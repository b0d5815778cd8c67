"""Persistent tuning cache (autotune layer 2 storage), the counterpart of
``repro.autotune.cache``.

Winners are keyed by ``(backend, shape-bucket)``: the bucket rounds B, K
and draws-per-distribution up to powers of two, so shapes inside one
bucket share a winner.  The key format is the reference's (v1-v6 fields:
``key``/``nokey``, ``|fac``, ``|devN``, ``|tr:SIG``, ``|sp``); the backend
is the device type of the call's tensors (``cuda`` or ``cpu``).

The port keeps its own file, so that a process that runs both packages
(the tests do) never mixes their winners under the shared ``cpu|...``
keys: ``$REPRO_TORCH_AUTOTUNE_CACHE``, default
``~/.cache/repro_torch/autotune.json``, schema ``repro-torch-autotune-v1``::

    {
      "schema": "repro-torch-autotune-v1",
      "entries": {
        "cuda|B64|K262144|d1|float32|key|tr:kp": {
          "method": "kernel_trunc", "W": 128, "tb": 8, "tk": 512, "us": 710.2,
          "source": "measured" | "model" | "bench"
        },
        ...
      }
    }

Writes are atomic (tmp file + ``os.replace``) and a corrupt or
wrong-schema file (the reference's included) is treated as empty.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
from typing import Dict, Iterable, List, Optional

SCHEMA = "repro-torch-autotune-v1"
BENCH_SCHEMA = "repro-torch-autotune-bench-v1"
PATH_ENV = "REPRO_TORCH_AUTOTUNE_CACHE"

# precedence when deciding whether a new record may overwrite an old one
_SOURCE_RANK = {"model": 0, "bench": 1, "measured": 2}


def default_cache_path() -> str:
    env = os.environ.get(PATH_ENV)
    if env:
        return env
    return os.path.join(
        os.path.expanduser("~"), ".cache", "repro_torch", "autotune.json"
    )


def _bucket(n: int) -> int:
    """Round up to a power of two (1 stays 1)."""
    n = max(int(n), 1)
    return 1 << (n - 1).bit_length()


def bucket_key(
    backend: str, B: int, K: int, draws: int, dtype: str, has_key: bool = True,
    factored: bool = False, devices: int = 1, transforms: str = "",
    sparse: bool = False,
) -> str:
    """Shape-bucket cache key.  ``has_key`` is part of the key (a caller
    without a random stream has no gumbel/alias candidates); so are
    ``factored`` (``|fac``), a mesh's ``devices`` (``|devN``, B then being
    the per-shard rows), the truncation-chain signature (``|tr:SIG``) and
    ``sparse`` (``|sp``)."""
    kd = "key" if has_key else "nokey"
    base = f"{backend}|B{_bucket(B)}|K{_bucket(K)}|d{_bucket(draws)}|{dtype}|{kd}"
    if factored:
        base += "|fac"
    if devices and devices > 1:
        base += f"|dev{_bucket(devices)}"
    if transforms:
        base += f"|tr:{transforms}"
    if sparse:
        base += "|sp"
    return base


class TuningCache:
    """In-memory winner table with JSON persistence.  Thread-safe."""

    def __init__(self, path: Optional[str] = None, autoload: bool = True):
        self.path = path or default_cache_path()
        self._lock = threading.Lock()
        self._entries: Dict[str, Dict] = {}
        self._dirty = False
        if autoload:
            self.load()

    # -- persistence ------------------------------------------------------

    def load(self) -> int:
        """Merge entries from ``self.path``; returns how many were read."""
        try:
            with open(self.path) as f:
                blob = json.load(f)
        except (OSError, ValueError):
            return 0
        if not isinstance(blob, dict) or blob.get("schema") != SCHEMA:
            return 0
        entries = blob.get("entries")
        if not isinstance(entries, dict):
            return 0
        n = 0
        with self._lock:
            for k, v in entries.items():
                if isinstance(v, dict) and "method" in v:
                    self._entries.setdefault(k, v)
                    n += 1
        return n

    def save(self, path: Optional[str] = None) -> str:
        """Atomically write the cache; returns the path written."""
        path = path or self.path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with self._lock:
            blob = {"schema": SCHEMA, "entries": dict(self._entries)}
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".", suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(blob, f, indent=1, sort_keys=True)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        # only after the atomic replace: a failed write leaves the cache
        # dirty so save_if_dirty retries later
        with self._lock:
            self._dirty = False
        return path

    def save_if_dirty(self) -> Optional[str]:
        if self._dirty:
            try:
                return self.save()
            except OSError:
                return None  # read-only FS: keep the in-memory cache working
        return None

    # -- lookup / update --------------------------------------------------

    def get(self, key: str) -> Optional[Dict]:
        with self._lock:
            return self._entries.get(key)

    def put(
        self,
        key: str,
        method: str,
        W: int,
        us: float,
        source: str = "measured",
        tb: Optional[int] = None,
        tk: Optional[int] = None,
    ) -> Dict:
        """Record a winner.  Lower-precedence sources never clobber
        higher-precedence ones (a cost-model guess won't erase a measured
        winner); equal precedence keeps the faster entry."""
        rec = {"method": method, "W": int(W), "us": float(us), "source": source}
        if tb:
            rec["tb"] = int(tb)
        if tk:
            rec["tk"] = int(tk)
        rank = _SOURCE_RANK.get(source, 0)
        with self._lock:
            old = self._entries.get(key)
            if old is not None:
                old_rank = _SOURCE_RANK.get(old.get("source"), 0)
                if old_rank > rank:
                    return old
                if old_rank == rank and old.get("us", float("inf")) <= us:
                    return old
            self._entries[key] = rec
            self._dirty = True
        return rec

    def ingest_records(self, blob_or_records, source: str = "bench") -> int:
        """Pre-warm from timing records: the per-bucket argmin.

        Accepts a ``repro-torch-autotune-bench-v1`` blob
        (``{"schema": ..., "records": [...]}``), a bare record list
        ``[{backend, B, K, draws?, dtype?, devices?, transforms?, method,
        W?, us}, ...]``, or a cache file of this schema (another machine's
        winners, merged entry by entry).  Returns the number of buckets
        updated."""
        if isinstance(blob_or_records, dict):
            schema = blob_or_records.get("schema")
            if schema == SCHEMA:  # a cache file: merge entries directly
                n = 0
                for key, rec in (blob_or_records.get("entries") or {}).items():
                    try:
                        # require a real timing: a defaulted us would rank
                        # as an unbeatable 0-cost winner forever
                        self.put(key, rec["method"], rec.get("W", 32),
                                 float(rec["us"]), source=source,
                                 tb=rec.get("tb"), tk=rec.get("tk"))
                        n += 1
                    except (KeyError, TypeError, ValueError):
                        continue
                return n
            if schema != BENCH_SCHEMA:
                return 0
            records: Iterable[Dict] = blob_or_records.get("records", [])
        else:
            records = blob_or_records
        from repro_torch.autotune.cost_model import FACTORED_METHODS, SPARSE_METHODS
        from repro_torch.autotune.tuner import KEY_METHODS, KNOWN_METHODS

        best: Dict[str, Dict] = {}
        for r in records:
            try:
                # only resolvable strategies may become bucket winners
                if r["method"] not in KNOWN_METHODS:
                    continue
                us = float(r["us"])
                is_sparse = r["method"] in SPARSE_METHODS
                factored = r["method"] in FACTORED_METHODS or is_sparse
                if is_sparse:
                    sparse_opts = (True,)
                elif factored:
                    sparse_opts = (False, True)
                else:
                    sparse_opts = (False,)
                for has_key in (True, False):
                    if not has_key and r["method"] in KEY_METHODS:
                        continue
                    for sp in sparse_opts:
                        key = bucket_key(
                            r.get("backend", "cpu"), r["B"], r["K"],
                            r.get("draws", 1), r.get("dtype", "float32"),
                            has_key=has_key, factored=factored,
                            devices=int(r.get("devices", 1)),
                            transforms=str(r.get("transforms", "")),
                            sparse=sp,
                        )
                        if key not in best or us < best[key]["us"]:
                            best[key] = {"method": r["method"],
                                         "W": int(r.get("W", 32)), "us": us,
                                         "tb": r.get("tb"), "tk": r.get("tk")}
            except (KeyError, TypeError, ValueError):
                continue
        for key, rec in best.items():
            self.put(key, rec["method"], rec["W"], rec["us"], source=source,
                     tb=rec.get("tb"), tk=rec.get("tk"))
        return len(best)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._dirty = True

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def items(self) -> List:
        with self._lock:
            return sorted(self._entries.items())
