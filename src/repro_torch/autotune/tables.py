"""Reusable distribution cache (autotune layer 3), the counterpart of
``repro.autotune.tables``.

Alias and Fenwick state are pure functions of the weight matrix: when the
same distributions are drawn from again and again (a fixed phi inside one
LDA sweep, a static unigram table), rebuilding them every call wastes the
O(K) build.  This module memoizes built :class:`Categorical` objects for
the ``dist_key=`` path of ``sample_categorical``, for the kinds whose
state that path reuses (``cost_model.CACHED_TABLE_METHODS``), and raw
alias tables (:meth:`TableCache.get_or_build`) for the sparse LDA sweep's
word proposals.

Staleness: entries are keyed by a **content digest** of the weights
(shape, dtype, device and two exact checksums over their bytes, see
:func:`content_digest`) besides the caller's ``dist_key``, so changed
weights miss and rebuild.  Tensors are mutable, unlike JAX arrays: the
digest memo is keyed by the tensor's identity *and* its version counter
and storage pointer, so ``w.mul_(2)`` or ``w.copy_(...)`` (which bump the
version counter that views share with their base) is digested again.

Entries are LRU-evicted beyond ``max_entries``.  While a CUDA stream is
capturing a graph (or ``torch.compile`` traces), nothing is digested or
cached: the caller gets a fresh build.
"""

from __future__ import annotations

import collections
import threading
import weakref
from typing import Any, Optional, Tuple

import torch

_MASK32 = 0xFFFFFFFF
# bytes per checksum step: bounds the int64 temporaries to 2 x 128 MiB
_CHUNK = 1 << 24


def _checksums(weights: torch.Tensor) -> Tuple[int, int]:
    """Two exact (mod 2^32) order-sensitive checksums over the raw bytes
    of ``weights``: the plain byte sum and a position-weighted one, in
    int64 masked to 32 bits (no uint32 arithmetic on the CPU).  Any
    single changed element changes at least one of them; the weighted sum
    also catches permutations that keep the plain sum."""
    bts = weights.detach().contiguous().view(-1).view(torch.uint8)
    s1 = s2 = 0
    for start in range(0, bts.numel(), _CHUNK):
        iv = bts[start:start + _CHUNK].to(torch.int64)
        pos = torch.arange(start, start + iv.numel(), dtype=torch.int64, device=iv.device)
        s1 = (s1 + int(iv.sum())) & _MASK32
        term = (iv * ((2 * pos + 1) & _MASK32)) & _MASK32
        s2 = (s2 + int(term.sum())) & _MASK32
    return s1, s2


# digest memo: id(tensor), its version counter and data pointer -> digest,
# with a weakref that evicts the entry when the tensor is freed (a recycled
# id can then never alias a dead tensor's digest)
_DIGEST_MEMO: dict = {}
_DIGEST_LOCK = threading.Lock()


def content_digest(weights) -> Optional[str]:
    """Content fingerprint of a weight tensor, or ``None`` while a CUDA
    stream captures or ``torch.compile`` traces (see
    ``tuner._tracing_active``).

    Shape, dtype, device and two byte-level checksums (one pass on the
    tensor's device, two scalar transfers).  Memoized per tensor while
    its version counter and storage stay the same."""
    from repro_torch.autotune.tuner import _tracing_active

    if _tracing_active():
        return None
    w = torch.as_tensor(weights)
    wid = id(weights)
    stamp = (w._version, w.data_ptr())
    with _DIGEST_LOCK:
        hit = _DIGEST_MEMO.get(wid)
        if hit is not None and hit[0]() is weights and hit[1] == stamp:
            return hit[2]
    s1, s2 = _checksums(w)
    digest = f"{tuple(w.shape)}|{w.dtype}|{w.device}|{s1:#x}|{s2:#x}"
    if w is not weights:
        return digest  # converted input: nothing to memoize it by
    ref = weakref.ref(weights, lambda _r, k=wid: _DIGEST_MEMO.pop(k, None))
    with _DIGEST_LOCK:
        _DIGEST_MEMO[wid] = (ref, stamp, digest)
    return digest


# the raw table kinds of TableCache.get_or_build
TABLE_KINDS = ("alias_host", "alias_device")


def _build_table(kind: str, weights):
    if kind == "alias_host":
        from repro_torch.core.alias import build_alias_tables_host

        return build_alias_tables_host(weights)
    from repro_torch.kernels.alias_build import build_alias_tables_device

    return build_alias_tables_device(weights)


class TableCache:
    """LRU memo of built :class:`Categorical` objects, keyed by (dist_key,
    method, W, content digest of the weights), and of raw alias tables
    (:meth:`get_or_build`)."""

    def __init__(self, max_entries: int = 16):
        self.max_entries = max_entries
        self._lock = threading.Lock()
        self._entries: "collections.OrderedDict[Tuple, Any]" = collections.OrderedDict()
        self.hits = 0
        self.misses = 0

    def _lookup(self, key):
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                self.hits += 1
                return self._entries[key]
        return None

    def _store(self, key, value):
        with self._lock:
            self.misses += 1
            self._entries[key] = value
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
        return value

    def get_or_build(self, dist_key: str, kind: str, weights):
        """The cached raw table of ``kind`` for ``dist_key``, built on a
        miss: ``"alias_host"`` (``core.alias.build_alias_tables_host``,
        Vose's build on the host) or ``"alias_device"``
        (``kernels.alias_build.build_alias_tables_device``: K13 on the
        card).  The sparse LDA sweep's per-word tables come through here.
        The same digest contract as :meth:`get_or_build_dist`."""
        if kind not in TABLE_KINDS:
            raise ValueError(f"unknown table kind {kind!r}; options: {TABLE_KINDS}")
        digest = content_digest(weights)
        if digest is None:
            return _build_table(kind, weights)
        key = (str(dist_key), f"table:{kind}", None, digest)
        hit = self._lookup(key)
        if hit is not None:
            return hit
        return self._store(key, _build_table(kind, weights))

    def get_or_build_dist(self, dist_key: str, plan, weights):
        """The cached :class:`Categorical` for ``dist_key`` under ``plan``
        (a ``SamplerPlan``), built on a miss.  The weights' digest is part
        of the key, so changed values or shapes under a reused
        ``dist_key`` rebuild; while a stream captures nothing is cached."""
        digest = content_digest(weights)
        if digest is None:
            return plan.build(weights)
        key = (str(dist_key), plan.method, plan.W, digest)
        hit = self._lookup(key)
        if hit is not None:
            return hit
        return self._store(key, plan.build(weights))

    def invalidate(self, dist_key: str) -> int:
        """Drop every entry for ``dist_key``; returns how many went."""
        dist_key = str(dist_key)
        with self._lock:
            doomed = [k for k in self._entries if k[0] == dist_key]
            for k in doomed:
                del self._entries[k]
        return len(doomed)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self.hits = 0
            self.misses = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._entries), "hits": self.hits,
                    "misses": self.misses}


_GLOBAL: Optional[TableCache] = None


def get_table_cache() -> TableCache:
    global _GLOBAL
    if _GLOBAL is None:
        _GLOBAL = TableCache()
    return _GLOBAL


def reset_table_cache() -> None:
    global _GLOBAL
    _GLOBAL = None
