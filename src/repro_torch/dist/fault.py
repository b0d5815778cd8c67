"""Elastic fault tolerance: per-rank shard checkpoints that reshard on
restore, async saves, and the preemption hook, the counterpart of
``repro.dist.fault`` with the same on-disk format (schema 2)::

    <dir>/
      step_00000042/
        manifest.json      # schema, global leaf table (shape/dtype),
                           # per-rank shard tables (block index/offset/enc),
                           # per-rank file hashes, save topology, user
                           # 'extra' payload, step number
        data.rank0.bin     # rank 0's owned blocks, concatenated raw
        data.rank1.bin     # rank 1's owned blocks
        ...

Every rank writes ONLY the blocks it owns: the local shard of each
DTensor whose coordinate is 0 on every mesh dim the leaf replicates over
(JAX's ``replica_id == 0``), so a replicated block is written exactly
once.  Plain tensors and numpy leaves are host-replicated state that rank
0 alone writes.  Nothing is gathered.

The commit protocol: each rank streams its blocks into
``.tmp-<step>/data.rank{i}.bin``, fsyncs, then atomically publishes a
``shards.rank{i}.json`` marker (block table + sha256).  Rank 0 waits for
ALL markers, merges them into ``manifest.json``, verifies the shard tables
cover every leaf, and commits the step by one ``os.replace`` of the temp
directory.  The commit goes through the file system only: no collective.

Restore is elastic and lazy: block indices are global coordinates, so
``restore(like=tree, shardings=new_tree)`` assembles exactly the regions
the new placement puts on THIS rank, reading only the rank files that hold
them (``restore_stats()`` reports which).  A checkpoint written by either
package restores in the other bit for bit: leaves go in sorted-key order
(JAX's dict order), dtypes are recorded by their numpy names
(``"bfloat16"`` included; its bytes pass through ``int16``), and the
manifest's ``treedef`` holds the writer's own tree description, of which
restore checks only the leaf count, as the reference does.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import signal
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.dist.compression import dequantize_int8, quantize_int8

_MANIFEST = "manifest.json"
_SCHEMA = 2
_LEGACY_DATA = "data.bin"          # schema-1 single-file checkpoints

# dtypes stored as int8 (+ float32 scale) when the manager compresses
_COMPRESSIBLE = ("float32", "float64")

# numpy has no bfloat16: its bytes are stored and read through int16
_STORAGE = {"bfloat16": np.int16}


def _rank_file(rank: int) -> str:
    return f"data.rank{rank}.bin"


def _marker_file(rank: int) -> str:
    return f"shards.rank{rank}.json"


def _dtype_name(x) -> str:
    """The numpy name of a leaf's dtype (what the reference records)."""
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    return np.asarray(x).dtype.name


def _np_dtype(name: str):
    return _STORAGE[name] if name in _STORAGE else np.dtype(name)


def _torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host snapshot of a tensor, C-contiguous, bfloat16 as int16 bits."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    arr = t.cpu().numpy()
    # a CPU tensor's array shares its memory: copy, so an in-place update
    # after save() cannot reach the writer thread
    return arr.copy() if t.device.type == "cpu" else _c_contiguous(arr)


def _c_contiguous(x) -> np.ndarray:
    """C-contiguous WITHOUT promoting 0-d to 1-d (``np.ascontiguousarray``
    would, desyncing block indices from the recorded leaf shape)."""
    arr = np.asarray(x)
    return arr if arr.flags["C_CONTIGUOUS"] else np.ascontiguousarray(arr)


def _from_numpy(arr: np.ndarray, name: str) -> torch.Tensor:
    t = torch.from_numpy(arr if arr.flags.writeable else np.array(arr))
    return t.view(torch.bfloat16) if name == "bfloat16" else t


@dataclasses.dataclass
class _Block:
    """One owned block of one leaf: global index + payload bytes."""

    leaf: int
    index: Tuple[Tuple[int, int], ...]   # ((start, stop), ...) per dim
    data: np.ndarray                     # host snapshot, C-contiguous
    dtype: str


def _tree_leaves(tree) -> list:
    """Leaves of nested dicts in sorted key order (JAX's dict order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tree_leaves(tree[k])]
    return [tree]


def _tree_unflatten(like, leaves):
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)

    return build(like)


def _tree_repr(tree) -> str:
    """The port's tree description, written where the reference writes
    its ``PyTreeDef``."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_tree_repr(tree[k])}" for k in sorted(tree)) + "}"
    return "*"


def _local_region(shape, mesh, placements) -> Tuple[Tuple[int, int], ...]:
    """The global ((start, stop), ...) of this rank's shard of a tensor of
    ``shape`` placed on ``mesh``."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    lshape, offset = compute_local_shape_and_global_offset(tuple(shape), mesh, placements)
    return tuple((int(o), int(o) + int(n)) for o, n in zip(offset, lshape))


def _owned_blocks(leaf_id: int, x, process_index: int) -> List[_Block]:
    """The blocks THIS rank writes for one leaf: a DTensor's local shard
    when its coordinate is 0 on every mesh dim the leaf replicates over;
    everything else is host-replicated state that rank 0 alone persists."""
    from torch.distributed.tensor import DTensor

    name = _dtype_name(x)
    if isinstance(x, DTensor):
        mesh = x.device_mesh
        coord = mesh.get_coordinate()
        if coord is None or any(c != 0 for c, p in zip(coord, x.placements)
                                if not p.is_shard()):
            return []
        index = _local_region(x.shape, mesh, x.placements)
        return [_Block(leaf_id, index, _to_numpy(x.to_local()), name)]
    if process_index != 0:
        return []
    arr = _to_numpy(x) if isinstance(x, torch.Tensor) else _c_contiguous(x)
    return [_Block(leaf_id, tuple((0, int(d)) for d in arr.shape), arr, name)]


def _block_volume(index: Sequence[Sequence[int]]) -> int:
    vol = 1
    for start, stop in index:
        vol *= max(int(stop) - int(start), 0)
    return vol


def _process() -> Tuple[int, int]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class CheckpointError(RuntimeError):
    """A checkpoint on disk disagrees with its manifest (skew/corruption)."""


class CheckpointManager:
    """Atomic, GC'd, optionally async per-rank shard checkpoints.

    Parameters
    ----------
    dir: checkpoint root (created on first save); shared storage every
        rank can reach in a multi-process run.
    keep: how many committed steps to retain; ``None``/0 keeps everything.
    async_save: hand the (already host-snapshotted) write to a background
        thread; ``save(..., block=True)`` or :meth:`wait` joins it.
    compress: store float32/float64 blocks as int8 + a float32 scale per
        block (lossy by <= scale/2 per element; meant for optimizer
        moments, not params).
    commit_timeout: how long rank 0 waits for every rank's marker (and
        the other ranks for the commit).
    process_index / process_count: rank overrides for tests; default to
        the ``torch.distributed`` rank and world size (0 and 1 without a
        process group).
    """

    def __init__(self, dir: str, keep: Optional[int] = None, async_save: bool = True,
                 compress: bool = False, commit_timeout: float = 120.0,
                 process_index: Optional[int] = None, process_count: Optional[int] = None):
        self.dir = dir
        self.keep = keep
        self.async_save = async_save
        self.compress = compress
        self.commit_timeout = float(commit_timeout)
        self._proc = process_index
        self._nproc = process_count
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._restore_stats: Dict[str, object] = {}

    def _rank(self) -> int:
        return _process()[0] if self._proc is None else int(self._proc)

    def _world(self) -> int:
        return _process()[1] if self._nproc is None else int(self._nproc)

    # -- paths -------------------------------------------------------------

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def _tmp_dir(self, step: int) -> str:
        # shared by every rank of one save: derivable without communication
        return os.path.join(self.dir, f".tmp-{step:08d}")

    def steps(self) -> List[int]:
        """Committed step numbers under the root, ascending."""
        if not os.path.isdir(self.dir):
            return []
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_"):
                try:
                    out.append(int(name[len("step_"):]))
                except ValueError:
                    continue
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        """The newest committed step, or ``None`` on an empty root."""
        steps = self.steps()
        return steps[-1] if steps else None

    # -- save --------------------------------------------------------------

    def save(self, step: int, tree, extra: Optional[Dict] = None, block: bool = False,
             mesh=None) -> None:
        """Snapshot this rank's owned blocks NOW, then write (async).

        Every rank calls ``save`` with the same global ``tree``; each
        writes only its own shards.  The snapshot to host memory happens
        here, so later in-place updates cannot race the writer thread.
        ``mesh`` (a DeviceMesh or ``{axis: size}`` mapping) is recorded in
        the manifest topology."""
        from torch.distributed.tensor import DTensor

        from repro_torch.dist.sharding import mesh_shape

        self.wait()  # serialize saves; surface a previous writer's error
        leaves = _tree_leaves(tree)
        rank = self._rank()
        blocks: List[_Block] = []
        for i, x in enumerate(leaves):
            blocks.extend(_owned_blocks(i, x, rank))
        leaf_meta = [{"shape": tuple(int(d) for d in (x.shape if isinstance(x, torch.Tensor)
                                                      else np.shape(x))),
                      "dtype": _dtype_name(x)} for x in leaves]
        if mesh is not None:
            mesh = {str(k): int(v) for k, v in (mesh.items() if isinstance(mesh, dict)
                                                else mesh_shape(mesh).items())}
        devices = self._world()
        for x in leaves:
            if isinstance(x, DTensor):
                devices = int(x.device_mesh.size())
                break
        payload = {
            "step": int(step),
            "treedef": _tree_repr(tree),
            "extra": extra if extra is not None else {},
            "topology": {"processes": self._world(), "devices": devices, "mesh": mesh},
        }
        if self.async_save and not block:
            self._thread = threading.Thread(target=self._write_guarded,
                                            args=(step, blocks, leaf_meta, payload),
                                            daemon=True)
            self._thread.start()
        else:
            self._write(step, blocks, leaf_meta, payload)

    def _write_guarded(self, step, blocks, leaf_meta, payload):
        try:
            self._write(step, blocks, leaf_meta, payload)
        except BaseException as e:  # re-raised from wait()
            self._error = e

    def _write(self, step: int, blocks: List[_Block], leaf_meta: List[Dict], payload: Dict):
        rank, world = self._rank(), self._world()
        os.makedirs(self.dir, exist_ok=True)
        tmp = self._tmp_dir(step)
        if rank == 0:
            # clear stale temp dirs of preempted writers, never this save's
            for name in os.listdir(self.dir):
                if name.startswith(".tmp-") and name != os.path.basename(tmp):
                    shutil.rmtree(os.path.join(self.dir, name), ignore_errors=True)
        os.makedirs(tmp, exist_ok=True)

        # ---- every rank: stream owned blocks, fsync, publish marker
        table: List[Dict] = []
        offset = 0
        digest = hashlib.sha256()
        with open(os.path.join(tmp, _rank_file(rank)), "wb") as f:
            for b in blocks:
                enc, scale = "raw", 0.0
                buf = b.data
                if self.compress and b.dtype in _COMPRESSIBLE and buf.size:
                    q, s = quantize_int8(torch.from_numpy(buf))
                    buf = q.numpy()
                    enc, scale = "int8", float(s)
                data = memoryview(buf).cast("B") if buf.ndim and buf.size else buf.tobytes()
                table.append({"leaf": b.leaf, "index": [list(se) for se in b.index],
                              "offset": offset, "nbytes": len(data), "enc": enc,
                              "scale": scale})
                f.write(data)
                digest.update(data)
                offset += len(data)
            f.flush()
            os.fsync(f.fileno())
        marker = {"rank": rank, "nbytes": offset, "sha256": digest.hexdigest(),
                  "shards": table}
        mpath = os.path.join(tmp, _marker_file(rank))
        with open(mpath + ".part", "w") as f:
            json.dump(marker, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(mpath + ".part", mpath)

        if rank != 0:
            # wait for rank 0's commit, so block=True/wait() means "my
            # shards are in a committed checkpoint"
            deadline = time.monotonic() + self.commit_timeout
            final = self._step_dir(step)
            while not os.path.isdir(final):
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"rank {rank}: step {step} was never committed by process 0 "
                        f"within {self.commit_timeout:.0f}s")
                time.sleep(0.02)
            return

        # ---- rank 0: wait for every marker, merge, verify coverage, commit
        deadline = time.monotonic() + self.commit_timeout
        markers: Dict[int, Dict] = {}
        while len(markers) < world:
            for r in range(world):
                if r in markers:
                    continue
                p = os.path.join(tmp, _marker_file(r))
                if os.path.exists(p):
                    with open(p) as f:
                        markers[r] = json.load(f)
            if len(markers) < world:
                if time.monotonic() > deadline:
                    missing = sorted(set(range(world)) - set(markers))
                    raise TimeoutError(
                        f"step {step}: ranks {missing} never published their shard "
                        f"markers within {self.commit_timeout:.0f}s — checkpoint NOT "
                        f"committed")
                time.sleep(0.02)

        vol = [0] * len(leaf_meta)
        for m in markers.values():
            for sh in m["shards"]:
                vol[sh["leaf"]] += _block_volume(sh["index"])
        for i, meta in enumerate(leaf_meta):
            want = int(np.prod(meta["shape"])) if meta["shape"] else 1
            if vol[i] != want:
                raise CheckpointError(
                    f"step {step}: leaf {i} {tuple(meta['shape'])} has shard coverage "
                    f"{vol[i]}/{want} elements across {world} ranks — refusing to "
                    f"commit a checkpoint with holes")

        manifest = {
            "schema": _SCHEMA,
            "leaves": leaf_meta,
            "shards": {str(r): m["shards"] for r, m in markers.items()},
            "files": {str(r): {"name": _rank_file(r), "nbytes": m["nbytes"],
                               "sha256": m["sha256"]} for r, m in markers.items()},
            **payload,
        }
        with open(os.path.join(tmp, _MANIFEST), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        for r in range(world):
            os.remove(os.path.join(tmp, _marker_file(r)))
        final = self._step_dir(step)
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.replace(tmp, final)  # the commit point
        self._gc()

    def _gc(self):
        if not self.keep:
            return
        steps = self.steps()
        for s in steps[: max(len(steps) - self.keep, 0)]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def wait(self) -> None:
        """Join an in-flight async save; re-raise its error, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # -- restore -----------------------------------------------------------

    def restore(self, like, shardings=None, step: Optional[int] = None):
        """Read a checkpoint back as ``(tree, extra)``.

        ``like`` supplies the tree structure (its values are ignored; a
        tensor leaf names the device a leaf comes back on).
        ``shardings``, a matching tree of
        :class:`~repro_torch.dist.sharding.NamedSharding`, places every
        leaf onto its new mesh: the elastic and lazy path, which assembles
        only this rank's regions from only the rank files holding them
        (a sharding that splits its leaf gives a DTensor, one that
        replicates it the whole tensor on the mesh's device).  Without
        ``shardings`` leaves come back whole.

        Raises :class:`CheckpointError` when the on-disk shard files
        disagree with the manifest."""
        from torch.distributed.tensor import DTensor

        from repro_torch.dist.sharding import is_sharded

        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.dir!r}")
        d = self._step_dir(step)
        with open(os.path.join(d, _MANIFEST)) as f:
            manifest = json.load(f)
        like_leaves = _tree_leaves(like)
        leaves_meta = manifest["leaves"]
        if len(like_leaves) != len(leaves_meta):
            raise ValueError(
                f"checkpoint step {step} holds {len(leaves_meta)} leaves but 'like' has "
                f"{len(like_leaves)} — structure drift?")
        sh_leaves = (_tree_leaves(shardings) if shardings is not None
                     else [None] * len(leaves_meta))

        def device_of(li, sh):
            if sh is not None:
                mesh = sh.mesh
                if mesh.device_type == "cuda":
                    return torch.device("cuda", torch.cuda.current_device())
                return torch.device(mesh.device_type)
            x = like_leaves[li]
            if isinstance(x, DTensor):
                return torch.device(x.device_mesh.device_type)
            return x.device if isinstance(x, torch.Tensor) else torch.device("cpu")

        if manifest.get("schema", 1) < 2:
            out = self._read_v1(d, manifest, sh_leaves, device_of)
            return _tree_unflatten(like, out), manifest.get("extra", {})

        self._check_rank_files(d, manifest, step)
        by_leaf: Dict[int, List[Tuple[int, Dict]]] = {}
        for r_str, shards in manifest["shards"].items():
            for sh in shards:
                by_leaf.setdefault(int(sh["leaf"]), []).append((int(r_str), sh))
        file_cache: Dict[int, bytes] = {}
        stats = {"files_read": [], "bytes_read": 0}

        def rank_bytes(rank: int) -> bytes:
            """Load + hash-verify one rank's data file (once)."""
            if rank not in file_cache:
                finfo = manifest["files"][str(rank)]
                with open(os.path.join(d, finfo["name"]), "rb") as f:
                    blob = f.read()
                sha = hashlib.sha256(blob).hexdigest()
                if sha != finfo["sha256"]:
                    raise CheckpointError(
                        f"step {step}: {finfo['name']} content hash {sha[:12]} != "
                        f"manifest {finfo['sha256'][:12]} — shard file corrupted or "
                        f"from a different save")
                file_cache[rank] = blob
                stats["files_read"].append(finfo["name"])
                stats["bytes_read"] += len(blob)
            return file_cache[rank]

        def region(li: int, want) -> np.ndarray:
            """Assemble one requested region of leaf ``li`` from blocks."""
            meta = leaves_meta[li]
            shape = tuple(meta["shape"])
            name = meta["dtype"]
            store = _np_dtype(name)
            rshape = tuple(stop - start for start, stop in want)
            out = np.zeros(rshape, store)
            filled = np.zeros(rshape, bool)
            for rank, sh in by_leaf.get(li, []):
                have = tuple((int(a), int(b)) for a, b in sh["index"])
                inter = tuple((max(a0, b0), min(a1, b1))
                              for (a0, a1), (b0, b1) in zip(have, want))
                if any(a >= b for a, b in inter):
                    continue
                blob = memoryview(rank_bytes(rank))   # slices without copying
                raw = blob[sh["offset"]: sh["offset"] + sh["nbytes"]]
                if len(raw) != sh["nbytes"]:
                    raise CheckpointError(
                        f"step {step}: rank {rank} shard of leaf {li} is truncated "
                        f"({len(raw)}/{sh['nbytes']} bytes)")
                bshape = tuple(b - a for a, b in have)
                if sh.get("enc") == "int8":
                    q = torch.from_numpy(np.frombuffer(raw, np.int8).reshape(bshape).copy())
                    block = dequantize_int8(q, torch.tensor(sh["scale"], dtype=torch.float32)
                                            ).numpy().astype(store)
                else:
                    block = np.frombuffer(raw, store).reshape(bshape)
                if not rshape:            # scalar leaf
                    out[()] = block
                    filled[()] = True
                    continue
                dst = tuple(slice(a - w0, b - w0) for (a, b), (w0, _) in zip(inter, want))
                src = tuple(slice(a - h0, b - h0) for (a, b), (h0, _) in zip(inter, have))
                out[dst] = block[src]
                filled[dst] = True
            if not bool(np.all(filled)):
                raise CheckpointError(
                    f"step {step}: shard tables do not cover region {want} of leaf {li} "
                    f"{shape} — saved on {manifest['topology']['processes']} processes; "
                    f"manifest and data files disagree")
            return out

        out = []
        for li, (meta, sh) in enumerate(zip(leaves_meta, sh_leaves)):
            shape = tuple(meta["shape"])
            dev = device_of(li, sh)
            if is_sharded(sh):
                want = _local_region(shape, sh.mesh, sh.placements)
                local = _from_numpy(region(li, want), meta["dtype"]).to(dev)
                out.append(DTensor.from_local(
                    local, sh.mesh, sh.placements, run_check=False, shape=torch.Size(shape),
                    stride=torch.empty(shape, device="meta").stride()))
            else:
                full = tuple((0, int(n)) for n in shape)
                out.append(_from_numpy(region(li, full), meta["dtype"]).to(dev))
        self._restore_stats = {
            "step": int(step),
            "files_read": sorted(stats["files_read"]),
            "bytes_read": int(stats["bytes_read"]),
            "saved_topology": manifest.get("topology", {}),
        }
        return _tree_unflatten(like, out), manifest.get("extra", {})

    def restore_stats(self) -> Dict[str, object]:
        """What the last :meth:`restore` read from disk: ``files_read`` /
        ``bytes_read`` make the only-my-shards contract observable."""
        return dict(self._restore_stats)

    def _check_rank_files(self, d: str, manifest: Dict, step: int) -> None:
        """Manifest-vs-disk skew checks that don't require reading data."""
        files = manifest.get("files", {})
        topo = manifest.get("topology", {})
        nproc = int(topo.get("processes", len(files)))
        if len(files) != nproc:
            raise CheckpointError(
                f"step {step}: manifest topology says {nproc} processes but records "
                f"{len(files)} shard files — manifest is internally inconsistent")
        on_disk = set(os.listdir(d))
        missing = [f["name"] for f in files.values() if f["name"] not in on_disk]
        if missing:
            raise CheckpointError(
                f"step {step}: manifest (saved on {nproc} processes) lists shard files "
                f"{sorted(missing)} that are missing on disk — topology skew or partial "
                f"copy; refusing to load")
        for f in files.values():
            size = os.path.getsize(os.path.join(d, f["name"]))
            if size != int(f["nbytes"]):
                raise CheckpointError(
                    f"step {step}: {f['name']} is {size} bytes on disk but the manifest "
                    f"recorded {f['nbytes']} — truncated or mixed-save shard file")

    def _read_v1(self, d: str, manifest: Dict, sh_leaves, device_of) -> List:
        """Schema-1 reader: the legacy single gathered ``data.bin``."""
        from repro_torch.dist.sharding import device_put

        with open(os.path.join(d, _LEGACY_DATA), "rb") as f:
            blob = f.read()
        out = []
        for li, (meta, sh) in enumerate(zip(manifest["leaves"], sh_leaves)):
            raw = blob[meta["offset"]: meta["offset"] + meta["nbytes"]]
            shape = tuple(meta["shape"])
            name = meta["dtype"]
            if meta.get("enc") == "int8":
                q = torch.from_numpy(np.frombuffer(raw, dtype=np.int8).reshape(shape).copy())
                t = dequantize_int8(q, torch.tensor(meta["scale"], dtype=torch.float32)
                                    ).to(_torch_dtype(name))
            else:
                t = _from_numpy(np.frombuffer(raw, dtype=_np_dtype(name)).reshape(shape), name)
            t = t.to(device_of(li, sh))
            out.append(device_put(t, sh) if sh is not None else t)
        return out


# ---------------------------------------------------------------------------
# preemption
# ---------------------------------------------------------------------------

# SIGTERM flips this event; the train loop polls ``preempted()`` each step
# and commits a final checkpoint before exiting (launch/train.py)
_PREEMPTED = threading.Event()


def install_preemption_handler(signals: Tuple[int, ...] = (signal.SIGTERM,)) -> None:
    """Route cluster preemption signals into the ``preempted()`` flag.

    Chainable: a previously installed handler for the same signal still
    runs.  Safe to call more than once (the flag is idempotent)."""
    for sig in signals:
        prev = signal.getsignal(sig)

        def handler(signum, frame, _prev=prev):
            _PREEMPTED.set()
            if callable(_prev) and _prev not in (signal.SIG_IGN, signal.SIG_DFL):
                _prev(signum, frame)

        try:
            signal.signal(sig, handler)
        except ValueError:
            # not the main thread: preemption then only arrives via
            # _signal_preemption()
            pass


def preempted() -> bool:
    """Has a preemption signal arrived?  (Sticky until reset.)"""
    return _PREEMPTED.is_set()


def _signal_preemption() -> None:
    """Test hook: mark the process preempted without a real SIGTERM."""
    _PREEMPTED.set()


def reset_preemption() -> None:
    """Clear the sticky preemption flag (between tests / after resume)."""
    _PREEMPTED.clear()
