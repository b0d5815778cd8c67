"""Build the port's CUDA sources at first use and load them with ctypes.

Each kernel package keeps its CUDA C++ under ``csrc/``; the shared tile
steps are in ``kernels/csrc/draw_tile.cuh``.  A source compiles with
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``
into a shared library with a plain C interface, named by a hash of the
sources and flags, under ``build/kernels/`` at the root of the checkout
(listed in ``.gitignore``).  Nothing is built when a module is imported:
:func:`load` builds on the first launch, :func:`build_all` builds every
library at once, one ``nvcc`` process per source, all started together.

:func:`bind` sets the C functions' argument types, and :func:`launch`
calls one on PyTorch's current stream, raises on a CUDA error and counts
the launch.  There is no fallback: a missing ``nvcc``, a failed build or a
failed launch raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

_KERNELS = Path(__file__).resolve().parent
BUILD_DIR = _KERNELS.parents[2] / "build" / "kernels"
ARCH = "arch=compute_90a,code=sm_90a"
NVCC_FLAGS = (
    "-gencode", ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

# library name -> main source, relative to kernels/
SOURCES: Dict[str, str] = {
    "butterfly_table": "butterfly_table/csrc/butterfly_table.cu",
    "butterfly_sample": "butterfly_sample/csrc/butterfly_sample.cu",
    "butterfly_trunc": "butterfly_sample/csrc/butterfly_trunc.cu",
    "lda_draw": "lda_draw/csrc/lda_draw.cu",
    "alias_build": "alias_build/csrc/alias_build.cu",
    "sparse_mh": "sparse_mh/csrc/sparse_mh.cu",
    "sparse_counts": "sparse_counts/csrc/sparse_counts.cu",
}
_INCLUDES = ("csrc",)

_NVCC_FALLBACK = "/usr/local/cuda/bin/nvcc"
_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# compiler output (ptxas register / shared-memory report) per library
build_log: Dict[str, str] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else on ``PATH``, else
    ``/usr/local/cuda/bin/nvcc``; raises when there is none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    which = shutil.which("nvcc")
    if which:
        cands.append(Path(which))
    cands.append(Path(_NVCC_FALLBACK))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels cannot be built"
    )


def _inputs(name: str) -> List[Path]:
    src = _KERNELS / SOURCES[name]
    headers = sorted(
        p for d in (*_INCLUDES, str(Path(SOURCES[name]).parent))
        for p in (_KERNELS / d).glob("*.cuh")
    )
    return [src, *headers]


def library_path(name: str) -> Path:
    """Where the library for ``name`` lives: the file name carries a hash
    of its sources and flags, so an edited source rebuilds."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _inputs(name):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _command(name: str, out: Path) -> List[str]:
    src = _KERNELS / SOURCES[name]
    incs = [f"-I{_KERNELS / d}" for d in _INCLUDES] + [f"-I{src.parent}"]
    return [nvcc_path(), *NVCC_FLAGS, *incs, "-o", str(out), str(src)]


def _start(name: str) -> Tuple[subprocess.Popen, Path, Path] | None:
    lib = library_path(name)
    if lib.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen(
        _command(name, tmp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True,
    )
    return proc, tmp, lib


def _finish(name: str, job: Tuple[subprocess.Popen, Path, Path]) -> None:
    proc, tmp, lib = job
    out, _ = proc.communicate()
    build_log[name] = out
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name} ({proc.returncode}):\n{out}")
    os.replace(tmp, lib)


def build_all() -> Dict[str, Path]:
    """Compile every library whose build is missing, all nvcc processes
    started together; returns name -> library path."""
    with _lock:
        jobs = {n: _start(n) for n in SOURCES}
        errors = []
        for n, job in jobs.items():
            if job is not None:
                try:
                    _finish(n, job)
                except RuntimeError as e:
                    errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
    return {n: library_path(n) for n in SOURCES}


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        job = _start(name)
        if job is not None:
            _finish(name, job)
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
        return lib


def bind(name: str, sigs: Dict[str, Sequence], warps: Optional[Tuple[str, int]] = None
         ) -> ctypes.CDLL:
    """The library ``name`` (built first if needed) with the argument types
    of each C function in ``sigs`` set and an int return (the CUDA error).
    ``warps`` = (C function, value): the library's warps per block, which
    must equal the wrapper's (it sizes shared memory from it)."""
    lib = load(name)
    if not getattr(lib, "_bound", False):
        for fn, argtypes in sigs.items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        if warps is not None:
            fn = getattr(lib, warps[0])
            fn.argtypes = []
            fn.restype = ctypes.c_int
            if fn() != warps[1]:
                raise RuntimeError(f"{name} library disagrees on warps per block")
        lib._bound = True
    return lib


def launch(lib: ctypes.CDLL, fn: str, counts: Dict[str, int], *args) -> None:
    """Call kernel launcher ``fn`` of ``lib`` on PyTorch's current stream
    (no synchronisation), raise if the launch failed, and add one to
    ``counts[fn]``."""
    import torch

    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(lib, fn)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: CUDA error {err}")
    counts[fn] += 1
