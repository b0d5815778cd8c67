"""Run one cell of the benchmark and print its result as one JSON line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, ``bench/`` and
the port (``src/repro_torch``).  Needs a CUDA card: without one, or with
fewer cards than the cell asks for, it exits with code 3 and prints no
result.  With ``--trace 0`` the metrics are the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics, ``busy_s``, ``window_s`` and a
``breakdown``.  The numbers compared with the reference follow, each with
its limit, on standard error and under ``checks`` in the result.

Kernels build into ``build/`` of the checkout (the port's nvcc builds in
``build/kernels``), so only a checkout's first run compiles.  Each run
tunes afresh: ``REPRO_AUTOTUNE=model`` with a new tuning cache under
``TMPDIR``, removed at exit.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return "not read"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for p in (ROOT / "src", ROOT):
        sys.path.insert(0, str(p))
    tmp = tempfile.mkdtemp(prefix="bench-run-")
    os.environ["REPRO_AUTOTUNE"] = "model"
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = os.path.join(tmp, "autotune.json")
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
    try:
        import torch

        from bench import harness, manifest

        cell = manifest.cell(args.workload, ROOT)
        chips = int(cell.workload["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"needs {chips} CUDA card(s); torch sees "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 3
        result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                                  "cuda", T_START, tmp,
                                  log=lambda m: print(m, file=sys.stderr))
        found = manifest.forbidden_modules(list(sys.modules))
        if found:
            print(f"the process holds forbidden modules: {found}", file=sys.stderr)
            return 4
        result["device"]["power_limit"] = _power_limit()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
