"""Readings for the limits of ``correct``, at a cell's own size.

    python3 bench/calibrate.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9

For each of ``--seeds`` the program's set-up runs (the corpus, the start,
the checked sweeps) and the judge's numbers are printed (the lower
readings); for each of ``--control-seeds`` the same with the control, the
reference in bfloat16, in ``gibbs_step``'s place (the upper readings).
One JSON line a seed, all in one process.  Needs a CUDA card.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def readings(cell, seed: int, device, control: bool) -> dict:
    from bench import harness, reference
    from repro_torch.lda import gibbs

    step = gibbs.gibbs_step
    if control:
        gibbs.gibbs_step = reference.control_step(cell.mix)
    try:
        t0 = time.perf_counter()
        corpus, prog, snaps, times = harness.setup(cell, seed, device, t0)
        prog.free()
    finally:
        gibbs.gibbs_step = step
    t = time.perf_counter()
    checks = harness.check(cell, corpus, snaps, seed, device)
    times["check_s"] = time.perf_counter() - t
    return {"workload": cell.name, "seed": seed,
            "kind": "control" if control else "program",
            "numbers": {k: v["value"] for k, v in checks.items()},
            "correct": all(v["value"] <= v["limit"] for v in checks.values()),
            "times": times}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    for p in (ROOT / "src", ROOT):
        sys.path.insert(0, str(p))
    os.environ["REPRO_AUTOTUNE"] = "model"
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = os.path.join(
        tempfile.mkdtemp(prefix="bench-calibrate-"), "autotune.json")
    import torch

    from bench import manifest

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 3
    cell = manifest.cell(args.workload, ROOT)
    for control, seeds in ((False, args.seeds), (True, args.control_seeds)):
        for s in filter(None, seeds.split(",")):
            print(json.dumps(readings(cell, int(s), "cuda", control)), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
