"""The port's examples (``examples/torch/``) run end to end on the CPU
with small arguments: each in its own process, on the plain PyTorch
versions (``--device cpu``), with the autotune cache under
``tmp_path``.  ``train_lm`` trains, checkpoints, and resumes from its
checkpoint in a second process."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

# example -> (its arguments after --device cpu, a line its output must hold)
RUNS = {
    "quickstart": (["--B", "2000"], "max |empirical - target|"),
    "lda_topics": (["--iters", "10", "--M", "96", "--V", "120", "--method", "auto"],
                   "top words per topic"),
    "lda_topics_sparse": (["--iters", "3", "--M", "96", "--V", "120", "--sparse"],
                          "top words per topic"),
    "serve_decode": (["--new", "4", "--arch", "hymba-1.5b"], "generated (4, 4) tokens"),
    "serve_continuous": ([], "requests through 4 slots"),
}


def _run(example, args, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_TORCH_AUTOTUNE_CACHE=str(tmp_path / "autotune.json"))
    script = ROOT / "examples" / "torch" / f"{example}.py"
    p = subprocess.run([sys.executable, str(script), "--device", "cpu", *args], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-2000:]
    return p.stdout


@pytest.mark.parametrize("name", list(RUNS))
def test_example_runs(name, tmp_path):
    args, want = RUNS[name]
    out = _run(name.replace("_sparse", ""), args, tmp_path)
    assert want in out, out[-2000:]


def test_train_lm_resumes_from_its_checkpoint(tmp_path):
    """Three steps with a checkpoint, then a second process resumes at step
    3 and finishes step 5."""
    common = ["--smoke", "--batch", "2", "--seq-len", "32", "--ckpt-every", "2",
              "--ckpt-dir", str(tmp_path / "ck")]
    first = _run("train_lm", ["--steps", "3", *common], tmp_path)
    assert "step    0 loss" in first and first.rstrip().endswith("done")
    second = _run("train_lm", ["--steps", "5", *common], tmp_path)
    assert "resumed from step 3" in second and "step    4 loss" in second
