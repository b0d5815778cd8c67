"""The port's launchers (``python -m repro_torch.launch.train|serve``) and
the serve engine on a 2-rank mesh, on the CPU (``REPRO_TORCH_DEVICE=cpu``,
gloo groups).  The reference's launchers are not run here (they need
virtual XLA devices); each case holds the port to its own unsharded or
uninterrupted run, as the reference's tests of these paths do:

- train: SIGTERM mid-run, then a rerun, ends with params and optimizer
  state bit-equal to an uninterrupted 4-step run, and writes
  ``--monitor-out``; ``--tp 2`` on two ranks (tensor-parallel DTensor
  compute), and ``--tp 1`` on two (data-parallel: FSDP and sharded
  rows), stay within 1e-5 of the one-rank run (losses as printed, to
  1e-4; every param after 4 steps to an absolute 1e-5: the sharded
  contractions sum in another order);
- serve: ``--dp 2`` on two ranks gives the tokens of ``--dp 1`` (a
  one-rank mesh, the same counter key), and ``--continuous --dp 2`` those
  of ``--continuous`` without a mesh (the per-slot counter uniforms),
  for mamba2-370m too;
- the engine with ``mesh=`` a 2-rank (2, 1) mesh gives, on every rank,
  the tokens of the same six requests without a mesh (the twin of
  ``test_mesh_sharded_engine_bit_identical``), with each shard's plan
  tagged ``devices=2``;
- ``--app lda --smoke`` runs 2 sweeps."""

import json
import os
import re
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.dist.fault import CheckpointManager
from torch_ranks import free_port, run_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN = ["-m", "repro_torch.launch.train", "--arch", "llama3-8b", "--smoke", "--steps", "4",
         "--batch", "4", "--seq-len", "32", "--ckpt-every", "2", "--log-every", "1"]
SERVE = ["--requests", "8", "--max-new", "4"]
# the SSM family through the engine: its state, written whole into the
# engine's plain caches
SSM = SERVE + ["--arch", "mamba2-370m", "--continuous"]


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), REPRO_TORCH_DEVICE="cpu",
               OMP_NUM_THREADS="1")
    env.pop("REPRO_COORDINATOR", None)
    env.update({k: str(v) for k, v in extra.items()})
    return env


def _losses(text):
    return {int(m.group(1)): float(m.group(2))
            for m in re.finditer(r"step\s+(\d+) loss ([0-9.]+)", text)}


def _final_tree(ckpt):
    from repro_torch.dist.fault import _tree_leaves

    d = os.path.join(ckpt, "step_00000004")
    with open(os.path.join(d, "manifest.json")) as f:
        man = json.load(f)
    like = [torch.zeros(m["shape"]) for m in man["leaves"]]
    out, extra = CheckpointManager(ckpt).restore(like={f"{i:04d}": x for i, x in enumerate(like)})
    return _tree_leaves(out), extra, man


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    d = tmp_path_factory.mktemp("train_ref")
    out = subprocess.run([sys.executable, *TRAIN, "--ckpt-dir", str(d / "ck"),
                          "--monitor-out", str(d / "monitor.json")],
                         env=_env(), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return d, out.stdout


def test_train_sigterm_then_resume_is_bit_exact(uninterrupted, tmp_path):
    ref_dir, ref_out = uninterrupted
    mon = json.loads((ref_dir / "monitor.json").read_text())
    assert mon["summary"]["steps"] == 4 and mon["summary"]["hosts"] == 1
    assert len(mon["hosts"]) == 1

    ck = str(tmp_path / "ck")
    p = subprocess.Popen([sys.executable, *TRAIN, "--ckpt-dir", ck], env=_env(),
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    for line in p.stdout:          # the handler is installed before step 0
        if line.startswith("step     0"):
            p.send_signal(signal.SIGTERM)
            break
    rest, err = p.communicate(timeout=300)
    assert p.returncode == 0, err[-3000:]
    m = re.search(r"preempted; checkpoint committed at step (\d+)", rest)
    assert m, rest
    committed = int(m.group(1))
    assert 1 <= committed < 4
    assert CheckpointManager(ck).latest_step() == committed

    out = subprocess.run([sys.executable, *TRAIN, "--ckpt-dir", ck], env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert f"resumed from step {committed}" in out.stdout
    assert {s: v for s, v in _losses(out.stdout).items()} == \
        {s: v for s, v in _losses(ref_out).items() if s >= committed}
    got, gextra, gman = _final_tree(ck)
    want, wextra, wman = _final_tree(str(ref_dir / "ck"))
    assert gextra == wextra == {"cursor": {"seed": 0, "step": 4}, "step": 4}
    assert gman["files"] == wman["files"]          # the same bytes (sha256)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.slow
@pytest.mark.parametrize("tp", [2, 1], ids=["tp2", "dp2"])
def test_train_tp2_on_two_ranks_matches_one_rank(uninterrupted, tmp_path, tp):
    """``--tp 2`` (a (1, 2) mesh: heads, mlp and vocab split) and, as a
    second case, ``--tp 1`` on two ranks (a (2, 1) mesh: FSDP over
    ``embed``, each rank its own rows of every batch)."""
    ref_dir, ref_out = uninterrupted
    port = free_port()
    ck = str(tmp_path / "ck")
    procs = [subprocess.Popen([sys.executable, *TRAIN, "--ckpt-dir", ck, "--tp", str(tp)],
                              env=_env(REPRO_COORDINATOR=f"127.0.0.1:{port}",
                                       REPRO_NUM_PROCESSES=2, REPRO_PROCESS_ID=r),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in (0, 1)]
    outs = [p.communicate(timeout=400) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    got, want = _losses(outs[0][0]), _losses(ref_out)
    assert sorted(got) == [0, 1, 2, 3]
    assert all(abs(got[s] - want[s]) <= 1e-4 for s in got), (got, want)
    tp2, _, man = _final_tree(ck)
    one, _, _ = _final_tree(str(ref_dir / "ck"))
    assert man["topology"]["processes"] == 2 and man["topology"]["mesh"] == {"data": 2 // tp,
                                                                             "model": tp}
    assert man["files"]["1"]["nbytes"] > 0          # rank 1 wrote its own shards
    for a, b in zip(tp2, one):
        assert (a - b).abs().max().item() <= 1e-5


def _serve_worker(rank, world, out_dir):
    """Every case that needs the 2-rank group, in one spawn: the engine on
    a (2, 1) mesh with plain params, then the serve launcher's
    ``--dp 2`` and ``--continuous --dp 2`` (params placed by the rules;
    the latter for mamba2-370m too)."""
    import dataclasses

    from repro_torch.configs import base, get_config
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model, init_params
    from repro_torch.serve import ContinuousBatchingEngine, Request, SamplingParams

    res = {}
    mesh = make_host_mesh(model=1)
    for method in ("kernel", "butterfly"):
        cfg = dataclasses.replace(get_config("llama3-8b", smoke=True),
                                  sampler=base.SamplerSpec(method=method, W=8))
        model = build_model(cfg)
        params = init_params(0, model.specs, torch.float32, "cpu")

        def reqs():
            return [Request(prompt=np.arange(2 + i % 3, dtype=np.int32) + i, max_new_tokens=4,
                            seed=i, sampling=SamplingParams(temperature=0.8, top_p=0.9))
                    for i in range(6)]

        eng = ContinuousBatchingEngine(model, params, max_slots=8, max_len=32, mesh=mesh)
        res[f"engine_{method}"] = [r.output_tokens for r in eng.run(reqs())]
        res[f"shard_plan_{method}"] = [list(eng.plan.shape), eng.plan.devices]
        res[f"plain_{method}"] = [
            r.output_tokens for r in ContinuousBatchingEngine(
                model, params, max_slots=8, max_len=32).run(reqs())]
    shd.set_activation_sharding(None)
    for name, argv in (("dp2", SERVE + ["--dp", "2"]),
                       ("cont_dp2", SERVE + ["--continuous", "--dp", "2"]),
                       ("ssm_dp2", SSM + ["--dp", "2"])):
        res[name] = serve.run(serve.parser().parse_args(argv))["tokens"]
        shd.set_activation_sharding(None)
    with open(os.path.join(out_dir, f"serve{rank}.json"), "w") as f:
        json.dump(res, f)


def _serve_dp1(rank, world, out_dir):
    from repro_torch.launch import serve

    res = {"dp1": serve.run(serve.parser().parse_args(SERVE + ["--dp", "1"]))["tokens"]}
    with open(os.path.join(out_dir, "dp1.json"), "w") as f:
        json.dump(res, f)


@pytest.mark.slow
def test_serve_and_engine_on_two_ranks(tmp_path, monkeypatch):
    run_ranks(_serve_worker, tmp_path, 2)
    one = tmp_path / "one"
    one.mkdir()
    run_ranks(_serve_dp1, one, 1)
    monkeypatch.setenv("REPRO_TORCH_DEVICE", "cpu")
    from repro_torch.launch import serve

    cont = serve.run(serve.parser().parse_args(SERVE + ["--continuous"]))["tokens"]
    ssm = serve.run(serve.parser().parse_args(SSM))["tokens"]
    r0, r1 = (json.loads((tmp_path / f"serve{r}.json").read_text()) for r in range(2))
    dp1 = json.loads((one / "dp1.json").read_text())["dp1"]
    assert r0 == r1                                   # every rank ends with the same tokens
    for method in ("kernel", "butterfly"):
        assert r0[f"engine_{method}"] == r0[f"plain_{method}"], method
        # each shard's plan: its (4, V) rows, tagged with the 2 shards
        assert r0[f"shard_plan_{method}"][0][0] == 4, method
        assert r0[f"shard_plan_{method}"][1] == 2, method
    assert r0["dp2"] == dp1
    assert r0["cont_dp2"] == cont
    assert r0["ssm_dp2"] == ssm
    assert len(dp1) == 8 and all(len(t) == 4 for t in dp1)


def test_train_lda_smoke_runs_two_sweeps(monkeypatch, capsys):
    monkeypatch.setenv("REPRO_TORCH_DEVICE", "cpu")
    from repro_torch.launch import train

    out = train.train_lda(train.parser().parse_args(
        ["--app", "lda", "--smoke", "--steps", "2", "--log-every", "1"]))
    assert len(out["sweeps"]) == 2
    assert all(np.isfinite(s["perplexity"]) for s in out["sweeps"])
    assert "gibbs complete" in capsys.readouterr().out


def test_importing_the_launchers_starts_no_group():
    code = ("import repro_torch.launch.train, repro_torch.launch.serve, "
            "repro_torch.launch.mesh\nimport torch.distributed as d\n"
            "print(d.is_initialized())")
    out = subprocess.run([sys.executable, "-c", code], env=_env(), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "False", out.stderr[-2000:]
