"""Whole runs of tiny cells on the CPU (the harness without its look for a
card): a sound run is correct; the control and each fault a sweep can
have make ``correct`` false; a new configuration, mix and metric are
found by name from files alone."""

import json
import shutil
import time

import pytest
import torch

from bench import harness, manifest, reference

TINY = dict(M=64, V=90, K=10, K_planted=10, avg_len=8.0, max_len=14)
ROUTES = ("lda-nytimes-k1000.dense", "lda-wikipedia-k240.sparse")


def tiny(name: str) -> manifest.Cell:
    c = manifest.cell(name)
    c.config.update(TINY)
    return c


def run(c: manifest.Cell, trace: bool = False, seed: int = 2**31 + 9) -> dict:
    return harness.run_cell(c, seed, 0.02, trace, "cpu", time.perf_counter())


def unchanged(step):
    return lambda state, corpus, **kw: state


def half_left_out(step):
    """The second half of the documents keeps its topics: left out of the
    draw, the counts and resample taken over what the first half drew."""
    def broken(state, corpus, **kw):
        old = state.z.clone()
        new = step(state, corpus, **kw)
        half = old.shape[0] // 2
        new.z[half:] = old[half:]
        return new
    return broken


def token_altered(step):
    """One live token's topic changed where it is drawn."""
    def broken(state, corpus, **kw):
        new = step(state, corpus, **kw)
        K = new.theta.shape[1]
        new.z[0, 0] = (new.z[0, 0] + 1) % K
        return new
    return broken


@pytest.mark.parametrize("name", ROUTES)
def test_a_sound_run_is_correct(name):
    r = run(tiny(name))
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"tokens_per_s", "setup_s"}
    assert all(v["value"] > 0 for v in r["metrics"].values())
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("name", ROUTES)
@pytest.mark.parametrize("fault", [unchanged, half_left_out, token_altered,
                                   "control"], ids=lambda f: getattr(f, "__name__", f))
def test_the_control_and_each_fault_are_not_correct(name, fault, monkeypatch):
    from repro_torch.lda import gibbs

    c = tiny(name)
    if fault == "control":
        monkeypatch.setattr(gibbs, "gibbs_step", reference.control_step(c.mix))
    else:
        monkeypatch.setattr(gibbs, "gibbs_step", fault(gibbs.gibbs_step))
    r = run(c)
    assert not r["correct"], r["checks"]


def test_a_new_config_mix_and_metric_need_only_new_files(tmp_path):
    """A scratch copy of the benchmark gains a configuration, a mix and a
    per-layer metric as new files and manifest entries; the harness finds
    them by name and runs the new cell."""
    root = tmp_path / "checkout"
    shutil.copytree(manifest.ROOT / "bench", root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    man = manifest.load()
    conf = json.loads((manifest.ROOT / man["configs"][0]["file"]).read_text())
    conf.update(TINY, name="tiny-lda")
    (root / "bench/configs/tiny-lda.json").write_text(json.dumps(conf))
    mix = json.loads(manifest.mix_path(manifest.ROOT, "dense").read_text())
    mix.update(gibbs_step={"method": "prefix"}, timing_seconds=0.05, checked_sweeps=2)
    (root / "bench/mixes/dense-prefix.json").write_text(json.dumps(mix))
    (root / "bench/metrics/sweep_ms.py").write_text(
        "def read(ctx):\n    return 1e3 * ctx.sweep_s\n")
    man["configs"].append({"name": "tiny-lda", "source": "a test", "reduced": [],
                           "file": "bench/configs/tiny-lda.json", "why": "a test"})
    man["workloads"].append({"name": "tiny-lda.dense-prefix", "config": "tiny-lda",
                             "traffic": "dense-prefix", "chips": 1, "why": "a test"})
    man["per_layer"].append({"name": "sweep_ms", "unit": "ms", "better": "lower",
                             "source": "host_clock", "layer": "sweep",
                             "moves": "tokens_per_s", "workloads": ["tiny-lda.dense-prefix"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    c = manifest.cell("tiny-lda.dense-prefix", root)
    assert c.mix["gibbs_step"] == {"method": "prefix"}
    assert [m["name"] for m in c.per_layer][-1] == "sweep_ms"
    r = run(c)
    assert r["correct"] and "tokens_per_s" in r["metrics"]
    r = run(c, trace=True)
    assert r["correct"] and r["metrics"]["sweep_ms"]["value"] > 0
    assert r["metrics"]["sweep_ms"]["unit"] == "ms"
    assert "k8_roofline" not in r["metrics"]   # nothing traced on a CPU


def test_the_reference_follows_the_port_on_the_cpu():
    """The judge's numbers are exactly 0 for the port's own sweeps: the same
    start, draws, counts and resample, read from the seed alone."""
    for name in ROUTES:
        c = tiny(name)
        corpus, prog, snaps, _ = harness.setup(c, 5, "cpu", time.perf_counter())
        checks = harness.check(c, corpus, snaps, 5, "cpu")
        assert all(v["value"] == 0 for v in checks.values()), checks
        assert len(snaps) == c.mix["checked_sweeps"] + 1
        assert not torch.equal(snaps[0][2], snaps[-1][2])
