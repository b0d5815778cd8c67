"""``BENCHMARK.json`` against the benchmark's contract: names, units,
sources, which cells report which metric, the files each name points to,
and the chip time a full check of 24 cells would take."""

import ast
import json
from pathlib import Path

import pytest

from bench import manifest

ROOT = manifest.ROOT
MAN = manifest.load(ROOT)
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
            "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_and_entry_keys():
    assert set(MAN) == TOP_KEYS
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer",
                                          "moves"}
        assert m["source"] in SOURCES
    assert len(json.dumps(MAN)) <= 64 * 1024


def test_name_unit_and_text_characters():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in MAN[k]]
    names += [w["config"] for w in MAN["workloads"]] + [w["traffic"] for w in MAN["workloads"]]
    names += [k for c in MAN["configs"] for k in c["reduced"]]
    for n in names:
        assert manifest.NAME_RE.match(n), n
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert manifest.UNIT_RE.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    texts = [x["why"] for k in ("configs", "workloads") for x in MAN[k]]
    texts += [c["source"] for c in MAN["configs"]] + [m["layer"] for m in MAN["per_layer"]]
    texts += MAN["command"]
    for t in texts:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t, t
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in MAN[k]}) == len(MAN[k])


def test_setup_metric_and_every_cell_reports_enough():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for w in MAN["workloads"]:
        reported = [m for m in MAN["end_to_end"] if manifest.reports(m, w["name"])]
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
        assert any(manifest.reports(m, w["name"]) for m in MAN["per_layer"])


def test_each_per_layer_metric_moves_a_metric_its_cells_report():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    cells = {w["name"] for w in MAN["workloads"]}
    for m in MAN["per_layer"]:
        moved = e2e[m["moves"]]
        for c in m.get("workloads", sorted(cells)):
            assert c in cells
            assert manifest.reports(moved, c), (m["name"], c)


def test_configs_and_cells_match():
    configs = {c["name"] for c in MAN["configs"]}
    used = {w["config"] for w in MAN["workloads"]}
    assert used == configs
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(set(pairs)) == len(pairs)
    fours = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert fours <= max(1, len(MAN["workloads"]) // 4)


def test_every_name_finds_its_files():
    paths = [Path(p) for p in MAN["paths"]]
    files = [c["file"] for c in MAN["configs"]]
    assert len(set(files)) == len(files)
    for c in MAN["configs"]:
        assert any(Path(c["file"]).parts[: len(p.parts)] == p.parts for p in paths)
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"]
        for k in ("M", "V", "K", "alpha", "beta", "max_len", "avg_len", "K_planted"):
            assert k in data, (c["name"], k)
    for w in MAN["workloads"]:
        mix = json.loads(manifest.mix_path(ROOT, w["traffic"]).read_text())
        assert {"gibbs_step", "reference", "checked_sweeps", "limits"} <= set(mix)
        assert manifest.cell(w["name"], ROOT).config["name"] == w["config"]
    for m in MAN["per_layer"]:
        assert callable(manifest.load_reader(ROOT, m["name"]).read)


def test_command_and_paths_stay_inside_the_benchmark():
    assert 1 <= len(MAN["paths"]) <= 16 and len(MAN["command"]) <= 32
    for p in MAN["paths"]:
        assert not p.startswith("/") and ".." not in Path(p).parts and len(p) <= 200
    for word in MAN["command"]:
        assert not word.startswith("/") and ".." not in word
        if "/" in word:
            assert any(word.startswith(p + "/") for p in MAN["paths"])


def test_a_full_check_of_24_cells_fits_its_time():
    rs = MAN["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("path", sorted(Path(__file__).parent.rglob("*.py")),
                         ids=lambda p: p.name)
def test_no_file_imports_jax_or_the_jax_package(path):
    tree = ast.parse(path.read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            tops.add(node.module.split(".")[0])
    assert not tops & manifest.FORBIDDEN_MODULES
    if path.name == "reference.py":
        assert "repro_torch" not in tops
    text = path.read_text()
    for old in ("bench" + "marks/", "BENCH" + "_"):   # the JAX package's old records
        assert old not in text


def test_forbidden_modules_compares_whole_top_level_names():
    assert manifest.forbidden_modules(["repro_torch", "repro_torch.lda", "reprox"]) == []
    assert manifest.forbidden_modules(["repro.lda.gibbs", "jax.numpy", "flax",
                                       "jaxlib.xla"]) == ["flax", "jax", "jaxlib", "repro"]
