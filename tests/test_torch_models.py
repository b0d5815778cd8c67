"""The port's configs and dense decoder stack (repro_torch.configs,
repro_torch.models) against the reference's (repro.configs, repro.models),
on the same weights: the reference's float32 parameters, carried across
by ``params_from_numpy``, and token ids made with numpy from a seed.

Tolerance: logits and cache leaves within rtol 1e-4, atol 1e-4 (float32
throughout; PyTorch and XLA sum the contractions in different orders).
"""

import ast
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import build_model as jbuild
from repro.models import init_params as jinit
from repro.models import layers as jlayers
from repro.models import params as jparams
from repro.serve.engine import _pad_caches_to as j_pad_caches_to
from repro_torch import configs as tconfigs
from repro_torch.models import attention as tattn
from repro_torch.models import build_model as tbuild
from repro_torch.models import layers as tlayers
from repro_torch.models import params as tparams

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-4, atol=1e-4)
DENSE = ("gemma2-9b", "llama3-8b", "qwen3-4b")
PADDED = dict(name="padded", family="dense", num_layers=2, d_model=32, num_heads=4,
              num_kv_heads=2, d_ff=64, vocab_size=50, pad_vocab_multiple=16)


def _configs(name):
    if name == "padded":
        return jconfigs.ModelConfig(**PADDED), tconfigs.ModelConfig(**PADDED)
    return jconfigs.get_config(name, smoke=True), tconfigs.get_config(name, smoke=True)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=DENSE + ("padded",))
def pair(request):
    jc, tc = _configs(request.param)
    jm, tm = jbuild(jc), tbuild(tc)
    jp = jinit(jax.random.PRNGKey(7), jm.specs, jnp.float32)
    tp = tparams.params_from_numpy(_np_tree(jp), device="cpu")
    toks = np.random.default_rng(3).integers(0, jc.vocab_size, (2, 24)).astype(np.int32)
    return jm, tm, jp, tp, toks


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               err_msg=what, **TOL)


def _close_tree(got, want, what):
    g, w = tparams.tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w), what
    for a, b in zip(g, w):
        assert tuple(a.shape) == tuple(b.shape), what
        _close(a.numpy(), b, what)


def test_lm_apply_matches_reference(pair):
    jm, tm, jp, tp, toks = pair
    jl, _ = jm.apply(jp, {"tokens": jnp.asarray(toks)}, remat="none")
    tl, _ = tm.apply(tp, {"tokens": torch.as_tensor(toks)})
    assert tl.shape == jl.shape
    _close(tl.numpy(), jl, "lm_apply logits")
    if tm.cfg.padded_vocab != tm.cfg.vocab_size:
        assert (tl[..., tm.cfg.vocab_size:] < -1e29).all()


def test_lm_prefill_matches_reference(pair):
    jm, tm, jp, tp, toks = pair
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(tp, {"tokens": torch.as_tensor(toks)})
    _close(tl.numpy(), jl, "prefill logits")
    _close_tree(tc, jc, "prefill caches")


@pytest.mark.parametrize("per_row", [False, True])
def test_lm_decode_matches_reference(pair, per_row):
    """Two decode steps on the prefilled caches grown to 40 positions, at a
    shared position and at per-row positions (one row behind the other)."""
    jm, tm, jp, tp, toks = pair
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    jc = j_pad_caches_to(jc, 40)
    tc = tparams.params_from_numpy(_np_tree(jc), device="cpu")
    rng = np.random.default_rng(4)
    for t in range(2):
        nt = rng.integers(0, jm.cfg.vocab_size, (2, 1)).astype(np.int32)
        if per_row:
            pos = np.array([24 + t, 9 + t], np.int32)
            jpos, tpos = jnp.asarray(pos), torch.as_tensor(pos)
        else:
            jpos, tpos = jnp.int32(24 + t), 24 + t
        jl, jc = jm.decode(jp, jc, jnp.asarray(nt), jpos)
        tl, tc = tm.decode(tp, tc, torch.as_tensor(nt), tpos)
        _close(tl.numpy(), jl, f"decode logits, step {t}")
        _close_tree(tc, jc, f"decode caches, step {t}")


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (1000, 50.0)])
def test_long_prefill_chunked_matches_reference(window, softcap):
    """Past CHUNKED_THRESHOLD (S = 4,352) attention runs query chunks of
    Q_CHUNK; with a window and a softcap, as the reference's."""
    S = 4352
    assert S > tattn.CHUNKED_THRESHOLD == jattn.CHUNKED_THRESHOLD
    assert tattn.Q_CHUNK == jattn.Q_CHUNK
    rng = np.random.default_rng(5)
    q = rng.normal(size=(1, S, 4, 8)).astype(np.float32)
    k = rng.normal(size=(1, S, 2, 8)).astype(np.float32)
    v = rng.normal(size=(1, S, 2, 8)).astype(np.float32)
    pos = np.arange(S)
    want = jattn._sdpa_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(pos), jnp.asarray(pos), causal=True,
                               window=window, softcap=softcap)
    got = tattn._sdpa_chunked(*(torch.as_tensor(x) for x in (q, k, v, pos, pos)),
                              causal=True, window=window, softcap=softcap)
    _close(got.numpy(), want, "chunked attention")
    dense = tattn._sdpa(*(torch.as_tensor(x) for x in (q[:, :300], k[:, :300], v[:, :300])),
                        tattn.attention_mask(torch.arange(300), torch.arange(300),
                                             window=window), softcap)
    _close(got[:, :300].numpy(), dense.numpy(), "chunked vs dense")


def test_gqa_attend_long_block_takes_chunked_path():
    cfg_kw = dict(name="long", family="dense", num_layers=1, d_model=16, num_heads=2,
                  num_kv_heads=1, d_ff=32, vocab_size=32, attn_softcap=50.0)
    jc, tc = jconfigs.ModelConfig(**cfg_kw), tconfigs.ModelConfig(**cfg_kw)
    spec = jattn.gqa_spec(jc)
    jp = jinit(jax.random.PRNGKey(1), spec, jnp.float32)
    tp = tparams.params_from_numpy(_np_tree(jp), device="cpu")
    S = tattn.CHUNKED_THRESHOLD + 64
    x = np.random.default_rng(6).normal(size=(1, S, 16)).astype(np.float32)
    jy, _ = jattn.gqa_attend(jp, jnp.asarray(x), jnp.arange(S), jc, window=512)
    ty, (k, v) = tattn.gqa_attend(tp, torch.as_tensor(x), torch.arange(S), tc, window=512)
    _close(ty.numpy(), jy, "gqa_attend, chunked")
    assert k.shape == (1, S, 1, 8)


def test_layers_match_reference():
    """The traps: tanh GELU, embed's bf16 scale, unembed's float32 softcap,
    RoPE's frequencies and per-row positions."""
    rng = np.random.default_rng(8)
    x = rng.normal(size=(3, 5, 16)).astype(np.float32) * 3
    np.testing.assert_allclose(tlayers._act("gelu")(torch.as_tensor(x)).numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(x))), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tlayers.rope_frequencies(64, 1e6).numpy(),
                               np.asarray(jlayers.rope_frequencies(64, 1e6)), rtol=1e-6)
    pos = rng.integers(0, 4000, (3, 5))
    xh = rng.normal(size=(3, 5, 2, 16)).astype(np.float32)
    _close(tlayers.apply_rope(torch.as_tensor(xh), torch.as_tensor(pos), 1e4).numpy(),
           jlayers.apply_rope(jnp.asarray(xh), jnp.asarray(pos), 1e4), "rope per-row")
    table = rng.normal(size=(11, 3584)).astype(np.float32)
    toks = np.array([[1, 4, 10]])
    tb = {"table": torch.as_tensor(table).to(torch.bfloat16)}
    jb = {"table": jnp.asarray(table, jnp.bfloat16)}
    got = tlayers.embed(tb, torch.as_tensor(toks), scale=True)
    want = jlayers.embed(jb, jnp.asarray(toks), scale=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    h = rng.normal(size=(2, 3584)).astype(np.float32)
    got = tlayers.unembed(None, torch.as_tensor(h).to(torch.bfloat16), tied_table=tb["table"],
                          softcap=30.0)
    want = jlayers.unembed(None, jnp.asarray(h, jnp.bfloat16), tied_table=jb["table"],
                           softcap=30.0)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=2 ** -7, atol=2 ** -7)


def test_decode_promotes_bf16_params_with_float32_caches():
    """bfloat16 parameters with the float32 caches the engine keeps: the
    step promotes as JAX does (float32 logits), and writes the caches in
    place."""
    cfg = tconfigs.get_config("gemma2-9b", smoke=True)
    m = tbuild(cfg)
    p = tparams.init_params(0, m.specs, torch.bfloat16, device="cpu")
    caches = tparams.init_params(0, m.cache_specs(2, 8), torch.float32, device="cpu")
    k0 = caches["attn"]["k"]
    logits, out = m.decode(p, caches, torch.tensor([[1], [2]]), torch.tensor([0, 3]))
    assert logits.dtype == torch.float32 and logits.shape == (2, cfg.vocab_size)
    assert out["attn"]["k"] is k0
    assert (k0[:, 0, 0] != 0).any() and (k0[:, 1, 3] != 0).any() and (k0[:, 0, 1:] == 0).all()


# -- configs and specs -----------------------------------------------------


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _prop(cfg, name):
    """A config property, or the type of what it raises (resolved_head_dim
    of an attention-free config divides by zero in both packages)."""
    try:
        return getattr(cfg, name)
    except ZeroDivisionError as e:
        return type(e)


def _plain(v):
    return dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v


@pytest.mark.parametrize("smoke", [False, True])
def test_get_config_resolves_all_architectures(smoke):
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS and len(tconfigs.ARCH_IDS) == 10
    for arch in tconfigs.ARCH_IDS:
        t, j = tconfigs.get_config(arch, smoke), jconfigs.get_config(arch, smoke)
        assert {k: _plain(v) for k, v in _fields(t).items()} == \
               {k: _plain(v) for k, v in _fields(j).items()}, arch
        for prop in ("padded_vocab", "resolved_head_dim", "q_per_kv"):
            assert _prop(t, prop) == _prop(j, prop), (arch, prop)
        assert _plain(t.sampler_spec) == _plain(j.sampler_spec)
        assert _plain(t.serve_spec) == _plain(j.serve_spec)
        assert [s.name for s in tconfigs.shapes_for(t)] == [s.name for s in jconfigs.shapes_for(j)]
    assert tconfigs.all_cells() == jconfigs.all_cells()
    assert set(tconfigs.SHAPES_BY_NAME) == set(jconfigs.SHAPES_BY_NAME)
    with pytest.raises(KeyError):
        tconfigs.get_config("gpt-2")


def test_gemma2_config_keeps_sampler_and_vocab():
    from repro_torch.configs import gemma2_9b

    assert gemma2_9b.CONFIG.sampler_spec is gemma2_9b.SAMPLER
    assert gemma2_9b.CONFIG.vocab_size == gemma2_9b.VOCAB_SIZE == 256000
    assert isinstance(gemma2_9b.SAMPLER, tconfigs.SamplerSpec)


@pytest.mark.parametrize("arch", DENSE + ("llama3-8b-full", "gemma2-9b-full"))
def test_specs_match_reference(arch):
    full = arch.endswith("-full")
    name = arch.removesuffix("-full")
    t = tbuild(tconfigs.get_config(name, smoke=not full))
    j = jbuild(jconfigs.get_config(name, smoke=not full))
    ts = tparams.tree_leaves(t.specs)
    js = jax.tree.leaves(j.specs, is_leaf=lambda x: hasattr(x, "axes"))
    assert [(s.shape, s.axes, s.init, s.scale) for s in ts] == \
           [(s.shape, s.axes, s.init, s.scale) for s in js]
    assert [tparams._fan_in(s) for s in ts] == [jparams._fan_in(s) for s in js]
    cs_t = tparams.tree_leaves(t.cache_specs(4, 64))
    cs_j = jax.tree.leaves(j.cache_specs(4, 64), is_leaf=lambda x: hasattr(x, "axes"))
    assert [s.shape for s in cs_t] == [s.shape for s in cs_j]
    assert tparams.param_count(t.specs) == sum(int(np.prod(s.shape)) for s in js)
    if arch == "gemma2-9b-full":
        assert tparams.param_count(t.specs) == 9_241_705_984
        assert tparams.param_bytes(t.specs) == 2 * 9_241_705_984
        meta = tparams.abstract_params(t.specs)
        assert meta["embed"]["table"].is_meta and meta["embed"]["table"].shape == (256000, 3584)
        assert tparams.logical_axes(t.specs)["embed"]["table"] == ("vocab", "embed")


def test_init_params_deterministic_and_on_the_asked_device():
    m = tbuild(tconfigs.get_config("qwen3-4b", smoke=True))
    a = tparams.init_params(torch.Generator().manual_seed(3), m.specs, device="cpu")
    b = tparams.init_params(3, m.specs, device="cpu")
    for x, y in zip(tparams.tree_leaves(a), tparams.tree_leaves(b)):
        assert x.device.type == "cpu" and torch.equal(x, y)
    assert torch.equal(a["final_norm"]["scale"], torch.ones(64))
    w = a["layers"]["attn"]["wq"]
    assert w.shape == (2, 64, 4, 16) and abs(float(w.std()) - 64 ** -0.5) < 0.01


def test_init_params_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m = tbuild(tconfigs.get_config("qwen3-4b", smoke=True))
    with pytest.raises(RuntimeError, match="CUDA"):
        tparams.init_params(0, m.specs)


def test_chip_smoke_imports_neither_jax_nor_repro():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.add(node.module.split(".")[0])
    assert "repro_torch" in mods
    assert not mods & {"jax", "jaxlib", "repro"}, mods
