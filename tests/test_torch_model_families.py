"""The port's MLA, cross-attention, MoE, SSM (SSD), hybrid and
encoder-decoder layers (repro_torch.models) against the reference's
(repro.models), on the same weights (float32, made with numpy from a
seed by the reference's init rule, carried across by
``params_from_numpy``) and the same inputs (numpy, from a seed).

Tolerance: rtol 1e-4, atol 1e-4 on values (float32; PyTorch and XLA sum
the contractions in different orders); 2e-4 where the reference's own
tests hold two forms of SSD or of MLA to each other (2e-3 for a decode
step against a full pass, as there).  Integers are exact: the experts each
token is routed to, its rank in its expert, and so the tokens the capacity
drops.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MLAConfig as JMLA
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import MoEConfig as JMoE
from repro.configs.base import SSMConfig as JSSM
from repro.models import attention as jattn
from repro.models import build_model as jbuild
from repro.models import params as jparams
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro_torch.configs import base as tbase
from repro_torch.models import attention as tattn
from repro_torch.models import build_model as tbuild
from repro_torch.models import moe as tmoe
from repro_torch.models import params_from_numpy
from repro_torch.models import ssm as tssm
from repro_torch.models.params import tree_leaves

TOL = dict(rtol=1e-4, atol=1e-4)
V = 64


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _close(got, want, what="", **tol):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                                          np.float32),
                               np.asarray(want, np.float32), err_msg=what, **(tol or TOL))


def _close_tree(got, want, what=""):
    g, w = tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w), what
    for a, b in zip(g, w):
        assert tuple(a.shape) == tuple(b.shape), what
        _close(a, b, what)


def _cfgs(**kw):
    """The same configuration in both packages (nested specs converted)."""
    conv = {"mla": (JMLA, tbase.MLAConfig), "moe": (JMoE, tbase.MoEConfig),
            "ssm": (JSSM, tbase.SSMConfig)}
    jkw, tkw = dict(kw), dict(kw)
    for k, (jc, tc) in conv.items():
        if k in kw:
            jkw[k], tkw[k] = jc(**kw[k]), tc(**kw[k])
    return JModelConfig(**jkw), tbase.ModelConfig(**tkw)


def _params(spec, seed=0):
    """Weights made with numpy from a seed: the reference's init rule
    (fan-in scaled normals, ones, zeros) without its per-leaf PRNG."""
    rng = np.random.default_rng(seed)

    def leaf(sp):
        if sp.init in ("zeros", "ones"):
            return np.full(sp.shape, sp.init == "ones", np.float32)
        std = sp.scale / np.sqrt(jparams._fan_in(sp))
        return (rng.normal(size=sp.shape) * std).astype(np.float32)

    arrs = jax.tree.map(leaf, spec, is_leaf=jparams.is_spec)
    return jax.tree.map(jnp.asarray, arrs), params_from_numpy(arrs, device="cpu")


def _jit(fn, *static):
    """The reference's function jitted (one compile beats its eager ops)."""
    return jax.jit(fn, static_argnums=static)


def _normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

MLA = dict(name="t", family="dense", num_layers=1, d_model=16, num_heads=2, num_kv_heads=2,
           d_ff=32, vocab_size=V, attention="mla",
           mla=dict(q_lora_rank=8, kv_lora_rank=8, qk_nope_head_dim=4, qk_rope_head_dim=4,
                    v_head_dim=4))


@pytest.fixture(scope="module")
def mla():
    jc, tc = _cfgs(**MLA)
    jp, tp = _params(jattn.mla_spec(jc))
    return jc, tc, jp, tp, _normal((2, 8, 16), 1)


def test_mla_full_matches_reference(mla):
    jc, tc, jp, tp, x = mla
    pos = np.arange(8)
    jy, jcache = _jit(jattn.mla_attend_full, 3)(jp, jnp.asarray(x), jnp.asarray(pos), jc)
    ty, tcache = tattn.mla_attend_full(tp, _t(x), _t(pos), tc)
    _close(ty, jy, "y")
    _close_tree(tcache, jcache, "latents")


@pytest.mark.parametrize("per_row", [False, True])
def test_mla_decode_matches_reference(mla, per_row):
    """The absorbed decode against a latent cache of 12 positions, at one
    shared position and at per-row positions (one row behind the other):
    the output and the cache, whose step rows are written in place."""
    jc, tc, jp, tp, _ = mla
    cache = {"c_kv": _normal((2, 12, 8), 2), "k_pe": _normal((2, 12, 4), 3)}
    x = _normal((2, 1, 16), 4)
    pos = np.array([9, 4], np.int32) if per_row else np.int32(9)
    jy, jcache = _jit(jattn.mla_attend_decode, 4)(jp, jnp.asarray(x),
                                                  jax.tree.map(jnp.asarray, cache),
                                                  jnp.asarray(pos), jc)
    tcache = params_from_numpy(cache, device="cpu")
    tpos = _t(pos) if per_row else 9
    ty, out = tattn.mla_attend_decode(tp, _t(x), tcache, tpos, tc)
    _close(ty, jy, "y")
    _close_tree(out, jcache, "cache")
    assert out["c_kv"] is tcache["c_kv"]


def test_mla_decode_matches_full(mla):
    """The absorbed decode equals the expanded full pass at the last position
    (the reference's own check, on the port)."""
    _, tc, _, tp, x = mla
    S = 8
    y_full, cache = tattn.mla_attend_full(tp, _t(x), torch.arange(S), tc)
    trunc = {k: torch.cat([v[:, : S - 1], torch.zeros_like(v[:, :1])], 1)
             for k, v in cache.items()}
    y_dec, _ = tattn.mla_attend_decode(tp, _t(x)[:, S - 1:], trunc, S - 1, tc)
    _close(y_dec[:, 0], y_full[:, -1], rtol=2e-4, atol=2e-4)


def test_cross_attention_matches_reference():
    jc, tc = _cfgs(name="t", family="encdec", num_layers=1, encoder_layers=1, d_model=16,
                   num_heads=4, num_kv_heads=2, d_ff=32, vocab_size=V)
    jp, tp = _params(jattn.cross_attention_spec(jc))
    x, mem = _normal((2, 5, 16), 1), _normal((2, 7, 16), 2)
    valid = np.array([True] * 5 + [False] * 2)
    jkv = jattn.cross_memory(jp, jnp.asarray(mem), jc)
    tkv = tattn.cross_memory(tp, _t(mem), tc)
    for a, b in zip(tkv, jkv):
        _close(a, b, "memory kv")
    for mv in (None, valid):
        jy = jattn.cross_attend(jp, jnp.asarray(x), jkv, jc,
                                None if mv is None else jnp.asarray(mv))
        ty = tattn.cross_attend(tp, _t(x), tkv, tc, None if mv is None else _t(mv))
        _close(ty, jy, f"cross_attend, memory_valid={mv}")


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def _moe(cf):
    return _cfgs(name="t", family="moe", num_layers=1, d_model=16, num_heads=2, num_kv_heads=2,
                 d_ff=0, vocab_size=V,
                 moe=dict(num_experts=4, top_k=2, expert_d_ff=16, capacity_factor=cf))


@pytest.mark.parametrize("cf", [8.0, 0.5], ids=["ample", "tight"])
@pytest.mark.parametrize("dispatch", ["einsum", "gather"])
def test_moe_matches_reference(dispatch, cf):
    """The output and the aux loss within TOL, and the routing exact: the
    same experts, the same rank in each expert, so the same drops."""
    jc, tc = _moe(cf)
    jp, tp = _params(jmoe.moe_spec(jc))
    x = _normal((2, 16, 16), 2)
    jy, jaux = _jit(jmoe.moe_block, 2, 3)(jp, jnp.asarray(x), jc, dispatch)
    ty, taux = tmoe.moe_block(tp, _t(x), tc, dispatch)
    _close(ty, jy, "y")
    _close(taux, jaux, "aux")
    G, g = tmoe._group(32, tc.moe)
    assert (G, g) == jmoe._group(32, jc.moe)
    C = tmoe._capacity(g, tc.moe)
    assert C == jmoe._capacity(g, jc.moe)
    xg = x.reshape(G, g, 16)
    _, jids, _ = _jit(jmoe._route, 2)(jp, jnp.asarray(xg), jc.moe)
    _, tids, _ = tmoe._route(tp, _t(xg), tc.moe)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    jpos, _ = jmoe._positions(jids, 4, 2)
    tpos, _ = tmoe._positions(tids, 4, 2)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    drops = int((tpos >= C).sum())
    assert (drops > 0) == (cf < 1), drops


def test_moe_dispatch_modes_agree_under_drops():
    _, tc = _moe(0.5)
    _, tp = _params(tmoe.moe_spec(tc))
    x = _t(_normal((2, 16, 16), 3))
    y_e, a_e = tmoe.moe_block(tp, x, tc, "einsum")
    y_g, a_g = tmoe.moe_block(tp, x, tc, "gather")
    _close(y_g, y_e, rtol=2e-5, atol=2e-5)
    assert float(a_e) == float(a_g)


def test_moe_gradients_match_reference():
    jc, tc = _moe(0.5)
    jp, tp = _params(jmoe.moe_spec(jc))
    x = _normal((2, 8, 16), 1)

    def jloss(p):
        y, aux = jmoe.moe_block(p, jnp.asarray(x), jc, "gather")
        return jnp.sum(y ** 2) + 0.01 * aux

    jg = jax.jit(jax.grad(jloss))(jp)
    leaves = [t.requires_grad_(True) for t in tree_leaves(tp)]
    y, aux = tmoe.moe_block(tp, _t(x), tc, "gather")
    tg = torch.autograd.grad(torch.sum(y ** 2) + 0.01 * aux, leaves)
    for a, b in zip(tg, jax.tree.leaves(jg)):
        _close(a, b, "grad")
    assert sum(float(a.norm()) > 0 for a in tg) >= 3


# ---------------------------------------------------------------------------
# SSM (SSD)
# ---------------------------------------------------------------------------


def _ssd_inputs(B, S, H, P, N, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, S, H, P)).astype(np.float32),
            rng.normal(size=(B, S, H, N)).astype(np.float32),
            rng.normal(size=(B, S, H, N)).astype(np.float32),
            rng.uniform(0.1, 0.9, size=(B, S, H)).astype(np.float32),
            (rng.normal(size=(H,)) * 0.3).astype(np.float32)]


@pytest.mark.parametrize("chunk", [4, 8, 32])
def test_ssd_chunked_matches_reference_and_recurrence(chunk):
    """The chunked dual form against the reference's at the same chunk, and
    against the step-by-step recurrence (float64 numpy), so every chunk
    size gives the same values."""
    args = _ssd_inputs(2, 32, 3, 4, 5, 0)
    jy, jh = _jit(jssm.ssd_chunked, 5)(*map(jnp.asarray, args), chunk)
    ty, th = tssm.ssd_chunked(*map(_t, args), chunk=chunk)
    _close(ty, jy, "y")
    _close(th, jh, "state")
    xh, bh, ch, dt, a_log = (a.astype(np.float64) for a in args)
    A = -np.exp(a_log)
    h = np.zeros((2, 3, 4, 5))
    ys = np.zeros((2, 32, 3, 4))
    for t in range(32):
        h = h * np.exp(dt[:, t] * A)[..., None, None] + np.einsum(
            "bhp,bhn->bhpn", xh[:, t] * dt[:, t][..., None], bh[:, t])
        ys[:, t] = np.einsum("bhn,bhpn->bhp", ch[:, t], h)
    _close(ty, ys, "y vs recurrence", rtol=2e-4, atol=2e-4)
    _close(th, h, "state vs recurrence", rtol=2e-4, atol=2e-4)


def test_ssd_chunk_must_divide():
    with pytest.raises(ValueError, match="chunk"):
        tssm.ssd_chunked(*map(_t, _ssd_inputs(1, 12, 2, 2, 2, 1)), chunk=8)


def test_ssd_gradient_finite_where_reference_is_nan():
    """Queue 3: the reference masks exp(diff) after the exp, so where the
    masked upper triangle overflows float32 its gradient is 0 * inf = NaN.
    The port masks before the exp: the same values, a finite gradient."""
    xh, bh, ch, dt, a_log = _ssd_inputs(1, 8, 2, 2, 2, 2)
    a_log = np.full_like(a_log, 5.0)    # A = -148: the log-decay falls by ~100 a step
    jg = jax.jit(jax.grad(lambda d: jnp.sum(jssm.ssd_chunked(
        jnp.asarray(xh), jnp.asarray(bh), jnp.asarray(ch), d, jnp.asarray(a_log), 8)[0])))(
        jnp.asarray(dt))
    assert np.isnan(np.asarray(jg)).any()
    d = _t(dt).requires_grad_(True)
    tg, = torch.autograd.grad(tssm.ssd_chunked(_t(xh), _t(bh), _t(ch), d, _t(a_log), 8)[0].sum(),
                              [d])
    assert torch.isfinite(tg).all()


SSM = dict(name="t", family="ssm", num_layers=2, d_model=16, num_heads=0, num_kv_heads=0,
           d_ff=0, vocab_size=V, attention="none",
           ssm=dict(state_dim=4, head_dim=4, num_heads=4, conv_width=4, chunk=4))


@pytest.mark.parametrize("S", [12, 10])
def test_ssm_block_matches_reference(S):
    """The full-sequence block, its front pad to a chunk multiple (S = 10)
    included, and the decode cache it leaves."""
    jc, tc = _cfgs(**SSM)
    jp, tp = _params(jssm.ssm_spec(jc))
    x = _normal((2, S, 16), 5)
    jy, jcache = _jit(jssm.ssm_block, 2)(jp, jnp.asarray(x), jc)
    ty, tcache = tssm.ssm_block(tp, _t(x), tc)
    _close(ty, jy, "y")
    _close_tree(tcache, jcache, "cache")


def test_ssm_decode_step_matches_reference():
    jc, tc = _cfgs(**SSM)
    jp, tp = _params(jssm.ssm_spec(jc))
    cache = {"h": _normal((2, 4, 4, 4), 6), "conv_x": _normal((2, 3, 16), 7),
             "conv_b": _normal((2, 3, 4), 8), "conv_c": _normal((2, 3, 4), 9)}
    x = _normal((2, 1, 16), 10)
    jy, jcache = _jit(jssm.ssm_decode_step, 3)(jp, jnp.asarray(x),
                                               jax.tree.map(jnp.asarray, cache), jc)
    tcache = params_from_numpy(cache, device="cpu")
    ty, out = tssm.ssm_decode_step(tp, _t(x), tcache, tc)
    _close(ty, jy, "y")
    _close_tree(out, jcache, "cache")
    assert out["h"] is tcache["h"]


# ---------------------------------------------------------------------------
# prefill + decode against a full pass, and against the reference
# ---------------------------------------------------------------------------

FAMILIES = {
    "ssm": SSM,
    "hybrid": dict(name="t", family="hybrid", num_layers=2, d_model=16, num_heads=4,
                   num_kv_heads=2, d_ff=32, vocab_size=V, meta_tokens=3, local_window=6,
                   ssm=dict(state_dim=4, head_dim=4, num_heads=4, conv_width=4, chunk=4)),
    "mla": dict(MLA, num_layers=2),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_prefill_decode_matches_full_and_reference(family):
    """Prefill 12 tokens, then decode tokens 12 and 13: each step's logits
    equal a full pass's at that position (rtol 2e-3, as the reference's
    test) and the reference's decode (TOL), caches included."""
    jc, tc = _cfgs(**FAMILIES[family])
    jm, tm = jbuild(jc), tbuild(tc)
    jp, tp = _params(jm.specs)
    toks = np.random.default_rng(0).integers(0, V, (2, 14)).astype(np.int32)
    full, _ = tm.apply(tp, {"tokens": _t(toks)}, remat="none")
    _, jcache = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks[:, :12])})
    _, tcache = tm.prefill(tp, {"tokens": _t(toks[:, :12])})
    _close_tree(tcache, jcache, "prefill caches")

    def grow(c):
        return jax.tree_util.tree_map_with_path(
            lambda p, l: (jnp.pad(l, [(0, 0), (0, 0), (0, 2)] + [(0, 0)] * (l.ndim - 3))
                          if {getattr(k, "key", None) for k in p} & {"k", "v", "c_kv", "k_pe"}
                          else l), c)

    jcache = grow(jcache)
    tcache = params_from_numpy(_np(jcache), device="cpu")
    pre = tc.meta_tokens
    jdecode = jax.jit(jm.decode)
    for s in (12, 13):
        jl, jcache = jdecode(jp, jcache, jnp.asarray(toks[:, s:s + 1]), jnp.int32(pre + s))
        tl, tcache = tm.decode(tp, tcache, _t(toks[:, s:s + 1]), pre + s)
        _close(tl, jl, f"decode logits at {s}")
        _close_tree(tcache, jcache, f"decode caches at {s}")
        _close(tl, full[:, s], f"decode vs full at {s}", rtol=2e-3, atol=2e-3)


# ---------------------------------------------------------------------------
# encoder-decoder
# ---------------------------------------------------------------------------

ENCDEC = dict(name="t", family="encdec", num_layers=2, encoder_layers=2, d_model=16,
              num_heads=4, num_kv_heads=2, d_ff=32, vocab_size=50, pad_vocab_multiple=16,
              frontend="audio")


def test_encdec_matches_reference():
    """apply, prefill (the cross KV computed once) and two decode steps
    against the reference, and decode against a full pass (rtol 2e-3)."""
    jc, tc = _cfgs(**ENCDEC)
    jm, tm = jbuild(jc), tbuild(tc)
    jp, tp = _params(jm.specs)
    src = _normal((2, 6, 16), 1, 0.5)
    tgt = np.random.default_rng(2).integers(0, 50, (2, 9)).astype(np.int32)
    jl, _ = jax.jit(lambda p, b: jm.apply(p, b, remat="none"))(
        jp, {"src_embeds": jnp.asarray(src), "tgt_tokens": jnp.asarray(tgt)})
    tl, aux = tm.apply(tp, {"src_embeds": _t(src), "tgt_tokens": _t(tgt)}, remat="none")
    assert float(aux) == 0.0 and tl.shape == (2, 9, 64)
    _close(tl, jl, "apply")
    assert (tl[..., 50:] < -1e29).all()
    jlast, jcache = jax.jit(jm.prefill)(jp, {"src_embeds": jnp.asarray(src),
                                             "tgt_tokens": jnp.asarray(tgt[:, :7])})
    tlast, tcache = tm.prefill(tp, {"src_embeds": _t(src), "tgt_tokens": _t(tgt[:, :7])})
    _close(tlast, jlast, "prefill logits")
    _close_tree(tcache, jcache, "prefill caches")
    from repro.serve.engine import _pad_caches_to as jpad
    from repro_torch.serve.engine import _pad_caches_to as tpad
    jcache = jpad(jcache, 9)
    tcache = tpad(tcache, 9)
    assert tcache["cross_k"].shape == (2, 2, 6, 2, 4) and tcache["self_k"].shape[2] == 9
    jdecode = jax.jit(jm.decode)
    for s in (7, 8):
        jl, jcache = jdecode(jp, jcache, jnp.asarray(tgt[:, s:s + 1]), jnp.int32(s))
        tl_s, tcache = tm.decode(tp, tcache, _t(tgt[:, s:s + 1]), s)
        _close(tl_s, jl, f"decode at {s}")
        _close_tree(tcache, jcache, f"decode caches at {s}")
        _close(tl_s, tl[:, s], f"decode vs apply at {s}", rtol=2e-3, atol=2e-3)


def test_encdec_cache_specs_split_the_budget():
    _, tc = _cfgs(**ENCDEC)
    spec = tbuild(tc).cache_specs(3, 21)
    assert spec["self_k"].shape == (2, 3, 10, 2, 4) and spec["cross_v"].shape == (2, 3, 11, 2, 4)


def test_encdec_decode_per_row_positions_match_scalar():
    """A (B,) position vector whose rows agree gives the scalar step's
    logits: the port reads per-row positions as (B, 1) RoPE positions.
    ROADMAP queue 3: the reference passes them on as (B,) and its RoPE
    broadcast fails for B > 1."""
    jc, tc = _cfgs(**ENCDEC)
    jm, tm = jbuild(jc), tbuild(tc)
    jp, tp = _params(jm.specs, 3)
    jcache = jparams.init_params(jax.random.PRNGKey(0), jm.cache_specs(2, 12), jnp.float32)
    with pytest.raises(ValueError, match="broadcast"):
        jm.decode(jp, jcache, jnp.zeros((2, 1), jnp.int32), jnp.array([3, 3], jnp.int32))
    src = _t(_normal((2, 6, 16), 1, 0.5))
    tgt = _t(np.random.default_rng(2).integers(0, 50, (2, 5)).astype(np.int32))
    _, c = tm.prefill(tp, {"src_embeds": src, "tgt_tokens": tgt[:, :4]})
    from repro_torch.serve.engine import _pad_caches_to
    c1 = _pad_caches_to(c, 6)
    c2 = {k: v.clone() for k, v in c1.items()}
    a, _ = tm.decode(tp, c1, tgt[:, 4:], 4)
    b, _ = tm.decode(tp, c2, tgt[:, 4:], torch.tensor([4, 4]))
    _close(b, a, rtol=1e-6, atol=1e-6)


def test_meta_and_frontend_prefixes_match_reference():
    """hymba-style meta tokens and the vlm stub frontend projection, in
    apply and prefill (their caches hold the prefix positions)."""
    for kw in (FAMILIES["hybrid"],
               dict(name="t", family="vlm", num_layers=2, d_model=16, num_heads=4,
                    num_kv_heads=2, d_ff=32, vocab_size=V, frontend="vision", frontend_len=3)):
        jc, tc = _cfgs(**kw)
        jm, tm = jbuild(jc), tbuild(tc)
        jp, tp = _params(jm.specs)
        toks = np.random.default_rng(1).integers(0, V, (2, 5)).astype(np.int32)
        jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": _t(toks)}
        if tc.frontend_len:
            fe = _normal((2, 3, 16), 4, 0.1)
            jb["frontend_embeds"], tb["frontend_embeds"] = jnp.asarray(fe), _t(fe)
        jl, _ = jax.jit(lambda p, b: jm.apply(p, b, remat="none"))(jp, jb)
        tl, _ = tm.apply(tp, tb, remat="none")
        assert tl.shape == (2, 5, V)
        _close(tl, jl, kw["family"])
        jlast, jcache = jax.jit(jm.prefill)(jp, jb)
        tlast, tcache = tm.prefill(tp, tb)
        _close(tlast, jlast, kw["family"])
        _close_tree(tcache, jcache, kw["family"])
