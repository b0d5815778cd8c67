"""The port's training substrate (repro_torch.train, repro_torch.data)
against the reference's (repro.train, repro.data) on the same inputs, and
its own behaviour.

* Optimizers, step by step on the same parameters and the same gradients
  (numpy, from a seed), against the reference run op by op (under ``jit``
  XLA fuses multiply-adds and multiplies by a constant's reciprocal, so
  the jitted reference parts from itself in the last bit): AdamW's and
  8-bit AdamW's moments exact, so the 8-bit codes (int8 m, uint8 sqrt(v))
  and their block scales are equal;
  the updated parameters within rtol 1e-6, atol 1e-7 (float32; the step
  size and bias corrections are float32 scalars in both, but ``cos`` and
  ``pow`` may differ by an ulp).  Adafactor's factored moments and
  parameters within rtol 1e-5, atol 1e-7 (its row and column means sum
  in different orders).
* ``_schedule``, clipping and ``cross_entropy``: within rtol 1e-6.
* ``TokenPipeline``: bit-equal batches at every (seed, step, shard), and
  cursor restore.
* Training TINY lowers the loss with each optimizer, as the reference's
  test asks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import ShapeConfig as JShape
from repro.data.pipeline import TokenPipeline as JPipe
from repro.models import build_model as jbuild
from repro.models import init_params as jinit
from repro.train import optimizer as jopt
from repro.train.train_step import cross_entropy as jce
from repro.train.train_step import make_train_step as jstep
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.models import build_model, init_params, params_from_numpy
from repro_torch.models.params import ParamSpec, tree_leaves
from repro_torch.train import optimizer as topt
from repro_torch.train.train_step import (cross_entropy, global_norm, make_eval_step,
                                          make_train_step)

TINY = dict(name="tiny", family="dense", num_layers=2, d_model=32, num_heads=4,
            num_kv_heads=2, d_ff=64, vocab_size=64)
SHAPE = dict(name="t", seq_len=32, global_batch=8, kind="train")
OPT = dict(lr=1e-2, warmup=3, total_steps=20)


def _tree(seed):
    """A parameter-like tree: matrices, a stacked 3-d leaf, vectors, and
    leaves whose size is not a multiple of the 256-wide 8-bit block."""
    rng = np.random.default_rng(seed)
    shapes = {"a": {"w": (16, 40), "b": (40,)}, "stack": (2, 24, 30), "norm": (7,),
              "e": (300, 3)}

    def make(x):
        if isinstance(x, dict):
            return {k: make(v) for k, v in x.items()}
        return rng.normal(size=x).astype(np.float32)

    return make(shapes)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("name", ["adamw", "adamw8bit", "adafactor"])
def test_optimizer_steps_match_reference(name):
    """Four steps over warm-up and decay on the same gradients; the
    reference runs op by op (no jit, no fusion)."""
    params = _tree(0)
    jo = jopt.make_optimizer(name, **OPT)
    to = topt.make_optimizer(name, **OPT)
    jp, tp = jax.tree.map(jnp.asarray, params), params_from_numpy(params, device="cpu")
    js, ts = jo.init(jp), to.init(tp)
    exact = name != "adafactor"
    ptol = dict(rtol=1e-6, atol=1e-7) if exact else dict(rtol=1e-5, atol=1e-7)
    for step in range(4):
        grads = _tree(10 + step)
        jp, js = jo.update(jax.tree.map(jnp.asarray, grads), jp, js, step)
        tp, ts = to.update(params_from_numpy(grads, device="cpu"), tp, ts, step)
        for g, w in zip(tree_leaves(tp), jax.tree.leaves(jp)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=f"params {step}",
                                       **ptol)
        sg, sw = tree_leaves(ts), jax.tree.leaves(js)
        assert len(sg) == len(sw)
        for g, w in zip(sg, sw):
            assert str(g.dtype).replace("torch.", "") == str(w.dtype), (g.dtype, w.dtype)
            assert tuple(g.shape) == w.shape
            if exact:
                np.testing.assert_array_equal(g.numpy(), np.asarray(w), f"state {step}")
            else:
                np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-30)
    if name == "adamw8bit":
        codes = [x for x in tree_leaves(ts) if x.dtype in (torch.int8, torch.uint8)]
        assert len(codes) == 10 and all(bool((c != 0).any()) for c in codes)


def test_8bit_codes_round_half_to_even():
    """A block whose values land on .5 codes: both packages round half to
    even (not floor(x + 0.5))."""
    x = np.zeros(256, np.float32)
    x[0], x[1], x[2], x[3] = 127.0, 0.5, 1.5, -2.5
    jq, js = jopt._q8(jnp.asarray(x))
    tq, ts = topt._q8(torch.as_tensor(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert tq[0, 1:4].tolist() == [0, 2, -2]
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jq, _ = jopt._q8_sqrt(jnp.asarray(np.abs(x) ** 2))
    tq, _ = topt._q8_sqrt(torch.as_tensor(np.abs(x) ** 2))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))


def test_state_specs_match_reference():
    specs = {"w": ParamSpec((16, 40), ("embed", "mlp")), "b": ParamSpec((300,), ("mlp",))}
    from repro.models.params import ParamSpec as JSpec
    jspecs = {"w": JSpec((16, 40), ("embed", "mlp")), "b": JSpec((300,), ("mlp",))}
    for name in ("adamw", "adamw8bit", "adafactor"):
        got = topt.make_optimizer(name).state_specs(specs)
        want = jopt.make_optimizer(name).state_specs(jspecs)
        g, w = tree_leaves(got), jax.tree.leaves(want)
        assert [tuple(x.shape) for x in g] == [x.shape for x in w], name
        assert [str(x.dtype).replace("torch.", "") for x in g] == [str(x.dtype) for x in w]
        assert all(x.device.type == "meta" for x in g)
    with pytest.raises(ValueError, match="unknown optimizer"):
        topt.make_optimizer("sgd")


@pytest.mark.parametrize("warmup,total", [(3, 20), (2000, 100_000), (0, 1)])
def test_schedule_matches_reference(warmup, total):
    for step in (0, 1, 2, 3, 4, 7, 19, 20, 25, 1999, 2000, 50_000, 100_000):
        got = float(topt._schedule(step, 3e-4, warmup, total))
        want = float(jopt._schedule(jnp.int32(step), 3e-4, warmup, total))
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=str(step))


def test_cross_entropy_and_global_norm_match_reference():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(3, 7, 50)).astype(np.float32) * 3
    logits[..., 45:] = -1e30                      # padded columns
    labels = rng.integers(0, 45, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) > 0.3).astype(np.float32)
    for z in (0.0, 1e-4):
        jl, jc = jce(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask), z)
        tl, tc = cross_entropy(torch.as_tensor(logits), torch.as_tensor(labels),
                               torch.as_tensor(mask), z)
        np.testing.assert_allclose([float(tl), float(tc)], [float(jl), float(jc)], rtol=1e-6)
    zero = torch.zeros((3, 7))
    tl, tc = cross_entropy(torch.as_tensor(logits), torch.as_tensor(labels), zero)
    assert float(tl) == float(tc) == 0.0          # an all-masked batch divides by 1
    tree = _tree(3)
    from repro.train.train_step import global_norm as jgn
    np.testing.assert_allclose(float(global_norm(params_from_numpy(tree, device="cpu"))),
                               float(jgn(jax.tree.map(jnp.asarray, tree))), rtol=1e-6)


def _tiny():
    jm = jbuild(JModelConfig(**TINY))
    tm = build_model(ModelConfig(**TINY))
    jp = jinit(jax.random.PRNGKey(0), jm.specs, jnp.float32)
    tp = params_from_numpy(_np(jp), device="cpu")
    return jm, tm, jp, tp


@pytest.mark.parametrize("clip", [1.0, 0.05])
def test_train_step_clipping_matches_reference(clip):
    """One step with the gradient norm above and far above the clip: the
    loss, the norm (before clipping) and the clipped update."""
    jm, tm, jp, tp = _tiny()
    batch = TokenPipeline(ModelConfig(**TINY), ShapeConfig(**SHAPE), seed=0).next_batch()
    jo, to = jopt.make_optimizer("adamw", **OPT), topt.make_optimizer("adamw", **OPT)
    # AdamW's first update is nearly scale-invariant, so the clipped
    # gradients are read through m = (1 - b1) * g
    jp1, js, jm1 = jax.jit(jstep(jm, jo, remat="none", grad_clip=clip))(
        jp, jo.init(jp), {k: jnp.asarray(v) for k, v in batch.items()}, jnp.int32(0))
    tp1, ts, tm1 = make_train_step(tm, to, remat="none", grad_clip=clip)(
        tp, to.init(tp), {k: torch.as_tensor(v) for k, v in batch.items()}, 0)
    np.testing.assert_allclose(float(tm1.loss), float(jm1.loss), rtol=1e-5)
    np.testing.assert_allclose(float(tm1.grad_norm), float(jm1.grad_norm), rtol=1e-5)
    assert float(tm1.grad_norm) > clip
    m_norm = float(global_norm({k: v["m"] for k, v in _flat_state(ts).items()}))
    # m = (1 - b1) * clipped grads, whose norm is the clip
    np.testing.assert_allclose(m_norm, (1 - 0.9) * clip, rtol=1e-4)
    assert int(tm1.tokens) == 8 * 31


def _flat_state(state, prefix=""):
    out = {}
    for k, v in state.items():
        if "m" in v and not isinstance(v["m"], dict):
            out[prefix + k] = v
        else:
            out.update(_flat_state(v, prefix + k + "."))
    return out


@pytest.mark.parametrize("opt_name", ["adamw", "adamw8bit", "adafactor"])
def test_loss_decreases_on_tiny(opt_name):
    """30 steps on TINY lower the mean loss of the last five by 0.2 below the
    first five (the reference's test), and eval's CE follows."""
    _, tm, _, tp = _tiny()
    opt = topt.make_optimizer(opt_name, lr=1e-2, warmup=10, total_steps=200)
    state = opt.init(tp)
    step_fn = make_train_step(tm, opt, remat="none")
    pipe = TokenPipeline(ModelConfig(**TINY), ShapeConfig(**SHAPE), seed=0)
    eval_fn = make_eval_step(tm)
    held = {k: torch.as_tensor(v) for k, v in pipe.next_batch().items()}
    ce0 = float(eval_fn(tp, held))
    losses = []
    for step in range(30):
        batch = {k: torch.as_tensor(v) for k, v in pipe.next_batch().items()}
        tp, state, m = step_fn(tp, state, batch, step)
        losses.append(float(m.loss))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2, losses[::6]
    assert float(eval_fn(tp, held)) < ce0


def test_8bit_tracks_fp32():
    _, tm, _, tp = _tiny()
    pipe = TokenPipeline(ModelConfig(**TINY), ShapeConfig(**SHAPE), seed=0)
    runs = {}
    for name in ("adamw", "adamw8bit"):
        opt = topt.make_optimizer(name, lr=1e-2, warmup=10, total_steps=200)
        p, s = tp, opt.init(tp)
        f = make_train_step(tm, opt, remat="none")
        pipe.restore({"seed": 0, "step": 0})
        for step in range(10):
            p, s, m = f(p, s, {k: torch.as_tensor(v) for k, v in pipe.next_batch().items()},
                        step)
        runs[name] = float(m.loss)
    assert abs(runs["adamw"] - runs["adamw8bit"]) / runs["adamw"] < 0.05, runs


# ---------------------------------------------------------------------------
# TokenPipeline
# ---------------------------------------------------------------------------

PIPE_CFGS = {
    "tokens": TINY,
    "frontend": dict(TINY, family="vlm", frontend="vision", frontend_len=8),
    "encdec": dict(TINY, family="encdec", encoder_layers=2, frontend="audio"),
}


@pytest.mark.parametrize("kind", sorted(PIPE_CFGS))
def test_pipeline_bit_equal_to_reference(kind):
    for seed, shards in ((0, 1), (7, 2), (123, 4)):
        for shard in range(shards):
            j = JPipe(JModelConfig(**PIPE_CFGS[kind]), JShape(**SHAPE), seed=seed,
                      num_shards=shards, shard=shard)
            t = TokenPipeline(ModelConfig(**PIPE_CFGS[kind]), ShapeConfig(**SHAPE), seed=seed,
                              num_shards=shards, shard=shard)
            assert t.local_batch == j.local_batch == 8 // shards
            for _ in range(3):
                a, b = t.next_batch(), j.next_batch()
                assert sorted(a) == sorted(b)
                for k in a:
                    assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
                    np.testing.assert_array_equal(a[k], b[k])
            assert t.cursor() == j.cursor()


def test_pipeline_cursor_restore_and_shards():
    cfg, shape = ModelConfig(**TINY), ShapeConfig(**SHAPE)
    p1 = TokenPipeline(cfg, shape, seed=7)
    b1 = [p1.next_batch()["tokens"] for _ in range(3)]
    p2 = TokenPipeline(cfg, shape, seed=7)
    p2.restore({"seed": 7, "step": 2})
    np.testing.assert_array_equal(p2.next_batch()["tokens"], b1[2])
    assert p2.cursor() == {"seed": 7, "step": 3}
    a = TokenPipeline(cfg, shape, seed=7, num_shards=2, shard=0)
    b = TokenPipeline(cfg, shape, seed=7, num_shards=2, shard=1)
    assert not np.array_equal(a.next_batch()["tokens"], b.next_batch()["tokens"])
    with pytest.raises(ValueError, match="shards"):
        TokenPipeline(cfg, shape, num_shards=3)


# ---------------------------------------------------------------------------
# vocabulary padding (the port's twin of test_vocab_padding.py)
# ---------------------------------------------------------------------------

VCFG = dict(name="t", family="dense", num_layers=2, d_model=32, num_heads=4, num_kv_heads=2,
            d_ff=64, vocab_size=50)


def test_padded_shapes_and_masking():
    cfg = ModelConfig(**VCFG, pad_vocab_multiple=16)
    assert cfg.padded_vocab == 64
    model = build_model(cfg)
    params = init_params(0, model.specs, device="cpu")
    assert params["embed"]["table"].shape[0] == 64
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, 50, (2, 12)))
    logits, _ = model.apply(params, {"tokens": toks}, remat="none")
    assert logits.shape[-1] == 64
    assert (logits[..., 50:] < -1e29).all() and torch.isfinite(logits[..., :50]).all()


def test_loss_unchanged_by_padding():
    """The same parameters embedded in the padded tables give the same CE,
    to the bit."""
    toks = torch.as_tensor(np.random.default_rng(1).integers(0, 50, (2, 16)))
    model_a = build_model(ModelConfig(**VCFG))
    params_a = init_params(0, model_a.specs, device="cpu")
    model_b = build_model(ModelConfig(**VCFG, pad_vocab_multiple=16))
    params_b = init_params(1, model_b.specs, device="cpu")
    params_b["embed"]["table"][:50] = params_a["embed"]["table"]
    params_b["unembed"]["table"][:, :50] = params_a["unembed"]["table"]
    params_b["layers"] = params_a["layers"]
    params_b["final_norm"] = params_a["final_norm"]
    la, _ = model_a.apply(params_a, {"tokens": toks}, remat="none")
    lb, _ = model_b.apply(params_b, {"tokens": toks}, remat="none")
    labels = toks[:, 1:]
    mask = torch.ones(labels.shape)
    ca, _ = cross_entropy(la[:, :-1], labels, mask, z_loss=0.0)
    cb, _ = cross_entropy(lb[:, :-1], labels, mask, z_loss=0.0)
    assert float(ca) == float(cb)


def test_padded_train_step_matches_reference_and_never_samples_pads():
    """A train step on the padded vocabulary equals the reference's; the
    padded rows of the tables get no gradient (their logits are masked),
    and ``generate`` never returns a padded id."""
    jcfg = JModelConfig(**VCFG, pad_vocab_multiple=16, sampler_method="fenwick", sampler_W=8)
    tcfg = ModelConfig(**VCFG, pad_vocab_multiple=16, sampler_method="fenwick", sampler_W=8)
    jm, tm = jbuild(jcfg), build_model(tcfg)
    jp = jinit(jax.random.PRNGKey(3), jm.specs, jnp.float32)
    tp = params_from_numpy(_np(jp), device="cpu")
    batch = TokenPipeline(tcfg, ShapeConfig(**SHAPE), seed=2).next_batch()
    jo, to = jopt.make_optimizer("adamw", **OPT), topt.make_optimizer("adamw", **OPT)
    _, _, jmet = jax.jit(jstep(jm, jo, remat="none"))(
        jp, jo.init(jp), {k: jnp.asarray(v) for k, v in batch.items()}, jnp.int32(1))
    tp1, ts, tmet = make_train_step(tm, to, remat="none")(
        tp, to.init(tp), {k: torch.as_tensor(v) for k, v in batch.items()}, 1)
    np.testing.assert_allclose(float(tmet.loss), float(jmet.loss), rtol=1e-5)
    assert torch.equal(ts["unembed"]["table"]["m"][:, 50:],
                       torch.zeros_like(ts["unembed"]["table"]["m"][:, 50:]))
    from repro_torch.serve import generate
    toks = torch.as_tensor(np.random.default_rng(2).integers(0, 50, (3, 8)))
    r = generate(tm, tp1, {"tokens": toks}, max_new_tokens=12, temperature=1.5,
                 generator=torch.Generator().manual_seed(4))
    assert (r.tokens < 50).all(), r.tokens.max()
