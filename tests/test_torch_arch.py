"""The port's twin of ``test_arch_smoke.py``: every one of the ten
architectures at smoke size, built by ``repro_torch.models.build_model``,
against the reference on the same weights (the reference's float32
parameters carried across by ``params_from_numpy``) and the same batch
(``TokenPipeline``, bit-equal in both packages).

* Forward logits and one decode step: rtol 1e-4, atol 1e-4 (float32;
  PyTorch and XLA sum the contractions in different orders).
* One AdamW step: the loss and the gradient norm within rtol 1e-5; the
  updated parameters within atol 1e-4 at a step size of 5e-4, since Adam's
  first steps move each weight by about the step size whatever its
  gradient's size, so a gradient near zero that the two differ on by 1e-6
  of the norm moves its weight by a different fraction of it.
* ``remat="full"`` against ``"none"`` in the port: equal logits and equal
  gradients (rtol 2e-5, atol 2e-5, as the reference's test).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as jget
from repro.configs.base import ShapeConfig as JShape
from repro.data.pipeline import TokenPipeline as JPipe
from repro.models import build_model as jbuild
from repro.models import init_params as jinit
from repro.models.params import init_params as jinit_tree
from repro.train.optimizer import make_optimizer as jopt
from repro.train.train_step import make_train_step as jstep
from repro_torch.configs import get_config as tget
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.models import build_model as tbuild
from repro_torch.models import params_from_numpy
from repro_torch.models.params import tree_leaves
from repro_torch.train.optimizer import make_optimizer
from repro_torch.train.train_step import make_train_step

TOL = dict(rtol=1e-4, atol=1e-4)
SHAPE = ShapeConfig("smoke", seq_len=32, global_batch=4, kind="train")
OPT = dict(lr=1e-3, warmup=2, total_steps=10)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=ARCH_IDS)
def arch(request):
    """The reference's results for one architecture, computed once: its
    forward logits, one decode step and one AdamW step (jitted: compiling
    is quicker than running the scans op by op at this size)."""
    name = request.param
    jcfg, tcfg = jget(name, smoke=True), tget(name, smoke=True)
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    jp = jinit(jax.random.PRNGKey(0), jm.specs, jnp.float32)
    batch = TokenPipeline(tcfg, SHAPE, seed=0).next_batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    logits, aux = jax.jit(lambda p, b: jm.apply(p, b, remat="none"))(jp, jbatch)
    caches = jinit_tree(jax.random.PRNGKey(1), jm.cache_specs(2, 16), jnp.float32)
    tok = np.array([[3], [7]], np.int32)
    dec_logits, dec_caches = jax.jit(jm.decode)(jp, caches, jnp.asarray(tok), jnp.int32(5))
    opt = jopt("adamw", **OPT)
    p1, _, met = jax.jit(jstep(jm, opt, remat="none"))(jp, opt.init(jp), jbatch, jnp.int32(1))
    return dict(name=name, tm=tm, jp=_np(jp), batch=batch, logits=np.asarray(logits),
                aux=float(aux), caches=_np(caches), tok=tok, dec_logits=np.asarray(dec_logits),
                dec_caches=_np(dec_caches), p1=_np(p1), loss=float(met.loss),
                grad_norm=float(met.grad_norm))


def _tbatch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def test_pipeline_batch_matches_reference(arch):
    want = JPipe(jget(arch["name"], smoke=True), JShape("smoke", 32, 4, "train"),
                 seed=0).next_batch()
    assert sorted(want) == sorted(arch["batch"])
    for k in want:
        assert want[k].dtype == arch["batch"][k].dtype
        np.testing.assert_array_equal(arch["batch"][k], want[k])


def test_forward_matches_reference(arch):
    tm = arch["tm"]
    tp = params_from_numpy(arch["jp"], device="cpu")
    logits, aux = tm.apply(tp, _tbatch(arch["batch"]), remat="none")
    toks = arch["batch"].get("tgt_tokens", arch["batch"].get("tokens"))
    assert tuple(logits.shape) == (*toks.shape, tm.cfg.vocab_size)
    assert torch.isfinite(logits).all()
    np.testing.assert_allclose(logits.numpy(), arch["logits"], **TOL)
    np.testing.assert_allclose(float(aux), arch["aux"], **TOL)


def test_decode_step_matches_reference(arch):
    tm = arch["tm"]
    tp = params_from_numpy(arch["jp"], device="cpu")
    caches = params_from_numpy(arch["caches"], device="cpu")
    logits, out = tm.decode(tp, caches, torch.as_tensor(arch["tok"]), 5)
    assert tuple(logits.shape) == (2, tm.cfg.vocab_size) and torch.isfinite(logits).all()
    np.testing.assert_allclose(logits.numpy(), arch["dec_logits"], **TOL)
    got, want = tree_leaves(out), jax.tree.leaves(arch["dec_caches"])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, **TOL)


def test_adamw_train_step_matches_reference(arch):
    tm = arch["tm"]
    tp = params_from_numpy(arch["jp"], device="cpu")
    opt = make_optimizer("adamw", **OPT)
    p1, _, met = make_train_step(tm, opt, remat="none")(tp, opt.init(tp),
                                                        _tbatch(arch["batch"]), 1)
    assert np.isfinite(float(met.loss))
    np.testing.assert_allclose(float(met.loss), arch["loss"], rtol=1e-5)
    np.testing.assert_allclose(float(met.grad_norm), arch["grad_norm"], rtol=1e-5)
    got, want = tree_leaves(p1), jax.tree.leaves(arch["p1"])
    assert len(got) == len(want)
    for g, w, p0 in zip(got, want, tree_leaves(tp)):
        assert g.dtype == p0.dtype and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4)
    assert any(not torch.equal(a, b) for a, b in zip(got, tree_leaves(tp))), "no update"


def test_remat_full_matches_none(arch):
    """Per-layer recomputation changes neither the forward values nor the
    gradients."""
    tm = arch["tm"]
    outs = []
    for remat in ("none", "full"):
        tp = params_from_numpy(arch["jp"], device="cpu")
        leaves = [t.requires_grad_(True) for t in tree_leaves(tp)]
        logits, aux = tm.apply(tp, _tbatch(arch["batch"]), remat=remat)
        loss = logits.float().square().mean() + 0.01 * aux
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        outs.append((logits.detach(), grads))
    (l0, g0), (l1, g1) = outs
    np.testing.assert_allclose(l1.numpy(), l0.numpy(), rtol=2e-5, atol=2e-5)
    for a, b in zip(g0, g1):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=2e-5, atol=2e-5)
