"""Temperature scaling of logits follows the reference's dtype promotion,
on the CPU with the same numpy inputs: a Python scalar temperature is
weakly typed (bf16 and fp16 logits are divided by the temperature rounded
to their dtype, and stay in it), a float32 tensor, 0-d or (B,), promotes
bf16 and fp16 logits to float32 weights.

Tolerance: bf16 and fp16 weights, and the scaled logits, are equal bit
for bit.  float32 weights come from ``exp``, whose last place differs
between XLA and PyTorch, so they are held within a relative 2e-6 and by
draws on the same uniforms, where a mismatch must be a float64-checked
boundary tie (``ref.boundary_ties``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import sampling as jsampling
from repro.sampling.distribution import logits_to_weights as jax_logits_to_weights
from repro_torch import sampling
from repro_torch.core.reference import draw_prefix
from repro_torch.kernels.butterfly_sample.ref import boundary_ties
from repro_torch.sampling import transforms as ttr
from repro_torch.sampling.distribution import logits_to_weights
from repro_torch.sampling.plan import _scale

DTYPES = [(torch.bfloat16, jnp.bfloat16), (torch.float16, jnp.float16),
          (torch.float32, jnp.float32)]
TEMPERATURES = ["python 0.7", "python 1.3", "0-d float32 0.7", "(8,) float32"]


def _logits(seed=0, B=8, V=1000):
    return (3.0 * np.random.default_rng(seed).standard_normal((B, V))).astype(np.float32)


def _temperature(kind: str, B: int = 8):
    """(port's, reference's) temperature of one kind."""
    if kind.startswith("python"):
        t = float(kind.split()[1])
        return t, t
    if kind.startswith("0-d"):
        return torch.tensor(0.7, dtype=torch.float32), jnp.asarray(np.float32(0.7))
    t = np.random.default_rng(B).uniform(0.5, 1.5, B).astype(np.float32)
    return torch.as_tensor(t), jnp.asarray(t)


def _same_draws(got: torch.Tensor, want: np.ndarray, seed: int):
    """Prefix draws on the two weight sets with one set of uniforms: equal,
    or float64-checked boundary ties."""
    u = np.random.default_rng(seed).uniform(0, 1, got.shape[0]).astype(np.float32)
    w64 = torch.as_tensor(want.astype(np.float64))
    a = draw_prefix(got.to(torch.float64), torch.as_tensor(u, dtype=torch.float64))
    b = draw_prefix(w64, torch.as_tensor(u, dtype=torch.float64))
    res = boundary_ties(a, b, torch.as_tensor(want.astype(np.float32)), torch.as_tensor(u))
    assert res["faults"] == 0, res


@pytest.mark.parametrize("temperature", TEMPERATURES)
@pytest.mark.parametrize("dtype,jdtype", DTYPES, ids=["bf16", "fp16", "fp32"])
def test_logits_to_weights_follows_reference_promotion(dtype, jdtype, temperature):
    """Equal dtypes in every case; bf16 and fp16 weights bit-equal; float32
    weights equal up to ``exp``'s last place (draws tie-checked)."""
    x = _logits()
    t, tj = _temperature(temperature)
    got = logits_to_weights(torch.as_tensor(x).to(dtype), t)
    want = jax_logits_to_weights(jnp.asarray(x).astype(jdtype), tj)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    if got.dtype in (torch.bfloat16, torch.float16):
        wanted = torch.as_tensor(np.asarray(want.astype(jnp.float32))).to(got.dtype)
        assert torch.equal(got.view(torch.int16), wanted.view(torch.int16))
    else:
        want32 = np.asarray(want.astype(jnp.float32))
        np.testing.assert_allclose(got.float().numpy(), want32, rtol=2e-6, atol=0)
        _same_draws(got.float(), want32, seed=len(temperature))


def test_temperature_of_keeps_python_scalars_weak():
    """A chain's Temperature times a Python temperature stays a Python
    scalar (the reference's weak type), formed in float32; a tensor factor
    makes a tensor."""
    chain = (ttr.Temperature(2.0),)
    t = ttr.temperature_of(chain, 0.7)
    assert isinstance(t, float) and t == float(np.float32(0.7) * np.float32(2.0))
    assert ttr.temperature_of((ttr.Temperature(3),), 2) == 6.0
    assert isinstance(ttr.temperature_of((ttr.Temperature(torch.tensor(2.0)),), 0.7),
                      torch.Tensor)
    x = torch.as_tensor(_logits()).to(torch.bfloat16)
    assert logits_to_weights(x, t).dtype == torch.bfloat16


@pytest.mark.parametrize("method", ["prefix", "kernel"])
def test_plan_build_from_bf16_logits_matches_reference(method):
    """``plan(m).build_from_logits(bf16 logits, 0.7)`` then ``draw(u=)``
    draws the reference's indices (boundary ties only) from bit-equal bf16
    weights."""
    x = _logits(seed=3, B=16, V=500)
    u = np.random.default_rng(4).uniform(0, 1, 16).astype(np.float32)
    tp = sampling.plan((16, 500), method=method, dtype="bfloat16")
    jp = jsampling.plan((16, 500), method=method, dtype="bfloat16")
    td = tp.build_from_logits(torch.as_tensor(x).to(torch.bfloat16), 0.7)
    jd = jp.build_from_logits(jnp.asarray(x).astype(jnp.bfloat16), 0.7)
    got = td.draw(u=torch.as_tensor(u))
    want = np.asarray(jd.draw(u=jnp.asarray(u)))
    wb = logits_to_weights(torch.as_tensor(x).to(torch.bfloat16), 0.7)
    wj = jax_logits_to_weights(jnp.asarray(x).astype(jnp.bfloat16), 0.7)
    assert torch.equal(wb.float(), torch.as_tensor(np.asarray(wj.astype(jnp.float32))))
    res = boundary_ties(got, want, wb.float(), torch.as_tensor(u))
    assert res["faults"] == 0, res


@pytest.mark.parametrize("temperature", ["python 0.7", "0-d float32 0.7", "(8,) float32"])
def test_gumbel_scale_follows_reference_promotion(temperature):
    """The gumbel path's logit scaling (``plan._scale``) is the reference's
    ``logits / jnp.asarray(t)``: the same dtype (bf16 for a Python
    temperature, float32 for a float32 tensor) and the same bits."""
    x = _logits()
    t, tj = _temperature(temperature)
    got = _scale(torch.as_tensor(x).to(torch.bfloat16), t)
    tj = jnp.asarray(tj)
    want = jnp.asarray(x).astype(jnp.bfloat16) / (tj[:, None] if tj.ndim == 1 else tj)
    want = torch.as_tensor(np.asarray(want.astype(jnp.float32)))
    if temperature.startswith("python"):
        assert got.dtype == torch.bfloat16
        assert torch.equal(got.float(), want)
    else:
        assert got.dtype == torch.float32
        assert torch.equal(got, want)
