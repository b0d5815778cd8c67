"""``Categorical`` — a batch of categorical distributions with its built
draw state, the counterpart of ``repro.sampling.distribution``.

The paper's reusable table (and its siblings) is built once from a weight
matrix and searched per draw.  A :class:`Categorical` is a plain object
that holds that state as tensors on one device (JAX's pytree registration
has no counterpart here); ``method``, ``W`` and the unpadded ``shape``
travel with it.

State per variant (a dict of tensors):

  ============  =====================================================
  prefix        ``prefix``  (B, K) inclusive prefix sums
  fenwick       ``table``   (B, Kp) per-sample segment table
  butterfly     ``table``   (G, nb, W, W) paper-faithful butterfly table
                (K1 on CUDA)
  two_level     ``blocks``  (B, nb, W), ``running`` (B, nb)
  kernel        ``weights`` (B, K) weights, ``running`` (B, nb) running
                block sums (pass A, K2 on CUDA)
  lda_kernel    ``theta`` (C, K) / ``phi`` (V, K) factors,
                ``doc_ids`` / ``words`` (B,) row selectors,
                ``running`` (B, nb) factored pass-A running block sums
  gumbel        ``logw``    (B, K) log-weights, -inf where w = 0
  alias         ``prob`` / ``alias`` (B, K) Walker/Vose tables
  alias_device  ``prob`` / ``alias`` (B, K), built by the split-based
                PSA build (``kernels.alias_build``, K13 on CUDA)
  radix_forest  ``cdf`` (B, K) normalized prefix sums, ``root`` (B, M+1)
  ============  =====================================================

The u-driven variants (:data:`U_VARIANTS`) draw from given uniforms or
from a ``torch.Generator``; the key-driven ones (:data:`KEY_VARIANTS`)
need the generator (the reference's ``jax.random`` key).  The two
frameworks give different numbers from one seed: tests feed both the same
uniforms, or compare key-driven draws by chi-squared.

The reference's ``kernel`` state pads the weights' columns to its column
tile; :func:`kernel_state_from_numpy` and :func:`kernel_state_to_numpy`
carry that state between the two packages as numpy arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import alias as _alias
from repro_torch.core import butterfly as _bfly
from repro_torch.core import gumbel as _gumbel
from repro_torch.core import radix as _radix
from repro_torch.kernels import runtime
from repro_torch.kernels.butterfly_sample import ops as _kops
from repro_torch.kernels.butterfly_table import ops as _tops

VARIANTS = (
    "prefix", "fenwick", "butterfly", "two_level", "kernel", "gumbel",
    "alias", "lda_kernel", "alias_device", "radix_forest",
)
FACTORED_VARIANTS = ("lda_kernel",)
U_VARIANTS = (
    "prefix", "fenwick", "butterfly", "two_level", "kernel", "lda_kernel",
    "radix_forest",
)
KEY_VARIANTS = ("gumbel", "alias", "alias_device")
# variants whose (S, B) uniforms go to one pass-B launch (rows indirection)
_MULTI_U = ("kernel", "lda_kernel")

# table builds since the last reset — the "zero rebuilds" witness
_BUILD_COUNT = 0


def build_count() -> int:
    return _BUILD_COUNT


def _note_build() -> None:
    global _BUILD_COUNT
    _BUILD_COUNT += 1


def _float_like(weights: torch.Tensor) -> torch.Tensor:
    if weights.dtype not in (torch.float32, torch.float64):
        return weights.to(torch.float32)
    return weights


def as_tensor(x, device=None) -> torch.Tensor:
    """``x`` as a tensor: a tensor stays where it is unless ``device`` is
    given; anything else goes to ``device`` (default ``cuda``)."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(runtime.resolve_device(device))
    return torch.as_tensor(np.asarray(x), device=runtime.resolve_device(device))


def _uniforms(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    return torch.rand(shape, generator=generator, device=device)


# ---------------------------------------------------------------------------
# State builders
# ---------------------------------------------------------------------------


def _build_state(method: str, weights: torch.Tensor, W: int) -> Dict[str, Any]:
    """The draw state of ``method`` for (B, K) ``weights``."""
    if method == "prefix":
        return {"prefix": torch.cumsum(_float_like(weights), dim=-1)}
    if method == "fenwick":
        wp, _, _ = _bfly._prep(weights, W, group_pad=False)
        return {"table": _bfly.build_fenwick_table(wp, W)}
    if method == "butterfly":
        wp, _, _ = _bfly._prep(weights, W, group_pad=True)
        return {"table": _tops.butterfly_table(wp, W, layout="blocks")}
    if method == "two_level":
        blocks, running = _bfly.two_level_state(weights, W)
        return {"blocks": blocks, "running": running}
    if method == "kernel":
        wp, running = _kops.build_block_sums(weights, W=W)
        return {"weights": wp, "running": running}
    if method == "gumbel":
        return {"logw": _gumbel.log_weights(weights)}
    if method == "alias":
        t = _alias.build_alias_tables(weights)
        return {"prob": t.prob, "alias": t.alias}
    if method == "alias_device":
        from repro_torch.kernels.alias_build import build_alias_tables_device

        t = build_alias_tables_device(weights)
        return {"prob": t.prob, "alias": t.alias}
    if method == "radix_forest":
        cdf, root = _radix.build_radix_forest(weights)
        return {"cdf": cdf, "root": root}
    if method == "lda_kernel":
        raise ValueError(
            "the factored 'lda_kernel' variant builds from (theta, phi, "
            "doc_ids, words) — use Categorical.from_factors"
        )
    raise ValueError(f"unknown Categorical variant {method!r}; options: {VARIANTS}")


def _build_state_factored(theta, phi, doc_ids, words, W: int) -> Dict[str, Any]:
    """The ``lda_kernel`` state: factored pass A (K6 on CUDA) straight
    from the factors — no (B, K) weight tensor."""
    from repro_torch.kernels.lda_draw import ops as _lops

    theta, phi, running = _lops.lda_build_running(theta, phi, doc_ids, words, W=W)
    return {"theta": theta, "phi": phi, "doc_ids": doc_ids, "words": words,
            "running": running}


def kernel_state_from_numpy(wp, running, device=None) -> Dict[str, torch.Tensor]:
    """The port's ``kernel`` state from the reference's ``(weights,
    running)`` leaves as numpy arrays.  Padded rows and columns are kept:
    the draws read only the rows they are given, and padded columns are
    zero, so they are never drawn."""
    dev = runtime.resolve_device(device)
    return {"weights": torch.as_tensor(np.array(wp, np.float32), device=dev),
            "running": torch.as_tensor(np.array(running, np.float32), device=dev)}


def kernel_state_to_numpy(state: Dict[str, torch.Tensor], W: int
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """(weights, running) as numpy, the weights' columns padded with zeros
    to nb * W (the reference's pass B reads whole W-blocks)."""
    w = state["weights"].float().cpu()
    running = state["running"].cpu()
    pad = running.shape[1] * W - w.shape[1]
    return torch.nn.functional.pad(w, (0, pad)).numpy(), running.numpy()


# ---------------------------------------------------------------------------
# The distribution object
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Categorical:
    """A batch of categorical distributions with precomputed draw state.
    Construct with :meth:`from_weights`, :meth:`from_logits` or
    :meth:`from_factors`; rebuild for new weights with :meth:`refreshed`."""

    method: str
    W: int
    shape: Tuple[int, int]          # unpadded (B, K)
    state: Dict[str, Any]
    tb: int = 0

    @classmethod
    def from_weights(cls, weights, method: str = "auto", W: Optional[int] = None,
                     draws: int = 1, device=None) -> "Categorical":
        """Build from (B, K) non-negative weights.  ``W=None`` picks
        ``runtime.default_w(K)``; ``method="auto"`` is not ported yet."""
        weights = as_tensor(weights, device)
        if weights.dim() != 2:
            raise ValueError(f"weights must be (B, K), got shape {tuple(weights.shape)}")
        from repro_torch.sampling.plan import plan

        p = plan(tuple(weights.shape), method=method, W=W, dtype=weights.dtype,
                 draws=draws, has_key=method in KEY_VARIANTS or method == "auto")
        return cls._build(weights, p.table_method, p.W)

    @classmethod
    def from_logits(cls, logits, temperature=1.0, method: str = "auto",
                    W: Optional[int] = None, draws: int = 1, transforms=None,
                    device=None) -> "Categorical":
        """Build from (B, V) logits via a temperature-scaled stable softmax
        in the logits' own floating dtype; a ``transforms`` truncation chain
        zeroes the truncated tokens' weights before the build."""
        logits = as_tensor(logits, device)
        if transforms:
            from repro_torch.sampling import transforms as _tr

            weights = _tr.apply_to_logits(transforms, logits, temperature)
        else:
            weights = logits_to_weights(logits, temperature)
        return cls.from_weights(weights, method=method, W=W, draws=draws)

    @classmethod
    def from_factors(cls, theta, phi, words, doc_ids=None, method: str = "lda_kernel",
                     W: Optional[int] = None, tb: Optional[int] = None) -> "Categorical":
        """A factored distribution: sample s draws from
        ``theta[doc_ids[s]] * phi[words[s]]``; the ``lda_kernel`` state is
        built straight from the factors.  Another method forms the (B, K)
        product once and builds its flat table."""
        theta = torch.as_tensor(theta)
        phi = torch.as_tensor(phi, device=theta.device)
        words = torch.as_tensor(words, device=theta.device).to(torch.int32)
        B, K = int(words.shape[0]), int(theta.shape[1])
        if doc_ids is None:
            if theta.shape[0] != B:
                raise ValueError(
                    f"doc_ids=None needs one theta row per sample; got "
                    f"theta {tuple(theta.shape)} for {B} samples"
                )
            doc_ids = torch.arange(B, dtype=torch.int32, device=theta.device)
        doc_ids = torch.as_tensor(doc_ids, device=theta.device).to(torch.int32)
        from repro_torch.sampling.plan import plan

        p = plan((B, K), method=method, W=W, dtype=theta.dtype, has_key=False,
                 factored=True)
        if p.method not in FACTORED_VARIANTS:
            flat = theta[doc_ids.long()] * phi[words.long()]
            return cls._build(flat, p.table_method, p.W, tb or p.tb)
        return cls._build_factored(theta, phi, doc_ids, words, p.method, p.W, tb or p.tb)

    @classmethod
    def _build(cls, weights, method: str, W: int, tb: int = 0) -> "Categorical":
        _note_build()
        return cls(method=method, W=int(W),
                   shape=(int(weights.shape[0]), int(weights.shape[1])),
                   state=_build_state(method, weights, int(W)), tb=int(tb))

    @classmethod
    def _build_factored(cls, theta, phi, doc_ids, words, method: str, W: int,
                        tb: int = 0) -> "Categorical":
        _note_build()
        return cls(method=method, W=int(W),
                   shape=(int(words.shape[0]), int(theta.shape[1])),
                   state=_build_state_factored(theta, phi, doc_ids, words, int(W)),
                   tb=int(tb))

    def refreshed(self, weights) -> "Categorical":
        """Rebuild the tables from new same-shape weights: same variant,
        same W, fresh state."""
        if self.method in FACTORED_VARIANTS:
            raise ValueError(
                f"{self.method!r} is a factored variant; refresh it with "
                "refresh_from_factors(theta, phi) instead of flat weights"
            )
        weights = torch.as_tensor(weights)
        if tuple(weights.shape) != self.shape:
            raise ValueError(
                f"refreshed() weights shape {tuple(weights.shape)} != {self.shape}; "
                "build a new Categorical for a different shape"
            )
        return Categorical._build(weights, self.method, self.W, self.tb)

    def refresh_from_factors(self, theta, phi, words=None) -> "Categorical":
        """Rebuild a factored distribution's table from new factors (same
        variant, W and word positions unless ``words`` is given)."""
        if self.method not in FACTORED_VARIANTS:
            raise ValueError(
                f"{self.method!r} carries flat-weight state; use "
                "refreshed(new_weights)"
            )
        theta = torch.as_tensor(theta)
        words = self.state["words"] if words is None else \
            torch.as_tensor(words, device=theta.device).to(torch.int32)
        if int(theta.shape[1]) != self.shape[1]:
            raise ValueError(f"refresh_from_factors() K={theta.shape[1]} != {self.shape[1]}")
        if int(words.shape[0]) != self.shape[0]:
            raise ValueError(
                f"refresh_from_factors() got {words.shape[0]} samples, "
                f"expected {self.shape[0]}"
            )
        return Categorical._build_factored(theta, phi, self.state["doc_ids"], words,
                                           self.method, self.W, self.tb)

    @property
    def batch_size(self) -> int:
        return self.shape[0]

    @property
    def num_categories(self) -> int:
        return self.shape[1]

    @property
    def needs_key(self) -> bool:
        return self.method in KEY_VARIANTS

    @property
    def device(self) -> torch.device:
        return next(iter(self.state.values())).device

    def draw(self, generator: Optional[torch.Generator] = None, u=None,
             num_samples: int = 1) -> torch.Tensor:
        """Draw indices; see :func:`draw`."""
        return draw(self, generator=generator, u=u, num_samples=num_samples)


# ---------------------------------------------------------------------------
# Logits -> weights (dtype-preserving stable softmax)
# ---------------------------------------------------------------------------


def logits_to_weights(logits, temperature=1.0) -> torch.Tensor:
    """Temperature-scaled unnormalized probabilities from (B, V) logits:
    max-subtracted and dtype-preserving (bfloat16 in, bfloat16 out;
    non-float inputs go to float32).  ``temperature`` is a scalar or a
    per-row (B,) tensor."""
    logits = torch.as_tensor(logits)
    if not logits.is_floating_point():
        logits = logits.to(torch.float32)
    t = torch.as_tensor(temperature, device=logits.device)
    z = logits / (t[:, None] if t.dim() == 1 else t)
    z = z - z.max(dim=-1, keepdim=True).values
    return torch.exp(z)


# ---------------------------------------------------------------------------
# Draws
# ---------------------------------------------------------------------------


def _draw_with_u(method: str, state: Dict[str, Any], u: torch.Tensor, shape,
                 W: int) -> torch.Tensor:
    """One draw per row from (B,) uniforms; ``shape`` is the unpadded
    (B, K).  ``kernel`` and ``lda_kernel`` also take (S, B) uniforms for S
    draws in one launch."""
    B, K = shape
    if method == "prefix":
        p = state["prefix"]
        stop = p[:, -1] * u.to(p.dtype)
        idx = torch.searchsorted(p, stop[:, None].contiguous(), right=True)[:, 0]
        return idx.clamp(max=K - 1).to(torch.int32)
    if method == "fenwick":
        return _bfly.draw_fenwick_from_table(state["table"], u, W=W, K=K)
    if method == "butterfly":
        return _bfly.draw_butterfly_from_table(state["table"], u, W=W, B=B, K=K)
    if method == "two_level":
        return _bfly.draw_two_level_from_state(state["blocks"], state["running"], u, W, K)
    if method == "kernel":
        return _kops.butterfly_sample_from_sums(state["weights"], state["running"], u,
                                                K=K, W=W)
    if method == "lda_kernel":
        from repro_torch.kernels.lda_draw import ops as _lops

        return _lops.lda_draw_from_running(
            state["theta"], state["phi"], state["running"], u,
            state["doc_ids"], state["words"], K=K, W=W,
        )
    if method == "radix_forest":
        return _radix.draw_radix_forest(state["cdf"], state["root"], u)
    raise ValueError(f"variant {method!r} draws from a generator, not uniforms — "
                     "pass generator=")


def _draw_u(dist: Categorical, u: torch.Tensor) -> torch.Tensor:
    return _draw_with_u(dist.method, dist.state, u, dist.shape, dist.W)


def _draw_with_generator(dist: Categorical, g: Optional[torch.Generator]) -> torch.Tensor:
    """One draw per row from ``g``."""
    if dist.method == "gumbel":
        logw = dist.state["logw"]
        noise = _gumbel.gumbel_noise(logw.shape, g, logw.device, logw.dtype)
        return torch.argmax(logw + noise, dim=-1).to(torch.int32)
    if dist.method in ("alias", "alias_device"):
        t = _alias.AliasTable(prob=dist.state["prob"], alias=dist.state["alias"])
        return _alias.draw_alias_batch(t, g)
    return _draw_u(dist, _uniforms((dist.shape[0],), g, dist.device))


def draw(dist: Categorical, generator: Optional[torch.Generator] = None, u=None,
         num_samples: int = 1) -> torch.Tensor:
    """Draw category indices from a built :class:`Categorical`.

    * ``u=`` ((B,) or (num_samples, B)): the u-driven variants draw from
      these uniforms.
    * ``generator=``: uniforms (or Gumbel noise, alias columns and coins)
      come from it; ``num_samples > 1`` returns (num_samples, B).
    """
    if u is not None:
        u = torch.as_tensor(u, device=dist.device).to(torch.float32)
        if u.dim() == 2:
            if dist.method in _MULTI_U:
                return _draw_u(dist, u)
            return torch.stack([_draw_u(dist, uu) for uu in u])
        if num_samples != 1:
            raise ValueError("num_samples > 1 needs u of shape (S, B) or a generator")
        return _draw_u(dist, u)
    if num_samples == 1:
        return _draw_with_generator(dist, generator)
    if dist.method in KEY_VARIANTS:
        return torch.stack([_draw_with_generator(dist, generator)
                            for _ in range(num_samples)])
    us = _uniforms((num_samples, dist.shape[0]), generator, dist.device)
    if dist.method in _MULTI_U:
        return _draw_u(dist, us)
    return torch.stack([_draw_u(dist, uu) for uu in us])
