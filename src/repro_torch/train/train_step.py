"""Train step, the counterpart of ``repro.train.train_step``: masked cross
entropy (+ z-loss + the MoE aux loss), global-norm gradient clipping and
an optimizer update.

Gradients come from ``torch.autograd``; parameters, gradients and the
optimizer state stay trees of tensors, as in the reference.  Mixed
precision as there: parameters and activations in the parameters' dtype,
losses and reductions in float32, the optimizer state per optimizer.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch.dist.sharding import gather_dim
from repro_torch.models.model import Model
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.train.optimizer import Optimizer


class TrainMetrics(NamedTuple):
    loss: torch.Tensor
    ce: torch.Tensor
    aux: torch.Tensor
    grad_norm: torch.Tensor
    tokens: torch.Tensor


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
                  z_loss: float = 1e-4) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked token CE with z-loss; logits any float dtype, math in float32.
    Vocab-sharded DTensor logits are gathered along the vocab first: the
    DTensor rule of ``torch.gather`` on a vocab shard gives a masked
    partial that its reduction then fails on."""
    logits = gather_dim(logits, -1).to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    ce = (lse - gold) * mask
    zl = z_loss * (lse ** 2) * mask
    denom = torch.clamp_min(mask.sum(), 1.0)
    return (ce.sum() + zl.sum()) / denom, ce.sum() / denom


def _batch_labels(batch: Dict):
    """Next-token labels + mask from the batch (decoder-only or encdec)."""
    toks = batch["tgt_tokens"] if "tgt_tokens" in batch else batch["tokens"]
    labels = toks[:, 1:]
    mask = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
    return labels, mask


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


def make_train_step(
    model: Model,
    optimizer: Optimizer,
    remat: str = "full",
    grad_clip: float = 1.0,
    moe_aux_weight: float = 0.01,
    z_loss: float = 1e-4,
) -> Callable:
    """Returns train_step(params, opt_state, batch, step) ->
    (params, opt_state, TrainMetrics).  ``batch`` holds tensors on the
    params' device; ``step`` is an int."""

    def train_step(params, opt_state, batch, step):
        leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
        with torch.enable_grad():
            logits, aux = model.apply(leaves, batch, remat=remat)
            labels, mask = _batch_labels(batch)
            loss, ce = cross_entropy(logits[:, :-1], labels, mask, z_loss)
            total = loss + moe_aux_weight * aux
            flat = tree_leaves(leaves)
            got = torch.autograd.grad(total, flat, allow_unused=True)
        del logits
        it = iter(torch.zeros_like(p) if g is None else g for g, p in zip(got, flat))
        grads = tree_map(lambda _: next(it), leaves)
        del got, flat, leaves
        gnorm = global_norm(grads)
        scale = torch.clamp_max(gnorm.new_full((), grad_clip) / torch.clamp_min(gnorm, 1e-9),
                                1.0)
        grads = tree_map(lambda g: g.to(torch.float32) * scale, grads)
        params, opt_state = optimizer.update(grads, params, opt_state, int(step))
        aux = torch.as_tensor(aux, dtype=torch.float32, device=loss.device)
        return params, opt_state, TrainMetrics(loss=total.detach(), ce=ce.detach(),
                                               aux=aux.detach(), grad_norm=gnorm,
                                               tokens=mask.sum())

    return train_step


def make_eval_step(model: Model, remat: str = "none") -> Callable:
    def eval_step(params, batch):
        with torch.no_grad():
            logits, _ = model.apply(params, batch, remat=remat)
            labels, mask = _batch_labels(batch)
            _, ce = cross_entropy(logits[:, :-1], labels, mask, z_loss=0.0)
        return ce

    return eval_step
