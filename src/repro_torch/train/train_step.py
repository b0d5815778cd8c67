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

from repro_torch.dist.sharding import shard_offset
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
    DTensor logits give their log-sum-exp and gold logits on each rank's
    own block (:func:`_lse_gold_per_shard`)."""
    if hasattr(logits, "full_tensor"):
        lse, gold, mask = _lse_gold_per_shard(logits, labels, mask)
    else:
        logits = logits.to(torch.float32)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    ce = (lse - gold) * mask
    zl = z_loss * (lse ** 2) * mask
    denom = torch.clamp_min(mask.sum(), 1.0)
    return (ce.sum() + zl.sum()) / denom, ce.sum() / denom


# float32 elements of one chunk of logits rows in the vocab-parallel loss
_CHUNK = 1 << 26


def _lse_gold_per_shard(logits, labels, mask):
    """Log-sum-exp and gold logit of DTensor logits (..., V) placed as the
    unembedding places them (``layers.logits_sharding``: rows, positions
    or columns split over the mesh), in Megatron's vocab-parallel form:
    each rank reduces its own columns (:class:`_VocabParallelLseGold`) and
    the partial results are all-reduced over the mesh dims that split the
    vocabulary.  Nothing gathers the logits.  ``labels`` and ``mask``
    (global, the logits' shape less V; tensors or DTensors) are narrowed
    to the rank's rows and positions.  The three come back as DTensors
    placed as the logits' leading dims."""
    from torch.distributed.tensor import DTensor, Replicate

    mesh = logits.device_mesh
    last = logits.dim() - 1
    if any(p.is_partial() for p in logits.placements):
        logits = logits.redistribute(mesh, [Replicate() if p.is_partial() else p
                                            for p in logits.placements])
    vocab_dims = [m for m, p in enumerate(logits.placements) if p.is_shard(last)]
    rows = [Replicate() if p.is_shard(last) else p for p in logits.placements]
    v0, _ = shard_offset(logits.shape[-1], last, mesh, logits.placements)

    def local(t):
        if not hasattr(t, "full_tensor"):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
        return t.redistribute(mesh, rows).to_local()

    lse, gold = _VocabParallelLseGold.apply(logits.to_local(), local(labels),
                                            v0, mesh, vocab_dims)
    shape = tuple(labels.shape)
    stride = torch.empty(shape, device="meta").stride()
    return tuple(DTensor.from_local(t, mesh, rows, run_check=False, shape=torch.Size(shape),
                                    stride=stride) for t in (lse, gold, local(mask)))


def _all_reduce(t: torch.Tensor, op: str, mesh, dims) -> torch.Tensor:
    """``t`` reduced by ``op`` over each mesh dim of ``dims``."""
    import torch.distributed._functional_collectives as funcol

    for m in dims:
        t = funcol.wait_tensor(funcol.all_reduce(t, op, (mesh, m)))
    return t


class _VocabParallelLseGold(torch.autograd.Function):
    """Log-sum-exp and gold logit over a vocabulary whose columns are
    split over the mesh dims ``dims``: the local max, all-reduced (max);
    the sum of exponentials in float32 over chunks of rows, all-reduced
    (sum); the gold logit by a gather masked to this rank's columns (from
    ``v0``), all-reduced (sum).  The backward pass recomputes the softmax
    chunk by chunk from the saved local logits (in their own dtype):
    ``d_lse * softmax + d_gold * onehot``, so a z-loss on the log-sum-exp
    adds its ``2 z lse softmax`` through ``d_lse``; it needs no
    collective.  No rank holds float32 logits beyond one chunk."""

    @staticmethod
    def forward(ctx, logits, labels, v0: int, mesh, dims):
        V = logits.shape[-1]
        flat = logits.reshape(-1, V)
        step = max(1, _CHUNK // max(V, 1))
        m = _all_reduce(torch.amax(flat, dim=-1).to(torch.float32), "max", mesh, dims)
        m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        s = torch.empty_like(m)
        for i in range(0, flat.shape[0], step):
            s[i:i + step] = torch.exp(flat[i:i + step].to(torch.float32)
                                      - m[i:i + step, None]).sum(-1)
        lse = m + torch.log(_all_reduce(s, "sum", mesh, dims))
        col = labels.reshape(-1).long() - v0
        own = (col >= 0) & (col < V)
        col = torch.where(own, col, torch.zeros_like(col))
        gold = torch.gather(flat, 1, col[:, None])[:, 0].to(torch.float32)
        gold = _all_reduce(torch.where(own, gold, torch.zeros_like(gold)), "sum", mesh, dims)
        ctx.save_for_backward(logits, lse, col, own)
        ctx.step = step
        shape = logits.shape[:-1]
        return lse.reshape(shape), gold.reshape(shape)

    @staticmethod
    def backward(ctx, d_lse, d_gold):
        logits, lse, col, own = ctx.saved_tensors
        V = logits.shape[-1]
        flat = logits.reshape(-1, V)
        d_lse = d_lse.reshape(-1).to(torch.float32)
        d_gold = torch.where(own, d_gold.reshape(-1).to(torch.float32),
                             torch.zeros_like(lse))
        grad = torch.empty_like(flat)
        for i in range(0, flat.shape[0], ctx.step):
            j = slice(i, i + ctx.step)
            g = torch.exp(flat[j].to(torch.float32) - lse[j, None]) * d_lse[j, None]
            g.scatter_add_(1, col[j, None], d_gold[j, None])
            grad[j] = g.to(grad.dtype)
        return grad.reshape(logits.shape), None, None, None, None


def _batch_labels(batch: Dict):
    """Next-token labels + mask from the batch (decoder-only or encdec)."""
    toks = batch["tgt_tokens"] if "tgt_tokens" in batch else batch["tokens"]
    labels = toks[:, 1:]
    mask = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
    return labels, mask


def _loss(logits, batch, z_loss: float):
    """(loss, ce, tokens) of the next-token labels.  DTensor logits keep
    every position, the last one masked (its label wraps to the first
    token), where the plain path slices it off: the unembedding may split
    the positions over ``model``, and a slice of one position off them
    would be uneven."""
    labels, mask = _batch_labels(batch)
    if not hasattr(logits, "full_tensor"):
        return (*cross_entropy(logits[:, :-1], labels, mask, z_loss), mask.sum())
    toks = batch["tgt_tokens"] if "tgt_tokens" in batch else batch["tokens"]
    shifted = torch.cat([toks[:, 1:], toks[:, :1]], dim=1)
    full = torch.ones(tuple(shifted.shape), dtype=torch.float32, device=shifted.device)
    full[:, -1] = 0.0
    return (*cross_entropy(logits, shifted, full, z_loss), mask.sum())


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
            loss, ce, tokens = _loss(logits, batch, z_loss)
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
                                               tokens=tokens)

    return train_step


def make_eval_step(model: Model, remat: str = "none") -> Callable:
    def eval_step(params, batch):
        with torch.no_grad():
            logits, _ = model.apply(params, batch, remat=remat)
            _, ce, _ = _loss(logits, batch, z_loss=0.0)
        return ce

    return eval_step
