"""Shared neural layers: norms, RoPE, MLPs, embeddings, the counterpart of
``repro.models.layers``.

All layers are pure functions over ParamSpec-declared params; norms and
softmax accumulate in float32.  Operands of mixed dtypes are promoted as
JAX promotes them (bfloat16 with float32 gives float32): :func:`einsum`
casts both sides first, where ``torch.einsum`` would refuse.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.dist.sharding import (NamedSharding, PartitionSpec, activation_layout,
                                      from_local_block, gather_dim, local_block, mesh_of,
                                      model_dim, named_sharding, shard_offset)
from repro_torch.models.params import ParamSpec


def einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` with JAX's promotion of mixed operand dtypes.  Two
    DTensor operands contract through :func:`_matmul_einsum`."""
    dt = ops[0].dtype
    for o in ops[1:]:
        dt = torch.promote_types(dt, o.dtype)
    ops = tuple(o if o.dtype == dt else o.to(dt) for o in ops)
    if len(ops) == 2 and any(hasattr(o, "full_tensor") for o in ops):
        return _matmul_einsum(eq, *ops)
    return torch.einsum(eq, *ops)


def _matmul_einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A two-operand einsum as permutes, reshapes and one (batched)
    matmul, each group of dims (batch, ``a``'s free, contracted, ``b``'s
    free) flattened in the order it has in ``a`` (``b``'s free dims in
    ``b``'s order).  For DTensor operands: ``torch.einsum`` orders a group
    its own way, and a flattened group whose sharded dim is not its first
    is what the card's PyTorch cannot propagate (ROADMAP.md, deliberate
    differences); the operands' layouts put a sharded dim first."""
    ins, out = eq.replace(" ", "").split("->")
    sa, sb = ins.split(",")
    if "..." in eq:   # the leading dims that "..." stands for, as letters
        spare = [c for c in "ABCDEFGHIJKLMNOPQRSTUVWXYZ" if c not in eq]
        n = (a.dim() - len(sa) + 3) if "..." in sa else (b.dim() - len(sb) + 3)
        dots = "".join(spare[:n])
        sa, sb, out = (x.replace("...", dots) for x in (sa, sb, out))
    size = {**dict(zip(sa, a.shape)), **dict(zip(sb, b.shape))}
    batch = [c for c in sa if c in sb and c in out]
    contract = [c for c in sa if c in sb and c not in out]
    free_a = [c for c in sa if c not in sb]
    free_b = [c for c in sb if c not in sa]

    def n(cs):
        r = 1
        for c in cs:
            r *= int(size[c])
        return r

    A = reshape(a.permute([sa.index(c) for c in batch + free_a + contract]),
                (n(batch), n(free_a), n(contract)))
    B = reshape(b.permute([sb.index(c) for c in batch + contract + free_b]),
                (n(batch), n(contract), n(free_b)))
    y = torch.bmm(A, B)
    order = batch + free_a + free_b
    y = reshape(y, tuple(int(size[c]) for c in order))
    return y.permute([order.index(c) for c in out])


def _view_groups(src, dst):
    """The consecutive dims of shapes ``src`` and ``dst`` that a reshape
    maps onto each other: [(src dims, dst dims)], products equal."""
    groups, i, j = [], 0, 0
    while i < len(src) or j < len(dst):
        si, dj = [i] if i < len(src) else [], [j] if j < len(dst) else []
        ps = src[i] if si else 1
        pd = dst[j] if dj else 1
        i, j = i + bool(si), j + bool(dj)
        while ps != pd:
            if ps < pd:
                si.append(i)
                ps *= src[i]
                i += 1
            else:
                dj.append(j)
                pd *= dst[j]
                j += 1
        groups.append((si, dj))
    return groups


def _reshapeable(x, shape):
    """A DTensor ``x`` with the dims gathered that keep a reshape to
    ``shape`` from keeping its sharding: a sharded dim flattened behind
    another, or a sharded dim split into parts whose first does not divide
    over the mesh dims that shard it.  The card's PyTorch refuses both.
    Partial sums are reduced first where the reshape flattens or splits a
    group of dims whose first does not divide over the partial mesh dims:
    DTensor's view rule would scatter the sums along that dim and then
    refuse to flatten it unevenly (ROADMAP.md, F6)."""
    if not hasattr(x, "full_tensor"):
        return x
    mesh = x.device_mesh

    def ways(d):
        n = 1
        for m, p in enumerate(x.placements):
            if p.is_shard(d):
                n *= mesh.size(m)
        return n

    # size-1 dims take no part
    groups = [([d for d in src if x.shape[d] > 1], [e for e in dst if shape[e] > 1])
              for src, dst in _view_groups(tuple(x.shape), tuple(shape))]
    sums = math.prod(mesh.size(m) for m, p in enumerate(x.placements) if p.is_partial())
    if sums > 1 and any((len(src) > 1 or len(dst) > 1) and x.shape[src[0]] % (ways(src[0]) * sums)
                        for src, dst in groups if src):
        from torch.distributed.tensor import Replicate

        x = x.redistribute(mesh, [Replicate() if p.is_partial() else p for p in x.placements])
    for src, dst in groups:
        first = shape[dst[0]] if dst else 1
        for k, d in enumerate(src):
            n = ways(d)
            if n > 1 and (k > 0 or first % n):
                x = gather_dim(x, d)
    return x


def reshape(x: torch.Tensor, shape) -> torch.Tensor:
    """``x.reshape(shape)``; a DTensor through :class:`_Reshape`, which
    gathers a dim first where the card's PyTorch cannot keep it sharded."""
    if hasattr(x, "full_tensor"):
        return _Reshape.apply(x, tuple(shape))
    return x.reshape(shape)


class _Reshape(torch.autograd.Function):
    """``x.reshape(shape)``, a DTensor made reshapeable first, in the
    forward pass and (the gradient, back to ``x``'s shape) in the backward
    pass, where DTensor picks the gradient's placements itself."""

    @staticmethod
    def forward(ctx, x, shape):
        ctx.shape = tuple(x.shape)
        return _contiguous(_reshapeable(x, shape)).reshape(shape)

    @staticmethod
    def backward(ctx, g):
        return _contiguous(_reshapeable(g, ctx.shape)).reshape(ctx.shape), None


def _contiguous(x):
    """``x.contiguous()``, a DTensor's local tensor made contiguous too:
    DTensor's ``contiguous`` looks at the global strides only, so a
    gradient whose local shard is a transposed view (one local head, say)
    stays one, and the local view of the reshape that follows fails."""
    x = x.contiguous()
    if not hasattr(x, "full_tensor") or x.to_local().is_contiguous():
        return x
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(x.to_local().contiguous(), x.device_mesh, x.placements,
                              run_check=False, shape=x.shape, stride=x.stride())


def remat_layer(fn, remat: str):
    """``fn`` under ``torch.utils.checkpoint`` (recomputed in the backward
    pass) for ``remat`` "full" or "dots" while gradients are recorded,
    else ``fn``: the stacks' counterpart of the reference's
    ``jax.checkpoint`` around each layer."""
    if remat in ("full", "dots") and torch.is_grad_enabled():
        return partial(checkpoint, fn, use_reentrant=False)
    return fn


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm_spec(d: int) -> Dict[str, ParamSpec]:
    return {"scale": ParamSpec((d,), ("embed",), init="ones")}


def rmsnorm(params, x, eps: float = 1e-6):
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].to(torch.float32)).to(x.dtype)


def head_rmsnorm_spec(head_dim: int) -> Dict[str, ParamSpec]:
    """qk-norm (Qwen3): per-head RMSNorm over head_dim."""
    return {"scale": ParamSpec((head_dim,), ("head",), init="ones")}


head_rmsnorm = rmsnorm   # the same arithmetic over the last (head_dim) axis


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, D) or (B, S, D); positions: (S,) shared across batch,
    or (B, S) per-row (continuous batching: every slot decodes at its own
    sequence position)."""
    head_dim = x.shape[-1]
    freqs = rope_frequencies(head_dim, theta, x.device)              # (D/2,)
    angles = positions[..., None].to(torch.float32) * freqs          # (..., S, D/2)
    if x.dim() == 4:                                                 # add heads axis
        angles = angles[..., None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (gated)
# ---------------------------------------------------------------------------


def mlp_spec(d_model: int, d_ff: int) -> Dict[str, ParamSpec]:
    return {
        "w_gate": ParamSpec((d_model, d_ff), ("embed", "mlp")),
        "w_up": ParamSpec((d_model, d_ff), ("embed", "mlp")),
        "w_down": ParamSpec((d_ff, d_model), ("mlp", "embed")),
    }


def _gelu_tanh(x):
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(x, approximate="tanh")


def _act(name: str):
    return {"silu": F.silu, "gelu": _gelu_tanh}[name]


def mlp(params, x, act: str = "silu"):
    """The gated MLP.  On a mesh (a DTensor operand) whose ``model`` degree
    divides d_ff it runs per shard (:func:`_mlp_per_shard`), the dense MLP,
    arctic's dense residual and hymba's alike."""
    mesh = mesh_of(x, *params.values())
    if mesh is not None and x.dim() == 3:
        md = model_dim(mesh)
        if md is not None and params["w_gate"].shape[1] % mesh.size(md) == 0:
            return _mlp_per_shard(params, x, act, mesh, md)
    g = _act(act)(einsum("...d,df->...f", x, params["w_gate"]))
    u = einsum("...d,df->...f", x, params["w_up"])
    return einsum("...f,fd->...d", g * u, params["w_down"])


def _mlp_per_shard(params, x, act: str, mesh, md: int):
    """Megatron's MLP with sequence parallelism, on local tensors: each rank
    takes its rows with every position (``x`` gathered over ``model``; its
    gradient comes back as partial sums over ``model``), projects them
    onto its columns of ``w_gate`` and ``w_up`` (d_ff split over ``model``,
    the ``mlp`` rule) and back through its rows of ``w_down``, each weight
    gathered along ``embed`` only (FSDP).  The partial outputs are
    reduce-scattered to the positions over ``model``.  A weight's gradient
    comes back split over ``model`` as the weight is, and partial over the
    mesh dims that split the rows.  Where the positions do not divide
    ``model`` (a decode step) the weights stay (:func:`_mlp_stationary`)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    rows, out = activation_layout(x.shape, mesh)
    if not out[md].is_shard():
        return _mlp_stationary(params, x, act, mesh, md)
    part = [Partial() if m == md else p for m, p in enumerate(rows)]
    summed = [Partial() if p.is_shard() else Replicate() for p in rows]

    def weight(w, dim):
        pl = [Shard(dim) if m == md else Replicate() for m in range(mesh.ndim)]
        return local_block(w, mesh, pl, [Shard(dim) if m == md else q
                                         for m, q in enumerate(summed)])

    xl = local_block(x, mesh, rows, part)
    g = _act(act)(einsum("...d,df->...f", xl, weight(params["w_gate"], 1)))
    u = einsum("...d,df->...f", xl, weight(params["w_up"], 1))
    y = einsum("...f,fd->...d", g * u, weight(params["w_down"], 0))
    return from_local_block(y, mesh, part, x.shape).redistribute(mesh, out)


def _mlp_stationary(params, x, act: str, mesh, md: int):
    """The MLP of a step whose positions do not divide ``model`` (a decode
    step: one position a row), with the weights where the ``embed`` and
    ``mlp`` rules put them, as ``moe._stationary_ffn`` runs the experts:
    the rows move to this rank's columns of D (every row of the mesh dims
    that split D), each rank contracts its columns with its block of
    ``w_gate`` and ``w_up``, the gate and up products are all-reduced over
    those dims in float32, the down product (its block of ``w_down``) is
    reduced over ``model`` and its columns go back to the rows' layout.
    So a rank moves activations, not weights.  The weights' gradients
    come back split as the weights are (partial over a mesh dim that
    splits the rows and not D)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    B, S, D = x.shape
    F = params["w_gate"].shape[1]
    rows, out = activation_layout(x.shape, mesh)
    rule = named_sharding((D, F), ("embed", "mlp"), mesh).placements
    cols = [d != md and p.is_shard(0) for d, p in enumerate(rule)]   # the dims that split D

    def pl(at_model, at_cols):
        """Placements: ``at_model`` on ``model``, ``at_cols`` on the dims
        that split D, the rows' elsewhere."""
        return [at_model if d == md else at_cols if cols[d] else rows[d]
                for d in range(mesh.ndim)]

    def weight(w, f):
        """This rank's block of a weight whose d_ff dim is ``f``, in place."""
        at = [Shard(f) if d == md else Shard(1 - f) if cols[d] else Replicate()
              for d in range(mesh.ndim)]
        grad = [Partial() if rows[d].is_shard() and not cols[d] and d != md else p
                for d, p in enumerate(at)]
        return local_block(w, mesh, at, grad)

    def whole(t):
        """A float32 product of this rank's columns, summed over the dims
        that split D, in ``x``'s dtype."""
        t = from_local_block(t.to(torch.float32), mesh, pl(Shard(2), Partial()), (B, S, F))
        return local_block(t, mesh, pl(Shard(2), Replicate()),
                           pl(Shard(2), Partial())).to(x.dtype)

    xs = local_block(x, mesh, pl(Replicate(), Shard(2)), pl(Partial(), Shard(2)))
    g = _act(act)(whole(einsum("bsd,df->bsf", xs, weight(params["w_gate"], 1))))
    u = whole(einsum("bsd,df->bsf", xs, weight(params["w_up"], 1)))
    y = einsum("bsf,fd->bsd", g * u, weight(params["w_down"], 0))
    return from_local_block(y, mesh, pl(Partial(), Shard(2)), (B, S, D)).redistribute(mesh, out)


# ---------------------------------------------------------------------------
# Embeddings / unembedding
# ---------------------------------------------------------------------------


def embedding_spec(vocab: int, d_model: int) -> Dict[str, ParamSpec]:
    return {"table": ParamSpec((vocab, d_model), ("vocab", "embed"), scale=1.0)}


def embed(params, tokens, scale: bool = False):
    """Rows of the table.  A DTensor table is gathered whole first (FSDP
    gathers a parameter before its use): DTensor's lookup on a vocab shard
    gives a masked partial whose mask a later op with a cached sharding
    decision applies to a tensor of another shape, and the card's PyTorch
    has no lookup rule for a table whose embedding dim shards over the
    mesh axes that shard the tokens' rows (ROADMAP.md, deliberate
    differences)."""
    table = gather_dim(gather_dim(params["table"], 0), 1)
    if hasattr(table, "full_tensor") and hasattr(tokens, "full_tensor"):
        x = _lookup_per_shard(table, tokens)
    else:
        x = table[tokens.long()]
    if scale:
        # sqrt(float32(D)) cast to the table's dtype, then the multiply (a
        # host float holding that value exactly)
        s = torch.sqrt(torch.tensor(float(table.shape[-1]), dtype=torch.float32))
        x = x * float(s.to(x.dtype))
    return x


def _lookup_per_shard(table, tokens):
    """The rows of a replicated DTensor table for each rank's own tokens,
    looked up on the local tensors (the card's PyTorch has no lookup rule
    for tokens whose rows shard over two mesh dims, pod and data); the
    table's gradient is partial over the mesh dims that shard the
    tokens."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh = tokens.device_mesh
    grad = [Partial() if p.is_shard() else Replicate() for p in tokens.placements]
    local = table.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
        grad_placements=grad)
    x = local[tokens.to_local().long()]
    shape = tuple(tokens.shape) + (table.shape[-1],)
    return DTensor.from_local(x, mesh, tokens.placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def unembed_spec(vocab: int, d_model: int) -> Dict[str, ParamSpec]:
    return {"table": ParamSpec((d_model, vocab), ("embed", "vocab"))}


def unembed(params, x, tied_table=None, softcap: float = 0.0, vocab_size=None):
    """Project to vocab logits (kept in compute dtype).  ``tied_table``
    (V, D) overrides; the softcap is computed in float32 and cast back;
    columns from ``vocab_size`` on (a padded table's) are masked to -1e30,
    so loss and sampling see exactly the real vocabulary.  DTensor
    operands are projected on each rank's own block
    (:func:`_unembed_per_shard`)."""
    table = params["table"] if tied_table is None else tied_table
    if hasattr(x, "full_tensor") or hasattr(table, "full_tensor"):
        return _unembed_per_shard(x, table, tied_table is not None, softcap, vocab_size)
    if tied_table is not None:
        logits = einsum("...d,vd->...v", x, tied_table)
    else:
        logits = einsum("...d,dv->...v", x, params["table"])
    return _cap_and_mask(logits, softcap, vocab_size, 0)


def _cap_and_mask(logits, softcap: float, vocab_size, v0: int):
    """The final softcap, then the padded columns masked: ``logits``' last
    dim holds the vocabulary's columns from ``v0`` on."""
    if softcap > 0:
        logits = (torch.tanh(logits.to(torch.float32) / softcap) * softcap).to(logits.dtype)
    if vocab_size is not None and v0 + logits.shape[-1] > vocab_size:
        valid = torch.arange(v0, v0 + logits.shape[-1], device=logits.device) < vocab_size
        logits = torch.where(valid, logits, torch.tensor(-1e30, dtype=logits.dtype,
                                                         device=logits.device))
    return logits


def logits_sharding(shape, mesh):
    """The sharding of logits of ``shape`` (..., S, V) on ``mesh``: rows
    over the data axes, the vocabulary over ``model`` where it divides (the
    ``vocab`` rule), else the positions (the ``seq`` rule), else (a decode
    step's one position) the vocabulary unevenly, as ``torch.chunk``
    splits it (DTensor's uneven ``Shard``: ceil(V / N) columns a rank, fewer
    on the last), so no two ``model`` ranks compute the same logits."""
    axes = ("batch", "vocab") if len(shape) == 2 else \
        ("batch",) + (None,) * (len(shape) - 3) + ("seq", "vocab")
    sh = named_sharding(tuple(shape), axes, mesh)
    md = model_dim(mesh)
    if md is None or not sh.placements[md].is_replicate() or shape[-1] < mesh.size(md):
        return sh
    from torch.distributed.tensor import Shard

    pl = list(sh.placements)
    pl[md] = Shard(len(shape) - 1)
    return NamedSharding(mesh, PartitionSpec(*sh.spec[:-1], "model"), tuple(pl))


def _unembed_per_shard(x, table, tied: bool, softcap: float, vocab_size):
    """The unembedding of DTensor operands on local tensors: each rank
    projects its rows (and positions) of ``x`` onto its columns of the
    table, placed as :func:`logits_sharding`; the table is split into its
    columns first and gathered along ``embed`` only, so a rank moves its
    own columns (``dist.sharding.local_block``), ``x`` along ``model``
    where the vocabulary shards over it.  So a rank computes 1/N of the
    logits over N ranks (ceil(V / N) columns where N does not divide V) and
    holds no whole vocabulary.  The gradients come back partial where a
    rank saw part of the sum: ``x``'s over the vocabulary's mesh dims, the
    table's over the rows'.  The softcap and the padded columns' mask run
    on the local logits, at their global column offset."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = mesh_of(x, table)
    vdim = 0 if tied else 1
    shape = tuple(x.shape[:-1]) + (table.shape[vdim],)
    out = logits_sharding(shape, mesh).placements
    last = len(shape) - 1
    vocab = [p.is_shard(last) for p in out]
    x_pl = [Replicate() if v else p for p, v in zip(out, vocab)]
    x_grad = [Partial() if v else p for p, v in zip(out, vocab)]
    w_pl = [Shard(vdim) if v else Replicate() for v in vocab]
    w_grad = [w if v or p.is_replicate() else Partial() for w, p, v in zip(w_pl, out, vocab)]
    xl = local_block(x, mesh, x_pl, x_grad)
    wl = local_block(table, mesh, w_pl, w_grad)
    logits = einsum("...d,vd->...v" if tied else "...d,dv->...v", xl, wl)
    v0, _ = shard_offset(shape[-1], last, mesh, out)
    return from_local_block(_cap_and_mask(logits, softcap, vocab_size, v0), mesh, out, shape)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return torch.tanh(x / cap) * cap if cap > 0 else x
