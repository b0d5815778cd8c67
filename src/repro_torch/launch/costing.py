"""Per-layer cost accounting for the dry-run, the counterpart of
``repro.launch.costing``.

The reference compiles one isolated layer body per stack because XLA's
``cost_analysis`` counts a scan body once, and reports ``scanned + (L - 1)
x body``.  The port has no scan: its stacks are Python loops over the
layers (``models.transformer.stack_apply``, ``models.encdec``), so the
dry-run's trace already counts every layer, and :func:`corrected_totals`
keeps the reference's keys but equals the traced totals (ROADMAP.md,
deliberate differences).

:func:`body_cost` stays as the cost of one layer of a stack at the cell's
geometry and placement, for a roofline: the trace's total is L x body
plus the work outside the layers (embedding, head, loss, optimizer, the
draw).  It traces the model's own layer functions (``layer_apply``,
``_enc_layer``, ``_dec_layer``); a train body is the gradients of a loss
through the layer under ``remat_layer`` (its forward, the recomputation
the backward needs, its backward), as each layer of the train step
runs.  Attention is forced dense (the
reference's ``1 << 30`` threshold), which changes no count here: the
chunked loop's matmuls are the dense ones, cut into pieces.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.params import ParamSpec, tree_leaves, tree_map


def stacks(cfg: ModelConfig, kind: str) -> List[str]:
    """The layer stacks a step of ``kind`` runs (the reference's)."""
    if cfg.encoder_layers > 0:
        return ["encdec_decoder"] if kind == "decode" else ["encoder", "encdec_decoder"]
    return ["decoder"]


def body_cost(cfg: ModelConfig, shape: ShapeConfig, mesh, rules, kind: str,
              stack: str = "decoder", device="cpu") -> Dict:
    """Trace one layer of ``stack`` at the cell's geometry on ``mesh``
    (None: one device); returns ``flops``, ``bytes_accessed`` and
    ``collectives`` per device, as the dry-run counts a step."""
    from repro_torch.models import attention as attn_mod

    old = attn_mod.CHUNKED_THRESHOLD
    attn_mod.CHUNKED_THRESHOLD = 1 << 30
    try:
        return _body_cost(cfg, shape, mesh, rules, kind, stack, torch.device(device))
    finally:
        attn_mod.CHUNKED_THRESHOLD = old


def _layer(spec: ParamSpec) -> ParamSpec:
    """One layer's slice of a stacked (L, ...) spec."""
    return ParamSpec(spec.shape[1:], spec.axes[1:], spec.init, spec.scale)


def _body_cost(cfg, shape, mesh, rules, kind, stack, dev) -> Dict:
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.dryrun import StepTally, _abstract_tree, _place, collective_bytes
    from repro_torch.models import encdec as ed
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import remat_layer

    B = shape.global_batch
    if cfg.encoder_layers > 0:
        S_text = shape.seq_len // 2
    elif cfg.frontend_len > 0:
        S_text = shape.seq_len - cfg.frontend_len
    else:
        S_text = shape.seq_len
    S_full = S_text + cfg.meta_tokens + cfg.frontend_len
    if cfg.encoder_layers > 0 and stack == "encoder":
        S_full = shape.seq_len - S_text
    if stack == "encoder":
        lspec = ed._enc_layer_spec(cfg)
    elif stack == "encdec_decoder":
        lspec = ed._dec_layer_spec(cfg)
    else:
        lspec = tf.layer_spec(cfg)
    bf16, D = torch.bfloat16, cfg.d_model
    tally = StepTally()
    with FakeTensorMode(allow_non_fake_inputs=True):
        lp = _abstract_tree(lspec, bf16, mesh, rules, dev)
        if kind == "decode":
            cache_len = shape.seq_len + cfg.meta_tokens + cfg.frontend_len
            if stack == "encdec_decoder":
                tgt = cache_len // 2   # the model's own split (models.model)
                lc = tree_map(_layer, ed.encdec_cache_specs(cfg, B, tgt, cache_len - tgt))
            else:
                lc = tf.layer_cache_spec(cfg, B, cache_len)
            cache = _abstract_tree(lc, bf16, mesh, rules, dev)
            x = _place(torch.empty((B, 1, D), dtype=bf16, device=dev), ("batch", None, None),
                       mesh, rules)
            positions = torch.arange(1, device=dev) + 7

            def run():
                if stack == "encdec_decoder":
                    return ed._dec_layer(cfg, lp, x, positions, None, cache, 7)
                return tf.layer_apply(cfg, lp, x, positions, 0, cache=cache, cache_pos=7)[:2]
        else:
            x = _place(torch.empty((B, S_full, D), dtype=bf16, device=dev),
                       ("batch", "seq", None), mesh, rules)
            positions = torch.arange(S_full, device=dev)
            # the decoder cross-attends a same-length memory stand-in, as
            # the reference's body does
            memory = _place(torch.empty((B, S_full, D), dtype=bf16, device=dev),
                            ("batch", "seq", None), mesh, rules)

            def body(p, h, m):
                if stack == "encoder":
                    return ed._enc_layer(cfg, p, h, positions)
                if stack == "encdec_decoder":
                    return ed._dec_layer(cfg, p, h, positions, m, None, None)[0]
                return tf.layer_apply(cfg, p, h, positions, 0)[0]

            if kind == "train":
                def run():
                    leaves = tree_map(lambda t: t.detach().requires_grad_(True), lp)
                    h, m = (t.detach().requires_grad_(True) for t in (x, memory))
                    wrt = tree_leaves(leaves) + [h] + [m] * (stack == "encdec_decoder")
                    with torch.enable_grad():
                        y = remat_layer(body, "full")(leaves, h, m)
                        total = torch.sum(y.to(torch.float32) ** 2)
                        return torch.autograd.grad(total, wrt, allow_unused=True)
            else:
                def run():
                    return body(lp, x, memory)

        repl = implicit_replication() if mesh is not None else contextlib.nullcontext()
        with repl, tally.counting():
            run()
    return {"flops": float(tally.flops), "bytes_accessed": float(tally.bytes),
            "collectives": collective_bytes(tally.collectives)}


def corrected_totals(traced: Dict, cfg: ModelConfig, bodies: Dict[str, Dict]) -> Dict:
    """The reference's keys, equal to the traced totals: the port's trace
    counts every layer (no scan body is counted once).  ``cfg`` and
    ``bodies`` are taken for the reference's signature."""
    return {
        "flops_total": traced.get("cost", {}).get("flops", 0.0),
        "bytes_total": traced.get("cost", {}).get("bytes_accessed", 0.0),
        "collective_bytes_total": traced.get("collectives", {}).get("total_bytes", 0.0),
    }
