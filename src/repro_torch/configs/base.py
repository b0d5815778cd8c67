"""Model / run configuration schema, the counterpart of
``repro.configs.base``.

One ``ModelConfig`` describes any of the 10 architectures (plus reduced
smoke variants); ``ShapeConfig`` describes the input-shape cells.  Configs
are data, not code: the families whose model code the port does not have
yet still resolve here.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class SamplerSpec:
    """Decode-time sampler preferences, resolved once per workload shape
    by ``repro_torch.sampling.plan``.

    ``method``: auto | two_level | fenwick | butterfly | kernel | prefix |
    gumbel | alias | alias_device | radix_forest (``auto``: the autotune
    tuner's pick).  ``W = 0`` means the tuned W under ``auto``, else
    ``runtime.default_w(K)``.  ``draws`` is the
    expected uses per distribution (1 for decode).  ``top_k`` / ``top_p``
    / ``min_p`` are the model's default truncation, disabled at
    0 / 1.0 / 0."""

    method: str = "auto"
    W: int = 0
    draws: int = 1
    top_k: int = 0
    top_p: float = 1.0
    min_p: float = 0.0

    @property
    def truncates(self) -> bool:
        return self.top_k > 0 or self.top_p < 1.0 or self.min_p > 0.0


@dataclasses.dataclass(frozen=True)
class ServeSpec:
    """Continuous-batching serve defaults (``repro_torch.serve.batching``).

    ``max_slots`` is the fixed decode batch width (one compiled step, all
    request churn expressed as per-slot data); ``max_waiting`` bounds the
    admission queue (submissions beyond it are rejected, not queued);
    ``max_len`` is the per-slot KV budget (prompt + generated tokens);
    ``prefill_chunk`` caps how many queued requests are prefilled between
    consecutive decode steps (prefill/decode interleaving — 0 = no cap).
    """

    max_slots: int = 8
    max_waiting: int = 64
    max_len: int = 256
    prefill_chunk: int = 2


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    expert_d_ff: int = 1024
    capacity_factor: float = 1.25
    # routing group size in tokens: capacity (and the dispatch one-hots)
    # are per-group, bounding dispatch memory at O(T * group * k * cf)
    # regardless of sequence length
    group_tokens: int = 4096
    # Arctic-style parallel dense residual MLP (0 disables)
    dense_residual_d_ff: int = 0
    router_z_loss: float = 1e-3


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 128          # N
    head_dim: int = 64            # P
    num_heads: int = 32           # d_inner / P
    conv_width: int = 4
    chunk: int = 128              # SSD chunk length
    expand: int = 2
    n_groups: int = 1


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None          # default d_model // num_heads
    attention: str = "gqa"                  # gqa | mla | none
    qk_norm: bool = False
    attn_softcap: float = 0.0               # gemma2: 50.0
    final_softcap: float = 0.0              # gemma2: 30.0
    sliding_window: int = 0                 # gemma2 local layers: 4096
    layer_pattern: str = "uniform"          # uniform | local_global (gemma2)
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    act: str = "silu"                       # silu | gelu
    tie_embeddings: bool = False
    embedding_scale: bool = False           # gemma2: x * sqrt(d_model)
    post_norms: bool = False                # gemma2 post-attn/post-ffn norms
    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # encoder-decoder
    encoder_layers: int = 0                 # >0 => encdec family
    # frontends (stub): how many leading positions come as embeddings
    frontend: str = "none"                  # none | audio | vision
    frontend_len: int = 0                   # positions supplied as embeddings
    # hymba: learned meta tokens prepended to every sequence
    meta_tokens: int = 0
    # hybrid/local attention: window for local layers (0 = all full attn)
    local_window: int = 0
    # MoE dispatch implementation (einsum = GShard baseline, gather = opt)
    moe_dispatch: str = "einsum"
    # pad embedding/unembedding tables to this multiple (0 = exact vocab);
    # Megatron-style: odd vocabs (e.g. seamless 256206) shard after padding,
    # padded logit columns are masked to -inf so loss/sampling are unchanged
    pad_vocab_multiple: int = 0

    @property
    def padded_vocab(self) -> int:
        if self.pad_vocab_multiple <= 0:
            return self.vocab_size
        m = self.pad_vocab_multiple
        return ((self.vocab_size + m - 1) // m) * m
    # paper technique: decode-time token sampler.  The structured form is
    # ``sampler`` (a SamplerSpec, resolved once per (B, V) workload by
    # repro_torch.sampling.plan); the loose sampler_method/sampler_W pair
    # remains as the legacy spelling and feeds sampler_spec when
    # ``sampler`` is unset.  Method options and W semantics: see
    # SamplerSpec.
    sampler: Optional[SamplerSpec] = None
    sampler_method: str = "auto"
    sampler_W: int = 0
    # continuous-batching serve defaults (slots / queue depth / KV budget);
    # None -> the ServeSpec defaults
    serve: Optional[ServeSpec] = None

    @property
    def sampler_spec(self) -> SamplerSpec:
        """The effective sampler spec: ``sampler`` if set, else the legacy
        ``sampler_method``/``sampler_W`` pair lifted into a SamplerSpec."""
        if self.sampler is not None:
            return self.sampler
        return SamplerSpec(method=self.sampler_method, W=self.sampler_W)

    @property
    def serve_spec(self) -> ServeSpec:
        """The effective continuous-batching defaults."""
        return self.serve if self.serve is not None else ServeSpec()

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}

# long_500k requires sub-quadratic sequence handling (spec: run only for
# SSM / hybrid families; full-attention archs skip it — DESIGN.md §4).
LONG_CONTEXT_FAMILIES = ("ssm", "hybrid")


def shapes_for(config: ModelConfig) -> Tuple[ShapeConfig, ...]:
    shapes = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if config.family in LONG_CONTEXT_FAMILIES:
        shapes.append(LONG_500K)
    return tuple(shapes)
