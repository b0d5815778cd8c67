"""Deterministic, sharded, checkpointable synthetic data pipeline, the
counterpart of ``repro.data.pipeline``.

Every batch is a pure function of (seed, step, shard), so a restarted run,
possibly on a different number of hosts, reproduces the exact token
stream from the checkpointed cursor.  The generator is a Zipf-ish LM
surrogate, so losses are non-degenerate.  Batches are numpy arrays made
by numpy alone, bit-equal to the reference's; the caller moves them to
its device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclasses.dataclass
class PipelineState:
    seed: int
    step: int  # the cursor, stored in checkpoints


class TokenPipeline:
    """Yields batch dicts matching the model family's input contract."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, seed: int = 0,
                 num_shards: int = 1, shard: int = 0):
        self.cfg, self.shape = cfg, shape
        self.state = PipelineState(seed=seed, step=0)
        self.num_shards, self.shard = num_shards, shard
        if shape.global_batch % num_shards:
            raise ValueError(f"global batch {shape.global_batch} does not divide over "
                             f"{num_shards} shards")
        self.local_batch = shape.global_batch // num_shards

    # -- deterministic token synthesis ------------------------------------
    def _tokens(self, step: int, batch: int, seq: int) -> np.ndarray:
        rng = np.random.default_rng(
            (self.state.seed * 1_000_003 + step) * 65_537 + self.shard
        )
        # Zipf-distributed ids with locally repeated spans (compressible
        # structure so CE can actually go below uniform)
        v = self.cfg.vocab_size
        base = rng.zipf(1.3, size=(batch, seq)).astype(np.int64) % v
        rep = rng.integers(0, seq - 8, size=(batch,))
        for b in range(batch):
            r = rep[b]
            base[b, r + 4: r + 8] = base[b, r: r + 4]
        return base.astype(np.int32)

    def _frontend(self, step: int, batch: int, n: int) -> np.ndarray:
        rng = np.random.default_rng(self.state.seed * 7 + step + 13 * self.shard)
        return rng.normal(size=(batch, n, self.cfg.d_model)).astype(np.float32) * 0.02

    def next_batch(self) -> Dict[str, np.ndarray]:
        step = self.state.step
        self.state.step += 1
        B, S = self.local_batch, self.shape.seq_len
        cfg = self.cfg
        if cfg.encoder_layers > 0:
            se = S // 2
            return {
                "src_embeds": self._frontend(step, B, se),
                "tgt_tokens": self._tokens(step, B, S - se),
            }
        if cfg.frontend_len > 0:
            return {
                "tokens": self._tokens(step, B, S - cfg.frontend_len),
                "frontend_embeds": self._frontend(step, B, cfg.frontend_len),
            }
        return {"tokens": self._tokens(step, B, S)}

    # -- checkpoint integration -------------------------------------------
    def cursor(self) -> Dict:
        return {"seed": self.state.seed, "step": self.state.step}

    def restore(self, cursor: Dict) -> None:
        self.state = PipelineState(seed=int(cursor["seed"]), step=int(cursor["step"]))
