"""Request lifecycle for the continuous-batching serve engine, a copy of
``repro.serve.request`` on the port's ``SamplingParams``.

A :class:`Request` is everything the engine needs to serve one user
sequence: the prompt, a token budget, per-request :class:`SamplingParams`
(temperature / top-k / top-p / min-p — each request its own values), and
a seed.  The seed is lifted into a (2,) counter-RNG seed pair
(``repro_torch.kernels.rng``), so the uniform that draws this request's t-th
token is the pure function ``u = threefry(seed, t)`` — independent of
which slot the request lands in, what else shares the batch, and how
many devices the batch shards over.  That function IS the slot-recycling
isolation invariant: a request's tokens are bit-identical whether it ran
alone or churned through a recycled slot.

States move strictly forward::

    QUEUED -> PREFILLING -> DECODING -> FINISHED
         \\-> REJECTED            (admission control / validation)

and the timestamps recorded at each edge (arrival, prefill, first token,
finish) give time to first token and end-to-end latency.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional

import numpy as np

from repro_torch.serve.engine import SamplingParams

__all__ = ["Request", "RequestState", "FinishReason", "SamplingParams"]


class RequestState(enum.Enum):
    QUEUED = "queued"            # admitted, waiting for a slot
    PREFILLING = "prefilling"    # prompt prefix being prefilled
    DECODING = "decoding"        # bound to a slot, in the decode batch
    FINISHED = "finished"
    REJECTED = "rejected"        # queue full or validation failure


class FinishReason(enum.Enum):
    EOS = "eos"
    LENGTH = "length"            # max_new_tokens reached
    REJECTED = "rejected"


@dataclasses.dataclass
class Request:
    """One generation request moving through the engine.

    Mutable by design: the engine appends output tokens and stamps the
    lifecycle timestamps in place (there is exactly one owner).  Sampling
    parameters must be concrete scalars here — the engine packs them into
    the per-slot (B,) operand vectors of the one compiled decode step.
    """

    prompt: np.ndarray                      # (S,) int32 token ids
    max_new_tokens: int = 16
    sampling: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    seed: int = 0
    eos_id: Optional[int] = None            # None -> run to max_new_tokens

    # -- engine-owned lifecycle state --------------------------------------
    id: int = -1
    state: RequestState = RequestState.QUEUED
    finish_reason: Optional[FinishReason] = None
    output_tokens: List[int] = dataclasses.field(default_factory=list)
    slot: Optional[int] = None

    # timestamps (perf_counter seconds; -1.0 = not reached)
    arrival_time: float = -1.0
    prefill_time: float = -1.0
    first_token_time: float = -1.0
    finish_time: float = -1.0
    token_times: List[float] = dataclasses.field(default_factory=list)

    future: Optional[object] = None         # asyncio.Future when async-submitted

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size == 0:
            raise ValueError("empty prompt: a request needs >= 1 prompt token")
        if self.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {self.max_new_tokens}"
            )
        for name in ("temperature", "top_k", "top_p", "min_p"):
            v = getattr(self.sampling, name)
            if v is not None and not isinstance(v, (int, float)):
                raise ValueError(
                    f"continuous batching packs sampling params into (B,) "
                    f"slot vectors; {name} must be a concrete scalar, got "
                    f"{type(v).__name__}"
                )

    # -- derived -----------------------------------------------------------

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def total_budget(self) -> int:
        """KV positions this request needs: prompt + generated tokens."""
        return self.prompt_len + self.max_new_tokens

    @property
    def done(self) -> bool:
        return self.state in (RequestState.FINISHED, RequestState.REJECTED)

    @property
    def ttft(self) -> float:
        """Time to first token (s); nan until the first token lands."""
        if self.first_token_time < 0 or self.arrival_time < 0:
            return float("nan")
        return self.first_token_time - self.arrival_time

    @property
    def e2e_latency(self) -> float:
        """Arrival -> finish (s); nan until finished."""
        if self.finish_time < 0 or self.arrival_time < 0:
            return float("nan")
        return self.finish_time - self.arrival_time

    def effective_temperature(self, default: float) -> float:
        t = self.sampling.temperature
        return float(default if t is None else t)
