"""Serving layer: single-step factories (``engine``) and the
continuous-batching engine (``batching`` + ``request`` + ``scheduler``),
the counterpart of ``repro.serve``.
"""

from repro_torch.serve.batching import ContinuousBatchingEngine
from repro_torch.serve.engine import (
    GenerationResult,
    SamplingParams,
    default_sampling_params,
    generate,
    make_decode_step,
    make_prefill_step,
    make_serve_step,
)
from repro_torch.serve.request import FinishReason, Request, RequestState
from repro_torch.serve.scheduler import QueueFullError, Scheduler

__all__ = [
    "ContinuousBatchingEngine",
    "GenerationResult",
    "SamplingParams",
    "default_sampling_params",
    "generate",
    "make_decode_step",
    "make_prefill_step",
    "make_serve_step",
    "FinishReason",
    "Request",
    "RequestState",
    "QueueFullError",
    "Scheduler",
]
