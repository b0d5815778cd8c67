from repro_torch.kernels.lda_draw.ops import (
    lda_build_running,
    lda_draw,
    lda_draw_factored,
    lda_draw_factored_rng,
    lda_draw_from_running,
    lda_draw_from_running_rng,
)

__all__ = [
    "lda_build_running",
    "lda_draw",
    "lda_draw_factored",
    "lda_draw_factored_rng",
    "lda_draw_from_running",
    "lda_draw_from_running_rng",
]
