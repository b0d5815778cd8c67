"""Core strategies: butterfly-patterned partial sums and their siblings
(Fenwick, two-level, Gumbel, alias, radix forest), the prefix oracle, and
the one-shot ``sample_categorical`` / ``sample_from_logits``."""

from repro_torch.core.api import METHODS, sample_categorical, sample_from_logits
from repro_torch.core.butterfly import (
    DEFAULT_W,
    build_butterfly_table,
    build_fenwick_table,
    butterfly_rounds,
    butterfly_search,
    closed_form_table,
    draw_butterfly,
    draw_fenwick,
    draw_fenwick_from_table,
    draw_two_level,
    fenwick_search,
    pad_to_multiple,
)
from repro_torch.core.gumbel import draw_gumbel, draw_gumbel_logits
from repro_torch.core.reference import draw_linear_np, draw_prefix, prefix_sums

__all__ = [
    "METHODS", "DEFAULT_W", "sample_categorical", "sample_from_logits",
    "build_butterfly_table", "build_fenwick_table", "butterfly_rounds",
    "butterfly_search", "closed_form_table", "draw_butterfly", "draw_fenwick",
    "draw_fenwick_from_table", "draw_two_level",
    "fenwick_search", "pad_to_multiple", "draw_gumbel", "draw_gumbel_logits",
    "draw_linear_np", "draw_prefix", "prefix_sums",
]
