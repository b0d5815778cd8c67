"""LDA run configuration (the paper's own application).

Paper scale: M=43556 docs, V=37286 vocab, ~3.07M words, K in {16..240}
(Fig. 3 sweeps K = 32k+16).  CPU tests scale M/V down.
"""

import dataclasses


@dataclasses.dataclass(frozen=True)
class LDAConfig:
    name: str = "lda-wikipedia"
    M: int = 43556
    V: int = 37286
    K: int = 240
    alpha: float = 0.1
    beta: float = 0.05
    iterations: int = 100
    sampler_method: str = "butterfly"
    sampler_W: int = 32


CONFIG = LDAConfig()
SMOKE = LDAConfig(name="lda-smoke", M=96, V=120, K=8, iterations=5, sampler_W=8)
