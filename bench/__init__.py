"""The benchmark of the PyTorch/CUDA port (``repro_torch``): LDA Gibbs sweeps.

``BENCHMARK.json`` at the root of the checkout names the cells.  Each cell
is a configuration (``bench/configs/<name>.json``: the corpus and the
model's sizes) under a traffic mix (``bench/mixes/<name>.json``: which
route of ``gibbs_step`` the window drives, how the run is traced and
checked).  Each per-layer metric has a reader of its own,
``bench/metrics/<name>.py``.  The harness finds all three by the names in
``BENCHMARK.json``, so a new cell, mix or metric is new files plus entries.

Run a cell from the root of a checkout::

    python3 bench/run.py --workload lda-nytimes-k1000.dense --seed 7 \\
        --seconds 10 --trace 0

Nothing here imports ``jax``, ``jaxlib``, ``flax`` or the JAX package
``repro``; ``bench/reference.py`` imports nothing of ``repro_torch``.
"""
