#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--out results.json]
    python3 chip_smoke.py --timing-only [--src OTHER_CHECKOUT/src]

The second form builds and runs phase 2g's timings alone (no checks, no
result line), for this checkout or, with ``--src``, another commit's
kernels with the same inputs, so that one call can time two commits in
turns.

Phases, each of which raises on failure (exit code != 0, no result line):

1. Device: the card's name and power limit (nvidia-smi), then the CUDA
   kernels built from the sources in this checkout (nvcc, sm_90a, one
   process per library, all started together).
2. Kernels against their plain PyTorch versions on the card, at the main
   paths' shapes (K=240, V=37,286, one chunk of 256 documents = 27,392
   draws).  The factored draw: the fused draw (K8) through
   ``lda_draw_factored``, the forced two-pass route, pass A (K6) through
   ``lda_build_running`` and pass B (K7) through ``lda_draw_from_running``
   with S=1 and S=4.  The draw on the chunk's given weights: the
   butterfly table (K1, both layouts), the fused draw (K4), the forced
   two-pass route, pass A (K2) and pass B (K3) with S=1 and S=4.  W=32
   and W=16; integer weights (0 mismatches allowed), Dirichlet weights
   (float64-checked boundary ties only), bf16, and the padded last chunk
   with all-zero rows; K1 also at W=4 and W=8, K4 also at K=32,000 x
   B=64.  K1 also at W=64 and W=128 (integer, Dirichlet, bf16; and at
   (128, 256000), the butterfly state's) in both schedules, the split
   (P > 1 blocks a group at every case) equal to the serial one bit for
   bit.  K7 in both layouts (one warp, a group of W/4 lanes per draw)
   against the plain walk on K6's sums, bit for bit, S=1 and 4, at every
   K8 case, and K6 in both layouts equal bit for bit there (and to its
   plain version on integer factors).  K3 (a
   group of W/4 lanes per draw) also at W=8, 64 and 128 and at K=239
   (ncols % 4 != 0: four loads a lane), each case against its plain
   version on the plain running sums (ties only on real weights), against
   the plain walk on the card's running sums and against K4's draw on the
   same uniforms (both bit for bit).  The truncated draws (phase 2d): K9, K11 and K12 (S=1 and S=4; K12
   in both layouts, equal bit for bit) and both routes forced, at (8, 256000), (64, 256000), (64, 128256) and (24, 300);
   integer and peaked-softmax weights, bf16, zero rows, gemma2-9b's and
   per-row params with disabled stages; real-weight mismatches are ties
   only where float64 shows them within the rounding of sums as deep as
   the card's (``butterfly_sample.ref.cuda_sum_depth``).  K9's radix
   select equals its bisection body (``threshold="bisect"``) bit for bit
   on every case and on edge rows (all equal, one live token, -inf-logit
   zeros, -0.0, top-k > K, non-integer top-k, more top-p survivors than
   K9's list holds) at K = 300, 32,000, 56,000 (staged and from L2) and
   100,000; K11 equals ``masked_blocksums_warp_order_torch`` bit for bit
   there and at B = 1, 8, 64, W = 32, 64, 128.  The alias
   assembly (phase 2e):
   K13 at phi (37,286 x 240), (64, 4096) and (64, 256000), alias positions
   equal, prob within ``alias_build.ref.prob_tolerance``, and the induced
   mass of the device build; K13 in each layout that takes the shape
   (block, group, split) equal to the block layout and to its exact-order
   CPU model (``alias_build.ref.assemble_*_order_torch``) bit for bit
   there and on edge rows (zero weights, all light, all pads) at Kp = 256
   and 4,096.  Each kernel and its plain version are timed with CUDA
   events (and, where one PyTorch computation does the same work, its
   library yardstick: for the draws from given uniforms, K3, K4, K7, K8
   and K12, ``torch.searchsorted`` over ``torch.cumsum`` of the weights
   they draw from); the truncated routes end to end at (64, 256000);
   K9's radix select against its bisection body there and, with its rows
   staged in shared memory and read from L2, at (64, 32000) and (64,
   56000); K11 also at B = 8.  The seeded draws (phase 2f): K5
   at K4's cases (the chunk at W=32 and 16, integer, Dirichlet, bf16,
   zero rows; (64, 256000), (8, 256000) and (64, 32000) at W=128) and K10
   at K9's, each against its plain version and against K4 / K9 fed
   ``rng.row_uniforms`` (equal), with row offsets that wrap at 2**32, both
   routes forced, ``hw=True`` (Philox) twice and against its plain
   version; K4 and K5 in both layouts (one warp per row, a row split over
   several blocks) equal to the layout the rule picks, bit for bit, in
   every case, ``hw=True`` included; the device Threefry against
   ``rng.row_uniforms`` over 2**21 counters; K5 and K10 timed at (64,
   256000) beside K4 / K9 on the PyTorch uniforms they replace.  K8 in
   both layouts (one warp, a group of W/4 lanes per draw) against the
   rule's pick and against K6 + K7, and K2's split against its warp layout
   with K3 on the split's sums against K4, bit for bit, at the chunk's
   cases, W = 8 ... 128, K = 239, bf16, zero rows and (for K2) decode
   widths.  Phase 2g times K2, K4 and K5 in both layouts (K2 beside
   ``view(B, nb, W).sum(-1).cumsum(1)``; K2 also with device times at
   every shape) at the chunk, (64, 4096), (64,
   32000), (8, 256000), (64, 256000) and a grid of B x K around the layout
   rule's crossover, K3 at the chunk with S=1 and S=4, K8 in both layouts
   and K6 + K7 at the chunk for K = 240 ... 3,000 and over every padded
   position of the corpus, K7 in both layouts at the chunk and K = 3,000
   (S=1 and 4), K1 in both schedules at (128, 256000) (each kernel's
   device time apart) and over a B x K grid at W = 64 and 128, K11 at
   (64, 256000), the device times of K1 at the chunk, K6, K9, K10, K12
   and K13 at the main paths' shapes, K6 in both layouts beside its
   library call (the gathered product, ``view(Bt, nb, W).sum(-1).
   cumsum(1)``) at the chunk and at K = 3,000, K12 in both layouts at
   (64, 256000), (64, 4096), (64, 32000) and (64, 128256) with S = 1 and
   4, beside the device time of a 64-element ``add_``, and K13 in each
   layout at phi and (64, 256000) and over a B x Kp grid, with the
   ``alias_device`` build's steps (``_partition``, ``_merged_rank``, K13)
   beside the whole build and its path.
3. The main paths at the paper's Wikipedia scale (M=43,556 docs,
   V=37,286 words, K=240, ~3.07M tokens, Zipf word ids, made from --seed),
   each run with the launch counts set to 0 just before it and read just
   after: 3 ``gibbs_step`` sweeps with ``method="lda_kernel"``, W=32 (K8,
   one launch per chunk of 256 docs), then ``sample_z`` with 4 draws per
   token (K6 + K7 per chunk); 3 sweeps with ``method="butterfly"`` (K1 per
   chunk) and 3 with ``method="kernel"`` (K2 + K3 per chunk), W=16 (the
   reference's ``default_w(240)``); the given-weights entry points over
   every chunk of the last state (``butterfly_sample``, K4;
   ``build_block_sums`` and ``butterfly_sample_from_sums_rng`` with 4
   draws per token, K2 + K3).  Then one sweep per method under
   ``torch.profiler`` (device time by kernel, the device's busy share) and
   the Figure-3 K-sweep (lda_kernel, butterfly, kernel and prefix),
   printed, no claim made.
4. A planted corpus: 30 ``lda_kernel`` sweeps must bring perplexity below
   0.6 x its initial value.
5. The sampling API, each path with the launch counts set to 0 just
   before it and read just after: decode at gemma2-9b's width, 20 steps of
   ``plan((64, 256000), method="kernel", transforms="kp").sample_logits``
   with top-k 64 / top-p 0.95, then per-row params (K9 once per step),
   then four tokens per row (K11 and K12 once per step), and the same at a
   32,000-token vocabulary; ``sample_from_logits`` at (64, 256000) once
   per explicit method (``alias`` at (64, 4096)), including ``butterfly``
   (K1 at W=128) and ``alias_device`` (K13 at Kp=262,144); the butterfly
   ``Categorical`` at (64, 256000) against its plain table;
   ``Categorical.from_weights(phi, method="alias_device")`` with 16 draws
   per row and its induced mass; one paper-scale sweep each with
   ``gumbel`` and ``alias``.
6. The sharded paths on a one-rank NCCL group (in-memory store) and its
   ``("data",)`` mesh, each with the launch counts read per path: 20
   decode steps of ``plan((64, 256000), method="kernel", mesh=mesh,
   transforms="kp").sample_logits(..., key=...)`` with top-k 64 / top-p
   0.95 (K10 once per step) and 20 without the chain (K5 once per step),
   the first step equal to the unsharded counter draw; ``sample`` at
   (64, 256000) once per explicit method (``alias`` at (64, 4096)), each
   equal to the unsharded counter draw; the per-shard bodies for R = 2
   and 8 shards, concatenated, equal to the one-rank draws (two NCCL
   ranks cannot share one card); 3 paper-scale sweeps of
   ``make_sharded_gibbs(mesh, 240, V, method="lda_kernel", W=32)`` with
   exactly one ``all_reduce`` per sweep and the first sweep's z equal to
   ``lda_draw_factored_rng`` on the whole batch; 30 sweeps of the planted
   corpus below 0.6x its start; 3 sweeps of ``make_sharded_gibbs(mesh,
   240, V, sparse=True)`` (S1 once and one ``all_reduce`` a sweep), each
   sweep's z equal to ``draw_z_sparse`` on its incoming state (cdf
   tables, the same cap and seed).  Phase 5b's grid (the autotune
   buckets) times ``sparse_mh`` in its factored buckets (``|sp``) and in
   two buckets of 2**21 tokens (K = 240, 2,048) where only ``lda_kernel``
   and ``sparse_mh`` run, and ``fit_cuda`` fits its terms too.
7. Sparse LDA at the Wikipedia corpus: S1 (the MH sweep kernel) in both
   layouts ("doc", the rule's pick, and "position", the first port's
   body) against its plain version and each other bit for bit (z, both
   accept counts, the proposal count) with cdf, alias and alias_device
   tables, 1 and 4 steps, cap 8 (truncating) and 64, then documents
   masked out, row counters that wrap at 2**32, K = 2,048 (8,192
   documents), every document masked, cap 1 and cap = K, doc proposals
   exactly at K alpha and on a cc value, documents of 307 positions, and
   K = 16,384 (where the rule takes "position"); at K = 240, 1,024 and
   2,048, 3 ``gibbs_step(sparse=True)`` sweeps each with cdf,
   alias_device and auto tables (S1 once a sweep, K13 once a sweep with
   alias_device tables), one ``sparse="auto"`` sweep (its resolution
   printed) and 3 sweeps of the dense default, each path's launches read
   around it; in a fresh process (this script with ``--sparse-profile``,
   whose traces hold every launch), S1's event and device times in both
   layouts at K = 240, 1,024 and 2,048 (cdf and alias_device tables)
   beside its plain version and bound, and the sparse sweep profiled,
   S1's count in its trace; 2 sweeps of ``StreamingSparseLDA`` over
   ``zipf_shard_source`` (50,000 documents in 4 shards, the corpus's
   vocabulary) with tokens/s.
8. Serving, the decoder path (``repro_torch.models`` and
   ``repro_torch.serve``), each path with the launch counts read around
   it: gemma2-9b's ``CONFIG`` at full width and depth (42 layers, d_model
   3,584, head_dim 256, d_ff 14,336, V = 256,000), bfloat16 parameters
   from ``init_params`` on the card (seeded), float32 caches.
   ``ContinuousBatchingEngine`` at ``ServeSpec`` defaults (8 slots,
   ``max_len`` 256, ``prefill_chunk`` 2) serves 16 requests (prompts of
   1-120 tokens, 16-48 new, the model card's top-k 64 / top-p 0.95,
   greedy, min-p 0.05 and top-k 1 in turns): every request finishes with
   tokens below V, greedy and top-k 1 rows equal the argmax of the step's
   logits, four requests run alone in fresh engines give the same tokens,
   and one step at 8 live slots has its truncated draw (K9) held against
   the plain version; K9 (or what the plan's method implies) once per
   step.  Seconds a step at 8 live slots (median, p90), the draw's CUDA
   events within the step, prefill seconds per bucket, tokens/s, peak
   memory, and a profiled window of 3 steps (busy share, kernels a step).
   Then ``generate`` over 64 prompts of 32 tokens, 8 new, with the model
   card's truncation (K9 at (64, 256000) once per token), and one
   ``make_decode_step(num_samples=4)`` call (K11 + K12 once).
9. The other model families at full width, bfloat16 parameters from
   ``init_params`` on the card, each model freed before the next, each
   path's launches read around it.  Through ``ContinuousBatchingEngine``
   (8 slots, float32 caches, the plan's method set to ``kernel``; what
   ``auto`` would pick is printed): minicpm3-4b (MLA), granite-moe-1b-a400m
   (MoE), mamba2-370m (SSM) and hymba-1.5b (hybrid, 128 meta tokens), 10
   requests each (plain, top-p 0.9, top-k 20, top-k 1 and greedy in turns):
   K9 once a step, one step at 8 live slots held against its plain
   version, greedy and top-k 1 rows the argmax, no token at or past V,
   finite logits, and (not MoE, whose capacity couples rows) four requests
   alone equal to their batched tokens.  Through ``generate`` (4 prompts
   of 32 tokens, 8 new, bfloat16 caches): pixtral-12b with 256 stub patch
   embeddings, seamless-m4t-medium with 64 stub frames (V = 256,206) and
   arctic-480b at full width but 1 of its 35 layers (a cut of depth,
   printed).  Each family then takes one ``make_decode_step(num_samples=4)``
   call under top-k 20 / top-p 0.9 with the plan's method set to
   ``kernel`` (K11 + K12 once; every candidate within its row's top-k).
   Seconds a decode step (median, p90), tokens/s, prefill seconds per
   bucket, peak memory and launches per family.
10. Training: 3 steps each of granite-moe-1b-a400m and mamba2-370m at full
   width and depth (bfloat16 parameters, float32 AdamW state, a batch of
   4 x 512 from ``TokenPipeline`` repeated, ``remat="full"``): finite
   losses that fall, parameters that move, seconds a step, tokens/s and
   peak memory; then one AdamW step of every architecture's SMOKE config
   on the card (``remat="full"``) against the same step on the CPU
   (``remat="none"``): loss and gradient norm within rtol 1e-4, every
   parameter within 2e-4.
11. The launchers (``repro_torch.dist`` and ``repro_torch.launch``) on a
   one-rank NCCL group (an in-memory store, no TCP port) and the
   ("data", "model") mesh of (1, 1) that ``launch.mesh`` builds.
   (a) ``launch.train``'s loop at full width and depth of mamba2-370m
   (float32 parameters, AdamW, 4 x 512, ``--ckpt-every 2``, checkpoints
   under ``build/``; the free disk space checked first): an uninterrupted
   6-step run; a run that sends itself SIGTERM after step 3 and commits a
   checkpoint; a second call that resumes it to step 6.  The restored tree
   bit-equal to the saved one, the resumed batches bit-equal to the
   uninterrupted run's, the losses within rtol 1e-3 of it; seconds a step,
   the saves' and the restore's seconds, bytes and files, and the
   StepMonitor summary; one ``compress=True`` save of the AdamW moments,
   each element back within its scale / 2.  (b) ``launch.serve``'s
   ``run`` at full width and depth of qwen3-4b (float32 parameters, the
   plan's method set to ``kernel``): ``--continuous`` (K9), ``--continuous
   --dp 1 --tp 1`` (the engine on the mesh: thresholds, K2 + K3) with the
   same tokens, and ``generate`` on the mesh (K10); each path's first
   launch of each kernel held to its plain version; seconds a step,
   tokens/s and peak memory.  (c) ``launch.train --app lda`` at
   configs/lda.py's CONFIG for 2 sweeps (the ``butterfly`` method, K1).
12. The dry-run (``launch.dryrun``, ``launch.costing``) on a fake process
   group of 512 ranks.  (a) ``lower_cell`` traces fourteen production cells
   at full width under ``FakeTensorMode`` on cuda meshes, ``DRYRUN_WORKERS``
   processes at a time, each with its own fake group: gemma2-9b
   ``decode_32k``, llama3-8b and seamless-m4t-medium ``train_4k``,
   hymba-1.5b ``decode_32k`` (the cache's keys split over ``model``,
   combined by log-sum-exp) and ``prefill_32k`` (the chunked path, a
   window and meta tokens, the queries split over ``model``),
   minicpm3-4b, hymba-1.5b and arctic-480b ``train_4k`` (attention's
   projections on each rank's own positions, the backward),
   llama3-8b ``decode_32k`` (the MLP's weights in place), granite-moe-1b-a400m
   ``train_4k`` (the MoE dispatch over its experts), pixtral-12b
   ``train_4k`` (the MLP with its d_ff over ``model``) and mamba2-370m
   ``decode_32k`` (50,280 columns split unevenly) on the 256-rank pod,
   qwen3-4b ``prefill_32k`` and minicpm3-4b ``decode_32k`` (MLA decode,
   ROADMAP.md F6) on the 512-rank two-pod mesh; each prints its
   parameters, trace seconds, per-device memory (beside the card's 80 GB)
   and its five largest storages at the peak, FLOPs and the ops that hold
   the most of them, bytes, collectives by kind, the
   resolved sampler and the kernels traced by their fake rules, and holds
   its parameter and AdamW-state bytes per device equal to
   ``dist.sharding.tree_bytes_per_device`` on the same mesh.  llama3-8b
   ``train_4k`` (the sharded loss and unembedding) must hold no float32
   logits over the whole vocabulary at its peak, peak under 40 GiB a
   device and count at most 1.25x the reference's 2.87e14 FLOPs a device
   (XLA's count of the reference's dry-run on a CPU host).  The six
   cells whose heads the ``model`` degree does not divide count at most
   1.25x the reference's FLOPs a device (``ATTN_REF_FLOPS``, the same
   source); hymba-1.5b ``decode_32k`` moves no all-gather with the
   cache's length and under a tenth of the 5.416e10 bytes of collectives
   it moved while it gathered its cache, and peaks under the 3.919 GiB it
   took then; the three ``train_4k`` cells print the local shapes of
   their three ops of the most FLOPs, none of which may take a projection
   of attention over every position of a rank's rows, and minicpm3-4b's
   and hymba-1.5b's peak under the card's 80 GB (arctic-480b's peak is
   printed: neither package fits it).  llama3-8b ``decode_32k`` moves at
   most 9.9e9 bytes of collectives a step and all-gathers no block of an
   MLP weight.  The three cells of the MoE dispatch, the MLP and the
   odd vocabulary (ROADMAP.md F5 (b)-(d)) count at most 1.25x the
   reference's FLOPs a device (``LAYER_REF_FLOPS``, the same source) and
   peak under the card's 80 GB; mamba2-370m ``decode_32k``'s ops hold no
   product over the whole vocabulary.  (b) One card: the dry-run without a mesh, then the same
   step run for real on inputs of the same shapes (``dryrun.real_inputs``,
   ``cell_step``): gemma2-9b at full width and depth, 8 sequences, 4,096
   cache positions, bfloat16 parameters and caches, as the serve step
   resolves its draw and under the model card's top-k 64 / top-p 0.95
   (K9), and granite-moe-1b-a400m training at 4 x 512 with AdamW and
   ``remat="full"``; FLOPs (``FlopCounterMode`` over the real step) and
   kernel calls (the wrappers' launch counts) equal, the predicted peak
   within 10% of ``max_memory_allocated`` above what was held before the
   inputs were made, the first launch of each kernel held to its plain
   version.

The last two lines are the ``{"kernels": [...]}`` record (the 13 TPU
kernels and S1; a kernel with several layouts also gives the one its
rule picks at each main-path shape; a kernel phase 12 traced gives its
``traced_calls``) and
``{"ok": true, "device": {...}}``.  There is no CPU path: without a CUDA
device the script exits 1 before printing a result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import hashlib
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# --src DIR (with --timing-only) imports the port from DIR, another
# checkout's src/, so that one call can time two commits' kernels in turns
SRC = (Path(sys.argv[sys.argv.index("--src") + 1]).resolve()
       if "--src" in sys.argv[:-1] else ROOT / "src")
sys.path.insert(0, str(SRC))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import sampling  # noqa: E402
from repro_torch import serve  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.configs import gemma2_9b  # noqa: E402
from repro_torch.configs.base import SamplerSpec, ShapeConfig  # noqa: E402
from repro_torch.data.pipeline import TokenPipeline  # noqa: E402
from repro_torch.configs.lda import CONFIG  # noqa: E402
from repro_torch.core import api  # noqa: E402
from repro_torch.core import butterfly as bfly  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import rng  # noqa: E402
from repro_torch.kernels import runtime  # noqa: E402
from repro_torch.kernels.alias_build import kernel as KA  # noqa: E402
from repro_torch.kernels.alias_build import ops as aops  # noqa: E402
from repro_torch.kernels.alias_build import ref as alias_ref  # noqa: E402
from repro_torch.kernels.alias_build.ref import prob_tolerance  # noqa: E402
from repro_torch.kernels.butterfly_sample import kernel as KB  # noqa: E402
from repro_torch.kernels.butterfly_sample import ops as bops  # noqa: E402
from repro_torch.kernels.butterfly_sample.ref import boundary_ties as weight_ties  # noqa: E402
from repro_torch.kernels.butterfly_sample.ref import (  # noqa: E402
    cuda_sum_depth, masked_blocksums_warp_order_torch, trunc_boundary_ties)
from repro_torch.kernels.butterfly_table import kernel as KT  # noqa: E402
from repro_torch.kernels.butterfly_table import ref as KTR  # noqa: E402
from repro_torch.kernels.lda_draw import kernel as KL  # noqa: E402
from repro_torch.kernels.lda_draw import ops  # noqa: E402
from repro_torch.kernels.lda_draw.ref import boundary_ties  # noqa: E402
from repro_torch.kernels.sparse_mh import kernel as KS  # noqa: E402
from repro_torch.kernels.sparse_mh import ref as sparse_ref  # noqa: E402
from repro_torch.lda import corpus as corpus_mod  # noqa: E402
from repro_torch.lda import gibbs  # noqa: E402
from repro_torch.lda import sparse as lsp  # noqa: E402
from repro_torch.models import build_model, init_params, param_count  # noqa: E402
from repro_torch.models.params import tree_leaves, tree_map  # noqa: E402
from repro_torch.serve.engine import _logits_plan, _pad_caches_to, _sp_sig  # noqa: E402
from repro_torch.sampling import reference as sref  # noqa: E402
from repro_torch.sampling import transforms as tr  # noqa: E402
from repro_torch.train.optimizer import make_optimizer  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOPS = 67e12             # H100 SXM fp32 outside the tensor cores
_CSRC = "src/repro_torch/kernels/{0}/csrc/{0}.cu"
_TPU = "src/repro/kernels/{}/kernel.py:{}"
_TRUNC_SRC = "src/repro_torch/kernels/butterfly_sample/csrc/butterfly_trunc.cu"
KERNELS = {  # wrapper name -> (kernel-table id, source, TPU kernel it replaces, counts)
    "butterfly_table": ("K1", _CSRC.format("butterfly_table"),
                        _TPU.format("butterfly_table", 56), KT.LAUNCHES),
    "blocksums": ("K2", _CSRC.format("butterfly_sample"),
                  _TPU.format("butterfly_sample", 140), KB.LAUNCHES),
    "walk": ("K3", _CSRC.format("butterfly_sample"),
             _TPU.format("butterfly_sample", 744), KB.LAUNCHES),
    "fused_draw": ("K4", _CSRC.format("butterfly_sample"),
                   _TPU.format("butterfly_sample", 183), KB.LAUNCHES),
    "fused_draw_rng": ("K5", _CSRC.format("butterfly_sample"),
                       _TPU.format("butterfly_sample", 219), KB.LAUNCHES),
    "lda_blocksums": ("K6", _CSRC.format("lda_draw"), _TPU.format("lda_draw", 125),
                      KL.LAUNCHES),
    "lda_walk": ("K7", _CSRC.format("lda_draw"), _TPU.format("lda_draw", 178),
                 KL.LAUNCHES),
    "lda_fused_draw": ("K8", _CSRC.format("lda_draw"), _TPU.format("lda_draw", 61),
                       KL.LAUNCHES),
    "fused_trunc_draw": ("K9", _TRUNC_SRC, _TPU.format("butterfly_sample", 389),
                         KB.LAUNCHES),
    "fused_trunc_draw_rng": ("K10", _TRUNC_SRC, _TPU.format("butterfly_sample", 428),
                             KB.LAUNCHES),
    "masked_blocksums": ("K11", _TRUNC_SRC, _TPU.format("butterfly_sample", 484),
                         KB.LAUNCHES),
    "walk_trunc": ("K12", _TRUNC_SRC, _TPU.format("butterfly_sample", 522), KB.LAUNCHES),
    "alias_assemble": ("K13", _CSRC.format("alias_build"), _TPU.format("alias_build", 115),
                       KA.LAUNCHES),
    # S1 replaces no pallas_call: the reference's MH sweep is XLA
    "sparse_mh": ("S1", _CSRC.format("sparse_mh"), "src/repro/lda/sparse.py:192",
                  KS.LAUNCHES),
}
# decode widths: gemma2-9b's vocabulary (top-k 64, top-p 0.95), whose
# rows K9 reads from L2, and the 32,000-token vocabulary of the repo's
# arctic-480b config (the llama-2 tokenizer's), whose rows K9 stages in
# shared memory
DECODE_B = 64
DECODE_VOCABS = (gemma2_9b.VOCAB_SIZE, 32000)


def path_layouts(L: int) -> dict:
    """The layout (K1: schedule) each kernel's rule picks at the shapes the
    main paths give it: the chunk (27,392 draws, K = 240; W = 16 for the
    given weights, 32 for the factors), the decode widths (W = 128) and
    the sparse sweep over the corpus's documents of L positions; kernels
    with one layout are absent."""
    Vd = gemma2_9b.VOCAB_SIZE
    nbv, nbc = KB.num_blocks(Vd, 128), KB.num_blocks(CONFIG.K, 16)
    chunk, dec = "chunk", f"(64, {Vd})"
    return {
        "butterfly_table": {chunk: KT.table_schedule(27392 // 16, nbc, 16),
                            f"(128, {Vd})": KT.table_schedule(1, Vd // 128, 128)},
        "blocksums": {chunk: KB.blocksums_layout(27392, nbc, 16),
                      dec: KB.blocksums_layout(64, nbv, 128)},
        "fused_draw": {chunk: KB.fused_layout(27392, nbc, 16)},
        "fused_draw_rng": {dec: KB.fused_layout(64, nbv, 128)},
        "lda_blocksums": {chunk: KL.lda_blocksums_layout(KL.num_blocks(CONFIG.K, 32), 32)},
        "lda_walk": {chunk: KL.lda_walk_layout(KL.num_blocks(CONFIG.K, 32), 32)},
        "lda_fused_draw": {chunk: KL.lda_fused_layout(KL.num_blocks(CONFIG.K, 32), 32)},
        "walk_trunc": {f"(64, {K})": KB.walk_trunc_layout(KB.num_blocks(K, 128), 128)
                       for K in DECODE_VOCABS},
        "alias_assemble": {"phi": KA.alias_layout(CONFIG.V, aops._next_pow2(CONFIG.K)),
                           dec: KA.alias_layout(64, aops._next_pow2(Vd))},
        "sparse_mh": {f"corpus K={K} cap 64": KS.mh_layout(K, 64, L) for K in SPARSE_KS},
    }


def reset_counts() -> None:
    for mod in (KT, KB, KL, KA, KS):
        mod.reset_launches()


def read_counts() -> dict:
    return {name: k[3][name] for name, k in KERNELS.items()}


_START = time.perf_counter()


def log(*a):
    """Print a line; a phase's first line ends with the script's seconds."""
    if a and isinstance(a[0], str) and a[0].startswith("phase "):
        a = (*a, f"[{time.perf_counter() - _START:.1f} s]")
    print(*a, flush=True)


def free_device() -> None:
    """Free a phase's device memory: collect the reference cycles first (a
    traced engine's draw and step close over the engine, which holds the
    parameters), then return the cached blocks."""
    gc.collect()
    torch.cuda.empty_cache()


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over reps launches, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / reps


def device_ms_by_kernel(fn, reps: int = 20) -> dict:
    """Mean device time per call of fn() from torch.profiler, by kernel
    name: the kernels' own time on the card, without the host's gaps
    between launches (which CUDA events around a run of calls include)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / reps / 1e3 for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}


def device_ms(fn, reps: int = 20):
    """The sum of :func:`device_ms_by_kernel`; None (not measured) when
    the trace holds no kernel: the profiler missed them."""
    ms = sum(device_ms_by_kernel(fn, reps).values())
    return ms if ms > 0 else None


def _ms(v) -> str:
    return "not measured" if v is None else f"{v:.4f} ms"


def host_us(fn, reps: int = 200) -> float:
    """Host time per call of fn() in microseconds: the wrapper's checks,
    allocations and launch, with no synchronisation inside the loop (the
    card's queue holds every launch), so the card's time is not in it."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / reps * 1e6


def paper_corpus(seed: int, M: int, V: int, avg_len=70.5, max_len=307,
                 zipf=1.05) -> corpus_mod.Corpus:
    """A corpus at the paper's scale, vectorised from a seed: Poisson doc
    lengths clipped to [1, max_len], Zipf-distributed word ids (id = rank)."""
    rng = np.random.default_rng(seed)
    lengths = np.clip(rng.poisson(avg_len, size=M), 1, max_len).astype(np.int32)
    maxN = int(lengths.max())
    p = np.arange(1, V + 1, dtype=np.float64) ** -zipf
    cdf = np.cumsum(p) / p.sum()
    words = np.searchsorted(cdf, rng.random(int(lengths.sum())), side="right")
    mask = np.arange(maxN)[None, :] < lengths[:, None]
    docs = np.zeros((M, maxN), np.int32)
    docs[mask] = np.minimum(words, V - 1)
    return corpus_mod.Corpus(docs=docs, lengths=lengths, mask=mask, vocab_size=V)


def factors(kind: str, C: int, V: int, K: int, g: torch.Generator, dev):
    if kind == "int":
        th = torch.randint(1, 100, (C, K), generator=g, device=dev).float()
        ph = torch.randint(1, 100, (V, K), generator=g, device=dev).float()
        return th, ph
    th = torch._standard_gamma(torch.full((C, K), 0.3, device=dev), generator=g)
    ph = torch._standard_gamma(torch.full((V, K), 0.3, device=dev), generator=g)
    return th / th.sum(1, keepdim=True), ph / ph.sum(0, keepdim=True)


class Tally:
    """Per-kernel comparison results over every case of phase 2."""

    def __init__(self):
        self.t = {n: {"cases": 0, "mismatches": 0, "ties": 0, "max_abs_err": 0.0}
                  for n in KERNELS}

    def _indices(self, name, case, a, b, res, exact: bool):
        t = self.t[name]
        t["cases"] += 1
        t["mismatches"] += res["mismatches"] if exact else 0
        t["ties"] += 0 if exact else res["ties"]
        t["max_abs_err"] = max(t["max_abs_err"],
                               float((a.long() - b.long()).abs().max()) if exact else 0.0)
        bad = res["mismatches"] if exact else res["faults"]
        log(f"  {name:15s} {case:34s} mismatches={res['mismatches']} "
            f"ties={res['ties']} faults={res['faults']}")
        if bad:
            raise AssertionError(f"{name} disagrees with its plain version: {case} {res}")

    def indices(self, name, case, a, b, th, ph, d, w, u, exact: bool):
        """Draws from the factors theta[d] * phi[w]."""
        self._indices(name, case, a, b, boundary_ties(a, b, th, ph, d, w, u), exact)

    def weights(self, name, case, a, b, wts, u, exact: bool):
        """Draws from given (B, K) weights."""
        self._indices(name, case, a, b, weight_ties(a, b, wts, u), exact)

    def running(self, name, case, a, b, exact: bool, rel_tol=240 * 2.0 ** -23):
        t = self.t[name]
        t["cases"] += 1
        err = float((a - b).abs().max())
        rel = err / max(float(b.abs().max()), 1e-30)
        log(f"  {name:15s} {case:34s} max_abs_err={err:.3g} rel={rel:.3g}")
        if exact and err:
            raise AssertionError(f"{name} running sums differ on integer weights: {err}")
        if rel > rel_tol:
            raise AssertionError(f"{name} running sums off by {rel:.3g} relative")
        if exact:
            t["max_abs_err"] = max(t["max_abs_err"], err)

    def same(self, name, case, a, b):
        """Two outputs that must be equal bit for bit (two bodies or two
        orders of one computation)."""
        t = self.t[name]
        t["cases"] += 1
        mis = int((a != b).sum())
        log(f"  {name:15s} {case:34s} bit-equal: {mis} differ")
        if mis:
            raise AssertionError(f"{name}: {case}: {mis} of {a.numel()} differ")

    def trunc(self, name, case, a, b, wts, u, params, exact: bool):
        """Truncated draws from given weights (float64 tau and stop ties,
        with the rounding of sums as deep as the card's)."""
        res = trunc_boundary_ties(a, b, wts, u, params, depth=cuda_sum_depth(wts.shape[1]))
        self._indices(name, case, a, b, res, exact)

    def assemble(self, name, case, got, want, tol):
        """K13: alias positions equal, prob within ``tol``."""
        t = self.t[name]
        t["cases"] += 1
        mis = int((got[1] != want[1]).sum())
        err = float((got[0] - want[0]).abs().max())
        log(f"  {name:15s} {case:34s} apos mismatches={mis} prob max_abs_err={err:.3g} "
            f"(bound {tol:.3g})")
        if mis or err > tol:
            raise AssertionError(f"{name} disagrees with its plain version: {case}")
        t["max_abs_err"] = max(t["max_abs_err"], err)

    def table(self, name, case, got, want, W, exact: bool):
        """Butterfly tables in the (G, nb, W, W) layout: rows 0..W-2 of
        every block equal; the running row W-1 equal on integer weights,
        else within nb fp32 roundings (the kernel carries it in order,
        the plain version takes torch.cumsum)."""
        t = self.t[name]
        t["cases"] += 1
        nb = got.shape[1]
        seg = int((got[..., : W - 1, :] != want[..., : W - 1, :]).sum())
        err = float((got - want).abs().max())
        rel = float(((got - want).abs() / want.abs().clamp(min=1e-30))[..., W - 1, :].max())
        log(f"  {name:15s} {case:34s} segment mismatches={seg} "
            f"max_abs_err={err:.3g} running rel={rel:.3g}")
        if seg or (exact and err) or rel > nb * 2.0 ** -22:
            raise AssertionError(f"{name} table differs from its plain version: {case}")
        if exact:
            t["max_abs_err"] = max(t["max_abs_err"], err)


def rows_to_blocks(t, W):
    """(B, K) butterfly table -> its (G, nb, W, W) layout."""
    B, K = t.shape
    return t.view(B // W, W, K // W, W).transpose(1, 2)


def phase_kernels(corpus, dev, seed: int):
    K, V, C = CONFIG.K, corpus.vocab_size, 256
    g = torch.Generator(device=dev).manual_seed(seed)
    docs_c = torch.as_tensor(corpus.docs[:C], device=dev)
    N = docs_c.shape[1]
    Bt = C * N
    d = (torch.arange(Bt, device=dev, dtype=torch.int32) // N).contiguous()
    w = docs_c.reshape(-1).contiguous()
    u = torch.rand(Bt, generator=g, device=dev)
    u4 = torch.rand((4, Bt), generator=g, device=dev)
    log(f"phase 2: kernels vs plain at C={C} docs x maxN={N} = {Bt} draws, K={K}, V={V}")
    tally = Tally()
    for W in (32, 16):
        for kind in ("int", "dirichlet"):
            exact = kind == "int"
            th, ph = factors(kind, C, V, K, g, dev)
            case = f"W={W} {kind}"
            plain = ops.lda_draw_factored(th, ph, d, w, u, W=W, impl="torch")
            fused = ops.lda_draw_factored(th, ph, d, w, u, W=W)
            tally.indices("lda_fused_draw", case, fused, plain, th, ph, d, w, u, exact)
            check_lda_layouts(tally, case, th, ph, d, w, u, u4, W, exact)
            two = KL.lda_draw_docs(th, ph, d, w, u, W, route="two_pass")
            tally.indices("lda_walk", case + " two-pass route", two, plain,
                          th, ph, d, w, u, exact)
            _, _, run = ops.lda_build_running(th, ph, d, w, W=W)
            _, _, run_p = ops.lda_build_running(th, ph, d, w, W=W, impl="torch")
            tally.running("lda_blocksums", case, run, run_p, exact)
            for S, uu in ((1, u), (4, u4)):
                a = ops.lda_draw_from_running(th, ph, run, uu, d, w, K=K, W=W)
                b = ops.lda_draw_from_running(th, ph, run, uu, d, w, K=K, W=W, impl="torch")
                tally.indices("lda_walk", f"{case} S={S}", a, b, th, ph, d, w, uu, exact)
    # bf16 factors (integer values < 256 are exact in bf16)
    th, ph = (x.to(torch.bfloat16) for x in factors("int", C, V, K, g, dev))
    tally.indices("lda_fused_draw", "W=32 bf16",
                  ops.lda_draw_factored(th, ph, d, w, u, W=32),
                  ops.lda_draw_factored(th, ph, d, w, u, W=32, impl="torch"),
                  th.float(), ph.float(), d, w, u, True)
    check_lda_layouts(tally, "W=32 bf16", th, ph, d, w, u, u4, 32, True)
    # K8's layouts at the other widths, and at K = 239 (ncols % 4 != 0: the
    # group layout's four-loads-a-lane instantiation)
    for W in (8, 64, 128):
        th, ph = factors("dirichlet", C, V, K, g, dev)
        check_lda_layouts(tally, f"W={W} dirichlet", th, ph, d, w, u, u4, W)
    th, ph = (x[:, :K - 1].contiguous() for x in factors("dirichlet", C, V, K, g, dev))
    check_lda_layouts(tally, f"K={K - 1} W=32 dirichlet", th, ph, d, w, u, u4, 32)
    # the sweep's last chunk: padded with all-zero theta rows
    th, ph = factors("dirichlet", corpus.docs.shape[0], V, K, g, dev)
    docs = torch.as_tensor(corpus.docs, device=dev)
    *_, (start, end, th_c, docs_p) = gibbs._chunks(th, docs, C)
    log(f"  last chunk: docs {start}..{end}, {C - (end - start)} all-zero theta rows")
    wz = docs_p.reshape(-1).contiguous()
    a = ops.lda_draw_factored(th_c, ph, d, wz, u, W=32)
    b = ops.lda_draw_factored(th_c, ph, d, wz, u, W=32, impl="torch")
    tally.indices("lda_fused_draw", "W=32 zero rows", a, b, th_c, ph, d, wz, u, False)
    check_lda_layouts(tally, "W=32 zero rows", th_c, ph, d, wz, u, u4, 32)
    if int(a.min()) < 0 or int(a.max()) >= K:
        raise AssertionError("zero-row chunk drew an index outside [0, K)")
    return tally, (d, w, u, u4)


def check_lda_layouts(tally, case, th, ph, d, w, u, u4, W, exact=False):
    """K8 in each layout that fits against the layout the rule picks, and
    K8 against K6 + K7 on the same uniforms (all bit for bit: the group
    layout makes the warp layout's adds, which are K6's and K7's).  K6 in
    each layout that fits against the rule's pick (bit for bit), and on
    integer factors (``exact``) against its plain version.  K7 in each
    layout against the plain walk on K6's running sums, S = 1 and 4 (bit
    for bit: the same adds), so its group and warp layouts agree."""
    nb = KL.num_blocks(th.shape[1], W)
    a = KL.lda_fused_draw(th, ph, d, w, u, W)
    for layout in KL.LAYOUTS:
        if (KL.group_fits if layout == "group" else KL.fused_fits)(nb, W):
            tally.same("lda_fused_draw", f"{case} {layout} layout",
                       KL._lda_fused_draw(th, ph, d, w, u, W, layout=layout), a)
    run = KL.lda_blocksums(th, ph, d, w, W, nb)
    for layout in KL.LAYOUTS:
        if layout == "warp" or KL.group_fits(nb, W):
            tally.same("lda_blocksums", f"{case} {layout} layout",
                       KL._lda_blocksums(th, ph, d, w, W, nb, layout=layout), run)
    if exact:
        tally.same("lda_blocksums", f"{case} vs plain", run,
                   KL.lda_blocksums_torch(th, ph, d, w, W, nb))
    rows = torch.arange(u.shape[0], dtype=torch.int32, device=u.device)
    tally.same("lda_fused_draw", f"{case} vs K6 + K7", a,
               KL.lda_walk(th, ph, run, u, rows, d, w, W))
    for S, uu in ((1, u), (4, u4.reshape(-1).contiguous())):
        rs = rows.repeat(S)
        ds, ws = d.repeat(S), w.repeat(S)
        plain = KL.lda_walk_torch(th, ph, run, uu, rs, ds, ws, W).to(torch.int32)
        for layout in KL.LAYOUTS:
            tally.same("lda_walk", f"{case} S={S} {layout} vs plain walk",
                       KL._lda_walk(th, ph, run, uu, rs, ds, ws, W, layout=layout), plain)


def chunk_weights(th, ph, d, w):
    """The (C*N, K) weights of one chunk, as the sweep forms them."""
    return (th[d.long()] * ph[w.long()]).contiguous()


def check_table(tally, case, wts, W, exact):
    """K1 in both layouts against its plain version; the sweep pads K to a
    multiple of W as ``core.butterfly._prep`` does.  At W = 64 and 128 in
    both schedules, the split (P blocks a group, P > 1 at every case: its
    runs end mid-row) equal to the serial one bit for bit, and the
    rule's pick equal to both."""
    wp, _ = bfly.pad_to_multiple(wts, axis=1, mult=W)
    G, nb = wp.shape[0] // W, wp.shape[1] // W
    schedules = KT.SCHEDULES if W >= 64 else (None,)
    if W >= 64:
        P = KTR.table_split_blocks(G, nb, W)
        if P < 2:
            raise AssertionError(f"K1 {case}: the split gives P = {P}, no run boundary")
        case = f"{case} P={P}"
    for layout in KT.LAYOUTS:
        want = KT.butterfly_table_torch(wp, W, layout)
        got = {s: KT._butterfly_table(wp, W, layout, schedule=s) for s in schedules}
        for s, t in got.items():
            a, b = (rows_to_blocks(t, W), rows_to_blocks(want, W)) if layout == "rows" \
                else (t, want)
            tally.table("butterfly_table", f"{case} {layout} {s or ''}", a, b, W, exact)
        if W >= 64:
            tally.same("butterfly_table", f"{case} {layout} split vs serial",
                       got["split"], got["serial"])
            tally.same("butterfly_table", f"{case} {layout} rule vs serial",
                       KT.butterfly_table_cuda(wp, W, layout), got["serial"])


def check_walk(tally, case, wts, run, W, u, u4, exact):
    """K3 on the card's running sums ``run`` (K2), S = 1 and 4: against
    its plain version on the plain running sums (ties only on real
    weights), against the plain walk on ``run`` and against K4's draw on
    the same uniforms (both bit for bit: the group walk makes the adds of
    one warp's walk)."""
    B, Kc = wts.shape
    _, run_p = bops.build_block_sums(wts, W=W, impl="torch")
    for S, uu in ((1, u), (4, u4)):
        a = bops.butterfly_sample_from_sums(wts, run, uu, K=Kc, W=W)
        b = bops.butterfly_sample_from_sums(wts, run_p, uu, K=Kc, W=W, impl="torch")
        tally.weights("walk", f"{case} S={S}", a, b, wts.float(), uu, exact)
        tally.same("walk", f"{case} S={S} vs plain walk",
                   a, bops.butterfly_sample_from_sums(wts, run, uu, K=Kc, W=W, impl="torch"))
    rows = torch.arange(B, dtype=torch.int32, device=wts.device)
    tally.same("walk", f"{case} vs K4", KB.walk(wts, run, u, rows, W), KB.fused_draw(wts, u, W))


def check_blocksums_layouts(tally, case, wts, W, u, exact: bool):
    """K2 in each layout against its plain version (the rule's pick among
    them, at every shape the main paths give K2), its split layout
    against its warp layout (bit for bit: the same adds), and K3 on the
    split's running sums against K4 on the same uniforms."""
    nb = KB.num_blocks(wts.shape[1], W)
    split = KB._blocksums(wts, W, nb, layout="split")
    warp = KB._blocksums(wts, W, nb, layout="warp")
    plain = KB.blocksums_torch(wts, W, nb)
    for layout, run in (("split", split), ("warp", warp)):
        tally.running("blocksums", f"{case} {layout}", run, plain, exact)
    tally.same("blocksums", f"{case} split vs warp", split, warp)
    rows = torch.arange(wts.shape[0], dtype=torch.int32, device=wts.device)
    tally.same("walk", f"{case} on K2 split sums vs K4", KB.walk(wts, split, u, rows, W),
               KB.fused_draw(wts, u, W))


def phase_given_kernels(corpus, dev, seed: int, tally, inputs):
    """K1-K4 against their plain versions on the chunk's given weights."""
    d, w, u, u4 = inputs
    K, V, C = CONFIG.K, corpus.vocab_size, 256
    B = d.numel()
    g = torch.Generator(device=dev).manual_seed(seed + 2)
    log(f"phase 2b: given-weight kernels vs plain at B={B} x K={K}")
    for W in (32, 16):
        for kind in ("int", "dirichlet"):
            exact = kind == "int"
            wts = chunk_weights(*factors(kind, C, V, K, g, dev), d, w)
            case = f"W={W} {kind}"
            check_table(tally, case, wts, W, exact)
            plain = bops.butterfly_sample(wts, u, W=W, impl="torch")
            tally.weights("fused_draw", case, bops.butterfly_sample(wts, u, W=W, route="fused"),
                          plain, wts, u, exact)
            two = bops.butterfly_sample(wts, u, W=W, route="two_pass")
            tally.weights("walk", case + " two-pass route", two, plain, wts, u, exact)
            _, run = bops.build_block_sums(wts, W=W)
            _, run_p = bops.build_block_sums(wts, W=W, impl="torch")
            tally.running("blocksums", case, run, run_p, exact)
            check_walk(tally, case, wts, run, W, u, u4, exact)
            check_blocksums_layouts(tally, case, wts, W, u, exact)
    # K3 (W / 4 lanes per draw) at the other widths, and at K = 239 (ncols
    # % 4 != 0: the four-loads-a-lane instantiation)
    for W in (8, 64, 128):
        for kind in ("int", "dirichlet"):
            wts = chunk_weights(*factors(kind, C, V, K, g, dev), d, w)
            check_walk(tally, f"W={W} {kind}", wts, bops.build_block_sums(wts, W=W)[1], W,
                       u, u4, kind == "int")
            check_blocksums_layouts(tally, f"W={W} {kind}", wts, W, u, kind == "int")
    wt = chunk_weights(*factors("dirichlet", C, V, K, g, dev), d, w)[:, :K - 1].contiguous()
    if KB.walk_vector_loads(wt):
        raise AssertionError("K = 239 should take the four-loads-a-lane walk")
    check_walk(tally, f"K={K - 1} W=16 dirichlet", wt, bops.build_block_sums(wt, W=16)[1],
               16, u, u4, False)
    check_blocksums_layouts(tally, f"K={K - 1} W=16 dirichlet", wt, 16, u, False)
    # K2 at vocabulary widths, where its rule takes the split layout
    for B2, K2, W2, dtype in ((DECODE_B, gemma2_9b.VOCAB_SIZE, 128, torch.float32),
                              (8, 32000, 128, torch.float32), (DECODE_B, 4096, 64,
                                                               torch.float32),
                              (DECODE_B, gemma2_9b.VOCAB_SIZE, 128, torch.bfloat16),
                              (DECODE_B, 32003, 128, torch.float32)):
        wv = trunc_weights("softmax", B2, K2, g, dev, zero_rows=(0, B2 - 1)).to(dtype)
        check_blocksums_layouts(tally, f"({B2},{K2}) W={W2} {str(dtype)[6:]}", wv, W2,
                                torch.rand(B2, generator=g, device=dev), False)
    for W in (8, 4, 64, 128):
        check_table(tally, f"W={W} int", chunk_weights(*factors("int", C, V, K, g, dev), d, w),
                    W, True)
    for W in (64, 128):
        check_table(tally, f"W={W} dirichlet", chunk_weights(
            *factors("dirichlet", C, V, K, g, dev), d, w), W, False)
    # bf16 weights (the integer products are integers in bf16 too)
    wb = chunk_weights(*factors("int", C, V, K, g, dev), d, w).to(torch.bfloat16)
    for W in (16, 64, 128):
        check_table(tally, f"W={W} bf16", wb, W, True)
    # K1 at W = 128 on the butterfly state's (128, 256000): integers below
    # 50 (every running sum below 2**24, exact), peaked softmax, bf16
    Kv = gemma2_9b.VOCAB_SIZE
    for kind, wv in (("int", torch.randint(1, 50, (128, Kv), generator=g, device=dev).float()),
                     ("softmax", trunc_weights("softmax", 128, Kv, g, dev)),
                     ("softmax bf16", trunc_weights("softmax", 128, Kv, g, dev)
                      .to(torch.bfloat16))):
        check_table(tally, f"(128,{Kv}) W=128 {kind}", wv, 128, kind == "int")
    for route in ("fused", "two_pass"):
        tally.weights("fused_draw" if route == "fused" else "walk", f"W=16 bf16 {route}",
                      bops.butterfly_sample(wb, u, W=16, route=route),
                      bops.butterfly_sample(wb, u, W=16, impl="torch"), wb.float(), u, True)
    check_walk(tally, "W=16 bf16", wb, bops.build_block_sums(wb, W=16)[1], 16, u, u4, True)
    check_blocksums_layouts(tally, "W=16 bf16", wb, 16, u, True)
    # the sweep's last chunk: padded with all-zero rows
    th, ph = factors("dirichlet", corpus.docs.shape[0], V, K, g, dev)
    docs = torch.as_tensor(corpus.docs, device=dev)
    *_, (start, end, th_c, docs_p) = gibbs._chunks(th, docs, C)
    wz = chunk_weights(th_c, ph, d, docs_p.reshape(-1))
    zero = d >= end - start
    for route in ("fused", "two_pass"):
        a = bops.butterfly_sample(wz, u, W=16, route=route)
        b = bops.butterfly_sample(wz, u, W=16, impl="torch")
        tally.weights("fused_draw" if route == "fused" else "walk", f"W=16 zero rows {route}",
                      a, b, wz, u, False)
        if int(a.min()) < 0 or int(a.max()) >= K or not bool((a[zero] == K - 1).all()):
            raise AssertionError("zero-row chunk drew outside [0, K) or not K-1")
    check_walk(tally, "W=16 zero rows", wz, bops.build_block_sums(wz, W=16)[1], 16, u, u4,
               False)
    check_blocksums_layouts(tally, "W=16 zero rows", wz, 16, u, False)
    check_table(tally, "W=16 zero rows", wz, 16, False)
    # a large K: the port's switch picks the route; the forced two-pass
    # route must agree with it
    Kl, Bl = 32000, 64
    Wl = runtime.default_w(Kl)
    nbl = KB.num_blocks(Kl, Wl)
    wl = torch._standard_gamma(torch.full((Bl, Kl), 0.3, device=dev), generator=g)
    ul = torch.rand(Bl, generator=g, device=dev)
    route = "fused" if KB.fused_fits(nbl, Wl) else "two_pass"
    log(f"  K={Kl} B={Bl} W={Wl}: the switch picks the {route} route")
    a = bops.butterfly_sample(wl, ul, W=Wl)
    tally.weights("fused_draw" if route == "fused" else "walk", f"K={Kl} W={Wl} {route}",
                  a, bops.butterfly_sample(wl, ul, W=Wl, impl="torch"), wl, ul, False)
    if not torch.equal(a, bops.butterfly_sample(wl, ul, W=Wl, route="two_pass")):
        raise AssertionError(f"K={Kl}: the fused and two-pass routes disagree")
    if not torch.equal(bops.butterfly_sample(wts, u, W=16, route="fused"),
                       bops.butterfly_sample(wts, u, W=16, route="two_pass")):
        raise AssertionError("the fused and two-pass routes disagree on the chunk")
    return tally


def bounds(name, th, ph, d, w, out_idx, W, nb, S=1):
    """Least bytes / flops for one call on this run's data (each input
    row read once, each output written once) -> (bound_ms, bound_by)."""
    K = th.shape[1]
    el = th.element_size()
    ids = d.numel() * 4 * 2
    if name == "lda_walk":
        blk = (out_idx.long().reshape(-1) // W)
        dd, ww = d.long().repeat(S), w.long().repeat(S)
        tb = torch.unique(dd * nb + blk).numel() * W * el
        pb = torch.unique(ww * nb + blk).numel() * W * el
        nbytes = tb + pb + d.numel() * nb * 4 + S * d.numel() * (4 + 4 * 3 + 4)
        flops = S * d.numel() * (3 * W + nb)
    else:
        rows = (torch.unique(d).numel() + torch.unique(w).numel()) * K * el
        outb = d.numel() * (nb * 4 if name == "lda_blocksums" else 4)
        ub = d.numel() * 4 if name == "lda_fused_draw" else 0
        nbytes = rows + ids + ub + outb
        flops = d.numel() * 2 * K
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_kernels(calls):
    """CUDA-event times of each kernel (the faster of two runs, taken
    around its plain version's), its plain version and, where given, its
    one-call library counterpart, with the bound for this call's work.
    ``calls``: name -> (kernel, plain, library or None, bound(out))."""
    out = {}
    for name, (kern, plain, lib, bound) in calls.items():
        ms = cuda_ms(kern)
        pms = cuda_ms(plain, reps=5, warmup=1)
        lms = cuda_ms(lib) if lib else None
        ms2 = cuda_ms(kern)
        bms, by = bound(kern())
        out[name] = {"ms": min(ms, ms2), "plain_ms": pms, "bound_ms": bms,
                     "bound_by": by, "library_ms": lms}
        log(f"  {name:15s} kernel {ms:.4f}/{ms2:.4f} ms  plain {pms:.4f} ms  "
            f"library {lms} ms  bound {bms * 1e3:.2f} us ({by})")
    return out


def phase_timing(corpus, dev, seed, inputs):
    """K6-K8 at the lda_kernel path's W=32 shapes (Dirichlet factors);
    K7 with S=4 draws per sample."""
    d, w, u, u4 = inputs
    K, V, C, W = CONFIG.K, corpus.vocab_size, 256, 32
    nb = -(-K // W)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    th, ph = factors("dirichlet", C, V, K, g, dev)
    Bt = d.numel()
    S = 4
    run = KL.lda_blocksums(th, ph, d, w, W, nb)
    rows4 = torch.arange(Bt, dtype=torch.int32, device=dev).repeat(S)
    d4, w4, uf = d.repeat(S), w.repeat(S), u4.reshape(-1).contiguous()

    def bound(name, s=1):
        return lambda idx: bounds(name, th, ph, d, w, idx, W, nb, S=s)

    dl, wl = d.long(), w.long()

    def product():
        return th[dl] * ph[wl]

    return time_kernels({
        "lda_fused_draw": (lambda: KL.lda_fused_draw(th, ph, d, w, u, W),
                           lambda: KL.lda_fused_draw_torch(th, ph, d, w, u, W),
                           searchsorted_library(product, u), bound("lda_fused_draw")),
        "lda_blocksums": (lambda: KL.lda_blocksums(th, ph, d, w, W, nb),
                          lambda: KL.lda_blocksums_torch(th, ph, d, w, W, nb),
                          k6_library(th, ph, d, w, W, nb),
                          bound("lda_blocksums")),
        "lda_walk": (lambda: KL.lda_walk(th, ph, run, uf, rows4, d4, w4, W),
                     lambda: KL.lda_walk_torch(th, ph, run, uf, rows4, d4, w4, W),
                     searchsorted_library(product, u4.t().contiguous()),
                     bound("lda_walk", S)),
    })


def k6_library(th, ph, d, w, W, nb):
    """K6's library yardstick, one PyTorch expression (never called by the
    port): the gathered products padded to nb * W columns, W-block sums,
    cumsum; the (Bt, K) product is formed."""
    dl, wl = d.long(), w.long()
    pad = nb * W - th.shape[1]
    return lambda: torch.nn.functional.pad(th[dl] * ph[wl], (0, pad)).view(
        dl.numel(), nb, W).sum(-1).cumsum(1)


def searchsorted_library(weights, u):
    """The draws' library yardstick, one PyTorch expression (never called by
    the port): each row's running sum, then the index of u x its total in
    it (``torch.searchsorted``), the index the kernels draw from the same
    uniforms.  ``weights`` makes the (B, K) weights inside the call (a
    gathered product, a mask); ``u`` is (B,) or (B, S)."""
    def call():
        cs = torch.cumsum(weights(), dim=-1)
        q = u * cs[:, -1:] if u.dim() == 2 else (u * cs[:, -1])[:, None]
        return torch.searchsorted(cs, q, right=True)
    return call


def given_bounds(name, wts, W, nb, out_idx, rows):
    """Least bytes / flops of one given-weights kernel call on this run's
    data -> (bound_ms, bound_by).  Each input row read once, each output
    written once; K3 reads only the W-blocks and running rows it uses."""
    B, K = wts.shape
    el = wts.element_size()
    if name == "butterfly_table":
        nbytes = B * K * (el + 4)
        flops = B * K // 2 * (W.bit_length() - 1) + B * nb
    elif name == "blocksums":
        nbytes = B * K * el + B * nb * 4
        flops = B * K + B * nb
    elif name == "fused_draw":
        nbytes = B * K * el + B * 8
        flops = B * (K + nb + W + W.bit_length())
    else:  # walk: S draws per row through ``rows``
        r = rows.long()
        blk = out_idx.long() // W
        nbytes = (torch.unique(r * nb + blk).numel() * W * el
                  + torch.unique(r).numel() * nb * 4 + r.numel() * 12)
        flops = r.numel() * (nb + W + W.bit_length())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_given_timing(corpus, dev, seed, inputs):
    """K1-K4 at the butterfly and kernel sweeps' shapes: one chunk's
    Dirichlet weights, W=16 (the reference's default_w(240)); K3 with S=4
    draws per row.  K2's library counterpart is PyTorch's per-block sum
    then running sum."""
    d, w, u, u4 = inputs
    K, V, C, W = CONFIG.K, corpus.vocab_size, 256, 16
    nb = KB.num_blocks(K, W)
    g = torch.Generator(device=dev).manual_seed(seed + 3)
    wts = chunk_weights(*factors("dirichlet", C, V, K, g, dev), d, w)
    B, S = wts.shape[0], 4
    run = KB.blocksums(wts, W, nb)
    rows4 = torch.arange(B, dtype=torch.int32, device=dev).repeat(S)
    uf = u4.reshape(-1).contiguous()

    def bound(name):
        return lambda idx: given_bounds(name, wts, W, nb, idx, rows4)

    return time_kernels({
        "butterfly_table": (lambda: KT.butterfly_table_cuda(wts, W, "blocks"),
                            lambda: KT.butterfly_table_torch(wts, W, "blocks"), None,
                            bound("butterfly_table")),
        "blocksums": (lambda: KB.blocksums(wts, W, nb),
                      lambda: KB.blocksums_torch(wts, W, nb),
                      lambda: torch.cumsum(wts.view(B, nb, W).sum(-1), dim=1),
                      bound("blocksums")),
        "walk": (lambda: KB.walk(wts, run, uf, rows4, W),
                 lambda: KB.walk_torch(wts, run, uf, rows4, W),
                 searchsorted_library(lambda: wts, u4.t().contiguous()), bound("walk")),
        "fused_draw": (lambda: KB.fused_draw(wts, u, W),
                       lambda: KB.fused_draw_torch(wts, u, W),
                       searchsorted_library(lambda: wts, u), bound("fused_draw")),
    })


def sweep_seconds(state, corpus, method, W, n):
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = gibbs.gibbs_step(state, corpus, method=method, W=W, chunk=256)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return state, times


def check_path(path, counts, expect):
    """Fail unless each kernel of ``expect`` was launched exactly as often
    as expected on the path just run, and no other kernel was."""
    log(f"  launches on the {path} path: "
        f"{ {n: c for n, c in counts.items() if c} }")
    for name, n in expect.items():
        if counts[name] != n or n == 0:
            raise AssertionError(f"{path}: {name} launched {counts[name]}x, expected {n}x")
    extra = {n: c for n, c in counts.items() if c and n not in expect}
    if extra:
        raise AssertionError(f"{path}: unexpected launches {extra}")


def add_counts(total: dict, counts: dict) -> None:
    """Add the launch counts read after one path to the run's totals."""
    for name, n in counts.items():
        total[name] = total.get(name, 0) + n


def check_state(state, K, *zs):
    rows = state.theta.sum(dim=1)
    if not torch.allclose(rows, torch.ones_like(rows), atol=1e-4):
        raise AssertionError("theta rows do not sum to 1")
    for z in (state.z, *zs):
        if int(z.min()) < 0 or int(z.max()) >= K:
            raise AssertionError("a topic outside [0, K)")


def phase_main(corpus, dev, seed):
    K, M, chunk, W = CONFIG.K, corpus.docs.shape[0], 256, 32
    nchunks = -(-M // chunk)
    log(f"phase 3: main path, M={M} V={corpus.vocab_size} K={K} "
        f"tokens={corpus.total_words} maxN={corpus.docs.shape[1]} chunks={nchunks}")
    state = gibbs.init_state(seed, corpus, K, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    state, times = sweep_seconds(state, corpus, "lda_kernel", W, 3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    zs = gibbs.sample_z(state, corpus, num_samples=4, W=W, chunk=chunk)
    torch.cuda.synchronize()
    t_sample = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    check_path("lda_kernel", launches, {"lda_fused_draw": 3 * nchunks,
                                        "lda_blocksums": nchunks, "lda_walk": nchunks})
    check_state(state, K, zs)
    ppl = gibbs.perplexity(state, corpus)
    if not np.isfinite(ppl):
        raise AssertionError("perplexity is not finite")
    log(f"  seconds per sweep (lda_kernel, W={W}): {times}")
    log(f"  sample_z (4 draws/token): {t_sample:.4f} s   perplexity {ppl:.2f}")
    log(f"  peak device memory {peak / 2**30:.3f} GiB")
    return state, launches, {"sweep_s": times, "sample_z_s": t_sample,
                             "perplexity": ppl, "peak_bytes": peak,
                             "tokens": corpus.total_words}


def phase_table_paths(state, corpus, dev, seed):
    """The paths this slice brings, at the same scale, from the
    lda_kernel path's last state: 3 ``butterfly`` sweeps (K1 per chunk),
    3 ``kernel`` sweeps (K2 + K3 per chunk), then the given-weights entry
    points over every chunk (K4, then K2 + K3 with 4 draws per token)."""
    K, M, chunk = CONFIG.K, corpus.docs.shape[0], 256
    W = runtime.default_w(K)
    nchunks = -(-M // chunk)
    res, launches = {}, {}
    for method, expect in (("butterfly", {"butterfly_table": 3 * nchunks}),
                           ("kernel", {"blocksums": 3 * nchunks, "walk": 3 * nchunks})):
        torch.cuda.synchronize()
        reset_counts()
        state, times = sweep_seconds(state, corpus, method, None, 3)
        counts = read_counts()
        check_path(method, counts, expect)
        check_state(state, K)
        ppl = gibbs.perplexity(state, corpus)
        if not np.isfinite(ppl):
            raise AssertionError(f"{method}: perplexity is not finite")
        log(f"  seconds per sweep ({method}, W={W}): {times}   perplexity {ppl:.2f}")
        res[method] = {"sweep_s": times, "perplexity": ppl, "launches": counts}
        add_counts(launches, counts)
    # the given-weights entry points, one chunk's weights at a time
    docs = torch.as_tensor(corpus.docs, device=dev)
    maxN = docs.shape[1]
    z1 = torch.empty((M, maxN), dtype=torch.int32, device=dev)
    z4 = torch.empty((4, M, maxN), dtype=torch.int32, device=dev)
    pair = np.array([seed, 12345], np.uint32)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    for start, end, theta_c, docs_c in gibbs._chunks(state.theta, docs, chunk):
        C, N = docs_c.shape
        wts = (theta_c[:, None, :] * state.phi[docs_c.long()]).reshape(C * N, K)
        u = torch.rand(C * N, generator=state.key, device=dev)
        z1[start:end] = bops.butterfly_sample(wts, u, W=W).view(C, N)[: end - start]
        wp, run = bops.build_block_sums(wts, W=W)
        zs = bops.butterfly_sample_from_sums_rng(wp, run, pair, B=C * N, K=K, S=4,
                                                 row_offset=start * N, W=W)
        z4[:, start:end] = zs.view(4, C, N)[:, : end - start]
    torch.cuda.synchronize()
    t_given = time.perf_counter() - t0
    counts = read_counts()
    expect = {"fused_draw": nchunks, "blocksums": nchunks, "walk": nchunks}
    check_path("given-weights", counts, expect)
    check_state(state, K, z1, z4)
    log(f"  given-weights entry points over {nchunks} chunks (1 + 4 draws/token): "
        f"{t_given:.4f} s")
    res["given_weights"] = {"seconds": t_given, "launches": counts}
    add_counts(launches, counts)
    return state, launches, res


def phase_profile(state, corpus, method, W, label=None, **kw):
    """One more sweep of ``method`` under torch.profiler (after the
    counted runs): device time by kernel, the device's busy share and the
    trace's kernel count (S1's apart).  ``kw`` goes to ``gibbs_step`` (the
    sparse sweep's options).  Late in this script's process a trace loses
    some of its kernels (PERF.md §7): its busy share is a lower bound, and
    the sparse sweep is profiled in a fresh process
    (:func:`sparse_profile_fresh`)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state = gibbs.gibbs_step(state, corpus, method=method, W=W, chunk=256, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # kernels only: an aten op's row repeats the device time of its kernels
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                  reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    log(f"phase 3c: profiled {label or method} sweep wall {wall:.4f} s, device busy "
        f"{busy:.4f} s ({100 * busy / wall:.1f}%)")
    for us, n, key in rows[:10]:
        log(f"  {us / 1e3:9.3f} ms  x{n:<5d} {key[:90]}")
    return state, {"wall_s": wall, "device_busy_s": busy,
                   "launches": {"sparse_mh": sum(n for _, n, k in rows if "sparse_mh" in k),
                                "kernels": sum(n for _, n, _ in rows)},
                   "top": [{"ms": us / 1e3, "count": n, "name": key[:120]}
                           for us, n, key in rows[:10]]}


def phase_fig3(corpus, dev, seed):
    log("phase 3b: Figure-3 K-sweep (1 warm-up + 2 timed sweeps each, W=default_w(K)), "
        "printed only")
    rows = []
    for K in range(16, 241, 32):
        for method in ("lda_kernel", "butterfly", "kernel", "prefix"):
            state = gibbs.init_state(seed, corpus, K, device=dev)
            state, _ = sweep_seconds(state, corpus, method, None, 1)
            state, t = sweep_seconds(state, corpus, method, None, 2)
            row = {"K": K, "method": method, "sweep_s": t}
            rows.append(row)
            log("  fig3 " + json.dumps(row))
            del state
    return rows


def phase_planted(dev, seed):
    corpus = corpus_mod.synthesize_corpus(seed=0, M=96, V=120, K=8, avg_len=40, max_len=80)
    state = gibbs.init_state(seed, corpus, 8, device=dev)
    p0 = gibbs.perplexity(state, corpus)
    for _ in range(30):
        state = gibbs.gibbs_step(state, corpus, method="lda_kernel", W=8)
    p1 = gibbs.perplexity(state, corpus)
    log(f"phase 4: planted corpus perplexity {p0:.3f} -> {p1:.3f} after 30 sweeps")
    if not (np.isfinite(p1) and p1 < 0.6 * p0):
        raise AssertionError(f"planted corpus: perplexity {p0} -> {p1}, not below 0.6x")
    return {"p0": p0, "p1": p1}


# ---------------------------------------------------------------------------
# Truncated draws (K9, K11, K12), the alias assembly (K13) and the sampling API
# ---------------------------------------------------------------------------


def trunc_weights(kind: str, B: int, K: int, g: torch.Generator, dev, zero_rows=()):
    """(B, K) weights: integers in [1, 100) (every fp32 sum exact while the
    row total stays below 2**24) or a peaked softmax of N(0, 4^2) logits."""
    if kind == "int":
        w = torch.randint(1, 100, (B, K), generator=g, device=dev).float()
    else:
        z = 4.0 * torch.randn((B, K), generator=g, device=dev)
        w = torch.exp(z - z.max(dim=1, keepdim=True).values)
    for r in zero_rows:
        w[r] = 0
    return w.contiguous()


def trunc_params(kind: str, B: int, g: torch.Generator, dev) -> torch.Tensor:
    """(B, 3) [top_k, top_p, min_p]: gemma2-9b's (64, 0.95, 0) on every row,
    or per-row values with row r % 4 disabling top-k, top-p, min-p, or all
    three."""
    if kind == "uniform":
        s = gemma2_9b.SAMPLER
        return torch.tensor([[float(s.top_k), s.top_p, s.min_p]], device=dev).repeat(B, 1)
    k = torch.randint(1, 200, (B,), generator=g, device=dev).float()
    p = 0.5 + 0.5 * torch.rand((B,), generator=g, device=dev)
    m = 0.05 * torch.rand((B,), generator=g, device=dev)
    r = torch.arange(B, device=dev) % 4
    k = torch.where((r == 0) | (r == 3), 0.0, k)
    p = torch.where((r == 1) | (r == 3), 1.0, p)
    m = torch.where((r == 2) | (r == 3), 0.0, m)
    return torch.stack([k, p, m], dim=1).contiguous()


# (B, K, weights, params, dtype, all-zero rows) of the truncated-draw checks:
# (8, 256000) (the serve batch of the reference's ServeSpec.max_slots),
# (64, 256000), (64, 128256) (llama3-8b's vocabulary) and (24, 300)
TRUNC_CASES = [(8, 256000, "int", "uniform", torch.float32, (0, 5)),
               (64, 256000, "softmax", "uniform", torch.float32, ()),
               (64, 256000, "softmax", "hetero", torch.float32, (7,)),
               (64, 128256, "int", "hetero", torch.float32, ()),
               (64, 128256, "softmax", "uniform", torch.bfloat16, ()),
               (24, 300, "int", "hetero", torch.float32, (3,)),
               (24, 300, "softmax", "hetero", torch.float32, ())]
# widths of the edge rows: a row of K9's survivor list at most, rows staged
# in shared memory (32,000 and 56,000) and rows read from L2
EDGE_KS = (300, 32000, 56000, 100000)
# K11 against its exact-order plain model at B = 1, 8, 64, W = 32, 64, 128:
# widths whose nb is not a multiple of a block's run of W-blocks
K11_KS = (100003, 256000)


def trunc_edge_rows(K: int, g: torch.Generator, dev):
    """(10, K) weights and params of the threshold's edge rows: all equal;
    one live token; zeros from -inf logits; -0.0 entries; top-k > K;
    non-integer top-k with min-p; top-k off with top-p on (more survivors
    than K9's list holds once K > 2048); ties at tau_k beyond the list
    (2,548 columns at the row max); top-k 1; a plain softmax row."""
    z = 4.0 * torch.randn((10, K), generator=g, device=dev)
    w = torch.exp(z - z.max(dim=1, keepdim=True).values)
    w[0] = 0.25
    w[1] = 0.0
    w[1, K // 3] = 1.0
    zi = torch.where(torch.rand((K,), generator=g, device=dev) < 0.7, float("-inf"), z[2])
    zi[0] = 0.0
    w[2] = torch.exp(zi - zi.max())
    w[3] = torch.where(torch.rand((K,), generator=g, device=dev) < 0.5, -0.0, w[3])
    w[7, : min(K, KB._TRUNC_LIST_CAP + 500)] = 1.0
    prm = torch.tensor([[64, 0.95, 0], [64, 0.95, 0], [64, 0.9, 0], [64, 0.95, 0],
                        [K + 1, 0.95, 0], [2.5, 0.9, 0.01], [0, 0.9, 0], [64, 0.95, 0],
                        [1, 0.5, 0], [64, 0.95, 0]], dtype=torch.float32, device=dev)
    return w.contiguous(), prm


def phase_trunc_kernels(dev, seed: int, tally):
    """K9, K11 and K12 against their plain versions at TRUNC_CASES:
    integer and peaked-softmax weights, bf16, zero rows, gemma2-9b's and
    per-row params, both routes forced, K12 with S=1 and S=4 and in each
    layout (one warp, a group of W/4 lanes per draw) equal to the rule's
    pick bit for bit.  K9's radix
    select against its bisection body (``threshold="bisect"``), equal bit
    for bit, there and on the edge rows at EDGE_KS, with the row staged and
    read from L2; K11 against ``masked_blocksums_warp_order_torch``, equal
    bit for bit, there and at B = 1, 8, 64, W = 32, 64, 128."""
    g = torch.Generator(device=dev).manual_seed(seed + 5)
    log("phase 2d: truncated-draw kernels vs plain (K9, K11, K12)")
    for B, K, kind, pk, dtype, zero in TRUNC_CASES:
        W = runtime.default_w(K)
        nb = KB.num_blocks(K, W)
        w = trunc_weights(kind, B, K, g, dev, zero).to(dtype)
        prm = trunc_params(pk, B, g, dev)
        u = torch.rand(B, generator=g, device=dev)
        exact = kind == "int"
        case = f"({B},{K}) W={W} {kind} {pk} {str(dtype)[6:]}"
        a = KB.fused_trunc_draw(w, u, prm, W)
        b = KB.fused_trunc_draw_torch(w, u, prm, W)
        tally.trunc("fused_trunc_draw", case, a, b, w, u, prm, exact)
        tally.same("fused_trunc_draw", case + " radix vs bisect", a,
                   KB._fused_trunc_draw(w, u, prm, W, 32, None, threshold="bisect"))
        if zero and not bool((a[list(zero)].clamp(max=K - 1) == K - 1).all()):
            raise AssertionError(f"{case}: an all-zero row did not draw K-1")
        tau = tr.thresholds_from_params(w, prm).contiguous()
        run = KB.masked_blocksums(w, tau, W, nb)
        tally.running("masked_blocksums", case, run, KB.masked_blocksums_torch(w, tau, W, nb),
                      exact, rel_tol=(W + nb) * 2.0 ** -23)
        tally.same("masked_blocksums", case + " vs warp order", run,
                   masked_blocksums_warp_order_torch(w, tau, W, nb))
        wm = KB._mask(w.float(), tau)
        for S in (1, 4):
            us = torch.rand((S, B), generator=g, device=dev)
            rows = torch.arange(B, dtype=torch.int32, device=dev).repeat(S)
            uf = us.reshape(-1).contiguous()
            a = KB.walk_trunc(w, run, uf, tau, rows, W)
            tally.weights("walk_trunc", f"{case} S={S}", a,
                          KB.walk_trunc_torch(w, run, uf, tau, rows, W), wm, uf, exact)
            for layout in KB.WALK_TRUNC_LAYOUTS:
                tally.same("walk_trunc", f"{case} S={S} {layout} layout",
                           KB._walk_trunc(w, run, uf, tau, rows, W, layout=layout), a)
        # both routes forced through the entry point
        fused = bops.butterfly_sample_truncated(w, u, prm, W=W, route="fused")
        two = bops.butterfly_sample_truncated(w, u, prm, W=W, route="two_pass")
        tally.trunc("fused_trunc_draw", case + " fused vs two-pass", fused, two, w, u, prm,
                    exact)
        if int(fused.min()) < 0 or int(fused.max()) >= K:
            raise AssertionError(f"{case}: an index outside [0, K)")
    for K in EDGE_KS:
        W = runtime.default_w(K)
        w, prm = trunc_edge_rows(K, g, dev)
        u = torch.rand(w.shape[0], generator=g, device=dev)
        case = f"edge rows (10,{K}) W={W}"
        a = KB.fused_trunc_draw(w, u, prm, W)
        tally.trunc("fused_trunc_draw", case, a, KB.fused_trunc_draw_torch(w, u, prm, W), w,
                    u, prm, False)
        sources = (True, False) if KB.trunc_row_staged(K, KB.num_blocks(K, W), W) else (False,)
        for staged in sources:
            for thr in ("radix", "bisect"):
                tally.same("fused_trunc_draw", f"{case} staged={staged} {thr}", a,
                           KB._fused_trunc_draw(w, u, prm, W, 32, staged, threshold=thr))
    for B in (1, 8, 64):
        for W in (32, 64, 128):
            for K in K11_KS:
                w = trunc_weights("softmax", B, K, g, dev)
                tau = tr.thresholds_from_params(
                    w, trunc_params("uniform", B, g, dev)).contiguous()
                nb = KB.num_blocks(K, W)
                tally.same("masked_blocksums", f"({B},{K}) W={W} vs warp order",
                           KB.masked_blocksums(w, tau, W, nb),
                           masked_blocksums_warp_order_torch(w, tau, W, nb))
    return tally


def induced_mass_err(w, prob, alias) -> float:
    """max |mass - w / sum(w)| of a (prob, alias) table, in float64 on the
    card: mass[c] = (prob[c] + sum_{alias[k]=c} (1 - prob[k])) / K."""
    p = prob.double()
    K = p.shape[1]
    mass = p.clone().scatter_add_(1, alias.long(), 1.0 - p) / K
    wd = w.double()
    tot = wd.sum(dim=1, keepdim=True)
    target = torch.where(tot > 0, wd / tot.clamp(min=1e-300), torch.full_like(wd, 1.0 / K))
    return float((mass - target).abs().max())


def alias_inputs(w):
    """The device build's assembly inputs for (B, K) weights: partitioned
    scaled weights padded with s = 1 to the next power of two, light counts
    and merged ranks."""
    s_sorted, _order, _inv, nL = aops._partition(w)
    K = w.shape[1]
    Kp = aops._next_pow2(K)
    sp = torch.nn.functional.pad(s_sorted, (0, Kp - K), value=1.0).contiguous()
    return sp, nL, aops._merged_rank(sp, nL).contiguous()


def alias_edge_inputs(K: int, g: torch.Generator, dev):
    """K a power of two: a Dirichlet row, a zero-weight row, an all-light
    row (uniform weights: nL = Kp) and an all-pad row (s = 1, nL = 0)."""
    w = torch._standard_gamma(torch.full((3, K), 0.3, device=dev), generator=g)
    w[1] = 0.0
    w[2] = 1.0
    sp, nL, rank = alias_inputs(w)
    ones = torch.ones(1, K, device=dev)
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    return (torch.cat([sp, ones]).contiguous(), torch.cat([nL, zero]).contiguous(),
            torch.cat([rank, aops._merged_rank(ones, zero)]).contiguous())


def check_alias_layouts(tally, case, sp, nL, rank):
    """K13 in each layout that takes the shape against the forced block
    layout (the first port's kernel) and against its exact-order CPU model,
    prob and apos bit for bit."""
    B, Kp = sp.shape
    want = KA._alias_assemble(sp, nL, rank, layout="block")
    cpu = [t.cpu() for t in (sp, nL, rank)]
    for lay in KA.fitting_layouts(B, Kp):
        got = KA._alias_assemble(sp, nL, rank, layout=lay)
        if lay != "block":
            tally.same("alias_assemble", f"{case} {lay} prob vs block", got[0], want[0])
            tally.same("alias_assemble", f"{case} {lay} apos vs block", got[1], want[1])
        model = getattr(alias_ref, f"assemble_{lay}_order_torch")(*cpu)
        tally.same("alias_assemble", f"{case} {lay} prob vs model", got[0].cpu(), model[0])
        tally.same("alias_assemble", f"{case} {lay} apos vs model", got[1].cpu(), model[1])


def phase_alias_kernels(dev, seed: int, tally, phi):
    """K13 (the rule's layout) against its plain version at phi (V x K =
    37,286 x 240, Kp = 256) and at (64, 4096) and (64, 256000) (Kp =
    262,144) peaked-softmax weights; each layout against the block layout
    and its exact-order model there and on edge rows at Kp = 256 and 4,096;
    the induced mass of the full device build against the weights."""
    g = torch.Generator(device=dev).manual_seed(seed + 6)
    log("phase 2e: alias assembly (K13) vs plain, its layouts vs block and their models")
    for case, w in (("phi 37286x240", phi),
                    ("(64,4096) softmax", trunc_weights("softmax", 64, 4096, g, dev)),
                    (f"(64,{gemma2_9b.VOCAB_SIZE}) softmax",
                     trunc_weights("softmax", 64, gemma2_9b.VOCAB_SIZE, g, dev))):
        sp, nL, rank = alias_inputs(w)
        got = KA.alias_assemble(sp, nL, rank)
        tally.assemble("alias_assemble", case, got, KA.alias_assemble_torch(sp, nL, rank),
                       prob_tolerance(sp.shape[1]))
        check_alias_layouts(tally, case, sp, nL, rank)
        t = aops.build_alias_tables_device(w)
        err = induced_mass_err(w, t.prob, t.alias)
        log(f"  alias_device {case}: induced mass max_abs_err={err:.3g}")
        if err > 5e-6:
            raise AssertionError(f"alias_device {case}: induced mass off by {err}")
    for K in (256, 4096):
        check_alias_layouts(tally, f"edge rows Kp={K}", *alias_edge_inputs(K, g, dev))
    return tally


def trunc_bounds(name, w, W, nb, S=1):
    """Least bytes / operations of one truncated-draw kernel call on this
    run's data -> (bound_ms, bound_by).  K9: the weights, u and params read
    once and the draws written once; the function's operations (the max, a
    threshold select, the mask, the draw: a few per weight) take far less
    time than the bytes.  The kernel's own passes over a row (four digit
    histograms, the survivor list, the draw's block sums) are its
    algorithm's re-reads of data on the chip, not bytes the function must
    move."""
    B, K = w.shape
    el = w.element_size()
    if name == "fused_trunc_draw":
        nbytes = B * K * el + B * (4 + 12 + 4)
        flops = 4 * B * K
    elif name == "masked_blocksums":
        nbytes = B * K * el + B * 4 + B * nb * 4
        flops = 2 * B * K + B * nb
    else:  # walk_trunc: one running row and one W-block per draw
        nbytes = B * nb * 4 + S * B * (W * el + 4 * 4)
        flops = S * B * (nb + 3 * W)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_new_timing(dev, seed, phi):
    """K9 (forced fused), K11 and K12 (S=1) at (64, 256000), W = default_w;
    K9's radix select against its bisection body there, K9 with its
    stages switched off one by one, and K9 with the row staged and read
    from L2 at (64, 32000) and (64, 56000); K11 also at B = 8; K13 at phi (37,286 x 256)
    and at (64, 256000) (Kp = 262,144); K1 at (128, 256000), W=128 (the
    butterfly state of 64 rows, padded to a group of 128).  Library
    yardsticks: the sort-based truncated draw (several calls) for K9,
    where + view-sum + cumsum for K11."""
    g = torch.Generator(device=dev).manual_seed(seed + 7)
    B, K = DECODE_B, gemma2_9b.VOCAB_SIZE
    W = runtime.default_w(K)
    nb = KB.num_blocks(K, W)
    w = trunc_weights("softmax", B, K, g, dev)
    prm = trunc_params("uniform", B, g, dev)
    u = torch.rand(B, generator=g, device=dev)
    tau = tr.thresholds_from_params(w, prm).contiguous()
    run = KB.masked_blocksums(w, tau, W, nb)
    rows = torch.arange(B, dtype=torch.int32, device=dev)
    chain = (sampling.TopK(prm[:, 0]), sampling.TopP(prm[:, 1]))
    out = time_kernels({
        "fused_trunc_draw": (lambda: KB.fused_trunc_draw(w, u, prm, W),
                             lambda: KB.fused_trunc_draw_torch(w, u, prm, W),
                             lambda: sref.draw_truncated_sorted(w, u, chain),
                             lambda idx: trunc_bounds("fused_trunc_draw", w, W, nb)),
        "masked_blocksums": (lambda: KB.masked_blocksums(w, tau, W, nb),
                             lambda: KB.masked_blocksums_torch(w, tau, W, nb),
                             lambda: torch.cumsum(torch.where(w >= tau[:, None], w, 0.0)
                                                  .view(B, nb, W).sum(-1), dim=1),
                             lambda idx: trunc_bounds("masked_blocksums", w, W, nb)),
        "walk_trunc": (lambda: KB.walk_trunc(w, run, u, tau, rows, W),
                       lambda: KB.walk_trunc_torch(w, run, u, tau, rows, W),
                       searchsorted_library(lambda: torch.where(w >= tau[:, None], w, 0.0), u),
                       lambda idx: trunc_bounds("walk_trunc", w, W, nb)),
    })
    # the two routes end to end, and tau in PyTorch alone
    routes = {
        "fused (K9)": lambda: bops.butterfly_sample_truncated(w, u, prm, W=W, route="fused"),
        "two-pass (tau + K11 + K12)": lambda: bops.butterfly_sample_truncated(
            w, u, prm, W=W, route="two_pass"),
        "tau (plain PyTorch)": lambda: tr.thresholds_from_params(w, prm),
    }
    out["routes"] = {}
    for name, fn in routes.items():
        ms = cuda_ms(fn, reps=5, warmup=1)
        out["routes"][name] = ms
        log(f"  ({B},{K}) {name:28s} {ms:.4f} ms")
    # K9's two threshold bodies, in turns
    for thr in ("radix", "bisect", "bisect", "radix"):
        ms = cuda_ms(lambda: KB._fused_trunc_draw(w, u, prm, W, 32, None, threshold=thr))
        key = f"fused (K9) at ({B},{K}) {thr}"
        out["routes"].setdefault(key, []).append(ms)
        log(f"  {key} {ms:.4f} ms")
    # where K9's time goes: its stages switched off one by one
    for name, stages in (("no truncation", (0.0, 1.0, 0.0)), ("top-k only", (64.0, 1.0, 0.0)),
                         ("top-p only (full-row sums)", (0.0, 0.95, 0.0))):
        ps = torch.tensor([stages], device=dev).repeat(B, 1)
        ms = cuda_ms(lambda: KB.fused_trunc_draw(w, u, ps, W))
        out["routes"][f"fused (K9) at ({B},{K}) {name}"] = ms
        log(f"  fused (K9) at ({B},{K}) {name} {ms:.4f} ms")
    # and its two row sources where a row fits shared memory
    for Ks in (32000, 56000):
        ws = trunc_weights("softmax", B, Ks, g, dev)
        Ws = runtime.default_w(Ks)
        for staged, thr in ((True, "radix"), (False, "radix"), (True, "bisect"),
                            (False, "bisect"), (False, "bisect"), (True, "bisect"),
                            (False, "radix"), (True, "radix")):
            ms = cuda_ms(lambda: KB._fused_trunc_draw(ws, u, prm, Ws, 32, staged,
                                                      threshold=thr))
            key = f"fused (K9) at ({B},{Ks}) row {'staged' if staged else 'from L2'} {thr}"
            out["routes"].setdefault(key, []).append(ms)
            log(f"  {key} {ms:.4f} ms")
    # K11 at the serve batch of 8 rows, beside its plain version and yardstick
    w8, tau8 = w[:8].contiguous(), tau[:8].contiguous()
    out["masked_blocksums B=8"] = time_kernels({
        "masked_blocksums": (lambda: KB.masked_blocksums(w8, tau8, W, nb),
                             lambda: KB.masked_blocksums_torch(w8, tau8, W, nb),
                             lambda: torch.cumsum(torch.where(w8 >= tau8[:, None], w8, 0.0)
                                                  .view(8, nb, W).sum(-1), dim=1),
                             lambda idx: trunc_bounds("masked_blocksums", w8, W, nb)),
    })["masked_blocksums"]
    # K13 at phi
    out.update(time_alias(*alias_inputs(phi)))
    # K1 at W=128 on the butterfly state's (128, 256000): the rule's pick
    # (the split), and each schedule forced
    wt = trunc_weights("softmax", 128, K, g, dev)
    t1 = {"ms": cuda_ms(lambda: KT.butterfly_table_cuda(wt, 128, "blocks")),
          "device_ms": device_ms(lambda: KT.butterfly_table_cuda(wt, 128, "blocks")),
          "plain_ms": cuda_ms(lambda: KT.butterfly_table_torch(wt, 128, "blocks"), reps=3,
                              warmup=1),
          "bound_ms": 128 * K * 8 / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
          "schedule": KT.table_schedule(1, K // 128, 128)}
    for sched in KT.SCHEDULES:
        fn = lambda sched=sched: KT._butterfly_table(wt, 128, "blocks", schedule=sched)  # noqa: E731
        t1[f"{sched} ms"], t1[f"{sched} device_ms"] = cuda_ms(fn), device_ms(fn)
    log(f"  butterfly_table W=128 (128,{K}) kernel ({t1['schedule']}) {t1['ms']:.4f} ms "
        f"(device {_ms(t1['device_ms'])})  serial {t1['serial ms']:.4f} ms (device "
        f"{_ms(t1['serial device_ms'])})  plain {t1['plain_ms']:.4f} ms  bound "
        f"{t1['bound_ms'] * 1e3:.2f} us (bytes)")
    out["butterfly_table_w128"] = t1
    # K13 at the vocabulary's (64, 256000), Kp = 262,144
    out["alias_assemble_vocab"] = time_alias(*alias_inputs(w))["alias_assemble"]
    return out


def alias_bound(sp, nL):
    """K13's least time: the padded scaled weights and ranks read and prob
    and alias positions written, 16 bytes a column, and the light counts."""
    return (sp.numel() * 16 + nL.numel() * 4) / HBM_BYTES_PER_S * 1e3, "bytes"


def time_alias(sp, nL, rank):
    """K13 (the rule's layout) beside its plain version and bound, and its
    device time (the split's three kernels summed)."""
    out = time_kernels({
        "alias_assemble": (lambda: KA.alias_assemble(sp, nL, rank),
                           lambda: KA.alias_assemble_torch(sp, nL, rank), None,
                           lambda _: alias_bound(sp, nL)),
    })
    t = out["alias_assemble"]
    t["device_ms"] = device_ms(lambda: KA.alias_assemble(sp, nL, rank))
    t["layout"] = KA.alias_layout(*sp.shape)
    t["shape"] = list(sp.shape)
    log(f"  alias_assemble {tuple(sp.shape)} ({t['layout']}): device {_ms(t['device_ms'])}")
    return out


def step_seconds(fn, n: int):
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times


def phase_decode(dev, seed, steps: int = 20):
    """The decode main path: ``plan((64, V), method="kernel",
    transforms="kp").sample_logits(logits, generator, transforms=(TopK(64),
    TopP(0.95)))`` for ``steps`` steps at each of DECODE_VOCABS: gemma2-9b's
    params on every row, then per-row params (one token per row: K9 once
    per step), then gemma2-9b's params with num_samples=4 (four candidate
    tokens per row: K11 and K12 once per step).  Logits from --seed on the
    card; every drawn token is among its row's top-k logits."""
    g = torch.Generator(device=dev).manual_seed(seed + 8)
    res, launches = {}, {}
    spec = gemma2_9b.SAMPLER
    for V in DECODE_VOCABS:
        B = DECODE_B
        p = sampling.plan((B, V), method="kernel", transforms="kp")
        logits = 4.0 * torch.randn((B, V), generator=g, device=dev)
        ks = torch.randint(8, 128, (B,), generator=g, device=dev).float()
        ps = 0.8 + 0.2 * torch.rand((B,), generator=g, device=dev)
        gemma = (sampling.TopK(spec.top_k), sampling.TopP(spec.top_p))
        for name, chain, S in (("uniform", gemma, 1),
                               ("per-row", (sampling.TopK(ks), sampling.TopP(ps)), 1),
                               ("uniform S=4", gemma, 4)):
            toks = []
            torch.cuda.synchronize()
            reset_counts()
            times = step_seconds(lambda: toks.append(p.sample_logits(
                logits, g, num_samples=S, transforms=chain)), steps)
            counts = read_counts()
            route = "fused" if S == 1 else "two_pass"
            expect = ({"fused_trunc_draw": steps} if route == "fused"
                      else {"masked_blocksums": steps, "walk_trunc": steps})
            check_path(f"decode ({B},{V}) {name}", counts, expect)
            kk = torch.as_tensor(chain[0].k, device=dev).float().expand(B)
            kth = torch.gather(torch.sort(logits, dim=1, descending=True).values, 1,
                               (kk.long() - 1)[:, None])
            tok = torch.stack(toks).long().reshape(-1, B)
            if not bool((torch.gather(logits, 1, tok.T) >= kth).all()):
                raise AssertionError(f"decode ({B},{V}) {name}: a token outside its top-k")
            log(f"  decode ({B},{V}) {name} route={route}: seconds per step {times}")
            res[f"{V} {name}"] = {"route": route, "step_s": times, "launches": counts}
            add_counts(launches, counts)
    return launches, res


def phase_methods(dev, seed):
    """``sample_from_logits`` at (64, 256000) once per explicit method
    (``alias`` at (64, 4096): its pairing is K sequential steps per row);
    the butterfly Categorical at (64, 256000) against its plain table."""
    g = torch.Generator(device=dev).manual_seed(seed + 9)
    B, V = DECODE_B, gemma2_9b.VOCAB_SIZE
    logits = 4.0 * torch.randn((B, V), generator=g, device=dev)
    expects = {"butterfly": {"butterfly_table": 1}, "kernel": {"blocksums": 1, "walk": 1},
               "alias_device": {"alias_assemble": 1}}
    res, launches = {}, {}
    for m in api.METHODS[1:]:
        x = logits[:, :4096].contiguous() if m == "alias" else logits
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        idx = api.sample_from_logits(x, g, method=m)
        torch.cuda.synchronize()
        t = time.perf_counter() - t0
        counts = read_counts()
        check_path(f"sample_from_logits {m} {tuple(x.shape)}", counts,
                   expects.get(m, {}))
        if int(idx.min()) < 0 or int(idx.max()) >= x.shape[1]:
            raise AssertionError(f"{m}: an index outside [0, V)")
        log(f"  sample_from_logits {m:13s} {tuple(x.shape)}: {t:.4f} s")
        res[m] = {"shape": list(x.shape), "seconds": t, "launches": counts}
        add_counts(launches, counts)
    # Categorical(method="butterfly") at vocabulary width (K1 at W=128)
    w = sampling.logits_to_weights(logits[:, :V])
    reset_counts()
    dist = sampling.Categorical.from_weights(w, method="butterfly")
    u = torch.rand(B, generator=g, device=dev)
    got = dist.draw(u=u)
    counts = read_counts()
    check_path("Categorical butterfly (64,256000)", counts, {"butterfly_table": 1})
    add_counts(launches, counts)
    wp, _, _ = bfly._prep(w, dist.W, group_pad=True)
    plain_table = KT.butterfly_table_torch(wp, dist.W, "blocks")
    want = bfly.draw_butterfly_from_table(plain_table, u, W=dist.W, B=B, K=V)
    r = weight_ties(got, want, w, u)
    log(f"  Categorical butterfly W={dist.W} (64,{V}) vs plain table: {r}")
    if r["faults"]:
        raise AssertionError(f"butterfly Categorical disagrees with its plain version: {r}")
    res["butterfly_categorical"] = r
    return launches, res


def phase_alias_phi(dev, seed, phi):
    """``Categorical.from_weights(phi, method="alias_device")`` at the paper
    corpus' phi (37,286 x 240): K13 once, S=16 draws per row, the induced
    mass against the weights."""
    g = torch.Generator(device=dev).manual_seed(seed + 10)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    dist = sampling.Categorical.from_weights(phi, method="alias_device")
    z = dist.draw(generator=g, num_samples=16)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = read_counts()
    check_path("alias_device on phi", counts, {"alias_assemble": 1})
    err = induced_mass_err(phi, dist.state["prob"], dist.state["alias"])
    drawn = torch.gather(phi, 1, z.T.long())
    log(f"  alias_device phi {tuple(phi.shape)}: build + 16 draws/row {secs:.4f} s, "
        f"induced mass max_abs_err={err:.3g}")
    if err > 5e-6 or z.shape != (16, phi.shape[0]) or not bool((drawn > 0).all()):
        raise AssertionError("alias_device on phi: mass off or a zero-weight draw")
    return counts, {"seconds": secs, "mass_err": err}


def phase_gibbs_new(state, corpus):
    """One paper-scale sweep each with ``gumbel`` and ``alias``."""
    res = {}
    K = CONFIG.K
    for method in ("gumbel", "alias"):
        state, times = sweep_seconds(state, corpus, method, None, 1)
        check_state(state, K)
        ppl = gibbs.perplexity(state, corpus)
        if not np.isfinite(ppl):
            raise AssertionError(f"{method}: perplexity is not finite")
        log(f"  seconds per sweep ({method}): {times}   perplexity {ppl:.2f}")
        res[method] = {"sweep_s": times, "perplexity": ppl}
    return state, res


# ---------------------------------------------------------------------------
# The defaults (method="auto") and the autotune grid
# ---------------------------------------------------------------------------

# the kernels one build + draw of a method launches on the untruncated paths
AUTO_KERNELS = {"lda_kernel": ("lda_fused_draw",), "kernel": ("blocksums", "walk"),
                "butterfly": ("butterfly_table",), "alias_device": ("alias_assemble",)}


def auto_expect(method: str, n: int, S: int = 0) -> dict:
    """The launches of ``n`` calls of a path resolved to ``method`` (``S``
    > 0: a top-k/top-p decode with S tokens a row, where a ``kernel`` or
    ``kernel_trunc`` plan runs K9, or K11 + K12)."""
    if S and method in ("kernel", "kernel_trunc"):
        names = ("fused_trunc_draw",) if S == 1 else ("masked_blocksums", "walk_trunc")
    else:
        names = AUTO_KERNELS.get("kernel" if method == "kernel_trunc" else method, ())
    return {k: n for k in names}


def resolution(B: int, K: int, **kw) -> dict:
    """What ``auto`` resolves a card workload to (a hit on the plan's own
    bucket: the source is the cache entry's)."""
    from repro_torch import autotune

    r = autotune.get_tuner().resolve_full(B, K, backend="cuda", **kw)
    return {"method": r.method, "W": r.W, "tb": r.tb, "tk": r.tk, "source": r.source}


def _same(name: str, got: torch.Tensor, want: torch.Tensor) -> None:
    if not torch.equal(got, want):
        raise AssertionError(f"auto {name}: differs from its resolved method's draw "
                             f"({int((got != want).sum())} of {got.numel()})")


def _auto_path(name, res, counts, expect, seconds, explicit) -> dict:
    check_path(f"auto {name} -> {res['method']}", counts, expect)
    log(f"  auto {name}: {res}, {seconds}; explicit methods: {explicit}")
    return {"resolved": res, "seconds": seconds, "launches": counts, "explicit": explicit}


def phase_auto(state, corpus, dev, seed, main_res):
    """The lifted defaults at full width, each with the launch counts read
    around it and its draws equal to the explicit method it resolved to on
    the same random stream: the sweep (``gibbs_step`` at its default, 3
    sweeps, then one ``draw_z`` against the resolved method),
    ``sample_from_logits`` and ``plan(..., transforms="kp")`` at (64,
    256000) with one and four tokens a row, ``Categorical.from_weights(phi)``
    and 16 draws through ``sample_categorical(phi, g, dist_key="phi",
    draws=16)``, then phi changed in place and drawn again under the same
    key: the draw must come from a rebuilt table (the same with an explicit
    ``alias_device``, whose build launches K13 once a miss)."""
    from repro_torch import autotune

    K, M, chunk = CONFIG.K, corpus.docs.shape[0], 256
    maxN = corpus.docs.shape[1]
    nchunks = -(-M // chunk)
    res, launches = {}, {}
    decode, methods, alias_phi = main_res["api"]
    # the sweep: 3 sweeps at the default, then draw_z against the resolved method
    rz = resolution(chunk * maxN, K, has_key=False, factored=True)
    reset_counts()
    state, times = sweep_seconds(state, corpus, "auto", None, 3)
    counts = read_counts()
    explicit = {"lda_kernel (W=32)": main_res["sweep_s"],
                **{m: main_res["table_paths"][m]["sweep_s"] for m in ("butterfly", "kernel")}}
    res["gibbs_step"] = _auto_path("gibbs_step", rz, counts,
                                   auto_expect(rz["method"], 3 * nchunks), times, explicit)
    add_counts(launches, counts)
    check_state(state, K)
    g0 = state.key.get_state()
    za = gibbs.draw_z(state, corpus.docs)
    state.key.set_state(g0)
    _same("draw_z", za, gibbs.draw_z(state, corpus.docs, method=rz["method"], W=rz["W"]))
    # decode width: sample_from_logits and the truncated plan
    B, V = DECODE_B, gemma2_9b.VOCAB_SIZE
    g = torch.Generator(device=dev).manual_seed(seed + 14)
    logits = 4.0 * torch.randn((B, V), generator=g, device=dev)
    rl = resolution(B, V, has_key=True)
    g.manual_seed(seed + 15)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    tok = api.sample_from_logits(logits, g)
    torch.cuda.synchronize()
    t = time.perf_counter() - t0
    counts = read_counts()
    g.manual_seed(seed + 15)
    _same("sample_from_logits", tok,
          api.sample_from_logits(logits, g, method=rl["method"], W=rl["W"]))
    res["sample_from_logits"] = _auto_path(
        f"sample_from_logits ({B},{V})", rl, counts, auto_expect(rl["method"], 1), t,
        {m: r["seconds"] for m, r in methods.items()
         if isinstance(r, dict) and r.get("shape") == [B, V]})
    add_counts(launches, counts)
    spec = gemma2_9b.SAMPLER
    chain = (sampling.TopK(spec.top_k), sampling.TopP(spec.top_p))
    rt = resolution(B, V, has_key=True, transforms="kp")
    p = sampling.plan((B, V), transforms="kp")
    pe = sampling.plan((B, V), method=rt["method"], W=rt["W"], transforms="kp")
    for S in (1, 4):
        toks = []
        g.manual_seed(seed + 16)
        reset_counts()
        t = step_seconds(lambda: toks.append(p.sample_logits(
            logits, g, num_samples=S, transforms=chain)), 20)
        counts = read_counts()
        g.manual_seed(seed + 16)
        _same(f"plan kp S={S}", toks[0], pe.sample_logits(logits, g, num_samples=S,
                                                           transforms=chain))
        dec = decode.get(f"{V} uniform" + (" S=4" if S == 4 else ""), {})
        res[f"plan_kp_S{S}"] = _auto_path(
            f"plan((64, {V}), transforms='kp') S={S}", rt, counts,
            auto_expect(rt["method"], 20, S=S), t, {"kernel": dec.get("step_s")})
        add_counts(launches, counts)
    # phi: from_weights at the default, then 16 draws under dist_key
    phi = state.phi.clone()
    rp = resolution(*phi.shape, has_key=True)
    g.manual_seed(seed + 17)
    reset_counts()
    t0 = time.perf_counter()
    d = sampling.Categorical.from_weights(phi)
    za = d.draw(generator=g)
    torch.cuda.synchronize()
    t = time.perf_counter() - t0
    counts = read_counts()
    g.manual_seed(seed + 17)
    _same("Categorical.from_weights(phi)", za, sampling.Categorical.from_weights(
        phi, method=rp["method"], W=rp["W"]).draw(generator=g))
    res["from_weights_phi"] = _auto_path(
        f"Categorical.from_weights(phi {tuple(phi.shape)})", rp, counts,
        auto_expect(rp["method"], 1), t,
        {"alias_device (build + 16 draws)": alias_phi["seconds"]})
    add_counts(launches, counts)
    rk = resolution(*phi.shape, has_key=True, draws=16)
    for name, kw in (("auto", {}), ("alias_device", {"method": "alias_device"})):
        counts, res[f"dist_key_phi {name}"] = _dist_key_phi(state.phi.clone(), g, seed, rk
                                                            if not kw else None, **kw)
        add_counts(launches, counts)
    return state, launches, res


def _dist_key_phi(phi, g, seed, res, method="auto"):
    """16 draws through ``sample_categorical(phi, g, method=method,
    dist_key=..., draws=16)`` (a cached-table method builds once and hits
    15 times), equal to 16 draws from one fresh build; then ``phi``
    changed in place and one more draw under the same key, which must
    rebuild (a miss, the method's build launches again) and equal a fresh
    build's draw on the new weights."""
    from repro_torch import autotune

    m = res["method"] if method == "auto" else method
    W = res["W"] if method == "auto" else runtime.default_w(phi.shape[1])
    key = f"phi/{method}"
    cache = autotune.get_table_cache()
    cache.clear()
    cached = m in api._CACHED_KINDS
    g.manual_seed(seed + 18)
    reset_counts()
    t0 = time.perf_counter()
    z = torch.stack([api.sample_categorical(phi, g, method=method, dist_key=key, draws=16)
                     for _ in range(16)])
    torch.cuda.synchronize()
    t = time.perf_counter() - t0
    counts = read_counts()
    stats = cache.stats()
    if cached and (stats["misses"], stats["hits"]) != (1, 15):
        raise AssertionError(f"dist_key={key!r}: expected 1 build and 15 hits, got {stats}")
    g.manual_seed(seed + 18)
    fresh = sampling.Categorical.from_weights(phi, method=m, W=W)
    _same(f"dist_key {method}", z, torch.stack([fresh.draw(generator=g) for _ in range(16)]))
    out = _auto_path(f"sample_categorical(phi, method={method!r}, dist_key, draws=16)",
                     res or {"method": m, "W": W}, counts,
                     auto_expect(m, 1 if cached else 16), t, {})
    phi[:, : phi.shape[1] // 2].mul_(2.0)
    g.manual_seed(seed + 19)
    reset_counts()
    got = api.sample_categorical(phi, g, method=method, dist_key=key, draws=16)
    after_counts = read_counts()
    after = cache.stats()
    g.manual_seed(seed + 19)
    _same(f"dist_key {method} after an in-place change", got,
          sampling.Categorical.from_weights(phi, method=m, W=W).draw(generator=g))
    if cached and after["misses"] != stats["misses"] + 1:
        raise AssertionError(f"dist_key={key!r} after phi.mul_: no rebuild ({after})")
    check_path(f"dist_key {method} after phi.mul_", after_counts, auto_expect(m, 1))
    log(f"  dist_key={key!r} ({m}) after phi.mul_ in place: table cache {after}, "
        + ("a rebuild" if cached else f"{m} caches no table: built per call")
        + ", draws equal to a fresh build's")
    add_counts(counts, after_counts)
    out["rebuild"] = {"cache": after, "launches": after_counts}
    return counts, out


def auto_sharded(mesh, corpus, dev, seed):
    """``make_sharded_gibbs(mesh, 240, V)`` at its default on the world of
    one: one sweep, its launches, and its z and phi equal to the sweep of
    the method it resolved to."""
    from repro_torch.lda.distributed import make_sharded_gibbs

    K = CONFIG.K
    M, N = corpus.docs.shape
    r = resolution(M * N, K, has_key=False, factored=True)   # one shard: every document
    outs = []
    for kw in ({}, {"method": r["method"], "W": r["W"]}):
        place, step = make_sharded_gibbs(mesh, K, corpus.vocab_size, **kw)
        st, docs, mask = place(gibbs.init_state(seed, corpus, K, device=dev),
                               corpus.docs, corpus.mask)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        with _AllReduceCount() as c:
            st = step(st, docs, mask)
        torch.cuda.synchronize()
        outs.append((st, time.perf_counter() - t0, read_counts(), c.n))
    (sa, ta, counts, na), (se, te, _, _) = outs
    _same("make_sharded_gibbs z", sa.z.to_local(), se.z.to_local())
    _same("make_sharded_gibbs phi", sa.phi.to_local(), se.phi.to_local())
    if na != 1:
        raise AssertionError(f"auto distributed sweep: {na} all_reduce calls")
    return counts, _auto_path("make_sharded_gibbs(mesh, 240, V)", r, counts,
                              auto_expect(r["method"], 1), [ta],
                              {r["method"]: [te]})


GRID_BS = (64, 1024, 27392)
GRID_KS = (16, 64, 240, 1024, 4096, 32000, 256000)
GRID_MAX_BYTES = 512 * 2**20          # cells with B * K * 4 bytes up to this
GRID_TRUNC_MIN_K = 4096               # truncated ("kp") buckets from this K
# the PyTorch Vose build pairs K entries a row one step at a time
# (core/alias.py): above this K it would take minutes, so alias is left out
ALIAS_MAX_K = 4096
# one draws=64 bucket for each cached-table method: (method, B, K, has_key)
GRID_REUSE = (("alias", 1024, 1024, True), ("fenwick", 1024, 4096, False),
              ("alias_device", 64, 32000, True), ("radix_forest", 27392, 240, False))
# the sparse sweep's buckets at a corpus's token count (2**21 tokens, as a
# sweep of the paper's corpus draws 3.07 M): only the two candidates that
# form no (B, K) tensor are timed there; they anchor sparse_mh's byte term,
# which the small buckets (host-bound) leave to noise
GRID_SPARSE = ((2**21, 240), (2**21, 2048))
GRID_SPARSE_ONLY = ("lda_kernel", "sparse_mh")
MODEL_TARGET = 1.25                   # the model's pick within this of the winner
# the median of this many synchronised calls per candidate: a host-bound
# call's time varies up to 2x between runs on the H100 (PERF.md §6); alias,
# whose calls take 0.3-2.4 s (K sequential steps), is timed once
GRID_ITERS = 9


def grid_buckets():
    out = []
    for B in GRID_BS:
        for K in GRID_KS:
            if B * K * 4 > GRID_MAX_BYTES:
                continue
            out += [{"B": B, "K": K, "has_key": False}, {"B": B, "K": K, "has_key": True},
                    {"B": B, "K": K, "has_key": False, "factored": True}]
            if K >= GRID_TRUNC_MIN_K:
                out.append({"B": B, "K": K, "has_key": True, "transforms": "kp"})
    out += [{"B": B, "K": K, "has_key": hk, "draws": 64, "for": m}
            for m, B, K, hk in GRID_REUSE]
    out += [{"B": B, "K": K, "has_key": False, "factored": True, "only": GRID_SPARSE_ONLY}
            for B, K in GRID_SPARSE]
    return out


def _fit_nonneg(cols, t):
    """Coefficients >= 0 of the columns ``cols`` (each a value per point)
    that minimize the relative error sum(((cols . c) / t - 1) ** 2): the
    best least-squares fit over every subset of free coefficients."""
    A = np.stack([np.asarray(c, float) / t for c in cols], 1)
    best, n = None, A.shape[1]
    for mask in range(1, 1 << n):
        idx = [i for i in range(n) if mask >> i & 1]
        c, *_ = np.linalg.lstsq(A[:, idx], np.ones_like(t), rcond=None)
        if (c < 0).any():
            continue
        full = np.zeros(n)
        full[idx] = c
        err = float(((A @ full - 1) ** 2).sum())
        if best is None or err < best[0]:
            best = (err, full)
    return [float(v) for v in best[1]]


def fit_cuda(rows) -> dict:
    """The ``"cuda"`` entry's ``call_us``, ``eq_scale`` and ``row_ns``
    fitted from the grid's draws=1 timings at each method's model W: per
    method, its host time a call, a scale on its modelled bytes and its
    time per category of a row, over its own workload (plain, or the
    factored / truncated one where it serves only that); then the extra
    host time of its factored (``m|fac``) and truncated (``m|tr``) forms,
    the other terms held."""
    from repro_torch.autotune import cost_model as cm

    bp = cm.BACKENDS["cuda"]
    pts = {}
    for r in rows:
        if r["draws"] != 1:
            continue
        B, K, fac, tr = r["B"], r["K"], r["factored"], bool(r["transforms"])
        sp = r.get("sparse", False)
        W = cm.default_w(K)
        for name, us in r["timed"].items():
            m, w = name.split("@")
            if int(w) != W or us is None:
                continue
            eq = cm.method_cost_eq(m, K, W=W, backend="cuda", factored=fac, truncated=tr,
                                   sparse=sp)
            native = cm.FACTORED_METHODS + cm.SPARSE_METHODS
            form = ("tr" if tr and m not in cm.TRUNCATED_METHODS else
                    "fac" if fac and m not in native else "")
            pts.setdefault(m, {}).setdefault(form, []).append(
                (B * eq / (bp.bandwidth_gbps * 1e3), K / 1e3, us - bp.launch_us))
    call, scale, row = {}, {}, {}
    for m, forms in sorted(pts.items()):
        base = forms.get("") or forms.get("fac") or forms.get("tr")
        x, k, t = (np.array(v, float) for v in zip(*base))
        call[m], scale[m], row[m] = _fit_nonneg([np.ones_like(t), x, k], t)
        for form in ("fac", "tr"):
            if form in forms and forms[form] is not base:
                x, k, t = (np.array(v, float) for v in zip(*forms[form]))
                rest = call[m] + scale[m] * x + row[m] * k
                e = float(((1 - rest / t) / t).sum() / (1 / t ** 2).sum())
                call[f"{m}|{form}"] = max(e, 0.0)
    return {"call_us": {k: round(v, 1) for k, v in call.items()},
            "eq_scale": {k: round(v, 3) for k, v in scale.items()},
            "row_ns": {k: round(v, 3) for k, v in row.items()}}


def phase_grid():
    """Phase 5b: every candidate timed per bucket of the grid
    (``measure_candidates``, the timing of measure mode: the host clock
    around each call, synchronised; the median of ``GRID_ITERS`` calls),
    the measured winner against the cost model's pick with the committed
    ``"cuda"`` constants, the ratio of the pick's measured time to the
    winner's, and :func:`fit_cuda`'s refit from this run."""
    from repro_torch.autotune import cost_model as cm
    from repro_torch.autotune import tuner as tu
    from repro_torch.autotune.cache import bucket_key

    t_all = time.perf_counter()
    rows, misses = [], []
    log(f"phase 5b: autotune grid, B in {GRID_BS} x K in {GRID_KS} (B*K*4 <= "
        f"{GRID_MAX_BYTES} bytes), plain / keyed / factored (with sparse_mh: |sp), "
        f"'kp' from K = {GRID_TRUNC_MIN_K}, draws=64 buckets {GRID_REUSE}, sparse "
        f"buckets {GRID_SPARSE} ({GRID_SPARSE_ONLY} only); alias left out above "
        f"K = {ALIAS_MAX_K} (resolve_full(candidates=...)): its PyTorch Vose build "
        "takes K sequential steps a row")
    for b in grid_buckets():
        B, K, hk = b["B"], b["K"], b["has_key"]
        fac, sig, d = b.get("factored", False), b.get("transforms", ""), b.get("draws", 1)
        # the factored buckets are the LDA z-draw's: sparse_mh competes (|sp)
        sp = fac
        cands = tu.candidate_methods(B, K, "cuda", hk, factored=fac, transforms=sig,
                                     sparse=sp)
        left_out = [c for c in cands if (c == "alias" and K > ALIAS_MAX_K)
                    or c not in b.get("only", cands)]
        cands = tuple(c for c in cands if c not in left_out)
        t0 = time.perf_counter()
        timed = {}
        for group, iters in ((tuple(c for c in cands if c != "alias"), GRID_ITERS),
                             (tuple(c for c in cands if c == "alias"), 1)):
            timed.update(tu.measure_candidates(group, B, K, factored=fac,
                                               truncated=bool(sig), sparse=sp,
                                               device="cuda", iters=iters))
        timed = {k: timed[k] for c in cands for k in timed if k[0] == c}  # candidate order
        wm, wW, wus = tu.measured_winner(timed, K, draws=d, backend="cuda")
        pm, pW, pred = cm.choose(cands, B, K, draws=d, backend="cuda", factored=fac,
                                 truncated=bool(sig), sparse=sp)
        raw = timed.get((pm, pW))
        pick = (float("inf") if raw is None
                else tu.amortized_us(raw, pm, K, pW, draws=d, backend="cuda"))
        ratio = pick / wus
        key = bucket_key("cuda", B, K, d, "float32", has_key=hk, factored=fac,
                         transforms=sig, sparse=sp)
        row = {"bucket": key, "B": B, "K": K, "draws": d, "has_key": hk, "factored": fac,
               "transforms": sig, "sparse": sp, "winner": [wm, wW, wus], "pick": [pm, pW, pick],
               "predicted_us": pred, "ratio": ratio, "left_out": left_out,
               "seconds": time.perf_counter() - t0,
               "timed": {f"{m}@{W}": us for (m, W), us in timed.items()}}
        rows.append(row)
        flag = "" if ratio <= MODEL_TARGET else f"   MISS (> {MODEL_TARGET}x)"
        log(f"  grid {key}: winner {wm} W={wW} {wus:.1f} us; model {pm} W={pW} "
            f"measured {pick:.1f} us (predicted {pred:.1f}); ratio {ratio:.3f}{flag}")
        if ratio > MODEL_TARGET:
            misses.append(key)
    secs = time.perf_counter() - t_all
    log(f"  grid: {len(rows)} buckets in {secs:.1f} s; model pick within "
        f"{MODEL_TARGET}x of the winner in {len(rows) - len(misses)}; misses {misses}")
    fit = fit_cuda(rows)
    log(f"  grid: the committed 'cuda' constants {cm.BACKENDS['cuda']}")
    log(f"  grid: refit from this run {json.dumps(fit)}")
    return {"rows": rows, "misses": misses, "seconds": secs,
            "constants": repr(cm.BACKENDS["cuda"]), "refit": fit}


# ---------------------------------------------------------------------------
# The seeded draws (K5, K10) and the sharded paths
# ---------------------------------------------------------------------------

SEED_PAIR = np.array([0x12345678, 0x9ABCDEF0], np.uint32)


def _seed2(dev):
    """The seeded draws' folded seed (fold(seed, TAG_U, 0)), on the host and
    on the card."""
    s = rng.fold(rng.seed_from_key(SEED_PAIR), rng.TAG_U, 0)
    return s, s.to(dev)


def phase_seeded_kernels(corpus, dev, seed: int, tally, inputs):
    """K5 and K10 against their plain versions at the cases of K4 and K9,
    and against K4 / K9 fed ``rng.row_uniforms`` (equal bit for bit: one
    body, the same uniforms); row offsets that wrap at 2**32; both routes
    forced; ``hw=True`` (Philox) twice and against its plain version; the
    device cipher against ``rng.row_uniforms`` over 2**21 counters, half
    past the wrap."""
    d, w, _u, _u4 = inputs
    K, V, C = CONFIG.K, corpus.vocab_size, 256
    g = torch.Generator(device=dev).manual_seed(seed + 11)
    s2, s2d = _seed2(dev)
    log("phase 2f: seeded draws (K5, K10) vs plain and vs K4 / K9 on row_uniforms")
    n = 1 << 21
    r0 = 2**32 - n // 2
    got = KB.threefry_uniforms(s2, r0, n, dev)
    bad = int((got != rng.row_uniforms(s2d, r0, n)).sum())
    log(f"  threefry_uniforms: {n} counters from {r0} (wrapping at 2**32): {bad} differ")
    if bad:
        raise AssertionError("the device Threefry disagrees with rng.row_uniforms")

    def k5_case(case, wts, W, r0, exact):
        B = wts.shape[0]
        uu = rng.row_uniforms(s2d, r0, B)
        a = KB.fused_draw_rng(wts, s2, r0, W)
        if not torch.equal(a, KB.fused_draw(wts, uu, W)):
            raise AssertionError(f"K5 differs from K4 on the same uniforms: {case}")
        for layout in KB.LAYOUTS:  # each layout equals the one the rule picks
            tally.same("fused_draw_rng", f"{case} {layout}",
                       KB._fused_draw_rng(wts, s2, r0, W, layout=layout), a)
            tally.same("fused_draw", f"{case} {layout}",
                       KB._fused_draw(wts, uu, W, layout=layout), a)
        tally.weights("fused_draw_rng", case, a, KB.fused_draw_rng_torch(wts, s2, r0, W),
                      wts.float(), uu, exact)
        two = bops.butterfly_sample_rng(wts, SEED_PAIR, row_offset=r0, W=W, route="two_pass")
        if not torch.equal(a.clamp(max=wts.shape[1] - 1), two):
            raise AssertionError(f"K5: the fused and two-pass routes disagree: {case}")

    for W in (32, 16):
        for kind in ("int", "dirichlet"):
            wts = chunk_weights(*factors(kind, C, V, K, g, dev), d, w)
            k5_case(f"chunk W={W} {kind}", wts, W, 0, kind == "int")
            k5_case(f"chunk W={W} {kind} wrap", wts, W, 2**32 - wts.shape[0] // 2,
                    kind == "int")
    wb = chunk_weights(*factors("int", C, V, K, g, dev), d, w).to(torch.bfloat16)
    k5_case("chunk W=16 bf16", wb, 16, 12345, True)
    th, ph = factors("dirichlet", corpus.docs.shape[0], V, K, g, dev)
    *_, (start, end, th_c, docs_p) = gibbs._chunks(th, torch.as_tensor(corpus.docs,
                                                                       device=dev), C)
    wz = chunk_weights(th_c, ph, d, docs_p.reshape(-1))
    k5_case("chunk W=16 zero rows", wz, 16, 7, False)
    wv = trunc_weights("softmax", DECODE_B, gemma2_9b.VOCAB_SIZE, g, dev)
    k5_case(f"({DECODE_B},{gemma2_9b.VOCAB_SIZE}) W=128 softmax", wv, 128, 2**32 - 3, False)
    wi = trunc_weights("int", DECODE_B, gemma2_9b.VOCAB_SIZE, g, dev)
    k5_case(f"({DECODE_B},{gemma2_9b.VOCAB_SIZE}) W=128 int", wi, 128, 99, True)
    for B, Kv in ((8, gemma2_9b.VOCAB_SIZE), (DECODE_B, 32000)):
        k5_case(f"({B},{Kv}) W=128 softmax", trunc_weights("softmax", B, Kv, g, dev), 128,
                2**32 - B // 2, False)
    # hw=True: Philox in the kernel
    a = KB.fused_draw_rng(wv, s2, 5, 128, hw=True)
    if not torch.equal(a, KB.fused_draw_rng(wv, s2, 5, 128, hw=True)):
        raise AssertionError("K5 hw=True: one seed, two different draws")
    for layout in KB.LAYOUTS:
        tally.same("fused_draw_rng", f"hw=True (Philox) {layout}",
                   KB._fused_draw_rng(wv, s2, 5, 128, hw=True, layout=layout), a)
    tally.weights("fused_draw_rng", "hw=True (Philox) softmax", a,
                  KB.fused_draw_rng_torch(wv, s2, 5, 128, hw=True), wv,
                  rng.philox_row_uniforms(s2d, 5, DECODE_B), False)
    # K10 at K9's cases
    for i, (B, Kc, kind, pk, dtype, zero) in enumerate(TRUNC_CASES):
        W = runtime.default_w(Kc)
        wt = trunc_weights(kind, B, Kc, g, dev, zero).to(dtype)
        prm = trunc_params(pk, B, g, dev)
        r0 = 2**32 - B // 2 if i % 2 else 1000 * i
        uu = rng.row_uniforms(s2d, r0, B)
        exact = kind == "int"
        case = f"({B},{Kc}) W={W} {kind} {pk} {str(dtype)[6:]} r0={r0}"
        a = KB.fused_trunc_draw_rng(wt, s2, r0, prm, W)
        if not torch.equal(a, KB.fused_trunc_draw(wt, uu, prm, W)):
            raise AssertionError(f"K10 differs from K9 on the same uniforms: {case}")
        tally.trunc("fused_trunc_draw_rng", case, a,
                    KB.fused_trunc_draw_rng_torch(wt, s2, r0, prm, W), wt, uu, prm, exact)
        two = bops.butterfly_sample_truncated_rng(wt, SEED_PAIR, prm, row_offset=r0, W=W,
                                                  route="two_pass")
        tally.trunc("fused_trunc_draw_rng", case + " fused vs two-pass",
                    a.clamp(max=Kc - 1), two, wt, uu, prm, exact)
        if zero and not bool((a[list(zero)].clamp(max=Kc - 1) == Kc - 1).all()):
            raise AssertionError(f"{case}: an all-zero row did not draw K-1")
    for K in EDGE_KS:  # K9's edge rows, the survivor list's overflow among them
        W = runtime.default_w(K)
        wt, prm = trunc_edge_rows(K, g, dev)
        uu = rng.row_uniforms(s2d, 77, wt.shape[0])
        a = KB.fused_trunc_draw_rng(wt, s2, 77, prm, W)
        tally.same("fused_trunc_draw_rng", f"edge rows (10,{K}) vs K9",
                   a, KB.fused_trunc_draw(wt, uu, prm, W))
        tally.trunc("fused_trunc_draw_rng", f"edge rows (10,{K})", a,
                    KB.fused_trunc_draw_rng_torch(wt, s2, 77, prm, W), wt, uu, prm, False)
    return tally


def phase_seeded_timing(dev, seed):
    """K5 and K10 at the sharded decode's (64, 256000), W=128, peaked
    softmax weights, gemma2-9b's params: beside each its plain version,
    its bound (the weights read once, B int32 written), its yardstick
    (K10: the sorted draw; K5: none) and K4 / K9 on the PyTorch
    ``rng.row_uniforms`` they replace."""
    g = torch.Generator(device=dev).manual_seed(seed + 12)
    B, Kv, W = DECODE_B, gemma2_9b.VOCAB_SIZE, 128
    s2, s2d = _seed2(dev)
    w = trunc_weights("softmax", B, Kv, g, dev)
    prm = trunc_params("uniform", B, g, dev)
    chain = (sampling.TopK(prm[:, 0]), sampling.TopP(prm[:, 1]))
    bound = (B * Kv * 4 + B * 4) / HBM_BYTES_PER_S * 1e3
    u = rng.row_uniforms(s2d, 0, B)
    log(f"phase 2f: seeded-draw times at ({B},{Kv}) W={W}")
    out = time_kernels({
        "fused_draw_rng": (lambda: KB.fused_draw_rng(w, s2, 0, W),
                           lambda: KB.fused_draw_rng_torch(w, s2, 0, W), None,
                           lambda _: (bound, "bytes")),
        "fused_trunc_draw_rng": (lambda: KB.fused_trunc_draw_rng(w, s2, 0, prm, W),
                                 lambda: KB.fused_trunc_draw_rng_torch(w, s2, 0, prm, W),
                                 lambda: sref.draw_truncated_sorted(w, u, chain),
                                 lambda _: (bound + B * 12 / HBM_BYTES_PER_S * 1e3, "bytes")),
    })
    # what the in-kernel uniforms save: K4 / K9 on PyTorch's row_uniforms
    for name, fn in (("K4 + row_uniforms", lambda: KB.fused_draw(w, rng.row_uniforms(s2d, 0, B),
                                                                 W)),
                     ("K9 + row_uniforms", lambda: KB.fused_trunc_draw(
                         w, rng.row_uniforms(s2d, 0, B), prm, W)),
                     ("row_uniforms alone", lambda: rng.row_uniforms(s2d, 0, B))):
        ms = cuda_ms(fn)
        out.setdefault("replaced", {})[name] = ms
        log(f"  {name:22s} {ms:.4f} ms")
    return out


# K2 and K4/K5 layout shapes: the sweep's chunk (K = 240, W = 16; B is the
# chunk's), the decode widths at W = default_w(K), and a grid of row widths
# and batches around the rule's crossover (kernel.fused_layout)
LAYOUT_SHAPES = [(27392, 240), (64, 4096), (64, 32000), (8, 256000), (64, 256000)] + [
    (B, K) for B in (64, 1024, 27392) for K in (512, 1024, 2048, 4096)]
# K8 layout shapes at the lda_kernel sweep's W = 32: the chunk of 256
# documents at K = 240 and at wider K around the layout rule (the warp
# layout fits up to ~3,000 columns: K = 3,000 runs the two-pass route),
# and every padded position of the paper corpus at once (the distributed
# sweep's one launch)
LDA_LAYOUT_KS = (240, 1024, 2048, 3000)


def _timed(fn, main: bool) -> dict:
    """CUDA-event ms of fn(); at the main paths' shapes also the
    profiler's device ms and the host's microseconds per call."""
    out = {"ms": cuda_ms(fn)}
    if main:
        out["device_ms"] = device_ms(fn)
        out["host_us"] = host_us(fn)
    return out


def _lda_layout_timing(corpus, dev, g, C: int):
    """K8 in each layout (and K6 + K7, the two-pass route) at the chunk
    for LDA_LAYOUT_KS and at every padded position of the corpus (K =
    240), W = 32, Dirichlet factors."""
    W, V = 32, corpus.vocab_size
    layouts = getattr(KL, "LAYOUTS", None)
    M, N = corpus.docs.shape
    out = []
    for Kc, docs in [(k, corpus.docs[:C]) for k in LDA_LAYOUT_KS] + [(CONFIG.K, corpus.docs)]:
        Cd = docs.shape[0]
        th, ph = factors("dirichlet", Cd, V, Kc, g, dev)
        d = (torch.arange(Cd * N, device=dev, dtype=torch.int32) // N).contiguous()
        w = torch.as_tensor(docs, device=dev).reshape(-1).to(torch.int32).contiguous()
        u = torch.rand(d.numel(), generator=g, device=dev)
        nb = KL.num_blocks(Kc, W)
        main = Kc == CONFIG.K
        row = {"draws": d.numel(), "K": Kc, "W": W, "nb": nb,
               "bound_ms": bounds("lda_fused_draw", th, ph, d, w, None, W, nb)[0]}
        if layouts:
            row["rule"] = KL.lda_fused_layout(nb, W)
            calls = {lay: (lambda lay=lay: KL._lda_fused_draw(th, ph, d, w, u, W, layout=lay))
                     for lay in layouts
                     if (KL.group_fits if lay == "group" else KL.fused_fits)(nb, W)}
        else:
            calls = ({"default": lambda: KL.lda_fused_draw(th, ph, d, w, u, W)}
                     if KL.fused_fits(nb, W) else {})
        rows = torch.arange(d.numel(), dtype=torch.int32, device=dev)
        calls["K6 + K7"] = lambda: KL.lda_walk(th, ph, KL.lda_blocksums(th, ph, d, w, W, nb),
                                               u, rows, d, w, W)
        for name, fn in calls.items():
            row[name] = _timed(fn, main)
        log("  K8 " + " ".join(f"{k}={v}" for k, v in row.items()))
        out.append(row)
        del th, ph, d, w, u, rows
    return out


# K1's schedule grid: W = 64 and 128, K = 32,000 and 256,000, B from 128
# up to the largest power of two whose fp32 weights and table fit in 8 GiB
TABLE_GRID = [(B, Kc, W) for W in (64, 128) for Kc in (32000, 256000)
              for B in (128 << i for i in range(9)) if B * Kc * 8 <= 8 << 30]


def _table_timing(dev, g):
    """K1 in each schedule at (128, 256000), W = 128 (the butterfly state of
    64 rows; also the host's time per call) and over TABLE_GRID, uniform
    weights: CUDA-event and profiler device ms beside the bound."""
    scheds = getattr(KT, "SCHEDULES", None)
    out = []
    for i, (B, Kc, W) in enumerate([(128, gemma2_9b.VOCAB_SIZE, 128)] + TABLE_GRID):
        w = torch.rand((B, Kc), generator=g, device=dev)
        G, nb = B // W, Kc // W
        row = {"B": B, "K": Kc, "W": W, "bound_ms": B * Kc * 8 / HBM_BYTES_PER_S * 1e3}
        if scheds:
            row["rule"] = KT.table_schedule(G, nb, W)
            row["P"] = KTR.table_split_blocks(G, nb, W)
            calls = {s: (lambda s=s: KT._butterfly_table(w, W, "blocks", schedule=s))
                     for s in scheds}
        else:
            calls = {"default": lambda: KT.butterfly_table_cuda(w, W, "blocks")}
        for name, fn in calls.items():
            if i == 0:  # the main shape: also the host's time and each kernel apart
                row[name] = _timed(fn, True)
                row[name]["by_kernel"] = {k.split("<")[0].split("::")[-1]: v for k, v in
                                          device_ms_by_kernel(fn).items()}
            else:
                row[name] = {"ms": cuda_ms(fn), "device_ms": device_ms(fn)}
        log("  K1 " + " ".join(f"{k}={v}" for k, v in row.items()))
        out.append(row)
        del w
    return out


def _walk_layout_timing(corpus, dev, g, C: int):
    """K7 in each layout at the chunk (K = 240) and at K = 3,000 (the
    two-pass route of ``lda_draw_docs``), W = 32, S = 1 and 4 draws per
    position, on K6's running sums of Dirichlet factors."""
    W, V = 32, corpus.vocab_size
    layouts = KL.LAYOUTS if hasattr(KL, "_lda_walk") else None
    docs = torch.as_tensor(corpus.docs[:C], device=dev)
    N = docs.shape[1]
    d = (torch.arange(C * N, device=dev, dtype=torch.int32) // N).contiguous()
    w = docs.reshape(-1).to(torch.int32).contiguous()
    out = []
    for Kc in (CONFIG.K, 3000):
        th, ph = factors("dirichlet", C, V, Kc, g, dev)
        nb = KL.num_blocks(Kc, W)
        run = KL.lda_blocksums(th, ph, d, w, W, nb)
        for S in (1, 4):
            rows = torch.arange(d.numel(), dtype=torch.int32, device=dev).repeat(S)
            ds, ws = d.repeat(S), w.repeat(S)
            u = torch.rand(rows.numel(), generator=g, device=dev)
            idx = KL.lda_walk(th, ph, run, u, rows, ds, ws, W)
            row = {"K": Kc, "S": S, "draws": rows.numel(), "W": W, "nb": nb,
                   "bound_ms": bounds("lda_walk", th, ph, d, w, idx, W, nb, S=S)[0]}
            calls = ({lay: (lambda lay=lay: KL._lda_walk(th, ph, run, u, rows, ds, ws, W,
                                                         layout=lay)) for lay in layouts}
                     if layouts else
                     {"default": lambda: KL.lda_walk(th, ph, run, u, rows, ds, ws, W)})
            if layouts:
                row["rule"] = KL.lda_walk_layout(nb, W)
            for name, fn in calls.items():
                row[name] = _timed(fn, True)
            log("  K7 " + " ".join(f"{k}={v}" for k, v in row.items()))
            out.append(row)
    return out


def _fence_timing(corpus, dev, g, chunk, d, w):
    """Device times of the kernels that phase 2g times nowhere else, at the
    main paths' shapes: K1 at the chunk (W = 16, the butterfly sweep's
    call), K6 at the chunk (W = 32), K9, K10 and K12 at (64, 256000), W =
    128, gemma2-9b's params, K13 at phi (37,286 x 240)."""
    K, V = CONFIG.K, corpus.vocab_size
    th, ph = factors("dirichlet", 256, V, K, g, dev)
    B, Kv, W = DECODE_B, gemma2_9b.VOCAB_SIZE, 128
    wv = trunc_weights("softmax", B, Kv, g, dev)
    prm = trunc_params("uniform", B, g, dev)
    u = torch.rand(B, generator=g, device=dev)
    tau = tr.thresholds_from_params(wv, prm).contiguous()
    run = KB.masked_blocksums(wv, tau, W, KB.num_blocks(Kv, W))
    rows = torch.arange(B, dtype=torch.int32, device=dev)
    s2, _ = _seed2(dev)
    sp, nL, rank = alias_inputs(factors("dirichlet", 1, V, K, g, dev)[1])
    calls = {"K1 chunk W=16": lambda: KT.butterfly_table_cuda(chunk, 16, "blocks"),
             "K6 chunk W=32": lambda: KL.lda_blocksums(th, ph, d, w, 32, KL.num_blocks(K, 32)),
             "K9": lambda: KB.fused_trunc_draw(wv, u, prm, W),
             "K10": lambda: KB.fused_trunc_draw_rng(wv, s2, 0, prm, W),
             "K12": lambda: KB.walk_trunc(wv, run, u, tau, rows, W),
             "K13 phi": lambda: KA.alias_assemble(sp, nL, rank)}
    out = {n: _timed(fn, True) for n, fn in calls.items()}
    log("  fence " + " ".join(f"{k}={v}" for k, v in out.items()))
    return out


def phase_layout_timing(corpus, dev, seed):
    """CUDA-event times of K2, K4 and K5 in each layout at LAYOUT_SHAPES
    (K2 beside its library call, ``view(B, nb, W).sum(-1).cumsum(1)``), K3
    at the chunk (W = 16) with S = 1 and 4, K8 in each layout at
    LDA_LAYOUT_KS and over every position of the corpus, K7 in each layout
    (``_walk_layout_timing``), K1 in each schedule (``_table_timing``), K11
    at (64, 256000) W = 128, the kernels of ``_fence_timing``, K6 in each
    layout (``_blocksums_layout_timing``) and K12 in each layout
    (``_walk_trunc_layout_timing``) and K13 in each layout
    (``_alias_timing``), each
    beside its bound (each input read once, each
    output written once); at the main paths' shapes also the device time
    from torch.profiler, which leaves out the host's time per call, and
    that host time (where it exceeds the device time, the CUDA-event time
    of back-to-back calls measures the host).  Uses only entry points the
    kernels had before their layouts, so that ``--timing-only --src``
    times an older commit's kernels with the same inputs (it reports its
    one layout as "default")."""
    g = torch.Generator(device=dev).manual_seed(seed + 20)
    s2, _ = _seed2(dev)
    res = {"fused": [], "walk": {}}
    layouts = getattr(KB, "LAYOUTS", None)
    k2_layouts = layouts if hasattr(KB, "_blocksums") else None
    C, K = 256, CONFIG.K
    docs_c = torch.as_tensor(corpus.docs[:C], device=dev)
    N = docs_c.shape[1]
    d = (torch.arange(C * N, device=dev, dtype=torch.int32) // N).contiguous()
    w = docs_c.reshape(-1).contiguous()
    chunk = chunk_weights(*factors("dirichlet", C, corpus.vocab_size, K, g, dev), d, w)
    log(f"phase 2g: K2 and K4/K5 layouts, K3 by lane groups, K8 layouts, K11 "
        f"({'layouts ' + str(layouts) if layouts else 'one layout'})")
    for i, (B, Kc) in enumerate(LAYOUT_SHAPES):
        main = i < 5  # the shapes of the main paths
        if Kc == K:  # the chunk of 256 documents: B = 256 x its longest
            W, wts, B = 16, chunk, chunk.shape[0]
        else:
            W = runtime.default_w(Kc)
            wts = torch._standard_gamma(torch.full((B, Kc), 0.3, device=dev), generator=g)
        u = torch.rand(B, generator=g, device=dev)
        nb = KB.num_blocks(Kc, W)
        row = {"B": B, "K": Kc, "W": W, "nb": nb,
               "bound_ms": (B * Kc * 4 + B * 8) / HBM_BYTES_PER_S * 1e3,
               "K2 bound_ms": given_bounds("blocksums", wts, W, nb, None, None)[0]}
        calls = ({lay: (lambda lay=lay: KB._fused_draw(wts, u, W, layout=lay),
                        lambda lay=lay: KB._fused_draw_rng(wts, s2, 0, W, layout=lay))
                  for lay in layouts} if layouts else
                 {"default": (lambda: KB.fused_draw(wts, u, W),
                              lambda: KB.fused_draw_rng(wts, s2, 0, W))})
        if layouts:
            row["rule"] = KB.fused_layout(B, nb, W)
        for lay, (k4, k5) in calls.items():
            row[f"K4 {lay}"] = cuda_ms(k4)
            row[f"K5 {lay}"] = cuda_ms(k5)
            if main:  # also the card's own time and the host's per call
                row[f"K4 {lay} device"] = device_ms(k4)
                row[f"K5 {lay} device"] = device_ms(k5)
                row[f"K5 {lay} host_us"] = host_us(k5)
        k2 = ({lay: (lambda lay=lay: KB._blocksums(wts, W, nb, layout=lay))
               for lay in k2_layouts} if k2_layouts else
              {"default": lambda: KB.blocksums(wts, W, nb)})
        if k2_layouts:
            row["K2 rule"] = KB.blocksums_layout(B, nb, W)
        if Kc % W == 0:  # the library yardstick needs whole W-blocks
            k2["library"] = lambda: torch.cumsum(wts.view(B, nb, W).sum(-1), dim=1)
        for lay, fn in k2.items():  # device times at every shape: the crossover
            row[f"K2 {lay}"] = cuda_ms(fn)
            row[f"K2 {lay} device"] = device_ms(fn)
        log("  " + " ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                            for k, v in row.items()))
        res["fused"].append(row)
        del wts
    W, nb, B = 16, KB.num_blocks(K, 16), chunk.shape[0]
    run = KB.blocksums(chunk, W, nb)
    for S in (1, 4):
        rows = torch.arange(B, dtype=torch.int32, device=dev).repeat(S)
        uf = torch.rand(S * B, generator=g, device=dev)
        ms = cuda_ms(lambda: KB.walk(chunk, run, uf, rows, W))
        dms = device_ms(lambda: KB.walk(chunk, run, uf, rows, W))
        hus = host_us(lambda: KB.walk(chunk, run, uf, rows, W))
        bms, _ = given_bounds("walk", chunk, W, nb, KB.walk(chunk, run, uf, rows, W), rows)
        res["walk"][f"S={S}"] = {"ms": ms, "device_ms": dms, "host_us": hus, "bound_ms": bms,
                                 "draws": S * B}
        log(f"  K3 chunk ({B},{K}) W={W} S={S}: {ms:.4f} ms (device {_ms(dms)}, host "
            f"{hus:.1f} us per call), bound {bms:.5f} ms")
    res["lda_fused"] = _lda_layout_timing(corpus, dev, g, C)
    res["lda_walk"] = _walk_layout_timing(corpus, dev, g, C)
    res["butterfly_table"] = _table_timing(dev, g)
    res["fence"] = _fence_timing(corpus, dev, g, chunk, d, w)
    # K11 (untouched by the K2 and K8 layouts) at the decode's shape
    Bv, Kv, Wv = DECODE_B, gemma2_9b.VOCAB_SIZE, 128
    wv = trunc_weights("softmax", Bv, Kv, g, dev)
    tau = tr.thresholds_from_params(wv, trunc_params("uniform", Bv, g, dev)).contiguous()
    nbv = KB.num_blocks(Kv, Wv)
    res["masked_blocksums"] = _timed(lambda: KB.masked_blocksums(wv, tau, Wv, nbv), True)
    log(f"  K11 ({Bv},{Kv}) W={Wv}: {res['masked_blocksums']}")
    res["lda_blocksums"] = _blocksums_layout_timing(corpus, dev, g, C)
    res["walk_trunc"] = _walk_trunc_layout_timing(dev, g, wv, tau)
    res["alias"] = _alias_timing(dev, g)
    return res


def _blocksums_layout_timing(corpus, dev, g, C: int):
    """K6 in each layout that fits at the chunk (K = 240) and at K = 3,000,
    W = 32, Dirichlet factors, beside its library yardstick
    (``k6_library``) and its bound."""
    W, V = 32, corpus.vocab_size
    layouts = KL.LAYOUTS if hasattr(KL, "_lda_blocksums") else None
    docs = torch.as_tensor(corpus.docs[:C], device=dev)
    N = docs.shape[1]
    d = (torch.arange(C * N, device=dev, dtype=torch.int32) // N).contiguous()
    w = docs.reshape(-1).to(torch.int32).contiguous()
    out = []
    for Kc in (CONFIG.K, 3000):
        th, ph = factors("dirichlet", C, V, Kc, g, dev)
        nb = KL.num_blocks(Kc, W)
        row = {"K": Kc, "draws": d.numel(), "W": W, "nb": nb,
               "bound_ms": bounds("lda_blocksums", th, ph, d, w, None, W, nb)[0]}
        if layouts:
            row["rule"] = KL.lda_blocksums_layout(nb, W)
            calls = {lay: (lambda lay=lay: KL._lda_blocksums(th, ph, d, w, W, nb, layout=lay))
                     for lay in layouts if lay == "warp" or KL.group_fits(nb, W)}
        else:
            calls = {"default": lambda: KL.lda_blocksums(th, ph, d, w, W, nb)}
        calls["library"] = k6_library(th, ph, d, w, W, nb)
        for name, fn in calls.items():
            row[name] = _timed(fn, True)
        log("  K6 " + " ".join(f"{k}={v}" for k, v in row.items()))
        out.append(row)
    return out


def _walk_trunc_layout_timing(dev, g, wv, tau):
    """K12 in each layout at the decode's (64, 256000) and at (64, K) for K
    = 4,096, 32,000 and 128,256 (peaked softmax, gemma2-9b's params), W =
    default_w(K), S = 1 and 4 draws per row, on K11's masked running sums,
    beside its bound; and the profiler's time of a 64-element ``add_``, the
    least device time of a launch."""
    B = wv.shape[0]
    layouts = getattr(KB, "WALK_TRUNC_LAYOUTS", None)
    x = torch.zeros(B, device=dev)
    out = {"floor_device_ms": device_ms(lambda: x.add_(1.0)), "rows": []}
    for Kv in (gemma2_9b.VOCAB_SIZE, 4096, 32000, 128256):
        if Kv != wv.shape[1]:
            wv = trunc_weights("softmax", B, Kv, g, dev)
            tau = tr.thresholds_from_params(wv, trunc_params("uniform", B, g, dev)).contiguous()
        W = runtime.default_w(Kv)
        nb = KB.num_blocks(Kv, W)
        run = KB.masked_blocksums(wv, tau, W, nb)
        for S in (1, 4):
            rows = torch.arange(B, dtype=torch.int32, device=dev).repeat(S)
            u = torch.rand(S * B, generator=g, device=dev)
            row = {"B": B, "K": Kv, "S": S, "W": W, "nb": nb,
                   "bound_ms": trunc_bounds("walk_trunc", wv, W, nb, S=S)[0]}
            if layouts:
                row["rule"] = KB.walk_trunc_layout(nb, W)
                calls = {lay: (lambda lay=lay: KB._walk_trunc(wv, run, u, tau, rows, W,
                                                              layout=lay)) for lay in layouts}
            else:
                calls = {"default": lambda: KB.walk_trunc(wv, run, u, tau, rows, W)}
            for name, fn in calls.items():
                row[name] = _timed(fn, True)
            log("  K12 " + " ".join(f"{k}={v}" for k, v in row.items()))
            out["rows"].append(row)
    log(f"  device floor (64-element add_): {_ms(out['floor_device_ms'])}")
    return out


# K13's layout grid: rows tiled from (64, K) softmax inputs at vocabulary
# widths (gemma2-9b's 256,000, llama-3's 128,256, the llama-2 tokenizer's
# 32,000: Kp = 262,144, 131,072, 32,768) and at K = 16,000 and 4,096, B
# around the layout rule's crossover
ALIAS_GRID = ([(B, gemma2_9b.VOCAB_SIZE) for B in (1, 8, 64, 256, 1024, 4096)]
              + [(B, 128256) for B in (64, 1024)]
              + [(B, 32000) for B in (64, 1024, 8192, 32768)]
              + [(B, 16000) for B in (64, 1024, 8192)]
              + [(B, 4096) for B in (64, 1024, 8192, 37286)])


def _alias_timing(dev, g):
    """K13 in each layout (one "default" in a tree without them) at phi
    (37,286 x 240, Kp = 256) and at (64, 256000) (Kp = 262,144), the main
    paths' shapes, with the profiler's device ms and the host's time per
    call; over ALIAS_GRID (rows tiled from the (64, K) inputs) CUDA-event
    and device ms; and at both main shapes the device build's steps:
    ``_partition``, ``_merged_rank``, the assembly, the whole
    ``build_alias_tables_device`` and the path around it
    (``sample_from_logits`` at (64, 256000), ``Categorical.from_weights``
    and 16 draws a row at phi)."""
    layouts = getattr(KA, "fitting_layouts", None)

    def calls(sp, nL, rank):
        if layouts is None:
            return {"default": lambda: KA.alias_assemble(sp, nL, rank)}
        return {lay: (lambda lay=lay: KA._alias_assemble(sp, nL, rank, layout=lay))
                for lay in layouts(*sp.shape)}

    V = gemma2_9b.VOCAB_SIZE
    phi = factors("dirichlet", 1, CONFIG.V, CONFIG.K, g, dev)[1]
    logits = 4.0 * torch.randn((DECODE_B, V), generator=g, device=dev)
    wv = sampling.logits_to_weights(logits)
    out = {"main": [], "grid": [], "build": []}
    for name, w in (("phi", phi), (f"({DECODE_B}, {V})", wv)):
        sp, nL, rank = alias_inputs(w)
        row = {"shape": name, "B": sp.shape[0], "Kp": sp.shape[1],
               "bound_ms": alias_bound(sp, nL)[0]}
        if layouts is not None:
            row["rule"] = KA.alias_layout(*sp.shape)
        for lay, fn in calls(sp, nL, rank).items():
            row[lay] = _timed(fn, True)
            row[lay]["by_kernel"] = {re.search(r"(\w+)(?:<[^>]*>)?\(", k).group(1): v
                                     for k, v in device_ms_by_kernel(fn).items()}
        log("  K13 " + " ".join(f"{k}={v}" for k, v in row.items()))
        out["main"].append(row)
        if name == "phi":
            path = ("Categorical + 16 draws", lambda: sampling.Categorical.from_weights(
                phi, method="alias_device").draw(generator=g, num_samples=16))
        else:
            path = ("sample_from_logits", lambda: api.sample_from_logits(
                logits, g, method="alias_device"))
        steps = {"_partition": lambda: aops._partition(w),
                 "_merged_rank": lambda: aops._merged_rank(sp, nL),
                 "alias_assemble": lambda: KA.alias_assemble(sp, nL, rank),
                 "build_alias_tables_device": lambda: aops.build_alias_tables_device(w),
                 path[0]: path[1]}
        build = {"shape": name}
        for step, fn in steps.items():
            build[step] = {"ms": cuda_ms(fn, reps=5, warmup=1), "device_ms": device_ms(fn, 5)}
        log("  alias_device " + " ".join(f"{k}={v}" for k, v in build.items()))
        out["build"].append(build)
    base = {V: alias_inputs(wv)}
    for B, K in ALIAS_GRID:
        if K not in base:
            base[K] = alias_inputs(trunc_weights("softmax", DECODE_B, K, g, dev))
        idx = torch.arange(B, device=dev) % DECODE_B
        sp, nL, rank = (t[idx].contiguous() for t in base[K])
        row = {"B": B, "Kp": sp.shape[1], "bound_ms": alias_bound(sp, nL)[0]}
        if layouts is not None:
            row["rule"] = KA.alias_layout(*sp.shape)
        for lay, fn in calls(sp, nL, rank).items():
            row[lay] = {"ms": cuda_ms(fn), "device_ms": device_ms(fn)}
        log("  K13 " + " ".join(f"{k}={v}" for k, v in row.items()))
        out["grid"].append(row)
        del sp, nL, rank
    return out


def _shard_emulation(dev, g, B, V, W, prm, key):
    """The per-shard bodies on rows [s*B/R, (s+1)*B/R) with row0 = s*B/R,
    R = 2 and 8, concatenated, against the one-rank draws.  Two NCCL ranks
    cannot share a card; this shows the device-count invariance on one.
    K5, K10 and the ``kernel`` tables (K2; K3 draws) sum each row in a
    fixed order, whatever the batch, so they must be equal bit for bit.
    The other tables are built by PyTorch's CUDA reductions and scans
    (``torch.cumsum`` among them), whose order may change with the number
    of rows: there a mismatch must be a float64-checked boundary tie."""
    from repro_torch.sampling import sharded as sh

    z = 4.0 * torch.randn((B, V), generator=g, device=dev)
    w = sampling.logits_to_weights(z)
    temp = torch.ones(B, device=dev)
    u = rng.row_uniforms(rng.fold(rng.seed_from_key(key), rng.TAG_U).to(dev), 0, B)
    bodies = {
        "K5 (kernel logits)": lambda lo, hi: sh._shard_sample_logits(
            "kernel", W, z[lo:hi], 1.0, key, lo),
        "K10 (kernel, top-k/top-p)": lambda lo, hi: sh._shard_sample_truncated(
            "kernel", W, z[lo:hi], temp[lo:hi], prm[lo:hi], key, lo),
    }
    for m in ("kernel", "prefix", "fenwick", "butterfly", "two_level", "radix_forest"):
        bodies[f"{m} (build + counter draw)"] = (
            lambda lo, hi, m=m: sh._local_draw(sampling.Categorical._build(w[lo:hi], m, W),
                                               key, lo, 1))
    res = {}
    for name, body in bodies.items():
        exact = name.startswith(("K5", "K10", "kernel"))
        whole = body(0, B)
        for R in (2, 8):
            n = B // R
            parts = torch.cat([body(s * n, (s + 1) * n) for s in range(R)])
            r = ({"mismatches": int((parts != whole).sum()), "ties": 0, "faults": 0}
                 if exact else weight_ties(parts, whole, w, u))
            if exact:
                r["faults"] = r["mismatches"]
            log(f"  shard emulation R={R} {name}: {r}")
            if r["faults"]:
                raise AssertionError(f"shard emulation R={R} {name}: the shards differ "
                                     f"from the one-rank draw: {r}")
            res[f"R={R} {name}"] = r
    return res


class _AllReduceCount:
    """Counts torch.distributed.all_reduce calls while active."""

    def __enter__(self):
        import torch.distributed as dist

        self.n, self._orig = 0, dist.all_reduce

        def counted(*a, **k):
            self.n += 1
            return self._orig(*a, **k)

        dist.all_reduce = counted
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        dist.all_reduce = self._orig


def sparse_sharded(mesh, corpus, dev, seed, sweeps: int = 3, cap: int = 32):
    """``make_sharded_gibbs(mesh, 240, V, sparse=True)`` at paper scale:
    S1 once and one ``all_reduce`` a sweep; each sweep's z equal to the
    single-device sparse draw (``draw_z_sparse``, cdf tables, the same
    cap and seed) from that sweep's incoming state."""
    from repro_torch.lda.distributed import make_sharded_gibbs

    K = CONFIG.K
    place, step = make_sharded_gibbs(mesh, K, corpus.vocab_size, sparse=True, cap=cap)
    st, docs, mask = place(gibbs.init_state(seed, corpus, K, device=dev), corpus.docs,
                           corpus.mask)
    ins, outs, times, reduces = [], [], [], []
    torch.cuda.synchronize()
    reset_counts()
    for _ in range(sweeps):
        ins.append(gibbs.LDAState(theta=st.theta.to_local(), phi=st.phi.to_local(),
                                  z=st.z.to_local(), key=st.key, step=st.step))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _AllReduceCount() as c:
            st = step(st, docs, mask)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        reduces.append(c.n)
        outs.append(st.z.to_local())
    counts = read_counts()
    check_path("distributed sparse sweep", counts, {"sparse_mh": sweeps})
    if reduces != [1] * sweeps:
        raise AssertionError(f"distributed sparse sweep: all_reduce calls {reduces}")
    for i, (s_in, z) in enumerate(zip(ins, outs)):
        want = lsp.draw_z_sparse(s_in, docs.to_local(), mask.to_local(), mh_steps=1,
                                 word_proposal="cdf",
                                 cache=lsp.SparseSweepCache(cap_min=cap, cap_max=cap))
        if not torch.equal(z, want):
            raise AssertionError(f"distributed sparse sweep {i}: z differs from "
                                 "draw_z_sparse on its incoming state")
    full = gibbs.LDAState(theta=st.theta.to_local(), phi=st.phi.to_local(),
                          z=st.z.to_local(), key=st.key, step=st.step)
    check_state(full, K)
    ppl = gibbs.perplexity(full, corpus)
    log(f"  distributed sparse sweep (cdf, cap {cap}, 1 step, 1 rank): seconds per sweep "
        f"{times}, all_reduce calls {reduces}, z equal to draw_z_sparse's, perplexity "
        f"{ppl:.2f}")
    return counts, {"sweep_s": times, "all_reduce": reduces, "perplexity": ppl,
                    "launches": counts}


def phase_sharded(corpus, dev, seed, steps: int = 20, B: int = DECODE_B,
                  V: int = gemma2_9b.VOCAB_SIZE, M_planted: int = 96):
    """Phase 6, the sharded paths, on a one-rank NCCL group (an in-memory
    store, no TCP port) and its ``("data",)`` mesh: the decode at
    gemma2-9b's width (K10 once per step under top-k/top-p, K5 once per
    step without), ``sample`` once per explicit method against the
    unsharded counter draw, the shard emulation, and the distributed sweep
    at paper scale (one all_reduce per sweep) and on the planted corpus."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.lda.distributed import make_sharded_gibbs
    from repro_torch.sampling import sharded as sh

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("data",))
        g = torch.Generator(device=dev).manual_seed(seed + 13)
        spec = gemma2_9b.SAMPLER
        chain = (sampling.TopK(spec.top_k), sampling.TopP(spec.top_p))
        res, launches = {}, {}
        logits = 4.0 * torch.randn((B, V), generator=g, device=dev)
        kth = torch.sort(logits, dim=1, descending=True).values[:, spec.top_k - 1:spec.top_k]
        for name, kw, expect in (
                ("top-k/top-p (K10)", {"transforms": chain}, "fused_trunc_draw_rng"),
                ("no transforms (K5)", {}, "fused_draw_rng")):
            p = sampling.plan((B, V), method="kernel", mesh=mesh,
                              transforms="kp" if kw else "")
            toks = []
            torch.cuda.synchronize()
            reset_counts()
            times = step_seconds(lambda: toks.append(p.sample_logits(
                logits, key=[seed, len(toks)], **kw)), steps)
            counts = read_counts()
            check_path(f"sharded decode ({B},{V}) {name}", counts, {expect: steps})
            tok = torch.stack([t.to_local() for t in toks]).long()
            if kw and not bool((torch.gather(logits, 1, tok.T) >= kth).all()):
                raise AssertionError(f"sharded decode {name}: a token outside its top-k")
            want = (bops.butterfly_sample_truncated_rng(
                sampling.logits_to_weights(logits), [seed, 0],
                tr.canonical_params(chain, B, device=dev)) if kw else
                bops.butterfly_sample_rng(sampling.logits_to_weights(logits), [seed, 0],
                                          W=p.W))
            if not torch.equal(toks[0].to_local(), want):
                raise AssertionError(f"sharded decode {name}: differs from the unsharded "
                                     "counter draw")
            log(f"  sharded decode ({B},{V}) {name}: seconds per step {times}")
            res[f"decode {name}"] = {"step_s": times, "launches": counts}
            add_counts(launches, counts)
        # sample once per explicit method, against the unsharded counter draw
        key = [seed, 77]
        s0 = rng.seed_from_key(key)
        expects = {"kernel": {"fused_draw_rng": 1}, "butterfly": {"butterfly_table": 1},
                   "alias_device": {"alias_assemble": 1}}
        w = sampling.logits_to_weights(logits)
        for m in api.METHODS[1:]:
            x = w[:, :4096].contiguous() if m == "alias" else w
            p = sampling.plan(tuple(x.shape), method=m, mesh=mesh)
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            got = p.sample(x, key=key).to_local()
            torch.cuda.synchronize()
            t = time.perf_counter() - t0
            counts = read_counts()
            check_path(f"sharded sample {m} {tuple(x.shape)}", counts, expects.get(m, {}))
            add_counts(launches, counts)
            flat = sampling.Categorical.from_weights(x, method=m, W=p.W)
            if m in sampling.U_VARIANTS:
                want = flat.draw(u=rng.row_uniforms(rng.fold(s0, rng.TAG_U).to(dev), 0, B))
            else:
                want = sh._local_draw(flat, s0, 0, 1)
            if not torch.equal(got, want):
                raise AssertionError(f"sharded sample {m}: differs from the unsharded "
                                     "counter draw")
            log(f"  sharded sample {m:13s} {tuple(x.shape)}: {t:.4f} s, equals the "
                "unsharded counter draw")
            res[f"sample {m}"] = {"shape": list(x.shape), "seconds": t, "launches": counts}
        prm = tr.canonical_params(chain, B, device=dev).contiguous()
        res["shard_emulation"] = _shard_emulation(dev, g, B, V, 128, prm, [seed, 5])
        # the distributed sweep at paper scale
        K = CONFIG.K
        place, step = make_sharded_gibbs(mesh, K, corpus.vocab_size, method="lda_kernel", W=32)
        state0 = gibbs.init_state(seed, corpus, K, device=dev)
        st, docs, mask = place(state0, corpus.docs, corpus.mask)
        torch.cuda.synchronize()
        reset_counts()
        times, reduces = [], []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with _AllReduceCount() as c:
                st = step(st, docs, mask)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            reduces.append(c.n)
        counts = read_counts()
        check_path("distributed sweep (lda_kernel)", counts, {"lda_fused_draw": 3})
        add_counts(launches, counts)
        if reduces != [1, 1, 1]:
            raise AssertionError(f"distributed sweep: all_reduce calls per sweep {reduces}")
        full = gibbs.LDAState(theta=st.theta.to_local(), phi=st.phi.to_local(),
                              z=st.z.to_local(), key=st.key, step=st.step)
        check_state(full, K)
        ppl = gibbs.perplexity(full, corpus)
        log(f"  distributed sweep (lda_kernel, W=32, 1 rank): seconds per sweep {times}, "
            f"all_reduce calls {reduces}, perplexity {ppl:.2f}")
        # the first sweep's z: the whole batch's counter draw with its seed
        st1 = step(place(state0, corpus.docs, corpus.mask)[0], docs, mask)
        M, N = corpus.docs.shape
        seed_z = rng.fold(rng.seed_from_key([0, seed]), rng.TAG_LDA_Z, 0)
        want = ops.lda_draw_factored_rng(
            state0.theta, state0.phi, torch.arange(M * N, dtype=torch.int32, device=dev) // N,
            docs.to_local().reshape(-1), seed_z, row_offset=0, W=32)
        if not torch.equal(st1.z.to_local().reshape(-1), want):
            raise AssertionError("distributed sweep: the first sweep's z differs from "
                                 "lda_draw_factored_rng on the whole batch")
        res["distributed_sweep"] = {"sweep_s": times, "all_reduce": reduces,
                                    "perplexity": ppl, "launches": counts}
        counts, res["distributed_sparse"] = sparse_sharded(mesh, corpus, dev, seed)
        add_counts(launches, counts)
        counts, res["distributed_auto"] = auto_sharded(mesh, corpus, dev, seed)
        add_counts(launches, counts)
        # the planted corpus: 30 sweeps bring perplexity below 0.6x its start
        pc = corpus_mod.synthesize_corpus(seed=0, M=M_planted, V=120, K=8, avg_len=40,
                                          max_len=80)
        place, step = make_sharded_gibbs(mesh, 8, pc.vocab_size, method="lda_kernel", W=8)
        s = gibbs.init_state(seed, pc, 8, device=dev)
        p0 = gibbs.perplexity(s, pc)
        s, pd, pm = place(s, pc.docs, pc.mask)
        for _ in range(30):
            s = step(s, pd, pm)
        p1 = gibbs.perplexity(gibbs.LDAState(theta=s.theta.to_local(), phi=s.phi.to_local(),
                                             z=s.z.to_local(), key=s.key, step=s.step), pc)
        log(f"  distributed planted corpus: perplexity {p0:.3f} -> {p1:.3f} after 30 sweeps")
        if not (np.isfinite(p1) and p1 < 0.6 * p0):
            raise AssertionError(f"distributed planted corpus: perplexity {p0} -> {p1}")
        res["distributed_planted"] = {"p0": p0, "p1": p1}
    finally:
        dist.destroy_process_group()
    return launches, res


# ---------------------------------------------------------------------------
# Phase 7: sparse LDA (the MH-alias sweep, S1)
# ---------------------------------------------------------------------------

SPARSE_KS = (240, 1024, 2048)          # the sparse / dense crossover's topic counts
SPARSE_MODES = ("cdf", "alias", "alias_device")
# documents per step of the plain version's loop on the card: the result
# does not depend on it (ref.mh_sweep_torch), and 2,048 keeps its
# (chunk, L, cap) temporaries near 1 GB with 22 steps over the corpus
SPARSE_PLAIN_CHUNK = 2048
SPARSE_STEPS = 2                       # gibbs_step's mh_steps default
# one Threefry uniform: the integer operations of the block's source
# (THREEFRY_OPS, counted at the fp32 rate), and the integer instructions
# sm_90a compiles it to (SASS of one uniform: 20 SHF, 20 LOP3, 11 IADD3,
# 1 VIADD, 14 IMAD.IADD).  An SM issues 64 integer lanes a clock on its
# ALU pipe and 64 more as IMAD forms on its FMA pipe; only LOP3 has no
# IMAD form (adds go as IMAD.IADD, rotations as IMAD.SHL / IMAD.HI), so
# a uniform takes at least max(20 / 64, 66 / 128) of an SM's clock a lane
THREEFRY_OPS = 82
THREEFRY_INT_INSTRS, THREEFRY_ALU_ONLY_INSTRS = 66, 20
INT32_ALU_LANES_PER_SM, INT32_LANES_PER_SM = 64, 128
H100_SMS, H100_MAX_SM_HZ = 132, 1.98e9   # clocks.max.sm
MH_UNIFORMS = {"cdf": 4, "alias": 5, "alias_device": 5}   # a cycle, doc layout
STREAM_DOCS, STREAM_SHARD_DOCS = 50000, 12500


def sparse_inputs(corpus, dev, g, K: int, cap: int, M: int = None):
    """The MH sweep's inputs over the first ``M`` documents (all by
    default): Dirichlet(0.3) theta rows, a Dirichlet phi, uniform z, the
    corpus positions, and the sparse counts of z at ``cap``."""
    docs = torch.as_tensor(corpus.docs[:M], device=dev)
    mask = torch.as_tensor(corpus.mask[:M], device=dev)
    Md = docs.shape[0]
    theta = _normalised_gamma(g, (Md, K), 0.3, 1, dev)
    phi = factors("dirichlet", 1, corpus.vocab_size, K, g, dev)[1].contiguous()
    z = torch.randint(0, K, tuple(docs.shape), generator=g, device=dev, dtype=torch.int32)
    doc_topic, _ = lsp._counts_scatter(z, docs, mask, K, corpus.vocab_size)
    sp = lsp.sparse_counts(doc_topic, cap)
    return [z, docs, mask, theta, phi, sp.ids, sp.cnt]


def _normalised_gamma(g, shape, conc, dim, dev):
    x = torch._standard_gamma(torch.full(shape, conc, device=dev), generator=g)
    return (x / x.sum(dim, keepdim=True)).contiguous()


def sparse_tables(phi, mode: str):
    """(tbl_a, tbl_b) of a word-proposal mode, built once outside the
    kernels' comparison (``alias``: Vose on the host; ``alias_device``:
    the device build, K13)."""
    from repro_torch.core.alias import build_alias_tables_host

    if mode == "cdf":
        return lsp._phi_cdf(phi), torch.zeros((1, 1), dtype=torch.int32, device=phi.device)
    t = (build_alias_tables_host(phi) if mode == "alias"
         else aops.build_alias_tables_device(phi))
    return t.prob.contiguous(), t.alias.contiguous()


def check_s1(tally, case, inp, tables, seed2, row0, steps, mode, alpha=0.1):
    """S1 in each layout that takes the shape against its plain version on
    one input (z, both accept counts and the proposal count bit for bit),
    and the layouts' z against each other."""
    z, docs, mask, theta, phi, ids, cnt = inp
    args = (z, docs, mask, theta, phi, ids, cnt, *tables, seed2, row0, alpha)
    zp, wp, dp, props = sparse_ref.mh_sweep_torch(*args, steps=steps, cap=ids.shape[1],
                                                  mode=mode, chunk=SPARSE_PLAIN_CHUNK)
    want = torch.stack([wp, dp, props]).long()
    got = {}
    for lay in KS.fitting_layouts(theta.shape[1], ids.shape[1], docs.shape[1]):
        zk, wa, da, nk = KS._mh_sweep(*args, steps=steps, mode=mode, layout=lay)
        tally.same("sparse_mh", f"{case} [{lay}]", zk, zp)
        tally.same("sparse_mh", f"{case} [{lay}] counts",
                   torch.stack([wa, da, nk * steps]).long(), want)
        got[lay] = zk
    if len(got) > 1:
        tally.same("sparse_mh", f"{case} doc = position", got["doc"], got["position"])
    return {"word_accepts": int(wp), "doc_accepts": int(dp), "proposals": int(props),
            "changed": int((zp != z).sum()), "layouts": list(got)}


def s1_exact_inputs(dev, seed2, kind: str):
    """Small inputs on which a token's doc proposal hits a boundary
    exactly, built from the token's own uniform u3 = k / 2**24 (K = 16):
    ``"t=Ka"`` sets alpha = k / K and the document's retained mass to
    2**24 - k, so t = K alpha; ``"x=cc"`` (K alpha = 16, mass 2**24 - 16)
    gives each document counts (x, mass - x) with x = t - K alpha, so x
    equals cc[0].  -> (inputs, row0, alpha)."""
    M, L, K, V, row0 = 64, 8, 16, 30, 3
    g = torch.Generator(device=dev).manual_seed(75)
    rows = torch.arange(M, device=dev)
    ctr = (row0 + rows[:, None]) * L + torch.arange(L, device=dev)[None]
    u3 = rng.uniform(rng._u32(seed2, dev), ctr, 3)
    docs = torch.randint(0, V, (M, L), generator=g, device=dev, dtype=torch.int32)
    mask = torch.rand((M, L), generator=g, device=dev) < 0.7
    z = torch.randint(0, K, (M, L), generator=g, device=dev, dtype=torch.int32)
    dt = torch.randint(0, 5, (M, K), generator=g, device=dev).float()
    if kind == "t=Ka":
        k = int(u3[0, 0].item() * 2**24)
        alpha = k / K
        dt[0] = 0
        dt[0, 5], dt[0, 9] = 2**24 - k - 1000, 1000
        mask[0, 0] = True
        first = torch.zeros(M, dtype=torch.int64, device=dev)
    else:
        alpha = 1.0
        first = torch.argmax((u3 >= 0.5 + 2.0**-20).int(), dim=1)
        x = (u3[rows, first] * 2**24).long() - 16
        dt.zero_()
        dt[rows, rows % K] = x.float()
        dt[rows, (rows + 3) % K] = (2**24 - 16 - x).float()
        mask[rows, first] = True
    if (dt < 0).any():
        raise AssertionError(f"{kind}: the built counts are negative")
    sp = lsp.sparse_counts(dt, 4)
    # the boundary is hit, in float32 as the kernel computes it
    Ka = torch.tensor(float(K), device=dev) * torch.tensor(alpha, device=dev)
    cc = torch.cumsum(sp.cnt, 1).float()
    t = u3[rows, first] * (Ka + cc[:, -1])
    hits = int((t == Ka).sum()) if kind == "t=Ka" else int((t - Ka == cc[:, 0]).sum())
    if not hits:
        raise AssertionError(f"{kind}: no token's doc proposal lands on the boundary")
    theta = _normalised_gamma(g, (M, K), 0.3, 1, dev)
    phi = factors("dirichlet", 1, V, K, g, dev)[1].contiguous()
    return [z, docs, mask, theta, phi, sp.ids, sp.cnt], row0, alpha


def s1_bound(inp, z_out, tables, steps, mode):
    """Least time of one S1 call on this run's data: the larger of the
    bytes term and the integer term ``int32_ms``.  Bytes: the position
    arrays read and z written (13 bytes a position), the retained lists,
    and of the gathered inputs at least the elements this run must touch
    (theta and phi at each live token's topic before and after the sweep,
    and a live word's table entries: cdf a descent's ceil(log2 K) + 1,
    alias a column's prob and alias).  Integer work: the uniforms a live
    token and cycle must draw (``MH_UNIFORMS``: cdf 4, alias 5), each
    the larger of THREEFRY_ALU_ONLY_INSTRS at the ALU pipe's 64 lanes an SM
    a clock and THREEFRY_INT_INSTRS at both pipes' 128, 132 SMs at 1,980
    MHz.  ``fp32_ms`` counts THREEFRY_OPS a uniform at the fp32 rate, the
    first port's looser figure."""
    z, docs, mask, theta, phi, ids, cnt = inp
    K, V = theta.shape[1], phi.shape[0]
    live = mask.reshape(-1)
    d = (torch.arange(docs.shape[0], device=z.device)[:, None].expand_as(docs)
         .reshape(-1)[live])
    w = docs.reshape(-1)[live].long()
    zz = torch.cat([z.reshape(-1)[live], z_out.reshape(-1)[live]]).long()
    dd, ww = d.repeat(2), w.repeat(2)
    th_el = torch.unique(dd * K + zz).numel()
    ph_el = torch.unique(ww * K + zz).numel()
    words = torch.unique(w).numel()
    per_word = sparse_ref.ceil_log2(K) + 1 if mode == "cdf" else 2
    nbytes = (z.numel() * 13 + ids.numel() * 8 + (th_el + ph_el) * 4
              + words * per_word * 4)
    uniforms = int(live.sum()) * steps * MH_UNIFORMS[mode]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_fp32 = uniforms * THREEFRY_OPS / FP32_FLOPS * 1e3
    clocks = max(THREEFRY_ALU_ONLY_INSTRS / INT32_ALU_LANES_PER_SM,
                 THREEFRY_INT_INSTRS / INT32_LANES_PER_SM)
    t_int = uniforms * clocks / (H100_SMS * H100_MAX_SM_HZ) * 1e3
    bound, by = (t_bytes, "bytes") if t_bytes >= t_int else (t_int, "operations")
    return {"bound_ms": bound, "bound_by": by, "bytes_ms": t_bytes, "int32_ms": t_int,
            "fp32_ms": t_fp32, "uniforms": uniforms}


def s1_device_per_launch(fn, reps: int = 20):
    """S1's device time a launch from a torch.profiler trace of ``reps``
    calls of ``fn`` (one S1 launch each) -> (ms, launches the trace held)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and "sparse_mh" in e.key]
    n = sum(e.count for e in rows)
    return (sum(e.self_device_time_total for e in rows) / n / 1e3 if n else None), n


def _s1_times(args, mode, reps: int = 20) -> dict:
    """S1 in each layout that takes the shape: the CUDA-event time, two
    means of ``reps`` launches taken in turns doc, position, position, doc
    (``ms`` the faster), and the device time a launch from a profiler
    trace (``device_ms``, with the launches the trace held)."""
    K, cap, L = args[3].shape[1], args[5].shape[1], args[1].shape[1]
    lays = KS.fitting_layouts(K, cap, L)
    runs = {lay: (lambda lay=lay: KS._mh_sweep(*args, steps=SPARSE_STEPS, mode=mode,
                                               layout=lay)) for lay in lays}
    ev = {lay: [] for lay in lays}
    for lay in (*lays, *reversed(lays)):
        ev[lay].append(cuda_ms(runs[lay], reps=reps))
    out = {}
    for lay in lays:
        ms, n = s1_device_per_launch(runs[lay], reps)
        out[lay] = {"ms": min(ev[lay]), "events_ms": ev[lay], "device_ms": ms,
                    "launches_seen": n}
    return out


def s1_timing(dev, seed) -> dict:
    """S1's times at the corpus, 2 steps, cap 64, K = 240, 1,024 and
    2,048 with cdf and alias_device tables: each layout's event and device
    times (:func:`_s1_times`) beside its bound, and the plain version's
    time at K = 240, cdf.  Each K's inputs come from a generator seeded
    ``seed + 70 + K``.  -> phase 7's S1 record for the ``kernels`` line."""
    corpus = paper_corpus(seed, CONFIG.M, CONFIG.V)
    seed2 = rng.fold(rng.seed_from_key([seed, 70]), rng.TAG_SPARSE_MH)
    K, L = CONFIG.K, corpus.docs.shape[1]
    by_k, pms = {}, None
    for Kt in SPARSE_KS:
        inp = sparse_inputs(corpus, dev, torch.Generator(device=dev).manual_seed(
            seed + 70 + Kt), Kt, 64)
        for mode in ("cdf", "alias_device"):
            tabs = sparse_tables(inp[4], mode)
            a = (*inp, *tabs, seed2, 0, 0.1)
            t = _s1_times(a, mode)
            zt = KS.mh_sweep(*a, steps=SPARSE_STEPS, mode=mode)[0]
            t["bound"] = b = s1_bound(inp, zt, tabs, SPARSE_STEPS, mode)
            if (Kt, mode) == (K, "cdf"):
                pms = cuda_ms(lambda: sparse_ref.mh_sweep_torch(
                    *a, steps=SPARSE_STEPS, cap=64, mode="cdf", chunk=SPARSE_PLAIN_CHUNK),
                    reps=3, warmup=1)
            by_k[f"K={Kt} {mode}"] = t
            log(f"  sparse_mh K={Kt} {mode} (steps={SPARSE_STEPS}, cap 64): "
                + ", ".join(f"{lay} events {t[lay]['events_ms']} device "
                            f"{t[lay]['device_ms']} ({t[lay]['launches_seen']} launches "
                            "in the trace)" for lay in KS.LAYOUTS if lay in t)
                + f"; bound {b['bound_ms']:.5f} ms ({b['bound_by']}; int32 "
                f"{b['int32_ms']:.5f}, fp32 rate {b['fp32_ms']:.5f}, bytes "
                f"{b['bytes_ms']:.5f})")
            del tabs, a
        del inp
    main = by_k[f"K={K} cdf"]
    lay = KS.mh_layout(K, 64, L)
    bound = main["bound"]
    log(f"  sparse_mh (K={K}, cdf, {lay}) {main[lay]['ms']:.4f} ms, position "
        f"{main['position']['ms']:.4f} ms, plain {pms:.4f} ms, bound "
        f"{bound['bound_ms'] * 1e3:.2f} us ({bound['bound_by']}); library: none (no "
        "PyTorch call runs an MH sweep)")
    return {"ms": main[lay]["ms"], "device_ms": main[lay]["device_ms"], "plain_ms": pms,
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
            "bound_int32_ms": bound["int32_ms"], "bound_fp32_ms": bound["fp32_ms"],
            "bound_bytes_ms": bound["bytes_ms"], "library_ms": None,
            "alias_ms": by_k[f"K={K} alias_device"][lay]["ms"], "layout": lay,
            "position_ms": main["position"]["ms"],
            "position_device_ms": main["position"]["device_ms"], "by_K": by_k,
            "shape": [CONFIG.M, L, K, 64], "steps": SPARSE_STEPS}


def phase_sparse_profile(dev, seed) -> dict:
    """``--sparse-profile``, run by :func:`sparse_profile_fresh` in a
    process of its own: S1's times (:func:`s1_timing`), then the sparse
    cdf sweep at K = 240 profiled after one unprofiled sweep."""
    timing = s1_timing(dev, seed)
    corpus = paper_corpus(seed, CONFIG.M, CONFIG.V)
    dev_corpus = corpus_mod.Corpus(docs=torch.as_tensor(corpus.docs, device=dev),
                                   lengths=corpus.lengths,
                                   mask=torch.as_tensor(corpus.mask, device=dev),
                                   vocab_size=corpus.vocab_size)
    state = gibbs.init_state(seed, dev_corpus, CONFIG.K, device=dev)
    cache = lsp.SparseSweepCache()
    state = gibbs.gibbs_step(state, dev_corpus, sparse=True, sparse_cache=cache)
    prof = phase_profile(state, dev_corpus, "auto", None, label="sparse (cdf), fresh process",
                         sparse=True, sparse_cache=cache)[1]
    return {"timing": timing, "profile": prof}


def sparse_profile_fresh(seed: int) -> dict:
    """:func:`phase_sparse_profile` in a process of its own (this script
    with ``--sparse-profile``, waited for): late in this process a
    profiler trace loses kernels, S1's among them, where a fresh process's
    trace holds them all (PERF.md §7).  Its log is relayed."""
    cmd = [sys.executable, str(Path(__file__).resolve()), "--sparse-profile", "--seed",
           str(seed)]
    # the card's memory that this process's allocator holds unused goes back,
    # so that the fresh process finds room
    reserved = torch.cuda.memory_reserved()
    torch.cuda.empty_cache()
    log(f"  fresh process: this one holds {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"({reserved / 2**30:.2f} GiB reserved before empty_cache)")
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=900, cwd=str(ROOT))
    lines = out.stdout.strip().splitlines()
    for line in lines[:-1]:
        log("  | " + line)
    if out.returncode != 0 or not lines:
        raise RuntimeError(f"--sparse-profile failed ({out.returncode}):\n"
                           f"{out.stdout[-4000:]}\n{out.stderr[-4000:]}")
    return json.loads(lines[-1])


def phase_sparse_kernel(corpus, dev, seed, tally):
    """Phase 7a: S1 in each layout against its plain version at the full
    corpus, K = 240, in each word-proposal mode, steps 1 and 4, cap 8
    (truncating) and 64; then edge inputs (documents masked out, every
    document masked, row counters that wrap at 2**32, cap 1 and cap = K,
    a doc proposal exactly at K alpha and exactly on a cc value, L = 307
    positions, K = 2,048, and K = 16,384 where the rule takes "position").
    S1's times are taken in a fresh process (:func:`s1_timing`)."""
    K = CONFIG.K
    g = torch.Generator(device=dev).manual_seed(seed + 70)
    log(f"phase 7a: sparse MH sweep (S1) vs plain at M={corpus.docs.shape[0]} x "
        f"L={corpus.docs.shape[1]}, K={K}, V={corpus.vocab_size}")
    seed2 = rng.fold(rng.seed_from_key([seed, 70]), rng.TAG_SPARSE_MH)
    res = {}
    inp64 = sparse_inputs(corpus, dev, g, K, 64)
    doc_topic = lsp._counts_scatter(*inp64[:3], K, corpus.vocab_size)[0]
    inp8 = inp64[:5] + list(lsp.sparse_counts(doc_topic, 8))
    support = (doc_topic > 0).sum(1)
    log(f"  documents whose support exceeds cap: {int((support > 8).sum())} (cap 8), "
        f"{int((support > 64).sum())} (cap 64); S1's layout at the corpus: "
        f"{KS.mh_layout(K, 64, corpus.docs.shape[1])}")
    for mode in SPARSE_MODES:
        tables = sparse_tables(inp64[4], mode)
        for steps in (1, 4):
            for cap, inp in ((8, inp8), (64, inp64)):
                case = f"{mode} steps={steps} cap={cap}"
                res[case] = check_s1(tally, case, inp, tables, seed2, 0, steps, mode)
    # edge inputs: documents masked out, counters near 2**32, K = 2,048
    masked = [x.clone() for x in inp64]
    masked[2][::7] = False
    res["masked rows"] = check_s1(tally, "cdf masked rows", masked,
                                  sparse_tables(masked[4], "cdf"), seed2, 0, 2, "cdf")
    res["wrap"] = check_s1(tally, "alias row0 wraps 2**32", inp64,
                           sparse_tables(inp64[4], "alias"), seed2, 2**32 - 9000, 2,
                           "alias")
    inp_k = sparse_inputs(corpus, dev, g, 2048, 64, M=8192)
    for mode in ("cdf", "alias_device"):
        res[f"K=2048 {mode}"] = check_s1(tally, f"K=2048 M=8192 {mode}", inp_k,
                                         sparse_tables(inp_k[4], mode), seed2, 0, 2, mode)
    del inp_k
    # the doc layout's edges: every document masked, cap 1 and cap = K,
    # the doc proposal exactly at K alpha and on a cc value, long documents
    cdf = sparse_tables(inp64[4], "cdf")
    dead = [x.clone() for x in inp64]
    dead[2].zero_()
    res["all masked"] = check_s1(tally, "cdf every document masked", dead, cdf, seed2, 0,
                                 2, "cdf")
    if res["all masked"]["changed"] or res["all masked"]["proposals"]:
        raise AssertionError(f"S1 moved masked positions: {res['all masked']}")
    for cap in (1, K):
        inp_c = inp64[:5] + list(lsp.sparse_counts(doc_topic, cap))
        res[f"cap={cap}"] = check_s1(tally, f"cdf steps=2 cap={cap}", inp_c, cdf, seed2, 0,
                                     2, "cdf")
    for kind in ("t=Ka", "x=cc"):
        inp_e, row0, alpha = s1_exact_inputs(dev, seed2, kind)
        for mode in ("cdf", "alias"):
            res[f"{kind} {mode}"] = check_s1(tally, f"{kind} {mode} steps=1", inp_e,
                                             sparse_tables(inp_e[4], mode), seed2, row0, 1,
                                             mode, alpha=alpha)
    long_corpus = paper_corpus(seed + 71, 4096, CONFIG.V, avg_len=250)
    inp_l = sparse_inputs(long_corpus, dev, g, K, 64)
    for mode in ("cdf", "alias"):
        res[f"L={inp_l[0].shape[1]} {mode}"] = check_s1(
            tally, f"L={inp_l[0].shape[1]} M=4096 {mode}", inp_l,
            sparse_tables(inp_l[4], mode), seed2, 2**32 - 70000, 2, mode)
    del inp_l
    inp_big = sparse_inputs(corpus, dev, g, 16384, 64, M=256)
    if KS.mh_layout(16384, 64, inp_big[0].shape[1]) != "position":
        raise AssertionError("S1's rule should take the position layout at K = 16,384")
    res["K=16384"] = check_s1(tally, "K=16384 M=256 cdf (position only)", inp_big,
                              sparse_tables(inp_big[4], "cdf"), seed2, 0, 2, "cdf")
    del inp_big
    return res


def sparse_sweeps(corpus, dev, seed, K, n, **kw):
    """``n`` ``gibbs_step(sparse=True, ...)`` sweeps from a fresh state and
    cache, timed: (state, seconds, cache)."""
    state = gibbs.init_state(seed, corpus, K, device=dev)
    cache = lsp.SparseSweepCache()
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = gibbs.gibbs_step(state, corpus, sparse=True, sparse_cache=cache, **kw)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return state, times, cache


def phase_sparse(corpus, dev, seed):
    """Phase 7b: at K = 240, 1,024 and 2,048, 3 ``gibbs_step(sparse=True)``
    sweeps each with ``word_proposal`` cdf, alias_device and auto (S1 once a
    sweep; K13 once a sweep where the tables are alias_device), one
    ``sparse="auto"`` sweep (the tuner's pick), and 3 sweeps of the dense
    default beside them, each path's launches read around it; then, in a
    fresh process, S1's times and the sparse sweep (cdf, K = 240)
    profiled."""
    from repro_torch import autotune

    M, maxN = corpus.docs.shape
    V, tokens = corpus.vocab_size, corpus.total_words
    nchunks = -(-M // 256)
    res, launches = {}, {}
    for K in SPARSE_KS:
        log(f"phase 7b: sparse sweeps at K={K} (M={M}, V={V}, {tokens} tokens)")
        r = res[K] = {}
        for wp in ("cdf", "alias_device", "auto"):
            mode = lsp.resolve_word_proposal(wp, K, V, tokens * SPARSE_STEPS, dev.type)
            # each path starts from the same state: its tables are built anew
            autotune.get_table_cache().clear()
            torch.cuda.synchronize()
            reset_counts()
            state, times, cache = sparse_sweeps(corpus, dev, seed, K, 3, word_proposal=wp)
            counts = read_counts()
            expect = {"sparse_mh": 3, **({"alias_assemble": 3}
                                         if mode == "alias_device" else {})}
            check_path(f"sparse sweep K={K} {wp} ({mode})", counts, expect)
            check_state(state, K)
            ppl = gibbs.perplexity(state, corpus)
            if not np.isfinite(ppl):
                raise AssertionError(f"sparse sweep K={K} {wp}: perplexity not finite")
            log(f"  sparse {wp:12s} -> {mode:12s} seconds per sweep {times}; accept "
                f"rates {cache.last_stats}; caps {cache.caps_history}; perplexity "
                f"{ppl:.2f}")
            r[wp] = {"tables": mode, "sweep_s": times, "stats": cache.last_stats,
                     "caps": cache.caps_history, "perplexity": ppl, "launches": counts}
            add_counts(launches, counts)
        # sparse="auto": the tuner arbitrates dense against sparse
        ra = resolution(tokens, K, factored=True, sparse=True)
        dense_auto = resolution(256 * maxN, K, has_key=False, factored=True)
        state = gibbs.init_state(seed, corpus, K, device=dev)
        torch.cuda.synchronize()
        reset_counts()
        t = step_seconds(lambda: gibbs.gibbs_step(state, corpus, sparse="auto"), 1)
        counts = read_counts()
        expect = ({"sparse_mh": 1} if ra["method"] in autotune.SPARSE_METHODS
                  else auto_expect(dense_auto["method"], nchunks))
        check_path(f"sparse='auto' K={K} -> {ra['method']}", counts, expect)
        log(f"  sparse='auto' resolves to {ra}: {t} s")
        r["sparse_auto"] = {"resolved": ra, "sweep_s": t, "launches": counts}
        add_counts(launches, counts)
        # the dense default beside them
        state = gibbs.init_state(seed, corpus, K, device=dev)
        torch.cuda.synchronize()
        reset_counts()
        state, times = sweep_seconds(state, corpus, "auto", None, 3)
        counts = read_counts()
        check_path(f"dense default K={K} -> {dense_auto['method']}", counts,
                   auto_expect(dense_auto["method"], 3 * nchunks))
        check_state(state, K)
        log(f"  dense default ({dense_auto['method']} W={dense_auto['W']}) seconds per "
            f"sweep {times}")
        r["dense_default"] = {"resolved": dense_auto, "sweep_s": times, "launches": counts}
        add_counts(launches, counts)
        del state
        autotune.get_table_cache().clear()
    # S1's times and the profiled sparse sweep, in a fresh process; the
    # trace's S1 count against the one launch a sweep
    fresh = sparse_profile_fresh(seed)
    res["profile"], res["s1_timing"] = fresh["profile"], fresh["timing"]
    log(f"  profile: the trace holds S1 x{res['profile']['launches']['sparse_mh']} of 1 "
        f"launch, {res['profile']['launches']['kernels']} kernels")
    return launches, res


def phase_streaming(dev, seed):
    """Phase 7c: ``StreamingSparseLDA`` over ``zipf_shard_source`` (the
    Wikipedia corpus's vocabulary, length mean and cap; K = 240), 2 sweeps,
    S1 once a shard."""
    src = corpus_mod.zipf_shard_source(seed, num_docs=STREAM_DOCS, V=CONFIG.V, K=CONFIG.K,
                                       shard_docs=STREAM_SHARD_DOCS, avg_len=70.5,
                                       max_len=307)
    eng = lsp.StreamingSparseLDA(seed, src, K=CONFIG.K, mh_steps=SPARSE_STEPS, cap=64,
                                 device=dev)
    torch.cuda.synchronize()
    reset_counts()
    stats = [eng.sweep() for _ in range(2)]
    counts = read_counts()
    check_path(f"streaming sparse ({src.num_shards} shards x {STREAM_SHARD_DOCS} docs)",
               counts, {"sparse_mh": 2 * src.num_shards})
    for s in stats:
        if not (np.isfinite(s["perplexity"]) and 0 < s["doc_accept_rate"] <= 1):
            raise AssertionError(f"streaming sparse sweep: {s}")
    log(f"phase 7c: streaming sparse LDA, {STREAM_DOCS} docs in {src.num_shards} shards of "
        f"{STREAM_SHARD_DOCS}, V={CONFIG.V}, K={CONFIG.K}: {stats}")
    return counts, {"num_docs": STREAM_DOCS, "shards": src.num_shards, "sweeps": stats,
                    "launches": counts}


# phase 8: serving gemma2-9b at full width and depth (the model card's
# truncation, greedy, min-p and top-k 1 in turns)
SERVE_MIXES = (("model card", dict(top_k=64, top_p=0.95)), ("greedy", dict(temperature=0.0)),
               ("min-p 0.05", dict(min_p=0.05)), ("top-k 1", dict(top_k=1)))
SERVE_REQUESTS, SERVE_SOLO = 16, 4      # requests served; of them, rerun alone
SERVE_PROMPT, SERVE_NEW = (1, 120), (16, 48)
GEN_B, GEN_S, GEN_NEW = 64, 32, 8       # generate: prompts, prompt length, new tokens


def serve_requests(seed: int, V: int) -> list:
    """The phase's requests, made anew from ``seed`` on every call (a
    Request is the engine's to fill)."""
    rng = np.random.default_rng(seed + 80)
    out = []
    for i in range(SERVE_REQUESTS):
        plen = int(rng.integers(SERVE_PROMPT[0], SERVE_PROMPT[1] + 1))
        new = int(rng.integers(SERVE_NEW[0], SERVE_NEW[1] + 1))
        out.append(serve.Request(prompt=rng.integers(0, V, plen).astype(np.int32),
                                 max_new_tokens=new, seed=seed * 1000 + i,
                                 sampling=serve.SamplingParams(**SERVE_MIXES[i % 4][1])))
    return out


def serve_expect(method: str, draws: int, S: int = 1) -> dict:
    """The launches a plan's method implies for ``draws`` truncated draw
    calls: K9 each (K11 + K12 for several tokens a row) for ``kernel`` /
    ``kernel_trunc``, K1 for ``butterfly``; none for the plain methods."""
    if method in ("kernel", "kernel_trunc"):
        return ({"fused_trunc_draw": draws} if S == 1
                else {"masked_blocksums": draws, "walk_trunc": draws})
    return {"butterfly_table": draws} if method == "butterfly" else {}


def _pct(xs, q) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), q))


def _argmax_faults(rec) -> dict:
    """Greedy and top-k 1 rows: each token is its row's argmax, or a token
    whose logit equals the maximum (a tie)."""
    got = torch.cat([r[0] for r in rec]).long()
    am = torch.cat([r[1] for r in rec]).long()
    lg_got = torch.cat([r[2] for r in rec])
    lg_max = torch.cat([r[3] for r in rec])
    mis = got != am
    ties = mis & (lg_got == lg_max)
    return {"rows": int(got.numel()), "mismatches": int(mis.sum()), "ties": int(ties.sum())}


SERVE_PROFILE_STEPS = 3


def device_profile(fn, n: int, label: str, count: str = "") -> dict:
    """``fn()`` ``n`` times under torch.profiler, tracing the card only (a
    trace of the host's ops takes longer to read than the calls take to
    run): wall and device-busy seconds a call, the busy share, device ops
    a call (kernels, copies and sets) and the ten largest; ``count``: how
    many device ops whose name holds it the trace kept.  Late in this
    script's process a trace may lose kernels (PERF.md §7): the busy share
    and the op count are then lower bounds, and ``count`` says whether the
    trace held a kernel whose launches are known."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                  reverse=True)
    if not rows:
        raise AssertionError(f"{label}: the trace holds no device op")
    busy = sum(r[0] for r in rows) / 1e6
    out = {"calls": n, "wall_s": wall / n, "device_busy_s": busy / n, "busy_share": busy / wall,
           "ops_per_call": sum(c for _, c, _ in rows) / n,
           "trace_s": time.perf_counter() - t0,
           "top": [{"ms": us / 1e3 / n, "count": c / n, "name": k[:120]}
                   for us, c, k in rows[:10]]}
    if count:
        out["counted"] = sum(c for _, c, k in rows if count in k)
    log(f"  profiled {label} ({n} calls): wall {out['wall_s']:.5f} s a call, device busy "
        f"{out['device_busy_s']:.5f} s ({100 * out['busy_share']:.1f}%), "
        f"{out['ops_per_call']:.0f} device ops a call (trace read in {out['trace_s']:.1f} s)"
        + (f"; '{count}' ops in the trace: {out['counted']} of {n}" if count else ""))
    for t in out["top"]:
        log(f"  {t['ms']:9.4f} ms  x{t['count']:<7.1f} {t['name'][:90]}")
    return out


def serve_profile(model, params, requests) -> dict:
    """SERVE_PROFILE_STEPS decode steps of a fresh engine with every slot
    live (the first ``max_slots`` of ``requests``), profiled."""
    eng = serve.ContinuousBatchingEngine(model, params)
    for r in requests[:eng.max_slots]:
        eng.submit_nowait(r)
    while eng.scheduler.waiting_depth:
        eng._admit()
        eng.step_once()

    def step():
        if eng.step_once() != eng.max_slots:
            raise AssertionError("the profiled steps need every slot live")

    out = device_profile(step, SERVE_PROFILE_STEPS,
                         f"decode step at {eng.max_slots} live slots", count="trunc_draw")
    del eng
    return out


# the wrappers that the draw entry points (kernels.butterfly_sample.ops)
# call by name: K2, K3, K9, K11, K12
DRAW_WRAPPERS = ("blocksums", "walk", "fused_trunc_draw", "masked_blocksums", "walk_trunc")
# phase 11's seeded per-shard draw: K10 (generate on a mesh under the
# config's truncation)
SHARD_WRAPPERS = ("fused_trunc_draw_rng",)


@contextlib.contextmanager
def captured_draws(names=DRAW_WRAPPERS):
    """Inside, the first call that ``ops`` makes of each wrapper of
    ``names`` is recorded, ``cap[name] = (args, out)``, ``out`` cloned
    before the caller clamps it in place.  The launch and its count stay
    the wrapper's own."""
    cap = {}
    real = {n: getattr(bops, n) for n in names}

    def wrap(name):
        def call(*args, **kw):
            out = real[name](*args, **kw)
            if name not in cap:
                cap[name] = (args, out.clone())
            return out
        return call

    for n in names:
        setattr(bops, n, wrap(n))
    try:
        yield cap
    finally:
        for n, fn in real.items():
            setattr(bops, n, fn)


def check_captured(tally, case: str, cap: dict, counts: dict) -> None:
    """Hold the launches that captured_draws recorded on a main path
    against their kernels' plain versions on the same inputs.  Every
    wrapper launched there (``counts``) must have been recorded.  Running
    sums within their fp32 adds (K11 also bit-equal to its exact-order
    model); draws equal, or float64-checked ties."""
    names = [n for n in DRAW_WRAPPERS + SHARD_WRAPPERS if counts.get(n)]
    missing = [n for n in names if n not in cap]
    if missing:
        raise AssertionError(f"{case}: no launch of {missing} was recorded")
    for name in names:
        args, out = cap[name]
        if name == "blocksums":
            w, W, nb = args
            tally.running(name, f"{case} K2", out, KB.blocksums_torch(w, W, nb), False)
        elif name == "walk":
            w, run, u, rows, W = args
            plain = KB.walk_torch(w, KB.blocksums_torch(w, W, run.shape[1]), u, rows, W)
            tally.weights(name, f"{case} K3", out, plain, w.float(), u, False)
        elif name == "fused_trunc_draw":
            w, u, prm, W, iters = args
            tally.trunc(name, f"{case} K9", out, KB.fused_trunc_draw_torch(w, u, prm, W, iters),
                        w, u, prm, False)
        elif name == "masked_blocksums":
            w, tau, W, nb = args
            tally.running(name, f"{case} K11", out, KB.masked_blocksums_torch(w, tau, W, nb),
                          False, rel_tol=(W + nb) * 2.0 ** -23)
            tally.same(name, f"{case} K11 vs warp order", out,
                       masked_blocksums_warp_order_torch(w, tau, W, nb))
        elif name == "fused_trunc_draw_rng":
            w, s2, r0, prm, W, iters = args
            u = rng.row_uniforms(s2.to(w.device), r0, w.shape[0])
            tally.trunc(name, f"{case} K10", out,
                        KB.fused_trunc_draw_rng_torch(w, s2, r0, prm, W, iters), w, u, prm,
                        False)
        else:
            w, run, u, tau, rows, W = args
            plain = KB.walk_trunc_torch(w, KB.masked_blocksums_torch(w, tau, W, run.shape[1]),
                                        u, tau, rows, W)
            tally.weights(name, f"{case} K12", out, plain, KB._mask(w.float(), tau), u, False)


def serve_engine(label: str, model, params, requests, solo, tally, dev) -> tuple:
    """``model`` through ``ContinuousBatchingEngine`` at ``ServeSpec``
    defaults, its decode traced.  ``requests()`` (a fresh list on each
    call) is served: every request finishes, every token lies in [0, V),
    every step's logits are finite, greedy and top-k 1 rows are the
    argmax, and one full step's truncated draw (K9) is held to its plain
    version.  ``solo`` names the first requests' mixes; each of them runs
    again alone in a fresh engine and must give its batched tokens.  Then
    a profiled window with every slot live.  Returns (launches, result)."""
    cfg = model.cfg
    V, Vp = cfg.vocab_size, cfg.padded_vocab
    eng, trace = traced_engine(model, params, dev)
    log(f"  engine: {eng.max_slots} slots, max_len {eng.max_len}, prefill_chunk "
        f"{eng.prefill_chunk}; plan ({eng.max_slots}, {Vp}) method={eng.plan.method} "
        f"W={eng.plan.W}")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = eng.run(requests())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    st = eng.stats()
    check_path(f"{label} engine ({eng.max_slots}, {Vp}) method={eng.plan.method}", counts,
               serve_expect(eng.plan.method, st["steps"]))
    for r in out:
        if r.state is not serve.RequestState.FINISHED or len(r.output_tokens) != r.max_new_tokens:
            raise AssertionError(f"{label}: request {r.id} did not finish: {r.state} "
                                 f"{len(r.output_tokens)}/{r.max_new_tokens}")
        if not all(0 <= t < V for t in r.output_tokens):
            raise AssertionError(f"{label}: request {r.id}: a token outside [0, {V})")
    if not bool(trace["finite"]):
        raise AssertionError(f"{label}: non-finite logits in a decode step")
    am = _argmax_faults(trace["rec"])
    log(f"  greedy and top-k 1 rows: {am}")
    if am["mismatches"] != am["ties"] or not am["rows"]:
        raise AssertionError(f"{label}: a greedy or top-k 1 row is not the argmax: {am}")
    # the recycling invariant: alone in a fresh engine, the same tokens
    solo_counts = {}
    for i, mix in enumerate(solo):
        one = serve.ContinuousBatchingEngine(model, params)
        torch.cuda.synchronize()
        reset_counts()
        r = one.run([requests()[i]])[0]
        c = read_counts()
        check_path(f"{label} engine, request {i} alone", c,
                   serve_expect(one.plan.method, one.stats()["steps"]))
        add_counts(solo_counts, c)
        if r.output_tokens != out[i].output_tokens:
            raise AssertionError(f"{label} request {i} ({mix}): alone {r.output_tokens} != "
                                 f"batched {out[i].output_tokens}")
        del one
    log(f"  recycling: {len(solo)} requests alone equal their batched tokens "
        f"({list(solo) or 'not checked'})")
    profile = serve_profile(model, params, sorted(requests(), key=lambda r: -r.max_new_tokens))
    # one full step's draw against the plain version
    cap = trace["capture"]
    if not cap:
        raise AssertionError(f"{label}: no step ran with every slot live")
    a = KB.fused_trunc_draw(cap["w"], cap["u"], cap["kpm"], eng.plan.W)
    tally.trunc("fused_trunc_draw", f"{label} step ({eng.max_slots},{Vp})", a,
                KB.fused_trunc_draw_torch(cap["w"], cap["u"], cap["kpm"], eng.plan.W),
                cap["w"], cap["u"], cap["kpm"], False)
    tally.same("fused_trunc_draw", f"{label} step, the engine's draw", cap["out"],
               a.clamp(max=Vp - 1))
    full = [x["dt"] for x in eng.step_times if x["active"] == eng.max_slots]
    draw_ms = [e0.elapsed_time(e1) for e0, e1 in trace["draw_ev"]]
    buckets = {}
    for x in eng.prefill_times:
        buckets.setdefault(x["bucket"], []).append(x["dt"])
    res = {
        "method": eng.plan.method, "W": eng.plan.W, "slots": eng.max_slots,
        "max_len": eng.max_len, "requests": len(out), "steps": st["steps"],
        "tokens": st["tokens_out"], "wall_s": wall, "tokens_per_s": st["tokens_out"] / wall,
        "steps_at_full": len(full), "step_s_median": _pct(full, 50), "step_s_p90": _pct(full, 90),
        "step_s_full": full, "draw_ms_median": _pct(draw_ms, 50), "draw_ms_p90": _pct(draw_ms, 90),
        "prefill_s_by_bucket": {b: {"n": len(v), "median": _pct(v, 50)}
                                for b, v in sorted(buckets.items())},
        "argmax_rows": am, "solo_equal": list(solo), "launches": counts,
        "solo_launches": solo_counts, "profile": profile,
    }
    log(f"  {label} engine: {st['steps']} decode steps, {st['tokens_out']} tokens in {wall:.3f} s "
        f"({res['tokens_per_s']:.1f} tokens/s); seconds a step at {eng.max_slots} live "
        f"slots ({len(full)} steps): median {res['step_s_median']:.5f}, p90 "
        f"{res['step_s_p90']:.5f}; the truncated draw in the step (CUDA events): median "
        f"{res['draw_ms_median']:.4f} ms, p90 {res['draw_ms_p90']:.4f} ms")
    log(f"  prefill seconds by bucket: "
        f"{ {b: round(v['median'], 5) for b, v in res['prefill_s_by_bucket'].items()} }")
    launches = dict(counts)
    add_counts(launches, solo_counts)
    del eng, trace, cap
    return launches, res


def num_samples_step(label: str, model, params, batch, prefill_len: int, dev, seed: int,
                     tally, sp) -> dict:
    """One ``make_decode_step(num_samples=4)`` call truncated by ``sp`` on
    the prefilled ``batch``: K11 + K12 once, held to their plain versions
    on the step's own weights, tau and uniforms; finite logits; every
    candidate within its row's top-k and below ``vocab_size``."""
    cfg = model.cfg
    last, caches = model.prefill(params, batch)
    caches = _pad_caches_to(caches, prefill_len + 1)
    B = last.shape[0]
    dstep = serve.make_decode_step(model, batch_size=B, num_samples=4, sampling_params=sp)
    torch.cuda.synchronize()
    reset_counts()
    with captured_draws() as cap:
        cand, logits, _ = dstep(params, caches, last.argmax(-1).to(torch.int32)[:, None],
                                prefill_len, torch.Generator(device=dev).manual_seed(seed))
    counts = read_counts()
    dplan = _logits_plan(cfg, B, logits.shape[1], str(logits.dtype)[6:], draws=4,
                         transforms=_sp_sig(sp), backend=dev.type)   # the step's own plan
    case = f"{label} decode step ({B},{cfg.padded_vocab}) num_samples=4"
    check_path(f"{case} method={dplan.method}", counts, serve_expect(dplan.method, 1, S=4))
    check_captured(tally, f"{label} num_samples=4", cap, counts)
    V = cfg.vocab_size
    if not (torch.isfinite(last[:, :V]).all() and torch.isfinite(logits[:, :V]).all()):
        raise AssertionError(f"{case}: non-finite logits")
    # the top-k test in the weights the draw truncates (bf16 logits round
    # to tied weights)
    wts = sampling.logits_to_weights(logits, 1.0).float()
    kth = torch.sort(wts, dim=1, descending=True).values[:, sp.top_k - 1:sp.top_k]
    if cand.shape != (B, 4) or not bool((torch.gather(wts, 1, cand.long()) >= kth).all()) \
            or int(cand.max()) >= V:
        raise AssertionError(f"{case}: shape {tuple(cand.shape)} or a token outside its "
                             "row's top-k")
    return counts


def phase_serving(dev, seed, tally):
    """Phase 8: gemma2-9b's ``CONFIG`` (42 layers, d_model 3,584, V =
    256,000) with bfloat16 parameters from ``init_params`` on the card and
    float32 caches.  (a) ``serve_engine`` over SERVE_REQUESTS requests,
    SERVE_SOLO of them again alone.  (b) ``generate`` over GEN_B prompts
    (its first draw held to the plain version) and one
    ``make_decode_step(num_samples=4)`` call (K11 + K12), both under the
    model card's truncation."""
    cfg = gemma2_9b.CONFIG
    V = cfg.vocab_size
    model = build_model(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(torch.Generator(device=dev).manual_seed(seed + 81), model.specs,
                         torch.bfloat16, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = param_count(model.specs)
    log(f"phase 8: serving {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"head_dim {cfg.resolved_head_dim}, d_ff {cfg.d_ff}, V={V}; {n_params} bfloat16 "
        f"parameters made in {init_s:.2f} s")
    launches, res = serve_engine("phase 8", model, params, lambda: serve_requests(seed, V),
                                 [m for m, _ in SERVE_MIXES[:SERVE_SOLO]], tally, dev)
    res.update(config=cfg.name, params=n_params, init_s=init_s)

    # (b) generate over GEN_B prompts, the model card's truncation
    g = torch.Generator(device=dev).manual_seed(seed + 82)
    toks = torch.randint(0, V, (GEN_B, GEN_S), generator=g, device=dev, dtype=torch.int32)
    sp0 = serve.default_sampling_params(cfg)
    gplan = sampling.plan((GEN_B, V), method=cfg.sampler_spec.method, dtype="bfloat16",
                          transforms=tr.signature(sp0.transforms()), backend=dev.type)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with captured_draws() as cap:
        gen = serve.generate(model, params, {"tokens": toks}, max_new_tokens=GEN_NEW,
                             generator=g)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    counts = read_counts()
    check_path(f"generate ({GEN_B},{V}) method={gplan.method}", counts,
               serve_expect(gplan.method, GEN_NEW))
    check_captured(tally, f"phase 8 generate ({GEN_B},{V})", cap, counts)
    add_counts(launches, counts)
    if gen.tokens.shape != (GEN_B, GEN_NEW) or not ((gen.tokens >= 0) & (gen.tokens < V)).all():
        raise AssertionError(f"generate: tokens of shape {gen.tokens.shape} or out of range")
    res["generate"] = {"B": GEN_B, "prompt": GEN_S, "new": GEN_NEW, "method": gplan.method,
                       "seconds": gen_s, "launches": counts}
    log(f"  generate: {GEN_B} prompts of {GEN_S} tokens, {GEN_NEW} new, plan method="
        f"{gplan.method} W={gplan.W}: {gen_s:.3f} s")
    # one decode step drawing four candidate tokens a row
    counts = num_samples_step("phase 8", model, params, {"tokens": toks[:8]}, GEN_S, dev,
                              seed + 83, tally, sp0)
    add_counts(launches, counts)
    res["decode_num_samples_4"] = {"B": 8, "launches": counts}
    res["peak_bytes"] = torch.cuda.max_memory_allocated()
    log(f"  peak device memory {res['peak_bytes'] / 2**30:.3f} GiB")
    del params, cap
    free_device()
    return launches, res


def traced_engine(model, params, dev, **kw):
    """An engine whose decode and draw are traced: ``trace["rec"]`` holds,
    for every step, the greedy and top-k 1 rows' (drawn, argmax, logit of
    the drawn, max logit); ``"draw_ev"`` the truncated draw's CUDA events
    at every step with all slots live; ``"capture"`` the first such step's
    (w, u, kpm, out); ``"finite"`` whether every step's logits over the
    real vocabulary were finite (a device flag, read once at the end)."""
    V = model.cfg.vocab_size
    trace = {"rec": [], "draw_ev": [], "capture": {}, "finite": None}
    held = {}

    def decode(p, c, t, pos):
        logits, c = model.decode(p, c, t, pos)
        held["logits"] = logits
        ok = torch.isfinite(logits[:, :V]).all()
        trace["finite"] = ok if trace["finite"] is None else trace["finite"] & ok
        return logits, c

    eng = serve.ContinuousBatchingEngine(model._replace(decode=decode), params, **kw)
    real_draw, real_step = eng._draw, eng._step

    def draw(w, u, kpm):
        full = bool(eng._active.all())
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = real_draw(w, u, kpm)
        e1.record()
        if full:
            trace["draw_ev"].append((e0, e1))
            if not trace["capture"]:
                trace["capture"].update(w=w.clone(), u=u.clone(), kpm=kpm.clone(),
                                        out=out.clone())
        return out

    def step(*args):
        greedy = [int(s) for s in np.nonzero(eng._active)[0]
                  if eng._temp[s] == 0 or eng._kpm[s, 0] == 1]
        idx = torch.as_tensor(greedy, dtype=torch.long, device=dev)
        nxt = real_step(*args)
        if greedy:
            lg = held["logits"][idx].float()
            got = nxt[idx].long()
            trace["rec"].append((got, lg.argmax(-1), lg.gather(1, got[:, None])[:, 0],
                                 lg.max(-1).values))
        return nxt

    eng._draw, eng._step = draw, step
    return eng, trace


# phase 9: the other model families at full width (slices 12b and 12c)
FAMILY_ENGINE = ("minicpm3-4b", "granite-moe-1b-a400m", "mamba2-370m", "hymba-1.5b")
FAMILY_GENERATE = ("pixtral-12b", "seamless-m4t-medium", "arctic-480b")
FAMILY_MIXES = (("plain", {}), ("top-p 0.9", dict(top_p=0.9)), ("top-k 20", dict(top_k=20)),
                ("top-k 1", dict(top_k=1)), ("greedy", dict(temperature=0.0)))
FAMILY_REQUESTS, FAMILY_SOLO = 16, 4
FAMILY_PROMPT, FAMILY_NEW = (1, 40), (16, 28)
FAMILY_SOLO_NEW = (6, 12)                      # the requests also run alone are short
FAMILY_GEN = dict(B=4, S=32, new=16, src=64)   # generate: prompts, length, new, enc-dec frames
ARCTIC_LAYERS = 1                              # of 35: the depth cut that fits one card
FAMILY_TRUNC = dict(top_k=20, top_p=0.9)       # the num_samples=4 step's truncation


def family_requests(seed: int, V: int) -> list:
    rng = np.random.default_rng(seed + 90)
    out = []
    for i in range(FAMILY_REQUESTS):
        plen = int(rng.integers(FAMILY_PROMPT[0], FAMILY_PROMPT[1] + 1))
        lo, hi = FAMILY_SOLO_NEW if i < FAMILY_SOLO else FAMILY_NEW
        new = int(rng.integers(lo, hi + 1))
        out.append(serve.Request(prompt=rng.integers(0, V, plen).astype(np.int32),
                                 max_new_tokens=new, seed=seed * 1000 + 500 + i,
                                 sampling=serve.SamplingParams(**FAMILY_MIXES[i % 5][1])))
    return out


def kernel_config(cfg):
    """``cfg`` with its sampler's method set to ``kernel`` (the rest kept)."""
    return dataclasses.replace(cfg, sampler=dataclasses.replace(
        cfg.sampler or SamplerSpec(), method="kernel"))


def family_model(name: str, dev, seed: int, layers: int = 0):
    """A family's full-width model with bfloat16 parameters made on the
    card from ``seed`` (``layers``: a cut of depth)."""
    cfg = kernel_config(get_config(name))
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    model = build_model(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = init_params(torch.Generator(device=dev).manual_seed(seed), model.specs,
                         torch.bfloat16, dev)
    torch.cuda.synchronize()
    return model, params, time.perf_counter() - t0


def family_engine(name: str, dev, seed: int, tally) -> tuple:
    """One family through the engine (phase 9a): ``serve_engine`` over
    FAMILY_REQUESTS requests (FAMILY_SOLO again alone, but for MoE, whose
    capacity couples the rows of a step), then one ``num_samples=4``
    step."""
    model, params, init_s = family_model(name, dev, seed)
    cfg = model.cfg
    V = cfg.vocab_size
    auto = sampling.plan((8, cfg.padded_vocab), method="auto", dtype="float32",
                         has_key=False, backend=dev.type).method
    torch.cuda.reset_peak_memory_stats()
    log(f"phase 9: {name} through the engine: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, V={V}; {param_count(model.specs)} bfloat16 parameters made in "
        f"{init_s:.2f} s (auto picks {auto} at (8, {cfg.padded_vocab}))")
    solo = [] if cfg.family == "moe" else [m for m, _ in FAMILY_MIXES[:FAMILY_SOLO]]
    launches, res = serve_engine(f"phase 9 {name}", model, params,
                                 lambda: family_requests(seed, V), solo, tally, dev)
    toks = torch.randint(0, V, (FAMILY_GEN["B"], 8), device=dev, dtype=torch.int32,
                         generator=torch.Generator(device=dev).manual_seed(seed + 1))
    add_counts(launches, num_samples_step(f"phase 9 {name}", model, params, {"tokens": toks},
                                          toks.shape[1] + cfg.meta_tokens, dev, seed, tally,
                                          serve.SamplingParams(**FAMILY_TRUNC)))
    res.update(config=name, family=cfg.family, layers=cfg.num_layers,
               params=param_count(model.specs), init_s=init_s, auto_method=auto,
               peak_bytes=torch.cuda.max_memory_allocated())
    log(f"  {name}: peak {res['peak_bytes'] / 2**30:.3f} GiB; launches "
        f"{ {n: c for n, c in launches.items() if c} }")
    del params
    free_device()
    return launches, res


def family_generate(name: str, dev, seed: int, tally) -> tuple:
    """One family through ``generate`` with bfloat16 caches (phase 9b);
    its first draw (K2 + K3) held to the plain versions."""
    layers = ARCTIC_LAYERS if name == "arctic-480b" else 0
    torch.cuda.reset_peak_memory_stats()
    model, params, init_s = family_model(name, dev, seed, layers)
    cfg = model.cfg
    V, B, S, new = cfg.vocab_size, FAMILY_GEN["B"], FAMILY_GEN["S"], FAMILY_GEN["new"]
    cut = (f"; CUT: {layers} of {get_config(name).num_layers} layers at full width "
           f"(all would need ~{param_count(build_model(get_config(name)).specs) * 2 / 1e9:.0f}"
           " GB in bfloat16)") if layers else ""
    log(f"phase 9: {name} through generate: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"V={V}; {param_count(model.specs)} bfloat16 parameters made in {init_s:.2f} s{cut}")
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    toks = torch.randint(0, V, (B, S), generator=g, device=dev, dtype=torch.int32)
    emb_len = FAMILY_GEN["src"] if cfg.encoder_layers else cfg.frontend_len
    emb = (torch.randn((B, emb_len, cfg.d_model), generator=g, device=dev) * 0.02).to(
        torch.bfloat16) if emb_len else None
    if cfg.encoder_layers:
        batch, prefix = {"src_embeds": emb, "tgt_tokens": toks}, 0
    elif emb is not None:
        batch, prefix = {"tokens": toks, "frontend_embeds": emb}, emb_len
    else:
        batch, prefix = {"tokens": toks}, cfg.meta_tokens
    # step times: the host clock at each decode call, after a sync
    stamps, pre = [], []

    def prefill(p, b):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model.prefill(p, b)
        torch.cuda.synchronize()
        pre.append(time.perf_counter() - t0)
        return out

    def decode(p, c, t, pos):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        return model.decode(p, c, t, pos)

    timed = model._replace(prefill=prefill, decode=decode)
    gplan = sampling.plan((B, cfg.padded_vocab), method=cfg.sampler_spec.method,
                          dtype="bfloat16", has_key=True, backend=dev.type)
    auto = sampling.plan((B, cfg.padded_vocab), method="auto", dtype="bfloat16",
                         has_key=True, backend=dev.type).method
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with captured_draws() as cap:
        gen = serve.generate(timed, params, batch, max_new_tokens=new, generator=g)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stamps.append(time.perf_counter())
    counts = read_counts()
    check_path(f"{name} generate ({B},{cfg.padded_vocab}) method={gplan.method}", counts,
               auto_expect(gplan.method, new))
    check_captured(tally, f"phase 9 {name} generate", cap, counts)
    launches = dict(counts)
    if gen.tokens.shape != (B, new) or not ((gen.tokens >= 0) & (gen.tokens < V)).all():
        raise AssertionError(f"{name} generate: tokens of shape {gen.tokens.shape} or out "
                             "of range")
    if gen.prefill_len != S + prefix:
        raise AssertionError(f"{name} generate: prefill_len {gen.prefill_len}")
    steps = list(np.diff(stamps))
    add_counts(launches, num_samples_step(f"phase 9 {name}", model, params, batch, S + prefix,
                                          dev, seed, tally,
                                          serve.SamplingParams(**FAMILY_TRUNC)))
    res = {
        "config": name, "family": cfg.family, "layers": cfg.num_layers,
        "layers_of": get_config(name).num_layers, "params": param_count(model.specs),
        "init_s": init_s, "method": gplan.method, "auto_method": auto, "B": B, "prompt": S,
        "prefix": prefix, "new": new, "wall_s": wall, "tokens_per_s": B * new / wall,
        "prefill_s": pre[0], "decode_steps": len(steps), "step_s_median": _pct(steps, 50),
        "step_s_p90": _pct(steps, 90), "launches": launches,
        "peak_bytes": torch.cuda.max_memory_allocated(),
    }
    log(f"  {name}: generate {B} x {S} (+{prefix} prefix) -> {new} new, method "
        f"{gplan.method} (auto picks {auto}): {wall:.3f} s ({res['tokens_per_s']:.1f} "
        f"tokens/s), prefill {pre[0]:.4f} s, seconds a decode step ({len(steps)} steps) "
        f"median {res['step_s_median']:.5f} p90 {res['step_s_p90']:.5f}; peak "
        f"{res['peak_bytes'] / 2**30:.3f} GiB; launches "
        f"{ {n: c for n, c in launches.items() if c} }")
    del params, batch, emb, cap
    free_device()
    return launches, res


def phase_families(dev, seed, tally) -> tuple:
    """Phase 9: the seven other families at full width."""
    launches, res = {}, {}
    for i, name in enumerate(FAMILY_ENGINE):
        counts, res[name] = family_engine(name, dev, seed + 91 + i, tally)
        add_counts(launches, counts)
    for i, name in enumerate(FAMILY_GENERATE):
        counts, res[name] = family_generate(name, dev, seed + 95 + i, tally)
        add_counts(launches, counts)
    return launches, res


# phase 10: training
TRAIN_FULL = ("granite-moe-1b-a400m", "mamba2-370m")
TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 512, 3
TRAIN_OPT = dict(lr=1e-3, warmup=1, total_steps=100)   # full step size from step 1
SMOKE_TOL = dict(loss_rtol=1e-4, param_atol=2e-4)


def train_full(name: str, dev, seed: int) -> dict:
    cfg = get_config(name)
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    params = init_params(torch.Generator(device=dev).manual_seed(seed), model.specs,
                         torch.bfloat16, dev)
    opt = make_optimizer("adamw", **TRAIN_OPT)
    state = opt.init(params)
    step_fn = make_train_step(model, opt, remat="full")
    pipe = TokenPipeline(cfg, ShapeConfig("chip", TRAIN_S, TRAIN_B, "train"), seed=seed)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in pipe.next_batch().items()}
    probe = tree_leaves(params["layers"])[-1][0].clone()
    losses, times = [], []
    reset_counts()
    for step in range(1, TRAIN_STEPS + 1):   # the same batch each step
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step_fn(params, state, batch, step)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(m.loss))
    check_path(f"{name} train steps", read_counts(), {})
    moved = not torch.equal(tree_leaves(params["layers"])[-1][0], probe)
    res = {"config": name, "layers": cfg.num_layers, "params": param_count(model.specs),
           "B": TRAIN_B, "S": TRAIN_S, "losses": losses, "grad_norm": float(m.grad_norm),
           "step_s": times, "step_s_median": _pct(times, 50),
           "tokens_per_s": TRAIN_B * TRAIN_S / _pct(times, 50), "moved": moved,
           "peak_bytes": torch.cuda.max_memory_allocated()}
    # one more step on the same batch, profiled (its result is dropped)
    res["profile"] = device_profile(lambda: step_fn(params, state, batch, TRAIN_STEPS + 1), 1,
                                    f"{name} train step")
    log(f"phase 10: {name} at full width and depth ({cfg.num_layers} layers, "
        f"{res['params']} bfloat16 parameters, float32 AdamW state), {TRAIN_STEPS} steps on "
        f"one {TRAIN_B} x {TRAIN_S} batch, remat full: losses {losses}, seconds a step "
        f"{[round(t, 4) for t in times]} ({res['tokens_per_s']:.0f} tokens/s after the "
        f"first), peak {res['peak_bytes'] / 2**30:.3f} GiB")
    if not (np.isfinite(losses).all() and moved and losses[-1] < losses[0]):
        raise AssertionError(f"{name} training: losses {losses}, parameters moved {moved}")
    del params, state, batch, m
    free_device()
    return res


def train_smoke(name: str, dev, seed: int) -> dict:
    """One AdamW step of a SMOKE config on ``dev`` (the card) against the
    CPU."""
    cfg = get_config(name, smoke=True)
    model = build_model(cfg)
    params = init_params(seed, model.specs, torch.float32, "cpu")
    batch = TokenPipeline(cfg, ShapeConfig("smoke", 32, 4, "train"), seed=seed).next_batch()
    opt = make_optimizer("adamw", lr=1e-3, warmup=2, total_steps=10)
    out = {}
    for where, remat in (("cpu", "none"), (dev, "full")):
        p = tree_map(lambda t: t.to(where), params)
        b = {k: torch.as_tensor(v, device=where) for k, v in batch.items()}
        p1, _, m = make_train_step(model, opt, remat=remat)(p, opt.init(p), b, 1)
        out[where] = (p1, float(m.loss), float(m.grad_norm))
    (pc, lc, gc), (pg, lg, gg) = out["cpu"], out[dev]
    err = max(float((a.cpu() - b).abs().max()) for a, b in zip(tree_leaves(pg),
                                                                 tree_leaves(pc)))
    ok = (abs(lg - lc) <= SMOKE_TOL["loss_rtol"] * abs(lc)
          and abs(gg - gc) <= SMOKE_TOL["loss_rtol"] * abs(gc)
          and err <= SMOKE_TOL["param_atol"])
    log(f"  {name:22s} smoke step card vs CPU: loss {lg:.6f} / {lc:.6f}, grad norm "
        f"{gg:.6f} / {gc:.6f}, parameters max |diff| {err:.3g}")
    if not ok:
        raise AssertionError(f"{name}: the card's smoke train step differs from the CPU's")
    return {"loss": [lg, lc], "grad_norm": [gg, gc], "param_max_abs_diff": err}


def phase_training(dev, seed) -> dict:
    """Phase 10: training at full width, then every SMOKE config's step on
    the card against the CPU's."""
    res = {name: train_full(name, dev, seed + 100 + i) for i, name in enumerate(TRAIN_FULL)}
    log(f"phase 10: one AdamW step of each SMOKE config, card (remat full) vs CPU (remat "
        f"none), tolerance {SMOKE_TOL}")
    res["smoke"] = {name: train_smoke(name, dev, seed + 110) for name in ARCH_IDS}
    return res



# ---------------------------------------------------------------------------
# Phase 11: the launchers on the card
# ---------------------------------------------------------------------------

# --warmup 2: the resumed steps 3-5 train at the schedule's full rate, so a
# wrongly restored optimizer state moves their losses
LAUNCH_TRAIN = ("--arch", "mamba2-370m", "--steps", "6", "--batch", "4", "--seq-len", "512",
                "--ckpt-every", "2", "--log-every", "1", "--warmup", "2")
PREEMPT_AFTER = 3          # steps before the run sends itself SIGTERM
# resumed vs uninterrupted losses: 0 measured on the H100 (PERF.md §6); the
# margin is for a backward pass that sums with atomics in another order
RESUME_LOSS_RTOL = 1e-5
CKPTS_ON_DISK = 4          # the launcher's keep=3 and the one being written
LAUNCH_SERVE = "qwen3-4b"  # the serve launcher's default arch


def _batch_sha(batch) -> str:
    h = hashlib.sha256()
    for k in sorted(batch):
        h.update(k.encode())
        h.update(np.ascontiguousarray(batch[k]).tobytes())
    return h.hexdigest()


def _differing_leaves(a, b) -> int:
    return sum(not torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


def launch_train(dev, seed) -> dict:
    """Phase 11a: ``launch.train``'s loop (``train_lm``) at full width and
    depth of mamba2-370m, float32 parameters and AdamW as the launcher
    makes them.  An uninterrupted 6-step run without checkpoints; then a
    run that sends itself SIGTERM after step 3 (the loop commits a
    checkpoint and returns) and a second call that resumes it to step 6.
    The restored tree must be bit-equal to the saved one, the resumed
    batches to the uninterrupted run's, the losses within
    RESUME_LOSS_RTOL; then one ``compress=True`` save of the AdamW state,
    whose every element comes back within its scale / 2."""
    import shutil
    import signal

    from repro_torch.dist.compression import quantize_int8
    from repro_torch.dist.fault import CheckpointManager, reset_preemption
    from repro_torch.launch import train as ltrain

    root = ROOT / "build" / "phase11"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    n_params = param_count(build_model(get_config(LAUNCH_TRAIN[1])).specs)
    ckpt_bytes = 3 * 4 * n_params                  # float32 params, AdamW m and v
    free = shutil.disk_usage(root).free
    need = CKPTS_ON_DISK * ckpt_bytes + ckpt_bytes
    log(f"phase 11a: a checkpoint of {LAUNCH_TRAIN[1]} is {ckpt_bytes / 1e9:.3f} GB; "
        f"{free / 1e9:.1f} GB free under {root}, {need / 1e9:.1f} GB needed")
    if free < need:
        raise AssertionError(f"phase 11a: {free / 1e9:.1f} GB free under {root}; the "
                             f"checkpoints need {need / 1e9:.1f} GB")
    parse = ltrain.parser().parse_args
    argv = list(LAUNCH_TRAIN) + ["--seed", str(seed)]
    shas = {"ref": {}, "run": {}}

    def recorder(which, kill_after=None):
        def on_step(step, batch, metrics):
            shas[which][step] = _batch_sha(batch)
            if kill_after is not None and step == kill_after - 1:
                os.kill(os.getpid(), signal.SIGTERM)
        return on_step

    prev = signal.getsignal(signal.SIGTERM)
    res = {"config": LAUNCH_TRAIN[1], "params": n_params, "checkpoint_bytes": ckpt_bytes}
    try:
        reset_counts()
        ref = ltrain.train_lm(parse(argv), on_step=recorder("ref"))
        res["uninterrupted"] = {"losses": ref["losses"], "step_s": ref["step_s"]}
        del ref
        free_device()
        ck = root / "ckpt"
        a = ltrain.train_lm(parse(argv + ["--ckpt-dir", str(ck)]),
                            on_step=recorder("run", PREEMPT_AFTER))
        if not a["preempted"] or CheckpointManager(str(ck)).latest_step() != PREEMPT_AFTER:
            raise AssertionError(f"phase 11a: SIGTERM after step {PREEMPT_AFTER} did not "
                                 f"commit step {PREEMPT_AFTER}: {a['saves']}")
        saved = {"params": a["params"], "opt": a["opt"]}
        reset_preemption()
        restored = {}

        def on_restore(tree, extra):
            restored["differ"] = _differing_leaves(tree, saved)
            restored["leaves"] = len(tree_leaves(tree))
            restored["extra"] = extra

        b = ltrain.train_lm(parse(argv + ["--ckpt-dir", str(ck), "--monitor-out",
                                          str(root / "monitor.json")]),
                            on_step=recorder("run"), on_restore=on_restore)
        check_path("phase 11a train", read_counts(), {})
        del saved
    finally:
        reset_preemption()
        signal.signal(signal.SIGTERM, prev)
    losses = {**a["losses"], **b["losses"]}
    want = res["uninterrupted"]["losses"]
    rel = max(abs(losses[s] - want[s]) / abs(want[s]) for s in want)
    batches_equal = shas["run"] == shas["ref"]
    res.update(
        preempted_at=PREEMPT_AFTER, resumed_from=b["start"], losses=losses,
        loss_max_rel_diff=rel, batches_equal=batches_equal,
        restored_leaves=restored.get("leaves"), restored_differ=restored.get("differ"),
        step_s={**a["step_s"], **b["step_s"]}, saves=a["saves"] + b["saves"],
        restore=b["restore"], monitor=b["summary"],
        monitor_file=json.loads((root / "monitor.json").read_text()))
    log(f"  uninterrupted losses {want}; preempted after step {PREEMPT_AFTER}, resumed from "
        f"step {b['start']}: losses {losses}, max rel diff {rel:.3g} (tolerance "
        f"{RESUME_LOSS_RTOL}); batches bit-equal {batches_equal}; restored tree: "
        f"{restored.get('differ')} of {restored.get('leaves')} leaves differ")
    log(f"  seconds a step {[round(t, 4) for t in res['step_s'].values()]}; saves "
        f"{[{k: v for k, v in sv.items() if k != 'files'} for sv in res['saves']]}; files "
        f"{res['saves'][0]['files']}; restore {b['restore']}")
    log(f"  StepMonitor summary: {b['summary']}")
    if restored.get("differ") != 0 or restored.get("extra", {}).get("step") != PREEMPT_AFTER:
        raise AssertionError(f"phase 11a: the restored tree differs from the saved one "
                             f"({restored})")
    if not batches_equal or rel > RESUME_LOSS_RTOL or not np.isfinite(list(losses.values())).all():
        raise AssertionError(f"phase 11a: resumed run off the uninterrupted one: batches "
                             f"{batches_equal}, loss rel diff {rel}")
    if b["summary"]["steps"] != 6 - PREEMPT_AFTER or b["summary"]["dead_hosts"]:
        raise AssertionError(f"phase 11a: monitor summary {b['summary']}")

    # one compressed save of the AdamW moments
    opt = b["opt"]
    del a, b
    free_device()
    shutil.rmtree(ck)
    mgr = CheckpointManager(str(root / "int8"), async_save=False, compress=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr.save(1, {"opt": opt})
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back, _ = mgr.restore(like={"opt": opt})
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    worst = 0.0
    for x, y in zip(tree_leaves(opt), tree_leaves(back["opt"])):
        _, scale = quantize_int8(x)
        err = (x - y).abs()
        slack = float((err - (scale / 2 + torch.finfo(torch.float32).eps * x.abs())).max())
        worst = max(worst, float(err.max() / torch.clamp_min(scale / 2, 1e-30)))
        if slack > 0:
            raise AssertionError(f"phase 11a: an int8 moment came back {slack} past scale/2")
    d = root / "int8" / "step_00000001"
    res["int8"] = {"save_s": save_s, "restore_s": restore_s,
                   "bytes": sum(f.stat().st_size for f in d.iterdir()),
                   "raw_bytes": 2 * 4 * n_params, "max_err_over_half_scale": worst}
    log(f"  compress=True save of the AdamW moments: {res['int8']}")
    del opt, back
    shutil.rmtree(root)
    free_device()
    return res


def launch_serve(dev, seed, tally) -> tuple:
    """Phase 11b: ``launch.serve``'s ``run`` (what its CLI calls) at full
    width and depth of qwen3-4b, float32 parameters as the launcher makes
    them, the plan's method set to ``kernel``: ``--continuous`` without a
    mesh (K9), ``--continuous --dp 1 --tp 1`` (the engine on a (1, 1)
    mesh: thresholds, then K2 + K3 on the masked weights) with the same
    tokens, and ``generate`` on the mesh (K10).  The first launch of each
    kernel of each path is held to its plain version on its own inputs."""
    from repro_torch.launch import serve as lserve

    cfg = kernel_config(get_config(LAUNCH_SERVE))
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = init_params(torch.Generator(device=dev).manual_seed(seed), model.specs,
                         torch.float32, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    log(f"phase 11b: {LAUNCH_SERVE} at full width ({cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, V={cfg.vocab_size}); {param_count(model.specs)} float32 parameters "
        f"made in {init_s:.2f} s")
    launches, res = {}, {"config": LAUNCH_SERVE, "params": param_count(model.specs)}
    paths = (("engine", ["--continuous"], DRAW_WRAPPERS, {"fused_trunc_draw"}),
             ("engine dp 1", ["--continuous", "--dp", "1", "--tp", "1"], DRAW_WRAPPERS,
              {"blocksums", "walk"}),
             ("generate dp 1", ["--dp", "1", "--tp", "1"], SHARD_WRAPPERS,
              {"fused_trunc_draw_rng"}))
    for label, argv, names, expect in paths:
        reset_counts()
        with captured_draws(names) as cap:
            out = lserve.run(lserve.parser().parse_args(argv + ["--sampler", "kernel"]), cfg,
                             params)
        torch.cuda.synchronize()
        counts = read_counts()
        got = {n for n, c in counts.items() if c}
        log(f"  {label}: launches { {n: c for n, c in counts.items() if c} }")
        if got != expect:
            raise AssertionError(f"phase 11b {label}: launched {got}, expected {expect}")
        check_captured(tally, f"phase 11 {label}", cap, counts)
        add_counts(launches, counts)
        toks = out["tokens"]
        flat = [t for row in toks for t in row]
        if not flat or min(flat) < 0 or max(flat) >= cfg.vocab_size:
            raise AssertionError(f"phase 11b {label}: tokens out of range")
        steps = out["engine"].step_times if "engine" in out else []
        res[label] = {"tokens": toks, "seconds": out["seconds"], "steps": out["steps"],
                      "tokens_out": out["tokens_out"],
                      "tokens_per_s": out["tokens_out"] / out["seconds"],
                      "step_s_median": _pct([s["dt"] for s in steps], 50) if steps else
                      out["seconds"] / out["steps"], "launches": counts}
        log(f"  {label}: {out['tokens_out']} tokens in {out['seconds']:.3f} s "
            f"({res[label]['tokens_per_s']:.1f} tokens/s, {out['steps']} steps, seconds a "
            f"step {res[label]['step_s_median']:.5f})")
        del out
    if res["engine dp 1"]["tokens"] != res["engine"]["tokens"]:
        raise AssertionError("phase 11b: the engine on the (1, 1) mesh gave other tokens "
                             "than the engine without a mesh")
    res["peak_bytes"] = torch.cuda.max_memory_allocated()
    log(f"  the engine on the mesh gave the unsharded engine's tokens; peak "
        f"{res['peak_bytes'] / 2**30:.3f} GiB")
    del params
    free_device()
    return launches, res


def launch_lda(dev, seed) -> tuple:
    """Phase 11c: ``launch.train --app lda`` (``train_lda``) at
    configs/lda.py's CONFIG for 2 sweeps, its launches counted."""
    from repro_torch.launch import train as ltrain

    args = ltrain.parser().parse_args(["--app", "lda", "--steps", "2", "--log-every", "1",
                                       "--seed", str(seed)])
    reset_counts()
    t0 = time.perf_counter()
    out = ltrain.train_lda(args)
    wall = time.perf_counter() - t0
    counts = read_counts()
    c = out["config"]
    log(f"phase 11c: --app lda at M={c.M}, V={c.V}, K={c.K}, method {c.sampler_method} "
        f"W={c.sampler_W}: {len(out['sweeps'])} sweeps {out['sweeps']} ({wall:.2f} s with the "
        f"corpus); launches { {n: k for n, k in counts.items() if k} }")
    got = {n for n, k in counts.items() if k}
    if not all(np.isfinite(s["perplexity"]) for s in out["sweeps"]) or \
            got != set(AUTO_KERNELS[c.sampler_method]):
        raise AssertionError(f"phase 11c: {out['sweeps']}, launches {counts}")
    check_state(out["state"], c.K, out["state"].z)
    return counts, {"config": dataclasses.asdict(c), "sweeps": out["sweeps"], "wall_s": wall,
                    "launches": counts}


def phase_launchers(dev, seed, tally) -> tuple:
    """Phase 11: the launchers on a one-rank NCCL group (an in-memory store,
    no TCP port) and the ("data", "model") mesh of (1, 1) they build."""
    import torch.distributed as dist

    from repro_torch.dist import multihost
    from repro_torch.dist import sharding as shd

    t0 = time.perf_counter()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        res = {"train": launch_train(dev, seed + 120)}
        launches, res["serve"] = launch_serve(dev, seed + 121, tally)
        counts, res["lda"] = launch_lda(dev, seed + 122)
        add_counts(launches, counts)
    finally:
        shd.set_activation_sharding(None)
        multihost._reset_for_tests()
        dist.destroy_process_group()
    res["seconds"] = time.perf_counter() - t0
    log(f"phase 11: {res['seconds']:.2f} s")
    return launches, res


# ---------------------------------------------------------------------------
# Phase 12: the dry-run (launch.dryrun, launch.costing) on the card
# ---------------------------------------------------------------------------

# (arch, shape, multi-pod): production cells traced on a fake group of 512
# ranks and cuda meshes, the longest traces first (38-84 s each on the card's
# host down to 6 s), as the worker processes take them in this order
DRYRUN_CELLS = (("qwen3-4b", "prefill_32k", True), ("hymba-1.5b", "train_4k", False),
                ("minicpm3-4b", "train_4k", False), ("arctic-480b", "train_4k", False),
                ("hymba-1.5b", "prefill_32k", False), ("pixtral-12b", "train_4k", False),
                ("llama3-8b", "train_4k", False), ("minicpm3-4b", "decode_32k", True),
                ("granite-moe-1b-a400m", "train_4k", False),
                ("seamless-m4t-medium", "train_4k", False), ("hymba-1.5b", "decode_32k", False),
                ("mamba2-370m", "decode_32k", False), ("gemma2-9b", "decode_32k", False),
                ("llama3-8b", "decode_32k", False))
# processes that trace phase 12a's cells at once (the card's host has 8 cores;
# one trace is a single host thread)
DRYRUN_WORKERS = 4
H100_BYTES = 80 * 10**9
# The cells of heads that the model degree (16) does not divide (ROADMAP.md,
# F5 (a) and F6), per device: the reference's FLOPs (``corrected.flops_total``
# of ``repro.launch.dryrun --arch A --shape S --mesh single|multi``, XLA's
# count on a CPU host of 256 / 512 virtual devices) and the share of them
# the port's may take.  The train_4k cells run attention's projections on
# each rank's own positions (ROADMAP.md, F5 (a')), so none of their ops of
# the most FLOPs may be a projection over every position of a rank's rows
# (``ATTN_TRAIN``)
ATTN_REF_FLOPS = {("hymba-1.5b", "decode_32k", False): (1.169e10, 1.25),
                  ("hymba-1.5b", "prefill_32k", False): (4.124e13, 1.25),
                  ("minicpm3-4b", "train_4k", False): (1.96e14, 1.25),
                  ("minicpm3-4b", "decode_32k", True): (3.292e10, 1.25),
                  ("hymba-1.5b", "train_4k", False): (6.998e13, 1.25),
                  ("arctic-480b", "train_4k", False): (7.906e14, 1.25)}
ATTN_TRAIN = ("minicpm3-4b", "hymba-1.5b", "arctic-480b")
# llama3-8b decode_32k's collective bytes a step before the per-shard MLP
# gathered its weights (the dry-run on the card, PERF.md §5: 9.812e9), with
# room for the activations the MLP moves instead
LLAMA_DECODE_COLLECTIVES = 9.9e9
# The cells of the MoE dispatch, the MLP and the unembedding of a vocabulary
# that the model degree does not divide (ROADMAP.md F5 (b)-(d)), per device
# on pod16x16: the reference's FLOPs (``corrected.flops_total`` of
# ``repro.launch.dryrun --arch A --shape S``, XLA's count on a CPU host of
# 256 virtual devices), and the share of them the port's may take
LAYER_REF_FLOPS = {("granite-moe-1b-a400m", "train_4k", False): 8.49e13,
                   ("pixtral-12b", "train_4k", False): 4.35e14,
                   ("mamba2-370m", "decode_32k", False): 8.310e8}
LAYER_FLOPS_RATIO = 1.25
# hymba-1.5b decode_32k while every model rank gathered its cache (the
# dry-run on the card, ROADMAP.md F5): 5.416e10 bytes of collectives a step,
# a peak of 3.919 GiB a device.  The step must move under a tenth of those
# bytes and peak below that peak.
HYMBA_DECODE_COLLECTIVES = 5.416e10 / 10
HYMBA_DECODE_PEAK = 3.919 * 2**30
# llama3-8b train_4k on pod16x16, per device: the reference's FLOPs
# (``corrected.flops_total`` of ``repro.launch.dryrun --arch llama3-8b
# --shape train_4k``, XLA's count on a CPU host of 256 virtual devices),
# the share above it the port may take, and the peak the port must stay
# under (the sharded loss and unembedding; ROADMAP.md, F4)
LLAMA_TRAIN_REF_FLOPS = 2.87e14
LLAMA_TRAIN_FLOPS_RATIO = 1.25
LLAMA_TRAIN_PEAK = 40 * 2**30
# one card, predicted against measured: gemma2-9b decode at full width and
# depth (as the reference's serve step resolves its draw, then under the
# model card's truncation), granite-moe training at phase 10's geometry
ONE_CHIP = (("gemma2-9b", ShapeConfig("decode_1chip", 4096, 8, "decode"), None),
            ("gemma2-9b", ShapeConfig("decode_1chip", 4096, 8, "decode"),
             dict(top_k=64, top_p=0.95)),
            ("granite-moe-1b-a400m", ShapeConfig("train_1chip", 512, 4, "train"), None))
PEAK_TOL = 0.10          # predicted peak within this share of the measured one


def dryrun_cell(res: dict, arch: str, shape: str, multi: bool) -> dict:
    """One production cell as ``launch.dryrun.lower_cell`` traced it on a
    cuda mesh of a fake group (``res``), printed and checked: its parameter
    and optimizer-state bytes held to ``dist.sharding.tree_bytes_per_device``
    on the same mesh, and the checks of its cell."""
    from repro_torch.dist import sharding as shd

    mesh = shd.MeshDesc({"pod": 2, "data": 16, "model": 16} if multi
                        else {"data": 16, "model": 16})   # the cell's mesh, described
    specs = build_model(get_config(arch)).specs
    want = {"params": shd.tree_bytes_per_device(specs, mesh, 2.0)}
    if res.get("optimizer") == "adamw":   # float32 m and v, placed as the parameters
        want["opt"] = 2 * shd.tree_bytes_per_device(specs, mesh, 4.0)
    got = res["memory"]["by_argument"]
    mem, cost, coll = res["memory"], res["cost"], res["collectives"]
    log(f"  {arch} {shape} on {res['mesh']} ({res['devices']} ranks): {res['params']} "
        f"parameters, trace {res['lower_s']:.1f} s; per device: arguments "
        f"{mem['argument_bytes'] / 2**30:.3f} GiB ({ {k: v for k, v in got.items()} }), "
        f"outputs {mem['output_bytes'] / 2**30:.3f} GiB, temporaries "
        f"{mem['temp_bytes'] / 2**30:.3f} GiB, aliased {mem['alias_bytes'] / 2**30:.3f} GiB, "
        f"peak {mem['peak_bytes'] / 2**30:.3f} GiB beside the card's 80 GB "
        f"({mem['peak_bytes'] / H100_BYTES:.1%}); flops {cost['flops']:.6g}, bytes "
        f"{cost['bytes_accessed']:.6g}; collectives "
        f"{ {k: v for k, v in coll.items() if k != 'op_counts'} } counts {coll['op_counts']}; "
        f"sampler {res.get('sampler')}; traced kernel calls {res['kernel_calls']}; largest "
        f"storages at the peak {mem['peak_top']}")
    for k, v in want.items():
        if got[k] != v:
            raise AssertionError(f"{arch} {shape}: {k} bytes per device {got[k]} != "
                                 f"tree_bytes_per_device's {v}")
    res["tree_bytes_per_device"] = want
    log(f"    ops of the most flops: {res['flops_top']}")
    log(f"    collectives of the most bytes: {list(res['collectives_by'].items())[:4]}")
    if (arch, shape) == ("llama3-8b", "train_4k"):
        check_sharded_loss(res, get_config(arch))
    if (arch, shape, multi) in ATTN_REF_FLOPS:
        check_attention_cell(res, arch, shape, multi)
    if (arch, shape, multi) == ("llama3-8b", "decode_32k", False):
        check_decode_mlp(res, get_config(arch))
    if (arch, shape, multi) in LAYER_REF_FLOPS:
        check_layer_cell(res, arch, shape, multi)
    return res


def check_layer_cell(res: dict, arch: str, shape: str, multi: bool) -> None:
    """A cell of the MoE dispatch, the MLP or an odd vocabulary: FLOPs a
    device within ``LAYER_FLOPS_RATIO`` of the reference's
    (``LAYER_REF_FLOPS``), the peak under the card's 80 GB, and in a decode
    step no op of the most FLOPs over every column of a vocabulary that
    ``model`` does not divide."""
    from repro_torch.configs.base import SHAPES_BY_NAME

    ref = LAYER_REF_FLOPS[(arch, shape, multi)]
    flops, peak = res["corrected"]["flops_total"], res["memory"]["peak_bytes"]
    if flops > LAYER_FLOPS_RATIO * ref:
        raise AssertionError(f"{arch} {shape}: {flops:.4g} FLOPs a device, over "
                             f"{LAYER_FLOPS_RATIO} x the reference's {ref:.4g}")
    if peak >= H100_BYTES:
        raise AssertionError(f"{arch} {shape} peaks at {peak / 2**30:.2f} GiB a device, "
                             f"over the card's 80 GB")
    V = get_config(arch).padded_vocab
    whole = [op for _, op, _ in res["flops_top"]
             if any(f in op for f in (f", {V})", f", {V},", f"({V},"))]
    if SHAPES_BY_NAME[shape].kind == "decode" and V % 16 and whole:
        raise AssertionError(f"{arch} {shape} projects every column of its {V}: {whole}")
    log(f"    {arch} {shape}: {flops / ref:.3f} x the reference's FLOPs, peak "
        f"{peak / 2**30:.3f} GiB")


def check_attention_cell(res: dict, arch: str, shape: str, multi: bool) -> None:
    """A cell whose heads ``model`` does not divide: FLOPs within its
    share of the reference's (``ATTN_REF_FLOPS``); hymba-1.5b ``decode_32k``
    moves no all-gather with the cache's length (or a rank's block of it)
    in its output and under ``HYMBA_DECODE_COLLECTIVES`` bytes, and peaks
    under ``HYMBA_DECODE_PEAK``; the ``train_4k`` cells of ``ATTN_TRAIN``
    take no projection of attention over every position of a rank's rows
    among their three ops of the most FLOPs
    (:func:`whole_width_projections`), and minicpm3-4b's and hymba-1.5b's
    fit the card (arctic-480b's peak is printed only)."""
    from repro_torch.configs.base import SHAPES_BY_NAME

    ref, ratio = ATTN_REF_FLOPS[(arch, shape, multi)]
    flops, peak = res["corrected"]["flops_total"], res["memory"]["peak_bytes"]
    if flops > ratio * ref:
        raise AssertionError(f"{arch} {shape}: {flops:.4g} FLOPs a device, over "
                             f"{ratio} x the reference's {ref:.4g}")
    msg = f"    {arch} {shape}: {flops / ref:.3f} x the reference's FLOPs"
    if (arch, shape) == ("hymba-1.5b", "decode_32k"):
        sh = SHAPES_BY_NAME[shape]
        caches = build_model(get_config(arch)).cache_specs(sh.global_batch, sh.seq_len)
        T = caches["attn"]["k"].shape[2]   # (layers, B, T, kv heads, head)
        cache = [k for k in res["collectives_by"] if k.startswith("all-gather")
                 and (f"{T}," in k or f"{T // 16}," in k)]
        if cache:
            raise AssertionError(f"{arch} {shape} gathers its cache: {cache}")
        moved = res["collectives"]["total_bytes"]
        if moved >= HYMBA_DECODE_COLLECTIVES or peak >= HYMBA_DECODE_PEAK:
            raise AssertionError(f"{arch} {shape}: {moved:.4g} bytes of collectives (limit "
                                 f"{HYMBA_DECODE_COLLECTIVES:.4g}), peak {peak / 2**30:.3f} GiB "
                                 f"(limit {HYMBA_DECODE_PEAK / 2**30:.3f})")
        msg += f", {moved:.4g} bytes of collectives, no cache gathered"
    if arch in ATTN_TRAIN and shape == "train_4k":
        top = res["flops_top"][:3]
        log(f"    three ops of the most flops (local shapes): "
            f"{[(op, round(share, 4)) for _, op, share in top]}")
        whole = whole_width_projections(top, get_config(arch), multi)
        if whole:
            raise AssertionError(f"{arch} {shape} projects every position of a rank's rows: "
                                 f"{whole}")
        if arch != "arctic-480b" and peak >= H100_BYTES:
            raise AssertionError(f"{arch} {shape} peaks at {peak / 2**30:.2f} GiB a device, "
                                 f"over the card's 80 GB")
        msg += ", no projection over every position among its three largest ops"
    log(f"{msg}, peak {peak / 2**30:.3f} GiB")


def _op_shapes(key: str) -> list:
    """The shapes in a ``flops_top`` or ``collectives_by`` key, "op
    [(shape), ...]"."""
    import ast

    return [tuple(s) for s in ast.literal_eval(key.split(" ", 1)[1])]


def whole_width_projections(top, cfg, multi: bool) -> list:
    """The ops of ``top`` (``flops_top`` entries of a ``train_4k`` cell)
    that are a gradient of attention's projections over every position of
    a rank's rows: a ``bmm`` whose contracted dim is the rows' positions
    (16 rows x 4,096 on pod16x16, hymba's meta tokens included) and whose
    other dims are widths of attention's weights (d_model, the heads',
    MLA's latent ranks).  The MLP's weight gradients (d_ff split over
    ``model``) are not among them."""
    from repro_torch.configs.base import SHAPES_BY_NAME

    sh = SHAPES_BY_NAME["train_4k"]
    positions = sh.global_batch // (32 if multi else 16) * (sh.seq_len + cfg.meta_tokens)
    H, hd = cfg.num_heads, cfg.resolved_head_dim
    widths = {cfg.d_model, H * hd, cfg.num_kv_heads * hd}
    if cfg.mla is not None:
        m = cfg.mla
        widths |= {m.q_lora_rank, m.kv_lora_rank, m.kv_lora_rank + m.qk_rope_head_dim,
                   H * (m.qk_nope_head_dim + m.qk_rope_head_dim), H * m.qk_nope_head_dim,
                   H * m.v_head_dim}
    found = []
    for _, op, _ in top:
        shapes = _op_shapes(op)
        if len(shapes) != 2 or len(shapes[0]) != 3:
            continue
        (_, m_, k), (_, _, n) = shapes
        if k == positions and m_ in widths and n in widths:
            found.append(op)
    return found


def check_decode_mlp(res: dict, cfg) -> None:
    """llama3-8b ``decode_32k``: collectives a step under
    ``LLAMA_DECODE_COLLECTIVES`` bytes, and no all-gather of a block of
    an MLP weight (d_model x d_ff over 16 ranks, or whole): the decode
    MLP moves its activations, not its weights."""
    moved = res["collectives"]["total_bytes"]
    blocks = {cfg.d_model * cfg.d_ff // 16, cfg.d_model * cfg.d_ff}
    gathered = [k for k in res["collectives_by"] if k.startswith("all-gather")
                and any(int(np.prod(s)) in blocks for s in _op_shapes(k))]
    if gathered or moved > LLAMA_DECODE_COLLECTIVES:
        raise AssertionError(f"llama3-8b decode_32k: {moved:.4g} bytes of collectives a step "
                             f"(limit {LLAMA_DECODE_COLLECTIVES:.4g}), MLP weights gathered: "
                             f"{gathered}")
    log(f"    llama3-8b decode_32k: {moved:.4g} bytes of collectives a step, no MLP weight "
        f"gathered")


def check_sharded_loss(res: dict, cfg) -> None:
    """llama3-8b train_4k: no float32 logits over the whole vocabulary
    among the largest storages at the peak, the peak under
    ``LLAMA_TRAIN_PEAK``, the FLOPs within ``LLAMA_TRAIN_FLOPS_RATIO`` of
    the reference's."""
    V = cfg.padded_vocab
    whole = [t for t in res["memory"]["peak_top"] if t[2] == "float32" and t[1][-1] == V]
    if whole:
        raise AssertionError(f"llama3-8b train_4k holds float32 logits over the whole "
                             f"vocabulary at its peak: {whole}")
    peak = res["memory"]["peak_bytes"]
    if peak >= LLAMA_TRAIN_PEAK:
        raise AssertionError(f"llama3-8b train_4k peaks at {peak / 2**30:.2f} GiB a device, "
                             f"not under {LLAMA_TRAIN_PEAK / 2**30:.0f}")
    flops = res["corrected"]["flops_total"]
    if flops > LLAMA_TRAIN_FLOPS_RATIO * LLAMA_TRAIN_REF_FLOPS:
        raise AssertionError(f"llama3-8b train_4k: {flops:.4g} FLOPs a device, over "
                             f"{LLAMA_TRAIN_FLOPS_RATIO} x the reference's "
                             f"{LLAMA_TRAIN_REF_FLOPS:.3g}")
    log(f"    sharded loss: peak {peak / 2**30:.3f} GiB, {flops / LLAMA_TRAIN_REF_FLOPS:.3f} x "
        f"the reference's FLOPs")


def one_chip(arch: str, shape, sp, dev, seed: int, tally) -> tuple:
    """The dry-run's one-card prediction (``mesh=None`` on cuda) against the
    same step run for real: FLOPs (``FlopCounterMode``) and kernel calls
    equal, the peak within ``PEAK_TOL`` of ``max_memory_allocated`` above
    the memory held before the inputs were made; the first launch of each
    kernel held to its plain version."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch import dryrun

    cfg = get_config(arch)
    params = serve.SamplingParams(**sp) if sp else None
    label = f"{arch} {shape.name}" + (f" {sp}" if sp else "")
    pred = dryrun.trace_cell(cfg, shape, None, device="cuda", sampling_params=params)
    free_device()
    base = torch.cuda.memory_allocated()
    args = dryrun.real_inputs(cfg, shape, dev, seed)
    run = dryrun.cell_step(cfg, shape, args, sampling_params=params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as fc, captured_draws() as cap:
        out = run()
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    counts = read_counts()
    del out
    launched = {n: c for n, c in counts.items() if c}
    want = pred["memory"]["peak_bytes"]
    gap = (want - peak) / peak
    res = {"config": arch, "shape": dataclasses.asdict(shape), "sampling": sp,
           "flops": [pred["cost"]["flops"], float(fc.get_total_flops())],
           "kernel_calls": [pred["kernel_calls"], launched],
           "peak_bytes": [want, peak], "peak_gap": gap, "memory": pred["memory"],
           "trace_s": pred["lower_s"], "step_s": step_s, "sampler": pred.get("sampler")}
    log(f"  {label} on one card: flops traced {res['flops'][0]:.6g} / run "
        f"{res['flops'][1]:.6g}; kernel calls traced {pred['kernel_calls']} / launched "
        f"{launched}; peak predicted {want / 2**30:.3f} GiB (arguments "
        f"{pred['memory']['argument_bytes'] / 2**30:.3f} + outputs "
        f"{pred['memory']['output_bytes'] / 2**30:.3f} + temporaries "
        f"{pred['memory']['temp_bytes'] / 2**30:.3f}) / measured {peak / 2**30:.3f} GiB "
        f"(gap {gap:+.2%}); sampler {pred.get('sampler')}; trace {pred['lower_s']:.1f} s, "
        f"step {step_s:.2f} s")
    check_captured(tally, f"phase 12 {label}", cap, counts)
    if res["flops"][0] != res["flops"][1]:
        raise AssertionError(f"{label}: traced flops {res['flops'][0]} != run's {res['flops'][1]}")
    if pred["kernel_calls"] != launched:
        raise AssertionError(f"{label}: traced kernel calls {pred['kernel_calls']} != "
                             f"launches {launched}")
    if abs(gap) > PEAK_TOL:
        raise AssertionError(f"{label}: predicted peak {want} is {gap:+.2%} off the "
                             f"measured {peak}")
    del args, run
    free_device()
    return counts, res


def phase_dryrun(dev, seed, tally) -> tuple:
    """Phase 12: (a) the production cells, each traced on a fake group of
    512 ranks in one of ``DRYRUN_WORKERS`` spawned processes and checked
    here in ``DRYRUN_CELLS``' order; (b) the one-card predictions against
    the real steps."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    res, traced, launches = {"cells": {}, "one_chip": []}, {}, {}
    with ProcessPoolExecutor(DRYRUN_WORKERS, mp_context=multiprocessing.get_context("spawn"),
                             initializer=dryrun.fake_process_group, initargs=(512,)) as pool:
        lowered = [pool.submit(dryrun.lower_cell, arch, shape, multi_pod=multi, device="cuda")
                   for arch, shape, multi in DRYRUN_CELLS]
        try:
            for (arch, shape, multi), fut in zip(DRYRUN_CELLS, lowered):
                cell = dryrun_cell(fut.result(), arch, shape, multi)
                res["cells"][f"{arch} {shape} {cell['mesh']}"] = cell
                add_counts(traced, cell["kernel_calls"])
        finally:
            for fut in lowered:
                fut.cancel()
    res["cells_s"] = time.perf_counter() - t0
    log("phase 12b: one card, predicted against measured")
    for i, (arch, shape, sp) in enumerate(ONE_CHIP):
        counts, one = one_chip(arch, shape, sp, dev, seed + 130 + i, tally)
        res["one_chip"].append(one)
        add_counts(launches, counts)
        add_counts(traced, one["kernel_calls"][0])
    res["seconds"] = time.perf_counter() - t0
    res["traced_calls"] = traced
    log(f"phase 12: {res['seconds']:.2f} s (cells {res['cells_s']:.2f} s)")
    return launches, res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=None, help="write every result as JSON")
    ap.add_argument("--timing-only", action="store_true",
                    help="build, run phase 2g's timings alone and print them as JSON "
                         "(no checks, no result line)")
    ap.add_argument("--sparse-profile", action="store_true",
                    help="run phase 7b's fresh process alone (S1's times, the profiled "
                         "sparse sweep) and print it as JSON (chip_smoke.py starts this "
                         "itself)")
    ap.add_argument("--src", type=Path, default=None,
                    help="with --timing-only: import the port from this src/ directory "
                         "(another commit's checkout) in place of this one's")
    args = ap.parse_args(argv)
    if args.src and not args.timing_only:
        ap.error("--src times another checkout's kernels and needs --timing-only")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; the port's "
              "kernels run only on the card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    # the defaults resolve from the committed cost model, on a cache file of
    # this run inside the checkout
    cache = ROOT / "build" / ("autotune_sparse_profile.json" if args.sparse_profile
                              else "autotune.json")
    cache.unlink(missing_ok=True)
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = str(cache)
    os.environ["REPRO_AUTOTUNE"] = "model"
    smi = nvidia_smi()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    log(f"phase 1: kernels built in {build_s:.2f} s (from {SRC})")
    for name, text in _build.build_log.items():
        log(f"  nvcc {name}:\n" + "\n".join("    " + x for x in text.strip().splitlines()))

    if args.sparse_profile:
        log(json.dumps(phase_sparse_profile(dev, args.seed)))
        return 0
    t0 = time.perf_counter()
    corpus = paper_corpus(args.seed, CONFIG.M, CONFIG.V)
    log(f"corpus built in {time.perf_counter() - t0:.2f} s")
    if args.timing_only:
        log(json.dumps({"card": smi, "src": str(SRC),
                        "layout_timing": phase_layout_timing(corpus, dev, args.seed)}))
        return 0
    tally, inputs = phase_kernels(corpus, dev, args.seed)
    phase_given_kernels(corpus, dev, args.seed, tally, inputs)
    phi = factors("dirichlet", 1, CONFIG.V, CONFIG.K,
                  torch.Generator(device=dev).manual_seed(args.seed + 4), dev)[1]
    phase_trunc_kernels(dev, args.seed, tally)
    phase_alias_kernels(dev, args.seed, tally, phi)
    phase_seeded_kernels(corpus, dev, args.seed, tally, inputs)
    log("phase 2c: kernel times (CUDA events)")
    timing = phase_timing(corpus, dev, args.seed, inputs)
    timing.update(phase_given_timing(corpus, dev, args.seed, inputs))
    timing.update(phase_new_timing(dev, args.seed, phi))
    timing.update(phase_seeded_timing(dev, args.seed))
    layout_timing = phase_layout_timing(corpus, dev, args.seed)
    dev_corpus = corpus_mod.Corpus(
        docs=torch.as_tensor(corpus.docs, device=dev),
        lengths=corpus.lengths,
        mask=torch.as_tensor(corpus.mask, device=dev),
        vocab_size=corpus.vocab_size,
    )
    state, lda_counts, main_res = phase_main(dev_corpus, dev, args.seed)
    state, launches, main_res["table_paths"] = phase_table_paths(
        state, dev_corpus, dev, args.seed)
    launches.update({n: lda_counts[n] for n in ("lda_fused_draw", "lda_blocksums",
                                                 "lda_walk")})
    log("phase 5: the sampling API on the card")
    for fn in (lambda: phase_decode(dev, args.seed), lambda: phase_methods(dev, args.seed),
               lambda: phase_alias_phi(dev, args.seed, state.phi)):
        counts, res = fn()
        main_res.setdefault("api", []).append(res)
        add_counts(launches, counts)
    state, main_res["gibbs_new"] = phase_gibbs_new(state, dev_corpus)
    log("phase 5a: the defaults (method='auto') on the card")
    state, counts, main_res["auto"] = phase_auto(state, dev_corpus, dev, args.seed, main_res)
    add_counts(launches, counts)
    main_res["grid"] = phase_grid()
    main_res["profile"] = {}
    for method, W in (("lda_kernel", 32), ("butterfly", None), ("kernel", None)):
        state, main_res["profile"][method] = phase_profile(state, dev_corpus, method, W)
    del state
    fig3 = phase_fig3(dev_corpus, dev, args.seed)
    planted = phase_planted(dev, args.seed)
    log("phase 6: the sharded paths (one-rank NCCL group, mesh ('data',))")
    counts, main_res["sharded"] = phase_sharded(dev_corpus, dev, args.seed)
    add_counts(launches, counts)
    log("phase 7: sparse LDA (the MH-alias sweep, S1)")
    main_res["sparse_kernel"] = phase_sparse_kernel(corpus, dev, args.seed, tally)
    counts, main_res["sparse"] = phase_sparse(dev_corpus, dev, args.seed)
    add_counts(launches, counts)
    timing["sparse_mh"] = main_res["sparse"].pop("s1_timing")
    counts, main_res["streaming"] = phase_streaming(dev, args.seed)
    add_counts(launches, counts)
    del dev_corpus, phi, inputs
    torch.cuda.empty_cache()
    log("phase 8: serving (the decoder path: models/ and serve/ on the card)")
    counts, main_res["serving"] = phase_serving(dev, args.seed, tally)
    add_counts(launches, counts)
    log("phase 9: the other model families at full width")
    counts, main_res["families"] = phase_families(dev, args.seed, tally)
    add_counts(launches, counts)
    log("phase 10: training (train/ and data/ on the card)")
    main_res["training"] = phase_training(dev, args.seed)
    log("phase 11: the launchers on the card (dist/ and launch/)")
    counts, main_res["launchers"] = phase_launchers(dev, args.seed, tally)
    add_counts(launches, counts)
    log("phase 12: the dry-run (launch.dryrun and launch.costing) on the card")
    counts, main_res["dryrun"] = phase_dryrun(dev, args.seed, tally)
    add_counts(launches, counts)

    kernels = []
    layouts = path_layouts(corpus.docs.shape[1])
    for name, (kid, src, replaces, _) in KERNELS.items():
        t, tm = tally.t[name], timing[name]
        kernels.append({
            "name": name, "id": kid, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": t["max_abs_err"], "ms": tm["ms"], "plain_ms": tm["plain_ms"],
            "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
            "library_ms": tm.get("library_ms"), "bound_us": tm["bound_ms"] * 1e3,
            "mismatches": t["mismatches"], "ties": t["ties"], "cases": t["cases"],
        })
        if name in layouts:
            kernels[-1]["layouts"] = layouts[name]
        if name in main_res["dryrun"]["traced_calls"]:  # phase 12's fake-rule calls
            kernels[-1]["traced_calls"] = main_res["dryrun"]["traced_calls"][name]
        if name == "butterfly_table":  # the W = 128 call beside the chunk's
            w128 = timing["butterfly_table_w128"]
            kernels[-1].update({f"{k}_w128": w128[k] for k in (
                "ms", "device_ms", "plain_ms", "bound_ms", "schedule")})
        if name == "alias_assemble":  # the vocabulary's call beside phi's
            vocab = timing["alias_assemble_vocab"]
            kernels[-1].update({f"{k}_vocab": vocab[k] for k in (
                "ms", "device_ms", "plain_ms", "bound_ms", "layout", "shape")})
            kernels[-1]["device_ms"] = tm["device_ms"]
        if name == "sparse_mh":  # both layouts, and K = 1,024 and 2,048
            kernels[-1].update({k: tm[k] for k in (
                "device_ms", "alias_ms", "layout", "position_ms", "position_device_ms",
                "bound_int32_ms", "bound_fp32_ms", "bound_bytes_ms", "shape", "steps")})
            kernels[-1]["by_K"] = {case: {lay: {"ms": t[lay]["ms"],
                                                 "device_ms": t[lay]["device_ms"]}
                                          for lay in KS.LAYOUTS if lay in t}
                                   | {"bound_ms": t["bound"]["bound_ms"]}
                                   for case, t in tm["by_K"].items()}
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({
            "card": smi, "build_s": build_s, "kernels": kernels, "timing": timing,
            "layout_timing": layout_timing, "main": main_res,
            "fig3": fig3, "planted": planted, "tally": tally.t,
        }, indent=1))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
