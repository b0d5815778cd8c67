"""The least work of a sweep and of its kernels: bytes and operations.

Counted from the cell's own data, each input read once and each output
written once (``peaks.json`` holds the card's rates):

* :func:`sweep_bytes`: any exact sweep of the configuration reads every
  live token's word and topic and writes its topic (4 bytes each), reads
  theta and phi and writes them anew (float32).  No operations are
  counted: the dense and the sparse routes need different arithmetic for
  the same sweep.
* :func:`k8_chunk_bounds`: K8 on one chunk of documents (the port's
  ``lda_draw`` bound): theta rows of the chunk's documents and phi rows of
  its distinct words, the per-position document ids and words (8 bytes),
  uniforms (4) and topics written (4); operations ``2 K`` a position at
  the float32 rate.  A chunk's bound is the larger of the two times.
* :func:`s1_bound`: S1 on one sweep (the port's ``sparse_mh`` bound): the
  larger of a bytes term (the position arrays, 13 bytes a position; each
  document's retained (topic, count) pairs, 8 bytes each; theta and phi at
  each live token's topics before and after; a descent's ``ceil(log2 K) +
  1`` cdf entries of each live word) and an integer term (4 Threefry
  uniforms a live token and cycle, each ``max(20 / 64, 66 / 128)`` of an
  SM's clock, 132 SMs at 1,980 MHz).
"""

from __future__ import annotations

from typing import Dict, List

import torch

from bench.manifest import read_json

PEAKS = read_json("peaks.json")
THREEFRY_INT_INSTRS, THREEFRY_ALU_ONLY_INSTRS = 66, 20
CDF_UNIFORMS = 4          # uniforms a live token draws in one cdf MH cycle


def sweep_bytes(live_tokens: int, M: int, V: int, K: int) -> int:
    return 12 * int(live_tokens) + 2 * 4 * K * (int(M) + int(V))


def sweep_seconds(live_tokens: int, M: int, V: int, K: int) -> float:
    return sweep_bytes(live_tokens, M, V, K) / PEAKS["hbm_bytes_per_s"]


def k8_chunk_bounds(docs: torch.Tensor, K: int, chunk: int) -> List[Dict[str, float]]:
    """Each chunk's least bytes, operations and seconds; the last chunk is
    padded to ``chunk`` documents of word 0, as the sweep draws it."""
    M, L = docs.shape
    chunk = min(chunk, M)
    out = []
    for s in range(0, M, chunk):
        words = docs[s:s + chunk].reshape(-1)
        pad = chunk - min(chunk, M - s)
        distinct = int(torch.unique(words).numel())
        if pad and not bool((words == 0).any()):
            distinct += 1
        positions = chunk * L
        nbytes = (chunk + distinct) * K * 4 + positions * (8 + 4 + 4)
        flops = positions * 2 * K
        t = max(nbytes / PEAKS["hbm_bytes_per_s"], flops / PEAKS["fp32_flops_per_s"])
        out.append({"bytes": nbytes, "flops": flops, "seconds": t})
    return out


def s1_bound(z_in, z_out, docs, mask, K: int, steps: int) -> Dict[str, float]:
    """S1's least time on one sweep from topics ``z_in`` to ``z_out``."""
    M, L = docs.shape
    live = mask.reshape(-1)
    d = torch.arange(M, device=docs.device)[:, None].expand(M, L).reshape(-1)[live]
    w = docs.reshape(-1)[live].long()
    zz = torch.cat([z_in.reshape(-1)[live], z_out.reshape(-1)[live]]).long()
    dd, ww = d.repeat(2), w.repeat(2)
    theta_el = int(torch.unique(dd * K + zz).numel())
    phi_el = int(torch.unique(ww * K + zz).numel())
    pairs = int(torch.unique(d * K + z_in.reshape(-1)[live].long()).numel())
    words = int(torch.unique(w).numel())
    per_word = max(1, (K - 1).bit_length()) + 1
    nbytes = M * L * 13 + pairs * 8 + (theta_el + phi_el) * 4 + words * per_word * 4
    uniforms = int(live.sum()) * steps * CDF_UNIFORMS
    clocks = max(THREEFRY_ALU_ONLY_INSTRS / PEAKS["int32_alu_lanes_per_sm"],
                 THREEFRY_INT_INSTRS / PEAKS["int32_lanes_per_sm"])
    t_int = uniforms * clocks / (PEAKS["sms"] * PEAKS["sm_max_hz"])
    t_bytes = nbytes / PEAKS["hbm_bytes_per_s"]
    return {"bytes": nbytes, "uniforms": uniforms, "bytes_s": t_bytes, "int32_s": t_int,
            "seconds": max(t_bytes, t_int)}
