"""Gather-ring throughput probe on one CUDA card.

    python -m noise_gnn_tpu_torch.tools.gather_probe

Port of ``tools/exp_dma_gather.py`` (``main()``, :101-138): can a ring of
``depth`` per-block copies in flight gather random rows as fast as the
library's gather? It runs at that tool's shapes: a row table x ``[1,000,000,
256]`` f32 (1.02 GB) viewed as aligned 8-row blocks ``x3 [125,000, 8, 256]``,
E = 131,072 random block ids (``numpy.random.default_rng(0)``, as the tool
draws them), P = 16 passes, chunk 2048, depth in {2, 4, 8, 16, 24}. For each
depth it times the CUDA kernel (``ops/gather_ring.py``) with CUDA events after
warm-up and prints M blocks/s, M rows/s (8 rows a block), GB/s (the bytes of
all its copies), its bound, and the cluster size C the wrapper's rule chose
with the number of such clusters the card holds at once. Two library
yardsticks follow, each one ``torch.index_select`` call:

* the same P * E 8-row blocks (the kernel's reads, plus 17.2 GB of writes);
* P * E single 1 KB rows, ``x[8 * idx]``, through ``ops/scatter.fast_take``
  (one ``index_select``): the comparison the TPU tool made against its
  ``fast_take``.

The kernel's function is every one of the P * E copies landing in its ring
slot, and the result is the final rings (``ops/gather_ring.py``). Bounds
count the bytes a call must move over 3.35 TB/s (the H100's published
memory rate): each distinct block or row it reads once from device memory
(the P passes re-read the same E ids, whose re-reads the 50 MB L2 cache may
serve; about 81 K of the 125 K blocks are drawn at all), the ids, and each
output once. Each printed line also gives the time of all of the call's
reads and writes at that rate, which the L2 cache lets a call beat; that
time is a yardstick, not a bound.

The JAX tool's ``utils/memory.configure_malloc`` and ``configure_jax_cache``
set the host heap and JAX's compilation cache; the port has no counterpart
for either. Needs a CUDA card.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from ..ops.gather_ring import gather_ring, plan
from ..ops.scatter import fast_take
from ..utils.profiling import HBM_BYTES_PER_S, time_ms

N, F = 1_000_000, 256
E = 131_072
P = 16
CHUNK = 2048
DEPTHS = (2, 4, 8, 16, 24)


def make_inputs(device, seed: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """(x3 [N/8, 8, F] f32 from a seeded torch generator on ``device``,
    idx [E] int32 block ids from ``numpy.random.default_rng(seed)``)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x3 = torch.randn((N // 8, 8, F), generator=gen, device=device)
    idx = np.random.default_rng(seed).integers(0, N // 8, E).astype(np.int32)
    return x3, torch.from_numpy(idx).to(device)


def copy_bytes(depth: int, e: int = E, passes: int = P, chunk: int = CHUNK,
               f: int = F) -> int:
    """Bytes one probe call moves: every block copy read, each chunk's
    indices read, every final ring written."""
    return passes * (e * 8 * f * 4 + e * 4 + (e // chunk) * depth * 8 * f * 4)


def _rates(ms: float, ids: int, traffic: int, least: int) -> dict:
    """Rates of a call that gathers ``ids`` blocks (or rows) in ``ms``:
    ``traffic`` is the bytes of all its reads and writes
    (``traffic_at_hbm_ms`` their time at the memory rate, a yardstick),
    ``least`` the bytes it must move (each distinct block it reads once,
    each output once), whose time at the memory rate is the bound."""
    s = ms * 1e-3
    return dict(ms=ms, M_ids_per_s=ids / s / 1e6, GB_per_s=traffic / s / 1e9,
                traffic_bytes=traffic, traffic_at_hbm_ms=traffic / HBM_BYTES_PER_S * 1e3,
                bytes=least, bound_ms=least / HBM_BYTES_PER_S * 1e3, bound_by="bytes")


def probe(x3: torch.Tensor, idx: torch.Tensor, reps: int = 10, chunk: int = CHUNK,
          passes: int = P) -> list[dict]:
    """Time the kernel at each depth; one row of rates, bound and cluster
    plan per depth. The passes re-read the same blocks, so the bound counts
    each distinct block once (a re-read may hit L2); ``traffic_at_hbm_ms``
    is the time of every copy at the memory rate."""
    e, f = int(idx.shape[0]), int(x3.shape[2])
    distinct = int(torch.unique(idx).numel())
    rows = []
    for depth in DEPTHS:
        ms = time_ms(lambda: gather_ring(x3, idx, depth, chunk, passes), reps)
        out = passes * (e // chunk) * depth * 8 * f * 4
        r = _rates(ms, passes * e, copy_bytes(depth, e, passes, chunk, f),
                   distinct * 8 * f * 4 + e * 4 + out)
        r["M_rows_per_s"] = 8 * r["M_ids_per_s"]  # 8 rows a block
        csize, active = plan(depth, chunk, f, passes, e // chunk, x3.device)
        rows.append(dict(depth=depth, distinct_blocks=distinct, cluster=csize,
                         active_clusters=active, **r))
    return rows


def yardsticks(x3: torch.Tensor, idx: torch.Tensor, reps: int = 10,
               passes: int = P) -> dict:
    """The two ``torch.index_select`` yardsticks over the same P * E ids."""
    nblk, _, f = x3.shape
    big = idx.repeat(passes)
    ids = passes * int(idx.shape[0])
    distinct = int(torch.unique(idx).numel())
    block_ms = time_ms(lambda: torch.index_select(x3, 0, big), reps)
    x2, rows8 = x3.view(nblk * 8, f), big * 8
    row_ms = time_ms(lambda: fast_take(x2, rows8), reps)
    blk, row = 8 * f * 4, f * 4
    return {
        "index_select blocks": _rates(block_ms, ids, 2 * ids * blk + ids * 4,
                                      distinct * blk + ids * 4 + ids * blk),
        "index_select rows": _rates(row_ms, ids, 2 * ids * row + ids * 4,
                                    distinct * row + ids * 4 + ids * row),
    }


def report(rows: list[dict], yard: dict) -> list[str]:
    """Printable lines, one per depth and one per yardstick."""
    out = []
    for r in rows:
        out.append(f"gather ring depth={r['depth']:3d} C={r['cluster']} "
                   f"({r['active_clusters']} clusters at once): {r['ms']:8.3f} ms -> "
                   f"{r['M_ids_per_s']:7.1f} M blocks/s, {r['M_rows_per_s']:8.1f} M rows/s, "
                   f"{r['GB_per_s']:7.1f} GB/s; bound {r['bound_ms']:.3f} ms, all copies "
                   f"at the memory rate {r['traffic_at_hbm_ms']:.3f} ms")
    for name, r in yard.items():
        out.append(f"{name:26s}: {r['ms']:8.3f} ms -> {r['M_ids_per_s']:7.1f} M ids/s, "
                   f"{r['GB_per_s']:7.1f} GB/s; bound {r['bound_ms']:.3f} ms, all reads "
                   f"and writes at the memory rate {r['traffic_at_hbm_ms']:.3f} ms")
    return out


def run(device) -> dict:
    """The probe at the tool's shapes on ``device``: every depth and both
    yardsticks."""
    x3, idx = make_inputs(device)
    return {"depths": probe(x3, idx), "yardsticks": yardsticks(x3, idx)}


def main() -> int:
    if not torch.cuda.is_available():
        print("gather_probe: no CUDA device is visible", file=sys.stderr)
        return 2
    print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    res = run(torch.device("cuda", 0))
    for line in report(res["depths"], res["yardsticks"]):
        print(line, flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
