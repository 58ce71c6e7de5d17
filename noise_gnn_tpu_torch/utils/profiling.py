"""Throughput accounting shared with the JAX package's metrics, and the
CUDA-event timers and published H100 rates that the card's scripts
(``tools/gather_probe.py``, ``chip_smoke.py``) time and bound kernels with."""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM memory rate, published
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores, published


def tree_edges_per_batch(batch_size: int, fanouts: tuple[int, ...]) -> int:
    """Sampled (parent, child) pairs per k-hop tree batch — the unit behind
    the edges/s counter (matches the BASELINE.md north-star metric)."""
    total, width = 0, batch_size
    for f in fanouts:
        width *= f
        total += width
    return total


def time_ms(fn, reps: int, warm: int = 2) -> float:
    """Mean CUDA-event time of ``fn`` over ``reps`` calls after ``warm``."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_turns(fns: dict, turns: int, reps: int, warm: int = 2) -> dict[str, list[float]]:
    """``time_ms`` of each named function in turns: every function once per
    turn, ``turns`` turns, so that a drift of the card's clock or of its
    neighbours falls on all of them alike. Returns each name's times."""
    times: dict[str, list[float]] = {name: [] for name in fns}
    for _ in range(turns):
        for name, fn in fns.items():
            times[name].append(time_ms(fn, reps, warm))
    return times
