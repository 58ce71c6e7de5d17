"""Tracing and throughput observability, and the CUDA-event timers and
published H100 rates that the card's scripts (``chip_smoke.py`` and the
tools under ``tools/``) time and bound kernels with.

Port of ``noise_gnn_tpu/utils/profiling.py``:

* ``trace(name)``      — context manager adding a named region to a
                         ``torch.profiler`` trace (and an NVTX range on a card);
* ``start_profile`` /
  ``stop_profile``     — one ``torch.profiler`` session, written as a Chrome
                         trace into a directory;
* ``Throughput``       — epoch-level counter turning step times into
                         edges/s, seeds/s and step-latency percentiles.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

HBM_BYTES_PER_S = 3.35e12  # H100 SXM memory rate, published
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores, published


_session: dict = {}


@contextlib.contextmanager
def trace(name: str):
    """A named region: a ``record_function`` span in a profiler trace, and
    an NVTX range where CUDA is available."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def start_profile(log_dir: str) -> None:
    """Start one profiler session (the CPU, and the card where there is
    one); :func:`stop_profile` writes its trace into ``log_dir``."""
    if _session:
        raise RuntimeError("a profile is already running")
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.__enter__()
    _session.update(prof=prof, log_dir=log_dir)


def stop_profile() -> str:
    """Stop the session and write its Chrome trace; returns the file's path."""
    if not _session:
        raise RuntimeError("no profile is running")
    prof, log_dir = _session.pop("prof"), _session.pop("log_dir")
    prof.__exit__(None, None, None)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    return path


def tree_edges_per_batch(batch_size: int, fanouts: tuple[int, ...]) -> int:
    """Sampled (parent, child) pairs per k-hop tree batch — the unit behind
    the edges/s counter (matches the BASELINE.md north-star metric)."""
    total, width = 0, batch_size
    for f in fanouts:
        width *= f
        total += width
    return total


class Throughput:
    """Accumulates per-step wall times; reports edges/s and percentiles."""

    def __init__(self, batch_size: int, fanouts: tuple[int, ...]):
        self.edges_per_batch = tree_edges_per_batch(batch_size, fanouts)
        self.batch_size = batch_size
        self._times: list[float] = []
        self._t0: float | None = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._t0 is not None:
            self._times.append(now - self._t0)
        self._t0 = now

    def epoch_stats(self) -> dict:
        if not self._times:
            return {}
        t = np.asarray(self._times)
        stats = {
            "steps": int(t.size),
            "step_ms_p50": float(np.percentile(t, 50) * 1e3),
            "step_ms_p99": float(np.percentile(t, 99) * 1e3),
            "edges_per_s": float(self.edges_per_batch / np.median(t)),
            "seeds_per_s": float(self.batch_size / np.median(t)),
        }
        self._times.clear()
        self._t0 = None
        return stats


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


def call_times(fn, device: torch.device, iters: int, warm: int = 1) -> dict[str, list[float]]:
    """Each of ``iters`` calls of ``fn`` after ``warm``, timed on its own:
    ``ms`` by CUDA events around the call on a card (``None`` on the CPU)
    and ``wall_ms`` by the host's clock from the call to the end of its
    device work. The measuring tools (``tools/``) take medians or minima
    of these."""
    for _ in range(warm):
        fn()
    cuda = device.type == "cuda"
    times: dict[str, list] = {"ms": [], "wall_ms": []}
    for _ in range(iters):
        if cuda:
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            fn()
            end.record()
            end.synchronize()
            times["ms"].append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times["ms"].append(None)
        times["wall_ms"].append((time.perf_counter() - t0) * 1e3)
    return times


def time_turns(fns: dict, turns: int, reps: int, warm: int = 2) -> dict[str, list[float]]:
    """``time_ms`` of each named function in turns: every function once per
    turn, ``turns`` turns, so that a drift of the card's clock or of its
    neighbours falls on all of them alike. Returns each name's times."""
    times: dict[str, list[float]] = {name: [] for name in fns}
    for _ in range(turns):
        for name, fn in fns.items():
            times[name].append(time_ms(fn, reps, warm))
    return times
