"""The program's spans and counters, the profiler session an operator
starts, and the CUDA-event timers and published H100 rates that the card's
scripts (``chip_smoke.py`` and the tools under ``tools/``) time and bound
kernels with.

Port of ``noise_gnn_tpu/utils/profiling.py``, whose spans here also time
themselves:

* ``trace(name)``      — a named span of the program. A running
                         ``torch.profiler`` session is the switch: with none,
                         it is one shared null context and costs one flag
                         check; within one, it is a ``record_function``
                         range in the trace and a row of the span table;
* ``count(name, mask)``— a counter of the True entries of a mask over its
                         size, kept on the mask's device while a profiler
                         runs (``counting()`` says whether one does, for a
                         mask that costs work to build);
* ``spans`` / ``counts``
  / ``reset``          — the span table and the counters: read, and emptied;
* ``capturing`` /
  ``replay``           — the spans and counters of work captured in a CUDA
                         graph, recorded at every replay that runs under a
                         profiler;
* ``start_profile`` /
  ``stop_profile``     — one ``torch.profiler`` session, written as a Chrome
                         trace into a directory.

A span's row holds its calls, its total time and its self time (the total
less what its child spans cover), timed between two marks on the clock of
the work it covers: CUDA events on the current stream once CUDA is in use
in the process, the host's clock otherwise. Event pairs are resolved when
they have completed (``Event.query``, no sync) and the rest when the table
is read. Spans nest within one thread.

Inside ``capturing()`` (a CUDA graph's capture), whether or not a profiler
runs, a span is two external timing events, which the graph records on
every replay, and a counter keeps its mask, which every replay refills.
``replay`` then adds the span rows and the counters of each replay that
runs while a profiler does, after the previous replay's events have been
read, since this one records over them.
"""

from __future__ import annotations

import collections
import contextlib
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

HBM_BYTES_PER_S = 3.35e12  # H100 SXM memory rate, published
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores, published

_profiling = torch._C._autograd._profiler_enabled  # a running profiler session
_OFF = contextlib.nullcontext()

_session: dict = {}


class _Table:
    """What the spans and counters have recorded since the last reset."""

    def __init__(self):
        self.rows: dict[str, list] = {}  # name -> [calls, ms, self ms]
        self.pending: collections.deque = collections.deque()  # (name, parent, start, end)
        self.open: list[str] = []  # the names of the open spans, innermost last
        self.events: list = []  # finished CUDA events, reused
        self.counts: dict[str, list] = {}  # name -> [device count, slots]
        self.capture: Capture | None = None  # the CUDA graph being captured

    def mark(self, cuda: bool):
        """A span's edge: a CUDA event on the current stream, or the host's
        clock."""
        if not cuda:
            return time.perf_counter()
        ev = self.events.pop() if self.events else torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def close(self, name: str, start, end) -> None:
        self.open.pop()
        self.pending.append((name, self.open[-1] if self.open else None, start, end, True))
        self.resolve(wait=False)

    def resolve(self, wait: bool) -> None:
        """Add the finished spans to the rows, oldest first: their ends were
        marked in this order on one clock, so they complete in it."""
        while self.pending:
            name, parent, start, end, pooled = self.pending[0]
            if isinstance(end, float):
                ms = (end - start) * 1e3
            else:
                if not end.query():
                    if not wait:
                        return
                    end.synchronize()
                ms = start.elapsed_time(end)
                if pooled:
                    self.events += (start, end)
            self.pending.popleft()
            row = self.rows.setdefault(name, [0, 0.0, 0.0])
            row[0] += 1
            row[1] += ms
            row[2] += ms
            if parent is not None:
                self.rows.setdefault(parent, [0, 0.0, 0.0])[2] -= ms


_table = _Table()


class Capture:
    """The spans and counters met while a CUDA graph was captured: each
    span as (name, parent, start, end) with external timing events, in the
    order the spans closed, and each counter as (name, mask)."""

    def __init__(self):
        self.spans: list[tuple] = []
        self.counts: list[tuple[str, torch.Tensor]] = []
        self.open: list[str] = []


class _CapturedSpan:
    __slots__ = ("name", "start")

    def __init__(self, name: str):
        self.name = name

    def _mark(self):
        ev = torch.cuda.Event(enable_timing=True, external=True)
        ev.record()
        return ev

    def __enter__(self):
        _table.capture.open.append(self.name)
        self.start = self._mark()
        return self

    def __exit__(self, *exc):
        cap = _table.capture
        end = self._mark()
        cap.open.pop()
        cap.spans.append((self.name, cap.open[-1] if cap.open else None, self.start, end))
        return False


class _Span:
    __slots__ = ("name", "rf", "start")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rf = record_function(self.name)
        self.rf.__enter__()
        _table.open.append(self.name)
        self.start = _table.mark(torch.cuda.is_initialized())
        return self

    def __exit__(self, *exc):
        end = _table.mark(not isinstance(self.start, float))
        self.rf.__exit__(*exc)
        _table.close(self.name, self.start, end)
        return False


def trace(name: str):
    """A named span of the program: the shared null context when no
    profiler session runs; within one, a ``record_function`` range and a
    row of :func:`spans`; inside :func:`capturing`, two events that the
    graph records."""
    if _table.capture is not None:
        return _CapturedSpan(name)
    return _Span(name) if _profiling() else _OFF


def counting() -> bool:
    """Whether :func:`count` counts: a profiler session runs, or a graph
    is being captured (whose replays may run under one)."""
    return _table.capture is not None or _profiling()


def count(name: str, mask: torch.Tensor) -> None:
    """While a profiler session runs, add the True entries of ``mask`` to
    counter ``name`` (on the mask's device, no sync) and its size to the
    counter's slots. Inside :func:`capturing` the mask is kept for the
    replays."""
    if _table.capture is not None:
        _table.capture.counts.append((name, mask))
        return
    if not _profiling():
        return
    c = _table.counts.get(name)
    if c is None:
        c = _table.counts[name] = [torch.zeros((), dtype=torch.int64, device=mask.device), 0]
    c[0] += mask.sum()
    c[1] += mask.numel()


def spans() -> dict[str, dict]:
    """``{name: {"calls", "ms", "self_ms"}}`` of every span recorded since
    the last :func:`reset`, waiting for the device where it must."""
    _table.resolve(wait=True)
    return {k: {"calls": c, "ms": ms, "self_ms": own} for k, (c, ms, own) in _table.rows.items()}


def counts() -> dict[str, dict]:
    """``{name: {"hits", "slots"}}`` of every counter since the last
    :func:`reset` (reading them syncs with the device)."""
    return {k: {"hits": int(n.item()), "slots": s} for k, (n, s) in _table.counts.items()}


def reset() -> None:
    """Empty the span table and the counters."""
    _table.rows.clear()
    _table.pending.clear()
    _table.counts.clear()


@contextlib.contextmanager
def capturing():
    """Record the spans and counters of the work inside as a
    :class:`Capture`, for the CUDA graph captured there."""
    if _table.capture is not None:
        raise RuntimeError("a capture is already being recorded")
    _table.capture = cap = Capture()
    try:
        yield cap
    finally:
        _table.capture = None


def replay(graph, cap: Capture) -> None:
    """``graph.replay()``; while a profiler runs, the spans and counters
    ``cap`` recorded at its capture are added for this replay, the
    outermost spans as children of the innermost open one."""
    if not _profiling():
        graph.replay()
        return
    _table.resolve(wait=True)  # the previous replay's events, before this one records over them
    graph.replay()
    parent = _table.open[-1] if _table.open else None
    for name, par, start, end in cap.spans:
        _table.pending.append((name, par if par is not None else parent, start, end, False))
    _table.resolve(wait=False)
    for name, mask in cap.counts:
        count(name, mask)


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
