"""A static-shape training step replayed as one CUDA graph.

A step whose shapes stay the same from call to call, which never waits
for the host and draws its random numbers from one explicit
``torch.Generator``, issues the same chain of kernels at every call. The
host's part of it, hundreds of small launches, can then be done once, at
a capture, and the chain replayed by one launch (``torch.cuda.CUDAGraph``).

:class:`StepGraph` runs the first :data:`WARM` calls eagerly, on a side
stream, where they initialise what is made lazily (cuBLAS's workspace for
that stream, the optimizers' moments); it captures the next call on that
stream and replays it, and replays every later call. From the capture on,
the step's optimizers keep their step counts on the device
(``capturable``), so that a replay advances them and their bias
correction; that correction is then computed in float32 on the device,
where eager Adam computes it in float64 on the host. A replay copies the
call's tensors into the graph's static inputs and returns a clone of its
static output. The generator is registered with the graph, so a replay
draws what an eager step would, and advances the generator as far. The
spans and counters inside the step are recorded at the capture and added
at every replay that runs under a profiler
(``utils/profiling.py::capturing``).

:class:`GraphCache` keeps one graph for each live set of owners (the
optimizers of the states a step updates) and drops it, and so frees its
memory pool, when one of them dies.
"""

from __future__ import annotations

import functools
import weakref
from typing import Callable

import torch

from ..utils import profiling

WARM = 2  # eager calls before the capture


@functools.cache
def _side_stream(device: torch.device) -> torch.cuda.Stream:
    return torch.cuda.Stream(device)


class StepGraph:
    """One step function, eager for its first :data:`WARM` calls, then a
    CUDA graph. ``sig`` is what the capture assumed of the call (the cache
    compares it); ``keep`` is what the graph reads by address and not
    through its inputs, held alive with it."""

    def __init__(self, sig: tuple, keep: tuple):
        self.sig = sig
        self.keep = keep
        self.calls = 0
        self.graph: torch.cuda.CUDAGraph | None = None

    def __call__(self, fn: Callable[..., torch.Tensor], args: tuple[torch.Tensor, ...],
                 gen: torch.Generator, opts: tuple[torch.optim.Optimizer, ...]) -> torch.Tensor:
        """``fn(*args)``, a tensor, where ``fn`` steps the optimizers
        ``opts`` and draws from ``gen`` alone; ``args`` are device tensors
        of the shapes the capture saw."""
        if self.graph is not None:
            for dst, src in zip(self.static, args):
                dst.copy_(src)
            profiling.replay(self.graph, self.cap)
            return self.out.clone()
        side = _side_stream(args[0].device)
        cur = torch.cuda.current_stream(args[0].device)
        side.wait_stream(cur)
        if self.calls < WARM:
            self.calls += 1
            with torch.cuda.stream(side):
                out = fn(*args)
            cur.wait_stream(side)
            return out
        for opt in opts:
            capturable(opt)
        self.static = [a.clone() for a in args]
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(gen)
        with profiling.capturing() as cap, torch.cuda.graph(graph, stream=side):
            out = fn(*self.static)
        self.graph, self.cap, self.out = graph, cap, out
        profiling.replay(graph, cap)
        return out.clone()


def capturable(opt: torch.optim.Optimizer) -> None:
    """Switch ``opt`` (Adam or AdamW) to ``capturable``: its step counts
    move to its parameters' device."""
    for group in opt.param_groups:
        group["capturable"] = True
    for p, st in opt.state.items():
        if "step" in st:
            st["step"] = st["step"].to(p.device)


class GraphCache:
    """One :class:`StepGraph` for each live set of owners; a call with
    another ``sig`` replaces it."""

    def __init__(self):
        self.graphs: dict[tuple[int, ...], StepGraph] = {}

    def get(self, owners: tuple, sig: tuple, keep: tuple) -> StepGraph:
        key = tuple(id(o) for o in owners)
        g = self.graphs.get(key)
        if g is None or g.sig != sig:
            g = self.graphs[key] = StepGraph(sig, keep)
            for o in owners:  # an id is reused only after its owner, and this entry, died
                weakref.finalize(o, self.graphs.pop, key, None)
        return g
