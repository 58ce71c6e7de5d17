"""The flat-subgraph aggregation's three forms at the CTP cora shape.

    python -m noise_gnn_tpu_torch.tools.exp_flat_agg [--batch 512] [--iters 5] [--cpu]

Port of ``tools/exp_flat_agg.py``. The CTP, TE and H steps aggregate the
sampled tree's flat subgraph (seeds, then each depth's children
contiguously). The JAX package aggregates it by reshape and masked sum
(``ops/tree_agg.py``) because on the TPU the edge-list scatter-add was
about three orders of magnitude slower. This tool asks the same question
of the port on the card, at B = 512, fanouts (10, 5), F = 8710 f32
(n_sub = 31,232 rows, E = 30,720 edges), for three forms:

* ``edge_list``: the mean over the structural edge list,
  ``ops/scatter.py::gather_scatter_mean`` on ``ops/sampler.py::
  flat_edge_index``, a row gather and ``index_add_``, taken in the edge
  chunks of ``ops/scatter.py::edge_chunk`` as the main path would (the JSON
  line gives the chunks: the JAX scatter was one op);
* ``structured``: ``ops/tree_agg.py::tree_gather_scatter`` on a
  ``TreeTopo``, each depth reshaped to [parents, fanout, F], masked, summed
  and divided by max(count, 1), the leaves zero-filled: the form the main
  path runs;
* ``delta``: ``ops/scatter.py::segment_sum`` of ``2 * int(n_sub * 0.1)``
  random edges' gathered rows (a rewire's added edges).

Each form's calls are timed with ``utils/profiling.py::call_times``: CUDA
events around the call alone, and the line states the median. The JAX
tool's ``timeit`` synchronised through ``float(jnp.sum(out))``, which
puts a full reduction of the output inside its window, so its numbers are
not taken by this protocol. ``max_abs_diff`` is between ``edge_list`` and
``structured`` (``max_rel_diff``: over the largest ``structured`` value).
``bound_ms`` is each form's bytes (its inputs read once, its output
written once) over the card's memory rate. The edge mask is all ones, as
in the JAX tool. ``--cpu`` cuts the shape to F = 64 and, unless
``--batch`` is given, B = 16.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import sys

import numpy as np
import torch

from ..ops.sampler import flat_edge_index
from ..ops.scatter import edge_chunk, fast_take, gather_scatter_mean, segment_sum
from ..ops.tree_agg import TreeTopo, tree_gather_scatter
from ..utils.profiling import HBM_BYTES_PER_S, call_times
from .common import card_info, log, tool_device

FULL = dict(batch=512, feat=8710)  # the CTP cora shape (sagePL hid 256, F = 8710)
CPU_CUT = dict(batch=16, feat=64)
FANOUTS = (10, 5)
DELTA_FRACTION = 0.1  # the JAX tool's delta edges: 2 * int(n_sub * 0.1)


def tree_sizes(batch: int, fanouts: tuple[int, ...]) -> list[int]:
    sizes = [batch]
    for f in fanouts:
        sizes.append(sizes[-1] * f)
    return sizes


def forms(x: torch.Tensor, edge_mask: torch.Tensor, batch: int, fanouts: tuple[int, ...],
          add: torch.Tensor) -> dict:
    """The three forms as callables on ``x`` [n_sub, F]: ``edge_mask`` [E]
    masks the structural edges of (a) and (b); ``add`` [2, k] are (c)'s
    (source, destination) rows."""
    n_sub = x.shape[0]
    ei = torch.from_numpy(flat_edge_index(batch, fanouts)).to(x.device)
    topo = TreeTopo(batch, fanouts, edge_mask)
    return {"edge_list": lambda: gather_scatter_mean(x, ei, n_sub, edge_mask),
            "structured": lambda: tree_gather_scatter(x, topo),
            "delta": lambda: segment_sum(fast_take(x, add[0]), add[1], n_sub)}


def form_bytes(n_sub: int, edges: int, delta: int, feat: int, itemsize: int) -> dict:
    """Bytes each form must move: the rows it reads once (each message's
    source row; the ids and mask are under 0.1% here and not counted) and
    its [n_sub, F] output written once."""
    out = n_sub * feat * itemsize
    return {"edge_list": edges * feat * itemsize + out,
            "structured": edges * feat * itemsize + out,
            "delta": delta * feat * itemsize + out}


def run(cpu: bool = False, batch: int | None = None, iters: int = 5) -> dict:
    dev = tool_device(cpu)
    shape = CPU_CUT if cpu else FULL
    batch = shape["batch"] if batch is None else batch
    feat, fanouts = shape["feat"], FANOUTS
    sizes = tree_sizes(batch, fanouts)
    n_sub, edges = sum(sizes), sum(sizes[1:])
    delta = 2 * int(n_sub * DELTA_FRACTION)
    chunk = edge_chunk(edges, feat)
    log(f"device: {dev}; B={batch} fanouts={fanouts} F={feat} f32: n_sub={n_sub} "
        f"edges={edges}, delta edges {delta}, edge chunks {math.ceil(edges / chunk)}")
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((n_sub, feat), generator=gen, device=dev)
    rng = np.random.default_rng(0)
    add = torch.from_numpy(rng.integers(0, n_sub, (2, delta))).to(dev)
    mask = torch.ones(edges, dtype=torch.bool, device=dev)
    fns = forms(x, mask, batch, fanouts, add)
    times = {name: call_times(fn, dev, iters) for name, fn in fns.items()}
    stat = "ms" if dev.type == "cuda" else "wall_ms"
    med = {name: statistics.median(t[stat]) for name, t in times.items()}
    a, b = fns["edge_list"](), fns["structured"]()
    diff = float((a - b).abs().max())
    rel = diff / max(float(b.abs().max()), 1e-30)
    del a, b
    nbytes = form_bytes(n_sub, edges, delta, feat, x.element_size())
    bound = {name: v / HBM_BYTES_PER_S * 1e3 for name, v in nbytes.items()}
    for name in fns:
        log(f"{name}: median {med[name]:.3f} {stat} (bound {bound[name]:.3f} ms)")
    return {"metric": "flat_agg_ms", "stat": f"median of {iters} {stat}",
            "ms": med if dev.type == "cuda" else None,
            "wall_ms": {name: statistics.median(t["wall_ms"]) for name, t in times.items()},
            "times_ms": {name: t[stat] for name, t in times.items()},
            "edge_list_over_structured": med["edge_list"] / med["structured"],
            "max_abs_diff": diff, "max_rel_diff": rel, "edge_chunk": chunk,
            "edge_chunks": math.ceil(edges / chunk), "bytes": nbytes, "bound_ms": bound,
            "bound_by": "bytes", "n_sub": n_sub, "edges": edges, "delta_edges": delta,
            "batch": batch, "fanouts": list(fanouts), "feat": feat, "dtype": "float32",
            "iters": iters, **card_info(dev)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--iters", type=int, default=5)
    a = ap.parse_args(argv)
    res = run(a.cpu, a.batch, a.iters)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
