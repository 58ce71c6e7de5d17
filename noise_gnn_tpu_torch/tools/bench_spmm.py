"""SpMM throughput: edges/s of the SAGE mean aggregation on one CUDA card.

    python -m noise_gnn_tpu_torch.tools.bench_spmm [--nodes 1000000] [--edges 32000000]
        [--feat 256] [--dtype bfloat16] [--iters 5] [--cpu]

Port of ``bench.py``. The graph is ``bench.py``'s, from the same
``numpy.random.default_rng(0)`` draws (``bench.py:79-83``): E uniform
sources, E uniform destinations counted into a destination-major CSR, so it
equals the JAX bench's bit for bit; the features come from a seeded
``torch.Generator`` on the device. ``--cpu`` cuts the shape to 50,000 nodes
and 1,000,000 edges, as ``bench.py:66-67`` does. Legs, each timed call by
call with CUDA events after a warm-up, the median of ``--iters`` calls
(``bench.py``'s scalar-fetch timing answered a TPU's remote link; a card
needs none):

* ``single``: one application of ``ops/spmm.py::Spmm`` (the CUDA kernel);
* ``chained``: K = 8 data-dependent applications, each link's output the
  next link's input (``bench.py:112-122``), counted as 8E edges;
* ``dual``: one application over ``[N, 2F]``, the pair eval's width
  (``bench.py:142``), counted as 2E model-edges;
* ``baseline`` and ``baseline_chained``: the reference mechanism, the
  port's ``ops/scatter.py::gather_scatter_mean`` (a gather of the source
  rows and an ``index_add_`` scatter-mean), alone and as the same K = 8
  chain (``bench.py:172-176``). Its gather takes ``baseline_chunks`` slabs
  of edges at a time (``ops/scatter.py::edge_chunk``: [E, F] messages over
  ~128 M elements are never held whole);
* ``torch_sparse``: the library's CSR @ dense product with 1/deg values,
  the yardstick of PERF.md's kernel table (on the CPU, where torch.sparse
  has no bf16 product, over f32 copies: ``torch_sparse_dtype``).

The JSON line keeps ``bench.py``'s keys: ``value`` is the best
single-stream rate of either mechanism, ``vs_baseline`` the chained kernel
over the chained reference mechanism (like for like, ``bench.py:201-219``),
``vs_baseline_one_jit`` one application over one (a single call here). It
adds ``vs_torch_sparse`` (one application over the library's) and
``sol_fraction``: ``value`` over the speed of light at the H100's 3.35 TB/s,
one feature row read from memory per edge (``bench.py:11-14``; E x F bytes
a call, which a kernel that keeps rows in cache needs not move, so this is
a share of a per-edge gather's rate, not a roofline); ``bound_ms``, the
least time of one application at this shape by the rule of PERF.md's
kernel table (x, the CSR and the output each moved once at 3.35 TB/s, or
E x F + N x F float32 operations at 67 TFLOP/s, whichever is larger), and
``bound_fraction``, ``bound_ms`` over the ``single`` leg's ms; and each
leg's ms.
No leg is optional: a leg that fails fails the tool.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

from ..ops.scatter import edge_chunk, gather_scatter_mean
from ..ops.spmm import Spmm
from ..utils.profiling import FP32_OPS_PER_S, HBM_BYTES_PER_S, call_times
from .common import card_info, log, tool_device

K = 8  # links of the chained legs
CPU_NODES, CPU_EDGES = 50_000, 1_000_000


def make_graph(nodes: int, edges: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``bench.py``'s graph: (indptr [N+1] int64, sources [E] int32 grouped
    by destination row, in-degrees [N])."""
    rng = np.random.default_rng(0)
    src = rng.integers(0, nodes, edges).astype(np.int32)
    counts = np.bincount(rng.integers(0, nodes, edges), minlength=nodes)
    indptr = np.zeros(nodes + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    return indptr, src, counts


def features(nodes: int, feat: int, dtype: torch.dtype, device, seed: int = 0) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((nodes, feat), generator=gen, device=device).to(dtype)


def _median_ms(fn, device, iters: int) -> float:
    t = call_times(fn, device, iters)
    return statistics.median(t["ms"] if device.type == "cuda" else t["wall_ms"])


def run(cpu: bool = False, nodes: int = 1_000_000, edges: int = 32_000_000, feat: int = 256,
        dtype: str = "bfloat16", iters: int = 5) -> dict:
    """Every leg at this shape; the JSON line's dict."""
    dev = tool_device(cpu)
    if cpu:
        nodes, edges = min(nodes, CPU_NODES), min(edges, CPU_EDGES)
    n, e, f = nodes, edges, feat
    dt = getattr(torch, dtype)
    log(f"device: {dev}; N={n} E={e} F={f} {dtype}")
    indptr_np, src_np, counts = make_graph(n, e)
    indptr = torch.from_numpy(indptr_np).to(dev)
    src = torch.from_numpy(src_np).to(dev)
    x = features(n, f, dt, dev, 0)

    t0 = time.perf_counter()
    op = Spmm(indptr, src)
    log(f"Spmm pack: {time.perf_counter() - t0:.2f} s")

    def chain(step):
        def go():
            y = x
            for _ in range(K):
                y = step(y)
            return y
        return go

    ms = {"single": _median_ms(lambda: op(x), dev, iters),
          "chained": _median_ms(chain(lambda y: op(y, out_dtype=dt)), dev, iters)}
    x2 = features(n, 2 * f, dt, dev, 1)
    ms["dual"] = _median_ms(lambda: op(x2), dev, iters)
    del x2

    dst = torch.repeat_interleave(torch.arange(n, device=dev),
                                  torch.from_numpy(counts).to(dev))
    ei = torch.stack([src.long(), dst])
    del dst
    ms["baseline"] = _median_ms(lambda: gather_scatter_mean(x, ei, n), dev, iters)
    ms["baseline_chained"] = _median_ms(chain(lambda y: gather_scatter_mean(y, ei, n)),
                                        dev, iters)
    del ei

    # torch.sparse has no bf16 CSR product on the CPU
    lib_dt = torch.float32 if dev.type == "cpu" else dt
    deg = torch.from_numpy(counts).to(dev)
    vals = (1.0 / deg.clamp(min=1).float()).repeat_interleave(deg).to(lib_dt)
    lib_a = torch.sparse_csr_tensor(indptr.to(torch.int32), src, vals, (n, n))
    xl = x.to(lib_dt)
    ms["torch_sparse"] = _median_ms(lambda: lib_a @ xl, dev, iters)

    nbytes = 2 * n * f * x.element_size() + e * src.element_size() + (n + 1) * 8
    b_ms, o_ms = nbytes / HBM_BYTES_PER_S * 1e3, (e * f + n * f) / FP32_OPS_PER_S * 1e3
    s = {k: v * 1e-3 for k, v in ms.items()}
    rate = {"single": e / s["single"], "chained": K * e / s["chained"],
            "dual": 2 * e / s["dual"], "baseline": e / s["baseline"],
            "baseline_chained": K * e / s["baseline_chained"],
            "torch_sparse": e / s["torch_sparse"]}
    for leg, r in rate.items():
        log(f"{leg:17s} {ms[leg]:10.3f} ms -> {r / 1e6:9.1f} M edges/s")
    value = max(rate["single"], rate["chained"], rate["baseline"], rate["baseline_chained"])
    sol = HBM_BYTES_PER_S / (f * x.element_size())
    log(f"speed of light at {HBM_BYTES_PER_S / 1e12:.2f} TB/s, one row read per edge: "
        f"{sol / 1e6:.0f} M edges/s; best single-stream {100 * value / sol:.1f}%")
    log(f"bound of one application: {max(b_ms, o_ms):.3f} ms ({nbytes / 1e9:.3f} GB moved "
        f"once); single {ms['single']:.3f} ms, {100 * max(b_ms, o_ms) / ms['single']:.1f}%")
    return {
        "metric": "spmm_edges_per_s_per_chip",
        "value": value,
        "unit": "edges/s",
        "vs_baseline": rate["chained"] / rate["baseline_chained"],
        "vs_baseline_one_jit": rate["single"] / rate["baseline"],
        "vs_torch_sparse": rate["single"] / rate["torch_sparse"],
        "sol_fraction": value / sol,
        "bound_ms": max(b_ms, o_ms),
        "bound_by": "bytes" if b_ms >= o_ms else "operations",
        "bound_fraction": max(b_ms, o_ms) / ms["single"],
        "single_edges_per_s": rate["single"],
        "chained_edges_per_s": rate["chained"],
        "dual_stream_model_edges_per_s": rate["dual"],
        "baseline_edges_per_s": rate["baseline"],
        "baseline_chained_edges_per_s": rate["baseline_chained"],
        "torch_sparse_edges_per_s": rate["torch_sparse"],
        "ms": ms,
        "baseline_chunks": -(-e // edge_chunk(e, f)),
        "torch_sparse_dtype": str(lib_dt)[6:],
        "nodes": n, "edges": e, "feat": f, "dtype": dtype, "iters": iters, "chain": K,
        **card_info(dev),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help=f"run on the CPU, cut to {CPU_NODES} nodes and {CPU_EDGES} edges")
    ap.add_argument("--nodes", type=int, default=1_000_000)
    ap.add_argument("--edges", type=int, default=32_000_000)
    ap.add_argument("--feat", type=int, default=256)
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    ap.add_argument("--iters", type=int, default=5)
    a = ap.parse_args(argv)
    print(json.dumps(run(a.cpu, a.nodes, a.edges, a.feat, a.dtype, a.iters)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
