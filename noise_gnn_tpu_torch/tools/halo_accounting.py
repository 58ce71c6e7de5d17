"""Exchange-volume accounting of the halo partition (host only).

    python -m noise_gnn_tpu_torch.tools.halo_accounting [--shards 8] [--feat 256]
        [--dataset ogbn-products] [--scale 1] [--reorder] [--iters 8]
        [--link-bytes-per-s R] [--spmm-edges-per-s R] [--cpu]

Port of ``tools/halo_accounting.py``: the byte counts of the node-sharded
aggregation's boundary exchange (``parallel/halo.py``), a layer of bf16
activations of width ``--feat``, on a (synthetic) dataset graph split into
``--shards`` ranks, optionally after ``locality_order`` (``--reorder``):
the boundary rows, the bytes of the true rows (``actual``), of the padded
[D, B_max, F] all_to_all buffer (``padded``), of the round-robin exchange
(``ppermute_rounds``), of the rows that leave their rank
(``wire_bytes_offdiag``), and of the replicated all-reduce design the halo
replaced. The counts equal the JAX tool's bit for bit.

The JAX tool turned them into times with a TPU's link rate and its kernel's
rate. This one holds no rate of its own: ``--link-bytes-per-s`` gives
``per_rank_exchange_s`` (a rank's share of the wire bytes over that rate),
``--spmm-edges-per-s`` gives ``per_rank_spmm_s`` (a rank's share of the
edges), and both together ``predicted_scaling_efficiency``; without them
those keys are left out. The work is host numpy and the port's native
label propagation; as every tool of the port it asks for ``--cpu`` where no
card is visible, and names the card its host holds.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from ..graph.datasets import load_network
from ..parallel.halo import build_halo_partition, locality_order
from .common import card_info, log, tool_device


def run(cpu: bool = False, shards: int = 8, feat: int = 256, dataset: str = "ogbn-products",
        scale: int = 1, reorder: bool = False, iters: int = 8,
        link_bytes_per_s: float | None = None, spmm_edges_per_s: float | None = None) -> dict:
    dev = tool_device(cpu)
    t0 = time.time()
    g = load_network({"dataset_name": dataset, "synthetic_scale": scale,
                      "whole_test_set": True, "seed": 0})
    log(f"graph: {g.num_nodes} nodes, {g.edge_index.shape[1]} edges ({time.time() - t0:.0f}s)")
    t0 = time.time()
    edges = g.edge_index
    if reorder:
        _, inv = locality_order(edges, g.num_nodes, shards, iters=iters)
        edges = inv[edges]
        log(f"locality_order: {time.time() - t0:.0f}s")
        t0 = time.time()
    part = build_halo_partition(edges, g.num_nodes, shards)
    log(f"partition: {time.time() - t0:.0f}s")

    comm = part.comm_bytes_per_layer(feat, bytes_per_el=2)  # bf16 activations
    e = int(g.edge_index.shape[1])
    out = {
        "shards": shards,
        "reorder": bool(reorder),
        "nodes": g.num_nodes,
        "edges": e,
        "boundary_rows_total": int(part.boundary_rows_total),
        "boundary_fraction_of_nodes": round(part.boundary_rows_total / g.num_nodes, 4),
        "alltoall_bytes_actual": int(comm["actual"]),
        "wire_bytes_offdiag": int(comm.get("actual_wire", comm["actual"])),
        "alltoall_bytes_padded": int(comm["padded"]),
        "ppermute_rounds_bytes": int(comm.get("ppermute_rounds", 0)),
        "replicated_psum_equiv_bytes": int(comm["replicated_psum_equiv"]),
        "comm_reduction_vs_psum": round(comm["replicated_psum_equiv"] / max(comm["actual"], 1), 1),
    }
    if link_bytes_per_s:
        out["link_bytes_per_s"] = link_bytes_per_s
        out["per_rank_exchange_s"] = out["wire_bytes_offdiag"] / shards / link_bytes_per_s
    if spmm_edges_per_s:
        out["spmm_edges_per_s"] = spmm_edges_per_s
        out["per_rank_spmm_s"] = e / shards / spmm_edges_per_s
    if link_bytes_per_s and spmm_edges_per_s:
        out["predicted_scaling_efficiency"] = out["per_rank_spmm_s"] / (
            out["per_rank_spmm_s"] + out["per_rank_exchange_s"])
    return {**out, **card_info(dev)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--feat", type=int, default=256)
    ap.add_argument("--dataset", default="ogbn-products")
    ap.add_argument("--scale", type=int, default=1)
    ap.add_argument("--reorder", action="store_true",
                    help="apply locality_order (balanced label propagation)")
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--link-bytes-per-s", type=float, default=None,
                    help="a rank's exchange rate, for the time estimates")
    ap.add_argument("--spmm-edges-per-s", type=float, default=None,
                    help="a rank's SpMM rate (e.g. bench_spmm's value), for the time estimates")
    a = ap.parse_args(argv)
    res = run(a.cpu, a.shards, a.feat, a.dataset, a.scale, a.reorder, a.iters,
              a.link_bytes_per_s, a.spmm_edges_per_s)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
