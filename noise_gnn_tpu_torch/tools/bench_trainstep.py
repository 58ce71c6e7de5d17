"""Train-step benchmark: the sampled-leaf against the exact-leaf co-teaching step.

    python -m noise_gnn_tpu_torch.tools.bench_trainstep [--nodes 1200000] [--deg 26]
        [--feat 100] [--classes 47] [--hidden 256] [--batch 512] [--fanouts 15,10,5]
        [--steps 30] [--dtype bfloat16] [--modes sampled,exact] [--reps 3] [--cpu]

Port of ``tools/bench_trainstep.py``: the products shape (1.2 M nodes of
in-degree 26, 100 bf16 features, 47 classes, two 3 x 256 SAGE nets, batch
512, fanouts 15, 10, 5) through the port's co-teaching epoch driver
(``train/steps.py::ct_epoch``) for ``--steps`` steps. ``exact`` builds its
fused ``[N, 2F]`` leaf table with ``ops/leaf_agg.py::fused_leaf_table``
(the SpMM kernel on a card) and samples one hop fewer; ``sampled`` samples
every hop. The graph is drawn on the device from a seeded
``torch.Generator`` (a fixed in-degree CSR with uniform sources, uniform
labels): the JAX tool draws the same kind of graph with ``jax.random``, so
the two graphs differ by PRNG. Each mode runs one warm-up epoch and then
``--reps`` epochs, each from fresh states (built before the timing starts,
so the nets' init is not in the time), timed with CUDA events; a step's
time is the fastest epoch's over its steps (as the JAX tool takes the
fastest of three). The JSON line gives ms a step (events and host wall)
and tree edges/s (``utils/profiling.py::tree_edges_per_batch``) per mode.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import torch

from ..graph.containers import CSRGraph
from ..models import nets
from ..ops.leaf_agg import fused_leaf_table
from ..train import steps as S
from ..utils.profiling import call_times, tree_edges_per_batch
from .common import card_info, log, tool_device

FORGET_RATE = 0.2


def make_data(dev, nodes: int, deg: int, feat: int, classes: int, dtype: torch.dtype,
              steps: int, batch: int) -> tuple[S.GraphData, torch.Tensor, torch.Tensor]:
    """(data, seeds [steps, batch], masks): the fixed-degree CSR, features,
    labels and seed batches, drawn on ``dev`` from ``torch.Generator`` seed 0."""
    gen = torch.Generator(device=dev).manual_seed(0)
    e = nodes * deg
    indptr = torch.arange(nodes + 1, device=dev, dtype=torch.int64) * deg
    indices = torch.randint(0, nodes, (e,), generator=gen, device=dev, dtype=torch.int32)
    x = torch.randn((nodes, feat), generator=gen, device=dev).to(dtype)
    y = torch.randint(0, classes, (nodes,), generator=gen, device=dev)
    seeds = torch.randint(0, nodes, (steps, batch), generator=gen, device=dev)
    data = S.GraphData(x=x, y=y, yhn=y, clean=torch.ones(nodes, dtype=torch.bool, device=dev),
                       csr=CSRGraph(indptr, indices, nodes))
    return data, seeds, torch.ones((steps, batch), dtype=torch.bool, device=dev)


def sage_spec(feat: int, hidden: int, classes: int, layers: int, dtype: str) -> nets.NetSpec:
    return nets.NetSpec(module="sage", in_size=feat, hidden_size=hidden, out_size=classes,
                        num_layers=layers, dropout=0.5, compute_dtype=dtype)


def adam(params):
    return torch.optim.Adam(params, lr=1e-3)


def fresh_states(spec: nets.NetSpec, dev) -> tuple[S.TrainState, S.TrainState]:
    return tuple(S.init_state(torch.Generator(device=dev).manual_seed(seed), spec, adam, dev)
                 for seed in (1, 2))


def run(cpu: bool = False, nodes: int = 1_200_000, deg: int = 26, feat: int = 100,
        classes: int = 47, hidden: int = 256, batch: int = 512,
        fanouts: tuple[int, ...] = (15, 10, 5), steps: int = 30, dtype: str = "bfloat16",
        modes: tuple[str, ...] = ("sampled", "exact"), reps: int = 3) -> dict:
    dev = tool_device(cpu)
    log(f"device: {dev}; N={nodes} deg={deg} F={feat} C={classes} hidden={hidden} "
        f"batch={batch} fanouts={fanouts} {dtype}, {steps} steps")
    data, seeds, masks = make_data(dev, nodes, deg, feat, classes, getattr(torch, dtype),
                                   steps, batch)
    spec = sage_spec(feat, hidden, classes, len(fanouts), dtype)
    edges = tree_edges_per_batch(batch, fanouts)
    out = {}
    for mode in modes:
        if mode not in ("sampled", "exact"):
            raise ValueError(f"unknown mode {mode!r}")
        exact = mode == "exact"
        d, row = data, {}
        if exact:
            t0 = time.perf_counter()
            d = dataclasses.replace(data, leaf_agg=fused_leaf_table(data.x, data.csr, "mean"))
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            row["leaf_table_s"] = time.perf_counter() - t0
            log(f"[{mode}] leaf table ({nodes * deg / 1e6:.1f} M edges): "
                f"{row['leaf_table_s']:.2f} s")

        # the warm-up's and each timed epoch's fresh states, built outside the timed window
        pairs = [fresh_states(spec, dev) for _ in range(reps + 1)]

        def epoch(d=d, exact=exact, pairs=pairs):
            s1, s2 = pairs.pop()
            gen = torch.Generator(device=dev).manual_seed(9)
            m = S.ct_epoch(spec, s1, s2, d, seeds, masks, gen, FORGET_RATE, fanouts,
                           exact_leaf=exact)
            return float(m["loss_1"])

        t = call_times(epoch, dev, reps)
        per = min(t["ms"]) if dev.type == "cuda" else min(t["wall_ms"])
        row.update(ms_per_step=per / steps, wall_ms_per_step=min(t["wall_ms"]) / steps,
                   tree_edges_per_s=edges / (per / steps * 1e-3))
        log(f"[{mode}] {row['ms_per_step']:.3f} ms/step "
            f"({row['tree_edges_per_s'] / 1e6:.1f} M tree edges/s)")
        out[mode] = row
    res = {"metric": "train_step_ms", "modes": out, "tree_edges_per_batch": edges,
           "nodes": nodes, "deg": deg, "feat": feat, "classes": classes, "hidden": hidden,
           "batch": batch, "fanouts": list(fanouts), "steps": steps, "dtype": dtype,
           "reps": reps, **card_info(dev)}
    if "sampled" in out and "exact" in out:
        res["speedup_exact_vs_sampled"] = out["sampled"]["ms_per_step"] / out["exact"]["ms_per_step"]
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--nodes", type=int, default=1_200_000)
    ap.add_argument("--deg", type=int, default=26)
    ap.add_argument("--feat", type=int, default=100)
    ap.add_argument("--classes", type=int, default=47)
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--fanouts", default="15,10,5")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    ap.add_argument("--modes", default="sampled,exact")
    ap.add_argument("--reps", type=int, default=3)
    a = ap.parse_args(argv)
    res = run(a.cpu, a.nodes, a.deg, a.feat, a.classes, a.hidden, a.batch,
              tuple(int(f) for f in a.fanouts.split(",")), a.steps, a.dtype,
              tuple(a.modes.split(",")), a.reps)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
