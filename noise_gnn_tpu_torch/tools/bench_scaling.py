"""Scaling efficiency of the data-parallel co-teaching step: throughput at 1
and at N ranks.

    python -m noise_gnn_tpu_torch.tools.bench_scaling [--world 1 2 ...] [--nodes 50000]
        [--feat 128] [--hidden 256] [--batch-per-device 256] [--iters 10] [--cpu]

Port of ``tools/bench_scaling.py``. At each world size N it times the DP
co-teaching step of ``parallel/`` (``make_mesh``, ``make_dp_ct_step``, each
rank's block of the batch as ``shard_batch`` takes it) on a synthetic graph
of ``--nodes`` nodes, degree 16, 16 classes, sym 0.3 noise; sage 3 x
``--hidden``, fanouts 15, 10, 5, a global batch of N x ``--batch-per-device``
seeds. The rate is tree edges a step (``utils/profiling.py::
tree_edges_per_batch`` of the global batch) over the mean step time of
``--iters`` steps after one warm-up step; efficiency is rate_N / (N x
rate_1), against the smallest world size given.

World size 1 runs in this process, without a process group. A larger one
runs N rank processes (this module with ``--worker``) joined through a
``file://`` rendezvous in a temporary directory. They use NCCL, rank r on
``cuda:r``, when the machine has a card for each rank; otherwise gloo, the
ranks sharing card 0 (NCCL refuses two ranks on one card), or on the CPU
under ``--cpu``. The JSON line names each world size's backend; where ranks
share one card (``shared_card``) or the CPU, their rate is not a scaling
number (``scaling_number: false``): they divide one device's time.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from ..graph.datasets import synthetic_graph
from ..models import nets
from ..noise import flip_label, noise_or_not
from ..parallel import make_dp_ct_step, make_mesh, multihost
from ..train import steps as S
from ..utils.profiling import tree_edges_per_batch
from .bench_trainstep import adam
from .common import ROOT, card_info, log, tool_device

CLASSES = 16
FANOUTS = (15, 10, 5)
RANK_TIMEOUT_S = 900.0  # seconds each world size's ranks may take


def measure(world: int, args: dict, dev: torch.device) -> dict:
    """Mean step time and rate of the DP step over this process's mesh (no
    group: one rank)."""
    mesh = make_mesh()
    g = synthetic_graph(args["nodes"], args["feat"], CLASSES, args["nodes"] * 16, seed=0)
    yhn, _ = flip_label(g.y, CLASSES, "sym", 0.3, np.random.default_rng(0))
    data = S.GraphData(x=torch.from_numpy(g.x).to(dev), y=torch.from_numpy(g.y).to(dev).long(),
                       yhn=torch.from_numpy(yhn).to(dev).long(),
                       clean=torch.from_numpy(noise_or_not(g.y, yhn)).to(dev), csr=g.csr(dev))
    spec = nets.NetSpec("sage", args["feat"], args["hidden"], CLASSES, len(FANOUTS), 0.5)
    s1, s2 = (S.init_state(torch.Generator(device=dev).manual_seed(k), spec, adam, dev, mesh)
              for k in (1, 2))
    bs = args["batch_per_device"] * world
    seeds = torch.arange(bs, device=dev) % args["nodes"]
    mask = torch.ones(bs, dtype=torch.bool, device=dev)
    step = make_dp_ct_step(spec, FANOUTS, mesh)
    gen = torch.Generator(device=dev).manual_seed(0)
    float(step(s1, s2, data, seeds, mask, gen, 0.2)["loss_1"])  # warm-up
    t0 = time.perf_counter()
    for _ in range(args["iters"]):
        m = step(s1, s2, data, seeds, mask, gen, 0.2)
    float(m["loss_1"])  # the last step's end
    dt = (time.perf_counter() - t0) / args["iters"]
    edges = tree_edges_per_batch(bs, FANOUTS)
    log(f"{world} rank(s): {dt * 1e3:.1f} ms/step, {edges / dt / 1e6:.1f} M edges/s "
        f"(global batch {bs})")
    return {"ms_per_step": dt * 1e3, "rate": edges / dt, "edges_per_batch": edges}


def _worker(spec: str) -> int:
    """One rank: join the group, measure, and (rank 0) write the result."""
    a = json.loads(spec)
    multihost.initialize(init_method=f"file://{a['pg']}", world_size=a["world"],
                         rank=a["rank"], backend=a["backend"],
                         device="cpu" if a["cpu"] else None)
    if a["cpu"]:
        dev = torch.device("cpu")
    else:
        dev = torch.device("cuda", a["rank"] if a["backend"] == "nccl" else 0)
        torch.cuda.set_device(dev)
    res = measure(a["world"], a["args"], dev)
    if a["rank"] == 0:
        Path(a["out"]).write_text(json.dumps(res))
    torch.distributed.destroy_process_group()
    return 0


def _run_ranks(world: int, backend: str, cpu: bool, args: dict) -> dict:
    """Rank 0's result once every rank has exited 0; all ranks are killed
    when one fails (the others would wait for it) or the time runs out."""
    with tempfile.TemporaryDirectory() as tmp:
        env = {k: v for k, v in os.environ.items()
               if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
        if cpu:
            env["OMP_NUM_THREADS"] = "1"
        out, procs = Path(tmp) / "rank0.json", []
        for r in range(world):
            spec = json.dumps(dict(world=world, rank=r, backend=backend, cpu=cpu, args=args,
                                   pg=str(Path(tmp) / "pg"), out=str(out)))
            with open(Path(tmp) / f"rank{r}.log", "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "noise_gnn_tpu_torch.tools.bench_scaling",
                     "--worker", spec], stdout=f, stderr=subprocess.STDOUT, env=env,
                    cwd=str(ROOT)))
        deadline = time.monotonic() + RANK_TIMEOUT_S
        try:
            while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
                if any(p.returncode not in (None, 0) for p in procs):
                    break
                time.sleep(0.2)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, p in enumerate(procs):
            text = (Path(tmp) / f"rank{r}.log").read_text()
            log(text.rstrip())
            if p.returncode != 0:
                raise RuntimeError(f"rank {r} of {world} exited {p.returncode}:\n{text[-4000:]}")
        return json.loads(out.read_text())


def run(cpu: bool = False, world: tuple[int, ...] = (1,), nodes: int = 50_000, feat: int = 128,
        hidden: int = 256, batch_per_device: int = 256, iters: int = 10) -> dict:
    dev = tool_device(cpu)
    args = dict(nodes=nodes, feat=feat, hidden=hidden, batch_per_device=batch_per_device,
                iters=iters)
    cards = 0 if cpu else torch.cuda.device_count()
    res, backend = {}, {}
    for n in world:
        if n == 1:
            backend[n] = None
            res[n] = measure(1, args, dev)
        else:
            backend[n] = "nccl" if n <= cards else "gloo"
            res[n] = _run_ranks(n, backend[n], cpu, args)
    base = min(res)
    shared = not cpu and any(b == "gloo" for b in backend.values())
    return {
        "metric": "dp_scaling_efficiency",
        "rates_edges_per_s": {n: r["rate"] for n, r in res.items()},
        "ms_per_step": {n: r["ms_per_step"] for n, r in res.items()},
        "edges_per_batch": {n: r["edges_per_batch"] for n, r in res.items()},
        "efficiency": {n: res[n]["rate"] / (res[base]["rate"] * n / base) for n in res},
        "backend": backend,
        "shared_card": shared,
        "scaling_number": not cpu and not shared,
        "nodes": nodes, "feat": feat, "hidden": hidden, "batch_per_device": batch_per_device,
        "fanouts": list(FANOUTS), "iters": iters,
        **card_info(dev),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--world", type=int, nargs="+", default=[1])
    ap.add_argument("--nodes", type=int, default=50_000)
    ap.add_argument("--feat", type=int, default=128)
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--batch-per-device", type=int, default=256)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.worker is not None:
        return _worker(a.worker)
    res = run(a.cpu, tuple(a.world), a.nodes, a.feat, a.hidden, a.batch_per_device, a.iters)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
