#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``noise_gnn_tpu_torch``) on one card.

    python3 chip_smoke.py [--out DIR]

Phases (any failure exits nonzero; the last stdout line is printed only
when every phase passed):

1. Device: ``nvidia-smi`` name and power limit, the torch device; build both
   CUDA kernels with ``nvcc``, one after the other: the SpMM
   (``noise_gnn_tpu_torch/csrc/spmm.cu``) and the gather ring
   (``noise_gnn_tpu_torch/csrc/gather_ring.cu``), and report the build time.
2. Kernels against their plain versions on the card. SpMM: mean and sum, f32
   and bf16 input and output, F in {100, 128, 256, 512}, on a graph with
   isolated rows (N not a multiple of any block size), a power-law graph with
   hubs of in-degree 1e5..2.5e5, and a graph whose rows sit at S - 1, S,
   S + 1 and 2S + 1 in-edges (S = ``spmm.SEG_EDGES``, the most edges one
   segment takes) beside hubs of 1e5 and 2.5e5.
   Tolerance: |kernel - plain| <= max(1e-5, 4 sqrt(deg) 2^-24) * agg(|x|)
   per element (fp32 sums in another order: ~1e-5 relative to the
   summands' magnitude, widened by the probabilistic sqrt(deg) rounding
   bound for hub rows), plus one bf16 ulp of the output for bf16 outputs;
   and two calls must give bit-equal outputs.
   Gather ring: bit-equal to ``gather_ring_reference`` (the kernel only
   copies) for F in {4, 128, 256} and (depth, chunk) pairs with depth ==
   chunk, depth < chunk and depth 1.
   Then the main paths' functions on small inputs, on the card against the
   CPU (which the CPU tests hold against the JAX package): one co-teaching
   epoch of 4 steps at the products widths and the pair eval, and one CTP
   epoch of 4 steps with the consistency term at the arxiv widths (sagePL
   2 x 256, fanouts [10, 5]); f32, dropout 0, deterministic trees, the same
   initial params; summed losses within 1e-5 relative, params within
   1e-4, logits within 1e-4.
3. Main path at full width: ``noise_gnn_tpu_torch.main.main`` on
   ``configs/config_products.yml`` with num_runs 1, max_epochs 2,
   reinit_retries 0 (the full synthetic products graph, 2,449,029 nodes,
   100 features, 47 classes, ~61.86 M edges; 3 x 256 SAGE, fanouts
   [15, 10, 5], bf16, exact leaf; the config's own train_frac 2, ~1292 steps
   per epoch: at train_frac 40, 65 steps per epoch, two epochs leave both
   nets at chance, as the JAX package's own products curves stay at chance
   through their first ~1300 steps). The SpMM launch counts are reset just
   before and read just after: the leaf table (F = 100), the paired
   co-teaching eval (F = 512) and the baseline eval (F = 256) must all have
   gone through the kernel. Losses must be finite, and the last epoch's
   validation accuracy above 1/47 for the better co-teaching net and for
   the baseline net.
4. CTP path at full width: ``main`` on ``configs/config_ctp.yml`` (the
   synthetic ogbn-arxiv graph, 169,343 nodes, 128 features, 40 classes;
   sagePL 2 x 256, fanouts [10, 5], batch 512, f32) with num_runs 1 and
   reinit_retries 0, four times, the SpMM counts reset before and read after
   each: 2 epochs uninterrupted (epoch 0 without, epoch 1 with the
   consistency term); 1 epoch with ``ckpt_every: 1``; ``resume: true`` to
   epoch 2; and ``do_train: false`` (``algo_type: coteaching``, as the JAX
   package loads a checkpoint of two nets) on the last checkpoint. Losses
   finite, validation accuracy of the better net above 1/40, the resumed
   epoch 1's losses within 1e-4 relative of the uninterrupted run's (the
   backward's scatter-adds are atomics, so two runs differ in the last
   bits), the loaded nets' validation accuracies within 1e-3 of the resumed
   run's last epoch's (the same params, evaluated one net at a time instead
   of as a pair), and the SpMM launched for the leaf table (F = 128, once per
   run), the pair eval (F = 512, once per epoch) and the loaded nets' eval
   (F = 256, twice).
5. Gather probe path: ``noise_gnn_tpu_torch.tools.gather_probe.run`` at the
   JAX tool's shapes (x [1,000,000, 256] f32, E = 131,072, P = 16, chunk
   2048, depth 2, 4, 8, 16, 24) with the gather-ring counts reset before
   and read after; then, at the same shapes, the kernel's rings bit-equal
   to the plain version's at every depth, and the plain version (which,
   like the kernel, makes all P x E copies: one ``index_select``) timed.
   The bound counts each distinct block read once from device memory (the
   passes' re-reads may hit L2), the ids, and the final rings written.
6. The SpMM at the main paths' shapes on the full graphs (products F = 100,
   256 and 512 bf16; arxiv F = 128, 512 and 256 f32; mean). For each graph
   it logs the largest in-degrees and the segment schedule's size and pack
   time on the card. At each shape the kernel is held against its plain
   version with the tolerance of phase 2 and two of its calls must be
   bit-equal; then it is timed with CUDA events after warm-up in turns with
   one library call for the same function (``torch.sparse`` CSR @ dense, a
   yardstick): kernel, library, kernel, library; then its plain version;
   beside the bound: max(bytes / 3.35 TB/s, adds / 67 TFLOP/s), counting x,
   indices and indptr read once and out written once.

Then it prints one ``{"kernels": [...]}`` line (errors from the full-size
checks, launches from the main paths), the ``nvidia-smi`` line and, last,
``{"ok": true, "device": {...}}``. Details go to ``<out>/report.json``.
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from noise_gnn_tpu_torch.eval.inference import FullGraphInference
from noise_gnn_tpu_torch.graph.containers import CSRGraph, coo_to_csr
from noise_gnn_tpu_torch.graph.datasets import load_network
from noise_gnn_tpu_torch.main import main as port_main
from noise_gnn_tpu_torch.models import nets
from noise_gnn_tpu_torch.models.convert import params_from_jax, params_to_jax
from noise_gnn_tpu_torch.ops import gather_ring, spmm
from noise_gnn_tpu_torch.ops.leaf_agg import fused_leaf_table
from noise_gnn_tpu_torch.tools import gather_probe
from noise_gnn_tpu_torch.train import steps
from noise_gnn_tpu_torch.utils.config import load_config
from noise_gnn_tpu_torch.utils.profiling import (FP32_OPS_PER_S, HBM_BYTES_PER_S, time_ms,
                                                  time_turns)

CONFIG = "configs/config_products.yml"
CTP_CONFIG = "configs/config_ctp.yml"
SOURCE = "noise_gnn_tpu_torch/csrc/spmm.cu"
REPLACES = "noise_gnn_tpu/ops/pallas_spmm.py:147"
GATHER_SOURCE = "noise_gnn_tpu_torch/csrc/gather_ring.cu"
GATHER_REPLACES = "tools/exp_dma_gather.py:56"
# the main paths' SpMM shapes: (name, F, launches expected per run)
SHAPES = (("leaf table", 100, 1), ("eval pair", 512, 4), ("eval single", 256, 4))
CTP_SHAPES = (("arxiv leaf table", 128), ("arxiv eval pair", 512), ("arxiv load eval", 256))
# the gather ring's small (depth, chunk) cases: depth 1, depth == chunk, and
# depth < chunk (slots rewritten, the last copy kept); also run by
# tests/test_torch_port_gpu.py
GATHER_CASES = ((1, 1), (1, 8), (2, 8), (3, 16), (16, 16), (7, 64), (24, 2048))


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


# ------------------------------------------------------------- correctness


def isolated_graph(rng):
    n = 100_003
    e = 2_000_000
    dst = rng.integers(0, int(n * 0.9), e)  # the last 10% of rows get no edges
    src = rng.integers(0, n, e)
    return n, src, dst


def hub_graph(rng):
    n = 300_007
    hubs = np.repeat(np.asarray([5, 77_777, n - 1]), [100_000, 150_000, 250_000])
    tail = (n * rng.random(4_000_000) ** 3).astype(np.int64)  # power-law-ish
    dst = np.concatenate([hubs, tail])
    src = rng.integers(0, n, dst.shape[0])
    return n, src, dst


def boundary_graph(rng):
    """Rows at S - 1, S, S + 1 and 2S + 1 in-edges (1000 of each) beside two
    hubs of 1e5 and 2.5e5 and a power-law-ish tail."""
    n, s = 150_001, spmm.SEG_EDGES
    sizes = np.repeat([s - 1, s, s + 1, 2 * s + 1], 1000)
    rows = np.repeat(np.arange(10, 10 + sizes.shape[0]), sizes)
    hubs = np.repeat(np.asarray([3, n - 2]), [100_000, 250_000])
    tail = (n * rng.random(2_000_000) ** 3).astype(np.int64)
    tail = tail[(tail < 10) | (tail >= 10 + sizes.shape[0])]  # the sized rows stay exact
    dst = np.concatenate([rows, hubs, tail])
    src = rng.integers(0, n, dst.shape[0])
    return n, src, dst


def degree_profile(indptr: torch.Tensor) -> dict:
    """The five largest in-degrees, the median and p99 (of up to 2^20
    sampled rows) and the count of rows with none."""
    deg = (indptr[1:] - indptr[:-1]).float()
    q = torch.quantile(deg[torch.randperm(deg.numel(), device=deg.device)[:1 << 20]],
                       torch.tensor([0.5, 0.99], device=deg.device))
    return dict(top5=[int(v) for v in torch.topk(deg, 5).values.tolist()],
                median=float(q[0]), p99=float(q[1]), isolated=int((deg == 0).sum()))


def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    e = torch.floor(torch.log2(v.abs().clamp(min=2.0 ** -126)))
    return torch.pow(2.0, e - 7)


def sum_rtol(indptr: torch.Tensor) -> torch.Tensor:
    """Per-row relative tolerance [N, 1] of an fp32 sum in another order:
    max(1e-5, 4 sqrt(deg) 2^-24)."""
    deg = (indptr[1:] - indptr[:-1]).float()[:, None]
    return torch.clamp(4 * deg.clamp(min=1).sqrt() * 2.0 ** -24, min=1e-5)


def compare(got: torch.Tensor, ref: torch.Tensor, mag: torch.Tensor, rtol: torch.Tensor,
            rows: int = 1 << 18) -> dict:
    """Hold the kernel's output against the plain version's fp32 ``ref``:
    |got - ref| <= rtol * mag (mag = the same SpMM of |x|), plus one bf16 ulp
    of ref for a bf16 output. Row block by row block, so that the full
    graph's comparison stays within a few GB."""
    abs_err = rel = over = 0.0
    for lo in range(0, ref.shape[0], rows):
        r, m = ref[lo:lo + rows], mag[lo:lo + rows]
        err = (got[lo:lo + rows].float() - r).abs()
        tol = rtol[lo:lo + rows] * m
        if got.dtype == torch.bfloat16:
            tol = tol + bf16_ulp(r)
        abs_err = max(abs_err, err.max().item())
        rel = max(rel, (err / m.clamp(min=1e-30)).max().item())
        over = max(over, (err / tol.clamp(min=1e-30)).max().item())
    return dict(max_abs_err=abs_err, max_err_rel_to_magnitude=rel, max_err_over_tol=over,
                ok=over <= 1.0)


def log_case(case: dict) -> None:
    log("    {graph} F={F} {x}->{out} {m}: max abs err {max_abs_err:.3e}, "
        "max err/agg|x| {max_err_rel_to_magnitude:.3e}, err/tol {max_err_over_tol:.3f}, "
        "repeat bit-equal {repeat_equal} {v}".format(
            m="mean" if case["mean"] else "sum", v="ok" if case["ok"] else "FAIL", **case))


def check_kernel(dev) -> list[dict]:
    rng = np.random.default_rng(0)
    cases = []
    for gname, make in (("isolated rows", isolated_graph), ("power-law hubs", hub_graph),
                        ("segment boundaries", boundary_graph)):
        n, src, dst = make(rng)
        indptr, indices = coo_to_csr(src.astype(np.int32), dst.astype(np.int32), n)
        csr = CSRGraph(torch.from_numpy(indptr).to(dev), torch.from_numpy(indices).to(dev), n)
        op = spmm.Spmm.from_csr(csr)
        rtol = sum_rtol(csr.indptr)
        deg = csr.indptr[1:] - csr.indptr[:-1]
        sch = op.schedule
        log(f"  graph '{gname}': N={n} E={indices.shape[0]} max in-degree "
            f"{int(deg.max())} isolated rows {int((deg == 0).sum())}, "
            f"{sch.seg_len.shape[0]} segments of <= {spmm.SEG_EDGES} edges, "
            f"{sch.comb_row.shape[0]} rows split into {sch.num_partials}")
        gen = torch.Generator(device=dev).manual_seed(1)
        for f in (100, 128, 256, 512):
            x32 = torch.randn((n, f), generator=gen, device=dev)
            for x_dtype in (torch.float32, torch.bfloat16):
                x = x32.to(x_dtype)
                for mean in (True, False):
                    ref = spmm.spmm_reference(csr.indptr, csr.indices, x, mean, torch.float32)
                    mag = spmm.spmm_reference(csr.indptr, csr.indices, x.abs(), mean,
                                              torch.float32)
                    for out_dtype in (torch.float32, torch.bfloat16):
                        got = op(x, mean=mean, out_dtype=out_dtype)
                        case = dict(graph=gname, F=f, x=str(x_dtype)[6:],
                                    out=str(out_dtype)[6:], mean=mean)
                        case.update(compare(got, ref, mag, rtol))
                        repeat_equal = torch.equal(got, op(x, mean=mean, out_dtype=out_dtype))
                        case.update(repeat_equal=repeat_equal, ok=case["ok"] and repeat_equal)
                        cases.append(case)
                        log_case(case)
        del csr, op, x32, x, ref, mag, got
        torch.cuda.empty_cache()
    return cases


def check_small_path(dev) -> dict:
    """The main path's training and eval functions on a small input, on the
    card against the CPU (where they run the plain SpMM and are held
    against the JAX package by tests/test_torch_port_slice.py): one
    co-teaching epoch of 4 steps and the pair eval, at the products
    widths, f32, dropout 0, every in-degree <= the fanouts (so every tree is
    deterministic), both devices from the same initial params."""
    n, f, c, hidden, fanouts, bs, nsteps = 5_000, 100, 47, 256, (15, 10, 5), 512, 4
    rng = np.random.default_rng(3)
    deg = rng.integers(0, min(fanouts) + 1, n)
    ei = np.stack([rng.integers(0, n, deg.sum()), np.repeat(np.arange(n), deg)])
    x = rng.standard_normal((n, f)).astype(np.float32)
    y = rng.integers(0, c, n)
    yhn = np.where(rng.random(n) < 0.3, rng.integers(0, c, n), y)
    seeds = rng.permutation(n)[: nsteps * bs].reshape(nsteps, bs)
    masks = np.ones((nsteps, bs), bool)
    masks[-1, -37:] = False  # a padded last batch
    spec = nets.NetSpec(module="sage", in_size=f, hidden_size=hidden, out_size=c,
                        num_layers=3, dropout=0.0)
    # initial params as numpy, copied onto each device (models/convert.py)
    init = [params_to_jax(nets.init_params(torch.Generator().manual_seed(s), spec))
            for s in (1, 2)]

    def adam(params):
        return torch.optim.Adam(params, lr=1e-3)

    def run_on(d):
        csr = CSRGraph.from_coo(ei.astype(np.int32), n, d)
        tx = torch.from_numpy(x).to(d)
        table = fused_leaf_table(tx, csr)
        data = steps.GraphData(x=tx, y=torch.from_numpy(y).to(d),
                               yhn=torch.from_numpy(yhn).to(d),
                               clean=torch.from_numpy(y == yhn).to(d), csr=csr,
                               leaf_agg=table)
        states = [steps.state_from_params(params_from_jax(q, d), adam) for q in init]
        m = steps.ct_epoch(spec, *states, data, torch.from_numpy(seeds).to(d),
                           torch.from_numpy(masks).to(d), torch.Generator(device=d),
                           0.2, fanouts, exact_leaf=True)
        return m, [params_to_jax(s.params) for s in states], FullGraphInference(
            spec, csr, x_agg=table[:, f:]), tx

    m_gpu, p_gpu, infer_gpu, x_gpu = run_on(dev)
    m_cpu, p_cpu, infer_cpu, x_cpu = run_on(torch.device("cpu"))
    # fp32 sums and products in another order; Adam's m/sqrt(v) turns last-bit
    # gradient differences into steps of up to ~lr, hence params at 1e-4
    loss_err = max(abs(float(m_gpu[k]) - float(m_cpu[k])) / abs(float(m_cpu[k]))
                   for k in ("loss_1", "loss_2"))
    param_err = max(float(np.abs(a[k] - b[k]).max()) for pa, pb in zip(p_gpu, p_cpu)
                    for a, b in zip(pa["convs"], pb["convs"]) for k in a)
    # the pair eval of the same (CPU-trained) params on both devices
    logit_err = max((a.cpu() - b).abs().max().item() for a, b in zip(
        infer_gpu.pair(*(params_from_jax(q, dev) for q in p_cpu), x_gpu),
        infer_cpu.pair(*(params_from_jax(q) for q in p_cpu), x_cpu)))
    rep = dict(loss_rel_err=loss_err, param_max_abs_err=param_err,
               logit_max_abs_err=logit_err,
               ok=loss_err <= 1e-5 and param_err <= 1e-4 and logit_err <= 1e-4)
    log(f"  {nsteps} co-teaching steps + pair eval, N={n}, E={ei.shape[1]}: summed-loss "
        f"rel err {loss_err:.2e} (tol 1e-5), params max abs err {param_err:.2e} "
        f"(tol 1e-4), pair-eval logits max abs err {logit_err:.2e} (tol 1e-4)")
    if not rep["ok"]:
        raise RuntimeError(f"the port on the card disagrees with the CPU: {rep}")
    return rep


def check_gather_small(dev) -> list[dict]:
    """The gather ring against its plain version on small inputs: bit-equal
    (the kernel only copies), for depth == chunk, depth < chunk (slots
    rewritten, the last copy kept) and depth 1."""
    rng = np.random.default_rng(5)
    cases = []
    for f in (4, 128, 256):
        x3 = torch.from_numpy(rng.standard_normal((1000, 8, f)).astype(np.float32)).to(dev)
        for depth, chunk in GATHER_CASES:
            idx = torch.from_numpy(rng.integers(0, 1000, chunk * 5).astype(np.int32)).to(dev)
            got = gather_ring.gather_ring(x3, idx, depth, chunk, 3)
            want = gather_ring.gather_ring_reference(x3, idx, depth, chunk, 3)
            cases.append(dict(F=f, depth=depth, chunk=chunk, equal=bool(torch.equal(got, want))))
    bad = [c for c in cases if not c["equal"]]
    log(f"  gather ring: {len(cases) - len(bad)} of {len(cases)} small cases bit-equal")
    if bad:
        raise RuntimeError(f"gather ring disagrees with its plain version: {bad}")
    return cases


def check_small_ctp(dev) -> dict:
    """The CTP path's training function on a small input, on the card
    against the CPU (held against the JAX package by
    tests/test_torch_port_ctp.py): one CTP epoch of 4 steps with the
    consistency term at the arxiv widths (sagePL 2 x 256 on 128 features,
    40 classes, fanouts [10, 5], batch 512), f32, dropout 0, every
    in-degree <= the fanouts, both devices from the same initial params."""
    n, f, c, hidden, fanouts, bs, nsteps = 5_000, 128, 40, 256, (10, 5), 512, 4
    rng = np.random.default_rng(4)
    deg = rng.integers(0, min(fanouts) + 1, n)
    ei = np.stack([rng.integers(0, n, deg.sum()), np.repeat(np.arange(n), deg)])
    x = rng.standard_normal((n, f)).astype(np.float32)
    y = rng.integers(0, c, n)
    yhn = np.where(rng.random(n) < 0.3, rng.integers(0, c, n), y)
    seeds = rng.permutation(n)[: nsteps * bs].reshape(nsteps, bs)
    masks = np.ones((nsteps, bs), bool)
    masks[-1, -37:] = False  # a padded last batch
    spec = nets.NetSpec(module="sagePL", in_size=f, hidden_size=hidden, out_size=c,
                        num_layers=2, dropout=0.0, nbr_nodes=n)
    init = [params_to_jax(nets.init_params(torch.Generator().manual_seed(s), spec))
            for s in (1, 2)]

    def adam(params):
        return torch.optim.Adam(params, lr=1e-3)

    def run_on(d):
        data = steps.GraphData(x=torch.from_numpy(x).to(d), y=torch.from_numpy(y).to(d),
                               yhn=torch.from_numpy(yhn).to(d),
                               clean=torch.from_numpy(y == yhn).to(d),
                               csr=CSRGraph.from_coo(ei.astype(np.int32), n, d))
        states = [steps.state_from_params(params_from_jax(q, d), adam) for q in init]
        m = steps.ctp_epoch(spec, *states, data, torch.from_numpy(seeds).to(d),
                            torch.from_numpy(masks).to(d), torch.Generator(device=d), 0.2,
                            fanouts, use_cr=True, spl_noise=0.1)
        return {k: float(v) for k, v in m.items()}, [params_to_jax(s.params) for s in states]

    m_gpu, p_gpu = run_on(dev)
    m_cpu, p_cpu = run_on(torch.device("cpu"))
    loss_err = max(abs(m_gpu[k] - m_cpu[k]) / abs(m_cpu[k]) for k in ("loss_1", "loss_2"))
    param_err = max(max(float(np.abs(a["noise"] - b["noise"]).max()),
                        max(float(np.abs(ca[k] - cb[k]).max())
                            for ca, cb in zip(a["convs"], b["convs"]) for k in ca))
                    for a, b in zip(p_gpu, p_cpu))
    rep = dict(loss_rel_err=loss_err, param_max_abs_err=param_err, cr_term=m_gpu["loss_cr_1"],
               ok=loss_err <= 1e-5 and param_err <= 1e-4 and m_cpu["loss_cr_1"] > 0)
    log(f"  {nsteps} CTP steps with the consistency term, N={n}, E={ei.shape[1]}: summed-"
        f"loss rel err {loss_err:.2e} (tol 1e-5), params max abs err {param_err:.2e} "
        f"(tol 1e-4), consistency term {m_gpu['loss_cr_1']:.4f}")
    if not rep["ok"]:
        raise RuntimeError(f"the CTP step on the card disagrees with the CPU: {rep}")
    return rep


# ------------------------------------------------------------ main path


def _drive(cfg: dict) -> dict:
    """Run ``main(cfg)`` with the SpMM counts reset just before and read
    just after; returns the result, wall time, counts, peak memory and the
    run's metrics records."""
    spmm.launch_counts.clear()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = port_main(cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {int(f): int(c) for f, c in spmm.launch_counts.items()}
    metrics = Path(cfg["out_dir"]) / "metrics" / f"{cfg['_output_name']}.jsonl"
    recs = [json.loads(line) for line in metrics.read_text().splitlines()]
    return dict(result=res, wall_s=wall, launches=counts,
                peak_bytes=torch.cuda.max_memory_allocated(), records=recs)


def _events(run: dict, event: str) -> list[dict]:
    return [r for r in run["records"] if r.get("event") == event]


def run_main_path(out: Path) -> dict:
    cfg = load_config(CONFIG)
    cfg.update(num_runs=1, max_epochs=2, reinit_retries=0, out_dir=str(out / "run"))
    r = _drive(cfg)
    res, counts = r["result"], r["launches"]
    ct, base = _events(r, "epoch_ct"), _events(r, "epoch_baseline")
    for e in ct:
        log(f"  CT epoch {e['epoch']}: train {e['epoch_train_s']:.3f} s, eval "
            f"{e['epoch_eval_s']:.3f} s, loss {e['loss_1']:.4f}/{e['loss_2']:.4f}, "
            f"pure {e['pure_ratio_1']:.3f}/{e['pure_ratio_2']:.3f}, val "
            f"{e['val_acc_1']:.4f}/{e['val_acc_2']:.4f}, test "
            f"{e['test_acc_1']:.4f}/{e['test_acc_2']:.4f}")
    for e in base:
        log(f"  baseline epoch {e['epoch']}: train {e['epoch_train_s']:.3f} s, eval "
            f"{e['epoch_eval_s']:.3f} s, loss {e['loss']:.4f}, val {e['val_acc']:.4f}, "
            f"test {e['test_acc']:.4f}")
    log(f"  main(config) wall {r['wall_s']:.1f} s, peak device memory "
        f"{r['peak_bytes'] / 2**30:.2f} GiB, SpMM launches by F {counts}")
    log(f"  results: nalgo {tuple(res['nalgo'])} baseline {tuple(res['baseline'])}")

    if len(ct) != 2 or len(base) != 2:
        raise RuntimeError(f"expected 2 CT and 2 baseline epochs, got {len(ct)}, {len(base)}")
    losses = [e[k] for e in ct for k in ("loss_1", "loss_2")] + [e["loss"] for e in base]
    if not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"non-finite loss: {losses}")
    vals = [max(ct[-1]["val_acc_1"], ct[-1]["val_acc_2"]), base[-1]["val_acc"]]
    if not min(vals) > 1 / 47:
        raise RuntimeError(f"validation accuracy (co-teaching, baseline) not above "
                           f"1/47: {vals}")
    for name, f, want in SHAPES:
        if counts.get(f, 0) < want:
            raise RuntimeError(f"SpMM ({name}, F={f}) launched {counts.get(f, 0)} "
                               f"times on the main path, expected >= {want}")
    if sum(counts.values()) < 9:
        raise RuntimeError(f"SpMM launched {sum(counts.values())} times, expected >= 9")
    return dict(config=CONFIG, wall_s=r["wall_s"], peak_bytes=r["peak_bytes"],
                launches=counts, ct_epochs=ct, baseline_epochs=base,
                nalgo=list(res["nalgo"]), baseline=list(res["baseline"]))


def run_ctp_path(out: Path) -> dict:
    """The CTP path at full width: uninterrupted, killed after epoch 0,
    resumed, and loaded for evaluation (see phase 4 of the module doc)."""
    base = load_config(CTP_CONFIG)
    base.update(num_runs=1, max_epochs=2, reinit_retries=0)
    shutil.rmtree(out / "ctp", ignore_errors=True)  # metrics files append
    ckpt = str(out / "ctp" / "ckpt")
    plan = (("full", {}),
            ("killed", dict(max_epochs=1, ckpt_every=1, ckpt_path=ckpt)),
            ("resumed", dict(resume=True, ckpt_every=1, ckpt_path=ckpt)),
            ("loaded", dict(algo_type="coteaching", do_train=False, ckpt_path=ckpt)))
    want_counts = {"full": {128: 1, 512: 2}, "killed": {128: 1, 512: 1},
                   "resumed": {128: 1, 512: 1}, "loaded": {128: 1, 256: 2}}
    runs = {}
    for name, over in plan:
        cfg = dict(copy.deepcopy(base), out_dir=str(out / "ctp" / name), **over)
        r = runs[name] = _drive(cfg)
        r["epochs"] = _events(r, "epoch_ctp")
        for e in r["epochs"]:
            log(f"  {name} epoch {e['epoch']}: train {e['epoch_train_s']:.3f} s, eval "
                f"{e['epoch_eval_s']:.3f} s, loss {e['loss_1']:.6f}/{e['loss_2']:.6f}, cr "
                f"{e['loss_cr_1']:.4f}/{e['loss_cr_2']:.4f}, pure {e['pure_ratio_1']:.3f}/"
                f"{e['pure_ratio_2']:.3f}, val {e['val_acc_1']:.4f}/{e['val_acc_2']:.4f}, "
                f"test {e['test_acc_1']:.4f}/{e['test_acc_2']:.4f}")
        log(f"  {name}: main(config) wall {r['wall_s']:.1f} s, peak device memory "
            f"{r['peak_bytes'] / 2**30:.2f} GiB, SpMM launches by F {r['launches']}")
        if r["launches"] != want_counts[name]:
            raise RuntimeError(f"CTP run '{name}' launched the SpMM {r['launches']} times "
                               f"by F, expected {want_counts[name]}")
    full, resumed, loaded = runs["full"]["epochs"], runs["resumed"]["epochs"], runs["loaded"]
    if [e["epoch"] for e in full] != [0, 1] or [e["epoch"] for e in resumed] != [1]:
        raise RuntimeError("expected epochs [0, 1] uninterrupted and [1] resumed")
    losses = [e[k] for e in full + resumed for k in ("loss_1", "loss_2", "loss_cr_1")]
    if not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"non-finite CTP loss: {losses}")
    if not (full[0]["loss_cr_1"] == 0.0 and full[1]["loss_cr_1"] > 0.0):
        raise RuntimeError("the consistency term must be off in epoch 0 and on in epoch 1")
    best_val = max(full[-1]["val_acc_1"], full[-1]["val_acc_2"])
    if not best_val > 1 / 40:
        raise RuntimeError(f"CTP validation accuracy {best_val} not above 1/40")
    resume_err = max(abs(resumed[0][k] - full[1][k]) / abs(full[1][k])
                     for k in ("loss_1", "loss_2"))
    acc1, acc2 = loaded["result"]["loaded"]
    load_err = max(abs(acc1["valid"] - resumed[0]["val_acc_1"]),
                   abs(acc2["valid"] - resumed[0]["val_acc_2"]))
    log(f"  resumed epoch 1 against the uninterrupted run: summed losses rel diff "
        f"{resume_err:.3e} (tol 1e-4); loaded nets' validation {acc1['valid']:.4f}/"
        f"{acc2['valid']:.4f} against the resumed run's {resumed[0]['val_acc_1']:.4f}/"
        f"{resumed[0]['val_acc_2']:.4f}")
    if not resume_err <= 1e-4:
        raise RuntimeError(f"resumed epoch 1 is {resume_err:.3e} from the uninterrupted run")
    if not load_err <= 1e-3:
        raise RuntimeError(f"load-and-eval accuracies differ from the run's by {load_err}")
    for r in runs.values():
        del r["result"], r["records"]
    return dict(config=CTP_CONFIG, runs=runs, resume_rel_diff=resume_err,
                load_acc_diff=load_err, best_val=best_val, loaded=dict(acc1=acc1, acc2=acc2))


def run_gather_path(dev) -> dict:
    """The probe tool's path with the gather-ring counts reset before and
    read after, then the kernel's rings held bit-equal to the plain
    version's at every depth at the same shapes, and the plain version
    timed."""
    gather_ring.launch_counts.clear()
    res = gather_probe.run(dev)
    torch.cuda.synchronize()
    counts = {int(d): int(c) for d, c in gather_ring.launch_counts.items()}
    for line in gather_probe.report(res["depths"], res["yardsticks"]):
        log("  " + line)
    x3, idx = gather_probe.make_inputs(dev)
    for row in res["depths"]:
        d = row["depth"]
        args = (x3, idx, d, gather_probe.CHUNK, gather_probe.P)
        got = gather_ring.gather_ring(*args)
        want = gather_ring.gather_ring_reference(*args)
        row.update(equal=bool(torch.equal(got, want)),
                   max_abs_err=float((got - want).abs().max()),
                   plain_ms=time_ms(lambda: gather_ring.gather_ring_reference(*args), reps=5),
                   launches=counts.get(d, 0))
        log(f"  depth {d}: rings bit-equal to the plain version: {row['equal']}, plain "
            f"{row['plain_ms']:.3f} ms, launches on the probe path {row['launches']}")
        del got, want
        if not row["equal"] or row["launches"] == 0:
            raise RuntimeError(f"gather ring at depth {d}: {row}")
    del x3, idx
    torch.cuda.empty_cache()
    return res


# ----------------------------------------------------------------- timing


def time_shapes(dev, config: str, shapes, dtype: torch.dtype) -> list[dict]:
    """Check and time the kernel at a main path's own shapes on its full
    graph: its output (mean, in ``dtype`` in and out, as the path calls it)
    is held against the plain version with the tolerance of ``compare``.
    ``shapes`` are (name, F) pairs; the F of the raw features takes the
    graph's own x, the others random rows."""
    cfg = load_config(config)
    g = load_network(cfg)
    csr = g.csr(dev)
    n, e = g.num_nodes, int(csr.indices.shape[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    op = spmm.Spmm.from_csr(csr)
    torch.cuda.synchronize()
    pack_ms = (time.perf_counter() - t0) * 1e3
    sch = op.schedule
    graph = dict(in_degree=degree_profile(csr.indptr), pack_ms=pack_ms,
                 segments=int(sch.seg_len.shape[0]), seg_edges=spmm.SEG_EDGES,
                 split_rows=int(sch.comb_row.shape[0]), partials=sch.num_partials)
    log(f"  {g.name}: N={n} E={e}, in-degree {graph['in_degree']}; {graph['segments']} "
        f"segments of <= {spmm.SEG_EDGES} edges, {graph['split_rows']} rows split into "
        f"{graph['partials']}; Spmm pack on the card {pack_ms:.1f} ms")
    rtol = sum_rtol(csr.indptr)
    deg = (csr.indptr[1:] - csr.indptr[:-1])
    vals = (1.0 / deg.clamp(min=1).float()).repeat_interleave(deg).to(dtype)
    lib_a = torch.sparse_csr_tensor(csr.indptr.to(torch.int32), csr.indices, vals, (n, n))
    gen = torch.Generator(device=dev).manual_seed(2)
    itemsize = torch.tensor([], dtype=dtype).element_size()
    tname = str(dtype)[6:]
    rows = []
    for name, f in shapes:
        if f == g.num_features:
            x = torch.from_numpy(g.x).to(dev).to(dtype)  # the real leaf input
        else:
            x = torch.randn((n, f), generator=gen, device=dev).to(dtype)
        got = op(x, mean=True, out_dtype=dtype)
        case = dict(graph=f"{g.name} (full)", F=f, x=tname, out=tname, mean=True)
        case.update(compare(
            got, spmm.spmm_reference(csr.indptr, csr.indices, x, True, torch.float32),
            spmm.spmm_reference(csr.indptr, csr.indices, x.abs(), True, torch.float32),
            rtol))
        repeat_equal = torch.equal(got, op(x, mean=True, out_dtype=dtype))
        case.update(repeat_equal=repeat_equal, ok=case["ok"] and repeat_equal)
        del got
        log_case(case)
        turns = time_turns({"kernel": lambda: op(x, mean=True, out_dtype=dtype),
                            "library": lambda: lib_a @ x}, turns=2, reps=10)
        k_ms, l_ms = (sum(turns[k]) / len(turns[k]) for k in ("kernel", "library"))
        p_ms = time_ms(lambda: spmm.spmm_reference(csr.indptr, csr.indices, x, True, dtype),
                       reps=2, warm=1)
        nbytes = n * f * itemsize + e * 4 + (n + 1) * 8 + n * f * itemsize
        nops = e * f + n * f
        b_ms, o_ms = nbytes / HBM_BYTES_PER_S * 1e3, nops / FP32_OPS_PER_S * 1e3
        row = dict(shape=name, F=f, N=n, E=e, dtype=tname, ms=k_ms, plain_ms=p_ms,
                   library_ms=l_ms, library=f"torch.sparse CSR @ dense ({tname})",
                   turns_ms=turns, edge_row_bytes=e * f * itemsize, graph_stats=graph,
                   bound_ms=max(b_ms, o_ms), bound_by="bytes" if b_ms >= o_ms else "operations",
                   bytes=nbytes, ops=nops, check=case)
        rows.append(row)
        log(f"  {name} F={f} {tname}: kernel {k_ms:.3f} ms (turns "
            f"{turns['kernel']}), "
            f"library {l_ms:.3f} ms (turns {turns['library']}), plain {p_ms:.3f} ms, bound "
            f"{row['bound_ms']:.3f} ms ({row['bound_by']}, {nbytes / 1e9:.3f} GB); one source "
            f"row per edge would be {e * f * itemsize / 1e9:.3f} GB")
        del x
        torch.cuda.empty_cache()
        if not case["ok"]:
            raise RuntimeError(f"kernel out of tolerance at the main-path shape: {case}")
    return rows


def spmm_row(row: dict, launches: int) -> dict:
    return dict(
        name=f"spmm_csr ({row['shape']}, F={row['F']} {row['dtype']})", route="cuda",
        source=SOURCE, replaces=REPLACES, launches=launches,
        max_abs_err=row["check"]["max_abs_err"],
        max_err_over_tol=row["check"]["max_err_over_tol"],
        ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
        bound_by=row["bound_by"], library_ms=row["library_ms"])


def run(out: Path) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    out.mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    log(f"[1] device: {smi} | torch {torch.__version__} CUDA {torch.version.cuda} | "
        f"{kind} x{count}")
    t0 = time.perf_counter()
    libs = [spmm.build(), gather_ring.build()]  # a fresh checkout has nothing built
    build_s = time.perf_counter() - t0
    log(f"    built {libs[0].name} from {SOURCE} and {libs[1].name} from {GATHER_SOURCE} "
        f"in {build_s:.1f} s")

    log("[2] kernels against their plain versions")
    cases = check_kernel(dev)
    bad = [c for c in cases if not c["ok"]]
    if bad:
        raise RuntimeError(f"{len(bad)} of {len(cases)} kernel checks out of tolerance: {bad[:3]}")
    log(f"    all {len(cases)} SpMM cases within tolerance")
    gather_cases = check_gather_small(dev)
    small = check_small_path(dev)
    small_ctp = check_small_ctp(dev)

    log("[3] main path: products, full width")
    main_rep = run_main_path(out)

    log("[4] CTP path: arxiv, full width, with resume and load-and-eval")
    ctp_rep = run_ctp_path(out)

    log("[5] gather probe path: the tool's shapes")
    gather_rep = run_gather_path(dev)

    log("[6] SpMM check and timing at the main paths' shapes, full graphs")
    rows = time_shapes(dev, CONFIG, [(name, f) for name, f, _ in SHAPES], torch.bfloat16)
    ctp_rows = time_shapes(dev, CTP_CONFIG, CTP_SHAPES, torch.float32)

    kernels = [spmm_row(row, main_rep["launches"].get(row["F"], 0)) for row in rows]
    ctp_launches = {}
    for r in ctp_rep["runs"].values():
        for f, c in r["launches"].items():
            ctp_launches[f] = ctp_launches.get(f, 0) + c
    kernels += [spmm_row(row, ctp_launches.get(row["F"], 0)) for row in ctp_rows]
    block_sel = gather_rep["yardsticks"]["index_select blocks"]
    row_sel = gather_rep["yardsticks"]["index_select rows"]
    for r in gather_rep["depths"]:
        kernels.append(dict(
            name=f"gather_ring (depth {r['depth']}, chunk {gather_probe.CHUNK}, "
                 f"P={gather_probe.P}, [8, {gather_probe.F}] f32 blocks)",
            route="cuda", source=GATHER_SOURCE, replaces=GATHER_REPLACES,
            launches=r["launches"], max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=block_sel["ms"], library_rows_ms=row_sel["ms"]))
    report = dict(nvidia_smi=smi, device=kind, count=count, build_s=build_s,
                  checks=cases, gather_checks=gather_cases, small_path=small,
                  small_ctp=small_ctp, main_path=main_rep, ctp_path=ctp_rep,
                  gather_path=gather_rep, timing=rows, ctp_timing=ctp_rows, kernels=kernels)
    (out / "report.json").write_text(json.dumps(report, indent=1, default=str))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default="out/chip_smoke",
                        help="directory for the run's logs, metrics and report")
    sys.exit(run(Path(parser.parse_args().out)))
