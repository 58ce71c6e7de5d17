#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``noise_gnn_tpu_torch``) on one card.

    python3 chip_smoke.py [--out DIR]

Phases (any failure exits nonzero; the last stdout line is printed only
when every phase passed):

1. Device: ``nvidia-smi`` name and power limit, the torch device; build both
   CUDA kernels with ``nvcc`` and the host graph runtime with ``g++``, all
   started together: the SpMM (``noise_gnn_tpu_torch/csrc/spmm.cu``), the
   gather ring (``noise_gnn_tpu_torch/csrc/gather_ring.cu``) and
   ``noise_gnn_tpu_torch/csrc/graph_runtime.cpp`` (which every CSR of the
   port comes from), and report the build times.
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
   copies) for F in {4, 128, 256}, (depth, chunk) pairs with depth ==
   chunk, depth < chunk and depth 1, and passes in {1, 2, 3, 4, 8, 16};
   those grids fit on the card at once, so the wrapper's rule runs them
   without clusters. Then the same passes at depth 24, F = 256 (one block
   an SM) on grids of over twice the card's SMs, where the rule picks
   clusters: C = 1, 2, 1, 4, 8, 8. Every cluster size it can choose must
   have been launched, each case bit-equal.
   Then the main paths' functions on small inputs, on the card against the
   CPU (which the CPU tests hold against the JAX package): one co-teaching
   epoch of 4 steps at the products widths and the pair eval, and one CTP
   epoch of 4 steps with the consistency term at the arxiv widths (sagePL
   2 x 256, fanouts [10, 5]); f32, dropout 0, deterministic trees, the same
   initial params; summed losses within 1e-5 relative, params within
   1e-4, logits within 1e-4. The rewiring: ``hier_topk`` on 2^20 tied
   values (multiples of 0.25, signed zeros, -inf) and ``topk_rewire_tree``
   on a tree of 32 seeds with fanouts [10, 5, 5] (9,952 rows) over
   exact-arithmetic rows (four entries of +-0.5: every similarity a
   multiple of 0.25, ties everywhere), bit-equal to the CPU, order
   included. Then one TE epoch of 4 steps at the arxiv widths (sagePL
   3 x 256 on 128 features, 40 classes, fanouts [10, 5, 5], batch 32)
   without and with the rewired contrast, on a forest in which no node
   repeats within a step's tree (so no two hidden rows are equal in exact
   arithmetic; see tests/test_torch_port_te.py) and a negative-view rate
   of 0.01 (``shuffle_pos`` then shuffles nothing, so no random draw
   differs between the devices): summed losses within 1e-5 relative,
   params within 1e-4, and whether each step's rewired topologies agree,
   with the margin of the k-th pick where they do not.
   Then one H epoch of 4 steps with the pseudo net on, at config_h.yml's
   widths (sageH 2 x 128 twice and a sage 2 x 128 pseudo net on 128
   features, 40 classes, fanouts [10, 5], batch 32) on a forest, with
   exact-arithmetic features (the pseudo net's rewire scores the raw
   features, so its picks are decided by the tie rule): every step's
   rewired positive graph equal, summed losses within 1e-5 relative, the
   three nets' params within 1e-4. And one contrastive finetune epoch of 4
   steps at config_contrast.yml's widths (sageFC 2 x 128, batch 512) on four
   given views whose in-degrees are <= the fanouts: summed losses within
   1e-5 relative, params within 1e-4, except the projection's bias, which
   feeds a batch norm (its gradient is 0 in exact arithmetic and rounding
   noise on each device, which Adam turns into steps of up to lr either
   way): it must stay within 4 x lr of its initial value.
3. Main path at full width: ``noise_gnn_tpu_torch.main.main`` on
   ``configs/config_products.yml`` with num_runs 1, max_epochs 2,
   reinit_retries 0 (the full synthetic products graph, 2,449,029 nodes,
   100 features, 47 classes, ~61.86 M edges; 3 x 256 SAGE, fanouts
   [15, 10, 5], bf16, exact leaf; the config's own train_frac 2, ~1292 steps
   per epoch: at train_frac 40, 65 steps per epoch, two epochs leave both
   nets at chance, as the JAX package's own products curves stay at chance
   through their first ~1300 steps). It logs the setup's CSR build seconds
   (the native counting sort). The SpMM launch counts are reset just
   before and read just after: the leaf table (F = 100), the paired
   co-teaching eval (F = 512) and the baseline eval (F = 256) must all have
   gone through the kernel. Losses must be finite, and the last epoch's
   validation accuracy above 1/47 for the better co-teaching net and for
   the baseline net.
4. CTP path at full width: ``main`` on ``configs/config_ctp.yml`` (the
   synthetic ogbn-arxiv graph, 169,343 nodes, 128 features, 40 classes;
   sagePL 2 x 256, fanouts [10, 5], batch 512, f32) with num_runs 1 and
   reinit_retries 0, five times, the SpMM counts reset before and read after
   each: 2 epochs uninterrupted (epoch 0 without, epoch 1 with the
   consistency term), twice; 1 epoch with ``ckpt_every: 1``; ``resume:
   true`` to epoch 2; and ``do_train: false`` (``algo_type: coteaching``,
   as the JAX package loads a checkpoint of two nets) on the last
   checkpoint. Losses finite, validation accuracy of the better net above
   1/40, the two uninterrupted runs' epoch 1 compared bit for bit (logged),
   the resumed epoch 1's summed losses equal to the uninterrupted run's bit
   for bit (every sum that feeds the loss adds in a fixed order: the
   gather of sagePL's noise rows has a sorted-segment-sum backward), the
   loaded nets' validation accuracies within 1e-3 of the resumed
   run's last epoch's (the same params, evaluated one net at a time instead
   of as a pair), and the SpMM launched for the leaf table (F = 128, once per
   run), the pair eval (F = 512, once per epoch) and the loaded nets' eval
   (F = 256, twice).
5. Gather probe path: ``noise_gnn_tpu_torch.tools.gather_probe.run`` at the
   JAX tool's shapes (x [1,000,000, 256] f32, E = 131,072, P = 16, chunk
   2048, depth 2, 4, 8, 16, 24) with the gather-ring counts reset before
   and read after; then, at the same shapes, the kernel's rings bit-equal
   to the plain version's at every depth, and the plain version (which,
   like the kernel, makes all P x E copies: one ``index_select``) timed;
   the rings of a second call must be bit-equal to the first's. Each depth
   logs the cluster size C the wrapper's rule chose and how many clusters
   of C the card holds at once.
   The bound counts each distinct block read once from device memory (the
   passes' re-reads may hit L2), the ids, and the final rings written.
6. The SpMM at the main paths' shapes on the full graphs (products F = 100,
   256, 512 and, for phase 9b's use_bn pair eval, 200 bf16; arxiv F = 128,
   512 and 256 f32; mean). For each graph
   it logs the largest in-degrees and the segment schedule's size and pack
   time on the card. At each shape the kernel is held against its plain
   version with the tolerance of phase 2 and two of its calls must be
   bit-equal; then it is timed with CUDA events after warm-up in turns with
   one library call for the same function (``torch.sparse`` CSR @ dense, a
   yardstick): kernel, library, kernel, library; then its plain version;
   beside the bound: max(bytes / 3.35 TB/s, adds / 67 TFLOP/s), counting x,
   indices and indptr read once and out written once.
7. TE path at full width: ``main`` on ``configs/config_arxiv.yml``
   (``what: _test3`` on an OGB dataset: ``PipelineTE``; synthetic
   ogbn-arxiv; sagePL 3 x 256, fanouts [10, 5, 5], batch 512: 159,232 flat
   rows a step, 78 row blocks of the rewire), with num_runs 1, max_epochs
   2, ct_tk 0 (epoch 1 rewires) and reinit_retries 0. The train split is
   cut to ``TE_STEPS`` batches (logged) so that the contrast epoch stays
   near a minute, through the split cache that ``load_network`` reads under
   ``load_index`` (kept in the run's own ``data_dir``). Then the same run
   again with the contrast term off in epoch 1 (the same forget rates), as
   the witness for epoch 1's accuracy (whether its epoch 0 matches is
   logged).
   Losses finite, ``loss_cont_1 > 0`` in epoch 1 of the first run only,
   each net's contrast loss lower over the last quarter of the contrast
   epoch's steps than over the first, the better net's validation accuracy
   above 1/40, and the SpMM counts (reset before, read after each run)
   show the leaf table (F = 128, once) and the pair eval (F = 512, two
   layers an epoch) through the kernel. It logs ms per plain and per
   contrast step, the rewire's share of a contrast step (CUDA events
   around each ``topk_rewire_tree``), peak device memory, both runs'
   validation accuracies, and the time of one rewire block's similarity
   matmul at the f32 precision the rewire needs ('highest') and with TF32.
8. H and CT paths at full width through ``main``, on the synthetic
   ogbn-arxiv graph, the SpMM counts reset before and read after each run.
   H: ``configs/config_h.yml`` (``PipelineH``: sageH 2 x 128 twice and a
   sage 2 x 128 pseudo net, fanouts [10, 5], batch 512, the full train
   split of 179 steps; 31,232 flat rows a step, rewired with k2 = 12,492)
   with num_runs 1, max_epochs 2 (epoch 0 plain, epoch 1 with the pseudo
   net) and reinit_retries 0; then 1 epoch with ``ckpt_every: 1`` and
   ``resume: true`` to 2. Losses finite, ``loss_pred`` and ``loss_add`` 0 in
   epoch 0 and > 0 in epoch 1, the better net's validation above 1/40, the
   SpMM launched for the leaf table (F = 128, once a run) and the pair eval
   (F = 256, once an epoch), and the resumed epoch 1's summed losses equal
   to the uninterrupted run's bit for bit. CT: ``configs/config_contrast.yml``
   (``PipelineCT``: sageFC 2 x 128, batch 1024) with warmup 2, ct_tk 1 (so
   the split uses the config's forget rate, 0.45 x 1.1) and max_epochs 4:
   2 warmup epochs, the split, 2 finetune epochs; then killed at max_epochs
   3 with ``ckpt_every: 1`` and resumed to 4. Losses finite, the split's
   clean ids cleaner than the train split, the finetune's best test
   accuracy above 1/40, the SpMM launched for the leaf table (F = 128), the
   pair eval (F = 256: 2 warmup epochs and the split) and the single eval
   (F = 128: the finetune's start, each finetune epoch, the end), and the
   resumed finetune epoch's summed losses equal to the uninterrupted run's
   bit for bit. It logs ms per plain and per pseudo H step, the rewire's
   share of a pseudo step (CUDA events around each ``topk_rewire_tree``), ms
   per warmup and per finetune step, the views' build time (the edge
   augmentation on the host), peak device memory, and the whole script's
   time.

9. Slice 5. (a) The graph runtime on the synthetic arxiv graph: ``coo_to_csr``
   and ``expand_rows`` bit-equal to their numpy plain versions (both timed),
   ``hash_i32`` equal over two calls; with phase 3's products CSR seconds.
   (b) ``use_bn``: first the pair eval at the products widths on a small
   graph, card against CPU (f32 logits within 1e-4; in bf16, whose layer 1
   is the [N, 200] bf16 SpMM, the card's distance from the CPU's f32 logits
   within 4x the CPU's own bf16 distance plus 1e-3); then ``main`` on
   ``configs/config_products.yml`` with ``use_bn: true`` (num_runs 1,
   max_epochs 2, reinit_retries 0; exact leaf off under BN, so the tree
   carries every hop): losses finite, validation above 1/47 for the better
   co-teaching net and the baseline net, and the SpMM launched exactly at
   the BN eval's shapes (pair 200, 512, 512 and single 100, 256, 256 bf16,
   each epoch). (c) GAT: one forward at config_cora.yml's widths on a
   2,000-node subgraph of the synthetic cora, card against CPU within 1e-5
   (f32); then ``main`` on ``configs/config_cora.yml`` with
   ``module_compare: gat``, ``train_type: both``, 2 epochs (sage
   co-teaching beside a GAT baseline on flat subgraphs of 31,232 rows, the
   dense [n, n] attention, and its eval on the full edge list): losses
   finite, peak device memory logged, the SpMM counts of the sage pair eval;
   then the SpMM checked and timed at cora's shapes (F = the features, and
   1024, f32) as in phase 6. (d) Three GAT baseline steps, each in
   ``trace("step")``, inside ``start_profile`` / ``stop_profile``: the Chrome
   trace must exist and name three ``step`` regions (its kernel events on
   the card are counted and logged). Each part's time is logged.

Then it prints one ``{"kernels": [...]}`` line (errors from the full-size
checks, launches from the main paths; the products rows count phase 3's and
9b's runs, the arxiv rows the CTP, TE, H and CT runs', the cora rows 9c's;
each path's also on its own), the ``nvidia-smi`` line and,
last, ``{"ok": true, "device": {...}}``. Details go to
``<out>/report.json``.
"""

from __future__ import annotations

import argparse
import copy
import inspect
import json
import math
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from noise_gnn_tpu_torch import native
from noise_gnn_tpu_torch.augment import rewire
from noise_gnn_tpu_torch.eval.inference import FullGraphInference
from noise_gnn_tpu_torch.graph.containers import CSRGraph, coo_to_csr
from noise_gnn_tpu_torch.graph.datasets import load_network
from noise_gnn_tpu_torch.main import main as port_main
from noise_gnn_tpu_torch.models import nets
from noise_gnn_tpu_torch.models.convert import params_from_jax, params_to_jax
from noise_gnn_tpu_torch.ops import gather_ring, sddmm, spmm
from noise_gnn_tpu_torch.ops.leaf_agg import fused_leaf_table
from noise_gnn_tpu_torch.ops.tree_agg import TreeTopo
from noise_gnn_tpu_torch.tools import gather_probe
from noise_gnn_tpu_torch.train import steps
from noise_gnn_tpu_torch.train.pipelines import PipelineS
from noise_gnn_tpu_torch.utils.config import load_config
from noise_gnn_tpu_torch.utils.profiling import (FP32_OPS_PER_S, HBM_BYTES_PER_S, start_profile,
                                                  stop_profile, time_ms, time_turns, trace)

CONFIG = "configs/config_products.yml"
CTP_CONFIG = "configs/config_ctp.yml"
TE_CONFIG = "configs/config_arxiv.yml"
H_CONFIG = "configs/config_h.yml"
CT_CONFIG = "configs/config_contrast.yml"
CORA_CONFIG = "configs/config_cora.yml"
TE_STEPS = 64  # train batches an epoch in phase 7
SOURCE = "noise_gnn_tpu_torch/csrc/spmm.cu"
REPLACES = "noise_gnn_tpu/ops/pallas_spmm.py:147"
GATHER_SOURCE = "noise_gnn_tpu_torch/csrc/gather_ring.cu"
GATHER_REPLACES = "tools/exp_dma_gather.py:56"
# the main paths' SpMM shapes: (name, F, launches expected per run)
SHAPES = (("leaf table", 100, 1), ("eval pair", 512, 4), ("eval single", 256, 4))
CTP_SHAPES = (("arxiv leaf table", 128), ("arxiv eval pair", 512), ("arxiv load eval", 256))
# the products SpMM shape only use_bn gives (phase 9b): layer 1 of the pair
# eval aggregates [bn1(x) | bn1'(x)], [N, 2 x 100] bf16
BN_SHAPES = (("BN eval pair layer 1", 200),)
# the gather ring's small (depth, chunk) cases: depth 1, depth == chunk, and
# depth < chunk (slots rewritten, the last copy kept); also run by
# tests/test_torch_port_gpu.py
GATHER_CASES = ((1, 1), (1, 8), (2, 8), (3, 16), (16, 16), (7, 64), (24, 2048))
# passes of the gather ring's small cases: C = 1, 2, 1 (3 is odd), 4, 8, 8
# where the rule clusters
GATHER_PASSES = (1, 2, 3, 4, 8, 16)


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


def _params_err(pa: dict, pb: dict, skip=()) -> float:
    """Max abs difference of two JAX-layout params nests, leaves named in
    ``skip`` ("proj.b") left out."""
    err = 0.0
    for ca, cb in zip(pa["convs"], pb["convs"]):
        err = max([err] + [float(np.abs(ca[k] - cb[k]).max()) for k in ca])
    for name in ("noise", "proj", "bnl", "act"):
        if name not in pa:
            continue
        pairs = ([(name, pa[name], pb[name])] if name == "noise" else
                 [(f"{name}.{k}", pa[name][k], pb[name][k]) for k in pa[name]])
        err = max([err] + [float(np.abs(a - b).max()) for n, a, b in pairs if n not in skip])
    return err


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
    param_err = max(_params_err(a, b) for a, b in zip(p_gpu, p_cpu))
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
    rewritten, the last copy kept) and depth 1, at every passes of
    ``GATHER_PASSES``; then at those passes on grids too large to fit on the
    card at once, so that the rule launches every cluster size it can
    choose."""
    rng = np.random.default_rng(5)
    cases = []

    def case(x3, idx, depth, chunk, passes):
        got = gather_ring.gather_ring(x3, idx, depth, chunk, passes)
        want = gather_ring.gather_ring_reference(x3, idx, depth, chunk, passes)
        csize, _ = gather_ring.plan(depth, chunk, int(x3.shape[2]), passes,
                                    idx.shape[0] // chunk, dev)
        cases.append(dict(F=int(x3.shape[2]), depth=depth, chunk=chunk, passes=passes,
                          nchunks=idx.shape[0] // chunk, cluster=csize,
                          equal=bool(torch.equal(got, want))))

    for f in (4, 128, 256):
        x3 = torch.from_numpy(rng.standard_normal((1000, 8, f)).astype(np.float32)).to(dev)
        for depth, chunk in GATHER_CASES:
            idx = torch.from_numpy(rng.integers(0, 1000, chunk * 5).astype(np.int32)).to(dev)
            for passes in GATHER_PASSES:
                case(x3, idx, depth, chunk, passes)
    x3 = torch.from_numpy(rng.standard_normal((1000, 8, 256)).astype(np.float32)).to(dev)
    for passes in GATHER_PASSES:
        nchunks = wave_chunks(passes, torch.cuda.get_device_properties(dev).multi_processor_count)
        idx = torch.from_numpy(rng.integers(0, 1000, 64 * nchunks).astype(np.int32)).to(dev)
        case(x3, idx, 24, 64, passes)
    bad = [c for c in cases if not c["equal"]]
    chosen = sorted({c["cluster"] for c in cases})
    log(f"  gather ring: {len(cases) - len(bad)} of {len(cases)} small cases bit-equal; "
        f"cluster sizes launched {chosen}")
    if bad:
        raise RuntimeError(f"gather ring disagrees with its plain version: {bad}")
    if chosen != sorted(gather_ring.CLUSTER_SIZES):
        raise RuntimeError(f"the small cases launched cluster sizes {chosen}, not "
                           f"{sorted(gather_ring.CLUSTER_SIZES)}")
    return cases


def wave_chunks(passes: int, sms: int) -> int:
    """Chunks for a grid of ``passes`` passes over twice ``sms`` blocks: at
    one block an SM, more than the card holds at once."""
    return -(-2 * sms // passes)


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
    param_err = max(_params_err(a, b) for a, b in zip(p_gpu, p_cpu))
    rep = dict(loss_rel_err=loss_err, param_max_abs_err=param_err, cr_term=m_gpu["loss_cr_1"],
               ok=loss_err <= 1e-5 and param_err <= 1e-4 and m_cpu["loss_cr_1"] > 0)
    log(f"  {nsteps} CTP steps with the consistency term, N={n}, E={ei.shape[1]}: summed-"
        f"loss rel err {loss_err:.2e} (tol 1e-5), params max abs err {param_err:.2e} "
        f"(tol 1e-4), consistency term {m_gpu['loss_cr_1']:.4f}")
    if not rep["ok"]:
        raise RuntimeError(f"the CTP step on the card disagrees with the CPU: {rep}")
    return rep


def exact_rows(rng, n: int, d: int, pool: int) -> np.ndarray:
    """[n, d] f32 rows drawn from ``pool`` distinct rows with four entries of
    +-0.5 and the rest 0: unit norms, and every dot product a multiple of
    0.25 in any order of summation."""
    rows = np.zeros((pool, d), np.float32)
    for r in range(pool):
        rows[r, rng.choice(d, 4, replace=False)] = rng.choice([-0.5, 0.5], 4)
    return rows[rng.integers(0, pool, n)]


def _topo_arrays(t: TreeTopo) -> list[np.ndarray]:
    return [a.cpu().numpy() for a in (t.edge_mask, t.extra_src, t.extra_dst, t.extra_mask)]


def check_small_rewire(dev) -> dict:
    """``hier_topk`` on tied values and ``topk_rewire_tree`` on exact rows,
    card against CPU, bit for bit (values as int32 images, so that -0.0 and
    0.0 differ)."""
    rng = np.random.default_rng(6)
    x = (rng.integers(-4, 5, 1 << 20) * 0.25).astype(np.float32)
    x[rng.random(x.shape[0]) < 0.1] = -0.0
    x[rng.random(x.shape[0]) < 0.05] = -np.inf
    topk_equal = []
    for k in (1, 100, 31_846):
        (cv, ci), (gv, gi) = (sddmm.hier_topk(torch.from_numpy(x).to(d), k)
                              for d in ("cpu", dev))
        topk_equal.append(bool(torch.equal(ci, gi.cpu()) and torch.equal(
            cv.view(torch.int32), gv.cpu().view(torch.int32))))
    b, fanouts = 32, (10, 5, 5)
    topo_cpu = TreeTopo(b, fanouts, torch.from_numpy(rng.random(b * 310) < 0.8))
    h = torch.from_numpy(exact_rows(rng, topo_cpu.num_nodes, 16, 300))
    want = rewire.topk_rewire_tree(h, topo_cpu, 0.1)
    got = rewire.topk_rewire_tree(h.to(dev), TreeTopo(b, fanouts, topo_cpu.edge_mask.to(dev)),
                                  0.1)
    rewire_equal = all(np.array_equal(a, c) for w, g in zip(want, got)
                       for a, c in zip(_topo_arrays(w), _topo_arrays(g)))
    rep = dict(hier_topk_equal=topk_equal, rewire_equal=rewire_equal,
               rows=topo_cpu.num_nodes, extra_edges=int(want[0].extra_src.shape[0]),
               ok=all(topk_equal) and rewire_equal)
    log(f"  hier_topk on 2^20 tied values, k = 1 / 100 / 31846: bit-equal to the CPU "
        f"{topk_equal}; topk_rewire_tree on {rep['rows']} exact rows ({rep['extra_edges']} "
        f"additions a graph): masks and edges bit-equal {rewire_equal}")
    if not rep["ok"]:
        raise RuntimeError(f"the rewiring on the card disagrees with the CPU: {rep}")
    return rep


def forest(n_roots: int, fanouts: tuple[int, ...]) -> tuple[np.ndarray, np.ndarray, int]:
    """Complete in-trees with the given fanouts (edges child -> parent):
    (edge_index, roots, nodes). A tree sampled from roots takes every
    in-neighbour and repeats no node."""
    size = 1 + int(np.cumsum(np.cumprod(fanouts))[-1])
    src, dst = [], []
    for r in range(n_roots):
        level, nxt = [r * size], r * size + 1
        for f in fanouts:
            new = []
            for parent in level:
                kids = list(range(nxt, nxt + f))
                nxt += f
                src += kids
                dst += [parent] * f
                new += kids
            level = new
    return (np.stack([np.asarray(src, np.int32), np.asarray(dst, np.int32)]),
            np.arange(n_roots) * size, n_roots * size)


def check_small_te(dev) -> dict:
    """One TE epoch of 4 steps at the arxiv widths, without and with the
    rewired contrast, on the card against the CPU (see phase 2 of the
    module doc). Returns both comparisons."""
    f, c, hidden, fanouts, bs, nsteps = 128, 40, 256, (10, 5, 5), 32, 4
    ei, roots, n = forest(bs * nsteps, fanouts)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((n, f)).astype(np.float32)
    y = rng.integers(0, c, n)
    yhn = np.where(rng.random(n) < 0.3, rng.integers(0, c, n), y)
    seeds = rng.permutation(roots).reshape(nsteps, bs)
    masks = np.ones((nsteps, bs), bool)
    spec = nets.NetSpec(module="sagePL", in_size=f, hidden_size=hidden, out_size=c,
                        num_layers=3, dropout=0.0, nbr_nodes=n)
    init = [params_to_jax(nets.init_params(torch.Generator().manual_seed(s), spec))
            for s in (1, 2)]
    kw = dict(algo="coteaching", co_lambda=0.1, spl_cont_beta=1.0, spl_rewire_rate=0.1,
              spl_noise_rate_pos=0.1, spl_noise_rate_neg=0.01)

    def adam(params):
        return torch.optim.Adam(params, lr=1e-3)

    def run_on(d, use_contrast):
        data = steps.GraphData(x=torch.from_numpy(x).to(d), y=torch.from_numpy(y).to(d),
                               yhn=torch.from_numpy(yhn).to(d),
                               clean=torch.from_numpy(y == yhn).to(d),
                               csr=CSRGraph.from_coo(ei, n, d))
        states = [steps.state_from_params(params_from_jax(q, d), adam) for q in init]
        rewires = []

        def recording(h, topo, k):
            out = rewire.topk_rewire_tree(h, topo, k)
            rewires.append((h.detach().cpu(), topo, out))
            return out

        steps.topk_rewire_tree = recording
        try:
            m = steps.te_epoch(spec, *states, data, torch.from_numpy(seeds).to(d),
                               torch.from_numpy(masks).to(d), torch.Generator(device=d), 0.2,
                               fanouts, use_contrast=use_contrast, **kw)
        finally:
            steps.topk_rewire_tree = rewire.topk_rewire_tree
        return ({k: float(v) for k, v in m.items()}, [params_to_jax(s.params) for s in states],
                rewires)

    reps = {}
    for use_contrast in (False, True):
        m_gpu, p_gpu, rw_gpu = run_on(dev, use_contrast)
        m_cpu, p_cpu, rw_cpu = run_on(torch.device("cpu"), use_contrast)
        keys = ("loss_1", "loss_2") + (("loss_cont_1", "loss_cont_2") if use_contrast else ())
        loss_err = max(abs(m_gpu[k] - m_cpu[k]) / abs(m_cpu[k]) for k in keys)
        param_err = max(_params_err(a, b) for a, b in zip(p_gpu, p_cpu))
        agree = [all(np.array_equal(u[0], v[0]) and np.array_equal(u[3], v[3])
                     and sorted(zip(u[1].tolist(), u[2].tolist()))
                     == sorted(zip(v[1].tolist(), v[2].tolist()))
                     for u, v in zip(map(_topo_arrays, g[2]), map(_topo_arrays, q[2])))
                 for g, q in zip(rw_gpu, rw_cpu)]
        margins = [pick_margins(h, topo, pos.edge_mask, dev) for (h, topo, (pos, _)), same
                   in zip(rw_cpu, agree) if not same]
        rep = reps["contrast" if use_contrast else "plain"] = dict(
            loss_rel_err=loss_err, param_max_abs_err=param_err, rewires_agree=agree,
            kth_margins=margins, loss_cont_1=m_cpu["loss_cont_1"],
            ok=(loss_err <= 1e-5 and param_err <= 1e-4
                and (m_cpu["loss_cont_1"] > 0) == use_contrast))
        log(f"  {nsteps} TE steps {'with' if use_contrast else 'without'} the rewired "
            f"contrast, {bs} seeds x fanouts {list(fanouts)} ({bs * 311} rows a step): "
            f"summed-loss rel err {loss_err:.2e} (tol 1e-5), params max abs err "
            f"{param_err:.2e} (tol 1e-4)" + (
                f", contrast term {m_cpu['loss_cont_1']:.4f}, rewired topologies agree "
                f"by step {agree}" + (f", k-th pick margins {margins}" if margins else "")
                if use_contrast else ""))
        if not rep["ok"]:
            raise RuntimeError(f"the TE epoch on the card disagrees with the CPU: {rep}")
    return reps


def check_small_h(dev) -> dict:
    """One H epoch of 4 steps with the pseudo net on, at config_h.yml's
    widths, on the card against the CPU (see phase 2 of the module doc)."""
    f, c, hidden, fanouts, bs, nsteps = 128, 40, 128, (10, 5), 32, 4
    ei, roots, n = forest(bs * nsteps, fanouts)
    rng = np.random.default_rng(8)
    x = exact_rows(rng, n, f, 4000)
    y = rng.integers(0, c, n)
    yhn = np.where(rng.random(n) < 0.3, rng.integers(0, c, n), y)
    seeds = rng.permutation(roots).reshape(nsteps, bs)
    masks = np.ones((nsteps, bs), bool)
    kw = dict(in_size=f, hidden_size=hidden, out_size=c, num_layers=2, dropout=0.0)
    spec, pseudo_spec = nets.NetSpec(module="sageH", **kw), nets.NetSpec(module="sage", **kw)
    init = [params_to_jax(nets.init_params(torch.Generator().manual_seed(s), sp))
            for s, sp in ((1, spec), (2, spec), (3, pseudo_spec))]

    def adam(params):
        return torch.optim.Adam(params, lr=1e-3)

    def run_on(d):
        data = steps.GraphData(x=torch.from_numpy(x).to(d), y=torch.from_numpy(y).to(d),
                               yhn=torch.from_numpy(yhn).to(d),
                               clean=torch.from_numpy(y == yhn).to(d),
                               csr=CSRGraph.from_coo(ei, n, d))
        states = [steps.state_from_params(params_from_jax(q, d), adam) for q in init]
        rewires = []

        def recording(h, topo, k, **kw):
            out = rewire.topk_rewire_tree(h, topo, k, **kw)
            rewires.append(_topo_arrays(out[0]))
            return out

        steps.topk_rewire_tree = recording
        try:
            m = steps.h_epoch(spec, pseudo_spec, *states, data, torch.from_numpy(seeds).to(d),
                              torch.from_numpy(masks).to(d), torch.Generator(device=d), 0.2,
                              fanouts, use_pseudo=True, rewire_rate=0.2)
        finally:
            steps.topk_rewire_tree = rewire.topk_rewire_tree
        return ({k: float(v) for k, v in m.items()}, [params_to_jax(s.params) for s in states],
                rewires)

    m_gpu, p_gpu, rw_gpu = run_on(dev)
    m_cpu, p_cpu, rw_cpu = run_on(torch.device("cpu"))
    keys = ("loss_1", "loss_2", "loss_pred", "loss_add")
    loss_err = max(abs(m_gpu[k] - m_cpu[k]) / abs(m_cpu[k]) for k in keys)
    param_err = [_params_err(a, b) for a, b in zip(p_gpu, p_cpu)]
    agree = [len(u) == len(v) and all(np.array_equal(a, b) for a, b in zip(u, v))
             for u, v in zip(rw_gpu, rw_cpu)]
    rep = dict(loss_rel_err=loss_err, param_max_abs_err=param_err, rewires_agree=agree,
               loss_pred=m_cpu["loss_pred"], loss_add=m_cpu["loss_add"],
               ok=(loss_err <= 1e-5 and max(param_err) <= 1e-4 and len(agree) == nsteps
                   and all(agree) and m_cpu["loss_add"] > 0))
    log(f"  {nsteps} H steps with the pseudo net, {bs} seeds x fanouts {list(fanouts)} "
        f"({bs * 61} rows a step, exact-arithmetic features): summed-loss rel err "
        f"{loss_err:.2e} (tol 1e-5), params max abs err (net 1, 2, pseudo) "
        f"{['%.2e' % e for e in param_err]} (tol 1e-4), rewired positive graphs equal by "
        f"step {agree}, loss_pred {m_cpu['loss_pred']:.4f}, loss_add {m_cpu['loss_add']:.4f}")
    if not rep["ok"]:
        raise RuntimeError(f"the H epoch on the card disagrees with the CPU: {rep}")
    return rep


def check_small_ct(dev) -> dict:
    """One contrastive finetune epoch of 4 steps at config_contrast.yml's
    widths on four given views, on the card against the CPU (see phase 2 of
    the module doc)."""
    n, f, c, hidden, fanouts, bs, nsteps = 5_000, 128, 40, 128, (10, 5), 512, 4
    rng = np.random.default_rng(9)

    def low_degree():
        deg = rng.integers(0, min(fanouts) + 1, n)
        return np.stack([rng.integers(0, n, deg.sum()), np.repeat(np.arange(n), deg)])

    graphs = [low_degree() for _ in range(3)]
    x = rng.standard_normal((n, f)).astype(np.float32)
    feats = {"orig": x, "edge_s": x, "feat_s": x[:, rng.permutation(f)],
             "large": x[rng.permutation(n)]}
    gi = {"orig": 0, "edge_s": 1, "feat_s": 0, "large": 2}
    y = rng.integers(0, c, n)
    yhn = np.where(rng.random(n) < 0.45, (y + 1) % c, y)
    perm = rng.permutation(n)
    cs, ns = (perm[i * nsteps * bs:(i + 1) * nsteps * bs].reshape(nsteps, bs) for i in (0, 1))
    cm, nm = np.ones((nsteps, bs), bool), np.ones((nsteps, bs), bool)
    cm[-1, -37:] = nm[-1, -53:] = False  # padded last batches
    spec = nets.NetSpec(module="sageFC", in_size=f, hidden_size=hidden, out_size=c,
                        num_layers=2, dropout=0.0)
    init = params_to_jax(nets.init_params(torch.Generator().manual_seed(1), spec))

    def run_on(d):
        data = steps.GraphData(x=torch.from_numpy(x).to(d), y=torch.from_numpy(y).to(d),
                               yhn=torch.from_numpy(yhn).to(d),
                               clean=torch.from_numpy(y == yhn).to(d),
                               csr=CSRGraph.from_coo(graphs[0].astype(np.int32), n, d))
        views = {v: (torch.from_numpy(feats[v]).to(d),
                     CSRGraph.from_coo(graphs[gi[v]].astype(np.int32), n, d)) for v in feats}
        s = steps.state_from_params(params_from_jax(init, d),
                                    lambda q: torch.optim.Adam(q, lr=5e-4))
        t = [torch.from_numpy(a).to(d) for a in (cs, cm, ns, nm)]
        m = steps.contrast_epoch(spec, s, data, views, *t, torch.Generator(device=d), fanouts,
                                 lam=1.0)
        return {k: float(v) for k, v in m.items()}, params_to_jax(s.params)

    m_gpu, p_gpu = run_on(dev)
    m_cpu, p_cpu = run_on(torch.device("cpu"))
    loss_err = max(abs(m_gpu[k] - m_cpu[k]) / abs(m_cpu[k]) for k in ("loss_semi", "loss_cont"))
    # the projection's bias feeds a batch norm: its gradient is 0 in exact
    # arithmetic and rounding noise on each device, which Adam turns into
    # steps of up to lr either way; it is held to that bound instead
    param_err = _params_err(p_gpu, p_cpu, skip=("proj.b",))
    bias_moved = max(float(np.abs(p["proj"]["b"] - init["proj"]["b"]).max())
                     for p in (p_gpu, p_cpu))
    rep = dict(loss_rel_err=loss_err, param_max_abs_err=param_err, proj_b_moved=bias_moved,
               loss_semi=m_cpu["loss_semi"], loss_cont=m_cpu["loss_cont"],
               ok=(loss_err <= 1e-5 and param_err <= 1e-4 and bias_moved <= nsteps * 5e-4 * 1.001))
    log(f"  {nsteps} contrastive finetune steps on four views, N={n}, batch {bs}, five tree "
        f"forwards a step: summed-loss rel err {loss_err:.2e} (tol 1e-5), params max abs err "
        f"{param_err:.2e} (tol 1e-4; the projection's bias, ahead of a batch norm, moved "
        f"{bias_moved:.2e} <= {nsteps} x lr), loss_semi {m_cpu['loss_semi']:.4f}, loss_cont "
        f"{m_cpu['loss_cont']:.4f}")
    if not rep["ok"]:
        raise RuntimeError(f"the contrastive finetune on the card disagrees with the CPU: {rep}")
    return rep


def pick_margins(h: torch.Tensor, topo: TreeTopo, pos_keep: torch.Tensor, dev) -> dict:
    """For a rewire whose picks differ between the devices: in each sweep,
    the distance between the k2-th and the (k2+1)-th candidate similarity
    (from the CPU's hidden rows, the similarity matrix whole on the card)."""
    hn = sddmm.l2_normalize(h.to(dev).float())
    n, b = topo.num_nodes, topo.batch_size
    k2 = max(2 * int(n * 0.1), 1)
    child = torch.arange(b, n, device=dev)
    par = topo.parent_of(child)
    out = {}
    for name, sign, keep in (("pos", 1.0, pos_keep), ("neg", -1.0, topo.edge_mask)):
        s = sign * (hn @ hn.T)
        s.fill_diagonal_(float("-inf"))
        keep = keep.to(dev)
        s[child[keep], par[keep]] = float("-inf")
        v = torch.topk(s.reshape(-1), k2 + 1).values
        out[name] = float(v[k2 - 1] - v[k2])
        del s
    return out

# ------------------------------------------------------------ main path


def _drive(cfg: dict, run=port_main) -> dict:
    """Run ``run(cfg)`` (``main``) with the SpMM counts reset just before
    and read just after; returns the result, wall time, counts, peak memory
    and the run's metrics records."""
    spmm.launch_counts.clear()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = run(cfg)
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
    (setup,) = _events(r, "setup")
    log(f"  setup: load_network {setup['load_s']:.2f} s, CSR build (native counting sort) + "
        f"placement {setup['csr_s']:.2f} s, noise {setup['noise_s']:.2f} s")
    return dict(config=CONFIG, wall_s=r["wall_s"], peak_bytes=r["peak_bytes"],
                launches=counts, ct_epochs=ct, baseline_epochs=base, setup=setup,
                nalgo=list(res["nalgo"]), baseline=list(res["baseline"]))


def run_ctp_path(out: Path) -> dict:
    """The CTP path at full width: uninterrupted, killed after epoch 0,
    resumed, and loaded for evaluation (see phase 4 of the module doc)."""
    base = load_config(CTP_CONFIG)
    base.update(num_runs=1, max_epochs=2, reinit_retries=0)
    shutil.rmtree(out / "ctp", ignore_errors=True)  # metrics files append
    ckpt = str(out / "ctp" / "ckpt")
    plan = (("full", {}), ("full again", {}),
            ("killed", dict(max_epochs=1, ckpt_every=1, ckpt_path=ckpt)),
            ("resumed", dict(resume=True, ckpt_every=1, ckpt_path=ckpt)),
            ("loaded", dict(algo_type="coteaching", do_train=False, ckpt_path=ckpt)))
    want_counts = {"full": {128: 1, 512: 2}, "full again": {128: 1, 512: 2},
                   "killed": {128: 1, 512: 1},
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
    again = runs["full again"]["epochs"]
    keys = ("loss_1", "loss_2", "loss_cr_1", "loss_cr_2", "correct_1", "correct_2")
    repeat_equal = {k: again[1][k] == full[1][k] for k in keys}
    resume_err = max(abs(resumed[0][k] - full[1][k]) / abs(full[1][k])
                     for k in ("loss_1", "loss_2"))
    acc1, acc2 = loaded["result"]["loaded"]
    load_err = max(abs(acc1["valid"] - resumed[0]["val_acc_1"]),
                   abs(acc2["valid"] - resumed[0]["val_acc_2"]))
    log(f"  two uninterrupted runs' epoch 1 bit-equal by metric: {repeat_equal}")
    log(f"  resumed epoch 1 against the uninterrupted run: summed losses rel diff "
        f"{resume_err:.3e} (required 0: bit-equal); loaded nets' validation "
        f"{acc1['valid']:.4f}/{acc2['valid']:.4f} against the resumed run's "
        f"{resumed[0]['val_acc_1']:.4f}/{resumed[0]['val_acc_2']:.4f}")
    if resume_err != 0.0:
        raise RuntimeError(f"resumed epoch 1 is {resume_err:.3e} from the uninterrupted run")
    if not load_err <= 1e-3:
        raise RuntimeError(f"load-and-eval accuracies differ from the run's by {load_err}")
    for r in runs.values():
        del r["result"], r["records"]
    return dict(config=CTP_CONFIG, runs=runs, repeat_equal=repeat_equal,
                resume_rel_diff=resume_err, load_acc_diff=load_err, best_val=best_val,
                loaded=dict(acc1=acc1, acc2=acc2))


def _cut_split(cfg: dict, steps_kept: int) -> dict:
    """Write the config's split, its train part cut to ``steps_kept``
    batches, into the split cache that ``load_network`` reads back under
    ``load_index`` (the JAX package's own hook); returns the sizes."""
    load_network(dict(cfg, load_index=True))  # computes the split and caches it
    cache = (Path(cfg["data_dir"]) / "index" / f"{cfg['dataset_name']}_seed"
             f"{int(cfg.get('seed', 0))}_scale{int(cfg.get('synthetic_scale', 1))}.npz")
    with np.load(cache) as z:
        idx = {k: z[k] for k in z.files}
    full = int(idx["train_idx"].shape[0])
    kept = min(full, steps_kept * int(cfg["batch_size"]))
    idx["train_idx"] = idx["train_idx"][:kept]
    np.savez(cache, **idx)
    return dict(full=full, kept=kept)


def run_te_path(out: Path, dev) -> dict:
    """The TE path at full width (phase 7 of the module doc): ``main`` on
    the arxiv config, then the same run without the contrast epoch."""
    cfg = load_config(TE_CONFIG)
    shutil.rmtree(out / "te", ignore_errors=True)
    # the cut split cache lives in the run's own data_dir (the graph is the
    # synthetic one either way)
    cfg.update(num_runs=1, max_epochs=2, ct_tk=0, reinit_retries=0, load_index=True,
               out_dir=str(out / "te"), data_dir=str(out / "te" / "data"))
    bs = int(cfg["batch_size"])
    cut = _cut_split(cfg, TE_STEPS)
    nsteps = -(-cut["kept"] // bs)
    log(f"  train split cut from {cut['full']} to {cut['kept']} seeds ({nsteps} steps an "
        f"epoch) through load_index, to keep the contrast epoch near a minute")
    events, step_losses = [], []

    def timed_rewire(h, topo, k):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        res = rewire.topk_rewire_tree(h, topo, k)
        end.record()
        events.append((start, end))
        return res

    def logged_step(*args, **kw):
        loss, aux = te_step_loss(*args, **kw)
        ct, _, _, lc1, lc2 = aux
        step_losses.append(torch.stack([ct.loss_1, ct.loss_2, lc1, lc2]).detach())
        return loss, aux

    def drive(c):
        step_losses.clear()
        r = _drive(c)  # main(c): config_arxiv.yml's `what: _test3` on OGB -> PipelineTE
        r["step_losses"] = torch.stack(step_losses).cpu().numpy()
        return r

    te_step_loss, te_epoch = steps.te_step_loss, steps.te_epoch
    steps.topk_rewire_tree, steps.te_step_loss = timed_rewire, logged_step
    try:
        r = drive(cfg)
        rewire_ms = [a.elapsed_time(b) for a, b in events]
        events.clear()
        # the witness: the same run (the same forget rates) with the
        # contrast term off in epoch 1
        steps.te_epoch = lambda *a, **kw: te_epoch(*a, **dict(kw, use_contrast=False))
        w = drive(dict(cfg, out_dir=str(out / "te" / "witness")))
    finally:
        steps.topk_rewire_tree = rewire.topk_rewire_tree
        steps.te_step_loss, steps.te_epoch = te_step_loss, te_epoch
    if events:
        raise RuntimeError(f"the witness run rewired {len(events)} times")
    epochs, w_epochs = _events(r, "epoch_te"), _events(w, "epoch_te")
    for tag, eps in (("", epochs), ("witness, no contrast: ", w_epochs)):
        for e in eps:
            log(f"  {tag}TE epoch {e['epoch']}: train {e['epoch_train_s']:.3f} s "
                f"({e['epoch_train_s'] / nsteps * 1e3:.1f} ms a step), eval "
                f"{e['epoch_eval_s']:.3f} s, loss {e['loss_1']:.4f}/{e['loss_2']:.4f}, "
                f"contrast {e['loss_cont_1']:.4f}/{e['loss_cont_2']:.4f}, pure "
                f"{e['pure_ratio_1']:.3f}/{e['pure_ratio_2']:.3f}, val "
                f"{e['val_acc_1']:.4f}/{e['val_acc_2']:.4f}")
    if [e["epoch"] for e in epochs] != [0, 1] or [e["epoch"] for e in w_epochs] != [0, 1]:
        raise RuntimeError("main did not run the TE epochs [0, 1] for the arxiv config: "
                           f"{[e['epoch'] for e in epochs]}, {[e['epoch'] for e in w_epochs]}")
    plain, cont = epochs
    keys = ("loss_1", "loss_2", "val_acc_1", "val_acc_2")
    epoch0_equal = all(plain[k] == w_epochs[0][k] for k in keys)
    sl = r["step_losses"][nsteps:]  # the contrast epoch's steps
    q = max(1, nsteps // 4)
    quarters = dict(first=sl[:q].mean(axis=0).tolist(), last=sl[-q:].mean(axis=0).tolist())
    log(f"  epoch 0 equal to the witness's (losses, val): {epoch0_equal}; contrast epoch, "
        f"mean of the first / last {q} steps' [ce_1, ce_2, cont_1, cont_2]: "
        f"{np.round(quarters['first'], 4).tolist()} / {np.round(quarters['last'], 4).tolist()}")
    share = sum(rewire_ms) / (cont["epoch_train_s"] * 1e3)
    # one rewire block's similarity matmul at the rewire's shape, two precisions
    n = bs * (1 + int(np.cumsum(np.cumprod(cfg["nbr_neighbors"]))[-1]))  # rows a step
    hn = torch.randn((n, int(cfg["hidden_size"])), device=dev)
    mm = {}
    for prec in ("highest", "high"):
        torch.set_float32_matmul_precision(prec)
        mm[prec] = time_ms(lambda: hn[:2048] @ hn.T, reps=20)
    torch.set_float32_matmul_precision("highest")
    del hn
    rep = dict(config=TE_CONFIG, wall_s=r["wall_s"], peak_bytes=r["peak_bytes"],
               launches=r["launches"], train_cut=cut, steps=nsteps, epochs=epochs,
               witness_epochs=w_epochs, witness_launches=w["launches"],
               epoch0_equal=epoch0_equal, contrast_quarters=quarters,
               plain_step_ms=plain["epoch_train_s"] / nsteps * 1e3,
               contrast_step_ms=cont["epoch_train_s"] / nsteps * 1e3,
               rewire_calls=len(rewire_ms), rewire_ms_mean=float(np.mean(rewire_ms)),
               rewire_share=share, block_matmul_ms=mm, result=list(r["result"]))
    log(f"  {nsteps} steps an epoch: plain {rep['plain_step_ms']:.1f} ms a step, contrast "
        f"{rep['contrast_step_ms']:.1f} ms a step; {len(rewire_ms)} rewires of "
        f"{rep['rewire_ms_mean']:.1f} ms each (CUDA events): {100 * share:.1f}% of the "
        f"contrast epoch's train time; one rewire block's similarity matmul "
        f"[2048, 256] x [256, {n}] f32 {mm['highest']:.3f} ms ('highest'), "
        f"{mm['high']:.3f} ms with TF32")
    log(f"  main(config) wall {r['wall_s']:.1f} s, peak device memory "
        f"{r['peak_bytes'] / 2**30:.2f} GiB, SpMM launches by F {r['launches']}")
    losses = [e[k] for e in epochs + w_epochs
              for k in ("loss_1", "loss_2", "loss_cont_1", "loss_cont_2")]
    if not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"non-finite TE loss: {losses}")
    if not (plain["loss_cont_1"] == 0.0 and cont["loss_cont_1"] > 0.0
            and w_epochs[1]["loss_cont_1"] == 0.0):
        raise RuntimeError("the contrast term must be on in epoch 1 of the run only")
    best_val = max(cont["val_acc_1"], cont["val_acc_2"])
    if not best_val > 1 / 40:
        raise RuntimeError(f"TE validation accuracy {best_val} not above 1/40")
    if not all(b < a for a, b in zip(quarters["first"][2:], quarters["last"][2:])):
        raise RuntimeError(f"the contrast loss did not fall over the contrast epoch: {quarters}")
    want = {128: 1, 512: 4}  # the leaf table; the pair eval's layers 2 and 3, two epochs
    if r["launches"] != want or w["launches"] != want:
        raise RuntimeError(f"TE runs launched the SpMM {r['launches']} and {w['launches']} "
                           f"times by F, expected {want}")
    if len(rewire_ms) != nsteps:
        raise RuntimeError(f"{len(rewire_ms)} rewires in the contrast epoch of {nsteps} steps")
    return rep


def _timed_rewires(events: list):
    """A stand-in for ``steps.topk_rewire_tree`` that records CUDA events
    around each call."""
    def timed(*args, **kw):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        res = rewire.topk_rewire_tree(*args, **kw)
        end.record()
        events.append((start, end))
        return res
    return timed


def _counting_steps(fn, seen: list):
    """A stand-in for an epoch function of ``steps`` that records each
    call's number of steps (its ``seeds`` rows)."""
    sig = inspect.signature(fn)

    def counted(*args, **kw):
        seen.append(int(sig.bind(*args, **kw).arguments["seeds"].shape[0]))
        return fn(*args, **kw)
    return counted


def _resume_check(full: dict, resumed: dict, keys) -> float:
    """The resumed epoch's summed losses against the uninterrupted run's:
    the largest relative difference (0.0: bit-equal)."""
    return max(abs(resumed[k] - full[k]) / max(abs(full[k]), 1e-30) for k in keys)


def run_h_path(out: Path) -> dict:
    """PipelineH at full width through ``main`` (phase 8 of the module doc):
    2 epochs uninterrupted, then killed after epoch 0 and resumed."""
    base = load_config(H_CONFIG)
    base.update(num_runs=1, max_epochs=2, reinit_retries=0)
    shutil.rmtree(out / "h", ignore_errors=True)
    ckpt = str(out / "h" / "ckpt")
    plan = (("full", {}), ("killed", dict(max_epochs=1, ckpt_every=1, ckpt_path=ckpt)),
            ("resumed", dict(resume=True, ckpt_every=1, ckpt_path=ckpt)))
    want_counts = {"full": {128: 1, 256: 2}, "killed": {128: 1, 256: 1},
                   "resumed": {128: 1, 256: 1}}
    runs, events, seen = {}, [], []
    h_epoch = steps.h_epoch
    steps.topk_rewire_tree = _timed_rewires(events)
    steps.h_epoch = _counting_steps(h_epoch, seen)
    try:
        for name, over in plan:
            events.clear()
            seen.clear()
            cfg = dict(copy.deepcopy(base), out_dir=str(out / "h" / name), **over)
            r = runs[name] = _drive(cfg)  # main: algo_type hpseudo -> PipelineH
            r["epochs"] = _events(r, "epoch_h")
            r["rewire_ms"] = [a.elapsed_time(b) for a, b in events]
            r["steps"] = list(seen)
            for e in r["epochs"]:
                log(f"  {name} H epoch {e['epoch']}: train {e['epoch_train_s']:.3f} s, eval "
                    f"{e['epoch_eval_s']:.3f} s, loss {e['loss_1']:.6f}/{e['loss_2']:.6f}, "
                    f"pred {e['loss_pred']:.4f}, add {e['loss_add']:.4f}, pure "
                    f"{e['pure_ratio_1']:.3f}/{e['pure_ratio_2']:.3f}, val "
                    f"{e['val_acc_1']:.4f}/{e['val_acc_2']:.4f}")
            log(f"  {name}: main(config) wall {r['wall_s']:.1f} s, peak device memory "
                f"{r['peak_bytes'] / 2**30:.2f} GiB, SpMM launches by F {r['launches']}")
            if r["launches"] != want_counts[name]:
                raise RuntimeError(f"H run '{name}' launched the SpMM {r['launches']} times "
                                   f"by F, expected {want_counts[name]}")
    finally:
        steps.topk_rewire_tree, steps.h_epoch = rewire.topk_rewire_tree, h_epoch
    full, resumed = runs["full"]["epochs"], runs["resumed"]["epochs"]
    if [e["epoch"] for e in full] != [0, 1] or [e["epoch"] for e in resumed] != [1]:
        raise RuntimeError("expected H epochs [0, 1] uninterrupted and [1] resumed")
    losses = [e[k] for e in full + resumed for k in ("loss_1", "loss_2", "loss_pred", "loss_add")]
    if not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"non-finite H loss: {losses}")
    plain, pseudo = full
    if not (plain["loss_pred"] == plain["loss_add"] == 0.0
            and pseudo["loss_pred"] > 0.0 and pseudo["loss_add"] > 0.0):
        raise RuntimeError("the pseudo net's terms must be 0 in epoch 0 and > 0 in epoch 1")
    best_val = max(pseudo["val_acc_1"], pseudo["val_acc_2"])
    if not best_val > 1 / 40:
        raise RuntimeError(f"H validation accuracy {best_val} not above 1/40")
    nsteps = runs["full"]["steps"][1]
    rewire_ms = runs["full"]["rewire_ms"]
    if len(rewire_ms) != nsteps:
        raise RuntimeError(f"{len(rewire_ms)} rewires in the pseudo epoch of {nsteps} steps")
    resume_err = _resume_check(pseudo, resumed[0], ("loss_1", "loss_2", "loss_pred", "loss_add"))
    rep = dict(config=H_CONFIG, steps=nsteps, epochs=full, resumed_epoch=resumed[0],
               resume_rel_diff=resume_err, best_val=best_val,
               plain_step_ms=plain["epoch_train_s"] / nsteps * 1e3,
               pseudo_step_ms=pseudo["epoch_train_s"] / nsteps * 1e3,
               rewire_ms_mean=float(np.mean(rewire_ms)),
               rewire_share=sum(rewire_ms) / (pseudo["epoch_train_s"] * 1e3),
               runs={k: dict(wall_s=r["wall_s"], peak_bytes=r["peak_bytes"],
                             launches=r["launches"]) for k, r in runs.items()},
               launches=runs["full"]["launches"], peak_bytes=runs["full"]["peak_bytes"])
    log(f"  {nsteps} steps an epoch: plain {rep['plain_step_ms']:.1f} ms a step, pseudo "
        f"{rep['pseudo_step_ms']:.1f} ms a step; {len(rewire_ms)} rewires of the raw features "
        f"of {rep['rewire_ms_mean']:.2f} ms each (CUDA events): {100 * rep['rewire_share']:.1f}% "
        f"of the pseudo epoch's train time")
    log(f"  resumed epoch 1 against the uninterrupted run: summed losses rel diff "
        f"{resume_err:.3e} (required 0: bit-equal)")
    if resume_err != 0.0:
        raise RuntimeError(f"resumed H epoch 1 is {resume_err:.3e} from the uninterrupted run")
    return rep


def run_ct_path(out: Path) -> dict:
    """PipelineCT at full width through ``main`` (phase 8 of the module
    doc): warmup 2, split, finetune 2, then killed after the first finetune
    epoch and resumed."""
    base = load_config(CT_CONFIG)
    base.update(num_runs=1, warmup=2, ct_tk=1, max_epochs=4, reinit_retries=0)
    shutil.rmtree(out / "ct", ignore_errors=True)
    ckpt = str(out / "ct" / "ckpt")
    plan = (("full", {}), ("killed", dict(max_epochs=3, ckpt_every=1, ckpt_path=ckpt)),
            ("resumed", dict(resume=True, ckpt_every=1, ckpt_path=ckpt)))
    # F = 128: the leaf table, then the single eval (layer 2) at the
    # finetune's start, each finetune epoch and the end; F = 256: the pair
    # eval of each warmup epoch and the split
    want_counts = {"full": {128: 5, 256: 3}, "killed": {128: 4, 256: 3},
                   "resumed": {128: 3}}
    runs, seen = {}, []
    ct_epoch = steps.ct_epoch
    steps.ct_epoch = _counting_steps(ct_epoch, seen)  # the warmup's epochs
    try:
        for name, over in plan:
            seen.clear()
            cfg = dict(copy.deepcopy(base), out_dir=str(out / "ct" / name), **over)
            runs[name] = _drive(cfg)  # main: algo_type contrastive -> PipelineCT
            runs[name]["warmup_steps"] = list(seen)
    finally:
        steps.ct_epoch = ct_epoch
    for name, r in runs.items():
        for ev in ("warmup", "finetune", "split", "views"):
            r[ev] = _events(r, ev)
        for e in r["warmup"]:
            log(f"  {name} warmup epoch {e['epoch']}: train {e['epoch_train_s']:.3f} s, loss "
                f"{e['loss_1']:.4f}/{e['loss_2']:.4f}, val {e['val_acc_1']:.4f}/"
                f"{e['val_acc_2']:.4f}")
        for e in r["split"]:
            log(f"  {name} split: {e['n_clean']} clean ids (clean ratio {e['clean_ratio']:.4f}, "
                f"the train split's {e['train_clean_frac']:.4f}), {e['n_noisy']} noisy")
        for e in r["finetune"]:
            log(f"  {name} finetune epoch {e['epoch']}: train {e['epoch_train_s']:.3f} s over "
                f"{e['steps']} steps, loss semi {e['loss_semi']:.6f} cont {e['loss_cont']:.6f}, "
                f"val {e['val_acc']:.4f}, test {e['test_acc']:.4f}")
        log(f"  {name}: main(config) wall {r['wall_s']:.1f} s (views {r['views'][0]['build_s']:.1f} "
            f"s, edge augmentation on the host {r['views'][0]['edges_s']:.1f} s), peak device "
            f"memory {r['peak_bytes'] / 2**30:.2f} GiB, SpMM launches by F {r['launches']}")
        if r["launches"] != want_counts[name]:
            raise RuntimeError(f"CT run '{name}' launched the SpMM {r['launches']} times by "
                               f"F, expected {want_counts[name]}")
    full, resumed = runs["full"], runs["resumed"]
    if ([e["epoch"] for e in full["warmup"]] != [0, 1]
            or [e["epoch"] for e in full["finetune"]] != [2, 3]
            or [e["epoch"] for e in resumed["finetune"]] != [3] or resumed["warmup"]):
        raise RuntimeError("expected warmup [0, 1] and finetune [2, 3] uninterrupted, "
                           "finetune [3] alone resumed")
    losses = ([e[k] for e in full["warmup"] for k in ("loss_1", "loss_2")]
              + [e[k] for e in full["finetune"] + resumed["finetune"]
                 for k in ("loss_semi", "loss_cont")])
    if not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"non-finite CT loss: {losses}")
    (split,) = full["split"]
    if not split["clean_ratio"] > split["train_clean_frac"]:
        raise RuntimeError(f"the split's clean ids are no cleaner than the train split: {split}")
    best_test = float(full["result"]["contrastive"][0])
    if not best_test > 1 / 40:
        raise RuntimeError(f"CT finetune best test accuracy {best_test} not above 1/40")
    resume_err = _resume_check(full["finetune"][1], resumed["finetune"][0],
                               ("loss_semi", "loss_cont"))
    warm, ft = full["warmup"][-1], full["finetune"][-1]
    warm_steps = full["warmup_steps"][-1]
    rep = dict(config=CT_CONFIG, warmup_epochs=full["warmup"], finetune_epochs=full["finetune"],
               split=split, resumed_epoch=resumed["finetune"][0], resume_rel_diff=resume_err,
               best_test=best_test, warmup_step_ms=warm["epoch_train_s"] / warm_steps * 1e3,
               finetune_step_ms=ft["epoch_train_s"] / ft["steps"] * 1e3,
               views_build_s=full["views"][0]["build_s"],
               views_edges_s=full["views"][0]["edges_s"],
               runs={k: dict(wall_s=r["wall_s"], peak_bytes=r["peak_bytes"],
                             launches=r["launches"]) for k, r in runs.items()},
               launches=full["launches"], peak_bytes=full["peak_bytes"])
    log(f"  warmup {rep['warmup_step_ms']:.1f} ms a step ({warm_steps} steps), finetune "
        f"{rep['finetune_step_ms']:.1f} ms a step ({ft['steps']} steps); best test "
        f"{best_test:.4f}")
    log(f"  resumed finetune epoch 3 against the uninterrupted run: summed losses rel diff "
        f"{resume_err:.3e} (required 0: bit-equal)")
    if resume_err != 0.0:
        raise RuntimeError(f"resumed CT finetune epoch is {resume_err:.3e} from the "
                           "uninterrupted run")
    return rep


def run_gather_path(dev) -> dict:
    """The probe tool's path with the gather-ring counts reset before and
    read after, then the kernel's rings held bit-equal to the plain
    version's and to a second call's at every depth at the same shapes, and
    the plain version timed."""
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
        again = gather_ring.gather_ring(*args)
        want = gather_ring.gather_ring_reference(*args)
        row.update(equal=bool(torch.equal(got, want)), repeat_equal=bool(torch.equal(got, again)),
                   max_abs_err=float((got - want).abs().max()),
                   plain_ms=time_ms(lambda: gather_ring.gather_ring_reference(*args), reps=5),
                   launches=counts.get(d, 0))
        log(f"  depth {d}: C = {row['cluster']} ({row['active_clusters']} clusters at once), "
            f"rings bit-equal to the plain version: {row['equal']}, to a second call: "
            f"{row['repeat_equal']}, plain {row['plain_ms']:.3f} ms, launches on the probe "
            f"path {row['launches']}")
        del got, again, want
        if not (row["equal"] and row["repeat_equal"]) or row["launches"] == 0:
            raise RuntimeError(f"gather ring at depth {d}: {row}")
    del x3, idx
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------- phase 9


def run_native(build_s: float, main_rep: dict) -> dict:
    """9a: the port's graph runtime on the synthetic arxiv graph against
    its numpy plain versions, and the products CSR build of phase 3."""
    g = load_network(load_config(CTP_CONFIG))
    src, dst, n = g.edge_index[0], g.edge_index[1], g.num_nodes
    t0 = time.perf_counter()
    indptr, indices = native.coo_to_csr(src, dst, n)
    t1 = time.perf_counter()
    ref_indptr, ref_indices = native.coo_to_csr_reference(src, dst, n)
    t2 = time.perf_counter()
    rows = native.expand_rows(indptr, n)
    t3 = time.perf_counter()
    ref_rows = native.expand_rows_reference(indptr, n)
    t4 = time.perf_counter()
    hashes = [native.hash_i32(indices), native.hash_i32(indices)]
    rep = dict(N=n, E=int(src.shape[0]), build_s=build_s,
               csr_equal=bool(np.array_equal(indptr, ref_indptr)
                              and np.array_equal(indices, ref_indices)),
               rows_equal=bool(np.array_equal(rows, ref_rows)), hash_repeat_equal=hashes[0] == hashes[1],
               coo_to_csr_s=t1 - t0, coo_to_csr_plain_s=t2 - t1, expand_rows_s=t3 - t2,
               expand_rows_plain_s=t4 - t3, products_csr_s=main_rep["setup"]["csr_s"])
    log(f"  built {native.build().name} from noise_gnn_tpu_torch/csrc/graph_runtime.cpp in "
        f"{build_s:.1f} s (g++, in phase 1)")
    log(f"  {g.name}: N={n} E={rep['E']}: coo_to_csr {rep['coo_to_csr_s']:.3f} s (numpy stable "
        f"sort {rep['coo_to_csr_plain_s']:.3f} s), bit-equal {rep['csr_equal']}; expand_rows "
        f"{rep['expand_rows_s']:.4f} s (numpy {rep['expand_rows_plain_s']:.4f} s), bit-equal "
        f"{rep['rows_equal']}; hash_i32 repeat equal {rep['hash_repeat_equal']}")
    log(f"  products CSR build + placement in phase 3's setup: {rep['products_csr_s']:.2f} s")
    if not (rep["csr_equal"] and rep["rows_equal"] and rep["hash_repeat_equal"]):
        raise RuntimeError(f"the native runtime disagrees with its plain versions: {rep}")
    return rep


def _bn_params(spec, seed: int) -> dict:
    """Port-initialized params as numpy, the batch norms' scales and biases
    moved off 1 and 0 so that each counts."""
    p = params_to_jax(nets.init_params(torch.Generator().manual_seed(seed), spec))
    rng = np.random.default_rng(seed)
    for name in ("bn1", "bn2"):
        p[name] = {k: (v + 0.2 * rng.standard_normal(v.shape)).astype(np.float32)
                   for k, v in p[name].items()}
    return p


def check_small_bn(dev) -> dict:
    """9b, before the run: the use_bn pair eval at the products widths (3 x
    256 on 100 features, 47 classes) on a small graph, on the card against
    the CPU. f32: logits within phase 2's 1e-4. bf16 (the path's dtype, its
    layer 1 the [N, 200] bf16 SpMM): the card's distance from the CPU's f32
    logits within 4x the CPU's own bf16 distance plus 1e-3."""
    n, f, c, hidden = 5_000, 100, 47, 256
    rng = np.random.default_rng(10)
    deg = rng.integers(0, 16, n)
    ei = np.stack([rng.integers(0, n, deg.sum()), np.repeat(np.arange(n), deg)]).astype(np.int32)
    x = rng.standard_normal((n, f)).astype(np.float32)
    kw = dict(module="sage", in_size=f, hidden_size=hidden, out_size=c, num_layers=3,
              dropout=0.0, use_bn=True)
    init = [_bn_params(nets.NetSpec(**kw), s) for s in (1, 2)]

    def pair(d, dtype):
        spec = nets.NetSpec(**kw, compute_dtype=dtype)
        infer = FullGraphInference(spec, CSRGraph.from_coo(ei, n, d))
        return [o.cpu() for o in infer.pair(*(params_from_jax(q, d) for q in init),
                                             torch.from_numpy(x).to(d))]

    ref = pair("cpu", "float32")
    f32_err = max((a - b).abs().max().item() for a, b in zip(pair(dev, "float32"), ref))
    cpu_bf16 = max((a - b).abs().max().item() for a, b in zip(pair("cpu", "bfloat16"), ref))
    spmm.launch_counts.clear()
    gpu_bf16 = max((a - b).abs().max().item() for a, b in zip(pair(dev, "bfloat16"), ref))
    counts = {int(k): int(v) for k, v in spmm.launch_counts.items()}
    rep = dict(f32_logit_err=f32_err, bf16_card_err=gpu_bf16, bf16_cpu_err=cpu_bf16,
               bf16_launches=counts,
               ok=(f32_err <= 1e-4 and gpu_bf16 <= 4 * cpu_bf16 + 1e-3
                   and counts == {200: 1, 512: 2}))
    log(f"  use_bn pair eval at the products widths, N={n}, E={ei.shape[1]}: f32 logits card "
        f"vs CPU max abs err {f32_err:.2e} (tol 1e-4); bf16 logits from the CPU's f32: card "
        f"{gpu_bf16:.3e}, CPU bf16 {cpu_bf16:.3e} (card <= 4 x CPU + 1e-3); bf16 SpMM launches "
        f"by F {counts} (expected {{200: 1, 512: 2}})")
    if not rep["ok"]:
        raise RuntimeError(f"the use_bn pair eval on the card disagrees with the CPU: {rep}")
    return rep


def run_bn_path(out: Path) -> dict:
    """9b: co-teaching and the baseline under use_bn through ``main`` at the
    products widths; the SpMM counts by F reset before and read after."""
    cfg = load_config(CONFIG)
    cfg.update(use_bn=True, num_runs=1, max_epochs=2, reinit_retries=0,
               out_dir=str(out / "bn"))
    seen: list = []
    ct_epoch, baseline_epoch = steps.ct_epoch, steps.baseline_epoch
    steps.ct_epoch = _counting_steps(ct_epoch, seen)
    steps.baseline_epoch = _counting_steps(baseline_epoch, seen)
    try:
        r = _drive(cfg)
    finally:
        steps.ct_epoch, steps.baseline_epoch = ct_epoch, baseline_epoch
    ct, base = _events(r, "epoch_ct"), _events(r, "epoch_baseline")
    nsteps = seen[0]
    for e in ct:
        log(f"  BN CT epoch {e['epoch']}: train {e['epoch_train_s']:.3f} s "
            f"({e['epoch_train_s'] / nsteps * 1e3:.1f} ms a step), eval {e['epoch_eval_s']:.3f} "
            f"s, loss {e['loss_1']:.4f}/{e['loss_2']:.4f}, val {e['val_acc_1']:.4f}/"
            f"{e['val_acc_2']:.4f}")
    for e in base:
        log(f"  BN baseline epoch {e['epoch']}: train {e['epoch_train_s']:.3f} s "
            f"({e['epoch_train_s'] / nsteps * 1e3:.1f} ms a step), eval {e['epoch_eval_s']:.3f} "
            f"s, loss {e['loss']:.4f}, val {e['val_acc']:.4f}")
    log(f"  {nsteps} steps an epoch (no step cap); main(config) wall {r['wall_s']:.1f} s, peak "
        f"device memory {r['peak_bytes'] / 2**30:.2f} GiB, SpMM launches by F {r['launches']}")
    if len(ct) != 2 or len(base) != 2:
        raise RuntimeError(f"expected 2 BN CT and 2 baseline epochs, got {len(ct)}, {len(base)}")
    losses = [e[k] for e in ct for k in ("loss_1", "loss_2")] + [e["loss"] for e in base]
    if not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"non-finite BN loss: {losses}")
    vals = [max(ct[-1]["val_acc_1"], ct[-1]["val_acc_2"]), base[-1]["val_acc"]]
    if not min(vals) > 1 / 47:
        raise RuntimeError(f"BN validation accuracy (co-teaching, baseline) not above 1/47: {vals}")
    # two epochs of the pair eval's three layers (2F, 2H, 2H) and of the
    # baseline's single eval's (F, H, H); no leaf table under BN
    f, h = int(cfg["nbr_features"]), int(cfg["hidden_size"])
    want = {f: 2, 2 * f: 2, h: 4, 2 * h: 4}
    if r["launches"] != want:
        raise RuntimeError(f"the BN run launched the SpMM {r['launches']} times by F, expected "
                           f"{want}")
    return dict(config=CONFIG, use_bn=True, steps=nsteps, wall_s=r["wall_s"],
                peak_bytes=r["peak_bytes"], launches=r["launches"], ct_epochs=ct,
                baseline_epochs=base,
                ct_step_ms=ct[-1]["epoch_train_s"] / nsteps * 1e3,
                baseline_step_ms=base[-1]["epoch_train_s"] / nsteps * 1e3)


def check_small_gat(dev, g) -> dict:
    """9c, before the run: one GAT forward at config_cora.yml's widths on
    the subgraph of the synthetic cora's first 2,000 nodes, with an edge
    mask, on the card against the CPU: f32, within 1e-5."""
    n = 2_000
    ei = g.edge_index[:, (g.edge_index[0] < n) & (g.edge_index[1] < n)]
    em = np.random.default_rng(11).random(ei.shape[1]) < 0.8
    spec = nets.NetSpec(module="gat", in_size=g.num_features, hidden_size=512,
                        out_size=g.num_classes, num_layers=2, dropout=0.0)
    init = params_to_jax(nets.init_params(torch.Generator().manual_seed(1), spec))

    def fwd(d):
        return nets._gat_forward(spec, params_from_jax(init, d), torch.from_numpy(g.x[:n]).to(d),
                                 torch.from_numpy(ei).to(d), n, torch.from_numpy(em).to(d)).cpu()

    got, want = fwd(dev), fwd("cpu")
    err = (got - want).abs().max().item()
    rep = dict(N=n, E=int(ei.shape[1]), max_abs_err=err, max_abs_logit=want.abs().max().item(),
               ok=err <= 1e-5)
    log(f"  GAT forward on {n} nodes, {rep['E']} edges (mask 0.8), {g.num_features} -> 512 -> "
        f"{g.num_classes}: card vs CPU max abs err {err:.2e} (tol 1e-5; logits up to "
        f"{rep['max_abs_logit']:.3f})")
    if not rep["ok"]:
        raise RuntimeError(f"the GAT forward on the card disagrees with the CPU: {rep}")
    return rep


def _gat_config(out: Path) -> dict:
    cfg = load_config(CORA_CONFIG)
    cfg.update(module_compare="gat", train_type="both", num_runs=1, max_epochs=2,
               out_dir=str(out))
    return cfg


def run_gat_path(out: Path, g) -> dict:
    """9c: sage co-teaching beside a GAT baseline through ``main`` on
    config_cora.yml; SpMM counts (the sage pair eval) and peak memory."""
    cfg = _gat_config(out / "gat")
    seen: list = []
    baseline_epoch = steps.baseline_epoch
    steps.baseline_epoch = _counting_steps(baseline_epoch, seen)
    try:
        r = _drive(cfg)  # main: coteaching on cora -> PipelineS
    finally:
        steps.baseline_epoch = baseline_epoch
    ct, base = _events(r, "epoch_ct"), _events(r, "epoch_baseline")
    nsteps = seen[0]
    rows = int(cfg["batch_size"]) * (1 + int(np.cumsum(np.cumprod(cfg["nbr_neighbors"]))[-1]))
    for e in ct:
        log(f"  sage CT epoch {e['epoch']}: train {e['epoch_train_s']:.3f} s, loss "
            f"{e['loss_1']:.4f}/{e['loss_2']:.4f}, val {e['val_acc_1']:.4f}/{e['val_acc_2']:.4f}")
    for e in base:
        log(f"  GAT baseline epoch {e['epoch']}: train {e['epoch_train_s']:.3f} s "
            f"({e['epoch_train_s'] / nsteps * 1e3:.1f} ms a step over flat subgraphs of "
            f"{rows} rows), eval {e['epoch_eval_s']:.3f} s (dense "
            f"[{g.num_nodes}, {g.num_nodes}]), loss {e['loss']:.4f}, val {e['val_acc']:.4f}")
    log(f"  main(config) wall {r['wall_s']:.1f} s, peak device memory "
        f"{r['peak_bytes'] / 2**30:.2f} GiB, SpMM launches by F {r['launches']}")
    if len(ct) != 2 or len(base) != 2:
        raise RuntimeError(f"expected 2 CT and 2 GAT baseline epochs, got {len(ct)}, {len(base)}")
    losses = [e[k] for e in ct for k in ("loss_1", "loss_2")] + [e["loss"] for e in base]
    if not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"non-finite loss in the GAT run: {losses}")
    want = {g.num_features: 1, 2 * int(cfg["hidden_size"]): 2}  # leaf table, pair layer 2
    if r["launches"] != want:
        raise RuntimeError(f"the GAT run launched the SpMM {r['launches']} times by F, "
                           f"expected {want}")
    return dict(config=CORA_CONFIG, module_compare="gat", steps=nsteps, wall_s=r["wall_s"],
                peak_bytes=r["peak_bytes"], launches=r["launches"], ct_epochs=ct,
                baseline_epochs=base, gat_step_ms=base[-1]["epoch_train_s"] / nsteps * 1e3)


def run_profile(out: Path, dev) -> dict:
    """9d: three GAT baseline steps of 9c's configuration, each in
    ``trace("step")``, inside one ``start_profile`` / ``stop_profile``; the
    Chrome trace must exist and name the step region."""
    pipe = PipelineS(_gat_config(out / "profile"))
    spec = pipe.spec_for("gat")
    s = pipe.init_state(spec)
    seeds, masks = pipe.epoch_seed_matrix(pipe.split_idx["train"], int(pipe.config["batch_size"]))
    noise_mat = torch.as_tensor(pipe.noise_mat, dtype=torch.float32, device=dev)
    start_profile(str(out / "profile" / "trace"))
    for i in range(3):
        j = i % seeds.shape[0]
        with trace("step"):
            steps.baseline_epoch(spec, s, pipe.data, seeds[j:j + 1], masks[j:j + 1], pipe.gen,
                                 noise_mat, pipe.fanouts,
                                 compare_loss=pipe.config["compare_loss"])
            torch.cuda.synchronize()
    path = Path(stop_profile())
    events = json.loads(path.read_text())["traceEvents"]

    def spans(cat):
        return [ev["dur"] / 1e3 for ev in events if ev.get("name") == "step"
                and ev.get("cat") == cat]

    kernels = [ev for ev in events if ev.get("cat") == "kernel"]
    rep = dict(trace=str(path), trace_bytes=path.stat().st_size,
               step_ms=spans("user_annotation"), step_ms_on_card=spans("gpu_user_annotation"),
               kernel_events=len(kernels),
               kernel_ms=sum(ev.get("dur", 0) for ev in kernels) / 1e3)
    # one stream, so kernels do not overlap: their summed time over the
    # host's step spans is the card's busy share of the steps
    rep["busy_share"] = rep["kernel_ms"] / max(sum(rep["step_ms"]), 1e-9)
    log(f"  trace {path.name} ({rep['trace_bytes'] / 1e6:.1f} MB): 'step' spans on the host "
        f"{['%.1f' % v for v in rep['step_ms']]} ms, on the card "
        f"{['%.1f' % v for v in rep['step_ms_on_card']]} ms; {len(kernels)} kernel events, "
        f"{rep['kernel_ms']:.1f} ms of kernel time: the card busy "
        f"{100 * rep['busy_share']:.1f}% of the steps")
    if len(rep["step_ms"]) != 3:
        raise RuntimeError(f"the profile does not name 3 'step' regions: {rep}")
    return rep


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
    t_start = time.perf_counter()
    out.mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    log(f"[1] device: {smi} | torch {torch.__version__} CUDA {torch.version.cuda} | "
        f"{kind} x{count}")
    t0 = time.perf_counter()

    def timed(build):
        t = time.perf_counter()
        return build(), time.perf_counter() - t

    # a fresh checkout has nothing built: both kernels (nvcc) and the host
    # graph runtime (g++), all started together
    with ThreadPoolExecutor(3) as pool:
        (lib_s, _), (lib_g, _), (_, native_s) = pool.map(
            timed, (spmm.build, gather_ring.build, native.build))
    build_s = time.perf_counter() - t0
    log(f"    built {lib_s.name} from {SOURCE} and {lib_g.name} from {GATHER_SOURCE} "
        f"in {build_s:.1f} s (the graph runtime in {native_s:.1f} s beside them)")

    log("[2] kernels against their plain versions")
    cases = check_kernel(dev)
    bad = [c for c in cases if not c["ok"]]
    if bad:
        raise RuntimeError(f"{len(bad)} of {len(cases)} kernel checks out of tolerance: {bad[:3]}")
    log(f"    all {len(cases)} SpMM cases within tolerance")
    gather_cases = check_gather_small(dev)
    small = check_small_path(dev)
    small_ctp = check_small_ctp(dev)
    small_rewire = check_small_rewire(dev)
    small_te = check_small_te(dev)
    small_h = check_small_h(dev)
    small_ct = check_small_ct(dev)

    log("[3] main path: products, full width")
    main_rep = run_main_path(out)

    log("[4] CTP path: arxiv, full width, with resume and load-and-eval")
    ctp_rep = run_ctp_path(out)

    log("[5] gather probe path: the tool's shapes")
    gather_rep = run_gather_path(dev)

    log("[6] SpMM check and timing at the main paths' shapes, full graphs")
    rows = time_shapes(dev, CONFIG, [(name, f) for name, f, _ in SHAPES] + list(BN_SHAPES),
                       torch.bfloat16)
    ctp_rows = time_shapes(dev, CTP_CONFIG, CTP_SHAPES, torch.float32)

    log("[7] TE path: arxiv, full width, with the rewired contrast")
    te_rep = run_te_path(out, dev)

    log("[8] H and CT paths: arxiv, full width, each killed and resumed")
    h_rep = run_h_path(out)
    ct_rep = run_ct_path(out)

    log("[9] slice 5: the native runtime, use_bn, GAT, the profiler")
    t9 = time.perf_counter()
    log("  [9a] the graph runtime")
    native_rep = run_native(native_s, main_rep)
    t9a = time.perf_counter()
    log(f"  [9a] {t9a - t9:.1f} s")
    log("  [9b] use_bn co-teaching and baseline: products, full width")
    small_bn = check_small_bn(dev)
    bn_rep = run_bn_path(out)
    t9b = time.perf_counter()
    log(f"  [9b] {t9b - t9a:.1f} s")
    log("  [9c] GAT baseline beside sage co-teaching: cora, full width")
    cora_cfg = load_config(CORA_CONFIG)
    cora = load_network(cora_cfg)
    small_gat = check_small_gat(dev, cora)
    gat_rep = run_gat_path(out, cora)
    cora_rows = time_shapes(dev, CORA_CONFIG,
                            [("cora leaf table", cora.num_features),
                             ("cora eval pair", 2 * int(cora_cfg["hidden_size"]))],
                            torch.float32)
    t9c = time.perf_counter()
    log(f"  [9c] {t9c - t9b:.1f} s")
    log("  [9d] the profiler around three GAT baseline steps")
    profile_rep = run_profile(out, dev)
    log(f"  [9d] {time.perf_counter() - t9c:.1f} s; phase 9 {time.perf_counter() - t9:.1f} s")

    kernels = []
    for row in rows:
        by_path = {"co": main_rep["launches"].get(row["F"], 0),
                   "bn": bn_rep["launches"].get(row["F"], 0)}
        k = spmm_row(row, sum(by_path.values()))
        k.update({f"launches_{p}": c for p, c in by_path.items()})
        kernels.append(k)
    arxiv_runs = {"ctp": list(ctp_rep["runs"].values()), "te": [te_rep],
                  "h": list(h_rep["runs"].values()), "ct": list(ct_rep["runs"].values())}
    for row in ctp_rows:
        by_path = {p: sum(r["launches"].get(row["F"], 0) for r in rs)
                   for p, rs in arxiv_runs.items()}
        k = spmm_row(row, sum(by_path.values()))
        k.update({f"launches_{p}": c for p, c in by_path.items()})
        kernels.append(k)
    block_sel = gather_rep["yardsticks"]["index_select blocks"]
    row_sel = gather_rep["yardsticks"]["index_select rows"]
    for r in gather_rep["depths"]:
        kernels.append(dict(
            name=f"gather_ring (depth {r['depth']}, chunk {gather_probe.CHUNK}, "
                 f"P={gather_probe.P}, [8, {gather_probe.F}] f32 blocks)",
            route="cuda", source=GATHER_SOURCE, replaces=GATHER_REPLACES,
            launches=r["launches"], max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=block_sel["ms"], library_rows_ms=row_sel["ms"], cluster=r["cluster"],
            active_clusters=r["active_clusters"]))
    kernels += [spmm_row(row, gat_rep["launches"].get(row["F"], 0)) for row in cora_rows]
    report = dict(nvidia_smi=smi, device=kind, count=count, build_s=build_s,
                  checks=cases, gather_checks=gather_cases, small_path=small,
                  small_ctp=small_ctp, small_rewire=small_rewire, small_te=small_te,
                  small_h=small_h, small_ct=small_ct, main_path=main_rep, ctp_path=ctp_rep,
                  gather_path=gather_rep, timing=rows, ctp_timing=ctp_rows, te_path=te_rep,
                  h_path=h_rep, ct_path=ct_rep, native=native_rep, small_bn=small_bn,
                  bn_path=bn_rep, small_gat=small_gat, gat_path=gat_rep, cora_timing=cora_rows,
                  profile=profile_rep, kernels=kernels,
                  script_s=time.perf_counter() - t_start)
    log(f"    whole script {report['script_s']:.1f} s")
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
