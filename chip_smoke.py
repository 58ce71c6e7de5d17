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
10. Slice 6, ``parallel/`` (the card is one, so no multi-card run: the
   NCCL calls run in a one-rank group, and the multi-rank logic on two
   ranks sharing the card over gloo; their times are not multi-card times).
   (a) A one-rank NCCL group: one ``make_dp_ct_step`` at
   config_arxiv10.yml's widths (sage 3 x 256, fanouts [10, 5, 5], batch
   512, dropout 0.5, f32) on the synthetic arxiv, whose params and summed
   losses must equal the one-process step's bit for bit (the same draws;
   a one-rank all-gather and all-reduce copy); then the halo pair eval
   (``make_halo_inference``'s ``infer_pair``) within 2e-5 of the CUDA
   SpMM's pair eval of the same params, both timed. (b) ``main`` on
   ``configs/config_products.yml`` (full width, bf16, exact leaf) with
   num_runs 1, max_epochs 1 (one CT and one baseline epoch over the
   config's whole train split of 1292 steps: a shorter run leaves both
   nets at chance) on two ranks, ``chip_smoke.py --dp-worker`` processes
   sharing ``cuda:0`` over gloo, after the same run in this process: the
   ranks' results equal, each epoch's params hash equal across the ranks
   (the pipeline checks it), validation above 1/47 for the better
   co-teaching net and the baseline and within 0.02 of the one-process
   run's, each rank's leaf table built by the SpMM; then one f32 DP
   co-teaching step at the config's widths and fanouts (no exact leaf,
   dropout on) equal on both ranks bit for bit and within 1e-4 of the
   one-process step. It logs the step times, the halo pack's seconds, the
   exchange bytes a layer and each rank's peak memory. (c)
   ``configs/config_arxiv10.yml`` with ``full_graph: true`` on two such
   ranks for 2 epochs (one full-graph step each): finite losses, the
   better net's validation above 1/40, the param hashes recorded.

11. Slice 7, data parallelism in the CTP, TE, H and CT epochs, under
   ``use_bn`` and in the GAT baseline (one card again: a one-rank NCCL
   group, then two ranks sharing it over gloo; no time here is a
   multi-card time). (a) A one-rank NCCL group: one step each of
   ``ctp_epoch`` (consistency on), ``te_epoch`` (the rewired contrast on),
   ``h_epoch`` (the pseudo net on), the CT finetune, the co-teaching step
   under ``use_bn`` and the GAT baseline, at small widths (64 features and
   hidden, 10 classes, fanouts [10, 5] and [10, 5, 5], dropout 0.5) on a
   random 4,000-node graph: params, summed metrics and the rewires' picks
   bit-equal to the one-process step's. (b) ``main`` on
   ``configs/config_arxiv.yml`` at full width (sagePL 3 x 256, fanouts [10,
   5, 5], batch 512, f32; phase 7's cut of ``TE_STEPS`` batches, epoch 1
   rewiring) on two ranks, beside phase 7's one-process run: each rank's
   rewire (CUDA events) and the row blocks it swept (39 of 78 a step, which
   must hold), each flat gather of f32 rows (the [159,232, 256] ``h_pure``,
   bytes whole and ms), ms a plain and a contrast step, each rank's peak,
   the largest epoch-metric differences from one process, the replica
   hashes (equal on both ranks); then a TE probe step (f32, seeded params,
   the first batch) on the ranks and, on rank 0, in one process: how many
   of the k2 = 31,846 picks differ (the pure passes' GEMMs run over half
   the rows, so near-ties may go the other way: counted, not hidden) and
   the params' distance. Validation within 0.02 of phase 7's. (c)
   ``configs/config_ctp.yml`` and ``configs/config_h.yml`` (2 epochs, the
   train split cut to 16 batches) on two ranks, each beside the same run
   in this process, and ``configs/config_contrast.yml`` (phase 8's
   configuration: warmup 2, the split, finetune 2) on two ranks beside
   phase 8's one-process run: the same records, the views' hash, and the
   split's sizes, which must equal one process's; best test accuracy
   within 0.02 of one process's.

12. Slice 8, tensor parallelism (``model_parallel`` M = 2; the card is
   one, so every rank shares it over gloo: no time here is a multi-card
   time). (a) Phase 11a's small-width steps (now also co-teaching and the
   back-corrected baseline), the states sharded, on two ranks at (D, M) =
   (1, 2) and four at (2, 2), the six ranks started at once and run
   beside (c), against
   phase 11a's one-process steps on the card: summed metrics within 1e-5
   relative (atol 1e-6), params (gathered whole) within 1e-4 and equal on
   every rank, the CT projection bias within lr of its start (it feeds a
   batch norm, as in phase 2), the rewires' picks equal. (b)
   ``configs/config_products.yml`` at full width (3 x 256 bf16, exact
   leaf) through ``main`` at (1, 2), one CT and one baseline epoch with
   the train split cut to ``TP_STEPS`` batches (the split cache, in the
   phase's own ``data_dir``, beside a link to phase 3's graph cache), and
   the same run in this process: ms a step, each rank's peak, the model
   axis's column gathers and input-gradient all-reduces a step (calls,
   bytes, CUDA-event ms), the SpMM counts (each rank's leaf table must go
   through the kernel), the ranks' results and param hashes equal,
   validation within 0.02 of one process's. (c) ``configs/config_cora.yml``
   (sage 2 x 512) at (1, 2), co-teaching for 2 epochs; then 1 epoch with
   ``ckpt_every: 1`` and ``resume: true`` to 2: the resumed epoch's losses,
   pure ratios and param hash bit-equal to the uninterrupted TP run's;
   then the checkpoint (whole, the one format) loaded in one process with
   ``do_train: false``: validation within 1e-3 of the resumed run's.

13. Slice 9, the measuring tools (``noise_gnn_tpu_torch/tools/``), each
   called as a user would (``run``), its JSON line logged as ``[13] <tool>
   {...}``: ``bench_spmm`` at its full default shape (``bench.py``'s graph,
   1,000,000 nodes, 32,000,000 edges, F = 256 bf16; 3 timed calls a leg),
   then the kernel on that graph against its plain version at F = 256 and
   at the dual 2F = 512 (phase 2's tolerance, two calls bit-equal);
   ``bench_trainstep`` and ``profile_step`` at their default shapes (1.2 M
   nodes of degree 26, 3 x 256 SAGE, batch 512, fanouts [15, 10, 5], bf16)
   cut to ``TOOL_STEPS`` steps a run, 2 timed runs; ``bench_scaling --world
   1 2``, the two ranks sharing the card over gloo (which must not be
   reported as a scaling number); and one ``evidence --one`` row,
   ``config_cora.yml`` co-teaching vs CE cut to 1 run of 3 epochs, whose
   accuracies must be finite. Each tool's seconds are logged; no launch of
   this phase enters the kernels line.

Then it prints one ``{"kernels": [...]}`` line (errors from the full-size
checks, launches from the main paths; the products rows count phase 3's,
9b's, 10b's ranks' and 12b's ranks' and one-process runs, the arxiv rows
the CTP, TE, H and CT runs' and phase 11's ranks' and one-process runs',
the cora rows 9c's and 12c's ranks' and loaded runs; each path's also on
its own), the ``nvidia-smi`` line and, last, ``{"ok": true, "device":
{...}}``. Details go to ``<out>/report.json``.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import gc
import inspect
import json
import math
import os
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
from noise_gnn_tpu_torch.models.convert import gather_params, params_from_jax, params_to_jax
from noise_gnn_tpu_torch.ops import gather_ring, sddmm, spmm
from noise_gnn_tpu_torch.ops.leaf_agg import fused_leaf_table
from noise_gnn_tpu_torch.ops.tree_agg import TreeTopo
from noise_gnn_tpu_torch.parallel import make_dp_ct_step, make_mesh, multihost
from noise_gnn_tpu_torch.parallel.halo import (build_halo_partition, make_halo_inference,
                                               place_partition, shard_features)
from noise_gnn_tpu_torch.tools import (bench_scaling, bench_spmm, bench_trainstep, evidence,
                                       gather_probe, profile_step)
from noise_gnn_tpu_torch.train import pipelines, steps
from noise_gnn_tpu_torch.train.pipelines import BasePipeline, PipelineCO, PipelineS
from noise_gnn_tpu_torch.utils.config import load_config
from noise_gnn_tpu_torch.utils.profiling import (FP32_OPS_PER_S, HBM_BYTES_PER_S, start_profile,
                                                  stop_profile, time_ms, time_turns, trace)

CONFIG = "configs/config_products.yml"
CTP_CONFIG = "configs/config_ctp.yml"
TE_CONFIG = "configs/config_arxiv.yml"
H_CONFIG = "configs/config_h.yml"
CT_CONFIG = "configs/config_contrast.yml"
CORA_CONFIG = "configs/config_cora.yml"
FG_CONFIG = "configs/config_arxiv10.yml"
TE_STEPS = 64  # train batches an epoch in phase 7
DP_DEVICE = "cuda:0"  # the card the ranks of phases 10b and 10c share
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

        def recording(h, topo, k, **kw):
            out = rewire.topk_rewire_tree(h, topo, k, **kw)
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

    def timed_rewire(h, topo, k, **kw):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        res = rewire.topk_rewire_tree(h, topo, k, **kw)
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


# ------------------------------------------------------------------ phase 10


def _rank_rows_equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


def _capture_pipeline(box: list, cls=PipelineCO):
    """Patch ``cls.loop`` to keep the pipeline ``main`` builds (the f32 and
    probe steps reuse its graph); returns the original to restore."""
    loop = cls.loop

    def keeping(self):
        box.append(self)
        return loop(self)

    cls.loop = keeping
    return loop


def dp_f32_step(pipe, mesh) -> dict:
    """One f32 co-teaching step at the pipeline's widths and fanouts (no
    exact leaf, dropout on) from seeded params on the first batch of its
    train split: the one-process step (``mesh`` None) or the DP step over
    ``mesh``. Returns both nets' params after it, as numpy by leaf name."""
    spec = dataclasses.replace(pipe.spec_for(), compute_dtype="float32")
    data = dataclasses.replace(pipe.data, x=pipe.data.x.float(), leaf_agg=None)
    dev, bs = pipe.device, int(pipe.config["batch_size"])
    seeds = torch.from_numpy(pipe.split_idx["train"][:bs]).long().to(dev)
    mask = torch.ones(bs, dtype=torch.bool, device=dev)
    init = torch.Generator(device=dev).manual_seed(3)
    s1 = steps.init_state(init, spec, pipe.make_optimizer, dev)
    s2 = steps.init_state(init, spec, pipe.make_optimizer, dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    if mesh is None:
        steps.ct_step(spec, s1, s2, data, seeds, mask, gen, torch.tensor(0.3, device=dev),
                      pipe.fanouts)
    else:
        make_dp_ct_step(spec, pipe.fanouts, mesh)(s1, s2, data, seeds, mask, gen, 0.3)
    return {f"{i}/{name}": v for i, s in enumerate((s1, s2))
            for name, v in _flat_params(params_to_jax(s.params)).items()}


def _flat_params(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        return {k2: v for k in tree for k2, v in _flat_params(tree[k], f"{prefix}{k}.").items()}
    if isinstance(tree, list):
        return {k2: v for i, t in enumerate(tree)
                for k2, v in _flat_params(t, f"{prefix}{i}.").items()}
    return {prefix.rstrip("."): np.asarray(tree)}


def dp_worker(arg: str) -> int:
    """One rank of phase 10b or 10c (``chip_smoke.py --dp-worker JSON``):
    joins the gloo group, runs ``main`` on the config with its SpMM counts
    and peak memory reset, then (10b) the DP f32 step; writes its report.
    Phase 11's ranks go to :func:`epochs_worker`, phase 12's to
    :func:`tp_worker`."""
    a = json.loads(arg)
    if a.get("epochs"):
        return epochs_worker(a)
    if a.get("tp"):
        return tp_worker(a)
    multihost.initialize(init_method=f"file://{a['pg']}", world_size=a["world"],
                         rank=a["rank"], backend="gloo")
    torch.cuda.reset_peak_memory_stats()
    spmm.launch_counts.clear()
    box = []
    loop = _capture_pipeline(box)
    try:
        t0 = time.perf_counter()
        res = port_main(a["config"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        PipelineCO.loop = loop
    (pipe,) = box
    part = pipe._halo_part
    spec = pipe.spec_for()
    el = 2 if spec.compute_dtype == "bfloat16" else 4
    rep = dict(rank=a["rank"], wall_s=wall, peak_bytes=torch.cuda.max_memory_allocated(),
               launches={int(f): int(c) for f, c in spmm.launch_counts.items()},
               result={k: list(v) for k, v in res.items()},
               halo=dict(per=part.per, b_max=part.b_max, e_max=part.e_max,
                         boundary_rows=part.boundary_rows_total,
                         comm_pair={f: part.comm_bytes_per_layer(f, el)
                                    for f in (2 * spec.in_size, 2 * spec.hidden_size)}))
    if a["f32_step"]:
        np.savez(Path(a["out"]).with_suffix(".npz"), **dp_f32_step(pipe, pipe.mesh))
    Path(a["out"]).write_text(json.dumps(rep, default=str))
    torch.distributed.destroy_process_group()
    return 0


def _start_ranks(out: Path, tag: str, cfg: dict | None, world: int, f32_step: bool,
                 extra: dict | None = None):
    """Start ``world`` ranks of :func:`dp_worker` (with ``extra`` in its
    argument) sharing ``cuda:0`` over gloo; :func:`_wait_ranks` waits."""
    d = (out / tag).resolve()  # file:// takes an absolute path
    d.mkdir(parents=True, exist_ok=True)
    (d / "pg").unlink(missing_ok=True)
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    procs = []
    for r in range(world):
        arg = json.dumps(dict(rank=r, world=world, pg=str(d / "pg"), config=cfg,
                              out=str(d / f"rank{r}.json"), f32_step=f32_step, **(extra or {})))
        procs.append(subprocess.Popen([sys.executable, __file__, "--dp-worker", arg],
                                      stdout=open(d / f"rank{r}.log", "w"),
                                      stderr=subprocess.STDOUT, env=env))
    return d, procs


def _wait_ranks(tag: str, started, timeout: int = 600) -> list:
    """Each rank's report once all have exited 0 (killed if the wait runs
    out, or as soon as one rank fails: the others would wait for it)."""
    d, procs = started
    world = len(procs)
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
            if any(p.returncode not in (None, 0) for p in procs):
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    codes = [p.returncode for p in procs]
    if any(codes):
        # the logs of the ranks that failed on their own (not killed here)
        bad = [r for r, c in enumerate(codes) if c > 0] or list(range(world))
        tails = "\n".join(f"--- rank {r}:\n" + (d / f"rank{r}.log").read_text()[-3000:]
                          for r in bad)
        raise RuntimeError(f"{tag}: the ranks exited {codes}\n{tails}")
    return [json.loads((d / f"rank{r}.json").read_text()) for r in range(world)]


def _run_ranks(out: Path, tag: str, cfg: dict, world: int, f32_step: bool,
               timeout: int = 600, extra: dict | None = None) -> list:
    """``world`` ranks of :func:`dp_worker` sharing ``cuda:0`` over gloo,
    started together and waited for."""
    return _wait_ranks(tag, _start_ranks(out, tag, cfg, world, f32_step, extra), timeout)


def _metrics(cfg: dict) -> list[dict]:
    (path,) = (Path(cfg["out_dir"]) / "metrics").glob("*.jsonl")
    return [json.loads(line) for line in path.read_text().splitlines()]


def run_dp_nccl(out: Path, dev) -> dict:
    """Phase 10a: a one-rank NCCL group on the card; the DP co-teaching step
    bit-equal to the one-process step, and the halo pair eval against the
    CUDA SpMM's pair eval, on the synthetic arxiv at config_arxiv10.yml's
    widths, f32."""
    (out / "pg10a").unlink(missing_ok=True)
    multihost.initialize(init_method=f"file://{(out / 'pg10a').resolve()}", world_size=1,
                         rank=0, backend="nccl")
    try:
        mesh = make_mesh()
        cfg = load_config(FG_CONFIG)
        g = load_network(cfg)
        spec = nets.make_network(dict(cfg, compute_dtype="float32"), g.num_features,
                                 g.num_classes, g.num_nodes)
        rng = np.random.default_rng(0)
        yhn = np.where(rng.random(g.num_nodes) < 0.3, rng.integers(0, g.num_classes,
                                                                   g.num_nodes), g.y)
        csr = CSRGraph.from_coo(g.edge_index, g.num_nodes, dev)
        x = torch.from_numpy(g.x).to(dev)
        data = steps.GraphData(x, torch.from_numpy(g.y).long().to(dev),
                               torch.from_numpy(yhn).long().to(dev),
                               torch.from_numpy(yhn == g.y).to(dev), csr)
        fanouts = tuple(int(f) for f in cfg["nbr_neighbors"])
        bs = int(cfg["batch_size"])
        seeds = torch.from_numpy(g.split_idx()["train"][:bs]).long().to(dev)
        mask = torch.ones(bs, dtype=torch.bool, device=dev)

        def adam(params):
            return torch.optim.Adam(params, lr=float(cfg["learning_rate"]))

        def states():
            init = torch.Generator(device=dev).manual_seed(5)
            return steps.init_state(init, spec, adam, dev), steps.init_state(init, spec, adam, dev)

        a1, a2 = states()
        b1, b2 = states()
        m_dp = make_dp_ct_step(spec, fanouts, mesh)(a1, a2, data, seeds, mask,
                                                      torch.Generator(device=dev).manual_seed(7), 0.3)
        m_one = steps.ct_step(spec, b1, b2, data, seeds, mask,
                              torch.Generator(device=dev).manual_seed(7),
                              torch.tensor(0.3, device=dev), fanouts)
        step_equal = all(torch.equal(p, q) for s, t in ((a1, b1), (a2, b2))
                         for p, q in zip(nets.parameters(s.params), nets.parameters(t.params)))
        loss_equal = bool(torch.equal(torch.stack([m_dp["loss_1"], m_dp["loss_2"]]), m_one[:2]))

        t0 = time.perf_counter()
        part = place_partition(mesh, build_halo_partition(g.edge_index, g.num_nodes, 1), dev)
        torch.cuda.synchronize()
        pack_s = time.perf_counter() - t0
        xs = shard_features(mesh, x, part)
        _, _, infer_pair = make_halo_inference(mesh, spec, None, g.num_nodes, part=part)
        spmm_pair = FullGraphInference(spec, csr).pair
        p1, p2 = a1.params, a2.params
        h1, h2 = infer_pair(p1, p2, xs)
        s1, s2 = spmm_pair(p1, p2, x)
        err = max((h1[:g.num_nodes] - s1).abs().max().item(),
                  (h2[:g.num_nodes] - s2).abs().max().item())
        mag = max(s1.abs().max().item(), s2.abs().max().item())
        halo_ms = time_ms(lambda: infer_pair(p1, p2, xs), reps=3, warm=1)
        spmm_ms = time_ms(lambda: spmm_pair(p1, p2, x), reps=3, warm=1)
    finally:
        torch.distributed.destroy_process_group()
    log(f"  [10a] one-rank NCCL group: DP step params bit-equal to the one-process step: "
        f"{step_equal} (summed losses equal: {loss_equal}); halo pair eval against the CUDA "
        f"SpMM pair eval: max |diff| {err:.3e} (logits up to {mag:.3f}), {halo_ms:.2f} ms "
        f"against {spmm_ms:.2f} ms; halo pack + placement {pack_s:.2f} s")
    if not (step_equal and loss_equal):
        raise RuntimeError("the DP step on a one-rank NCCL group differs from the one-process step")
    if not err <= 2e-5:
        raise RuntimeError(f"the halo pair eval is {err:.3e} from the SpMM pair eval (2e-5)")
    return dict(step_equal=step_equal, loss_equal=loss_equal, pair_max_abs_err=err,
                logit_max=mag, halo_pair_ms=halo_ms, spmm_pair_ms=spmm_ms, pack_s=pack_s)


def run_dp_shared(out: Path) -> dict:
    """Phase 10b: ``main`` on config_products.yml on two ranks sharing
    ``cuda:0`` over gloo, against the same run in this process. All three
    load the graph from the generation cache under the config's
    ``data_dir`` (phase 3 wrote it; else the first run here does)."""
    root = out / "dp"
    shutil.rmtree(root, ignore_errors=True)
    cfg = load_config(CONFIG)
    cfg.update(num_runs=1, max_epochs=1, reinit_retries=0, device=DP_DEVICE)
    one_cfg = dict(cfg, out_dir=str(root / "one"))
    box = []
    loop = _capture_pipeline(box)
    try:
        one = _drive(one_cfg)
    finally:
        PipelineCO.loop = loop
    nsteps = -(-len(box[0].split_idx["train"]) // int(cfg["batch_size"]))
    one_step = dp_f32_step(box[0], None)
    box.clear()  # free the one-process run's memory for the ranks
    gc.collect()
    torch.cuda.empty_cache()
    dp_cfg = dict(cfg, out_dir=str(root / "ranks"))
    t0 = time.perf_counter()
    ranks = _run_ranks(root, "ranks", dp_cfg, 2, f32_step=True)
    dp_wall = time.perf_counter() - t0
    recs, one_recs = _metrics(dp_cfg), one["records"]
    steps_dp = [np.load(root / "ranks" / f"rank{r}.npz") for r in range(2)]
    step_ranks_equal = _rank_rows_equal(dict(steps_dp[0]), dict(steps_dp[1]))
    step_err = max(float(np.abs(steps_dp[0][k] - one_step[k]).max()) for k in one_step)
    rows = {}
    for tag, rs in (("dp", recs), ("one", one_recs)):
        ct, base = [r for r in rs if r.get("event") == "epoch_ct"], \
            [r for r in rs if r.get("event") == "epoch_baseline"]
        rows[tag] = dict(ct=ct, base=base)
        for e in ct:
            log(f"  {tag} CT epoch {e['epoch']}: train {e['epoch_train_s']:.3f} s "
                f"({e['epoch_train_s'] / nsteps * 1e3:.2f} ms a step), eval "
                f"{e['epoch_eval_s']:.3f} s, loss {e['loss_1']:.5f}/{e['loss_2']:.5f}, val "
                f"{e['val_acc_1']:.4f}/{e['val_acc_2']:.4f}, hash {e.get('param_hash')}")
        for e in base:
            log(f"  {tag} baseline epoch {e['epoch']}: train {e['epoch_train_s']:.3f} s "
                f"({e['epoch_train_s'] / nsteps * 1e3:.2f} ms a step), eval "
                f"{e['epoch_eval_s']:.3f} s, loss {e['loss']:.5f}, val {e['val_acc']:.4f}, "
                f"hash {e.get('param_hash')}")
    (halo_rec,) = [r for r in recs if r.get("event") == "halo"]
    log(f"  halo pack {halo_rec['pack_s']:.2f} s, placement {halo_rec['place_s']:.2f} s "
        f"(per {halo_rec['per']}, B_max {halo_rec['b_max']}); pair exchange bytes a layer "
        f"{ranks[0]['halo']['comm_pair']}")
    for r in ranks:
        log(f"  rank {r['rank']}: main wall {r['wall_s']:.1f} s, peak device memory "
            f"{r['peak_bytes'] / 2**30:.2f} GiB, SpMM launches by F {r['launches']}")
    log(f"  one process: main wall {one['wall_s']:.1f} s, peak {one['peak_bytes'] / 2**30:.2f} "
        f"GiB; the two ranks' wall {dp_wall:.1f} s (2 ranks on one card over gloo)")
    log(f"  f32 step: ranks bit-equal {step_ranks_equal}, max |DP - one process| {step_err:.3e}")
    dp, one_rows = rows["dp"], rows["one"]
    if ranks[0]["result"] != ranks[1]["result"]:
        raise RuntimeError(f"the ranks' results differ: {ranks[0]['result']} {ranks[1]['result']}")
    if len(dp["ct"]) != 1 or len(dp["base"]) != 1:
        raise RuntimeError("expected one CT and one baseline epoch on the ranks")
    losses = [dp["ct"][0]["loss_1"], dp["ct"][0]["loss_2"], dp["base"][0]["loss"]]
    if not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"non-finite DP loss: {losses}")
    vals = [max(dp["ct"][0]["val_acc_1"], dp["ct"][0]["val_acc_2"]), dp["base"][0]["val_acc"]]
    ones = [max(one_rows["ct"][0]["val_acc_1"], one_rows["ct"][0]["val_acc_2"]),
            one_rows["base"][0]["val_acc"]]
    if not min(vals) > 1 / 47:
        raise RuntimeError(f"DP validation (co-teaching, baseline) not above 1/47: {vals}")
    if not max(abs(a - b) for a, b in zip(vals, ones)) <= 0.02:
        raise RuntimeError(f"DP validation {vals} not within 0.02 of one process's {ones}")
    if not (step_ranks_equal and step_err <= 1e-4):
        raise RuntimeError(f"DP f32 step: ranks equal {step_ranks_equal}, {step_err:.3e} from "
                           "one process (1e-4)")
    if not all(e.get("param_hash") for e in dp["ct"] + dp["base"]):
        raise RuntimeError("an epoch record of the ranks lacks its param hash")
    if not all(r["launches"].get("100", r["launches"].get(100, 0)) >= 1 for r in ranks):
        raise RuntimeError(f"a rank did not build its leaf table with the SpMM: "
                           f"{[r['launches'] for r in ranks]}")
    return dict(config=CONFIG, steps=nsteps, ranks=ranks, one_wall_s=one["wall_s"],
                one_peak_bytes=one["peak_bytes"], one_launches=one["launches"], dp_wall_s=dp_wall,
                halo=halo_rec, epochs=rows, val_dp=vals, val_one=ones,
                f32_step_ranks_equal=step_ranks_equal, f32_step_err=step_err)


def run_fullgraph(out: Path) -> dict:
    """Phase 10c: config_arxiv10.yml with ``full_graph: true`` on two ranks
    sharing ``cuda:0`` over gloo, 2 epochs (one full-graph step each)."""
    root = out / "fg"
    shutil.rmtree(root, ignore_errors=True)
    cfg = load_config(FG_CONFIG)
    cfg.update(num_runs=1, max_epochs=2, reinit_retries=0, full_graph=True, do_plot=False,
               device=DP_DEVICE, out_dir=str(root / "ranks"), data_dir=str(root / "data"))
    t0 = time.perf_counter()
    ranks = _run_ranks(root, "ranks", cfg, 2, f32_step=False)
    wall = time.perf_counter() - t0
    recs = _metrics(cfg)
    ct = [r for r in recs if r.get("event") == "epoch_ct"]
    (halo_rec,) = [r for r in recs if r.get("event") == "halo"]
    for e in ct:
        log(f"  full-graph epoch {e['epoch']}: train {e['epoch_train_s']:.3f} s (one step), eval "
            f"{e['epoch_eval_s']:.3f} s, loss {e['loss_1']:.5f}/{e['loss_2']:.5f}, val "
            f"{e['val_acc_1']:.4f}/{e['val_acc_2']:.4f}, hash {e.get('param_hash')}")
    log(f"  halo pack {halo_rec['pack_s']:.2f} s (per {halo_rec['per']}, B_max "
        f"{halo_rec['b_max']}); exchange bytes a layer {ranks[0]['halo']['comm_pair']}")
    for r in ranks:
        log(f"  rank {r['rank']}: main wall {r['wall_s']:.1f} s, peak device memory "
            f"{r['peak_bytes'] / 2**30:.2f} GiB")
    log(f"  the two ranks' wall {wall:.1f} s (2 ranks on one card over gloo)")
    if [e["epoch"] for e in ct] != [0, 1]:
        raise RuntimeError(f"expected full-graph epochs [0, 1], got {[e['epoch'] for e in ct]}")
    losses = [e[k] for e in ct for k in ("loss_1", "loss_2")]
    if not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"non-finite full-graph loss: {losses}")
    best = max(ct[-1]["val_acc_1"], ct[-1]["val_acc_2"])
    if not best > 1 / 40:
        raise RuntimeError(f"full-graph validation {best} not above 1/40")
    if not all(e.get("param_hash") for e in ct):
        raise RuntimeError("a full-graph epoch record lacks its param hash")
    return dict(config=FG_CONFIG, ranks=ranks, wall_s=wall, epochs=ct, halo=halo_rec,
                best_val=best)


# ------------------------------------------------------------------ phase 11


def _small_epochs(dev, mesh) -> dict:
    """One step of each epoch loop (co-teaching, the back-corrected
    baseline, CTP, TE with the rewired contrast, H with the pseudo net, the
    CT finetune, co-teaching under ``use_bn``, the GAT baseline) at small
    widths on a random graph, from seeded params and draws, over ``mesh``
    (None: one process; with a model axis the states are sharded, phase
    12). Returns each loop's metrics and params (gathered whole) after the
    step, and every rewire's picks, as numpy by name."""
    rng = np.random.default_rng(11)
    n, f, c, b = 4000, 64, 10, 64
    edges = [rng.integers(0, n, (2, 40_000)).astype(np.int32) for _ in range(3)]
    x = torch.from_numpy(rng.standard_normal((n, f)).astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.integers(0, c, n)).to(dev)
    yhn = torch.where(torch.from_numpy(rng.random(n) < 0.3).to(dev),
                      torch.from_numpy(rng.integers(0, c, n)).to(dev), y)
    csr = [CSRGraph.from_coo(e, n, dev) for e in edges]
    data = steps.GraphData(x, y, yhn, y == yhn, csr[0])
    views = {"orig": (x, csr[0]), "edge_s": (x, csr[1]),
             "feat_s": (x[:, torch.from_numpy(rng.permutation(f)).to(dev)], csr[0]),
             "large": (x[torch.from_numpy(rng.permutation(n)).to(dev)], csr[2])}
    perm = torch.from_numpy(rng.permutation(n)).to(dev)
    seeds, noisy = perm[:b][None], perm[b:2 * b][None]
    mask = torch.ones_like(seeds, dtype=torch.bool)
    base = dict(in_size=f, hidden_size=64, out_size=c, num_layers=2, dropout=0.5)

    def states(spec, *keys):
        return [steps.state_from_params(
            nets.init_params(torch.Generator(device=dev).manual_seed(k), spec, dev),
            lambda p: torch.optim.Adam(p, lr=1e-3), mesh) for k in keys]

    def gen():
        return torch.Generator(device=dev).manual_seed(7)

    picks, out = [], {}
    real = steps.topk_rewire_tree

    def recording(*a, **kw):
        res = real(*a, **kw)
        picks.append(torch.cat([t.extra_src for t in res if t is not None]
                               + [t.extra_dst for t in res if t is not None]).cpu().numpy())
        return res

    def keep(tag, m, *ss):
        out[f"{tag}.metrics"] = torch.stack([m[k] for k in sorted(m)]).cpu().numpy()
        for i, s in enumerate(ss):
            out.update({f"{tag}.{i}.{k}": v for k, v in
                        _flat_params(params_to_jax(gather_params(mesh, s.params))).items()})

    sg = nets.NetSpec(module="sage", **base)
    s1, s2 = states(sg, 12, 13)
    keep("co", steps.ct_epoch(sg, s1, s2, data, seeds, mask, gen(), 0.3, (10, 5), mesh=mesh),
         s1, s2)
    (s,) = states(sg, 14)
    keep("base", steps.baseline_epoch(sg, s, data, seeds, mask, gen(),
                                      torch.full((c, c), 0.02, device=dev)
                                      + 0.8 * torch.eye(c, device=dev), (10, 5),
                                      compare_loss="back", mesh=mesh), s)
    steps.topk_rewire_tree = recording
    try:
        pl = nets.NetSpec(module="sagePL", nbr_nodes=n, **base)
        s1, s2 = states(pl, 1, 2)
        keep("ctp", steps.ctp_epoch(pl, s1, s2, data, seeds, mask, gen(), 0.3, (10, 5),
                                    use_cr=True, mesh=mesh), s1, s2)
        pl3 = dataclasses.replace(pl, num_layers=3)
        s1, s2 = states(pl3, 3, 4)
        keep("te", steps.te_epoch(pl3, s1, s2, data, seeds[:, :32], mask[:, :32], gen(), 0.3,
                                  (10, 5, 5), mesh=mesh, use_contrast=True,
                                  spl_rewire_rate=0.1), s1, s2)
        hs, ps = nets.NetSpec(module="sageH", **base), nets.NetSpec(module="sage", **base)
        s1, s2, sp = states(hs, 5, 6) + states(ps, 7)
        keep("h", steps.h_epoch(hs, ps, s1, s2, sp, data, seeds, mask, gen(), 0.3, (10, 5),
                                use_pseudo=True, mesh=mesh), s1, s2, sp)
    finally:
        steps.topk_rewire_tree = real
    fc = nets.NetSpec(module="sageFC", **base)
    (s,) = states(fc, 8)
    out["init.ct.proj.b"] = s.params["proj"]["b"].detach().cpu().numpy().copy()
    keep("ct", steps.contrast_epoch(fc, s, data, views, seeds, mask, noisy, mask, gen(),
                                    (10, 5), 1.0, mesh), s)
    bn = nets.NetSpec(module="sage", use_bn=True, **base)
    s1, s2 = states(bn, 9, 10)
    keep("bn", steps.ct_epoch(bn, s1, s2, data, seeds, mask, gen(), 0.3, (10, 5), mesh=mesh),
         s1, s2)
    gat = nets.NetSpec(module="gat", **base)
    (s,) = states(gat, 11)
    keep("gat", steps.baseline_epoch(gat, s, data, seeds[:, :32], mask[:, :32], gen(),
                                     torch.eye(c, device=dev), (10, 5), mesh=mesh), s)
    out.update({f"picks.{i}": p for i, p in enumerate(picks)})
    return out


def run_epochs_nccl(out: Path, dev) -> dict:
    """Phase 11a: a one-rank NCCL group on the card; one step of each
    epoch loop under the mesh bit-equal to the one-process step. Returns
    the report and the one-process outputs (phase 12a's reference)."""
    (out / "pg11a").unlink(missing_ok=True)
    multihost.initialize(init_method=f"file://{(out / 'pg11a').resolve()}", world_size=1,
                         rank=0, backend="nccl")
    try:
        t0 = time.perf_counter()
        dp = _small_epochs(dev, make_mesh())
        one = _small_epochs(dev, None)
        secs = time.perf_counter() - t0
    finally:
        torch.distributed.destroy_process_group()
    loops = sorted({k.split(".")[0] for k in one})  # and "picks", the rewires
    equal = {d: all(np.array_equal(dp[k], one[k]) for k in one if k.split(".")[0] == d)
             for d in loops}
    log(f"  [11a] one-rank NCCL group, one step of each epoch loop at small widths against the "
        f"one-process step, bit-equal (params, summed metrics; rewire picks): {equal} "
        f"({secs:.1f} s)")
    if set(dp) != set(one) or not all(equal.values()) or len([k for k in one
                                                             if k.startswith("picks")]) != 2:
        raise RuntimeError(f"an epoch loop on a one-rank NCCL group differs from one process: {equal}")
    return dict(bit_equal=equal, s=secs), one


def _te_probe_step(pipe, mesh) -> dict:
    """One f32 TE step with the rewired contrast at the pipeline's widths
    from seeded params on the first batch of its train split (``mesh``
    None: one process): its summed metrics, both nets' params and the
    rewire's picks."""
    c, dev = pipe.config, pipe.device
    spec = pipe.spec_for()
    bs = int(c["batch_size"])
    seeds = torch.from_numpy(pipe.split_idx["train"][:bs]).long().to(dev)[None]
    init = torch.Generator(device=dev).manual_seed(3)
    s1 = steps.init_state(init, spec, pipe.make_optimizer, dev)
    s2 = steps.init_state(init, spec, pipe.make_optimizer, dev)
    picks = []
    real = steps.topk_rewire_tree

    def recording(*a, **kw):
        res = real(*a, **kw)
        picks.append([torch.stack([t.extra_src, t.extra_dst]).cpu().numpy() for t in res])
        return res

    steps.topk_rewire_tree = recording
    try:
        m = steps.te_epoch(spec, s1, s2, pipe.data, seeds, torch.ones_like(seeds, dtype=torch.bool),
                           torch.Generator(device=dev).manual_seed(11), 0.3, pipe.fanouts,
                           mesh=mesh, use_contrast=True,
                           spl_cont_beta=float(c["spl_cont_beta"]),
                           spl_rewire_rate=float(c["spl_rewire_rate"]),
                           spl_noise_rate_pos=float(c["spl_noise_rate_pos"]),
                           spl_noise_rate_neg=float(c["spl_noise_rate_neg"]))
    finally:
        steps.topk_rewire_tree = real
    return dict(metrics={k: float(v) for k, v in m.items()}, picks=picks[0],
                params={f"{i}/{k}": v for i, s in enumerate((s1, s2))
                        for k, v in _flat_params(params_to_jax(s.params)).items()})


def _picks_differ(a: np.ndarray, b: np.ndarray) -> int:
    """How many of ``a``'s (src, dst) additions ``b`` lacks."""
    return len(set(map(tuple, a.T.tolist())) - set(map(tuple, b.T.tolist())))


def epochs_worker(a: dict) -> int:
    """One rank of phase 11b or 11c (``chip_smoke.py --dp-worker JSON``
    with ``epochs``): joins the gloo group and runs ``main`` on the
    config, recording each rewire's CUDA-event time and block range, each
    flat gather's bytes and time, the replica hashes and the peak memory;
    then (11b) the TE probe step under the mesh, and on rank 0 also in one
    process, to count the picks that differ."""
    multihost.initialize(init_method=f"file://{a['pg']}", world_size=a["world"],
                         rank=a["rank"], backend="gloo")
    torch.cuda.reset_peak_memory_stats()
    spmm.launch_counts.clear()
    rewires, gathers, hashes, blocks, box = [], [], [], [], []
    real_tree, real_gather, real_range = (steps.topk_rewire_tree, steps.gather_flat,
                                          rewire.block_range)
    real_hash = BasePipeline._replica_hash

    def timed_tree(*args, **kw):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        res = real_tree(*args, **kw)
        ev[1].record()
        rewires.append(ev)
        return res

    def timed_gather(mesh, t, sizes):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        res = real_gather(mesh, t, sizes)
        ev[1].record()
        gathers.append((list(t.shape), str(t.dtype)[6:], res.numel() * res.element_size(), ev))
        return res

    def counted_range(nblocks, mesh=None):
        r = real_range(nblocks, mesh)
        blocks.append((r.start, r.stop, nblocks))
        return r

    def hashed(self, *states):
        hashes.append(real_hash(self, *states))
        return hashes[-1]

    cls = getattr(pipelines, a["pipeline"])
    loop = _capture_pipeline(box, cls)
    steps.topk_rewire_tree, steps.gather_flat, rewire.block_range = (timed_tree, timed_gather,
                                                                     counted_range)
    BasePipeline._replica_hash = hashed
    try:
        t0 = time.perf_counter()
        res = port_main(a["config"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        cls.loop = loop
        steps.topk_rewire_tree, steps.gather_flat, rewire.block_range = (real_tree, real_gather,
                                                                         real_range)
        BasePipeline._replica_hash = real_hash
    rep = dict(rank=a["rank"], wall_s=wall, peak_bytes=torch.cuda.max_memory_allocated(),
               launches={int(f): int(c) for f, c in spmm.launch_counts.items()},
               result=_result_of(res), hashes=hashes,
               rewire_ms=[e[0].elapsed_time(e[1]) for e in rewires],
               blocks=[(b[1] - b[0], b[2]) for b in blocks],
               gathers=[dict(shape=s, dtype=d, bytes=nb, ms=e[0].elapsed_time(e[1]))
                        for s, d, nb, e in gathers if len(s) == 2])
    if a.get("te_probe"):  # after the records above: its rewires are its own
        pipe = box[0]
        probe = _te_probe_step(pipe, pipe.mesh)
        if a["rank"] == 0:
            one = _te_probe_step(pipe, None)
            rep["probe"] = dict(
                k2=int(one["picks"][0].shape[1]),
                pos_differ=_picks_differ(probe["picks"][0], one["picks"][0]),
                neg_differ=_picks_differ(probe["picks"][1], one["picks"][1]),
                param_err=max(float(np.abs(probe["params"][k] - one["params"][k]).max())
                              for k in one["params"]),
                metric_diff={k: probe["metrics"][k] - one["metrics"][k] for k in one["metrics"]},
                metrics=probe["metrics"])
    Path(a["out"]).write_text(json.dumps(rep, default=str))
    torch.distributed.destroy_process_group()
    return 0


def _result_of(res) -> list:
    """The best test accuracy (and std) a ``main`` run returns."""
    if isinstance(res, dict) and "contrastive" in res:
        return [float(v) for v in res["contrastive"]]
    return [float(v) for v in res]


def _epoch_ranks(out: Path, tag: str, pipeline: str, cfg: dict, te_probe: bool = False,
                   timeout: int = 900) -> list:
    return _run_ranks(out, tag, cfg, 2, f32_step=False, timeout=timeout,
                      extra=dict(epochs=True, pipeline=pipeline, te_probe=te_probe))


def _rank_summary(tag: str, ranks: list) -> dict:
    """Each rank's rewires (ms, blocks swept of the whole), its flat
    gathers of f32 rows (bytes whole, ms), peak and hashes; logged."""
    rows = []
    for r in ranks:
        rew = r["rewire_ms"]
        blocks = sorted({tuple(b) for b in r["blocks"]})
        g = r["gathers"]
        row = dict(rank=r["rank"], rewires=len(rew),
                   rewire_ms_mean=float(np.mean(rew)) if rew else None, blocks=blocks,
                   gathers=len(g), gather_bytes=max((x["bytes"] for x in g), default=0),
                   gather_ms_mean=float(np.mean([x["ms"] for x in g])) if g else None,
                   gather_shapes=sorted({(tuple(x["shape"]), x["dtype"]) for x in g}),
                   peak_bytes=r["peak_bytes"], wall_s=r["wall_s"], launches=r["launches"],
                   hashes=len(r["hashes"]))
        rows.append(row)
        log(f"  {tag} rank {r['rank']} (2 ranks sharing one card over gloo): {row['rewires']} "
            f"rewires of {row['rewire_ms_mean']} ms mean (CUDA events), row blocks swept "
            f"(of the whole) {blocks}; {row['gathers']} flat gathers of f32 rows "
            f"{row['gather_shapes']}, {row['gather_bytes'] / 1e6:.1f} MB whole, "
            f"{row['gather_ms_mean']} ms mean; peak {r['peak_bytes'] / 2**30:.2f} GiB; main "
            f"wall {r['wall_s']:.1f} s; SpMM launches by F {r['launches']}")
    if ranks[0]["hashes"] != ranks[1]["hashes"] or not ranks[0]["hashes"]:
        raise RuntimeError(f"{tag}: the ranks' param hashes differ or are missing")
    if ranks[0]["result"] != ranks[1]["result"]:
        raise RuntimeError(f"{tag}: the ranks' results differ")
    return dict(ranks=rows, hashes=ranks[0]["hashes"], result=ranks[0]["result"],
                launches_all=[{int(f): c for f, c in r["launches"].items()} for r in ranks])


def _epoch_diffs(dp: list, one: list, keys) -> dict:
    """Per key, the largest |DP - one process| over the epochs."""
    return {k: max(abs(a[k] - b[k]) for a, b in zip(dp, one)) for k in keys}


def run_dp_te(out: Path, te_rep: dict) -> dict:
    """Phase 11b: ``main`` on config_arxiv.yml at full width on two ranks
    sharing the card over gloo: phase 7's run (the same config and cut
    split), beside phase 7's one-process run."""
    root = out / "dp11b"
    shutil.rmtree(root, ignore_errors=True)
    cfg = load_config(TE_CONFIG)
    cfg.update(num_runs=1, max_epochs=2, ct_tk=0, reinit_retries=0, load_index=True,
               device=DP_DEVICE, out_dir=str(root / "ranks"), data_dir=str(root / "data"))
    cut = _cut_split(cfg, TE_STEPS)
    nsteps = -(-cut["kept"] // int(cfg["batch_size"]))
    t0 = time.perf_counter()
    ranks = _epoch_ranks(root, "ranks", "PipelineTE", cfg, te_probe=True)
    wall = time.perf_counter() - t0
    rep = _rank_summary("11b", ranks)
    epochs = [r for r in _metrics(cfg) if r.get("event") == "epoch_te"]
    one = te_rep["epochs"]
    keys = ("loss_1", "loss_2", "loss_cont_1", "loss_cont_2", "val_acc_1", "val_acc_2")
    diffs = _epoch_diffs(epochs, one, keys)
    probe = ranks[0]["probe"]
    for e in epochs:
        log(f"  11b DP TE epoch {e['epoch']}: train {e['epoch_train_s']:.3f} s "
            f"({e['epoch_train_s'] / nsteps * 1e3:.1f} ms a step), loss "
            f"{e['loss_1']:.4f}/{e['loss_2']:.4f}, contrast {e['loss_cont_1']:.4f}/"
            f"{e['loss_cont_2']:.4f}, val {e['val_acc_1']:.4f}/{e['val_acc_2']:.4f}")
    log(f"  11b against phase 7's one-process run, largest |DP - one| over the epochs: "
        f"{diffs}; the two ranks' wall {wall:.1f} s")
    log(f"  11b TE probe step (f32, seeded params, the first batch): picks differing from one "
        f"process: pos {probe['pos_differ']} / neg {probe['neg_differ']} of k2 = {probe['k2']}; "
        f"params {probe['param_err']:.3e} from one process; metric differences "
        f"{probe['metric_diff']}")
    rep.update(config=TE_CONFIG, steps=nsteps, train_cut=cut, epochs=epochs, diffs=diffs,
               probe=probe, wall_s=wall,
               plain_step_ms=epochs[0]["epoch_train_s"] / nsteps * 1e3,
               contrast_step_ms=epochs[1]["epoch_train_s"] / nsteps * 1e3)
    swept = [[tuple(b) for b in r["blocks"]] for r in ranks]
    if [e["epoch"] for e in epochs] != [0, 1]:
        raise RuntimeError(f"11b: expected TE epochs [0, 1], got {[e['epoch'] for e in epochs]}")
    if not all(math.isfinite(e[k]) for e in epochs for k in keys[:4]):
        raise RuntimeError("11b: a non-finite loss")
    if not (epochs[0]["loss_cont_1"] == 0.0 and epochs[1]["loss_cont_1"] > 0.0):
        raise RuntimeError("11b: the contrast term must be off in epoch 0 and on in epoch 1")
    n_sub = int(cfg["batch_size"]) * (1 + int(np.cumsum(np.cumprod(cfg["nbr_neighbors"]))[-1]))
    nb = -(-n_sub // 2048)  # the rewire's row blocks: 78 at full width
    want = [[(nb * (r + 1) // 2 - nb * r // 2, nb)] * nsteps for r in range(2)]
    if swept != want:  # main's contrast epoch: 39 of 78 row blocks a step on each rank
        raise RuntimeError(f"11b: each rank must sweep its half of the row blocks a step: "
                           f"{[sorted(set(b)) for b in swept]}")
    if not max(epochs[1]["val_acc_1"], epochs[1]["val_acc_2"]) > 1 / 40:
        raise RuntimeError("11b: validation not above 1/40")
    if not abs(max(epochs[1]["val_acc_1"], epochs[1]["val_acc_2"])
               - max(one[1]["val_acc_1"], one[1]["val_acc_2"])) <= 0.02:
        raise RuntimeError(f"11b: DP validation not within 0.02 of one process's: {diffs}")
    return rep


def run_dp_cut(out: Path, ct_rep: dict) -> dict:
    """Phase 11c: ``main`` on config_ctp.yml and config_h.yml (2 epochs, the
    train split cut to 16 batches) and config_contrast.yml (phase 8's run:
    2 warmup epochs, the split, 2 finetune epochs) on two ranks sharing the
    card over gloo, each beside one process: the CTP and H runs here, CT's
    phase 8's."""
    reps = {}
    for tag, config, pipeline, event, keys in (
            ("ctp", CTP_CONFIG, "PipelineCTP", "epoch_ctp",
             ("loss_1", "loss_2", "loss_cr_1", "val_acc_1", "val_acc_2")),
            ("h", H_CONFIG, "PipelineH", "epoch_h",
             ("loss_1", "loss_2", "loss_pred", "loss_add", "val_acc_1", "val_acc_2"))):
        root = out / f"dp11c_{tag}"
        shutil.rmtree(root, ignore_errors=True)
        cfg = load_config(config)
        cfg.update(num_runs=1, max_epochs=2, reinit_retries=0, load_index=True,
                   device=DP_DEVICE, data_dir=str(root / "data"))
        cut = _cut_split(cfg, 16)
        one = _drive(dict(cfg, out_dir=str(root / "one")))
        gc.collect()
        torch.cuda.empty_cache()
        dp_cfg = dict(cfg, out_dir=str(root / "ranks"))
        ranks = _epoch_ranks(root, "ranks", pipeline, dp_cfg)
        rep = reps[tag] = _rank_summary(f"11c {tag}", ranks)
        epochs, one_epochs = ([r for r in recs if r.get("event") == event]
                              for recs in (_metrics(dp_cfg), one["records"]))
        nsteps = -(-cut["kept"] // int(cfg["batch_size"]))
        rep.update(config=config, train_cut=cut, steps=nsteps, epochs=epochs,
                   one_wall_s=one["wall_s"], one_peak_bytes=one["peak_bytes"],
                   launches_all=rep["launches_all"] + [one["launches"]],
                   one_result=_result_of(one["result"]),
                   diffs=_epoch_diffs(epochs, one_epochs, keys),
                   step_ms=[e["epoch_train_s"] / nsteps * 1e3 for e in epochs],
                   one_step_ms=[e["epoch_train_s"] / nsteps * 1e3 for e in one_epochs])
        log(f"  11c {tag}: {nsteps} steps an epoch, ms a step DP {np.round(rep['step_ms'], 1)} "
            f"one process {np.round(rep['one_step_ms'], 1)}; largest |DP - one| {rep['diffs']}; "
            f"results DP {rep['result']} one {rep['one_result']}")
        if [e["epoch"] for e in epochs] != [0, 1]:
            raise RuntimeError(f"11c {tag}: expected epochs [0, 1]")
        if not all(math.isfinite(e[k]) for e in epochs for k in keys):
            raise RuntimeError(f"11c {tag}: a non-finite loss")
        if not abs(rep["result"][0] - rep["one_result"][0]) <= 0.02:
            raise RuntimeError(f"11c {tag}: DP best test not within 0.02 of one process's")
    # CT beside phase 8's one-process run, the same config
    root = out / "dp11c_ct"
    shutil.rmtree(root, ignore_errors=True)
    cfg = load_config(CT_CONFIG)
    cfg.update(num_runs=1, warmup=2, ct_tk=1, max_epochs=4, reinit_retries=0,
               device=DP_DEVICE, out_dir=str(root / "ranks"))
    ranks = _epoch_ranks(root, "ranks", "PipelineCT", cfg)
    rep = reps["ct"] = _rank_summary("11c ct", ranks)
    recs = _metrics(cfg)
    (split,) = [r for r in recs if r.get("event") == "split"]
    warm = [r for r in recs if r.get("event") == "warmup"]
    ft = [r for r in recs if r.get("event") == "finetune"]
    (views,) = [r for r in recs if r.get("event") == "views"]
    one_split = ct_rep["split"]
    rep.update(config=CT_CONFIG, split=split, one_split=one_split, warmup=warm, finetune=ft,
               views=views, one_best_test=ct_rep["best_test"],
               warmup_diffs=_epoch_diffs(warm, ct_rep["warmup_epochs"],
                                         ("loss_1", "loss_2", "val_acc_1", "val_acc_2")),
               finetune_diffs=_epoch_diffs(ft, ct_rep["finetune_epochs"],
                                           ("loss_semi", "loss_cont", "val_acc")),
               warmup_epoch_s=[e["epoch_train_s"] for e in warm],
               finetune_step_ms=[e["epoch_train_s"] / e["steps"] * 1e3 for e in ft])
    log(f"  11c ct: split DP {split['n_clean']} clean / {split['n_noisy']} noisy (clean ratio "
        f"{split['clean_ratio']:.4f}), one process {one_split['n_clean']} / "
        f"{one_split['n_noisy']} ({one_split['clean_ratio']:.4f}); views {views['build_s']:.1f} "
        f"s (hash {views.get('views_hash')}); largest |DP - one| warmup {rep['warmup_diffs']}, "
        f"finetune {rep['finetune_diffs']}; best test DP {rep['result'][0]:.4f} one "
        f"{ct_rep['best_test']:.4f}")
    if (split["n_clean"], split["n_noisy"]) != (one_split["n_clean"], one_split["n_noisy"]):
        raise RuntimeError("11c ct: the split's sizes differ from one process's")
    if [e["epoch"] for e in ft] != [2, 3] or not all(
            math.isfinite(e[k]) for e in ft for k in ("loss_semi", "loss_cont")):
        raise RuntimeError("11c ct: expected finite finetune epochs [2, 3]")
    if not abs(rep["result"][0] - ct_rep["best_test"]) <= 0.02:
        raise RuntimeError("11c ct: DP best test not within 0.02 of one process's")
    return reps


# ------------------------------------------------------------------ phase 12

TP_M = 2  # phase 12's model axis
TP_STEPS = 128  # train batches an epoch in phase 12b


def tp_worker(a: dict) -> int:
    """One rank of phase 12 (``chip_smoke.py --dp-worker JSON`` with
    ``tp``), joined to a gloo group of ranks sharing ``cuda:0``. "small":
    the small-width steps of :func:`_small_epochs` over the (world / M, M)
    mesh, written as npz. "main": ``main`` on each config of ``configs`` in
    turn, recording per run the model axis's column gathers (calls, bytes
    of the whole output, CUDA-event ms) and input-gradient all-reduces
    (calls, f32 bytes, ms), each split by the train step they fell in (one
    state: a baseline step; two: co-teaching), the SpMM counts, the peak
    memory and the wall time."""
    from noise_gnn_tpu_torch.parallel import mesh as mesh_mod

    multihost.initialize(init_method=f"file://{a['pg']}", world_size=a["world"],
                         rank=a["rank"], backend="gloo")
    if a["tp"] == "small":
        mesh = make_mesh(model_parallel=TP_M)
        t0 = time.perf_counter()
        res = _small_epochs(torch.device(DP_DEVICE), mesh)
        np.savez(Path(a["out"]).with_suffix(".npz"), **res)
        Path(a["out"]).write_text(json.dumps(dict(rank=a["rank"], data_rank=mesh.rank,
                                                  model_rank=mesh.model_rank,
                                                  s=time.perf_counter() - t0)))
        torch.distributed.destroy_process_group()
        return 0
    events = []  # (kind, bytes, [start, end])
    real_cols, real_bwd, real_step = (mesh_mod.all_gather_cols, mesh_mod._ModelInput.backward,
                                      steps._step)

    def record(kind, nbytes, fn):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        res = fn()
        ev[1].record()
        events.append((kind, nbytes, ev))
        return res

    def timed_cols(mesh, t):
        return record("gather", t.numel() * t.element_size() * mesh.model_size,
                      lambda: real_cols(mesh, t))

    def timed_bwd(ctx, *grads):
        return record("reduce", sum(g.numel() for g in grads) * 4,
                      lambda: real_bwd(ctx, *grads))

    def marked_step(states, loss, mesh=None):
        res = real_step(states, loss, mesh)
        events.append((f"step{len(states)}", 0, None))
        return res

    mesh_mod.all_gather_cols = timed_cols
    mesh_mod._ModelInput.backward = staticmethod(timed_bwd)
    steps._step = marked_step
    runs = []
    try:
        for cfg in a["configs"]:
            events.clear()
            spmm.launch_counts.clear()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = port_main(cfg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            by = {}  # (kind, step kind) -> [calls, bytes, ms]
            pending = []
            for kind, nbytes, ev in events:
                if ev is None:  # a step ended: its collectives are its own
                    for k, b, e in pending:
                        row = by.setdefault(f"{k}/{kind}", [0, 0, 0.0])
                        row[0] += 1
                        row[1] += b
                        row[2] += e[0].elapsed_time(e[1])
                    pending = []
                else:
                    pending.append((kind, nbytes, ev))
            nsteps = {k: sum(1 for e in events if e[0] == k) for k in ("step1", "step2")}
            runs.append(dict(wall_s=wall, peak_bytes=torch.cuda.max_memory_allocated(),
                             launches={int(f): int(c) for f, c in spmm.launch_counts.items()},
                             result={k: list(v) for k, v in res.items()}
                             if isinstance(res, dict) else None,
                             collectives=by, steps=nsteps))
    finally:
        mesh_mod.all_gather_cols, steps._step = real_cols, real_step
        mesh_mod._ModelInput.backward = staticmethod(real_bwd)
    Path(a["out"]).write_text(json.dumps(dict(rank=a["rank"], runs=runs), default=str))
    torch.distributed.destroy_process_group()
    return 0


def _tp_ranks(out: Path, tag: str, world: int, mode: str, configs=None):
    return _start_ranks(out, tag, None, world, f32_step=False,
                        extra=dict(tp=mode, configs=configs))


def start_tp_small(out: Path) -> dict:
    """Start phase 12a's ranks: two at (D, M) = (1, 2) and four at (2, 2),
    all sharing the card over gloo at once; :func:`finish_tp_small`
    checks them."""
    root = out / "tp12a"
    shutil.rmtree(root, ignore_errors=True)
    return {(d, TP_M): _tp_ranks(root, f"d{d}m{TP_M}", d * TP_M, "small") for d in (1, 2)}


def finish_tp_small(started: dict, one: dict) -> dict:
    """Phase 12a: the small-width steps of :func:`_small_epochs` on the
    ranks :func:`start_tp_small` started, against the one-process steps of
    phase 11a: summed metrics within 1e-5 relative (atol 1e-6), params
    (gathered whole) within 1e-4, equal on every rank; the CT projection
    bias, which feeds a batch norm, within lr of its start; the rewires'
    picks equal."""
    reps = {}
    for (d, m), st in started.items():
        ranks = _wait_ranks(f"12a ({d}, {m})", st)
        outs = [dict(np.load(st[0] / f"rank{r}.npz")) for r in range(d * m)]
        if set(outs[0]) != set(one):
            raise RuntimeError(f"12a ({d}, {m}): other outputs than one process's")
        rank_equal = all(_rank_rows_equal(outs[0], o) for o in outs[1:])
        loops = sorted({k.split(".")[0] for k in one} - {"picks", "init"})
        errs = {}
        for loop in loops:
            keys = [k for k in one if k.split(".")[0] == loop and not k.endswith(".metrics")]
            want = one[f"{loop}.metrics"]
            met = max(float(np.max(np.abs(o[f"{loop}.metrics"] - want)
                                   / (1e-6 + 1e-5 * np.abs(want)))) for o in outs)
            par = max(float(np.abs(o[k] - one[k]).max()) for o in outs for k in keys
                      if k != "ct.0.proj.b")
            errs[loop] = dict(metrics_over_tol=met, params=par)
        bias = max(float(np.abs(o["ct.0.proj.b"] - one["init.ct.proj.b"]).max()) for o in outs)
        picks_equal = all(np.array_equal(o[k], one[k]) for o in outs for k in one
                          if k.startswith("picks"))
        reps[f"d{d}m{m}"] = dict(errors=errs, ranks_equal=rank_equal, picks_equal=picks_equal,
                                 ct_proj_b_from_init=bias,
                                 grid=sorted((r["data_rank"], r["model_rank"]) for r in ranks),
                                 rank_s=[r["s"] for r in ranks])
        shown = {k: (f"{v['metrics_over_tol']:.3f}", f"{v['params']:.2e}") for k, v in errs.items()}
        log(f"  12a ({d}, {m}) on {d * m} ranks sharing the card over gloo: by loop, the summed "
            f"metrics' largest |TP - one| over (1e-6 + 1e-5 |one|) and the params' largest "
            f"|TP - one| {shown}; ranks equal {rank_equal}, picks equal {picks_equal}, CT proj "
            f"bias {bias:.2e} from its start")
        bad = [k for k, v in errs.items()
               if not (v["metrics_over_tol"] <= 1.0 and v["params"] <= 1e-4)]
        if bad or not rank_equal or not picks_equal or not bias <= 1e-3 * 1.001:
            raise RuntimeError(f"12a ({d}, {m}): steps out of tolerance {bad}, ranks equal "
                               f"{rank_equal}, picks equal {picks_equal}, bias {bias}")
    return reps


def _link_products_cache(data_dir: Path) -> None:
    """Point ``data_dir``'s synthetic products cache at the default one
    (phase 3 generated it there), so that a run with its own split cache
    loads the graph instead of generating it again."""
    cfg = load_config(CONFIG)
    name = f"{cfg['dataset_name']}_seed{int(cfg['seed'])}_scale1_v3.npz"
    src = (Path(cfg["data_dir"]) / "synthetic" / name).resolve()
    dst = data_dir / "synthetic" / name
    if src.exists() and not dst.exists():
        dst.parent.mkdir(parents=True, exist_ok=True)
        dst.symlink_to(src)


def _tp_collectives(run: dict, nsteps: int) -> dict:
    """Per train step of each branch: the model axis's column gathers and
    input-gradient all-reduces (calls, bytes, ms)."""
    out = {}
    for key, (calls, nbytes, ms) in run["collectives"].items():
        kind, step = key.split("/")
        branch = {"step2": "ct", "step1": "baseline"}[step]
        out[f"{branch} {kind}"] = dict(calls=calls / nsteps, bytes=nbytes / nsteps,
                                       ms=ms / nsteps)
    return out


def run_tp_products(out: Path) -> dict:
    """Phase 12b: ``main`` on config_products.yml at full width on two
    ranks at (1, 2) sharing the card over gloo, one CT and one baseline
    epoch of ``TP_STEPS`` batches (the train split cut through the split
    cache), beside the same run in this process."""
    root = out / "tp12b"
    shutil.rmtree(root, ignore_errors=True)
    cfg = load_config(CONFIG)
    cfg.update(num_runs=1, max_epochs=1, reinit_retries=0, load_index=True,
               device=DP_DEVICE, data_dir=str((root / "data").resolve()))
    _link_products_cache(root / "data")
    cut = _cut_split(cfg, TP_STEPS)
    nsteps = -(-cut["kept"] // int(cfg["batch_size"]))
    one = _drive(dict(cfg, out_dir=str(root / "one")))
    gc.collect()
    torch.cuda.empty_cache()
    tp_cfg = dict(cfg, model_parallel=TP_M, out_dir=str(root / "ranks"))
    t0 = time.perf_counter()
    ranks = _wait_ranks("12b", _tp_ranks(root, "ranks", TP_M, "main", [tp_cfg]), timeout=900)
    wall = time.perf_counter() - t0
    runs = [r["runs"][0] for r in ranks]
    recs, one_recs = _metrics(tp_cfg), one["records"]
    rows = {}
    for tag, rs in (("tp", recs), ("one", one_recs)):
        ct = [r for r in rs if r.get("event") == "epoch_ct"]
        base = [r for r in rs if r.get("event") == "epoch_baseline"]
        rows[tag] = dict(ct=ct, base=base,
                         ct_step_ms=[e["epoch_train_s"] / nsteps * 1e3 for e in ct],
                         base_step_ms=[e["epoch_train_s"] / nsteps * 1e3 for e in base])
    coll = [_tp_collectives(r, nsteps) for r in runs]
    tp, solo = rows["tp"], rows["one"]
    for tag in ("tp", "one"):
        r = rows[tag]
        log(f"  12b {tag}: {nsteps} steps an epoch; ms a step CT {np.round(r['ct_step_ms'], 2)} "
            f"baseline {np.round(r['base_step_ms'], 2)}; CT loss "
            f"{r['ct'][0]['loss_1']:.6f}/{r['ct'][0]['loss_2']:.6f}, val "
            f"{r['ct'][0]['val_acc_1']:.4f}/{r['ct'][0]['val_acc_2']:.4f}; baseline loss "
            f"{r['base'][0]['loss']:.6f} val {r['base'][0]['val_acc']:.4f}")
    for r, run, c in zip(ranks, runs, coll):
        shown = {k: (round(v["calls"], 2), int(v["bytes"]), round(v["ms"], 2))
                 for k, v in c.items()}
        log(f"  12b rank {r['rank']} (2 ranks sharing one card over gloo): main wall "
            f"{run['wall_s']:.1f} s, peak {run['peak_bytes'] / 2**30:.2f} GiB, SpMM launches by "
            f"F {run['launches']}; a step's model-axis collectives {shown} (calls, bytes "
            f"whole, ms)")
    log(f"  12b one process: main wall {one['wall_s']:.1f} s, peak "
        f"{one['peak_bytes'] / 2**30:.2f} GiB, SpMM launches by F {one['launches']}; the two "
        f"ranks' wall {wall:.1f} s")
    if len(tp["ct"]) != 1 or len(tp["base"]) != 1:
        raise RuntimeError("12b: expected one CT and one baseline epoch on the ranks")
    losses = [tp["ct"][0]["loss_1"], tp["ct"][0]["loss_2"], tp["base"][0]["loss"]]
    if not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"12b: non-finite TP loss: {losses}")
    if runs[0]["result"] != runs[1]["result"]:
        raise RuntimeError(f"12b: the ranks' results differ: {runs[0]['result']} "
                           f"{runs[1]['result']}")
    if not all(e.get("param_hash") for e in tp["ct"] + tp["base"]):
        raise RuntimeError("12b: an epoch record of the ranks lacks its param hash")
    vals = [max(tp["ct"][0]["val_acc_1"], tp["ct"][0]["val_acc_2"]), tp["base"][0]["val_acc"]]
    ones = [max(solo["ct"][0]["val_acc_1"], solo["ct"][0]["val_acc_2"]),
            solo["base"][0]["val_acc"]]
    if not max(abs(a - b) for a, b in zip(vals, ones)) <= 0.02:
        raise RuntimeError(f"12b: TP validation {vals} not within 0.02 of one process's {ones}")
    if not all(run["launches"].get(100, run["launches"].get("100", 0)) >= 1 for run in runs):
        raise RuntimeError(f"12b: a rank did not build its leaf table with the SpMM: "
                           f"{[run['launches'] for run in runs]}")
    if not all(c.get("ct gather", {}).get("calls") for c in coll):
        raise RuntimeError("12b: no model-axis gather in the co-teaching steps")
    return dict(config=CONFIG, m=TP_M, steps=nsteps, train_cut=cut, epochs=rows,
                ranks=[dict(rank=r["rank"], **{k: v for k, v in run.items() if k != "result"})
                       for r, run in zip(ranks, runs)],
                collectives=coll, one_wall_s=one["wall_s"], one_peak_bytes=one["peak_bytes"],
                one_launches=one["launches"], wall_s=wall, val_tp=vals, val_one=ones,
                launches_all=[run["launches"] for run in runs] + [one["launches"]])


def run_tp_cora(out: Path) -> dict:
    """Phase 12c: ``main`` on config_cora.yml (sage 2 x 512) at (1, 2),
    co-teaching for 2 epochs; then killed after epoch 0 and resumed; then
    the checkpoint loaded in this process with ``do_train: false``."""
    root = out / "tp12c"
    shutil.rmtree(root, ignore_errors=True)
    ckpt = str((root / "ckpt" / "ct").resolve())
    cfg = load_config(CORA_CONFIG)
    cfg.update(num_runs=1, max_epochs=2, reinit_retries=0, train_type="nalgo",
               device=DP_DEVICE, model_parallel=TP_M)
    full = dict(cfg, out_dir=str(root / "full"))
    killed = dict(cfg, out_dir=str(root / "killed"), max_epochs=1, ckpt_every=1,
                  ckpt_path=ckpt)
    resumed = dict(killed, out_dir=str(root / "resumed"), max_epochs=2, resume=True)
    ranks = _wait_ranks("12c", _tp_ranks(root, "ranks", TP_M, "main",
                                         [full, killed, resumed]))
    want = [e for e in _metrics(full) if e.get("event") == "epoch_ct"]
    got = [e for e in _metrics(resumed) if e.get("event") == "epoch_ct"]
    loaded = _drive(dict(cfg, out_dir=str(root / "loaded"), model_parallel=1, do_train=False,
                         ckpt_path=ckpt))
    acc1, acc2 = loaded["result"]["loaded"]
    keys = ("loss_1", "loss_2", "pure_ratio_1", "pure_ratio_2", "param_hash")
    equal = {k: len(got) == 1 and len(want) == 2 and got[0][k] == want[1][k] for k in keys}
    load_err = max(abs(acc1["valid"] - got[0]["val_acc_1"]),
                   abs(acc2["valid"] - got[0]["val_acc_2"]))
    for e in want:
        log(f"  12c full epoch {e['epoch']}: train {e['epoch_train_s']:.3f} s, loss "
            f"{e['loss_1']:.6f}/{e['loss_2']:.6f}, val {e['val_acc_1']:.4f}/"
            f"{e['val_acc_2']:.4f}, hash {e['param_hash']}")
    log(f"  12c resumed epoch 1 against the uninterrupted TP run, bit-equal by key: {equal}; "
        f"loaded in one process: validation {acc1['valid']:.4f}/{acc2['valid']:.4f} against "
        f"{got[0]['val_acc_1']:.4f}/{got[0]['val_acc_2']:.4f}; each rank's peak "
        f"{[round(r['runs'][0]['peak_bytes'] / 2**30, 2) for r in ranks]} GiB")
    if not all(equal.values()):
        raise RuntimeError(f"12c: the resumed TP epoch differs from the uninterrupted one: {equal}")
    if not all(math.isfinite(e[k]) for e in want for k in ("loss_1", "loss_2")):
        raise RuntimeError("12c: a non-finite loss")
    if not load_err <= 1e-3:
        raise RuntimeError(f"12c: the loaded nets' accuracies differ from the run's by {load_err}")
    return dict(config=CORA_CONFIG, m=TP_M, epochs=want, resumed=got, equal=equal,
                loaded=dict(acc1=acc1, acc2=acc2), load_acc_diff=load_err,
                ranks=[[{k: v for k, v in run.items() if k != "result"} for run in r["runs"]]
                       for r in ranks],
                launches_all=[run["launches"] for r in ranks for run in r["runs"]]
                + [loaded["launches"]])


# ----------------------------------------------------------------- timing


# ------------------------------------------------------------------ phase 13

TOOL_STEPS = 10  # steps a run of bench_trainstep and profile_step in phase 13


def _tool_line(name: str, res: dict) -> None:
    log(f"  [13] {name} {json.dumps(res)}")


def check_bench_shape(dev, res: dict) -> list[dict]:
    """The kernel against its plain version on ``bench_spmm``'s graph at its
    F and the dual 2F (bf16 in and out, mean), with phase 2's tolerance;
    two calls bit-equal."""
    n, e, f = res["nodes"], res["edges"], res["feat"]
    indptr_np, src_np, _ = bench_spmm.make_graph(n, e)
    indptr, src = torch.from_numpy(indptr_np).to(dev), torch.from_numpy(src_np).to(dev)
    op = spmm.Spmm(indptr, src)
    rtol = sum_rtol(indptr)
    cases = []
    for width, seed in ((f, 0), (2 * f, 1)):
        x = bench_spmm.features(n, width, torch.bfloat16, dev, seed)
        got = op(x)
        case = dict(graph=f"bench_spmm (N={n}, E={e})", F=width, x="bfloat16", out="bfloat16",
                    mean=True)
        case.update(compare(got, spmm.spmm_reference(indptr, src, x, True, torch.float32),
                            spmm.spmm_reference(indptr, src, x.abs(), True, torch.float32),
                            rtol))
        case.update(repeat_equal=bool(torch.equal(got, op(x))))
        case["ok"] = case["ok"] and case["repeat_equal"]
        log_case(case)
        cases.append(case)
        del x, got
    del op, indptr, src
    torch.cuda.empty_cache()
    return cases


def run_tools(out: Path, dev) -> dict:
    """Phase 13: the port's measuring tools on the card (see the module
    doc). Each tool's JSON line is logged; any failure raises."""
    rep = {}
    t = time.perf_counter()
    rep["bench_spmm"] = bench_spmm.run(iters=3)
    _tool_line("bench_spmm", rep["bench_spmm"])
    rep["bench_spmm_checks"] = check_bench_shape(dev, rep["bench_spmm"])
    if not all(c["ok"] for c in rep["bench_spmm_checks"]):
        raise RuntimeError(f"kernel out of tolerance at bench_spmm's shape: "
                           f"{rep['bench_spmm_checks']}")
    rep["seconds"] = {"bench_spmm": time.perf_counter() - t}

    t = time.perf_counter()
    rep["bench_trainstep"] = bench_trainstep.run(steps=TOOL_STEPS, reps=2)
    _tool_line("bench_trainstep", rep["bench_trainstep"])
    rep["seconds"]["bench_trainstep"] = time.perf_counter() - t
    t = time.perf_counter()
    rep["profile_step"] = profile_step.run(steps=TOOL_STEPS, reps=2)
    _tool_line("profile_step", rep["profile_step"])
    rep["seconds"]["profile_step"] = time.perf_counter() - t
    torch.cuda.empty_cache()

    t = time.perf_counter()
    rep["bench_scaling"] = bench_scaling.run(world=(1, 2))
    _tool_line("bench_scaling", rep["bench_scaling"])
    rep["seconds"]["bench_scaling"] = time.perf_counter() - t
    if rep["bench_scaling"]["scaling_number"]:
        raise RuntimeError("two ranks sharing one card were reported as a scaling number")

    t = time.perf_counter()
    label, base, ov = evidence.MATRIX[0]
    ov = dict(ov, num_runs=1, max_epochs=3, out_dir=str((out / "evidence").resolve()))
    proc = subprocess.run(
        [sys.executable, "-m", "noise_gnn_tpu_torch.tools.evidence", "--one",
         json.dumps({"base": base, "ov": ov})], capture_output=True, text=True, timeout=600,
        cwd=str(Path(__file__).resolve().parent))
    if proc.returncode != 0:
        raise RuntimeError(f"evidence --one exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    row = json.loads(proc.stdout.strip().splitlines()[-1])
    rep["evidence_one"] = {k: v for k, v in row.items() if not k.startswith("_")}
    _tool_line(f"evidence --one ({label}, 1 run, 3 epochs)", rep["evidence_one"])
    rep["seconds"]["evidence_one"] = time.perf_counter() - t
    accs = [row[b]["mean"] for b in ("nalgo", "baseline")]
    if not (all(math.isfinite(a) for a in accs) and "_curves" in row):
        raise RuntimeError(f"evidence --one: accuracies {accs}, keys {sorted(row)}")

    for k in ("bench_spmm", "bench_trainstep", "profile_step", "bench_scaling"):
        if "card" not in rep[k] or "power_limit" not in rep[k]:
            raise RuntimeError(f"{k}'s line names no card")
    log("  [13] seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in rep["seconds"].items()))
    return rep


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

    log("[10] slice 6: data parallelism, the halo exchange, full-graph training")
    t10 = time.perf_counter()
    dp_nccl = run_dp_nccl(out, dev)
    t10a = time.perf_counter()
    log(f"  [10a] {t10a - t10:.1f} s")
    log("  [10b] products, full width, 2 ranks sharing the card over gloo")
    dp_rep = run_dp_shared(out)
    t10b = time.perf_counter()
    log(f"  [10b] {t10b - t10a:.1f} s")
    log("  [10c] arxiv full-graph training, 2 ranks sharing the card over gloo")
    fg_rep = run_fullgraph(out)
    log(f"  [10c] {time.perf_counter() - t10b:.1f} s; phase 10 {time.perf_counter() - t10:.1f} s")

    log("[11] slice 7: data parallelism in the CTP, TE, H and CT epochs, use_bn and GAT")
    t11 = time.perf_counter()
    epochs_nccl, one_small = run_epochs_nccl(out, dev)
    t11a = time.perf_counter()
    log(f"  [11a] {t11a - t11:.1f} s")
    log("  [11b] arxiv TE, full width, 2 ranks sharing the card over gloo")
    dp_te = run_dp_te(out, te_rep)
    t11b = time.perf_counter()
    log(f"  [11b] {t11b - t11a:.1f} s")
    log("  [11c] arxiv CTP, H and CT, 2 ranks sharing the card over gloo")
    dp_cut = run_dp_cut(out, ct_rep)
    log(f"  [11c] {time.perf_counter() - t11b:.1f} s; phase 11 {time.perf_counter() - t11:.1f} s")

    log("[12] slice 8: tensor parallelism, ranks sharing the card over gloo")
    t12 = time.perf_counter()
    # 12a's six ranks run beside 12c (whose checks are bits, not times),
    # and both before 12b, which is timed
    log(f"  [12a] small-width steps at (D, M) = (1, {TP_M}) and (2, {TP_M}), started")
    small_ranks = start_tp_small(out)
    log(f"  [12c] cora, (1, {TP_M}), killed and resumed, loaded in one process")
    tp_cora = run_tp_cora(out)
    t12c = time.perf_counter()
    log(f"  [12c] {t12c - t12:.1f} s")
    tp_small = finish_tp_small(small_ranks, one_small)
    t12a = time.perf_counter()
    log(f"  [12a] {t12a - t12:.1f} s from its start")
    log(f"  [12b] products, full width, (1, {TP_M}), {TP_STEPS} steps an epoch")
    tp_prod = run_tp_products(out)
    log(f"  [12b] {time.perf_counter() - t12a:.1f} s; phase 12 {time.perf_counter() - t12:.1f} s")

    log("[13] the measuring tools: bench_spmm, bench_trainstep, profile_step, bench_scaling, "
        "evidence --one")
    t13 = time.perf_counter()
    tools_rep = run_tools(out, dev)
    log(f"  [13] phase 13 {time.perf_counter() - t13:.1f} s")

    kernels = []
    for row in rows:
        by_path = {"co": main_rep["launches"].get(row["F"], 0),
                   "bn": bn_rep["launches"].get(row["F"], 0),
                   "dp": sum(r["launches"].get(str(row["F"]), 0) for r in dp_rep["ranks"]),
                   "tp": sum(c.get(row["F"], c.get(str(row["F"]), 0))
                             for c in tp_prod["launches_all"])}
        k = spmm_row(row, sum(by_path.values()))
        k.update({f"launches_{p}": c for p, c in by_path.items()})
        kernels.append(k)
    arxiv_runs = {"ctp": list(ctp_rep["runs"].values()), "te": [te_rep],
                  "h": list(h_rep["runs"].values()), "ct": list(ct_rep["runs"].values()),
                  "dp11": [dict(launches=c) for r in [dp_te, *dp_cut.values()]
                           for c in r["launches_all"]]}
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
    for row in cora_rows:
        by_path = {"gat": gat_rep["launches"].get(row["F"], 0),
                   "tp": sum(c.get(row["F"], c.get(str(row["F"]), 0))
                             for c in tp_cora["launches_all"])}
        k = spmm_row(row, sum(by_path.values()))
        k.update({f"launches_{p}": c for p, c in by_path.items()})
        kernels.append(k)
    report = dict(nvidia_smi=smi, device=kind, count=count, build_s=build_s,
                  checks=cases, gather_checks=gather_cases, small_path=small,
                  small_ctp=small_ctp, small_rewire=small_rewire, small_te=small_te,
                  small_h=small_h, small_ct=small_ct, main_path=main_rep, ctp_path=ctp_rep,
                  gather_path=gather_rep, timing=rows, ctp_timing=ctp_rows, te_path=te_rep,
                  h_path=h_rep, ct_path=ct_rep, native=native_rep, small_bn=small_bn,
                  bn_path=bn_rep, small_gat=small_gat, gat_path=gat_rep, cora_timing=cora_rows,
                  profile=profile_rep, dp_nccl=dp_nccl, dp_shared=dp_rep, fullgraph=fg_rep,
                  epochs_nccl=epochs_nccl, dp_te=dp_te, dp_cut=dp_cut,
                  tp_small=tp_small, tp_products=tp_prod, tp_cora=tp_cora,
                  tools=tools_rep, kernels=kernels,
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
    parser.add_argument("--dp-worker", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.dp_worker is not None:  # one rank of phase 10, 11 or 12, started by run()
        sys.exit(dp_worker(args.dp_worker))
    sys.exit(run(Path(args.out)))
