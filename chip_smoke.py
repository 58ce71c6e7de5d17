#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``noise_gnn_tpu_torch``) on one card.

    python3 chip_smoke.py [--out DIR]

Phases (any failure exits nonzero; the last stdout line is printed only
when every phase passed):

1. Device: ``nvidia-smi`` name and power limit, the torch device; build the
   CUDA SpMM from ``noise_gnn_tpu_torch/csrc/spmm.cu`` with ``nvcc`` and
   report the build time.
2. Kernel against its plain version on the card: mean and sum, f32 and bf16
   input and output, F in {100, 256, 512}, on a graph with isolated rows
   (N not a multiple of any block size) and a power-law graph with hubs of
   in-degree 1e5..2.5e5.
   Tolerance: |kernel - plain| <= max(1e-5, 4 sqrt(deg) 2^-24) * agg(|x|)
   per element (fp32 sums in another order: ~1e-5 relative to the
   summands' magnitude, widened by the probabilistic sqrt(deg) rounding
   bound for hub rows), plus one bf16 ulp of the output for bf16 outputs.
   Then the main path's functions on a small input, on the card against
   the CPU (which the CPU tests hold against the JAX package): one
   co-teaching epoch of 4 steps at the products widths (f32, dropout 0,
   deterministic trees, the same initial params) and the pair eval; summed
   losses within 1e-5 relative, params within 1e-4, logits within 1e-4.
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
4. The three main-path shapes on the full graph (F = 100, 256 and 512,
   mean, bf16 in and out): the kernel held against its plain version with
   the tolerance of phase 2, then timed with CUDA events after warm-up
   beside its plain version and one library call for the same function
   (``torch.sparse`` CSR @ dense, bf16) as a yardstick, and beside the
   bound: max(bytes / 3.35 TB/s, adds / 67 TFLOP/s), counting x, indices
   and indptr read once and out written once.

Then it prints one ``{"kernels": [...]}`` line (errors from phase 4's
full-size checks, launches from phase 3), the ``nvidia-smi`` line and,
last, ``{"ok": true, "device": {...}}``. Details go to ``<out>/report.json``.
"""

from __future__ import annotations

import argparse
import json
import math
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
from noise_gnn_tpu_torch.ops import spmm
from noise_gnn_tpu_torch.ops.leaf_agg import fused_leaf_table
from noise_gnn_tpu_torch.train import steps
from noise_gnn_tpu_torch.utils.config import load_config

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores, published
CONFIG = "configs/config_products.yml"
SOURCE = "noise_gnn_tpu_torch/csrc/spmm.cu"
REPLACES = "noise_gnn_tpu/ops/pallas_spmm.py:147"
# the main path's SpMM shapes: (name, F, launches expected per run)
SHAPES = (("leaf table", 100, 1), ("eval pair", 512, 4), ("eval single", 256, 4))


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
        "max err/agg|x| {max_err_rel_to_magnitude:.3e}, err/tol {max_err_over_tol:.3f} "
        "{v}".format(m="mean" if case["mean"] else "sum", v="ok" if case["ok"] else "FAIL",
                     **case))


def check_kernel(dev) -> list[dict]:
    rng = np.random.default_rng(0)
    cases = []
    for gname, make in (("isolated rows", isolated_graph), ("power-law hubs", hub_graph)):
        n, src, dst = make(rng)
        indptr, indices = coo_to_csr(src.astype(np.int32), dst.astype(np.int32), n)
        csr = CSRGraph(torch.from_numpy(indptr).to(dev), torch.from_numpy(indices).to(dev), n)
        op = spmm.Spmm.from_csr(csr)
        rtol = sum_rtol(csr.indptr)
        deg = csr.indptr[1:] - csr.indptr[:-1]
        log(f"  graph '{gname}': N={n} E={indices.shape[0]} max in-degree "
            f"{int(deg.max())} isolated rows {int((deg == 0).sum())}")
        gen = torch.Generator(device=dev).manual_seed(1)
        for f in (100, 256, 512):
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


# ------------------------------------------------------------ main path


def run_main_path(out: Path) -> dict:
    cfg = load_config(CONFIG)
    cfg.update(num_runs=1, max_epochs=2, reinit_retries=0, out_dir=str(out / "run"))
    spmm.launch_counts.clear()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = port_main(cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {int(f): int(c) for f, c in spmm.launch_counts.items()}
    peak = torch.cuda.max_memory_allocated()

    metrics = Path(cfg["out_dir"]) / "metrics" / f"{cfg['_output_name']}.jsonl"
    recs = [json.loads(line) for line in metrics.read_text().splitlines()]
    ct = [r for r in recs if r.get("event") == "epoch_ct"]
    base = [r for r in recs if r.get("event") == "epoch_baseline"]
    for r in ct:
        log(f"  CT epoch {r['epoch']}: train {r['epoch_train_s']:.3f} s, eval "
            f"{r['epoch_eval_s']:.3f} s, loss {r['loss_1']:.4f}/{r['loss_2']:.4f}, "
            f"pure {r['pure_ratio_1']:.3f}/{r['pure_ratio_2']:.3f}, val "
            f"{r['val_acc_1']:.4f}/{r['val_acc_2']:.4f}, test "
            f"{r['test_acc_1']:.4f}/{r['test_acc_2']:.4f}")
    for r in base:
        log(f"  baseline epoch {r['epoch']}: train {r['epoch_train_s']:.3f} s, eval "
            f"{r['epoch_eval_s']:.3f} s, loss {r['loss']:.4f}, val {r['val_acc']:.4f}, "
            f"test {r['test_acc']:.4f}")
    log(f"  main(config) wall {wall:.1f} s, peak device memory "
        f"{peak / 2**30:.2f} GiB, SpMM launches by F {counts}")
    log(f"  results: nalgo {tuple(res['nalgo'])} baseline {tuple(res['baseline'])}")

    if len(ct) != 2 or len(base) != 2:
        raise RuntimeError(f"expected 2 CT and 2 baseline epochs, got {len(ct)}, {len(base)}")
    losses = [r[k] for r in ct for k in ("loss_1", "loss_2")] + [r["loss"] for r in base]
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
    return dict(config=CONFIG, wall_s=wall, peak_bytes=peak, launches=counts,
                ct_epochs=ct, baseline_epochs=base,
                nalgo=list(res["nalgo"]), baseline=list(res["baseline"]))


# ----------------------------------------------------------------- timing


def time_ms(fn, reps: int, warm: int = 2) -> float:
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


def time_shapes(dev) -> list[dict]:
    """Check and time the kernel at the main path's own shapes on the full
    graph: its output (mean, bf16 in and out, as the main path calls it) is
    held against the plain version with the tolerance of ``compare``."""
    cfg = load_config(CONFIG)
    g = load_network(cfg)
    csr = g.csr(dev)
    n, e = g.num_nodes, int(csr.indices.shape[0])
    op = spmm.Spmm.from_csr(csr)
    rtol = sum_rtol(csr.indptr)
    deg = (csr.indptr[1:] - csr.indptr[:-1])
    vals = (1.0 / deg.clamp(min=1).float()).repeat_interleave(deg).to(torch.bfloat16)
    lib_a = torch.sparse_csr_tensor(csr.indptr.to(torch.int32), csr.indices, vals, (n, n))
    gen = torch.Generator(device=dev).manual_seed(2)
    rows = []
    for name, f, _ in SHAPES:
        if f == 100:
            x = torch.from_numpy(g.x).to(dev).to(torch.bfloat16)  # the real leaf input
        else:
            x = torch.randn((n, f), generator=gen, device=dev).to(torch.bfloat16)
        k_ms = time_ms(lambda: op(x, mean=True, out_dtype=torch.bfloat16), reps=10)
        p_ms = time_ms(lambda: spmm.spmm_reference(csr.indptr, csr.indices, x, True,
                                                   torch.bfloat16), reps=2, warm=1)
        l_ms = time_ms(lambda: lib_a @ x, reps=10)
        case = dict(graph="products (full)", F=f, x="bfloat16", out="bfloat16", mean=True)
        case.update(compare(
            op(x, mean=True, out_dtype=torch.bfloat16),
            spmm.spmm_reference(csr.indptr, csr.indices, x, True, torch.float32),
            spmm.spmm_reference(csr.indptr, csr.indices, x.abs(), True, torch.float32),
            rtol))
        log_case(case)
        nbytes = n * f * 2 + e * 4 + (n + 1) * 8 + n * f * 2
        nops = e * f + n * f
        b_ms, o_ms = nbytes / HBM_BYTES_PER_S * 1e3, nops / FP32_OPS_PER_S * 1e3
        row = dict(shape=name, F=f, N=n, E=e, dtype="bfloat16", ms=k_ms, plain_ms=p_ms,
                   library_ms=l_ms, library="torch.sparse CSR @ dense (bf16)",
                   bound_ms=max(b_ms, o_ms), bound_by="bytes" if b_ms >= o_ms else "operations",
                   bytes=nbytes, ops=nops, check=case)
        rows.append(row)
        log(f"  {name} F={f} bf16: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, library "
            f"{l_ms:.3f} ms, bound {row['bound_ms']:.3f} ms ({row['bound_by']}, "
            f"{nbytes / 1e9:.3f} GB)")
        del x
        torch.cuda.empty_cache()
        if not case["ok"]:
            raise RuntimeError(f"kernel out of tolerance at the main-path shape: {case}")
    return rows


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
    lib = spmm.build()
    build_s = time.perf_counter() - t0
    log(f"    built {lib.name} from {SOURCE} in {build_s:.1f} s")

    log("[2] kernel against its plain version")
    cases = check_kernel(dev)
    bad = [c for c in cases if not c["ok"]]
    if bad:
        raise RuntimeError(f"{len(bad)} of {len(cases)} kernel checks out of tolerance: {bad[:3]}")
    log(f"    all {len(cases)} cases within tolerance")
    small = check_small_path(dev)

    log("[3] main path: products, full width")
    main_rep = run_main_path(out)

    log("[4] check and timing at the main-path shapes, full graph")
    rows = time_shapes(dev)

    kernels = []
    for row, (name, f, _) in zip(rows, SHAPES):
        kernels.append(dict(
            name=f"spmm_csr ({name}, F={f} bf16)", route="cuda", source=SOURCE,
            replaces=REPLACES, launches=main_rep["launches"].get(f, 0),
            max_abs_err=row["check"]["max_abs_err"],
            max_err_over_tol=row["check"]["max_err_over_tol"],
            ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"]))
    report = dict(nvidia_smi=smi, device=kind, count=count, build_s=build_s,
                  checks=cases, small_path=small, main_path=main_rep, timing=rows,
                  kernels=kernels)
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
