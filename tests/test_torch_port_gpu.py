"""Tests of the port that need a CUDA card: the CUDA SpMM and the
gather-ring kernel against their plain versions, the main path on a small
graph, the rewire's top-k and the sorted segment sum against the CPU, and
``tools/bench_spmm.py``'s legs at a small shape.
They skip where no card is visible. This file imports neither JAX nor the JAX package, so on a card
without JAX it runs without the repo's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_port_gpu.py
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from noise_gnn_tpu_torch.graph.containers import CSRGraph
from noise_gnn_tpu_torch.ops import gather_ring as gr
from noise_gnn_tpu_torch.ops import spmm

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _bf16_ulp(v):
    e = torch.floor(torch.log2(v.abs().clamp(min=2.0 ** -126)))
    return torch.pow(2.0, e - 7)


def _check_launches(op, csr, x, f):
    """mean/sum x f32/bf16 out: each call one counted launch (split rows
    take a second kernel, still one count), bit-equal to its repeat, and
    within max(1e-5, 4 sqrt(deg) 2^-24) x agg(|x|) of the plain version
    (fp32 sums in another order), plus one bf16 ulp for bf16 output."""
    deg = (csr.indptr[1:] - csr.indptr[:-1]).float()[:, None]
    rtol = torch.clamp(4 * deg.clamp(min=1).sqrt() * 2.0 ** -24, min=1e-5)
    for mean in (True, False):
        want = spmm.spmm_reference(csr.indptr, csr.indices, x, mean, torch.float32)
        mag = spmm.spmm_reference(csr.indptr, csr.indices, x.abs(), mean, torch.float32)
        for out_dtype in (torch.float32, torch.bfloat16):
            before = spmm.launch_counts[f]
            got = op(x, mean=mean, out_dtype=out_dtype)
            again = op(x, mean=mean, out_dtype=out_dtype)
            assert spmm.launch_counts[f] == before + 2 and got.dtype == out_dtype
            torch.cuda.synchronize()
            assert torch.equal(got, again)
            err = (got.float() - want).abs()
            tol = rtol * mag
            if out_dtype == torch.bfloat16:
                tol = tol + _bf16_ulp(want)
            assert bool((err <= tol).all()), float((err / tol.clamp(min=1e-30)).max())
            assert float(got[deg[:, 0] == 0].abs().max()) == 0.0  # isolated rows


@pytest.mark.gpu
@pytest.mark.parametrize("f", [100, 128, 256, 512])
def test_cuda_kernel_matches_plain(cuda, f):
    """f32/bf16 in, isolated rows and 2e4-degree hubs (split into segments
    of ``SEG_EDGES``); see ``_check_launches``."""
    rng = np.random.default_rng(f)
    n = 20011
    dst = np.concatenate([rng.integers(0, n - 500, 200_000), np.repeat([17, 4001], 20_000)])
    src = rng.integers(0, n, dst.shape[0])
    csr = CSRGraph.from_coo(np.stack([src, dst]).astype(np.int32), n, cuda)
    op = spmm.Spmm.from_csr(csr)
    assert op.schedule.num_partials > 0
    gen = torch.Generator(device=cuda).manual_seed(f)
    for x_dtype in (torch.float32, torch.bfloat16):
        _check_launches(op, csr, torch.randn((n, f), generator=gen, device=cuda).to(x_dtype), f)


@pytest.mark.gpu
def test_cuda_kernel_segment_boundaries(cuda):
    """Rows of exactly S - 1, S, S + 1 and 2S + 1 in-edges and a hub of 40S,
    S = SEG_EDGES."""
    s = spmm.SEG_EDGES
    rng = np.random.default_rng(s)
    n = 5003
    dst = np.concatenate([rng.integers(10, n - 100, 40_000),
                          np.repeat([5, 6, 7, 8, 9], [s - 1, s, s + 1, 2 * s + 1, 40 * s])])
    src = rng.integers(0, n, dst.shape[0])
    csr = CSRGraph.from_coo(np.stack([src, dst]).astype(np.int32), n, cuda)
    op = spmm.Spmm.from_csr(csr)
    split = set(op.schedule.comb_row.tolist())
    assert {7, 8, 9} <= split and not {5, 6} & split
    gen = torch.Generator(device=cuda).manual_seed(s)
    for f in (100, 128, 256, 512):
        _check_launches(op, csr, torch.randn((n, f), generator=gen, device=cuda).to(
            torch.bfloat16 if f == 100 else torch.float32), f)


@pytest.mark.gpu
def test_cuda_kernel_column_slices(cuda):
    """A source table over four times the L2 whose 256-byte column slices
    fit in it (120,000 x 512 f32, 246 MB), which the kernel runs slice by
    slice, and one a quarter as wide (61 MB), which it runs whole."""
    rng = np.random.default_rng(7)
    n, f = 120_000, 512
    dst = np.concatenate([rng.integers(0, n - 50, 1_500_000), np.repeat([3], 3000)])
    src = rng.integers(0, n, dst.shape[0])
    csr = CSRGraph.from_coo(np.stack([src, dst]).astype(np.int32), n, cuda)
    op = spmm.Spmm.from_csr(csr)
    gen = torch.Generator(device=cuda).manual_seed(7)
    for width in (f, f // 4):
        _check_launches(op, csr, torch.randn((n, width), generator=gen, device=cuda), width)


@pytest.mark.gpu
def test_cuda_kernel_odd_width_and_views(cuda):
    """F not a multiple of any vector width, and a misaligned input; one
    row of 300 in-edges, which the kernel splits."""
    n = 1001
    rng = np.random.default_rng(3)
    dst = np.concatenate([rng.integers(0, n, 30_000), np.full(300, 500)])
    src = rng.integers(0, n, dst.shape[0])
    csr = CSRGraph.from_coo(np.stack([src, dst]).astype(np.int32), n, cuda)
    op = spmm.Spmm.from_csr(csr)
    assert 500 in op.schedule.comb_row.tolist()
    base = torch.randn((n * 37 + 1,), device=cuda)
    x = base[1:].view(n, 37)  # contiguous, 4-byte but not 16-byte aligned
    want = spmm.spmm_reference(csr.indptr, csr.indices, x, True, torch.float32)
    got = op(x)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="contiguous"):
        op(torch.randn((37, n), device=cuda).t())


@pytest.mark.gpu
def test_main_path_small_on_cuda(cuda, tmp_path):
    from noise_gnn_tpu_torch.main import main
    from noise_gnn_tpu_torch.utils.config import load_config

    c = load_config(str(ROOT / "configs" / "config_products.yml"))
    c.update(synthetic_scale=200, max_epochs=2, num_runs=1, reinit_retries=0,
             out_dir=str(tmp_path / "out"), data_dir=str(tmp_path / "data"))
    spmm.launch_counts.clear()
    res = main(c)
    assert set(res) == {"nalgo", "baseline"}
    assert all(np.isfinite(v[0]) for v in res.values())
    # leaf table + 2 pair-eval layers x 2 epochs + 2 single-eval layers x 2 epochs
    assert sum(spmm.launch_counts.values()) >= 9


@pytest.mark.gpu
@pytest.mark.parametrize("f", [4, 128, 256])
def test_gather_ring_kernel_matches_plain(cuda, f):
    """Bit-equal final rings for depth == chunk, depth < chunk (slots
    rewritten, the last copy kept) and depth 1 (``chip_smoke.GATHER_CASES``),
    at passes 1, 2, 3, 4, 8 and 16, with a launch counted each call and a
    repeated call bit-equal."""
    from chip_smoke import GATHER_CASES, GATHER_PASSES

    rng = np.random.default_rng(f)
    x3 = torch.from_numpy(rng.standard_normal((1000, 8, f)).astype(np.float32)).to(cuda)
    for depth, chunk in GATHER_CASES:
        idx = torch.from_numpy(rng.integers(0, 1000, chunk * 5).astype(np.int32)).to(cuda)
        for passes in GATHER_PASSES:
            before = gr.launch_counts[depth]
            got = gr.gather_ring(x3, idx, depth, chunk, passes)
            again = gr.gather_ring(x3, idx, depth, chunk, passes)
            torch.cuda.synchronize()
            assert gr.launch_counts[depth] == before + 2
            assert torch.equal(got, again)
            assert torch.equal(got, gr.gather_ring_reference(x3, idx, depth, chunk, passes))


@pytest.mark.gpu
@pytest.mark.parametrize("passes", [1, 2, 3, 4, 8, 16])
def test_gather_ring_kernel_clusters(cuda, passes):
    """Depth 24 of [8, 256] blocks (one block an SM) on a grid of over twice
    the card's SMs, where the rule clusters: C is the largest of 8, 4, 2, 1
    dividing passes. One launch counted per call, bit-equal to the plain
    version and to a repeated call."""
    from chip_smoke import wave_chunks

    nchunks = wave_chunks(passes, torch.cuda.get_device_properties(cuda).multi_processor_count)
    csize, active = gr.plan(24, 64, 256, passes, nchunks, cuda)
    assert csize == max(c for c in gr.CLUSTER_SIZES if passes % c == 0) and active >= 1
    rng = np.random.default_rng(passes)
    x3 = torch.from_numpy(rng.standard_normal((1000, 8, 256)).astype(np.float32)).to(cuda)
    idx = torch.from_numpy(rng.integers(0, 1000, 64 * nchunks).astype(np.int32)).to(cuda)
    before = gr.launch_counts[24]
    got = gr.gather_ring(x3, idx, 24, 64, passes)
    again = gr.gather_ring(x3, idx, 24, 64, passes)
    torch.cuda.synchronize()
    assert gr.launch_counts[24] == before + 2
    assert torch.equal(got, again)
    assert torch.equal(got, gr.gather_ring_reference(x3, idx, 24, 64, passes))


@pytest.mark.gpu
def test_gather_ring_kernel_refuses(cuda):
    x3 = torch.zeros((10, 8, 1024), device=cuda)
    idx = torch.zeros(64, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        gr.gather_ring(x3, idx, 16, 64, 1)  # 16 blocks of 32 KB
    with pytest.raises(ValueError, match="outside"):
        gr.gather_ring(x3, idx + 10, 2, 64, 1)
    gr.gather_ring(x3, idx, 2, 64, 1)  # in range: the wrapper remembers idx
    idx += 10  # the same tensor, changed in place
    with pytest.raises(ValueError, match="outside"):
        gr.gather_ring(x3, idx, 2, 64, 1)


@pytest.mark.gpu
def test_stable_topk_and_tree_rewire_match_cpu(cuda):
    """The stable top-k helper and ``hier_topk`` on tied values with signed
    zeros and -inf, and ``topk_rewire_tree`` on exact-arithmetic rows (four
    entries of +-0.5, from a pool of 40: every similarity a multiple of
    0.25, ties everywhere): bit-equal to the CPU, order included."""
    from chip_smoke import exact_rows
    from noise_gnn_tpu_torch.augment.rewire import topk_rewire_tree
    from noise_gnn_tpu_torch.ops import sddmm
    from noise_gnn_tpu_torch.ops.tree_agg import TreeTopo

    rng = np.random.default_rng(12)
    x = (rng.integers(-4, 5, 200_000) * 0.25).astype(np.float32)
    x[rng.random(x.shape[0]) < 0.1] = -0.0
    x[rng.random(x.shape[0]) < 0.05] = -np.inf
    for fn, k in ((sddmm.stable_topk, 5000), (sddmm.hier_topk, 7), (sddmm.hier_topk, 3000)):
        (cv, ci), (gv, gi) = (fn(torch.from_numpy(x).to(d), k) for d in ("cpu", cuda))
        assert torch.equal(gi.cpu(), ci)
        assert torch.equal(gv.cpu().view(torch.int32), cv.view(torch.int32))
    b, fanouts = 16, (10, 5, 5)
    mask = torch.from_numpy(rng.random(b * 310) < 0.8)
    h = torch.from_numpy(exact_rows(rng, b * 311, 16, 40))
    want = topk_rewire_tree(h, TreeTopo(b, fanouts, mask), 0.1)
    got = topk_rewire_tree(h.to(cuda), TreeTopo(b, fanouts, mask.to(cuda)), 0.1)
    for w, g in zip(want, got):
        for a, c in ((w.edge_mask, g.edge_mask), (w.extra_src, g.extra_src),
                     (w.extra_dst, g.extra_dst), (w.extra_mask, g.extra_mask)):
            assert torch.equal(c.cpu(), a)


@pytest.mark.gpu
def test_sorted_segment_sum_is_fixed_order(cuda):
    """On the card the sorted segment sum (``segment_sum``) adds each segment's rows in index
    order: bit-equal to the CPU's ``index_add_`` on random floats, and the
    gradient of ``fast_take`` from a source that requires grad is the same
    on every call (``index_select``'s own backward adds with atomics)."""
    from noise_gnn_tpu_torch.ops.scatter import fast_take, segment_sum

    rng = np.random.default_rng(13)
    ids = torch.from_numpy(rng.integers(0, 300, 200_000))
    data = torch.from_numpy(rng.standard_normal((200_000, 64)).astype(np.float32))
    want = torch.zeros(301, 64).index_add_(0, ids, data)
    got = segment_sum(data.to(cuda), ids.to(cuda), 301)
    assert torch.equal(got.cpu(), want)
    grads = []
    for _ in range(2):
        x = torch.zeros(300, 64, device=cuda, requires_grad=True)
        (fast_take(x, ids.to(cuda)) * data.to(cuda)).sum().backward()
        grads.append(x.grad)
    assert torch.equal(grads[0], grads[1]) and torch.equal(grads[0].cpu(), want[:300])


@pytest.mark.gpu
def test_bench_spmm_small_on_cuda(cuda):
    """``tools/bench_spmm.py`` on the card at a small shape: every number
    of its JSON line finite, the kernel launched at F and 2F; then the
    kernel on the tool's graph (13% isolated rows) against its plain
    version (see ``_check_launches``)."""
    from noise_gnn_tpu_torch.tools import bench_spmm

    n, e, f = 50_000, 100_000, 64
    spmm.launch_counts.clear()
    res = bench_spmm.run(nodes=n, edges=e, feat=f, iters=2)
    nums = [v for v in res.values() if isinstance(v, float)] + list(res["ms"].values())
    assert len(nums) >= 15 and all(np.isfinite(v) and v > 0 for v in nums)
    assert res["card"] == torch.cuda.get_device_name(0) and res["power_limit"]
    assert spmm.launch_counts[f] > 0 and spmm.launch_counts[2 * f] > 0
    indptr, src, _ = bench_spmm.make_graph(n, e)
    csr = CSRGraph(torch.from_numpy(indptr).to(cuda), torch.from_numpy(src).to(cuda), n)
    op = spmm.Spmm.from_csr(csr)
    for x_dtype in (torch.float32, torch.bfloat16):
        _check_launches(op, csr, bench_spmm.features(n, f, x_dtype, cuda), f)
