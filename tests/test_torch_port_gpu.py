"""Tests of the port that need a CUDA card: the CUDA SpMM, the gather-ring
kernel and the GAT attention kernel against their plain versions, the main path on a small
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
from noise_gnn_tpu_torch.ops import gat_attn
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


@pytest.mark.gpu
def test_flat_agg_forms_on_cuda(cuda):
    """``tools/exp_flat_agg.py``'s forms (a) edge-list mean and (b) tree
    aggregation on the card, with a random edge mask, against the same
    forms on the CPU: f32, 1e-5 (``index_add_`` adds a row's up to 10
    messages in another order on the card); (b) is a fixed-order masked
    sum and must agree with (a) as well."""
    from noise_gnn_tpu_torch.tools import exp_flat_agg

    batch, fanouts, feat = 64, (10, 5), 384
    n_sub = sum(exp_flat_agg.tree_sizes(batch, fanouts))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((n_sub, feat)).astype(np.float32))
    mask = torch.from_numpy(rng.random(n_sub - batch) < 0.7)
    add = torch.from_numpy(rng.integers(0, n_sub, (2, 2 * int(n_sub * 0.1))))
    cpu = exp_flat_agg.forms(x, mask, batch, fanouts, add)
    card = exp_flat_agg.forms(x.to(cuda), mask.to(cuda), batch, fanouts, add.to(cuda))
    for name in ("edge_list", "structured"):
        got = card[name]().cpu()
        torch.testing.assert_close(got, cpu[name](), rtol=0, atol=1e-5, msg=name)
    torch.testing.assert_close(card["edge_list"]().cpu(), cpu["structured"](), rtol=0,
                               atol=1e-5)


def _rewire_rows(cuda, n: int, d: int, seed: int):
    g = torch.Generator(device=cuda).manual_seed(seed)
    from noise_gnn_tpu_torch.ops.sddmm import l2_normalize

    return l2_normalize(torch.randn((n, d), generator=g, device=cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("d", [256, 128])
def test_rewire_similarities_match_cublas(cuda, d):
    """The extrema kernel's product, written out: bit-equal to the f32
    ``hp[rows] @ hn.T`` that the block sweep takes from cuBLAS, block by
    block, and to ``hn @ hn.T`` whole (one FMA chain over k in order)."""
    from noise_gnn_tpu_torch.ops import sddmm

    n = 128 * 40
    hn = _rewire_rows(cuda, n, d, d)
    hp = sddmm.padded_rows(hn, 2048)
    before = sddmm.launch_counts["sim"]
    for row0 in range(0, n, 2048):
        rows = min(2048, n - row0)
        want = (hp[row0:row0 + 2048] @ hn.T)[:rows]
        got = sddmm.similarity_rows(hn, row0, rows)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(sddmm.similarity_rows(hn, 0, n).view(torch.int32),
                       (hn @ hn.T).view(torch.int32))
    assert sddmm.launch_counts["sim"] == before + 4


@pytest.mark.gpu
@pytest.mark.parametrize("d", [256, 128])
def test_rewire_extrema_and_values_match_plain(cuda, d):
    """``segment_extrema`` (both signs and pos alone, a whole range and one
    not starting at 0) and ``segment_values`` launch their kernels and are
    bit-equal to the plain versions on the card, which read cuBLAS's
    blocks; rows past N -inf. At this shape ([2048, D] x [D, 10,752])
    cuBLAS's f32 product is itself one FMA chain in order, as the first
    check asserts; at small shapes it may split k (a [512, 256] x [256,
    1280] product differs from the chain by a few ulp)."""
    from noise_gnn_tpu_torch.augment import rewire
    from noise_gnn_tpu_torch.ops import sddmm
    from noise_gnn_tpu_torch.ops.tree_agg import TreeTopo

    b, fanouts, block = 512, (5, 3), 2048
    n = b * 21  # 10,752 rows: 84 tiles; 6 blocks hold 12,288
    topo = TreeTopo(b, fanouts, torch.rand(n - b, generator=torch.Generator().manual_seed(d))
                    .to(cuda) < 0.8)
    hn, k2, _, _, pos_keep = rewire._plan(_rewire_rows(cuda, n, d, d + 1), topo, 0.1)
    hp = sddmm.padded_rows(hn, block)
    assert torch.equal(sddmm.similarity_rows(hn, 2048, 2048).view(torch.int32),
                       (hp[2048:4096] @ hn.T).view(torch.int32))
    excl = [rewire._exclusions(topo, pos_keep), rewire._exclusions(topo, topo.edge_mask)]
    nb = -(-n // block)
    for blocks, neg in ((range(nb), True), (range(1, nb), True), (range(nb), False)):
        before = dict(sddmm.launch_counts)
        got = sddmm.segment_extrema(hn, blocks, block, excl[0], excl[1] if neg else None)
        want = sddmm._extrema_plain(hn, blocks, block, excl[0], excl[1] if neg else None)
        assert (got[1] is None) == (want[1] is None) == (not neg)
        for g, w in zip(got, want):
            if g is not None:
                assert torch.equal(g.view(torch.int32), w.view(torch.int32))
        picks = [(sddmm.select_segments(x.view(len(blocks), -1), k2), e, s)
                 for x, e, s in zip(got, excl, (False, True)) if x is not None]
        vals = sddmm.segment_values(hn, blocks, block, picks)
        for g, w in zip(vals, sddmm._values_plain(hn, blocks, block, picks)):
            assert torch.equal(g.view(torch.int32), w.view(torch.int32))
        assert sddmm.launch_counts["extrema"] == before.get("extrema", 0) + 1
        assert sddmm.launch_counts["values"] == before.get("values", 0) + 1
    assert bool(torch.isinf(got[0][n:]).all())


@pytest.mark.gpu
def test_rewire_fused_matches_block_sweep_at_cell_shape(cuda, monkeypatch):
    """``topk_rewire_tree`` at the TE cell's shape (b = 512, fanouts (10, 5,
    5): 159,232 rows, random f32 rows, D = 256): the fused route, whose
    kernels ran, and the block sweep give the same topologies, both signs,
    order included; and so does the pos-only call."""
    from noise_gnn_tpu_torch.augment import rewire
    from noise_gnn_tpu_torch.ops import sddmm
    from noise_gnn_tpu_torch.ops.tree_agg import TreeTopo

    b, fanouts = 512, (10, 5, 5)
    n = b * 311
    topo = TreeTopo(b, fanouts, torch.rand(n - b, generator=torch.Generator().manual_seed(5))
                    .to(cuda) < 0.8)
    h = torch.randn((n, 256), generator=torch.Generator(device=cuda).manual_seed(5),
                    device=cuda)
    for neg in (True, False):
        before = dict(sddmm.launch_counts)
        fused = rewire.topk_rewire_tree(h, topo, 0.1, neg=neg)
        assert sddmm.launch_counts["extrema"] == before.get("extrema", 0) + 1
        assert sddmm.launch_counts["values"] == before.get("values", 0) + -(-78 // rewire.GROUP)
        with monkeypatch.context() as m:
            m.setattr(rewire, "_sweep_fused", rewire._sweep_blocks)
            plain = rewire.topk_rewire_tree(h, topo, 0.1, neg=neg)
        assert (fused[1] is None) == (plain[1] is None) == (not neg)
        for tf, tp in zip(fused, plain):
            if tf is not None:
                for a, c in ((tf.edge_mask, tp.edge_mask), (tf.extra_src, tp.extra_src),
                             (tf.extra_dst, tp.extra_dst), (tf.extra_mask, tp.extra_mask)):
                    assert torch.equal(a, c)


@pytest.mark.gpu
def test_rewire_kernels_refuse(cuda):
    """Not float32, not contiguous, or rows not whole 128-row tiles: the
    wrappers raise before any launch."""
    from noise_gnn_tpu_torch.ops import sddmm

    excl = torch.full((256,), -1, dtype=torch.int32, device=cuda)
    hn = torch.zeros((256, 8), device=cuda)
    si = [(torch.zeros((1, 1), dtype=torch.int64, device=cuda), excl, False)]
    bad = (hn.half(), torch.zeros((256, 16), device=cuda)[:, ::2], hn[:200])
    for x in bad:
        with pytest.raises((TypeError, ValueError)):
            sddmm.segment_extrema(x, range(1), 128, excl)
        with pytest.raises((TypeError, ValueError)):
            sddmm.segment_values(x, range(1), 128, si)
    with pytest.raises(ValueError):
        sddmm.segment_extrema(hn, range(1), 100, excl)
    with pytest.raises(ValueError):
        sddmm.similarity_rows(hn, 64, 128)


@pytest.mark.gpu
def test_topk_keys_kernel_matches_plain(cuda):
    """``stable_topk``'s int64 keys from the keys kernel, along the last
    axis of a 1-D and a 2-D array with signed zeros, infinities and ties:
    bit-equal to the CPU's torch ops; and ``stable_topk`` itself."""
    from noise_gnn_tpu_torch.ops import sddmm

    rng = np.random.default_rng(21)
    x = (rng.integers(-4, 5, (3, 70_001)) * 0.25).astype(np.float32)
    x[rng.random(x.shape) < 0.1] = -0.0
    x[rng.random(x.shape) < 0.02] = np.inf
    x[rng.random(x.shape) < 0.02] = -np.inf
    for a in (torch.from_numpy(x), torch.from_numpy(x[1])):
        before = sddmm.launch_counts["keys"]
        assert torch.equal(sddmm.topk_keys(a.to(cuda)).cpu(), sddmm.topk_keys(a))
        assert sddmm.launch_counts["keys"] == before + 1
        (cv, ci), (gv, gi) = (sddmm.stable_topk(a.to(d), 777) for d in ("cpu", cuda))
        assert torch.equal(gi.cpu(), ci) and torch.equal(gv.cpu().view(torch.int32),
                                                         cv.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,width,heads", [
    (torch.bfloat16, 1024, 8),  # the products pair's layers 1-2: 8 heads of 128
    (torch.bfloat16, 376, 8),  # layer 3: 8 heads of 47, vectors across heads
    (torch.bfloat16, 188, 4),  # a single net's layer 3: 8-byte vectors
    (torch.float32, 512, 4),
    (torch.float32, 2048, 16),  # two column passes, 16 heads
    (torch.float32, 33, 3),  # scalar loads
])
def test_gat_attn_kernel_matches_plain(cuda, dtype, width, heads):
    """On GATConv's self-looped CSR of a graph with existing self-loops and
    two rows of products' largest in-degree (7,411, split into 29 segments
    of ``SEG_EDGES``): within max(1e-5, 4 sqrt(deg) 2^-24) of the weighted
    sum of |x| of the plain version (fp32 sums and exponentials in another
    order), plus one bf16 ulp for bf16; every call one counted launch, and
    bit-equal to its repeat."""
    rng = np.random.default_rng(width)
    n = 20011
    dst = np.concatenate([rng.integers(0, n - 500, 200_000), np.repeat([17, 4001], 7411),
                          np.arange(0, 300)])
    src = np.concatenate([rng.integers(0, n, dst.shape[0] - 300), np.arange(0, 300)])
    csr = CSRGraph.from_coo(np.stack([src, dst]).astype(np.int32), n, cuda)
    op = gat_attn.GatAttn.self_looped(csr)
    assert {17, 4001} <= set(op.schedule.comb_row.tolist())
    gen = torch.Generator(device=cuda).manual_seed(width)
    x = torch.randn((n, width), generator=gen, device=cuda).to(dtype)
    s_src, s_dst = (3 * torch.randn((n, heads), generator=gen, device=cuda) for _ in range(2))
    want = gat_attn.gat_attn_reference(op.indptr, op.indices, x.float(), s_src, s_dst)
    mag = gat_attn.gat_attn_reference(op.indptr, op.indices, x.float().abs(), s_src, s_dst)
    before = gat_attn.launch_counts[width]
    got = op(x, s_src, s_dst)
    again = op(x, s_src, s_dst)
    torch.cuda.synchronize()
    assert gat_attn.launch_counts[width] == before + 2 and got.dtype == dtype
    assert torch.equal(got, again)
    deg = (op.indptr[1:] - op.indptr[:-1]).float()[:, None]
    tol = torch.clamp(4 * deg.sqrt() * 2.0 ** -24, min=1e-5) * mag
    if dtype == torch.bfloat16:
        tol = tol + _bf16_ulp(want)
    err = (got.float() - want).abs()
    assert bool((err <= tol).all()), float((err / tol.clamp(min=1e-30)).max())


@pytest.mark.gpu
def test_gat_attn_kernel_rows_without_edges(cuda):
    """A CSR without the self-loops: rows without in-edges give 0, the rest
    agree with the plain version."""
    n = 3000
    rng = np.random.default_rng(5)
    dst = rng.integers(0, n // 2, 20_000)
    src = rng.integers(0, n, dst.shape[0])
    csr = CSRGraph.from_coo(np.stack([src, dst]).astype(np.int32), n, cuda)
    op = gat_attn.GatAttn(csr.indptr, csr.indices)
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn((n, 256), generator=gen, device=cuda)
    s_src, s_dst = (torch.randn((n, 4), generator=gen, device=cuda) for _ in range(2))
    got = op(x, s_src, s_dst)
    torch.cuda.synchronize()
    empty = (csr.indptr[1:] - csr.indptr[:-1]) == 0
    assert bool(empty.any()) and float(got[empty].abs().max()) == 0.0
    want = gat_attn.gat_attn_reference(op.indptr, op.indices, x, s_src, s_dst)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
