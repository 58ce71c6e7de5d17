"""Tests of the port that need a CUDA card: the CUDA SpMM and the
gather-ring kernel against their plain versions, and the main path on a
small graph. They skip where no card is
visible. This file imports neither JAX nor the JAX package, so on a card
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
    with a launch counted each."""
    from chip_smoke import GATHER_CASES

    rng = np.random.default_rng(f)
    x3 = torch.from_numpy(rng.standard_normal((1000, 8, f)).astype(np.float32)).to(cuda)
    for depth, chunk in GATHER_CASES:
        idx = torch.from_numpy(rng.integers(0, 1000, chunk * 5).astype(np.int32)).to(cuda)
        before = gr.launch_counts[depth]
        got = gr.gather_ring(x3, idx, depth, chunk, 3)
        torch.cuda.synchronize()
        assert gr.launch_counts[depth] == before + 1
        assert torch.equal(got, gr.gather_ring_reference(x3, idx, depth, chunk, 3))


@pytest.mark.gpu
def test_gather_ring_kernel_refuses(cuda):
    x3 = torch.zeros((10, 8, 1024), device=cuda)
    idx = torch.zeros(64, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        gr.gather_ring(x3, idx, 16, 64, 1)  # 16 blocks of 32 KB
    with pytest.raises(ValueError, match="outside"):
        gr.gather_ring(x3, idx + 10, 2, 64, 1)
