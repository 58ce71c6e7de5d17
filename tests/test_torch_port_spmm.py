"""The port's CSR SpMM and scatter ops against the JAX package.

On the CPU the ``Spmm`` operator runs its plain version; it is held against
the Pallas kernel in interpret mode (as tests/test_pallas_spmm.py runs it)
and against ``gather_scatter_mean``/``_sum``. The CUDA kernel itself is held
against the plain version in ``tests/test_torch_port_gpu.py``.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noise_gnn_tpu.graph.containers import CSRGraph as JCSR
from noise_gnn_tpu.ops import scatter as jscatter
from noise_gnn_tpu.ops.leaf_agg import fused_leaf_table as j_fused
from noise_gnn_tpu.ops.pallas_spmm import PallasSpmm
from noise_gnn_tpu_torch.graph.containers import CSRGraph
from noise_gnn_tpu_torch.ops import scatter as tscatter
from noise_gnn_tpu_torch.ops import spmm as tspmm
from noise_gnn_tpu_torch.ops.leaf_agg import fused_leaf_table as t_fused

# f32 parity: only the summation order differs, so errors are bounded
# relative to the sum of the summands' magnitudes, |got - want| <= RTOL *
# agg(|x|) + ATOL (agg = the same mean or sum over the row's in-edges)
RTOL, ATOL = 1e-5, 1e-6


def assert_agg_close(got, want, x, ei, n, mean):
    absx = torch.from_numpy(np.abs(np.asarray(x, np.float32)))
    f = tscatter.gather_scatter_mean if mean else tscatter.gather_scatter_sum
    scale = f(absx, torch.from_numpy(ei), n).numpy()
    err = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))
    assert (err <= RTOL * scale + ATOL).all(), float((err - RTOL * scale).max())


def hub_graph(n=700, e=6000, hubs=(3, 11), hub_deg=1500, isolated=100, seed=0):
    """Random edges plus hub destinations; the last `isolated` rows get no
    in-edges."""
    rng = np.random.default_rng(seed)
    dst = np.concatenate([rng.integers(0, n - isolated, e),
                          np.repeat(np.asarray(hubs), hub_deg)])
    src = rng.integers(0, n, dst.shape[0])
    return np.stack([src, dst]).astype(np.int32)


def spmm_op(ei, n):
    return tspmm.Spmm.from_csr(CSRGraph.from_coo(ei, n))


@pytest.mark.parametrize("mean", [True, False])
@pytest.mark.parametrize("out_bf16", [False, True])
def test_plain_spmm_matches_pallas_interpret(mean, out_bf16):
    n = 700
    ei = hub_graph(n)
    x = np.random.default_rng(1).standard_normal((n, 100)).astype(np.float32)
    jcsr = JCSR.from_coo(ei, n)
    op = PallasSpmm(np.asarray(jcsr.indptr), np.asarray(jcsr.indices), n)
    xp = jnp.pad(jnp.asarray(x), ((0, 0), (0, 28)))  # Pallas lanes: F % 128
    out_dtype = jnp.bfloat16 if out_bf16 else jnp.float32
    want = np.asarray(op.apply(xp, mean=mean, interpret=True,
                               out_dtype=out_dtype)[:, :100].astype(jnp.float32))
    got = spmm_op(ei, n)(torch.from_numpy(x), mean=mean,
                         out_dtype=torch.bfloat16 if out_bf16 else torch.float32)
    assert got.dtype == (torch.bfloat16 if out_bf16 else torch.float32)
    got = got.float().numpy()
    if out_bf16:
        # both round the same f32 sums; allow one bf16 ulp where the sums'
        # last bits straddle a rounding boundary
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-6)
    else:
        assert_agg_close(got, want, x, ei, n, mean)
    assert np.abs(got[-100:]).max() == 0.0  # isolated rows


@pytest.mark.parametrize("kind", ["mean", "sum", "max"])
@pytest.mark.parametrize("masked", [False, True])
def test_gather_scatter_identical_math(kind, masked):
    n = 300
    ei = hub_graph(n, 2500, hubs=(5,), hub_deg=400, isolated=30, seed=2)
    x = np.random.default_rng(3).standard_normal((n, 24)).astype(np.float32)
    mask = np.random.default_rng(4).random(ei.shape[1]) < 0.8 if masked else None
    jf = getattr(jscatter, f"gather_scatter_{kind}")
    tf = getattr(tscatter, f"gather_scatter_{kind}")
    want = np.asarray(jf(jnp.asarray(x), jnp.asarray(ei), n,
                         None if mask is None else jnp.asarray(mask)))
    got = tf(torch.from_numpy(x), torch.from_numpy(ei), n,
             None if mask is None else torch.from_numpy(mask)).numpy()
    if kind == "max":
        np.testing.assert_array_equal(got, want)
    else:
        kept = ei if mask is None else ei[:, mask]
        assert_agg_close(got, want, x, kept, n, kind == "mean")
    dj = np.asarray(jscatter.degree(jnp.asarray(ei), n))
    np.testing.assert_array_equal(tscatter.degree(torch.from_numpy(ei), n).numpy(), dj)


@pytest.mark.parametrize("mean", [True, False])
def test_plain_spmm_matches_gather_scatter(mean):
    n = 500
    ei = hub_graph(n, 4000, hubs=(0, 499 - 60), hub_deg=900, isolated=50, seed=5)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((n, 37)).astype(np.float32))
    want = (tscatter.gather_scatter_mean if mean else tscatter.gather_scatter_sum)(
        x, torch.from_numpy(ei), n)
    got = spmm_op(ei, n)(x, mean=mean)
    assert_agg_close(got, want, x, ei, n, mean)
    # the edge-chunked plain version equals the one-slab one
    small = tspmm.spmm_reference(*_csr_of(ei, n), x, mean, slab_elems=37 * 64)
    assert_agg_close(small, got, x, ei, n, mean)


def _csr_of(ei, n):
    c = CSRGraph.from_coo(ei, n)
    return c.indptr, c.indices


@pytest.mark.parametrize("aggr", ["mean", "sum", "max"])
def test_fused_leaf_table_matches_jax(aggr):
    n = 400
    ei = hub_graph(n, 3000, hubs=(7,), hub_deg=300, isolated=40, seed=8)
    x = np.random.default_rng(9).standard_normal((n, 20)).astype(np.float32)
    want = np.asarray(j_fused(jnp.asarray(x), JCSR.from_coo(ei, n), aggr=aggr,
                              backend="xla"))
    got = t_fused(torch.from_numpy(x), CSRGraph.from_coo(ei, n), aggr=aggr)
    np.testing.assert_array_equal(got[:, :20].numpy(), x)
    if aggr == "max":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        assert_agg_close(got[:, 20:], want[:, 20:], x, ei, n, aggr == "mean")


def _chip_smoke():
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_chip_smoke_tolerance(out_dtype):
    """The card check's tolerance, here on the plain version: its own output
    (bf16-rounded or not) passes, in row blocks as in one block; an error of
    twice the tolerance in one element fails."""
    cs = _chip_smoke()
    n = 700
    indptr, indices = _csr_of(hub_graph(n), n)
    x = torch.from_numpy(np.random.default_rng(10).standard_normal((n, 100)).astype(np.float32))
    ref = tspmm.spmm_reference(indptr, indices, x, True, torch.float32)
    mag = tspmm.spmm_reference(indptr, indices, x.abs(), True, torch.float32)
    rtol = cs.sum_rtol(indptr)
    got = ref.to(out_dtype)
    whole, blocks = cs.compare(got, ref, mag, rtol), cs.compare(got, ref, mag, rtol, rows=64)
    assert whole == blocks and whole["ok"] and whole["max_err_over_tol"] <= 0.5
    tol = rtol[3, 0] * mag[3, 7] + (cs.bf16_ulp(ref[3, 7]) if out_dtype == torch.bfloat16 else 0)
    bad = ref.clone()
    bad[3, 7] += 2 * tol
    res = cs.compare(bad.to(out_dtype), ref, mag, rtol, rows=64)
    assert not res["ok"] and res["max_err_over_tol"] > 1.0


def test_wrapper_checks():
    n = 50
    op = spmm_op(hub_graph(n, 200, hubs=(1,), hub_deg=10, isolated=5), n)
    with pytest.raises(ValueError):
        op(torch.zeros(n + 1, 8))
    with pytest.raises(TypeError):
        op(torch.zeros(n, 8, dtype=torch.float64))
    with pytest.raises(TypeError):
        op(torch.zeros(n, 8), out_dtype=torch.float16)
    with pytest.raises(ValueError):
        tspmm.Spmm(torch.tensor([0, 1]), torch.tensor([5], dtype=torch.int32))
    tspmm.launch_counts.clear()
    op(torch.zeros(n, 8))
    assert sum(tspmm.launch_counts.values()) == 0  # the plain version never counts
