"""The port's CSR SpMM and scatter ops against the JAX package.

On the CPU the ``Spmm`` operator runs its plain version; it is held against
the Pallas kernel in interpret mode (as tests/test_pallas_spmm.py runs it)
and against ``gather_scatter_mean``/``_sum``. The kernel's segment schedule
(``segment_schedule``) is checked here, and its arithmetic (per-segment
partials, combined in segment order) is held against the plain version in
plain torch. The CUDA kernel itself is held against the plain version in
``tests/test_torch_port_gpu.py``.
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


def boundary_graph(s, n=60, seed=11):
    """Rows of 0, S - 1, S, S + 1, 2S + 1 and 40S in-edges (rows 0-5) among
    random ones; rows n - 5 .. n - 1 get none either."""
    rng = np.random.default_rng(seed)
    dst = np.concatenate([np.repeat([1, 2, 3, 4, 5], [s - 1, s, s + 1, 2 * s + 1, 40 * s]),
                          rng.integers(6, n - 5, 30 * n)])
    src = rng.integers(0, n, dst.shape[0])
    return np.stack([src, dst]).astype(np.int32)


@pytest.mark.parametrize("seg_edges", [1, 8, 64])
def test_segment_schedule_covers_edges(seg_edges):
    """Every edge in exactly one segment, in CSR order; no segment over S;
    rows of 0 or S edges one segment, rows of S + 1 two; split rows own
    consecutive partial slots in segment order; longest segments first,
    CSR order among equals."""
    s, n = seg_edges, 60
    indptr, indices = _csr_of(boundary_graph(s, n), n)
    sch = tspmm.segment_schedule(indptr, s)
    start, length, dst = sch.seg_start, sch.seg_len.long(), sch.seg_dst.long()
    assert start.dtype == torch.int64 and sch.seg_len.dtype == sch.seg_dst.dtype == torch.int32
    assert int(length.max()) <= s and int(length.sum()) == indices.shape[0]
    full = torch.argsort(start[length > 0])  # empty segments (isolated rows) aside
    starts, ends = start[length > 0][full], (start + length)[length > 0][full]
    assert int(starts[0]) == 0 and torch.equal(starts[1:], ends[:-1])
    # longest first, CSR order among segments of one length
    assert bool((length[:-1] >= length[1:]).all())
    same = length[:-1] == length[1:]
    assert bool((start[:-1][same] <= start[1:][same]).all())
    deg = indptr[1:] - indptr[:-1]
    # each isolated row (row 0 and the last 5) is one empty segment, in order
    assert torch.equal(dst[length == 0], torch.nonzero(deg == 0).squeeze(1))
    direct = dst >= 0
    rows = dst[direct]
    assert torch.equal(start[direct], indptr[rows]) and torch.equal(length[direct], deg[rows])
    split_rows = sch.comb_row.long()
    assert sorted(rows.tolist() + split_rows.tolist()) == list(range(n))
    assert torch.equal(split_rows, torch.nonzero(deg > s).squeeze(1))
    assert {0, 2} <= set(rows.tolist()) and 3 in split_rows.tolist()
    # split row j: slots comb_ptr[j] .. comb_ptr[j + 1] cover its edges in order
    slot_start = torch.empty(sch.num_partials, dtype=torch.int64)
    slot_start[-1 - dst[~direct]] = start[~direct]
    for j, r in enumerate(split_rows.tolist()):
        p0, p1 = int(sch.comb_ptr[j]), int(sch.comb_ptr[j + 1])
        want = torch.arange(int(indptr[r]), int(indptr[r + 1]), s)
        assert p1 - p0 == (int(deg[r]) + s - 1) // s and torch.equal(slot_start[p0:p1], want)
    assert int(sch.comb_ptr[-1]) == sch.num_partials


def schedule_eval(sch, indptr, indices, x, mean):
    """The kernel's arithmetic in plain torch: one fp32 sum per segment;
    a row of one segment is that sum, a split row the sum of its partials
    in slot (= segment) order; then scaled."""
    n, f = indptr.shape[0] - 1, x.shape[1]
    nseg = sch.seg_len.shape[0]
    length = sch.seg_len.long()
    offs = torch.cumsum(length, 0) - length
    edge = (sch.seg_start.repeat_interleave(length)
            + torch.arange(int(length.sum())) - offs.repeat_interleave(length))
    sums = torch.zeros(nseg, f).index_add_(
        0, torch.arange(nseg).repeat_interleave(length), x[indices[edge].long()].float())
    deg = (indptr[1:] - indptr[:-1]).float()
    scale = 1.0 / deg.clamp(min=1) if mean else torch.ones(n)
    out = torch.zeros(n, f)
    dst = sch.seg_dst.long()
    direct = dst >= 0
    out[dst[direct]] = sums[direct] * scale[dst[direct], None]
    partial = torch.empty(sch.num_partials, f)
    partial[-1 - dst[~direct]] = sums[~direct]
    for j, r in enumerate(sch.comb_row.tolist()):
        acc = torch.zeros(f)
        for p in range(int(sch.comb_ptr[j]), int(sch.comb_ptr[j + 1])):
            acc = acc + partial[p]
        out[r] = acc * scale[r]
    return out


@pytest.mark.parametrize("mean", [True, False])
def test_schedule_arithmetic_matches_plain(mean):
    """Hubs of 1500 in-edges, ~190 segments of S = 8 each."""
    n = 700
    ei = hub_graph(n)
    indptr, indices = _csr_of(ei, n)
    x = torch.from_numpy(np.random.default_rng(12).standard_normal((n, 40)).astype(np.float32))
    sch = tspmm.segment_schedule(indptr, 8)
    assert sch.num_partials >= 2 * 1500 // 8
    got = schedule_eval(sch, indptr, indices, x, mean)
    want = tspmm.spmm_reference(indptr, indices, x, mean, torch.float32)
    assert_agg_close(got.numpy(), want.numpy(), x.numpy(), ei, n, mean)


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
    with pytest.raises(ValueError, match="seg_edges"):
        tspmm.segment_schedule(op.indptr, 0)
    tspmm.launch_counts.clear()
    op(torch.zeros(n, 8))
    assert sum(tspmm.launch_counts.values()) == 0  # the plain version never counts
