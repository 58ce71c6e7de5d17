"""The rewire's fused route on the CPU, where ``ops/sddmm.py`` runs the
plain versions of its kernels: bit-equal to the block-by-block sweep.

Where N and the row block are multiples of 128, ``augment/rewire.py::_sweep``
takes the segment extrema of every swept row at once
(``segment_extrema``), the chosen segments' values per group of blocks
(``segment_values``) and ``hier_topk``'s two stages between them; else it
sweeps block by block (``_sweep_blocks``). On aligned trees (b = 128, fanouts
(2, 2): N = 896; (3, 2): N = 1,280) both must give the same picks in the
same order, the same values to the bit, edge masks and extra masks; on
exact-arithmetic rows (every similarity a multiple of 0.25, exact zeros
and, negated, -0.0: ties everywhere) and on random rows. Split block ranges
merged in order must give one sweep's carries. On the same aligned trees
the fused route must give the JAX package's ``topk_rewire_tree`` bit for
bit (its parity tests in ``test_torch_port_rewire.py`` use unaligned trees,
which the block sweep takes). The card's kernels are held to these plain
versions by ``tests/test_torch_port_gpu.py``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import exact_rows
from noise_gnn_tpu.augment import rewire as jrw
from noise_gnn_tpu.ops import tree_agg as jtree
from noise_gnn_tpu_torch.augment import rewire
from noise_gnn_tpu_torch.ops import sddmm
from noise_gnn_tpu_torch.ops.tree_agg import TreeTopo
from noise_gnn_tpu_torch.utils import profiling

torch.set_num_threads(1)

B = 128


def _rows(kind: str, n: int, d: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    if kind == "random":
        return torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    h = exact_rows(rng, n, d, 24)
    h[rng.random(n) < 0.3] *= -1  # zeros of both signs
    h[rng.random(n) < 0.02] = -0.0  # zero rows: every cosine a signed zero
    return torch.from_numpy(h)


def _tree(fanouts, kind: str, seed: int, d: int = 16):
    n = B * int(np.sum(np.cumprod((1,) + tuple(fanouts))))
    rng = np.random.default_rng(seed + 100)
    topo = TreeTopo(B, fanouts, torch.from_numpy(rng.random(n - B) < 0.8))
    return _rows(kind, n, d, seed), topo


def _topos(out):
    return [[t.edge_mask, t.extra_src, t.extra_dst, t.extra_mask] for t in out if t is not None]


def _bits(c):
    return [c[0].view(torch.int32), c[1], c[2]]


@pytest.fixture
def blocks_only(monkeypatch):
    """Runs ``topk_rewire_tree`` with the block sweep on every tree."""
    def use():
        monkeypatch.setattr(rewire, "_sweep_fused", rewire._sweep_blocks)
    return use


@pytest.mark.parametrize("kind", ["exact", "random"])
@pytest.mark.parametrize("neg", [True, False])
@pytest.mark.parametrize("block", [128, 256, 2048])
@pytest.mark.parametrize("fanouts", [(2, 2), (3, 2)])
def test_fused_route_matches_block_sweep(fanouts, block, neg, kind, blocks_only):
    """Carries (values to the bit, rows, cols, order) and the rewired
    topologies (edge masks, extra edges and masks) of both routes."""
    h, topo = _tree(fanouts, kind, seed=len(fanouts) * 7 + block)
    hn, k2, _, _, pos_keep = rewire._plan(h, topo, 0.1)
    nb = -(-topo.num_nodes // min(block, topo.num_nodes))
    blk = min(block, topo.num_nodes)
    want = rewire._sweep_blocks(hn, topo, pos_keep, k2, range(nb), blk, neg)
    got = rewire._sweep_fused(hn, topo, pos_keep, k2, range(nb), blk, neg)
    assert (want[1] is None) == (got[1] is None) == (not neg)
    for w, g in zip(want, got):
        if w is not None:
            for a, b in zip(_bits(w), _bits(g)):
                assert torch.equal(a, b)
    fused = _topos(rewire.topk_rewire_tree(h, topo, 0.1, block=block, neg=neg))
    blocks_only()
    plain = _topos(rewire.topk_rewire_tree(h, topo, 0.1, block=block, neg=neg))
    assert len(fused) == len(plain) == (2 if neg else 1)
    for tf, tp in zip(fused, plain):
        for a, b in zip(tf, tp):
            assert torch.equal(a, b)


@functools.lru_cache(maxsize=None)
def _j_rewire_tree(fanouts, block):
    """One jit of the JAX tree rewire per tree shape and block size."""
    def run(h, mask):
        return [(t.edge_mask, t.extra_src, t.extra_dst, t.extra_mask) for t in
                jrw.topk_rewire_tree(h, jtree.TreeTopo(B, fanouts, mask), 0.1, block=block)]
    return jax.jit(run)


@pytest.mark.parametrize("kind", ["exact", "random"])
@pytest.mark.parametrize("block", [256, 2048])
@pytest.mark.parametrize("fanouts", [(2, 2), (3, 2)])
def test_fused_route_matches_the_jax_package(fanouts, block, kind, monkeypatch):
    """The fused route's rewired topologies (edge masks, extra edges in
    their order, extra masks) are the JAX package's, both signs with neg on
    and the pos one with neg off."""
    h, topo = _tree(fanouts, kind, seed=block + len(fanouts))
    want = _j_rewire_tree(fanouts, block)(jnp.asarray(h.numpy()),
                                          jnp.asarray(topo.edge_mask.numpy()))
    monkeypatch.setattr(rewire, "_sweep_blocks", None)  # the fused route only
    for neg in (True, False):
        got = _topos(rewire.topk_rewire_tree(h, topo, 0.1, block=block, neg=neg))
        assert len(got) == (2 if neg else 1)
        for wt, gt in zip(want, got):
            for w, g in zip(wt, gt):
                w = np.asarray(w)
                np.testing.assert_array_equal(g.numpy().astype(w.dtype), w)


@pytest.mark.parametrize("kind", ["exact", "random"])
@pytest.mark.parametrize("split", [1, 3, 5])
def test_split_block_ranges_merge_to_one_sweep(split, kind):
    """Two contiguous block ranges (as two ranks sweep them) through the
    fused route, merged in order by ``merge_carries``: the one sweep's
    carries, bit for bit; an empty range included (split 5)."""
    h, topo = _tree((3, 2), kind, seed=split)
    block = 256
    hn, k2, _, _, pos_keep = rewire._plan(h, topo, 0.1)
    one = rewire._sweep_blocks(hn, topo, pos_keep, k2, range(5), block, True)
    parts = [rewire.rewire_carries(h, topo, 0.1, block, r)
             for r in (range(0, split), range(split, 5))]
    for j in range(2):
        merged = rewire.merge_carries([p[j] for p in parts], k2)
        for a, b in zip(_bits(one[j]), _bits(merged)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("aligned", [True, False])
def test_route_follows_the_shape_and_counts(aligned, monkeypatch):
    """Whole 128-row tiles take the fused route, else the block sweep; the
    ``rewire_fused`` counter, on while a profiler runs, reads the share of
    swept blocks the fused route took: 100% or 0%."""
    b = B if aligned else 16
    n = b * 10
    rng = np.random.default_rng(3)
    topo = TreeTopo(b, (3, 2), torch.from_numpy(rng.random(n - b) < 0.8))
    h = _rows("random", n, 16, 3)
    ran = []
    for name in ("_sweep_fused", "_sweep_blocks"):
        real = getattr(rewire, name)
        monkeypatch.setattr(rewire, name,
                            lambda *a, _r=real, _n=name: ran.append(_n) or _r(*a))
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        rewire.topk_rewire_tree(h, topo, 0.1, block=256)
        spans = profiling.spans()
    c = profiling.counts()["rewire_fused"]
    profiling.reset()
    assert ran == ["_sweep_fused" if aligned else "_sweep_blocks"]
    assert c["slots"] == -(-n // 256) and c["hits"] == (c["slots"] if aligned else 0)
    assert ("ngt.rewire_sim" in spans) == aligned


@pytest.mark.parametrize("t_lo,t_hi,t,band", [(0, 7, 7, 3), (0, 10, 10, 3), (2, 6, 10, 3),
                                              (9, 10, 10, 3), (0, 3, 12, 3), (0, 24, 24, 8),
                                              (5, 22, 40, 8), (17, 150, 200, 8),
                                              (0, 1244, 1244, 8)])
def test_tile_list_covers_every_row_segment_once(t_lo, t_hi, t, band):
    """Each (row tile in range, segment) is filled exactly once: by a tile's
    rows (I, J), or by its columns where J lies in the range and J != I;
    the list is band-major. The last case is the TE cell's whole range
    (774,390 tiles), counted only."""
    count = sddmm.tile_count(t_lo, t_hi, t, band)
    if t > 100:
        r = t_hi - t_lo
        assert count == r * (r + 1) // 2 + r * (t - r)
        ks = [0, 1, count // 3, count // 2, count - 2, count - 1]
        assert len({sddmm.tile_of(k, t_lo, t_hi, t, band) for k in ks}) == len(ks)
        return
    tiles = [sddmm.tile_of(k, t_lo, t_hi, t, band) for k in range(count)]
    seen = {}
    for i, j in tiles:
        seen[(i, j)] = seen.get((i, j), 0) + 1
        if j != i and t_lo <= j < t_hi:
            seen[(j, i)] = seen.get((j, i), 0) + 1
    assert seen == {(i, j): 1 for i in range(t_lo, t_hi) for j in range(t)}
    bands = [(i - t_lo) // band for i, _ in tiles]
    assert bands == sorted(bands)


def test_value_chunks_cut_sorted_entries_by_column_tile():
    """Every entry in exactly one chunk of at most 64 consecutive sorted
    entries of one column tile; the unused chunks are empty."""
    rng = np.random.default_rng(0)
    segs = torch.from_numpy(rng.integers(0, 9, 700))
    segs[:150] = 4  # a tile of more than two chunks
    order, starts, lens = sddmm.value_chunks(segs, 9, chunk=64)
    s = segs[order]
    assert torch.equal(s, torch.sort(segs, stable=True).values)
    covered = torch.zeros(700, dtype=torch.int64)
    for a, m in zip(starts.tolist(), lens.tolist()):
        if m:
            assert 0 < m <= 64 and int(s[a:a + m].unique().numel()) == 1
            covered[a:a + m] += 1
    assert bool((covered == 1).all())


def test_plain_extrema_and_values_are_the_block_segments():
    """``segment_extrema`` and ``segment_values`` on the CPU: the segment
    maxima of the sweep's excluded blocks (sim and -sim) and their rows."""
    h, topo = _tree((2, 2), "exact", seed=11)
    hn, k2, _, _, pos_keep = rewire._plan(h, topo, 0.1)
    n, block = topo.num_nodes, 256
    excl = rewire._exclusions(topo, pos_keep)
    ext, _ = sddmm.segment_extrema(hn, range(1, 4), block, excl)
    hp = sddmm.padded_rows(hn, block)
    for j, i in enumerate(range(1, 4)):
        s = sddmm.exclude_(hp[i * block:(i + 1) * block] @ hn.T, i * block, excl)
        segs = s.view(-1, 128)
        assert torch.equal(ext[j * block:(j + 1) * block].reshape(-1).view(torch.int32),
                           sddmm._segment_max(segs).view(torch.int32))
        si = torch.tensor([[0, 5, int(segs.shape[0]) - 1]])
        (vals,) = sddmm.segment_values(hn, range(i, i + 1), block, [(si, excl, False)])
        assert torch.equal(vals[0].view(torch.int32), segs[si[0]].view(torch.int32))
    assert bool(torch.isinf(ext[n - block:]).all())  # rows past N (ext starts at row 256)


def test_stable_topk_takes_rows_on_their_own():
    """Along the last axis each row is the 1-D ``stable_topk`` of itself."""
    rng = np.random.default_rng(4)
    x = (rng.integers(-3, 4, (5, 300)) * 0.5).astype(np.float32)
    x[rng.random(x.shape) < 0.1] = -0.0
    v, i = sddmm.stable_topk(torch.from_numpy(x), 17)
    for r in range(5):
        vr, ir = sddmm.stable_topk(torch.from_numpy(x[r]), 17)
        assert torch.equal(i[r], ir) and torch.equal(v[r].view(torch.int32),
                                                     vr.view(torch.int32))


@pytest.mark.parametrize("bad", ["unaligned", "dtype", "strided", "block"])
def test_wrappers_refuse_what_the_kernels_do_not_take(bad):
    """N and the block must be whole 128-row tiles, ``hn`` f32 and
    contiguous."""
    hn = torch.zeros((256, 8))
    excl = torch.full((256,), -1, dtype=torch.int32)
    block = 128
    if bad == "unaligned":
        hn, excl = torch.zeros((200, 8)), excl[:200]
    elif bad == "dtype":
        hn = hn.double()
    elif bad == "strided":
        hn = torch.zeros((256, 16))[:, ::2]
    else:
        block = 100
    with pytest.raises((TypeError, ValueError)):
        sddmm.segment_extrema(hn, range(1), block, excl)
    with pytest.raises((TypeError, ValueError)):
        sddmm.segment_values(hn, range(1), block, [(torch.zeros((1, 1), dtype=torch.int64),
                                                    excl, False)])
