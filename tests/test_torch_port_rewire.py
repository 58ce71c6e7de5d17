"""The rewiring ops against the JAX package on the CPU: the stable top-k,
``hier_topk`` and ``blockwise_topk`` (same values and indices, ties and
signed zeros included), and ``topk_rewire`` / ``topk_rewire_tree`` (same
edges and masks).

Exact-arithmetic embeddings: every row has four nonzero entries of +-0.5,
so every norm is exactly 1 and every similarity a multiple of 0.25 in any
order of summation. Both packages then see the same numbers, and rows drawn
from a small pool (as the sampled tree repeats node ids) make ties common:
the picks must agree bit for bit, order included.

Random float embeddings are a well-conditioned input, as the deterministic
trees of the epoch tests are: the two packages' similarities may differ in
the last bits, so the test first checks, in float64, that the k-th and the
(k+1)-th candidate of every selection are more than 1e-5 apart. Then the
picked sets must agree (their order among near-equal values may not)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noise_gnn_tpu.augment import rewire as jrw
from noise_gnn_tpu.ops import sddmm as jsd
from noise_gnn_tpu.ops import tree_agg as jtree
from noise_gnn_tpu.ops.sampler import flat_edge_index
from noise_gnn_tpu_torch.augment import rewire as trw
from noise_gnn_tpu_torch.ops import sddmm as tsd
from noise_gnn_tpu_torch.ops import tree_agg as ttree

torch.set_num_threads(1)

B, FANOUTS, D = 8, (3, 2), 8
N_TREE = B * (1 + 3 + 6)


def exact_rows(rng, n, d=D, pool=None):
    """[n, d] f32 rows with four entries of +-0.5 and the rest 0 (unit
    norm); with ``pool``, drawn from that many distinct rows."""
    m = pool or n
    rows = np.zeros((m, d), np.float32)
    for r in range(m):
        cols = rng.choice(d, 4, replace=False)
        rows[r, cols] = rng.choice([-0.5, 0.5], 4)
    return rows if pool is None else rows[rng.integers(0, m, n)]


def tied_values(rng, n):
    """Multiples of 0.25 with signed zeros and -inf: mostly ties."""
    v = rng.integers(-4, 5, n).astype(np.float32) * 0.25
    v[rng.random(n) < 0.1] = -0.0
    v[rng.random(n) < 0.05] = -np.inf
    return v


# ---------------------------------------------------------------- top-k


@pytest.mark.parametrize("n,k", [pytest.param(300, 7, marks=pytest.mark.slow),
                                 pytest.param(5000, 40, marks=pytest.mark.slow),
                                 (5000, 2000), (4096, 3)])
def test_stable_and_hier_topk_match(n, k):
    """``stable_topk`` is ``jax.lax.top_k``; ``hier_topk`` on arrays past
    4 * seg (the hierarchy, not the plain top-k) gives the JAX indices."""
    x = tied_values(np.random.default_rng(n + k), n)
    jv, ji = jax.jit(jax.lax.top_k, static_argnums=1)(jnp.asarray(x), k)
    tv, ti = tsd.stable_topk(torch.from_numpy(x), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy().view(np.int32), np.asarray(jv).view(np.int32))
    for seg in (16, 128):
        jv, ji = jax.jit(jsd.hier_topk, static_argnums=(1, 2))(jnp.asarray(x), k, seg)
        tv, ti = tsd.hier_topk(torch.from_numpy(x), k, seg=seg)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy().view(np.int32), np.asarray(jv).view(np.int32))


def test_segment_max_takes_positive_zero():
    """A segment whose largest entries are zeros of both signs has the
    maximum +0.0, as XLA's reduction (and top-k order) has it."""
    segs = torch.tensor([[-0.0, 0.0, -1.0], [0.0, -0.0, -2.0], [-0.0, -0.0, -3.0]])
    m = tsd._segment_max(segs)
    assert m.numpy().view(np.int32).tolist() == np.array([0.0, 0.0, -0.0],
                                                         np.float32).view(np.int32).tolist()
    # every row: the maximum of the floats' total-order keys
    vals = np.array([0.0, -0.0, 1.0, -1.0, -np.inf, np.inf, 0.25, -0.25, 3e-39, -3e-39],
                    np.float32)
    segs = torch.from_numpy(np.random.default_rng(0).choice(vals, (4000, 5)))
    key = tsd.order_key(segs).amax(dim=1)
    want = key ^ ((key >> 31) & 0x7FFFFFFF)  # order_key is its own inverse
    assert torch.equal(tsd._segment_max(segs).view(torch.int32), want)


@pytest.mark.parametrize("largest", [pytest.param(True, marks=pytest.mark.slow), False])
def test_blockwise_topk_matches(largest):
    """Over the implicit h h^T of exact rows (ties everywhere), with the
    adjacency-and-diagonal mask, in blocks that do not divide N."""
    rng = np.random.default_rng(3)
    n, k = 70, 24
    h = exact_rows(rng, n, pool=12)
    ei = rng.integers(0, n, (2, 150)).astype(np.int32)
    valid = rng.random(150) < 0.8
    jv, jr, jc = jax.jit(lambda h, ei, valid: jsd.blockwise_topk(
        h, k, jrw._adj_mask_fn(ei, valid, n), largest=largest, block=16))(
            jnp.asarray(h), jnp.asarray(ei), jnp.asarray(valid))
    tv, tr, tc = tsd.blockwise_topk(torch.from_numpy(h), k,
                                    trw._adj_mask_fn(torch.from_numpy(ei),
                                                     torch.from_numpy(valid), n),
                                    largest=largest, block=16)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


# --------------------------------------------------------------- rewire


@functools.lru_cache(maxsize=None)
def _j_rewire_tree(block):
    """One jit of the JAX tree rewire per block size, shared by the tests."""
    def run(h, mask, k_percent):
        pos, neg = jrw.topk_rewire_tree(h, jtree.TreeTopo(B, FANOUTS, mask), k_percent,
                                        block=block)
        return [(t.edge_mask, t.extra_src, t.extra_dst, t.extra_mask) for t in (pos, neg)]
    return jax.jit(run, static_argnums=2)


def _rewire_tree_both(h, mask, k_percent=0.1, block=32):
    want = _j_rewire_tree(block)(jnp.asarray(h), jnp.asarray(mask), k_percent)
    got = trw.topk_rewire_tree(torch.from_numpy(h),
                               ttree.TreeTopo(B, FANOUTS, torch.from_numpy(mask)),
                               k_percent, block=block)
    got = [(t.edge_mask, t.extra_src, t.extra_dst, t.extra_mask) for t in got]
    return ([[np.asarray(a) for a in t] for t in want],
            [[a.numpy() for a in t] for t in got])


@pytest.mark.parametrize("pool,block", [(6, 32), (20, 32),
                                        pytest.param(None, 2048, marks=pytest.mark.slow)])
def test_topk_rewire_tree_exact_matches(pool, block):
    """Same keep-masks and the same extra edges in the same order, on exact
    rows with many repeats; several row blocks (32) and one (2048)."""
    rng = np.random.default_rng(pool or 0)
    h = exact_rows(rng, N_TREE, pool=pool)
    mask = rng.random(N_TREE - B) < 0.8
    want, got = _rewire_tree_both(h, mask, block=block)
    for w, g in zip(want, got):
        for a, b in zip(w, g):
            np.testing.assert_array_equal(b, a.astype(b.dtype))


def _gap_at(values: np.ndarray, k: int) -> float:
    """The distance between the k-th and the (k+1)-th largest finite value."""
    v = np.sort(values[np.isfinite(values)])[::-1]
    return float(v[k - 1] - v[k]) if v.shape[0] > k else np.inf


def test_topk_rewire_tree_random_matches():
    """Random float rows, with every selection's boundary checked to be
    more than 1e-5 wide in float64: the same keep-masks and the same sets
    of extra edges."""
    rng = np.random.default_rng(11)
    h = rng.standard_normal((N_TREE, 16)).astype(np.float32)
    mask = rng.random(N_TREE - B) < 0.8
    want, got = _rewire_tree_both(h, mask)
    k2 = 2 * int(N_TREE * 0.1)
    hn = h.astype(np.float64) / np.linalg.norm(h.astype(np.float64), axis=1, keepdims=True)
    sim = hn @ hn.T
    src, dst = flat_edge_index(B, FANOUTS)
    edge_sim = sim[src, dst]
    gaps = [_gap_at(np.where(mask, edge_sim, -np.inf), k2),
            _gap_at(np.where(mask, -edge_sim, -np.inf), k2)]
    for sign, keep in ((1.0, want[0][0]), (-1.0, mask)):
        s = sign * sim
        np.fill_diagonal(s, -np.inf)
        s[src[keep], dst[keep]] = -np.inf
        gaps.append(_gap_at(s.reshape(-1), k2))
    assert min(gaps) > 1e-5, gaps
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[3], w[3])
        assert sorted(zip(g[1].tolist(), g[2].tolist())) == sorted(
            zip(w[1].tolist(), w[2].tolist()))


def test_topk_rewire_edge_list_matches():
    """The edge-list ``topk_rewire`` on a random graph over exact rows: the
    same edges and masks, order included."""
    rng = np.random.default_rng(5)
    n, e = 60, 140
    h = exact_rows(rng, n, pool=15)
    ei = rng.integers(0, n, (2, e)).astype(np.int32)
    mask = rng.random(e) < 0.9
    want = jax.jit(lambda h, ei, mask: jrw.topk_rewire(h, ei, mask, 0.1, block=16))(
        jnp.asarray(h), jnp.asarray(ei), jnp.asarray(mask))
    got = trw.topk_rewire(torch.from_numpy(h), torch.from_numpy(ei), torch.from_numpy(mask),
                          0.1, block=16)
    for (we, wm), (ge, gm) in zip(want, got):
        np.testing.assert_array_equal(ge.numpy(), np.asarray(we))
        np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))


def test_tree_rewire_equals_edge_list_rewire():
    """The tree form picks what the edge-list form picks on the tree's
    equivalent edge list (the JAX package's own contract), in the port."""
    rng = np.random.default_rng(8)
    h = torch.from_numpy(exact_rows(rng, N_TREE, pool=10))
    mask = torch.from_numpy(rng.random(N_TREE - B) < 0.8)
    ei = torch.from_numpy(flat_edge_index(B, FANOUTS))
    (pe, pm), (ne, nm) = trw.topk_rewire(h, ei, mask, 0.1, block=2048)
    pos, neg = trw.topk_rewire_tree(h, ttree.TreeTopo(B, FANOUTS, mask), 0.1, block=2048)
    e = ei.shape[1]
    for (edges, m), t in (((pe, pm), pos), ((ne, nm), neg)):
        assert torch.equal(m[:e], t.edge_mask)
        assert sorted(zip(edges[0, e:].tolist(), edges[1, e:].tolist())) == sorted(
            zip(t.extra_src.tolist(), t.extra_dst.tolist()))
