"""The port's native graph runtime and its small host and segment helpers
against the JAX package.

The port builds its own copy of the C++ runtime (``noise_gnn_tpu_torch/
csrc/graph_runtime.cpp``); every entry point agrees with the JAX
package's library bit for bit, and with the numpy plain versions. The JAX
library is built from a copy of its source in a temporary directory, so
this file never waits on (or races) another worker's build of it. A failed
build raises: nothing falls back to numpy."""

import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import noise_gnn_tpu.native as jnative
from noise_gnn_tpu.graph.containers import pad_edges as j_pad_edges
from noise_gnn_tpu.ops import scatter as jscatter
from noise_gnn_tpu.ops.sampler import TreeBatch as JTreeBatch
from noise_gnn_tpu_torch import native
from noise_gnn_tpu_torch.graph.containers import CSRGraph, pad_edges
from noise_gnn_tpu_torch.ops import scatter as tscatter
from noise_gnn_tpu_torch.ops.sampler import sample_khop_tree

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def jax_native(tmp_path, monkeypatch):
    """The JAX package's native module, its library built afresh from a
    copy of ``csrc/graph_runtime.cpp`` in ``tmp_path``."""
    shutil.copy(ROOT / "csrc" / "graph_runtime.cpp", tmp_path / "graph_runtime.cpp")
    monkeypatch.setattr(jnative, "_SRC_DIR", str(tmp_path))
    monkeypatch.setattr(jnative, "_LIB", None)
    monkeypatch.setattr(jnative, "_TRIED", False)
    assert jnative.available()
    return jnative


def test_native_matches_jax_and_plain(jax_native):
    rng = np.random.default_rng(0)
    n, e = 3000, 40_000
    src = rng.integers(0, n, e).astype(np.int32)
    dst = (n * rng.random(e) ** 2).astype(np.int32)  # skewed rows, some empty
    indptr, indices = native.coo_to_csr(src, dst, n)
    for want in (jax_native.coo_to_csr(src, dst, n), native.coo_to_csr_reference(src, dst, n)):
        np.testing.assert_array_equal(indptr, want[0])
        np.testing.assert_array_equal(indices, want[1])
    assert indptr.dtype == np.int64 and indices.dtype == np.int32
    rows = native.expand_rows(indptr, n)
    np.testing.assert_array_equal(rows, jax_native.expand_rows(indptr, n))
    np.testing.assert_array_equal(rows, native.expand_rows_reference(indptr, n))
    frontier = rng.integers(0, n, 500).astype(np.int32)
    fmask = rng.random(500) < 0.8
    for fm in (None, fmask):
        got = native.sample_hop(indptr, indices, frontier, 4, 7, fm)
        want = jax_native.sample_hop(indptr, indices, frontier, 4, 7, fm)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert native.hash_i32(indices) == jax_native.hash_i32(indices)
    assert native.hash_i32(src[:500]) == native.hash_i32_reference(src[:500])
    part = (np.arange(n) % 4).astype(np.int32)
    got = native.label_prop(src, dst, n, 4, part.copy(), iters=3)
    np.testing.assert_array_equal(got, jax_native.label_prop(src, dst, n, 4, part.copy(), 3))


def test_failed_build_raises(monkeypatch):
    """Pointed at a missing compiler, the runtime's first use raises with
    the cause, and so does building a CSR: no numpy fallback runs."""
    monkeypatch.setattr(native, "CXX", "/nonexistent/bin/g++")
    monkeypatch.setattr(native, "_LIB", None)
    ei = np.asarray([[0, 1], [1, 0]], np.int32)
    with pytest.raises(RuntimeError, match="nonexistent"):
        native.coo_to_csr(ei[0], ei[1], 2)
    with pytest.raises(RuntimeError, match="nonexistent"):
        CSRGraph.from_coo(ei, 2)


def test_native_rejects_bad_ids():
    """Ids the C code would index out of bounds with raise before the call."""
    with pytest.raises(ValueError, match="outside"):
        native.coo_to_csr(np.asarray([0, 1]), np.asarray([0, 2]), 2)
    with pytest.raises(ValueError, match="shape"):
        native.coo_to_csr(np.asarray([0, 1]), np.asarray([0]), 2)
    indptr = np.asarray([0, 1, 2])
    with pytest.raises(ValueError, match="expected"):
        native.expand_rows(indptr, 3)
    with pytest.raises(ValueError, match="outside"):
        native.sample_hop(indptr, np.asarray([1, 0]), np.asarray([2]), 2, 0)
    with pytest.raises(ValueError, match="outside"):
        native.label_prop(np.asarray([0]), np.asarray([1]), 2, 2, np.asarray([0, 2]))


@pytest.mark.parametrize("e,multiple", [(0, 128), (300, 128), (256, 128), (5, 4)])
def test_pad_edges_matches(e, multiple):
    ei = np.random.default_rng(e).integers(0, 50, (2, e)).astype(np.int32)
    for a, b in zip(pad_edges(ei, multiple), j_pad_edges(ei, multiple)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_segment_mean_max_match():
    """Exactly equal: the values are multiples of 0.25 with small sums, so
    every order of summation gives the same f32 numbers; empty segments and
    fully masked ones give 0, and so does a segment whose max is -inf."""
    rng = np.random.default_rng(1)
    data = (rng.integers(-8, 9, (200, 6)) * 0.25).astype(np.float32)
    data[3, 2] = -np.inf
    ids = rng.integers(0, 40, 200).astype(np.int32)
    ids[ids == 7] = 8  # an empty segment
    mask = rng.random(200) < 0.7
    for m in (None, mask):
        jm = None if m is None else jnp.asarray(m)
        tm = None if m is None else torch.from_numpy(m)
        for jf, tf in ((jscatter.segment_mean, tscatter.segment_mean),
                       (jscatter.segment_max, tscatter.segment_max)):
            if jf is jscatter.segment_mean:
                d = np.where(np.isinf(data), 0.0, data).astype(np.float32)
            else:
                d = data
            want = np.asarray(jax.jit(jf, static_argnums=2)(jnp.asarray(d), jnp.asarray(ids),
                                                             40, jm))
            got = tf(torch.from_numpy(d), torch.from_numpy(ids), 40, tm).numpy()
            np.testing.assert_array_equal(got, want)


def test_num_sub_nodes():
    ei = np.asarray([[1, 2, 3, 0], [0, 0, 0, 1]], np.int32)
    tb = sample_khop_tree(torch.Generator().manual_seed(0), CSRGraph.from_coo(ei, 4),
                          torch.tensor([0, 1, 2]), (2, 3))
    jtb = JTreeBatch(tuple(jnp.asarray(i.numpy()) for i in tb.n_ids),
                     tuple(jnp.asarray(m.numpy()) for m in tb.masks), tb.fanouts, tb.batch_size)
    assert tb.num_sub_nodes == jtb.num_sub_nodes == 3 + 6 + 18 == tb.flat_n_id().shape[0]
