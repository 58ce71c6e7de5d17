"""The gather-ring probe's plain version against the JAX package's Pallas
kernel (``tools/exp_dma_gather.py:56``, run here in Pallas TPU interpret
mode) and against a loop over the port's stated contract; the wrapper
refuses anything but a CUDA tensor; the kernel's cluster-size rule, its
grid order and the wrapper's memo of ids found in range.

The TPU kernel starts the copy into a slot before it waits for the slot's
previous copy, so its result is defined only where each slot is written
once: depth == chunk. There the kernel's returned block (ring slot 0 of the
last grid step) must be the block the plain version puts there. The kernel
returns the block's sum, so two inputs are used: blocks filled with their
own id (the sum names the block exactly) and random normal blocks (sums
agree to f32 rounding, rtol 1e-6)."""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from noise_gnn_tpu_torch.ops.gather_ring import (
    CLUSTER_SIZES,
    _check_range,
    block_coords,
    cluster_size,
    gather_ring,
    gather_ring_reference,
    last_positions,
)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
E, P, F, NBLK = 64, 2, 128, 40


@pytest.fixture(scope="module")
def tool():
    spec = importlib.util.spec_from_file_location(
        "exp_dma_gather", ROOT / "tools" / "exp_dma_gather.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ring_loop(x3, idx, depth, chunk, passes):
    """The contract, one copy at a time: slot i % depth takes x3[idx[c*chunk + i]]."""
    nchunks = idx.shape[0] // chunk
    out = np.zeros((passes, nchunks, depth) + x3.shape[1:], x3.dtype)
    for p in range(passes):
        for c in range(nchunks):
            for i in range(chunk):
                out[p, c, i % depth] = x3[idx[c * chunk + i]]
    return out


@pytest.mark.parametrize("depth", [4, 8, 16])
def test_plain_matches_pallas_kernel_interpret(tool, monkeypatch, depth):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=pltpu.InterpretParams()))
    monkeypatch.setattr(tool, "E", E)
    monkeypatch.setattr(tool, "P", P)
    rng = np.random.default_rng(depth)
    idx = rng.integers(0, NBLK, E).astype(np.int32)
    chunk = depth
    by_id = np.broadcast_to(np.arange(NBLK, dtype=np.float32)[:, None, None],
                            (NBLK, 8, F)).copy()
    normal = rng.standard_normal((NBLK, 8, F)).astype(np.float32)
    for x3 in (by_id, normal):
        fn = tool.make(depth, chunk, F, jnp.asarray(x3))
        got_tpu = float(fn(jnp.asarray(idx), jnp.asarray(x3)))
        ring = gather_ring_reference(torch.from_numpy(x3), torch.from_numpy(idx), depth,
                                     chunk, P)
        want = ring[-1, -1, 0]  # what the TPU kernel returns
        if x3 is by_id:
            assert got_tpu == 8 * F * float(idx[(E // chunk - 1) * chunk])
            assert float(want.sum()) == got_tpu
        else:
            np.testing.assert_allclose(float(want.double().sum()), got_tpu, rtol=1e-6)


@pytest.mark.parametrize("depth,chunk", [(1, 1), (1, 8), (2, 8), (3, 16), (5, 16), (7, 64)])
def test_plain_matches_contract_loop(depth, chunk):
    """depth < chunk: each slot is rewritten; the plain version keeps the
    last copy into each, exactly (bit-equal)."""
    rng = np.random.default_rng(chunk * 10 + depth)
    x3 = rng.standard_normal((50, 8, 12)).astype(np.float32)
    idx = rng.integers(0, 50, chunk * 4).astype(np.int32)
    got = gather_ring_reference(torch.from_numpy(x3), torch.from_numpy(idx), depth, chunk, 3)
    np.testing.assert_array_equal(got.numpy(), _ring_loop(x3, idx, depth, chunk, 3))
    assert last_positions(depth, chunk) == [
        max(i for i in range(chunk) if i % depth == s) for s in range(depth)]


def test_wrapper_refuses_cpu_and_bad_arguments():
    x3 = torch.zeros((10, 8, 16))
    idx = torch.zeros(32, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA card only"):
        gather_ring(x3, idx, 4, 8, 2)
    with pytest.raises(ValueError, match="depth <= chunk"):
        gather_ring_reference(x3, idx, 9, 8, 2)
    with pytest.raises(ValueError, match="multiple of chunk"):
        gather_ring_reference(x3, idx[:30], 2, 8, 2)
    with pytest.raises(ValueError, match="int32"):
        gather_ring_reference(x3, idx.long(), 2, 8, 2)


def _resident(per_cluster):
    """``resident(C)`` for clusters-at-once counts by C (0: does not fit)."""
    return lambda c: per_cluster.get(c, 0) * c


@pytest.mark.parametrize("passes,blocks,per_cluster,want", [
    (16, 1024, {1: 1056, 2: 528, 4: 248, 8: 124}, 1),  # the grid fits at once
    (16, 1024, {1: 660, 2: 396, 4: 186, 8: 92}, 8),
    (16, 1024, {1: 132, 2: 66, 4: 30, 8: 15}, 8),
    (12, 1024, {1: 132, 2: 66, 4: 30, 8: 15}, 4),  # 8 does not divide 12
    (2, 1024, {1: 132, 2: 66, 4: 30, 8: 15}, 2),
    (3, 1024, {1: 132, 2: 66, 4: 30, 8: 15}, 1),
    (16, 1024, {1: 132, 2: 66, 4: 30}, 4),  # no cluster of 8 fits
    (16, 1024, {2: 1}, 2),  # only with its ids split over 2 blocks
    (16, 1024, {}, 0),  # nothing fits
])
def test_cluster_size_rule(passes, blocks, per_cluster, want):
    assert cluster_size(passes, blocks, _resident(per_cluster)) == want
    assert want == 0 or passes % want == 0


def test_cluster_size_is_largest_that_divides_and_fits():
    """Past one wave, the largest of 8, 4, 2, 1 that divides passes and fits."""
    for passes in range(1, 33):
        for limit in CLUSTER_SIZES:
            fits = {c: 15 for c in CLUSTER_SIZES if c <= limit}
            got = cluster_size(passes, 10**6, _resident(fits))
            assert got == max(c for c in CLUSTER_SIZES if passes % c == 0 and c <= limit)
    assert cluster_size(3, 10**6, _resident({c: 15 for c in CLUSTER_SIZES})) == 1


@pytest.mark.parametrize("passes,nchunks,csize", [
    (16, 4, 8), (16, 3, 4), (8, 5, 8), (2, 5, 2), (3, 4, 1), (4, 1, 4), (1, 7, 1)])
def test_block_coords_chunk_major_clusters(passes, nchunks, csize):
    """Every (p, c) once; cluster k holds passes q * C .. q * C + C - 1 of one
    chunk, rank r being pass q * C + r."""
    coords = block_coords(passes, nchunks, csize)
    assert sorted((p, c) for p, c, _ in coords) == [
        (p, c) for p in range(passes) for c in range(nchunks)]
    for k in range(len(coords) // csize):
        cluster = coords[k * csize:(k + 1) * csize]
        assert len({c for _, c, _ in cluster}) == 1
        q = cluster[0][0] // csize
        assert [(p, r) for p, _, r in cluster] == [(q * csize + r, r) for r in range(csize)]


def test_range_check_memo_sees_in_place_change():
    """The wrapper checks an unchanged ids tensor once; a change in place
    (or another tensor) is checked again."""
    idx = torch.arange(8, dtype=torch.int32)
    _check_range(idx, 8)
    _check_range(idx, 8)  # memo
    with pytest.raises(ValueError, match="outside"):
        _check_range(idx, 7)  # another table size
    idx += 10
    with pytest.raises(ValueError, match="outside"):
        _check_range(idx, 8)
    with pytest.raises(ValueError, match="outside"):
        _check_range(idx.clone() - 20, 8)
