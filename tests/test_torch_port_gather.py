"""The gather-ring probe's plain version against the JAX package's Pallas
kernel (``tools/exp_dma_gather.py:56``, run here in Pallas TPU interpret
mode) and against a loop over the port's stated contract; the wrapper
refuses anything but a CUDA tensor.

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
    gather_ring,
    gather_ring_reference,
    last_positions,
)

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
