"""The port's profiling, memory and noise helpers against the JAX
package's.

A profile started and stopped on the CPU writes a Chrome trace that names
the traced region and the program's own spans; the host edge and feature
noise draw the JAX package's numbers bit for bit from the same numpy seed;
the on-device label flip is held to the noise matrix statistically (its
draws come from a ``torch.Generator``, so they cannot equal
``jax.random``'s)."""

import json

import numpy as np
import pytest
import torch

from noise_gnn_tpu import noise as jnoise
from noise_gnn_tpu_torch import noise as tnoise
from noise_gnn_tpu_torch.train import steps
from noise_gnn_tpu_torch.utils import memory, profiling

torch.set_num_threads(1)


def test_profile_round_trip_on_cpu(tmp_path):
    w = torch.ones(4, 3, requires_grad=True)
    state = steps.TrainState({"convs": [{"w": w}]}, torch.optim.Adam([w], lr=0.1))
    profiling.start_profile(str(tmp_path))
    with pytest.raises(RuntimeError, match="already"):
        profiling.start_profile(str(tmp_path))
    with profiling.trace("step"):
        torch.ones(64).cumsum(0)
        steps._step((state,), (w * w).sum())
    path = profiling.stop_profile()
    profiling.reset()
    names = {ev.get("name") for ev in json.loads(open(path).read())["traceEvents"]}
    assert {"step", "ngt.backward", "ngt.optimizer"} <= names
    with pytest.raises(RuntimeError, match="no profile"):
        profiling.stop_profile()


def test_memory_helpers():
    assert memory.configure_malloc() in (True, False)
    memory.warm_heap(1 << 20)
    memory.warm_heap(0)


def test_edge_and_feature_noise_match_jax():
    rng = np.random.default_rng(0)
    n = 300
    a, b = rng.integers(0, n, (2, 900))
    keep = a != b
    ei = np.stack([np.concatenate([a[keep], b[keep]]), np.concatenate([b[keep], a[keep]])])
    ei = np.unique(ei, axis=1).astype(np.int32)  # undirected, deduplicated
    for prob in (0.0, 0.4):
        got = tnoise.add_edge_noise(ei, n, prob, np.random.default_rng(5))
        want = jnoise.add_edge_noise(ei, n, prob, np.random.default_rng(5))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    x = rng.standard_normal((50, 8)).astype(np.float32)
    got = tnoise.add_feature_noise(x, 0.3, 0.1, 0.2, np.random.default_rng(6))
    want = jnoise.add_feature_noise(x, 0.3, 0.1, 0.2, np.random.default_rng(6))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_flip_label_device_frequencies():
    """1e5 draws: each row's frequencies within 4 sigma of the noise
    matrix's row (a zero entry is never drawn)."""
    c, n = 5, 100_000
    _, mat = tnoise.flip_label(np.zeros(1, np.int64), c, "rand_pair", 0.3,
                               np.random.default_rng(2))
    labels = torch.arange(n) % c
    out = tnoise.flip_label_device(torch.Generator().manual_seed(3), labels,
                                   torch.from_numpy(mat))
    assert out.shape == (n,) and out.dtype == torch.int64
    counts = np.zeros((c, c))
    np.add.at(counts, (labels.numpy(), out.numpy()), 1)
    rows = counts.sum(axis=1, keepdims=True)
    sigma = np.sqrt(mat * (1 - mat) / rows)
    assert (np.abs(counts / rows - mat) <= 4 * sigma).all()
