"""Host data of the PyTorch port against the JAX package: synthetic graphs,
load_network (synthetic, npz and the real-format readers), CSR order,
splits, label noise, forget-rate schedules and the pipeline's seed batches
must be EXACTLY equal for the same seed."""

import os

import numpy as np
import pytest
import torch

from noise_gnn_tpu import noise as jnoise
from noise_gnn_tpu.graph import containers as jcont
from noise_gnn_tpu.graph import datasets as jdata
from noise_gnn_tpu.graph import readers as jread
from noise_gnn_tpu.graph import splits as jsplits
from noise_gnn_tpu.losses.schedules import forget_rate_schedule as j_schedule
from noise_gnn_tpu.utils.profiling import tree_edges_per_batch as j_tepb
from noise_gnn_tpu_torch import noise as tnoise
from noise_gnn_tpu_torch.graph import containers as tcont
from noise_gnn_tpu_torch.graph import datasets as tdata
from noise_gnn_tpu_torch.graph import readers as tread
from noise_gnn_tpu_torch.graph import splits as tsplits
from noise_gnn_tpu_torch.losses.schedules import forget_rate_schedule as t_schedule
from noise_gnn_tpu_torch.utils.profiling import tree_edges_per_batch as t_tepb

torch.set_num_threads(1)

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                   "real_formats")

_FIELDS = ("x", "y", "edge_index", "train_mask", "val_mask", "test_mask", "yhn")


def assert_graph_equal(a, b):
    assert a.num_classes == b.num_classes and a.name == b.name
    for f in _FIELDS:
        va, vb = getattr(a, f), getattr(b, f)
        assert (va is None) == (vb is None), f
        if va is not None:
            assert va.dtype == vb.dtype, f
            np.testing.assert_array_equal(va, vb, err_msg=f)


@pytest.mark.parametrize("n,f,c,e,seed", [(300, 12, 5, 2000, 0), (1000, 33, 7, 9000, 9)])
def test_synthetic_graph_identical(n, f, c, e, seed):
    kw = dict(homophily=0.7, seed=seed, feature_noise=1.5, difficulty_sigma=0.8)
    assert_graph_equal(jdata.synthetic_graph(n, f, c, e, **kw),
                       tdata.synthetic_graph(n, f, c, e, **kw))


@pytest.mark.parametrize("name,extra", [
    ("cora", {"synthetic_scale": 10}),
    ("pubmed", {"synthetic_scale": 10}),
    ("computers", {"synthetic_scale": 10}),
    ("ogbn-arxiv", {"synthetic_scale": 100}),
    ("ogbn-products", {"synthetic_scale": 1000, "whole_test_set": False,
                       "train_frac": 2, "tvalid_frac": 2, "test_frac": 40}),
])
def test_load_network_identical(tmp_path, name, extra):
    cfg = {"dataset_name": name, "data_dir": str(tmp_path), "seed": 7, **extra}
    assert_graph_equal(jdata.load_network(dict(cfg)), tdata.load_network(dict(cfg)))


def test_load_network_npz_and_index_cache(tmp_path):
    g = tdata.synthetic_graph(400, 16, 5, 3000, seed=4, name="ogbn-arxiv")
    idx = np.random.default_rng(0).permutation(400)
    np.savez(tmp_path / "ogbn-arxiv.npz", x=g.x, y=g.y, edge_index=g.edge_index,
             train_idx=idx[:200], valid_idx=idx[200:300], test_idx=idx[300:])
    cfg = {"dataset_name": "ogbn-arxiv", "data_dir": str(tmp_path), "seed": 3,
           "load_index": True}
    a = jdata.load_network(dict(cfg))
    b = tdata.load_network(dict(cfg))  # reads the index cache the JAX side wrote
    assert_graph_equal(a, b)
    np.testing.assert_array_equal(b.train_mask.nonzero()[0], np.sort(idx[:200]))


@pytest.mark.parametrize("name", ["cora", "computers", "pubmed", "ogbn-arxiv"])
def test_readers_identical(name):
    assert_graph_equal(jread.detect_and_read(FIX, name), tread.detect_and_read(FIX, name))


@pytest.mark.parametrize("n,e,seed", [(50, 0, 0), (500, 4000, 1), (3000, 20000, 2)])
def test_csr_order_identical(n, e, seed):
    rng = np.random.default_rng(seed)
    ei = rng.integers(0, n, (2, e)).astype(np.int32)
    a = jcont.CSRGraph.from_coo(ei, n)
    b = tcont.CSRGraph.from_coo(ei, n)
    np.testing.assert_array_equal(np.asarray(a.indptr), b.indptr.numpy())
    np.testing.assert_array_equal(np.asarray(a.indices), b.indices.numpy())
    assert b.indptr.dtype == torch.int64 and b.indices.dtype == torch.int32


@pytest.mark.parametrize("which", ["planetoid", "public", "computers", "products"])
def test_splits_identical(which):
    g = tdata.synthetic_graph(900, 8, 6, 4000, seed=5)
    cfg = {"train_frac": 3, "tvalid_frac": 2, "test_frac": 5}
    outs = []
    for mod in (jsplits, tsplits):
        rng = np.random.default_rng(11)
        if which == "planetoid":
            out = mod.random_planetoid_splits(g, rng)
        elif which == "public":
            out = mod.random_planetoid_splits(g, rng, val_total=100, test_total=200)
        elif which == "computers":
            out = mod.random_computers_splits(g, rng)
        else:
            base = g.replace(train_mask=np.arange(900) < 500,
                             val_mask=(np.arange(900) >= 500) & (np.arange(900) < 700),
                             test_mask=np.arange(900) >= 700)
            out = mod.ogb_products_splits(base, cfg, rng)
        outs.append(out)
    assert_graph_equal(*outs)


@pytest.mark.parametrize("noise_type", ["sym", "next_pair", "rand_pair", "aim_pair"])
def test_label_noise_identical(noise_type):
    y = np.random.default_rng(0).integers(0, 9, 5000).astype(np.int32)
    yj, mj = jnoise.flip_label(y, 9, noise_type, 0.35, np.random.default_rng(21))
    yt, mt = tnoise.flip_label(y, 9, noise_type, 0.35, np.random.default_rng(21))
    np.testing.assert_array_equal(yj, yt)
    np.testing.assert_array_equal(mj, mt)
    np.testing.assert_array_equal(jnoise.noise_or_not(y, yj), tnoise.noise_or_not(y, yt))
    np.testing.assert_array_equal(
        jnoise.build_noise_matrix(9, noise_type, 0.2, np.random.default_rng(2)),
        tnoise.build_noise_matrix(9, noise_type, 0.2, np.random.default_rng(2)))


@pytest.mark.parametrize("variant,max_epochs,warmup", [
    ("ogb", 50, None), ("ogb", 7, None), ("small", 30, None), ("contrast", 40, 25),
])
def test_forget_rate_schedule_identical(variant, max_epochs, warmup):
    args = (max_epochs, 0.3, 15, 1.2)
    kw = dict(ct_exp=1.0, warmup=warmup, variant=variant)
    np.testing.assert_array_equal(j_schedule(*args, **kw), t_schedule(*args, **kw))
    assert j_tepb(512, (15, 10, 5)) == t_tepb(512, (15, 10, 5))


def test_pipeline_host_state_identical(tmp_path):
    """Both pipelines draw the same noise and the same epoch seed batches
    from one config: the host rng is consumed in the same order."""
    from noise_gnn_tpu.train.pipelines import BasePipeline as JPipe
    from noise_gnn_tpu.utils.config import load_config as j_load
    from noise_gnn_tpu_torch.train.pipelines import BasePipeline as TPipe
    from noise_gnn_tpu_torch.utils.config import load_config as t_load

    over = dict(synthetic_scale=10, data_dir=str(tmp_path / "data"),
                out_dir=str(tmp_path / "out"), noise_type="rand_pair")
    cj = j_load("configs/config_cora.yml")
    cj.update(over, data_parallel=False)
    ct = t_load("configs/config_cora.yml")
    ct.update(over, device="cpu")
    pj, pt = JPipe(cj), TPipe(ct)
    assert_graph_equal(pj.graph, pt.graph)
    np.testing.assert_array_equal(pj.noise_mat, pt.noise_mat)
    np.testing.assert_array_equal(pj.clean, pt.clean)
    np.testing.assert_array_equal(pj.rate_schedule, pt.rate_schedule)
    assert pj.fanouts == pt.fanouts
    train = pj.split_idx["train"]
    for _ in range(2):
        sj, mj = pj.epoch_seed_matrix(train, 64)
        st, mt = pt.epoch_seed_matrix(train, 64)
        np.testing.assert_array_equal(np.asarray(sj), st.numpy())
        np.testing.assert_array_equal(np.asarray(mj), mt.numpy())
    pj._flip_labels(1)
    pt._flip_labels(1)
    np.testing.assert_array_equal(np.asarray(pj.data.yhn), pt.data.yhn.numpy())
    np.testing.assert_array_equal(np.asarray(pj.data.clean), pt.data.clean.numpy())
