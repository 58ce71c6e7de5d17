"""The port's ``parallel/`` in one process, against the JAX package: the
halo pack (every array bit-equal, the pair counts and the exchange bytes
equal) at D = 2 and 4, ``shard_edges``, ``locality_order``; the
layout-independent draws of the sampler and of dropout (each rank's block
of a data-parallel draw equals that block of the one-process draw); a
one-rank mesh's halo SpMM against the edge-list aggregation; and the
refusals of a ``model_parallel`` that does not divide the ranks, of
``model_parallel > 1`` in one process and of ``data_parallel: false`` at
several ranks. The multi-rank runs are in ``test_torch_port_dist.py``,
``test_torch_port_dp_epochs.py`` and ``test_torch_port_tp.py``."""

import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import noise_gnn_tpu.native as jnative
from noise_gnn_tpu.graph.datasets import synthetic_graph
from noise_gnn_tpu.parallel import halo as jhalo
from noise_gnn_tpu.parallel import partition as jpartition
from noise_gnn_tpu_torch.graph.containers import CSRGraph
from noise_gnn_tpu_torch.models.layers import dropout
from noise_gnn_tpu_torch.ops import scatter as tscatter
from noise_gnn_tpu_torch.ops.sampler import sample_khop_tree
from noise_gnn_tpu_torch.parallel import halo, partition
from noise_gnn_tpu_torch.parallel.mesh import Mesh, make_mesh

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def tiny():
    """The JAX package's tests/test_parallel.py graph."""
    return synthetic_graph(200, 12, 4, 1600, homophily=0.9, seed=0)


@pytest.mark.parametrize("d", [2, 4])
def test_halo_pack_bit_equal(tiny, d):
    j = jhalo.build_halo_partition(tiny.edge_index, tiny.num_nodes, d)
    t = halo.build_halo_partition(tiny.edge_index, tiny.num_nodes, d)
    for name in ("src_local", "slot", "recv_rows", "deg"):
        a, b = np.asarray(getattr(j, name)), getattr(t, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    for name in ("num_nodes", "per", "b_max", "e_max", "n_shards", "boundary_rows_total",
                 "pair_counts"):
        assert getattr(t, name) == getattr(j, name), name
    for f in (12, 16, 512):
        assert t.comm_bytes_per_layer(f) == j.comm_bytes_per_layer(f)
        assert t.comm_bytes_per_layer(f, 2) == j.comm_bytes_per_layer(f, 2)


@pytest.mark.parametrize("d", [2, 3, 8])
def test_shard_edges_matches(tiny, d):
    ei = tiny.edge_index[:, :1597]
    (a, am), (b, bm) = jpartition.shard_edges(ei, d), partition.shard_edges(ei, d)
    np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(bm, am)


def test_locality_order_matches(tiny, tmp_path, monkeypatch):
    """The JAX package's native ``label_prop`` (built from a copy of its
    C++ in ``tmp_path``) and the port's give the same order, which cuts the
    boundary of the contiguous-ID sharding."""
    shutil.copy(ROOT / "csrc" / "graph_runtime.cpp", tmp_path / "graph_runtime.cpp")
    monkeypatch.setattr(jnative, "_SRC_DIR", str(tmp_path))
    monkeypatch.setattr(jnative, "_LIB", None)
    monkeypatch.setattr(jnative, "_TRIED", False)
    assert jnative.available()
    for d in (2, 4):
        jo, ji = jhalo.locality_order(tiny.edge_index, tiny.num_nodes, d)
        to, ti = halo.locality_order(tiny.edge_index, tiny.num_nodes, d)
        np.testing.assert_array_equal(to, jo)
        np.testing.assert_array_equal(ti, ji)
        base = halo.build_halo_partition(tiny.edge_index, tiny.num_nodes, d)
        moved = halo.build_halo_partition(ti[tiny.edge_index], tiny.num_nodes, d)
        assert moved.boundary_rows_total < base.boundary_rows_total


def _fake_mesh(rank, d):
    """A rank's place in a grid of ``d`` (no group: the draws need none)."""
    return Mesh({"data": d, "model": 1}, rank, None)


@pytest.mark.parametrize("d", [2, 4])
def test_sampler_draws_layout_independent(tiny, d):
    """Each rank's tree of its block of the seeds equals that block of the
    one-process tree at every hop, random picks included (in-degrees up to
    ~20 against fanouts [3, 2])."""
    csr = CSRGraph.from_coo(tiny.edge_index, tiny.num_nodes)
    seeds = torch.from_numpy(np.random.default_rng(0).permutation(200)[:32]).long()
    mask = torch.arange(32) < 29
    fan = (3, 2)
    whole = sample_khop_tree(torch.Generator().manual_seed(5), csr, seeds, fan, mask)
    for r in range(d):
        m = _fake_mesh(r, d)
        part = sample_khop_tree(torch.Generator().manual_seed(5), csr, seeds[m.rows(32)], fan,
                                mask[m.rows(32)], mesh=m)
        for depth in range(len(fan) + 1):
            rows = m.rows(whole.n_ids[depth].shape[0])
            assert torch.equal(part.n_ids[depth], whole.n_ids[depth][rows])
            assert torch.equal(part.masks[depth], whole.masks[depth][rows])


@pytest.mark.parametrize("d", [2, 4])
def test_dropout_draws_layout_independent(d):
    x = torch.randn(48, 7, generator=torch.Generator().manual_seed(1))
    whole = dropout(torch.Generator().manual_seed(3), x, 0.5, True)
    for r in range(d):
        m = _fake_mesh(r, d)
        rows = m.rows(48)
        got = dropout(torch.Generator().manual_seed(3), x[rows], 0.5, True, m)
        assert torch.equal(got, whole[rows])


def test_one_rank_mesh_draws_unchanged(tiny):
    """A one-rank mesh draws what no mesh draws, bit for bit."""
    m = make_mesh()
    assert m.size == 1 and m.group is None
    x = torch.randn(10, 4)
    assert torch.equal(dropout(torch.Generator().manual_seed(2), x, 0.3, True, m),
                       dropout(torch.Generator().manual_seed(2), x, 0.3, True))


@pytest.mark.parametrize("mean", [True, False])
def test_one_rank_halo_spmm_matches_edge_list(tiny, mean):
    m = make_mesh()
    part = halo.place_partition(m, halo.build_halo_partition(tiny.edge_index,
                                                             tiny.num_nodes, 1))
    x = torch.from_numpy(tiny.x)
    got = halo.halo_spmm(m, part, halo.shard_features(m, x, part), mean=mean)
    ei = torch.from_numpy(tiny.edge_index).long()
    fn = tscatter.gather_scatter_mean if mean else tscatter.gather_scatter_sum
    torch.testing.assert_close(got[:tiny.num_nodes], fn(x, ei, tiny.num_nodes),
                               rtol=1e-5, atol=1e-5)


def test_sorted_segments_chunks_match_one_call(monkeypatch):
    """The chunked local reduction (chunks of whole segments) equals the
    sorted segment sum of ``ops/scatter.py`` bit for bit."""
    g = torch.Generator().manual_seed(0)
    ids = torch.randint(0, 40, (3000,), generator=g)
    ids[::7] = 40  # pads, dropped
    data = torch.randn(3000, 5, generator=g)
    plan = halo._SortedSegments(ids, None, 40)
    want = tscatter.segment_sum(data, ids, 41)[:40]
    assert torch.equal(plan.sum(data), want)
    monkeypatch.setattr(halo, "_CHUNK_ELEMS", 5 * 37)  # ~37 rows a chunk
    assert torch.equal(plan.sum(data), want)


@pytest.mark.parametrize("name,over", [
    ("config_ctp.yml", {}),
    ("config_arxiv.yml", {}),
    ("config_h.yml", {}),
    ("config_contrast.yml", {}),
    ("config_cora.yml", {"algo_type": "analysis"}),
    ("config_cora.yml", {"algo_type": "grid"}),
])
def test_other_pipelines_refuse_several_ranks(tmp_path, monkeypatch, name, over):
    """Every pipeline trains data- and tensor-parallel at world size > 1;
    what each refuses, before it loads anything (no log is opened), is a
    ``model_parallel`` that does not divide the ranks, as the JAX
    package's mesh does."""
    from noise_gnn_tpu_torch.main import main
    from noise_gnn_tpu_torch.parallel import multihost
    from noise_gnn_tpu_torch.utils.config import load_config

    monkeypatch.setattr(multihost, "world_size", lambda: 2)
    c = load_config(str(ROOT / "configs" / name))
    c.update(device="cpu", out_dir=str(tmp_path), model_parallel=3, **over)
    with pytest.raises(ValueError, match="2 ranks not divisible by model_parallel=3"):
        main(c)
    assert not (tmp_path / "logs").exists()


def test_co_refuses_copies_and_tp(tmp_path, monkeypatch):
    from noise_gnn_tpu_torch.main import main
    from noise_gnn_tpu_torch.parallel import multihost
    from noise_gnn_tpu_torch.utils.config import load_config

    c = load_config(str(ROOT / "configs" / "config_cora.yml"))
    c.update(device="cpu", out_dir=str(tmp_path))
    with pytest.raises(ValueError, match="model_parallel=2 requested but no multi-device"):
        main(dict(c, model_parallel=2))
    monkeypatch.setattr(multihost, "world_size", lambda: 2)
    with pytest.raises(ValueError, match="copies"):
        main(dict(c, data_parallel=False))
    with pytest.raises(ValueError, match="not divisible by model_parallel=2"):
        make_mesh(model_parallel=2)


def test_full_graph_falls_back_in_one_process(tmp_path):
    """In one process ``full_graph: true`` logs and trains on sampled trees,
    as the JAX package does on one device."""
    from noise_gnn_tpu_torch.train.pipelines import PipelineS
    from noise_gnn_tpu_torch.utils.config import load_config

    c = load_config(str(ROOT / "configs" / "config_cora.yml"))
    c.update(device="cpu", synthetic_scale=16, full_graph=True, out_dir=str(tmp_path),
             data_dir=str(tmp_path / "data"))
    pipe = PipelineS(c)
    assert pipe.mesh is None and not pipe._fullgraph_on(pipe.spec_for())
    (log,) = (tmp_path / "logs").rglob("*.log")
    assert "full_graph requested but needs a multi-device mesh" in log.read_text()
