"""The port's probe tools (``noise_gnn_tpu_torch/tools/``: ``exp_flat_agg``,
``exp_ctp_step``, ``calibrate_synthetic``, ``probe_hard_draw``) against the
JAX package and its scripts of the same names, on the CPU at tiny sizes.

The aggregation forms equal JAX's ``gather_scatter_mean``,
``tree_gather_scatter`` and ``segment_sum`` (f32, 1e-5); the CTP step's two
legs give one forward loss from one generator state (1e-5 relative); the
calibration bisects to the JAX tool's midpoints under one stub and
restores the registry after a failing probe, and its ``train_eval`` lands
within a measured tolerance of JAX's; the hard draw's labels are JAX
``PipelineCO._flip_labels(1)``'s bit for bit. Each tool's ``--cpu`` line
has its keys, finite, and without ``--cpu`` and a card each raises. The
card's case is ``tests/test_torch_port_gpu.py::test_flat_agg_forms_on_cuda``.
"""

import dataclasses
import importlib.util
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from noise_gnn_tpu_torch.graph import datasets as TD
from noise_gnn_tpu_torch.tools import (calibrate_synthetic, exp_ctp_step, exp_flat_agg,
                                       probe_hard_draw)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


def _jax_tool(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}",
                                                  ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def _finite_numbers(d):
    """Every number in a nest of dicts and lists (booleans aside)."""
    if isinstance(d, dict):
        return [v for x in d.values() for v in _finite_numbers(x)]
    if isinstance(d, list):
        return [v for x in d for v in _finite_numbers(x)]
    return [d] if isinstance(d, (int, float)) and not isinstance(d, bool) else []


def _assert_cpu_line(res: dict):
    assert res["card"] == "cpu" and res["power_limit"] is None
    nums = _finite_numbers(res)
    assert nums and all(math.isfinite(v) for v in nums)


# ------------------------------------------------------------ exp_flat_agg


def test_flat_agg_forms_match_jax():
    """(a) and (b) with a random edge mask against JAX's edge-list mean and
    tree aggregation, (c) against JAX's segment_sum of the gathered rows;
    f32, 1e-5 (sums of up to 10 rows in another order)."""
    import jax.numpy as jnp

    from noise_gnn_tpu.ops.sampler import flat_edge_index
    from noise_gnn_tpu.ops.scatter import gather_scatter_mean, segment_sum
    from noise_gnn_tpu.ops.tree_agg import TreeTopo, tree_gather_scatter

    batch, fanouts, feat = 6, (4, 3), 16
    n_sub = sum(exp_flat_agg.tree_sizes(batch, fanouts))
    edges = n_sub - batch
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n_sub, feat)).astype(np.float32)
    mask = rng.random(edges) < 0.7
    add = rng.integers(0, n_sub, (2, 2 * int(n_sub * 0.1)))
    fns = exp_flat_agg.forms(torch.from_numpy(x), torch.from_numpy(mask), batch, fanouts,
                             torch.from_numpy(add))
    got = {k: fn().numpy() for k, fn in fns.items()}
    xj, mj = jnp.asarray(x), jnp.asarray(mask)
    ei = jnp.asarray(flat_edge_index(batch, fanouts))
    want_edge = np.asarray(gather_scatter_mean(xj, ei, n_sub, mj))
    want_tree = np.asarray(tree_gather_scatter(xj, TreeTopo(batch, fanouts, mj)))
    want_delta = np.asarray(segment_sum(jnp.take(xj, jnp.asarray(add[0]), axis=0),
                                        jnp.asarray(add[1]), n_sub))
    for k, want in (("edge_list", want_edge), ("structured", want_edge),
                    ("structured", want_tree), ("delta", want_delta)):
        np.testing.assert_allclose(got[k], want, rtol=0, atol=1e-5, err_msg=k)
    assert not (~mask).all() and np.abs(want_edge[:batch]).max() > 0


def test_flat_agg_cpu_line():
    res = exp_flat_agg.run(cpu=True, iters=2)
    assert (res["batch"], res["feat"], res["n_sub"], res["edges"]) == (16, 64, 976, 960)
    assert res["delta_edges"] == 2 * int(976 * 0.1) and res["edge_chunks"] == 1
    assert set(res["times_ms"]) == {"edge_list", "structured", "delta"}
    assert res["ms"] is None and res["max_abs_diff"] <= 1e-5
    # (a) and (b) read each child row once and write every row once
    assert res["bytes"]["structured"] == (960 + 976) * 64 * 4
    _assert_cpu_line(res)


# ------------------------------------------------------------ exp_ctp_step

CTP_SMALL = dict(scale=40, batch=8, hidden=8, fanouts=(3, 2))


@pytest.fixture
def ctp_data(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # load_network caches the synthetic graph under ./data
    return exp_ctp_step.make_data(torch.device("cpu"), CTP_SMALL["scale"])


def test_ctp_step_legs_same_forward_loss(ctp_data):
    """The edge-list leg and the TreeTopo leg (the main path's
    ``ctp_step_loss``) from one generator state: one loss within 1e-5
    relative (sums in another order), on a tree with masked edges."""
    from noise_gnn_tpu_torch.models import nets
    from noise_gnn_tpu_torch.train import steps as S

    data, feat, classes = ctp_data
    n = data.x.shape[0]
    spec = nets.NetSpec(module="sagePL", in_size=feat, hidden_size=8, out_size=classes,
                        num_layers=2, dropout=0.5, nbr_nodes=n)
    p1, p2 = (nets.init_params(torch.Generator().manual_seed(s), spec) for s in (1, 2))
    seeds = torch.from_numpy(np.random.default_rng(3).integers(0, n, 8))
    mask = torch.tensor([True] * 7 + [False])
    fr = torch.tensor(0.3)
    state = torch.Generator().manual_seed(5).get_state()
    losses = {}
    for leg in ("tree", "edge_list"):
        gen = torch.Generator()
        gen.set_state(state)
        losses[leg] = float(exp_ctp_step.leg_loss(leg, spec, p1, p2, data, seeds, mask, gen,
                                                  fr, (3, 2)))
    assert math.isfinite(losses["tree"]) and losses["tree"] > 0
    assert abs(losses["edge_list"] - losses["tree"]) <= 1e-5 * abs(losses["tree"])


def test_ctp_step_cpu_line(ctp_data):
    res = exp_ctp_step.run(cpu=True, old=True, iters=1, **CTP_SMALL)
    assert set(res["legs"]) == {"tree", "edge_list"}
    for row in res["legs"].values():
        assert set(row) == {"forward_loss"} | {
            f"{s}{t}_wall_ms" for s in ("forward", "forward_backward", "full_step")
            for t in ("", "_times")}
    tree, edge = res["legs"]["tree"]["forward_loss"], res["legs"]["edge_list"]["forward_loss"]
    assert abs(edge - tree) <= 1e-5 * abs(tree)
    assert res["float32_matmul_precision"] == torch.get_float32_matmul_precision()
    assert (res["module"], res["layers"], res["forget_rate"]) == ("sagePL", 2, 0.3)
    _assert_cpu_line(res)


# ----------------------------------------------------- calibrate_synthetic


def test_calibrate_bisection_matches_jax(monkeypatch, capsys):
    """Under one monotone stub for ``train_eval`` (an accuracy read from
    each package's own registry, so the swap is what is tested), both tools
    probe the same midpoints and suggest the same ``feature_noise``."""
    from noise_gnn_tpu.graph import datasets as JD

    jax_tool = _jax_tool("calibrate_synthetic")
    seen = {"jax": [], "port": []}

    def stub(registry, key):
        def train_eval(g, **kw):
            f = registry["pubmed"].feature_noise
            seen[key].append(f)
            return 1.0 / (1.0 + f)
        return train_eval

    monkeypatch.setattr(jax_tool, "train_eval", stub(JD.DATASET_REGISTRY, "jax"))
    monkeypatch.setattr(calibrate_synthetic, "train_eval", stub(TD.DATASET_REGISTRY, "port"))
    argv = ["pubmed", "--scale", "100", "--iters", "4"]
    monkeypatch.setattr(sys, "argv", ["calibrate_synthetic.py", *argv, "--cpu"])
    jax_tool.main()
    jax_line = capsys.readouterr().out.strip()
    assert calibrate_synthetic.main(["--cpu", *argv]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["datasets"]["pubmed"]
    assert len(seen["jax"]) == 4 and seen["port"] == seen["jax"]
    assert [p["feature_noise"] for p in res["probes"]] == seen["jax"]
    assert jax_line == f"pubmed: feature_noise={res['feature_noise']:.2f}"
    assert TD.DATASET_REGISTRY["pubmed"].feature_noise == res["registry"] == 0.21


def test_calibrate_probe_restores_registry_on_error(monkeypatch):
    before = TD.DATASET_REGISTRY["cora"]

    def boom(g, **kw):
        assert TD.DATASET_REGISTRY["cora"].feature_noise == 9.5
        raise RuntimeError("train_eval failed")

    monkeypatch.setattr(calibrate_synthetic, "train_eval", boom)
    with pytest.raises(RuntimeError, match="train_eval failed"):
        calibrate_synthetic.probe("cora", 9.5, scale=100, epochs=1, hidden=4, lr=1e-2)
    assert TD.DATASET_REGISTRY["cora"] is before


# |port - JAX| of train_eval's test accuracy on synthetic pubmed at scale 10
# (1,971 nodes, F = 50, 3 classes), 30 epochs, hidden 32, measured over
# train_eval seeds 0, 1 and 2: 0.018, 0.005 and 0.046 (port 0.716 / 0.764 /
# 0.681 against JAX 0.698 / 0.759 / 0.727; init and dropout from different
# PRNGs). The bound is 2x the largest; chance is 1/3.
TRAIN_EVAL_TOL = 0.092


def test_calibrate_train_eval_matches_jax(tmp_path):
    jax_tool = _jax_tool("calibrate_synthetic")
    from noise_gnn_tpu.graph.datasets import load_network as j_load

    cfg = {"dataset_name": "pubmed", "seed": 0, "synthetic_scale": 10}
    gj = j_load(dict(cfg, data_dir=str(tmp_path / "j")))
    gt = TD.load_network(dict(cfg, data_dir=str(tmp_path / "t")))
    np.testing.assert_array_equal(gj.x, gt.x)
    kw = dict(epochs=30, hidden=32, lr=5e-3, seed=0)
    got = calibrate_synthetic.train_eval(gt, **kw)
    want = jax_tool.train_eval(gj, **kw)
    assert 1 / 3 < got <= 1 and abs(got - want) <= TRAIN_EVAL_TOL, (got, want)


# --------------------------------------------------------- probe_hard_draw

HD_OV = dict(synthetic_scale=1000, hidden_size=16, nbr_neighbors=[3, 2, 2])


def test_hard_draw_labels_match_jax(tmp_path):
    """Every reflip of ``HardDrawCO`` gives JAX ``PipelineCO._flip_labels(1)``'s
    noisy labels, bit for bit (the draw is host numpy keyed by (seed, run))."""
    from noise_gnn_tpu.train.pipelines import PipelineCO as JPipe
    from noise_gnn_tpu.utils.config import load_config as j_load
    from noise_gnn_tpu_torch.utils.config import load_config as t_load

    over = dict(HD_OV, data_dir=str(tmp_path / "data"), out_dir=str(tmp_path / "out"))
    cj = j_load(str(ROOT / "configs" / "config_products.yml"))
    cj.update(over, data_parallel=False)
    ct = t_load(str(ROOT / "configs" / "config_products.yml"))
    ct.update(over, device="cpu")
    pj, pt = JPipe(cj), probe_hard_draw.HardDrawCO(ct)
    pj._flip_labels(1)
    want = np.asarray(pj.data.yhn)
    assert (want != pt.graph.y).any()
    for run in (0, 2):
        pt._flip_labels(run)
        np.testing.assert_array_equal(pt.data.yhn.numpy(), want)
        np.testing.assert_array_equal(pt.clean, pj.clean)


def test_hard_draw_cpu_run(tmp_path):
    res = probe_hard_draw.run(1, device="cpu", data_dir=str(tmp_path / "data"),
                              out_dir=str(tmp_path / "out"), reinit_retries=0, **HD_OV)
    assert res["epochs"] == 1 and 0 <= res["hard_draw_ct_best"] <= 1
    assert res["reinit_attempts"] == 0 and res["curve"]["epoch"] == [0]
    assert set(res["curve"]) == {"epoch", "test_best", "pure_ratio_1", "pure_ratio_2",
                                 "epoch_train_s", "epoch_eval_s"}
    _assert_cpu_line(res)


# ---------------------------------------------------------- the device rule


@pytest.mark.parametrize("tool,argv", [(exp_flat_agg, []), (exp_ctp_step, []),
                                       (calibrate_synthetic, ["cora"]),
                                       (probe_hard_draw, [])])
def test_probe_tools_raise_without_card_or_cpu(tool, argv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tool.main(argv)


def test_registry_profiles_unchanged():
    """The port's registry holds the JAX package's profiles (the values the
    calibration checks on the card)."""
    from noise_gnn_tpu.graph import datasets as JD

    assert {k: dataclasses.asdict(v) for k, v in TD.DATASET_REGISTRY.items()} == \
        {k: dataclasses.asdict(v) for k, v in JD.DATASET_REGISTRY.items()}
