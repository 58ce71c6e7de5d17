"""The port's entry point on the CPU, what it refuses, and its import guard:
no module of ``noise_gnn_tpu_torch`` (nor ``chip_smoke.py``) may import JAX
or the JAX package. Also the slice-3 pipelines (TE/TES, the grid, the
analysis) and ``do_plot`` through the entry point, with their host data
held against the JAX package's."""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from noise_gnn_tpu_torch.main import main
from noise_gnn_tpu_torch.utils.config import device_of, load_config
from noise_gnn_tpu_torch.utils.plotting import plot_metrics_file

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


def _cfg(tmp_path, name="config_cora.yml", **over):
    c = load_config(str(ROOT / "configs" / name))
    c.update(device="cpu", synthetic_scale=10, max_epochs=2, num_runs=1,
             out_dir=str(tmp_path / "out"), data_dir=str(tmp_path / "data"))
    c.update(over)
    return c


@pytest.mark.parametrize("name,over", [
    ("config_cora.yml", {}),
    ("config_products.yml", {"synthetic_scale": 1000, "reinit_retries": 0,
                             "batch_size": 128}),
])
def test_main_runs_on_cpu(tmp_path, name, over):
    c = _cfg(tmp_path, name, **over)
    res = main(c)
    assert set(res) == {"nalgo", "baseline"}
    for summary in res.values():
        mean, std = summary
        assert np.isfinite(mean) and 0.0 <= mean <= 1.0 and std == 0.0
    metrics = ROOT / c["out_dir"] / "metrics" / f"{c['_output_name']}.jsonl"
    recs = [json.loads(line) for line in open(metrics)]
    ct = [r for r in recs if r.get("event") == "epoch_ct"]
    base = [r for r in recs if r.get("event") == "epoch_baseline"]
    assert len(ct) == 2 and len(base) == 2
    for r in ct:
        for k in ("loss_1", "loss_2", "pure_ratio_1", "val_acc_1", "noisy_fit_2"):
            assert np.isfinite(r[k]), k
    assert np.isfinite(base[-1]["loss"]) and 0.0 <= base[-1]["val_acc"] <= 1.0


def test_baseline_algo_dispatch(tmp_path):
    res = main(_cfg(tmp_path, algo_type="baseline", compare_loss="back", max_epochs=1))
    assert set(res) == {"baseline"}


def test_gcn_head_runs_on_cpu(tmp_path):
    """gcn_head, the one module outside the conv stacks, trains on trees
    and evaluates through the edge-list forward, as the JAX package does
    (one layer: its forward is the first conv alone, so only then are its
    outputs the classes)."""
    c = _cfg(tmp_path, module="gcn_head", module_compare="gcn_head", num_layers=1,
             max_epochs=1)
    res = main(c)
    assert set(res) == {"nalgo", "baseline"}
    assert all(0.0 <= summary[0] <= 1.0 for summary in res.values())
    (rec,) = _records(c, "epoch_ct")
    assert np.isfinite(rec["loss_1"]) and 0.0 <= rec["val_acc_1"] <= 1.0


@pytest.mark.parametrize("over,error,match", [
    # co-teaching trains on trees, and gat has none (its step fails in the
    # JAX package too): refused, not invented
    pytest.param({"module": "gat"}, NotImplementedError, "gat", id="over0"),
    # tensor parallelism needs several ranks: in one process a
    # tensor-parallel degree above 1 is refused, as the JAX package refuses
    # it without a multi-device mesh
    pytest.param({"model_parallel": 2}, ValueError, "multi-device", id="over1"),
])
def test_not_yet_ported_raises(tmp_path, over, error, match):
    with pytest.raises(error, match=match):
        main(_cfg(tmp_path, **over))


@pytest.mark.parametrize("name,cls", [("config_h.yml", "PipelineH"),
                                      ("config_contrast.yml", "PipelineCT")])
def test_slice4_configs_dispatch(tmp_path, monkeypatch, name, cls):
    """``hpseudo`` dispatches to PipelineH, ``contrastive`` to PipelineCT:
    each config runs through ``main`` at a small size (synthetic arxiv at
    scale 400, fanouts [3, 2], width 32). H: epoch 0 without the pseudo net,
    epoch 1 with it. CT: 2 warmup epochs, the split, 2 finetune epochs
    (ct_tk 1, so the split uses the config's forget rate)."""
    import noise_gnn_tpu_torch.train.pipelines as P

    ran = []
    loop = getattr(P, cls).loop
    monkeypatch.setattr(getattr(P, cls), "loop",
                        lambda self: ran.append(type(self).__name__) or loop(self))
    over = dict(synthetic_scale=400, nbr_neighbors=[3, 2], batch_size=256, hidden_size=32,
                reinit_retries=0)
    if name == "config_contrast.yml":
        over.update(max_epochs=4, warmup=2, ct_tk=1)
    c = _cfg(tmp_path, name, **over)
    res = main(c)
    assert ran == [cls]
    if cls == "PipelineH":
        mean, std = res
        assert 0.0 <= mean <= 1.0 and std == 0.0
        eps = _records(c, "epoch_h")
        assert [r["epoch"] for r in eps] == [0, 1]
        for r in eps:
            for k in ("loss_1", "loss_2", "loss_pred", "loss_add", "val_acc_1"):
                assert np.isfinite(r[k]), k
        assert eps[0]["loss_pred"] == eps[0]["loss_add"] == 0.0
        assert eps[1]["loss_pred"] > 0.0 and eps[1]["loss_add"] > 0.0
    else:
        assert set(res) == {"contrastive", "final"} and 0.0 <= res["contrastive"][0] <= 1.0
        assert [r["epoch"] for r in _records(c, "warmup")] == [0, 1]
        ft = _records(c, "finetune")
        assert [r["epoch"] for r in ft] == [2, 3]
        assert all(np.isfinite(r[k]) for r in ft for k in ("loss_semi", "loss_cont"))
        (split,) = _records(c, "split")
        assert split["n_clean"] > 0 and split["n_noisy"] > 0


def _records(c, event=None):
    path = Path(c["out_dir"]) / "metrics" / f"{c['_output_name']}.jsonl"
    recs = [json.loads(line) for line in open(path)]
    return [r for r in recs if event is None or r.get("event") == event]


def _jax_host_data(c):
    """The JAX package's graph, split and flipped labels for a config: host
    numpy only, the same draws the port's pipelines make at init."""
    from noise_gnn_tpu.graph.datasets import load_network as j_load
    from noise_gnn_tpu.noise import flip_label as j_flip

    g = j_load(dict(c))
    yhn, mat = j_flip(g.y, g.num_classes, c["noise_type"], float(c["noise_rate"]),
                      np.random.default_rng(int(c["seed"])))
    return g, yhn, mat


# the CPU runs keep the configs' models and cut their trees: fanouts of 3 and
# 2 (the configs' 10 and 5 give the rewire 10^8-element blocks a step)
SMALL_TREES = {"nbr_neighbors": [3, 2, 2], "batch_size": 256, "hidden_size": 32}


@pytest.mark.parametrize("name,over", [
    ("config_test_s.yml", {"ct_tk": 0, "noise_rate": 0.3}),
    pytest.param("config_arxiv.yml", {"synthetic_scale": 400, "ct_tk": 0},
                 marks=pytest.mark.slow),
])
def test_te_configs_run_on_cpu(tmp_path, name, over):
    """``what: _test3`` dispatches to PipelineTES (small graph) and
    PipelineTE (arxiv): epoch 0 plain, epoch 1 with the rewired contrast;
    finite losses, accuracies in [0, 1], the summary's structure, and the
    noise matrix the JAX package draws for the config."""
    over = {**SMALL_TREES, **over}
    c = _cfg(tmp_path, name, **over)
    res = main(c)
    branches = res if isinstance(res, dict) else {"nalgo": res}
    assert set(branches) == ({"nalgo", "baseline"} if c["train_type"] == "both" else {"nalgo"})
    for mean, std in branches.values():
        assert 0.0 <= mean <= 1.0 and std == 0.0
    te = _records(c, "epoch_te")
    assert [r["epoch"] for r in te] == [0, 1]
    for r in te:
        for k in ("loss_1", "loss_2", "loss_cont_1", "val_acc_1", "test_acc_2"):
            assert np.isfinite(r[k]), k
    assert te[0]["loss_cont_1"] == 0.0 and te[1]["loss_cont_1"] > 0.0
    _, _, jmat = _jax_host_data(c)
    nmat = np.load(Path(c["out_dir"]) / "nmat" / f"{c['_output_name']}.npy")
    np.testing.assert_array_equal(nmat, jmat)


@pytest.mark.slow
def test_grid_runs_on_cpu(tmp_path):
    """A 2 x 1 grid of PipelineTES runs on synthetic cora: one result per
    cell, sorted by accuracy, each a nalgo (mean, std) of one run (the two
    epochs stay before the config's ct_tk; the TE tests above run the
    contrast epochs)."""
    c = _cfg(tmp_path, "config_grid.yml", grid_beta=[0.5, 2.0], grid_tau=[0.2],
             **SMALL_TREES)
    res = main(c)
    assert sorted((r["beta"], r["tau"]) for r in res) == [(0.5, 0.2), (2.0, 0.2)]
    assert [r["acc"] for r in res] == sorted((r["acc"] for r in res), reverse=True)
    assert all(0.0 <= r["acc"] <= 1.0 and r["std"] == 0.0 for r in res)
    assert _records(c, "grid_results")[0]["results"] == res


def test_analysis_runs_on_cpu(tmp_path):
    """PipelineA on synthetic cora: per-epoch selection probes in [0, 1], the
    best validation accuracy, and a confusion matrix of the test split whose
    rows count the JAX package's test labels."""
    c = _cfg(tmp_path, "config_analysis.yml", **SMALL_TREES)
    res = main(c)
    recs = _records(c, "epoch_analysis")
    assert [r["epoch"] for r in recs] == [0, 1]
    for r in recs:
        for k in ("clean_sel_acc", "noisy_sel_acc", "val_acc", "test_acc"):
            assert 0.0 <= r[k] <= 1.0, k
    assert res["best_val"] == max(r["val_acc"] for r in recs)
    g, _, _ = _jax_host_data(c)
    test = g.split_idx()["test"]
    np.testing.assert_array_equal(res["confusion"].sum(axis=1),
                                  np.bincount(g.y[test], minlength=g.num_classes))
    saved = np.load(Path(c["out_dir"]) / "metrics" / f"confusion_{c['_output_name']}.npy")
    np.testing.assert_array_equal(saved, res["confusion"])


@pytest.mark.slow
def test_do_plot(tmp_path, monkeypatch):
    """``do_plot`` on the co-teaching path writes the PNG beside metrics/
    (config_arxiv8.yml's hook) where matplotlib is installed; without
    matplotlib (absent, or its import made to fail) the plot is None."""
    c = _cfg(tmp_path, "config_arxiv8.yml", synthetic_scale=400, **SMALL_TREES)
    main(c)
    png = Path(c["out_dir"]) / "plots" / f"{c['_output_name']}.png"
    metrics = Path(c["out_dir"]) / "metrics" / f"{c['_output_name']}.jsonl"
    again = plot_metrics_file(str(metrics), str(tmp_path / "again.png"))
    if importlib.util.find_spec("matplotlib") is None:
        assert again is None and not png.exists()
    else:
        assert png.stat().st_size > 0 and again == str(tmp_path / "again.png")
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import raises ImportError
    assert plot_metrics_file(str(metrics), str(tmp_path / "none.png")) is None
    assert not (tmp_path / "none.png").exists()


def test_model_parallel_raises(tmp_path):
    with pytest.raises(ValueError, match="model_parallel"):
        main(_cfg(tmp_path, model_parallel=2))


def test_no_gpu_raises_unless_cpu_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_of({"device": "cuda"})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_of({})
    assert device_of({"device": "cpu"}) == torch.device("cpu")


_GUARD = """
import importlib, importlib.util, pkgutil, sys
sys.modules["jax"] = None
sys.modules["noise_gnn_tpu"] = None
import noise_gnn_tpu_torch
names = [m.name for m in pkgutil.walk_packages(noise_gnn_tpu_torch.__path__,
                                               "noise_gnn_tpu_torch.")]
for name in names:
    importlib.import_module(name)
probes = {f"noise_gnn_tpu_torch.tools.{t}" for t in
          ("exp_flat_agg", "exp_ctp_step", "calibrate_synthetic", "probe_hard_draw")}
assert probes <= set(names), sorted(probes - set(names))
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = [m for m, mod in sys.modules.items() if mod is not None
       and (m in ("jax", "noise_gnn_tpu") or m.startswith(("jax.", "noise_gnn_tpu.")))]
assert not bad, bad
print(len(names))
"""


def test_import_guard_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    res = subprocess.run([sys.executable, "-c", _GUARD], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 65  # every module of the port imported
