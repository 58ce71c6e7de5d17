"""Checkpoint/resume and ``do_train: false`` in the port, on the CPU.

The bundle round-trips and refuses a template of other leaves;
kill-and-resume gives per-epoch metrics identical to the uninterrupted run
for the co-teaching, the CTP, the TE and the H loops and the contrastive
finetune (the JAX package's own tests, tests/test_checkpoint.py:109-170,
for the port); resuming a run whose last
epoch is already in the checkpoint reproduces the JAX package's record of
a best of 0.0; and load-and-eval of the same params gives the JAX
package's accuracies; and a tiny ``PipelineCTP`` run through each
package's entry point draws the same host data and writes the same
per-epoch records."""

import copy
import glob
import json

import jax
import numpy as np
import optax
import pytest
import torch

from noise_gnn_tpu.train import pipelines as JP
from noise_gnn_tpu.train import steps as JS
from noise_gnn_tpu.utils.checkpoint import save_checkpoint as j_save
from noise_gnn_tpu.utils.config import DEFAULTS as JDEFAULTS
from noise_gnn_tpu_torch.main import main as tmain
from noise_gnn_tpu_torch.models import nets as tnets
from noise_gnn_tpu_torch.models.convert import params_from_jax
from noise_gnn_tpu_torch.train import steps as TS
from noise_gnn_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from noise_gnn_tpu_torch.utils.config import DEFAULTS as TDEFAULTS

torch.set_num_threads(1)

BASE = dict(dataset_name="cora", synthetic_scale=40, num_runs=1, batch_size=64,
            hidden_size=16, num_layers=2, nbr_neighbors=[3, 2], train_type="nalgo",
            algo_type="coteaching", seed=11, epoch_logger=False)
FAMILIES = {
    "co": ("epoch_ct", {}),
    "ctp": ("epoch_ctp", dict(module="sagePL", algo_type="ctp")),
    # PipelineTES; the rewired contrast in the last epoch, after the resume
    "te": ("epoch_te", dict(module="sagePL", what="_test3", ct_tk=2)),
    # PipelineH: three states, the pseudo net a sage beside two sageH
    "h": ("epoch_h", dict(module="sageH", algo_type="hpseudo")),
}


def _adam(params):
    return torch.optim.Adam(params, lr=1e-2)


def _trained_state(seed: int) -> TS.TrainState:
    spec = tnets.NetSpec(module="sagePL", in_size=6, hidden_size=8, out_size=3,
                         nbr_nodes=11, dropout=0.0)
    s = TS.init_state(torch.Generator().manual_seed(seed), spec, _adam)
    for _ in range(2):
        loss = sum((p ** 2).sum() for p in tnets.parameters(s.params))
        TS._step((s,), loss)
    return s


def test_checkpoint_roundtrip(tmp_path):
    """Params, Adam moments and meta come back exactly, and the restored
    optimizer takes the same next step."""
    s1, s2 = _trained_state(1), _trained_state(2)
    path = str(tmp_path / "ck" / "bundle")
    meta = {"run": 2, "epoch": 13, "gen_state": "00ff"}
    save_checkpoint(path, (TS.state_tree(s1), TS.state_tree(s2)), meta)
    tmpl = TS.state_tree(_trained_state(9))
    (r1, r2), got_meta = load_checkpoint(path, (tmpl, tmpl))
    assert got_meta == meta
    for s, r in ((s1, r1), (s2, r2)):
        want = TS.state_tree(s)
        for a, b in zip(jax.tree_util.tree_leaves(want), jax.tree_util.tree_leaves(r)):
            assert torch.equal(a.detach(), b)
        restored = TS.state_from_tree(r, _adam)
        for st in (s, restored):
            TS._step((st,), sum((p ** 3).sum() for p in tnets.parameters(st.params)))
        for a, b in zip(tnets.parameters(s.params), tnets.parameters(restored.params)):
            assert torch.equal(a, b)


def test_checkpoint_leaf_mismatch_raises(tmp_path):
    path = str(tmp_path / "bundle")
    save_checkpoint(path, {"a": torch.ones(3)}, {})
    with pytest.raises(ValueError, match="leaves"):
        load_checkpoint(path, {"a": torch.ones(3), "b": torch.ones(2)})
    with pytest.raises(ValueError, match="template expects 'b'"):
        load_checkpoint(path, {"b": torch.ones(3)})


def _metrics(out_dir, event):
    rows = []
    for f in sorted(glob.glob(str(out_dir / "metrics" / "*.jsonl"))):
        rows += [json.loads(line) for line in open(f)]
    return {(r["run"], r["epoch"]): r for r in rows if r.get("event") == event}


@pytest.mark.parametrize("family", [pytest.param(f, marks=pytest.mark.slow)
                                    if f in ("te", "h") else f for f in sorted(FAMILIES)])
def test_kill_and_resume_reproduces_metrics(tmp_path, family):
    """A run killed after epoch 1 and resumed to epoch 4 finishes with the
    uninterrupted run's per-epoch metrics, exactly: the bundle carries the
    params and Adam moments, the meta the host rng and the generator."""
    event, over = FAMILIES[family]
    base = {**TDEFAULTS, **BASE, **over, "device": "cpu"}
    tmain(dict(copy.deepcopy(base), max_epochs=4, out_dir=str(tmp_path / "full")))
    want = _metrics(tmp_path / "full", event)
    ckpt = str(tmp_path / "kr" / "models" / "stable")
    killed = dict(copy.deepcopy(base), max_epochs=2, out_dir=str(tmp_path / "kr"),
                  ckpt_every=1, ckpt_path=ckpt)
    tmain(copy.deepcopy(killed))
    tmain(dict(copy.deepcopy(killed), resume=True, max_epochs=4))
    got = _metrics(tmp_path / "kr", event)
    assert set(got) == set(want) == {(0, e) for e in range(4)}
    skip = {"ts", "epoch_train_s", "epoch_eval_s", "edges_per_s"}  # wall clock
    for pos in [(0, 2), (0, 3)]:  # post-resume epochs
        for k in set(want[pos]) - skip:
            assert got[pos][k] == want[pos][k], (pos, k)


def test_kill_and_resume_ct_finetune(tmp_path):
    """PipelineCT killed in the finetune (after its first epoch) and resumed
    lands in the finetune directly, from the bundle's state and split ids,
    and finishes with the uninterrupted run's finetune records exactly (the
    JAX package's tests/test_checkpoint.py:148)."""
    base = {**TDEFAULTS, **BASE, "algo_type": "contrastive", "module": "sageFC", "warmup": 2,
            "prob_s": 0.05, "prob_l": 0.1, "device": "cpu"}
    tmain(dict(copy.deepcopy(base), max_epochs=5, out_dir=str(tmp_path / "full")))
    ckpt = str(tmp_path / "kr" / "models" / "stable_ft")
    killed = dict(copy.deepcopy(base), max_epochs=3, out_dir=str(tmp_path / "kr"),
                  ckpt_every=1, ckpt_path=ckpt)
    tmain(copy.deepcopy(killed))
    tmain(dict(copy.deepcopy(killed), resume=True, max_epochs=5))

    def finetune(out):
        rows = []
        for f in sorted(glob.glob(str(out / "metrics" / "*.jsonl"))):
            rows += [json.loads(line) for line in open(f)]
        return rows

    want = {r["epoch"]: r for r in finetune(tmp_path / "full") if r["event"] == "finetune"}
    rows = finetune(tmp_path / "kr")
    got = {r["epoch"]: r for r in rows if r["event"] == "finetune"}
    assert sorted(want) == sorted(got) == [2, 3, 4]
    assert [r["epoch"] for r in rows if r["event"] == "warmup"] == [0, 1]  # not re-run
    for e in (3, 4):  # post-resume epochs
        for k in set(want[e]) - {"ts", "epoch_train_s"}:
            assert got[e][k] == want[e][k], (e, k)
    summaries = [r for r in rows if r["event"] == "summary_contrastive"]
    (full_summary,) = [r for r in finetune(tmp_path / "full")
                       if r["event"] == "summary_contrastive"]
    for k in ("mean", "final", "warmup_best_val"):
        assert summaries[-1][k] == full_summary[k], k


@pytest.mark.parametrize("family", ["co", "ctp"])
def test_resume_past_last_epoch_matches_jax(tmp_path, family):
    """Resuming from the checkpoint of the last epoch (start_epoch >=
    max_epochs) runs no epoch, and the JAX package appends a best of 0.0
    for the run; the port reproduces that record (ROADMAP queue 3)."""
    event, over = FAMILIES[family]
    results = {}
    for name, defaults in (("jax", JDEFAULTS), ("torch", TDEFAULTS)):
        cfg = {**defaults, **BASE, **over, "max_epochs": 1, "ckpt_every": 1,
               "data_parallel": False, "out_dir": str(tmp_path / name),
               "ckpt_path": str(tmp_path / name / "ck")}
        if name == "torch":
            cfg["device"] = "cpu"
            run = tmain
        else:
            cls = JP.PipelineCTP if family == "ctp" else JP.PipelineS

            def run(c, cls=cls):
                return cls(c).loop()
        first = run(copy.deepcopy(cfg))
        again = run(dict(copy.deepcopy(cfg), resume=True))
        if isinstance(first, dict):
            first, again = first["nalgo"], again["nalgo"]
        results[name] = (tuple(first), tuple(again), again.extra["runs"])
        assert len(_metrics(tmp_path / name, event)) == 1  # the resumed run added none
    (jf, ja, jruns), (tf, ta, truns) = results["jax"], results["torch"]
    assert jf[0] > 0.0 and tf[0] > 0.0
    assert ja == ta == (0.0, 0.0) and jruns == truns == [0.0]


@pytest.mark.parametrize("module", ["sage", "sagePL"])
def test_load_and_eval_matches_jax(tmp_path, module):
    """do_train: false on the same two nets' params (a JAX checkpoint and
    the port's own, written from the same numbers) gives the same split
    accuracies."""
    cfg = dict(BASE, module=module, max_epochs=1, do_train=False, data_parallel=False)
    jp = JP.PipelineS({**JDEFAULTS, **cfg, "out_dir": str(tmp_path / "jax")})
    spec = jp.spec_for()
    opt = optax.adam(1e-3)
    js = [JS.init_state(jax.random.key(k), spec, opt) for k in (21, 22)]
    j_save(str(tmp_path / "jck"), (js[0], js[1], jax.random.key(0)), {"run": 0, "epoch": 0})
    jp.config["ckpt_path"] = str(tmp_path / "jck")
    jres = jp.loop()

    ts = [TS.state_from_params(params_from_jax(jax.tree.map(np.asarray, s.params)), _adam)
          for s in js]
    save_checkpoint(str(tmp_path / "tck"), tuple(TS.state_tree(s) for s in ts),
                    {"run": 0, "epoch": 0})
    tres = tmain({**TDEFAULTS, **cfg, "device": "cpu", "out_dir": str(tmp_path / "torch"),
                  "ckpt_path": str(tmp_path / "tck")})
    for a, b in zip(jres["loaded"], tres["loaded"]):
        assert a == b
    assert tres["meta"] == {"run": 0, "epoch": 0}


def test_pipeline_ctp_tiny_matches_jax_shape(tmp_path):
    """A tiny PipelineCTP run through each package's entry: the same host
    data (noise matrix, epochs' seed batches), the same per-epoch metric
    keys, finite losses and a consistency term from epoch 1 on. The device
    streams differ (jax.random vs torch), so the numbers are compared only
    as they must agree."""
    over = dict(dataset_name="cora", synthetic_scale=40, module="sagePL", algo_type="ctp",
                train_type="nalgo", hidden_size=16, num_layers=2, nbr_neighbors=[3, 2],
                num_runs=1, max_epochs=2, batch_size=64, seed=3, epoch_logger=False,
                data_parallel=False)
    jc = dict(JDEFAULTS, **over, out_dir=str(tmp_path / "jax"))
    tc = dict(TDEFAULTS, **over, out_dir=str(tmp_path / "torch"), device="cpu")
    jp = JP.PipelineCTP(copy.deepcopy(jc))
    jres = jp.loop()
    tres = tmain(copy.deepcopy(tc))
    assert len(jres) == len(tres) == 2 and 0.0 < tres[0] <= 1.0
    je = list(_metrics(tmp_path / "jax", "epoch_ctp").values())
    te = list(_metrics(tmp_path / "torch", "epoch_ctp").values())
    assert [r["epoch"] for r in te] == [r["epoch"] for r in je] == [0, 1]
    for a, b in zip(je, te):
        assert set(a) - {"epoch_eval_s"} <= set(b)
        assert all(np.isfinite(b[k]) for k in ("loss_1", "loss_2", "val_acc_1"))
    assert te[0]["loss_cr_1"] == 0.0 and te[1]["loss_cr_1"] > 0.0
    jn = np.load(glob.glob(str(tmp_path / "jax" / "nmat" / "*.npy"))[0])
    tn = np.load(glob.glob(str(tmp_path / "torch" / "nmat" / "*.npy"))[0])
    np.testing.assert_array_equal(tn, jn)
