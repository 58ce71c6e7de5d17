"""The port's entry point on the CPU, what it refuses, and its import guard:
no module of ``noise_gnn_tpu_torch`` (nor ``chip_smoke.py``) may import JAX
or the JAX package."""

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


@pytest.mark.parametrize("over", [
    {"algo_type": "contrastive"}, {"algo_type": "grid"}, {"algo_type": "hpseudo"},
    {"do_plot": True}, {"algo_type": "analysis"}, {"what": "_test2"}, {"module": "sageH"},
])
def test_not_yet_ported_raises(tmp_path, over):
    with pytest.raises(NotImplementedError, match="not yet ported"):
        main(_cfg(tmp_path, **over))


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
    assert int(res.stdout.split()[-1]) >= 20  # every module of the port imported
