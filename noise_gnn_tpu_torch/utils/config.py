"""YAML config front-end with the reference's key surface, plus validation.

The port's own copy of ``noise_gnn_tpu/utils/config.py``: same keys, same
defaults and the same validation, except that ``device`` defaults to
``cuda`` and ``device_of`` resolves it (the port never runs on the CPU
unless a config or caller asks for it).

Reference: main.py:54-57 loads raw YAML with no validation, and pipelines
mutate the dict at runtime. Here: same keys (a reference config file loads
unchanged), explicit defaults, and a validation pass that catches unknown
dispatch values early. Runtime-derived values (nbr_features, nbr_classes,
nbr_nodes, device) are still injected into the dict for parity with
pipelines that read them back.
"""

from __future__ import annotations

import datetime as dt

import torch
import yaml

DEFAULTS: dict = {
    # data
    "batch_id": 0,
    "data_dir": "data",
    "dataset_name": "cora",
    "what": "",
    "seed": 1232,
    "synthetic_scale": 1,
    # model
    "module": "sage",
    "module_compare": "sage",
    "hidden_size": 128,
    "num_layers": 2,
    "nbr_neighbors": [10, 5],
    "use_bn": False,
    # training
    "train_type": "both",  # nalgo | baseline | both
    "compare_loss": "normal",  # normal | back
    "dropout": 0.5,
    "optimizer": "adam",
    "learning_rate": 1e-3,
    "weight_decay": 0.0,
    "num_runs": 1,
    "max_epochs": 50,
    # Co-teaching at scale is bistable (docs/RESULTS.md flagship, round 3):
    # on a hard noise draw with an unlucky init the mutual small-loss
    # feedback never engages and purity pins at the clean fraction. The CO
    # loop detects this online (selection_degenerate) and, with retries > 0,
    # re-initializes both nets (fresh keys, SAME noise realization — the
    # paired A/B stays paired) and re-trains the run, up to this many times.
    "reinit_retries": 0,
    "batch_size": 512,
    "batch_size_full": False,
    "next_lr": 1e-3,
    "num_workers": 0,
    # exact-leaf mode (ops/leaf_agg.py): precompute the deepest hop's
    # neighbor aggregate once per run instead of sampling it every step —
    # exact (not estimated) aggregation, ~70% fewer gather indices/step.
    # Applies to tree-mode steps with module sage/gcn/sageH/sageFC, no BN.
    "exact_leaf": False,
    # device: 'cpu' runs on the host; anything else needs a CUDA card
    "cuda": True,  # accepted for compat; `device` decides
    "device": "cuda",
    # distributed execution: the port trains on one card, so data_parallel
    # is accepted and has no effect, model_parallel > 1 raises, and
    # full_graph falls back to sampled-tree training (as the JAX package
    # does on one device)
    "data_parallel": "auto",  # auto | true | false
    "model_parallel": 1,
    "full_graph": False,
    # bools
    "do_train": True,
    "do_plot": False,
    "do_warmup": True,
    "epoch_logger": True,
    "load_index": False,
    "whole_test_set": True,
    # products subsampling
    "train_frac": 1,
    "tvalid_frac": 1,
    "test_frac": 1,
    # noise
    "noise_rate": 0.3,
    "noise_type": "sym",
    # co-teaching
    "algo_type": "coteaching",
    "ct_tk": 15,
    "ct_tau": 0.2,
    "ct_exp": 1,
    "co_lambda": 0.1,
    # contrastive / SPL
    "spl_cont_beta": 1.0,
    "spl_noise_rate_pos": 0.1,
    "spl_noise_rate_neg": 0.1,
    "spl_rewire_rate": 0.1,
    "spl_noise": 0.1,
    "warmup": 15,
    "lambda": 1.0,
    "prob_s": 0.1,
    "prob_l": 0.3,
    "augment_edge": True,
    "augment_feat": True,
    # grid search (PipelineSG sweeps beta x tau)
    "grid_beta": [0.5, 1.0, 2.0],
    "grid_tau": [0.1, 0.2, 0.3],
    # io
    "out_dir": "out",
    "warm_heap_gb": 0,  # pre-fault heap pages (slow-first-touch hosts)
    # precision: bf16 features/activations when compute_dtype is bfloat16
    "param_dtype": "float32",
    "compute_dtype": "float32",
}

_ALGO_TYPES = ("coteaching", "codi", "ctp", "contrastive", "grid", "analysis", "hpseudo", "baseline")
_NOISE_TYPES = ("sym", "next_pair", "rand_pair", "aim_pair")
_TRAIN_TYPES = ("nalgo", "baseline", "both")


def load_config(path: str) -> dict:
    with open(path) as f:
        user = yaml.safe_load(f) or {}
    cfg = dict(DEFAULTS)
    cfg.update(user)
    validate_config(cfg)
    return cfg


def validate_config(cfg: dict) -> None:
    if cfg["algo_type"] not in _ALGO_TYPES:
        raise ValueError(
            f"algo_type {cfg['algo_type']!r} not in {_ALGO_TYPES}"
        )
    if cfg["noise_type"] not in _NOISE_TYPES:
        raise ValueError(
            f"noise_type {cfg['noise_type']!r} not in {_NOISE_TYPES}"
        )
    if cfg["train_type"] not in _TRAIN_TYPES:
        raise ValueError(
            f"train_type {cfg['train_type']!r} not in {_TRAIN_TYPES}"
        )
    if not (0.0 <= float(cfg["noise_rate"]) <= 1.0):
        raise ValueError("noise_rate must be in [0, 1]")
    if int(cfg["num_layers"]) < 1:
        raise ValueError("num_layers must be >= 1")
    fan = cfg["nbr_neighbors"]
    if not isinstance(fan, (list, tuple)) or not all(int(f) > 0 for f in fan):
        raise ValueError("nbr_neighbors must be a list of positive ints")
    if str(cfg.get("aggr", "mean")) not in ("mean", "max"):
        raise ValueError("aggr must be 'mean' or 'max'")
    if int(cfg.get("model_parallel", 1)) < 1:
        raise ValueError("model_parallel must be >= 1")


def run_name(cfg: dict) -> str:
    """Run-name string encoding the key hyperparameters (reference
    output_name, src/pipeline.py:68)."""
    date = dt.datetime.now()
    neigh = "".join(str(f) for f in cfg["nbr_neighbors"])
    return (
        f"dt{date.month}{date.day}_{cfg['dataset_name']}_id{cfg['batch_id']}"
        f"_{cfg['train_type']}_{cfg['algo_type']}_{cfg['module']}"
        f"_noise_{cfg['noise_type']}{cfg['noise_rate']}"
        f"_lay{cfg['num_layers']}_hid{cfg['hidden_size']}"
        f"_lr{cfg['learning_rate']}_epo{cfg['max_epochs']}_bs{cfg['batch_size']}"
        f"_drop{cfg['dropout']}_tk{cfg['ct_tk']}_cttau{cfg['ct_tau']}"
        f"_neigh{neigh}"
    )


def device_of(cfg: dict) -> torch.device:
    """The device a run uses: the CPU only when ``device: 'cpu'`` is set;
    otherwise the (current) CUDA card, and an error where there is none."""
    want = str(cfg.get("device", "cuda"))
    if want == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {want!r} requested but no CUDA device is visible; "
            "set device: 'cpu' to run on the host"
        )
    return torch.device(want if want.startswith("cuda") else "cuda")
