"""Calibrate the synthetic fallback's difficulty (``DATASET_REGISTRY``'s
``feature_noise``) with the port.

    python -m noise_gnn_tpu_torch.tools.calibrate_synthetic cora pubmed computers [--cpu]
    python -m noise_gnn_tpu_torch.tools.calibrate_synthetic ogbn-arxiv
    python -m noise_gnn_tpu_torch.tools.calibrate_synthetic ogbn-products --scale 10 --cli
    python -m noise_gnn_tpu_torch.tools.calibrate_synthetic cora --lo 0.42 --hi 0.42 --iters 1

Port of ``tools/calibrate_synthetic.py``. The synthetic graphs stand in for
the real datasets, so their difficulty is calibrated: a plain 2-layer SAGE
trained on CLEAN labels should land near the real dataset's published
accuracy (:data:`TARGETS`). ``feature_noise`` is the per-direction noise
std of ``graph/datasets.py::synthetic_graph``; accuracy falls as it rises,
so the tool bisects it geometrically between ``--lo`` and ``--hi``.
``--lo f --hi f --iters 1`` probes exactly ``f``: that checks a registry
value.

Each probe swaps the profile's ``feature_noise`` in the port's own
``DATASET_REGISTRY`` and restores it afterwards, also when the probe
raises (:func:`probe`). :func:`train_eval` is full-batch 2-layer SAGE
(hidden 256, dropout 0.5, Adam) on clean labels, the test accuracy at the
best-validation epoch (validation every 5 epochs and at the last); its
init and dropout come from ``torch.Generator``, so its accuracies differ
from the JAX tool's by PRNG, not by arithmetic. ``--cli`` probes through
the port's ``main`` (mini-batch training, full-graph eval) with no
injected noise, its ``baseline`` accuracy: the way at products scale.

Each probe's line goes to stderr; the JSON line gives, per dataset, its
target, every probe (``feature_noise``, accuracy, seconds) and the
suggested ``feature_noise``, with the card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import tempfile
import time

import torch

from ..graph import datasets as D
from ..models import nets
from ..train import steps as S
from ..utils.config import load_config
from .common import ROOT, card_info, log, tool_device

TARGETS = {
    "cora": 0.62,
    "pubmed": 0.77,
    "computers": 0.82,
    "ogbn-arxiv": 0.71,
    "ogbn-products": 0.78,
}


def train_eval(g, *, epochs: int, hidden: int, lr: float, seed: int = 0,
               device=torch.device("cpu")) -> float:
    """Full-batch 2-layer SAGE on clean labels; test acc at the best-val epoch."""
    spec = nets.NetSpec(module="sage", in_size=g.num_features, hidden_size=hidden,
                        out_size=g.num_classes, num_layers=2, dropout=0.5)
    state = S.init_state(torch.Generator(device=device).manual_seed(seed), spec,
                         lambda ps: torch.optim.Adam(ps, lr=lr), device)
    x = torch.from_numpy(g.x).to(device)
    y = torch.from_numpy(g.y).to(device).long()
    ei = torch.from_numpy(g.edge_index).to(device)
    idx = {k: torch.from_numpy(v).to(device).long() for k, v in g.split_idx().items()}
    gen = torch.Generator(device=device).manual_seed(seed + 1)

    def accs():
        with torch.no_grad():
            pred = nets.apply(spec, state.params, x, ei, train=False)["logits"].argmax(-1)
        return tuple(float((pred[ix] == y[ix]).float().mean())
                     for ix in (idx["valid"], idx["test"]))

    best_va, best_te = -1.0, 0.0
    for ep in range(epochs):
        out = nets.apply(spec, state.params, x, ei, train=True, gen=gen)["logits"]
        S._step((state,), torch.nn.functional.cross_entropy(out[idx["train"]],
                                                            y[idx["train"]]))
        if ep % 5 == 4 or ep == epochs - 1:
            va_a, te_a = accs()
            if va_a > best_va:
                best_va, best_te = va_a, te_a
    return best_te


def probe(name: str, fnoise: float, scale: int, epochs: int, hidden: int, lr: float,
          via_cli: bool = False, device=torch.device("cpu")) -> float:
    """Clean accuracy of ``name`` with ``feature_noise`` = ``fnoise``."""
    prof = D.DATASET_REGISTRY[name]
    D.DATASET_REGISTRY[name] = dataclasses.replace(prof, feature_noise=fnoise)
    try:
        t0 = time.time()
        with tempfile.TemporaryDirectory() as td:
            if via_cli:
                # products scale: the pipeline (mini-batch train, full-graph
                # eval) with no injected noise, so 'baseline' is the clean band
                from ..main import main as port_main

                base = {"ogbn-products": "config_products.yml",
                        "ogbn-arxiv": "config_arxiv.yml"}[name]
                cfg = load_config(str(ROOT / "configs" / base))
                cfg.update(dict(
                    dataset_name=name, train_type="baseline", compare_loss="normal",
                    noise_rate=0.0, noise_type="sym", num_runs=1, max_epochs=epochs,
                    synthetic_scale=scale, data_dir=td, out_dir=f"{td}/out", batch_id=98,
                    epoch_logger=False, exact_leaf=True, what="", module="sage",
                    module_compare="sage", device=str(device)))
                acc = float(port_main(cfg)["baseline"][0])
            else:
                g = D.load_network({"dataset_name": name, "seed": 0, "synthetic_scale": scale,
                                    "data_dir": td})
                acc = train_eval(g, epochs=epochs, hidden=hidden, lr=lr, device=device)
        log(f"  {name} f={fnoise:.3f} -> test {acc:.3f}  ({time.time() - t0:.0f}s)")
        return acc
    finally:
        D.DATASET_REGISTRY[name] = prof


def calibrate(name: str, lo: float, hi: float, iters: int, **probe_kw) -> dict:
    """Geometric bisection of ``feature_noise`` between ``lo`` (easy) and
    ``hi`` (hard) towards ``TARGETS[name]``."""
    target = TARGETS[name]
    probes = []
    for _ in range(iters):
        mid = (lo * hi) ** 0.5
        t0 = time.perf_counter()
        acc = probe(name, mid, **probe_kw)
        probes.append({"feature_noise": mid, "acc": acc, "s": time.perf_counter() - t0})
        if acc > target:
            lo = mid  # too easy -> more noise
        else:
            hi = mid
    return {"target": target, "probes": probes, "feature_noise": (lo * hi) ** 0.5,
            "registry": D.DATASET_REGISTRY[name].feature_noise}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("datasets", nargs="+")
    ap.add_argument("--scale", type=int, default=1)
    ap.add_argument("--epochs", type=int, default=80)
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--lr", type=float, default=5e-3)
    ap.add_argument("--iters", type=int, default=5, help="bisection steps")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--cli", action="store_true",
                    help="probe via the pipeline (mini-batch train + full-graph eval); "
                         "required at ogbn-products scale")
    ap.add_argument("--lo", type=float, default=0.2)
    ap.add_argument("--hi", type=float, default=8.0,
                    help="raise for dense graphs (deg ~25 aggregation suppresses feature "
                         "noise ~5x per hop)")
    a = ap.parse_args(argv)
    dev = tool_device(a.cpu)
    out = {}
    for name in a.datasets:
        log(f"== {name} target {TARGETS[name]:.2f} (scale {a.scale})")
        out[name] = calibrate(name, a.lo, a.hi, a.iters, scale=a.scale, epochs=a.epochs,
                              hidden=a.hidden, lr=a.lr, via_cli=a.cli, device=dev)
        log(f"{name}: feature_noise={out[name]['feature_noise']:.2f}")
    print(json.dumps({"metric": "clean_test_acc", "datasets": out, "scale": a.scale,
                      "epochs": a.epochs, "hidden": a.hidden, "lr": a.lr,
                      "via_cli": a.cli, **card_info(dev)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
