"""Probe: does co-teaching recover on the hard flagship noise draw given a
longer epoch budget?

    python -m noise_gnn_tpu_torch.tools.probe_hard_draw [EPOCHS=100] [--cpu]

Port of ``tools/probe_hard_draw.py``. The JAX package's round-3 flagship
measurement found the (seed 1232, run 1) ``rand_pair`` draw on the
synthetic ogbn-products collapsing co-teaching at the 50-epoch budget;
the JAX tool re-trained the same draw for 100 epochs and measured recovery
(the source of ``noise_gnn_tpu/train/pipelines.py``'s reinit retry). This
tool re-trains the same draw with the port: ``PipelineCO`` on
``configs/config_products.yml`` with ``train_type: nalgo``,
``compare_loss: normal``, ``num_runs: 1``, ``batch_id: 95``,
``exact_leaf: true`` and ``max_epochs`` EPOCHS, every (re)flip forced onto
run 1's realization (:class:`HardDrawCO`). The noise draw is host numpy
keyed by (seed, run), so it is the JAX package's bit for bit; the nets'
init comes from ``torch.Generator`` and cannot match JAX's.

Its JSON line gives ``hard_draw_ct_best`` and ``epochs`` (the JAX tool's
keys), the per-epoch curve (best test accuracy of the pair, both selection
purities, train and eval seconds), the run's reinit attempts, and the card.
The graph comes from ``data_dir`` relative to the working directory (run it
from the repo root, as the JAX tool); logs and metrics go under ``out/``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from ..train.pipelines import PipelineCO
from ..utils.config import load_config
from .common import ROOT, card_info, log, tool_device

HARD_RUN = 1  # the run index of the paired evidence measurement's collapsed draw


class HardDrawCO(PipelineCO):
    """PipelineCO whose every (seed, run)-keyed reflip takes run 1's draw."""

    def _flip_labels(self, run=None):
        super()._flip_labels(HARD_RUN if run is not None else None)


def run(epochs: int = 100, **overrides) -> dict:
    """Train the hard draw for ``epochs`` epochs; ``overrides`` update the
    config last (``device: 'cpu'``, ``synthetic_scale``, ``data_dir``,
    ``out_dir``, ...)."""
    dev = tool_device(str(overrides.get("device", "cuda")) == "cpu")
    cfg = load_config(str(ROOT / "configs" / "config_products.yml"))
    cfg.update(train_type="nalgo", compare_loss="normal", num_runs=1, max_epochs=epochs,
               batch_id=95, exact_leaf=True)
    cfg.update(overrides)
    log(f"device: {dev}; config_products.yml, {epochs} epochs, run {HARD_RUN}'s draw")
    pipe = HardDrawCO(cfg)
    summary = pipe.loop()["nalgo"]
    pipe.metrics.close()
    metrics = Path(pipe.metrics.path)
    recs = [json.loads(line) for line in metrics.read_text().splitlines()]
    # the file appends: this run's records follow its own (the last) setup record
    last_setup = max(i for i, r in enumerate(recs) if r.get("event") == "setup")
    recs = recs[last_setup:]
    ep = [r for r in recs if r.get("event") == "epoch_ct"]
    reinits = [r for r in recs if r.get("event") == "reinit_degenerate"]
    return {"hard_draw_ct_best": round(float(summary[0]), 4), "epochs": epochs,
            "best_unrounded": float(summary[0]),
            "reinit_attempts": len(reinits),
            "clean_fraction": float(pipe.clean.mean()),
            "feat": int(pipe.graph.num_features), "hidden": int(cfg["hidden_size"]),
            "curve": {"epoch": [r["epoch"] for r in ep],
                      "test_best": [max(r["test_acc_1"], r["test_acc_2"]) for r in ep],
                      "pure_ratio_1": [r["pure_ratio_1"] for r in ep],
                      "pure_ratio_2": [r["pure_ratio_2"] for r in ep],
                      "epoch_train_s": [r["epoch_train_s"] for r in ep],
                      "epoch_eval_s": [r["epoch_eval_s"] for r in ep]},
            "metrics_path": str(metrics), **card_info(dev)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("epochs", nargs="?", type=int, default=100)
    ap.add_argument("--cpu", action="store_true")
    a = ap.parse_args(argv)
    res = run(a.epochs, **({"device": "cpu"} if a.cpu else {}))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
