"""Multi-panel training plots from the metrics JSONL (reference parity:
the matplotlib tails of every pipeline, e.g. src/pipeline.py:315-360).

The port's own copy of ``noise_gnn_tpu/utils/plotting.py``. matplotlib is
optional: without it no plot is written and the caller gets None.
"""

from __future__ import annotations

import json
import os

PANELS = [
    ("accuracy", ["train_acc_1", "train_acc_2", "val_acc_1", "val_acc_2",
                  "train_acc", "val_acc"]),
    ("test accuracy", ["test_acc_1", "test_acc_2", "test_acc"]),
    ("pure ratio", ["pure_ratio_1", "pure_ratio_2"]),
    ("loss", ["loss_1", "loss_2", "loss", "loss_cont_1", "loss_cont_2",
              "loss_semi", "loss_cont", "loss_cr_1", "loss_cr_2"]),
]


def plot_metrics_file(metrics_path: str, out_path: str | None = None) -> str | None:
    """Render the reference-style 4-panel PNG; returns the output path or
    None when matplotlib is unavailable or no epoch rows exist. The default
    output is ``<out_dir>/plots/<run>.png``, beside ``metrics/`` (the
    reference writes to ../out_plots/, src/pipeline.py:359)."""
    with open(metrics_path) as f:
        rows = [json.loads(line) for line in f]
    epochs = [r for r in rows if r.get("event", "").startswith(("epoch", "warmup", "finetune"))]
    if not epochs:
        return None
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None

    fig, axs = plt.subplots(len(PANELS), 1, figsize=(10, 15))
    for ax, (title, keys) in zip(axs, PANELS):
        plotted = False
        for k in keys:
            ys = [r[k] for r in epochs if k in r]
            if ys:
                ax.plot(ys, label=k)
                plotted = True
        ax.set_title(title)
        if plotted:
            ax.legend(fontsize=7)
    plt.tight_layout()
    out = out_path or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(metrics_path))),
        "plots",
        os.path.basename(metrics_path).replace(".jsonl", ".png"),
    )
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    plt.savefig(out)
    plt.close(fig)
    return out
