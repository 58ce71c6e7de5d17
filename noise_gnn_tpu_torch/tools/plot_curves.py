"""Curve plots of the evidence suite's row artifacts.

    python -m noise_gnn_tpu_torch.tools.plot_curves docs/evidence/h100 [more dirs/files...]

The port's copy of ``tools/plot_curves.py``, which ``evidence.py`` beside
it runs on its artifact directory as the JAX tool runs its own (in a
process of its own, by this file's path: it imports nothing of the
package). For
every artifact holding per-epoch curves (the ``_curves`` field the
evidence suite harvests) it writes ``curves_<rowstem>.png`` next to it,
with three aligned panels:

  1. test accuracy          — the verdict criterion trajectory
  2. train acc vs NOISY y   — fit to the corrupted training targets
  3. noisy_fit              — fit to the flipped label on the corrupted
                              subset only (the direct memorization signal)

Per-run draws are thin translucent lines; the per-branch mean is bold.
Color follows the entity (CE baseline vs noise-robust algorithm), never
the run index; the two co-teaching nets share the branch hue (net 2
dashed).
"""

from __future__ import annotations

import glob
import json
import os
import sys

import numpy as np

# validated categorical palette, light mode, fixed slot order
CE_COLOR = "#2a78d6"      # slot 1 blue  — plain-CE baseline
NALGO_COLOR = "#eb6834"   # slot 2 orange — noise-robust algorithm
TEXT = "#3d3d3a"
GRID = "#d9d8d2"

PANELS = [
    ("test accuracy", ["test_acc", "test_acc_1", "test_acc_2"]),
    ("train acc vs noisy labels",
     ["train_acc_noisy", "train_acc_noisy_1", "train_acc_noisy_2"]),
    ("noisy-fit (corrupted subset)",
     ["noisy_fit", "noisy_fit_1", "noisy_fit_2"]),
]


def _branch_series(curves: dict, keys: list[str]):
    """(branch, run) -> list of (epochs, values, dashed) for one panel."""
    out: dict = {}
    for ckey, c in curves.items():
        ev = ckey.split("_r")[0]
        if ev == "epoch_baseline":
            branch = "CE"
        elif ev in ("epoch_ct", "epoch_te", "epoch_ctp", "epoch_h"):
            branch = "nalgo"
        else:
            continue
        for k in keys:
            if k in c:
                out.setdefault(branch, []).append(
                    (c["epoch"], c[k], k.endswith("_2"))
                )
    return out


def plot_artifact(path: str) -> str | None:
    with open(path) as f:
        art = json.load(f)
    curves = art.get("result", {}).get("_curves")
    if not curves:
        return None

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    panels = [(title, _branch_series(curves, keys)) for title, keys in PANELS]
    panels = [(t, s) for t, s in panels if s]
    if not panels:
        return None

    fig, axes = plt.subplots(len(panels), 1, figsize=(7, 2.6 * len(panels)),
                             sharex=True, constrained_layout=True)
    if len(panels) == 1:
        axes = [axes]
    color = {"CE": CE_COLOR, "nalgo": NALGO_COLOR}

    def _segments(ep, vals):
        """Split at epoch regressions (reinit-retried runs concatenate
        [0..k_abort, 0..max] in one harvested stream)."""
        out, start = [], 0
        for i in range(1, len(ep)):
            if ep[i] <= ep[i - 1]:
                out.append((ep[start:i], vals[start:i]))
                start = i
        out.append((ep[start:], vals[start:]))
        return out

    for ax, (title, series) in zip(axes, panels):
        for branch, runs in series.items():
            finals = []  # last contiguous segment per trace (the kept run)
            for ep, vals, dashed in runs:
                segs = _segments(ep, vals)
                for se, sv in segs:
                    ax.plot(se, sv, color=color[branch], linewidth=1.0,
                            alpha=0.3, linestyle="--" if dashed else "-")
                finals.append(segs[-1])
            # bold mean across the kept segments (align on the shortest)
            if finals:
                nmin = min(len(v) for _, v in finals)
                mean = np.mean([v[:nmin] for _, v in finals], axis=0)
                ax.plot(finals[0][0][:nmin], mean, color=color[branch],
                        linewidth=2.0, label=f"{branch} (mean)")
        ax.set_title(title, fontsize=10, color=TEXT, loc="left")
        ax.grid(True, color=GRID, linewidth=0.6, alpha=0.6)
        ax.tick_params(colors=TEXT, labelsize=8)
        for side in ("top", "right"):
            ax.spines[side].set_visible(False)
        for side in ("left", "bottom"):
            ax.spines[side].set_color(GRID)
        ax.legend(fontsize=8, frameon=False, labelcolor=TEXT)
    axes[-1].set_xlabel("epoch", fontsize=9, color=TEXT)
    fig.suptitle(art.get("label", os.path.basename(path)), fontsize=11,
                 color=TEXT)

    stem = os.path.splitext(os.path.basename(path))[0]
    out = os.path.join(os.path.dirname(path), f"curves_{stem}.png")
    fig.savefig(out, dpi=150, facecolor="white")
    plt.close(fig)
    return out


def main(argv=None) -> int:
    targets = []
    for a in (sys.argv[1:] if argv is None else argv) or ["docs/evidence/h100"]:
        if os.path.isdir(a):
            targets += sorted(glob.glob(os.path.join(a, "*.json")))
        else:
            targets.append(a)
    for p in targets:
        out = plot_artifact(p)
        if out:
            print(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
