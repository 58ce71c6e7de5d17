"""Render a run's metrics JSONL as the reference's multi-panel PNG.

    python -m noise_gnn_tpu_torch.tools.plot_metrics out/metrics/<run>.jsonl [-o plot.png]

The port's copy of ``tools/plot_metrics.py``, over the port's
``utils/plotting.py``.
"""

from __future__ import annotations

import argparse
import sys

from ..utils.plotting import plot_metrics_file


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("metrics_file")
    ap.add_argument("-o", "--out", default=None)
    a = ap.parse_args(argv)
    out = plot_metrics_file(a.metrics_file, a.out)
    print(f"wrote {out}" if out else "nothing to plot")
    return 0


if __name__ == "__main__":
    sys.exit(main())
