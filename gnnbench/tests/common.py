"""Small sizes at which the tests run the cells on the CPU."""

import torch

torch.set_num_threads(1)

SMALL = {
    "products_sage_co": {"synthetic_scale": 1000, "batch_size": 64},
    "products_sage_eval": {"synthetic_scale": 1000},
    "arxiv_sagepl_te": {"synthetic_scale": 100, "batch_size": 64, "nbr_neighbors": [3, 2, 2]},
    "arxiv_sagepl_warm": {"synthetic_scale": 100, "batch_size": 64, "nbr_neighbors": [3, 2, 2]},
}


def run_cell(workload: str, seed: int, trace: int = 0, overrides=None, capsys=None):
    """(exit code, result dict or None) of one run on the CPU."""
    import json

    from gnnbench import run

    ov = dict(SMALL[workload])
    ov.update(overrides or {})
    rc = run.main(["--workload", workload, "--seed", str(seed), "--seconds", "0.5",
                   "--trace", str(trace)], device="cpu", overrides=ov)
    if capsys is None:
        return rc, None
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    return rc, (json.loads(lines[-1]) if lines else None)
