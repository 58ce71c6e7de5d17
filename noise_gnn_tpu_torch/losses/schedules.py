"""Forget-rate schedules for co-teaching small-loss selection.

The port's copy of ``noise_gnn_tpu/losses/schedules.py`` (numpy only).

All three reference variants (SURVEY §2.3):
  * 'ogb'      — ramp to noise_rate**ct_exp over ct_tk epochs, then flat at
                 noise_rate*ct_tau                (src/pipeline.py:48-49)
  * 'small'    — ramp to noise_rate*ct_tau, then flat at the same value
                 (src/pipeline_s.py:52-53)
  * 'contrast' — ramp to noise_rate over ct_tk, then noise_rate*ct_tau until
                 `warmup`, then 1.0               (src/pipeline_contrast.py:44-46)
"""

from __future__ import annotations

import numpy as np


def forget_rate_schedule(
    max_epochs: int,
    noise_rate: float,
    ct_tk: int,
    ct_tau: float,
    ct_exp: float = 1.0,
    warmup: int | None = None,
    variant: str = "ogb",
) -> np.ndarray:
    # runs shorter than the ramp keep the ramp's shape, truncated (the
    # reference's slice assignment would crash when max_epochs < ct_tk)
    tk = min(ct_tk, max_epochs)
    if variant == "ogb":
        sched = np.ones(max_epochs) * noise_rate * ct_tau
        sched[:tk] = np.linspace(0, noise_rate**ct_exp, ct_tk)[:tk]
    elif variant == "small":
        sched = np.ones(max_epochs) * noise_rate * ct_tau
        sched[:tk] = np.linspace(0, noise_rate * ct_tau, ct_tk)[:tk]
    elif variant == "contrast":
        if warmup is None:
            raise ValueError("'contrast' schedule needs warmup")
        sched = np.ones(max_epochs)
        sched[:tk] = np.linspace(0, noise_rate, ct_tk)[:tk]
        sched[tk:warmup] = sched[tk:warmup] * noise_rate * ct_tau
    else:
        raise ValueError(f"unknown schedule variant {variant!r}")
    return sched.astype(np.float32)
