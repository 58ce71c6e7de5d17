"""Weights carried between the JAX package and the port.

The JAX params pytree, as numpy (``jax.tree.map(np.asarray, params)``), is
``{"convs": [{"w_neigh", "w_root", "b"} | {"w", "b"}, ...]}`` with weight
matrices ``[in, out]`` (noise_gnn_tpu/models/layers.py:66-72), plus
``"noise"`` [nbr_nodes, in_size] for sagePL. The port keeps
the same structure and the same ``[in, out]`` layout at its public
functions (``x @ w``), so the mapping is a copy into f32 tensors; nothing is
transposed.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_jax(params_np: dict, device=None) -> dict:
    """JAX-layout numpy params -> the port's params (f32 leaf tensors)."""
    def t(v):
        return torch.tensor(np.asarray(v), dtype=torch.float32, device=device)

    out = {"convs": [{k: t(v) for k, v in conv.items()} for conv in params_np["convs"]]}
    if "noise" in params_np:
        out["noise"] = t(params_np["noise"])
    return out


def params_to_jax(params: dict) -> dict:
    """The inverse: the port's params -> JAX-layout numpy arrays."""
    def a(v):
        return v.detach().cpu().numpy()

    out = {"convs": [{k: a(v) for k, v in conv.items()} for conv in params["convs"]]}
    if "noise" in params:
        out["noise"] = a(params["noise"])
    return out
