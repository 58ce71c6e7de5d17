"""Weights carried between the JAX package and the port.

The JAX params pytree, as numpy (``jax.tree.map(np.asarray, params)``), is
``{"convs": [{"w_neigh", "w_root", "b"} | {"w", "b"}, ...]}`` with weight
matrices ``[in, out]`` (noise_gnn_tpu/models/layers.py:66-72), plus
``"noise"`` [nbr_nodes, in_size] for sagePL, ``"proj"`` {"w", "b"} and
``"bnl"`` {"scale", "bias"} for sageFC, ``"act"`` {"alpha"} (a 0-d array)
for sageH and sageFC, and ``"bn1"``/``"bn2"`` {"scale", "bias"} under
``use_bn``; GAT's is ``{"layers": [{"w", "a"}, ...]}``. The port keeps the
same structure and the same ``[in, out]`` layout at its public functions
(``x @ w``), so the mapping is a copy into f32 tensors; nothing is
transposed. A key outside that structure raises rather than being dropped.
"""

from __future__ import annotations

import numpy as np
import torch

# top-level entries besides the layer list -> the keys each holds (None: one array)
_BN = {"scale", "bias"}
_ENTRIES = {"noise": None, "proj": {"w", "b"}, "bnl": _BN, "bn1": _BN, "bn2": _BN,
            "act": {"alpha"}}
# the layer lists -> the key sets their items may have
_LISTS = {"convs": ({"w_neigh", "w_root", "b"}, {"w", "b"}), "layers": ({"w", "a"},)}


def _check(params: dict) -> None:
    lists = [name for name in _LISTS if name in params]
    if len(lists) != 1:
        raise ValueError(f"params need one of {sorted(_LISTS)}, got {sorted(params)}")
    unknown = set(params) - set(lists) - set(_ENTRIES)
    if unknown:
        raise ValueError(f"params entries {sorted(unknown)} are not carried by the port")
    name = lists[0]
    for i, layer in enumerate(params[name]):
        if set(layer) not in _LISTS[name]:
            raise ValueError(f"{name}[{i}] has keys {sorted(layer)}, not one of "
                             f"{[sorted(k) for k in _LISTS[name]]}")
    for name, keys in _ENTRIES.items():
        if keys is not None and name in params and set(params[name]) != keys:
            raise ValueError(f"params[{name!r}] has keys {sorted(params[name])}, "
                             f"expected {sorted(keys)}")


def _map(params: dict, leaf) -> dict:
    _check(params)
    out = {name: [{k: leaf(v) for k, v in layer.items()} for layer in params[name]]
           for name in _LISTS if name in params}
    for name, keys in _ENTRIES.items():
        if name in params:
            v = params[name]
            out[name] = leaf(v) if keys is None else {k: leaf(v[k]) for k in v}
    return out


def params_from_jax(params_np: dict, device=None) -> dict:
    """JAX-layout numpy params -> the port's params (f32 leaf tensors)."""
    return _map(params_np, lambda v: torch.tensor(np.asarray(v), dtype=torch.float32,
                                                  device=device))


def params_to_jax(params: dict) -> dict:
    """The inverse: the port's params -> JAX-layout numpy arrays."""
    return _map(params, lambda v: v.detach().cpu().numpy())
