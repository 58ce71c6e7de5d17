"""Weights carried between the JAX package and the port.

The JAX params pytree, as numpy (``jax.tree.map(np.asarray, params)``), is
``{"convs": [{"w_neigh", "w_root", "b"} | {"w", "b"}, ...]}`` with weight
matrices ``[in, out]`` (noise_gnn_tpu/models/layers.py:66-72), plus
``"noise"`` [nbr_nodes, in_size] for sagePL, ``"proj"`` {"w", "b"} and
``"bnl"`` {"scale", "bias"} for sageFC, ``"act"`` {"alpha"} (a 0-d array)
for sageH and sageFC, and ``"bn1"``/``"bn2"`` {"scale", "bias"} under
``use_bn``; GAT's is ``{"layers": [{"w", "a"}, ...]}``; the port's own
``gat_ns`` (no JAX counterpart) has ``{"convs": [{"w", "att_src",
"att_dst", "b", "skip_w", "skip_b"}, ...]}``. The port keeps the
same structure and the same ``[in, out]`` layout at its public functions
(``x @ w``), so the mapping is a copy into f32 tensors; nothing is
transposed. A key outside that structure raises rather than being dropped.

Under tensor parallelism (``model_parallel`` M > 1) a rank holds its
contiguous column block of each leaf that ``parallel/mesh.py::
param_sharding`` picks: :func:`shard_params` cuts it from the whole leaf,
:func:`gather_params` puts the blocks back together over the model axis.
Which leaves those are follows from the structure: each sharded leaf's
whole width is read from a replicated sibling (:func:`whole_widths`), so a
nest of blocks and a nest of whole leaves are told apart without a record
of how they were made.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.mesh import Mesh, all_gather, column_block, column_sharded

# top-level entries besides the layer list -> the keys each holds (None: one array)
_BN = {"scale", "bias"}
_ENTRIES = {"noise": None, "proj": {"w", "b"}, "bnl": _BN, "bn1": _BN, "bn2": _BN,
            "act": {"alpha"}}
# the layer lists -> the key sets their items may have
_GAT_NS = {"w", "att_src", "att_dst", "b", "skip_w", "skip_b"}  # the port's own module
_LISTS = {"convs": ({"w_neigh", "w_root", "b"}, {"w", "b"}, _GAT_NS), "layers": ({"w", "a"},)}


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


# ------------------------------------------------------ tensor parallelism


def whole_widths(params: dict) -> dict:
    """The whole column count of every leaf, as a nest of ``params``'s
    structure, read from leaves that are never sharded, so it holds for a
    rank's blocks as for the whole leaves: a conv's weights have its bias's
    width, a GAT layer's ``w`` half the rows of its ``a`` [2F', 1]
    (``a`` itself 1), sagePL's ``noise`` the first conv's input width
    (a weight's rows), ``proj.w`` its bias's; None for leaves under 2-D."""
    _check(params)
    out = {}
    if "convs" in params:
        out["convs"] = [_gat_ns_widths(layer) if set(layer) == _GAT_NS else
                        {k: None if k == "b" else int(layer["b"].shape[0]) for k in layer}
                        for layer in params["convs"]]
    if "layers" in params:
        out["layers"] = [{"w": int(layer["a"].shape[0]) // 2, "a": int(layer["a"].shape[1])}
                         for layer in params["layers"]]
    for name, keys in _ENTRIES.items():
        if name in params and keys is not None:
            out[name] = {k: None for k in params[name]}
    if "noise" in params:
        first = params["convs"][0]
        out["noise"] = int(first["w_neigh" if "w_neigh" in first else "w"].shape[0])
    if "proj" in params:
        out["proj"]["w"] = int(params["proj"]["b"].shape[0])
    return out


def _gat_ns_widths(layer: dict) -> dict:
    """A gat_ns layer's: ``w`` has the attention vectors' H * C columns,
    ``skip_w`` its bias's; the rest are never sharded (gat_ns runs in one
    process)."""
    return {"w": int(layer["att_src"].numel()), "att_src": None, "att_dst": None, "b": None,
            "skip_w": int(layer["skip_b"].shape[0]), "skip_b": None}


def _tp(mesh: Mesh | None) -> bool:
    return mesh is not None and mesh.model_size > 1


def _zip(params, widths, fn):
    """``fn(leaf, width)`` over the leaves of ``params`` and their widths."""
    if isinstance(params, dict):
        return {k: _zip(params[k], widths[k], fn) for k in params}
    if isinstance(params, list):
        return [_zip(p, w, fn) for p, w in zip(params, widths)]
    return fn(params, widths)


def _blocked(mesh: Mesh, t: torch.Tensor, width: int | None) -> bool | None:
    """For a leaf of whole ``width`` that the rule shards: True where ``t``
    is this rank's block, False where it is whole; None where the rule
    leaves the leaf whole. Raises on any other width."""
    if width is None or not column_sharded((t.shape[0], width), mesh.model_size):
        return None
    if t.shape[-1] not in (width, width // mesh.model_size):
        raise ValueError(f"a leaf of {t.shape[-1]} columns is neither whole ({width}) nor a "
                         f"block of {mesh.model_size}")
    return t.shape[-1] != width


def shard_leaf(mesh: Mesh | None, t: torch.Tensor, width: int | None) -> torch.Tensor:
    """This rank's column block (a contiguous copy) of a leaf of whole
    ``width`` that the rule shards; ``t`` itself otherwise, and where it
    is a block already."""
    if not _tp(mesh) or _blocked(mesh, t, width) is not False:
        return t
    return t[:, column_block(mesh, width)].contiguous()


def shard_params(mesh: Mesh | None, params: dict) -> dict:
    """This rank's params under tensor parallelism: the column block of
    each leaf that ``param_sharding`` picks, every other leaf as it is;
    ``params`` itself at M = 1."""
    if not _tp(mesh):
        return params
    return _zip(params, whole_widths(params), lambda t, w: shard_leaf(mesh, t, w))


def gather_leaves(mesh: Mesh | None, leaves: list, widths: list) -> list:
    """The whole leaves from this rank's: the blocks of every sharded leaf
    joined in one all-gather over the model axis (every model rank must
    call it), detached; the other leaves as they are."""
    if not _tp(mesh):
        return list(leaves)
    cut = [i for i, (t, w) in enumerate(zip(leaves, widths)) if _blocked(mesh, t, w)]
    if not cut:
        return list(leaves)
    m = mesh.model_size
    flat = torch.cat([leaves[i].detach().reshape(-1) for i in cut])
    every = all_gather(mesh.model_axis(), flat[None]).view(m, -1)
    out, base = list(leaves), 0
    for i in cut:
        rows, c = leaves[i].shape
        block = every[:, base:base + rows * c].view(m, rows, c)
        out[i] = block.permute(1, 0, 2).reshape(rows, m * c)
        base += rows * c
    return out


def gather_params(mesh: Mesh | None, params: dict) -> dict:
    """The whole params from this rank's (the inverse of
    :func:`shard_params`; whole leaves pass as they are); ``params``
    itself at M = 1. Every model rank must call it."""
    if not _tp(mesh):
        return params
    leaves, widths = [], []
    _zip(params, whole_widths(params), lambda t, w: (leaves.append(t), widths.append(w)))
    it = iter(gather_leaves(mesh, leaves, widths))
    return _zip(params, whole_widths(params), lambda t, w: next(it))
