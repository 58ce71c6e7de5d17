"""Checkpointing: a bundle of named tensors plus the run's position.

Port of ``noise_gnn_tpu/utils/checkpoint.py`` in its spirit: one ``.npz`` of
the bundle's flattened leaves and a JSON sidecar with the leaves' names and
``meta``. Nothing is pickled, so loading needs neither ``torch.load`` nor
``allow_pickle``. A bundle is any nest of dicts (flattened in sorted key
order, as a JAX pytree is), lists and tuples whose leaves are tensors; it is
restored into the structure, dtypes and devices of a template nest. A
``None`` leaf of the template takes the stored array as it is, whatever
its shape, as a CPU tensor (the contrastive finetune's split ids).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch


def _flatten(tree, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flatten(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in _flatten(v, f"{prefix}{i}/")]
    return [(prefix.rstrip("/"), tree)]


def _unflatten(like, leaves: list):
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(like)


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _sidecar(path: str) -> str:
    base = path[:-4] if path.endswith(".npz") else path
    return base + ".json"


def save_checkpoint(path: str, tree, meta: dict | None = None) -> None:
    """Write the bundle's leaves to ``<path>.npz`` and their names and
    ``meta`` (JSON-serialisable) to ``<path>.json``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    leaves = _flatten(tree)
    np.savez(_npz(path), **{f"leaf_{i}": v.detach().cpu().numpy()
                            for i, (_, v) in enumerate(leaves)})
    side = {"leaves": [k for k, _ in leaves], "num_leaves": len(leaves), "meta": meta or {}}
    with open(_sidecar(path), "w") as f:
        json.dump(side, f)


def load_checkpoint(path: str, like):
    """Restore a bundle into the structure of ``like`` (a template nest of
    tensors); returns (bundle, meta). Raises ValueError when the checkpoint's
    leaves are not the template's."""
    with np.load(_npz(path)) as z:
        arrays = [z[f"leaf_{i}"] for i in range(len(z.files))]
    with open(_sidecar(path)) as f:
        side = json.load(f)
    tmpl = _flatten(like)
    if len(tmpl) != len(arrays):
        raise ValueError(f"checkpoint has {len(arrays)} leaves, template expects {len(tmpl)}")
    names = [k for k, _ in tmpl]
    if side["leaves"] != names:
        bad = next(i for i, (a, b) in enumerate(zip(side["leaves"], names)) if a != b)
        raise ValueError(f"checkpoint leaf {bad} is {side['leaves'][bad]!r}, template "
                         f"expects {names[bad]!r}")
    leaves = []
    for (name, t), a in zip(tmpl, arrays):
        if t is None:
            leaves.append(torch.from_numpy(a))
            continue
        if tuple(a.shape) != tuple(t.shape):
            raise ValueError(f"checkpoint leaf {name!r} has shape {a.shape}, template "
                             f"expects {tuple(t.shape)}")
        leaves.append(torch.from_numpy(a).to(device=t.device, dtype=t.dtype))
    return _unflatten(like, leaves), side.get("meta", {})
