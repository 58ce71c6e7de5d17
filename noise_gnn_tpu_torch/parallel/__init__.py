"""Parallelism over ranks of a ``torch.distributed`` process group.

Port of ``noise_gnn_tpu/parallel/``. The JAX package runs one controller
over a mesh of devices; the port runs one process per rank, each with one
device, and says where data lives by what each rank holds:

* ``multihost`` -- joining the process group (torchrun's environment or
                   explicit arguments; nccl for card ranks, gloo for CPU);
* ``mesh``      -- the (data, model) grid over the ranks, the TP rule and
                   the collectives (all-reduce, all-gather, all_to_all,
                   point-to-point rounds; the column gather and the input
                   gradient sum of the model axis);
* ``dp``        -- data-parallel co-teaching steps: each step's seeds split
                   over ``data``, parameters replicated, the gradients summed
                   in one all-reduce;
* ``partition`` -- edge-partitioned full-graph aggregation, features
                   replicated, one all-reduce of the partials;
* ``halo``      -- node-sharded aggregation with a boundary exchange (the
                   pipelines' full-graph eval under DP);
* ``fullbatch`` -- full-graph training through the halo exchange.

With ``model_parallel`` M > 1 the ranks form a (world / M, M) grid: the
data axis as above, and tensor parallelism over the model axis, where each
rank holds a contiguous column block of the weights the JAX package's rule
picks (``mesh.param_sharding``) and the products run column-parallel
(``models/layers.py::tp_matmul``).

``mesh`` and ``multihost`` import only torch, so the model and op layers
use the collectives; ``dp`` and ``partition``, which import the models and
the training steps, load at their first use here.
"""

import importlib

from .mesh import batch_sharding, make_mesh, param_sharding, replicated
from .multihost import initialize as distributed_initialize, process_info

_LATER = {"make_dp_ct_epoch": "dp", "make_dp_ct_step": "dp", "shard_batch": "dp",
          "make_partitioned_inference": "partition", "partitioned_spmm_sum": "partition",
          "partitioned_spmm_mean": "partition", "shard_edges": "partition"}

__all__ = [
    "make_mesh",
    "param_sharding",
    "replicated",
    "batch_sharding",
    "make_dp_ct_epoch",
    "make_dp_ct_step",
    "shard_batch",
    "make_partitioned_inference",
    "partitioned_spmm_sum",
    "partitioned_spmm_mean",
    "shard_edges",
    "distributed_initialize",
    "process_info",
]


def __getattr__(name: str):
    if name in _LATER:
        return getattr(importlib.import_module(f".{_LATER[name]}", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
