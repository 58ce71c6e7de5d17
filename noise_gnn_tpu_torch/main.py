"""CLI entry: ``python -m noise_gnn_tpu_torch.main -config configs/<x>.yml``.

Dispatches as the JAX package's ``main.py:30-59`` does, for the algorithms
this port runs: ``coteaching`` and ``codi`` train ``PipelineCO`` on the OGB
datasets and ``PipelineS`` on the small graphs, or, with ``what: _test2`` or
``_test3``, ``PipelineTE`` (OGB) and ``PipelineTES``; ``baseline`` forces
``train_type: baseline`` on ``PipelineCO``/``PipelineS``; ``ctp`` trains
``PipelineCTP``, ``contrastive`` ``PipelineCT``, ``hpseudo`` ``PipelineH``,
``grid`` ``PipelineSG`` and ``analysis`` ``PipelineA``: every one of the 36
configs under ``configs/`` dispatches. Runs on the CUDA card unless the
config says ``device: 'cpu'``. As the JAX package's entry does, ``main``
first configures glibc's malloc for large buffers (``utils/memory.py``),
and the command line pre-faults ``warm_heap_gb`` GB of heap when the
config asks for it.

Several ranks: ``torchrun --nproc_per_node N -m noise_gnn_tpu_torch.main
-config ...``. When ``WORLD_SIZE`` > 1 and no process group exists yet,
``main`` joins one (``parallel/multihost.py``: NCCL, each rank on the card
of its ``LOCAL_RANK``; gloo under ``device: 'cpu'``), as the JAX package
sees every device without being asked; every pipeline then trains
data-parallel, and with ``model_parallel: M`` > 1 tensor-parallel over M
ranks of each data index (``torchrun --nproc_per_node 4`` at M = 2 is a
(2, 2) grid).
"""

from __future__ import annotations

import argparse
import os

from .parallel import multihost
from .train.pipelines import (PipelineA, PipelineCO, PipelineCT, PipelineCTP, PipelineH,
                              PipelineS, PipelineSG, PipelineTE, PipelineTES)
from .utils.config import load_config
from .utils.memory import configure_malloc, warm_heap

OGB = ("ogbn-arxiv", "ogbn-products")


def main(config: dict):
    configure_malloc()
    if int(os.environ.get("WORLD_SIZE", 1)) > 1:
        multihost.initialize(device=str(config.get("device", "cuda")))
    algo = config["algo_type"]
    ogb = config["dataset_name"] in OGB
    if algo in ("codi", "coteaching"):
        if config.get("what") in ("_test2", "_test3"):
            cls = PipelineTE if ogb else PipelineTES
        else:
            cls = PipelineCO if ogb else PipelineS
    elif algo == "baseline":
        config["train_type"] = "baseline"
        cls = PipelineCO if ogb else PipelineS
    elif algo == "ctp":
        cls = PipelineCTP
    elif algo == "contrastive":
        cls = PipelineCT
    elif algo == "grid":
        cls = PipelineSG
    elif algo == "analysis":
        cls = PipelineA
    elif algo == "hpseudo":
        cls = PipelineH
    else:
        raise ValueError(f"wrong algo type {algo!r}")
    return cls(config).loop()


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("-config", "--config", required=True, type=str,
                        help="configuration file path")
    args = parser.parse_args()
    config = load_config(args.config)
    warm_gb = float(config.get("warm_heap_gb", 0))
    if warm_gb > 0:
        print(f"warming {warm_gb:g} GB of heap ...")
        warm_heap(int(warm_gb * (1 << 30)))  # after configure_malloc, which it calls
    main(config)
