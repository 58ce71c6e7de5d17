"""CLI entry: ``python -m noise_gnn_tpu_torch.main -config configs/<x>.yml``.

Dispatches as the JAX package's ``main.py:30-59`` does, for the algorithms
this port runs: ``coteaching`` and ``codi`` train ``PipelineCO`` on the OGB
datasets and ``PipelineS`` on the small graphs; ``baseline`` forces
``train_type: baseline`` on the same pipelines; ``ctp`` trains
``PipelineCTP``. Every other ``algo_type`` (and the ``_test2``/``_test3``
variants) raises "not yet ported". Runs on the CUDA card unless the config
says ``device: 'cpu'``.
"""

from __future__ import annotations

import argparse

from .train.pipelines import PipelineCO, PipelineCTP, PipelineS, not_yet_ported
from .utils.config import load_config

OGB = ("ogbn-arxiv", "ogbn-products")


def main(config: dict):
    algo = config["algo_type"]
    if algo in ("codi", "coteaching"):
        if config.get("what") in ("_test2", "_test3"):
            raise not_yet_ported(f"what: {config['what']!r} (PipelineTE/TES)")
        cls = PipelineCO if config["dataset_name"] in OGB else PipelineS
    elif algo == "baseline":
        config["train_type"] = "baseline"
        cls = PipelineCO if config["dataset_name"] in OGB else PipelineS
    elif algo == "ctp":
        cls = PipelineCTP
    else:
        raise not_yet_ported(f"algo_type {algo!r}")
    return cls(config).loop()


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("-config", "--config", required=True, type=str,
                        help="configuration file path")
    args = parser.parse_args()
    main(load_config(args.config))
