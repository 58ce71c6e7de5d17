"""Run logging: file logger (reference parity) + structured JSONL metrics.

Reference: src/utils/utils.py:19-42 writes ``../out_logs/<algo><what>/<run>.log``
and DEBUG-dumps the whole config. Here logs go under ``<out_dir>/logs/`` and
every epoch's metrics additionally land in a machine-readable JSONL stream
(the observability upgrade flagged in SURVEY §5).
"""

from __future__ import annotations

import json
import logging
import os
import time


def initialize_logger(config: dict, file_name: str) -> logging.Logger:
    logger = logging.getLogger(file_name)
    logger.handlers = []
    logger.setLevel(logging.DEBUG)
    logger.propagate = False

    log_dir = os.path.join(
        str(config.get("out_dir", "out")), "logs",
        f"{config.get('algo_type', '')}{config.get('what', '')}",
    )
    os.makedirs(log_dir, exist_ok=True)
    log_path = os.path.join(log_dir, file_name + ".log")
    if os.path.exists(log_path):
        os.remove(log_path)
    fh = logging.FileHandler(log_path)
    fh.setFormatter(logging.Formatter("%(asctime)s - %(levelname)s - %(message)s"))
    logger.addHandler(fh)
    sh = logging.StreamHandler()
    sh.setLevel(logging.INFO)
    sh.setFormatter(logging.Formatter("%(message)s"))
    logger.addHandler(sh)

    for key in sorted(config.keys()):
        pad = " " * max(24 - len(key), 1)
        logger.debug(f"{key}{pad}-->   {config[key]}")
    return logger


class MetricsWriter:
    """Append-only JSONL metrics stream, one object per epoch/step."""

    def __init__(self, config: dict, file_name: str):
        mdir = os.path.join(str(config.get("out_dir", "out")), "metrics")
        os.makedirs(mdir, exist_ok=True)
        self.path = os.path.join(mdir, file_name + ".jsonl")
        self._fh = open(self.path, "a")

    def write(self, **record) -> None:
        record.setdefault("ts", time.time())
        self._fh.write(json.dumps(record, default=float) + "\n")
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()
