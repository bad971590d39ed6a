"""Metrics logging: one JSON line per record in <logdir>/metrics.jsonl,
echoed to stdout, and the log directories' timestamp. Counterpart of
storygen_tpu/utils/logging.py (MetricLogger, get_time_string) without the
optional tensorboard writer."""
from __future__ import annotations

import json
import os
import time
from datetime import datetime
from typing import Dict


def get_time_string() -> str:
    """Timestamp suffix for log dirs."""
    return datetime.now().strftime("%Y%m%dT%H%M%S")


class MetricLogger:
    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(logdir, "metrics.jsonl")

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        rec = {"step": step, "time": time.time(), **metrics}
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(f"step {step}: " + " ".join(f"{k}={v:.5g}"
                                          for k, v in metrics.items()),
              flush=True)
