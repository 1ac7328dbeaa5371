"""Experiment tagging and metric-record flattening.

Equivalents of the reference's Neptune helpers (utils/misc.py:317-336), a
copy of medicalsemseg_tpu/utils/tags.py with the tag function renamed:
`experiment_tags` produces the same tag list; `log_metrics` appends the
per-epoch metric dict to a JSON-lines sink (the no-egress stand-in for
neptune_logger[k].log(v, epoch)).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

from medicalsemseg_tpu_torch.config import Config


def experiment_tags(cfg: Config) -> List[str]:
    """Same tags as the reference (utils/misc.py:323-336)."""
    tags = ["Finetuning", cfg.model]
    tags.append("3D" if cfg.input_dim == 3 else "2D")
    if cfg.task[0:4] == "Task":
        tags.append("Decathlon")
    elif cfg.task in ("Abdomen", "Cervix"):
        tags.append("BTCV")
    tags.append(cfg.task)
    return tags


def log_metrics(log_dir: str, metric_dict: Dict) -> None:
    """Append an epoch's metrics (reference log_to_neptune shape) to
    log_dir/metrics.jsonl."""
    os.makedirs(log_dir, exist_ok=True)
    with open(os.path.join(log_dir, "metrics.jsonl"), "a") as f:
        f.write(json.dumps(metric_dict) + "\n")
