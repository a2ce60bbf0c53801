"""Per-metric JSON statistics files and loss/accuracy plots (port of
lctvqa/train/stats.py; the reference's `basic_vqa/file_utils.py` and
`basic_vqa/plot.py:78-111`).

The files are the JAX package's, byte for byte: `json.dump` of a list of
floats. matplotlib is imported where a plot is drawn; where it is
missing, as on a card's machine, the plot is skipped with one log line
and the JSON files are written all the same.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Sequence


def read_file_in_dir(root_dir: str, file_name: str):
    path = os.path.join(root_dir, file_name)
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return json.load(f)


def write_to_file_in_dir(root_dir: str, file_name: str, data) -> None:
    os.makedirs(root_dir, exist_ok=True)
    with open(os.path.join(root_dir, file_name), "w") as f:
        json.dump(data, f)


def log_to_file_in_dir(root_dir: str, file_name: str, text: str) -> None:
    with open(os.path.join(root_dir, file_name), "a") as f:
        f.write(text + "\n")


def plot_loss_acc(losses: Sequence[float], accs: Sequence[float],
                  prefix: str, fname: str) -> bool:
    """Two-panel loss/accuracy PNG per epoch (plot.py:78-111). -> whether
    it was drawn: False, with a log line, where matplotlib is missing."""
    try:
        import matplotlib
    except ImportError:
        logging.info(f"matplotlib is not installed: {fname} not drawn")
        return False
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(10, 4))
    xs = list(range(1, len(losses) + 1))
    ax1.plot(xs, list(losses), marker="o")
    ax1.set_xlabel("epoch")
    ax1.set_ylabel("loss")
    ax1.set_title(f"{prefix} Loss")
    xs = list(range(1, len(accs) + 1))
    ax2.plot(xs, list(accs), marker="o")
    ax2.set_xlabel("epoch")
    ax2.set_ylabel("accuracy")
    ax2.set_title(f"{prefix} Accuracy")
    fig.tight_layout()
    fig.savefig(fname)
    plt.close(fig)
    return True
