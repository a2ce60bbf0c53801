"""Device-side counters (port of the jnp half of lctvqa/train/metrics.py).
Each returns 0-d tensors on the device of its inputs; nothing here reads a
value back to the host. BLEU against the reference questions is host
work and comes with the eval slice.
"""

from __future__ import annotations

import torch


def num_correct(pred: torch.Tensor, multi_choice: torch.Tensor) -> torch.Tensor:
    """Count of predictions that match any multi-choice answer. pred [B],
    multi_choice [B, 10] padded with -1."""
    return (multi_choice == pred[:, None]).any(1).sum()


def mask_unk(pred: torch.Tensor, unk_idx: int) -> torch.Tensor:
    """`<unk>` predictions become -9999, so that they match no answer."""
    return torch.where(pred == unk_idx, torch.full_like(pred, -9999), pred)


def num_correct_qst(qst_logits: torch.Tensor, qst: torch.Tensor):
    """(exact, <= 3 errors, <= 5 errors) counts of teacher-forced
    questions."""
    pred = qst_logits.argmax(2)[:, :-1]
    err = (pred != qst[:, 1:]).sum(1)
    return (err == 0).sum(), (err <= 3).sum(), (err <= 5).sum()
