"""Losses: cross entropy and soft cross entropy (port of
lctvqa/ops/losses.py). All in fp32; semantics of torch's
`nn.CrossEntropyLoss` (mean reduction) and the reference's `softXEnt`.
"""

from __future__ import annotations

import torch

f32 = torch.float32


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logits [N, C], labels [N] int -> scalar mean CE."""
    logp = torch.log_softmax(logits.to(f32), dim=-1)
    return -logp.gather(1, labels.long()[:, None])[:, 0].mean()


def soft_xent(logits: torch.Tensor, target_probs: torch.Tensor) -> torch.Tensor:
    """-(target * log_softmax(pred)).sum() / N."""
    logp = torch.log_softmax(logits.to(f32), dim=-1)
    return -(target_probs * logp).sum() / logits.shape[0]


def sequence_teacher_forcing_ce(qst_logits: torch.Tensor,
                                questions: torch.Tensor) -> torch.Tensor:
    """Shifted next-token CE: CE(logits[:, :-1] vs question[:, 1:]),
    flattened. Pad positions are NOT masked: `<pad>` is an ordinary target
    class, a quirk of the reference kept for parity."""
    v = qst_logits.shape[-1]
    return cross_entropy(qst_logits[:, :-1].reshape(-1, v),
                         questions[:, 1:].reshape(-1))
