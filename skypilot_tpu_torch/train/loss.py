"""Loss functions (fp32 softmax, optional z-loss, padding-aware): the
port of ``skypilot_tpu/train/loss.py``."""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       weights: Optional[torch.Tensor] = None,
                       z_loss_coeff: float = 0.0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-weighted mean cross entropy.

    logits [B,S,V] fp32, targets [B,S] int, weights [B,S] (1 = real
    token, 0 = pad). Returns (mean_loss, total_weight). z-loss (PaLM)
    regularizes the log-partition toward 0 for bf16 stability.
    """
    logits = logits.float()
    log_z = torch.logsumexp(logits, dim=-1)                        # [B,S]
    target_logits = torch.gather(
        logits, -1, targets.long()[..., None]).squeeze(-1)         # [B,S]
    nll = log_z - target_logits
    if z_loss_coeff:
        nll = nll + z_loss_coeff * torch.square(log_z)
    if weights is None:
        weights = torch.ones_like(nll)
    weights = weights.float()
    total_weight = torch.clamp(weights.sum(), min=1.0)
    return (nll * weights).sum() / total_weight, total_weight
