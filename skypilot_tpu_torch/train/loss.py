"""Loss functions (fp32 softmax, optional z-loss, padding-aware): the
port of ``skypilot_tpu/train/loss.py``."""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from skypilot_tpu_torch.parallel.sharding import reduce_from_tensor


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       weights: Optional[torch.Tensor] = None,
                       z_loss_coeff: float = 0.0,
                       parallel: Optional[Any] = None,
                       total_weight: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-weighted mean cross entropy.

    logits [B,S,V] fp32, targets [B,S] int, weights [B,S] (1 = real
    token, 0 = pad). Returns (mean_loss, total_weight). z-loss (PaLM)
    regularizes the log-partition toward 0 for bf16 stability.

    ``parallel`` (a ``TensorParallel`` on a training mesh): the arrays
    are this rank's rows of the batch (under ``seq``, its block of their
    columns), ``total_weight`` is the weight sum of the WHOLE batch
    (all-reduced over data x fsdp x seq), and the loss is this rank's
    share of the batch mean: the mean is its sum over those ranks,
    whatever the weights on each (not the mean of the ranks' means). Under ``tensor`` the logits are this rank's block of
    the vocab, and the log-partition and the target logit are summed
    over the tensor group (a vocab-parallel cross entropy: the [B, S, V]
    logits are never gathered).

    ``total_weight``: the normalizer, already summed (a pipeline
    microbatch's share of a batch whose weight sum is known); returned
    as given.
    """
    logits = logits.float()
    if parallel is not None and parallel.degree > 1:
        log_z, target_logits = _vocab_parallel(logits, targets, parallel)
    else:
        log_z = torch.logsumexp(logits, dim=-1)                    # [B,S]
        target_logits = torch.gather(
            logits, -1, targets.long()[..., None]).squeeze(-1)     # [B,S]
    nll = log_z - target_logits
    if z_loss_coeff:
        nll = nll + z_loss_coeff * torch.square(log_z)
    if weights is None:
        weights = torch.ones_like(nll)
    weights = weights.float()
    if total_weight is None:
        total = weights.sum()
        if parallel is not None:
            total = parallel.token_sum(total)
        total_weight = torch.clamp(total, min=1.0)
    return (nll * weights).sum() / total_weight, total_weight


def _vocab_parallel(logits: torch.Tensor, targets: torch.Tensor,
                    parallel: Any) -> Tuple[torch.Tensor, torch.Tensor]:
    """(log-partition, target logit) [B,S] of vocab-sharded fp32 logits
    [B,S,V/tensor]: logsumexp's max shift taken over the whole row (a
    max all-reduce, no gradient), the shifted exponentials' sums added
    over the group, and the target logit read on the rank that holds its
    column (zeros elsewhere, so the sum is exact). The sums are
    Megatron's g: every rank holds the same loss, so each block's
    gradient is its own part."""
    width = logits.shape[-1]
    shift = parallel.all_reduce(logits.detach().amax(dim=-1), op='max')
    sums = reduce_from_tensor(
        torch.exp(logits - shift[..., None]).sum(dim=-1), parallel)
    local = targets.long() - parallel.rank * width
    mine = (local >= 0) & (local < width)
    picked = torch.gather(logits, -1,
                          torch.where(mine, local, 0)[..., None]).squeeze(-1)
    return (torch.log(sums) + shift,
            reduce_from_tensor(torch.where(mine, picked, 0.0), parallel))
