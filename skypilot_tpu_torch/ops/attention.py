"""Attention ops: the reference attention and the dispatch to the flash
kernels. The port of ``skypilot_tpu/ops/attention.py``.

``xla_attention`` is the numerics reference (softmax statistics in fp32,
causal and segment masks with the finite ``NEG_INF``). ``impl='auto'``
and ``'pallas'`` route to ``ops/flash_attention.py``: the Hopper kernels
for CUDA tensors, their plain PyTorch versions for CPU tensors.

The reference's ``_flash_under_mesh`` shard_maps the kernel over the
head axis of an ambient device mesh. Here each tensor-parallel rank is
its own process and its q/k/v already hold only its heads
(``models/decode.py``), so the same call runs the kernel on the shard:
the per-head case needs no code of its own. The sequence-parallel paths
(``'ring'``, ``'ulysses'``) belong to the training half of the
multi-device work (ROADMAP.md, queue A item 15 (b)) and raise.
"""
from __future__ import annotations

from typing import Optional

import torch

from skypilot_tpu_torch.ops.common import NEG_INF


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, S, KV, D] -> [B, S, KV*n_rep, D] (GQA broadcast)."""
    if n_rep == 1:
        return x
    b, s, kv, d = x.shape
    return x[:, :, :, None, :].expand(b, s, kv, n_rep, d).reshape(
        b, s, kv * n_rep, d)


def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True,
                  segment_ids: Optional[torch.Tensor] = None,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Reference attention. q: [B,S,H,D]; k,v: [B,S,KV,D]; returns
    [B,S,H,D]. Softmax statistics in fp32 regardless of input dtype."""
    _, s_q, n_heads, head_dim = q.shape
    n_kv = k.shape[2]
    if n_heads % n_kv:
        raise ValueError(f'{n_heads} query heads are not a multiple of '
                         f'{n_kv} kv heads')
    k = repeat_kv(k, n_heads // n_kv)
    v = repeat_kv(v, n_heads // n_kv)
    if scale is None:
        scale = head_dim ** -0.5
    logits = torch.einsum('bqhd,bkhd->bhqk', q.float(), k.float()) * scale
    s_k = k.shape[1]
    mask = None
    if causal:
        q_pos = torch.arange(s_q, device=q.device)[:, None]
        k_pos = torch.arange(s_k, device=q.device)[None, :]
        mask = (q_pos >= k_pos)[None, None, :, :]
    if segment_ids is not None:
        seg_mask = (segment_ids[:, :, None] ==
                    segment_ids[:, None, :])[:, None, :, :]
        mask = seg_mask if mask is None else mask & seg_mask
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    weights = torch.softmax(logits, dim=-1)
    return torch.einsum('bhqk,bkhd->bqhd', weights.to(v.dtype).float(),
                        v.float()).to(v.dtype)


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         segment_ids: Optional[torch.Tensor] = None,
                         impl: str = 'auto') -> torch.Tensor:
    """Dispatching attention entry point used by ``models/``.

    impl: 'auto' | 'pallas' (the flash kernels; their plain versions for
    CPU tensors) | 'xla' (``xla_attention``). 'ring' and 'ulysses'
    raise: they are the training half of the multi-device work."""
    if impl in ('auto', 'pallas'):
        from skypilot_tpu_torch.ops.flash_attention import flash_attention
        return flash_attention(q, k, v, causal=causal,
                               segment_ids=segment_ids)
    if impl == 'xla':
        return xla_attention(q, k, v, causal=causal, segment_ids=segment_ids)
    if impl in ('ring', 'ulysses'):
        raise NotImplementedError(
            f'{impl} attention is sequence-parallel training work, not '
            'ported yet (ROADMAP.md, queue A item 15 (b), the training '
            'half)')
    raise ValueError(f'Unknown attention impl {impl!r}')
