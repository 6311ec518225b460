"""Attention ops: the reference attention and the dispatch to the flash
kernels. The port of ``skypilot_tpu/ops/attention.py``.

``xla_attention`` is the numerics reference (softmax statistics in fp32,
causal and segment masks with the finite ``NEG_INF``). ``impl='auto'``
and ``'pallas'`` route to ``ops/flash_attention.py``: the Hopper kernels
for CUDA tensors, their plain PyTorch versions for CPU tensors.

The reference's ``_flash_under_mesh`` shard_maps the kernel over the
batch axes (``data``, ``fsdp``) and the head axis (``tensor``) of an
ambient device mesh. Here each rank is its own process and its q/k/v
already hold only its batch rows and heads (``models/llama.py`` under a
training mesh, ``models/decode.py`` under a serving one), with its rows
of the segment ids, so the same call runs the kernel on the shard: the
per-shard case needs no code of its own. ``check_mesh`` is what remains
of the reference's dispatch: the layouts it sends elsewhere raise when
the mesh is built. Heads that ``tensor`` does not divide are a
``ValueError`` (the reference falls back to XLA attention over
replicated heads there). A ``stage`` degree splits the layers, not
attention: each stage runs its layers' attention on a microbatch's rows
(``parallel/pipeline.py``).

Under a ``seq`` degree above 1 (``parallel``: the rank's
``TensorParallel``; q/k/v hold its block of the columns) the dispatch
takes the sequence-parallel paths of ``ops/ring_attention.py``:
``'ring'`` and ``'ulysses'`` as named, and ``'auto'`` / ``'pallas'``
the ring over the flash kernels. The reference sends ``'pallas'`` to
``xla_attention`` under GSPMD there: the same function, which on the
card would be the plain O(S^2) path. ``'xla'`` all-gathers K/V (and the
key segment ids) over ``seq`` and runs ``xla_attention`` with the query
rows at their global positions: the twin of the reference's GSPMD
result.
"""
from __future__ import annotations

from typing import Dict, Optional

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
                  scale: Optional[float] = None,
                  kv_segment_ids: Optional[torch.Tensor] = None,
                  q_offset: int = 0) -> torch.Tensor:
    """Reference attention. q: [B,S,H,D]; k,v: [B,S,KV,D]; returns
    [B,S,H,D]. Softmax statistics in fp32 regardless of input dtype.

    ``kv_segment_ids`` / ``q_offset``: the keys' segment ids where they
    are not the queries', and the first query row's key position (query
    rows of one ``seq`` block against the whole sequence's keys)."""
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
        q_pos = q_offset + torch.arange(s_q, device=q.device)[:, None]
        k_pos = torch.arange(s_k, device=q.device)[None, :]
        mask = (q_pos >= k_pos)[None, None, :, :]
    if segment_ids is not None:
        keys = segment_ids if kv_segment_ids is None else kv_segment_ids
        seg_mask = (segment_ids[:, :, None] ==
                    keys[:, None, :])[:, None, :, :]
        mask = seg_mask if mask is None else mask & seg_mask
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    weights = torch.softmax(logits, dim=-1)
    return torch.einsum('bhqk,bkhd->bqhd', weights.to(v.dtype).float(),
                        v.float()).to(v.dtype)


def check_mesh(shape: Dict[str, int], n_heads: int, n_kv_heads: int) -> None:
    """Raise unless attention runs on a mesh of this ``shape`` (axis ->
    degree): query and kv heads that the ``tensor`` degree divides
    (``stage`` splits the layers, not attention)."""
    tp = shape.get('tensor', 1)
    if n_heads % tp or n_kv_heads % tp:
        raise ValueError(
            f'tensor={tp} does not divide {n_heads} query and {n_kv_heads} '
            'kv heads: attention runs per head shard')


class _GatherSeq(torch.autograd.Function):
    """This rank's block of columns gathered whole over ``seq``; the
    backward sums the gradient over the seq ranks and keeps the
    block."""

    @staticmethod
    def forward(ctx, x, parallel):
        ctx.parallel = parallel
        return parallel.all_gather(x, 1, 'seq')

    @staticmethod
    def backward(ctx, grad):
        return ctx.parallel.reduce_scatter(grad, 1, 'seq'), None


def _xla_over_seq(q, k, v, causal, segment_ids, parallel) -> torch.Tensor:
    """``xla_attention`` of this rank's query block against the whole
    sequence's K/V (gathered over ``seq``)."""
    keys = None
    if segment_ids is not None:
        keys = parallel.all_gather(segment_ids.contiguous(), 1, 'seq')
    return xla_attention(q, _GatherSeq.apply(k, parallel),
                         _GatherSeq.apply(v, parallel), causal=causal,
                         segment_ids=segment_ids, kv_segment_ids=keys,
                         q_offset=parallel.seq_rank * q.shape[1])


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         segment_ids: Optional[torch.Tensor] = None,
                         impl: str = 'auto',
                         parallel=None) -> torch.Tensor:
    """Dispatching attention entry point used by ``models/``.

    impl: 'auto' | 'pallas' (the flash kernels; their plain versions for
    CPU tensors) | 'xla' (``xla_attention``) | 'ring' | 'ulysses' (the
    sequence-parallel paths, ``ops/ring_attention.py``). ``parallel``:
    the rank's ``TensorParallel`` on a training mesh; under a ``seq``
    degree above 1 q/k/v and the segment ids are its block of the
    columns (see the module docstring)."""
    if parallel is not None and parallel.seq > 1:
        from skypilot_tpu_torch.ops import ring_attention as ra
        kw = dict(causal=causal, segment_ids=segment_ids, parallel=parallel)
        if impl in ('auto', 'pallas', 'ring'):
            return ra.ring_attention(q, k, v, **kw)
        if impl == 'ulysses':
            return ra.ulysses_attention(q, k, v, **kw)
        if impl == 'xla':
            return _xla_over_seq(q, k, v, causal, segment_ids, parallel)
        raise ValueError(f'Unknown attention impl {impl!r}')
    if impl in ('auto', 'pallas', 'ring', 'ulysses'):
        from skypilot_tpu_torch.ops.flash_attention import flash_attention
        return flash_attention(q, k, v, causal=causal,
                               segment_ids=segment_ids)
    if impl == 'xla':
        return xla_attention(q, k, v, causal=causal, segment_ids=segment_ids)
    raise ValueError(f'Unknown attention impl {impl!r}')
