"""Sequence-parallel attention over the ``seq`` mesh axis: the port of
``skypilot_tpu/ops/ring_attention.py``.

Each rank of a training mesh with a ``seq`` degree n > 1 holds one block
of S / n columns of the batch: this rank's queries, keys and values
(q ``[B, S/n, H, D]``, k/v ``[B, S/n, KVH, D]``) and, for packed
batches, its segment ids ``[B, S/n]``. The collectives are explicit
calls on its ``TensorParallel`` (``parallel/sharding.py``), the
counterpart of the reference's ``shard_map`` over ``seq``.

* **Ring attention** (``ring_attention``): the K/V blocks go round the
  ring (``TensorParallel.ring_shift``, the reference's ``ppermute``) at
  the KV-head size while each rank keeps its Q block; at hop t rank i
  holds block j = (i - t) mod n. Where the reference accumulates
  einsums with a running max, each block here is one call of the flash
  forward kernel (``ops/flash_attention.py``) on the rank's queries and
  that block's keys: causal on the diagonal block (j = i), full on a
  block of earlier positions, with the travelling block's segment ids
  as ``kv_segment_ids``. The blocks' (o_j, lse_j) merge in fp32: lse =
  logaddexp of the lse_j, o = sum exp(lse_j - lse) o_j. A causal block
  of later positions (j > i) is fully masked: the reference computes
  it and its placeholders wash out of the running max; here it is
  skipped. A row that a block masks entirely comes back with an lse of
  about ``NEG_INF``, so it takes no weight in the merge. The forward
  saves q, k, v, the segment ids, o and lse: O(S/n) residuals. The
  backward makes a second rotation: per block the dq kernel and the
  dk/dv kernel on the rank's q, o, lse and do (the merged o and lse:
  the kernels recompute P = exp(s - lse) as the reference's backward
  does, and delta = rowsum(do * o) must be the merged o's); dq sums at
  home in fp32, the fp32 dk/dv accumulators ride the ring with their
  block and arrive home after n hops.
* **Ulysses** (``ulysses_attention``): all-to-all seq -> heads
  (``TensorParallel.all_to_all``), the flash attention over the whole
  sequence for H / n heads (the reference runs ``xla_attention`` there),
  all-to-all back. KV heads that n does not divide are repeated to the
  query heads first; the segment ids are all-gathered. Its backward is
  the all-to-alls' transposes around the flash ``autograd.Function``.

On CUDA tensors every ring block runs the kernels, which raise on a
block off their grid (a block length that is not a multiple of 64, a
head dim other than 128 or 256: ``flash_attention._check_inputs``);
``train/pretrain.mesh_seq`` rounds the sequence so that the entry points
never build one. CPU tensors run the plain versions. Without a mesh, or
at a ``seq`` degree of 1, both are the flash attention (the reference
falls back to its XLA attention there).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from skypilot_tpu_torch.ops import flash_attention as fa
from skypilot_tpu_torch.ops.attention import repeat_kv


def seq_degree(parallel) -> int:
    """The ``seq`` degree of ``parallel`` (1 for None)."""
    return 1 if parallel is None else parallel.seq


def seq_shard(x: torch.Tensor, parallel, dim: int = 1) -> torch.Tensor:
    """This rank's block of the columns of ``x`` along ``dim`` (the
    reference's ``P(None, 'seq')``); the reference's ValueError when
    ``seq`` does not divide them."""
    n, s = seq_degree(parallel), x.shape[dim]
    if s % n:
        raise ValueError(f'ring_attention: seq length {s} not divisible by '
                         f'seq mesh axis size {n}')
    size = s // n
    return x.narrow(dim, parallel.seq_rank * size, size) if n > 1 else x


def _block_forward(q, k, v, causal, seg, kv_seg
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse) of this rank's queries against one key block: the flash
    forward kernel on CUDA tensors, its plain version on CPU tensors."""
    kw = dict(causal=causal, segment_ids=seg, kv_segment_ids=kv_seg)
    if q.is_cuda:
        return fa.flash_forward_kernel(q, k, v, **kw)
    return fa.flash_forward_reference(q, k, v, **kw)


def _block_backward(q, k, v, o, lse, do, causal, seg, kv_seg):
    """(dq, dk, dv) of one key block from the merged o and lse (the
    kernels on CUDA tensors, the plain versions on CPU tensors)."""
    kw = dict(causal=causal, segment_ids=seg, kv_segment_ids=kv_seg)
    if q.is_cuda:
        dq, delta = fa.flash_dq_kernel(q, k, v, o, lse, do, **kw)
        return (dq,) + fa.flash_dkv_kernel(q, k, v, lse, do, delta, **kw)
    return fa.flash_backward_reference(q, k, v, o, lse, do, **kw)


def _visited(causal: bool, i: int, j: int) -> bool:
    """Whether rank i computes against key block j: a causal block of
    later positions is fully masked."""
    return not (causal and j > i)


def merge_blocks(parts: Sequence[Tuple[torch.Tensor, torch.Tensor]]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The blocks' (o_j [B,S,H,D], lse_j [B,H,S]) merged in fp32: (o
    fp32, lse) with lse = logaddexp of the lse_j and o = sum exp(lse_j -
    lse) o_j, both contiguous (the kernels take o)."""
    o_acc = lse_acc = None
    for o_j, lse_j in parts:
        if o_acc is None:
            o_acc, lse_acc = o_j.float(), lse_j
            continue
        lse = torch.logaddexp(lse_acc, lse_j)
        o_acc = (o_acc * torch.exp(lse_acc - lse).transpose(1, 2)[..., None]
                 + o_j.float() *
                 torch.exp(lse_j - lse).transpose(1, 2)[..., None])
        lse_acc = lse
    return o_acc.contiguous(), lse_acc.contiguous()


class _RingAttention(torch.autograd.Function):
    """The reference's ``_make_ring_core`` custom_vjp: forward and
    backward rotations over this rank's blocks (segment ids optional, no
    gradient)."""

    @staticmethod
    def forward(ctx, q, k, v, seg, causal, parallel):
        n, i = parallel.seq, parallel.seq_rank
        ring: List[torch.Tensor] = [k, v] + ([seg] if seg is not None
                                             else [])

        def blocks():
            nonlocal ring
            for t in range(n):
                j = (i - t) % n
                if _visited(causal, i, j):
                    yield _block_forward(
                        q, ring[0], ring[1], causal and j == i, seg,
                        ring[2] if seg is not None else None)
                if t < n - 1:
                    ring = parallel.ring_shift(ring)

        o, lse = merge_blocks(blocks())
        o = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, o, lse, seg)
        ctx.causal, ctx.parallel = causal, parallel
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, seg = ctx.saved_tensors
        causal, parallel = ctx.causal, ctx.parallel
        n, i = parallel.seq, parallel.seq_rank
        do = do.contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        # The dk/dv accumulators ride with their K/V block (and its
        # segment ids); the last hop takes only the accumulators home.
        ring = ([k, v] + ([seg] if seg is not None else []) +
                [torch.zeros(k.shape, dtype=torch.float32, device=k.device),
                 torch.zeros(v.shape, dtype=torch.float32, device=v.device)])
        for t in range(n):
            j = (i - t) % n
            if _visited(causal, i, j):
                dq_j, dk_j, dv_j = _block_backward(
                    q, ring[0], ring[1], o, lse, do, causal and j == i, seg,
                    ring[2] if seg is not None else None)
                dq += dq_j.float()
                ring[-2] = ring[-2] + dk_j.float()
                ring[-1] = ring[-1] + dv_j.float()
            if t < n - 1:
                ring = parallel.ring_shift(ring)
            else:
                ring[-2:] = parallel.ring_shift(ring[-2:])
        return (dq.to(q.dtype), ring[-2].to(k.dtype), ring[-1].to(v.dtype),
                None, None, None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True,
                   segment_ids: Optional[torch.Tensor] = None,
                   parallel=None) -> torch.Tensor:
    """Ring attention on this rank's blocks: q [B,S/n,H,D], k/v
    [B,S/n,KVH,D], segment ids [B,S/n]; returns [B,S/n,H,D]. ``parallel``
    is the rank's ``TensorParallel``; without one, or at seq degree 1,
    the flash attention."""
    if seq_degree(parallel) == 1:
        return fa.flash_attention(q, k, v, causal=causal,
                                  segment_ids=segment_ids)
    _check_blocks(q, k, v, segment_ids)
    if segment_ids is not None:
        segment_ids = segment_ids.to(torch.int32).contiguous()
    return _RingAttention.apply(q.contiguous(), k.contiguous(),
                                v.contiguous(), segment_ids, causal,
                                parallel)


def _check_blocks(q, k, v, segment_ids) -> None:
    b, s, h, _ = q.shape
    if k.shape[:2] != (b, s) or k.shape != v.shape or h % k.shape[2]:
        raise ValueError(f'sequence-parallel attention: q {tuple(q.shape)}, '
                         f'k {tuple(k.shape)}, v {tuple(v.shape)}')
    if segment_ids is not None and tuple(segment_ids.shape) != (b, s):
        raise ValueError(f'segment ids {tuple(segment_ids.shape)} for '
                         f'blocks of {(b, s)}')


class _AllToAll(torch.autograd.Function):
    """``TensorParallel.all_to_all`` over ``seq``; its transpose (the
    split and the joined dims swapped) in the backward."""

    @staticmethod
    def forward(ctx, x, parallel, split_dim, concat_dim):
        ctx.parallel, ctx.dims = parallel, (split_dim, concat_dim)
        return parallel.all_to_all(x, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, grad):
        split_dim, concat_dim = ctx.dims
        return (ctx.parallel.all_to_all(grad.contiguous(), concat_dim,
                                        split_dim), None, None, None)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True,
                      segment_ids: Optional[torch.Tensor] = None,
                      parallel=None) -> torch.Tensor:
    """All-to-all (DeepSpeed-Ulysses) sequence parallelism on this rank's
    blocks, shapes as ``ring_attention``'s."""
    n = seq_degree(parallel)
    if n == 1:
        return fa.flash_attention(q, k, v, causal=causal,
                                  segment_ids=segment_ids)
    _check_blocks(q, k, v, segment_ids)
    if q.shape[2] % n:
        raise ValueError(f'ulysses_attention: {q.shape[2]} heads not '
                         f'divisible by seq mesh axis size {n}')
    if k.shape[2] % n:
        # Not enough KV heads to split: broadcast them to full heads
        # first (costs the GQA saving on the wire, keeps semantics).
        k = repeat_kv(k, q.shape[2] // k.shape[2])
        v = repeat_kv(v, q.shape[2] // v.shape[2])
    # [B, S/n, H, D] -> [B, S, H/n, D]
    q, k, v = (_AllToAll.apply(x, parallel, 2, 1) for x in (q, k, v))
    if segment_ids is not None:
        segment_ids = parallel.all_gather(
            segment_ids.to(torch.int32).contiguous(), 1, 'seq')
    out = fa.flash_attention(q, k, v, causal=causal,
                             segment_ids=segment_ids)
    # [B, S, H/n, D] -> [B, S/n, H, D]
    return _AllToAll.apply(out, parallel, 1, 2)
