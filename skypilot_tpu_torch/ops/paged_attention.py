"""Paged attention: block-table-indexed decode/verify attention.

The port of ``skypilot_tpu/ops/pallas/paged_attention.py``. One public
dispatch, ``paged_attention``, with the reference's layout: q
``[B, Q, H, D]`` (Q query positions per sequence: 1 = decode, >1 = a
verify window whose KV rows are already in the pool), pools
``[NB, BS, KVH, D]``, block tables ``[B, BPS]`` (0 = the null block),
``n_valid [B]`` rows per sequence INCLUDING the window, optional
``[NB, BS, KVH]`` fp32 row scales of an int8 pool. Query j attends
``pos < n_valid - (Q - 1 - j)``. Returns ``[B, Q, H, D]``.

Two implementations behind it:

* the Hopper kernel (``csrc/paged_attention.cu``), for CUDA tensors:
  ``_paged_kernel``'s algorithm (fp32 running max/sum, finite
  ``NEG_INF`` window mask, only ``ceil(n_valid/BS)`` blocks read, P
  rounded to bf16 before P.V for a bf16 pool, ``acc / max(l, 1e-30)``)
  for bf16/fp32 pools, and ``_paged_kernel_quant``'s for int8 pools,
  in one launch. A CUDA tensor reaches the kernel or the call raises:
  there is no fallback.
* ``paged_attention_reference``, the plain PyTorch version of the same
  function, for CPU tensors (the tier-1 tests) and as the kernel's
  comparison on the card.

``cfg.paged_block_k`` / ``SKYT_PAGED_BLOCK_K`` shape TPU VMEM blocks;
the port ignores them (a CTA always walks whole pool blocks).

``LAUNCHES`` counts kernel launches, one plain integer per kernel, so a
run can show that the main path went through the kernels.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from skypilot_tpu_torch.ops.common import NEG_INF

# Plain-integer launch counters, one per kernel (bumped only where the
# wrapper launches the kernel).
LAUNCHES: Dict[str, int] = {'paged_attention': 0,
                            'paged_attention_quant': 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_HEAD_DIMS = (64, 128, 256)
_WAVE_CTAS = 264               # CTAs resident at once: two per H100 SM
_MAX_SPLITS = 4                # a (b, h)'s splits are one cluster
_lib: Optional[ctypes.CDLL] = None


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

def paged_attention_reference(q: torch.Tensor, k_pool: torch.Tensor,
                              v_pool: torch.Tensor,
                              block_tables: torch.Tensor,
                              n_valid: torch.Tensor,
                              k_scale: Optional[torch.Tensor] = None,
                              v_scale: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """The kernel's function in plain PyTorch, in fp32: gather each
    slot's rows through its block table, mask with the window rule and
    ``NEG_INF``, and weigh only the rows of the first
    ``ceil(n_valid/BS)`` blocks, exactly the rows the kernel reads (so
    a fully masked row is uniform over those rows, as in the kernel).
    A 16-bit pool has P rounded to its type before P.V, as the
    reference's ``p.astype(v.dtype)``; the sum keeps fp32 P."""
    b, q_len, h, d = q.shape
    nb, bs, kvh, _ = k_pool.shape
    g = h // kvh
    bps = block_tables.shape[1]
    t = bps * bs
    dev = q.device
    offs = torch.arange(bs, device=dev)
    rows = (block_tables.long()[:, :, None] * bs + offs).reshape(b, t)
    k = k_pool.reshape(nb * bs, kvh, d)[rows].float()        # [B,T,KVH,D]
    v = v_pool.reshape(nb * bs, kvh, d)[rows].float()
    if k_scale is not None:
        k = k * k_scale.reshape(nb * bs, kvh)[rows].float()[..., None]
        v = v * v_scale.reshape(nb * bs, kvh)[rows].float()[..., None]
    qg = q.float().reshape(b, q_len, kvh, g, d) * (d ** -0.5)
    s = torch.einsum('bqhgd,bthd->bhgqt', qg, k)             # [B,KVH,G,Q,T]
    nv = n_valid.long().to(dev)
    pos = torch.arange(t, device=dev)
    limit = nv[:, None] - (q_len - 1) + torch.arange(q_len, device=dev)
    valid = pos[None, None, :] < limit[:, :, None]           # [B,Q,T]
    nblk = torch.clamp((nv + bs - 1) // bs, max=bps)
    read = pos[None, :] < (nblk * bs)[:, None]               # [B,T]
    s = torch.where(valid[:, None, None], s, NEG_INF)
    s = torch.where(read[:, None, None, None, :], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * read[:, None, None, None, :]
    l = p.sum(dim=-1, keepdim=True)
    if k_scale is None and v_pool.dtype in (torch.bfloat16, torch.float16):
        # the reference's p.astype(v.dtype) before P.V (l keeps fp32 P)
        p = p.to(v_pool.dtype).float()
    acc = torch.einsum('bhgqt,bthd->bhgqd', p, v)
    out = acc / torch.clamp(l, min=1e-30)                    # [B,KVH,G,Q,D]
    return out.permute(0, 3, 1, 2, 4).reshape(b, q_len, h, d).to(q.dtype)


# ---------------------------------------------------------------------------
# Hopper kernel wrapper
# ---------------------------------------------------------------------------

def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from skypilot_tpu_torch import _build
        lib = _build.load_library('paged_attention')
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.skyt_paged_attention.argtypes = (
            [p] * 8 + [i] * 8 + [ctypes.c_float, i, i, p])
        lib.skyt_paged_attention.restype = i
        lib.skyt_paged_attention_warps.argtypes = [i] * 6
        lib.skyt_paged_attention_warps.restype = i
        _lib = lib
    return _lib


def _num_splits(b: int, kvh: int, bps: int) -> int:
    """CTAs per (sequence, kv head), from the shape alone (the host never
    reads the lengths): as many as keep every CTA of the launch resident
    at once (``_WAVE_CTAS``), so a small batch still fills the card, and
    one split once B * KVH alone does. The splits of a (sequence, kv
    head) are one cluster, at most ``_MAX_SPLITS``: clusters of 8 did
    not all fit on an H100 at once (PERF.md). Each split walks an even
    share of the slot's blocks."""
    return max(1, min(bps, _MAX_SPLITS, _WAVE_CTAS // (b * kvh)))


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f'paged_attention kernel: {msg}')


def paged_attention_kernel(qg: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_tables: torch.Tensor,
                           n_valid: torch.Tensor, q_len: int,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None,
                           num_splits: Optional[int] = None
                           ) -> torch.Tensor:
    """Launch the kernel on the kernel layout: qg ``[B, KVH, Q*G, D]``
    -> ``[B, KVH, Q*G, D]``. Raises on any shape, dtype, device or
    layout the kernel does not take, and when the launch fails.

    ``num_splits`` fixes the number of CTAs per (sequence, kv head)
    instead of ``_num_splits``'s choice; ``chip_smoke.py:split_study``
    times other counts with it."""
    b, kvh, qgr, d = qg.shape
    nb, bs, pkvh, pd = k_pool.shape
    bps = block_tables.shape[1] if block_tables.dim() == 2 else -1
    dev = qg.device
    quant = k_scale is not None
    tensors = [qg, k_pool, v_pool, block_tables, n_valid]
    if quant:
        tensors += [k_scale, v_scale]
    _check(all(x is not None and x.is_cuda and x.device == dev
               for x in tensors), 'all tensors must be on one CUDA device')
    _check(qg.dtype in (torch.bfloat16, torch.float32),
           f'query dtype {qg.dtype} (bf16 or fp32)')
    if quant:
        _check(k_pool.dtype == torch.int8 and v_pool.dtype == torch.int8,
               'scales given but the pool is not int8')
        _check(k_scale.dtype == torch.float32 and
               v_scale.dtype == torch.float32 and
               tuple(k_scale.shape) == (nb, bs, kvh) and
               tuple(v_scale.shape) == (nb, bs, kvh),
               'int8 pool scales must be fp32 [NB, BS, KVH]')
    else:
        _check(k_pool.dtype == qg.dtype and v_pool.dtype == qg.dtype,
               f'fp pool dtype {k_pool.dtype} must equal the query dtype '
               f'{qg.dtype} (int8 pools need scales)')
    _check(v_pool.shape == k_pool.shape, 'k/v pool shapes differ')
    _check(pkvh == kvh and pd == d, 'pool [NB,BS,KVH,D] vs query heads')
    _check(d in _HEAD_DIMS, f'head dim {d} (one of {_HEAD_DIMS})')
    _check(qgr % q_len == 0, 'Q*G rows not a multiple of Q')
    _check(block_tables.dtype == torch.int32 and bps > 0 and
           block_tables.shape[0] == b, 'block tables must be int32 [B,BPS]')
    _check(n_valid.dtype == torch.int32 and tuple(n_valid.shape) == (b,),
           'n_valid must be int32 [B]')
    _check(all(x.is_contiguous() for x in tensors), 'inputs must be '
           'contiguous')
    _check(all(x.data_ptr() % 16 == 0 for x in (qg, k_pool, v_pool)),
           'q and pools must be 16-byte aligned')
    splits = num_splits if num_splits is not None else \
        _num_splits(b, kvh, bps)
    _check(1 <= splits <= min(bps, _MAX_SPLITS),
           f'{splits} splits for {bps} blocks per slot (at most '
           f'{_MAX_SPLITS})')
    lib = _library()
    q_code, kv_code = _DTYPE_CODES[qg.dtype], _DTYPE_CODES[k_pool.dtype]
    _check(lib.skyt_paged_attention_warps(qgr, d, bps, splits, q_code,
                                          kv_code) > 0,
           f'Q*G={qgr}, D={d}, {k_pool.dtype} pool: one warp\'s tiles do '
           f'not fit in shared memory')
    out = torch.empty_like(qg)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.skyt_paged_attention(
        qg.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        k_scale.data_ptr() if quant else None,
        v_scale.data_ptr() if quant else None,
        block_tables.data_ptr(), n_valid.data_ptr(), out.data_ptr(),
        b, kvh, qgr, q_len, d, bs, bps, splits,
        d ** -0.5, q_code, kv_code, stream)
    if err != 0:
        raise RuntimeError(f'paged_attention kernel launch failed: CUDA '
                           f'error {err}')
    LAUNCHES['paged_attention_quant' if quant else 'paged_attention'] += 1
    return out


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, block_tables: torch.Tensor,
                    n_valid: torch.Tensor, *,
                    k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention over a paged KV pool (layout in the module docstring).

    CUDA tensors go to the Hopper kernel (or raise); CPU tensors go to
    ``paged_attention_reference``."""
    b, q_len, h, d = q.shape
    kvh = k_pool.shape[2]
    if h % kvh:
        raise ValueError(f'{h} query heads not a multiple of {kvh} kv heads')
    if (k_scale is None) != (v_scale is None):
        raise ValueError('k_scale and v_scale go together')
    if not q.is_cuda:
        if any(x is not None and x.is_cuda for x in
               (k_pool, v_pool, block_tables, n_valid, k_scale, v_scale)):
            raise ValueError('q is on the CPU but other inputs are on CUDA')
        return paged_attention_reference(q, k_pool, v_pool, block_tables,
                                         n_valid, k_scale, v_scale)
    g = h // kvh
    qg = q.reshape(b, q_len, kvh, g, d).transpose(1, 2)
    qg = qg.reshape(b, kvh, q_len * g, d).contiguous()
    out = paged_attention_kernel(qg, k_pool, v_pool, block_tables,
                                 n_valid, q_len, k_scale, v_scale)
    out = out.reshape(b, kvh, q_len, g, d).transpose(1, 2)
    return out.reshape(b, q_len, h, d)
