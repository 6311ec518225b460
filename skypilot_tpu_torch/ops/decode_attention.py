"""Length-aware decode attention over a monolithic KV cache.

The port of ``skypilot_tpu/ops/pallas/decode_attention.py``. One public
dispatch, ``decode_attention``, with the reference's layout: q
``[B, Q, H, D]`` (Q = 1 is single-token decode, Q > 1 a window whose
rows are already in the cache), caches ``[B, T, KVH, D]``, ``n_valid
[B]`` valid rows INCLUDING the window, optional ``[B, T, KVH]`` fp32
row scales of an int8 cache. Query j attends ``pos < n_valid - (Q - 1 -
j)``. Returns ``[B, Q, H, D]``.

Two implementations behind it:

* the Hopper kernels (``csrc/decode_attention.cu``), for CUDA tensors,
  one launch a call: ``_decode_kernel``'s algorithm (q scaled in fp32,
  fp32 running max/sum, the finite ``NEG_INF`` window mask, only
  ``min(n_valid, T)`` rows read, P rounded to bf16 before P.V for a bf16
  cache, ``acc / max(l, 1e-30)``) for bf16/fp32 caches, and
  ``_decode_kernel_quant``'s (V's scale on P, P in fp32) for int8
  caches. bf16 queries with Q*G <= 32 (<= 16 at D=256) run on tensor
  cores (``mma.sync``); fp32 queries and wider windows run a second
  kernel on CUDA cores, a route chosen by dtype and shape before the
  launch (``_mma_tiles``). Both take every T (the tail is masked, never
  read), D in {64, 128, 256} and Q >= 1, and the wrapper raises on
  anything else; ``n_valid > T`` fails a device-side assert. The splits of a (sequence, kv head) are
  one thread-block cluster merged in shared memory, so a call needs no
  scratch. A CUDA tensor reaches a kernel or the call raises: there is
  no fallback.
* ``xla_decode_attention``, the plain PyTorch version (the reference's
  oracle of the same name: full-cache masked softmax), for CPU tensors
  (the CPU tests), for ``impl='xla'``, and as the kernels' comparison
  on the card. A fully masked query row (a window position with
  ``n_valid < Q``, discarded by the caller) is uniform over all T rows
  here and uniform over the rows read in the kernels.

``block_k`` sizes the TPU kernel's VMEM blocks of the sequential kv
axis; the port accepts and ignores it: a warp always walks 16-row tiles
(32 on CUDA cores), and how a sequence's rows are spread over CTAs
follows from the split count (``_num_splits``), not from a block size.
``LAUNCHES`` counts kernel launches, one plain integer per TPU kernel
(either Hopper kernel counts under the cache's type).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Optional

import torch

from skypilot_tpu_torch.ops.common import NEG_INF

LAUNCHES: Dict[str, int] = {'decode_attention': 0,
                            'decode_attention_quant': 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_HEAD_DIMS = (64, 128, 256)
_MMA_TILE = 16                 # rows of a tensor-core tile (cache or query)
_WAVE_CTAS = 264               # CTAs resident at once: two per H100 SM
_MAX_SPLITS = 4                # a (b, h)'s splits are one cluster
_lib: Optional[ctypes.CDLL] = None


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

def xla_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, n_valid: torch.Tensor,
                         k_scale: Optional[torch.Tensor] = None,
                         v_scale: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Full-cache masked attention (reads all T rows), as the reference's
    ``xla_decode_attention``: fp32 scores scaled after Q.K^T, the window
    mask with ``NEG_INF``, probabilities cast to the value dtype (an int8
    cache is dequantized to the query dtype) and an fp32 accumulator."""
    b, q_len, h, d = q.shape
    t, kvh = k_cache.shape[1], k_cache.shape[2]
    g = h // kvh
    if k_scale is not None:
        k_cache = k_cache.float() * k_scale[..., None]
        v_cache = (v_cache.float() * v_scale[..., None]).to(q.dtype)
    qg = q.reshape(b, q_len, kvh, g, d)
    scores = torch.einsum('bqhgk,bthk->bhgqt', qg.float(),
                          k_cache.float()) * (d ** -0.5)
    dev = q.device
    limit = (n_valid.long().to(dev)[:, None] - (q_len - 1) +
             torch.arange(q_len, device=dev)[None, :])       # [B, Q]
    valid = (torch.arange(t, device=dev)[None, None, :] <
             limit[:, :, None])                              # [B, Q, T]
    scores = torch.where(valid[:, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    attn = torch.einsum('bhgqt,bthk->bqhgk', probs.float(), v_cache.float())
    return attn.reshape(b, q_len, h, d).to(q.dtype)


# ---------------------------------------------------------------------------
# Hopper kernel wrapper
# ---------------------------------------------------------------------------

def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from skypilot_tpu_torch import _build
        lib = _build.load_library('decode_attention')
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.skyt_decode_attention.argtypes = (
            [p] * 7 + [i] * 8 + [ctypes.c_float, i, i, p])
        lib.skyt_decode_attention.restype = i
        lib.skyt_decode_attention_warps.argtypes = [i] * 5
        lib.skyt_decode_attention_warps.restype = i
        _lib = lib
    return _lib


def _mma_tiles(q_dtype: torch.dtype, kv_dtype: torch.dtype, qgr: int,
               d: int) -> int:
    """The kernel a call runs, by dtype and shape, chosen before launch:
    the 16-row query tiles of the tensor-core kernel, or 0 for the
    CUDA-core kernel. bf16 queries over a bf16 or int8 cache take tensor
    cores for up to 32 query rows (Q*G), 16 at D=256 (two tiles'
    accumulators would not fit in registers there); fp32 queries and
    wider windows run on CUDA cores."""
    if q_dtype != torch.bfloat16 or kv_dtype not in (torch.bfloat16,
                                                     torch.int8):
        return 0
    if qgr <= _MMA_TILE:
        return 1
    return 2 if qgr <= 2 * _MMA_TILE and d <= 128 else 0


@functools.lru_cache(maxsize=None)
def _warps(qgr: int, d: int, m_tiles: int, q_code: int, kv_code: int
           ) -> int:
    """Warps a CTA of that kernel runs with (0: one warp's tiles do not
    fit in shared memory)."""
    return _library().skyt_decode_attention_warps(qgr, d, m_tiles, q_code,
                                                  kv_code)


def _num_splits(b: int, kvh: int, t: int) -> int:
    """CTAs per (sequence, kv head), from the shape alone (the host never
    reads the lengths): as many as keep every CTA of the launch resident
    at once (``_WAVE_CTAS``), so a small batch still fills the card, and
    one split once B * KVH alone does; never more than a full sequence's
    16-row tiles, and at most ``_MAX_SPLITS``, one cluster (the paged
    kernels' rule, ``paged_attention._num_splits``). Each split walks an
    even share of the sequence's ``min(n_valid, T)`` rows."""
    return max(1, min(math.ceil(t / _MMA_TILE), _MAX_SPLITS,
                      _WAVE_CTAS // (b * kvh)))


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f'decode_attention kernel: {msg}')


def decode_attention_kernel(qg: torch.Tensor, k_cache: torch.Tensor,
                            v_cache: torch.Tensor, n_valid: torch.Tensor,
                            q_len: int,
                            k_scale: Optional[torch.Tensor] = None,
                            v_scale: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Launch a kernel on the kernel layout: qg ``[B, KVH, Q*G, D]``
    -> ``[B, KVH, Q*G, D]``. Raises on any shape, dtype, device or
    layout the kernels do not take and when the launch fails.

    ``n_valid > T`` is checked on the card, so the host never waits for
    the lengths: the cluster's rank 0 fails a device-side assert, and the
    next synchronisation raises. The kernels never read past T."""
    b, kvh, qgr, d = qg.shape
    t = k_cache.shape[1] if k_cache.dim() == 4 else -1
    dev = qg.device
    quant = k_scale is not None
    tensors = [qg, k_cache, v_cache, n_valid]
    if quant:
        tensors += [k_scale, v_scale]
    _check(all(x is not None and x.is_cuda and x.device == dev
               for x in tensors), 'all tensors must be on one CUDA device')
    _check(qg.dtype in (torch.bfloat16, torch.float32),
           f'query dtype {qg.dtype} (bf16 or fp32)')
    _check(k_cache.dim() == 4 and tuple(k_cache.shape) == (b, t, kvh, d)
           and v_cache.shape == k_cache.shape and t > 0,
           'caches must be [B, T, KVH, D] matching the query heads')
    if quant:
        _check(k_cache.dtype == torch.int8 and v_cache.dtype == torch.int8,
               'scales given but the cache is not int8')
        _check(k_scale.dtype == torch.float32 and
               v_scale.dtype == torch.float32 and
               tuple(k_scale.shape) == (b, t, kvh) and
               tuple(v_scale.shape) == (b, t, kvh),
               'int8 cache scales must be fp32 [B, T, KVH]')
    else:
        _check(k_cache.dtype == qg.dtype and v_cache.dtype == qg.dtype,
               f'cache dtype {k_cache.dtype} must equal the query dtype '
               f'{qg.dtype} (int8 caches need scales)')
    _check(d in _HEAD_DIMS, f'head dim {d} (one of {_HEAD_DIMS})')
    _check(q_len >= 1 and qgr % q_len == 0,
           'Q*G rows not a multiple of Q >= 1')
    _check(n_valid.dtype == torch.int32 and tuple(n_valid.shape) == (b,),
           'n_valid must be int32 [B]')
    _check(all(x.is_contiguous() for x in tensors),
           'inputs must be contiguous')
    _check(all(x.data_ptr() % 16 == 0 for x in (qg, k_cache, v_cache)),
           'q and caches must be 16-byte aligned')
    splits = _num_splits(b, kvh, t)
    _check(1 <= splits <= min(math.ceil(t / _MMA_TILE), _MAX_SPLITS),
           f'{splits} splits for T={t} (at most {_MAX_SPLITS}, one per '
           f'{_MMA_TILE} rows)')
    m_tiles = _mma_tiles(qg.dtype, k_cache.dtype, qgr, d)
    q_code, kv_code = _DTYPE_CODES[qg.dtype], _DTYPE_CODES[k_cache.dtype]
    _check(_warps(qgr, d, m_tiles, q_code, kv_code) > 0,
           f'Q*G={qgr} query rows at D={d}: one warp\'s tiles do not fit '
           f'in shared memory')
    out = torch.empty_like(qg)
    err = _library().skyt_decode_attention(
        qg.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        k_scale.data_ptr() if quant else None,
        v_scale.data_ptr() if quant else None,
        n_valid.data_ptr(), out.data_ptr(), b, t, kvh, qgr, q_len, d,
        splits, m_tiles, d ** -0.5, q_code, kv_code,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f'decode_attention kernel launch failed: CUDA '
                           f'error {err}')
    LAUNCHES['decode_attention_quant' if quant else 'decode_attention'] += 1
    return out


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, n_valid: torch.Tensor, *,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None,
                     impl: str = 'auto',
                     block_k: Optional[int] = None) -> torch.Tensor:
    """Attention over a monolithic KV cache (layout in the module
    docstring). ``impl='xla'`` runs ``xla_decode_attention``; otherwise
    CUDA tensors go to the Hopper kernel (or raise) and CPU tensors to
    ``xla_decode_attention``. ``block_k`` is accepted for the
    reference's signature and ignored."""
    del block_k
    b, q_len, h, d = q.shape
    kvh = k_cache.shape[2]
    if h % kvh:
        raise ValueError(f'{h} query heads not a multiple of {kvh} kv heads')
    if (k_scale is None) != (v_scale is None):
        raise ValueError('k_scale and v_scale go together')
    if impl == 'xla' or not q.is_cuda:
        if not q.is_cuda and any(
                x is not None and x.is_cuda
                for x in (k_cache, v_cache, n_valid, k_scale, v_scale)):
            raise ValueError('q is on the CPU but other inputs are on CUDA')
        return xla_decode_attention(q, k_cache, v_cache, n_valid, k_scale,
                                    v_scale)
    g = h // kvh
    qg = q.reshape(b, q_len, kvh, g, d).transpose(1, 2)
    qg = qg.reshape(b, kvh, q_len * g, d).contiguous()
    out = decode_attention_kernel(qg, k_cache, v_cache,
                                  n_valid.to(torch.int32), q_len,
                                  k_scale, v_scale)
    out = out.reshape(b, kvh, q_len, g, d).transpose(1, 2)
    return out.reshape(b, q_len, h, d)
