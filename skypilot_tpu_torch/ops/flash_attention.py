"""Flash attention (causal or not, GQA, optional segment ids) with its
backward: the port of ``skypilot_tpu/ops/pallas/flash_attention.py``.

Public entry ``flash_attention(q, k, v, *, causal, segment_ids)`` in the
model layout: q ``[B, S, H, D]``, k/v ``[B, S, KVH, D]``, segment ids
``[B, S]`` (packed sequences: scores across segments are masked);
returns ``[B, S, H, D]``. It is a ``torch.autograd.Function`` whose
forward saves (q, k, v, o, lse) and whose backward computes
``delta = rowsum(do * o)`` (plain XLA in the reference), dq and dk/dv.

Two implementations behind it:

* the Hopper kernels (``csrc/flash_attention.cu``), for CUDA tensors:
  forward (``_fwd_kernel`` / ``_fwd_kernel_seg``), dq (``_bwd_dq_kernel``
  / ``_seg``, which also computes delta and writes it for dk/dv) and
  dk/dv (``_bwd_dkv_kernel`` / ``_seg``). They read the
  model layout in place, so the reference's four transposes are gone. A
  CUDA tensor inside the gate reaches the kernels or the call raises:
  there is no fallback.
* ``flash_forward_reference`` / ``flash_backward_reference``: the plain
  PyTorch versions of the same algebra (fp32 scores, finite
  ``NEG_INF`` masks, ``max(l, 1e-30)``, P rounded to v's type before
  P.V), for CPU tensors (the tier-1 tests) and as the kernels'
  comparison on the card.

The kernel wrappers and the plain versions also take
``kv_segment_ids``, the key rows' segment ids apart from the query
rows' (the TPU kernel's ``seg_q_ref`` / ``seg_k_ref``):
``ops/ring_attention.py`` pairs one rank's query block with another
rank's key block. Without it the key rows' ids are the query rows'.

The gate is the reference's ``_supported``: equal query and key
lengths, 128-multiple blocks (so S % 128 == 0), head_dim % 128 == 0 and
a whole GQA group. Outside it the call warns once and runs
``xla_attention``, as the reference does (head_dim 64 configs and
sequences off the 128 grid do so on the card too, until a kernel
covers them: ROADMAP). Inside it, the kernels take bf16 or fp32 with
head_dim 128 or 256 and raise on anything else; a launch error comes
back from the launcher (``cudaFuncSetAttribute`` for shared memory,
``cudaGetLastError``) and raises.

``LAUNCHES`` counts kernel launches, one plain integer per kernel and
segment flag, so a run can show that the main path went through them;
``FALLBACKS`` counts the calls that ran ``xla_attention`` instead, so
it can show that none did.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from skypilot_tpu_torch.ops.common import (NEG_INF, fit_block,
                                           warn_fallback_once)

LAUNCHES: Dict[str, int] = {'flash_fwd': 0, 'flash_fwd_seg': 0,
                            'flash_dq': 0, 'flash_dq_seg': 0,
                            'flash_dkv': 0, 'flash_dkv_seg': 0}

DEFAULT_BLOCK_Q = 512
DEFAULT_BLOCK_K = 512
# Calls outside the gate, which ran ``xla_attention`` instead of the
# kernels, by the device type of their tensors.
FALLBACKS: Dict[str, int] = {'cuda': 0, 'cpu': 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (128, 256)
_lib: Optional[ctypes.CDLL] = None


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, FALLBACKS):
        for name in counts:
            counts[name] = 0


def _block_sizes(s: int) -> Tuple[int, int]:
    return fit_block(s, DEFAULT_BLOCK_Q), fit_block(s, DEFAULT_BLOCK_K)


def _supported(q: torch.Tensor, k: torch.Tensor) -> bool:
    """The reference's gate (``flash_attention.py:_supported``)."""
    s_q, s_k = q.shape[1], k.shape[1]
    bq, bk = _block_sizes(s_q)
    if s_q != s_k:
        return False
    if bq % 128 or bk % 128:
        return False
    if q.shape[-1] % 128:
        return False
    if q.shape[2] % k.shape[2]:
        return False  # invalid GQA config; xla_attention raises clearly
    return True


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def _mask(s: int, device, causal: bool,
          segment_ids: Optional[torch.Tensor],
          kv_segment_ids: Optional[torch.Tensor] = None
          ) -> Optional[torch.Tensor]:
    """Boolean keep-mask broadcastable to [B, KVH, G, Sq, Sk]; the key
    rows' segment ids are ``kv_segment_ids`` where given, else the query
    rows'."""
    mask = None
    if causal:
        pos = torch.arange(s, device=device)
        mask = (pos[:, None] >= pos[None, :])[None, None, None]
    if segment_ids is not None:
        keys = segment_ids if kv_segment_ids is None else kv_segment_ids
        seg = (segment_ids[:, :, None] == keys[:, None, :])[:, None, None]
        mask = seg if mask is None else mask & seg
    return mask


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool,
            segment_ids: Optional[torch.Tensor],
            kv_segment_ids: Optional[torch.Tensor] = None):
    """Scaled, masked fp32 scores [B, KVH, G, S, S] and the scaled
    grouped queries [B, S, KVH, G, D]."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    qg = q.float().reshape(b, s, kvh, h // kvh, d) * (d ** -0.5)
    sc = torch.einsum('bqhgd,bkhd->bhgqk', qg, k.float())
    mask = _mask(s, q.device, causal, segment_ids, kv_segment_ids)
    if mask is not None:
        sc = torch.where(mask, sc, NEG_INF)
    return sc, qg


def flash_forward_reference(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True,
                            segment_ids: Optional[torch.Tensor] = None,
                            kv_segment_ids: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernels' function in plain PyTorch: (o [B,S,H,D] in
    q's type, lse [B,H,S] fp32). A row with no key left (possible only
    with ``kv_segment_ids``) gets the mean of v and an lse of about
    ``NEG_INF``: no weight in a merge over key blocks."""
    b, s, h, d = q.shape
    sc, _ = _scores(q, k, causal, segment_ids, kv_segment_ids)
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.exp(sc - m)
    l_safe = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    acc = torch.einsum('bhgqk,bkhd->bhgqd', p.to(v.dtype).float(), v.float())
    o = (acc / l_safe).permute(0, 3, 1, 2, 4).reshape(b, s, h, d)
    lse = (m + torch.log(l_safe)).reshape(b, h, s)
    return o.to(q.dtype), lse


def _delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """rowsum(do * o) in fp32, [B, H, S]."""
    return (do.float() * o.float()).sum(dim=-1).transpose(1, 2).contiguous()


def _probs(q, k, v, o, lse, do, causal, segment_ids, kv_segment_ids=None):
    """p = exp(s - lse) and ds = p (do v^T - delta), [B,KVH,G,S,S] fp32,
    with the scaled grouped q and the grouped fp32 do."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    sc, qg = _scores(q, k, causal, segment_ids, kv_segment_ids)
    p = torch.exp(sc - lse.reshape(b, kvh, g, s, 1))
    dog = do.float().reshape(b, s, kvh, g, d)
    dp = torch.einsum('bqhgd,bkhd->bhgqk', dog, v.float())
    delta = _delta(o, do).reshape(b, kvh, g, s, 1)
    return p, p * (dp - delta), qg, dog


def _dq(ds, q, k):
    b, s, h, d = q.shape
    dq = torch.einsum('bhgqk,bkhd->bqhgd', ds, k.float()) * (d ** -0.5)
    return dq.reshape(b, s, h, d).to(q.dtype)


def _dkv(p, ds, qg, dog, k, v):
    dk = torch.einsum('bhgqk,bqhgd->bkhd', ds, qg)
    dv = torch.einsum('bhgqk,bqhgd->bkhd', p, dog)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_dq_reference(q, k, v, o, lse, do, *, causal: bool = True,
                       segment_ids: Optional[torch.Tensor] = None,
                       kv_segment_ids: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """The dq kernel's function in plain PyTorch: ds k * scale."""
    _, ds, _, _ = _probs(q, k, v, o, lse, do, causal, segment_ids,
                         kv_segment_ids)
    return _dq(ds, q, k)


def flash_dkv_reference(q, k, v, o, lse, do, *, causal: bool = True,
                        segment_ids: Optional[torch.Tensor] = None,
                        kv_segment_ids: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dk/dv kernel's function in plain PyTorch: (ds^T q * scale,
    p^T do), summed over the GQA group in fp32."""
    p, ds, qg, dog = _probs(q, k, v, o, lse, do, causal, segment_ids,
                            kv_segment_ids)
    return _dkv(p, ds, qg, dog, k, v)


def flash_backward_reference(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             lse: torch.Tensor, do: torch.Tensor, *,
                             causal: bool = True,
                             segment_ids: Optional[torch.Tensor] = None,
                             kv_segment_ids: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Both backward kernels' function in plain PyTorch, from the saved
    lse: p = exp(s - lse), ds = p (do v^T - delta). Returns (dq, dk,
    dv) in q's, k's and v's types."""
    p, ds, qg, dog = _probs(q, k, v, o, lse, do, causal, segment_ids,
                            kv_segment_ids)
    return (_dq(ds, q, k),) + _dkv(p, ds, qg, dog, k, v)


# ---------------------------------------------------------------------------
# Hopper kernel wrappers
# ---------------------------------------------------------------------------

def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from skypilot_tpu_torch import _build
        lib = _build.load_library('flash_attention')
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.skyt_flash_fwd.argtypes = [p] * 7 + [i] * 6 + [f, i, p]
        lib.skyt_flash_fwd.restype = i
        lib.skyt_flash_bwd_dq.argtypes = [p] * 10 + [i] * 6 + [f, i, p]
        lib.skyt_flash_bwd_dq.restype = i
        lib.skyt_flash_bwd_dkv.argtypes = [p] * 10 + [i] * 6 + [f, i, p]
        lib.skyt_flash_bwd_dkv.restype = i
        _lib = lib
    return _lib


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f'flash_attention kernel: {msg}')


def _check_inputs(q, k, v, segment_ids, kv_segment_ids, *extra) -> None:
    """Raise on anything the kernels do not take."""
    b, s, h, d = q.shape
    tensors = [q, k, v] + [x for x in extra if x is not None]
    _check(kv_segment_ids is None or segment_ids is not None,
           'key segment ids need the query rows\' segment ids')
    for ids in (segment_ids, kv_segment_ids):
        if ids is not None:
            tensors.append(ids)
            _check(ids.dtype == torch.int32 and tuple(ids.shape) == (b, s),
                   'segment ids must be int32 [B,S]')
    dev = q.device
    _check(all(x.is_cuda and x.device == dev for x in tensors),
           'all tensors must be on one CUDA device')
    _check(q.dtype in _DTYPE_CODES, f'dtype {q.dtype} (bf16 or fp32)')
    _check(k.dtype == q.dtype and v.dtype == q.dtype,
           'q, k and v must share a dtype')
    _check(k.dim() == 4 and k.shape == v.shape and k.shape[0] == b and
           k.shape[1] == s and k.shape[3] == d, 'k/v must be [B,S,KVH,D]')
    _check(h % k.shape[2] == 0, f'{h} heads not a multiple of '
           f'{k.shape[2]} kv heads')
    _check(d in _HEAD_DIMS, f'head dim {d} (one of {_HEAD_DIMS})')
    _check(s % 64 == 0, f'sequence length {s} not a multiple of 64')
    _check(all(x.is_contiguous() for x in tensors),
           'inputs must be contiguous')
    _check(all(x.data_ptr() % 16 == 0 for x in tensors),
           'inputs must be 16-byte aligned')


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def flash_forward_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         segment_ids: Optional[torch.Tensor] = None,
                         kv_segment_ids: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel: (o [B,S,H,D], lse [B,H,S] fp32).
    ``kv_segment_ids``: the key rows' segment ids where they are not the
    query rows' (a ring attention block)."""
    _check_inputs(q, k, v, segment_ids, kv_segment_ids)
    b, s, h, d = q.shape
    lib = _library()
    o = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    err = lib.skyt_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(segment_ids),
        _ptr(kv_segment_ids), o.data_ptr(), lse.data_ptr(), b, s, h,
        k.shape[2], d, int(causal),
        d ** -0.5, _DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f'flash forward kernel launch failed: CUDA '
                           f'error {err}')
    LAUNCHES['flash_fwd_seg' if segment_ids is not None else
             'flash_fwd'] += 1
    return o, lse


def _backward_common(q, k, causal):
    """The trailing C arguments of the dq and dk/dv launches: shape,
    scale, type and stream."""
    b, s, h, d = q.shape
    return (b, s, h, k.shape[2], d, int(causal), d ** -0.5,
            _DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)


def _check_stats(q, *stats) -> None:
    b, s, h, _ = q.shape
    _check(all(x.dtype == torch.float32 and tuple(x.shape) == (b, h, s)
               for x in stats), 'lse and delta must be fp32 [B,H,S]')


def flash_dq_kernel(q, k, v, o, lse, do, *, causal: bool = True,
                    segment_ids: Optional[torch.Tensor] = None,
                    kv_segment_ids: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the dq kernel: (dq [B,S,H,D], delta = rowsum(do * o)
    [B,H,S] fp32, which the dk/dv kernel takes)."""
    _check_inputs(q, k, v, segment_ids, kv_segment_ids, o, do, lse)
    _check(o.shape == q.shape and o.dtype == q.dtype and
           do.shape == q.shape and do.dtype == q.dtype,
           'o and do must match q')
    _check_stats(q, lse)
    common = _backward_common(q, k, causal)
    lib = _library()
    dq = torch.empty_like(q)
    delta = torch.empty_like(lse)
    err = lib.skyt_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), _ptr(segment_ids),
        _ptr(kv_segment_ids), dq.data_ptr(), *common)
    if err != 0:
        raise RuntimeError(f'flash dq kernel launch failed: CUDA error '
                           f'{err}')
    LAUNCHES['flash_dq_seg' if segment_ids is not None else
             'flash_dq'] += 1
    return dq, delta


def flash_dkv_kernel(q, k, v, lse, do, delta, *, causal: bool = True,
                     segment_ids: Optional[torch.Tensor] = None,
                     kv_segment_ids: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the dk/dv kernel (``delta`` from the dq kernel)."""
    _check_inputs(q, k, v, segment_ids, kv_segment_ids, do, lse, delta)
    _check(do.shape == q.shape and do.dtype == q.dtype, 'do must match q')
    _check_stats(q, lse, delta)
    common = _backward_common(q, k, causal)
    lib = _library()
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    err = lib.skyt_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), _ptr(segment_ids),
        _ptr(kv_segment_ids), dk.data_ptr(), dv.data_ptr(), *common)
    if err != 0:
        raise RuntimeError(f'flash dk/dv kernel launch failed: CUDA error '
                           f'{err}')
    LAUNCHES['flash_dkv_seg' if segment_ids is not None else
             'flash_dkv'] += 1
    return dk, dv


def flash_backward_kernel(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, o: torch.Tensor,
                          lse: torch.Tensor, do: torch.Tensor, *,
                          causal: bool = True,
                          segment_ids: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """The dq kernel (which computes delta = rowsum(do * o)), then the
    dk/dv kernel on the same stream: (dq, dk, dv)."""
    _check(o.shape == q.shape and o.is_cuda, 'o must match q on CUDA')
    dq, delta = flash_dq_kernel(q, k, v, o, lse, do, causal=causal,
                                segment_ids=segment_ids)
    dk, dv = flash_dkv_kernel(q, k, v, lse, do, delta, causal=causal,
                              segment_ids=segment_ids)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# autograd plumbing + public entry
# ---------------------------------------------------------------------------

class _FlashAttention(torch.autograd.Function):
    """The reference's ``_flash`` / ``_flash_seg`` custom_vjp pair: one
    Function with an optional segment-id input (no gradient)."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, causal):
        if q.is_cuda:
            o, lse = flash_forward_kernel(q, k, v, causal=causal,
                                          segment_ids=segment_ids)
        else:
            o, lse = flash_forward_reference(q, k, v, causal=causal,
                                             segment_ids=segment_ids)
        ctx.save_for_backward(q, k, v, o, lse, segment_ids)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, segment_ids = ctx.saved_tensors
        do = do.contiguous()
        if q.is_cuda:
            dq, dk, dv = flash_backward_kernel(
                q, k, v, o, lse, do, causal=ctx.causal,
                segment_ids=segment_ids)
        else:
            dq, dk, dv = flash_backward_reference(
                q, k, v, o, lse, do, causal=ctx.causal,
                segment_ids=segment_ids)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    segment_ids: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Public entry. q: [B,S,H,D]; k,v: [B,S,KV,D]; returns [B,S,H,D].

    Shapes outside the reference's gate warn once, count in
    ``FALLBACKS`` and run ``xla_attention``; inside it, CUDA tensors run
    the Hopper kernels (or raise) and CPU tensors their plain versions."""
    from skypilot_tpu_torch.ops.attention import xla_attention
    if not _supported(q, k):
        FALLBACKS[q.device.type] = FALLBACKS.get(q.device.type, 0) + 1
        warn_fallback_once('flash attention',
                           f'shape (q={tuple(q.shape)}, '
                           f'k={tuple(k.shape)})')
        return xla_attention(q, k, v, causal=causal,
                             segment_ids=segment_ids)
    tensors = [k, v] + ([segment_ids] if segment_ids is not None else [])
    if any(x.device != q.device for x in tensors):
        raise ValueError('flash_attention: q, k, v and segment ids must be '
                         'on one device')
    if segment_ids is not None:
        segment_ids = segment_ids.to(torch.int32).contiguous()
    return _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), segment_ids, causal)
