"""LoRA adapters for the stacked-layer Llama params.

The port of ``skypilot_tpu/models/lora.py``. Adapters sit on the
attention q/v projections (``W_eff = W + (alpha / r) * A @ B``), stacked
on the leading layer axis like the base weights: ``A`` is drawn from
N(0, 1/r), ``B`` starts at zero, so a fresh adapter is the base model.
``merge`` folds adapters into the dense weights.

Multi-adapter serving: the paged engine keeps a fixed stack of adapter
pages (``init_adapter_pages``: ``[L, P, ...]`` tensors; page 0 is the
base model, all zeros with scale 0) and each slot carries a page index.
``apply_lora_pages`` gathers each slot's A/B pages by index and runs the
same two-stage product as ``apply_lora_qv``, so one step serves a batch
of different adapters and a slot on page 0 gets an exact-zero delta.
Ranks are padded to the stack's ``max_rank`` with zero columns and rows,
which add exact zeros. The reference computes these products as XLA
einsums, not as a kernel; here they are PyTorch einsums. Under a
tensor-parallel mesh each rank's store holds the B pages of its own
query and kv heads (``shards=``, ``shard=``): the deltas then land on
the rank's heads of q and v with no collective, the sums the
reference's replicated store gives, since q and v heads never mix
before attention.

Seeds come from explicit ``torch.Generator``s, so the draws differ from
the reference's threefry draws; ``models/convert.py`` carries the
reference's adapters over where the same numbers are needed.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from skypilot_tpu_torch.models.config import ModelConfig
from skypilot_tpu_torch.models.convert import tensor_from_numpy
from skypilot_tpu_torch.utils.device import resolve_device

Params = Dict[str, Any]

DEFAULT_ALPHA = 16.0

LEAVES = ('wq_a', 'wq_b', 'wv_a', 'wv_b')


def init_lora_params(seed: int, cfg: ModelConfig, rank: int,
                     dtype: torch.dtype = torch.float32, *,
                     device: Optional[Union[str, torch.device]] = None
                     ) -> Params:
    """Stacked q/v adapter params (``[L, ...]`` leading): A from
    N(0, 1/rank) drawn by a ``torch.Generator`` seeded with ``seed`` on
    the CPU, B zero."""
    dev = resolve_device(device)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv, n = cfg.n_heads, cfg.n_kv_heads, cfg.n_layers
    gen = torch.Generator(device='cpu')
    gen.manual_seed(int(seed))
    std = rank ** -0.5

    def a_init():
        a = std * torch.randn((n, d, rank), generator=gen,
                              dtype=torch.float32)
        return a.to(device=dev, dtype=dtype)

    return {
        'wq_a': a_init(),
        'wq_b': torch.zeros((n, rank, h, hd), dtype=dtype, device=dev),
        'wv_a': a_init(),
        'wv_b': torch.zeros((n, rank, kv, hd), dtype=dtype, device=dev),
    }


def lora_scale(rank: int, alpha: float = DEFAULT_ALPHA) -> float:
    return alpha / rank


def apply_lora_qv(x: torch.Tensor, lora: Params):
    """(delta_q, delta_v) of one layer's adapter for the attention
    input ``x`` [B, S, D]: [B, S, H, hd] and [B, S, KVH, hd]."""
    dt = x.dtype
    scale = lora_scale(lora['wq_a'].shape[-1])

    def delta(a, b):
        xr = torch.einsum('bsd,dr->bsr', x, a.to(dt))
        return torch.einsum('bsr,rhk->bshk', xr, b.to(dt)) * scale

    return (delta(lora['wq_a'], lora['wq_b']),
            delta(lora['wv_a'], lora['wv_b']))


# ---------------------------------------------------------------------
# Multi-adapter pages (paged serving runtime)
# ---------------------------------------------------------------------


def init_adapter_pages(cfg: ModelConfig, n_pages: int, max_rank: int,
                       dtype: torch.dtype = torch.float32, *,
                       device: Optional[Union[str, torch.device]] = None,
                       shards: int = 1) -> Params:
    """The adapter page store: ``[L, P, ...]`` with ``P = n_pages + 1``;
    page 0 is the base model (all zeros, scale 0), so an un-adaptered
    slot gathers an exact-zero delta. ``shards``: a tensor-parallel
    rank's store, whose ``wq_b`` / ``wv_b`` pages hold ``1 / shards`` of
    the query / kv heads (A pages stay whole)."""
    if n_pages < 1:
        raise ValueError('n_pages must be >= 1')
    if max_rank < 1:
        raise ValueError('max_rank must be >= 1')
    if cfg.n_heads % shards or cfg.n_kv_heads % shards:
        raise ValueError(f'{cfg.n_heads} query and {cfg.n_kv_heads} kv '
                         f'heads do not split over {shards} shards')
    dev = resolve_device(device)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.n_heads // shards, cfg.n_kv_heads // shards
    n = cfg.n_layers
    p = n_pages + 1

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    return {
        'wq_a': zeros(n, p, d, max_rank),
        'wq_b': zeros(n, p, max_rank, h, hd),
        'wv_a': zeros(n, p, d, max_rank),
        'wv_b': zeros(n, p, max_rank, kv, hd),
        'scale': zeros(n, p, dt=torch.float32),
    }


def _as_tensor(value: Any) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value
    return tensor_from_numpy(np.asarray(value))


def write_adapter_page(pages: Params, page: int, lora: Params,
                       alpha: float = DEFAULT_ALPHA, *,
                       shard: Tuple[int, int] = (0, 1)) -> Params:
    """Upload one adapter into page slot ``page``, in place (rank
    zero-padded to the store's max_rank). ``lora``'s leaves may be
    tensors or numpy arrays. ``shard`` = (index, count): a
    tensor-parallel rank's store (``init_adapter_pages(shards=count)``)
    takes head block ``index`` of the whole adapter's B, the block
    ``inference/sharding`` gives that rank's ``wq`` and ``wv``. Returns
    the page store."""
    if page < 1:
        raise ValueError('page 0 is reserved for the base model')
    max_rank = pages['wq_a'].shape[-1]
    rank = int(lora['wq_a'].shape[-1])
    if rank > max_rank:
        raise ValueError(
            f'adapter rank {rank} exceeds the page store max_rank '
            f'{max_rank}')
    dev, dt = pages['wq_a'].device, pages['wq_a'].dtype
    index, count = shard
    for key in LEAVES:
        value = _as_tensor(lora[key]).to(device=dev, dtype=dt)
        if key.endswith('_b') and count > 1:    # [L, rank, heads, hd]
            heads = pages[key].shape[3]
            if value.shape[2] != heads * count:
                raise ValueError(
                    f'{key} has {value.shape[2]} heads; a store of '
                    f'{heads} a shard over {count} shards takes '
                    f'{heads * count}')
            value = value.narrow(2, index * heads, heads)
        slot = pages[key][:, page]
        slot.zero_()
        if key.endswith('_a'):      # [L, d, rank] into [L, d, max_rank]
            slot[:, :, :rank] = value
        else:                       # [L, rank, heads, hd]
            slot[:, :rank] = value
    pages['scale'][:, page] = lora_scale(rank, alpha)
    return pages


def adapter_nbytes(cfg: ModelConfig, rank: int,
                   itemsize: int = 4) -> int:
    """Weight bytes of one rank-``rank`` q/v adapter (the charge the
    engine accounts against the KV block pool)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv, n = cfg.n_heads, cfg.n_kv_heads, cfg.n_layers
    per_layer = rank * (d + h * hd) + rank * (d + kv * hd)
    return n * per_layer * itemsize


def apply_lora_pages(x: torch.Tensor, pages: Params,
                     adapter_ids: torch.Tensor):
    """Per-slot adapter deltas, grouped (the BGMV shape, einsum form).

    ``x``: [B, S, D] attention input; ``pages``: one layer's slice of
    the store ({'wq_a': [P, d, r], ...}); ``adapter_ids``: [B] page
    index per slot (0 = base, exact-zero delta). Returns ``(delta_q,
    delta_v)`` shaped like the q/v projections."""
    dt = x.dtype
    ids = adapter_ids.long()
    s = pages['scale'][ids].to(dt)[:, None, None, None]   # [B,1,1,1]

    def delta(a_pages, b_pages):
        a = a_pages[ids].to(dt)                           # [B, d, r]
        b = b_pages[ids].to(dt)                           # [B, r, h, hd]
        xr = torch.einsum('bsd,bdr->bsr', x, a)
        return torch.einsum('bsr,brhk->bshk', xr, b) * s

    return (delta(pages['wq_a'], pages['wq_b']),
            delta(pages['wv_a'], pages['wv_b']))


def attach(params: Params, lora: Params) -> Params:
    """Params with the adapter subtree mounted at ``layers/lora``."""
    out = dict(params)
    out['layers'] = dict(params['layers'])
    out['layers']['lora'] = lora
    return out


def detach(params: Params) -> Params:
    out = dict(params)
    out['layers'] = {k: v for k, v in params['layers'].items()
                     if k != 'lora'}
    return out


def merge(params: Params, alpha: float = DEFAULT_ALPHA) -> Params:
    """Fold adapters into the dense weights (in fp32, cast back):
    wq += scale * A_q @ B_q, wv += scale * A_v @ B_v, with the rank
    read from the adapter's shapes."""
    lora = params['layers'].get('lora')
    if lora is None:
        return params
    scale = lora_scale(lora['wq_a'].shape[-1], alpha)
    merged = detach(params)
    attn = dict(merged['layers']['attn'])
    f32 = torch.float32
    for w, a, b in (('wq', 'wq_a', 'wq_b'), ('wv', 'wv_a', 'wv_b')):
        attn[w] = (attn[w].to(f32) + scale * torch.einsum(
            'ldr,lrhk->ldhk', lora[a].to(f32),
            lora[b].to(f32))).to(attn[w].dtype)
    merged['layers'] = dict(merged['layers'])
    merged['layers']['attn'] = attn
    return merged
