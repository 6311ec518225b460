"""KV-cache decoding for the Llama family: the port of
``skypilot_tpu/models/decode.py`` (both halves).

Monolithic cache (the batch ``InferenceEngine``):

* ``KVCache``: stacked-layer arrays ``[L, B, max_len, kv_heads,
  head_dim]`` + per-sequence lengths (int8 with per-row fp32 scales
  when ``cfg.kv_cache_dtype == 'int8'``).
* ``prefill`` runs the right-padded prompt batch in one causal pass
  (flash attention) and writes the cache; only the last valid row of
  each prompt goes through the LM head.
* ``decode_step`` writes each active sequence's new K/V row at
  ``lengths[b]`` in place (the counterpart of the reference's one-hot
  ``jnp.where``) and attends through ``ops/decode_attention.py`` (the
  Hopper kernel for CUDA tensors).
* ``sample`` and ``generate``: exactly ``max_new_tokens`` decode steps,
  as the reference's scan, EOS handled by masking.

Paged pool (the continuous engine):

* ``PagedKVCache``: a pool of fixed-size KV blocks per layer
  ``[L, num_blocks, block_size, kv_heads, head_dim]`` plus per-slot
  block tables and lengths. Block 0 is the reserved null block: unused
  table entries point at it, and masked (inactive / padding) writes
  land in it.
* ``prefill_chunk`` absorbs one fixed-size prompt chunk of one slot;
  ``paged_verify_step`` runs a Q-token window for every slot in one
  pass; ``paged_decode_step`` is its Q=1 case that also advances the
  lengths.

Differences of idiom from the reference: the layer loop is a Python
loop over the stacked ``[L, ...]`` weights (the reference's
``lax.scan``), and the pool is written IN PLACE (``index_put_``): the
functions return the cache object they were given (or a shallow copy
with new lengths) whose pool tensors they have updated, where the
reference returns new arrays. Attention over the pool goes through
``ops/paged_attention.py`` (the Hopper kernel for CUDA tensors);
chunked-prefill attention is plain PyTorch, as it is plain XLA in the
reference. The multi-LoRA adapter page store (``models/lora.py``) is
indexed by layer where the reference mounts it in the layer scan; with
``lora_pages=None`` the paged functions run exactly the base ops. A
MoE layer runs ``llama._moe_block`` in every prefill, decode and verify
step, as the reference's ``_mlp`` does.

Tensor parallelism (inside ``parallel.sharding.mesh_context``, one
process per shard, params sliced by ``inference/sharding.py``): the
column-parallel projections (``wq``/``wk``/``wv``, ``wi_*``) give each
rank its heads and its part of the MLP; attention runs on those heads
(the same kernels at the shard's shapes, the cache holding only this
rank's kv heads); the row-parallel ``wo`` and ``mlp.wo`` end with an
all-reduce of fp32 partial sums (int32 for W8A8, whose activation scale
is the max over every rank's part); the embedding is vocab-sharded
(masked lookup plus all-reduce) and so is the LM head, whose columns
are assembled on every rank by an all-reduce of zero-padded shards
(exact), so the driver samples from the whole row. ``generate``
broadcasts the driver's draw each step. MoE layers raise under a mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import torch

from skypilot_tpu_torch.models import lora as lora_lib
from skypilot_tpu_torch.models.config import ModelConfig
from skypilot_tpu_torch.models.llama import (_activate, _moe_block,
                                             apply_rope, fp32_logits,
                                             rope_table_for)
from skypilot_tpu_torch.models.quant import QTensor, weight_einsum
from skypilot_tpu_torch.ops.attention import multi_head_attention
from skypilot_tpu_torch.ops.common import NEG_INF
from skypilot_tpu_torch.ops.decode_attention import decode_attention
from skypilot_tpu_torch.ops.norms import rms_norm
from skypilot_tpu_torch.ops.paged_attention import paged_attention
from skypilot_tpu_torch.parallel.sharding import (ambient_tensor_parallelism,
                                                  divides)
from skypilot_tpu_torch.utils.device import resolve_device

Params = Dict[str, Any]


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 over the trailing head_dim axis
    (``torch.round`` rounds half to even, like ``jnp.round``)."""
    x32 = x.float()
    absmax = torch.amax(torch.abs(x32), dim=-1)
    scale = torch.clamp(absmax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def serving_params(params: Params, cfg: ModelConfig) -> Params:
    """Store the projection and embedding weights in ``compute_dtype``
    once, at load. The reference casts fp32 weights to the compute
    dtype inside every einsum, so the results are the same and the
    weights take half the memory; norm scales, the MoE router and W8A8
    ``QTensor``s stay as they are (the reference reads them in fp32 /
    int8; the router routes in fp32)."""
    dt = cfg.compute_dtype

    def cast(node, key=''):
        if isinstance(node, dict):
            return {k: cast(v, k) for k, v in node.items()}
        if key in ('scale', 'router') or isinstance(node, QTensor):
            return node
        return node.to(dt)

    return cast(params)


def _layer(params: Params, index: int) -> Params:
    """Layer ``index``'s slice of the stacked ``[L, ...]`` weights."""
    def take(node):
        if isinstance(node, dict):
            return {k: take(v) for k, v in node.items()}
        return node[index]
    return take(params['layers'])


def _embed(params: Params, tokens: torch.Tensor,
           cfg: ModelConfig) -> torch.Tensor:
    # The reference's iota one-hot einsum (use_iota_embed) picks the
    # same rows exactly; a gather is its plain form.
    table = params['embed']['embedding']
    tp = ambient_tensor_parallelism()
    if tp.degree == 1:
        return table[tokens.long()].to(cfg.compute_dtype)
    # Vocab-sharded table: this rank holds rows [rank*Vl, (rank+1)*Vl).
    # A token outside them reads zeros, so the sum over the ranks has one
    # nonzero term and is the row itself, exactly.
    local = tokens.long() - tp.rank * table.shape[0]
    mine = (local >= 0) & (local < table.shape[0])
    rows = table[torch.where(mine, local, 0)].float()
    rows = torch.where(mine[..., None], rows, 0.0)
    return tp.all_reduce(rows).to(cfg.compute_dtype)


def _gather_vocab(local: torch.Tensor) -> torch.Tensor:
    """Vocab-sharded fp32 logits [..., V/tp] -> [..., V] on every rank:
    each rank writes its columns into zeros and the sum over the ranks
    (one nonzero term a column, so exact) assembles the row; the
    sampling rank reads it."""
    tp = ambient_tensor_parallelism()
    if tp.degree == 1:
        return local
    v = local.shape[-1]
    full = local.new_zeros(*local.shape[:-1], v * tp.degree)
    full[..., tp.rank * v:(tp.rank + 1) * v] = local
    return tp.all_reduce(full)


def _row_reduce():
    """The all-reduce a row-parallel projection (``wo``, ``mlp.wo``)
    ends with under tensor parallelism, else None."""
    tp = ambient_tensor_parallelism()
    return tp.all_reduce if tp.degree > 1 else None


def _local_kv_heads(cfg: ModelConfig) -> int:
    """This rank's kv heads: all of them, or ``n_kv_heads / tensor``
    under tensor parallelism (the pool holds only this rank's heads)."""
    return divides(cfg.n_kv_heads, ambient_tensor_parallelism().degree,
                   'n_kv_heads')


def _lm_head(params: Params, x: torch.Tensor,
             cfg: ModelConfig) -> torch.Tensor:
    """Final norm + vocab projection with compute-dtype operands and an
    fp32 result, like the reference's ``preferred_element_type``: the
    fp32 accumulator is never rounded to the compute dtype."""
    x = rms_norm(x, params['final_norm']['scale'], cfg.norm_eps)
    dt = cfg.compute_dtype
    if cfg.tie_embeddings:
        head = params['embed']['embedding'].to(dt).t()
    elif isinstance(params['lm_head']['w'], QTensor):
        return _gather_vocab(weight_einsum(
            'bsd,dv->bsv', x, params['lm_head']['w'], torch.float32))
    else:
        head = params['lm_head']['w'].to(dt)
    return _gather_vocab(fp32_logits(x.to(dt), head))


def _mlp(x: torch.Tensor, lp: Params, cfg: ModelConfig) -> torch.Tensor:
    if cfg.is_moe:
        if ambient_tensor_parallelism().degree > 1:
            raise NotImplementedError(
                'MoE layers under a tensor-parallel mesh are not ported '
                'yet (ROADMAP.md, queue A item 15)')
        # The training block, dense or capacity per cfg.moe_dispatch (a
        # padded chunk's rows route and claim capacity like real ones,
        # as in the reference); the aux loss is a training term.
        return _moe_block(x, lp['moe'], cfg, with_aux=False)[0]
    dt = cfg.compute_dtype
    mlp = lp['mlp']
    gate = weight_einsum('bsd,df->bsf', x, mlp['wi_gate'], dt)
    up = weight_einsum('bsd,df->bsf', x, mlp['wi_up'], dt)
    return weight_einsum('bsf,fd->bsd', _activate(gate, cfg) * up,
                         mlp['wo'], dt, reduce=_row_reduce())


def _qkv(x: torch.Tensor, lp: Params, cfg: ModelConfig, sin, cos,
         lora: Optional[Tuple[Params, torch.Tensor]] = None):
    """q, k (roped) and v of one layer. ``lora``: (this layer's
    adapter pages, per-row page ids); their q/v deltas are added before
    RoPE, as in the reference."""
    dt = cfg.compute_dtype
    h = rms_norm(x, lp['ln_attn']['scale'], cfg.norm_eps)
    q = weight_einsum('bsd,dhk->bshk', h, lp['attn']['wq'], dt)
    k = weight_einsum('bsd,dhk->bshk', h, lp['attn']['wk'], dt)
    v = weight_einsum('bsd,dhk->bshk', h, lp['attn']['wv'], dt)
    if lora is not None:
        dq, dv = lora_lib.apply_lora_pages(h, *lora)
        q = q + dq
        v = v + dv
    return apply_rope(q, sin, cos), apply_rope(k, sin, cos), v


def _lora_layer(lora_pages: Optional[Params], adapter_ids, layer: int
                ) -> Optional[Tuple[Params, torch.Tensor]]:
    """Layer ``layer``'s slice of the ``[L, P, ...]`` page store with
    the page ids (the reference mounts the store in its layer scan)."""
    if lora_pages is None:
        return None
    return ({k: v[layer] for k, v in lora_pages.items()}, adapter_ids)


def _attn_out_and_mlp(x: torch.Tensor, attn: torch.Tensor, lp: Params,
                      cfg: ModelConfig) -> torch.Tensor:
    x = x + weight_einsum('bshk,hkd->bsd', attn, lp['attn']['wo'],
                          cfg.compute_dtype, reduce=_row_reduce())
    h = rms_norm(x, lp['ln_mlp']['scale'], cfg.norm_eps)
    return x + _mlp(h, lp, cfg)


# ---------------------------------------------------------------------------
# Monolithic KV cache: prefill, decode step, sampling, generate
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class KVCache:
    """Stacked-layer KV cache + per-sequence lengths.

    With ``cfg.kv_cache_dtype == 'int8'`` k/v hold int8 and
    ``k_scale``/``v_scale`` per-row (position x kv head) fp32 scales,
    dequantized inside the decode-attention kernel."""
    k: torch.Tensor        # [L, B, max_len, kv_heads, head_dim]
    v: torch.Tensor
    lengths: torch.Tensor  # [B] int32 valid positions per sequence
    k_scale: Optional[torch.Tensor] = None   # [L, B, max_len, kv_heads]
    v_scale: Optional[torch.Tensor] = None

    @property
    def max_len(self) -> int:
        return self.k.shape[2]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device: Optional[Union[str, torch.device]] = None
               ) -> KVCache:
    if cfg.kv_cache_dtype not in ('compute', 'int8'):
        raise ValueError(
            f"kv_cache_dtype must be 'compute' or 'int8', got "
            f'{cfg.kv_cache_dtype!r}')
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, _local_kv_heads(cfg),
             cfg.resolved_head_dim)
    lengths = torch.zeros((batch,), dtype=torch.int32, device=dev)
    if cfg.kv_cache_dtype == 'int8':
        return KVCache(
            k=torch.zeros(shape, dtype=torch.int8, device=dev),
            v=torch.zeros(shape, dtype=torch.int8, device=dev),
            lengths=lengths,
            k_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
            v_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=dev))
    dt = cfg.compute_dtype
    return KVCache(k=torch.zeros(shape, dtype=dt, device=dev),
                   v=torch.zeros(shape, dtype=dt, device=dev),
                   lengths=lengths)


def _prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       cfg: ModelConfig) -> torch.Tensor:
    """Prefill attention: ``multi_head_attention`` (the flash kernels
    inside the reference's gate, i.e. prompt buckets that are multiples
    of 128). Under tensor parallelism q/k/v hold this rank's heads (the
    column-parallel projections made them), so each rank runs the same
    kernel on its head shard with no collective: the reference's
    shard_map over the head axis."""
    return multi_head_attention(q, k, v, causal=True, impl=cfg.attention_impl)


def _write_kv(cache: KVCache, layer: int, start: int, k: torch.Tensor,
              v: torch.Tensor) -> None:
    """Write k/v ``[B, S, KVH, D]`` into rows ``[start, start + S)`` of
    one layer of the cache, quantizing for an int8 cache."""
    rows = slice(start, start + k.shape[1])
    if cache.quantized:
        k_q, k_s = quantize_kv(k)
        v_q, v_s = quantize_kv(v)
        cache.k[layer, :, rows] = k_q
        cache.v[layer, :, rows] = v_q
        cache.k_scale[layer, :, rows] = k_s
        cache.v_scale[layer, :, rows] = v_s
    else:
        cache.k[layer, :, rows] = k.to(cache.k.dtype)
        cache.v[layer, :, rows] = v.to(cache.v.dtype)


def prefill(params: Params, tokens: torch.Tensor, lengths: torch.Tensor,
            cfg: ModelConfig, max_len: int) -> Tuple[torch.Tensor, KVCache]:
    """Process right-padded prompts; returns (last-token logits [B, V]
    fp32, cache). tokens: [B, S] (S <= max_len), lengths: [B] valid
    counts (>= 1).

    Only each prompt's last valid row goes through the LM head: the
    reference computes [B, S, V] logits and then takes that row (8.4 GB
    of fp32 for llama3-8b at B=8, S=2048); the row's numbers are the
    same."""
    b, s = tokens.shape
    dev = tokens.device
    sin, cos = rope_table_for(cfg, torch.arange(s, device=dev))
    x = _embed(params, tokens, cfg)
    cache = init_cache(cfg, b, max_len, device=dev)
    for layer in range(cfg.n_layers):
        lp = _layer(params, layer)
        q, k, v = _qkv(x, lp, cfg, sin, cos)
        attn = _prefill_attention(q, k, v, cfg)
        x = _attn_out_and_mlp(x, attn, lp, cfg)
        _write_kv(cache, layer, 0, k, v)
    lengths = lengths.to(device=dev, dtype=torch.int32)
    last = x[torch.arange(b, device=dev), lengths.long() - 1]   # [B, D]
    logits = _lm_head(params, last[:, None], cfg)[:, 0]
    return logits, dataclasses.replace(cache, lengths=lengths.clone())


def decode_step(params: Params, tokens: torch.Tensor, cache: KVCache,
                cfg: ModelConfig, active: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, KVCache]:
    """One autoregressive step. tokens: [B] (the just-sampled token).

    Each active sequence's K/V row is written in place at
    ``lengths[b]``; attention reads ``lengths + 1`` rows. With
    ``active`` given, an inactive sequence or one at ``max_len`` writes
    nothing; without it every sequence writes, so every length must be
    below ``max_len`` (a row past the cache fails the index). Returns
    (logits [B, V] fp32, the cache with ``lengths + active``)."""
    b = tokens.shape[0]
    dev = tokens.device
    t = cache.max_len
    lens = cache.lengths.long()
    sin, cos = rope_table_for(cfg, lens[:, None])
    x = _embed(params, tokens[:, None], cfg)                 # [B, 1, D]
    rows = torch.arange(b, device=dev)
    if active is None:
        at, write, advance = lens, None, 1
    else:
        at = torch.clamp(lens, max=t - 1)
        write = active & (lens < t)                          # [B]
        advance = active.to(torch.int32)
    n_valid = (lens + 1).to(torch.int32)
    impl = cfg.decode_attention_impl or cfg.attention_impl

    def put(buf: torch.Tensor, new: torch.Tensor) -> None:
        # The reference's one-hot jnp.where, as an in-place row write.
        new = new.to(buf.dtype)
        if write is not None:
            w = write.reshape(b, *([1] * (new.dim() - 1)))
            new = torch.where(w, new, buf[rows, at])
        buf[rows, at] = new

    for layer in range(cfg.n_layers):
        lp = _layer(params, layer)
        q, k, v = _qkv(x, lp, cfg, sin, cos)
        k_scale = v_scale = None
        if cache.quantized:
            k_q, k_s = quantize_kv(k[:, 0])
            v_q, v_s = quantize_kv(v[:, 0])
            put(cache.k[layer], k_q)
            put(cache.v[layer], v_q)
            put(cache.k_scale[layer], k_s)
            put(cache.v_scale[layer], v_s)
            k_scale, v_scale = cache.k_scale[layer], cache.v_scale[layer]
        else:
            put(cache.k[layer], k[:, 0])
            put(cache.v[layer], v[:, 0])
        attn = decode_attention(q, cache.k[layer], cache.v[layer], n_valid,
                                k_scale=k_scale, v_scale=v_scale,
                                impl=impl)
        x = _attn_out_and_mlp(x, attn, lp, cfg)
    logits = _lm_head(params, x, cfg)[:, 0]
    return logits, dataclasses.replace(
        cache, lengths=cache.lengths + advance)


def sample(logits: torch.Tensor, generator: Optional[torch.Generator],
           temperature: float) -> torch.Tensor:
    """Greedy (temperature 0) or one draw from softmax(logits / t) per
    row with ``generator`` (the reference's ``jax.random.categorical``;
    the draws differ, the distribution is the same)."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


def generate(params: Params, tokens: torch.Tensor, lengths: torch.Tensor,
             cfg: ModelConfig, *, max_new_tokens: int,
             temperature: float = 0.0, eos_id: Optional[int] = None,
             seed: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched generation: prompts [B, S] + lengths [B] -> (generated
    [B, max_new_tokens] int32, gen_lengths [B] int32).

    Runs exactly ``max_new_tokens`` decode steps, as the reference's
    scan (rows that hit EOS keep emitting it). For temperature > 0 a
    ``torch.Generator`` on the tokens' device, seeded by ``seed``, draws
    step by step: the same seed gives the same tokens."""
    b, s = tokens.shape
    dev = tokens.device
    eos = -1 if eos_id is None else eos_id
    gen = None
    if temperature != 0.0:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
    logits, cache = prefill(params, tokens, lengths, cfg,
                            s + max_new_tokens)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    out = []
    tp = ambient_tensor_parallelism()
    for _ in range(max_new_tokens):
        tok = sample(logits, gen, temperature)
        if tp.degree > 1:
            tok = tp.broadcast(tok)   # the driver's draw, on every rank
        tok = torch.where(done, torch.full_like(tok, max(eos, 0)), tok)
        done = done | (tok == eos)
        logits, cache = decode_step(params, tok, cache, cfg)
        out.append(tok)
    generated = torch.stack(out, dim=1)                      # [B, N]
    if eos >= 0:
        hit = generated == eos
        first = torch.argmax(hit.to(torch.int32), dim=1)
        gen_lengths = torch.where(hit.any(dim=1), first,
                                  torch.full_like(first, max_new_tokens))
    else:
        gen_lengths = torch.full((b,), max_new_tokens, device=dev)
    return generated, gen_lengths.to(torch.int32)


# ---------------------------------------------------------------------------
# Paged KV cache: block-granular pool + per-slot block tables
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PagedKVCache:
    """Block-granular KV pool + per-slot block tables (PagedAttention).

    ``cfg.kv_cache_dtype == 'int8'`` stores int8 k/v with per-row fp32
    scales. Block id 0 is the reserved null block.
    """
    k: torch.Tensor        # [L, num_blocks, block_size, kv_heads, head_dim]
    v: torch.Tensor
    lengths: torch.Tensor       # [slots] int32 valid positions per slot
    block_tables: torch.Tensor  # [slots, blocks_per_slot] int32 pool ids
    k_scale: Optional[torch.Tensor] = None  # [L, num_blocks, block, kvh]
    v_scale: Optional[torch.Tensor] = None

    @property
    def block_size(self) -> int:
        return self.k.shape[2]

    @property
    def num_blocks(self) -> int:
        return self.k.shape[1]

    @property
    def blocks_per_slot(self) -> int:
        return self.block_tables.shape[1]

    @property
    def max_len(self) -> int:
        return self.blocks_per_slot * self.block_size

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def init_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                     slots: int, blocks_per_slot: int, *,
                     device: Optional[Union[str, torch.device]] = None
                     ) -> PagedKVCache:
    if cfg.kv_cache_dtype not in ('compute', 'int8'):
        raise ValueError(
            f"kv_cache_dtype must be 'compute' or 'int8', got "
            f'{cfg.kv_cache_dtype!r}')
    if num_blocks < 2:
        raise ValueError('num_blocks must be >= 2 (block 0 is reserved)')
    dev = resolve_device(device)
    shape = (cfg.n_layers, num_blocks, block_size, _local_kv_heads(cfg),
             cfg.resolved_head_dim)
    lengths = torch.zeros((slots,), dtype=torch.int32, device=dev)
    tables = torch.zeros((slots, blocks_per_slot), dtype=torch.int32,
                         device=dev)
    if cfg.kv_cache_dtype == 'int8':
        return PagedKVCache(
            k=torch.zeros(shape, dtype=torch.int8, device=dev),
            v=torch.zeros(shape, dtype=torch.int8, device=dev),
            lengths=lengths, block_tables=tables,
            k_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
            v_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=dev))
    dt = cfg.compute_dtype
    return PagedKVCache(k=torch.zeros(shape, dtype=dt, device=dev),
                        v=torch.zeros(shape, dtype=dt, device=dev),
                        lengths=lengths, block_tables=tables)


def _write_rows(pool: torch.Tensor, rows: torch.Tensor,
                values: torch.Tensor) -> None:
    """``pool[rows] = values`` in place, where ``rows`` name the null row
    (pool row 0) once for every padded or inactive input: each of those
    writes carries the last one's value, so the null row ends the same on
    every device and in every run, as the reference's serial scatter
    leaves it. An index assignment keeps an unspecified one of duplicate
    writes (on CUDA, and on the CPU when it splits the work), and padded
    chunk queries read the null row: under capacity dispatch their
    routes claim capacity from real tokens."""
    flat = rows.reshape(-1)
    values = values.reshape(flat.shape[0], *values.shape[rows.dim():])
    null = flat == 0
    order = torch.arange(flat.shape[0], device=flat.device)
    last = torch.where(null, order, -1).amax().clamp_min(0)
    null = null.view(-1, *[1] * (values.dim() - 1))
    pool[flat] = torch.where(null, values.index_select(0, last[None]),
                             values)


def _view_rows(block_tables: torch.Tensor, block_size: int) -> torch.Tensor:
    """Block tables [..., BPS] -> flat pool row per view position
    [..., BPS*block_size] (the gather index of a slot's logical view)."""
    off = torch.arange(block_size, dtype=torch.long,
                       device=block_tables.device)
    rows = block_tables.long()[..., :, None] * block_size + off
    return rows.reshape(*block_tables.shape[:-1], -1)


def _repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, S, KV, D] -> [B, S, KV*n_rep, D] (GQA broadcast)."""
    if n_rep == 1:
        return x
    b, s, kv, d = x.shape
    return x[:, :, :, None, :].expand(b, s, kv, n_rep, d).reshape(
        b, s, kv * n_rep, d)


def _chunk_attention(q: torch.Tensor, k_view: torch.Tensor,
                     v_view: torch.Tensor, q_pos: torch.Tensor,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Chunked-prefill attention: chunk queries over a gathered cache
    view that already holds the chunk's own rows.

    q: [1, C, H, D] at absolute positions ``q_pos`` [C]; k_view/v_view:
    [1, T, KVH, D] (rows at or past a query's position+1 are masked).
    Mirrors the reference numerics: fp32 scores and softmax, the
    ``NEG_INF`` mask, probabilities cast to the value dtype.
    """
    _, _, h, d = q.shape
    kvh = k_view.shape[2]
    if k_scale is not None:
        k_view = k_view.float() * k_scale[..., None]
        v_view = (v_view.float() * v_scale[..., None]).to(q.dtype)
    k_view = _repeat_kv(k_view, h // kvh)
    v_view = _repeat_kv(v_view, h // kvh)
    logits = torch.einsum('bqhd,bkhd->bhqk', q.float(),
                          k_view.float()) * (d ** -0.5)
    t = k_view.shape[1]
    mask = (torch.arange(t, device=q.device)[None, :] <=
            q_pos[:, None])[None, None]
    logits = torch.where(mask, logits, NEG_INF)
    weights = torch.softmax(logits, dim=-1)
    return torch.einsum('bhqk,bkhd->bqhd', weights.to(v_view.dtype),
                        v_view)


def prefill_chunk(params: Params, tokens: torch.Tensor, start: int,
                  n_new: int, slot: int, cache: PagedKVCache,
                  cfg: ModelConfig, lora_pages: Optional[Params] = None,
                  adapter_id: Optional[int] = None
                  ) -> Tuple[torch.Tensor, PagedKVCache]:
    """Absorb one prompt chunk for one slot into the paged pool.

    tokens: [1, C] right-padded chunk; ``start``: positions already
    cached for the slot; ``n_new``: valid tokens in this chunk;
    ``slot``: the slot's row in the block table. Chunk queries attend
    the slot's rows ``[0, start)`` plus causally within the chunk.
    Writes the chunk's K/V rows into the pool in place (padding rows go
    to the null block) and sets ``lengths[slot] = start + n_new``.
    ``lora_pages``/``adapter_id``: the adapter page store and this
    slot's page (0 = base, an exact-zero delta); None runs the base
    ops only. Returns (last-valid-token logits [1, V] fp32, cache).
    """
    _, c = tokens.shape
    dev = tokens.device
    offs = start + torch.arange(c, device=dev)               # [C] abs pos
    sin, cos = rope_table_for(cfg, offs)
    x = _embed(params, tokens, cfg)                          # [1, C, D]
    bs = cache.block_size
    bps = cache.blocks_per_slot
    nb = cache.num_blocks
    bt_slot = cache.block_tables[slot].long()                # [BPS]
    valid_tok = torch.arange(c, device=dev) < n_new
    blk = torch.clamp(offs // bs, 0, bps - 1)
    write_rows = torch.where(valid_tok, bt_slot[blk] * bs + offs % bs,
                             torch.zeros_like(offs))         # [C]
    view_rows = _view_rows(bt_slot, bs)                      # [T]
    adapter_ids = (torch.tensor([int(adapter_id or 0)], device=dev)
                   if lora_pages is not None else None)
    for layer in range(cfg.n_layers):
        lp = _layer(params, layer)
        q, k, v = _qkv(x, lp, cfg, sin, cos,
                       _lora_layer(lora_pages, adapter_ids, layer))
        kf = cache.k[layer].view(nb * bs, *cache.k.shape[3:])
        vf = cache.v[layer].view(nb * bs, *cache.v.shape[3:])
        if cache.quantized:
            k_q, k_s = quantize_kv(k)
            v_q, v_s = quantize_kv(v)
            ksf = cache.k_scale[layer].view(nb * bs, -1)
            vsf = cache.v_scale[layer].view(nb * bs, -1)
            _write_rows(kf, write_rows, k_q[0])
            _write_rows(vf, write_rows, v_q[0])
            _write_rows(ksf, write_rows, k_s[0])
            _write_rows(vsf, write_rows, v_s[0])
            attn = _chunk_attention(q, kf[view_rows][None],
                                    vf[view_rows][None], offs,
                                    k_scale=ksf[view_rows][None],
                                    v_scale=vsf[view_rows][None])
        else:
            _write_rows(kf, write_rows, k[0].to(kf.dtype))
            _write_rows(vf, write_rows, v[0].to(vf.dtype))
            attn = _chunk_attention(q, kf[view_rows][None],
                                    vf[view_rows][None], offs)
        x = _attn_out_and_mlp(x, attn, lp, cfg)
    # Only the last valid row's logits are used: project that row alone.
    last_row = max(n_new - 1, 0)
    logits = _lm_head(params, x[:, last_row:last_row + 1], cfg)
    cache.lengths[slot] = start + n_new
    return logits[:, 0], cache


def paged_decode_step(params: Params, tokens: torch.Tensor,
                      cache: PagedKVCache, cfg: ModelConfig,
                      active: Optional[torch.Tensor] = None,
                      lora_pages: Optional[Params] = None,
                      adapter_ids: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, PagedKVCache]:
    """One autoregressive step over the paged pool. tokens: [B].

    Inactive slots neither write (their rows go to the null block) nor
    advance. Returns (logits [B, V] fp32, cache with lengths advanced
    by ``active``)."""
    logits, cache = paged_verify_step(params, tokens[:, None], cache, cfg,
                                      active=active, lora_pages=lora_pages,
                                      adapter_ids=adapter_ids)
    step = (torch.ones_like(cache.lengths) if active is None
            else active.to(torch.int32))
    return logits[:, 0], dataclasses.replace(cache,
                                             lengths=cache.lengths + step)


def paged_verify_step(params: Params, tokens: torch.Tensor,
                      cache: PagedKVCache, cfg: ModelConfig,
                      active: Optional[torch.Tensor] = None,
                      n_input: Optional[torch.Tensor] = None,
                      lora_pages: Optional[Params] = None,
                      adapter_ids: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, PagedKVCache]:
    """Process a Q-token window per slot in one pass (Q == 1 is plain
    decode). tokens: [B, Q]; position ``lengths[b] + j`` holds
    ``tokens[b, j]``; ``n_input`` ([B], default Q) marks slots with
    fewer real inputs (their padded rows write to the null block and
    their padded logits are garbage the caller discards). The caller's
    block tables must cover ``lengths + n_input`` rows.
    ``lora_pages``/``adapter_ids`` ([B] page per slot, default all 0):
    per-slot adapter deltas on q/v; None runs the base ops only.

    Returns (logits [B, Q, V] fp32, cache with KV written in place and
    lengths UNCHANGED).
    """
    b, q_len = tokens.shape
    dev = tokens.device
    if active is None:
        active = torch.ones((b,), dtype=torch.bool, device=dev)
    if n_input is None:
        n_input = torch.full((b,), q_len, dtype=torch.int32, device=dev)
    lens = cache.lengths.long()
    window = torch.arange(q_len, device=dev)
    offs = lens[:, None] + window[None, :]                   # [B, Q]
    sin, cos = rope_table_for(cfg, offs)
    x = _embed(params, tokens, cfg)                          # [B, Q, D]
    bs = cache.block_size
    bps = cache.blocks_per_slot
    nb = cache.num_blocks
    valid_q = (window[None, :] < n_input[:, None]) & active[:, None]
    blk = torch.clamp(offs // bs, 0, bps - 1)
    write_rows = torch.where(
        valid_q,
        torch.gather(cache.block_tables.long(), 1, blk) * bs + offs % bs,
        torch.zeros_like(offs))                              # [B, Q]
    # Kernel mask base: rows INCLUDING the whole window; an inactive
    # slot reads one (null) row and its output is discarded.
    n_valid = torch.where(active, lens + q_len,
                          torch.ones_like(lens)).to(torch.int32)
    if lora_pages is not None and adapter_ids is None:
        adapter_ids = torch.zeros((b,), dtype=torch.int32, device=dev)
    for layer in range(cfg.n_layers):
        lp = _layer(params, layer)
        q, k, v = _qkv(x, lp, cfg, sin, cos,
                       _lora_layer(lora_pages, adapter_ids, layer))
        kf = cache.k[layer].view(nb * bs, *cache.k.shape[3:])
        vf = cache.v[layer].view(nb * bs, *cache.v.shape[3:])
        k_pool_scale = v_pool_scale = None
        if cache.quantized:
            k_q, k_s = quantize_kv(k)
            v_q, v_s = quantize_kv(v)
            _write_rows(kf, write_rows, k_q)
            _write_rows(vf, write_rows, v_q)
            _write_rows(cache.k_scale[layer].view(nb * bs, -1), write_rows,
                        k_s)
            _write_rows(cache.v_scale[layer].view(nb * bs, -1), write_rows,
                        v_s)
            k_pool_scale = cache.k_scale[layer]
            v_pool_scale = cache.v_scale[layer]
        else:
            _write_rows(kf, write_rows, k.to(kf.dtype))
            _write_rows(vf, write_rows, v.to(vf.dtype))
        attn = paged_attention(q, cache.k[layer], cache.v[layer],
                               cache.block_tables, n_valid,
                               k_scale=k_pool_scale, v_scale=v_pool_scale)
        x = _attn_out_and_mlp(x, attn, lp, cfg)
    return _lm_head(params, x, cfg), cache
