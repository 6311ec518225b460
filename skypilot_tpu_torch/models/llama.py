"""Llama-family decoder: the dense half of ``skypilot_tpu/models/llama.py``.

Params are a plain dict with the JAX package's keys and its stacked
``[L, ...]`` layer layout (``models/convert.py`` carries a JAX pytree
over as is). Here: RoPE tables (with the llama3 NTK scaling), the gated
MLP activation, ``init_params``, the attention and MLP blocks, the
reference's five remat policies and ``forward``.

Differences of idiom from the reference: the layer loop is a Python
loop over the stacked weights (the reference's ``lax.scan``), remat is
``torch.utils.checkpoint`` per layer (``_remat_policy`` says how the
selective policies are kept), and the one-hot ("iota") embedding is an
index lookup, which picks the same rows. LoRA adapters mounted at
``params['layers']['lora']`` (``models/lora.py``) add their q/v deltas
in the attention block. MoE layers (``params['layers']['moe']``) route
each token to its top-k experts with the reference's dense or capacity
dispatch; the expert products are torch einsums, as they are XLA
einsums in the reference, except dense dispatch's tokens times every
expert: one ``bmm`` with the tokens broadcast (``_to_experts``), which
reads each expert weight once where the einsum copies it first.
Pipeline stages are multi-device work and raise here.
"""
from __future__ import annotations

import contextlib
import functools
import math
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch.utils.checkpoint import (CheckpointPolicy,
                                    create_selective_checkpoint_contexts)

from skypilot_tpu_torch.models.config import ModelConfig
from skypilot_tpu_torch.models.lora import apply_lora_qv
from skypilot_tpu_torch.ops.attention import multi_head_attention
from skypilot_tpu_torch.ops.norms import rms_norm
from skypilot_tpu_torch.utils.device import resolve_device

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_table(positions: torch.Tensor, head_dim: int, theta: float,
               scaling: Optional[Tuple[float, float, float, int]] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """sin/cos tables [*, S, head_dim/2] (fp32).

    ``scaling`` = (factor, low_freq_factor, high_freq_factor,
    original_max_position): the Llama-3.1 NTK frequency rescale —
    long-wavelength frequencies are divided by ``factor``, short ones
    kept, with a smooth ramp between the two wavelength cutoffs.
    """
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=positions.device), exps)
    if scaling is not None:
        factor, low_f, high_f, orig_max = scaling
        wavelen = 2.0 * math.pi / freqs
        low_wavelen = orig_max / low_f
        high_wavelen = orig_max / high_f
        smooth = (orig_max / wavelen - low_f) / (high_f - low_f)
        smooth = torch.clamp(smooth, 0.0, 1.0)
        scaled = (1.0 - smooth) * freqs / factor + smooth * freqs
        freqs = torch.where(wavelen > low_wavelen, freqs / factor,
                            torch.where(wavelen < high_wavelen, freqs,
                                        scaled))
    angles = positions[..., None].float() * freqs      # [..., S, half]
    return torch.sin(angles), torch.cos(angles)


def rope_table_for(cfg: ModelConfig, positions: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """rope_table with the config's theta + optional llama3 scaling."""
    return rope_table(positions, cfg.resolved_head_dim, cfg.rope_theta,
                      scaling=cfg.rope_scaling)


def apply_rope(x: torch.Tensor, sin: torch.Tensor,
               cos: torch.Tensor) -> torch.Tensor:
    """x: [B, S, H, D]; sin/cos: [B, S, D/2] or [S, D/2]."""
    half = x.shape[-1] // 2
    if sin.dim() == 2:
        sin = sin[None, :, None, :]
        cos = cos[None, :, None, :]
    else:
        sin = sin[:, :, None, :]
        cos = cos[:, :, None, :]
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    return torch.cat([out1, out2], dim=-1).to(x.dtype)


def _activate(gate: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Gated-MLP nonlinearity: SwiGLU (llama) or GeGLU (gemma)."""
    if cfg.activation == 'gelu_tanh':
        return F.gelu(gate, approximate='tanh')
    return F.silu(gate)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_params(seed: int, cfg: ModelConfig, *,
                device: Optional[Union[str, torch.device]] = None,
                weight_dtype: Optional[torch.dtype] = None) -> Params:
    """Random parameters with ``skypilot_tpu``'s keys, stacked shapes and
    distributions (truncated normal of std ``fan_in**-0.5`` for the
    projections, N(0, 0.02) for the embedding, ones for the norms).

    The numbers are drawn by a ``torch.Generator`` on ``device`` (default
    ``cuda``), one layer at a time, and stored directly in
    ``weight_dtype`` (default ``cfg.param_dtype``), so a large model
    never passes through host memory and never holds a full fp32 copy
    on the card. Norm scales and the MoE router stay in
    ``cfg.param_dtype``. The draws
    differ from ``jax.random``'s: parity tests carry JAX parameters over
    with ``models/convert.py`` instead.
    """
    dev = resolve_device(device)
    wdt = weight_dtype or cfg.param_dtype
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    n_layer = cfg.n_layers

    def dense(shape, in_size) -> torch.Tensor:
        out = torch.empty(shape, dtype=torch.float32, device=dev)
        torch.nn.init.trunc_normal_(out, mean=0.0, std=1.0, a=-3.0, b=3.0,
                                    generator=gen)
        return (out * in_size ** -0.5).to(wdt)

    def stack_init(shape, in_size, dtype=None) -> torch.Tensor:
        out = torch.empty((n_layer,) + shape, dtype=dtype or wdt,
                          device=dev)
        for i in range(n_layer):
            out[i] = dense(shape, in_size)
        return out

    ones = dict(dtype=cfg.param_dtype, device=dev)
    layers: Params = {
        'attn': {
            'wq': stack_init((d, h, hd), d),
            'wk': stack_init((d, kv, hd), d),
            'wv': stack_init((d, kv, hd), d),
            'wo': stack_init((h, hd, d), h * hd),
        },
        'ln_attn': {'scale': torch.ones((n_layer, d), **ones)},
        'ln_mlp': {'scale': torch.ones((n_layer, d), **ones)},
    }
    if cfg.is_moe:
        e = cfg.num_experts
        # The router stays in cfg.param_dtype, like the norm scales: the
        # block routes in fp32 and it is d x E a layer.
        layers['moe'] = {
            'router': stack_init((d, e), d, dtype=cfg.param_dtype),
            'wi_gate': stack_init((e, d, f), d),
            'wi_up': stack_init((e, d, f), d),
            'wo': stack_init((e, f, d), f),
        }
    else:
        layers['mlp'] = {
            'wi_gate': stack_init((d, f), d),
            'wi_up': stack_init((d, f), d),
            'wo': stack_init((f, d), f),
        }
    embed = torch.empty((v, d), dtype=torch.float32, device=dev)
    embed.normal_(0.0, 1.0, generator=gen)
    params: Params = {
        'embed': {'embedding': (embed * 0.02).to(wdt)},
        'layers': layers,
        'final_norm': {'scale': torch.ones((d,), **ones)},
    }
    del embed
    if not cfg.tie_embeddings:
        params['lm_head'] = {'w': dense((d, v), d)}
    return params


def param_logical_axes(cfg: ModelConfig) -> Params:
    """Dict mirroring ``init_params``, leaves = tuples of logical axis
    names (``parallel/sharding.py`` maps them to mesh axes)."""
    layers: Params = {
        'attn': {
            'wq': ('layers', 'embed', 'heads', 'head_dim'),
            'wk': ('layers', 'embed', 'kv_heads', 'head_dim'),
            'wv': ('layers', 'embed', 'kv_heads', 'head_dim'),
            'wo': ('layers', 'heads', 'head_dim', 'embed'),
        },
        'ln_attn': {'scale': ('layers', 'norm')},
        'ln_mlp': {'scale': ('layers', 'norm')},
    }
    if cfg.is_moe:
        layers['moe'] = {
            'router': ('layers', 'embed', None),
            'wi_gate': ('layers', 'expert', 'embed', 'mlp'),
            'wi_up': ('layers', 'expert', 'embed', 'mlp'),
            'wo': ('layers', 'expert', 'mlp', 'embed'),
        }
    else:
        layers['mlp'] = {
            'wi_gate': ('layers', 'embed', 'mlp'),
            'wi_up': ('layers', 'embed', 'mlp'),
            'wo': ('layers', 'mlp', 'embed'),
        }
    axes: Params = {
        'embed': {'embedding': ('vocab', 'embed')},
        'layers': layers,
        'final_norm': {'scale': ('norm',)},
    }
    if not cfg.tie_embeddings:
        axes['lm_head'] = {'w': ('embed', 'vocab')}
    return axes


# ---------------------------------------------------------------------------
# Vocab projection with an fp32 result
# ---------------------------------------------------------------------------

def _mm_fp32_out(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with an fp32 result, like the reference's
    ``preferred_element_type``: the fp32 accumulator is never rounded to
    the operands' type."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    # The CPU has no low-precision GEMM with an fp32 output; products
    # of bf16 values are exact in fp32, so upcast.
    return a.float() @ b.float()


class _Fp32Logits(torch.autograd.Function):
    """rows [N, d] @ head [d, V] in the compute dtype with an fp32
    result. The backward rounds the fp32 logit gradient to the compute
    dtype and runs both products there."""

    @staticmethod
    def forward(ctx, rows, head):
        ctx.save_for_backward(rows, head)
        return _mm_fp32_out(rows, head)

    @staticmethod
    def backward(ctx, grad):
        rows, head = ctx.saved_tensors
        g = grad.to(rows.dtype)
        return g @ head.t(), rows.t() @ g


def fp32_logits(x: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """x [..., d] @ head [d, V] (both in the compute dtype) -> fp32
    logits [..., V]."""
    rows = x.reshape(-1, x.shape[-1])
    return _Fp32Logits.apply(rows, head).reshape(*x.shape[:-1], -1)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

# The reference's ``checkpoint_name`` tags (its llama.py:191-233): the
# tensor computed inside ``_named(name)`` is the one the selective remat
# policies may save. The weight casts run before the context, so the
# only product or sum inside it (``_TAGGED_OPS``) makes that tensor;
# einsum's reshapes around it are not saved.
_tag = threading.local()
_TAGGED_OPS = (torch.ops.aten.bmm.default, torch.ops.aten.mm.default,
               torch.ops.aten.mul.Tensor, torch.ops.aten.add.Tensor)


@contextlib.contextmanager
def _named(name: Optional[str]):
    before = getattr(_tag, 'name', None)
    _tag.name = name
    try:
        yield
    finally:
        _tag.name = before


def _attention_block(x: torch.Tensor, lp: Params, cfg: ModelConfig,
                     sin: torch.Tensor, cos: torch.Tensor,
                     segments: Optional[torch.Tensor] = None,
                     lora_params: Optional[Params] = None
                     ) -> torch.Tensor:
    dt = cfg.compute_dtype
    wq, wk, wv, wo = (lp[n].to(dt) for n in ('wq', 'wk', 'wv', 'wo'))
    with _named(None if lora_params is not None else 'query_proj'):
        q = torch.einsum('bsd,dhk->bshk', x, wq)
    with _named('key_proj'):
        k = torch.einsum('bsd,dhk->bshk', x, wk)
    with _named(None if lora_params is not None else 'value_proj'):
        v = torch.einsum('bsd,dhk->bshk', x, wv)
    if lora_params is not None:
        # LoRA deltas on q/v; the base weights stay as they are. The
        # tags go on the sums, as in the reference.
        dq, dv = apply_lora_qv(x, lora_params)
        with _named('query_proj'):
            q = q + dq
        with _named('value_proj'):
            v = v + dv
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    out = multi_head_attention(q, k, v, causal=True, segment_ids=segments,
                               impl=cfg.attention_impl)
    with _named('attn_out'):
        return torch.einsum('bshk,hkd->bsd', out, wo)


def _mlp_block(x: torch.Tensor, lp: Params,
               cfg: ModelConfig) -> torch.Tensor:
    dt = cfg.compute_dtype
    w_gate, w_up, wo = (lp[n].to(dt) for n in ('wi_gate', 'wi_up', 'wo'))
    gate = torch.einsum('bsd,df->bsf', x, w_gate)
    up = torch.einsum('bsd,df->bsf', x, w_up)
    act = _activate(gate, cfg)
    with _named('mlp_hidden'):
        hidden = act * up
    with _named('mlp_out'):
        return torch.einsum('bsf,fd->bsd', hidden, wo)


def _router_aux_loss(router_logits: torch.Tensor, selected: torch.Tensor,
                     e: int) -> torch.Tensor:
    """Switch/GShard load-balancing loss: E * sum_e f_e * P_e, where f_e
    is the fraction of tokens whose TOP-1 expert is e and P_e the mean
    router probability of e; 1 at uniform balance."""
    probs = torch.softmax(router_logits, dim=-1)              # [B,S,E]
    top1 = F.one_hot(selected[..., 0], e).float()
    f = top1.reshape(-1, e).mean(dim=0)
    p = probs.reshape(-1, e).mean(dim=0)
    return e * torch.sum(f * p)


def _route(x: torch.Tensor, router: Any, k_top: int
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """fp32 router logits [.., E], then the top-k (descending, as
    ``lax.top_k``) and the softmax over the k selected logits: (logits,
    weights [.., k], selected [.., k])."""
    logits = torch.einsum('bsd,de->bse', x.float(),
                          router.to(torch.float32))
    top, selected = torch.topk(logits, k_top, dim=-1)
    return logits, torch.softmax(top, dim=-1), selected


def _moe_block_capacity(x: torch.Tensor, lp: Params, cfg: ModelConfig,
                        with_aux: bool = True
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Capacity dispatch (the reference's ``_moe_block_capacity``).

    Tokens route in groups of ``min(S, moe_group_size)`` (one group when
    S does not divide); each expert takes at most C = ceil(int(cf * G *
    k) / E) tokens of a group, claimed k-major (every token's first
    choice before any second choice, tokens in sequence order); an
    assignment past C loses that expert's contribution. Padded rows
    route like real ones, as in the reference. Returns (out, aux), aux
    None without ``with_aux``."""
    dt = cfg.compute_dtype
    b, s, d = x.shape
    e, k_top = cfg.num_experts, cfg.experts_per_token
    group = min(s, cfg.moe_group_size)
    if s % group:
        group = s
    bg = b * (s // group)
    xg = x.reshape(bg, group, d)
    capacity = max(1, -(-int(cfg.capacity_factor * group * k_top) // e))
    logits, weights, selected = _route(xg, lp['router'], k_top)
    aux = _router_aux_loss(logits, selected, e) if with_aux else None
    mask = F.one_hot(selected, e).float()                    # [B',G,k,E]
    mask_km = mask.transpose(1, 2).reshape(bg, k_top * group, e)
    pos = torch.cumsum(mask_km, dim=1) - 1.0                 # [B',kG,E]
    keep = mask_km * (pos < capacity)
    # one_hot(pos, C) with the reference's zero rows for pos outside
    # [0, C) (not-selected entries sit at -1).
    slot = (pos[..., None] == torch.arange(
        capacity, device=x.device, dtype=pos.dtype)).float() * \
        keep[..., None]                                      # [B',kG,E,C]
    slot = slot.reshape(bg, k_top, group, e, capacity).transpose(1, 2)
    combine = torch.einsum('bsk,bskec->bsec', weights, slot)  # [B',G,E,C]
    dispatch = (combine > 0.0).to(dt)
    xe = torch.einsum('bsec,bsd->ebcd', dispatch, xg)        # [E,B',C,d]
    w_gate, w_up, wo = (lp[n].to(dt) for n in ('wi_gate', 'wi_up', 'wo'))
    gate = torch.einsum('ebcd,edf->ebcf', xe, w_gate)
    up = torch.einsum('ebcd,edf->ebcf', xe, w_up)
    act = _activate(gate, cfg)
    with _named('mlp_hidden'):
        hidden = act * up
    out_e = torch.einsum('ebcf,efd->ebcd', hidden, wo)
    combine = combine.to(dt)
    with _named('mlp_out'):
        y = torch.einsum('bsec,ebcd->bsd', combine, out_e)
    return y.reshape(b, s, d), aux


def _to_experts(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum('bsd,edf->ebsf', x, w) as one ``bmm`` whose x operand is
    broadcast over the experts (batch stride 0). ``torch.einsum`` would
    copy the permuted weight first: a second pass over every expert
    weight in every decode step."""
    b, s, d = x.shape
    out = torch.matmul(x.reshape(1, b * s, d), w)           # [E,BS,f]
    return out.reshape(w.shape[0], b, s, w.shape[-1])


def _moe_block(x: torch.Tensor, lp: Params, cfg: ModelConfig,
               with_aux: bool = True
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Top-k MoE (the reference's ``_moe_block``): dense dispatch runs
    every expert on every token and combines the outputs with the
    one-hot weights; ``cfg.moe_dispatch == 'capacity'`` takes
    ``_moe_block_capacity``. A ``QTensor`` expert dequantizes through
    ``.to(dt)``, as the reference's ``astype``. Returns (out, aux);
    serving passes ``with_aux=False`` (aux None), where the reference's
    jit drops the unused aux."""
    if cfg.moe_dispatch == 'capacity':
        return _moe_block_capacity(x, lp, cfg, with_aux)
    dt = cfg.compute_dtype
    e, k_top = cfg.num_experts, cfg.experts_per_token
    logits, weights, selected = _route(x, lp['router'], k_top)
    aux = _router_aux_loss(logits, selected, e) if with_aux else None
    # sum_k one_hot(selected_k) * weight_k: the k experts are distinct.
    combine = torch.zeros_like(logits).scatter_(-1, selected,
                                                weights)     # [B,S,E]
    w_gate, w_up, wo = (lp[n].to(dt) for n in ('wi_gate', 'wi_up', 'wo'))
    gate = _to_experts(x, w_gate)
    up = _to_experts(x, w_up)
    act = _activate(gate, cfg)
    with _named('mlp_hidden'):
        hidden = act * up
    expert_out = torch.einsum('ebsf,efd->ebsd', hidden, wo)
    combine = combine.to(dt)
    with _named('mlp_out'):
        out = torch.einsum('ebsd,bse->bsd', expert_out, combine)
    return out, aux


def _decoder_layer(x: torch.Tensor, lp: Params, cfg: ModelConfig,
                   sin: torch.Tensor, cos: torch.Tensor,
                   segments: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decoder layer: (x, router aux loss), the aux 0 for a dense
    MLP."""
    h = rms_norm(x, lp['ln_attn']['scale'], cfg.norm_eps)
    x = x + _attention_block(h, lp['attn'], cfg, sin, cos,
                             segments=segments,
                             lora_params=lp.get('lora'))
    h = rms_norm(x, lp['ln_mlp']['scale'], cfg.norm_eps)
    if cfg.is_moe:
        out, aux = _moe_block(h, lp['moe'], cfg)
        return x + out, aux
    return (x + _mlp_block(h, lp['mlp'], cfg),
            torch.zeros((), dtype=torch.float32, device=x.device))


_ATTN_NAMES = ('query_proj', 'key_proj', 'value_proj', 'attn_out')
SAVED_NAMES = {'save_attn': frozenset(_ATTN_NAMES),
               'save_dots': frozenset(_ATTN_NAMES +
                                      ('mlp_hidden', 'mlp_out'))}


def _save_only_these_names(names: frozenset) -> Callable[..., Any]:
    """jax.checkpoint_policies.save_only_these_names as a selective
    checkpoint policy: the product or sum run inside ``_named(n)`` for
    ``n`` in ``names`` is saved, every other op is recomputed."""
    def policy(ctx, func, *args, **kwargs):
        del ctx, args, kwargs
        if func in _TAGGED_OPS and getattr(_tag, 'name', None) in names:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE
    return policy


def _dots_with_no_batch_dims(ctx, func, *args, **kwargs):
    """jax.checkpoint_policies.checkpoint_dots_with_no_batch_dims: save
    every matrix product without batch dims. ``torch.einsum`` lowers
    the layer's weight products ('bsd,dhk->bshk' and the like) to a
    ``bmm`` with a batch of one, and the attention products with batch
    and heads to a ``bmm`` over B x H. The MoE block's products of the
    tokens with every expert (``_to_experts``) are a ``bmm`` whose
    token operand is broadcast (batch stride 0): no batch dims either,
    as the reference's 'bsd,edf->ebsf'."""
    del ctx, kwargs
    if func is torch.ops.aten.mm.default or (
            func is torch.ops.aten.bmm.default and
            (args[0].shape[0] == 1 or args[0].stride(0) == 0)):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_policy(cfg: ModelConfig) -> Optional[Callable[..., Any]]:
    """How each layer is rematerialized in the backward: None (keep
    every activation), ``torch.utils.checkpoint`` alone (full), or a
    selective checkpoint policy. Flash forwards a layer runs in one
    train step, with one dq and one dk/dv launch:

    * ``none``: keep every activation; 1 forward.
    * ``full``: save only the layer input and re-run the layer; 2.
    * ``save_attn``: save ``query_proj``, ``key_proj``, ``value_proj``
      and ``attn_out`` (the output after ``wo``); the norms, RoPE, the
      attention and the MLP are recomputed; 2 (``wo``'s gradient and
      the flash backward need the flash output, which no name saves,
      as in the reference).
    * ``save_dots``: those and ``mlp_hidden``, ``mlp_out``; 2.
    * ``dots``: every weight product (``_dots_with_no_batch_dims``);
      2, for the same reason.

    The flash kernels are a ctypes launch inside an autograd Function,
    which a selective policy never sees, so they always re-run under
    remat, like the reference's Pallas calls."""
    if cfg.remat_policy == 'none':
        return None
    if cfg.remat_policy == 'full':
        return functools.partial(torch.utils.checkpoint.checkpoint,
                                 use_reentrant=False)
    if cfg.remat_policy == 'dots':
        policy = _dots_with_no_batch_dims
    elif cfg.remat_policy in SAVED_NAMES:
        policy = _save_only_these_names(SAVED_NAMES[cfg.remat_policy])
    else:
        raise ValueError(f'Unknown remat policy {cfg.remat_policy!r}')
    return functools.partial(
        torch.utils.checkpoint.checkpoint, use_reentrant=False,
        context_fn=functools.partial(create_selective_checkpoint_contexts,
                                     policy))


def _unstack(layers: Params, n_layers: int) -> List[Params]:
    """The stacked ``[L, ...]`` weights as L per-layer dicts of views.
    One ``unbind`` per leaf, so the backward writes each stacked
    gradient once instead of once per layer."""
    out: List[Params] = [{} for _ in range(n_layers)]

    def walk(node, dests):
        for key, value in node.items():
            if isinstance(value, dict):
                subs = [d.setdefault(key, {}) for d in dests]
                walk(value, subs)
            else:
                # ``unbind`` of a tensor, or of a W8A8 ``QTensor``.
                for d, piece in zip(dests, value.unbind(0)):
                    d[key] = piece

    walk(layers, out)
    return out


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig, *,
            positions: Optional[torch.Tensor] = None,
            segments: Optional[torch.Tensor] = None,
            pipeline_stages: int = 1,
            return_aux: bool = False,
            return_hidden: bool = False) -> torch.Tensor:
    """tokens [B, S] int -> logits [B, S, vocab] fp32 (or, with
    ``return_hidden``, the final normed hidden states [B, S, d_model]).

    LoRA params at ``params['layers']['lora']`` add their q/v deltas.
    ``return_aux``: also return the layer mean of the router aux loss
    (0 for a dense model) as (logits, aux). ``pipeline_stages > 1``
    raises with a pointer to ROADMAP.md."""
    if pipeline_stages > 1:
        raise NotImplementedError(
            'pipeline stages are multi-device work, not ported yet '
            '(ROADMAP.md, queue A item 15)')
    _, s = tokens.shape
    dt = cfg.compute_dtype
    if positions is None:
        positions = torch.arange(s, device=tokens.device)
    sin, cos = rope_table_for(cfg, positions)
    x = params['embed']['embedding'][tokens.long()].to(dt)
    remat = _remat_policy(cfg)
    aux = []
    for lp in _unstack(params['layers'], cfg.n_layers):
        if remat is not None:
            x, layer_aux = remat(_decoder_layer, x, lp, cfg, sin, cos,
                                 segments)
        else:
            x, layer_aux = _decoder_layer(x, lp, cfg, sin, cos, segments)
        aux.append(layer_aux)
    x = rms_norm(x, params['final_norm']['scale'], cfg.norm_eps)
    if return_hidden:
        return x
    if cfg.tie_embeddings:
        head = params['embed']['embedding'].to(dt).t()
    else:
        head = params['lm_head']['w'].to(dt)
    logits = fp32_logits(x, head)
    if return_aux:
        return logits, torch.stack(aux).mean()
    return logits
