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

Under a training mesh (``parallel``: this rank's ``TensorParallel``,
from ``train/step.py``) the params are this rank's shards under
``parallel/sharding.DEFAULT_RULES`` and the tokens its rows of the
batch: each layer gathers its weights whole along ``embed`` over
``fsdp`` (``gather_fsdp``, in the compute dtype), runs ``wq``/``wk``/
``wv``/``wi_*`` column-parallel and ``wo``/``mlp.wo`` row-parallel over
``tensor`` (Megatron's conjugate pair), looks the tokens up in its
vocab rows and sums over ``tensor``, and returns its vocab columns of
the logits: the loss combines them over ``tensor`` (a vocab-parallel
cross entropy, ``train/loss.py``) instead of gathering [B, S, V]. Under
``seq`` the tokens (and positions and segments) are the rank's block of
the columns: the default positions start at its block's first column,
attention runs over the ``seq`` group (``ops/ring_attention.py``) and
everything else is per token, except capacity dispatch's claim of
expert slots, which runs over groups of the global sequence
(``_moe_block_capacity``). A MoE layer holds its block of the
experts over ``expert`` and of each expert's FFN columns over
``tensor``, routes every token whole and sums its experts' outputs over
both axes (``_moe_block``); the router aux loss is the whole batch's
(``_router_aux``). The
context is an argument, not ambient state: a remat recompute runs in
the autograd thread and re-issues the layer's collectives in the same
order on every rank.
LoRA layers on a mesh raise here: the reference trains LoRA unsharded.
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
from skypilot_tpu_torch.parallel import pipeline
from skypilot_tpu_torch.parallel.sharding import (TensorParallel,
                                                  copy_to_experts,
                                                  copy_to_tensor,
                                                  gather_fsdp,
                                                  reduce_from_experts,
                                                  reduce_from_tensor,
                                                  reduce_from_tokens)
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
                weight_dtype: Optional[torch.dtype] = None,
                leaf: Optional[Callable[[Tuple[str, ...], torch.Tensor],
                                        Any]] = None) -> Params:
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

    ``leaf(path, tensor)``, when given, takes each leaf as soon as it is
    drawn (``path`` its keys, e.g. ``('layers', 'moe', 'wo')``) and its
    result goes into the tree in the leaf's place, so the whole leaf
    can be freed before the next one is drawn; the draws are the same
    with it or without (a tensor-parallel rank builds its shard this
    way: ``inference/sharding.init_shard``).
    """
    dev = resolve_device(device)
    keep = leaf or (lambda path, x: x)
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

    def stack_init(path, shape, in_size, dtype=None) -> Any:
        out = torch.empty((n_layer,) + shape, dtype=dtype or wdt,
                          device=dev)
        for i in range(n_layer):
            out[i] = dense(shape, in_size)
        return keep(('layers',) + path, out)

    def ones(path, shape) -> Any:
        return keep(path, torch.ones(shape, dtype=cfg.param_dtype,
                                     device=dev))

    layers: Params = {
        'attn': {
            'wq': stack_init(('attn', 'wq'), (d, h, hd), d),
            'wk': stack_init(('attn', 'wk'), (d, kv, hd), d),
            'wv': stack_init(('attn', 'wv'), (d, kv, hd), d),
            'wo': stack_init(('attn', 'wo'), (h, hd, d), h * hd),
        },
        'ln_attn': {'scale': ones(('layers', 'ln_attn', 'scale'),
                                  (n_layer, d))},
        'ln_mlp': {'scale': ones(('layers', 'ln_mlp', 'scale'),
                                 (n_layer, d))},
    }
    if cfg.is_moe:
        e = cfg.num_experts
        # The router stays in cfg.param_dtype, like the norm scales: the
        # block routes in fp32 and it is d x E a layer.
        layers['moe'] = {
            'router': stack_init(('moe', 'router'), (d, e), d,
                                 dtype=cfg.param_dtype),
            'wi_gate': stack_init(('moe', 'wi_gate'), (e, d, f), d),
            'wi_up': stack_init(('moe', 'wi_up'), (e, d, f), d),
            'wo': stack_init(('moe', 'wo'), (e, f, d), f),
        }
    else:
        layers['mlp'] = {
            'wi_gate': stack_init(('mlp', 'wi_gate'), (d, f), d),
            'wi_up': stack_init(('mlp', 'wi_up'), (d, f), d),
            'wo': stack_init(('mlp', 'wo'), (f, d), f),
        }
    embed = torch.empty((v, d), dtype=torch.float32, device=dev)
    embed.normal_(0.0, 1.0, generator=gen)
    embed = keep(('embed', 'embedding'), (embed * 0.02).to(wdt))
    params: Params = {
        'embed': {'embedding': embed},
        'layers': layers,
        'final_norm': {'scale': ones(('final_norm', 'scale'), (d,))},
    }
    if not cfg.tie_embeddings:
        params['lm_head'] = {'w': keep(('lm_head', 'w'), dense((d, v), d))}
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


def param_shapes(cfg: ModelConfig) -> Params:
    """Every param's full shape (``init_params``'s), as a tree of
    meta tensors."""
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    h, kv, hd, n = (cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
                    cfg.n_layers)
    shapes = {
        'attn': {'wq': (n, d, h, hd), 'wk': (n, d, kv, hd),
                 'wv': (n, d, kv, hd), 'wo': (n, h, hd, d)},
        'ln_attn': {'scale': (n, d)}, 'ln_mlp': {'scale': (n, d)},
    }
    if cfg.is_moe:
        e = cfg.num_experts
        shapes['moe'] = {'router': (n, d, e), 'wi_gate': (n, e, d, f),
                         'wi_up': (n, e, d, f), 'wo': (n, e, f, d)}
    else:
        shapes['mlp'] = {'wi_gate': (n, d, f), 'wi_up': (n, d, f),
                         'wo': (n, f, d)}
    tree = {'embed': {'embedding': (v, d)}, 'layers': shapes,
            'final_norm': {'scale': (d,)}}
    if not cfg.tie_embeddings:
        tree['lm_head'] = {'w': (d, v)}

    def meta(node):
        if isinstance(node, dict):
            return {k: meta(x) for k, x in node.items()}
        return torch.empty(node, dtype=cfg.param_dtype, device='meta')
    return meta(tree)


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


# One device: every degree 1, so each helper below is the plain op.
_ONE_DEVICE = TensorParallel()


def _attention_block(x: torch.Tensor, lp: Params, cfg: ModelConfig,
                     sin: torch.Tensor, cos: torch.Tensor,
                     segments: Optional[torch.Tensor] = None,
                     lora_params: Optional[Params] = None,
                     par: TensorParallel = _ONE_DEVICE) -> torch.Tensor:
    dt = cfg.compute_dtype
    wq, wk, wv = (gather_fsdp(lp[n], par, 0, dt) for n in ('wq', 'wk', 'wv'))
    wo = gather_fsdp(lp['wo'], par, 2, dt)
    x = copy_to_tensor(x, par)
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
                               impl=cfg.attention_impl, parallel=par)
    with _named('attn_out'):
        out = torch.einsum('bshk,hkd->bsd', out, wo)
    return reduce_from_tensor(out, par)


def _mlp_block(x: torch.Tensor, lp: Params, cfg: ModelConfig,
               par: TensorParallel = _ONE_DEVICE) -> torch.Tensor:
    dt = cfg.compute_dtype
    w_gate, w_up = (gather_fsdp(lp[n], par, 0, dt)
                    for n in ('wi_gate', 'wi_up'))
    wo = gather_fsdp(lp['wo'], par, 1, dt)
    x = copy_to_tensor(x, par)
    gate = torch.einsum('bsd,df->bsf', x, w_gate)
    up = torch.einsum('bsd,df->bsf', x, w_up)
    act = _activate(gate, cfg)
    with _named('mlp_hidden'):
        hidden = act * up
    with _named('mlp_out'):
        out = torch.einsum('bsf,fd->bsd', hidden, wo)
    return reduce_from_tensor(out, par)


def _router_stats(router_logits: torch.Tensor, selected: torch.Tensor,
                  e: int) -> torch.Tensor:
    """[2E]: f_e, the fraction of tokens whose TOP-1 expert is e (no
    gradient), then P_e, the mean router probability of e."""
    probs = torch.softmax(router_logits, dim=-1)              # [B,S,E]
    top1 = F.one_hot(selected[..., 0], e).float()
    return torch.cat([top1.reshape(-1, e).mean(dim=0),
                      probs.reshape(-1, e).mean(dim=0)])


def _aux_of(stats: torch.Tensor) -> torch.Tensor:
    """E * sum_e f_e * P_e of ``_router_stats`` [..., 2E]: [...]."""
    f, p = stats.chunk(2, dim=-1)
    return f.shape[-1] * torch.sum(f * p, dim=-1)


def _router_aux_loss(router_logits: torch.Tensor, selected: torch.Tensor,
                     e: int) -> torch.Tensor:
    """Switch/GShard load-balancing loss: E * sum_e f_e * P_e, where f_e
    is the fraction of tokens whose TOP-1 expert is e and P_e the mean
    router probability of e; 1 at uniform balance."""
    return _aux_of(_router_stats(router_logits, selected, e))


def _router_aux(stats: torch.Tensor, par: TensorParallel) -> torch.Tensor:
    """The layer mean of the aux loss from the layers' ``_router_stats``
    [L, 2E] of this rank's tokens. f and P are means over the WHOLE
    batch, as in the reference, where they are global means under GSPMD:
    each is averaged over the batch ranks (one sum over ``tokens`` for
    every layer, each rank's share of the batch equal) before the
    product, never the ranks' products averaged."""
    if par.tokens > 1:
        stats = reduce_from_tokens(stats, par) / par.tokens
    return _aux_of(stats).mean()


def _route(x: torch.Tensor, router: Any, k_top: int
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """fp32 router logits [.., E], then the top-k (descending, as
    ``lax.top_k``) and the softmax over the k selected logits: (logits,
    weights [.., k], selected [.., k])."""
    logits = torch.einsum('bsd,de->bse', x.float(),
                          router.to(torch.float32))
    top, selected = torch.topk(logits, k_top, dim=-1)
    return logits, torch.softmax(top, dim=-1), selected


def _capacity_groups(s: int, cfg: ModelConfig, par: TensorParallel
                     ) -> Tuple[int, int]:
    """(group, capacity) of capacity dispatch over the GLOBAL sequence,
    this rank's ``s`` columns times ``seq``, as the reference forms them
    under GSPMD: groups of ``min(S, moe_group_size)`` columns (one group
    when S does not divide) and C = ceil(int(cf * G * k) / E) slots of
    each expert a group."""
    total = s * par.seq
    group = min(total, cfg.moe_group_size)
    if total % group:
        group = total
    k_top, e = cfg.experts_per_token, cfg.num_experts
    return group, max(1, -(-int(cfg.capacity_factor * group * k_top) // e))


def _seq_window(s: int, group: int, par: TensorParallel
                ) -> Tuple[int, int, int]:
    """The groups that hold this rank's ``s`` columns of the global
    sequence: (the first group's index, how many, the offset of the
    rank's first column in the first group)."""
    lo = par.seq_rank * s
    first = lo // group
    return first, (lo + s - 1) // group - first + 1, lo - first * group


def _slots(selected: torch.Tensor, e: int, capacity: int) -> torch.Tensor:
    """The reference's slot claim of groups ``selected`` [B', G, k] (each
    token's top-k experts): [B', G, k, E, C], one where a token's choice
    holds slot c of expert e. Claimed k-major (every token's first
    choice before any second choice, tokens in sequence order); a
    choice past C holds none."""
    bg, group, k_top = selected.shape
    mask = F.one_hot(selected, e).float()                    # [B',G,k,E]
    mask_km = mask.transpose(1, 2).reshape(bg, k_top * group, e)
    pos = torch.cumsum(mask_km, dim=1) - 1.0                 # [B',kG,E]
    keep = mask_km * (pos < capacity)
    # one_hot(pos, C) with the reference's zero rows for pos outside
    # [0, C) (not-selected entries sit at -1).
    slot = (pos[..., None] == torch.arange(
        capacity, device=selected.device, dtype=pos.dtype)).float() * \
        keep[..., None]                                      # [B',kG,E,C]
    return slot.reshape(bg, k_top, group, e, capacity).transpose(1, 2)


def _moe_block_capacity(x: torch.Tensor, lp: Params, cfg: ModelConfig,
                        with_aux: bool = True,
                        reduce: Optional[Callable[..., torch.Tensor]] = None,
                        par: Optional[TensorParallel] = None
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Capacity dispatch (the reference's ``_moe_block_capacity``).

    Tokens route in groups (``_capacity_groups``); each expert takes at
    most C tokens of a group, claimed as ``_slots`` says; an assignment
    past C loses that expert's contribution. Padded rows route like
    real ones, as in the reference. Returns (out, aux), aux None without
    ``with_aux``; ``reduce`` and ``par`` as in ``_moe_block``.

    Under ``seq`` the groups span the global sequence. Where each lies
    inside this rank's columns, the block runs as on one device. Where
    one crosses a rank boundary, a token's slot depends on the choices
    of tokens on other ranks: the block gathers every rank's top-k
    choices ([B, s, k] integers, no gradient) over ``seq``, claims the
    slots of its groups whole, and runs its own tokens through them,
    placed at their columns of those groups with zero rows (and zero
    routing weights) at the other ranks' columns. The slots that other
    ranks' tokens hold stay empty here and no output leaves the rank."""
    dt = cfg.compute_dtype
    b, s, d = x.shape
    e, k_top = cfg.num_experts, cfg.experts_per_token
    mesh = par or _ONE_DEVICE
    group, capacity = _capacity_groups(s, cfg, mesh)
    logits, weights, selected = _route(
        x, gather_fsdp(lp['router'], mesh, 0, torch.float32), k_top)
    aux = _aux_stats(logits, selected, e, par) if with_aux else None
    weights = copy_to_experts(weights, mesh)
    xe = copy_to_experts(x, mesh)
    if s % group == 0:
        offset, width = 0, s
    else:
        first, count, offset = _seq_window(s, group, mesh)
        width = count * group
        columns = slice(first * group, first * group + width)
        selected = mesh.all_gather(selected, 1, 'seq')[:, columns]
        pad = (0, 0, offset, width - offset - s)
        weights, xe = F.pad(weights, pad), F.pad(xe, pad)
    bg = b * (width // group)
    slot = _slots(selected.reshape(bg, group, k_top), e, capacity)
    e0, e1 = _local_experts(e, mesh)
    combine = torch.einsum('bsk,bskec->bsec',
                           weights.reshape(bg, group, k_top),
                           slot[:, :, :, e0:e1])             # [B',G,El,C]
    dispatch = (combine > 0.0).to(dt)
    xe = torch.einsum('bsec,bsd->ebcd', dispatch,
                      xe.reshape(bg, group, d))              # [El,B',C,d]
    w_gate, w_up, wo = _expert_weights(lp, mesh, dt)
    gate = torch.einsum('ebcd,edf->ebcf', xe, w_gate)
    up = torch.einsum('ebcd,edf->ebcf', xe, w_up)
    act = _activate(gate, cfg)
    with _named('mlp_hidden'):
        hidden = act * up
    out_e = torch.einsum('ebcf,efd->ebcd', hidden, wo)
    if reduce is not None or mesh.experts > 1:
        with _named('mlp_out'):
            y = torch.einsum('bsec,ebcd->bsd', combine, out_e.float())
        y = (reduce(y, 'sum') if reduce is not None
             else reduce_from_experts(y, mesh)).to(dt)
    else:
        combine = combine.to(dt)
        with _named('mlp_out'):
            y = torch.einsum('bsec,ebcd->bsd', combine, out_e)
    return y.reshape(b, width, d)[:, offset:offset + s], aux


def _aux_stats(logits: torch.Tensor, selected: torch.Tensor, e: int,
               par: Optional[TensorParallel]) -> torch.Tensor:
    """The block's aux: the loss itself off a mesh (``par`` None), its
    ``_router_stats`` [2E] on one (``forward`` averages them over the
    batch ranks: ``_router_aux``)."""
    if par is None:
        return _router_aux_loss(logits, selected, e)
    return _router_stats(logits, selected, e)


def _local_experts(e: int, par: TensorParallel) -> Tuple[int, int]:
    """This rank's experts [e0, e1): its block of ``expert`` (the rule
    'expert')."""
    size = e // par.expert
    return par.expert_rank * size, (par.expert_rank + 1) * size


def _expert_weights(lp: Params, par: TensorParallel, dt: torch.dtype
                    ) -> Tuple[Any, Any, Any]:
    """``wi_gate``, ``wi_up`` [El, d, f/tensor] and ``wo`` [El, f/tensor,
    d] of this rank's experts in ``dt``, gathered whole along ``embed``
    over ``fsdp`` (a W8A8 ``QTensor`` off a mesh dequantizes through
    ``.to(dt)``, as the reference's ``astype``)."""
    return (gather_fsdp(lp['wi_gate'], par, 1, dt),
            gather_fsdp(lp['wi_up'], par, 1, dt),
            gather_fsdp(lp['wo'], par, 2, dt))


def _to_experts(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum('bsd,edf->ebsf', x, w) as one ``bmm`` whose x operand is
    broadcast over the experts (batch stride 0). ``torch.einsum`` would
    copy the permuted weight first: a second pass over every expert
    weight in every decode step."""
    b, s, d = x.shape
    out = torch.matmul(x.reshape(1, b * s, d), w)           # [E,BS,f]
    return out.reshape(w.shape[0], b, s, w.shape[-1])


def _moe_block(x: torch.Tensor, lp: Params, cfg: ModelConfig,
               with_aux: bool = True,
               reduce: Optional[Callable[..., torch.Tensor]] = None,
               par: Optional[TensorParallel] = None
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Top-k MoE (the reference's ``_moe_block``): dense dispatch runs
    every expert on every token and combines the outputs with the
    one-hot weights; ``cfg.moe_dispatch == 'capacity'`` takes
    ``_moe_block_capacity``. A ``QTensor`` expert dequantizes through
    ``.to(dt)``, as the reference's ``astype``. Returns (out, aux);
    serving passes ``with_aux=False`` (aux None), where the reference's
    jit drops the unused aux.

    ``reduce`` (tensor-parallel serving, as ``quant.weight_einsum``
    takes it): the expert leaves hold this rank's ``f / tensor`` columns
    of every expert, so each expert's output is a partial sum. The
    partials are combined in fp32 and summed over the ranks once, after
    the combine, and rounded to the compute dtype once: one all-reduce
    of ``[B, S, d]`` a block, as the dense ``mlp.wo``. The router and the
    dispatch run whole on every rank, on the same ``x``.

    ``par`` (a training mesh, ``forward(parallel=)``): the leaves are
    this rank's blocks, its experts ``[e0, e1)`` over ``expert`` and its
    FFN columns over ``tensor``, each an ``fsdp`` block along ``embed``.
    The router is gathered whole and routes every token in fp32; the
    block keeps its experts' part of the combine and sums the combined
    output over ``experts`` in fp32 in one all-reduce (the g op). The
    f op (identity forward, all-reduce backward over ``experts``) sits
    on the expert branch's input and on the top-k routing weights, whose
    gradients each rank holds only its experts' part of; the router's
    own path into ``x`` and its gradient are whole on every rank. The
    aux is this rank's ``_router_stats``."""
    if cfg.moe_dispatch == 'capacity':
        return _moe_block_capacity(x, lp, cfg, with_aux, reduce, par)
    dt = cfg.compute_dtype
    e, k_top = cfg.num_experts, cfg.experts_per_token
    mesh = par or _ONE_DEVICE
    logits, weights, selected = _route(
        x, gather_fsdp(lp['router'], mesh, 0, torch.float32), k_top)
    aux = _aux_stats(logits, selected, e, par) if with_aux else None
    # sum_k one_hot(selected_k) * weight_k: the k experts are distinct.
    e0, e1 = _local_experts(e, mesh)
    combine = torch.zeros_like(logits).scatter(
        -1, selected, copy_to_experts(weights, mesh))[..., e0:e1]
    w_gate, w_up, wo = _expert_weights(lp, mesh, dt)
    xe = copy_to_experts(x, mesh)
    gate = _to_experts(xe, w_gate)
    up = _to_experts(xe, w_up)
    act = _activate(gate, cfg)
    with _named('mlp_hidden'):
        hidden = act * up
    expert_out = torch.einsum('ebsf,efd->ebsd', hidden, wo)
    if reduce is not None or mesh.experts > 1:
        with _named('mlp_out'):
            out = torch.einsum('ebsd,bse->bsd', expert_out.float(), combine)
        return (reduce(out, 'sum') if reduce is not None
                else reduce_from_experts(out, mesh)).to(dt), aux
    combine = combine.to(dt)
    with _named('mlp_out'):
        out = torch.einsum('ebsd,bse->bsd', expert_out, combine)
    return out, aux


def _decoder_layer(x: torch.Tensor, lp: Params, cfg: ModelConfig,
                   sin: torch.Tensor, cos: torch.Tensor,
                   segments: Optional[torch.Tensor] = None,
                   par: TensorParallel = _ONE_DEVICE
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decoder layer: (x, the MoE block's ``_router_stats`` [2E] of
    these tokens; a 0 for a dense MLP)."""
    h = rms_norm(x, lp['ln_attn']['scale'], cfg.norm_eps)
    x = x + _attention_block(h, lp['attn'], cfg, sin, cos,
                             segments=segments,
                             lora_params=lp.get('lora'), par=par)
    h = rms_norm(x, lp['ln_mlp']['scale'], cfg.norm_eps)
    if cfg.is_moe:
        out, stats = _moe_block(h, lp['moe'], cfg, par=par)
        return x + out, stats
    return (x + _mlp_block(h, lp['mlp'], cfg, par),
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


def _embed(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
           par: TensorParallel) -> torch.Tensor:
    """The token rows of the embedding in the compute dtype. The table
    is gathered over fsdp in its own dtype (its gradient scatters there,
    as on one device); under tensor, this rank holds the vocab rows
    [rank*Vl, (rank+1)*Vl), a token outside them reads zeros, and the
    sum over the tensor group (one nonzero term) is the row itself."""
    table = params['embed']['embedding']
    table = gather_fsdp(table, par, 1, table.dtype)
    if par.degree == 1:
        return table[tokens.long()].to(cfg.compute_dtype)
    local = tokens.long() - par.rank * table.shape[0]
    mine = (local >= 0) & (local < table.shape[0])
    rows = table[torch.where(mine, local, 0)].to(cfg.compute_dtype)
    return reduce_from_tensor(torch.where(mine[..., None], rows, 0.0), par)


# The reference's refusals under pipeline stages (its llama.py:465-490).
PACKED_UNDER_STAGES = (
    'packed-sequence segments are not supported with pipeline_stages > 1 '
    '(segments are closed over at full batch size but stages see '
    'microbatches)')


def _check_pipelined(segments: Optional[torch.Tensor],
                     positions: Optional[torch.Tensor],
                     return_aux: bool) -> None:
    if segments is not None:
        raise ValueError(PACKED_UNDER_STAGES)
    if return_aux:
        raise ValueError(
            'return_aux is not supported with pipeline_stages > 1 (the '
            'stage body carries activations only); set '
            'router_aux_loss_coeff=0 for pipelined MoE training')
    if positions is not None and positions.dim() > 1:
        raise ValueError(
            'per-example positions are not supported with pipeline_stages '
            '> 1 (sin/cos are closed over at full batch size but stages see '
            'microbatches); decode paths with KV caches run unpipelined')


def _final(params: Params, x: torch.Tensor, cfg: ModelConfig,
           par: TensorParallel, return_hidden: bool = False
           ) -> torch.Tensor:
    """The final norm and the LM head: fp32 logits (under ``tensor``,
    this rank's vocab columns), or the normed hidden states."""
    x = rms_norm(x, params['final_norm']['scale'], cfg.norm_eps)
    if return_hidden:
        return x
    dt = cfg.compute_dtype
    if cfg.tie_embeddings:
        head = gather_fsdp(params['embed']['embedding'], par, 1, dt).t()
    else:
        head = gather_fsdp(params['lm_head']['w'], par, 0, dt)
    return fp32_logits(copy_to_tensor(x, par), head)


def _rank_positions(s: int, par: TensorParallel,
                    device: torch.device) -> torch.Tensor:
    """The default positions of this rank's ``s`` columns: under
    ``seq`` its block of the sequence starts at ``seq_rank * s``."""
    return par.seq_rank * s + torch.arange(s, device=device)


def _layer_runner(cfg: ModelConfig, sin: torch.Tensor, cos: torch.Tensor,
                  segments: Optional[torch.Tensor], par: TensorParallel
                  ) -> Callable[[torch.Tensor, Params],
                                Tuple[torch.Tensor, torch.Tensor]]:
    """One decoder layer under the config's remat policy."""
    remat = _remat_policy(cfg)

    def run(x: torch.Tensor, lp: Params):
        if remat is not None:
            return remat(_decoder_layer, x, lp, cfg, sin, cos, segments,
                         par)
        return _decoder_layer(x, lp, cfg, sin, cos, segments, par)

    return run


def _pipeline(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
              last: Callable[[torch.Tensor, slice], Any], *,
              positions: Optional[torch.Tensor],
              segments: Optional[torch.Tensor], return_aux: bool,
              pipeline_stages: int, pipeline_microbatches: Optional[int],
              parallel: Optional[TensorParallel],
              wrt: Optional[List[torch.Tensor]] = None):
    """``parallel/pipeline.pipeline_apply`` of this model: the embedding
    of each microbatch's rows on the first stage, this rank's L/S layers
    on every stage (the remat policy per layer and microbatch, MoE
    layers routing each microbatch's rows), and ``last(y, rows)`` of
    each microbatch's output ``y`` (``rows``: its rows of this rank's
    tokens) on the last stage. M is ``pipeline_microbatches``, else the
    reference's default for the GLOBAL batch (this rank's rows x data x
    fsdp); it must divide this rank's rows. Under ``seq`` a microbatch is
    the rank's block of the columns (RoPE from the block's first column),
    and each layer runs its ring or Ulysses attention over the stage's
    seq ranks; under ``expert`` each MoE layer runs over the stage's
    expert ranks. A stage's ranks run the microbatches in the same
    order, so their collectives line up."""
    _check_pipelined(segments, positions, return_aux)
    par = parallel
    if par is None or par.stage != pipeline_stages:
        raise ValueError(
            f'pipeline_stages={pipeline_stages} runs over the stage ranks '
            'of a training mesh: pass parallel=, this rank\'s place on a '
            f'mesh of stage={pipeline_stages} (got '
            f'{None if par is None else f"stage={par.stage}"})')
    n_local = pipeline.check_layers(cfg.n_layers, pipeline_stages)
    rows, s = tokens.shape
    count = pipeline_microbatches or pipeline.default_num_microbatches(
        rows * par.batch_degree, pipeline_stages)
    size = pipeline.microbatch_rows(rows, count)
    if positions is None:
        positions = _rank_positions(s, par, tokens.device)
    sin, cos = rope_table_for(cfg, positions)
    layer = _layer_runner(cfg, sin, cos, None, par)

    def first(m: int) -> torch.Tensor:
        return _embed(params, tokens[m * size:(m + 1) * size], cfg, par)

    def body(x: torch.Tensor) -> torch.Tensor:
        for lp in _unstack(params['layers'], n_local):
            x, _ = layer(x, lp)
        return x

    return pipeline.pipeline_apply(
        par, count, first, body,
        lambda y, m: last(y, slice(m * size, (m + 1) * size)),
        (size, s, cfg.d_model), cfg.compute_dtype, tokens.device, wrt)


def pipeline_grads(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
                   loss_of: Callable[[torch.Tensor, slice], torch.Tensor],
                   leaves: List[torch.Tensor], *,
                   positions: Optional[torch.Tensor] = None,
                   segments: Optional[torch.Tensor] = None,
                   pipeline_stages: int,
                   pipeline_microbatches: Optional[int] = None,
                   parallel: Optional[TensorParallel] = None
                   ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """The train step's forward and backward under pipeline stages:
    ``loss_of(logits, rows)`` is a microbatch's share of the loss from
    its fp32 logits (this rank's vocab columns under ``tensor``) and its
    rows of this rank's tokens, on the last stage. Returns the losses'
    sum (the last stage's; 0 on the others) and each of ``leaves``'
    gradient of it (``parallel/pipeline.pipeline_apply``: zeros for a
    leaf this stage does not use)."""
    outs, grads = _pipeline(
        params, tokens, cfg,
        lambda y, rows: loss_of(_final(params, y, cfg, parallel), rows),
        positions=positions, segments=segments, return_aux=False,
        pipeline_stages=pipeline_stages,
        pipeline_microbatches=pipeline_microbatches, parallel=parallel,
        wrt=leaves)
    loss = (torch.stack([x.detach() for x in outs]).sum() if outs else
            torch.zeros((), dtype=torch.float32, device=tokens.device))
    return loss, grads


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig, *,
            positions: Optional[torch.Tensor] = None,
            segments: Optional[torch.Tensor] = None,
            pipeline_stages: int = 1,
            pipeline_microbatches: Optional[int] = None,
            return_aux: bool = False,
            return_hidden: bool = False,
            parallel: Optional[TensorParallel] = None) -> torch.Tensor:
    """tokens [B, S] int -> logits [B, S, vocab] fp32 (or, with
    ``return_hidden``, the final normed hidden states [B, S, d_model]).

    LoRA params at ``params['layers']['lora']`` add their q/v deltas.
    ``return_aux``: also return the layer mean of the router aux loss
    (0 for a dense model) as (logits, aux); on a mesh it is the whole
    batch's (``_router_aux``), the same on every rank. ``parallel``:
    this rank's place on a training mesh; params, tokens, positions and
    segments are then its shards and rows (under ``seq``, its block of
    the columns), and the logits its rows and, under ``tensor``, its
    block of the vocab; MoE layers run their experts over ``expert`` and
    ``tensor`` (``_moe_block``) and, under ``seq``, claim capacity over
    the global sequence (``_moe_block_capacity``).

    ``pipeline_stages > 1`` (with ``parallel`` on a mesh of that
    ``stage`` degree; ``pipeline_microbatches`` None for the reference's
    default) runs the GPipe forward (``_pipeline``) and returns the last
    stage's logits on every stage rank (one sum over ``stage``). It
    takes no gradient: the train step runs the pipeline's backward
    schedule (``pipeline_grads``). Packed ``segments``, ``return_aux``
    and per-example (2-D) ``positions`` raise there, as in the
    reference. LoRA layers on a mesh raise: the reference trains LoRA
    unsharded (its ``train/finetune.py`` ignores ``--mesh`` with a LoRA
    rank)."""
    par = parallel or _ONE_DEVICE
    if par is not _ONE_DEVICE and 'lora' in params['layers']:
        raise NotImplementedError(
            'LoRA layers do not train under a mesh: as in the reference, '
            'LoRA runs unsharded and a mesh applies to full finetuning')
    if pipeline_stages > 1:
        return _pipelined_forward(params, tokens, cfg, positions, segments,
                                  pipeline_stages, pipeline_microbatches,
                                  return_aux, return_hidden, parallel)
    _, s = tokens.shape
    if positions is None:
        positions = _rank_positions(s, par, tokens.device)
    sin, cos = rope_table_for(cfg, positions)
    x = _embed(params, tokens, cfg, par)
    layer = _layer_runner(cfg, sin, cos, segments, par)
    aux = []
    for lp in _unstack(params['layers'], cfg.n_layers):
        x, layer_aux = layer(x, lp)
        aux.append(layer_aux)
    out = _final(params, x, cfg, par, return_hidden)
    if return_hidden or not return_aux:
        return out
    aux = torch.stack(aux)
    return out, (_router_aux(aux, par) if cfg.is_moe else aux.mean())


@torch.no_grad()
def _pipelined_forward(params: Params, tokens: torch.Tensor,
                       cfg: ModelConfig, positions, segments,
                       pipeline_stages: int,
                       pipeline_microbatches: Optional[int],
                       return_aux: bool, return_hidden: bool,
                       parallel: Optional[TensorParallel]) -> torch.Tensor:
    """``forward`` under stages: the last stage's outputs of this rank's
    rows, joined and summed over ``stage`` (zeros from the others)."""
    outs, _ = _pipeline(
        params, tokens, cfg,
        lambda y, rows: _final(params, y, cfg, parallel, return_hidden),
        positions=positions, segments=segments, return_aux=return_aux,
        pipeline_stages=pipeline_stages,
        pipeline_microbatches=pipeline_microbatches, parallel=parallel)
    rows, s = tokens.shape
    width = (cfg.d_model if return_hidden
             else cfg.vocab_size // parallel.degree)
    out = (torch.cat(outs) if outs else torch.zeros(
        (rows, s, width), dtype=(cfg.compute_dtype if return_hidden
                                 else torch.float32),
        device=tokens.device))
    return parallel.all_reduce(out, axis='stage')
