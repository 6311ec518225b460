"""Llama-family decoder: the serving subset of ``skypilot_tpu/models/llama.py``.

Params are a plain dict with the JAX package's keys and its stacked
``[L, ...]`` layer layout (``models/convert.py`` carries a JAX pytree
over as is). Here: RoPE tables (with the llama3 NTK scaling), the gated
MLP activation and ``init_params``. ``forward``, remat, MoE blocks and
the training blocks belong to later slices of the port.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from skypilot_tpu_torch.models.config import ModelConfig
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
    on the card. Norm scales stay in ``cfg.param_dtype``. The draws
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

    def stack_init(shape, in_size) -> torch.Tensor:
        out = torch.empty((n_layer,) + shape, dtype=wdt, device=dev)
        for i in range(n_layer):
            out[i] = dense(shape, in_size)
        return out

    if cfg.is_moe:
        raise NotImplementedError(
            'MoE blocks are not ported yet (ROADMAP.md, queue A)')
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
        'mlp': {
            'wi_gate': stack_init((d, f), d),
            'wi_up': stack_init((d, f), d),
            'wo': stack_init((f, d), f),
        },
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
