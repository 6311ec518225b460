"""HuggingFace checkpoint interop: safetensors <-> the port's stacked
params, the port of ``skypilot_tpu/models/hf_interop.py``.

The same names, key mapping, config mapping and rejections as the
reference (Llama/Mistral/Mixtral import; Qwen2, Gemma, projection
biases, sliding-window attention and non-llama3 rope scaling raise).
What differs is where the tensors go:

* The safetensors container is read and written by
  ``utils/safetensors_io.py`` (a private ``mmap``, bf16 without
  ``ml_dtypes``); ``SafetensorsReader`` and ``write_safetensors`` are
  re-exported here under the reference's names.
* ``load_checkpoint`` allocates each stacked ``[L, ...]`` destination
  once, on ``device`` and in the target dtype, and streams the file
  into it one HF tensor at a time: the tensor is copied from its map
  to the device and transposed, reshaped and cast into its slice
  there. Device memory peaks at the params plus one source tensor; the
  reference instead builds the whole tree in host numpy first.

HF stores projections as [out_features, in_features]; the params keep
[in, heads, head_dim]-style layouts, so each weight is transposed and
reshaped on the way in and out. HF's rotate-half rope convention
matches ``models/llama.py:apply_rope``: no head permutation is needed.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from skypilot_tpu_torch.models.config import ModelConfig
from skypilot_tpu_torch.utils.device import resolve_device
from skypilot_tpu_torch.utils.safetensors_io import (  # noqa: F401
    SafetensorsReader, write_safetensors)

Params = Dict[str, Any]


def _iter_checkpoint_files(path: str) -> List[str]:
    """Resolve a checkpoint dir/file to its .safetensors shard list."""
    if os.path.isfile(path):
        return [path]
    index = os.path.join(path, 'model.safetensors.index.json')
    if os.path.exists(index):
        with open(index) as f:
            weight_map = json.load(f)['weight_map']
        return [os.path.join(path, fn) for fn in sorted(set(
            weight_map.values()))]
    single = os.path.join(path, 'model.safetensors')
    if os.path.exists(single):
        return [single]
    shards = sorted(
        os.path.join(path, fn) for fn in os.listdir(path)
        if fn.endswith('.safetensors'))
    if not shards:
        raise FileNotFoundError(f'no .safetensors files under {path}')
    return shards


# ---------------------------------------------------------------------------
# Config mapping
# ---------------------------------------------------------------------------

_SUPPORTED_MODEL_TYPES = ('llama', 'mistral', 'mixtral')


def config_from_hf(hf: Dict[str, Any], *,
                   name: Optional[str] = None) -> ModelConfig:
    """HF config.json dict -> ModelConfig."""
    model_type = hf.get('model_type', 'llama')
    if model_type == 'qwen2':
        # Qwen2 hardcodes q/k/v projection biases (not reflected in its
        # config.json), which the bias-free stacked layout cannot hold.
        raise ValueError(
            "model_type 'qwen2' is not importable: Qwen2 checkpoints "
            'carry QKV biases the stacked pytree has no slot for')
    if model_type == 'gemma':
        # Gemma's (1+weight) RMSNorm and sqrt(d_model) embedding scale
        # differ from the llama forward; importing would produce
        # silently wrong logits.
        raise ValueError(
            "model_type 'gemma' is not importable: its RMSNorm/embed "
            'conventions differ from the llama forward pass')
    if model_type not in _SUPPORTED_MODEL_TYPES:
        raise ValueError(
            f'unsupported HF model_type {model_type!r}; supported: '
            f'{_SUPPORTED_MODEL_TYPES}')
    if hf.get('attention_bias') or hf.get('qkv_bias') or hf.get(
            'mlp_bias'):
        raise ValueError('projection biases are not supported by the '
                         'stacked pytree layout')
    if hf.get('sliding_window') is not None:
        # Mistral-v0.1-style sliding-window attention: the forward pass
        # here attends over the full causal context, which would
        # silently diverge from the published model past the window.
        raise ValueError(
            f"sliding_window={hf['sliding_window']} attention is not "
            'supported; only full-causal-attention checkpoints import '
            '(Mistral v0.2+ exports set sliding_window to null)')
    kwargs: Dict[str, Any] = dict(
        name=name or hf.get('_name_or_path') or model_type,
        vocab_size=hf['vocab_size'],
        d_model=hf['hidden_size'],
        n_layers=hf['num_hidden_layers'],
        n_heads=hf['num_attention_heads'],
        n_kv_heads=hf.get('num_key_value_heads',
                          hf['num_attention_heads']),
        d_ff=hf['intermediate_size'],
        head_dim=hf.get('head_dim'),
        rope_theta=float(hf.get('rope_theta', 10_000.0)),
        norm_eps=float(hf.get('rms_norm_eps', 1e-5)),
        max_seq_len=int(hf.get('max_position_embeddings', 8192)),
        tie_embeddings=bool(hf.get('tie_word_embeddings', False)),
    )
    if model_type == 'mixtral':
        kwargs['num_experts'] = hf['num_local_experts']
        kwargs['experts_per_token'] = hf['num_experts_per_tok']
    scaling = hf.get('rope_scaling')
    if scaling:
        rtype = scaling.get('rope_type', scaling.get('type'))
        if rtype != 'llama3':
            raise ValueError(f'unsupported rope_scaling type {rtype!r} '
                             "(only 'llama3' NTK scaling)")
        kwargs.update(
            rope_scaling_factor=float(scaling['factor']),
            rope_low_freq_factor=float(scaling.get('low_freq_factor', 1.0)),
            rope_high_freq_factor=float(
                scaling.get('high_freq_factor', 4.0)),
            rope_original_max_position=int(
                scaling.get('original_max_position_embeddings', 8192)),
        )
    return ModelConfig(**kwargs)


def config_to_hf(cfg: ModelConfig) -> Dict[str, Any]:
    """ModelConfig -> HF config.json dict (llama/mixtral layout)."""
    hf: Dict[str, Any] = {
        'model_type': 'mixtral' if cfg.is_moe else 'llama',
        'architectures': ['MixtralForCausalLM' if cfg.is_moe
                          else 'LlamaForCausalLM'],
        'vocab_size': cfg.vocab_size,
        'hidden_size': cfg.d_model,
        'num_hidden_layers': cfg.n_layers,
        'num_attention_heads': cfg.n_heads,
        'num_key_value_heads': cfg.n_kv_heads,
        'intermediate_size': cfg.d_ff,
        'head_dim': cfg.resolved_head_dim,
        'rope_theta': cfg.rope_theta,
        'rms_norm_eps': cfg.norm_eps,
        'max_position_embeddings': cfg.max_seq_len,
        'tie_word_embeddings': cfg.tie_embeddings,
        'hidden_act': 'silu',
        'torch_dtype': 'float32',
    }
    if cfg.is_moe:
        hf['num_local_experts'] = cfg.num_experts
        hf['num_experts_per_tok'] = cfg.experts_per_token
    if cfg.rope_scaling:
        factor, low, high, orig = cfg.rope_scaling
        hf['rope_scaling'] = {
            'rope_type': 'llama3', 'factor': factor,
            'low_freq_factor': low, 'high_freq_factor': high,
            'original_max_position_embeddings': orig,
        }
    return hf


def load_config(path: str, *, name: Optional[str] = None,
                **overrides) -> ModelConfig:
    with open(os.path.join(path, 'config.json')) as f:
        cfg = config_from_hf(json.load(f), name=name)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


# ---------------------------------------------------------------------------
# Weight mapping
# ---------------------------------------------------------------------------

def _strip_prefix(key: str) -> str:
    return key[6:] if key.startswith('model.') else key


def _t(x: torch.Tensor) -> torch.Tensor:
    return x.t()


@torch.no_grad()
def load_checkpoint(path: str, *, dtype: Optional[torch.dtype] = None,
                    cfg: Optional[ModelConfig] = None,
                    device: Optional[Union[str, torch.device]] = None,
                    **config_overrides) -> Tuple[Params, ModelConfig]:
    """HF checkpoint dir (config.json + *.safetensors) -> (params, cfg),
    the params on ``device`` (default ``cuda``).

    ``dtype`` overrides the loaded param dtype (e.g. torch.bfloat16 for
    serving: half the resident memory of fp32); by default the params
    load in ``cfg.param_dtype``.
    """
    dev = resolve_device(device)
    if cfg is None:
        cfg = load_config(path, **config_overrides)
    dt = dtype if dtype is not None else cfg.param_dtype
    if dtype is not None:
        cfg = dataclasses.replace(cfg, param_dtype=dtype)

    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    n = cfg.n_layers

    def alloc(*shape):
        # Every element is written below (the completeness check
        # raises otherwise), so the memory is left uninitialized.
        return torch.empty(shape, dtype=dt, device=dev)

    layers: Params = {
        'attn': {'wq': alloc(n, d, h, hd), 'wk': alloc(n, d, kv, hd),
                 'wv': alloc(n, d, kv, hd), 'wo': alloc(n, h, hd, d)},
        'ln_attn': {'scale': alloc(n, d)},
        'ln_mlp': {'scale': alloc(n, d)},
    }
    if cfg.is_moe:
        e = cfg.num_experts
        layers['moe'] = {'router': alloc(n, d, e),
                         'wi_gate': alloc(n, e, d, f),
                         'wi_up': alloc(n, e, d, f),
                         'wo': alloc(n, e, f, d)}
    else:
        layers['mlp'] = {'wi_gate': alloc(n, d, f),
                         'wi_up': alloc(n, d, f),
                         'wo': alloc(n, f, d)}
    params: Params = {
        'embed': {'embedding': alloc(v, d)},
        'layers': layers,
        'final_norm': {'scale': alloc(d)},
    }
    if not cfg.tie_embeddings:
        params['lm_head'] = {'w': alloc(d, v)}

    seen = set()
    SKIP = 'skip'

    def target(key: str):
        """(destination slice, transform of the HF tensor), SKIP, or
        None for a tensor that maps nowhere."""
        key = _strip_prefix(key)
        # Ignorable extras some exports carry (non-weights).
        if key.endswith('rotary_emb.inv_freq'):
            return SKIP
        if key == 'embed_tokens.weight':
            return params['embed']['embedding'], None
        if key == 'norm.weight':
            return params['final_norm']['scale'], None
        if key == 'lm_head.weight':
            if cfg.tie_embeddings:
                return SKIP  # redundant tied head in some exports
            return params['lm_head']['w'], _t
        if not key.startswith('layers.'):
            return None
        parts = key.split('.')
        i = int(parts[1])
        rest = '.'.join(parts[2:])
        at = layers['attn']
        simple = {
            'self_attn.q_proj.weight': (at['wq'], (d, h, hd)),
            'self_attn.k_proj.weight': (at['wk'], (d, kv, hd)),
            'self_attn.v_proj.weight': (at['wv'], (d, kv, hd)),
            'self_attn.o_proj.weight': (at['wo'], (h, hd, d)),
        }
        if rest in simple:
            dest, shape = simple[rest]
            return dest[i], lambda x: x.t().reshape(shape)
        if rest == 'input_layernorm.weight':
            return layers['ln_attn']['scale'][i], None
        if rest == 'post_attention_layernorm.weight':
            return layers['ln_mlp']['scale'][i], None
        mlp = {'mlp.gate_proj.weight': 'wi_gate',
               'mlp.up_proj.weight': 'wi_up',
               'mlp.down_proj.weight': 'wo'}
        if rest in mlp and 'mlp' in layers:
            return layers['mlp'][mlp[rest]][i], _t
        if rest == 'block_sparse_moe.gate.weight' and 'moe' in layers:
            return layers['moe']['router'][i], _t
        if rest.startswith('block_sparse_moe.experts.') and \
                'moe' in layers:
            j = int(rest.split('.')[2])
            w = {'w1': 'wi_gate', 'w3': 'wi_up',
                 'w2': 'wo'}.get(rest.split('.')[3])
            if w is not None:
                return layers['moe'][w][i, j], _t
        return None

    unmapped = []
    for fn in _iter_checkpoint_files(path):
        with SafetensorsReader(fn) as reader:
            for key in reader.keys():
                result = target(key)
                if result is SKIP:
                    continue
                if result is None:
                    unmapped.append(key)
                    continue
                dest, transform = result
                # One source tensor on the device at a time: copied from
                # its map, then laid out and cast into its slice there.
                src = reader.get(key).to(dev)
                src = src if transform is None else transform(src)
                if src.shape != dest.shape:
                    raise ValueError(
                        f'{key} in {fn} has shape '
                        f'{tuple(reader.shape(key))}, which does not fit '
                        f'{tuple(dest.shape)} of the config')
                dest.copy_(src)
                del src
                seen.add(_strip_prefix(key))
    if unmapped:
        raise ValueError(
            f'unmapped tensors in {path}: {sorted(unmapped)[:8]}'
            f'{"..." if len(unmapped) > 8 else ""}')
    # embed + final norm (+ head), per layer: 4 attn + 2 norms + either
    # 3 dense-MLP tensors or router + 3 per expert.
    per_layer = 6 + (1 + 3 * cfg.num_experts if cfg.is_moe else 3)
    expected = 2 + (0 if cfg.tie_embeddings else 1) + n * per_layer
    if len(seen) != expected:
        raise ValueError(
            f'checkpoint {path} incomplete: {len(seen)} tensors mapped, '
            f'expected {expected}')
    return params, cfg


def resolve_engine_inputs(hf_checkpoint: Optional[str], params, cfg, *,
                          dtype: Optional[torch.dtype] = None,
                          device: Optional[Union[str, torch.device]] = None):
    """Shared serving-engine constructor path: when ``hf_checkpoint``
    is set, fill missing params/cfg from the HF dir (bf16 by default:
    serving wants half the resident memory of fp32)."""
    if not hf_checkpoint:
        return params, cfg
    if params is None:
        params, cfg = load_checkpoint(hf_checkpoint,
                                      dtype=dtype or torch.bfloat16,
                                      device=device)
    elif cfg is None:
        cfg = load_config(hf_checkpoint)
    return params, cfg


def iter_hf_tensors(params: Params, cfg: ModelConfig
                    ) -> Iterator[Tuple[str, torch.Tensor]]:
    """Stacked params -> (HF tensor name, tensor) pairs (export side);
    each tensor is a view of the params, on their device."""
    d = cfg.d_model
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim

    yield 'model.embed_tokens.weight', params['embed']['embedding']
    yield 'model.norm.weight', params['final_norm']['scale']
    if not cfg.tie_embeddings:
        yield 'lm_head.weight', params['lm_head']['w'].t()
    layers = params['layers']
    for i in range(cfg.n_layers):
        p = f'model.layers.{i}.'
        at = layers['attn']
        yield (p + 'self_attn.q_proj.weight',
               at['wq'][i].reshape(d, h * hd).t())
        yield (p + 'self_attn.k_proj.weight',
               at['wk'][i].reshape(d, kv * hd).t())
        yield (p + 'self_attn.v_proj.weight',
               at['wv'][i].reshape(d, kv * hd).t())
        yield (p + 'self_attn.o_proj.weight',
               at['wo'][i].reshape(h * hd, d).t())
        yield p + 'input_layernorm.weight', layers['ln_attn']['scale'][i]
        yield (p + 'post_attention_layernorm.weight',
               layers['ln_mlp']['scale'][i])
        if cfg.is_moe:
            moe = layers['moe']
            yield p + 'block_sparse_moe.gate.weight', moe['router'][i].t()
            for j in range(cfg.num_experts):
                ep = p + f'block_sparse_moe.experts.{j}.'
                yield ep + 'w1.weight', moe['wi_gate'][i, j].t()
                yield ep + 'w3.weight', moe['wi_up'][i, j].t()
                yield ep + 'w2.weight', moe['wo'][i, j].t()
        else:
            mlp = layers['mlp']
            yield p + 'mlp.gate_proj.weight', mlp['wi_gate'][i].t()
            yield p + 'mlp.up_proj.weight', mlp['wi_up'][i].t()
            yield p + 'mlp.down_proj.weight', mlp['wo'][i].t()


def save_checkpoint(params: Params, cfg: ModelConfig, out_dir: str,
                    *, dtype: Optional[torch.dtype] = None) -> None:
    """Export the params as an HF-layout checkpoint (config.json +
    model.safetensors) loadable by ``transformers`` and by
    ``load_checkpoint``: the finetune-then-publish path."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, 'config.json'), 'w') as f:
        json.dump(config_to_hf(cfg), f, indent=2)
    write_safetensors(
        os.path.join(out_dir, 'model.safetensors'),
        dict(iter_hf_tensors(params, cfg)),
        metadata={'format': 'pt'}, dtype=dtype)
