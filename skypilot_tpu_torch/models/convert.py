"""Weight bridge between the JAX package's params pytree and the port.

``params_from_numpy`` takes the JAX params as numpy arrays (the caller
runs ``jax.tree.map(np.asarray, params)``) and returns the port's
params dict: the same keys, the same stacked ``[L, ...]`` layout, the
same dtypes, on ``device``. ``params_to_numpy`` goes the other way.
The two round-trip bit for bit (bf16 arrays travel as their raw 16-bit
patterns). A W8A8-quantized JAX tree carries ``QTensor`` leaves (the
reference's, with numpy ``q`` and ``scale``); each becomes the port's
``QTensor``, so the same int8 weights go into both implementations.

LoRA: a params tree with an adapter mounted at ``layers/lora``
(``skypilot_tpu/models/lora.attach``) carries it over too;
``lora_from_numpy`` carries a bare adapter (``init_lora_params``'s
``[L, ...]`` leaves) and ``adapter_pages_from_numpy`` an adapter page
store (``init_adapter_pages``'s ``[L, P, ...]`` leaves), so both
packages can be fed the same adapters.
"""
from __future__ import annotations

import sys
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from skypilot_tpu_torch.models.config import ModelConfig
from skypilot_tpu_torch.models.quant import QTensor
from skypilot_tpu_torch.utils.device import resolve_device

Params = Dict[str, Any]


def _expected_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    h, kv, hd, n = (cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
                    cfg.n_layers)
    shapes = {
        'embed/embedding': (v, d),
        'final_norm/scale': (d,),
        'layers/attn/wq': (n, d, h, hd),
        'layers/attn/wk': (n, d, kv, hd),
        'layers/attn/wv': (n, d, kv, hd),
        'layers/attn/wo': (n, h, hd, d),
        'layers/ln_attn/scale': (n, d),
        'layers/ln_mlp/scale': (n, d),
    }
    if cfg.is_moe:
        e = cfg.num_experts
        shapes.update({'layers/moe/router': (n, d, e),
                       'layers/moe/wi_gate': (n, e, d, f),
                       'layers/moe/wi_up': (n, e, d, f),
                       'layers/moe/wo': (n, e, f, d)})
    else:
        shapes.update({'layers/mlp/wi_gate': (n, d, f),
                       'layers/mlp/wi_up': (n, d, f),
                       'layers/mlp/wo': (n, f, d)})
    if not cfg.tie_embeddings:
        shapes['lm_head/w'] = (d, v)
    return shapes


def _lora_shapes(cfg: ModelConfig, rank: int,
                 pages: Optional[int] = None) -> Dict[str, tuple]:
    """Leaf shapes of a rank-``rank`` adapter, or of a page store of
    ``pages`` page slots (page 0 included) with its ``scale``."""
    d, h, kv, hd, n = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.resolved_head_dim, cfg.n_layers)
    lead = (n,) if pages is None else (n, pages)
    shapes = {'wq_a': lead + (d, rank), 'wq_b': lead + (rank, h, hd),
              'wv_a': lead + (d, rank), 'wv_b': lead + (rank, kv, hd)}
    if pages is not None:
        shapes['scale'] = lead
    return shapes


def tensor_from_numpy(array: np.ndarray,
                      device: Union[str, torch.device] = 'cpu'
                      ) -> torch.Tensor:
    """A numpy array (ml_dtypes bfloat16 included) as a tensor."""
    array = np.ascontiguousarray(array)
    if array.dtype.name == 'bfloat16':
        raw = torch.from_numpy(array.view(np.uint16).astype(np.int16))
        return raw.view(torch.bfloat16).to(device)
    return torch.from_numpy(array.copy()).to(device)


def tensor_to_numpy(tensor: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array (bf16 as ml_dtypes bfloat16).

    numpy has no bf16 of its own: the JAX package's bf16 arrays carry
    ``ml_dtypes``' type, which the port does not import (the card
    machine lacks it). A bf16 tensor converts only in a process where
    it is already loaded (by JAX: the parity tests), and raises
    elsewhere."""
    tensor = tensor.detach().cpu().contiguous()
    if tensor.dtype == torch.bfloat16:
        ml_dtypes = sys.modules.get('ml_dtypes')
        if ml_dtypes is None:
            raise TypeError('a bf16 tensor has no numpy dtype in this '
                            'process (ml_dtypes is not loaded)')
        bits = tensor.view(torch.int16).numpy().astype(np.uint16)
        return bits.view(ml_dtypes.bfloat16)
    return tensor.numpy().copy()


def params_from_numpy(tree: Params, cfg: ModelConfig,
                      device: Optional[Union[str, torch.device]] = None
                      ) -> Params:
    """JAX params (numpy leaves) -> port params on ``device``.

    Checks every leaf against ``cfg``'s shapes and raises on a missing,
    extra or mis-shaped leaf."""
    dev = resolve_device(device)
    expected = _expected_shapes(cfg)
    seen = set()

    def walk(node, prefix):
        if isinstance(node, dict):
            return {k: walk(v, prefix + (k,)) for k, v in node.items()}
        path = '/'.join(prefix)
        if prefix[:2] == ('layers', 'lora'):
            return _lora_leaf(tree['layers']['lora'], prefix[2], cfg, dev)
        if path not in expected:
            raise KeyError(f'unexpected param {path!r} for {cfg.name}')
        quantized = hasattr(node, 'q') and hasattr(node, 'scale')
        array = np.asarray(node.q if quantized else node)
        if tuple(array.shape) != expected[path]:
            raise ValueError(f'param {path!r} has shape {array.shape}, '
                             f'{cfg.name} expects {expected[path]}')
        seen.add(path)
        if quantized:
            return QTensor(tensor_from_numpy(array, dev),
                           tensor_from_numpy(np.asarray(node.scale), dev))
        return tensor_from_numpy(array, dev)

    out = walk(tree, ())
    missing = sorted(set(expected) - seen)
    if missing:
        raise KeyError(f'params for {cfg.name} lack {missing}')
    return out


def params_to_numpy(params: Params) -> Params:
    """Port params -> the JAX pytree layout with numpy leaves."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    return tensor_to_numpy(params)


def _lora_leaf(tree: Params, key: str, cfg: ModelConfig,
               device: torch.device, pages: Optional[int] = None
               ) -> torch.Tensor:
    rank = int(np.shape(tree['wq_a'])[-1])
    expected = _lora_shapes(cfg, rank, pages)
    if key not in expected:
        raise KeyError(f'unexpected LoRA leaf {key!r} for {cfg.name}')
    array = np.asarray(tree[key])
    if tuple(array.shape) != expected[key]:
        raise ValueError(f'LoRA leaf {key!r} has shape {array.shape}, '
                         f'{cfg.name} expects {expected[key]}')
    return tensor_from_numpy(array, device)


def _lora_tree(tree: Params, cfg: ModelConfig, device, pages) -> Params:
    dev = resolve_device(device)
    rank = int(np.shape(tree['wq_a'])[-1])
    missing = sorted(set(_lora_shapes(cfg, rank, pages)) - set(tree))
    if missing:
        raise KeyError(f'LoRA tree for {cfg.name} lacks {missing}')
    return {key: _lora_leaf(tree, key, cfg, dev, pages) for key in tree}


def lora_from_numpy(tree: Params, cfg: ModelConfig,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> Params:
    """A reference adapter (``wq_a``/``wq_b``/``wv_a``/``wv_b``, numpy
    ``[L, ...]`` leaves) -> port tensors on ``device``, shape-checked."""
    return _lora_tree(tree, cfg, device, None)


def adapter_pages_from_numpy(tree: Params, cfg: ModelConfig,
                             device: Optional[Union[str, torch.device]]
                             = None) -> Params:
    """A reference adapter page store (``[L, P, ...]`` numpy leaves and
    ``scale [L, P]``) -> port tensors on ``device``, shape-checked."""
    pages = int(np.shape(tree['scale'])[1])
    return _lora_tree(tree, cfg, device, pages)
