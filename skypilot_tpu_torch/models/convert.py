"""Weight bridge between the JAX package's params pytree and the port.

``params_from_numpy`` takes the JAX params as numpy arrays (the caller
runs ``jax.tree.map(np.asarray, params)``) and returns the port's
params dict: the same keys, the same stacked ``[L, ...]`` layout, the
same dtypes, on ``device``. ``params_to_numpy`` goes the other way.
The two round-trip bit for bit (bf16 arrays travel as their raw 16-bit
patterns). A W8A8-quantized JAX tree carries ``QTensor`` leaves (the
reference's, with numpy ``q`` and ``scale``); each becomes the port's
``QTensor``, so the same int8 weights go into both implementations.
"""
from __future__ import annotations

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
    if not cfg.is_moe:
        shapes.update({'layers/mlp/wi_gate': (n, d, f),
                       'layers/mlp/wi_up': (n, d, f),
                       'layers/mlp/wo': (n, f, d)})
    if not cfg.tie_embeddings:
        shapes['lm_head/w'] = (d, v)
    return shapes


def _to_tensor(array: np.ndarray, device: torch.device) -> torch.Tensor:
    array = np.ascontiguousarray(array)
    if array.dtype.name == 'bfloat16':
        raw = torch.from_numpy(array.view(np.uint16).astype(np.int16))
        return raw.view(torch.bfloat16).to(device)
    return torch.from_numpy(array.copy()).to(device)


def _to_numpy(tensor: torch.Tensor) -> np.ndarray:
    tensor = tensor.detach().cpu().contiguous()
    if tensor.dtype == torch.bfloat16:
        import ml_dtypes  # the dtype the JAX side's arrays carry
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
        if path not in expected:
            raise KeyError(f'unexpected param {path!r} for {cfg.name}')
        quantized = hasattr(node, 'q') and hasattr(node, 'scale')
        array = np.asarray(node.q if quantized else node)
        if tuple(array.shape) != expected[path]:
            raise ValueError(f'param {path!r} has shape {array.shape}, '
                             f'{cfg.name} expects {expected[path]}')
        seen.add(path)
        if quantized:
            return QTensor(_to_tensor(array, dev),
                           _to_tensor(np.asarray(node.scale), dev))
        return _to_tensor(array, dev)

    out = walk(tree, ())
    missing = sorted(set(expected) - seen)
    if missing:
        raise KeyError(f'params for {cfg.name} lack {missing}')
    return out


def params_to_numpy(params: Params) -> Params:
    """Port params -> the JAX pytree layout with numpy leaves."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    return _to_numpy(params)
