"""Weight projections: the fp branch of ``skypilot_tpu/models/quant.py``.

The W8A8 ``QTensor`` path (per-token int8 activations x per-channel
int8 weights) is not ported yet; asking for it raises with a pointer to
ROADMAP.md rather than serving fp weights under a quantized name.
"""
from __future__ import annotations

from typing import Any

import torch

_W8A8_TODO = ('W8A8 weight quantization is not ported yet '
              '(ROADMAP.md, queue A item 8)')


def weight_einsum(spec: str, x: torch.Tensor, w: Any,
                  dt: torch.dtype) -> torch.Tensor:
    """``einsum(spec, x, w)`` in ``dt`` (the reference's fp branch:
    operands cast to the compute dtype, result in the compute dtype).
    A weight already stored in ``dt`` is used as is."""
    if not isinstance(w, torch.Tensor):
        raise NotImplementedError(_W8A8_TODO)
    return torch.einsum(spec, x.to(dt), w.to(dt))


def maybe_quantize(params: Any, quantize: bool) -> Any:
    if quantize:
        raise NotImplementedError(_W8A8_TODO)
    return params
