"""Int8 W8A8 weights for serving: the port of ``skypilot_tpu/models/quant.py``.

* ``QTensor``: int8 values + fp32 scale (the quantized tensor's rank
  with the contraction axes reduced to 1), dropped into the param dicts
  in place of a weight. ``.to(dtype)`` / ``astype`` dequantize, so a
  code path that casts a weight (``llama.forward``) keeps working,
  unquantized-slow but correct; ``.to(device)`` moves it; indexing and
  ``unbind`` slice the stacked ``[L, ...]`` layers.
* ``weight_einsum``: the projections. A plain tensor takes the fp
  einsum in the compute dtype; a ``QTensor`` quantizes the activations
  per token (symmetric absmax over the contracted trailing axes) and
  multiplies int8 by int8 with an exact int32 accumulation, then scales
  by (activation scale x weight scale). As in the reference, where XLA
  does this product, it is a library GEMM (``torch._int_mm`` on the
  card, an int32 matmul on the CPU), not a hand-written kernel. fp32
  accumulation would not do: at K = 14336 the sums reach 127^2 x K ~
  2.3e8 > 2^24.
* ``quantize_params``: the decoder-layer projections and an untied LM
  head; embeddings and norm scales stay fp. MoE experts stay fp unless
  ``quantize_moe``: then each expert tensor gets per-(layer, expert,
  out-channel) scales, the router stays fp, and the MoE block
  dequantizes them (``QTensor.to(dtype)``), as the reference does.
"""
from __future__ import annotations

import dataclasses
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple,
                    Union)

import torch

Params = Dict[str, Any]

_EPS = 1e-8


@dataclasses.dataclass
class QTensor:
    """Symmetric int8 tensor: ``dequant = q.float() * scale``."""
    q: torch.Tensor       # int8, original shape
    scale: torch.Tensor   # fp32, q's shape with contracted axes -> 1

    @property
    def shape(self) -> torch.Size:
        return self.q.shape

    @property
    def ndim(self) -> int:
        return self.q.dim()

    def astype(self, dt: torch.dtype) -> torch.Tensor:
        """Full dequantization (the drop-in for fp call sites)."""
        return (self.q * self.scale).to(dt)     # int8 * fp32 -> fp32

    def to(self, target: Union[torch.dtype, str, torch.device]) -> Any:
        """A dtype dequantizes (like the reference's ``astype``); a
        device moves the int8 values and their scales."""
        if isinstance(target, torch.dtype):
            return self.astype(target)
        return QTensor(self.q.to(target), self.scale.to(target))

    def __getitem__(self, index) -> 'QTensor':
        return QTensor(self.q[index], self.scale[index])

    def unbind(self, dim: int = 0) -> List['QTensor']:
        return [QTensor(q, s) for q, s in
                zip(self.q.unbind(dim), self.scale.unbind(dim))]


def quantize_tensor(w: torch.Tensor, reduce_axes: Sequence[int]) -> QTensor:
    """Symmetric absmax int8 over ``reduce_axes`` (the contraction dims);
    ``torch.round`` rounds half to even, like ``jnp.round``."""
    w = w.float()
    absmax = torch.amax(torch.abs(w), dim=tuple(reduce_axes), keepdim=True)
    scale = torch.clamp(absmax, min=_EPS) / 127.0
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return QTensor(q=q, scale=scale)


def _quantize_stacked(w: torch.Tensor,
                      reduce_axes: Sequence[int]) -> QTensor:
    """``quantize_tensor`` of a stacked ``[L, ...]`` leaf whose reduced
    axes exclude axis 0, one layer at a time: the same values as the
    whole-array call, with one layer's fp32 temporaries at a time."""
    inner = [a - 1 for a in reduce_axes]
    parts = [quantize_tensor(layer, inner) for layer in w.unbind(0)]
    return QTensor(torch.stack([p.q for p in parts]),
                   torch.stack([p.scale for p in parts]))


def _absmax(x32: torch.Tensor, n_contract: int) -> torch.Tensor:
    axes = tuple(range(x32.dim() - n_contract, x32.dim()))
    return torch.amax(torch.abs(x32), dim=axes, keepdim=True)


def _quantize_by(x32: torch.Tensor, absmax: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(absmax, min=_EPS) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def _quantize_activations(x: torch.Tensor, n_contract: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token dynamic int8: reduce over the trailing ``n_contract``
    axes."""
    x32 = x.float()
    return _quantize_by(x32, _absmax(x32, n_contract))


def _pad_to(x: torch.Tensor, dim: int, multiple: int,
            minimum: int = 0) -> torch.Tensor:
    size = x.shape[dim]
    target = max(minimum, -(-size // multiple) * multiple)
    if target == size:
        return x
    pad = [0, 0] * (x.dim() - 1 - dim) + [0, target - size]
    return torch.nn.functional.pad(x, pad)


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int8 [M, K] x int8 [K, N] -> int32 [M, N]. On the card,
    ``torch._int_mm`` (it needs M > 16 and K, N multiples of 8: the
    operands are zero-padded and the result cut back); on the CPU an
    int32 matmul."""
    m, n = a.shape[0], b.shape[1]
    if not a.is_cuda:
        return a.to(torch.int32) @ b.to(torch.int32)
    a = _pad_to(_pad_to(a, 1, 8), 0, 8, minimum=32)
    b = _pad_to(_pad_to(b, 0, 8), 1, 8)
    return torch._int_mm(a.contiguous(), b.contiguous())[:m, :n]


def _split_spec(spec: str) -> Tuple[int, str]:
    """(number of contracted axes, w's output axes) of a projection
    spec, which must contract x's TRAILING axes against w's LEADING
    axes in the same order, with the output = x's batch axes then w's
    output axes."""
    lhs, out_spec = spec.split('->')
    x_spec, w_spec = lhs.split(',')
    contracted = [a for a in x_spec if a in w_spec]
    n_c = len(contracted)
    w_out = w_spec[n_c:]
    if (x_spec[len(x_spec) - n_c:] != ''.join(contracted) or
            w_spec[:n_c] != ''.join(contracted) or
            out_spec != x_spec[:len(x_spec) - n_c] + w_out):
        raise ValueError(f'weight_einsum cannot scale {spec!r}')
    return n_c, w_out


def weight_einsum(spec: str, x: torch.Tensor, w: Any,
                  dt: torch.dtype,
                  reduce: Optional[Callable[[torch.Tensor, str],
                                            torch.Tensor]] = None
                  ) -> torch.Tensor:
    """``einsum(spec, x, w)`` in ``dt``; the W8A8 product for a QTensor.

    ``spec`` is a projection ('bsd,dhk->bshk', 'bshk,hkd->bsd',
    'bsd,df->bsf', 'bsf,fd->bsd', 'bsd,dv->bsv'; see ``_split_spec``).
    A plain tensor takes the fp einsum in ``dt``; a weight already
    stored in ``dt`` is used as is.

    ``reduce`` (tensor-parallel serving): ``x`` and ``w`` hold this
    rank's part of the contracted axes (a row-parallel projection) and
    ``reduce(t, op)`` sums (``'sum'``) or maxes (``'max'``) ``t`` over
    the ranks in place. The partial products are summed in fp32 (int32
    for W8A8, exact) and rounded to ``dt`` once, and a W8A8 activation
    scale is the max over every rank's part: the numbers the reference
    computes on the whole contraction."""
    if not isinstance(w, QTensor):
        if reduce is None:
            return torch.einsum(spec, x.to(dt), w.to(dt))
        from skypilot_tpu_torch.models.llama import _mm_fp32_out
        n_c, _ = _split_spec(spec)
        k = w.shape[:n_c].numel()
        out = _mm_fp32_out(x.to(dt).reshape(-1, k),
                           w.to(dt).reshape(k, -1))
        out = reduce(out, 'sum')
        return out.reshape(*x.shape[:x.dim() - n_c],
                           *w.shape[n_c:]).to(dt)
    n_c, w_out = _split_spec(spec)
    if reduce is None:
        x_q, x_scale = _quantize_activations(x, n_c)
    else:
        # This rank's part of the contraction: the scale is the absmax
        # over every rank's part.
        x32 = x.float()
        x_q, x_scale = _quantize_by(x32, reduce(_absmax(x32, n_c), 'max'))
    batch = x.shape[:x.dim() - n_c]
    k = 1
    for size in x.shape[x.dim() - n_c:]:
        k *= size
    out = int8_matmul(x_q.reshape(-1, k), w.q.reshape(k, -1))
    if reduce is not None:
        out = reduce(out, 'sum')
    out = out.reshape(*batch, *w.q.shape[n_c:]).float()
    x_s = x_scale.reshape(*batch, *([1] * len(w_out)))
    w_s = w.scale.reshape(w.scale.shape[n_c:])
    return (out * x_s * w_s).to(dt)


# ---------------------------------------------------------------------------
# Param-tree quantization
# ---------------------------------------------------------------------------

def maybe_quantize(params: Params, quantize: bool) -> Params:
    """Engine entry point: ``quantize_params`` when ``quantize``."""
    return quantize_params(params) if quantize else params


def quantize_params(params: Params, *, quantize_moe: bool = False) -> Params:
    """Quantize the decoder-layer projections (+ untied lm head); the
    embeddings, norm scales and MoE router stay fp, as in the reference.
    The MoE experts quantize only with ``quantize_moe``."""
    out: Params = {}
    for name, sub in params.items():
        if name == 'layers':
            out[name] = _quantize_layers(sub, quantize_moe)
        elif name == 'lm_head':
            out[name] = {'w': quantize_tensor(sub['w'], (0,))}   # [d, v]
        else:
            out[name] = sub
    return out


def _quantize_layers(layers: Params, quantize_moe: bool) -> Params:
    out: Params = {}
    for block, sub in layers.items():
        if block == 'attn':
            out[block] = {
                'wq': _quantize_stacked(sub['wq'], (1,)),    # [L,d,h,k]
                'wk': _quantize_stacked(sub['wk'], (1,)),
                'wv': _quantize_stacked(sub['wv'], (1,)),
                'wo': _quantize_stacked(sub['wo'], (1, 2)),  # [L,h,k,d]
            }
        elif block == 'mlp':
            out[block] = {
                'wi_gate': _quantize_stacked(sub['wi_gate'], (1,)),
                'wi_up': _quantize_stacked(sub['wi_up'], (1,)),
                'wo': _quantize_stacked(sub['wo'], (1,)),    # [L,f,d]
            }
        elif block == 'moe' and quantize_moe:
            # [L,e,d,f] / [L,e,f,d]: contract d / f, scales per (layer,
            # expert, out-channel).
            out[block] = {
                'router': sub['router'],
                'wi_gate': _quantize_stacked(sub['wi_gate'], (2,)),
                'wi_up': _quantize_stacked(sub['wi_up'], (2,)),
                'wo': _quantize_stacked(sub['wo'], (2,)),
            }
        else:
            out[block] = sub
    return out


def _leaves(tree: Any):
    if isinstance(tree, dict):
        for value in tree.values():
            yield from _leaves(value)
    elif isinstance(tree, QTensor):
        yield tree.q
        yield tree.scale
    else:
        yield tree


def param_bytes(params: Params) -> int:
    """Total bytes (a QTensor counts its int8 payload + fp32 scales)."""
    return sum(x.numel() * x.element_size() for x in _leaves(params))
