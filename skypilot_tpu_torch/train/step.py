"""Train state and train step on one card: the port of
``skypilot_tpu/train/step.py``.

The optimizers are the reference's optax chains with their update rules
written out in torch (not ``torch.optim``):

- ``adamw``: ``chain(clip_by_global_norm(c), adamw(schedule, b1, b2,
  eps=1e-8, eps_root=0, weight_decay=wd))``: the global norm clip (no
  change below the limit, else ``g / norm * limit``), Adam moments with
  bias correction at the incremented count, decoupled weight decay on
  every leaf (the reference's mask is None), and the learning rate of
  ``warmup_cosine_decay_schedule`` at the count before the increment.
- ``adafactor``: ``chain(clip_by_global_norm(c), adafactor(schedule,
  weight_decay_rate=wd, decay_rate=b2))`` (class ``Adafactor``).

Differences of idiom from the reference: there is no mesh (one card;
passing one raises), no jit and no donation. The parameters and the
Adam moments are updated in place, which keeps one copy of each on the
card where the reference's pure update would allocate new arrays. The
step count is a Python int.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.models.config import ModelConfig
from skypilot_tpu_torch.train.loss import cross_entropy_loss
from skypilot_tpu_torch.utils.device import resolve_device

Params = Dict[str, Any]

# Elastic resize handshake: the controller touches the file named by this
# env var when it wants the gang restarted at a different world size; the
# training loop checks at each step boundary.
RESIZE_SIGNAL_ENV = 'SKYT_RESIZE_SIGNAL'


def resize_requested() -> bool:
    """True when the controller asked for a step-boundary resize."""
    path = os.environ.get(RESIZE_SIGNAL_ENV)
    return bool(path) and os.path.exists(path)


@dataclasses.dataclass
class TrainHParams:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    grad_clip_norm: float = 1.0
    z_loss_coeff: float = 1e-4
    # 'adamw' (2 fp32 moments/param) or 'adafactor' (factored second
    # moment in the param's dtype, O(rows + cols) state per leaf).
    optimizer: str = 'adamw'


@dataclasses.dataclass
class TrainState:
    step: int
    params: Params
    opt_state: Any


def _leaves(tree: Params) -> List[torch.Tensor]:
    """Leaves in sorted-key order (the order of a JAX pytree)."""
    out: List[torch.Tensor] = []
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, dict):
            out.extend(_leaves(value))
        else:
            out.append(value)
    return out


def _no_mesh(mesh: Any) -> None:
    if mesh is not None:
        raise NotImplementedError(
            'device meshes are multi-device work, not ported yet: the port '
            'trains on one card (ROADMAP.md, queue A item 15)')


def warmup_cosine_decay(init_value: float, peak_value: float,
                        warmup_steps: int, decay_steps: int,
                        end_value: float = 0.0) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule: linear warmup from
    ``init_value`` to ``peak_value``, then cosine decay to ``end_value``
    over ``decay_steps - warmup_steps`` steps."""
    if decay_steps - warmup_steps <= 0:
        raise ValueError('the cosine decay needs decay_steps > warmup_steps')
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - count / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        c = min(count - warmup_steps, decay_steps - warmup_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * c /
                                       (decay_steps - warmup_steps)))
        return peak_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


def _schedule(hp: TrainHParams) -> Callable[[int], float]:
    """The reference's learning-rate schedule for both optimizers."""
    return warmup_cosine_decay(
        init_value=0.0, peak_value=hp.learning_rate,
        warmup_steps=hp.warmup_steps,
        decay_steps=max(hp.total_steps, hp.warmup_steps + 1),
        end_value=hp.learning_rate * 0.1)


class AdamW:
    """clip_by_global_norm -> scale_by_adam -> add_decayed_weights ->
    scale_by_learning_rate(schedule), updating params in place.
    ``schedule`` (step -> learning rate) defaults to the reference's
    warmup-cosine of ``hp``; ``clip=False`` drops the clipping, which
    with a constant schedule is plain ``optax.adamw``.

    State: ``{'count': int, 'mu': params-like, 'nu': params-like}``."""

    def __init__(self, hp: TrainHParams,
                 schedule: Optional[Callable[[int], float]] = None,
                 clip: bool = True):
        self.hp = hp
        self.eps = 1e-8        # optax.adamw defaults
        self.eps_root = 0.0
        self.schedule = schedule or _schedule(hp)
        self.clip = clip

    def init(self, params: Params) -> Dict[str, Any]:
        def zeros(tree):
            if isinstance(tree, dict):
                return {k: zeros(v) for k, v in tree.items()}
            return torch.zeros_like(tree, dtype=torch.float32,
                                    requires_grad=False)
        return {'count': 0, 'mu': zeros(params), 'nu': zeros(params)}

    @torch.no_grad()
    def update_(self, params: Params, grads: List[torch.Tensor],
                state: Dict[str, Any]
                ) -> Tuple[Dict[str, Any], Optional[torch.Tensor]]:
        """Apply one update in place. ``grads`` are in ``_leaves``
        order. Returns (new state, global norm of the unclipped grads;
        None without clipping)."""
        hp = self.hp
        g_norm = clip = None
        if self.clip:
            g_norm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                                    for g in grads))
            clip = torch.where(g_norm < hp.grad_clip_norm,
                               torch.ones_like(g_norm),
                               hp.grad_clip_norm / g_norm)
        count_inc = state['count'] + 1
        bc1 = 1.0 - hp.b1 ** count_inc
        bc2 = 1.0 - hp.b2 ** count_inc
        lr = self.schedule(state['count'])
        for p, g, mu, nu in zip(_leaves(params), grads,
                                _leaves(state['mu']), _leaves(state['nu'])):
            g = g.float() if clip is None else g.float() * clip
            mu.mul_(hp.b1).add_(g, alpha=1.0 - hp.b1)
            nu.mul_(hp.b2).addcmul_(g, g, value=1.0 - hp.b2)
            update = (mu / bc1) / (torch.sqrt(nu / bc2 + self.eps_root) +
                                   self.eps)
            update.add_(p.float(), alpha=hp.weight_decay)
            p.add_((-lr * update).to(p.dtype))
        return {'count': count_inc, 'mu': state['mu'],
                'nu': state['nu']}, g_norm


def plain_adamw(learning_rate: float) -> AdamW:
    """``optax.adamw(learning_rate)`` at its defaults, as ``AdamW``:
    betas (0.9, 0.999), eps 1e-8, weight decay 1e-4, a constant learning
    rate and no clipping (the finetune's LoRA optimizer and GRPO's)."""
    return AdamW(TrainHParams(learning_rate=learning_rate, b1=0.9,
                              b2=0.999, weight_decay=1e-4),
                 schedule=lambda count: learning_rate, clip=False)


def factored_dims(shape: Tuple[int, ...],
                  min_dim_size_to_factor: int = 128
                  ) -> Optional[Tuple[int, int]]:
    """optax's ``_factored_dims``: the leaf's two largest dims (second
    largest, largest) by numpy's own ``argsort`` of the shape, so ties
    fall as they do in optax; None when the second largest is below
    ``min_dim_size_to_factor`` or the leaf has fewer than two dims. On
    bench-1b7's stacked leaves: ``wq [22, 2560, 20, 128]`` gives (3, 1),
    ``wo [22, 20, 128, 2560]`` (2, 3), the norm scales ``[22, 2560]``
    None."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


def _in_dtype(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype``: a weakly typed scalar in JAX takes the
    array's dtype before the op, where torch would keep it in float."""
    return torch.tensor(x, dtype=dtype).item()


def _global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """optax.global_norm: each leaf's sum of squares (accumulated in
    fp32, stored in the leaf's dtype), summed over the leaves in order,
    then the square root, all in that dtype."""
    total = sum(torch.sum(torch.square(g.float())).to(g.dtype)
                for g in grads)
    return torch.sqrt(total)


class Adafactor:
    """``chain(clip_by_global_norm(c), adafactor(schedule,
    weight_decay_rate=wd, decay_rate=b2))`` with optax's defaults
    (``min_dim_size_to_factor=128``, ``eps=1e-30``, clipping threshold
    1, parameter scale on, no momentum), updating params in place:

    1. the global norm clip, in the grads' dtype (``g / norm * c`` above
       the limit, ``g`` unchanged below it);
    2. ``scale_by_factored_rms``: with ``beta = 1 - (count + 1) ** -b2``
       (0 at the first step: ``b2`` is an exponent here, not a beta) and
       ``g2 = g * g + eps``, a factored leaf (``factored_dims``, dims
       ``d1`` < ``d0`` in size) keeps ``v_row = beta v_row + (1 - beta)
       mean(g2, d0)`` and ``v_col`` likewise over ``d1`` and scales ``g``
       by ``(v_row / mean(v_row over d1)) ** -0.5`` along ``d0`` and
       ``v_col ** -0.5`` along ``d1``; any other leaf keeps a full ``v``
       and scales by ``v ** -0.5``;
    3. ``clip_by_block_rms(1)``: ``u / max(1, rms(u))`` per whole leaf;
    4. ``u * lr(count)``;
    5. ``u * max(rms(param), 1e-3)`` per whole leaf;
    6. ``u + wd * param``: the weight decay comes after the learning
       rate, so the rate does not scale it (each step shrinks every
       param by ``wd``, as in the reference);
    7. ``param - u``.

    The statistics are stored in the param's dtype (bf16 params keep
    bf16 statistics) and the means and decays run in fp32 where JAX
    promotes them; scalars are rounded to the leaf's dtype first, as
    JAX's weak types are. State: ``{'count': int, 'v_row', 'v_col',
    'v'}``, each a params-like tree, unused statistics ``(1,)`` zeros:
    optax's ``FactoredState`` names and shapes."""

    min_dim_size_to_factor = 128
    eps = 1e-30
    clipping_threshold = 1.0
    min_param_scale = 1e-3

    def __init__(self, hp: TrainHParams):
        self.hp = hp
        self.decay_rate = hp.b2
        self.schedule = _schedule(hp)

    def _factored(self, shape) -> Optional[Tuple[int, int]]:
        return factored_dims(tuple(shape), self.min_dim_size_to_factor)

    def init(self, params: Params) -> Dict[str, Any]:
        def stats(tree, which):
            if isinstance(tree, dict):
                return {k: stats(v, which) for k, v in tree.items()}
            dims = self._factored(tree.shape)
            shape = (1,)
            if which == 'v' and dims is None:
                shape = tuple(tree.shape)
            elif which != 'v' and dims is not None:
                drop = dims[1] if which == 'v_row' else dims[0]
                shape = tuple(n for i, n in enumerate(tree.shape)
                              if i != drop)
            return torch.zeros(shape, dtype=tree.dtype, device=tree.device)
        return {'count': 0, 'v_row': stats(params, 'v_row'),
                'v_col': stats(params, 'v_col'), 'v': stats(params, 'v')}

    def _decay(self, count: int) -> Tuple[float, float]:
        """(beta, 1 - beta) at ``count``, computed in fp32."""
        beta = np.float32(1.0) - np.float32(count + 1) ** np.float32(
            -self.decay_rate)
        return float(beta), float(np.float32(1.0) - beta)

    @torch.no_grad()
    def update_(self, params: Params, grads: List[torch.Tensor],
                state: Dict[str, Any]
                ) -> Tuple[Dict[str, Any], Optional[torch.Tensor]]:
        """Apply one update in place. ``grads`` are in ``_leaves``
        order. Returns (new state, global norm of the unclipped grads,
        in their dtype)."""
        hp = self.hp
        g_norm = _global_norm(grads)
        clipped = g_norm >= hp.grad_clip_norm
        one = torch.ones_like(g_norm)
        divisor = torch.where(clipped, g_norm, one)
        factor = torch.where(clipped, one * hp.grad_clip_norm, one)
        count = state['count']
        beta, one_minus = self._decay(count)
        lr = self.schedule(count)
        for p, g, v_row, v_col, v in zip(
                _leaves(params), grads, _leaves(state['v_row']),
                _leaves(state['v_col']), _leaves(state['v'])):
            dt = p.dtype
            g = g.to(dt) / divisor.to(dt) * factor.to(dt)
            g2 = g * g + _in_dtype(self.eps, dt)
            dims = self._factored(p.shape)
            if dims is not None:
                d1, d0 = dims
                new_row = (v_row.float() * beta + torch.mean(
                    g2, dim=d0).float() * one_minus).to(dt)
                new_col = (v_col.float() * beta + torch.mean(
                    g2, dim=d1).float() * one_minus).to(dt)
                del g2
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_mean = torch.mean(new_row, dim=reduced_d1,
                                      keepdim=True)
                row_factor = (new_row / row_mean) ** -0.5
                col_factor = new_col ** -0.5
                u = g * row_factor.unsqueeze(d0)
                u.mul_(col_factor.unsqueeze(d1))
                v_row.copy_(new_row)
                v_col.copy_(new_col)
            else:
                new_v = (v.float() * beta + g2.float() * one_minus).to(dt)
                del g2
                u = g * new_v ** -0.5
                v.copy_(new_v)
            del g
            rms = torch.sqrt(torch.mean(u * u))
            u.div_(torch.clamp_min(rms / self.clipping_threshold, 1.0))
            u.mul_(_in_dtype(lr, dt))
            p_rms = torch.sqrt(torch.mean(p * p))
            u.mul_(torch.clamp_min(p_rms,
                                   _in_dtype(self.min_param_scale, dt)))
            u.add_(p * _in_dtype(hp.weight_decay, dt))
            p.sub_(u)
        return {'count': count + 1, 'v_row': state['v_row'],
                'v_col': state['v_col'], 'v': state['v']}, g_norm


Optimizer = Union[AdamW, Adafactor]


def make_optimizer(hp: TrainHParams) -> Optimizer:
    if hp.optimizer == 'adafactor':
        return Adafactor(hp)
    if hp.optimizer != 'adamw':
        raise ValueError(f'Unknown optimizer {hp.optimizer!r} '
                         f"(expected 'adamw' or 'adafactor')")
    return AdamW(hp)


def _trainable(params: Params) -> Params:
    for leaf in _leaves(params):
        leaf.requires_grad_(True)
    return params


def create_train_state(seed: int, cfg: ModelConfig, hp: TrainHParams,
                       mesh: Any = None, *,
                       device: Optional[Union[str, torch.device]] = None
                       ) -> TrainState:
    """Initialize params (``llama.init_params`` on the card, in
    ``cfg.param_dtype``) and the optimizer state."""
    _no_mesh(mesh)
    params = llama.init_params(seed, cfg, device=resolve_device(device))
    return create_train_state_from_params(params, cfg, hp)


def create_train_state_from_params(params: Params, cfg: ModelConfig,
                                   hp: TrainHParams,
                                   mesh: Any = None) -> TrainState:
    """TrainState around EXISTING params (finetuning a loaded
    checkpoint); the params are trained in place."""
    del cfg  # layout comes from the params themselves
    _no_mesh(mesh)
    optimizer = make_optimizer(hp)
    return TrainState(step=0, params=_trainable(params),
                      opt_state=optimizer.init(params))


def train_step_fn(state: TrainState, batch: Dict[str, torch.Tensor],
                  cfg: ModelConfig, optimizer: Optimizer, hp: TrainHParams,
                  pipeline_stages: int = 1
                  ) -> Tuple[TrainState, Dict[str, Any]]:
    """One step. batch: tokens [B,S], targets [B,S], weights [B,S],
    optional positions and segments.

    A MoE model (with ``router_aux_loss_coeff > 0``, no pipeline)
    optimizes ``total_loss = loss + coeff * router_aux``, the layer mean
    of the router load-balancing loss; ``loss`` stays the plain cross
    entropy, and ``router_aux`` is 0 for a dense model."""
    use_aux = (cfg.is_moe and cfg.router_aux_loss_coeff > 0
               and pipeline_stages == 1)
    leaves = _leaves(state.params)
    out = llama.forward(state.params, batch['tokens'], cfg,
                        positions=batch.get('positions'),
                        segments=batch.get('segments'),
                        pipeline_stages=pipeline_stages,
                        return_aux=use_aux)
    logits, aux = out if use_aux else (out, None)
    loss, _ = cross_entropy_loss(logits, batch['targets'],
                                 batch.get('weights'),
                                 z_loss_coeff=hp.z_loss_coeff)
    del logits, out
    total_loss = loss
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=loss.device)
    else:
        total_loss = loss + cfg.router_aux_loss_coeff * aux
    grads = torch.autograd.grad(total_loss, leaves)
    opt_state, grad_norm = optimizer.update_(state.params, list(grads),
                                             state.opt_state)
    del grads
    metrics = {
        'loss': loss.detach(),
        'total_loss': total_loss.detach(),
        'grad_norm': grad_norm,
        'step': state.step,
        # 1.0 = a perfectly balanced router.
        'router_aux': aux.detach().float(),
    }
    return TrainState(step=state.step + 1, params=state.params,
                      opt_state=opt_state), metrics


def make_train_step(cfg: ModelConfig, hp: TrainHParams, mesh: Any = None
                    ) -> Callable[[TrainState, Dict[str, torch.Tensor]],
                                  Tuple[TrainState, Dict[str, Any]]]:
    """The train step for one card (no jit: PyTorch runs eagerly)."""
    _no_mesh(mesh)
    optimizer = make_optimizer(hp)

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        return train_step_fn(state, batch, cfg, optimizer, hp)

    return step


def make_forward(cfg: ModelConfig, mesh: Any = None):
    """An inference forward: (params, tokens) -> fp32 logits."""
    _no_mesh(mesh)

    @torch.no_grad()
    def fwd(params: Params, tokens: torch.Tensor) -> torch.Tensor:
        return llama.forward(params, tokens, cfg)

    return fwd
