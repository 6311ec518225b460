"""Train state and train step on one card: the port of
``skypilot_tpu/train/step.py``.

The optimizer is optax's ``chain(clip_by_global_norm(c), adamw(schedule,
b1, b2, eps=1e-8, eps_root=0, weight_decay=wd))`` with its update rules
written out in torch (not ``torch.optim``): the global norm clip (no
change below the limit, else ``g / norm * limit``), Adam moments with
bias correction at the incremented count, decoupled weight decay on
every leaf (the reference's mask is None), and the learning rate of
``warmup_cosine_decay_schedule`` at the count before the increment.

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
    # 'adamw' (2 fp32 moments/param); 'adafactor' is not ported yet.
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


class AdamW:
    """clip_by_global_norm -> scale_by_adam -> add_decayed_weights ->
    scale_by_learning_rate(schedule), updating params in place.

    State: ``{'count': int, 'mu': params-like, 'nu': params-like}``."""

    def __init__(self, hp: TrainHParams):
        self.hp = hp
        self.eps = 1e-8        # optax.adamw defaults
        self.eps_root = 0.0
        self.schedule = warmup_cosine_decay(
            init_value=0.0, peak_value=hp.learning_rate,
            warmup_steps=hp.warmup_steps,
            decay_steps=max(hp.total_steps, hp.warmup_steps + 1),
            end_value=hp.learning_rate * 0.1)

    def init(self, params: Params) -> Dict[str, Any]:
        def zeros(tree):
            if isinstance(tree, dict):
                return {k: zeros(v) for k, v in tree.items()}
            return torch.zeros_like(tree, dtype=torch.float32,
                                    requires_grad=False)
        return {'count': 0, 'mu': zeros(params), 'nu': zeros(params)}

    @torch.no_grad()
    def update_(self, params: Params, grads: List[torch.Tensor],
                state: Dict[str, Any]) -> Tuple[Dict[str, Any],
                                                torch.Tensor]:
        """Apply one update in place. ``grads`` are in ``_leaves``
        order. Returns (new state, global norm of the unclipped
        grads)."""
        hp = self.hp
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
            g = g.float() * clip
            mu.mul_(hp.b1).add_(g, alpha=1.0 - hp.b1)
            nu.mul_(hp.b2).addcmul_(g, g, value=1.0 - hp.b2)
            update = (mu / bc1) / (torch.sqrt(nu / bc2 + self.eps_root) +
                                   self.eps)
            update.add_(p.float(), alpha=hp.weight_decay)
            p.add_((-lr * update).to(p.dtype))
        return {'count': count_inc, 'mu': state['mu'],
                'nu': state['nu']}, g_norm


def make_optimizer(hp: TrainHParams) -> AdamW:
    if hp.optimizer == 'adafactor':
        raise NotImplementedError(
            'adafactor is not ported yet (ROADMAP.md, queue A item 14)')
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
                  cfg: ModelConfig, optimizer: AdamW, hp: TrainHParams,
                  pipeline_stages: int = 1
                  ) -> Tuple[TrainState, Dict[str, Any]]:
    """One step. batch: tokens [B,S], targets [B,S], weights [B,S],
    optional positions and segments."""
    leaves = _leaves(state.params)
    logits = llama.forward(state.params, batch['tokens'], cfg,
                           positions=batch.get('positions'),
                           segments=batch.get('segments'),
                           pipeline_stages=pipeline_stages)
    loss, _ = cross_entropy_loss(logits, batch['targets'],
                                 batch.get('weights'),
                                 z_loss_coeff=hp.z_loss_coeff)
    del logits
    # Dense models only: the router aux loss is 0.
    grads = torch.autograd.grad(loss, leaves)
    opt_state, grad_norm = optimizer.update_(state.params, list(grads),
                                             state.opt_state)
    del grads
    loss = loss.detach()
    metrics = {
        'loss': loss,
        'total_loss': loss,
        'grad_norm': grad_norm,
        'step': state.step,
        'router_aux': torch.zeros((), dtype=torch.float32,
                                  device=loss.device),
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
