"""Train state and train step, on one card or over a mesh: the port of
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

Under a mesh over ``data``, ``stage``, ``fsdp``, ``seq``, ``expert`` and
``tensor`` (one process per rank, ``parallel/launch.py``) each rank holds
its block of every leaf under ``parallel/sharding.DEFAULT_RULES``
(``state_shardings``: an optimizer leaf shards like its param only on an
exact shape match, every other leaf is whole on every rank) and trains
on its rows of the batch and, under ``seq``, its block of their columns.
The batch does not split over ``expert``: ranks that differ only there
hold the same tokens and other experts of each MoE layer (a dense model
trains on them as replicas, as in the reference). The step:

- runs ``llama.forward`` on the shards (fsdp gathers, Megatron's
  column/row-parallel pair over ``tensor``, ring or Ulysses attention
  over ``seq``, each MoE layer's experts over ``expert`` and ``tensor``,
  the rank's vocab columns of the logits), the loss combining the vocab
  blocks over ``tensor`` and normalized by the weight sum of the WHOLE
  batch (``train/loss.py``), plus the router aux loss of the whole
  batch (``llama._router_aux``);
- sums each gradient over the ranks that hold other tokens: an
  fsdp-sharded leaf's arrives reduce-scattered over ``fsdp`` (the
  gather's backward) and is all-reduced over ``data`` and ``seq``, any
  other leaf's is all-reduced over all three (a ``tensor`` rank's
  replicated leaves already hold the whole gradient);
- counts each element of the gradient once in the global norm, and runs
  the optimizers on the blocks: AdamW elementwise, Adafactor with its
  factored statistics, its update RMS and its parameter RMS reduced
  over each leaf's shard groups (``LeafShard``: the expert leaves'
  over ``expert`` too). No leaf splits over ``seq`` (its ranks hold the
  same, whole gradients after the sum), so the norm and the statistics
  reduce over no ``seq`` group.

Under ``stage`` (GPipe, ``parallel/pipeline.py``) each rank holds its
block of L/S layers and its stage's share of the step
(``llama.pipeline_grads``): the microbatches' losses on the last stage,
each normalized by the weight sum of the whole batch, the backward
schedule's gradients, then the sums above and, for every leaf that
``stage`` does not split (the embedding, the final norm, the LM head),
a sum over ``stage``: a stage that did not use the leaf adds zeros, and
a tied embedding adds its first-stage and last-stage parts. The global
norm and Adafactor's statistics count each stage's block of a layer
leaf once. As in the reference, a MoE model trains there on the plain
cross entropy (``router_aux`` 0), and packed segments raise. The loss
is the last stage's, summed over ``stage`` for the metrics.

The stage body runs the layers as on a mesh without stages: ring or
Ulysses attention over the stage's ``seq`` group (its RoPE positions
from the rank's first column), each MoE layer's experts over its
``expert`` group, one microbatch at a time. A stage rank hands its
microbatch blocks to the rank of the next stage at the same ``data``,
``fsdp``, ``seq``, ``expert`` and ``tensor`` coordinates.

The reference's numbers under a mesh are its one-device numbers up to
the order of the sums; so are the port's.

Differences of idiom from the reference: no jit and no donation. The
parameters and the Adam moments are updated in place, which keeps one
copy of each on the card where the reference's pure update would
allocate new arrays. The step count is a Python int.
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
from skypilot_tpu_torch.ops.attention import check_mesh
from skypilot_tpu_torch.ops.ring_attention import seq_shard
from skypilot_tpu_torch.parallel import pipeline
from skypilot_tpu_torch.parallel.mesh import Mesh
from skypilot_tpu_torch.parallel.sharding import (DEFAULT_RULES,
                                                  LogicalAxisRules,
                                                  NamedSharding,
                                                  PartitionSpec,
                                                  TensorParallel,
                                                  param_shardings,
                                                  shard_params_pytree,
                                                  tensor_parallel_of)
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
    # Pipeline microbatch count when the mesh has a stage axis > 1; None =
    # largest divisor of the global batch <= 2 * stages
    # (parallel/pipeline.py).
    pipeline_microbatches: Optional[int] = None
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


def _tree_map(fn: Callable[..., Any], tree: Params, extras) -> Params:
    """``fn(leaf, extra)`` over the leaves in ``_leaves`` order, ``extras``
    an iterator in that order."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k], extras) for k in sorted(tree)}
    return fn(tree, next(extras))


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------

def mesh_parallel(mesh: Optional[Mesh],
                  cfg: ModelConfig) -> Optional[TensorParallel]:
    """This rank's ``TensorParallel`` on ``mesh``, None for no mesh or a
    one-rank mesh. What the slice does not cover raises first, before
    any process group is touched (``check_training_mesh``)."""
    if mesh is None or mesh.size == 1:
        return None
    check_training_mesh(mesh.shape, cfg)
    return tensor_parallel_of(mesh)


def check_training_mesh(shape: Dict[str, int], cfg: ModelConfig,
                        batch: Optional[int] = None) -> None:
    """Raise for a mesh ``shape`` (axis -> degree, more than one rank)
    that the step does not train on: an ``expert`` degree that does not
    divide the experts, heads that ``tensor`` does not divide
    (``ops/attention.check_mesh``), layers that ``stage`` does not
    divide and, for a global ``batch``, the default microbatch count
    where it does not divide a rank's rows (the step raises there too:
    ``llama._pipeline``)."""
    check_mesh(shape, cfg.n_heads, cfg.n_kv_heads)
    stage = shape.get('stage', 1)
    if stage > 1:
        pipeline.check_layers(cfg.n_layers, stage)
        if batch is not None:
            rows = batch // (shape.get('data', 1) * shape.get('fsdp', 1))
            pipeline.microbatch_rows(
                rows, pipeline.default_num_microbatches(batch, stage))
    expert = shape.get('expert', 1)
    if cfg.is_moe and cfg.num_experts % expert:
        raise ValueError(f'expert={expert} does not divide the '
                         f'{cfg.num_experts} experts')


@dataclasses.dataclass(frozen=True)
class LeafShard:
    """One leaf's place on a training mesh: per dim the number of blocks
    and this rank's index, the mesh axes that split it (degree > 1), and
    the rank's groups. A leaf whole on every rank has no axes."""
    par: TensorParallel
    splits: Tuple[Tuple[int, int], ...]
    axes: Tuple[str, ...]

    @classmethod
    def of(cls, sharding: NamedSharding, par: TensorParallel,
           ndim: int) -> 'LeafShard':
        import torch.distributed as dist
        rank = dist.get_rank()
        axes = []
        for entry in sharding.spec:
            for axis in ((entry,) if isinstance(entry, str)
                         else tuple(entry or ())):
                if sharding.mesh.shape[axis] > 1:
                    axes.append(axis)
        return cls(par, tuple(sharding.split(d, rank) for d in range(ndim)),
                   tuple(axes))

    def full_shape(self, local: Tuple[int, ...]) -> Tuple[int, ...]:
        if not self.axes:
            return tuple(local)
        return tuple(n * c for n, (c, _) in zip(local, self.splits))

    def sum_(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the leaf's shard groups."""
        for axis in self.axes:
            x = self.par.all_reduce(x, axis=axis)
        return x

    def mean(self, x: torch.Tensor, dim: Optional[int] = None
             ) -> torch.Tensor:
        """``torch.mean`` of the whole leaf from this rank's block ``x``:
        over everything, or along ``dim`` (whole on every rank), the sums
        in fp32, the result in ``x``'s dtype."""
        if not self.axes:
            return torch.mean(x) if dim is None else torch.mean(x, dim=dim)
        full = self.full_shape(tuple(x.shape))
        if dim is None:
            return (self.sum_(x.float().sum()) / math.prod(full)).to(x.dtype)
        whole = x.new_zeros(full[:dim] + full[dim + 1:], dtype=torch.float32)
        self.block(whole, dim).copy_(x.float().sum(dim))
        return (self.sum_(whole) / full[dim]).to(x.dtype)

    def block(self, whole: torch.Tensor, dropped: int) -> torch.Tensor:
        """This rank's block (a view) of ``whole``, an array of the
        leaf's full shape without dim ``dropped``."""
        splits = self.splits[:dropped] + self.splits[dropped + 1:]
        for d, (count, index) in enumerate(splits):
            if count > 1:
                size = whole.shape[d] // count
                whole = whole.narrow(d, index * size, size)
        return whole


# A leaf off any mesh.
_WHOLE = LeafShard(TensorParallel(), (), ())


def _layout(mesh: Optional[Mesh], cfg: ModelConfig, hp: 'TrainHParams',
            par: Optional[TensorParallel]) -> Optional[List[LeafShard]]:
    """Each param's ``LeafShard`` under ``state_shardings``, in
    ``_leaves`` order (None off a mesh)."""
    if par is None:
        return None
    sh = _leaves(state_shardings(mesh, cfg, hp).params)
    shapes = _leaves(llama.param_shapes(cfg))
    return [LeafShard.of(s, par, t.dim()) for s, t in zip(sh, shapes)]


def state_shardings(mesh: Mesh, cfg: ModelConfig, hp: 'TrainHParams',
                    rules: LogicalAxisRules = DEFAULT_RULES
                    ) -> 'TrainState':
    """A TrainState of ``NamedSharding``: the params under the rules; an
    optimizer leaf mirrors the param whose key path is the longest
    suffix of its own only when its shape is that param's exactly
    (AdamW's mu and nu, Adafactor's unfactored v), whatever other param
    shares the shape (d_ff == d_model makes ``wi_gate`` and ``mlp.wo``
    the same shape with transposed shardings); every other leaf
    (Adafactor's v_row and v_col, the counts) is whole on every rank."""
    param_sh = param_shardings(mesh, llama.param_logical_axes(cfg), rules)
    shapes = llama.param_shapes(cfg)
    replicated = NamedSharding(mesh, PartitionSpec())
    flat_sh = dict(_paths(param_sh))
    flat_shape = dict(_paths(shapes))
    opt = make_optimizer(hp).init(shapes)

    def mirror(node, path):
        if isinstance(node, dict):
            return {k: mirror(v, path + (k,)) for k, v in node.items()}
        for start in range(len(path)):
            suffix = path[start:]
            if suffix in flat_sh:
                if tuple(flat_shape[suffix].shape) == tuple(node.shape):
                    return flat_sh[suffix]
                break
        return replicated

    opt_sh = {k: (replicated if not isinstance(v, dict) else mirror(v, (k,)))
              for k, v in opt.items()}
    return TrainState(step=replicated, params=param_sh, opt_state=opt_sh)


def _paths(tree: Params, prefix: Tuple[str, ...] = ()):
    """(key path, leaf) pairs of a dict tree."""
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _paths(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _batch_rows(batch: Dict[str, Any], par: TensorParallel
                ) -> Dict[str, Any]:
    """This rank's rows of every [B, S] entry of a global batch (rule
    'batch': over (data, fsdp), data major) and, under ``seq``, its block
    of their columns (rule 'act_seq'; a ValueError when ``seq`` does not
    divide them)."""
    out = {}
    for key, value in batch.items():
        rows = value.shape[0]
        if rows % par.batch_degree:
            raise ValueError(f'batch {key} of {rows} rows does not divide '
                             f'over data x fsdp = {par.batch_degree}')
        n = rows // par.batch_degree
        out[key] = seq_shard(
            value[par.batch_index * n:(par.batch_index + 1) * n], par)
    return out


def _square_sums(grads: List[torch.Tensor],
                 layout: Optional[List[LeafShard]]) -> List[torch.Tensor]:
    """Each leaf's fp32 sum of squares over the WHOLE gradient: a
    sharded leaf's blocks summed over its shard groups, a leaf whole on
    every rank counted once (its copies off index 0 of an axis that does
    not split it add zeros; the adds are exact)."""
    sums = [torch.sum(torch.square(g.float())) for g in grads]
    if layout is None:
        return sums
    par = layout[0].par
    vec = torch.stack(sums)
    for axis in ('stage', 'fsdp', 'expert', 'tensor'):
        _, degree, index = par.axis(axis)
        if degree == 1:
            continue
        keep = [1.0 if axis in leaf.axes or index == 0 else 0.0
                for leaf in layout]
        vec = par.all_reduce(vec * vec.new_tensor(keep), axis=axis)
    return list(vec.unbind())


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
    with a constant schedule is plain ``optax.adamw``. ``layout``: each
    leaf's ``LeafShard`` on a mesh (the moments are blocks like their
    params; only the clip's norm reduces).

    State: ``{'count': int, 'mu': params-like, 'nu': params-like}``."""

    def __init__(self, hp: TrainHParams,
                 schedule: Optional[Callable[[int], float]] = None,
                 clip: bool = True,
                 layout: Optional[List[LeafShard]] = None):
        self.hp = hp
        self.eps = 1e-8        # optax.adamw defaults
        self.eps_root = 0.0
        self.schedule = schedule or _schedule(hp)
        self.clip = clip
        self.layout = layout

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
            g_norm = torch.sqrt(sum(_square_sums(grads, self.layout)))
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


def _global_norm(grads: List[torch.Tensor],
                 layout: Optional[List[LeafShard]] = None) -> torch.Tensor:
    """optax.global_norm: each leaf's sum of squares (accumulated in
    fp32, stored in the leaf's dtype), summed over the leaves in order,
    then the square root, all in that dtype."""
    total = sum(s.to(g.dtype)
                for s, g in zip(_square_sums(grads, layout), grads))
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
    optax's ``FactoredState`` names and shapes.

    ``layout``: each leaf's ``LeafShard`` on a mesh. A leaf factors as
    its WHOLE shape does; ``v`` is a block like its param, ``v_row`` and
    ``v_col`` are whole on every rank (their means over a split dim
    summed over the leaf's shard groups), and each leaf's update RMS and
    parameter RMS are over the whole leaf."""

    min_dim_size_to_factor = 128
    eps = 1e-30
    clipping_threshold = 1.0
    min_param_scale = 1e-3

    def __init__(self, hp: TrainHParams,
                 layout: Optional[List[LeafShard]] = None):
        self.hp = hp
        self.decay_rate = hp.b2
        self.schedule = _schedule(hp)
        self.layout = layout

    def _factored(self, shape) -> Optional[Tuple[int, int]]:
        return factored_dims(tuple(shape), self.min_dim_size_to_factor)

    def _whole(self, p: torch.Tensor,
               leaf: Optional[LeafShard]) -> Tuple[int, ...]:
        return tuple(p.shape) if leaf is None else leaf.full_shape(p.shape)

    def init(self, params: Params) -> Dict[str, Any]:
        def stats(which):
            def make(p, leaf):
                whole = self._whole(p, leaf)
                dims = self._factored(whole)
                shape = (1,)
                if which == 'v' and dims is None:
                    shape = tuple(p.shape)
                elif which != 'v' and dims is not None:
                    drop = dims[1] if which == 'v_row' else dims[0]
                    shape = tuple(n for i, n in enumerate(whole)
                                  if i != drop)
                return torch.zeros(shape, dtype=p.dtype, device=p.device)
            return _tree_map(make, params, self._leaf_iter(params))
        return {'count': 0, 'v_row': stats('v_row'),
                'v_col': stats('v_col'), 'v': stats('v')}

    def _leaf_iter(self, params: Params):
        return iter(self.layout or [None] * len(_leaves(params)))

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
        g_norm = _global_norm(grads, self.layout)
        clipped = g_norm >= hp.grad_clip_norm
        one = torch.ones_like(g_norm)
        divisor = torch.where(clipped, g_norm, one)
        factor = torch.where(clipped, one * hp.grad_clip_norm, one)
        count = state['count']
        beta, one_minus = self._decay(count)
        lr = self.schedule(count)
        for p, g, v_row, v_col, v, leaf in zip(
                _leaves(params), grads, _leaves(state['v_row']),
                _leaves(state['v_col']), _leaves(state['v']),
                self._leaf_iter(params)):
            dt = p.dtype
            leaf = leaf or _WHOLE
            g = g.to(dt) / divisor.to(dt) * factor.to(dt)
            g2 = g * g + _in_dtype(self.eps, dt)
            dims = self._factored(leaf.full_shape(p.shape))
            if dims is not None:
                d1, d0 = dims
                new_row = (v_row.float() * beta + leaf.mean(
                    g2, d0).float() * one_minus).to(dt)
                new_col = (v_col.float() * beta + leaf.mean(
                    g2, d1).float() * one_minus).to(dt)
                del g2
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_mean = torch.mean(new_row, dim=reduced_d1,
                                      keepdim=True)
                row_factor = (new_row / row_mean) ** -0.5
                col_factor = new_col ** -0.5
                u = g * leaf.block(row_factor, d0).unsqueeze(d0)
                u.mul_(leaf.block(col_factor, d1).unsqueeze(d1))
                v_row.copy_(new_row)
                v_col.copy_(new_col)
            else:
                new_v = (v.float() * beta + g2.float() * one_minus).to(dt)
                del g2
                u = g * new_v ** -0.5
                v.copy_(new_v)
            del g
            rms = torch.sqrt(leaf.mean(u * u))
            u.div_(torch.clamp_min(rms / self.clipping_threshold, 1.0))
            u.mul_(_in_dtype(lr, dt))
            p_rms = torch.sqrt(leaf.mean(p * p))
            u.mul_(torch.clamp_min(p_rms,
                                   _in_dtype(self.min_param_scale, dt)))
            u.add_(p * _in_dtype(hp.weight_decay, dt))
            p.sub_(u)
        return {'count': count + 1, 'v_row': state['v_row'],
                'v_col': state['v_col'], 'v': state['v']}, g_norm


Optimizer = Union[AdamW, Adafactor]


def make_optimizer(hp: TrainHParams,
                   layout: Optional[List[LeafShard]] = None) -> Optimizer:
    if hp.optimizer == 'adafactor':
        return Adafactor(hp, layout)
    if hp.optimizer != 'adamw':
        raise ValueError(f'Unknown optimizer {hp.optimizer!r} '
                         f"(expected 'adamw' or 'adafactor')")
    return AdamW(hp, layout=layout)


def _trainable(params: Params) -> Params:
    for leaf in _leaves(params):
        leaf.requires_grad_(True)
    return params


def create_train_state(seed: int, cfg: ModelConfig, hp: TrainHParams,
                       mesh: Optional[Mesh] = None, *,
                       device: Optional[Union[str, torch.device]] = None
                       ) -> TrainState:
    """Initialize params (``llama.init_params`` on the card, in
    ``cfg.param_dtype``) and the optimizer state. On a mesh every rank
    draws the whole init from the same seed and keeps its block, so the
    values are the one-device init's."""
    mesh_parallel(mesh, cfg)       # what the slice does not cover raises
    params = llama.init_params(seed, cfg, device=resolve_device(device))
    return create_train_state_from_params(params, cfg, hp, mesh)


def create_train_state_from_params(params: Params, cfg: ModelConfig,
                                   hp: TrainHParams,
                                   mesh: Optional[Mesh] = None
                                   ) -> TrainState:
    """TrainState around EXISTING params (finetuning a loaded
    checkpoint): one device trains them in place; on a mesh this rank
    keeps (copies of) its blocks."""
    par = mesh_parallel(mesh, cfg)
    if par is not None:
        import torch.distributed as dist
        params = shard_params_pytree(mesh, llama.param_logical_axes(cfg),
                                     params, rank=dist.get_rank())
    optimizer = make_optimizer(hp, _layout(mesh, cfg, hp, par))
    return TrainState(step=0, params=_trainable(params),
                      opt_state=optimizer.init(params))


def train_step_fn(state: TrainState, batch: Dict[str, torch.Tensor],
                  cfg: ModelConfig, optimizer: Optimizer, hp: TrainHParams,
                  pipeline_stages: int = 1,
                  parallel: Optional[TensorParallel] = None
                  ) -> Tuple[TrainState, Dict[str, Any]]:
    """One step. batch: tokens [B,S], targets [B,S], weights [B,S],
    optional positions and segments (on a mesh: this rank's rows;
    ``parallel`` its place, ``optimizer`` built on its layout).

    A MoE model (with ``router_aux_loss_coeff > 0``, no pipeline)
    optimizes ``total_loss = loss + coeff * router_aux``, the layer mean
    of the router load-balancing loss; ``loss`` stays the plain cross
    entropy, and ``router_aux`` is 0 for a dense model and under
    pipeline stages (``_pipeline_loss``)."""
    use_aux = (cfg.is_moe and cfg.router_aux_loss_coeff > 0
               and pipeline_stages == 1)
    leaves = _leaves(state.params)
    aux = None
    if pipeline_stages > 1:
        loss, grads = _pipeline_loss(state.params, batch, cfg, hp, leaves,
                                     pipeline_stages, parallel)
        total_loss = loss
    else:
        out = llama.forward(state.params, batch['tokens'], cfg,
                            positions=batch.get('positions'),
                            segments=batch.get('segments'),
                            return_aux=use_aux, parallel=parallel)
        logits, aux = out if use_aux else (out, None)
        loss, _ = cross_entropy_loss(logits, batch['targets'],
                                     batch.get('weights'),
                                     z_loss_coeff=hp.z_loss_coeff,
                                     parallel=parallel)
        del logits, out
        total_loss = loss
        if aux is not None:
            total_loss = loss + cfg.router_aux_loss_coeff * aux
        grads = list(torch.autograd.grad(total_loss, leaves))
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=loss.device)
    if parallel is not None:
        grads = _sum_grads(grads, optimizer.layout, parallel)
        grads = _stage_sum(grads, optimizer.layout, parallel)
        # This rank's loss is its share of the batch mean (under stages
        # the last stage's, zeros on the others); the aux is already the
        # whole batch's.
        loss = parallel.all_reduce(parallel.token_sum(
            loss.detach().clone()), axis='stage')
        total_loss = (loss if not use_aux else
                      loss + cfg.router_aux_loss_coeff * aux.detach())
    opt_state, grad_norm = optimizer.update_(state.params, grads,
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


def _pipeline_loss(params: Params, batch: Dict[str, torch.Tensor],
                   cfg: ModelConfig, hp: TrainHParams,
                   leaves: List[torch.Tensor], pipeline_stages: int,
                   parallel: Optional[TensorParallel]
                   ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """(loss, gradients) of this rank's share of a step under pipeline
    stages: each microbatch's cross entropy on the last stage over the
    weight sum of the WHOLE batch (one sum over ``tokens`` a step), so
    the microbatches' losses add up to the batch mean."""
    targets, weights = batch['targets'], batch.get('weights')
    if weights is None:
        weights = torch.ones(targets.shape, dtype=torch.float32,
                             device=targets.device)
    total = None
    if parallel is not None and parallel.stage_rank == parallel.stage - 1:
        total = torch.clamp(parallel.token_sum(weights.float().sum()),
                            min=1.0)

    def loss_of(logits: torch.Tensor, rows: slice) -> torch.Tensor:
        return cross_entropy_loss(logits, targets[rows], weights[rows],
                                  z_loss_coeff=hp.z_loss_coeff,
                                  parallel=parallel, total_weight=total)[0]

    return llama.pipeline_grads(
        params, batch['tokens'], cfg, loss_of, leaves,
        positions=batch.get('positions'), segments=batch.get('segments'),
        pipeline_stages=pipeline_stages,
        pipeline_microbatches=hp.pipeline_microbatches, parallel=parallel)


def _stage_sum(grads: List[torch.Tensor], layout: List[LeafShard],
               par: TensorParallel) -> List[torch.Tensor]:
    """Each gradient of a leaf that ``stage`` does not split (the
    embedding, the final norm, the LM head) summed over ``stage``: the
    stages that do not use it hold zeros."""
    if par.stage == 1:
        return grads
    return [g if 'stage' in leaf.axes else par.all_reduce(g, axis='stage')
            for g, leaf in zip(grads, layout)]


def _sum_grads(grads: List[torch.Tensor], layout: List[LeafShard],
               par: TensorParallel) -> List[torch.Tensor]:
    """Each gradient summed over the ranks that hold other tokens, in one
    all-reduce: an fsdp-sharded leaf's is already summed over fsdp (its
    gather's backward reduce-scatters) and is summed over ``replicas``
    (data x seq: every leaf is whole over seq, as over data), the rest
    over ``tokens`` (data x fsdp x seq). Nothing sums over ``expert``:
    its ranks hold the same tokens, and each rank's gradient of a leaf
    it holds whole there (the router, attention) is already whole."""
    return [par.all_reduce(g, axis='replicas' if 'fsdp' in leaf.axes
                           else 'tokens')
            for g, leaf in zip(grads, layout)]


def make_train_step(cfg: ModelConfig, hp: TrainHParams,
                    mesh: Optional[Mesh] = None
                    ) -> Callable[[TrainState, Dict[str, torch.Tensor]],
                                  Tuple[TrainState, Dict[str, Any]]]:
    """The train step (no jit: PyTorch runs eagerly). It takes the
    GLOBAL batch, as the reference's jitted step does: on a mesh each
    rank trains on its rows, and every rank returns the same metrics."""
    par = mesh_parallel(mesh, cfg)
    optimizer = make_optimizer(hp, _layout(mesh, cfg, hp, par))
    stages = 1 if par is None else par.stage

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        if par is not None:
            batch = _batch_rows(batch, par)
        return train_step_fn(state, batch, cfg, optimizer, hp,
                             pipeline_stages=stages, parallel=par)

    return step


def make_forward(cfg: ModelConfig, mesh: Optional[Mesh] = None):
    """An inference forward: (params, tokens) -> fp32 logits of the
    whole batch (on a mesh: the rank's shards and the global tokens; the
    rows and columns are gathered back on every rank)."""
    par = mesh_parallel(mesh, cfg)

    @torch.no_grad()
    def fwd(params: Params, tokens: torch.Tensor) -> torch.Tensor:
        if par is None:
            return llama.forward(params, tokens, cfg)
        rows = _batch_rows({'tokens': tokens}, par)['tokens']
        logits = par.all_gather(
            llama.forward(params, rows, cfg, pipeline_stages=par.stage,
                          parallel=par), -1, 'tensor')
        logits = par.all_gather(logits, 1, 'seq')
        return par.all_gather(par.all_gather(logits, 0, 'fsdp'), 0, 'data')

    return fwd
