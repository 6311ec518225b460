"""Logical-axis sharding rules: the port of
``skypilot_tpu/parallel/sharding.py``.

Model code names array dimensions with *logical* axes ('embed', 'mlp',
'heads', ...); a rule table maps them to mesh axes, so a parallelism
strategy is a rule-table edit, not a model edit. The rules, the spec
arithmetic and ``DEFAULT_RULES`` are the reference's.

Differences of idiom: the reference hands shardings to XLA, which
places the arrays and inserts the collectives. Here each rank is its
own process, so

* ``shard_params_pytree`` returns THIS rank's slice of every leaf under
  the rules (a W8A8 ``QTensor``'s int8 values and scales sliced
  consistently: a scale axis of size 1 stays whole); the reference's
  tree of shardings is ``param_shardings``;
* the collectives the model needs are explicit calls on the ambient
  ``TensorParallel`` (``models/decode.py``), which
  ``ambient_tensor_parallelism`` returns inside ``mesh_context(mesh)``,
  the counterpart of ``jax.sharding.set_mesh``: the engines enter it
  around their compute calls.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

from skypilot_tpu_torch.parallel.mesh import Mesh

MeshAxes = Union[None, str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """Per-dimension mesh axes: None (replicated), one axis name, or a
    tuple of names (sharded over their product, major to minor)."""

    def __new__(cls, *parts: MeshAxes) -> 'PartitionSpec':
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f'PartitionSpec{tuple.__repr__(self)}'


P = PartitionSpec


class LogicalAxisRules:
    """Ordered logical-axis -> mesh-axes mapping."""

    def __init__(self, rules: Dict[str, MeshAxes]) -> None:
        self._rules = dict(rules)

    def mesh_axes(self, logical: Optional[str]) -> MeshAxes:
        if logical is None:
            return None
        if logical not in self._rules:
            raise KeyError(f'No sharding rule for logical axis {logical!r}. '
                           f'Known: {sorted(self._rules)}')
        return self._rules[logical]

    def spec(self, logical_axes: Sequence[Optional[str]]) -> PartitionSpec:
        """('batch', None, 'embed') -> P(('data','fsdp'), None, 'tensor').
        A mesh axis appears at most once: later occurrences replicate."""
        out = []
        used = set()
        for ax in logical_axes:
            mesh_ax = self.mesh_axes(ax)
            if mesh_ax is None:
                out.append(None)
                continue
            axes = (mesh_ax,) if isinstance(mesh_ax, str) else tuple(mesh_ax)
            axes = tuple(a for a in axes if a not in used)
            used.update(axes)
            if not axes:
                out.append(None)
            elif len(axes) == 1:
                out.append(axes[0])
            else:
                out.append(axes)
        return PartitionSpec(*out)

    def replace(self, **updates: MeshAxes) -> 'LogicalAxisRules':
        new = dict(self._rules)
        new.update(updates)
        return LogicalAxisRules(new)


# Default rules for the decoder LMs in models/ (the reference's):
#   params:     embed->fsdp, mlp/heads/vocab->tensor, layers->stage (PP)
#   activations: batch->(data,fsdp), seq->seq (context parallel),
#                heads->tensor, experts->expert
DEFAULT_RULES = LogicalAxisRules({
    # activation axes
    'batch': ('data', 'fsdp'),
    'act_seq': 'seq',
    'act_embed': None,
    'act_heads': 'tensor',
    'act_kv_heads': 'tensor',
    # parameter axes
    'embed': 'fsdp',
    'mlp': 'tensor',
    'heads': 'tensor',
    'kv_heads': 'tensor',
    'head_dim': None,
    'vocab': 'tensor',
    'layers': 'stage',
    'expert': 'expert',
    'norm': None,
})


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec over a mesh: which part of an array each rank holds."""
    mesh: Mesh
    spec: PartitionSpec

    def split(self, dim: int, rank: int) -> Tuple[int, int]:
        """(number of shards, this rank's shard index) along ``dim``."""
        entry = self.spec[dim] if dim < len(self.spec) else None
        if entry is None:
            return 1, 0
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        coords = self.mesh.coords(rank)
        count, index = 1, 0
        for axis in axes:
            size = self.mesh.shape[axis]
            count *= size
            index = index * size + coords[axis]
        return count, index

    def slice(self, x: torch.Tensor, rank: int) -> torch.Tensor:
        """Rank ``rank``'s block of ``x`` (a copy when it is a part)."""
        out = x
        for dim in range(x.dim()):
            count, index = self.split(dim, rank)
            if count == 1 or x.shape[dim] == 1:
                continue
            if x.shape[dim] % count:
                raise ValueError(
                    f'dimension {dim} of size {x.shape[dim]} does not '
                    f'divide over {count} shards ({self.spec})')
            size = x.shape[dim] // count
            out = out.narrow(dim, index * size, size)
        return out if out is x else out.clone()

    def full_shape(self, local: Sequence[int]) -> Tuple[int, ...]:
        """The whole array's shape from a block's (``gather``'s)."""
        shape = list(local)
        for dim, entry in enumerate(self.spec[:len(shape)]):
            for axis in ((entry,) if isinstance(entry, str)
                         else tuple(entry or ())):
                shape[dim] *= self.mesh.shape[axis]
        return tuple(shape)

    def gather(self, x: torch.Tensor, tp: 'TensorParallel') -> torch.Tensor:
        """The whole array from this rank's block ``x``: along each
        sharded dim, the blocks of the dim's mesh axes joined, minor
        axis first (collective over those axes)."""
        x = x.detach()
        for dim in range(x.dim()):
            entry = self.spec[dim] if dim < len(self.spec) else None
            if entry is None:
                continue
            axes = (entry,) if isinstance(entry, str) else tuple(entry)
            for axis in reversed(axes):
                if self.mesh.shape[axis] > 1:
                    x = tp.all_gather(x, dim, axis)
        return x


def logical_sharding(mesh: Mesh, logical_axes: Sequence[Optional[str]],
                     rules: LogicalAxisRules = DEFAULT_RULES
                     ) -> NamedSharding:
    return NamedSharding(mesh, rules.spec(logical_axes))


def _map_axes(fn, axes_tree):
    if isinstance(axes_tree, dict):
        return {k: _map_axes(fn, v) for k, v in axes_tree.items()}
    return fn(axes_tree)


def param_shardings(mesh: Mesh, logical_axes_tree,
                     rules: LogicalAxisRules = DEFAULT_RULES):
    """A tree of ``NamedSharding`` mirroring ``logical_axes_tree`` (each
    leaf a tuple of logical axis names): what the reference's
    ``shard_params_pytree`` returns."""
    return _map_axes(lambda axes: logical_sharding(mesh, axes, rules),
                     logical_axes_tree)


def shard_params_pytree(mesh: Mesh, logical_axes_tree, params, *,
                        rank: int,
                        rules: LogicalAxisRules = DEFAULT_RULES):
    """Rank ``rank``'s slice of every leaf of ``params`` under the
    rules. A ``QTensor`` (``models/quant.py``) slices its int8 values
    and its scales alike; a scale axis of size 1 (a contracted axis)
    stays whole on every rank."""
    def walk(axes, node):
        if isinstance(node, dict):
            return {k: walk(axes[k], v) for k, v in node.items()}
        return shard_leaf(logical_sharding(mesh, axes, rules), node, rank)

    return walk(logical_axes_tree, params)


def shard_leaf(sharding: NamedSharding, node: Any, rank: int) -> Any:
    """Rank ``rank``'s slice of one leaf (a tensor or a ``QTensor``)."""
    from skypilot_tpu_torch.models.quant import QTensor
    if isinstance(node, QTensor):
        return QTensor(sharding.slice(node.q, rank),
                       sharding.slice(node.scale, rank))
    return sharding.slice(node, rank)


# ---------------------------------------------------------------------------
# This rank's groups: the tensor axis (serving and training), the batch
# axes data and fsdp, the sequence axis seq, the expert axis and the
# pipeline axis stage (training)
# ---------------------------------------------------------------------------

_collective_time = {'calls': 0, 'seconds': 0.0, 'timed': False}
_collective_kinds: Dict[str, int] = {}
_collective_kind_seconds: Dict[str, float] = {}


def time_collectives(enabled: bool) -> None:
    """Time every collective of ``TensorParallel`` (host wall clock,
    the device synchronized before and after each, so the time is the
    collective's own) into ``collective_stats()``; off by default."""
    _collective_time['timed'] = bool(enabled)


def collective_stats(reset: bool = False) -> Dict[str, Any]:
    """Calls and seconds (timed ones) of every collective since the last
    reset, and both by kind and axis (``'all_gather fsdp'``, ...)."""
    out = {'calls': _collective_time['calls'],
           'seconds': _collective_time['seconds'],
           'by_kind': dict(_collective_kinds),
           'seconds_by_kind': dict(_collective_kind_seconds)}
    if reset:
        _collective_time['calls'] = 0
        _collective_time['seconds'] = 0.0
        _collective_kinds.clear()
        _collective_kind_seconds.clear()
    return out


# Mesh axes a rank of a training mesh keeps a group for.
TRAIN_AXES = ('data', 'stage', 'fsdp', 'seq', 'expert', 'tensor')


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """This rank's place on the mesh. ``group``, ``degree`` and ``rank``
    are the ``tensor`` axis (what serving uses: its process group, the
    degree and this rank's index along it; ``group`` None at degree 1);
    ``data_*``, ``fsdp_*``, ``seq_*``, ``expert_*`` and ``stage_*`` the
    same for the batch axes, the sequence axis, the expert axis and the
    pipeline axis of a training mesh. Three groups span several axes,
    so that a sum over them is one collective: ``tokens`` (data x fsdp x seq, every rank that holds
    other tokens of the batch), ``replicas`` (data x seq, the ranks that
    hold the same fsdp block of a leaf) and ``experts`` (expert x
    tensor, the ranks that hold other experts or other FFN columns of
    one token's MoE output). Every collective names its axis or group
    and is a no-op at degree 1."""
    mesh: Optional[Mesh] = None
    group: Any = None
    degree: int = 1
    rank: int = 0
    data_group: Any = None
    data: int = 1
    data_rank: int = 0
    fsdp_group: Any = None
    fsdp: int = 1
    fsdp_rank: int = 0
    seq_group: Any = None
    seq: int = 1
    seq_rank: int = 0
    expert_group: Any = None
    expert: int = 1
    expert_rank: int = 0
    stage_group: Any = None
    stage: int = 1
    stage_rank: int = 0
    tokens_group: Any = None
    tokens: int = 1
    replicas_group: Any = None
    replicas: int = 1
    experts_group: Any = None
    experts: int = 1

    def axis(self, name: str) -> Tuple[Any, int, int]:
        """(group, degree, this rank's index) along ``name``: a mesh axis
        or one of the groups ``'tokens'``, ``'replicas'`` and
        ``'experts'``."""
        if name == 'tensor':
            return self.group, self.degree, self.rank
        if name == 'data':
            return self.data_group, self.data, self.data_rank
        if name == 'fsdp':
            return self.fsdp_group, self.fsdp, self.fsdp_rank
        if name == 'seq':
            return self.seq_group, self.seq, self.seq_rank
        if name == 'expert':
            return self.expert_group, self.expert, self.expert_rank
        if name == 'stage':
            return self.stage_group, self.stage, self.stage_rank
        if name == 'tokens':
            return (self.tokens_group, self.tokens,
                    self.batch_index * self.seq + self.seq_rank)
        if name == 'replicas':
            return (self.replicas_group, self.replicas,
                    self.data_rank * self.seq + self.seq_rank)
        if name == 'experts':
            return (self.experts_group, self.experts,
                    self.expert_rank * self.degree + self.rank)
        raise ValueError(f'no group for mesh axis {name!r}')

    @property
    def batch_degree(self) -> int:
        """Shards of the batch: data x fsdp (rule 'batch')."""
        return self.data * self.fsdp

    @property
    def batch_index(self) -> int:
        """This rank's block of the batch, data major."""
        return self.data_rank * self.fsdp + self.fsdp_rank

    def token_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over every rank that holds other tokens of the
        batch, its rows (data x fsdp) and its columns (seq), in one
        all-reduce over ``tokens`` (in place)."""
        return self.all_reduce(x, axis='tokens')

    def _run(self, x: torch.Tensor, call, kind: str) -> torch.Tensor:
        timed = _collective_time['timed']
        if timed:
            if x.is_cuda:
                torch.cuda.synchronize(x.device)
            t0 = time.perf_counter()
        call()
        _collective_time['calls'] += 1
        _collective_kinds[kind] = _collective_kinds.get(kind, 0) + 1
        if timed:
            if x.is_cuda:
                torch.cuda.synchronize(x.device)
            took = time.perf_counter() - t0
            _collective_time['seconds'] += took
            _collective_kind_seconds[kind] = \
                _collective_kind_seconds.get(kind, 0.0) + took
        return x

    def all_reduce(self, x: torch.Tensor, op: str = 'sum',
                   axis: str = 'tensor') -> torch.Tensor:
        """In place over the axis's group: ``'sum'`` or ``'max'``."""
        import torch.distributed as dist
        group, degree, _ = self.axis(axis)
        if degree == 1:
            return x
        reduce_op = {'sum': dist.ReduceOp.SUM, 'max': dist.ReduceOp.MAX}[op]
        x = x.contiguous()
        return self._run(x, lambda: dist.all_reduce(x, op=reduce_op,
                                                    group=group),
                         f'all_reduce {axis}')

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """In place from the tensor group's index ``src``."""
        import torch.distributed as dist
        root = dist.get_global_rank(self.group, src)
        return self._run(x, lambda: dist.broadcast(x, src=root,
                                                   group=self.group),
                         'broadcast tensor')

    def all_gather(self, x: torch.Tensor, dim: int,
                   axis: str) -> torch.Tensor:
        """The axis's shards of ``x`` joined along ``dim`` in index
        order (a new tensor)."""
        import torch.distributed as dist
        group, degree, _ = self.axis(axis)
        if degree == 1:
            return x
        front = x.movedim(dim, 0).contiguous()
        out = front.new_empty((degree * front.shape[0],) + front.shape[1:])
        self._run(out, lambda: dist.all_gather_into_tensor(
            out, front, group=group), f'all_gather {axis}')
        return out.movedim(0, dim)

    def ring_shift(self, xs: Sequence[torch.Tensor],
                   axis: str = 'seq') -> List[torch.Tensor]:
        """One hop of the ring along ``axis``, the reference's
        ``ppermute`` with ``perm = [(i, (i + 1) % n)]``: each tensor of
        ``xs`` goes to the next index and this rank gets the previous
        index's (new tensors), all in one batch of point-to-point ops.
        Under ``gloo`` a CUDA tensor is staged through a host copy here,
        explicitly: gloo's send and receive move host memory (its
        collectives stage CUDA tensors themselves)."""
        import torch.distributed as dist
        group, degree, index = self.axis(axis)
        if degree == 1:
            return list(xs)
        staged = (any(x.is_cuda for x in xs) and
                  dist.get_backend(group) == 'gloo')
        sends = [x.detach().contiguous() for x in xs]
        if staged:
            sends = [x.cpu() for x in sends]
        recvs = [torch.empty_like(x) for x in sends]
        dst = dist.get_global_rank(group, (index + 1) % degree)
        src = dist.get_global_rank(group, (index - 1) % degree)

        def hop():
            ops = [dist.P2POp(dist.isend, x, dst, group=group)
                   for x in sends]
            ops += [dist.P2POp(dist.irecv, x, src, group=group)
                    for x in recvs]
            for work in dist.batch_isend_irecv(ops):
                work.wait()

        self._run(recvs[0], hop, f'ring_shift {axis}')
        if staged:
            return [y.to(x.device) for x, y in zip(xs, recvs)]
        return recvs

    def _peer(self, axis: str, hop: int) -> Tuple[Any, int, bool]:
        """(group, global rank of the index ``hop`` away along ``axis``,
        whether CUDA tensors go through the host): not cyclic, so a hop
        past either end raises."""
        import torch.distributed as dist
        group, degree, index = self.axis(axis)
        if not 0 <= index + hop < degree:
            raise ValueError(f'index {index} of {axis}={degree} has no peer '
                             f'{hop:+d} away')
        return (group, dist.get_global_rank(group, index + hop),
                dist.get_backend(group) == 'gloo')

    def send_to(self, x: torch.Tensor, hop: int, tag: int,
                axis: str = 'stage') -> Callable[[], None]:
        """Start sending ``x`` to the rank ``hop`` indices along ``axis``
        (+1 the next stage, -1 the previous one), tagged ``tag`` (a
        microbatch's index: only the receive that names the same tag
        takes it). Returns the send's wait (its work holds the sent
        buffer until then). Under ``gloo`` a CUDA tensor is staged
        through a host copy, as in ``ring_shift``."""
        import torch.distributed as dist
        group, dst, gloo = self._peer(axis, hop)
        send = x.detach().contiguous()
        if send.is_cuda and gloo:
            send = send.cpu()
        works = []
        self._run(send, lambda: works.append(
            dist.isend(send, dst, group=group, tag=tag)), f'send {axis}')
        return works[0].wait

    def recv_from(self, shape: Sequence[int], dtype: torch.dtype,
                  device: torch.device, hop: int, tag: int,
                  axis: str = 'stage') -> torch.Tensor:
        """The tensor that the rank ``hop`` indices along ``axis`` sends
        with ``tag`` (a new tensor on ``device``); blocks until it
        arrives, so under ``time_collectives`` its time includes the
        wait for the sender."""
        import torch.distributed as dist
        group, src, gloo = self._peer(axis, hop)
        staged = torch.device(device).type == 'cuda' and gloo
        out = torch.empty(tuple(shape), dtype=dtype,
                          device='cpu' if staged else device)
        self._run(out, lambda: dist.recv(out, src, group=group, tag=tag),
                  f'recv {axis}')
        return out.to(device) if staged else out

    def all_to_all(self, x: torch.Tensor, split_dim: int, concat_dim: int,
                   axis: str = 'seq') -> torch.Tensor:
        """The reference's tiled ``lax.all_to_all``: ``x`` cut into the
        axis's degree blocks along ``split_dim``, block j sent to index
        j, and the blocks received joined along ``concat_dim`` in index
        order (a new tensor)."""
        import torch.distributed as dist
        group, degree, _ = self.axis(axis)
        if degree == 1:
            return x
        if x.shape[split_dim] % degree:
            raise ValueError(f'dimension {split_dim} of size '
                             f'{x.shape[split_dim]} does not split over '
                             f'{axis}={degree}')
        # Block j of the split dim first, so each peer's block is one
        # contiguous slab of the flat buffer.
        parts = x.unflatten(split_dim, (degree, -1)).movedim(split_dim, 0)
        send = parts.contiguous()
        recv = torch.empty_like(send)
        self._run(recv, lambda: dist.all_to_all_single(recv, send,
                                                       group=group),
                  f'all_to_all {axis}')
        # recv[j] is peer j's block: join the peers along concat_dim
        # (one past its index in the [degree, ...] layout).
        return recv.movedim(0, concat_dim).flatten(concat_dim,
                                                   concat_dim + 1)

    def reduce_scatter(self, x: torch.Tensor, dim: int,
                       axis: str) -> torch.Tensor:
        """The sum of ``x`` over the axis's group, this rank's block of
        it along ``dim`` (a new tensor)."""
        import torch.distributed as dist
        group, degree, _ = self.axis(axis)
        if degree == 1:
            return x
        front = x.movedim(dim, 0).contiguous()
        out = front.new_empty((front.shape[0] // degree,) + front.shape[1:])
        self._run(out, lambda: dist.reduce_scatter_tensor(
            out, front, group=group), f'reduce_scatter {axis}')
        return out.movedim(0, dim)


class _CopyTo(torch.autograd.Function):
    """Megatron's f: identity forward; the backward sums the gradient
    over the axis's group (each rank's heads, columns or experts give a
    part of it)."""

    @staticmethod
    def forward(ctx, x, tp, axis):
        ctx.tp, ctx.axis = tp, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.tp.all_reduce(grad.clone(), axis=ctx.axis), None, None


class _ReduceFrom(torch.autograd.Function):
    """Megatron's g: the forward sums the partial results over the
    axis's group; identity backward."""

    @staticmethod
    def forward(ctx, x, tp, axis):
        return tp.all_reduce(x.clone(), axis=axis)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _GatherFsdp(torch.autograd.Function):
    """A parameter's fsdp shard, cast to ``dtype``, gathered whole along
    its ``embed`` dim; the backward sums the gradient over the fsdp group
    in fp32 and keeps this rank's block, in the shard's dtype."""

    @staticmethod
    def forward(ctx, shard, tp, dim, dtype):
        ctx.tp, ctx.dim, ctx.dtype = tp, dim, shard.dtype
        return tp.all_gather(shard.to(dtype), dim, 'fsdp')

    @staticmethod
    def backward(ctx, grad):
        part = ctx.tp.reduce_scatter(grad.float(), ctx.dim, 'fsdp')
        return part.to(ctx.dtype), None, None, None


def copy_to_tensor(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """The input of column-parallel projections (``wq``/``wk``/``wv``,
    ``wi_*``, the LM head)."""
    return x if tp.degree == 1 else _CopyTo.apply(x, tp, 'tensor')


def reduce_from_tensor(x: torch.Tensor,
                       tp: TensorParallel) -> torch.Tensor:
    """The output of row-parallel projections (``wo``, ``mlp.wo``) and
    of the vocab-sharded embedding lookup."""
    return x if tp.degree == 1 else _ReduceFrom.apply(x, tp, 'tensor')


def copy_to_experts(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """f over ``experts`` (expert x tensor): a MoE block's input to this
    rank's experts and columns, and its routing weights; each rank's
    gradient into them is the part its experts and columns give."""
    return x if tp.experts == 1 else _CopyTo.apply(x, tp, 'experts')


def reduce_from_experts(x: torch.Tensor,
                        tp: TensorParallel) -> torch.Tensor:
    """g over ``experts``: a MoE block's output, summed over the ranks
    that hold its other experts and columns."""
    return x if tp.experts == 1 else _ReduceFrom.apply(x, tp, 'experts')


def reduce_from_tokens(x: torch.Tensor,
                       tp: TensorParallel) -> torch.Tensor:
    """g over ``tokens``: a statistic of this rank's tokens summed over
    the batch. Its backward is the identity, so each rank's gradient is
    its own tokens' part and the gradient sums over ``tokens``
    (``train/step._sum_grads``) count the whole once."""
    return x if tp.tokens == 1 else _ReduceFrom.apply(x, tp, 'tokens')


def gather_fsdp(shard: torch.Tensor, tp: TensorParallel, dim: int,
                dtype: torch.dtype) -> torch.Tensor:
    """``shard.to(dtype)`` whole along ``dim`` over the fsdp group."""
    if tp.fsdp == 1:
        return shard.to(dtype)
    return _GatherFsdp.apply(shard, tp, dim, dtype)


def gather_params_pytree(shardings, params, tp: TensorParallel):
    """The whole arrays of a tree of this rank's blocks under a tree of
    ``NamedSharding`` (collective over the blocks' axes; ints pass)."""
    if isinstance(params, dict):
        return {k: gather_params_pytree(shardings[k], v, tp)
                for k, v in params.items()}
    if not isinstance(params, torch.Tensor):
        return params
    return shardings.gather(params, tp)


_SINGLE = TensorParallel()
_ambient = threading.local()


def tensor_parallel_of(mesh: Optional[Mesh]) -> TensorParallel:
    """The ``TensorParallel`` of this process's rank on ``mesh``: a group
    for each of its ``data``, ``stage``, ``fsdp``, ``seq``, ``expert``
    and ``tensor`` axes above degree 1, and the ``tokens``, ``replicas`` and
    ``experts`` groups (one axis's group where only one of theirs is
    above 1; every rank must call it: the groups are built
    collectively)."""
    if mesh is None or all(mesh.shape.get(a, 1) <= 1 for a in TRAIN_AXES):
        return TensorParallel(mesh=mesh)
    import torch.distributed as dist
    coords = mesh.coords(dist.get_rank())
    fields, groups = {}, {}
    for axis, prefix in (('tensor', ''), ('data', 'data_'),
                         ('fsdp', 'fsdp_'), ('seq', 'seq_'),
                         ('expert', 'expert_'), ('stage', 'stage_')):
        size = mesh.shape.get(axis, 1)
        if size > 1:
            groups[axis] = fields[prefix + 'group'] = mesh.group(axis)
            fields['degree' if axis == 'tensor' else axis] = size
            fields['rank' if axis == 'tensor' else prefix + 'rank'] = \
                coords[axis]
    for name, axes in (('tokens', ('data', 'fsdp', 'seq')),
                       ('replicas', ('data', 'seq')),
                       ('experts', ('expert', 'tensor'))):
        split = [a for a in axes if a in groups]
        if split:
            fields[name] = math.prod(mesh.shape[a] for a in split)
            fields[name + '_group'] = (groups[split[0]] if len(split) == 1
                                       else mesh.group_over(split))
    return TensorParallel(mesh=mesh, **fields)


def ambient_tensor_parallelism() -> TensorParallel:
    """The innermost ``mesh_context``'s ``TensorParallel`` on this
    thread (degree 1 outside any)."""
    stack = getattr(_ambient, 'stack', None)
    return stack[-1] if stack else _SINGLE


@contextlib.contextmanager
def mesh_context(tp: Optional[TensorParallel]):
    """Make ``tp`` ambient on this thread for the body (a no-op for
    None): the counterpart of ``jax.sharding.set_mesh``."""
    if tp is None:
        yield
        return
    stack = getattr(_ambient, 'stack', None)
    if stack is None:
        stack = _ambient.stack = []
    stack.append(tp)
    try:
        yield
    finally:
        stack.pop()


def divides(total: int, degree: int, what: str) -> int:
    """``total // degree``, or a ValueError naming ``what``."""
    if total % degree:
        raise ValueError(f'{what} ({total}) does not divide over '
                         f'tensor={degree}')
    return total // degree

