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
import threading
import time
from typing import Any, Dict, Optional, Sequence, Tuple, Union

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

    def _split(self, dim: int, rank: int) -> Tuple[int, int]:
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
            count, index = self._split(dim, rank)
            if count == 1 or x.shape[dim] == 1:
                continue
            if x.shape[dim] % count:
                raise ValueError(
                    f'dimension {dim} of size {x.shape[dim]} does not '
                    f'divide over {count} shards ({self.spec})')
            size = x.shape[dim] // count
            out = out.narrow(dim, index * size, size)
        return out if out is x else out.clone()


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
    from skypilot_tpu_torch.models.quant import QTensor

    def walk(axes, node):
        if isinstance(node, dict):
            return {k: walk(axes[k], v) for k, v in node.items()}
        sharding = logical_sharding(mesh, axes, rules)
        if isinstance(node, QTensor):
            return QTensor(sharding.slice(node.q, rank),
                           sharding.slice(node.scale, rank))
        return sharding.slice(node, rank)

    return walk(logical_axes_tree, params)


# ---------------------------------------------------------------------------
# The ambient tensor-parallel group
# ---------------------------------------------------------------------------

_collective_time = {'calls': 0, 'seconds': 0.0, 'timed': False}


def time_collectives(enabled: bool) -> None:
    """Time every collective of ``TensorParallel`` (host wall clock,
    the device synchronized before and after each, so the time is the
    collective's own) into ``collective_stats()``; off by default."""
    _collective_time['timed'] = bool(enabled)


def collective_stats(reset: bool = False) -> Dict[str, float]:
    out = {'calls': _collective_time['calls'],
           'seconds': _collective_time['seconds']}
    if reset:
        _collective_time['calls'] = 0
        _collective_time['seconds'] = 0.0
    return out


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """This rank's place on the ``tensor`` axis: its process group, the
    degree and its index along the axis (``group`` None at degree 1)."""
    mesh: Optional[Mesh] = None
    group: Any = None
    degree: int = 1
    rank: int = 0

    def _run(self, x: torch.Tensor, call) -> torch.Tensor:
        timed = _collective_time['timed']
        if timed:
            if x.is_cuda:
                torch.cuda.synchronize(x.device)
            t0 = time.perf_counter()
        call()
        _collective_time['calls'] += 1
        if timed:
            if x.is_cuda:
                torch.cuda.synchronize(x.device)
            _collective_time['seconds'] += time.perf_counter() - t0
        return x

    def all_reduce(self, x: torch.Tensor, op: str = 'sum') -> torch.Tensor:
        """In place over the group: ``'sum'`` or ``'max'``."""
        import torch.distributed as dist
        reduce_op = {'sum': dist.ReduceOp.SUM, 'max': dist.ReduceOp.MAX}[op]
        x = x.contiguous()
        return self._run(x, lambda: dist.all_reduce(x, op=reduce_op,
                                                    group=self.group))

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """In place from the group's index ``src``."""
        import torch.distributed as dist
        root = dist.get_global_rank(self.group, src)
        return self._run(x, lambda: dist.broadcast(x, src=root,
                                                   group=self.group))


_SINGLE = TensorParallel()
_ambient = threading.local()


def tensor_parallel_of(mesh: Optional[Mesh]) -> TensorParallel:
    """The ``TensorParallel`` of this process's rank on ``mesh``."""
    if mesh is None or mesh.shape.get('tensor', 1) <= 1:
        return TensorParallel(mesh=mesh)
    import torch.distributed as dist
    return TensorParallel(mesh=mesh, group=mesh.group('tensor'),
                          degree=mesh.shape['tensor'],
                          rank=mesh.coords(dist.get_rank())['tensor'])


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

