"""Checkpoint save/restore and the resume pattern: the port of
``skypilot_tpu/train/checkpoint.py``.

A checkpoint directory holds one subdirectory per step, named by the
step number. Each holds ``state.safetensors``, every tensor of the train
state by its '/'-joined key (``step``, ``params/layers/attn/wq``,
``opt_state/count``, ``opt_state/v_row/embed/embedding``, ...; integers
as 0-dim int64 tensors), and the manifest of ``data/ckpt_manifest.py``.

The file is written and read by ``utils/safetensors_io.py`` (an 8-byte
little-endian header length, a JSON header of dtype, shape and byte
offsets per tensor, then the raw bytes), so any safetensors reader
reads it. The reference writes with orbax; reading its orbax
checkpoints is out of scope.

The commit protocol is the reference's: the shard file is written and
fsynced first, ``fault_injection.inject(COMMIT_SITE)`` runs next, and
the manifest is written last. ``latest_step`` reports committed steps
only: a save that died before its manifest, or a torn manifest, reads
as absent. After each commit the ``max_to_keep`` newest committed steps
are kept and older ones removed.

On a training mesh (``shardings``: the ``train/step.state_shardings`` of
the tree, each rank holding its blocks) every rank joins the gather of
each whole tensor, one at a time as rank 0 writes it (the same file and
manifest a one-card run writes), and a barrier follows; ``restore``
into any mesh reads the whole tensors and keeps each rank's blocks, so
a step written at one mesh resumes at another (the reference's
topology-change restore).
"""
from __future__ import annotations

import dataclasses
import functools
import logging
import os
import shutil
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from skypilot_tpu_torch.data import ckpt_manifest
from skypilot_tpu_torch.parallel.sharding import (NamedSharding,
                                                  tensor_parallel_of)
from skypilot_tpu_torch.utils import fault_injection
from skypilot_tpu_torch.utils.safetensors_io import (Deferred,
                                                    SafetensorsReader,
                                                    write_safetensors)

logger = logging.getLogger(__name__)

# Chaos site between the shard write and the manifest commit: a save
# killed here must stay invisible to ``latest_step``.
COMMIT_SITE = 'train.ckpt.commit'
SHARD_NAME = 'state.safetensors'


# ---------------------------------------------------------------------------
# safetensors files
# ---------------------------------------------------------------------------

def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """The tensors of a safetensors file, on the CPU (its
    ``__metadata__`` is skipped)."""
    with SafetensorsReader(path) as reader:
        return {name: reader.get(name).clone() for name in reader.keys()}


# ---------------------------------------------------------------------------
# Trees
# ---------------------------------------------------------------------------

def _as_dict(tree: Any) -> Any:
    """A TrainState (any dataclass) as a dict of its fields, shallowly:
    ``dataclasses.asdict`` would copy every tensor."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return {f.name: getattr(tree, f.name)
                for f in dataclasses.fields(tree)}
    return tree


def _flatten(tree: Any, prefix: str = '') -> Dict[str, Any]:
    if not isinstance(tree, NamedSharding):
        tree = _as_dict(tree)
    if isinstance(tree, dict):
        out: Dict[str, Any] = {}
        for key in sorted(tree):
            out.update(_flatten(tree[key], f'{prefix}{key}/'))
        return out
    return {prefix[:-1]: tree}


def _flat_shardings(shardings: Any) -> Tuple[Any, Dict[str, Any]]:
    """(the mesh, each key's ``NamedSharding``) of a shardings tree."""
    flat = _flatten(shardings)
    return next(iter(flat.values())).mesh, flat


def _to_tensors(flat: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    out = {}
    for key, leaf in flat.items():
        if isinstance(leaf, torch.Tensor):
            out[key] = leaf
        elif isinstance(leaf, int):
            out[key] = torch.tensor(leaf, dtype=torch.int64)
        else:
            raise TypeError(f'{key}: cannot checkpoint a '
                            f'{type(leaf).__name__}')
    return out


@torch.no_grad()
def _restore_into(tree: Any, loaded: Dict[str, torch.Tensor],
                  prefix: str = '') -> Any:
    """``tree`` with every tensor overwritten in place from ``loaded``
    (so it keeps its device and dtype) and every int replaced."""
    node = _as_dict(tree)
    if isinstance(node, dict):
        rebuilt = {k: _restore_into(v, loaded, f'{prefix}{k}/')
                   for k, v in node.items()}
        if node is not tree:
            return dataclasses.replace(tree, **rebuilt)
        return rebuilt
    key = prefix[:-1]
    value = loaded[key]
    if isinstance(tree, torch.Tensor):
        if tuple(value.shape) != tuple(tree.shape):
            raise ValueError(f'{key}: checkpoint shape {tuple(value.shape)}'
                             f' != state shape {tuple(tree.shape)}')
        tree.copy_(value)
        return tree
    return int(value)


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------

def _step_dir(directory: str, step: int) -> Optional[str]:
    """The digit-named child of ``directory`` whose value is ``step``
    (tolerant of zero-padding)."""
    try:
        entries = os.listdir(directory)
    except OSError:
        return None
    for name in entries:
        full = os.path.join(directory, name)
        if name.isdigit() and int(name) == step and os.path.isdir(full):
            return full
    return None


def _committed_steps(directory: str) -> Tuple[List[int], List[int]]:
    """``(committed, uncommitted)`` step numbers by manifest presence (a
    torn manifest reads as absent)."""
    committed: List[int] = []
    uncommitted: List[int] = []
    try:
        entries = os.listdir(directory)
    except OSError:
        return committed, uncommitted
    for name in entries:
        full = os.path.join(directory, name)
        if not (name.isdigit() and os.path.isdir(full)):
            continue
        if ckpt_manifest.read(full) is not None:
            committed.append(int(name))
        else:
            uncommitted.append(int(name))
    return committed, uncommitted


def save(directory: str, step: int, tree: Any, max_to_keep: int = 3,
         shardings: Any = None) -> None:
    """Write step ``step`` of ``tree`` (a TrainState or a dict of
    tensors and ints) and commit it; then keep the ``max_to_keep``
    newest committed steps. An uncommitted directory of the same step
    (a save that died) is replaced; a committed one raises.
    ``shardings``: ``tree`` is this rank's blocks on a mesh; every rank
    calls ``save``, rank 0 writes the whole tensors."""
    flat = _to_tensors(_flatten(tree))
    if shardings is None:
        _write(directory, step, flat, max_to_keep)
        return
    import torch.distributed as dist
    mesh, sh = _flat_shardings(shardings)
    par = tensor_parallel_of(mesh)
    if dist.get_rank() == 0:
        # Each whole tensor is gathered as the writer reaches it and
        # freed once written: the host never holds the whole state.
        _write(directory, step, {
            key: Deferred(sh[key].full_shape(t.shape), t.dtype, t.device,
                          functools.partial(sh[key].gather, t, par))
            for key, t in flat.items()}, max_to_keep)
    else:
        # The same gathers in the writer's (name) order.
        for key in sorted(flat):
            sh[key].gather(flat[key], par)
    dist.barrier()


def _write(directory: str, step: int, flat: Dict[str, Any],
           max_to_keep: int) -> None:
    directory = os.path.abspath(os.path.expanduser(directory))
    os.makedirs(directory, exist_ok=True)
    old = _step_dir(directory, step)
    if old is not None:
        if ckpt_manifest.read(old) is not None:
            raise FileExistsError(f'checkpoint step {step} is already '
                                  f'committed in {directory}')
        shutil.rmtree(old)
    step_dir = os.path.join(directory, str(step))
    os.makedirs(step_dir)
    write_safetensors(os.path.join(step_dir, SHARD_NAME), flat, fsync=True)
    fault_injection.inject(COMMIT_SITE)
    ckpt_manifest.write(step_dir, ckpt_manifest.build(step_dir, step=step))
    committed, _ = _committed_steps(directory)
    for stale in sorted(committed)[:-max_to_keep]:
        shutil.rmtree(_step_dir(directory, stale), ignore_errors=True)
    logger.info('Saved checkpoint step %d to %s', step, directory)


def step_manifest(directory: str, step: int) -> Optional[dict]:
    """The committed manifest of one step (None = absent or
    uncommitted)."""
    directory = os.path.abspath(os.path.expanduser(directory))
    step_dir = _step_dir(directory, step)
    if step_dir is None:
        return None
    return ckpt_manifest.read(step_dir)


def latest_step(directory: str) -> Optional[int]:
    """Newest COMMITTED step, or None. A pure read: nothing is
    created."""
    directory = os.path.abspath(os.path.expanduser(directory))
    committed, uncommitted = _committed_steps(directory)
    if uncommitted:
        logger.warning('Ignoring uncommitted checkpoint step(s) %s in %s '
                       '(save died before the manifest commit)',
                       sorted(uncommitted), directory)
    return max(committed) if committed else None


def restore(directory: str, step: int, target: Any,
            subtree: Optional[str] = None, shardings: Any = None) -> Any:
    """Step ``step`` restored into ``target``: its tensors are
    overwritten in place (on their device, in their dtypes) and its ints
    replaced; returns the restored tree. Keys must match exactly; with
    ``subtree`` (e.g. ``'params'`` of a saved train state), the keys
    under that name must match ``target``'s and the rest are not read
    into it. ``shardings``: ``target`` holds this rank's blocks on a
    mesh, whatever mesh wrote the step; each rank reads its blocks of
    the whole tensors."""
    directory = os.path.abspath(os.path.expanduser(directory))
    step_dir = _step_dir(directory, step)
    if step_dir is None or ckpt_manifest.read(step_dir) is None:
        raise FileNotFoundError(f'no committed checkpoint step {step} in '
                                f'{directory}')
    with SafetensorsReader(os.path.join(step_dir, SHARD_NAME)) as reader:
        prefix = subtree + '/' if subtree else ''
        names = {k[len(prefix):]: k for k in reader.keys()
                 if k.startswith(prefix)}
        want = set(_flatten(target))
        if want != set(names):
            raise ValueError(
                f'checkpoint step {step} does not match the state: missing '
                f'{sorted(want - set(names))}, extra '
                f'{sorted(set(names) - want)}')
        loaded = {k: reader.get(name) for k, name in names.items()}
        if shardings is not None:
            import torch.distributed as dist
            rank, (_, sh) = dist.get_rank(), _flat_shardings(shardings)
            loaded = {k: sh[k].slice(v, rank) for k, v in loaded.items()}
        restored = _restore_into(target, loaded)
        del loaded
    logger.info('Restored checkpoint step %d from %s', step, directory)
    return restored


def restore_latest(directory: str, init_fn: Callable[[], Any],
                   subtree: Optional[str] = None) -> Any:
    """The newest committed checkpoint restored into ``init_fn()`` (see
    ``restore`` for ``subtree``), or ``init_fn()`` itself when there is
    none."""
    step = latest_step(directory)
    target = init_fn()
    if step is None:
        return target
    return restore(directory, step, target, subtree)
