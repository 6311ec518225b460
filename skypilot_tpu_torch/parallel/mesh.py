"""Device mesh construction: the port of ``skypilot_tpu/parallel/mesh.py``.

Axis convention (outermost -> innermost), the reference's:

    ('data', 'stage', 'fsdp', 'seq', 'expert', 'tensor')

``data`` and ``stage`` are the axes whose collectives may cross slice
boundaries (``DCN_AXIS_NAMES``); ``tensor`` is innermost.

Differences of idiom: a JAX mesh is an array of devices driven by one
controller; here the unit is one process per shard, so a ``Mesh`` is an
array of ``torch.distributed`` RANKS with the axis names, and its
``device_mesh`` is the ``torch.distributed.device_mesh.DeviceMesh`` over
the same array (built at first use, once the process group exists).
The multi-slice layout is host arithmetic and is the reference's: each
slice is a consecutive block of ranks, blocked into the full mesh along
the DCN axes. Ranks have no physical topology to honour, so within a
slice the ranks fill the mesh in order (the reference's
``create_device_mesh`` on virtual CPU devices does the same).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

MESH_AXIS_NAMES: Tuple[str, ...] = ('data', 'stage', 'fsdp', 'seq', 'expert',
                                    'tensor')

# Axes whose collectives may cross slice boundaries (ride DCN).
DCN_AXIS_NAMES: Tuple[str, ...] = ('data', 'stage')


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Parallelism degrees. -1 on `fsdp` means 'all remaining devices'."""
    data: int = 1
    stage: int = 1
    fsdp: int = -1
    seq: int = 1
    expert: int = 1
    tensor: int = 1
    # Degrees that cross slice boundaries (multi-slice over DCN); 1 =
    # single slice.
    num_slices: int = 1

    def with_num_slices(self, num_slices: int) -> 'MeshConfig':
        """Re-solve the DCN axes for a changed slice count (elastic
        shrink/grow): the slice-crossing component of each DCN axis is
        re-derived for ``num_slices`` while the within-slice components
        stay fixed. Pipeline stages across DCN cannot resize, so a
        ``stage`` axis with a DCN component raises."""
        if num_slices < 1:
            raise ValueError(f'num_slices must be >= 1, got {num_slices}')
        if num_slices == self.num_slices:
            return self
        sizes = {name: getattr(self, name) for name in MESH_AXIS_NAMES}
        remaining = self.num_slices
        dcn = {}
        ici = {}
        for name in MESH_AXIS_NAMES:
            size = sizes[name]
            if name in DCN_AXIS_NAMES and remaining > 1 and size == -1:
                # 'All remaining devices' absorbs the whole slice-crossing
                # product and re-resolves against the surviving devices.
                dcn[name] = remaining
                ici[name] = -1
                remaining = 1
            elif name in DCN_AXIS_NAMES and remaining > 1:
                take = math.gcd(size, remaining)
                dcn[name] = take
                ici[name] = size // take
                remaining //= take
            else:
                dcn[name] = 1
                ici[name] = size
        if remaining != 1:
            raise ValueError(
                f'num_slices={self.num_slices} does not divide into DCN '
                f'axes {DCN_AXIS_NAMES} of mesh {sizes}')
        if dcn['stage'] > 1:
            raise ValueError(
                'Pipeline stages span slice boundaries '
                f'(stage={sizes["stage"]} with {self.num_slices} '
                'slices); the stage split cannot resize elastically — '
                'use a data-parallel DCN layout for elastic jobs.')
        new_sizes = dict(sizes)
        if ici['data'] != -1:
            new_sizes['data'] = ici['data'] * num_slices
        return dataclasses.replace(self, num_slices=num_slices,
                                   **new_sizes)

    def resolve(self, num_devices: int, *,
                num_slices: Optional[int] = None) -> 'MeshConfig':
        """Fill in -1 axes so the product equals num_devices
        (``num_slices``: first re-solve the DCN axes for that count)."""
        if num_slices is not None and num_slices != self.num_slices:
            return self.with_num_slices(num_slices).resolve(num_devices)
        sizes = {name: getattr(self, name) for name in MESH_AXIS_NAMES}
        unknown = [k for k, v in sizes.items() if v == -1]
        known_product = math.prod(v for v in sizes.values() if v != -1)
        if not unknown:
            if known_product != num_devices:
                raise ValueError(
                    f'Mesh axes {sizes} multiply to {known_product}, but '
                    f'{num_devices} devices are present.')
            return self
        if len(unknown) > 1:
            raise ValueError(f'At most one -1 axis allowed, got {unknown}')
        if num_devices % known_product:
            raise ValueError(
                f'{num_devices} devices not divisible by fixed axes product '
                f'{known_product} ({sizes})')
        sizes[unknown[0]] = num_devices // known_product
        return dataclasses.replace(self, **sizes)

    def axis_sizes(self) -> Tuple[int, ...]:
        return tuple(getattr(self, name) for name in MESH_AXIS_NAMES)

    @property
    def num_devices(self) -> int:
        return math.prod(self.axis_sizes())


class Mesh:
    """Named axes over an array of ``torch.distributed`` ranks.

    ``shape`` maps each axis name to its size (the reference's
    ``mesh.shape``); ``devices`` is the rank array; ``device_type`` is
    ``'cuda'`` or ``'cpu'``, what the ranks compute on."""

    def __init__(self, ranks: np.ndarray,
                 axis_names: Sequence[str] = MESH_AXIS_NAMES,
                 device_type: str = 'cuda') -> None:
        ranks = np.asarray(ranks, dtype=np.int64)
        if ranks.ndim != len(axis_names):
            raise ValueError(f'rank array of rank {ranks.ndim} for axes '
                             f'{tuple(axis_names)}')
        self.devices = ranks
        self.axis_names = tuple(axis_names)
        self.device_type = device_type
        self._device_mesh = None

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def coords(self, rank: int) -> Dict[str, int]:
        """Rank ``rank``'s index along every axis."""
        where = np.argwhere(self.devices == rank)
        if not len(where):
            raise ValueError(f'rank {rank} is not in {describe_mesh(self)}')
        return dict(zip(self.axis_names, (int(i) for i in where[0])))

    @property
    def device_mesh(self):
        """The ``DeviceMesh`` over this rank array (the process group
        must be initialised: ``parallel/launch.py``)."""
        if self._device_mesh is None:
            import torch
            from torch.distributed.device_mesh import DeviceMesh
            self._device_mesh = DeviceMesh(
                self.device_type, torch.as_tensor(self.devices),
                mesh_dim_names=self.axis_names)
        return self._device_mesh

    def group(self, axis: str):
        """The process group of this rank's line along ``axis``."""
        return self.device_mesh.get_group(axis)

    def __repr__(self) -> str:
        return describe_mesh(self)


def world_ranks() -> List[int]:
    """Every rank of the initialised process group ([0] without one)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return list(range(dist.get_world_size()))
    return [0]


def _ordered(ranks: Sequence[int], shape: Sequence[int]) -> np.ndarray:
    return np.asarray(list(ranks), dtype=np.int64).reshape(tuple(shape))


def build_mesh(config: MeshConfig,
               devices: Optional[Sequence[int]] = None,
               device_type: str = 'cuda') -> Mesh:
    """A ``Mesh`` over ``devices`` (ranks; default every rank of the
    process group) honouring the DCN axes: with ``num_slices > 1`` each
    slice is a consecutive block of ranks, blocked into the full mesh
    along ``data``/``stage`` (the reference's hybrid layout)."""
    if devices is None:
        devices = world_ranks()
    devices = list(devices)
    config = config.resolve(len(devices))
    shape = config.axis_sizes()
    if config.num_slices > 1:
        per_slice = len(devices) // config.num_slices
        dcn_shape = []
        ici_shape = []
        remaining_dcn = config.num_slices
        for name, size in zip(MESH_AXIS_NAMES, shape):
            if name in DCN_AXIS_NAMES and remaining_dcn > 1:
                take = math.gcd(size, remaining_dcn)
                dcn_shape.append(take)
                ici_shape.append(size // take)
                remaining_dcn //= take
            else:
                dcn_shape.append(1)
                ici_shape.append(size)
        if remaining_dcn != 1:
            raise ValueError(
                f'num_slices={config.num_slices} does not divide into DCN '
                f'axes {DCN_AXIS_NAMES} of mesh '
                f'{dict(zip(MESH_AXIS_NAMES, shape))}')
        ranks = _block_hybrid_mesh(devices, ici_shape, dcn_shape, per_slice)
    else:
        ranks = _ordered(devices, shape)
    return Mesh(ranks, MESH_AXIS_NAMES, device_type)


def _block_hybrid_mesh(devices: Sequence[int], ici_shape: Sequence[int],
                       dcn_shape: Sequence[int],
                       per_slice: int) -> np.ndarray:
    """Blocked (slice-major) rank array: axis i has size dcn*ici."""
    full_shape = tuple(d * i for d, i in zip(dcn_shape, ici_shape))
    out = np.empty(full_shape, dtype=np.int64)
    for slice_idx, dcn_index in enumerate(np.ndindex(*dcn_shape)):
        group = devices[slice_idx * per_slice:(slice_idx + 1) * per_slice]
        region = tuple(
            slice(dcn_index[d] * ici_shape[d],
                  (dcn_index[d] + 1) * ici_shape[d])
            for d in range(len(full_shape)))
        out[region] = _ordered(group, ici_shape)
    return out


def single_device_mesh(device: int = 0, device_type: str = 'cuda') -> Mesh:
    """A trivial 1-rank mesh (all axes size 1)."""
    return Mesh(np.array([device]).reshape((1,) * len(MESH_AXIS_NAMES)),
                MESH_AXIS_NAMES, device_type)


def auto_mesh_config(num_devices: int,
                     *,
                     num_slices: int = 1,
                     tensor: int = 1,
                     seq: int = 1,
                     expert: int = 1,
                     stage: int = 1) -> MeshConfig:
    """Explicit TP/SP/EP/PP degrees, DP across slices, FSDP over
    everything left (the standard large-LM recipe)."""
    data = num_slices if num_slices > 1 else 1
    fixed = data * stage * seq * expert * tensor
    if num_devices % fixed:
        raise ValueError(
            f'{num_devices} devices not divisible by requested degrees '
            f'(data={data}, stage={stage}, seq={seq}, expert={expert}, '
            f'tensor={tensor})')
    return MeshConfig(data=data, stage=stage, fsdp=num_devices // fixed,
                      seq=seq, expert=expert, tensor=tensor,
                      num_slices=num_slices)


def mesh_axis_size(mesh: Mesh, names: Sequence[str]) -> int:
    return math.prod(mesh.shape[n] for n in names if n in mesh.shape)


def describe_mesh(mesh: Mesh) -> str:
    sizes = {k: v for k, v in mesh.shape.items() if v > 1}
    return f'Mesh({sizes or "1 device"})'


def parse_mesh_spec(spec: str) -> Dict[str, int]:
    """'tensor=2,data=1' -> {'tensor': 2, 'data': 1} (the reference's
    ``train/pretrain.parse_mesh`` for a non-empty spec)."""
    out: Dict[str, int] = {}
    for part in spec.split(','):
        key, _, value = part.partition('=')
        out[key.strip()] = int(value)
    return out
