"""Tensor-parallel serving: the port of ``skypilot_tpu/inference/sharding.py``.

A model wider than one card serves over a mesh's ``tensor`` axis: heads,
MLP columns and the vocab shard over it, everything else replicates
(the training rules, ``parallel/sharding.DEFAULT_RULES``), and each rank
runs the same hand-written kernels on its head shard.

Differences of idiom: the reference is one process that places arrays
on every chip and lets XLA insert the collectives. Here the unit is one
process per shard (``parallel/launch.py``) and every rank builds the
same engine with ``mesh='tensor=N'``:

* ``prepare_engine`` quantizes the whole tree first (so W8A8 scales
  reduce over whole tensors, the numbers the reference's sharded
  quantization gives) and keeps this rank's slice of every leaf;
* the KV pool holds only this rank's kv heads (``shard_paged_cache``;
  the engines allocate it that way, under ``mesh_context``), while block
  tables and lengths are the same on every rank;
* rank 0 of the tensor axis is the DRIVER: it alone runs the scheduler
  and samples, and before every model step it broadcasts the step's
  plan (``StepChannel``): the tensors that step takes. The other ranks
  are FOLLOWERS: ``engine.follow()`` runs each plan's step on their
  shards until the driver closes the channel.
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import Any, Dict, Optional, Tuple, Union

import torch

from skypilot_tpu_torch.models.config import ModelConfig
from skypilot_tpu_torch.parallel.mesh import (Mesh, MeshConfig, build_mesh,
                                              parse_mesh_spec, world_ranks)
from skypilot_tpu_torch.parallel.sharding import (TensorParallel, divides,
                                                  shard_params_pytree,
                                                  tensor_parallel_of)

Params = Dict[str, Any]

_AXES = ('data', 'stage', 'fsdp', 'seq', 'expert', 'tensor')


def build_inference_mesh(spec: Union[str, Mesh], *,
                         devices=None, device_type: str = 'cuda') -> Mesh:
    """'tensor=4' / 'tensor=4,data=2'-style spec (or a ready Mesh) over
    ``devices`` (ranks; default every rank of the process group).

    Unspecified axes stay at 1 and the mesh takes exactly the ranks the
    spec multiplies out to: leftover ranks are NOT absorbed into fsdp
    (weight-gathering per matmul is the wrong default for a
    latency-bound decode loop)."""
    if isinstance(spec, Mesh):
        return spec
    if not spec or not spec.strip():
        raise ValueError(
            "empty mesh spec: pass e.g. 'tensor=4' (or omit the mesh "
            'argument for single-device serving)')
    devices = list(world_ranks() if devices is None else devices)
    axes = {name: 1 for name in _AXES}
    parsed = parse_mesh_spec(spec)
    unknown = set(parsed) - set(axes)
    if unknown:
        raise ValueError(
            f'unknown mesh axis {sorted(unknown)} in {spec!r}; valid '
            f'axes: {sorted(axes)}')
    axes.update(parsed)
    wildcards = [a for a, v in axes.items() if v == -1]
    if wildcards:  # 'tensor=-1': absorb every rank
        if len(wildcards) > 1:
            raise ValueError(f'mesh {spec!r}: only one axis may be -1')
        fixed = math.prod(v for v in axes.values() if v != -1)
        axes[wildcards[0]] = max(len(devices) // fixed, 1)
    n = math.prod(axes.values())
    if n < 1 or n > len(devices):
        raise ValueError(
            f'mesh {spec!r} needs {n} devices, have {len(devices)} (one '
            'rank per device: start them with '
            'skypilot_tpu_torch.parallel.launch)')
    return build_mesh(MeshConfig(**axes), devices=devices[:n],
                      device_type=device_type)


def shard_inference_params(params: Params, mesh: Mesh, cfg: ModelConfig,
                           rank: Optional[int] = None) -> Params:
    """Rank ``rank``'s (default this process's) slice of ``params`` under
    the model's logical-axes rules."""
    from skypilot_tpu_torch.models import llama
    if rank is None:
        import torch.distributed as dist
        rank = dist.get_rank()
    return shard_params_pytree(mesh, llama.param_logical_axes(cfg), params,
                               rank=rank)


def prepare_engine(params: Params, cfg: ModelConfig,
                   mesh: Optional[Union[str, Mesh]], *,
                   quantize: bool = False,
                   device_type: str = 'cuda'
                   ) -> Tuple[Params, ModelConfig, Optional[Mesh]]:
    """(params, cfg, mesh) ready for the engine: W8A8 when ``quantize``
    (on the whole tensors), then, under a mesh of more than one rank,
    this rank's shard, with decode attention defaulting to ``'auto'``
    (the kernels) as in the reference."""
    from skypilot_tpu_torch.models.quant import maybe_quantize
    params = maybe_quantize(params, quantize)
    if mesh is None:
        return params, cfg, None
    mesh = build_inference_mesh(mesh, device_type=device_type)
    if mesh.size == 1:
        return params, cfg, mesh
    check_tensor_only(mesh, cfg)
    cfg = dataclasses.replace(
        cfg, decode_attention_impl=cfg.decode_attention_impl or 'auto')
    return shard_inference_params(params, mesh, cfg), cfg, mesh


def wants_shards(spec: Optional[Union[str, Mesh]]) -> bool:
    """Whether ``spec`` asks for more than one rank (before any process
    group exists: the options a mesh cannot serve yet are refused
    first)."""
    if isinstance(spec, Mesh):
        return spec.size > 1
    if not spec or not spec.strip():
        return False
    return any(v != 1 for v in parse_mesh_spec(spec).values())


def check_unported(spec: Optional[Union[str, Mesh]], cfg: ModelConfig,
                   **options: bool) -> None:
    """Raise ``NotImplementedError`` when a mesh of more than one rank
    meets what does not serve under one yet: MoE configs, and each
    option of ``options`` that is on."""
    if not wants_shards(spec):
        return
    if cfg.is_moe:
        options = dict(options, moe=True)
    for name, on in options.items():
        if on:
            what = 'MoE configs' if name == 'moe' else f'{name}='
            raise NotImplementedError(
                f'{what} under a tensor-parallel mesh is not ported yet '
                '(ROADMAP.md, queue A item 15)')


def release_unsharded(serving: Optional['MeshServing'],
                      device: torch.device) -> None:
    """Under a mesh on the card, hand the freed whole-tensor blocks of
    the weights back to the device, so ranks sharing a card can use
    them."""
    if serving is not None and device.type == 'cuda':
        torch.cuda.empty_cache()


def check_tensor_only(mesh: Mesh, cfg: ModelConfig) -> None:
    """The serving half of the port shards over ``tensor`` only, and
    every sharded size must divide the degree."""
    other = {k: v for k, v in mesh.shape.items() if k != 'tensor' and v > 1}
    if other:
        raise NotImplementedError(
            f'serving over mesh axes {sorted(other)} is not ported yet '
            '(ROADMAP.md, queue A item 15): only tensor=N')
    tp = mesh.shape['tensor']
    for size, what in ((cfg.n_heads, 'n_heads'),
                       (cfg.n_kv_heads, 'n_kv_heads'),
                       (cfg.d_ff, 'd_ff'), (cfg.vocab_size, 'vocab_size')):
        divides(size, tp, what)


def shard_paged_cache(cache, mesh: Optional[Mesh], cfg: ModelConfig):
    """This rank's part of a ``PagedKVCache``: k/v (and int8 scales)
    along the kv-head axis, the axis the attention kernels run per
    shard; block tables and lengths stay whole. A cache that already
    holds only this rank's heads (the engines allocate it so, under
    ``mesh_context``) is returned as it is."""
    tp = tensor_parallel_of(mesh)
    local = divides(cfg.n_kv_heads, tp.degree, 'n_kv_heads')
    if tp.degree == 1 or cache.k.shape[3] == local:
        return cache

    def part(x):
        return (None if x is None else
                x.narrow(3, tp.rank * local, local).clone())

    return dataclasses.replace(
        cache, k=part(cache.k), v=part(cache.v),
        k_scale=part(cache.k_scale), v_scale=part(cache.v_scale))


class MeshServing:
    """An engine's place on its serving mesh: the mesh, this rank's
    ``TensorParallel``, its device (``cuda:(rank % count)``, or the CPU
    when ``device`` is the CPU), the plan channel, and what ``/stats``
    reports (the mesh, the backend and every rank's device). Every rank
    builds it at the same point of the engine's construction: the
    process groups and the device exchange are collective."""

    def __init__(self, spec: Union[str, Mesh], device: torch.device) -> None:
        import torch.distributed as dist
        from skypilot_tpu_torch.parallel.launch import rank_device
        from skypilot_tpu_torch.parallel.mesh import describe_mesh
        self.mesh = build_inference_mesh(spec, device_type=device.type)
        rank = dist.get_rank()
        if rank not in self.mesh.devices:
            raise ValueError(f'rank {rank} is not on {describe_mesh(self.mesh)}')
        self.tp = tensor_parallel_of(self.mesh)
        self.device = rank_device(rank, device.type)
        self.channel = StepChannel(self.tp, self.device)
        devices = [None] * dist.get_world_size()
        dist.all_gather_object(devices, str(self.device))
        self.info = {'mesh': describe_mesh(self.mesh),
                     'mesh_backend': dist.get_backend(),
                     'mesh_devices': devices}

    @property
    def driver(self) -> bool:
        return self.channel.driver

    def require_driver(self, what: str) -> None:
        if not self.driver:
            raise RuntimeError(
                f'{what} runs on the driver rank (tensor index 0); this '
                'rank follows its plans (engine.follow())')


def mesh_serving(spec: Optional[Union[str, Mesh]], device: torch.device,
                 cfg: ModelConfig) -> Optional[MeshServing]:
    """The engines' entry: None for no mesh or a one-rank mesh, else
    this rank's ``MeshServing`` (unsupported axes or models raise)."""
    if not spec:
        return None
    if build_inference_mesh(spec, device_type=device.type).size == 1:
        return None
    serving = MeshServing(spec, device)
    check_tensor_only(serving.mesh, cfg)
    return serving


# ---------------------------------------------------------------------------
# Driver -> follower step plans
# ---------------------------------------------------------------------------

PLAN_STOP = 0
PLAN_NOOP = 1

# Idle driver keep-alive: well inside the collective timeout
# (parallel/launch.DEFAULT_TIMEOUT_S), which a follower waiting for the
# next plan would otherwise reach on a quiet server.
KEEPALIVE_S = 30.0


class StepChannel:
    """The driver's step plans, broadcast over the tensor group.

    A plan is an op code and an int64 payload (the step's tokens,
    scalars, lengths and block tables): two broadcasts, the header
    ``[op, n]`` and the payload. The driver holds ``lock`` from the
    plan to the end of the step it announces (the keep-alive thread
    takes it too), so the ranks' collectives stay in one order."""

    def __init__(self, tp: TensorParallel, device: torch.device) -> None:
        self.tp = tp
        self.device = device
        self.driver = tp.rank == 0
        self.lock = threading.RLock()
        self._last = time.monotonic()
        self._closed = threading.Event()
        self._thread = None
        if self.driver:
            self._thread = threading.Thread(
                target=self._keepalive, args=(KEEPALIVE_S,),
                name='tp-keepalive', daemon=True)
            self._thread.start()

    def publish(self, op: int, *parts: Any) -> None:
        """Driver: announce ``op`` with ``parts`` (ints and integer
        tensors, flattened in order)."""
        tensors = [torch.as_tensor(p, dtype=torch.int64).reshape(-1)
                   .to(self.device) for p in parts]
        payload = (torch.cat(tensors) if tensors else
                   torch.zeros(0, dtype=torch.int64, device=self.device))
        header = torch.tensor([op, payload.numel()], dtype=torch.int64,
                              device=self.device)
        self.tp.broadcast(header)
        if payload.numel():
            self.tp.broadcast(payload)
        self._last = time.monotonic()

    def receive(self) -> Tuple[int, torch.Tensor]:
        """Follower: the next plan (op, int64 payload on the device)."""
        header = torch.zeros(2, dtype=torch.int64, device=self.device)
        self.tp.broadcast(header)
        op, n = (int(v) for v in header.tolist())
        payload = torch.zeros(n, dtype=torch.int64, device=self.device)
        if n:
            self.tp.broadcast(payload)
        return op, payload

    def _keepalive(self, interval: float) -> None:
        while not self._closed.wait(interval / 4):
            if time.monotonic() - self._last < interval:
                continue
            with self.lock:
                if not self._closed.is_set():
                    self.publish(PLAN_NOOP)

    def close(self) -> None:
        """Driver: tell the followers to return from ``follow``."""
        if self._closed.is_set():
            return
        with self.lock:
            self._closed.set()
            self.publish(PLAN_STOP)
        if self._thread is not None:
            self._thread.join(timeout=10)


class PlanReader:
    """Reads a plan's payload front to back."""

    def __init__(self, payload: torch.Tensor) -> None:
        self._payload = payload
        self._at = 0

    def ints(self, n: int) -> list:
        return [int(v) for v in self.take(n).tolist()]

    def take(self, n: int, shape: Optional[Tuple[int, ...]] = None,
             dtype: torch.dtype = torch.int64) -> torch.Tensor:
        out = self._payload[self._at:self._at + n]
        self._at += n
        if shape is not None:
            out = out.reshape(shape)
        return out.to(dtype)


def float_bits(value: float) -> int:
    """A float carried in an int64 plan slot (its IEEE-754 bits)."""
    import struct
    return struct.unpack('<q', struct.pack('<d', float(value)))[0]


def bits_float(bits: int) -> float:
    import struct
    return struct.unpack('<d', struct.pack('<q', int(bits)))[0]
