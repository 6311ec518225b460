"""Continuous batching over a paged KV pool with chunked prefill.

The port of ``skypilot_tpu/inference/continuous.py``'s engine core:

* **Paged KV pool**: KV lives in a fixed pool of ``block_size``-token
  blocks; each slot maps its positions through a block table, so a
  sequence holds memory in proportion to its length.
* **Chunked prefill**: a prompt is absorbed in fixed-size chunks
  interleaved between decode steps, so the inter-token latency of
  active decoders is bounded by the chunk budget, not by arriving
  prompt length.
* **Prefix cache**: full prompt blocks are digest-keyed and shared
  read-only across requests (``inference/paged.py``).

* **Speculative decoding** (``spec_decode=`` / ``SKYT_SPEC_DECODE``):
  a host-side draft (``inference/speculative.py``, n-gram lookup by
  default) proposes up to ``draft_k`` tokens after the pending one; one
  verify step scores the window (``paged_verify_step``, the paged
  kernel at Q = ``draft_k + 1``) and the engine emits the longest
  prefix that matches what the target samples at each position.
  Rejected rows roll back: lengths truncate and surplus tail blocks
  return to the pool.
* **Multi-LoRA pages** (``lora_pages=`` / ``SKYT_LORA_PAGES``): a fixed
  stack of adapter pages on the device (``models/lora.py``), filled on
  demand from the host registry, charged against the KV block pool
  (``AdapterPagePool``); admission is deficit-round-robin across
  adapters (one lane per adapter).
* **Disaggregated roles** (``role=`` / ``SKYT_DISAGG_ROLE``): a
  ``'prefill'`` engine never decodes: a finished prefill's KV blocks,
  partial tail block and fp32 last-logits row are packed
  (``inference/kv_migrate.py``) into ``self.exporter`` and the slot's
  blocks return to the pool at once. A ``'decode'`` engine admits a
  pulled export (``submit_migrated``) through a refcount-exact
  ``BlockImporter`` and decodes without a prefill pass; any import
  failure falls back to a local re-prefill of the same tokens.

One decode step runs every slot together (``paged_decode_step``, whose
attention is the Hopper paged-attention kernel on the card); a
scheduler thread admits requests into free slots as others finish,
preempts the newest request when the pool runs dry, and resumes it by
re-prefilling. The public surface (``generate_ids``/``stream_ids``/...)
is the reference's.

Sampling is a function of (seed, position): the plain step samples at
``cache.lengths``, row ``j`` of a verify window at ``lengths0 + 1 + j``,
both through ``_sample_seed``, so a speculative or resumed stream is the
plain stream at any temperature (bitwise where the logits are).

* **Live weight refresh** (``request_refresh`` / ``refresh_weights``):
  new weights, a ``flatten_param_paths``-keyed delta or a whole tree,
  are copied into the engine's own leaves at the top of a serving-loop
  iteration (a step boundary), so KV written by the old weights stays
  valid and only later positions see the new ones; ``mode='drain'``
  first holds admission and lets in-flight requests finish. Each
  request carries the ``policy_version`` it was submitted under (the RL
  rollout path's staleness). The engine owns its weights: a leaf that
  would share storage with the caller's params is copied at
  construction (the reference's arrays are immutable, torch tensors are
  not: a learner's in-place optimizer step must not reach the served
  weights), and a refresh copies its source into the engine's dtype
  when it is requested, so the version labels the weights as they were
  then. ``refresh_seconds`` in ``stats()`` adds up the time of those
  two copies: on the card, device time on a stream of their own, so
  decode steps in flight are not in it (the reference times its tick's
  wall clock). Chaos site ``infer.weights.refresh`` (``utils/
  fault_injection.py``): a fault there fails the refresh's ticket and
  leaves the weights and the version as they were.

* **Tensor-parallel serving** (``mesh='tensor=N'``,
  ``inference/sharding.py``): the engine is built on each of N ranks
  (``parallel/launch.py``), each holding its shard of the weights and
  its kv heads of the pool. The scheduler decides admissions from
  wall-clock arrivals, so the ranks could not each run it and agree:
  rank 0 of the tensor axis is the driver, which alone runs the
  scheduler thread and samples, and before every model step broadcasts
  the step's plan (the tokens, scalars, lengths and block tables that
  ``prefill_chunk`` / ``paged_decode_step`` / ``paged_verify_step``
  take; a speculative window is the verify step at Q = k+1). The other
  ranks run only those steps, in ``follow()``, until the driver's
  ``shutdown()``. A failed step under a mesh is fatal to the engine
  (the ranks' collectives would no longer line up). MoE configs serve
  under a mesh with fp experts (each rank builds only its slice of the
  seeded init). Disaggregated roles serve under a mesh: an export
  gathers each block's kv heads from every rank in rank order, an
  import checks the whole-head payload on the driver and scatters each
  rank's heads into its pool, so the wire format stays the
  reference's whole blocks. LoRA pages serve under a mesh: the driver
  keeps the registry, the page pool and its accounting, uploads a page
  by a plan whose adapter every rank writes (B on its own heads, A
  whole), and the step plans carry the slots' pages. A weight refresh
  is checked whole on the driver and announced at a step boundary;
  every rank copies its slice of each leaf in place. A page write or a
  refresh that fails once announced is fatal, like a failed step.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import logging
import math
import queue
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from skypilot_tpu_torch.inference import kv_migrate, sharding
from skypilot_tpu_torch.inference.engine import restore_params
from skypilot_tpu_torch.inference.paged import (AdapterPagePool,
                                                BlockImporter, BlockPool,
                                                PrefixCache,
                                                adapter_chain_root,
                                                chain_digests)
from skypilot_tpu_torch.inference.tokenizer import get_tokenizer
from skypilot_tpu_torch.models import decode as decode_lib
from skypilot_tpu_torch.models import hf_interop
from skypilot_tpu_torch.models import lora as lora_lib
from skypilot_tpu_torch.models.config import (ModelConfig, get_model_config,
                                              with_int8_kv_cache)
from skypilot_tpu_torch.models.convert import tensor_from_numpy
from skypilot_tpu_torch.models.quant import QTensor
from skypilot_tpu_torch.parallel.sharding import mesh_context
from skypilot_tpu_torch.server import metrics
from skypilot_tpu_torch.utils import env, fault_injection, tracing
from skypilot_tpu_torch.utils.device import resolve_device, to_device

logger = logging.getLogger(__name__)

DEFAULT_BLOCK_SIZE = 16
DEFAULT_PREFILL_CHUNK = 64

# Chaos sites (utils/fault_injection): the two host-side edges of
# adapter residency (pulling a cold adapter into a device page, and
# LRU-evicting an idle one to make room), and a live weight swap, before
# any leaf is written.
LORA_FETCH_SITE = 'infer.lora.fetch'
LORA_EVICT_SITE = 'infer.lora.evict'
WEIGHT_REFRESH_SITE = 'infer.weights.refresh'

_MASK64 = (1 << 64) - 1

# Tensor-parallel step plans (inference/sharding.StepChannel).
_PLAN_PREFILL = 2
_PLAN_DECODE = 3
_PLAN_VERIFY = 4
# Disaggregated roles: the pool's blocks read for an export, written for
# an import (their whole-head payload follows the plan).
_PLAN_READ_BLOCKS = 5
_PLAN_WRITE_BLOCKS = 6
# LoRA pages: an adapter uploaded into a page (its weights follow the
# plan). Live refresh: the engine leaves written at this step boundary
# (their whole new values follow the plan).
_PLAN_WRITE_PAGE = 7
_PLAN_REFRESH = 8


def flatten_param_paths(params) -> Dict[str, Any]:
    """Stable ``'/'``-joined path -> leaf map for a params tree (nested
    dicts, lists and tuples): the reference's function, giving the same
    paths for the same tree. The RL pipeline's policy store names its
    shards by these paths and the refresh resolves them back. Dicts walk
    in sorted key order, so the map does not depend on insertion
    order."""
    flat: Dict[str, Any] = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for key in sorted(node):
                walk(node[key], prefix + (str(key),))
        elif isinstance(node, (list, tuple)):
            for i, value in enumerate(node):
                walk(value, prefix + (str(i),))
        else:
            flat['/'.join(prefix)] = node

    walk(params, ())
    return flat


def _tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, QTensor):
        return [tree.q, tree.scale]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _owned(tree, given) -> Any:
    """``tree`` detached from autograd, with every tensor that shares
    storage with a tensor of ``given`` (the caller's params; ``None``
    when the engine made or loaded its own) copied."""
    shared = {t.untyped_storage().data_ptr() for t in _tensors(given)}

    def own(node):
        if isinstance(node, dict):
            return {k: own(v) for k, v in node.items()}
        if isinstance(node, QTensor):
            return QTensor(own(node.q), own(node.scale))
        node = node.detach()
        if node.untyped_storage().data_ptr() in shared:
            return node.clone()
        return node

    return own(tree)


class _WeightRefresh:
    """A queued live weight swap: ``copies`` pairs each engine leaf
    (under a mesh: its index in the engine's sorted paths) with its new
    value, already in the leaf's dtype and on its device (under a mesh:
    the whole value). The serving loop applies it at a step boundary,
    then sets ``done`` (``error`` on failure); ``nbytes`` and
    ``apply_seconds`` are what the apply moved (under a mesh the bytes
    broadcast to every rank) and its wall seconds, broadcasts
    included."""

    def __init__(self, copies, version, mode, prepare_seconds) -> None:
        self.copies = copies
        self.version = version
        self.mode = mode
        self.prepare_seconds = prepare_seconds
        self.applied_shards = 0
        self.nbytes = 0
        self.apply_seconds = 0.0
        self.done = threading.Event()
        self.error: Optional[BaseException] = None


def _sample_seed(seed: int, position: int) -> int:
    """A 63-bit generator seed that is a pure function of (seed,
    position) (splitmix64 finaliser over the pair)."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(position) + 1) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) & ((1 << 63) - 1)


def _sample_tokens(logits: torch.Tensor, seeds: Sequence[int],
                   positions: Sequence[int],
                   temps: Sequence[float]) -> torch.Tensor:
    """Sample-at-POSITION: the token at position p is a pure function of
    (seed, p, logits), so a resumed stream reproduces the plain stream.
    Greedy (temperature <= 0) is argmax; otherwise one draw from
    softmax(logits / t) with a ``torch.Generator`` seeded from
    (seed, position). The draws differ from the reference's threefry
    draws; the contract is the same."""
    tokens = torch.argmax(logits, dim=-1).to(torch.int32)
    for row, temp in enumerate(temps):
        if temp <= 0.0:
            continue
        gen = torch.Generator(device=logits.device)
        gen.manual_seed(_sample_seed(seeds[row], positions[row]))
        probs = torch.softmax(logits[row].float() / max(temp, 1e-6), -1)
        tokens[row] = torch.multinomial(probs, 1, generator=gen)[0]
    return tokens


def _decode_all_step(params, last_logits, cache, active, temps, seeds,
                     positions, lora_pages=None, adapter_ids=None, *, cfg,
                     announce=None):
    """One step for every slot: sample from the last logits, advance.
    ``lora_pages``/``adapter_ids`` are None on a non-LoRA engine and on
    an all-base batch: the step is then exactly the base step.
    ``announce(tokens, active)``: a tensor-parallel driver's plan,
    published between the sampling and the step."""
    tokens = _sample_tokens(last_logits, seeds, positions, temps)
    if announce is not None:
        announce(tokens, active)
    logits, cache = decode_lib.paged_decode_step(
        params, tokens, cache, cfg, active=active, lora_pages=lora_pages,
        adapter_ids=adapter_ids)
    return tokens, logits, cache


def _sample_pending_step(logits_row, seed, length, temp):
    """The pending token a slot enters speculative mode with: what the
    plain step would sample next (same logits, same (seed, position))."""
    return int(_sample_tokens(logits_row[None], [seed], [length],
                              [temp])[0])


def _spec_verify_all_step(params, cache, inputs, n_input, active, temps,
                          seeds, positions, lora_pages=None,
                          adapter_ids=None, *, cfg, q_len, announce=None):
    """One speculative verify step for every slot.

    ``inputs`` [B, Q]: the pending token, then the draft proposals
    (rows at or past ``n_input`` are padding); ``positions``: the
    slots' lengths before the step (host copy of ``cache.lengths``).
    The verify step writes every window row and returns per-row
    logits; the target for row ``j`` is sampled at position
    ``lengths0 + 1 + j`` with the plain step's rule, and a draft is
    accepted while it equals its target. ``n_emit`` = 1 + the accepted
    prefix (the pending token always lands); ``pending`` = the first
    target that did not match (or the bonus token after a fully
    accepted window): the plain engine's next token, carried to the
    next step. Lengths advance by ``n_emit`` on the device; the host
    rolls back further (eos, caps) by truncating its mirror.
    ``announce(inputs, n_input, active)``: a tensor-parallel driver's
    plan, published before the step."""
    lengths0 = cache.lengths
    if announce is not None:
        announce(inputs, n_input, active)
    logits, cache = decode_lib.paged_verify_step(
        params, inputs, cache, cfg, active=active, n_input=n_input,
        lora_pages=lora_pages, adapter_ids=adapter_ids)
    g = torch.stack([
        _sample_tokens(logits[:, j], seeds, [p + 1 + j for p in positions],
                       temps)
        for j in range(q_len)], dim=1)                       # [B, Q]
    if q_len > 1:
        match = g[:, :-1] == inputs[:, 1:]
        match &= (torch.arange(1, q_len, device=g.device)[None, :] <
                  n_input[:, None])
        accepted = torch.cumprod(match.to(torch.int32), dim=1)
        n_emit = 1 + accepted.sum(dim=1)
    else:
        n_emit = torch.ones_like(lengths0)
    n_emit = torch.where(active, torch.minimum(n_emit, n_input),
                         torch.zeros_like(n_emit)).to(torch.int32)
    pending = torch.gather(g, 1, torch.clamp(n_emit - 1, min=0).long()
                           [:, None])[:, 0]
    cache = dataclasses.replace(cache, lengths=lengths0 + n_emit)
    return n_emit, pending, cache


def _prefill_chunk_step(params, tokens, start, n_new, slot, cache,
                        lora_pages=None, adapter_id=None, *, cfg,
                        announce=None):
    if announce is not None:
        announce(tokens, start, n_new, slot)
    return decode_lib.prefill_chunk(params, tokens, start, n_new, slot,
                                    cache, cfg, lora_pages=lora_pages,
                                    adapter_id=adapter_id)


class _Request:
    def __init__(self, token_ids: List[int], max_new_tokens: int,
                 temperature: float, eos_id: Optional[int],
                 seed: int, adapter: Optional[str] = None) -> None:
        self.token_ids = token_ids
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.eos_id = eos_id
        self.seed = seed
        self.adapter = adapter  # registered LoRA adapter name or None
        self.arrival = time.monotonic()
        self.arrival_wall = time.time()
        self.admitted = False  # queue-wait counted once, not per resume
        self.generated: List[int] = []
        self.done = threading.Event()
        self.error: Optional[BaseException] = None
        # Distributed tracing (armed deployments with an incoming
        # context only): the per-request engine span; queue-wait /
        # prefill-chunk / decode / preempt child spans hang off it.
        self.span = None
        self.decode_start_wall: Optional[float] = None
        self.decode_start_mono: Optional[float] = None
        # Disaggregated serving: the engine-assigned id a prefill-role
        # export is keyed by; ``migration`` holds the decode side's
        # pulled KV (``kv_migrate.PulledKv``) until it imports or falls
        # back to a local re-prefill.
        self.request_id = ''
        self.migration = None
        self.handoff_start: Optional[float] = None
        # The engine's policy version when the request was submitted:
        # the RL rollout path computes a batch's staleness from it.
        self.policy_version = 0


class _DrrQueue:
    """Deficit-round-robin admission queue keyed by adapter.

    Each adapter (base traffic = key ``''``) owns a FIFO lane; lanes
    are served round-robin with a per-visit ``quantum`` of deficit
    measured in KV blocks (what a prompt consumes), and a lane admits
    while its deficit covers the head request's block cost. A hot
    adapter gets one quantum a round like every other, so it queues
    behind itself. A single lane (base traffic only) is exact FIFO.
    """

    def __init__(self, block_size: int, quantum_blocks: int) -> None:
        self._block_size = max(1, block_size)
        self._quantum = max(1, quantum_blocks)
        self._queues: Dict[str, 'collections.deque[_Request]'] = {}
        self._rotation: 'collections.deque[str]' = collections.deque()
        self._deficit: Dict[str, int] = {}
        self._total = 0

    def __len__(self) -> int:
        return self._total

    @staticmethod
    def _key(request: _Request) -> str:
        return request.adapter or ''

    def _cost(self, request: _Request) -> int:
        tokens = len(request.token_ids) + len(request.generated)
        return max(1, -(-tokens // self._block_size))

    def _lane(self, key: str, front: bool) -> 'collections.deque[_Request]':
        lane = self._queues.get(key)
        if lane is None:
            lane = self._queues[key] = collections.deque()
            if front:
                self._rotation.appendleft(key)
            else:
                self._rotation.append(key)
            self._deficit.setdefault(key, 0)
        return lane

    def _drop_lane(self, key: str) -> None:
        """An emptied lane leaves the rotation and forfeits its deficit
        (it must not bank credit while idle)."""
        self._rotation.popleft()
        self._queues.pop(key, None)
        self._deficit.pop(key, None)

    def push(self, request: _Request) -> None:
        self._lane(self._key(request), front=False).append(request)
        self._total += 1

    def push_front(self, request: _Request) -> None:
        """Head-of-lane requeue (preemption / pool-blocked retry): the
        request resumes first in its lane, and its pop's deficit charge
        is refunded so the retry is not billed twice."""
        key = self._key(request)
        self._lane(key, front=True).appendleft(request)
        self._deficit[key] = self._deficit.get(key, 0) + \
            self._cost(request)
        self._total += 1

    def pop(self, blocked=None) -> Optional[_Request]:
        """Next request in DRR order, or None when the queue is empty
        or every lane's head is ``blocked`` (per-adapter quota)."""
        while self._total:
            progressed = False
            for _ in range(len(self._rotation)):
                key = self._rotation[0]
                lane = self._queues.get(key)
                if not lane:
                    self._drop_lane(key)
                    continue
                head = lane[0]
                if blocked is not None and blocked(head):
                    self._rotation.rotate(-1)
                    continue
                cost = self._cost(head)
                if self._deficit.get(key, 0) >= cost:
                    lane.popleft()
                    self._deficit[key] -= cost
                    self._total -= 1
                    if not lane:
                        self._drop_lane(key)
                    return head
                self._deficit[key] = self._deficit.get(key, 0) + \
                    self._quantum
                self._rotation.rotate(-1)
                progressed = True
            if not progressed:
                return None  # every lane head quota-blocked
        return None


class _PrefillState:
    """A slot mid-prefill: ``pos`` = next index of ``ids`` to absorb.

    ``ids`` is the prompt PLUS any tokens generated before a
    preemption: a preempted request resumes by re-prefilling its whole
    visible sequence and continuing to decode."""

    def __init__(self, request: _Request, slot: int, pos: int,
                 ids: List[int]) -> None:
        self.request = request
        self.slot = slot
        self.pos = pos
        self.ids = ids


class ContinuousBatchingEngine:
    """generate() admits into the shared decode loop; thread-safe.

    The weights, in order: ``params`` (a port params dict;
    ``models/convert.py`` carries JAX params over), ``hf_checkpoint``
    (an HF directory, in bf16, with its tokenizer), ``checkpoint_dir``
    (a training checkpoint's newest step), else ``llama.init_params``
    from ``seed`` on the device (see ``engine.py``). ``device``:
    default ``cuda`` (raises without a GPU); pass ``'cpu'`` to run on
    the CPU. ``spec_decode``/``draft_k``/``draft``:
    speculative decoding (defaults ``SKYT_SPEC_DECODE``,
    ``SKYT_SPEC_DRAFT_K``; the n-gram draft of ``SKYT_SPEC_NGRAM_MAX``).
    ``lora_pages``/``lora_max_rank``/``lora_max_active``: multi-LoRA
    serving (defaults ``SKYT_LORA_*``; 0 pages = off); ``base_digest``
    binds the engine to its base weights for ``register_adapter``.
    ``role``: ``'prefill'``, ``'decode'`` or ``''`` (colocated; default
    ``SKYT_DISAGG_ROLE``).
    """

    def __init__(self,
                 model: str = 'tiny',
                 *,
                 cfg: Optional[ModelConfig] = None,
                 params: Optional[Any] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 max_slots: int = 4,
                 max_len: Optional[int] = None,
                 block_size: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 num_blocks: Optional[int] = None,
                 prefix_cache: bool = True,
                 seed: int = 0,
                 quantize: bool = False,
                 quantize_kv: bool = False,
                 checkpoint_dir: Optional[str] = None,
                 hf_checkpoint: Optional[str] = None,
                 mesh: Optional[Any] = None,
                 spec_decode: Optional[bool] = None,
                 draft_k: Optional[int] = None,
                 draft: Optional[Any] = None,
                 role: Optional[str] = None,
                 lora_pages: Optional[int] = None,
                 lora_max_rank: Optional[int] = None,
                 lora_max_active: Optional[int] = None,
                 base_digest: Optional[str] = None) -> None:
        # Disaggregated serving role: '' = colocated, 'prefill' = chunked
        # prefill only, finished KV parked in the exporter for the decode
        # fleet to pull; 'decode' = imports migrated KV and batch-decodes
        # (prefill only as the re-prefill fallback).
        if role is None:
            role = env.get_str('SKYT_DISAGG_ROLE')
        if role not in ('', 'prefill', 'decode'):
            raise ValueError(
                f"SKYT_DISAGG_ROLE must be '', 'prefill' or 'decode', "
                f'got {role!r}')
        self.role = role
        self.exporter = (kv_migrate.KvExporter()
                         if role == 'prefill' else None)
        self.device = resolve_device(device)
        # The caller's own tree, the only one that can change under the
        # engine: the engine copies the leaves it would share with it.
        given = params
        # Real-weights path: see engine.py (models/hf_interop.py).
        if hf_checkpoint:
            params, cfg = hf_interop.resolve_engine_inputs(
                hf_checkpoint, params, cfg, device=self.device)
        self.cfg = cfg or get_model_config(model)
        if quantize_kv:
            self.cfg = with_int8_kv_cache(self.cfg)
        sharding.check_unported(mesh, self.cfg, params)
        self._mesh = sharding.mesh_serving(mesh, self.device, self.cfg)
        self._tp = None
        if self._mesh is not None:
            self.device, self._tp = self._mesh.device, self._mesh.tp
        self.tokenizer = get_tokenizer(hf_checkpoint,
                                       require=bool(hf_checkpoint))
        # A model whose vocab can't cover the tokenizer still serves the
        # id-level APIs; only the TEXT entry points are refused.
        self._tokenizer_fits = (self.tokenizer.vocab_size <=
                                self.cfg.vocab_size)
        if hf_checkpoint and not self._tokenizer_fits:
            raise ValueError(
                f'Model vocab {self.cfg.vocab_size} < tokenizer '
                f'vocab {self.tokenizer.vocab_size}')
        self.max_slots = max_slots
        self.max_len = min(max_len or self.cfg.max_seq_len,
                           self.cfg.max_seq_len)
        self.block_size = block_size or DEFAULT_BLOCK_SIZE
        if self.block_size < 1:
            raise ValueError(f'block_size must be >= 1, got '
                             f'{self.block_size}')
        self.prefill_chunk = max(1, min(
            prefill_chunk or DEFAULT_PREFILL_CHUNK, self.max_len))
        self.blocks_per_slot = math.ceil(self.max_len / self.block_size)
        # Default pool = the memory a monolithic max_slots*max_len cache
        # would take (+1 for the reserved null block).
        self.num_blocks = (num_blocks or
                           max_slots * self.blocks_per_slot + 1)
        if params is None and checkpoint_dir:
            params = restore_params(checkpoint_dir, self.cfg, seed,
                                    self.device)
        with torch.no_grad():
            params, self.cfg, _ = sharding.prepare_engine(
                None if params is None else to_device(params, self.device),
                self.cfg, self._mesh and self._mesh.mesh, quantize=quantize,
                device=self.device, seed=seed)
            self.params = _owned(decode_lib.serving_params(
                params, self.cfg), given)
        del params
        sharding.release_unsharded(self._mesh, self.device)
        with mesh_context(self._tp):
            self.cache = sharding.shard_paged_cache(
                decode_lib.init_paged_cache(
                    self.cfg, self.num_blocks, self.block_size, max_slots,
                    self.blocks_per_slot, device=self.device),
                self._mesh and self._mesh.mesh, self.cfg)
        # Host-side bookkeeping (serving-loop thread only).
        self._pool = BlockPool(self.num_blocks)
        self._prefix: Optional[PrefixCache] = (
            PrefixCache(self._pool, self.block_size)
            if prefix_cache and self.block_size <= self.max_len else None)
        self._host_bt = np.zeros((max_slots, self.blocks_per_slot),
                                 np.int32)
        self._host_len = np.zeros((max_slots,), np.int64)
        self._slot_blocks: List[List[int]] = [[] for _ in
                                              range(max_slots)]
        self._bt_dirty = False
        self._slots: List[Optional[_Request]] = [None] * max_slots
        self._decoding = [False] * max_slots
        self._admit_order = [0] * max_slots  # preemption victim pick
        self._admit_seq = 0
        self._prefilling: List[_PrefillState] = []
        # Admission queue: DRR-fair across adapters (exact FIFO with
        # base traffic only).
        self._waiting = _DrrQueue(self.block_size,
                                  env.get_int('SKYT_LORA_DRR_QUANTUM'))
        # Pool version at the last admission attempt that failed on
        # memory pressure: until it changes, retrying is pure waste.
        self._blocked_at_version: Optional[int] = None
        # Speculative decoding: verify window = pending token + up to
        # draft_k proposals; off (window 1) unless asked for.
        if spec_decode is None:
            spec_decode = env.get_bool('SKYT_SPEC_DECODE')
        k_draft = (draft_k if draft_k is not None
                   else env.get_int('SKYT_SPEC_DRAFT_K'))
        self._spec_window = (1 + max(0, min(int(k_draft),
                                            self.max_len - 1))
                             if spec_decode else 1)
        if spec_decode and self._spec_window > 1:
            from skypilot_tpu_torch.inference.speculative import NGramDraft
            self._draft = draft or NGramDraft(
                env.get_int('SKYT_SPEC_NGRAM_MAX'), corpus_entries=8192)
        else:
            self._draft = None
        self.spec_decode = self._draft is not None
        # Multi-LoRA serving: a fixed stack of device adapter pages fed
        # from the host registry, residency charged against the KV block
        # pool, per-slot page indices gathered inside the steps. 0 pages
        # = off: the steps and the scheduling order are the base ones.
        n_lora = (lora_pages if lora_pages is not None
                  else env.get_int('SKYT_LORA_PAGES'))
        self._lora_max_rank = max(1, (
            lora_max_rank if lora_max_rank is not None
            else env.get_int('SKYT_LORA_MAX_RANK')))
        self._lora_max_active = (
            lora_max_active if lora_max_active is not None
            else env.get_int('SKYT_LORA_MAX_ACTIVE'))
        self.base_digest = base_digest or ''
        self._adapters: Dict[str, Dict[str, Any]] = {}
        self._adapter_lock = threading.Lock()
        self._adapter_demand: Dict[str, Dict[str, float]] = {}
        self._slot_adapter = np.zeros((max_slots,), np.int32)
        self._slot_adapter_name: List[Optional[str]] = \
            [None] * max_slots
        self._in_adapter_admit = False
        self._adapter_pool: Optional[AdapterPagePool] = None
        self._lora_store = None
        if n_lora > 0:
            # A block's charge counts every kv head of the mesh: the
            # accounting is the one-rank engine's, on the driver alone.
            block_bytes = (2 * self.cfg.n_layers * self.block_size *
                           self.cfg.n_kv_heads *
                           self.cfg.resolved_head_dim *
                           self.cache.k.element_size())
            if self.cache.quantized:
                block_bytes += 2 * self.cfg.n_layers * self.block_size * 4
            if self.is_driver:
                self._adapter_pool = AdapterPagePool(self._pool, n_lora,
                                                     block_bytes)
            self._lora_store = lora_lib.init_adapter_pages(
                self.cfg, n_lora, self._lora_max_rank,
                dtype=self.cfg.compute_dtype, device=self.device,
                shards=self._tp.degree if self._tp is not None else 1)
        self._pending_tok = np.zeros((max_slots,), np.int64)
        self._seeds = [seed + 1 + i for i in range(max_slots)]
        self._last_logits = torch.zeros((max_slots, self.cfg.vocab_size),
                                        dtype=torch.float32,
                                        device=self.device)
        self._pending: 'queue.Queue[_Request]' = queue.Queue()
        # Counters (monotonic).
        self._requests_total = 0
        self._completions_total = 0
        self._errors_total = 0
        self._prefill_errors_total = 0
        self._prefill_chunks_total = 0
        self._decode_steps_total = 0
        self._tokens_total = 0
        self._decode_seconds_total = 0.0
        self._queue_wait_seconds_total = 0.0
        self._prefix_hits_total = 0
        self._prefix_misses_total = 0
        self._prefix_tokens_reused_total = 0
        self._preemptions_total = 0
        self._draft_tokens_total = 0
        self._accepted_tokens_total = 0
        self._verify_steps_total = 0
        self._kv_exports_total = 0
        self._kv_imports_total = 0
        self._kv_import_fallbacks_total = 0
        self._request_ids = itertools.count(1)
        # Live weight refresh: tickets queue here; the serving loop
        # applies them at the top of an iteration. A drain ticket at the
        # head holds admission until the engine is idle.
        self.policy_version = 0
        self._refresh_queue: 'queue.Queue[_WeightRefresh]' = queue.Queue()
        self._refresh_hold = False
        self._weight_refreshes_total = 0
        self._refresh_shards_total = 0
        self._refresh_seconds_total = 0.0
        # The refresh copies' own stream (see _timed_copies).
        self._refresh_stream = (torch.cuda.Stream(self.device)
                                if self.device.type == 'cuda' else None)
        self._stop = threading.Event()
        self._wake = threading.Event()
        # Under a mesh: the error that ended the driver's loop (fatal).
        self._fatal: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._loop,
                                        name='continuous-batching',
                                        daemon=True)
        if self._mesh is None or self._mesh.driver:
            self._thread.start()

    # -- block-table plumbing -------------------------------------------

    def _sync_tables(self) -> None:
        """Push host block-table/length edits to the device cache. The
        tables are copied (``torch.tensor``): on the CPU ``as_tensor``
        would alias the host mirror, which the scheduler edits between
        steps."""
        if not self._bt_dirty:
            return
        self.cache = dataclasses.replace(
            self.cache,
            block_tables=torch.tensor(self._host_bt, device=self.device),
            lengths=torch.tensor(self._host_len.astype(np.int32),
                                 device=self.device))
        self._bt_dirty = False

    def _alloc_block(self) -> Optional[int]:
        """Pool alloc with prefix-cache LRU eviction under pressure.
        Only reclaimable entries are evicted. The last resort before
        preemption is reclaiming idle adapter pages (KV and adapter
        residency share one budget); the reentrancy guard keeps an
        adapter admission's own eviction loop in charge."""
        block = self._pool.alloc()
        while block is None and self._prefix is not None:
            if not self._prefix.evict_reclaimable():
                break
            block = self._pool.alloc()
        while (block is None and self._adapter_pool is not None and
               not self._in_adapter_admit):
            if self._adapter_pool.evict_lru(
                    on_evict=self._note_adapter_evict) is None:
                break
            block = self._pool.alloc()
        return block

    def _release_slot(self, slot: int) -> None:
        for block in self._slot_blocks[slot]:
            self._pool.decref(block)
        self._slot_blocks[slot] = []
        self._host_bt[slot, :] = 0
        self._host_len[slot] = 0
        self._slots[slot] = None
        self._decoding[slot] = False
        self._pending_tok[slot] = 0
        name = self._slot_adapter_name[slot]
        if name is not None:
            self._slot_adapter_name[slot] = None
            self._slot_adapter[slot] = 0
            if self._adapter_pool is not None and \
                    self._adapter_pool.page_of(name) is not None:
                self._adapter_pool.unpin(name)
        self._bt_dirty = True

    def _finish(self, request: _Request,
                error: Optional[BaseException] = None) -> None:
        """Single exit point: keeps requests == completions + errors +
        in-flight, whatever path a request dies on."""
        if error is not None:
            request.error = error
            self._errors_total += 1
        else:
            self._completions_total += 1
        if request.span is not None:
            self._record_decode_segment(request)
            request.span.finish(error=error,
                                tokens=len(request.generated))
            request.span = None
        request.done.set()

    @staticmethod
    def _record_decode_segment(request: _Request) -> None:
        """Close the current ``infer.decode`` span segment (finish OR
        preempt): segments end at preemption, so the requeue wait and
        the re-prefill are not billed as decode."""
        if request.span is None or request.decode_start_wall is None \
                or request.decode_start_mono is None:
            return
        tracing.record_span(
            'infer.decode', request.span.context,
            request.decode_start_wall,
            max(0.0, time.monotonic() - request.decode_start_mono),
            service='inference', tokens=len(request.generated))
        request.decode_start_wall = None
        request.decode_start_mono = None

    def _note_admitted(self, request: _Request) -> None:
        """Count a request's queue wait once (not again on a resume) and
        record its ``infer.queue_wait`` span."""
        if request.admitted:
            return
        request.admitted = True
        wait_s = max(0.0, time.monotonic() - request.arrival)
        self._queue_wait_seconds_total += wait_s
        if request.span is not None:
            tracing.record_span('infer.queue_wait', request.span.context,
                                request.arrival_wall, wait_s,
                                service='inference')

    @staticmethod
    def _start_decode_segment(request: _Request) -> None:
        if request.decode_start_wall is None:
            request.decode_start_wall = time.time()
            request.decode_start_mono = time.monotonic()

    def _fail_slot(self, slot: int, error: BaseException,
                   prefill: bool = False) -> None:
        request = self._slots[slot]
        self._release_slot(slot)
        if prefill:
            self._prefill_errors_total += 1
        if request is not None:
            self._finish(request, error)

    # -- multi-LoRA adapters --------------------------------------------

    def register_adapter(self, name: str, lora: Any, *,
                         alpha: float = lora_lib.DEFAULT_ALPHA,
                         base_digest: Optional[str] = None) -> None:
        """Make adapter ``name`` servable: its weights (an
        ``init_lora_params``-shaped dict of tensors or numpy arrays) go
        into the host registry; the device page is filled on the first
        request that needs it. ``base_digest`` (when both sides declare
        one) must match the engine's base weights."""
        if self._mesh is not None:
            self._mesh.require_driver('registering an adapter')
        if not name:
            raise ValueError('adapter name must be non-empty')
        if self._adapter_pool is None:
            raise RuntimeError(
                'engine has no adapter pages (construct with '
                'lora_pages=N or set SKYT_LORA_PAGES)')
        shape = tuple(lora['wq_a'].shape)
        rank = int(shape[-1])
        if rank > self._lora_max_rank:
            raise ValueError(
                f'adapter {name!r} rank {rank} exceeds the engine '
                f'page max_rank {self._lora_max_rank} '
                f'(SKYT_LORA_MAX_RANK)')
        if shape[0] != self.cfg.n_layers or shape[1] != self.cfg.d_model:
            raise ValueError(
                f'adapter {name!r} shape {shape} does not match the base '
                f'model [{self.cfg.n_layers}, {self.cfg.d_model}, r]')
        if base_digest and self.base_digest and \
                base_digest != self.base_digest:
            raise ValueError(
                f'adapter {name!r} was trained against base '
                f'{base_digest[:12]}...; this engine serves '
                f'{self.base_digest[:12]}...')
        host = {key: (value.detach().to('cpu', copy=True)
                      if isinstance(value, torch.Tensor)
                      else tensor_from_numpy(np.array(value)))
                for key, value in lora.items()}
        with self._adapter_lock:
            self._adapters[name] = {
                'lora': host,
                'alpha': float(alpha),
                'rank': rank,
                'base_digest': base_digest or '',
                'nbytes': lora_lib.adapter_nbytes(self.cfg, rank),
            }
            self._adapter_demand.setdefault(
                name, {'requests': 0, 'last_request': 0.0,
                       'last_evicted': 0.0})

    def adapters(self) -> List[str]:
        with self._adapter_lock:
            return sorted(self._adapters)

    def adapter_stats(self) -> Dict[str, Dict[str, float]]:
        """Per-adapter demand and residency snapshot (``/adapters``)."""
        resident = (set(self._adapter_pool.resident_names())
                    if self._adapter_pool is not None else set())
        out: Dict[str, Dict[str, float]] = {}
        with self._adapter_lock:
            for name, entry in self._adapters.items():
                demand = self._adapter_demand.get(name, {})
                out[name] = {
                    'rank': entry['rank'],
                    'resident': float(name in resident),
                    'active_slots': float(sum(
                        1 for n in self._slot_adapter_name if n == name)),
                    'requests': float(demand.get('requests', 0)),
                    'last_request': float(demand.get('last_request',
                                                     0.0)),
                    'last_evicted': float(demand.get('last_evicted',
                                                     0.0)),
                }
        return out

    def _note_adapter_evict(self, name: str) -> None:
        """Observes every adapter-page eviction BEFORE the pool
        mutates (chaos site ``infer.lora.evict``, demand bookkeeping):
        a fault here aborts the eviction with the pool as it was."""
        fault_injection.inject(LORA_EVICT_SITE)
        demand = self._adapter_demand.setdefault(
            name, {'requests': 0, 'last_request': 0.0,
                   'last_evicted': 0.0})
        demand['last_evicted'] = time.time()

    def _fetch_adapter(self, entry: Dict[str, Any]) -> Dict[str, Any]:
        """Stage a missed adapter's weights on the device, in the page
        store's dtype, before a page is claimed for it (chaos site
        ``infer.lora.fetch``: a failure here fails the request and
        retains nothing)."""
        fault_injection.inject(LORA_FETCH_SITE)
        ref = self._lora_store['wq_a']
        return {key: value.to(device=ref.device, dtype=ref.dtype)
                for key, value in entry['lora'].items()}

    def _ensure_adapter_resident(self, name: str) -> Optional[int]:
        """Device page of ``name``, uploading it on a miss. None = it
        cannot fit right now (the request stays queued, nothing is
        retained). Raises on unknown adapters and failed fetches."""
        with self._adapter_lock:
            entry = self._adapters.get(name)
        if entry is None:
            raise KeyError(f'adapter {name!r} is not registered')
        page = self._adapter_pool.lookup(name)
        if page is not None:
            return page
        weights = self._fetch_adapter(entry)
        self._in_adapter_admit = True
        try:
            page = self._adapter_pool.admit(
                name, entry['nbytes'], alloc=self._alloc_block,
                on_evict=self._note_adapter_evict)
        finally:
            self._in_adapter_admit = False
        if page is None:
            return None
        self._write_adapter_page(page, weights, entry['alpha'])
        return page

    def _write_adapter_page(self, page: int, weights: Dict[str, Any],
                            alpha: float) -> None:
        """Upload ``weights`` (staged by ``_fetch_adapter``) into page
        ``page``. Under a mesh the driver announces the page, the
        adapter's rank and alpha, then every rank writes the broadcast
        adapter (``_scatter_page``); a failure from the announcement on
        is fatal (``PlanFailed``)."""
        if self._mesh is None:
            lora_lib.write_adapter_page(self._lora_store, page, weights,
                                        alpha=alpha)
            return
        rank = int(weights['wq_a'].shape[-1])
        with self._step_guard():
            try:
                self._mesh.channel.publish(
                    _PLAN_WRITE_PAGE, [page, rank, sharding.float_bits(alpha)])
                self._scatter_page(page, rank, alpha, weights)
            except Exception as e:
                raise sharding.PlanFailed(
                    f'adapter page {page} write failed under the mesh') from e

    def _scatter_page(self, page: int, rank: int, alpha: float,
                      weights: Optional[Dict[str, Any]]) -> None:
        """Every rank: the driver's rank-``rank`` adapter, each leaf
        broadcast whole (a follower passes None), written into this
        rank's page ``page``: its head block of B, A whole."""
        d, hd = self.cfg.d_model, self.cfg.resolved_head_dim
        n = self.cfg.n_layers
        shapes = {'wq_a': (n, d, rank), 'wv_a': (n, d, rank),
                  'wq_b': (n, rank, self.cfg.n_heads, hd),
                  'wv_b': (n, rank, self.cfg.n_kv_heads, hd)}
        dtype = self._lora_store['wq_a'].dtype
        whole = {key: sharding.broadcast_whole(
            None if weights is None else weights[key], shape, dtype,
            self._tp, self.device) for key, shape in shapes.items()}
        lora_lib.write_adapter_page(self._lora_store, page, whole,
                                    alpha=alpha,
                                    shard=(self._tp.rank, self._tp.degree))

    def _quota_blocked(self, request: _Request) -> bool:
        """Per-adapter concurrency quota (``SKYT_LORA_MAX_ACTIVE``): an
        adapter at its cap waits in its lane; other lanes admit."""
        if not request.adapter or self._lora_max_active <= 0:
            return False
        active = sum(1 for name in self._slot_adapter_name
                     if name == request.adapter)
        return active >= self._lora_max_active

    def _lora_step_args(self):
        """(lora_pages, adapter_ids) for the steps: (None, None) on a
        non-LoRA engine or an all-base batch (no slot holds an adapter
        page), so those steps run exactly the base ops."""
        if self._adapter_pool is None or not self._slot_adapter.any():
            return (None, None)
        return (self._lora_store,
                torch.tensor(self._slot_adapter, device=self.device))

    # -- admission + chunked prefill ------------------------------------

    def _admit(self) -> None:
        """Bookkeeping-only admission: assign a free slot, reference
        cached prefix blocks, allocate private blocks for the prompt.
        The compute (chunked prefill) happens in ``_prefill_tick``."""
        if self._refresh_hold:
            return  # a drain-mode refresh is pending: admission held
        while True:
            try:
                self._waiting.push(self._pending.get_nowait())
            except queue.Empty:
                break
        while self._waiting:
            slot = next((s for s in range(self.max_slots)
                         if self._slots[s] is None), None)
            if slot is None:
                return
            if self._blocked_at_version == self._pool.version:
                return  # still memory-blocked; nothing changed since
            request = self._waiting.pop(blocked=self._quota_blocked)
            if request is None:
                return  # every lane head is quota-blocked
            try:
                if not self._begin_prefill(request, slot):
                    self._waiting.push_front(request)
                    self._blocked_at_version = self._pool.version
                    return
            except sharding.PlanFailed:
                raise  # fatal under a mesh: see _loop
            except Exception as e:  # pylint: disable=broad-except
                logger.warning('prefill admission failed: %s: %s',
                               type(e).__name__, e)
                self._prefill_errors_total += 1
                self._finish(request, e)
                continue
            self._blocked_at_version = None

    def _begin_prefill(self, request: _Request, slot: int) -> bool:
        """Returns False when the pool can't fit the prompt right now
        (request stays queued); raises when it never can. A migrated
        request imports its pulled KV instead, or falls back to a local
        re-prefill of the same tokens when the import fails."""
        if request.migration is not None:
            try:
                return self._import_migrated(request, slot,
                                             request.migration)
            except sharding.PlanFailed:
                raise  # fatal under a mesh: see _loop
            except Exception as e:  # pylint: disable=broad-except
                # The refcount-exact abort already ran: re-prefill the
                # same tokens; sampling at (seed, position) keeps the
                # stream identical.
                logger.warning('KV import failed (%s: %s); falling back '
                               'to local re-prefill', type(e).__name__, e)
                self._kv_import_fallbacks_total += 1
                request.migration = None
                request.handoff_start = None
        ids = request.token_ids + request.generated
        plen = len(ids)
        needed_total = math.ceil(plen / self.block_size)
        if needed_total > self._pool.total_blocks:
            raise RuntimeError(
                f'prompt needs {needed_total} KV blocks; pool has '
                f'{self._pool.total_blocks} (raise num_blocks)')
        if request.adapter and self._adapter_pool is None:
            raise RuntimeError(
                f'request names adapter {request.adapter!r} but the '
                'engine has no adapter pages (lora_pages=0)')
        # LoRA v-deltas make cached V adapter-specific: each adapter
        # keys its prefix chains under its own root.
        root = adapter_chain_root(request.adapter)
        shared: List[int] = []
        if self._prefix is not None:
            # Leave >= 1 prompt token to compute: the last token's
            # logits seed sampling and are never cached.
            shared = self._prefix.lookup(ids, limit_tokens=plen - 1,
                                         root=root)
        blocks = list(shared)
        # Admission watermark: one tail block of headroom per active
        # decoder, counting only RECLAIMABLE prefix entries as free.
        need_private = needed_total - len(shared)
        avail = self._pool.free_blocks + (
            self._prefix.reclaimable_blocks if self._prefix is not None
            else 0)
        if avail < need_private + sum(self._decoding):
            for block in blocks:
                self._pool.decref(block)
            return False
        while len(blocks) < needed_total:
            block = self._alloc_block()
            if block is None:
                for held in blocks:
                    self._pool.decref(held)
                return False
            blocks.append(block)
        adapter_page = 0
        if request.adapter:
            # After the KV blocks are held (the adapter admission's own
            # evictions cannot take them), before the commit: a raise
            # fails the request, None requeues it, both with the pool
            # exactly as it was.
            try:
                page = self._ensure_adapter_resident(request.adapter)
            except BaseException:
                for block in blocks:
                    self._pool.decref(block)
                raise
            if page is None:
                for block in blocks:
                    self._pool.decref(block)
                return False
            adapter_page = page
            self._adapter_pool.pin(request.adapter)
        start = len(shared) * self.block_size
        if self._prefix is not None:
            if shared:
                self._prefix_hits_total += 1
                self._prefix_tokens_reused_total += start
            else:
                self._prefix_misses_total += 1
        self._note_admitted(request)
        self._slot_blocks[slot] = blocks
        self._host_bt[slot, :] = 0
        self._host_bt[slot, :len(blocks)] = blocks
        self._host_len[slot] = start
        self._bt_dirty = True
        self._slots[slot] = request
        self._decoding[slot] = False
        self._slot_adapter[slot] = adapter_page
        self._slot_adapter_name[slot] = request.adapter or None
        self._admit_seq += 1
        self._admit_order[slot] = self._admit_seq
        self._prefilling.append(_PrefillState(request, slot, start, ids))
        return True

    def _prefill_tick(self) -> None:
        """Absorb ONE chunk of ONE prefilling prompt (FIFO)."""
        if not self._prefilling:
            return
        state = self._prefilling[0]
        request, slot = state.request, state.slot
        ids = state.ids
        chunk = ids[state.pos:state.pos + self.prefill_chunk]
        tokens = np.zeros((1, self.prefill_chunk), np.int32)
        tokens[0, :len(chunk)] = chunk
        self._sync_tables()
        lora_pages, _ = self._lora_step_args()
        adapter_id = (int(self._slot_adapter[slot])
                      if lora_pages is not None else None)
        chunk_wall = time.time()
        chunk_mono = time.monotonic()
        try:
            with self._step_guard():
                last, cache = _prefill_chunk_step(
                    self.params, torch.as_tensor(tokens, device=self.device),
                    state.pos, len(chunk), slot, self.cache, lora_pages,
                    adapter_id, cfg=self.cfg, announce=self._announcer(
                        _PLAN_PREFILL, adapter_id))
        except Exception as e:  # pylint: disable=broad-except
            if self._mesh is not None:
                raise  # fatal under a mesh: see _loop
            logger.warning('chunked prefill failed: %s: %s',
                           type(e).__name__, e)
            self._prefilling.pop(0)
            self._fail_slot(slot, e, prefill=True)
            return
        self.cache = cache
        state.pos += len(chunk)
        self._host_len[slot] = state.pos
        self._prefill_chunks_total += 1
        if request.span is not None:
            tracing.record_span(
                'infer.prefill_chunk', request.span.context, chunk_wall,
                max(0.0, time.monotonic() - chunk_mono),
                service='inference', tokens=len(chunk), slot=slot,
                pos=state.pos)
        if state.pos >= len(ids):
            self._prefilling.pop(0)
            if self.role == 'prefill':
                # Prefill fleet: never decode. Pack the slot's KV and
                # last logits for the decode side's pull and give the
                # blocks straight back (the export holds host copies).
                self._export_prefill(request, slot, ids, last[0])
                return
            self._last_logits[slot] = last[0].float()
            self._seeds[slot] = request.seed
            if self._draft is not None:
                # The speculative pending token: exactly what the plain
                # step would sample next (same logits, same position).
                # A preempted request resumes here too, by re-prefill.
                self._pending_tok[slot] = _sample_pending_step(
                    self._last_logits[slot], request.seed, state.pos,
                    request.temperature)
            self._decoding[slot] = True
            self._start_decode_segment(request)
            if self._prefix is not None:
                self._prefix.insert(ids, self._slot_blocks[slot],
                                    root=adapter_chain_root(
                                        request.adapter))

    # -- disaggregated prefill/decode -----------------------------------

    def _pool_fields(self) -> Dict[str, torch.Tensor]:
        """The pool tensors a block's payload carries, by wire name."""
        cache = self.cache
        fields = {'k': cache.k, 'v': cache.v}
        if cache.quantized:
            fields.update(k_scale=cache.k_scale, v_scale=cache.v_scale)
        return fields

    def _read_block_arrays(self, block_ids: List[int]
                           ) -> List[Dict[str, torch.Tensor]]:
        """Host copies of the pool KV at ``block_ids`` (one batched
        device read per field), one name->tensor dict per block:
        ``k``/``v`` [L, block_size, kv_heads, head_dim] and, for an int8
        pool, ``k_scale``/``v_scale`` [L, block_size, kv_heads]. Under a
        mesh every rank reads its heads of the blocks the driver
        announces and one gather a field joins them in rank order: the
        driver gets every kv head, as one rank's pool holds them."""
        if not block_ids:
            return []
        idx = torch.tensor(block_ids, dtype=torch.long, device=self.device)
        with self._step_guard():
            if self._mesh is not None:
                self._mesh.channel.publish(_PLAN_READ_BLOCKS, idx)
            slices = self._block_slices(idx)
        # Block-major on the host, so each block's slice of the copy is
        # contiguous; the copy never aliases the pool.
        host = {name: x.transpose(0, 1).contiguous().cpu()
                for name, x in slices.items()}
        return [{name: tensor[i] for name, tensor in host.items()}
                for i in range(len(block_ids))]

    def _block_slices(self, idx: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Each pool field at blocks ``idx`` ([L, n, block_size,
        kv_heads, ...]) with every rank's kv heads (a collective under a
        mesh: the driver and its followers call it for one plan)."""
        return {name: sharding.gather_kv_heads(pool.index_select(1, idx),
                                               self._tp)
                for name, pool in self._pool_fields().items()}

    def _whole_block(self, pool: torch.Tensor) -> tuple:
        """The shape of one block of a pool field with every kv head of
        the mesh ([L, block_size, kv_heads, ...]): a payload's."""
        degree = self._tp.degree if self._tp is not None else 1
        return ((pool.shape[0], pool.shape[2],
                 pool.shape[sharding.KV_HEAD_AXIS] * degree) +
                tuple(pool.shape[4:]))

    def _write_block_arrays(self, writes: List[tuple]) -> None:
        """Scatter ``(block_id, arrays)`` payloads into the pool in place
        (one batched host->device write per field). A payload whose
        fields, dtypes or shapes are not this pool's (every kv head of
        the mesh) raises before any field is written or any plan is
        announced."""
        if not writes:
            return
        fields = self._pool_fields()
        for _, arrays in writes:
            if set(arrays) != set(fields):
                raise RuntimeError(f'migrated block carries '
                                   f'{sorted(arrays)}; this pool holds '
                                   f'{sorted(fields)}')
            for name, pool in fields.items():
                array = arrays[name]
                want = self._whole_block(pool)
                if array.dtype != pool.dtype or tuple(array.shape) != want:
                    raise RuntimeError(
                        f'migrated {name} is {array.dtype} '
                        f'{tuple(array.shape)}; this pool takes '
                        f'{pool.dtype} {want}')
        idx = torch.tensor([b for b, _ in writes], dtype=torch.long,
                           device=self.device)
        stacked = {name: torch.stack([arrays[name] for _, arrays in writes],
                                     dim=1).to(self.device)
                   for name in fields}
        with self._step_guard():
            if self._mesh is not None:
                self._mesh.channel.publish(_PLAN_WRITE_BLOCKS, idx)
            self._scatter_blocks(idx, stacked)

    def _scatter_blocks(self, idx: torch.Tensor,
                        stacked: Optional[Dict[str, torch.Tensor]]) -> None:
        """Write whole-head block slices (name -> [L, n, block_size,
        kv_heads, ...]) into this rank's kv heads of the pool at blocks
        ``idx``. Under a mesh the driver's slices reach every rank (a
        follower passes None)."""
        for name, pool in self._pool_fields().items():
            whole = stacked[name] if stacked is not None else None
            if self._tp is not None:
                block = self._whole_block(pool)
                whole = sharding.broadcast_whole(
                    whole, (block[0], len(idx)) + block[1:], pool.dtype,
                    self._tp, self.device)
            pool.index_copy_(1, idx, sharding.local_kv_heads(whole,
                                                             self._tp))

    def _export_prefill(self, request: _Request, slot: int,
                        ids: List[int], last_row: torch.Tensor) -> None:
        """Prefill-role completion: serialize the slot's KV (full blocks
        one by one, the migration's delta unit; the partial tail block
        and the fp32 last-logits row as the tail), park it in the
        exporter, finish the request with no generated token and release
        the slot."""
        plen = len(ids)
        n_full = plen // self.block_size
        blocks = self._slot_blocks[slot]
        root = adapter_chain_root(request.adapter)
        try:
            host = self._read_block_arrays(blocks)
            payloads = [kv_migrate.pack_arrays(host[i])
                        for i in range(n_full)]
            tail_arrays = {'logits': last_row.float()}
            if plen % self.block_size:
                for name, array in host[n_full].items():
                    tail_arrays[f'tail_{name}'] = array
            export = kv_migrate.KvExport(
                request_id=request.request_id, ids=list(ids),
                block_size=self.block_size,
                digests=chain_digests(ids, self.block_size, root=root),
                blocks=payloads, tail=kv_migrate.pack_arrays(tail_arrays),
                meta={'seed': request.seed, 'n_tokens': plen,
                      'adapter': request.adapter or ''},
                created=time.monotonic())
        except Exception as e:  # pylint: disable=broad-except
            logger.warning('KV export failed: %s: %s', type(e).__name__, e)
            self._fail_slot(slot, e, prefill=True)
            return
        self.exporter.put(export)
        self._kv_exports_total += 1
        if self._prefix is not None:
            # Later prompts sharing this prefix prefill only their suffix,
            # and their exports list the shared blocks under the same
            # chain digests.
            self._prefix.insert(ids, blocks, root=root)
        self._finish(request)
        self._release_slot(slot)

    def _import_migrated(self, request: _Request, slot: int,
                         pulled) -> bool:
        """Decode-role admission of a migrated prefill: acquire blocks
        through a refcount-exact import (the resident prefix re-used in
        place, payloads written only into freshly allocated blocks), set
        the slot's last logits and enter decode with no prefill compute.
        Returns False when the pool cannot fit it right now (the request
        stays queued); raises on any integrity problem, with the pool
        and the prefix cache exactly as they were."""
        ids = request.token_ids + request.generated
        plen = len(ids)
        manifest = pulled.manifest
        if (manifest['n_tokens'] != plen or
                manifest['block_size'] != self.block_size):
            raise RuntimeError(
                f'migration manifest mismatch: {manifest["n_tokens"]} '
                f'tokens/bs={manifest["block_size"]} vs local '
                f'{plen}/bs={self.block_size}')
        root = adapter_chain_root(request.adapter)
        digests = chain_digests(ids, self.block_size, root=root)
        if [row['digest'] for row in manifest['blocks']] != digests:
            raise RuntimeError('migration chain digests diverge from the '
                               'local token stream')
        n_full = plen // self.block_size
        needed_total = math.ceil(plen / self.block_size)
        if needed_total > self._pool.total_blocks:
            raise RuntimeError(
                f'migrated prompt needs {needed_total} KV blocks; pool '
                f'has {self._pool.total_blocks}')
        # The admission watermark of _begin_prefill: one tail block of
        # headroom per active decoder.
        resident_now = (self._prefix.resident_chain(ids, root=root)
                        if self._prefix is not None else [])
        need_private = needed_total - len(resident_now)
        avail = self._pool.free_blocks + (
            self._prefix.reclaimable_blocks if self._prefix is not None
            else 0)
        if avail < need_private + sum(self._decoding):
            return False
        adapter_page = 0
        if request.adapter:
            page = self._ensure_adapter_resident(request.adapter)
            if page is None:
                return False
            adapter_page = page
            # Pinned now: the import's own allocations go through
            # _alloc_block, whose adapter eviction must not take it.
            self._adapter_pool.pin(request.adapter)
        importer = BlockImporter(self._pool, self._prefix)
        got = importer.begin(ids, needed_total, block_size=self.block_size,
                             alloc=self._alloc_block, root=root)
        if got is None:
            if request.adapter:
                self._adapter_pool.unpin(request.adapter)
            return False
        blocks, n_resident = got
        try:
            writes = []
            for i in range(n_full):
                if i < n_resident:
                    continue  # resident: the cached copy is canonical
                payload = pulled.payloads[i]
                if payload is None:
                    # The pull's residency probe was optimistic and the
                    # entry was evicted since: the payload never moved.
                    raise RuntimeError(f'block {i} evicted mid-migration '
                                       'and its payload was not pulled')
                writes.append((blocks[i], kv_migrate.unpack_arrays(payload)))
            tail = kv_migrate.unpack_arrays(pulled.tail)
            if plen % self.block_size:
                tail_block = {name[len('tail_'):]: array
                              for name, array in tail.items()
                              if name.startswith('tail_')}
                if not tail_block:
                    raise RuntimeError('migration tail payload is missing '
                                       'the partial block')
                writes.append((blocks[n_full], tail_block))
            logits = tail['logits']
            if tuple(logits.shape) != (self.cfg.vocab_size,):
                raise RuntimeError(f'migrated logits row is '
                                   f'{tuple(logits.shape)}; vocab is '
                                   f'{self.cfg.vocab_size}')
            self._write_block_arrays(writes)
            self._last_logits[slot] = logits.to(self.device, torch.float32)
        except Exception:
            importer.abort()
            if request.adapter:
                self._adapter_pool.unpin(request.adapter)
            raise
        importer.commit()
        self._note_admitted(request)
        self._slot_blocks[slot] = list(blocks)
        self._host_bt[slot, :] = 0
        self._host_bt[slot, :len(blocks)] = blocks
        self._host_len[slot] = plen
        self._bt_dirty = True
        self._slots[slot] = request
        self._slot_adapter[slot] = adapter_page
        self._slot_adapter_name[slot] = request.adapter or None
        self._admit_seq += 1
        self._admit_order[slot] = self._admit_seq
        self._seeds[slot] = request.seed
        if self._draft is not None:
            self._pending_tok[slot] = _sample_pending_step(
                self._last_logits[slot], request.seed, plen,
                request.temperature)
        self._decoding[slot] = True
        self._start_decode_segment(request)
        if self._prefix is not None:
            self._prefix.insert(ids, blocks, root=root)
        request.migration = None  # a later preemption re-prefills
        self._kv_imports_total += 1
        if request.handoff_start is not None:
            metrics.DISAGG_HANDOFF.observe(
                max(0.0, time.monotonic() - request.handoff_start))
            request.handoff_start = None
        return True

    def _preempt(self, slot: int, active_mask: np.ndarray) -> None:
        """Release a slot's blocks (decoding OR mid-prefill) and requeue
        its request at the FRONT of its admission lane; it resumes by
        re-prefilling prompt + generated-so-far."""
        request = self._slots[slot]
        self._prefilling = [s for s in self._prefilling
                            if s.slot != slot]
        self._release_slot(slot)
        active_mask[slot] = False
        self._preemptions_total += 1
        if request is not None:
            if request.span is not None:
                # Close the decode segment here: the requeue wait and
                # the resume's re-prefill are not decode.
                self._record_decode_segment(request)
                tracing.record_span(
                    'infer.preempt', request.span.context, time.time(),
                    0.0, service='inference', slot=slot,
                    generated=len(request.generated))
            self._waiting.push_front(request)
            self._wake.set()

    def _ensure_decode_blocks(self, active_mask: np.ndarray,
                              needed: Optional[np.ndarray] = None
                              ) -> None:
        """A slot about to write positions ``length .. length + n - 1``
        needs tail blocks covering them BEFORE the step (``needed``:
        per-slot token counts, default 1, the plain decode step). When
        the pool is exhausted even after prefix eviction, the most
        recently admitted request is preempted (the oldest request
        always progresses, so the system drains)."""
        for slot in range(self.max_slots):
            if not active_mask[slot]:
                continue
            length = int(self._host_len[slot])
            n_new = 1 if needed is None else int(needed[slot])
            if n_new <= 0:
                continue
            last_pos = min(length + n_new, self.max_len) - 1
            failed = False
            for index in range(length // self.block_size,
                               last_pos // self.block_size + 1):
                if index >= self.blocks_per_slot:
                    break  # finish check retires it this step
                if self._host_bt[slot, index] != 0:
                    continue
                while True:
                    block = self._alloc_block()
                    if block is not None:
                        self._slot_blocks[slot].append(block)
                        self._host_bt[slot, index] = block
                        self._bt_dirty = True
                        break
                    victims = [s for s in range(self.max_slots)
                               if s != slot and self._slots[s] is not None]
                    if not victims:
                        active_mask[slot] = False
                        self._fail_slot(slot, RuntimeError(
                            'KV block pool exhausted mid-decode (raise '
                            'num_blocks or lower max_slots)'))
                        failed = True
                        break
                    victim = max(victims,
                                 key=lambda s: self._admit_order[s])
                    self._preempt(victim, active_mask)
                if failed:
                    break

    def _trim_slot_blocks(self, slot: int, new_len: int) -> None:
        """Speculative rollback: positions >= ``new_len`` are dead
        (rejected drafts, post-eos rows); tail blocks past the last
        live one go back to the pool, leaving exactly the blocks a
        plain run at ``new_len`` holds. Shared prefix blocks cover
        positions below the prefill length <= new_len, so only private
        verify-window blocks are ever trimmed."""
        keep = -(-new_len // self.block_size)
        blocks = self._slot_blocks[slot]
        if len(blocks) <= keep:
            return
        for index in range(keep, len(blocks)):
            self._pool.decref(blocks[index])
            self._host_bt[slot, index] = 0
        self._slot_blocks[slot] = blocks[:keep]
        self._bt_dirty = True

    # -- speculative verify step ----------------------------------------

    def _spec_step(self, active_mask: np.ndarray) -> None:
        """Draft -> batched verify -> accept/rollback for every decoding
        slot; scheduled exactly like a decode step."""
        q_len = self._spec_window
        inputs = np.zeros((self.max_slots, q_len), np.int32)
        n_input = np.ones((self.max_slots,), np.int32)
        for slot in range(self.max_slots):
            if not active_mask[slot]:
                continue
            request = self._slots[slot]
            length = int(self._host_len[slot])
            # Never draft past what the request can still emit or the
            # slot can still hold: a shrunken window is a plain step.
            cap = max(1, min(q_len,
                             request.max_new_tokens -
                             len(request.generated),
                             self.max_len - length))
            pending = int(self._pending_tok[slot])
            inputs[slot, 0] = pending
            n = 1
            if cap > 1:
                history = (request.token_ids + request.generated +
                           [pending])
                for tok in self._draft.propose(history, cap - 1):
                    inputs[slot, n] = int(tok)
                    n += 1
            n_input[slot] = n
        self._ensure_decode_blocks(active_mask, needed=n_input)
        if not active_mask.any():
            return
        self._draft_tokens_total += int((n_input[active_mask] - 1).sum())
        self._sync_tables()
        temps = [r.temperature if r else 0.0 for r in self._slots]
        positions = [int(n) for n in self._host_len]
        lora_pages, adapter_ids = self._lora_step_args()
        step_t0 = time.perf_counter()
        try:
            with self._step_guard():
                n_emit, pending_next, cache = _spec_verify_all_step(
                    self.params, self.cache,
                    torch.as_tensor(inputs, device=self.device),
                    torch.as_tensor(n_input, device=self.device),
                    torch.as_tensor(active_mask, device=self.device),
                    temps, self._seeds, positions, lora_pages, adapter_ids,
                    cfg=self.cfg, q_len=q_len,
                    announce=self._announcer(_PLAN_VERIFY, adapter_ids))
        except Exception as e:  # pylint: disable=broad-except
            if self._mesh is not None:
                raise  # fatal under a mesh: see _loop
            logger.warning('speculative verify step failed: %s: %s',
                           type(e).__name__, e)
            for slot in range(self.max_slots):
                if active_mask[slot] and self._slots[slot] is not None:
                    self._fail_slot(slot, e)
            return
        self.cache = cache
        self._verify_steps_total += 1
        # Overlap the readback with admission bookkeeping only: a
        # prefill tick would sync tables while the verified slots' host
        # lengths are stale until n_emit lands.
        overlap_t0 = time.perf_counter()
        self._admit()
        overlap_cost = time.perf_counter() - overlap_t0
        host_emit = n_emit.tolist()
        host_pending = pending_next.tolist()
        self._decode_seconds_total += (time.perf_counter() - step_t0 -
                                       overlap_cost)
        for slot in range(self.max_slots):
            request = self._slots[slot]
            if request is None or not active_mask[slot]:
                continue
            m = int(host_emit[slot])
            if m <= 0:
                continue
            emitted = []
            for tok in inputs[slot, :m]:
                emitted.append(int(tok))
                if (request.eos_id is not None and
                        int(tok) == request.eos_id):
                    break  # post-eos acceptances are dead rows
            # Count acceptance after the eos truncation: drafts accepted
            # on the device but cut as post-eos rows were never
            # delivered.
            self._accepted_tokens_total += len(emitted) - 1
            request.generated.extend(emitted)
            self._tokens_total += len(emitted)
            new_len = int(self._host_len[slot]) + len(emitted)
            self._host_len[slot] = new_len
            if len(emitted) < m:
                # The device advanced by m: re-sync the truncated mirror.
                self._bt_dirty = True
            self._trim_slot_blocks(slot, new_len)
            self._pending_tok[slot] = int(host_pending[slot])
            finished = (
                (request.eos_id is not None and
                 emitted[-1] == request.eos_id) or
                len(request.generated) >= request.max_new_tokens or
                new_len >= self.max_len)
            if finished:
                observe = getattr(self._draft, 'observe', None)
                if observe is not None:
                    # Feed the completion corpus: a repeated query
                    # drafts its answer from the last one.
                    observe(request.token_ids + request.generated)
                self._finish(request)
                self._release_slot(slot)  # blocks back to the pool

    # -- serving loop ---------------------------------------------------

    def _loop(self) -> None:
        with torch.no_grad(), mesh_context(self._tp):
            if self._mesh is None:
                self._loop_body()
                return
            try:
                self._loop_body()
            except Exception as e:  # pylint: disable=broad-except
                # A failed step under a mesh is fatal: the ranks'
                # collectives no longer line up.
                logger.exception('tensor-parallel step failed; the engine '
                                 'stops serving')
                self._fatal = e
                self._fail_everything(e)

    # -- tensor-parallel driver and followers ---------------------------

    def _step_guard(self):
        """The plan channel's lock around a step (plan + collectives),
        so the keep-alive never lands inside one; a no-op unsharded."""
        if self._mesh is None:
            return contextlib.nullcontext()
        return self._mesh.channel.lock

    def _announcer(self, op: int, adapter_ids=None):
        """The step's plan publisher on a mesh's driver, else None. The
        plan is whether the step reads adapter pages, the step's own
        arguments, the slots' adapter pages (``adapter_ids``: the
        prefill slot's page, or ``[slots]`` pages; None = an all-base
        step, which runs the base ops on every rank), then the pool's
        lengths and block tables as the step will read them."""
        if self._mesh is None:
            return None
        lora = [] if adapter_ids is None else [adapter_ids]

        def announce(*args):
            scalars = [a for a in args if not isinstance(a, torch.Tensor)]
            tensors = [a for a in args if isinstance(a, torch.Tensor)]
            if op in (_PLAN_PREFILL, _PLAN_VERIFY):
                scalars.append(tensors[0].shape[1])
            self._mesh.channel.publish(op, [len(lora)], scalars, *tensors,
                                       *lora, self.cache.lengths,
                                       self.cache.block_tables)

        return announce

    def _fail_everything(self, error: BaseException) -> None:
        """Fail every request the engine holds (the fatal path)."""
        for slot in range(self.max_slots):
            if self._slots[slot] is not None:
                self._fail_slot(slot, error)
        self._prefilling = []
        while self._waiting:
            self._finish(self._waiting.pop(), error)
        while True:
            try:
                self._finish(self._pending.get_nowait(), error)
            except queue.Empty:
                break

    @property
    def is_driver(self) -> bool:
        """True unless this engine is a follower rank of a mesh."""
        return self._mesh is None or self._mesh.driver

    def follow(self) -> None:
        """A follower rank's loop: run each step the driver announces
        on this rank's shards (the plan brings the lengths, the block
        tables and the slots' adapter pages; this rank keeps only its
        part of the pool and of the page store), and write each block,
        adapter page and refreshed leaf the driver broadcasts; returns
        when the driver shuts down."""
        if self._mesh is None or self._mesh.driver:
            raise RuntimeError('follow() runs on the follower ranks of a '
                               'tensor-parallel mesh')
        slots, bps = self.max_slots, self.blocks_per_slot
        with torch.no_grad(), mesh_context(self._tp):
            while True:
                op, payload = self._mesh.channel.receive()
                if op == sharding.PLAN_STOP:
                    return
                plan = sharding.PlanReader(payload)
                if op == _PLAN_READ_BLOCKS:
                    self._block_slices(payload)
                    continue
                if op == _PLAN_WRITE_BLOCKS:
                    self._scatter_blocks(payload, None)
                    continue
                if op == _PLAN_WRITE_PAGE:
                    page, rank, alpha = plan.ints(3)
                    self._scatter_page(page, rank, sharding.bits_float(alpha),
                                       None)
                    continue
                if op == _PLAN_REFRESH:
                    self._refresh_leaves(plan.ints(payload.numel()), None)
                    continue
                if op not in (_PLAN_PREFILL, _PLAN_DECODE, _PLAN_VERIFY):
                    continue  # keep-alive
                (lora,) = plan.ints(1)
                if op == _PLAN_PREFILL:
                    start, n_new, slot, c = plan.ints(4)
                    tokens = plan.take(c, (1, c), torch.int32)
                elif op == _PLAN_DECODE:
                    tokens = plan.take(slots, None, torch.int32)
                    active = plan.take(slots, None, torch.bool)
                else:
                    (q_len,) = plan.ints(1)
                    tokens = plan.take(slots * q_len, (slots, q_len),
                                       torch.int32)
                    n_input = plan.take(slots, None, torch.int32)
                    active = plan.take(slots, None, torch.bool)
                pages = self._lora_store if lora else None
                ids = None
                if lora:
                    ids = plan.take(1 if op == _PLAN_PREFILL else slots,
                                    None, torch.int32)
                cache = dataclasses.replace(
                    self.cache,
                    lengths=plan.take(slots, None, torch.int32),
                    block_tables=plan.take(slots * bps, (slots, bps),
                                           torch.int32))
                if op == _PLAN_PREFILL:
                    _, self.cache = decode_lib.prefill_chunk(
                        self.params, tokens, start, n_new, slot, cache,
                        self.cfg, lora_pages=pages,
                        adapter_id=None if ids is None else int(ids[0]))
                elif op == _PLAN_DECODE:
                    _, self.cache = decode_lib.paged_decode_step(
                        self.params, tokens, cache, self.cfg,
                        active=active, lora_pages=pages, adapter_ids=ids)
                else:
                    _, self.cache = decode_lib.paged_verify_step(
                        self.params, tokens, cache, self.cfg,
                        active=active, n_input=n_input, lora_pages=pages,
                        adapter_ids=ids)

    # -- live weight refresh --------------------------------------------

    def request_refresh(self, updates=None, *, params=None,
                        version: Optional[int] = None,
                        mode: str = 'step') -> _WeightRefresh:
        """Queue a live weight refresh; returns the ticket (wait on
        ``.done``, then check ``.error``).

        Exactly one of ``updates`` (a ``flatten_param_paths``-keyed dict
        of new values, tensors or numpy arrays: the delta path) or
        ``params`` (a whole tree with the engine's paths) must be given.
        The new values are copied into the engine's dtype and device
        here, before this returns, so a caller may change its tensors
        at once; the serving loop copies them into the engine's leaves
        at the next step boundary. Raises ``KeyError`` for a path the
        engine does not have (or, with ``params``, one it lacks),
        ``ValueError`` for a shape that is not the leaf's, and
        ``TypeError`` for a W8A8 ``QTensor`` leaf, which cannot take an
        unquantized value; the weights and the version are then
        untouched. ``mode='step'`` swaps with generation running;
        ``'drain'`` holds admission and waits for in-flight requests
        first. ``version`` defaults to the current one plus one.

        Under a mesh it runs on the driver, and every value has its
        leaf's whole shape (this rank's slice times the degree along
        the axis its path's rule shards); all checks are made here,
        before any rank changes anything, and every rank copies its
        slice at the same step boundary."""
        if self._mesh is not None:
            self._mesh.require_driver('a weight refresh')
        if (updates is None) == (params is None):
            raise ValueError(
                'pass exactly one of updates= (delta shards) or '
                'params= (full tree)')
        if mode not in ('step', 'drain'):
            raise ValueError(
                f"refresh mode must be 'step' or 'drain', got {mode!r}")
        targets = flatten_param_paths(self.params)
        new = updates if params is None else flatten_param_paths(params)
        unknown = sorted(set(new) - set(targets))
        if unknown:
            raise KeyError(
                f'refresh updates name {len(unknown)} unknown param '
                f'shards (first: {unknown[:3]}); learner and engine '
                f'param trees have diverged')
        missing = sorted(set(targets) - set(new)) if params is not None \
            else []
        if missing:
            raise KeyError(f'full refresh lacks {len(missing)} param '
                           f'shards (first: {missing[:3]})')
        paths = sorted(targets)
        shardings = self._leaf_shardings()
        pairs = []
        for path in sorted(new):
            leaf = targets[path]
            if isinstance(leaf, QTensor):
                raise TypeError(
                    f'{path} is an int8 W8A8 weight; a refresh '
                    f'cannot write an unquantized value into it')
            value = new[path]
            if not isinstance(value, torch.Tensor):
                value = tensor_from_numpy(np.asarray(value))
            want = (tuple(leaf.shape) if shardings is None else
                    shardings[path].full_shape(leaf.shape))
            if tuple(value.shape) != want:
                raise ValueError(
                    f'refresh of {path}: shape {tuple(value.shape)} '
                    f'!= the engine leaf\'s {want}')
            # Under a mesh the serving loop finds the leaf by its index.
            pairs.append((leaf if shardings is None
                          else paths.index(path), leaf, value.detach()))

        def snapshot():
            return [(key, value.to(device=leaf.device, dtype=leaf.dtype,
                                   copy=True)) for key, leaf, value in pairs]

        copies, seconds = self._timed_copies(snapshot)
        ticket = _WeightRefresh(copies, version, mode, seconds)
        self._refresh_queue.put(ticket)
        self._wake.set()
        return ticket

    def refresh_weights(self, updates=None, *, params=None,
                        version: Optional[int] = None,
                        mode: str = 'step',
                        timeout: float = 120.0) -> int:
        """Blocking :meth:`request_refresh`; returns the new
        ``policy_version``."""
        ticket = self.request_refresh(updates, params=params,
                                      version=version, mode=mode)
        if not ticket.done.wait(timeout):
            raise TimeoutError('weight refresh timed out')
        if ticket.error is not None:
            raise ticket.error
        return self.policy_version

    def _refresh_tick(self) -> None:
        """Serving loop only: apply the queued refreshes at the step
        boundary (the top of a loop iteration, before admission,
        prefill or decode read the weights). Each copy writes an engine
        leaf in place, on the stream the steps run on."""
        while not self._refresh_queue.empty():
            ticket = self._refresh_queue.queue[0]  # peek; sole consumer
            if ticket.mode == 'drain':
                self._refresh_hold = True
                if any(r is not None for r in self._slots) or \
                        self._prefilling:
                    return  # in-flight work finishes on the old weights
            self._refresh_queue.get_nowait()
            seconds = 0.0
            try:
                fault_injection.inject(WEIGHT_REFRESH_SITE)
                t0 = time.perf_counter()
                if self._mesh is None:
                    n_shards, seconds = self._timed_copies(
                        lambda: self._apply_updates(ticket.copies))
                    ticket.nbytes = sum(v.numel() * v.element_size()
                                        for _, v in ticket.copies)
                else:
                    n_shards, seconds, ticket.nbytes = \
                        self._refresh_mesh(ticket.copies)
                ticket.apply_seconds = time.perf_counter() - t0
                self.policy_version = (int(ticket.version)
                                       if ticket.version is not None
                                       else self.policy_version + 1)
                ticket.applied_shards = n_shards
                self._weight_refreshes_total += 1
                self._refresh_shards_total += n_shards
            except Exception as e:  # pylint: disable=broad-except
                ticket.error = e
                if isinstance(e, sharding.PlanFailed):
                    raise  # fatal under a mesh: see _loop
                logger.warning('live weight refresh failed: %s: %s',
                               type(e).__name__, e)
            finally:
                ticket.copies = []
                self._refresh_seconds_total += (ticket.prepare_seconds +
                                                seconds)
                queued = self._refresh_queue.queue
                self._refresh_hold = bool(queued) and \
                    queued[0].mode == 'drain'
                ticket.done.set()

    def _apply_updates(self, copies) -> int:
        """Write each (engine leaf, new value) pair in place; the values
        already have the leaf's dtype, device and shape
        (``request_refresh`` made them). Returns the number of leaves
        written."""
        for leaf, value in copies:
            leaf.copy_(value)
        return len(copies)

    def _leaf_shardings(self) -> Optional[Dict[str, Any]]:
        """Under a mesh, each param path's ``NamedSharding`` (the rule
        ``prepare_engine`` sliced the leaf by); None unsharded."""
        if self._mesh is None:
            return None
        from skypilot_tpu_torch.models import llama
        from skypilot_tpu_torch.parallel.sharding import param_shardings
        return flatten_param_paths(param_shardings(
            self._mesh.mesh, llama.param_logical_axes(self.cfg)))

    def _refresh_mesh(self, copies):
        """Driver: announce the refreshed leaves (their indices in the
        sorted paths), then apply them on every rank
        (``_refresh_leaves``); a failure from the announcement on is
        fatal (``PlanFailed``)."""
        indices = [index for index, _ in copies]
        with self._step_guard():
            try:
                self._mesh.channel.publish(_PLAN_REFRESH, indices)
                return self._refresh_leaves(indices,
                                            [v for _, v in copies])
            except Exception as e:
                raise sharding.PlanFailed(
                    'weight refresh failed under the mesh') from e

    def _refresh_leaves(self, indices: List[int],
                        values: Optional[List[torch.Tensor]]):
        """Every rank: each leaf's whole new value broadcast from the
        driver (a follower passes None), narrowed to this rank's slice
        by its path's rule (``shard_leaf``) and copied into the leaf in
        place on the refresh stream, one leaf at a time. Returns
        (leaves written, the copies' seconds, bytes broadcast)."""
        from skypilot_tpu_torch.parallel.sharding import shard_leaf
        targets = flatten_param_paths(self.params)
        paths = sorted(targets)
        shardings = self._leaf_shardings()
        seconds, nbytes = 0.0, 0
        for k, index in enumerate(indices):
            path = paths[index]
            leaf, rule = targets[path], shardings[path]
            whole = sharding.broadcast_whole(
                None if values is None else values[k],
                rule.full_shape(leaf.shape), leaf.dtype, self._tp,
                self.device)
            local = shard_leaf(rule, whole, torch.distributed.get_rank())
            _, copy_s = self._timed_copies(lambda: leaf.copy_(local))
            seconds += copy_s
            nbytes += whole.numel() * whole.element_size()
            del whole, local
        return len(indices), seconds, nbytes

    def _timed_copies(self, enqueue):
        """Run ``enqueue`` (a refresh's copies) to completion and return
        (its result, its seconds). On the card the copies run on the
        engine's refresh stream, after the work already queued on the
        calling thread's stream (a decode step in flight, a learner's
        last update), and the seconds are the device time between CUDA
        events around them alone: ``refresh_seconds`` counts the copies
        and no decode work. On the CPU, wall seconds."""
        if self.device.type != 'cuda':
            t0 = time.perf_counter()
            with torch.no_grad():
                out = enqueue()
            return out, time.perf_counter() - t0
        stream = self._refresh_stream
        stream.wait_stream(torch.cuda.current_stream(self.device))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.no_grad(), torch.cuda.stream(stream):
            start.record(stream)
            out = enqueue()
            end.record(stream)
        end.synchronize()
        return out, start.elapsed_time(end) / 1e3

    def _loop_body(self) -> None:
        while not self._stop.is_set():
            self._refresh_tick()
            self._admit()
            self._prefill_tick()
            active_mask = np.array(self._decoding, bool)
            if not active_mask.any():
                if self._prefilling or self._waiting or \
                        not self._pending.empty():
                    continue  # keep absorbing prefill chunks
                self._wake.wait(0.01)
                self._wake.clear()
                continue
            if self._draft is not None:
                self._spec_step(active_mask)
                continue
            self._ensure_decode_blocks(active_mask)
            if not active_mask.any():
                continue
            self._sync_tables()
            temps = [r.temperature if r else 0.0 for r in self._slots]
            positions = [int(n) for n in self._host_len]
            lora_pages, adapter_ids = self._lora_step_args()
            step_t0 = time.perf_counter()
            try:
                with self._step_guard():
                    tokens, logits, cache = _decode_all_step(
                        self.params, self._last_logits, self.cache,
                        torch.as_tensor(active_mask, device=self.device),
                        temps, self._seeds, positions, lora_pages,
                        adapter_ids, cfg=self.cfg,
                        announce=self._announcer(_PLAN_DECODE,
                                                 adapter_ids))
            except Exception as e:  # pylint: disable=broad-except
                if self._mesh is not None:
                    raise  # fatal under a mesh: see _loop
                logger.warning('decode step failed: %s: %s',
                               type(e).__name__, e)
                for slot in range(self.max_slots):
                    if active_mask[slot] and self._slots[slot] is not None:
                        self._fail_slot(slot, e)
                continue
            self.cache = cache
            self._last_logits = logits
            self._decode_steps_total += 1
            # The step advanced every active slot by one position.
            self._host_len[active_mask] += 1
            # Queue the next prefill chunk behind the step before
            # reading the tokens back, so the device stays busy.
            overlap_t0 = time.perf_counter()
            self._admit()
            self._prefill_tick()
            overlap_cost = time.perf_counter() - overlap_t0
            host_tokens = tokens.tolist()
            self._decode_seconds_total += (time.perf_counter() -
                                           step_t0 - overlap_cost)
            for slot in range(self.max_slots):
                request = self._slots[slot]
                if request is None or not active_mask[slot]:
                    continue
                token = int(host_tokens[slot])
                self._tokens_total += 1
                request.generated.append(token)
                finished = (
                    (request.eos_id is not None and
                     token == request.eos_id) or
                    len(request.generated) >= request.max_new_tokens or
                    self._host_len[slot] >= self.max_len)
                if finished:
                    self._finish(request)
                    self._release_slot(slot)  # blocks back to the pool

    # -- public API -----------------------------------------------------

    def _submit(self, token_ids: List[int], max_new_tokens: int,
                temperature: float, eos_id: Optional[int],
                seed: int, trace_ctx=None, adapter: Optional[str] = None,
                migration=None,
                handoff_start: Optional[float] = None) -> _Request:
        """Shared admission path: validate + enqueue. ``trace_ctx`` (a
        ``tracing.SpanContext``, e.g. parsed from the serving request's
        ``traceparent``) opens a per-request ``infer.request`` span
        whose children are the queue-wait, prefill-chunk, decode and
        preempt spans; only the driver of a mesh records them (it alone
        runs the scheduler)."""
        if self._mesh is not None:
            self._mesh.require_driver('submitting a request')
            if self._fatal is not None:
                raise RuntimeError('the engine stopped after a failed '
                                   'tensor-parallel step') from self._fatal
        if len(token_ids) >= self.max_len:
            raise ValueError(
                f'prompt is {len(token_ids)} tokens; engine max_len is '
                f'{self.max_len} (prompt + generation must fit)')
        if self.role == 'prefill' and max_new_tokens > 0:
            raise RuntimeError(
                'a prefill-role engine never decodes; use '
                'prefill_and_export (or clear SKYT_DISAGG_ROLE)')
        if adapter:
            # Reject unknown adapters eagerly (a clean error, not an
            # asynchronous prefill failure) and count demand.
            with self._adapter_lock:
                if adapter not in self._adapters:
                    raise ValueError(
                        f'adapter {adapter!r} is not registered '
                        f'(register_adapter first)')
                demand = self._adapter_demand.setdefault(
                    adapter, {'requests': 0, 'last_request': 0.0,
                              'last_evicted': 0.0})
                demand['requests'] += 1
                demand['last_request'] = time.time()
        request = _Request(list(token_ids), max_new_tokens, temperature,
                           eos_id, seed, adapter=adapter or None)
        request.policy_version = self.policy_version
        request.request_id = f'r{next(self._request_ids)}'
        request.migration = migration
        request.handoff_start = handoff_start
        if trace_ctx is not None:
            request.span = tracing.start_span(
                'infer.request', parent=trace_ctx, service='inference',
                prompt_tokens=len(token_ids),
                max_new_tokens=max_new_tokens)
        self._requests_total += 1
        self._pending.put(request)
        self._wake.set()
        return request

    # -- disaggregated-serving public surface ---------------------------

    def prefill_and_export(self, token_ids: List[int], *,
                           temperature: float = 0.0,
                           eos_id: Optional[int] = None,
                           seed: int = 0,
                           timeout: float = 300.0,
                           trace_ctx=None) -> str:
        """Prefill-role entry: absorb the prompt (chunked, prefix-cache
        accelerated) and park the serialized KV in ``self.exporter``.
        Returns the request id the export is keyed by: the decode side
        pulls ``/kv/manifest/<id>`` etc. from this replica."""
        if self.role != 'prefill':
            raise RuntimeError(
                "prefill_and_export needs role='prefill' "
                '(SKYT_DISAGG_ROLE)')
        request = self._submit(token_ids, 0, temperature, eos_id, seed,
                               trace_ctx=trace_ctx)
        if not request.done.wait(timeout):
            raise TimeoutError('prefill timed out')
        if request.error is not None:
            raise request.error
        return request.request_id

    def probe_resident(self, token_ids: List[int],
                       adapter: Optional[str] = None) -> List[int]:
        """Chain digests of the full-block prefix already resident in
        this engine's prefix cache: read-only, the decode side's input
        to the migration's delta manifest (those blocks are not pulled).
        Adapter chains live under their own root, so probe with the
        adapter the request decodes with."""
        if self._prefix is None:
            return []
        return self._prefix.resident_chain(
            token_ids, root=adapter_chain_root(adapter))

    def submit_migrated(self, token_ids: List[int], pulled, *,
                        max_new_tokens: int = 32,
                        temperature: float = 0.0,
                        eos_id: Optional[int] = None,
                        seed: int = 0,
                        handoff_start: Optional[float] = None,
                        trace_ctx=None) -> _Request:
        """Decode-role entry: admit a pulled migration
        (``kv_migrate.PulledKv``). The serving loop imports the blocks
        refcount-exactly and decodes with no prefill pass; any import
        failure falls back to a local re-prefill of ``token_ids``, so the
        request always completes. Returns the request handle (stream
        with :meth:`tail_tokens` or wait on ``request.done``).
        ``handoff_start`` (``time.monotonic``) stamps
        ``skyt_disagg_handoff_seconds`` when the import lands."""
        if self.role == 'prefill':
            raise RuntimeError("a prefill-role engine never decodes; "
                               "submit_migrated needs role='decode' "
                               "(or colocated)")
        return self._submit(token_ids, max_new_tokens, temperature,
                            eos_id, seed, trace_ctx=trace_ctx,
                            migration=pulled, handoff_start=handoff_start)

    def tail_tokens(self, request: _Request, *,
                    eos_id: Optional[int] = None,
                    timeout: float = 300.0):
        """Yield a submitted request's tokens as they land."""
        emitted = 0
        deadline = time.monotonic() + timeout
        while True:
            finished = request.done.is_set()
            generated = request.generated
            while emitted < len(generated):
                token = generated[emitted]
                emitted += 1
                if eos_id is not None and token == eos_id:
                    return
                yield token
            if finished:
                if request.error is not None:
                    raise request.error
                return
            if time.monotonic() > deadline:
                raise TimeoutError('generation timed out')
            time.sleep(0.005)

    def submit_ids(self, token_ids: List[int], *,
                   max_new_tokens: int = 32,
                   temperature: float = 0.0,
                   eos_id: Optional[int] = None,
                   seed: int = 0,
                   adapter: Optional[str] = None,
                   trace_ctx=None) -> _Request:
        """Non-blocking admission (the RL rollout path submits a whole
        prompt group, then harvests): returns the request handle — wait
        on ``handle.done``, then read ``handle.generated`` /
        ``handle.error``; ``handle.policy_version`` is the weights'
        version it was submitted under."""
        return self._submit(token_ids, max_new_tokens, temperature,
                            eos_id, seed, trace_ctx=trace_ctx,
                            adapter=adapter)

    def generate_ids(self, token_ids: List[int], *,
                     max_new_tokens: int = 32,
                     temperature: float = 0.0,
                     eos_id: Optional[int] = None,
                     seed: int = 0,
                     timeout: float = 300.0,
                     adapter: Optional[str] = None,
                     trace_ctx=None) -> List[int]:
        request = self._submit(token_ids, max_new_tokens, temperature,
                               eos_id, seed, trace_ctx=trace_ctx,
                               adapter=adapter)
        if not request.done.wait(timeout):
            raise TimeoutError('generation timed out')
        if request.error is not None:
            raise request.error
        generated = request.generated
        if eos_id is not None and eos_id in generated:
            generated = generated[:generated.index(eos_id)]
        return generated

    def _require_tokenizer(self) -> None:
        if not self._tokenizer_fits:
            raise ValueError(
                f'Model vocab {self.cfg.vocab_size} < tokenizer '
                f'vocab {self.tokenizer.vocab_size}; text APIs are '
                f'unavailable (use the *_ids entry points)')

    def generate_text(self, prompt: str, **kwargs: Any) -> str:
        self._require_tokenizer()
        ids = self.tokenizer.encode(prompt)
        out = self.generate_ids(ids, eos_id=self.tokenizer.eos_id,
                                **kwargs)
        return self.tokenizer.decode(out)

    def stream_ids(self, token_ids: List[int], *,
                   max_new_tokens: int = 32,
                   temperature: float = 0.0,
                   eos_id: Optional[int] = None,
                   seed: int = 0,
                   timeout: float = 300.0,
                   adapter: Optional[str] = None,
                   trace_ctx=None):
        """Yield generated token ids AS THEY LAND in the slot loop.
        Validation and admission happen eagerly."""
        request = self._submit(token_ids, max_new_tokens, temperature,
                               eos_id, seed, trace_ctx=trace_ctx,
                               adapter=adapter)
        return self.tail_tokens(request, eos_id=eos_id, timeout=timeout)

    def stream_text(self, prompt: str, **kwargs: Any):
        """Yield text deltas: the ids are decoded cumulatively (one
        token may be a partial UTF-8 sequence; the running decode keeps
        the deltas well formed)."""
        self._require_tokenizer()
        ids = self.tokenizer.encode(prompt)
        out_ids: List[int] = []
        text_so_far = ''
        for token in self.stream_ids(ids, eos_id=self.tokenizer.eos_id,
                                     **kwargs):
            out_ids.append(token)
            text = self.tokenizer.decode(out_ids)
            delta, text_so_far = text[len(text_so_far):], text
            if delta:
                yield delta

    def generate_texts(self, prompts: List[str],
                       **kwargs: Any) -> List[str]:
        """Concurrent multi-prompt entry (the HTTP payload's batch API):
        each prompt is its own slot request, so they overlap."""
        import concurrent.futures
        workers = max(1, min(len(prompts), 2 * self.max_slots))
        with concurrent.futures.ThreadPoolExecutor(
                max_workers=workers) as pool:
            futures = [pool.submit(self.generate_text, p, **kwargs)
                       for p in prompts]
            return [f.result() for f in futures]

    def stats(self) -> Dict[str, float]:
        """The reference's stats schema, plus ``decode_steps`` (plain
        decode steps; each launches the paged kernel once a layer);
        under a mesh also the mesh, its backend, each rank's device and
        the ``role``."""
        total = self._pool.total_blocks
        free = self._pool.free_blocks
        apool = self._adapter_pool
        mesh = ({**self._mesh.info, 'role': self.role}
                if self._mesh is not None else {})
        return {
            **mesh,
            'slots': self.max_slots,
            'active': sum(r is not None for r in self._slots),
            'pending': self._pending.qsize() + len(self._waiting),
            # Monotonic counters (Prometheus counters on /metrics).
            'requests': self._requests_total,
            'completions': self._completions_total,
            'request_errors': self._errors_total,
            'prefill_errors': self._prefill_errors_total,
            'prefill_chunks': self._prefill_chunks_total,
            'decode_steps': self._decode_steps_total,
            'tokens_generated': self._tokens_total,
            'decode_seconds': round(self._decode_seconds_total, 4),
            'queue_wait_seconds': round(self._queue_wait_seconds_total,
                                        4),
            'prefix_cache_hits': self._prefix_hits_total,
            'prefix_cache_misses': self._prefix_misses_total,
            'prefix_tokens_reused': self._prefix_tokens_reused_total,
            'preemptions': self._preemptions_total,
            # Disaggregated serving (kv_exports_pending is a gauge).
            'kv_exports': self._kv_exports_total,
            'kv_imports': self._kv_imports_total,
            'kv_import_fallbacks': self._kv_import_fallbacks_total,
            'kv_exports_pending': (len(self.exporter)
                                   if self.exporter is not None else 0),
            # Speculative decoding: the acceptance rate is
            # accepted_tokens / draft_tokens.
            'draft_tokens': self._draft_tokens_total,
            'accepted_tokens': self._accepted_tokens_total,
            'verify_steps': self._verify_steps_total,
            'spec_window': self._spec_window,
            # Live weight refresh (policy_version is a gauge).
            'policy_version': self.policy_version,
            'weight_refreshes': self._weight_refreshes_total,
            'refresh_shards': self._refresh_shards_total,
            'refresh_seconds': round(self._refresh_seconds_total, 4),
            # Multi-LoRA (0 on engines with no adapter pages).
            'lora_hits': apool.hits if apool is not None else 0,
            'lora_misses': apool.misses if apool is not None else 0,
            'lora_evictions': apool.evictions if apool is not None else 0,
            'lora_pages_total': apool.n_pages if apool is not None else 0,
            'lora_pages_resident': (apool.resident_pages
                                    if apool is not None else 0),
            'lora_blocks_charged': (apool.blocks_charged
                                    if apool is not None else 0),
            'lora_adapters_registered': len(self._adapters),
            # Point-in-time gauges: paged-pool pressure.
            'block_size': self.block_size,
            'blocks_total': total,
            'blocks_free': free,
            'blocks_cached': (self._prefix.cached_blocks
                              if self._prefix is not None else 0),
            'block_occupancy': round((total - free) / total, 4)
            if total else 0.0,
        }

    def shutdown(self) -> None:
        """Stop the serving loop; under a mesh the driver then releases
        the followers' ``follow`` loops."""
        self._stop.set()
        self._wake.set()
        if self._thread.is_alive():
            self._thread.join(timeout=10)
        if self._mesh is not None and self._mesh.driver:
            self._mesh.channel.close()
