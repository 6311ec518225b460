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

One decode step runs every slot together (``paged_decode_step``, whose
attention is the Hopper paged-attention kernel on the card); a
scheduler thread admits requests into free slots as others finish,
preempts the newest request when the pool runs dry, and resumes it by
re-prefilling. The public surface (``generate_ids``/``stream_ids``/...)
is the reference's.

Not ported yet (constructor arguments that raise when set): multi-LoRA
pages, speculative decoding, disaggregated roles, tensor-parallel
meshes, checkpoint and HF loading; likewise live weight
refresh and tracing spans.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import queue
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from skypilot_tpu_torch.inference.paged import BlockPool, PrefixCache
from skypilot_tpu_torch.inference.tokenizer import get_tokenizer
from skypilot_tpu_torch.models import decode as decode_lib
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.models.config import (ModelConfig, get_model_config,
                                              with_int8_kv_cache)
from skypilot_tpu_torch.models.quant import maybe_quantize
from skypilot_tpu_torch.utils.device import resolve_device, to_device

DEFAULT_BLOCK_SIZE = 16
DEFAULT_PREFILL_CHUNK = 64

_MASK64 = (1 << 64) - 1


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
                     positions, *, cfg):
    """One step for every slot: sample from the last logits, advance."""
    tokens = _sample_tokens(last_logits, seeds, positions, temps)
    logits, cache = decode_lib.paged_decode_step(params, tokens, cache,
                                                 cfg, active=active)
    return tokens, logits, cache


def _prefill_chunk_step(params, tokens, start, n_new, slot, cache, *, cfg):
    return decode_lib.prefill_chunk(params, tokens, start, n_new, slot,
                                    cache, cfg)


class _Request:
    def __init__(self, token_ids: List[int], max_new_tokens: int,
                 temperature: float, eos_id: Optional[int],
                 seed: int) -> None:
        self.token_ids = token_ids
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.eos_id = eos_id
        self.seed = seed
        self.arrival = time.monotonic()
        self.admitted = False  # queue-wait counted once, not per resume
        self.generated: List[int] = []
        self.done = threading.Event()
        self.error: Optional[BaseException] = None


class _DrrQueue:
    """The admission queue. The reference serves one deficit-round-robin
    lane per LoRA adapter; with base traffic only (the port has no
    adapters yet) that is a single lane, i.e. exact FIFO with
    head-of-lane requeue for preempted and HBM-blocked requests."""

    def __init__(self) -> None:
        self._lane: 'collections.deque[_Request]' = collections.deque()

    def __len__(self) -> int:
        return len(self._lane)

    def push(self, request: _Request) -> None:
        self._lane.append(request)

    def push_front(self, request: _Request) -> None:
        self._lane.appendleft(request)

    def pop(self) -> Optional[_Request]:
        return self._lane.popleft() if self._lane else None


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

    ``params``: a port params dict (``models/convert.py`` carries JAX
    params over); default: ``llama.init_params`` from ``seed`` on the
    device. ``device``: default ``cuda`` (raises without a GPU); pass
    ``'cpu'`` to run on the CPU.
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
                 role: Optional[str] = None,
                 lora_pages: Optional[int] = None) -> None:
        unported = {'checkpoint_dir': checkpoint_dir,
                    'hf_checkpoint': hf_checkpoint, 'mesh': mesh,
                    'spec_decode': spec_decode, 'role': role,
                    'lora_pages': lora_pages}
        for name, value in unported.items():
            if value:
                raise NotImplementedError(
                    f'{name}= is not ported yet (ROADMAP.md, queue A)')
        self.device = resolve_device(device)
        self.cfg = cfg or get_model_config(model)
        if quantize_kv:
            self.cfg = with_int8_kv_cache(self.cfg)
        self.tokenizer = get_tokenizer()
        # A model whose vocab can't cover the tokenizer still serves the
        # id-level APIs; only the TEXT entry points are refused.
        self._tokenizer_fits = (self.tokenizer.vocab_size <=
                                self.cfg.vocab_size)
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
        if params is None:
            params = llama.init_params(seed, self.cfg, device=self.device,
                                       weight_dtype=self.cfg.compute_dtype)
        params = to_device(params, self.device)
        self.params = decode_lib.serving_params(
            maybe_quantize(params, quantize), self.cfg)
        self.cache = decode_lib.init_paged_cache(
            self.cfg, self.num_blocks, self.block_size, max_slots,
            self.blocks_per_slot, device=self.device)
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
        self._waiting = _DrrQueue()
        # Pool version at the last admission attempt that failed on
        # memory pressure: until it changes, retrying is pure waste.
        self._blocked_at_version: Optional[int] = None
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
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread = threading.Thread(target=self._loop,
                                        name='continuous-batching',
                                        daemon=True)
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
        Only reclaimable entries are evicted."""
        block = self._pool.alloc()
        while block is None and self._prefix is not None:
            if not self._prefix.evict_reclaimable():
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
        request.done.set()

    def _fail_slot(self, slot: int, error: BaseException,
                   prefill: bool = False) -> None:
        request = self._slots[slot]
        self._release_slot(slot)
        if prefill:
            self._prefill_errors_total += 1
        if request is not None:
            self._finish(request, error)

    # -- admission + chunked prefill ------------------------------------

    def _admit(self) -> None:
        """Bookkeeping-only admission: assign a free slot, reference
        cached prefix blocks, allocate private blocks for the prompt.
        The compute (chunked prefill) happens in ``_prefill_tick``."""
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
            request = self._waiting.pop()
            try:
                if not self._begin_prefill(request, slot):
                    self._waiting.push_front(request)
                    self._blocked_at_version = self._pool.version
                    return
            except Exception as e:  # pylint: disable=broad-except
                self._prefill_errors_total += 1
                self._finish(request, e)
                continue
            self._blocked_at_version = None

    def _begin_prefill(self, request: _Request, slot: int) -> bool:
        """Returns False when the pool can't fit the prompt right now
        (request stays queued); raises when it never can."""
        ids = request.token_ids + request.generated
        plen = len(ids)
        needed_total = math.ceil(plen / self.block_size)
        if needed_total > self._pool.total_blocks:
            raise RuntimeError(
                f'prompt needs {needed_total} KV blocks; pool has '
                f'{self._pool.total_blocks} (raise num_blocks)')
        shared: List[int] = []
        if self._prefix is not None:
            # Leave >= 1 prompt token to compute: the last token's
            # logits seed sampling and are never cached.
            shared = self._prefix.lookup(ids, limit_tokens=plen - 1)
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
        start = len(shared) * self.block_size
        if self._prefix is not None:
            if shared:
                self._prefix_hits_total += 1
                self._prefix_tokens_reused_total += start
            else:
                self._prefix_misses_total += 1
        if not request.admitted:
            request.admitted = True
            self._queue_wait_seconds_total += max(
                0.0, time.monotonic() - request.arrival)
        self._slot_blocks[slot] = blocks
        self._host_bt[slot, :] = 0
        self._host_bt[slot, :len(blocks)] = blocks
        self._host_len[slot] = start
        self._bt_dirty = True
        self._slots[slot] = request
        self._decoding[slot] = False
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
        try:
            last, cache = _prefill_chunk_step(
                self.params, torch.as_tensor(tokens, device=self.device),
                state.pos, len(chunk), slot, self.cache, cfg=self.cfg)
        except Exception as e:  # pylint: disable=broad-except
            self._prefilling.pop(0)
            self._fail_slot(slot, e, prefill=True)
            return
        self.cache = cache
        state.pos += len(chunk)
        self._host_len[slot] = state.pos
        self._prefill_chunks_total += 1
        if state.pos >= len(ids):
            self._prefilling.pop(0)
            self._last_logits[slot] = last[0].float()
            self._seeds[slot] = request.seed
            self._decoding[slot] = True
            if self._prefix is not None:
                self._prefix.insert(ids, self._slot_blocks[slot])

    def _preempt(self, slot: int, active_mask: np.ndarray) -> None:
        """Release a slot's blocks (decoding OR mid-prefill) and requeue
        its request at the FRONT of the admission queue; it resumes by
        re-prefilling prompt + generated-so-far."""
        request = self._slots[slot]
        self._prefilling = [s for s in self._prefilling
                            if s.slot != slot]
        self._release_slot(slot)
        active_mask[slot] = False
        self._preemptions_total += 1
        if request is not None:
            self._waiting.push_front(request)
            self._wake.set()

    def _ensure_decode_blocks(self, active_mask: np.ndarray) -> None:
        """A slot about to write position ``length`` needs its tail block
        BEFORE the step. When the pool is exhausted even after prefix
        eviction, the most recently admitted request is preempted (the
        oldest request always progresses, so the system drains)."""
        for slot in range(self.max_slots):
            if not active_mask[slot]:
                continue
            index = int(self._host_len[slot]) // self.block_size
            if index >= self.blocks_per_slot:
                continue  # finish check retires it this step
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
                    break
                victim = max(victims, key=lambda s: self._admit_order[s])
                self._preempt(victim, active_mask)

    # -- serving loop ---------------------------------------------------

    def _loop(self) -> None:
        with torch.no_grad():
            self._loop_body()

    def _loop_body(self) -> None:
        while not self._stop.is_set():
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
            self._ensure_decode_blocks(active_mask)
            if not active_mask.any():
                continue
            self._sync_tables()
            temps = [r.temperature if r else 0.0 for r in self._slots]
            positions = [int(n) for n in self._host_len]
            step_t0 = time.perf_counter()
            try:
                tokens, logits, cache = _decode_all_step(
                    self.params, self._last_logits, self.cache,
                    torch.as_tensor(active_mask, device=self.device),
                    temps, self._seeds, positions, cfg=self.cfg)
            except Exception as e:  # pylint: disable=broad-except
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
                seed: int) -> _Request:
        """Shared admission path: validate + enqueue."""
        if len(token_ids) >= self.max_len:
            raise ValueError(
                f'prompt is {len(token_ids)} tokens; engine max_len is '
                f'{self.max_len} (prompt + generation must fit)')
        request = _Request(list(token_ids), max_new_tokens, temperature,
                           eos_id, seed)
        self._requests_total += 1
        self._pending.put(request)
        self._wake.set()
        return request

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
                   seed: int = 0) -> _Request:
        """Non-blocking admission: returns the request handle — wait on
        ``handle.done``, then read ``handle.generated``/``handle.error``."""
        return self._submit(token_ids, max_new_tokens, temperature,
                            eos_id, seed)

    def generate_ids(self, token_ids: List[int], *,
                     max_new_tokens: int = 32,
                     temperature: float = 0.0,
                     eos_id: Optional[int] = None,
                     seed: int = 0,
                     timeout: float = 300.0) -> List[int]:
        request = self._submit(token_ids, max_new_tokens, temperature,
                               eos_id, seed)
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
                   timeout: float = 300.0):
        """Yield generated token ids AS THEY LAND in the slot loop.
        Validation and admission happen eagerly."""
        request = self._submit(token_ids, max_new_tokens, temperature,
                               eos_id, seed)
        return self.tail_tokens(request, eos_id=eos_id, timeout=timeout)

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
        total = self._pool.total_blocks
        free = self._pool.free_blocks
        return {
            'slots': self.max_slots,
            'active': sum(r is not None for r in self._slots),
            'pending': self._pending.qsize() + len(self._waiting),
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
            'block_size': self.block_size,
            'blocks_total': total,
            'blocks_free': free,
            'blocks_cached': (self._prefix.cached_blocks
                              if self._prefix is not None else 0),
            'block_occupancy': round((total - free) / total, 4)
            if total else 0.0,
        }

    def shutdown(self) -> None:
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout=10)
