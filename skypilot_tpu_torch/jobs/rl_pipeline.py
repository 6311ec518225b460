"""Live-sync GRPO rollout pipeline: delta weight refresh without
stopping generation. The port of ``skypilot_tpu/jobs/rl_pipeline.py``.

One elastic unit, two roles:

* a **learner** consuming rollout batches (``train/grpo.py``'s
  :class:`GrpoLearner`) and committing each new policy as a *delta
  manifest* (only the shards whose bytes changed) to a
  :class:`PolicyStore`;
* a **rollout fleet** serving generation through the continuous
  batching engine and live-refreshing weights in place: each replica
  pulls just the changed shards over the fan-out path
  (``data/fanout.py``), swaps them at a serving-loop step boundary and
  resumes, staggered by ``SKYT_RL_REFRESH_CONCURRENCY`` so generation
  never stops fleet-wide.

Off-policy staleness (learner version at consume minus the policy
version that generated the batch) is stamped on every batch and bounded
by the ``max_staleness`` backpressure valve: a producer whose batch
would exceed the bound if it landed now waits (with a timeout that loops
it back through the refresh step: consuming a batch bumps the learner
version and shrinks the queue by one, so only a weight refresh can
reopen the valve).

Batch hand-off is the :class:`RolloutQueue` protocol (``put`` / ``pop``
/ ``ack`` / ``requeue``): a popped batch stays in flight until the
learner acks it, and a learner fault requeues it at the front, so no
batch is lost. :class:`FileBatchQueue` is the same protocol over a
shared directory for the distributed roles (``main --role
learner|rollout``).

The store's bytes are the reference's: ``publish`` writes ``np.save`` of
each fp32 learner leaf under its ``flatten_param_paths`` path and
commits ``MANIFEST.skyt.json`` last (``data/ckpt_manifest.py``), so a
JAX learner can feed port engines and a port learner JAX engines.

Chaos sites (``utils/fault_injection.py``)::

    rl.rollout.generate    a rollout wave, before submission
    rl.refresh.pull        a replica's delta pull, before fetching
    rl.learn.step          the learner step, before state mutation

Left out: ``expand_pipeline`` and ``launch_pipeline``, which turn a
``pipeline:`` task into a gang of orchestrator tasks. They build the
reference's ``spec.Task`` and submit to its jobs controller, which the
port does not duplicate; a gang they launch may run this module's
``main`` as its command.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import hashlib
import io
import json
import logging
import os
import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np

import torch

from skypilot_tpu_torch.data import ckpt_manifest
from skypilot_tpu_torch.data.fanout import DirectorySource, FanoutPuller
from skypilot_tpu_torch.inference.continuous import flatten_param_paths
from skypilot_tpu_torch.models.convert import tensor_to_numpy
from skypilot_tpu_torch.server import metrics
from skypilot_tpu_torch.utils import env, fault_injection

logger = logging.getLogger(__name__)

# Chaos sites: the three host-side edges of the pipeline. Generation
# faults exercise replica loss mid-wave; pull faults exercise a
# replica dying mid-refresh (the store manifest commit protocol makes
# a torn pull re-pullable); learn faults exercise the ack/requeue
# no-lost-batches invariant.
ROLLOUT_GENERATE_SITE = 'rl.rollout.generate'
REFRESH_PULL_SITE = 'rl.refresh.pull'
LEARN_STEP_SITE = 'rl.learn.step'

_BATCH_DIR = 'batches'
_WEIGHTS_DIR = 'weights'
_CLAIM_SUFFIX = '.claim'


# --------------------------------------------------------------------
# Policy store: delta-manifest weight publication
# --------------------------------------------------------------------


class PolicyStore:
    """Committed policy weights under one directory, one ``.npy`` file
    per parameter shard (named by its ``flatten_param_paths`` path —
    the same naming contract the engine's ``request_refresh(updates=)``
    resolves), with a content-addressed ``MANIFEST.skyt.json``
    committed last (``data/ckpt_manifest``: tmp + fsync + rename, so a
    reader never sees a version whose shards aren't all on disk).

    ``publish`` skips shards whose bytes are unchanged: the manifest
    diff is the delta a replica transfers. Leaves may be numpy arrays
    or tensors (``tensor.detach().cpu().numpy()``: the fp32 learner's
    bytes are the reference's for the same values)."""

    def __init__(self, root: str) -> None:
        self.root = os.path.join(root, _WEIGHTS_DIR)
        os.makedirs(self.root, exist_ok=True)

    # -- learner side -------------------------------------------------

    def publish(self, params: Any, version: int) -> Dict[str, Any]:
        """Write changed shards + commit the manifest at ``version``.
        Returns ``{'version', 'shards_total', 'shards_written',
        'bytes_written'}``."""
        prev = ckpt_manifest.read(self.root)
        prev_map = ckpt_manifest.shard_map(prev) if prev else {}
        flat = flatten_param_paths(params)
        written = 0
        nbytes = 0
        for path, leaf in flat.items():
            rel = path + '.npy'
            buf = io.BytesIO()
            np.save(buf, _host_array(leaf), allow_pickle=False)
            blob = buf.getvalue()
            before = prev_map.get(rel)
            if before is not None and before['size'] == len(blob):
                if hashlib.sha256(blob).hexdigest() == before['sha256']:
                    continue  # unchanged shard: not part of the delta
            full = os.path.join(self.root, *rel.split('/'))
            os.makedirs(os.path.dirname(full), exist_ok=True)
            tmp = full + ckpt_manifest.TMP_INFIX
            with open(tmp, 'wb') as f:
                f.write(blob)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, full)
            written += 1
            nbytes += len(blob)
        payload = ckpt_manifest.build(self.root, step=int(version))
        ckpt_manifest.write(self.root, payload)
        return {'version': int(version),
                'shards_total': len(flat),
                'shards_written': written,
                'bytes_written': nbytes}

    # -- rollout side -------------------------------------------------

    def version(self) -> Optional[int]:
        payload = ckpt_manifest.read(self.root)
        if payload is None:
            return None
        return int(payload.get('step', 0))

    def pull(self, dest: str,
             sources: Iterable[Any] = ()) -> Optional[Dict[str, Any]]:
        """Pull the committed delta into ``dest`` (a per-replica local
        copy) through the fan-out path — peer ``sources`` first, the
        store directory as the origin bucket — and load the changed
        shards.  Returns ``{'version', 'updates', 'shards_pulled',
        'bytes_pulled'}`` or None if nothing is committed yet."""
        manifest = ckpt_manifest.read(self.root)
        if manifest is None:
            return None
        os.makedirs(dest, exist_ok=True)
        before = ckpt_manifest.read(dest)
        changed = ckpt_manifest.diff(before, manifest)
        puller = FanoutPuller(manifest, dest, sources,
                              DirectorySource(self.root))
        puller.pull()
        updates: Dict[str, np.ndarray] = {}
        nbytes = 0
        for shard in changed:
            full = os.path.join(dest, *shard['path'].split('/'))
            updates[shard['path'][:-len('.npy')]] = np.load(full)
            nbytes += int(shard['size'])
        return {'version': int(manifest.get('step', 0)),
                'updates': updates,
                'shards_pulled': len(changed),
                'bytes_pulled': nbytes}


# --------------------------------------------------------------------
# Rollout batches and the hand-off queue
# --------------------------------------------------------------------


@dataclasses.dataclass
class RolloutBatch:
    """One wave of rollouts from one replica: ``prompts`` [B, L] and
    ``generated`` [B, N] int32, ``rewards`` [B] float32 (B = prompts
    x group_size, tiled).  ``policy_version`` is the *minimum* engine
    policy version that served the wave — a refresh landing mid-wave
    makes the wave as stale as its oldest token."""
    prompts: np.ndarray
    generated: np.ndarray
    rewards: np.ndarray
    group_size: int
    policy_version: int
    rank: int = 0
    seq: int = 0


class RolloutQueue:
    """Bounded in-memory FIFO with explicit consumption accounting:
    ``pop`` moves a batch to the in-flight set, ``ack`` retires it,
    ``requeue`` puts it back at the FRONT (a learner fault must not
    reorder it behind fresher batches — that would silently raise its
    staleness).  ``depth`` counts queued + in-flight: both are batches
    the learner has yet to *retire*, which is what the staleness
    projection needs."""

    def __init__(self, capacity: int) -> None:
        self.capacity = capacity
        self._items: collections.deque = collections.deque()
        self._inflight: Dict[int, RolloutBatch] = {}
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)
        self._next_key = 0
        self.produced = 0
        self.acked = 0
        self.requeued = 0

    def put(self, batch: RolloutBatch,
            timeout: Optional[float] = None) -> bool:
        with self._lock:
            if len(self._items) >= self.capacity:
                if not self._not_full.wait_for(
                        lambda: len(self._items) < self.capacity,
                        timeout):
                    return False
            self._items.append(batch)
            self.produced += 1
            self._not_empty.notify()
        return True

    def pop(self, timeout: Optional[float] = None
            ) -> Optional[RolloutBatch]:
        with self._lock:
            if not self._items:
                if not self._not_empty.wait_for(
                        lambda: bool(self._items), timeout):
                    return None
            batch = self._items.popleft()
            self._next_key += 1
            batch._queue_key = self._next_key  # type: ignore[attr-defined]
            self._inflight[self._next_key] = batch
            self._not_full.notify()
        return batch

    def ack(self, batch: RolloutBatch) -> None:
        with self._lock:
            self._inflight.pop(getattr(batch, '_queue_key', None), None)
            self.acked += 1

    def requeue(self, batch: RolloutBatch) -> None:
        with self._lock:
            self._inflight.pop(getattr(batch, '_queue_key', None), None)
            self._items.appendleft(batch)
            self.requeued += 1
            self._not_empty.notify()

    def depth(self) -> int:
        with self._lock:
            return len(self._items) + len(self._inflight)

    def unretired(self) -> int:
        """Batches produced but never acked — the no-lost-batches
        invariant is ``produced == acked + depth()`` at quiesce."""
        with self._lock:
            return self.produced - self.acked


class FileBatchQueue:
    """The :class:`RolloutQueue` protocol over a shared directory —
    the hand-off path when learner and rollout replicas are separate
    jobs of a ``pipeline:`` gang.  A batch is one ``.npz`` committed
    tmp -> rename; ``pop`` claims by renaming to ``*.claim`` (atomic:
    two learners can't both win); ``ack`` deletes the claim;
    ``requeue`` renames it back.  A learner that dies holding a claim
    leaves the ``.claim`` file on disk — its replacement reclaims it
    first (oldest claims sort before fresh batches), so the batch is
    delayed, not lost."""

    def __init__(self, root: str, capacity: int) -> None:
        self.root = os.path.join(root, _BATCH_DIR)
        self.capacity = capacity
        os.makedirs(self.root, exist_ok=True)

    def _entries(self, suffix: str) -> List[str]:
        try:
            names = os.listdir(self.root)
        except OSError:
            return []
        out = [n for n in names if n.endswith(suffix)]
        out.sort()
        return out

    def put(self, batch: RolloutBatch,
            timeout: Optional[float] = None) -> bool:
        deadline = None if timeout is None else time.monotonic() + timeout
        while len(self._entries('.npz')) >= self.capacity:
            if deadline is not None and time.monotonic() >= deadline:
                return False
            time.sleep(0.05)
        name = (f'{batch.policy_version:08d}-{batch.rank:04d}-'
                f'{batch.seq:08d}.npz')
        tmp = os.path.join(self.root,
                           name + ckpt_manifest.TMP_INFIX)
        with open(tmp, 'wb') as f:
            np.savez(f, prompts=batch.prompts, generated=batch.generated,
                     rewards=batch.rewards,
                     meta=np.asarray([batch.group_size,
                                      batch.policy_version,
                                      batch.rank, batch.seq], np.int64))
        os.replace(tmp, os.path.join(self.root, name))
        return True

    def pop(self, timeout: Optional[float] = None
            ) -> Optional[RolloutBatch]:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            # Orphaned claims first (a predecessor died mid-step).
            for name in self._entries(_CLAIM_SUFFIX) + \
                    self._entries('.npz'):
                full = os.path.join(self.root, name)
                if name.endswith(_CLAIM_SUFFIX):
                    claim = full
                else:
                    claim = full + _CLAIM_SUFFIX
                    try:
                        os.rename(full, claim)
                    except OSError:
                        continue  # raced another consumer
                try:
                    with np.load(claim) as z:
                        meta = z['meta']
                        batch = RolloutBatch(
                            prompts=z['prompts'],
                            generated=z['generated'],
                            rewards=z['rewards'],
                            group_size=int(meta[0]),
                            policy_version=int(meta[1]),
                            rank=int(meta[2]), seq=int(meta[3]))
                except (OSError, KeyError, ValueError):
                    continue  # torn claim from a dead writer
                batch._claim_path = claim  # type: ignore[attr-defined]
                return batch
            if deadline is not None and time.monotonic() >= deadline:
                return None
            time.sleep(0.05)

    def ack(self, batch: RolloutBatch) -> None:
        claim = getattr(batch, '_claim_path', None)
        if claim:
            try:
                os.remove(claim)
            except OSError:
                pass

    def requeue(self, batch: RolloutBatch) -> None:
        claim = getattr(batch, '_claim_path', None)
        if claim:
            try:
                os.rename(claim, claim[:-len(_CLAIM_SUFFIX)])
            except OSError:
                pass

    def depth(self) -> int:
        return len(self._entries('.npz')) + \
            len(self._entries(_CLAIM_SUFFIX))


# --------------------------------------------------------------------
# Pipeline configuration (env knobs + the task-spec pipeline: block)
# --------------------------------------------------------------------


@dataclasses.dataclass
class PipelineConfig:
    rollout_replicas: int = 1
    max_staleness: int = 4
    queue_batches: int = 2
    refresh_mode: str = 'step'
    refresh_concurrency: int = 1
    store: Optional[str] = None

    @classmethod
    def from_env(cls) -> 'PipelineConfig':
        return cls(
            rollout_replicas=max(
                1, env.get_int('SKYT_RL_FLEET')),
            max_staleness=env.get_int('SKYT_RL_MAX_STALENESS'),
            queue_batches=max(
                1, env.get_int('SKYT_RL_QUEUE_BATCHES')),
            refresh_mode=env.get_str('SKYT_RL_REFRESH_MODE')
            or 'step',
            refresh_concurrency=max(1, env.get_int(
                'SKYT_RL_REFRESH_CONCURRENCY')),
            store=env.get_str('SKYT_RL_STORE'),
        )

    @classmethod
    def from_pipeline_block(cls, block: Dict[str, Any]
                            ) -> 'PipelineConfig':
        return cls(
            rollout_replicas=int(block['rollout_replicas']),
            max_staleness=int(block.get('max_staleness', 4)),
            queue_batches=int(block.get('queue_batches', 2)),
            refresh_mode=str(block.get('refresh_mode', 'step')),
            refresh_concurrency=int(block.get('refresh_concurrency', 1)),
            store=block.get('store'),
        )


# --------------------------------------------------------------------
# Rollout worker: generate -> valve -> refresh, forever
# --------------------------------------------------------------------


class RolloutWorker:
    """One rollout replica: owns a continuous-batching engine serving
    one wave at a time.  Loop order is refresh -> valve -> generate:
    the valve can only reopen via a refresh, so a valve-blocked worker
    times out back into the refresh step rather than deadlocking."""

    def __init__(self, rank: int, engine: Any, queue: Any,
                 store: PolicyStore, pcfg: PipelineConfig, *,
                 make_wave: Callable[[int, int], Any],
                 reward_fn: Callable[..., np.ndarray],
                 learner_version: Callable[[], int],
                 refresh_slots: threading.Semaphore,
                 producing: 'collections.Counter',
                 pull_dest: str,
                 max_new_tokens: int = 8,
                 temperature: float = 1.0,
                 valve_timeout: float = 0.2) -> None:
        self.rank = rank
        self.engine = engine
        self.queue = queue
        self.store = store
        self.pcfg = pcfg
        self.make_wave = make_wave
        self.reward_fn = reward_fn
        self.learner_version = learner_version
        self.refresh_slots = refresh_slots
        self.producing = producing
        self.pull_dest = pull_dest
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.valve_timeout = valve_timeout
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.seq = 0
        self.waves = 0
        self.tokens = 0
        self.refreshes = 0
        self.valve_waits = 0
        self.errors: List[Exception] = []
        # Transient pull/swap failures (e.g. the learner committed a
        # newer version mid-pull, failing the digest check) — retried
        # on the next loop, tracked apart from wave errors.
        self.refresh_errors: List[Exception] = []
        self.refresh_latencies: List[float] = []
        # version -> publish wall-clock, filled by the pipeline so a
        # replica can report commit->applied sync latency.
        self.publish_wall: Dict[int, float] = {}

    # -- refresh ------------------------------------------------------

    def maybe_refresh(self) -> bool:
        """Pull + apply the latest committed policy if it's newer than
        the engine's.  Staggered: at most ``refresh_concurrency``
        replicas are inside a pull/swap at once, so the rest of the
        fleet keeps generating."""
        committed = self.store.version()
        if committed is None or committed <= self.engine.policy_version:
            return False
        if not self.refresh_slots.acquire(timeout=self.valve_timeout):
            return False
        t0 = time.monotonic()
        try:
            fault_injection.inject(REFRESH_PULL_SITE)
            pulled = self.store.pull(self.pull_dest)
            if pulled is None or not pulled['updates']:
                return False
            self.engine.refresh_weights(pulled['updates'],
                                        version=pulled['version'],
                                        mode=self.pcfg.refresh_mode)
            self.refreshes += 1
            metrics.RL_WEIGHT_REFRESHES.inc(outcome='ok')
            wall = time.monotonic() - t0
            published = self.publish_wall.get(pulled['version'])
            if published is not None:
                wall = time.monotonic() - published
            self.refresh_latencies.append(wall)
            metrics.RL_WEIGHT_SYNC_SECONDS.observe(wall)
            return True
        except Exception as e:  # pylint: disable=broad-except
            metrics.RL_WEIGHT_REFRESHES.inc(outcome='error')
            self.refresh_errors.append(e)
            logger.warning('rollout[%d] refresh failed: %s',
                           self.rank, e)
            return False
        finally:
            self.refresh_slots.release()

    # -- valve --------------------------------------------------------

    def projected_staleness(self) -> int:
        """Staleness this replica's NEXT batch would see at consume
        time if produced now: the learner's lead over the engine, plus
        every unretired batch ahead of it (each consumption bumps the
        learner version by one), plus waves other replicas are
        mid-generating.  Consumption cancels itself out of this sum —
        only a refresh lowers it."""
        lag = max(0, self.learner_version() - self.engine.policy_version)
        others = sum(v for k, v in self.producing.items()
                     if k != self.rank)
        return lag + self.queue.depth() + others

    # -- generate -----------------------------------------------------

    def generate_wave(self) -> Optional[RolloutBatch]:
        from skypilot_tpu_torch.train.grpo import engine_rollouts
        fault_injection.inject(ROLLOUT_GENERATE_SITE)
        tiled, targets, group_size = self.make_wave(self.rank, self.seq)
        generated, version = engine_rollouts(
            self.engine, [list(map(int, row)) for row in tiled],
            max_new_tokens=self.max_new_tokens,
            temperature=self.temperature,
            step=(self.seq * 131 + self.rank))
        rewards = np.asarray(self.reward_fn(generated, targets),
                             np.float32)
        batch = RolloutBatch(
            prompts=np.asarray(tiled, np.int32),
            generated=np.asarray(generated, np.int32),
            rewards=rewards, group_size=group_size,
            policy_version=int(version), rank=self.rank, seq=self.seq)
        self.seq += 1
        self.waves += 1
        ntok = int(np.asarray(generated).size)
        self.tokens += ntok
        metrics.RL_ROLLOUT_TOKENS.inc(ntok, rank=str(self.rank))
        metrics.RL_ROLLOUT_BATCHES.inc(outcome='produced')
        return batch

    # -- loop ---------------------------------------------------------

    def run_once(self) -> bool:
        """One worker iteration; returns True if a batch was queued."""
        self.maybe_refresh()
        if self.projected_staleness() >= self.pcfg.max_staleness:
            self.valve_waits += 1
            metrics.RL_VALVE_WAITS.inc(rank=str(self.rank))
            # Timed wait, then loop back through maybe_refresh() —
            # NOT a wait-for-consumption: consuming can never reopen
            # the valve (see projected_staleness).
            self._stop.wait(self.valve_timeout)
            return False
        self.producing[self.rank] += 1
        try:
            batch = self.generate_wave()
        except Exception as e:  # pylint: disable=broad-except
            self.errors.append(e)
            logger.warning('rollout[%d] wave failed: %s', self.rank, e)
            self._stop.wait(self.valve_timeout)
            return False
        finally:
            self.producing[self.rank] -= 1
        while not self._stop.is_set():
            if self.queue.put(batch, timeout=self.valve_timeout):
                return True
        return False

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._run, name=f'rl-rollout-{self.rank}',
            daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            self.run_once()

    def stop(self, timeout: float = 30.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)


# --------------------------------------------------------------------
# The in-process pipeline (also the simulation/bench harness)
# --------------------------------------------------------------------


def _wave_fns(pool, pool_targets, replicas: int, prompts_per_step: int,
              group_size: int):
    """``make_wave(rank, seq)`` and ``reward(generated, targets)`` over
    a prompt pool: replica ``rank``'s wave ``seq`` takes the next
    ``prompts_per_step`` prompts of the pool, each tiled
    ``group_size`` times."""
    from skypilot_tpu_torch.train import grpo
    pool = np.asarray(pool)
    pool_targets = np.asarray(pool_targets)
    p, g = prompts_per_step, group_size

    def make_wave(rank: int, seq: int):
        idx = ((seq * replicas + rank) * p + np.arange(p)) % len(pool)
        return (np.repeat(pool[idx], g, axis=0),
                np.repeat(pool_targets[idx], g), g)

    def reward(generated, targets):
        return grpo.reward_fn(torch.as_tensor(np.asarray(generated)),
                              torch.as_tensor(np.asarray(targets))
                              ).numpy()

    return make_wave, reward


class RLPipeline:
    """Learner + rollout fleet in one process: the default execution
    mode of ``pipeline:`` recipes at smoke scale, and the harness the
    chaos tests drive. The distributed roles (``main --role
    learner|rollout``) run the same classes over a
    :class:`FileBatchQueue` instead of the in-memory one. Every replica
    engine and the learner live on ``device``."""

    def __init__(self, model_cfg, pcfg: PipelineConfig, *,
                 steps: int = 8,
                 prompts_per_step: int = 2,
                 group_size: int = 4,
                 prompt_len: int = 8,
                 max_new_tokens: int = 8,
                 num_prompts: int = 64,
                 temperature: float = 1.0,
                 learning_rate: float = 1e-3,
                 checkpoint_dir: Optional[str] = None,
                 max_slots: int = 8,
                 seed: int = 0,
                 device: Optional[Any] = None) -> None:
        if not pcfg.store:
            raise ValueError('pipeline needs a store directory '
                             '(pipeline.store / SKYT_RL_STORE)')
        self.model_cfg = model_cfg
        self.pcfg = pcfg
        self.steps = steps
        self.prompts_per_step = prompts_per_step
        self.group_size = group_size
        self.prompt_len = prompt_len
        self.max_new_tokens = max_new_tokens
        self.num_prompts = num_prompts
        self.temperature = temperature
        self.learning_rate = learning_rate
        self.checkpoint_dir = checkpoint_dir
        self.max_slots = max_slots
        self.seed = seed
        self.device = device
        self.workers: List[RolloutWorker] = []
        self.learner = None
        self.queue: Optional[RolloutQueue] = None
        self.staleness: List[int] = []
        self.learn_metrics: List[Dict[str, float]] = []
        self.learn_faults = 0
        self.publish_wall: Dict[int, float] = {}

    # -- construction -------------------------------------------------

    def _build(self):
        from skypilot_tpu_torch.inference.continuous import (
            ContinuousBatchingEngine)
        from skypilot_tpu_torch.train import grpo

        self.learner = grpo.GrpoLearner(
            self.model_cfg, learning_rate=self.learning_rate,
            checkpoint_dir=self.checkpoint_dir, seed=self.seed,
            device=self.device)
        self.store = PolicyStore(self.pcfg.store)
        info = self.store.publish(self.learner.params,
                                  self.learner.version)
        self.publish_wall[info['version']] = time.monotonic()
        self.queue = RolloutQueue(self.pcfg.queue_batches)

        pool, pool_targets = grpo.make_prompts(
            42, self.num_prompts, self.prompt_len,
            self.model_cfg.vocab_size)
        make_wave, reward = _wave_fns(
            pool, pool_targets, self.pcfg.rollout_replicas,
            self.prompts_per_step, self.group_size)
        refresh_slots = threading.Semaphore(
            self.pcfg.refresh_concurrency)
        producing: collections.Counter = collections.Counter()
        p, g = self.prompts_per_step, self.group_size
        for rank in range(self.pcfg.rollout_replicas):
            # The engine copies the learner's weights into its own
            # storage: the learner's in-place steps never reach it
            # before a refresh.
            engine = ContinuousBatchingEngine(
                cfg=self.model_cfg, params=self.learner.params,
                device=self.learner.device,
                max_slots=min(p * g, self.max_slots),
                max_len=min(self.model_cfg.max_seq_len,
                            self.prompt_len + self.max_new_tokens + 1))
            worker = RolloutWorker(
                rank, engine, self.queue, self.store, self.pcfg,
                make_wave=make_wave, reward_fn=reward,
                learner_version=lambda: self.learner.version,
                refresh_slots=refresh_slots, producing=producing,
                pull_dest=os.path.join(self.pcfg.store,
                                       f'replica-{rank}'),
                max_new_tokens=self.max_new_tokens,
                temperature=self.temperature)
            worker.publish_wall = self.publish_wall
            self.workers.append(worker)

    # -- learner loop -------------------------------------------------

    def _consume_one(self, timeout: float = 60.0) -> bool:
        batch = self.queue.pop(timeout=timeout)
        if batch is None:
            return False
        try:
            # Chaos BEFORE any state mutation: an injected learner
            # fault must leave the optimizer state untouched and the
            # batch re-consumable.
            fault_injection.inject(LEARN_STEP_SITE)
            consumed_at = self.learner.version
            out = self.learner.learn_rollouts(
                batch.prompts, batch.generated, batch.rewards,
                batch.group_size)
        except Exception as e:  # pylint: disable=broad-except
            self.learn_faults += 1
            self.queue.requeue(batch)
            metrics.RL_ROLLOUT_BATCHES.inc(outcome='requeued')
            logger.warning('learner step faulted (%s); batch '
                           'rank=%d seq=%d requeued', e, batch.rank,
                           batch.seq)
            return False
        stale = max(0, consumed_at - batch.policy_version)
        self.staleness.append(stale)
        self.learn_metrics.append(out)
        self.queue.ack(batch)
        info = self.store.publish(self.learner.params,
                                  self.learner.version)
        self.publish_wall[info['version']] = time.monotonic()
        metrics.RL_ROLLOUT_BATCHES.inc(outcome='consumed')
        metrics.RL_STALENESS.observe(stale)
        metrics.RL_LEARNER_VERSION.set(self.learner.version)
        metrics.RL_QUEUE_DEPTH.set(self.queue.depth())
        return True

    # -- run ----------------------------------------------------------

    def run(self) -> Dict[str, Any]:
        self._build()
        t0 = time.monotonic()
        for worker in self.workers:
            worker.start()
        try:
            consumed = 0
            deadline = time.monotonic() + 600.0
            while consumed < self.steps:
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f'pipeline stalled at step {consumed}')
                if self._consume_one(timeout=5.0):
                    consumed += 1
        finally:
            for worker in self.workers:
                worker.stop()
            for worker in self.workers:
                worker.engine.shutdown()
        elapsed = time.monotonic() - t0
        if self.learner.checkpoint_dir:
            self.learner.save()
        return self.summary(elapsed)

    def summary(self, elapsed: float) -> Dict[str, Any]:
        lat = sorted(x for w in self.workers
                     for x in w.refresh_latencies)

        def pct(p: float) -> float:
            if not lat:
                return 0.0
            return lat[min(len(lat) - 1, int(p * len(lat)))]

        tokens = sum(w.tokens for w in self.workers)
        return {
            'steps': len(self.staleness),
            'elapsed_s': elapsed,
            'rollout_tokens': tokens,
            'rollout_tokens_per_s': tokens / max(elapsed, 1e-9),
            'waves': sum(w.waves for w in self.workers),
            'refreshes': sum(w.refreshes for w in self.workers),
            'refresh_p50_s': pct(0.50),
            'refresh_p99_s': pct(0.99),
            'staleness_max': max(self.staleness, default=0),
            'staleness_mean': (sum(self.staleness)
                               / max(len(self.staleness), 1)),
            'valve_waits': sum(w.valve_waits for w in self.workers),
            'learn_faults': self.learn_faults,
            'batches_produced': self.queue.produced,
            'batches_acked': self.queue.acked,
            'batches_requeued': self.queue.requeued,
            'batches_unretired': self.queue.unretired(),
            'mean_reward_last': (self.learn_metrics[-1]['mean_reward']
                                 if self.learn_metrics else 0.0),
            'worker_errors': sum(len(w.errors) for w in self.workers),
            'refresh_errors': sum(len(w.refresh_errors)
                                  for w in self.workers),
        }


# --------------------------------------------------------------------
# CLI: the recipe entry point for every role
# --------------------------------------------------------------------


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description='Live-sync GRPO rollout pipeline')
    parser.add_argument('--role', default=None,
                        choices=(None, 'inprocess', 'learner',
                                 'rollout'),
                        help='Pipeline role; default comes from '
                             'SKYT_RL_ROLE (empty = run learner + '
                             'rollout fleet in-process).')
    parser.add_argument('--model', default='tiny')
    parser.add_argument('--vocab-size', type=int, default=None)
    parser.add_argument('--steps', type=int, default=8)
    parser.add_argument('--prompts-per-step', type=int, default=2)
    parser.add_argument('--group-size', type=int, default=4)
    parser.add_argument('--prompt-len', type=int, default=8)
    parser.add_argument('--max-new-tokens', type=int, default=8)
    parser.add_argument('--temperature', type=float, default=1.0)
    parser.add_argument('--learning-rate', type=float, default=1e-3)
    parser.add_argument('--checkpoint-dir', default=None)
    parser.add_argument('--store', default=None)
    parser.add_argument('--rollout-replicas', type=int, default=None)
    parser.add_argument('--device', default=None,
                        help="torch device (default cuda; 'cpu' runs on "
                             'the CPU).')
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from skypilot_tpu_torch.models.config import get_model_config
    overrides = {}
    if args.vocab_size:
        overrides['vocab_size'] = args.vocab_size
    model_cfg = get_model_config(args.model, **overrides)

    pcfg = PipelineConfig.from_env()
    if args.store:
        pcfg.store = args.store
    if args.rollout_replicas is not None:
        pcfg.rollout_replicas = args.rollout_replicas

    role = args.role or env.get_str('SKYT_RL_ROLE') or 'inprocess'
    if role == 'inprocess':
        pipe = RLPipeline(
            model_cfg, pcfg, steps=args.steps,
            prompts_per_step=args.prompts_per_step,
            group_size=args.group_size, prompt_len=args.prompt_len,
            max_new_tokens=args.max_new_tokens,
            temperature=args.temperature,
            learning_rate=args.learning_rate,
            checkpoint_dir=args.checkpoint_dir, device=args.device)
        summary = pipe.run()
        print(json.dumps(summary), flush=True)
        return 0
    if role == 'learner':
        return _run_learner_role(model_cfg, pcfg, args)
    return _run_rollout_role(model_cfg, pcfg, args)


def _run_learner_role(model_cfg, pcfg: PipelineConfig, args) -> int:
    """Distributed learner: consume file-queue batches, publish
    deltas. The rollout fleet discovers new versions by watching the
    store manifest."""
    from skypilot_tpu_torch.train import grpo
    learner = grpo.GrpoLearner(
        model_cfg, learning_rate=args.learning_rate,
        checkpoint_dir=args.checkpoint_dir, device=args.device)
    store = PolicyStore(pcfg.store)
    queue = FileBatchQueue(pcfg.store, pcfg.queue_batches)
    store.publish(learner.params, learner.version)
    consumed = learner.version
    while consumed < args.steps:
        batch = queue.pop(timeout=300.0)
        if batch is None:
            logger.warning('learner: no rollout batch in 300s; '
                           'exiting at step %d', consumed)
            return 1
        try:
            fault_injection.inject(LEARN_STEP_SITE)
            before = learner.version
            out = learner.learn_rollouts(
                batch.prompts, batch.generated, batch.rewards,
                batch.group_size)
        except Exception as e:  # pylint: disable=broad-except
            queue.requeue(batch)
            metrics.RL_ROLLOUT_BATCHES.inc(outcome='requeued')
            logger.warning('learner step faulted (%s); requeued', e)
            continue
        queue.ack(batch)
        store.publish(learner.params, learner.version)
        metrics.RL_ROLLOUT_BATCHES.inc(outcome='consumed')
        metrics.RL_STALENESS.observe(max(0, before - batch.policy_version))
        metrics.RL_LEARNER_VERSION.set(learner.version)
        metrics.RL_QUEUE_DEPTH.set(queue.depth())
        consumed += 1
        print(json.dumps({'step': consumed, **out}), flush=True)
    learner.save()
    return 0


def _run_rollout_role(model_cfg, pcfg: PipelineConfig, args) -> int:
    """Distributed rollout replica: file-queue producer. Runs until
    the learner's committed version reaches --steps (unlike the
    reference's, a worker waiting on a full queue then stops too)."""
    from skypilot_tpu_torch.inference.continuous import (
        ContinuousBatchingEngine)
    from skypilot_tpu_torch.train import grpo
    from skypilot_tpu_torch.utils.device import resolve_device
    device = resolve_device(args.device)
    rank = env.get_int('SKYT_RL_RANK')
    store = PolicyStore(pcfg.store)
    queue = FileBatchQueue(pcfg.store, pcfg.queue_batches)
    # Wait for the learner's first publication: the policy init.
    deadline = time.monotonic() + 300.0
    while store.version() is None:
        if time.monotonic() > deadline:
            raise TimeoutError('no policy published within 300s')
        time.sleep(0.2)
    pulled = store.pull(os.path.join(pcfg.store, f'replica-{rank}'))
    params = _params_from_store(model_cfg, pulled['updates'], device)
    engine = ContinuousBatchingEngine(
        cfg=model_cfg, params=params, device=device,
        max_slots=min(args.prompts_per_step * args.group_size, 8),
        max_len=min(model_cfg.max_seq_len,
                    args.prompt_len + args.max_new_tokens + 1))
    del params
    engine.policy_version = pulled['version']
    pool, pool_targets = grpo.make_prompts(42, 64, args.prompt_len,
                                           model_cfg.vocab_size)
    make_wave, reward = _wave_fns(pool, pool_targets,
                                  pcfg.rollout_replicas,
                                  args.prompts_per_step, args.group_size)
    worker = RolloutWorker(
        rank, engine, queue, store, pcfg,
        make_wave=make_wave, reward_fn=reward,
        learner_version=lambda: store.version() or 0,
        refresh_slots=threading.Semaphore(pcfg.refresh_concurrency),
        producing=collections.Counter(),
        pull_dest=os.path.join(pcfg.store, f'replica-{rank}'),
        max_new_tokens=args.max_new_tokens,
        temperature=args.temperature)
    # The worker runs on its own thread and is stopped once the learner
    # has published the last version: a worker blocked on a full queue
    # (the learner done, nobody consuming) must not hang the role.
    worker.start()
    try:
        while (store.version() or 0) < args.steps:
            time.sleep(0.2)
    finally:
        worker.stop()
        engine.shutdown()
    return 0


def _params_from_store(model_cfg, updates: Dict[str, np.ndarray],
                       device: Optional[Any] = None) -> Dict[str, Any]:
    """A params tree straight from a full store pull: each stored shard
    becomes its leaf (on ``device``, in ``cfg.param_dtype``), checked
    against the shapes ``model_cfg`` implies
    (``models/convert.py:_expected_shapes``). Raises ``ValueError`` on
    a missing or mis-shaped shard and on one the model does not have.
    Nothing is initialized first: at full size that would be a wasted
    multi-GB init."""
    from skypilot_tpu_torch.models.convert import (_expected_shapes,
                                                   tensor_from_numpy)
    from skypilot_tpu_torch.utils.device import resolve_device
    dev = resolve_device(device)
    expected = _expected_shapes(model_cfg)
    missing = sorted(set(expected) - set(updates))
    if missing:
        raise ValueError(f'store pull missing shards: {missing}')
    extra = sorted(set(updates) - set(expected))
    if extra:
        raise ValueError(f'store pull has shards {model_cfg.name} does '
                         f'not: {extra}')
    params: Dict[str, Any] = {}
    for path in sorted(expected):
        array = np.asarray(updates[path])
        if tuple(array.shape) != expected[path]:
            raise ValueError(f'store shard {path!r} has shape '
                             f'{array.shape}, {model_cfg.name} expects '
                             f'{expected[path]}')
        *parents, leaf = path.split('/')
        node = params
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = tensor_from_numpy(array, dev).to(model_cfg.param_dtype)
    return params


def _host_array(leaf: Any) -> np.ndarray:
    """A leaf as the numpy array ``np.save`` writes: a tensor's values
    on the host (bf16 only where numpy has a type for it)."""
    if isinstance(leaf, torch.Tensor):
        return tensor_to_numpy(leaf)
    return np.asarray(leaf)


if __name__ == '__main__':
    raise SystemExit(main())
