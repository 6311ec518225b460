"""The port's serving metrics.

* ``INFERENCE_COUNTER_STATS``: the port's copy of the counter/gauge split
  of the inference server's ``/metrics`` (``skypilot_tpu/server/
  metrics.py``): the engine stats that are cumulative render as
  Prometheus counters (``skyt_inference_<key>_total``, rate()-able);
  every other numeric stat is a point-in-time gauge.
* The disaggregated-serving families of that registry, in-process:
  ``KV_MIGRATE_BLOCKS`` / ``KV_MIGRATE_BYTES`` (incremented by
  ``inference/kv_migrate.py``) and the ``DISAGG_HANDOFF`` histogram
  (observed by the decode engine when a migrated import lands), with
  the reference's names, labels and buckets. ``reset_for_tests`` clears
  them.
* The weight fan-out's families (``FANOUT_SHARDS``, ``FANOUT_BYTES``,
  ``FANOUT_HEALS``, ``FANOUT_PULLS``, ``FANOUT_LEASE_WAIT``; incremented
  by ``data/fanout.py``) and the RL pipeline's (``RL_*``; by
  ``jobs/rl_pipeline.py``), with the reference's names, labels and
  buckets. The controller's quarantine and lease gauges stay with the
  reference's orchestrator, which the port does not duplicate.
"""
from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Tuple

INFERENCE_COUNTER_STATS = frozenset({
    'requests', 'completions', 'request_errors',
    'tokens_generated', 'decode_seconds', 'queue_wait_seconds',
    'prefill_chunks', 'prefill_errors',
    'prefix_cache_hits', 'prefix_cache_misses', 'prefix_tokens_reused',
    'preemptions',
    # Speculative decoding: acceptance rate = rate(accepted) /
    # rate(draft); spec_window stays a gauge.
    'draft_tokens', 'accepted_tokens', 'verify_steps',
    # Disaggregated serving: cumulative KV migration counts;
    # kv_exports_pending stays a gauge.
    'kv_exports', 'kv_imports', 'kv_import_fallbacks',
    # Multi-LoRA paging: adapter page-pool traffic; residency and
    # registration counts stay gauges.
    'lora_hits', 'lora_misses', 'lora_evictions',
    # Live weight refresh: cumulative swap counts and time;
    # policy_version stays a gauge.
    'weight_refreshes', 'refresh_shards', 'refresh_seconds',
})

_lock = threading.Lock()
LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(name: str, allowed: Tuple[str, ...],
               labels: Dict[str, str]) -> LabelKey:
    if set(labels) != set(allowed):
        raise ValueError(f'{name} takes labels {sorted(allowed)}, got '
                         f'{sorted(labels)}')
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class Counter:
    """A monotonic counter per label set."""

    def __init__(self, name: str, help_text: str,
                 labels: Tuple[str, ...] = ()) -> None:
        self.name = name
        self.help = help_text
        self.labels = labels
        self._values: Dict[LabelKey, float] = {}

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        key = _label_key(self.name, self.labels, labels)
        with _lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels: str) -> float:
        key = _label_key(self.name, self.labels, labels)
        with _lock:
            return self._values.get(key, 0.0)


class Gauge:
    """A point-in-time value per label set."""

    def __init__(self, name: str, help_text: str,
                 labels: Tuple[str, ...] = ()) -> None:
        self.name = name
        self.help = help_text
        self.labels = labels
        self._values: Dict[LabelKey, float] = {}

    def set(self, value: float, **labels: str) -> None:
        key = _label_key(self.name, self.labels, labels)
        with _lock:
            self._values[key] = float(value)

    def value(self, **labels: str) -> float:
        key = _label_key(self.name, self.labels, labels)
        with _lock:
            return self._values.get(key, 0.0)


class Histogram:
    """Cumulative bucket counts, sum and count per label set, and a
    window of the last 1000 observations."""

    def __init__(self, name: str, help_text: str,
                 buckets: Iterable[float],
                 labels: Tuple[str, ...] = ()) -> None:
        self.name = name
        self.help = help_text
        self.labels = labels
        self.buckets = tuple(sorted(buckets))
        self._counts: Dict[LabelKey, List[int]] = {}
        self._sums: Dict[LabelKey, float] = {}
        self._totals: Dict[LabelKey, int] = {}
        self._samples: Dict[LabelKey, List[float]] = {}

    def observe(self, value: float, **labels: str) -> None:
        key = _label_key(self.name, self.labels, labels)
        with _lock:
            counts = self._counts.setdefault(key, [0] * len(self.buckets))
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    counts[i] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value
            self._totals[key] = self._totals.get(key, 0) + 1
            window = self._samples.setdefault(key, [])
            window.append(value)
            del window[:-1000]

    def count(self, **labels: str) -> int:
        key = _label_key(self.name, self.labels, labels)
        with _lock:
            return self._totals.get(key, 0)

    def samples(self, **labels: str) -> List[float]:
        """The window of recent observations, oldest first."""
        key = _label_key(self.name, self.labels, labels)
        with _lock:
            return list(self._samples.get(key, []))


_TTFB_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                 0.5, 1, 2.5, 5, 10, 30, float('inf'))

DISAGG_HANDOFF = Histogram(
    'skyt_disagg_handoff_seconds',
    'Prefill->decode handoff latency: prefill completion to the '
    'decode replica resuming the stream (KV migration + import; the '
    'TTFT tax disaggregation pays for specialized fleets)',
    buckets=_TTFB_BUCKETS)
KV_MIGRATE_BLOCKS = Counter(
    'skyt_kv_migrate_blocks_total',
    'KV blocks handled by prefill->decode migrations by outcome '
    '(moved = payload crossed the wire, resident = delta-manifest hit '
    'on the decode side\'s PrefixCache so nothing moved, '
    'corrupt_retry = digest mismatch discarded and re-pulled — a '
    'corrupt block is never decoded)',
    labels=('outcome',))
KV_MIGRATE_BYTES = Counter(
    'skyt_kv_migrate_bytes_total',
    'KV migration payload bytes by direction (push = served by the '
    'prefill side, pull = received verified by the decode side)',
    labels=('direction',))

_TRANSFER_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 30, 60, 120,
                     300, 600, float('inf'))

FANOUT_SHARDS = Counter(
    'skyt_fanout_shards_total',
    'Fan-out shard fetches by source (peer, bucket) and outcome (ok, '
    'corrupt = digest mismatch, error = source died/timed out, '
    'resumed = continued a partial shard)',
    labels=('source', 'outcome'))
FANOUT_BYTES = Counter(
    'skyt_fanout_bytes_total',
    'Fan-out weight bytes received by source (peer, bucket)',
    labels=('source',))
FANOUT_HEALS = Counter(
    'skyt_fanout_heals_total',
    'Fan-out tree re-parent events by reason (dead = peer '
    'unavailable/timeout, corrupt = digest mismatch)',
    labels=('reason',))
FANOUT_PULLS = Counter(
    'skyt_fanout_pulls_total',
    'Completed fan-out pulls by outcome (a pull = one replica '
    'reaching verified-complete weights)',
    labels=('outcome',))
FANOUT_LEASE_WAIT = Histogram(
    'skyt_fanout_lease_wait_seconds',
    'Seconds a puller waited for a bucket-read lease (convoy '
    'control: bounded to O(log N) concurrent origin readers)',
    buckets=_TRANSFER_BUCKETS,
    labels=())

_RL_SYNC_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                    1.0, 2.5, 5.0, 10.0, 30.0, float('inf'))
_RL_STALENESS_BUCKETS = (0, 1, 2, 3, 4, 6, 8, 12, 16, 32,
                         float('inf'))

RL_ROLLOUT_TOKENS = Counter(
    'skyt_rl_rollout_tokens_total',
    'Rollout tokens generated by the pipeline rollout fleet, by '
    'replica rank',
    labels=('rank',))
RL_ROLLOUT_BATCHES = Counter(
    'skyt_rl_rollout_batches_total',
    'Rollout batches by outcome (produced = enqueued for the '
    'learner, consumed = folded into a learner step, requeued = '
    'returned to the queue after a learner fault mid-step)',
    labels=('outcome',))
RL_WEIGHT_REFRESHES = Counter(
    'skyt_rl_weight_refreshes_total',
    'Per-replica live weight refreshes by outcome (ok, error)',
    labels=('outcome',))
RL_WEIGHT_SYNC_SECONDS = Histogram(
    'skyt_rl_weight_sync_seconds',
    'Learner-commit to rollout-replica-swapped latency per refresh '
    '(delta manifest pull + per-shard device_put at the step '
    'boundary)',
    buckets=_RL_SYNC_BUCKETS,
    labels=())
RL_STALENESS = Histogram(
    'skyt_rl_staleness_steps',
    'Off-policy staleness at consume: learner steps between the '
    'policy version that generated a rollout batch and the version '
    'that consumed it (bounded by SKYT_RL_MAX_STALENESS)',
    buckets=_RL_STALENESS_BUCKETS,
    labels=())
RL_VALVE_WAITS = Counter(
    'skyt_rl_valve_waits_total',
    'Times a rollout replica paused generation on the max_staleness '
    'backpressure valve (waiting for a weight refresh to land)',
    labels=('rank',))
RL_LEARNER_VERSION = Gauge(
    'skyt_rl_learner_version',
    'Latest policy version the learner has published',
    labels=())
RL_QUEUE_DEPTH = Gauge(
    'skyt_rl_queue_depth',
    'Rollout batches buffered between the rollout fleet and the '
    'learner',
    labels=())

_ALL = (DISAGG_HANDOFF, KV_MIGRATE_BLOCKS, KV_MIGRATE_BYTES,
        FANOUT_SHARDS, FANOUT_BYTES, FANOUT_HEALS, FANOUT_PULLS,
        FANOUT_LEASE_WAIT, RL_ROLLOUT_TOKENS, RL_ROLLOUT_BATCHES,
        RL_WEIGHT_REFRESHES, RL_WEIGHT_SYNC_SECONDS, RL_STALENESS,
        RL_VALVE_WAITS, RL_LEARNER_VERSION, RL_QUEUE_DEPTH)


def reset_for_tests() -> None:
    with _lock:
        for metric in _ALL:
            for attr in ('_values', '_counts', '_sums', '_totals',
                         '_samples'):
                if hasattr(metric, attr):
                    getattr(metric, attr).clear()
