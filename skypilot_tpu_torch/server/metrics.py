"""The counter/gauge split of the inference server's ``/metrics``.

The port's copy of ``INFERENCE_COUNTER_STATS`` from
``skypilot_tpu/server/metrics.py``: the engine stats that are
cumulative render as Prometheus counters (``skyt_inference_<key>_total``,
rate()-able); every other numeric stat is a point-in-time gauge.
"""
from __future__ import annotations

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
