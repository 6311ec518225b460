"""The port's continuous engine: its ``infer.*`` trace spans and its
adapter chaos sites against the reference, on the CPU.

Twins of ``tests/test_paged_kv.py::test_engine_emits_trace_spans_per_request``
(the port's engine records the reference's spans, with the same names,
parents and annotations, for the same request, into the same per-trace
store; the server joins a ``traceparent``; under a mesh only the driver
rank records) and of ``tests/test_lora_serving.py``'s injected
``infer.lora.fetch`` / ``infer.lora.evict`` faults (the request fails,
the pool accounting stays exact, the fault clears).
"""
import contextlib
import json
import os
import threading
import urllib.request

import jax
import numpy as np
import pytest

import torch_tp_ranks as ranks
from fault_injection import clause
from skypilot_tpu.inference.continuous import (ContinuousBatchingEngine as
                                               JaxContinuous)
from skypilot_tpu.models import lora as jlora
from skypilot_tpu.models.config import get_model_config as jax_config
from skypilot_tpu.utils import trace_store as jtrace_store
from skypilot_tpu.utils import tracing as jtracing
from skypilot_tpu_torch.inference import server as tserver
from skypilot_tpu_torch.inference.continuous import ContinuousBatchingEngine
from skypilot_tpu_torch.parallel.launch import launch
from skypilot_tpu_torch.utils import fault_injection, trace_store, tracing
from torch_threads import few_torch_threads  # noqa: F401 (autouse)
from torch_tp_ranks import one_thread_ranks  # noqa: F401 (autouse)

PROMPT = [(3 * i + 5) % 512 for i in range(21)]  # 3 chunks of 8


@pytest.fixture
def traced(tmp_path, monkeypatch):
    """Tracing armed at rate 1, spans stored under ``tmp_path``."""
    monkeypatch.setenv('SKYT_TRACE_SAMPLE', '1')
    monkeypatch.setenv('SKYT_TRACE_DIR', str(tmp_path))
    tracing.reset_for_tests()
    jtracing.reset_for_tests()
    yield tmp_path
    tracing.reset_for_tests()
    jtracing.reset_for_tests()


def _skeleton(spans, ctx):
    """Names, services, parents (the caller / the request span) and the
    annotations that do not depend on time, in a stable order."""
    request = next(s for s in spans if s['name'] == 'infer.request')
    parents = {ctx.span_id: 'caller', request['span_id']: 'request'}
    return sorted(
        (s['name'], s['service'], parents.get(s['parent_span_id']),
         s['status'], json.dumps(s.get('annotations', {}), sort_keys=True))
        for s in spans)


def test_engine_emits_trace_spans_per_request(traced):
    """A request submitted with a trace context records an
    ``infer.request`` span with queue-wait / prefill-chunk / decode
    children sharing the caller's trace id; the reference's engine
    records the same skeleton for the same request."""
    eng = ContinuousBatchingEngine('tiny', device='cpu', max_slots=2,
                                   max_len=96, block_size=8,
                                   prefill_chunk=8)
    try:
        ctx = tracing.SpanContext.new_root()
        out = eng.generate_ids(PROMPT, max_new_tokens=4, trace_ctx=ctx)
        assert len(out) <= 4
        spans = trace_store.load_trace(ctx.trace_id)
        by_name = {}
        for s in spans:
            by_name.setdefault(s['name'], []).append(s)
        assert len(by_name['infer.request']) == 1
        request_span = by_name['infer.request'][0]
        assert request_span['parent_span_id'] == ctx.span_id
        assert request_span['annotations']['tokens'] == len(out)
        assert len(by_name['infer.prefill_chunk']) >= 3
        for child_name in ('infer.queue_wait', 'infer.prefill_chunk',
                           'infer.decode'):
            for child in by_name[child_name]:
                assert child['parent_span_id'] == request_span['span_id']
        assert by_name['infer.decode'][0]['annotations']['tokens'] == len(
            out)
        # Untraced requests stay span-free.
        eng.generate_ids([1, 2, 3], max_new_tokens=2)
        assert len(trace_store.load_trace(ctx.trace_id)) == len(spans)
    finally:
        eng.shutdown()
    ref = JaxContinuous('tiny', max_slots=2, max_len=96, block_size=8,
                        prefill_chunk=8)
    try:
        jctx = jtracing.SpanContext.new_root()
        ref.generate_ids(PROMPT, max_new_tokens=4, trace_ctx=jctx)
    finally:
        ref.shutdown()
    assert _skeleton(spans, ctx) == _skeleton(
        jtrace_store.load_trace(jctx.trace_id), jctx)


def test_server_joins_the_callers_traceparent(traced):
    eng = ContinuousBatchingEngine('tiny', device='cpu', max_slots=2,
                                   max_len=96)
    server = tserver.serve(eng, '127.0.0.1', 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        ctx = tracing.SpanContext.new_root()
        req = urllib.request.Request(
            f'http://127.0.0.1:{server.server_address[1]}/generate',
            data=json.dumps({'prompt': 'hi', 'max_new_tokens': 3}).encode(),
            headers={'Content-Type': 'application/json',
                     'traceparent': ctx.to_traceparent()})
        with urllib.request.urlopen(req, timeout=60) as r:
            assert len(json.loads(r.read())['outputs']) == 1
        names = [s['name'] for s in trace_store.load_trace(ctx.trace_id)]
        assert 'infer.request' in names and 'infer.decode' in names
        # A malformed header reads as absent.
        assert tracing.parse_traceparent('00-zz-zz-01') is None
    finally:
        server.shutdown()
        server.server_close()
        eng.shutdown()


def test_only_the_driver_rank_records_spans(traced):
    ctx = tracing.SpanContext.new_root()
    out = launch(ranks.traced_request, 2, ctx.trace_id, ctx.span_id,
                 device='cpu')
    spans = trace_store.load_trace(ctx.trace_id)
    assert {s['name'] for s in spans} >= {'infer.request',
                                          'infer.prefill_chunk',
                                          'infer.decode'}
    assert {s['pid'] for s in spans} == {out[0]['pid']}
    assert out[1]['pid'] != out[0]['pid']


# ---------------------------------------------------------------------------
# Chaos: injected faults at the adapter fetch/evict sites
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _faults(*clauses):
    """The port's ``SKYT_FAULT_SPEC`` for the block, state reset on
    entry and exit (the reference's ``inject_faults`` for the port's
    module)."""
    spec = ','.join(clauses)
    fault_injection.parse_spec(spec)
    previous = os.environ.get(fault_injection.SPEC_ENV)
    os.environ[fault_injection.SPEC_ENV] = spec
    fault_injection.reset()
    try:
        yield
    finally:
        if previous is None:
            os.environ.pop(fault_injection.SPEC_ENV, None)
        else:
            os.environ[fault_injection.SPEC_ENV] = previous
        fault_injection.reset()


def _lora(rank, seed):
    """A non-trivial adapter (B filled), numpy leaves."""
    cfg = jax_config('tiny')
    lora = jlora.init_lora_params(jax.random.key(seed), cfg, rank)
    kb_q, kb_v = jax.random.split(jax.random.key(seed + 1000))
    lora['wq_b'] = 0.05 * jax.random.normal(kb_q, lora['wq_b'].shape)
    lora['wv_b'] = 0.05 * jax.random.normal(kb_v, lora['wv_b'].shape)
    return {k: np.asarray(v) for k, v in lora.items()}


def _pool_snapshot(pool):
    return ([pool.refcount(b) for b in range(pool.num_blocks)],
            pool.free_blocks)


def _lora_engine():
    return ContinuousBatchingEngine('tiny', device='cpu', max_slots=2,
                                    max_len=64, block_size=8,
                                    prefill_chunk=8, lora_pages=1,
                                    lora_max_rank=4)


def test_injected_lora_fetch_fault_fails_request_refcount_exact():
    eng = _lora_engine()
    eng.register_adapter('chaotic', _lora(2, seed=7))
    try:
        baseline = _pool_snapshot(eng._pool)
        with _faults(clause('infer.lora.fetch', 'OSError')):
            with pytest.raises(OSError):
                eng.generate_ids([1, 2, 3], max_new_tokens=4,
                                 adapter='chaotic')
        # The failed fetch retained nothing.
        assert _pool_snapshot(eng._pool) == baseline
        assert eng._adapter_pool.blocks_charged == 0
        # The fault cleared: the same request now serves.
        out = eng.generate_ids([1, 2, 3], max_new_tokens=4,
                               adapter='chaotic')
        assert len(out) == 4
    finally:
        eng.shutdown()


def test_injected_lora_evict_fault_fails_eviction_refcount_exact():
    eng = _lora_engine()
    eng.register_adapter('resident', _lora(2, seed=8))
    eng.register_adapter('incoming', _lora(2, seed=9))
    try:
        eng.generate_ids([5, 6, 7], max_new_tokens=2, adapter='resident')
        snap = _pool_snapshot(eng._pool)
        charged = eng._adapter_pool.blocks_charged
        with _faults(clause('infer.lora.evict', 'OSError')):
            # Admitting 'incoming' must LRU-evict 'resident'; the
            # injected fault aborts that admission...
            with pytest.raises(OSError):
                eng.generate_ids([5, 6, 7], max_new_tokens=2,
                                 adapter='incoming')
        # ...leaving 'resident' resident and the accounting exact.
        assert eng._adapter_pool.resident_names() == ['resident']
        assert eng._adapter_pool.blocks_charged == charged
        assert _pool_snapshot(eng._pool) == snap
        out = eng.generate_ids([5, 6, 7], max_new_tokens=2,
                               adapter='incoming')
        assert len(out) == 2
        assert eng.adapter_stats()['resident']['last_evicted'] > 0
    finally:
        eng.shutdown()
