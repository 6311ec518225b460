"""The port's multi-LoRA serving against the JAX reference.

* **Math**: ``apply_lora_qv``, ``apply_lora_pages``, the page upload,
  ``merge`` and ``llama.forward`` with an adapter mounted agree with
  the reference within 2e-5 (absolute, fp32) on converted weights; a
  page-0 row of a mixed batch is bitwise the base step's row.
* **Host policy**: ``AdapterPagePool`` accounting, pins and failed
  admissions, and the DRR admission queue, on the reference's cases.
* **Engines** (TINY, fp32 compute, the JAX engine's weights and
  adapters): a base request on a LoRA engine gives the base engine's
  tokens and the JAX engine's; two tenants' greedy tokens equal the
  JAX LoRA engine's; merge-then-serve equals the adapter runtime;
  adapter prefix chains never collide; residency stats; unknown
  adapters and bad registrations are refused; a hot adapter cannot
  starve a light one; the per-adapter quota; a failed fetch or
  eviction fails the request and leaves every refcount exact.
* **Registry**: export/load round trip, corrupt shards detected, bad
  tenants skipped, and adapters cross between the two packages'
  registries in both directions.

Token ids are compared exactly.
"""
import dataclasses
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.inference.continuous import (
    ContinuousBatchingEngine as JaxEngine)
from skypilot_tpu.models import decode as jdecode
from skypilot_tpu.models import llama as jllama
from skypilot_tpu.models import lora as jlora
from skypilot_tpu.models.config import get_model_config as jax_config
from skypilot_tpu.serve import adapter_registry as jregistry
from skypilot_tpu_torch.inference.continuous import (
    ContinuousBatchingEngine as TorchEngine)
from skypilot_tpu_torch.inference.continuous import _DrrQueue, _Request
from skypilot_tpu_torch.inference.paged import (AdapterPagePool, BlockPool,
                                                adapter_chain_root)
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models import decode as tdecode
from skypilot_tpu_torch.models import llama as tllama
from skypilot_tpu_torch.models import lora as tlora
from skypilot_tpu_torch.models.config import get_model_config as torch_config
from skypilot_tpu_torch.serve import adapter_registry as tregistry
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

ATOL = 2e-5
KW = dict(max_slots=2, max_len=96, block_size=8, prefill_chunk=8)
JCFG = jax_config('tiny', compute_dtype=jnp.float32)
PROMPT = [(7 * i + 3) % 512 for i in range(21)]


def _tcfg():
    return torch_config('tiny', compute_dtype=torch.float32)


def _jax_lora(rank, seed=1):
    """A non-trivial reference adapter (B filled, so deltas move
    tokens), as numpy leaves."""
    lora = jlora.init_lora_params(jax.random.key(seed), JCFG, rank)
    kb_q, kb_v = jax.random.split(jax.random.key(seed + 1000))
    lora['wq_b'] = 0.05 * jax.random.normal(kb_q, lora['wq_b'].shape)
    lora['wv_b'] = 0.05 * jax.random.normal(kb_v, lora['wv_b'].shape)
    return {k: np.asarray(v) for k, v in lora.items()}


def _port_lora(rank, seed=1):
    return convert.lora_from_numpy(_jax_lora(rank, seed), _tcfg(),
                                   device='cpu')


def _pool_snapshot(pool):
    return ([pool.refcount(b) for b in range(pool.num_blocks)],
            pool.free_blocks)


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=ATOL)


# ---------------------------------------------------------------------------
# Math against the reference
# ---------------------------------------------------------------------------

def test_apply_lora_qv_matches_reference():
    lora = _jax_lora(4, seed=2)
    x = np.random.RandomState(0).randn(2, 5, JCFG.d_model).astype(
        np.float32)
    jq, jv = jlora.apply_lora_qv(jnp.asarray(x),
                                 {k: v[1] for k, v in lora.items()})
    tq, tv = tlora.apply_lora_qv(
        torch.from_numpy(x),
        {k: torch.from_numpy(np.array(v[1])) for k, v in lora.items()})
    _close(tq, jq)
    _close(tv, jv)


def test_adapter_pages_match_reference():
    """The page uploads (ranks 4 and 2 padded to 4) are equal exactly,
    the store converts, and the per-slot deltas of a mixed batch agree
    within 2e-5."""
    a, b = _jax_lora(4, seed=3), _jax_lora(2, seed=4)
    jpages = jlora.init_adapter_pages(JCFG, 2, 4)
    jpages = jlora.write_adapter_page(jpages, 1, a, alpha=16.0)
    jpages = jlora.write_adapter_page(jpages, 2, b, alpha=8.0)
    tpages = tlora.init_adapter_pages(_tcfg(), 2, 4, device='cpu')
    tlora.write_adapter_page(tpages, 1, a, alpha=16.0)
    tlora.write_adapter_page(tpages, 2, _port_lora(2, seed=4), alpha=8.0)
    converted = convert.adapter_pages_from_numpy(
        jax.tree.map(np.asarray, jpages), _tcfg(), device='cpu')
    for key in tpages:
        assert torch.equal(tpages[key], converted[key]), key
    x = np.random.RandomState(1).randn(3, 4, JCFG.d_model).astype(
        np.float32)
    ids = np.array([2, 0, 1], np.int32)
    for layer in range(JCFG.n_layers):
        jq, jv = jlora.apply_lora_pages(
            jnp.asarray(x), {k: v[layer] for k, v in jpages.items()},
            jnp.asarray(ids))
        tq, tv = tlora.apply_lora_pages(
            torch.from_numpy(x), {k: v[layer] for k, v in tpages.items()},
            torch.from_numpy(ids))
        _close(tq, jq)
        _close(tv, jv)
        assert not tq[1].any() and not tv[1].any()   # page 0: exact zero
    assert tlora.adapter_nbytes(_tcfg(), 4) == jlora.adapter_nbytes(JCFG, 4)
    with pytest.raises(ValueError, match='page 0'):
        tlora.write_adapter_page(tpages, 0, a)
    with pytest.raises(ValueError, match='max_rank'):
        tlora.write_adapter_page(tpages, 1, _jax_lora(8))


def test_merge_and_forward_with_adapter_match_reference():
    jparams = jllama.init_params(jax.random.key(0), JCFG)
    lora = _jax_lora(4, seed=5)
    jattached = jlora.attach(jparams, {k: jnp.asarray(v)
                                       for k, v in lora.items()})
    tattached = convert.params_from_numpy(
        jax.tree.map(np.asarray, jattached), _tcfg(), device='cpu')
    assert set(tattached['layers']['lora']) == set(tlora.LEAVES)
    tokens = np.array([[3, 1, 4, 1, 5, 9, 2, 6]], np.int32)
    want = jllama.forward(jattached, jnp.asarray(tokens), JCFG)
    got = tllama.forward(tattached, torch.from_numpy(tokens), _tcfg())
    _close(got, want)
    jmerged = jlora.merge(jattached)
    tmerged = tlora.merge(tattached)
    assert 'lora' not in tmerged['layers']
    for key in ('wq', 'wv'):
        _close(tmerged['layers']['attn'][key],
               jmerged['layers']['attn'][key])
    base = tllama.forward(tlora.detach(tattached), torch.from_numpy(tokens),
                          _tcfg())
    assert (got - base).abs().max() > 1e-3   # the adapter moves logits


def test_page_zero_row_is_bitwise_the_base_step():
    """A mixed batch (slot 0 on an adapter page, slot 1 on page 0): slot
    1's logits and KV equal the base step's bit for bit."""
    tparams = convert.params_from_numpy(
        jax.tree.map(np.asarray, jllama.init_params(jax.random.key(0),
                                                    JCFG)),
        _tcfg(), device='cpu')
    pages = tlora.init_adapter_pages(_tcfg(), 1, 4, device='cpu')
    tlora.write_adapter_page(pages, 1, _port_lora(4, seed=6))
    tokens = torch.tensor([[5, 6, 7], [8, 9, 10]], dtype=torch.int32)
    out = {}
    for name, lora_args in (('base', {}),
                            ('lora', dict(lora_pages=pages,
                                          adapter_ids=torch.tensor(
                                              [1, 0], dtype=torch.int32)))):
        cache = tdecode.init_paged_cache(_tcfg(), 5, 8, 2, 2, device='cpu')
        cache = dataclasses.replace(cache, block_tables=torch.tensor(
            [[1, 2], [3, 4]], dtype=torch.int32))
        logits, cache = tdecode.paged_verify_step(tparams, tokens, cache,
                                                  _tcfg(), **lora_args)
        out[name] = (logits, cache)
    (lb, cb), (ll, cl) = out['base'], out['lora']
    assert torch.equal(ll[1], lb[1])
    assert torch.equal(cl.k[:, 3], cb.k[:, 3])
    assert torch.equal(cl.v[:, 3], cb.v[:, 3])
    assert not torch.equal(ll[0], lb[0])


# ---------------------------------------------------------------------------
# AdapterPagePool and the DRR queue (host-side policy)
# ---------------------------------------------------------------------------

def test_adapter_page_pool_refcount_exact_accounting():
    pool = BlockPool(8)
    apool = AdapterPagePool(pool, n_pages=2, block_bytes=100)
    baseline = _pool_snapshot(pool)
    assert apool.blocks_for(150) == 2 and apool.blocks_for(1) == 1
    assert apool.admit('a', 150) == 1
    assert apool.admit('b', 50) == 2
    assert apool.resident_pages == 2 and apool.blocks_charged == 3
    assert pool.free_blocks == 7 - 3
    assert apool.lookup('a') == 1 and apool.lookup('nope') is None
    assert apool.hits == 1 and apool.misses == 1
    page = apool.admit('c', 100)    # evicts 'b', the least recent
    assert page == 2 and apool.evictions == 1
    assert apool.resident_names() == ['a', 'c']
    apool.clear()
    assert apool.blocks_charged == 0 and apool.resident_pages == 0
    assert _pool_snapshot(pool) == baseline


def test_adapter_page_pool_pins_block_eviction():
    pool = BlockPool(8)
    apool = AdapterPagePool(pool, n_pages=1, block_bytes=100)
    assert apool.admit('a', 10) == 1
    apool.pin('a')
    assert apool.evict_lru() is None
    assert apool.admit('b', 10) is None
    assert apool.resident_names() == ['a']
    version = pool.version
    apool.unpin('a')
    assert pool.version != version
    assert apool.admit('b', 10) == 1
    with pytest.raises(ValueError, match='non-resident'):
        apool.pin('a')
    with pytest.raises(ValueError, match='unpinned'):
        apool.unpin('b')
    apool.clear()
    assert pool.free_blocks == pool.total_blocks


def test_adapter_page_pool_failed_admission_retains_nothing():
    pool = BlockPool(6)
    apool = AdapterPagePool(pool, n_pages=2, block_bytes=100)
    assert apool.admit('a', 250) == 1
    before = _pool_snapshot(pool)
    with pytest.raises(ValueError, match='charge blocks'):
        apool.admit('huge', 100 * 100)
    assert _pool_snapshot(pool) == before
    apool.pin('a')
    assert apool.admit('b', 250) is None
    assert _pool_snapshot(pool) == before
    apool.unpin('a')
    calls = {'n': 0}

    def exploding_alloc():
        if calls['n'] >= 1:
            raise OSError('injected')
        calls['n'] += 1
        return pool.alloc()

    with pytest.raises(OSError):
        apool.admit('b', 150, alloc=exploding_alloc)
    assert _pool_snapshot(pool) == before
    with pytest.raises(ValueError, match='already resident'):
        apool.admit('a', 10)
    apool.clear()
    assert pool.free_blocks == pool.total_blocks


def _req(n_tokens, adapter=None):
    return _Request(list(range(n_tokens)), 8, 0.0, None, 0,
                    adapter=adapter)


def test_drr_queue_single_lane_is_exact_fifo():
    q = _DrrQueue(block_size=8, quantum_blocks=4)
    reqs = [_req(24) for _ in range(5)]
    for r in reqs:
        q.push(r)
    assert len(q) == 5
    assert [q.pop() for _ in range(5)] == reqs
    assert q.pop() is None and len(q) == 0


def test_drr_queue_hot_lane_cannot_starve_light_lanes():
    q = _DrrQueue(block_size=8, quantum_blocks=4)
    hot = [_req(8, 'hot') for _ in range(100)]
    for r in hot[:50]:
        q.push(r)
    light_a, light_b, base = _req(8, 'a'), _req(8, 'b'), _req(8)
    q.push(light_a)
    q.push(light_b)
    q.push(base)
    for r in hot[50:]:
        q.push(r)
    first_eight = [q.pop() for _ in range(8)]
    assert light_a in first_eight and light_b in first_eight
    assert base in first_eight
    rest = [q.pop() for _ in range(len(q))]
    assert [r for r in first_eight + rest if r.adapter == 'hot'] == hot


def test_drr_queue_push_front_refunds_and_blocked_lanes_skip():
    q = _DrrQueue(block_size=8, quantum_blocks=4)
    blocked_req, other = _req(8, 'quota'), _req(8, 'free')
    q.push(blocked_req)
    q.push(other)
    assert q.pop(blocked=lambda r: r.adapter == 'quota') is other
    assert q.pop(blocked=lambda r: True) is None
    assert len(q) == 1
    assert q.pop() is blocked_req
    q.push_front(blocked_req)
    assert q.pop() is blocked_req
    assert q.pop() is None


# ---------------------------------------------------------------------------
# Engines against the JAX LoRA engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def engines():
    ref = JaxEngine('tiny', cfg=JCFG, lora_pages=2, lora_max_rank=4, **KW)
    ref.register_adapter('tenant-a', _jax_lora(4, seed=1))
    ref.register_adapter('tenant-b', _jax_lora(2, seed=2))
    params = convert.params_from_numpy(
        jax.tree.map(np.asarray, ref.params), _tcfg(), device='cpu')
    port = TorchEngine('tiny', cfg=_tcfg(), params=params, device='cpu',
                       lora_pages=2, lora_max_rank=4, **KW)
    port.register_adapter('tenant-a', _port_lora(4, seed=1))
    port.register_adapter('tenant-b', _jax_lora(2, seed=2))  # numpy too
    base = TorchEngine('tiny', cfg=_tcfg(), params=params, device='cpu',
                       **KW)
    yield ref, port, base, params
    # Teardown accounting: once idle, evicting every adapter returns
    # every charge block.
    apool = port._adapter_pool
    charged, free_before = apool.blocks_charged, port._pool.free_blocks
    apool.clear()
    assert apool.blocks_charged == 0
    assert port._pool.free_blocks == free_before + charged
    for eng in (ref, port, base):
        eng.shutdown()


def _jax_greedy(ref, ids, n):
    generated, gen_len = jdecode.generate(
        ref.params, jnp.asarray([ids], jnp.int32),
        jnp.asarray([len(ids)], jnp.int32), ref.cfg, max_new_tokens=n,
        temperature=0.0)
    return [int(t) for t in np.asarray(generated)[0][:int(gen_len[0])]]


def test_base_request_on_lora_engine_equals_base_and_jax(engines):
    ref, port, base, _ = engines
    want = _jax_greedy(ref, PROMPT, 8)
    assert base.generate_ids(PROMPT, max_new_tokens=8) == want
    # Alone (an all-base batch) and beside an adapter request (a mixed
    # batch, page 0 for the base slot).
    assert port.generate_ids(PROMPT, max_new_tokens=8) == want
    adapted = port.submit_ids(PROMPT, max_new_tokens=8, adapter='tenant-a')
    mixed = port.submit_ids(PROMPT, max_new_tokens=8)
    for h in (adapted, mixed):
        assert h.done.wait(120) and h.error is None
    assert mixed.generated == want
    assert adapted.generated != want


def test_two_tenants_equal_jax_lora_engine(engines):
    ref, port, _, _ = engines
    for ids in (PROMPT, [(5 * i + 2) % 512 for i in range(9)]):
        for tenant in ('tenant-a', 'tenant-b'):
            want = ref.generate_ids(ids, max_new_tokens=8, adapter=tenant,
                                    timeout=120)
            assert port.generate_ids(ids, max_new_tokens=8,
                                     adapter=tenant) == want, tenant
    # Both tenants at once, in one batch.
    handles = {t: port.submit_ids(PROMPT, max_new_tokens=8, adapter=t)
               for t in ('tenant-a', 'tenant-b')}
    for tenant, h in handles.items():
        assert h.done.wait(120) and h.error is None
        assert h.generated == ref.generate_ids(
            PROMPT, max_new_tokens=8, adapter=tenant, timeout=120)


@pytest.mark.parametrize('quantize_kv', [False, True],
                         ids=['fp32', 'int8_kv'])
def test_merge_then_serve_matches_adapter_runtime(engines, quantize_kv):
    _, _, _, params = engines
    lora = _port_lora(4, seed=3)
    merged = tlora.merge(tlora.attach(params, lora))
    eng_merged = TorchEngine('tiny', cfg=_tcfg(), params=merged,
                             device='cpu', quantize_kv=quantize_kv, **KW)
    eng_paged = TorchEngine('tiny', cfg=_tcfg(), params=params,
                            device='cpu', quantize_kv=quantize_kv,
                            lora_pages=1, lora_max_rank=4, **KW)
    eng_paged.register_adapter('ft', lora)
    try:
        for ids in (PROMPT, [(11 * i + 7) % 512 for i in range(8)]):
            want = eng_merged.generate_ids(ids, max_new_tokens=8)
            got = eng_paged.generate_ids(ids, max_new_tokens=8,
                                         adapter='ft')
            assert got == want, ids
    finally:
        eng_merged.shutdown()
        eng_paged.shutdown()


def test_speculative_lora_engine_equals_lora_engine(engines):
    """Verify windows carry the adapter deltas too: a speculative LoRA
    engine gives the LoRA engine's greedy tokens, base and adapter."""
    _, port, _, params = engines
    spec = TorchEngine('tiny', cfg=_tcfg(), params=params, device='cpu',
                       lora_pages=1, lora_max_rank=4, spec_decode=True,
                       draft_k=3, **KW)
    spec.register_adapter('tenant-a', _port_lora(4, seed=1))
    try:
        for ids in (PROMPT, [5, 6, 7, 8] * 4):
            for adapter in ('tenant-a', None):
                want = port.generate_ids(ids, max_new_tokens=12,
                                         adapter=adapter)
                assert spec.generate_ids(ids, max_new_tokens=12,
                                         adapter=adapter) == want
        assert spec.stats()['verify_steps'] > 0
    finally:
        spec.shutdown()


def test_adapter_prefix_chains_never_collide(engines):
    _, port, _, _ = engines
    assert adapter_chain_root(None) == 0 == adapter_chain_root('')
    assert adapter_chain_root('a') != adapter_chain_root('b')
    assert adapter_chain_root('a') != 0
    ids = [(3 * i + 11) % 512 for i in range(17)]
    base_1 = port.generate_ids(ids, max_new_tokens=6)
    stats_0 = port.stats()
    adapted_1 = port.generate_ids(ids, max_new_tokens=6,
                                  adapter='tenant-a')
    stats_1 = port.stats()
    assert stats_1['prefix_cache_hits'] == stats_0['prefix_cache_hits']
    adapted_2 = port.generate_ids(ids, max_new_tokens=6,
                                  adapter='tenant-a')
    stats_2 = port.stats()
    assert stats_2['prefix_cache_hits'] == stats_1['prefix_cache_hits'] + 1
    assert adapted_2 == adapted_1
    assert port.generate_ids(ids, max_new_tokens=6) == base_1


def test_adapter_residency_hits_misses_and_stats(engines):
    _, port, _, _ = engines
    ids = [9, 8, 7, 6, 5]
    before = port.stats()
    port.generate_ids(ids, max_new_tokens=4, adapter='tenant-b')
    port.generate_ids(ids, max_new_tokens=4, adapter='tenant-b')
    after = port.stats()
    assert after['lora_misses'] >= before['lora_misses']
    assert after['lora_hits'] >= before['lora_hits'] + 1
    assert after['lora_adapters_registered'] == 2
    assert after['lora_pages_total'] == 2
    assert after['lora_blocks_charged'] > 0
    per = port.adapter_stats()
    assert per['tenant-b']['requests'] >= 2
    assert per['tenant-b']['rank'] == 2
    assert per['tenant-b']['resident'] == 1.0
    assert set(per) == {'tenant-a', 'tenant-b'}
    assert port.adapters() == ['tenant-a', 'tenant-b']


def test_unknown_adapter_rejected_eagerly(engines):
    _, port, _, _ = engines
    with pytest.raises(ValueError, match='not registered'):
        port.generate_ids([1, 2, 3], max_new_tokens=2,
                          adapter='never-registered')


def test_register_adapter_validation(engines):
    _, port, _, params = engines
    with pytest.raises(ValueError, match='rank'):
        port.register_adapter('too-big', _port_lora(8))
    with pytest.raises(ValueError, match='does not match'):
        port.register_adapter('wrong-shape', {
            k: v[:1] for k, v in _port_lora(2).items()})
    eng = TorchEngine('tiny', cfg=_tcfg(), params=params, device='cpu',
                      max_slots=1, max_len=32, lora_pages=1,
                      lora_max_rank=4, base_digest='digest-of-base-X')
    try:
        with pytest.raises(ValueError, match='trained against base'):
            eng.register_adapter('wrong-base', _port_lora(2),
                                 base_digest='digest-of-base-Y')
        eng.register_adapter('right-base', _port_lora(2),
                             base_digest='digest-of-base-X')
        with pytest.raises(ValueError, match='non-empty'):
            eng.register_adapter('', _port_lora(2))
    finally:
        eng.shutdown()
    plain = TorchEngine('tiny', cfg=_tcfg(), params=params, device='cpu',
                        max_slots=1, max_len=32)
    try:
        with pytest.raises(RuntimeError, match='no adapter pages'):
            plain.register_adapter('x', _port_lora(2))
        with pytest.raises(ValueError, match='not registered'):
            plain.generate_ids([1, 2], max_new_tokens=2, adapter='x')
    finally:
        plain.shutdown()


def test_hot_adapter_cannot_starve_light_tenant(engines, monkeypatch):
    """A backlog of hot-adapter requests is queued first, then one
    light-tenant request; DRR admission lets the light one overtake
    most of the backlog. The finish order is read from the engine's
    single exit point."""
    _, port, _, _ = engines
    order = []
    finish = port._finish

    def recording_finish(request, error=None):
        order.append(request)
        finish(request, error)

    monkeypatch.setattr(port, '_finish', recording_finish)
    ids = [3, 1, 4, 1, 5]
    hot = [port._submit(ids + [i % 7], 4, 0.0, None, 0,
                        adapter='tenant-a') for i in range(10)]
    light = port._submit(ids + [9], 4, 0.0, None, 0, adapter='tenant-b')
    for h in hot + [light]:
        assert h.done.wait(120) and h.error is None
    assert order.index(light) < 8


def test_per_adapter_quota_queues_without_blocking_others(engines):
    _, _, _, params = engines
    eng = TorchEngine('tiny', cfg=_tcfg(), params=params, device='cpu',
                      max_slots=2, max_len=64, block_size=8,
                      prefill_chunk=8, lora_pages=2, lora_max_rank=4,
                      lora_max_active=1)
    eng.register_adapter('q', _port_lora(2, seed=5))
    try:
        results = {}

        def run(tag, adapter):
            results[tag] = eng.generate_ids([1, 2, 3, 4], max_new_tokens=6,
                                            adapter=adapter)

        threads = [threading.Thread(target=run, args=(f'q{i}', 'q'))
                   for i in range(3)]
        threads.append(threading.Thread(target=run, args=('base', None)))
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert len(results) == 4
        assert results['q0'] == results['q1'] == results['q2']
    finally:
        eng.shutdown()


def test_fetch_failure_fails_request_refcount_exact(engines, monkeypatch):
    """Where the reference raises its ``infer.lora.fetch`` fault: the
    request fails, and KV blocks, page slots and charge blocks all
    return."""
    _, _, _, params = engines
    eng = TorchEngine('tiny', cfg=_tcfg(), params=params, device='cpu',
                      max_slots=2, max_len=64, block_size=8,
                      prefill_chunk=8, lora_pages=1, lora_max_rank=4)
    eng.register_adapter('chaotic', _port_lora(2, seed=7))
    try:
        baseline = _pool_snapshot(eng._pool)

        def failing_fetch(entry):
            raise OSError('injected fetch failure')

        monkeypatch.setattr(eng, '_fetch_adapter', failing_fetch)
        with pytest.raises(OSError, match='injected'):
            eng.generate_ids([1, 2, 3], max_new_tokens=4, adapter='chaotic')
        assert _pool_snapshot(eng._pool) == baseline
        assert eng._adapter_pool.blocks_charged == 0
        assert eng.stats()['prefill_errors'] == 1
        monkeypatch.undo()
        out = eng.generate_ids([1, 2, 3], max_new_tokens=4,
                               adapter='chaotic')
        assert len(out) == 4
    finally:
        eng.shutdown()


def test_evict_failure_fails_request_refcount_exact(engines, monkeypatch):
    """Where the reference raises its ``infer.lora.evict`` fault: the
    admission that needed the eviction fails, the resident adapter stays
    resident, and the accounting is exact."""
    _, _, _, params = engines
    eng = TorchEngine('tiny', cfg=_tcfg(), params=params, device='cpu',
                      max_slots=2, max_len=64, block_size=8,
                      prefill_chunk=8, lora_pages=1, lora_max_rank=4)
    eng.register_adapter('resident', _port_lora(2, seed=8))
    eng.register_adapter('incoming', _port_lora(2, seed=9))
    try:
        eng.generate_ids([5, 6, 7], max_new_tokens=2, adapter='resident')
        snap = _pool_snapshot(eng._pool)
        charged = eng._adapter_pool.blocks_charged
        note = eng._note_adapter_evict

        def failing_evict(name):
            raise OSError('injected evict failure')

        monkeypatch.setattr(eng, '_note_adapter_evict', failing_evict)
        with pytest.raises(OSError, match='injected'):
            eng.generate_ids([5, 6, 7], max_new_tokens=2,
                             adapter='incoming')
        assert eng._adapter_pool.resident_names() == ['resident']
        assert eng._adapter_pool.blocks_charged == charged
        assert _pool_snapshot(eng._pool) == snap
        monkeypatch.setattr(eng, '_note_adapter_evict', note)
        out = eng.generate_ids([5, 6, 7], max_new_tokens=2,
                               adapter='incoming')
        assert len(out) == 2
        assert eng.adapter_stats()['resident']['last_evicted'] > 0
    finally:
        eng.shutdown()


# ---------------------------------------------------------------------------
# Adapter registry
# ---------------------------------------------------------------------------

def test_adapter_registry_export_load_roundtrip(tmp_path):
    root = str(tmp_path / 'registry')
    lora = _port_lora(2, seed=11)
    directory = tregistry.export_adapter(
        root, 'my-ft', lora, alpha=16.0, base_digest='base-abc', step=7,
        extra_meta={'note': 'test'})
    name, loaded, meta = tregistry.load_adapter(
        directory, expect_base_digest='base-abc')
    assert name == 'my-ft' and meta['rank'] == 2 and meta['note'] == 'test'
    for key in tregistry.ADAPTER_LEAVES:
        np.testing.assert_array_equal(loaded[key], lora[key].numpy())
    with pytest.raises(ValueError, match='trained against base'):
        tregistry.load_adapter(directory, expect_base_digest='base-zzz')
    tregistry.export_adapter(root, 'my-ft', lora, alpha=16.0,
                             base_digest='base-abc')
    assert tregistry.scan_registry(root) == [directory]


def test_adapter_registry_detects_corrupt_shards(tmp_path):
    directory = tregistry.export_adapter(
        str(tmp_path / 'registry'), 'torn', _port_lora(2, seed=12),
        alpha=16.0, base_digest='base-abc')
    shard = next(f for f in os.listdir(directory) if f.startswith('wq_a-'))
    with open(os.path.join(directory, shard), 'r+b') as f:
        f.seek(-1, 2)
        f.write(b'\xff')
    with pytest.raises(ValueError, match='failed verification'):
        tregistry.load_adapter(directory)


def test_load_registry_into_engine_skips_bad_tenants(engines, tmp_path):
    _, _, _, params = engines
    root = str(tmp_path / 'registry')
    tregistry.export_adapter(root, 'good', _port_lora(2, seed=13),
                             alpha=16.0, base_digest='base-X')
    tregistry.export_adapter(root, 'wrong-base', _port_lora(2, seed=14),
                             alpha=16.0, base_digest='base-Y')
    eng = TorchEngine('tiny', cfg=_tcfg(), params=params, device='cpu',
                      max_slots=1, max_len=32, lora_pages=1,
                      lora_max_rank=4, base_digest='base-X')
    try:
        assert tregistry.load_registry_into(eng, root) == ['good']
        assert eng.adapters() == ['good']
    finally:
        eng.shutdown()


def test_adapters_cross_between_the_two_registries(engines, tmp_path):
    """An adapter exported by the reference loads into the port (and
    serves the JAX engine's tokens there), one exported by the port
    loads into the reference, both bytes-identical on disk; the base
    digests of the same weights agree."""
    ref, _, _, params = engines
    jparams = jax.tree.map(np.asarray, ref.params)
    digest = jregistry.params_digest(jparams)
    assert tregistry.params_digest(params) == digest
    lora = _jax_lora(4, seed=1)
    jdir = jregistry.export_adapter(str(tmp_path / 'from-jax'), 'tenant-a',
                                    lora, alpha=16.0, base_digest=digest)
    tdir = tregistry.export_adapter(str(tmp_path / 'from-port'),
                                    'tenant-a',
                                    convert.lora_from_numpy(
                                        lora, _tcfg(), device='cpu'),
                                    alpha=16.0, base_digest=digest)
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir))
    for name in os.listdir(jdir):
        with open(os.path.join(jdir, name), 'rb') as a, \
                open(os.path.join(tdir, name), 'rb') as b:
            assert a.read() == b.read(), name
    name, loaded, meta = jregistry.load_adapter(
        tdir, expect_base_digest=digest)
    assert name == 'tenant-a' and meta['rank'] == 4
    eng = TorchEngine('tiny', cfg=_tcfg(), params=params, device='cpu',
                      lora_pages=1, lora_max_rank=4, base_digest=digest,
                      **KW)
    try:
        assert tregistry.load_registry_into(
            eng, str(tmp_path / 'from-jax')) == ['tenant-a']
        assert eng.generate_ids(PROMPT, max_new_tokens=8,
                                adapter='tenant-a') == ref.generate_ids(
            PROMPT, max_new_tokens=8, adapter='tenant-a', timeout=120)
    finally:
        eng.shutdown()


def test_checkpoint_digest_equals_reference(tmp_path):
    """A checkpoint directory's digest is the reference's, with a
    committed manifest (its canonical payload) and without one (the
    weight and config files hashed)."""
    from skypilot_tpu.data import ckpt_manifest as jmanifest
    from skypilot_tpu_torch.data import ckpt_manifest as tmanifest
    root = tmp_path / 'ckpt'
    root.mkdir()
    (root / 'config.json').write_text('{"d_model": 64}')
    (root / 'model.safetensors').write_bytes(bytes(range(256)) * 4)
    (root / 'notes.txt').write_text('ignored without a manifest')
    plain = tregistry.checkpoint_digest(str(root))
    assert plain == jregistry.checkpoint_digest(str(root))
    tmanifest.write(str(root), tmanifest.build(str(root), step=3))
    assert jmanifest.read(str(root)) == tmanifest.read(str(root))
    committed = tregistry.checkpoint_digest(str(root))
    assert committed == jregistry.checkpoint_digest(str(root))
    assert committed != plain
