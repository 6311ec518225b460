"""The port's disaggregated prefill/decode engine roles against the
reference.

Every case of ``tests/test_disagg_engine.py`` runs on the port's engines
(TINY at fp32 compute on the CPU, the JAX engine's weights converted by
``models/convert.py``): a stream decoded from migrated KV is token for
token the colocated engine's, greedy and at temperature 0.9, because
the export carries the fp32 last-logits row and sampling is a function
of (seed, position); any import problem (an evicted delta block, a
tampered manifest) falls back to a local re-prefill that completes the
request with the pool and the prefix cache refcount-exact.

Across packages: a JAX prefill-role engine's export, imported by the
port's decode-role engine, gives the JAX colocated engine's greedy
tokens, and the port's export imported by a JAX decode-role engine
does too. Under pool pressure a migrated request is preempted,
re-prefills, and ends with an unpressured run's tokens, every block free
at the end. Tolerance: none (token ids are compared exactly).
"""
import copy
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.inference import kv_migrate as jkv
from skypilot_tpu.inference.continuous import (
    ContinuousBatchingEngine as JaxEngine)
from skypilot_tpu.models.config import get_model_config as jax_config
from skypilot_tpu.server import metrics as jmetrics
from skypilot_tpu_torch.inference import kv_migrate
from skypilot_tpu_torch.inference.continuous import (
    ContinuousBatchingEngine as TorchEngine)
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models.config import get_model_config as torch_config
from skypilot_tpu_torch.server import metrics
from torch_threads import few_torch_threads  # noqa: F401 (autouse)


@pytest.fixture(autouse=True, scope='module')
def _fresh_metrics():
    """Both packages' in-process migration metrics end the module empty,
    as they were before it."""
    metrics.reset_for_tests()
    jmetrics.reset_for_tests()
    yield
    metrics.reset_for_tests()
    jmetrics.reset_for_tests()


# 18 tokens at block_size 16: one full (shareable) block + a partial tail.
PROMPT = [5, 9, 42, 7, 11, 3, 2, 8, 19, 21, 4, 6, 13, 17, 23, 29, 31, 1]
KW = dict(max_slots=2, max_len=96)


def _shifted(offset):
    """PROMPT moved by ``offset`` inside TINY's 512-token vocabulary: a
    prompt no other case sends."""
    return [(p + offset) % 512 for p in PROMPT]


def _tcfg():
    return torch_config('tiny', compute_dtype=torch.float32)


def _jcfg():
    return jax_config('tiny', compute_dtype=jnp.float32)


@pytest.fixture(scope='module')
def fleets():
    """A prefill-role, a decode-role and a colocated port engine on the
    JAX colocated engine's weights, and that JAX engine."""
    jcolo = JaxEngine('tiny', cfg=_jcfg(), **KW)
    engines = [jcolo]
    try:
        params = convert.params_from_numpy(
            jax.tree.map(np.asarray, jcolo.params), _tcfg(), device='cpu')
        for role in ('prefill', 'decode', ''):
            engines.append(TorchEngine('tiny', cfg=_tcfg(), params=params,
                                       device='cpu', role=role, **KW))
        yield engines[1], engines[2], engines[3], jcolo, params
    finally:
        for engine in engines:
            engine.shutdown()


def _migrate(pre, dec, ids, *, seed=0, temperature=0.0,
             max_new_tokens=8, mutate=None, tamper=None):
    """The full path: prefill + export -> delta pull -> decode."""
    rid = pre.prefill_and_export(ids, seed=seed, temperature=temperature)
    puller = kv_migrate.KvPuller(
        kv_migrate.LocalKvSource(pre.exporter, mutate=mutate),
        sleep=lambda _s: None)
    pulled = puller.pull(rid, resident_digests=dec.probe_resident(ids))
    if tamper is not None:
        tamper(pulled)
    request = dec.submit_migrated(ids, pulled, seed=seed,
                                  temperature=temperature,
                                  max_new_tokens=max_new_tokens)
    tokens = list(dec.tail_tokens(request))
    return tokens, pulled, rid


def _quiesce_free_blocks(engine):
    """Pool free count once the prefix cache releases every entry it
    alone holds (the engine is idle; reclaimable == all of them)."""
    while engine._prefix.evict_reclaimable():
        pass
    return engine._pool.free_blocks


def test_migrated_stream_matches_colocated_greedy(fleets):
    pre, dec, colo, jcolo, _ = fleets
    tokens, _pulled, _rid = _migrate(pre, dec, PROMPT, seed=0)
    assert tokens == colo.generate_ids(PROMPT, max_new_tokens=8, seed=0)
    assert tokens == jcolo.generate_ids(PROMPT, max_new_tokens=8, seed=0)
    assert dec.stats()['kv_import_fallbacks'] == 0
    assert pre.stats()['kv_exports'] >= 1
    # The prefill fleet never decoded a token, the decode fleet never
    # prefilled this prompt.
    assert pre.stats()['tokens_generated'] == 0
    assert dec.stats()['prefill_chunks'] == 0


def test_migrated_stream_matches_colocated_temperature(fleets):
    pre, dec, colo, _, _ = fleets
    tokens, _pulled, _rid = _migrate(pre, dec, PROMPT, seed=7,
                                     temperature=0.9)
    assert tokens == colo.generate_ids(PROMPT, max_new_tokens=8,
                                       temperature=0.9, seed=7)


def test_shared_prefix_moves_only_non_resident_blocks(fleets):
    """A second migration of a prompt sharing the full-block prefix
    moves no full block: the decode side's prefix cache holds it and the
    delta manifest says so."""
    pre, dec, colo, _, _ = fleets
    _tokens, first, _rid = _migrate(pre, dec, PROMPT, seed=0)
    assert first.moved + first.resident == len(PROMPT) // dec.block_size
    tokens, second, _rid = _migrate(pre, dec, PROMPT, seed=3)
    assert second.moved == 0
    assert second.resident == len(PROMPT) // dec.block_size
    assert tokens == colo.generate_ids(PROMPT, max_new_tokens=8, seed=3)


def test_prefill_death_post_handoff_still_completes(fleets):
    """Once the pull lands, the decode side holds everything locally:
    dropping the export (the prefill replica dying) changes nothing."""
    pre, dec, colo, _, _ = fleets
    prompt = _shifted(200)
    rid = pre.prefill_and_export(prompt, seed=1)
    puller = kv_migrate.KvPuller(kv_migrate.LocalKvSource(pre.exporter),
                                 sleep=lambda _s: None)
    pulled = puller.pull(rid,
                         resident_digests=dec.probe_resident(prompt))
    pre.exporter.pop(rid)  # the prefill replica is gone
    request = dec.submit_migrated(prompt, pulled, seed=1,
                                  max_new_tokens=8)
    tokens = list(dec.tail_tokens(request))
    assert tokens == colo.generate_ids(prompt, max_new_tokens=8, seed=1)
    assert dec.stats()['kv_import_fallbacks'] == 0


def test_decode_death_mid_migration_pull_raises_for_reroute():
    """A source gone mid-pull surfaces as MigrationUnavailable to the
    caller (which re-routes or re-prefills), never as a half-imported
    slot."""
    exporter = kv_migrate.KvExporter()  # empty: the peer is gone
    puller = kv_migrate.KvPuller(kv_migrate.LocalKvSource(exporter),
                                 retries=1, sleep=lambda _s: None)
    with pytest.raises(kv_migrate.MigrationUnavailable):
        puller.pull('dead')


def test_bad_import_falls_back_to_reprefill_zero_leaks(fleets):
    """Evicted-delta-block race (payload None for a non-resident block):
    the import aborts refcount-exactly and the request completes by a
    local re-prefill with the same tokens."""
    pre, dec, colo, _, _ = fleets
    prompt = _shifted(400)
    fallbacks0 = dec.stats()['kv_import_fallbacks']

    def drop_block(pulled):
        assert pulled.moved >= 1
        pulled.payloads[0] = None  # claims resident; the cache disagrees

    tokens, _pulled, _rid = _migrate(pre, dec, prompt, seed=2,
                                     tamper=drop_block)
    assert tokens == colo.generate_ids(prompt, max_new_tokens=8, seed=2)
    assert dec.stats()['kv_import_fallbacks'] == fallbacks0 + 1
    # No refcount leaks: with the engine idle, evicting every
    # reclaimable prefix entry returns the whole pool to the free list.
    assert _quiesce_free_blocks(dec) == dec._pool.total_blocks


def test_tampered_manifest_falls_back_to_reprefill(fleets):
    pre, dec, colo, _, _ = fleets
    prompt = _shifted(600)
    fallbacks0 = dec.stats()['kv_import_fallbacks']

    def tamper(pulled):
        pulled.manifest = copy.deepcopy(pulled.manifest)
        pulled.manifest['n_tokens'] += 1

    tokens, _pulled, _rid = _migrate(pre, dec, prompt, seed=4,
                                     tamper=tamper)
    assert tokens == colo.generate_ids(prompt, max_new_tokens=8, seed=4)
    assert dec.stats()['kv_import_fallbacks'] == fallbacks0 + 1
    assert _quiesce_free_blocks(dec) == dec._pool.total_blocks


def test_handoff_metric_observed_on_import(fleets):
    pre, dec, _, _, _ = fleets
    prompt = _shifted(800)
    metrics.reset_for_tests()
    rid = pre.prefill_and_export(prompt, seed=5)
    handoff_start = time.monotonic()
    puller = kv_migrate.KvPuller(kv_migrate.LocalKvSource(pre.exporter),
                                 sleep=lambda _s: None)
    pulled = puller.pull(rid,
                         resident_digests=dec.probe_resident(prompt))
    request = dec.submit_migrated(prompt, pulled, seed=5,
                                  max_new_tokens=4,
                                  handoff_start=handoff_start)
    list(dec.tail_tokens(request))
    assert metrics.DISAGG_HANDOFF.count() == 1
    assert 0.0 <= metrics.DISAGG_HANDOFF.samples()[0] < 60.0


def test_speculative_decode_engine_imports_to_plain_tokens(fleets):
    """A speculative decode-role engine seeds its pending token from the
    migrated logits row: greedy and at temperature 0.9 it streams the
    plain colocated engine's tokens, all of them from verify steps."""
    pre, _dec, colo, _, params = fleets
    spec = TorchEngine('tiny', cfg=_tcfg(), params=params, device='cpu',
                       role='decode', spec_decode=True, draft_k=3, **KW)
    try:
        for offset, temperature in ((1700, 0.0), (1900, 0.9)):
            prompt = _shifted(offset) * 2
            tokens, _pulled, _rid = _migrate(pre, spec, prompt, seed=8,
                                             temperature=temperature,
                                             max_new_tokens=12)
            assert tokens == colo.generate_ids(prompt, max_new_tokens=12,
                                               seed=8,
                                               temperature=temperature)
        stats = spec.stats()
        assert stats['kv_imports'] == 2 and stats['prefill_chunks'] == 0
        assert stats['verify_steps'] > 0 and stats['decode_steps'] == 0
    finally:
        spec.shutdown()


def test_role_validation(fleets, monkeypatch):
    pre, dec, _, _, _ = fleets
    with pytest.raises(ValueError, match='SKYT_DISAGG_ROLE'):
        TorchEngine('tiny', device='cpu', max_slots=1, max_len=32,
                    role='both')
    monkeypatch.setenv('SKYT_DISAGG_ROLE', 'bogus')
    with pytest.raises(ValueError, match='SKYT_DISAGG_ROLE'):
        TorchEngine('tiny', device='cpu', max_slots=1, max_len=32)
    with pytest.raises(RuntimeError, match='prefill'):
        dec.prefill_and_export(PROMPT)
    with pytest.raises(RuntimeError, match='never decodes'):
        pre.submit_migrated(PROMPT, None)
    with pytest.raises(RuntimeError, match='never decodes'):
        pre.generate_ids(PROMPT, max_new_tokens=2)
    assert pre.role == 'prefill' and dec.role == 'decode'
    assert dec.exporter is None and pre.stats()['kv_imports'] == 0


def test_role_from_env(monkeypatch):
    monkeypatch.setenv('SKYT_DISAGG_ROLE', 'prefill')
    engine = TorchEngine('tiny', device='cpu', max_slots=1, max_len=32)
    try:
        assert engine.role == 'prefill' and engine.exporter is not None
    finally:
        engine.shutdown()


def test_prefill_role_slot_releases_immediately(fleets):
    """The export holds host copies: once prefill_and_export returns,
    the prefill pool is free again (but for reclaimable prefix entries),
    so the slot turns over at the prefill rate."""
    pre, _dec, _colo, _, _ = fleets
    prompt = _shifted(1000)
    rid = pre.prefill_and_export(prompt, seed=6)
    assert pre.stats()['active'] == 0
    assert pre.stats()['kv_exports_pending'] >= 1
    assert _quiesce_free_blocks(pre) == pre._pool.total_blocks
    assert pre.exporter.pop(rid) is not None


# -- across packages -----------------------------------------------------


@pytest.fixture(scope='module')
def jax_roles(fleets):
    engines = [JaxEngine('tiny', cfg=_jcfg(), role=role, **KW)
               for role in ('prefill', 'decode')]
    try:
        yield engines
    finally:
        for engine in engines:
            engine.shutdown()


def test_jax_export_imported_by_port_decode_engine(fleets, jax_roles):
    """The JAX prefill-role engine's payloads, pulled by the port's
    puller and imported by the port's decode engine, give the JAX
    colocated engine's greedy tokens."""
    _pre, dec, _colo, jcolo, _ = fleets
    jpre, _jdec = jax_roles
    fallbacks0 = dec.stats()['kv_import_fallbacks']
    for prompt in (_shifted(1200),
                   [(7 * i + 3) % 512 for i in range(37)]):
        rid = jpre.prefill_and_export(prompt, seed=0)
        pulled = kv_migrate.KvPuller(
            jkv.LocalKvSource(jpre.exporter), sleep=lambda _s: None).pull(
                rid, resident_digests=dec.probe_resident(prompt))
        assert pulled.moved == len(prompt) // dec.block_size
        imports0 = dec.stats()['kv_imports']
        request = dec.submit_migrated(prompt, pulled, max_new_tokens=10)
        tokens = list(dec.tail_tokens(request))
        assert tokens == jcolo.generate_ids(prompt, max_new_tokens=10)
        assert dec.stats()['kv_imports'] == imports0 + 1
    assert dec.stats()['kv_import_fallbacks'] == fallbacks0


def test_port_export_imported_by_jax_decode_engine(fleets, jax_roles):
    """The reverse: the port's prefill-role export, pulled by the
    reference's puller and imported by the JAX decode engine."""
    pre, _dec, _colo, jcolo, _ = fleets
    _jpre, jdec = jax_roles
    for prompt in (_shifted(1400),
                   [(5 * i + 11) % 512 for i in range(41)]):
        rid = pre.prefill_and_export(prompt, seed=0)
        pulled = jkv.KvPuller(
            kv_migrate.LocalKvSource(pre.exporter),
            sleep=lambda _s: None).pull(
                rid, resident_digests=jdec.probe_resident(prompt))
        request = jdec.submit_migrated(prompt, pulled, max_new_tokens=10)
        tokens = list(jdec.tail_tokens(request))
        assert tokens == jcolo.generate_ids(prompt, max_new_tokens=10)
        pre.exporter.pop(rid)
    stats = jdec.stats()
    assert stats['kv_imports'] == 2 and stats['kv_import_fallbacks'] == 0


# -- preemption of a migrated request --------------------------------------


def test_migrated_request_preempted_reprefills_to_unpressured_tokens(
        fleets):
    """A decode engine whose 7-block pool cannot hold two long streams: a
    plain 18-token request and a migrated 34-token one, submitted in
    that order, decode until the pool runs dry; the plain request asks
    for a block first and preempts the migrated (newest) one, which
    re-prefills (its migration already consumed) and ends with the
    tokens an unpressured run gives; every block is free at the end."""
    pre, _dec, colo, _, params = fleets
    tight = TorchEngine('tiny', cfg=_tcfg(), params=params, device='cpu',
                        role='decode', num_blocks=8, **KW)
    victims = []
    preempt = tight._preempt

    def record(slot, active_mask):
        victims.append(tight._slots[slot])
        preempt(slot, active_mask)

    tight._preempt = record
    try:
        first = _shifted(1600)
        second = [(13 * i + 7) % 512 for i in range(34)]
        want_first = colo.generate_ids(first, max_new_tokens=40, seed=1)
        want_second = colo.generate_ids(second, max_new_tokens=40, seed=2)
        rid = pre.prefill_and_export(second, seed=2)
        pulled = kv_migrate.KvPuller(
            kv_migrate.LocalKvSource(pre.exporter),
            sleep=lambda _s: None).pull(
                rid, resident_digests=tight.probe_resident(second))
        pre.exporter.pop(rid)
        plain = tight.submit_ids(first, max_new_tokens=40, seed=1)
        migrated = tight.submit_migrated(second, pulled, max_new_tokens=40,
                                         seed=2)
        for handle in (plain, migrated):
            assert handle.done.wait(120) and handle.error is None
        stats = tight.stats()
        assert stats['kv_imports'] == 1 and stats['kv_import_fallbacks'] == 0
        assert stats['preemptions'] >= 1 and migrated in victims
        assert migrated.migration is None
        assert plain.generated == want_first
        assert migrated.generated == want_second
        assert _quiesce_free_blocks(tight) == tight._pool.total_blocks
    finally:
        del tight._preempt
        tight.shutdown()
