"""The port's speculative decoding against the JAX reference.

Draft proposers are held to the reference's on its own cases and on
seeded random histories; ``ModelDraft`` to the reference's on the same
(converted) weights. Engines serve TINY at fp32 compute with the JAX
engine's weights, ``block_size`` 8 and ``prefill_chunk`` 8: greedy
speculative tokens equal the JAX plain engine's token for token, the
speculative stream at temperature 0.8 equals the port's plain stream,
an eos inside an accepted window stops the stream where the plain
engine stops, a repeated query accepts its answer from the completion
corpus, and after the traffic drains the block pool and prefix cache
are exactly a plain run's. Tolerance: none (token ids are compared
exactly).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.inference import speculative as jspec
from skypilot_tpu.inference.continuous import (
    ContinuousBatchingEngine as JaxEngine)
from skypilot_tpu.models import llama as jllama
from skypilot_tpu.models.config import get_model_config as jax_config
from skypilot_tpu.utils import env_registry
from skypilot_tpu_torch.inference import server as tserver
from skypilot_tpu_torch.inference import speculative as tspec
from skypilot_tpu_torch.inference.continuous import (
    ContinuousBatchingEngine as TorchEngine)
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models.config import get_model_config as torch_config
from skypilot_tpu_torch.utils import env
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

KW = dict(max_slots=2, max_len=96, block_size=8, prefill_chunk=8)

PROMPTS = [
    [5, 6, 7, 8, 5, 6, 7, 8, 5, 6, 7],       # periodic: drafts fire
    [(7 * i + 3) % 512 for i in range(21)],   # arbitrary: drafts miss
    [9, 9, 9, 9, 9, 9],                       # constant
]


def _tcfg():
    return torch_config('tiny', compute_dtype=torch.float32)


# ---------------------------------------------------------------------------
# Draft proposers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('cls', [jspec.NGramDraft, tspec.NGramDraft],
                         ids=['reference', 'port'])
def test_ngram_draft_prompt_lookup(cls):
    d = cls(max_ngram=3)
    assert d.propose([1, 5, 6, 9, 2, 5, 6], 3) == [9, 2, 5]
    hist = [7, 8, 9, 1, 2, 9, 4, 7, 8, 9]
    assert d.propose(hist, 2) == [1, 2]
    assert d.propose([1, 2, 3, 4, 5], 4) == []
    assert d.propose([1], 4) == []
    assert d.propose([1, 2, 3], 0) == []


def test_ngram_draft_most_recent_occurrence_wins():
    d = tspec.NGramDraft(max_ngram=2)
    assert d.propose([3, 4, 7, 1, 3, 4, 8, 2, 3, 4], 1) == [8]


def test_ngram_draft_corpus_retrieval():
    d = tspec.NGramDraft(max_ngram=3, corpus_entries=1024)
    assert d.propose([10, 11, 12], 4) == []
    d.observe([10, 11, 12, 13, 14, 15, 16])
    assert d.propose([99, 10, 11, 12], 4) == [13, 14, 15, 16]
    # At equal order the slot's own history wins...
    assert d.propose([11, 12, 13, 55, 10, 11, 12, 13], 2) == [55, 10]
    # ...but a corpus trigram outranks low-order history backoff.
    assert d.propose([13, 55, 10, 11, 12, 13], 2) == [14, 15]
    d2 = tspec.NGramDraft(max_ngram=3)
    d2.observe([10, 11, 12, 13, 14])
    assert d2.propose([10, 11, 12], 2) == []


def test_ngram_draft_validates_bounds():
    with pytest.raises(ValueError, match='min_ngram'):
        tspec.NGramDraft(max_ngram=0)
    with pytest.raises(ValueError, match='min_ngram'):
        tspec.NGramDraft(max_ngram=2, min_ngram=3)


@pytest.mark.parametrize('seed', range(4))
def test_ngram_draft_equals_reference_on_random_histories(seed):
    """Seeded histories over a small vocabulary (so n-grams recur),
    with a corpus small enough to be cleared along the way."""
    rng = np.random.RandomState(seed)
    kwargs = dict(max_ngram=int(rng.randint(1, 5)), corpus_entries=64)
    ref, port = jspec.NGramDraft(**kwargs), tspec.NGramDraft(**kwargs)
    for _ in range(60):
        hist = rng.randint(0, 6, size=rng.randint(0, 40)).tolist()
        k = int(rng.randint(0, 6))
        assert port.propose(hist, k) == ref.propose(hist, k), (hist, k)
        if rng.rand() < 0.3:
            done = rng.randint(0, 6, size=rng.randint(0, 30)).tolist()
            ref.observe(done)
            port.observe(done)


def test_model_draft_equals_reference():
    jcfg = jax_config('tiny', compute_dtype=jnp.float32)
    jparams = jllama.init_params(jax.random.key(0), jcfg)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        _tcfg(), device='cpu')
    ref = jspec.ModelDraft(jparams, jcfg, context_tokens=16)
    port = tspec.ModelDraft(tparams, _tcfg(), context_tokens=16)
    for hist in ([(3 * i + 2) % 512 for i in range(10)],
                 [(11 * i + 5) % 512 for i in range(30)]):
        out = port.propose(hist, 4)
        assert len(out) == 4 and all(isinstance(t, int) for t in out)
        assert out == ref.propose(hist, 4)
    assert port.propose([], 4) == [] and port.propose([1, 2], 0) == []


# ---------------------------------------------------------------------------
# Engines
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def engines():
    ref = JaxEngine('tiny', cfg=jax_config('tiny', compute_dtype=jnp.float32),
                    **KW)
    params = convert.params_from_numpy(
        jax.tree.map(np.asarray, ref.params), _tcfg(), device='cpu')
    plain = TorchEngine('tiny', cfg=_tcfg(), params=params, device='cpu',
                        **KW)
    spec = TorchEngine('tiny', cfg=_tcfg(), params=params, device='cpu',
                       spec_decode=True, draft_k=4, **KW)
    yield ref, plain, spec, params
    for eng in (ref, plain, spec):
        eng.shutdown()


def test_spec_greedy_equals_jax_plain_engine(engines):
    ref, plain, spec, _ = engines
    before = spec.stats()
    for ids in PROMPTS:
        want = ref.generate_ids(ids, max_new_tokens=24, timeout=120)
        assert spec.generate_ids(ids, max_new_tokens=24) == want, ids
        assert plain.generate_ids(ids, max_new_tokens=24) == want, ids
    after = spec.stats()
    drafted = after['draft_tokens'] - before['draft_tokens']
    accepted = after['accepted_tokens'] - before['accepted_tokens']
    # Drafts were proposed and some rejected mid-stream, so the equality
    # covers the rollback path, not only accepts.
    assert drafted > 0 and accepted < drafted
    assert after['verify_steps'] > before['verify_steps']
    assert after['spec_window'] == 5
    assert after['decode_steps'] == 0   # every step was a verify step


def test_spec_temperature_stream_equals_plain_stream(engines):
    """Sampling is a function of (seed, position): at temperature 0.8
    the speculative stream reproduces the plain stream."""
    _, plain, spec, _ = engines
    for ids in PROMPTS:
        a = plain.generate_ids(ids, max_new_tokens=16, temperature=0.8,
                               seed=3)
        b = spec.generate_ids(ids, max_new_tokens=16, temperature=0.8,
                              seed=3)
        assert a == b, ids


def test_spec_eos_inside_accepted_window(engines):
    _, plain, spec, _ = engines
    ids = [31, 41, 59, 26, 5]
    full = plain.generate_ids(ids, max_new_tokens=20)
    eos = full[10]  # stop mid-stream
    want = plain.generate_ids(ids, max_new_tokens=20, eos_id=eos)
    # Warm the corpus so the window actually accepts past the eos.
    spec.generate_ids(ids, max_new_tokens=20)
    handle = spec.submit_ids(ids, max_new_tokens=20, eos_id=eos)
    assert handle.done.wait(120) and handle.error is None
    assert handle.generated[:-1] == want and handle.generated[-1] == eos
    assert spec.generate_ids(ids, max_new_tokens=20, eos_id=eos) == want


def test_spec_repeated_queries_accept_from_corpus(engines):
    _, _, spec, _ = engines
    ids = [(11 * i + 4) % 512 for i in range(12)]
    before = spec.stats()
    first = spec.generate_ids(ids, max_new_tokens=24)
    mid = spec.stats()
    second = spec.generate_ids(ids, max_new_tokens=24)
    after = spec.stats()
    assert first == second
    cold = mid['verify_steps'] - before['verify_steps']
    warm = after['verify_steps'] - mid['verify_steps']
    warm_accept = after['accepted_tokens'] - mid['accepted_tokens']
    assert warm < cold
    assert warm_accept >= 24 - warm


def test_spec_rollback_leaves_pool_and_prefix_as_plain_run(engines):
    """Fresh engines (the comparison needs identical histories): after
    the same traffic, block refcounts and prefix entries are a plain
    run's exactly."""
    _, _, _, params = engines
    plain = TorchEngine('tiny', cfg=_tcfg(), params=params, device='cpu',
                        **KW)
    spec = TorchEngine('tiny', cfg=_tcfg(), params=params, device='cpu',
                       spec_decode=True, draft_k=4, **KW)
    try:
        for eng in (plain, spec):
            for ids in PROMPTS:
                eng.generate_ids(ids, max_new_tokens=12)
        ps, ss = plain.stats(), spec.stats()
        for key in ('blocks_free', 'blocks_cached', 'block_occupancy'):
            assert ss[key] == ps[key], key
        for eng in (plain, spec):
            held = [b for b in range(1, eng.num_blocks)
                    if eng._pool.refcount(b) > 0]
            assert len(held) == eng.stats()['blocks_cached']
            assert all(eng._pool.refcount(b) == 1 for b in held)
        assert ([eng._pool.refcount(b) for b in range(spec.num_blocks)] ==
                [plain._pool.refcount(b) for b in range(plain.num_blocks)])
    finally:
        plain.shutdown()
        spec.shutdown()


def test_spec_window_one_when_draft_k_is_zero(engines):
    """``spec_decode=True`` with ``draft_k=0`` runs window 1, as the
    reference does: no draft, plain steps."""
    _, _, _, params = engines
    eng = TorchEngine('tiny', cfg=_tcfg(), params=params, device='cpu',
                      spec_decode=True, draft_k=0, **KW)
    try:
        assert not eng.spec_decode and eng.stats()['spec_window'] == 1
    finally:
        eng.shutdown()


def test_env_knobs_match_the_reference_registry(monkeypatch):
    for name, (kind, default) in env.DECLARATIONS.items():
        var = env_registry.REGISTRY[name]
        assert (var.type, var.default) == (kind, default), name
    monkeypatch.setenv('SKYT_SPEC_DRAFT_K', 'x')
    assert env.get_int('SKYT_SPEC_DRAFT_K') == 4   # unparsable: default
    for raw, want in (('0', False), ('off', False), ('1', True),
                      ('yes', True)):
        monkeypatch.setenv('SKYT_SPEC_DECODE', raw)
        assert env.get_bool('SKYT_SPEC_DECODE') is want
    with pytest.raises(KeyError):
        env.get_int('SKYT_NOT_A_KNOB')


def test_spec_env_knobs_and_stats_keys(engines, monkeypatch):
    """SKYT_SPEC_DECODE / SKYT_SPEC_DRAFT_K drive the default, and
    ``/metrics`` carries the speculative counters and the window gauge."""
    _, _, _, params = engines
    monkeypatch.setenv('SKYT_SPEC_DECODE', '1')
    monkeypatch.setenv('SKYT_SPEC_DRAFT_K', '2')
    eng = TorchEngine('tiny', cfg=_tcfg(), params=params, device='cpu',
                      max_slots=2, max_len=64, block_size=8,
                      prefill_chunk=8)
    try:
        assert eng.spec_decode and eng.stats()['spec_window'] == 3
        eng.generate_ids([4, 5, 6, 4, 5, 6, 4, 5], max_new_tokens=8)
        stats = eng.stats()
        assert stats['verify_steps'] > 0
        assert stats['draft_tokens'] >= stats['accepted_tokens'] > 0
        text = tserver.metrics_text(stats)
        for name in ('draft_tokens', 'accepted_tokens', 'verify_steps'):
            assert (f'# TYPE skyt_inference_{name}_total counter'
                    in text), name
        assert '# TYPE skyt_inference_spec_window gauge' in text
    finally:
        eng.shutdown()


def test_spec_disabled_by_default(engines, monkeypatch):
    _, _, _, params = engines
    monkeypatch.delenv('SKYT_SPEC_DECODE', raising=False)
    eng = TorchEngine('tiny', cfg=_tcfg(), params=params, device='cpu',
                      max_slots=2, max_len=64)
    try:
        assert not eng.spec_decode
        eng.generate_ids([1, 2, 3], max_new_tokens=3)
        assert eng.stats()['verify_steps'] == 0
        assert eng.stats()['spec_window'] == 1
    finally:
        eng.shutdown()
