"""Multi-LoRA adapter pages under tensor parallelism: the port against
the JAX reference.

The JAX engines run in this process on the 8 virtual CPU devices of
``tests/conftest.py`` (``mesh='tensor=2'``); the port's tensor=2 engines
run as two ``gloo`` ranks (``tests/torch_tp_ranks.lora_cases``), its
one-rank engine in this process. TINY with 4 query and 2 kv heads at
fp32 compute, 2 adapter pages of max rank 4 and three registered
adapters of ranks 4, 2 and 4 whose B is non-zero (the reference's
adapters, carried over by ``convert.lora_from_numpy``), so one is
evicted. Requests go in waves that share a batch (``LORA_WAVES``).

Held: the port's greedy tokens equal the JAX tensor=2 engine's exactly,
for the fp and the int8 pool, and its ``lora_*`` counters equal the JAX
engine's; each rank's B pages are, bitwise, its head block of the
one-rank port's pages and its A pages equal them whole; both ranks make
the same step calls, and an all-base batch passes no adapter pages to
any of them; speculative windows and a decode role give the plain
tokens of the same adapter requests; the charge of an adapter in KV
blocks counts every kv head of the mesh.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_tp_ranks as ranks
from skypilot_tpu.inference.continuous import (ContinuousBatchingEngine as
                                               JaxContinuous)
from skypilot_tpu.models import llama as jllama
from skypilot_tpu.models import lora as jlora
from skypilot_tpu.models.config import get_model_config as jax_config
from skypilot_tpu_torch.inference.continuous import (
    ContinuousBatchingEngine as TorchContinuous)
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models import lora as tlora
from skypilot_tpu_torch.parallel.launch import launch
from torch_threads import few_torch_threads  # noqa: F401 (autouse)
from torch_tp_ranks import one_thread_ranks  # noqa: F401 (autouse)

N_NEW = 6
KW = dict(max_slots=2, max_len=64, block_size=8, prefill_chunk=8)
POOLS = list(ranks.DISAGG_POOLS)


def _jax_cfg():
    return jax_config('tiny', n_heads=4, n_kv_heads=2,
                      compute_dtype=jnp.float32)


def _adapter(rank, seed):
    """A reference adapter with B filled (as
    ``tests/test_lora_serving.py:_make_lora`` makes them), as numpy."""
    lora = jlora.init_lora_params(jax.random.key(seed), _jax_cfg(), rank)
    kq, kv = jax.random.split(jax.random.key(seed + 1000))
    lora['wq_b'] = 0.05 * jax.random.normal(kq, lora['wq_b'].shape)
    lora['wv_b'] = 0.05 * jax.random.normal(kv, lora['wv_b'].shape)
    return {k: np.asarray(v) for k, v in lora.items()}


@pytest.fixture(scope='module')
def jax_side():
    """The JAX tensor=2 LoRA engine's tokens and counters by pool, with
    the weights and the adapters as numpy."""
    params = jax.tree.map(np.asarray, jllama.init_params(jax.random.key(0),
                                                         _jax_cfg()))
    adapters = {name: _adapter(rank, seed) for seed, (name, rank) in
                enumerate(ranks.ADAPTER_RANKS.items(), start=1)}
    out = {'params': params, 'adapters': adapters}
    for pool, options in ranks.DISAGG_POOLS.items():
        engine = JaxContinuous(cfg=_jax_cfg(), seed=0, mesh='tensor=2',
                               **ranks.LORA_KW, **KW, **options)
        try:
            for name, lora in adapters.items():
                engine.register_adapter(name, lora)
            tokens = ranks.run_waves(engine, ranks.LORA_WAVES, N_NEW)
            stats = engine.stats()
            out[pool] = {
                'tokens': tokens,
                'counters': {k: stats[k] for k in ranks.LORA_COUNTERS},
                'base_tokens': ranks.run_waves(engine, [ranks.BASE_WAVE],
                                               N_NEW)[0]}
        finally:
            engine.shutdown()
    return out


@pytest.fixture(scope='module')
def runs(jax_side):
    """Every tensor=2 case in one launch, then the one-rank port engine
    on the fp pool (this process)."""
    tp = launch(ranks.lora_cases, 2, jax_side['params'],
                jax_side['adapters'], N_NEW, device='cpu', timeout=300)
    cfg = ranks.tiny_config()
    engine = TorchContinuous(
        cfg=cfg, params=convert.params_from_numpy(jax_side['params'], cfg,
                                                  device='cpu'),
        device='cpu', **ranks.LORA_KW, **KW)
    try:
        for name, lora in jax_side['adapters'].items():
            engine.register_adapter(name, convert.lora_from_numpy(
                lora, cfg, device='cpu'))
        one = {'tokens': ranks.run_waves(engine, ranks.LORA_WAVES, N_NEW),
               'pages': {n: engine._adapter_pool.page_of(n)  # pylint: disable=protected-access
                         for n in jax_side['adapters']},
               'store': {k: v.numpy() for k, v in
                         engine._lora_store.items()}}  # pylint: disable=protected-access
    finally:
        engine.shutdown()
    return {'tp': tp, 'one': one}


def _wave_answer(tokens, adapter, prompt):
    """The waves' answer to (adapter, prompt index)."""
    for wave, got in zip(ranks.LORA_WAVES, tokens):
        for request, answer in zip(wave, got):
            if request == (adapter, prompt):
                return answer
    raise KeyError((adapter, prompt))


@pytest.mark.parametrize('pool', POOLS)
def test_tp_lora_tokens_match_jax_tp_engine(runs, jax_side, pool):
    """Adapter and base requests sharing batches, with an eviction:
    the JAX tensor=2 engine's greedy tokens exactly; the adapters move
    their requests off the base answers."""
    got = runs['tp'][0]['pools'][pool]
    assert got['tokens'] == jax_side[pool]['tokens']
    assert got['base_tokens'] == jax_side[pool]['base_tokens']
    base = dict(zip([i for _, i in ranks.BASE_WAVE], got['base_tokens']))
    assert _wave_answer(got['tokens'], 'a', 0) != base[0]
    assert _wave_answer(got['tokens'], 'c', 0) != base[0]


def test_one_rank_port_tokens_match_jax_tp_engine(runs, jax_side):
    assert runs['one']['tokens'] == jax_side['fp']['tokens']


@pytest.mark.parametrize('pool', POOLS)
def test_tp_lora_counters_match_jax_tp_engine(runs, jax_side, pool):
    """``lora_hits`` / ``_misses`` / ``_evictions`` / ``_blocks_charged``
    / ``_pages_resident`` equal the JAX engine's after the same waves:
    1 hit, 4 misses, 2 evictions, 2 resident adapters of rank 4 at 2
    blocks each (charged for every kv head of the mesh: 7168 bytes over
    4096-byte blocks)."""
    got = runs['tp'][0]['pools'][pool]['counters']
    assert got == jax_side[pool]['counters']
    if pool == 'fp':
        assert got == {'lora_hits': 1, 'lora_misses': 4,
                       'lora_evictions': 2, 'lora_blocks_charged': 4,
                       'lora_pages_resident': 2}
    stats = runs['tp'][0]['pools'][pool]['adapter_stats']
    assert sorted(n for n, s in stats.items() if s['resident']) == ['a', 'c']


def test_adapter_charge_counts_every_kv_head():
    """The block charge is the one-rank engine's: an adapter's bytes
    and a block's bytes both count the mesh's every kv head."""
    cfg = ranks.tiny_config()
    assert tlora.adapter_nbytes(cfg, 4) == 2 * (4 * (64 + 4 * 16) +
                                                4 * (64 + 2 * 16)) * 4
    assert tlora.adapter_nbytes(cfg, 4) == jlora.adapter_nbytes(_jax_cfg(),
                                                                 4)


def test_each_rank_holds_its_head_block_of_the_pages(runs):
    """Each rank's page of each resident adapter: B is bitwise its head
    block of the one-rank port's page (rank r: heads [r*n, (r+1)*n)),
    A and the scale equal it whole; page 0 stays zero."""
    one = runs['one']
    for r, out in enumerate(runs['tp']):
        store = out['pools']['fp']['store']
        pages = runs['tp'][0]['pools']['fp']['pages']
        for name in ('a', 'c'):
            p, q = pages[name], one['pages'][name]
            for key in ('wq_a', 'wv_a', 'scale'):
                np.testing.assert_array_equal(store[key][:, p],
                                              one['store'][key][:, q])
            for key in ('wq_b', 'wv_b'):
                n = store[key].shape[3]
                assert n * 2 == one['store'][key].shape[3]
                np.testing.assert_array_equal(
                    store[key][:, p],
                    one['store'][key][:, q, :, r * n:(r + 1) * n],
                    err_msg=f'rank {r} {name} {key}')
            assert store['wq_b'][:, p].any()
        for key, value in store.items():
            assert not value[:, 0].any(), key


@pytest.mark.parametrize('pool', POOLS)
def test_all_base_batches_pass_no_pages(runs, pool):
    """Both ranks make the same step calls in the same order; adapter
    batches pass the page store, and every step of the all-base wave
    passes ``lora_pages=None`` on every rank."""
    tp = runs['tp']
    steps = [r['pools'][pool]['steps'] for r in tp]
    assert steps[0] == steps[1]
    start = tp[0]['pools'][pool]['base_from']
    base = steps[0][start:]
    assert base and not any(lora for _, lora in base)
    # (a decode step is the Q=1 case of the verify step: both record)
    assert {'prefill_chunk', 'paged_decode_step'} <= {n for n, _ in base}
    assert sum(lora for _, lora in steps[0][:start]) > 0


def test_speculative_adapter_requests_give_plain_tokens(runs):
    tp = runs['tp'][0]
    plain = tp['pools']['fp']['tokens']
    want = [_wave_answer(plain, name, i) for name, i in ranks.SPEC_WAVE]
    assert tp['spec']['tokens'] == want
    # Windows of more than the pending row were verified (drafts were
    # proposed; whether the seeded model accepts them is not held).
    assert tp['spec']['stats']['verify_steps'] > 0
    assert tp['spec']['stats']['draft_tokens'] > 0


def test_decode_role_serves_adapter_requests(runs):
    """An adapter request on a tensor=2 decode-role engine (a local
    prefill: exports carry base KV) gives the colocated tokens."""
    tp = runs['tp'][0]
    plain = tp['pools']['fp']['tokens']
    want = [_wave_answer(plain, name, i) if name else None
            for name, i in ranks.DECODE_ROLE_WAVE]
    got = tp['decode_role']['tokens']
    assert got[0] == want[0]
    assert got[1] == tp['pools']['fp']['base_tokens'][1]
    assert tp['decode_role']['stats']['role'] == 'decode'
