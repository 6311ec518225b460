"""Live weight refresh under tensor parallelism: the port against the
JAX reference.

The JAX engines run in this process on the 8 virtual CPU devices of
``tests/conftest.py`` (``mesh='tensor=2'``); the port's tensor=2 engines
run as two ``gloo`` ranks (``tests/torch_tp_ranks.refresh_cases``), its
one-rank engines in this process. TINY with 4 query and 2 kv heads and
TINY_MOE, both at fp32 compute, on the JAX engines' seed-0 weights.

Held: after a whole-tree refresh, a delta of leaves under every shard
rule (heads, kv heads, the row-parallel ``wo``, MLP columns, the vocab
of the embedding and the head, a replicated norm scale) and a drain-mode
delta, the port's greedy tokens equal the JAX tensor=2 engine's, and so
do its version and refresh counters; each rank's leaves are bitwise its
slice of the one-rank port's refreshed leaves; an unknown path, a shard
where the whole leaf is due and a W8A8 leaf raise ``KeyError``,
``ValueError`` and ``TypeError`` with every rank's weights and the
version unchanged; a drain-mode refresh lands only after the request in
flight has finished on the old weights; TINY_MOE refreshes its expert
leaves (each expert's FFN columns sharded) to the JAX engine's tokens.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_tp_ranks as ranks
from skypilot_tpu.inference.continuous import (ContinuousBatchingEngine as
                                               JaxContinuous)
from skypilot_tpu.models import llama as jllama
from skypilot_tpu.models.config import get_model_config as jax_config
from skypilot_tpu_torch.inference import sharding
from skypilot_tpu_torch.inference.continuous import (
    ContinuousBatchingEngine as TorchContinuous)
from skypilot_tpu_torch.inference.continuous import flatten_param_paths
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.parallel.launch import launch
from torch_threads import few_torch_threads  # noqa: F401 (autouse)
from torch_tp_ranks import one_thread_ranks  # noqa: F401 (autouse)

N_NEW = 6
KW = dict(max_slots=2, max_len=64, block_size=8, prefill_chunk=8)
# One leaf under each shard rule of the dense model.
DELTA_PATHS = ('layers/attn/wq', 'layers/attn/wk', 'layers/attn/wo',
               'layers/mlp/wi_gate', 'layers/mlp/wi_up', 'layers/mlp/wo',
               'embed/embedding', 'lm_head/w', 'layers/ln_attn/scale')
DRAIN_PATHS = ('layers/attn/wv', 'final_norm/scale')
MOE_PATHS = ('layers/moe/wi_gate', 'layers/moe/wi_up', 'layers/moe/wo',
             'layers/moe/router')


def _jax_cfg(name='tiny'):
    if name == 'tiny':
        return jax_config('tiny', n_heads=4, n_kv_heads=2,
                          compute_dtype=jnp.float32)
    return jax_config(name, compute_dtype=jnp.float32)


def _init(seed, name='tiny'):
    return jax.tree.map(np.asarray, jllama.init_params(jax.random.key(seed),
                                                       _jax_cfg(name)))


def _delta(params, paths, seed):
    """New values of ``paths``: each leaf halved plus seeded noise of
    its own spread (fp32, the leaf's whole shape)."""
    rng = np.random.RandomState(seed)
    flat = flatten_param_paths(params)
    return {p: (0.5 * flat[p] + rng.normal(0, float(flat[p].std()) + 1e-3,
                                           flat[p].shape)
                ).astype(np.float32) for p in paths}


@pytest.fixture(scope='module')
def inputs():
    params = _init(0)
    flat = flatten_param_paths(params)
    other = -flat['final_norm/scale']
    wq = flat['layers/attn/wq']
    return {
        'params': params, 'new': _init(1),
        'delta': _delta(params, DELTA_PATHS, 2),
        'drain': _delta(params, DRAIN_PATHS, 3),
        # A valid leaf beside each fault: nothing of the update lands.
        'bad': [{'final_norm/scale': other, 'nope/leaf': other},
                {'final_norm/scale': other,
                 'layers/attn/wq': wq[:, :, :wq.shape[2] // 2]}],
        'w8a8_bad': {'final_norm/scale': other, 'layers/attn/wq': wq},
        'moe': _init(0, 'tiny-moe'),
        'moe_delta': _delta(_init(0, 'tiny-moe'), MOE_PATHS, 4)}


def _tokens(engine):
    return [engine.generate_ids(p, max_new_tokens=N_NEW)
            for p in ranks.PROMPTS]


@pytest.fixture(scope='module')
def jax_side(inputs):
    """The JAX tensor=2 engines' tokens after each refresh, and their
    counters."""
    engine = JaxContinuous(cfg=_jax_cfg(), seed=0, mesh='tensor=2', **KW)
    try:
        out = {'before': _tokens(engine)}
        engine.refresh_weights(params=inputs['new'])
        out['whole'] = _tokens(engine)
        engine.refresh_weights(inputs['delta'])
        out['delta'] = _tokens(engine)
        engine.refresh_weights(inputs['drain'], mode='drain')
        out['after_drain'] = _tokens(engine)
        stats = engine.stats()
        out['counters'] = {k: stats[k] for k in (
            'policy_version', 'weight_refreshes', 'refresh_shards')}
    finally:
        engine.shutdown()
    moe = JaxContinuous(cfg=_jax_cfg('tiny-moe'), seed=0, mesh='tensor=2',
                        **KW)
    try:
        moe.refresh_weights(inputs['moe_delta'])
        out['moe'] = _tokens(moe)
    finally:
        moe.shutdown()
    return out


def _one_rank(params_np, cfg, refreshes):
    """The one-rank port engine's leaves after ``refreshes`` (``(kwargs,
    mode)`` pairs), and its counters."""
    engine = TorchContinuous(cfg=cfg, params=convert.params_from_numpy(
        params_np, cfg, device='cpu'), device='cpu', **KW)
    try:
        for kwargs, mode in refreshes:
            engine.refresh_weights(**kwargs, mode=mode)
        stats = engine.stats()
        return engine.params, {k: stats[k] for k in (
            'policy_version', 'weight_refreshes', 'refresh_shards')}
    finally:
        engine.shutdown()


@pytest.fixture(scope='module')
def runs(inputs):
    """Every tensor=2 case in one launch, then the one-rank port engines
    through the same refreshes (this process)."""
    tp = launch(ranks.refresh_cases, 2, inputs['params'], inputs['new'],
                inputs['delta'], inputs['bad'], inputs['drain'],
                inputs['w8a8_bad'],
                inputs['moe'], inputs['moe_delta'], N_NEW, device='cpu',
                timeout=300)
    cfg = ranks.tiny_config()
    one, counters = _one_rank(inputs['params'], cfg, [
        ({'params': convert.params_from_numpy(inputs['new'], cfg,
                                              device='cpu')}, 'step'),
        ({'updates': inputs['delta']}, 'step'),
        ({'updates': inputs['drain']}, 'drain')])
    moe, _ = _one_rank(inputs['moe'], ranks.moe_config(),
                       [({'updates': inputs['moe_delta']}, 'step')])
    return {'tp': tp, 'one': one, 'one_counters': counters, 'moe': moe}


def _same_slices(tp, key, one, cfg):
    """Each rank's leaves equal its slice of the one-rank port's
    leaves, bitwise (under the rules ``prepare_engine`` slices by)."""
    mesh = sharding.build_inference_mesh('tensor=2', devices=[0, 1],
                                         device_type='cpu')
    for rank in (0, 1):
        want = ranks.leaves(sharding.shard_inference_params(one, mesh, cfg,
                                                            rank=rank))
        got = tp[rank][key]
        assert sorted(got) == sorted(want)
        for path, value in want.items():
            np.testing.assert_array_equal(got[path], value,
                                          err_msg=f'rank {rank} {path}')


def test_tp_refresh_tokens_match_jax_tp_engine(runs, jax_side):
    """Whole tree, delta of every shard rule, drain-mode delta: the JAX
    tensor=2 engine's tokens after each, and its counters."""
    got = runs['tp'][0]['tiny']
    assert got['before'] == jax_side['before']
    assert got['whole'] == jax_side['whole'] != jax_side['before']
    assert got['delta'] == jax_side['delta'] != jax_side['whole']
    assert got['after_drain'] == jax_side['after_drain']
    counters = {k: got['stats'][k] for k in jax_side['counters']}
    assert counters == jax_side['counters'] == runs['one_counters']
    assert got['versions'] == [1, 2, 2, 3]


def test_each_rank_refreshes_its_slice_bitwise(runs, inputs):
    """After the three refreshes each rank's leaves are its slices of the
    one-rank port's refreshed leaves (so every shard rule narrowed the
    whole value as it narrowed the weights); a delta broadcasts each
    leaf whole: its bytes are the updates' fp32 bytes."""
    tp = runs['tp']
    _same_slices(tp, 'tiny_leaves', runs['one'], ranks.tiny_config())
    got = tp[0]['tiny']
    assert got['delta_shards'] == len(DELTA_PATHS)
    assert got['delta_bytes'] == sum(v.nbytes
                                     for v in inputs['delta'].values())
    # The sharded leaves really are shards.
    assert tp[0]['tiny_leaves']['layers/attn/wq'].shape[2] == 2
    assert tp[0]['tiny_leaves']['embed/embedding'].shape[0] == 256


def test_refused_refreshes_change_nothing(runs):
    """An unknown path and a shard-shaped value (each beside a valid
    leaf) raise ``KeyError`` and ``ValueError`` on the driver; a W8A8
    leaf ``TypeError``; the version stays, and no rank's weights move
    (the W8A8 engine's leaves before and after, bitwise; the TINY
    engine's end on the one-rank port's, checked above)."""
    got = runs['tp'][0]['tiny']
    assert got['errors'] == ['KeyError', 'ValueError']
    assert got['versions'][1] == got['versions'][2]
    assert runs['tp'][0]['w8a8'] == (['TypeError'], 0)
    for rank in (0, 1):
        before, after = (runs['tp'][rank]['w8a8_before'],
                         runs['tp'][rank]['w8a8_after'])
        assert sorted(before) == sorted(after)
        for path in before:
            np.testing.assert_array_equal(before[path], after[path])


def test_drain_refresh_waits_for_the_request_in_flight(runs):
    """A drain-mode refresh asked for while a request decodes lands
    after it finished: that request gives the delta weights' tokens."""
    got = runs['tp'][0]['tiny']
    assert got['drained_first']
    assert got['in_flight'] == got['delta'][1]


def test_moe_refresh_matches_jax_tp_engine(runs, jax_side):
    """TINY_MOE's expert leaves (each expert's FFN columns on each rank)
    and router refreshed: the JAX tensor=2 engine's tokens, each rank's
    leaves its slices of the one-rank port's."""
    assert runs['tp'][0]['moe']['tokens'] == jax_side['moe']
    assert runs['tp'][0]['moe']['version'] == 1
    _same_slices(runs['tp'], 'moe_leaves', runs['moe'], ranks.moe_config())
