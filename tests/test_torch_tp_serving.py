"""Tensor-parallel serving of the port against the JAX reference.

The JAX side runs in this process on the 8 virtual CPU devices of
``tests/conftest.py`` (``mesh='tensor=2'``). The port's side runs as two
``gloo`` ranks (``parallel/launch.py``) in spawned processes that import
only torch and the port (``tests/torch_tp_ranks.py``), each building the
same engine with ``mesh='tensor=2'`` on its shard of the JAX engine's
weights. TINY with 4 query and 2 kv heads at fp32 compute: greedy
tokens must equal the JAX engines' under the mesh and the single-device
engines', on both engines, plain, with W8A8, with an int8 pool and with
speculative windows; each rank's weight shards must equal the JAX
sharded params' addressable shards bitwise. The twins of
``tests/test_inference_sharding.py`` and of
``tests/test_kv_cache_int8.py::test_all_three_quant_axes_compose``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_tp_ranks as ranks
from skypilot_tpu.inference.continuous import (ContinuousBatchingEngine as
                                               JaxContinuous)
from skypilot_tpu.inference.engine import InferenceEngine as JaxEngine
from skypilot_tpu.inference.sharding import (
    build_inference_mesh as jax_build_inference_mesh)
from skypilot_tpu.inference.sharding import (
    shard_inference_params as jax_shard_inference_params)
from skypilot_tpu.models import decode as jdecode
from skypilot_tpu.models import llama as jllama
from skypilot_tpu.models import quant as jquant
from skypilot_tpu.models.config import get_model_config as jax_config
from skypilot_tpu_torch.inference import sharding
from skypilot_tpu_torch.models import convert, llama
from skypilot_tpu_torch.models import quant as tquant
from skypilot_tpu_torch.parallel.launch import launch
from skypilot_tpu_torch.parallel.sharding import param_shardings
from torch_threads import few_torch_threads  # noqa: F401 (autouse)
from torch_tp_ranks import one_thread_ranks  # noqa: F401 (autouse)


def _jax_cfg(**overrides):
    return jax_config('tiny', n_heads=4, n_kv_heads=2,
                      compute_dtype=jnp.float32, **overrides)


def _jax_tokens(kind, options, mesh):
    cfg = _jax_cfg()
    if kind == 'batch':
        engine = JaxEngine(cfg=cfg, seed=0, mesh=mesh, max_batch=2,
                           **options)
        return engine.generate_ids(ranks.PROMPTS,
                                   max_new_tokens=ranks.N_NEW)
    engine = JaxContinuous(cfg=cfg, seed=0, mesh=mesh, max_slots=2,
                           max_len=64, block_size=8, prefill_chunk=8,
                           **options)
    try:
        return [engine.generate_ids(p, max_new_tokens=ranks.N_NEW)
                for p in ranks.PROMPTS]
    finally:
        engine.shutdown()


@pytest.fixture(scope='module')
def jax_params():
    """The weights every JAX engine of seed 0 serves, as numpy."""
    return jax.tree.map(np.asarray, jllama.init_params(jax.random.key(0),
                                                       _jax_cfg()))


@pytest.fixture(scope='module')
def port_runs(jax_params):
    """Every engine case on the port's two ranks, in one launch."""
    return launch(ranks.serve_cases, 2, jax_params,
                  list(ranks.ENGINE_CASES), device='cpu')


def _port(port_runs, name, rank=0):
    return port_runs[rank]['cases'][name]


def test_params_actually_shard(jax_params):
    """Each rank's slice of every leaf equals the JAX sharded params'
    addressable shard on the same device, bitwise, and ``wq`` is
    really split."""
    cfg = ranks.tiny_config()
    params = convert.params_from_numpy(jax_params, cfg, device='cpu')
    mesh = sharding.build_inference_mesh('tensor=2', devices=[0, 1],
                                         device_type='cpu')
    jmesh = jax_build_inference_mesh('tensor=2')
    jsharded = jax_shard_inference_params(
        jax.tree.map(jnp.asarray, jax_params), jmesh, _jax_cfg())
    ids = [d.id for d in jmesh.devices.flat]
    for rank in (0, 1):
        shard = sharding.shard_inference_params(params, mesh, cfg,
                                                rank=rank)
        jleaves = jax.tree_util.tree_leaves_with_path(jsharded)
        for path, jleaf in jleaves:
            keys = [p.key for p in path]
            leaf = shard
            for key in keys:
                leaf = leaf[key]
            jshard = next(s for s in jleaf.addressable_shards
                          if s.device.id == ids[rank])
            np.testing.assert_array_equal(leaf.numpy(),
                                          np.asarray(jshard.data))
    wq = sharding.shard_inference_params(params, mesh, cfg,
                                         rank=0)['layers']['attn']['wq']
    assert tuple(wq.shape) == (2, 64, 2, 16)


def test_sharded_generation_matches_single_device(port_runs):
    single = _jax_tokens('batch', {}, None)
    assert _jax_tokens('batch', {}, 'tensor=2') == single
    assert _port(port_runs, 'batch')['tokens'] == single


def test_continuous_sharded_generation_matches_single_device(port_runs):
    single = _jax_tokens('continuous', {}, None)
    assert _jax_tokens('continuous', {}, 'tensor=2') == single
    assert _port(port_runs, 'continuous')['tokens'] == single


@pytest.mark.parametrize('name', ['batch_w8a8', 'batch_int8kv',
                                  'continuous_w8a8', 'continuous_int8kv',
                                  'continuous_spec'])
def test_quantized_and_speculative_tp_tokens_match_jax(port_runs, name):
    kind, options = ranks.ENGINE_CASES[name]
    assert _port(port_runs, name)['tokens'] == _jax_tokens(
        kind, options, 'tensor=2')


def test_mesh_plus_quantize_compose(port_runs, jax_params):
    """W8A8 under the mesh: int8 ``wq`` shards of half the heads on both
    ranks, and the reference's tokens. The int8 values of every rank's
    shard equal the JAX engine's addressable shards bitwise; the scales
    equal the slices of the reference's unsharded ``quantize_params``
    bitwise. The JAX engine's own sharded scales differ from its
    unsharded ones by one fp32 ulp (XLA compiles the sharded program
    differently), so against those the scales are held to 2e-7."""
    for rank in (0, 1):
        assert _port(port_runs, 'batch_w8a8', rank)['wq'] == [
            'torch.int8', [2, 64, 2, 16]]
    jeng = JaxEngine(cfg=_jax_cfg(), seed=0, mesh='tensor=2',
                     quantize=True)
    assert jeng.params['layers']['attn']['wq'].q.dtype == jnp.int8
    junsharded = jquant.quantize_params(jax.tree.map(jnp.asarray,
                                                     jax_params))
    cfg = ranks.tiny_config()
    full = tquant.quantize_params(convert.params_from_numpy(
        jax_params, cfg, device='cpu'))
    mesh = sharding.build_inference_mesh('tensor=2', devices=[0, 1],
                                         device_type='cpu')
    ids = [d.id for d in jeng._mesh.devices.flat]  # pylint: disable=protected-access
    for rank in (0, 1):
        shard = sharding.shard_inference_params(full, mesh, cfg, rank=rank)
        for block, name in (('attn', 'wq'), ('attn', 'wo'),
                            ('mlp', 'wi_gate'), ('mlp', 'wo')):
            got = shard['layers'][block][name]
            jwant = jeng.params['layers'][block][name]
            unsharded = junsharded['layers'][block][name]

            def addressable(array):
                return np.asarray(next(
                    s for s in array.addressable_shards
                    if s.device.id == ids[rank]).data)

            np.testing.assert_array_equal(got.q.numpy(),
                                          addressable(jwant.q))
            np.testing.assert_allclose(got.scale.numpy(),
                                       addressable(jwant.scale),
                                       rtol=2e-7, atol=0)
            want = param_shardings(
                mesh, llama.param_logical_axes(cfg))['layers'][block][name]
            np.testing.assert_array_equal(
                got.scale.numpy(),
                want.slice(torch.from_numpy(np.array(unsharded.scale)),
                           rank).numpy())


def test_all_three_quant_axes_compose(port_runs):
    """W8A8 weights + int8 KV + the TP mesh in one engine."""
    assert _port(port_runs, 'batch_all_quant')['tokens'] == _jax_tokens(
        'batch', {'quantize': True, 'quantize_kv': True}, 'tensor=2')


def test_tp_decode_uses_kernel_dispatch_per_shard(port_runs):
    """Under the mesh each rank's decode steps go through the decode /
    paged dispatch (the kernels on the card, their plain versions
    here) on its own kv-head shard: 2 of 4 query heads. The batch engine
    defaults decode attention to the kernel route."""
    for rank in (0, 1):
        batch = _port(port_runs, 'batch', rank)['decode_attention']
        assert batch['calls'] > 0 and batch['heads'] == [2]
        cont = _port(port_runs, 'continuous', rank)['paged_attention']
        assert cont['calls'] > 0 and cont['heads'] == [2]
        spec = _port(port_runs, 'continuous_spec', rank)['paged_attention']
        assert spec['calls'] > 0 and spec['heads'] == [2]
    # Both ranks ran the same steps.
    assert (_port(port_runs, 'continuous', 0)['paged_attention'] ==
            _port(port_runs, 'continuous', 1)['paged_attention'])


@pytest.fixture(scope='module')
def prefill_runs():
    """Prefill at head_dim 128, S=128 (a shape the flash kernels take):
    the single-device JAX logits and each port rank's, in one launch."""
    jcfg = _jax_cfg(attention_impl='pallas', max_seq_len=256, head_dim=128)
    params = jax.tree.map(np.asarray,
                          jllama.init_params(jax.random.key(0), jcfg))
    rng = np.random.RandomState(1)
    tokens = rng.randint(0, jcfg.vocab_size, (2, 128)).astype(np.int32)
    lengths = np.array([128, 100], np.int32)
    ref, _ = jdecode.prefill(jax.tree.map(jnp.asarray, params),
                             jnp.asarray(tokens), jnp.asarray(lengths),
                             jcfg, 160)
    return np.asarray(ref), launch(ranks.prefill_shards, 2, params, tokens,
                                   lengths, device='cpu')


def test_tp_prefill_runs_flash_kernel_per_shard(prefill_runs):
    """Prefill under the mesh runs the flash dispatch on each rank's 2
    heads, keeps 1 kv head in the cache, and gives the single-device
    JAX prefill's logits within 2e-4."""
    ref, out = prefill_runs
    for rank in (0, 1):
        assert out[rank]['flash']['calls'] > 0
        assert out[rank]['flash']['heads'] == [2]
        assert out[rank]['cache_heads'] == 1
        np.testing.assert_allclose(out[rank]['logits'], ref, rtol=2e-4,
                                   atol=2e-4)


def test_bad_mesh_specs_rejected():
    with pytest.raises(ValueError, match='empty mesh spec'):
        sharding.build_inference_mesh('')
    with pytest.raises(ValueError, match='unknown mesh axis'):
        sharding.build_inference_mesh('tp=8', devices=range(8))
    with pytest.raises(ValueError, match='devices'):
        sharding.build_inference_mesh('tensor=16', devices=range(8))
    with pytest.raises(ValueError, match='only one axis may be -1'):
        sharding.build_inference_mesh('tensor=-1,data=-1', devices=range(8))
    mesh = sharding.build_inference_mesh('tensor=-1', devices=range(8))
    assert mesh.shape['tensor'] == 8
    jmesh = jax_build_inference_mesh('tensor=2,data=2')
    mesh = sharding.build_inference_mesh('tensor=2,data=2', devices=range(8))
    assert mesh.shape == dict(jmesh.shape)
    # Without ranks a multi-rank mesh names the launcher.
    with pytest.raises(ValueError, match='parallel.launch'):
        sharding.build_inference_mesh('tensor=2')


def test_prepare_engine_none_is_identity():
    cfg = ranks.tiny_config()
    params = llama.init_params(0, cfg, device='cpu')
    p2, c2, m2 = sharding.prepare_engine(params, cfg, None)
    assert p2 is params and c2 is cfg and m2 is None


def test_unported_options_raise_under_the_mesh(port_runs):
    """Refresh under a mesh raises with its queue item (the constructor
    options are pinned in ``test_torch_isolation.py``); the driver's
    stats name the mesh, the backend and each rank's device."""
    cont = _port(port_runs, 'continuous')
    assert 'ROADMAP' in cont['refresh_refused']
    assert 'item 15' in cont['refresh_refused']
    assert cont['mesh'] == {'mesh': "Mesh({'tensor': 2})",
                            'mesh_backend': 'gloo',
                            'mesh_devices': ['cpu', 'cpu']}
    assert _port(port_runs, 'batch')['mesh'] == cont['mesh']



def test_paged_pool_holds_this_ranks_kv_heads(port_runs, prefill_runs):
    """Each rank's pool holds 1 of the 2 kv heads; ``shard_paged_cache``
    of a whole pool keeps exactly this rank's head."""
    for rank in (0, 1):
        assert _port(port_runs, 'continuous', rank)['pool_kv_heads'] == 1
        out = prefill_runs[1][rank]
        np.testing.assert_array_equal(out['pool_shard'],
                                      out['pool'][:, :, :, rank:rank + 1])
