"""Tensor-parallel serving of MoE configs: the port against the JAX
reference.

The JAX engines run in this process on the 8 virtual CPU devices of
``tests/conftest.py`` at ``mesh='tensor=2'``; the port runs as two
``gloo`` ranks (``tests/torch_tp_ranks.py``), each building the same
engine with ``mesh='tensor=2'`` on its shard of the JAX engine's
weights. TINY_MOE (4 query and 2 kv heads, 4 experts top 2) at fp32
compute: greedy tokens equal the JAX engines' on both engines under
dense and capacity dispatch, with W8A8 and an int8 pool, and with
speculative windows; each rank's expert shards equal the JAX sharded
params' addressable shards bitwise; the follower routes every token of
every step as the driver does; a MoE decode step takes the collectives
of a dense one of the same depth.
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
from skypilot_tpu.models import llama as jllama
from skypilot_tpu.models import quant as jquant
from skypilot_tpu.models.config import get_model_config as jax_config
from skypilot_tpu_torch.inference import sharding
from skypilot_tpu_torch.models import llama, quant
from skypilot_tpu_torch.parallel.launch import launch
from torch_threads import few_torch_threads  # noqa: F401 (autouse)
from torch_tp_ranks import one_thread_ranks  # noqa: F401 (autouse)


def _jax_cfg(**overrides):
    return jax_config('tiny-moe', compute_dtype=jnp.float32, **overrides)


def _jax_tokens(name):
    kind, options, overrides = ranks.MOE_CASES[name]
    cfg = _jax_cfg(**overrides)
    if kind == 'batch':
        engine = JaxEngine(cfg=cfg, seed=0, mesh='tensor=2', max_batch=2,
                           **options)
        return engine.generate_ids(ranks.PROMPTS,
                                   max_new_tokens=ranks.N_NEW)
    engine = JaxContinuous(cfg=cfg, seed=0, mesh='tensor=2', max_slots=2,
                           max_len=64, block_size=8, prefill_chunk=8,
                           **options)
    try:
        return [engine.generate_ids(p, max_new_tokens=ranks.N_NEW)
                for p in ranks.PROMPTS]
    finally:
        engine.shutdown()


@pytest.fixture(scope='module')
def jax_params():
    """The weights every JAX engine of seed 0 serves, as numpy (the
    dispatch does not change them)."""
    return jax.tree.map(np.asarray, jllama.init_params(jax.random.key(0),
                                                       _jax_cfg()))


@pytest.fixture(scope='module')
def port_runs(jax_params):
    """Every MoE case on the port's two ranks, in one launch."""
    return launch(ranks.serve_moe_cases, 2, jax_params,
                  list(ranks.MOE_CASES), device='cpu')


@pytest.mark.parametrize('name', list(ranks.MOE_CASES))
def test_moe_tp_tokens_match_jax(port_runs, name):
    """The driver's greedy tokens equal the JAX engine's under the same
    mesh, and every rank's decode attention went through the paged
    dispatch on its own kv head (continuous engine)."""
    assert port_runs[0]['cases'][name]['tokens'] == _jax_tokens(name)
    if name.startswith('continuous'):
        for rank in (0, 1):
            paged = port_runs[rank]['cases'][name]['paged_attention']
            assert paged['calls'] > 0 and paged['heads'] == [2]


def test_expert_shards_equal_jax_addressable_shards(port_runs, jax_params):
    """Each rank's expert leaves (served by its engine) equal the JAX
    sharded params' addressable shard on the same device, bitwise: every
    expert on every rank, half of each expert's FFN columns."""
    jmesh = jax_build_inference_mesh('tensor=2')
    jsharded = jax_shard_inference_params(
        jax.tree.map(jnp.asarray, jax_params), jmesh, _jax_cfg())
    ids = [d.id for d in jmesh.devices.flat]
    cfg = ranks.moe_config()
    for rank in (0, 1):
        experts = port_runs[rank]['cases']['continuous_dense']['experts']
        for name, got in experts.items():
            jleaf = jsharded['layers']['moe'][name]
            want = next(s for s in jleaf.addressable_shards
                        if s.device.id == ids[rank])
            np.testing.assert_array_equal(got, np.asarray(want.data))
        assert experts['wi_gate'].shape == (
            cfg.n_layers, cfg.num_experts, cfg.d_model, cfg.d_ff // 2)
        assert experts['wo'].shape == (
            cfg.n_layers, cfg.num_experts, cfg.d_ff // 2, cfg.d_model)


@pytest.mark.parametrize('name', list(ranks.MOE_CASES))
def test_follower_routes_as_the_driver(port_runs, name):
    """The follower's ``selected`` equals the driver's in every router
    call (each layer of each step), bitwise: both route the same
    residual stream."""
    driver = port_runs[0]['cases'][name]['selected']
    follower = port_runs[1]['cases'][name]['selected']
    assert len(driver) == len(follower) > 0
    for a, b in zip(driver, follower):
        np.testing.assert_array_equal(a, b)


def test_moe_decode_step_collectives_equal_dense(port_runs):
    """A MoE decode step takes the dense step's collectives at the same
    depth: the embedding's, two all-reduces a layer (attention ``wo``
    and the MoE block's one) and the vocab gather. A reduce per expert
    would show here."""
    cfg = ranks.moe_config()
    for rank in (0, 1):
        counts = port_runs[rank]['collectives']
        assert counts['tiny-moe'] == counts['tiny']
        assert counts['tiny-moe'] == {
            'all_reduce tensor': 2 * cfg.n_layers + 2}


@pytest.mark.parametrize('model', ['tiny', 'tiny-moe'])
@pytest.mark.parametrize('quantize', [False, True])
def test_shard_built_leaf_by_leaf_equals_slice_of_whole_init(model,
                                                             quantize):
    """``init_shard`` (each leaf drawn, quantized, sliced and freed in
    turn) gives each rank exactly its slice of the one-rank seeded init
    (W8A8 on the whole tensors when ``quantize``)."""
    cfg = ranks.moe_config(model)
    mesh = sharding.build_inference_mesh('tensor=2', devices=[0, 1],
                                         device_type='cpu')
    whole = quant.maybe_quantize(llama.init_params(
        0, cfg, device='cpu', weight_dtype=cfg.compute_dtype), quantize)
    for rank in (0, 1):
        built = sharding.init_shard(0, cfg, mesh, device='cpu',
                                    quantize=quantize, rank=rank)
        sliced = sharding.shard_inference_params(whole, mesh, cfg,
                                                 rank=rank)
        got, want = list(quant._leaves(built)), list(quant._leaves(sliced))  # pylint: disable=protected-access
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.shape == b.shape and torch.equal(a, b)


def test_int8_experts_refused_under_a_mesh_as_in_the_reference(jax_params):
    """A tree with int8 experts does not serve under ``tensor=2`` in
    either package: the reference shards before it quantizes, and its
    ``device_put`` of an already-quantized tree fails on a scale axis
    squeezed to 1; the port refuses the tree before it starts any
    rank."""
    jq = jquant.quantize_params(jax.tree.map(jnp.asarray, jax_params),
                                quantize_moe=True)
    with pytest.raises(ValueError, match='divisible by 2'):
        JaxEngine(cfg=_jax_cfg(), params=jq, mesh='tensor=2', max_batch=2)
    tq = quant.quantize_params(llama.init_params(0, ranks.moe_config(),
                                                 device='cpu'),
                               quantize_moe=True)
    with pytest.raises(NotImplementedError, match='int8 MoE experts'):
        sharding.check_unported('tensor=2', ranks.moe_config(), tq)
    sharding.check_unported(None, ranks.moe_config(), tq)
