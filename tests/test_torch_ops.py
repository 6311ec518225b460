"""Port ops against the JAX reference: norms, RoPE, KV quantization,
the config registry and the weight bridge.

Inputs come from seeded numpy and go through both packages on the CPU;
fp32 results agree to 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import config as jconfig
from skypilot_tpu.models import decode as jdecode
from skypilot_tpu.models import llama as jllama
from skypilot_tpu.ops import rms_norm as j_rms_norm
from skypilot_tpu_torch.models import config as tconfig
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models import decode as tdecode
from skypilot_tpu_torch.models import llama as tllama
from skypilot_tpu_torch.ops import rms_norm as t_rms_norm
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

ATOL = 1e-6


def _np(x):
    return np.asarray(x, np.float32)


def test_rms_norm_matches_reference():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 64).astype(np.float32) * 3
    scale = rng.randn(64).astype(np.float32)
    ref = j_rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-5)
    out = t_rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-5)
    np.testing.assert_allclose(out.numpy(), _np(ref), atol=ATOL)


@pytest.mark.parametrize('scaling', [None, (8.0, 1.0, 4.0, 8192)],
                         ids=['plain', 'llama3'])
@pytest.mark.parametrize('pos_shape', [(48,), (2, 24)], ids=['1d', '2d'])
def test_rope_table_matches_reference(scaling, pos_shape):
    positions = np.arange(int(np.prod(pos_shape))).reshape(pos_shape)
    jsin, jcos = jllama.rope_table(jnp.asarray(positions), 128, 500_000.0,
                                   scaling=scaling)
    tsin, tcos = tllama.rope_table(torch.from_numpy(positions), 128,
                                   500_000.0, scaling=scaling)
    np.testing.assert_allclose(tsin.numpy(), _np(jsin), atol=ATOL)
    np.testing.assert_allclose(tcos.numpy(), _np(jcos), atol=ATOL)


@pytest.mark.parametrize('table_rank', [2, 3])
def test_apply_rope_matches_reference(table_rank):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 6, 4, 16).astype(np.float32)
    positions = (np.arange(6) if table_rank == 2 else
                 np.stack([np.arange(6), np.arange(6) + 9]))
    jsin, jcos = jllama.rope_table(jnp.asarray(positions), 16, 10_000.0)
    tsin, tcos = tllama.rope_table(torch.from_numpy(positions), 16,
                                   10_000.0)
    ref = jllama.apply_rope(jnp.asarray(x), jsin, jcos)
    out = tllama.apply_rope(torch.from_numpy(x), tsin, tcos)
    np.testing.assert_allclose(out.numpy(), _np(ref), atol=ATOL)


def test_quantize_kv_matches_reference():
    """int8 values are equal except where the two fp32 divisions land
    on opposite sides of a .5 tie; such values differ by exactly 1."""
    rng = np.random.RandomState(2)
    x = (rng.randn(3, 7, 2, 16) * rng.uniform(0.01, 10, (3, 7, 2, 1))
         ).astype(np.float32)
    jq, js = jdecode.quantize_kv(jnp.asarray(x))
    tq, ts = tdecode.quantize_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_allclose(ts.numpy(), _np(js), rtol=1e-7, atol=0)
    diff = np.abs(tq.numpy().astype(np.int32) -
                  np.asarray(jq).astype(np.int32))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 1e-3


def _dtype_name(value):
    if isinstance(value, torch.dtype):
        return str(value).replace('torch.', '')
    return jnp.dtype(value).name


def test_every_registered_config_matches_field_by_field():
    assert tconfig.list_models() == jconfig.list_models()
    jfields = [f.name for f in dataclasses.fields(jconfig.ModelConfig)]
    tfields = [f.name for f in dataclasses.fields(tconfig.ModelConfig)]
    assert tfields == jfields
    for name in jconfig.list_models():
        jc = jconfig.get_model_config(name)
        tc = tconfig.get_model_config(name)
        for field in jfields:
            jv, tv = getattr(jc, field), getattr(tc, field)
            if field in ('param_dtype', 'compute_dtype'):
                assert _dtype_name(tv) == _dtype_name(jv), (name, field)
            else:
                assert tv == jv, (name, field)
        assert tc.resolved_head_dim == jc.resolved_head_dim
        assert tc.rope_scaling == jc.rope_scaling
        assert tc.is_moe == jc.is_moe
        assert tc.params_count() == jc.params_count()
        assert (tconfig.with_int8_kv_cache(tc).kv_cache_dtype ==
                jconfig.with_int8_kv_cache(jc).kv_cache_dtype)


@pytest.mark.parametrize('param_dtype', ['float32', 'bfloat16'])
def test_weight_bridge_round_trips_exactly(param_dtype):
    jcfg = jconfig.get_model_config('tiny',
                                    param_dtype=jnp.dtype(param_dtype))
    tcfg = tconfig.get_model_config('tiny')
    tree = jax.tree.map(np.asarray,
                        jllama.init_params(jax.random.key(3), jcfg))
    params = convert.params_from_numpy(tree, tcfg, device='cpu')
    assert (params['layers']['attn']['wq'].dtype ==
            getattr(torch, param_dtype))
    back = convert.params_to_numpy(params)
    flat_in = jax.tree_util.tree_leaves_with_path(tree)
    flat_out = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_in) == len(flat_out)
    for path, leaf in flat_in:
        out = flat_out[path]
        assert out.dtype == leaf.dtype and out.shape == leaf.shape, path
        np.testing.assert_array_equal(out.view(np.uint8),
                                      leaf.view(np.uint8))


def test_weight_bridge_rejects_mismatched_trees():
    tcfg = tconfig.get_model_config('tiny')
    tree = jax.tree.map(np.asarray, jllama.init_params(
        jax.random.key(0), jconfig.get_model_config('tiny')))
    bad = dict(tree, extra={'w': np.zeros(3, np.float32)})
    with pytest.raises(KeyError, match='unexpected'):
        convert.params_from_numpy(bad, tcfg, device='cpu')
    with pytest.raises(ValueError, match='shape'):
        convert.params_from_numpy(tree, tconfig.get_model_config(
            'tiny', d_model=32), device='cpu')


def test_init_params_keys_shapes_and_storage_dtype():
    cfg = tconfig.get_model_config('tiny')
    params = tllama.init_params(0, cfg, device='cpu',
                                weight_dtype=torch.bfloat16)
    ref = jllama.init_params(jax.random.key(0),
                             jconfig.get_model_config('tiny'))
    shapes = jax.tree.map(lambda x: tuple(x.shape), ref)
    tshapes = jax.tree.map(lambda x: tuple(x.shape), params)
    assert tshapes == shapes
    assert params['layers']['mlp']['wo'].dtype == torch.bfloat16
    assert params['layers']['ln_attn']['scale'].dtype == torch.float32
    # Same distributions: truncated normal of std fan_in**-0.5.
    wq = params['layers']['attn']['wq'].float()
    assert wq.abs().max() <= 3 * 64 ** -0.5 + 1e-2
    assert abs(wq.std().item() - 0.88 * 64 ** -0.5) < 0.02
    again = tllama.init_params(0, cfg, device='cpu',
                               weight_dtype=torch.bfloat16)
    assert torch.equal(again['embed']['embedding'],
                       params['embed']['embedding'])
