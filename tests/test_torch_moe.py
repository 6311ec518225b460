"""The port's MoE layers against the JAX reference on the CPU.

TINY_MOE (4 experts, top 2) at fp32 compute, the reference's weights
carried over by ``models/convert.py``, inputs from seeded numpy. Held:
``_moe_block`` (dense and capacity dispatch, capacity 0.25 that drops
assignments, a padded prefill chunk whose padding claims capacity) to
1e-5; ``forward(return_aux=True)`` logits to 2e-4 and the aux loss to
1e-6 (also the fine-grained 8 experts top 3); both engines' greedy
tokens exactly; three train steps (AdamW, Adafactor) to the training
tolerances of ``test_torch_train.py``; the int8-expert block to 1e-4
relative. The large MoE configs build with the reference's leaf names
and shapes (shapes only, under a fake-tensor mode).
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from skypilot_tpu.inference.continuous import (
    ContinuousBatchingEngine as JaxContinuous)
from skypilot_tpu.inference.engine import InferenceEngine as JaxBatch
from skypilot_tpu.models import config as jconfig
from skypilot_tpu.models import decode as jdecode
from skypilot_tpu.models import llama as jllama
from skypilot_tpu.models import quant as jquant
from skypilot_tpu.parallel.sharding import DEFAULT_RULES
from skypilot_tpu.train import step as jstep
from skypilot_tpu_torch.inference.continuous import (
    ContinuousBatchingEngine as TorchContinuous)
from skypilot_tpu_torch.inference.engine import InferenceEngine as TorchBatch
from skypilot_tpu_torch.models import config as tconfig
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models import decode as tdecode
from skypilot_tpu_torch.models import llama as tllama
from skypilot_tpu_torch.models import quant as tquant
from skypilot_tpu_torch.train import pretrain as tpretrain
from skypilot_tpu_torch.train import step as tstep
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

PROMPTS = [[3, 1, 4, 1, 5], [2, 7, 18] * 9, [31, 41, 59, 26, 5, 3]]


def _configs(**overrides):
    jcfg = jconfig.get_model_config('tiny-moe', compute_dtype=jnp.float32,
                                    attention_impl='xla', **overrides)
    tcfg = tconfig.get_model_config('tiny-moe',
                                    compute_dtype=torch.float32,
                                    attention_impl='xla', **overrides)
    return jcfg, tcfg


def _params(jcfg, tcfg, seed=0):
    jparams = jllama.init_params(jax.random.key(seed), jcfg)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        tcfg, device='cpu')
    return jparams, tparams


def _layer0(jparams, tparams):
    return (jax.tree.map(lambda a: a[0], jparams['layers']['moe']),
            {k: v[0] for k, v in tparams['layers']['moe'].items()})


def _block_pair(jlp, tlp, jcfg, tcfg, x):
    jout, jaux = jllama._moe_block(jnp.asarray(x), jlp, jcfg, DEFAULT_RULES)
    with torch.no_grad():
        tout, taux = tllama._moe_block(torch.from_numpy(x), tlp, tcfg)
    return np.asarray(jout), float(jaux), tout.numpy(), taux.item()


@pytest.mark.parametrize('dispatch,factor', [
    ('dense', 1.25), ('capacity', 1.25), ('capacity', 0.25)],
    ids=['dense', 'capacity', 'capacity-drops'])
def test_moe_block_matches_jax(dispatch, factor):
    """Output and aux of one layer's block on [2, 16, 64] activations.
    At capacity 0.25 (C = 2 of 16 tokens x 2 choices / 4 experts) most
    assignments drop: the output then differs from dense dispatch's."""
    jcfg, tcfg = _configs(moe_dispatch=dispatch, capacity_factor=factor)
    jparams, tparams = _params(jcfg, tcfg, seed=1)
    jlp, tlp = _layer0(jparams, tparams)
    x = np.random.RandomState(2).randn(2, 16, 64).astype(np.float32)
    jout, jaux, tout, taux = _block_pair(jlp, tlp, jcfg, tcfg, x)
    np.testing.assert_allclose(tout, jout, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(taux, jaux, atol=1e-6, rtol=0)
    if factor < 1:
        with torch.no_grad():
            dense, _ = tllama._moe_block(
                torch.from_numpy(x), tlp,
                dataclasses.replace(tcfg, moe_dispatch='dense'))
        assert np.abs(dense.numpy() - tout).max() > 1e-2


def test_moe_block_groups_like_jax():
    """moe_group_size 4 splits S=16 into four groups of C = 3; S=6 does
    not divide and routes as one group."""
    jcfg, tcfg = _configs(moe_dispatch='capacity', moe_group_size=4)
    jparams, tparams = _params(jcfg, tcfg, seed=3)
    jlp, tlp = _layer0(jparams, tparams)
    rng = np.random.RandomState(4)
    for s in (16, 6):
        x = rng.randn(2, s, 64).astype(np.float32)
        jout, jaux, tout, taux = _block_pair(jlp, tlp, jcfg, tcfg, x)
        np.testing.assert_allclose(tout, jout, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(taux, jaux, atol=1e-6, rtol=0)


def test_padded_chunk_routes_like_jax():
    """A prefill chunk of 16 rows holding 9 tokens under capacity
    dispatch (capacity 0.5: C = 4 of 16 x 2 / 4): the 7 padding rows
    route and claim capacity like real tokens in both packages, so the
    logits and the pool agree; the same 9 tokens in a chunk padded
    with another token id give other logits."""
    jcfg, tcfg = _configs(moe_dispatch='capacity', capacity_factor=0.5)
    jparams, tparams = _params(jcfg, tcfg, seed=5)
    chunk = np.zeros((1, 16), np.int32)
    chunk[0, :9] = np.random.RandomState(6).randint(1, 512, 9)
    tables = np.arange(1, 9, dtype=np.int32).reshape(2, 4)
    jc = dataclasses.replace(jdecode.init_paged_cache(jcfg, 9, 8, 2, 4),
                             block_tables=jnp.asarray(tables))
    tc = dataclasses.replace(
        tdecode.init_paged_cache(tcfg, 9, 8, 2, 4, device='cpu'),
        block_tables=torch.from_numpy(tables))
    jl, jc = jdecode.prefill_chunk(jparams, jnp.asarray(chunk),
                                   jnp.int32(0), jnp.int32(9), jnp.int32(1),
                                   jc, jcfg)
    with torch.no_grad():
        tl, tc = tdecode.prefill_chunk(tparams, torch.from_numpy(chunk), 0,
                                       9, 1, tc, tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    # The whole pool, the null block too: its row 0 keeps the last of
    # the padding rows' writes, as the reference's scatter leaves it.
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), atol=1e-5)
    np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v), atol=1e-5)
    assert np.abs(tc.k[:, 0, 0].numpy()).max() > 0
    other = chunk.copy()
    other[0, 9:] = 7
    fresh = tdecode.init_paged_cache(tcfg, 9, 8, 2, 4, device='cpu')
    fresh = dataclasses.replace(fresh, block_tables=torch.from_numpy(tables))
    with torch.no_grad():
        tl_other, _ = tdecode.prefill_chunk(tparams, torch.from_numpy(other),
                                            0, 9, 1, fresh, tcfg)
    assert np.abs(tl_other.numpy() - tl.numpy()).max() > 1e-4


def test_pool_writes_keep_the_last_null_row_write():
    """``_write_rows``: every padded or inactive input aims at the null
    row 0; the row ends holding the last of those writes (any device,
    any split of the work), the other rows their own values."""
    pool = torch.zeros(6, 2, 3)
    rows = torch.tensor([[0, 3, 0], [5, 0, 2]])
    values = torch.arange(36, dtype=torch.float32).reshape(2, 3, 2, 3)
    tdecode._write_rows(pool, rows, values)
    assert torch.equal(pool[0], values[1, 1])
    for row, (i, j) in ((3, (0, 1)), (5, (1, 0)), (2, (1, 2))):
        assert torch.equal(pool[row], values[i, j])
    assert not pool[[1, 4]].any()
    scales = torch.zeros(6, 2)
    tdecode._write_rows(scales, torch.tensor([4, 0, 0]),
                        torch.tensor([[1., 2.], [3., 4.], [5., 6.]]))
    assert scales[0].tolist() == [5., 6.] and scales[4].tolist() == [1., 2.]


@pytest.mark.parametrize('overrides', [
    {}, {'moe_dispatch': 'capacity'},
    {'num_experts': 8, 'experts_per_token': 3}],
    ids=['dense', 'capacity', 'fine-grained'])
def test_forward_return_aux_matches_jax(overrides):
    """Logits and the layer-mean aux loss of a [2, 32] batch; the
    fine-grained variant is the reference's deepseek-style test
    (tests/test_model.py:103)."""
    jcfg, tcfg = _configs(**overrides)
    jparams, tparams = _params(jcfg, tcfg, seed=7)
    tokens = np.random.RandomState(8).randint(0, 512, (2, 32)).astype(
        np.int32)
    jlogits, jaux = jllama.forward(jparams, jnp.asarray(tokens), jcfg,
                                   return_aux=True)
    with torch.no_grad():
        tlogits, taux = tllama.forward(tparams, torch.from_numpy(tokens),
                                       tcfg, return_aux=True)
    assert tlogits.dtype == torch.float32 and taux.shape == ()
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(taux.item(), float(jaux), atol=1e-6, rtol=0)
    assert np.isfinite(tlogits.numpy()).all()


def test_dense_forward_aux_is_zero():
    cfg = tconfig.get_model_config('tiny', compute_dtype=torch.float32)
    params = tllama.init_params(0, cfg, device='cpu')
    tokens = torch.zeros((1, 8), dtype=torch.int32)
    with torch.no_grad():
        logits, aux = tllama.forward(params, tokens, cfg, return_aux=True)
        plain = tllama.forward(params, tokens, cfg)
    assert aux.item() == 0.0
    assert torch.equal(logits, plain)


@pytest.mark.parametrize('dispatch', ['dense', 'capacity'])
def test_engines_greedy_tokens_match_jax(dispatch):
    """Both engines of each package on the same weights (capacity 0.5
    under capacity dispatch, so chunks and decode windows drop): the
    port's continuous and batch engines give the JAX engines' greedy
    tokens, token for token."""
    overrides = dict(moe_dispatch=dispatch, capacity_factor=0.5)
    jcfg = jconfig.get_model_config('tiny-moe', compute_dtype=jnp.float32,
                                    **overrides)
    tcfg = tconfig.get_model_config('tiny-moe',
                                    compute_dtype=torch.float32,
                                    **overrides)
    ref = JaxContinuous('tiny-moe', cfg=jcfg, max_slots=2, max_len=96)
    params = convert.params_from_numpy(
        jax.tree.map(np.asarray, ref.params), tcfg, device='cpu')
    port = TorchContinuous('tiny-moe', cfg=tcfg, params=params,
                           device='cpu', max_slots=2, max_len=96)
    try:
        want = [ref.generate_ids(p, max_new_tokens=8) for p in PROMPTS]
        got = [port.generate_ids(p, max_new_tokens=8) for p in PROMPTS]
    finally:
        ref.shutdown()
        port.shutdown()
    assert got == want
    jbatch = JaxBatch('tiny-moe', cfg=jcfg, max_batch=4)
    tbatch = TorchBatch('tiny-moe', cfg=tcfg, device='cpu', max_batch=4,
                        params=convert.params_from_numpy(
                            jax.tree.map(np.asarray, jbatch.params), tcfg,
                            device='cpu'))
    assert (tbatch.generate_ids(PROMPTS, max_new_tokens=8) ==
            jbatch.generate_ids(PROMPTS, max_new_tokens=8))


@pytest.mark.parametrize('optimizer,dispatch', [
    ('adamw', 'dense'), ('adafactor', 'capacity')])
def test_train_steps_match_jax(optimizer, dispatch):
    """Three steps with warmup 1: loss (plain cross entropy),
    total_loss (+ 0.01 x aux), router_aux and grad norm, then the
    params. The Adafactor case widens TINY_MOE to d_model 128, d_ff 256,
    so that the expert leaves are factored."""
    widths = ({'d_model': 128, 'd_ff': 256} if optimizer == 'adafactor'
              else {})
    jcfg, tcfg = _configs(moe_dispatch=dispatch, **widths)
    jparams, tparams = _params(jcfg, tcfg, seed=9)
    kwargs = dict(warmup_steps=1, total_steps=10, optimizer=optimizer)
    jhp, hp = jstep.TrainHParams(**kwargs), tstep.TrainHParams(**kwargs)
    jopt = jstep.make_optimizer(jhp)
    jstate = jstep.TrainState(step=jnp.zeros((), jnp.int32),
                              params=jparams, opt_state=jopt.init(jparams))
    jfn = jax.jit(functools.partial(jstep.train_step_fn, cfg=jcfg,
                                    optimizer=jopt, hp=jhp))
    tstate = tstep.create_train_state_from_params(tparams, tcfg, hp)
    tfn = tstep.make_train_step(tcfg, hp)
    rng = np.random.RandomState(10)
    for i in range(3):
        tokens = rng.randint(0, 512, (2, 32)).astype(np.int32)
        batch = {'tokens': tokens, 'targets': np.roll(tokens, -1, axis=1),
                 'weights': (rng.rand(2, 32) > 0.1).astype(np.float32)}
        jstate, jm = jfn(jstate, jax.tree.map(jnp.asarray, batch))
        tstate, tm = tfn(tstate, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
        for key in ('loss', 'total_loss', 'router_aux'):
            np.testing.assert_allclose(tm[key].item(), float(jm[key]),
                                       rtol=1e-5, err_msg=key)
        np.testing.assert_allclose(tm['grad_norm'].item(),
                                   float(jm['grad_norm']), rtol=1e-4)
        assert tm['router_aux'].item() > 0.9
        assert tm['total_loss'].item() != tm['loss'].item()
    ref = jax.tree_util.tree_leaves_with_path(jstate.params)
    got = dict(jax.tree_util.tree_leaves_with_path(
        convert.params_to_numpy(tstate.params)))
    for path, leaf in ref:
        np.testing.assert_allclose(got[path], np.asarray(leaf), atol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))


def test_quantized_moe_block_matches_jax():
    """``quantize_params(quantize_moe=True)`` of the same fp32 weights on
    each side: the same int8 experts and scales [L, E, 1, out], the
    router fp; the dequantizing block (dense and capacity) agrees with
    the reference's to 1e-4 relative, and so does the port's block on
    the reference's own quantized tree carried over."""
    jcfg, tcfg = _configs()
    jparams, tparams = _params(jcfg, tcfg, seed=11)
    jq = jquant.quantize_params(jparams, quantize_moe=True)
    tq = tquant.quantize_params(tparams, quantize_moe=True)
    carried = convert.params_from_numpy(jax.tree.map(np.asarray, jq), tcfg,
                                        device='cpu')
    for name in ('wi_gate', 'wi_up', 'wo'):
        ours, theirs = tq['layers']['moe'][name], jq['layers']['moe'][name]
        assert isinstance(ours, tquant.QTensor)
        assert ours.scale.shape == tuple(theirs.scale.shape)
        assert (np.abs(ours.q.numpy().astype(np.int32) -
                       np.asarray(theirs.q, np.int32)).max() <= 1)
    x = np.random.RandomState(12).randn(2, 16, 64).astype(np.float32)
    for dispatch in ('dense', 'capacity'):
        jc = dataclasses.replace(jcfg, moe_dispatch=dispatch)
        tc = dataclasses.replace(tcfg, moe_dispatch=dispatch)
        jlp = jax.tree.map(lambda a: a[0], jq['layers']['moe'])
        jout, _ = jllama._moe_block(jnp.asarray(x), jlp, jc, DEFAULT_RULES)
        jout = np.asarray(jout)
        for tree in (tq, carried):
            tlp = {k: v[0] for k, v in tree['layers']['moe'].items()}
            with torch.no_grad():
                tout, _ = tllama._moe_block(torch.from_numpy(x), tlp, tc)
            rel = np.linalg.norm(tout.numpy() - jout) / np.linalg.norm(jout)
            assert rel < 1e-4, (dispatch, rel)


def test_quantize_keeps_experts_fp_by_default():
    """The twin of tests/test_quant.py:68: plain quantization leaves the
    experts fp and quantizes the attention; ``quantize_moe`` quantizes
    the experts and keeps the router fp."""
    cfg = tconfig.get_model_config('tiny-moe')
    params = tllama.init_params(0, cfg, device='cpu')
    default = tquant.quantize_params(params)
    assert isinstance(default['layers']['moe']['wi_gate'], torch.Tensor)
    assert isinstance(default['layers']['attn']['wq'], tquant.QTensor)
    opted = tquant.quantize_params(params, quantize_moe=True)
    assert isinstance(opted['layers']['moe']['wi_gate'], tquant.QTensor)
    assert isinstance(opted['layers']['moe']['router'], torch.Tensor)
    assert tquant.param_bytes(opted) < tquant.param_bytes(default)


def test_serving_params_keep_the_router_fp32():
    cfg = tconfig.get_model_config('tiny-moe')
    params = tllama.init_params(0, cfg, device='cpu',
                                weight_dtype=torch.bfloat16)
    assert params['layers']['moe']['router'].dtype == torch.float32
    served = tdecode.serving_params(params, cfg)
    assert served['layers']['moe']['router'].dtype == torch.float32
    assert served['layers']['moe']['wi_gate'].dtype == torch.bfloat16


def test_pretrain_moe_dispatch_capacity(capsys):
    """``pretrain --model tiny-moe --moe-dispatch capacity`` on the CPU
    trains: finite losses, one JSON line per --log-every."""
    assert tpretrain.main(['--model', 'tiny-moe', '--moe-dispatch',
                           'capacity', '--capacity-factor', '1.0',
                           '--device', 'cpu', '--steps', '2', '--batch',
                           '2', '--seq', '32', '--log-every', '1',
                           '--warmup-steps', '1']) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x['step'] for x in lines[:2]] == [1, 2]
    assert all(np.isfinite(x['loss']) for x in lines[:2])
    assert lines[-1] == {'done': True, 'final_step': 2}


@pytest.mark.parametrize('name', ['deepseek-moe-16b', 'gpt-oss-20b',
                                  'mixtral-8x7b'])
def test_large_moe_configs_build_with_reference_shapes(name, monkeypatch):
    """``init_params`` under a fake-tensor mode (shapes and dtypes only;
    the draws are skipped) gives the reference's leaf names and shapes
    (``jax.eval_shape`` of its init), and ``convert`` expects the same."""
    jcfg = jconfig.get_model_config(name)
    ref = jax.eval_shape(lambda k: jllama.init_params(k, jcfg),
                         jax.random.key(0))
    ref = {jax.tree_util.keystr(p): tuple(leaf.shape)
           for p, leaf in jax.tree_util.tree_leaves_with_path(ref)}
    tcfg = tconfig.get_model_config(name)
    monkeypatch.setattr(torch.nn.init, 'trunc_normal_',
                        lambda t, **kwargs: t)
    with FakeTensorMode():
        params = tllama.init_params(0, tcfg, device='cpu',
                                    weight_dtype=torch.bfloat16)
    got = {jax.tree_util.keystr(p): tuple(leaf.shape)
           for p, leaf in jax.tree_util.tree_leaves_with_path(params)}
    assert got == ref
    expected = {"['" + k.replace('/', "']['") + "']": v
                for k, v in convert._expected_shapes(tcfg).items()}
    assert expected == ref
    moe = params['layers']['moe']
    assert moe['router'].dtype == torch.float32
    assert moe['wi_gate'].dtype == torch.bfloat16


def test_tiny_moe_converts_both_ways():
    """A JAX TINY_MOE tree carries across and back bit for bit, with its
    ``moe`` subtree and no ``mlp``; a missing expert leaf is refused."""
    jcfg, tcfg = _configs()
    jparams, tparams = _params(jcfg, tcfg, seed=13)
    assert 'mlp' not in tparams['layers']
    back = convert.params_to_numpy(tparams)
    for path, leaf in jax.tree_util.tree_leaves_with_path(jparams):
        got = back
        for key in path:
            got = got[key.key]
        np.testing.assert_array_equal(got, np.asarray(leaf))
    tree = jax.tree.map(np.asarray, jparams)
    del tree['layers']['moe']['wo']
    with pytest.raises(KeyError, match='lack'):
        convert.params_from_numpy(tree, tcfg, device='cpu')
