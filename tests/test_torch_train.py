"""Port training path against the JAX reference on the CPU: the FLOP
accounting, the loss, the schedule, AdamW and Adafactor against optax,
the model forward, the train step under every remat policy and both
optimizers.

Inputs and batches come from seeded numpy; JAX parameters are carried
over with ``models/convert.py``. The model runs TINY with head_dim 128
(so both sides reach the flash kernel's gate; the JAX side runs its
Pallas kernels in the interpreter) at fp32 compute. Tolerances: loss and
logits 1e-5 relative / 2e-5 absolute (sums in another order); AdamW
updates 1e-6; Adafactor at fp32 1e-6 relative (statistics per element,
params to their leaf's largest magnitude: ``0.9 p - u`` cancels near
zero), at bf16 bitwise; params after three train steps 1e-5.
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from skypilot_tpu.models import config as jconfig
from skypilot_tpu.models import llama as jllama
from skypilot_tpu.train import loss as jloss
from skypilot_tpu.train import step as jstep
from skypilot_tpu_torch.models import config as tconfig
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models import llama as tllama
from skypilot_tpu_torch.train import loss as tloss
from skypilot_tpu_torch.train import pretrain as tpretrain
from skypilot_tpu_torch.train import step as tstep
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

B, S = 2, 128


@pytest.mark.parametrize('seq', [1024, 2048])
def test_flops_per_token_matches_jax(seq):
    for name in jconfig.list_models():
        assert (tconfig.get_model_config(name).flops_per_token(seq) ==
                jconfig.get_model_config(name).flops_per_token(seq)), name


@pytest.mark.parametrize('z_loss', [0.0, 1e-4])
def test_cross_entropy_matches_jax(z_loss):
    rng = np.random.RandomState(0)
    logits = rng.randn(2, 5, 33).astype(np.float32) * 4
    targets = rng.randint(0, 33, (2, 5)).astype(np.int32)
    weights = (rng.rand(2, 5) > 0.3).astype(np.float32)
    for w in (None, weights):
        ref, ref_w = jloss.cross_entropy_loss(
            jnp.asarray(logits), jnp.asarray(targets),
            None if w is None else jnp.asarray(w), z_loss_coeff=z_loss)
        out, out_w = tloss.cross_entropy_loss(
            torch.from_numpy(logits), torch.from_numpy(targets),
            None if w is None else torch.from_numpy(w),
            z_loss_coeff=z_loss)
        np.testing.assert_allclose(out.item(), float(ref), rtol=1e-6)
        assert out_w.item() == float(ref_w)


@pytest.mark.parametrize('warmup,total', [(5, 20), (0, 8), (3, 3)])
def test_schedule_matches_optax(warmup, total):
    hp = tstep.TrainHParams(learning_rate=1e-3, warmup_steps=warmup,
                            total_steps=total)
    ref = optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=1e-3, warmup_steps=warmup,
        decay_steps=max(total, warmup + 1), end_value=1e-4)
    ours = tstep.make_optimizer(hp).schedule
    for count in range(total + 4):
        np.testing.assert_allclose(ours(count), float(ref(count)),
                                   rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize('scale', [0.01, 10.0], ids=['unclipped',
                                                     'clipped'])
def test_adamw_updates_match_optax(scale):
    """Five updates of a small params dict; large grads trigger the
    global-norm clip."""
    rng = np.random.RandomState(1)
    params = {'a': {'w': rng.randn(3, 4).astype(np.float32)},
              'b': rng.randn(5).astype(np.float32)}
    hp = tstep.TrainHParams(learning_rate=1e-2, warmup_steps=2,
                            total_steps=6)
    jopt = jstep.make_optimizer(dataclasses.replace(hp))
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init(jparams)
    tparams = {'a': {'w': torch.from_numpy(params['a']['w'].copy())},
               'b': torch.from_numpy(params['b'].copy())}
    topt = tstep.make_optimizer(hp)
    tstate = topt.init(tparams)
    for i in range(5):
        grads = {'a': {'w': rng.randn(3, 4).astype(np.float32) * scale},
                 'b': rng.randn(5).astype(np.float32) * scale}
        updates, jstate = jopt.update(jax.tree.map(jnp.asarray, grads),
                                      jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        tgrads = [torch.from_numpy(grads['a']['w']),
                  torch.from_numpy(grads['b'])]
        tstate, norm = topt.update_(tparams, tgrads, tstate)
        np.testing.assert_allclose(norm.item(),
                                   float(optax.global_norm(grads)),
                                   rtol=1e-6)
        np.testing.assert_allclose(tparams['a']['w'].numpy(),
                                   np.asarray(jparams['a']['w']),
                                   atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(tparams['b'].numpy(),
                                   np.asarray(jparams['b']), atol=1e-6,
                                   rtol=1e-6)


_ADAFACTOR_LEAVES = {'a': (2, 128, 4, 32), 'b': (2, 128, 128),
                     'c': (512, 128), 'd': (2, 128), 'e': (7,)}


def _adafactor_pair(dtype):
    hp = dict(learning_rate=1e-2, warmup_steps=1, total_steps=6,
              optimizer='adafactor')
    return (jstep.make_optimizer(jstep.TrainHParams(**hp)),
            tstep.make_optimizer(tstep.TrainHParams(**hp)))


def _check_adafactor(jparams, jstate, tparams, tstate, dtype):
    factored = jstate[1][0]
    assert tstate['count'] == int(factored.count)
    for key in sorted(_ADAFACTOR_LEAVES):
        got = tparams[key].float().numpy()
        ref = np.asarray(jparams[key], np.float32)
        if dtype == 'bfloat16':
            np.testing.assert_array_equal(got, ref, err_msg=key)
        else:
            np.testing.assert_allclose(
                got, ref, rtol=0, atol=1e-6 * np.abs(ref).max(),
                err_msg=key)
        for name in ('v_row', 'v_col', 'v'):
            got = tstate[name][key]
            ref = np.asarray(getattr(factored, name)[key], np.float32)
            assert got.dtype == getattr(torch, dtype)
            assert tuple(got.shape) == ref.shape, (name, key)
            if dtype == 'bfloat16':
                np.testing.assert_array_equal(got.float().numpy(), ref,
                                              err_msg=f'{name} {key}')
            else:
                np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6,
                                           err_msg=f'{name} {key}')


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('carry', [False, True],
                         ids=['from_init', 'optax_state_carried'])
def test_adafactor_updates_match_optax(dtype, carry):
    """Three updates of factored ([2,128,4,32] over dims 1 and 3,
    [2,128,128], [512,128]) and unfactored ([2,128], [7]) leaves, the
    second one clipped by the global norm. With ``carry``, the first
    update runs in optax only and its params and ``FactoredState`` are
    carried into the port's state by name."""
    rng = np.random.RandomState(2)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    params = {k: (rng.randn(*s) * 0.05).astype(np.float32)
              for k, s in _ADAFACTOR_LEAVES.items()}
    jopt, topt = _adafactor_pair(dtype)
    jparams = {k: jnp.asarray(v, jdt) for k, v in params.items()}
    jstate = jopt.init(jparams)
    for i in range(3):
        scale = 10.0 if i == 1 else 0.01
        grads = {k: (rng.randn(*s) * scale).astype(np.float32)
                 for k, s in _ADAFACTOR_LEAVES.items()}
        jgrads = {k: jnp.asarray(v, jdt) for k, v in grads.items()}
        if i == int(carry):
            tparams = {k: torch.from_numpy(np.array(v, np.float32)).to(tdt)
                       for k, v in jparams.items()}
            tstate = topt.init(tparams)
            if carry:
                factored = jstate[1][0]
                tstate['count'] = int(factored.count)
                for name in ('v_row', 'v_col', 'v'):
                    for k, v in getattr(factored, name).items():
                        tstate[name][k].copy_(torch.from_numpy(
                            np.array(v, np.float32)))
        updates, jstate = jopt.update(jgrads, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        if i < int(carry):
            continue
        tstate, norm = topt.update_(
            tparams, [torch.from_numpy(grads[k]).to(tdt)
                      for k in sorted(grads)], tstate)
        np.testing.assert_allclose(norm.float().item(),
                                   float(optax.global_norm(jgrads)),
                                   rtol=1e-6)
        _check_adafactor(jparams, jstate, tparams, tstate, dtype)


def test_adafactor_factors_like_optax():
    """Every leaf of bench-1b7 (shapes only) is factored over the dims
    optax picks, with its statistics' shapes; TINY factors none."""
    from optax._src import factorized
    for name in ('bench-1b7', 'tiny'):
        shapes = jax.eval_shape(functools.partial(
            jllama.init_params, cfg=jconfig.get_model_config(name)),
            jax.random.key(0))
        for path, leaf in jax.tree_util.tree_leaves_with_path(shapes):
            assert tstep.factored_dims(leaf.shape) == \
                factorized._factored_dims(leaf.shape, True, 128), path
        if name == 'tiny':
            assert all(tstep.factored_dims(x.shape) is None
                       for x in jax.tree.leaves(shapes))
    dims = {'wq': (3, 1), 'wo': (2, 3)}
    for key, want in dims.items():
        shape = jax.eval_shape(functools.partial(
            jllama.init_params, cfg=jconfig.get_model_config('bench-1b7')),
            jax.random.key(0))['layers']['attn'][key].shape
        assert tstep.factored_dims(shape) == want


def test_adafactor_weight_decay_is_not_scaled_by_lr():
    """With zero gradients the update is the weight decay alone, added
    after the learning rate: every param shrinks by 10% a step (bf16:
    1.0 -> 0.8984)."""
    for dtype, want in ((torch.float32, 0.9), (torch.bfloat16, 0.8984375)):
        params = {'w': torch.ones((3, 4), dtype=dtype)}
        opt = tstep.make_optimizer(tstep.TrainHParams(
            optimizer='adafactor', learning_rate=1e-6))
        state = opt.init(params)
        opt.update_(params, [torch.zeros_like(params['w'])], state)
        assert torch.all(params['w'] == want)


def _configs(**overrides):
    jcfg = jconfig.get_model_config('tiny', head_dim=128,
                                    compute_dtype=jnp.float32,
                                    attention_impl='pallas', **overrides)
    tcfg = tconfig.get_model_config('tiny', head_dim=128,
                                    compute_dtype=torch.float32,
                                    attention_impl='pallas', **overrides)
    return jcfg, tcfg


def _params(jcfg, tcfg, seed=0):
    jparams = jllama.init_params(jax.random.key(seed), jcfg)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        tcfg, device='cpu')
    return jparams, tparams


def _batch(seed, vocab, segments=False):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, vocab, (B, S)).astype(np.int32)
    batch = {'tokens': tokens, 'targets': np.roll(tokens, -1, axis=1),
             'weights': (rng.rand(B, S) > 0.1).astype(np.float32)}
    if segments:
        batch['segments'] = np.stack(
            [np.cumsum(rng.rand(S) < 0.03) for _ in range(B)]
        ).astype(np.int32)
        batch['positions'] = np.stack(
            [np.arange(S) + 7 * i for i in range(B)]).astype(np.int32)
    return batch


@pytest.mark.parametrize('variant', ['plain', 'segments', 'hidden',
                                     'tied'])
def test_forward_matches_jax(variant):
    overrides = {'tie_embeddings': True} if variant == 'tied' else {}
    jcfg, tcfg = _configs(**overrides)
    jparams, tparams = _params(jcfg, tcfg, seed=2)
    batch = _batch(3, jcfg.vocab_size, segments=variant == 'segments')
    kwargs = {'return_hidden': variant == 'hidden'}
    jkw, tkw = dict(kwargs), dict(kwargs)
    for key in ('positions', 'segments'):
        if key in batch:
            jkw[key] = jnp.asarray(batch[key])
            tkw[key] = torch.from_numpy(batch[key])
    ref = jllama.forward(jparams, jnp.asarray(batch['tokens']), jcfg, **jkw)
    with torch.no_grad():
        out = tllama.forward(tparams, torch.from_numpy(batch['tokens']),
                             tcfg, **tkw)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=1e-5)


@pytest.mark.parametrize('remat,optimizer', [
    ('none', 'adamw'), ('full', 'adamw'), ('save_attn', 'adamw'),
    ('save_dots', 'adamw'), ('dots', 'adamw'), ('full', 'adafactor')],
    ids=['none', 'full', 'save_attn', 'save_dots', 'dots',
         'full-adafactor'])
def test_train_steps_match_jax(remat, optimizer):
    """Three steps with warmup 1 (so the weights move from step 2 on):
    loss, grad norm and the params after. The Adafactor case widens
    TINY to d_model 128, d_ff 256 so that its leaves are factored."""
    widths = ({'d_model': 128, 'd_ff': 256} if optimizer == 'adafactor'
              else {})
    jcfg, tcfg = _configs(remat_policy=remat, **widths)
    jparams, tparams = _params(jcfg, tcfg, seed=4)
    hp = tstep.TrainHParams(warmup_steps=1, total_steps=10,
                            optimizer=optimizer)
    jhp = jstep.TrainHParams(warmup_steps=1, total_steps=10,
                             optimizer=optimizer)
    jopt = jstep.make_optimizer(jhp)
    jstate = jstep.TrainState(step=jnp.zeros((), jnp.int32),
                              params=jparams, opt_state=jopt.init(jparams))
    jfn = jax.jit(functools.partial(jstep.train_step_fn, cfg=jcfg,
                                    optimizer=jopt, hp=jhp))
    tstate = tstep.create_train_state_from_params(tparams, tcfg, hp)
    tfn = tstep.make_train_step(tcfg, hp)
    for i in range(3):
        batch = _batch(10 + i, jcfg.vocab_size, segments=i == 2)
        jstate, jm = jfn(jstate, jax.tree.map(jnp.asarray, batch))
        tstate, tm = tfn(tstate, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
        np.testing.assert_allclose(tm['loss'].item(), float(jm['loss']),
                                   rtol=1e-5)
        np.testing.assert_allclose(tm['grad_norm'].item(),
                                   float(jm['grad_norm']), rtol=1e-4)
        assert tm['step'] == int(jm['step']) == i
        assert tm['router_aux'].item() == 0.0
    ref = jax.tree_util.tree_leaves_with_path(jstate.params)
    got = dict(jax.tree_util.tree_leaves_with_path(
        convert.params_to_numpy(tstate.params)))
    for path, leaf in ref:
        np.testing.assert_allclose(got[path], np.asarray(leaf), atol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))


def test_pretrain_main_prints_json_lines(capsys):
    assert tpretrain.main(['--model', 'tiny', '--steps', '4',
                           '--device', 'cpu', '--batch', '2', '--seq',
                           '64', '--log-every', '2',
                           '--warmup-steps', '1']) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x['step'] for x in lines[:2]] == [2, 4]
    for line in lines[:2]:
        assert np.isfinite(line['loss'])
        assert line['tokens_per_sec'] > 0
        assert 'achieved_tflops' in line
    assert lines[-1] == {'done': True, 'final_step': 4}


def test_synthetic_batch_structure():
    batch = tpretrain.synthetic_batch(3, 2, 16, 100)
    tokens = batch['tokens']
    assert tokens.dtype == torch.int32 and tokens.shape == (2, 16)
    assert torch.equal(tokens[:, 1::2], tokens[:, 0::2])
    assert torch.equal(batch['targets'], torch.roll(tokens, -1, 1))
    again = tpretrain.synthetic_batch(3, 2, 16, 100)
    assert torch.equal(again['tokens'], tokens)


def test_file_batches(tmp_path):
    path = tmp_path / 'tokens.npy'
    np.save(path, np.arange(50, dtype=np.int32))
    it = tpretrain.file_batch_iterator(str(path), 2, 4)
    first = next(it)
    assert first['tokens'].tolist() == [[0, 1, 2, 3], [5, 6, 7, 8]]
    assert first['targets'].tolist() == [[1, 2, 3, 4], [6, 7, 8, 9]]


def test_unported_options_raise(monkeypatch, tmp_path):
    """A stage degree with seq or with expert trains one step through
    ``pretrain`` (its own four ranks); what the mesh step does not cover
    raises before any rank starts: heads that tensor does not divide and
    an expert degree that does not divide the experts; pipeline stages
    in the forward off the stage ranks. (A seq degree trains:
    ``tests/test_torch_train_mesh_seq.py``; an expert degree and MoE
    models on a mesh train: ``tests/test_torch_train_mesh_moe.py``, and
    under seq: ``tests/test_torch_train_mesh_moe_seq.py``; a stage
    degree trains: ``tests/test_torch_train_mesh_stage.py``, and with
    seq or expert: ``tests/test_torch_train_mesh_stage_seq.py``,
    ``tests/test_torch_train_mesh_stage_expert.py``.)"""
    monkeypatch.setenv('OMP_NUM_THREADS', '1')     # the spawned ranks'
    for argv in (['--mesh', 'stage=2,seq=2'],
                 ['--model', 'tiny-moe', '--mesh', 'stage=2,expert=2']):
        assert tpretrain.main(argv + ['--device', 'cpu', '--steps', '1',
                                      '--seq', '32']) == 0
    with pytest.raises(ValueError, match='does not divide'):
        tpretrain.main(['--mesh', 'tensor=4', '--device', 'cpu',
                        '--steps', '1'])
    with pytest.raises(ValueError, match='does not divide'):
        tpretrain.main(['--model', 'tiny-moe', '--mesh', 'expert=8',
                        '--device', 'cpu', '--steps', '1'])
    cfg = tconfig.get_model_config('tiny')
    params = tllama.init_params(0, cfg, device='cpu')
    tokens = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match='pass parallel='):
        tllama.forward(params, tokens, cfg, pipeline_stages=2)
    monkeypatch.setenv(tstep.RESIZE_SIGNAL_ENV, str(tmp_path / 'resize'))
    assert not tstep.resize_requested()
    (tmp_path / 'resize').touch()
    assert tstep.resize_requested()


@pytest.mark.parametrize('policy,saved', [
    ('save_attn', ['query_proj', 'key_proj', 'value_proj', 'attn_out']),
    ('save_dots', ['query_proj', 'key_proj', 'value_proj', 'attn_out',
                   'mlp_hidden', 'mlp_out']),
    ('dots', ['query_proj', 'key_proj', 'value_proj', 'attn_out', None,
              None, 'mlp_out'])])
def test_selective_remat_saves_what_the_reference_names(policy, saved,
                                                        monkeypatch):
    """The ops each policy saves in a layer's forward, by the name in
    force when they ran (``dots``: the seven weight products, two of
    them untagged gate/up), and the gradients equal the unrematerialized
    ones exactly."""
    records = []
    wrap = {'save_attn': '_save_only_these_names',
            'save_dots': '_save_only_these_names',
            'dots': '_dots_with_no_batch_dims'}[policy]
    inner = getattr(tllama, wrap)

    def recording(ctx, func, *args, **kwargs):
        decision = (inner(tllama.SAVED_NAMES[policy])
                    if wrap == '_save_only_these_names' else inner)(
                        ctx, func, *args, **kwargs)
        if decision == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE \
                and not ctx.is_recompute:
            records.append(getattr(tllama._tag, 'name', None))
        return decision

    monkeypatch.setattr(tllama, wrap,
                        (lambda names: recording)
                        if wrap == '_save_only_these_names' else recording)
    grads = {}
    for remat in ('none', policy):
        cfg = tconfig.get_model_config('tiny', head_dim=128,
                                       compute_dtype=torch.float32,
                                       remat_policy=remat)
        params = tllama.init_params(0, cfg, device='cpu')
        leaves = [x.requires_grad_(True) for x in tstep._leaves(params)]
        tokens = torch.from_numpy(
            np.random.RandomState(1).randint(0, 512, (2, 128)))
        loss = tllama.forward(params, tokens, cfg).square().mean()
        grads[remat] = torch.autograd.grad(loss, leaves)
    assert records == saved * cfg.n_layers
    for a, b in zip(grads['none'], grads[policy]):
        assert torch.equal(a, b)
