"""The port's GRPO learner and driver (``skypilot_tpu_torch/train/grpo.py``)
against the reference's (``skypilot_tpu/train/grpo.py``), and the
continuous engine's live weight refresh under a learner.

TINY at fp32 compute on the CPU, params carried over by
``models/convert.py``, inputs drawn from numpy seeds:

* ``reward_fn`` exactly; ``grpo_advantages`` within 1e-6, an all-equal
  group included (0, not NaN: the population std, as ``jnp.std``).
* The GRPO loss and every gradient against ``jax.value_and_grad`` of the
  reference's ``loss_fn`` within 1e-5; losses and params after 3 learner
  steps (``optax.adamw`` at its defaults) within 1e-5.
* A learner step and a full refresh of the engine give the greedy tokens
  of a JAX engine refreshed after the same JAX step.
* The engine owns its weights: a learner step in place with no refresh
  leaves the served leaves and greedy tokens as they were; a queued
  refresh serves the weights as they were when it was requested; a full
  refresh into a bf16 engine equals ``serving_params`` of the tree bit
  for bit; shape, path and W8A8 mismatches raise and leave the version.
* The driver: ``main`` runs and resumes (the twin of
  ``tests/test_train_drivers.py``'s GRPO resume test), on both rollout
  backends.
"""
import inspect
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from skypilot_tpu.inference.continuous import (
    ContinuousBatchingEngine as JaxEngine)
from skypilot_tpu.models.config import get_model_config as jax_config
from skypilot_tpu.train import grpo as jgrpo
from skypilot_tpu_torch.inference.continuous import (
    ContinuousBatchingEngine as TorchEngine, flatten_param_paths)
from skypilot_tpu_torch.models import convert, decode
from skypilot_tpu_torch.models.config import get_model_config as torch_config
from skypilot_tpu_torch.train import grpo
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

# The reference driver's default rate. Adam divides each gradient by its
# own running RMS, so on the few entries whose gradient is near eps
# (1e-8) the fp32 rounding of two summation orders moves the update by up
# to ~1e-2 of the rate: at 1e-2 that is 1.2e-4 on 3 of lm_head's 32768
# entries after 3 steps, at this rate ~1e-6.
LR = 1e-4
P, G, L, N = 2, 4, 6, 5
PROMPTS = [[5, 9, 42, 7, 11, 3], [2, 8, 19, 21, 4, 6], [13, 17, 23, 29]]
KW = dict(max_slots=4, max_len=32)


def _tcfg(**kw):
    return torch_config('tiny', compute_dtype=torch.float32, **kw)


def _jcfg():
    return jax_config('tiny', compute_dtype=jnp.float32)


def _batch(seed):
    """One rollout batch: tiled prompts [P*G, L], generated [P*G, N]
    and rewards [P*G] (one group of equal rewards)."""
    rng = np.random.default_rng(seed)
    prompts = np.repeat(rng.integers(3, 512, (P, L)), G, axis=0)
    generated = rng.integers(0, 512, (P * G, N))
    rewards = rng.random(P * G).astype(np.float32)
    rewards[:G] = 0.25
    return (prompts.astype(np.int32), generated.astype(np.int32),
            rewards)


def _assert_tree_close(port, ref, atol):
    flat = flatten_param_paths(port)
    ref_flat = flatten_param_paths(ref)
    assert set(flat) == set(ref_flat)
    for path, leaf in flat.items():
        np.testing.assert_allclose(leaf.detach().numpy(),
                                   np.asarray(ref_flat[path]), rtol=0,
                                   atol=atol, err_msg=path)


@pytest.fixture(scope='module')
def learners():
    """A JAX learner and a port learner on the JAX learner's initial
    params (fresh AdamW state)."""
    jl = jgrpo.GrpoLearner(_jcfg(), learning_rate=LR, seed=3)
    tl = grpo.GrpoLearner(_tcfg(), learning_rate=LR, device='cpu')
    start = convert.params_from_numpy(jax.tree.map(np.asarray, jl.params),
                                      _tcfg(), device='cpu')
    with torch.no_grad():
        for path, leaf in flatten_param_paths(tl.params).items():
            leaf.copy_(flatten_param_paths(start)[path])
    return jl, tl


def test_reward_fn_exact():
    rng = np.random.default_rng(0)
    generated = rng.integers(0, 6, (12, 9)).astype(np.int32)
    targets = rng.integers(0, 6, (12,)).astype(np.int32)
    want = np.asarray(jgrpo.reward_fn(jnp.asarray(generated),
                                      jnp.asarray(targets)))
    got = grpo.reward_fn(torch.as_tensor(generated),
                         torch.as_tensor(targets)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('group_size', [2, 4, 8])
def test_grpo_advantages_match_population_std(group_size):
    rng = np.random.default_rng(group_size)
    rewards = rng.random(4 * group_size).astype(np.float32)
    rewards[:group_size] = 0.5    # an all-equal group
    want = np.asarray(jgrpo.grpo_advantages(jnp.asarray(rewards),
                                            group_size))
    got = grpo.grpo_advantages(torch.as_tensor(rewards),
                               group_size).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.all(np.isfinite(got)) and np.all(got[:group_size] == 0.0)


def test_make_prompts_cue_is_last_token():
    prompts, cues = grpo.make_prompts(42, 16, 8, 512)
    assert prompts.shape == (16, 8) and prompts.dtype == torch.int32
    assert torch.equal(cues, prompts[:, -1])
    assert int(prompts.min()) >= 3 and int(prompts.max()) < 512
    again, _ = grpo.make_prompts(42, 16, 8, 512)
    assert torch.equal(prompts, again)


def test_loss_and_every_gradient_match_jax():
    jcfg, tcfg = _jcfg(), _tcfg()
    jparams = jax.tree.map(
        np.asarray, jgrpo.GrpoLearner(jcfg, seed=7).params)
    prompts, generated, rewards = _batch(1)
    tokens = np.concatenate([prompts, generated], axis=1)
    gen_mask = np.concatenate([np.zeros_like(prompts),
                               np.ones_like(generated)], axis=1)
    adv = np.asarray(jgrpo.grpo_advantages(jnp.asarray(rewards), G))
    # The reference's own loss, from its step's closure.
    step = jgrpo.make_grpo_step(jcfg, optax.adamw(LR))
    loss_fn = inspect.getclosurevars(step.__wrapped__).nonlocals['loss_fn']
    (jloss, (jlp,)), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, jparams), jnp.asarray(tokens),
        jnp.asarray(gen_mask), jnp.asarray(adv))
    params = convert.params_from_numpy(jparams, tcfg, device='cpu')
    leaves = list(flatten_param_paths(params).values())
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss, mean_lp = grpo.grpo_loss(params, torch.as_tensor(tokens),
                                   torch.as_tensor(gen_mask),
                                   torch.as_tensor(adv.copy()), tcfg)
    grads = torch.autograd.grad(loss, leaves)
    loss, mean_lp = float(loss.detach()), float(mean_lp.detach())
    assert abs(loss - float(jloss)) <= 1e-5 * max(1, abs(float(jloss)))
    assert abs(mean_lp - float(jlp)) <= 1e-5 * abs(float(jlp))
    jflat = flatten_param_paths(jgrads)
    for path, grad in zip(flatten_param_paths(params), grads):
        np.testing.assert_allclose(grad.numpy(), np.asarray(jflat[path]),
                                   rtol=0, atol=1e-5, err_msg=path)


def test_three_learner_steps_match_jax(learners):
    jl, tl = learners
    for seed in range(3):
        batch = _batch(10 + seed)
        want = jl.learn_rollouts(*batch, G)
        got = tl.learn_rollouts(*batch, G)
        for key in ('loss', 'mean_logprob', 'mean_reward'):
            assert abs(got[key] - want[key]) <= 1e-5 * max(1, abs(want[key]))
    assert tl.version == jl.version == 3
    _assert_tree_close(tl.params, jl.params, 1e-5)
    # AdamW moments too.
    _assert_tree_close(tl.state.opt_state['mu'], jl.state.opt_state[0].mu,
                       1e-5)


def test_refreshed_engine_matches_jax_refreshed_engine(learners):
    """One more learner step on each side, then a full refresh of an
    engine built before the step: the port engine's greedy tokens are
    the JAX engine's."""
    jl, tl = learners
    jeng = JaxEngine('tiny', cfg=_jcfg(), params=jl.params, **KW)
    teng = TorchEngine('tiny', cfg=_tcfg(), params=tl.params,
                       device='cpu', **KW)
    try:
        before = [teng.generate_ids(p, max_new_tokens=8) for p in PROMPTS]
        assert before == [jeng.generate_ids(p, max_new_tokens=8)
                          for p in PROMPTS]
        batch = _batch(20)
        jl.learn_rollouts(*batch, G)
        tl.learn_rollouts(*batch, G)
        assert jeng.refresh_weights(params=jl.params,
                                    version=jl.version) == jl.version
        assert teng.refresh_weights(params=tl.params,
                                    version=tl.version) == tl.version
        want = [jeng.generate_ids(p, max_new_tokens=8) for p in PROMPTS]
        assert [teng.generate_ids(p, max_new_tokens=8)
                for p in PROMPTS] == want
        stats = teng.stats()
        assert stats['policy_version'] == tl.version
        assert stats['weight_refreshes'] == 1
        assert stats['refresh_shards'] == len(flatten_param_paths(
            tl.params))
    finally:
        jeng.shutdown()
        teng.shutdown()


def _snapshot(engine):
    return {p: t.clone() for p, t in flatten_param_paths(
        engine.params).items()}


def _assert_leaves(engine, want):
    for path, leaf in flatten_param_paths(engine.params).items():
        assert torch.equal(leaf, want[path]), path


def test_engine_weights_do_not_alias_the_learner():
    """At fp32 compute on the CPU ``serving_params`` would hand the engine
    every learner tensor itself; the engine copies them, so a learner
    step in place with no refresh changes nothing it serves."""
    learner = grpo.GrpoLearner(_tcfg(), learning_rate=LR, device='cpu')
    engine = TorchEngine('tiny', cfg=_tcfg(), params=learner.params,
                         device='cpu', **KW)
    try:
        ours = {t.untyped_storage().data_ptr()
                for t in flatten_param_paths(engine.params).values()}
        theirs = {t.untyped_storage().data_ptr()
                  for t in flatten_param_paths(learner.params).values()}
        assert not ours & theirs
        tokens = [engine.generate_ids(p, max_new_tokens=8) for p in PROMPTS]
        leaves = _snapshot(engine)
        learner.learn_rollouts(*_batch(30), G)
        _assert_leaves(engine, leaves)
        assert engine.policy_version == 0
        assert [engine.generate_ids(p, max_new_tokens=8)
                for p in PROMPTS] == tokens
    finally:
        engine.shutdown()


def test_queued_refresh_serves_the_weights_it_was_requested_with():
    """A drain refresh waits for an in-flight request; the learner's
    params change in place meanwhile. The engine must end on the
    weights as they were at the request, under that version."""
    learner = grpo.GrpoLearner(_tcfg(), learning_rate=LR, device='cpu')
    engine = TorchEngine('tiny', cfg=_tcfg(), params=learner.params,
                         device='cpu', max_slots=2, max_len=128)
    try:
        asked = {p: t.detach().clone()
                 for p, t in flatten_param_paths(learner.params).items()}
        busy = engine.submit_ids(PROMPTS[0], max_new_tokens=100)
        # A drain refresh waits only while a slot is occupied (the
        # engine's rule, the reference's): request it once busy holds
        # one, its first token out.
        deadline = time.monotonic() + 60
        while not busy.generated and time.monotonic() < deadline:
            time.sleep(0.001)
        assert busy.generated
        ticket = engine.request_refresh(params=learner.params, version=7,
                                        mode='drain')
        with torch.no_grad():
            for leaf in flatten_param_paths(learner.params).values():
                leaf.add_(1.0)
        assert ticket.done.wait(60) and ticket.error is None
        assert busy.done.is_set() and len(busy.generated) == 100
        assert busy.policy_version == 0
        assert engine.policy_version == 7
        _assert_leaves(engine, asked)
        later = engine.submit_ids(PROMPTS[1], max_new_tokens=2)
        assert later.done.wait(60) and later.policy_version == 7
    finally:
        engine.shutdown()


def test_full_refresh_rounds_as_serving_params():
    """A bf16-compute engine: fp32 learner leaves are rounded to bf16 by
    the refresh exactly as ``serving_params`` rounds them (norm scales
    stay fp32), dtypes and shapes kept."""
    cfg = torch_config('tiny')            # bf16 compute
    learner = grpo.GrpoLearner(cfg, learning_rate=LR, device='cpu')
    engine = TorchEngine('tiny', cfg=cfg, device='cpu', seed=5, **KW)
    try:
        dtypes = {p: t.dtype for p, t in flatten_param_paths(
            engine.params).items()}
        assert engine.refresh_weights(params=learner.params) == 1
        with torch.no_grad():
            want = flatten_param_paths(decode.serving_params(
                learner.params, cfg))
        for path, leaf in flatten_param_paths(engine.params).items():
            assert leaf.dtype == dtypes[path] == want[path].dtype, path
            assert torch.equal(leaf, want[path]), path
        assert dtypes['layers/attn/wq'] == torch.bfloat16
        assert dtypes['final_norm/scale'] == torch.float32
    finally:
        engine.shutdown()


def test_refresh_rejects_bad_shapes_paths_and_quantized_leaves():
    engine = TorchEngine('tiny', cfg=_tcfg(), device='cpu', **KW)
    quant = TorchEngine('tiny', cfg=_tcfg(), device='cpu', quantize=True,
                        **KW)
    try:
        leaves = _snapshot(engine)
        wq = leaves['layers/attn/wq']
        with pytest.raises(ValueError, match='shape'):
            engine.refresh_weights({'layers/attn/wq': wq[:1]})
        with pytest.raises(KeyError):
            engine.refresh_weights({'layers/attn/nope': wq})
        partial = {p: t for p, t in leaves.items() if 'embed' not in p}
        with pytest.raises(KeyError):
            engine.refresh_weights(params=partial)
        with pytest.raises(ValueError, match='exactly one'):
            engine.refresh_weights()
        with pytest.raises(ValueError, match='mode'):
            engine.refresh_weights({'layers/attn/wq': wq}, mode='hot')
        assert engine.policy_version == 0
        _assert_leaves(engine, leaves)
        with pytest.raises(TypeError, match='int8'):
            quant.refresh_weights({'layers/attn/wq': wq.numpy()})
        assert quant.policy_version == 0
        # A numpy shard of the right shape lands (the store's path).
        assert engine.refresh_weights(
            {'layers/attn/wq': (wq * 2).numpy()}, version=4) == 4
        assert torch.equal(engine.params['layers']['attn']['wq'], wq * 2)
    finally:
        engine.shutdown()
        quant.shutdown()


def _lines(out):
    return [json.loads(x) for x in out.splitlines() if x.startswith('{')]


def _argv(ckpt, steps, every, *extra):
    return ['--model', 'tiny', '--steps', str(steps), '--prompts-per-step',
            '2', '--group-size', '4', '--prompt-len', '6',
            '--max-new-tokens', '4', '--checkpoint-dir', ckpt,
            '--checkpoint-every', str(every), '--log-every', '2',
            '--device', 'cpu', *extra]


def test_grpo_runs_and_resumes(tmp_path, capsys):
    """The driver's contract (managed-job recovery): the run's lines,
    rewards in [0, 1], a relaunch that continues from the saved step
    and restores the learner bitwise."""
    ckpt = str(tmp_path / 'gr')
    assert grpo.main(_argv(ckpt, 4, 4)) == 0
    lines = _lines(capsys.readouterr().out)
    steps = [x for x in lines if 'mean_reward' in x]
    assert [x['step'] for x in steps] == [2, 4]
    assert all(0.0 <= x['mean_reward'] <= 1.0 for x in steps)
    assert all(x['rollout_s'] > 0 and x['learn_s'] > 0 for x in steps)
    assert lines[-1] == {'done': True, 'final_step': 4}
    saved = grpo.GrpoLearner(torch_config('tiny'), checkpoint_dir=ckpt,
                             device='cpu')
    assert saved.resumed_from == 4 and saved.state.opt_state['count'] == 4

    assert grpo.main(_argv(ckpt, 6, 2)) == 0
    lines = _lines(capsys.readouterr().out)
    assert lines[0] == {'resumed_from_step': 4}
    assert [x['step'] for x in lines if 'loss' in x] == [6]
    assert lines[-1] == {'done': True, 'final_step': 6}


def test_grpo_loop_backend(capsys):
    out = grpo.run(grpo.parse_args([
        '--model', 'tiny', '--steps', '2', '--prompts-per-step', '2',
        '--group-size', '2', '--prompt-len', '4', '--max-new-tokens', '3',
        '--log-every', '1', '--rollout-backend', 'loop', '--device',
        'cpu']))
    assert out['engine'] is None and out['learner'].version == 2
    lines = _lines(capsys.readouterr().out)
    assert [x['step'] for x in lines if 'loss' in x] == [1, 2]
    assert all(x['refresh_s'] == 0.0 for x in lines if 'loss' in x)
