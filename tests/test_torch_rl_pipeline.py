"""The port's live-sync GRPO rollout pipeline
(``skypilot_tpu_torch/jobs/rl_pipeline.py``), the engine's live refresh
and the server's policy-store watcher, against the reference's.

Twins of ``tests/test_rl_pipeline.py`` on the port (TINY at fp32 compute
on the CPU, the JAX engine's weights carried over by
``models/convert.py``): the queue, file-queue, store and config cases;
delta refresh and drain; unknown shards; the ``infer.weights.refresh``
chaos site; the watcher; greedy rollouts equal to the JAX
``decode.generate`` on the same params; and one pipeline run with a
fault at each ``rl.*`` site that keeps the staleness bound, loses no
batch and refreshes live.

Across packages: the port's ``PolicyStore`` writes the reference's bytes
(every ``.npy`` and ``MANIFEST.skyt.json`` identical for the same
params), a JAX publish refreshes a port engine and a port publish a JAX
engine, and both give the JAX engine's greedy tokens. The distributed
roles hand batches over a ``FileBatchQueue``. Tolerance: none (token ids
and bytes are compared exactly).
"""
import contextlib
import os
import tempfile
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.inference.continuous import (
    ContinuousBatchingEngine as JaxEngine)
from skypilot_tpu.inference.continuous import (
    flatten_param_paths as jax_flatten)
from skypilot_tpu.jobs import rl_pipeline as jrl
from skypilot_tpu.models import decode as jdecode
from skypilot_tpu.models.config import get_model_config as jax_config
from skypilot_tpu_torch.inference import server as server_mod
from skypilot_tpu_torch.inference.continuous import (
    ContinuousBatchingEngine as TorchEngine, flatten_param_paths)
from skypilot_tpu_torch.jobs import rl_pipeline
from skypilot_tpu_torch.jobs.rl_pipeline import (FileBatchQueue,
                                                 PipelineConfig,
                                                 PolicyStore, RLPipeline,
                                                 RolloutBatch, RolloutQueue)
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models.config import get_model_config as torch_config
from skypilot_tpu_torch.server import metrics
from skypilot_tpu_torch.train import grpo
from skypilot_tpu_torch.utils import fault_injection
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

IDS = [5, 9, 42, 7]
PROMPTS = [[5, 9, 42, 7, 11, 3], [2, 8, 19, 21, 4, 6], [13, 17, 23, 29]]
KW = dict(max_slots=4, max_len=32)
DEADLINE_S = 20.0


@contextlib.contextmanager
def inject_faults(*clauses):
    """``SKYT_FAULT_SPEC`` for the block, the port's fault state reset on
    entry and exit."""
    spec = ','.join(clauses)
    fault_injection.parse_spec(spec)
    previous = os.environ.get(fault_injection.SPEC_ENV)
    os.environ[fault_injection.SPEC_ENV] = spec
    fault_injection.reset()
    try:
        yield
    finally:
        if previous is None:
            os.environ.pop(fault_injection.SPEC_ENV, None)
        else:
            os.environ[fault_injection.SPEC_ENV] = previous
        fault_injection.reset()


@pytest.fixture(autouse=True, scope='module')
def _fresh_metrics():
    metrics.reset_for_tests()
    yield
    metrics.reset_for_tests()


def _tcfg():
    return torch_config('tiny', compute_dtype=torch.float32)


def _jcfg():
    return jax_config('tiny', compute_dtype=jnp.float32)


def _batch(seq=0, rank=0, version=0, b=4, l=3, n=2):
    rng = np.random.default_rng(seq * 100 + rank)
    return RolloutBatch(
        prompts=rng.integers(0, 50, (b, l)).astype(np.int32),
        generated=rng.integers(0, 50, (b, n)).astype(np.int32),
        rewards=rng.random(b).astype(np.float32),
        group_size=2, policy_version=version, rank=rank, seq=seq)


# --------------------------------------------------------------------
# RolloutQueue / FileBatchQueue
# --------------------------------------------------------------------


def test_rollout_queue_fifo_and_conservation():
    q = RolloutQueue(capacity=3)
    batches = [_batch(seq=i) for i in range(3)]
    for b in batches:
        assert q.put(b, timeout=1)
    assert q.depth() == 3 and q.produced == 3
    first = q.pop(timeout=1)
    assert first is batches[0]
    assert q.depth() == 3          # in flight still counts
    q.ack(first)
    assert q.depth() == 2 and q.acked == 1
    assert q.unretired() == 2


def test_rollout_queue_requeue_goes_to_front():
    q = RolloutQueue(capacity=3)
    for i in range(3):
        q.put(_batch(seq=i), timeout=1)
    popped = q.pop(timeout=1)
    assert popped.seq == 0
    q.requeue(popped)
    assert q.pop(timeout=1).seq == 0
    assert q.requeued == 1


def test_rollout_queue_put_blocks_when_full():
    q = RolloutQueue(capacity=1)
    assert q.put(_batch(seq=0), timeout=1)
    assert not q.put(_batch(seq=1), timeout=0.05)   # backpressure
    q.ack(q.pop(timeout=1))
    assert q.put(_batch(seq=1), timeout=1)


def test_file_queue_roundtrip(tmp_path):
    q = FileBatchQueue(str(tmp_path), capacity=4)
    sent = _batch(seq=7, rank=2, version=3)
    assert q.put(sent, timeout=1)
    assert q.depth() == 1
    got = q.pop(timeout=1)
    np.testing.assert_array_equal(got.prompts, sent.prompts)
    np.testing.assert_array_equal(got.generated, sent.generated)
    np.testing.assert_array_equal(got.rewards, sent.rewards)
    assert (got.group_size, got.policy_version, got.rank, got.seq) == \
        (2, 3, 2, 7)
    assert q.depth() == 1
    q.ack(got)
    assert q.depth() == 0


def test_file_queue_orphaned_claim_is_reclaimed(tmp_path):
    q1 = FileBatchQueue(str(tmp_path), capacity=4)
    q1.put(_batch(seq=0, version=1), timeout=1)
    q1.put(_batch(seq=1, version=2), timeout=1)
    assert q1.pop(timeout=1).seq == 0
    del q1  # the learner dies without ack/requeue
    q2 = FileBatchQueue(str(tmp_path), capacity=4)
    first = q2.pop(timeout=1)
    assert first.seq == 0
    q2.requeue(first)
    again = q2.pop(timeout=1)
    assert again.seq == 0
    q2.ack(again)
    assert q2.pop(timeout=1).seq == 1


def test_file_queue_capacity_backpressure(tmp_path):
    q = FileBatchQueue(str(tmp_path), capacity=1)
    assert q.put(_batch(seq=0), timeout=1)
    assert not q.put(_batch(seq=1), timeout=0.1)


def test_file_queue_reads_the_reference_batches(tmp_path):
    """One hand-off directory for both packages: a batch either writes
    reads in the other."""
    sent = _batch(seq=3, rank=1, version=5)
    jrl.FileBatchQueue(str(tmp_path), 4).put(jrl.RolloutBatch(
        **{k: getattr(sent, k) for k in (
            'prompts', 'generated', 'rewards', 'group_size',
            'policy_version', 'rank', 'seq')}), timeout=1)
    got = FileBatchQueue(str(tmp_path), 4).pop(timeout=1)
    np.testing.assert_array_equal(got.generated, sent.generated)
    assert (got.policy_version, got.rank, got.seq) == (5, 1, 3)


# --------------------------------------------------------------------
# PolicyStore
# --------------------------------------------------------------------


def _toy_params():
    return {'head': {'w': np.arange(12, dtype=np.float32).reshape(3, 4)},
            'embed': np.ones((5, 4), np.float32),
            'layers': [{'w1': np.full((2, 2), 2.0, np.float32)},
                       {'w1': np.full((2, 2), 3.0, np.float32)}]}


def test_policy_store_delta_publish(tmp_path):
    store = PolicyStore(str(tmp_path))
    assert store.version() is None
    params = _toy_params()
    info = store.publish(params, version=0)
    assert info['shards_total'] == info['shards_written'] == 4
    assert store.version() == 0
    params['layers'][1]['w1'] = params['layers'][1]['w1'] + 1.0
    info = store.publish(params, version=1)
    assert info['shards_written'] == 1
    assert store.version() == 1


def test_policy_store_pull_is_incremental(tmp_path):
    store = PolicyStore(str(tmp_path))
    params = _toy_params()
    store.publish(params, version=0)
    dest = str(tmp_path / 'replica-0')
    pulled = store.pull(dest)
    assert pulled['version'] == 0
    assert set(pulled['updates']) == {
        'head/w', 'embed', 'layers/0/w1', 'layers/1/w1'}
    np.testing.assert_array_equal(pulled['updates']['embed'],
                                  params['embed'])
    params['embed'] = params['embed'] * 2.0
    store.publish(params, version=1)
    pulled = store.pull(dest)
    assert pulled['version'] == 1
    assert list(pulled['updates']) == ['embed']
    assert pulled['shards_pulled'] == 1
    np.testing.assert_array_equal(pulled['updates']['embed'],
                                  params['embed'])


def test_pipeline_config_from_env(monkeypatch):
    monkeypatch.setenv('SKYT_RL_FLEET', '5')
    monkeypatch.setenv('SKYT_RL_MAX_STALENESS', '7')
    monkeypatch.setenv('SKYT_RL_QUEUE_BATCHES', '3')
    monkeypatch.setenv('SKYT_RL_REFRESH_MODE', 'drain')
    monkeypatch.setenv('SKYT_RL_REFRESH_CONCURRENCY', '2')
    monkeypatch.setenv('SKYT_RL_STORE', '/tmp/rl-store')
    pcfg = PipelineConfig.from_env()
    assert pcfg == PipelineConfig(
        rollout_replicas=5, max_staleness=7, queue_batches=3,
        refresh_mode='drain', refresh_concurrency=2,
        store='/tmp/rl-store')
    assert PipelineConfig.from_pipeline_block(
        {'rollout_replicas': 2, 'store': 's'}) == PipelineConfig(
            rollout_replicas=2, store='s')


# --------------------------------------------------------------------
# The engine's live refresh (module engines: port and JAX, same weights)
# --------------------------------------------------------------------


@pytest.fixture(scope='module')
def engines():
    """A port engine on the JAX engine's weights, the JAX engine, and
    those weights as numpy."""
    jeng = JaxEngine('tiny', cfg=_jcfg(), **KW)
    teng = None
    try:
        base = jax.tree.map(np.asarray, jeng.params)
        teng = TorchEngine('tiny', cfg=_tcfg(), device='cpu',
                           params=convert.params_from_numpy(
                               base, _tcfg(), device='cpu'), **KW)
        yield teng, jeng, base
    finally:
        jeng.shutdown()
        if teng is not None:
            teng.shutdown()


def test_flatten_param_paths_match_the_reference(engines):
    teng, jeng, base = engines
    assert list(flatten_param_paths(teng.params)) == list(jax_flatten(
        jeng.params)) == list(jax_flatten(base))
    assert list(flatten_param_paths(_toy_params())) == \
        list(jax_flatten(_toy_params()))


def test_engine_delta_refresh_version_and_output(engines):
    engine = engines[0]
    before = engine.generate_ids(IDS, max_new_tokens=6)
    v0 = engine.policy_version
    flat = flatten_param_paths(engine.params)
    path = 'embed/embedding'
    original = flat[path].clone()
    # A delta that cannot leave greedy output alone: negate one tensor.
    assert engine.refresh_weights({path: -original.numpy()},
                                  version=v0 + 3, mode='step') == v0 + 3
    assert engine.policy_version == v0 + 3
    assert engine.generate_ids(IDS, max_new_tokens=6) != before
    # Restore; drain mode holds admission first.
    engine.refresh_weights({path: original}, version=v0 + 4,
                           mode='drain')
    assert engine.generate_ids(IDS, max_new_tokens=6) == before
    stats = engine.stats()
    assert stats['weight_refreshes'] >= 2
    assert stats['refresh_shards'] >= 2
    assert stats['policy_version'] == v0 + 4


def test_engine_refresh_rejects_unknown_shards(engines):
    engine = engines[0]
    v = engine.policy_version
    with pytest.raises(KeyError):
        engine.refresh_weights({'no/such/shard': np.zeros(2)},
                               version=v + 1)
    assert engine.policy_version == v


def test_engine_refresh_chaos_site(engines):
    """An injected ``infer.weights.refresh`` fault fails the ticket; the
    engine keeps serving on its weights and the retry lands."""
    engine = engines[0]
    flat = flatten_param_paths(engine.params)
    path = sorted(flat)[0]
    update = {path: flat[path].clone()}
    v = engine.policy_version
    before = engine.generate_ids(IDS, max_new_tokens=4)
    with inject_faults('infer.weights.refresh:OSError:times=1'):
        with pytest.raises(OSError, match='injected'):
            engine.refresh_weights(update, version=v + 1)
        assert engine.policy_version == v
        assert engine.generate_ids(IDS, max_new_tokens=4) == before
        assert engine.refresh_weights(update, version=v + 1) == v + 1


def _wait_version(engine, version):
    deadline = time.monotonic() + DEADLINE_S
    while (engine.policy_version != version and
           time.monotonic() < deadline):
        time.sleep(0.05)
    return engine.policy_version


def test_server_policy_store_watcher(engines, tmp_path, monkeypatch):
    """``--policy-store``: the committed policy is pulled before serving,
    then every newer commit's delta refreshes the engine live."""
    monkeypatch.setattr(tempfile, 'tempdir', str(tmp_path))  # its copy
    engine = engines[0]
    store = PolicyStore(str(tmp_path / 'store'))
    base = {p: t.numpy().copy()
            for p, t in flatten_param_paths(engine.params).items()}
    v1 = engine.policy_version + 100
    store.publish(base, version=v1)
    server_mod.watch_policy_store(engine, str(tmp_path / 'store'),
                                  poll_s=0.1)
    assert engine.policy_version == v1     # synchronous first pull
    path = sorted(base)[0]
    store.publish(dict(base, **{path: -base[path]}), version=v1 + 1)
    assert _wait_version(engine, v1 + 1) == v1 + 1
    np.testing.assert_array_equal(
        flatten_param_paths(engine.params)[path].numpy(), -base[path])
    store.publish(base, version=v1 + 2)
    assert _wait_version(engine, v1 + 2) == v1 + 2


def test_engine_rollouts_greedy_parity(engines):
    """Engine rollouts at temperature 0 are the JAX batch
    ``decode.generate``'s tokens on the same params."""
    engine, jeng, base = engines
    prompts, _ = grpo.make_prompts(3, 4, 6, engine.cfg.vocab_size)
    tiled = np.repeat(prompts.numpy(), 2, axis=0)
    generated, version = grpo.engine_rollouts(
        engine, tiled.tolist(), max_new_tokens=5, temperature=0.0,
        step=0)
    assert version == engine.policy_version
    lengths = jnp.full((tiled.shape[0],), tiled.shape[1], jnp.int32)
    ref, _ = jdecode.generate(
        jax.tree.map(jnp.asarray, base), jnp.asarray(tiled, jnp.int32),
        lengths, jeng.cfg, max_new_tokens=5, temperature=0.0)
    np.testing.assert_array_equal(generated.numpy(), np.asarray(ref))


# --------------------------------------------------------------------
# The store across packages
# --------------------------------------------------------------------


def _files(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            full = os.path.join(dirpath, name)
            with open(full, 'rb') as f:
                out[os.path.relpath(full, root)] = f.read()
    return out


def test_policy_store_bytes_match_the_reference(engines, tmp_path):
    _, _, base = engines
    tparams = convert.params_from_numpy(base, _tcfg(), device='cpu')
    PolicyStore(str(tmp_path / 'port')).publish(tparams, version=3)
    jrl.PolicyStore(str(tmp_path / 'ref')).publish(base, version=3)
    port, ref = _files(tmp_path / 'port'), _files(tmp_path / 'ref')
    assert len(port) == len(flatten_param_paths(base)) + 1
    assert port == ref


def test_policy_store_feeds_engines_across_packages(engines, tmp_path):
    """A JAX learner's publish refreshes a port engine and a port
    learner's a JAX engine: with one leaf negated and then restored,
    every engine gives the JAX engine's greedy tokens."""
    teng, jeng, base = engines
    path = 'layers/mlp/wo'
    changed = dict(jax_flatten(base), **{path: -base['layers']['mlp']['wo']})
    v = max(teng.policy_version, jeng.policy_version) + 10
    jax_store = jrl.PolicyStore(str(tmp_path / 'jax'))
    jax_store.publish(changed, version=v)
    pulled = PolicyStore(str(tmp_path / 'jax')).pull(str(tmp_path / 't'))
    assert pulled['shards_pulled'] == len(changed)
    teng.refresh_weights(pulled['updates'], version=v)
    port_store = PolicyStore(str(tmp_path / 'port'))
    port_store.publish({p: torch.as_tensor(np.array(a))
                        for p, a in changed.items()}, version=v)
    jpulled = jrl.PolicyStore(str(tmp_path / 'port')).pull(
        str(tmp_path / 'j'))
    jeng.refresh_weights(jpulled['updates'], version=v)
    try:
        want = [jeng.generate_ids(p, max_new_tokens=6) for p in PROMPTS]
        assert [teng.generate_ids(p, max_new_tokens=6)
                for p in PROMPTS] == want
    finally:
        restore = {path: base['layers']['mlp']['wo']}
        teng.refresh_weights(restore, version=v + 1)
        jeng.refresh_weights(restore, version=v + 1)
    assert [teng.generate_ids(p, max_new_tokens=6) for p in PROMPTS] == \
        [jeng.generate_ids(p, max_new_tokens=6) for p in PROMPTS]


def test_params_from_store_builds_the_tree(engines):
    _, _, base = engines
    flat = dict(jax_flatten(base))
    params = rl_pipeline._params_from_store(_tcfg(), flat, 'cpu')
    for path, leaf in flatten_param_paths(params).items():
        assert leaf.dtype == torch.float32
        np.testing.assert_array_equal(leaf.numpy(), flat[path])
    missing = {p: a for p, a in flat.items() if p != 'lm_head/w'}
    with pytest.raises(ValueError, match='missing'):
        rl_pipeline._params_from_store(_tcfg(), missing, 'cpu')
    bad = dict(flat, **{'final_norm/scale': np.ones(3, np.float32)})
    with pytest.raises(ValueError, match='shape'):
        rl_pipeline._params_from_store(_tcfg(), bad, 'cpu')


# --------------------------------------------------------------------
# The pipeline under chaos, and the distributed roles
# --------------------------------------------------------------------


def test_pipeline_chaos_run_holds_invariants(tmp_path):
    """One in-process run with a fault at every ``rl.*`` site: a killed
    wave, a killed delta pull, a learner step killed before it mutates
    state. The run completes with the staleness bound held, the faulted
    batch requeued and no batch lost."""
    pcfg = PipelineConfig(rollout_replicas=2, max_staleness=3,
                          queue_batches=2, refresh_mode='step',
                          refresh_concurrency=1,
                          store=str(tmp_path / 'store'))
    pipe = RLPipeline(torch_config('tiny'), pcfg, steps=4,
                      prompts_per_step=2, group_size=2, prompt_len=4,
                      max_new_tokens=4, num_prompts=16, max_slots=4,
                      device='cpu')
    with inject_faults(
            f'{rl_pipeline.LEARN_STEP_SITE}:Exception:times=1',
            f'{rl_pipeline.ROLLOUT_GENERATE_SITE}:Exception:times=1',
            f'{rl_pipeline.REFRESH_PULL_SITE}:OSError:times=1'):
        summary = pipe.run()
    assert summary['steps'] == 4
    assert summary['learn_faults'] == 1
    assert summary['batches_requeued'] >= 1
    assert summary['worker_errors'] == 1
    assert summary['refresh_errors'] >= 1
    assert summary['staleness_max'] <= pcfg.max_staleness
    assert summary['batches_unretired'] == summary['batches_produced'] \
        - summary['batches_acked']
    assert summary['batches_acked'] >= 4
    assert summary['refreshes'] >= 1
    assert summary['rollout_tokens'] > 0
    assert metrics.RL_ROLLOUT_BATCHES.value(outcome='requeued') >= 1
    assert metrics.RL_LEARNER_VERSION.value() == 4


def test_distributed_roles_over_the_file_queue(tmp_path, capsys):
    """``--role learner`` and ``--role rollout`` as two threads on one
    store: the rollout replica pulls the learner's policy, produces
    batches into the file queue, and the learner consumes them to the
    step count, publishing each version."""
    store = str(tmp_path / 'store')
    common = ['--model', 'tiny', '--steps', '2', '--prompts-per-step', '1',
              '--group-size', '2', '--prompt-len', '4',
              '--max-new-tokens', '3', '--store', store, '--device', 'cpu']
    rcs = {}

    def role(name):
        rcs[name] = rl_pipeline.main(['--role', name] + common)

    threads = [threading.Thread(target=role, args=(name,), daemon=True)
               for name in ('learner', 'rollout')]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert rcs == {'learner': 0, 'rollout': 0}
    assert PolicyStore(store).version() == 2
    steps = [line for line in capsys.readouterr().out.splitlines()
             if line.startswith('{"step"')]
    assert len(steps) == 2
