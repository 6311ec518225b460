"""Pipeline-parallel training over the stage axis against the JAX
reference, on the CPU: ``stage=2`` alone.

The checks of ``tests/torch_stage_cases.py`` at ``stage=2`` with the
default 4 microbatches and with 8, on TINY_MOE and with tied embeddings
(``tests/test_torch_train_mesh_stage_axes.py`` takes ``stage=4`` and
stage with fsdp and with tensor). In the same launch two planted faults,
a backward handoff that drops the gradient and the stage-unsplit
leaves' gradients left unsummed over ``stage``, must each fail the
comparison. Then the fast cases of the reference's
``tests/test_pipeline.py`` and its refusals, the handoffs' tags, a
deadlocked exchange that fails its launch within the launch's bound,
and a step of ``pretrain`` and of the full finetune at ``stage=2,seq=2``
and ``stage=2,expert=2``.
"""
import json
import os
import shutil
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_reference as ref_lib
import torch_stage_cases as cases
from skypilot_tpu.models import llama as jllama
from skypilot_tpu.parallel import pipeline as jpipeline
from skypilot_tpu_torch.models import config as tconfig
from skypilot_tpu_torch.models import hf_interop
from skypilot_tpu_torch.models import llama as tllama
from skypilot_tpu_torch.parallel import pipeline as tpipeline
from skypilot_tpu_torch.parallel.launch import RankFailed, launch
from skypilot_tpu_torch.train import finetune as tfinetune
from skypilot_tpu_torch.train import pretrain as tpretrain
from skypilot_tpu_torch.train import step as tstep
from torch_threads import few_torch_threads  # noqa: F401 (autouse)
from torch_tp_ranks import one_thread_ranks  # noqa: F401 (autouse)
import torch_train_ranks as ranks

FIXTURE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'skypilot_tpu_torch', 'testdata',
    'tokenizer_llama3')
LABELS = cases.labels_of({'stage=2'})


@pytest.fixture(scope='module')
def launches():
    """This module's mesh launches (``cases.mesh_run``)."""
    return {}


@pytest.mark.parametrize('label', LABELS)
def test_stage_train_steps_match_jax_on_mesh(launches, label):
    cases.check_train_steps(launches, label)


@pytest.mark.parametrize('label', LABELS)
def test_stage_forward_matches_jax(launches, label):
    cases.check_forward(launches, label)


@pytest.mark.parametrize('label', LABELS)
def test_stage_state_is_sharded(launches, label):
    cases.check_sharded(launches, label)


@pytest.mark.parametrize('label', LABELS)
def test_stage_step_handoffs(launches, label):
    cases.check_handoffs(launches, label)


@pytest.mark.parametrize('fault', ['dx dropped', 'stage sum skipped'])
def test_planted_faults_fail_the_comparison(launches, fault):
    out, refs = cases.mesh_run(launches, 'stage=2')
    with pytest.raises(AssertionError):
        ref_lib.assert_matches(out[0]['runs'][fault], refs['stage=2'])


def test_handoffs_match_tags_and_stop_at_the_ends():
    """Tagged sends taken out of order by their receives; a hop past
    either end of the stage axis raises."""
    out = launch(ranks.stage_handoffs, 2, False, device='cpu',
                 timeout=cases.LAUNCH_TIMEOUT_S)
    assert [r['stage_rank'] for r in out] == [0, 1]
    assert out[1]['got'] == [0.0, 1.0, 2.0]
    assert out[0]['got'] == [12.0, 11.0, 10.0]
    for r in out:
        assert len(r['errors']) == 2
        assert all('has no peer' in e for e in r['errors'])


def test_deadlocked_exchange_fails_within_the_launch_bound():
    t0 = time.monotonic()
    with pytest.raises(RankFailed, match='timeout of 5'):
        launch(ranks.stage_handoffs, 2, True, device='cpu', timeout=5)
    assert time.monotonic() - t0 < 60


def test_default_num_microbatches():
    """The reference's values (its test_pipeline cases) and its function
    on every batch up to 16 and stage count up to 4."""
    assert tpipeline.default_num_microbatches(8, 2) == 4
    assert tpipeline.default_num_microbatches(8, 4) == 8
    assert tpipeline.default_num_microbatches(6, 2) == 3
    assert tpipeline.default_num_microbatches(7, 4) == 7
    assert tpipeline.default_num_microbatches(1, 4) == 1
    for batch in range(1, 17):
        for stages in range(1, 5):
            assert tpipeline.default_num_microbatches(batch, stages) == \
                jpipeline.default_num_microbatches(batch, stages)


def test_indivisible_layers_and_batch_raise():
    """The reference's refusals, with its messages: layers that the
    stages do not divide (``stage_stack``) and a batch that the
    microbatches do not divide (``pipeline_apply``); in the port also a
    rank's rows under data x fsdp, and each before any rank starts."""
    cfg = ref_lib.jax_config()
    params = jllama.init_params(jax.random.key(0), cfg)
    axes = jllama.param_logical_axes(cfg)
    with pytest.raises(ValueError, match='not divisible') as want:
        jpipeline.stage_stack(params['layers'], axes['layers'],
                              cfg.n_layers + 1)
    with pytest.raises(ValueError, match='not divisible') as got:
        tpipeline.check_layers(cfg.n_layers, cfg.n_layers + 1)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match='not divisible') as want:
        jpipeline.pipeline_apply({}, jnp.zeros((5, 4)), lambda p, x: x,
                                 n_stages=2, num_microbatches=2)
    with pytest.raises(ValueError, match='not divisible') as got:
        tpipeline.microbatch_rows(5, 2)
    assert str(got.value) == str(want.value)
    tiny = tconfig.get_model_config('tiny')
    with pytest.raises(ValueError, match='not divisible'):
        tstep.check_training_mesh({'stage': 3}, tiny)
    # B=4 over fsdp=2: 2 rows a rank, the default 4 microbatches.
    with pytest.raises(ValueError, match='not divisible'):
        tstep.check_training_mesh({'stage': 2, 'fsdp': 2}, tiny, 4)
    tstep.check_training_mesh({'stage': 2, 'fsdp': 2}, tiny, 8)
    for argv in (['--mesh', 'stage=3'],
                 ['--mesh', 'stage=2,fsdp=2', '--batch', '4']):
        with pytest.raises(ValueError, match='not divisible'):
            tpretrain.main(argv + ['--device', 'cpu', '--steps', '1'])


@pytest.mark.parametrize('refusal', ['segments', 'return_aux', 'positions'])
def test_forward_refusals_under_stages(refusal):
    """Packed segments, ``return_aux`` and per-example positions raise
    under stages with the reference's messages; so does ``--packed`` on
    ``pretrain --mesh stage=2``, before any rank starts."""
    tokens = np.zeros((2, 8), np.int32)
    kwargs = {'segments': {'segments': np.zeros((2, 8), np.int32)},
              'return_aux': {'return_aux': True},
              'positions': {'positions': np.zeros((2, 8), np.int32)}
              }[refusal]
    jcfg = ref_lib.jax_config()
    jparams = jllama.init_params(jax.random.key(0), jcfg)
    with pytest.raises(ValueError) as want:
        jllama.forward(jparams, jnp.asarray(tokens), jcfg,
                       pipeline_stages=2,
                       **{k: jnp.asarray(v) if k != 'return_aux' else v
                          for k, v in kwargs.items()})
    cfg = tconfig.get_model_config('tiny')
    params = tllama.init_params(0, cfg, device='cpu')
    with pytest.raises(ValueError) as got:
        tllama.forward(params, torch.from_numpy(tokens), cfg,
                       pipeline_stages=2,
                       **{k: torch.from_numpy(v) if k != 'return_aux'
                          else v for k, v in kwargs.items()})
    assert str(got.value) == str(want.value)
    if refusal == 'segments':
        with pytest.raises(ValueError, match='segments are not supported'):
            tpretrain.main(['--mesh', 'stage=2', '--packed', '--device',
                            'cpu', '--steps', '1'])


def test_forward_under_stages_needs_the_stage_ranks():
    """``forward(pipeline_stages=2)`` off a mesh of that stage degree
    says what it needs."""
    cfg = tconfig.get_model_config('tiny')
    params = tllama.init_params(0, cfg, device='cpu')
    with pytest.raises(ValueError, match='pass parallel='):
        tllama.forward(params, torch.zeros((2, 8), dtype=torch.int32), cfg,
                       pipeline_stages=2)


@pytest.mark.parametrize('axis', ['seq', 'expert'])
def test_stage_with_seq_or_expert_raises(axis, tmp_path, capfd):
    """stage x seq and stage x expert train (their parity with the
    reference: ``tests/test_torch_train_mesh_stage_seq.py`` and
    ``tests/test_torch_train_mesh_stage_expert.py``): the mesh check
    passes, and ``pretrain`` and the full finetune each start their four
    ranks and train a step to a finite loss."""
    model = 'tiny-moe' if axis == 'expert' else 'tiny'
    spec = f'stage=2,{axis}=2'
    tstep.check_training_mesh({'stage': 2, axis: 2},
                              tconfig.get_model_config(model), 4)
    capfd.readouterr()
    assert tpretrain.main(['--model', model, '--mesh', spec, '--device',
                           'cpu', '--steps', '1', '--seq', '32',
                           '--log-every', '1']) == 0
    assert tfinetune.main(_finetune_argv(model, tmp_path) +
                          ['--mesh', spec]) == 0
    lines = [json.loads(x) for x in capfd.readouterr().out.splitlines()
             if x.startswith('{')]
    losses = [x['loss'] for x in lines if 'loss' in x]
    assert len(losses) == 2 and np.all(np.isfinite(losses)), lines


def _finetune_argv(model, root):
    """One full-finetune step of ``model`` (vocab 1024, the tokenizer
    fixture's) from an HF directory on a text corpus, both written under
    ``root``."""
    cfg = tconfig.get_model_config(model, vocab_size=1024)
    ckpt = os.path.join(root, 'base')
    hf_interop.save_checkpoint(tllama.init_params(0, cfg, device='cpu'), cfg,
                               ckpt)
    for name in ('tokenizer.json', 'tokenizer_config.json'):
        shutil.copy(os.path.join(FIXTURE, name), ckpt)
    corpus = os.path.join(root, 'corpus.txt')
    with open(corpus, 'w') as f:
        f.write('\n'.join(f'document {i}: the stages split the layers.'
                          for i in range(40)))
    return ['--hf-checkpoint', ckpt, '--data', corpus, '--steps', '1',
            '--batch', '4', '--seq', '32', '--lora-rank', '0',
            '--log-every', '1', '--device', 'cpu']
