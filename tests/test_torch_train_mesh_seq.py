"""Mesh training over the sequence axis against the JAX reference, on the
CPU.

The port's train step at ``seq=2`` (ring attention and Ulysses attention;
two gloo ranks, ``tests/torch_seq_ranks.py``) and at
``fsdp=2,seq=2,tensor=2`` (ring; eight ranks) against the JAX package's
train step with the same ``attention_impl`` on the same mesh of virtual
CPU devices (``tests/torch_mesh_reference.py``): three steps (TINY, 4
query and 2 kv heads of dim 128, fp32; the third batch packs documents,
with segment ids and positions, so the ring carries the key segments)
under AdamW and, at ``seq=2``, Adafactor (d_model 128, d_ff 256) give
the reference's loss, grad norm and params within its 1e-5; each rank's
blocks of the initial params are the reference's shards. The port's
``'xla'`` step at ``seq=2`` (K/V gathered over seq) gives the ring's
losses. ``pretrain --mesh seq=2`` rounds the sequence up to the seq
degree (to 64 x seq on CUDA ranks), its loss falls, and its checkpoint
restores on one rank; a full finetune at ``seq=2`` gives the
one-process finetune's losses; both also train a step at
``stage=2,seq=2``. Each mesh launches once.
"""
import json
import os
import shutil

import numpy as np
import pytest

import torch
import torch_mesh_reference as ref_lib
from skypilot_tpu_torch.models import config as tconfig
from skypilot_tpu_torch.models import hf_interop, llama
from skypilot_tpu_torch.parallel.launch import launch
from skypilot_tpu_torch.train import finetune as tfinetune
from skypilot_tpu_torch.train import pretrain as tpretrain
from skypilot_tpu_torch.train import step as tstep
from torch_threads import few_torch_threads  # noqa: F401 (autouse)
from torch_tp_ranks import one_thread_ranks  # noqa: F401 (autouse)
import torch_seq_ranks as ranks

SEQ2 = 'seq=2'
FULL = 'fsdp=2,seq=2,tensor=2'
# (mesh, run name, optimizer, attention impl, widths)
RUNS = ((SEQ2, 'ring', 'adamw', 'ring', {}),
        (SEQ2, 'ring_adafactor', 'adafactor', 'ring',
         {'d_model': 128, 'd_ff': 256}),
        (SEQ2, 'ulysses', 'adamw', 'ulysses', {}),
        (FULL, 'ring', 'adamw', 'ring', {}))
FIXTURE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'skypilot_tpu_torch', 'testdata',
    'tokenizer_llama3')
PRETRAIN = ['--model', 'tiny', '--device', 'cpu', '--batch', '4',
            '--seq', '63', '--learning-rate', '1e-2', '--warmup-steps', '2',
            '--log-every', '2']


def _batches():
    return [ref_lib.batch(10), ref_lib.batch(11),
            ref_lib.batch(12, segments=True)]


def _finetune_argv(root):
    """A full finetune of TINY (vocab 1024, the tokenizer fixture's) as
    an HF directory on a text corpus, both written under ``root``."""
    cfg = tconfig.get_model_config('tiny', vocab_size=1024)
    ckpt = os.path.join(root, 'base')
    hf_interop.save_checkpoint(llama.init_params(0, cfg, device='cpu'), cfg,
                               ckpt)
    for name in ('tokenizer.json', 'tokenizer_config.json'):
        shutil.copy(os.path.join(FIXTURE, name), ckpt)
    corpus = os.path.join(root, 'corpus.txt')
    with open(corpus, 'w') as f:
        f.write('\n'.join(f'document {i}: the ranks split the sequence.'
                          for i in range(40)))
    return ['--hf-checkpoint', ckpt, '--data', corpus, '--steps', '3',
            '--batch', '4', '--seq', '32', '--learning-rate', '1e-3',
            '--lora-rank', '0', '--log-every', '1', '--device', 'cpu']


@pytest.fixture(scope='module')
def launches(tmp_path_factory):
    """Each mesh's one launch, made at its first use, with the
    reference's runs; the ``seq=2`` launch also runs ``pretrain``
    (checkpointing into a module temporary directory) and a full
    finetune."""
    root = str(tmp_path_factory.mktemp('seq'))
    return {'ckpt': os.path.join(root, 'ckpt'),
            'finetune': _finetune_argv(root)}


def _mesh_run(launches, spec):
    if spec in launches:
        return launches[spec]
    runs, refs = [], {}
    for mspec, name, optimizer, impl, widths in RUNS:
        if mspec != spec:
            continue
        run, refs[name] = ref_lib.run(spec, name, optimizer, _batches(),
                                      attention_impl=impl, **widths)
        runs.append(run)
    mains = finetunes = ()
    if spec == SEQ2:
        # The in-port 'xla' twin of the ring run: same params, batches.
        runs.append(dict(runs[0], name='xla', overrides=dict(
            runs[0]['overrides'], attention_impl='xla')))
        mains = [('skypilot_tpu_torch.train.pretrain', PRETRAIN + [
            '--mesh', 'seq=2', '--steps', '8', '--checkpoint-dir',
            launches['ckpt'], '--checkpoint-every', '4'])]
        finetunes = [launches['finetune'] + ['--mesh', 'seq=2']]
    n = 2 if spec == SEQ2 else 8
    out = launch(ranks.seq_train_checks, n, spec, runs, mains, finetunes,
                 device='cpu')
    launches[spec] = (out, refs)
    return launches[spec]


@pytest.mark.parametrize('spec,name', [(r[0], r[1]) for r in RUNS])
def test_train_steps_match_jax_on_seq_mesh(launches, spec, name):
    out, refs = _mesh_run(launches, spec)
    ref_lib.assert_matches(out[0]['runs'][name], refs[name])
    ref_lib.assert_state_sharded(out, name, refs[name])
    assert all(r['runs'][name]['flash_fallbacks'] == 0 for r in out)


def test_xla_step_gives_the_ring_losses(launches):
    out, refs = _mesh_run(launches, SEQ2)
    for r in out:
        for got, want in zip(r['runs']['xla']['metrics'],
                             r['runs']['ring']['metrics'], strict=True):
            np.testing.assert_allclose(got['loss'], want['loss'],
                                       rtol=ref_lib.LOSS_RTOL)
            np.testing.assert_allclose(got['grad_norm'], want['grad_norm'],
                                       rtol=ref_lib.NORM_RTOL)
    ref_lib.assert_matches(out[0]['runs']['xla'], refs['ring'])


def test_pretrain_on_seq_mesh_rounds_trains_and_restores(launches, capsys):
    """``--seq 63`` at seq=2 trains on 64 columns (rank 0 prints
    ``seq_rounded_to``, the other rank nothing), the loss falls over 8
    steps, and the step-8 checkpoint (whole tensors) restores into one
    process, which trains on from it."""
    out, _ = _mesh_run(launches, SEQ2)
    first, second = (r['mains'][0] for r in out)
    assert first['rc'] == 0 and second['rc'] == 0
    assert second['lines'] == []
    lines = first['lines']
    assert lines[0] == {'seq_rounded_to': 64}
    losses = [x['loss'] for x in lines if 'loss' in x]
    assert len(losses) == 4 and losses[-1] < losses[0], losses
    assert lines[-1] == {'done': True, 'final_step': 8}
    assert tpretrain.main(PRETRAIN + ['--steps', '9', '--checkpoint-dir',
                                      launches['ckpt']]) == 0
    resumed = [json.loads(x) for x in
               capsys.readouterr().out.splitlines() if x.startswith('{')]
    assert {'resumed_from_step': 8} in resumed
    after = [x['loss'] for x in resumed if 'loss' in x]
    assert len(after) == 1 and np.isfinite(after[0])


def test_full_finetune_on_seq_mesh(launches):
    """Three full-finetune steps at seq=2 (fp32 compute, ``enter_mesh``
    as pretrain's) give the one-process finetune's losses (1e-5); only
    rank 0 prints."""
    out, _ = _mesh_run(launches, SEQ2)
    one = tfinetune.run(tfinetune.parse_args(launches['finetune']),
                        compute_dtype=torch.float32)
    first, second = (r['finetunes'][0] for r in out)
    assert second['lines'] == []
    np.testing.assert_allclose(first['losses'], one['losses'], rtol=1e-5)


def test_mesh_seq_keeps_cuda_ring_blocks_on_the_kernels_grid(capsys):
    """On CUDA ranks at seq > 1 the sequence rounds up to 64 x seq (each
    ring block a whole number of the flash kernels' 64-row tiles); on CPU
    ranks up to seq, as the reference rounds; one rank rounds nothing."""
    from skypilot_tpu_torch.parallel.mesh import Mesh
    seq2 = np.arange(2).reshape(1, 1, 1, 2, 1, 1)
    cuda, cpu = Mesh(seq2, device_type='cuda'), Mesh(seq2, device_type='cpu')
    assert tpretrain.mesh_seq(1000, cuda, True) == 1024
    assert tpretrain.mesh_seq(1024, cuda, True) == 1024
    assert tpretrain.mesh_seq(1000, cpu, True) == 1000
    assert tpretrain.mesh_seq(63, cpu, False) == 64
    assert tpretrain.mesh_seq(1000, None, True) == 1000
    lines = capsys.readouterr().out.splitlines()
    assert [json.loads(x) for x in lines] == [{'seq_rounded_to': 1024}]


def test_stage_still_raises(launches, capfd):
    """A stage degree with seq above 1 trains (its parity with the
    reference: ``tests/test_torch_train_mesh_stage_seq.py``): the mesh
    check passes, and ``pretrain`` and the full finetune at
    ``stage=2,seq=2`` each start their four ranks and train a step."""
    tstep.check_training_mesh({'stage': 2, 'seq': 2},
                              tconfig.get_model_config('tiny'), 4)
    capfd.readouterr()
    assert tpretrain.main(PRETRAIN + ['--mesh', 'stage=2,seq=2',
                                      '--steps', '1', '--log-every',
                                      '1']) == 0
    assert tfinetune.main(launches['finetune'] + [
        '--mesh', 'stage=2,seq=2', '--steps', '1']) == 0
    lines = [json.loads(x) for x in capfd.readouterr().out.splitlines()
             if x.startswith('{')]
    assert lines[0] == {'seq_rounded_to': 64}
    losses = [x['loss'] for x in lines if 'loss' in x]
    assert len(losses) == 2 and np.all(np.isfinite(losses)), lines
