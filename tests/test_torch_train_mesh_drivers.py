"""The mesh-training entry points on the CPU: the twins of the JAX
package's driver and elastic-training tests under ``--mesh``.

``train.pretrain.main`` with ``--mesh fsdp=2`` starts its own two gloo
ranks (only rank 0 prints): its loss falls, it checkpoints, and a second
run resumes from the step the first committed. Under an elastic
controller the resize signal stops every rank at the same step boundary
after a checkpoint, and the re-exec at one slice (one process) resumes
there. A checkpoint written at fsdp=2 restores on one process, and one
written on one process restores at fsdp=2, each continuing as the
uninterrupted run does. A full ``train.finetune`` under ``--mesh
fsdp=2`` gives the one-process finetune's losses and exported weights.
A mesh checkpoint's writer makes each whole tensor only as it writes it.
"""
import json
import os
import shutil
import weakref

import numpy as np
import pytest
import torch

from skypilot_tpu_torch.models import hf_interop, llama
from skypilot_tpu_torch.models.config import get_model_config
from skypilot_tpu_torch.parallel.launch import launch
from skypilot_tpu_torch.train import checkpoint as ckpt_lib
from skypilot_tpu_torch.train import finetune as tfinetune
from skypilot_tpu_torch.train import pretrain as tpretrain
from skypilot_tpu_torch.utils.safetensors_io import (Deferred,
                                                    write_safetensors)
from torch_threads import few_torch_threads  # noqa: F401 (autouse)
from torch_tp_ranks import one_thread_ranks  # noqa: F401 (autouse)
import torch_train_ranks as ranks

FIXTURE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'skypilot_tpu_torch', 'testdata',
    'tokenizer_llama3')


def _lines(text):
    return [json.loads(x) for x in text.splitlines() if x.startswith('{')]


def test_pretrain_loss_decreases_and_checkpoints(tmp_path, capfd):
    ckpt = str(tmp_path / 'ck')
    rc = tpretrain.main([
        '--model', 'tiny', '--steps', '8', '--batch', '4', '--seq', '64',
        '--warmup-steps', '2', '--log-every', '2',
        '--checkpoint-dir', ckpt, '--checkpoint-every', '4',
        '--learning-rate', '1e-2', '--mesh', 'fsdp=2', '--device', 'cpu'])
    assert rc == 0
    lines = _lines(capfd.readouterr().out)
    losses = [x['loss'] for x in lines if 'loss' in x]
    assert len(losses) == 4 and losses[-1] < losses[0], lines
    assert lines[-1] == {'done': True, 'final_step': 8}
    assert ckpt_lib.latest_step(ckpt) == 8


def test_pretrain_resumes_from_checkpoint(tmp_path, capfd):
    ckpt = str(tmp_path / 'ck')
    argv = ['--model', 'tiny', '--batch', '3', '--seq', '32',
            '--checkpoint-dir', ckpt, '--mesh', 'fsdp=2', '--device', 'cpu']
    assert tpretrain.main(argv + ['--steps', '4',
                                  '--checkpoint-every', '4']) == 0
    first = _lines(capfd.readouterr().out)
    assert {'batch_rounded_to': 4} in first
    assert tpretrain.main(argv + ['--steps', '6',
                                  '--checkpoint-every', '2']) == 0
    lines = _lines(capfd.readouterr().out)
    assert {'resumed_from_step': 4} in lines
    assert {'mesh_devices': 2, 'num_slices': 1} in lines
    steps = [x['step'] for x in lines if 'step' in x]
    assert steps and min(steps) > 4
    assert ckpt_lib.latest_step(ckpt) == 6


def test_pretrain_driver_resize_signal_exits_at_step_boundary(
        tmp_path, monkeypatch, capfd):
    """Two slices of data=2 (two ranks): the signal, present from the
    start, stops both ranks after step 1 with a checkpoint; the re-exec
    at one slice is one process and resumes at step 1."""
    ckpt = str(tmp_path / 'ck')
    signal = tmp_path / 'resize.signal'
    signal.write_text('shrink\n')
    monkeypatch.setenv('SKYT_RESIZE_SIGNAL', str(signal))
    monkeypatch.setenv('SKYT_ELASTIC_SLICES', '2')
    argv = ['--model', 'tiny', '--steps', '8', '--batch', '4',
            '--seq', '32', '--checkpoint-dir', ckpt,
            '--checkpoint-every', '100', '--device', 'cpu',
            '--mesh', 'data=2,num_slices=2,fsdp=-1']
    assert tpretrain.main(argv) == 0
    assert ckpt_lib.latest_step(ckpt) == 1
    assert _lines(capfd.readouterr().out) == [{'resize_exit_at_step': 1}]
    signal.unlink()
    monkeypatch.setenv('SKYT_ELASTIC_SLICES', '1')
    assert tpretrain.main(argv) == 0
    assert ckpt_lib.latest_step(ckpt) == 8
    lines = _lines(capfd.readouterr().out)
    assert lines[:2] == [{'resumed_from_step': 1},
                         {'mesh_devices': 1, 'num_slices': 1}]


@pytest.mark.parametrize('write,read,model', [
    ('fsdp=2', None, 'tiny'), (None, 'fsdp=2', 'tiny'),
    ('expert=2', None, 'tiny-moe'), (None, 'expert=2,fsdp=2', 'tiny-moe'),
    ('stage=2', None, 'tiny'), ('stage=2', 'fsdp=2', 'tiny')],
    ids=['fsdp2_to_one', 'one_to_fsdp2', 'moe_expert2_to_one',
         'moe_one_to_expert2_fsdp2', 'stage2_to_one', 'stage2_to_fsdp2'])
def test_topology_change_restore_resharding(tmp_path, write, read, model):
    """A step written at one layout restores into the other (the files
    hold whole tensors): the params restored are the params saved,
    bitwise (a MoE model's expert leaves written from their blocks over
    expert, read into blocks over expert and fsdp; the layer leaves
    written from their blocks over stage), and the next step's loss is
    the uninterrupted run's (fp32 sums in another order: 1e-5)."""
    directory = str(tmp_path / 'ck')

    def cycle(spec, restore):
        if spec is None:
            return ranks.checkpoint_cycle(0, 1, None, directory, restore,
                                          model)
        world = int(np.prod([int(p.split('=')[1])
                             for p in spec.split(',')]))
        return launch(ranks.checkpoint_cycle, world, spec, directory,
                      restore, model, device='cpu')[0]

    saved = cycle(write, False)
    assert ckpt_lib.latest_step(directory) == 2
    resumed = cycle(read, True)
    assert resumed['step'] == 3
    flat_saved = dict(_flat(saved['params']))
    flat_resumed = dict(_flat(resumed['params']))
    assert flat_saved.keys() == flat_resumed.keys()
    for key, value in flat_saved.items():
        np.testing.assert_array_equal(flat_resumed[key], value, err_msg=key)
    np.testing.assert_allclose(resumed['losses'][0], saved['losses'][2],
                               rtol=1e-5)


def _flat(tree, prefix=''):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flat(value, f'{prefix}{key}/')
        else:
            yield prefix + key, value


def test_pretrain_trains_on_stage_mesh(capfd):
    """``pretrain --mesh stage=2`` starts its two ranks and trains (rank
    0 prints the last stage's loss): the one-process run's losses within
    the printed rounding and bf16's."""
    argv = ['--model', 'tiny', '--steps', '3', '--batch', '4', '--seq',
            '64', '--log-every', '1', '--device', 'cpu']
    assert tpretrain.main(argv + ['--mesh', 'stage=2']) == 0
    lines = _lines(capfd.readouterr().out)
    assert tpretrain.main(argv) == 0
    one = _lines(capfd.readouterr().out)
    assert lines[-1] == one[-1] == {'done': True, 'final_step': 3}
    got = [x['loss'] for x in lines if 'loss' in x]
    want = [x['loss'] for x in one if 'loss' in x]
    assert len(got) == 3 and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_deferred_tensors_are_written_one_at_a_time(tmp_path):
    """What a mesh checkpoint's writer relies on: each ``Deferred``
    value is made as its turn comes, in name order, after the one before
    it is written and dropped, and the file's bytes are those of the
    same tensors written eagerly; a made tensor off its declared shape
    raises."""
    rng = np.random.RandomState(0)
    arrays = {'b': rng.randn(3, 4).astype(np.float32),
              'a': rng.randn(5).astype(np.float32),
              'c/d': rng.randint(-2 ** 14, 2 ** 14, (2, 2, 2)).astype(
                  np.int16)}

    def tensor(arr):
        # Every view of it keeps ``arr`` (weakly referenced below) alive.
        t = torch.from_numpy(arr)
        return t.view(torch.bfloat16) if arr.dtype == np.int16 else t

    tensors = {k: tensor(v) for k, v in arrays.items()}
    made, alive = [], []

    def maker(name):
        def make():
            assert all(ref() is None for ref in alive), made
            made.append(name)
            arr = arrays[name].copy()
            alive.append(weakref.ref(arr))
            return tensor(arr)
        return make

    eager, lazy = str(tmp_path / 'eager'), str(tmp_path / 'lazy')
    write_safetensors(eager, tensors)
    write_safetensors(lazy, {k: Deferred(tuple(v.shape), v.dtype, v.device,
                                         maker(k))
                             for k, v in tensors.items()})
    assert made == sorted(tensors)
    with open(eager, 'rb') as a, open(lazy, 'rb') as b:
        assert a.read() == b.read()
    with pytest.raises(ValueError, match='declared'):
        write_safetensors(str(tmp_path / 'bad'), {'a': Deferred(
            (4,), torch.float32, torch.device('cpu'), maker('a'))})


@pytest.fixture(scope='module')
def hf_dir(tmp_path_factory):
    """TINY (vocab 1024 for the tokenizer fixture) as an HF directory,
    and a text corpus."""
    root = tmp_path_factory.mktemp('ft')
    cfg = get_model_config('tiny', vocab_size=1024)
    ckpt = str(root / 'base')
    hf_interop.save_checkpoint(llama.init_params(0, cfg, device='cpu'), cfg,
                               ckpt)
    for name in ('tokenizer.json', 'tokenizer_config.json'):
        shutil.copy(os.path.join(FIXTURE, name), ckpt)
    corpus = root / 'corpus.txt'
    corpus.write_text('\n'.join(
        f'document {i}: the ranks split the batch and the weights.'
        for i in range(40)))
    return ckpt, str(corpus)


def test_full_finetune_under_mesh(hf_dir, tmp_path, capfd):
    """Three full-finetune steps at fsdp=2 (fp32 compute) give the
    one-process run's losses (1e-5) and exported weights (as
    ``tests/torch_mesh_reference``: 1e-5, AdamW's few rounding-floor
    elements within twice the summed learning rates); the command with
    ``--mesh fsdp=2`` starts its own ranks and exports once."""
    ckpt, corpus = hf_dir
    argv = ['--hf-checkpoint', ckpt, '--data', corpus, '--steps', '3',
            '--batch', '4', '--seq', '32', '--learning-rate', '1e-3',
            '--lora-rank', '0', '--log-every', '1', '--device', 'cpu']
    one = tfinetune.run(tfinetune.parse_args(
        argv + ['--export-dir', str(tmp_path / 'one')]),
        compute_dtype=torch.float32)
    two = launch(ranks.finetune_run, 2, argv + [
        '--mesh', 'fsdp=2', '--export-dir', str(tmp_path / 'two')],
        device='cpu')
    assert two[1]['lines'] == []        # only rank 0 prints
    np.testing.assert_allclose(two[0]['losses'], one['losses'], rtol=1e-5)
    a, _ = hf_interop.load_checkpoint(str(tmp_path / 'one'), device='cpu')
    b, _ = hf_interop.load_checkpoint(str(tmp_path / 'two'), device='cpu')
    flat_b = dict(_leaves(b))
    for name, x in _leaves(a):
        diff = (x - flat_b[name]).abs()
        assert int((diff > 1e-5).sum()) <= 4, name
        assert float(diff.max()) <= 2 * 3 * 1e-3, name
    capfd.readouterr()
    assert tfinetune.main(argv + ['--steps', '1', '--mesh', 'fsdp=2',
                                  '--export-dir',
                                  str(tmp_path / 'cmd')]) == 0
    lines = _lines(capfd.readouterr().out)
    assert [x['step'] for x in lines if 'loss' in x] == [1]
    assert {'exported': str(tmp_path / 'cmd')} in lines
    assert os.path.exists(os.path.join(str(tmp_path / 'cmd'),
                                       'config.json'))


def test_full_finetune_under_stage_mesh(hf_dir, capfd):
    """Three full-finetune steps at stage=2 (fp32 compute) give the
    one-process run's losses (1e-5); the command with ``--mesh stage=2``
    starts its own two ranks."""
    ckpt, corpus = hf_dir
    argv = ['--hf-checkpoint', ckpt, '--data', corpus, '--steps', '3',
            '--batch', '4', '--seq', '32', '--learning-rate', '1e-3',
            '--lora-rank', '0', '--log-every', '1', '--device', 'cpu']
    one = tfinetune.run(tfinetune.parse_args(argv),
                        compute_dtype=torch.float32)
    two = launch(ranks.finetune_run, 2, argv + ['--mesh', 'stage=2'],
                 device='cpu', timeout=120)
    assert two[1]['lines'] == []        # only rank 0 prints
    np.testing.assert_allclose(two[0]['losses'], one['losses'], rtol=1e-5)
    np.testing.assert_allclose(two[1]['losses'], one['losses'], rtol=1e-5)
    capfd.readouterr()
    assert tfinetune.main(argv + ['--steps', '1', '--mesh', 'stage=2']) == 0
    lines = _lines(capfd.readouterr().out)
    assert [x['step'] for x in lines if 'loss' in x] == [1]


def _leaves(tree, prefix=''):
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            yield from _leaves(tree[key], prefix + key + '/')
        else:
            yield prefix + key, tree[key]
