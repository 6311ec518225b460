"""The port's checkpoints (``train/checkpoint.py``) and resume on the CPU.

A save restores bit for bit (params, both optimizers' states, bf16
leaves, the step and count ints) into a fresh state; the file is a
safetensors file with the state's keys; a save killed at the commit site
is invisible to ``latest_step`` and a torn manifest reads as absent; the
three newest committed steps are kept; ``pretrain.main`` resumed from a
checkpoint gives the losses of an uninterrupted run exactly (TINY, 2 + 2
steps).
"""
import json
import os
import struct

import pytest
import torch

from skypilot_tpu_torch.data import ckpt_manifest
from skypilot_tpu_torch.models.config import get_model_config
from skypilot_tpu_torch.train import checkpoint as ckpt
from skypilot_tpu_torch.train import pretrain
from skypilot_tpu_torch.train import step as tstep
from skypilot_tpu_torch.utils import fault_injection
from torch_threads import few_torch_threads  # noqa: F401 (autouse)


def _trained_state(optimizer, param_dtype, steps=2, seed=0):
    cfg = get_model_config('tiny', param_dtype=param_dtype, d_model=128,
                           d_ff=256)
    hp = tstep.TrainHParams(warmup_steps=1, total_steps=10,
                            optimizer=optimizer)
    state = tstep.create_train_state(seed, cfg, hp, device='cpu')
    step_fn = tstep.make_train_step(cfg, hp)
    for i in range(steps):
        batch = pretrain.synthetic_batch(i, 2, 32, cfg.vocab_size)
        state, _ = step_fn(state, batch)
    return cfg, hp, state


def _flat(state):
    return ckpt._flatten(state)


@pytest.mark.parametrize('optimizer,param_dtype', [
    ('adamw', torch.float32), ('adafactor', torch.float32),
    ('adafactor', torch.bfloat16), ('adamw', torch.bfloat16)])
def test_save_restore_is_bit_exact(tmp_path, optimizer, param_dtype):
    cfg, hp, state = _trained_state(optimizer, param_dtype)
    ckpt.save(str(tmp_path), 2, state)
    fresh = tstep.create_train_state(1, cfg, hp, device='cpu')
    restored = ckpt.restore(str(tmp_path), 2, fresh)
    assert restored.step == state.step == 2
    assert restored.opt_state['count'] == 2
    want, got = _flat(state), _flat(restored)
    assert sorted(want) == sorted(got)
    for key, value in want.items():
        if isinstance(value, torch.Tensor):
            assert got[key].dtype == value.dtype, key
            assert torch.equal(got[key], value), key
        else:
            assert got[key] == value, key
    # Restored in place: the fresh state's own tensors hold the values,
    # and the params are still trainable leaves.
    wq = restored.params['layers']['attn']['wq']
    assert wq is fresh.params['layers']['attn']['wq'] and wq.requires_grad
    if optimizer == 'adafactor':
        assert 'opt_state/v_row/layers/attn/wq' in got


def test_file_is_safetensors_with_the_state_keys(tmp_path):
    _, _, state = _trained_state('adafactor', torch.bfloat16, steps=1)
    ckpt.save(str(tmp_path), 1, state)
    path = tmp_path / '1' / ckpt.SHARD_NAME
    raw = path.read_bytes()
    (size,) = struct.unpack('<Q', raw[:8])
    header = json.loads(raw[8:8 + size])
    assert size % 8 == 0
    emb = header['params/embed/embedding']
    assert emb['dtype'] == 'BF16' and emb['shape'] == [512, 128]
    assert header['step'] == {'dtype': 'I64', 'shape': [],
                              'data_offsets': header['step'][
                                  'data_offsets']}
    end = max(v['data_offsets'][1] for v in header.values())
    assert len(raw) == 8 + size + end
    tensors = ckpt.read_safetensors(str(path))
    assert int(tensors['opt_state/count']) == 1
    manifest = ckpt.step_manifest(str(tmp_path), 1)
    assert manifest['step'] == 1
    assert [s['path'] for s in manifest['shards']] == [ckpt.SHARD_NAME]


def test_killed_save_and_torn_manifest_are_invisible(tmp_path,
                                                     monkeypatch):
    _, _, state = _trained_state('adamw', torch.float32, steps=1)
    directory = str(tmp_path)
    assert ckpt.latest_step(directory) is None
    ckpt.save(directory, 1, state)
    monkeypatch.setenv(fault_injection.SPEC_ENV,
                       f'{ckpt.COMMIT_SITE}:OSError:times=1')
    fault_injection.reset()
    with pytest.raises(OSError, match='injected'):
        ckpt.save(directory, 2, state)
    assert os.path.exists(tmp_path / '2' / ckpt.SHARD_NAME)
    assert ckpt.latest_step(directory) == 1
    assert ckpt.step_manifest(directory, 2) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(directory, 2, state)
    # The uncommitted step is written again by the next save of it.
    ckpt.save(directory, 2, state)
    assert ckpt.latest_step(directory) == 2
    with pytest.raises(FileExistsError):
        ckpt.save(directory, 2, state)
    # A torn manifest reads as absent.
    manifest = tmp_path / '2' / ckpt_manifest.MANIFEST_NAME
    manifest.write_bytes(manifest.read_bytes()[:40])
    assert ckpt.latest_step(directory) == 1
    fault_injection.reset()


def test_keeps_the_three_newest_committed_steps(tmp_path):
    _, _, state = _trained_state('adamw', torch.float32, steps=1)
    for step in (1, 2, 3, 4, 5):
        ckpt.save(str(tmp_path), step, state)
    assert sorted(os.listdir(tmp_path)) == ['3', '4', '5']
    assert ckpt.latest_step(str(tmp_path)) == 5
    restored = ckpt.restore_latest(str(tmp_path), lambda: state)
    assert restored.step == state.step


def test_restore_refuses_another_state(tmp_path):
    cfg, hp, state = _trained_state('adamw', torch.float32, steps=1)
    ckpt.save(str(tmp_path), 1, state)
    other = tstep.create_train_state(
        0, cfg, tstep.TrainHParams(optimizer='adafactor'), device='cpu')
    with pytest.raises(ValueError, match='does not match'):
        ckpt.restore(str(tmp_path), 1, other)


def _losses(capsys):
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    return lines, {x['step']: x['loss'] for x in lines if 'loss' in x}


@pytest.mark.parametrize('optimizer', ['adamw', 'adafactor'])
def test_pretrain_resume_matches_uninterrupted_run(tmp_path, capsys,
                                                   optimizer):
    """2 steps with a checkpoint, then a resumed run to step 4: the
    losses and the final checkpoint equal a 4-step run's exactly."""
    base = ['--model', 'tiny', '--device', 'cpu', '--batch', '2', '--seq',
            '32', '--log-every', '1', '--warmup-steps', '1',
            '--checkpoint-every', '2', '--optimizer', optimizer]
    whole, part = str(tmp_path / 'whole'), str(tmp_path / 'part')
    assert pretrain.main(base + ['--steps', '4', '--checkpoint-dir',
                                 whole]) == 0
    _, want = _losses(capsys)
    assert pretrain.main(base + ['--steps', '2', '--checkpoint-dir',
                                 part]) == 0
    _, first = _losses(capsys)
    assert pretrain.main(base + ['--steps', '4', '--checkpoint-dir',
                                 part]) == 0
    lines, second = _losses(capsys)
    assert lines[0] == {'resumed_from_step': 2}
    assert {**first, **second} == want
    a = ckpt.read_safetensors(os.path.join(whole, '4', ckpt.SHARD_NAME))
    b = ckpt.read_safetensors(os.path.join(part, '4', ckpt.SHARD_NAME))
    assert sorted(a) == sorted(b)
    for key in a:
        assert torch.equal(a[key], b[key]), key


def test_resize_exit_saves_the_step(tmp_path, capsys, monkeypatch):
    signal = tmp_path / 'resize'
    signal.touch()
    monkeypatch.setenv(tstep.RESIZE_SIGNAL_ENV, str(signal))
    directory = str(tmp_path / 'ckpt')
    assert pretrain.main(['--model', 'tiny', '--device', 'cpu', '--batch',
                          '2', '--seq', '32', '--steps', '5',
                          '--checkpoint-dir', directory]) == 0
    lines, _ = _losses(capsys)
    assert lines[-1] == {'resize_exit_at_step': 1}
    assert ckpt.latest_step(directory) == 1


def test_fault_spec_parses_like_the_reference():
    from skypilot_tpu.utils import fault_injection as jfault
    spec = (f'{ckpt.COMMIT_SITE}:OSError:p=0.5:seed=3:times=2,'
            'train.*:TimeoutError')
    ours = [(c.site, c.exc, c.p, c.seed, c.times)
            for c in fault_injection.parse_spec(spec)]
    ref = [(c.site, c.exc, c.p, c.seed, c.times)
           for c in jfault.parse_spec(spec)]
    assert ours == ref
    with pytest.raises(ValueError):
        fault_injection.parse_spec(f'{ckpt.COMMIT_SITE}:PgError')
    assert fault_injection.parse_spec(spec)[1].matches(ckpt.COMMIT_SITE)
