"""The port's packer (``data/packer.py``) against the reference's on the
CPU: the same token stream gives the same grids bit for bit, through the
native library and through ``pack_batch_py``; a packed batch's forward
equals JAX's at fp32 (TINY with head_dim 128; 1e-5 relative / 2e-5
absolute, as the dense forward); ``pretrain.main --packed`` counts the
real tokens and launches no fallback.
"""
import itertools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.data import packer as jpacker
from skypilot_tpu.models import config as jconfig
from skypilot_tpu.models import llama as jllama
from skypilot_tpu_torch.data import packer as tpacker
from skypilot_tpu_torch.models import config as tconfig
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models import llama as tllama
from skypilot_tpu_torch.train import pretrain
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

EOS = 1


def _stream(n=6000, seed=0, mean_doc=40, vocab=512):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(2, vocab, n).astype(np.int32)
    tokens[rng.rand(n) < 1 / mean_doc] = EOS
    tokens[100:400] = 7  # one document longer than seq: split in chunks
    return tokens


@pytest.fixture(autouse=True)
def _reference_packer_state(tmp_path, monkeypatch):
    monkeypatch.setenv('SKYT_STATE_DIR', str(tmp_path / 'state'))


@pytest.mark.parametrize('native', [True, False],
                         ids=['native', 'python'])
@pytest.mark.parametrize('batch,seq', [(3, 40), (4, 129), (1, 16)])
def test_grids_match_the_reference(native, batch, seq, monkeypatch):
    """``python``: a host where the native packer does not build."""
    tokens = _stream()
    if not native:
        monkeypatch.setattr(tpacker, '_lib', None)
        monkeypatch.setattr(tpacker, '_lib_error',
                            RuntimeError('no compiler'))
    tpacker.reset_call_counts()
    ours = list(itertools.islice(tpacker.packed_batch_iterator(
        tokens, batch=batch, seq=seq, eos_id=EOS,
        require_native=native), 40))
    ref = list(itertools.islice(jpacker.packed_batch_iterator(
        tokens, batch=batch, seq=seq, eos_id=EOS), 40))
    assert tpacker.CALLS['native' if native else 'python'] >= 40
    assert tpacker.CALLS['python' if native else 'native'] == 0
    for a, b in zip(ours, ref):
        assert sorted(a) == sorted(b)
        for key in a:
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_single_batch_and_loop_end():
    tokens = _stream(500)
    for start in (0, 37, 499):
        a = tpacker.pack_batch_native(tokens, start, EOS, 2, 64)
        b = tpacker.pack_batch_py(tokens, start, EOS, 2, 64)
        c = jpacker.pack_batch_py(tokens, start, EOS, 2, 64)
        assert a[1:] == b[1:] == c[1:]
        for key in a[0]:
            np.testing.assert_array_equal(a[0][key], b[0][key])
            np.testing.assert_array_equal(a[0][key], c[0][key])
    it = tpacker.packed_batch_iterator(tokens, batch=2, seq=64,
                                       eos_id=EOS, loop=False)
    assert sum(1 for _ in it) > 1
    with pytest.raises(ValueError, match='no packable'):
        next(tpacker.packed_batch_iterator(np.zeros(0, np.int32), batch=2,
                                           seq=8, eos_id=EOS))


def test_native_required_raises_when_it_cannot_build(monkeypatch):
    monkeypatch.setattr(tpacker, '_lib', None)
    monkeypatch.setattr(tpacker, '_lib_error', RuntimeError('no compiler'))
    with pytest.raises(RuntimeError, match='native packer unavailable'):
        next(tpacker.packed_batch_iterator(_stream(), batch=2, seq=16,
                                           eos_id=EOS, require_native=True))
    batch = next(tpacker.packed_batch_iterator(_stream(), batch=2, seq=16,
                                               eos_id=EOS))
    assert batch['tokens'].shape == (2, 16)


def test_packed_forward_matches_jax():
    kw = dict(head_dim=128, attention_impl='pallas')
    jcfg = jconfig.get_model_config('tiny', compute_dtype=jnp.float32, **kw)
    tcfg = tconfig.get_model_config('tiny', compute_dtype=torch.float32,
                                    **kw)
    jparams = jllama.init_params(jax.random.key(3), jcfg)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        tcfg, device='cpu')
    batch = next(tpacker.packed_batch_iterator(
        _stream(seed=1), batch=2, seq=128, eos_id=EOS))
    assert batch['segments'].max() > 1
    ref = jllama.forward(jparams, jnp.asarray(batch['tokens']), jcfg,
                         positions=jnp.asarray(batch['positions']),
                         segments=jnp.asarray(batch['segments']))
    with torch.no_grad():
        out = tllama.forward(
            tparams, torch.from_numpy(batch['tokens']), tcfg,
            positions=torch.from_numpy(batch['positions']),
            segments=torch.from_numpy(batch['segments']))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=1e-5)


def test_pretrain_packed_counts_real_tokens(tmp_path, capsys,
                                            monkeypatch):
    path = tmp_path / 'tokens.npy'
    np.save(path, _stream(20000, mean_doc=20))
    seen = []
    from skypilot_tpu_torch.train import step as tstep
    inner = tstep.make_train_step

    def recording(cfg, hp, mesh=None):
        fn = inner(cfg, hp, mesh)

        def step(state, batch):
            seen.append(float(batch['weights'].sum()))
            assert batch['segments'].dtype == torch.int32
            return fn(state, batch)
        return step

    monkeypatch.setattr(tstep, 'make_train_step', recording)
    clock = iter(float(i) for i in range(100))

    class Clock:  # one tick a read, for pretrain's module only
        perf_counter = staticmethod(lambda: next(clock))

    monkeypatch.setattr(pretrain, 'time', Clock)
    assert pretrain.main(['--model', 'tiny', '--device', 'cpu', '--batch',
                          '2', '--seq', '64', '--steps', '2',
                          '--log-every', '2', '--packed', '--data',
                          str(path), '--eos-id', str(EOS)]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert len(seen) == 2 and 0 < sum(seen) < 2 * 2 * 64
    # One clock tick a window read: tokens/s is the real tokens of both
    # steps over the window's length.
    assert lines[0]['tokens_per_sec'] == round(sum(seen) / 1.0, 1)
    assert np.isfinite(lines[0]['loss'])
