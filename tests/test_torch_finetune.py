"""The port's finetune against the JAX package's, on the CPU.

TINY (vocab widened to 1024 for the committed tokenizer fixture) at
fp32 compute, written as an HF directory by the JAX package's writer,
finetuned on a text corpus through the fixture's tokenizer:

* LoRA, 8 steps, from the JAX run's adapter init carried over: the
  losses agree with the JAX finetune's step (``make_lora_step`` under
  ``optax.adamw``) within 1e-5 relative and the adapters within 1e-5,
  the ``--export-dir`` params (merged, fp32) with the JAX merge of the
  adapter within 1e-5, and the ``--adapter-export-dir`` artifact loads
  through both packages' ``load_adapter`` against the base's digest.
* Full, 2 steps: losses and exported params against the JAX train step
  with the finetune's ``TrainHParams``.
* ``--checkpoint-dir``: the same command resumed from step 2 gives the
  losses and the final params of an uninterrupted run, bitwise, in
  both modes.
"""
import functools
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from skypilot_tpu.inference import tokenizer as jtokenizer
from skypilot_tpu.models import hf_interop as jhf
from skypilot_tpu.models import lora as jlora
from skypilot_tpu.models.config import get_model_config as jconfig
from skypilot_tpu.serve import adapter_registry as jregistry
from skypilot_tpu.train import finetune as jfinetune
from skypilot_tpu.train import step as jstep
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models import hf_interop as thf
from skypilot_tpu_torch.serve import adapter_registry as tregistry
from skypilot_tpu_torch.train import finetune as tfinetune
from torch_hf_fixture import write_checkpoint
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

LINES = [
    'the model serves a batch of requests from the paged cache',
    'each layer reads its weights once a decode step',
    "it's a small corpus: 12 lines, 3.14 and résumé",
    'attention over the prefix, then the MLP and the head',
] * 3
BATCH, SEQ, LR = 2, 32, 1e-2


@pytest.fixture(scope='module')
def base(tmp_path_factory):
    root = tmp_path_factory.mktemp('ft')
    ckpt = write_checkpoint(root / 'base', jconfig('tiny', vocab_size=1024),
                            seed=11, tokenizer=True)
    data = str(root / 'corpus.txt')
    with open(data, 'w', encoding='utf-8') as f:
        f.write('\n'.join(LINES) + '\n')
    return ckpt, data


def _argv(base, tmp, *extra, steps=8, rank=4):
    ckpt, data = base
    return ['--hf-checkpoint', ckpt, '--data', data, '--steps', str(steps),
            '--batch', str(BATCH), '--seq', str(SEQ), '--learning-rate',
            str(LR), '--lora-rank', str(rank), '--log-every', '1',
            '--device', 'cpu', *extra]


def _jax_lora_run(ckpt, data, steps, rank):
    """The JAX finetune's LoRA loop at fp32 compute: its iterator, init
    (key 0), optimizer and step."""
    params, cfg = jhf.load_checkpoint(ckpt, dtype=jnp.bfloat16,
                                      compute_dtype=jnp.float32,
                                      attention_impl='xla')
    tok = jtokenizer.get_tokenizer(ckpt, require=True)
    batches = jfinetune.text_batch_iterator(data, tok, BATCH, SEQ)
    init = jlora.init_lora_params(jax.random.key(0), cfg, rank)
    optimizer = optax.adamw(LR)
    state = optimizer.init(init)
    step = jfinetune.make_lora_step(params, cfg, optimizer)
    lora, losses = init, []
    for _ in range(steps):
        lora, state, loss = step(lora, state, next(batches))
        losses.append(float(loss))
    return init, losses, lora, params


def _close(got_params, ref_tree, atol):
    got = dict(jax.tree_util.tree_leaves_with_path(
        convert.params_to_numpy(got_params)))
    for path, leaf in jax.tree_util.tree_leaves_with_path(ref_tree):
        np.testing.assert_allclose(
            np.asarray(got[path], np.float32),
            np.asarray(leaf, np.float32), atol=atol, rtol=0,
            err_msg=jax.tree_util.keystr(path))


def test_lora_finetune_matches_jax(base, tmp_path, capsys):
    ckpt, data = base
    init, jlosses, jl, jbase = _jax_lora_run(ckpt, data, 8, 4)
    export, registry = str(tmp_path / 'export'), str(tmp_path / 'reg')
    args = tfinetune.parse_args(_argv(
        base, tmp_path, '--export-dir', export, '--adapter-export-dir',
        registry, '--adapter-name', 'ft'))
    carried = {k: torch.from_numpy(np.array(v)) for k, v in init.items()}
    out = tfinetune.run(args, lora_init=carried,
                        compute_dtype=torch.float32)
    np.testing.assert_allclose(out['losses'], jlosses, rtol=1e-5)
    assert jlosses[-1] < jlosses[0] - 0.01     # the adapter learns
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x['step'] for x in lines if 'step' in x] == list(range(1, 9))
    assert {x.get('mode') for x in lines if 'step' in x} == {'lora-r4'}
    assert {'exported': export} in lines and lines[-1]['done'] is True
    for key in ('wq_a', 'wq_b', 'wv_a', 'wv_b'):
        np.testing.assert_allclose(out['lora'][key].numpy(),
                                   np.asarray(jl[key]), atol=1e-5)
    # The export: merged into the bf16 base, written in fp32, with the
    # tokenizer files alongside; held to the JAX merge of the same
    # adapter (the two runs' adapters differ by ~1e-7, which moves a
    # merged weight near a bf16 rounding boundary by one bf16 step).
    tparams, _ = thf.load_checkpoint(export, device='cpu')
    assert tparams['layers']['attn']['wq'].dtype == torch.float32
    jmerged = jlora.merge(jlora.attach(jbase, {
        k: jnp.asarray(v.numpy()) for k, v in out['lora'].items()}))
    _close(tparams, jmerged, atol=1e-5)
    assert sorted(os.listdir(export)) == [
        'config.json', 'model.safetensors', 'tokenizer.json',
        'tokenizer_config.json']
    # The adapter, pinned to the base by digest, loads in both packages.
    digest = tregistry.checkpoint_digest(ckpt)
    assert digest == jregistry.checkpoint_digest(ckpt)
    adir = os.path.join(registry, 'ft')
    for registry_lib in (tregistry, jregistry):
        name, leaves, meta = registry_lib.load_adapter(
            adir, expect_base_digest=digest)
        assert name == 'ft' and meta['rank'] == 4
        assert meta['hf_checkpoint'] == ckpt and meta['alpha'] == 16.0
        np.testing.assert_array_equal(leaves['wv_b'],
                                      out['lora']['wv_b'].numpy())
        with pytest.raises(ValueError, match='trained against base'):
            registry_lib.load_adapter(adir, expect_base_digest='0' * 64)


def test_full_finetune_matches_jax(base, tmp_path, capsys):
    ckpt, data = base
    params, cfg = jhf.load_checkpoint(ckpt, dtype=jnp.float32,
                                      compute_dtype=jnp.float32,
                                      attention_impl='xla')
    hp = jstep.TrainHParams(learning_rate=LR, warmup_steps=2,
                            total_steps=11)
    optimizer = jstep.make_optimizer(hp)
    state = jstep.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                             opt_state=optimizer.init(params))
    step = jax.jit(functools.partial(jstep.train_step_fn, cfg=cfg,
                                     optimizer=optimizer, hp=hp))
    batches = jfinetune.text_batch_iterator(
        data, jtokenizer.get_tokenizer(ckpt, require=True), BATCH, SEQ)
    jlosses = []
    for _ in range(2):
        state, metrics = step(state, next(batches))
        jlosses.append(float(metrics['loss']))
    export = str(tmp_path / 'export')
    out = tfinetune.run(tfinetune.parse_args(_argv(
        base, tmp_path, '--export-dir', export, steps=2, rank=0)),
        compute_dtype=torch.float32)
    np.testing.assert_allclose(out['losses'], jlosses, rtol=1e-5)
    assert out['lora'] is None
    modes = {json.loads(x).get('mode')
             for x in capsys.readouterr().out.splitlines()}
    assert 'full' in modes
    tparams, _ = thf.load_checkpoint(export, device='cpu')
    _close(tparams, state.params, atol=1e-5)


@pytest.mark.parametrize('rank', [4, 0], ids=['lora', 'full'])
def test_resume_equals_uninterrupted(base, tmp_path, rank):
    """4 steps checkpointed at 2 and 4; the same command run again on a
    copy holding step 2 alone resumes there and ends bitwise equal."""
    whole, part = str(tmp_path / 'whole'), str(tmp_path / 'part')

    def run(directory):
        return tfinetune.run(tfinetune.parse_args(_argv(
            base, tmp_path, '--checkpoint-dir', directory,
            '--checkpoint-every', '2', steps=4, rank=rank)))

    ref = run(whole)
    shutil.copytree(whole, part)
    shutil.rmtree(os.path.join(part, '4'))
    resumed = run(part)
    assert resumed['losses'] == ref['losses'][2:]
    a, b = convert.params_to_numpy(ref['params']), \
        convert.params_to_numpy(resumed['params'])
    for (path, x), (_, y) in zip(jax.tree_util.tree_leaves_with_path(a),
                                 jax.tree_util.tree_leaves_with_path(b)):
        np.testing.assert_array_equal(x, y, err_msg=str(path))


def test_mesh_and_empty_corpus(base, tmp_path, capsys):
    """A full finetune on a stage, an fsdp or a seq mesh runs only in
    the ranks that ``main`` starts; LoRA ignores the mesh with a
    warning; an empty corpus raises."""
    with pytest.raises(RuntimeError, match='starts them'):
        tfinetune.run(tfinetune.parse_args(_argv(
            base, tmp_path, '--mesh', 'stage=2', steps=1, rank=0)))
    with pytest.raises(RuntimeError, match='starts them'):
        tfinetune.run(tfinetune.parse_args(_argv(
            base, tmp_path, '--mesh', 'seq=2', steps=1, rank=0)))
    with pytest.raises(RuntimeError, match='starts them'):
        tfinetune.run(tfinetune.parse_args(_argv(
            base, tmp_path, '--mesh', 'fsdp=2', steps=1, rank=0)))
    out = tfinetune.run(tfinetune.parse_args(_argv(
        base, tmp_path, '--mesh', 'fsdp=2', steps=1, rank=2)))
    assert len(out['losses']) == 1
    assert 'warning' in json.loads(capsys.readouterr().out.splitlines()[0])
    empty = tmp_path / 'empty.txt'
    empty.write_text('\n \n')
    ckpt, _ = base
    with pytest.raises(ValueError, match='empty'):
        tfinetune.run(tfinetune.parse_args(_argv(
            (ckpt, str(empty)), tmp_path, steps=1)))
