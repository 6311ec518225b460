"""The port's HF checkpoint interop against the JAX package's, on the CPU.

Checkpoints are written by ``skypilot_tpu.models.hf_interop`` (its own
writer) from params drawn with seeded numpy; the port must load them
bitwise equal to the JAX loader's result carried over by
``models/convert.py`` (fp32 and bf16, dense, TINY_MOE, tied
embeddings, llama3 rope scaling, a sharded ``index.json`` directory),
write ``model.safetensors`` byte-identical to the JAX writer's and an
equal ``config.json``, give fp32 logits within 2e-5, refuse what the
JAX loader refuses with the same error types, and digest a directory
as the JAX registry does. Then, from such a directory (TINY at vocab
1024 with the committed tokenizer fixture, params loaded at fp32 and
passed in so that the tokenizer comes from the directory), both engines
give the JAX engines' greedy tokens and texts, the server's
``/generate``, ``/v1/completions`` and ``/v1/chat/completions`` give the
JAX server's payloads, ``--hf-checkpoint --lora-dir`` binds adapters to
the checkpoint's digest, the batch worker reads a directory, and an
engine built with ``checkpoint_dir=`` from ``pretrain
--checkpoint-dir`` output gives the tokens of the same params passed in.
"""
import dataclasses
import json
import os
import threading
import urllib.request

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from skypilot_tpu.inference import server as jserver
from skypilot_tpu.inference.continuous import (
    ContinuousBatchingEngine as JaxContinuous)
from skypilot_tpu.inference.engine import InferenceEngine as JaxBatch
from skypilot_tpu.models import config as jconfig
from skypilot_tpu.models import hf_interop as jhf
from skypilot_tpu.models import llama as jllama
from skypilot_tpu.serve import adapter_registry as jregistry
from skypilot_tpu_torch.batch import infer_worker
from skypilot_tpu_torch.inference import server as tserver
from skypilot_tpu_torch.inference import tokenizer as ttokenizer
from skypilot_tpu_torch.inference.continuous import (
    ContinuousBatchingEngine as TorchContinuous)
from skypilot_tpu_torch.inference.engine import InferenceEngine as TorchBatch
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models import hf_interop as thf
from skypilot_tpu_torch.models import llama as tllama
from skypilot_tpu_torch.models import lora as tlora
from skypilot_tpu_torch.serve import adapter_registry as tregistry
from skypilot_tpu_torch.train import pretrain as tpretrain
from torch_hf_fixture import numpy_params, write_checkpoint
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

LLAMA3_SCALING = dict(rope_scaling_factor=8.0, rope_low_freq_factor=1.0,
                      rope_high_freq_factor=4.0,
                      rope_original_max_position=64)


def _jcfg(name='tiny', **overrides):
    return jconfig.get_model_config(name, **overrides)


def _write_jax_checkpoint(tmp_path, cfg, file_dtype=None, seed=0):
    return write_checkpoint(tmp_path / 'ckpt', cfg, seed=seed,
                            file_dtype=file_dtype)


def _shard(directory):
    """Split ``model.safetensors`` into two shards and an index."""
    path = os.path.join(directory, 'model.safetensors')
    with jhf.SafetensorsReader(path) as reader:
        tensors = {k: np.array(reader.get(k)) for k in reader.keys()}
    os.unlink(path)
    names = sorted(tensors)
    halves = {'model-00001-of-00002.safetensors': names[::2],
              'model-00002-of-00002.safetensors': names[1::2]}
    weight_map = {}
    for fn, keys in halves.items():
        jhf.write_safetensors(os.path.join(directory, fn),
                              {k: tensors[k] for k in keys})
        weight_map.update({k: fn for k in keys})
    with open(os.path.join(directory, 'model.safetensors.index.json'),
              'w') as f:
        json.dump({'weight_map': weight_map}, f)


def _flat(tree, prefix=''):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f'{prefix}{k}/'))
        return out
    return {prefix[:-1]: tree}


def _assert_bitwise(tparams, jparams_torch):
    a, b = _flat(tparams), _flat(jparams_torch)
    assert sorted(a) == sorted(b)
    for key in a:
        assert a[key].dtype == b[key].dtype, key
        assert a[key].shape == b[key].shape, key
        assert torch.equal(a[key].view(-1).view(torch.uint8)
                           if a[key].dtype == torch.bfloat16 else a[key],
                           b[key].view(-1).view(torch.uint8)
                           if b[key].dtype == torch.bfloat16 else b[key]), key


CASES = {
    'dense': dict(name='tiny'),
    'moe': dict(name='tiny-moe'),
    'tied': dict(name='tiny', tie_embeddings=True),
    'rope-scaling': dict(name='tiny', **LLAMA3_SCALING),
    'sharded': dict(name='tiny', shard=True),
}
DTYPES = {'fp32': (None, None, None),
          'bf16-file': (ml_dtypes.bfloat16, None, None),
          'bf16-load': (None, jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize('dtypes', list(DTYPES))
@pytest.mark.parametrize('case', list(CASES))
def test_load_is_bitwise_the_jax_load(tmp_path, case, dtypes):
    spec = dict(CASES[case])
    shard = spec.pop('shard', False)
    cfg = _jcfg(**spec)
    file_dt, jload_dt, tload_dt = DTYPES[dtypes]
    path = _write_jax_checkpoint(tmp_path, cfg, file_dtype=file_dt)
    if shard:
        _shard(path)
    jparams, jcfg = jhf.load_checkpoint(path, dtype=jload_dt)
    tparams, tcfg = thf.load_checkpoint(path, dtype=tload_dt,
                                        device='cpu')
    for field in ('vocab_size', 'd_model', 'n_layers', 'n_heads',
                  'n_kv_heads', 'd_ff', 'head_dim', 'rope_theta',
                  'norm_eps', 'max_seq_len', 'tie_embeddings',
                  'num_experts', 'experts_per_token', 'rope_scaling',
                  'name'):
        assert getattr(tcfg, field) == getattr(jcfg, field), field
    assert tcfg.param_dtype == (tload_dt or torch.float32)
    carried = convert.params_from_numpy(
        jax.tree.map(np.asarray, jparams), tcfg, 'cpu')
    _assert_bitwise(tparams, carried)


@pytest.mark.parametrize('case', ['dense', 'moe', 'tied', 'bf16'])
def test_save_is_byte_identical(tmp_path, case):
    cfg = _jcfg('tiny-moe' if case == 'moe' else 'tiny',
                tie_embeddings=case == 'tied', **LLAMA3_SCALING)
    np_params = numpy_params(cfg, seed=3)
    jdir, tdir = str(tmp_path / 'jax'), str(tmp_path / 'torch')
    bf16 = case == 'bf16'
    jhf.save_checkpoint(np_params, cfg, jdir,
                        dtype=ml_dtypes.bfloat16 if bf16 else None)
    tcfg = thf.load_config(jdir)
    tparams = convert.params_from_numpy(np_params, tcfg, 'cpu')
    thf.save_checkpoint(tparams, tcfg, tdir,
                        dtype=torch.bfloat16 if bf16 else None)
    with open(os.path.join(jdir, 'model.safetensors'), 'rb') as f:
        jbytes = f.read()
    with open(os.path.join(tdir, 'model.safetensors'), 'rb') as f:
        assert f.read() == jbytes
    with open(os.path.join(jdir, 'config.json')) as f:
        jconf = json.load(f)
    with open(os.path.join(tdir, 'config.json')) as f:
        assert json.load(f) == jconf
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))


def test_fp32_logits_agree(tmp_path):
    cfg = _jcfg('tiny', **LLAMA3_SCALING)
    path = _write_jax_checkpoint(tmp_path, cfg, seed=5)
    tokens = np.random.default_rng(6).integers(0, 512, (2, 19))
    jparams, jcfg = jhf.load_checkpoint(path, compute_dtype=jnp.float32,
                                        attention_impl='xla')
    jlogits = np.asarray(jllama.forward(jparams, jnp.asarray(tokens),
                                        jcfg))
    tparams, tcfg = thf.load_checkpoint(path, device='cpu',
                                        compute_dtype=torch.float32)
    with torch.no_grad():
        tlogits = tllama.forward(tparams, torch.as_tensor(tokens),
                                 tcfg).numpy()
    np.testing.assert_allclose(tlogits, jlogits, atol=2e-5, rtol=2e-5)


def _edit_config(path, **changes):
    with open(os.path.join(path, 'config.json')) as f:
        conf = json.load(f)
    conf.update(changes)
    with open(os.path.join(path, 'config.json'), 'w') as f:
        json.dump(conf, f)


def _edit_tensors(path, drop=None, add=None):
    st = os.path.join(path, 'model.safetensors')
    with jhf.SafetensorsReader(st) as reader:
        tensors = {k: np.array(reader.get(k)) for k in reader.keys()}
    if drop:
        del tensors[drop]
    if add:
        tensors[add] = np.zeros((3,), np.float32)
    jhf.write_safetensors(st, tensors)


REJECTIONS = {
    'unmapped': lambda p: _edit_tensors(p, add='model.layers.0.extra.w'),
    'incomplete': lambda p: _edit_tensors(
        p, drop='model.layers.1.mlp.up_proj.weight'),
    'qwen2': lambda p: _edit_config(p, model_type='qwen2'),
    'gemma': lambda p: _edit_config(p, model_type='gemma'),
    'sliding_window': lambda p: _edit_config(p, sliding_window=4096),
    'bias': lambda p: _edit_config(p, attention_bias=True),
    'rope_scaling': lambda p: _edit_config(
        p, rope_scaling={'type': 'linear', 'factor': 2.0}),
    'model_type': lambda p: _edit_config(p, model_type='gpt2'),
}


@pytest.mark.parametrize('case', list(REJECTIONS))
def test_rejections_match(tmp_path, case):
    path = _write_jax_checkpoint(tmp_path, _jcfg('tiny'))
    REJECTIONS[case](path)
    with pytest.raises(Exception) as jerr:
        jhf.load_checkpoint(path)
    with pytest.raises(Exception) as terr:
        thf.load_checkpoint(path, device='cpu')
    assert terr.type is jerr.type is ValueError
    assert str(terr.value) == str(jerr.value)


def test_inv_freq_and_tied_head_are_skipped(tmp_path):
    cfg = _jcfg('tiny', tie_embeddings=True)
    path = _write_jax_checkpoint(tmp_path, cfg)
    st = os.path.join(path, 'model.safetensors')
    with jhf.SafetensorsReader(st) as reader:
        tensors = {k: np.array(reader.get(k)) for k in reader.keys()}
    tensors['lm_head.weight'] = tensors['model.embed_tokens.weight']
    tensors['model.layers.0.self_attn.rotary_emb.inv_freq'] = np.ones(
        (8,), np.float32)
    jhf.write_safetensors(st, tensors)
    jparams, _ = jhf.load_checkpoint(path)
    tparams, tcfg = thf.load_checkpoint(path, device='cpu')
    _assert_bitwise(tparams, convert.params_from_numpy(
        jax.tree.map(np.asarray, jparams), tcfg, 'cpu'))


def test_checkpoint_digest_is_the_jax_digest(tmp_path):
    path = _write_jax_checkpoint(tmp_path, _jcfg('tiny'))
    assert tregistry.checkpoint_digest(path) == \
        jregistry.checkpoint_digest(path)


def test_reader_views_are_private(tmp_path):
    """A write into a tensor ``get`` returned never reaches the file."""
    path = os.path.join(tmp_path, 'x.safetensors')
    thf.write_safetensors(path, {'a': torch.arange(6, dtype=torch.int32),
                                 'b': torch.ones(2, dtype=torch.bfloat16)})
    with thf.SafetensorsReader(path) as reader:
        a = reader.get('a')
        a.fill_(7)
        assert reader.get('b').dtype == torch.bfloat16
    with thf.SafetensorsReader(path) as reader:
        assert reader.get('a').tolist() == list(range(6))
    assert not os.path.exists(path + '.tmp')


def test_resolve_engine_inputs_defaults_to_bf16(tmp_path):
    path = _write_jax_checkpoint(tmp_path, _jcfg('tiny'))
    params, cfg = thf.resolve_engine_inputs(path, None, None, device='cpu')
    assert params['layers']['attn']['wq'].dtype == torch.bfloat16
    assert cfg.param_dtype == torch.bfloat16
    same, cfg2 = thf.resolve_engine_inputs(path, params, None)
    assert same is params and cfg2.vocab_size == 512
    assert thf.resolve_engine_inputs(None, 'p', 'c') == ('p', 'c')
    assert dataclasses.is_dataclass(cfg)


# ---------------------------------------------------------------------------
# Engines, server and batch worker from checkpoint directories
# ---------------------------------------------------------------------------

PROMPTS = ['hello world', 'the quick brown fox<|eot_id|> jumps',
           'résumé 2048 数据']
MESSAGES = [{'role': 'system', 'content': 'be brief'},
            {'role': 'user', 'content': 'hi there'}]
KW = dict(max_slots=2, max_len=96)


@pytest.fixture(scope='module')
def hf_dir(tmp_path_factory):
    """TINY (vocab 1024) with the committed tokenizer fixture, and its
    params loaded at fp32 compute by both packages."""
    path = write_checkpoint(tmp_path_factory.mktemp('hf') / 'ckpt',
                            _jcfg('tiny', vocab_size=1024), seed=21,
                            tokenizer=True)
    jparams, jcfg = jhf.load_checkpoint(path, dtype=jnp.float32,
                                        compute_dtype=jnp.float32,
                                        attention_impl='xla')
    tparams, tcfg = thf.load_checkpoint(path, dtype=torch.float32,
                                        device='cpu',
                                        compute_dtype=torch.float32)
    return path, jparams, jcfg, tparams, tcfg


def _engines(hf_dir, kind):
    path, jparams, jcfg, tparams, tcfg = hf_dir
    if kind == 'batch':
        return (JaxBatch(hf_checkpoint=path, params=jparams, cfg=jcfg,
                         max_batch=4),
                TorchBatch(hf_checkpoint=path, params=tparams, cfg=tcfg,
                           device='cpu', max_batch=4))
    return (JaxContinuous(hf_checkpoint=path, params=jparams, cfg=jcfg,
                          **KW),
            TorchContinuous(hf_checkpoint=path, params=tparams, cfg=tcfg,
                            device='cpu', **KW))


def _shutdown(*engines):
    for engine in engines:
        if hasattr(engine, 'shutdown'):
            engine.shutdown()


@pytest.mark.parametrize('kind', ['batch', 'continuous'])
def test_engines_from_hf_checkpoint_match_jax(hf_dir, kind):
    jeng, teng = _engines(hf_dir, kind)
    try:
        assert isinstance(teng.tokenizer, ttokenizer.HFTokenizer)
        ids = [teng.tokenizer.encode(p) for p in PROMPTS]
        assert ids == [jeng.tokenizer.encode(p) for p in PROMPTS]
        if kind == 'batch':
            assert teng.generate_ids(ids, max_new_tokens=10) == \
                jeng.generate_ids(ids, max_new_tokens=10)
            assert teng.generate_text(PROMPTS, max_new_tokens=10) == \
                jeng.generate_text(PROMPTS, max_new_tokens=10)
        else:
            for p, i in zip(PROMPTS, ids):
                assert teng.generate_ids(i, max_new_tokens=10) == \
                    jeng.generate_ids(i, max_new_tokens=10)
                assert teng.generate_text(p, max_new_tokens=10) == \
                    jeng.generate_text(p, max_new_tokens=10)
    finally:
        _shutdown(jeng, teng)


class _Server:
    def __init__(self, serve, engine):
        self.server = serve(engine, '127.0.0.1', 0)
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()

    def post(self, path, payload):
        req = urllib.request.Request(
            f'http://127.0.0.1:{self.port}{path}',
            data=json.dumps(payload).encode(),
            headers={'Content-Type': 'application/json'})
        with urllib.request.urlopen(req, timeout=120) as resp:
            body = json.loads(resp.read())
        body.pop('id', None)
        body.pop('created', None)
        return body

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)


@pytest.mark.parametrize('kind', ['batch', 'continuous'])
def test_server_payloads_match_jax(hf_dir, kind):
    jeng, teng = _engines(hf_dir, kind)
    jsrv, tsrv = _Server(jserver.serve, jeng), _Server(tserver.serve, teng)
    try:
        for path, body in (
                ('/generate', {'prompts': PROMPTS, 'max_new_tokens': 8}),
                ('/v1/chat/completions', {'messages': MESSAGES,
                                          'max_tokens': 6}),
                ('/v1/completions', {'prompt': PROMPTS[1],
                                     'max_tokens': 6})):
            assert tsrv.post(path, body) == jsrv.post(path, body), path
        rendered = teng.tokenizer.apply_chat_template(MESSAGES)
        assert rendered.startswith(
            '<|begin_of_text|><|start_header_id|>system<|end_header_id|>')
    finally:
        jsrv.close()
        tsrv.close()
        _shutdown(jeng, teng)


def test_server_flags_bind_adapters_to_the_checkpoint(hf_dir, tmp_path):
    """--hf-checkpoint with --lora-dir: the served checkpoint's digest
    admits an adapter exported against it and skips one that was not."""
    path, _, _, _, tcfg = hf_dir
    registry = str(tmp_path / 'reg')
    lora = tlora.init_lora_params(1, tcfg, 4, device='cpu')
    tregistry.export_adapter(registry, 'good', lora, alpha=16.0,
                             base_digest=tregistry.checkpoint_digest(path))
    tregistry.export_adapter(registry, 'stale', lora, alpha=16.0,
                             base_digest='f' * 64)
    engine = tserver.build_engine(tserver.parse_args([
        '--hf-checkpoint', path, '--device', 'cpu', '--engine',
        'continuous', '--max-batch', '2', '--max-len', '64',
        '--lora-pages', '2', '--lora-max-rank', '4', '--lora-dir',
        registry]))
    try:
        assert engine.base_digest == tregistry.checkpoint_digest(path)
        assert sorted(engine.adapter_stats()) == ['good']
        assert engine.params['layers']['attn']['wq'].dtype == \
            torch.bfloat16
        assert isinstance(engine.tokenizer, ttokenizer.HFTokenizer)
    finally:
        engine.shutdown()
    batch = tserver.build_engine(tserver.parse_args([
        '--hf-checkpoint', path, '--device', 'cpu', '--max-batch', '2']))
    assert batch.cfg.vocab_size == 1024
    assert isinstance(batch.tokenizer, ttokenizer.HFTokenizer)


def test_batch_worker_reads_a_directory(hf_dir, tmp_path):
    path = hf_dir[0]
    src, dst = tmp_path / 'in.jsonl', tmp_path / 'out.jsonl'
    src.write_text(''.join(json.dumps({'prompt': p, 'k': i}) + '\n'
                           for i, p in enumerate(PROMPTS)))
    assert infer_worker.main(['--model', path, '--device', 'cpu',
                              '--input', str(src), '--output', str(dst),
                              '--max-new-tokens', '6']) == 0
    rows = [json.loads(x) for x in dst.read_text().splitlines()]
    want = TorchBatch(hf_checkpoint=path, device='cpu').generate_text(
        PROMPTS, max_new_tokens=6)
    assert [r['completion'] for r in rows] == want
    assert [r['k'] for r in rows] == [0, 1, 2]


def test_engines_serve_a_training_checkpoint(tmp_path, capsys):
    """``checkpoint_dir=``: the params of pretrain's last committed step,
    the same tokens as those params passed in; an empty directory gives
    the seeded init."""
    ckpt = str(tmp_path / 'run')
    assert tpretrain.main(['--model', 'tiny', '--steps', '2', '--device',
                           'cpu', '--batch', '2', '--seq', '32',
                           '--checkpoint-dir', ckpt]) == 0
    with thf.SafetensorsReader(os.path.join(ckpt, '2', 'state.safetensors')
                               ) as reader:
        flat = {k[len('params/'):]: reader.get(k).clone()
                for k in reader.keys() if k.startswith('params/')}
    params = {}
    for key, value in flat.items():
        node = params
        *parents, leaf = key.split('/')
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    ids = [[5, 6, 7, 8], [9, 10]]
    for engine_cls in (TorchBatch, TorchContinuous):
        kw = KW if engine_cls is TorchContinuous else {}
        from_dir = engine_cls('tiny', checkpoint_dir=ckpt, device='cpu',
                              **kw)
        given = engine_cls('tiny', params=params, device='cpu', **kw)
        try:
            torch.testing.assert_close(
                from_dir.params['layers']['attn']['wq'],
                given.params['layers']['attn']['wq'], rtol=0, atol=0)
            if engine_cls is TorchBatch:
                assert from_dir.generate_ids(ids, max_new_tokens=6) == \
                    given.generate_ids(ids, max_new_tokens=6)
            else:
                for i in ids:
                    assert from_dir.generate_ids(i, max_new_tokens=6) == \
                        given.generate_ids(i, max_new_tokens=6)
        finally:
            _shutdown(from_dir, given)
    empty = TorchBatch('tiny', checkpoint_dir=str(tmp_path / 'none'),
                       device='cpu', seed=3)
    served = empty.params['layers']['attn']['wq']
    torch.testing.assert_close(
        served, tllama.init_params(3, empty.cfg, device='cpu')['layers'][
            'attn']['wq'].to(served.dtype), rtol=0, atol=0)


def test_a_mis_sized_tensor_raises(tmp_path):
    """A tensor that would broadcast into its slot (a [1] norm scale)
    raises instead of filling the slot."""
    path = _write_jax_checkpoint(tmp_path, _jcfg('tiny'))
    st = os.path.join(path, 'model.safetensors')
    with jhf.SafetensorsReader(st) as reader:
        tensors = {k: np.array(reader.get(k)) for k in reader.keys()}
    tensors['model.norm.weight'] = np.ones((1,), np.float32)
    jhf.write_safetensors(st, tensors)
    with pytest.raises(ValueError, match='does not fit'):
        thf.load_checkpoint(path, device='cpu')
