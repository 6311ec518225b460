"""The port's batch ``InferenceEngine`` and W8A8 weights against the JAX
reference, on the CPU.

Both sides serve TINY with fp32 compute and the same weights (the JAX
engine's, carried over by ``models/convert.py``). ``prefill`` and
``decode_step`` logits agree within 2e-5 for fp and int8 caches; greedy
tokens of ``generate_ids`` agree token for token, chunking and EOS
truncation included; ``embed_text`` within 1e-5. The port's batch and
continuous engines agree with each other, the HTTP server's ``--engine
batch`` and the JSONL batch worker run end to end, and the W8A8 path
(``models/quant.py``) is held to the reference's.
"""
import json
import socket
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.inference.engine import InferenceEngine as JaxEngine
from skypilot_tpu.models import decode as jdecode
from skypilot_tpu.models import quant as jquant
from skypilot_tpu.models.config import get_model_config as jax_config
from skypilot_tpu.models.config import with_int8_kv_cache as jax_int8
from skypilot_tpu_torch.batch import infer_worker
from skypilot_tpu_torch.inference import server as tserver
from skypilot_tpu_torch.inference.continuous import ContinuousBatchingEngine
from skypilot_tpu_torch.inference.engine import InferenceEngine
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models import decode as tdecode
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.models import quant as tquant
from skypilot_tpu_torch.models.config import get_model_config as torch_config
from skypilot_tpu_torch.models.config import with_int8_kv_cache as torch_int8
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

PROMPTS = [[3, 1, 4, 1, 5], [2, 7, 18] * 7, [31, 41, 59, 26, 5, 3]]


@pytest.fixture(scope='module')
def engines():
    ref = JaxEngine('tiny', cfg=jax_config('tiny', compute_dtype=jnp.float32),
                    max_batch=2)
    jparams = jax.tree.map(np.asarray, ref.params)
    params = convert.params_from_numpy(jparams, torch_config('tiny'),
                                       device='cpu')
    port = InferenceEngine('tiny', cfg=torch_config(
        'tiny', compute_dtype=torch.float32), params=params, device='cpu',
        max_batch=2)
    return ref, port, jparams, params


def _tokens(seed=1, b=2, s=16, lengths=(16, 9)):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, 512, (b, s)).astype(np.int32)
    return tokens, np.asarray(lengths, np.int32)


def _close(got, want, tol):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize('int8', [False, True], ids=['fp', 'int8'])
def test_prefill_and_decode_step_logits_match(engines, int8):
    _, _, jparams, params = engines
    jcfg = jax_config('tiny', compute_dtype=jnp.float32)
    tcfg = torch_config('tiny', compute_dtype=torch.float32)
    if int8:
        jcfg, tcfg = jax_int8(jcfg), torch_int8(tcfg)
    tokens, lengths = _tokens()
    jl, jcache = jdecode.prefill(jparams, jnp.asarray(tokens),
                                 jnp.asarray(lengths), jcfg, 24)
    tl, tcache = tdecode.prefill(params, torch.from_numpy(tokens),
                                 torch.from_numpy(lengths), tcfg, 24)
    _close(tl.numpy(), jl, 2e-5)
    assert tcache.quantized == int8 and tcache.max_len == 24
    step = np.array([7, 300], np.int32)
    for _ in range(2):
        jl, jcache = jdecode.decode_step(jparams, jnp.asarray(step), jcache,
                                         jcfg)
        tl, tcache = tdecode.decode_step(params, torch.from_numpy(step),
                                         tcache, tcfg)
        _close(tl.numpy(), jl, 2e-5)
        step = np.array(jnp.argmax(jl, axis=-1), np.int32)
    np.testing.assert_array_equal(tcache.lengths.numpy(),
                                  np.asarray(jcache.lengths))
    if int8:
        np.testing.assert_array_equal(tcache.k.numpy(),
                                      np.asarray(jcache.k))
    else:
        _close(tcache.k.numpy(), jcache.k, 2e-5)


def test_inactive_row_writes_nothing():
    """``active=False`` leaves the cache row alone and the length where
    it was, as the reference's one-hot write does."""
    cfg = torch_config('tiny', compute_dtype=torch.float32)
    from skypilot_tpu_torch.models import llama
    params = llama.init_params(3, cfg, device='cpu')
    tokens, lengths = _tokens(b=2, s=8, lengths=(8, 4))
    _, cache = tdecode.prefill(params, torch.from_numpy(tokens),
                               torch.from_numpy(lengths), cfg, 12)
    before = cache.k.clone()
    _, cache = tdecode.decode_step(params, torch.tensor([5, 6]), cache, cfg,
                                   active=torch.tensor([True, False]))
    assert cache.lengths.tolist() == [9, 4]
    assert torch.equal(cache.k[:, 1], before[:, 1])
    assert not torch.equal(cache.k[:, 0, 8], before[:, 0, 8])


def test_full_cache_row_write():
    """A sequence at max_len: with ``active`` given it writes nothing
    (the reference's one-hot matches no row); without ``active`` every
    sequence writes, and a row past the cache fails the index."""
    cfg = torch_config('tiny', compute_dtype=torch.float32)
    from skypilot_tpu_torch.models import llama
    params = llama.init_params(3, cfg, device='cpu')
    tokens, lengths = _tokens(b=2, s=8, lengths=(8, 4))
    _, cache = tdecode.prefill(params, torch.from_numpy(tokens),
                               torch.from_numpy(lengths), cfg, 8)
    before = cache.k.clone()
    _, after = tdecode.decode_step(params, torch.tensor([5, 6]), cache, cfg,
                                   active=torch.tensor([True, True]))
    assert after.lengths.tolist() == [9, 5]
    assert torch.equal(after.k[:, 0], before[:, 0])
    assert not torch.equal(after.k[:, 1, 4], before[:, 1, 4])
    with pytest.raises(IndexError):
        tdecode.decode_step(params, torch.tensor([5, 6]), cache, cfg)


def test_generate_ids_match_reference_with_chunking(engines):
    """Three prompts over max_batch=2: two chunks, padded batch rows."""
    ref, port, _, _ = engines
    assert port.generate_ids(PROMPTS, max_new_tokens=10) == \
        ref.generate_ids(PROMPTS, max_new_tokens=10)
    assert port.stats['requests'] >= 3
    assert port.stats['tokens_generated'] >= 30


def test_generate_eos_truncation_matches_reference(engines):
    """An EOS id taken from the greedy stream itself: both sides emit it
    from its first position on and report the same lengths."""
    _, _, jparams, params = engines
    jcfg = jax_config('tiny', compute_dtype=jnp.float32)
    tcfg = torch_config('tiny', compute_dtype=torch.float32)
    tokens, lengths = _tokens(seed=2)
    free, _ = tdecode.generate(params, torch.from_numpy(tokens),
                               torch.from_numpy(lengths), tcfg,
                               max_new_tokens=8)
    eos = int(free[0, 3])
    tg, tlen = tdecode.generate(params, torch.from_numpy(tokens),
                                torch.from_numpy(lengths), tcfg,
                                max_new_tokens=8, eos_id=eos)
    jg, jlen = jdecode.generate(jparams, jnp.asarray(tokens),
                                jnp.asarray(lengths), jcfg,
                                max_new_tokens=8, eos_id=eos)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    assert int(tlen[0]) <= 3 and (tg[0, int(tlen[0]):] == eos).all()


def test_sampling_is_a_function_of_the_seed(engines):
    _, port, _, _ = engines
    a = port.generate_ids(PROMPTS[:2], 8, temperature=1.0, seed=3)
    b = port.generate_ids(PROMPTS[:2], 8, temperature=1.0, seed=3)
    c = port.generate_ids(PROMPTS[:2], 8, temperature=1.0, seed=4)
    assert a == b and a != c


def test_embed_text_matches_reference(engines):
    ref, port, _, _ = engines
    texts = ['hello', 'a longer text to embed', 'x']
    got = port.embed_text(texts)
    assert got.shape == (3, 64) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(ref.embed_text(texts)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, rtol=1e-5)
    assert port.embed_text([]).shape == (0, 64)


def test_batch_and_continuous_engines_agree(engines):
    _, port, _, params = engines
    cont = ContinuousBatchingEngine(
        'tiny', cfg=torch_config('tiny', compute_dtype=torch.float32),
        params=params, device='cpu', max_slots=2, max_len=96)
    try:
        eos = cont.tokenizer.eos_id
        want = [cont.generate_ids(p, max_new_tokens=9, eos_id=eos)
                for p in PROMPTS]
    finally:
        cont.shutdown()
    assert port.generate_ids(PROMPTS, max_new_tokens=9) == want


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def test_server_main_batch_engine(monkeypatch):
    """``server.main(['--engine', 'batch', ...])`` serves /generate,
    /health and /stats until the server is shut down."""
    servers = []
    real_serve = tserver.serve

    def serve(engine, host, port):
        server = real_serve(engine, host, port)
        servers.append(server)
        return server

    monkeypatch.setattr(tserver, 'serve', serve)
    port = _free_port()
    result = []
    thread = threading.Thread(target=lambda: result.append(tserver.main(
        ['--engine', 'batch', '--model', 'tiny', '--device', 'cpu',
         '--host', '127.0.0.1', '--port', str(port), '--max-batch', '2'])),
        daemon=True)
    thread.start()
    base = f'http://127.0.0.1:{port}'
    try:
        for _ in range(600):
            if servers:
                break
            thread.join(0.1)
        assert servers, 'server did not start'
        body = json.dumps({'prompts': ['a', 'bb', 'ccc'],
                           'max_new_tokens': 4}).encode()
        req = urllib.request.Request(
            f'{base}/generate', data=body,
            headers={'Content-Type': 'application/json'})
        with urllib.request.urlopen(req, timeout=120) as resp:
            payload = json.loads(resp.read())
        assert list(payload) == ['outputs'] and len(payload['outputs']) == 3
        health = json.loads(urllib.request.urlopen(f'{base}/health',
                                                   timeout=10).read())
        assert health == {'status': 'ok', 'model': 'tiny'}
        stats = json.loads(urllib.request.urlopen(f'{base}/stats',
                                                  timeout=10).read())
        assert stats['requests'] == 4       # the warm-up + 3 prompts
        assert set(stats) == {'requests', 'tokens_generated',
                              'decode_seconds'}
    finally:
        if servers:
            servers[0].shutdown()
        thread.join(30)
    assert result == [0]


@pytest.mark.parametrize('embeddings', [False, True],
                         ids=['completions', 'embeddings'])
def test_infer_worker_jsonl(tmp_path, embeddings):
    src = tmp_path / 'in.jsonl'
    dst = tmp_path / 'out.jsonl'
    records = [{'id': i, 'prompt': p} for i, p in
               enumerate(['one', 'two words', 'three more words'])]
    src.write_text(''.join(json.dumps(r) + '\n' for r in records) + '\n')
    argv = ['--model', 'tiny', '--device', 'cpu', '--input', str(src),
            '--output', str(dst), '--max-new-tokens', '4', '--max-batch',
            '2']
    assert infer_worker.main(argv + (['--embeddings'] if embeddings
                                     else [])) == 0
    out = [json.loads(x) for x in dst.read_text().splitlines()]
    assert [r['id'] for r in out] == [0, 1, 2]
    for record in out:
        if embeddings:
            vec = np.asarray(record['embedding'])
            assert vec.shape == (64,)
            assert abs(np.linalg.norm(vec) - 1) < 1e-4
        else:
            assert isinstance(record['completion'], str)


# ---------------------------------------------------------------------------
# W8A8
# ---------------------------------------------------------------------------

SPECS = [('bsd,dhk->bshk', (2, 3, 64), (64, 4, 16), (0,)),
         ('bshk,hkd->bsd', (2, 3, 4, 16), (4, 16, 64), (0, 1)),
         ('bsd,df->bsf', (2, 3, 64), (64, 128), (0,)),
         ('bsf,fd->bsd', (2, 3, 128), (128, 64), (0,)),
         ('bsd,dv->bsv', (2, 1, 64), (64, 512), (0,))]


@pytest.mark.parametrize('spec,xs,ws,axes', SPECS,
                         ids=[s[0] for s in SPECS])
def test_weight_einsum_int8_matches_reference(spec, xs, ws, axes):
    rng = np.random.RandomState(len(spec))
    x = rng.randn(*xs).astype(np.float32)
    w = rng.randn(*ws).astype(np.float32)
    jq = jquant.quantize_tensor(jnp.asarray(w), axes)
    tq = tquant.quantize_tensor(torch.from_numpy(w), axes)
    np.testing.assert_array_equal(tq.q.numpy(), np.asarray(jq.q))
    # scales equal within one ulp
    np.testing.assert_allclose(tq.scale.numpy(), np.asarray(jq.scale),
                               rtol=1.2e-7, atol=0)
    want = np.asarray(jquant.weight_einsum(spec, jnp.asarray(x), jq,
                                           jnp.float32))
    got = tquant.weight_einsum(spec, torch.from_numpy(x), tq,
                               torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    fp = np.asarray(jnp.einsum(spec, x, w))
    rel = np.linalg.norm(got - fp) / np.linalg.norm(fp)
    assert rel < 0.02, rel
    with pytest.raises(ValueError, match='cannot scale'):
        tquant.weight_einsum('bsd,edf->ebsf', torch.zeros(2, 3, 64),
                             tquant.quantize_tensor(torch.zeros(4, 64, 8),
                                                    (1,)), torch.float32)


def test_int8_matmul_is_exact_past_fp32():
    """Sums past 2^24 stay exact (an fp32 accumulator would round)."""
    a = torch.full((2, 14336), 127, dtype=torch.int8)
    b = torch.full((14336, 8), 127, dtype=torch.int8)
    b[0, 0] = 126
    out = tquant.int8_matmul(a, b)
    assert out.dtype == torch.int32
    assert out[0, 1].item() == 127 * 127 * 14336
    assert out[0, 0].item() == 127 * 127 * 14336 - 127


def test_quantize_params_halves_bytes_and_keeps_structure(engines):
    _, _, _, params = engines
    qparams = tquant.quantize_params(params)
    assert tquant.param_bytes(qparams) < 0.55 * tquant.param_bytes(params)
    attn = qparams['layers']['attn']
    assert isinstance(attn['wq'], tquant.QTensor)
    assert attn['wq'].q.dtype == torch.int8
    assert attn['wq'].scale.shape == (2, 1, 4, 16)
    assert isinstance(qparams['embed']['embedding'], torch.Tensor)
    assert set(qparams) == set(params)
    # quantize_moe on a MoE tree: the experts become QTensors with
    # per-(layer, expert, out-channel) scales, the router stays fp.
    moe_cfg = torch_config('tiny-moe')
    moe = tquant.quantize_params(
        llama.init_params(0, moe_cfg, device='cpu'),
        quantize_moe=True)['layers']['moe']
    n, e, d, f = (moe_cfg.n_layers, moe_cfg.num_experts, moe_cfg.d_model,
                  moe_cfg.d_ff)
    for name, out in (('wi_gate', f), ('wi_up', f), ('wo', d)):
        assert isinstance(moe[name], tquant.QTensor)
        assert moe[name].q.dtype == torch.int8
        assert moe[name].scale.shape == (n, e, 1, out)
    assert isinstance(moe['router'], torch.Tensor)
    assert moe['router'].dtype == torch.float32


def test_quantized_prefill_logits(engines):
    """Quantized on each side from the same fp32 weights: the port's
    quantized logits match the reference's (1e-4 relative) and stay close
    to the fp logits (cosine > 0.99); the reference's own quantized tree,
    carried over, gives the same logits."""
    _, _, jparams, params = engines
    jcfg = jax_config('tiny', compute_dtype=jnp.float32)
    tcfg = torch_config('tiny', compute_dtype=torch.float32)
    tokens, lengths = _tokens(seed=3)
    jtree = jquant.quantize_params(jax.tree.map(jnp.asarray, jparams))
    jl, _ = jdecode.prefill(jtree, jnp.asarray(tokens), jnp.asarray(lengths),
                            jcfg, 24)
    jl = np.asarray(jl)
    carried = convert.params_from_numpy(jax.tree.map(np.asarray, jtree),
                                        torch_config('tiny'), device='cpu')
    assert isinstance(carried['layers']['mlp']['wo'], tquant.QTensor)
    for qparams in (tquant.quantize_params(params), carried):
        ql, _ = tdecode.prefill(qparams, torch.from_numpy(tokens),
                                torch.from_numpy(lengths), tcfg, 24)
        ql = ql.numpy()
        assert np.abs(ql - jl).max() <= 1e-4 * np.abs(jl).max()
    fl, _ = tdecode.prefill(params, torch.from_numpy(tokens),
                            torch.from_numpy(lengths), tcfg, 24)
    fl = fl.numpy()
    cos = (fl * ql).sum() / (np.linalg.norm(fl) * np.linalg.norm(ql))
    assert cos > 0.99, cos


def test_quantized_engine_generates(engines):
    _, _, _, params = engines
    port = InferenceEngine('tiny', cfg=torch_config(
        'tiny', compute_dtype=torch.float32), params=params, device='cpu',
        max_batch=2, quantize=True)
    assert isinstance(port.params['layers']['attn']['wq'], tquant.QTensor)
    out = port.generate_ids(PROMPTS[:2], max_new_tokens=4)
    assert len(out) == 2 and all(len(o) <= 4 for o in out)
    vec = port.embed_text(['hello'])
    assert vec.shape == (1, 64) and np.isfinite(vec).all()
