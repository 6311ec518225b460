"""The port's HTTP server surface against the reference server.

TINY at fp32 compute with the JAX engine's weights on both sides. The
port's ``/v1/completions`` and ``/v1/chat/completions`` answer with the
reference server's payloads (over the JAX engine, ids and timestamps
aside), ``null`` fields read as defaults, SSE streams end with a
``finish_reason`` frame and ``[DONE]`` and carry the non-streamed text,
a mid-stream failure ends in an error frame, the batch engine refuses
``stream=true`` with a 400, the chat template is the reference's,
``/stats`` names the reference engine's keys (plus the port's
``decode_steps``), ``/metrics`` is the reference handler's text for the
same stats, and ``/adapters`` and adapter selection (JSON field or
``X-Skyt-Adapter``) work. Token ids and texts are compared exactly.
"""
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.inference import server as jserver
from skypilot_tpu.inference import tokenizer as jtokenizer
from skypilot_tpu.inference.continuous import (
    ContinuousBatchingEngine as JaxEngine)
from skypilot_tpu.models.config import get_model_config as jax_config
from skypilot_tpu.server import metrics as jmetrics
from skypilot_tpu_torch.inference import server as tserver
from skypilot_tpu_torch.inference import tokenizer as ttokenizer
from skypilot_tpu_torch.inference.continuous import (
    ContinuousBatchingEngine as TorchEngine)
from skypilot_tpu_torch.inference.engine import InferenceEngine
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models import lora as tlora
from skypilot_tpu_torch.models.config import get_model_config as torch_config
from skypilot_tpu_torch.serve import adapter_registry as tregistry
from skypilot_tpu_torch.server import metrics as tmetrics
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

KW = dict(max_slots=2, max_len=96)
MESSAGES = [{'role': 'system', 'content': 'be brief'},
            {'role': 'user', 'content': 'hi there'}]


def _tcfg():
    return torch_config('tiny', compute_dtype=torch.float32)


class _Server:
    def __init__(self, serve, engine):
        self.server = serve(engine, '127.0.0.1', 0)
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()

    def url(self, path):
        return f'http://127.0.0.1:{self.port}{path}'

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)


def _post(srv, path, payload, headers=None):
    req = urllib.request.Request(
        srv.url(path), data=json.dumps(payload).encode(),
        headers={'Content-Type': 'application/json', **(headers or {})})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.status, resp.headers, resp.read()


def _get(srv, path):
    with urllib.request.urlopen(srv.url(path), timeout=60) as resp:
        return resp.read()


def _frames(body: bytes):
    """SSE ``data:`` payloads of a (de-chunked) stream body."""
    out = []
    for event in body.decode().split('\n\n'):
        if event.strip():
            assert event.startswith('data: '), event
            out.append(event[len('data: '):])
    return out


@pytest.fixture(scope='module')
def servers():
    ref = JaxEngine('tiny', cfg=jax_config('tiny', compute_dtype=jnp.float32),
                    **KW)
    params = convert.params_from_numpy(
        jax.tree.map(np.asarray, ref.params), _tcfg(), device='cpu')
    port = TorchEngine('tiny', cfg=_tcfg(), params=params, device='cpu',
                       lora_pages=1, lora_max_rank=4, **KW)
    lora = tlora.init_lora_params(3, _tcfg(), 4, device='cpu')
    gen = torch.Generator().manual_seed(4)
    for key in ('wq_b', 'wv_b'):
        lora[key] = 0.05 * torch.randn(lora[key].shape, generator=gen)
    port.register_adapter('tenant', lora)
    batch = InferenceEngine('tiny', cfg=_tcfg(), params=params,
                            device='cpu', max_batch=2)
    srv = {'ref': _Server(jserver.serve, ref),
           'port': _Server(tserver.serve, port),
           'batch': _Server(tserver.serve, batch)}
    yield srv, ref, port, params
    for s in srv.values():
        s.close()
    ref.shutdown()
    port.shutdown()


def _strip(payload):
    payload = dict(payload)
    assert payload.pop('id').startswith('cmpl-')
    assert isinstance(payload.pop('created'), int)
    return payload


@pytest.mark.parametrize('path,body', [
    ('/v1/completions', {'prompt': 'hello', 'max_tokens': 6}),
    ('/v1/completions', {'prompt': ['abc'], 'max_tokens': None,
                         'temperature': None}),
    ('/v1/chat/completions', {'messages': MESSAGES, 'max_tokens': 5}),
    ('/v1/chat/completions', {'messages': MESSAGES, 'max_tokens': None,
                              'temperature': None}),
], ids=['completion', 'completion-nulls', 'chat', 'chat-nulls'])
def test_openai_payloads_equal_reference(servers, path, body):
    srv = servers[0]
    _, _, want = _post(srv['ref'], path, body)
    status, headers, got = _post(srv['port'], path, body)
    assert status == 200
    assert headers['Content-Type'] == 'application/json'
    assert _strip(json.loads(got)) == _strip(json.loads(want))


@pytest.mark.parametrize('chat', [False, True], ids=['completion', 'chat'])
def test_sse_stream_frames_and_text(servers, chat):
    srv, _, port, _ = servers
    if chat:
        path, body = '/v1/chat/completions', {'messages': MESSAGES,
                                              'max_tokens': 12}
    else:
        path, body = '/v1/completions', {'prompt': 'stream me',
                                         'max_tokens': 12}
    _, _, plain = _post(srv['port'], path, body)
    plain = json.loads(plain)['choices'][0]
    status, headers, raw = _post(srv['port'], path,
                                 dict(body, stream=True))
    assert status == 200
    assert headers['Content-Type'] == 'text/event-stream'
    assert headers['Transfer-Encoding'] == 'chunked'
    frames = _frames(raw)
    assert frames[-1] == '[DONE]'
    chunks = [json.loads(f) for f in frames[:-1]]
    obj = 'chat.completion.chunk' if chat else 'text_completion'
    assert all(c['object'] == obj and c['model'] == 'tiny' for c in chunks)
    assert len({c['id'] for c in chunks}) == 1
    final = chunks[-1]['choices'][0]
    assert final['finish_reason'] == plain['finish_reason']
    assert all(c['choices'][0]['finish_reason'] is None
               for c in chunks[:-1])
    if chat:
        text = ''.join(c['choices'][0]['delta'].get('content', '')
                       for c in chunks)
        assert text == plain['message']['content']
        assert final['delta'] == {}
    else:
        text = ''.join(c['choices'][0]['text'] for c in chunks)
        assert text == plain['text']
    # The engine's own text streaming gives the same text.
    if not chat:
        assert ''.join(port.stream_text('stream me', max_new_tokens=12)) \
            == plain['text']


def test_sse_mid_stream_failure_sends_an_error_frame(servers, monkeypatch):
    srv, _, port, _ = servers

    def failing_stream(ids, **kwargs):
        def tokens():
            yield 72                     # 'E'
            raise RuntimeError('device lost mid-stream')
        return tokens()

    monkeypatch.setattr(port, 'stream_ids', failing_stream)
    _, _, raw = _post(srv['port'], '/v1/completions',
                      {'prompt': 'x', 'max_tokens': 4, 'stream': True})
    frames = _frames(raw)
    assert frames[-1] == '[DONE]'
    assert json.loads(frames[-2]) == {'error': 'device lost mid-stream'}
    assert json.loads(frames[0])['choices'][0]['text'] == 'E'


def test_batch_engine_refuses_stream_with_400(servers):
    srv = servers[0]
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(srv['batch'], '/v1/completions',
              {'prompt': 'x', 'stream': True})
    assert err.value.code == 400
    assert 'continuous engine' in json.loads(err.value.read())['error']
    # Without stream the batch engine answers the OpenAI route.
    status, _, body = _post(srv['batch'], '/v1/chat/completions',
                            {'messages': MESSAGES, 'max_tokens': 4})
    payload = json.loads(body)
    assert status == 200 and payload['object'] == 'chat.completion'


def test_chat_template_equals_reference():
    cases = [MESSAGES, [], [{'content': 'no role'}],
             [{'role': 'user', 'content': 'é ünï'}, {'role': 'assistant'}]]
    for messages in cases:
        for gen in (True, False):
            want = jtokenizer.render_transcript(messages, gen)
            assert ttokenizer.render_transcript(messages, gen) == want
            assert ttokenizer.ByteTokenizer().apply_chat_template(
                messages, gen) == jtokenizer.ByteTokenizer(
                ).apply_chat_template(messages, gen)
    assert ttokenizer.ByteTokenizer.chat_template is None


def test_stats_keys_equal_reference_engine(servers):
    srv = servers[0]
    ref_keys = set(json.loads(_get(srv['ref'], '/stats')))
    port_keys = set(json.loads(_get(srv['port'], '/stats')))
    # The port keeps decode_steps (plain steps, for its launch counts).
    assert port_keys == ref_keys | {'decode_steps'}


def test_metrics_equal_reference_handler_rule(servers):
    """The port's ``/metrics`` is, line for line, what the reference
    handler renders for the same stats; the counter set is the
    reference's."""
    srv, _, port, _ = servers
    assert tmetrics.INFERENCE_COUNTER_STATS == \
        jmetrics.INFERENCE_COUNTER_STATS
    port.generate_ids([5, 6, 7], max_new_tokens=3)
    text = _get(srv['port'], '/metrics').decode()
    stats = json.loads(_get(srv['port'], '/stats'))

    class Stub:
        pass

    stub = Stub()
    stub.stats = lambda: stats
    handler = jserver.make_handler(stub)
    captured = {'body': b''}

    class Out:
        def write(self, b):
            captured['body'] += b

        def flush(self):
            pass

    h = handler.__new__(handler)
    h.path = '/metrics'
    h.wfile = Out()
    h.send_response = lambda code: captured.setdefault('code', code)
    h.send_header = lambda *a: None
    h.end_headers = lambda: None
    h.do_GET()
    assert captured['code'] == 200
    assert text == captured['body'].decode()
    assert '# TYPE skyt_inference_verify_steps_total counter' in text
    assert '# TYPE skyt_inference_blocks_capacity gauge' in text


def test_adapters_route_and_adapter_selection(servers):
    srv, _, port, _ = servers
    assert json.loads(_get(srv['ref'], '/adapters')) == {}
    ids = port.tokenizer.encode('tenant prompt')
    want = port.tokenizer.decode(port.generate_ids(
        ids, max_new_tokens=6, eos_id=port.tokenizer.eos_id,
        adapter='tenant'))
    base = port.tokenizer.decode(port.generate_ids(
        ids, max_new_tokens=6, eos_id=port.tokenizer.eos_id))
    _, _, body = _post(srv['port'], '/generate',
                       {'prompts': ['tenant prompt'], 'max_new_tokens': 6,
                        'adapter': 'tenant'})
    assert json.loads(body)['outputs'] == [want]
    _, _, body = _post(srv['port'], '/v1/completions',
                       {'prompt': 'tenant prompt', 'max_tokens': 6},
                       headers={'X-Skyt-Adapter': 'tenant'})
    assert json.loads(body)['choices'][0]['text'] == want
    assert want != base
    adapters = json.loads(_get(srv['port'], '/adapters'))
    assert set(adapters) == {'tenant'}
    assert adapters['tenant']['resident'] == 1.0
    assert adapters['tenant']['requests'] >= 3
    stats = json.loads(_get(srv['port'], '/stats'))
    assert stats['lora_pages_resident'] == 1
    assert stats['lora_blocks_charged'] > 0
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(srv['port'], '/generate',
              {'prompts': ['x'], 'adapter': 'nobody'})
    assert err.value.code == 500
    assert 'not registered' in json.loads(err.value.read())['error']


def test_server_flags_build_the_engine(tmp_path):
    """``--spec-decode``, ``--draft-k``, ``--lora-pages``,
    ``--lora-max-rank`` and ``--lora-dir`` reach the continuous engine
    (on the CPU with ``--device cpu``)."""
    root = str(tmp_path / 'registry')
    lora = tlora.init_lora_params(1, torch_config('tiny'), 2, device='cpu')
    tregistry.export_adapter(root, 'ft', lora, alpha=16.0,
                             base_digest='any')
    args = tserver.parse_args([
        '--engine', 'continuous', '--device', 'cpu', '--max-batch', '2',
        '--max-len', '64', '--spec-decode', '--draft-k', '2',
        '--lora-pages', '2', '--lora-max-rank', '4', '--lora-dir', root])
    engine = tserver.build_engine(args)
    try:
        stats = engine.stats()
        assert engine.spec_decode and stats['spec_window'] == 3
        assert stats['lora_pages_total'] == 2
        assert engine.adapters() == ['ft']
        assert stats['completions'] == 1       # the warm-up request
    finally:
        engine.shutdown()
