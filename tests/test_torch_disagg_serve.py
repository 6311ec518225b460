"""The reference's load balancer in front of the port's disaggregated
servers.

The serve stack's ``LoadBalancer`` and ``start_load_balancer``
(``skypilot_tpu/serve/load_balancer.py``) drive a port prefill-role
server and a port decode-role server (TINY at fp32 on the CPU) through
the two-hop route: ``/disagg/prefill`` on the prefill replica, then the
client's request on the decode replica with ``X-Skyt-Kv-Request-Id`` and
``X-Skyt-Kv-Endpoint``, over HTTP end to end. The two-hop answer equals
the single-hop one, the decode engine imports without a fallback and
without a prefill chunk, and the export is released; an OpenAI SSE
stream goes the same way; a dead prefill fleet degrades to single-hop.
Tolerance: none (texts are compared exactly).
"""
import json
import socket
import threading
import urllib.error
import urllib.request

import pytest
import torch

from skypilot_tpu.serve.load_balancer import (LoadBalancer,
                                              start_load_balancer)
from skypilot_tpu.serve.load_balancing_policies import LoadBalancingPolicy
from skypilot_tpu.server import metrics as jmetrics
from skypilot_tpu_torch.inference import server as tserver
from skypilot_tpu_torch.inference.continuous import (
    ContinuousBatchingEngine as TorchEngine)
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.models.config import get_model_config
from skypilot_tpu_torch.server import metrics
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

PROMPT = 'a shared system preamble that spans multiple KV blocks: rules'
BODY = {'prompts': [PROMPT], 'max_new_tokens': 6, 'seed': 0}


@pytest.fixture(scope='module')
def disagg_stack():
    """Port prefill-role and decode-role engines on one set of weights
    behind the port's server, fronted by the reference's LB, and a
    colocated engine on the same weights (not served) for expected
    answers."""
    cfg = get_model_config('tiny', compute_dtype=torch.float32)
    params = llama.init_params(0, cfg, device='cpu')
    engines, servers, threads, lb_server = {}, {}, [], None
    try:
        engines['colocated'] = TorchEngine('tiny', cfg=cfg, params=params,
                                           device='cpu', max_slots=2,
                                           max_len=96)
        for role in ('prefill', 'decode'):
            engines[role] = TorchEngine('tiny', cfg=cfg, params=params,
                                        device='cpu', role=role,
                                        max_slots=2, max_len=96)
            server = tserver.serve(engines[role], '127.0.0.1', 0)
            servers[role] = server
            thread = threading.Thread(target=server.serve_forever,
                                      daemon=True)
            thread.start()
            threads.append(thread)
        urls = {role: f'http://127.0.0.1:{s.server_address[1]}'
                for role, s in servers.items()}
        lb = LoadBalancer(LoadBalancingPolicy.make('p2c_ewma'))
        lb_server = start_load_balancer(lb, '127.0.0.1', 0)
        yield engines, urls, lb, lb_server
    finally:
        if lb_server is not None:
            lb_server.shutdown()
        for server in servers.values():
            server.shutdown()
            server.server_close()
        for thread in threads:
            thread.join(timeout=10)
        for engine in engines.values():
            engine.shutdown()


@pytest.fixture(autouse=True)
def _fresh_metrics():
    """Both packages' in-process metrics start and end each test empty
    (the reference's LB counts into the JAX package's registry)."""
    metrics.reset_for_tests()
    jmetrics.reset_for_tests()
    yield
    metrics.reset_for_tests()
    jmetrics.reset_for_tests()


def _post(port, path, payload):
    req = urllib.request.Request(
        f'http://127.0.0.1:{port}{path}',
        data=json.dumps(payload).encode(),
        headers={'Content-Type': 'application/json'})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.read()


def _two_hop(lb, urls):
    lb.sync_replicas([(1, urls['prefill'], 1.0), (2, urls['decode'], 1.0)],
                     roles={1: 'prefill', 2: 'decode'})


def test_two_hop_generate_matches_single_hop(disagg_stack):
    engines, urls, lb, lb_server = disagg_stack
    # Single-hop baseline: the decode replica alone, no roles; it
    # prefills locally like a colocated engine.
    lb.sync_replicas([(2, urls['decode'], 1.0)])
    baseline = json.loads(_post(lb_server.port, '/generate', BODY))
    pre, dec = engines['prefill'].stats(), engines['decode'].stats()
    # Two-hop: the prefill replica absorbs the prompt, the decode replica
    # pulls the KV and decodes: the same text, no local prefill. The
    # prompt's full blocks are resident on the decode side since the
    # baseline, so only the tail moves.
    _two_hop(lb, urls)
    two_hop = json.loads(_post(lb_server.port, '/generate', BODY))
    assert two_hop['outputs'] == baseline['outputs']
    after_pre = engines['prefill'].stats()
    after_dec = engines['decode'].stats()
    assert after_pre['kv_exports'] == pre['kv_exports'] + 1
    assert after_dec['kv_imports'] == dec['kv_imports'] + 1
    assert after_dec['kv_import_fallbacks'] == 0
    assert after_dec['prefill_chunks'] == dec['prefill_chunks']
    assert metrics.DISAGG_HANDOFF.count() == 1
    assert metrics.KV_MIGRATE_BLOCKS.value(outcome='moved') == 0
    # The consumed export was released on the prefill side.
    assert after_pre['kv_exports_pending'] == 0
    # A prompt the decode side never saw moves every full block and
    # gives a colocated engine's text.
    prompt = 'another prompt, and all of its KV blocks move'
    out = json.loads(_post(lb_server.port, '/generate',
                           dict(BODY, prompts=[prompt])))['outputs']
    assert out == [engines['colocated'].generate_text(prompt,
                                                      max_new_tokens=6)]
    n_ids = len(engines['decode'].tokenizer.encode(prompt))
    assert metrics.KV_MIGRATE_BLOCKS.value(outcome='moved') == \
        n_ids // engines['decode'].block_size
    final = engines['decode'].stats()
    assert final['kv_imports'] == dec['kv_imports'] + 2
    assert final['prefill_chunks'] == dec['prefill_chunks']
    assert final['kv_import_fallbacks'] == 0
    assert engines['prefill'].stats()['kv_exports_pending'] == 0


def test_two_hop_openai_stream_first_tokens_after_handoff(disagg_stack):
    engines, urls, lb, lb_server = disagg_stack
    prompt = 'streamed: ' + PROMPT
    lb.sync_replicas([(2, urls['decode'], 1.0)])
    single = json.loads(_post(lb_server.port, '/v1/completions',
                              {'prompt': prompt, 'max_tokens': 4}))
    _two_hop(lb, urls)
    imports0 = engines['decode'].stats()['kv_imports']
    body = _post(lb_server.port, '/v1/completions',
                 {'prompt': prompt, 'max_tokens': 4, 'stream': True})
    frames = [ln for ln in body.split(b'\n') if ln]
    assert frames[-1] == b'data: [DONE]'
    text = ''.join(json.loads(f[len(b'data: '):])['choices'][0]['text']
                   for f in frames[:-1])
    assert text == single['choices'][0]['text']
    assert engines['decode'].stats()['kv_imports'] == imports0 + 1
    assert engines['decode'].stats()['kv_import_fallbacks'] == 0


def test_two_hop_survives_prefill_fleet_death(disagg_stack):
    """Hop 1 pointing at a dead endpoint degrades to single-hop: the
    decode replica prefills locally and the request completes."""
    engines, urls, lb, lb_server = disagg_stack
    dead = socket.socket()
    dead.bind(('127.0.0.1', 0))  # bound but never accepting
    try:
        lb.sync_replicas(
            [(1, f'http://127.0.0.1:{dead.getsockname()[1]}', 1.0),
             (2, urls['decode'], 1.0)],
            roles={1: 'prefill', 2: 'decode'})
        imports0 = engines['decode'].stats()['kv_imports']
        out = json.loads(_post(lb_server.port, '/generate',
                               dict(BODY, seed=3)))['outputs']
        assert len(out) == 1 and isinstance(out[0], str)
        assert engines['decode'].stats()['kv_imports'] == imports0
    finally:
        dead.close()


def test_routes_refuse_the_wrong_role(disagg_stack):
    """``/disagg/prefill`` on a decode replica is a 400; ``/kv/*`` on a
    replica without an exporter is a 404."""
    _engines, urls, _lb, _lb_server = disagg_stack
    port = int(urls['decode'].rsplit(':', 1)[1])
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(port, '/disagg/prefill', BODY)
    assert err.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(f'{urls["decode"]}/kv/manifest/r1',
                               timeout=30)
    assert err.value.code == 404
    pre_port = int(urls['prefill'].rsplit(':', 1)[1])
    answer = json.loads(_post(pre_port, '/disagg/prefill', BODY))
    assert answer['n_tokens'] > 0
    with urllib.request.urlopen(
            f'{urls["prefill"]}/kv/manifest/{answer["request_id"]}',
            timeout=30) as resp:
        manifest = json.loads(resp.read())
    assert manifest['n_tokens'] == answer['n_tokens']
    assert json.loads(_post(pre_port, f'/kv/release/{answer["request_id"]}',
                            {})) == {'ok': True}


@pytest.mark.parametrize('role', ['prefill', 'decode'])
def test_role_flag_builds_and_warms_the_engine(role):
    """``--role`` reaches the continuous engine; a prefill replica warms
    up through its own export and drops it, a decode replica by one
    short local request."""
    args = tserver.parse_args(['--engine', 'continuous', '--device', 'cpu',
                               '--max-batch', '2', '--max-len', '64',
                               '--role', role])
    engine = tserver.build_engine(args)
    try:
        stats = engine.stats()
        assert engine.role == role
        assert stats['completions'] == 1           # the warm-up request
        assert stats['kv_exports'] == (role == 'prefill')
        assert stats['kv_exports_pending'] == 0
        assert stats['tokens_generated'] == (0 if role == 'prefill' else 8)
    finally:
        engine.shutdown()
