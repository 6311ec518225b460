"""``python -m skypilot_tpu_torch.inference.server --mesh tensor=2`` on the
CPU: the server starts its own two ``gloo`` ranks, rank 0 serves HTTP,
``/generate`` and ``/v1/completions`` answer with the tokens of the
same engine run unsharded (the twin of the reference's
``server.py --mesh``, whose engines are held to the JAX engines in
``test_torch_tp_serving.py``), ``/stats`` names the mesh, the backend
and each rank's device, and stopping the server stops every rank. With
``--role decode`` or ``--role prefill`` the mesh server is one hop of
a two-hop request beside a one-rank server of the other role, and the
answer is the colocated engine's. With ``--lora-dir`` the mesh server
answers adapter requests (the ``adapter`` field and the
``X-Skyt-Adapter`` header) with the unsharded engine's text and lists
its adapters; with ``--policy-store`` it serves the committed version,
then a newer one, and only its driver polls the store.
"""
import contextlib
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import psutil
import pytest
import torch

from skypilot_tpu_torch.inference.server import (build_engine, parse_args,
                                                 serve)
from torch_threads import few_torch_threads  # noqa: F401 (autouse)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _get(port, path):
    with urllib.request.urlopen(f'http://127.0.0.1:{port}{path}',
                                timeout=60) as r:
        return json.loads(r.read())


def _post(port, path, body):
    req = urllib.request.Request(
        f'http://127.0.0.1:{port}{path}', data=json.dumps(body).encode(),
        headers={'Content-Type': 'application/json'})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


@pytest.mark.parametrize('engine', ['batch', 'continuous'])
def test_server_mesh_serves_and_stops_every_rank(engine):
    _serve_and_stop('tiny', engine)


def test_server_mesh_serves_moe_and_stops_every_rank():
    """A MoE ``--model`` (TINY_MOE, each rank building its slice of every
    expert from the seed) under ``--mesh tensor=2`` serves
    ``/v1/completions`` with the unsharded engine's text and stops every
    rank."""
    _serve_and_stop('tiny-moe', 'continuous')


def _serve_and_stop(model, engine):
    argv = _argv(model, engine)
    with _mesh_server(argv) as port:
        body = {'prompts': ['hello'], 'max_new_tokens': 5}
        got = _post(port, '/generate', body)['outputs']
        completion = _post(port, '/v1/completions',
                           {'prompt': 'hello', 'max_tokens': 5})
        stats = _get(port, '/stats')
    assert stats['mesh'] == "Mesh({'tensor': 2})"
    assert stats['mesh_backend'] == 'gloo'
    assert stats['mesh_devices'] == ['cpu', 'cpu']
    # The unsharded engine of the same flags answers the same text.
    if engine == 'batch':
        assert got == _single(argv, ['hello'], max_new_tokens=5)
    else:
        assert got == [_single(argv, 'hello', max_new_tokens=5)]
    assert completion['choices'][0]['text'] == got[0]


@pytest.mark.parametrize('mesh_role', ['decode', 'prefill'])
def test_server_mesh_role_two_hop(mesh_role):
    """``--role decode|prefill --mesh tensor=2`` beside a one-rank server
    of the other role and the same flags: hop 1 on the prefill side,
    hop 2 on the decode side, which pulls the whole-head blocks (the
    mesh gathers them from its ranks for an export, scatters them over
    its ranks for an import) and decodes the colocated server's text;
    ``/stats`` names the mesh and the role, and the prefill side holds
    no export afterwards (its warm-up export was dropped)."""
    argv = _argv('tiny', 'continuous')
    prompt = 'a shared system preamble that spans multiple KV blocks: rules'
    body = {'prompts': [prompt], 'max_new_tokens': 6}
    other = 'prefill' if mesh_role == 'decode' else 'decode'
    torch.set_num_threads(1)
    local = build_engine(parse_args(_argv('tiny', 'continuous') +
                                    ['--role', other]))
    server = serve(local, '127.0.0.1', 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    local_url = f'http://127.0.0.1:{server.server_address[1]}'
    try:
        with _mesh_server(argv + ['--role', mesh_role]) as port:
            mesh_url = f'http://127.0.0.1:{port}'
            pre, dec = ((local_url, mesh_url) if mesh_role == 'decode'
                        else (mesh_url, local_url))
            hop1 = _post_url(f'{pre}/disagg/prefill', body,
                             {'X-Skyt-Disagg-Path': '/generate'})
            got = _post_url(f'{dec}/generate', body,
                            {'X-Skyt-Kv-Request-Id': hop1['request_id'],
                             'X-Skyt-Kv-Endpoint': pre})['outputs']
            stats = {url: _get_url(f'{url}/stats')
                     for url in (pre, dec)}
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
        local.shutdown()
    assert stats[mesh_url]['role'] == mesh_role
    assert stats[mesh_url]['mesh'] == "Mesh({'tensor': 2})"
    assert stats[dec]['kv_imports'] == 1
    assert stats[dec]['kv_import_fallbacks'] == 0
    assert stats[pre]['kv_exports_pending'] == 0
    assert got == [_single(argv, prompt, max_new_tokens=6)]


def _lora_registry(root):
    """A registry under ``root`` with one rank-4 adapter for TINY whose
    B is seeded and non-zero (so it moves the answer)."""
    from skypilot_tpu_torch.models import lora as lora_lib
    from skypilot_tpu_torch.models.config import get_model_config
    from skypilot_tpu_torch.serve import adapter_registry
    lora = lora_lib.init_lora_params(3, get_model_config('tiny'), 4,
                                     device='cpu')
    gen = torch.Generator().manual_seed(4)
    for key in ('wq_b', 'wv_b'):
        lora[key] = 0.05 * torch.randn(lora[key].shape, generator=gen)
    adapter_registry.export_adapter(str(root), 'tenant', lora, alpha=16.0,
                                    base_digest='')
    return str(root)


def _policy_tree(seed):
    """TINY's seeded init as the policy store's flat numpy shards."""
    from skypilot_tpu_torch.inference.continuous import flatten_param_paths
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.models.config import get_model_config
    params = llama.init_params(seed, get_model_config('tiny'),
                               device='cpu')
    return {p: t.numpy().copy()
            for p, t in flatten_param_paths(params).items()}


def _engine_text(tree, prompt):
    """The unsharded continuous engine's answer on the flat ``tree``."""
    from skypilot_tpu_torch.inference.continuous import (
        ContinuousBatchingEngine)
    engine = ContinuousBatchingEngine('tiny', device='cpu', max_slots=2,
                                      max_len=64)
    try:
        engine.refresh_weights(tree)
        return engine.generate_text(prompt, max_new_tokens=5)
    finally:
        engine.shutdown()


@pytest.mark.parametrize('option', ['lora_dir', 'policy_store'])
def test_server_mesh_serves_adapters_and_policy_store(option, tmp_path):
    """``--lora-pages 2 --lora-dir REG`` or ``--policy-store STORE``
    under ``--mesh tensor=2``: the driver registers the adapters and
    polls the store; the answers are the unsharded engine's."""
    argv = _argv('tiny', 'continuous')
    body = {'prompts': ['hello'], 'max_new_tokens': 5}
    torch.set_num_threads(1)
    if option == 'lora_dir':
        argv += ['--lora-pages', '2', '--lora-max-rank', '4', '--lora-dir',
                 _lora_registry(tmp_path / 'reg')]
        with _mesh_server(argv) as port:
            got = _post(port, '/generate', dict(body, adapter='tenant'))
            completion = _post_url(
                f'http://127.0.0.1:{port}/v1/completions',
                {'prompt': 'hello', 'max_tokens': 5},
                {'X-Skyt-Adapter': 'tenant'})
            base = _post(port, '/generate', body)['outputs']
            adapters = _get(port, '/adapters')
            stats = _get(port, '/stats')
        want = _single(argv, 'hello', max_new_tokens=5, adapter='tenant')
        assert got['outputs'] == [want]
        assert completion['choices'][0]['text'] == want
        assert base == [_single(argv, 'hello', max_new_tokens=5)] != [want]
        assert adapters['tenant']['resident'] == 1.0
        assert stats['lora_pages_resident'] == 1
        assert stats['lora_adapters_registered'] == 1
        assert stats['lora_misses'] == 1 and stats['lora_hits'] == 1
        return
    store_dir = str(tmp_path / 'store')
    from skypilot_tpu_torch.jobs.rl_pipeline import PolicyStore
    store = PolicyStore(store_dir)
    v5 = _policy_tree(1)
    store.publish(v5, version=5)
    v6 = dict(v5, **{'final_norm/scale': -v5['final_norm/scale']})
    tmp = tmp_path / 'tmp'
    tmp.mkdir()
    argv += ['--policy-store', store_dir]
    with _mesh_server(argv, SKYT_RL_EVAL_POLL_S='0.2',
                      TMPDIR=str(tmp)) as port:
        first = _get(port, '/stats')['policy_version']
        got5 = _post(port, '/generate', body)['outputs']
        store.publish(v6, version=6)
        deadline = time.monotonic() + 60
        while _get(port, '/stats')['policy_version'] != 6:
            assert time.monotonic() < deadline, 'version 6 never served'
            time.sleep(0.2)
        got6 = _post(port, '/generate', body)['outputs']
        stats = _get(port, '/stats')
        # One watcher, on the driver: one local copy of the store.
        copies = [p for p in os.listdir(tmp)
                  if p.startswith('skyt-eval-policy-')]
    assert first == 5 and copies and len(copies) == 1
    assert stats['weight_refreshes'] == 2
    assert got5 == [_engine_text(v5, 'hello')]
    assert got6 == [_engine_text(v6, 'hello')] != got5


def _argv(model, engine):
    return ['--model', model, '--device', 'cpu', '--engine', engine,
            '--max-batch', '2', '--max-len', '64', '--host', '127.0.0.1',
            '--port', str(_free_port())]


def _get_url(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


def _post_url(url, body, headers):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={'Content-Type': 'application/json', **headers})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _single(argv, prompt, **kwargs):
    """What the unsharded engine of the server's flags answers to
    ``generate_text(prompt, **kwargs)``."""
    torch.set_num_threads(1)
    engine = build_engine(parse_args(argv))
    try:
        return engine.generate_text(prompt, **kwargs)
    finally:
        if hasattr(engine, 'shutdown'):
            engine.shutdown()


@contextlib.contextmanager
def _mesh_server(argv, **extra_env):
    """``server --mesh tensor=2`` with ``argv`` (and ``extra_env``):
    yields its port once ``/health`` answers; stopping it (SIGTERM)
    must stop both ranks."""
    port = int(argv[argv.index('--port') + 1])
    env = dict(os.environ, OMP_NUM_THREADS='1', **extra_env)
    proc = subprocess.Popen(
        [sys.executable, '-m', 'skypilot_tpu_torch.inference.server',
         '--mesh', 'tensor=2'] + argv, cwd=REPO_ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.monotonic() + 120
        while True:
            assert proc.poll() is None, proc.stdout.read()
            try:
                assert _get(port, '/health')['status'] == 'ok'
                break
            except OSError:
                assert time.monotonic() < deadline, 'server never came up'
                time.sleep(0.5)
        rank_pids = [child.pid for child in
                     psutil.Process(proc.pid).children(recursive=True)
                     if 'spawn_main' in ' '.join(child.cmdline())]
        yield port
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    # Stopping the server stopped its ranks too.
    assert len(rank_pids) == 2

    def alive(pid):
        try:
            return psutil.Process(pid).status() != psutil.STATUS_ZOMBIE
        except psutil.NoSuchProcess:
            return False

    deadline = time.monotonic() + 30
    while any(alive(pid) for pid in rank_pids):
        assert time.monotonic() < deadline, 'a rank outlived the server'
        time.sleep(0.2)
