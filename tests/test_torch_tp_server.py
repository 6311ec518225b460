"""``python -m skypilot_tpu_torch.inference.server --mesh tensor=2`` on the
CPU: the server starts its own two ``gloo`` ranks, rank 0 serves HTTP,
``/generate`` and ``/v1/completions`` answer with the tokens of the
same engine run unsharded (the twin of the reference's
``server.py --mesh``, whose engines are held to the JAX engines in
``test_torch_tp_serving.py``), ``/stats`` names the mesh, the backend
and each rank's device, and stopping the server stops every rank.
"""
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import psutil
import pytest
import torch

from skypilot_tpu_torch.inference.server import build_engine, parse_args
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
    port = _free_port()
    argv = ['--model', 'tiny', '--device', 'cpu', '--engine', engine,
            '--max-batch', '2', '--max-len', '64', '--host', '127.0.0.1',
            '--port', str(port)]
    env = dict(os.environ, OMP_NUM_THREADS='1')
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
        body = {'prompts': ['hello'], 'max_new_tokens': 5}
        got = _post(port, '/generate', body)['outputs']
        completion = _post(port, '/v1/completions',
                           {'prompt': 'hello', 'max_tokens': 5})
        stats = _get(port, '/stats')
        rank_pids = [child.pid for child in
                     psutil.Process(proc.pid).children(recursive=True)
                     if 'spawn_main' in ' '.join(child.cmdline())]
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    assert stats['mesh'] == "Mesh({'tensor': 2})"
    assert stats['mesh_backend'] == 'gloo'
    assert stats['mesh_devices'] == ['cpu', 'cpu']
    # The unsharded engine of the same flags answers the same text.
    torch.set_num_threads(1)
    single = build_engine(parse_args(argv))
    try:
        if engine == 'batch':
            want = single.generate_text(['hello'], max_new_tokens=5)
        else:
            want = [single.generate_text('hello', max_new_tokens=5)]
        assert got == want
        assert completion['choices'][0]['text'] == got[0]
    finally:
        if hasattr(single, 'shutdown'):
            single.shutdown()
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
