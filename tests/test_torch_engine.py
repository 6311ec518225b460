"""The port's ContinuousBatchingEngine against the JAX engine.

Both engines serve TINY with fp32 compute and the same weights (the JAX
engine's, carried over by ``models/convert.py``). Greedy outputs must
agree token for token however the requests interleave: staggered
arrivals, more requests than slots, a prefix-cache hit and a forced
preemption. The port's HTTP server answers ``/generate`` with the
reference payload.
"""
import json
import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.inference.continuous import (
    ContinuousBatchingEngine as JaxEngine)
from skypilot_tpu.models.config import get_model_config as jax_config
from skypilot_tpu_torch.inference import server as tserver
from skypilot_tpu_torch.inference.continuous import (
    ContinuousBatchingEngine as TorchEngine)
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models.config import get_model_config as torch_config
from torch_threads import few_torch_threads  # noqa: F401 (autouse)


@pytest.fixture(scope='module')
def engines():
    ref = JaxEngine('tiny', cfg=jax_config('tiny',
                                           compute_dtype=jnp.float32),
                    max_slots=2, max_len=96)
    params = convert.params_from_numpy(
        jax.tree.map(np.asarray, ref.params), torch_config('tiny'),
        device='cpu')
    port = TorchEngine('tiny', cfg=torch_config('tiny',
                                                compute_dtype=torch.float32),
                       params=params, device='cpu', max_slots=2,
                       max_len=96)
    yield ref, port, params
    ref.shutdown()
    port.shutdown()


def test_staggered_requests_match_reference(engines):
    ref, port, _ = engines
    prompts = [[3, 1, 4, 1, 5], [2, 7, 18], [31, 41, 59, 26, 5, 3]]
    outs = [None] * len(prompts)

    def run(i):
        time.sleep(0.05 * i)  # staggered arrivals
        outs[i] = port.generate_ids(prompts[i], max_new_tokens=10)

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    for i, prompt in enumerate(prompts):
        assert outs[i] == ref.generate_ids(prompt, max_new_tokens=10), i


def test_more_requests_than_slots_match_reference(engines):
    ref, port, _ = engines
    handles = [port.submit_ids([i + 1, i + 2, 3 * i], max_new_tokens=4)
               for i in range(8)]
    for i, handle in enumerate(handles):
        assert handle.done.wait(120) and handle.error is None
        assert handle.generated == ref.generate_ids([i + 1, i + 2, 3 * i],
                                                    max_new_tokens=4), i
    stats = port.stats()
    assert stats['active'] == 0 and stats['pending'] == 0
    assert stats['requests'] == stats['completions']


def test_prefix_cache_hit_matches_reference(engines):
    ref, port, _ = engines
    prefix = [(9 * i + 2) % 512 for i in range(32)]
    first = port.generate_ids(prefix + [401, 17], max_new_tokens=5)
    before = port.stats()
    second = port.generate_ids(prefix + [88], max_new_tokens=5)
    after = port.stats()
    assert after['prefix_cache_hits'] == before['prefix_cache_hits'] + 1
    assert (after['prefix_tokens_reused'] >=
            before['prefix_tokens_reused'] + 32)
    assert first == ref.generate_ids(prefix + [401, 17], max_new_tokens=5)
    assert second == ref.generate_ids(prefix + [88], max_new_tokens=5)


def test_forced_preemption_resumes_to_reference_tokens(engines):
    """4 slots x 3 blocks of demand against 8 usable blocks: the engine
    must preempt and resume (by re-prefill) rather than fail, and every
    output still equals the reference."""
    ref, _, params = engines
    port = TorchEngine('tiny', cfg=torch_config('tiny',
                                                compute_dtype=torch.float32),
                       params=params, device='cpu', max_slots=4,
                       max_len=64, block_size=8, prefill_chunk=8,
                       num_blocks=9, prefix_cache=False)
    try:
        prompts = [[(i * 13 + j) % 512 for j in range(12)]
                   for i in range(4)]
        handles = [port.submit_ids(p, max_new_tokens=6) for p in prompts]
        for i, handle in enumerate(handles):
            assert handle.done.wait(120) and handle.error is None
            assert handle.generated == ref.generate_ids(
                prompts[i], max_new_tokens=6), i
        stats = port.stats()
        assert stats['completions'] == 4
        assert stats['preemptions'] >= 1
        assert stats['blocks_free'] == stats['blocks_total']
    finally:
        port.shutdown()


def test_http_generate_payload(engines):
    ref, port, _ = engines
    server = tserver.serve(port, '127.0.0.1', 0)
    host_port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        body = json.dumps({'prompts': ['a', 'bb', 'ccc'],
                           'max_new_tokens': 4}).encode()
        req = urllib.request.Request(
            f'http://127.0.0.1:{host_port}/generate', data=body,
            headers={'Content-Type': 'application/json'})
        with urllib.request.urlopen(req, timeout=120) as resp:
            payload = json.loads(resp.read())
        assert list(payload) == ['outputs']
        assert payload['outputs'] == ref.generate_texts(
            ['a', 'bb', 'ccc'], max_new_tokens=4)
        health = json.loads(urllib.request.urlopen(
            f'http://127.0.0.1:{host_port}/health', timeout=10).read())
        assert health == {'status': 'ok', 'model': 'tiny'}
        stats = json.loads(urllib.request.urlopen(
            f'http://127.0.0.1:{host_port}/stats', timeout=10).read())
        assert stats['slots'] == port.max_slots
        assert stats['decode_steps'] > 0
    finally:
        server.shutdown()
        server.server_close()


def test_sampling_is_a_function_of_seed_and_position(engines):
    """temperature > 0: the same (seed, prompt) gives the same stream,
    another seed another one (the reference's contract; its threefry
    draws themselves are not reproduced)."""
    _, port, _ = engines
    ids = [5, 9, 42, 7]
    a = port.generate_ids(ids, max_new_tokens=12, temperature=1.0, seed=3)
    b = port.generate_ids(ids, max_new_tokens=12, temperature=1.0, seed=3)
    c = port.generate_ids(ids, max_new_tokens=12, temperature=1.0, seed=4)
    assert a == b and a != c
