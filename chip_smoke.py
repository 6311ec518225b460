#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py              # all phases, one card
    python3 chip_smoke.py --skip-engine  # device, build and kernels only
    python3 chip_smoke.py --profile      # + a torch.profiler window

Phases, in order; any failure exits non-zero:

1. Device: a CUDA card or exit; print its ``nvidia-smi`` name and power
   limit; TF32 off for matmuls and cuDNN.
2. Build: compile every kernel under ``skypilot_tpu_torch/csrc`` from
   this checkout (``_build.build_all``).
3. Kernels vs plain: each paged-attention kernel against its plain
   PyTorch version on the same card tensors, at llama3-8b attention
   shapes (H=32, KVH=8, D=128, BS=16; shuffled block tables; lengths
   1..2048), decode (Q=1) and verify (Q=5) windows, bf16 / fp32 / int8
   pools, head dims 64 and 256, the engine's own B=4 shape, and B=40.
   Then times (median of CUDA-event timings, L2 flushed before each
   launch) at the B=8 mixed-length decode shape: kernel, plain version,
   and ``F.scaled_dot_product_attention`` over the gathered view (a
   yardstick only; the port never calls it), beside the bound; and the
   kernel's time against its split count at B=4, 8, 40 and 128.
4. Small-model agreement: the engine on the card (kernel path) and on
   the CPU (plain path) give the same greedy tokens on a TINY-shaped
   model with head_dim 128 and fp32 compute.
5. Engine, full width: llama3-8b at full depth (bf16 weights from the
   port's seeded random init on the card), served by the port's HTTP
   server; four concurrent ``/generate`` requests, one of them longer
   than a prefill chunk; the kernel counter must rise by n_layers per
   decode step; a repeated request is identical.
6. Engine, int8 KV on the same weights: the int8 kernel must run.

Then one JSON line listing every kernel, the ``nvidia-smi`` name and
power-limit line, and last ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

# Peak rates per card (NVIDIA data sheets; dense, no sparsity).
_CARDS = [  # (name fragment, memory bytes/s, bf16 flop/s)
    ('H200', 4.8e12, 989e12),
    ('H100 NVL', 3.9e12, 835e12),
    ('H100 PCIe', 2.0e12, 756e12),
    ('H100', 3.35e12, 989e12),   # SXM
]
N_TIMED = 30


def log(msg: str) -> None:
    print(msg, flush=True)


def card_peaks(name: str):
    for fragment, bw, flops in _CARDS:
        if fragment in name:
            return fragment, bw, flops
    raise RuntimeError(f'no peak rates known for {name!r}')


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Phase 3: kernels vs plain
# ---------------------------------------------------------------------------

def make_case(torch, *, b, kvh, g, d, bs, bps, lengths, q_len, pool, seed):
    """Card tensors for one paged-attention call (public layout)."""
    from skypilot_tpu_torch.models.decode import quantize_kv
    gen = torch.Generator(device='cuda')
    gen.manual_seed(seed)
    nb = b * bps + 1
    qdt = torch.float32 if pool == 'fp32' else torch.bfloat16
    k = torch.randn((nb, bs, kvh, d), generator=gen, device='cuda')
    v = torch.randn((nb, bs, kvh, d), generator=gen, device='cuda')
    q = torch.randn((b, q_len, kvh * g, d), generator=gen,
                    device='cuda').to(qdt)
    perm = torch.randperm(nb - 1, generator=gen, device='cuda') + 1
    bt = perm[:b * bps].reshape(b, bps).to(torch.int32).contiguous()
    nv = torch.tensor(lengths, dtype=torch.int32, device='cuda')
    qg = q.reshape(b, q_len, kvh, g, d).transpose(1, 2)
    case = {'q': q, 'qg': qg.reshape(b, kvh, q_len * g, d).contiguous(),
            'bt': bt, 'nv': nv, 'k_scale': None, 'v_scale': None}
    if pool == 'int8':
        case['k'], case['k_scale'] = quantize_kv(k.to(torch.bfloat16))
        case['v'], case['v_scale'] = quantize_kv(v.to(torch.bfloat16))
    else:
        case['k'], case['v'] = k.to(qdt), v.to(qdt)
    return case


def run_kernel(pa, c):
    return pa.paged_attention(c['q'], c['k'], c['v'], c['bt'], c['nv'],
                              k_scale=c['k_scale'], v_scale=c['v_scale'])


def run_kernel_splits(pa, c, splits):
    """The kernel alone (kernel layout, no regroup) with a fixed split
    count; returns the kernel layout [B, KVH, Q*G, D]."""
    q_len = c['q'].shape[1]
    return pa.paged_attention_kernel(c['qg'], c['k'], c['v'], c['bt'],
                                     c['nv'], q_len, c['k_scale'],
                                     c['v_scale'], num_splits=splits)


def run_plain(pa, c):
    return pa.paged_attention_reference(c['q'], c['k'], c['v'], c['bt'],
                                        c['nv'], c['k_scale'],
                                        c['v_scale'])


def time_ms(torch, fn, flush) -> float:
    """Median device time of ``fn`` over N_TIMED launches, each after an
    L2 flush; a device-side sleep keeps the host's enqueue out of the
    measured window."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(N_TIMED):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(c, bs, d, bw, flops_peak):
    """Least time for the work this call's data needs: the K/V rows of
    the blocks read (+ int8 scales), q, out, lengths and tables, each
    moved once, against ~4 flops per (query row, key row, dim)."""
    nv = c['nv'].tolist()
    b, q_len, h, _ = c['q'].shape
    kvh = c['k'].shape[2]
    bps = c['bt'].shape[1]
    rows = sum(min(math.ceil(n / bs), bps) * bs for n in nv)
    kv_bytes = rows * kvh * d * 2 * c['k'].element_size()
    if c['k_scale'] is not None:
        kv_bytes += rows * kvh * 4 * 2
    q_bytes = c['q'].numel() * c['q'].element_size()
    nbytes = kv_bytes + 2 * q_bytes + 4 * b + 4 * b * bps
    flops = 4 * rows * q_len * h * d
    bytes_ms = nbytes / bw * 1e3
    ops_ms = flops / flops_peak * 1e3
    return (max(bytes_ms, ops_ms),
            'bytes' if bytes_ms >= ops_ms else 'operations')


def library_call(torch, c, bs):
    """``F.scaled_dot_product_attention`` over the pre-gathered view with
    a boolean mask: one library call computing the same decode (Q=1)
    function, timed as a yardstick."""
    import torch.nn.functional as F
    b, q_len, h, d = c['q'].shape
    nb, _, kvh, _ = c['k'].shape
    bps = c['bt'].shape[1]
    rows = (c['bt'].long()[:, :, None] * bs +
            torch.arange(bs, device='cuda')).reshape(b, -1)
    k = c['k'].reshape(nb * bs, kvh, d)[rows]
    v = c['v'].reshape(nb * bs, kvh, d)[rows]
    if c['k_scale'] is not None:
        k = (k.float() * c['k_scale'].reshape(nb * bs, kvh)[rows][..., None])
        v = (v.float() * c['v_scale'].reshape(nb * bs, kvh)[rows][..., None])
    dt = c['q'].dtype
    g = h // kvh
    k = k.to(dt).repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
    v = v.to(dt).repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
    q = c['q'].transpose(1, 2).contiguous()
    mask = (torch.arange(bps * bs, device='cuda')[None, :] <
            c['nv'][:, None])[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)


def phase_kernels(torch, pa, bw, flops_peak):
    llama = dict(kvh=8, g=4, d=128, bs=16, bps=128)
    lengths8 = [1, 15, 16, 17, 1000, 2048, 1000, 2048]
    tol = {'bf16': 2e-2, 'fp32': 2e-4, 'int8': 2e-2}
    errors = {'paged_attention': 0.0, 'paged_attention_quant': 0.0}
    cases = []
    for pool in ('bf16', 'fp32', 'int8'):
        for q_len in (1, 5):
            cases.append((f'{pool} Q={q_len} B=8', pool,
                          dict(llama, b=8, lengths=lengths8, q_len=q_len)))
        cases.append((f'{pool} Q=1 B=4 (engine shape)', pool,
                      dict(llama, b=4, lengths=[1, 17, 1000, 2048],
                           q_len=1)))
        for q_len in (1, 5):
            cases.append((f'{pool} Q={q_len} B=40', pool,
                          dict(llama, b=40, lengths=lengths8 * 5,
                               q_len=q_len)))
    cases.append(('bf16 D=64 H=64 KVH=8', 'bf16',
                  dict(kvh=8, g=8, d=64, bs=16, bps=128, b=8,
                       lengths=[1000] * 8, q_len=1)))
    cases.append(('bf16 D=256 H=16 KVH=16', 'bf16',
                  dict(kvh=16, g=1, d=256, bs=16, bps=128, b=8,
                       lengths=[1000] * 8, q_len=1)))
    for seed, (label, pool, shape) in enumerate(cases):
        c = make_case(torch, pool=pool, seed=seed, **shape)
        splits = pa._num_splits(shape['bps'])
        out = run_kernel(pa, c)
        torch.cuda.synchronize()
        ref = run_plain(pa, c)
        err = (out.float() - ref.float()).abs().max().item()
        finite = bool(torch.isfinite(out).all().item())
        name = 'paged_attention_quant' if pool == 'int8' else \
            'paged_attention'
        errors[name] = max(errors[name], err)
        status = 'ok' if finite and err <= tol[pool] else 'FAIL'
        log(f'[kernels] {label}, {splits} split(s): max|kernel-plain| = '
            f'{err:.3e} (tol {tol[pool]:g}) {status}')
        if status != 'ok':
            raise AssertionError(f'kernel disagrees with plain: {label}')

    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8,
                        device='cuda')
    rows = {}
    for name, pool in (('paged_attention', 'bf16'),
                       ('paged_attention_quant', 'int8')):
        c = make_case(torch, pool=pool, seed=100,
                      **dict(llama, b=8, lengths=lengths8, q_len=1))
        ms = time_ms(torch, lambda: run_kernel(pa, c), flush)
        plain_ms = time_ms(torch, lambda: run_plain(pa, c), flush)
        library_ms = time_ms(torch, library_call(torch, c, 16), flush)
        bound_ms, bound_by = bound(c, 16, 128, bw, flops_peak)
        rows[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                          bound_ms=bound_ms, bound_by=bound_by,
                          max_abs_err=errors[name])
        log(f'[kernels] {name} B=8 mixed decode: kernel {ms:.4f} ms, '
            f'plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, '
            f'bound {bound_ms:.4f} ms ({bound_by})')
    split_study(torch, pa, llama, lengths8, flush)
    del flush
    return rows


def split_study(torch, pa, llama, lengths8, flush):
    """Kernel time (its combine included) against the split count, bf16
    pool, Q=1: at the engine's B=4 decode shape (its four prompts
    halfway through their 32 new tokens) and at mixed lengths for B=8,
    40 and 128."""
    shapes = {'B=4 engine decode (22/57/167/417)': [22, 57, 167, 417],
              'B=8 mix': lengths8,
              'B=40 mix': lengths8 * 5,
              'B=128 mix': lengths8 * 16}
    for label, lengths in shapes.items():
        shape = dict(llama, b=len(lengths), lengths=lengths, q_len=1)
        c = make_case(torch, pool='bf16', seed=200, **shape)
        picked = pa._num_splits(shape['bps'])
        times = {s: time_ms(torch, lambda: run_kernel_splits(pa, c, s),
                            flush)
                 for s in sorted({1, 2, 4, 8, 16, 32, 64, picked})}
        best = min(times, key=times.get)
        log(f'[splits] {label}: picked {picked} '
            f'({times[picked]:.4f} ms), best {best} ({times[best]:.4f} ms); '
            f'ms by splits ' + json.dumps({str(s): t
                                           for s, t in times.items()}))


# ---------------------------------------------------------------------------
# Phases 4-6: the engine
# ---------------------------------------------------------------------------

def post_generate(port: int, prompts, max_new_tokens: int):
    body = json.dumps({'prompts': prompts,
                       'max_new_tokens': max_new_tokens}).encode()
    req = urllib.request.Request(
        f'http://127.0.0.1:{port}/generate', data=body,
        headers={'Content-Type': 'application/json'})
    with urllib.request.urlopen(req, timeout=600) as resp:
        return json.loads(resp.read())


def recorded_ids(engine):
    """Record the token ids behind each text request (the HTTP payload
    carries text; the check needs ids)."""
    records = []
    inner = engine.generate_ids

    def generate_ids(ids, **kwargs):
        out = inner(ids, **kwargs)
        records.append((list(ids), list(out)))
        return out

    engine.generate_ids = generate_ids
    return records


def phase_small_agreement(torch):
    from skypilot_tpu_torch.inference.continuous import (
        ContinuousBatchingEngine)
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.models.config import get_model_config
    cfg = get_model_config('tiny', head_dim=128,
                           compute_dtype=torch.float32)
    params = llama.init_params(7, cfg, device='cpu')
    prompts = [[3, 1, 4, 1, 5], [2, 7, 18] * 9, [31, 41, 59, 26, 5, 3]]
    outs = {}
    for device in ('cuda', 'cpu'):
        engine = ContinuousBatchingEngine('tiny', cfg=cfg, params=params,
                                          device=device, max_slots=2,
                                          max_len=96)
        try:
            handles = [engine.submit_ids(p, max_new_tokens=12)
                       for p in prompts]
            for h in handles:
                if not h.done.wait(300) or h.error is not None:
                    raise RuntimeError(f'{device} request failed: '
                                       f'{h.error}')
            outs[device] = [h.generated for h in handles]
        finally:
            engine.shutdown()
    log(f'[small] card tokens {outs["cuda"]}')
    if outs['cuda'] != outs['cpu']:
        raise AssertionError(f'card and CPU disagree: {outs}')
    log('[small] card (kernel) and CPU (plain) greedy tokens agree')


def serve_engine(engine):
    from skypilot_tpu_torch.inference import server as server_lib
    server = server_lib.serve(engine, '127.0.0.1', 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, server.server_address[1]


def drive_engine(torch, pa, engine, kernel, prompts, max_new_tokens):
    """One run of the main path: the launch counts are zeroed just
    before and read just after. Returns (counts, per-request records,
    stats before, stats after, wall seconds)."""
    server, port = serve_engine(engine)
    try:
        records = recorded_ids(engine)
        before = engine.stats()
        results = [None] * len(prompts)
        errors = []

        def run(i):
            try:
                results[i] = post_generate(port, [prompts[i]],
                                           max_new_tokens)
            except Exception as e:  # collected, then raised below
                errors.append(e)

        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(prompts))]
        torch.cuda.synchronize()
        pa.reset_launch_counts()
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(pa.LAUNCHES)
        after = engine.stats()
        if errors:
            raise errors[0]
        if any(r is None or len(r['outputs']) != 1 for r in results):
            raise AssertionError(f'bad /generate payloads: {results}')
    finally:
        server.shutdown()
        server.server_close()
    vocab = engine.cfg.vocab_size
    if len(records) != len(prompts):
        raise AssertionError(f'{len(records)} records for '
                             f'{len(prompts)} requests')
    for ids, out in records:
        if not 1 <= len(out) <= max_new_tokens or \
                not all(0 <= t < vocab for t in out):
            raise AssertionError(f'bad output ids for a {len(ids)}-token '
                                 f'prompt: {out}')
    steps = after['decode_steps'] - before['decode_steps']
    expected = engine.cfg.n_layers * steps
    if counts[kernel] != expected or steps <= 0:
        raise AssertionError(f'{kernel} launched {counts[kernel]} times '
                             f'in {steps} decode steps; expected '
                             f'{expected}')
    log(f'[engine] {kernel}: {counts[kernel]} launches = '
        f'{engine.cfg.n_layers} layers x {steps} decode steps; '
        f'all launch counts {counts}')
    return counts, records, before, after, wall


def profile_decode(torch, engine, prompts, max_new_tokens):
    """Trace one batch of requests with ``torch.profiler``: the device's
    busy share of the window (kernel self time / wall) and the kernels
    that take it."""
    from torch.profiler import ProfilerActivity, profile
    handles = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for p in prompts:
            handles.append(engine.submit_ids(engine.tokenizer.encode(p),
                                             max_new_tokens=max_new_tokens))
        for h in handles:
            if not h.done.wait(600) or h.error is not None:
                raise RuntimeError(f'profiled request failed: {h.error}')
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for entry in prof.key_averages():
        dev = getattr(entry, 'self_device_time_total', None)
        if dev is None:
            dev = getattr(entry, 'self_cuda_time_total', 0)
        if dev > 0:
            rows.append((dev, entry.key, entry.count))
    busy_us = sum(r[0] for r in rows)
    log(f'[profile] window {wall_us / 1e3:.1f} ms, device busy '
        f'{busy_us / 1e3:.1f} ms ({100 * busy_us / wall_us:.1f}%)')
    for dev, key, count in sorted(rows, reverse=True)[:12]:
        log(f'[profile]   {dev / 1e3:9.2f} ms  {count:6d}x  {key[:90]}')
    return busy_us / wall_us


def phase_engine(torch, pa, profile_window=False):
    from skypilot_tpu_torch.inference.continuous import (
        ContinuousBatchingEngine)
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.models.config import get_model_config
    cfg = get_model_config('llama3-8b')
    t0 = time.perf_counter()
    params = llama.init_params(0, cfg, device='cuda',
                               weight_dtype=cfg.compute_dtype)
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    log(f'[engine] llama3-8b init on card: {nbytes / 1e9:.2f} GB in '
        f'{time.perf_counter() - t0:.1f} s')
    engine = ContinuousBatchingEngine('llama3-8b', params=params,
                                      max_slots=4, max_len=2048,
                                      block_size=16)
    pool_gb = (engine.cache.k.numel() * engine.cache.k.element_size() *
               2 / 1e9)
    log(f'[engine] KV pool {tuple(engine.cache.k.shape)} x2 = '
        f'{pool_gb:.2f} GB; prefill chunk {engine.prefill_chunk}')
    result = {}
    try:
        engine.generate_ids([1, 2, 3], max_new_tokens=2)  # warm-up
        text = ('The paged pool maps every slot through a block table. '
                * 8)
        prompts = ['Hello', text[:40], text[:150], text[:400]]
        counts, records, before, after, wall = drive_engine(
            torch, pa, engine, 'paged_attention', prompts, 32)
        result['launches'] = counts['paged_attention']
        tokens = after['tokens_generated'] - before['tokens_generated']
        decode_s = after['decode_seconds'] - before['decode_seconds']
        result['decode_tok_s'] = tokens / decode_s if decode_s else 0.0
        result['wall_tok_s'] = tokens / wall
        result['decode_steps'] = (after['decode_steps'] -
                                  before['decode_steps'])
        log(f'[engine] 4 concurrent requests: {tokens} tokens, '
            f'{result["decode_steps"]} decode steps, '
            f'decode {result["decode_tok_s"]:.1f} tok/s, '
            f'wall {result["wall_tok_s"]:.1f} tok/s ({wall:.2f} s)')
        # Repeat one request: greedy output is identical.
        ids = engine.tokenizer.encode(prompts[2])
        first = engine.generate_ids(ids, max_new_tokens=16)
        second = engine.generate_ids(ids, max_new_tokens=16)
        if first != second:
            raise AssertionError(f'repeat differs: {first} vs {second}')
        log(f'[engine] repeated request identical ({len(first)} tokens)')
        # Time to first token of a lone 150-token request.
        t0 = time.perf_counter()
        stream = engine.stream_ids(ids, max_new_tokens=4)
        next(stream)
        result['ttft_ms'] = (time.perf_counter() - t0) * 1e3
        list(stream)
        log(f'[engine] time to first token ({len(ids)}-token prompt): '
            f'{result["ttft_ms"]:.1f} ms')
        if profile_window:
            result['device_busy_share'] = profile_decode(
                torch, engine, prompts, 32)
    finally:
        engine.shutdown()
    del engine
    # Phase 6: int8 KV on the same weights.
    engine = ContinuousBatchingEngine('llama3-8b', params=params,
                                      max_slots=4, max_len=2048,
                                      block_size=16, quantize_kv=True)
    try:
        counts, _, before, after, _ = drive_engine(
            torch, pa, engine, 'paged_attention_quant',
            ['Hello', text[:200]], 16)
        result['launches_quant'] = counts['paged_attention_quant']
    finally:
        engine.shutdown()
    return result


def _leaves(tree):
    if isinstance(tree, dict):
        for value in tree.values():
            yield from _leaves(value)
    else:
        yield tree


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--skip-engine', action='store_true',
                        help='stop after the kernel checks')
    parser.add_argument('--profile', action='store_true',
                        help='also trace one batch of llama3-8b requests '
                             'with torch.profiler (device busy share, '
                             'top kernels)')
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device available', file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from skypilot_tpu_torch import _build
    from skypilot_tpu_torch.ops import paged_attention as pa
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    card, bw, flops_peak = card_peaks(kind)
    log(f'[device] {smi}; peaks used: {card} {bw / 1e12:.2f} TB/s, '
        f'{flops_peak / 1e12:.0f} TFLOP/s bf16; torch {torch.__version__} '
        f'cuda {torch.version.cuda}')

    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f'[build] {len(libs)} kernel libraries in '
        f'{time.perf_counter() - t0:.1f} s: {libs}')

    rows = phase_kernels(torch, pa, bw, flops_peak)
    engine = {}
    if not args.skip_engine:
        phase_small_agreement(torch)
        engine = phase_engine(torch, pa, profile_window=args.profile)
        log(f'[engine] summary {json.dumps(engine)}')
    replaces = {
        'paged_attention':
            'skypilot_tpu/ops/pallas/paged_attention.py:64',
        'paged_attention_quant':
            'skypilot_tpu/ops/pallas/paged_attention.py:124',
    }
    # Counts come only from the main path's own run: null when it was
    # skipped, never a number this run did not measure.
    launches = {'paged_attention': engine.get('launches'),
                'paged_attention_quant': engine.get('launches_quant')}
    kernels = [dict(name=name, route='cuda',
                    source='skypilot_tpu_torch/csrc/paged_attention.cu',
                    replaces=replaces[name], launches=launches[name],
                    **rows[name]) for name in replaces]
    print(json.dumps({'kernels': kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
