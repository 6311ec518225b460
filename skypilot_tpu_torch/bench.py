"""Benchmark twin of the reference's ``bench.py`` on one GPU.

    python -m skypilot_tpu_torch.bench [--mode train|decode|kernels]
    python -m skypilot_tpu_torch.bench --device cpu --mode train

Prints ONE JSON line: ``{"metric", "value", "unit", "vs_baseline",
"detail"}``, with the reference's keys and, in ``detail``, the card's
name and power limit as ``nvidia-smi`` gives them.

* ``train`` (the headline metric): model FLOPs utilization of the train
  step. bench-1b7 with Adafactor, bf16 params and the config's remat by
  default, ``TrainHParams(warmup_steps=10, total_steps=1000)``, B=8,
  S=2048, 5 warmup and 20 timed steps dispatched back to back, a scalar
  fetch of the loss as the sync point. MFU = tokens/s x
  ``cfg.flops_per_token(seq)`` / peak; ``vs_baseline`` = MFU / 0.40.
* ``decode``: steady-state tokens/s of ``models/decode.generate``,
  timed at N and 2N new tokens and differenced so the prefill cancels.
  ``--quantize`` (W8A8) and ``--attention-impl`` are the A/B axes.
* ``kernels``: every hand kernel against its plain version at the
  reference's shapes (B=2, S=512, H=8, KVH=4, D=128, T=256; a shuffled
  paged pool of block 32; a Q=4 verify window) and tolerances (2e-2,
  2e-1 for gradients, 0.12 for int8 caches); exit 1 if any check fails.

The peak bf16 rate comes from the card's name: 989 TFLOP/s for an H100
SXM ("H100 80GB HBM3"), 756 for an H100 PCIe; any other card is marked
``peak_estimated`` and measured against 989.

It runs on the card unless ``--device cpu`` is given, and then takes the
reference's CPU defaults (TINY, batch 4, seq 64; decode batch 2, 16
tokens; kernels at B=1, S=256, H=2, KVH=1, T=128 in fp32 with tolerances
2e-4 and 2e-3, where the wrappers run their plain versions). With no
card and no ``--device cpu`` it prints a ``train_mfu_unavailable`` line
and exits 1: it never moves to the CPU by itself.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

# Peak dense bf16 TFLOP/s by card name (NVIDIA data sheets).
_PEAK_TFLOPS = (('H100 PCIe', 756.0), ('H100 SXM', 989.0),
                ('H100 80GB HBM3', 989.0))
_NOMINAL_PEAK = 989.0


def card_info(device: torch.device) -> Dict[str, Any]:
    """The card's name and power limit in watts (``nvidia-smi``); on the
    CPU the platform's name and None."""
    if device.type != 'cuda':
        return {'card': 'cpu', 'power_limit_w': None}
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader,nounits', f'--id={device.index or 0}'],
        capture_output=True, text=True, check=True, timeout=60)
    name, _, limit = out.stdout.strip().splitlines()[0].rpartition(',')
    return {'card': name.strip(), 'power_limit_w': float(limit)}


def peak_tflops(device: torch.device) -> Tuple[float, bool]:
    """(peak bf16 TFLOP/s, estimated?) of ``device``."""
    if device.type != 'cuda':
        return 0.1, False  # nominal; CPU runs are smoke only
    name = torch.cuda.get_device_name(device)
    for fragment, tflops in _PEAK_TFLOPS:
        if fragment in name:
            return tflops, False
    return _NOMINAL_PEAK, True


def _backend(device: torch.device) -> str:
    return 'gpu' if device.type == 'cuda' else 'cpu'


def _random_tokens(seed: int, shape, vocab: int,
                   device: torch.device) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, vocab, shape, generator=gen,
                         dtype=torch.int32).to(device)


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------

def train_setup(args, model: str, on_accel: bool):
    """(config, optimizer, batch, seq) of the train mode: the flags, else
    the reference's defaults (bench-1b7 takes Adafactor and bf16
    params)."""
    from skypilot_tpu_torch.models.config import get_model_config
    overrides: Dict[str, Any] = {}
    param_dtype = args.param_dtype or (
        'bfloat16' if model == 'bench-1b7' else None)
    if param_dtype:
        overrides['param_dtype'] = getattr(torch, param_dtype)
    if args.remat_policy:
        overrides['remat_policy'] = args.remat_policy
    cfg = get_model_config(model, **overrides)
    optimizer = args.optimizer or (
        'adafactor' if model == 'bench-1b7' else 'adamw')
    batch = args.batch or (8 if on_accel else 4)
    seq = min(args.seq or (2048 if on_accel else 64), cfg.max_seq_len)
    return cfg, optimizer, batch, seq


def train_bench(args, model: str, device: torch.device) -> int:
    from skypilot_tpu_torch.train.step import (TrainHParams,
                                               create_train_state,
                                               make_train_step)
    on_accel = device.type == 'cuda'
    steps = args.steps or 20
    warmup = args.warmup or 5
    cfg, optimizer, batch, seq = train_setup(args, model, on_accel)
    hp = TrainHParams(warmup_steps=10, total_steps=1000,
                      optimizer=optimizer)
    if on_accel:
        torch.cuda.reset_peak_memory_stats(device)
    state = create_train_state(0, cfg, hp, device=device)
    step = make_train_step(cfg, hp)
    tokens = _random_tokens(1, (batch, seq), cfg.vocab_size, device)
    train_batch = {
        'tokens': tokens,
        'targets': torch.roll(tokens, -1, dims=1),
        'weights': torch.ones((batch, seq), dtype=torch.float32,
                              device=device),
    }
    metrics = None
    for _ in range(max(warmup, 1)):
        state, metrics = step(state, train_batch)
    float(metrics['loss'])  # sync point

    # Timed region: all steps dispatched back to back; the final scalar
    # fetch waits for the whole chain (each step updates the params the
    # next one reads).
    t0 = time.perf_counter()
    for _ in range(steps):
        state, metrics = step(state, train_batch)
    loss = float(metrics['loss'])
    elapsed = time.perf_counter() - t0

    tokens_per_sec = batch * seq * steps / elapsed
    flops_per_token = cfg.flops_per_token(seq)
    achieved_tflops = tokens_per_sec * flops_per_token / 1e12
    peak, estimated = peak_tflops(device)
    mfu = achieved_tflops / peak
    detail = {
        'tokens_per_sec_per_chip': round(tokens_per_sec, 1),
        'achieved_tflops_per_chip': round(achieved_tflops, 2),
        'peak_tflops_per_chip': peak,
        'batch': batch, 'seq': seq, 'steps': steps,
        'loss': round(loss, 4),
        'peak_estimated': estimated,
        'seconds_per_step': elapsed / steps,
        'optimizer': optimizer,
        'param_dtype': str(cfg.param_dtype).replace('torch.', ''),
        'remat_policy': cfg.remat_policy,
        'peak_memory_gb': (torch.cuda.max_memory_allocated(device) / 1e9
                           if on_accel else None),
    }
    detail.update(card_info(device))
    print(json.dumps({
        'metric': f'train_mfu_{model}_{_backend(device)}1',
        'value': round(mfu * 100, 2),
        'unit': '% MFU',
        'vs_baseline': round(mfu / 0.40, 3),
        'detail': detail,
    }), flush=True)
    return 0


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def decode_bench(args, model: str, device: torch.device) -> int:
    """Steady-state decode tokens/s: two ``generate`` lengths (N and 2N)
    are timed and differenced, so the prefill cancels and the rate is
    the autoregressive loop alone (KV-cache attention and weight
    reads)."""
    from skypilot_tpu_torch.models import decode as decode_lib
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.models.config import get_model_config
    from skypilot_tpu_torch.models.quant import maybe_quantize

    on_accel = device.type == 'cuda'
    overrides: Dict[str, Any] = {}
    param_dtype = args.param_dtype or ('bfloat16' if on_accel else None)
    if param_dtype:
        overrides['param_dtype'] = getattr(torch, param_dtype)
    if args.attention_impl:
        overrides['attention_impl'] = args.attention_impl
    cfg = get_model_config(model, **overrides)
    batch = args.batch or (8 if on_accel else 2)
    new_tokens = args.steps or (256 if on_accel else 16)
    prompt_len = args.seq or (128 if on_accel else 16)
    # prompt + the longer (2N) run must stay inside the model context.
    prompt_len = min(prompt_len, max(cfg.max_seq_len - 2 * new_tokens, 8))
    new_tokens = min(new_tokens,
                     max((cfg.max_seq_len - prompt_len) // 2, 1))

    params = maybe_quantize(llama.init_params(0, cfg, device=device),
                            args.quantize)
    tokens = _random_tokens(1, (batch, prompt_len), cfg.vocab_size, device)
    lengths = torch.full((batch,), prompt_len, dtype=torch.int32,
                         device=device)

    def run(n: int) -> float:
        t0 = time.perf_counter()
        with torch.no_grad():
            out, _ = decode_lib.generate(params, tokens, lengths, cfg,
                                         max_new_tokens=n, temperature=0.0)
        out.cpu()
        return time.perf_counter() - t0

    for _ in range(args.warmup or 1):
        run(new_tokens)
        run(2 * new_tokens)
    t_n = run(new_tokens)
    t_2n = run(2 * new_tokens)
    decode_elapsed = max(t_2n - t_n, 1e-9)   # prefill cancels
    toks_per_sec = batch * new_tokens / decode_elapsed
    detail = {
        'batch': batch, 'prompt_len': prompt_len,
        'new_tokens': new_tokens, 'quantized': args.quantize,
        'attention_impl': cfg.attention_impl,
        'param_dtype': param_dtype or 'float32',
        'devices_used': 1,
        'per_seq_toks_per_sec': round(toks_per_sec / batch, 1),
        'prefill_plus_n_seconds': round(t_n, 4),
    }
    detail.update(card_info(device))
    print(json.dumps({
        'metric': f'decode_toks_per_sec_{model}'
                  f'{"_int8" if args.quantize else ""}'
                  f'_{_backend(device)}1',
        'value': round(toks_per_sec, 1),
        'unit': 'tokens/sec',
        'vs_baseline': 0,     # no reference decode number to compare
        'detail': detail,
    }), flush=True)
    return 0


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

def kernels_check(device: torch.device) -> int:
    """Every hand kernel against its plain version (on the CPU the
    wrappers run their plain versions, as the reference's interpreter
    runs its kernels)."""
    from skypilot_tpu_torch.models.decode import quantize_kv
    from skypilot_tpu_torch.ops import decode_attention as da
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.ops import paged_attention as pa
    from skypilot_tpu_torch.ops.attention import xla_attention

    on_accel = device.type == 'cuda'
    checks: Dict[str, Dict[str, Any]] = {}

    def record(name: str, make_got: Callable[[], torch.Tensor],
               ref: torch.Tensor, tol: float) -> None:
        # Each check runs under its own guard, so a launch failure lands
        # in the JSON line instead of ending the process before it.
        try:
            got = make_got()
            err = float((got.float() - ref.float()).abs().max())
            checks[name] = {'max_abs_err': round(err, 6),
                            'ok': math.isfinite(err) and err < tol}
        except Exception as e:  # pylint: disable=broad-except
            checks[name] = {'ok': False,
                            'error': f'{type(e).__name__}: {e}'[:300]}

    if on_accel:
        b, s, h, kv, d, t = 2, 512, 8, 4, 128, 256
    else:
        b, s, h, kv, d, t = 1, 256, 2, 1, 128, 128
    fwd_tol = 2e-2 if on_accel else 2e-4
    grad_tol = 2e-1 if on_accel else 2e-3
    dt = torch.bfloat16 if on_accel else torch.float32
    gen = torch.Generator().manual_seed(0)

    def normal(*shape):
        return torch.randn(shape, generator=gen).to(device=device, dtype=dt)

    q, k, v = normal(b, s, h, d), normal(b, s, kv, d), normal(b, s, kv, d)
    seg = torch.cat([torch.zeros((b, s // 2), dtype=torch.int32),
                     torch.ones((b, s - s // 2), dtype=torch.int32)],
                    dim=1).to(device)
    with torch.no_grad():
        ref = xla_attention(q, k, v, causal=True)
        ref_seg = xla_attention(q, k, v, causal=True, segment_ids=seg)
        record('flash_fwd',
               lambda: fa.flash_attention(q, k, v, causal=True), ref,
               fwd_tol)
        record('flash_seg_fwd',
               lambda: fa.flash_attention(q, k, v, causal=True,
                                          segment_ids=seg),
               ref_seg, fwd_tol)

    def grads(fn):
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        loss = (fn(*leaves).float() ** 2).sum()
        return torch.autograd.grad(loss, leaves)

    for tag, segments in (('flash', None), ('flash_seg', seg)):
        refs = grads(lambda *a, sg=segments: xla_attention(
            *a, causal=True, segment_ids=sg))
        try:
            got = grads(lambda *a, sg=segments: fa.flash_attention(
                *a, causal=True, segment_ids=sg))
        except Exception as e:  # pylint: disable=broad-except
            checks[f'{tag}_grads'] = {
                'ok': False, 'error': f'{type(e).__name__}: {e}'[:300]}
            continue
        for name, a, r in zip((f'{tag}_dq', f'{tag}_dk', f'{tag}_dv'),
                              got, refs):
            record(name, lambda a=a: a, r, grad_tol)

    with torch.no_grad():
        # Decode kernel: [B,1,H,D] queries over a length-masked cache.
        kc, vc, q1 = normal(b, t, kv, d), normal(b, t, kv, d), \
            normal(b, 1, h, d)
        n_valid = torch.tensor(([t, t // 3] * b)[:b], dtype=torch.int32,
                               device=device)
        ref_dec = da.xla_decode_attention(q1, kc, vc, n_valid)
        record('decode_kernel',
               lambda: da.decode_attention(q1, kc, vc, n_valid), ref_dec,
               fwd_tol)
        kq, kscale = quantize_kv(kc)
        vq, vscale = quantize_kv(vc)
        record('decode_kernel_int8kv',
               lambda: da.decode_attention(q1, kq, vq, n_valid,
                                           k_scale=kscale, v_scale=vscale),
               ref_dec, 0.12)  # int8 cache quantization error floor

        # Paged kernel over a shuffled pool of 32-row blocks.
        bs_pool = 32
        bps = t // bs_pool
        nb = b * bps + 1
        k_pool, v_pool = normal(nb, bs_pool, kv, d), \
            normal(nb, bs_pool, kv, d)
        ids_pool = np.arange(1, nb)
        np.random.RandomState(0).shuffle(ids_pool)
        btab = torch.as_tensor(ids_pool[:b * bps].reshape(b, bps),
                               dtype=torch.int32, device=device)
        ref_paged = pa.paged_attention_reference(q1, k_pool, v_pool, btab,
                                                 n_valid)
        record('paged_kernel',
               lambda: pa.paged_attention(q1, k_pool, v_pool, btab,
                                          n_valid),
               ref_paged, fwd_tol)
        kpq, kps = quantize_kv(k_pool)
        vpq, vps = quantize_kv(v_pool)
        ref_paged8 = pa.paged_attention_reference(
            q1, kpq, vpq, btab, n_valid, kps, vps)
        record('paged_kernel_int8kv',
               lambda: pa.paged_attention(q1, kpq, vpq, btab, n_valid,
                                          k_scale=kps, v_scale=vps),
               ref_paged8, 0.12)
        # Multi-query verify window (speculative decoding's check).
        q4 = normal(b, 4, h, d)
        ref_verify = pa.paged_attention_reference(q4, k_pool, v_pool, btab,
                                                  n_valid)
        record('paged_verify_kernel',
               lambda: pa.paged_attention(q4, k_pool, v_pool, btab,
                                          n_valid),
               ref_verify, fwd_tol)

    all_ok = all(c['ok'] for c in checks.values())
    detail: Dict[str, Any] = {'interpret_mode': not on_accel, **checks}
    detail.update(card_info(device))
    print(json.dumps({
        'metric': f'hand_kernels_vs_plain_{_backend(device)}',
        'value': 1 if all_ok else 0,
        'unit': 'all kernels launch + match',
        'vs_baseline': 1 if all_ok else 0,
        'detail': detail,
    }), flush=True)
    return 0 if all_ok else 1


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--model', default=None)
    parser.add_argument('--batch', type=int, default=None)
    parser.add_argument('--seq', type=int, default=None)
    parser.add_argument('--steps', type=int, default=None,
                        help='train: timed steps (default 20); decode: '
                             'generated tokens (default 256 on the card).')
    parser.add_argument('--warmup', type=int, default=None,
                        help='warmup runs (default: train 5, decode 1).')
    parser.add_argument('--optimizer', default=None,
                        choices=[None, 'adamw', 'adafactor'])
    parser.add_argument('--param-dtype', default=None,
                        choices=[None, 'float32', 'bfloat16'])
    parser.add_argument('--remat-policy', default=None,
                        choices=[None, 'none', 'dots', 'save_attn',
                                 'save_dots', 'full'])
    parser.add_argument('--mode', default='train',
                        choices=['train', 'decode', 'kernels'],
                        help='train = MFU of the train step (the headline '
                             'metric); decode = serving tokens/sec of the '
                             'KV-cache decode loop; kernels = every hand '
                             'kernel vs its plain version.')
    parser.add_argument('--quantize', action='store_true',
                        help='decode mode: int8 W8A8 weights.')
    parser.add_argument('--attention-impl', default=None,
                        choices=[None, 'auto', 'xla', 'pallas'],
                        help='decode mode: attention implementation '
                             "('pallas' = the hand kernels).")
    parser.add_argument('--device', default=None,
                        help="'cuda' (default) or 'cpu'")
    return parser


def main(argv: Optional[list] = None) -> int:
    args = _parser().parse_args(argv)
    if args.device is None and not torch.cuda.is_available():
        print(json.dumps({
            'metric': 'train_mfu_unavailable',
            'value': 0,
            'unit': '% MFU',
            'vs_baseline': 0,
            'detail': {'error': 'no CUDA device is available; pass '
                                '--device cpu to run on the CPU'},
        }), flush=True)
        return 1
    from skypilot_tpu_torch.utils.device import resolve_device
    device = resolve_device(args.device)
    model = args.model or ('bench-1b7' if device.type == 'cuda' else 'tiny')
    if args.mode == 'kernels':
        return kernels_check(device)
    if args.mode == 'decode':
        try:
            return decode_bench(args, model, device)
        except Exception as e:  # pylint: disable=broad-except
            # A launch or runtime failure still lands in a parseable
            # JSON line.
            import traceback
            traceback.print_exc()
            print(json.dumps({
                'metric': f'decode_toks_per_sec_{model}_failed',
                'value': 0,
                'unit': 'tokens/sec',
                'vs_baseline': 0,
                'detail': {'error': f'{type(e).__name__}: {e}'[:500],
                           'quantized': args.quantize,
                           'attention_impl': args.attention_impl},
            }), flush=True)
            return 1
    return train_bench(args, model, device)


if __name__ == '__main__':
    sys.exit(main())
