#!/usr/bin/env python3
"""The dense MoE block's expert products, two ways, on one card.

    python3 tools/moe_expert_products.py [--tokens 4 1024] [--runs 20]

One deepseek-moe-16b layer at full width (d_model 2048, 64 experts of
d_ff 1408, top 6; bf16 experts from a seed, fp32 router) runs
``models/llama.py:_moe_block`` (dense dispatch, no aux) on bf16 tokens,
as the decode step (4 slots, one token each) and a prefill chunk run it:
once as the port has it, the tokens times every expert as one ``bmm``
with the tokens broadcast over the experts (``_to_experts``), and once
with ``torch.einsum('bsd,edf->ebsf', ...)`` in its place. Both are held
to each other (they must agree to bf16 rounding), then timed with CUDA
events (median of ``--runs`` after a warm-up; the 1.1 GB of experts
does not fit the L2). Prints the card's name and power limit, one
``[experts]`` line per (tokens, variant) and a JSON line of the times,
with the block's weight-read bound (expert bytes / 3.35 TB/s).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HBM_BYTES_PER_S = 3.35e12


def events_ms(torch, fn, runs):
    fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--tokens', type=int, nargs='+', default=[4, 1024],
                        help='tokens per call: B=4 rows of tokens/4')
    parser.add_argument('--runs', type=int, default=20)
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print('moe_expert_products: no CUDA device', file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.models.config import get_model_config
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    cfg = get_model_config('deepseek-moe-16b', n_layers=1)
    params = llama.init_params(0, cfg, device='cuda',
                               weight_dtype=cfg.compute_dtype)
    lp = {k: v[0] for k, v in params['layers']['moe'].items()}
    expert_bytes = sum(lp[n].numel() * lp[n].element_size()
                       for n in ('wi_gate', 'wi_up', 'wo'))
    bound_ms = expert_bytes / HBM_BYTES_PER_S * 1e3
    port = llama._to_experts

    def einsum(x, w):
        return torch.einsum('bsd,edf->ebsf', x, w)

    results = []
    gen = torch.Generator(device='cuda').manual_seed(1)
    for tokens in args.tokens:
        x = torch.randn((4, tokens // 4, cfg.d_model), device='cuda',
                        generator=gen).to(cfg.compute_dtype)
        outs, row = {}, dict(tokens=tokens, bound_ms=bound_ms)
        for name, fn in (('broadcast_bmm', port), ('einsum', einsum)):
            llama._to_experts = fn
            try:
                def block():
                    with torch.no_grad():
                        return llama._moe_block(x, lp, cfg, with_aux=False)[0]
                outs[name] = block()
                row[name] = events_ms(torch, block, args.runs)
            finally:
                llama._to_experts = port
            print(f'[experts] {tokens} tokens, {name}: {row[name]:.4f} ms '
                  f'(bound {bound_ms:.4f} ms, '
                  f'{100 * bound_ms / row[name]:.1f}%)', flush=True)
        err = ((outs['einsum'].float() - outs['broadcast_bmm'].float()).abs()
               .max() / outs['einsum'].float().abs().max()).item()
        row['max_rel_diff'] = err
        results.append(row)
        if not err <= 2e-2:
            print(f'moe_expert_products: the variants disagree ({err:.3e})',
                  file=sys.stderr)
            return 1
    print(json.dumps(dict(expert_bytes=expert_bytes, results=results)))
    return 0


if __name__ == '__main__':
    sys.exit(main())
