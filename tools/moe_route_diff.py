#!/usr/bin/env python3
"""Where capacity-dispatch routes part between the card and the CPU.

    python3 tools/moe_route_diff.py [--seeds 7 11] [--capacity-factor 0.5]

Serves TINY_MOE (head_dim 128, fp32 compute, capacity dispatch) with the
same seeded params and prompts on the CPU once and on the card twice,
through the continuous engine (2 slots, max_len 96, one request at a
time) and the batch engine, and records every router call: its fp32
logits, its top-k choices and which of its rows are padding (a prefill
chunk's rows past ``n_new``, a bucketed prompt's rows past its length,
a verify window's rows of an inactive slot). For each card run it
prints one JSON line against the CPU run: whether the greedy tokens are
equal, the first router call whose choices differ, and for each of that
call's differing rows whether it is padding, the smallest gap between
neighbours of its top-(k+1) sorted logits on either device and the
largest difference of its logits between the devices; then the largest
logit difference over real and over padding rows, and the smallest
top-(k+1) gap of real and of padding rows in prefill calls, over all
calls before the first difference. A near-tie shows as a gap of about
the real rows' logit difference (1e-6); padding rows that read
different values on the two devices show as logit differences far above
it.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPTS = [[3, 1, 4, 1, 5], [2, 7, 18] * 9, [31, 41, 59, 26, 5, 3]]


def record(torch, cfg, params, device, new_tokens):
    """Both engines' greedy tokens on ``device`` and every router call
    in order: dicts of 'where', 'logits' [.., E], 'selected' [.., k],
    'pad' [..] (CPU tensors)."""
    from skypilot_tpu_torch.inference.continuous import (
        ContinuousBatchingEngine)
    from skypilot_tpu_torch.inference.engine import InferenceEngine
    from skypilot_tpu_torch.models import decode, llama
    calls, where = [], {}
    saved = dict(route=llama._route, chunk=decode.prefill_chunk,
                 verify=decode.paged_verify_step, prefill=decode.prefill,
                 step=decode.decode_step)

    def route(x, router, k_top):
        logits, weights, selected = saved['route'](x, router, k_top)
        calls.append(dict(where=where['name'],
                          pad=where['pad'].reshape(logits.shape[:-1]).cpu(),
                          logits=logits.detach().cpu(),
                          selected=selected.cpu()))
        return logits, weights, selected

    def chunk(params, tokens, start, n_new, *args, **kwargs):
        where.update(name='prefill_chunk', pad=torch.arange(
            tokens.shape[1]) >= n_new)
        return saved['chunk'](params, tokens, start, n_new, *args, **kwargs)

    def verify(params, tokens, cache, cfg, active=None, n_input=None,
               **kwargs):
        b, q_len = tokens.shape
        live = torch.ones((b, q_len), dtype=torch.bool)
        if n_input is not None:
            live &= torch.arange(q_len)[None, :] < n_input.cpu()[:, None]
        if active is not None:
            live &= active.cpu()[:, None]
        where.update(name='paged_verify_step', pad=~live)
        return saved['verify'](params, tokens, cache, cfg, active=active,
                               n_input=n_input, **kwargs)

    def prefill(params, tokens, lengths, *args, **kwargs):
        where.update(name='prefill', pad=torch.arange(tokens.shape[1])[
            None, :] >= lengths.cpu()[:, None])
        return saved['prefill'](params, tokens, lengths, *args, **kwargs)

    def step(params, tokens, cache, cfg, active=None):
        where.update(name='decode_step', pad=(
            torch.zeros(tokens.shape[0], dtype=torch.bool) if active is None
            else ~active.cpu()))
        return saved['step'](params, tokens, cache, cfg, active=active)

    llama._route, decode.prefill_chunk = route, chunk
    decode.paged_verify_step, decode.prefill = verify, prefill
    decode.decode_step = step
    try:
        engine = ContinuousBatchingEngine('tiny-moe', cfg=cfg, params=params,
                                          device=device, max_slots=2,
                                          max_len=96)
        try:
            tokens = [engine.generate_ids(p, max_new_tokens=new_tokens)
                      for p in PROMPTS]
        finally:
            engine.shutdown()
        batch = InferenceEngine('tiny-moe', cfg=cfg, params=params,
                                device=device, max_batch=4)
        tokens.append(batch.generate_ids(PROMPTS,
                                         max_new_tokens=new_tokens))
    finally:
        llama._route, decode.prefill_chunk = saved['route'], saved['chunk']
        decode.paged_verify_step = saved['verify']
        decode.prefill, decode.decode_step = saved['prefill'], saved['step']
    return tokens, calls


def neighbour_gap(torch, logits, k_top):
    """Smallest gap between neighbours of each row's top-(k+1) sorted
    logits: the margin that keeps its choices and their order."""
    top = torch.topk(logits, k_top + 1, dim=-1).values
    return (top[..., :-1] - top[..., 1:]).min(dim=-1).values


def compare(torch, cpu, card, k_top):
    """The first call whose choices differ and the readings before it."""
    out = dict(calls=len(cpu), calls_card=len(card), first_difference=None)
    worst = dict(real_logit_diff=0.0, pad_logit_diff=0.0,
                 real_prefill_gap=float('inf'),
                 pad_prefill_gap=float('inf'))
    for i, (a, b) in enumerate(zip(cpu, card)):
        if a['where'] != b['where'] or a['logits'].shape != b['logits'].shape:
            out['first_difference'] = dict(call=i, schedule=[
                a['where'], b['where'], list(a['logits'].shape),
                list(b['logits'].shape)])
            break
        diff = (a['logits'] - b['logits']).abs().amax(dim=-1)
        gap = torch.minimum(neighbour_gap(torch, a['logits'], k_top),
                            neighbour_gap(torch, b['logits'], k_top))
        pad = a['pad']
        differs = (a['selected'] != b['selected']).any(dim=-1)
        if differs.any():
            rows = []
            for idx in differs.nonzero().tolist()[:8]:
                idx = tuple(idx)
                rows.append(dict(
                    row=list(idx), padding=bool(pad[idx]),
                    gap_cpu=float(neighbour_gap(torch, a['logits'][idx],
                                                k_top)),
                    gap_card=float(neighbour_gap(torch, b['logits'][idx],
                                                 k_top)),
                    logit_diff=float(diff[idx]),
                    selected_cpu=a['selected'][idx].tolist(),
                    selected_card=b['selected'][idx].tolist()))
            out['first_difference'] = dict(
                call=i, where=a['where'], shape=list(a['logits'].shape),
                rows_differing=int(differs.sum()),
                padding_rows=int(pad.sum()), rows=rows,
                call_real_logit_diff=float(diff[~pad].max()) if (
                    ~pad).any() else None,
                call_pad_logit_diff=float(diff[pad].max()) if pad.any()
                else None)
            break
        for kind, mask in (('real', ~pad), ('pad', pad)):
            if not mask.any():
                continue
            worst[f'{kind}_logit_diff'] = max(worst[f'{kind}_logit_diff'],
                                              float(diff[mask].max()))
            if a['where'] in ('prefill_chunk', 'prefill'):
                worst[f'{kind}_prefill_gap'] = min(
                    worst[f'{kind}_prefill_gap'], float(gap[mask].min()))
    out['before_first_difference'] = worst
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--seeds', type=int, nargs='+', default=[7, 11])
    parser.add_argument('--capacity-factor', type=float, default=0.5)
    parser.add_argument('--new-tokens', type=int, default=8)
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print('moe_route_diff: no CUDA device', file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.models.config import get_model_config
    cfg = get_model_config('tiny-moe', head_dim=128,
                           compute_dtype=torch.float32,
                           moe_dispatch='capacity',
                           capacity_factor=args.capacity_factor)
    ok = True
    for seed in args.seeds:
        params = llama.init_params(seed, cfg, device='cpu')
        cpu_tokens, cpu_calls = record(torch, cfg, params, 'cpu',
                                       args.new_tokens)
        for run in (1, 2):
            tokens, calls = record(torch, cfg, params, 'cuda',
                                   args.new_tokens)
            report = compare(torch, cpu_calls, calls,
                             cfg.experts_per_token)
            same = tokens == cpu_tokens
            ok = ok and same
            print(json.dumps(dict(seed=seed, card_run=run,
                                  capacity_factor=args.capacity_factor,
                                  tokens_equal=same, **report)), flush=True)
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
