#!/usr/bin/env python3
"""Probe the collectives of mesh training on one GPU, two ranks.

    python3 tools/train_mesh_probe.py

Starts two ranks on the card (``parallel/launch.py``: two ranks on one
device, so ``gloo``) and prints one JSON line per rank: for each
collective the sharded train step may use (all-gather into a tensor,
reduce-scatter of a tensor and of a list, all-reduce, all-to-all), on
CUDA tensors of fp32 and bf16, whether ``gloo`` takes it and gives the
right result; then the median time of each that works at 1, 16 and 64
MB (the card synchronized before and after each call). Then the ring
hop of sequence-parallel attention, ``TensorParallel.ring_shift`` (which
stages CUDA tensors through host memory under gloo: gloo's send and
receive move host memory), exact and timed at the same sizes. Exits
non-zero when the rank launch fails; a collective that ``gloo`` refuses
is reported, not an error.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

OPS = ('all_gather_into_tensor', 'reduce_scatter_tensor', 'reduce_scatter',
       'all_reduce', 'all_to_all_single')


def _call(torch, dist, op, x, world):
    """Run ``op`` on ``x`` (this rank's input); returns the output."""
    n = x.numel()
    if op == 'all_gather_into_tensor':
        out = x.new_empty(n * world)
        dist.all_gather_into_tensor(out, x)
    elif op == 'reduce_scatter_tensor':
        out = x.new_empty(n // world)
        dist.reduce_scatter_tensor(out, x)
    elif op == 'reduce_scatter':
        out = x.new_empty(n // world)
        dist.reduce_scatter(out, list(x.chunk(world)))
    elif op == 'all_reduce':
        out = x.clone()
        dist.all_reduce(out)
    else:
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x)
    return out


def _expected(torch, op, rank, world, n, dtype, dev):
    """What ``op`` must give when rank r's input is arange(n) + 1000 r."""
    ins = [torch.arange(n, device=dev).to(dtype) + 1000 * r
           for r in range(world)]
    if op == 'all_gather_into_tensor':
        return torch.cat(ins)
    if op in ('reduce_scatter_tensor', 'reduce_scatter'):
        return sum(x.float() for x in ins).to(dtype).chunk(world)[rank]
    if op == 'all_reduce':
        return sum(x.float() for x in ins).to(dtype)
    return torch.cat([x.chunk(world)[rank] for x in ins])


def rank_main(rank, world):
    import torch
    import torch.distributed as dist
    dev = torch.device('cuda', torch.cuda.current_device())
    result = {'rank': rank, 'backend': dist.get_backend(), 'works': {},
              'ms': {}}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        for op in OPS:
            x = torch.arange(64, device=dev).to(dtype) + 1000 * rank
            try:
                got = _call(torch, dist, op, x, world)
                torch.cuda.synchronize()
                want = _expected(torch, op, rank, world, 64, dtype, dev)
                ok = bool(torch.equal(got, want))
            except Exception as e:  # reported: gloo refuses it
                ok = f'{type(e).__name__}: {e}'[:160]
            result['works'][f'{op} {name}'] = ok
    from skypilot_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from skypilot_tpu_torch.parallel.sharding import tensor_parallel_of
    par = tensor_parallel_of(build_mesh(MeshConfig(fsdp=1, seq=world),
                                        device_type='cuda'))
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.arange(64, device=dev).to(dtype) + 1000 * rank
        got = par.ring_shift([x])[0]
        want = torch.arange(64, device=dev).to(dtype) + 1000 * (
            (rank - 1) % world)
        result['works'][f'ring_shift {str(dtype)[6:]}'] = bool(
            got.is_cuda and torch.equal(got, want))
    for mb in (1, 16, 64):
        x = torch.randn(mb * 2 ** 19, device=dev).to(torch.bfloat16)
        times = []
        for _ in range(6):
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            par.ring_shift([x])
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        result['ms'][f'ring_shift bf16 {mb} MB'] = round(
            statistics.median(times[1:]), 3)
    for op in OPS:
        if result['works'][f'{op} bfloat16'] is not True:
            continue
        for mb in (1, 16, 64):
            x = torch.randn(mb * 2 ** 19, device=dev).to(torch.bfloat16)
            times = []
            for _ in range(6):
                torch.cuda.synchronize()
                dist.barrier()
                t0 = time.perf_counter()
                _call(torch, dist, op, x, world)
                torch.cuda.synchronize()
                times.append(1e3 * (time.perf_counter() - t0))
            result['ms'][f'{op} bf16 {mb} MB'] = round(
                statistics.median(times[1:]), 3)
    return result


def main() -> int:
    from skypilot_tpu_torch.parallel.launch import launch
    print(subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=False).stdout.strip(), flush=True)
    for r in launch(rank_main, 2, device='cuda'):
        print(json.dumps(r), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
