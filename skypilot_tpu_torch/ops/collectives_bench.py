"""Collective microbenchmark (the nccl-tests equivalent): the port of
``skypilot_tpu/ops/collectives_bench.py``.

    python -m skypilot_tpu_torch.ops.collectives_bench --op all_reduce \\
        --size-mb 64 [--device cpu]

Starts one rank per GPU, at least 2 (2 on the CPU; ``parallel/launch.py``) on a one-axis mesh ``('x',)`` of the port's
``Mesh`` and times ``torch.distributed``'s collectives over it. One
JSON line per op: algbw (payload / time) and busbw (algbw times the
ring-traffic factor of nccl-tests: 2(n-1)/n for all-reduce, (n-1)/n
for all-gather and reduce-scatter), as the reference reports them.

The process-group backend follows the launcher's rule, and the line
says which (``detail.backend``, ``detail.path``): ranks that share one
card talk over ``gloo``, which moves a CUDA tensor's bytes through host
memory; that is the path the tensor-parallel serving step takes on
such a machine, not NVLink or NCCL bandwidth. ``gloo`` reduces CUDA
tensors in place but gathers and scatters only host tensors, so those
two ops stage through host memory explicitly, inside the timed loop.
``ppermute`` belongs to the training half of the multi-device work
(ROADMAP.md, queue A item 15 (b)).
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

OPS = ('all_reduce', 'all_gather', 'reduce_scatter')


def _bus_factor(op: str, n: int) -> float:
    if n <= 1:
        return 1.0
    if op == 'all_reduce':
        return 2 * (n - 1) / n
    if op in ('all_gather', 'reduce_scatter'):
        return (n - 1) / n
    return 1.0


def _collective(op: str, x: torch.Tensor, group, n: int, staged: bool):
    """One call of ``op`` on this rank's shard ``x``; ``staged``: copy
    through host memory (gloo's gathers take host tensors only)."""
    import torch.distributed as dist
    if op == 'all_reduce':
        dist.all_reduce(x, group=group)
        return x
    src = x.cpu() if staged else x
    if op == 'all_gather':
        out = src.new_empty(src.numel() * n)
        dist.all_gather_into_tensor(out, src, group=group)
    else:
        out = src.new_empty(src.numel() // n)
        dist.reduce_scatter_tensor(out, src, group=group)
    return out.to(x.device) if staged else out


def _rank_bench(rank: int, world: int, ops, size_mb: float, iters: int,
                warmup: int, device_type: str):
    import torch.distributed as dist
    from skypilot_tpu_torch.parallel.launch import rank_device
    from skypilot_tpu_torch.parallel.mesh import Mesh
    mesh = Mesh(np.arange(world), ('x',), device_type)
    group = mesh.group('x')
    device = rank_device(rank, device_type)
    backend = dist.get_backend(group)
    staged = backend == 'gloo' and device.type == 'cuda'
    elems = int(size_mb * 1e6 / 4)
    elems -= elems % (world * world)
    lines = []
    for op in ops:
        # The reference's layout: the payload is sharded over the ranks.
        x = torch.arange(elems // world, dtype=torch.float32,
                         device=device)
        for _ in range(max(warmup, 1)):
            _collective(op, x, group, world, staged and op != 'all_reduce')
        if device.type == 'cuda':
            torch.cuda.synchronize(device)
        dist.barrier(group=group)
        t0 = time.perf_counter()
        for _ in range(iters):
            _collective(op, x, group, world, staged and op != 'all_reduce')
        if device.type == 'cuda':
            torch.cuda.synchronize(device)
        elapsed = time.perf_counter() - t0
        payload_bytes = elems * 4
        algbw = payload_bytes * iters / elapsed / 1e9
        kind = (torch.cuda.get_device_name(device) if device.type == 'cuda'
                else 'cpu')
        lines.append({
            'metric': f'collective_{op}_{world}dev',
            'value': round(algbw * _bus_factor(op, world), 3),
            'unit': 'GB/s busbw',
            'detail': {
                'algbw_gbps': round(algbw, 3),
                'payload_mb': round(payload_bytes / 1e6, 1),
                'iters': iters,
                'devices': world,
                'device_kind': kind,
                'backend': backend,
                'path': ('gloo through host memory' if staged or
                         device.type == 'cpu' else backend),
            },
        })
    return lines if rank == 0 else None


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument('--op', default='all_reduce',
                        choices=list(OPS) + ['all'])
    parser.add_argument('--size-mb', type=float, default=64)
    parser.add_argument('--iters', type=int, default=20)
    parser.add_argument('--warmup', type=int, default=3)
    parser.add_argument('--device', default=None,
                        help="'cpu' runs the ranks on the CPU (default: "
                             'the GPUs).')
    args = parser.parse_args(argv)
    from skypilot_tpu_torch.parallel.launch import launch
    from skypilot_tpu_torch.utils.device import resolve_device
    device = resolve_device(args.device)
    world = max(2, torch.cuda.device_count() if device.type == 'cuda'
                else 2)
    ops = list(OPS) if args.op == 'all' else [args.op]
    lines = launch(_rank_bench, world, ops, args.size_mb, args.iters,
                   args.warmup, device.type, device=device.type)[0]
    for line in lines:
        print(json.dumps(line), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
