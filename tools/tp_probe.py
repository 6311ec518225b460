#!/usr/bin/env python3
"""Probe the tensor-parallel serving path on one GPU, two ranks.

    python3 tools/tp_probe.py

Starts two ranks on the card (``parallel/launch.py``: two ranks on one
device, so ``gloo``) and prints one JSON line per rank:

* which collectives ``gloo`` takes on CUDA tensors of each dtype the
  tensor-parallel step uses (all-reduce sum and max, broadcast), and
  whether the result is right;
* whether a ``DeviceMesh`` over the two ranks builds on ``cuda``;
* the greedy tokens of both engines under ``mesh='tensor=2'`` at TINY
  (4 query and 2 kv heads, head_dim 128, fp32 compute) and of the same
  engines on one rank, with each rank's kernel launch counts.

Exits non-zero when a collective fails or the tokens differ.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

PROMPTS = [[5, 6, 7, 8], [9, 10, 9, 10, 9, 10, 9, 10, 9]]


def _collectives(torch, dist, rank):
    out = {}
    dev = torch.device('cuda', torch.cuda.current_device())
    for dtype in (torch.float32, torch.bfloat16, torch.int32, torch.int64):
        for op in ('sum', 'max', 'broadcast'):
            x = torch.full((4096,), rank + 1, dtype=dtype, device=dev)
            want = {'sum': 3, 'max': 2, 'broadcast': 1}[op]
            try:
                if op == 'broadcast':
                    dist.broadcast(x, src=0)
                else:
                    dist.all_reduce(x, op=(dist.ReduceOp.SUM if op == 'sum'
                                           else dist.ReduceOp.MAX))
                torch.cuda.synchronize()
                got = bool((x.float() == want).all().item())
            except Exception as e:  # reported, then fails the probe
                got = f'{type(e).__name__}: {e}'[:200]
            out[f'{op} {str(dtype)[6:]}'] = got
    return out


def _engines(torch, mesh):
    from skypilot_tpu_torch.inference.continuous import (
        ContinuousBatchingEngine)
    from skypilot_tpu_torch.inference.engine import InferenceEngine
    from skypilot_tpu_torch.models.config import get_model_config
    from skypilot_tpu_torch.ops import decode_attention as da
    from skypilot_tpu_torch.ops import paged_attention as pa
    cfg = get_model_config('tiny', n_heads=4, n_kv_heads=2, head_dim=128,
                           compute_dtype=torch.float32)
    out = {}
    pa.reset_launch_counts()
    da.reset_launch_counts()
    batch = InferenceEngine(cfg=cfg, seed=0, mesh=mesh, max_batch=2)
    cont = ContinuousBatchingEngine(cfg=cfg, seed=0, mesh=mesh, max_slots=2,
                                    max_len=64)
    for name, engine in (('batch', batch), ('continuous', cont)):
        if not engine.is_driver:
            engine.follow()
            continue
        if name == 'batch':
            out[name] = engine.generate_ids(PROMPTS, max_new_tokens=6)
        else:
            out[name] = [engine.generate_ids(p, max_new_tokens=6)
                         for p in PROMPTS]
        engine.shutdown()
    out['launches'] = {**dict(pa.LAUNCHES), **dict(da.LAUNCHES)}
    return out


def rank_main(rank, world):
    import torch
    import torch.distributed as dist
    from skypilot_tpu_torch.parallel.mesh import build_mesh, MeshConfig
    result = {'rank': rank, 'device': str(torch.cuda.current_device()),
              'backend': dist.get_backend(),
              'collectives': _collectives(torch, dist, rank)}
    mesh = build_mesh(MeshConfig(fsdp=1, tensor=world), device_type='cuda')
    result['device_mesh'] = str(mesh.device_mesh)
    result['tp'] = _engines(torch, 'tensor=2')
    return result


def main() -> int:
    import torch
    from skypilot_tpu_torch import _build
    from skypilot_tpu_torch.parallel.launch import launch
    print(subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=False).stdout.strip(), flush=True)
    _build.build_all()
    ranks = launch(rank_main, 2, device='cuda')
    single = _engines(torch, None)
    ok = True
    for r in ranks:
        print(json.dumps(r), flush=True)
        ok &= all(v is True for v in r['collectives'].values())
    print(json.dumps({'single': single}), flush=True)
    tp = ranks[0]['tp']
    for name in ('batch', 'continuous'):
        same = tp[name] == single[name]
        print(f'{name}: tensor=2 tokens {"==" if same else "!="} one rank',
              flush=True)
        ok &= same
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
