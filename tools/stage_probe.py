#!/usr/bin/env python3
"""Where a pipeline-parallel train step spends its time, on one GPU.

    python3 tools/stage_probe.py

Starts two ranks on the card (``parallel/launch.py``: two ranks on one
device, so ``gloo``) and trains ``chip_smoke.py``'s bench-1b7 at full
width and 2 layers at ``--mesh stage=2`` through ``train.pretrain.main``
(phase 36's arguments), twice, 2 steps each, then once at ``--mesh
fsdp=2``. Each rank times, the card synchronized before and after, each
call of the pipeline's forward and backward (``llama.pipeline_grads``),
of the stage handoffs' receives (``TensorParallel.recv_from``), of the
embedding and the head, of the gradient sums (``train/step._sum_grads``,
``_stage_sum``) and of the AdamW update, and prints per rank and run
its steps' seconds and peak memory, then the timed calls in order. The
first run's first step pays the ranks' warm-up; the second run's does
not.
"""
from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def rank_fn(rank, world, runs):
    """``chip_smoke.mesh_train_rank`` with the sections timed."""
    import torch
    import chip_smoke
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.parallel import sharding
    from skypilot_tpu_torch.train import step as tstep
    times = []

    def timed(name, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            times.append((name, round(time.perf_counter() - t0, 3)))
            return out
        return run

    llama.pipeline_grads = timed('pipeline_grads', llama.pipeline_grads)
    llama._embed = timed('embed', llama._embed)
    llama._final = timed('final', llama._final)
    tstep._sum_grads = timed('sum_grads', tstep._sum_grads)
    tstep._stage_sum = timed('stage_sum', tstep._stage_sum)
    tstep.AdamW.update_ = timed('adamw', tstep.AdamW.update_)
    sharding.TensorParallel.recv_from = timed(
        'recv', sharding.TensorParallel.recv_from)
    out = chip_smoke.mesh_train_rank(rank, world, runs)
    out['times'] = times
    return out


def main() -> int:
    import torch
    import chip_smoke
    from skypilot_tpu_torch import _build
    from skypilot_tpu_torch.parallel.launch import launch
    if not torch.cuda.is_available():
        print('stage_probe: no CUDA device available', file=sys.stderr)
        return 1
    _build.build_all()
    chip_smoke.register_mesh_model()
    print(chip_smoke.nvidia_smi_line(), flush=True)
    steps = ['--steps', '2']
    runs = [('stage=2 first', chip_smoke.STAGE_ARGV + steps, None),
            ('stage=2 again', chip_smoke.STAGE_ARGV + steps, None),
            ('fsdp=2', chip_smoke.MESH_ARGV + steps + ['--mesh', 'fsdp=2'],
             None)]
    t0 = time.perf_counter()
    ranks = launch(rank_fn, 2, runs, device='cuda')
    print(f'launch {time.perf_counter() - t0:.1f} s', flush=True)
    for r in ranks:
        print(f'rank {r["rank"]}')
        for label, run in r['runs'].items():
            print(f'  {label}: run {run["wall_s"]:.2f} s, steps '
                  f'{[round(x["wall_s"], 3) for x in run["steps"]]} s, '
                  f'peak {run["peak_gb"]:.2f} GB')
        print(f'  timed calls {r["times"]}', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
