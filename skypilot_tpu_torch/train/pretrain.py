"""Pretraining entry point, on one card or over a mesh: the port of
``skypilot_tpu/train/pretrain.py``.

    python -m skypilot_tpu_torch.train.pretrain --model bench-1b7 \\
        --batch 8 --seq 2048 --steps 20
    python -m skypilot_tpu_torch.train.pretrain --model bench-1b7 \\
        --mesh fsdp=2
    python -m skypilot_tpu_torch.train.pretrain --model deepseek-moe-16b \\
        --mesh expert=2,fsdp=2
    python -m skypilot_tpu_torch.train.pretrain --model bench-1b7 \\
        --mesh stage=2
    python -m skypilot_tpu_torch.train.pretrain --model bench-1b7 \\
        --mesh stage=2,seq=2
    python -m skypilot_tpu_torch.train.pretrain --model bench-1b7 \\
        --optimizer adafactor --param-dtype bfloat16 --packed \\
        --data tokens.npy --eos-id 1 --checkpoint-dir ckpt
    python -m skypilot_tpu_torch.train.pretrain --model tiny --device cpu

Runs on the GPU unless ``--device cpu`` is given. Emits one JSON line per
--log-every steps:
    {"step": N, "loss": x, "tokens_per_sec": y, "achieved_tflops": z}
and ``{"done": true, "final_step": N}`` at the end.

``--checkpoint-dir`` restores the newest committed step (printing
``{"resumed_from_step": n}``) and saves every ``--checkpoint-every``
steps, at the last step, and before a resize exit
(``train/checkpoint.py``). ``--packed`` packs the EOS-delimited
documents of ``--data`` (``data/packer.py``; on the card the native
packer must build) and counts only the real tokens (the weights) in
tokens/s. ``--moe-dispatch`` / ``--capacity-factor`` set a MoE
model's dispatch (``--model tiny-moe --moe-dispatch capacity``).

``--mesh`` (``data``, ``stage``, ``fsdp``, ``seq``, ``expert``,
``tensor``; ``train/step.py``)
takes one process per rank: run as a command, it starts its own ranks
(``parallel/launch.py``; ``gloo`` when they share a card), each of which
runs this same ``main`` inside the process group. The degrees multiply
to the rank count; a -1 axis takes the GPUs the others leave (1 on the
CPU). As in the reference, ``SKYT_ELASTIC_SLICES`` re-solves the mesh's
DCN axes (``MeshConfig.resolve``), the batch rounds up to data x fsdp
(``{"batch_rounded_to": n}``) and the sequence up to seq, on the card
up to 64 x seq for the ring's kernels (the reference rounds to seq,
silently; here ``{"seq_rounded_to": n}``), a packed
batch is cut into each rank's rows and columns, a resume prints
``{"mesh_devices": n, ...}``, only rank 0 prints, checkpoints hold
whole tensors (rank 0 writes them) and restore into any mesh, and a
resize request is rank 0's decision, broadcast, so that every rank
stops at the same step. ``expert`` splits each MoE layer's experts and
not the batch (a dense model trains on its ranks as replicas, as in the
reference). ``stage`` splits the layers into a GPipe pipeline
(``parallel/pipeline.py``; the loss is the last stage's): the layers
and a rank's rows of the batch must divide over the stages and the
default microbatches, and ``--packed`` raises there, as in the
reference. A MoE model under ``seq`` claims capacity over the global
sequence, as the reference's groups span it. ``stage`` combines with
``seq`` (ring or Ulysses attention inside each stage) and with
``expert`` (each stage's MoE layers over its expert ranks):
``--mesh stage=2,seq=2``, ``--model tiny-moe --mesh stage=2,expert=2``.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from typing import Dict, Iterator, Optional

import numpy as np
import torch


def parse_mesh(spec: Optional[str]) -> Dict[str, int]:
    """'fsdp=-1,tensor=2' -> {'fsdp': -1, 'tensor': 2}."""
    if not spec:
        return {'fsdp': -1}
    out: Dict[str, int] = {}
    for part in spec.split(','):
        key, _, value = part.partition('=')
        out[key.strip()] = int(value)
    return out


def mesh_ranks(config, device_type: str) -> int:
    """The ranks a ``MeshConfig`` takes: the product of its degrees, a -1
    axis taking the GPUs the others leave (at least 1; 1 on the CPU)."""
    sizes = config.axis_sizes()
    known = math.prod(n for n in sizes if n != -1)
    if -1 not in sizes:
        return known
    count = torch.cuda.device_count() if device_type == 'cuda' else 1
    return known * max(1, count // known)


def training_mesh(spec: Optional[str], cfg, device_type: str,
                  batch: Optional[int] = None):
    """(mesh config resolved for its ranks, rank count) of ``--mesh``
    under ``SKYT_ELASTIC_SLICES``; what the slice does not train on
    raises here, before any rank starts (with ``batch``, also a batch
    the pipeline's microbatches do not divide, once rounded up to data
    x fsdp)."""
    from skypilot_tpu_torch.parallel.mesh import MESH_AXIS_NAMES, MeshConfig
    from skypilot_tpu_torch.train.step import check_training_mesh
    config = MeshConfig(**parse_mesh(spec))
    slices = os.environ.get('SKYT_ELASTIC_SLICES')
    if slices:
        # The recipe's mesh describes the FULL gang; the DCN axes
        # re-solve for the surviving slice count.
        config = config.with_num_slices(int(slices))
    world = mesh_ranks(config, device_type)
    config = config.resolve(world)
    if world > 1:
        if batch is not None:
            div = config.data * config.fsdp
            batch = -(-batch // div) * div
        check_training_mesh(dict(zip(MESH_AXIS_NAMES, config.axis_sizes())),
                            cfg, batch)
    return config, world


def is_launched() -> bool:
    """True inside a rank of a process group (``parallel/launch.py``)."""
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def rank_decides(flag: bool, device: torch.device) -> bool:
    """Rank 0's ``flag`` on every rank (one broadcast; the flag itself
    off a process group)."""
    if not is_launched():
        return flag
    import torch.distributed as dist
    t = torch.tensor([int(flag)], device=device)
    dist.broadcast(t, src=0)
    return bool(t.item())


def _rank_main(rank: int, world: int, entry, argv) -> int:
    del rank, world
    return entry(argv)


def start_ranks(entry, argv, spec: Optional[str], cfg,
                device_type: str, batch: Optional[int] = None
                ) -> Optional[int]:
    """Rank 0's exit code of ``entry(argv)`` run on the ranks that
    ``--mesh spec`` takes, started here (``parallel/launch.py``) when
    they are more than one and this process is not one of them; None
    when this process trains itself. ``batch``: the global batch, held
    to the pipeline's microbatches before the ranks start."""
    if is_launched():
        return None
    _, world = training_mesh(spec, cfg, device_type, batch)
    if world == 1:
        return None
    from skypilot_tpu_torch.parallel.launch import launch
    return launch(_rank_main, world, entry, argv, device=device_type)[0]


def enter_mesh(args: argparse.Namespace, cfg, device: torch.device):
    """(resolved ``MeshConfig``, mesh or None for one rank, whether this
    rank prints) of ``args.mesh`` inside a launched rank. The batch
    rounds up to data x fsdp, so every batch shard is non-empty (rank 0
    prints ``{"batch_rounded_to": n}``)."""
    from skypilot_tpu_torch.parallel.mesh import build_mesh
    mesh_config, world = training_mesh(args.mesh, cfg, device.type)
    if world == 1:
        return mesh_config, None, True
    if not is_launched():
        raise RuntimeError(f'--mesh {args.mesh} takes {world} ranks: run '
                           'the command (main), which starts them')
    import torch.distributed as dist
    if dist.get_world_size() != world:
        raise ValueError(f'mesh {args.mesh!r} takes {world} ranks, the '
                         f'process group has {dist.get_world_size()}')
    mesh = build_mesh(mesh_config, device_type=device.type)
    is_main = dist.get_rank() == 0
    batch_div = mesh.shape['data'] * mesh.shape['fsdp']
    batch = -(-args.batch // batch_div) * batch_div
    if batch != args.batch and is_main:
        print(json.dumps({'batch_rounded_to': batch}), flush=True)
    args.batch = batch
    return mesh_config, mesh, is_main


# Columns of a ring attention block must be a multiple of this on the
# card: the flash kernels' row tile (``ops/flash_attention.py``).
RING_BLOCK_COLUMNS = 64


def mesh_seq(seq: int, mesh, is_main: bool) -> int:
    """``seq`` rounded up to a multiple of the mesh's ``seq`` degree n, so
    that every rank's block of columns is non-empty, and on CUDA ranks
    with n > 1 to a multiple of 64 n, so that every ring block is on the
    flash kernels' grid (rank 0 prints ``{"seq_rounded_to": n}`` when it
    changes)."""
    div = 1 if mesh is None else mesh.shape['seq']
    if div > 1 and mesh.device_type == 'cuda':
        div *= RING_BLOCK_COLUMNS
    rounded = -(-seq // div) * div
    if rounded != seq and is_main:
        print(json.dumps({'seq_rounded_to': rounded}), flush=True)
    return rounded


def synthetic_batch(step: int, batch: int, seq: int, vocab_size: int,
                    device: Optional[torch.device] = None
                    ) -> Dict[str, torch.Tensor]:
    """Deterministic synthetic LM data: every other token repeats its
    left neighbour, so a real model drives loss well below uniform
    entropy. Drawn from a CPU ``torch.Generator`` seeded by ``step`` (the
    same batch on every device; the draws differ from jax.random's)."""
    gen = torch.Generator().manual_seed(step)
    base = torch.randint(0, vocab_size, (batch, seq), generator=gen,
                         dtype=torch.int32)
    repeat = torch.roll(base, 1, dims=1)
    mask = (torch.arange(seq) % 2).bool()
    tokens = torch.where(mask[None, :], repeat, base)
    return {
        'tokens': tokens.to(device),
        'targets': torch.roll(tokens, -1, dims=1).to(device),
        'weights': torch.ones((batch, seq), dtype=torch.float32,
                              device=device),
    }


def file_batch_iterator(path: str, batch: int, seq: int,
                        device: Optional[torch.device] = None
                        ) -> Iterator[Dict[str, torch.Tensor]]:
    """Stream batches from a flat .npy/int32 token file (memmapped)."""
    data = np.load(os.path.expanduser(path), mmap_mode='r')
    tokens_per_batch = batch * (seq + 1)
    offset = 0
    while True:
        if offset + tokens_per_batch > data.shape[0]:
            offset = 0
        chunk = np.asarray(
            data[offset:offset + tokens_per_batch]).reshape(batch, seq + 1)
        offset += tokens_per_batch
        chunk = torch.from_numpy(chunk.astype(np.int32))
        yield {
            'tokens': chunk[:, :-1].contiguous().to(device),
            'targets': chunk[:, 1:].contiguous().to(device),
            'weights': torch.ones((batch, seq), dtype=torch.float32,
                                  device=device),
        }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument('--model', default='tiny')
    parser.add_argument('--steps', type=int, default=20)
    parser.add_argument('--batch', type=int, default=4)
    parser.add_argument('--seq', type=int, default=None)
    parser.add_argument('--learning-rate', type=float, default=3e-4)
    parser.add_argument('--warmup-steps', type=int, default=10)
    parser.add_argument('--optimizer', default='adamw',
                        choices=['adamw', 'adafactor'])
    parser.add_argument('--mesh', default=None,
                        help="e.g. 'fsdp=2', 'tensor=2', 'stage=2', "
                             "'expert=2,fsdp=2', 'data=2,fsdp=-1' "
                             "(default fsdp=-1)")
    parser.add_argument('--data', default='synthetic',
                        help="'synthetic' or a flat token .npy file")
    parser.add_argument('--packed', action='store_true', default=False,
                        help='Pack EOS-delimited documents from --data '
                             'into padding-free batches (native C++ '
                             'packer; segment-masked attention).')
    parser.add_argument('--eos-id', type=int, default=1,
                        help='Document delimiter token for --packed.')
    parser.add_argument('--checkpoint-dir', default=None)
    parser.add_argument('--checkpoint-every', type=int, default=50)
    parser.add_argument('--log-every', type=int, default=10)
    parser.add_argument('--param-dtype', default=None,
                        choices=[None, 'float32', 'bfloat16'])
    parser.add_argument('--remat-policy', default=None,
                        choices=[None, 'none', 'dots', 'save_attn',
                                 'save_dots', 'full'],
                        help='activation remat: full = least memory; '
                             'save_attn/save_dots trade memory for '
                             'less recompute (models/llama.py).')
    parser.add_argument('--moe-dispatch', default=None,
                        choices=[None, 'dense', 'capacity'])
    parser.add_argument('--capacity-factor', type=float, default=None)
    parser.add_argument('--device', default=None,
                        help="'cuda' (default) or 'cpu'")
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parser.parse_args(argv)

    from skypilot_tpu_torch.models.config import get_model_config
    from skypilot_tpu_torch.train import checkpoint as ckpt_lib
    from skypilot_tpu_torch.train.step import (TrainHParams,
                                               create_train_state,
                                               make_train_step,
                                               resize_requested,
                                               state_shardings)
    from skypilot_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    overrides = {}
    if args.param_dtype:
        overrides['param_dtype'] = getattr(torch, args.param_dtype)
    if args.remat_policy:
        overrides['remat_policy'] = args.remat_policy
    if args.moe_dispatch:
        overrides['moe_dispatch'] = args.moe_dispatch
    if args.capacity_factor is not None:
        overrides['capacity_factor'] = args.capacity_factor
    cfg = get_model_config(args.model, **overrides)
    if args.packed and parse_mesh(args.mesh).get('stage', 1) > 1:
        from skypilot_tpu_torch.models.llama import PACKED_UNDER_STAGES
        raise ValueError(PACKED_UNDER_STAGES)
    code = start_ranks(main, argv, args.mesh, cfg, device.type, args.batch)
    if code is not None:
        return code
    mesh_config, mesh, is_main = enter_mesh(args, cfg, device)
    seq = mesh_seq(min(args.seq or 1024, cfg.max_seq_len), mesh, is_main)
    hp = TrainHParams(learning_rate=args.learning_rate,
                      warmup_steps=args.warmup_steps,
                      total_steps=max(args.steps, args.warmup_steps + 1),
                      optimizer=args.optimizer)
    state = create_train_state(0, cfg, hp, mesh, device=device)
    shardings = None if mesh is None else state_shardings(mesh, cfg, hp)
    start_step = 0
    if args.checkpoint_dir:
        latest = ckpt_lib.latest_step(args.checkpoint_dir)
        if latest is not None:
            # Any mesh restores a checkpoint of any other: the files
            # hold whole tensors, each rank reads its blocks.
            state = ckpt_lib.restore(args.checkpoint_dir, latest, state,
                                     shardings=shardings)
            start_step = state.step
            if is_main:
                print(json.dumps({'resumed_from_step': start_step}),
                      flush=True)
                print(json.dumps({'mesh_devices': mesh_config.num_devices,
                                  'num_slices': mesh_config.num_slices}),
                      flush=True)
    step_fn = make_train_step(cfg, hp, mesh)

    if args.data == 'synthetic':
        data_iter = None
    elif args.packed:
        from skypilot_tpu_torch.data.packer import packed_batch_iterator
        data_iter = packed_batch_iterator(
            args.data, batch=args.batch, seq=seq, eos_id=args.eos_id,
            require_native=device.type == 'cuda')
    else:
        data_iter = file_batch_iterator(args.data, args.batch, seq, device)
    flops_per_token = cfg.flops_per_token(seq)
    window_t0 = time.perf_counter()
    window_tokens = 0.0
    for step in range(start_step, args.steps):
        if data_iter is not None:
            batch = next(data_iter)
        else:
            batch = synthetic_batch(step, args.batch, seq, cfg.vocab_size,
                                    device)
        # REAL tokens, not grid cells: packed batches (host numpy) carry
        # padding with weight 0, which must not count in throughput.
        weights = batch['weights']
        if isinstance(weights, np.ndarray):
            real_tokens = float(weights.sum())
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in batch.items()}
        else:
            real_tokens = args.batch * seq
        state, metrics = step_fn(state, batch)
        window_tokens += real_tokens
        if (step + 1) % args.log_every == 0 or step + 1 == args.steps:
            loss = float(metrics['loss'])  # sync point
            elapsed = time.perf_counter() - window_t0
            tps = window_tokens / max(elapsed, 1e-9)
            if is_main:
                print(json.dumps({
                    'step': step + 1,
                    'loss': round(loss, 4),
                    'tokens_per_sec': round(tps, 1),
                    'achieved_tflops': round(tps * flops_per_token / 1e12,
                                             2),
                }), flush=True)
            window_t0 = time.perf_counter()
            window_tokens = 0.0
        saved_this_step = bool(args.checkpoint_dir) and (
            (step + 1) % args.checkpoint_every == 0 or
            step + 1 == args.steps)
        if saved_this_step:
            ckpt_lib.save(args.checkpoint_dir, step + 1, state,
                          shardings=shardings)
        if rank_decides(resize_requested(), device):
            # A step boundary is the only resize-safe point: params and
            # optimizer state are consistent. Checkpoint, then exit 0.
            if args.checkpoint_dir and not saved_this_step:
                ckpt_lib.save(args.checkpoint_dir, step + 1, state,
                              shardings=shardings)
            if is_main:
                print(json.dumps({'resize_exit_at_step': step + 1}),
                      flush=True)
            return 0
    if is_main:
        print(json.dumps({'done': True, 'final_step': args.steps}),
              flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
