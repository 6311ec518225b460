"""Finetuning: a real checkpoint in, a real checkpoint out. The port of
``skypilot_tpu/train/finetune.py``, with its flags, defaults and JSON
lines::

    python -m skypilot_tpu_torch.train.finetune \\
        --hf-checkpoint /ckpts/Meta-Llama-3.1-8B --data corpus.txt \\
        --lora-rank 16 --steps 200 --export-dir /ckpts/my-ft \\
        [--adapter-export-dir REG --adapter-name NAME] \\
        [--checkpoint-dir DIR] [--device cpu]

The checkpoint loads through ``models/hf_interop.py``, text tokenizes
with the checkpoint's own BPE (``inference/tokenizer.py``), and the
result exports back to HF layout (LoRA adapters merged into the dense
weights), servable by the port's engines or anything else that reads
Llama safetensors.

Two modes (the CPU with ``--device cpu``):

* **full** (``--lora-rank 0``): every parameter trains in fp32 with the
  pretrain step (``train/step.py``: AdamW with global-norm clipping and
  the reference's warmup-cosine schedule, warmup ``min(10, steps)``).
  ``--mesh`` trains over ``data``/``stage``/``fsdp``/``seq``/
  ``expert``/``tensor`` as ``pretrain`` does (``stage=2,seq=2``,
  ``stage=2,expert=2`` too): the command starts its own ranks, each
  loads the checkpoint and keeps its blocks, the batch rounds up to
  data x fsdp and the sequence up to seq, only rank 0 prints, and the
  export holds the whole (gathered) weights.
* **LoRA** (``--lora-rank R``): the base weights are frozen in bf16 with
  no optimizer state; the q/v adapters train in fp32 under the
  reference's plain ``optax.adamw(lr)``: no clipping, no schedule,
  betas (0.9, 0.999), eps 1e-8, weight decay 1e-4. ``--mesh`` is
  ignored with a warning line, as in the reference.

``--checkpoint-dir`` restores the newest committed step (printing
``{"resumed_from_step": n}``), skips the batches that step consumed, and
saves every ``--checkpoint-every`` steps and at the last
(``train/checkpoint.py``): a resumed run trains on what an
uninterrupted one would. ``--adapter-export-dir``
also commits the unmerged adapter under that registry root
(``serve/adapter_registry.py``), pinned to the base checkpoint's digest.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch

from skypilot_tpu_torch.train.step import (AdamW, TrainHParams, _leaves,
                                           plain_adamw)


def text_batch_iterator(path: str, tokenizer, batch: int, seq: int,
                        device: Optional[torch.device] = None
                        ) -> Iterator[Dict[str, torch.Tensor]]:
    """Tokenize a text file (one document per line) into a contiguous
    stream and cut [batch, seq] LM batches, cycling at EOF."""
    ids: List[int] = []
    with open(os.path.expanduser(path), encoding='utf-8') as f:
        for line in f:
            line = line.strip()
            if line:
                ids.extend(tokenizer.encode(line, add_bos=True))
                ids.append(tokenizer.eos_id)
    if not ids:
        raise ValueError(f'corpus {path} is empty (no non-blank lines)')
    if len(ids) < batch * (seq + 1):
        # Small corpora: tile so a batch always fills.
        reps = -(-batch * (seq + 1) // len(ids))
        ids = ids * reps
    data = np.asarray(ids, np.int32)
    per_batch = batch * (seq + 1)
    offset = 0
    while True:
        if offset + per_batch > data.shape[0]:
            offset = 0
        chunk = torch.from_numpy(
            data[offset:offset + per_batch].reshape(batch, seq + 1))
        offset += per_batch
        yield {
            'tokens': chunk[:, :-1].contiguous().to(device),
            'targets': chunk[:, 1:].contiguous().to(device),
            'weights': torch.ones((batch, seq), dtype=torch.float32,
                                  device=device),
        }


def skip_batches(data_iter: Iterator[Any], n: int) -> None:
    """Advance past the ``n`` batches a resumed run already trained on,
    so that it sees the batches an uninterrupted run would (the
    reference's finetune restarts its iterator at the first batch)."""
    for _ in range(n):
        next(data_iter)


def make_lora_step(base_params, cfg, optimizer: AdamW):
    """A LoRA step: gradients ONLY into the adapter tree (updated in
    place); the frozen base takes no gradient and has no optimizer
    state. Returns (adapter, optimizer state, loss)."""
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.models import lora as lora_lib
    from skypilot_tpu_torch.train.loss import cross_entropy_loss

    def step(lora_params, opt_state, batch):
        params = lora_lib.attach(base_params, lora_params)
        logits = llama.forward(params, batch['tokens'], cfg)
        loss, _ = cross_entropy_loss(logits, batch['targets'],
                                     batch.get('weights'))
        del logits
        grads = torch.autograd.grad(loss, _leaves(lora_params))
        opt_state, _ = optimizer.update_(lora_params, list(grads),
                                         opt_state)
        return lora_params, opt_state, loss.detach()

    return step


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument('--hf-checkpoint', required=True,
                        help='HF-layout dir (config.json + safetensors '
                             '+ tokenizer.json)')
    parser.add_argument('--data', required=True,
                        help='text file (one document per line) or flat '
                             'int32 token .npy')
    parser.add_argument('--steps', type=int, default=100)
    parser.add_argument('--batch', type=int, default=4)
    parser.add_argument('--seq', type=int, default=512)
    parser.add_argument('--learning-rate', type=float, default=1e-5)
    parser.add_argument('--lora-rank', type=int, default=0,
                        help='0 = full finetune; >0 = LoRA rank '
                             '(frozen bf16 base, fp32 adapters)')
    parser.add_argument('--mesh', default=None,
                        help="full finetune: e.g. 'fsdp=2', 'stage=2', "
                             "'stage=2,seq=2' (ignored with --lora-rank "
                             '> 0)')
    parser.add_argument('--export-dir', default=None,
                        help='write the finetuned model back as an '
                             'HF-layout checkpoint (LoRA merged)')
    parser.add_argument('--adapter-export-dir', default=None,
                        help='LoRA mode: also export the UNMERGED '
                             'adapter as a content-addressed manifest '
                             'artifact under this registry root '
                             '(digest-named A/B shards + base-model '
                             'digest), servable by the multi-LoRA '
                             'engine')
    parser.add_argument('--adapter-name', default=None,
                        help='registry name for --adapter-export-dir '
                             '(default: the export dir basename or '
                             '"adapter")')
    parser.add_argument('--checkpoint-dir', default=None)
    parser.add_argument('--checkpoint-every', type=int, default=50)
    parser.add_argument('--log-every', type=int, default=10)
    parser.add_argument('--device', default=None,
                        help="'cuda' (default) or 'cpu'")
    return parser.parse_args(argv)


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def run(args: argparse.Namespace, *, lora_init=None,
        **config_overrides) -> Dict[str, Any]:
    """The finetune ``args`` ask for. ``lora_init`` replaces the
    adapter's seeded init (tests carry the reference's over);
    ``config_overrides`` go to the loaded config (e.g. the compute
    dtype). Returns the losses, the final (merged) params, the config
    and the adapter (None in full mode). A full finetune on a mesh of
    more than one rank runs in each rank of the launch (``main``), and
    every rank returns the whole params."""
    from skypilot_tpu_torch.inference.tokenizer import get_tokenizer
    from skypilot_tpu_torch.models import hf_interop
    from skypilot_tpu_torch.models import lora as lora_lib
    from skypilot_tpu_torch.train import checkpoint as ckpt_lib
    from skypilot_tpu_torch.train.pretrain import (enter_mesh,
                                                   file_batch_iterator,
                                                   mesh_seq)
    from skypilot_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    use_lora = args.lora_rank > 0
    if use_lora and args.mesh:
        _emit({'warning': '--mesh is ignored with --lora-rank > 0 (LoRA '
                          'runs unsharded)'})
    # LoRA: a frozen bf16 base halves resident memory and has no
    # optimizer state. Full: fp32 master weights.
    params, cfg = hf_interop.load_checkpoint(
        args.hf_checkpoint,
        dtype=torch.bfloat16 if use_lora else torch.float32,
        device=device, **config_overrides)
    mesh, is_main = None, True
    if not use_lora:
        _, mesh, is_main = enter_mesh(args, cfg, device)
    emit = _emit if is_main else _quiet
    seq = mesh_seq(min(args.seq, cfg.max_seq_len), mesh, is_main)
    if args.data.endswith('.npy'):
        data_iter = file_batch_iterator(args.data, args.batch, seq, device)
    else:
        tokenizer = get_tokenizer(args.hf_checkpoint, require=True)
        data_iter = text_batch_iterator(args.data, tokenizer, args.batch,
                                        seq, device)

    t0 = time.perf_counter()
    losses: List[float] = []
    lora_params = None

    def log(step: int, loss: torch.Tensor, mode: str) -> None:
        if (step + 1) % args.log_every == 0 or step + 1 == args.steps:
            emit({'step': step + 1, 'loss': round(float(loss), 4),
                   'mode': mode})

    def checkpoint_due(step: int) -> bool:
        return bool(args.checkpoint_dir) and (
            (step + 1) % args.checkpoint_every == 0 or
            step + 1 == args.steps)

    if use_lora:
        if lora_init is None:
            lora_params = lora_lib.init_lora_params(0, cfg, args.lora_rank,
                                                    device=device)
        else:
            lora_params = {k: v.to(device=device, dtype=torch.float32)
                           for k, v in lora_init.items()}
        optimizer = plain_adamw(args.learning_rate)
        opt_state = optimizer.init(lora_params)
        start_step = 0
        if args.checkpoint_dir:
            latest = ckpt_lib.latest_step(args.checkpoint_dir)
            if latest is not None:
                restored = ckpt_lib.restore(
                    args.checkpoint_dir, latest,
                    {'lora': lora_params, 'opt': opt_state, 'step': 0})
                lora_params = restored['lora']
                opt_state = restored['opt']
                start_step = int(restored['step'])
                _emit({'resumed_from_step': start_step})
        for leaf in _leaves(lora_params):
            leaf.requires_grad_(True)
        skip_batches(data_iter, start_step)
        step_fn = make_lora_step(params, cfg, optimizer)
        for step in range(start_step, args.steps):
            lora_params, opt_state, loss = step_fn(
                lora_params, opt_state, next(data_iter))
            losses.append(float(loss))
            log(step, loss, f'lora-r{args.lora_rank}')
            if checkpoint_due(step):
                ckpt_lib.save(args.checkpoint_dir, step + 1,
                              {'lora': lora_params, 'opt': opt_state,
                               'step': step + 1})
        lora_params = {k: v.detach() for k, v in lora_params.items()}
        final_params = lora_lib.merge(lora_lib.attach(params, lora_params))
        if args.adapter_export_dir:
            # The UNMERGED adapter, pinned to its base: the multi-LoRA
            # engine rejects it against any other base checkpoint.
            from skypilot_tpu_torch.serve import adapter_registry
            adapter_name = (args.adapter_name or
                            (os.path.basename(
                                os.path.normpath(args.export_dir))
                             if args.export_dir else 'adapter'))
            exported = adapter_registry.export_adapter(
                args.adapter_export_dir, adapter_name, lora_params,
                alpha=lora_lib.DEFAULT_ALPHA,
                base_digest=adapter_registry.checkpoint_digest(
                    args.hf_checkpoint),
                step=args.steps,
                extra_meta={'hf_checkpoint': args.hf_checkpoint})
            _emit({'adapter_exported': exported,
                   'adapter_name': adapter_name, 'rank': args.lora_rank})
    else:
        from skypilot_tpu_torch.train.step import (
            create_train_state_from_params, make_train_step,
            state_shardings)
        hp = TrainHParams(learning_rate=args.learning_rate,
                          warmup_steps=min(10, args.steps),
                          total_steps=max(args.steps, 11))
        state = create_train_state_from_params(params, cfg, hp, mesh)
        del params
        shardings = (None if mesh is None
                     else state_shardings(mesh, cfg, hp))
        start_step = 0
        if args.checkpoint_dir:
            latest = ckpt_lib.latest_step(args.checkpoint_dir)
            if latest is not None:
                state = ckpt_lib.restore(args.checkpoint_dir, latest, state,
                                         shardings=shardings)
                start_step = state.step
                emit({'resumed_from_step': start_step})
        skip_batches(data_iter, start_step)
        step_fn = make_train_step(cfg, hp, mesh)
        for step in range(start_step, args.steps):
            state, metrics = step_fn(state, next(data_iter))
            losses.append(float(metrics['loss']))
            log(step, metrics['loss'], 'full')
            if checkpoint_due(step):
                ckpt_lib.save(args.checkpoint_dir, step + 1, state,
                              shardings=shardings)
        final_params = state.params
        if mesh is not None:
            from skypilot_tpu_torch.parallel.sharding import (
                gather_params_pytree, tensor_parallel_of)
            final_params = gather_params_pytree(
                shardings.params, final_params, tensor_parallel_of(mesh))

    if args.export_dir and is_main:
        hf_interop.save_checkpoint(final_params, cfg, args.export_dir,
                                   dtype=torch.float32)
        # Ship the tokenizer along so the export serves end-to-end.
        for fn in ('tokenizer.json', 'tokenizer_config.json'):
            src = os.path.join(args.hf_checkpoint, fn)
            if os.path.exists(src):
                shutil.copy(src, os.path.join(args.export_dir, fn))
        emit({'exported': args.export_dir})
    emit({'done': True, 'seconds': round(time.perf_counter() - t0, 1)})
    return {'losses': losses, 'params': final_params, 'cfg': cfg,
            'lora': lora_params}


def _quiet(obj) -> None:
    del obj


def main(argv=None) -> int:
    from skypilot_tpu_torch.models.hf_interop import load_config
    from skypilot_tpu_torch.train.pretrain import start_ranks
    from skypilot_tpu_torch.utils.device import resolve_device
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    if args.lora_rank == 0:
        device = resolve_device(args.device)
        code = start_ranks(main, argv, args.mesh,
                           load_config(args.hf_checkpoint), device.type,
                           args.batch)
        if code is not None:
            return code
    run(args)
    return 0


if __name__ == '__main__':
    sys.exit(main())
