"""Batch-inference mapper: the port of ``skypilot_tpu/batch/infer_worker.py``.

Reads a JSONL slice (``{"prompt": ...}`` per record) from $BATCH_INPUT
or ``--input`` and writes each record back with its ``completion`` (or,
with ``--embeddings``, its L2-normalized ``embedding``) to $BATCH_OUTPUT
or ``--output``. The batch ``InferenceEngine`` loads once per process::

    python -m skypilot_tpu_torch.batch.infer_worker --model llama3-8b \\
        --input prompts.jsonl --output out.jsonl [--embeddings]
    python -m skypilot_tpu_torch.batch.infer_worker --device cpu ...

A directory as ``--model`` is an HF checkpoint: its weights load in
bf16 and its own tokenizer serves (``models/hf_interop.py``). Runs on
the card unless ``--device cpu`` asks for the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument('--model', default='tiny',
                        help='registered model name, or an HF checkpoint '
                             'directory (config.json + safetensors + '
                             'tokenizer.json)')
    parser.add_argument('--max-new-tokens', type=int, default=128)
    parser.add_argument('--embeddings', action='store_true',
                        help='emit L2-normalized text embeddings '
                             '(engine.embed_text) instead of '
                             'completions')
    parser.add_argument('--temperature', type=float, default=0.0)
    parser.add_argument('--max-batch', type=int, default=8)
    parser.add_argument('--device', default=None,
                        help="torch device (default cuda; 'cpu' runs on "
                             'the CPU).')
    parser.add_argument('--input', default=None,
                        help='override $BATCH_INPUT (local testing)')
    parser.add_argument('--output', default=None,
                        help='override $BATCH_OUTPUT (local testing)')
    args = parser.parse_args(argv)

    in_path = args.input or os.environ['BATCH_INPUT']
    out_path = args.output or os.environ['BATCH_OUTPUT']
    records = []
    with open(in_path, encoding='utf-8') as f:
        for line in f:
            line = line.strip()
            if line:
                records.append(json.loads(line))

    from skypilot_tpu_torch.inference.engine import InferenceEngine
    if os.path.isdir(args.model):
        engine = InferenceEngine(hf_checkpoint=args.model,
                                 device=args.device,
                                 max_batch=args.max_batch)
    else:
        engine = InferenceEngine(args.model, device=args.device,
                                 max_batch=args.max_batch)
    prompts = [r.get('prompt', '') for r in records]
    if args.embeddings:
        vectors = engine.embed_text(prompts)
        with open(out_path, 'w', encoding='utf-8') as f:
            for record, vec in zip(records, vectors):
                f.write(json.dumps(
                    {**record,
                     'embedding': [round(float(v), 6) for v in vec]})
                    + '\n')
        return 0
    completions = engine.generate_text(
        prompts, max_new_tokens=args.max_new_tokens,
        temperature=args.temperature)
    with open(out_path, 'w', encoding='utf-8') as f:
        for record, completion in zip(records, completions):
            f.write(json.dumps({**record, 'completion': completion})
                    + '\n')
    return 0


if __name__ == '__main__':
    sys.exit(main())
