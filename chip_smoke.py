#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py              # all phases, one card
    python3 chip_smoke.py --skip-engine  # device, build and kernels only
    python3 chip_smoke.py --profile      # + torch.profiler windows

Phases, in order; any failure exits non-zero:

1. Device: a CUDA card or exit; print its ``nvidia-smi`` name and power
   limit; TF32 off for matmuls and cuDNN.
2. Build: compile every kernel under ``skypilot_tpu_torch/csrc`` from
   this checkout (``_build.build_all``, one ``nvcc`` per source, all
   started together).
3. Paged kernels vs plain: each paged-attention kernel against its plain
   PyTorch version on the same card tensors, at llama3-8b attention
   shapes (H=32, KVH=8, D=128, BS=16; shuffled block tables; lengths
   1..2048), decode (Q=1) and verify (Q=5) windows, bf16 / fp32 / int8
   pools, head dims 64 and 256, the engine's own B=4 shape, B=40, a
   pool whose rows past each slot's length hold +-1e4, the MoE configs'
   heads, and bench-1b7's heads (G=5) at the GRPO rollout engine's 8
   slots of 65-129 rows; each output held by its error normalized per
   (sequence, head) (``head_err``), with planted faults (an interior
   block, one split's blocks or the last partial block of a 1000-row
   slot, or of the GRPO shape's 120-row slot, skipped; a (sequence, kv
   head) unwritten) that must exceed the same limit, and fully masked
   verify rows held to the mean of the V rows of the blocks read. Then
   times (median of CUDA-event timings, L2 flushed before each launch)
   at the B=8 mixed-length decode shape: kernel, plain version, and
   ``F.scaled_dot_product_attention`` over the gathered view (a
   yardstick only; the port never calls it), beside the bound; the
   kernel alone at B=8 mixed Q=5 and B=128 mixed Q=1 beside their
   bounds; and the kernel's time against its split count at B=4, 8, 40
   and 128, beside each shape's bound.
4. Decode kernels vs plain: each decode-attention kernel (kernels 3-4,
   the batch engine's) against its plain PyTorch version at llama3-8b
   heads: B=8 mixed lengths 1..2048 at T=2048 with Q=1 and Q=5, the batch
   engine's T=288 at B=4 and for a lone request (B=1, with planted
   faults), B=40 and B=128 (one split), caches whose stale rows
   hold +-1e4 (Q=1 and Q=5), D=64 at T=300 (off the 16-row tile) and
   D=256; bf16, fp32 and int8 caches; each output held by its error
   normalized per (sequence, head) (``head_err``), with planted faults
   (a (sequence, kv head) unwritten, an interior and the last partial
   16-row tile of the 1000-row sequence skipped, one split's rows of a
   2048-row sequence skipped) that must exceed the same limit, and fully
   masked window rows held to the mean of the V rows read. Then times,
   bf16 and int8,
   at B=8 mixed T=2048 (Q=1 and Q=5), the engine's B=4 T=288 and B=128
   mixed T=2048: kernel, plain, and SDPA with a boolean length mask over
   the whole cache (a yardstick only), beside the bound.
5. Flash kernels vs plain: forward (o, lse), dq and dk/dv against their
   plain versions at bench-1b7's attention shape (B=2, S=2048, H=20,
   KVH=4, D=128), causal and not, bf16 and fp32, with and without
   segment ids, and with segment ids that do not increase along a row
   (bf16, causal and not); once at D=256; once at the batch engine's
   prefill shape (llama3-8b heads H=32, KVH=8, B=4, S=256, bf16,
   causal), its lone request's (B=1, S=256), the LoRA finetune's
   (B=4, S=512) and the GRPO learner's (bench-1b7 heads, B=8, S=128);
   at the ring's edge shapes S=64 and S=192 with GQA groups 1
   and 8, bf16 and fp32; each output's error normalized per 64-row tile
   of one head (``tile_err``), and the dq kernel's delta against the
   plain one. A second backward must give bitwise the same dq, dk and
   dv. Faults planted in the plain bf16 outputs (a tile unwritten, a
   key tile skipped by the forward or by dq, with segments a key tile
   that shares a document skipped by the forward, a group head
   dropped, delta off by a constant) must exceed the same limits. Then
   at the trainer's shape (B=8, bf16, causal) the
   outputs against plain once more, and the times, causal and with
   packed documents (the ``_seg`` twins): each kernel, its plain
   version, SDPA forward and backward (flash backend; with documents
   the efficient backend and a boolean mask; a yardstick only), the
   torch delta chain, and the bound; beside them the least time the
   kernels' shared-memory operand reads take (``smem_floor_ms``).
6. Small-model training agreement: TINY with head_dim 128 and fp32
   compute, three train steps on the card (kernel path) and on the CPU
   (plain path) from the same params and batches; and at bf16 compute,
   one forward and backward on the card through the kernels and through
   ``xla_attention``, every parameter gradient compared.
7. Training, full width and depth: ``train.pretrain.main`` on bench-1b7,
   B=8, S=2048, 20 steps; losses finite and falling; the flash counters
   must move by 2 x n_layers forward and n_layers each of dq and dk/dv
   per step (full remat), and no call may leave the kernels' gate. Step time, tokens/s, TFLOP/s, share of peak
   and peak memory.
8. Small-model serving agreement: the engine on the card and on the CPU
   give the same greedy tokens (TINY, head_dim 128, fp32 compute).
9. Continuous engine, full width: llama3-8b at full depth (bf16 weights from the
   port's seeded random init on the card), served by the port's HTTP
   server; four concurrent ``/generate`` requests, one of them longer
   than a prefill chunk; the kernel counter must rise by n_layers per
   decode step; a repeated request is identical; then (outside the
   counted window) the plain streams of phase 14's prompts.
10. Continuous engine, int8 KV on the same weights: the int8 kernel
   must run.
11. Small batch-engine agreement: ``InferenceEngine`` on the card and on
   the CPU give the same greedy tokens (TINY, head_dim 128, fp32
   compute), with an fp and an int8 cache.
12. Batch engine, full width: ``InferenceEngine(max_batch=4)`` on phase
   9's llama3-8b weights behind the port's HTTP server; one /generate
   of 4 prompts (bucket 256) and 32 new tokens: decode_attention must
   launch n_layers x 32 times and flash fwd n_layers times, with no
   flash fallback; a repeat is identical; the prefill time of the
   batch; ``embed_text`` gives unit-norm vectors; an int8-KV engine
   (the int8 kernel must run) and a W8A8 engine (prefill logits finite,
   cosine > 0.99 against the bf16 weights') on the same weights.
13. Small speculative and LoRA agreement: TINY with head_dim 128 and
   fp32 compute; a speculative engine (draft_k 4), a plain engine and a
   LoRA engine (one seeded adapter, B non-zero) on the card give the
   greedy tokens of the plain and the LoRA engine on the CPU, on a
   periodic, an arbitrary and a constant prompt.
14. Speculative serving, full width: phase 9's llama3-8b weights, n-gram
   drafts with draft_k 4 (verify windows of 5 rows, 20 query rows a kv
   head) behind the port's HTTP server: one /v1/completions alone, then
   four concurrent /v1/completions (the first prompt repeated, one
   streamed as SSE) and one /v1/chat/completions; the paged kernel must
   launch n_layers x (decode + verify steps); the SSE stream ends with a
   finish_reason frame and [DONE]; /metrics serves the verify counter;
   the repeated prompt alone accepts drafts from the corpus; acceptance
   rate, decode tok/s and time to first token beside phase 9's, and the
   share of tokens on which the bf16 speculative streams agree with
   phase 9's plain streams of the same prompts (printed, not gated).
   Again with an int8 pool: the int8 kernel rises the same way.
15. LoRA serving, full width: the same weights, lora_pages 4,
   lora_max_rank 16, two seeded adapters (rank 16 and 8, B scaled by
   ``LORA_B_SCALE``) through /generate with an ``adapter`` field and
   /v1/completions with ``X-Skyt-Adapter``, beside a base /generate: the
   paged kernel launches n_layers a decode step; /adapters and /stats
   show 2 resident adapters and charged KV blocks; the base request
   gives the tokens it gives alone on a plain engine, each adapter
   other tokens; decode tok/s beside a plain engine's.

16. Bench twin, train: ``skypilot_tpu_torch.bench`` ``--mode train`` at
   its defaults (bench-1b7, Adafactor, bf16 params, full remat, B=8,
   S=2048, 5 warmup and 20 timed steps): rc 0, one JSON line, a finite
   loss, 2L forward, L dq and L dk/dv flash launches a step over the 25
   steps, no call outside the kernels; MFU, tokens/s, s/step, peak GB.
17. Remat policies: the same with ``--remat-policy`` save_attn,
   save_dots and dots (1 + 3 steps each): 2L / L / L launches a step
   (``models/llama.py:_remat_policy``); s/step and peak GB each.
18. Packed documents: ``train.pretrain.main --packed`` on bench-1b7 (B=8,
   S=2048, Adafactor, bf16 params, 3 steps) over a token file written
   here (documents of mean length 500): only the segment kernels move
   (2L / L / L a step), the native packer packs every batch, losses
   finite.
19. Resume: ``train.pretrain.main --checkpoint-dir`` on TINY with head
   dim 128 (registered here as ``tiny-hd128``): 4 steps checkpointed at
   2 and 4; a second run from a copy of step 2 alone resumes and must
   give the first run's losses and step-4 state bitwise.
20. Bench twin, decode: ``--mode decode`` at its defaults (bench-1b7
   bf16, B=8, prompt 128, N=256): the decode kernel launches 22 times a
   decode step, the flash forward 22 times a prefill.
21. Bench twin, kernels: ``--mode kernels`` (every hand kernel against
   its plain version at the reference's shapes and tolerances) exits 0.

22. MoE serving, full width and depth: deepseek-moe-16b (28 layers, 64
   experts top 6, 16 heads = 16 kv heads of dim 128, dense dispatch;
   seeded bf16 weights with an fp32 router, 32.8 GB, initialized on the
   card) on the continuous engine (4 slots) and the batch engine
   (max_batch 4) behind the port's HTTP server, 4 prompts of 131-255
   tokens and 32 new tokens each: paged and decode launches rise by 28
   a decode step, flash fwd by 28 a batch prefill, every logits row
   finite; greedy tokens of the two engines compared (printed, not
   gated); decode tok/s of each; one decode step (CUDA events) against
   the bytes of every weight it reads, and its 28 MoE blocks alone
   (with ``--profile`` also their share of a traced step); peak memory.
23. The same continuous-engine requests on ``quantize_params(params,
   quantize_moe=True)``: param bytes below 0.55x the bf16 tree, finite
   logits, greedy agreement with phase 22 printed.
24. gpt-oss-20b at full width and 4 of its 24 layers on the continuous
   engine: the paged kernel at D=64, G=8, 4 launches a decode step.
25. MoE training: three ``make_train_step`` steps on deepseek-moe-16b
   at 2 layers with capacity dispatch (AdamW, fp32 params, B=4,
   S=1024): finite losses, ``router_aux`` >= 1 - 1e-6, flash launches
   2L / L / L a step.

26. Serving from a checkpoint directory, full width and depth (run after
   phase 15, on phase 9's weights): ``hf_interop.save_checkpoint`` of
   the llama3-8b params in bf16 (16.06 GB) plus the committed
   tokenizer fixture (``skypilot_tpu_torch/testdata/tokenizer_llama3``)
   into a scratch directory (free space checked first; removed at the
   end); ``load_checkpoint`` on the card must give every tensor bitwise
   and peak at most the params + 2 x the largest tensor; then the
   port's server built from ``--hf-checkpoint DIR``, continuous engine
   and then batch engine (freed between): four lone /generate
   requests, one at a time, whose tokens a twin engine on the in-memory
   params must reproduce; paged launches n_layers a decode step,
   decode launches n_layers x 32 and flash fwd n_layers a request; one
   /v1/chat/completions through the fixture's chat template; save and
   load GB/s, load peak, time to first token and decode tok/s.
27. Finetune on that directory: ``train.finetune.main`` with LoRA rank
   8, 3 steps, B=4, S=512 and ``--adapter-export-dir``: finite losses,
   the trained B leaves nonzero, flash launches per step 2L forward
   (L without remat), L dq, L dk/dv; then the server with
   ``--hf-checkpoint DIR --lora-dir REG``: the adapter registers
   against the checkpoint's digest, and a request naming it gives
   first-token logits that differ from the base request's; s/step and
   peak GB.
28. Disaggregated prefill/decode, full width and depth (after phase 27,
   on phase 9's weights): a prefill-role and a decode-role continuous
   engine (4 slots, max_len 2048, block 16), and a decode-role twin,
   each behind the port's server on localhost. The script drives both
   hops as the serve LB does: ``/disagg/prefill`` on the prefill server,
   then ``/generate`` on the decode server with ``X-Skyt-Kv-Request-Id``
   and ``X-Skyt-Kv-Endpoint``. Four lone requests of 131-255 tokens + 32,
   one at a time: greedy tokens exactly the twin's single-hop (local
   prefill) answer; no paged launch during hop 1 and n_layers a decode
   step during hop 2; exports +1 with none pending after, imports +1,
   no fallback and no decode-side prefill chunk; the handoff histogram
   observed. Then a request sharing 11 full blocks with a lone one: a
   direct ``KvPuller`` pull moves fewer blocks than it has, 11 resident,
   and its two-hop tokens equal the twin's; and a burst of 4 through
   both hops at once (counters gated, agreement with the twin's
   concurrent streams printed). Again on int8 pools (kernel 2), lone
   requests only. Any WARNING from the port's serving modules (a failed
   pull, an import fallback, a retry) fails the phase. Pool GB, handoff
   seconds (pull + import) and bytes moved per request, decode tok/s
   beside the twin's.

29. GRPO with live weight refresh, full width and depth (after phase 28;
   its own ``[smoke]`` line): ``grpo.main``'s loop (``grpo.run`` of its
   parsed argv) on bench-1b7, 3 steps of 2 prompts x 4 rollouts, prompt
   65 + 64 new tokens at temperature 1, rollouts from the continuous
   engine (8 slots), a learner step at B=8, S=128 (fp32, optax's plain
   AdamW) and a full live refresh after each: the paged kernel launches
   22 a decode step, flash 2L / L / L a learner step with no fallback;
   weight_refreshes and policy_version 3; every engine leaf the
   learner's cast to bf16 bit for bit; a temperature-0 wave of unseen
   prompts token for token a fresh engine's on the learner's params; a
   delta refresh negating ``layers/mlp/wo`` changes a lone request's
   greedy tokens and a drain refresh restoring it brings them back. Per
   step rollout / learn / refresh seconds and peak memory.
30. The RL pipeline and the eval server: ``RLPipeline`` at bench-1b7's
   full width and 2 of its 22 layers (registered here as
   ``bench-1b7-l2``), 2 rollout replicas, staleness bound 3, queue 2, 5
   learner steps (without a live refresh the valve admits at most 4
   batches), one fault at each of ``rl.rollout.generate``,
   ``rl.refresh.pull`` and ``rl.learn.step``: staleness max <= 3, no
   batch lost, the faulted batch requeued, >= 1 live refresh, paged 2
   launches a decode step of both replicas, flash 2L / L / L a learner
   step. Then the port's server with ``--policy-store`` on the same
   store (under a scratch directory, removed at the end): it serves the
   store's version, leaves equal to the store's arrays in bf16, before
   its first ``/generate``, and ``GET /fanout/*`` hands a
   ``FanoutPuller`` the store's manifest and bytes.

31. Tensor-parallel serving (after the MoE phases): llama3-8b at full
   width and depth at ``mesh='tensor=2'``, two ranks
   (``parallel/launch.py``) sharing the one card over ``gloo``, each
   building its shard from the same seeded init as phase 9. First
   kernels 1-5 timed at one rank's shapes (H=16, KVH=4; phases 3-5 hold
   them against the plain versions with planted faults). Then on both
   ranks the continuous engine (4 prompts of 131-255 tokens + 16 new;
   bf16, then int8 pool with every collective timed; then n-gram
   drafts, draft_k 4) and the batch engine (one batch, bf16 then int8
   cache): each rank's launch counts must be n_layers a decode or
   verify step (paged), n_layers x 16 (decode) and n_layers a prefill
   (flash), no flash fallback. The
   first decode step's logits (gathered to the driver) against one
   rank's on the same weights within ``TP_LOGIT_TOL`` a row; the common
   greedy prefix with one rank's batch engine printed, not gated. Then
   ``inference.server --mesh tensor=2`` (its own two ranks) answers
   ``/generate`` and ``/v1/completions`` and ``/stats`` names the mesh
   and the backend. Printed beside the card's name and power limit:
   each rank's peak memory, decode tok/s at tensor=2 against one rank's
   and the collectives' share of a timed run, labelled "two ranks on
   one card over gloo: not a TP speed".

Then one JSON line listing every kernel (the paged kernels' launches are
the sums of phases 9, 14, 15, 22, 23, 24, 26, 27, 28, 29, 30 and 31, and
of 10, 14, 28 and 31's int8 runs; the decode kernels' of phases 12, 20,
22, 26 and 31; the flash kernels' of phases 7, 16, 17, 18, 25, 27, 29
and 30, and phase 31's batch prefills' forwards), the
``nvidia-smi`` name and power-limit line, and last ``{"ok": true,
"device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

# Peak rates per card (NVIDIA data sheets; dense, no sparsity).
_CARDS = [  # (name fragment, memory bytes/s, bf16 flop/s)
    ('H200', 4.8e12, 989e12),
    ('H100 NVL', 3.9e12, 835e12),
    ('H100 PCIe', 2.0e12, 756e12),
    ('H100', 3.35e12, 989e12),   # SXM
]
N_TIMED = 30


def log(msg: str) -> None:
    print(msg, flush=True)


def card_peaks(name: str):
    for fragment, bw, flops in _CARDS:
        if fragment in name:
            return fragment, bw, flops
    raise RuntimeError(f'no peak rates known for {name!r}')


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Phase 3: kernels vs plain
# ---------------------------------------------------------------------------

def make_case(torch, *, b, kvh, g, d, bs, bps, lengths, q_len, pool, seed,
              poison=False):
    """Card tensors for one paged-attention call (public layout). With
    ``poison``, the pool rows a slot does not hold (past n_valid in the
    last block read, and every block after it) hold +-1e4 (K +, V -)."""
    from skypilot_tpu_torch.models.decode import quantize_kv
    gen = torch.Generator(device='cuda')
    gen.manual_seed(seed)
    nb = b * bps + 1
    qdt = torch.float32 if pool == 'fp32' else torch.bfloat16
    k = torch.randn((nb, bs, kvh, d), generator=gen, device='cuda')
    v = torch.randn((nb, bs, kvh, d), generator=gen, device='cuda')
    q = torch.randn((b, q_len, kvh * g, d), generator=gen,
                    device='cuda').to(qdt)
    perm = torch.randperm(nb - 1, generator=gen, device='cuda') + 1
    bt = perm[:b * bps].reshape(b, bps).to(torch.int32).contiguous()
    nv = torch.tensor(lengths, dtype=torch.int32, device='cuda')
    if poison:
        pos = torch.arange(bps * bs, device='cuda').reshape(bps, bs)
        stale = (pos[None] >= nv[:, None, None]).reshape(-1)
        rows = (bt.long()[:, :, None] * bs +
                torch.arange(bs, device='cuda')).reshape(-1)[stale]
        k.view(nb * bs, kvh, d)[rows] = 1e4
        v.view(nb * bs, kvh, d)[rows] = -1e4
    qg = q.reshape(b, q_len, kvh, g, d).transpose(1, 2)
    case = {'q': q, 'qg': qg.reshape(b, kvh, q_len * g, d).contiguous(),
            'bt': bt, 'nv': nv, 'k_scale': None, 'v_scale': None}
    if pool == 'int8':
        case['k'], case['k_scale'] = quantize_kv(k.to(torch.bfloat16))
        case['v'], case['v_scale'] = quantize_kv(v.to(torch.bfloat16))
    else:
        case['k'], case['v'] = k.to(qdt), v.to(qdt)
    return case


def run_kernel(pa, c):
    return pa.paged_attention(c['q'], c['k'], c['v'], c['bt'], c['nv'],
                              k_scale=c['k_scale'], v_scale=c['v_scale'])


def run_kernel_splits(pa, c, splits):
    """The kernel alone (kernel layout, no regroup) with a fixed split
    count; returns the kernel layout [B, KVH, Q*G, D]."""
    q_len = c['q'].shape[1]
    return pa.paged_attention_kernel(c['qg'], c['k'], c['v'], c['bt'],
                                     c['nv'], q_len, c['k_scale'],
                                     c['v_scale'], num_splits=splits)


def run_plain(pa, c, bt=None, nv=None):
    return pa.paged_attention_reference(
        c['q'], c['k'], c['v'], c['bt'] if bt is None else bt,
        c['nv'] if nv is None else nv, c['k_scale'], c['v_scale'])


def time_ms(torch, fn, flush) -> float:
    """Median device time of ``fn`` over N_TIMED launches, each after an
    L2 flush; a device-side sleep keeps the host's enqueue out of the
    measured window."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(N_TIMED):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(c, bs, d, bw, flops_peak):
    """Least time for the work this call's data needs: the K/V rows of
    the blocks read (+ int8 scales), q, out, lengths and tables, each
    moved once, against ~4 flops per (query row, key row, dim)."""
    nv = c['nv'].tolist()
    b, q_len, h, _ = c['q'].shape
    kvh = c['k'].shape[2]
    bps = c['bt'].shape[1]
    rows = sum(min(math.ceil(n / bs), bps) * bs for n in nv)
    kv_bytes = rows * kvh * d * 2 * c['k'].element_size()
    if c['k_scale'] is not None:
        kv_bytes += rows * kvh * 4 * 2
    q_bytes = c['q'].numel() * c['q'].element_size()
    nbytes = kv_bytes + 2 * q_bytes + 4 * b + 4 * b * bps
    flops = 4 * rows * q_len * h * d
    bytes_ms = nbytes / bw * 1e3
    ops_ms = flops / flops_peak * 1e3
    return (max(bytes_ms, ops_ms),
            'bytes' if bytes_ms >= ops_ms else 'operations')


def library_call(torch, c, bs):
    """``F.scaled_dot_product_attention`` over the pre-gathered view with
    a boolean mask: one library call computing the same decode (Q=1)
    function, timed as a yardstick."""
    import torch.nn.functional as F
    b, q_len, h, d = c['q'].shape
    nb, _, kvh, _ = c['k'].shape
    bps = c['bt'].shape[1]
    rows = (c['bt'].long()[:, :, None] * bs +
            torch.arange(bs, device='cuda')).reshape(b, -1)
    k = c['k'].reshape(nb * bs, kvh, d)[rows]
    v = c['v'].reshape(nb * bs, kvh, d)[rows]
    if c['k_scale'] is not None:
        k = (k.float() * c['k_scale'].reshape(nb * bs, kvh)[rows][..., None])
        v = (v.float() * c['v_scale'].reshape(nb * bs, kvh)[rows][..., None])
    dt = c['q'].dtype
    g = h // kvh
    k = k.to(dt).repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
    v = v.to(dt).repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
    q = c['q'].transpose(1, 2).contiguous()
    mask = (torch.arange(bps * bs, device='cuda')[None, :] <
            c['nv'][:, None])[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)


# Limits on the per-(sequence, head) normalized error (head_err) of the
# paged kernels. bf16 and int8 outputs round to bf16 (2^-8 relative, up
# to 2^-7 of the largest element when a rounding flips), and the kernel
# rounds P against its running max where the plain version uses the
# row's; fp32 sums differ in order only. Planted faults (paged_faults)
# read 0.17 and more in a CPU run of the plain version at the B=8 mixed
# shape, and must exceed these.
PAGED_TOL = {'bf16': 2e-2, 'fp32': 1e-4, 'int8': 2e-2}


def blocks_left_out(c, seq, blocks, bs, nv_seq=None):
    """The block table and lengths of a call in which sequence ``seq``
    never had ``blocks`` (indices into its table; its later blocks move
    up), or, with ``nv_seq``, simply holds that many rows."""
    bt, nv = c['bt'].clone(), c['nv'].clone()
    if blocks:
        bps = bt.shape[1]
        keep = [i for i in range(bps) if i not in blocks] + list(blocks)
        bt[seq] = c['bt'][seq, keep]
        nv[seq] -= len(blocks) * bs
    if nv_seq is not None:
        nv[seq] = nv_seq
    return bt, nv


def paged_faults(torch, pa, c, ref, kvh, bs, splits, rows=1000):
    """Errors of faults the kernel could make, built from the plain
    output (Q=1) on the sequence that holds ``rows`` rows (1000 rows in
    63 blocks: sequence 4 at B=8, 2 at B=4): an interior block skipped
    (block 30, or the middle one of a shorter sequence), one split's
    partial dropped (its second split's blocks), one (sequence, kv
    head) left unwritten (sequence 1, kv head 3), and the last partial
    block skipped (rows 992-999 of 1000)."""
    seq = c['nv'].tolist().index(rows)
    nblk = -(-rows // bs)
    per = -(-nblk // splits)
    cases = {'interior block skipped': dict(blocks=[min(30, nblk // 2)]),
             'one split dropped': dict(blocks=list(range(per, 2 * per))),
             'last partial block skipped': dict(blocks=[],
                                                nv_seq=rows // bs * bs)}
    errs = {}
    for name, kw in cases.items():
        bt, nv = blocks_left_out(c, seq, bs=bs, **kw)
        errs[name] = head_err(torch, run_plain(pa, c, bt, nv), ref, c['nv'])
    unwritten = ref.clone()
    g = ref.shape[2] // kvh
    unwritten[min(1, ref.shape[0] - 1), :, 3 * g:4 * g] = 0
    errs['one (b, kv head) unwritten'] = head_err(torch, unwritten, ref,
                                                  c['nv'])
    return errs


def masked_rows_err(torch, c, out, bs):
    """Fully masked query rows (window positions j with n_valid - (Q - 1
    - j) <= 0): the largest error of the kernel's rows against the mean
    of the V rows of the blocks read, normalized per (sequence, head) by
    that mean's largest entry; inf if none is finite. None without such
    rows."""
    b, q_len, h, d = c['q'].shape
    nb, _, kvh, _ = c['k'].shape
    worst = None
    for i, n in enumerate(c['nv'].tolist()):
        masked = [j for j in range(q_len) if n - (q_len - 1 - j) <= 0]
        if not masked:
            continue
        nblk = min(-(-n // bs), c['bt'].shape[1])
        rows = (c['bt'][i, :nblk].long()[:, None] * bs +
                torch.arange(bs, device='cuda')).reshape(-1)
        v = c['v'].reshape(nb * bs, kvh, d)[rows].float()
        if c['v_scale'] is not None:
            v = v * c['v_scale'].reshape(nb * bs, kvh)[rows][..., None]
        mean = v.mean(0).repeat_interleave(h // kvh, dim=0)   # [H, D]
        got = out[i, masked].float()                          # [M, H, D]
        if not bool(torch.isfinite(got).all()):
            return math.inf
        err = ((got - mean).abs().amax(dim=(0, 2)) /
               mean.abs().amax(dim=1).clamp_min(1e-30)).max().item()
        worst = err if worst is None else max(worst, err)
    return worst


LLAMA_PAGED = dict(kvh=8, g=4, d=128, bs=16, bps=128)
LENGTHS8 = [1, 15, 16, 17, 1000, 2048, 1000, 2048]
MOE_HEADS = {'H=16 KVH=16 D=128 (deepseek-moe-16b)': dict(kvh=16, g=1,
                                                          d=128),
             'H=64 KVH=8 D=64 (gpt-oss-20b)': dict(kvh=8, g=8, d=64)}
# bench-1b7's heads (G=5, the one group size that is not a power of
# two) at the GRPO rollout engine's shape (phase 29): 8 slots of 9
# blocks (max_len 130), prompts of 65 rows growing to 129; the planted
# faults go on the 120-row sequence (8 blocks, the last one partial).
# llama3-8b's heads on one rank of tensor=2 (phase 31): H=16, KVH=4, G=4.
TP_HEADS = dict(kvh=4, g=4, d=128)
TP_LABEL = 'H=16 KVH=4 D=128 (llama3-8b tensor=2 shard)'
# New tokens a request in phase 31: each decode step of two ranks sharing
# the card makes ~66 gloo collectives of ~2 ms each
# (ops/collectives_bench.py on the card), so its decode runs are short.
TP_NEW = 16
# Phase 31's batch engine: 4 prompts in bucket 256 + TP_NEW rows.
TP_DECODE = dict(TP_HEADS, b=4, t=256 + TP_NEW,
                 lengths=[257, 200, 256 + TP_NEW, 131], q_len=1)
GRPO_PAGED = dict(kvh=4, g=5, d=128, bs=16, bps=9, b=8,
                  lengths=[65, 72, 81, 96, 100, 113, 120, 129], q_len=1)
GRPO_FAULT_ROWS = 120


def check_paged(torch, pa):
    """Kernels 1-2 against their plain version at llama3-8b heads, each
    output held by head_err: B=8 mixed lengths (Q=1 and 5), the engine's
    B=4 shape, B=40 (Q=1 and 5), bf16 / fp32 / int8 pools, stale pool
    rows at +-1e4, D=64 and D=256; the MoE configs' heads (MOE_HEADS)
    at B=8 and B=4, Q=1 and 5; planted faults at B=8 Q=1 and the MoE
    heads' B=4 Q=1; bench-1b7's heads at the GRPO rollout engine's
    shape (GRPO_PAGED, bf16 Q=1, with planted faults); fully masked
    verify rows against the uniform mean. Returns the largest absolute
    error of each kernel."""
    llama, lengths8 = LLAMA_PAGED, LENGTHS8
    errors = {'paged_attention': 0.0, 'paged_attention_quant': 0.0}
    cases = []
    for pool in ('bf16', 'fp32', 'int8'):
        for q_len in (1, 5):
            cases.append((f'{pool} Q={q_len} B=8', pool,
                          dict(llama, b=8, lengths=lengths8, q_len=q_len),
                          False))
        cases.append((f'{pool} Q=1 B=4 (engine shape)', pool,
                      dict(llama, b=4, lengths=[1, 17, 1000, 2048],
                           q_len=1), False))
        for q_len in (1, 5):
            cases.append((f'{pool} Q={q_len} B=40', pool,
                          dict(llama, b=40, lengths=lengths8 * 5,
                               q_len=q_len), False))
        cases.append((f'{pool} Q=5 B=8 stale rows +-1e4', pool,
                      dict(llama, b=8, lengths=lengths8, q_len=5), True))
    cases.append(('bf16 D=64 H=64 KVH=8', 'bf16',
                  dict(kvh=8, g=8, d=64, bs=16, bps=128, b=8,
                       lengths=[1000] * 8, q_len=1), False))
    cases.append(('bf16 D=256 H=16 KVH=16', 'bf16',
                  dict(kvh=16, g=1, d=256, bs=16, bps=128, b=8,
                       lengths=[1000] * 8, q_len=1), False))
    # The MoE configs' heads: deepseek-moe-16b (G=1) and gpt-oss-20b
    # (D=64, G=8), at B=8 and at the continuous engine's 4 slots (the
    # split count of its decode steps).
    engine_q1 = set()
    for label, heads in MOE_HEADS.items():
        for pool in ('bf16', 'int8'):
            for q_len in (1, 5):
                cases.append((f'{pool} Q={q_len} B=8 {label}', pool,
                              dict(heads, bs=16, bps=128, b=8,
                                   lengths=lengths8, q_len=q_len), False))
                cases.append((f'{pool} Q={q_len} B=4 {label}', pool,
                              dict(heads, bs=16, bps=128, b=4,
                                   lengths=[1, 17, 1000, 2048],
                                   q_len=q_len), False))
            engine_q1.add(f'{pool} Q=1 B=4 {label}')
    # One rank's heads of llama3-8b at tensor=2, at the continuous
    # engine's 4 slots: decode and verify windows, fp and int8 pools.
    for pool in ('bf16', 'int8'):
        for q_len in (1, 5):
            cases.append((f'{pool} Q={q_len} B=4 {TP_LABEL}', pool,
                          dict(TP_HEADS, bs=16, bps=128, b=4,
                               lengths=[1, 17, 1000, 2048], q_len=q_len),
                          False))
        engine_q1.add(f'{pool} Q=1 B=4 {TP_LABEL}')
    grpo_label = 'bf16 Q=1 B=8 H=20 KVH=4 (GRPO rollouts)'
    cases.append((grpo_label, 'bf16', GRPO_PAGED, False))
    failed = []
    for seed, (label, pool, shape, poison) in enumerate(cases):
        c = make_case(torch, pool=pool, seed=seed, poison=poison, **shape)
        splits = pa._num_splits(shape['b'], shape['kvh'], shape['bps'])
        name = 'paged_attention_quant' if pool == 'int8' else \
            'paged_attention'
        before = pa.LAUNCHES[name]
        out = run_kernel(pa, c)
        torch.cuda.synchronize()
        ref = run_plain(pa, c)
        rel = head_err(torch, out, ref, c['nv'])
        keep = (c['nv'].long()[:, None] - (shape['q_len'] - 1) +
                torch.arange(shape['q_len'], device='cuda')) > 0
        finite = bool(torch.isfinite(out[keep]).all().item())
        ok = (finite and rel <= PAGED_TOL[pool] and
              pa.LAUNCHES[name] == before + 1)
        if label.endswith('Q=1 B=8') or label in engine_q1 or \
                label == grpo_label:
            faults = paged_faults(
                torch, pa, c, ref, shape['kvh'], shape['bs'], splits,
                GRPO_FAULT_ROWS if label == grpo_label else 1000)
            caught = {n: e > PAGED_TOL[pool] for n, e in faults.items()}
            log(f'[kernels] {label}: planted faults, head error ' +
                ', '.join(f'{n} {e:.3e}{"" if caught[n] else " MISSED"}'
                          for n, e in faults.items()))
            ok = ok and all(caught.values())
        masked = masked_rows_err(torch, c, out, shape['bs'])
        if masked is not None:
            plain_masked = masked_rows_err(torch, c, ref, shape['bs'])
            log(f'[kernels] {label}: fully masked rows vs the uniform mean '
                f'of the blocks read: kernel {masked:.3e}, plain '
                f'{plain_masked:.3e}')
            ok = ok and max(masked, plain_masked) <= PAGED_TOL[pool]
        abs_err = ((out.float() - ref.float()).abs() *
                   keep[..., None, None]).max().item()
        errors[name] = max(errors[name], abs_err)
        log(f'[kernels] {label}, {splits} split(s): head error {rel:.3e} '
            f'(limit {PAGED_TOL[pool]:g}), max abs {abs_err:.3e} '
            f'{"ok" if ok else "FAIL"}')
        if not ok:
            failed.append(label)
    if failed:
        raise AssertionError(f'paged kernels disagree with plain, or a '
                             f'planted fault passes the limit: {failed}')
    return errors


def phase_kernels(torch, pa, bw, flops_peak):
    """check_paged, then times: kernel, plain, SDPA and bound at B=8
    mixed Q=1; the kernel and bound at B=8 mixed Q=5 and B=128 mixed
    Q=1; the split study."""
    llama, lengths8 = LLAMA_PAGED, LENGTHS8
    errors = check_paged(torch, pa)
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8,
                        device='cuda')
    rows = {}
    for name, pool in (('paged_attention', 'bf16'),
                       ('paged_attention_quant', 'int8')):
        c = make_case(torch, pool=pool, seed=100,
                      **dict(llama, b=8, lengths=lengths8, q_len=1))
        ms = time_ms(torch, lambda: run_kernel(pa, c), flush)
        plain_ms = time_ms(torch, lambda: run_plain(pa, c), flush)
        library_ms = time_ms(torch, library_call(torch, c, 16), flush)
        bound_ms, bound_by = bound(c, 16, 128, bw, flops_peak)
        rows[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                          bound_ms=bound_ms, bound_by=bound_by,
                          max_abs_err=errors[name])
        log(f'[kernels] {name} B=8 mixed decode: kernel {ms:.4f} ms, '
            f'plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, '
            f'bound {bound_ms:.4f} ms ({bound_by}), '
            f'{100 * bound_ms / ms:.1f}% of bound')
        for label, shape in (('B=8 mixed Q=5', dict(b=8, lengths=lengths8,
                                                    q_len=5)),
                             ('B=128 mixed Q=1',
                              dict(b=128, lengths=lengths8 * 16, q_len=1))):
            c = make_case(torch, pool=pool, seed=101, **dict(llama, **shape))
            ms = time_ms(torch, lambda: run_kernel(pa, c), flush)
            bound_ms, bound_by = bound(c, 16, 128, bw, flops_peak)
            log(f'[kernels] {name} {label}: kernel {ms:.4f} ms, bound '
                f'{bound_ms:.4f} ms ({bound_by}), '
                f'{100 * bound_ms / ms:.1f}% of bound')
            del c
        for label, heads in MOE_HEADS.items():
            c = make_case(torch, pool=pool, seed=102, **dict(
                heads, bs=16, bps=128, b=8, lengths=lengths8, q_len=1))
            ms = time_ms(torch, lambda: run_kernel(pa, c), flush)
            plain_ms = time_ms(torch, lambda: run_plain(pa, c), flush)
            bound_ms, bound_by = bound(c, 16, heads['d'], bw, flops_peak)
            log(f'[kernels] {name} B=8 mixed Q=1 {label}: kernel '
                f'{ms:.4f} ms, plain {plain_ms:.4f} ms, bound '
                f'{bound_ms:.4f} ms ({bound_by}), '
                f'{100 * bound_ms / ms:.1f}% of bound')
            del c
    split_study(torch, pa, llama, lengths8, flush, bw, flops_peak)
    del flush
    return rows


def split_study(torch, pa, llama, lengths8, flush, bw, flops_peak):
    """Kernel time against the split count, bf16 pool, Q=1: at the
    engine's B=4 decode shape (its four prompts halfway through their 32
    new tokens) and at mixed lengths for B=8, 40 and 128; the bound
    beside each shape."""
    shapes = {'B=4 engine decode (22/57/167/417)': [22, 57, 167, 417],
              'B=8 mix': lengths8,
              'B=40 mix': lengths8 * 5,
              'B=128 mix': lengths8 * 16}
    for label, lengths in shapes.items():
        shape = dict(llama, b=len(lengths), lengths=lengths, q_len=1)
        c = make_case(torch, pool='bf16', seed=200, **shape)
        picked = pa._num_splits(shape['b'], shape['kvh'], shape['bps'])
        times = {s: time_ms(torch, lambda: run_kernel_splits(pa, c, s),
                            flush)
                 for s in sorted({1, 2, 3, 4, picked})}
        best = min(times, key=times.get)
        bound_ms, _ = bound(c, 16, 128, bw, flops_peak)
        log(f'[splits] {label}: bound {bound_ms:.4f} ms; picked {picked} '
            f'({times[picked]:.4f} ms), best {best} ({times[best]:.4f} ms); '
            f'ms by splits ' + json.dumps({str(s): t
                                           for s, t in times.items()}))
        del c


# ---------------------------------------------------------------------------
# Phase 4: decode-attention kernels vs plain
# ---------------------------------------------------------------------------

# Limits on the per-(sequence, head) normalized error (head_err). bf16
# rounds P (kernel and plain) and, for an int8 cache, the plain version
# rounds the dequantized V and P to bf16 where the kernel keeps fp32; a
# CPU run of the plain version at bf16 against fp32 reads 7e-3 to 9e-3 at
# the B=8 mixed shape. Planted faults (decode_faults) must exceed them.
DECODE_TOL = {'bf16': 2e-2, 'fp32': 1e-4, 'int8': 2e-2}


def decode_case(torch, *, b, kvh, g, d, t, lengths, q_len, cache, seed,
                poison=False):
    """Card tensors for one decode-attention call (public layout). With
    ``poison``, cache rows at and past n_valid hold +-1e4 (K +, V -)."""
    from skypilot_tpu_torch.models.decode import quantize_kv
    gen = torch.Generator(device='cuda')
    gen.manual_seed(seed)
    qdt = torch.float32 if cache == 'fp32' else torch.bfloat16
    k = torch.randn((b, t, kvh, d), generator=gen, device='cuda')
    v = torch.randn((b, t, kvh, d), generator=gen, device='cuda')
    q = torch.randn((b, q_len, kvh * g, d), generator=gen,
                    device='cuda').to(qdt)
    nv = torch.tensor(lengths, dtype=torch.int32, device='cuda')
    if poison:
        stale = (torch.arange(t, device='cuda')[None, :] >=
                 nv[:, None])[..., None, None]
        k = torch.where(stale, torch.full_like(k, 1e4), k)
        v = torch.where(stale, torch.full_like(v, -1e4), v)
    c = {'q': q, 'nv': nv, 'k_scale': None, 'v_scale': None}
    if cache == 'int8':
        c['k'], c['k_scale'] = quantize_kv(k.to(torch.bfloat16))
        c['v'], c['v_scale'] = quantize_kv(v.to(torch.bfloat16))
    else:
        c['k'], c['v'] = k.to(qdt), v.to(qdt)
    return c


def run_decode(da, c):
    return da.decode_attention(c['q'], c['k'], c['v'], c['nv'],
                               k_scale=c['k_scale'], v_scale=c['v_scale'])


def run_decode_plain(da, c, nv=None):
    return da.xla_decode_attention(c['q'], c['k'], c['v'],
                                   c['nv'] if nv is None else nv,
                                   c['k_scale'], c['v_scale'])


def head_err(torch, got, ref, nv) -> float:
    """The largest normalized error of one (sequence, head): max over
    (b, h) of max|got - ref| / max|ref| over its query rows and head
    dims, [B, Q, H, D]. Fully masked query rows (window positions with
    n_valid - (Q - 1 - j) <= 0, discarded by the caller) are left out."""
    q_len = ref.shape[1]
    limit = (nv.long()[:, None] - (q_len - 1) +
             torch.arange(q_len, device=nv.device)[None, :])
    keep = (limit > 0)[..., None, None]
    ref = ref.float()
    diff = ((got.float() - ref).abs() * keep).amax(dim=(1, 3))
    scale = (ref.abs() * keep).amax(dim=(1, 3)).clamp_min(1e-30)
    return (diff / scale).max().item()


def rows_left_out(torch, c, seq, start, stop):
    """The cache and lengths of a call in which sequence ``seq`` never
    had rows [start, stop): its later rows move up."""
    n = int(c['nv'][seq])
    left = dict(c, nv=c['nv'].clone())
    for key in ('k', 'v', 'k_scale', 'v_scale'):
        if c[key] is not None:
            left[key] = c[key].clone()
            left[key][seq, start:n - (stop - start)] = c[key][seq, stop:n]
    left['nv'][seq] = n - (stop - start)
    return left


def decode_faults(torch, da, c, ref, kvh):
    """Errors of faults the kernel could make, built from the plain
    output: one (sequence, kv head) left unwritten (sequence 1, or 0 at
    B=1; kv head 3); in the first sequence of 64 rows or more that ends
    inside a 16-row tile (n_valid 1000 at B=8, 257 at B=4 T=288, 205 at
    B=1) an interior
    tile skipped (the one at n_valid / 2: rows 496-511 or 128-143) and
    the last partial tile skipped; in the longest sequence (2048 or
    288) its second split's rows skipped (the cluster merge dropping a
    rank)."""
    unwritten = ref.clone()
    g = ref.shape[2] // kvh
    unwritten[min(1, ref.shape[0] - 1), :, 3 * g:4 * g] = 0
    lengths = c['nv'].tolist()
    part = next(i for i, n in enumerate(lengths) if n >= 64 and n % 16)
    mid = lengths[part] // 32 * 16
    interior = run_decode_plain(da, rows_left_out(torch, c, part, mid,
                                                  mid + 16))
    nv = c['nv'].clone()
    nv[part] = nv[part] // 16 * 16
    last = run_decode_plain(da, c, nv)
    b, t = c['k'].shape[:2]
    splits = da._num_splits(b, kvh, t)
    assert splits > 1, 'the split fault needs a call of several splits'
    longest = lengths.index(max(lengths))
    per = -(-lengths[longest] // 16 // splits) * 16
    split = run_decode_plain(da, rows_left_out(torch, c, longest, per,
                                               2 * per))
    return {'one (b, kv head) unwritten':
                head_err(torch, unwritten, ref, c['nv']),
            'interior tile skipped': head_err(torch, interior, ref,
                                              c['nv']),
            'last partial tile skipped': head_err(torch, last, ref,
                                                  c['nv']),
            f'split 1 of {splits} skipped': head_err(torch, split, ref,
                                                     c['nv'])}


def decode_masked_rows_err(torch, c, out):
    """Fully masked query rows (window positions j with n_valid - (Q - 1
    - j) <= 0) of sequences that hold rows: the largest error of the
    kernel's rows against the mean of the V rows it reads (below
    min(n_valid, T)), normalized per (sequence, head) by that mean's
    largest entry; inf if a row is not finite. None without such rows.
    (The plain version is uniform over all T rows instead: both are
    discarded by contract.)"""
    b, q_len, h, d = c['q'].shape
    t, kvh = c['k'].shape[1], c['k'].shape[2]
    worst = None
    for i, n in enumerate(c['nv'].tolist()):
        masked = [j for j in range(q_len) if n - (q_len - 1 - j) <= 0]
        if not masked or n <= 0:
            continue
        v = c['v'][i, :min(n, t)].float()                    # [N, KVH, D]
        if c['v_scale'] is not None:
            v = v * c['v_scale'][i, :min(n, t)][..., None]
        mean = v.mean(0).repeat_interleave(h // kvh, dim=0)  # [H, D]
        got = out[i, masked].float()                         # [M, H, D]
        if not bool(torch.isfinite(got).all()):
            return math.inf
        err = ((got - mean).abs().amax(dim=(0, 2)) /
               mean.abs().amax(dim=1).clamp_min(1e-30)).max().item()
        worst = err if worst is None else max(worst, err)
    return worst


def decode_bound(c, bw, flops_peak):
    """Least time for the work this call's data needs: the K/V rows below
    min(n_valid, T) (+ int8 scales), q, out and lengths, each moved once,
    against ~4 flops per (query row, key row, dim)."""
    b, q_len, h, d = c['q'].shape
    t, kvh = c['k'].shape[1], c['k'].shape[2]
    rows = sum(min(n, t) for n in c['nv'].tolist())
    kv_bytes = rows * kvh * d * 2 * c['k'].element_size()
    if c['k_scale'] is not None:
        kv_bytes += rows * kvh * 4 * 2
    q_bytes = c['q'].numel() * c['q'].element_size()
    nbytes = kv_bytes + 2 * q_bytes + 4 * b
    flops = 4 * rows * q_len * h * d
    bytes_ms = nbytes / bw * 1e3
    ops_ms = flops / flops_peak * 1e3
    return (max(bytes_ms, ops_ms),
            'bytes' if bytes_ms >= ops_ms else 'operations')


def decode_library_call(torch, c):
    """``F.scaled_dot_product_attention`` over the whole cache with a
    boolean window mask (query j attends pos < n_valid - (Q - 1 - j)),
    k/v repeated to all heads (an int8 cache dequantized to bf16 first):
    one library call computing the same decode function, timed as a
    yardstick."""
    import torch.nn.functional as F
    b, q_len, h, _ = c['q'].shape
    t, kvh = c['k'].shape[1], c['k'].shape[2]
    k, v = c['k'], c['v']
    if c['k_scale'] is not None:
        k = k.float() * c['k_scale'][..., None]
        v = v.float() * c['v_scale'][..., None]
    dt = c['q'].dtype
    g = h // kvh
    k = k.to(dt).repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
    v = v.to(dt).repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
    q = c['q'].transpose(1, 2).contiguous()
    limit = (c['nv'].long()[:, None] - (q_len - 1) +
             torch.arange(q_len, device='cuda')[None, :])        # [B, Q]
    mask = (torch.arange(t, device='cuda')[None, None, :] <
            limit[:, :, None])[:, None]                          # [B,1,Q,T]
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)


LENGTHS_B4_ENGINE = [257, 200, 288, 131]
DEEPSEEK_LABEL = 'H=16 KVH=16 D=128 (deepseek-moe-16b)'
DEEPSEEK_DECODE = dict(kvh=16, g=1, d=128)


def decode_timed_shapes(llama):
    """The shapes kernels 3-4 are timed at, the first one's times being
    the kernels line's."""
    return {'B=8 mixed T=2048 Q=1': dict(llama, b=8, t=2048,
                                         lengths=LENGTHS8, q_len=1),
            'B=4 T=288 (batch engine)': dict(llama, b=4, t=288,
                                             lengths=LENGTHS_B4_ENGINE,
                                             q_len=1),
            'B=8 mixed T=2048 Q=5': dict(llama, b=8, t=2048,
                                         lengths=LENGTHS8, q_len=5),
            'B=128 mixed T=2048 Q=1': dict(llama, b=128, t=2048,
                                           lengths=LENGTHS8 * 16, q_len=1)}


def phase_decode_kernels(torch, da, bw, flops_peak):
    """Kernels 3-4 against their plain version at llama3-8b heads: the
    paged kernels' B=8 mixed lengths at T=2048 (Q=1 and Q=5; bf16, fp32
    and int8), the batch engine's T=288, B=40 and B=128 (one split each),
    D=64 at T=300 and D=256, and caches whose stale rows hold +-1e4;
    deepseek-moe-16b's heads (G=1) at B=8 T=2048 and B=4 T=288; the
    batch engine's lone request (B=1 T=288); planted faults against the
    same limit; fully masked window rows
    against the mean of the rows read; then the times of
    ``decode_timed_shapes`` (bf16 and int8)."""
    llama = dict(kvh=8, g=4, d=128)
    cases = []
    for cache in ('bf16', 'fp32', 'int8'):
        for q_len in (1, 5):
            cases.append((f'{cache} Q={q_len} B=8 T=2048', cache,
                          dict(llama, b=8, t=2048, lengths=LENGTHS8,
                               q_len=q_len), False))
        cases.append((f'{cache} Q=1 B=4 T=288 (batch engine)', cache,
                      dict(llama, b=4, t=288, lengths=LENGTHS_B4_ENGINE,
                           q_len=1), False))
        # One request alone in the batch engine (phase 26).
        cases.append((f'{cache} Q=1 B=1 T=288 (batch engine, lone)', cache,
                      dict(llama, b=1, t=288, lengths=[205], q_len=1),
                      False))
        for q_len in (1, 5):
            cases.append((f'{cache} Q={q_len} B=8 T=2048 stale rows +-1e4',
                          cache, dict(llama, b=8, t=2048, lengths=LENGTHS8,
                                      q_len=q_len), True))
    for cache in ('bf16', 'int8'):
        for b in (40, 128):
            cases.append((f'{cache} Q=1 B={b} T=2048 mixed', cache,
                          dict(llama, b=b, t=2048,
                               lengths=LENGTHS8 * (b // 8), q_len=1),
                          False))
        cases.append((f'{cache} D=64 H=64 KVH=8 T=300', cache,
                      dict(kvh=8, g=8, d=64, b=8, t=300,
                           lengths=[1, 31, 33, 64, 65, 200, 299, 300],
                           q_len=1), False))
    cases.append(('bf16 D=256 H=16 KVH=16 T=1000', 'bf16',
                  dict(kvh=16, g=1, d=256, b=8, t=1000,
                       lengths=[1, 31, 33, 64, 65, 200, 999, 1000],
                       q_len=5), False))
    # deepseek-moe-16b's heads: G=1, at B=8 and at the batch engine's
    # B=4 T=288 (its split count).
    for cache in ('bf16', 'int8'):
        for q_len in (1, 5):
            cases.append((f'{cache} Q={q_len} B=8 T=2048 {DEEPSEEK_LABEL}',
                          cache, dict(DEEPSEEK_DECODE, b=8, t=2048,
                                      lengths=LENGTHS8, q_len=q_len),
                          False))
        cases.append((f'{cache} Q=1 B=4 T=288 {DEEPSEEK_LABEL}', cache,
                      dict(DEEPSEEK_DECODE, b=4, t=288,
                           lengths=LENGTHS_B4_ENGINE, q_len=1), False))
    # One rank's heads of llama3-8b at tensor=2 (phase 31's batch engine).
    for cache in ('bf16', 'int8'):
        cases.append((f'{cache} Q=1 B=4 T={TP_DECODE["t"]} {TP_LABEL}',
                      cache, TP_DECODE, False))
    errors = {'decode_attention': 0.0, 'decode_attention_quant': 0.0}
    failed = []
    for seed, (label, cache, shape, poison) in enumerate(cases):
        c = decode_case(torch, cache=cache, seed=300 + seed, poison=poison,
                        **shape)
        name = ('decode_attention_quant' if cache == 'int8' else
                'decode_attention')
        splits = da._num_splits(shape['b'], shape['kvh'], shape['t'])
        before = da.LAUNCHES[name]
        out = run_decode(da, c)
        torch.cuda.synchronize()
        ref = run_decode_plain(da, c)
        rel = head_err(torch, out, ref, c['nv'])
        finite = bool(torch.isfinite(out).all().item())
        ok = (finite and rel <= DECODE_TOL[cache] and
              da.LAUNCHES[name] == before + 1)
        if shape['q_len'] == 1 and (label.endswith('B=8 T=2048') or
                                    label.endswith(f'B=4 T=288 '
                                                   f'{DEEPSEEK_LABEL}') or
                                    label.endswith(TP_LABEL) or
                                    label.endswith('(batch engine, lone)')):
            faults = decode_faults(torch, da, c, ref, shape['kvh'])
            caught = {n: e > DECODE_TOL[cache] for n, e in faults.items()}
            log(f'[decode] {label}: planted faults, head error ' +
                ', '.join(f'{n} {e:.3e}{"" if caught[n] else " MISSED"}'
                          for n, e in faults.items()))
            ok = ok and all(caught.values())
        masked = decode_masked_rows_err(torch, c, out)
        if masked is not None:
            log(f'[decode] {label}: fully masked rows vs the uniform mean '
                f'of the rows read: {masked:.3e}')
            ok = ok and masked <= DECODE_TOL[cache]
        keep = (c['nv'].long()[:, None] - (shape['q_len'] - 1) +
                torch.arange(shape['q_len'], device='cuda')) > 0
        abs_err = ((out.float() - ref.float()).abs() *
                   keep[..., None, None]).max().item()
        errors[name] = max(errors[name], abs_err)
        log(f'[decode] {label}, {splits} split(s): head error {rel:.3e} '
            f'(limit {DECODE_TOL[cache]:g}), max abs {abs_err:.3e} '
            f'{"ok" if ok else "FAIL"}')
        if not ok:
            failed.append(label)
        del c, out, ref
    if failed:
        raise AssertionError(f'decode kernels disagree with plain, or a '
                             f'planted fault passes the limit: {failed}')

    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8,
                        device='cuda')
    rows = {}
    for name, cache in (('decode_attention', 'bf16'),
                        ('decode_attention_quant', 'int8')):
        for label, shape in decode_timed_shapes(llama).items():
            c = decode_case(torch, cache=cache, seed=400, **shape)
            ms = time_ms(torch, lambda: run_decode(da, c), flush)
            plain_ms = time_ms(torch, lambda: run_decode_plain(da, c), flush)
            library_ms = time_ms(torch, decode_library_call(torch, c), flush)
            bound_ms, bound_by = decode_bound(c, bw, flops_peak)
            if name not in rows:
                rows[name] = dict(ms=ms, plain_ms=plain_ms,
                                  library_ms=library_ms, bound_ms=bound_ms,
                                  bound_by=bound_by,
                                  max_abs_err=errors[name])
            log(f'[decode] {name} {label}: kernel {ms:.4f} ms, plain '
                f'{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound '
                f'{bound_ms:.4f} ms ({bound_by}), '
                f'{100 * bound_ms / ms:.1f}% of bound')
            del c
        c = decode_case(torch, cache=cache, seed=401, **dict(
            DEEPSEEK_DECODE, b=8, t=2048, lengths=LENGTHS8, q_len=1))
        ms = time_ms(torch, lambda: run_decode(da, c), flush)
        plain_ms = time_ms(torch, lambda: run_decode_plain(da, c), flush)
        bound_ms, bound_by = decode_bound(c, bw, flops_peak)
        log(f'[decode] {name} B=8 mixed T=2048 Q=1 {DEEPSEEK_LABEL}: '
            f'kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound '
            f'{bound_ms:.4f} ms ({bound_by}), '
            f'{100 * bound_ms / ms:.1f}% of bound')
        del c
    del flush
    return rows


# ---------------------------------------------------------------------------
# Phase 5: flash-attention kernels vs plain
# ---------------------------------------------------------------------------

# Limits on the tile error (tile_err) of each output, (o and lse,
# gradients) per input type. bench.py:_kernels_smoke's absolute 2e-2 /
# 2e-1 for bf16 passed an all-zero dq; these sit between the readings on
# sound kernels and the errors of planted faults (planted_faults), which
# must exceed them.
FLASH_TOL = {'bf16': (5e-2, 5e-2), 'fp32': (1e-4, 1e-4)}
# The dq kernel's delta against the plain ``_delta``: fp32 sums of the
# same products in another order, in either input type.
DELTA_TOL = 1e-4


def norm_err(got, ref) -> float:
    """max|got - ref| / max|ref|, in fp32."""
    ref = ref.float()
    return ((got.float() - ref).abs().max() / ref.abs().max()).item()


def tile_err(got, ref) -> float:
    """The largest normalized error of any 64-row tile of one head: max
    over (batch, head, tile) of max|got - ref| / max|ref| within it, for
    [B, S, H, D] outputs and [B, H, S] lse. A tile a kernel left
    unwritten reads 1, however small its values."""
    if ref.dim() == 4:
        b, s, h, d = ref.shape
        shape, dims = (b, s // 64, 64, h, d), (2, 4)
    else:
        b, h, s = ref.shape
        shape, dims = (b, h, s // 64, 64), (3,)
    ref = ref.float()
    diff = (got.float() - ref).abs().reshape(shape).amax(dims)
    scale = ref.abs().reshape(shape).amax(dims).clamp_min(1e-30)
    return (diff / scale).max().item()


def flash_case(torch, *, b, s, h, kvh, d, dtype, segments, seed):
    """Card tensors for one flash call in the model layout; segments are
    documents of random lengths per row, numbered in order, or with
    ``segments='permuted'`` renumbered by a random permutation per row
    (ids that do not increase along a row)."""
    gen = torch.Generator(device='cuda')
    gen.manual_seed(seed)
    dt = torch.float32 if dtype == 'fp32' else torch.bfloat16
    q, do = (torch.randn((b, s, h, d), generator=gen, device='cuda')
             .to(dt) for _ in range(2))
    k, v = (torch.randn((b, s, kvh, d), generator=gen, device='cuda')
            .to(dt) for _ in range(2))
    seg = None
    if segments:
        starts = torch.rand((b, s), generator=gen, device='cuda') < 1 / 300
        seg = torch.cumsum(starts.int(), dim=1).to(torch.int32).contiguous()
        if segments == 'permuted':
            perm = torch.stack([torch.randperm(s + 1, generator=gen,
                                               device='cuda')
                                for _ in range(b)]).to(torch.int32)
            seg = torch.gather(perm, 1, seg.long()).contiguous()
    return q, k, v, do, seg


def flash_bound(b, s, h, kvh, d, itemsize, which, bw, flops_peak,
                pairs=None, seg=False):
    """Least time for one call: FLOPs (2, 3 or 4 products of 2*H*D per
    (query, key) pair the mask keeps; ``pairs`` defaults to the causal
    B*S^2/2) at the bf16 peak against the bytes of each input read once
    and each output written once (dq reads o and do and writes dq and
    delta; segment ids add 4 bytes a position)."""
    qb = b * s * h * d * itemsize
    kvb = b * s * kvh * d * itemsize
    stat = b * h * s * 4
    if pairs is None:
        pairs = b * s * s / 2
    products = {'fwd': 2, 'dq': 3, 'dkv': 4}[which]
    flops = products * 2 * h * d * pairs
    nbytes = {'fwd': qb + 2 * kvb + qb + stat,
              'dq': 3 * qb + 2 * kvb + stat + qb + stat,
              'dkv': 2 * qb + 2 * kvb + 2 * stat + 2 * kvb}[which]
    if seg:
        nbytes += b * s * 4
    bytes_ms = nbytes / bw * 1e3
    ops_ms = flops / flops_peak * 1e3
    return (max(bytes_ms, ops_ms),
            'bytes' if bytes_ms >= ops_ms else 'operations')


# A delta off by this constant (about the mean |delta| at the trainer's
# causal shape) must move dq and dk past the gradient limit.
DELTA_FAULT = 1.0


def plain_rows_without(torch, fa, q, k, v, causal, seg, rows, keys):
    """The plain forward's o and lse with query rows ``rows`` of batch 0,
    head 0 recomputed as if the keys ``keys`` were left out too: what a
    forward kernel that skipped that key tile for that q tile would
    write."""
    d = q.shape[-1]
    dev = q.device
    qr = q[0, rows, 0].float() * d ** -0.5
    sc = qr @ k[0, :, 0].float().T
    pos_q = torch.arange(rows.start, rows.stop, device=dev)
    keep = torch.ones_like(sc, dtype=torch.bool)
    if causal:
        keep &= pos_q[:, None] >= torch.arange(k.shape[1], device=dev)
    if seg is not None:
        keep &= seg[0, rows][:, None] == seg[0][None, :]
    keep[:, keys] = False
    sc = torch.where(keep, sc, fa.NEG_INF)
    m = sc.amax(-1, keepdim=True)
    p = torch.exp(sc - m)
    l_safe = p.sum(-1, keepdim=True).clamp_min(1e-30)
    o_rows = (p.to(v.dtype).float() @ v[0, :, 0].float()) / l_safe
    return o_rows, (m + torch.log(l_safe))[:, 0]


def shared_key_tile(torch, causal, seg, rows):
    """The 64-key tile that holds the most (query, key) pairs the mask
    keeps for query rows ``rows`` of batch 0: one a segment tile skip
    must not drop."""
    s = seg.shape[1]
    pos = torch.arange(s, device=seg.device)
    keep = seg[0, rows][:, None] == seg[0][None, :]
    if causal:
        keep &= pos[rows][:, None] >= pos[None, :]
    kt = int(keep.reshape(keep.shape[0], s // 64, 64).sum((0, 2)).argmax())
    return slice(64 * kt, 64 * kt + 64)


def planted_faults(torch, fa, q, k, v, do, causal, seg, ro, rlse, rgrads):
    """The tile errors of faults a kernel could make, each built
    from the plain outputs: one CTA's 64 rows left unwritten (o, dq, dk,
    dv; batch 0, head 0, rows 1024-1087, or the last 64 of a shorter
    sequence), the forward skipping one key tile for those rows (keys
    64-127, or the only one; with segments the tile that shares the most
    pairs with them, as a tile skip that misjudged the ids would), the
    dq kernel skipping one key tile of one head, the dk/dv kernel
    dropping one query head of its group, and delta off by DELTA_FAULT
    (dq, dk). Each must exceed the check's limit."""
    rdq, rdk, rdv = rgrads
    s = q.shape[1]
    first = min(1024, s - 64)
    rows = slice(first, first + 64)

    def unwritten(ref):
        bad = ref.clone()
        bad[0, rows, 0] = 0
        return tile_err(bad, ref)

    p, ds, qg, dog = fa._probs(q, k, v, ro, rlse, do, causal, seg)
    bad_ds = ds - DELTA_FAULT * p
    dq_delta = fa._dq(bad_ds, q, k)
    dk_delta, _ = fa._dkv(p, bad_ds, qg, dog, k, v)
    del p, qg, dog, bad_ds
    skipped = min(64, s - 64)
    keys = slice(skipped, skipped + 64)

    def forward_without(keys):
        bad = ro.clone()
        bad[0, rows, 0] = plain_rows_without(torch, fa, q, k, v, causal,
                                             seg, rows, keys)[0].to(ro.dtype)
        return tile_err(bad, ro)

    if seg is None:
        forward = {'o: one key tile skipped': forward_without(keys)}
    else:  # keys 64-127 may share no document with those rows
        forward = {'o: a document tile skipped wrongly': forward_without(
            shared_key_tile(torch, causal, seg, rows))}
    ds[0, 0, 0, :, keys] = 0
    dq_skip = fa._dq(ds, q, k)
    del ds
    do_drop = do.clone()
    do_drop[0, :, 0] = 0
    dk_drop, dv_drop = fa.flash_dkv_reference(q, k, v, ro, rlse, do_drop,
                                              causal=causal,
                                              segment_ids=seg)
    return {'o: one q tile unwritten': unwritten(ro), **forward,
            'dq: one q tile unwritten': unwritten(rdq),
            'dq: one key tile skipped': tile_err(dq_skip, rdq),
            'dq: delta off': tile_err(dq_delta, rdq),
            'dk: one k tile unwritten': unwritten(rdk),
            'dv: one k tile unwritten': unwritten(rdv),
            'dk: one group head dropped': tile_err(dk_drop, rdk),
            'dv: one group head dropped': tile_err(dv_drop, rdv),
            'dk: delta off': tile_err(dk_delta, rdk)}


def flash_cases():
    """(label, shape, dtype, causal, segments) of phase 5: bench-1b7's
    attention (B=2) both ways, with segment ids permuted per row, D=256,
    the batch engine's prefill at llama3-8b's and deepseek-moe-16b's
    heads, its lone request (B=1), the LoRA finetune's B=4 S=512, the
    MoE train steps' shape, the GRPO learner's B=8 S=128, and the
    pipeline's edge shapes:
    S=64 (one
    tile: the ring's prologue and epilogue only) and S=192 (three tiles,
    no multiple of the two stages; the forward's 64-row CTA), GQA groups
    of 1 and 8."""
    shape = dict(b=2, s=2048, h=20, kvh=4, d=128)   # bench-1b7 attention
    cases = [(f'{dtype} {"causal" if causal else "full"}'
              f'{" seg" if segments else ""}', shape, dtype, causal,
              segments)
             for dtype in ('bf16', 'fp32') for causal in (True, False)
             for segments in (False, True)]
    # Segment ids that do not increase along a row: the forward's tile
    # skip must hold for any order of the ids.
    for causal in (True, False):
        cases.append((f'bf16 {"causal" if causal else "full"} seg, ids '
                      f'permuted per row', shape, 'bf16', causal,
                      'permuted'))
    cases.append(('bf16 causal seg D=256 H=KVH=16',
                  dict(b=2, s=2048, h=16, kvh=16, d=256), 'bf16', True,
                  True))
    # The batch engine's prefill (phase 12) and embed_text: llama3-8b
    # heads, four prompts in bucket 256.
    cases.append(('bf16 causal B=4 S=256 H=32 KVH=8 (batch-engine prefill)',
                  dict(b=4, s=256, h=32, kvh=8, d=128), 'bf16', True,
                  False))
    # The batch engine serving one request at a time (phase 26: batch
    # bucket 1, prompt bucket 256) and the LoRA finetune's steps
    # (phase 27: B=4 S=512).
    cases.append(('bf16 causal B=1 S=256 H=32 KVH=8 (batch-engine lone '
                  'prefill)', dict(b=1, s=256, h=32, kvh=8, d=128), 'bf16',
                  True, False))
    cases.append(('bf16 causal B=4 S=512 H=32 KVH=8 (finetune)',
                  dict(b=4, s=512, h=32, kvh=8, d=128), 'bf16', True,
                  False))
    # The GRPO learner's steps (phase 29: 2 prompts x 4 rollouts of
    # 65 + 64 tokens) at bench-1b7's heads.
    cases.append(('bf16 causal B=8 S=128 H=20 KVH=4 (GRPO learner)',
                  dict(b=8, s=128, h=20, kvh=4, d=128), 'bf16', True,
                  False))
    # One rank's heads of llama3-8b at tensor=2: the batch engine's
    # prefill under the mesh (phase 31).
    cases.append(('bf16 causal B=4 S=256 H=16 KVH=4 (tensor=2 batch-engine '
                  'prefill)', dict(b=4, s=256, h=16, kvh=4, d=128), 'bf16',
                  True, False))
    # deepseek-moe-16b's heads (G=1): its batch-engine prefill (phase 22)
    # and its train steps (phase 25).
    cases.append(('bf16 causal B=4 S=256 H=16 KVH=16 (MoE batch prefill)',
                  dict(b=4, s=256, h=16, kvh=16, d=128), 'bf16', True,
                  False))
    cases.append(('bf16 causal B=4 S=1024 H=16 KVH=16 (MoE train)',
                  dict(b=4, s=1024, h=16, kvh=16, d=128), 'bf16', True,
                  False))
    for dtype in ('bf16', 'fp32'):
        for s, h, kvh, causal, segments in ((64, 8, 8, True, True),
                                            (64, 16, 2, False, False),
                                            (192, 16, 2, True, False),
                                            (192, 8, 8, False, True)):
            cases.append((f'{dtype} {"causal" if causal else "full"}'
                          f'{" seg" if segments else ""} S={s} '
                          f'G={h // kvh} (edge)',
                          dict(b=2, s=s, h=h, kvh=kvh, d=128), dtype,
                          causal, segments))
    return cases


def phase_flash_kernels(torch, fa, bw, flops_peak):
    """Each kernel against its plain version on the same card tensors
    (o, lse, dq, dk, dv; tile error against FLASH_TOL; the dq kernel's
    delta against the plain one) at the trainer's attention shape, the
    batch engine's prefill shape and the pipeline's edge shapes; a
    second backward must give bitwise the same dq, dk and dv; planted
    faults against the same limits; then times at the trainer's
    shape."""
    errors = {'flash_fwd': 0.0, 'flash_dq': 0.0, 'flash_dkv': 0.0}
    failed = []
    for seed, (label, shp, dtype, causal, segments) in enumerate(
            flash_cases()):
        q, k, v, do, seg = flash_case(torch, dtype=dtype,
                                      segments=segments, seed=seed, **shp)
        o, lse = fa.flash_forward_kernel(q, k, v, causal=causal,
                                         segment_ids=seg)
        dq, dk, dv = fa.flash_backward_kernel(q, k, v, o, lse, do,
                                              causal=causal,
                                              segment_ids=seg)
        dq2, delta = fa.flash_dq_kernel(q, k, v, o, lse, do, causal=causal,
                                        segment_ids=seg)
        dk2, dv2 = fa.flash_dkv_kernel(q, k, v, lse, do, delta,
                                       causal=causal, segment_ids=seg)
        torch.cuda.synchronize()
        same = all(torch.equal(x, y)
                   for x, y in ((dq, dq2), (dk, dk2), (dv, dv2)))
        delta_err = tile_err(delta, fa._delta(o, do))
        ro, rlse = fa.flash_forward_reference(q, k, v, causal=causal,
                                              segment_ids=seg)
        rgrads = fa.flash_backward_reference(
            q, k, v, ro, rlse, do, causal=causal, segment_ids=seg)
        got = (('o', o, ro), ('lse', lse, rlse)) + tuple(
            zip(('dq', 'dk', 'dv'), (dq, dk, dv), rgrads))
        ok = compare_flash(torch, label, dtype, got, errors)
        log(f'[flash] {label}: delta tile error {delta_err:.3e} (limit '
            f'{DELTA_TOL:g}); second backward bitwise '
            f'{"equal" if same else "DIFFERENT"}')
        ok = ok and same and delta_err <= DELTA_TOL
        if dtype == 'bf16':
            faults = planted_faults(torch, fa, q, k, v, do, causal, seg, ro,
                                    rlse, rgrads)
            fwd_tol, grad_tol = FLASH_TOL[dtype]
            caught = {n: e > (fwd_tol if n.startswith('o:') else grad_tol)
                      for n, e in faults.items()}
            log(f'[flash] {label}: planted faults, tile error ' +
                ', '.join(f'{n} {e:.3e}{"" if caught[n] else " MISSED"}'
                          for n, e in faults.items()))
            ok = ok and all(caught.values())
        if not ok:
            failed.append(label)
        del q, k, v, do, o, lse, dq, dk, dv, dq2, dk2, dv2, delta, ro, rlse
        del rgrads, got
    rows = flash_times(torch, fa, errors, bw, flops_peak, failed)
    if failed:
        raise AssertionError(f'flash kernels disagree with plain, or a '
                             f'planted fault passes the limit: {failed}')
    return rows


def compare_flash(torch, label, dtype, got, errors) -> bool:
    """Log each output's tile error and absolute error; fold them into
    ``errors`` (max abs per kernel); True when all are within FLASH_TOL
    and finite."""
    fwd_tol, grad_tol = FLASH_TOL[dtype]
    rel = {n: tile_err(x, r) for n, x, r in got}
    err = {n: (x.float() - r.float()).abs().max().item() for n, x, r in got}
    finite = all(bool(torch.isfinite(x).all().item()) for _, x, _ in got)
    ok = finite and all(e <= (fwd_tol if n in ('o', 'lse') else grad_tol)
                        for n, e in rel.items())
    for kernel, names in (('flash_fwd', ('o', 'lse')), ('flash_dq', ('dq',)),
                          ('flash_dkv', ('dk', 'dv'))):
        errors[kernel] = max([errors[kernel]] + [err[n] for n in names])
    log(f'[flash] {label}: tile error ' +
        ', '.join(f'{n} {e:.3e}' for n, e in rel.items()) +
        f' (limits {fwd_tol:g} / {grad_tol:g}); max abs ' +
        ', '.join(f'{n} {e:.3e}' for n, e in err.items()) +
        f' {"ok" if ok else "FAIL"}')
    return ok


def packed_segments(torch, b, s):
    """Segment ids of documents of mean length 500, like phase 18's token
    file: a new document starts at each position with probability
    1/500."""
    gen = torch.Generator().manual_seed(3)
    starts = torch.rand((b, s), generator=gen) < 1 / 500
    return torch.cumsum(starts.int(), 1).int().cuda()


def sdpa_call(torch, q, k, v, do, seg):
    """``F.scaled_dot_product_attention`` on the same inputs (k/v
    repeated over the group, [B, H, S, D]): the flash backend with
    ``is_causal``, or with segment ids the efficient backend with the
    boolean causal-and-same-segment mask. A yardstick the port never
    calls. Returns (forward, backward) thunks."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    g = q.shape[2] // k.shape[2]
    qs, ks, vs = (x.transpose(1, 2).contiguous().requires_grad_(True)
                  for x in (q, k.repeat_interleave(g, dim=2),
                            v.repeat_interleave(g, dim=2)))
    kwargs = dict(is_causal=True)
    backend = SDPBackend.FLASH_ATTENTION
    if seg is not None:
        s = q.shape[1]
        pos = torch.arange(s, device='cuda')
        kwargs = dict(attn_mask=((pos[:, None] >= pos[None, :]) &
                                 (seg[:, :, None] == seg[:, None, :]))
                      [:, None])
        backend = SDPBackend.EFFICIENT_ATTENTION

    def forward():
        with sdpa_kernel(backend):
            return F.scaled_dot_product_attention(qs, ks, vs, **kwargs)

    out = forward()
    dos = do.transpose(1, 2).contiguous()

    def backward():
        torch.autograd.grad(out, (qs, ks, vs), dos, retain_graph=True)
    return forward, backward


def flash_timings(torch, fa, q, k, v, do, seg, flush):
    """Median times (ms) at one shape: each kernel (dq with its delta),
    the whole backward, each plain version, the torch delta chain, and
    SDPA's forward and backward."""
    kw = dict(segment_ids=seg)
    o, lse = fa.flash_forward_kernel(q, k, v, **kw)
    _, delta = fa.flash_dq_kernel(q, k, v, o, lse, do, **kw)
    sdpa_fwd, sdpa_bwd = sdpa_call(torch, q, k, v, do, seg)
    thunks = {
        'flash_fwd': lambda: fa.flash_forward_kernel(q, k, v, **kw),
        'flash_dq': lambda: fa.flash_dq_kernel(q, k, v, o, lse, do, **kw),
        'flash_dkv': lambda: fa.flash_dkv_kernel(q, k, v, lse, do, delta,
                                                 **kw),
        'backward': lambda: fa.flash_backward_kernel(q, k, v, o, lse, do,
                                                     **kw),
        'plain flash_fwd': lambda: fa.flash_forward_reference(q, k, v,
                                                              **kw),
        'plain flash_dq': lambda: fa.flash_dq_reference(q, k, v, o, lse, do,
                                                        **kw),
        'plain flash_dkv': lambda: fa.flash_dkv_reference(q, k, v, o, lse,
                                                          do, **kw),
        'torch delta': lambda: fa._delta(o, do),
        'sdpa fwd': sdpa_fwd,
        'sdpa bwd': sdpa_bwd,
    }
    return {name: time_ms(torch, fn, flush) for name, fn in thunks.items()}


def flash_times(torch, fa, errors, bw, flops_peak, failed):
    """At the trainer's shape (bench-1b7, B=8, S=2048, bf16, causal): the
    kernels' outputs against the plain ones (a failure joins
    ``failed``), then the times of each kernel, its plain version, SDPA
    (a yardstick the port never calls) and the bound; again with packed
    documents (the ``_seg`` twins, kernels 6, 8 and 10, whose bound
    counts the pairs the segment mask keeps). Returns (a row per kernel,
    the whole backward's ms)."""
    shp = dict(b=8, s=2048, h=20, kvh=4, d=128)
    q, k, v, do, _ = flash_case(torch, dtype='bf16', segments=False,
                                seed=99, **shp)
    o, lse = fa.flash_forward_kernel(q, k, v)
    grads = fa.flash_backward_kernel(q, k, v, o, lse, do)
    ro, rlse = fa.flash_forward_reference(q, k, v)
    rgrads = fa.flash_backward_reference(q, k, v, ro, rlse, do)
    label = 'bf16 causal B=8 (trainer shape)'
    got = (('o', o, ro), ('lse', lse, rlse)) + tuple(
        zip(('dq', 'dk', 'dv'), grads, rgrads))
    if not compare_flash(torch, label, 'bf16', got, errors):
        failed.append(label)
    del o, lse, grads, ro, rlse, rgrads, got
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8,
                        device='cuda')
    seg = packed_segments(torch, shp['b'], shp['s'])
    lengths = torch.unique_consecutive(
        seg + 10 ** 6 * torch.arange(shp['b'], device='cuda')[:, None],
        return_counts=True)[1].double()
    seg_pairs = (lengths * (lengths + 1) / 2).sum().item()
    times = {'': flash_timings(torch, fa, q, k, v, do, None, flush),
             'seg': flash_timings(torch, fa, q, k, v, do, seg, flush)}
    del flush
    rows = {}
    for name, which in (('flash_fwd', 'fwd'), ('flash_dq', 'dq'),
                        ('flash_dkv', 'dkv')):
        for variant, t in times.items():
            seg_on = variant == 'seg'
            bound_ms, bound_by = flash_bound(
                itemsize=2, which=which, bw=bw, flops_peak=flops_peak,
                pairs=seg_pairs if seg_on else None, seg=seg_on, **shp)
            lib = 'sdpa fwd' if which == 'fwd' else 'sdpa bwd'
            row = dict(ms=t[name], plain_ms=t['plain ' + name],
                       library_ms=t[lib] if which == 'fwd' else None,
                       bound_ms=bound_ms, bound_by=bound_by)
            if which != 'fwd':
                # SDPA's backward computes dq, dk and dv in one call: no
                # library call computes dq or dk/dv alone.
                row['library_bwd_ms'] = t[lib]
            if seg_on:
                rows[name]['seg'] = row
            else:
                rows[name] = dict(row, max_abs_err=errors[name])
            log(f'[flash] {name}{"_seg" if seg_on else ""} B=8 S=2048 H=20 '
                f'KVH=4 bf16 causal{" packed documents" if seg_on else ""}'
                f': kernel {t[name]:.4f} ms, plain '
                f'{t["plain " + name]:.4f} ms, bound {bound_ms:.4f} ms '
                f'({bound_by}), {100 * bound_ms / t[name]:.1f}% of bound; '
                f'SDPA {lib} {t[lib]:.4f} ms')
    for variant, t in times.items():
        log(f'[flash] {variant or "causal"}: backward (dq with delta + dkv)'
            f' {t["backward"]:.4f} ms vs SDPA backward {t["sdpa bwd"]:.4f} '
            f'ms; forward {t["flash_fwd"]:.4f} ms vs SDPA forward '
            f'{t["sdpa fwd"]:.4f} ms; the torch delta chain the dq kernel '
            f'replaces {t["torch delta"]:.4f} ms')
    log(f'[flash] packed documents: {lengths.numel()} documents, '
        f'{seg_pairs:.0f} kept (query, key) pairs = '
        f'{100 * seg_pairs / (shp["b"] * shp["s"] ** 2 / 2):.1f}% of causal')
    floor = smem_floor_ms(torch, **shp)
    log(f'[flash] causal: shared-memory operand reads alone take at '
        f'least {floor["fwd"]:.4f} ms (forward, wgmma; kernel '
        f'{times[""]["flash_fwd"]:.4f} ms), {floor["dq"]:.4f} ms (dq, '
        f'ldmatrix) and {floor["dkv"]:.4f} ms (dk/dv, ldmatrix)')
    return rows, times['']['backward']


def smem_floor_ms(torch, b, s, h, kvh, d):
    """The least time (ms) in which the bf16 kernels can read their
    matrix operands from shared memory in one causal call at D=128, at
    128 bytes a clock per SM at the card's top SM clock, under the
    tiling of csrc/flash_attention.cu. Forward (wgmma): each warpgroup
    of a 128-row CTA reads, for each 128-key tile it visits, its 64 Q
    rows (A of q k^T) and the K and V tiles (B of q k^T and of p v):
    (64 + 2 * 128) * D * 2 bytes. The backward's ldmatrix.x4 loads (512
    bytes each): dq, 4 warps of two m16 tiles per 128-row CTA, 32-key
    tiles, 80 loads a warp a tile (per k16 step 4 A and 4 B for s and
    dp; 8 B for ds.k per 16 keys); dk/dv, 4 warps of 16 keys, 64-query
    steps, 144 loads a warp a step (16 A, 32 B for each of s^T, dv, dp^T
    and dk)."""
    fwd_tiles = 2 * sum(i + 1 for i in range(s // 128))
    dq_tiles = 4 * sum(4 * (i + 1) for i in range(s // 128))
    dkv_steps = 4 * (h // kvh) * sum(s // 64 - i for i in range(s // 64))
    nbytes = {'fwd': (64 + 2 * 128) * d * 2 * fwd_tiles * b * h,
              'dq': 512 * 80 * dq_tiles * b * h,
              'dkv': 512 * 144 * dkv_steps * b * kvh}
    clock = float(subprocess.run(
        ['nvidia-smi', '--query-gpu=clocks.max.sm',
         '--format=csv,noheader,nounits'], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0]) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return {n: x / (128 * sms * clock) * 1e3 for n, x in nbytes.items()}


# ---------------------------------------------------------------------------
# Phases 6-7: training
# ---------------------------------------------------------------------------

def _copy_params(tree, device):
    if isinstance(tree, dict):
        return {k: _copy_params(v, device) for k, v in tree.items()}
    return tree.detach().clone().to(device)


def phase_train_small(torch):
    """TINY with head_dim 128 and fp32 compute: three train steps on the
    card (kernel path) and on the CPU (plain path) from the same params
    and batches; losses and grad norms agree to 1e-4 relative."""
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.models.config import get_model_config
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.train import step as st
    from skypilot_tpu_torch.train.pretrain import synthetic_batch
    cfg = get_model_config('tiny', head_dim=128,
                           compute_dtype=torch.float32)
    hp = st.TrainHParams(warmup_steps=1, total_steps=10)
    params = llama.init_params(5, cfg, device='cpu')
    metrics = {}
    for device in ('cuda', 'cpu'):
        state = st.create_train_state_from_params(
            _copy_params(params, device), cfg, hp)
        step_fn = st.make_train_step(cfg, hp)
        before = fa.LAUNCHES['flash_fwd']
        out = []
        for i in range(3):
            batch = synthetic_batch(i, 2, 128, cfg.vocab_size, device)
            state, m = step_fn(state, batch)
            out.append((float(m['loss']), float(m['grad_norm'])))
        metrics[device] = out
        if device == 'cuda' and fa.LAUNCHES['flash_fwd'] - before != 6:
            raise AssertionError('the small card run missed the kernels')
    log(f'[train-small] card (loss, grad_norm) {metrics["cuda"]}; '
        f'CPU {metrics["cpu"]}')
    for (l1, g1), (l2, g2) in zip(metrics['cuda'], metrics['cpu']):
        if abs(l1 - l2) > 1e-4 * abs(l2) or abs(g1 - g2) > 1e-4 * abs(g2):
            raise AssertionError(f'card and CPU training disagree: '
                                 f'{metrics}')
    log('[train-small] card (kernel) and CPU (plain) agree within 1e-4')
    train_small_bf16(torch)


def train_small_bf16(torch):
    """The training path's own type: TINY with head_dim 128 at bf16
    compute, one forward and backward on the card through the kernels
    (attention_impl 'auto') and through ``xla_attention`` ('xla') from
    the same params and batch. The loss and every parameter gradient
    agree within the bf16 gradient limit (normalized error)."""
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.models.config import get_model_config
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.train.loss import cross_entropy_loss
    from skypilot_tpu_torch.train.pretrain import synthetic_batch
    shape = dict(head_dim=128, max_seq_len=512)
    params = llama.init_params(5, get_model_config('tiny', **shape),
                               device='cuda')
    batch = synthetic_batch(0, 2, 512, 512, torch.device('cuda'))
    leaves = [x.requires_grad_(True) for x in _leaves(params)]
    out = {}
    for impl in ('auto', 'xla'):
        cfg = get_model_config('tiny', attention_impl=impl, **shape)
        before = dict(fa.LAUNCHES)
        logits = llama.forward(params, batch['tokens'], cfg)
        loss, _ = cross_entropy_loss(logits, batch['targets'],
                                     batch['weights'])
        out[impl] = (loss.item(), torch.autograd.grad(loss, leaves))
        moved = {n: fa.LAUNCHES[n] - before[n]
                 for n in ('flash_fwd', 'flash_dq', 'flash_dkv')}
        want = cfg.n_layers if impl == 'auto' else 0
        if moved != dict.fromkeys(moved, want):
            raise AssertionError(f'{impl}: flash launches {moved}, '
                                 f'expected {want} each')
    (loss_k, grads_k), (loss_x, grads_x) = out['auto'], out['xla']
    rel = max(norm_err(a, b) for a, b in zip(grads_k, grads_x))
    tol = FLASH_TOL['bf16'][1]
    log(f'[train-small] bf16 compute, kernels vs xla_attention on the '
        f'card: loss {loss_k:.6f} vs {loss_x:.6f}, largest normalized '
        f'gradient error over {len(leaves)} leaves {rel:.3e} (limit '
        f'{tol:g})')
    if abs(loss_k - loss_x) > tol * abs(loss_x) or not rel <= tol:
        raise AssertionError('bf16 training through the kernels disagrees '
                             'with xla_attention')


def phase_train(torch, fa, flops_peak, steps=20):
    """bench-1b7 at full width and depth through the trainer's entry
    point; the flash launch counters are zeroed just before and read
    just after."""
    import contextlib
    import gc
    import io
    from skypilot_tpu_torch.models.config import get_model_config
    from skypilot_tpu_torch.train import pretrain
    cfg = get_model_config('bench-1b7')
    batch, seq = 8, 2048
    argv = ['--model', 'bench-1b7', '--batch', str(batch), '--seq',
            str(seq), '--steps', str(steps), '--warmup-steps', '5',
            '--log-every', '5']
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = pretrain.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(fa.LAUNCHES)
    fallbacks = dict(fa.FALLBACKS)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    gc.collect()
    torch.cuda.empty_cache()
    lines = [json.loads(x) for x in out.getvalue().splitlines()]
    for line in lines:
        log(f'[train] {json.dumps(line)}')
    logged = [x for x in lines if 'loss' in x]
    if rc != 0 or not logged or lines[-1] != {'done': True,
                                               'final_step': steps}:
        raise AssertionError(f'pretrain.main failed: rc={rc}, {lines}')
    losses = [x['loss'] for x in logged]
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f'losses not finite and falling: {losses}')
    # Full remat: each layer's forward runs twice a step (forward and
    # recompute), its backward once.
    n = cfg.n_layers * steps
    expected = {'flash_fwd': 2 * n, 'flash_dq': n, 'flash_dkv': n,
                'flash_fwd_seg': 0, 'flash_dq_seg': 0, 'flash_dkv_seg': 0}
    if counts != expected or fallbacks['cuda']:
        raise AssertionError(f'flash launches {counts}, expected '
                             f'{expected} (2L fwd, L dq, L dkv per step); '
                             f'calls outside the kernels {fallbacks}')
    log(f'[train] flash launches {counts} = 2x{cfg.n_layers} fwd, '
        f'{cfg.n_layers} dq, {cfg.n_layers} dkv per step x {steps} steps')
    last = logged[-1]
    tps = last['tokens_per_sec']
    result = dict(
        launches=counts, losses=losses, wall_s=wall, peak_mem_gb=peak_gb,
        step_s=batch * seq / tps, tokens_per_sec=tps,
        achieved_tflops=last['achieved_tflops'],
        peak_share=last['achieved_tflops'] * 1e12 / flops_peak)
    log(f'[train] bench-1b7 B={batch} S={seq}, last window of 5 steps: '
        f'{result["step_s"]:.3f} s/step, {tps:.1f} tokens/s, '
        f'{last["achieved_tflops"]:.2f} TFLOP/s = '
        f'{100 * result["peak_share"]:.2f}% of {flops_peak / 1e12:.0f}; '
        f'peak memory {peak_gb:.2f} GB; {steps} steps in {wall:.1f} s')
    return result


def profile_train(torch, cfg, steps=2):
    """Trace ``steps`` bench-1b7 train steps (B=8, S=2048, after one
    warm-up step) with ``torch.profiler``: the device's busy share and
    the kernels that take the step."""
    import gc
    from torch.profiler import ProfilerActivity, profile
    from skypilot_tpu_torch.train import step as st
    from skypilot_tpu_torch.train.pretrain import synthetic_batch
    hp = st.TrainHParams(warmup_steps=1, total_steps=10)
    state = st.create_train_state(2, cfg, hp)
    step_fn = st.make_train_step(cfg, hp)
    dev = torch.device('cuda')
    state, _ = step_fn(state, synthetic_batch(0, 8, 2048, cfg.vocab_size,
                                              dev))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            state, m = step_fn(state, synthetic_batch(
                1 + i, 8, 2048, cfg.vocab_size, dev))
        float(m['loss'])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return profile_summary('profile-train', prof, wall_us, top=16)


# ---------------------------------------------------------------------------
# Phases 8-10: the continuous engine
# ---------------------------------------------------------------------------

def post_generate(port: int, prompts, max_new_tokens: int):
    body = json.dumps({'prompts': prompts,
                       'max_new_tokens': max_new_tokens}).encode()
    req = urllib.request.Request(
        f'http://127.0.0.1:{port}/generate', data=body,
        headers={'Content-Type': 'application/json'})
    with urllib.request.urlopen(req, timeout=600) as resp:
        return json.loads(resp.read())


class CallRecorder:
    """Records every ``generate_ids`` call of an engine (its arguments
    and result) while in use, so a twin engine can replay them; on exit
    the engine's own method is back (no reference cycle keeps a
    dropped engine's memory until the next collection)."""

    def __init__(self, engine):
        self.engine, self.calls = engine, []

    def __enter__(self):
        inner = self.engine.generate_ids

        def generate_ids(*args, **kwargs):
            out = inner(*args, **kwargs)
            self.calls.append((args, kwargs, out))
            return out

        self.engine.generate_ids = generate_ids
        return self

    def __exit__(self, *exc):
        del self.engine.generate_ids


def phase_small_agreement(torch):
    from skypilot_tpu_torch.inference.continuous import (
        ContinuousBatchingEngine)
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.models.config import get_model_config
    cfg = get_model_config('tiny', head_dim=128,
                           compute_dtype=torch.float32)
    params = llama.init_params(7, cfg, device='cpu')
    prompts = [[3, 1, 4, 1, 5], [2, 7, 18] * 9, [31, 41, 59, 26, 5, 3]]
    outs = {}
    for device in ('cuda', 'cpu'):
        engine = ContinuousBatchingEngine('tiny', cfg=cfg, params=params,
                                          device=device, max_slots=2,
                                          max_len=96)
        try:
            handles = [engine.submit_ids(p, max_new_tokens=12)
                       for p in prompts]
            for h in handles:
                if not h.done.wait(300) or h.error is not None:
                    raise RuntimeError(f'{device} request failed: '
                                       f'{h.error}')
            outs[device] = [h.generated for h in handles]
        finally:
            engine.shutdown()
    log(f'[small] card tokens {outs["cuda"]}')
    if outs['cuda'] != outs['cpu']:
        raise AssertionError(f'card and CPU disagree: {outs}')
    log('[small] card (kernel) and CPU (plain) greedy tokens agree')


def serve_engine(engine):
    from skypilot_tpu_torch.inference import server as server_lib
    server = server_lib.serve(engine, '127.0.0.1', 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, server.server_address[1]


def drive_engine(torch, pa, engine, kernel, prompts, max_new_tokens):
    """One run of the main path: the launch counts are zeroed just
    before and read just after. Returns (counts, per-request records,
    stats before, stats after, wall seconds)."""
    server, port = serve_engine(engine)
    try:
        with CallRecorder(engine) as recorder:
            before = engine.stats()
            results = [None] * len(prompts)
            errors = []

            def run(i):
                try:
                    results[i] = post_generate(port, [prompts[i]],
                                               max_new_tokens)
                except Exception as e:  # collected, then raised below
                    errors.append(e)

            threads = [threading.Thread(target=run, args=(i,))
                       for i in range(len(prompts))]
            torch.cuda.synchronize()
            pa.reset_launch_counts()
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=900)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = dict(pa.LAUNCHES)
            after = engine.stats()
            if errors:
                raise errors[0]
            if any(r is None or len(r['outputs']) != 1 for r in results):
                raise AssertionError(f'bad /generate payloads: {results}')
    finally:
        server.shutdown()
        server.server_close()
    records = [(list(args[0]), list(out)) for args, _, out in recorder.calls]
    vocab = engine.cfg.vocab_size
    if len(records) != len(prompts):
        raise AssertionError(f'{len(records)} records for '
                             f'{len(prompts)} requests')
    for ids, out in records:
        if not 1 <= len(out) <= max_new_tokens or \
                not all(0 <= t < vocab for t in out):
            raise AssertionError(f'bad output ids for a {len(ids)}-token '
                                 f'prompt: {out}')
    steps = after['decode_steps'] - before['decode_steps']
    expected = engine.cfg.n_layers * steps
    if counts[kernel] != expected or steps <= 0:
        raise AssertionError(f'{kernel} launched {counts[kernel]} times '
                             f'in {steps} decode steps; expected '
                             f'{expected}')
    log(f'[engine] {kernel}: {counts[kernel]} launches = '
        f'{engine.cfg.n_layers} layers x {steps} decode steps; '
        f'all launch counts {counts}')
    return counts, records, before, after, wall


def profile_decode(torch, engine, prompts, max_new_tokens):
    """Trace one batch of requests with ``torch.profiler``: the device's
    busy share of the window (kernel self time / wall) and the kernels
    that take it."""
    from torch.profiler import ProfilerActivity, profile
    handles = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for p in prompts:
            handles.append(engine.submit_ids(engine.tokenizer.encode(p),
                                             max_new_tokens=max_new_tokens))
        for h in handles:
            if not h.done.wait(600) or h.error is not None:
                raise RuntimeError(f'profiled request failed: {h.error}')
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return profile_summary('profile', prof, wall_us)


def profile_summary(tag, prof, wall_us, top=12):
    """Print the device's busy share of a traced window (the device-side
    kernel time over the wall; CPU-side ops, whose device time repeats
    their kernels', are left out), the time by kind of kernel and the
    kernels that take most of it; returns the share."""
    from torch.autograd import DeviceType
    rows = []
    for entry in prof.key_averages():
        if getattr(entry, 'device_type', None) != DeviceType.CUDA:
            continue
        dev = getattr(entry, 'self_device_time_total', None)
        if dev is None:
            dev = getattr(entry, 'self_cuda_time_total', 0)
        if dev > 0:
            rows.append((dev, entry.key, entry.count))
    busy_us = sum(r[0] for r in rows)
    log(f'[{tag}] window {wall_us / 1e3:.1f} ms, device busy '
        f'{busy_us / 1e3:.1f} ms ({100 * busy_us / wall_us:.1f}%)')
    kinds = {}
    for dev, key, _ in rows:
        low = key.lower()
        kind = ('flash' if 'flash_' in low else
                'decode' if 'decode_attention' in low else
                'paged' if 'paged_attention' in low else
                'gemm' if any(x in low for x in ('nvjet', 'gemm', 'cutlass',
                                                  'sm90_xmma')) else
                'other')
        kinds[kind] = kinds.get(kind, 0) + dev
    log(f'[{tag}] by kind: ' + ', '.join(
        f'{k} {v / 1e3:.1f} ms ({100 * v / busy_us:.1f}%)'
        for k, v in sorted(kinds.items(), key=lambda kv: -kv[1])))
    for dev, key, count in sorted(rows, reverse=True)[:top]:
        log(f'[{tag}]   {dev / 1e3:9.2f} ms  {count:6d}x  {key[:90]}')
    return busy_us / wall_us


def llama3_params(torch):
    """llama3-8b's bf16 weights from the port's seeded random init, on
    the card; shared by the continuous and the batch engine phases."""
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.models.config import get_model_config
    cfg = get_model_config('llama3-8b')
    t0 = time.perf_counter()
    params = llama.init_params(0, cfg, device='cuda',
                               weight_dtype=cfg.compute_dtype)
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    log(f'[engine] llama3-8b init on card: {nbytes / 1e9:.2f} GB in '
        f'{time.perf_counter() - t0:.1f} s')
    return params


def phase_engine(torch, pa, params, profile_window=False):
    from skypilot_tpu_torch.inference.continuous import (
        ContinuousBatchingEngine)
    free_card(torch)
    engine = ContinuousBatchingEngine('llama3-8b', params=params,
                                      max_slots=4, max_len=2048,
                                      block_size=16)
    pool_gb = (engine.cache.k.numel() * engine.cache.k.element_size() *
               2 / 1e9)
    log(f'[engine] KV pool {tuple(engine.cache.k.shape)} x2 = '
        f'{pool_gb:.2f} GB; prefill chunk {engine.prefill_chunk}')
    result = {}
    try:
        engine.generate_ids([1, 2, 3], max_new_tokens=2)  # warm-up
        text = ('The paged pool maps every slot through a block table. '
                * 8)
        prompts = ['Hello', text[:40], text[:150], text[:400]]
        counts, records, before, after, wall = drive_engine(
            torch, pa, engine, 'paged_attention', prompts, 32)
        result['launches'] = counts['paged_attention']
        tokens = after['tokens_generated'] - before['tokens_generated']
        decode_s = after['decode_seconds'] - before['decode_seconds']
        result['decode_tok_s'] = tokens / decode_s if decode_s else 0.0
        result['wall_tok_s'] = tokens / wall
        result['decode_steps'] = (after['decode_steps'] -
                                  before['decode_steps'])
        log(f'[engine] 4 concurrent requests: {tokens} tokens, '
            f'{result["decode_steps"]} decode steps, '
            f'decode {result["decode_tok_s"]:.1f} tok/s, '
            f'wall {result["wall_tok_s"]:.1f} tok/s ({wall:.2f} s)')
        # Repeat one request: greedy output is identical.
        ids = engine.tokenizer.encode(prompts[2])
        first = engine.generate_ids(ids, max_new_tokens=16)
        second = engine.generate_ids(ids, max_new_tokens=16)
        if first != second:
            raise AssertionError(f'repeat differs: {first} vs {second}')
        log(f'[engine] repeated request identical ({len(first)} tokens)')
        # Time to first token of a lone 150-token request.
        t0 = time.perf_counter()
        stream = engine.stream_ids(ids, max_new_tokens=4)
        next(stream)
        result['ttft_ms'] = (time.perf_counter() - t0) * 1e3
        list(stream)
        log(f'[engine] time to first token ({len(ids)}-token prompt): '
            f'{result["ttft_ms"]:.1f} ms')
        if profile_window:
            result['device_busy_share'] = profile_decode(
                torch, engine, prompts, 32)
        # The plain streams of phase 14's prompts, for its agreement
        # share and its decode rate on the same requests (outside the
        # counted window).
        before = engine.stats()
        result['plain_streams'] = concurrent_ids(engine, SPEC_PROMPTS, 32)
        result['same_prompts_tok_s'] = decode_rate(before, engine.stats())
    finally:
        engine.shutdown()
    del engine
    # Phase 10: int8 KV on the same weights.
    free_card(torch)
    engine = ContinuousBatchingEngine('llama3-8b', params=params,
                                      max_slots=4, max_len=2048,
                                      block_size=16, quantize_kv=True)
    try:
        counts, _, before, after, _ = drive_engine(
            torch, pa, engine, 'paged_attention_quant',
            ['Hello', text[:200]], 16)
        result['launches_quant'] = counts['paged_attention_quant']
    finally:
        engine.shutdown()
    return result


# ---------------------------------------------------------------------------
# Phases 13-15: speculative verify windows and LoRA pages
# ---------------------------------------------------------------------------

SPEC_TEXT = ('Speculative decoding drafts tokens from the history and '
             'verifies the whole window in one step. ')
# Phase 14's prompts: the first is sent alone first, then repeated.
SPEC_PROMPTS = [SPEC_TEXT * 2, SPEC_TEXT[:90], 'Hello there',
                SPEC_TEXT[:150]]
# Phase 15's adapters: A from init_lora_params (N(0, 1/rank)), B drawn
# as LORA_B_SCALE x N(0, 1) (a fresh adapter's B is zero, the base
# model): large enough that the q/v deltas move greedy tokens.
LORA_B_SCALE = 0.02


def decode_rate(before, after):
    """Tokens a decode second between two ``stats()`` readings."""
    seconds = after['decode_seconds'] - before['decode_seconds']
    tokens = after['tokens_generated'] - before['tokens_generated']
    return tokens / seconds if seconds else 0.0


def concurrent_ids(engine, prompts, max_new_tokens):
    """Greedy ids of ``prompts`` submitted together (no eos)."""
    handles = [engine.submit_ids(engine.tokenizer.encode(p),
                                 max_new_tokens=max_new_tokens)
               for p in prompts]
    for h in handles:
        if not h.done.wait(600) or h.error is not None:
            raise RuntimeError(f'request failed: {h.error}')
    return [list(h.generated) for h in handles]


def post_json(port, path, payload, headers=None):
    req = urllib.request.Request(
        f'http://127.0.0.1:{port}{path}', data=json.dumps(payload).encode(),
        headers={'Content-Type': 'application/json', **(headers or {})})
    with urllib.request.urlopen(req, timeout=600) as resp:
        body = resp.read()
    if path.startswith('/v1/') and payload.get('stream'):
        return [e[len('data: '):] for e in body.decode().split('\n\n')
                if e.strip()]
    return json.loads(body)


def get_url(port, path):
    with urllib.request.urlopen(f'http://127.0.0.1:{port}{path}',
                                timeout=60) as resp:
        return resp.read().decode()


def run_concurrently(calls):
    """Run the zero-argument ``calls`` on threads; their results in
    order, or the first error raised."""
    results, errors = [None] * len(calls), []

    def run(i):
        try:
            results[i] = calls[i]()
        except Exception as e:  # collected, then raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(calls))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    if errors:
        raise errors[0]
    return results


def tiny_adapter(torch, cfg, rank, seed, scale):
    from skypilot_tpu_torch.models import lora as lora_lib
    adapter = lora_lib.init_lora_params(seed, cfg, rank, device='cpu')
    gen = torch.Generator().manual_seed(seed + 1000)
    for key in ('wq_b', 'wv_b'):
        adapter[key] = scale * torch.randn(adapter[key].shape,
                                           generator=gen)
    return adapter


def phase_small_spec_lora(torch):
    """Phase 13. TINY with head_dim 128 and fp32 compute: a speculative
    engine (draft_k 4), a plain engine and a LoRA engine (one seeded
    adapter, B non-zero) on the card; greedy tokens must equal the
    plain engine's and the LoRA engine's on the CPU, on a periodic, an
    arbitrary and a constant prompt."""
    from skypilot_tpu_torch.inference.continuous import (
        ContinuousBatchingEngine)
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.models.config import get_model_config
    cfg = get_model_config('tiny', head_dim=128,
                           compute_dtype=torch.float32)
    params = llama.init_params(7, cfg, device='cpu')
    adapter = tiny_adapter(torch, cfg, 4, 5, 0.05)
    prompts = [[5, 6, 7, 8] * 3, [(7 * i + 3) % 512 for i in range(21)],
               [9] * 6]

    def run(device, **extra):
        engine = ContinuousBatchingEngine(
            'tiny', cfg=cfg, params=params, device=device, max_slots=2,
            max_len=96, block_size=8, prefill_chunk=8, **extra)
        try:
            kw = {}
            if extra.get('lora_pages'):
                engine.register_adapter('a', adapter)
                kw['adapter'] = 'a'
            outs = [engine.generate_ids(p, max_new_tokens=16, **kw)
                    for p in prompts]
            return outs, engine.stats()
        finally:
            engine.shutdown()

    plain_cpu, _ = run('cpu')
    spec_card, spec_stats = run('cuda', spec_decode=True, draft_k=4)
    plain_card, _ = run('cuda')
    lora_cpu, _ = run('cpu', lora_pages=1, lora_max_rank=4)
    lora_card, lora_stats = run('cuda', lora_pages=1, lora_max_rank=4)
    log(f'[small-spec] card speculative tokens {spec_card}; '
        f'{spec_stats["verify_steps"]} verify steps, '
        f'{spec_stats["accepted_tokens"]}/{spec_stats["draft_tokens"]} '
        f'drafts accepted')
    if spec_card != plain_cpu or plain_card != plain_cpu:
        raise AssertionError(f'speculative/plain card vs CPU: {spec_card} '
                             f'/ {plain_card} vs {plain_cpu}')
    if spec_stats['verify_steps'] <= 0 or spec_stats['accepted_tokens'] <= 0:
        raise AssertionError(f'no verify window accepted: {spec_stats}')
    if lora_card != lora_cpu:
        raise AssertionError(f'LoRA card vs CPU: {lora_card} vs '
                             f'{lora_cpu}')
    if lora_cpu == plain_cpu or lora_stats['lora_pages_resident'] != 1:
        raise AssertionError('the adapter did not serve')
    log('[small-spec] speculative and plain card tokens equal the CPU '
        'plain engine\'s; LoRA card tokens equal the CPU LoRA engine\'s')


def common_prefix(a, b):
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


def phase_spec_engine(torch, pa, params, plain):
    """Phases 14 (and its int8-KV run). llama3-8b at full depth on phase
    9's weights, n-gram drafts with draft_k 4, behind the port's HTTP
    server: one /v1/completions alone (it feeds the completion corpus),
    then the counted window: four concurrent /v1/completions (the first
    prompt repeated, one streamed as SSE) and one /v1/chat/completions.
    The paged kernel must launch n_layers x (decode + verify steps)."""
    from skypilot_tpu_torch.inference.continuous import (
        ContinuousBatchingEngine)
    result = {}
    for quant in (False, True):
        kernel = 'paged_attention_quant' if quant else 'paged_attention'
        tag = 'spec-int8' if quant else 'spec'
        free_card(torch)
        engine = ContinuousBatchingEngine(
            'llama3-8b', params=params, max_slots=4, max_len=2048,
            block_size=16, spec_decode=True, draft_k=4, quantize_kv=quant)
        n_layers = engine.cfg.n_layers
        server, port = serve_engine(engine)
        try:
            engine.generate_ids([1, 2, 3], max_new_tokens=2)  # warm-up
            first = post_json(port, '/v1/completions',
                              {'prompt': SPEC_PROMPTS[0], 'max_tokens': 32})
            torch.cuda.synchronize()
            before = engine.stats()
            pa.reset_launch_counts()
            t0 = time.perf_counter()
            calls = [
                lambda: post_json(port, '/v1/completions',
                                  {'prompt': SPEC_PROMPTS[0],
                                   'max_tokens': 32}),
                lambda: post_json(port, '/v1/completions',
                                  {'prompt': SPEC_PROMPTS[1],
                                   'max_tokens': 32, 'stream': True}),
                lambda: post_json(port, '/v1/completions',
                                  {'prompt': SPEC_PROMPTS[2],
                                   'max_tokens': 32}),
                lambda: post_json(port, '/v1/completions',
                                  {'prompt': SPEC_PROMPTS[3],
                                   'max_tokens': 32})]
            answers = run_concurrently(calls)
            chat = post_json(port, '/v1/chat/completions', {
                'messages': [{'role': 'user', 'content': SPEC_PROMPTS[3]}],
                'max_tokens': 16})
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = dict(pa.LAUNCHES)
            after = engine.stats()
            metrics = get_url(port, '/metrics')
        finally:
            server.shutdown()
            server.server_close()
        try:
            delta = {k: after[k] - before[k] for k in
                     ('decode_steps', 'verify_steps', 'draft_tokens',
                      'accepted_tokens', 'tokens_generated')}
            steps = delta['decode_steps'] + delta['verify_steps']
            other = ('paged_attention' if quant
                     else 'paged_attention_quant')
            if (counts[kernel] != n_layers * steps or
                    delta['verify_steps'] <= 0 or counts[other] != 0):
                raise AssertionError(
                    f'{tag}: {kernel} launched {counts[kernel]} times in '
                    f'{delta["decode_steps"]} decode + '
                    f'{delta["verify_steps"]} verify steps; expected '
                    f'{n_layers * steps}; {other} {counts[other]}')
            frames = answers[1]
            last = json.loads(frames[-2])['choices'][0]
            if frames[-1] != '[DONE]' or last['finish_reason'] not in (
                    'stop', 'length'):
                raise AssertionError(f'{tag}: SSE stream ended with '
                                     f'{frames[-2:]}')
            for answer in [first, chat] + answers[:1] + answers[2:]:
                if answer['choices'][0]['finish_reason'] not in (
                        'stop', 'length'):
                    raise AssertionError(f'{tag}: bad payload {answer}')
            if ('# TYPE skyt_inference_verify_steps_total counter'
                    not in metrics):
                raise AssertionError(f'{tag}: /metrics lacks the verify '
                                     f'counter')
            rate = (delta['accepted_tokens'] / delta['draft_tokens']
                    if delta['draft_tokens'] else 0.0)
            tok_s = decode_rate(before, after)
            log(f'[{tag}] {kernel}: {counts[kernel]} launches = {n_layers} '
                f'layers x ({delta["decode_steps"]} decode + '
                f'{delta["verify_steps"]} verify steps); SSE ended with a '
                f'{last["finish_reason"]!r} frame and [DONE]; /metrics '
                f'serves the verify counter')
            log(f'[{tag}] window: {delta["tokens_generated"]} tokens in '
                f'{wall:.2f} s, acceptance {delta["accepted_tokens"]}/'
                f'{delta["draft_tokens"]} = {rate:.4f}, decode '
                f'{tok_s:.1f} tok/s, {delta["tokens_generated"] / max(1, delta["verify_steps"]):.2f} '
                f'tokens a verify step')
            if quant:
                result['launches_quant'] = counts[kernel]
                continue
            result.update(launches=counts[kernel],
                          verify_steps=delta['verify_steps'],
                          acceptance=rate, decode_tok_s=tok_s)
            # The repeated prompt alone: its drafts come from the corpus.
            before = engine.stats()
            again = engine.generate_ids(
                engine.tokenizer.encode(SPEC_PROMPTS[0]), max_new_tokens=32)
            after = engine.stats()
            accepted = after['accepted_tokens'] - before['accepted_tokens']
            steps = after['verify_steps'] - before['verify_steps']
            if accepted <= 0:
                raise AssertionError('the repeated request accepted no '
                                     'draft from the corpus')
            log(f'[{tag}] repeated request alone: {len(again)} tokens in '
                f'{steps} verify steps, {accepted} drafts accepted')
            # Time to first token of phase 9's lone 150-token request,
            # measured as phase 9 does: after two runs of the same
            # prompt (its full blocks in the prefix cache).
            ids = engine.tokenizer.encode(
                ('The paged pool maps every slot through a block table. '
                 * 8)[:150])
            for _ in range(2):
                engine.generate_ids(ids, max_new_tokens=16)
            t0 = time.perf_counter()
            stream = engine.stream_ids(ids, max_new_tokens=4)
            next(stream)
            result['ttft_ms'] = (time.perf_counter() - t0) * 1e3
            list(stream)
            # bf16: a window of 5 rows rounds otherwise than 5 single
            # steps, so the streams may part; report how far they agree.
            before = engine.stats()
            spec_streams = concurrent_ids(engine, SPEC_PROMPTS, 32)
            after = engine.stats()
            result['same_prompts_tok_s'] = decode_rate(before, after)
            agree = sum(common_prefix(a, b) for a, b in
                        zip(spec_streams, plain['plain_streams']))
            total = sum(len(b) for b in plain['plain_streams'])
            result['agreement'] = agree / total
            log(f'[{tag}] decode {tok_s:.1f} tok/s, TTFT '
                f'{result["ttft_ms"]:.1f} ms (phase 9 plain: '
                f'{plain["decode_tok_s"]:.1f} tok/s, TTFT '
                f'{plain["ttft_ms"]:.1f} ms)')
            log(f'[{tag}] the four prompts together, 32 tokens each: '
                f'{result["same_prompts_tok_s"]:.1f} decode tok/s in '
                f'{after["verify_steps"] - before["verify_steps"]} verify '
                f'steps, acceptance '
                f'{after["accepted_tokens"] - before["accepted_tokens"]}/'
                f'{after["draft_tokens"] - before["draft_tokens"]} (plain '
                f'engine in phase 9: {plain["same_prompts_tok_s"]:.1f} '
                f'tok/s); bf16 speculative streams agree with the plain '
                f'streams on {agree}/{total} tokens (common prefix; '
                f'{result["agreement"]:.4f})')
        finally:
            engine.shutdown()
        del engine
    return result


def phase_lora_engine(torch, pa, params):
    """Phase 15. The same weights, lora_pages 4, lora_max_rank 16, two
    seeded adapters (rank 16 and 8) behind the port's HTTP server: one
    /generate with an ``adapter`` field, one /v1/completions with
    ``X-Skyt-Adapter`` and one base /generate, concurrently. The paged
    kernel must launch n_layers per decode step; the base request must
    give the tokens it gives alone on a plain engine; each adapter must
    move them; /adapters and /stats show two resident adapters."""
    from skypilot_tpu_torch.inference.continuous import (
        ContinuousBatchingEngine)
    from skypilot_tpu_torch.models.config import get_model_config
    cfg = get_model_config('llama3-8b')
    n_layers = cfg.n_layers
    prompt = ('Every adapter page is charged against the paged KV pool, '
              'so a cold adapter costs blocks, not a fleet.')
    adapters = {'tenant-16': tiny_adapter(torch, cfg, 16, 11, LORA_B_SCALE),
                'tenant-8': tiny_adapter(torch, cfg, 8, 12, LORA_B_SCALE)}
    free_card(torch)
    engine = ContinuousBatchingEngine('llama3-8b', params=params,
                                      max_slots=4, max_len=2048,
                                      block_size=16, lora_pages=4,
                                      lora_max_rank=16)
    result = {}
    records = []
    inner = engine.generate_ids

    def generate_ids(ids, **kwargs):
        out = inner(ids, **kwargs)
        records.append((kwargs.get('adapter'), list(out)))
        return out

    try:
        for name, adapter in adapters.items():
            engine.register_adapter(name, adapter)
        engine.generate_ids([1, 2, 3], max_new_tokens=2)  # warm-up
        engine.generate_ids = generate_ids
        server, port = serve_engine(engine)
        try:
            torch.cuda.synchronize()
            before = engine.stats()
            pa.reset_launch_counts()
            run_concurrently([
                lambda: post_json(port, '/generate', {
                    'prompts': [prompt], 'max_new_tokens': 32,
                    'adapter': 'tenant-16'}),
                lambda: post_json(port, '/v1/completions', {
                    'prompt': prompt, 'max_tokens': 32},
                    headers={'X-Skyt-Adapter': 'tenant-8'}),
                lambda: post_json(port, '/generate', {
                    'prompts': [prompt], 'max_new_tokens': 32})])
            torch.cuda.synchronize()
            counts = dict(pa.LAUNCHES)
            after = engine.stats()
            listed = json.loads(get_url(port, '/adapters'))
            stats = json.loads(get_url(port, '/stats'))
        finally:
            server.shutdown()
            server.server_close()
        steps = after['decode_steps'] - before['decode_steps']
        if (counts['paged_attention'] != n_layers * steps or steps <= 0 or
                counts['paged_attention_quant'] != 0):
            raise AssertionError(f'lora: paged_attention launched '
                                 f'{counts["paged_attention"]} times in '
                                 f'{steps} decode steps')
        if (stats['lora_pages_resident'] != 2 or
                stats['lora_blocks_charged'] <= 0 or
                sorted(listed) != sorted(adapters) or
                any(v['resident'] != 1.0 for v in listed.values())):
            raise AssertionError(f'lora residency: {listed} / '
                                 f'{stats["lora_pages_resident"]} pages, '
                                 f'{stats["lora_blocks_charged"]} blocks')
        result['launches'] = counts['paged_attention']
        result['decode_tok_s'] = decode_rate(before, after)
        by_adapter = dict(records)
        log(f'[lora] paged_attention: {counts["paged_attention"]} launches '
            f'= {n_layers} layers x {steps} decode steps; '
            f'{stats["lora_pages_resident"]} adapters resident, '
            f'{stats["lora_blocks_charged"]} KV blocks charged; B scale '
            f'{LORA_B_SCALE}')
    finally:
        engine.shutdown()
    del engine
    free_card(torch)
    plain = ContinuousBatchingEngine('llama3-8b', params=params,
                                     max_slots=4, max_len=2048,
                                     block_size=16)
    try:
        plain.generate_ids([1, 2, 3], max_new_tokens=2)  # warm-up
        ids = plain.tokenizer.encode(prompt)
        alone = plain.generate_ids(ids, max_new_tokens=32,
                                   eos_id=plain.tokenizer.eos_id)
        before = plain.stats()
        concurrent_ids(plain, [prompt] * 3, 32)
        base_tok_s = decode_rate(before, plain.stats())
    finally:
        plain.shutdown()
    if by_adapter[None] != alone:
        raise AssertionError(f'base request on the LoRA engine '
                             f'{by_adapter[None]} vs alone on a plain '
                             f'engine {alone}')
    for name in adapters:
        if by_adapter[name] == alone:
            raise AssertionError(f'adapter {name} left the base tokens '
                                 f'unchanged')
    log(f'[lora] base request equals the plain engine\'s tokens; both '
        f'adapters move them (first differing token '
        + ', '.join(f'{n} {common_prefix(by_adapter[n], alone)}'
                    for n in adapters) + ')')
    log(f'[lora] decode {result["decode_tok_s"]:.1f} tok/s with two '
        f'adapters and a base request; plain engine, three base requests: '
        f'{base_tok_s:.1f} tok/s')
    result['base_decode_tok_s'] = base_tok_s
    return result


# ---------------------------------------------------------------------------
# Phases 11-12: the batch engine
# ---------------------------------------------------------------------------

def phase_small_batch_agreement(torch, da):
    """TINY with head_dim 128 and fp32 compute: the batch engine on the
    card (decode kernels) and on the CPU (plain version) from the same
    weights give the same greedy tokens, with an fp and an int8 cache."""
    from skypilot_tpu_torch.inference.engine import InferenceEngine
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.models.config import get_model_config
    cfg = get_model_config('tiny', head_dim=128,
                           compute_dtype=torch.float32)
    params = llama.init_params(7, cfg, device='cpu')
    prompts = [[3, 1, 4, 1, 5], [2, 7, 18] * 9, [31, 41, 59, 26, 5, 3]]
    for quantize_kv in (False, True):
        name = ('decode_attention_quant' if quantize_kv else
                'decode_attention')
        outs = {}
        for device in ('cuda', 'cpu'):
            engine = InferenceEngine('tiny', cfg=cfg, params=params,
                                     device=device, max_batch=4,
                                     quantize_kv=quantize_kv)
            before = da.LAUNCHES[name]
            outs[device] = engine.generate_ids(prompts, max_new_tokens=12)
            moved = da.LAUNCHES[name] - before
            want = cfg.n_layers * 16 if device == 'cuda' else 0
            if moved != want:
                raise AssertionError(f'{device}: {name} launched {moved} '
                                     f'times, expected {want}')
        log(f'[small-batch] quantize_kv={quantize_kv}: card tokens '
            f'{outs["cuda"]}')
        if outs['cuda'] != outs['cpu']:
            raise AssertionError(f'card and CPU batch engines disagree: '
                                 f'{outs}')
    log('[small-batch] card (kernel) and CPU (plain) greedy tokens agree, '
        'fp and int8 cache')


def drive_batch(torch, da, fa, engine, prompts, max_new_tokens):
    """One ``/generate`` of ``prompts`` through the port's HTTP server in
    front of the batch engine: the launch counts are zeroed just before
    and read just after. Returns (outputs, decode counts, flash counts,
    flash fallbacks, stats delta, wall seconds)."""
    server, port = serve_engine(engine)
    try:
        before = dict(engine.stats)
        torch.cuda.synchronize()
        da.reset_launch_counts()
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        payload = post_generate(port, prompts, max_new_tokens)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, flash = dict(da.LAUNCHES), dict(fa.LAUNCHES)
        fallbacks = dict(fa.FALLBACKS)
    finally:
        server.shutdown()
        server.server_close()
    outputs = payload.get('outputs')
    if not isinstance(outputs, list) or len(outputs) != len(prompts) or \
            not all(isinstance(o, str) for o in outputs):
        raise AssertionError(f'bad /generate payload: {payload}')
    delta = {k: engine.stats[k] - before[k] for k in before}
    return outputs, counts, flash, fallbacks, delta, wall


def check_batch_counts(label, counts, flash, fallbacks, expected,
                       n_flash):
    if counts != expected or flash['flash_fwd'] != n_flash or \
            fallbacks['cuda']:
        raise AssertionError(
            f'{label}: decode launches {counts} (expected {expected}), '
            f'flash fwd {flash["flash_fwd"]} (expected {n_flash}), calls '
            f'outside the flash kernels {fallbacks}')


def profile_batch(torch, engine, prompts, max_new_tokens):
    """Trace one batch-engine request (prefill + decode steps) with
    ``torch.profiler``: the device's busy share and the top kernels."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.generate_text(prompts, max_new_tokens=max_new_tokens)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return profile_summary('profile-batch', prof, wall_us)


def phase_batch_engine(torch, da, fa, params, profile_window=False):
    """llama3-8b at full width and depth (phase 9's bf16 weights)
    through ``InferenceEngine(max_batch=4)`` behind the port's HTTP
    server: one /generate of 4 prompts of 131-255 tokens (bucket 256)
    and 32 new tokens (T = 288); decode_attention must launch exactly
    n_layers x 32 times, flash fwd n_layers times, no call may leave
    the flash gate; a repeat is identical; embed_text; the int8-KV and
    W8A8 engines on the same weights."""
    from skypilot_tpu_torch.inference.engine import InferenceEngine
    from skypilot_tpu_torch.models import decode as decode_lib
    from skypilot_tpu_torch.models.config import get_model_config
    cfg = get_model_config('llama3-8b')
    n_layers, new = cfg.n_layers, 32
    text = ('The batch engine pads every prompt of one request to a '
            'shared bucket and decodes them together. ') * 4
    prompts = [text[:n] for n in (130, 170, 211, 254)]
    result = {}
    engine = InferenceEngine('llama3-8b', params=params, max_batch=4)
    ids = [engine.tokenizer.encode(p) for p in prompts]
    if not all(128 < len(x) <= 256 for x in ids):
        raise AssertionError(f'prompt lengths {[len(x) for x in ids]}')
    engine.generate_text(['warmup'], max_new_tokens=8)
    outputs, counts, flash, fallbacks, delta, wall = drive_batch(
        torch, da, fa, engine, prompts, new)
    check_batch_counts('batch engine', counts, flash, fallbacks,
                       {'decode_attention': n_layers * new,
                        'decode_attention_quant': 0}, n_layers)
    result['launches'] = counts['decode_attention']
    log(f'[batch] decode_attention: {counts["decode_attention"]} launches '
        f'= {n_layers} layers x {new} steps; flash fwd '
        f'{flash["flash_fwd"]}; fallbacks {fallbacks}')
    again = drive_batch(torch, da, fa, engine, prompts, new)[0]
    if again != outputs:
        raise AssertionError(f'repeat differs: {outputs} vs {again}')
    log('[batch] repeated request identical')
    if profile_window:
        result['device_busy_share'] = profile_batch(torch, engine, prompts,
                                                    new)

    # Prefill alone, on the same padded batch: the median of 3 runs.
    lengths = [len(x) for x in ids]
    import numpy as np
    tokens, lens = engine._batch(ids, np.array(lengths, np.int32))
    times = []
    with torch.no_grad():
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits_fp, _ = decode_lib.prefill(engine.params, tokens, lens,
                                              cfg, tokens.shape[1] + new)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    prefill_s = statistics.median(times)
    tokens_gen = delta['tokens_generated']
    gen_s = delta['decode_seconds']
    result.update(
        prefill_ms=prefill_s * 1e3, generate_s=gen_s,
        tokens_generated=tokens_gen, wall_s=wall,
        tok_s=tokens_gen / gen_s,
        decode_tok_s=tokens_gen / (gen_s - prefill_s))
    log(f'[batch] llama3-8b B=4 S=256 +{new}: prefill {prefill_s * 1e3:.1f}'
        f' ms; generate {gen_s:.3f} s for {tokens_gen} tokens = '
        f'{result["tok_s"]:.1f} tok/s ({result["decode_tok_s"]:.1f} tok/s '
        f'without the prefill); request wall {wall:.3f} s')

    torch.cuda.synchronize()
    fa.reset_launch_counts()
    vecs = engine.embed_text(prompts)
    norms = np.linalg.norm(vecs, axis=-1)
    if vecs.shape != (4, cfg.d_model) or not np.isfinite(vecs).all() or \
            np.abs(norms - 1).max() > 1e-3 or \
            fa.LAUNCHES['flash_fwd'] != n_layers or fa.FALLBACKS['cuda']:
        raise AssertionError(f'embed_text: shape {vecs.shape}, norms '
                             f'{norms}, flash {fa.LAUNCHES}, fallbacks '
                             f'{fa.FALLBACKS}')
    log(f'[batch] embed_text: {vecs.shape}, norms {norms.tolist()}, flash '
        f'fwd {fa.LAUNCHES["flash_fwd"]}')
    del engine

    engine = InferenceEngine('llama3-8b', params=params, max_batch=4,
                             quantize_kv=True)
    _, counts, flash, fallbacks, _, _ = drive_batch(
        torch, da, fa, engine, prompts, new)
    check_batch_counts('int8 KV', counts, flash, fallbacks,
                       {'decode_attention': 0,
                        'decode_attention_quant': n_layers * new}, n_layers)
    result['launches_quant'] = counts['decode_attention_quant']
    log(f'[batch] int8 KV: decode_attention_quant '
        f'{counts["decode_attention_quant"]} launches')
    del engine

    t0 = time.perf_counter()
    engine = InferenceEngine('llama3-8b', params=params, max_batch=4,
                             quantize=True)
    torch.cuda.synchronize()
    log(f'[batch] W8A8 weights quantized in {time.perf_counter() - t0:.1f} '
        f's')
    _, counts, flash, fallbacks, delta, _ = drive_batch(
        torch, da, fa, engine, prompts[:1], new)
    check_batch_counts('W8A8', counts, flash, fallbacks,
                       {'decode_attention': n_layers * new,
                        'decode_attention_quant': 0}, n_layers)
    with torch.no_grad():
        logits_q, _ = decode_lib.prefill(engine.params, tokens, lens, cfg,
                                         tokens.shape[1] + new)
    fp, q = logits_fp.double(), logits_q.double()
    cos = ((fp * q).sum() / (fp.norm() * q.norm())).item()
    finite = bool(torch.isfinite(logits_q).all().item())
    result['w8a8_cosine'] = cos
    result['w8a8_tok_s'] = delta['tokens_generated'] / delta['decode_seconds']
    log(f'[batch] W8A8: one request, {delta["tokens_generated"]} tokens in '
        f'{delta["decode_seconds"]:.3f} s; prefill logits finite {finite}, '
        f'cosine {cos:.5f} against bf16 weights (limit 0.99)')
    if not finite or not cos > 0.99:
        raise AssertionError('W8A8 prefill logits not finite or not close '
                             'to the bf16 ones')
    del engine
    return result


# ---------------------------------------------------------------------------
# Phases 26-27: llama3-8b from a checkpoint directory, and the finetune loop
# ---------------------------------------------------------------------------

CKPT_TEXT = ('A checkpoint directory holds config.json, the safetensors '
             'shards and the tokenizer files; the engine loads them onto '
             'the card. ') * 4
# 129-256 tokens each with the fixture's tokenizer (batch bucket 256).
CKPT_PROMPTS = [CKPT_TEXT[:n] for n in (240, 300, 360, 430)]
CKPT_MESSAGES = [{'role': 'system', 'content': 'Answer in one line.'},
                 {'role': 'user', 'content': 'What does the loader read?'}]
CKPT_NEW = 32
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       'skypilot_tpu_torch', 'testdata', 'tokenizer_llama3')


def scratch_dir(need_bytes, tag='ckpt'):
    """A fresh directory with ``need_bytes`` free: under the temp
    directory, else under the checkout's git-ignored ``build/``
    (``tag`` names the phases that write there)."""
    import shutil
    import tempfile
    here = os.path.dirname(os.path.abspath(__file__))
    seen = []
    for root in (tempfile.gettempdir(), os.path.join(here, 'build')):
        os.makedirs(root, exist_ok=True)
        free = shutil.disk_usage(root).free
        seen.append(f'{root}: {free / 1e9:.1f} GB free')
        if free >= need_bytes:
            log(f'[{tag}] writing under {root} ({free / 1e9:.1f} GB free)')
            return tempfile.mkdtemp(prefix=f'smoke_{tag}_', dir=root)
    raise RuntimeError(f'no room for the {need_bytes / 1e9:.1f} GB the '
                       f'{tag} phases write ({"; ".join(seen)}); '
                       'the depth is not cut quietly')


def flat_tree(tree, prefix=''):
    if isinstance(tree, dict):
        out = {}
        for key, value in tree.items():
            out.update(flat_tree(value, f'{prefix}{key}/'))
        return out
    return {prefix[:-1]: tree}


def same_bits(torch, loaded, drawn):
    """``loaded`` holds exactly ``drawn``'s numbers (a bf16 load of an
    fp32 leaf: equal after the exact widening, and ``drawn`` exact in
    bf16)."""
    if loaded.dtype == drawn.dtype:
        if loaded.dtype == torch.bfloat16:
            return torch.equal(loaded.view(torch.int16),
                               drawn.view(torch.int16))
        return torch.equal(loaded, drawn)
    return torch.equal(loaded.to(drawn.dtype), drawn)


def engine_stats(engine):
    stats = engine.stats
    return dict(stats() if callable(stats) else stats)


def drive_lone(torch, engine, prompts, reset):
    """Lone ``/generate`` requests, one at a time, through the port's
    HTTP server: counters zeroed just before, read (by the caller) just
    after. Returns (the recorded generate_ids calls, stats before,
    stats after, wall s)."""
    server, port = serve_engine(engine)
    try:
        with CallRecorder(engine) as recorder:
            before = engine_stats(engine)
            torch.cuda.synchronize()
            reset()
            t0 = time.perf_counter()
            for prompt in prompts:
                payload = post_generate(port, [prompt], CKPT_NEW)
                if len(payload.get('outputs', [])) != 1:
                    raise AssertionError(f'bad /generate payload '
                                         f'{payload}')
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            after = engine_stats(engine)
    finally:
        server.shutdown()
        server.server_close()
    return recorder.calls, before, after, wall


def replay(label, calls, twin):
    """The twin (in-memory params) gives each recorded call's tokens."""
    for args, kwargs, out in calls:
        again = twin.generate_ids(*args, **kwargs)
        if again != out:
            raise AssertionError(f'{label}: the checkpoint engine gave '
                                 f'{out}, the in-memory one {again}')
    log(f'[ckpt] {label}: {len(calls)} lone requests give the '
        f'in-memory engine\'s tokens exactly')


def check_chat(port, engine):
    """One /v1/chat/completions rendered through the checkpoint's own
    chat template (bos and header tokens as single ids)."""
    with CallRecorder(engine) as recorder:
        payload = post_json(port, '/v1/chat/completions',
                            {'messages': CKPT_MESSAGES, 'max_tokens': 8})
    tok = engine.tokenizer
    want = tok.encode(tok.apply_chat_template(CKPT_MESSAGES),
                      add_bos=False)
    (args, _, _), = recorder.calls
    header = tok._tok.token_to_id('<|start_header_id|>')
    if list(args[0]) != want or want[0] != tok.bos_id or \
            want.count(header) != 3 or \
            payload['choices'][0]['message']['role'] != 'assistant':
        raise AssertionError(f'chat prompt {args[0][:16]} (want '
                             f'{want[:16]}), payload {payload}')
    log(f'[ckpt] /v1/chat/completions: {len(want)} prompt ids through '
        f'the fixture template (bos {tok.bos_id}, 3 headers)')


def phase_checkpoint_serving(torch, pa, da, fa, params, directory,
                             plain):
    """Phase 26 on ``directory`` (written here): save, load bitwise
    with its peak, then serve it on each engine (see the docstring)."""
    import shutil
    from skypilot_tpu_torch.inference import server as server_lib
    from skypilot_tpu_torch.inference.continuous import (
        ContinuousBatchingEngine)
    from skypilot_tpu_torch.inference.engine import InferenceEngine
    from skypilot_tpu_torch.models import hf_interop
    from skypilot_tpu_torch.models.config import get_model_config
    cfg = get_model_config('llama3-8b')
    n_layers = cfg.n_layers
    result = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hf_interop.save_checkpoint(params, cfg, directory, dtype=torch.bfloat16)
    result['save_s'] = time.perf_counter() - t0
    for name in ('tokenizer.json', 'tokenizer_config.json'):
        shutil.copy(os.path.join(FIXTURE, name), directory)
    file_gb = os.path.getsize(os.path.join(directory,
                                           'model.safetensors')) / 1e9
    result['file_gb'] = file_gb
    result['save_gb_s'] = file_gb / result['save_s']
    log(f'[ckpt] save_checkpoint: {file_gb:.2f} GB in '
        f'{result["save_s"]:.2f} s ({result["save_gb_s"]:.2f} GB/s)')

    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loaded, lcfg = hf_interop.load_checkpoint(directory,
                                              dtype=torch.bfloat16,
                                              device='cuda')
    torch.cuda.synchronize()
    result['load_s'] = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    param_bytes = sum(t.numel() * t.element_size() for t in _leaves(loaded))
    with hf_interop.SafetensorsReader(
            os.path.join(directory, 'model.safetensors')) as reader:
        largest = max(reader.get(k).numel() * reader.get(k).element_size()
                      for k in reader.keys())
    bound = param_bytes + 2 * largest
    result.update(load_gb_s=file_gb / result['load_s'], peak_gb=peak / 1e9,
                  param_gb=param_bytes / 1e9, peak_bound_gb=bound / 1e9)
    log(f'[ckpt] load_checkpoint: {result["load_s"]:.2f} s '
        f'({result["load_gb_s"]:.2f} GB/s; read right after the write, '
        f'so from the page cache); peak {result["peak_gb"]:.3f} GB for '
        f'{result["param_gb"]:.3f} GB of params (bound '
        f'{result["peak_bound_gb"]:.3f} GB = params + 2 x the largest '
        f'file tensor, {largest / 1e9:.3f} GB)')
    if peak > bound:
        raise AssertionError(f'load peak {peak} B above {bound} B')
    drawn, got = flat_tree(params), flat_tree(loaded)
    if sorted(drawn) != sorted(got) or not all(
            same_bits(torch, got[k], drawn[k]) for k in drawn):
        bad = [k for k in drawn if k not in got or
               not same_bits(torch, got[k], drawn[k])]
        raise AssertionError(f'loaded tensors differ: {bad[:8]}')
    log(f'[ckpt] all {len(drawn)} loaded tensors equal the drawn params '
        'bitwise')
    del loaded, got
    free_card(torch)

    flags = ['--hf-checkpoint', directory, '--max-batch', '4']
    # Continuous engine, then the batch engine, each freed before the
    # next; each against a twin on the in-memory params.
    engine = server_lib.build_engine(server_lib.parse_args(
        flags + ['--engine', 'continuous', '--max-len', '2048',
                 '--block-size', '16']))
    try:
        rec, before, after, wall = drive_lone(
            torch, engine, CKPT_PROMPTS, pa.reset_launch_counts)
        counts = dict(pa.LAUNCHES)
        steps = after['decode_steps'] - before['decode_steps']
        if counts['paged_attention'] != n_layers * steps or steps <= 0 \
                or counts['paged_attention_quant']:
            raise AssertionError(f'paged launches {counts} in {steps} '
                                 'decode steps')
        result['paged'] = counts['paged_attention']
        result['decode_tok_s'] = decode_rate(before, after)
        log(f'[ckpt] continuous: paged_attention {counts["paged_attention"]}'
            f' = {n_layers} x {steps} decode steps; decode '
            f'{result["decode_tok_s"]:.1f} tok/s over 4 lone requests '
            f'(phase 9, 4 concurrent: {plain["decode_tok_s"]:.1f}); wall '
            f'{wall:.2f} s')
        server, port = serve_engine(engine)
        try:
            check_chat(port, engine)
        finally:
            server.shutdown()
            server.server_close()
        ids = engine.tokenizer.encode(CKPT_PROMPTS[1])
        engine.generate_ids(ids, max_new_tokens=4)
        t0 = time.perf_counter()
        stream = engine.stream_ids(ids, max_new_tokens=4)
        next(stream)
        result['ttft_ms'] = (time.perf_counter() - t0) * 1e3
        list(stream)
        log(f'[ckpt] time to first token ({len(ids)}-token prompt): '
            f'{result["ttft_ms"]:.1f} ms (phase 9: '
            f'{plain["ttft_ms"]:.1f} ms)')
    finally:
        engine.shutdown()
    del engine
    free_card(torch)
    twin = ContinuousBatchingEngine(hf_checkpoint=directory, params=params,
                                    cfg=lcfg, max_slots=4, max_len=2048,
                                    block_size=16)
    try:
        replay('continuous', rec, twin)
    finally:
        twin.shutdown()
    del twin
    free_card(torch)

    engine = server_lib.build_engine(server_lib.parse_args(
        flags + ['--engine', 'batch']))
    lengths = [len(engine.tokenizer.encode(p)) for p in CKPT_PROMPTS]
    if not all(128 < n <= 256 for n in lengths):
        raise AssertionError(f'prompt lengths {lengths}')

    def reset():
        da.reset_launch_counts()
        fa.reset_launch_counts()

    rec, before, after, wall = drive_lone(torch, engine, CKPT_PROMPTS,
                                          reset)
    counts, flash = dict(da.LAUNCHES), dict(fa.LAUNCHES)
    check_batch_counts('ckpt batch engine', counts, flash,
                       dict(fa.FALLBACKS),
                       {'decode_attention': 4 * n_layers * CKPT_NEW,
                        'decode_attention_quant': 0}, 4 * n_layers)
    result['decode'] = counts['decode_attention']
    result['batch_flash_fwd'] = flash['flash_fwd']
    tokens = after['tokens_generated'] - before['tokens_generated']
    result['batch_tok_s'] = tokens / (after['decode_seconds'] -
                                      before['decode_seconds'])
    log(f'[ckpt] batch: decode_attention {counts["decode_attention"]} = '
        f'4 requests x {n_layers} x {CKPT_NEW}, flash fwd '
        f'{flash["flash_fwd"]} (prompts of {lengths} tokens); '
        f'{result["batch_tok_s"]:.1f} generated tok/s; wall {wall:.2f} s')
    del engine
    free_card(torch)
    twin = InferenceEngine(hf_checkpoint=directory, params=params, cfg=lcfg,
                           max_batch=4)
    replay('batch', rec, twin)
    del twin
    free_card(torch)
    return result


class RecordPrefill:
    """Records the logits of every ``decode.prefill_chunk`` call while
    in use (each lone request's last one holds its first-token
    logits)."""

    def __init__(self):
        from skypilot_tpu_torch.models import decode as decode_lib
        self.lib, self.saved, self.rows = decode_lib, None, []

    def __enter__(self):
        self.saved = self.lib.prefill_chunk

        def prefill_chunk(*args, **kwargs):
            logits, cache = self.saved(*args, **kwargs)
            self.rows.append(logits.float().clone())
            return logits, cache

        self.lib.prefill_chunk = prefill_chunk
        return self

    def __exit__(self, *exc):
        self.lib.prefill_chunk = self.saved


def run_timed_main(main, argv):
    """(rc, [(seconds since the start, JSON line)]) of ``main(argv)``,
    each standard-output line stamped as it is written."""
    import contextlib
    import io

    class Stamped(io.StringIO):
        def __init__(self):
            super().__init__()
            self.t0, self.stamps = time.perf_counter(), []

        def write(self, s):
            for line in s.splitlines():
                if line.startswith('{'):
                    self.stamps.append((time.perf_counter() - self.t0,
                                        json.loads(line)))
            return super().write(s)

    out = Stamped()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.stamps


def phase_finetune(torch, pa, fa, directory, work):
    """Phase 27: ``train.finetune`` (LoRA rank 8, 3 steps, B=4, S=512)
    on the phase 26 directory, its adapter exported against the base's
    digest, then served beside that base."""
    import numpy as np
    from skypilot_tpu_torch.inference import server as server_lib
    from skypilot_tpu_torch.models import hf_interop
    from skypilot_tpu_torch.serve import adapter_registry
    from skypilot_tpu_torch.train import finetune
    cfg = hf_interop.load_config(directory)
    n_layers, steps = cfg.n_layers, 3
    corpus = os.path.join(work, 'corpus.txt')
    registry = os.path.join(work, 'adapters')
    with open(corpus, 'w', encoding='utf-8') as f:
        f.write('\n'.join([CKPT_TEXT, SPEC_TEXT * 3] + CKPT_PROMPTS) + '\n')
    # The flash forward runs once a layer, twice when remat re-runs the
    # layer in the backward (every policy but 'none':
    # models/llama.py:_remat_policy); dq and dk/dv once a layer.
    per_step = {'flash_fwd': n_layers * (1 if cfg.remat_policy == 'none'
                                         else 2),
                'flash_dq': n_layers, 'flash_dkv': n_layers}
    expected = {k: v * steps for k, v in per_step.items()}
    expected.update(flash_fwd_seg=0, flash_dq_seg=0, flash_dkv_seg=0)
    free_card(torch)
    base = torch.cuda.memory_allocated()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    rc, stamps = run_timed_main(finetune.main, [
        '--hf-checkpoint', directory, '--data', corpus, '--lora-rank', '8',
        '--steps', str(steps), '--batch', '4', '--seq', '512',
        '--adapter-export-dir', registry, '--log-every', '1'])
    torch.cuda.synchronize()
    counts, fallbacks = dict(fa.LAUNCHES), dict(fa.FALLBACKS)
    peak = torch.cuda.max_memory_allocated() - base
    free_card(torch)
    lines = [line for _, line in stamps]
    step_t = [t for t, line in stamps if 'step' in line]
    losses = [line['loss'] for line in lines if 'step' in line]
    if rc != 0 or len(losses) != steps or \
            not all(math.isfinite(x) for x in losses) or \
            counts != expected or fallbacks['cuda']:
        raise AssertionError(f'finetune rc {rc}, lines {lines}, flash '
                             f'{counts} (expected {expected}), calls '
                             f'outside the kernels {fallbacks}')
    _, lora, meta = adapter_registry.load_adapter(
        os.path.join(registry, 'adapter'))
    if not all(np.any(lora[k] != 0) for k in ('wq_b', 'wv_b')):
        raise AssertionError('the trained B leaves are still zero')
    result = {'finetune': counts, 'losses': losses,
              'step_s': step_t[-1] - step_t[-2],
              'finetune_peak_gb': peak / 1e9}
    log(f'[finetune] losses {losses}; {result["step_s"]:.3f} s a step '
        f'(steps 2 -> 3); peak {peak / 1e9:.2f} GB above the '
        f'{base / 1e9:.2f} GB already held; flash {counts} = '
        f'{per_step} x {steps} steps (remat {cfg.remat_policy}); adapter '
        f'rank {meta["rank"]}, base {meta["base_digest"][:12]}')

    engine = server_lib.build_engine(server_lib.parse_args([
        '--hf-checkpoint', directory, '--engine', 'continuous',
        '--max-batch', '4', '--max-len', '2048', '--lora-pages', '2',
        '--lora-max-rank', '8', '--lora-dir', registry]))
    server, port = serve_engine(engine)
    try:
        if list(engine.adapter_stats()) != ['adapter'] or \
                engine.base_digest != meta['base_digest']:
            raise AssertionError(f'adapter not registered: '
                                 f'{engine.adapter_stats()}, base '
                                 f'{engine.base_digest[:12]}')
        before = engine.stats()
        torch.cuda.synchronize()
        pa.reset_launch_counts()
        with RecordPrefill() as rec:
            post_generate(port, [CKPT_PROMPTS[0]], 8)
            n_base = len(rec.rows)
            post_json(port, '/generate', {'prompts': [CKPT_PROMPTS[0]],
                                          'max_new_tokens': 8,
                                          'adapter': 'adapter'})
        torch.cuda.synchronize()
        launches = dict(pa.LAUNCHES)['paged_attention']
        steps_run = engine.stats()['decode_steps'] - before['decode_steps']
    finally:
        server.shutdown()
        server.server_close()
        engine.shutdown()
    base_row, adapter_row = rec.rows[n_base - 1], rec.rows[-1]
    diff = float((base_row - adapter_row).abs().max())
    if launches != n_layers * steps_run or not (
            torch.isfinite(base_row).all() and
            torch.isfinite(adapter_row).all()) or diff == 0.0:
        raise AssertionError(f'adapter serving: paged {launches} in '
                             f'{steps_run} steps, logits apart {diff}')
    result['lora_paged'] = launches
    log(f'[finetune] served with --lora-dir: adapter registered against '
        f'the checkpoint digest; its first-token logits differ from the '
        f'base\'s by up to {diff:.4g}; paged_attention {launches} = '
        f'{n_layers} x {steps_run} decode steps')
    del engine
    free_card(torch)
    return result


def run_checkpoint_phases(torch, pa, da, fa, params, plain):
    """Phases 26-27 in one scratch directory, removed at the end."""
    import shutil
    need = sum(t.numel() * 2 for t in _leaves(params)) + (2 << 30)
    work = scratch_dir(need)
    directory = os.path.join(work, 'llama3-8b')
    t0 = time.perf_counter()
    try:
        result = phase_checkpoint_serving(torch, pa, da, fa, params,
                                          directory, plain)
        t1 = time.perf_counter()
        result.update(phase_finetune(torch, pa, fa, directory, work))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f'[smoke] phase 26 {t1 - t0:.1f} s, 27 '
        f'{time.perf_counter() - t1:.1f} s')
    return result


# ---------------------------------------------------------------------------
# Phase 28: disaggregated prefill/decode
# ---------------------------------------------------------------------------

# Four lone prompts of 131-255 tokens (the byte tokenizer: one token a
# byte after BOS), no two sharing a first block; the burst's four more.
DISAGG_TEXT = ('A prefill replica absorbs the prompt and parks its KV '
               'blocks; the decode replica pulls them and streams. ') * 4
DISAGG_LONE = [f'Lone request {i}: {DISAGG_TEXT}'[:n]
               for i, n in enumerate((130, 170, 210, 254))]
DISAGG_BURST = [f'Burst request {i}: {DISAGG_TEXT}'[:n]
                for i, n in enumerate((140, 180, 220, 250))]


class WarningLog:
    """Collects every WARNING or worse that the port's serving modules
    log while in use (a failed pull, a KV import fallback, a retry)."""

    def __init__(self):
        import logging
        self.records = []
        self.logger = logging.getLogger('skypilot_tpu_torch.inference')
        self.handler = logging.Handler(logging.WARNING)
        self.handler.emit = lambda r: self.records.append(
            f'{r.name}: {r.getMessage()}')

    def __enter__(self):
        self.logger.addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)


class SubmitRecorder:
    """Records the handle of every request an engine admits (its
    ``_submit``), so the script reads the ids each HTTP request gave."""

    def __init__(self, engine):
        self.engine, self.handles = engine, []

    def __enter__(self):
        inner = self.engine._submit

        def submit(*args, **kwargs):
            handle = inner(*args, **kwargs)
            self.handles.append(handle)
            return handle

        self.engine._submit = submit
        return self

    def __exit__(self, *exc):
        del self.engine._submit


def two_hop(pre_port, dec_port, prompt, max_new_tokens):
    """Both hops of the serve LB's two-hop route, driven as the LB
    drives them: the client's body to the prefill replica's
    ``/disagg/prefill``, then to the decode replica with the export's id
    and endpoint. Returns the prefill hop's answer."""
    body = {'prompts': [prompt], 'max_new_tokens': max_new_tokens}
    hop1 = post_json(pre_port, '/disagg/prefill', body,
                     {'X-Skyt-Disagg-Path': '/generate'})
    post_json(dec_port, '/generate', body,
              {'X-Skyt-Kv-Request-Id': hop1['request_id'],
               'X-Skyt-Kv-Endpoint': f'http://127.0.0.1:{pre_port}'})
    return hop1


def disagg_pool(torch, pa, params, quantize_kv, full):
    """Phase 28 for one pool type: a prefill-role and a decode-role
    engine on phase 9's tree, each behind the port's server, and a
    decode-role twin on the same tree whose single-hop (local prefill)
    answers the two-hop answers must equal exactly. Lone requests, then
    with ``full`` a shared-prefix request and a concurrent burst."""
    from skypilot_tpu_torch.inference import kv_migrate
    from skypilot_tpu_torch.inference.continuous import (
        ContinuousBatchingEngine)
    from skypilot_tpu_torch.server import metrics
    tag = 'int8' if quantize_kv else 'bf16'
    kernel = 'paged_attention_quant' if quantize_kv else 'paged_attention'
    kw = dict(params=params, max_slots=4, max_len=2048, block_size=16,
              quantize_kv=quantize_kv)
    free_card(torch)
    engines = {role: ContinuousBatchingEngine('llama3-8b', role=role, **kw)
               for role in ('prefill', 'decode')}
    engines['twin'] = ContinuousBatchingEngine('llama3-8b', role='decode',
                                               **kw)
    pre, dec, twin = engines['prefill'], engines['decode'], engines['twin']
    n_layers = dec.cfg.n_layers
    servers = {}
    result = {}
    try:
        for role, engine in engines.items():
            gb = sum(t.numel() * t.element_size()
                     for t in engine._pool_fields().values()) / 1e9
            log(f'[disagg {tag}] {role} pool '
                f'{tuple(engine.cache.k.shape)} {engine.cache.k.dtype}: '
                f'{gb:.3f} GB')
            servers[role] = serve_engine(engine)
        ports = {role: port for role, (_, port) in servers.items()}
        # Warm-up, outside every counted window.
        pre.exporter.pop(pre.prefill_and_export([1, 2, 3]))
        dec.generate_ids([1, 2, 3], max_new_tokens=2)
        twin.generate_ids([1, 2, 3], max_new_tokens=2)
        with WarningLog() as warnings, SubmitRecorder(dec) as dec_rec, \
                SubmitRecorder(twin) as twin_rec:
            # Single-hop answers of every prompt on the twin.
            before_twin = twin.stats()
            for prompt in DISAGG_LONE:
                post_json(ports['twin'], '/generate',
                          {'prompts': [prompt], 'max_new_tokens': 32})
            lone_want = [list(h.generated) for h in twin_rec.handles]
            result['twin_tok_s'] = decode_rate(before_twin, twin.stats())
            # Lone two-hop requests, one at a time.
            launches, handoff, moved_bytes = 0, [], []
            tokens, seconds = 0, 0.0
            for i, prompt in enumerate(DISAGG_LONE):
                before_pre, before_dec = pre.stats(), dec.stats()
                pulled0 = metrics.KV_MIGRATE_BYTES.value(direction='pull')
                samples0 = len(metrics.DISAGG_HANDOFF.samples())
                torch.cuda.synchronize()
                pa.reset_launch_counts()
                hop1 = post_json(ports['prefill'], '/disagg/prefill',
                                 {'prompts': [prompt],
                                  'max_new_tokens': 32},
                                 {'X-Skyt-Disagg-Path': '/generate'})
                torch.cuda.synchronize()
                hop1_counts = dict(pa.LAUNCHES)
                post_json(ports['decode'], '/generate',
                          {'prompts': [prompt], 'max_new_tokens': 32},
                          {'X-Skyt-Kv-Request-Id': hop1['request_id'],
                           'X-Skyt-Kv-Endpoint':
                               f'http://127.0.0.1:{ports["prefill"]}'})
                torch.cuda.synchronize()
                counts = dict(pa.LAUNCHES)
                after_pre, after_dec = pre.stats(), dec.stats()
                got = list(dec_rec.handles[-1].generated)
                steps = after_dec['decode_steps'] - before_dec['decode_steps']
                checks = {
                    'tokens equal the twin single-hop': got == lone_want[i],
                    'no paged launch in hop 1':
                        hop1_counts['paged_attention'] == 0 and
                        hop1_counts['paged_attention_quant'] == 0,
                    'paged launches = layers x decode steps':
                        steps > 0 and counts[kernel] == n_layers * steps,
                    'exports +1': after_pre['kv_exports'] ==
                        before_pre['kv_exports'] + 1,
                    'exports pending 0': after_pre['kv_exports_pending'] == 0,
                    'imports +1': after_dec['kv_imports'] ==
                        before_dec['kv_imports'] + 1,
                    'no fallback': after_dec['kv_import_fallbacks'] == 0,
                    'no decode-side prefill chunk':
                        after_dec['prefill_chunks'] ==
                        before_dec['prefill_chunks'],
                    'handoff observed':
                        len(metrics.DISAGG_HANDOFF.samples()) ==
                        samples0 + 1,
                }
                failed = [name for name, ok in checks.items() if not ok]
                if failed:
                    raise AssertionError(
                        f'[disagg {tag}] lone request {i} '
                        f'({hop1["n_tokens"]} tokens): {failed}; tokens '
                        f'{got} vs single-hop {lone_want[i]}; launches '
                        f'{hop1_counts} then {counts}, {steps} steps')
                launches += counts[kernel]
                handoff.append(metrics.DISAGG_HANDOFF.samples()[-1])
                moved_bytes.append(
                    metrics.KV_MIGRATE_BYTES.value(direction='pull') -
                    pulled0)
                tokens += (after_dec['tokens_generated'] -
                           before_dec['tokens_generated'])
                seconds += (after_dec['decode_seconds'] -
                            before_dec['decode_seconds'])
            result['lone_tok_s'] = tokens / seconds if seconds else 0.0
            result['handoff_s'] = handoff
            result['bytes'] = moved_bytes
            log(f'[disagg {tag}] 4 lone two-hop requests of '
                f'{[len(dec.tokenizer.encode(p)) for p in DISAGG_LONE]} '
                f'tokens: greedy tokens equal the single-hop twin; '
                f'{launches} {kernel} launches = {n_layers} x decode '
                f'steps; handoff (pull + import) '
                f'{", ".join(f"{1e3 * s:.1f}" for s in handoff)} ms; '
                f'moved {", ".join(f"{b / 1e6:.2f}" for b in moved_bytes)} '
                f'MB; decode {result["lone_tok_s"]:.1f} tok/s (the twin '
                f'single-hop: {result["twin_tok_s"]:.1f})')
            result['launches'] = launches
            if not full:
                if warnings.records:
                    raise AssertionError(f'[disagg {tag}] the serving '
                                         f'modules logged: '
                                         f'{warnings.records}')
                return result
            # Shared prefix: 11 full blocks of the last lone prompt.
            shared = DISAGG_LONE[3][:175] + ' and a different ending.'
            ids = dec.tokenizer.encode(shared)
            hop1 = post_json(ports['prefill'], '/disagg/prefill',
                             {'prompts': [shared], 'max_new_tokens': 32},
                             {'X-Skyt-Disagg-Path': '/generate'})
            source = kv_migrate.HTTPKvSource(
                f'http://127.0.0.1:{ports["prefill"]}')
            pulled = kv_migrate.KvPuller(source).pull(
                hop1['request_id'],
                resident_digests=dec.probe_resident(ids))
            total = len(ids) // dec.block_size
            if not (pulled.moved < total and pulled.resident >= 10 and
                    pulled.moved + pulled.resident == total):
                raise AssertionError(
                    f'[disagg {tag}] shared prefix: moved {pulled.moved}, '
                    f'resident {pulled.resident} of {total} blocks')
            before_dec = dec.stats()
            pa.reset_launch_counts()
            post_json(ports['decode'], '/generate',
                      {'prompts': [shared], 'max_new_tokens': 32},
                      {'X-Skyt-Kv-Request-Id': hop1['request_id'],
                       'X-Skyt-Kv-Endpoint':
                           f'http://127.0.0.1:{ports["prefill"]}'})
            torch.cuda.synchronize()
            launches += pa.LAUNCHES[kernel]
            post_json(ports['twin'], '/generate',
                      {'prompts': [shared], 'max_new_tokens': 32})
            after_dec = dec.stats()
            if (dec_rec.handles[-1].generated !=
                    twin_rec.handles[-1].generated or
                    after_dec['kv_imports'] != before_dec['kv_imports'] + 1
                    or after_dec['prefill_chunks'] !=
                    before_dec['prefill_chunks']):
                raise AssertionError(f'[disagg {tag}] shared-prefix '
                                     f'request: {after_dec}')
            log(f'[disagg {tag}] shared prefix ({len(ids)} tokens): a '
                f'direct pull moved {pulled.moved} of {total} full '
                f'blocks, {pulled.resident} resident; its two-hop tokens '
                f'equal the single-hop twin')
            # Concurrent burst: four requests through both hops at once.
            n_twin = len(twin_rec.handles)
            run_concurrently([
                (lambda p=p: post_json(ports['twin'], '/generate',
                                       {'prompts': [p],
                                        'max_new_tokens': 32}))
                for p in DISAGG_BURST])
            burst_want = {tuple(h.token_ids): list(h.generated)
                          for h in twin_rec.handles[n_twin:]}
            before_pre, before_dec = pre.stats(), dec.stats()
            n_dec = len(dec_rec.handles)
            torch.cuda.synchronize()
            pa.reset_launch_counts()
            run_concurrently([
                (lambda p=p: two_hop(ports['prefill'], ports['decode'], p,
                                     32))
                for p in DISAGG_BURST])
            torch.cuda.synchronize()
            counts = dict(pa.LAUNCHES)
            after_pre, after_dec = pre.stats(), dec.stats()
            steps = after_dec['decode_steps'] - before_dec['decode_steps']
            agree = sum(list(h.generated) == burst_want[tuple(h.token_ids)]
                        for h in dec_rec.handles[n_dec:])
            checks = {
                'exports +4': after_pre['kv_exports'] ==
                    before_pre['kv_exports'] + 4,
                'exports pending 0': after_pre['kv_exports_pending'] == 0,
                'imports +4': after_dec['kv_imports'] ==
                    before_dec['kv_imports'] + 4,
                'no fallback': after_dec['kv_import_fallbacks'] == 0,
                'no decode-side prefill chunk':
                    after_dec['prefill_chunks'] ==
                    before_dec['prefill_chunks'],
                'paged launches = layers x decode steps':
                    steps > 0 and counts[kernel] == n_layers * steps,
            }
            failed = [name for name, ok in checks.items() if not ok]
            if failed:
                raise AssertionError(f'[disagg {tag}] burst: {failed}; '
                                     f'{counts}, {steps} steps')
            launches += counts[kernel]
            result['burst_tok_s'] = decode_rate(before_dec, after_dec)
            log(f'[disagg {tag}] burst of 4 through both hops: '
                f'{counts[kernel]} launches = {n_layers} x {steps} steps; '
                f'{agree} of 4 streams equal the twin\'s concurrent '
                f'single-hop streams; decode '
                f'{result["burst_tok_s"]:.1f} tok/s')
            if warnings.records:
                raise AssertionError(f'[disagg {tag}] the serving modules '
                                     f'logged: {warnings.records}')
        result['launches'] = launches
    finally:
        for server, _ in servers.values():
            server.shutdown()
            server.server_close()
        for engine in engines.values():
            engine.shutdown()
    return result


def phase_disagg(torch, pa, params):
    """Phase 28: the bf16 pool, then the int8 pool (kernel 2) on lone
    requests."""
    t0 = time.perf_counter()
    bf16 = disagg_pool(torch, pa, params, quantize_kv=False, full=True)
    free_card(torch)
    int8 = disagg_pool(torch, pa, params, quantize_kv=True, full=False)
    free_card(torch)
    log(f'[smoke] phase 28 {time.perf_counter() - t0:.1f} s')
    return {'launches': bf16['launches'],
            'launches_quant': int8['launches'],
            'bf16': bf16, 'int8': int8}


# ---------------------------------------------------------------------------
# Phases 29-30: GRPO with live weight refresh, the RL pipeline
# ---------------------------------------------------------------------------

GRPO_STEPS = 3
GRPO_ARGV = ['--model', 'bench-1b7', '--steps', str(GRPO_STEPS),
             '--prompts-per-step', '2', '--group-size', '4',
             '--prompt-len', '65', '--max-new-tokens', '64',
             '--temperature', '1.0', '--log-every', '1']
RL_BASE = 'bench-1b7'
RL_MODEL = 'bench-1b7-l2'   # RL_BASE at full width, 2 of its layers


def learner_flash(cfg, steps):
    """Flash launches of ``steps`` learner steps under full remat: 2L
    forward (forward and recompute), L dq, L dk/dv a step."""
    n = cfg.n_layers * steps
    return {'flash_fwd': 2 * n, 'flash_dq': n, 'flash_dkv': n,
            'flash_fwd_seg': 0, 'flash_dq_seg': 0, 'flash_dkv_seg': 0}


def check_served_leaves(torch, engine, params, cfg, label):
    """Every engine leaf is ``serving_params`` of ``params`` (the fp32
    learner's leaf rounded to bf16, norm scales fp32), bit for bit."""
    from skypilot_tpu_torch.inference.continuous import flatten_param_paths
    from skypilot_tpu_torch.models import decode
    with torch.no_grad():
        want = flatten_param_paths(decode.serving_params(params, cfg))
    got = flatten_param_paths(engine.params)
    bad = [p for p, leaf in got.items()
           if leaf.dtype != want[p].dtype or not torch.equal(leaf, want[p])]
    if set(got) != set(want) or bad:
        raise AssertionError(f'{label}: engine leaves differ from the '
                             f'learner\'s cast to bf16: {bad[:4]}')
    log(f'[{label}] {len(got)} engine leaves = the learner\'s cast as '
        f'serving_params casts, bit for bit')


def phase_grpo(torch, pa, fa, device='cuda'):
    """Phase 29: ``grpo.main``'s loop (``grpo.run`` of its parsed argv)
    on bench-1b7 at full width and depth: 3 steps of 2 prompts x 4
    rollouts, prompt 65 + 64 new tokens at temperature 1 from the
    continuous engine (8 slots), a learner step at B=8, S=128 and a live
    full refresh after each. Gates: the paged kernel 22 launches a
    decode step, flash 2L / L / L a learner step and no fallback;
    weight_refreshes and policy_version 3; every engine leaf the
    learner's cast to bf16 bit for bit; a temperature-0 wave of unseen
    prompts equal to a fresh engine's on the learner's params; a delta
    refresh negating ``layers/mlp/wo`` changes a lone request's greedy
    tokens and a drain refresh restoring it brings them back."""
    import contextlib
    import io
    from skypilot_tpu_torch.inference.continuous import (
        ContinuousBatchingEngine)
    from skypilot_tpu_torch.train import grpo
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pa.reset_launch_counts()
    fa.reset_launch_counts()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        run = grpo.run(grpo.parse_args(GRPO_ARGV + ['--device', device]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    paged, flash = dict(pa.LAUNCHES), dict(fa.LAUNCHES)
    fallbacks = dict(fa.FALLBACKS)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    learner, engine, cfg = run['learner'], run['engine'], run['cfg']
    lines = [json.loads(x) for x in out.getvalue().splitlines()
             if x.startswith('{')]
    try:
        for line in lines:
            log(f'[grpo] {json.dumps(line)}')
        steps = [x for x in lines if 'loss' in x]
        if len(steps) != GRPO_STEPS or lines[-1] != {
                'done': True, 'final_step': GRPO_STEPS} or not all(
                    math.isfinite(x['loss']) for x in steps):
            raise AssertionError(f'grpo lines {lines}')
        stats = engine.stats()
        n_layers = cfg.n_layers
        want_paged = n_layers * stats['decode_steps']
        if paged['paged_attention'] != want_paged or \
                paged['paged_attention_quant'] or \
                stats['decode_steps'] < 64:
            raise AssertionError(f'paged launches {paged}, expected '
                                 f'{want_paged} = {n_layers} x '
                                 f'{stats["decode_steps"]} decode steps')
        if flash != learner_flash(cfg, GRPO_STEPS) or fallbacks['cuda']:
            raise AssertionError(f'flash launches {flash}, expected '
                                 f'{learner_flash(cfg, GRPO_STEPS)}; '
                                 f'calls outside the kernels {fallbacks}')
        if not (stats['weight_refreshes'] == stats['policy_version'] ==
                engine.policy_version == learner.version == GRPO_STEPS):
            raise AssertionError(f'refresh counters {stats}')
        log(f'[grpo] paged_attention {paged["paged_attention"]} = '
            f'{n_layers} x {stats["decode_steps"]} decode steps; flash '
            f'{flash}; {stats["weight_refreshes"]} refreshes of '
            f'{stats["refresh_shards"] // stats["weight_refreshes"]} '
            f'leaves, {stats["refresh_seconds"]:.4f} s in all; '
            f'policy_version {stats["policy_version"]}')
        log(f'[grpo] per step (rollout / learn / refresh s): ' + ', '.join(
            f'{x["rollout_s"]:.3f} / {x["learn_s"]:.3f} / '
            f'{x["refresh_s"]:.4f}' for x in steps) +
            f'; {wall:.1f} s in all; peak memory {peak_gb:.2f} GB; '
            f'{nvidia_smi_line()}')
        check_served_leaves(torch, engine, learner.params, cfg, 'grpo')
        # A wave of prompts no step used (no cached prefix of the old
        # weights), at temperature 0, from the refreshed engine and from
        # a fresh engine on the learner's params.
        pool, _ = grpo.make_prompts(42, 256, 65, cfg.vocab_size)
        tiled = torch.repeat_interleave(pool[200:202], 4, dim=0).tolist()
        wave, version = grpo.engine_rollouts(
            engine, tiled, max_new_tokens=64, temperature=0.0, step=99)
        fresh = ContinuousBatchingEngine(cfg=cfg, params=learner.params,
                                         device=device, max_slots=8,
                                         max_len=130)
        try:
            twin, _ = grpo.engine_rollouts(
                fresh, tiled, max_new_tokens=64, temperature=0.0, step=99)
        finally:
            fresh.shutdown()
        del fresh
        if version != GRPO_STEPS or not torch.equal(wave, twin):
            raise AssertionError(
                f'refreshed wave (version {version}) differs from a fresh '
                f'engine\'s: {(wave != twin).sum().item()} of '
                f'{wave.numel()} tokens')
        log(f'[grpo] temperature-0 wave of 8 x 64 tokens from the '
            f'refreshed engine = a fresh engine\'s on the learner\'s '
            f'params, token for token')
        delta = delta_refresh(torch, engine, pool[210, :15].tolist())
    finally:
        engine.shutdown()
    result = dict(paged=paged['paged_attention'], flash=flash,
                  decode_steps=stats['decode_steps'], wall_s=wall,
                  peak_gb=peak_gb,
                  steps=[{k: x[k] for k in ('rollout_s', 'learn_s',
                                            'refresh_s', 'loss',
                                            'mean_reward')}
                         for x in steps],
                  refresh_seconds=stats['refresh_seconds'], **delta)
    del run, learner, engine
    free_card(torch)
    return result


def delta_refresh(torch, engine, ids):
    """A full-size delta refresh on a serving engine: negate one stacked
    leaf (``layers/mlp/wo``, every layer's MLP output), a lone greedy
    request's tokens change; restore it with ``mode='drain'``, they come
    back. Returns the two refresh wall times."""
    from skypilot_tpu_torch.inference.continuous import flatten_param_paths
    path = 'layers/mlp/wo'
    original = flatten_param_paths(engine.params)[path].clone()
    before = engine.generate_ids(ids, max_new_tokens=32)
    v = engine.policy_version
    t0 = time.perf_counter()
    engine.refresh_weights({path: -original}, version=v + 1)
    negate_s = time.perf_counter() - t0
    changed = engine.generate_ids(ids, max_new_tokens=32)
    t0 = time.perf_counter()
    engine.refresh_weights({path: original}, version=v + 2, mode='drain')
    restore_s = time.perf_counter() - t0
    after = engine.generate_ids(ids, max_new_tokens=32)
    if changed == before or after != before or \
            engine.policy_version != v + 2:
        raise AssertionError(f'delta refresh of {path}: before {before}, '
                             f'negated {changed}, restored {after}')
    log(f'[grpo] delta refresh of {path} {tuple(original.shape)} '
        f'({original.numel() * original.element_size() / 1e9:.3f} GB): '
        f'tokens changed; restored by a drain refresh, the tokens are '
        f'back; refresh walls {negate_s:.4f} / {restore_s:.4f} s')
    return {'delta_refresh_s': [negate_s, restore_s]}


def phase_rl_pipeline(torch, pa, fa, work, device='cuda'):
    """Phase 30: ``RLPipeline`` at bench-1b7's full width and 2 of its 22
    layers (each version commits the fp32 tree, 1.21 GB, and each
    replica keeps a copy): 2 rollout replicas (8 slots each), staleness
    bound 3, queue 2, 5 learner steps, prompts 65 + 64 new tokens; one
    fault at each rl.* site. Gates the summary's invariants, paged
    launches 2 a decode step of both replicas and flash 2L / L / L a
    learner step. Then the port's server with ``--policy-store`` on the
    same store serves its version before the first ``/generate``, and
    hands a ``FanoutPuller`` the store's bytes through ``GET
    /fanout/*``."""
    import dataclasses
    from skypilot_tpu_torch.jobs import rl_pipeline as rl
    from skypilot_tpu_torch.models import config
    from skypilot_tpu_torch.utils import fault_injection
    if RL_MODEL not in config.MODEL_REGISTRY:
        config.MODEL_REGISTRY.register(RL_MODEL)(dataclasses.replace(
            config.get_model_config(RL_BASE), name=RL_MODEL,
            n_layers=2))
    cfg = config.get_model_config(RL_MODEL)
    store = os.path.join(work, 'store')
    pcfg = rl.PipelineConfig(rollout_replicas=2, max_staleness=3,
                             queue_batches=2, refresh_mode='step',
                             refresh_concurrency=1, store=store)
    # 5 steps: the valve lets at most 4 batches be produced from the
    # initial policy (3, or 4 when both replicas pass it at once), so
    # the run cannot finish without a live refresh.
    steps = 5
    pipe = rl.RLPipeline(cfg, pcfg, steps=steps, prompts_per_step=2,
                         group_size=4, prompt_len=65, max_new_tokens=64,
                         num_prompts=64, max_slots=8, device=device)
    os.environ[fault_injection.SPEC_ENV] = ','.join([
        f'{rl.LEARN_STEP_SITE}:Exception:times=1',
        f'{rl.ROLLOUT_GENERATE_SITE}:Exception:times=1',
        f'{rl.REFRESH_PULL_SITE}:OSError:times=1'])
    fault_injection.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pa.reset_launch_counts()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        summary = pipe.run()
    finally:
        os.environ.pop(fault_injection.SPEC_ENV, None)
        fault_injection.reset()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    paged, flash = dict(pa.LAUNCHES), dict(fa.LAUNCHES)
    fallbacks = dict(fa.FALLBACKS)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f'[rl] summary {json.dumps(summary)}')
    decode_steps = sum(w.engine.stats()['decode_steps']
                       for w in pipe.workers)
    checks = {
        'steps': summary['steps'] == steps,
        'staleness_max <= 3': summary['staleness_max'] <= 3,
        'no batch lost': summary['batches_unretired'] ==
        pipe.queue.depth() and summary['batches_acked'] >= steps,
        'refreshes >= 1': summary['refreshes'] >= 1,
        'one learner fault, requeued': summary['learn_faults'] == 1 and
        summary['batches_requeued'] >= 1,
        'one killed wave': summary['worker_errors'] == 1,
        'a killed pull': summary['refresh_errors'] >= 1,
        'paged 2 a decode step': paged['paged_attention'] ==
        cfg.n_layers * decode_steps > 0,
        'flash 2L / L / L a step': flash == learner_flash(cfg, steps),
        'no flash fallback': not fallbacks['cuda'],
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f'pipeline checks failed {failed}: paged '
                             f'{paged}, {decode_steps} decode steps, '
                             f'flash {flash}, fallbacks {fallbacks}')
    log(f'[rl] {steps} steps in {wall:.1f} s: staleness max '
        f'{summary["staleness_max"]}, {summary["refreshes"]} live '
        f'refreshes (p50 {summary["refresh_p50_s"]:.3f} s commit to '
        f'swap), {summary["rollout_tokens_per_s"]:.1f} rollout tok/s; '
        f'paged {paged["paged_attention"]} = {cfg.n_layers} x '
        f'{decode_steps} decode steps; flash {flash}; peak '
        f'{peak_gb:.2f} GB')
    version = rl.PolicyStore(store).version()
    del pipe
    free_card(torch)
    result = dict(paged=paged['paged_attention'], flash=flash, wall_s=wall,
                  peak_gb=peak_gb, summary=summary)
    result.update(eval_server(torch, store, version, work, device))
    return result


def eval_server(torch, store, version, work, device):
    """The port's server on the pipeline's store: ``build_engine`` with
    ``--policy-store`` pulls before it returns, so the engine serves
    ``version`` before its first ``/generate``; its leaves are the
    store's arrays cast to bf16; ``GET /fanout/*`` over the store
    (``SKYT_FANOUT_DIR``) hands a ``FanoutPuller`` whose bucket serves
    nothing the store's manifest and bytes."""
    import numpy as np
    from skypilot_tpu_torch.data import ckpt_manifest, fanout
    from skypilot_tpu_torch.inference import server as server_lib
    from skypilot_tpu_torch.inference.continuous import flatten_param_paths
    from skypilot_tpu_torch.models.convert import tensor_from_numpy
    import tempfile
    weights = os.path.join(store, 'weights')
    os.environ[fanout.DIR_ENV] = weights
    # The watcher pulls into a new temporary directory: keep it under
    # ``work``, which the caller removes.
    saved, tempfile.tempdir = tempfile.tempdir, work
    try:
        engine = server_lib.build_engine(server_lib.parse_args([
            '--model', RL_MODEL, '--engine', 'continuous', '--max-batch',
            '4', '--max-len', '256', '--policy-store', store, '--device',
            device]))
    finally:
        tempfile.tempdir = saved
    try:
        if engine.policy_version != version:
            raise AssertionError(f'served version {engine.policy_version}'
                                 f', store {version}')
        for path, leaf in flatten_param_paths(engine.params).items():
            want = tensor_from_numpy(np.load(os.path.join(
                weights, *path.split('/')) + '.npy'), leaf.device).to(
                    leaf.dtype)
            if not torch.equal(leaf, want):
                raise AssertionError(f'{path}: served leaf is not the '
                                     f'store\'s')
        server, port = serve_engine(engine)
        try:
            out = post_generate(port, ['the policy store'], 16)
            endpoint = f'http://127.0.0.1:{port}'
            manifest = fanout.fetch_manifest(endpoint, timeout=30.0)
            dest = os.path.join(work, 'fanout-pull')
            t0 = time.perf_counter()
            result = fanout.FanoutPuller(
                manifest, dest,
                [fanout.HTTPPeerSource(1, endpoint, timeout=60.0)],
                fanout.CallableSource('bucket', lambda s, o: b'',
                                      is_peer=False)).pull()
            pull_s = time.perf_counter() - t0
        finally:
            server.shutdown()
            server.server_close()
    finally:
        engine.shutdown()
        os.environ.pop(fanout.DIR_ENV, None)
    if manifest != ckpt_manifest.read(weights) or \
            ckpt_manifest.verify(dest, manifest) or \
            set(result['sources'].values()) != {'peer:1'}:
        raise AssertionError(f'/fanout pull differs from the store: '
                             f'{result}')
    nbytes = sum(s['size'] for s in manifest['shards'])
    log(f'[rl-eval] --policy-store: serving version {version} before the '
        f'first /generate ({len(out["outputs"][0])} chars back), leaves '
        f'= the store\'s; GET /fanout/* handed a FanoutPuller '
        f'{result["fetched"]} shards, {nbytes / 1e9:.3f} GB, the '
        f'store\'s digests, in {pull_s:.2f} s')
    return {'fanout_pull_s': pull_s, 'fanout_gb': nbytes / 1e9}


def run_rl_phases(torch, pa, fa):
    """Phases 29-30; phase 30 writes under a scratch directory, removed
    at the end."""
    import shutil
    t0 = time.perf_counter()
    grpo_result = phase_grpo(torch, pa, fa)
    t1 = time.perf_counter()
    work = scratch_dir(8 << 30, 'rl')
    try:
        pipeline = phase_rl_pipeline(torch, pa, fa, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f'[smoke] phase 29 {t1 - t0:.1f} s, 30 '
        f'{time.perf_counter() - t1:.1f} s')
    return {'paged': grpo_result['paged'] + pipeline['paged'],
            'flash': [grpo_result['flash'], pipeline['flash']],
            'grpo': grpo_result, 'pipeline': pipeline}


# ---------------------------------------------------------------------------
# Phases 16-21: the bench twin, remat policies, --packed, resume
# ---------------------------------------------------------------------------

def run_json_main(main, argv):
    """(rc, JSON lines) of an entry point's ``main(argv)``, its standard
    output captured."""
    import contextlib
    import io
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, [json.loads(x) for x in out.getvalue().splitlines()
                if x.startswith('{')]


def free_card(torch):
    """Collect garbage, then return cached blocks to the card. A
    continuous engine keeps its own copy of a caller's weights, and one
    served over HTTP stays reachable from its handler class (a reference
    cycle) until a collection: phases that build engines on one shared
    tree call this before each."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def bench_train(torch, fa, argv, steps, label):
    """``bench.main(['--mode', 'train'] + argv)`` with the flash counters
    zeroed just before and read just after; gates its one JSON line, a
    finite loss and 2L forward, L dq, L dk/dv launches per step (every
    remat policy but 'none' re-runs the flash forward), none of them
    segment kernels, no call outside the kernels."""
    from skypilot_tpu_torch import bench
    from skypilot_tpu_torch.models.config import get_model_config
    n_layers = get_model_config('bench-1b7').n_layers
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    rc, lines = run_json_main(bench.main, ['--mode', 'train'] + argv)
    torch.cuda.synchronize()
    counts, fallbacks = dict(fa.LAUNCHES), dict(fa.FALLBACKS)
    free_card(torch)
    if rc != 0 or len(lines) != 1:
        raise AssertionError(f'{label}: bench rc {rc}, lines {lines}')
    line = lines[0]
    detail = line['detail']
    n = n_layers * steps
    expected = {'flash_fwd': 2 * n, 'flash_dq': n, 'flash_dkv': n,
                'flash_fwd_seg': 0, 'flash_dq_seg': 0, 'flash_dkv_seg': 0}
    if counts != expected or fallbacks['cuda'] or \
            not math.isfinite(detail['loss']):
        raise AssertionError(f'{label}: flash launches {counts} (expected '
                             f'{expected}), calls outside the kernels '
                             f'{fallbacks}, loss {detail["loss"]}')
    log(f'[{label}] {json.dumps(line)}')
    log(f'[{label}] {detail["remat_policy"]}: '
        f'{detail["seconds_per_step"]:.4f} s/step, '
        f'{detail["tokens_per_sec_per_chip"]} tokens/s, MFU {line["value"]}%'
        f' of {detail["peak_tflops_per_chip"]:g} TFLOP/s, peak memory '
        f'{detail["peak_memory_gb"]:.2f} GB; flash launches {counts} = '
        f'2x{n_layers} fwd, {n_layers} dq, {n_layers} dkv x {steps} steps')
    return dict(line=line, launches=counts)


def phase_bench_train(torch, fa):
    """Phase 16: the bench twin's train mode at its defaults (bench-1b7,
    Adafactor, bf16 params, full remat, B=8, S=2048, 5 + 20 steps)."""
    return bench_train(torch, fa, [], 25, 'bench-train')


def phase_remat(torch, fa, steps=3):
    """Phase 17: bench-1b7 Adafactor bf16 steps (1 warmup + ``steps``
    timed) under each selective remat policy."""
    out = {}
    for policy in ('save_attn', 'save_dots', 'dots'):
        out[policy] = bench_train(
            torch, fa, ['--remat-policy', policy, '--warmup', '1',
                        '--steps', str(steps)], 1 + steps, f'remat-{policy}')
    return out


def packed_tokens(path, n_tokens, eos_id, vocab, seed=0):
    """A flat int32 token file of documents whose lengths are geometric
    with mean 500, each ending in ``eos_id``."""
    import numpy as np
    rng = np.random.RandomState(seed)
    tokens = rng.randint(2, vocab, n_tokens).astype(np.int32)
    tokens[rng.rand(n_tokens) < 1 / 500] = eos_id
    np.save(path, tokens)


def phase_packed(torch, fa, steps=3):
    """Phase 18: ``pretrain.main --packed`` on bench-1b7 (B=8, S=2048,
    Adafactor, bf16 params) over a token file written here: only the
    segment kernels run (2L / L / L a step), the native packer packs
    every batch, losses are finite."""
    import os
    import tempfile
    from skypilot_tpu_torch.data import packer
    from skypilot_tpu_torch.models.config import get_model_config
    from skypilot_tpu_torch.train import pretrain
    cfg = get_model_config('bench-1b7')
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'tokens.npy')
        packed_tokens(path, 8 * 2049 * (steps + 2), 1, cfg.vocab_size)
        argv = ['--model', 'bench-1b7', '--batch', '8', '--seq', '2048',
                '--steps', str(steps), '--packed', '--data', path,
                '--eos-id', '1', '--optimizer', 'adafactor',
                '--param-dtype', 'bfloat16', '--warmup-steps', '1',
                '--log-every', '1']
        torch.cuda.synchronize()
        fa.reset_launch_counts()
        packer.reset_call_counts()
        t0 = time.perf_counter()
        rc, lines = run_json_main(pretrain.main, argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts, fallbacks = dict(fa.LAUNCHES), dict(fa.FALLBACKS)
    calls = dict(packer.CALLS)
    free_card(torch)
    for line in lines:
        log(f'[packed] {json.dumps(line)}')
    losses = [x['loss'] for x in lines if 'loss' in x]
    n = cfg.n_layers * steps
    expected = {'flash_fwd': 0, 'flash_dq': 0, 'flash_dkv': 0,
                'flash_fwd_seg': 2 * n, 'flash_dq_seg': n,
                'flash_dkv_seg': n}
    if rc != 0 or len(losses) != steps or \
            not all(math.isfinite(x) for x in losses) or \
            counts != expected or fallbacks['cuda'] or \
            calls != {'native': steps, 'python': 0}:
        raise AssertionError(
            f'packed: rc {rc}, losses {losses}, flash launches {counts} '
            f'(expected {expected}), calls outside the kernels '
            f'{fallbacks}, packer calls {calls} (expected {steps} native)')
    log(f'[packed] {steps} steps in {wall:.1f} s: flash launches {counts} '
        f'= 2x{cfg.n_layers} fwd_seg, {cfg.n_layers} dq_seg, '
        f'{cfg.n_layers} dkv_seg per step; packer calls {calls}')
    return dict(launches=counts, losses=losses)


RESUME_MODEL = 'tiny-hd128'


def phase_resume(torch, fa):
    """Phase 19: ``pretrain.main --checkpoint-dir`` on the card. TINY with
    head_dim 128 (so the flash kernels run), registered here as
    ``tiny-hd128``; Adafactor, bf16 params, B=4, S=128. Run A trains 4
    steps, checkpointing at 2 and 4. Run B starts from a copy of A's
    step 2 only, resumes and trains steps 3-4. B's logged losses and its
    step-4 checkpoint (params and optimizer state) must equal A's
    bitwise; the largest difference is printed."""
    import dataclasses
    import os
    import shutil
    import tempfile
    from skypilot_tpu_torch.models import config
    from skypilot_tpu_torch.train import checkpoint, pretrain
    if RESUME_MODEL not in config.MODEL_REGISTRY:
        config.MODEL_REGISTRY.register(RESUME_MODEL)(dataclasses.replace(
            config.TINY, name=RESUME_MODEL, head_dim=128))
    cfg = config.get_model_config(RESUME_MODEL)
    # 'none' remat (TINY's): one flash forward a layer and step.
    want_fwd = 4 * cfg.n_layers * (1 if cfg.remat_policy == 'none' else 2)
    base = ['--model', RESUME_MODEL, '--batch', '4', '--seq', '128',
            '--steps', '4', '--checkpoint-every', '2', '--log-every', '1',
            '--warmup-steps', '1', '--optimizer', 'adafactor',
            '--param-dtype', 'bfloat16']
    with tempfile.TemporaryDirectory() as tmp:
        dir_a, dir_b = os.path.join(tmp, 'a'), os.path.join(tmp, 'b')
        fa.reset_launch_counts()
        rc_a, lines_a = run_json_main(pretrain.main,
                                      base + ['--checkpoint-dir', dir_a])
        launched = fa.LAUNCHES['flash_fwd']
        shutil.copytree(os.path.join(dir_a, '2'), os.path.join(dir_b, '2'))
        rc_b, lines_b = run_json_main(pretrain.main,
                                      base + ['--checkpoint-dir', dir_b])
        state_a = checkpoint.read_safetensors(
            os.path.join(dir_a, '4', checkpoint.SHARD_NAME))
        state_b = checkpoint.read_safetensors(
            os.path.join(dir_b, '4', checkpoint.SHARD_NAME))
        steps_b = [n for n in (2, 4)
                   if checkpoint.step_manifest(dir_b, n) is not None]
    loss_a = {x['step']: x['loss'] for x in lines_a if 'loss' in x}
    loss_b = {x['step']: x['loss'] for x in lines_b if 'loss' in x}
    diff = max(float((state_a[k].float() - state_b[k].float()).abs().max())
               for k in state_a) if set(state_a) == set(state_b) else None
    log(f'[resume] run A losses {loss_a}; run B {lines_b[0]}, losses '
        f'{loss_b}; {len(state_a)} tensors of the step-4 states, largest '
        f'difference {diff}')
    if rc_a or rc_b or lines_b[0] != {'resumed_from_step': 2} or \
            sorted(loss_b) != [3, 4] or \
            any(loss_b[i] != loss_a[i] for i in loss_b) or diff != 0.0 or \
            steps_b != [2, 4] or launched != want_fwd:
        raise AssertionError(
            f'resume: rc {rc_a}/{rc_b}, B {lines_b}, committed steps '
            f'{steps_b}, flash fwd launches of A {launched} (expected '
            f'{want_fwd}), state difference {diff}')
    log('[resume] the resumed run reproduces the uninterrupted one '
        'bitwise (losses, params, Adafactor statistics)')
    return dict(max_state_diff=diff)


def phase_bench_decode(torch, da, fa):
    """Phase 20: the bench twin's decode mode at its defaults (bench-1b7,
    bf16, B=8, prompt 128, N=256: generate at N and 2N after one warmup
    of each): the decode kernel launches 22 times a decode step and the
    flash forward 22 times a prefill."""
    from skypilot_tpu_torch import bench
    from skypilot_tpu_torch.models.config import get_model_config
    n_layers = get_model_config('bench-1b7').n_layers
    torch.cuda.synchronize()
    da.reset_launch_counts()
    fa.reset_launch_counts()
    rc, lines = run_json_main(bench.main, ['--mode', 'decode'])
    torch.cuda.synchronize()
    counts, flash = dict(da.LAUNCHES), dict(fa.LAUNCHES)
    free_card(torch)
    if rc != 0 or len(lines) != 1:
        raise AssertionError(f'bench-decode: rc {rc}, lines {lines}')
    line = lines[0]
    new = line['detail']['new_tokens']
    decode_steps = 2 * (new + 2 * new)
    expected = {'decode_attention': n_layers * decode_steps,
                'decode_attention_quant': 0}
    log(f'[bench-decode] {json.dumps(line)}')
    if counts != expected or flash['flash_fwd'] != 4 * n_layers or \
            not line['value'] > 0:
        raise AssertionError(
            f'bench-decode: decode launches {counts} (expected {expected}),'
            f' flash fwd {flash["flash_fwd"]} (expected {4 * n_layers})')
    log(f'[bench-decode] {line["value"]} tokens/s; decode launches '
        f'{counts["decode_attention"]} = {n_layers} x {decode_steps} '
        f'decode steps')
    return dict(line=line, launches=counts['decode_attention'])


def phase_bench_kernels(torch):
    """Phase 21: the bench twin's kernels mode: every hand kernel against
    its plain version at the reference's shapes and tolerances."""
    from skypilot_tpu_torch import bench
    rc, lines = run_json_main(bench.main, ['--mode', 'kernels'])
    free_card(torch)
    log(f'[bench-kernels] {json.dumps(lines)}')
    if rc != 0 or len(lines) != 1 or lines[0]['value'] != 1:
        raise AssertionError(f'bench-kernels: rc {rc}')
    return lines[0]


# ---------------------------------------------------------------------------
# Phases 22-25: Mixture-of-Experts
# ---------------------------------------------------------------------------

MOE_TEXT = ('A mixture of experts routes every token to a few of its '
            'feed-forward experts and mixes their outputs. ') * 4
# Four prompts of 131-255 tokens (the batch engine's bucket 256), served
# by both engines.
MOE_PROMPTS = [MOE_TEXT[:n] for n in (130, 170, 211, 254)]
MOE_NEW = 32


def deepseek_params(torch):
    """deepseek-moe-16b at full width and depth: bf16 weights (the
    router fp32) from the port's seeded random init, on the card."""
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.models.config import get_model_config
    from skypilot_tpu_torch.models.quant import param_bytes
    cfg = get_model_config('deepseek-moe-16b')
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = llama.init_params(0, cfg, device='cuda',
                               weight_dtype=cfg.compute_dtype)
    torch.cuda.synchronize()
    nbytes = param_bytes(params)
    log(f'[moe] deepseek-moe-16b init on card: {nbytes / 1e9:.2f} GB '
        f'({sum(t.numel() for t in _leaves(params)) / 1e9:.3f} B params) '
        f'in {time.perf_counter() - t0:.1f} s')
    return params, nbytes


class FiniteLogits:
    """Wraps ``decode.paged_decode_step`` and ``decode.prefill_chunk``
    while in use: every logits row of an active slot must be finite
    (read after the window; no sync inside the steps)."""

    def __init__(self, torch):
        from skypilot_tpu_torch.models import decode as decode_lib
        self.torch, self.lib, self.flags = torch, decode_lib, []
        self.saved = (decode_lib.paged_decode_step,
                      decode_lib.prefill_chunk)

    def __enter__(self):
        step, chunk = self.saved

        def paged_decode_step(*args, **kwargs):
            logits, cache = step(*args, **kwargs)
            active = kwargs.get('active')
            rows = logits if active is None else logits[active]
            self.flags.append(self.torch.isfinite(rows).all())
            return logits, cache

        def prefill_chunk(*args, **kwargs):
            logits, cache = chunk(*args, **kwargs)
            self.flags.append(self.torch.isfinite(logits).all())
            return logits, cache

        self.lib.paged_decode_step = paged_decode_step
        self.lib.prefill_chunk = prefill_chunk
        return self

    def __exit__(self, *exc):
        self.lib.paged_decode_step, self.lib.prefill_chunk = self.saved

    def check(self, label):
        if not self.flags or not all(bool(f) for f in self.flags):
            raise AssertionError(f'{label}: non-finite logits in '
                                 f'{sum(not bool(f) for f in self.flags)} '
                                 f'of {len(self.flags)} steps')
        log(f'[{label}] logits finite in all {len(self.flags)} prefill '
            f'chunks and decode steps')


def decode_step_bytes(params, cfg, batch, context):
    """Bytes a decode step of the dense dispatch must move at least:
    every layer weight (each expert is read for every token) and the LM
    head once, ``batch`` embedding rows, and the K/V rows of
    ``context`` positions a sequence; operations: 2 per weight element
    and token, 4 per (query, key row, head dim)."""
    from skypilot_tpu_torch.models.quant import param_bytes
    weights = param_bytes(params['layers']) + param_bytes(
        params['lm_head']) + param_bytes(params['final_norm'])
    hd, kvh = cfg.resolved_head_dim, cfg.n_kv_heads
    kv = batch * context * cfg.n_layers * 2 * kvh * hd * 2
    rows = batch * cfg.d_model * 2
    n_weights = sum(t.numel() for t in _leaves(params['layers'])) + \
        params['lm_head']['w'].numel()
    ops = 2 * batch * n_weights + \
        4 * batch * context * cfg.n_layers * cfg.n_heads * hd
    return weights + kv + rows, ops


def decode_step_fns(torch, engine, context=256):
    """(one ``paged_decode_step`` of every slot at ``context`` cached
    rows, on a pool of its own so that the engine's pool and prefix
    cache stay untouched; the step's n_layers MoE blocks alone on its
    activations' shape)."""
    from skypilot_tpu_torch.models import decode as decode_lib
    from skypilot_tpu_torch.models import llama
    cfg, b = engine.cfg, engine.max_slots
    bps = context // 16 + 1
    cache = decode_lib.init_paged_cache(cfg, b * bps + 1, 16, b, bps,
                                        device='cuda')
    cache.block_tables.copy_(torch.arange(1, b * bps + 1, device='cuda',
                                          dtype=torch.int32).reshape(b, bps))
    cache.lengths.fill_(context)
    tokens = torch.arange(b, dtype=torch.int32, device='cuda') + 7
    active = torch.ones(b, dtype=torch.bool, device='cuda')
    x = torch.randn((b, 1, cfg.d_model), device='cuda').to(cfg.compute_dtype)
    moe = [decode_lib._layer(engine.params, i)['moe']
           for i in range(cfg.n_layers)]

    def step():
        with torch.no_grad():
            decode_lib.paged_decode_step(engine.params, tokens, cache, cfg,
                                         active=active)

    def blocks():
        with torch.no_grad():
            for lp in moe:
                llama._moe_block(x, lp, cfg, with_aux=False)

    return step, blocks


def events_ms(torch, fn, n=10):
    """Median device time of ``fn`` over ``n`` runs after one warm-up
    (CUDA events; the stream is idle before each)."""
    fn()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def profile_moe_share(torch, step, blocks, steps=4):
    """``--profile``: the device's kernel time in a traced window of
    ``steps`` decode steps and in one of as many runs of the step's MoE
    blocks alone; returns their ratio, the MoE blocks' share of the
    step's device time."""
    from torch.profiler import ProfilerActivity, profile
    busy = {}
    for tag, fn in (('profile-moe-step', step), ('profile-moe-blocks',
                                                 blocks)):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        busy[tag] = profile_summary(tag, prof, wall_us) * wall_us
    share = busy['profile-moe-blocks'] / busy['profile-moe-step']
    log(f'[profile-moe] device time a decode step '
        f'{busy["profile-moe-step"] / steps / 1e3:.2f} ms, of its MoE '
        f'blocks {busy["profile-moe-blocks"] / steps / 1e3:.2f} ms '
        f'({100 * share:.1f}%)')
    return share


def drive_moe_continuous(torch, pa, engine, label):
    """MOE_PROMPTS, concurrent, through /generate on the continuous
    engine (paged launches = n_layers a decode step, checked by
    ``drive_engine``), every logits row finite; returns (launches,
    decode tok/s, {prompt ids: tokens})."""
    probe = FiniteLogits(torch)
    with probe:
        counts, records, before, after, wall = drive_engine(
            torch, pa, engine, 'paged_attention', MOE_PROMPTS, MOE_NEW)
    probe.check(label)
    rate = decode_rate(before, after)
    steps = after['decode_steps'] - before['decode_steps']
    tokens = after['tokens_generated'] - before['tokens_generated']
    log(f'[{label}] {len(MOE_PROMPTS)} concurrent /generate: {tokens} '
        f'tokens in {steps} decode steps, decode {rate:.1f} tok/s, wall '
        f'{tokens / wall:.1f} tok/s ({wall:.2f} s)')
    return (counts['paged_attention'], rate,
            {tuple(ids): out for ids, out in records})


def agreement(a, b):
    """Share of ``b``'s tokens inside the common prefix of each pair."""
    shared = sum(common_prefix(a[k], b[k]) for k in b)
    return shared / max(1, sum(len(b[k]) for k in b))


# One full-width MoE block against plain fp32 dense dispatch: the
# largest per-token relative error (bf16 activations and experts, or
# int8 experts, against fp32 products of the same weights).
MOE_BLOCK_TOL = 2e-2
# The engines' first-step logits at fp32 (the same weights, upcast a
# layer at a time): the continuous engine's chunked prefill with plain
# chunk attention and the batch engine's flash prefill compute one
# function; the largest per-row relative error. At bf16 through 28
# layers of seeded weights the two paths part by several percent a row,
# as far as each lies from fp32 (printed, not gated: no limit there
# separates rounding from a fault).
ENGINE_FP32_TOL = 1e-3


def row_err(got, ref) -> float:
    """Largest relative error of a row (the last axis) of ``got``."""
    got, ref = got.float(), ref.float()
    return ((got - ref).norm(dim=-1) /
            ref.norm(dim=-1).clamp_min(1e-30)).max().item()


def plain_moe_block(torch, x, lp, cfg, k_top):
    """The reference's dense ``_moe_block`` written out in fp32: router
    logits, the top ``k_top`` and the softmax over them, every expert on
    every token, the outputs combined by the one-hot weights; an int8
    expert is q * scale. Returns (out, selected)."""
    F = torch.nn.functional

    def fp32(t):
        return t.q.float() * t.scale if hasattr(t, 'scale') else t.float()

    xf = x.float()
    logits = torch.einsum('bsd,de->bse', xf, fp32(lp['router']))
    top, selected = torch.topk(logits, k_top, dim=-1)
    combine = torch.zeros_like(logits).scatter_(-1, selected,
                                                torch.softmax(top, dim=-1))
    gate = torch.einsum('bsd,edf->ebsf', xf, fp32(lp['wi_gate']))
    up = torch.einsum('bsd,edf->ebsf', xf, fp32(lp['wi_up']))
    act = (F.gelu(gate, approximate='tanh')
           if cfg.activation == 'gelu_tanh' else F.silu(gate))
    out = torch.einsum('ebsf,efd->ebsd', act * up, fp32(lp['wo']))
    return torch.einsum('ebsd,bse->bsd', out, combine), selected


def check_moe_block(torch, params, cfg, label):
    """Layer 0's ``_moe_block`` (dense dispatch) at full width on the
    decode step's [4, 1] and a prefill's [4, 64] tokens against
    ``plain_moe_block``: the same choices, every token within
    MOE_BLOCK_TOL; the plain block with one choice too few (a planted
    fault) must exceed it. Returns the largest error."""
    from skypilot_tpu_torch.models import decode as decode_lib
    from skypilot_tpu_torch.models import llama
    lp = decode_lib._layer(params, 0)['moe']
    k_top = cfg.experts_per_token
    gen = torch.Generator(device='cuda').manual_seed(5)
    worst = 0.0
    for b, s in ((4, 1), (4, 64)):
        x = torch.randn((b, s, cfg.d_model), device='cuda',
                        generator=gen).to(cfg.compute_dtype)
        with torch.no_grad():
            got, _ = llama._moe_block(x, lp, cfg, with_aux=False)
            chosen = llama._route(x, lp['router'], k_top)[2]
            ref, selected = plain_moe_block(torch, x, lp, cfg, k_top)
            fault = plain_moe_block(torch, x, lp, cfg, k_top - 1)[0]
        err, fault_err = row_err(got, ref), row_err(fault, ref)
        same = torch.equal(chosen, selected)
        ok = (bool(torch.isfinite(got).all()) and same and
              err <= MOE_BLOCK_TOL < fault_err)
        log(f'[{label}] layer 0 MoE block, {b}x{s} tokens vs plain fp32 '
            f'dense dispatch: choices {"equal" if same else "DIFFER"}, '
            f'token error {err:.3e} (limit {MOE_BLOCK_TOL:g}); planted '
            f'{k_top - 1} choices {fault_err:.3e} '
            f'{"ok" if ok else "FAIL"}')
        if not ok:
            raise AssertionError(f'{label}: the MoE block disagrees with '
                                 f'plain fp32, or the planted fault passes')
        worst = max(worst, err)
        del x, got, ref, fault
    return worst


class _Upcast:
    """A stacked ``[L, ...]`` weight whose layer slices come out in
    fp32 (``decode._layer`` indexes every leaf)."""

    def __init__(self, stacked):
        self.stacked = stacked

    def __getitem__(self, index):
        return self.stacked[index].float()


def fp32_view(params):
    """``params`` read in fp32: embedding, head and norms copied, the
    layers upcast one at a time as the layer loop takes them."""
    def walk(node, lazy):
        if isinstance(node, dict):
            return {k: walk(v, lazy) for k, v in node.items()}
        return _Upcast(node) if lazy else node.float()
    return {k: walk(v, k == 'layers') for k, v in params.items()}


def first_step_logits(torch, engine, ids, chunk, params, cfg):
    """Each prompt's first-token logits through the batch engine's
    ``prefill`` (one padded batch, flash) and through the continuous
    engine's ``prefill_chunk`` (``chunk`` rows at a time, as its
    scheduler feeds them) on a pool of its own, both on ``params`` at
    ``cfg``: (batch [B, V], continuous [B, V])."""
    import numpy as np
    from skypilot_tpu_torch.models import decode as decode_lib
    lengths = np.array([len(x) for x in ids], np.int32)
    tokens, lens = engine._batch(ids, lengths)
    with torch.no_grad():
        batch, _ = decode_lib.prefill(params, tokens, lens, cfg,
                                      tokens.shape[1] + MOE_NEW)
    rows = []
    for prompt in ids:
        cache = decode_lib.init_paged_cache(cfg, 129, 16, 1, 128,
                                            device='cuda')
        cache.block_tables.copy_(torch.arange(
            1, 129, dtype=torch.int32, device='cuda')[None])
        for pos in range(0, len(prompt), chunk):
            part = prompt[pos:pos + chunk]
            window = torch.zeros((1, chunk), dtype=torch.int32,
                                 device='cuda')
            window[0, :len(part)] = torch.tensor(part, dtype=torch.int32)
            with torch.no_grad():
                last, cache = decode_lib.prefill_chunk(
                    params, window, pos, len(part), 0, cache, cfg)
        rows.append(last[0])
        del cache
    return batch[:len(ids)], torch.stack(rows)


def compare_engine_logits(torch, engine, ids, chunk, streams, batch_out):
    """``first_step_logits`` of both engines at fp32, held to
    ENGINE_FP32_TOL (the batch rows rolled by one prompt, a planted
    fault, must exceed it), and at bf16 (the engines' own params),
    printed beside each bf16 path's distance from the fp32 batch rows,
    with the fp32 top-2 gaps of the rows and each engine's first token.
    Returns a dict of the readings."""
    import dataclasses
    cfg = engine.cfg
    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    bf_batch, bf_cont = first_step_logits(torch, engine, ids, chunk,
                                          engine.params, cfg)
    fp_batch, fp_cont = first_step_logits(
        torch, engine, ids, chunk, fp32_view(engine.params), cfg32)
    err32 = row_err(fp_cont, fp_batch)
    fault = row_err(fp_cont, torch.roll(fp_batch, 1, dims=0))
    out = dict(fp32_err=err32, bf16_err=row_err(bf_cont, bf_batch),
               bf16_batch_vs_fp32=row_err(bf_batch, fp_batch),
               bf16_continuous_vs_fp32=row_err(bf_cont, fp_batch),
               bf16_largest_diff=(bf_cont - bf_batch).abs().max().item())
    top2 = torch.topk(fp_batch, 2, dim=-1).values
    out['fp32_top2_gaps'] = (top2[:, 0] - top2[:, 1]).tolist()
    argmax = dict(fp32=list(zip(fp_cont.argmax(-1).tolist(),
                                fp_batch.argmax(-1).tolist())),
                  bf16=list(zip(bf_cont.argmax(-1).tolist(),
                                bf_batch.argmax(-1).tolist())),
                  served=[(streams[tuple(x)][0], o[0])
                          for x, o in zip(ids, batch_out)])
    finite = all(bool(torch.isfinite(t).all()) for t in
                 (bf_batch, bf_cont, fp_batch, fp_cont))
    ok = finite and err32 <= ENGINE_FP32_TOL < fault
    log(f'[moe] first-step logits, continuous (chunks of {chunk}, plain '
        f'chunk attention) vs batch engine (flash prefill): fp32 row '
        f'error {err32:.3e} (limit {ENGINE_FP32_TOL:g}; planted rolled '
        f'rows {fault:.3e}); bf16 row error {out["bf16_err"]:.3e}, '
        f'largest difference {out["bf16_largest_diff"]:.3e}, bf16 from '
        f'fp32: batch {out["bf16_batch_vs_fp32"]:.3e}, continuous '
        f'{out["bf16_continuous_vs_fp32"]:.3e}; fp32 top-2 gaps '
        f'{", ".join(f"{g:.3e}" for g in out["fp32_top2_gaps"])}; argmax '
        f'(continuous, batch) {json.dumps(argmax)} '
        f'{"ok" if ok else "FAIL"}')
    if not ok:
        raise AssertionError('moe: the engines\' fp32 first-step logits '
                             'disagree, or the planted fault passes')
    return out


def phase_moe_serving(torch, pa, da, fa, params, param_gb, bw,
                      flops_peak, profile_window=False):
    """Phase 22: deepseek-moe-16b (28 layers, 64 experts top 6, MHA 16
    heads of 128; dense dispatch) on both engines behind the port's HTTP
    server: layer 0's MoE block against plain fp32 (check_moe_block);
    the continuous engine (4 slots, max_len 2048) and the batch engine
    (max_batch 4) serve MOE_PROMPTS with 32 new tokens; paged and decode
    launches move by 28 a decode step; the engines' first-step logits
    held to each other at fp32 (compare_engine_logits); their greedy tokens
    compared (printed, not gated: bf16 near-ties); a decode step against
    its bound; peak memory."""
    from skypilot_tpu_torch.inference.continuous import (
        ContinuousBatchingEngine)
    from skypilot_tpu_torch.inference.engine import InferenceEngine
    from skypilot_tpu_torch.models.config import get_model_config
    cfg = get_model_config('deepseek-moe-16b')
    n_layers = cfg.n_layers
    result = {'param_gb': param_gb,
              'block_err': check_moe_block(torch, params, cfg, 'moe')}
    torch.cuda.reset_peak_memory_stats()
    free_card(torch)
    engine = ContinuousBatchingEngine('deepseek-moe-16b', params=params,
                                      max_slots=4, max_len=2048,
                                      block_size=16)
    chunk = engine.prefill_chunk
    try:
        engine.generate_ids([1, 2, 3], max_new_tokens=2)  # warm-up
        launches, rate, streams = drive_moe_continuous(
            torch, pa, engine, 'moe')
        result.update(launches=launches, continuous_tok_s=rate)
        step, blocks = decode_step_fns(torch, engine)
        step_ms, moe_ms = events_ms(torch, step), events_ms(torch, blocks)
        nbytes, ops = decode_step_bytes(engine.params, cfg, 4, 257)
        bytes_ms, ops_ms = nbytes / bw * 1e3, ops / flops_peak * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        result.update(step_ms=step_ms, step_bound_ms=bound_ms,
                      moe_ms=moe_ms)
        log(f'[moe] decode step of 4 slots at 256 cached rows: '
            f'{step_ms:.2f} ms (CUDA events, median of 10); bound '
            f'{bound_ms:.2f} ms ({nbytes / 1e9:.2f} GB at '
            f'{bw / 1e12:.2f} TB/s; operations {ops_ms:.3f} ms), '
            f'{100 * bound_ms / step_ms:.1f}% of bound; its 28 MoE blocks '
            f'alone {moe_ms:.2f} ms ({100 * moe_ms / step_ms:.1f}% of the '
            f'step)')
        if profile_window:
            result['moe_share_profiled'] = profile_moe_share(torch, step,
                                                             blocks)
        del step, blocks
    finally:
        engine.shutdown()
    del engine

    engine = InferenceEngine('deepseek-moe-16b', params=params, max_batch=4)
    ids = [engine.tokenizer.encode(p) for p in MOE_PROMPTS]
    if not all(128 < len(x) <= 256 for x in ids):
        raise AssertionError(f'prompt lengths {[len(x) for x in ids]}')
    engine.generate_text(['warmup'], max_new_tokens=8)
    outputs, counts, flash, fallbacks, delta, wall = drive_batch(
        torch, da, fa, engine, MOE_PROMPTS, MOE_NEW)
    check_batch_counts('moe batch engine', counts, flash, fallbacks,
                       {'decode_attention': n_layers * MOE_NEW,
                        'decode_attention_quant': 0}, n_layers)
    result['batch_launches'] = counts['decode_attention']
    result['batch_tok_s'] = delta['tokens_generated'] / delta[
        'decode_seconds']
    log(f'[moe-batch] one /generate of 4 prompts: decode_attention '
        f'{counts["decode_attention"]} launches = {n_layers} layers x '
        f'{MOE_NEW} steps, flash fwd {flash["flash_fwd"]}; '
        f'{delta["tokens_generated"]} tokens in '
        f'{delta["decode_seconds"]:.3f} s = {result["batch_tok_s"]:.1f} '
        f'tok/s (prefill included); request wall {wall:.3f} s')
    batch_out = engine.generate_ids(ids, max_new_tokens=MOE_NEW)
    result['peak_gb'] = torch.cuda.max_memory_allocated() / 1e9
    log(f'[moe] peak memory of both engines {result["peak_gb"]:.2f} GB '
        f'(weights {param_gb:.2f} GB)')
    result['first_step'] = compare_engine_logits(
        torch, engine, ids, chunk, streams, batch_out)
    del engine
    mine = {tuple(x): out for x, out in zip(ids, batch_out)}
    share = agreement(streams, mine)
    result['engines_agree'] = share
    log(f'[moe] greedy tokens, batch vs continuous engine: '
        f'{100 * share:.1f}% of the batch engine\'s tokens in the common '
        f'prefix (not gated: bf16 near-ties; first-step logits above)')
    result['streams'] = streams
    return result


def phase_moe_int8(torch, pa, qparams, bf16_gb, bf16_streams):
    """Phase 23: the same continuous-engine requests on
    ``quantize_params(params, quantize_moe=True)`` (int8 experts with
    per-(layer, expert, out-channel) scales, W8A8 attention and head,
    fp32 router): param bytes below 0.55x the bf16 tree, layer 0's MoE
    block against plain fp32 of the dequantized experts, every request
    complete with finite logits, greedy agreement with phase 22
    printed."""
    from skypilot_tpu_torch.inference.continuous import (
        ContinuousBatchingEngine)
    from skypilot_tpu_torch.models.config import get_model_config
    from skypilot_tpu_torch.models.quant import param_bytes
    q_gb = param_bytes(qparams) / 1e9
    log(f'[moe-int8] int8 experts: {q_gb:.2f} GB = '
        f'{q_gb / bf16_gb:.3f}x the bf16 tree (limit 0.55)')
    if not q_gb < 0.55 * bf16_gb:
        raise AssertionError('int8 experts: param bytes not below 0.55x')
    block_err = check_moe_block(
        torch, qparams, get_model_config('deepseek-moe-16b'), 'moe-int8')
    free_card(torch)
    engine = ContinuousBatchingEngine('deepseek-moe-16b', params=qparams,
                                      max_slots=4, max_len=2048,
                                      block_size=16)
    try:
        launches, rate, streams = drive_moe_continuous(
            torch, pa, engine, 'moe-int8')
    finally:
        engine.shutdown()
    share = agreement(bf16_streams, streams)
    log(f'[moe-int8] greedy tokens vs the bf16 weights: {100 * share:.1f}% '
        f'in the common prefix (not gated)')
    return dict(launches=launches, tok_s=rate, param_gb=q_gb,
                agree=share, block_err=block_err)


def phase_gpt_oss(torch, pa):
    """Phase 24: gpt-oss-20b at full width (d_model 2880, 32 experts top
    4, 64 heads / 8 kv heads of dim 64, vocab 201088) and 4 of its 24
    layers on the continuous engine: the paged kernel at D=64, G=8, 4
    launches a decode step."""
    from skypilot_tpu_torch.inference.continuous import (
        ContinuousBatchingEngine)
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.models.config import get_model_config
    from skypilot_tpu_torch.models.quant import param_bytes
    cfg = get_model_config('gpt-oss-20b', n_layers=4)
    params = llama.init_params(1, cfg, device='cuda',
                               weight_dtype=cfg.compute_dtype)
    log(f'[gpt-oss] 4 layers: {param_bytes(params) / 1e9:.2f} GB')
    engine = ContinuousBatchingEngine('gpt-oss-20b', cfg=cfg, params=params,
                                      max_slots=4, max_len=2048,
                                      block_size=16)
    try:
        engine.generate_ids([1, 2, 3], max_new_tokens=2)
        launches, rate, _ = drive_moe_continuous(torch, pa, engine,
                                                 'gpt-oss')
    finally:
        engine.shutdown()
    del engine, params
    free_card(torch)
    return dict(launches=launches, tok_s=rate)


def phase_moe_train(torch, fa, steps=3):
    """Phase 25: ``make_train_step`` on deepseek-moe-16b at 2 of its 28
    layers (full width; AdamW, fp32 params, full remat) with capacity
    dispatch, B=4, S=1024: finite losses, router_aux >= 1 - 1e-6 (1 at
    uniform balance), flash launches 2L / L / L a step, no call outside
    the kernels."""
    from skypilot_tpu_torch.models.config import get_model_config
    from skypilot_tpu_torch.train import step as st
    from skypilot_tpu_torch.train.pretrain import synthetic_batch
    cfg = get_model_config('deepseek-moe-16b', n_layers=2,
                           moe_dispatch='capacity')
    hp = st.TrainHParams(warmup_steps=1, total_steps=10)
    torch.cuda.reset_peak_memory_stats()
    state = st.create_train_state(0, cfg, hp, device='cuda')
    step_fn = st.make_train_step(cfg, hp)
    batches = [synthetic_batch(i, 4, 1024, cfg.vocab_size,
                               torch.device('cuda')) for i in range(steps)]
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    metrics, times = [], []
    for batch in batches:
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        metrics.append({k: float(m[k]) for k in
                        ('loss', 'total_loss', 'router_aux', 'grad_norm')})
    counts, fallbacks = dict(fa.LAUNCHES), dict(fa.FALLBACKS)
    peak = torch.cuda.max_memory_allocated() / 1e9
    del state, batches
    free_card(torch)
    n = cfg.n_layers * steps
    expected = {'flash_fwd': 2 * n, 'flash_dq': n, 'flash_dkv': n,
                'flash_fwd_seg': 0, 'flash_dq_seg': 0, 'flash_dkv_seg': 0}
    for i, m in enumerate(metrics):
        log(f'[moe-train] step {i + 1}: {json.dumps(m)} in '
            f'{times[i]:.3f} s')
    ok = all(math.isfinite(m['loss']) and math.isfinite(m['total_loss'])
             and m['router_aux'] >= 1 - 1e-6 for m in metrics)
    if not ok or counts != expected or fallbacks['cuda']:
        raise AssertionError(
            f'moe-train: metrics {metrics}, flash launches {counts} '
            f'(expected {expected}), calls outside the kernels {fallbacks}')
    log(f'[moe-train] capacity dispatch, B=4 S=1024: steps 2-{steps} '
        f'{statistics.median(times[1:]):.3f} s, peak {peak:.2f} GB; flash '
        f'launches {counts} = 2x{cfg.n_layers} fwd, {cfg.n_layers} dq, '
        f'{cfg.n_layers} dkv x {steps} steps')
    return dict(launches=counts, metrics=metrics, peak_gb=peak)


def run_moe_phases(torch, pa, da, fa, bw, flops_peak,
                   profile_window=False):
    """Phases 22-25 in order, deepseek-moe-16b's bf16 weights freed once
    they are quantized; returns the launch counts for the kernels line
    and a summary."""
    from skypilot_tpu_torch.models.quant import quantize_params
    t0 = time.perf_counter()
    params, nbytes = deepseek_params(torch)
    serving = phase_moe_serving(torch, pa, da, fa, params, nbytes / 1e9,
                                bw, flops_peak,
                                profile_window=profile_window)
    t_quant = time.perf_counter()
    qparams = quantize_params(params, quantize_moe=True)
    del params
    free_card(torch)
    torch.cuda.synchronize()
    log(f'[moe-int8] quantized in {time.perf_counter() - t_quant:.1f} s')
    int8 = phase_moe_int8(torch, pa, qparams, nbytes / 1e9,
                          serving.pop('streams'))
    del qparams
    free_card(torch)
    t1 = time.perf_counter()
    oss = phase_gpt_oss(torch, pa)
    t2 = time.perf_counter()
    train = phase_moe_train(torch, fa)
    log(f'[smoke] MoE phases {time.perf_counter() - t0:.1f} s: deepseek '
        f'serving and int8 {t1 - t0:.1f} s, gpt-oss {t2 - t1:.1f} s, '
        f'training {time.perf_counter() - t2:.1f} s')
    summary = dict(serving=serving, int8={k: v for k, v in int8.items()},
                   gpt_oss=oss, train={k: train[k] for k in
                                       ('metrics', 'peak_gb')})
    log(f'[moe] summary {json.dumps(summary)}')
    return dict(paged=serving['launches'] + int8['launches'] +
                oss['launches'], decode=serving['batch_launches'],
                train=train['launches'])


def _leaves(tree):
    if isinstance(tree, dict):
        for value in tree.values():
            yield from _leaves(value)
    else:
        yield tree


# ---------------------------------------------------------------------------
# Phase 31: tensor-parallel serving, llama3-8b at tensor=2 on the one card
# ---------------------------------------------------------------------------

# The first decode step's logits under tensor=2 against one rank's, per
# row: ||tp - one|| / ||one||. Justification: the two runs differ only
# in where the row-parallel projections (wo and mlp.wo, 64 a step) round
# to bf16: one rank rounds its single fp32-accumulated GEMM, tensor=2
# sums two fp32 partials and rounds once; the results differ by at most
# one bf16 ulp (2^-8 relative) in an element, about 2^-9 on average, and
# 64 independent such perturbations compound as a random walk through
# the residual stream: sqrt(64) * 2^-9 = 1.6e-2. The limit is three
# times that.
TP_LOGIT_TOL = 5e-2
TP_TIMED = 'continuous int8 KV, collectives timed'
TP_RUNS = (('continuous', {}), (TP_TIMED, {'quantize_kv': True}),
           ('continuous speculative', {'spec_decode': True, 'draft_k': 4}),
           ('batch', {}), ('batch int8 KV', {'quantize_kv': True}))


def tp_prompts():
    text = ('Tensor parallelism splits every attention head group and '
            'every MLP column block across the ranks. ') * 4
    return [text[:n] for n in (130, 170, 211, 254)]


def _tp_engine(label, options):
    from skypilot_tpu_torch.inference.continuous import (
        ContinuousBatchingEngine)
    from skypilot_tpu_torch.inference.engine import InferenceEngine
    if label.startswith('batch'):
        return InferenceEngine('llama3-8b', seed=0, mesh='tensor=2',
                               max_batch=4, **options)
    return ContinuousBatchingEngine('llama3-8b', seed=0, mesh='tensor=2',
                                    max_slots=4, max_len=2048,
                                    block_size=16, **options)


def tp_rank(rank, world, prompts, new):
    """One rank of phase 31. Every rank builds each run's engine from
    the seeded init (its shard of llama3-8b), zeroes the launch counts,
    and serves: the driver drives the prompts, the follower runs its
    plans until the driver shuts down; then both read the counts. After
    the batch engine, both ranks run one prefill and one decode step on
    its shards for the logits check. Returns each run's counts, stats
    (driver), peak and steady memory, and the driver's logits."""
    import gc
    import numpy as np
    import torch
    from skypilot_tpu_torch.models import decode as decode_lib
    from skypilot_tpu_torch.ops import decode_attention as da
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.ops import paged_attention as pa
    from skypilot_tpu_torch.parallel import sharding as psharding
    out = {'rank': rank, 'runs': {}}
    for label, options in TP_RUNS:
        psharding.time_collectives(label == TP_TIMED)
        psharding.collective_stats(reset=True)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        engine = _tp_engine(label, options)
        steady_gb = torch.cuda.memory_allocated() / 1e9
        run = {'init_peak_gb': torch.cuda.max_memory_allocated() / 1e9,
               'steady_gb': steady_gb}
        torch.cuda.synchronize()
        for module in (pa, da, fa):
            module.reset_launch_counts()
        if engine.is_driver:
            before = (dict(engine.stats) if label.startswith('batch')
                      else engine.stats())
            ids = [engine.tokenizer.encode(p) for p in prompts]
            t0 = time.perf_counter()
            if label.startswith('batch'):
                run['tokens'] = engine.generate_ids(ids, max_new_tokens=new)
            else:
                handles = [engine.submit_ids(x, max_new_tokens=new)
                           for x in ids]
                for h in handles:
                    if not h.done.wait(600) or h.error is not None:
                        raise RuntimeError(f'request failed: {h.error}')
                run['tokens'] = [list(h.generated) for h in handles]
            torch.cuda.synchronize()
            run['wall_s'] = time.perf_counter() - t0
            after = (dict(engine.stats) if label.startswith('batch')
                     else engine.stats())
            run['delta'] = {k: after[k] - before[k] for k in before
                            if isinstance(before[k], (int, float))}
            run['mesh'] = {k: v for k, v in after.items()
                           if k.startswith('mesh')}
            run['collectives'] = psharding.collective_stats()
            engine.shutdown()
        else:
            engine.follow()
        torch.cuda.synchronize()
        run['launches'] = {**dict(pa.LAUNCHES), **dict(da.LAUNCHES),
                           **{k: v for k, v in fa.LAUNCHES.items()
                              if k == 'flash_fwd'}}
        run['flash_fallbacks'] = fa.FALLBACKS['cuda']
        run['peak_gb'] = torch.cuda.max_memory_allocated() / 1e9
        if label == 'batch':
            # The logits check: one prefill and one decode step on the
            # shards, every rank in the mesh context (SPMD).
            ids = [engine.tokenizer.encode(p) for p in prompts]
            with torch.no_grad(), psharding.mesh_context(engine._tp):
                tokens, lens = engine._batch(
                    ids, np.array([len(x) for x in ids], np.int32))
                logits0, cache = decode_lib.prefill(
                    engine.params, tokens, lens, engine.cfg,
                    tokens.shape[1] + 8)
                first = torch.argmax(logits0, dim=-1).to(torch.int32)
                logits1, _ = decode_lib.decode_step(engine.params, first,
                                                    cache, engine.cfg)
            if engine.is_driver:
                run['logits'] = logits1[:len(ids)].float().cpu().numpy()
        out['runs'][label] = run
        del engine
    psharding.time_collectives(False)
    return out


def tp_single_rank(torch, prompts, new):
    """The same prompts on one rank, from llama3_params' weights (the
    same seeded init): the batch engine's tokens, its first decode
    step's logits (as in tp_rank) and the continuous engine's decode
    rate."""
    import numpy as np
    from skypilot_tpu_torch.inference.continuous import (
        ContinuousBatchingEngine)
    from skypilot_tpu_torch.inference.engine import InferenceEngine
    from skypilot_tpu_torch.models import decode as decode_lib
    params = llama3_params(torch)
    batch = InferenceEngine('llama3-8b', params=params, max_batch=4)
    ids = [batch.tokenizer.encode(p) for p in prompts]
    out = {'tokens': batch.generate_ids(ids, max_new_tokens=new)}
    with torch.no_grad():
        tokens, lens = batch._batch(ids, np.array([len(x) for x in ids],
                                                  np.int32))
        logits0, cache = decode_lib.prefill(batch.params, tokens, lens,
                                            batch.cfg, tokens.shape[1] + 8)
        first = torch.argmax(logits0, dim=-1).to(torch.int32)
        logits1, _ = decode_lib.decode_step(batch.params, first, cache,
                                            batch.cfg)
    out['logits'] = logits1[:len(ids)].float().cpu().numpy()
    del batch, cache, logits0, logits1
    free_card(torch)
    engine = ContinuousBatchingEngine('llama3-8b', params=params,
                                      max_slots=4, max_len=2048,
                                      block_size=16)
    try:
        before = engine.stats()
        concurrent_ids(engine, prompts, new)
        out['decode_tok_s'] = decode_rate(before, engine.stats())
    finally:
        engine.shutdown()
    del engine, params
    free_card(torch)
    return out


def tp_shard_times(torch, pa, da, fa, bw, flops_peak):
    """Kernels 1-5 at one rank's shapes of llama3-8b at tensor=2 (H=16,
    KVH=4): the continuous engine's 4 slots (paged, bf16 and int8), the
    batch engine's B=4 T=272 (decode, bf16 and int8) and its prefill
    B=4 S=256 (flash forward): kernel, plain and bound."""
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8,
                        device='cuda')
    rows = {}
    for name, pool in (('paged_attention', 'bf16'),
                       ('paged_attention_quant', 'int8')):
        c = make_case(torch, pool=pool, seed=700, **dict(
            TP_HEADS, bs=16, bps=128, b=4, lengths=[1, 17, 1000, 2048],
            q_len=1))
        rows[name] = dict(ms=time_ms(torch, lambda: run_kernel(pa, c), flush),
                          plain_ms=time_ms(torch, lambda: run_plain(pa, c),
                                           flush))
        rows[name]['bound_ms'], rows[name]['bound_by'] = bound(
            c, 16, 128, bw, flops_peak)
        del c
    for name, cache in (('decode_attention', 'bf16'),
                        ('decode_attention_quant', 'int8')):
        c = decode_case(torch, cache=cache, seed=701, **TP_DECODE)
        rows[name] = dict(ms=time_ms(torch, lambda: run_decode(da, c), flush),
                          plain_ms=time_ms(torch,
                                           lambda: run_decode_plain(da, c),
                                           flush))
        rows[name]['bound_ms'], rows[name]['bound_by'] = decode_bound(
            c, bw, flops_peak)
        del c
    q, k, v, _, _ = flash_case(torch, b=4, s=256, h=16, kvh=4, d=128,
                               dtype='bf16', segments=False, seed=702)
    rows['flash_fwd'] = dict(
        ms=time_ms(torch, lambda: fa.flash_forward_kernel(q, k, v), flush),
        plain_ms=time_ms(torch, lambda: fa.flash_forward_reference(q, k, v),
                         flush))
    rows['flash_fwd']['bound_ms'], rows['flash_fwd']['bound_by'] = \
        flash_bound(4, 256, 16, 4, 128, 2, 'fwd', bw, flops_peak)
    del q, k, v, flush
    for name, row in rows.items():
        log(f'[tp] {name} at the tensor=2 shard shape: kernel '
            f'{row["ms"]:.4f} ms, plain {row["plain_ms"]:.4f} ms, bound '
            f'{row["bound_ms"]:.4f} ms ({row["bound_by"]}), '
            f'{100 * row["bound_ms"] / row["ms"]:.1f}% of bound')
    return rows


def check_tp_runs(ranks, n_layers, new):
    """Each rank's launches against the driver's steps: paged n_layers a
    decode or verify step, decode n_layers x ``new``, flash n_layers a
    batch prefill, no flash fallback; both ranks alike."""
    driver = ranks[0]['runs']
    for label, _ in TP_RUNS:
        delta = driver[label]['delta']
        if label.startswith('batch'):
            kernel = ('decode_attention_quant' if 'int8' in label
                      else 'decode_attention')
            expected = {kernel: n_layers * new, 'flash_fwd': n_layers}
        else:
            kernel = ('paged_attention_quant' if 'int8' in label
                      else 'paged_attention')
            steps = delta['decode_steps'] + delta['verify_steps']
            if steps <= 0 or ('speculative' in label) != (
                    delta['verify_steps'] > 0):
                raise AssertionError(f'[tp] {label}: steps {delta}')
            expected = {kernel: n_layers * steps, 'flash_fwd': 0}
        for r in ranks:
            run = r['runs'][label]
            got = {k: run['launches'][k] for k in expected}
            others = {k: v for k, v in run['launches'].items()
                      if k not in expected and v}
            if got != expected or others or run['flash_fallbacks']:
                raise AssertionError(
                    f'[tp] rank {r["rank"]} {label}: launches '
                    f'{run["launches"]} (expected {expected}), flash '
                    f'fallbacks {run["flash_fallbacks"]}')
        log(f'[tp] {label}: each rank launched {expected} ('
            f'{n_layers} layers x {delta.get("decode_steps", new)} decode '
            f'+ {delta.get("verify_steps", 0)} verify steps)')


def tp_server(torch, prompts, smi):
    """``inference.server --mesh tensor=2`` on the card as a user starts
    it: it starts its own two ranks; /generate and /v1/completions
    answer, /stats names the mesh and the backend; SIGTERM stops it."""
    import signal
    import socket
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        port = sock.getsockname()[1]
    cmd = [sys.executable, '-m', 'skypilot_tpu_torch.inference.server',
           '--model', 'llama3-8b', '--mesh', 'tensor=2', '--engine',
           'continuous', '--max-batch', '4', '--max-len', '2048',
           '--host', '127.0.0.1', '--port', str(port)]
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=root, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        while True:
            if proc.poll() is not None:
                raise AssertionError('--mesh server exited: ' +
                                     proc.stdout.read()[-4000:])
            try:
                get_url(port, '/health')
                break
            except OSError:
                if time.perf_counter() - t0 > 300:
                    raise AssertionError('--mesh server never came up')
                time.sleep(1.0)
        up_s = time.perf_counter() - t0
        gen = post_json(port, '/generate', {'prompts': prompts[:2],
                                            'max_new_tokens': 16})
        comp = post_json(port, '/v1/completions',
                         {'prompt': prompts[0], 'max_tokens': 16})
        stats = json.loads(get_url(port, '/stats'))
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    if len(gen.get('outputs', [])) != 2 or not comp.get('choices'):
        raise AssertionError(f'[tp] server payloads {gen} {comp}')
    if stats.get('mesh') != "Mesh({'tensor': 2})" or \
            stats.get('mesh_backend') not in ('gloo', 'nccl') or \
            len(stats.get('mesh_devices', [])) != 2:
        raise AssertionError(f'[tp] /stats does not name the mesh: {stats}')
    log(f'[tp] server --mesh tensor=2 up in {up_s:.1f} s; /generate and '
        f'/v1/completions answered; /stats mesh {stats["mesh"]}, backend '
        f'{stats["mesh_backend"]}, devices {stats["mesh_devices"]}; {smi}')
    return {'up_s': up_s, 'backend': stats['mesh_backend']}


def phase_tp(torch, pa, da, fa, bw, flops_peak, smi):
    """Phase 31: llama3-8b at full width and depth served at tensor=2 by
    two ranks that share the one card (gloo), both engines, then the
    --mesh server. Returns the launch totals for the kernels line and
    the numbers PERF.md keeps."""
    from skypilot_tpu_torch.models.config import get_model_config
    from skypilot_tpu_torch.parallel.launch import launch
    import numpy as np
    t0 = time.perf_counter()
    n_layers = get_model_config('llama3-8b').n_layers
    shard = tp_shard_times(torch, pa, da, fa, bw, flops_peak)
    free_card(torch)
    prompts = tp_prompts()
    ranks = launch(tp_rank, 2, prompts, TP_NEW, device='cuda')
    t1 = time.perf_counter()
    check_tp_runs(ranks, n_layers, TP_NEW)
    single = tp_single_rank(torch, prompts, TP_NEW)
    driver = ranks[0]['runs']
    tp_logits, one = driver['batch']['logits'], single['logits']
    rel = (np.linalg.norm(tp_logits - one, axis=-1) /
           np.linalg.norm(one, axis=-1))
    abs_err = float(np.abs(tp_logits - one).max())
    prefix = [common_prefix(a, b) for a, b in
              zip(driver['batch']['tokens'], single['tokens'])]
    label = 'two ranks on one card over gloo: not a TP speed'
    log(f'[tp] first decode step logits, tensor=2 vs one rank: relative '
        f'L2 per row {[float(f"{x:.3e}") for x in rel]} (limit '
        f'{TP_LOGIT_TOL:g}), max abs {abs_err:.3e}; common greedy prefix '
        f'of {TP_NEW} tokens {prefix} (not gated)')
    if not np.isfinite(tp_logits).all() or rel.max() > TP_LOGIT_TOL:
        raise AssertionError(f'[tp] tensor=2 logits off one rank\'s: {rel}')
    plain = driver['continuous']
    tok_s = (plain['delta']['tokens_generated'] /
             plain['delta']['decode_seconds'])
    timed = driver[TP_TIMED]
    share = timed['collectives']['seconds'] / timed['wall_s']
    for r in ranks:
        peaks = {k: round(v['peak_gb'], 2) for k, v in r['runs'].items()}
        log(f'[tp] rank {r["rank"]} peak GB by run {peaks}; steady after '
            f'build {r["runs"]["continuous"]["steady_gb"]:.2f} GB ({smi})')
    log(f'[tp] decode {tok_s:.1f} tok/s at tensor=2 vs '
        f'{single["decode_tok_s"]:.1f} tok/s on one rank (4 requests, '
        f'{TP_NEW} new; {label}; {smi})')
    log(f'[tp] collectives {timed["collectives"]["calls"]} calls, '
        f'{timed["collectives"]["seconds"]:.3f} s of a '
        f'{timed["wall_s"]:.3f} s run = {100 * share:.1f}% of it, each '
        f'timed with the card synchronized ({label}; {smi})')
    log(f'[tp] backend {driver["continuous"]["mesh"]["mesh_backend"]}, '
        f'devices {driver["continuous"]["mesh"]["mesh_devices"]}')
    server = tp_server(torch, prompts, smi)
    launches = {}
    for r in ranks:
        for run in r['runs'].values():
            for k, v in run['launches'].items():
                launches[k] = launches.get(k, 0) + v
    log(f'[smoke] phase 31 {time.perf_counter() - t0:.1f} s (ranks '
        f'{t1 - t0:.1f} s)')
    return {'launches': launches, 'tok_s': tok_s,
            'single_tok_s': single['decode_tok_s'],
            'collective_share': share, 'logit_rel': float(rel.max()),
            'shard_times': shard, 'server': server}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--skip-engine', action='store_true',
                        help='stop after the kernel checks (no training, '
                             'no engine)')
    parser.add_argument('--profile', action='store_true',
                        help='also trace two bench-1b7 train steps and '
                             'one batch of llama3-8b requests on each '
                             'engine with torch.profiler (device busy '
                             'share, top kernels)')
    args = parser.parse_args(argv)
    started = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device available', file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from skypilot_tpu_torch import _build
    from skypilot_tpu_torch.ops import decode_attention as da
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.ops import paged_attention as pa
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    card, bw, flops_peak = card_peaks(kind)
    log(f'[device] {smi}; peaks used: {card} {bw / 1e12:.2f} TB/s, '
        f'{flops_peak / 1e12:.0f} TFLOP/s bf16; torch {torch.__version__} '
        f'cuda {torch.version.cuda}')

    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f'[build] {len(libs)} kernel libraries in '
        f'{time.perf_counter() - t0:.1f} s: {libs}')
    t0 = time.perf_counter()
    rows = phase_kernels(torch, pa, bw, flops_peak)
    t1 = time.perf_counter()
    rows.update(phase_decode_kernels(torch, da, bw, flops_peak))
    t2 = time.perf_counter()
    flash_rows, backward_ms = phase_flash_kernels(torch, fa, bw, flops_peak)
    rows.update(flash_rows)
    log(f'[smoke] kernel phases: paged {t1 - t0:.1f} s, decode '
        f'{t2 - t1:.1f} s, flash {time.perf_counter() - t2:.1f} s')
    engine, train, batch, spec, lora = {}, {}, {}, {}, {}
    bench_tr, remat, packed, bench_dec, moe = {}, {}, {}, {}, {}
    ckpt, disagg, rl, tp = {}, {}, {}, {}
    if not args.skip_engine:
        phase_train_small(torch)
        train = phase_train(torch, fa, flops_peak)
        from skypilot_tpu_torch.models.config import get_model_config
        n_layers = get_model_config('bench-1b7').n_layers
        attn_ms = (2 * rows['flash_fwd']['ms'] + backward_ms) * n_layers
        log(f'[train] attention per step from the kernel times: '
            f'{attn_ms:.1f} ms of {1e3 * train["step_s"]:.1f} ms '
            f'({100 * attn_ms / (1e3 * train["step_s"]):.1f}%)')
        if args.profile:
            train['device_busy_share'] = profile_train(
                torch, get_model_config('bench-1b7'))
        log(f'[train] summary {json.dumps(train)}')
        phase_small_agreement(torch)
        params = llama3_params(torch)
        engine = phase_engine(torch, pa, params,
                              profile_window=args.profile)
        log('[engine] summary ' + json.dumps(
            {k: v for k, v in engine.items() if k != 'plain_streams'}))
        phase_small_batch_agreement(torch, da)
        batch = phase_batch_engine(torch, da, fa, params,
                                   profile_window=args.profile)
        log(f'[batch] summary {json.dumps(batch)}')
        phase_small_spec_lora(torch)
        spec = phase_spec_engine(torch, pa, params, engine)
        log(f'[spec] summary {json.dumps(spec)}')
        lora = phase_lora_engine(torch, pa, params)
        log(f'[lora] summary {json.dumps(lora)}')
        ckpt = run_checkpoint_phases(torch, pa, da, fa, params, engine)
        log(f'[ckpt] summary {json.dumps(ckpt)}')
        disagg = phase_disagg(torch, pa, params)
        log(f'[disagg] summary {json.dumps(disagg)}')
        del params
        free_card(torch)
        rl = run_rl_phases(torch, pa, fa)
        log('[rl] phases 29-30 summary ' + json.dumps(
            {k: v for k, v in rl.items() if k in ('grpo', 'pipeline')}))
        t0 = time.perf_counter()
        bench_tr = phase_bench_train(torch, fa)
        remat = phase_remat(torch, fa)
        packed = phase_packed(torch, fa)
        phase_resume(torch, fa)
        t1 = time.perf_counter()
        bench_dec = phase_bench_decode(torch, da, fa)
        phase_bench_kernels(torch)
        log(f'[smoke] phases 16-19 {t1 - t0:.1f} s, 20-21 '
            f'{time.perf_counter() - t1:.1f} s')
        moe = run_moe_phases(torch, pa, da, fa, bw, flops_peak,
                             profile_window=args.profile)
        free_card(torch)
        tp = phase_tp(torch, pa, da, fa, bw, flops_peak, smi)
        log('[tp] phase 31 summary ' + json.dumps(
            {k: v for k, v in tp.items() if k != 'launches'}))
    flash_src = 'skypilot_tpu/ops/pallas/flash_attention.py'
    replaces = {
        'paged_attention':
            'skypilot_tpu/ops/pallas/paged_attention.py:64',
        'paged_attention_quant':
            'skypilot_tpu/ops/pallas/paged_attention.py:124',
        'decode_attention':
            'skypilot_tpu/ops/pallas/decode_attention.py:42 _decode_kernel',
        'decode_attention_quant':
            'skypilot_tpu/ops/pallas/decode_attention.py:109 '
            '_decode_kernel_quant',
        'flash_fwd': f'{flash_src}:62 _fwd_kernel + :128 _fwd_kernel_seg',
        'flash_dq': f'{flash_src}:193 _bwd_dq_kernel + '
                    ':246 _bwd_dq_kernel_seg',
        'flash_dkv': f'{flash_src}:254 _bwd_dkv_kernel + '
                     ':325 _bwd_dkv_kernel_seg',
    }
    sources = {'paged_attention': 'paged_attention.cu',
               'paged_attention_quant': 'paged_attention.cu',
               'decode_attention': 'decode_attention.cu',
               'decode_attention_quant': 'decode_attention.cu',
               'flash_fwd': 'flash_attention.cu',
               'flash_dq': 'flash_attention.cu',
               'flash_dkv': 'flash_attention.cu'}
    # Counts come only from the main paths' own runs (the continuous
    # engine's plain, speculative and LoRA windows, the MoE engines, the
    # checkpoint-served engines of phases 26-27 and the decode-role
    # engines of phase 28 and the GRPO rollout engines of phases 29-30
    # for the paged kernels, the batch engines (phase 26's too) and the
    # bench twin's decode mode for the decode kernels, the trainer's
    # entry points for the flash kernels: phase 7, the bench twin's train
    # mode, the remat policies, the MoE train steps, the finetune of
    # phase 27, the GRPO learners of phases 29-30, and --packed for the
    # segment twins): null when they were skipped, never a number this
    # run did not measure.
    def total(parts):
        return sum(parts) if None not in parts else None

    tp_launches = tp.get('launches', {})

    trains = [train.get('launches'), bench_tr.get('launches'),
              packed.get('launches'), moe.get('train'),
              ckpt.get('finetune')] + [
        remat.get(p, {}).get('launches')
        for p in ('save_attn', 'save_dots', 'dots')] + rl.get(
            'flash', [None])
    launches = {
        'paged_attention': total([engine.get('launches'),
                                  spec.get('launches'),
                                  lora.get('launches'), moe.get('paged'),
                                  ckpt.get('paged'),
                                  ckpt.get('lora_paged'),
                                  disagg.get('launches'), rl.get('paged'),
                                  tp_launches.get('paged_attention')]),
        'paged_attention_quant': total([
            engine.get('launches_quant'), spec.get('launches_quant'),
            disagg.get('launches_quant'),
            tp_launches.get('paged_attention_quant')]),
        'decode_attention': total([batch.get('launches'),
                                   bench_dec.get('launches'),
                                   moe.get('decode'), ckpt.get('decode'),
                                   tp_launches.get('decode_attention')]),
        'decode_attention_quant': total([
            batch.get('launches_quant'),
            tp_launches.get('decode_attention_quant')])}
    for name in ('flash_fwd', 'flash_dq', 'flash_dkv'):
        launches[name] = total([
            None if t is None else t[name] + t[name + '_seg']
            for t in trains])
    if launches['flash_fwd'] is not None and tp_launches:
        launches['flash_fwd'] += tp_launches['flash_fwd']
    kernels = [dict(name=name, route='cuda',
                    source='skypilot_tpu_torch/csrc/' + sources[name],
                    replaces=replaces[name], launches=launches[name],
                    **rows[name]) for name in replaces]
    log(f'[smoke] {time.perf_counter() - started:.1f} s, build included')
    print(json.dumps({'kernels': kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
