"""Batched KV-cache inference engine: the port of
``skypilot_tpu/inference/engine.py``.

Requests are batched, prompts right-padded into shape buckets (powers
of two, at least 16), the batch padded to a power of two, and
``max_new_tokens`` rounded up to a bucket of at least 8; the whole
batch then runs ``models/decode.py:generate``: one ``prefill`` (flash
attention at prompt buckets that are multiples of 128) and exactly that
many ``decode_step``s, each layer of which is the Hopper
decode-attention kernel on the card. ``embed_text`` mean-pools the
final hidden states of ``llama.forward``.

``device``: default ``cuda`` (raises without a GPU); pass ``'cpu'`` to
run on the CPU. The weights, in order: ``params`` (a port params dict;
``models/convert.py`` carries JAX params over), ``hf_checkpoint`` (an
HF directory, loaded in bf16 by ``models/hf_interop.py``, whose
tokenizer then serves), ``checkpoint_dir`` (the newest step of a
training checkpoint, ``train/checkpoint.py``), else
``llama.init_params`` from ``seed`` on the device, in the compute
dtype.

``mesh='tensor=N'`` (tensor-parallel serving, ``inference/sharding.py``):
build the engine on each of N ranks (``parallel/launch.py``). Each keeps
its shard of the weights; the driver (tensor index 0) serves the calls
and announces each ``generate`` to the followers, which run it on their
shards in ``follow()`` until the driver's ``shutdown()``. Prefill runs
the flash kernel and decode the decode kernel on each rank's heads; the
driver samples and broadcasts each step's tokens. ``embed_text`` raises
under a mesh (ROADMAP.md, queue A item 15).
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from skypilot_tpu_torch.inference import sharding
from skypilot_tpu_torch.inference.tokenizer import get_tokenizer
from skypilot_tpu_torch.models import decode as decode_lib
from skypilot_tpu_torch.models import hf_interop, llama
from skypilot_tpu_torch.models.config import (ModelConfig, get_model_config,
                                              with_int8_kv_cache)
from skypilot_tpu_torch.parallel.sharding import mesh_context
from skypilot_tpu_torch.train.checkpoint import restore_latest
from skypilot_tpu_torch.utils.device import resolve_device, to_device


# The batch engine's one plan: a padded batch to generate.
_PLAN_GENERATE = 2


def restore_params(checkpoint_dir: str, cfg: ModelConfig, seed: int,
                   device: torch.device):
    """The params of the newest committed step of a training checkpoint
    directory (``train/checkpoint.py``: ``pretrain``'s or
    ``finetune``'s full-mode output) in ``cfg.param_dtype`` on
    ``device``; ``init_params`` from ``seed`` when it holds none."""
    return restore_latest(
        checkpoint_dir,
        lambda: llama.init_params(seed, cfg, device=device),
        subtree='params')


def _bucket(n: int, minimum: int = 16) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def _embed_pooled(params, tokens: torch.Tensor, lengths: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """Masked mean-pool of final hidden states, L2-normalized (fp32)."""
    hidden = llama.forward(params, tokens, cfg, return_hidden=True)
    s = tokens.shape[1]
    mask = (torch.arange(s, device=tokens.device)[None, :] <
            lengths[:, None])
    # bf16 products with a 0/1 mask are exact in fp32: the reference's
    # einsum with an fp32 result.
    summed = (hidden.float() * mask[..., None].float()).sum(dim=1)
    pooled = summed / torch.clamp(lengths[:, None].float(), min=1.0)
    norm = torch.linalg.norm(pooled, dim=-1, keepdim=True)
    return pooled / torch.clamp(norm, min=1e-6)


class InferenceEngine:
    """Thread-safe generate() over a fixed model."""

    def __init__(self,
                 model: str = 'tiny',
                 *,
                 cfg: Optional[ModelConfig] = None,
                 params: Optional[Any] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 checkpoint_dir: Optional[str] = None,
                 hf_checkpoint: Optional[str] = None,
                 seed: int = 0,
                 max_batch: int = 8,
                 quantize: bool = False,
                 quantize_kv: bool = False,
                 mesh: Optional[Any] = None) -> None:
        self.device = resolve_device(device)
        # hf_checkpoint: an HF-layout dir (config.json + safetensors +
        # tokenizer.json): published weights and their own tokenizer
        # (models/hf_interop.py). The cfg/params args then come from it.
        if hf_checkpoint:
            params, cfg = hf_interop.resolve_engine_inputs(
                hf_checkpoint, params, cfg, device=self.device)
        self.cfg = cfg or get_model_config(model)
        if quantize_kv:
            # int8 KV cache, dequantized inside the decode kernel.
            self.cfg = with_int8_kv_cache(self.cfg)
        sharding.check_unported(mesh, self.cfg)
        self._mesh = sharding.mesh_serving(mesh, self.device, self.cfg)
        self._tp = None
        if self._mesh is not None:
            self.device, self._tp = self._mesh.device, self._mesh.tp
        self.tokenizer = get_tokenizer(hf_checkpoint,
                                       require=bool(hf_checkpoint))
        if self.tokenizer.vocab_size > self.cfg.vocab_size:
            raise ValueError(
                f'Model vocab {self.cfg.vocab_size} < tokenizer '
                f'vocab {self.tokenizer.vocab_size}')
        self.max_batch = max_batch
        self._lock = threading.Lock()
        if params is None and checkpoint_dir:
            params = restore_params(checkpoint_dir, self.cfg, seed,
                                    self.device)
        if params is None:
            params = llama.init_params(seed, self.cfg, device=self.device,
                                       weight_dtype=self.cfg.compute_dtype)
        params, self.cfg, _ = sharding.prepare_engine(
            to_device(params, self.device), self.cfg,
            self._mesh and self._mesh.mesh, quantize=quantize,
            device_type=self.device.type)
        self.params = decode_lib.serving_params(params, self.cfg)
        del params
        sharding.release_unsharded(self._mesh, self.device)
        self.stats: Dict[str, Any] = {
            'requests': 0, 'tokens_generated': 0, 'decode_seconds': 0.0}
        if self._mesh is not None:
            self.stats.update(self._mesh.info)

    def _batch(self, ids: List[List[int]], lengths: np.ndarray):
        """Right-padded [batch bucket, prompt bucket] tokens and lengths
        (padding rows have length 1) on the device."""
        b = len(ids)
        s = _bucket(int(lengths.max()))
        batch_b = _bucket(b, minimum=1)
        tokens = np.full((batch_b, s), self.tokenizer.pad_id, np.int32)
        for i, p in enumerate(ids):
            tokens[i, :len(p)] = p
        pad_lengths = np.concatenate(
            [lengths, np.ones(batch_b - b, np.int32)])
        return (torch.as_tensor(tokens, device=self.device),
                torch.as_tensor(pad_lengths, device=self.device))

    # ------------------------------------------------------------------

    def generate_ids(self, prompts: List[List[int]],
                     max_new_tokens: int = 32,
                     temperature: float = 0.0,
                     seed: int = 0) -> List[List[int]]:
        if not prompts:
            return []
        if len(prompts) > self.max_batch:
            out: List[List[int]] = []
            for i in range(0, len(prompts), self.max_batch):
                out.extend(self.generate_ids(
                    prompts[i:i + self.max_batch], max_new_tokens,
                    temperature, seed))
            return out
        if self._mesh is not None:
            self._mesh.require_driver('generate_ids')
        b = len(prompts)
        lengths = np.array([len(p) for p in prompts], np.int32)
        n_new = _bucket(max_new_tokens, minimum=8)
        tokens, pad_lengths = self._batch(prompts, lengths)
        with self._lock, torch.no_grad():
            t0 = time.perf_counter()
            generated, gen_lengths = self._generate(
                tokens, pad_lengths, n_new, temperature, seed)
            generated = generated.cpu().numpy()
            gen_lengths = gen_lengths.cpu().numpy()
            elapsed = time.perf_counter() - t0
            self.stats['requests'] += b
            self.stats['tokens_generated'] += int(gen_lengths[:b].sum())
            self.stats['decode_seconds'] += elapsed
        return [
            generated[i, :min(int(gen_lengths[i]), max_new_tokens)].tolist()
            for i in range(b)
        ]

    def _generate(self, tokens: torch.Tensor, lengths: torch.Tensor,
                  n_new: int, temperature: float, seed: int):
        """``decode_lib.generate`` of one padded batch; under a mesh the
        driver first announces it (its shapes, sampling arguments,
        tokens and lengths) and every rank runs it in the mesh
        context."""
        eos = self.tokenizer.eos_id
        if self._mesh is None:
            return decode_lib.generate(
                self.params, tokens, lengths, self.cfg,
                max_new_tokens=n_new, temperature=temperature, eos_id=eos,
                seed=seed)
        with self._mesh.channel.lock, mesh_context(self._tp):
            self._mesh.channel.publish(
                _PLAN_GENERATE,
                [tokens.shape[0], tokens.shape[1], n_new,
                 sharding.float_bits(temperature), seed,
                 -1 if eos is None else eos], tokens, lengths)
            return decode_lib.generate(
                self.params, tokens, lengths, self.cfg,
                max_new_tokens=n_new, temperature=temperature, eos_id=eos,
                seed=seed)

    @property
    def is_driver(self) -> bool:
        """True unless this engine is a follower rank of a mesh."""
        return self._mesh is None or self._mesh.driver

    def follow(self) -> None:
        """A follower rank's loop: run each ``generate`` the driver
        announces on this rank's shards; returns when the driver shuts
        down."""
        if self._mesh is None or self._mesh.driver:
            raise RuntimeError('follow() runs on the follower ranks of a '
                               'tensor-parallel mesh')
        channel = self._mesh.channel
        with torch.no_grad(), mesh_context(self._tp):
            while True:
                op, payload = channel.receive()
                if op == sharding.PLAN_STOP:
                    return
                if op != _PLAN_GENERATE:
                    continue
                plan = sharding.PlanReader(payload)
                b, s, n_new, temp_bits, seed, eos = plan.ints(6)
                tokens = plan.take(b * s, (b, s), torch.int32)
                lengths = plan.take(b, None, torch.int32)
                decode_lib.generate(
                    self.params, tokens, lengths, self.cfg,
                    max_new_tokens=n_new,
                    temperature=sharding.bits_float(temp_bits),
                    eos_id=None if eos < 0 else eos, seed=seed)

    def shutdown(self) -> None:
        """Under a mesh, the driver releases the followers' ``follow``
        loops; a no-op otherwise."""
        if self._mesh is not None and self._mesh.driver:
            self._mesh.channel.close()

    def generate_text(self, prompts: List[str],
                      max_new_tokens: int = 32,
                      temperature: float = 0.0,
                      seed: int = 0) -> List[str]:
        ids = [self.tokenizer.encode(p) for p in prompts]
        outs = self.generate_ids(ids, max_new_tokens, temperature, seed)
        return [self.tokenizer.decode(o) for o in outs]

    # -- text embeddings ------------------------------------------------

    def embed_text(self, texts: List[str]) -> np.ndarray:
        """[len(texts), d_model] L2-normalized fp32 embeddings: final
        hidden states (``llama.forward(return_hidden=True)``, no LM head)
        mean-pooled over the real tokens of each right-padded prompt."""
        if self._mesh is not None:
            raise NotImplementedError(
                'embed_text under a tensor-parallel mesh is not ported yet '
                '(ROADMAP.md, queue A item 15)')
        if not texts:
            return np.zeros((0, self.cfg.d_model), np.float32)
        if len(texts) > self.max_batch:
            parts = [self.embed_text(texts[i:i + self.max_batch])
                     for i in range(0, len(texts), self.max_batch)]
            return np.concatenate(parts, axis=0)
        ids = [self.tokenizer.encode(t)[:self.cfg.max_seq_len]
               for t in texts]
        b = len(ids)
        lengths = np.array([max(len(p), 1) for p in ids], np.int32)
        tokens, pad_lengths = self._batch(ids, lengths)
        with self._lock, torch.no_grad():
            pooled = _embed_pooled(self.params, tokens, pad_lengths,
                                   self.cfg)
            self.stats['requests'] += b
            return pooled.cpu().numpy()[:b]
