"""GRPO post-training on one card: the port of
``skypilot_tpu/train/grpo.py``, with its CLI flags and JSON lines::

    python -m skypilot_tpu_torch.train.grpo --model tiny --steps 30 \\
        [--checkpoint-dir DIR] [--rollout-backend engine|loop] \\
        [--device cpu]

The algorithm (DeepSeekMath-style GRPO, no value network):

  1. sample G rollouts per prompt from the current policy;
  2. score each with a verifiable reward: the fraction of generated
     tokens equal to the prompt's last token (the cue);
  3. advantage = (reward - group mean) / (group std + 1e-6), the
     population std (ddof 0), so a group of equal rewards gives 0;
  4. one policy-gradient step on ``-mean(adv * sum(logprob of the
     generated tokens))`` under ``optax.adamw(lr)`` at its defaults
     (``AdamW`` with a constant rate and no clipping).

Rollouts come from the port's continuous engine (``--rollout-backend
engine``, the default: the paged-attention kernel on the card), which is
refreshed in place with the learner's weights after every step
(``refresh_weights(params=...)``: fully on-policy), or from
``models/decode.generate`` (``loop``). The learner is fp32; the engine
serves ``cfg.compute_dtype``.

Differences by design from the reference: prompts are drawn by a seeded
``torch.Generator`` and sampling by the engine's (seed, position)
generators, not by ``jax.random``'s threefry, so the port's prompts and
sampled tokens are not the reference's (greedy rollouts on the same
prompts and params are). Each rollout keeps the reference's request seed
``(step << 20) | i``, so a wave replays within the port. The step lines
carry, beside the reference's ``step``, ``mean_reward`` and ``loss``,
the seconds of the step's rollouts (``rollout_s``), learner step
(``learn_s``) and engine refresh (``refresh_s``, from the engine's
stats). The learner's checkpoints go through ``train/checkpoint.py``
(step, params and AdamW state); a resumed run prints
``{"resumed_from_step": n}``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.models.config import ModelConfig
from skypilot_tpu_torch.train.step import (AdamW, TrainState, _leaves,
                                           _trainable, plain_adamw)
from skypilot_tpu_torch.utils.device import resolve_device

Params = Dict[str, Any]


def make_prompts(seed: int, n: int, prompt_len: int, vocab_size: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prompts [n, prompt_len] int32 (CPU) whose last token is the
    repeat-me cue, drawn from [3, vocab_size) by a ``torch.Generator``
    seeded with ``seed``; returns (prompts, cues)."""
    gen = torch.Generator().manual_seed(int(seed))
    body = torch.randint(3, vocab_size, (n, prompt_len), generator=gen,
                         dtype=torch.int32)
    return body, body[:, -1].clone()


def reward_fn(generated: torch.Tensor, targets: torch.Tensor
              ) -> torch.Tensor:
    """Fraction of generated tokens equal to the cue: [P*G, N] -> [P*G]
    fp32."""
    return (generated == targets[:, None]).float().mean(dim=1)


def grpo_advantages(rewards: torch.Tensor, group_size: int
                    ) -> torch.Tensor:
    """[P*G] rewards -> group-normalized advantages, with the population
    std (``jnp.std``'s ddof 0; torch's default is the unbiased one)."""
    grouped = rewards.float().reshape(-1, group_size)
    mean = grouped.mean(dim=1, keepdim=True)
    std = grouped.std(dim=1, keepdim=True, correction=0)
    return ((grouped - mean) / (std + 1e-6)).reshape(-1)


def grpo_loss(params: Params, tokens: torch.Tensor, gen_mask: torch.Tensor,
              advantages: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, T]: prompt + generated; ``gen_mask`` marks the
    generated positions. Returns (loss, mean sequence logprob):
    ``loss = -mean(adv * sum(logprob(token) over generated))``."""
    logits = llama.forward(params, tokens[:, :-1], cfg)
    logprobs = torch.log_softmax(logits.float(), dim=-1)
    del logits
    chosen = torch.gather(logprobs, -1,
                          tokens[:, 1:, None].long())[..., 0]   # [B, T-1]
    mask = gen_mask[:, 1:].float()
    seq_logprob = (chosen * mask).sum(dim=1)
    loss = -(advantages * seq_logprob).mean()
    return loss, seq_logprob.mean()


def make_grpo_step(cfg: ModelConfig, optimizer: AdamW):
    """(state, tokens, gen_mask, advantages) -> (state, metrics): the
    gradient by ``torch.autograd.grad``, the update in place."""

    def step(state: TrainState, tokens, gen_mask, advantages):
        loss, mean_lp = grpo_loss(state.params, tokens, gen_mask,
                                  advantages, cfg)
        grads = torch.autograd.grad(loss, _leaves(state.params))
        opt_state, _ = optimizer.update_(state.params, list(grads),
                                         state.opt_state)
        del grads
        return TrainState(step=state.step + 1, params=state.params,
                          opt_state=opt_state), {
                              'loss': loss.detach(),
                              'mean_logprob': mean_lp.detach()}

    return step


class GrpoLearner:
    """The policy state (fp32 params in ``cfg.param_dtype`` and AdamW
    state on ``device``), one ``learn()`` per rollout batch, checkpoint
    save and restore. ``version`` (the step count) is the policy version
    the RL pipeline publishes and measures staleness in."""

    def __init__(self, cfg: ModelConfig, *, learning_rate: float = 1e-4,
                 checkpoint_dir: Optional[str] = None, seed: int = 0,
                 device: Optional[Union[str, torch.device]] = None
                 ) -> None:
        self.cfg = cfg
        self.device = resolve_device(device)
        self.checkpoint_dir = checkpoint_dir
        self.optimizer = plain_adamw(learning_rate)
        params = _trainable(llama.init_params(seed, cfg,
                                              device=self.device))
        self.state = TrainState(step=0, params=params,
                                opt_state=self.optimizer.init(params))
        self.resumed_from: Optional[int] = None
        if checkpoint_dir:
            from skypilot_tpu_torch.train import checkpoint as ckpt_lib
            latest = ckpt_lib.latest_step(checkpoint_dir)
            if latest is not None:
                self.state = ckpt_lib.restore(checkpoint_dir, latest,
                                              self.state)
                self.resumed_from = self.state.step
        self._step_fn = make_grpo_step(cfg, self.optimizer)

    @property
    def params(self) -> Params:
        return self.state.params

    @property
    def version(self) -> int:
        return int(self.state.step)

    def learn(self, tokens, gen_mask, advantages) -> Dict[str, float]:
        self.state, metrics = self._step_fn(self.state, tokens, gen_mask,
                                            advantages)
        return {k: float(v) for k, v in metrics.items()}

    def learn_rollouts(self, prompts, generated, rewards,
                       group_size: int) -> Dict[str, float]:
        """One step straight from rollout arrays (tensors or numpy):
        ``prompts`` [P*G, L] (already tiled), ``generated`` [P*G, N],
        ``rewards`` [P*G]."""
        dev = self.device
        prompts = torch.as_tensor(prompts).to(dev, torch.int32)
        generated = torch.as_tensor(generated).to(dev, torch.int32)
        rewards = torch.as_tensor(rewards).to(dev, torch.float32)
        advantages = grpo_advantages(rewards, group_size)
        tokens = torch.cat([prompts, generated], dim=1)
        gen_mask = torch.cat([torch.zeros_like(prompts),
                              torch.ones_like(generated)], dim=1)
        out = self.learn(tokens, gen_mask, advantages)
        out['mean_reward'] = float(rewards.mean())
        return out

    def save(self) -> None:
        if self.checkpoint_dir:
            from skypilot_tpu_torch.train import checkpoint as ckpt_lib
            ckpt_lib.save(self.checkpoint_dir, self.version, self.state)


def engine_rollouts(engine, tiled, *, max_new_tokens: int,
                    temperature: float, step: int,
                    timeout: float = 300.0) -> Tuple[torch.Tensor, int]:
    """One rollout wave through the continuous engine: every row of
    ``tiled`` [B, L] is its own request (the G copies of a prompt share
    their prefill through the prefix cache), harvested in order. Row i
    of step s samples with seed ``(s << 20) | i``: a wave replays, and G
    siblings still draw G streams. Returns ([B, N] int32 on the CPU,
    the oldest policy version that admitted a row of the wave)."""
    handles = [
        engine.submit_ids([int(t) for t in row],
                          max_new_tokens=max_new_tokens,
                          temperature=temperature, seed=(step << 20) | i)
        for i, row in enumerate(tiled)]
    outs: List[List[int]] = []
    version = None
    for handle in handles:
        if not handle.done.wait(timeout):
            raise TimeoutError('rollout generation timed out')
        if handle.error is not None:
            raise handle.error
        outs.append(handle.generated)
        version = (handle.policy_version if version is None
                   else min(version, handle.policy_version))
    return torch.tensor(outs, dtype=torch.int32), (version or 0)


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument('--model', default='tiny')
    parser.add_argument('--steps', type=int, default=30)
    parser.add_argument('--prompts-per-step', type=int, default=4)
    parser.add_argument('--group-size', type=int, default=4)
    parser.add_argument('--prompt-len', type=int, default=8)
    parser.add_argument('--max-new-tokens', type=int, default=8)
    parser.add_argument('--temperature', type=float, default=1.0)
    parser.add_argument('--learning-rate', type=float, default=1e-4)
    parser.add_argument('--checkpoint-dir', default=None)
    parser.add_argument('--checkpoint-every', type=int, default=10)
    parser.add_argument('--log-every', type=int, default=5)
    parser.add_argument('--vocab-size', type=int, default=None,
                        help='override the model vocab (a small vocab '
                             'makes the repeat reward dense enough to '
                             'learn in a few steps).')
    parser.add_argument('--num-prompts', type=int, default=256,
                        help='size of the synthetic prompt pool; steps '
                             'cycle through it.')
    parser.add_argument('--attention-impl', default=None,
                        help="override the model's attention impl for "
                             'the policy-gradient step (default: the '
                             "config's, the flash kernels on the card; "
                             'shapes off their grid run plain '
                             'attention inside the dispatch).')
    parser.add_argument('--rollout-backend', default='engine',
                        choices=('engine', 'loop'),
                        help='"engine" (default): the continuous '
                             'engine, refreshed in place after every '
                             'learner step; "loop": '
                             'models/decode.generate.')
    parser.add_argument('--device', default=None,
                        help="torch device (default cuda; 'cpu' runs on "
                             'the CPU).')
    return parser.parse_args(argv)


def _emit(obj: Dict[str, Any]) -> None:
    print(json.dumps(obj), flush=True)


def run(args: argparse.Namespace) -> Dict[str, Any]:
    """The training loop of ``main``. Returns ``{'learner', 'engine',
    'cfg'}``; the engine (None with ``--rollout-backend loop`` or when
    no step was left) is still serving, and the caller shuts it down
    (``main`` does). On an error the engine is shut down here."""
    from skypilot_tpu_torch.models import decode
    from skypilot_tpu_torch.models.config import get_model_config
    overrides: Dict[str, Any] = {}
    if args.attention_impl:
        overrides['attention_impl'] = args.attention_impl
    if args.vocab_size:
        overrides['vocab_size'] = args.vocab_size
    cfg = get_model_config(args.model, **overrides)
    learner = GrpoLearner(cfg, learning_rate=args.learning_rate,
                          checkpoint_dir=args.checkpoint_dir,
                          device=args.device)
    dev = learner.device
    start_step = learner.version
    if learner.resumed_from is not None:
        _emit({'resumed_from_step': learner.resumed_from})
    p, g = args.prompts_per_step, args.group_size
    # The prompt "dataset": a fixed pool, cycled per step.
    pool, pool_targets = make_prompts(42, args.num_prompts,
                                      args.prompt_len, cfg.vocab_size)
    engine = None
    if args.rollout_backend == 'engine' and start_step < args.steps:
        from skypilot_tpu_torch.inference.continuous import (
            ContinuousBatchingEngine)
        engine = ContinuousBatchingEngine(
            cfg=cfg, params=learner.params, device=dev,
            max_slots=min(p * g, 8),
            max_len=min(cfg.max_seq_len,
                        args.prompt_len + args.max_new_tokens + 1))
    try:
        for step in range(start_step, args.steps):
            idx = (step * p + torch.arange(p)) % args.num_prompts
            tiled = torch.repeat_interleave(pool[idx], g, dim=0)
            tiled_targets = torch.repeat_interleave(pool_targets[idx], g)
            t0 = time.perf_counter()
            if engine is not None:
                generated, _ = engine_rollouts(
                    engine, tiled.tolist(),
                    max_new_tokens=args.max_new_tokens,
                    temperature=args.temperature, step=step)
            else:
                with torch.no_grad():
                    lengths = torch.full((p * g,), args.prompt_len,
                                         dtype=torch.int32, device=dev)
                    generated, _ = decode.generate(
                        learner.params, tiled.to(dev), lengths, cfg,
                        max_new_tokens=args.max_new_tokens,
                        temperature=args.temperature, seed=1000 + step)
                generated = generated.cpu()
            t1 = time.perf_counter()
            rewards = reward_fn(generated, tiled_targets)
            metrics = learner.learn_rollouts(tiled, generated, rewards, g)
            t2 = time.perf_counter()
            refresh_s = 0.0
            if engine is not None:
                # Live in-place refresh: the next wave runs on the
                # post-step policy (standalone mode is fully on-policy).
                before = engine.stats()['refresh_seconds']
                engine.refresh_weights(params=learner.params,
                                       version=learner.version)
                refresh_s = engine.stats()['refresh_seconds'] - before
            if (step + 1) % args.log_every == 0 or step + 1 == args.steps:
                _emit({'step': step + 1,
                       'mean_reward': round(metrics['mean_reward'], 4),
                       'loss': round(metrics['loss'], 4),
                       'rollout_s': round(t1 - t0, 4),
                       'learn_s': round(t2 - t1, 4),
                       'refresh_s': round(refresh_s, 4)})
            if args.checkpoint_dir and (
                    (step + 1) % args.checkpoint_every == 0 or
                    step + 1 == args.steps):
                learner.save()
    except BaseException:
        if engine is not None:
            engine.shutdown()
        raise
    _emit({'done': True, 'final_step': args.steps})
    return {'learner': learner, 'engine': engine, 'cfg': cfg}


def main(argv=None) -> int:
    out = run(parse_args(argv))
    if out['engine'] is not None:
        out['engine'].shutdown()
    return 0


if __name__ == '__main__':
    sys.exit(main())
