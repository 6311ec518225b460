"""GPipe pipeline parallelism over the ``stage`` mesh axis: the port of
``skypilot_tpu/parallel/pipeline.py``.

The reference writes the pipeline as sharded array ops for GSPMD: the
layer leaves reshape to ``[S, L/S, ...]`` over ``stage`` (``stage_stack``),
every tick applies every stage's layers at once (a ``vmap``), the
handoff is a ``jnp.roll`` over ``stage`` (a CollectivePermute), and
autodiff of the whole schedule gives the backward pipeline. Plain GPipe:
``M + S - 1`` ticks for M microbatches on S stages.

Here each stage is its own process, so the schedule is explicit
(``pipeline_apply``):

* the layer leaves need no reshape: the rule ``layers -> stage`` already
  hands each stage rank its ``[L/S, ...]`` block (``check_layers`` keeps
  the reference's ``not divisible`` refusal);
* forward: stage s runs its layers on microbatch m as soon as stage s-1
  has sent it (a tagged point-to-point receive), then sends the output
  on. Stage s thus works on microbatch t - s at tick t and on nothing at
  the reference's bubble ticks, whose junk never reaches an output: the
  skipped ticks change no number;
* backward: microbatch M-1 down to 0, stage s receives the gradient of
  its output from stage s+1 (the last stage takes it from the loss), runs
  ``torch.autograd.grad`` of that microbatch's output into the given
  leaves and its input, and sends the input's gradient to stage s-1.
  Each exchange names its microbatch (the tag), and each rank issues its
  sends and receives in this one fixed order, so no two ranks can wait
  on each other;
* the leaves' gradients add up over the microbatches in fp32.

A handoff goes along ``stage`` alone: to the rank at the same ``data``,
``fsdp``, ``seq``, ``expert`` and ``tensor`` coordinates, with that
rank's block of a microbatch. Every rank of a stage runs the same
schedule, so the collectives inside ``body`` (the ring over ``seq``, a
MoE layer's sums over ``expert``) and inside its recompute line up.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch


def default_num_microbatches(batch: int, n_stages: int) -> int:
    """Largest M <= 2 * n_stages dividing ``batch`` (the reference's: 2x
    stages keeps the GPipe bubble <= 1/3)."""
    for m in range(min(2 * n_stages, batch), 0, -1):
        if batch % m == 0:
            return m
    return 1


def check_layers(n_layers: int, n_stages: int) -> int:
    """Layers a stage holds; the reference's ``stage_stack`` refusal for a
    layer count that the stages do not divide."""
    if n_layers % n_stages:
        raise ValueError(f'n_layers={n_layers} not divisible by pipeline '
                         f'stages={n_stages}')
    return n_layers // n_stages


def microbatch_rows(rows: int, num_microbatches: int) -> int:
    """Rows of one microbatch of a rank's ``rows``; the reference's
    ``pipeline_apply`` refusal for a batch the microbatches do not
    divide. Under data x fsdp the reference pads a rank's part of a
    microbatch where GSPMD must; here the rank's rows must divide."""
    if rows % num_microbatches:
        raise ValueError(f'batch={rows} not divisible by '
                         f'num_microbatches={num_microbatches}')
    return rows // num_microbatches


def pipeline_apply(par: Any, num_microbatches: int,
                   first: Callable[[int], torch.Tensor],
                   body: Callable[[torch.Tensor], torch.Tensor],
                   last: Callable[[torch.Tensor, int], Any],
                   act_shape: Sequence[int], act_dtype: torch.dtype,
                   device: torch.device,
                   wrt: Optional[Sequence[torch.Tensor]] = None
                   ) -> Tuple[List[Any], Optional[List[torch.Tensor]]]:
    """GPipe over the ``stage`` ranks of ``par`` (a ``TensorParallel``).

    ``first(m)``: microbatch m's input to the first stage (called there
    only). ``body(x)``: this rank's layers. ``last(y, m)``: on the last
    stage, what microbatch m's output ``y`` becomes (its loss when
    training). ``act_shape`` / ``act_dtype``: a microbatch's activations
    between stages.

    Returns (outs, grads): ``last``'s results in microbatch order on the
    last stage ([] elsewhere), and with ``wrt`` (leaves) the gradients
    of the sum of the last stage's scalar outs with respect to them, on
    every stage (zeros for a leaf the rank does not use), each in its
    leaf's dtype; None without ``wrt`` (a forward only)."""
    n_stages, index = par.stage, par.stage_rank
    is_first, is_last = index == 0, index == n_stages - 1
    train = wrt is not None
    waits: List[Callable[[], None]] = []
    saved: List[Tuple[Optional[torch.Tensor], Any]] = []
    outs: List[Any] = []
    for m in range(num_microbatches):
        if is_first:
            x = first(m)
        else:
            x = par.recv_from(act_shape, act_dtype, device, -1, m)
            x.requires_grad_(train)
        y = body(x)
        if is_last:
            y = last(y, m)
            outs.append(y)
        else:
            waits.append(par.send_to(y, +1, m))
        if train:
            saved.append((None if is_first else x, y))
    for wait in waits:
        wait()
    if not train:
        return outs, None
    leaves = list(wrt)
    sums: List[Optional[torch.Tensor]] = [None] * len(leaves)
    waits = []
    for m in reversed(range(num_microbatches)):
        x, y = saved.pop()
        dy = None
        if not is_last:
            dy = par.recv_from(act_shape, act_dtype, device, +1, m)
        inputs = leaves + ([] if x is None else [x])
        grads = torch.autograd.grad(y, inputs, grad_outputs=dy,
                                    allow_unused=True)
        del y, dy
        for i, g in enumerate(grads[:len(leaves)]):
            if g is not None:
                sums[i] = (g.float() if sums[i] is None
                           else sums[i].add_(g.float()))
        if x is not None:
            waits.append(par.send_to(grads[-1], -1, m))
        del grads, x
    for wait in waits:
        wait()
    return outs, [torch.zeros_like(p) if s is None else s.to(p.dtype)
                  for p, s in zip(leaves, sums)]
