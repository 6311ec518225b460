"""Pipeline stages combined with the sequence axis against the JAX
reference, on the CPU: ``stage=2,seq=2``.

The checks of ``tests/torch_stage_cases.py`` on four gloo ranks: TINY
with ring attention and with Ulysses attention (under full remat, so a
microbatch's backward re-runs its all-to-alls), TINY_MOE with dense
dispatch and with capacity 0.5 in the default group of 128 columns,
which crosses the seq ranks' boundary (full remat: the recompute
re-gathers the top-k choices over ``seq``). Three AdamW steps give the
reference's losses, grad norms and params, each rank's blocks are the
reference's shards at its coordinates, and each microbatch goes
forward and back once a step. In the same launch a planted fault, every
seq rank's RoPE positions from 0, must fail the comparison.
``tests/test_torch_train_mesh_stage_expert.py`` takes ``stage=2,expert=2``.
"""
import pytest

import torch_mesh_reference as ref_lib
import torch_stage_cases as cases
from torch_threads import few_torch_threads  # noqa: F401 (autouse)
from torch_tp_ranks import one_thread_ranks  # noqa: F401 (autouse)

SPEC = 'stage=2,seq=2'
LABELS = cases.labels_of({SPEC})


@pytest.fixture(scope='module')
def launches():
    """This module's mesh launch (``cases.mesh_run``)."""
    return {}


@pytest.mark.parametrize('label', LABELS)
def test_stage_train_steps_match_jax_on_mesh(launches, label):
    cases.check_train_steps(launches, label)


@pytest.mark.parametrize('label', LABELS)
def test_stage_forward_matches_jax(launches, label):
    cases.check_forward(launches, label)


@pytest.mark.parametrize('label', LABELS)
def test_stage_state_is_sharded(launches, label):
    cases.check_sharded(launches, label)


@pytest.mark.parametrize('label', LABELS)
def test_stage_step_handoffs(launches, label):
    cases.check_handoffs(launches, label)


@pytest.mark.parametrize('label', [x for x in LABELS if 'ulysses' not in x])
def test_stage_body_runs_the_ring(launches, label):
    """Each microbatch's layer runs the ring over its stage's seq group:
    one K/V hop in each forward (the recompute's too, under full remat)
    and a K/V and a dK/dV hop in the backward; a capacity group across
    the seq ranks gathers the top-k choices over ``seq`` once a forward.
    """
    out, _ = cases.mesh_run(launches, SPEC)
    overrides = cases.CASES[label][3]
    forwards = 2 if overrides.get('remat_policy') == 'full' else 1
    layers = 2 // ref_lib.mesh_axes(SPEC)['stage']
    m = cases.microbatches(label)
    want = {'ring_shift seq': (forwards + 2) * layers * m}
    if overrides.get('moe_dispatch') == 'capacity':
        want['all_gather seq'] = forwards * layers * m
    for r in out:
        for step in r['runs'][label]['collectives']:
            assert {k: v for k, v in step.items()
                    if k.endswith(' seq')} == want, (r['coords'], step)


def test_positions_from_zero_fail_the_comparison(launches):
    """The second seq rank's columns at the first rank's RoPE angles."""
    out, refs = cases.mesh_run(launches, SPEC)
    with pytest.raises(AssertionError):
        ref_lib.assert_matches(out[0]['runs']['positions from 0'],
                               refs['stage=2,seq=2 ring'])
