"""Pipeline stages combined with the expert axis against the JAX
reference, on the CPU: ``stage=2,expert=2``.

The checks of ``tests/torch_stage_cases.py`` on four gloo ranks:
TINY_MOE with dense dispatch and with capacity dispatch at the default
factor (under full remat, so a microbatch's backward re-runs each MoE
block's sum over ``expert``). Each stage rank holds its layer's half of
the experts; three AdamW steps give the reference's losses (the plain
cross entropy: ``router_aux`` 0 under stages), grad norms and params,
each rank's blocks are the reference's shards at its coordinates, and
each microbatch goes forward and back once a step. In the same launch a
planted fault, each MoE block's output left unsummed over ``expert``,
must fail the comparison. ``tests/test_torch_train_mesh_stage_seq.py``
takes ``stage=2,seq=2``.
"""
import pytest

import torch_mesh_reference as ref_lib
import torch_stage_cases as cases
from torch_threads import few_torch_threads  # noqa: F401 (autouse)
from torch_tp_ranks import one_thread_ranks  # noqa: F401 (autouse)

SPEC = 'stage=2,expert=2'
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


@pytest.mark.parametrize('label', LABELS)
def test_stage_body_sums_over_experts(launches, label):
    """Each microbatch's MoE layer sums its output over ``experts``
    once in the forward (a full remat's recompute stops before the sum)
    and its input's and routing weights' gradients once each in the
    backward."""
    out, _ = cases.mesh_run(launches, SPEC)
    layers = 2 // ref_lib.mesh_axes(SPEC)['stage']
    want = 3 * layers * cases.microbatches(label)
    for r in out:
        for step in r['runs'][label]['collectives']:
            assert step.get('all_reduce experts') == want, (r['coords'],
                                                            step)


def test_expert_sum_skipped_fails_the_comparison(launches):
    """Each expert rank's MoE output holds only its own experts' part."""
    out, refs = cases.mesh_run(launches, SPEC)
    with pytest.raises(AssertionError):
        ref_lib.assert_matches(out[0]['runs']['expert sum skipped'],
                               refs['stage=2,expert=2 tiny-moe'])
