"""Pipeline-parallel training over the stage axis with the other axes
against the JAX reference, on the CPU.

The checks of ``tests/torch_stage_cases.py`` at ``stage=4`` on 4 layers
(the middle stages both receive and send), ``stage=2,fsdp=2`` with
Adafactor (a layer leaf's statistics summed over its stage and fsdp
blocks) and ``stage=2,tensor=2`` under full remat (the recompute
re-issues each layer's collectives inside a microbatch's backward);
``tests/test_torch_train_mesh_stage.py`` takes ``stage=2`` alone.
"""
import pytest

import torch_stage_cases as cases
from torch_threads import few_torch_threads  # noqa: F401 (autouse)
from torch_tp_ranks import one_thread_ranks  # noqa: F401 (autouse)

LABELS = cases.labels_of({'stage=4', 'stage=2,fsdp=2', 'stage=2,tensor=2'})


@pytest.fixture(scope='module')
def launches():
    """This module's mesh launches (``cases.mesh_run``)."""
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
