"""MoE training over the expert axis against the JAX reference, on the CPU.

The port's train step on TINY_MOE (4 query and 2 kv heads of dim 128,
fp32, the XLA attention) at ``expert=2``, ``expert=2,fsdp=2``,
``fsdp=2`` and ``tensor=2`` (gloo ranks) against the JAX package's
train step on the same mesh of virtual CPU devices, as
``tests/test_torch_train_mesh.py`` does for dense models: three steps
give the reference's loss, total loss, router aux loss, grad norm and
params (the router's included), each rank's blocks are the reference's
shards at its coordinates, and each step issues the collectives counted
below. Each mesh launches once, its planted faults in the same ranks:
the aux as the mean of the ranks' products, and the routing weights' or
the expert branch's gradient left unreduced, must each fail the
comparison.
"""
import json

import numpy as np
import pytest

import torch_mesh_reference as ref_lib
from skypilot_tpu_torch.parallel.launch import launch
from skypilot_tpu_torch.train import pretrain as tpretrain
from torch_threads import few_torch_threads  # noqa: F401 (autouse)
from torch_tp_ranks import one_thread_ranks  # noqa: F401 (autouse)
import torch_train_ranks as ranks

MODEL = 'tiny-moe'
N_LAYERS = 2
# Mesh -> (optimizer, model overrides, planted faults). expert=2,fsdp=2
# drops tokens (capacity 0.5), keeps the default aux coefficient and
# rematerializes every layer, so its recompute re-issues the layer's
# collectives; the others weigh the aux at 1.0, so that its gradient
# shows in every leaf.
CASES = {
    'expert=2': ('adamw', {'router_aux_loss_coeff': 1.0},
                 ('routing weights unreduced', 'expert input unreduced')),
    'expert=2,fsdp=2': ('adafactor', {'moe_dispatch': 'capacity',
                                      'capacity_factor': 0.5,
                                      'remat_policy': 'full'}, ()),
    'fsdp=2': ('adamw', {'router_aux_loss_coeff': 1.0},
               ('aux of rank products',)),
    'tensor=2': ('adamw', {'moe_dispatch': 'capacity',
                           'capacity_factor': 1.25,
                           'router_aux_loss_coeff': 1.0}, ()),
}


def step_collectives(spec, optimizer, remat):
    """The collectives of one train step, by kind and group.

    What this slice adds, per MoE layer: one sum of the block's output
    over ``experts`` (expert x tensor) in the forward (a full remat's
    recompute stops before it: ``torch.utils.checkpoint`` stops once the
    tensors the backward needs are rebuilt, and the sum's is not one),
    and in the backward one sum of the expert branch's input gradient
    and one of the routing weights' [B, S, k]; then one sum of the
    layers' router statistics [L, 2E] over ``tokens`` a step. The rest
    is what a dense mesh step takes: the embedding and Megatron's pairs
    over ``tensor`` with the vocab-parallel loss, the fsdp gathers of
    every layer's weights (again in a recompute) and their
    reduce-scatters, the loss's sums, the gradient sums, the global
    norm over each splitting axis, and Adafactor's RMSes (two a leaf
    and axis that splits it; no TINY_MOE leaf factors)."""
    axes = ref_lib.mesh_axes(spec)
    expert, fsdp, tensor = (axes.get(a, 1) for a in ('expert', 'fsdp',
                                                     'tensor'))
    n, forwards = N_LAYERS, 2 if remat else 1
    rms = 2 if optimizer == 'adafactor' else 0
    counts = {}
    if expert * tensor > 1:
        counts['all_reduce experts'] = 3 * n
    if fsdp > 1:
        # The aux statistics, the loss's weight sum and the loss; the
        # three norm scales' gradients (fsdp splits no other leaf).
        counts['all_reduce tokens'] = 3 + 3
        # Per layer: wq, wk, wv, wo, the router and the three expert
        # leaves; the embedding and the head once.
        counts['all_gather fsdp'] = 8 * n * forwards + 2
        counts['reduce_scatter fsdp'] = 8 * n + 2
        counts['all_reduce fsdp'] = 1 + rms * (8 + 2)
    if tensor > 1:
        assert not remat
        # The embedding's sum; attention's g forward and f backward a
        # layer; the loss's max, partition sums and target logits; the
        # head's f backward; the norm.
        counts['all_reduce tensor'] = 1 + 2 * n + 3 + 1 + 1
    if expert > 1:
        counts['all_reduce expert'] = 1 + rms * 3
    return counts


@pytest.fixture(scope='module')
def launches():
    """Each mesh's one launch, made at its first use."""
    return {}


def _mesh_run(launches, spec):
    if spec in launches:
        return launches[spec]
    optimizer, overrides, faults = CASES[spec]
    batches = [ref_lib.batch(30), ref_lib.batch(31), ref_lib.batch(32)]
    run, ref = ref_lib.run(spec, 'moe', optimizer, batches, model=MODEL,
                           **overrides)
    runs = [run] + [dict(run, name=fault, fault=fault) for fault in faults]
    world = int(np.prod(list(ref_lib.mesh_axes(spec).values())))
    out = launch(ranks.mesh_checks, world, spec, runs, device='cpu')
    launches[spec] = (out, ref)
    return launches[spec]


@pytest.mark.parametrize('spec', list(CASES))
def test_moe_train_steps_match_jax_on_mesh(launches, spec):
    out, ref = _mesh_run(launches, spec)
    got = out[0]['runs']['moe']
    ref_lib.assert_matches(got, ref)
    auxes = [m['router_aux'] for m in got['metrics']]
    assert all(0.9 < a < 2.0 for a in auxes), auxes
    # Every rank reports the same metrics.
    for r in out[1:]:
        assert r['runs']['moe']['metrics'] == got['metrics']
    assert all(r['runs']['moe']['flash_fallbacks'] == 0 for r in out)


@pytest.mark.parametrize('spec', list(CASES))
def test_moe_state_is_sharded(launches, spec):
    """Each rank's blocks are the reference's shards: the expert leaves
    split over expert (and fsdp along embed, tensor along the FFN
    columns), the router whole over expert and tensor."""
    out, ref = _mesh_run(launches, spec)
    ref_lib.assert_state_sharded(out, 'moe', ref)


@pytest.mark.parametrize('spec', list(CASES))
def test_moe_step_collectives(launches, spec):
    out, _ = _mesh_run(launches, spec)
    optimizer, overrides, _ = CASES[spec]
    want = step_collectives(spec, optimizer,
                            overrides.get('remat_policy') == 'full')
    for step in out[0]['runs']['moe']['collectives']:
        assert step == want


@pytest.mark.parametrize('spec,fault', [
    (spec, fault) for spec, (_, _, faults) in CASES.items()
    for fault in faults])
def test_planted_faults_fail_the_comparison(launches, spec, fault):
    out, ref = _mesh_run(launches, spec)
    with pytest.raises(AssertionError):
        ref_lib.assert_matches(out[0]['runs'][fault], ref)


@pytest.mark.parametrize('model,spec', [
    ('tiny-moe', 'expert=2'), ('tiny-moe', 'expert=2,fsdp=2'),
    ('tiny', 'expert=2')])
def test_pretrain_trains_on_expert_mesh(model, spec, capfd):
    """``pretrain --mesh`` with an expert axis starts its ranks and
    trains (rank 0 prints); its losses are the one-process run's within
    the printed rounding and bf16's (a dense model trains on the expert
    ranks as replicas: the same losses)."""
    argv = ['--model', model, '--steps', '3', '--batch', '4', '--seq',
            '64', '--log-every', '1', '--device', 'cpu']
    assert tpretrain.main(argv + ['--mesh', spec]) == 0
    lines = _lines(capfd.readouterr().out)
    assert tpretrain.main(argv) == 0
    one = _lines(capfd.readouterr().out)
    assert lines[-1] == one[-1] == {'done': True, 'final_step': 3}
    got = [x['loss'] for x in lines if 'loss' in x]
    want = [x['loss'] for x in one if 'loss' in x]
    assert len(got) == 3 and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, atol=0 if model == 'tiny' else 2e-3)


def _lines(text):
    return [json.loads(x) for x in text.splitlines() if x.startswith('{')]
