"""Mesh training on the batch axes against the JAX reference, on the CPU.

The port's train step at ``data=2`` and ``fsdp=2`` (two gloo ranks,
``tests/torch_train_ranks.py``) against the JAX package's train step on
the same mesh of virtual CPU devices (``tests/torch_mesh_reference.py``):
three steps under AdamW (TINY, 4 query and 2 kv heads of dim 128, fp32;
the third batch packs documents) and under Adafactor (d_model 128,
d_ff 256, so that its leaves factor) give the reference's loss, grad
norm and params (tolerances in ``torch_mesh_reference``); each rank's
blocks are the reference's shards at its coordinates. At ``data=2`` the
loss of a batch whose ranks hold unequal weights is the reference's
whole-batch mean, and five steps on the port's packed batches give the
reference's losses and grad norms and fall. Each mesh launches once.
"""
import jax.numpy as jnp
import numpy as np
import pytest

import torch_mesh_reference as ref_lib
from skypilot_tpu.train import loss as jloss
from skypilot_tpu_torch.data import packer
from skypilot_tpu_torch.parallel.launch import launch
from torch_threads import few_torch_threads  # noqa: F401 (autouse)
from torch_tp_ranks import one_thread_ranks  # noqa: F401 (autouse)
import torch_train_ranks as ranks

MESHES = ('data=2', 'fsdp=2')


def _packed_batches(n):
    rng = np.random.RandomState(2)
    docs = []
    while len(docs) < 400:
        docs.extend(rng.randint(2, 512, rng.randint(3, 40)).tolist())
        docs.append(1)
    it = packer.packed_batch_iterator(np.asarray(docs, np.int32),
                                      batch=ref_lib.B, seq=ref_lib.S,
                                      eos_id=1)
    return [next(it) for _ in range(n)]


def _loss_case():
    """A batch whose first half (rank 0's rows at data=2) is fully
    weighted and whose second half has 1 token in 10."""
    rng = np.random.RandomState(5)
    logits = rng.randn(ref_lib.B, 16, 33).astype(np.float32) * 3
    targets = rng.randint(0, 33, (ref_lib.B, 16)).astype(np.int32)
    weights = np.ones((ref_lib.B, 16), np.float32)
    weights[ref_lib.B // 2:] = rng.rand(ref_lib.B // 2, 16) < 0.1
    return logits, targets, weights


@pytest.fixture(scope='module')
def launches():
    """Each mesh's one launch, made at its first use."""
    return {}


def _mesh_run(launches, spec):
    if spec in launches:
        return launches[spec]
    batches = [ref_lib.batch(10), ref_lib.batch(11),
               ref_lib.batch(12, segments=True)]
    runs, refs = [], {}
    for name, optimizer, widths in (
            ('adamw', 'adamw', {}),
            ('adafactor', 'adafactor', {'d_model': 128, 'd_ff': 256})):
        run, refs[name] = ref_lib.run(spec, name, optimizer, batches,
                                      **widths)
        runs.append(run)
    loss_case = None
    if spec == 'data=2':
        run, refs['packed'] = ref_lib.run(spec, 'packed', 'adamw',
                                          _packed_batches(5), seed=1)
        runs.append(run)
        loss_case = _loss_case()
    out = launch(ranks.mesh_checks, 2, spec, runs, loss_case, device='cpu')
    launches[spec] = (out, refs, loss_case)
    return launches[spec]


@pytest.mark.parametrize('spec', MESHES)
@pytest.mark.parametrize('name', ['adamw', 'adafactor'])
def test_train_steps_match_jax_on_mesh(launches, spec, name):
    out, refs, _ = _mesh_run(launches, spec)
    ref_lib.assert_matches(out[0]['runs'][name], refs[name])


@pytest.mark.parametrize('spec', MESHES)
@pytest.mark.parametrize('name', ['adamw', 'adafactor'])
def test_state_is_sharded(launches, spec, name):
    out, refs, _ = _mesh_run(launches, spec)
    ref_lib.assert_state_sharded(out, name, refs[name])


def test_train_step_on_packed_batches(launches):
    out, refs, _ = _mesh_run(launches, 'data=2')
    got = out[0]['runs']['packed']['metrics']
    losses = [m['loss'] for m in got]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    # Each step's loss and grad norm are the reference's. The params are
    # held after three steps by the parity runs; over five AdamW steps an
    # element whose gradient sits at the fp32 rounding floor takes a
    # normalized update of either sign in either package.
    for g, r in zip(got, refs['packed']['metrics'], strict=True):
        np.testing.assert_allclose(g['loss'], r['loss'],
                                   rtol=ref_lib.LOSS_RTOL)
        np.testing.assert_allclose(g['grad_norm'], r['grad_norm'],
                                   rtol=ref_lib.NORM_RTOL)


def test_cross_entropy_weights(launches):
    out, _, case = _mesh_run(launches, 'data=2')
    logits, targets, weights = case
    want, want_w = jloss.cross_entropy_loss(
        jnp.asarray(logits), jnp.asarray(targets), jnp.asarray(weights),
        z_loss_coeff=1e-4)
    shares = [r['loss'] for r in out]
    np.testing.assert_allclose(sum(s['share'] for s in shares), float(want),
                               rtol=1e-6)
    assert all(s['total'] == float(want_w) for s in shares)
    # Not the mean of the ranks' own means.
    mean_of_means = np.mean([s['own_mean'] for s in shares])
    assert abs(mean_of_means - float(want)) > 1e-2
