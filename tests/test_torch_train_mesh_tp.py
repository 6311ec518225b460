"""Mesh training with the head axis against the JAX reference, on the CPU.

The port's train step at ``tensor=2`` (two gloo ranks) and at
``data=2,fsdp=2,tensor=2`` (eight) against the JAX package's train step
on the same mesh of virtual CPU devices, as in
``tests/test_torch_train_mesh.py``: three steps under AdamW and under
Adafactor give the reference's loss, grad norm and params, and each
rank's blocks are the reference's shards at its coordinates. On the
full mesh ten steps on one batch overfit it, and the vocab-parallel
cross entropy of a batch whose ranks hold unequal weights is the
reference's whole-batch loss. The optimizer-state
shardings mirror each param's own under a shape collision, as the
reference's do. Each mesh launches once.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_mesh_reference as ref_lib
from skypilot_tpu.models.config import get_model_config as jconfig
from skypilot_tpu.parallel.mesh import MeshConfig as JMeshConfig
from skypilot_tpu.parallel.mesh import build_mesh as jbuild_mesh
from skypilot_tpu.train import loss as jloss
from skypilot_tpu.train import step as jstep
from skypilot_tpu_torch.models.config import get_model_config as tconfig
from skypilot_tpu_torch.parallel.launch import launch
from skypilot_tpu_torch.parallel.mesh import MeshConfig, build_mesh
from skypilot_tpu_torch.train import step as tstep
from torch_threads import few_torch_threads  # noqa: F401 (autouse)
from torch_tp_ranks import one_thread_ranks  # noqa: F401 (autouse)
import torch_train_ranks as ranks

MESHES = ('tensor=2', 'data=2,fsdp=2,tensor=2')
FULL = 'data=2,fsdp=2,tensor=2'


@pytest.fixture(scope='module')
def launches():
    """Each mesh's one launch, made at its first use."""
    return {}


def _mesh_run(launches, spec):
    if spec in launches:
        return launches[spec]
    batches = [ref_lib.batch(20), ref_lib.batch(21),
               ref_lib.batch(22, segments=True)]
    runs, refs = [], {}
    for name, optimizer, widths in (
            ('adamw', 'adamw', {}),
            ('adafactor', 'adafactor', {'d_model': 128, 'd_ff': 256})):
        run, refs[name] = ref_lib.run(spec, name, optimizer, batches,
                                      **widths)
        runs.append(run)
    if spec == FULL:
        # The reference's test_loss_decreases_overfit: one batch, ten
        # steps at a high learning rate.
        runs.append({'name': 'overfit', 'overrides': {'head_dim': 128},
                     'hp': dict(learning_rate=1e-2, warmup_steps=2,
                                total_steps=50, weight_decay=0.0),
                     'params': runs[0]['params'],
                     'batches': [ref_lib.batch(23)] * 10})
    world = int(np.prod(list(ref_lib.mesh_axes(spec).values())))
    case = _loss_case() if spec == FULL else None
    out = launch(ranks.mesh_checks, world, spec, runs, case, device='cpu')
    launches[spec] = (out, refs, case)
    return launches[spec]


def _loss_case():
    """Logits whose rows hold unequal weights over the batch ranks
    (rows 4-7 weight 1 token in 10), over a vocab the tensor ranks
    split."""
    rng = np.random.RandomState(6)
    logits = rng.randn(ref_lib.B, 16, 34).astype(np.float32) * 3
    targets = rng.randint(0, 34, (ref_lib.B, 16)).astype(np.int32)
    weights = np.ones((ref_lib.B, 16), np.float32)
    weights[ref_lib.B // 2:] = rng.rand(ref_lib.B // 2, 16) < 0.1
    return logits, targets, weights


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


def test_loss_decreases_overfit(launches):
    out, _, _ = _mesh_run(launches, FULL)
    metrics = out[0]['runs']['overfit']['metrics']
    losses = [m['loss'] for m in metrics]
    assert losses[-1] < losses[0] * 0.9, losses
    assert metrics[-1]['step'] == 9
    # Every rank reports the same metrics.
    for r in out[1:]:
        assert r['runs']['overfit']['metrics'] == metrics


def test_cross_entropy_weights(launches):
    """The vocab-parallel cross entropy on the full mesh: each rank's
    share, summed over the ranks of one tensor index, is the reference's
    loss over the whole batch (not the mean of the batch ranks' means),
    and every rank sees the whole batch's weight sum."""
    out, _, (logits, targets, weights) = _mesh_run(launches, FULL)
    want, want_w = jloss.cross_entropy_loss(
        jnp.asarray(logits), jnp.asarray(targets), jnp.asarray(weights),
        z_loss_coeff=1e-4)
    for t in (0, 1):
        shares = [r['loss']['share'] for r in out
                  if r['coords']['tensor'] == t]
        np.testing.assert_allclose(sum(shares), float(want), rtol=1e-6)
    assert all(r['loss']['total'] == float(want_w) for r in out)
    means = [r['loss']['own_mean'] for r in out]
    assert abs(np.mean(means) - float(want)) > 1e-2


@pytest.mark.parametrize('optimizer', ['adamw', 'adafactor'])
def test_opt_state_sharding_exact_under_shape_collision(optimizer):
    """d_ff == d_model: wi_gate and wo have identical shapes but
    transposed shardings; each optimizer leaf that mirrors a param
    mirrors its own (the reference's specs, leaf for leaf), and
    Adafactor's factored statistics are whole on every rank."""
    mesh = build_mesh(MeshConfig(data=2, fsdp=2, tensor=2),
                      devices=list(range(8)), device_type='cpu')
    hp = tstep.TrainHParams(optimizer=optimizer)
    sh = tstep.state_shardings(mesh, tconfig('tiny', d_ff=64), hp)
    wo = sh.params['layers']['mlp']['wo'].spec
    gate = sh.params['layers']['mlp']['wi_gate'].spec
    assert wo != gate
    jmesh = jbuild_mesh(JMeshConfig(data=2, fsdp=2, tensor=2),
                        devices=jax.devices()[:8])
    jsh = jstep.state_shardings(jmesh, jconfig('tiny', d_ff=64),
                                jstep.TrainHParams(optimizer=optimizer))
    for path, leaf in jax.tree_util.tree_leaves_with_path(jsh.params):
        keys = [k.key for k in path]
        node = sh.params
        for k in keys:
            node = node[k]
        assert tuple(node.spec) == tuple(leaf.spec), keys
    inner = jsh.opt_state[1][0]
    mirrors = 0
    for tree in ref_lib.OPT_LEAVES[optimizer]:
        for path, leaf in jax.tree_util.tree_leaves_with_path(
                getattr(inner, tree)):
            keys = [k.key for k in path]
            node = sh.opt_state[tree]
            for k in keys:
                node = node[k]
            assert tuple(node.spec) == tuple(leaf.spec), (tree, keys)
            if keys[-2:] == ['mlp', 'wo'] and tree in ('mu', 'nu'):
                assert node.spec == wo
                mirrors += 1
    assert mirrors == (2 if optimizer == 'adamw' else 0)


@pytest.mark.parametrize('name,overrides', [
    ('tiny', {}), ('tiny', {'tie_embeddings': True}), ('tiny-moe', {})])
def test_param_shapes_match_init(name, overrides):
    """``llama.param_shapes`` (what the mesh layout and the shardings
    are built from) names every leaf of ``init_params`` with its
    shape."""
    from skypilot_tpu_torch.models import llama
    cfg = tconfig(name, **overrides)
    got = dict(tstep._paths(llama.param_shapes(cfg)))
    want = dict(tstep._paths(llama.init_params(0, cfg, device='cpu')))
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
