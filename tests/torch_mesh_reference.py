"""The JAX side of the mesh-training parity tests.

The reference runs in the test process on the 8 virtual CPU devices of
``tests/conftest.py``, a mesh of fewer ranks on the first devices; the
port's ranks run in spawned processes (``tests/torch_train_ranks.py``),
which never import this module. The runs here are the reference's own
``state_shardings`` / ``create_train_state`` / ``make_train_step`` on
the same mesh, at TINY with 4 query and 2 kv heads of dim 128 at fp32,
the XLA attention (its flash kernel under a mesh is held by
``tests/test_torch_train_mesh_attention.py``).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np

from skypilot_tpu.models.config import get_model_config
from skypilot_tpu.parallel.mesh import MeshConfig, build_mesh
from skypilot_tpu.train import step as jstep

B, S = 8, 128

# Tolerances against the reference on the same mesh: both sides' numbers
# are their one-device numbers up to the order of fp32 sums (the port's
# all-reduces and reduce-scatters, XLA's partitioned reductions); three
# steps of TINY agree within a few 1e-7 relative (loss, grad norm) and
# 1e-6 absolute (params of magnitude <= 0.3).
LOSS_RTOL = 1e-5
NORM_RTOL = 1e-5
PARAM_ATOL = 1e-5
# AdamW's exception: an element whose gradient cancels to the fp32
# rounding floor (an embedding row whose uses nearly cancel) has a
# gradient of arbitrary relative error in either package, and AdamW
# normalizes it, m / (sqrt(v) + eps), into an update of up to the full
# learning rate of either sign. Such elements are few: at most
# ADAM_FLOOR_ELEMENTS of a leaf may pass PARAM_ATOL, each by no more
# than twice the learning rates summed over the steps (the schedule's
# 0, 3e-4, 3e-4 at warmup 1).
ADAM_FLOOR_ELEMENTS = 4
ADAM_FLOOR_ATOL = 2 * (3e-4 + 3e-4)
# The step metrics held to the reference's.
METRICS = ('loss', 'total_loss', 'router_aux', 'grad_norm')
# The optimizer state's params-like trees, by optimizer.
OPT_LEAVES = {'adamw': ('mu', 'nu'), 'adafactor': ('v_row', 'v_col', 'v')}


def mesh_axes(spec):
    return {k: int(v) for k, v in
            (part.split('=') for part in spec.split(','))}


def jax_mesh(spec):
    axes = mesh_axes(spec)
    n = math.prod(axes.values())
    return build_mesh(MeshConfig(**{'fsdp': 1, **axes}),
                      devices=jax.devices()[:n])


def jax_config(model='tiny', **overrides):
    return get_model_config(model, **{
        'n_heads': 4, 'n_kv_heads': 2, 'head_dim': 128,
        'compute_dtype': jnp.float32, 'attention_impl': 'xla', **overrides})


def batch(seed, vocab=512, segments=False):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, vocab, (B, S)).astype(np.int32)
    out = {'tokens': tokens, 'targets': np.roll(tokens, -1, axis=1),
           'weights': (rng.rand(B, S) > 0.1).astype(np.float32)}
    if segments:
        out['segments'] = np.stack(
            [np.cumsum(rng.rand(S) < 0.03) for _ in range(B)]
        ).astype(np.int32)
        out['positions'] = np.stack(
            [np.arange(S) + 7 * i for i in range(B)]).astype(np.int32)
    return out


def _key(path):
    return '/'.join(str(k.key) for k in path)


def shards_by_coords(jmesh, tree):
    """{'a/b/c' leaf path: {sorted coords tuple: shard data}} of a tree
    of sharded arrays."""
    names = jmesh.axis_names
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        per = {}
        for shard in leaf.addressable_shards:
            where = np.argwhere(jmesh.devices == shard.device)[0]
            per[tuple(sorted(zip(names, (int(i) for i in where))))] = \
                np.array(shard.data, copy=True)
        out[_key(path)] = per
    return out


def run(spec, name, optimizer, batches, seed=0, hp=None, model='tiny',
        **overrides):
    """The reference's train steps of ``model`` on mesh ``spec``: the
    port's run (``torch_train_ranks.mesh_checks``), and what to hold it
    to: each step's loss, total loss, router aux loss and grad norm, the
    whole params after, and the shards of the initial params and
    optimizer state by mesh coordinates."""
    jmesh = jax_mesh(spec)
    cfg = jax_config(model, **overrides)
    hp = dict(hp or dict(warmup_steps=1, total_steps=10),
              optimizer=optimizer)
    jhp = jstep.TrainHParams(**hp)
    shardings = jstep.state_shardings(jmesh, cfg, jhp)
    state = jstep.create_train_state(jax.random.key(seed), cfg, jhp, jmesh,
                                     shardings=shardings)
    params = jax.tree.map(lambda x: np.array(x, copy=True), state.params)
    inner = state.opt_state[1][0]   # ScaleByAdamState / FactoredState
    ref = {'params': shards_by_coords(jmesh, state.params),
           'opt': {n: shards_by_coords(jmesh, getattr(inner, n))
                   for n in OPT_LEAVES[optimizer]},
           'metrics': [], 'optimizer': optimizer}
    step = jstep.make_train_step(cfg, jhp, jmesh, shardings=shardings)
    for b in batches:
        state, metrics = step(state, jax.tree.map(jnp.asarray, b))
        ref['metrics'].append({k: float(metrics[k]) for k in METRICS} |
                              {'step': int(metrics['step'])})
    ref['final'] = jax.tree.map(np.asarray, state.params)
    port_run = {'name': name, 'model': model,
                'overrides': {'head_dim': 128, **overrides},
                'hp': hp, 'params': params, 'batches': batches}
    return port_run, ref


def assert_matches(got, ref):
    """A port run (rank 0's result) against the reference's."""
    for g, r in zip(got['metrics'], ref['metrics'], strict=True):
        assert g['step'] == r['step']
        for key in ('loss', 'total_loss', 'router_aux'):
            np.testing.assert_allclose(g[key], r[key], rtol=LOSS_RTOL,
                                       err_msg=key)
        np.testing.assert_allclose(g['grad_norm'], r['grad_norm'],
                                   rtol=NORM_RTOL)
    final = dict(jax.tree_util.tree_leaves_with_path(got['final']))
    adamw = ref['optimizer'] == 'adamw'
    for path, leaf in jax.tree_util.tree_leaves_with_path(ref['final']):
        diff = np.abs(final[path] - leaf)
        off = int((diff > PARAM_ATOL).sum())
        assert off <= (ADAM_FLOOR_ELEMENTS if adamw else 0), (
            jax.tree_util.keystr(path), off, float(diff.max()))
        assert diff.max() <= (ADAM_FLOOR_ATOL if adamw else PARAM_ATOL), (
            jax.tree_util.keystr(path), float(diff.max()))


def assert_state_sharded(ranks, name, ref):
    """Each rank's blocks of the initial params are the reference's
    shards on the device at the same mesh coordinates, exactly, and its
    optimizer leaves have that shard's shape (a block where the leaf
    mirrors its param, whole where it is replicated)."""
    for r in ranks:
        coords = tuple(sorted(r['coords'].items()))
        run = r['runs'][name]
        for path, block in jax.tree_util.tree_leaves_with_path(
                run['initial']):
            want = ref['params'][_key(path)][coords]
            np.testing.assert_array_equal(block, want, err_msg=_key(path))
        for tree, per_leaf in ref['opt'].items():
            assert set(run['opt_shapes'][tree]) == set(per_leaf), tree
            for path, per in per_leaf.items():
                assert run['opt_shapes'][tree][path] == \
                    per[coords].shape, (tree, path)
