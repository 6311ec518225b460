"""The flash kernels per shard of a training mesh, against the JAX
reference, on the CPU: the twins of ``tests/test_attention_mesh.py``.

Each rank (gloo, ``tests/torch_train_ranks.py``) runs
``multi_head_attention(impl='pallas')`` (the kernels' plain versions on
the CPU) on its rows of the batch (over data x fsdp) and its heads (over
tensor), as the reference's ``_flash_under_mesh`` shard_maps the kernel;
its output block, with and without segment ids, and the gradients of its
blocks equal the reference's ``xla_attention`` on the whole arrays,
sliced alike (B=4, S=256, 4 query and 2 kv heads of dim 128, fp32, the
reference test's shapes and limits). On ``data=2,fsdp=2,tensor=2`` a
train step with ``attention_impl='pallas'`` gives the ``'xla'`` step's
losses and the JAX mesh step's, with no call leaving the kernels' gate.
Heads that tensor does not divide are a ValueError when the mesh is
built (the reference falls back to XLA attention there). Each mesh
launches once.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_mesh_reference as ref_lib
from skypilot_tpu.ops.attention import xla_attention
from skypilot_tpu_torch.ops.attention import check_mesh
from skypilot_tpu_torch.parallel.launch import launch
from skypilot_tpu_torch.parallel.mesh import MeshConfig, build_mesh
from skypilot_tpu_torch.train import step as tstep
from torch_threads import few_torch_threads  # noqa: F401 (autouse)
from torch_tp_ranks import one_thread_ranks  # noqa: F401 (autouse)
import torch_train_ranks as ranks

B, S, H, KV, D = 4, 256, 4, 2, 128
FULL = 'data=2,fsdp=2,tensor=2'
MESHES = (FULL, 'fsdp=4')
TRAIN_HP = dict(learning_rate=1e-2, warmup_steps=1, total_steps=8)


def _qkv(seed):
    ks = jax.random.split(jax.random.key(seed), 3)
    return tuple(np.asarray(jax.random.normal(kk, (B, S, n, D), jnp.float32))
                 for kk, n in zip(ks, (H, KV, KV)))


def _segments():
    # Two documents per row, the boundary varying by row.
    return np.array([[0] * (64 + 32 * i) + [1] * (S - 64 - 32 * i)
                     for i in range(B)], np.int32)


def _train_batch():
    rng = np.random.RandomState(1)
    tokens = rng.randint(0, 512, (B, 128)).astype(np.int32)
    return {'tokens': tokens, 'targets': np.roll(tokens, -1, axis=1),
            'weights': np.ones((B, 128), np.float32)}


@pytest.fixture(scope='module')
def launches():
    """Each mesh's one launch, made at its first use."""
    return {}


def _mesh_run(launches, spec):
    if spec in launches:
        return launches[spec]
    q, k, v = _qkv(0)
    seg = _segments()
    runs, train_ref = [], None
    if spec == FULL:
        run, train_ref = ref_lib.run(spec, 'xla', 'adamw',
                                     [_train_batch()] * 3, hp=TRAIN_HP)
        run['overrides'] = {**run['overrides'], 'attention_impl': 'xla'}
        pallas = dict(run, name='pallas', overrides={
            **run['overrides'], 'attention_impl': 'pallas'})
        runs = [run, pallas]
    world = int(np.prod(list(ref_lib.mesh_axes(spec).values())))
    out = launch(ranks.attention_checks, world, spec, q, k, v, seg, runs,
                 device='cpu')
    launches[spec] = ((q, k, v, seg), out, train_ref)
    return launches[spec]


def _blocks(r, arrays):
    rows = slice(*r['rows'])
    return [x[rows][:, :, slice(*r[heads])]
            for x, heads in zip(arrays, ('heads', 'kv_heads', 'kv_heads'))]


@pytest.mark.parametrize('spec', MESHES)
def test_pallas_under_mesh_matches_xla(launches, spec):
    (q, k, v, _), out, _ = _mesh_run(launches, spec)
    want = np.asarray(xla_attention(q, k, v, causal=True))
    for r in out:
        np.testing.assert_allclose(r['plain'], _blocks(r, [want])[0],
                                   atol=2e-5, rtol=2e-5)
        assert r['fallbacks'] == 0


@pytest.mark.parametrize('spec', MESHES)
def test_pallas_under_mesh_segment_ids(launches, spec):
    (q, k, v, seg), out, _ = _mesh_run(launches, spec)
    want = np.asarray(xla_attention(q, k, v, causal=True, segment_ids=seg))
    for r in out:
        np.testing.assert_allclose(r['segments'], _blocks(r, [want])[0],
                                   atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize('spec', MESHES)
def test_pallas_under_mesh_gradients(launches, spec):
    (q, k, v, _), out, _ = _mesh_run(launches, spec)
    grads = jax.grad(lambda q, k, v: (xla_attention(
        q, k, v, causal=True).astype(jnp.float32) ** 2).sum(),
        argnums=(0, 1, 2))(q, k, v)
    for r in out:
        for got, want in zip(r['grads'], _blocks(r, [np.asarray(g)
                                                     for g in grads])):
            np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)


def test_train_step_pallas_on_mesh(launches):
    """The reference's twin: the pallas step trains and matches the xla
    step (there within 1e-3; here the reference's xla mesh step within
    LOSS_RTOL, both impls), with no call leaving the kernels' gate."""
    _, out, ref = _mesh_run(launches, FULL)
    want = [m['loss'] for m in ref['metrics']]
    for r in out:
        runs = r['runs']
        assert runs['pallas']['flash_fallbacks'] == 0
        for impl in ('pallas', 'xla'):
            got = [m['loss'] for m in runs[impl]['metrics']]
            np.testing.assert_allclose(got, want, rtol=ref_lib.LOSS_RTOL)
        pallas = [m['loss'] for m in runs['pallas']['metrics']]
        assert pallas[-1] < pallas[0], pallas


def test_pallas_nondividing_heads_raises():
    """tensor=4 does not divide 2 kv heads (nor tensor=8 the 4 query
    heads): the reference falls back to XLA attention over replicated
    heads; the port refuses the mesh when it is built."""
    for tensor in (4, 8):
        with pytest.raises(ValueError, match='does not divide'):
            check_mesh({'tensor': tensor}, H, KV)
        mesh = build_mesh(MeshConfig(tensor=tensor, fsdp=1),
                          devices=list(range(tensor)), device_type='cpu')
        cfg = ranks.tiny_config(head_dim=D)
        with pytest.raises(ValueError, match='does not divide'):
            tstep.make_train_step(cfg, tstep.TrainHParams(), mesh)
    # A seq degree runs the ring (tests/test_torch_ring_attention.py); a
    # stage degree splits the layers, not attention
    # (tests/test_torch_train_mesh_stage.py).
    check_mesh({'seq': 4, 'data': 2}, H, KV)
    check_mesh({'stage': 4, 'data': 2}, H, KV)
