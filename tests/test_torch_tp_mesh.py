"""The port's mesh, sharding rules and rank launcher against the JAX
reference, on the CPU.

Twins of ``tests/test_mesh.py`` and ``tests/test_sharding_rules.py``:
the port's ``MeshConfig`` arithmetic, its rank layouts (single and
multi-slice) and its logical-axis specs must equal the reference's on
the same inputs, where the reference lays out the 8 virtual CPU devices
of ``tests/conftest.py`` and the port the ranks 0..7 (rank ``r`` for
device ``r``). Then the launcher: its backend rule, a failing or dying
rank ending the launch with its traceback, and the collectives
benchmark over two ``gloo`` ranks.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest

import torch_tp_ranks as ranks
from skypilot_tpu.models import llama as jllama
from skypilot_tpu.models.config import get_model_config as jax_config
from skypilot_tpu.parallel import mesh as jmesh
from skypilot_tpu.parallel import sharding as jsharding
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.models.config import get_model_config
from skypilot_tpu_torch.ops import collectives_bench
from skypilot_tpu_torch.parallel import launch, mesh, sharding
from skypilot_tpu_torch.parallel.sharding import DEFAULT_RULES, P
from torch_threads import few_torch_threads  # noqa: F401 (autouse)
from torch_tp_ranks import one_thread_ranks  # noqa: F401 (autouse)


def _same_config(port_cfg, jax_cfg):
    assert dataclasses.asdict(port_cfg) == dataclasses.asdict(jax_cfg)


def _same_layout(port_mesh, jax_mesh):
    assert port_mesh.shape == dict(jax_mesh.shape)
    ids = np.vectorize(lambda d: d.id)(jax_mesh.devices)
    np.testing.assert_array_equal(port_mesh.devices, ids)


def test_resolve_fills_fsdp():
    cfg = mesh.MeshConfig(data=2, tensor=2).resolve(8)
    assert cfg.fsdp == 2 and cfg.num_devices == 8
    _same_config(cfg, jmesh.MeshConfig(data=2, tensor=2).resolve(8))


@pytest.mark.parametrize('kwargs', [dict(data=3, fsdp=1),
                                    dict(data=2, fsdp=2, tensor=4),
                                    dict(data=-1, fsdp=-1)])
def test_resolve_mismatch_raises(kwargs):
    with pytest.raises(ValueError) as want:
        jmesh.MeshConfig(**kwargs).resolve(8)
    with pytest.raises(ValueError) as got:
        mesh.MeshConfig(**kwargs).resolve(8)
    assert str(got.value) == str(want.value)


def test_build_mesh_axes():
    config = dict(data=2, fsdp=2, tensor=2)
    port = mesh.build_mesh(mesh.MeshConfig(**config), devices=range(8))
    assert port.shape['data'] == 2 and port.shape['tensor'] == 2
    assert port.shape['stage'] == 1
    assert 'data' in mesh.describe_mesh(port)
    _same_layout(port, jmesh.build_mesh(jmesh.MeshConfig(**config)))
    assert port.coords(5) == {'data': 1, 'stage': 0, 'fsdp': 0, 'seq': 0,
                              'expert': 0, 'tensor': 1}


def test_build_mesh_hybrid_multislice():
    # 2 virtual slices of 4 ranks: the data axis rides DCN.
    for config in (dict(data=2, fsdp=4, num_slices=2),
                   dict(data=2, fsdp=2, tensor=2, num_slices=2)):
        port = mesh.build_mesh(mesh.MeshConfig(**config), devices=range(8))
        assert port.shape['data'] == 2
        _same_layout(port, jmesh.build_mesh(jmesh.MeshConfig(**config)))


def test_multislice_requires_dcn_axis():
    with pytest.raises(ValueError):
        jmesh.build_mesh(jmesh.MeshConfig(data=1, fsdp=8, num_slices=2))
    with pytest.raises(ValueError, match='does not divide into DCN'):
        mesh.build_mesh(mesh.MeshConfig(data=1, fsdp=8, num_slices=2),
                        devices=range(8))


@pytest.mark.parametrize('config,slices', [
    (dict(data=4, fsdp=-1, num_slices=2), 1),
    (dict(data=-1, fsdp=4, num_slices=2), 4),
    (dict(data=2, stage=2, num_slices=4), 2),
    (dict(stage=2, fsdp=-1, num_slices=2), 1)])
def test_with_num_slices_matches_reference(config, slices):
    try:
        want = jmesh.MeshConfig(**config).with_num_slices(slices)
    except ValueError as e:
        with pytest.raises(ValueError, match='stage'):
            mesh.MeshConfig(**config).with_num_slices(slices)
        assert 'stage' in str(e)
        return
    _same_config(mesh.MeshConfig(**config).with_num_slices(slices), want)


def test_auto_mesh_config():
    for kwargs in (dict(tensor=2), dict(num_slices=2)):
        cfg = mesh.auto_mesh_config(8, **kwargs)
        _same_config(cfg, jmesh.auto_mesh_config(8, **kwargs))
    assert mesh.auto_mesh_config(8, tensor=2).fsdp == 4
    with pytest.raises(ValueError):
        mesh.auto_mesh_config(8, tensor=3)


def test_single_device_mesh():
    port = mesh.single_device_mesh(0)
    assert all(v == 1 for v in port.shape.values())
    assert tuple(port.shape) == tuple(
        jmesh.single_device_mesh(jax.devices()[0]).shape)
    assert mesh.describe_mesh(port) == 'Mesh(1 device)'
    assert mesh.mesh_axis_size(port, ('data', 'tensor')) == 1


# -- logical-axis rules -------------------------------------------------

def test_spec_mapping():
    for axes in (('batch', 'act_seq', 'act_embed'), ('embed', 'mlp')):
        assert DEFAULT_RULES.spec(axes) == tuple(
            jsharding.DEFAULT_RULES.spec(axes))
    assert DEFAULT_RULES.spec(('embed', 'mlp')) == P('fsdp', 'tensor')


def test_duplicate_mesh_axis_dropped():
    spec = DEFAULT_RULES.spec(('embed', 'embed'))
    assert spec == P('fsdp', None)
    assert spec == tuple(jsharding.DEFAULT_RULES.spec(('embed', 'embed')))


def test_rules_replace():
    rules = DEFAULT_RULES.replace(embed=None)
    assert rules.spec(('embed', 'mlp')) == P(None, 'tensor')
    assert DEFAULT_RULES.spec(('embed',)) == P('fsdp')
    assert rules.spec(('embed', 'mlp')) == tuple(
        jsharding.DEFAULT_RULES.replace(embed=None).spec(('embed', 'mlp')))
    with pytest.raises(KeyError, match='No sharding rule'):
        DEFAULT_RULES.spec(('nonsense',))


def test_param_shardings_cover_tree():
    """Every leaf's spec is the reference's, over the same mesh."""
    config = dict(data=2, fsdp=2, tensor=2)
    port_mesh = mesh.build_mesh(mesh.MeshConfig(**config), devices=range(8))
    port = sharding.param_shardings(
        port_mesh, llama.param_logical_axes(get_model_config('tiny')))
    want = jsharding.shard_params_pytree(
        jmesh.build_mesh(jmesh.MeshConfig(**config)),
        jllama.param_logical_axes(jax_config('tiny')))
    assert port['embed']['embedding'].spec == P('tensor', 'fsdp')
    assert port['layers']['attn']['wq'].spec == P('stage', 'fsdp',
                                                  'tensor', None)
    flat = jax.tree_util.tree_leaves_with_path(want)
    for path, jax_sharding in flat:
        leaf = port
        for p in path:
            leaf = leaf[p.key]
        assert leaf.spec == tuple(jax_sharding.spec) + (None,) * (
            len(leaf.spec) - len(tuple(jax_sharding.spec)))


def test_moe_param_axes_match_shapes():
    cfg = get_model_config('tiny-moe')
    params = llama.init_params(0, cfg, device='cpu')
    axes = llama.param_logical_axes(cfg)
    assert axes == jllama.param_logical_axes(jax_config('tiny-moe'))

    def walk(p, a):
        if isinstance(p, dict):
            assert sorted(p) == sorted(a)
            for key in p:
                walk(p[key], a[key])
        else:
            assert p.dim() == len(a), (p.shape, a)

    walk(params, axes)


# -- the launcher ---------------------------------------------------------

def test_backend_rule():
    assert launch.choose_backend(2, 'cpu')[0] == 'gloo'
    assert launch.choose_backend(2, 'cuda', device_count=1)[0] == 'gloo'
    assert launch.choose_backend(2, 'cuda', device_count=2)[0] == 'nccl'
    assert launch.choose_backend(4, 'cuda', device_count=8)[0] == 'nccl'
    assert str(launch.rank_device(3, 'cpu')) == 'cpu'


@pytest.mark.parametrize('how,match', [('raise', 'planted failure'),
                                       ('exit', 'exit code 3')])
def test_a_failing_rank_ends_the_launch(how, match):
    """The other rank waits in a collective; the launch still ends, with
    the failed rank's traceback or exit code."""
    with pytest.raises(launch.RankFailed, match=match):
        launch.launch(ranks.fail, 2, 1, how, device='cpu')
    assert launch.launch(ranks.fail, 2, 5, how, device='cpu') == [0, 1]


def test_collectives_bench_over_two_ranks(capsys):
    assert collectives_bench.main(['--op', 'all', '--size-mb', '0.05',
                                   '--iters', '2', '--warmup', '1',
                                   '--device', 'cpu']) == 0
    lines = [json.loads(line) for line in
             capsys.readouterr().out.strip().splitlines()]
    assert [line['metric'] for line in lines] == [
        'collective_all_reduce_2dev', 'collective_all_gather_2dev',
        'collective_reduce_scatter_2dev', 'collective_ppermute_2dev']
    for line in lines:
        detail = line['detail']
        assert detail['backend'] == 'gloo' and detail['devices'] == 2
        factor = (1.0 if 'all_reduce' in line['metric'] or
                  'ppermute' in line['metric'] else 0.5)
        assert line['value'] == pytest.approx(
            detail['algbw_gbps'] * factor, rel=1e-2, abs=2e-3)
