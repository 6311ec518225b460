"""MoE training over the sequence axis against the JAX reference, on the
CPU.

The reference forms capacity dispatch's groups over the GLOBAL sequence
(``min(S, moe_group_size)`` columns; the capacity of a group from that
size; slots claimed k-major over the whole group), so under ``seq`` a
token's slot depends on tokens of the other ranks. The port's train
step on TINY_MOE (4 query and 2 kv heads of dim 128, fp32, ring
attention) at ``seq=2`` (dense dispatch; capacity 0.5 with the default
group, 128 columns across both ranks; capacity 0.5 with groups of 32,
inside a rank) and at ``expert=2,seq=2`` (capacity 0.5, full remat)
against the JAX package's train step on the same mesh of virtual CPU
devices (``tests/torch_mesh_reference.py``): three AdamW steps give the
reference's loss, total loss, router aux loss, grad norm and params,
each rank's blocks are the reference's shards at its coordinates, and
each step issues the collectives counted below. Planted faults in the
same ranks must fail the comparison: capacity claimed on each rank's
columns alone, and the router statistics' sum over ``seq`` skipped.
One process holds the per-rank slot claim against the reference's
block on the whole sequence, with a group across the rank boundary.
``pretrain`` and the full finetune train a MoE model at ``seq=2``.
Each mesh launches once.
"""
import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_reference as ref_lib
from skypilot_tpu.models import config as jconfig
from skypilot_tpu.models import llama as jllama
from skypilot_tpu.parallel.sharding import DEFAULT_RULES
from skypilot_tpu_torch.models import config as tconfig
from skypilot_tpu_torch.models import hf_interop
from skypilot_tpu_torch.models import llama as tllama
from skypilot_tpu_torch.parallel.launch import launch
from skypilot_tpu_torch.parallel.sharding import TensorParallel
from skypilot_tpu_torch.train import finetune as tfinetune
from skypilot_tpu_torch.train import pretrain as tpretrain
from torch_threads import few_torch_threads  # noqa: F401 (autouse)
from torch_tp_ranks import one_thread_ranks  # noqa: F401 (autouse)
import torch_seq_ranks as ranks

MODEL = 'tiny-moe'
N_LAYERS = 2
SEQ2, BOTH = 'seq=2', 'expert=2,seq=2'
CAPACITY = {'moe_dispatch': 'capacity', 'capacity_factor': 0.5}
# (mesh, run name, model overrides, planted faults). The dense run
# weighs the aux at 1.0, so that its gradient shows in every leaf; the
# expert=2,seq=2 run rematerializes every layer, so its recompute
# re-issues the layer's collectives.
RUNS = (
    (SEQ2, 'dense', {'router_aux_loss_coeff': 1.0},
     ("aux of this rank's tokens",)),
    (SEQ2, 'capacity', CAPACITY, ('rank-local groups',)),
    (SEQ2, 'capacity group 32', dict(CAPACITY, moe_group_size=32), ()),
    (BOTH, 'capacity', dict(CAPACITY, remat_policy='full'), ()),
)
FIXTURE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'skypilot_tpu_torch', 'testdata',
    'tokenizer_llama3')
PRETRAIN = ['--model', MODEL, '--device', 'cpu', '--batch', '4', '--seq',
            '64', '--steps', '3', '--log-every', '1', '--moe-dispatch',
            'capacity', '--capacity-factor', '0.5']


def _batches():
    return [ref_lib.batch(40), ref_lib.batch(41), ref_lib.batch(42)]


def _finetune_argv(root):
    """A full finetune of TINY_MOE (vocab 1024, the tokenizer fixture's)
    as an HF directory on a text corpus, both written under ``root``."""
    cfg = tconfig.get_model_config(MODEL, vocab_size=1024)
    ckpt = os.path.join(root, 'base')
    hf_interop.save_checkpoint(tllama.init_params(0, cfg, device='cpu'), cfg,
                               ckpt)
    for name in ('tokenizer.json', 'tokenizer_config.json'):
        shutil.copy(os.path.join(FIXTURE, name), ckpt)
    corpus = os.path.join(root, 'corpus.txt')
    with open(corpus, 'w') as f:
        f.write('\n'.join(f'document {i}: the experts split the sequence.'
                          for i in range(40)))
    return ['--hf-checkpoint', ckpt, '--data', corpus, '--steps', '3',
            '--batch', '4', '--seq', '32', '--learning-rate', '1e-3',
            '--lora-rank', '0', '--log-every', '1', '--device', 'cpu']


def step_collectives(spec, name):
    """The collectives of one train step, by kind and group.

    A dense ``seq=2`` step (no remat, AdamW) of ``N_LAYERS`` layers:
    the ring's K/V hop in each layer's forward and its K/V and dk/dv
    hops in the backward; over ``tokens`` the loss's weight sum, the
    metrics' loss and each of the 13 leaves' gradient sum.
    MoE adds the layers' router statistics [L, 2E], summed over
    ``tokens`` once a step, and, for a capacity layer whose group
    crosses a rank boundary, one gather of the top-k choices over
    ``seq`` a forward (a full remat's recompute re-runs it: the
    expert branch's saved tensors come after it). Under ``expert`` each
    MoE layer adds one sum of its output over ``experts`` (the
    recompute stops before it) and two in the backward (the expert
    branch's input and the routing weights), and the norm and AdamW's
    statistics add one sum over ``expert`` of the expert leaves'
    squares."""
    axes = ref_lib.mesh_axes(spec)
    overrides = dict((r[1], r[2]) for r in RUNS if r[0] == spec)[name]
    forwards = 2 if overrides.get('remat_policy') == 'full' else 1
    n = N_LAYERS
    counts = {'ring_shift seq': (forwards + 2) * n,
              'all_reduce tokens': 2 + 13 + 1}
    group = min(ref_lib.S, overrides.get('moe_group_size', 4096))
    spans = (overrides.get('moe_dispatch') == 'capacity' and
             ref_lib.S // axes['seq'] % group != 0)
    if spans:
        counts['all_gather seq'] = forwards * n
    if axes.get('expert', 1) > 1:
        counts['all_reduce experts'] = 3 * n
        counts['all_reduce expert'] = 1
    return counts


@pytest.fixture(scope='module')
def launches(tmp_path_factory):
    """Each mesh's one launch, made at its first use; the ``seq=2``
    launch also runs ``pretrain`` and a full finetune."""
    root = str(tmp_path_factory.mktemp('moe_seq'))
    return {'finetune': _finetune_argv(root)}


def _mesh_run(launches, spec):
    if spec in launches:
        return launches[spec]
    runs, refs = [], {}
    for mspec, name, overrides, faults in RUNS:
        if mspec != spec:
            continue
        run, refs[name] = ref_lib.run(spec, name, 'adamw', _batches(),
                                      model=MODEL, attention_impl='ring',
                                      **overrides)
        runs += [run] + [dict(run, name=fault, fault=fault)
                         for fault in faults]
    mains = finetunes = ()
    if spec == SEQ2:
        mains = [('skypilot_tpu_torch.train.pretrain',
                  PRETRAIN + ['--mesh', SEQ2])]
        finetunes = [launches['finetune'] + ['--mesh', SEQ2]]
    world = int(np.prod(list(ref_lib.mesh_axes(spec).values())))
    out = launch(ranks.seq_train_checks, world, spec, runs, mains,
                 finetunes, device='cpu')
    launches[spec] = (out, refs)
    return launches[spec]


CASES = [(r[0], r[1]) for r in RUNS]


@pytest.mark.parametrize('spec,name', CASES)
def test_moe_train_steps_match_jax_on_seq_mesh(launches, spec, name):
    out, refs = _mesh_run(launches, spec)
    got = out[0]['runs'][name]
    ref_lib.assert_matches(got, refs[name])
    auxes = [m['router_aux'] for m in got['metrics']]
    assert all(0.9 < a < 2.0 for a in auxes), auxes
    for r in out[1:]:
        assert r['runs'][name]['metrics'] == got['metrics']
    assert all(r['runs'][name]['flash_fallbacks'] == 0 for r in out)


@pytest.mark.parametrize('spec,name', CASES)
def test_moe_state_is_sharded_on_seq_mesh(launches, spec, name):
    """Each rank's blocks are the reference's shards: every leaf whole
    over ``seq``, the expert leaves split over ``expert``."""
    out, refs = _mesh_run(launches, spec)
    ref_lib.assert_state_sharded(out, name, refs[name])


@pytest.mark.parametrize('spec,name', CASES)
def test_moe_seq_step_collectives(launches, spec, name):
    out, _ = _mesh_run(launches, spec)
    want = step_collectives(spec, name)
    for r in out:
        for step in r['runs'][name]['collectives']:
            assert step == want


@pytest.mark.parametrize('spec,name,fault', [
    (spec, name, fault) for spec, name, _, faults in RUNS
    for fault in faults])
def test_planted_faults_fail_the_comparison(launches, spec, name, fault):
    out, refs = _mesh_run(launches, spec)
    with pytest.raises(AssertionError):
        ref_lib.assert_matches(out[0]['runs'][fault], refs[name])


class _SeqRank(TensorParallel):
    """Rank ``seq_rank`` of ``seq`` simulated in one process: its gather
    of the top-k choices over ``seq`` returns ``WHOLE``, the choices of
    the whole sequence, after checking that the rank's own are its
    columns of it."""

    WHOLE = None

    def all_gather(self, x, dim, axis):
        whole = type(self).WHOLE
        s = x.shape[1]
        assert (dim, axis) == (1, 'seq')
        assert torch.equal(x, whole[:, self.seq_rank * s:
                                    (self.seq_rank + 1) * s])
        return whole


@pytest.mark.parametrize('s,group_size,n', [(96, 32, 2), (128, 4096, 4)],
                         ids=['straddling-group-n2', 'one-group-n4'])
def test_rank_slots_match_the_whole_sequence(s, group_size, n):
    """Each simulated rank of ``seq=n`` claims its tokens' slots from the
    gathered choices, and its block's output on its columns, joined
    over the ranks, is the reference's block on the whole sequence
    (1e-5): at S=96 with groups of 32 on two ranks the middle group
    crosses the boundary (rank 1's columns start 16 into it), at S=128
    on four ranks one group spans them all. Assignments drop (capacity
    0.5), and the block of each rank's columns alone (groups and
    capacity of its own columns) is off the reference."""
    overrides = dict(moe_dispatch='capacity', capacity_factor=0.5,
                     moe_group_size=group_size)
    jcfg = jconfig.get_model_config(MODEL, compute_dtype=jnp.float32,
                                    **overrides)
    tcfg = tconfig.get_model_config(MODEL, compute_dtype=torch.float32,
                                    **overrides)
    rng = np.random.RandomState(7)
    d, e, f = tcfg.d_model, tcfg.num_experts, tcfg.d_ff
    lp = {'router': rng.randn(d, e) * 0.5, 'wi_gate': rng.randn(e, d, f),
          'wi_up': rng.randn(e, d, f), 'wo': rng.randn(e, f, d)}
    lp = {k: (v / (1.0 if k == 'router' else np.sqrt(v.shape[-2])))
          .astype(np.float32) for k, v in lp.items()}
    x = rng.randn(2, s, d).astype(np.float32)
    want, _ = jllama._moe_block(jnp.asarray(x), {k: jnp.asarray(v) for k, v
                                                 in lp.items()}, jcfg,
                                DEFAULT_RULES)
    tlp = {k: torch.from_numpy(v) for k, v in lp.items()}
    xt = torch.from_numpy(x)
    k_top = tcfg.experts_per_token
    group, capacity = tllama._capacity_groups(s, tcfg, tllama._ONE_DEVICE)
    whole = tllama._route(xt, tlp['router'], k_top)[2]
    _SeqRank.WHOLE = whole
    slots = tllama._slots(whole.reshape(-1, group, k_top), e, capacity)
    slots = slots.reshape(2, s, k_top, e, capacity)
    assert 0 < slots.sum() < whole.numel()
    cols = s // n
    outs, alone = [], []
    with torch.no_grad():
        for r in range(n):
            par = _SeqRank(seq=n, seq_rank=r)
            assert tllama._capacity_groups(cols, tcfg, par) == (group,
                                                                capacity)
            first, count, offset = tllama._seq_window(cols, group, par)
            window = whole[:, first * group:(first + count) * group]
            mine = tllama._slots(window.reshape(-1, group, k_top), e,
                                 capacity)
            mine = mine.reshape(2, count * group, k_top, e, capacity)
            assert torch.equal(mine[:, offset:offset + cols],
                               slots[:, r * cols:(r + 1) * cols])
            block = xt[:, r * cols:(r + 1) * cols]
            outs.append(tllama._moe_block(block, tlp, tcfg, par=par)[0])
            alone.append(tllama._moe_block(block, tlp, tcfg)[0])
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)
    assert not np.allclose(torch.cat(alone, 1).numpy(), np.asarray(want),
                           atol=1e-3)


def test_pretrain_trains_moe_on_seq_mesh(launches, capfd):
    """``pretrain --mesh seq=2 --moe-dispatch capacity`` (in the seq=2
    launch's ranks) trains: rc 0, only rank 0 prints, finite losses,
    the one-process run's losses within bf16's relative rounding (2^-8:
    the ranks' attention rounds its blocks' bf16 outputs apart, where
    the one process rounds the whole row once)."""
    out, _ = _mesh_run(launches, SEQ2)
    first, second = (r['mains'][0] for r in out)
    assert first['rc'] == 0 and second['rc'] == 0
    assert second['lines'] == []
    assert first['lines'][-1] == {'done': True, 'final_step': 3}
    got = [x['loss'] for x in first['lines'] if 'loss' in x]
    assert tpretrain.main(PRETRAIN) == 0
    one = [json.loads(x) for x in capfd.readouterr().out.splitlines()
           if x.startswith('{')]
    want = [x['loss'] for x in one if 'loss' in x]
    assert len(got) == 3 and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=2 ** -8)


def test_full_finetune_moe_on_seq_mesh(launches):
    """Three full-finetune steps of a MoE checkpoint at seq=2 (fp32
    compute) give the one-process finetune's losses (1e-5); only rank 0
    prints."""
    out, _ = _mesh_run(launches, SEQ2)
    one = tfinetune.run(tfinetune.parse_args(launches['finetune']),
                        compute_dtype=torch.float32)
    first, second = (r['finetunes'][0] for r in out)
    assert second['lines'] == []
    np.testing.assert_allclose(first['losses'], one['losses'], rtol=1e-5)
