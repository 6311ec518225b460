"""The stage-axis mesh runs of ``tests/test_torch_train_mesh_stage.py``
and ``tests/test_torch_train_mesh_stage_axes.py`` (two files, so that
two test workers share them), and the checks they share.

The port's train step (TINY at 4 query and 2 kv heads of dim 128, fp32,
the XLA attention) on a mesh with a stage axis (gloo ranks) against the
JAX package's train step on the same mesh of virtual CPU devices: three
steps give the reference's loss, total loss, router aux loss (0 under
stages), grad norm and params; ``make_forward`` gives its logits; each
rank's blocks are the reference's shards at its coordinates (a stage
rank holds its L/S layers); each step hands every microbatch forward and
its gradient back once. Each mesh launches once, its planted faults in
the same ranks.
"""
import jax
import jax.numpy as jnp
import numpy as np

import torch_mesh_reference as ref_lib
from skypilot_tpu.models import llama as jllama
from skypilot_tpu.parallel import pipeline as jpipeline
from skypilot_tpu_torch.models import config as tconfig
from skypilot_tpu_torch.models import llama as tllama
from skypilot_tpu_torch.parallel.launch import launch
from skypilot_tpu_torch.train import step as tstep
import torch_train_ranks as ranks

# A launch of the mesh runs takes well under a minute; a deadlocked
# exchange fails it here instead of at the collective timeout.
LAUNCH_TIMEOUT_S = 120
CAPACITY = {'moe_dispatch': 'capacity', 'capacity_factor': 0.5}
# Run label -> (mesh, model, optimizer, model overrides, hparams, planted
# faults). Every run of one mesh shares its launch.
CASES = {
    'stage=2': ('stage=2', 'tiny', 'adamw', {}, {},
                ('dx dropped', 'stage sum skipped')),
    'stage=2 M=8': ('stage=2', 'tiny', 'adamw', {},
                    {'pipeline_microbatches': 8}, ()),
    'stage=2 tiny-moe': ('stage=2', 'tiny-moe', 'adamw', {}, {}, ()),
    # The embedding is the first stage's input and the last stage's head.
    'stage=2 tied': ('stage=2', 'tiny', 'adamw', {'tie_embeddings': True},
                     {}, ()),
    'stage=4': ('stage=4', 'tiny', 'adamw', {'n_layers': 4}, {}, ()),
    'stage=2,fsdp=2': ('stage=2,fsdp=2', 'tiny', 'adafactor', {}, {}, ()),
    'stage=2,tensor=2': ('stage=2,tensor=2', 'tiny', 'adamw',
                         {'remat_policy': 'full'}, {}, ()),
    # Ring and Ulysses attention over each stage's seq group, the RoPE
    # positions from each seq rank's first column.
    'stage=2,seq=2 ring': ('stage=2,seq=2', 'tiny', 'adamw',
                           {'attention_impl': 'ring'}, {},
                           ('positions from 0',)),
    # Under full remat the recompute re-runs each ring inside a
    # microbatch's backward.
    'stage=2,seq=2 ulysses': ('stage=2,seq=2', 'tiny', 'adamw',
                              {'attention_impl': 'ulysses',
                               'remat_policy': 'full'}, {}, ()),
    'stage=2,seq=2 tiny-moe': ('stage=2,seq=2', 'tiny-moe', 'adamw',
                               {'attention_impl': 'ring'}, {}, ()),
    # The default group (128 columns) crosses the seq ranks' boundary.
    'stage=2,seq=2 capacity': ('stage=2,seq=2', 'tiny-moe', 'adamw',
                               dict(CAPACITY, attention_impl='ring',
                                    remat_policy='full'), {}, ()),
    'stage=2,expert=2 tiny-moe': ('stage=2,expert=2', 'tiny-moe', 'adamw',
                                  {}, {}, ('expert sum skipped',)),
    'stage=2,expert=2 capacity': ('stage=2,expert=2', 'tiny-moe', 'adamw',
                                  {'moe_dispatch': 'capacity',
                                   'remat_policy': 'full'}, {}, ()),
}


def labels_of(specs):
    """The runs of the meshes ``specs``."""
    return [label for label, case in CASES.items() if case[0] in specs]


def mesh_run(launches, spec):
    """Mesh ``spec``'s one launch, made at its first use and kept in
    ``launches`` (a test module's cache): (every rank's results, {label:
    reference, with the initial params whole under 'initial'})."""
    if spec in launches:
        return launches[spec]
    batches = [ref_lib.batch(40), ref_lib.batch(41), ref_lib.batch(42)]
    runs, refs = [], {}
    for label, (s, model, optimizer, overrides, hp, faults) in \
            CASES.items():
        if s != spec:
            continue
        run, ref = ref_lib.run(
            spec, label, optimizer, batches, model=model,
            hp=dict(warmup_steps=1, total_steps=10, **hp), **overrides)
        runs += [dict(run, forward=True)] + [
            dict(run, name=fault, fault=fault) for fault in faults]
        refs[label] = dict(ref, initial=run['params'])
    world = int(np.prod(list(ref_lib.mesh_axes(spec).values())))
    out = launch(ranks.mesh_checks, world, spec, runs, device='cpu',
                 timeout=LAUNCH_TIMEOUT_S)
    launches[spec] = (out, refs)
    return launches[spec]


def check_train_steps(launches, label):
    """Three steps of the run against the reference's; every rank
    reports the same metrics."""
    out, refs = mesh_run(launches, CASES[label][0])
    got = out[0]['runs'][label]
    ref_lib.assert_matches(got, refs[label])
    # As in the reference, the router aux loss is not computed under
    # stages: a MoE model trains on the plain cross entropy.
    assert all(m['router_aux'] == 0.0 for m in got['metrics'])
    # Every rank reports the same metrics (the last stage's loss).
    for r in out[1:]:
        assert r['runs'][label]['metrics'] == got['metrics']
    assert all(r['runs'][label]['flash_fallbacks'] == 0 for r in out)


def check_forward(launches, label):
    """``make_forward`` over the stage ranks (the GPipe forward, the last
    stage's logits summed over stage, then gathered over the batch and
    vocab axes) gives the reference's logits of the initial params on
    every rank."""
    out, refs = mesh_run(launches, CASES[label][0])
    _, model, _, overrides, _, _ = CASES[label]
    batch = ref_lib.batch(40)
    # The reference's forward off a mesh; the ring and Ulysses run on
    # its seq axis only.
    cfg = ref_lib.jax_config(model, **dict(overrides, attention_impl='xla'))
    want = np.asarray(jllama.forward(
        jax.tree.map(jnp.asarray, refs[label]['initial']),
        jnp.asarray(batch['tokens']), cfg))
    for r in out:
        np.testing.assert_allclose(r['runs'][label]['forward'], want,
                                   atol=2e-5, rtol=2e-5)


def check_sharded(launches, label):
    """Each rank's blocks are the reference's shards: a stage rank holds
    its L/S of every layer leaf (and its fsdp or tensor block of them),
    the embedding, the final norm and the head whole over stage."""
    out, refs = mesh_run(launches, CASES[label][0])
    ref_lib.assert_state_sharded(out, label, refs[label])


def microbatches(label):
    spec, _, _, _, hp, _ = CASES[label]
    stages = ref_lib.mesh_axes(spec)['stage']
    return hp.get('pipeline_microbatches') or \
        jpipeline.default_num_microbatches(ref_lib.B, stages)


def check_handoffs(launches, label):
    """Each step, each microbatch goes forward once from every stage but
    the last and its gradient back once to every stage but the first;
    the leaves that stage does not split (embedding, final norm, head)
    sum over stage once each, with the loss's broadcast and the global
    norm's sum (and Adafactor's RMSes)."""
    out, _ = mesh_run(launches, CASES[label][0])
    spec = CASES[label][0]
    stages = ref_lib.mesh_axes(spec)['stage']
    m = microbatches(label)
    # Adafactor's update RMS and parameter RMS of each layer leaf sum
    # over stage too.
    shapes = tllama.param_shapes(tconfig.get_model_config(
        CASES[label][1], **CASES[label][3]))
    layer_leaves = len(tstep._leaves(shapes['layers']))
    unsplit = len(tstep._leaves(shapes)) - layer_leaves
    rms = 2 * layer_leaves if CASES[label][2] == 'adafactor' else 0
    for r in out:
        index = r['coords']['stage']
        want = {'send stage': m * ((index < stages - 1) + (index > 0)),
                'recv stage': m * ((index > 0) + (index < stages - 1)),
                'all_reduce stage': unsplit + 1 + 1 + rms}
        for step in r['runs'][label]['collectives']:
            assert {k: v for k, v in step.items() if 'stage' in k} == \
                want, (r['coords'], step)
