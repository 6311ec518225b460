"""Rank-side halves of the mesh-training tests.

``skypilot_tpu_torch.parallel.launch.launch`` runs these functions in
spawned ranks (``gloo`` on the CPU). A rank imports this module and,
through it, only torch and the port: never a test module, which imports
jax. Every function returns plain Python and numpy values; the gathered
(whole) arrays come back from rank 0 only.
"""
import contextlib
import io
import json
import sys

import numpy as np
import torch

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'skypilot_tpu')


def tiny_config(model='tiny', **overrides):
    from skypilot_tpu_torch.models.config import get_model_config
    base = dict(n_heads=4, n_kv_heads=2, compute_dtype=torch.float32)
    base.update(overrides)
    return get_model_config(model, **base)


def _mesh(spec):
    from skypilot_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from skypilot_tpu_torch.parallel.mesh import parse_mesh_spec
    if spec is None:
        return None
    return build_mesh(MeshConfig(**{'fsdp': 1, **parse_mesh_spec(spec)}),
                      device_type='cpu')


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().float().numpy().copy()
    return tree


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def mesh_checks(rank, world, spec, runs, loss_case=None, block_jax=False):
    """Every check of one mesh ``spec`` in one launch. Each run of
    ``runs``: its params (numpy, whole) placed on the mesh, then
    ``make_train_step`` on each of its global batches; returns per run
    the metrics of every step, this rank's blocks of the initial params,
    the shapes of its optimizer leaves, (rank 0) the whole params after
    the last step and, for a run with ``forward``, the logits of
    ``make_forward`` on the initial params and the first batch.
    ``loss_case`` (logits, targets, weights): ``loss_shares`` of it. ``block_jax``: jax and the JAX package are
    blocked in this rank first, and the result says whether jax
    loaded."""
    if block_jax:
        for name in FORBIDDEN:
            sys.modules[name] = None
    import torch.distributed as dist
    from skypilot_tpu_torch.parallel.sharding import tensor_parallel_of
    mesh = _mesh(spec)
    par = tensor_parallel_of(mesh)
    out = {'rank': rank, 'coords': mesh.coords(rank),
           'runs': {run['name']: _train_run(run, mesh, par, rank)
                    for run in runs}}
    if loss_case is not None:
        out['loss'] = _loss_shares(par, *loss_case)
    if block_jax:
        out['jax_loaded'] = sys.modules.get('jax') is not None
    dist.barrier()
    return out


def _train_run(run, mesh, par, rank):
    from skypilot_tpu_torch.models import convert
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.parallel.sharding import gather_params_pytree
    from skypilot_tpu_torch.train import step as tstep
    from skypilot_tpu_torch.parallel import sharding as psharding
    cfg = tiny_config(run.get('model', 'tiny'), **run.get('overrides', {}))
    hp = tstep.TrainHParams(**run['hp'])
    params = convert.params_from_numpy(run['params'], cfg, device='cpu')
    state = tstep.create_train_state_from_params(params, cfg, hp, mesh)
    del params
    result = {
        'initial': _numpy(state.params),
        'opt_shapes': {k: {'/'.join(p): tuple(v.shape) for p, v in
                           tstep._paths(tree)}
                       for k, tree in state.opt_state.items()
                       if isinstance(tree, dict)},
        'metrics': [], 'collectives': []}
    if run.get('forward'):
        # The inference forward of the initial params on the first
        # batch's tokens: the whole logits, on every rank.
        result['forward'] = tstep.make_forward(cfg, mesh)(
            state.params,
            torch.from_numpy(run['batches'][0]['tokens'])).numpy()
    step = tstep.make_train_step(cfg, hp, mesh)
    fa.reset_launch_counts()
    undo = plant(run['fault'], cfg) if run.get('fault') else None
    try:
        for batch in run['batches']:
            psharding.collective_stats(reset=True)
            state, metrics = step(state, _torch_batch(batch))
            result['metrics'].append(
                {k: float(metrics[k]) for k in METRICS} |
                {'step': metrics['step']})
            result['collectives'].append(
                psharding.collective_stats()['by_kind'])
    finally:
        if undo is not None:
            undo()
    result['flash_fallbacks'] = fa.FALLBACKS['cpu']
    shardings = tstep.state_shardings(mesh, cfg, hp)
    whole = gather_params_pytree(shardings.params, state.params, par)
    if rank == 0:
        result['final'] = _numpy(whole)
    return result


# The step metrics a run reports (``torch_mesh_reference.METRICS``).
METRICS = ('loss', 'total_loss', 'router_aux', 'grad_norm')


def plant(fault, cfg):
    """A planted fault of the MoE blocks or of the pipeline under a
    mesh, for the parity tests to catch; returns the undo.

    * ``'aux of rank products'``: the router aux loss as the mean over
      the batch ranks of each rank's E * sum f * P, not the product of
      the whole batch's f and P;
    * ``'routing weights unreduced'``: the top-k routing weights' f op
      skipped, so their gradient (and the router's) holds only this
      rank's experts' part;
    * ``'expert input unreduced'``: the expert branch's f op skipped, so
      the gradient into the tokens holds only this rank's experts'
      part;
    * ``'dx dropped'``: the backward handoff sends zeros, so a stage
      gets no gradient of its output;
    * ``'stage sum skipped'``: the gradients of the leaves that ``stage``
      does not split are not summed over ``stage``;
    * ``'rank-local groups'``: capacity dispatch under ``seq`` groups
      each rank's columns alone, with a group's capacity of its own
      columns, as one device would;
    * ``"aux of this rank's tokens"``: the router statistics' sum over
      ``seq`` skipped (on a mesh whose ``tokens`` group is ``seq``), so
      the aux is each rank's own tokens';
    * ``'positions from 0'``: every seq rank's default RoPE positions
      start at 0, not at its first column;
    * ``'expert sum skipped'``: a MoE block's output is not summed over
      ``experts``, so each rank keeps its own experts' part."""
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.parallel.sharding import (TensorParallel,
                                                      reduce_from_tokens)
    from skypilot_tpu_torch.train import step as tstep
    if fault == 'dx dropped':
        real_send = TensorParallel.send_to

        def send_to(self, x, hop, tag, axis='stage'):
            return real_send(self, torch.zeros_like(x) if hop < 0 else x,
                             hop, tag, axis)

        TensorParallel.send_to = send_to
        return lambda: setattr(TensorParallel, 'send_to', real_send)
    if fault == 'stage sum skipped':
        real_sum = tstep._stage_sum
        tstep._stage_sum = lambda grads, layout, par: grads
        return lambda: setattr(tstep, '_stage_sum', real_sum)
    if fault == 'positions from 0':
        real_positions = llama._rank_positions
        llama._rank_positions = lambda s, par, device: real_positions(
            s, llama._ONE_DEVICE, device)
        return lambda: setattr(llama, '_rank_positions', real_positions)
    if fault == 'expert sum skipped':
        real_reduce = llama.reduce_from_experts
        llama.reduce_from_experts = lambda x, par: x
        return lambda: setattr(llama, 'reduce_from_experts', real_reduce)
    if fault == 'rank-local groups':
        real_groups = llama._capacity_groups
        llama._capacity_groups = lambda s, cfg_, par: real_groups(
            s, cfg_, llama._ONE_DEVICE)
        return lambda: setattr(llama, '_capacity_groups', real_groups)
    if fault == "aux of this rank's tokens":
        real = llama._router_aux

        def own_tokens(stats, par):
            assert par.tokens == par.seq > 1
            return llama._aux_of(stats).mean()

        llama._router_aux = own_tokens
        return lambda: setattr(llama, '_router_aux', real)
    if fault == 'aux of rank products':
        real = llama._router_aux

        def rank_products(stats, par):
            aux = llama._aux_of(stats).mean()
            return reduce_from_tokens(aux, par) / par.tokens

        llama._router_aux = rank_products
        return lambda: setattr(llama, '_router_aux', real)
    # The routing weights are [..., k], the tokens [..., d_model].
    skipped = {'routing weights unreduced': cfg.experts_per_token,
               'expert input unreduced': cfg.d_model}[fault]
    assert cfg.experts_per_token != cfg.d_model
    real = llama.copy_to_experts
    llama.copy_to_experts = lambda x, par: (
        x if x.shape[-1] == skipped else real(x, par))
    return lambda: setattr(llama, 'copy_to_experts', real)


def attention_checks(rank, world, spec, q, k, v, seg, runs=()):
    """The per-shard flash attention on mesh ``spec``: this rank's rows
    of q/k/v (batch over data x fsdp) and heads (over tensor) through
    ``multi_head_attention(impl='pallas')`` (the kernels' plain versions
    on the CPU), without and with its rows of ``seg``, and the gradients
    of sum(out^2) with respect to its blocks; then ``runs`` as
    ``mesh_checks`` runs them."""
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.ops.attention import multi_head_attention
    from skypilot_tpu_torch.parallel.sharding import tensor_parallel_of
    mesh = _mesh(spec)
    par = tensor_parallel_of(mesh)
    nb, bi = par.batch_degree, par.batch_index
    b, h, kvh = q.shape[0] // nb, q.shape[2] // par.degree, \
        k.shape[2] // par.degree

    def local(x, heads):
        x = torch.from_numpy(x)[bi * b:(bi + 1) * b]
        return x[:, :, par.rank * heads:(par.rank + 1) * heads].clone()

    ql, kl, vl = local(q, h), local(k, kvh), local(v, kvh)
    segl = torch.from_numpy(seg)[bi * b:(bi + 1) * b]
    fa.reset_launch_counts()
    out = {'rank': rank, 'rows': (bi * b, (bi + 1) * b),
           'heads': (par.rank * h, (par.rank + 1) * h),
           'kv_heads': (par.rank * kvh, (par.rank + 1) * kvh)}
    out['plain'] = multi_head_attention(ql, kl, vl, causal=True,
                                        impl='pallas').numpy()
    out['segments'] = multi_head_attention(ql, kl, vl, causal=True,
                                           segment_ids=segl,
                                           impl='pallas').numpy()
    grads = [x.clone().requires_grad_(True) for x in (ql, kl, vl)]
    loss = (multi_head_attention(*grads, causal=True,
                                 impl='pallas').float() ** 2).sum()
    loss.backward()
    out['grads'] = [g.grad.numpy() for g in grads]
    out['fallbacks'] = fa.FALLBACKS['cpu']
    out['runs'] = {run['name']: _train_run(run, mesh, par, rank)
                   for run in runs}
    return out


def _loss_shares(par, logits, targets, weights):
    """This rank's rows of a batch (and, under tensor, its block of the
    vocab) through ``cross_entropy_loss`` on the mesh: its share of the
    mean, the whole batch's weight sum, and the mean of its rows
    alone."""
    from skypilot_tpu_torch.train import loss as tloss
    from skypilot_tpu_torch.train.step import _batch_rows
    rows = _batch_rows({'logits': torch.from_numpy(logits),
                        'targets': torch.from_numpy(targets),
                        'weights': torch.from_numpy(weights)}, par)
    width = logits.shape[-1] // par.degree
    block = rows['logits'][..., par.rank * width:(par.rank + 1) * width]
    share, total = tloss.cross_entropy_loss(
        block, rows['targets'], rows['weights'], z_loss_coeff=1e-4,
        parallel=par)
    own, _ = tloss.cross_entropy_loss(rows['logits'], rows['targets'],
                                      rows['weights'], z_loss_coeff=1e-4)
    return {'share': float(share), 'total': float(total),
            'own_mean': float(own)}


def run_main(rank, world, module, argv):
    """``module.main(argv)`` in this rank, its stdout captured: (rc, the
    JSON lines it printed)."""
    import importlib
    main = importlib.import_module(module).main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return {'rc': rc, 'lines': [json.loads(x) for x in
                                buf.getvalue().splitlines()
                                if x.startswith('{')]}


def checkpoint_cycle(rank, world, spec, directory, restore, model='tiny'):
    """``model`` (AdamW) at mesh ``spec`` (None: one process, no mesh) on
    the synthetic batch of step 0 (B=8, S=64). Without ``restore``: two
    steps from the seed-0 init, a checkpoint of step 2 (whole tensors,
    rank 0 writes), then a third step; with it: the latest step of
    ``directory`` restored into a seed-1 state, then one step. Returns
    the losses, the step count after and (rank 0) the whole params as
    saved or as restored."""
    from skypilot_tpu_torch.parallel.sharding import (gather_params_pytree,
                                                      tensor_parallel_of)
    from skypilot_tpu_torch.train import checkpoint as ckpt_lib
    from skypilot_tpu_torch.train import step as tstep
    from skypilot_tpu_torch.train.pretrain import synthetic_batch
    del world
    mesh = _mesh(spec)
    cfg = tiny_config(model)
    hp = tstep.TrainHParams(warmup_steps=2, total_steps=10)
    shardings = None if mesh is None else tstep.state_shardings(mesh, cfg,
                                                                hp)
    state = tstep.create_train_state(1 if restore else 0, cfg, hp, mesh,
                                     device='cpu')
    step = tstep.make_train_step(cfg, hp, mesh)
    batch = synthetic_batch(0, 8, 64, cfg.vocab_size)
    losses = []
    if restore:
        state = ckpt_lib.restore(directory, ckpt_lib.latest_step(directory),
                                 state, shardings=shardings)
    else:
        for _ in range(2):
            state, metrics = step(state, batch)
            losses.append(float(metrics['loss']))
        ckpt_lib.save(directory, state.step, state, shardings=shardings)
    whole = state.params if mesh is None else gather_params_pytree(
        shardings.params, state.params, tensor_parallel_of(mesh))
    whole = _numpy(whole) if rank == 0 else None
    state, metrics = step(state, batch)
    losses.append(float(metrics['loss']))
    return {'rank': rank, 'losses': losses, 'step': state.step,
            'params': whole}


def finetune_run(rank, world, argv):
    """``train.finetune.run`` of ``argv`` in this rank at fp32 compute
    (rank 0 prints): the losses."""
    from skypilot_tpu_torch.train import finetune
    del world
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = finetune.run(finetune.parse_args(argv),
                           compute_dtype=torch.float32)
    return {'rank': rank, 'losses': out['losses'],
            'lines': buf.getvalue().splitlines()}


def cuda_moe_steps(rank, world, spec, steps=2):
    """TINY_MOE (head dim 128, fp32 compute, full remat, aux weight 1) on
    the card at mesh ``spec`` (None: this process alone): ``steps``
    train steps from the seed-0 init on the synthetic batches (B=4,
    S=128), each step's metrics, and the flash launches and fallbacks
    of the steps."""
    return cuda_steps(rank, world, spec, 'tiny-moe', steps,
                      router_aux_loss_coeff=1.0)


def cuda_stage_steps(rank, world, spec, steps=2, device='cuda'):
    """``cuda_moe_steps`` of TINY (2 layers)."""
    return cuda_steps(rank, world, spec, 'tiny', steps, device=device)


def cuda_steps(rank, world, spec, model, steps, device='cuda',
               **overrides):
    """``model`` (head dim 128, fp32 compute, full remat, ``overrides``)
    on the card (or ``device``) at mesh ``spec`` (None: this process
    alone): ``steps`` train steps from the seed-0 init (drawn on the CPU,
    so that every device starts from the same numbers) on the synthetic
    batches (B=4, S=128), each step's metrics, the flash launches and
    fallbacks of the steps, and the rank's mesh coordinates."""
    from skypilot_tpu_torch import _build
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.parallel.mesh import (MeshConfig, build_mesh,
                                                  parse_mesh_spec)
    from skypilot_tpu_torch.train import step as tstep
    from skypilot_tpu_torch.train.pretrain import synthetic_batch
    del world
    if device == 'cuda':
        _build.build_all()
    mesh = None if spec is None else build_mesh(
        MeshConfig(**{'fsdp': 1, **parse_mesh_spec(spec)}),
        device_type=device)
    cfg = tiny_config(model, head_dim=128, remat_policy='full', **overrides)
    hp = tstep.TrainHParams(warmup_steps=1, total_steps=10)
    params = _to(llama.init_params(0, cfg, device='cpu'), device)
    state = tstep.create_train_state_from_params(params, cfg, hp, mesh)
    del params
    step = tstep.make_train_step(cfg, hp, mesh)
    fa.reset_launch_counts()
    metrics = []
    for i in range(steps):
        state, m = step(state, synthetic_batch(i, 4, 128, cfg.vocab_size,
                                               torch.device(device)))
        metrics.append({k: float(m[k]) for k in METRICS})
    return {'rank': rank, 'metrics': metrics,
            'launches': dict(fa.LAUNCHES), 'fallbacks': fa.FALLBACKS[device],
            'n_layers': cfg.n_layers,
            'coords': None if mesh is None else mesh.coords(rank)}


def stage_handoffs(rank, world, deadlock):
    """Two ranks at ``stage=2``: microbatches 0-2 handed forward and
    their gradients back as ``parallel/pipeline.py`` does, with the
    tags out of order on the sending side (each receive must take its
    own tag's tensor); hops past either end raise. With ``deadlock``
    both ranks wait for a tag that is never sent."""
    from skypilot_tpu_torch.parallel.sharding import tensor_parallel_of
    del world
    par = tensor_parallel_of(_mesh('stage=2'))
    shape, dev = (2, 3), torch.device('cpu')
    if deadlock:
        par.recv_from(shape, torch.float32, dev, 1 - 2 * rank, 99)
    errors = []
    for hop in (-1, 2) if rank == 0 else (1, -2):
        try:
            par.send_to(torch.zeros(shape), hop, 0)
        except ValueError as err:
            errors.append(str(err))
    got = []
    if rank == 0:
        waits = [par.send_to(torch.full(shape, float(m)), 1, m)
                 for m in (2, 0, 1)]
        got = [float(par.recv_from(shape, torch.float32, dev, 1, m)[0, 0])
               for m in (2, 1, 0)]
    else:
        got = [float(par.recv_from(shape, torch.float32, dev, -1, m)[0, 0])
               for m in (0, 1, 2)]
        waits = [par.send_to(torch.full(shape, 10.0 + m), -1, m)
                 for m in (1, 2, 0)]
    for wait in waits:
        wait()
    return {'rank': rank, 'stage_rank': par.stage_rank, 'got': got,
            'errors': errors}
