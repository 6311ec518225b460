"""Rank-side halves of the sequence-parallel tests.

``skypilot_tpu_torch.parallel.launch.launch`` runs these functions in
spawned ranks (``gloo`` on the CPU). A rank imports this module and,
through it, only torch, the port and ``torch_train_ranks``: never a test
module, which imports jax. Every function returns plain Python and numpy
values.
"""
import numpy as np
import torch

import torch_train_ranks as train_ranks


def _block(x, par):
    """This rank's rows (data x fsdp) and block of columns (seq) of a
    global [B, S, ...] numpy array, as a tensor."""
    from skypilot_tpu_torch.ops.ring_attention import seq_shard
    n, i = par.batch_degree, par.batch_index
    rows = torch.from_numpy(np.ascontiguousarray(x))
    rows = rows[i * (x.shape[0] // n):(i + 1) * (x.shape[0] // n)]
    return seq_shard(rows, par).contiguous()


def attention_checks(rank, world, spec, cases, planted=None):
    """Each case of ``cases`` through ``multi_head_attention`` on this
    rank's blocks of mesh ``spec``: its output block and, with
    ``grad``, the gradients of sum(out^2) with respect to its q, k and v
    blocks; its place on the mesh; the flash counters of the run. A
    case is (name, impl, causal, q, k, v, segment ids or None, grad).
    Then ``collective_checks`` and, with ``planted`` (q, k, v), the
    causal ring under a hop that does not rotate (``planted_ring``)."""
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.ops.attention import multi_head_attention
    from skypilot_tpu_torch.parallel.sharding import tensor_parallel_of
    del world
    par = tensor_parallel_of(train_ranks._mesh(spec))
    out = {'rank': rank, 'rows': par.batch_index, 'seq_rank': par.seq_rank,
           'cases': {}}
    fa.reset_launch_counts()
    for name, impl, causal, q, k, v, seg, grad in cases:
        blocks = [_block(x, par).requires_grad_(grad) for x in (q, k, v)]
        seg_block = None if seg is None else _block(seg, par)
        got = multi_head_attention(*blocks, causal=causal,
                                   segment_ids=seg_block, impl=impl,
                                   parallel=par)
        result = {'out': got.detach().numpy()}
        if grad:
            (got.float() ** 2).sum().backward()
            result['grads'] = [x.grad.numpy() for x in blocks]
        out['cases'][name] = result
    out['fallbacks'] = dict(fa.FALLBACKS)
    out['collectives'] = collective_checks(par)
    if planted is not None:
        out['planted'] = planted_ring(par, *planted)
    return out


def planted_ring(par, q, k, v):
    """Causal ring attention on this rank's blocks with a ring hop that
    does not rotate (each rank keeps its own K/V block; the hop is
    replaced for good in this rank): the output block."""
    from skypilot_tpu_torch.ops.attention import multi_head_attention
    from skypilot_tpu_torch.parallel.sharding import TensorParallel
    TensorParallel.ring_shift = lambda self, xs, axis='seq': list(xs)
    blocks = [_block(x, par) for x in (q, k, v)]
    return multi_head_attention(*blocks, causal=True, impl='ring',
                                parallel=par).numpy()


def collective_checks(par):
    """``ring_shift``, ``all_to_all`` over ``seq``, ``token_sum`` and a
    sum over ``replicas`` on this rank's tensors (fp32 and int32; rank
    r's hold 100 r + arange): what each returns."""
    import torch.distributed as dist
    rank = dist.get_rank()
    x = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4) + 100 * rank
    ids = torch.arange(6, dtype=torch.int32).reshape(2, 3) + 100 * rank
    shifted = par.ring_shift([x, ids])
    return {'shifted': [t.numpy() for t in shifted],
            'a2a': par.all_to_all(x, 2, 1).numpy(),
            'token_sum': float(par.token_sum(torch.ones(()) * (rank + 1))),
            'replicas_sum': float(par.all_reduce(
                torch.ones(()) * (rank + 1), axis='replicas'))}


def seq_train_checks(rank, world, spec, runs, main_runs=(),
                     finetunes=()):
    """``torch_train_ranks.mesh_checks`` of ``runs`` on mesh ``spec``,
    then each (module, argv) of ``main_runs`` through its ``main`` in
    this rank (``torch_train_ranks.run_main``) and each argv of
    ``finetunes`` through ``torch_train_ranks.finetune_run``."""
    out = train_ranks.mesh_checks(rank, world, spec, runs)
    out['mains'] = [train_ranks.run_main(rank, world, module, argv)
                    for module, argv in main_runs]
    out['finetunes'] = [train_ranks.finetune_run(rank, world, argv)
                        for argv in finetunes]
    return out


def cuda_ring_checks(rank, world):
    """On the card, two ranks at seq=2 over gloo: ``ring_shift`` of
    fp32, bf16 and int32 CUDA tensors and ``all_to_all`` of a bf16 one
    against the blocks expected; then causal ring attention (bf16, the
    kernels) on this rank's block of B=2 S=1024 H=8 KVH=2 D=128 against
    the whole-sequence flash kernels: the largest tile error of the
    output and of the gradients of sum(out * do), and the flash launches
    against the ring's block count (rank r visits r + 1 blocks); then a
    block off the kernels' grid: the error it raises."""
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.ops.attention import multi_head_attention
    from skypilot_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from skypilot_tpu_torch.parallel.sharding import tensor_parallel_of
    del world
    dev = torch.device('cuda', torch.cuda.current_device())
    par = tensor_parallel_of(build_mesh(MeshConfig(fsdp=1, seq=2),
                                        device_type='cuda'))
    xs = [(torch.arange(4096, device=dev) + 10000 * r).to(dt)
          for r in range(2) for dt in (torch.float32, torch.bfloat16,
                                       torch.int32)]
    mine, other = xs[3 * rank:3 * rank + 3], xs[3 * (1 - rank):
                                               3 * (1 - rank) + 3]
    shifted = par.ring_shift(mine)
    exact = all(y.is_cuda and torch.equal(y, x)
                for y, x in zip(shifted, other))
    blocks = [x[1].reshape(2, 4, 512) for x in (xs[0:3], xs[3:6])]
    a2a = par.all_to_all(blocks[rank], 2, 1)
    exact = exact and torch.equal(
        a2a, torch.cat([b[:, :, rank * 256:(rank + 1) * 256]
                        for b in blocks], dim=1))
    gen = torch.Generator().manual_seed(5)
    b, s, h, kvh, d = 2, 1024, 8, 2, 128
    q, do = (torch.randn(b, s, h, d, generator=gen) for _ in range(2))
    k, v = (torch.randn(b, s, kvh, d, generator=gen) for _ in range(2))
    q, k, v, do = (x.to(dev, torch.bfloat16) for x in (q, k, v, do))
    whole = [x.clone().requires_grad_(True) for x in (q, k, v)]
    ref = fa.flash_attention(*whole, causal=True)
    ref.backward(do)
    cols = slice(rank * s // 2, (rank + 1) * s // 2)
    mine = [x[:, cols].clone().requires_grad_(True) for x in (q, k, v)]
    fa.reset_launch_counts()
    out = multi_head_attention(*mine, causal=True, impl='auto',
                               parallel=par)
    out.backward(do[:, cols].contiguous())
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    fallbacks = fa.FALLBACKS['cuda']

    def tile_err(got, want):
        want = want.float()
        shape = (got.shape[0], got.shape[1] // 64, 64) + got.shape[2:]
        diff = (got.float() - want).abs().reshape(shape).amax((2, 4))
        scale = want.abs().reshape(shape).amax((2, 4)).clamp_min(1e-30)
        return (diff / scale).max().item()

    errors = {'out': tile_err(out.detach(), ref.detach()[:, cols])}
    for name, x, w in zip(('dq', 'dk', 'dv'), mine, whole):
        errors[name] = tile_err(x.grad, w.grad[:, cols])
    expected = {k: 0 for k in launches}
    expected.update({'flash_fwd': rank + 1, 'flash_dq': rank + 1,
                     'flash_dkv': rank + 1})
    # A block of 32 columns is off the kernels' 64-row grid: the first
    # block's kernel call raises (before any hop), nothing runs plain.
    try:
        multi_head_attention(*(x[:, :32] for x in mine), causal=True,
                             impl='auto', parallel=par)
        off_grid = 'ran'
    except ValueError as e:
        off_grid = str(e)
    return {'rank': rank, 'collectives_exact': bool(exact),
            'errors': errors, 'launches': launches,
            'expected_launches': expected, 'fallbacks': fallbacks,
            'off_grid': off_grid,
            'off_grid_fallbacks': fa.FALLBACKS['cuda'] - fallbacks}
