"""Rank-side halves of the tensor-parallel tests.

``skypilot_tpu_torch.parallel.launch.launch`` runs these functions in
spawned ranks (``gloo`` on the CPU, two ranks). A rank imports this
module and, through it, only torch and the port: never a test module,
which imports jax. Every function returns plain Python and numpy
values.
"""
import os
import sys

import pytest
import torch

PROMPTS = [[5, 6, 7, 8], [9, 10, 9, 10, 9, 10, 9, 10, 9]]
N_NEW = 6

# name -> (engine, engine options): both engines plain, W8A8 and int8
# pools, all three quantization axes at once, and speculative windows.
ENGINE_CASES = {
    'batch': ('batch', {}),
    'batch_w8a8': ('batch', {'quantize': True}),
    'batch_int8kv': ('batch', {'quantize_kv': True}),
    'batch_all_quant': ('batch', {'quantize': True, 'quantize_kv': True}),
    'continuous': ('continuous', {}),
    'continuous_w8a8': ('continuous', {'quantize': True}),
    'continuous_int8kv': ('continuous', {'quantize_kv': True}),
    'continuous_spec': ('continuous', {'spec_decode': True, 'draft_k': 3}),
}

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'skypilot_tpu')


@pytest.fixture(autouse=True, scope='module')
def one_thread_ranks():
    """The ranks a test module spawns inherit its environment: one CPU
    thread each (torch reads ``OMP_NUM_THREADS`` when it loads), as the
    test process itself runs under ``few_torch_threads``."""
    before = os.environ.get('OMP_NUM_THREADS')
    os.environ['OMP_NUM_THREADS'] = '1'
    try:
        yield
    finally:
        if before is None:
            os.environ.pop('OMP_NUM_THREADS', None)
        else:
            os.environ['OMP_NUM_THREADS'] = before


def tiny_config(**overrides):
    from skypilot_tpu_torch.models.config import get_model_config
    return get_model_config('tiny', n_heads=4, n_kv_heads=2,
                            compute_dtype=torch.float32, **overrides)


class _Counter:
    """Wraps a module function, counting calls and the head counts of
    their query argument (this rank's shard)."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.real = getattr(module, name)
        self.calls = 0
        self.heads = set()
        setattr(module, name, self)

    def __call__(self, q, *args, **kwargs):
        self.calls += 1
        self.heads.add(int(q.shape[2]))
        return self.real(q, *args, **kwargs)

    def restore(self):
        setattr(self.module, self.name, self.real)
        return {'calls': self.calls, 'heads': sorted(self.heads)}


def _build(kind, cfg, params, options):
    from skypilot_tpu_torch.inference.continuous import (
        ContinuousBatchingEngine)
    from skypilot_tpu_torch.inference.engine import InferenceEngine
    if kind == 'batch':
        return InferenceEngine(cfg=cfg, params=params, device='cpu',
                               mesh='tensor=2', max_batch=2, **options)
    return ContinuousBatchingEngine(cfg=cfg, params=params, device='cpu',
                                    mesh='tensor=2', max_slots=2,
                                    max_len=64, block_size=8,
                                    prefill_chunk=8, **options)


def serve_cases(rank, world, params_np, cases, block_jax=False):
    """Each case's engine on every rank under ``mesh='tensor=2'``. The
    driver generates ``PROMPTS`` (the continuous engine one at a time)
    and pins the refresh refusal; every rank reports its attention
    dispatch counts and head shapes and its ``wq`` shard."""
    if block_jax:
        for name in FORBIDDEN:
            sys.modules[name] = None
    from skypilot_tpu_torch.models import convert
    from skypilot_tpu_torch.models import decode as decode_lib
    out = {'rank': rank, 'world': world, 'cases': {}}
    for name in cases:
        kind, options = ENGINE_CASES[name]
        cfg = tiny_config()
        params = convert.params_from_numpy(params_np, cfg, device='cpu')
        counters = [_Counter(decode_lib, 'decode_attention'),
                    _Counter(decode_lib, 'paged_attention')]
        engine = _build(kind, cfg, params, options)
        case = {}
        if engine.is_driver:
            if kind == 'batch':
                case['tokens'] = engine.generate_ids(PROMPTS,
                                                     max_new_tokens=N_NEW)
                stats = engine.stats
            else:
                case['tokens'] = [engine.generate_ids(p,
                                                      max_new_tokens=N_NEW)
                                  for p in PROMPTS]
                stats = engine.stats()
                try:
                    engine.request_refresh(params=params)
                except NotImplementedError as e:
                    case['refresh_refused'] = str(e)
            case['mesh'] = {k: v for k, v in stats.items()
                            if k.startswith('mesh')}
            engine.shutdown()
        else:
            engine.follow()
        if kind == 'continuous':
            case['pool_kv_heads'] = int(engine.cache.k.shape[3])
        wq = engine.params['layers']['attn']['wq']
        case['wq'] = [str(getattr(wq, 'q', wq).dtype),
                      list(getattr(wq, 'q', wq).shape)]
        case['decode_attention'] = counters[0].restore()
        case['paged_attention'] = counters[1].restore()
        out['cases'][name] = case
    out['jax_loaded'] = any(sys.modules.get(n) is not None
                            for n in FORBIDDEN)
    return out


def prefill_shards(rank, world, params_np, tokens, lengths):
    """``decode.prefill`` of this rank's shard under the mesh context, at
    a shape the flash kernels take (head_dim 128, S=128): the gathered
    logits and the flash dispatch count on this rank."""
    from skypilot_tpu_torch.inference import sharding
    from skypilot_tpu_torch.models import convert
    from skypilot_tpu_torch.models import decode as decode_lib
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.parallel.sharding import (mesh_context,
                                                      tensor_parallel_of)
    cfg = tiny_config(attention_impl='pallas', max_seq_len=256,
                      head_dim=128)
    params = convert.params_from_numpy(params_np, cfg, device='cpu')
    mesh = sharding.build_inference_mesh('tensor=2', device_type='cpu')
    shard = sharding.shard_inference_params(params, mesh, cfg)
    counter = _Counter(fa, 'flash_attention')
    with torch.no_grad(), mesh_context(tensor_parallel_of(mesh)):
        logits, cache = decode_lib.prefill(shard, torch.as_tensor(tokens),
                                           torch.as_tensor(lengths), cfg,
                                           160)
    # A whole paged pool (both kv heads, distinct values) and this rank's
    # shard_paged_cache of it.
    pool = decode_lib.init_paged_cache(tiny_config(), 4, 8, 2, 2,
                                       device='cpu')
    pool.k.copy_(torch.arange(pool.k.numel(), dtype=pool.k.dtype)
                 .reshape(pool.k.shape))
    pool_shard = sharding.shard_paged_cache(pool, mesh, tiny_config())
    return {'logits': logits.numpy(), 'flash': counter.restore(),
            'cache_heads': int(cache.k.shape[3]),
            'pool': pool.k.numpy(), 'pool_shard': pool_shard.k.numpy()}


def fail(rank, world, bad_rank, how):
    """``bad_rank`` raises (``how='raise'``) or dies (``'exit'``) while
    the other ranks wait in a collective."""
    import torch.distributed as dist
    if rank == bad_rank:
        if how == 'exit':
            os._exit(3)
        raise ValueError('planted failure on this rank')
    dist.barrier()
    return rank


def traced_request(rank, world, trace_id, span_id):
    """One traced request on the continuous engine under the mesh
    (tracing armed by the launcher's environment); every rank returns
    its pid, so the test can tell whose spans reached the store."""
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.utils import tracing
    cfg = tiny_config()
    params = llama.init_params(0, cfg, device='cpu')
    engine = _build('continuous', cfg, params, {})
    if engine.is_driver:
        ctx = tracing.SpanContext(trace_id, span_id)
        engine.generate_ids(PROMPTS[1], max_new_tokens=3, trace_ctx=ctx)
        engine.shutdown()
    else:
        engine.follow()
    return {'pid': os.getpid()}


# name -> (engine, engine options, config overrides): TINY_MOE under
# dense and capacity dispatch (capacity 0.5, so prefill chunks and
# decode windows drop assignments) on both engines, W8A8 with an int8
# pool, and speculative windows under capacity dispatch.
CAPACITY = {'moe_dispatch': 'capacity', 'capacity_factor': 0.5}
MOE_CASES = {
    'batch_dense': ('batch', {}, {}),
    'batch_capacity': ('batch', {}, CAPACITY),
    'continuous_dense': ('continuous', {}, {}),
    'continuous_capacity': ('continuous', {}, CAPACITY),
    'continuous_quant': ('continuous', {'quantize': True,
                                        'quantize_kv': True}, {}),
    'continuous_spec': ('continuous', {'spec_decode': True, 'draft_k': 3},
                        CAPACITY),
}


def moe_config(name='tiny-moe', **overrides):
    from skypilot_tpu_torch.models.config import get_model_config
    return get_model_config(name, compute_dtype=torch.float32, **overrides)


class _Routes:
    """Wraps ``llama._route``, keeping every call's ``selected`` (the
    experts each token goes to, layer after layer, step after step)."""

    def __init__(self):
        from skypilot_tpu_torch.models import llama
        self.llama, self.real, self.selected = llama, llama._route, []
        llama._route = self

    def __call__(self, *args, **kwargs):
        out = self.real(*args, **kwargs)
        self.selected.append(out[2].numpy().copy())
        return out

    def restore(self):
        self.llama._route = self.real
        return self.selected


def _decode_step_collectives(engine):
    """The collectives, by kind, of one ``decode.decode_step`` at batch
    2 on the engine's shards (after a prefill of two tokens)."""
    from skypilot_tpu_torch.models import decode as decode_lib
    from skypilot_tpu_torch.parallel import sharding as psharding
    tokens = torch.tensor([[5, 6], [7, 8]], dtype=torch.int32)
    with torch.no_grad(), psharding.mesh_context(engine._tp):  # pylint: disable=protected-access
        _, cache = decode_lib.prefill(engine.params, tokens,
                                      torch.tensor([2, 2]), engine.cfg, 8)
        psharding.collective_stats(reset=True)
        decode_lib.decode_step(engine.params, tokens[:, 0], cache,
                               engine.cfg)
        return psharding.collective_stats()['by_kind']


def serve_moe_cases(rank, world, params_np, cases):
    """Each case's engine on TINY_MOE (fp32 compute) on every rank under
    ``mesh='tensor=2'``, on the JAX engine's weights: the driver's
    greedy tokens, every rank's ``selected`` of every router call, the
    paged dispatch count and its expert shards. Then one decode step's
    collectives on a dense TINY and on TINY_MOE, both of 2 layers and
    built from the seed (``init_shard``)."""
    from skypilot_tpu_torch.models import convert
    from skypilot_tpu_torch.models import decode as decode_lib
    out = {'rank': rank, 'cases': {}, 'collectives': {}}
    for name in cases:
        kind, options, overrides = MOE_CASES[name]
        cfg = moe_config(**overrides)
        params = convert.params_from_numpy(params_np, cfg, device='cpu')
        routes = _Routes()
        paged = _Counter(decode_lib, 'paged_attention')
        engine = _build(kind, cfg, params, options)
        case = {}
        if engine.is_driver:
            if kind == 'batch':
                case['tokens'] = engine.generate_ids(PROMPTS,
                                                     max_new_tokens=N_NEW)
            else:
                case['tokens'] = [engine.generate_ids(p,
                                                      max_new_tokens=N_NEW)
                                  for p in PROMPTS]
            engine.shutdown()
        else:
            engine.follow()
        case['selected'] = routes.restore()
        case['paged_attention'] = paged.restore()
        case['experts'] = {k: v.numpy() for k, v in
                           engine.params['layers']['moe'].items()}
        out['cases'][name] = case
    for model in ('tiny', 'tiny-moe'):
        engine = _build('batch', moe_config(model), None, {})
        out['collectives'][model] = _decode_step_collectives(engine)
        if engine.is_driver:
            engine.shutdown()
        else:
            engine.follow()
    return out
