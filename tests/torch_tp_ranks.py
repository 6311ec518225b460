"""Rank-side halves of the tensor-parallel tests.

``skypilot_tpu_torch.parallel.launch.launch`` runs these functions in
spawned ranks (``gloo`` on the CPU, two ranks). A rank imports this
module and, through it, only torch and the port: never a test module,
which imports jax. Every function returns plain Python and numpy
values.
"""
import os
import sys
import time

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
    driver generates ``PROMPTS`` (the continuous engine one at a time),
    and on the continuous engine refreshes the weights with the same
    tree and generates the first prompt again; every rank reports its
    attention dispatch counts and head shapes and its ``wq`` shard."""
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
                if name == 'continuous':
                    case['refresh_version'] = engine.refresh_weights(
                        params=params)
                    case['refreshed_tokens'] = engine.generate_ids(
                        PROMPTS[0], max_new_tokens=N_NEW)
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


# -- disaggregated roles under the mesh --------------------------------------

# Block size 8 (``_build``): A is 2 full blocks and a tail, B shares A's
# first 2 blocks and adds a full block and a tail, C is one full block
# and no tail, D a tail alone; E is the tampered one.
_A = [5, 9, 42, 7, 11, 3, 2, 8, 19, 21, 4, 6, 13, 17, 23, 29, 31, 1, 44]
DISAGG_PROMPTS = {
    'A': _A,
    'B': _A[:16] + [50, 51, 52, 53, 54, 55, 56, 57, 58],
    'C': [70, 71, 72, 73, 74, 75, 76, 77],
    'D': [90, 91, 92, 93, 94],
}
TAMPERED_PROMPT = [100 + i for i in range(12)]
DISAGG_POOLS = {'fp': {}, 'int8': {'quantize_kv': True}}
EXPORT_FIELDS = ('request_id', 'ids', 'block_size', 'digests', 'blocks',
                 'tail', 'meta')


def export_fields(export):
    """A ``KvExport`` of either package as a plain dict (what crosses a
    process boundary; ``kv_migrate.KvExport(**fields)`` rebuilds it)."""
    return {name: getattr(export, name) for name in EXPORT_FIELDS}


def raw(x):
    """``x``'s bytes (any dtype, any device) as a host uint8 array with
    one trailing axis of its item size: bitwise comparable, its other
    axes (the kv-head axis too) kept."""
    return x.detach().unsqueeze(-1).contiguous().view(torch.uint8).cpu() \
        .numpy()


class BlockRecorder:
    """While installed, this rank's part of every block read and write
    of the continuous engine under the mesh, block-major as ``raw``
    bytes: a read's local kv heads of the blocks (before the gather), a
    write's local kv heads as the pool holds them after it."""

    def __init__(self):
        from skypilot_tpu_torch.inference.continuous import (
            ContinuousBatchingEngine as engine)
        self.engine, self.reads, self.writes = engine, [], []
        self.real = engine._block_slices, engine._scatter_blocks
        real_read, real_write = self.real
        recorder = self

        def local(self, idx):
            return {name: raw(pool.index_select(1, idx).transpose(0, 1))
                    for name, pool in self._pool_fields().items()}

        def read(self, idx):
            recorder.reads.append(local(self, idx))
            return real_read(self, idx)

        def write(self, idx, stacked):
            real_write(self, idx, stacked)
            recorder.writes.append(local(self, idx))

        engine._block_slices, engine._scatter_blocks = read, write

    def restore(self):
        self.engine._block_slices, self.engine._scatter_blocks = self.real
        return {'reads': self.reads, 'writes': self.writes}


def export_blocks(fields, first=0):
    """An export's whole-head blocks from full block ``first`` on, then
    its partial tail block if any, as ``raw`` bytes (name -> [n, L,
    block_size, kv_heads, ..., item size]): what a read returned, or an
    import that found ``first`` blocks resident wrote."""
    from skypilot_tpu_torch.inference import kv_migrate
    import numpy as np
    blocks = [kv_migrate.unpack_arrays(b) for b in fields['blocks'][first:]]
    tail = kv_migrate.unpack_arrays(fields['tail'])
    part = {k[len('tail_'):]: v for k, v in tail.items()
            if k.startswith('tail_')}
    blocks += [part] if part else []
    return {name: np.stack([raw(b[name]) for b in blocks])
            for name in blocks[0]}


def check_head_order(exports, reads, writes, resident):
    """Rank order, bitwise: ``reads[r][i]`` (rank r's record of export
    i's read) joined over the ranks along the kv-head axis is export i's
    blocks; the last ``len(exports)`` records of ``writes[r]`` (imports
    of ``exports`` in order, finding ``resident[i]`` blocks resident)
    are rank r's kv heads of what they wrote."""
    import numpy as np
    degree = len(reads)
    for i, fields in enumerate(exports):
        whole = export_blocks(fields)
        for name, want in whole.items():
            got = np.concatenate([r[i][name] for r in reads], axis=3)
            np.testing.assert_array_equal(got, want, err_msg=name)
    for i, fields in enumerate(exports):
        whole = export_blocks(fields, resident[i])
        for rank in range(degree):
            got = writes[rank][i - len(exports)]
            for name, want in whole.items():
                n = want.shape[3] // degree
                np.testing.assert_array_equal(
                    got[name], want[:, :, :, rank * n:(rank + 1) * n],
                    err_msg=f'rank {rank} {name}')


def _pull(engine, fields):
    """``fields``' export pulled into ``engine``'s delta (its resident
    prefix not moved)."""
    from skypilot_tpu_torch.inference import kv_migrate
    exporter = kv_migrate.KvExporter()
    exporter.put(kv_migrate.KvExport(**fields))
    puller = kv_migrate.KvPuller(kv_migrate.LocalKvSource(exporter),
                                 sleep=lambda _s: None)
    return puller.pull(fields['request_id'],
                       resident_digests=engine.probe_resident(
                           fields['ids']))


def _free_after_quiesce(engine):
    """Whether every block is free once the idle driver's prefix cache
    drops every entry it alone holds (no refcount leak)."""
    while engine._prefix.evict_reclaimable():  # pylint: disable=protected-access
        pass
    return engine._pool.free_blocks == engine._pool.total_blocks  # pylint: disable=protected-access


def import_all(engine, exports, n_new, tamper=None):
    """Each export imported by the decode-role driver as a lone request
    (in order, so later prompts find the earlier ones' blocks resident):
    greedy tokens, blocks moved and resident, the stats' import
    counters."""
    out = {'tokens': [], 'moved': [], 'resident': []}
    for fields in exports:
        pulled = _pull(engine, fields)
        if tamper is not None:
            tamper(pulled)
        request = engine.submit_migrated(fields['ids'], pulled,
                                         max_new_tokens=n_new)
        out['tokens'].append(list(engine.tail_tokens(request)))
        out['moved'].append(pulled.moved)
        out['resident'].append(pulled.resident)
    stats = engine.stats()
    out.update({k: stats[k] for k in ('kv_imports', 'kv_import_fallbacks',
                                      'prefill_chunks', 'decode_steps',
                                      'verify_steps')})
    out['all_free'] = _free_after_quiesce(engine)
    return out


def short_payload(pulled):
    """Tamper: the first moved block carries one rank's kv heads only (a
    shard where the wire wants every head)."""
    from skypilot_tpu_torch.inference import kv_migrate
    i = next(i for i, p in enumerate(pulled.payloads) if p is not None)
    arrays = kv_migrate.unpack_arrays(pulled.payloads[i])
    pulled.payloads[i] = kv_migrate.pack_arrays(
        {name: a.narrow(1, 0, 1) for name, a in arrays.items()})


def disagg_cases(rank, world, params_np, foreign, n_new):
    """Disaggregated roles on every rank under ``mesh='tensor=2'``, for
    each pool of ``DISAGG_POOLS``: a prefill-role engine exports
    ``DISAGG_PROMPTS`` (the driver returns the exports); a decode-role
    engine imports, one source after another with its prefix cache
    emptied between them, ``foreign[pool]``'s exports (``'jax'``,
    ``'one'``) and its own, then a short payload that must fall back.
    On the fp pool a speculative decode-role engine imports the exports
    too and the decode role takes a live refresh; a decode role with
    adapter pages serves, and ``embed_text``, which still raises under
    a mesh, is tried. Every rank returns what it read and wrote of the
    pool (``BlockRecorder``)."""
    from skypilot_tpu_torch.inference.engine import InferenceEngine
    from skypilot_tpu_torch.models import convert
    cfg = tiny_config()
    params = convert.params_from_numpy(params_np, cfg, device='cpu')
    out = {'rank': rank, 'pools': {}, 'refused': {}, 'served': {}}
    for pool, options in DISAGG_POOLS.items():
        res = {}
        recorder = BlockRecorder()
        try:
            pre = _build('continuous', cfg, params,
                         dict(options, role='prefill'))
            if pre.is_driver:
                res['exports'] = [
                    export_fields(pre.exporter.get(pre.prefill_and_export(p)))
                    for p in DISAGG_PROMPTS.values()]
                res['prefill_stats'] = pre.stats()
                pre.shutdown()
            else:
                pre.follow()
            dec = _build('continuous', cfg, params,
                         dict(options, role='decode'))
            if dec.is_driver:
                for source in ('jax', 'one', 'tp'):
                    exports = (res['exports'] if source == 'tp'
                               else foreign[pool][source])
                    res[source] = import_all(dec, exports, n_new)
                tamper = foreign[pool]['tampered']
                res['tampered'] = import_all(dec, [tamper], n_new,
                                             tamper=short_payload)
                if pool == 'fp':
                    out['served']['refresh'] = dec.refresh_weights(
                        params=params)
                res['mesh'] = {k: v for k, v in dec.stats().items()
                               if k.startswith('mesh') or k == 'role'}
                dec.shutdown()
            else:
                dec.follow()
            if pool == 'fp':
                spec = _build('continuous', cfg, params,
                              dict(role='decode', spec_decode=True,
                                   draft_k=3))
                if spec.is_driver:
                    res['spec'] = import_all(spec, res['exports'], n_new)
                    spec.shutdown()
                else:
                    spec.follow()
        finally:
            res.update(recorder.restore())
        out['pools'][pool] = res
    lora = _build('continuous', cfg, params, dict(role='decode',
                                                  lora_pages=2))
    if lora.is_driver:
        out['served']['lora_pages'] = lora.stats()['lora_pages_total']
        lora.shutdown()
    else:
        lora.follow()
    batch = _build('batch', cfg, params, {})
    if batch.is_driver:
        try:
            batch.embed_text(['hello'])
        except NotImplementedError as e:
            out['refused']['embed_text'] = str(e)
        batch.shutdown()
    else:
        batch.follow()
    return out


# Card test prompts (llama3-8b ids): P1 shares P0's first two blocks.
_P0 = [(37 * i + 11) % 128000 for i in range(40)]
CUDA_DISAGG_PROMPTS = [_P0, _P0[:32] + [(53 * i + 7) % 128000
                                        for i in range(13)],
                       [(29 * i + 3) % 128000 for i in range(21)]]


def cuda_disagg_case(rank, world, quantize_kv, n_new):
    """llama3-8b's heads at 2 layers (bf16 compute, weights from seed 0)
    at tensor=2 on two ranks of the card: the colocated engine's greedy
    tokens of ``CUDA_DISAGG_PROMPTS`` (lone requests), then the prefill
    role's exports imported one after another by the decode role (lone
    requests), with both ranks' reads and writes (``BlockRecorder``) and
    the decode role's paged launches against its decode steps."""
    from skypilot_tpu_torch.inference.continuous import (
        ContinuousBatchingEngine)
    from skypilot_tpu_torch.models.config import get_model_config
    from skypilot_tpu_torch.ops import paged_attention as pa
    cfg = get_model_config('llama3-8b', n_layers=2)
    kw = dict(cfg=cfg, seed=0, device='cuda', mesh='tensor=2',
              max_slots=2, max_len=256, block_size=16,
              quantize_kv=quantize_kv)
    kernel = 'paged_attention_quant' if quantize_kv else 'paged_attention'
    out = {'rank': rank}
    recorder = BlockRecorder()
    try:
        colo = ContinuousBatchingEngine(**kw)
        if colo.is_driver:
            out['colocated'] = [colo.generate_ids(p, max_new_tokens=n_new)
                                for p in CUDA_DISAGG_PROMPTS]
            colo.shutdown()
        else:
            colo.follow()
        del colo
        pre = ContinuousBatchingEngine(role='prefill', **kw)
        if pre.is_driver:
            out['exports'] = [
                export_fields(pre.exporter.pop(pre.prefill_and_export(p)))
                for p in CUDA_DISAGG_PROMPTS]
            pre.shutdown()
        else:
            pre.follow()
        del pre
        dec = ContinuousBatchingEngine(role='decode', **kw)
        pa.reset_launch_counts()
        if dec.is_driver:
            out.update(import_all(dec, out['exports'], n_new))
            dec.shutdown()
        else:
            dec.follow()
        torch.cuda.synchronize()
        out['launches'] = pa.LAUNCHES[kernel]
    finally:
        out.update(recorder.restore())
    return out


# -- LoRA adapter pages under the mesh ---------------------------------------

# Three adapters for two pages (so one is evicted); block size 8. The
# pool has room for both resident adapters' charge and two requests at
# once on the int8 pool too (a rank-4 adapter charges 7 of its blocks):
# admission counts an idle adapter's charge as taken, as the
# reference's does.
LORA_KW = dict(lora_pages=2, lora_max_rank=4, num_blocks=40)
ADAPTER_RANKS = {'a': 4, 'b': 2, 'c': 4}
LORA_PROMPTS = [[5, 6, 7, 8], [9, 10, 9, 10, 9, 10, 9, 10, 9],
                [3 * i % 97 + 11 for i in range(13)],
                [7 * i % 89 + 2 for i in range(19)]]
# Waves of (adapter or '', prompt index), each submitted together and
# waited for, so every wave shares one batch and the counters do not
# depend on timing: a misses; b and c miss, the second evicts a; c hits;
# a misses and evicts b (c was used later). Then an all-base wave.
LORA_WAVES = [[('a', 0), ('', 1)], [('b', 2), ('c', 3)],
              [('c', 0), ('', 2)], [('a', 1), ('', 3)]]
BASE_WAVE = [('', 0), ('', 1)]
LORA_COUNTERS = ('lora_hits', 'lora_misses', 'lora_evictions',
                 'lora_blocks_charged', 'lora_pages_resident')
# Speculative windows (n-gram drafts of the repetitive prompt 1) and a
# decode role, each against the waves' answers to the same requests.
SPEC_WAVE = [('a', 1), ('b', 2)]
DECODE_ROLE_WAVE = [('c', 3), ('', 1)]


def run_waves(engine, waves, n_new):
    """Each wave's requests (``(adapter, prompt index)``) submitted
    together to either package's continuous engine and waited for: the
    greedy tokens, wave by wave."""
    out = []
    for wave in waves:
        handles = [engine.submit_ids(LORA_PROMPTS[i], max_new_tokens=n_new,
                                     adapter=name or None)
                   for name, i in wave]
        for h in handles:
            assert h.done.wait(300), 'request timed out'
            assert h.error is None, h.error
        out.append([[int(t) for t in h.generated] for h in handles])
    return out


class StepRecorder:
    """While installed, every ``prefill_chunk`` / ``paged_decode_step``
    / ``paged_verify_step`` call of this rank, in order, with whether
    it was given adapter pages."""

    NAMES = ('prefill_chunk', 'paged_decode_step', 'paged_verify_step')

    def __init__(self):
        from skypilot_tpu_torch.models import decode as decode_lib
        self.module, self.calls = decode_lib, []
        self.real = {n: getattr(decode_lib, n) for n in self.NAMES}
        for name, real in self.real.items():
            setattr(decode_lib, name, self._wrap(name, real))

    def _wrap(self, name, real):
        def step(*args, **kwargs):
            self.calls.append((name, kwargs.get('lora_pages') is not None))
            return real(*args, **kwargs)
        return step

    def restore(self):
        for name, real in self.real.items():
            setattr(self.module, name, real)
        return self.calls


def _lora_engine(cfg, params, adapters, options):
    engine = _build('continuous', cfg, params, dict(options, **LORA_KW))
    if engine.is_driver:
        for name, lora in adapters.items():
            engine.register_adapter(name, lora)
    return engine


def lora_cases(rank, world, params_np, adapters_np, n_new):
    """Adapter pages on every rank under ``mesh='tensor=2'``, for each
    pool of ``DISAGG_POOLS``: the driver registers ``adapters_np`` and
    runs ``LORA_WAVES`` (tokens, the ``lora_*`` counters, each adapter's
    page, where the all-base wave's steps begin); on the fp pool then a
    speculative engine runs ``SPEC_WAVE`` and a decode-role engine
    ``DECODE_ROLE_WAVE``. Every rank returns its page store and every
    step call it made (``StepRecorder``)."""
    from skypilot_tpu_torch.models import convert
    cfg = tiny_config()
    params = convert.params_from_numpy(params_np, cfg, device='cpu')
    adapters = {name: convert.lora_from_numpy(a, cfg, device='cpu')
                for name, a in adapters_np.items()}
    out = {'rank': rank, 'pools': {}}
    for pool, options in DISAGG_POOLS.items():
        res = {}
        steps = StepRecorder()
        try:
            engine = _lora_engine(cfg, params, adapters, options)
            if engine.is_driver:
                res['tokens'] = run_waves(engine, LORA_WAVES, n_new)
                stats = engine.stats()
                res['counters'] = {k: stats[k] for k in LORA_COUNTERS}
                res['pages'] = {n: engine._adapter_pool.page_of(n)  # pylint: disable=protected-access
                                for n in adapters}
                res['base_from'] = len(steps.calls)
                res['base_tokens'] = run_waves(engine, [BASE_WAVE],
                                               n_new)[0]
                res['adapter_stats'] = engine.adapter_stats()
                engine.shutdown()
            else:
                engine.follow()
        finally:
            res['steps'] = steps.restore()
        res['store'] = {k: v.numpy() for k, v in
                        engine._lora_store.items()}  # pylint: disable=protected-access
        out['pools'][pool] = res
    for label, options, wave in (
            ('spec', dict(spec_decode=True, draft_k=3), SPEC_WAVE),
            ('decode_role', dict(role='decode'), DECODE_ROLE_WAVE)):
        engine = _lora_engine(cfg, params, adapters, options)
        if engine.is_driver:
            out[label] = {'tokens': run_waves(engine, [wave], n_new)[0],
                          'stats': engine.stats()}
            engine.shutdown()
        else:
            engine.follow()
    return out


# -- live weight refresh under the mesh --------------------------------------

def leaves(params):
    """Every leaf of a port params tree by path, as numpy (a W8A8
    ``QTensor``'s int8 values and scales under ``/q`` and ``/scale``)."""
    from skypilot_tpu_torch.inference.continuous import flatten_param_paths
    from skypilot_tpu_torch.models.quant import QTensor
    out = {}
    for path, leaf in flatten_param_paths(params).items():
        if isinstance(leaf, QTensor):
            out[path + '/q'] = leaf.q.numpy().copy()
            out[path + '/scale'] = leaf.scale.numpy().copy()
        else:
            out[path] = leaf.numpy().copy()
    return out


def _refresh_errors(engine, bad):
    """Each of ``bad``'s update dicts refused by ``request_refresh``:
    the error's type name, and the version after."""
    got = []
    for updates in bad:
        try:
            engine.request_refresh(updates)
            got.append(None)
        except (KeyError, ValueError, TypeError) as e:
            got.append(type(e).__name__)
    return got, engine.policy_version


def refresh_cases(rank, world, params_np, new_np, delta_np, bad_np,
                  drain_np, w8a8_bad_np, moe_np, moe_delta_np, n_new):
    """Live refresh on every rank under ``mesh='tensor=2'``: on TINY,
    ``PROMPTS`` (tokens; a full block of them stays in the prefix cache
    across the refreshes, as the reference keeps it), a whole-tree
    refresh to ``new_np`` (tokens), a delta
    ``delta_np`` (tokens, leaves written, bytes broadcast), the refused
    updates ``bad_np`` (error types, version), then the drain-mode
    delta ``drain_np`` while a request is in flight (that request's
    tokens, whether it had finished when the refresh landed, then the
    tokens after it); on a W8A8 engine the refused ``w8a8_bad_np``; on
    TINY_MOE the delta ``moe_delta_np``. Every rank returns its leaves
    after each engine (and before the W8A8 one's refusals)."""
    from skypilot_tpu_torch.models import convert
    cfg = tiny_config()
    params = convert.params_from_numpy(params_np, cfg, device='cpu')
    out = {'rank': rank}
    engine = _build('continuous', cfg, params, {})
    if engine.is_driver:
        res = {'versions': [], 'before': [
            engine.generate_ids(p, max_new_tokens=n_new) for p in PROMPTS]}
        res['versions'].append(engine.refresh_weights(
            params=convert.params_from_numpy(new_np, cfg, device='cpu')))
        res['whole'] = [engine.generate_ids(p, max_new_tokens=n_new)
                        for p in PROMPTS]
        ticket = engine.request_refresh(delta_np)
        assert ticket.done.wait(120) and ticket.error is None, ticket.error
        res['versions'].append(engine.policy_version)
        res['delta_shards'] = ticket.applied_shards
        res['delta_bytes'] = ticket.nbytes
        res['delta'] = [engine.generate_ids(p, max_new_tokens=n_new)
                        for p in PROMPTS]
        res['errors'], version = _refresh_errors(engine, bad_np)
        res['versions'].append(version)
        flight = engine.submit_ids(PROMPTS[1], max_new_tokens=n_new)
        while not flight.generated:
            time.sleep(0.001)
        ticket = engine.request_refresh(drain_np, mode='drain')
        assert ticket.done.wait(120) and ticket.error is None, ticket.error
        res['drained_first'] = flight.done.is_set()
        res['in_flight'] = list(flight.generated)
        res['versions'].append(engine.policy_version)
        res['after_drain'] = [engine.generate_ids(p, max_new_tokens=n_new)
                              for p in PROMPTS]
        res['stats'] = engine.stats()
        out['tiny'] = res
        engine.shutdown()
    else:
        engine.follow()
    out['tiny_leaves'] = leaves(engine.params)
    del engine
    w8a8 = _build('continuous', cfg, params, {'quantize': True})
    out['w8a8_before'] = leaves(w8a8.params)
    if w8a8.is_driver:
        out['w8a8'] = _refresh_errors(w8a8, [w8a8_bad_np])
        w8a8.shutdown()
    else:
        w8a8.follow()
    out['w8a8_after'] = leaves(w8a8.params)
    del w8a8
    mcfg = moe_config()
    moe = _build('continuous', mcfg,
                 convert.params_from_numpy(moe_np, mcfg, device='cpu'), {})
    if moe.is_driver:
        version = moe.refresh_weights(moe_delta_np)
        out['moe'] = {'version': version,
                      'tokens': [moe.generate_ids(p, max_new_tokens=n_new)
                                 for p in PROMPTS]}
        moe.shutdown()
    else:
        moe.follow()
    out['moe_leaves'] = leaves(moe.params)
    return out


# -- adapter pages and live refresh at tensor=2 on the card -----------------

def cuda_tiny_config():
    """TINY with head_dim 128 (the card's decode kernel takes 64/128/256)
    and fp32 compute, so tensor=2 and one rank give the same tokens."""
    from skypilot_tpu_torch.models.config import get_model_config
    return get_model_config('tiny', head_dim=128,
                            compute_dtype=torch.float32)


def cuda_lora_case(rank, world, adapters, n_new, mesh='tensor=2',
                   device='cuda'):
    """``LORA_WAVES`` on the card (or ``device``) from the seeded init
    (seed 0), under ``mesh`` (None: one rank): tokens, the ``lora_*``
    counters, each adapter's page, every rank's page store and paged
    launches."""
    from skypilot_tpu_torch.inference.continuous import (
        ContinuousBatchingEngine)
    from skypilot_tpu_torch.ops import paged_attention as pa
    engine = ContinuousBatchingEngine(
        cfg=cuda_tiny_config(), seed=0, device=device, mesh=mesh,
        max_slots=2, max_len=64, block_size=8, prefill_chunk=8, **LORA_KW)
    pa.reset_launch_counts()
    out = {'rank': rank}
    if engine.is_driver:
        for name, lora in adapters.items():
            engine.register_adapter(name, lora)
        out['tokens'] = run_waves(engine, LORA_WAVES, n_new)
        stats = engine.stats()
        out['counters'] = {k: stats[k] for k in LORA_COUNTERS}
        out['decode_steps'] = stats['decode_steps']
        out['pages'] = {n: engine._adapter_pool.page_of(n)  # pylint: disable=protected-access
                        for n in adapters}
        engine.shutdown()
    else:
        engine.follow()
    if device == 'cuda':
        torch.cuda.synchronize()
    out['launches'] = pa.LAUNCHES['paged_attention']
    out['store'] = {k: v.cpu().numpy() for k, v in
                    engine._lora_store.items()}  # pylint: disable=protected-access
    return out


def cuda_refresh_case(rank, world, delta, n_new, mesh='tensor=2',
                      device='cuda'):
    """A delta refresh on the card (or ``device``) from the seeded init
    (seed 0), under
    ``mesh`` (None: one rank): ``PROMPTS``' tokens before and after,
    the version, and every rank's leaves after."""
    from skypilot_tpu_torch.inference.continuous import (
        ContinuousBatchingEngine, flatten_param_paths)
    engine = ContinuousBatchingEngine(
        cfg=cuda_tiny_config(), seed=0, device=device, mesh=mesh,
        max_slots=2, max_len=64, block_size=8, prefill_chunk=8,
        prefix_cache=False)
    out = {'rank': rank}
    if engine.is_driver:
        out['before'] = [engine.generate_ids(p, max_new_tokens=n_new)
                         for p in PROMPTS]
        out['version'] = engine.refresh_weights(delta)
        out['after'] = [engine.generate_ids(p, max_new_tokens=n_new)
                        for p in PROMPTS]
        engine.shutdown()
    else:
        engine.follow()
    out['leaves'] = {path: t.cpu().numpy() for path, t in
                     flatten_param_paths(engine.params).items()}
    return out
