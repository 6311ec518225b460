"""Disaggregated prefill/decode under tensor parallelism: the port
against the JAX reference.

The JAX engines run in this process on the 8 virtual CPU devices of
``tests/conftest.py`` (its prefill role at ``mesh='tensor=2'``, its
colocated engine on one device); the port's tensor=2 engines run as two
``gloo`` ranks (``tests/torch_tp_ranks.disagg_cases``), its one-rank
engines in this process. TINY with 4 query and 2 kv heads at fp32
compute, an fp pool and an int8 one (``quantize_kv``).

An export is whole blocks of every kv head whatever the layout, so the
port's tensor=2 export matches the JAX tensor=2 export and the port's
one-rank export in its manifest (chain digests, meta, field names,
dtypes, shapes) exactly, its arrays within 1e-5 and its logits row
within 2e-5 (fp32 sums in another order); the int8 pool's values within
one quantization step (equal to the JAX tensor=2 export's here; a step
apart moves the logits row, held to 1e-3 against one rank). Every import (JAX tensor=2 -> port tensor=2, port
one rank -> port tensor=2, port tensor=2 -> port one rank and -> port
tensor=2) decodes the JAX colocated engine's greedy tokens exactly.
Each rank's part of a transfer is its own kv heads, in rank order,
bitwise. A shared prefix moves only its non-resident blocks; a short
payload falls back to a local re-prefill before any rank writes; a
speculative decode role gives the plain tokens; LoRA pages and a live
refresh run beside a decode role, while ``embed_text`` and axes other
than ``tensor`` still raise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_tp_ranks as ranks
from skypilot_tpu.inference.continuous import (ContinuousBatchingEngine as
                                               JaxContinuous)
from skypilot_tpu.models import llama as jllama
from skypilot_tpu.models.config import get_model_config as jax_config
from skypilot_tpu_torch.inference import kv_migrate, sharding
from skypilot_tpu_torch.inference.continuous import (
    ContinuousBatchingEngine as TorchContinuous)
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.parallel.launch import launch
from torch_threads import few_torch_threads  # noqa: F401 (autouse)
from torch_tp_ranks import one_thread_ranks  # noqa: F401 (autouse)

N_NEW = 6
KW = dict(max_slots=2, max_len=64, block_size=8, prefill_chunk=8)
PROMPTS = list(ranks.DISAGG_PROMPTS.values())
POOLS = list(ranks.DISAGG_POOLS)
# Blocks moved and resident a prompt when A, B, C, D import in order:
# B finds A's first two blocks resident.
MOVED = [2, 1, 1, 0]
RESIDENT = [0, 2, 0, 0]


def _jax_cfg():
    return jax_config('tiny', n_heads=4, n_kv_heads=2,
                      compute_dtype=jnp.float32)


@pytest.fixture(scope='module')
def jax_side():
    """The JAX tensor=2 prefill role's exports and the JAX colocated
    engine's greedy tokens, by pool, with the weights as numpy."""
    params = jax.tree.map(np.asarray, jllama.init_params(jax.random.key(0),
                                                         _jax_cfg()))
    out = {'params': params}
    for pool, options in ranks.DISAGG_POOLS.items():
        pre = JaxContinuous(cfg=_jax_cfg(), seed=0, mesh='tensor=2',
                            role='prefill', **KW, **options)
        colo = JaxContinuous(cfg=_jax_cfg(), seed=0, **KW, **options)
        try:
            out[pool] = {
                'exports': [ranks.export_fields(pre.exporter.get(
                    pre.prefill_and_export(p))) for p in PROMPTS],
                'tokens': [colo.generate_ids(p, max_new_tokens=N_NEW)
                           for p in PROMPTS],
                'tampered': colo.generate_ids(ranks.TAMPERED_PROMPT,
                                              max_new_tokens=N_NEW)}
        finally:
            pre.shutdown()
            colo.shutdown()
    return out


def _one_rank(params, role, options):
    cfg = ranks.tiny_config()
    return TorchContinuous(cfg=cfg, params=convert.params_from_numpy(
        params, cfg, device='cpu'), device='cpu', role=role, **KW,
        **options)


@pytest.fixture(scope='module')
def runs(jax_side):
    """The port's one-rank exports (this process), then every tensor=2
    case in one launch, then the tensor=2 exports imported by a one-rank
    decode role (this process)."""
    foreign, one = {}, {}
    for pool, options in ranks.DISAGG_POOLS.items():
        pre = _one_rank(jax_side['params'], 'prefill', options)
        try:
            one[pool] = [ranks.export_fields(pre.exporter.get(
                pre.prefill_and_export(p))) for p in PROMPTS]
            tampered = ranks.export_fields(pre.exporter.get(
                pre.prefill_and_export(ranks.TAMPERED_PROMPT)))
        finally:
            pre.shutdown()
        foreign[pool] = {'jax': jax_side[pool]['exports'], 'one': one[pool],
                         'tampered': tampered}
    tp = launch(ranks.disagg_cases, 2, jax_side['params'], foreign, N_NEW,
                device='cpu', timeout=300)
    back = {}
    for pool, options in ranks.DISAGG_POOLS.items():
        dec = _one_rank(jax_side['params'], 'decode', options)
        try:
            back[pool] = ranks.import_all(
                dec, tp[0]['pools'][pool]['exports'], N_NEW)
        finally:
            dec.shutdown()
    return {'one': one, 'tp': tp, 'back': back}


def _same_export(got, want, logits_tol=2e-5):
    """Manifest exact; arrays within 1e-5 (int8 values within one
    step), the logits row within ``logits_tol``."""
    for key in ('ids', 'block_size', 'digests', 'meta'):
        assert got[key] == want[key], key
    assert len(got['blocks']) == len(want['blocks'])
    for got_bytes, want_bytes in (list(zip(got['blocks'], want['blocks'])) +
                                  [(got['tail'], want['tail'])]):
        a = kv_migrate.unpack_arrays(got_bytes)
        b = kv_migrate.unpack_arrays(want_bytes)
        assert sorted(a) == sorted(b)
        for name in a:
            assert a[name].dtype == b[name].dtype, name
            assert a[name].shape == b[name].shape, name
            if a[name].dtype == torch.int8:
                # fp32 rows 1e-6 apart may round to either side of a
                # half step: one int8 step at most.
                step = np.abs(a[name].numpy().astype(np.int32) -
                              b[name].numpy().astype(np.int32))
                assert step.max() <= 1, name
            else:
                tol = logits_tol if name == 'logits' else 1e-5
                np.testing.assert_allclose(a[name].numpy(),
                                           b[name].numpy(), rtol=tol,
                                           atol=tol, err_msg=name)


@pytest.mark.parametrize('pool', POOLS)
def test_tp_export_matches_jax_tp_export(runs, jax_side, pool):
    exports = runs['tp'][0]['pools'][pool]['exports']
    for got, want in zip(exports, jax_side[pool]['exports']):
        _same_export(got, want)
    # Whole blocks of both kv heads: [L, block_size, kv_heads, head_dim]
    # (and the int8 pool's row scales).
    block = kv_migrate.unpack_arrays(exports[0]['blocks'][0])
    assert tuple(block['k'].shape) == (2, 8, 2, 16)
    assert ('k_scale' in block) == (pool == 'int8')


@pytest.mark.parametrize('pool', POOLS)
def test_tp_export_matches_one_rank_export(runs, pool):
    """Against one rank the int8 pool's K/V may sit one step apart where
    the fp32 rows round on either side of a half step (1 of 512 values
    in A's first block here), which moves the logits row by 1.7e-4: it
    is held to 1e-3 there, 2e-5 on the fp pool."""
    exports = runs['tp'][0]['pools'][pool]['exports']
    for got, want in zip(exports, runs['one'][pool]):
        _same_export(got, want, 1e-3 if pool == 'int8' else 2e-5)


@pytest.mark.parametrize('pool', POOLS)
@pytest.mark.parametrize('source', ['jax', 'one', 'tp'])
def test_tp_decode_imports_give_jax_colocated_tokens(runs, jax_side, pool,
                                                     source):
    """JAX tensor=2, port one-rank and port tensor=2 exports imported by
    the port's tensor=2 decode role: the JAX colocated engine's greedy
    tokens, no fallback, no prefill chunk, a shared prefix moving only
    its non-resident blocks, and no block held once idle."""
    got = runs['tp'][0]['pools'][pool][source]
    assert got['tokens'] == jax_side[pool]['tokens']
    assert got['moved'] == MOVED and got['resident'] == RESIDENT
    assert got['kv_import_fallbacks'] == 0 and got['prefill_chunks'] == 0
    assert got['all_free']


@pytest.mark.parametrize('pool', POOLS)
def test_tp_export_imported_by_one_rank_decode(runs, jax_side, pool):
    got = runs['back'][pool]
    assert got['tokens'] == jax_side[pool]['tokens']
    assert got['moved'] == MOVED and got['kv_import_fallbacks'] == 0
    assert got['all_free']


@pytest.mark.parametrize('pool', POOLS)
def test_each_rank_moves_its_own_heads_in_rank_order(runs, pool):
    """Exports: every read's whole-head blocks are the ranks' local
    reads joined in rank order, bitwise (the export's payloads are
    those blocks). Imports: after every write each rank's pool holds
    its own kv head of the driver's payload, bitwise."""
    tp = runs['tp']
    exports = tp[0]['pools'][pool]['exports']
    reads = [r['pools'][pool]['reads'] for r in tp]
    writes = [r['pools'][pool]['writes'] for r in tp]
    assert len(reads[0]) == len(reads[1]) == len(exports)
    # One write an import (each moves a block or a tail), the same on
    # both ranks: the jax, one and tp sources, and on the fp pool the
    # speculative engine's import of the tp exports; the short payload
    # wrote nothing anywhere. The last imports are of the tp exports.
    imports = len(PROMPTS) * (4 if pool == 'fp' else 3)
    assert len(writes[0]) == len(writes[1]) == imports
    ranks.check_head_order(exports, reads, writes, RESIDENT)


@pytest.mark.parametrize('pool', POOLS)
def test_short_payload_falls_back_with_every_block_free(runs, jax_side,
                                                        pool):
    got = runs['tp'][0]['pools'][pool]['tampered']
    assert got['tokens'] == [jax_side[pool]['tampered']]
    assert got['kv_import_fallbacks'] == 1 and got['all_free']
    assert got['prefill_chunks'] > 0


def test_speculative_decode_role_under_the_mesh(runs, jax_side):
    got = runs['tp'][0]['pools']['fp']['spec']
    assert got['tokens'] == jax_side['fp']['tokens']
    assert got['verify_steps'] > 0 and got['decode_steps'] == 0
    assert got['kv_import_fallbacks'] == 0 and got['prefill_chunks'] == 0


def test_stats_name_mesh_and_role(runs):
    assert runs['tp'][0]['pools']['fp']['mesh'] == {
        'mesh': "Mesh({'tensor': 2})", 'mesh_backend': 'gloo',
        'mesh_devices': ['cpu', 'cpu'], 'role': 'decode'}


def test_options_still_refused_under_the_mesh(runs):
    """A live refresh and adapter pages now run beside a decode role
    under the mesh (a refresh to version 1; 2 pages); ``embed_text`` and
    axes other than ``tensor`` still raise, naming ROADMAP.md."""
    refused = runs['tp'][0]['refused']
    assert sorted(refused) == ['embed_text']
    assert all('ROADMAP' in m and 'item 15' in m for m in refused.values())
    assert runs['tp'][0]['served'] == {'refresh': 1, 'lora_pages': 2}
    assert runs['tp'][1]['refused'] == {}
    cfg = ranks.tiny_config()
    for spec in ('data=2', 'tensor=2,data=2'):
        mesh = sharding.build_inference_mesh(spec, devices=range(8),
                                             device_type='cpu')
        with pytest.raises(NotImplementedError, match='item 15'):
            sharding.prepare_engine(None, cfg, mesh)
