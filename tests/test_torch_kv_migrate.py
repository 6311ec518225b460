"""The port's KV-block migration data plane against the reference.

Every case of ``tests/test_kv_migrate.py`` runs on the port's copy
(``skypilot_tpu_torch/inference/kv_migrate.py``): delta manifests,
digest verification, ranged resume, backpressure, and the chaos sites
``infer.kv_migrate.push`` / ``infer.kv_migrate.pull`` through the
port's ``utils/fault_injection.py``. Then the wire contract: for fp32,
int8 and bf16 arrays the port's ``pack_arrays`` writes the reference's
bytes, each package unpacks the other's payloads, the manifests' JSON is
equal, the HTTP handlers answer alike, and each package's puller reads
the other's ``KvServer``. Tolerance: none (bytes are compared exactly).
"""
import contextlib
import hashlib
import json
import os

import ml_dtypes
import numpy as np
import pytest
import torch

from skypilot_tpu.inference import kv_migrate as jkv
from skypilot_tpu.inference.paged import chain_digests as jchain_digests
from skypilot_tpu.server import metrics as jmetrics
from skypilot_tpu_torch.inference import kv_migrate
from skypilot_tpu_torch.inference.paged import chain_digests
from skypilot_tpu_torch.server import metrics
from skypilot_tpu_torch.utils import fault_injection
from torch_threads import few_torch_threads  # noqa: F401 (autouse)


@pytest.fixture(autouse=True, scope='module')
def _fresh_metrics():
    """Both packages' in-process migration metrics end the module empty,
    as they were before it."""
    metrics.reset_for_tests()
    jmetrics.reset_for_tests()
    yield
    metrics.reset_for_tests()
    jmetrics.reset_for_tests()


BS = 4


@contextlib.contextmanager
def inject_faults(spec: str):
    """``SKYT_FAULT_SPEC`` for the block, the port's injection state
    reset on entry and exit."""
    fault_injection.parse_spec(spec)
    previous = os.environ.get(fault_injection.SPEC_ENV)
    os.environ[fault_injection.SPEC_ENV] = spec
    fault_injection.reset()
    try:
        yield
    finally:
        if previous is None:
            os.environ.pop(fault_injection.SPEC_ENV, None)
        else:
            os.environ[fault_injection.SPEC_ENV] = previous
        fault_injection.reset()


def _export(request_id='req-1', n_blocks=3, tail=b'tail-state'):
    ids = list(range(100, 100 + n_blocks * BS + 2))  # +2 partial tail
    digests = chain_digests(ids, BS)
    blocks = [bytes([7 + i]) * 64 for i in range(n_blocks)]
    return kv_migrate.KvExport(
        request_id=request_id, ids=ids, block_size=BS,
        digests=digests, blocks=blocks, tail=tail,
        meta={'seed': 42, 'generated': 0})


def _no_sleep(_seconds):
    pass


# -- export + manifest -------------------------------------------------


def test_manifest_carries_digests_and_shas_not_payloads():
    export = _export()
    manifest = export.manifest()
    assert manifest['request_id'] == 'req-1'
    assert manifest['block_size'] == BS
    assert manifest['n_tokens'] == len(export.ids)
    assert [r['digest'] for r in manifest['blocks']] == export.digests
    for row, payload in zip(manifest['blocks'], export.blocks):
        assert row['sha256'] == hashlib.sha256(payload).hexdigest()
        assert row['nbytes'] == len(payload)
        assert 'data' not in row
    assert manifest['tail']['nbytes'] == len(export.tail)
    assert manifest['meta']['seed'] == 42


def test_export_rejects_misaligned_digests():
    with pytest.raises(ValueError, match='digests'):
        kv_migrate.KvExport(
            request_id='r', ids=[1] * 8, block_size=4,
            digests=[1, 2, 3], blocks=[b'x'], tail=b'', meta={})


def test_exporter_put_get_pop_idempotent():
    exporter = kv_migrate.KvExporter()
    export = _export()
    exporter.put(export)
    assert exporter.request_ids() == ['req-1']
    assert exporter.get('req-1') is export
    assert exporter.pop('req-1') is export
    assert exporter.pop('req-1') is None  # idempotent
    with pytest.raises(KeyError):
        exporter.get('req-1')


# -- delta pull --------------------------------------------------------


def test_pull_moves_only_non_resident_blocks():
    metrics.reset_for_tests()
    exporter = kv_migrate.KvExporter()
    export = _export(n_blocks=4)
    exporter.put(export)
    puller = kv_migrate.KvPuller(
        kv_migrate.LocalKvSource(exporter), sleep=_no_sleep)
    # The decode side already holds the first two chain blocks.
    pulled = puller.pull('req-1', resident_digests=export.digests[:2])
    assert pulled.resident == 2
    assert pulled.moved == 2
    assert pulled.payloads[:2] == [None, None]
    assert pulled.payloads[2:] == export.blocks[2:]
    assert pulled.tail == export.tail
    assert metrics.KV_MIGRATE_BLOCKS.value(outcome='resident') == 2
    assert metrics.KV_MIGRATE_BLOCKS.value(outcome='moved') == 2
    # Only the moved payloads + tail crossed the wire.
    moved_bytes = sum(len(b) for b in export.blocks[2:]) + \
        len(export.tail)
    assert metrics.KV_MIGRATE_BYTES.value(direction='pull') == moved_bytes


def test_corrupt_block_repulled_never_returned():
    metrics.reset_for_tests()
    exporter = kv_migrate.KvExporter()
    export = _export(n_blocks=1)
    exporter.put(export)
    flips = {'left': 1}

    def mutate(kind, key, data):
        if kind == 'block' and flips['left'] > 0:
            flips['left'] -= 1
            return b'\x00' + data[1:]
        return data

    puller = kv_migrate.KvPuller(
        kv_migrate.LocalKvSource(exporter, mutate=mutate),
        sleep=_no_sleep)
    pulled = puller.pull('req-1')
    assert pulled.payloads[0] == export.blocks[0]  # clean bytes won
    assert puller.corrupt_retries == 1
    assert metrics.KV_MIGRATE_BLOCKS.value(outcome='corrupt_retry') == 1


def test_permanently_corrupt_block_raises_block_corrupt():
    exporter = kv_migrate.KvExporter()
    exporter.put(_export(n_blocks=1))
    puller = kv_migrate.KvPuller(
        kv_migrate.LocalKvSource(
            exporter, mutate=lambda k, key, d: b'\xff' * len(d)),
        retries=2, sleep=_no_sleep)
    with pytest.raises(kv_migrate.BlockCorrupt):
        puller.pull('req-1')


def test_dead_source_exhausts_retries():
    exporter = kv_migrate.KvExporter()  # empty: every lookup fails
    puller = kv_migrate.KvPuller(
        kv_migrate.LocalKvSource(exporter), retries=2, sleep=_no_sleep)
    with pytest.raises(kv_migrate.MigrationUnavailable):
        puller.pull('gone')
    assert puller.unavailable_retries == 3  # budget fully spent


# -- chaos sites -------------------------------------------------------


def test_pull_chaos_fault_is_retried_to_success():
    exporter = kv_migrate.KvExporter()
    export = _export()
    exporter.put(export)
    puller = kv_migrate.KvPuller(
        kv_migrate.LocalKvSource(exporter), sleep=_no_sleep)
    with inject_faults('infer.kv_migrate.pull:ConnectionError:times=2'):
        pulled = puller.pull('req-1')
    assert pulled.moved == len(export.blocks)
    assert puller.unavailable_retries >= 1


def test_push_chaos_fault_sheds_with_retry_after():
    exporter = kv_migrate.KvExporter()
    exporter.put(_export())
    with inject_faults('infer.kv_migrate.push:OSError:times=1'):
        status, headers, _body = kv_migrate.handle_kv_get(
            '/kv/manifest/req-1', exporter)
        assert status == 503
        assert 'Retry-After' in headers
        # Next attempt (fault budget spent) serves normally.
        status, _headers, body = kv_migrate.handle_kv_get(
            '/kv/manifest/req-1', exporter)
    assert status == 200
    assert b'req-1' in body


# -- the HTTP surface --------------------------------------------------


def test_http_pull_end_to_end_with_shed_and_release():
    exporter = kv_migrate.KvExporter()
    export = _export(n_blocks=3)
    exporter.put(export)
    with kv_migrate.KvServer(exporter) as server:
        source = kv_migrate.HTTPKvSource(server.endpoint, timeout=10)
        puller = kv_migrate.KvPuller(source, sleep=_no_sleep)
        with inject_faults('infer.kv_migrate.push:OSError:times=1'):
            # The 503+Retry-After shed surfaces as a retryable
            # MigrationUnavailable carrying the floor.
            pulled = puller.pull(
                'req-1', resident_digests=export.digests[:1])
        assert pulled.resident == 1
        assert pulled.payloads[1:] == export.blocks[1:]
        assert pulled.tail == export.tail
        assert puller.unavailable_retries >= 1
        source.release('req-1')
    assert len(exporter) == 0


def test_http_ranged_block_resume():
    exporter = kv_migrate.KvExporter()
    export = _export(n_blocks=1)
    exporter.put(export)
    with kv_migrate.KvServer(exporter) as server:
        source = kv_migrate.HTTPKvSource(server.endpoint, timeout=10)
        digest = export.digests[0]
        whole = b''.join(source.fetch_block('req-1', digest, 0))
        part = b''.join(source.fetch_block('req-1', digest, 10))
        assert whole == export.blocks[0]
        assert part == export.blocks[0][10:]


def test_handle_kv_get_unknown_paths():
    exporter = kv_migrate.KvExporter()
    exporter.put(_export())
    assert kv_migrate.handle_kv_get('/kv/manifest/nope',
                                    exporter)[0] == 404
    assert kv_migrate.handle_kv_get('/kv/block/req-1/123456',
                                    exporter)[0] == 404
    assert kv_migrate.handle_kv_get('/other', exporter)[0] == 404
    status, _h, _b = kv_migrate.handle_kv_release('/kv/release/nope',
                                                  exporter)
    assert status == 200  # idempotent release


# -- the wire contract with the reference --------------------------------


def _block_arrays(dtype: str, seed: int = 0):
    """One pool block's payload at a small shape (L=2, block 4, kv heads
    2, head dim 8) as (reference numpy dict, port torch dict), from the
    same seeded values; int8 carries its fp32 row scales."""
    rng = np.random.RandomState(seed)
    shape = (2, BS, 2, 8)
    if dtype == 'int8':
        ref = {'k': rng.randint(-128, 128, shape).astype(np.int8),
               'v': rng.randint(-128, 128, shape).astype(np.int8),
               'k_scale': rng.rand(*shape[:-1]).astype(np.float32),
               'v_scale': rng.rand(*shape[:-1]).astype(np.float32)}
        return ref, {n: torch.from_numpy(a.copy()) for n, a in ref.items()}
    k = rng.randn(*shape).astype(np.float32)
    v = rng.randn(*shape).astype(np.float32)
    if dtype == 'float32':
        ref = {'k': k, 'v': v}
        return ref, {n: torch.from_numpy(a.copy()) for n, a in ref.items()}
    port = {'k': torch.from_numpy(k).bfloat16(),
            'v': torch.from_numpy(v).bfloat16()}
    ref = {n: t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
           for n, t in port.items()}
    return ref, port


def _bits(t: torch.Tensor) -> np.ndarray:
    """Raw bytes of a tensor as uint8, for bitwise comparison."""
    return t.contiguous().reshape(-1).view(torch.uint8).numpy()


@pytest.mark.parametrize('dtype', ['float32', 'int8', 'bfloat16'])
def test_pack_bytes_equal_reference(dtype):
    ref_arrays, port_arrays = _block_arrays(dtype)
    port_bytes = kv_migrate.pack_arrays(port_arrays)
    ref_bytes = jkv.pack_arrays(ref_arrays)
    assert port_bytes == ref_bytes
    # The tail payload: the partial block's arrays under tail_ names
    # beside the fp32 logits row.
    logits = np.random.RandomState(1).randn(64).astype(np.float32)
    ref_tail = {'logits': logits,
                **{f'tail_{n}': a for n, a in ref_arrays.items()}}
    port_tail = {'logits': torch.from_numpy(logits.copy()),
                 **{f'tail_{n}': t for n, t in port_arrays.items()}}
    assert kv_migrate.pack_arrays(port_tail) == jkv.pack_arrays(ref_tail)
    header_len = int.from_bytes(port_bytes[:4], 'big')
    header = json.loads(port_bytes[4:4 + header_len])
    assert header['k']['dtype'] == dtype


@pytest.mark.parametrize('dtype', ['float32', 'int8', 'bfloat16'])
def test_each_side_unpacks_the_others_payload(dtype):
    ref_arrays, port_arrays = _block_arrays(dtype, seed=3)
    got = kv_migrate.unpack_arrays(jkv.pack_arrays(ref_arrays))
    assert sorted(got) == sorted(port_arrays)
    for name, tensor in port_arrays.items():
        assert got[name].dtype == tensor.dtype
        assert got[name].shape == tensor.shape
        assert np.array_equal(_bits(got[name]), _bits(tensor))
    back = jkv.unpack_arrays(kv_migrate.pack_arrays(port_arrays))
    for name, array in ref_arrays.items():
        assert back[name].dtype == array.dtype
        assert back[name].tobytes() == array.tobytes()


def test_unpack_rejects_truncated_and_unknown_payloads():
    payload = kv_migrate.pack_arrays({'k': torch.ones(3)})
    with pytest.raises(ValueError):
        kv_migrate.unpack_arrays(payload[:-1])
    with pytest.raises(ValueError, match='describes'):
        kv_migrate.unpack_arrays(payload + b'\x00')
    header = json.dumps({'k': {'dtype': 'float8', 'shape': [1]}}).encode()
    with pytest.raises(ValueError, match='float8'):
        kv_migrate.unpack_arrays(len(header).to_bytes(4, 'big') + header +
                                 b'\x00')


def test_manifest_json_and_handlers_equal_reference():
    ids = list(range(300, 300 + 3 * BS + 1))
    assert chain_digests(ids, BS) == jchain_digests(ids, BS)
    kwargs = dict(request_id='r7', ids=ids, block_size=BS,
                  digests=chain_digests(ids, BS),
                  blocks=[bytes([i]) * 40 for i in range(3)],
                  tail=b'tail', meta={'seed': 3, 'n_tokens': len(ids),
                                      'adapter': ''})
    port, ref = kv_migrate.KvExport(**kwargs), jkv.KvExport(**kwargs)
    assert json.dumps(port.manifest(), sort_keys=True) == \
        json.dumps(ref.manifest(), sort_keys=True)
    port_x, ref_x = kv_migrate.KvExporter(), jkv.KvExporter()
    port_x.put(port)
    ref_x.put(ref)
    digest = kwargs['digests'][1]
    for path, rng in (('/kv/manifest/r7', None), ('/kv/tail/r7', None),
                      (f'/kv/block/r7/{digest}', None),
                      (f'/kv/block/r7/{digest}', 'bytes=5-'),
                      ('/kv/block/r7/1', None), ('/kv/nope/r7', None)):
        assert kv_migrate.handle_kv_get(path, port_x, rng) == \
            jkv.handle_kv_get(path, ref_x, rng), (path, rng)
    assert kv_migrate.handle_kv_release('/kv/release/r7', port_x) == \
        jkv.handle_kv_release('/kv/release/r7', ref_x)


@pytest.mark.parametrize('direction', ['reference_pulls_port',
                                       'port_pulls_reference'])
def test_cross_wire_pull(direction):
    """One package's ``KvPuller`` over ``HTTPKvSource`` reads the other
    package's ``KvServer``, with a resident first block and a bf16 block
    payload, and releases the export."""
    server_mod, puller_mod = ((kv_migrate, jkv)
                              if direction == 'reference_pulls_port'
                              else (jkv, kv_migrate))
    ref_arrays, port_arrays = _block_arrays('bfloat16', seed=5)
    payload = kv_migrate.pack_arrays(port_arrays)
    ids = list(range(50, 50 + 3 * BS + 2))
    export = server_mod.KvExport(
        request_id='x1', ids=ids, block_size=BS,
        digests=chain_digests(ids, BS),
        blocks=[payload, payload[::-1], payload], tail=b'tail',
        meta={'seed': 0, 'n_tokens': len(ids), 'adapter': ''})
    exporter = server_mod.KvExporter()
    exporter.put(export)
    with server_mod.KvServer(exporter) as server:
        source = puller_mod.HTTPKvSource(server.endpoint, timeout=10)
        pulled = puller_mod.KvPuller(source, sleep=_no_sleep).pull(
            'x1', resident_digests=export.digests[:1])
        source.release('x1')
    assert pulled.resident == 1 and pulled.moved == 2
    assert pulled.payloads[1:] == export.blocks[1:]
    assert pulled.tail == b'tail'
    assert len(exporter) == 0
    got = puller_mod.unpack_arrays(pulled.payloads[2])
    if puller_mod is jkv:
        assert got['k'].tobytes() == ref_arrays['k'].tobytes()
    else:
        assert np.array_equal(_bits(got['k']), _bits(port_arrays['k']))
