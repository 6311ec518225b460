"""The port's replica side of the weight fan-out
(``skypilot_tpu_torch/data/fanout.py``) against the reference's.

Twins of ``tests/test_fanout.py``'s replica-side cases: the tree and
its heal order, the O(log N) lease bound, leases (bound, renewal, TTL,
the ``data.fanout.lease`` chaos site), the peer-serving handler
(manifest, shards, Range resume, 404/503), a ``PeerServer`` round trip,
a dead peer as ``PeerUnavailable``, the puller's delta refresh,
byte-offset resume, oversized-partial discard, heal order parent ->
grandparent -> bucket, corrupt-peer report, the authoritative bucket and
the lease gate. Across packages: a port ``PeerServer`` feeds the
reference's ``FanoutPuller`` and a JAX-package ``PeerServer`` feeds the
port's, and the port's inference server serves ``/fanout/*`` to either
puller. The controller's planning (``plan_for_new_replica``,
``quarantine_peer``) is the reference's alone and is not tested here.
"""
import contextlib
import json
import os
import threading
import urllib.request

import pytest

from skypilot_tpu.data import fanout as jfanout
from skypilot_tpu_torch.data import ckpt_manifest, fanout
from skypilot_tpu_torch.server import metrics
from skypilot_tpu_torch.utils import fault_injection
from torch_threads import few_torch_threads  # noqa: F401 (autouse)


@contextlib.contextmanager
def inject_faults(spec):
    """``SKYT_FAULT_SPEC`` for the block, the port's fault state reset on
    entry and exit."""
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


@pytest.fixture(autouse=True, scope='module')
def _fresh_metrics():
    metrics.reset_for_tests()
    yield
    metrics.reset_for_tests()


def _make_weights(root, files=None):
    files = files or {'model/a.bin': b'alpha' * 4000,
                      'model/b.bin': b'beta' * 2000,
                      'meta.json': b'{"step": 1}'}
    for rel, data in files.items():
        full = os.path.join(root, *rel.split('/'))
        os.makedirs(os.path.dirname(full) or root, exist_ok=True)
        with open(full, 'wb') as f:
            f.write(data)
    payload = ckpt_manifest.build(root, step=1)
    ckpt_manifest.write(root, payload)
    return payload


def _dir_source(name, root, is_peer=True):
    def fn(shard, offset):
        with open(os.path.join(root, *shard['path'].split('/')), 'rb') as f:
            f.seek(offset)
            return f.read()
    return fanout.CallableSource(name, fn, is_peer=is_peer)


# -- topology and leases -------------------------------------------------


def test_tree_topology_and_heal_order():
    assert fanout.tree_parent(0) is None
    assert fanout.tree_parent(1) == 0
    assert fanout.tree_parent(2) == 0
    assert fanout.tree_parent(5) == 2
    assert fanout.tree_ancestors(0) == []
    assert fanout.tree_ancestors(5) == [2, 0]
    assert fanout.tree_ancestors(14, arity=2) == [6, 2, 0]
    assert fanout.tree_ancestors(5, arity=4) == [1, 0]
    for n in range(40):
        for arity in (1, 2, 3, 4):
            assert fanout.tree_ancestors(n, arity) == \
                jfanout.tree_ancestors(n, arity)


def test_bucket_lease_bound_is_logarithmic():
    assert fanout.bucket_lease_bound(0) == 1
    assert fanout.bucket_lease_bound(1) == 1
    assert fanout.bucket_lease_bound(7) == 3
    assert fanout.bucket_lease_bound(1000) == 10
    assert fanout.bucket_lease_bound(10000) == 14
    assert fanout.bucket_lease_bound(10000, configured=3) == 3


def test_lease_manager_bound_renewal_and_ttl():
    clock = [0.0]
    lease = fanout.LeaseManager(bound=2, ttl=60.0, clock=lambda: clock[0])
    assert lease.try_acquire('a')
    assert lease.try_acquire('b')
    assert not lease.try_acquire('c')
    assert lease.try_acquire('a')     # renewal, not a second slot
    assert lease.active() == 2
    lease.release('a')
    assert lease.try_acquire('c')
    clock[0] = 61.0                   # a dead holder frees its slot
    assert lease.try_acquire('d')
    assert lease.max_active == 2


def test_lease_site_faults_surface_to_caller():
    lease = fanout.LeaseManager(bound=1)
    with inject_faults(f'{fanout.LEASE_SITE}:OSError:times=1'):
        with pytest.raises(OSError):
            lease.try_acquire('a')
        assert lease.try_acquire('a')


def test_sources_from_plan_keep_the_ancestor_order():
    plan = {'peers': [{'replica_id': 2, 'endpoint': 'http://a:1'},
                      {'replica_id': 1, 'endpoint': 'http://b:1/'}]}
    sources = fanout.sources_from_plan(plan, timeout=1.0)
    assert [s.replica_id for s in sources] == [2, 1]
    assert [s.endpoint for s in sources] == ['http://a:1', 'http://b:1']


# -- the peer-serving end ------------------------------------------------


def test_handle_peer_get_serves_manifest_and_shards(tmp_path):
    root = str(tmp_path)
    payload = _make_weights(root)
    status, _, body = fanout.handle_peer_get('/fanout/manifest', root)
    assert status == 200 and json.loads(body) == payload
    shard = payload['shards'][0]
    status, headers, body = fanout.handle_peer_get(
        f'/fanout/shard/{shard["sha256"]}', root)
    assert status == 200 and len(body) == shard['size']
    assert headers['X-Skyt-Shard-Sha256'] == shard['sha256']
    status, headers, tail = fanout.handle_peer_get(
        f'/fanout/shard/{shard["sha256"]}', root,
        range_header='bytes=100-')
    assert status == 206 and tail == body[100:]
    assert headers['Content-Range'].startswith('bytes 100-')
    # The reference's handler answers the same bytes and headers.
    for path, rng in (('/fanout/manifest', None),
                      (f'/fanout/shard/{shard["sha256"]}', 'bytes=100-')):
        assert fanout.handle_peer_get(path, root, rng) == \
            jfanout.handle_peer_get(path, root, rng)
    assert fanout.handle_peer_get('/fanout/shard/' + '0' * 64,
                                  root)[0] == 404
    os.remove(ckpt_manifest.manifest_path(root))
    assert fanout.handle_peer_get('/fanout/manifest', root)[0] == 404
    assert fanout.handle_peer_get('/fanout/manifest', '')[0] == 503


def test_peer_server_http_roundtrip_with_resume(tmp_path):
    src, dst = str(tmp_path / 'src'), str(tmp_path / 'dst')
    payload = _make_weights(src)
    with fanout.PeerServer(src) as server:
        with urllib.request.urlopen(
                f'{server.endpoint}/fanout/manifest') as resp:
            assert json.loads(resp.read()) == payload
        assert fanout.fetch_manifest(server.endpoint, timeout=5.0) == \
            payload
        source = fanout.HTTPPeerSource(1, server.endpoint, timeout=5.0)
        bucket = _dir_source('bucket', src, is_peer=False)
        result = fanout.FanoutPuller(payload, dst, [source], bucket).pull()
    assert result['fetched'] == len(payload['shards'])
    assert set(result['sources'].values()) == {'peer:1'}
    assert ckpt_manifest.verify(dst, payload) == []
    assert ckpt_manifest.read(dst) == payload


def test_http_peer_death_surfaces_as_peer_unavailable(tmp_path):
    src = str(tmp_path / 'src')
    payload = _make_weights(src)
    server = fanout.PeerServer(src)
    with server:
        pass  # started and stopped: the port is now dead
    source = fanout.HTTPPeerSource(1, server.endpoint, timeout=0.5)
    with pytest.raises(fanout.PeerUnavailable):
        list(source.fetch(payload['shards'][0], 0))
    with pytest.raises(fanout.PeerUnavailable):
        fanout.fetch_manifest(server.endpoint, timeout=0.5)


# -- the puller ----------------------------------------------------------


def test_warm_delta_refresh_moves_only_changed_shards(tmp_path):
    src, dst = str(tmp_path / 'src'), str(tmp_path / 'dst')
    old = _make_weights(src)
    bucket = _dir_source('bucket', src, is_peer=False)
    assert fanout.FanoutPuller(old, dst, [], bucket).pull()['fetched'] == 3
    with open(os.path.join(src, 'model', 'a.bin'), 'wb') as f:
        f.write(b'ALPHA2' * 4000)
    new = ckpt_manifest.build(src, step=2)
    ckpt_manifest.write(src, new)
    assert [s['path'] for s in ckpt_manifest.diff(old, new)] == \
        ['model/a.bin']
    second = fanout.FanoutPuller(new, dst, [], bucket).pull()
    assert second['fetched'] == 1 and second['skipped'] == 2
    assert ckpt_manifest.verify(dst, new) == []


def test_partial_shard_resumes_from_byte_offset(tmp_path):
    src, dst = str(tmp_path / 'src'), str(tmp_path / 'dst')
    payload = _make_weights(src)
    shard = payload['shards'][0]
    with open(os.path.join(src, *shard['path'].split('/')), 'rb') as f:
        half = f.read(shard['size'] // 2)
    final = os.path.join(dst, *shard['path'].split('/'))
    os.makedirs(os.path.dirname(final))
    with open(f'{final}{ckpt_manifest.TMP_INFIX}.part', 'wb') as f:
        f.write(half)
    offsets = []

    def fn(s, offset):
        offsets.append((s['path'], offset))
        with open(os.path.join(src, *s['path'].split('/')), 'rb') as f:
            f.seek(offset)
            return f.read()

    before = metrics.FANOUT_SHARDS.value(source='bucket', outcome='resumed')
    bucket = fanout.CallableSource('bucket', fn, is_peer=False)
    fanout.FanoutPuller(payload, dst, [], bucket).pull()
    assert (shard['path'], len(half)) in offsets
    assert ckpt_manifest.verify(dst, payload) == []
    assert metrics.FANOUT_SHARDS.value(source='bucket',
                                       outcome='resumed') == before + 1


def test_oversized_partial_is_discarded_not_resumed(tmp_path):
    src, dst = str(tmp_path / 'src'), str(tmp_path / 'dst')
    payload = _make_weights(src)
    shard = payload['shards'][0]
    final = os.path.join(dst, *shard['path'].split('/'))
    os.makedirs(os.path.dirname(final))
    with open(f'{final}{ckpt_manifest.TMP_INFIX}.part', 'wb') as f:
        f.write(b'x' * (shard['size'] + 100))
    bucket = _dir_source('bucket', src, is_peer=False)
    fanout.FanoutPuller(payload, dst, [], bucket).pull()
    assert ckpt_manifest.verify(dst, payload) == []


def test_dead_parent_heals_to_grandparent_then_bucket(tmp_path):
    src, dst = str(tmp_path / 'src'), str(tmp_path / 'dst')
    payload = _make_weights(src)

    def dead(shard, offset):
        raise ConnectionError('injected: peer died')

    parent = fanout.CallableSource('peer:parent', dead)
    grandparent = _dir_source('peer:grandparent', src)
    bucket = _dir_source('bucket', src, is_peer=False)
    puller = fanout.FanoutPuller(payload, dst, [parent, grandparent],
                                 bucket)
    result = puller.pull()
    assert result['heals'] == 1 and puller.heals[0][0] == 'peer:parent'
    assert set(result['sources'].values()) == {'peer:grandparent'}
    assert ckpt_manifest.verify(dst, payload) == []
    # With every peer dead the bucket serves.
    dst2 = str(tmp_path / 'dst2')
    result = fanout.FanoutPuller(
        payload, dst2, [fanout.CallableSource('peer:a', dead),
                        fanout.CallableSource('peer:b', dead)],
        bucket).pull()
    assert result['heals'] == 2
    assert set(result['sources'].values()) == {'bucket'}


def test_corrupt_peer_is_reported_and_healed(tmp_path):
    src, dst = str(tmp_path / 'src'), str(tmp_path / 'dst')
    payload = _make_weights(src)
    corrupt = fanout.CallableSource(
        'peer:evil', lambda s, o: b'\x00' * (s['size'] - o))
    bucket = _dir_source('bucket', src, is_peer=False)
    reported = []
    puller = fanout.FanoutPuller(
        payload, dst, [corrupt], bucket,
        lease=fanout.LeaseManager(bound=1),
        on_corrupt=lambda source, shard: reported.append(source.name))
    result = puller.pull()
    assert reported == ['peer:evil']
    assert result['heals'] == 1
    assert set(result['sources'].values()) == {'bucket'}
    assert ckpt_manifest.verify(dst, payload) == []


def test_bucket_digest_mismatch_is_authoritative(tmp_path):
    src, dst = str(tmp_path / 'src'), str(tmp_path / 'dst')
    payload = _make_weights(src)
    bad_bucket = fanout.CallableSource(
        'bucket', lambda s, o: b'\xff' * (s['size'] - o), is_peer=False)
    with pytest.raises(fanout.ShardCorrupt):
        fanout.FanoutPuller(payload, dst, [], bad_bucket).pull()
    assert ckpt_manifest.read(dst) is None


def test_lease_gates_bucket_and_times_out(tmp_path):
    src = str(tmp_path / 'src')
    payload = _make_weights(src)
    bucket = _dir_source('bucket', src, is_peer=False)
    lease = fanout.LeaseManager(bound=1, ttl=3600.0)
    assert lease.try_acquire('hog')
    naps = []
    puller = fanout.FanoutPuller(
        payload, str(tmp_path / 'dst'), [], bucket, lease=lease,
        holder='puller', lease_wait_s=0.5, sleep=naps.append)
    with pytest.raises(fanout.PeerUnavailable, match='lease'):
        puller.pull()
    assert naps
    lease.release('hog')
    result = puller.pull()
    assert result['fetched'] + result['skipped'] == 3
    assert lease.active() == 0


def test_directory_source_serves_ranges(tmp_path):
    src = str(tmp_path / 'src')
    payload = _make_weights(src)
    shard = payload['shards'][0]
    source = fanout.DirectorySource(src)
    whole = b''.join(source.fetch(shard, 0))
    assert len(whole) == shard['size']
    assert b''.join(source.fetch(shard, 10)) == whole[10:]
    with pytest.raises(fanout.PeerUnavailable):
        list(source.fetch({'path': 'nope.bin', 'size': 1}, 0))


# -- across packages -----------------------------------------------------


@pytest.mark.parametrize('direction', ['port_serves_jax',
                                       'jax_serves_port'])
def test_peer_servers_feed_the_other_package(tmp_path, direction):
    src, dst = str(tmp_path / 'src'), str(tmp_path / 'dst')
    payload = _make_weights(src)
    serve, pull = ((fanout, jfanout) if direction == 'port_serves_jax'
                   else (jfanout, fanout))
    with serve.PeerServer(src) as server:
        assert pull.fetch_manifest(server.endpoint, timeout=5.0) == payload
        source = pull.HTTPPeerSource(7, server.endpoint, timeout=5.0)
        bucket = pull.CallableSource('bucket', lambda s, o: b'',
                                     is_peer=False)
        result = pull.FanoutPuller(payload, dst, [source], bucket).pull()
    assert set(result['sources'].values()) == {'peer:7'}
    assert ckpt_manifest.verify(dst, payload) == []
    assert ckpt_manifest.read(dst) == payload


def test_inference_server_serves_fanout_routes(tmp_path, monkeypatch):
    """The port's HTTP server mounts the peer surface over
    ``SKYT_FANOUT_DIR``: either package's puller pulls from it."""
    from skypilot_tpu_torch.inference import server as server_mod
    src = str(tmp_path / 'weights')
    payload = _make_weights(src)
    monkeypatch.setenv(fanout.DIR_ENV, src)

    class _NoEngine:
        class cfg:
            name = 'none'

    server = server_mod.serve(_NoEngine(), '127.0.0.1', 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        endpoint = f'http://127.0.0.1:{server.server_address[1]}'
        for mod, dst in ((fanout, 'port'), (jfanout, 'jax')):
            assert mod.fetch_manifest(endpoint, timeout=5.0) == payload
            result = mod.FanoutPuller(
                payload, str(tmp_path / dst),
                [mod.HTTPPeerSource(1, endpoint, timeout=5.0)],
                mod.CallableSource('bucket', lambda s, o: b'',
                                   is_peer=False)).pull()
            assert set(result['sources'].values()) == {'peer:1'}
            assert ckpt_manifest.verify(str(tmp_path / dst), payload) == []
        shard = payload['shards'][0]
        req = urllib.request.Request(
            f'{endpoint}/fanout/shard/{shard["sha256"]}',
            headers={'Range': 'bytes=5-'})
        with urllib.request.urlopen(req, timeout=5.0) as resp:
            assert resp.status == 206
            assert len(resp.read()) == shard['size'] - 5
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=20)
    assert not thread.is_alive()
