"""Self-healing peer fan-out, the replica's side: the port's copy of
``skypilot_tpu/data/fanout.py``.

A replica pulls content-addressed shards (``data/ckpt_manifest.py``)
from its ancestors in a k-ary tree over the fleet, parent first, and
falls back up the chain to the bucket on peer death, timeout or digest
mismatch; it serves what it holds to its own children over
``/fanout/manifest`` and ``/fanout/shard/<sha256>`` (Range-resumable).
Every shard is digest-verified before it lands; a partial shard lives in
a deterministic ``.skyt-tmp`` file and resumes from its byte offset; a
digest mismatch on bytes one source served whole reports that source
(``on_corrupt``); a bucket mismatch is authoritative; direct bucket
reads go through a TTL'd lease bounded to O(log N) holders; the
destination's manifest commits last. The wire (paths, headers, Range,
manifests) is the reference's, so a port replica and a JAX replica feed
each other.

What is copied: the topology (``tree_parent``, ``tree_ancestors``,
``bucket_lease_bound``), ``LeaseManager``, the sources
(``HTTPPeerSource``, ``CallableSource``, ``DirectorySource``),
``fetch_manifest``, ``sources_from_plan``, ``FanoutPuller`` and the
peer-serving end (``handle_peer_get``, ``PeerServer``). Left out: the
controller's planning, ``plan_for_new_replica`` and ``quarantine_peer``.
They read and write ``serve_state``, and the reference's JAX-free
orchestrator calls them (``serve/replica_managers.py``); the port does
not duplicate the orchestrator, which hands a port replica its plan in
``SKYT_FANOUT_PEERS`` as it hands a JAX one.

Chaos sites: ``data.fanout.peer_get`` (a peer fetch) and
``data.fanout.lease`` (lease acquisition), through the port's
``utils/fault_injection.py``.
"""
from __future__ import annotations

import http.server
import json
import logging
import math
import os
import threading
import time
import urllib.error
import urllib.request
from typing import (Any, Callable, Dict, Iterable, Iterator, List,
                    Optional, Tuple)

from skypilot_tpu_torch.data import ckpt_manifest
from skypilot_tpu_torch.server import metrics
from skypilot_tpu_torch.utils import env, fault_injection, resilience

logger = logging.getLogger(__name__)

PEER_GET_SITE = 'data.fanout.peer_get'
LEASE_SITE = 'data.fanout.lease'

# The weights directory a replica serves to its peers (declared in
# utils/env.py).
DIR_ENV = 'SKYT_FANOUT_DIR'

_CHUNK = 256 * 1024


# -- topology ----------------------------------------------------------


def bucket_lease_bound(n_replicas: int, configured: int = 0) -> int:
    """Concurrent bucket readers allowed for a fleet of ``n``:
    the configured override, else ``ceil(log2(n+1))`` — the depth of
    the fan-out tree, so origin load grows with the tree's height,
    not its width."""
    if configured > 0:
        return int(configured)
    return max(1, int(math.ceil(math.log2(max(1, n_replicas) + 1))))


def tree_parent(position: int, arity: int = 2) -> Optional[int]:
    """Parent index of ``position`` in the canonical k-ary heap
    layout over the fleet join order (position 0 has no parent — it
    pulls from the bucket)."""
    if position <= 0:
        return None
    return (position - 1) // max(1, arity)


def tree_ancestors(position: int, arity: int = 2) -> List[int]:
    """Ancestor chain of ``position``, parent first — the heal order
    a puller walks before falling back to the bucket."""
    out: List[int] = []
    node = position
    while True:
        parent = tree_parent(node, arity)
        if parent is None:
            return out
        out.append(parent)
        node = parent


# -- leases ------------------------------------------------------------


class LeaseManager:
    """In-process bucket-read leases: at most ``bound`` concurrent
    holders, each lease expiring ``ttl`` seconds after acquisition so
    a holder that dies mid-pull frees its slot. The reference's serve
    path uses a DB-backed twin with the same semantics."""

    def __init__(self, bound: int, ttl: float = 120.0,
                 clock: Optional[Callable[[], float]] = None) -> None:
        if clock is None:
            clock = time.monotonic
        self._clock = clock
        self.bound = max(1, int(bound))
        self.ttl = float(ttl)
        self._held: Dict[str, float] = {}
        self._lock = threading.Lock()
        self.max_active = 0

    def _expire(self, now: float) -> None:
        dead = [h for h, t in self._held.items()
                if now - t > self.ttl]
        for holder in dead:
            del self._held[holder]
            logger.warning('fanout lease of %s expired after %.0fs',
                           holder, self.ttl)

    def try_acquire(self, holder: str) -> bool:
        fault_injection.inject(LEASE_SITE)
        now = self._clock()
        with self._lock:
            self._expire(now)
            if holder in self._held:
                self._held[holder] = now
                return True
            if len(self._held) >= self.bound:
                return False
            self._held[holder] = now
            self.max_active = max(self.max_active, len(self._held))
            return True

    def release(self, holder: str) -> None:
        with self._lock:
            self._held.pop(holder, None)

    def active(self) -> int:
        with self._lock:
            self._expire(self._clock())
            return len(self._held)


# -- transfer sources --------------------------------------------------


class PeerUnavailable(Exception):
    """Peer dead / timed out / refusing — heal to the next source."""


class ShardCorrupt(Exception):
    """Digest mismatch on bytes served whole by one source — the
    quarantine trigger."""


class HTTPPeerSource:
    """Ranged shard fetches from a peer replica's ``/fanout/shard``
    endpoint (mounted on the payload server). Connection errors and
    timeouts surface as :class:`PeerUnavailable`."""

    def __init__(self, replica_id: int, endpoint: str,
                 timeout: Optional[float] = None) -> None:
        self.replica_id = replica_id
        self.endpoint = endpoint.rstrip('/')
        if timeout is None:
            timeout = env.get_float('SKYT_FANOUT_PEER_TIMEOUT')
        self.timeout = timeout
        self.name = f'peer:{replica_id}'

    def fetch(self, shard: Dict[str, Any],
              offset: int) -> Iterator[bytes]:
        fault_injection.inject(PEER_GET_SITE)
        url = f'{self.endpoint}/fanout/shard/{shard["sha256"]}'
        req = urllib.request.Request(url)
        if offset:
            req.add_header('Range', f'bytes={offset}-')
        try:
            with urllib.request.urlopen(req,
                                        timeout=self.timeout) as resp:
                if resp.status not in (200, 206):
                    raise PeerUnavailable(
                        f'{self.name}: HTTP {resp.status}')
                if resp.status == 200 and offset:
                    # Peer ignored Range: discard the prefix so the
                    # resume offset stays truthful.
                    resp.read(offset)
                while True:
                    chunk = resp.read(_CHUNK)
                    if not chunk:
                        return
                    yield chunk
        except urllib.error.HTTPError as e:
            raise PeerUnavailable(f'{self.name}: HTTP {e.code}') \
                from None
        except (urllib.error.URLError, TimeoutError, OSError,
                ConnectionError) as e:
            raise PeerUnavailable(f'{self.name}: {e}') from None


class CallableSource:
    """Test/bench seam: wraps ``fn(shard, offset) -> bytes`` (peers
    in-process, latency injected by the callable)."""

    def __init__(self, name: str,
                 fn: Callable[[Dict[str, Any], int], bytes],
                 is_peer: bool = True) -> None:
        self.name = name
        self.replica_id: Optional[int] = None
        self._fn = fn
        self._is_peer = is_peer

    def fetch(self, shard: Dict[str, Any],
              offset: int) -> Iterator[bytes]:
        if self._is_peer:
            fault_injection.inject(PEER_GET_SITE)
        data = self._fn(shard, offset)
        for i in range(0, len(data), _CHUNK):
            yield data[i:i + _CHUNK]


class DirectorySource:
    """Local-directory bucket stand-in: serves shard bytes straight
    from a committed weights tree (the RL pipeline's policy store and
    the benches pull learner deltas through the same verified-ranged
    path remote buckets use)."""

    def __init__(self, root: str, name: str = 'bucket:dir') -> None:
        self.root = root
        self.name = name
        self.replica_id: Optional[int] = None

    def fetch(self, shard: Dict[str, Any],
              offset: int) -> Iterator[bytes]:
        path = os.path.join(self.root, shard['path'])
        try:
            with open(path, 'rb') as f:
                if offset:
                    f.seek(offset)
                while True:
                    chunk = f.read(_CHUNK)
                    if not chunk:
                        return
                    yield chunk
        except OSError as e:
            raise PeerUnavailable(f'{self.name}: {e}') from None


def fetch_manifest(endpoint: str,
                   timeout: Optional[float] = None
                   ) -> Optional[Dict[str, Any]]:
    """Fetch a peer's committed manifest (``/fanout/manifest``).

    Returns None when the peer has no committed manifest yet (404) —
    the same torn-reads-read-as-absent stance as the local
    ``ckpt_manifest.read``. Connection errors surface as
    :class:`PeerUnavailable` so pollers heal instead of crashing."""
    if timeout is None:
        timeout = env.get_float('SKYT_FANOUT_PEER_TIMEOUT')
    url = f'{endpoint.rstrip("/")}/fanout/manifest'
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            if resp.status != 200:
                raise PeerUnavailable(f'manifest: HTTP {resp.status}')
            return json.loads(resp.read().decode('utf-8'))
    except urllib.error.HTTPError as e:
        if e.code == 404:
            return None
        raise PeerUnavailable(f'manifest: HTTP {e.code}') from None
    except (urllib.error.URLError, TimeoutError, OSError,
            ConnectionError) as e:
        raise PeerUnavailable(f'manifest: {e}') from None


def sources_from_plan(plan: Dict[str, Any],
                      timeout: Optional[float] = None
                      ) -> List[HTTPPeerSource]:
    """Ancestor-ordered HTTP sources from a controller peer plan
    (the reference orchestrator's ``SKYT_FANOUT_PEERS`` payload,
    parsed)."""
    return [HTTPPeerSource(p['replica_id'], p['endpoint'],
                           timeout=timeout)
            for p in plan.get('peers', ())]


# -- the puller --------------------------------------------------------


class FanoutPuller:
    """Pulls one manifest's shards into ``dest``, healing up the
    source chain and falling back to the lease-bounded bucket.

    ``sources`` is the ancestor chain (parent first); ``bucket`` is
    the origin source (its fetches never inject ``peer_get`` faults
    and never quarantine). ``lease`` gates bucket reads — an object
    with ``try_acquire(holder)/release(holder)``
    (:class:`LeaseManager`).
    ``on_corrupt(source, shard)`` fires when a source served a whole
    shard whose digest mismatched (the reference's serve path wires it
    to its fleet-wide quarantine).
    """

    def __init__(self, manifest: Dict[str, Any], dest: str,
                 sources: Iterable[Any], bucket: Any, *,
                 lease: Optional[Any] = None,
                 holder: Optional[str] = None,
                 on_corrupt: Optional[Callable] = None,
                 lease_wait_s: float = 300.0,
                 sleep: Optional[Callable[[float], None]] = None
                 ) -> None:
        if sleep is None:
            sleep = time.sleep
        self.manifest = manifest
        self.dest = dest
        self.sources = list(sources)
        self.bucket = bucket
        self.lease = lease
        self.holder = holder or f'puller-{os.getpid()}-{id(self)}'
        self.on_corrupt = on_corrupt
        self.lease_wait_s = float(lease_wait_s)
        self._sleep = sleep
        self._lease_held = False
        # Observability for tests/benches: where each shard came from.
        self.shard_sources: Dict[str, str] = {}
        self.heals: List[Tuple[str, str]] = []

    # -- public --------------------------------------------------------

    def pull(self) -> Dict[str, Any]:
        """Fetch every missing/changed shard, verify, commit the
        manifest last. Returns a small result dict. Raises only when
        ALL sources (bucket included) fail a shard."""
        os.makedirs(self.dest, exist_ok=True)
        local = ckpt_manifest.read(self.dest)
        todo = ckpt_manifest.diff(local, self.manifest)
        # A committed manifest can still cover torn shards (a crashed
        # partial copy): re-check the ones diff skipped.
        if local is not None:
            have = {s['path'] for s in todo}
            todo += [s for s in ckpt_manifest.verify(
                self.dest, self.manifest) if s['path'] not in have]
        fetched = 0
        try:
            for shard in todo:
                self._pull_shard(shard)
                fetched += 1
        finally:
            self._release_lease()
        bad = ckpt_manifest.verify(self.dest, self.manifest)
        if bad:
            raise ShardCorrupt(
                f'{len(bad)} shard(s) failed final verification in '
                f'{self.dest}: {[s["path"] for s in bad[:4]]}')
        ckpt_manifest.write(self.dest, self.manifest)
        metrics.FANOUT_PULLS.inc(outcome='ok')
        return {'fetched': fetched, 'skipped':
                len(self.manifest.get('shards', ())) - fetched,
                'heals': len(self.heals),
                'sources': dict(self.shard_sources)}

    # -- internals -----------------------------------------------------

    def _pull_shard(self, shard: Dict[str, Any]) -> None:
        while True:
            source = self.sources[0] if self.sources else None
            if source is None:
                self._ensure_lease()
                source = self.bucket
            try:
                self._fetch_from(source, shard)
                self.shard_sources[shard['path']] = source.name
                metrics.FANOUT_SHARDS.inc(
                    source=('bucket' if source is self.bucket
                            else 'peer'), outcome='ok')
                return
            except ShardCorrupt as e:
                if source is self.bucket:
                    # The origin is authoritative: a bucket digest
                    # mismatch means the manifest and the object
                    # disagree — nothing further up to heal to.
                    raise
                metrics.FANOUT_SHARDS.inc(source='peer',
                                          outcome='corrupt')
                self._heal(source, f'corrupt: {e}')
                if self.on_corrupt is not None:
                    self.on_corrupt(source, shard)
            except (PeerUnavailable, TimeoutError, ConnectionError,
                    OSError) as e:
                if source is self.bucket:
                    raise PeerUnavailable(
                        f'bucket fetch of {shard["path"]} failed: '
                        f'{e}') from e
                metrics.FANOUT_SHARDS.inc(source='peer',
                                          outcome='error')
                self._heal(source, f'unavailable: {e}')

    def _heal(self, source: Any, reason: str) -> None:
        if self.sources and self.sources[0] is source:
            self.sources.pop(0)
        kind = 'corrupt' if reason.startswith('corrupt') else 'dead'
        metrics.FANOUT_HEALS.inc(reason=kind)
        self.heals.append((source.name, reason))
        nxt = self.sources[0].name if self.sources else 'bucket'
        logger.warning('fanout heal: %s %s; re-parenting to %s',
                       source.name, reason, nxt)

    def _fetch_from(self, source: Any,
                    shard: Dict[str, Any]) -> None:
        final = os.path.join(self.dest, *shard['path'].split('/'))
        os.makedirs(os.path.dirname(final) or self.dest,
                    exist_ok=True)
        # Deterministic tmp name: a relaunched puller (replica
        # preemption) resumes the same partial file.
        tmp = f'{final}{ckpt_manifest.TMP_INFIX}.part'
        offset = os.path.getsize(tmp) if os.path.exists(tmp) else 0
        if offset > shard['size']:
            os.remove(tmp)
            offset = 0
        if offset:
            metrics.FANOUT_SHARDS.inc(
                source=('bucket' if source is self.bucket else 'peer'),
                outcome='resumed')
        started_at = offset
        with open(tmp, 'ab') as f:
            for chunk in source.fetch(shard, offset):
                f.write(chunk)
                metrics.FANOUT_BYTES.inc(
                    len(chunk),
                    source=('bucket' if source is self.bucket
                            else 'peer'))
            f.flush()
            os.fsync(f.fileno())
        entry = ckpt_manifest.hash_file(tmp)
        if entry['sha256'] != shard['sha256'] or \
                entry['size'] != shard['size']:
            os.remove(tmp)
            if started_at == 0:
                # The whole shard came from this source: its bytes
                # are provably bad — corrupt, quarantine-worthy.
                raise ShardCorrupt(
                    f'{shard["path"]} from {source.name}: got '
                    f'{entry["sha256"][:12]}, want '
                    f'{shard["sha256"][:12]}')
            # Mixed provenance (resumed across sources): the bad
            # byte could belong to an earlier source — restart the
            # shard without blaming this peer.
            raise PeerUnavailable(
                f'{shard["path"]}: resumed shard failed digest; '
                f'restarting from offset 0')
        os.replace(tmp, final)

    def _ensure_lease(self) -> None:
        if self.lease is None or self._lease_held:
            return
        delays = resilience.backoff_delays(base=0.05, cap=2.0)
        waited = 0.0
        while True:
            if self.lease.try_acquire(self.holder):
                self._lease_held = True
                metrics.FANOUT_LEASE_WAIT.observe(waited)
                return
            delay = next(delays)
            waited += delay
            if waited > self.lease_wait_s:
                raise PeerUnavailable(
                    f'bucket lease not acquired within '
                    f'{self.lease_wait_s:.0f}s')
            self._sleep(delay)

    def _release_lease(self) -> None:
        if self.lease is not None and self._lease_held:
            self.lease.release(self.holder)
            self._lease_held = False


# -- peer-serving endpoint ---------------------------------------------


def handle_peer_get(path: str, weights_dir: Optional[str] = None,
                    range_header: Optional[str] = None
                    ) -> Tuple[int, Dict[str, str], bytes]:
    """Shared GET handler for the replica's peer-serving surface:
    ``/fanout/manifest`` (the committed manifest payload) and
    ``/fanout/shard/<sha256>`` (shard bytes, Range-resumable).
    Returns ``(status, headers, body)``; mounted by the payload
    server (inference/server.py) and :class:`PeerServer`. Serves
    only committed content — a torn manifest or a digest-less path
    is a 404, never a partial answer."""
    if weights_dir is None:
        weights_dir = env.get_str(DIR_ENV) or ''
    if not weights_dir:
        return 503, {}, b'{"error": "fanout dir not configured"}'
    payload = ckpt_manifest.read(weights_dir)
    if payload is None:
        return 404, {}, b'{"error": "no committed manifest"}'
    if path == '/fanout/manifest':
        return 200, {'Content-Type': 'application/json'}, json.dumps(
            payload, sort_keys=True).encode()
    prefix = '/fanout/shard/'
    if not path.startswith(prefix):
        return 404, {}, b'{"error": "not found"}'
    digest = path[len(prefix):]
    by_sha = {s['sha256']: s for s in payload.get('shards', ())}
    shard = by_sha.get(digest)
    if shard is None:
        return 404, {}, b'{"error": "unknown shard"}'
    root = os.path.abspath(weights_dir)
    full = os.path.abspath(os.path.join(root, *shard['path'].split('/')))
    if not full.startswith(root + os.sep):
        return 403, {}, b'{"error": "path escapes weights dir"}'
    offset = _parse_range(range_header)
    try:
        with open(full, 'rb') as f:
            if offset:
                f.seek(offset)
            body = f.read()
    except OSError:
        return 404, {}, b'{"error": "shard missing on disk"}'
    headers = {'Content-Type': 'application/octet-stream',
               'X-Skyt-Shard-Sha256': shard['sha256']}
    if offset:
        headers['Content-Range'] = (
            f'bytes {offset}-{shard["size"] - 1}/{shard["size"]}')
        return 206, headers, body
    return 200, headers, body


def _parse_range(header: Optional[str]) -> int:
    """Start offset of a ``bytes=N-`` header (the only form pullers
    send); anything else reads as 0 (serve from the top — the
    puller's digest check still holds)."""
    if not header or not header.startswith('bytes='):
        return 0
    spec = header[len('bytes='):].split(',')[0].strip()
    start = spec.split('-')[0]
    try:
        return max(0, int(start))
    except ValueError:
        return 0


class PeerServer:
    """Standalone peer-serving HTTP server over one weights
    directory — what tests and benches stand up in place of a full
    replica payload (the real replica mounts the same handler on
    its inference server)."""

    def __init__(self, weights_dir: str) -> None:
        self.weights_dir = weights_dir
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib casing)
                status, headers, body = handle_peer_get(
                    self.path, outer.weights_dir,
                    self.headers.get('Range'))
                self.send_response(status)
                for k, v in headers.items():
                    self.send_header(k, v)
                self.send_header('Content-Length', str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # noqa: D102
                pass

        self._server = http.server.ThreadingHTTPServer(
            ('127.0.0.1', 0), Handler)
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True)

    @property
    def endpoint(self) -> str:
        host, port = self._server.server_address[:2]
        return f'http://{host}:{port}'

    def __enter__(self) -> 'PeerServer':
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
