"""KV-block migration: the prefill->decode handoff of disaggregated serving.

The port's copy of ``skypilot_tpu/inference/kv_migrate.py``, on the
wire byte for byte the reference's, so either package's decode replica
pulls from either package's prefill replica.

A prefill replica (``role='prefill'`` / ``SKYT_DISAGG_ROLE=prefill``)
finishes a prompt and parks the result here as a :class:`KvExport`: the
slot's KV blocks serialized per block, keyed by the rolling chain
digests the :class:`PrefixCache` uses (``inference/paged.py``
``chain_digests``). The decode replica pulls it over a ranged,
content-addressed HTTP surface:

* **Delta manifests make shared-prefix migration nearly free.** The
  manifest carries one ``(chain digest, sha256, nbytes)`` row per full
  block; the decode side skips every block whose chain digest its own
  ``PrefixCache`` already holds (``outcome=resident``), so only
  non-resident blocks move. The decode engine increfs resident blocks
  through ``BlockImporter.begin`` before it writes the pulled ones, so
  they cannot be evicted mid-import.
* **Every payload is digest-verified; a corrupt block is re-pulled,
  never decoded.** sha256 over the wire bytes; a mismatch discards the
  payload and restarts that block from offset 0
  (``outcome=corrupt_retry``), bounded by ``SKYT_KV_MIGRATE_RETRIES``.
* **Transfers resume mid-block.** A fetch that dies mid-stream keeps
  its partial buffer; the retry sends ``Range: bytes=<got>-``.
* **The source's backpressure is honored.** A 429/503 with Retry-After
  floors the retry delay.

Payloads (:func:`pack_arrays`) are a 4-byte big-endian header length, a
JSON header (``sort_keys``; name -> ``{dtype, shape}``) and each array's
raw little-endian bytes in sorted-name order. The port packs and unpacks
torch tensors: a bf16 tensor crosses as its bytes under the dtype name
``bfloat16``, so no ``ml_dtypes`` is needed on either end.

Chaos sites (``utils/fault_injection.py``): ``infer.kv_migrate.push``
(the prefill side serving a manifest or block sheds with a 503 and
Retry-After) and ``infer.kv_migrate.pull`` (the decode side's fetch
fails).
"""
from __future__ import annotations

import dataclasses
import hashlib
import http.server
import json
import logging
import threading
import time
import urllib.error
import urllib.request
from typing import (Any, Callable, Dict, Iterator, List, Optional,
                    Sequence, Tuple)

import torch

from skypilot_tpu_torch.server import metrics
from skypilot_tpu_torch.utils import env, fault_injection, resilience

logger = logging.getLogger(__name__)

PUSH_SITE = 'infer.kv_migrate.push'
PULL_SITE = 'infer.kv_migrate.pull'

_CHUNK = 256 * 1024
_SHA_HEADER = 'X-Skyt-Kv-Sha256'


class MigrationUnavailable(Exception):
    """Source dead / timed out / shedding — retryable; carries the
    server's Retry-After floor when it sent one."""

    def __init__(self, msg: str, retry_after: float = 0.0) -> None:
        super().__init__(msg)
        self.retry_after = retry_after


class BlockCorrupt(Exception):
    """A payload failed its digest after every re-pull attempt — the
    decode side falls back to a local re-prefill; the bytes are never
    written into the KV pool."""


def _sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


# -- payload packing (engine KV tensors <-> wire bytes) ----------------

# The wire's dtype names are numpy's (``str(np.dtype)``; ``bfloat16`` is
# ml_dtypes' name, which the reference writes for a bf16 pool): those of
# the pool's fields and of the fp32 logits row.
_DTYPE_NAMES = {torch.bfloat16: 'bfloat16', torch.float16: 'float16',
                torch.float32: 'float32', torch.int8: 'int8'}
_DTYPES = {name: dtype for dtype, name in _DTYPE_NAMES.items()}


def pack_arrays(arrays: Dict[str, torch.Tensor]) -> bytes:
    """A name->tensor dict (tensors on any device) as one self-describing
    payload: a length-prefixed JSON header (name -> dtype, shape) + the
    raw bytes in sorted-name order. No pickle on the wire."""
    names = sorted(arrays)
    tensors = {n: arrays[n].detach().to('cpu').contiguous() for n in names}
    for name, tensor in tensors.items():
        if tensor.dtype not in _DTYPE_NAMES:
            raise ValueError(f'{name}: dtype {tensor.dtype} has no wire '
                             f'name')
    header = json.dumps(
        {n: {'dtype': _DTYPE_NAMES[tensors[n].dtype],
             'shape': list(tensors[n].shape)} for n in names},
        sort_keys=True).encode()
    parts = [len(header).to_bytes(4, 'big'), header]
    for name in names:
        parts.append(tensors[name].reshape(-1).view(torch.uint8)
                     .numpy().tobytes())
    return b''.join(parts)


def unpack_arrays(data: bytes) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`pack_arrays`: host tensors (copies; the
    payload is not aliased)."""
    hlen = int.from_bytes(data[:4], 'big')
    header = json.loads(data[4:4 + hlen])
    out: Dict[str, torch.Tensor] = {}
    offset = 4 + hlen
    for name in sorted(header):
        spec = header[name]
        dtype = _DTYPES.get(spec['dtype'])
        if dtype is None:
            raise ValueError(f'{name}: unknown wire dtype '
                             f'{spec["dtype"]!r}')
        shape = [int(dim) for dim in spec['shape']]
        count = 1
        for dim in shape:
            count *= dim
        nbytes = torch.empty((), dtype=dtype).element_size() * count
        if offset + nbytes > len(data):
            raise ValueError(f'payload is {len(data)}B but header '
                             f'describes more')
        if nbytes:
            out[name] = torch.frombuffer(
                bytearray(data[offset:offset + nbytes]),
                dtype=dtype).reshape(shape)
        else:
            out[name] = torch.empty(shape, dtype=dtype)
        offset += nbytes
    if offset != len(data):
        raise ValueError(
            f'payload is {len(data)}B but header describes {offset}B')
    return out


# -- the export (prefill side) -----------------------------------------


@dataclasses.dataclass
class KvExport:
    """One finished prefill parked for migration. ``blocks`` holds the
    serialized payload of every FULL block (chain order, aligned with
    ``digests``); ``tail`` is the engine's opaque tail state (partial
    block KV + last-logits row + resume metadata), ``meta`` the
    JSON-safe scalars the decode engine needs to resume the stream
    deterministically (seed, lengths)."""
    request_id: str
    ids: List[int]
    block_size: int
    digests: List[int]
    blocks: List[bytes]
    tail: bytes
    meta: Dict[str, Any]
    created: float = 0.0

    def __post_init__(self) -> None:
        if len(self.digests) != len(self.blocks):
            raise ValueError(
                f'{len(self.digests)} digests for '
                f'{len(self.blocks)} block payloads')
        self.block_sha = [_sha256(b) for b in self.blocks]
        self.tail_sha = _sha256(self.tail)

    def manifest(self) -> Dict[str, Any]:
        """The delta manifest: everything the decode side needs to
        plan the pull — no payload bytes."""
        return {
            'request_id': self.request_id,
            'block_size': self.block_size,
            'n_tokens': len(self.ids),
            'blocks': [
                {'digest': d, 'sha256': s, 'nbytes': len(b)}
                for d, s, b in zip(self.digests, self.block_sha,
                                   self.blocks)],
            'tail': {'sha256': self.tail_sha, 'nbytes': len(self.tail)},
            'meta': self.meta,
        }


class KvExporter:
    """The prefill replica's parking lot: finished prefills awaiting
    their decode-side pull, keyed by request id. Thread-safe (the
    serving loop puts, the HTTP thread reads, the handoff ack pops)."""

    def __init__(self) -> None:
        self._exports: Dict[str, KvExport] = {}
        self._lock = threading.Lock()

    def put(self, export: KvExport) -> None:
        with self._lock:
            self._exports[export.request_id] = export

    def get(self, request_id: str) -> KvExport:
        with self._lock:
            export = self._exports.get(request_id)
        if export is None:
            raise KeyError(request_id)
        return export

    def pop(self, request_id: str) -> Optional[KvExport]:
        """Release a completed (or abandoned) export. Idempotent."""
        with self._lock:
            return self._exports.pop(request_id, None)

    def request_ids(self) -> List[str]:
        with self._lock:
            return sorted(self._exports)

    def __len__(self) -> int:
        with self._lock:
            return len(self._exports)


# -- the HTTP surface (mounted by the prefill replica) -----------------


def handle_kv_get(path: str, exporter: KvExporter,
                  range_header: Optional[str] = None
                  ) -> Tuple[int, Dict[str, str], bytes]:
    """Shared GET handler for the prefill side's migration surface:

    * ``/kv/manifest/<request_id>`` — the delta manifest (JSON);
    * ``/kv/block/<request_id>/<digest>`` — one block's payload bytes
      (Range-resumable, sha256 in ``X-Skyt-Kv-Sha256``);
    * ``/kv/tail/<request_id>`` — the opaque tail payload.

    Returns ``(status, headers, body)``; mounted by the payload server
    and :class:`KvServer`. An injected push fault surfaces as a 503
    with ``Retry-After`` — the realistic shape of a prefill replica
    shedding load — so chaos drills exercise the puller's
    backpressure floor, not a synthetic stack trace."""
    try:
        fault_injection.inject(PUSH_SITE)
    except Exception as e:  # noqa: BLE001 — any injected fault sheds
        return (503, {'Retry-After': '0'},
                json.dumps({'error': f'shedding: {e}'}).encode())
    parts = path.strip('/').split('/')
    if len(parts) < 3 or parts[0] != 'kv':
        return 404, {}, b'{"error": "not found"}'
    kind, request_id = parts[1], parts[2]
    try:
        export = exporter.get(request_id)
    except KeyError:
        return 404, {}, b'{"error": "unknown request"}'
    if kind == 'manifest' and len(parts) == 3:
        body = json.dumps(export.manifest(), sort_keys=True).encode()
        return 200, {'Content-Type': 'application/json'}, body
    if kind == 'tail' and len(parts) == 3:
        payload, sha = export.tail, export.tail_sha
    elif kind == 'block' and len(parts) == 4:
        try:
            index = export.digests.index(int(parts[3]))
        except ValueError:
            return 404, {}, b'{"error": "unknown block digest"}'
        payload, sha = export.blocks[index], export.block_sha[index]
    else:
        return 404, {}, b'{"error": "not found"}'
    size = len(payload)
    offset = _parse_range(range_header)
    if offset > size:
        offset = 0
    body = payload[offset:]
    metrics.KV_MIGRATE_BYTES.inc(len(body), direction='push')
    headers = {'Content-Type': 'application/octet-stream',
               _SHA_HEADER: sha}
    if offset:
        headers['Content-Range'] = f'bytes {offset}-{size - 1}/{size}'
        return 206, headers, body
    return 200, headers, body


def handle_kv_release(path: str, exporter: KvExporter
                      ) -> Tuple[int, Dict[str, str], bytes]:
    """POST ``/kv/release/<request_id>`` — the decode side committed
    its import; the prefill side frees the parked export (and, in the
    engine, the slot's blocks). Idempotent: releasing an unknown id is
    200 (the pull may race a prefill-side timeout sweep)."""
    parts = path.strip('/').split('/')
    if len(parts) != 3 or parts[:2] != ['kv', 'release']:
        return 404, {}, b'{"error": "not found"}'
    exporter.pop(parts[2])
    return 200, {'Content-Type': 'application/json'}, b'{"ok": true}'


def _parse_range(header: Optional[str]) -> int:
    """Start offset of a ``bytes=N-`` header (the only form pullers
    send); anything else reads as 0 — the puller's digest check still
    holds."""
    if not header or not header.startswith('bytes='):
        return 0
    spec = header[len('bytes='):].split(',')[0].strip()
    try:
        return max(0, int(spec.split('-')[0]))
    except ValueError:
        return 0


class KvServer:
    """Standalone migration HTTP server over one exporter — what tests
    and benches stand up in place of a full prefill replica (the real
    replica mounts the same handlers on its inference server)."""

    def __init__(self, exporter: KvExporter) -> None:
        self.exporter = exporter
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def _reply(self, status, headers, body):
                self.send_response(status)
                for k, v in headers.items():
                    self.send_header(k, v)
                self.send_header('Content-Length', str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 (stdlib casing)
                self._reply(*handle_kv_get(
                    self.path, outer.exporter, self.headers.get('Range')))

            def do_POST(self):  # noqa: N802 (stdlib casing)
                self._reply(*handle_kv_release(self.path, outer.exporter))

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

    def __enter__(self) -> 'KvServer':
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()


# -- pull sources (decode side) ----------------------------------------


class HTTPKvSource:
    """Fetches manifests and payloads from a prefill replica's ``/kv``
    surface. Connection errors and timeouts surface as
    :class:`MigrationUnavailable`; 429/503 additionally carry the
    server's Retry-After floor."""

    def __init__(self, endpoint: str,
                 timeout: Optional[float] = None) -> None:
        self.endpoint = endpoint.rstrip('/')
        if timeout is None:
            timeout = env.get_float('SKYT_KV_MIGRATE_TIMEOUT')
        self.timeout = timeout
        self.name = f'kv:{self.endpoint}'

    def fetch_manifest(self, request_id: str) -> Dict[str, Any]:
        body = b''.join(self._get(f'/kv/manifest/{request_id}', 0))
        try:
            return json.loads(body)
        except ValueError as e:
            raise MigrationUnavailable(
                f'{self.name}: bad manifest: {e}') from None

    def fetch_block(self, request_id: str, digest: int,
                    offset: int) -> Iterator[bytes]:
        return self._get(f'/kv/block/{request_id}/{digest}', offset)

    def fetch_tail(self, request_id: str,
                   offset: int) -> Iterator[bytes]:
        return self._get(f'/kv/tail/{request_id}', offset)

    def release(self, request_id: str) -> None:
        """Best-effort handoff ack — the prefill side also sweeps
        abandoned exports, so a lost ack leaks nothing permanent."""
        req = urllib.request.Request(
            f'{self.endpoint}/kv/release/{request_id}', data=b'',
            method='POST')
        try:
            with urllib.request.urlopen(req, timeout=self.timeout):
                pass
        except (urllib.error.URLError, TimeoutError, OSError,
                ConnectionError):
            pass

    def _get(self, path: str, offset: int) -> Iterator[bytes]:
        fault_injection.inject(PULL_SITE)
        req = urllib.request.Request(self.endpoint + path)
        if offset:
            req.add_header('Range', f'bytes={offset}-')
        try:
            with urllib.request.urlopen(req,
                                        timeout=self.timeout) as resp:
                if resp.status not in (200, 206):
                    raise MigrationUnavailable(
                        f'{self.name}: HTTP {resp.status}')
                if resp.status == 200 and offset:
                    # Source ignored Range: discard the prefix so the
                    # resume offset stays truthful.
                    resp.read(offset)
                while True:
                    chunk = resp.read(_CHUNK)
                    if not chunk:
                        return
                    yield chunk
        except urllib.error.HTTPError as e:
            raise MigrationUnavailable(
                f'{self.name}: HTTP {e.code}',
                retry_after=_retry_after(e)) from None
        except (urllib.error.URLError, TimeoutError, OSError,
                ConnectionError) as e:
            raise MigrationUnavailable(f'{self.name}: {e}') from None


def _retry_after(error: urllib.error.HTTPError) -> float:
    if error.code not in (429, 503):
        return 0.0
    value = (error.headers.get('Retry-After') or '').strip()
    try:
        return max(0.0, float(value))
    except ValueError:
        return 0.0


class LocalKvSource:
    """Test/bench seam: serves straight from an in-process exporter.
    ``mutate(kind, key, data) -> bytes`` models a corrupt source
    (kind is ``'block'``/``'tail'``, key the digest or request id)."""

    def __init__(self, exporter: KvExporter,
                 mutate: Optional[Callable[[str, Any, bytes],
                                           bytes]] = None) -> None:
        self._exporter = exporter
        self._mutate = mutate
        self.name = 'kv:local'

    def _lookup(self, request_id: str) -> KvExport:
        try:
            return self._exporter.get(request_id)
        except KeyError:
            raise MigrationUnavailable(
                f'{self.name}: unknown request {request_id}') from None

    def fetch_manifest(self, request_id: str) -> Dict[str, Any]:
        fault_injection.inject(PULL_SITE)
        return self._lookup(request_id).manifest()

    def fetch_block(self, request_id: str, digest: int,
                    offset: int) -> Iterator[bytes]:
        fault_injection.inject(PULL_SITE)
        export = self._lookup(request_id)
        try:
            data = export.blocks[export.digests.index(digest)]
        except ValueError:
            raise MigrationUnavailable(
                f'{self.name}: unknown block {digest}') from None
        if self._mutate is not None:
            data = self._mutate('block', digest, data)
        yield from _chunks(data[offset:])

    def fetch_tail(self, request_id: str,
                   offset: int) -> Iterator[bytes]:
        fault_injection.inject(PULL_SITE)
        data = self._lookup(request_id).tail
        if self._mutate is not None:
            data = self._mutate('tail', request_id, data)
        yield from _chunks(data[offset:])

    def release(self, request_id: str) -> None:
        self._exporter.pop(request_id)


def _chunks(data: bytes) -> Iterator[bytes]:
    for i in range(0, len(data), _CHUNK):
        yield data[i:i + _CHUNK]


# -- the puller (decode side) ------------------------------------------


@dataclasses.dataclass
class PulledKv:
    """A verified migration: ``payloads`` aligns with
    ``manifest['blocks']`` — ``None`` where the block was resident on
    the decode side (nothing moved; the importer's prefix-cache hit
    already owns it)."""
    manifest: Dict[str, Any]
    payloads: List[Optional[bytes]]
    tail: bytes

    @property
    def moved(self) -> int:
        return sum(1 for p in self.payloads if p is not None)

    @property
    def resident(self) -> int:
        return sum(1 for p in self.payloads if p is None)


class KvPuller:
    """Pulls one export from a source, skipping blocks already
    resident on the decode side, verifying every payload, and
    honoring the source's backpressure. Raises
    :class:`MigrationUnavailable` when the source stays dead past the
    retry budget and :class:`BlockCorrupt` when a payload never
    passes its digest — both mapped to the re-prefill fallback by the
    decode engine, with the import transaction rolled back."""

    def __init__(self, source: Any, *, retries: Optional[int] = None,
                 sleep: Optional[Callable[[float], None]] = None) -> None:
        if retries is None:
            retries = env.get_int('SKYT_KV_MIGRATE_RETRIES')
        if sleep is None:
            sleep = time.sleep
        self._source = source
        self._retries = max(0, int(retries))
        self._sleep = sleep
        # Observability for tests/benches.
        self.corrupt_retries = 0
        self.unavailable_retries = 0

    def pull(self, request_id: str,
             resident_digests: Sequence[int] = ()) -> PulledKv:
        """Fetch the manifest, then every non-resident payload.
        ``resident_digests`` is the chain-digest prefix the decode
        engine matched (and increfed) in its own PrefixCache."""
        manifest = self._retrying(
            f'manifest:{request_id}',
            lambda: self._source.fetch_manifest(request_id))
        resident = set(resident_digests)
        payloads: List[Optional[bytes]] = []
        for row in manifest['blocks']:
            if row['digest'] in resident:
                metrics.KV_MIGRATE_BLOCKS.inc(outcome='resident')
                payloads.append(None)
                continue
            payloads.append(self._pull_payload(
                f'block:{row["digest"]}', row['sha256'], row['nbytes'],
                lambda offset, d=row['digest']: self._source.fetch_block(
                    request_id, d, offset)))
            metrics.KV_MIGRATE_BLOCKS.inc(outcome='moved')
        tail = self._pull_payload(
            'tail', manifest['tail']['sha256'],
            manifest['tail']['nbytes'],
            lambda offset: self._source.fetch_tail(request_id, offset))
        return PulledKv(manifest=manifest, payloads=payloads, tail=tail)

    # -- internals -----------------------------------------------------

    def _retrying(self, what: str, fn: Callable[[], Any]) -> Any:
        delays = resilience.backoff_delays(base=0.05, cap=2.0)
        attempts = 0
        while True:
            try:
                return fn()
            except (MigrationUnavailable, TimeoutError,
                    ConnectionError, OSError) as e:
                attempts += 1
                self.unavailable_retries += 1
                if attempts > self._retries:
                    raise
                delay = max(next(delays),
                            getattr(e, 'retry_after', 0.0))
                logger.warning(
                    'kv_migrate: %s unavailable (%s); retry %d/%d '
                    'in %.2fs', what, e, attempts, self._retries, delay)
                self._sleep(delay)

    def _pull_payload(self, what: str, sha256: str, nbytes: int,
                      fetch: Callable[[int], Iterator[bytes]]) -> bytes:
        """One payload, digest-verified: mid-stream death resumes at
        the byte reached; a digest mismatch discards everything (the
        partial prefix could be the corrupt part) and re-pulls from
        offset 0. A corrupt payload is never returned."""
        delays = resilience.backoff_delays(base=0.05, cap=2.0)
        attempts = 0
        buf = b''
        while True:
            try:
                for chunk in fetch(len(buf)):
                    buf += chunk
            except (MigrationUnavailable, TimeoutError,
                    ConnectionError, OSError) as e:
                attempts += 1
                self.unavailable_retries += 1
                if attempts > self._retries:
                    raise
                delay = max(next(delays),
                            getattr(e, 'retry_after', 0.0))
                logger.warning(
                    'kv_migrate: %s unavailable (%s); retry %d/%d '
                    'in %.2fs', what, e, attempts, self._retries, delay)
                self._sleep(delay)
                continue
            if len(buf) == nbytes and _sha256(buf) == sha256:
                metrics.KV_MIGRATE_BYTES.inc(len(buf), direction='pull')
                return buf
            attempts += 1
            self.corrupt_retries += 1
            metrics.KV_MIGRATE_BLOCKS.inc(outcome='corrupt_retry')
            if attempts > self._retries:
                raise BlockCorrupt(
                    f'{what}: got {_sha256(buf)[:12]}/{len(buf)}B, '
                    f'want {sha256[:12]}/{nbytes}B after '
                    f'{attempts} attempt(s)')
            logger.warning(
                'kv_migrate: %s failed digest; re-pulling from 0 '
                '(%d/%d)', what, attempts, self._retries)
            buf = b''
            self._sleep(next(delays))
