"""Inference HTTP server of the port: an engine over stdlib HTTP.

The port of ``skypilot_tpu/inference/server.py`` with the same payloads
and the same two engines: ``--engine batch`` (the default, the
monolithic ``InferenceEngine``) and ``--engine continuous`` (the
continuous-batching engine, with speculative decoding, multi-LoRA
adapters and disaggregated roles as options)::

    python -m skypilot_tpu_torch.inference.server --model llama3-8b \
        [--engine continuous] [--quantize] [--quantize-kv] \
        [--spec-decode] [--draft-k 4] \
        [--lora-pages 4] [--lora-max-rank 16] [--lora-dir DIR] \
        [--role prefill|decode]
    python -m skypilot_tpu_torch.inference.server --hf-checkpoint DIR \
        [--engine continuous] [--lora-pages 4 --lora-dir REG]
    python -m skypilot_tpu_torch.inference.server --engine continuous \
        --policy-store STORE
    python -m skypilot_tpu_torch.inference.server --model llama3-8b \
        --mesh tensor=2 [--engine continuous] [--lora-pages 4 \
        --lora-dir REG] [--policy-store STORE]

``--hf-checkpoint`` serves an HF directory's weights (bf16) with its own
tokenizer and chat template; ``--checkpoint-dir`` serves the newest step
of a training checkpoint. With ``--lora-dir``, the served checkpoint's
content digest is the base every adapter must have been trained on.

Endpoints:
    GET  /health               -> 200 {"status": "ok", "model": ...}
    GET  /stats                -> engine counters (JSON)
    GET  /metrics              -> the same counters, Prometheus text
    GET  /adapters             -> per-adapter demand and residency
    POST /generate             -> {"prompts": [...], "max_new_tokens":
                                   N, "temperature": t, "adapter": a}
                                  -> {"outputs": [...]}
    POST /v1/completions       -> OpenAI-compatible, streamed as SSE
    POST /v1/chat/completions     with "stream": true (continuous
                                  engine only)
    POST /disagg/prefill       -> {"request_id": id, "n_tokens": n}
                                  (prefill role: hop 1 of the serve
                                  load balancer's two-hop route)
    GET  /kv/manifest|block|tail/<id>  (prefill role: the KV export)
    POST /kv/release/<id>      -> drop a pulled export
    GET  /fanout/manifest      -> the committed weights manifest of
    GET  /fanout/shard/<sha>      ``SKYT_FANOUT_DIR``, and its shards
                                  (Range-resumable): what sibling
                                  replicas pull (``data/fanout.py``)

A request picks its LoRA adapter with the JSON ``adapter`` field or the
``X-Skyt-Adapter`` header. Disaggregated serving (``--role``): the load
balancer sends the client's body to a prefill replica's
``/disagg/prefill`` (``X-Skyt-Disagg-Path`` names the API it was sent
to), then to a decode replica with ``X-Skyt-Kv-Request-Id`` and
``X-Skyt-Kv-Endpoint``: the decode replica pulls the KV
(``inference/kv_migrate.py``) and decodes without a prefill pass, or
prefills locally when the pull fails.

``--policy-store STORE`` (or ``SKYT_RL_STORE``; continuous engine)
serves an RL pipeline's policy store (``jobs/rl_pipeline.py``): the
committed policy is pulled before the first request, then the store is
polled every ``SKYT_RL_EVAL_POLL_S`` seconds and each newer version's
shard delta refreshes the engine in place.

A ``traceparent`` header (W3C; forwarded by the serve load balancer)
makes the continuous engine record its ``infer.*`` spans into the
caller's trace when ``SKYT_TRACE_SAMPLE`` arms tracing
(``utils/tracing.py``).

``--mesh tensor=N`` serves tensor-parallel (``inference/sharding.py``):
the server starts its own N ranks (``parallel/launch.py``), each builds
the engine on its shard, rank 0 (the driver) serves HTTP and the others
follow its step plans; ``/stats`` names the mesh, the process-group
backend and each rank's device. Stopping the server (SIGTERM, Ctrl-C)
stops every rank. Every continuous-engine flag serves under the mesh:
``--lora-dir`` registers its adapters and ``--policy-store`` polls the
store on the driver alone, whose plans the other ranks follow.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from skypilot_tpu_torch.data import fanout
from skypilot_tpu_torch.inference import kv_migrate
from skypilot_tpu_torch.server.metrics import INFERENCE_COUNTER_STATS
from skypilot_tpu_torch.utils import env, tracing

logger = logging.getLogger(__name__)


def metrics_text(stats) -> str:
    """Prometheus text of an engine's stats: the keys of
    ``INFERENCE_COUNTER_STATS`` are counters named
    ``skyt_inference_<key>_total``, every other number a gauge
    ``skyt_inference_<key>`` (a gauge key ending ``_total`` is the
    pool's capacity and is renamed ``..._capacity``)."""
    lines = []
    for key, value in sorted(stats.items()):
        if isinstance(value, (int, float)):
            kind = 'counter' if key in INFERENCE_COUNTER_STATS else 'gauge'
            if kind == 'gauge' and key.endswith('_total'):
                key = key[:-len('_total')] + '_capacity'
            name = f'skyt_inference_{key}'
            if kind == 'counter':
                name += '_total'
            lines.append(f'# TYPE {name} {kind}')
            lines.append(f'{name} {value}')
    return '\n'.join(lines) + '\n'


def make_handler(engine):

    class Handler(BaseHTTPRequestHandler):
        protocol_version = 'HTTP/1.1'

        def log_message(self, fmt, *args):  # quiet
            logger.debug(fmt, *args)

        def _json(self, code: int, payload) -> None:
            self._body(code, json.dumps(payload).encode('utf-8'),
                       'application/json')

        def _body(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header('Content-Type', ctype)
            self.send_header('Content-Length', str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _stats(self):
            stats = engine.stats
            return stats() if callable(stats) else stats

        def _adapter_kwargs(self, req):
            """Per-tenant LoRA adapter: the JSON ``adapter`` field or
            the ``X-Skyt-Adapter`` header. Continuous engines only; the
            engine rejects unknown adapters with a clean error."""
            adapter = (req.get('adapter') or
                       self.headers.get('X-Skyt-Adapter') or '')
            if adapter and hasattr(engine, 'register_adapter'):
                return {'adapter': str(adapter)}
            return {}

        def _trace_kwargs(self):
            """Incoming ``traceparent`` (forwarded by the serve LB) ->
            the engine's ``trace_ctx``, so the queue-wait, prefill and
            decode spans join the caller's distributed trace. Continuous
            engine only: the batch engine has no per-request
            lifecycle."""
            if not tracing.armed() or not hasattr(engine, 'stream_ids'):
                return {}
            ctx = tracing.parse_traceparent(
                self.headers.get(tracing.TRACEPARENT_HEADER))
            return {'trace_ctx': ctx} if ctx is not None else {}

        def do_GET(self):
            if self.path == '/health':
                self._json(200, {'status': 'ok', 'model': engine.cfg.name})
            elif self.path == '/stats':
                self._json(200, self._stats())
            elif self.path == '/adapters':
                stats_fn = getattr(engine, 'adapter_stats', None)
                self._json(200, stats_fn() if stats_fn else {})
            elif self.path == '/metrics':
                self._body(200, metrics_text(self._stats()).encode(),
                           'text/plain; version=0.0.4')
            elif self.path.startswith('/kv/'):
                # The KV-migration surface (prefill role only): the
                # decode fleet pulls manifests, blocks and tails here.
                exporter = getattr(engine, 'exporter', None)
                if exporter is None:
                    self._json(404, {'error': 'not a prefill replica'})
                    return
                status, headers, body = kv_migrate.handle_kv_get(
                    self.path, exporter,
                    range_header=self.headers.get('Range'))
                self.send_response(status)
                for key, value in headers.items():
                    self.send_header(key, value)
                self.send_header('Content-Length', str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path.startswith('/fanout/'):
                # Peer weight serving: sibling replicas pull committed
                # shards from here instead of the bucket (the weights
                # dir is SKYT_FANOUT_DIR).
                status, headers, body = fanout.handle_peer_get(
                    self.path, range_header=self.headers.get('Range'))
                ctype = headers.pop('Content-Type', 'application/json')
                self.send_response(status)
                for key, value in headers.items():
                    self.send_header(key, value)
                self.send_header('Content-Type', ctype)
                self.send_header('Content-Length', str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._json(404, {'error': 'not found'})

        def do_POST(self):
            try:
                length = int(self.headers.get('Content-Length', 0))
                req = json.loads(self.rfile.read(length) or b'{}')
                if self.path == '/generate':
                    self._generate(req)
                elif self.path == '/v1/completions':
                    self._openai(req, chat=False)
                elif self.path == '/v1/chat/completions':
                    self._openai(req, chat=True)
                elif self.path == '/disagg/prefill':
                    self._disagg_prefill(req)
                elif self.path.startswith('/kv/release/'):
                    exporter = getattr(engine, 'exporter', None)
                    if exporter is None:
                        self._json(404,
                                   {'error': 'not a prefill replica'})
                        return
                    status, _headers, body = kv_migrate.handle_kv_release(
                        self.path, exporter)
                    self._body(status, body, 'application/json')
                else:
                    self._json(404, {'error': 'not found'})
            except Exception as e:  # pylint: disable=broad-except
                logger.error('generate failed: %s', e, exc_info=True)
                try:
                    self._json(500, {'error': str(e)})
                except (BrokenPipeError, ConnectionResetError):
                    pass

        # -- disaggregated serving ----------------------------------------

        def _prompt_ids(self, path, req):
            """Token ids of the request's single prompt, derived the same
            way on the prefill and the decode replica (both run this code
            over the same body); the import cross-checks chain digests,
            so a divergence falls back to a local re-prefill. None for
            shapes the two-hop route does not carry (several prompts)."""
            tok = engine.tokenizer
            if path == '/v1/chat/completions':
                prompt = tok.apply_chat_template(req.get('messages') or [])
                add_bos = not getattr(tok, 'chat_template', None)
            elif path == '/v1/completions':
                prompt = req.get('prompt', '')
                if isinstance(prompt, list):
                    prompt = prompt[0] if prompt else ''
                add_bos = True
            else:  # /generate
                prompts = req.get('prompts') or [req.get('prompt', '')]
                if len(prompts) != 1:
                    return None
                prompt = prompts[0]
                add_bos = True
            return tok.encode(prompt, add_bos=add_bos)

        def _disagg_prefill(self, req):
            """Hop 1 of the two-hop route: absorb the prompt and park its
            KV for the decode fleet's pull. The body is the client's;
            ``X-Skyt-Disagg-Path`` says which API to parse it as."""
            if getattr(engine, 'role', '') != 'prefill':
                self._json(400, {'error': 'not a prefill replica'})
                return
            path = self.headers.get('X-Skyt-Disagg-Path', '/generate')
            ids = self._prompt_ids(path, req)
            if ids is None:
                self._json(400, {'error': 'not a single-prompt request'})
                return
            request_id = engine.prefill_and_export(
                ids, temperature=float(req.get('temperature') or 0.0),
                seed=int(req.get('seed') or 0), **self._trace_kwargs())
            self._json(200, {'request_id': request_id,
                             'n_tokens': len(ids)})

        def _migrated_request(self, ids, kwargs):
            """Hop 2: when the prefill hop stamped this request with a KV
            export (``X-Skyt-Kv-*`` headers), pull the delta and enter
            decode directly. None: the caller prefills locally (a dead
            prefill replica or a failed pull costs latency, never the
            request). A pulled export is released at once. Requests that
            name an adapter prefill locally (exports are base-model
            chains) and release the export unread."""
            request_id = self.headers.get('X-Skyt-Kv-Request-Id')
            endpoint = self.headers.get('X-Skyt-Kv-Endpoint')
            if (not request_id or not endpoint or ids is None or
                    not hasattr(engine, 'submit_migrated') or
                    getattr(engine, 'role', '') == 'prefill'):
                return None
            try:
                source = kv_migrate.HTTPKvSource(endpoint)
                pulled = None
                if not kwargs.get('adapter'):
                    handoff_start = time.monotonic()
                    pulled = kv_migrate.KvPuller(source).pull(
                        request_id,
                        resident_digests=engine.probe_resident(ids))
                source.release(request_id)
                if pulled is None:
                    return None
                return engine.submit_migrated(
                    ids, pulled, handoff_start=handoff_start, **kwargs)
            except Exception as e:  # pylint: disable=broad-except
                logger.warning(
                    'KV pull for %s failed (%s: %s); falling back to '
                    'local prefill', request_id, type(e).__name__, e)
                return None

        def _generate(self, req):
            prompts = req.get('prompts') or [req.get('prompt', '')]
            kwargs = dict(max_new_tokens=int(req.get('max_new_tokens', 32)),
                          temperature=float(req.get('temperature', 0.0)),
                          seed=int(req.get('seed', 0)))
            if hasattr(engine, 'generate_texts'):   # continuous engine
                kwargs.update(self._trace_kwargs())
                kwargs.update(self._adapter_kwargs(req))
                tok = engine.tokenizer
                migrated = self._migrated_request(
                    self._prompt_ids('/generate', req),
                    dict(eos_id=tok.eos_id, **kwargs))
                if migrated is not None:
                    out_ids = list(engine.tail_tokens(migrated,
                                                      eos_id=tok.eos_id))
                    self._json(200, {'outputs': [tok.decode(out_ids)]})
                    return
                outputs = engine.generate_texts(prompts, **kwargs)
            else:                                   # batch engine
                outputs = engine.generate_text(prompts, **kwargs)
            self._json(200, {'outputs': outputs})

        # -- OpenAI-compatible surface ------------------------------------

        def _openai(self, req, chat: bool):
            tok = engine.tokenizer
            # A templated chat prompt renders its own BOS; encoding must
            # not prepend a second one.
            add_bos = True
            if chat:
                prompt = tok.apply_chat_template(req.get('messages') or [])
                add_bos = not getattr(tok, 'chat_template', None)
            else:
                prompt = req.get('prompt', '')
                if isinstance(prompt, list):
                    prompt = prompt[0] if prompt else ''
            # `null` is how OpenAI clients spell "default".
            max_tokens = int(req.get('max_tokens') or 64)
            kwargs = dict(max_new_tokens=max_tokens,
                          temperature=float(req.get('temperature') or 0.0))
            kwargs.update(self._trace_kwargs())
            kwargs.update(self._adapter_kwargs(req))
            rid = f'cmpl-{os.urandom(8).hex()}'
            model = engine.cfg.name
            if req.get('stream'):
                if not hasattr(engine, 'stream_ids'):
                    # A silent JSON body would break SSE clients.
                    self._json(400, {
                        'error': 'stream=true requires the continuous '
                                 'engine (--engine continuous)'})
                    return
                self._openai_stream(rid, model, prompt, chat, kwargs,
                                    add_bos=add_bos)
                return
            ids = tok.encode(prompt, add_bos=add_bos)
            if hasattr(engine, 'generate_texts'):   # continuous engine
                migrated = self._migrated_request(
                    ids, dict(eos_id=tok.eos_id, **kwargs))
                if migrated is not None:
                    out_ids = list(engine.tail_tokens(migrated,
                                                      eos_id=tok.eos_id))
                else:
                    out_ids = engine.generate_ids(ids, eos_id=tok.eos_id,
                                                  **kwargs)
            else:                                   # batch engine
                out_ids = engine.generate_ids([ids], **kwargs)[0]
                if tok.eos_id in out_ids:
                    out_ids = out_ids[:out_ids.index(tok.eos_id)]
            text = tok.decode(out_ids)
            finish = 'length' if len(out_ids) >= max_tokens else 'stop'
            if chat:
                choice = {'index': 0, 'finish_reason': finish,
                          'message': {'role': 'assistant',
                                      'content': text}}
                obj = 'chat.completion'
            else:
                choice = {'index': 0, 'finish_reason': finish,
                          'text': text}
                obj = 'text_completion'
            self._json(200, {'id': rid, 'object': obj, 'model': model,
                             'created': int(time.time()),
                             'choices': [choice]})

        def _openai_stream(self, rid, model, prompt, chat, kwargs,
                           add_bos: bool = True):
            # Whatever can fail with a clean 500 happens BEFORE the 200
            # and the chunked headers go out.
            tok = engine.tokenizer
            ids = tok.encode(prompt, add_bos=add_bos)
            migrated = self._migrated_request(
                ids, dict(eos_id=tok.eos_id, **kwargs))
            if migrated is not None:
                # The first tokens stream as soon as the import lands: the
                # handoff is the time to first token, not a re-prefill.
                token_iter = engine.tail_tokens(migrated, eos_id=tok.eos_id)
            else:
                token_iter = engine.stream_ids(ids, eos_id=tok.eos_id,
                                               **kwargs)
            self.send_response(200)
            self.send_header('Content-Type', 'text/event-stream')
            self.send_header('Cache-Control', 'no-cache')
            self.send_header('Transfer-Encoding', 'chunked')
            self.end_headers()

            def send(obj_bytes: bytes) -> None:
                frame = b'data: ' + obj_bytes + b'\n\n'
                self.wfile.write(f'{len(frame):x}\r\n'.encode() +
                                 frame + b'\r\n')
                self.wfile.flush()

            created = int(time.time())
            obj = 'chat.completion.chunk' if chat else 'text_completion'

            def chunk(choice) -> bytes:
                return json.dumps({'id': rid, 'object': obj,
                                   'model': model, 'created': created,
                                   'choices': [choice]}).encode()

            try:
                out_ids, text_so_far = [], ''
                try:
                    for token in token_iter:
                        out_ids.append(token)
                        text = tok.decode(out_ids)
                        delta = text[len(text_so_far):]
                        text_so_far = text
                        if not delta:
                            continue
                        if chat:
                            choice = {'index': 0, 'finish_reason': None,
                                      'delta': {'content': delta}}
                        else:
                            choice = {'index': 0, 'finish_reason': None,
                                      'text': delta}
                        send(chunk(choice))
                    finish = ('length'
                              if len(out_ids) >= kwargs['max_new_tokens']
                              else 'stop')
                except Exception as e:  # pylint: disable=broad-except
                    # Mid-stream failure: the status line is gone; send
                    # an error frame and end the stream cleanly.
                    logger.error('stream failed: %s', e, exc_info=True)
                    send(json.dumps({'error': str(e)}).encode())
                    finish = None
                if finish is not None:
                    final = ({'index': 0, 'finish_reason': finish,
                              'delta': {}} if chat else
                             {'index': 0, 'finish_reason': finish,
                              'text': ''})
                    send(chunk(final))
                send(b'[DONE]')
                self.wfile.write(b'0\r\n\r\n')
                self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError):
                pass  # the client went away mid-stream

    return Handler


def watch_policy_store(engine, store_root: str,
                       poll_s: Optional[float] = None) -> threading.Thread:
    """Serve an RL pipeline's policy store live (continuous engine):
    pull the committed policy before returning (into an empty local
    copy the manifest diff is the whole tree), then poll the store from
    a daemon thread and refresh the engine in place with each newer
    version's shard delta, at a step boundary. A pull that races a
    publish is retried at the next poll. The local copy lives in a new
    temporary directory."""
    import tempfile

    from skypilot_tpu_torch.jobs.rl_pipeline import PolicyStore

    if poll_s is None:
        poll_s = env.get_float('SKYT_RL_EVAL_POLL_S', minimum=0.1)
    store = PolicyStore(store_root)
    dest = tempfile.mkdtemp(prefix='skyt-eval-policy-')
    served = [-1]

    def pull_once() -> bool:
        if store.version() in (None, served[0]):
            return False
        res = store.pull(dest)
        if res is None or res['version'] == served[0]:
            return False
        if res['updates']:
            engine.refresh_weights(updates=res['updates'],
                                   version=res['version'], mode='step')
        served[0] = res['version']
        logger.info('policy store %s: serving version %d (%d shards, '
                    '%d bytes pulled)', store_root, res['version'],
                    res['shards_pulled'], res['bytes_pulled'])
        return True

    pull_once()  # blocking: never serve the random-init weights

    def loop() -> None:
        while True:
            time.sleep(poll_s)
            try:
                pull_once()
            except Exception as e:  # pylint: disable=broad-except
                logger.warning('policy store poll failed: %s', e)

    thread = threading.Thread(target=loop, name='policy-store-watch',
                              daemon=True)
    thread.start()
    return thread


def serve(engine, host: str, port: int) -> ThreadingHTTPServer:
    server = ThreadingHTTPServer((host, port), make_handler(engine))
    logger.info('Inference server for %s on %s:%d', engine.cfg.name, host,
                server.server_address[1])
    return server


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument('--model', default='tiny')
    parser.add_argument('--checkpoint-dir', default=None,
                        help='training checkpoint directory '
                             '(train/checkpoint.py): serve the params of '
                             'its newest committed step.')
    parser.add_argument('--hf-checkpoint', default=None,
                        help='HF-layout checkpoint dir (config.json + '
                             'safetensors + tokenizer.json): serve its '
                             'weights with its own BPE tokenizer '
                             '(models/hf_interop.py).')
    parser.add_argument('--host', default='0.0.0.0')
    parser.add_argument('--port', type=int, default=8080)
    parser.add_argument('--device', default=None,
                        help="torch device (default cuda; 'cpu' runs on "
                             'the CPU).')
    parser.add_argument('--max-batch', type=int, default=8)
    parser.add_argument('--engine', default='batch',
                        choices=['batch', 'continuous'],
                        help='batch = one padded batch per request '
                             '(InferenceEngine); continuous = slot-based '
                             'continuous batching over a paged KV pool.')
    parser.add_argument('--max-len', type=int, default=None,
                        help='KV length per slot (continuous engine; '
                             'default: the model context).')
    parser.add_argument('--block-size', type=int, default=None,
                        help='paged KV block granularity in tokens '
                             '(default 16).')
    parser.add_argument('--prefill-chunk', type=int, default=None,
                        help='chunked-prefill budget in tokens per '
                             'decode step (default 64).')
    parser.add_argument('--kv-blocks', type=int, default=None,
                        help='total paged KV pool blocks (default sized '
                             'to max_batch * max_len).')
    parser.add_argument('--spec-decode', action='store_true', default=None,
                        help='speculative decoding (continuous engine): '
                             'n-gram drafts + one verify step per window; '
                             'greedy output equals the plain engine\'s '
                             '(default $SKYT_SPEC_DECODE).')
    parser.add_argument('--draft-k', type=int, default=None,
                        help='draft tokens per speculative verify step '
                             '(default $SKYT_SPEC_DRAFT_K or 4).')
    parser.add_argument('--quantize', action='store_true',
                        help='int8 W8A8 weights (per-channel weights, '
                             'per-token activations).')
    parser.add_argument('--quantize-kv', action='store_true',
                        help='int8 KV cache (dequantized inside the '
                             'attention kernel).')
    parser.add_argument('--lora-pages', type=int, default=None,
                        help='device adapter page slots for multi-LoRA '
                             'serving (continuous engine; default '
                             '$SKYT_LORA_PAGES or 0 = off). Each '
                             'resident adapter charges KV blocks from '
                             'the shared paged pool.')
    parser.add_argument('--lora-max-rank', type=int, default=None,
                        help='largest adapter rank the page stack holds '
                             '(default $SKYT_LORA_MAX_RANK or 8).')
    parser.add_argument('--lora-dir', default=None,
                        help='adapter registry root: every committed '
                             'adapter under it is registered at '
                             'startup.')
    parser.add_argument('--role', default=None,
                        choices=['prefill', 'decode'],
                        help='disaggregated serving role (continuous '
                             'engine; default $SKYT_DISAGG_ROLE): prefill '
                             'replicas export KV for the decode fleet to '
                             'pull, decode replicas import it and stream '
                             'tokens.')
    parser.add_argument('--mesh', default=None,
                        help="tensor-parallel serving, e.g. 'tensor=2': "
                             'the server starts one rank per shard and '
                             'rank 0 serves HTTP.')
    parser.add_argument('--policy-store', default=None,
                        help='RL-pipeline policy store to serve '
                             '(continuous engine; default '
                             '$SKYT_RL_STORE): pull the committed policy '
                             'before serving, then poll every '
                             '$SKYT_RL_EVAL_POLL_S seconds and refresh '
                             'the engine in place with the shard delta '
                             'of each newer version.')
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.mesh:
        return serve_mesh(args)
    engine = build_engine(args)
    run_server(engine, args)
    return 0


def run_server(engine, args) -> None:
    server = serve(engine, args.host, args.port)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        if hasattr(engine, 'shutdown'):
            engine.shutdown()


def serve_mesh(args) -> int:
    """``--mesh``: start one rank per shard of the mesh and serve from
    the driver rank until the server is stopped."""
    import math
    from skypilot_tpu_torch.parallel import launch
    from skypilot_tpu_torch.parallel.mesh import parse_mesh_spec
    from skypilot_tpu_torch.utils.device import resolve_device
    device = resolve_device(args.device)
    degrees = parse_mesh_spec(args.mesh).values()
    world = math.prod(d for d in degrees if d != -1)
    if -1 in degrees:
        if device.type != 'cuda':
            raise ValueError(f'mesh {args.mesh!r}: a -1 axis counts '
                             'GPUs; name the degree on the CPU')
        import torch
        world = max(torch.cuda.device_count() // world, 1) * world
    launch.launch(_serve_rank, world, args, device=device.type)
    return 0


def _serve_rank(rank: int, world: int, args) -> None:
    """One rank of ``--mesh``: the driver serves HTTP, the others follow
    its plans (both return when the server stops)."""
    del rank, world
    engine = build_engine(args)
    if engine.is_driver:
        run_server(engine, args)
    else:
        engine.follow()


def build_engine(args):
    """The engine ``main``'s flags ask for, adapters registered from
    ``--lora-dir``, warmed up by one short request."""
    if args.engine == 'continuous':
        from skypilot_tpu_torch.inference.continuous import (
            ContinuousBatchingEngine)
        base_digest = None
        if args.lora_dir:
            # Bind the served base to its content digest so adapter
            # registration can reject mispointed registries.
            from skypilot_tpu_torch.serve import adapter_registry
            ckpt = args.hf_checkpoint or args.checkpoint_dir
            if ckpt and os.path.isdir(ckpt):
                base_digest = adapter_registry.checkpoint_digest(ckpt)
        engine = ContinuousBatchingEngine(
            args.model,
            checkpoint_dir=args.checkpoint_dir,
            hf_checkpoint=args.hf_checkpoint,
            device=args.device,
            max_slots=args.max_batch,
            max_len=args.max_len,
            block_size=args.block_size,
            prefill_chunk=args.prefill_chunk,
            num_blocks=args.kv_blocks,
            quantize=args.quantize,
            quantize_kv=args.quantize_kv,
            mesh=args.mesh,
            spec_decode=args.spec_decode,
            draft_k=args.draft_k,
            lora_pages=args.lora_pages,
            lora_max_rank=args.lora_max_rank,
            role=args.role,
            base_digest=base_digest)
        # Under a mesh the driver alone holds the adapter registry and
        # polls the policy store: the followers write what its plans
        # announce.
        if args.lora_dir and engine.is_driver:
            from skypilot_tpu_torch.serve import adapter_registry
            names = adapter_registry.load_registry_into(engine,
                                                        args.lora_dir)
            logger.info('registered %d adapters from %s: %s', len(names),
                        args.lora_dir, names)
        policy_store = args.policy_store or env.get_str('SKYT_RL_STORE')
        if policy_store and engine.is_driver:
            watch_policy_store(engine, policy_store)
        if engine.is_driver and engine.role == 'prefill':
            # Warm the prefill path; drop the throwaway export.
            engine.exporter.pop(engine.prefill_and_export(
                engine.tokenizer.encode('warmup')))
        elif engine.is_driver:
            engine.generate_text('warmup', max_new_tokens=8)
    else:
        from skypilot_tpu_torch.inference.engine import InferenceEngine
        engine = InferenceEngine(args.model,
                                 checkpoint_dir=args.checkpoint_dir,
                                 hf_checkpoint=args.hf_checkpoint,
                                 device=args.device,
                                 max_batch=args.max_batch,
                                 quantize=args.quantize,
                                 quantize_kv=args.quantize_kv,
                                 mesh=args.mesh)
        if engine.is_driver:
            engine.generate_text(['warmup'], max_new_tokens=8)
    return engine


if __name__ == '__main__':
    sys.exit(main())
