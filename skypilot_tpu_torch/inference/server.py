"""Inference HTTP server of the port: an engine over stdlib HTTP.

The port of ``skypilot_tpu/inference/server.py`` with the same payloads
and the same two engines: ``--engine batch`` (the default, the
monolithic ``InferenceEngine``) and ``--engine continuous`` (the
continuous-batching engine)::

    python -m skypilot_tpu_torch.inference.server --model llama3-8b \
        [--engine continuous] [--quantize] [--quantize-kv]

Endpoints:
    GET  /health     -> 200 {"status": "ok", "model": ...}
    GET  /stats      -> engine counters (JSON)
    POST /generate   -> {"prompts": [...], "max_new_tokens": N,
                         "temperature": t} -> {"outputs": [...]}

``/metrics``, the OpenAI-compatible routes, streaming over HTTP and the
other flags of the reference server are later slices.
"""
from __future__ import annotations

import argparse
import json
import logging
import sys
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

logger = logging.getLogger(__name__)


def make_handler(engine):

    class Handler(BaseHTTPRequestHandler):
        protocol_version = 'HTTP/1.1'

        def log_message(self, fmt, *args):  # quiet
            logger.debug(fmt, *args)

        def _json(self, code: int, payload) -> None:
            body = json.dumps(payload).encode('utf-8')
            self.send_response(code)
            self.send_header('Content-Type', 'application/json')
            self.send_header('Content-Length', str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == '/health':
                self._json(200, {'status': 'ok', 'model': engine.cfg.name})
            elif self.path == '/stats':
                stats = engine.stats
                self._json(200, stats() if callable(stats) else stats)
            else:
                self._json(404, {'error': 'not found'})

        def do_POST(self):
            try:
                length = int(self.headers.get('Content-Length', 0))
                req = json.loads(self.rfile.read(length) or b'{}')
                if self.path == '/generate':
                    self._generate(req)
                else:
                    self._json(404, {'error': 'not found'})
            except Exception as e:  # pylint: disable=broad-except
                logger.error('generate failed: %s', e, exc_info=True)
                try:
                    self._json(500, {'error': str(e)})
                except (BrokenPipeError, ConnectionResetError):
                    pass

        def _generate(self, req):
            prompts = req.get('prompts') or [req.get('prompt', '')]
            kwargs = dict(max_new_tokens=int(req.get('max_new_tokens', 32)),
                          temperature=float(req.get('temperature', 0.0)),
                          seed=int(req.get('seed', 0)))
            if hasattr(engine, 'generate_texts'):   # continuous engine
                outputs = engine.generate_texts(prompts, **kwargs)
            else:                                   # batch engine
                outputs = engine.generate_text(prompts, **kwargs)
            self._json(200, {'outputs': outputs})

    return Handler


def serve(engine, host: str, port: int) -> ThreadingHTTPServer:
    server = ThreadingHTTPServer((host, port), make_handler(engine))
    logger.info('Inference server for %s on %s:%d', engine.cfg.name, host,
                server.server_address[1])
    return server


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument('--model', default='tiny')
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
    parser.add_argument('--quantize', action='store_true',
                        help='int8 W8A8 weights (per-channel weights, '
                             'per-token activations).')
    parser.add_argument('--quantize-kv', action='store_true',
                        help='int8 KV cache (dequantized inside the '
                             'attention kernel).')
    args = parser.parse_args(argv)
    if args.engine == 'continuous':
        from skypilot_tpu_torch.inference.continuous import (
            ContinuousBatchingEngine)
        engine = ContinuousBatchingEngine(
            args.model,
            device=args.device,
            max_slots=args.max_batch,
            max_len=args.max_len,
            block_size=args.block_size,
            prefill_chunk=args.prefill_chunk,
            num_blocks=args.kv_blocks,
            quantize=args.quantize,
            quantize_kv=args.quantize_kv)
        engine.generate_text('warmup', max_new_tokens=8)
    else:
        from skypilot_tpu_torch.inference.engine import InferenceEngine
        engine = InferenceEngine(args.model,
                                 device=args.device,
                                 max_batch=args.max_batch,
                                 quantize=args.quantize,
                                 quantize_kv=args.quantize_kv)
        engine.generate_text(['warmup'], max_new_tokens=8)
    server = serve(engine, args.host, args.port)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        if hasattr(engine, 'shutdown'):
            engine.shutdown()
    return 0


if __name__ == '__main__':
    sys.exit(main())
