"""Distributed request tracing: the port's copy of
``skypilot_tpu/utils/tracing.py``: trace identity, W3C ``traceparent``
propagation, head sampling and tail keep, with the same span records,
so the port's inference spans join the same traces as the reference's
processes and land in the same per-trace store
(``utils/trace_store.py``).

Sampling (arm with ``SKYT_TRACE_SAMPLE``; unset = tracing fully off,
near-zero overhead on every instrumented path):

* **Head sampling**: the keep decision is a pure function of
  ``trace_id`` and the rate, so every process reaches the same verdict
  without coordination.
* **Tail keep**: non-head-sampled spans are buffered in-process
  (bounded by ``SKYT_TRACE_BUFFER``); a span finishing with an error,
  or running past ``SKYT_TRACE_SLOW_MS``, promotes its whole buffered
  trace to the store.

Threading: the ambient context is a thread-local stack (``span(...)``
context managers push/pop); scheduler code that cannot use ambient
nesting creates explicit spans via :func:`start_span` /
:func:`record_span`. Never raises into callers: a broken store degrades
to dropped spans, not failed requests.
"""
from __future__ import annotations

import logging
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

from skypilot_tpu_torch.utils import env

logger = logging.getLogger(__name__)

SAMPLE_ENV = 'SKYT_TRACE_SAMPLE'
CONTEXT_ENV = 'SKYT_TRACE_CONTEXT'
TRACEPARENT_HEADER = 'traceparent'

_HEX = frozenset('0123456789abcdef')

_lock = threading.Lock()
_tls = threading.local()
# Non-head-sampled spans buffered per trace awaiting a tail trigger
# (error / slow). Bounded: oldest trace evicted past SKYT_TRACE_BUFFER
# total spans.
_buffers: 'Dict[str, List[dict]]' = {}
_buffered = 0
_dropped = 0
_service = 'python'
# Stable small per-thread lane ids (threading.get_ident() values are
# huge and reused; a modulo of them could put two threads in one
# timeline lane).
_tids: Dict[int, int] = {}


def set_service(name: str) -> None:
    """Process-wide service name stamped on spans (e.g. 'api-server',
    'executor', 'serve-lb', 'inference')."""
    global _service
    _service = name


def stable_tid() -> int:
    """Small, stable, per-process thread id (1, 2, 3, ...)."""
    ident = threading.get_ident()
    tid = _tids.get(ident)
    if tid is None:
        with _lock:
            tid = _tids.setdefault(ident, len(_tids) + 1)
    return tid


# -- arming + sampling --------------------------------------------------


def armed() -> bool:
    """Tracing records spans only when SKYT_TRACE_SAMPLE is set at all
    (even to 0 — rate 0 still buffers for tail-keep). Unset = the
    instrumentation reduces to one dict lookup per site."""
    return SAMPLE_ENV in os.environ


def sample_rate() -> float:
    rate = env.get_float(SAMPLE_ENV)
    return 0.0 if rate is None else rate


def head_keep(trace_id: str, rate: Optional[float] = None) -> bool:
    """Deterministic head-sampling verdict: a pure function of the
    trace id and the rate, so client, server, runner, and child all
    agree without coordination."""
    if rate is None:
        rate = sample_rate()
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    try:
        return int(trace_id[:8], 16) / 0x100000000 < rate
    except (ValueError, IndexError):
        return False


def slow_ms() -> float:
    return env.get_float('SKYT_TRACE_SLOW_MS')


def _buffer_cap() -> int:
    return env.get_int('SKYT_TRACE_BUFFER', minimum=1)


# -- identity + propagation --------------------------------------------


def new_trace_id() -> str:
    return os.urandom(16).hex()


def new_span_id() -> str:
    return os.urandom(8).hex()


class SpanContext(NamedTuple):
    trace_id: str
    span_id: str

    @classmethod
    def new_root(cls) -> 'SpanContext':
        return cls(new_trace_id(), new_span_id())

    def child(self) -> 'SpanContext':
        return SpanContext(self.trace_id, new_span_id())

    def to_traceparent(self) -> str:
        flags = '01' if head_keep(self.trace_id) else '00'
        return f'00-{self.trace_id}-{self.span_id}-{flags}'


def parse_traceparent(value: Optional[str]) -> Optional[SpanContext]:
    """W3C traceparent -> context; anything malformed reads as absent
    (a bad header from a foreign client must not break the request)."""
    if not value:
        return None
    parts = value.strip().split('-')
    if len(parts) != 4:
        return None
    _version, trace_id, span_id, _flags = parts
    if (len(trace_id) != 32 or len(span_id) != 16 or
            not _HEX.issuperset(trace_id) or
            not _HEX.issuperset(span_id) or
            trace_id == '0' * 32 or span_id == '0' * 16):
        return None
    return SpanContext(trace_id, span_id)


def ambient() -> Optional[SpanContext]:
    """The current thread's active span context, falling back to the
    process-inherited SKYT_TRACE_CONTEXT (how an executor child joins
    its request's trace)."""
    stack = getattr(_tls, 'stack', None)
    if stack:
        return stack[-1]
    return parse_traceparent(os.environ.get(CONTEXT_ENV))


def current_ids() -> Optional[Tuple[str, str]]:
    """(trace_id, span_id) of the ambient context, or None. Cheap when
    disarmed — the events bus calls this on every publish."""
    if not armed():
        return None
    ctx = ambient()
    return (ctx.trace_id, ctx.span_id) if ctx is not None else None


def _push(ctx: SpanContext) -> None:
    stack = getattr(_tls, 'stack', None)
    if stack is None:
        stack = _tls.stack = []
    stack.append(ctx)


def _pop() -> None:
    stack = getattr(_tls, 'stack', None)
    if stack:
        stack.pop()


# -- spans --------------------------------------------------------------


class Span:
    """One in-flight span; ``finish()`` routes it to the store/buffer.
    'ts' is wall clock (viewers align processes on it); the duration is
    measured on the monotonic clock (a wall-clock step cannot skew it)."""

    __slots__ = ('name', 'context', 'parent_id', 'service', 'start_wall',
                 '_start_mono', 'annotations', '_finished')

    def __init__(self, name: str, context: SpanContext,
                 parent_id: Optional[str],
                 service: Optional[str] = None, **annotations) -> None:
        self.name = name
        self.context = context
        self.parent_id = parent_id
        self.service = service or _service
        self.start_wall = time.time()
        self._start_mono = time.monotonic()
        self.annotations = {k: v for k, v in annotations.items()
                            if v is not None}
        self._finished = False

    def annotate(self, **kv) -> None:
        self.annotations.update(
            {k: v for k, v in kv.items() if v is not None})

    def traceparent(self) -> str:
        return self.context.to_traceparent()

    def finish(self, error: Optional[BaseException] = None,
               **annotations) -> None:
        if self._finished:
            return
        self._finished = True
        self.annotate(**annotations)
        dur_ms = (time.monotonic() - self._start_mono) * 1000.0
        record = {
            'trace_id': self.context.trace_id,
            'span_id': self.context.span_id,
            'parent_span_id': self.parent_id,
            'name': self.name,
            'service': self.service,
            'pid': os.getpid(),
            'tid': stable_tid(),
            'start': self.start_wall,
            'dur_ms': round(dur_ms, 3),
            'status': 'error' if error is not None else 'ok',
        }
        if error is not None:
            record['error'] = f'{type(error).__name__}: {error}'
        if self.annotations:
            record['annotations'] = {
                k: (v if isinstance(v, (int, float, bool)) else str(v))
                for k, v in self.annotations.items()}
        _sink(record)


def start_span(name: str, parent: Optional[SpanContext] = None,
               service: Optional[str] = None,
               **annotations) -> Optional[Span]:
    """Explicit span for event-loop / scheduler code (no ambient push).
    Returns None when tracing is disarmed — callers guard on it."""
    if not armed():
        return None
    ctx = (parent.child() if parent is not None
           else SpanContext.new_root())
    return Span(name, ctx, parent.span_id if parent else None,
                service=service, **annotations)


def record_span(name: str, parent: Optional[SpanContext],
                start_wall: float, dur_s: float,
                service: Optional[str] = None,
                error: Optional[str] = None, **annotations) -> None:
    """Record an already-measured span retroactively (e.g. the
    inference engine's queue-wait, known only at admission)."""
    if not armed() or parent is None:
        return
    record = {
        'trace_id': parent.trace_id,
        'span_id': new_span_id(),
        'parent_span_id': parent.span_id,
        'name': name,
        'service': service or _service,
        'pid': os.getpid(),
        'tid': stable_tid(),
        'start': start_wall,
        'dur_ms': round(max(0.0, dur_s) * 1000.0, 3),
        'status': 'error' if error else 'ok',
    }
    if error:
        record['error'] = error
    if annotations:
        record['annotations'] = {
            k: (v if isinstance(v, (int, float, bool)) else str(v))
            for k, v in annotations.items() if v is not None}
    _sink(record)


class span:
    """``with tracing.span('server.submit', payload=name) as sp:`` —
    creates a child of the ambient context (or a new root), makes
    itself ambient for the body, records on exit (exceptions mark the
    span errored AND propagate). No-op when disarmed."""

    _AMBIENT = object()

    def __init__(self, name: str, parent=_AMBIENT,
                 service: Optional[str] = None, **annotations) -> None:
        self._name = name
        self._parent = parent
        self._service = service
        self._annotations = annotations
        self._span: Optional[Span] = None

    def __enter__(self) -> 'span':
        if not armed():
            return self
        parent = (ambient() if self._parent is span._AMBIENT
                  else self._parent)
        self._span = start_span(self._name, parent=parent,
                                service=self._service,
                                **self._annotations)
        if self._span is not None:
            _push(self._span.context)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._span is None:
            return
        _pop()
        self._span.finish(error=exc)

    @property
    def context(self) -> Optional[SpanContext]:
        return self._span.context if self._span is not None else None

    def traceparent(self) -> Optional[str]:
        return self._span.traceparent() if self._span is not None \
            else None

    def annotate(self, **kv) -> None:
        if self._span is not None:
            self._span.annotate(**kv)


# -- collection ---------------------------------------------------------


def _sink(record: dict) -> None:
    """Route one finished span: head-sampled -> durable store now;
    otherwise buffer, promoting the whole trace on a tail trigger
    (error, or past the slow threshold)."""
    global _buffered, _dropped
    trace_id = record['trace_id']
    to_write: List[dict] = []
    with _lock:
        tail = (record['status'] == 'error' or
                record['dur_ms'] >= slow_ms())
        if head_keep(trace_id):
            to_write.append(record)
        elif tail:
            promoted = _buffers.pop(trace_id, [])
            _buffered -= len(promoted)
            to_write.extend(promoted)
            to_write.append(record)
        else:
            _buffers.setdefault(trace_id, []).append(record)
            _buffered += 1
            cap = _buffer_cap()
            while _buffered > cap and _buffers:
                oldest = next(iter(_buffers))
                evicted = _buffers.pop(oldest)
                _buffered -= len(evicted)
                _dropped += len(evicted)
    if to_write:
        _write(trace_id, to_write)


def flush(trace_id: str) -> None:
    """Force a trace's buffered spans into the store (used when another
    signal — e.g. a FAILED request row — says the trace matters)."""
    global _buffered
    with _lock:
        spans = _buffers.pop(trace_id, [])
        _buffered -= len(spans)
    if spans:
        _write(trace_id, spans)


def _write(trace_id: str, spans: List[dict]) -> None:
    try:
        from skypilot_tpu_torch.utils import trace_store
        trace_store.append_spans(trace_id, spans)
    except Exception as e:  # pylint: disable=broad-except
        logger.debug('trace store append failed for %s: %s', trace_id, e)


def dropped_spans() -> int:
    return _dropped


def reset_for_tests() -> None:
    global _buffered, _dropped, _service
    with _lock:
        _buffers.clear()
        _buffered = 0
        _dropped = 0
        _service = 'python'
    if getattr(_tls, 'stack', None):
        _tls.stack = []
