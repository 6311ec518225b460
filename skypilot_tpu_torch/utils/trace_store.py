"""The durable per-trace span store: the port's copy of the write and
read halves of ``skypilot_tpu/utils/trace_store.py``.

Spans are appended as flock'd JSONL, one file per trace, at the
reference's path (``SKYT_TRACE_DIR``, else ``<server dir>/traces``
with the server dir ``SKYT_SERVER_DIR`` or ``$SKYT_STATE_DIR/server``,
default ``~/.skyt/server``), so the reference's readers (its API
server's trace view and critical path) find the port's spans beside
their own.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List

from skypilot_tpu_torch.utils import env


def traces_dir() -> str:
    override = env.get_str('SKYT_TRACE_DIR')
    if override:
        return os.path.expanduser(override)
    server = env.get_str('SKYT_SERVER_DIR') or os.path.join(
        os.path.expanduser(env.get_str('SKYT_STATE_DIR')), 'server')
    return os.path.join(server, 'traces')


def _valid_trace_id(trace_id: str) -> bool:
    return (len(trace_id) == 32 and
            all(c in '0123456789abcdef' for c in trace_id))


def trace_path(trace_id: str) -> str:
    if not _valid_trace_id(trace_id):
        raise ValueError(f'malformed trace id {trace_id!r}')
    return os.path.join(traces_dir(), f'{trace_id}.jsonl')


def append_spans(trace_id: str, spans: List[dict]) -> str:
    """flock'd JSONL append: concurrent writers interleave whole lines,
    never torn ones."""
    import fcntl
    path = trace_path(trace_id)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    payload = ''.join(json.dumps(s) + '\n' for s in spans)
    with open(path, 'a', encoding='utf-8') as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        f.write(payload)
        f.flush()
    return path


def load_trace(trace_id: str) -> List[dict]:
    """All spans of a trace, deduplicated by span_id (last write wins),
    in start order."""
    path = trace_path(trace_id)
    if not os.path.exists(path):
        return []
    by_id: Dict[str, dict] = {}
    with open(path, encoding='utf-8') as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                span = json.loads(line)
            except json.JSONDecodeError:
                continue  # torn tail line from a crashed writer
            if isinstance(span, dict) and span.get('span_id'):
                by_id[span['span_id']] = span
    return sorted(by_id.values(), key=lambda s: s.get('start', 0.0))
