"""Deterministic fault injection for chaos tests: the port's copy of
``skypilot_tpu/utils/fault_injection.py``, with the same spec syntax and
the same draws, so one ``SKYT_FAULT_SPEC`` drives both packages. The
port has no Postgres client: a clause naming ``PgError`` is refused
(``ValueError``), as any unknown exception is.

``SKYT_FAULT_SPEC`` holds comma-separated clauses::

    <site>:<Exception>[:p=<float>][:seed=<int>][:times=<int>]

e.g. ``requests_db.claim:OperationalError:p=0.3:seed=7``. Named call
sites (in the port: the checkpoint commit, ``train.ckpt.commit``)
invoke :func:`inject` with their site string; a matching clause raises its
exception with probability ``p`` (default 1.0) drawn from a
per-clause ``random.Random(seed)`` — the injection SEQUENCE is a pure
function of the seed, so a chaos test that passes once passes always.
``times`` caps total injections from that clause (default unlimited).
A site clause ending in ``*`` prefix-matches (``requests_db.*``).

The env var is inherited by every spawned process, so one spec
exercises every process of a run. When it is unset, :func:`inject` is
a single dict lookup — effectively free on hot paths. The spec syntax
is documented for operators in ``docs/fault_tolerance.md``.
"""
from __future__ import annotations

import os
import random
import sqlite3
from typing import Callable, Dict, List, Optional, Tuple

SPEC_ENV = 'SKYT_FAULT_SPEC'


def _make_operational_error() -> BaseException:
    return sqlite3.OperationalError('injected: database is locked')


_EXCEPTIONS: Dict[str, Callable[[], BaseException]] = {
    'OperationalError': _make_operational_error,
    'OSError': lambda: OSError('injected: I/O fault'),
    'ConnectionError': lambda: ConnectionError(
        'injected: connection refused'),
    'TimeoutError': lambda: TimeoutError('injected: timed out'),
    'Exception': lambda: Exception('injected fault'),
}


class _Clause:
    def __init__(self, site: str, exc: str, p: float, seed: int,
                 times: Optional[int]) -> None:
        if exc not in _EXCEPTIONS:
            raise ValueError(
                f'unknown fault exception {exc!r}; one of '
                f'{sorted(_EXCEPTIONS)}')
        if not 0.0 <= p <= 1.0:
            raise ValueError(f'fault probability must be in [0,1], got {p}')
        self.site = site
        self.exc = exc
        self.p = p
        self.seed = seed
        self.times = times

    def matches(self, site: str) -> bool:
        if self.site.endswith('*'):
            return site.startswith(self.site[:-1])
        return site == self.site


def parse_spec(spec: str) -> List[_Clause]:
    """Parse a full SKYT_FAULT_SPEC value. Raises ``ValueError`` on any
    malformed clause — a typo that silently injected nothing would make
    a chaos test vacuously green."""
    clauses = []
    for raw in spec.split(','):
        raw = raw.strip()
        if not raw:
            continue
        parts = raw.split(':')
        if len(parts) < 2:
            raise ValueError(
                f'fault clause {raw!r} needs at least site:Exception')
        site, exc = parts[0], parts[1]
        p, seed, times = 1.0, 0, None
        for opt in parts[2:]:
            key, _, value = opt.partition('=')
            if key == 'p':
                p = float(value)
            elif key == 'seed':
                seed = int(value)
            elif key == 'times':
                times = int(value)
            else:
                raise ValueError(
                    f'unknown fault option {opt!r} in clause {raw!r}')
        clauses.append(_Clause(site, exc, p, seed, times))
    return clauses


# Parse cache keyed by the raw env value; per-clause runtime state
# (RNG + remaining-injection budget) keyed by (spec, clause index) so a
# spec change mid-process starts fresh.
_parsed: Dict[str, List[_Clause]] = {}
_runtime: Dict[Tuple[str, int], Dict] = {}


def inject(site: str) -> None:
    """Raise the configured fault for ``site``, if any. No-op (one env
    lookup) when SKYT_FAULT_SPEC is unset."""
    spec = os.environ.get(SPEC_ENV)
    if not spec:
        return
    clauses = _parsed.get(spec)
    if clauses is None:
        clauses = parse_spec(spec)
        _parsed[spec] = clauses
    for index, clause in enumerate(clauses):
        if not clause.matches(site):
            continue
        state = _runtime.get((spec, index))
        if state is None:
            state = {'rng': random.Random(clause.seed),
                     'remaining': clause.times}
            _runtime[(spec, index)] = state
        if state['remaining'] is not None and state['remaining'] <= 0:
            continue
        # Always draw, even below p=1.0 thresholds that will fire: the
        # decision sequence must advance identically whether or not a
        # previous clause consumed the call.
        if state['rng'].random() < clause.p:
            if state['remaining'] is not None:
                state['remaining'] -= 1
            raise _EXCEPTIONS[clause.exc]()


def reset() -> None:
    """Forget parse + RNG/budget state (tests re-seed between cases)."""
    _parsed.clear()
    _runtime.clear()
