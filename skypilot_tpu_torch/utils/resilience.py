"""Retry pacing: the port's copy of ``backoff_delays`` from
``skypilot_tpu/utils/resilience.py``, the one part of that module the
KV-migration puller (``inference/kv_migrate.py``) uses.
"""
from __future__ import annotations

import random
from typing import Iterator, Optional


def backoff_delays(base: float = 0.05,
                   cap: float = 2.0,
                   multiplier: float = 2.0,
                   jitter: float = 0.25,
                   rng: Optional[random.Random] = None
                   ) -> Iterator[float]:
    """Infinite exponential-backoff delay sequence.

    Delay k is ``min(cap, base * multiplier**k)`` stretched by a random
    factor in ``[1, 1 + jitter]``: the jitter only adds, so the sequence
    never undershoots the deterministic floor. Pass a seeded ``rng``
    for a reproducible sequence.
    """
    if base <= 0:
        raise ValueError(f'backoff base must be > 0, got {base}')
    rng = rng or random
    delay = base
    while True:
        yield delay * (1.0 + rng.random() * jitter)
        delay = min(cap, delay * multiplier)
