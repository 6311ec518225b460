"""Helpers shared by the port's attention code.

``NEG_INF`` is the finite mask value of ``skypilot_tpu/ops/pallas/
common.py`` and ``ops/attention.py``. It must stay finite: a fully
masked query row (a padded verify position, or an inactive slot whose
``n_valid`` is 1 in ``paged_verify_step``) then gives
``exp(NEG_INF - NEG_INF) == 1``, i.e. uniform weights, where ``-inf``
would give NaN.

``fit_block`` and ``warn_fallback_once`` are the port's copies of the
reference's helpers of the same names.
"""
from __future__ import annotations

import logging

NEG_INF = -1e30

_warned_fallbacks: set = set()


def warn_fallback_once(kernel: str, reason: str) -> None:
    """Dropping off a kernel onto the plain reference attention costs
    memory and time: say so, once per (kernel, reason)."""
    key = (kernel, reason)
    if key in _warned_fallbacks:
        return
    _warned_fallbacks.add(key)
    logging.getLogger(__name__).warning(
        '%s: falling back to the reference attention for %s '
        '(expect higher memory traffic / lower throughput)', kernel, reason)


def fit_block(total: int, preferred: int) -> int:
    """Largest power-of-two-reduced block <= preferred that divides total."""
    b = min(preferred, total)
    while total % b:
        b //= 2
    return max(b, 1)
