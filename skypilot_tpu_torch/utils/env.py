"""The ``SKYT_*`` serving knobs the port reads, with the reference's
names, types and defaults.

The port's own copy of the entries of
``skypilot_tpu/utils/env_registry.py`` that the continuous engine
reads (speculative decoding, disaggregated serving and multi-LoRA
serving), the two of the weight fan-out's that its replica side
reads (``data/fanout.py``; the controller's are not ported) and the RL
pipeline's (``jobs/rl_pipeline.py``, ``inference/server.py
--policy-store``), with the same parsing: an unset or unparsable value
reads as the declared default, an empty string reads as unset, a
boolean is false for ``''``, ``0``, ``false``, ``no`` and ``off``, and
a number below the caller's ``minimum`` reads as the default. A
``path`` knob reads as a string (``None`` when unset). Reading a name
that is not declared here raises ``KeyError``.
"""
from __future__ import annotations

import logging
import os
from typing import Dict, Optional, Tuple

logger = logging.getLogger(__name__)

# name -> (type, default)
DECLARATIONS: Dict[str, Tuple[str, object]] = {
    'SKYT_SPEC_DECODE': ('bool', False),
    'SKYT_SPEC_DRAFT_K': ('int', 4),
    'SKYT_SPEC_NGRAM_MAX': ('int', 3),
    'SKYT_DISAGG_ROLE': ('str', ''),
    'SKYT_KV_MIGRATE_TIMEOUT': ('float', 30.0),
    'SKYT_KV_MIGRATE_RETRIES': ('int', 3),
    'SKYT_LORA_PAGES': ('int', 0),
    'SKYT_LORA_MAX_RANK': ('int', 8),
    'SKYT_LORA_MAX_ACTIVE': ('int', 0),
    'SKYT_LORA_DRR_QUANTUM': ('int', 4),
    'SKYT_FANOUT_PEER_TIMEOUT': ('float', 30.0),
    'SKYT_FANOUT_DIR': ('path', None),
    'SKYT_RL_MAX_STALENESS': ('int', 4),
    'SKYT_RL_QUEUE_BATCHES': ('int', 2),
    'SKYT_RL_REFRESH_MODE': ('str', 'step'),
    'SKYT_RL_REFRESH_CONCURRENCY': ('int', 1),
    'SKYT_RL_ROLE': ('str', ''),
    'SKYT_RL_RANK': ('int', 0),
    'SKYT_RL_FLEET': ('int', 1),
    'SKYT_RL_STORE': ('path', None),
    'SKYT_RL_EVAL_POLL_S': ('float', 10.0),
}

_FALSE = frozenset(('', '0', 'false', 'no', 'off'))


def _require(name: str, *kinds: str) -> object:
    declared = DECLARATIONS.get(name)
    if declared is None:
        raise KeyError(f'{name} is not a declared knob of the port')
    if declared[0] not in kinds:
        raise TypeError(f'{name} is a {declared[0]} knob, not {kinds[0]}')
    return declared[1]


def _number(name: str, kind: str, cast, minimum):
    default = _require(name, kind)
    raw = os.environ.get(name, '').strip()
    if not raw:
        return default
    try:
        value = cast(raw)
    except ValueError:
        logger.warning('ignoring unparsable %s=%r (using declared '
                       'default)', name, raw)
        return default
    if minimum is not None and value < minimum:
        return default
    return value


def get_int(name: str, minimum: Optional[int] = None) -> int:
    """Integer knob: the declared default when unset, unparsable or
    below ``minimum``."""
    return _number(name, 'int', int, minimum)


def get_float(name: str, minimum: Optional[float] = None) -> float:
    """Float knob: the declared default when unset, unparsable or below
    ``minimum``."""
    return _number(name, 'float', float, minimum)


def get_str(name: str) -> Optional[str]:
    """String or path knob: the raw value, or the declared default when
    unset or empty."""
    default = _require(name, 'str', 'path')
    return os.environ.get(name) or default


def get_bool(name: str) -> bool:
    """Boolean knob: unset -> the declared default; ``''``, ``0``,
    ``false``, ``no``, ``off`` (any case) -> False; anything else
    set -> True."""
    default = _require(name, 'bool')
    raw = os.environ.get(name)
    if raw is None:
        return bool(default)
    return raw.strip().lower() not in _FALSE
