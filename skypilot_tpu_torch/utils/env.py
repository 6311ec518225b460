"""The ``SKYT_*`` serving knobs the port reads, with the reference's
names, types and defaults.

The port's own copy of the entries of
``skypilot_tpu/utils/env_registry.py`` that the continuous engine
reads (speculative decoding, disaggregated serving and multi-LoRA
serving), with the same parsing: an unset or unparsable value reads as
the declared default, an empty string reads as unset, a boolean is
false for ``''``, ``0``, ``false``, ``no`` and ``off``.
Reading a name that is not declared here raises ``KeyError``.
"""
from __future__ import annotations

import logging
import os
from typing import Dict, Tuple

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
}

_FALSE = frozenset(('', '0', 'false', 'no', 'off'))


def _require(name: str, kind: str) -> object:
    declared = DECLARATIONS.get(name)
    if declared is None:
        raise KeyError(f'{name} is not a declared knob of the port')
    if declared[0] != kind:
        raise TypeError(f'{name} is a {declared[0]} knob, not {kind}')
    return declared[1]


def get_int(name: str) -> int:
    """Integer knob: the declared default when unset or unparsable."""
    default = _require(name, 'int')
    raw = os.environ.get(name, '').strip()
    if not raw:
        return default
    try:
        return int(raw)
    except ValueError:
        logger.warning('ignoring unparsable %s=%r (using declared '
                       'default)', name, raw)
        return default


def get_float(name: str) -> float:
    """Float knob: the declared default when unset or unparsable."""
    default = _require(name, 'float')
    raw = os.environ.get(name, '').strip()
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        logger.warning('ignoring unparsable %s=%r (using declared '
                       'default)', name, raw)
        return default


def get_str(name: str) -> str:
    """String knob: the raw value, or the declared default when unset
    or empty."""
    default = _require(name, 'str')
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
