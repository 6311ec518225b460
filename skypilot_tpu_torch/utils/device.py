"""Device selection for the port's entry points.

Entry points run on the card: ``None`` means ``cuda``, and asking for
``cuda`` on a machine without a GPU raises instead of quietly running
on the CPU. The CPU is used only when the caller names it (the tests).
"""
from __future__ import annotations

from typing import Any, Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'no CUDA device is available: the port runs on the GPU by '
            "default; pass device='cpu' to run on the CPU explicitly")
    if dev.type not in ('cuda', 'cpu'):
        raise ValueError(f'unsupported device {dev}')
    return dev


def to_device(tree: Any, device: torch.device) -> Any:
    """A params dict (nested dicts of tensors or W8A8 ``QTensor``s) moved
    to ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree.to(device)
