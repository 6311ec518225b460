"""Device selection for the port's entry points.

Entry points run on the card: ``None`` means ``cuda``, and asking for
``cuda`` on a machine without a GPU raises instead of quietly running
on the CPU. The CPU is used only when the caller names it (the tests).
"""
from __future__ import annotations

from typing import Optional, Union

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
