"""Packed-sequence batching over the native C++ packer: the port of
``skypilot_tpu/data/packer.py``.

EOS-delimited documents are greedily first-fit packed into fixed
[batch, seq] grids with per-token segment ids and positions, so
attention (segment mask) and RoPE (position reset) treat packed
neighbours as independent sequences: no padding waste, no
cross-document leakage.

``csrc/packer.cc`` (the port's copy of ``addons/dataloader/packer.cc``)
is built with the host C++ compiler at first use by ``_build.py`` into
``build/torch_kernels/`` and called through ctypes. ``pack_batch_py`` is
its bit-identical Python mirror, which runs where the native packer
does not build (as in the reference), unless the caller passes
``require_native=True`` (the trainer on the card), which raises instead.
``CALLS`` counts the batches each one packed.
"""
from __future__ import annotations

import ctypes
import logging
import os
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

CALLS: Dict[str, int] = {'native': 0, 'python': 0}

_lib: Optional[ctypes.CDLL] = None
_lib_error: Optional[BaseException] = None


def reset_call_counts() -> None:
    for key in CALLS:
        CALLS[key] = 0


def load_native() -> ctypes.CDLL:
    """Build (once) and load the C++ packer; raises when it cannot."""
    global _lib, _lib_error
    if _lib is not None:
        return _lib
    if _lib_error is not None:
        raise RuntimeError(f'native packer unavailable: {_lib_error}')
    from skypilot_tpu_torch import _build
    try:
        lib = _build.load_library('packer')
    except (OSError, RuntimeError) as e:
        _lib_error = e
        raise RuntimeError(f'native packer unavailable: {e}') from e
    lib.skyt_pack_batch.restype = ctypes.c_long
    lib.skyt_pack_batch.argtypes = [
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_long, ctypes.c_long,
        ctypes.c_uint32, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_long),
    ]
    _lib = lib
    return lib


def _use_native(require_native: bool) -> bool:
    """True when the native packer loads; False (the Python packer) when
    it does not, unless ``require_native``, which raises."""
    try:
        load_native()
        return True
    except RuntimeError as e:
        if require_native:
            raise
        logger.info('%s; using the Python packer.', e)
        return False


def pack_batch_native(tokens: np.ndarray, start: int, eos_id: int,
                      batch: int, seq: int
                      ) -> Tuple[Dict[str, np.ndarray], int, int]:
    lib = load_native()
    if tokens.dtype != np.uint32 or not tokens.flags['C_CONTIGUOUS']:
        tokens = np.ascontiguousarray(tokens, dtype=np.uint32)
    out_tokens = np.zeros((batch, seq), np.uint32)
    out_segments = np.zeros((batch, seq), np.int32)
    out_positions = np.zeros((batch, seq), np.int32)
    next_offset = ctypes.c_long(start)
    placed = lib.skyt_pack_batch(
        tokens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        len(tokens), start, eos_id, batch, seq,
        out_tokens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        out_segments.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out_positions.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.byref(next_offset))
    if placed < 0:
        raise ValueError(f'packer rejected batch={batch} seq={seq}')
    CALLS['native'] += 1
    grid = {'tokens': out_tokens, 'segments': out_segments,
            'positions': out_positions}
    return grid, next_offset.value, int(placed)


def pack_batch_py(tokens: np.ndarray, start: int, eos_id: int,
                  batch: int, seq: int
                  ) -> Tuple[Dict[str, np.ndarray], int, int]:
    """Bit-identical Python mirror of ``skyt_pack_batch`` (see
    ``csrc/packer.cc`` for the semantics)."""
    out_tokens = np.zeros((batch, seq), np.uint32)
    out_segments = np.zeros((batch, seq), np.int32)
    out_positions = np.zeros((batch, seq), np.int32)
    fill = [0] * batch
    seg = [0] * batch
    offset = int(start)
    placed = 0
    row_hint = 0
    n = len(tokens)
    while offset < n:
        doc_len = 0
        while offset + doc_len < n and doc_len < seq:
            doc_len += 1
            if tokens[offset + doc_len - 1] == eos_id:
                break
        if doc_len == 0:
            break
        row = -1
        for probe in range(batch):
            r = (row_hint + probe) % batch
            if fill[r] + doc_len <= seq:
                row = r
                break
        if row < 0:
            break
        at = fill[row]
        seg[row] += 1
        out_tokens[row, at:at + doc_len] = tokens[offset:offset + doc_len]
        out_segments[row, at:at + doc_len] = seg[row]
        out_positions[row, at:at + doc_len] = np.arange(doc_len)
        fill[row] += doc_len
        placed += doc_len
        offset += doc_len
        row_hint = row
        if all(f >= seq for f in fill):
            break
    CALLS['python'] += 1
    grid = {'tokens': out_tokens, 'segments': out_segments,
            'positions': out_positions}
    return grid, offset, placed


def pack_batch(tokens: np.ndarray, start: int, eos_id: int,
               batch: int, seq: int
               ) -> Tuple[Dict[str, np.ndarray], int, int]:
    if _use_native(False):
        return pack_batch_native(tokens, start, eos_id, batch, seq)
    return pack_batch_py(tokens, start, eos_id, batch, seq)


def packed_batch_iterator(tokens, *, batch: int, seq: int, eos_id: int,
                          loop: bool = True, require_native: bool = False
                          ) -> Iterator[Dict[str, np.ndarray]]:
    """Train-ready packed batches: tokens/targets/weights/segments/
    positions, each [batch, seq] numpy.

    ``tokens`` is a flat array OR a .npy path (memmapped). The array is
    viewed as uint32 once: an int32 memmap reinterprets zero-copy, so
    datasets larger than RAM stream off disk.

    targets are next tokens WITHIN the same segment; the weight is 0 on
    padding and on each segment's last token (its next token belongs to
    a different document).
    """
    if isinstance(tokens, str):
        tokens = np.load(os.path.expanduser(tokens), mmap_mode='r')
    if tokens.dtype == np.int32:
        tokens = tokens.view(np.uint32)
    elif tokens.dtype != np.uint32:
        tokens = np.ascontiguousarray(tokens, dtype=np.uint32)
    pack = (pack_batch_native if _use_native(require_native)
            else pack_batch_py)
    grid_seq = seq + 1  # pack one extra column so every target exists
    offset = 0
    while True:
        grid, offset, placed = pack(tokens, offset, eos_id, batch,
                                    grid_seq)
        if placed == 0:
            if offset == 0:
                raise ValueError(
                    'token stream yields no packable documents '
                    '(empty file, or every document is empty)')
            if not loop:
                return
            offset = 0
            continue
        toks = grid['tokens'].astype(np.int32)
        segs = grid['segments']
        poss = grid['positions']
        same_segment = (segs[:, 1:] == segs[:, :-1]) & (segs[:, :-1] > 0)
        yield {
            'tokens': toks[:, :-1],
            'targets': toks[:, 1:],
            'weights': same_segment.astype(np.float32),
            'segments': segs[:, :-1],
            'positions': poss[:, :-1],
        }
