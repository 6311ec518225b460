"""The safetensors container, read and written without the
``safetensors`` package: an 8-byte little-endian header length, a JSON
header of dtype, shape and byte offsets per tensor, then the raw bytes.

``SafetensorsReader`` parses the header from a private ``mmap`` and
``get`` returns a tensor on the map's pages, no copy. bf16 has no numpy
dtype without ``ml_dtypes``, so it is read as raw 16-bit integers and
viewed as ``torch.bfloat16``. ``write_safetensors`` streams: each tensor
is made contiguous (and cast) on its own device, copied to the host
through one pinned buffer and written before the next, so exporting a
model on the card never holds a host copy of it. Its bytes equal the
reference writer's (``skypilot_tpu/models/hf_interop.py``) for the same
tensors.

A value may also be a ``Deferred``: a tensor of known shape, dtype and
device made only when the writer reaches it, so a caller that gathers
each tensor (``train/checkpoint.py`` on a mesh) holds one at a time.

``models/hf_interop.py`` (HF checkpoints) and ``train/checkpoint.py``
(training state) both read and write through this module.
"""
from __future__ import annotations

import dataclasses
import json
import mmap
import os
import struct
from typing import Any, BinaryIO, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

# safetensors dtype tags <-> torch dtypes, and the numpy dtype each tag
# is read through (bf16: its raw 16-bit patterns).
_ST_DTYPES = {
    'F64': torch.float64, 'F32': torch.float32, 'F16': torch.float16,
    'BF16': torch.bfloat16, 'I64': torch.int64, 'I32': torch.int32,
    'I16': torch.int16, 'I8': torch.int8, 'U8': torch.uint8,
    'BOOL': torch.bool,
}
_ST_TAGS = {dt: tag for tag, dt in _ST_DTYPES.items()}
_NP_READ = {
    'F64': np.float64, 'F32': np.float32, 'F16': np.float16,
    'BF16': np.int16, 'I64': np.int64, 'I32': np.int32, 'I16': np.int16,
    'I8': np.int8, 'U8': np.uint8, 'BOOL': np.bool_,
}


def _st_tag(dtype: torch.dtype) -> str:
    try:
        return _ST_TAGS[dtype]
    except KeyError:
        raise ValueError(
            f'unsupported dtype for safetensors export: {dtype}') from None


class SafetensorsReader:
    """mmap-backed reader of one .safetensors file: ``get`` returns a
    CPU tensor on the map's pages (no copy). The map is private
    (copy-on-write), so a write into a returned tensor never reaches
    the file."""

    def __init__(self, path: str) -> None:
        self.path = path
        self._f = open(path, 'rb')
        try:
            self._mm = mmap.mmap(self._f.fileno(), 0,
                                 access=mmap.ACCESS_COPY)
        except BaseException:
            self._f.close()
            raise
        (header_len,) = struct.unpack('<Q', self._mm[:8])
        header = json.loads(self._mm[8:8 + header_len].decode('utf-8'))
        self.metadata = header.pop('__metadata__', {})
        self._entries = header
        self._data_start = 8 + header_len

    def keys(self) -> List[str]:
        return list(self._entries)

    def shape(self, name: str) -> Tuple[int, ...]:
        return tuple(self._entries[name]['shape'])

    def get(self, name: str) -> torch.Tensor:
        ent = self._entries[name]
        tag = ent['dtype']
        if tag not in _ST_DTYPES:
            raise ValueError(f'unsupported safetensors dtype {tag!r}')
        start, end = ent['data_offsets']
        if end == start:
            return torch.empty(ent['shape'], dtype=_ST_DTYPES[tag])
        np_dt = np.dtype(_NP_READ[tag])
        flat = np.frombuffer(self._mm, dtype=np_dt,
                             count=(end - start) // np_dt.itemsize,
                             offset=self._data_start + start)
        out = torch.from_numpy(flat)
        if tag == 'BF16':
            out = out.view(torch.bfloat16)
        return out.reshape(ent['shape'])

    def close(self) -> None:
        try:
            self._mm.close()
        except BufferError:
            # Tensors handed out by get() still reference the map; it
            # is released when the last of them dies.
            pass
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


@dataclasses.dataclass(frozen=True)
class Deferred:
    """A tensor that ``make()`` returns when the writer reaches it: the
    header needs only its shape, dtype and device."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    device: torch.device
    make: Callable[[], torch.Tensor]

    def numel(self) -> int:
        n = 1
        for size in self.shape:
            n *= size
        return n

    @property
    def is_cuda(self) -> bool:
        return self.device.type == 'cuda'

    def get(self) -> torch.Tensor:
        t = self.make()
        if tuple(t.shape) != tuple(self.shape) or t.dtype != self.dtype:
            raise ValueError(f'deferred tensor made {tuple(t.shape)} '
                             f'{t.dtype}, declared {tuple(self.shape)} '
                             f'{self.dtype}')
        return t


def _device_layout(t: torch.Tensor, dtype: Optional[torch.dtype]
                   ) -> torch.Tensor:
    """``t`` cast to ``dtype`` and laid out contiguously on its own
    device (a transposed view on the card is transposed there, not by
    the host), flat."""
    t = t.detach()
    if dtype is not None and t.dtype != dtype:
        t = t.to(dtype)
    return t.contiguous().reshape(-1)


def _write_to(f: BinaryIO, tensors: Dict[str, torch.Tensor],
              metadata: Optional[Dict[str, str]],
              dtype: Optional[torch.dtype]) -> None:
    header: Dict[str, Any] = {}
    if metadata:
        header['__metadata__'] = metadata
    offset = 0
    names = sorted(tensors)
    largest_on_card = 0
    for name in names:
        t = tensors[name]
        out_dt = dtype or t.dtype
        n = t.numel() * torch.empty((), dtype=out_dt).element_size()
        header[name] = {'dtype': _st_tag(out_dt), 'shape': list(t.shape),
                        'data_offsets': [offset, offset + n]}
        offset += n
        if t.is_cuda:
            largest_on_card = max(largest_on_card, n)
    blob = json.dumps(header, separators=(',', ':')).encode('utf-8')
    blob += b' ' * (-len(blob) % 8)
    f.write(struct.pack('<Q', len(blob)))
    f.write(blob)
    staging = (torch.empty(largest_on_card, dtype=torch.uint8,
                           pin_memory=True) if largest_on_card else None)
    for name in names:
        t = tensors[name]
        _write_one(f, t.get() if isinstance(t, Deferred) else t, dtype,
                   staging)


def _write_one(f: BinaryIO, t: torch.Tensor, dtype: Optional[torch.dtype],
               staging: Optional[torch.Tensor]) -> None:
    """One tensor's bytes (through ``staging`` from the card); nothing
    of it is referenced once this returns."""
    flat = _device_layout(t, dtype)
    if not flat.numel():
        return
    raw = flat.view(torch.uint8)
    if raw.is_cuda:
        host = staging[:raw.numel()]
        host.copy_(raw)
    else:
        host = raw
    f.write(host.numpy())


def write_safetensors(path: str, tensors: Dict[str, Any],
                      metadata: Optional[Dict[str, str]] = None, *,
                      dtype: Optional[torch.dtype] = None,
                      fsync: bool = False) -> None:
    """Write a .safetensors file of ``tensors`` (sorted names, contiguous
    offsets, the header's compact JSON padded with spaces to 8 bytes) to
    ``path + '.tmp'``, one tensor at a time, then rename it to ``path``;
    ``dtype`` casts every tensor as it is written, and ``fsync`` syncs
    the file before the rename. Tensors on the card reach the host
    through one pinned staging buffer of the largest one's size. A
    ``Deferred`` value is made as its turn comes, in name order."""
    tmp = path + '.tmp'
    with open(tmp, 'wb') as f:
        _write_to(f, tensors, metadata, dtype)
        if fsync:
            f.flush()
            os.fsync(f.fileno())
    os.replace(tmp, path)
