"""The safetensors format, read and written without the ``safetensors``
package (which the card's machine lacks).

A file is an 8-byte little-endian header length, a JSON header mapping each
tensor name to its ``dtype``, ``shape`` and ``data_offsets`` (byte offsets
into the data that follows the header; an optional ``__metadata__`` entry
holds strings), then the raw little-endian bytes in C order.

:func:`load_file` maps the file (``mmap``, copy-on-write) and returns tensors
that view it through ``torch.frombuffer``: nothing is read until a tensor is
used, and a multi-gigabyte checkpoint never sits in host memory twice.
"""
from __future__ import annotations

import json
import mmap
import struct
from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch

# safetensors dtype name -> torch dtype. BF16 is read as int16 bytes and
# reinterpreted (numpy has no bfloat16).
DTYPES = {'F64': torch.float64, 'F32': torch.float32, 'F16': torch.float16,
          'BF16': torch.bfloat16, 'I64': torch.int64, 'I32': torch.int32,
          'I16': torch.int16, 'I8': torch.int8, 'U8': torch.uint8,
          'BOOL': torch.bool}
_NAMES = {v: k for k, v in DTYPES.items()}
_VIEW = {torch.bfloat16: torch.int16}


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a safetensors file, as CPU tensors viewing the
    file's mapping (writable copy-on-write views: writing one never touches
    the file)."""
    with open(path, 'rb') as f:
        (n,) = struct.unpack('<Q', f.read(8))
        header = json.loads(f.read(n))
        size = f.seek(0, 2)
        buf = (mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
               if size else b'')
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == '__metadata__':
            continue
        dtype = DTYPES.get(info['dtype'])
        if dtype is None:
            raise ValueError(f'{path}: tensor {name!r} has unsupported dtype '
                             f'{info["dtype"]}')
        begin, end = info['data_offsets']
        shape = info['shape']
        if end == begin:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        raw = _VIEW.get(dtype, dtype)
        itemsize = torch.empty((), dtype=raw).element_size()
        t = torch.frombuffer(buf, dtype=raw, count=(end - begin) // itemsize,
                             offset=base + begin)
        out[name] = t.view(dtype).reshape(shape)
    return out


def _raw(x: Union[torch.Tensor, np.ndarray]) -> memoryview:
    """The C-order bytes of a tensor or array (on the host)."""
    if isinstance(x, np.ndarray):     # uint8 view: also for ml_dtypes'
        return np.ascontiguousarray(x).reshape(-1).view(np.uint8).data
    t = x.detach().cpu().contiguous().reshape(-1)
    return t.view(torch.uint8).numpy().data


def save_file(tensors: Mapping[str, Union[torch.Tensor, np.ndarray]],
              path: str, metadata: Optional[Dict[str, str]] = None) -> None:
    """Write tensors (torch or numpy, any dtype of :data:`DTYPES`) in their
    own dtypes, sorted by name; the header is padded with spaces to 8 bytes.
    Each tensor is copied to the host and written in turn."""
    header: dict = {}
    if metadata:
        header['__metadata__'] = dict(metadata)
    offset = 0
    names = sorted(tensors)
    for name in names:
        t = tensors[name]
        if isinstance(t, torch.Tensor):
            dtype = t.dtype
        elif t.dtype.name == 'bfloat16':
            dtype = torch.bfloat16
        else:
            dtype = torch.from_numpy(np.empty(0, t.dtype)).dtype
        if dtype not in _NAMES:
            raise ValueError(f'tensor {name!r}: dtype {dtype} is not '
                             'supported')
        nbytes = t.numel() * t.element_size() if isinstance(
            t, torch.Tensor) else t.nbytes
        header[name] = {'dtype': _NAMES[dtype], 'shape': list(t.shape),
                        'data_offsets': [offset, offset + nbytes]}
        offset += nbytes
    raw = json.dumps(header, separators=(',', ':')).encode()
    raw += b' ' * (-len(raw) % 8)
    with open(path, 'wb') as f:
        f.write(struct.pack('<Q', len(raw)))
        f.write(raw)
        for name in names:
            f.write(_raw(tensors[name]))


def save_safetensors(tensors: Mapping[str, np.ndarray], path: str) -> None:
    """Write arrays as fp32 safetensors (the format of the kohya LoRA
    adapters the training loop exports)."""
    save_file({k: np.asarray(v, dtype='<f4') for k, v in tensors.items()},
              path)
