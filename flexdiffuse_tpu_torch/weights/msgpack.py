"""flax's msgpack parameter format, read and written without flax or the
``msgpack`` package.

``flax.serialization.msgpack_serialize`` writes a tree of str-keyed dicts
whose leaves are arrays; :func:`serialize` writes the same bytes for the same
tree, and :func:`restore` reads them back. The format, as flax writes it
with ``msgpack.packb(..., use_bin_type=True)``:

* a dict is a msgpack map whose keys are in sorted order (flax rebuilds the
  tree with ``jax.tree_util.tree_map``, which sorts dict keys);
* an array is ExtType 1 whose payload is the msgpack array
  ``(shape, dtype name, C-order bytes)``; a numpy scalar is ExtType 3 with
  the payload of its 0-d array; the dtype name of bfloat16 is
  ``'bfloat16'``;
* an array of more than :data:`MAX_CHUNK_SIZE` bytes becomes the map
  ``{'__msgpack_chunked_array__': True, 'shape': {'0': d0, ...},
  'chunks': {'0': flat chunk, ...}}`` of flat chunks of
  ``MAX_CHUNK_SIZE // itemsize`` elements, in that key order.

Integers take msgpack's shortest encoding. Only what a parameter tree needs
is handled: maps, arrays (numpy or torch), numpy scalars, ints, bools and
strings; anything else raises. Restored arrays are numpy arrays viewing
the input buffer, except bfloat16 ones, which are torch tensors.
"""
from __future__ import annotations

import mmap
import struct
from typing import Any, Iterator, Mapping, Tuple, Union

import numpy as np
import torch

# flax's limit (flax/serialization.py), read when a tree is written.
MAX_CHUNK_SIZE = 2**30
CHUNKED = '__msgpack_chunked_array__'
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


# ---------------------------------------------------------------------------
# Writing


def _int(x: int) -> bytes:
    if 0 <= x < 128:
        return bytes([x])
    if -32 <= x < 0:
        return struct.pack('b', x)
    for lo, hi, code, fmt in ((0, 2**8, 0xcc, '>B'), (0, 2**16, 0xcd, '>H'),
                              (0, 2**32, 0xce, '>I'), (0, 2**64, 0xcf, '>Q'),
                              (-2**7, 0, 0xd0, '>b'), (-2**15, 0, 0xd1, '>h'),
                              (-2**31, 0, 0xd2, '>i'),
                              (-2**63, 0, 0xd3, '>q')):
        if lo <= x < hi:
            return bytes([code]) + struct.pack(fmt, x)
    raise ValueError(f'integer {x} does not fit msgpack')


def _sized(n: int, fix: Tuple[int, int], codes: Tuple[int, int, int]
           ) -> bytes:
    """Header of a str/bin/array/map of ``n`` items: the fix form when
    ``n < fix[1]`` (code ``fix[0] | n``), else 8-, 16- or 32-bit lengths
    (``codes``; ``None`` where the type has no such form)."""
    if fix and n < fix[1]:
        return bytes([fix[0] | n])
    for code, fmt, limit in zip(codes, ('>B', '>H', '>I'),
                                (2**8, 2**16, 2**32)):
        if code is not None and n < limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f'msgpack object of {n} items is too large')


def _str(s: str) -> bytes:
    b = s.encode('utf-8')
    return _sized(len(b), (0xa0, 32), (0xd9, 0xda, 0xdb)) + b


def _array_header(n: int) -> bytes:
    return _sized(n, (0x90, 16), (None, 0xdc, 0xdd))


def _map_header(n: int) -> bytes:
    return _sized(n, (0x80, 16), (None, 0xde, 0xdf))


def _ext_header(code: int, n: int) -> bytes:
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixed:
        return bytes([fixed[n], code])
    return _sized(n, (), (0xc7, 0xc8, 0xc9)) + bytes([code])


def _array_parts(t: Union[np.ndarray, torch.Tensor]
                 ) -> Tuple[Tuple[int, ...], str, Any]:
    """(shape, dtype name, C-order byte buffer) of a numpy or torch array."""
    if isinstance(t, np.ndarray):
        if t.dtype.hasobject or t.dtype.names is not None:
            raise ValueError(f'cannot serialize arrays of dtype {t.dtype}')
        flat = np.ascontiguousarray(t).reshape(-1).view(np.uint8)
        return t.shape, t.dtype.name, flat.data
    t = t.detach().cpu().contiguous()
    name = 'bfloat16' if t.dtype == torch.bfloat16 else \
        str(t.dtype).replace('torch.', '')
    flat = t.reshape(-1).view(torch.uint8) if t.numel() else \
        torch.empty(0, dtype=torch.uint8)
    return tuple(t.shape), name, flat.numpy().data


def _ext_array(code: int, t) -> Iterator[Any]:
    shape, name, data = _array_parts(t)
    head = (_array_header(3) + _array_header(len(shape)) +
            b''.join(_int(d) for d in shape) + _str(name) +
            _sized(data.nbytes, (), (0xc4, 0xc5, 0xc6)))
    yield _ext_header(code, len(head) + data.nbytes) + head
    if data.nbytes:
        yield data


def _nbytes(t) -> int:
    return t.nbytes if isinstance(t, np.ndarray) else \
        t.numel() * t.element_size()


def _chunked(t) -> Iterator[Any]:
    """flax's ``_chunk``: the map of flat chunks an oversized array
    becomes."""
    itemsize = t.itemsize if isinstance(t, np.ndarray) else t.element_size()
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = t.reshape(-1)
    n = flat.shape[0]
    yield _map_header(3) + _str(CHUNKED) + b'\xc3' + _str('shape')
    yield _map_header(len(t.shape))
    for i, d in enumerate(t.shape):
        yield _str(str(i)) + _int(int(d))
    starts = range(0, n, size)
    yield _str('chunks') + _map_header(len(starts))
    for i, s in enumerate(starts):
        yield _str(str(i))
        yield from _ext_array(_EXT_NDARRAY, flat[s:s + size])


def _pack(x) -> Iterator[Any]:
    if isinstance(x, Mapping):
        keys = sorted(x)
        if not all(isinstance(k, str) for k in keys):
            raise TypeError('only str-keyed maps can be serialized')
        yield _map_header(len(keys))
        for k in keys:
            yield _str(k)
            yield from _pack(x[k])
    elif isinstance(x, (np.ndarray, torch.Tensor)):
        if _nbytes(x) > MAX_CHUNK_SIZE:
            yield from _chunked(x)
        else:
            yield from _ext_array(_EXT_NDARRAY, x)
    elif isinstance(x, np.generic):
        yield from _ext_array(_EXT_NPSCALAR, np.asarray(x))
    elif isinstance(x, bool):
        yield b'\xc3' if x else b'\xc2'
    elif isinstance(x, int):
        yield _int(x)
    elif isinstance(x, str):
        yield _str(x)
    else:
        raise TypeError(f'cannot serialize {type(x).__name__} into a '
                        'parameter tree')


def serialize(tree: Mapping) -> bytes:
    """The bytes ``flax.serialization.msgpack_serialize(tree)`` gives."""
    return b''.join(bytes(p) for p in _pack(tree))


# ---------------------------------------------------------------------------
# Reading


class _Reader:
    def __init__(self, buf) -> None:
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        out = self.buf[self.pos:self.pos + n]
        if len(out) != n:
            raise ValueError('truncated msgpack data')
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        c = self.unpack('B')
        if c < 0x80:
            return c
        if c >= 0xe0:
            return c - 0x100
        if c & 0xf0 == 0x80:
            return self.map(c & 0x0f)
        if c & 0xf0 == 0x90:
            return [self.value() for _ in range(c & 0x0f)]
        if c & 0xe0 == 0xa0:
            return str(self.take(c & 0x1f), 'utf-8')
        simple = {0xc2: False, 0xc3: True}
        if c in simple:
            return simple[c]
        ints = {0xcc: '>B', 0xcd: '>H', 0xce: '>I', 0xcf: '>Q',
                0xd0: '>b', 0xd1: '>h', 0xd2: '>i', 0xd3: '>q'}
        if c in ints:
            return self.unpack(ints[c])
        lens = {0xc4: '>B', 0xc5: '>H', 0xc6: '>I',     # bin
                0xd9: '>B', 0xda: '>H', 0xdb: '>I',     # str
                0xdc: '>H', 0xdd: '>I',                 # array
                0xde: '>H', 0xdf: '>I',                 # map
                0xc7: '>B', 0xc8: '>H', 0xc9: '>I'}     # ext
        fixext = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
        if c in fixext:
            return self.ext(fixext[c])
        if c not in lens:
            raise ValueError(f'msgpack type 0x{c:02x} is not part of a '
                             'parameter tree')
        n = self.unpack(lens[c])
        if c <= 0xc6:
            return self.take(n)
        if c >= 0xd9 and c <= 0xdb:
            return str(self.take(n), 'utf-8')
        if c in (0xdc, 0xdd):
            return [self.value() for _ in range(n)]
        if c in (0xde, 0xdf):
            return self.map(n)
        return self.ext(n)

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        if out.get(CHUNKED) is True:
            shape = [out['shape'][str(i)] for i in range(len(out['shape']))]
            chunks = [out['chunks'][str(i)]
                      for i in range(len(out['chunks']))]
            cat = (torch.cat if isinstance(chunks[0], torch.Tensor)
                   else np.concatenate)
            return cat(chunks).reshape(shape)
        return out

    def ext(self, n: int):
        code = self.unpack('B')
        body = _Reader(self.take(n))
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f'msgpack ExtType {code} is not part of a '
                             'parameter tree')
        shape, name, data = body.value()
        if name == 'bfloat16':
            if data.readonly:       # torch views writable buffers only
                data = bytearray(data)
            arr = torch.frombuffer(data, dtype=torch.int16) if len(data) \
                else torch.empty(0, dtype=torch.int16)
            arr = arr.view(torch.bfloat16).reshape(shape)
            return arr if code == _EXT_NDARRAY else arr.reshape(())
        arr = np.frombuffer(data, dtype=np.dtype(name)).reshape(shape)
        return arr if code == _EXT_NDARRAY else arr[()]


def restore(data) -> Any:
    """The tree ``flax.serialization.msgpack_restore(data)`` gives (bfloat16
    leaves as torch tensors). ``data`` is bytes or any buffer; arrays view
    it without a copy."""
    r = _Reader(data)
    out = r.value()
    if r.pos != len(r.buf):
        raise ValueError('trailing bytes after the msgpack tree')
    return out


def load(path: str) -> Any:
    """:func:`restore` over a copy-on-write mapping of the file at
    ``path``: arrays view the mapping until they are copied."""
    with open(path, 'rb') as f:
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    return restore(buf)


def save(tree: Mapping, path: str) -> None:
    """Write ``tree`` to ``path`` in flax's msgpack format, one array at a
    time."""
    with open(path, 'wb') as f:
        for part in _pack(tree):
            f.write(part)
