"""flax's msgpack checkpoint format, read and written in Python and NumPy.

The JAX package writes its checkpoints with ``flax.serialization.
msgpack_serialize``: a msgpack document whose arrays are ext objects.  The
machine with the card has neither ``msgpack`` nor ``flax``, so the port
keeps its own copy of the subset flax writes:

  nil, bool, every int and float width, str, bin, array and map (each
  width), and ext with flax's three types (``_MsgpackExtType``):

    1  ndarray         a nested msgpack array (shape, dtype name, C-order
                       bytes);
    2  native_complex  a nested array (real, imag);
    3  npscalar        a 0-d ndarray, read back as a NumPy scalar.

An array larger than MAX_CHUNK_SIZE bytes is written as flax does, as a map
``{"__msgpack_chunked_array__": True, "shape": {...}, "chunks": {...}}`` of
flat pieces, and joined again on reading.  A ``bfloat16`` array (NumPy has
no such dtype) is read into a ``torch.bfloat16`` tensor from its raw bytes;
every other array comes back as a NumPy array.

``packb`` writes what ``msgpack_serialize`` writes for the same tree, byte
for byte: map keys in sorted order (``msgpack_serialize`` rebuilds the tree
with ``jax.tree_util``, which sorts them), Python floats as float64, ints
in their shortest encoding.  ``unpackb`` raises ``ValueError`` with the
offset on a truncated document or a byte it does not know.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

NDARRAY, NATIVE_COMPLEX, NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"
MAX_CHUNK_SIZE = 2**30  # flax.serialization.MAX_CHUNK_SIZE


# ---- decoding ---------------------------------------------------------------

class _Reader:
    def __init__(self, blob, base=0):
        self.buf = memoryview(blob)
        self.pos = 0
        self.base = base  # offset of buf[0] in the outermost document

    def take(self, n):
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError(
                f"truncated msgpack: {n} bytes needed at offset "
                f"{self.base + self.pos}, {len(self.buf) - self.pos} left")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def num(self, fmt):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self):
        at = self.base + self.pos
        t = self.take(1)[0]
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if t <= 0x8F:
            return self.map(t & 0x0F)
        if t <= 0x9F:
            return self.array(t & 0x0F)
        if t <= 0xBF:
            return self.str(t & 0x1F)
        if t in _FIXED:
            return _FIXED[t]
        if t in _NUMBERS:
            return self.num(_NUMBERS[t])
        if t in _SIZED:
            kind, fmt = _SIZED[t]
            n = self.num(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return self.str(n)
            if kind == "array":
                return self.array(n)
            if kind == "map":
                return self.map(n)
            return self.ext(n, at)
        if t in _FIXEXT:
            return self.ext(_FIXEXT[t], at)
        raise ValueError(f"unknown msgpack byte 0x{t:02x} at offset {at}")

    def str(self, n):
        return str(self.take(n), "utf-8")

    def array(self, n):
        return [self.obj() for _ in range(n)]

    def map(self, n):
        out = {}
        for _ in range(n):
            key = self.obj()
            out[key] = self.obj()
        return out

    def ext(self, n, at):
        code = struct.unpack(">b", self.take(1))[0]
        start = self.base + self.pos
        data = self.take(n)
        if code == NDARRAY:
            return _array_from(data, start)
        if code == NPSCALAR:
            arr = _array_from(data, start)
            return arr.reshape(()) if torch.is_tensor(arr) else arr[()]
        if code == NATIVE_COMPLEX:
            real, imag = _whole(data, start)
            return complex(real, imag)
        raise ValueError(f"unknown msgpack ext type {code} at offset {at}")


_FIXED = {0xC0: None, 0xC2: False, 0xC3: True}
_NUMBERS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
            0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_SIZED = {0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
          0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
          0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
          0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
          0xDE: ("map", ">H"), 0xDF: ("map", ">I")}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


def _whole(data, base):
    """The one object that fills ``data``."""
    reader = _Reader(data, base)
    out = reader.obj()
    if reader.pos != len(reader.buf):
        raise ValueError(f"extra bytes after the object ending at offset "
                         f"{base + reader.pos}")
    return out


def _array_from(data, base):
    shape, name, buf = _whole(data, base)
    if name == "bfloat16":
        dtype, itemsize = torch.bfloat16, 2
    else:
        dtype = np.dtype(name)
        itemsize = dtype.itemsize
    if len(buf) != itemsize * int(np.prod(shape, dtype=np.int64)):
        raise ValueError(f"ndarray at offset {base}: {len(buf)} bytes for "
                         f"shape {shape} of {name}")
    if dtype is torch.bfloat16:
        return torch.frombuffer(bytearray(buf), dtype=dtype).reshape(shape)
    # a read-only view of ``blob``, as flax gives; convert.flax_to_torch
    # makes the one copy
    return np.frombuffer(buf, dtype=dtype).reshape(shape)


def _unchunk(node):
    if isinstance(node, dict):
        if CHUNKED in node:
            shape = [node["shape"][str(i)] for i in range(len(node["shape"]))]
            parts = [node["chunks"][str(i)]
                     for i in range(len(node["chunks"]))]
            flat = (torch.cat(parts) if torch.is_tensor(parts[0])
                    else np.concatenate(parts))
            return flat.reshape(shape)
        return {k: _unchunk(v) for k, v in node.items()}
    return node


def unpackb(blob):
    """The tree ``flax.serialization.msgpack_restore`` gives for ``blob``."""
    return _unchunk(_whole(blob, 0))


# ---- encoding ---------------------------------------------------------------

def _head(out, n, small, small_max, codes):
    """A length header: ``small | n`` up to ``small_max``, else the first of
    ``codes`` ((code, struct format, largest n)) that holds ``n``."""
    if small is not None and n <= small_max:
        out.append(bytes([small | n]))
        return
    for code, fmt, largest in codes:
        if n <= largest:
            out.append(bytes([code]) + struct.pack(fmt, n))
            return
    raise ValueError(f"msgpack object of {n} entries or bytes is too large")


_STR = ((0xD9, ">B", 0xFF), (0xDA, ">H", 0xFFFF), (0xDB, ">I", 0xFFFFFFFF))
_BIN = ((0xC4, ">B", 0xFF), (0xC5, ">H", 0xFFFF), (0xC6, ">I", 0xFFFFFFFF))
_ARRAY = ((0xDC, ">H", 0xFFFF), (0xDD, ">I", 0xFFFFFFFF))
_MAP = ((0xDE, ">H", 0xFFFF), (0xDF, ">I", 0xFFFFFFFF))
_EXT = ((0xC7, ">B", 0xFF), (0xC8, ">H", 0xFFFF), (0xC9, ">I", 0xFFFFFFFF))
_FIXEXT_CODE = {n: code for code, n in _FIXEXT.items()}


def _int(out, v):
    if 0 <= v < 0x80:
        out.append(bytes([v]))
    elif -0x20 <= v < 0:
        out.append(bytes([v + 0x100]))
    else:
        for code, fmt, lo, hi in (
                (0xCC, ">B", 0x80, 0xFF), (0xD0, ">b", -0x80, -1),
                (0xCD, ">H", 0x100, 0xFFFF), (0xD1, ">h", -0x8000, -0x81),
                (0xCE, ">I", 0x10000, 0xFFFFFFFF),
                (0xD2, ">i", -0x80000000, -0x8001),
                (0xCF, ">Q", 0x100000000, 0xFFFFFFFFFFFFFFFF),
                (0xD3, ">q", -0x8000000000000000, -0x80000001)):
            if lo <= v <= hi:
                out.append(bytes([code]) + struct.pack(fmt, v))
                return
        raise ValueError(f"integer {v} does not fit msgpack")


def _ext(out, code, data):
    n = len(data)
    if n in _FIXEXT_CODE:
        out.append(bytes([_FIXEXT_CODE[n]]))
    else:
        _head(out, n, None, 0, _EXT)
    out.append(struct.pack(">b", code))
    out.append(data)


def _array_bytes(x):
    """flax's ``_ndarray_to_bytes``: msgpack of (shape, dtype name, C-order
    bytes)."""
    if torch.is_tensor(x):
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            shape, name = tuple(x.shape), "bfloat16"
            raw = x.view(torch.int16).numpy().tobytes()
            return packb([list(shape), name, raw])
        x = x.numpy()
    return packb([list(x.shape), x.dtype.name, x.tobytes("C")])


def _nbytes(x):
    return x.numel() * x.element_size() if torch.is_tensor(x) else x.nbytes


def _chunked(x):
    """flax's ``_chunk``: the flat array in pieces of MAX_CHUNK_SIZE bytes,
    keys in flax's insertion order."""
    itemsize = x.element_size() if torch.is_tensor(x) else x.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = x.reshape(-1)
    n = flat.shape[0]
    return {CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(x.shape)},
            "chunks": {str(j): flat[i:i + size]
                       for j, i in enumerate(range(0, n, size))}}


def _is_array(x):
    return isinstance(x, np.ndarray) or torch.is_tensor(x)


def _pack(out, x, sort_keys=True):
    if x is None:
        out.append(b"\xc0")
    elif x is True or x is False:
        out.append(b"\xc3" if x else b"\xc2")
    elif _is_array(x):
        if _nbytes(x) > MAX_CHUNK_SIZE:
            _pack(out, _chunked(x), sort_keys=False)
        else:
            _ext(out, NDARRAY, _array_bytes(x))
    elif isinstance(x, np.generic):
        _ext(out, NPSCALAR, _array_bytes(np.asarray(x)))
    elif isinstance(x, int):
        _int(out, x)
    elif isinstance(x, float):
        out.append(b"\xcb" + struct.pack(">d", x))
    elif isinstance(x, complex):
        _ext(out, NATIVE_COMPLEX, packb([x.real, x.imag]))
    elif isinstance(x, str):
        data = x.encode("utf-8")
        _head(out, len(data), 0xA0, 0x1F, _STR)
        out.append(data)
    elif isinstance(x, (bytes, bytearray, memoryview)):
        data = bytes(x)
        _head(out, len(data), None, 0, _BIN)
        out.append(data)
    elif isinstance(x, (list, tuple)):
        _head(out, len(x), 0x90, 0x0F, _ARRAY)
        for v in x:
            _pack(out, v)
    elif isinstance(x, dict):
        _head(out, len(x), 0x80, 0x0F, _MAP)
        for k in (sorted(x) if sort_keys else x):
            _pack(out, k)
            _pack(out, x[k], sort_keys)
    else:
        raise TypeError(f"cannot write {type(x).__name__} to msgpack")


def packb(tree):
    """``flax.serialization.msgpack_serialize(tree)``: dicts, lists, Python
    scalars, NumPy arrays and scalars, torch tensors (``bfloat16`` included)
    as leaves."""
    out = []
    _pack(out, tree)
    return b"".join(out)
