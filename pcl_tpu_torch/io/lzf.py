"""LZF compression codec of PCD ``binary_compressed`` bodies.

Counterpart of ``pcl_tpu/io/lzf.py`` (the format of Marc Lehmann's liblzf):

- a control byte ``c < 32`` starts a literal run of ``c + 1`` bytes;
- otherwise a back-reference of length ``(c >> 5) + 2`` (a 3-bit length field
  of 7 takes an extension byte) at offset ``((c & 0x1f) << 8) | next_byte``,
  counted back from the current output position less one.

The C codec ``csrc/lzf.c`` is built at first use (``ops/_build.host_library``)
because PCD bodies are megabytes; where the machine has no C compiler the
pure-Python codec below serves, as in the JAX package. This is host file
parsing, not a device path: the fallback hides neither the device nor a
kernel. Both codecs write valid LZF, so a stream written by either package, by
either codec, is read by the other.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

from pcl_tpu_torch.ops import _build


@functools.lru_cache(maxsize=None)
def _lib() -> Optional[ctypes.CDLL]:
    """The C codec, or None where it cannot be built."""
    try:
        lib = _build.host_library("lzf")
    except (RuntimeError, OSError):
        return None
    for fn in (lib.lzf_decompress, lib.lzf_compress):
        fn.restype = ctypes.c_long
        fn.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_char_p, ctypes.c_long]
    return lib


def decompress(data: bytes, expected_size: int) -> bytes:
    """The ``expected_size`` bytes that ``data`` encodes; anything else
    raises ``ValueError``."""
    lib = _lib()
    if lib is None:
        return _decompress_py(data, expected_size)
    out = ctypes.create_string_buffer(expected_size)
    n = lib.lzf_decompress(data, len(data), out, expected_size)
    if n != expected_size:
        raise ValueError(f"LZF decompress produced {n} bytes, expected {expected_size}")
    return out.raw


def compress(data: bytes) -> bytes:
    lib = _lib()
    if lib is None:
        return _compress_py(data)
    bound = max(len(data) * 2 + 64, 1024)
    out = ctypes.create_string_buffer(bound)
    n = lib.lzf_compress(data, len(data), out, bound)
    if n <= 0:
        raise ValueError("LZF compression failed")
    return out.raw[:n]


def _decompress_py(data: bytes, expected_size: int) -> bytes:
    out = bytearray(expected_size)
    ip, op, n = 0, 0, len(data)
    try:
        while ip < n:
            ctrl = data[ip]
            ip += 1
            if ctrl < 32:
                run = ctrl + 1
                if op + run > expected_size or ip + run > n:
                    raise ValueError("LZF literal run past the end")
                out[op:op + run] = data[ip:ip + run]
                ip += run
                op += run
            else:
                length = ctrl >> 5
                if length == 7:
                    length += data[ip]
                    ip += 1
                length += 2
                ref = op - ((ctrl & 0x1F) << 8) - 1 - data[ip]
                ip += 1
                if ref < 0 or op + length > expected_size:
                    raise ValueError("LZF back-reference out of range")
                for _ in range(length):         # may overlap: byte by byte
                    out[op] = out[ref]
                    op += 1
                    ref += 1
    except IndexError:
        raise ValueError("LZF stream truncated") from None
    if op != expected_size:
        raise ValueError(f"LZF decompress produced {op} bytes, expected {expected_size}")
    return bytes(out)


def _compress_py(data: bytes) -> bytes:
    """A valid LZF stream of literal runs only (no compression): what the
    codec writes where the C library cannot be built."""
    out = bytearray()
    for i in range(0, len(data), 32):
        chunk = data[i:i + 32]
        out.append(len(chunk) - 1)
        out.extend(chunk)
    return bytes(out)
