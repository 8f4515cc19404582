"""Page-block compression codec registry.

Equivalent of the reference's compress.go:16-187: built-in codecs
{UNCOMPRESSED, SNAPPY, GZIP, ZSTD} plus a thread-safe, user-pluggable registry
(`register_codec`, the extension hook compress.go exposes as
``RegisterBlockCompressor``).  Decompression validates the declared uncompressed
size, which is the first line of defense against decompression bombs (mirrors
``newBlockReader``, compress.go:131-152).

SNAPPY uses the native C++ codec (tpu_parquet/native/snappy.cpp) with a pure-Python
raw-snappy implementation as fallback; GZIP uses stdlib zlib; ZSTD uses the
``zstandard`` module when present.

Thread-safety contract: ``decompress_block``/``compress_block`` on a
registered codec instance may be called CONCURRENTLY from the prefetch
pipeline's worker threads (tpu_parquet/pipeline.py).  The built-ins satisfy
it (stateless, or per-thread contexts — see ZstdCompressor); codecs plugged
in via ``register_codec`` must too.
"""

from __future__ import annotations

from .errors import ParquetError

import gzip as _gzip
import io
import threading
import zlib
from typing import Callable, Optional

from .format import CompressionCodec

try:
    import zstandard as _zstd
except ImportError:  # pragma: no cover - present in target image
    _zstd = None

from . import native as _native
from .obs import PART_DECOMPRESS, host_part


class CompressionError(ParquetError):
    pass


class BlockCompressor:
    """Interface for page-block codecs (compress.go:24-27)."""

    def compress_block(self, block: bytes) -> bytes:
        raise NotImplementedError

    def decompress_block(self, block: bytes, uncompressed_size: int) -> bytes:
        raise NotImplementedError


class PlainCompressor(BlockCompressor):
    def compress_block(self, block: bytes) -> bytes:
        return bytes(block)

    def decompress_block(self, block: bytes, uncompressed_size: int) -> bytes:
        return bytes(block)


# ---------------------------------------------------------------------------
# Snappy (raw format) — native C++ preferred, pure-Python fallback
# ---------------------------------------------------------------------------

def _py_snappy_decompress(data: bytes, max_size: int = -1) -> bytes:
    """Pure-Python raw-snappy decoder (same format as native/snappy.cpp)."""
    pos = 0
    n = len(data)
    # uvarint header
    expect = 0
    shift = 0
    while True:
        if pos >= n:
            raise CompressionError("snappy: truncated length header")
        b = data[pos]
        pos += 1
        expect |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
        if shift > 28:
            raise CompressionError("snappy: length varint too long")
    if 0 <= max_size < expect:
        # bomb guard: stream claims more than the page header declared
        raise CompressionError(
            f"snappy stream claims {expect} bytes, page declared {max_size}"
        )
    out = bytearray()
    while pos < n:
        if len(out) > expect:
            # bomb guard inside the loop: copy ops amplify ~21x per input
            # byte, so waiting for the post-hoc length check would allocate
            # the whole bomb first
            raise CompressionError(
                f"snappy: output exceeds declared {expect} bytes"
            )
        tag = data[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:  # literal
            ln = tag >> 2
            if ln >= 60:
                extra = ln - 59
                if pos + extra > n:
                    raise CompressionError("snappy: truncated literal length")
                ln = int.from_bytes(data[pos : pos + extra], "little")
                pos += extra
            ln += 1
            if pos + ln > n:
                raise CompressionError("snappy: truncated literal")
            out += data[pos : pos + ln]
            pos += ln
        else:
            if kind == 1:
                if pos >= n:
                    raise CompressionError("snappy: truncated copy")
                ln = ((tag >> 2) & 7) + 4
                offset = ((tag >> 5) << 8) | data[pos]
                pos += 1
            elif kind == 2:
                if pos + 2 > n:
                    raise CompressionError("snappy: truncated copy")
                ln = (tag >> 2) + 1
                offset = int.from_bytes(data[pos : pos + 2], "little")
                pos += 2
            else:
                if pos + 4 > n:
                    raise CompressionError("snappy: truncated copy")
                ln = (tag >> 2) + 1
                offset = int.from_bytes(data[pos : pos + 4], "little")
                pos += 4
            if offset == 0 or offset > len(out):
                raise CompressionError("snappy: copy offset out of range")
            if offset >= ln:
                start = len(out) - offset
                out += out[start : start + ln]
            else:
                for _ in range(ln):
                    out.append(out[-offset])
    if len(out) != expect:
        raise CompressionError(
            f"snappy: declared {expect} bytes, produced {len(out)}"
        )
    return bytes(out)


def _py_snappy_compress(data: bytes) -> bytes:
    """Literal-only raw snappy (valid but uncompressed; fallback path only)."""
    out = bytearray()
    n = len(data)
    v = n
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    pos = 0
    while pos < n or (n == 0 and pos == 0 and False):
        ln = min(n - pos, 1 << 16)
        if ln == 0:
            break
        m = ln - 1
        if m < 60:
            out.append(m << 2)
        else:
            out.append(62 << 2)
            out += m.to_bytes(3, "little")
        out += data[pos : pos + ln]
        pos += ln
    return bytes(out)


class SnappyCompressor(BlockCompressor):
    def compress_block(self, block: bytes) -> bytes:
        if _native.available():
            return _native.snappy_compress(block)  # input: any buffer
        return _py_snappy_compress(bytes(block))

    def decompress_block(self, block: bytes, uncompressed_size: int):
        # returns bytes OR a uint8 numpy array (bytes-like, zero-copy native
        # path) — consumers must compare/concatenate by content, not type
        try:
            if _native.available():
                # no bytes() copy: the native wrapper takes any contiguous
                # buffer, and returns a uint8 array (not bytes) so the
                # output isn't copied either
                return _native.snappy_decompress(
                    block, max_size=max(uncompressed_size, 0)
                )
            return _py_snappy_decompress(
                bytes(block), max_size=max(uncompressed_size, 0)
            )
        except ValueError as e:
            raise CompressionError(str(e)) from e


class GzipCompressor(BlockCompressor):
    def compress_block(self, block: bytes) -> bytes:
        buf = io.BytesIO()
        with _gzip.GzipFile(fileobj=buf, mode="wb", mtime=0) as g:
            g.write(block)
        return buf.getvalue()

    def decompress_block(self, block: bytes, uncompressed_size: int) -> bytes:
        try:
            # wbits=47 accepts both gzip and zlib wrappers
            d = zlib.decompressobj(wbits=47)
            out = d.decompress(bytes(block), max(uncompressed_size, 0) + 1)
            # bomb guard: if output already exceeds the declared size, or input
            # remains unconsumed, fail *before* inflating the rest via flush()
            if len(out) > uncompressed_size or d.unconsumed_tail:
                raise CompressionError(
                    f"gzip page inflates past declared {uncompressed_size} bytes"
                )
            out += d.flush()
            return out
        except zlib.error as e:
            raise CompressionError(f"gzip: {e}") from e


class ZstdCompressor(BlockCompressor):
    """zstd codec with PER-THREAD compressor/decompressor objects.

    zstandard's context objects are explicitly not safe for concurrent use
    of the same method from multiple threads, and the prefetch pipeline
    (tpu_parquet/pipeline.py) decompresses several chunks' pages on a pool
    against ONE registered codec instance — so each thread lazily builds its
    own pair.  The other built-ins are audited stateless: Plain copies,
    Snappy calls a pure function (native or python), Gzip constructs a fresh
    decompressobj per call.
    """

    def __init__(self, level: int = 3):
        if _zstd is None:
            raise CompressionError("zstandard module not available")
        self._level = level
        self._tls = threading.local()

    def _ctx(self):
        t = self._tls
        if not hasattr(t, "c"):
            t.c = _zstd.ZstdCompressor(level=self._level)
            t.d = _zstd.ZstdDecompressor()
        return t

    def compress_block(self, block: bytes) -> bytes:
        return self._ctx().c.compress(bytes(block))

    def decompress_block(self, block: bytes, uncompressed_size: int) -> bytes:
        try:
            return self._ctx().d.decompress(
                bytes(block), max_output_size=max(uncompressed_size, 1)
            )
        except _zstd.ZstdError as e:
            raise CompressionError(f"zstd: {e}") from e


# ---------------------------------------------------------------------------
# Registry (compress.go:16-27, 160-187)
# ---------------------------------------------------------------------------

_registry_lock = threading.RLock()
_registry: dict[int, BlockCompressor] = {}


def register_codec(codec: int, compressor: BlockCompressor) -> None:
    """Public extension hook, mirroring ``RegisterBlockCompressor``."""
    with _registry_lock:
        _registry[int(codec)] = compressor


def get_codec(codec: int) -> BlockCompressor:
    if codec is None:  # absent thrift field (fuzz: file_reader-7c7d4874355f)
        raise CompressionError("column chunk missing compression codec")
    with _registry_lock:
        c = _registry.get(int(codec))
    if c is None:
        try:
            name = CompressionCodec(codec).name
        except ValueError:
            name = str(codec)
        raise CompressionError(f"unsupported compression codec {name}")
    return c


def registered_codecs() -> list[int]:
    with _registry_lock:
        return sorted(_registry)


def compress_block(block: bytes, codec: int) -> bytes:
    return get_codec(codec).compress_block(block)


@host_part(PART_DECOMPRESS)
def decompress_block(block: bytes, codec: int, uncompressed_size: int):
    """Decompress and validate the size declared in the page header.

    Returns a bytes-LIKE buffer: ``bytes`` from most codecs, a uint8 numpy
    array from the zero-copy native snappy path.  All in-tree consumers
    slice/view via the buffer protocol.

    Mirrors newBlockReader (compress.go:131-152): a mismatch between the header's
    uncompressed_page_size and actual output is corruption, not a warning.
    """
    if uncompressed_size < 0:
        raise CompressionError(f"negative uncompressed size {uncompressed_size}")
    out = get_codec(codec).decompress_block(block, uncompressed_size)
    if len(out) != uncompressed_size:
        raise CompressionError(
            f"page declared {uncompressed_size} uncompressed bytes, got {len(out)}"
        )
    return out


register_codec(CompressionCodec.UNCOMPRESSED, PlainCompressor())
register_codec(CompressionCodec.SNAPPY, SnappyCompressor())
register_codec(CompressionCodec.GZIP, GzipCompressor())
if _zstd is not None:
    register_codec(CompressionCodec.ZSTD, ZstdCompressor())
