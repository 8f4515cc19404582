"""INT96 legacy timestamp conversions.

Equivalent of the reference's int96_time.go:33-56 (`Int96ToTime`/`TimeToInt96`):
the 12-byte INT96 layout is 8 bytes little-endian nanoseconds-within-day followed
by 4 bytes little-endian Julian day number.  Vectorized over (n, 3) uint32
matrices (the decode representation from kernels/plain.py).
"""

from __future__ import annotations

import datetime

import numpy as np

JULIAN_UNIX_EPOCH = 2440588  # Julian day number of 1970-01-01
NS_PER_DAY = 86_400_000_000_000


def int96_to_ns_epoch(arr: np.ndarray) -> np.ndarray:
    """(n, 3) uint32 INT96 → int64 nanoseconds since unix epoch."""
    a = np.asarray(arr, dtype=np.uint32).reshape(-1, 3)
    nanos = a[:, 0].astype(np.uint64) | (a[:, 1].astype(np.uint64) << np.uint64(32))
    days = a[:, 2].astype(np.int64) - JULIAN_UNIX_EPOCH
    return days * NS_PER_DAY + nanos.astype(np.int64)


def ns_epoch_to_int96(ns: np.ndarray) -> np.ndarray:
    """int64 nanoseconds since unix epoch → (n, 3) uint32 INT96.

    Like the reference (int96_time.go IsAfterUnixEpoch gate), only post-epoch
    times are representable; negative inputs raise.
    """
    ns = np.asarray(ns, dtype=np.int64)
    if np.any(ns < 0):
        raise ValueError("INT96 conversion only supports times at/after the unix epoch")
    days, rem = np.divmod(ns, NS_PER_DAY)
    out = np.empty((len(ns), 3), dtype=np.uint32)
    rem_u = rem.astype(np.uint64)
    out[:, 0] = (rem_u & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    out[:, 1] = (rem_u >> np.uint64(32)).astype(np.uint32)
    out[:, 2] = (days + JULIAN_UNIX_EPOCH).astype(np.uint32)
    return out


def int96_to_datetime(v) -> datetime.datetime:
    """One INT96 value (12 bytes or (3,) uint32) → aware UTC datetime."""
    if isinstance(v, (bytes, bytearray)):
        v = np.frombuffer(bytes(v), "<u4")
    ns = int(int96_to_ns_epoch(np.asarray(v).reshape(1, 3))[0])
    return datetime.datetime.fromtimestamp(
        ns // 1_000_000_000, tz=datetime.timezone.utc
    ).replace(microsecond=(ns // 1000) % 1_000_000)


def datetime_to_int96(dt: datetime.datetime) -> bytes:
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=datetime.timezone.utc)
    delta = dt - datetime.datetime(1970, 1, 1, tzinfo=datetime.timezone.utc)
    ns = (delta.days * 86_400 + delta.seconds) * 1_000_000_000 + delta.microseconds * 1000
    return ns_epoch_to_int96(np.array([ns]))[0].astype("<u4").tobytes()
