"""Observability helpers: environment knobs that degrade, and latency
histograms.

The seed of the port's ``obs``, a copy of the parts of ``tpu_parquet.obs``
that the IO layer needs:

- :func:`env_float` / :func:`env_int` / :func:`warn_env_once` — a malformed
  ``TPQ_*`` value never raises: it falls back to the default with ONE
  warning line per (name, value) pair, shared by every knob of the package
  (the IO knobs here, the data-error knobs of ``quarantine``);
- :class:`LatencyHistogram` — the log2-bucketed latency distribution the
  stores record fetch times into (the learned hedge delay reads its p90)
  and the fetch engine records queue waits into.

Left out of the reference (Queue 1 item 5.5): the tracer and its spans,
the sampler, the flight recorder and its sources, the watchdog, the
registry and its folds, and the histograms' merging, serialization and
exemplars (trace ids), which only the registry reads.
"""

from __future__ import annotations

import logging
import os
import threading

__all__ = ["LatencyHistogram", "env_float", "env_int", "warn_env_once"]

# (name, raw) pairs already warned about: one line per bad value, not one
# per reader construction (a scan over 1000 shards must not log 1000 times)
_env_warned: "set[tuple[str, str]]" = set()


def _env_num(name: str, default, cast, lo=None, hi=None):
    raw = os.environ.get(name, "")
    if not raw:
        return default
    try:
        v = cast(raw)
    except (TypeError, ValueError):
        key = (name, raw)
        if key not in _env_warned:
            _env_warned.add(key)
            logging.getLogger(__name__).warning(
                "%s=%r is not a valid %s; using the default %r",
                name, raw, cast.__name__, default)
        return default
    if lo is not None and v < lo:
        v = lo
    if hi is not None and v > hi:
        v = hi
    return v


def env_float(name: str, default: float, lo=None, hi=None) -> float:
    """``float(os.environ[name])``: unset gives ``default``; malformed
    gives ``default`` plus ONE warning line; out-of-range values clamp to
    ``[lo, hi]``."""
    return _env_num(name, default, float, lo, hi)


def env_int(name: str, default: int, lo=None, hi=None) -> int:
    """Integer twin of :func:`env_float`, the same degradation."""
    return _env_num(name, default, int, lo, hi)


def warn_env_once(name: str, raw: str, fallback) -> None:
    """One warning line per bad (env var, value) pair, for the knobs that
    are not numbers (``TPQ_ON_DATA_ERROR``, ``TPQ_VALIDATE``,
    ``TPQ_DATA_ERROR_BUDGET``): the same set as the numeric knobs."""
    key = (name, raw)
    if key not in _env_warned:
        _env_warned.add(key)
        logging.getLogger(__name__).warning(
            "%s=%r is not valid; using %r", name, raw, fallback)


class LatencyHistogram:
    """Log2-bucketed latency distribution; lock-protected.

    Bucket ``i`` holds durations whose nanosecond count has bit length
    ``i`` (``[2^(i-1), 2^i)`` ns; bucket 0 is exactly 0 ns): about 62
    sparse buckets cover 1 ns to minutes with under 2x relative error.
    Quantiles take the bucket's geometric midpoint."""

    __slots__ = ("_lock", "buckets", "count", "max_seconds")

    def __init__(self):
        self._lock = threading.Lock()
        self.buckets: dict[int, int] = {}
        self.count = 0
        self.max_seconds = 0.0

    @staticmethod
    def bucket_index(seconds: float) -> int:
        """The bucket a duration lands in."""
        ns = int(seconds * 1e9)
        return ns.bit_length() if ns > 0 else 0

    def record(self, seconds: float) -> None:
        idx = self.bucket_index(seconds)
        with self._lock:
            self.buckets[idx] = self.buckets.get(idx, 0) + 1
            self.count += 1
            if seconds > self.max_seconds:
                self.max_seconds = seconds

    def quantile(self, q: float) -> float:
        """Approximate quantile in seconds (geometric bucket midpoint)."""
        with self._lock:
            if not self.count:
                return 0.0
            target = q * self.count
            seen = 0
            for i in sorted(self.buckets):
                seen += self.buckets[i]
                if seen >= target:
                    if i == 0:
                        return 0.0
                    return (2.0 ** (i - 0.5)) / 1e9
            return self.max_seconds
