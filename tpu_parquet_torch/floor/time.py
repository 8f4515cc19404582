"""Time-of-day value type.

Equivalent of the reference's floor.Time (floor/time.go:10-146): nanoseconds since
midnight with an adjusted-to-UTC flag, converting to/from the TIME logical type's
MILLIS/MICROS/NANOS representations.  Interoperates with datetime.time.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass


def parse_iso_datetime(s: str) -> datetime.datetime:
    """ISO-8601 string → datetime, accepting a trailing 'Z' (shared by the
    floor marshaller and csv2parquet — one timestamp-string parser)."""
    return datetime.datetime.fromisoformat(s.strip().replace("Z", "+00:00"))


@dataclass(frozen=True, order=True)
class Time:
    nanoseconds: int  # since midnight
    utc: bool = True

    def __post_init__(self):
        if not 0 <= self.nanoseconds < 86_400_000_000_000:
            raise ValueError(f"time of day out of range: {self.nanoseconds}ns")

    # -- constructors (floor/time.go NewTime/TimeFrom* parity) ----------------

    @classmethod
    def from_parts(cls, hour: int, minute: int, second: int = 0, ns: int = 0,
                   utc: bool = True) -> "Time":
        if not (0 <= hour < 24 and 0 <= minute < 60 and 0 <= second < 60
                and 0 <= ns < 1_000_000_000):
            raise ValueError(f"invalid time {hour}:{minute}:{second}.{ns}")
        return cls(((hour * 60 + minute) * 60 + second) * 1_000_000_000 + ns, utc)

    @classmethod
    def from_nanoseconds(cls, ns: int, utc: bool = True) -> "Time":
        return cls(ns, utc)

    @classmethod
    def from_microseconds(cls, us: int, utc: bool = True) -> "Time":
        return cls(us * 1000, utc)

    @classmethod
    def from_milliseconds(cls, ms: int, utc: bool = True) -> "Time":
        return cls(ms * 1_000_000, utc)

    @classmethod
    def from_datetime_time(cls, t: datetime.time) -> "Time":
        return cls.from_parts(t.hour, t.minute, t.second, t.microsecond * 1000,
                              utc=t.tzinfo is not None)

    # -- accessors -------------------------------------------------------------

    @property
    def hour(self) -> int:
        return self.nanoseconds // 3_600_000_000_000

    @property
    def minute(self) -> int:
        return (self.nanoseconds // 60_000_000_000) % 60

    @property
    def second(self) -> int:
        return (self.nanoseconds // 1_000_000_000) % 60

    @property
    def nanosecond(self) -> int:
        return self.nanoseconds % 1_000_000_000

    def milliseconds(self) -> int:
        return self.nanoseconds // 1_000_000

    def microseconds(self) -> int:
        return self.nanoseconds // 1000

    def to_datetime_time(self) -> datetime.time:
        return datetime.time(
            self.hour, self.minute, self.second, self.nanosecond // 1000,
            tzinfo=datetime.timezone.utc if self.utc else None,
        )

    def __str__(self):
        base = f"{self.hour:02d}:{self.minute:02d}:{self.second:02d}"
        if self.nanosecond:
            base += f".{self.nanosecond:09d}".rstrip("0")
        return base + ("Z" if self.utc else "")
