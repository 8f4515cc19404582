"""TPC-H LINEITEM rows drawn from a seed: the benchmark's frozen generator.

A copy of ``chip_smoke.py``'s ``draw_lineitem16`` (itself ``bench.py``
``gen_lineitem16``'s draw) with the seed made an argument.  NumPy only: the
reference reads these arrays, so this module imports nothing of the program.

Value distributions are uniform, not dbgen's, and ``l_comment`` is a pool of
256 five-word strings (each configuration file lists both under
``assumed``).  ``l_orderkey`` is strictly increasing, so a key names its row.
"""

from __future__ import annotations

import numpy as np

COLUMNS = ["l_orderkey", "l_partkey", "l_suppkey", "l_linenumber",
           "l_quantity", "l_extendedprice", "l_discount", "l_tax",
           "l_returnflag", "l_linestatus", "l_shipdate", "l_commitdate",
           "l_receiptdate", "l_shipinstruct", "l_shipmode", "l_comment"]
STRING_COLUMNS = ["l_returnflag", "l_linestatus", "l_shipinstruct",
                  "l_shipmode", "l_comment"]
# the Parquet physical type of each column the writer is given
PHYSICAL = {c: "INT64" for c in COLUMNS}
PHYSICAL.update({"l_linenumber": "INT32", "l_extendedprice": "DOUBLE",
                 "l_discount": "DOUBLE", "l_tax": "DOUBLE",
                 "l_shipdate": "INT32", "l_commitdate": "INT32",
                 "l_receiptdate": "INT32"})
PHYSICAL.update({c: "BYTE_ARRAY" for c in STRING_COLUMNS})
# the encoding of these columns when the writer declines a dictionary
DELTA_COLUMNS = ["l_orderkey", "l_shipdate", "l_commitdate",
                 "l_receiptdate"]
DATE_BASE = 8035  # 1992-01-01 in days since 1970-01-01
DATE_SPAN = 2526  # through 1998-12-01, TPC-H's shipdate range


def rng_seed(seed: int) -> int:
    """The generator's seed for a run's ``--seed`` (any whole number)."""
    return int(seed) % (1 << 63)


def draw(seed: int, rows: int, rows_per_group: int) -> list:
    """Per-row-group dicts of the 16 columns: the integer and float columns
    as arrays, each STRING column as ``(pool, indices)`` (its values are
    ``pool[indices]``)."""
    flags = [b"A", b"N", b"R"]
    status = [b"F", b"O"]
    instr = [b"DELIVER IN PERSON", b"COLLECT COD", b"NONE",
             b"TAKE BACK RETURN"]
    modes = [b"AIR", b"FOB", b"MAIL", b"RAIL", b"REG AIR", b"SHIP", b"TRUCK"]
    words = [f"word{i}".encode() for i in range(64)]
    comment_pool = [b" ".join(words[j % 64] for j in range(i, i + 5))
                    for i in range(256)]
    rng = np.random.default_rng(rng_seed(seed))
    key = 0
    groups = []
    for lo in range(0, rows, rows_per_group):
        n = min(rows_per_group, rows - lo)
        keys = key + np.cumsum(rng.integers(1, 5, n))
        key = int(keys[-1])
        groups.append({
            "l_orderkey": keys.astype(np.int64),
            "l_partkey": rng.integers(1, 200_000, n),
            "l_suppkey": rng.integers(1, 10_000, n),
            "l_linenumber": rng.integers(1, 8, n).astype(np.int32),
            "l_quantity": rng.integers(1, 51, n),
            "l_extendedprice": rng.uniform(900, 105_000, n),
            "l_discount": rng.uniform(0, 0.1, n).round(2),
            "l_tax": rng.uniform(0, 0.08, n).round(2),
            "l_returnflag": (flags, rng.integers(0, len(flags), n)),
            "l_linestatus": (status, rng.integers(0, len(status), n)),
            "l_shipdate": (DATE_BASE + rng.integers(0, DATE_SPAN, n)).astype(
                np.int32),
            "l_commitdate": (DATE_BASE + rng.integers(0, DATE_SPAN, n)
                             ).astype(np.int32),
            "l_receiptdate": (DATE_BASE + rng.integers(0, DATE_SPAN, n)
                              ).astype(np.int32),
            "l_shipinstruct": (instr, rng.integers(0, len(instr), n)),
            "l_shipmode": (modes, rng.integers(0, len(modes), n)),
            "l_comment": (comment_pool,
                          rng.integers(0, len(comment_pool), n)),
        })
    return groups


def column(groups: list, name: str) -> np.ndarray:
    """One fixed-width column over the whole table."""
    return np.concatenate([g[name] for g in groups])
