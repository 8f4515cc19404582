"""TPC-H ORDERS at full width with each order's LINEITEMs nested in it:
ORDERS' nine columns (clause 1.4), flat and REQUIRED, then an OPTIONAL LIST
``lines`` of a REQUIRED group of LINEITEM's fifteen columns other than
``l_orderkey`` (the parent's key), each lineitem leaf at ``max_def`` 2 and
``max_rep`` 1 (the Parquet format's three-level LIST, ``LogicalTypes.md``
"Nested Types").

The lineitems are :mod:`pqbench.lineitem`'s frozen draw from ``--seed``,
the configuration's ``lineitems`` rows; the orders' structure (1-7
lineitems an order, sparse keys, the levels) is :mod:`.orders_nested`'s,
drawn from its fixed :data:`~.orders_nested.ORDER_SEED` whatever the seed,
so every seed reads the same orders in the same row groups of
``rows_per_group`` orders.  ORDERS' own columns follow clause 4.2.3:
``o_orderstatus`` and ``o_totalprice`` derive from the order's lineitems
(``F`` where every line's ``l_linestatus`` is ``F``, ``O`` where every one
is ``O``, else ``P``; the sum of ``l_extendedprice * (1 + l_tax) *
(1 - l_discount)``), the others are drawn uniformly from a generator of
their own on ``--seed``: ``o_custkey`` 1-150,000, ``o_orderdate`` from
1992-01-01 through 151 days before 1998-12-31, ``o_orderpriority`` one of
the five priorities, ``o_clerk`` one of 1,000 clerks, ``o_shippriority``
0, ``o_comment`` from a pool of 256 strings of 4-12 words.  NumPy only
(``schema`` aside): the strings stay ``(pool, indices)``.
"""

from __future__ import annotations

import numpy as np

from .. import lineitem
from ..reference import Leaf
from . import orders_nested

ORDER_COLUMNS = ["o_orderkey", "o_custkey", "o_orderstatus", "o_totalprice",
                 "o_orderdate", "o_orderpriority", "o_clerk",
                 "o_shippriority", "o_comment"]
LINE_COLUMNS = [c for c in lineitem.COLUMNS if c != "l_orderkey"]
LINE_PATH = orders_nested.LINE_PATH
LEAVES = ORDER_COLUMNS + [LINE_PATH + c for c in LINE_COLUMNS]
# lineitem's DELTA columns, the parent's key in l_orderkey's place
DELTA_COLUMNS = ["o_orderkey", "o_orderdate"] + [
    LINE_PATH + c for c in lineitem.DELTA_COLUMNS if c != "l_orderkey"]
# o_orderdate's last day: 151 days before 1998-12-31 (clause 4.2.3)
ORDER_DATE_SPAN = 2406
STATUS = [b"F", b"O", b"P"]
PRIORITIES = [b"1-URGENT", b"2-HIGH", b"3-MEDIUM", b"4-NOT SPECIFIED",
              b"5-LOW"]
CLERKS = [b"Clerk#%09d" % i for i in range(1, 1001)]
_NOTE_WORDS = [f"note{i}".encode() for i in range(96)]
COMMENTS = [b" ".join(_NOTE_WORDS[j % 96] for j in range(i, i + 4 + i % 9))
            for i in range(256)]


def _whole(draws: list, c: str):
    """One lineitem column over the whole draw (a STRING column as
    ``(pool, indices)``)."""
    parts = [g[c] for g in draws]
    if isinstance(parts[0], tuple):
        return parts[0][0], np.concatenate([p[1] for p in parts])
    return np.concatenate(parts)


def _orders(seed: int, lines: dict, lens: np.ndarray) -> dict:
    """ORDERS' columns but the key, one entry an order of ``lens``
    lineitems."""
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    status = lines["l_linestatus"][1]
    n_f = np.add.reduceat((status == 0).astype(np.int64), starts)
    state = np.where(n_f == lens, 0, np.where(n_f == 0, 1, 2))
    price = np.add.reduceat(lines["l_extendedprice"]
                            * (1 + lines["l_tax"])
                            * (1 - lines["l_discount"]), starts)
    rng = np.random.default_rng([lineitem.rng_seed(seed), 1])
    n = len(lens)
    return {
        "o_custkey": rng.integers(1, 150_001, n),
        "o_orderstatus": (STATUS, state),
        "o_totalprice": price,
        "o_orderdate": (lineitem.DATE_BASE
                        + rng.integers(0, ORDER_DATE_SPAN, n)
                        ).astype(np.int32),
        "o_orderpriority": (PRIORITIES, rng.integers(0, len(PRIORITIES), n)),
        "o_clerk": (CLERKS, rng.integers(0, len(CLERKS), n)),
        "o_shippriority": np.zeros(n, np.int32),
        "o_comment": (COMMENTS, rng.integers(0, len(COMMENTS), n)),
    }


def draw(seed: int, config: dict) -> list:
    n = int(config["lineitems"])
    draws = lineitem.draw(seed, n, orders_nested.DRAW_GROUP)
    groups = orders_nested.nested_orders(draws, orders_nested.ORDER_SEED,
                                         int(config["rows_per_group"]))
    lines = {c: _whole(draws, c) for c in LINE_COLUMNS}
    del draws
    lens = np.concatenate([g["lens"] for g in groups])
    orders = _orders(seed, lines, lens)
    out = []
    o_lo = l_lo = 0
    for g in groups:
        o_hi, l_hi = o_lo + len(g["lens"]), l_lo + int(g["lens"].sum())
        row = {"o_orderkey": g["o_orderkey"]}
        for c in ORDER_COLUMNS[1:]:
            v = orders[c]
            row[c] = (v[0], v[1][o_lo:o_hi]) if isinstance(v, tuple) \
                else v[o_lo:o_hi]
        for c in LINE_COLUMNS:
            v = lines[c]
            row[LINE_PATH + c] = Leaf(
                (v[0], v[1][l_lo:l_hi]) if isinstance(v, tuple)
                else v[l_lo:l_hi], g["def"], g["rep"], 2, 1)
        out.append(row)
        o_lo, l_lo = o_hi, l_hi
    return out


def schema():
    """ORDERS' nine columns REQUIRED, then ``lines``: an OPTIONAL LIST of a
    REQUIRED group of LINEITEM's fifteen, the STRING columns UTF8."""
    from tpu_parquet_torch.format import (ConvertedType,
                                          FieldRepetitionType as FRT,
                                          LogicalType, StringType, Type)
    from tpu_parquet_torch.schema.core import (ColumnParameters,
                                               build_schema, data_column,
                                               group_column, list_column)

    utf8 = ColumnParameters(logical_type=LogicalType(STRING=StringType()),
                            converted_type=ConvertedType.UTF8)
    order_types = {"o_orderkey": Type.INT64, "o_custkey": Type.INT64,
                   "o_totalprice": Type.DOUBLE, "o_orderdate": Type.INT32,
                   "o_shippriority": Type.INT32}

    def column(c, ptype):
        if ptype == Type.BYTE_ARRAY:
            return data_column(c, ptype, FRT.REQUIRED, utf8)
        return data_column(c, ptype, FRT.REQUIRED)

    orders = [column(c, order_types.get(c, Type.BYTE_ARRAY))
              for c in ORDER_COLUMNS]
    line = [column(c, getattr(Type, lineitem.PHYSICAL[c]))
            for c in LINE_COLUMNS]
    return build_schema(orders + [
        list_column("lines", group_column("element", line, FRT.REQUIRED),
                    FRT.OPTIONAL)])
