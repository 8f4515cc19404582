"""TPC-H ORDERS with each order's LINEITEMs nested in it: an
``o_orderkey`` and an OPTIONAL LIST ``lines`` of a REQUIRED group of six
lineitem columns (the Parquet format's three-level LIST, ``LogicalTypes.md``
"Nested Types"), each lineitem leaf at ``max_def`` 2 and ``max_rep`` 1.

A frozen copy of ``chip_smoke.py``'s phase 10a (``nested_orders``,
``orders_schema``) with the seed made an argument: the configuration's
``lineitems`` rows of :mod:`pqbench.lineitem`'s draw from ``--seed``,
grouped into orders of 1-7 lineitems (TPC-H clause 4.2.3) drawn from a
generator of their own, the last order cut short, with sparse order keys,
``rows_per_group`` orders a row group.  The orders' generator keeps phase
10a's seed (:data:`ORDER_SEED`) whatever ``--seed`` is: every seed then
draws the same orders and the same lineitems a row group, so the work of
a run and the row groups its configuration pins do not move with the
seed; the values do.  ``--seed 4`` draws phase 10a's table.  NumPy only
(``schema`` aside): the strings stay ``(pool, indices)``.
"""

from __future__ import annotations

import numpy as np

from .. import lineitem
from ..reference import Leaf

NESTED_LINE_COLUMNS = ["l_partkey", "l_quantity", "l_extendedprice",
                       "l_shipdate", "l_shipmode", "l_comment"]
LINE_PATH = "lines.list.element."
LEAVES = ["o_orderkey"] + [LINE_PATH + c for c in NESTED_LINE_COLUMNS]
DELTA_COLUMNS: list = []
ORDER_SEED = 7
# rows a group of lineitem's draw (``draw_lineitem16``'s default): the
# order in which the generator is consumed
DRAW_GROUP = 1_000_000


def nested_orders(draws, order_seed: int,
                  orders_per_group: int = 250_000) -> list:
    """Per-row-group dicts of ``orders_per_group`` orders: ``o_orderkey``,
    ``lens`` (lineitems an order), each lineitem column's values (a STRING
    column as ``(pool, indices)``), and ``def``/``rep``, the lineitem
    leaves' levels (every list present: def 2; rep 0 at each order's first
    lineitem)."""
    lines = {}
    for c in NESTED_LINE_COLUMNS:
        parts = [g[c] for g in draws]
        if isinstance(parts[0], tuple):
            lines[c] = (parts[0][0], np.concatenate([p[1] for p in parts]))
        else:
            lines[c] = np.concatenate(parts)
    n_lines = len(lines["l_partkey"])
    rng = np.random.default_rng(order_seed)
    lens = rng.integers(1, 8, n_lines // 3)
    ends = np.cumsum(lens)
    k = int(np.searchsorted(ends, n_lines))
    lens = lens[: k + 1].copy()
    lens[-1] -= int(ends[k]) - n_lines
    keys = np.cumsum(rng.integers(1, 5, len(lens))).astype(np.int64)
    line_start = np.concatenate([[0], np.cumsum(lens)])
    groups = []
    for lo in range(0, len(lens), orders_per_group):
        hi = min(lo + orders_per_group, len(lens))
        a, b = int(line_start[lo]), int(line_start[hi])
        rep = np.ones(b - a, np.int32)
        rep[line_start[lo:hi] - a] = 0
        g = {"o_orderkey": keys[lo:hi], "lens": lens[lo:hi],
             "def": np.full(b - a, 2, np.int32), "rep": rep}
        for c, v in lines.items():
            g[c] = (v[0], v[1][a:b]) if isinstance(v, tuple) else v[a:b]
        groups.append(g)
    return groups


def draw(seed: int, config: dict) -> list:
    n = int(config["lineitems"])
    draws = lineitem.draw(seed, n, DRAW_GROUP)
    return [{"o_orderkey": g["o_orderkey"],
             **{LINE_PATH + c: Leaf(g[c], g["def"], g["rep"], 2, 1)
                for c in NESTED_LINE_COLUMNS}}
            for g in nested_orders(draws, ORDER_SEED,
                                   int(config["rows_per_group"]))]


def schema():
    from tpu_parquet_torch.format import (ConvertedType,
                                          FieldRepetitionType as FRT,
                                          LogicalType, StringType, Type)
    from tpu_parquet_torch.schema.core import (ColumnParameters,
                                               build_schema, data_column,
                                               group_column, list_column)

    utf8 = ColumnParameters(logical_type=LogicalType(STRING=StringType()),
                            converted_type=ConvertedType.UTF8)
    types = {"l_partkey": Type.INT64, "l_quantity": Type.INT64,
             "l_extendedprice": Type.DOUBLE, "l_shipdate": Type.INT32}
    line = [data_column(c, types[c], FRT.REQUIRED) if c in types else
            data_column(c, Type.BYTE_ARRAY, FRT.REQUIRED, utf8)
            for c in NESTED_LINE_COLUMNS]
    return build_schema([
        data_column("o_orderkey", Type.INT64, FRT.REQUIRED),
        list_column("lines", group_column("element", line, FRT.REQUIRED),
                    FRT.OPTIONAL)])
