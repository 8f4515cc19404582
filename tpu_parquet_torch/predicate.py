"""Statistics-based pruning (predicate pushdown): row groups and pages.

The counterpart of ``tpu_parquet.predicate``.  A small predicate algebra is
evaluated against the footer's per-chunk min/max/null_count
(:func:`prune_row_groups`: no byte of a pruned group is read) and, inside
a surviving flat row group, against the page headers' statistics
(:func:`prune_pages`: whole-page-aligned row runs the readers never
decompress, stage or decode).

    from tpu_parquet_torch.predicate import col
    pred = (col("l_shipdate") >= 8766) & (col("l_quantity") < 24)
    with DeviceFileReader(path, row_filter=pred) as r:
        for cols in r.iter_row_groups():              # pruned groups skipped
            ...

Soundness: every node evaluates to a pair of bounds — ``can_match`` (False
only when NO row in the group can satisfy the predicate) and ``always_match``
(True only when EVERY row must).  Missing or unreadable statistics degrade to
(True, False) — never prune on absent evidence.  SQL comparison semantics:
a NULL value satisfies no comparison, so ``~(col > v)`` is NOT ``col <= v``
— negation swaps the two bounds, which stays sound for both.  Unsigned and
decimal columns, and the legacy min/max fields of byte arrays, are never
evidence.
"""

from __future__ import annotations

import bisect
import struct
from dataclasses import dataclass
from typing import Optional

from .format import ConvertedType, Type
from .errors import ParquetError

__all__ = ["col", "Predicate", "prune_row_groups", "chunk_stats_range",
           "parse_filter"]


_INT_FMT = {Type.INT32: "<i", Type.INT64: "<q"}
_FLT_FMT = {Type.FLOAT: "<f", Type.DOUBLE: "<d"}


def _is_unsigned(elem) -> bool:
    ct = getattr(elem, "converted_type", None)
    if ct in (ConvertedType.UINT_8, ConvertedType.UINT_16,
              ConvertedType.UINT_32, ConvertedType.UINT_64):
        return True
    lt = getattr(elem, "logicalType", None)
    it = getattr(lt, "INTEGER", None) if lt is not None else None
    return it is not None and it.isSigned is False


def _is_decimal(elem) -> bool:
    """DECIMAL stats order by signed numeric value, not by the raw-int or
    lexicographic order this module compares with — and the row APIs yield
    SCALED Decimal values, so even int-backed decimals would compare against
    the wrong magnitude.  Degrade to no-evidence."""
    if getattr(elem, "converted_type", None) == ConvertedType.DECIMAL:
        return True
    lt = getattr(elem, "logicalType", None)
    return lt is not None and getattr(lt, "DECIMAL", None) is not None


def _decode_bound(raw: Optional[bytes], ptype: int, elem,
                  deprecated: bool) -> Optional[object]:
    """Decode one serialized min/max bound to a comparable Python value.

    ``deprecated`` marks the legacy Statistics.min/max fields, whose ordering
    is ambiguous for anything but plain signed numerics (PARQUET-251: old
    writers compared BYTE_ARRAY with *signed* bytes) — they degrade to
    no-evidence except for INT/FLOAT/DOUBLE.
    """
    if raw is None:
        return None
    if _is_decimal(elem):
        return None
    try:
        if ptype in _INT_FMT:
            if len(raw) != struct.calcsize(_INT_FMT[ptype]):
                return None
            # unsigned columns (converted OR logical type) sort differently
            # than the signed decode: degrade to no-evidence
            if _is_unsigned(elem):
                return None
            return struct.unpack(_INT_FMT[ptype], raw)[0]
        if ptype in _FLT_FMT:
            if len(raw) != struct.calcsize(_FLT_FMT[ptype]):
                return None
            return struct.unpack(_FLT_FMT[ptype], raw)[0]
        if ptype == Type.BYTE_ARRAY and not deprecated:
            return bytes(raw)
    except (struct.error, TypeError):
        return None
    return None


def stats_range(st, ptype, elem, num_values):
    """(min, max, null_count, num_values, ptype) from one Statistics object
    (chunk- or page-level); None bounds where absent/undecodable."""
    if st is None:
        return None, None, None, num_values, ptype
    if st.min_value is not None or st.max_value is not None:
        mn_raw, mx_raw, deprecated = st.min_value, st.max_value, False
    else:
        mn_raw, mx_raw, deprecated = st.min, st.max, True
    mn = _decode_bound(mn_raw, ptype, elem, deprecated)
    mx = _decode_bound(mx_raw, ptype, elem, deprecated)
    return mn, mx, st.null_count, num_values, ptype


def chunk_stats_range(md, elem):
    """(min, max, null_count, num_values, ptype) from one chunk's metadata;
    None bounds where statistics are absent/undecodable."""
    return stats_range(md.statistics, md.type, elem, md.num_values)


@dataclass(frozen=True)
class _Bounds:
    can: bool      # upper bound: group MAY contain a matching row
    always: bool   # lower bound: EVERY row in the group matches

    def __invert__(self):
        return _Bounds(can=not self.always, always=not self.can)


_NO_EVIDENCE = _Bounds(True, False)


class Predicate:
    """Base class; combine with ``&``, ``|``, ``~``."""

    def __and__(self, other):
        return _And(self, other)

    def __or__(self, other):
        return _Or(self, other)

    def __invert__(self):
        return _Not(self)

    # -- evaluation ---------------------------------------------------------

    def _bounds(self, stats_of) -> _Bounds:  # pragma: no cover - abstract
        raise NotImplementedError

    def columns(self) -> set:
        raise NotImplementedError


@dataclass(frozen=True)
class _And(Predicate):
    a: Predicate
    b: Predicate

    def _bounds(self, stats_of):
        x, y = self.a._bounds(stats_of), self.b._bounds(stats_of)
        return _Bounds(x.can and y.can, x.always and y.always)

    def columns(self):
        return self.a.columns() | self.b.columns()


@dataclass(frozen=True)
class _Or(Predicate):
    a: Predicate
    b: Predicate

    def _bounds(self, stats_of):
        x, y = self.a._bounds(stats_of), self.b._bounds(stats_of)
        return _Bounds(x.can or y.can, x.always or y.always)

    def columns(self):
        return self.a.columns() | self.b.columns()


@dataclass(frozen=True)
class _Not(Predicate):
    a: Predicate

    def _bounds(self, stats_of):
        return ~self.a._bounds(stats_of)

    def columns(self):
        return self.a.columns()


@dataclass(frozen=True)
class _Cmp(Predicate):
    """column <op> literal.  NULL rows satisfy no comparison."""

    column: str
    op: str  # lt le gt ge eq ne
    value: object

    def columns(self):
        return {self.column}

    def _bounds(self, stats_of):
        got = stats_of(self.column)
        if got is None:
            return _NO_EVIDENCE
        mn, mx, nulls, num, ptype = got
        v = self.value
        if isinstance(v, str):
            v = v.encode()
        all_null = nulls is not None and num is not None and nulls == num
        if all_null:
            return _Bounds(False, False)  # no non-null row to satisfy anything
        no_nulls = nulls == 0
        if mn is None or mx is None:
            return _NO_EVIDENCE
        # FLOAT/DOUBLE stats exclude NaN rows (this repo's stats.py; other
        # writers vary).  A NaN row satisfies NO ordered comparison and EVERY
        # inequality — so for floats the 'always' bound can never be proven
        # from min/max, and 'ne' may always match.
        is_float = ptype in _FLT_FMT
        try:
            if self.op == "lt":
                can, always = mn < v, mx < v
            elif self.op == "le":
                can, always = mn <= v, mx <= v
            elif self.op == "gt":
                can, always = mx > v, mn > v
            elif self.op == "ge":
                can, always = mx >= v, mn >= v
            elif self.op == "eq":
                can, always = mn <= v <= mx, mn == v == mx
            elif self.op == "ne":
                can, always = is_float or not (mn == v == mx), v < mn or v > mx
            else:  # pragma: no cover
                raise ParquetError(f"unknown predicate op {self.op}")
        except TypeError:
            return _NO_EVIDENCE  # incomparable literal: no evidence
        if is_float:
            always = False  # a possible NaN row breaks every 'always' proof
        return _Bounds(can, always and no_nulls)


@dataclass(frozen=True)
class _IsNull(Predicate):
    column: str
    want_null: bool

    def columns(self):
        return {self.column}

    def _bounds(self, stats_of):
        got = stats_of(self.column)
        if got is None:
            return _NO_EVIDENCE
        _, _, nulls, num, _ = got
        if nulls is None or num is None:
            return _NO_EVIDENCE
        has_null = nulls > 0
        all_null = nulls == num
        if self.want_null:
            return _Bounds(has_null, all_null)
        return _Bounds(not all_null, not has_null)


class _Column:
    """Comparison builder: ``col("a") > 3`` etc."""

    def __init__(self, name: str):
        self._name = name

    def __lt__(self, v):
        return _Cmp(self._name, "lt", v)

    def __le__(self, v):
        return _Cmp(self._name, "le", v)

    def __gt__(self, v):
        return _Cmp(self._name, "gt", v)

    def __ge__(self, v):
        return _Cmp(self._name, "ge", v)

    def __eq__(self, v):  # noqa: PLR0124
        return _Cmp(self._name, "eq", v)

    def __ne__(self, v):
        return _Cmp(self._name, "ne", v)

    def __hash__(self):
        return hash(self._name)

    def is_null(self):
        return _IsNull(self._name, True)

    def not_null(self):
        return _IsNull(self._name, False)

    def between(self, lo, hi):
        """lo <= col <= hi (inclusive both ends)."""
        return _Cmp(self._name, "ge", lo) & _Cmp(self._name, "le", hi)


def col(name: str) -> _Column:
    """Start a predicate on a (dotted) column path."""
    return _Column(name)


def parse_filter(text: str) -> Predicate:
    """Parse a textual predicate: ``"a > 5 and (b == 'x' or not c <= 3.5)"``.

    Python expression syntax via the ``ast`` module (no eval): comparisons of
    a column name against an int/float/str/bytes literal, combined with
    ``and``/``or``/``not``; ``col == None`` / ``col != None`` map to
    is_null/not_null.  Dotted column paths are written ``a.b.c``.
    """
    import ast

    try:
        tree = ast.parse(text, mode="eval")
    except SyntaxError as e:
        raise ParquetError(f"invalid filter expression: {e}") from None

    def name_of(node):
        parts = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            raise ParquetError("filter: column must be a (dotted) name")
        parts.append(node.id)
        return ".".join(reversed(parts))

    def literal(node):
        if isinstance(node, ast.Constant) and isinstance(
            node.value, (int, float, str, bytes, type(None))
        ):
            return node.value
        if (isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub)
                and isinstance(node.operand, ast.Constant)
                and isinstance(node.operand.value, (int, float))):
            return -node.operand.value
        raise ParquetError("filter: literal must be int/float/str/None")

    OPS = {ast.Lt: "lt", ast.LtE: "le", ast.Gt: "gt", ast.GtE: "ge",
           ast.Eq: "eq", ast.NotEq: "ne"}
    FLIP = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le",
            "eq": "eq", "ne": "ne"}

    def walk(node) -> Predicate:
        if isinstance(node, ast.BoolOp):
            parts = [walk(v) for v in node.values]
            out = parts[0]
            for nxt in parts[1:]:
                out = (out & nxt) if isinstance(node.op, ast.And) else (out | nxt)
            return out
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not):
            return ~walk(node.operand)
        if isinstance(node, ast.Compare):
            if len(node.ops) != 1:
                raise ParquetError("filter: chained comparisons unsupported")
            op = OPS.get(type(node.ops[0]))
            if op is None:
                raise ParquetError("filter: unsupported comparison operator")
            lhs, rhs = node.left, node.comparators[0]
            if isinstance(lhs, (ast.Name, ast.Attribute)):
                name, lit = name_of(lhs), literal(rhs)
            elif isinstance(rhs, (ast.Name, ast.Attribute)):
                name, lit, op = name_of(rhs), literal(lhs), FLIP[op]
            else:
                raise ParquetError("filter: one side must be a column name")
            if lit is None:
                if op == "eq":
                    return _IsNull(name, True)
                if op == "ne":
                    return _IsNull(name, False)
                raise ParquetError("filter: None only supports ==/!=")
            return _Cmp(name, op, lit)
        raise ParquetError(
            f"filter: unsupported syntax {ast.dump(node)[:40]}"
        )

    return walk(tree.body)


def prune_pages(filter_pages, all_boundaries, num_rows, predicate,
                leaves) -> "list[tuple[int, int]]":
    """Whole-page-aligned droppable row runs within one (flat) row group.

    ``filter_pages``: {column: (ends, stats_list, ptype)} — per data page of
    each FILTER column, the cumulative row end and the page-header
    Statistics (None where absent).  ``all_boundaries``: {column: ends} for
    EVERY selected column.  Returns maximal row runs [a, b) where the
    predicate provably matches no row, SHRUNK so that a and b are page
    boundaries of every selected column — dropping such a run means every
    column drops only whole pages, so decoded columns stay row-aligned with
    no sub-page surgery (the page analog of prune_row_groups' lattice;
    the Go reference carries page stats but never reads them).

    Soundness mirrors prune_row_groups: absent/undecodable stats are
    no-evidence, repeated columns never arrive here (callers gate on
    max_rep == 0).
    """
    # elementary breakpoints: every filter column's page edges
    bps = {0, num_rows}
    for ends, _, _ in filter_pages.values():
        bps.update(int(e) for e in ends)
    bps = sorted(b for b in bps if 0 <= b <= num_rows)
    dropped = []
    for a, b in zip(bps[:-1], bps[1:]):
        if a >= b:
            continue

        def stats_of(name, _a=a):
            fp = filter_pages.get(name)
            if fp is None:
                return None
            ends, stats_list, ptype = fp
            # the page containing row _a (elementary: one page per column)
            i = bisect.bisect_right(ends, _a)
            if i >= len(stats_list):
                return None
            start = int(ends[i - 1]) if i else 0
            return stats_range(stats_list[i], ptype, leaves[name].element,
                               int(ends[i]) - start)

        if not predicate._bounds(stats_of).can:
            if dropped and dropped[-1][1] == a:
                dropped[-1] = (dropped[-1][0], b)
            else:
                dropped.append((a, b))
    # shrink each run to whole-page edges of EVERY selected column — to a
    # FIXED POINT: rounding to one column's edges can land between another's
    # (lo only rises, hi only falls, so this terminates)
    out = []
    for a, b in dropped:
        lo, hi = a, b
        changed = True
        while changed and lo < hi:
            changed = False
            for ends in all_boundaries.values():
                edges = [0] + [int(e) for e in ends]
                i = bisect.bisect_left(edges, lo)
                lo2 = edges[i] if i < len(edges) else num_rows
                j = bisect.bisect_right(edges, hi) - 1
                hi2 = edges[j] if j >= 0 else 0
                nlo, nhi = max(lo, lo2), min(hi, hi2)
                if (nlo, nhi) != (lo, hi):
                    lo, hi = nlo, nhi
                    changed = True
        if lo < hi:
            out.append((lo, hi))
    return out


def prune_row_groups(metadata, schema, predicate: Predicate) -> list[bool]:
    """Per-row-group keep/skip flags: False means NO row can match.

    Unknown columns raise (a typo would silently disable pruning);
    group/repeated columns and absent stats never cause pruning.
    """
    leaves = {".".join(l.path): l for l in schema.leaves}
    for name in predicate.columns():
        if name not in leaves:
            raise ParquetError(f"row_filter references unknown column {name!r}")
    keep = []
    for rg in metadata.row_groups:
        by_name = {}
        for chunk in rg.columns or []:
            md = chunk.meta_data
            if md is not None and md.path_in_schema:
                by_name[".".join(md.path_in_schema)] = md

        def stats_of(name, _by=by_name):
            md = _by.get(name)
            if md is None:
                return None
            leaf = leaves[name]
            if leaf.max_rep > 0:
                return None  # repeated: row<->value mapping is not 1:1
            return chunk_stats_range(md, leaf.element)

        keep.append(predicate._bounds(stats_of).can)
    return keep
