"""Writing a configuration's file with the program's writer, and reading
back the layout it got.

A configuration's ``layout`` names its writer, ``writers/<layout>.py``,
which sets the layout alone (codec, dictionary, DELTA, page limits, CRCs);
the schema and the leaves, with their levels, come from the
configuration's table (:mod:`pqbench.tables`) through :func:`columns`.
Frozen copies of ``chip_smoke.py``'s ``fallback_layout``,
``_first_seen_dictionary`` and ``_fallback_encoder_class`` (their ``fail``
calls raise ``RuntimeError`` here), the pyarrow layout's machinery.

Set-up compares :func:`file_layout` with the layout the configuration file
pins, so a change to the writer cannot change the read workload silently.
"""

from __future__ import annotations

import numpy as np

PYARROW_DICT_LIMIT = 1 << 20
PYARROW_PAGE_SIZE = 1 << 20
PYARROW_BATCH = 1024
PYARROW_PAGE_ROWS = 20_000


def _values(v):
    """``(pool, indices)`` built into the program's ``ByteArrayData``; an
    array as it is."""
    from tpu_parquet_torch.column import ByteArrayData

    return (ByteArrayData.from_list(v[0]).take(v[1])
            if isinstance(v, tuple) else v)


def strings_group(group: dict) -> dict:
    """The group with each ``(pool, indices)`` STRING column built into the
    program's ``ByteArrayData``."""
    return {c: _values(v) for c, v in group.items()}


def columns(group: dict) -> dict:
    """A drawn row group as the program's writer takes it: a flat
    fixed-width leaf its array, a STRING leaf a ``ColumnData`` of
    ``ByteArrayData``, a :class:`~pqbench.reference.Leaf` a ``ColumnData``
    with its levels."""
    from tpu_parquet_torch.column import ByteArrayData, ColumnData

    from .reference import Leaf

    out = {}
    for c, v in group.items():
        if isinstance(v, Leaf):
            out[c] = ColumnData(values=_values(v.values),
                                def_levels=v.def_levels,
                                rep_levels=v.rep_levels, max_def=v.max_def,
                                max_rep=v.max_rep,
                                num_leaf_slots=len(v.def_levels))
        else:
            v = _values(v)
            out[c] = (ColumnData(values=v) if isinstance(v, ByteArrayData)
                      else v)
    return out


def _first_seen_dictionary(values):
    """(firsts, ids): the distinct values' first positions in order of
    first appearance, and each value's dictionary id (the program's native
    dictionary build, uncapped)."""
    from tpu_parquet_torch import native
    from tpu_parquet_torch.column import ByteArrayData

    n = len(values)
    if isinstance(values, ByteArrayData):
        res = native.dict_build(
            n, n + 1, offsets=np.ascontiguousarray(values.offsets,
                                                   dtype=np.int64),
            heap=np.ascontiguousarray(values.heap))
    else:
        rows = np.ascontiguousarray(values)
        res = native.dict_build(n, n + 1, data=rows,
                                width=rows.nbytes // max(n, 1))
    if res is None or isinstance(res, int):
        raise RuntimeError("the native dictionary build is unavailable")
    firsts, inverse = res
    return firsts, inverse.astype(np.int64)


def fallback_layout(values, dict_limit: int, page_size: "int | None" = None):
    """pyarrow's page layout for one dictionary-on REQUIRED column chunk.

    A data page holds at most 20,000 rows (or ``page_size`` encoded bytes)
    and is filled in batches of 1,024 rows.  After each batch the
    dictionary's PLAIN size is checked against ``dict_limit``: once it is
    over, the page in progress is flushed and the rest of the chunk is
    written PLAIN.  A dictionary page is flushed at the bit width of the
    dictionary size at that moment (at least 1), so widths grow page to
    page.  Returns (firsts, ids, dict_len, [(lo, hi, width)] dictionary
    pages, [(lo, hi)] PLAIN pages)."""
    from tpu_parquet_torch.column import ByteArrayData

    page_size = PYARROW_PAGE_SIZE if page_size is None else page_size
    n = len(values)
    firsts, ids = _first_seen_dictionary(values)
    if isinstance(values, ByteArrayData):
        lens = np.diff(np.asarray(values.offsets))
        entry = 4 + lens[firsts]
        value_bytes = np.concatenate([[0], np.cumsum(4 + lens)])
    else:
        row = np.asarray(values).nbytes // max(n, 1)
        entry = np.full(len(firsts), row, dtype=np.int64)
        value_bytes = np.arange(n + 1, dtype=np.int64) * row
    dict_bytes = np.concatenate([[0], np.cumsum(entry)])

    def dict_size(k):  # distinct values among the first k
        return int(np.searchsorted(firsts, k, side="left"))

    def width(k):
        return max(1, int(np.ceil(np.log2(max(dict_size(k), 1)))))

    dict_pages, plain_pages = [], []
    lo, fallen = 0, False
    while lo < n:
        hi = lo
        while hi < n:
            hi = min(hi + PYARROW_BATCH, lo + PYARROW_PAGE_ROWS, n)
            if not fallen and dict_bytes[dict_size(hi)] > dict_limit:
                fallen = "now"
                break
            size = ((hi - lo) * width(hi) // 8 if not fallen
                    else value_bytes[hi] - value_bytes[lo])
            if hi - lo >= PYARROW_PAGE_ROWS or size >= page_size:
                break
        if fallen == "now" or not fallen:
            dict_pages.append((lo, hi, width(hi)))
            if fallen:
                fallen, dict_end = True, hi
        else:
            plain_pages.append((lo, hi))
        lo = hi
    dict_len = dict_size(dict_end if fallen else n)
    return firsts, ids, dict_len, dict_pages, plain_pages


def _fallback_encoder_class():
    """A ``ChunkEncoder`` that lays a REQUIRED chunk out as pyarrow does
    (:func:`fallback_layout`), on the program's own encoders: ``plain`` for
    the dictionary page and the PLAIN suffix, ``rle`` for the index pages,
    the encoder's page writer (compression, headers, CRCs).  Per-column
    dictionary limits in ``limits`` (dotted name -> bytes)."""
    from tpu_parquet_torch.chunk_encode import (ChunkEncoder,
                                                ChunkWriteResult, _crc_i32)
    from tpu_parquet_torch.column import ByteArrayData
    from tpu_parquet_torch.format import (ColumnChunk, ColumnMetaData,
                                          DictionaryPageHeader, Encoding,
                                          PageHeader, PageType)
    from tpu_parquet_torch.kernels import plain, rle
    from tpu_parquet_torch.thrift import serialize

    class FallbackEncoder(ChunkEncoder):
        limits: dict = {}

        def write(self, cd, sink, offset):
            leaf = self.leaf
            if cd.max_def or cd.max_rep:
                raise RuntimeError("the pyarrow-layout writer takes "
                                   "REQUIRED flat columns")
            self.write_statistics = False
            values = cd.values
            name = ".".join(leaf.path)
            firsts, ids, dict_len, dpages, ppages = fallback_layout(
                values, self.limits.get(name, PYARROW_DICT_LIMIT))
            ptype = leaf.physical_type
            dict_vals = (values.take(firsts[:dict_len])
                         if isinstance(values, ByteArrayData)
                         else values[firsts[:dict_len]])
            raw = plain.encode(dict_vals, ptype, leaf.type_length)
            comp = self._compress(raw)
            ph = PageHeader(
                type=int(PageType.DICTIONARY_PAGE),
                uncompressed_page_size=len(raw),
                compressed_page_size=len(comp),
                dictionary_page_header=DictionaryPageHeader(
                    num_values=dict_len, encoding=int(Encoding.PLAIN)))
            if self.write_crc:
                ph.crc = _crc_i32(comp)
            hdr = serialize(ph)
            parts = [hdr, comp]
            pos = len(hdr) + len(comp)
            total_unc = len(hdr) + len(raw)
            data_off = None
            pages = ([(lo, hi, Encoding.RLE_DICTIONARY,
                       bytes([w]) + rle.encode(ids[lo:hi].astype(np.uint64),
                                               w))
                      for lo, hi, w in dpages]
                     + [(lo, hi, Encoding.PLAIN, None) for lo, hi in ppages])
            for lo, hi, enc, payload in pages:
                if payload is None:
                    sl = (ByteArrayData(
                        offsets=values.offsets[lo : hi + 1]
                        - values.offsets[lo],
                        heap=values.heap[values.offsets[lo]:
                                         values.offsets[hi]])
                          if isinstance(values, ByteArrayData)
                          else values[lo:hi])
                    payload = plain.encode(sl, ptype, leaf.type_length)
                page_parts, hdr_len, raw_len, _ = self._write_data_page(
                    cd, lo, hi, lo, hi, payload, enc)
                if data_off is None:
                    data_off = offset + pos
                parts.extend(page_parts)
                pos += sum(len(p) for p in page_parts)
                total_unc += raw_len + hdr_len
            for part in parts:
                sink.write(part)
            encodings = {Encoding.PLAIN, Encoding.RLE}
            if dpages:
                encodings.add(Encoding.RLE_DICTIONARY)
            md = ColumnMetaData(
                type=int(ptype), encodings=sorted(int(e) for e in encodings),
                path_in_schema=list(leaf.path), codec=int(self.codec),
                num_values=cd.num_leaf_slots,
                total_uncompressed_size=total_unc,
                total_compressed_size=pos, data_page_offset=data_off,
                dictionary_page_offset=offset)
            return ChunkWriteResult(
                chunk=ColumnChunk(file_offset=offset, meta_data=md),
                total_compressed=pos, total_uncompressed=total_unc)

    return FallbackEncoder


def write_file(config: dict, groups, path: str) -> None:
    """The configuration's table (``tables/<table>.py``) written by its
    layout's writer (``writers/<layout>.py``)."""
    from . import tables, writers

    writers.load(config["layout"]).write(
        path, tables.load(config["table"]), groups, config)


def file_layout(path: str) -> dict:
    """What the file holds: each row group's rows, and per column the
    sorted encoding names of its chunk in each row group, and each chunk's
    uncompressed bytes, the pages as the host ships them once it has
    decompressed them (from the file's footer)."""
    from tpu_parquet_torch.footer import read_file_metadata
    from tpu_parquet_torch.format import Encoding

    with open(path, "rb") as f:
        meta = read_file_metadata(f)
    encodings: dict = {}
    uncompressed: dict = {}
    for rg in meta.row_groups:
        for chunk in rg.columns:
            md = chunk.meta_data
            name = ".".join(md.path_in_schema)
            encodings.setdefault(name, []).append(
                sorted(Encoding(e).name for e in md.encodings))
            uncompressed.setdefault(name, []).append(
                int(md.total_uncompressed_size))
    return {"row_group_rows": [int(rg.num_rows) for rg in meta.row_groups],
            "chunk_encodings": encodings,
            "chunk_bytes_uncompressed": uncompressed}


def layout_differences(pinned: dict, got: dict) -> list:
    """Where the file's layout departs from the pinned one (empty: none)."""
    out = []
    if pinned["row_group_rows"] != got["row_group_rows"]:
        out.append(f"row groups {got['row_group_rows']}, pinned "
                   f"{pinned['row_group_rows']}")
    for c, want in pinned["chunk_encodings"].items():
        have = got["chunk_encodings"].get(c)
        if have != want:
            out.append(f"{c}: chunk encodings {have}, pinned {want}")
    extra = set(got["chunk_encodings"]) - set(pinned["chunk_encodings"])
    if extra:
        out.append(f"columns not pinned: {sorted(extra)}")
    return out
