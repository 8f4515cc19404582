"""pyarrow's dictionary-on layout (Arrow C++ ``WriterProperties`` defaults;
``chip_smoke.py``'s ``write_pyarrow_layout``) on the program's encoders:
data pages of at most 20,000 rows or 1 MiB filled 1,024 rows at a time,
each dictionary page's index width the bit width of the dictionary's size
when the page is written, fallback to PLAIN pages once the dictionary
passes its limit (the configuration's ``dict_limits``, column -> bytes;
:data:`~pqbench.write.PYARROW_DICT_LIMIT` for the others), SNAPPY, page
CRCs.  REQUIRED flat leaves only: a leaf with levels is refused."""

from __future__ import annotations

from ..write import PYARROW_PAGE_SIZE, _fallback_encoder_class, columns


def write(path: str, table, groups, config: dict) -> None:
    from tpu_parquet_torch import writer as W
    from tpu_parquet_torch.format import CompressionCodec

    enc = _fallback_encoder_class()
    enc.limits = dict(config.get("dict_limits", {}))
    real = W.ChunkEncoder
    W.ChunkEncoder = enc
    try:
        with W.FileWriter(path, table.schema(),
                          codec=CompressionCodec.SNAPPY,
                          use_dictionary=True, write_crc=True,
                          row_group_size=128 << 20,
                          page_size=PYARROW_PAGE_SIZE) as w:
            for g in groups:
                w.write_columns(columns(g))
                w.flush_row_group()
    finally:
        W.ChunkEncoder = real
