"""The port writer's layout (``bench.py`` ``gen_lineitem16``'s settings,
``chip_smoke.py``'s ``lineitem16_layout`` and phase 10a's
``write_orders``): SNAPPY, dictionary on, DELTA_BINARY_PACKED where the
writer declines a dictionary on the table's ``DELTA_COLUMNS``, page
CRCs."""

from __future__ import annotations

from ..write import columns


def write(path: str, table, groups, config: dict) -> None:
    from tpu_parquet_torch.format import CompressionCodec, Encoding
    from tpu_parquet_torch.writer import FileWriter

    with FileWriter(path, table.schema(), codec=CompressionCodec.SNAPPY,
                    use_dictionary=True, write_crc=True,
                    row_group_size=128 << 20,
                    column_encodings={c: Encoding.DELTA_BINARY_PACKED
                                      for c in table.DELTA_COLUMNS}) as w:
        for g in groups:
            w.write_columns(columns(g))
            w.flush_row_group()
