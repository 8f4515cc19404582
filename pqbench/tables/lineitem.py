"""TPC-H LINEITEM, 16 flat REQUIRED columns: :mod:`pqbench.lineitem`'s
frozen draw, sized by the configuration's ``rows`` and
``rows_per_group``."""

from __future__ import annotations

from .. import lineitem

LEAVES = lineitem.COLUMNS
DELTA_COLUMNS = lineitem.DELTA_COLUMNS


def draw(seed: int, config: dict) -> list:
    return lineitem.draw(seed, int(config["rows"]),
                         int(config["rows_per_group"]))


def schema():
    """LINEITEM's 16 columns REQUIRED, the STRING columns UTF8."""
    from tpu_parquet_torch.format import (ConvertedType,
                                          FieldRepetitionType as FRT,
                                          LogicalType, StringType, Type)
    from tpu_parquet_torch.schema.core import (ColumnParameters,
                                               build_schema, data_column)

    def column(c):
        ptype = getattr(Type, lineitem.PHYSICAL[c])
        if c in lineitem.STRING_COLUMNS:
            return data_column(c, ptype, FRT.REQUIRED,
                               ColumnParameters(
                                   logical_type=LogicalType(
                                       STRING=StringType()),
                                   converted_type=ConvertedType.UTF8))
        return data_column(c, ptype, FRT.REQUIRED)

    return build_schema([column(c) for c in LEAVES])
