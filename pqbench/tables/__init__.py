"""One module per table, named by a configuration's ``table`` key.

A table module gives, NumPy only and importing nothing of the program:

- ``draw(seed, config)``: the per-row-group dicts, from ``--seed`` and the
  configuration's sizes, each from a leaf's dotted path (as the file's
  footer names it) to its values in :mod:`pqbench.reference`'s form;
- ``LEAVES``: the leaves a full scan reads, in order;
- ``DELTA_COLUMNS``: the leaves a layout may encode DELTA_BINARY_PACKED
  where the writer declines a dictionary;

and ``schema()``, the file's schema in the program's terms (the one
function that imports the program, for the writer).  The reference digests
and counts any table's leaves from the drawn form, so a table is added by
adding its file.
"""

import importlib


def load(name: str):
    """The table module ``pqbench/tables/<name>.py``."""
    return importlib.import_module(f"{__name__}.{name}")
