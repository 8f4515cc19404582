"""One module per file layout, named by a configuration's ``layout`` key.

A writer module's ``write(path, table, groups, config)`` writes the drawn
``groups``, one row group each, with the program's ``FileWriter`` under
``table.schema()``, and sets the layout alone: codec, dictionary, DELTA,
page limits and CRCs.
"""

import importlib


def load(name: str):
    """The writer module ``pqbench/writers/<name>.py``."""
    return importlib.import_module(f"{__name__}.{name}")
