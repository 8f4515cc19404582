"""The orders the window completed over its seconds, counted as
``rows_per_s`` counts rows (a nested ORDERS row is one order and its
lineitems), in ``orders_nested_scan``, whose host-bound rate is watched
here, per layer, as ``rows_per_s.pyarrow`` is: the same reading."""

from pqbench.harness import reader_of

read = reader_of("rows_per_s.pyarrow")
