"""``snappy_walk_wasted_share`` in ``orders_nested_scan``, whose rate is
watched per layer (``rows_per_s.nested``): the same reading."""

from pqbench.harness import reader_of

read = reader_of("snappy_walk_wasted_share")
