"""``decode_roofline_share`` in ``orders_nested_scan``, whose rate is
watched per layer (``rows_per_s.nested``): the same reading, whose bytes
written hold one byte a slot for each level stream of a leaf."""

from pqbench.harness import reader_of

read = reader_of("decode_roofline_share")
