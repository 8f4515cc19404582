"""``device_idle_share.scan`` in ``orders_nested_scan``, whose rate is watched
per layer (``rows_per_s.nested``): the same reading."""

from pqbench.harness import reader_of

read = reader_of("device_idle_share.scan")
