"""``device_idle_share.scan`` in ``lineitem_loader``, whose rate is watched
per layer (``rows_per_s.loader``): the same reading."""

from pqbench.harness import reader_of

read = reader_of("device_idle_share.scan")
