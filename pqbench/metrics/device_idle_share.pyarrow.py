"""``device_idle_share.scan`` in ``pyarrow_scan``, whose rate is watched
per layer (``rows_per_s.pyarrow``): the same reading."""

from pqbench.harness import reader_of

read = reader_of("device_idle_share.scan")
