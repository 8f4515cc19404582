"""``host_offcpu_share`` in ``pyarrow_scan``, whose rate is watched per
layer (``rows_per_s.pyarrow``): the same reading."""

from pqbench.harness import reader_of

read = reader_of("host_offcpu_share")
