"""tpu_parquet_torch.data: the training-input subsystem.

The port's copy of ``tpu_parquet.data``.  Sits above
``reader``/``device_reader``/``pipeline``/``parallel`` and turns
"a directory of parquet files" into "shuffled, sharded, resumable,
fixed-shape batches for N epochs" — the layer every accelerator input stack
(tf.data, Grain) treats as its own subsystem:

- :mod:`~tpu_parquet_torch.data.sampler` — deterministic shuffle as a pure
  function of (seed, epoch, position): epoch-wise unit permutation plus a
  windowed block shuffle, no dataset materialization;
- :mod:`~tpu_parquet_torch.data.loader` — :class:`DataLoader` epoch iteration
  over host batches (numpy) or device batches (torch tensors),
  prefetch-overlapped decode, LPT per-host sharding, pad+mask ragged tails,
  :class:`LoaderStats` observability;
- :mod:`~tpu_parquet_torch.data.checkpoint` — the small versioned state blob
  behind ``loader.state()`` / ``loader.restore(state)``; save → restore →
  iterate is bit-identical to uninterrupted iteration.
"""

from .checkpoint import STATE_VERSION, pack_state, unpack_state
from .loader import DataLoader, LoaderStats
from .sampler import EpochPlan, block_permutation, epoch_unit_order, plan_epoch

__all__ = [
    "DataLoader",
    "LoaderStats",
    "STATE_VERSION",
    "pack_state",
    "unpack_state",
    "EpochPlan",
    "block_permutation",
    "epoch_unit_order",
    "plan_epoch",
]
