"""Versioned, validated checkpoint state for :class:`~tpu_parquet_torch.data.DataLoader`.

The whole point of a deterministic input pipeline is that its position is
SMALL: because the shuffled order is a pure function of (seed, epoch, cursor)
— see data/sampler.py — the checkpoint carries only those scalars plus a
dataset fingerprint, never buffered rows or RNG internals.  Save → restore →
iterate is bit-identical to uninterrupted iteration at any batch boundary,
for any prefetch depth.

Blob layout: ``b"TPQL" | version:u16be | json(state)``.  Every decode error,
type/range violation, unknown version, or fingerprint mismatch raises
:class:`tpu_parquet_torch.errors.CheckpointError` — a checkpoint that cannot be
adopted exactly must fail loudly, never silently mis-seek.

The port's copy of ``tpu_parquet.data.checkpoint``: the same ``MAGIC``,
``STATE_VERSION``, fields and fingerprint, so each package restores the
other's blob.
"""

from __future__ import annotations

import json

from ..errors import CheckpointError

__all__ = ["STATE_VERSION", "MAGIC", "pack_state", "unpack_state",
           "validate_state", "check_compatible"]

STATE_VERSION = 1
MAGIC = b"TPQL"

# (key, lo, hi) for every required integer field; bounds are sanity rails so
# a mutated blob cannot smuggle astronomically large ints into index math
_INT_FIELDS = (
    # exact-version check lives HERE so dict states (restore(dict)) are held
    # to it too, not only packed blobs
    ("version", STATE_VERSION, STATE_VERSION + 1),
    ("seed", 0, 1 << 64),
    ("epoch", 0, 1 << 62),
    ("rows_taken", 0, 1 << 62),
    ("batch_size", 1, 1 << 40),
    ("shuffle_window", 1, 1 << 40),
    ("n_units", 1, 1 << 40),
    ("total_rows", 0, 1 << 62),
    ("shard_rows", 0, 1 << 62),
)
_BOOL_FIELDS = ("shuffle", "drop_remainder")

# the config half of the state: must match the restoring loader exactly (the
# cursor half — seed/epoch/rows_taken — is what restore ADOPTS).
# dataset_digest hashes the ordered per-unit (rows, bytes, offset) sequence,
# so a reordered or substituted file set with coincidentally matching counts
# still refuses.
_FINGERPRINT = ("batch_size", "shuffle", "shuffle_window", "drop_remainder",
                "shard", "n_units", "total_rows", "shard_rows",
                "dataset_digest")


def _int_field(state: dict, key: str, lo: int, hi: int) -> int:
    v = state.get(key)
    if type(v) is not int:  # bool is an int subclass: excluded on purpose
        raise CheckpointError(
            f"loader state field {key!r} must be an int, got {type(v).__name__}"
        )
    if not lo <= v < hi:
        raise CheckpointError(
            f"loader state field {key!r} = {v} outside [{lo}, {hi})"
        )
    return v


def validate_state(state) -> dict:
    """Strict structural validation; returns ``state`` or raises."""
    if not isinstance(state, dict):
        raise CheckpointError(
            f"loader state must be a dict, got {type(state).__name__}"
        )
    for key, lo, hi in _INT_FIELDS:
        _int_field(state, key, lo, hi)
    for key in _BOOL_FIELDS:
        if type(state.get(key)) is not bool:
            raise CheckpointError(f"loader state field {key!r} must be a bool")
    shard = state.get("shard")
    if (not isinstance(shard, (list, tuple)) or len(shard) != 2
            or any(type(x) is not int for x in shard)):
        raise CheckpointError("loader state field 'shard' must be [index, n]")
    i, n = shard
    if not (1 <= n < 1 << 32 and 0 <= i < n):
        raise CheckpointError(f"loader state shard {i} of {n} out of range")
    if state["rows_taken"] > state["shard_rows"]:
        raise CheckpointError(
            f"loader state cursor {state['rows_taken']} past the shard's "
            f"{state['shard_rows']} rows"
        )
    # quarantine skips (optional — older blobs carry
    # none): a sorted duplicate-free unit list, its row total, and the
    # skip_file-marked file ordinals.  Structural rails only; the
    # restoring loader cross-checks membership and the row sum.
    skipped = state.get("skipped_units", [])
    if not isinstance(skipped, list) or any(
            type(u) is not int or not 0 <= u < state["n_units"]
            for u in skipped):
        raise CheckpointError(
            "loader state field 'skipped_units' must be a list of unit "
            "ordinals in [0, n_units)")
    if sorted(set(skipped)) != skipped:
        raise CheckpointError(
            "loader state field 'skipped_units' must be sorted and "
            "duplicate-free")
    sr = state.get("skipped_rows", 0)
    if type(sr) is not int or not 0 <= sr <= state["shard_rows"]:
        raise CheckpointError(
            "loader state field 'skipped_rows' out of [0, shard_rows]")
    sf = state.get("skipped_files", [])
    if not isinstance(sf, list) or any(
            type(f) is not int or not 0 <= f < 1 << 32 for f in sf):
        raise CheckpointError(
            "loader state field 'skipped_files' must be a list of file "
            "ordinals")
    if sorted(set(sf)) != sf:
        raise CheckpointError(
            "loader state field 'skipped_files' must be sorted and "
            "duplicate-free")
    # state() only ever emits batch boundaries (k * batch_size) or the
    # epoch-tail cursor (the shard's rows MINUS the quarantined units');
    # anything else is a tampered blob whose adoption would shift every
    # subsequent batch by a fraction of a batch
    rt = state["rows_taken"]
    if (rt % state["batch_size"] != 0
            and rt != state["shard_rows"] - sr):
        raise CheckpointError(
            f"loader state cursor {rt} is not a batch boundary "
            f"(batch_size {state['batch_size']})"
        )
    if state["shard_rows"] > state["total_rows"]:
        raise CheckpointError("loader state shard_rows exceeds total_rows")
    dg = state.get("dataset_digest")
    if type(dg) is not str or not (8 <= len(dg) <= 64):
        raise CheckpointError(
            "loader state field 'dataset_digest' must be a short hex string"
        )
    return state


def pack_state(state: dict) -> bytes:
    """Serialize a validated state dict to the versioned blob."""
    validate_state(state)
    payload = json.dumps(state, sort_keys=True,
                         separators=(",", ":")).encode("utf-8")
    return MAGIC + int(state["version"]).to_bytes(2, "big") + payload


def unpack_state(blob) -> dict:
    """Parse + validate a state blob; raises CheckpointError on anything off."""
    if isinstance(blob, dict):  # already-unpacked states pass through validated
        return validate_state(blob)
    if not isinstance(blob, (bytes, bytearray, memoryview)):
        raise CheckpointError(
            f"loader state blob must be bytes, got {type(blob).__name__}"
        )
    blob = bytes(blob)
    if len(blob) < len(MAGIC) + 2 or blob[: len(MAGIC)] != MAGIC:
        raise CheckpointError("not a loader state blob (bad magic)")
    version = int.from_bytes(blob[len(MAGIC) : len(MAGIC) + 2], "big")
    if version != STATE_VERSION:
        raise CheckpointError(
            f"unsupported loader state version {version} "
            f"(this build reads {STATE_VERSION})"
        )
    try:
        state = json.loads(blob[len(MAGIC) + 2 :].decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise CheckpointError(f"corrupt loader state payload: {e}") from e
    state = validate_state(state)
    if state["version"] != version:
        raise CheckpointError("loader state version header/payload mismatch")
    return state


def check_compatible(state: dict, expected: dict) -> None:
    """Refuse a state whose config fingerprint differs from the loader's.

    ``expected`` maps the _FINGERPRINT keys to the restoring loader's values;
    any mismatch means the state describes a DIFFERENT pipeline (other
    dataset, other sharding, other batch geometry) and adopting its cursor
    would silently yield wrong rows.
    """
    for key in _FINGERPRINT:
        got, want = state.get(key), expected[key]
        if key == "shard":
            got, want = list(got), list(want)
        if got != want:
            raise CheckpointError(
                f"loader state mismatch on {key!r}: state has {got!r}, "
                f"this loader has {want!r}"
            )
