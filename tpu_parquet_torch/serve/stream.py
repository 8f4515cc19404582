"""StreamingScan: long-lived incremental batch sessions over the serve tier.

The counterpart of ``tpu_parquet.serve.stream``.  A one-shot
``ScanService`` request materializes its whole response before the caller
sees a row, the wrong shape for a training job that wants a steady stream
of fixed-shape batches from a multi-gigabyte file set.  A
``ScanRequest(stream=True, batch_rows=N)`` instead returns a
:class:`StreamingScan` session: the worker decodes row groups one at a
time and pushes **fixed-shape padded and masked batches** (the
``data.DataLoader`` batch and mask contract, through its
:func:`~tpu_parquet_torch.data.loader.pad_and_mask`) through a bounded
buffer the consumer iterates.

Contracts the session inherits rather than reinvents:

- **Memory**: every buffered batch's bytes are charged to the tenant's
  :class:`~tpu_parquet_torch.alloc.InFlightBudget` slice and the
  service's global budget BEFORE it is buffered, and released when the
  consumer takes it: a slow consumer backpressures its own producer (and
  only its own tenant's slice), never the fleet.  The buffer depth is
  bounded by ``TPQ_STREAM_BUFFER_BATCHES``.
- **Cancellation, deadlines, breakers**, at *batch* granularity: the
  request's :class:`~tpu_parquet_torch.resilience.CancelToken` is checked
  at every group and batch boundary, classified failures note the file's
  circuit breaker as the one-shot path does, and a blocked ``next()``
  caller receives the typed terminal verdict promptly.
- **Warm path**: each row group is first probed in the decoded
  ``ResultCache``; a fully cached group streams straight from the cached
  host ``ColumnData``, with no ``ByteStore`` read and no device dispatch
  for that batch (the reader is not even opened until the first cold
  group).  ``device=True`` sessions decode on the host and ship each batch
  to the service's device (``ScanService(device=)``, ``cuda`` unless the
  caller names another) with the loader's
  :func:`~tpu_parquet_torch.data.loader.ship_to_device`: one copy per
  column, torch tensors on the device.
- **Resumability**: :meth:`StreamingScan.cursor` snapshots the consumer's
  position as a versioned ``b"TPQS"`` blob, byte for byte the reference's
  (so each package resumes the other's cursor), under the discipline of
  the ``TPQL`` loader checkpoint (strict validation, version echo,
  fingerprint refusal via :func:`check_cursor_compatible`): save, resume
  (``ScanRequest(cursor=blob)``), iterate is bit-identical to the
  uninterrupted stream, because batches never span files and the cursor
  only lands on batch boundaries.
"""

from __future__ import annotations

import hashlib
import json
import queue
import threading
import time

import numpy as np

from ..errors import CheckpointError, ParquetError
from ..obs import env_int

__all__ = ["CURSOR_MAGIC", "CURSOR_VERSION", "StreamingScan",
           "check_cursor_compatible", "pack_cursor", "request_digest",
           "unpack_cursor", "validate_cursor"]

CURSOR_VERSION = 1
CURSOR_MAGIC = b"TPQS"

# consumer-side poll tick while blocked on an empty buffer: bounds how long
# a terminal verdict (cancel/deadline/close) can go unnoticed by a blocked
# next() caller
_POLL_S = 0.05

# (key, lo, hi) rails, same scheme as data/checkpoint.py: a mutated blob
# cannot smuggle astronomically large ints into the resume arithmetic
_INT_FIELDS = (
    ("version", CURSOR_VERSION, CURSOR_VERSION + 1),
    ("batch_rows", 1, 1 << 40),
    ("n_paths", 1, 1 << 32),
    ("path_index", 0, 1 << 32),
    ("rows_done", 0, 1 << 62),
    ("batches_emitted", 0, 1 << 62),
)
_BOOL_FIELDS = ("device",)

# the config half of the cursor: must match the resuming request exactly
# (the cursor half — path_index/rows_done — is what resume ADOPTS).
# request_digest hashes the ordered paths + projection + filter text, so a
# cursor saved against one request shape refuses any other.
_FINGERPRINT = ("batch_rows", "device", "n_paths", "request_digest")


def request_digest(request) -> str:
    """Stable fingerprint of a streaming request's *shape* (ordered paths,
    projection, filter, device, batch geometry) — the refusal rail that
    keeps a saved cursor from seeking a different stream.  File CONTENT is
    deliberately not hashed: generation invalidation is the PlanCache's
    job; the cursor pins what the caller asked for."""
    flt = request.filter
    if flt is not None and not isinstance(flt, str):
        from ..scanplan import predicate_fingerprint

        flt = predicate_fingerprint(flt) or "opaque-predicate"
    cols = (None if request.columns is None
            else [str(c) for c in request.columns])
    canon = json.dumps({
        "paths": [str(p) for p in request.paths],
        "columns": cols,
        "filter": flt,
        "device": bool(request.device),
        "batch_rows": int(request.batch_rows),
    }, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(canon.encode("utf-8")).hexdigest()[:16]


def _int_field(state: dict, key: str, lo: int, hi: int) -> int:
    v = state.get(key)
    if type(v) is not int:  # bool is an int subclass: excluded on purpose
        raise CheckpointError(
            f"stream cursor field {key!r} must be an int, "
            f"got {type(v).__name__}")
    if not lo <= v < hi:
        raise CheckpointError(
            f"stream cursor field {key!r} = {v} outside [{lo}, {hi})")
    return v


def validate_cursor(state) -> dict:
    """Strict structural validation; returns ``state`` or raises
    :class:`~tpu_parquet_torch.errors.CheckpointError`."""
    if not isinstance(state, dict):
        raise CheckpointError(
            f"stream cursor must be a dict, got {type(state).__name__}")
    for key, lo, hi in _INT_FIELDS:
        _int_field(state, key, lo, hi)
    for key in _BOOL_FIELDS:
        if type(state.get(key)) is not bool:
            raise CheckpointError(
                f"stream cursor field {key!r} must be a bool")
    if state["path_index"] > state["n_paths"]:
        raise CheckpointError(
            f"stream cursor path_index {state['path_index']} past its "
            f"{state['n_paths']} paths")
    # the consumer only ever lands on batch boundaries (a padded tail
    # advances path_index and zeroes rows_done): anything else is a
    # tampered blob whose adoption would shift every subsequent batch
    if state["rows_done"] % state["batch_rows"] != 0:
        raise CheckpointError(
            f"stream cursor rows_done {state['rows_done']} is not a batch "
            f"boundary (batch_rows {state['batch_rows']})")
    dg = state.get("request_digest")
    if type(dg) is not str or not (8 <= len(dg) <= 64):
        raise CheckpointError(
            "stream cursor field 'request_digest' must be a short hex "
            "string")
    return state


def pack_cursor(state: dict) -> bytes:
    """Serialize a validated cursor dict to the versioned blob
    (``b"TPQS" | version:u16be | json``)."""
    validate_cursor(state)
    payload = json.dumps(state, sort_keys=True,
                         separators=(",", ":")).encode("utf-8")
    return CURSOR_MAGIC + int(state["version"]).to_bytes(2, "big") + payload


def unpack_cursor(blob) -> dict:
    """Parse + validate a cursor blob; raises CheckpointError on anything
    off (truncation, bad magic, unknown version, type/range violations,
    header/payload version disagreement)."""
    if isinstance(blob, dict):  # already-unpacked cursors pass validated
        return validate_cursor(blob)
    if not isinstance(blob, (bytes, bytearray, memoryview)):
        raise CheckpointError(
            f"stream cursor blob must be bytes, got {type(blob).__name__}")
    blob = bytes(blob)
    if len(blob) < len(CURSOR_MAGIC) + 2 or \
            blob[: len(CURSOR_MAGIC)] != CURSOR_MAGIC:
        raise CheckpointError("not a stream cursor blob (bad magic)")
    version = int.from_bytes(
        blob[len(CURSOR_MAGIC): len(CURSOR_MAGIC) + 2], "big")
    if version != CURSOR_VERSION:
        raise CheckpointError(
            f"unsupported stream cursor version {version} "
            f"(this build reads {CURSOR_VERSION})")
    try:
        state = json.loads(blob[len(CURSOR_MAGIC) + 2:].decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise CheckpointError(f"corrupt stream cursor payload: {e}") from e
    state = validate_cursor(state)
    if state["version"] != version:
        raise CheckpointError("stream cursor version header/payload mismatch")
    return state


def check_cursor_compatible(state: dict, expected: dict) -> None:
    """Refuse a cursor whose config fingerprint differs from the resuming
    request's — a mismatch means it describes a DIFFERENT stream and
    adopting its position would silently yield wrong rows."""
    for key in _FINGERPRINT:
        got, want = state.get(key), expected[key]
        if got != want:
            raise CheckpointError(
                f"stream cursor mismatch on {key!r}: cursor has {got!r}, "
                f"this request has {want!r}")


def _column_rows(cd, column: str) -> np.ndarray:
    """One decoded column chunk as a per-row array the batcher can slice:
    fixed-width columns pass through as their numpy values; BYTE_ARRAY
    columns become object arrays of ``bytes``.  Nested or nullable
    columns are not streamable (the DataLoader carries the same
    constraint) — refusing here keeps padded shapes honest."""
    from ..column import ByteArrayData

    if getattr(cd, "rep_levels", None) is not None:
        raise ParquetError(
            f"streaming scan: column {column!r} is nested (rep levels "
            f"present) — not batchable to a fixed shape")
    values = cd.values
    if values is None:
        raise ParquetError(f"streaming scan: column {column!r} decoded no "
                           f"values")
    if isinstance(values, ByteArrayData):
        arr = np.array(values.to_list(), dtype=object)
    else:
        arr = np.asarray(values)
    dl = getattr(cd, "def_levels", None)
    if dl is not None and len(arr) != len(dl):
        raise ParquetError(
            f"streaming scan: column {column!r} has nulls — not batchable "
            f"to a fixed shape")
    return arr


def _batch_nbytes(batch: dict) -> int:
    """Accounting size of one assembled batch, numpy arrays or shipped
    tensors alike (``nbytes`` of both; object arrays of byte strings count
    their payload, not just the pointer array)."""
    n = 0
    for a in batch.values():
        nb = int(getattr(a, "nbytes", 0) or 0)
        if getattr(a, "dtype", None) == object:
            nb += sum(len(v) for v in a if isinstance(v, (bytes, str)))
        n += nb
    return max(n, 1)


class StreamingScan:
    """One live streaming session: iterate it for batches, ``cursor()``
    to snapshot the position, ``close()``/``cancel()`` to stop early
    (context manager supported).

    The producer half runs on the service worker that picked the request
    up (a streaming session OCCUPIES its worker slot for its lifetime —
    size ``TPQ_SERVE_CONCURRENCY`` for the number of concurrent streams);
    the consumer half is whoever iterates.  All cross-thread state flows
    through the bounded buffer plus a terminal-verdict latch."""

    def __init__(self, service, request, ticket, tenant,
                 resume_state: "dict | None" = None):
        self._service = service
        self.request = request
        self.ticket = ticket
        self.token = ticket.token
        self._tenant = tenant
        self.batch_rows = int(request.batch_rows)
        if self.batch_rows < 1:
            raise ParquetError(
                f"streaming scan: batch_rows must be >= 1, "
                f"got {request.batch_rows}")
        depth = env_int("TPQ_STREAM_BUFFER_BATCHES", 2, lo=1)
        self._buf: "queue.Queue" = queue.Queue(maxsize=depth)
        self._lock = threading.Lock()
        self._terminal: "BaseException | None" = None
        self._exhausted = False
        self._digest = request_digest(request)
        # consumer-side cursor (what cursor() snapshots): advanced only
        # when a batch is actually DELIVERED — buffered-but-untaken work
        # is not part of the position
        self._cur_path = resume_state["path_index"] if resume_state else 0
        self._cur_rows = resume_state["rows_done"] if resume_state else 0
        self._batches_taken = (resume_state["batches_emitted"]
                               if resume_state else 0)
        self._resume = resume_state
        # the persistent producer generator (stream-aware fair scheduling:
        # a worker can park the session mid-file and a later leg — on any
        # worker — resumes exactly where the last batch left off)
        self._gen = None
        # structural warm/cold accounting (tests + serve stats)
        self.warm_batches = 0
        self.cold_groups = 0
        self.warm_groups = 0
        self.rows_emitted = 0
        self.slot_yields = 0
        # a cancel flips the terminal latch immediately — a blocked
        # next() caller sees the verdict on its next poll tick instead of
        # only at the producer's next boundary
        self.token.on_cancel(self._note_terminal)

    # -- consumer half ---------------------------------------------------------

    def __iter__(self) -> "StreamingScan":
        return self

    def __next__(self) -> dict:
        if self._exhausted:
            raise StopIteration
        while True:
            try:
                kind, payload, meta = self._buf.get(timeout=_POLL_S)
            except queue.Empty:
                with self._lock:
                    term = self._terminal
                if term is not None:
                    self._exhausted = True
                    raise term
                self.token.check()
                continue
            if kind == "end":
                with self._lock:
                    self._cur_path = len(self.request.paths)
                    self._cur_rows = 0
                self._exhausted = True
                raise StopIteration
            if kind == "error":
                self._exhausted = True
                raise payload
            self._service._release_stream(self._tenant, meta["charges"])
            with self._lock:
                if meta["file_done"]:
                    self._cur_path = meta["path_index"] + 1
                    self._cur_rows = 0
                else:
                    self._cur_path = meta["path_index"]
                    self._cur_rows = meta["rows_done"]
                self._batches_taken += 1
            if self._tenant is not None:
                with self._tenant.lock:
                    self._tenant.stream_batches += 1
            stats = self._service.stats
            with stats.lock:
                stats.stream_batches += 1
            return payload

    def cursor(self) -> bytes:
        """The resumable position blob: feed it back as
        ``ScanRequest(cursor=...)`` (same paths/columns/filter/device/
        batch_rows — :func:`check_cursor_compatible` refuses anything
        else) and iteration continues bit-identically from the next
        undelivered batch."""
        with self._lock:
            state = {
                "version": CURSOR_VERSION,
                "batch_rows": self.batch_rows,
                "n_paths": len(self.request.paths),
                "path_index": self._cur_path,
                "rows_done": self._cur_rows,
                "batches_emitted": self._batches_taken,
                "device": bool(self.request.device),
                "request_digest": self._digest,
            }
        return pack_cursor(state)

    def cancel(self) -> None:
        """Stop the stream (idempotent): the producer halts at its next
        boundary, buffered batches are discarded with their budget bytes
        released, and further ``next()`` raises the terminal
        :class:`~tpu_parquet_torch.errors.CancelledError`."""
        self.ticket.cancel()
        self._drain_release()

    def close(self) -> None:
        self.cancel()

    def __enter__(self) -> "StreamingScan":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- terminal delivery -----------------------------------------------------

    def _note_terminal(self, exc: BaseException) -> None:
        with self._lock:
            if self._terminal is None:
                self._terminal = exc

    def _fail(self, exc: BaseException) -> None:
        """Producer-side failure delivery: latch the verdict and try to
        queue it BEHIND already-buffered batches (the consumer drains good
        work first, then sees the typed error).  First verdict wins —
        a later failure of an already-terminal session is not re-queued."""
        with self._lock:
            already = self._terminal is not None
            if not already:
                self._terminal = exc
        if already:
            return
        try:
            self._buf.put_nowait(("error", exc, None))
        except queue.Full:
            pass  # the empty-buffer terminal check delivers it instead

    def _abort(self, exc: BaseException) -> None:
        """Service-shutdown path: cancel, latch, release every buffered
        batch's budget bytes.  A consumer blocked in ``next()`` raises
        ``exc`` within one poll tick."""
        self.token.cancel(exc)
        self._note_terminal(exc)
        self._close_gen()
        self._drain_release()

    def _close_gen(self) -> None:
        """Release a parked producer generator's resources (its open
        FileReader).  A generator mid-``next()`` on a worker cannot be
        closed from here — the cancelled token stops it at its next
        boundary instead."""
        gen = self._gen
        self._gen = None
        if gen is not None:
            try:
                gen.close()
            except (ValueError, RuntimeError):
                pass  # executing on a worker right now

    def _drain_release(self) -> None:
        while True:
            try:
                kind, _payload, meta = self._buf.get_nowait()
            except queue.Empty:
                return
            if kind == "batch":
                self._service._release_stream(self._tenant, meta["charges"])

    # -- producer half (runs on the service worker) ----------------------------

    def _push(self, item, token) -> None:
        """Blocking buffer put that stays cancellable: the producer parked
        behind a slow consumer still honors deadline/cancel promptly."""
        while True:
            token.check()
            try:
                self._buf.put(item, timeout=_POLL_S)
                return
            except queue.Full:
                continue

    def _emit(self, token, path_index: int, cols: dict, n: int,
              rows_done: int, file_done: bool) -> None:
        """Assemble one fixed-shape batch (pad+mask, optional device ship),
        charge its bytes, and buffer it."""
        from ..data.loader import pad_and_mask, ship_to_device

        trace = getattr(token, "trace", None)
        t0 = time.perf_counter() if trace is not None else 0.0
        batch = pad_and_mask(cols, n, self.batch_rows, mask_key="mask")
        if self.request.device:
            # torch.from_numpy raises TypeError on an object column, as
            # jnp.asarray does in the reference
            try:
                batch = ship_to_device(batch, self._service.device)
            except TypeError as e:
                raise ParquetError(
                    f"streaming scan: batch is not device-shippable "
                    f"(object-dtype column?): {e}") from e
        nbytes = _batch_nbytes(batch)
        charges = self._service._charge_stream(self._tenant, nbytes, token)
        meta = {"path_index": path_index, "rows_done": rows_done,
                "file_done": file_done, "charges": charges}
        try:
            self._push(("batch", batch, meta), token)
        except BaseException:
            self._service._release_stream(self._tenant, charges)
            raise
        self.rows_emitted += n
        if trace is not None:
            # closed after the fact: includes assembly + (device) ship +
            # the buffer wait behind a slow consumer
            trace.add_timed("batch", t0, time.perf_counter(), rows=n,
                            nbytes=nbytes, path_index=path_index,
                            file_done=file_done)

    def _produce(self, yield_check=None) -> bool:
        """Drive the producer: per file, per surviving row group, decode
        (or serve warm), slice into fixed-row batches, buffer.

        With ``yield_check`` set (stream-aware fair scheduling), the leg
        parks after any emitted batch for which ``yield_check()`` is true
        and returns ``False`` — the worker requeues the session and a
        later leg resumes the SAME generator (same reader, same pending
        remainder) exactly where it left off.  Returns ``True`` when the
        stream is fully produced.  Exceptions propagate to the worker
        (which counts them) after being delivered to the consumer via
        :meth:`_fail`."""
        try:
            gen = self._gen
            if gen is None:
                gen = self._gen = self._produce_gen()
            while True:
                try:
                    next(gen)
                except StopIteration:
                    self._gen = None
                    return True
                if yield_check is not None and yield_check():
                    self.slot_yields += 1
                    return False
        except BaseException as e:  # noqa: BLE001 — delivered to consumer
            self._gen = None
            self._fail(e)
            raise

    def _produce_gen(self):
        """The producer generator: yields once per emitted batch (the
        slot-yield boundaries)."""
        token = self.token
        req = self.request
        start = self._cur_path if self._resume is not None else 0
        skip = self._cur_rows if self._resume is not None else 0
        for pi in range(start, len(req.paths)):
            token.check()
            yield from self._stream_file(pi, req.paths[pi], skip)
            skip = 0
        self._push(("end", None, None), token)

    def _stream_file(self, path_index: int, path, skip_rows: int):
        """Stream one file (generator: yields after every emitted batch —
        the slot-yield boundaries): warm groups straight from the result
        cache, cold groups through a lazily-opened plan-replaying
        FileReader.  ``skip_rows`` (resume) skips whole groups by plan row
        counts — no IO, no decode — then slices into the first partial
        group."""
        from ..reader import FileReader
        from .cache import BoundDictCache
        from .service import _CLASSIFIED_FAILURES

        svc = self._service
        token = self.token
        req = self.request
        bs = self.batch_rows
        key = svc.cache.file_key(path)
        bkey = key if key is not None else ("path", str(path))
        svc.breakers.admit(bkey, str(path))
        reader = None
        try:
            meta, schema = svc.cache.footer(path)
            pred = svc._resolve_filter(req)
            plan = svc.cache.plan(key, req.columns, pred,
                                  meta=meta, schema=schema)
            vcrc = (req.validate_crc if req.validate_crc is not None
                    else svc._validate_crc)
            # host decode signature always: streaming decodes host-side
            # (device sessions ship per batch), so warm batches come from
            # the same entries a one-shot host scan populates
            rcache = svc.cache.bind_results(key, plan, row_filter=pred,
                                            device=False, validate_crc=vcrc,
                                            tenant=getattr(self._tenant,
                                                           "name", None))
            ordinals = plan.selected_ordinals()
            columns = self._ordered_columns(plan, ordinals)
            if "mask" in columns:
                raise ParquetError(
                    "streaming scan: a projected column is named 'mask' — "
                    "it would collide with the batch validity mask")
            nrows = {r.ordinal: int(r.num_rows) for r in plan.row_groups}
            pend: "dict[str, list]" = {c: [] for c in columns}
            pend_n = 0
            pend_cold = False
            consumed = 0   # surviving rows walked (skip arithmetic)
            emitted = skip_rows  # rows delivered so far within this file
            trace = getattr(token, "trace", None)
            for rg in ordinals:
                token.check()
                nr = nrows.get(rg, 0)
                if nr <= 0:
                    continue
                if consumed + nr <= skip_rows:
                    consumed += nr  # wholly before the cursor: no decode
                    continue
                t_g = time.perf_counter() if trace is not None else 0.0
                got = rcache.lookup_group(rg, columns) \
                    if rcache is not None else None
                if got is not None:
                    arrays = {c: _column_rows(got[c], c) for c in columns}
                    self.warm_groups += 1
                    cold = False
                else:
                    if reader is None:
                        reader = FileReader(
                            path, columns=req.columns, metadata=meta,
                            row_filter=pred, prefetch=req.prefetch,
                            validate_crc=vcrc, store=svc._store, plan=plan,
                            dict_cache=BoundDictCache(svc.cache, key),
                            result_cache=rcache, cancel=token)
                    group = reader.read_row_group(rg,
                                                  prefetch=req.prefetch)
                    arrays = {c: _column_rows(group[c], c) for c in columns}
                    self.cold_groups += 1
                    cold = True
                if trace is not None:
                    trace.add_timed("group", t_g, time.perf_counter(),
                                    rg=rg, rows=nr, warm=not cold,
                                    path=str(path))
                lens = {len(a) for a in arrays.values()}
                if len(lens) != 1 or lens != {nr}:
                    raise ParquetError(
                        f"streaming scan: row group {rg} column lengths "
                        f"{sorted(lens)} disagree with plan rows {nr}")
                lo = max(skip_rows - consumed, 0)
                consumed += nr
                if lo:
                    if lo >= nr:
                        continue
                    arrays = {c: a[lo:] for c, a in arrays.items()}
                take = nr - lo
                for c in columns:
                    pend[c].append(arrays[c])
                pend_n += take
                pend_cold = pend_cold or cold
                while pend_n >= bs:
                    cat = {c: (np.concatenate(pend[c])
                               if len(pend[c]) > 1 else pend[c][0])
                           for c in columns}
                    emitted += bs
                    pend_n -= bs
                    last_file_batch = (pend_n == 0
                                       and rg == ordinals[-1])
                    if not pend_cold:
                        self.warm_batches += 1
                    self._emit(token, path_index,
                               {c: a[:bs] for c, a in cat.items()}, bs,
                               emitted, last_file_batch)
                    pend = {c: ([cat[c][bs:]] if pend_n else [])
                            for c in columns}
                    # the carried remainder came from the group decoded
                    # LAST — its temperature is the remainder's
                    pend_cold = cold if pend_n else False
                    yield None  # slot-yield boundary (state is consistent)
            if pend_n:
                tail = {c: (np.concatenate(pend[c])
                            if len(pend[c]) > 1 else pend[c][0])
                        for c in columns}
                if not pend_cold:
                    self.warm_batches += 1
                self._emit(token, path_index, tail, pend_n, 0, True)
                yield None
        except _CLASSIFIED_FAILURES:
            self.breaker_note(bkey, path, ok=False)
            raise
        finally:
            if reader is not None:
                reader.close()
        self.breaker_note(bkey, path, ok=True)

    def breaker_note(self, bkey, path, ok: bool) -> None:
        self._service.breakers.note(bkey, str(path), ok=ok)

    @staticmethod
    def _ordered_columns(plan, ordinals) -> list:
        """Response column order = footer chunk order, exactly like the
        one-shot cache-hit path — a consumer must never see columns
        transposed by cache temperature or streaming mode."""
        columns = plan.columns
        rgp = next((r for r in plan.row_groups
                    if ordinals and r.ordinal == ordinals[0]), None)
        ordered = ([cp.column for cp in rgp.chunks] if rgp is not None
                   else list(columns))
        if set(ordered) != set(columns):
            ordered = list(columns)
        return ordered
