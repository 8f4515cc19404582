"""A closed loop of full scans: one caller reading the file again and again
with ``DeviceFileReader(path, prefetch=...).iter_row_groups()``.

Each row group's leaves are digested on the device as they arrive (the
digest is this caller's only work), the digest copied to pinned host
memory, and the row group dropped.  Without a ``columns`` list the traffic
reads every leaf of the configuration's table.  The pass the window's end
cuts off counts only for the row groups it yielded.
"""

from __future__ import annotations

import time

import numpy as np

from .. import digest, reference, tables, timing


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.columns = ctx.traffic.get("columns") or list(
            tables.load(ctx.config["table"]).LEAVES)
        self.prefetch = int(ctx.traffic["prefetch"])
        self.group_rows = ctx.layout["row_group_rows"]
        self.digests = digest.HostStore((len(self.columns), 5), ctx.device)
        self.levels = digest.HostStore(
            (len(self.columns), reference.LEVEL_WIDTH), ctx.device)
        self.group_ids: list = []
        self.passes: list = []
        self.rows = 0
        self._open = None
        # per row group and column, the bytes the decode writes in the form
        # the program returns it (read in the warm-up pass)
        self.written: dict = {}

    def _pass(self, deadline, keep: bool) -> bool:
        """One pass; False when the deadline cut it (left open)."""
        from tpu_parquet_torch import device_reader

        ctx, spans = self.ctx, self.ctx.spans
        plain = None if keep else reference.decoded_bytes(ctx.groups)
        t0 = time.perf_counter()
        with spans.span("open"):
            r = device_reader.DeviceFileReader(
                ctx.path, columns=self.columns, device=ctx.device,
                prefetch=self.prefetch)
            it = r.iter_row_groups()
        gi = 0
        while True:
            with spans.span("wait_group"):
                out = next(it, None)
            if out is None:
                break
            if plain is not None:
                self.written[gi] = {c: digest.output_bytes(out[c],
                                                           plain[gi][c])
                                    for c in self.columns}
            with spans.span("digest"), ctx.memory.own():
                ctx.on_side(lambda: self._fold(out, keep),
                            [t for c in out.values()
                             for t in digest.tensors_of(c)])
                del out
            if keep:
                self.group_ids.append(gi)
                self.rows += self.group_rows[gi]
            gi += 1
            if deadline is not None and time.perf_counter() >= deadline:
                self._open = (r, it)
                return False
        with spans.span("close"):
            it.close()
            st = r.stats()
            r.close()
        if keep:
            self.passes.append({
                "seconds": time.perf_counter() - t0, "rows": st.rows,
                "host_seconds": st.host_seconds,
                "stage_seconds": st.stage_seconds,
                "dispatch_seconds": st.dispatch_seconds})
        return True

    def _fold(self, out: dict, keep: bool) -> None:
        d = digest.group_digest(out, self.columns, self.ctx.pos)
        lv = digest.level_digests(out, self.columns, self.ctx.pos)
        if keep:
            self.digests.put(d)
            self.levels.put(lv)

    def warm(self) -> None:
        self._pass(None, keep=False)

    def window(self, deadline: float) -> None:
        while time.perf_counter() < deadline and self._pass(deadline, True):
            pass

    def close(self) -> None:
        if self._open is not None:
            r, it = self._open
            it.close()
            r.close()
            self._open = None

    def end_to_end(self, seconds: float) -> dict:
        return {"rows_per_s": timing.rate(self.rows, seconds)}

    def layer(self) -> dict:
        sums = {k: sum(p[k] for p in self.passes)
                for k in ("rows", "host_seconds", "stage_seconds",
                          "dispatch_seconds")}
        shipped = self.ctx.layout["chunk_bytes_uncompressed"]
        read = sum(shipped[c][g] for g in self.group_ids
                   for c in self.columns)
        written = sum(self.written[g][c] for g in self.group_ids
                      for c in self.columns)
        return {"window_rows": self.rows,
                "reader": sums if self.passes else None,
                "decode_bytes": {"read": read, "written": written},
                "pass_s": [round(p["seconds"], 4) for p in self.passes]}

    def labelled_spans(self) -> list:
        return list(self.ctx.spans.items)

    def verify(self) -> tuple:
        ref = reference.group_digests(self.ctx.groups, self.columns)
        got = np.concatenate([self.digests.array(), self.levels.array()],
                             axis=2)
        want = ref[self.group_ids] if self.group_ids else got
        bad = int(np.any(got != want, axis=2).sum())
        checks = [("digest_mismatches", bad, "<=", 0),
                  ("row_groups_compared", len(got), ">=", 1)]
        return checks, len(got), 0
