"""A closed loop of shuffled training epochs through ``DataLoader`` with
``to_device=True``: the training-input path, whose batches are decoded on
the host and shipped to the card.

Every batch's shape and dtypes are checked as it arrives, and its
columns' sums are added on the device into the epoch's sums (one
reduction a column into tensors made in set-up, so it allocates nothing);
the batches at positions drawn from the seed before the window (the same
number in every epoch) are digested whole.  The check compares every complete
epoch's sums and every sampled batch with the reference.
"""

from __future__ import annotations

import random
import time

import torch

from .. import digest, reference, timing


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        t = ctx.traffic
        self.columns = list(t["columns"])
        self.batch = int(t["batch_size"])
        self.window_rows = int(t["shuffle_window"])
        self.per_epoch = int(t["check_batches_per_epoch"])
        self.epoch_batches = sum(ctx.layout["row_group_rows"]) // self.batch
        self.codes = [reference.fixed_digest(ctx.groups[0][c][:1])[0]
                      for c in self.columns]
        k = len(self.columns)
        self.sampled = digest.HostStore((k, 5), ctx.device)
        self.sums = digest.HostStore((k,), ctx.device)
        self.acc = torch.zeros(k, dtype=torch.int64, device=ctx.device)
        self.part = torch.zeros(k, dtype=torch.int64, device=ctx.device)
        self.part_rows = list(self.part)
        self.keys: list = []  # (epoch, batch index) of each sampled digest
        self.complete: list = []  # (epoch, batches it yielded)
        self.bad_shape = 0
        self.rows = 0
        self.wait0 = self.wait1 = 0.0
        self._it = None
        self._epoch = 0
        self.epoch_s: list = []
        from tpu_parquet_torch.data import DataLoader

        self.loader = DataLoader(
            ctx.path, self.batch, columns=self.columns, shuffle=True,
            seed=ctx.seed, shuffle_window=self.window_rows,
            prefetch=int(t["prefetch"]), to_device=True,
            drop_remainder=True, device=ctx.device)

    def picks(self, epoch: int) -> set:
        """The batch positions of ``epoch`` digested whole."""
        rng = random.Random(self.ctx.seed * 1_000_003 + epoch)
        return set(rng.sample(range(self.epoch_batches),
                              min(self.per_epoch, self.epoch_batches)))

    def _sum(self, b: dict) -> None:
        for c, out in zip(self.columns, self.part_rows):
            torch.sum(digest.words_view(b[c]), 0, dtype=torch.int64, out=out)
        self.acc.add_(self.part)

    def _digest(self, b: dict, keep: bool) -> None:
        d = digest.batch_digest(b, self.columns, self.ctx.pos)
        if keep:
            self.sampled.put(d)

    def _end_epoch(self, keep: bool) -> None:
        if keep:
            self.sums.put(self.acc)
        self.acc.zero_()

    def _epoch_batches(self, deadline, keep: bool) -> bool:
        """One epoch; False when the deadline cut it (left open)."""
        ctx, spans = self.ctx, self.ctx.spans
        epoch = self._epoch
        picks = self.picks(epoch)
        t0 = time.perf_counter()
        it = iter(self.loader)
        j = 0
        while True:
            with spans.span("wait_batch"):
                b = next(it, None)
            if b is None:
                break
            self.bad_shape += sum(
                int(b[c].numel() != self.batch
                    or digest.dtype_code(b[c].dtype) != code)
                for c, code in zip(self.columns, self.codes))
            with spans.span("digest"):
                ctx.on_side(lambda: self._sum(b), list(b.values()))
                if j in picks:
                    with ctx.memory.own():
                        ctx.on_side(lambda: self._digest(b, keep))
                        if keep:
                            self.keys.append((epoch, j))
                del b
            if keep:
                self.rows += self.batch
            j += 1
            if deadline is not None and time.perf_counter() >= deadline:
                self._it = it
                return False
        ctx.on_side(lambda: self._end_epoch(keep))
        if keep:
            self.complete.append((epoch, j))
            self.epoch_s.append(round(time.perf_counter() - t0, 4))
        self._epoch += 1
        return True

    def warm(self) -> None:
        self._epoch_batches(None, keep=False)
        self.bad_shape = 0

    def window(self, deadline: float) -> None:
        self.wait0 = self.loader.stats().decode_wait_seconds
        while (time.perf_counter() < deadline
               and self._epoch_batches(deadline, True)):
            pass
        self.wait1 = self.loader.stats().decode_wait_seconds

    def close(self) -> None:
        if self._it is not None:
            self._it.close()
            self._it = None

    def end_to_end(self, seconds: float) -> dict:
        return {"rows_per_s": timing.rate(self.rows, seconds)}

    def layer(self) -> dict:
        return {"window_rows": self.rows,
                "loader": {"decode_wait_seconds": self.wait1 - self.wait0},
                "epoch_s": self.epoch_s}

    def labelled_spans(self) -> list:
        return list(self.ctx.spans.items)

    def verify(self) -> tuple:
        ctx = self.ctx
        order = reference.LoaderOrder(ctx.seed, ctx.layout["row_group_rows"],
                                      self.window_rows, self.batch)
        ref = reference.LoaderAnswers(ctx.groups, self.columns, order)
        sums = self.sums.array()
        # each complete epoch: every batch there, the delivered values' sums
        bad_epochs = sum(int(count != order.batches
                             or (sums[i] != ref.epoch_sums(e)).any())
                         for i, (e, count) in enumerate(self.complete))
        got = self.sampled.array()
        bad_batches = sum(int((got[i] != ref.batch(*key)).any())
                          for i, key in enumerate(self.keys))
        checks = [("batch_shape_mismatches", self.bad_shape, "<=", 0),
                  ("epoch_sum_mismatches", bad_epochs, "<=", 0),
                  ("sampled_batch_mismatches", bad_batches, "<=", 0),
                  ("batches_compared", len(self.keys), ">=", 1)]
        return checks, self.rows // self.batch, 0
