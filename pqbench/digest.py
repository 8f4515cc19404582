"""Digests of what the program returned, taken on its device.

A digest folds a column into five ``int64`` numbers, with wrapping
arithmetic, so that whole passes can be compared with the reference
(:mod:`pqbench.reference` computes the same numbers from the generator's
arrays) without keeping them:

- a fixed-width column of ``n`` values, each value's bits ``w`` as ``int64``
  (8-byte types reinterpreted, 4-byte ones sign-extended):
  ``[code, n, sum(w), sum(w * (i + 1)), 0]``, ``code`` naming the dtype;
- a STRING column, its values laid end to end in one heap:
  ``[3000, n, sum(len_i * (i + 1)), sum(b + 1), sum((b + 1) * (p + 1))]``
  over each row's length and each heap byte ``b`` at heap position ``p``.

A leaf that carries def or rep levels digests its defined values so, in
slot order, and its levels into six more numbers (:func:`level_digests`):
each level stream's count, sum and position-weighted sum over the leaf's
``num_leaf_slots``.  A row group of flat leaves launches nothing for them:
its six numbers a leaf are zeros, filled on the host (:meth:`HostStore.put`
of ``None``).

Only torch is imported: the program's column objects are read by their
fields (``values``; ``offsets`` and ``heap``; a dictionary column's
``indices`` with ``dict_u8`` or ``dict_offsets`` and ``dict_heap``).  No
digest copies from the host to the device: a copy from pageable memory
would wait for the device, and the digest would hold the caller back by
more than its own work.  Small constants are made once (:class:`Positions`);
everything else a digest allocates on the device is freed when it returns,
and its result goes to pinned host memory (:class:`HostStore`), so the
benchmark keeps no device memory of its own through a window.
"""

from __future__ import annotations

import torch

STRING_CODE = 3000
# bytes of a plain string heap folded per step (bounds the temporaries)
HEAP_CHUNK = 2 << 20
# fixed-width columns folded per step (bounds the temporaries)
COLUMNS_PER_STEP = 4
_CODES = {torch.int64: 1008, torch.int32: 1004, torch.float64: 2008,
          torch.float32: 2004, torch.int16: 1002, torch.int8: 1001}


def dtype_code(dtype) -> int:
    return _CODES.get(dtype, 9999)


class Positions:
    """1..n as ``int64`` on one device, made anew for each digest (a
    temporary, freed with it), and small constant tensors, each made once."""

    def __init__(self, device):
        self.device = device
        self._consts: dict = {}

    def __call__(self, n: int) -> torch.Tensor:
        return torch.arange(1, n + 1, dtype=torch.int64, device=self.device)

    def const(self, values: tuple) -> torch.Tensor:
        t = self._consts.get(values)
        if t is None:
            t = torch.tensor(values, dtype=torch.int64, device=self.device)
            self._consts[values] = t
        return t


class HostStore:
    """Rows of ``shape`` int64 digests kept in pinned host memory, each
    copied from the device without waiting (on the stream current at
    :meth:`put`); read them once the device has finished."""

    ROWS = 1024  # rows per pinned block

    def __init__(self, shape: tuple, device):
        self.shape = tuple(shape)
        self.pin = device.type == "cuda"
        self.blocks: list = []
        self.n = 0
        self._grow()

    def _grow(self) -> None:
        self.blocks.append(torch.empty((self.ROWS,) + self.shape,
                                       dtype=torch.int64,
                                       pin_memory=self.pin))

    def put(self, d: "torch.Tensor | None") -> None:
        """Store ``d``; ``None`` stores a row of zeros, on the host."""
        if self.n == len(self.blocks) * self.ROWS:
            self._grow()
        row = self.blocks[self.n // self.ROWS][self.n % self.ROWS]
        if d is None:
            row.zero_()
        else:
            row.copy_(d, non_blocking=self.pin)
        self.n += 1

    def array(self):
        """The stored rows as one NumPy array (after the device's work)."""
        import numpy as np

        if not self.n:
            return np.zeros((0,) + self.shape, dtype=np.int64)
        return torch.cat(self.blocks)[: self.n].numpy()


def words_view(v: torch.Tensor) -> torch.Tensor:
    """A tensor's bits as the signed integers of its width."""
    return v.view({8: torch.int64, 4: torch.int32, 2: torch.int16,
                   1: torch.int8}[v.element_size()])


def words(v: torch.Tensor) -> torch.Tensor:
    """Each value's bits as ``int64`` (4-byte and narrower sign-extended)."""
    w = words_view(v)
    return w if w.dtype == torch.int64 else w.to(torch.int64)


def fixed_digests(values: list, pos: Positions) -> torch.Tensor:
    """``[len(values), 5]``: the digests of equal-length value tensors."""
    n = values[0].numel()
    head = pos.const(tuple(x for v in values for x in (dtype_code(v.dtype),
                                                       n, 0)))
    sums = []
    for lo in range(0, len(values), COLUMNS_PER_STEP):
        w = torch.stack([words(v) for v in values[lo : lo + COLUMNS_PER_STEP]])
        sums.append(torch.stack([w.sum(1), (w * pos(n)).sum(1)], 1))
    h = head.view(-1, 3)
    return torch.cat([h[:, :2], torch.cat(sums), h[:, 2:]], 1)


def fixed_digest(v: torch.Tensor, pos: Positions) -> torch.Tensor:
    return fixed_digests([v], pos)[0]


def _string_row(n: int, l1, h0, h1, pos: Positions) -> torch.Tensor:
    return torch.cat([pos.const((STRING_CODE, n)), torch.stack([l1, h0, h1])])


def plain_string_digest(offsets: torch.Tensor, heap: torch.Tensor, n: int,
                        pos: Positions) -> torch.Tensor:
    o = offsets[: n + 1]
    lens = o[1:] - o[:-1]
    l1 = (lens * pos(n)).sum()
    base = o[0]
    total = o[n] - base
    parts = []
    for lo in range(0, heap.numel(), HEAP_CHUNK):
        seg = heap[lo : lo + HEAP_CHUNK].to(torch.int64) + 1
        q = pos(seg.numel()) + (lo - 1) - base  # heap position, 0-based
        seg = seg * ((q >= 0) & (q < total))
        parts.append(torch.stack([seg.sum(), (seg * (q + 1)).sum()]))
    hs = (torch.stack(parts).sum(0) if parts
          else pos.const((0, 0)))
    return _string_row(n, l1, hs[0], hs[1], pos)


def dict_string_digest(indices: torch.Tensor, doff: torch.Tensor,
                       dheap: torch.Tensor, n: int,
                       pos: Positions) -> torch.Tensor:
    """A ragged dictionary column's digest as if its values were laid end
    to end, from per-entry prefix sums over the dictionary's heap (entries
    past the real dictionary are padding: their sums are never read by a
    valid index, and every index into them is clamped)."""
    k = doff.numel() - 1
    size = dheap.numel()
    hv = dheap.to(torch.int64) + 1
    zero = pos.const((0,))
    p0 = torch.cat([zero, torch.cumsum(hv, 0)])
    p1 = torch.cat([zero, torch.cumsum(hv * (pos(size) - 1), 0)])
    s = doff[:k].clamp(0, size)
    t = torch.maximum(doff[1 : k + 1].clamp(0, size), s)
    s0 = p0[t] - p0[s]
    te = (p1[t] - p1[s]) - (s - 1) * s0
    le = t - s
    idx = (indices[:n].to(torch.int64) & 0xFFFFFFFF).clamp(0, max(k - 1, 0))
    s0r, tr, lr = s0[idx], te[idx], le[idx]
    out_off = torch.cumsum(lr, 0) - lr
    return _string_row(n, (lr * pos(n)).sum(), s0r.sum(),
                       (out_off * s0r + tr).sum(), pos)


def dense_values(col) -> torch.Tensor:
    """A flat fixed-width column's real values; a fixed-width dictionary
    column is gathered on its device first (``materialize()``)."""
    if getattr(col, "indices", None) is not None:
        col = col.materialize()
    return col.values[: col.num_values]


def is_string(col) -> bool:
    if getattr(col, "indices", None) is not None:
        return col.dict_u8 is None
    return col.values is None


def string_digest(col, pos: Positions) -> torch.Tensor:
    if getattr(col, "indices", None) is not None:
        return dict_string_digest(col.indices, col.dict_offsets,
                                  col.dict_heap, col.num_values, pos)
    return plain_string_digest(col.offsets, col.heap, col.num_values, pos)


def group_digest(group: dict, names, pos: Positions) -> torch.Tensor:
    """``[len(names), 5]``: each leaf's digest (of a leaf with levels, its
    defined values); a leaf that is missing digests as ``-1``s."""
    fixed, rows, order = [], [], []
    for i, name in enumerate(names):
        col = group.get(name)
        if col is None:
            rows.append(pos.const((-1, -1, -1, -1, -1)))
            order.append(("other", i))
        elif is_string(col):
            rows.append(string_digest(col, pos))
            order.append(("other", i))
        else:
            fixed.append(dense_values(col))
            order.append(("fixed", i))
    if fixed and len({v.numel() for v in fixed}) > 1:
        # columns of one row group of unequal length: each on its own
        fixed_rows = torch.stack([fixed_digest(v, pos) for v in fixed])
    elif fixed:
        fixed_rows = fixed_digests(fixed, pos)
    out = []
    fi = oi = 0
    for kind, _i in order:
        if kind == "fixed":
            out.append(fixed_rows[fi])
            fi += 1
        else:
            out.append(rows[oi])
            oi += 1
    return torch.stack(out)


def level_digest(col, pos: Positions) -> torch.Tensor:
    """``[6]``: the def levels' count, sum and position-weighted sum over
    the leaf's slots, then the rep levels' (zeros for a stream the leaf
    does not have)."""
    n = col.num_leaf_slots
    p = None
    out = []
    for levels, most in ((col.def_levels, col.max_def),
                         (col.rep_levels, col.max_rep)):
        if not most or levels is None:
            out.append(pos.const((0, 0, 0)))
            continue
        p = pos(n) if p is None else p
        w = levels[:n].to(torch.int64)
        out += [pos.const((n,)), torch.stack([w.sum(), (w * p).sum()])]
    return torch.cat(out)


def level_digests(group: dict, names, pos: Positions):
    """``[len(names), 6]``: each leaf's :func:`level_digest` (zeros for a
    flat or missing leaf), or ``None`` where no leaf carries levels, so a
    flat row group launches nothing."""
    cols = [group.get(name) for name in names]
    if not any(c is not None and (c.max_def or c.max_rep) for c in cols):
        return None
    return torch.stack([level_digest(c, pos) if c is not None
                        else pos.const((0,) * 6) for c in cols])


def batch_digest(batch: dict, names, pos: Positions) -> torch.Tensor:
    """``[len(names), 5]``: each column of one loader batch."""
    return fixed_digests([batch[c] for c in names], pos)


def tensors_of(col) -> list:
    """Every tensor a column object of the program holds."""
    return [v for v in vars(col).values() if isinstance(v, torch.Tensor)]


def output_bytes(col, plain_bytes: int) -> int:
    """The bytes a decode has to write to return ``col`` in the form the
    program returned it: a dictionary column's indices (its real count)
    and its dictionary tables, and one byte a slot for each level stream
    it has; any other column as ``plain_bytes`` gives it (the reference's
    count, levels included)."""
    if getattr(col, "indices", None) is None:
        return int(plain_bytes)
    dict_bytes = sum(t.numel() * t.element_size()
                     for t in (col.dict_u8, col.dict_offsets, col.dict_heap)
                     if t is not None)
    streams = (col.max_def > 0) + (col.max_rep > 0)
    return int(col.num_values * col.indices.element_size() + dict_bytes
               + streams * col.num_leaf_slots)
