"""Buddy allocator over shell slots.

Implements the paper's "combine adjacent PR regions" capability: allocations
are power-of-two runs of adjacent slots, aligned buddy-style so merges are
always possible when both buddies are free.  O(slots) per operation.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Range:
    start: int
    size: int

    @property
    def slots(self) -> tuple[int, ...]:
        return tuple(range(self.start, self.start + self.size))


class _BusySet(set):
    """Busy-slot set that mirrors every mutation into the allocator's
    bitmask, so window-freeness stays one shift+mask even for callers
    (tests, diagnostics) that poke `alloc.busy` directly.

    Every mutation routes through the owner's `_mark`/`_unmark`
    chokepoint (below) — the single place busy-set and bitmask move,
    which is what the schedlint mutation checker verifies."""

    def __init__(self, owner: "BuddyAllocator"):
        super().__init__()
        self._owner = owner

    def add(self, i):
        self._owner._mark(i)

    def discard(self, i):
        self._owner._unmark(i)

    def remove(self, i):
        if i not in self:
            raise KeyError(i)
        self._owner._unmark(i)

    def update(self, *others):
        for o in others:
            for i in o:
                self._owner._mark(i)

    def clear(self):
        # schedlint: ok(determinism) _unmark is commutative (discard +
        # mask clear): the final busy/mask state is iteration-order-free
        for i in tuple(self):
            self._owner._unmark(i)


class BuddyAllocator:
    def __init__(self, n_slots: int):
        assert n_slots >= 1
        self.n = n_slots            # any count; allocations stay
        # busy slots as a bitmask, kept in lockstep with `busy`: window
        # freeness is one shift+mask instead of a per-slot set probe
        # (the scheduler's free-window scans are on the per-event path)
        self._mask = 0
        self.busy: set[int] = _BusySet(self)  # po2 sized & size-aligned
        self._lf_mask, self._lf_best = -1, 0  # largest_free memo

    # -- queries ------------------------------------------------------------

    def free_slots(self) -> list[int]:
        return [i for i in range(self.n) if i not in self.busy]

    def window_free(self, start: int, size: int) -> bool:
        """Are slots [start, start+size) all free?  O(1) via the mask."""
        return (self._mask >> start) & ((1 << size) - 1) == 0

    def can_alloc(self, size: int, within: int | None = None) -> bool:
        return self.find(size, within) is not None

    def largest_free(self) -> int:
        if self._mask == self._lf_mask:
            return self._lf_best       # allocation state unchanged
        size = 1
        best = 0
        while size <= self.n:
            if self.find(size) is not None:
                best = size
            size *= 2
        self._lf_mask, self._lf_best = self._mask, best
        return best

    def aligned_starts(self, size: int) -> range:
        """Start indices of every size-aligned window (the only placeable
        positions); shared by find() and the scheduler's preemption scan."""
        return range(0, self.n - size + 1, size)

    def find(self, size: int, within: int | None = None) -> Range | None:
        """Smallest-index aligned free run of `size` slots, confined to
        the first `within` slots (None = the whole shell; the scheduler
        passes `n - reserve` to keep reserved slots out of reach)."""
        assert size >= 1 and (size & (size - 1)) == 0
        if size > self.n:
            return None
        limit = self.n if within is None else within
        window = (1 << size) - 1
        for start in self.aligned_starts(size):
            if start + size > limit:
                break
            if (self._mask >> start) & window == 0:
                return Range(start, size)
        return None

    # -- mutation -----------------------------------------------------------
    # `_mark`/`_unmark` are the single mutation chokepoint: every busy/
    # mask change — alloc, free, and direct `alloc.busy` pokes through
    # `_BusySet` — flows through them, so the busy set and the bitmask
    # cannot drift apart and the schedlint mutation checker has exactly
    # one pair of writers to verify.

    def _mark(self, i: int) -> None:
        set.add(self.busy, i)             # raw set op: no _BusySet loop
        self._mask |= 1 << i

    def _unmark(self, i: int) -> None:
        set.discard(self.busy, i)
        self._mask &= ~(1 << i)

    def alloc(self, size: int) -> Range | None:
        r = self.find(size)
        if r is None:
            return None
        for i in r.slots:
            self._mark(i)
        return r

    def alloc_at(self, r: Range) -> None:
        assert self.window_free(r.start, r.size), "double alloc"
        assert r.start % r.size == 0, "unaligned"
        for i in r.slots:
            self._mark(i)

    def free(self, r: Range) -> None:
        for i in r.slots:
            assert i in self.busy, f"double free of slot {i}"
            self._unmark(i)

    @property
    def utilization(self) -> float:
        return len(self.busy) / self.n
