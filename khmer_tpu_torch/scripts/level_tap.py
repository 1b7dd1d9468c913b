"""A tap on the walks' level probe on the card, and their clocks, for
chip_smoke.py and scripts/nbr_bench.py.

add_clocks(totals) adds each walk's clocks (kt_level_stats) and its probe
context's (LevelProbe.stats) to `totals` as core/partition._Prober.run
runs it on the card.

While installed, every core/partition._Prober made on the card runs its
walk's levels (csrc/level_walk.cc kt_level_run) through a PROBE_FN
callback that first calls the card's own probe, the C function on the
prober's context (khmer_byte_probe_level, khmer_nibble_probe_level or
khmer_bit_probe_level: the kernel launches and counts as on the main
path), and then, outside the probe's time: holds every `every`-th
level's bytes to the plain version on the same frontier on the card,
writes each frontier to a spool file for a replay, and keeps the largest
on the card. Around each run it adds
up the walk's clocks (kt_level_stats) and the context's
(LevelProbe.stats).
"""

import ctypes
import time

import numpy as np
import torch

from khmer_tpu_torch.core import partition as P
from khmer_tpu_torch.core import sketch_kernels as K
from khmer_tpu_torch.ops import host

# what each run adds up: the walk's clocks and the context's
WALK_KEYS = host.LEVEL_STATS
CARD_KEYS = K.LevelProbe.STATS


def add_clocks(totals):
    """Wrap partition._Prober.run so that each run on the card adds its
    walk's clocks and its context's (their change over the run) to
    `totals`; returns a function that removes the wrap."""
    run = P._Prober.run

    def clocked(prober, walk):
        if prober.card is None:
            return run(prober, walk)
        before = prober.card.stats()
        try:
            return run(prober, walk)
        finally:
            after = prober.card.stats()
            for key in CARD_KEYS:
                totals[key] = totals.get(key, 0.0) + after[key] - before[key]
            for key, v in walk.stats().items():
                totals[key] = totals.get(key, 0.0) + v

    P._Prober.run = clocked
    return lambda: setattr(P._Prober, "run", run)


class LevelTap:
    """Taps the probers of one table kind ("bit": kernel L, "byte": kernel
    N, "nibble": N's nibble mode) while installed (install() returns the function that removes it).
    After the walks: sizes (each level's nodes, in order), calls, checked
    (nodes held to plain, at most max_check of a level), err (bytes that
    differ), seconds (host seconds of the checks and the spool), largest
    ((f, r, the prober) of the largest level, on the card) and
    largest_below (the same of the largest level of fewer than `below`
    nodes, where given), totals (the walks' and contexts' clocks, summed
    by add_clocks), and replay() gives the spooled levels back."""

    def __init__(self, kind, every=1, spool=None, max_check=1 << 21,
                 below=None):
        self.kind, self.every, self.spool_path = kind, every, spool
        self.max_check, self.below = max_check, below
        self.sizes = []
        self.calls = self.checked = self.err = 0
        self.seconds = 0.0
        self.largest = self.largest_below = None
        self.totals = dict.fromkeys(WALK_KEYS + CARD_KEYS, 0.0)
        self._spool = None

    def install(self):
        remove_clocks = add_clocks(self.totals)
        run = P._Prober.run
        if self.spool_path:
            self._spool = open(self.spool_path, "wb")

        def tapped_run(prober, walk):
            if prober.card is not None and prober.card.kind == self.kind \
                    and not hasattr(prober, "_tap_probe"):
                prober._tap_probe = host.PROBE_FN(self._level(prober))
                prober.probe = prober._tap_probe
            return run(prober, walk)

        P._Prober.run = tapped_run

        def remove():
            P._Prober.run = run
            remove_clocks()
            if self._spool is not None:
                self._spool.close()
                self._spool = None
        return remove

    def _level(self, prober):
        """The callback of one prober: its card probe, then the tap."""
        real = host.PROBE_FN(prober.card.probe)

        def level(ctx, fr, n, masks, band):
            err = real(ctx, fr, n, masks, band)
            if err:
                return err
            try:
                self._after(prober, fr, n, masks, band)
            except Exception as e:  # the C++ loop's boundary
                prober._error = e
                return 1
            return 0
        return level

    def _after(self, prober, fr, n, masks, band):
        t0 = time.perf_counter()
        front = np.frombuffer((ctypes.c_int64 * (2 * n)).from_address(fr),
                              np.int64)
        if self._spool is not None:
            front.tofile(self._spool)
        self.sizes.append(n)
        check = self.calls % self.every == 0
        larger = self.largest is None or n > self.largest[0].shape[0]
        below = self.below is not None and n < self.below and (
            self.largest_below is None
            or n > self.largest_below[0].shape[0])
        if check or larger or below:
            on_card = torch.from_numpy(front.copy()).to(prober.dev)
            f, r = on_card[:n], on_card[n:]
            if check:
                self._check(prober, f, r, masks, band, n)
            if larger:
                self.largest = (f, r, prober)
            if below:
                self.largest_below = (f, r, prober)
        self.calls += 1
        self.seconds += time.perf_counter() - t0

    def _check(self, prober, f, r, masks, band, n):
        m = min(n, self.max_check)
        g = prober.graph
        if self.kind == "bit":
            want = K.neighbors_plain(g._primes, g.tables.flat, f[:m], r[:m],
                                     g.ksize())
            lo, hi = prober.band or (1, 1)
            want = (want, want if lo <= 1 <= hi else torch.zeros_like(want))
        elif self.kind == "nibble":
            want = K.nibble_neighbors_plain(g._primes, g.tables.flat, f[:m],
                                            r[:m], g.ksize(), prober.band or
                                            (1, 15))
        else:
            want = K.byte_neighbors_plain(g._primes, g.tables.flat, f[:m],
                                          r[:m], g.ksize(), prober.band or
                                          (1, 255), prober.big)
        for out, w in ((masks, want[0]), (band, want[1])):
            if out:
                got = np.frombuffer((ctypes.c_uint8 * m).from_address(out),
                                    np.uint8)
                self.err += int((torch.from_numpy(got.copy())
                                 != w.cpu()).sum())
        self.checked += m

    def replay(self, dev):
        """The spooled frontiers, each as (f, r) on `dev`, in order."""
        walk = torch.from_numpy(np.fromfile(self.spool_path, np.int64)).to(
            dev)
        out, o = [], 0
        for n in self.sizes:
            out.append((walk[o:o + n], walk[o + n:o + 2 * n]))
            o += 2 * n
        return out
