#!/usr/bin/env python
"""Kernels C (csrc/histogram.cu) and 2 (csrc/blocked_gather.cu) at the
shapes the main path gives them, on the card.

The shapes, config 1 (k = 20, 4 x 5e7 bytes, data/25k.fq.gz) built here
through the package's own entry points:

  * the first batch of the abundance histogram, in the exact layout (C's
    indices) and in the blocked layout (kernel 2 over the batch's
    hashes, then C's indices);
  * chip_smoke phase 5's chunk: the stream's first 2^20 hashes on the
    config-1 blocked table (kernel 2), and 2^20 random hashes;
  * scripts/profile_scatter2.py's 2^21 uniform indices into 2^17 bins (C).

Each is timed by CUDA events over `reps` back-to-back calls, as the host
issues them (scripts.cuda_ms: launch overhead included, what a caller
sees) and with the stream held while they are issued (scripts.device_ms:
the device time alone), beside the host's time to issue one call
(scripts.host_us). From the root of the repo:

    python -m khmer_tpu_torch.scripts.hist_gather_bench [--sweep]

With --sweep it also times kernel C on other block counts than its plan's,
and kernel 2 on a table that fits in L2 and on hashes sorted by block:
what the gather costs when DRAM serves it less. Prints one JSON object,
with the card's name and power limit.
"""

import json
import os
import subprocess
import sys

import numpy as np
import torch

import khmer_tpu_torch
from khmer_tpu_torch.core import blocked as B
from khmer_tpu_torch.core import sketch_kernels as K
from khmer_tpu_torch.scripts import cuda_ms, device_ms, host_us

REPO = os.path.dirname(os.path.dirname(os.path.abspath(
    khmer_tpu_torch.__file__)))
DATA = os.path.join(REPO, "data", "25k.fq.gz")
KSIZE = 20
PEAK_BYTES_S = 3.35e12  # H100 SXM HBM3


def timed(fn, reps):
    return {"ms": cuda_ms(fn, reps), "device_ms": device_ms(fn, reps),
            "host_us": host_us(fn, reps)}


def first_events(dev):
    """The events of abundance-dist's first batch over data/25k.fq.gz, as
    its step builds them (pipeline.Batcher, hash_batch): (hashes, valid),
    one of each a window of the batch's [B, L] rows."""
    from khmer_tpu_torch.core.pipeline import Batcher, hash_batch
    from khmer_tpu_torch.io.fastx import FastxParser

    batcher = Batcher(KSIZE)
    batch = None
    for rec in FastxParser(DATA):
        batch = batcher.add(rec.cleaned_seq)
        if batch is not None:
            break
    codes, lengths = batch
    hashes, valid = hash_batch(torch.from_numpy(codes).to(dev),
                               torch.from_numpy(lengths).to(dev), KSIZE)
    return hashes.reshape(-1), valid.reshape(-1)


def first_batch(main, dev):
    """The first abundance batch of `main` (a config-1 sketch) through
    sketch_kernels.abund_batch, as abundance-dist's step builds it: the
    events' hashes and their histogram indices."""
    from khmer_tpu_torch import Nodegraph

    hashes, valid = first_events(dev)
    tracking = Nodegraph(KSIZE, 1, 1, primes=main.hashsizes(), device=dev)
    b = K.abund_batch("bit", tracking._primes, tracking.tables,
                      main.storage_kind, main._primes, main.tables,
                      hashes, valid)
    return hashes, b["idx"]


def bincount(idx, nbins):
    """torch.bincount as histogram_add computes it, for indices >= 0: the
    bins past nbins dropped."""
    return torch.bincount(idx, minlength=nbins)[:nbins]


def stream_chunk(n=1 << 20):
    """The first n canonical hashes of the 25k stream, in order."""
    from khmer_tpu_torch.core.pipeline import DenseHasher
    from khmer_tpu_torch.io.fastx import FastxParser

    hasher = DenseHasher(KSIZE, "twobit")
    parts, have = [], 0
    for rec in FastxParser(DATA):
        if len(rec.cleaned_seq) >= KSIZE:
            for h, m in hasher.add(rec.cleaned_seq):
                parts.append(h[:m].copy())
                have += m
        if have >= n:
            break
    else:
        parts.extend(h[:m].copy() for h, m in hasher.flush())
    return np.concatenate(parts)[:n]


def blocked_floors(nblocks, hashes):
    """(least bytes, distinct (block, quarter) sectors) of a blocked
    gather: 12 B a hash plus each distinct counter once, and each
    distinct 32-byte quarter of a block once."""
    lanes = B._lane_index(K.umod(hashes, nblocks), B._offsets(hashes))
    counters = int(torch.unique(lanes).numel())
    sectors = int(torch.unique(lanes >> 5).numel())
    return 12 * hashes.shape[0] + counters, sectors


def hist_bound_bytes(idx, nbins):
    """8 B an index, a read and a write (int64) of each touched bin."""
    touched = int((bincount(idx[idx >= 0], nbins) != 0).sum())
    return 8 * idx.shape[0] + 16 * touched


def time_hist(idx, nbins, reps):
    acc = torch.zeros(nbins, dtype=torch.int64, device=idx.device)
    want = bincount(idx, nbins)
    got = K.histogram_add_cuda(torch.zeros_like(acc), idx)
    out = {"indices": idx.shape[0], "nbins": nbins,
           "max_abs_err": int((got - want).abs().max()),
           "bound_ms": hist_bound_bytes(idx, nbins) / PEAK_BYTES_S * 1e3}
    out.update(timed(lambda: K.histogram_add_cuda(acc, idx), reps))
    out["bincount"] = timed(lambda: bincount(idx, nbins), reps)
    return out


def time_gather2(table, hashes, reps):
    nb = table.shape[0]
    got = B.blocked_gather_cuda(table, hashes)
    want = B.gather_counts_plain(nb, (table,), hashes)
    nbytes, sectors = blocked_floors(nb, hashes)
    out = {"hashes": hashes.shape[0], "nblocks": nb,
           "max_abs_err": int((got - want).abs().max()),
           "bound_ms": nbytes / PEAK_BYTES_S * 1e3, "sectors": sectors,
           "sector_floor_ms": sectors * 32 / PEAK_BYTES_S * 1e3}
    out.update(timed(lambda: B.blocked_gather_cuda(table, hashes), reps))
    return out


def sweep(dev, shapes, table, chunk, reps):
    """Kernel C on other block counts than histogram_plan's; kernel 2 on
    a table that fits in L2 and on hashes sorted by block (this tree
    only)."""
    from khmer_tpu_torch.ops import cuda

    lib = cuda.library()
    sms = K._sm_count(dev.index)
    stream = K._stream(dev)
    out = {"hist": [], "gather": []}
    for label, idx, nbins in shapes:
        want = bincount(idx, nbins)
        plan = K.histogram_plan(idx.shape[0], sms)
        for blocks in sorted({sms // 2, sms, 2 * sms, 4 * sms, 8 * sms,
                              plan}):
            acc = torch.zeros(nbins, dtype=torch.int64, device=dev)

            def run():
                cuda.check(lib.khmer_histogram_add(
                    idx.data_ptr(), idx.shape[0], acc.data_ptr(), nbins,
                    blocks, dev.index, stream), "histogram_add")
            run()
            out["hist"].append({
                "shape": label, "blocks": blocks, "plan": plan,
                "max_abs_err": int((acc - want).abs().max()),
                "device_ms": device_ms(run, reps)})
    small = table[:196613]  # 25 MB: fits in L2
    order = torch.argsort(K.umod(chunk, table.shape[0]))
    for label, tab, h in (("chunk, L2-resident table", small, chunk),
                          ("chunk sorted by block", table,
                           chunk[order].contiguous())):
        r = time_gather2(tab, h, reps)
        r["case"] = label
        out["gather"].append(r)
    return out


def main(reps=50, do_sweep=False):
    if not torch.cuda.is_available():
        raise RuntimeError("hist_gather_bench needs a CUDA device")
    from khmer_tpu_torch import BlockedCountgraph, Countgraph
    from khmer_tpu_torch.io.fastx import FastxParser

    dev = torch.device("cuda", torch.cuda.current_device())
    nbins = K.ABUND_BINS
    exact = Countgraph(KSIZE, 5e7, 4, device=dev)
    exact.set_use_bigcount(True)
    exact.consume_seqfile(FastxParser(DATA))
    _, idx_exact = first_batch(exact, dev)
    del exact
    blocked = BlockedCountgraph(KSIZE, 5e7, 4, device=dev)
    blocked.consume_seqfile(FastxParser(DATA))
    uh, idx_blocked = first_batch(blocked, dev)
    table = blocked.tables[0]
    chunk = torch.from_numpy(stream_chunk().view(np.int64)).to(dev)
    rnd = torch.from_numpy(np.random.default_rng(4).integers(
        0, 2**64, 1 << 20, dtype=np.uint64).view(np.int64)).to(dev)
    uniform = torch.from_numpy(np.random.default_rng(0).integers(
        0, 1 << 17, 1 << 21).astype(np.int64)).to(dev)
    res = {
        "device": torch.cuda.get_device_name(dev),
        # name and power limit: a card set below 700 W runs slower
        "card": subprocess.run(
            ["nvidia-smi", "-i", str(dev.index),
             "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip(),
        "hist_exact_batch": time_hist(idx_exact, nbins, reps),
        "hist_blocked_batch": time_hist(idx_blocked, nbins, reps),
        "hist_uniform_2^21x2^17": time_hist(uniform, 1 << 17, reps),
        "gather2_blocked_batch": time_gather2(table, uh, reps),
        "gather2_stream_chunk": time_gather2(table, chunk, reps),
        "gather2_random_2^20": time_gather2(table, rnd, reps),
    }
    if do_sweep:
        res["sweep"] = sweep(dev, [
            ("exact batch", idx_exact, nbins),
            ("uniform 2^21x2^17", uniform, 1 << 17)], table, chunk, reps)
    return res


if __name__ == "__main__":
    print(json.dumps(main(do_sweep="--sweep" in sys.argv[1:])))
