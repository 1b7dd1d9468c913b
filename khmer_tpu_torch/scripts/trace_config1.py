#!/usr/bin/env python
"""Where the time goes in config 1 on the card.

Traces, with torch.profiler, the three device phases of config 1 as
users run it (load-into-counting -k 20 -x 5e7 -N 4, then abundance-dist)
on data/25k.fq.gz, in the exact layout (the default) and in the blocked
layout: consume_seqfile on the record path (the CLI's), consume_seqfile
on the native-parser path, and abundance_distribution. Each is run once untraced first (lazy CUDA module loading, the native
library's build), then once traced. For each it reports the wall time,
the device time (the sum of self device time over the device-side
entries, the table's "Self CUDA time total"; the operator entries that
launched them repeat the same time and are left out), the device's busy
share of the wall time, and the device-side entries (kernels, copies,
fills) that take the most time.

Needs a CUDA card. Run from the repo root:

    python -m khmer_tpu_torch.scripts.trace_config1
"""

import json
import os
import time

import torch
from torch.autograd import DeviceType

from khmer_tpu_torch import BlockedCountgraph, Countgraph, Nodegraph
from khmer_tpu_torch.io.fastx import FastxParser

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "data", "25k.fq.gz")
K = 20


def _self_device_us(event):
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0))


def main(top=8):
    """Trace each phase; returns one record per phase."""
    if not torch.cuda.is_available():
        raise RuntimeError("trace_config1 needs a CUDA device")
    dev = torch.device("cuda", torch.cuda.current_device())

    def exact():
        cg = Countgraph(K, 5e7, 4, device=dev)
        cg.set_use_bigcount(True)  # as load-into-counting makes it
        return cg

    def blocked():
        return BlockedCountgraph(K, 5e7, 4, device=dev)

    phases = []
    for layout, make in (("exact", exact), ("blocked", blocked)):
        loaded = make()
        loaded.consume_seqfile(DATA)

        def histogram(loaded=loaded):
            tracking = Nodegraph(K, 1, 1, primes=loaded.hashsizes(),
                                 device=dev)
            loaded.abundance_distribution(DATA, tracking)

        phases += [
            (layout + ", consume, record path",
             lambda make=make: make().consume_seqfile(FastxParser(DATA))),
            (layout + ", consume, native path",
             lambda make=make: make().consume_seqfile(DATA)),
            (layout + ", abundance histogram", histogram)]
    out = []
    for label, fn in phases:
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        device_ms = sum(_self_device_us(e) for e in events) / 1e3
        ranked = sorted(events, key=_self_device_us, reverse=True)[:top]
        out.append({
            "phase": label, "wall_ms": wall * 1e3, "device_ms": device_ms,
            "busy_share": device_ms / (wall * 1e3),
            "top": [(e.key, _self_device_us(e) / 1e3, e.count)
                    for e in ranked]})
    return out


if __name__ == "__main__":
    for record in main():
        print(json.dumps(record))
