#!/usr/bin/env python
"""Where the time goes in config 4 on the card.

Traces, with torch.profiler, the device work of config 4's two CLIs as
users run them (unique-kmers -k 20 -e 0.01; load-graph -k 20 -N 4): the
HLL consume (kernel K) and the tagged consume (kernel J, its new flags
back to the host, the spacing pass), on data/stamps-genomes.fa at -x
2.5e7 (BASELINE row 4), data/stamps-reads.fa.gz at -x 12.5e6 and, given
--synth, a read file at -x 8e9 (4 GB of bit tables). Each is run once
untraced first, then traced. For each it reports the wall time, the
device time (the sum of self device time over the device-side entries),
the device's busy share, K's and J's device time and kernel launches
beside the launches the wrappers counted (a trace that misses some of
them is reported as such), and the device-side entries that take the
most time.

Needs a CUDA card. Run from the repo root:

    python -m khmer_tpu_torch.scripts.trace_config4 [--synth reads.fa]
"""

import argparse
import json
import os
import time

import torch
from torch.autograd import DeviceType

from khmer_tpu_torch.core import sketch_kernels as K
from khmer_tpu_torch.core.hll import HLLCounter
from khmer_tpu_torch.core.sketch import Nodegraph
from khmer_tpu_torch.scripts.trace_config1 import _self_device_us

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "data")
INPUTS = [("stamps-genomes", os.path.join(DATA, "stamps-genomes.fa"),
           2.5e7),
          ("stamps-reads", os.path.join(DATA, "stamps-reads.fa.gz"),
           12.5e6)]
# kernel J's device entries: its sample and probe, its templates over
# BitEvents (two tile passes and the bucket pass a call) and the bucketed
# core's scan and finalize, which no other kernel of these runs uses
J_NAMES = ("bit_sample_kernel", "bit_probe_kernel", "BitEvents",
           "scan_kernel", "finalize_kernel")
J_BIT_EVENTS = 3


def trace(fn, top=6):
    """fn() untraced, then traced: one record."""
    dev = torch.device("cuda", torch.cuda.current_device())
    fn(dev)
    torch.cuda.synchronize()
    K.hll_add_cuda.launches = K.bit_update_cuda.launches = 0
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn(dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]

    def named(*names):
        hit = [e for e in events if any(n in e.key for n in names)]
        return (sum(_self_device_us(e) for e in hit) / 1e3,
                sum(e.count for e in hit))

    device_ms = sum(_self_device_us(e) for e in events) / 1e3
    k_ms, k_n = named("hll_add_kernel")
    j_ms, j_n = named(*J_NAMES)
    calls = {"hll_add": K.hll_add_cuda.launches,
             "bit_update": K.bit_update_cuda.launches}
    ranked = sorted(events, key=_self_device_us, reverse=True)[:top]
    return {"wall_ms": wall * 1e3, "device_ms": device_ms,
            "busy_share": device_ms / (wall * 1e3),
            "hll_add_ms": k_ms, "hll_add_kernels": k_n,
            "bit_update_ms": j_ms, "bit_update_kernels": j_n,
            "calls": calls,
            "whole": (k_n == calls["hll_add"] and named("BitEvents")[1]
                      == J_BIT_EVENTS * calls["bit_update"]),
            "top": [(e.key[:80], _self_device_us(e) / 1e3, e.count)
                    for e in ranked]}


def main(inputs=INPUTS):
    """Trace each input's HLL consume and tagged consume; returns one
    record per run."""
    if not torch.cuda.is_available():
        raise RuntimeError("trace_config4 needs a CUDA device")
    out = []
    for label, path, x in inputs:
        def hll(dev, path=path):
            HLLCounter(0.01, 20, device=dev).consume_seqfile(path)

        def tagged(dev, path=path, x=x):
            Nodegraph(20, x, 4, device=dev).consume_seqfile_and_tag(path)

        for what, fn in (("HLL consume", hll), ("tagged consume", tagged)):
            rec = trace(fn)
            rec.update(input=label, x=x, run=what)
            out.append(rec)
            torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--synth", help="a read file to trace at -x 8e9")
    args = parser.parse_args()
    inputs = list(INPUTS)
    if args.synth:
        inputs.append(("synth", args.synth, 8e9))
    for record in main(inputs):
        print(json.dumps(record))
