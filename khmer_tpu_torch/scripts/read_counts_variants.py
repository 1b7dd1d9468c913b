#!/usr/bin/env python
"""Kernel H (csrc/read_counts.cu) built in variants and timed over tile
and segment sizes on its shapes, on the card: what its time moves with.

Each variant is the kernel's source with one change, built by nvcc into
a library of its own under khmer_tpu_torch/_build/variants/:
  * base: the source as it is (kBatch 2 items a thread);
  * b1, b4: 1 or 4 items a thread, their loads issued together;
  * ldcg: the counter loads through L2 alone (__ldcg, no L1);
  * b4ldcg: both;
  * lb8: __launch_bounds__(256, 8), 32 registers, 8 blocks an SM.
Each is timed on the device alone (scripts.device_ms) at several plans
(rows a tile, windows a segment) of each of trim_bench's H_SHAPES, at
config 3's cutoff 2 and coverage 20, and checked against
read_counts_plain. One JSON line a shape: {variant rROWS sSEG: [ms,
equal]}. From the repo root:

    python -m khmer_tpu_torch.scripts.read_counts_variants [a b c d]
"""

import ctypes
import json
import os
import subprocess
import sys
import tempfile

import torch

from khmer_tpu_torch.core import sketch_kernels as K
from khmer_tpu_torch.ops import cuda
from khmer_tpu_torch.scripts import device_ms, trim_bench

_LOAD = "v[dt][u] = flat[counter_index(layout, h[u], t0 + dt)];"
_LDCG = "v[dt][u] = __ldcg(flat + counter_index(layout, h[u], t0 + dt));"
_BATCH = "constexpr int kBatch = 2;"
_BOUNDS = "__global__ void __launch_bounds__(kBlock)"
VARIANTS = {
    "base": (),
    "b1": ((_BATCH, "constexpr int kBatch = 1;"),),
    "b4": ((_BATCH, "constexpr int kBatch = 4;"),),
    "ldcg": ((_LOAD, _LDCG),),
    "b4ldcg": ((_BATCH, "constexpr int kBatch = 4;"), (_LOAD, _LDCG)),
    "lb8": ((_BOUNDS, "__global__ void __launch_bounds__(kBlock, 8)"),),
}
# (rows a tile, windows a segment) of each shape
PLANS = {
    "a": [(4, 128), (8, 128), (16, 128), (32, 128), (64, 128)],
    "b": [(4, 128), (8, 128), (16, 128), (32, 128), (64, 128)],
    "c": [(1, 1024), (2, 1024), (4, 1024), (2, 512), (4, 512), (8, 256),
          (1, 2048)],
    "d": [(1, 256), (1, 512), (1, 1024), (1, 2048), (1, 4096)],
}


def build():
    """{variant: its khmer_read_counts} built by one nvcc each, at once."""
    out_dir = os.path.join(cuda.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(cuda.CSRC, "read_counts.cu")) as f:
        src = f.read()
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError("variant %s: %r not in the source"
                                   % (name, old))
            text = text.replace(old, new)
        cu = os.path.join(out_dir, name + ".cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [cuda._nvcc()] + cuda.ARCH_FLAGS
            + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared", "-I",
               cuda.CSRC, "-o", os.path.join(out_dir, name + ".so"), cu],
            stderr=subprocess.PIPE, text=True)
    fns = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError("nvcc failed on variant %s:\n%s"
                               % (name, err))
        lib = ctypes.CDLL(os.path.join(out_dir, name + ".so"))
        fn = lib.khmer_read_counts
        fn.argtypes = cuda._ENTRY_POINTS["khmer_read_counts"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def launcher(fn, primes, k, cutoff, at_least, flat, rows, lengths, plan):
    """A call of one variant at plan (rows a tile, windows a segment)."""
    R, L = rows.shape
    dev = flat.device
    trim_at = torch.empty(R, dtype=torch.int32, device=dev)
    n_ge = torch.empty(R, dtype=torch.int32, device=dev)
    scratch = torch.empty(2 * R + -(-R // plan[0]), dtype=torch.int32,
                          device=dev)
    primes_arr, offsets_arr = K._layout(primes)

    def call():
        cuda.check(fn(flat.data_ptr(), len(primes),
                      ctypes.addressof(primes_arr),
                      ctypes.addressof(offsets_arr), rows.data_ptr(),
                      lengths.data_ptr(), R, L, k, cutoff, at_least, *plan,
                      None, None, 0, trim_at.data_ptr(), n_ge.data_ptr(),
                      scratch.data_ptr(), None, dev.index, K._stream(dev)),
                   "read_counts variant")
        return trim_at, n_ge
    return call


def main(argv=None):
    shapes = (argv if argv is not None else sys.argv[1:]) or list(PLANS)
    if not torch.cuda.is_available():
        raise RuntimeError("read_counts_variants needs a CUDA device")
    dev = torch.device("cuda", torch.cuda.current_device())
    fns = build()
    with tempfile.TemporaryDirectory(prefix=".trim_bench_",
                                     dir=trim_bench._REPO) as tmp:
        reads = None
        if "b" in shapes:
            from khmer_tpu_torch.scripts.synth_reads import write_reads

            reads = os.path.join(tmp, "synth.fa")
            write_reads(reads)
        for shape in shapes:
            primes, flat, rows, lengths = trim_bench.shape_inputs(
                dev, shape, reads)
            want = K.read_counts_plain(primes, 20, 2, 20, flat, rows,
                                       lengths)
            reps = 3 if shape == "d" else 20
            out = {}
            for name, fn in fns.items():
                for plan in PLANS[shape]:
                    call = launcher(fn, primes, 20, 2, 20, flat, rows,
                                    lengths, plan)
                    equal = all(torch.equal(a, b)
                                for a, b in zip(call(), want))
                    out["%s r%d s%d" % ((name,) + plan)] = [
                        device_ms(call, reps), equal]
            print(json.dumps({"shape": shape, "rows": rows.shape[0],
                              "L": rows.shape[1],
                              "device": torch.cuda.get_device_name(dev),
                              "device_ms": out}), flush=True)
            del flat
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
