#!/usr/bin/env python
"""Kernel K (csrc/hll_add.cu) built in variants and timed on its shapes,
on the card: what each half of its design buys.

Each variant is the kernel's source with one change, built by nvcc into
a library of its own under khmer_tpu_torch/_build/variants/:
  * base: the source as it is (sliding 2-bit words, 32-bit shared
    registers);
  * bytes: u8 shared registers (16 KB at p 14), four a 32-bit word,
    raised by a compare-and-swap of their bytewise maximum;
  * rebuild: kSlideMaxK 0, every window's murmur words rebuilt from its
    staged codes a byte at a time (the sliding words' validity and
    palindrome test kept);
  * rebuild-bytes: both;
  * check: an atomicMax only where the shared register holds less;
  * t1024: 1024-thread blocks, two an SM (32 registers a thread);
  * t256: 256-thread blocks, three an SM.
Each is timed on the device alone (scripts.device_ms) on
graph_bench's K shapes, (a) and (b) at p 14 and (c) at p 18, and checked
against hll_add_plain. One JSON line a shape: {variant: [ms, equal]}.
From the repo root:

    python -m khmer_tpu_torch.scripts.hll_variants
"""

import ctypes
import json
import os
import subprocess
import tempfile

import torch

from khmer_tpu_torch.core import sketch_kernels as K
from khmer_tpu_torch.ops import cuda
from khmer_tpu_torch.scripts import device_ms, graph_bench

_SLIDE = ("constexpr int kSlideMaxK = 32;",
          "constexpr int kSlideMaxK = 0;")
# u8 shared registers, four a 32-bit word, raised by max_word's
# compare-and-swap and merged a word at a time
_BYTES = (("      atomicMax(&regs[index], rho);",
           "      max_word(regs + (index >> 2), rho << (8 * (index & 3)));"),
          ("  const int nwords = kShared ? nc : 0;",
           "  const int nwords = kShared ? nc / 4 : 0;"),
          ("""    const uint32_t mine = regs[4 * q] | regs[4 * q + 1] << 8
                          | regs[4 * q + 2] << 16 | regs[4 * q + 3] << 24;""",
           "    const uint32_t mine = regs[q];"),
          ("blocks, (4 << p) + tile_bytes, s);",
           "blocks, (1 << p) + tile_bytes, s);"))
_CHECK = ("      atomicMax(&regs[index], rho);",
          "      if (regs[index] < rho) atomicMax(&regs[index], rho);")
_THREADS = "constexpr int kThreads = 512;"
_PER_SM = "constexpr int kBlocksPerSm = 2;"
# name -> (edits, threads a block, blocks an SM)
VARIANTS = {
    "base": ((), 512, 2),
    "bytes": (_BYTES, 512, 2),
    "rebuild": ((_SLIDE,), 512, 2),
    "rebuild-bytes": ((_SLIDE,) + _BYTES, 512, 2),
    "check": ((_CHECK,), 512, 2),
    "t1024": (((_THREADS, "constexpr int kThreads = 1024;"),), 1024, 2),
    "t256": (((_THREADS, "constexpr int kThreads = 256;"),
              (_PER_SM, "constexpr int kBlocksPerSm = 3;")), 256, 3),
}


def build():
    """{variant: its khmer_hll_add} built by one nvcc each, at once; and
    ptxas's report of each."""
    out_dir = os.path.join(cuda.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(cuda.CSRC, "hll_add.cu")) as f:
        src = f.read()
    procs = {}
    for name, (edits, _, _) in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError("variant %s: %r not in the source"
                                   % (name, old))
            text = text.replace(old, new)
        cu = os.path.join(out_dir, "hll_" + name + ".cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [cuda._nvcc()] + cuda.ARCH_FLAGS
            + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared",
               "-Xptxas", "-v", "-I", cuda.CSRC, "-o",
               os.path.join(out_dir, "hll_" + name + ".so"), cu],
            stderr=subprocess.PIPE, text=True)
    fns, reports = {}, {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError("nvcc failed on variant %s:\n%s"
                               % (name, err))
        reports[name] = [line.strip() for line in err.splitlines()
                         if "registers" in line or "spill" in line]
        lib = ctypes.CDLL(os.path.join(out_dir, "hll_" + name + ".so"))
        fn = lib.khmer_hll_add
        fn.argtypes = cuda._ENTRY_POINTS["khmer_hll_add"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns, reports


def launcher(fn, threads, per_sm, regs, codes, starts, fill, k=20):
    """A call of one variant, on as many blocks as its grid takes."""
    dev = regs.device
    p = regs.shape[0].bit_length() - 1
    tile = threads * K.HLL_RUN
    blocks = max(1, min(K._sm_count(dev.index) * per_sm,
                        -(-(fill - k + 1) // tile)))

    def call():
        cuda.check(fn(codes.data_ptr(), fill, starts.data_ptr(),
                      starts.shape[0], k, p, regs.data_ptr(), blocks,
                      dev.index, K._stream(dev)), "hll_add variant")
    return call


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("hll_variants needs a CUDA device")
    dev = torch.device("cuda", torch.cuda.current_device())
    fns, reports = build()
    print(json.dumps({"ptxas": reports}), flush=True)
    with tempfile.TemporaryDirectory(prefix=".graph_bench_",
                                     dir=graph_bench._REPO) as tmp:
        from khmer_tpu_torch.scripts.synth_reads import write_reads

        reads = os.path.join(tmp, "synth.fa")
        write_reads(reads)
        for shape, path, p in (("Ka", graph_bench.STAMPS, 14),
                               ("Kb", reads, 14),
                               ("Kc", graph_bench.STAMPS, 18)):
            codes, starts, fill = graph_bench.first_block(path)
            cd = torch.from_numpy(codes).to(dev)
            sd = torch.from_numpy(starts).to(dev)
            want = K.hll_add_plain(
                torch.zeros(1 << p, dtype=torch.uint8, device=dev), cd, sd,
                fill, 20)
            out = {}
            for name, fn in fns.items():
                _, threads, per_sm = VARIANTS[name]
                regs = torch.zeros(1 << p, dtype=torch.uint8, device=dev)
                call = launcher(fn, threads, per_sm, regs, cd, sd, fill)
                call()
                out[name] = [device_ms(call, 20), torch.equal(regs, want)]
            print(json.dumps({"shape": shape, "p": p, "codes": fill,
                              "device": torch.cuda.get_device_name(dev),
                              "device_ms": out}), flush=True)


if __name__ == "__main__":
    main()
