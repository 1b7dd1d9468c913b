#!/usr/bin/env python
"""Kernels J (csrc/bit_update.cu) and K (csrc/hll_add.cu) on the shapes
config 4 and config 1 give them, on the card.

J's shapes, at load-graph -k 20 -x 8e9 -N 4 (4 GB of bit tables) on
scripts/synth_reads.py's 1,000,000 reads (chip_smoke phase 9b), its calls
those of the tagged consume (core/graphmixin.py: each block's hashes in
chunks of pipeline.DENSE_CHUNK), the hashes on the card before timing:
  (a) the stream's first chunk into the tables zeroed, each call after
      they are zeroed again;
  (b) chunks 1-5 and 40, each into the tables as the chunks before it
      left them, restored from a device copy before each call (chunk 40
      is the shape of most of the stream's calls: most of its lanes land
      on bits set already; chunks 1-5 the stream's way there);
  (c) the first chunk into the tables as the whole stream left them
      (every bit of it set; the tables do not change);
  (d) config 1's abundance batches (abundance-dist's batches over
      data/25k.fq.gz, as core/pipeline.abundance_distribution builds
      them, each with its valid mask), each into tracking tables of
      config 1's primes as the batches before it left them, restored
      before each call;
  (e) the whole stream, its calls issued back to back after the tables are
      zeroed.
K's shapes, at -e 0.01 (p 14) and k 20, on one native block (a flat chunk
of io/native.pack_blocks):
  (a) the first block of data/stamps-reads.fa.gz (chip_smoke phase 9a);
  (b) the first block of the synthetic reads (phase 9b);
  (c) (a)'s block at p 18 (registers merged in device memory).
Each is timed by CUDA events as issued (scripts.cuda_ms, or
scripts.reset_ms where the state is restored before each call) and on the
device alone (the stream held while the calls are issued), and given its
bounds, H100 SXM rates: J's bytes (8 B a hash, 1 B a flag, and for (d) a
mask byte; each distinct table byte its valid lanes touch read and
written) and its sector floor (the same with 32 B for each distinct
32-byte sector its lanes read, and again for each one in which a bit goes
from 0 to 1), with the share of its lanes on bits set before the call
(those its probe settles where it runs), counted from the tables, and
whether its sample lets the probe run (sketch_kernels.bit_sample_plain);
K's operations (graph_cases.hll_ops).
The host's share of phase 9b, on the synthetic reads, each timed
HOST_REPS times on the host's clock after one run that is not timed:
  (Pa) the native parser alone (io/native.pack_blocks over the file);
  (Pb) the parser and the dense hasher (core/hostengine.hash_dense_reads
       of each block, k 20), the tagged consume's host half;
  (Pc) unique-kmers -k 20 -e 0.01 in process, as chip_smoke runs it.

Needs a CUDA card. From the root of the repo:

    python -m khmer_tpu_torch.scripts.graph_bench [--shapes Ja Kb ...]
    python -m khmer_tpu_torch.scripts.graph_bench --parent DIR
    python -m khmer_tpu_torch.scripts.graph_bench --rules --shapes Ja Jb Jd

The first writes the synthetic reads into a directory of its own in the
repo root (removed after) and prints one JSON line a shape (a chunk of
(b), a batch of (d)). The second
times the shapes in turns with another checkout of the repo at DIR,
parent, this one, this one, parent: each side a process of its own,
running this file's timing code on its own checkout's kernels and host
code (J's and K's wrappers, the parser, the hasher and the CLI take the
same arguments in both), one JSON line a shape
tagged with its side. The third times J with its sample's rule replaced,
in turns: the probe always runs (side "probe"), or never (side "commit",
every lane to the bucketed commit), each a copy of this checkout's
package with csrc/bit_update.cu's kProbeMaxOpen set to 100 or -1, in a
directory of its own: where the two cross is where the rule should
switch.
"""

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch

SHAPES = ("Ja", "Jb", "Jc", "Jd", "Je", "Ka", "Kb", "Kc", "Pa", "Pb", "Pc")
HOST_REPS = 5
MID_CHUNK = 40   # shape (b): the call whose tables chunks 0..39 made
MID_CHUNKS = (1, 2, 3, 4, 5, MID_CHUNK)  # shape (b)'s chunks
# the sample's rule in csrc/bit_update.cu, and the values that replace it
# for --rules: the probe always runs, or never
RULE = re.compile(r"constexpr int kProbeMaxOpen = -?[0-9]+;")
RULES = {"probe": 100, "commit": -1}
X = 8e9          # phase 9b's -x; 4 tables
SECTOR = 32
PEAK_BYTES_S = 3.35e12  # H100 SXM HBM3
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
STAMPS = os.path.join(_REPO, "data", "stamps-reads.fa.gz")
ABUND_DATA = os.path.join(_REPO, "data", "25k.fq.gz")


def stream_chunks(reads, dev, k=20, upto=None):
    """The hashes of the tagged consume's calls over `reads` (the first
    `upto` of them, or all), in order, as device tensors."""
    from khmer_tpu_torch.core import pipeline
    from khmer_tpu_torch.core.graphmixin import dense_hashes, read_blocks
    from khmer_tpu_torch.core.sketch import _hashes_tensor

    out = []
    for codes, offs, lens in read_blocks(reads):
        hashes = dense_hashes(codes, offs, lens, k)[0]
        for lo in range(0, len(hashes), pipeline.DENSE_CHUNK):
            if len(out) == upto:
                return out
            out.append(_hashes_tensor(
                hashes[lo:lo + pipeline.DENSE_CHUNK], dev))
    return out


def abund_batches(dev, k=20):
    """The (hashes, valid) of every abundance-dist batch over
    data/25k.fq.gz, in order, as core/pipeline.abundance_distribution
    builds them."""
    from khmer_tpu_torch.core.pipeline import Batcher, hash_batch
    from khmer_tpu_torch.io.fastx import FastxParser

    batcher = Batcher(k)
    packed = []

    def add(batch):
        if batch is not None:
            packed.extend(batch if isinstance(batch, list) else [batch])
    for rec in FastxParser(ABUND_DATA):
        if len(rec.cleaned_seq) >= k:
            add(batcher.add(rec.cleaned_seq))
    add(batcher.flush())
    out = []
    for codes, lengths in packed:
        hashes, valid = hash_batch(torch.from_numpy(codes).to(dev),
                                   torch.from_numpy(lengths).to(dev), k)
        out.append((hashes.reshape(-1), valid.reshape(-1)))
    return out


def bit_lanes(K, primes, flat, hashes, n, valid=None):
    """Of the lanes of the events i < n (and valid[i]): (count, distinct
    table bytes, distinct sectors, lanes on bits 0 before the call,
    distinct sectors holding such a bit)."""
    live = torch.arange(hashes.shape[0], device=hashes.device) < n
    if valid is not None:
        live &= valid
    h = hashes[live]
    bits = torch.cat([K.umod(h, p) + 8 * o
                      for p, o in zip(primes, K.bit_offsets(primes))])
    zero = ((flat[bits // 8].to(torch.int64) >> (bits % 8)) & 1) == 0
    return (int(bits.numel()), int(torch.unique(bits // 8).numel()),
            int(torch.unique(bits // (8 * SECTOR)).numel()),
            int(zero.sum()),
            int(torch.unique(bits[zero] // (8 * SECTOR)).numel()))


def probed(K, primes, flat, hashes, n, valid=None):
    """Whether kernel J's sample lets its probe run on this call (None on
    a checkout whose J has no sample)."""
    if not hasattr(K, "bit_sample_plain"):
        return None
    return K.bit_sample_plain(primes, flat, hashes, n, valid)


def _j_record(shape, n, lanes, mask_bytes, ms, dev_ms, probe):
    """A J shape's record: times, bounds, the share of its lanes on bits
    set before the call and whether the probe ran."""
    count, nbytes, sectors, opened, written = lanes
    rest = (9 + mask_bytes) * n
    return {"shape": shape, "hashes": n, "calls": 1, "ms": ms,
            "device_ms": dev_ms, "lanes": count, "zero_lanes": opened,
            "set_share": 1 - opened / max(count, 1), "probed": probe,
            "bound_ms": (rest + 2 * nbytes) / PEAK_BYTES_S * 1e3,
            "sector_floor_ms": (rest + SECTOR * (sectors + written))
            / PEAK_BYTES_S * 1e3}


def time_bits(dev, reads, shapes, reps=20):
    """J's shapes of `shapes` (Ja..Je): one record each (each chunk of
    Jb and batch of Jd)."""
    from khmer_tpu_torch.core import sketch_kernels as K
    from khmer_tpu_torch.scripts import cuda_ms, device_ms, reset_ms

    out = []
    if "Jd" in shapes:
        primes = K.get_n_primes_near_x(4, 5e7)
        t = K.init_tables("bit", primes, dev)
        nu = torch.zeros(1, dtype=torch.int64, device=dev)
        batches = abund_batches(dev)
        scratch = K.update_scratch(
            None, max(h.shape[0] for h, _ in batches), 4, dev)
        for b, (hashes, valid) in enumerate(batches):
            n = hashes.shape[0]
            copy = t.flat.clone()
            lanes = bit_lanes(K, primes, t.flat, hashes, n, valid)
            probe = probed(K, primes, t.flat, hashes, n, valid)

            def restore():
                t.flat.copy_(copy)

            def call_d(hashes=hashes, valid=valid, n=n):
                return K.bit_update_cuda(primes, t, nu, hashes, n, valid,
                                         scratch)
            out.append(dict(_j_record(
                "Jd", n, lanes, 1,
                reset_ms(restore, call_d, reps, False)[0],
                reset_ms(restore, call_d, reps, True)[0], probe), batch=b))
            restore()
            call_d()  # the tables as this batch leaves them
        del t
    if not {"Ja", "Jb", "Jc", "Je"} & set(shapes):
        return out
    chunks = stream_chunks(reads, dev)
    primes = K.get_n_primes_near_x(4, X)
    t = K.init_tables("bit", primes, dev)
    nu = torch.zeros(1, dtype=torch.int64, device=dev)
    scratch = K.update_scratch(None, max(c.shape[0] for c in chunks), 4,
                               dev)

    def call(h):
        return K.bit_update_cuda(primes, t, nu, h, h.shape[0],
                                 scratch=scratch)

    def zero():
        t.flat.zero_()

    def stream_from(lo, hi):
        for h in chunks[lo:hi]:
            call(h)

    def stream(upto=len(chunks)):
        stream_from(0, upto)

    first = chunks[0]
    if "Ja" in shapes:
        zero()
        n = first.shape[0]
        lanes = bit_lanes(K, primes, t.flat, first, n)
        probe = probed(K, primes, t.flat, first, n)
        out.append(_j_record(
            "Ja", n, lanes, 0,
            reset_ms(zero, lambda: call(first), reps, False)[0],
            reset_ms(zero, lambda: call(first), reps, True)[0], probe))
    if "Je" in shapes:
        n = sum(c.shape[0] for c in chunks)
        out.append({"shape": "Je", "hashes": n, "calls": len(chunks),
                    "ms": reset_ms(zero, stream, 3, False)[0],
                    "device_ms": reset_ms(zero, stream, 3, True)[0]})
    if "Jb" in shapes:
        zero()
        done = 0
        for c in MID_CHUNKS:
            stream_from(done, c)
            done = c
            copy = t.flat.clone()
            h = chunks[c]
            n = h.shape[0]
            lanes = bit_lanes(K, primes, t.flat, h, n)
            probe = probed(K, primes, t.flat, h, n)

            def restore():
                t.flat.copy_(copy)
            out.append(dict(_j_record(
                "Jb", n, lanes, 0,
                reset_ms(restore, lambda: call(h), reps, False)[0],
                reset_ms(restore, lambda: call(h), reps, True)[0], probe),
                chunk=c))
            restore()
            del copy
    if "Jc" in shapes:
        zero()
        stream()
        n = first.shape[0]
        out.append(_j_record("Jc", n, bit_lanes(K, primes, t.flat, first, n),
                             0, cuda_ms(lambda: call(first), reps),
                             device_ms(lambda: call(first), reps),
                             probed(K, primes, t.flat, first, n)))
    del t, chunks
    torch.cuda.empty_cache()
    return out


def first_block(path):
    """(codes, starts, fill) of the first native block of `path`."""
    from khmer_tpu_torch.io import native

    codes, meta, _ = next(native.pack_blocks(path))
    return codes, meta[:, 0].astype(np.int64), len(codes)


def time_hll(dev, reads, shapes, reps=20):
    """K's shapes of `shapes` (Ka..Kc): one record each."""
    from khmer_tpu_torch.core import sketch_kernels as K
    from khmer_tpu_torch.scripts import cuda_ms, device_ms
    from khmer_tpu_torch.scripts.graph_cases import hll_ops

    out = []
    for shape, path, p in (("Ka", STAMPS, 14), ("Kb", reads, 14),
                           ("Kc", STAMPS, 18)):
        if shape not in shapes:
            continue
        codes, starts, fill = first_block(path)
        cd = torch.from_numpy(codes).to(dev)
        sd = torch.from_numpy(starts).to(dev)
        regs = torch.zeros(1 << p, dtype=torch.uint8, device=dev)
        nwin = K.flat_valid_windows(starts, fill, 20)

        def call():
            K.hll_add_cuda(regs, cd, sd, fill, 20)
        out.append({"shape": shape, "p": p, "codes": fill,
                    "windows": nwin, "ms": cuda_ms(call, reps),
                    "device_ms": device_ms(call, reps),
                    "bound_ms": hll_ops(20, nwin) / 67e12 * 1e3})
    return out


def time_host(reads, shapes):
    """The host shapes of `shapes` (Pa..Pc): one record each, with the
    seconds of each timed run."""
    import contextlib
    import io
    import time

    from khmer_tpu_torch.cli import unique_kmers
    from khmer_tpu_torch.core import hostengine
    from khmer_tpu_torch.io import native

    def parse():
        for _ in native.pack_blocks(reads):
            pass

    def parse_hash():
        for codes, meta, _ in native.pack_blocks(reads):
            hostengine.hash_dense_reads(codes, meta[:, 0], meta[:, 1], 20,
                                        "twobit")

    def count():
        with contextlib.redirect_stderr(io.StringIO()):
            unique_kmers.main(["-k", "20", "-e", "0.01", reads])
        torch.cuda.synchronize()

    out = []
    for shape, fn in (("Pa", parse), ("Pb", parse_hash), ("Pc", count)):
        if shape not in shapes:
            continue
        fn()
        seconds = []
        for _ in range(HOST_REPS):
            t0 = time.perf_counter()
            fn()
            seconds.append(time.perf_counter() - t0)
        out.append({"shape": shape, "seconds": seconds})
    return out


def run(dev, reads, shapes):
    """Every shape of `shapes` on this checkout's kernels, in SHAPES'
    order: one record each (each chunk of (b) and batch of (d)), with the
    card's name."""
    from khmer_tpu_torch.ops import cuda

    cuda.library()  # built before anything is timed
    name = torch.cuda.get_device_name(dev)
    recs = (time_hll(dev, reads, shapes) + time_bits(dev, reads, shapes)
            + time_host(reads, shapes))
    order = {s: i for i, s in enumerate(SHAPES)}
    return [dict(r, device=name)
            for r in sorted(recs, key=lambda r: order[r["shape"]])]


# One side of in_turns, run in the root of its checkout (its package
# first on the path): this file's run() on that checkout's kernels.
_SIDE = ("import importlib.util as iu, json, sys, torch\n"
         "spec = iu.spec_from_file_location('bench', sys.argv[1])\n"
         "bench = iu.module_from_spec(spec)\n"
         "spec.loader.exec_module(bench)\n"
         "reads, shapes = json.loads(sys.argv[2])\n"
         "for rec in bench.run(torch.device('cuda', 0), reads, shapes):\n"
         "    print(json.dumps(rec), flush=True)\n")


def in_turns(sides, reads, shapes):
    """The shapes timed on the kernels of each checkout of `sides`, a
    list of (label, root), in its order, each in a process of its own:
    yields (label, record)."""
    job = json.dumps([reads, list(shapes)])
    for side, root in sides:
        out = subprocess.run(
            [sys.executable, "-c", _SIDE, os.path.abspath(__file__), job],
            cwd=root, capture_output=True, text=True, check=True).stdout
        for line in out.splitlines():
            yield side, json.loads(line)


def rule_copy(tmp, name):
    """A copy of this checkout's package under tmp/name whose kernel J
    takes the sample's rule RULES[name]: the root to run it from."""
    root = os.path.join(tmp, name)
    pkg = os.path.join(root, "khmer_tpu_torch")
    shutil.copytree(os.path.join(_REPO, "khmer_tpu_torch"), pkg,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    cu = os.path.join(pkg, "csrc", "bit_update.cu")
    with open(cu) as f:
        src = f.read()
    src, n = RULE.subn("constexpr int kProbeMaxOpen = %d;" % RULES[name],
                       src)
    if n != 1:
        raise RuntimeError("kProbeMaxOpen is not in %s" % cu)
    with open(cu, "w") as f:
        f.write(src)
    return root


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", nargs="+", choices=SHAPES,
                    default=list(SHAPES))
    ap.add_argument("--parent", metavar="DIR",
                    help="time them in turns with the checkout at DIR")
    ap.add_argument("--rules", action="store_true",
                    help="time them in turns with J's probe always and "
                    "never run")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("graph_bench needs a CUDA device")
    from khmer_tpu_torch.scripts.synth_reads import write_reads

    with tempfile.TemporaryDirectory(prefix=".graph_bench_",
                                     dir=_REPO) as tmp:
        reads = os.path.join(tmp, "synth.fa")
        write_reads(reads)
        sides = []
        if a.parent:
            sides += [("parent", a.parent), ("change", _REPO),
                      ("change", _REPO), ("parent", a.parent)]
        if a.rules:
            probe, commit = (rule_copy(tmp, name) for name in RULES)
            sides += [("probe", probe), ("commit", commit),
                      ("commit", commit), ("probe", probe)]
        if sides:
            for side, rec in in_turns(sides, reads, a.shapes):
                print(json.dumps(dict(side=side, **rec)), flush=True)
            return
        dev = torch.device("cuda", torch.cuda.current_device())
        for rec in run(dev, reads, a.shapes):
            print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
