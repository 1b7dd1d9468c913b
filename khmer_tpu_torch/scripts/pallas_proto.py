#!/usr/bin/env python
"""The fused blocked read-modify-write over decoded events, on the card.

Counterpart of scripts/pallas_proto.py, whose Pallas kernel (make_kernel)
walks precomputed events through a VMEM-resident table. Here the same
events go through kernel D (csrc/proto_rmw.cu) and its plain PyTorch
version (core/blocked.py proto_rmw_plain), at the script's shapes:

  * correctness: a 64-slab table (2,048 blocks), 2 x 4,096 events with
    forced duplicates and 10% invalid, kernel against plain version;
  * timing: 2^19 blocks (a 64 MB table) and 2^20 events, 5 calls on an
    accumulating table, kernel against plain version, and kernel 1
    (csrc/blocked_update.cu) on 2^20 hashes into a table of the same
    size, whose events have the same shape (one lane in each 32-lane
    quarter of one 128-byte block). Both kernels run on the bucketed core
    (csrc/bucket_common.cuh), with the events' scratch; its bytes are
    printed beside those of an int32 winner image of one entry per
    counter, the table-sized scratch the core does without.

Needs a CUDA card. Run from the repo root:

    python -m khmer_tpu_torch.scripts.pallas_proto
"""

import json

import numpy as np
import torch

from khmer_tpu_torch.core import blocked as B
from khmer_tpu_torch.core.sketch_kernels import update_plan, update_scratch
from khmer_tpu_torch.scripts import cuda_ms

SLAB = 32          # table rows per slab of the Pallas kernel
LANES = B.LANES
TILE = 4096        # events per grid step of the Pallas kernel


def pack_offs(offs):
    """[M, 4] lane offsets -> int32 [M], 8 bits each."""
    return (offs[:, 0] | (offs[:, 1] << 8) | (offs[:, 2] << 16)
            | (offs[:, 3] << 24)).astype(np.int32)


def correctness_case(rng):
    """The script's correctness inputs (scripts/pallas_proto.py:171-182),
    drawn from `rng` in the same order: (bids int32 [M], -1 invalid;
    offs int32 [M, 4]; the zero table [nblocks, 128] uint8)."""
    nb = 64 * SLAB
    m = TILE * 2
    bids = rng.integers(0, nb, m).astype(np.int32)
    bids[100:160] = bids[100]
    offs = np.stack([rng.integers(0, 32, m) + 32 * q for q in range(4)],
                    axis=1).astype(np.int32)
    offs[120:160] = offs[100]
    invalid = rng.random(m) < 0.1
    bids = np.where(invalid, -1, bids).astype(np.int32)
    return bids, offs, np.zeros((nb, LANES), np.uint8)


def timing_events(rng, nb, m):
    """m events on nb blocks, one lane in each quarter
    (scripts/pallas_proto.py:197-200)."""
    bids = rng.integers(0, nb, m).astype(np.int32)
    offs = pack_offs(np.stack([rng.integers(0, 32, m) + 32 * q
                               for q in range(4)], axis=1).astype(np.int32))
    return bids, offs


ADVERSARIAL = ("one-event-x2^20", "all-on-7-blocks",
               "repeats-invalid-saturate", "crowded-bucket")


def adversarial_cases(rng):
    """Decoded-event cases that hold kernel D to its plain version, drawn
    from `rng`, in the order of ADVERSARIAL: (name, bids int32 [M], packed
    offs int32 [M], table [nblocks, 128] uint8, passes).

      * one event repeated 2^20 times: four counters of 2^20 occurrences
        each, through 255 in one pass;
      * 2^20 events crowded onto 7 blocks (896 counters);
      * lanes repeated within an event (a set), ids below 0 and at or past
        nblocks out to int32's limits, on a table whose first blocks sit at
        250, so that counters saturate;
      * 2^16 events on the first 400 of 100,003 blocks: tens of thousands
        of distinct counters in two buckets, far more than one bucket's
        map holds, so that the kernel splits them.
    """
    m = 1 << 20
    one_b, one_o = timing_events(rng, 101, 1)
    b7, o7 = timing_events(rng, 7, m)
    nb = 5
    bs, os_ = timing_events(rng, nb, 4000)
    bs[::7] = -1
    bs[::11] = nb + 3
    bs[::17] = np.iinfo(np.int32).min
    bs[::19] = np.iinfo(np.int32).max
    os_[::13] = pack_offs(np.asarray([[5, 5, 40, 40]], np.int32))[0]
    os_[::23] = pack_offs(np.asarray([[9, 9, 9, 9]], np.int32))[0]
    sat = np.zeros((nb, LANES), np.uint8)
    sat[:2] = 250
    bc, oc = timing_events(rng, 400, 1 << 16)
    return [
        (ADVERSARIAL[0], np.repeat(one_b, m), np.repeat(one_o, m),
         np.zeros((101, LANES), np.uint8), 2),
        (ADVERSARIAL[1], b7, o7, np.zeros((7, LANES), np.uint8), 2),
        (ADVERSARIAL[2], bs, os_, sat, 2),
        (ADVERSARIAL[3], bc, oc, np.zeros((100003, LANES), np.uint8), 2),
    ]


def main(nb=1 << 19, m=1 << 20, reps=5, seed=0):
    """Run both phases on the current CUDA device; returns their numbers
    (the correctness result, and ms per call of kernel D, its plain
    version and kernel 1, with kernel D's scratch bytes)."""
    if not torch.cuda.is_available():
        raise RuntimeError("pallas_proto needs a CUDA device")
    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(seed)

    bids, offs, table = correctness_case(rng)
    bids_d = torch.from_numpy(bids).to(dev)
    offs_d = torch.from_numpy(pack_offs(offs)).to(dev)
    tab_k = torch.from_numpy(table).to(dev)
    tab_p = tab_k.clone()
    nnew_k = int(B.proto_rmw_cuda(bids_d, offs_d, tab_k))
    nnew_p = int(B.proto_rmw_plain(bids_d, offs_d, tab_p))
    err = max(int((tab_k.int() - tab_p.int()).abs().max()),
              abs(nnew_k - nnew_p))
    out = {"device": torch.cuda.get_device_name(dev),
           "correct": {"nblocks": table.shape[0], "events": len(bids),
                       "nnew": nnew_k, "max_abs_err": err}}

    bids, offs = timing_events(rng, nb, m)
    bids_d = torch.from_numpy(bids).to(dev)
    offs_d = torch.from_numpy(offs).to(dev)
    hashes = torch.from_numpy(rng.integers(0, 2**64, m, dtype=np.uint64)
                              .view(np.int64)).to(dev)
    tab_k = torch.zeros((nb, LANES), dtype=torch.uint8, device=dev)
    tab_p = tab_k.clone()
    tab_1 = tab_k.clone()
    nnew = {"kernel": [], "plain": []}
    nu_1 = torch.zeros(1, dtype=torch.int64, device=dev)
    # each kernel's scratch, kept between calls as a sketch keeps it
    scratch = update_scratch(None, m, B.SUB, dev)
    scratch_1 = update_scratch(None, m, B.SUB, dev)
    ms = {
        "kernel": cuda_ms(lambda: nnew["kernel"].append(
            B.proto_rmw_cuda(bids_d, offs_d, tab_k, scratch)), reps),
        "plain": cuda_ms(lambda: nnew["plain"].append(
            B.proto_rmw_plain(bids_d, offs_d, tab_p)), reps),
        "blocked_update": cuda_ms(lambda: B.blocked_update_cuda(
            tab_1, hashes, m, nu_1, scratch_1), reps),
    }
    total = {k: int(torch.stack(v).sum()) for k, v in nnew.items()}
    err = max(int((tab_k.int() - tab_p.int()).abs().max()),
              abs(total["kernel"] - total["plain"]))
    # what the card must move at least: 8 B of event each, and one read
    # and one write of each distinct counter the events touch
    lanes = B._proto_lanes(bids_d, offs_d, nb)[1]
    touched = int(torch.unique(lanes).numel())
    out["timing"] = {
        "nblocks": nb, "events": m, "calls": reps + 1,
        "ms": ms["kernel"], "plain_ms": ms["plain"],
        "blocked_update_ms": ms["blocked_update"],
        "ns_per_event": ms["kernel"] * 1e6 / m,
        "bytes": 8 * m + 2 * touched, "ops": 4 * m,
        "scratch_bytes": update_plan(m, B.SUB)[2],
        "winner_image_bytes": 4 * tab_k.numel(),
        "nnew": total["kernel"], "max_abs_err": err}
    return out


if __name__ == "__main__":
    print(json.dumps(main()))
