#!/usr/bin/env python
"""Scatter-add histogram on the card.

Counterpart of scripts/profile_scatter2.py, whose Pallas kernel
(pallas_hist) adds M = 2^21 indices serially into a VMEM-resident int32
histogram of PT = 2^17 bins. Here the same histogram goes through kernel
C (csrc/histogram.cu, histogram_add), its plain PyTorch version
(core/sketch_kernels.py histogram_add_plain) and, as the yardstick, one
PyTorch call that computes it, ``torch.bincount(idx, minlength=PT)``.

Needs a CUDA card. Run from the repo root:

    python -m khmer_tpu_torch.scripts.profile_scatter2
"""

import json

import numpy as np
import torch

from khmer_tpu_torch.core import sketch_kernels as K
from khmer_tpu_torch.scripts import cuda_ms

M = 1 << 21
PT = 1 << 17


def main(m=M, nbins=PT, reps=20, seed=0):
    """Histogram m uniform indices into nbins bins three ways on the
    current CUDA device; returns ms per call of each and the largest
    difference between the kernel's and the others' histograms."""
    if not torch.cuda.is_available():
        raise RuntimeError("profile_scatter2 needs a CUDA device")
    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(seed)
    idx = torch.from_numpy(rng.integers(0, nbins, m).astype(np.int64)).to(
        dev)
    hist = {}

    def kernel():
        hist["kernel"] = K.histogram_add_cuda(
            torch.zeros(nbins, dtype=torch.int64, device=dev), idx)

    def plain():
        hist["plain"] = K.histogram_add_plain(
            torch.zeros(nbins, dtype=torch.int64, device=dev), idx)

    def library():
        hist["library"] = torch.bincount(idx, minlength=nbins)

    ms = {name: cuda_ms(fn, reps) for name, fn in (
        ("kernel", kernel), ("plain", plain), ("library", library))}
    err = max(int((hist["kernel"] - hist[k]).abs().max())
              for k in ("plain", "library"))
    touched = int((hist["library"] != 0).sum())
    return {"device": torch.cuda.get_device_name(dev), "events": m,
            "nbins": nbins, "ms": ms["kernel"], "plain_ms": ms["plain"],
            "library_ms": ms["library"], "max_abs_err": err,
            # at least: each index read once, each touched bin read and
            # written once (int64)
            "bytes": 8 * m + 16 * touched, "ops": m}


if __name__ == "__main__":
    print(json.dumps(main()))
