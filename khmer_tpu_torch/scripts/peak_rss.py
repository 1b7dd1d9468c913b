#!/usr/bin/env python
"""Run a command and print its wall time and peak resident memory.

Measures what a CPU run needs in host memory, for example the JAX
package's normalize-by-median under KHMER_TPU_ENGINE=device, whose scan
keeps u32 copies of the u8 tables:

    KHMER_TPU_ENGINE=device JAX_PLATFORMS=cpu \\
        python -m khmer_tpu_torch.scripts.peak_rss -- \\
        python -m khmer_tpu.cli.normalize_by_median -k 20 -C 20 -x 1e8 \\
        -N 4 reads.fa

The last line on stderr is one JSON object: the command's exit code, its
wall seconds and its peak resident set in bytes (the largest of its
process tree's, as getrusage reports for waited-for children).
"""

import json
import resource
import subprocess
import sys
import time


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["--"]:
        argv = argv[1:]
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    rc = subprocess.call(argv)
    wall = time.perf_counter() - t0
    peak = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss * 1024
    print(json.dumps({"rc": rc, "seconds": wall, "peak_rss_bytes": peak}),
          file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main())
