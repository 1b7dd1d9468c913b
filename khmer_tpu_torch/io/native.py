"""ctypes bindings for the native FASTA/FASTQ parser + 2-bit packer.

Counterpart of khmer_tpu/io/native.py, on the port's own copy of the
parser (csrc/fastx_io.cc), built with the rest of its host C++ by
ops/host.py (a failed build raises). It streams decompressed byte blocks
through it. io/fastx.py is the behavioral reference.
"""

import ctypes

import numpy as np

from khmer_tpu_torch.io.fastx import open_maybe_compressed
from khmer_tpu_torch.ops import host

BLOCK = 8 << 20


def pack_blocks(path):
    """Yield (codes u8 array, meta i64 [n,4], name_blob bytes) blocks.

    meta rows are (seq_code_offset, seq_len, name_offset, name_len);
    offsets reference the codes array / name blob of the same block.
    """
    lib = host.library()
    fh = open_maybe_compressed(path)
    first = fh.read(1)
    if not first:
        return
    is_fastq = first == b"@"
    fn = lib.fastq_pack if is_fastq else lib.fasta_pack

    pending = first
    eof = False
    while not eof:
        block = fh.read(BLOCK)
        if not block:
            eof = True
        data = pending + block
        if not data:
            break
        # FASTA records only terminate at '>' or EOF: hold back the tail
        # unless we're at EOF
        buf = data
        n_bytes = len(buf)
        codes = np.empty(n_bytes, dtype=np.uint8)
        max_rec = max(n_bytes // 8, 16)
        meta = np.empty(4 * max_rec, dtype=np.int64)
        consumed = ctypes.c_longlong(0)
        codes_used = ctypes.c_longlong(0)
        if not eof and not is_fastq:
            # ensure the last (possibly incomplete) record is retried
            cut = buf.rfind(b"\n>")
            if cut < 0:
                pending = data
                continue
            buf = data[: cut + 1]
        n = fn(buf, len(buf), codes.ctypes.data, meta.ctypes.data,
               max_rec, ctypes.byref(consumed), ctypes.byref(codes_used))
        if n < 0:
            raise ValueError("malformed %s input in %s"
                             % ("FASTQ" if is_fastq else "FASTA", path))
        if n > 0:
            yield (codes[: codes_used.value],
                   meta[: 4 * n].reshape(n, 4), buf)
        if is_fastq or eof:
            pending = data[consumed.value:]
        else:
            pending = data[len(buf):]
        if eof and pending.strip():
            raise ValueError("trailing unparsed data in %s" % path)
