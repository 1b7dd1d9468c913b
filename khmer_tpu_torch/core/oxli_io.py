"""OXLI v4 binary format — counterpart of khmer_tpu/core/oxli_io.py,
byte-compatible with khmer and with the JAX package.

Ported: the frame shared by every OXLI file (signature, format version,
gzip-transparent open, header check) and the table files of the ported
sketches (little-endian):

  Countgraph (.ct), Counttable:
                     "OXLI" ver=4 type=1 use_bigcount:u8 ksize:u32
                     n_tables:u8 occupied:u64 {tablesize:u64 bins:u8[n]}*
                     n_bigcounts:u64 {hash:u64 count:u16}*
  Nodegraph (.pt):   "OXLI" ver=4 type=2 ksize:u32 n_tables:u8 occupied:u64
                     {tablesize:u64 bins:u8[n/8+1]}*
  SmallCountgraph:   "OXLI" ver=4 type=7 ksize:u32 n_tables:u8 occupied:u64
                     {tablesize:u64 bins:u8[n/2+1]}* (no bigcount byte or
                     trailer)
  Tagset (.tagset):  "OXLI" ver=4 type=3 ksize:u32 n_tags:u64 density:u32
                     tags:u64[n_tags] (ascending)
  Stoptags:          "OXLI" ver=4 type=4 ksize:u32 n_tags:u64 tags:u64[n]
  Subset (.pmap):    "OXLI" ver=4 type=5 ksize:u32 n_entries:u64
                     {tag:u64 partition:u32}* (written and read in
                     core/partition.py)

Gzip variants are sniffed on read and chosen by a ".gz" file name on
write. The blocked table (private type 127) is written in
core/blocked.py.
"""

import collections
import gzip
import struct

import numpy as np

SAVED_SIGNATURE = b"OXLI"
SAVED_FORMAT_VERSION = 4
SAVED_COUNTING_HT = 1
SAVED_HASHBITS = 2
SAVED_TAGS = 3
SAVED_STOPTAGS = 4
SAVED_SUBSET = 5
SAVED_SMALLCOUNT = 7

_TYPE_NAMES = {
    SAVED_COUNTING_HT: "k-mer count graph",
    SAVED_HASHBITS: "k-mer graph",
    SAVED_TAGS: "tagset",
    SAVED_STOPTAGS: "stoptags",
    SAVED_SUBSET: "subset",
    SAVED_SMALLCOUNT: "small k-mer count graph",
}
_TYPE_OF_KIND = {"byte": SAVED_COUNTING_HT, "nibble": SAVED_SMALLCOUNT,
                 "bit": SAVED_HASHBITS}
# bytes a table of `tablesize` counters takes on disk, by storage kind
_TABLE_BYTES = {"byte": lambda n: n, "nibble": lambda n: n // 2 + 1,
                "bit": lambda n: n // 8 + 1}


def _open_read(path):
    f = open(path, "rb")
    head = f.read(2)
    f.seek(0)
    if head == b"\x1f\x8b":
        return gzip.open(f, "rb")
    return f


def _open_write(path):
    if path.endswith(".gz"):
        return gzip.open(path, "wb")
    return open(path, "wb")


def _check_header(f, expect_type, path, what):
    sig = f.read(4)
    if sig != SAVED_SIGNATURE:
        raise OSError(
            "Incorrect file signature 0x%s while reading %s from %s; "
            "should be OXLI"
            % (sig.hex(), what, path))
    version = f.read(1)[0]
    if version != SAVED_FORMAT_VERSION:
        raise OSError(
            "Incorrect file format version %d while reading %s from %s; "
            "should be %d" % (version, what, path, SAVED_FORMAT_VERSION))
    ht_type = f.read(1)[0]
    if ht_type != expect_type:
        raise OSError(
            "Incorrect file format type %d while reading %s from %s"
            % (ht_type, what, path))
    return ht_type


def save_sketch(sketch, path):
    """Save a sketch of the byte (type 1: Countgraph, Counttable,
    CyclicCounttable), bit (type 2: Nodegraph, Nodetable) or nibble
    layout (type 7: SmallCountgraph, SmallCounttable) in OXLI v4."""
    kind = sketch.storage_kind
    if kind not in _TYPE_OF_KIND:
        raise ValueError("cannot save storage kind %r" % kind)
    raw = sketch.get_raw_tables()
    occupied = sketch.n_occupied()
    with _open_write(path) as f:
        f.write(SAVED_SIGNATURE)
        f.write(bytes([SAVED_FORMAT_VERSION, _TYPE_OF_KIND[kind]]))
        if kind == "byte":
            f.write(bytes([1 if sketch._use_bigcount else 0]))
        f.write(struct.pack("<IBQ", sketch.ksize(), len(sketch._primes),
                            occupied))
        for prime, table in zip(sketch._primes, raw):
            f.write(struct.pack("<Q", prime))
            f.write(table.tobytes())
        if kind == "byte":
            f.write(struct.pack("<Q", len(sketch._bigcounts)))
            for h in sorted(sketch._bigcounts):
                f.write(struct.pack("<QH", h, sketch._bigcounts[h]))


def _read_tables(f, path, kind):
    ksize, n_tables, occupied = struct.unpack("<IBQ", f.read(13))
    primes = []
    tables = []
    for _ in range(n_tables):
        (tablesize,) = struct.unpack("<Q", f.read(8))
        nbytes = _TABLE_BYTES[kind](tablesize)
        data = f.read(nbytes)
        if len(data) != nbytes:
            raise OSError("Error reading from: " + path)
        primes.append(tablesize)
        tables.append(np.frombuffer(data, dtype=np.uint8))
    return ksize, primes, tables, occupied


def load_sketch(cls, path, device="cuda"):
    """Load an OXLI table file of cls's storage kind onto `device`."""
    kind = cls.storage_kind
    if kind not in _TYPE_OF_KIND:
        raise ValueError("cannot load storage kind %r" % kind)
    with _open_read(path) as f:
        _check_header(f, _TYPE_OF_KIND[kind], path,
                      _TYPE_NAMES[_TYPE_OF_KIND[kind]])
        use_bigcount = kind == "byte" and f.read(1)[0] != 0
        ksize, primes, tables, occupied = _read_tables(f, path, kind)
        bigcounts = {}
        if kind == "byte":
            (n_counts,) = struct.unpack("<Q", f.read(8))
            for _ in range(n_counts):
                h, c = struct.unpack("<QH", f.read(10))
                bigcounts[h] = c
    # n_unique is not stored in the format (the reference loses it too);
    # the saved occupied-bins header is kept, not recomputed
    obj = cls.from_numpy_state(ksize, primes, tables, 0, 0, device,
                               bigcounts=bigcounts,
                               use_bigcount=use_bigcount)
    obj._occupied_offset = occupied - obj._count_nonzero_t0()
    return obj


def load_countgraph(path, device="cuda", small=False):
    """Load a Countgraph (.ct, type 1), or with `small` a SmallCountgraph
    (type 7), onto `device`; a file of the other type raises, as in the
    JAX package."""
    from khmer_tpu_torch.core.sketch import Countgraph, SmallCountgraph

    return load_sketch(SmallCountgraph if small else Countgraph, path,
                       device)


def load_nodegraph(path, device="cuda"):
    """Load a Nodegraph (.ng / .pt, type 2) onto `device`."""
    from khmer_tpu_torch.core.sketch import Nodegraph

    return load_sketch(Nodegraph, path, device)


def load_counttable(path, small=False, device="cuda"):
    """Load a Counttable (type 1), or with `small` a SmallCounttable (type
    7), onto `device` (JAX oxli_io.py:187)."""
    from khmer_tpu_torch.core.sketch import Counttable, SmallCounttable

    return load_sketch(SmallCounttable if small else Counttable, path,
                       device)


def load_nodetable(path, device="cuda"):
    """Load a Nodetable (type 2) onto `device` (JAX oxli_io.py:193)."""
    from khmer_tpu_torch.core.sketch import Nodetable

    return load_sketch(Nodetable, path, device)


CgInfo = collections.namedtuple(
    "CgInfo", ["ksize", "n_tables", "table_size", "use_bigcount",
               "version", "ht_type", "n_occupied"])


def extract_countgraph_info(path):
    """CgInfo namedtuple; mirrors the reference
    khmer/__init__.py:134-178 (field order AND table_size rounding)."""
    try:
        with open(path, "rb") as f:
            sig = f.read(4)
            version = f.read(1)[0]
            ht_type = f.read(1)[0]
            if ht_type != SAVED_SMALLCOUNT:
                use_bigcount = f.read(1)[0]
            else:
                use_bigcount = None
            ksize, n_tables = struct.unpack("<IB", f.read(5))
            (occupied,) = struct.unpack("<Q", f.read(8))
            (tablesize,) = struct.unpack("<Q", f.read(8))
        if sig != SAVED_SIGNATURE:
            raise ValueError("Count graph file '{}' is missing file type "
                             "signature. ".format(path) + str(sig))
    except ValueError:
        raise
    except Exception:
        raise ValueError("Count graph file '{}' is corrupt ".format(path))
    return CgInfo(ksize, n_tables, round(tablesize, -2), use_bigcount,
                  version, ht_type, occupied)


def save_tagset(path, ksize, tags, tag_density):
    """reference: Hashgraph::save_tagset (hashgraph.cc:55-88)."""
    arr = np.array(sorted(tags), dtype=np.uint64)
    with _open_write(path) as f:
        f.write(SAVED_SIGNATURE)
        f.write(bytes([SAVED_FORMAT_VERSION, SAVED_TAGS]))
        f.write(struct.pack("<IQI", ksize, len(arr), tag_density))
        f.write(arr.tobytes())


def load_tagset(path, expect_ksize=None):
    """Returns (tags set, tag_density)."""
    with _open_read(path) as f:
        _check_header(f, SAVED_TAGS, path, "tagset")
        (ksize,) = struct.unpack("<I", f.read(4))
        if expect_ksize is not None and ksize != expect_ksize:
            raise OSError(
                "Incorrect k-mer size %d while reading tagset from %s"
                % (ksize, path))
        n, density = struct.unpack("<QI", f.read(12))
        data = f.read(8 * n)
        if len(data) != 8 * n:
            raise OSError("Error reading data from: " + path)
        tags = set(int(x) for x in np.frombuffer(data, dtype=np.uint64))
        return tags, density


def save_stoptags(path, ksize, stop_tags):
    """Write the stop tags as a type-4 file, ascending (reference
    Hashgraph::save_stop_tags, hashgraph.cc:572-600)."""
    arr = np.array(sorted(stop_tags), dtype=np.uint64)
    with _open_write(path) as f:
        f.write(SAVED_SIGNATURE)
        f.write(bytes([SAVED_FORMAT_VERSION, SAVED_STOPTAGS]))
        f.write(struct.pack("<IQ", ksize, len(arr)))
        f.write(arr.tobytes())


def load_stoptags(path, expect_ksize=None):
    """The stop tags of a stoptags file (type 4), as a set."""
    with _open_read(path) as f:
        _check_header(f, SAVED_STOPTAGS, path, "stoptags")
        (ksize,) = struct.unpack("<I", f.read(4))
        if expect_ksize is not None and ksize != expect_ksize:
            raise OSError(
                "Incorrect k-mer size %d while reading stoptags from %s"
                % (ksize, path))
        (n,) = struct.unpack("<Q", f.read(8))
        data = f.read(8 * n)
        return set(int(x) for x in np.frombuffer(data, dtype=np.uint64))
