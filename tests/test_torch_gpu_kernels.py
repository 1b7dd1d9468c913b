"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA GPU and skip without one. They import no JAX,
so they also run on a machine without it; there, from the repo root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu_kernels.py

Equality is exact: the state is integer.
"""

import numpy as np
import pytest
import torch

from khmer_tpu_torch.core import blocked as B
from khmer_tpu_torch.core import sketch_kernels as K
from khmer_tpu_torch.core.sketch import Countgraph
from khmer_tpu_torch.scripts import (countgraph_cases, diginorm_cases,
                                     family_cases, graph_cases, nibble_cases,
                                     partition_cases, pertable_cases,
                                     trim_cases)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU; the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _chunks(seed, nblocks, n_chunks, m, pool):
    """Seeded chunks of full-range u64 hashes drawn from a pool of `pool`
    values (duplicates when pool < m), each with a zero-padded tail."""
    rng = np.random.default_rng(seed)
    values = rng.integers(0, 2**64, pool, dtype=np.uint64)
    out = []
    for c in range(n_chunks):
        h = values[rng.integers(0, pool, m)]
        nvalid = m - 97 * c
        h[nvalid:] = 0
        out.append((h, nvalid))
    return out


@pytest.mark.parametrize("nblocks,n_chunks,m,pool", [
    (7, 3, 30000, 1 << 20),      # every lane driven past 255
    (101, 4, 8192, 64),          # heavy in-chunk duplicates
    (100003, 3, 65536, 1 << 30),
    (101, 2, 1 << 20, 1),        # one hash x 2^20 events, through 255
    (7, 2, 1 << 20, 1 << 30),    # a full chunk on 896 counters
])
def test_blocked_update_and_gather_match_plain(cuda_device, nblocks,
                                               n_chunks, m, pool):
    dev = cuda_device
    tab_k = torch.zeros((nblocks, B.LANES), dtype=torch.uint8, device=dev)
    tab_p = tab_k.clone()
    nu_k = torch.zeros(1, dtype=torch.int64, device=dev)
    nu_p = nu_k.clone()
    scratch = None
    for h, nvalid in _chunks(nblocks, nblocks, n_chunks, m, pool):
        hd = torch.from_numpy(h.view(np.int64)).to(dev)
        scratch = K.update_scratch(scratch, nvalid, B.SUB, dev)
        fk = B.blocked_update_cuda(tab_k, hd, nvalid, nu_k, scratch)
        fp = B.blocked_update_plain(nblocks, (tab_p,), nu_p, hd, nvalid)
        assert torch.equal(tab_k, tab_p)
        assert torch.equal(fk, fp)
        assert int(nu_k) == int(nu_p)
        ck = B.blocked_gather_cuda(tab_k, hd)
        cp = B.gather_counts_plain(nblocks, (tab_p,), hd)
        assert torch.equal(ck, cp)


def _crowded(seed, n, width, modulus):
    """n distinct-ish hashes whose counters all fall in the first `width`
    residues of `modulus`: far more distinct counters than one bucket's
    map holds, so the kernel must split the bucket."""
    rng = np.random.default_rng(seed)
    low = rng.integers(0, width, n, dtype=np.uint64)
    k = rng.integers(0, 2**64 // modulus - 1, n, dtype=np.uint64)
    return low + k * np.uint64(modulus)


def test_update_kernels_split_crowded_buckets(cuda_device):
    """Every event of a chunk on a narrow counter range: tens of thousands
    of distinct counters in a few buckets, in the blocked and the byte
    layout, each checked against its plain version."""
    dev = cuda_device
    n = 1 << 16
    nb = 100003
    tab_k = torch.zeros((nb, B.LANES), dtype=torch.uint8, device=dev)
    tab_p = tab_k.clone()
    nu_k = torch.zeros(1, dtype=torch.int64, device=dev)
    nu_p = nu_k.clone()
    for seed in range(2):
        hd = torch.from_numpy(_crowded(seed, n, 400, nb).view(np.int64)
                              ).to(dev)
        fk = B.blocked_update_cuda(tab_k, hd, n, nu_k)
        fp = B.blocked_update_plain(nb, (tab_p,), nu_p, hd, n)
        assert torch.equal(tab_k, tab_p) and torch.equal(fk, fp)
        assert int(nu_k) == int(nu_p)
    primes = (1000003, 999983, 999979, 999961)
    flat_k = torch.zeros(K.byte_flat_size(primes), dtype=torch.uint8,
                         device=dev)
    flat_p = flat_k.clone()
    nu_k.zero_()
    nu_p.zero_()
    for seed in range(2):
        # h < 20000 < every prime: counter offset_t + h in each table
        h = np.random.default_rng(seed).integers(0, 20000, n,
                                                 dtype=np.uint64)
        hd = torch.from_numpy(h.view(np.int64)).to(dev)
        rk = K.byte_update_cuda(primes, flat_k, nu_k, hd, n,
                                with_bigcount=True)
        rp = K.byte_update_plain(primes, flat_p, nu_p, hd, n,
                                 with_bigcount=True)
        assert torch.equal(flat_k, flat_p)
        assert int(nu_k) == int(nu_p)
        assert int(rk[2][0]) == int(rp[2][0])


def test_dispatch_launches_kernels_on_cuda_tensors(cuda_device):
    dev = cuda_device
    cg = B.BlockedCountgraph(20, 1e5, 4, device=dev)
    before = (B.blocked_update_cuda.launches,
              B.blocked_gather_cuda.launches)
    cg.count("ACGTACGTACGTACGTACGT")
    assert cg.get("ACGTACGTACGTACGTACGT") == 1
    assert B.blocked_update_cuda.launches == before[0] + 1
    assert B.blocked_gather_cuda.launches == before[1] + 1


@pytest.mark.parametrize("primes,n_chunks,m,pool", [
    ((7, 11, 13), 3, 30000, 1 << 20),          # every counter past 255
    ((997, 991, 983), 4, 8192, 64),            # heavy in-chunk duplicates
    ((1000003, 999983, 999979, 999961), 3, 65536, 1 << 30),
    # one hash x 2^20 events: bigcount through 255 in one chunk
    ((1000003, 999983, 999979, 999961), 2, 1 << 20, 1),
    ((7, 11, 13), 2, 1 << 20, 1 << 30),        # a full chunk on tiny primes
])
def test_byte_update_and_gather_match_plain(cuda_device, primes, n_chunks,
                                            m, pool):
    dev = cuda_device
    flat_k = torch.zeros(K.byte_flat_size(primes), dtype=torch.uint8,
                         device=dev)
    flat_p = flat_k.clone()
    nu_k = torch.zeros(1, dtype=torch.int64, device=dev)
    nu_p = nu_k.clone()
    scratch = None
    for h, nvalid in _chunks(len(primes), sum(primes), n_chunks, m, pool):
        hd = torch.from_numpy(h.view(np.int64)).to(dev)
        scratch = K.update_scratch(scratch, nvalid, len(primes), dev)
        rk = K.byte_update_cuda(primes, flat_k, nu_k, hd, nvalid,
                                with_bigcount=True, scratch=scratch)
        rp = K.byte_update_plain(primes, flat_p, nu_p, hd, nvalid,
                                 with_bigcount=True)
        assert torch.equal(flat_k, flat_p)
        assert int(nu_k) == int(nu_p)
        nk = int(rk[2][0])
        assert nk == int(rp[2][0])
        assert K.bigcount_triggers(rk[0][:nk].cpu().numpy().view(np.uint64),
                                   rk[1][:nk].cpu().numpy()) == \
            K.bigcount_triggers(rp[0].cpu().numpy().view(np.uint64),
                                rp[1].cpu().numpy())
        assert torch.equal(K.byte_gather_cuda(primes, flat_k, hd),
                           K.byte_gather_plain(primes, flat_p, hd))


@pytest.mark.parametrize("m,nbins", [(1 << 21, 1 << 17), (600000, 65537),
                                     (5000, 3)])
def test_histogram_add_matches_plain(cuda_device, m, nbins):
    rng = np.random.default_rng(m)
    idx = rng.integers(-5, nbins + 5, m)
    idx[: m // 2] = rng.integers(0, 4, m // 2)  # hot bins
    # wrapped, as JAX .at[].add wraps [-nbins, 0), and dropped below it
    idx[m // 4: m // 4 + 3000] = rng.integers(-nbins - 5, 0, 3000)
    idx[m // 2: m // 2 + 1000] = nbins - 1       # the top bin
    idx_d = torch.from_numpy(idx).to(cuda_device)
    start = torch.from_numpy(rng.integers(0, 9, nbins)).to(cuda_device)
    got = K.histogram_add_cuda(start.clone(), idx_d)
    want = K.histogram_add_plain(start.clone(), idx_d)
    assert torch.equal(got, want)


@pytest.mark.parametrize("sink", ["past the last bin", "the top bin"])
def test_histogram_add_abundance_shape_matches_plain(cuda_device, sink):
    """abundance-dist's batch: 65,536 bins, three quarters of 1,785,856
    indices past the last bin (the slots it does not count; dropped) or on
    the top bin, counts 1..255, wrapped negatives, into a nonzero
    histogram, twice (accumulated)."""
    dev = cuda_device
    nbins = K.ABUND_BINS
    rng = np.random.default_rng(nbins)
    m = 1_785_856
    idx = np.full(m, nbins if sink == "past the last bin" else nbins - 1,
                  dtype=np.int64)
    live = rng.choice(m, m // 4, replace=False)
    idx[live] = np.minimum(rng.geometric(0.6, len(live)), 255)
    idx[live[:3000]] = -rng.integers(1, nbins + 1, 3000)
    idx_d = torch.from_numpy(idx).to(dev)
    start = torch.from_numpy(rng.integers(0, 1 << 40, nbins)).to(dev)
    got, want = start.clone(), start.clone()
    for _ in range(2):
        K.histogram_add_cuda(got, idx_d)
        K.histogram_add_plain(want, idx_d)
        assert torch.equal(got, want)


@pytest.mark.parametrize("nbins", [3, 256, 257, 65_537, 1 << 17, 10**6])
def test_histogram_add_private_bin_edges_match_plain(cuda_device, nbins):
    """Indices on the edges of the bins each block counts in shared memory
    ([0, HIST_LOW_BINS)) and of the bins added in global memory (up to the
    top bin), crowded (every warp sees the same few bins), their wrapped
    negatives, and out-of-range indices on both sides."""
    dev = cuda_device
    low = K.HIST_LOW_BINS
    edges = {0, 1, low - 2, low - 1, low, low + 1, nbins - 2, nbins - 1}
    edges = np.asarray(sorted(b for b in edges if 0 <= b < nbins),
                       dtype=np.int64)
    rng = np.random.default_rng(nbins)
    idx = np.concatenate([rng.choice(edges, 1 << 20), edges - nbins,
                          rng.integers(-2 * nbins, 2 * nbins, 1 << 16)])
    rng.shuffle(idx)
    idx_d = torch.from_numpy(idx).to(dev)
    start = torch.from_numpy(rng.integers(0, 9, nbins)).to(dev)
    got = K.histogram_add_cuda(start.clone(), idx_d)
    want = K.histogram_add_plain(start.clone(), idx_d)
    assert torch.equal(got, want)


def test_histogram_add_splits_launches_under_a_lowered_limit(cuda_device,
                                                             monkeypatch):
    dev = cuda_device
    monkeypatch.setattr(K, "HIST_LAUNCH_LIMIT", 100_000)
    rng = np.random.default_rng(5)
    idx = rng.integers(-70_000, 70_000, 345_678)
    idx[::3] = 65_536
    idx_d = torch.from_numpy(idx).to(dev)
    before = K.histogram_add_cuda.launches
    got = K.histogram_add_cuda(torch.ones(65_537, dtype=torch.int64,
                                          device=dev), idx_d)
    assert K.histogram_add_cuda.launches == before + 4
    want = K.histogram_add_plain(torch.ones(65_537, dtype=torch.int64,
                                            device=dev), idx_d)
    assert torch.equal(got, want)
    # an offset view: each launch starts mid-tensor
    got = K.histogram_add_cuda(torch.zeros_like(got), idx_d[7:])
    want = K.histogram_add_plain(torch.zeros_like(want), idx_d[7:])
    assert torch.equal(got, want)


def test_raw_stream_handle_is_the_current_streams(cuda_device):
    """The wrappers pass sketch_kernels._stream, a private torch call, as
    the stream of every launch: it must name torch's current stream, on
    the default stream and inside another."""
    dev = cuda_device
    assert K._stream(dev) == torch.cuda.current_stream(dev).cuda_stream
    side = torch.cuda.Stream(dev)
    with torch.cuda.stream(side):
        assert K._stream(dev) == side.cuda_stream != 0


@pytest.mark.parametrize("nblocks", [1_562_471, 16_777_213, 7])
def test_blocked_gather_reduction_edges_match_plain(cuda_device, nblocks):
    """Kernel 2 reduces h % nblocks by the reciprocal; on random tables of
    the config-1 (200 MB) and the largest (2.15 GB) block counts it equals
    the plain version's `%` on the reduction's edge cases, on an aligned
    tensor, on views that start one and three hashes in (8-byte, not
    16-byte aligned) and on odd lengths."""
    from khmer_tpu_torch.scripts.byte_gather_bench import reduction_edges

    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(nblocks)
    table = torch.randint(0, 256, (nblocks, B.LANES), dtype=torch.uint8,
                          device=dev, generator=gen)
    hd = torch.from_numpy(reduction_edges((nblocks,)).view(np.int64)).to(dev)
    for h in (hd, hd[1:], hd[3:-3], hd[:13]):
        assert torch.equal(B.blocked_gather_cuda(table, h),
                           B.gather_counts_plain(nblocks, (table,), h))
    del table
    torch.cuda.empty_cache()


def test_proto_rmw_matches_plain(cuda_device):
    """The script's correctness case, three passes on one table, with the
    events' scratch kept between calls: no winner image to keep."""
    from khmer_tpu_torch.scripts import pallas_proto

    dev = cuda_device
    bids, offs, table = pallas_proto.correctness_case(
        np.random.default_rng(0))
    bids_d = torch.from_numpy(bids).to(dev)
    offs_d = torch.from_numpy(pallas_proto.pack_offs(offs)).to(dev)
    tab_k = torch.from_numpy(table).to(dev)
    tab_p = tab_k.clone()
    scratch = K.update_scratch(None, len(bids), B.SUB, dev)
    for _ in range(3):
        nk = B.proto_rmw_cuda(bids_d, offs_d, tab_k, scratch)
        np_ = B.proto_rmw_plain(bids_d, offs_d, tab_p)
        assert int(nk) == int(np_)
        assert torch.equal(tab_k, tab_p)


def _proto_cases():
    from khmer_tpu_torch.scripts import pallas_proto

    return {c[0]: c for c in pallas_proto.adversarial_cases(
        np.random.default_rng(20261019))}


@pytest.mark.parametrize("name", ["one-event-x2^20", "all-on-7-blocks",
                                  "repeats-invalid-saturate",
                                  "crowded-bucket"])
def test_proto_rmw_adversarial_cases_match_plain(cuda_device, name):
    """One event x 2^20, 2^20 events on 7 blocks, repeated lanes with
    invalid ids and saturation, and a crowded bucket that must split."""
    dev = cuda_device
    _, bids, offs, table, passes = _proto_cases()[name]
    bids_d = torch.from_numpy(bids).to(dev)
    offs_d = torch.from_numpy(offs).to(dev)
    tab_k = torch.from_numpy(table).to(dev)
    tab_p = tab_k.clone()
    for _ in range(passes):
        nk = B.proto_rmw_cuda(bids_d, offs_d, tab_k)
        np_ = B.proto_rmw_plain(bids_d, offs_d, tab_p)
        assert int(nk) == int(np_)
        assert torch.equal(tab_k, tab_p)


def test_proto_rmw_dispatch_runs_on_the_card(cuda_device):
    """proto_rmw(bids, offs, table), called as the JAX script calls its
    kernel, launches kernel D on a CUDA table (it once needed a winner
    image and raised without one)."""
    dev = cuda_device
    bids = torch.tensor([0, 0, 1, -1], dtype=torch.int32, device=dev)
    offs = torch.tensor([5 | 40 << 8 | 70 << 16 | 100 << 24] * 4,
                        dtype=torch.int32, device=dev)
    tab = torch.zeros((2, B.LANES), dtype=torch.uint8, device=dev)
    before = B.proto_rmw_cuda.launches
    assert int(B.proto_rmw(bids, offs, tab)) == 2
    assert B.proto_rmw_cuda.launches == before + 1
    assert tab[0, [5, 40, 70, 100]].tolist() == [2, 2, 2, 2]
    assert tab[1, [5, 40, 70, 100]].tolist() == [1, 1, 1, 1]
    assert int(tab.sum()) == 12


@pytest.mark.parametrize("name", ["config-1", "-x 1e9 -N 4",
                                  "-x 5e9 -N 4"])
def test_byte_gather_reduction_edges_match_plain(cuda_device, name):
    """Kernel B reduces each hash by the prime's reciprocal; on random
    tables of each size (0.2, 4 and 20 GB) it equals the plain version's
    `%` on the reduction's edge cases, through the paired loads (aligned)
    and the single ones (a view one hash in, odd length)."""
    from khmer_tpu_torch.scripts.byte_gather_bench import (PRIME_SETS,
                                                           reduction_edges)

    dev = cuda_device
    primes = PRIME_SETS[name]
    gen = torch.Generator(device=dev).manual_seed(len(name))
    flat = torch.randint(0, 256, (K.byte_flat_size(primes),),
                         dtype=torch.uint8, device=dev, generator=gen)
    hd = torch.from_numpy(reduction_edges(primes).view(np.int64)).to(dev)
    for h in (hd, hd[1:]):
        assert torch.equal(K.byte_gather_cuda(primes, flat, h),
                           K.byte_gather_plain(primes, flat, h))
    del flat
    torch.cuda.empty_cache()


def test_countgraph_dispatch_launches_kernels_on_cuda(cuda_device):
    cg = Countgraph(20, 1e5, 4, device=cuda_device)
    cg.set_use_bigcount(True)
    before = (K.byte_update_cuda.launches, K.byte_gather_cuda.launches)
    for _ in range(300):
        cg.count("ACGTACGTACGTACGTACGT")
    assert cg.get("ACGTACGTACGTACGTACGT") == 300
    assert K.byte_update_cuda.launches == before[0] + 300
    assert K.byte_gather_cuda.launches == before[1] + 1


@pytest.mark.parametrize("name", list(diginorm_cases.CASES))
def test_diginorm_kernels_match_plain(cuda_device, name):
    """Kernels E and F against their plain versions on the windows of
    scripts/diginorm_cases.py: rejections, keep flags, tables, n_unique
    and candidate counts all equal."""
    got = diginorm_cases.check_case(name, cuda_device)
    assert got["med"] == 0 and got["scan"] == 0, got
    if name == "all-rejected":
        assert got["rejected"] == got["bundles"] and got["kept after E"] == 0
    if name == "none-rejected":
        assert got["rejected"] == 0


def test_scan_normalizer_launches_kernels_on_cuda(cuda_device):
    """ScanNormalizer on a countgraph on the card runs kernel E and kernel
    F once a window, and keeps what the CPU engine keeps, with the same
    tables and n_unique."""
    from khmer_tpu_torch.core.diginorm_scan import ScanNormalizer
    from khmer_tpu_torch.io.fastx import Record

    rng = np.random.default_rng(9)
    genome = "".join(rng.choice(list("ACGT"), 3000))
    bundles = []
    for i in range(600):
        s = int(rng.integers(0, 2900))
        r = Record("r%d" % i, genome[s:s + int(rng.integers(10, 100))])
        r.cleaned_seq = r.sequence
        bundles.append([r])
    engines = [ScanNormalizer(Countgraph(20, 5e3, 3, device=d), 5)
               for d in (cuda_device, "cpu")]
    before = (K.diginorm_med_cuda.launches, K.diginorm_scan_cuda.launches)
    for s in range(0, 600, 256):
        got, want = (e.process_window(bundles[s:s + 256]) for e in engines)
        assert [len(x) for x in got] == [len(x) for x in want]
    assert K.diginorm_med_cuda.launches == before[0] + 3
    assert K.diginorm_scan_cuda.launches == before[1] + 3
    cg, ref = (e.graph for e in engines)
    assert cg.n_unique_kmers() == ref.n_unique_kmers()
    assert torch.equal(cg.tables.flat.cpu(), ref.tables.flat)
    assert int(engines[0].candidates) == int(engines[1].candidates) > 0


def test_scan_normalizer_long_reads_on_cuda(cuda_device):
    """Windows holding reads of 5,000 to 15,000 bases run on the card in
    runs (row_runs), kernels E and F once a run, kernel F keeping the
    15,000-base run's hashes in a device buffer; the card's engine keeps
    what the CPU's does, with the same tables, n_unique and candidates."""
    got = diginorm_cases.check_long_window(cuda_device)
    assert got["mismatches"] == 0, got
    assert got["runs"] == 18 and got["launches"] == (18, 18), got
    assert 0 < got["kept"] < 600


@pytest.mark.parametrize("name", list(trim_cases.CASES))
def test_trim_kernels_match_plain(cuda_device, name):
    """Kernels G and H against their plain versions on the windows of
    scripts/trim_cases.py: branches, trim positions, tables and n_unique
    (G whole, and its walk), states, branches, trim positions and the set
    (G's mark), states (G's probe); trim positions and windows at
    coverage, with and without a bigcount table (H). The pinned windows
    move what they must: trim positions, branches, and live bundles across
    groups with some alone."""
    got = trim_cases.check_case(name, cuda_device)
    assert got["scan"] == 0 and got["counts"] == 0, got
    assert got["mark"] == got["probe"] == got["walk"] == 0, got
    if name == "consume-lifts-trim":
        assert got["lifted"] >= 30, got
    if name in ("consume-lifts-digi", "consume-lifts-candidate"):
        assert got["moved"] >= 30, got
    if name == "groups-and-lone":
        assert 0 < got["alone"] < got["groups"] < got["live"], got
        assert got["live"] < got["bundles"], got
    if name == "C=300-Z=300":
        assert got["big entries"] > 0 and got["big moved"] > 0, got


@pytest.mark.parametrize("name", list(trim_cases.COUNT_CASES))
def test_read_counts_count_cases_match_plain(cuda_device, name):
    """Kernel H against read_counts_plain on the rows of
    trim_cases.COUNT_CASES: one row of 1,000,000 codes, a long-read run of
    row_runs, rows of L % 16 != 0, short reads mixed with long ones, a
    tile's tail of rows, k 1 and 32, counters at 254-255 with a bigcount
    table; at every threshold pair of the case."""
    got = trim_cases.check_counts_case(name, cuda_device)
    assert got["mismatches"] == 0, got
    assert got["trim 0"] > 0 and got["untrimmed"] > 0, got


def test_read_counts_spreads_a_long_row_over_blocks(cuda_device):
    """Rows of several segments, launched twice on the same inputs: the
    same answers each time (each call's scratch is cleared on the stream
    before its launch), equal to the plain version's, and one launch
    counted a call."""
    primes, k, codes, lengths, fill, _, _ = trim_cases.make_count_case(
        "L=5003 (L % 16 != 0)")
    c = torch.from_numpy(codes).to(cuda_device)
    n = torch.from_numpy(lengths).to(cuda_device)
    flat = torch.from_numpy(fill).to(cuda_device)
    assert K.read_plan(c.shape[1], k)["segs"] > 1
    before = K.read_counts_cuda.launches
    first = K.read_counts_cuda(primes, k, 2, 20, flat, c, n)
    again = K.read_counts_cuda(primes, k, 2, 20, flat, c, n)
    want = K.read_counts_plain(primes, k, 2, 20, flat, c, n)
    assert all(torch.equal(a, b) for a, b in zip(first, want))
    assert all(torch.equal(a, b) for a, b in zip(again, want))
    assert K.read_counts_cuda.launches == before + 2


def test_scan_trimmer_long_reads_on_cuda(cuda_device):
    """ScanTrimmerState on the card against the CPU's over windows holding
    reads of 5,000 to 15,000 bases: kernel G once a run of row_runs, the
    same branches, trim positions, tables, n_unique and counts of
    candidates, live bundles and groups; each of G's three launches once a
    run."""
    got = trim_cases.check_long_window(cuda_device)
    assert got["mismatches"] == 0, got
    assert got["runs"] == 18 and got["launches"] == (18, 18, 18), got
    assert got["consumed"] > 0


def test_trim_entry_points_launch_kernels_on_cuda(cuda_device):
    """ScanTrimmerState, read_counts_window and the Countgraph's sequence
    queries on the card launch kernels G and H and answer as the CPU's
    plain versions do."""
    from khmer_tpu_torch.core.diginorm_scan import (ScanTrimmerState,
                                                    read_counts_window)
    from khmer_tpu_torch.io.fastx import Record

    rng = np.random.default_rng(19)
    genome = "".join(rng.choice(list("ACGT"), 3000))
    recs = []
    for i in range(700):
        s = int(rng.integers(0, 2900))
        recs.append(Record("r%d" % i, genome[s:s + int(rng.integers(10,
                                                                    100))]))
    engines = [ScanTrimmerState(Countgraph(20, 5e3, 3, device=d), 2, 4)
               for d in (cuda_device, "cpu")]
    launchers = (K.trim_mark_cuda, K.trim_probe_cuda, K.trim_walk_cuda)
    before = [f.launches for f in launchers] + [K.read_counts_cuda.launches]
    for s in range(0, 700, 256):
        window = [[r] for r in recs[s:s + 256]]
        (bk, tk), (bp, tp) = (e.process_window(window) for e in engines)
        assert np.array_equal(bk, bp) and np.array_equal(tk, tp)
    assert [f.launches for f in launchers] == [b + 3 for b in before[:3]]
    cg, ref = (e.graph for e in engines)
    assert cg.n_unique_kmers() == ref.n_unique_kmers()
    assert torch.equal(cg.tables.flat.cpu(), ref.tables.flat)
    got = read_counts_window(cg, recs, 2, 3)
    want = read_counts_window(ref, recs, 2, 3)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    for r in recs[:20]:
        if len(r.sequence) >= 20:
            assert cg.median_at_least(r.sequence, 3) == \
                ref.median_at_least(r.sequence, 3)
        assert cg.trim_on_abundance(r.sequence, 2) == \
            ref.trim_on_abundance(r.sequence, 2)
    assert K.read_counts_cuda.launches > before[3] + 1


@pytest.mark.parametrize("name", list(graph_cases.BIT_CASES))
def test_bit_update_matches_plain(cuda_device, name):
    """Kernel J against its plain version: flags, n_unique and tables."""
    assert graph_cases.check_bit_case(name, cuda_device) == 0
    torch.cuda.empty_cache()


@pytest.mark.parametrize("name", list(graph_cases.HLL_CASES))
def test_hll_add_matches_plain(cuda_device, name):
    """Kernel K against its plain version: the registers."""
    assert graph_cases.check_hll_case(name, cuda_device) == 0


def test_graph_entry_points_launch_kernels_on_cuda(cuda_device, tmp_path,
                                                  monkeypatch):
    """HLLCounter, the Nodegraph's consumes and the abundance histogram on
    the card launch kernels K and J and answer as on the CPU."""
    import os

    from khmer_tpu_torch.core import pipeline
    from khmer_tpu_torch.core.hll import HLLCounter
    from khmer_tpu_torch.core.sketch import Nodegraph
    from khmer_tpu_torch.io.fastx import FastxParser

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    genomes = os.path.join(repo, "data", "stamps-genomes.fa")
    before = (K.hll_add_cuda.launches, K.bit_update_cuda.launches)
    monkeypatch.setattr(pipeline, "DENSE_CHUNK", 1000)
    got = {}
    for dev in (cuda_device, "cpu"):
        h = HLLCounter(0.01, 20, device=dev)
        h2 = HLLCounter(0.01, 20, device=dev)
        h2.consume_seqfile(FastxParser(genomes))
        ng = Nodegraph(20, 2.5e7, 4, device=dev)
        plain = Nodegraph(20, 2.5e7, 4, device=dev)
        got[str(dev)] = (h.consume_seqfile(genomes), h.counters,
                         h2.counters, ng.consume_seqfile_and_tag(
                             genomes), ng.all_tags,
                         ng.tables.flat.cpu(), ng.n_unique_kmers(),
                         plain.consume_seqfile(genomes),
                         plain.n_unique_kmers())
    k, c = got[str(cuda_device)], got["cpu"]
    assert k[:5] == c[:5] and torch.equal(k[5], c[5]) and k[6:] == c[6:]
    assert K.hll_add_cuda.launches >= before[0] + 2
    assert K.bit_update_cuda.launches > before[1] + 8
    cg = Countgraph(20, 1e5, 4, device=cuda_device)
    cg.consume_seqfile(genomes)
    tracking = Nodegraph(20, 1, 1, primes=cg.hashsizes(),
                         device=cuda_device)
    n = K.bit_update_cuda.launches
    hist = cg.abundance_distribution(genomes, tracking)
    assert K.bit_update_cuda.launches > n
    ref = Countgraph(20, 1e5, 4, device="cpu")
    ref.consume_seqfile(genomes)
    assert hist == ref.abundance_distribution(
        genomes, Nodegraph(20, 1, 1, primes=ref.hashsizes(), device="cpu"))


@pytest.mark.parametrize("name", list(partition_cases.NEIGHBOR_CASES))
def test_neighbors_match_plain(cuda_device, name):
    """Kernel L's probe and gather against their plain versions."""
    assert partition_cases.check_neighbor_case(name, cuda_device) == 0


def test_partition_on_cuda_launches_neighbors(cuda_device, tmp_path):
    """A Nodegraph on the card partitions (with and without the cut of
    big traversals) and annotates as on the CPU, its walk probing through
    kernel L, and its bit gather going through L's gather mode."""
    import os

    from khmer_tpu_torch.core.sketch import Nodegraph

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    genomes = os.path.join(repo, "data", "stamps-genomes.fa")
    got = {}
    for dev in (cuda_device, "cpu"):
        ng = Nodegraph(20, 2.5e7, 4, device=dev)
        ng._set_tag_density(10)
        ng.consume_seqfile_and_tag(genomes)
        before = (K.neighbors_cuda.launches, K.bit_gather_cuda.launches)
        out = []
        for stop_big in (True, False):
            subset = ng.do_subset_partition(0, 0, True, stop_big)
            ids = {t: subset.get_partition_id(t) for t in ng.all_tags}
            part = str(tmp_path / ("%s.part" % dev))
            n = subset.output_partitioned_file(genomes, part)
            with open(part, "rb") as f:
                out.append((ids, subset.count_partitions(), n, f.read()))
        probe = np.array(sorted(ng.all_tags), np.uint64)
        out.append(ng.get_counts_for_hashes(probe).tolist())
        out.append(ng.get_counts_for_hashes(probe + np.uint64(1)).tolist())
        got[str(dev)] = out
        if dev == cuda_device:
            assert K.neighbors_cuda.launches > before[0]
            assert K.bit_gather_cuda.launches > before[1]
    assert got[str(cuda_device)] == got["cpu"]


@pytest.mark.parametrize("name", list(pertable_cases.PERTABLE_CASES))
def test_byte_pertable_matches_plain(cuda_device, name):
    """Kernel M against its plain version."""
    assert pertable_cases.check_pertable_case(name, cuda_device) == 0


def test_repartition_on_cuda_launches_pertable(cuda_device):
    """The knot pipeline's repartition on the card gives the CPU's stop
    tags, small tags and counting tables, its excursions probed by kernel
    L, their counters gathered by kernel M and the adds committed by
    kernel A."""
    import os

    from khmer_tpu_torch.core.sketch import Nodegraph

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    reads = os.path.join(repo, "data", "stamps-reads.fa.gz")
    got = {}
    for dev in (cuda_device, "cpu"):
        ng = Nodegraph(20, 12.5e6, 4, device=dev)
        ng.consume_seqfile_and_tag(reads)
        ng.all_tags = set(sorted(ng.all_tags)[:2000])
        counting = Countgraph(20, 2e6, 4, device=dev)
        before = (K.neighbors_cuda.launches, K.byte_pertable_cuda.launches,
                  K.byte_update_cuda.launches)
        subset = ng.do_subset_partition(0, 0)
        size = ng.repartition_largest_partition(counting, 40, 200, 5,
                                                subs=subset)
        got[str(dev)] = (size, sorted(ng.stop_tags),
                         sorted(ng.repart_small_tags),
                         {t: subset.get_partition_id(t) for t in ng.all_tags},
                         [t.cpu().numpy().tobytes() for t in counting.tables])
        if dev == cuda_device:
            assert K.neighbors_cuda.launches > before[0]
            assert K.byte_pertable_cuda.launches > before[1]
            assert K.byte_update_cuda.launches > before[2]
    assert got[str(cuda_device)] == got["cpu"]
    assert got["cpu"][1]


# -- the Countgraph graph: kernel N, A's new flags, H's counts mode ----------


@pytest.mark.parametrize("name", list(countgraph_cases.NBR_CASES))
def test_byte_neighbors_match_plain(cuda_device, name):
    """Kernel N against its plain version without a band and at every
    band."""
    assert countgraph_cases.check_nbr_case(name, cuda_device) == 0


@pytest.mark.parametrize("name", list(countgraph_cases.FLAG_CASES))
def test_byte_update_flags_match_plain(cuda_device, name):
    """Kernel A's per-event new flags, tables, n_unique and bigcount
    triggers against its plain version."""
    assert countgraph_cases.check_flag_case(name, cuda_device) == 0


@pytest.mark.parametrize("name", list(trim_cases.COUNT_CASES))
def test_read_window_counts_match_plain(cuda_device, name):
    """Kernel H's counts mode against its plain version."""
    assert countgraph_cases.check_counts_case(name, cuda_device) == 0


def _n_launches():
    """Kernel N's launches in both its modes."""
    return (K.byte_neighbors_cuda.launches
            + K.byte_neighbors_cuda.small_launches)


def test_countgraph_graph_on_cuda_launches_kernels(cuda_device, tmp_path):
    """A Countgraph on the card tags as it consumes, partitions with and
    without an abundance band, sweeps, gives its k-mer counts and rebuilds
    from a partitioned FASTA as on the CPU, through kernels A (with its
    flags), N and H's counts mode."""
    import os

    from khmer_tpu_torch.io.fastx import FastxParser

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    reads = os.path.join(repo, "data", "stamps-reads.fa.gz")
    head = str(tmp_path / "head.fa")
    with open(head, "w") as f:
        for i, rec in enumerate(FastxParser(reads)):
            if i == 3000:
                break
            f.write(">%s\n%s\n" % (rec.name, rec.sequence))
    seqs = [rec.sequence for _, rec in zip(range(100), FastxParser(head))]
    got = {}
    for dev in (cuda_device, "cpu"):
        cg = Countgraph(20, 1e6, 4, device=dev)
        cg.set_use_bigcount(True)
        before = (K.byte_update_cuda.launches, _n_launches(),
                  K.read_window_counts_cuda.launches)
        out = [cg.consume_seqfile_and_tag(head), sorted(cg.all_tags)]
        for band in (None, (2, 200), (1, 65535)):
            subset = (cg.do_subset_partition(0, 0, False, True) if band is None
                      else cg.do_subset_partition_with_abundance(
                          band[0], band[1], stop_big_traversals=True))
            out.append({t: subset.get_partition_id(t) for t in cg.all_tags})
        out.append([sorted(cg.sweep_tag_neighborhood(s, 40)) for s in seqs])
        out.append([cg.get_median_count(s) for s in seqs])
        part = str(tmp_path / ("%s.part" % dev))
        cg.do_subset_partition(0, 0).output_partitioned_file(head, part)
        fresh = Countgraph(20, 1e6, 4, device=dev)
        out.append(fresh.consume_partitioned_fasta(part))
        out.append(sorted(fresh.all_tags))
        out.append([t.cpu().numpy().tobytes() for t in fresh.tables])
        got[str(dev)] = out
        if dev == cuda_device:
            assert K.byte_update_cuda.launches > before[0]
            assert _n_launches() > before[1]
            assert K.read_window_counts_cuda.launches > before[2]
    assert got[str(cuda_device)] == got["cpu"]


# -- the nibble tables: kernels P, Q and R -----------------------------------


@pytest.mark.parametrize("name", list(nibble_cases.NIBBLE_CASES))
def test_nibble_kernels_match_plain(cuda_device, name):
    """Kernels P, Q and R against their plain versions: tables, n_unique,
    new flags, counts and per-table counters; a case larger than the
    card's free memory (the 20 GB one on a smaller card) is skipped."""
    if not nibble_cases.case_fits(name, cuda_device):
        pytest.skip("the card lacks the memory for nibble case " + name)
    errs = nibble_cases.check_nibble_case(name, cuda_device)
    torch.cuda.empty_cache()
    assert errs == {"nibble_update": 0, "nibble_gather": 0,
                    "nibble_pertable": 0}


@pytest.mark.parametrize("name", list(nibble_cases.ROW_CASES))
def test_nibble_rows_match_plain(cuda_device, name):
    """Kernel R's and Q's rows modes against their plain versions on the
    row cases (k 1, 20 and 32, rows of L % 16 != 0, reads shorter than k,
    tables sharing 32-bit words, a read over 4,096 bases, a row of
    1,000,000 codes, a window of 16,384 reads over 4 GB): hashes,
    counters, flat nibble indices and the fill past each read; counts."""
    if not nibble_cases.row_case_fits(name, cuda_device):
        pytest.skip("the card lacks the memory for row case " + name)
    before = (K.nibble_pertable_rows_cuda.launches,
              K.nibble_row_counts_cuda.launches)
    errs = nibble_cases.check_row_case(name, cuda_device)
    torch.cuda.empty_cache()
    assert errs == {"nibble_pertable_rows": 0, "nibble_row_counts": 0}
    assert K.nibble_pertable_rows_cuda.launches == before[0] + 1
    assert K.nibble_row_counts_cuda.launches == before[1] + 1


def test_small_count_clis_on_cuda_launch_nibble_kernels(cuda_device,
                                                        tmp_path):
    """load-into-counting, abundance-dist-single, normalize-by-median,
    trim-low-abund and filter-abund-single with --small-count write on the
    card what they write on the CPU, through kernels P, Q and R (R's rows
    mode in the windows of normalize-by-median and trim-low-abund, Q's
    rows mode in filter-abund-single, Q under its mask in the histogram);
    the repartition of make-initial-stoptags with a nibble counting table
    gives the CPU's stop tags."""
    import contextlib
    import io
    import os

    from khmer_tpu_torch.cli import (abundance_dist_single,
                                     filter_abund_single, load_graph,
                                     load_into_counting,
                                     make_initial_stoptags,
                                     normalize_by_median, trim_low_abund)
    from khmer_tpu_torch.io.fastx import FastxParser

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    reads = os.path.join(repo, "data", "stamps-reads.fa.gz")
    head = str(tmp_path / "head.fa")
    with open(head, "w") as f:
        for i, rec in enumerate(FastxParser(reads)):
            if i == 5000:
                break
            f.write(">%s\n%s\n" % (rec.name, rec.sequence))
    tables = ["-k", "20", "-x", "1e5", "-N", "4", "--small-count"]
    runs = [
        (load_into_counting, tables + ["out.ct", head], ["out.ct"]),
        (abundance_dist_single, tables + [head, "out.dist"], ["out.dist"]),
        (normalize_by_median, tables + ["-C", "5", "-s", "n.ct", head],
         ["head.fa.keep", "n.ct"]),
        (trim_low_abund, tables + ["-V", "-Z", "10", "-s", "t.ct", head],
         ["head.fa.abundtrim", "t.ct"]),
        (filter_abund_single, tables + ["-C", "2", "-f", head],
         ["head.fa.abundfilt"]),
        (load_graph, ["-k", "20", "-x", "2e5", "-N", "4", "g", head], []),
        (make_initial_stoptags, ["-k", "20", "-x", "3e3", "-N", "4",
                                 "--small-count", "g"], ["g.stoptags"])]
    got = {}
    for dev in (cuda_device, "cpu"):
        d = tmp_path / str(dev).replace(":", "")
        d.mkdir()
        before = (K.nibble_update_cuda.launches,
                  K.nibble_gather_cuda.launches,
                  K.nibble_pertable_cuda.launches,
                  K.nibble_pertable_rows_cuda.launches,
                  K.nibble_row_counts_cuda.launches)
        cwd = os.getcwd()
        os.chdir(d)
        try:
            out = []
            for mod, args, files in runs:
                with contextlib.redirect_stderr(io.StringIO()):
                    mod.main(args + ["--device", str(dev)])
                out += [(d / f).read_bytes() for f in files]
        finally:
            os.chdir(cwd)
        got[str(dev)] = out
        if dev == cuda_device:
            assert K.nibble_update_cuda.launches > before[0]
            assert K.nibble_gather_cuda.launches > before[1]
            assert K.nibble_pertable_cuda.launches > before[2]
            assert K.nibble_pertable_rows_cuda.launches > before[3]
            assert K.nibble_row_counts_cuda.launches > before[4]
    assert got[str(cuda_device)] == got["cpu"]


# -- the sketch family: kernel S and kernel N's nibble mode ------------------


@pytest.mark.parametrize("name", list(family_cases.FILTER_CASES))
def test_consume_filter_matches_plain(cuda_device, name):
    """Kernel S against consume_filter_plain: the kept hashes in stream
    order and their count."""
    before = K.consume_filter_cuda.launches
    assert family_cases.check_filter_case(name, cuda_device) == 0
    assert K.consume_filter_cuda.launches == before + 1


@pytest.mark.parametrize("name", list(family_cases.NIBBLE_NBR_CASES))
def test_nibble_neighbors_match_plain(cuda_device, name):
    """Kernel N's nibble mode against nibble_neighbors_plain, in both of
    its modes, without a band and at every band."""
    assert family_cases.check_nibble_nbr_case(name, cuda_device) == 0


def test_sketch_family_on_cuda_launches_kernels(cuda_device, tmp_path):
    """The murmur tables' consumes, the masked and banded consumes and a
    SmallCountgraph's graph give on the card what they give on the CPU,
    through kernel S and kernel N's nibble mode."""
    import os

    from khmer_tpu_torch.core.sketch import (Counttable, Nodegraph,
                                             SmallCountgraph,
                                             SmallCounttable)
    from khmer_tpu_torch.io.fastx import FastxParser

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    reads = os.path.join(repo, "data", "stamps-reads.fa.gz")
    head, first = str(tmp_path / "head.fa"), str(tmp_path / "first.fa")
    with open(head, "w") as f, open(first, "w") as g:
        for i, rec in enumerate(FastxParser(reads)):
            if i == 3000:
                break
            f.write(">%s\n%s\n" % (rec.name, rec.sequence))
            if i < 500:
                g.write(">%s\n%s\n" % (rec.name, rec.sequence))
    seqs = [rec.sequence for _, rec in zip(range(50), FastxParser(head))]
    got = {}
    for dev in (cuda_device, "cpu"):
        before = (K.consume_filter_cuda.launches,
                  K.nibble_neighbors_cuda.launches
                  + K.nibble_neighbors_cuda.small_launches)
        out = []
        mask = Nodegraph(20, 1e5, 4, device=dev)
        mask.consume_seqfile(first)
        for cls in (Counttable, SmallCounttable):
            t = cls(20, 1e5, 4, device=dev)
            out.append(t.consume_seqfile_with_mask(head, mask, 1, True))
            out.append(t.consume_seqfile_banding(head, 4, 1))
            out.append(t.consume_seqfile_banding_with_mask(head, 4, 2, mask))
            out.append([x.tobytes() for x in t.get_raw_tables()])
            out.append([t.find_spectral_error_positions(s, 1) for s in seqs])
        g = SmallCountgraph(20, 1e5, 4, device=dev)
        out.append(g.consume_seqfile_and_tag(head))
        for band in (None, (1, 14), (1, 15), (2, 255)):
            subset = (g.do_subset_partition(0, 0) if band is None
                      else g.do_subset_partition_with_abundance(*band))
            out.append({t: subset.get_partition_id(t) for t in g.all_tags})
        out.append([sorted(g.sweep_tag_neighborhood(s, 40)) for s in seqs])
        got[str(dev)] = out
        if dev == cuda_device:
            assert K.consume_filter_cuda.launches > before[0]
            assert (K.nibble_neighbors_cuda.launches
                    + K.nibble_neighbors_cuda.small_launches) > before[1]
    assert got[str(cuda_device)] == got["cpu"]
