"""The walks' level loop in C++ (csrc/level_walk.cc kt_level_run, through
ops/host.py _LevelWalk.run and core/partition.py _Prober.run) against the
JAX package on the CPU, the probe the callback that runs kernels L's and
N's plain versions: the tags of the partition walk (with and without an
abundance band, on a Countgraph with bigcount entries and on a
Nodegraph), the .pmap bytes and the perimeter sweeps against JAX's native
engine (KHMER_TPU_ENGINE=auto); the loop against the same passes stepped
from Python; a probe that fails, which raises and leaves no answer; an
empty walk; and levels handed out by a block function whose first block is
smaller than the frontiers (the card's pinned block grows so).

Tolerance: exact everywhere (integer state)."""

import ctypes
import os

import numpy as np
import pytest
import torch

from khmer_tpu import Countgraph as JaxCountgraph
from khmer_tpu import Nodegraph as JaxNodegraph
from khmer_tpu.core import partition as JP
from khmer_tpu_torch.core import partition as P
from khmer_tpu_torch.core import sketch_kernels as K
from khmer_tpu_torch.core.sketch import Countgraph, Nodegraph
from khmer_tpu_torch.ops import host

# six xdist workers share the cores: one intra-op thread each
torch.set_num_threads(1)

K_SIZE = 20
BANDS = [None, (2, 200), (1, 65535), (3, 65535)]


@pytest.fixture(scope="module", autouse=True)
def _two_walk_threads():
    """Two threads a walk pass: the workers share the cores."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(host, "walk_threads", lambda: 2)
        yield


def _reads(seed, n=400, genome_len=3000, length=100, sub=0.01):
    """Seeded reads of a random genome with substitutions (branches), and
    one read 300 times more (its k-mers past 255: bigcount entries)."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, genome_len)
    out = []
    for _ in range(n):
        s = int(rng.integers(0, genome_len - length))
        read = genome[s:s + length].copy()
        hit = rng.random(length) < sub
        read[hit] = rng.integers(0, 4, int(hit.sum()))
        out.append("".join("ATCG"[c] for c in read))
    return out + [out[7]] * 300


@pytest.fixture(scope="module")
def seqs():
    return _reads(21)


@pytest.fixture(scope="module")
def graphs(seqs):
    """{kind: (JAX graph, the port's graph on the CPU holding its state)}:
    a Countgraph with bigcount on and a Nodegraph, tagged at density 10
    from the reads by JAX's native engine, every ninth tag a stop tag."""
    out = {}
    for kind, jcls, pcls in (("count", JaxCountgraph, Countgraph),
                             ("node", JaxNodegraph, Nodegraph)):
        os.environ["KHMER_TPU_ENGINE"] = "auto"
        try:
            jg = jcls(K_SIZE, 1e5, 4)
            if kind == "count":
                jg.set_use_bigcount(True)
            jg._set_tag_density(10)
            for s in seqs:
                jg.consume_and_tag(s)
        finally:
            del os.environ["KHMER_TPU_ENGINE"]
        for t in sorted(jg.all_tags)[::9]:
            jg.add_stop_tag(int(t))
        extra = ({"bigcounts": jg._bigcounts, "use_bigcount": True}
                 if kind == "count" else {})
        pg = pcls.from_numpy_state(
            K_SIZE, jg._primes, [np.asarray(t) for t in jg.tables],
            int(jg.n_unique_kmers()), 0, device="cpu",
            all_tags=jg.all_tags, stop_tags=jg.stop_tags,
            tag_density=jg._tag_density, **extra)
        out[kind] = (jg, pg)
    assert out["count"][0]._bigcounts
    return out


def _starts(pg):
    tags = np.array(sorted(pg.all_tags), np.uint64)
    return tags, P.revcomp_bits(tags, K_SIZE)


def _walk(pg, tags, r, band, stop_big=True, start_ok=None):
    if band is not None and start_ok is None:
        counts = pg.get_counts_for_hashes(tags)
        start_ok = (counts >= band[0]) & (counts <= band[1])
    return host.TagWalk(tags, r, K_SIZE, *(P._sorted_tags(s) for s in (
        pg.all_tags, pg.stop_tags)), 2 * pg._tag_density + 1, True, stop_big,
        start_ok)


@pytest.mark.parametrize("kind", ["count", "node"])
@pytest.mark.parametrize("band", BANDS)
def test_level_run_tags_match_jax(kind, band, graphs):
    """Every tag's walk through kt_level_run, probed by the plain
    versions, against JAX's find_all_tags_batch under its native engine
    (breaking on stop tags, big traversals cut)."""
    jg, pg = graphs[kind]
    tags, r = _starts(pg)
    walk = _walk(pg, tags, r, band)
    probe = P._Prober(pg, band)
    try:
        probe.run(walk)
        got = [set(t.tolist()) for t in walk.tags()]
        stats = walk.stats()
    finally:
        walk.close()
    os.environ["KHMER_TPU_ENGINE"] = "auto"
    try:
        want = JP.find_all_tags_batch(jg, list(zip(tags.tolist(),
                                                   r.tolist())),
                                      True, True, count_range=band)
    finally:
        del os.environ["KHMER_TPU_ENGINE"]
    assert got == [set(int(t) for t in w) for w in want]
    # a Nodegraph's k-mers count 1: a band from 2 up holds none of them
    assert (sum(map(len, got)) > 0) != (kind == "node" and band is not None
                                        and band[0] > 1)
    assert stats["levels"] > 1 or not any(got)
    assert stats["nodes"] >= stats["levels"]


@pytest.mark.parametrize("kind", ["count", "node"])
@pytest.mark.parametrize("band", BANDS)
def test_level_run_pmap_matches_jax(kind, band, graphs, tmp_path):
    """do_subset_partition(_with_abundance), whose walks run through
    kt_level_run: .pmap bytes against JAX's native engine."""
    jg, pg = graphs[kind]
    os.environ["KHMER_TPU_ENGINE"] = "auto"
    try:
        if band is None:
            mine = pg.do_subset_partition(0, 0, True, True)
            theirs = jg.do_subset_partition(0, 0, True, True)
        else:
            mine = pg.do_subset_partition_with_abundance(
                band[0], band[1], 0, 0, True, True)
            theirs = jg.do_subset_partition_with_abundance(
                band[0], band[1], 0, 0, True, True)
    finally:
        del os.environ["KHMER_TPU_ENGINE"]
    mine.save_partitionmap(str(tmp_path / "p.pmap"))
    theirs.save_partitionmap(str(tmp_path / "j.pmap"))
    assert (tmp_path / "p.pmap").read_bytes() \
        == (tmp_path / "j.pmap").read_bytes()


@pytest.mark.parametrize("kind", ["count", "node"])
@pytest.mark.parametrize("sweep_range", [0, 81])
def test_level_run_sweeps_match_jax(kind, sweep_range, graphs, seqs):
    """A batch of perimeter sweeps through kt_level_run against JAX's
    sweep_for_tags under its native engine."""
    jg, pg = graphs[kind]
    queries = seqs[:30] + [seqs[3][:K_SIZE], seqs[4][:10]]
    found, totals = P.sweep_for_tags_batch(pg, queries, sweep_range, True,
                                           True)
    os.environ["KHMER_TPU_ENGINE"] = "auto"
    try:
        want = [JP.sweep_for_tags(jg, q, sweep_range, True, True)
                for q in queries]
    finally:
        del os.environ["KHMER_TPU_ENGINE"]
    assert [(set(f.tolist()), int(n)) for f, n in zip(found, totals)] == \
        [(set(int(t) for t in w), int(n)) for w, n in want]
    assert any(len(f) for f in found)


@pytest.mark.parametrize("kind", ["count", "node"])
def test_level_run_equals_the_passes_stepped(kind, graphs):
    """The C++ loop and the same walk stepped a level at a time from
    Python (kt_level_pass, kt_level_frontier) give the same tags, levels
    and nodes."""
    _, pg = graphs[kind]
    tags, r = _starts(pg)
    probe = P._Prober(pg)
    sides = []
    for stepped in (False, True):
        walk = _walk(pg, tags, r, None, stop_big=False)
        try:
            levels = []
            if stepped:
                n = walk.step()
                while n:
                    levels.append(n)
                    n = walk.step(probe(walk, n))
            else:
                probe.run(walk)
            sides.append(([t.tolist() for t in walk.tags()], levels,
                          walk.stats()))
        finally:
            walk.close()
    (run_tags, _, run_stats), (step_tags, levels, _) = sides
    assert run_tags == step_tags
    assert run_stats["levels"] == len(levels)
    assert run_stats["nodes"] == sum(levels)


def test_probe_error_raises_with_no_answer(graphs):
    """A probe that returns a code stops the walk at that level, and run()
    raises ProbeError with it; a probe callback that raises ends the walk
    and _Prober.run raises its exception; find_all_tags_batch then returns
    nothing."""
    _, pg = graphs["count"]
    tags, r = _starts(pg)
    calls = []

    def failing(ctx, fr, n, masks, band):
        calls.append(n)
        return 7 if len(calls) == 3 else 0

    plain = P._Prober(pg)

    def probe(ctx, fr, n, masks, band):
        return plain._plain_level(ctx, fr, n, masks, band) or failing(
            ctx, fr, n, masks, band)

    cb = host.PROBE_FN(probe)
    walk = _walk(pg, tags, r, None)
    try:
        with pytest.raises(host.ProbeError) as err:
            walk.run(cb)
    finally:
        walk.close()
    assert err.value.code == 7
    assert len(calls) == 3

    class Boom(Exception):
        pass

    def boom(self, f, r):
        raise Boom("a level failed")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(P._Prober, "_probe", boom)
        with pytest.raises(Boom):
            P.find_all_tags_batch(pg, tags, r, True, True)


def test_empty_walk(graphs):
    """A walk of no starts, and sweeps of queries shorter than k, end on
    the first pass: the probe is never called."""
    _, pg = graphs["count"]
    calls = []

    def probe(ctx, fr, n, masks, band):
        calls.append(n)
        return 0

    cb = host.PROBE_FN(probe)
    empty = np.zeros(0, np.uint64)
    walk = _walk(pg, empty, empty, (2, 200), start_ok=np.zeros(0, bool))
    try:
        walk.run(cb)
        assert walk.tags() == [] or all(len(t) == 0 for t in walk.tags())
        assert walk.stats()["levels"] == 0
    finally:
        walk.close()
    assert calls == []
    assert P.find_all_tags_batch(pg, empty, empty) == []
    found, totals = P.sweep_for_tags_batch(pg, ["ACGT", "A" * (K_SIZE - 1)])
    assert [len(f) for f in found] == [0, 0] and totals.tolist() == [0, 0]


BLOCK_FN = ctypes.CFUNCTYPE(ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64)


def test_levels_larger_than_the_first_block(graphs):
    """Each level's block handed out by a block function, as the card's
    pinned block is (grow-only, here from 64 bytes): the walk writes its
    frontier there and the probe its bytes after it; the tags equal those
    of the walk's own storage, and the block grew past its first size."""
    jg, pg = graphs["count"]
    tags, r = _starts(pg)
    band = (2, 200)
    held = {"buf": np.zeros(8, np.uint64), "grown": 0, "largest": 0}

    def block(ctx, n):
        need = (18 * n + 7) // 8
        held["largest"] = max(held["largest"], n)
        if held["buf"].shape[0] < need:
            held["buf"] = np.zeros(max(need, 2 * held["buf"].shape[0]),
                                   np.uint64)
            held["grown"] += 1
        return held["buf"].ctypes.data

    block_cb = BLOCK_FN(block)
    probe = P._Prober(pg, band)
    got = {}
    for side in ("own", "block"):
        walk = _walk(pg, tags, r, band)
        try:
            walk.run(probe.probe, block_cb if side == "block" else None)
            got[side] = [t.tolist() for t in walk.tags()]
        finally:
            walk.close()
    assert got["block"] == got["own"]
    assert held["grown"] >= 2 and 18 * held["largest"] > 64
    assert [set(t) for t in got["own"]] == [
        set(t.tolist()) for t in P.find_all_tags_batch(
            pg, tags, r, True, True, count_range=band)]


def test_level_probe_is_for_the_card():
    """The card's probe context takes CUDA tables only; the choice between
    it and the plain callback is the tables' device."""
    flat = torch.zeros(K.byte_flat_size([7, 5]), dtype=torch.uint8)
    with pytest.raises(ValueError):
        K.LevelProbe([7, 5], flat, K_SIZE, "byte")


def test_walk_loop_modules_import_no_jax():
    """The level tap and nbr_bench, which the card's machine runs, import
    no JAX."""
    import subprocess
    import sys

    code = ("import sys, khmer_tpu_torch.scripts.level_tap, "
            "khmer_tpu_torch.scripts.nbr_bench, "
            "khmer_tpu_torch.scripts.countgraph_cases; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'khmer_tpu.')) or m == 'khmer_tpu']; "
            "sys.exit(repr(bad) if bad else 0)")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr + proc.stdout
