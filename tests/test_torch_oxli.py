"""OXLI type-1 (Countgraph, with its bigcount trailer) and type-2
(Nodegraph) files of khmer_tpu_torch against the JAX package's: the
port's saved bytes equal JAX save_sketch's, plain and gzipped, and a
file written by either package loads into the other with the same
tables, bigcounts and n_occupied."""

import gzip

import numpy as np
import pytest
import torch

from khmer_tpu import Countgraph as JaxCountgraph
from khmer_tpu import Nodegraph as JaxNodegraph
from khmer_tpu.core import oxli_io as jax_io
from khmer_tpu_torch import Countgraph, Nodegraph
from khmer_tpu_torch.core import oxli_io

# six xdist workers share the cores: one intra-op thread each
torch.set_num_threads(1)

K = 20


def _sketches(kind):
    """A JAX sketch and the port's twin driven by the same seeded hashes
    (for a Countgraph, some counted past 255 so the bigcount map fills)."""
    rng = np.random.default_rng(5)
    hashes = rng.integers(0, 2**64, 3000, dtype=np.uint64)
    if kind == "countgraph":
        hashes = np.concatenate([hashes, np.repeat(hashes[:3], 300)])
        primes = (1009, 1013, 1019)
        ref, mine = JaxCountgraph(K, 1, 1, primes=primes), \
            Countgraph(K, 1, 1, primes=primes, device="cpu")
        ref.set_use_bigcount(True)
        mine.set_use_bigcount(True)
    else:
        primes = (4099, 4093)
        ref, mine = JaxNodegraph(K, 1, 1, primes=primes), \
            Nodegraph(K, 1, 1, primes=primes, device="cpu")
    rng.shuffle(hashes)
    for part in np.array_split(hashes, 3):
        ref._commit_hashes(part)
        mine._commit_hashes(part)
    return ref, mine


@pytest.mark.parametrize("kind", ["countgraph", "nodegraph"])
@pytest.mark.parametrize("suffix", ["", ".gz"])
def test_save_writes_the_same_bytes_as_jax(kind, suffix, tmp_path,
                                           monkeypatch):
    # gzip stamps the time into its header; hold it fixed for both
    monkeypatch.setattr(gzip.time, "time", lambda: 1.7e9)
    ref, mine = _sketches(kind)
    name = "table.oxli" + suffix
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jax_io.save_sketch(ref, str(tmp_path / "jax" / name))
    oxli_io.save_sketch(mine, str(tmp_path / "port" / name))
    blob = (tmp_path / "port" / name).read_bytes()
    assert blob == (tmp_path / "jax" / name).read_bytes()
    raw = gzip.decompress(blob) if suffix else blob
    assert raw[:6] == b"OXLI\x04" + bytes([1 if kind == "countgraph"
                                           else 2])
    if kind == "countgraph":
        assert mine._bigcounts and raw[6] == 1


@pytest.mark.parametrize("kind", ["countgraph", "nodegraph"])
@pytest.mark.parametrize("suffix", ["", ".gz"])
def test_files_load_across_the_packages(kind, suffix, tmp_path):
    ref, mine = _sketches(kind)
    jax_file = str(tmp_path / ("jax.oxli" + suffix))
    port_file = str(tmp_path / ("port.oxli" + suffix))
    ref.save(jax_file)
    mine.save(port_file)
    cls, jax_cls = ((Countgraph, JaxCountgraph) if kind == "countgraph"
                    else (Nodegraph, JaxNodegraph))
    got = cls.load(jax_file, device="cpu")
    back = jax_cls.load(port_file)
    for a, b, c in zip(got.get_raw_tables(), ref.get_raw_tables(),
                       back.get_raw_tables()):
        assert np.array_equal(a, b) and np.array_equal(a, c)
    assert got.hashsizes() == ref.hashsizes() == back.hashsizes()
    assert got.n_occupied() == ref.n_occupied() == back.n_occupied()
    assert got._bigcounts == ref._bigcounts == back._bigcounts
    assert got.get_use_bigcount() == ref.get_use_bigcount()
    query = np.random.default_rng(9).integers(0, 2**64, 200,
                                              dtype=np.uint64)
    assert np.array_equal(got.get_counts_for_hashes(query),
                          ref.get_counts_for_hashes(query))


def test_loaded_occupied_header_is_kept(tmp_path):
    """A stale occupied-bins header survives load and re-save, as in the
    reference and the JAX package."""
    ref, _ = _sketches("countgraph")
    ref._occupied_offset = 17
    path = str(tmp_path / "stale.ct")
    ref.save(path)
    got = Countgraph.load(path, device="cpu")
    assert got.n_occupied() == ref.n_occupied()
    again = str(tmp_path / "again.ct")
    got.save(again)
    with open(path, "rb") as a, open(again, "rb") as b:
        assert a.read() == b.read()


def test_wrong_type_is_refused(tmp_path):
    path = str(tmp_path / "graph.pt")
    JaxNodegraph(K, 1, 1, primes=(101,)).save(path)
    with pytest.raises(OSError, match="Incorrect file format type 2"):
        Countgraph.load(path, device="cpu")
