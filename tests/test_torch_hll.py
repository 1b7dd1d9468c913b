"""The port's HLLCounter (khmer_tpu_torch.core.hll, kernel K's plain
version on the CPU) and its unique-kmers CLI against the JAX package's,
under both JAX engines (KHMER_TPU_ENGINE=auto, the native host tier;
=device, the flat murmur + scatter-max path). Registers and estimates are
compared exactly; the inputs are the repo's data and seeded read sets
(the JAX package's own unique-kmers tests read reference data this
repository does not have)."""

import contextlib
import io
import os
import re
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from khmer_tpu import HLLCounter as JaxHLL
from khmer_tpu.core import hll as jax_hll
from khmer_tpu.core import pipeline as jax_pipeline
from khmer_tpu_torch.core import sketch_kernels as K
from khmer_tpu_torch.core.hll import HLLCounter
from khmer_tpu_torch.io.fastx import FastxParser

# six xdist workers share the cores: one intra-op thread each
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GENOMES = os.path.join(REPO, "data", "stamps-genomes.fa")
ENGINES = ["auto", "device"]


def _hll(error_rate=0.01, k=20):
    return HLLCounter(error_rate, k, device="cpu")


def _write_reads(path, seed, n=300):
    """Seeded FASTA reads of 0-180 bases with Ns, lowercase bases and
    reads shorter than k."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(n):
            length = int(rng.integers(0, 181))
            seq = "".join(rng.choice(list("ACGTACGTACGTacgtN"), length))
            f.write(">r%d\n%s\n" % (i, seq))
    return str(path)


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    return _write_reads(tmp_path_factory.mktemp("hll") / "reads.fa", 7)


def _jax_counters(monkeypatch, engine, k, error_rate, path):
    monkeypatch.setenv("KHMER_TPU_ENGINE", engine)
    j = JaxHLL(error_rate, k)
    got = j.consume_seqfile(path)
    return got, j.counters, j.estimate_cardinality()


@pytest.mark.parametrize("engine", ENGINES)
def test_stamps_genomes_estimate_matches_jax(engine, monkeypatch):
    jgot, jcounters, jest = _jax_counters(monkeypatch, engine, 20, 0.01,
                                          GENOMES)
    for source in (GENOMES, FastxParser(GENOMES)):
        h = _hll()
        assert h.consume_seqfile(source) == jgot
        assert h.counters == jcounters
        assert h.estimate_cardinality() == jest == 7948


@pytest.mark.parametrize("k,error_rate", [(4, 0.36), (17, 0.01),
                                          (20, 0.0040625), (31, 0.05),
                                          (32, 0.01)])
@pytest.mark.parametrize("engine", ENGINES)
def test_seeded_reads_match_jax(k, error_rate, engine, reads, monkeypatch):
    """Native blocks (a path) and the FlatPacker (a parser) give JAX's
    registers, read counts and consumed k-mers, at p 4, 14 and 16."""
    jgot, jcounters, jest = _jax_counters(monkeypatch, engine, k,
                                          error_rate, reads)
    for source in (reads, FastxParser(reads)):
        h = _hll(error_rate, k)
        assert h.consume_seqfile(source) == jgot
        assert h.counters == jcounters
        assert len(h) == jest


@pytest.mark.parametrize("k", [4, 17, 20, 31, 32, 33, 64])
def test_hll_add_plain_matches_jax_flat_step(k):
    """One flat chunk as JAX's device path sees it (a small FlatPacker
    chunk, so reads split across chunks): hll_add_plain against
    _hll_flat_hash + _make_add_batch, chunk by chunk."""
    rng = np.random.default_rng(k)
    chunk = 4096
    packer = jax_pipeline.FlatPacker(k, chunk=chunk)
    chunks = []
    for _ in range(80):
        seq = "".join(rng.choice(list("ACGT"), int(rng.integers(0, 400))))
        chunks.extend(packer.add(seq))
    chunks.append(packer.flush())
    p = 14
    regs = torch.zeros(1 << p, dtype=torch.uint8)
    jregs = jnp.zeros(1 << p, jnp.uint8)
    flat = jax_hll._hll_flat_hash(k, chunk)
    add = jax_hll._make_add_batch(p)
    for codes, starts, nfill in chunks:
        hs, valid = flat(jnp.asarray(codes), jnp.asarray(starts),
                         jnp.int32(nfill))
        jregs = add(jregs, hs, valid)
        K.hll_add(regs, torch.from_numpy(codes.copy()),
                  torch.from_numpy(starts.astype(np.int64)), nfill, k)
        assert K.flat_valid_windows(starts, nfill, k) == int(jnp.sum(valid))
    assert np.array_equal(regs.numpy(), np.asarray(jregs))


def test_hll_index_rho_edges():
    """rho = clz64(h >> p) - p + 1 with clz64(0) = 64, as JAX computes
    it, at the edges: h >> p == 0, the top bit set, single bits."""
    p = 14
    vals = [0, 1, (1 << p) - 1, 1 << p, (1 << 63), (1 << 64) - 1]
    vals += [1 << b for b in range(64)]
    h = np.array(vals, dtype=np.uint64)
    index, rho = K.hll_index_rho(torch.from_numpy(h.view(np.int64)), p)
    for v, i, r in zip(vals, index.tolist(), rho.tolist()):
        rest = v >> p
        clz = 64 - rest.bit_length()
        assert i == v & ((1 << p) - 1)
        assert r == clz - p + 1


@pytest.mark.parametrize("engine", ENGINES)
def test_consume_string_and_add_match_jax(engine, monkeypatch):
    monkeypatch.setenv("KHMER_TPU_ENGINE", engine)
    rng = np.random.default_rng(3)
    seqs = ["".join(rng.choice(list("ACGTNacgt"), int(n)))
            for n in rng.integers(20, 200, 40)]
    h, j = _hll(), JaxHLL(0.01, 20)
    for s in seqs:
        assert h.consume_string(s) == j.consume_string(s)
    assert h.counters == j.counters
    for s in seqs[:5]:
        for i in range(len(s) - 19):
            h.add(s[i:i + 20])
            j.add(s[i:i + 20])
    assert h.counters == j.counters
    assert len(h) == len(j)


# the behavioural cases of tests/test_hll.py, on this repository's data


def _alpha_case():
    for e, p, alpha in ((0.36, 4, 0.673), (0.21, 5, 0.697),
                        (0.16, 6, 0.709)):
        h = _hll(e)
        assert h.alpha == alpha and len(h.counters) == 2 ** p


def _alpha_readonly():
    with pytest.raises(AttributeError):
        _hll().alpha = 5


def _invalid_error_rate():
    with pytest.raises(ValueError):
        _hll(-0.01)


def _error_rate_bounds():
    assert len(_hll(0.367695).counters) == 2 ** 4
    assert len(_hll(0.0040625).counters) == 2 ** 16


def _change_error_rate():
    h = _hll(0.0040625)
    assert h.error_rate == 0.0040625
    h.error_rate = 0.008125
    assert h.error_rate == 0.008125


def _change_error_rate_after_consume():
    h = _hll()
    h.consume_string("A" * 32)
    with pytest.raises((AttributeError, ValueError)):
        h.error_rate = 0.1


def _change_ksize():
    h = _hll(0.0040625)
    assert h.ksize == 20
    h.ksize = 24
    assert h.ksize == 24
    h.ksize = 12
    assert h.ksize == 12
    with pytest.raises(ValueError):
        h.ksize = 0


def _change_ksize_after_consume():
    h = _hll()
    h.consume_string("A" * 32)
    with pytest.raises((AttributeError, ValueError)):
        h.ksize = 24


def _counters_zeroed():
    h = _hll(0.36)
    assert h.counters == [0] * 16


def _merge_mismatched_p():
    with pytest.raises(ValueError):
        _hll(0.36).merge(_hll(0.10))


def _merge_mismatched_k():
    with pytest.raises(ValueError):
        _hll(0.36).merge(_hll(0.36, 22))


def _merge_idempotent():
    a, b = _hll(0.36, 32), _hll(0.36, 32)
    a.consume_seqfile(GENOMES)
    b.consume_seqfile(GENOMES)
    before = len(a)
    a.merge(b)
    assert len(a) == before


def _merge_union():
    a, b, both = _hll(), _hll(), JaxHLL(0.01, 20)
    seqs = [r.sequence for r in FastxParser(GENOMES)]
    a.consume_string(seqs[0])
    b.consume_string(seqs[1])
    la, lb = len(a), len(b)
    a.merge(b)
    assert max(la, lb) <= len(a)
    for s in seqs:
        both.consume_string(s)
    assert a.counters == both.counters


def _short_sequence():
    with pytest.raises(ValueError):
        _hll(0.01, 32).consume_string("ACGT")


def _empty():
    assert len(_hll()) == 0


def _len_is_estimate():
    h = _hll()
    h.consume_seqfile(GENOMES)
    assert h.estimate_cardinality() == len(h) == 7948


def _too_few_counters():
    with pytest.raises(ValueError, match="at least 16 counters"):
        _hll(0.5)


BEHAVIOUR = {f.__name__.lstrip("_"): f for f in (
    _alpha_case, _alpha_readonly, _invalid_error_rate, _error_rate_bounds,
    _change_error_rate, _change_error_rate_after_consume, _change_ksize,
    _change_ksize_after_consume, _counters_zeroed, _merge_mismatched_p,
    _merge_mismatched_k, _merge_idempotent, _merge_union, _short_sequence,
    _empty, _len_is_estimate, _too_few_counters)}


@pytest.mark.parametrize("name", list(BEHAVIOUR))
def test_hll_behaviour(name):
    BEHAVIOUR[name]()


def test_hll_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        HLLCounter(0.01, 20)


# the unique-kmers CLI


class _Stdout(io.StringIO):
    pass


def _run(module, args):
    """A CLI's main() in this process: (status, stdout, stderr)."""
    import importlib

    mod = importlib.import_module(module)
    saved = sys.argv, sys.stdout, sys.stderr
    out, err = io.StringIO(), io.StringIO()
    sys.argv = [module] + args
    sys.stdout, sys.stderr = out, err
    try:
        try:
            mod.main()
            status = 0
        except SystemExit as exc:
            status = exc.code or 0
    finally:
        sys.argv, sys.stdout, sys.stderr = saved
    return status, out.getvalue(), err.getvalue()


def _body(err):
    """stderr without the version banner (it names the package)."""
    return [line for line in err.splitlines()
            if not line.startswith("||")]


CLI_CASES = {
    "genomes": ["-k", "20", "-e", "0.01", "{genomes}"],
    "report": ["-k", "17", "-R", "{report}", "{genomes}", "{reads}"],
    "stream": ["-k", "20", "--stream-records", "{reads}"],
    "diagnostics": ["-k", "31", "-e", "0.05", "--diagnostics", "{reads}"],
    "quiet": ["-q", "-k", "4", "-e", "0.36", "{reads}", "{genomes}"],
}


@pytest.mark.parametrize("name", list(CLI_CASES))
@pytest.mark.parametrize("engine", ENGINES)
def test_unique_kmers_cli_matches_jax(name, engine, reads, tmp_path,
                                      monkeypatch):
    monkeypatch.setenv("KHMER_TPU_ENGINE", engine)
    got = {}
    for side, module in (("port", "khmer_tpu_torch.cli.unique_kmers"),
                         ("jax", "khmer_tpu.cli.unique_kmers")):
        report = tmp_path / (side + ".report")
        args = [a.format(genomes=GENOMES, reads=reads, report=report)
                for a in CLI_CASES[name]]
        if side == "port":
            args += ["--device", "cpu"]
        status, out, err = _run(module, args)
        got[side] = (status, out, _body(err),
                     report.read_text() if report.exists() else None)
    assert got["port"] == got["jax"]
    status, out, body, report = got["port"]
    assert status == 0
    assert any(re.match(r"Total estimated number of unique \d+-mers: \d+",
                        line) for line in body)
    if name == "genomes":
        assert "Total estimated number of unique 20-mers: 7948" in body
    if name == "stream":
        assert out.count(">") == 300
    if name == "report":
        assert report.splitlines()[2].endswith("total")
    if name == "diagnostics":
        assert "If you have expected memory to use:" in body


def test_unique_kmers_cli_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with contextlib.redirect_stderr(io.StringIO()):
        with pytest.raises(RuntimeError, match="CUDA"):
            from khmer_tpu_torch.cli import unique_kmers

            unique_kmers.main(["-k", "20", GENOMES])
