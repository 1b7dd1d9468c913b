"""The port's CLIs (load-into-counting in both layouts, abundance-dist,
abundance-dist-single) against the JAX CLIs, the .ct files across the
two packages, and the port's import boundary (no JAX). normalize-by-median
is held to the JAX CLI in tests/test_torch_normalize_cli.py."""

import gzip
import itertools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from khmer_tpu.core.blocked import BlockedCountgraph as JaxBlocked
from khmer_tpu_torch.cli import (abundance_dist, abundance_dist_single,
                                 load_into_counting)
from khmer_tpu_torch.core.blocked import BlockedCountgraph

from tests.script_utils import runscript

# six xdist workers share the cores: one intra-op thread each
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "data", "25k.fq.gz")
ARGS = ["-k", "20", "-x", "4e5", "-N", "4", "--tpu-layout", "blocked"]


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    """The .ct and .info written by each package's CLI from the first 2000
    reads of data/25k.fq.gz (gzipped, as the real input is)."""
    d = tmp_path_factory.mktemp("cli")
    reads = str(d / "head2000.fq.gz")
    with gzip.open(DATA, "rt") as src, gzip.open(reads, "wt") as dst:
        dst.writelines(itertools.islice(src, 4 * 2000))
    port_ct, jax_ct = str(d / "port.ct"), str(d / "jax.ct")
    load_into_counting.main(ARGS + ["--device", "cpu", port_ct, reads])
    status, _, err = runscript("load-into-counting.py",
                               ARGS + [jax_ct, reads])
    assert status == 0, err
    return port_ct, jax_ct


def test_cli_writes_the_same_ct_and_info_as_jax(outputs):
    port_ct, jax_ct = outputs
    with open(port_ct, "rb") as a, open(jax_ct, "rb") as b:
        blob = a.read()
        assert blob == b.read()
    assert blob[:4] == b"OXLI" and blob[5] == 127
    with open(port_ct + ".info") as a, open(jax_ct + ".info") as b:
        info = a.read()
        assert info == b.read()
    assert "Total number of unique k-mers:" in info


def test_each_package_loads_the_others_ct(outputs):
    port_ct, jax_ct = outputs
    mine = BlockedCountgraph.load(jax_ct, device="cpu")
    ref = JaxBlocked.load(port_ct)
    assert mine.ksize() == ref.ksize() == 20
    assert mine.nblocks == ref.nblocks
    assert (mine.tables[0].numpy() == np.asarray(ref.tables[0])).all()
    assert mine.n_occupied() == ref.n_occupied()
    hashes = np.random.default_rng(0).integers(0, 2**64, 1000,
                                               dtype=np.uint64)
    assert (mine.get_counts_for_hashes(hashes)
            == ref.get_counts_for_hashes(hashes)).all()


EXACT_ARGS = ["-k", "20", "-x", "1e6", "-N", "4", "-f"]


@pytest.fixture(scope="module")
def exact_outputs(tmp_path_factory):
    """The .ct, .info and histogram CSVs written by each package's CLIs in
    the default (exact) layout from data/25k.fq.gz: load-into-counting,
    then abundance-dist on that .ct, and abundance-dist-single (which
    also saves its countgraph). The tables are small for the input, so
    -f lets the scripts past the false-positive guard, on both sides."""
    out = {}
    for side in ("port", "jax"):
        d = tmp_path_factory.mktemp(side)
        ct, hist = str(d / "out.ct"), str(d / "out.hist")
        single, single_ct = str(d / "single.hist"), str(d / "single.ct")
        if side == "port":
            dev = ["--device", "cpu"]
            load_into_counting.main(EXACT_ARGS + dev + [ct, DATA])
            abundance_dist.main(dev + [ct, DATA, hist])
            abundance_dist_single.main(
                EXACT_ARGS + dev + ["--savegraph", single_ct, DATA, single])
        else:
            for script, args in (
                    ("load-into-counting.py", EXACT_ARGS + [ct, DATA]),
                    ("abundance-dist.py", [ct, DATA, hist]),
                    ("abundance-dist-single.py", EXACT_ARGS + [
                        "--savegraph", single_ct, DATA, single])):
                status, _, err = runscript(script, args)
                assert status == 0, err
        out[side] = {"ct": ct, "info": ct + ".info", "hist": hist,
                     "single": single, "single_ct": single_ct}
    return out


@pytest.mark.parametrize("what", ["ct", "info", "hist", "single",
                                  "single_ct"])
def test_exact_layout_clis_write_the_same_bytes_as_jax(exact_outputs, what):
    with open(exact_outputs["port"][what], "rb") as a, \
            open(exact_outputs["jax"][what], "rb") as b:
        blob = a.read()
        assert blob == b.read()
    if what in ("ct", "single_ct"):
        assert blob[:6] == b"OXLI\x04\x01" and blob[6] == 1  # bigcount on
    if what in ("hist", "single"):
        assert blob.startswith(b"abundance,count,cumulative,")


def test_exact_layout_ct_loads_in_each_package(exact_outputs):
    from khmer_tpu import load_countgraph as jax_load
    from khmer_tpu_torch import load_countgraph

    mine = load_countgraph(exact_outputs["jax"]["ct"], device="cpu")
    ref = jax_load(exact_outputs["port"]["ct"])
    assert mine.hashsizes() == ref.hashsizes() == [999983, 999979,
                                                   999961, 999959]
    assert mine.get_use_bigcount() and ref.get_use_bigcount()
    for a, b in zip(mine.get_raw_tables(), ref.get_raw_tables()):
        assert np.array_equal(a, b)
    assert mine.n_occupied() == ref.n_occupied()
    assert mine._bigcounts == ref._bigcounts


def test_cuda_device_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        load_into_counting.main(ARGS + [str(tmp_path / "x.ct"), DATA])


def test_port_imports_no_jax():
    code = ("import sys, khmer_tpu_torch, khmer_tpu_torch.cli."
            "load_into_counting, khmer_tpu_torch.cli.abundance_dist, "
            "khmer_tpu_torch.cli.abundance_dist_single, "
            "khmer_tpu_torch.cli.normalize_by_median, "
            "khmer_tpu_torch.cli.trim_low_abund, "
            "khmer_tpu_torch.cli.filter_abund, "
            "khmer_tpu_torch.cli.filter_abund_single, "
            "khmer_tpu_torch.cli.unique_kmers, "
            "khmer_tpu_torch.cli.load_graph, "
            "khmer_tpu_torch.core.hll, "
            "khmer_tpu_torch.core.graphmixin, "
            "khmer_tpu_torch.ops.host, "
            "khmer_tpu_torch.scripts.graph_cases, "
            "khmer_tpu_torch.scripts.graph_bench, "
            "khmer_tpu_torch.scripts.hll_variants, "
            "khmer_tpu_torch.scripts.trace_config4, "
            "khmer_tpu_torch.utils.trimming, "
            "khmer_tpu_torch.scripts.trim_cases, "
            "khmer_tpu_torch.scripts.trim_bench, "
            "khmer_tpu_torch.scripts.read_counts_variants, "
            "khmer_tpu_torch.core.diginorm, "
            "khmer_tpu_torch.core.diginorm_scan, "
            "khmer_tpu_torch.io.pairing, "
            "khmer_tpu_torch.scripts.synth_reads, "
            "khmer_tpu_torch.scripts.diginorm_bench, "
            "khmer_tpu_torch.scripts.diginorm_cases, "
            "khmer_tpu_torch.scripts.peak_rss, "
            "khmer_tpu_torch.core.pipeline, khmer_tpu_torch.ops.cuda, "
            "khmer_tpu_torch.scripts.pallas_proto, "
            "khmer_tpu_torch.scripts.profile_scatter2, "
            "khmer_tpu_torch.scripts.pertable_cases, "
            "khmer_tpu_torch.ops.cyclic, khmer_tpu_torch.core.blocked, "
            "khmer_tpu_torch.core.hostengine, "
            "khmer_tpu_torch.scripts.family_cases; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib', 'khmer_tpu.'))"
            " or m == 'khmer_tpu']; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _single_case(tmp_path, reads, out_name):
    """abundance-dist-single through each package, in its own directory,
    with output `out_name`: {side: (status, the output's bytes or None)}."""
    args = ["-k", "20", "-x", "1e4", "-N", "2", "-f", reads, out_name]
    got = {}
    for side in ("port", "jax"):
        d = tmp_path / side
        d.mkdir()
        old = os.getcwd()
        os.chdir(d)
        try:
            if side == "port":
                try:
                    abundance_dist_single.main(args + ["--device", "cpu"])
                    status = 0
                except SystemExit as exc:
                    status = exc.code or 0
            else:
                status, _, _ = runscript("abundance-dist-single.py", args,
                                         fail_ok=True)
        finally:
            os.chdir(old)
        out = d / out_name
        got[side] = (status, out.read_bytes() if out.exists() else None)
    return got


def test_abundance_dist_single_dash_is_a_file_as_in_jax(tmp_path):
    """'-' names a file of that name, opened before counting, as the JAX
    CLI opens it (khmer_tpu/cli/abundance_dist_single.py:86-95)."""
    reads = str(tmp_path / "reads.fa")
    with gzip.open(DATA, "rt") as src, open(reads, "w") as dst:
        for i, rec in enumerate(itertools.islice(zip(*[src] * 4), 300)):
            dst.write(">%d\n%s" % (i, rec[1]))
    got = _single_case(tmp_path, reads, "-")
    assert got["port"] == got["jax"]
    status, blob = got["port"]
    assert status == 0 and blob.startswith(b"abundance,count,cumulative,")
    assert blob.count(b"\n") > 2


def test_abundance_dist_single_all_short_reads_leaves_the_header(tmp_path):
    """Every read shorter than k: the distribution is all zero, the CLI
    exits 1 and the output holds the header row alone, as in JAX."""
    reads = str(tmp_path / "short.fa")
    with open(reads, "w") as f:
        for i in range(50):
            f.write(">%d\n%s\n" % (i, "ACGTTGCA"[: 3 + i % 5] * 2))
    got = _single_case(tmp_path, reads, "out.hist")
    assert got["port"] == got["jax"] == (
        1, b"abundance,count,cumulative,cumulative_fraction\r\n")
