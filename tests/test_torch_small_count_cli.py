"""The seven ported CLIs that take --small-count (a SmallCountgraph: 4-bit
counters, two a byte, OXLI type 7), run by the port on the CPU
(--device cpu), against the JAX CLIs under both of their engines
(KHMER_TPU_ENGINE=device; =auto, the native host tier): the .ct and
.info of load-into-counting, the histogram of abundance-dist-single, the
.abundfilt of filter-abund-single, the .keep and -s .ct of
normalize-by-median, the .abundtrim, -s .ct and summary of
trim-low-abund (with and without -V), byte for byte, with the exit status
and the unique-k-mers line; the .stoptags of make-initial-stoptags and
find-knots (held to JAX's native engine, whose queue walks the port
follows, tests/test_torch_knots_cli.py), also with counting tables so
small that counters reach 15 within a traversal's adds; and the CLIs
that load a .ct without --small-count (abundance-dist, filter-abund,
count-median, normalize-by-median --loadgraph) refusing a type-7 file as
JAX's do, where trim-low-abund --loadgraph takes it. Inputs: the first
5,000 reads of data/stamps-reads.fa.gz, the first 2,000 of
data/25k.fq.gz, and files this module builds from them with the port's
own CLIs; each run in a directory of its own."""

import contextlib
import gzip
import importlib
import io
import itertools
import os
import re
import shutil
import sys
import traceback

import numpy as np
import pytest
import torch

from khmer_tpu_torch.cli import (load_graph, load_into_counting,
                                 partition_graph)
from khmer_tpu_torch.ops import host

# six xdist workers share the cores: one intra-op thread each
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAMPS = os.path.join(REPO, "data", "stamps-reads.fa.gz")
READS25K = os.path.join(REPO, "data", "25k.fq.gz")
TABLES = ["-k", "20", "-x", "1e5", "-N", "4", "--small-count"]
SMALL = ["--small-count"]


@pytest.fixture(scope="module", autouse=True)
def _two_walk_threads():
    """Two threads a walk pass: the workers share the cores."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(host, "walk_threads", lambda: 2)
        yield


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """head.fa (5,000 stamps reads), deep.fa (25 copies of 400 of them, a
    base changed in 30% of the copies: coverage past 20), long.fa (100-base
    reads of a 6,000-base genome, a read of 5,000 bases among them),
    reads.fq (2,000 reads of data/25k.fq.gz); small.ct (the port's
    load-into-counting --small-count of head.fa: OXLI type 7); graph,
    graph.tagset (the port's load-graph -k 20 -x 2e5 -N 4 of head.fa) and
    graph.subset.0.pmap (its partition-graph)."""
    d = tmp_path_factory.mktemp("inputs")
    with gzip.open(STAMPS, "rt") as src:
        lines = list(itertools.islice(src, 10000))
    (d / "head.fa").write_text("".join(lines))
    rng = np.random.default_rng(77)
    deep = []
    for copy in range(25):
        for i, s in enumerate(lines[1:800:2]):
            s = list(s.strip())
            if rng.random() < 0.3:
                s[int(rng.integers(0, len(s)))] = "ACGT"[copy % 4]
            deep.append(">d%d.%d\n%s\n" % (i, copy, "".join(s)))
    order = rng.permutation(len(deep))
    (d / "deep.fa").write_text("".join(deep[j] for j in order))
    genome = "".join(rng.choice(list("ACGT"), 6000))
    reads = []
    for i in range(400):
        s = int(rng.integers(0, 5900))
        reads.append(">g%d\n%s\n" % (i, genome[s:s + 100]))
    reads.insert(150, ">long\n%s\n" % genome[500:5500])
    (d / "long.fa").write_text("".join(reads))
    with gzip.open(READS25K, "rt") as src:
        (d / "reads.fq").write_text("".join(itertools.islice(src, 8000)))
    cwd = os.getcwd()
    os.chdir(d)
    try:
        with contextlib.redirect_stderr(io.StringIO()):
            load_into_counting.main(TABLES + ["--device", "cpu", "small.ct",
                                              "head.fa"])
            load_graph.main(["-k", "20", "-x", "2e5", "-N", "4", "--device",
                             "cpu", "graph", "head.fa"])
            partition_graph.main(["--device", "cpu", "graph"])
    finally:
        os.chdir(cwd)
    return d


SCRIPTS = {"load": "load_into_counting", "single": "abundance_dist_single",
           "filter-single": "filter_abund_single",
           "normalize": "normalize_by_median", "trim": "trim_low_abund",
           "initial": "make_initial_stoptags", "knots": "find_knots",
           "dist": "abundance_dist", "filter": "filter_abund",
           "median": "count_median"}
BOTH = ("device", "auto")
AUTO = ("auto",)
GRAPH = ["graph", "graph.tagset"]

# name -> (script, arguments (inputs by their names in the run's
# directory), inputs copied (the run renames or rewrites them), outputs
# compared byte for byte, the JAX engines to hold it to)
CASES = {
    "load": ("load", TABLES + ["-s", "json", "out.ct", "head.fa"], [],
             ["out.ct", "out.ct.info", "out.ct.info.json"], BOTH),
    "load-saturated-fastq": (
        "load", ["-k", "20", "-x", "3e3", "-N", "4", "--small-count", "-f",
                 "out.ct", "reads.fq", "head.fa"], [],
        ["out.ct", "out.ct.info"], BOTH),
    "single": ("single", TABLES + ["--savegraph", "out.ct", "reads.fq",
                                  "out.dist"],
               [], ["out.dist", "out.ct"], BOTH),
    "single-zero-saturated": (
        "single", ["-k", "20", "-x", "4e3", "-N", "2", "--small-count",
                   "-z", "-f", "head.fa", "out.dist"], [], ["out.dist"],
        BOTH),
    "filter-single": (
        "filter-single", TABLES + ["-C", "2", "-f", "--savegraph", "out.ct",
                                   "reads.fq"],
        [], ["reads.fq.abundfilt", "out.ct"], BOTH),
    "filter-single-variable-coverage": (
        "filter-single", TABLES + ["-V", "-Z", "5", "-C", "3", "-f", "-o",
                                   "out.fa", "head.fa"], [], ["out.fa"],
        BOTH),
    "normalize": ("normalize", TABLES + ["-C", "5", "-s", "out.ct",
                                         "head.fa"], [],
                  ["head.fa.keep", "out.ct"], BOTH),
    "normalize-C15-fastq": (
        "normalize", TABLES + ["-C", "15", "reads.fq"], [],
        ["reads.fq.keep"], BOTH),
    "normalize-loadgraph": ("normalize", ["-l", "small.ct", "-C", "5",
                                          "head.fa"], [], [], BOTH),
    "trim": ("trim", TABLES + ["-C", "2", "-s", "out.ct", "--summary-info",
                               "json", "deep.fa"], [],
             ["deep.fa.abundtrim", "out.ct", "deep.fa.info.json"], BOTH),
    "trim-variable-coverage": (
        "trim", TABLES + ["-V", "-Z", "10", "-C", "3", "--summary-info",
                          "tsv", "deep.fa"], [],
        ["deep.fa.abundtrim", "deep.fa.info.tsv"], BOTH),
    "trim-diginorm": ("trim", TABLES + ["--diginorm", "--diginorm-coverage",
                                        "8", "-s", "out.ct", "reads.fq"],
                      [], ["reads.fq.abundtrim", "out.ct"], BOTH),
    "trim-loadgraph": ("trim", ["-l", "small.ct", "-C", "3", "-s", "out.ct",
                                "reads.fq"], [],
                       ["reads.fq.abundtrim", "out.ct"], BOTH),
    # the JAX device engine cannot take a read over 4096 bases (its window
    # rows hold at most 4096 codes: ValueError)
    "normalize-long-read": ("normalize", TABLES + ["-C", "3", "-s", "out.ct",
                                                   "long.fa"], [],
                            ["long.fa.keep", "out.ct"], AUTO),
    "trim-long-read": ("trim", TABLES + ["-V", "-Z", "3", "-s", "out.ct",
                                         "long.fa"], [],
                       ["long.fa.abundtrim", "out.ct"], AUTO),
    "initial": ("initial", ["-k", "20", "-x", "2e5", "-N", "4"] + SMALL
                + ["graph"], [], ["graph.stoptags"], AUTO),
    "initial-saturated": ("initial", ["-k", "20", "-x", "3e3", "-N", "4"]
                          + SMALL + ["graph"], [], ["graph.stoptags"], AUTO),
    "knots": ("knots", ["-x", "2e5", "-N", "4"] + SMALL + ["graph"],
              ["graph.subset.0.pmap"],
              ["graph.stoptags", "graph.subset.0.pmap.processed"], AUTO),
    "knots-saturated": ("knots", ["-x", "3e3", "-N", "4"] + SMALL
                        + ["graph"], ["graph.subset.0.pmap"],
                        ["graph.stoptags", "graph.subset.0.pmap.processed"],
                        AUTO),
    "dist-refuses-type-7": ("dist", ["small.ct", "head.fa", "out.hist"], [],
                            [], BOTH),
    "filter-refuses-type-7": ("filter", ["small.ct", "head.fa"], [], [],
                              BOTH),
    "median-refuses-type-7": ("median", ["small.ct", "head.fa", "out.csv"],
                              [], [], BOTH),
}
# an uncaught exception is status -1: a loader given a type-7 file raises
STATUS = {"normalize-loadgraph": -1, "dist-refuses-type-7": -1,
          "filter-refuses-type-7": -1, "median-refuses-type-7": -1}
LINKED = ["head.fa", "deep.fa", "long.fa", "reads.fq", "small.ct"] + GRAPH


def _run(module, args, cwd):
    """A CLI's main() in this process, in `cwd` (an uncaught exception is
    status -1): (status, stderr)."""
    mod = importlib.import_module(module)
    saved = sys.argv, sys.stderr, os.getcwd()
    err = io.StringIO()
    sys.argv = [module] + args
    sys.stderr = err
    os.chdir(cwd)
    try:
        try:
            mod.main()
            status = 0
        except SystemExit as exc:
            status = exc.code or 0
        except Exception:  # pylint: disable=broad-except
            traceback.print_exc(file=err)
            status = -1
    finally:
        sys.argv, sys.stderr = saved[:2]
        os.chdir(saved[2])
    return status, err.getvalue()


def _run_dir(inputs, tmp_path_factory, name, label):
    d = tmp_path_factory.mktemp(label)
    for f in LINKED:
        os.symlink(inputs / f, d / f)
    for f in CASES[name][2]:
        shutil.copy(inputs / f, d / f)
    return d


def _unique_line(err):
    return re.findall(r"Total number of unique k-mers: \d+", err)


def _last_error(err):
    """The last line of a traceback (the exception and its message)."""
    lines = err.strip().splitlines()
    return lines[-1] if "Traceback" in err else None


@pytest.fixture(scope="module")
def port_runs(inputs, tmp_path_factory):
    """Each case through the port once: {name: (dir, status, stderr)}."""
    runs = {}

    def get(name):
        if name not in runs:
            script, args = CASES[name][:2]
            d = _run_dir(inputs, tmp_path_factory, name, "port-" + name)
            runs[name] = (d,) + _run(
                "khmer_tpu_torch.cli." + SCRIPTS[script],
                args + ["--device", "cpu"], d)
        return runs[name]

    return get


@pytest.mark.parametrize("name,engine", [
    (name, engine) for name in CASES for engine in CASES[name][4]])
def test_small_count_cli_matches_jax(name, engine, inputs, port_runs,
                                     tmp_path_factory, monkeypatch):
    script, args, _, outputs, _ = CASES[name]
    port_dir, status, err = port_runs(name)
    monkeypatch.setenv("KHMER_TPU_ENGINE", engine)
    jax_dir = _run_dir(inputs, tmp_path_factory, name,
                       "jax-%s-%s" % (engine, name))
    j_status, j_err = _run("khmer_tpu.cli." + SCRIPTS[script], args,
                           jax_dir)
    assert status == j_status == STATUS.get(name, 0), err + j_err
    assert _unique_line(err) == _unique_line(j_err)
    assert _last_error(err) == _last_error(j_err)
    for out in outputs:
        assert (port_dir / out).read_bytes() == \
            (jax_dir / out).read_bytes(), out
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(jax_dir))


def test_small_count_runs_reach_their_paths(port_runs):
    """The .ct files are type 7 with counters at 15; the runs keep,
    trim and drop some reads; the knot runs find stop tags; the refusals
    name the type-7 file."""
    import struct

    for name in ("load", "load-saturated-fastq", "normalize", "trim"):
        d, status, _ = port_runs(name)
        blob = (d / "out.ct").read_bytes()
        assert status == 0 and blob[:6] == b"OXLI\x04\x07"
    d, _, _ = port_runs("load-saturated-fastq")
    assert b"\xff" in (d / "out.ct").read_bytes()
    # a nibble saturates at 15, so at the default -Z 20 pass 1 keeps every
    # read aside; at -Z 10 it trims some
    d, _, err = port_runs("trim")
    assert "kept aside 10000 of 10000" in err
    assert re.search(r"trimmed [1-9]\d* reads", err)
    d, _, err = port_runs("trim-variable-coverage")
    kept = int(re.search(r"kept aside (\d+) of 10000", err).group(1))
    assert 0 < kept < 10000 and re.search(r"trimmed [1-9]\d* reads", err)
    d, _, _ = port_runs("normalize")
    assert 0 < (d / "head.fa.keep").read_bytes().count(b">") < 5000

    def n_stoptags(path):
        with open(path, "rb") as f:
            return struct.unpack("<Q", f.read(18)[10:18])[0]

    for name in ("initial", "initial-saturated", "knots",
                 "knots-saturated"):
        d, status, _ = port_runs(name)
        assert status == 0 and n_stoptags(d / "graph.stoptags") > 0, name
    for name in ("dist-refuses-type-7", "filter-refuses-type-7",
                 "median-refuses-type-7", "normalize-loadgraph"):
        _, status, err = port_runs(name)
        assert status == -1 and "Incorrect file format type 7" in err, name


def test_small_count_knots_saturate_within_a_traversal(inputs, monkeypatch,
                                                       tmp_path):
    """make-initial-stoptags on the tiny counting tables (case
    initial-saturated, held to JAX above) evaluates batches whose base
    counters already stand at 15, in batches of four tags, so that the
    adds of a batch's earlier traversals go onto counters at 15; the
    evaluation is told that a counter saturates there (its saturation
    with a byte table's 255 gives other stop tags:
    tests/test_torch_nibble.py)."""
    from khmer_tpu_torch.core import partition as P

    seen = []
    evaluate = host.ExcursionWalk.evaluate

    def watched(self, base, primes, threshold, frequency, saturation=255):
        seen.append((int(base.max()) if base.size else 0, saturation))
        return evaluate(self, base, primes, threshold, frequency,
                        saturation)

    monkeypatch.setattr(host.ExcursionWalk, "evaluate", watched)
    monkeypatch.setattr(P, "REPART_BATCH", 4)
    for f in GRAPH:
        os.symlink(inputs / f, tmp_path / f)
    status, err = _run("khmer_tpu_torch.cli.make_initial_stoptags",
                       CASES["initial-saturated"][1] + ["--device", "cpu"],
                       tmp_path)
    assert status == 0, err
    assert seen and {s for _, s in seen} == {15}
    assert max(b for b, _ in seen) == 15
