"""The port's make-initial-stoptags, find-knots, filter-stoptags and
extract-partitions against the JAX CLIs, on the CPU: every output file
byte for byte (.stoptags, .stopfilt, the group files, .dist, the
unassigned reads, the renamed .pmap files), the exit status and the
messages on stderr. The knot CLIs are held to JAX's native engine
(KHMER_TPU_ENGINE=auto), whose queue walks the port follows (JAX's level
engine gives the same stop tags on these inputs, tests/test_torch_knots.py,
but takes minutes); filter-stoptags and extract-partitions use no sketch
and are held to both engines. Inputs: reads of four genomes that share
repeats (one partition with knots; tests/test_torch_knots.py lump_reads),
their FASTQ with N and lowercase bases, and files this module builds from
them with the port's own CLIs; each run in a directory of its own. The
file system's order of the .pmap files that find-knots globs is made
sorted for both packages."""

import contextlib
import glob
import importlib
import io
import os
import shutil
import sys
import traceback

import numpy as np
import pytest
import torch

from khmer_tpu_torch.cli import (do_partition, load_graph,
                                 make_initial_stoptags, partition_graph)
from khmer_tpu_torch.ops import host

from .test_torch_knots import lump_reads

# six xdist workers share the cores: one intra-op thread each
torch.set_num_threads(1)

TABLES = ["-k", "20", "-x", "2e5", "-N", "4"]
COUNTING = ["-x", "3e4", "-N", "4"]


@pytest.fixture(scope="module", autouse=True)
def _two_walk_threads():
    """Two threads a walk pass: the workers share the cores."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(host, "walk_threads", lambda: 2)
        yield


def _sorted_glob(real):
    return lambda pattern, *a, **kw: sorted(real(pattern, *a, **kw))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """lump.fa (the lump's reads), clean.fq (some of them as FASTQ with N
    and lowercase bases, and a short one), mixed.fq (the same and a read
    with no name); graph,
    graph.tagset (the port's load-graph of lump.fa); graph.subset.0-1.pmap
    (its partition-graph in two subsets, the default walk: one lump);
    prior.stoptags (the port's make-initial-stoptags on the first 150
    tags); st.subset.0-1.pmap
    (partition-graph -S prior.stoptags); lump.fa.part, clean.fq.part (the
    port's do-partition --no-big-traverse of both files)."""
    d = tmp_path_factory.mktemp("inputs")
    seqs = lump_reads(17)
    (d / "lump.fa").write_text("".join(">r%d\n%s\n" % (i, s)
                                       for i, s in enumerate(seqs)))
    rng = np.random.default_rng(4)
    fq = []
    for i, s in enumerate(seqs[:150]):
        s = list(s)
        if i % 3 == 0:
            s[int(rng.integers(0, len(s)))] = "N"
        s = "".join(s[:30]).lower() + "".join(s[30:])
        fq.append("@q%d\n%s\n+\n%s\n" % (i, s, "I" * len(s)))
    fq.append("@short\nACGTACGT\n+\nIIIIIIII\n")
    (d / "clean.fq").write_text("".join(fq))
    fq.append("@\n%s\n+\n%s\n" % (seqs[5], "I" * len(seqs[5])))
    (d / "mixed.fq").write_text("".join(fq))
    real = glob.glob
    with contextlib.redirect_stderr(io.StringIO()), \
            pytest.MonkeyPatch.context() as mp:
        mp.setattr(glob, "glob", _sorted_glob(real))
        cwd = os.getcwd()
        os.chdir(d)
        try:
            load_graph.main(TABLES + ["--device", "cpu", "graph",
                                      "lump.fa"])
            partition_graph.main(["-s", "600", "--device", "cpu", "graph"])
            make_initial_stoptags.main(["-k", "20", "-s", "150"] + COUNTING
                                       + ["--device", "cpu", "graph"])
            os.rename("graph.stoptags", "prior.stoptags")
            for ext in ("", ".tagset"):
                shutil.copy("graph" + ext, "st" + ext)
            partition_graph.main(["-s", "600", "-S", "prior.stoptags",
                                  "--device", "cpu", "st"])
            do_partition.main(TABLES + ["--no-big-traverse", "--device",
                                        "cpu", "dp", "lump.fa", "clean.fq"])
        finally:
            os.chdir(cwd)
    return d


PORT = {"initial": "khmer_tpu_torch.cli.make_initial_stoptags",
        "knots": "khmer_tpu_torch.cli.find_knots",
        "filter": "khmer_tpu_torch.cli.filter_stoptags",
        "extract": "khmer_tpu_torch.cli.extract_partitions"}
JAX = {"initial": "khmer_tpu.cli.make_initial_stoptags",
       "knots": "khmer_tpu.cli.find_knots",
       "filter": "khmer_tpu.cli.filter_stoptags",
       "extract": "khmer_tpu.cli.extract_partitions"}
DEVICE = ("initial", "knots")  # the CLIs that take --device
BOTH = ("device", "auto")
AUTO = ("auto",)
PMAPS = ["graph.subset.0.pmap", "graph.subset.1.pmap"]
ST_PMAPS = ["st.subset.0.pmap", "st.subset.1.pmap"]
GRAPH = ["graph", "graph.tagset"]
ST = ["st", "st.tagset"]

# name -> (script, arguments, inputs linked, inputs copied (the run
# renames or rewrites them), outputs compared byte for byte, the JAX
# engines to hold it to)
CASES = {
    "initial": ("initial", ["-k", "20"] + COUNTING + ["graph"], GRAPH, [],
                ["graph.stoptags"], AUTO),
    "initial-subset": ("initial", ["-k", "20", "-s", "500"] + COUNTING
                       + ["graph"], GRAPH, [], ["graph.stoptags"], AUTO),
    "initial-prior": ("initial", ["-k", "20", "-S", "prior.stoptags"]
                      + COUNTING + ["graph"], GRAPH + ["prior.stoptags"],
                      [], ["graph.stoptags"], AUTO),
    "knots": ("knots", COUNTING + ["graph"], GRAPH, PMAPS,
              ["graph.stoptags"] + [p + ".processed" for p in PMAPS], AUTO),
    "knots-stoptags": (
        "knots", COUNTING + ["st"], ST, ST_PMAPS + ["st.stoptags"],
        ["st.stoptags"] + [p + ".processed" for p in ST_PMAPS], AUTO),
    "filter": ("filter", ["-k", "20", "prior.stoptags", "lump.fa",
                          "mixed.fq"], ["prior.stoptags", "lump.fa",
                                        "mixed.fq"], [],
               ["lump.fa.stopfilt", "mixed.fq.stopfilt"], BOTH),
    "filter-wrong-k": ("filter", ["-k", "21", "prior.stoptags", "lump.fa"],
                       ["prior.stoptags", "lump.fa"], [], [], BOTH),
    "extract": ("extract", ["out", "lump.fa.part"], ["lump.fa.part"], [],
                ["out.dist", "out.group0000.fa"], BOTH),
    "extract-groups": ("extract", ["-X", "150", "-m", "2", "-U", "out",
                                   "lump.fa.part", "clean.fq.part"],
                       ["lump.fa.part", "clean.fq.part"], [],
                       ["out.dist", "out.unassigned.fa"]
                       + ["out.group%04d.fa" % i for i in range(7)], BOTH),
    "extract-fastq": ("extract", ["-m", "0", "q", "clean.fq.part"],
                      ["clean.fq.part"], [],
                      ["q.dist", "q.group0000.fq"], BOTH),
    "extract-no-groups": ("extract", ["-n", "out", "lump.fa.part"],
                          ["lump.fa.part"], [], ["out.dist"], BOTH),
}
STATUS = {"filter-wrong-k": -1}


def _run(module, args, cwd):
    """A CLI's main() in this process, in `cwd` (an uncaught exception is
    status -1), the .pmap files it globs in sorted order: (status,
    stderr)."""
    mod = importlib.import_module(module)
    saved = sys.argv, sys.stderr, os.getcwd(), glob.glob
    err = io.StringIO()
    sys.argv = [module] + args
    sys.stderr = err
    glob.glob = _sorted_glob(saved[3])
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
        glob.glob = saved[3]
        os.chdir(saved[2])
    return status, err.getvalue()


def _run_dir(inputs, tmp_path_factory, name, label):
    _, _, linked, copied, _, _ = CASES[name]
    d = tmp_path_factory.mktemp(label)
    for f in linked:
        os.symlink(inputs / f, d / f)
    for f in copied:
        target = f.replace("st.stoptags", "prior.stoptags")
        shutil.copy(inputs / target, d / f)
    return d


def _messages(err):
    """stderr below the banner (whose lines name the package), and the
    last line of a traceback."""
    lines = [line for line in err.splitlines() if not line.startswith("||")]
    if "Traceback (most recent call last):" in lines:
        cut = lines.index("Traceback (most recent call last):")
        lines = lines[:cut] + lines[-1:]
    return lines


@pytest.fixture(scope="module")
def port_runs(inputs, tmp_path_factory):
    """Each case through the port once: {name: (dir, status, stderr)}."""
    runs = {}

    def get(name):
        if name not in runs:
            script, args = CASES[name][:2]
            if script in DEVICE:
                args = args + ["--device", "cpu"]
            d = _run_dir(inputs, tmp_path_factory, name, "port-" + name)
            runs[name] = (d,) + _run(PORT[script], args, d)
        return runs[name]

    return get


@pytest.mark.parametrize("name,engine", [
    (name, engine) for name in CASES for engine in CASES[name][5]])
def test_knot_cli_matches_jax(name, engine, inputs, port_runs,
                              tmp_path_factory, monkeypatch):
    script, args, _, _, outputs, _ = CASES[name]
    port_dir, status, err = port_runs(name)
    monkeypatch.setenv("KHMER_TPU_ENGINE", engine)
    jax_dir = _run_dir(inputs, tmp_path_factory, name,
                       "jax-%s-%s" % (engine, name))
    j_status, j_err = _run(JAX[script], args, jax_dir)
    assert status == j_status == STATUS.get(name, 0), err + j_err
    assert _messages(err) == _messages(j_err)
    for f in outputs:
        assert (port_dir / f).read_bytes() == (jax_dir / f).read_bytes(), f
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(jax_dir))


def test_knot_cli_cases_reach_their_paths(port_runs):
    """The runs find stop tags (find-knots more than the initial set it
    starts from), trim and drop reads, repartition to a size, and write
    several groups."""
    import struct

    def n_stoptags(path):
        with open(path, "rb") as f:
            return struct.unpack("<Q", f.read(18)[10:18])[0]

    d, _, _ = port_runs("initial-prior")
    first = n_stoptags(d / "prior.stoptags")
    assert n_stoptags(d / "graph.stoptags") > first
    d, _, err = port_runs("knots-stoptags")
    assert n_stoptags(d / "st.stoptags") > first > 0
    assert "** repartitioned size:" in err
    d, _, err = port_runs("knots")
    assert n_stoptags(d / "graph.stoptags") > 0
    assert not (d / PMAPS[0]).exists()
    d, _, _ = port_runs("filter")
    kept = (d / "lump.fa.stopfilt").read_text().count(">")
    assert 0 < kept < 1500
    assert "\n>q" in "\n" + (d / "mixed.fq.stopfilt").read_text()
    d, _, err = port_runs("extract-groups")
    assert "7 groups" in err and (d / "out.group0006.fa").stat().st_size


def test_port_knot_clis_default_to_the_card(inputs, tmp_path):
    """Without --device the graph is loaded onto the card, which raises
    where there is none (no fall back to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for script, files in (("initial", GRAPH), ("knots", GRAPH)):
        for f in files:
            os.symlink(inputs / f, tmp_path / f)
        status, err = _run(PORT[script], COUNTING + ["graph"], tmp_path)
        assert status == -1 and "CUDA" in err
        for f in files:
            os.unlink(tmp_path / f)
