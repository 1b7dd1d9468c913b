"""The port's do-partition, partition-graph, merge-partitions and
annotate-partitions (``--device cpu``) against the JAX CLIs under both of
their engines (KHMER_TPU_ENGINE=auto, the native host tier, whose queue
walk the port follows; =device, the level walk): every output file byte
for byte (.info, the .subset.N.pmap files, the .pmap.merged, the .part),
the exit status and the messages on stderr. The level walk cuts some big
traversals that the queue walk lets finish (tests/test_torch_partition.py
test_walk_where_jax_engines_differ): where the two JAX engines write
different bytes, the port writes the native engine's.
Where a run merges several subsets, the files' partition ids follow the
order glob lists them in, so the merged map and the .part are compared
with their ids renamed by first appearance (JAX's and the port's alike),
and the messages as a set of lines. Inputs: the first 2,000 reads of
data/stamps-reads.fa.gz and seeded reads of two genomes, with files this
module builds from them; each run in a directory of its own that links
them."""

import contextlib
import gzip
import importlib
import io
import itertools
import os
import shutil
import struct
import sys
import traceback

import numpy as np
import pytest
import torch

from khmer_tpu.core import oxli_io as jax_oxli
from khmer_tpu_torch.cli import load_graph, merge_partitions, partition_graph
from khmer_tpu_torch.ops import host

# six xdist workers share the cores: one intra-op thread each
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAMPS = os.path.join(REPO, "data", "stamps-reads.fa.gz")
TABLES = ["-k", "20", "-x", "2e6", "-N", "4"]
INPUTS = ("head.fa", "seeded.fa", "mixed.fq", "graph", "graph.tagset",
          "graph.stoptags", "sub", "sub.tagset", "sub.subset.0.pmap",
          "sub.subset.1.pmap", "sub.subset.2.pmap", "sub.pmap.merged")


@pytest.fixture(scope="module", autouse=True)
def _two_walk_threads():
    """Two threads a walk pass: the workers share the cores."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(host, "walk_threads", lambda: 2)
        yield


def _seeded(rng, n, genome_len, length=100):
    genome = rng.integers(0, 4, genome_len)
    out = []
    for _ in range(n):
        s = int(rng.integers(0, genome_len - length))
        r = genome[s:s + length].copy()
        hit = rng.random(length) < 0.01
        r[hit] = rng.integers(0, 4, int(hit.sum()))
        out.append("".join("ACGT"[c] for c in r))
    return out


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """head.fa (2,000 stamps reads), seeded.fa (reads of a deeply and a
    thinly covered genome, some shorter than k), mixed.fq (their FASTQ
    with N and lowercase bases); graph, graph.tagset (the port's
    load-graph of seeded.fa) and graph.stoptags (every fifth tag, written
    by JAX); sub, a copy of graph, partitioned by the port's
    partition-graph into three subsets, and sub.pmap.merged, their merge
    by the port's merge-partitions."""
    d = tmp_path_factory.mktemp("inputs")
    with gzip.open(STAMPS, "rt") as src:
        (d / "head.fa").write_text("".join(itertools.islice(src, 4000)))
    rng = np.random.default_rng(1515)
    seqs = _seeded(rng, 300, 3000) + _seeded(rng, 120, 8000)
    for i in range(0, len(seqs), 29):
        seqs[i] = seqs[i][:int(rng.integers(1, 19))]
    (d / "seeded.fa").write_text("".join(">s%d\n%s\n" % (i, s)
                                         for i, s in enumerate(seqs)))
    fq = []
    for i, s in enumerate(seqs[:200]):
        s = list(s)
        for j in rng.choice(len(s), min(len(s), 2), replace=False):
            s[j] = "N"
        s = "".join(s[:20]).lower() + "".join(s[20:])
        fq.append("@q%d\n%s\n+\n%s\n" % (i, s, "I" * len(s)))
    (d / "mixed.fq").write_text("".join(fq))
    with contextlib.redirect_stderr(io.StringIO()):
        load_graph.main(TABLES + ["--device", "cpu", str(d / "graph"),
                                  str(d / "seeded.fa")])
        for ext in ("", ".tagset"):
            shutil.copy(d / ("graph" + ext), d / ("sub" + ext))
        partition_graph.main(["-s", "150", "--no-big-traverse", "--device",
                              "cpu", str(d / "sub")])
        merge_partitions.main(["-k", "20", "--keep-subsets", "--device",
                               "cpu", str(d / "sub")])
    from khmer_tpu_torch.core import oxli_io

    tags, _ = oxli_io.load_tagset(str(d / "graph.tagset"))
    jax_oxli.save_stoptags(str(d / "graph.stoptags"), 20,
                           sorted(tags)[::5])
    return d


PORT = {"do": "khmer_tpu_torch.cli.do_partition",
        "partition": "khmer_tpu_torch.cli.partition_graph",
        "merge": "khmer_tpu_torch.cli.merge_partitions",
        "annotate": "khmer_tpu_torch.cli.annotate_partitions"}
JAX = {"do": "khmer_tpu.cli.do_partition",
       "partition": "khmer_tpu.cli.partition_graph",
       "merge": "khmer_tpu.cli.merge_partitions",
       "annotate": "khmer_tpu.cli.annotate_partitions"}
BOTH = ("device", "auto")
# JAX's level walk takes minutes on the stamps reads
AUTO = ("auto",)
SUBSETS = ["g.subset.%d.pmap" % i for i in range(6)]

# name -> (script, arguments, outputs compared byte for byte, outputs
# compared with their ids renamed, files the run must remove, the JAX
# engines to hold it to)
CASES = {
    "do-stamps-no-big-traverse": (
        "do", TABLES + ["--no-big-traverse", "--keep-subsets", "g",
                        "head.fa"],
        ["g.info", "g.subset.0.pmap", "head.fa.part"], [], [], AUTO),
    "do-stamps-default": (
        "do", TABLES + ["g", "head.fa"], ["g.info", "head.fa.part"], [],
        ["g.subset.0.pmap"], AUTO),
    "do-seeded-subsets": (
        "do", TABLES + ["-s", "120", "--no-big-traverse", "--keep-subsets",
                        "g", "seeded.fa", "mixed.fq"],
        ["g.info"] + SUBSETS, ["seeded.fa.part", "mixed.fq.part"], [], BOTH),
    "do-table-too-small": (
        "do", ["-k", "20", "-x", "3e3", "-N", "4", "g", "seeded.fa"], [],
        [], [], BOTH),
    "partition": ("partition", ["-s", "150", "graph"],
                  ["graph.info", "graph.subset.0.pmap",
                   "graph.subset.1.pmap", "graph.subset.2.pmap"], [], [],
                  BOTH),
    "partition-stoptags": (
        "partition", ["--stoptags", "graph.stoptags", "--no-big-traverse",
                      "graph"], ["graph.info", "graph.subset.0.pmap"], [],
        [], BOTH),
    "merge": ("merge", ["-k", "20", "sub"], [], ["sub.pmap.merged"],
              ["sub.subset.0.pmap", "sub.subset.1.pmap",
               "sub.subset.2.pmap"], BOTH),
    "annotate": ("annotate", ["-k", "20", "sub", "seeded.fa", "mixed.fq",
                              "head.fa"],
                 ["seeded.fa.part", "mixed.fq.part", "head.fa.part"], [],
                 [], BOTH),
    "annotate-no-pmap": ("annotate", ["-k", "20", "graph", "seeded.fa"],
                         [], [], [], BOTH),
}
STATUS = {"do-table-too-small": 1, "annotate-no-pmap": 1}


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


def _run_dir(inputs, tmp_path_factory, label):
    d = tmp_path_factory.mktemp(label)
    for name in INPUTS:
        if name.startswith("sub.subset"):
            shutil.copy(inputs / name, d / name)  # merge removes them
        else:
            os.symlink(inputs / name, d / name)
    return d


def _messages(err):
    """stderr below the banner (whose lines name the package)."""
    return [line for line in err.splitlines() if not line.startswith("||")]


def _renamed(name, blob):
    """A .part's or a .pmap's bytes with partition ids renamed 1, 2, ...
    by first appearance (reads in order; tags ascending)."""
    ids = {}

    def rename(pid):
        if pid == 0:
            return 0
        return ids.setdefault(pid, len(ids) + 1)

    if name.endswith(".part"):
        out = []
        for line in blob.split(b"\n"):
            if line[:1] in (b">", b"@") and b"\t" in line:
                head, pid = line.rsplit(b"\t", 1)
                line = head + b"\t%d" % rename(int(pid))
            out.append(line)
        return b"\n".join(out)
    rec = np.frombuffer(blob[18:], dtype=[("tag", "<u8"), ("pid", "<u4")])
    assert (np.diff(rec["tag"].astype(np.float64)) > 0).all()
    pids = np.array([rename(int(p)) for p in rec["pid"]], "<u4")
    out = rec.copy()
    out["pid"] = pids
    return blob[:18] + out.tobytes()


@pytest.fixture(scope="module")
def port_runs(inputs, tmp_path_factory):
    """Each case through the port once: {name: (dir, status, stderr)}."""
    runs = {}

    def get(name):
        if name not in runs:
            script, args = CASES[name][:2]
            d = _run_dir(inputs, tmp_path_factory, "port-" + name)
            runs[name] = (d,) + _run(PORT[script],
                                     args + ["--device", "cpu"], d)
        return runs[name]

    return get


def _jax_run(name, engine, inputs, tmp_path_factory, monkeypatch):
    script, args = CASES[name][:2]
    monkeypatch.setenv("KHMER_TPU_ENGINE", engine)
    d = _run_dir(inputs, tmp_path_factory, "jax-%s-%s" % (engine, name))
    return (d,) + _run(JAX[script], args, d)


def _outputs(name, d, err):
    """A run's messages and outputs, renamed where the case says so."""
    _, _, same, renamed, _, _ = CASES[name]
    msgs = _messages(err)
    out = {"messages": sorted(msgs) if renamed else msgs}
    for f in same:
        out[f] = (d / f).read_bytes()
    for f in renamed:
        out[f] = _renamed(f, (d / f).read_bytes())
    return out


@pytest.mark.parametrize("name,engine", [
    (name, engine) for name in CASES for engine in CASES[name][5]])
def test_partition_cli_matches_jax(name, engine, inputs, port_runs,
                                   tmp_path_factory, monkeypatch):
    _, args, _, renamed, removed, _ = CASES[name]
    port_dir, status, err = port_runs(name)
    jax_dir, j_status, j_err = _jax_run(name, engine, inputs,
                                        tmp_path_factory, monkeypatch)
    assert status == j_status == STATUS.get(name, 0), err + j_err
    mine = _outputs(name, port_dir, err)
    theirs = _outputs(name, jax_dir, j_err)
    if engine == "device" and mine != theirs:
        native = _outputs(name, *_jax_run(name, "auto", inputs,
                                          tmp_path_factory,
                                          monkeypatch)[::2])
        for key in mine:
            assert mine[key] == theirs[key] or (
                theirs[key] != native[key] and mine[key] == native[key]), key
    else:
        assert mine == theirs
    for out in renamed:
        assert (port_dir / out).read_bytes()
    for out in removed:
        assert not (port_dir / out).exists() and not (jax_dir / out).exists()
    if status == 0 and CASES[name][0] == "do":
        assert len(sorted(port_dir.glob("*.part"))) == len(
            [a for a in args if a.endswith((".fa", ".fq"))])


def test_partition_cli_cases_reach_their_paths(port_runs):
    """The stamps runs partition into several partitions, the seeded run
    into six subsets and more than one partition, and the stop tags
    change the subset map."""
    d, status, err = port_runs("do-stamps-no-big-traverse")
    assert status == 0 and "enqueued 1 subset tasks" in err
    counts = [int(line.split()[1]) for line in err.splitlines()
              if line.startswith("output ")]
    assert counts and counts[0] > 1
    d, status, err = port_runs("do-seeded-subsets")
    assert "enqueued 6 subset tasks" in err and "loading 6 pmap" in err
    assert all((d / name).exists() for name in SUBSETS)
    part = (d / "seeded.fa.part").read_text()
    assert len({line.split("\t")[1] for line in part.splitlines()
                if line.startswith(">")}) > 1
    plain = port_runs("partition")[0]
    stop = port_runs("partition-stoptags")[0]
    assert (stop / "graph.subset.0.pmap").read_bytes() != \
        (plain / "graph.subset.0.pmap").read_bytes()
    with open(stop / "graph.subset.0.pmap", "rb") as f:
        head = f.read(18)
    assert head[:4] == b"OXLI" and head[5] == 5
    assert struct.unpack("<I", head[6:10])[0] == 20


def test_port_partition_cli_defaults_to_the_card(inputs, tmp_path):
    """Without --device the nodegraph is made on the card, which raises
    where there is none (no fall back to the CPU)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for script, args in (("do", TABLES + ["g", str(inputs / "seeded.fa")]),
                         ("merge", ["-k", "20", str(inputs / "sub")])):
        status, err = _run(PORT[script], args, tmp_path)
        assert status == -1 and "CUDA" in err
