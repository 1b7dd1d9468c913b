"""The port's trim-low-abund, filter-abund and filter-abund-single
(``--device cpu``) against the JAX CLIs under both of their engines
(KHMER_TPU_ENGINE=device; =auto, the native host tier where it applies):
the .abundtrim / .abundfilt / single outputs byte for byte (a gzip output
decompressed: its header holds a timestamp), what -o - writes to stdout,
the -s / --savegraph .ct bytes, the --summary-info file, the exit status
and the unique-k-mers line. Inputs: the first 20,000 reads of
data/stamps-reads.fa.gz and files this module builds from them, each run
in a directory of its own that links them (--summary-info writes beside
its input)."""

import contextlib
import gzip
import importlib
import io
import itertools
import os
import re
import sys
import traceback

import numpy as np
import pytest
import torch

from khmer_tpu_torch.cli import load_into_counting

# six xdist workers share the cores: one intra-op thread each
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAMPS = os.path.join(REPO, "data", "stamps-reads.fa.gz")
TABLES = ["-k", "20", "-x", "1e5", "-N", "4"]
INPUTS = ("head.fa", "head5k.fa", "pairs.fa", "mixed.fq", "short.fa",
          "empty.fa", "sat.fa", "long.fa", "saved.ct", "long.ct")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The input files, in one directory: head.fa (20,000 stamps reads),
    head5k.fa (the first 5,000), pairs.fa (interleaved /1 /2 pairs, some
    with a mate shorter than k), mixed.fq (N and lowercase bases), short.fa
    (reads shorter than k), empty.fa, sat.fa (one read 300 times among
    others: counts past 255), long.fa (100-base reads of a 6,000-base
    genome with a read of 5,000 bases among them), and saved.ct and
    long.ct, the .ct files the port's load-into-counting writes of
    head5k.fa and sat.fa (bigcount on), and of long.fa."""
    d = tmp_path_factory.mktemp("inputs")
    with gzip.open(STAMPS, "rt") as src:
        lines = list(itertools.islice(src, 2 * 20000))
    seqs = [s.strip() for s in lines[1::2]]
    (d / "head.fa").write_text("".join(lines))
    (d / "head5k.fa").write_text("".join(lines[:10000]))
    rng = np.random.default_rng(1010)
    pairs = []
    for i in range(1500):
        a, b = seqs[2 * i], seqs[2 * i + 1]
        if i % 50 == 7:
            b = b[:int(rng.integers(5, 30))]
        pairs.append(">p%d/1\n%s\n>p%d/2\n%s\n" % (i, a, i, b))
    (d / "pairs.fa").write_text("".join(pairs))
    mixed = []
    for i, s in enumerate(seqs[8000:9500]):
        s = list(s)
        for j in rng.choice(len(s), int(rng.integers(0, 4)), replace=False):
            s[j] = "N"
        lo = int(rng.integers(0, len(s)))
        s[lo:lo + 30] = [c.lower() for c in s[lo:lo + 30]]
        s = "".join(s)
        qual = "".join(rng.choice(list("#5?I"), len(s)))
        mixed.append("@m%d\n%s\n+\n%s\n" % (i, s, qual))
    (d / "mixed.fq").write_text("".join(mixed))
    (d / "short.fa").write_text("".join(
        ">s%d\n%s\n" % (i, s[:int(rng.integers(1, 20))])
        for i, s in enumerate(seqs[:300])))
    (d / "empty.fa").write_text("")
    sat = [">x%d\n%s\n" % (i, seqs[i]) for i in range(200)]
    for i in range(300):
        sat.insert(int(rng.integers(0, len(sat) + 1)),
                   ">r%d\n%s\n" % (i, seqs[12345]))
    (d / "sat.fa").write_text("".join(sat))
    genome = "".join(rng.choice(list("ACGT"), 6000))
    reads = []
    for i in range(400):
        s = int(rng.integers(0, 5900))
        reads.append(">g%d\n%s\n" % (i, genome[s:s + 100]))
    reads.insert(150, ">long\n%s\n" % genome[500:5500])
    (d / "long.fa").write_text("".join(reads))
    with contextlib.redirect_stderr(io.StringIO()):
        load_into_counting.main(TABLES + [
            "-f", "--device", "cpu", str(d / "saved.ct"),
            str(d / "head5k.fa"), str(d / "sat.fa")])
        load_into_counting.main(TABLES + [
            "--device", "cpu", str(d / "long.ct"), str(d / "long.fa")])
    return d


PORT = {"trim": "khmer_tpu_torch.cli.trim_low_abund",
        "filter": "khmer_tpu_torch.cli.filter_abund",
        "single": "khmer_tpu_torch.cli.filter_abund_single"}
JAX = {"trim": "khmer_tpu.cli.trim_low_abund",
       "filter": "khmer_tpu.cli.filter_abund",
       "single": "khmer_tpu.cli.filter_abund_single"}
BOTH = ("device", "auto")

# name -> (script, arguments (inputs by their names in the run's
# directory), outputs to compare, the JAX engines to hold it to)
CASES = {
    "trim-stamps": (
        "trim", TABLES + ["-C", "2", "-s", "out.ct", "--summary-info",
                          "json", "head.fa"],
        ["head.fa.abundtrim", "out.ct", "head.fa.info.json"], BOTH),
    "trim-variable-coverage-tsv": (
        "trim", TABLES + ["-V", "-Z", "10", "-C", "3", "--summary-info",
                          "tsv", "head5k.fa"],
        ["head5k.fa.abundtrim", "head5k.fa.info.tsv"], BOTH),
    "trim-diginorm": (
        "trim", TABLES + ["--diginorm", "--diginorm-coverage", "8", "-s",
                          "out.ct", "head5k.fa"],
        ["head5k.fa.abundtrim", "out.ct"], BOTH),
    "trim-single-pass-gzip": (
        "trim", TABLES + ["--single-pass", "-o", "out.fa.gz", "--gzip",
                          "pairs.fa"], ["out.fa.gz"], BOTH),
    "trim-pairs": ("trim", TABLES + ["-s", "out.ct", "pairs.fa"],
                   ["pairs.fa.abundtrim", "out.ct"], BOTH),
    "trim-ignore-pairs-stdout": (
        "trim", TABLES + ["--ignore-pairs", "-o", "-", "pairs.fa"],
        ["-"], BOTH),
    "trim-fastq-n-lowercase": (
        "trim", ["-k", "17", "-x", "1e5", "-N", "4", "-C", "3", "-s",
                 "out.ct", "mixed.fq"], ["mixed.fq.abundtrim", "out.ct"],
        BOTH),
    "trim-loadgraph-bigcount-Z300": (
        "trim", ["-l", "saved.ct", "-V", "-Z", "300", "-s", "out.ct",
                 "sat.fa"], ["sat.fa.abundtrim", "out.ct"], BOTH),
    "trim-loadgraph-C300": (
        "trim", ["-l", "saved.ct", "-C", "300", "--summary-info", "json",
                 "sat.fa"], ["sat.fa.abundtrim", "sat.fa.info.json"], BOTH),
    "trim-two-files": (
        "trim", TABLES + ["-o", "out.fa", "pairs.fa", "head5k.fa"],
        ["out.fa"], BOTH),
    "trim-short-reads": ("trim", TABLES + ["short.fa"],
                         ["short.fa.abundtrim"], BOTH),
    "trim-empty-file": ("trim", TABLES + ["empty.fa"], [], BOTH),
    # the JAX device engine cannot take a read over 4096 bases (its
    # fallback window packs rows of at most 4096 codes: ValueError)
    "trim-long-read": ("trim", TABLES + ["-s", "out.ct", "long.fa"],
                       ["long.fa.abundtrim", "out.ct"], ("auto",)),
    "filter-stamps": ("filter", ["-C", "2", "saved.ct", "head.fa"],
                      ["head.fa.abundfilt"], BOTH),
    "filter-variable-coverage-bigcount-Z300": (
        "filter", ["-V", "-Z", "300", "saved.ct", "sat.fa"],
        ["sat.fa.abundfilt"], BOTH),
    "filter-C255-bigcount": ("filter", ["-C", "255", "saved.ct", "sat.fa"],
                             ["sat.fa.abundfilt"], BOTH),
    "filter-fastq-gzip-two-files": (
        "filter", ["-C", "3", "-o", "out.fq.gz", "--gzip", "saved.ct",
                   "mixed.fq", "pairs.fa"], ["out.fq.gz"], BOTH),
    "filter-long-read": ("filter", ["-C", "2", "long.ct", "long.fa"],
                         ["long.fa.abundfilt"], BOTH),
    "single-stamps": (
        "single", TABLES + ["-C", "2", "-f", "--savegraph", "out.ct",
                            "head5k.fa"], ["head5k.fa.abundfilt", "out.ct"],
        BOTH),
    "single-variable-coverage-outfile": (
        "single", TABLES + ["-V", "-Z", "5", "-f", "-o", "out.fa",
                            "pairs.fa"], ["out.fa"], BOTH),
    "single-fp-rate-too-high": ("single", ["-k", "20", "-x", "1e4", "-N",
                                           "4", "head5k.fa"], [], BOTH),
}
# exit status other than 0: the JAX CLI, like the reference, opens an
# empty input (or an empty pass-2 file: no read reached pass 1) with a
# parser that raises; too small a table exits 1
STATUS = {"trim-empty-file": -1, "trim-short-reads": -1,
          "single-fp-rate-too-high": 1}
# -C 300 finds every k-mer below it: every read is trimmed away
EMPTY_OUTPUT = ("trim-loadgraph-C300",)


class _Stdout(io.BytesIO):
    """The binary stdout a CLI's '-' output writes to; named as the file
    that FileType opens on descriptor 1 outside a test is."""

    name = 1


def _run(module, args, cwd):
    """A CLI's main() in this process, in `cwd`, as khmer's test harness
    runs scripts (an uncaught exception is status -1): (status, the bytes
    written to stdout, stderr)."""
    mod = importlib.import_module(module)
    saved = sys.argv, sys.stdout, sys.stderr, os.getcwd()
    out, err = io.StringIO(), io.StringIO()
    out.buffer = _Stdout()  # '-' outputs write binary records here
    sys.argv = [module] + args
    sys.stdout, sys.stderr = out, err
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
        sys.argv, sys.stdout, sys.stderr = saved[:3]
        os.chdir(saved[3])
    return status, out.buffer.getvalue(), err.getvalue()


def _run_dir(inputs, tmp_path_factory, label):
    d = tmp_path_factory.mktemp(label)
    for name in INPUTS:
        os.symlink(inputs / name, d / name)
    return d


def _read(d, name, stdout):
    if name == "-":
        return stdout
    with open(d / name, "rb") as f:
        blob = f.read()
    return gzip.decompress(blob) if name.endswith(".gz") else blob


def _unique_line(err):
    return re.findall(r"Total number of unique k-mers: \d+", err)


@pytest.fixture(scope="module")
def port_runs(inputs, tmp_path_factory):
    """Each case through the port once: {name: (dir, status, stdout,
    stderr)}."""
    runs = {}

    def get(name):
        if name not in runs:
            script, args, _, _ = CASES[name]
            d = _run_dir(inputs, tmp_path_factory, "port-" + name)
            runs[name] = (d,) + _run(PORT[script],
                                     args + ["--device", "cpu"], d)
        return runs[name]

    return get


@pytest.mark.parametrize("name,engine", [
    (name, engine) for name in CASES for engine in CASES[name][3]])
def test_trim_cli_matches_jax(name, engine, inputs, port_runs,
                              tmp_path_factory, monkeypatch):
    script, args, outputs, _ = CASES[name]
    port_dir, status, stdout, err = port_runs(name)
    monkeypatch.setenv("KHMER_TPU_ENGINE", engine)
    jax_dir = _run_dir(inputs, tmp_path_factory, "jax-" + name)
    j_status, j_stdout, j_err = _run(JAX[script], args, jax_dir)
    assert status == j_status, err + j_err
    assert _unique_line(err) == _unique_line(j_err)
    for out in outputs:
        assert _read(port_dir, out, stdout) == _read(jax_dir, out,
                                                     j_stdout), out
    assert status == STATUS.get(name, 0), err
    if status == 0:
        written = _read(port_dir, outputs[0], stdout)
        assert (written == b"") == (name in EMPTY_OUTPUT), outputs[0]


def test_trim_stamps_takes_every_branch(port_runs):
    """The 20,000-read case trims some reads, drops some and keeps some
    aside for the second pass."""
    port_dir, status, _, err = port_runs("trim-stamps")
    assert status == 0
    kept_aside = int(re.search(r"kept aside (\d+) of 20000", err).group(1))
    assert 0 < kept_aside < 20000
    written = _read(port_dir, "head.fa.abundtrim", b"").count(b">")
    assert 0 < written < 20000
    assert re.search(r"trimmed [1-9]\d* reads", err)


def test_port_trim_cli_defaults_to_the_card(inputs, tmp_path):
    """Without --device the countgraph is made on the card, which raises
    where there is none (no fall back to the CPU)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    status, _, err = _run(PORT["trim"], TABLES + [str(inputs / "pairs.fa")],
                          tmp_path)
    assert status == -1 and "CUDA" in err
