"""The port's normalize-by-median (``--device cpu``) against the JAX CLI
under both of its engines (KHMER_TPU_ENGINE=device, the scan; =auto, the
native host tier where it applies): the .keep and single outputs byte for
byte (a gzip output decompressed: its header holds a timestamp), the -R
report, the -s .ct bytes, the exit status and the unique-k-mers line.
Inputs: the first 20,000 reads of data/stamps-reads.fa.gz and files this
module builds from them."""

import contextlib
import gzip
import io
import itertools
import os
import re

import numpy as np
import pytest
import torch

from khmer_tpu_torch.cli import load_into_counting, normalize_by_median

from tests.script_utils import runscript

# six xdist workers share the cores: one intra-op thread each
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAMPS = os.path.join(REPO, "data", "stamps-reads.fa.gz")
TABLES = ["-x", "1e5", "-N", "4"]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The input files, in one directory: head.fa (20,000 stamps reads),
    pairs.fa (interleaved /1 /2 pairs, some with a mate shorter than k),
    unpaired.fa, mixed.fq (N and lowercase bases), short.fa (reads
    shorter than k), empty.fa, and saved.ct, a .ct the port's
    load-into-counting wrote."""
    d = tmp_path_factory.mktemp("inputs")
    with gzip.open(STAMPS, "rt") as src:
        lines = list(itertools.islice(src, 2 * 20000))
    seqs = [s.strip() for s in lines[1::2]]
    (d / "head.fa").write_text("".join(lines))
    rng = np.random.default_rng(606)
    pairs = []
    for i in range(1500):
        a, b = seqs[2 * i], seqs[2 * i + 1]
        if i % 50 == 7:
            b = b[:int(rng.integers(5, 30))]
        pairs.append(">p%d/1\n%s\n>p%d/2\n%s\n" % (i, a, i, b))
    (d / "pairs.fa").write_text("".join(pairs))
    (d / "unpaired.fa").write_text("".join(
        ">u%d\n%s\n" % (i, s) for i, s in enumerate(seqs[5000:5600])))
    mixed = []
    for i, s in enumerate(seqs[8000:9500]):
        s = list(s)
        for j in rng.choice(len(s), int(rng.integers(0, 4)), replace=False):
            s[j] = "N"
        lo = int(rng.integers(0, len(s)))
        s[lo:lo + 30] = [c.lower() for c in s[lo:lo + 30]]
        s = "".join(s)
        mixed.append("@m%d\n%s\n+\n%s\n" % (i, s, "I" * len(s)))
    (d / "mixed.fq").write_text("".join(mixed))
    (d / "short.fa").write_text("".join(
        ">s%d\n%s\n" % (i, s[:int(rng.integers(1, 32))])
        for i, s in enumerate(seqs[:300])))
    (d / "empty.fa").write_text("")
    load_into_counting.main(["-q", "-k", "20"] + TABLES + [
        "-f", "--device", "cpu", str(d / "saved.ct"), str(d / "pairs.fa")])
    return d


# name -> (arguments with {in} for the input directory, outputs to compare)
CASES = {
    "stamps-C20": (["-C", "20"] + TABLES + ["-s", "out.ct", "{in}/head.fa"],
                   ["head.fa.keep", "out.ct"]),
    "stamps-C5": (["-C", "5"] + TABLES + ["-s", "out.ct", "{in}/head.fa"],
                  ["head.fa.keep", "out.ct"]),
    "paired": (["-C", "5", "-k", "20"] + TABLES + ["-p", "{in}/pairs.fa"],
               ["pairs.fa.keep"]),
    "force-single": (["-C", "5", "-k", "20"] + TABLES
                     + ["--force_single", "{in}/pairs.fa"],
                     ["pairs.fa.keep"]),
    "unpaired-file": (["-C", "5", "-k", "20"] + TABLES
                      + ["-p", "-u", "{in}/unpaired.fa", "{in}/pairs.fa"],
                      ["pairs.fa.keep", "unpaired.fa.keep"]),
    "single-output-report-gzip": (
        ["-C", "5", "-k", "20"] + TABLES
        + ["-o", "out.fa.gz", "--gzip", "-R", "report.csv",
           "--report-frequency", "700", "{in}/pairs.fa", "{in}/unpaired.fa"],
        ["out.fa.gz", "report.csv"]),
    "loadgraph": (["-l", "{in}/saved.ct", "-C", "5", "-s", "out.ct",
                   "{in}/unpaired.fa"],
                  ["unpaired.fa.keep", "out.ct"]),
    "n-and-lowercase": (["-C", "3", "-k", "17"] + TABLES + ["{in}/mixed.fq"],
                        ["mixed.fq.keep"]),
    "short-reads": (["-C", "5"] + TABLES + ["{in}/short.fa"],
                    ["short.fa.keep"]),
    "empty-file": (["-C", "5"] + TABLES + ["{in}/empty.fa"],
                   ["empty.fa.keep"]),
}


def _run_port(args, cwd):
    """The port's CLI in this process, in `cwd`: (status, stderr)."""
    err = io.StringIO()
    old = os.getcwd()
    os.chdir(cwd)
    try:
        with contextlib.redirect_stderr(err):
            try:
                normalize_by_median.main(args + ["--device", "cpu"])
                status = 0
            except SystemExit as exc:
                status = exc.code or 0
    finally:
        os.chdir(old)
    return status, err.getvalue()


def _read(path):
    with open(path, "rb") as f:
        blob = f.read()
    return gzip.decompress(blob) if path.endswith(".gz") else blob


def _unique_line(err):
    return re.findall(r"Total number of unique k-mers: \d+", err)


@pytest.fixture(scope="module")
def port_runs(inputs, tmp_path_factory):
    """Each case through the port once: {name: (dir, status, stderr)}."""
    runs = {}

    def get(name):
        if name not in runs:
            args, _ = CASES[name]
            d = tmp_path_factory.mktemp("port-" + name)
            status, err = _run_port(
                [a.format(**{"in": inputs}) for a in args], str(d))
            runs[name] = (d, status, err)
        return runs[name]

    return get


@pytest.mark.parametrize("engine", ["device", "auto"])
@pytest.mark.parametrize("name", list(CASES))
def test_normalize_cli_matches_jax(name, engine, inputs, port_runs,
                                   tmp_path, monkeypatch):
    args, outputs = CASES[name]
    port_dir, status, err = port_runs(name)
    monkeypatch.setenv("KHMER_TPU_ENGINE", engine)
    j_status, _, j_err = runscript(
        "normalize-by-median.py", [a.format(**{"in": inputs}) for a in args],
        in_directory=str(tmp_path), fail_ok=True)
    assert status == j_status == 0, err + j_err
    assert _unique_line(err) == _unique_line(j_err)
    assert len(_unique_line(err)) == 1
    for out in outputs:
        assert _read(str(port_dir / out)) == _read(str(tmp_path / out)), out
    kept = _read(str(port_dir / outputs[0]))
    if name in ("short-reads", "empty-file"):
        assert kept == b""
    else:
        assert kept.count(b"\n") > 0


def test_stamps_head_keeps_some_and_drops_some(port_runs):
    """The 20,000-read case exercises both decisions and both windows'
    phases: the .keep holds some reads but not all."""
    port_dir, status, _ = port_runs("stamps-C20")
    kept = _read(str(port_dir / "head.fa.keep")).count(b">")
    assert status == 0 and 0 < kept < 20000


def test_port_cli_defaults_to_the_card(inputs, tmp_path):
    """Without --device the countgraph is made on the card, which raises
    where there is none (no fall back to the CPU)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    old = os.getcwd()
    os.chdir(tmp_path)
    try:
        with pytest.raises(RuntimeError, match="CUDA"):
            normalize_by_median.main(["-C", "5"] + TABLES
                                     + [str(inputs / "unpaired.fa")])
    finally:
        os.chdir(old)
