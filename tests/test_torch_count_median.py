"""The port's count-median CLI (khmer_tpu_torch.cli.count_median) against
the JAX CLI on the CPU: the CSV bytes, the exit status and stderr (without
the version banner), on reads with Ns and lowercase bases and reads
shorter than k, on a .ct with bigcount entries (both JAX engines take
their device path there) and on one without (JAX's native host tier then
rounds some standard deviations otherwise; the port follows JAX's device
path, pinned below and logged in ROADMAP section 3).

Tolerance: exact (the CSV's bytes)."""

import importlib
import io
import os
import sys

import numpy as np
import pytest
import torch

from khmer_tpu_torch.io.fastx import FastxParser

# six xdist workers share the cores: one intra-op thread each
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
READS_25K = os.path.join(REPO, "data", "25k.fq.gz")
ENGINES = ["auto", "device"]


def _run(module, args, cwd, env=None):
    """A CLI's main() in this process, in `cwd`: (status, stderr)."""
    mod = importlib.import_module(module)
    saved = sys.argv, sys.stderr, os.getcwd(), dict(os.environ)
    err = io.StringIO()
    sys.argv = [module] + args
    sys.stderr = err
    os.environ.update(env or {})
    os.chdir(cwd)
    try:
        try:
            mod.main()
            status = 0
        except SystemExit as exc:
            status = exc.code or 0
    finally:
        sys.argv, sys.stderr = saved[:2]
        os.chdir(saved[2])
        os.environ.clear()
        os.environ.update(saved[3])
    return status, err.getvalue()


def _body(err):
    return [line for line in err.splitlines() if not line.startswith("||")]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """reads.fq (the first 2,000 reads of data/25k.fq.gz), mixed.fa
    (seeded reads with Ns, lowercase runs, reads shorter than k and one
    read 300 times), and a .ct of each from JAX's load-into-counting
    (mixed.ct has bigcount entries)."""
    d = tmp_path_factory.mktemp("cm")
    with open(d / "reads.fq", "w") as f:
        for i, rec in enumerate(FastxParser(READS_25K)):
            if i == 2000:
                break
            f.write("@%s\n%s\n+\n%s\n" % (rec.name, rec.sequence,
                                          rec.quality))
    rng = np.random.default_rng(8)
    genome = "".join("ACGT"[c] for c in rng.integers(0, 4, 5000))
    with open(d / "mixed.fa", "w") as f:
        for i in range(400):
            n = int(rng.integers(5, 160))
            s = int(rng.integers(0, 5000 - n))
            seq = genome[s:s + n]
            if i % 7 == 1:
                seq = seq[:10] + "N" * 2 + seq[12:40].lower() + seq[40:]
            f.write(">m%d\n%s\n" % (i, seq))
        for i in range(300):
            f.write(">s%d\n%s\n" % (i, genome[100:220]))
    for name, src in (("reads.ct", "reads.fq"), ("mixed.ct", "mixed.fa")):
        status, _ = _run("khmer_tpu.cli.load_into_counting",
                         ["-k", "20", "-x", "2e5", "-N", "4", "-f", name,
                          src], d, {"KHMER_TPU_ENGINE": "device"})
        assert status == 0
    return d


def _csv(module, ct, reads, d, engine=None, device=False):
    """(status, stderr without the banner, CSV bytes) of a CLI writing
    out.csv in a directory of its own."""
    run = d / ("%s-%s" % (module.split(".")[0], engine or "port"))
    run.mkdir(exist_ok=True)
    args = [str(d / ct), str(d / reads), "out.csv"]
    args += ["--device", "cpu"] if device else []
    env = {"KHMER_TPU_ENGINE": engine} if engine else None
    status, err = _run(module, args, run, env)
    return status, _body(err), (run / "out.csv").read_bytes()


@pytest.mark.parametrize("engine", ENGINES)
def test_count_median_with_bigcount_matches_jax(engine, inputs):
    """A .ct with bigcount entries: the port's CSV against the JAX CLI's
    under both engines (both take their device path on it)."""
    from khmer_tpu_torch.core.oxli_io import load_sketch
    from khmer_tpu_torch.core.sketch import Countgraph

    assert load_sketch(Countgraph, str(inputs / "mixed.ct"),
                       device="cpu")._bigcounts
    got = _csv("khmer_tpu_torch.cli.count_median", "mixed.ct", "mixed.fa",
               inputs, device=True)
    want = _csv("khmer_tpu.cli.count_median", "mixed.ct", "mixed.fa",
                inputs, engine)
    assert got == want
    assert got[0] == 0
    lines = got[2].decode().splitlines()
    assert len(lines) == 1 + sum(1 for r in FastxParser(
        str(inputs / "mixed.fa")) if len(r.sequence) >= 20)
    assert any(int(line.split(",")[1]) > 255 for line in lines[1:])


def test_count_median_matches_jax_device_path(inputs):
    """A .ct without bigcount entries: the port's CSV equals the JAX CLI's
    device path, whose sums in float32 round each product and each sum
    (JAX's _median_avg_stddev). JAX's native host tier, which the JAX CLI
    takes under `auto` here, rounds the standard deviation of some reads
    in its last printed digits otherwise: this pins that difference."""
    got = _csv("khmer_tpu_torch.cli.count_median", "reads.ct", "reads.fq",
               inputs, device=True)
    device = _csv("khmer_tpu.cli.count_median", "reads.ct", "reads.fq",
                  inputs, "device")
    auto = _csv("khmer_tpu.cli.count_median", "reads.ct", "reads.fq",
                inputs, "auto")
    assert got == device
    assert got[0] == 0 and got[1][-1] == "writing to out.csv"
    a = auto[2].decode().splitlines()
    g = got[2].decode().splitlines()
    differ = [i for i, (x, y) in enumerate(zip(a, g)) if x != y]
    assert len(a) == len(g) == 2001
    assert differ
    for i in differ:  # name, median, average and length agree
        x, y = a[i].split(","), g[i].split(",")
        assert x[:3] + x[4:] == y[:3] + y[4:]
        assert abs(float(x[3]) - float(y[3])) < 1e-5


def test_count_median_defaults_to_the_card(inputs):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        _run("khmer_tpu_torch.cli.count_median",
             ["reads.ct", "reads.fq", "x.csv"], inputs)
