"""Kernel L's loading rule (csrc/neighbors.cu) mirrored in plain PyTorch
(scripts/partition_cases.py probe_stages) against the port's plain
versions and the JAX package, on the CPU: table 0 first for all eight
neighbours, each later stage the next tables only for the neighbours
still present. The present-neighbour bytes and the gather's flags equal
neighbors_plain, bit_gather_plain and JAX's make_neighbors_fn and
_gather_counts("bit") on tables empty, about 0.3%, 40% and 100% set, at
k 1, 20 and 32 and 1, 4 and 32 tables, on the card cases and on a graph
of read k-mers; the loads, rows and sectors of each stage and the two
sector floors equal a count one value at a time."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from khmer_tpu.core import graphmixin as JG
from khmer_tpu.core import sketch_kernels as JK
from khmer_tpu_torch.core import sketch_kernels as K
from khmer_tpu_torch.core.partition import revcomp_bits
from khmer_tpu_torch.scripts import partition_cases as PC

# six xdist workers share the cores: one intra-op thread each
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILLS = {"empty": 0.0, "sparse": 0.003, "forty": 0.4, "full": 1.0}
N = 400


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.uint64)
                            .view(np.int64).copy())


def _tables(rng, primes, fill):
    """A joined bit buffer whose bits are set with probability `fill`."""
    size = K.bit_flat_size(primes)
    return np.packbits(rng.random(8 * size) < fill, bitorder="little")


def _views(flat, primes):
    return tuple(jnp.asarray(flat[o:o + K.bit_table_bytes(p)])
                 for o, p in zip(K.bit_offsets(primes), primes))


def _nodes(rng, k, n):
    f = rng.integers(0, 2**64, n, dtype=np.uint64)
    if k < 32:
        f &= np.uint64((1 << (2 * k)) - 1)
    else:
        f[::2] |= np.uint64(1 << 63)
    return f, revcomp_bits(f, k)


@pytest.fixture(scope="module")
def jax_probe():
    """JAX's make_neighbors_fn, built once for each (primes, k)."""
    fns = {}

    def probe(primes, k, flat, f, r):
        key = (tuple(primes), k)
        if key not in fns:
            fns[key] = JG.make_neighbors_fn("bit", primes, k)
        _, _, nc, present = fns[key](_views(flat, primes), jnp.asarray(f),
                                     jnp.asarray(r))
        return np.asarray(nc), np.asarray(present)
    return probe


def _bits(masks):
    return ((masks[:, None] >> np.arange(8)) & 1).astype(bool)


def test_rule_follows_the_source():
    """The mirror's constants are the kernel's."""
    with open(os.path.join(REPO, "khmer_tpu_torch", "csrc",
                           "neighbors.cu")) as f:
        src = f.read()

    def const(name):
        return re.search(r"constexpr \w+ %s = (\w+);" % name, src).group(1)
    assert int(const("kFirst")) == PC.FIRST == 1
    assert int(const("kGroup")) == PC.GROUP


@pytest.mark.parametrize("fill", list(FILLS))
@pytest.mark.parametrize("ntables", [1, 4, 32])
@pytest.mark.parametrize("k", [1, 20, 32])
def test_staged_rule_matches_plain_and_jax(k, ntables, fill, jax_probe):
    """The rule's bytes and the gather's flags against the plain versions
    and JAX; stage 0 reads table 0 for every neighbour, later stages only
    rows with a survivor, and no stage follows one that leaves none."""
    rng = np.random.default_rng(1000 * k + 10 * ntables + len(fill))
    primes = tuple(K.get_n_primes_near_x(ntables, 20000))
    flat = _tables(rng, primes, FILLS[fill])
    f, r = _nodes(rng, k, N)
    tflat = torch.from_numpy(flat)
    got, stages = PC.neighbor_stages(primes, tflat, _t(f), _t(r), k)
    want = K.neighbors_plain(primes, tflat, _t(f), _t(r), k)
    assert torch.equal(got, want)
    nc, present = jax_probe(primes, k, flat, f, r)
    assert (_bits(got.numpy()) == present).all()
    assert stages[0]["tables"] == (0, 1) and stages[0]["rows"] == N
    assert 0 < stages[0]["loads"] <= 8 * N
    for before, stage in zip(stages, stages[1:]):
        assert stage["tables"][0] == before["tables"][1]
        assert stage["tables"][1] - stage["tables"][0] <= PC.GROUP
        assert 0 < stage["rows"] <= before["rows"]
    if fill == "empty":
        assert len(stages) == 1
    if fill == "full":
        assert got.eq(255).all() and stages[-1]["tables"][1] == ntables
        assert sum(s["loads"] for s in stages) == 8 * ntables * N
    flags, _ = PC.probe_stages(primes, tflat, _t(nc.reshape(-1))[:, None])
    jflags = np.asarray(JK._gather_counts("bit", primes, _views(flat, primes),
                                          jnp.asarray(nc.reshape(-1))))
    assert (flags[:, 0].to(torch.int32).numpy() == jflags).all()
    assert torch.equal(flags[:, 0].to(torch.int32), K.bit_gather_plain(
        primes, tflat, _t(nc.reshape(-1))))


def _brute(primes, flat, f, r, k):
    """probe_stages' counts and probe_floors, one value at a time."""
    offs = K.bit_offsets(primes)
    mask = (1 << (2 * k)) - 1
    shift = 2 * k - 2
    bounds, t0, width = [], 0, PC.FIRST
    while t0 < len(primes):
        bounds.append((t0, min(t0 + width, len(primes))))
        t0, width = bounds[-1][1], PC.GROUP
    stages = [{"rows": 0, "loads": 0, "sectors": set()} for _ in bounds]
    every, needed = set(), set()
    byte = []
    for fi, ri in zip(f.tolist(), r.tolist()):
        canon = []
        for j in range(4):
            canon.append(min(((fi << 2) | j) & mask,
                             (ri >> 2) | ((j ^ 1) << shift)))
        for j in range(4):
            canon.append(min((fi >> 2) | (j << shift),
                             ((ri << 2) | (j ^ 1)) & mask))

        def bit(c, t):
            return 8 * offs[t] + c % primes[t]

        def is_set(b):
            return flat[b >> 3] >> (b & 7) & 1

        for c in canon:
            ok = True
            for t in range(len(primes)):
                every.add(bit(c, t) // 256)
                if ok:
                    needed.add(bit(c, t) // 256)
                    ok = is_set(bit(c, t))
        live = set(range(8))
        for s, (t0, t1) in zip(stages, bounds):
            if not live:
                break
            s["rows"] += 1
            for t in range(t0, t1):
                s["loads"] += len(live)
                s["sectors"] |= {bit(canon[j], t) // 256 for j in live}
            live = {j for j in live if all(is_set(bit(canon[j], t))
                                           for t in range(t0, t1))}
        byte.append(sum(1 << j for j in live))
    return byte, stages, len(every), len(needed)


@pytest.mark.parametrize("ntables", [1, 4, 32])
@pytest.mark.parametrize("fill", [0.0, 0.02, 0.5, 1.0])
def test_counts_match_brute_force(fill, ntables):
    """Each stage's rows, loads and distinct sectors, and both sector
    floors, against a count one value at a time, on tables small enough
    that neighbours share sectors often."""
    rng = np.random.default_rng(int(fill * 100) + ntables)
    primes = tuple(K.get_n_primes_near_x(ntables, 4000))
    flat = _tables(rng, primes, fill)
    f, r = _nodes(rng, 20, 60)
    tflat = torch.from_numpy(flat)
    got, stages = PC.neighbor_stages(primes, tflat, _t(f), _t(r), 20)
    byte, want, every, needed = _brute(primes, flat.tolist(), f, r, 20)
    assert got.tolist() == byte
    assert [(s["rows"], s["loads"], s["sectors"]) for s in stages] == [
        (s["rows"], s["loads"], len(s["sectors"]))
        for s in want[:len(stages)]]
    assert all(s["rows"] == 0 for s in want[len(stages):])
    assert PC.probe_floors(primes, tflat, _t(f), _t(r), 20) \
        == (every, needed)
    assert needed <= every and (needed == every or fill < 1.0)


@pytest.mark.parametrize("name", list(PC.NEIGHBOR_CASES))
def test_card_cases_on_the_cpu(name):
    """The rule on every card case (CPU tensors): its bytes and the
    gather's flags equal the plain versions; the fill cases are filled as
    named (graph: real neighbours present)."""
    k, _, n = PC.NEIGHBOR_CASES[name]
    primes, flat, f, r, h = PC.case_inputs(name, torch.device("cpu"))
    got, stages = PC.neighbor_stages(primes, flat, f, r, k)
    want = K.neighbors_plain(primes, flat, f, r, k)
    assert torch.equal(got, want)
    flags, _ = PC.probe_stages(primes, flat, h[:, None])
    assert torch.equal(flags[:, 0].to(torch.int32),
                       K.bit_gather_plain(primes, flat, h))
    share = float(np.unpackbits(flat.numpy()).mean())
    fill = PC._FILL.get(name)
    if fill == "sparse":
        assert 0.002 < share < 0.006 and stages[1]["rows"] < f.shape[0] // 10
    elif fill == "empty":
        assert share == 0 and len(stages) == 1
    elif fill == "full":
        assert share == 1 and got.eq(255).all()
    elif fill == "graph":
        assert share < 0.006
        present = _bits(got.numpy()).sum(1)
        assert present.mean() > 1.5 and (present > 0).mean() > 0.95
        assert flags[:f.shape[0]].all()  # the nodes themselves
    elif n:
        assert 0.3 < share < 1


def test_graph_case_matches_jax(jax_probe):
    """The graph case's bytes against JAX's make_neighbors_fn."""
    primes, flat, f, r, _ = PC.case_inputs("k20-T4-graph",
                                           torch.device("cpu"))
    fu, ru = (a.numpy().view(np.uint64) for a in (f, r))
    _, present = jax_probe(primes, 20, flat.numpy(), fu, ru)
    got, _ = PC.neighbor_stages(primes, flat, f, r, 20)
    assert (_bits(got.numpy()) == present).all()
