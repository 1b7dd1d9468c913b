#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (khmer_tpu_torch) on one GPU.

Run from the root of the repository, on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (each prints a line; any failure raises and exits non-zero):
  1. device: the card's name and power limit (nvidia-smi) and torch's view;
  2. build: nvcc builds csrc/*.cu for sm_90a, one process per source, all
     at once; build time and ptxas report;
  3. exact: each kernel against its plain PyTorch version on the card, on
     seeded adversarial inputs (hashes >= 2^63, in-chunk duplicates,
     cross-hash bin collisions on tiny tables, counts driven past 255 and
     into bigcount, zero-padded tails with real zeros inside nvalid, chunk
     sequences, one hash x 2^20 events, full 2^20 chunks on a 7-block
     table and on tiny primes, chunks crowded onto a narrow counter range
     that the update kernels must split, histogram indices out of range
     and in the wrapped window [-nbins, 0), on abundance-dist's shape,
     crowded onto the edges of the histogram's private bins, and split
     into launches under a lowered limit; the pallas_proto script's
     correctness case, decoded events: one event x 2^20, 2^20 events on 7
     blocks, repeated lanes with invalid ids and saturation, a crowded
     bucket; the byte gather on the edges of its reduction by a
     reciprocal, on random tables of 0.2, 4 and 20 GB, and the blocked
     gather on them at 0.2 and 2.15 GB; the diginorm median test and
     keep/consume scan on the windows of scripts/diginorm_cases.py:
     counters at 254 and 255, C = 1, 255 and 300, k = 32, rows of 64,
     4096, 9000 and 20000 codes, 1 and 32 tables, a window rejected whole
     and one not at all, the byte tables of 0.2, 4 and 20 GB, and windows
     that only exact groups of the scan pass (a copy rejected because an
     earlier one of its group raised its counters to C, counters at 254
     and 255, k-mers first seen twice in a group, rows of 9000 codes
     mixing grouped and lone bundles), and windows on the edges of the
     median test's tiles and rounds (rows of exactly one segment of
     windows and of one more, 32 tables, rows of a million codes, reads
     whose table-0 survivors equal their threshold or fall one short),
     the median test's load counter held to its rule's on each; and the
     port's ScanNormalizer on the card against the CPU's over windows
     holding reads of 5,000 to 15,000 bases); the trim-low-abund pass-1
     scan (whole, and each of its pre-pass's mark and probe launches and
     its walk) and the per-read count/trim on the windows of
     scripts/trim_cases.py (counters at 254 and 255, cutoff 1, 2, 255 and
     300, -Z 20 and 300, --diginorm on and off, k 20 and 32, 1 and 32
     tables, rows of 64, 4096 and 20,000 codes, a mate shorter than k,
     tables of 0.2 and 4 GB; in stream order, a consume that lifts a
     later bundle's k-mer to the cutoff so its trim position moves, one
     that moves a later bundle from branch 1 to 0 under --diginorm, one
     that lifts a later candidate past the trim coverage, and live
     bundles across groups and a tile, grouped and alone; the count/trim
     also with a bigcount table at -C 300), the count/trim alone on the
     rows of scripts/trim_cases.py COUNT_CASES (one row of 1,000,000
     codes, a long-read run of 559 reads of 5,000-15,000 bases, rows of
     L % 16 != 0 of one segment and of several, short reads mixed with
     long ones, a tile's tail of rows, k 1 and 32 with reads of 0, 1 and
     2 windows, counters at 254-255 under a bigcount table; cutoff and
     at_least 0, equal and in either order; bad windows at window 0, in a
     later segment only, or nowhere), and the port's ScanTrimmerState on
     the card against the CPU's over the long-read windows; the Bloom-
     filter update (kernel J, its probe's open lanes held to the tables'
     count) and the murmur + HLL register max (kernel K) on the cases of
     scripts/graph_cases.py (crowded bins that split a bucket, one hash x
     2^20, hashes >= 2^63 on 8 tables, bits already set, some or half of
     them, a valid mask with nvalid < m, also over set bits, empty
     batches, bit indices past 2^32, 32 tables, a mid-stream chunk that
     repeats seen and unseen k-mers; p 4, 14 and 18, k 4, 17, 20, 25, 31,
     32, 33 and 64, palindromes, reads shorter than k and across read
     boundaries, runs of a thread across read starts, a continued first
     read, a fill short of the codes, a read over eight tiles, read starts
     on a tile's first and last windows and a run's edges, a last tile of
     one window, a chunk of one window); the per-table gather (kernel M)
     on the cases of scripts/pertable_cases.py (no hash, one, 2^20 + 3,
     the reduction's edges, hashes near 2^64, one table, three, eight and
     thirty-two, counters at 254 and 255, tables over 2^31 bytes);
  4. config 1, blocked: the port's load-into-counting (--tpu-layout
     blocked, k=20, 4 x 5e7 bytes) on data/25k.fq.gz, then the abundance
     histogram; results must equal the JAX package's and the blocked
     kernels must have launched on this path; then the blocked gather and
     the histogram on the step's first batch, beside their bounds, the
     gather's sector floor and torch.bincount;
  4b. config 1, exact (the default layout): load-into-counting, then
     abundance-dist on the .ct; every known JAX answer is asserted and the
     byte update, byte gather and histogram kernels must have launched on
     this path, and the bit-table update (kernel J) as abundance-dist's
     tracking update; a traced abundance-dist; J on its first batch; consume k-mers/s on the record and native-parser paths;
     the byte gather on one abundance batch (beside its byte bound and its
     sector floor) and on 2^20 random live hashes;
  5. scale, blocked: the 25k stream replayed 50 times through kernel and
     plain version on the config-1 table and the largest the layout
     allows (2.1 GB); tables compared exactly, k-mers/s of each; the
     blocked gather on the first chunk, beside its sector floor;
  5b. scale, exact: the same replay through the byte update and its plain
     version on the config-1 tables, on -x 1e9 -N 4 (4 GB of tables) and
     on -x 5e9 -N 4 (20 GB); tables compared exactly, with the update's
     chunk-sized scratch printed;
  6. microbenchmarks: the ports of scripts/pallas_proto.py (the decoded-
     event update against its plain version and against the blocked
     update in the same run, with its scratch) and
     scripts/profile_scatter2.py (the histogram against its plain version
     and torch.bincount);
  7. config 2: the port's normalize-by-median -C 20 -s on
     data/stamps-reads.fa.gz (the defaults: k 32, 4 x 1e6 tables); the
     JAX answers (.keep and .ct sha256, kept reads, n_unique) asserted and
     the median-test and scan kernels seen to launch, the median test's
     counter loads (a launch, and beside every table of every window) and
     the scan's groups (candidates a group); a traced run for
     their device time; both kernels on window 6 against their plain
     versions, beside their bounds and E's sector floors, E as issued and
     as the device sees it, its load counter held to its rule's
     (scripts/diginorm_bench.py);
  7b. config 2 at -k 20 -C 20 -x 1e9 -N 4 (4 GB of tables) on 1,000,000
     seeded synthetic reads (scripts/synth_reads.py); the JAX answers
     asserted, the device memory beside the tables, the median test's
     loads (asserted below every table of every window: its rounds
     engaged), the scan's groups, a traced run on the first 250,000
     of the reads (the run's depth cut to keep the script's time); both
     kernels on its window 6 against their plain versions, beside their
     bounds and E's sector floor;
  8. config 3 at the reference's parameters through the port's CLIs:
     trim-low-abund -k 20 -x 5e7 -N 4 -C 2 -s --summary-info json on
     data/stamps-reads.fa.gz, the same with -V, filter-abund -C 2 on phase
     4b's .ct over data/25k.fq.gz and filter-abund-single -k 20 -x 5e7 -C
     2 on it; the JAX answers (.abundtrim, .ct and .abundfilt sha256,
     summary fields, n_unique) asserted and the scan's three launches and
     the count/trim kernel seen to launch; the scan's candidates, live
     bundles and groups; a traced run (the scan's pre-pass and walk time
     apart, a bundle; the count/trim's a window); the scan whole and each
     of its launches, and the count/trim, on window 6 against their plain
     versions, beside their bounds and the count/trim's sector floor
     (scripts/trim_bench.py); the count/trim as issued and on the device,
     with the share of its loads a staging by table 0 would save, there
     and alone on a long-read run and on one row of 1,000,000 codes
     (trim_bench H_SHAPES (c) and (d));
  8b. trim-low-abund -k 20 -C 2 -x 1e9 -N 4 (4 GB of tables) on phase 7b's
     1,000,000 synthetic reads; the JAX answers asserted, the device
     memory beside the tables, the scan's counts, a traced run on the
     first 250,000 of the reads, the kernels on window 6;
  9. config 4 as BASELINE runs it: the port's unique-kmers -k 20 -e 0.01
     and load-graph -k 20 -x 2.5e7 -N 4 on data/stamps-genomes.fa; the
     JAX answers (estimate 7,948; n_unique, tags, and the .ng, .tagset
     and .info sha256) asserted and kernels K and J seen to launch; wall
     time, reads/s and k-mers/s; after 9b, the HLL consume and the tagged
     consume of 9, 9a and 9b traced (scripts/trace_config4.py, in a
     process of its own: device time of K and J, the busy share);
  9a. the same on data/stamps-reads.fa.gz, load-graph at -x 12.5e6 (the
     tagged consume config 5 starts from); K against its plain version
     and scatter_reduce_ on the run's first native block;
  9b. load-graph -k 20 -x 8e9 -N 4 (4 GB of bit tables) and unique-kmers
     -k 20 on phase 7b's 1,000,000 synthetic reads; J against its plain
     version on the stream's first 2^20 hashes into those tables zeroed
     (as the first chunk finds them: the time in the per-kernel line) and
     as the whole stream left them, and on the stream's chunk 40 into the
     tables as chunks 0-39 left them (the shape of most of its calls),
     each beside its byte bound, its sector floor and the share of lanes
     its probe settled;
  10. config 5 as BASELINE runs it: the port's do-partition -k 20 -x
     12.5e6 -N 4 --no-big-traverse --keep-subsets on data/stamps-reads.fa.gz;
     the JAX answers asserted (16,121 tags, count_partitions (51, 16,025)
     on the subset, every tag's id in the reference's golden map
     tests/golden/stamps_ref_pmap.txt.gz, the .info, subset .pmap and .part
     sha256, "output 50 partitions"), kernel L (the 8-neighbour probe)
     seen to launch once a level and held to its plain version on every
     level (scripts/level_tap.py: the walk's C++ loop, csrc/level_walk.cc
     kt_level_run, calls the card's probe through a callback that checks
     after it); the wall split into the tagged consume, the walk (its C++
     passes, writing the frontiers, and the probes: issuing the uploads,
     L's launches and the copies back, waiting in the syncs; L's time on
     the card, its frontiers replayed in order after the CLI from a file,
     each launch between CUDA events while a sleep kernel holds the
     stream, the card's gap between launches included), the union-find,
     the merge and the annotation; the host's peak resident set and the
     card's peak memory over the CLI and the walk's batches with their
     keeper bytes;
  10a. the same without --no-big-traverse, the CLI's default walk that no
     size cuts ("output 1 partitions", the .pmap and .part sha256), its
     keepers the largest;
  10b. do-partition -k 20 -x 8e9 -N 4 --no-big-traverse --keep-subsets (4
     GB of bit tables) on phase 7b's 1,000,000 synthetic reads: 527,780
     tags in 6 subsets, each subset .pmap's sha256, "output 25451
     partitions" and the .part's sha256 with its partition ids renamed by
     first appearance (the merge numbers them in the order glob lists the
     .pmap files); L held to its plain version on every eighth level;
     then L on the largest frontiers of 10 and 10b against its plain
     version, beside its byte bound (17 B a node) and its two sector
     floors (32 B a distinct sector read: of every table of every
     neighbour, and of what a probe that stops at a neighbour's first
     unset bit needs), with the loads of L's rule a stage: L's time in
     the per-kernel line is 10b's;
  11. the knot pipeline of khmer's partitioning guide through the port's
     CLIs on data/stamps-reads.fa.gz at -k 20: load-graph -x 12.5e6 -N 4,
     make-initial-stoptags -x 2e8 -N 4, partition-graph -S (the default
     walk), find-knots -x 2e8 -N 4, filter-stoptags, do-partition of the
     filtered reads, extract-partitions of its .part and of phase 10's;
     the JAX answers asserted (the sha256 of every .stoptags, .pmap,
     .stopfilt, .part, .dist and group file, the stop tags, the
     repartitioned sizes, the partitions); kernels M (the per-table
     gather), L and A seen to launch, M held to its plain version on
     every call; each CLI's wall, the repartitions' split into the
     excursions' walk, M, the host's evaluation, A's commits and the tags'
     walk again, with the tags walked again, also as one JSON line; then
     M on its largest call
     against its plain version and torch.take at precomputed indices,
     beside its byte bound and sector floor;
  11b. find-knots -x 2e8 -N 4 on phase 9b's graph (4 GB of bit tables)
     with phase 10b's six subsets, read in sorted order: the stop tags'
     sha256 and the repartitioned sizes asserted, the wall split (and its
     JSON line).
  12. the Countgraph as a de Bruijn graph at config 5's shape:
     Countgraph(20, 12.5e6, 4) with bigcount tagged from
     data/stamps-reads.fa.gz (kernel A with its new flags), partitioned
     with and without the abundance band (2, 200) (kernel N probes each
     level of the walks' C++ loop, in its small-level mode below
     sketch_kernels.NBR_SMALL_NODES nodes, else its staged mode), the
     first 1,000 reads swept at ranges 0 and 81,
     consume-partitioned-fasta of phase 10's .part, and count-median on
     phase 4b's .ct (kernel H's counts mode); the JAX answers asserted
     (EXPECT_C12), every call of A and H and every level of N held to its
     plain version (N by the level tap, as L in phase 10), N launched
     once a level; each step's wall with its walk's probes and passes;
     then N in both its modes on the phase's largest level and its
     largest below the crossover, H's counts mode and A with and without
     its flags on the phase's largest call, beside N's bound and sector
     floors;
  12b. the same graph at -x 1e9 (4 GB of byte tables) on phase 7b's
     reads: the tagged consume, the abundance partition over every tag
     and count-median against phase 7b's .ct, the JAX answers asserted,
     N held to plain on every eighth level; the wall split (tagged
     consume, the walk, union-find, count-median); the walk run again
     with no tap and split by its clocks (the C++ passes, writing the
     frontiers, issuing the uploads, N's launches and the copies back,
     waiting in the syncs); N over the walk replayed (held events); and
     the kernels on its largest calls as in phase 12 (N's small-level
     mode's time in the per-kernel line is 12b's, its staged mode's
     phase 12's).
  13. configs 1-3 and the knot pipeline with --small-count (a
     SmallCountgraph: 4-bit counters, two a byte, OXLI type 7) through
     the CLIs at their phases' shapes: load-into-counting and
     abundance-dist-single -k 20 -x 5e7 -N 4 and filter-abund-single -k 20
     -x 5e7 -C 2 on data/25k.fq.gz, normalize-by-median -C 20 -s and
     trim-low-abund -k 20 -x 5e7 -N 4 -C 2 -s (with and without -V) on
     data/stamps-reads.fa.gz, make-initial-stoptags and find-knots -x 2e8
     -N 4 on phase 11's graph; the JAX answers asserted (EXPECT_C13),
     kernels P, Q (under its mask in the histogram) and R (the nibble
     update and gathers; R's hashes-in entry in the knots), R's rows mode
     (normalize's and trim's windows), Q's rows mode (filter-abund-single)
     and J, C and L launched, every call of P, Q, R and the rows modes
     held to its plain version, each CLI's wall; phase 3 also holds them
     to plain on scripts/nibble_cases.py (both nibbles of a byte in one
     chunk and in two of the update's buckets, counters past 15, tiny odd
     primes, a crowded bucket, nibble tables of 0.1, 2 and 4 GB, Q under
     three masks; the rows modes at k 1, 20 and 32, on rows of L % 16 !=
     0, a read over 4,096 bases, a row of 1,000,000 codes and a window
     over 4 GB);
  13b. load-into-counting and abundance-dist-single -k 20 -x 2e9 -N 4
     --small-count (4 GB of nibble tables) on phase 7b's reads, then
     normalize-by-median -C 20 -x 2e9 -N 4 --small-count and
     filter-abund-single -k 20 -x 2e9 -N 4 -C 2 --small-count on their
     first 250,000, the JAX answers asserted, every call of P, Q and the
     rows modes held to plain, the device memory beside the tables; then
     P, Q (masked), R's rows mode and Q's rows mode on 13b's largest calls
     and R on phase 13's against their bounds and sector floors, R and
     R's rows mode beside torch.take at precomputed byte indices.
  14. the sketch family at 4 x 25 MB tables through the port's entry
     points: Counttable, SmallCounttable, Nodetable, BlockedCounttable and
     CyclicCounttable consume data/25k.fq.gz (n_unique, n_occupied, the
     saved file's sha256, read back by its loader, and the count ops,
     find_spectral_error_positions and trim_below_abundance of the first
     100 reads); a Countgraph consumes the stamps reads under a Nodegraph
     mask of their first half at threshold 0, both ways; a Counttable
     consumes data/25k.fq.gz in four bands whose table is the full
     consume's, and a band of the stamps reads under the mask; a
     SmallCountgraph(20, 5e7, 4) tags the stamps reads, partitions them
     with and without the band (2, 14) and sweeps its first 1,000 reads at
     81; the JAX answers asserted (EXPECT_C14), every call of kernel S
     (the consume filter) and every level of kernel N's nibble mode held
     to its plain version, each kernel of the path launched; phase 3 also
     holds S and N's nibble mode to plain on scripts/family_cases.py;
  14b. at 4 GB of tables on phase 7b's reads: a Counttable(20, 1e9, 4) and
     a SmallCounttable(20, 2e9, 4) consume them, a Countgraph(20, 1e9, 4)
     consumes them under a Nodegraph(20, 8e9, 4) mask of their first
     250,000, a SmallCountgraph(20, 2e9, 4) tags them and partitions every
     tag in the band (2, 14); the JAX answers asserted, every call of S and
     every 8th level of N's nibble mode held to plain; then S on its
     largest call beside torch.masked_select and the read of its count,
     and N's nibble mode in both its modes on phase 14's and 14b's largest
     levels, beside their bounds and sector floors (its staged mode's time
     in the per-kernel line is phase 14's, its small-level mode's 14b's).
Kernel times in the per-kernel line are CUDA-event times of calls issued
back to back (scripts.cuda_ms), what a caller sees (J's at 9b each call
alone after its tables are zeroed or restored, scripts.reset_ms); the
phase lines of
the histogram and the gathers also print their device time alone
(scripts.device_ms: the stream held while the calls are issued) and the
host's time to issue one call. It prints the card's name and power
limit, a JSON line of per-kernel results, then, last, the contract line
{"ok": true, "device": {...}}.
Without a CUDA device it exits 1 at once.
"""

import csv
import functools
import hashlib
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(REPO, "data", "25k.fq.gz")
K = 20
REPLAY = 50

# H100 SXM datasheet peaks: HBM3 bytes/s, and the
# float32 rate outside the tensor cores, used here for the kernels'
# 32-bit integer work (one operation per counter touched).
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12

# Config 1 through the JAX package (khmer_tpu, CPU):
# BlockedCountgraph(20, 5e7, 4) over data/25k.fq.gz, and its histogram
# with a tracking Nodegraph(20, 1, 1, primes=cg.hashsizes()).
EXPECT = {
    "nblocks": 1562471,
    "n_reads": 25000,
    "n_kmers": 1248896,
    "n_unique": 1246178,
    "n_occupied": 1230945,
    "ct_bytes": 199996314,
    "ct_sha256": "f9b0730650446467c7f47af6443dc982"
                 "bad2a26267ea37bcfb89541d46d05e3f",
    "hist_sum": 1220109,
    "hist_nonzero": 22,
    "hist_head": [(1, 1218061), (2, 1977), (3, 27), (4, 5), (5, 1), (6, 2),
                  (8, 3), (9, 3)],
}

# Config 1 in the exact layout through the JAX package (khmer_tpu, CPU):
# load-into-counting -k 20 -x 5e7 -N 4 (the default layout, bigcount on)
# on data/25k.fq.gz, then abundance-dist on that .ct.
EXPECT_EXACT = {
    "primes": [49999991, 49999921, 49999903, 49999897],
    "n_reads": 25000,
    "n_kmers": 1248896,
    "n_unique": 1246182,
    "n_occupied": 1230788,
    "n_bigcounts": 0,
    "ct_bytes": 199999772,
    "ct_sha256": "b91ca4331fe04c323944fe3106ae8a0c"
                 "13ff0917dc435aeab156f0fb72313cb5",
    "info_lines": ["Total number of unique k-mers: 1246182",
                   "fp rate estimated to be 0.000"],
    "hist_sum": 1246182,
    "hist_nonzero": 22,
    "hist_head": [(1, 1244118), (2, 1992), (3, 28), (4, 5), (5, 1), (6, 2),
                  (8, 3), (9, 3), (11, 1), (12, 2), (14, 1), (15, 1)],
    "csv_bytes": 530,
    "csv_sha256": "198e0429f6b78b9b12cf9751e196c593"
                  "6097fbba9947fb04e8166a5fb32fea3d",
}
SCALE_X = (1e9, 5e9)  # phase 5b's large tables: -x 1e9 / 5e9 -N 4

STAMPS = os.path.join(REPO, "data", "stamps-reads.fa.gz")
# Config 2 through the JAX package (khmer_tpu, CPU), the same under
# KHMER_TPU_ENGINE=auto (the native host tier) and =device (the scan):
# normalize-by-median -C 20 -s out.ct data/stamps-reads.fa.gz (k 32, 4
# tables near 1e6: the defaults).
EXPECT_C2 = {
    "reads": 200000,
    "kept": 26834,
    "n_unique": 663232,
    "keep_sha256": "851c9b21bbc10505b19ee8a1508f136b"
                   "51bd46d5190dd6845f51b2fdfed41992",
    "ct_bytes": 3999942,
    "ct_sha256": "a822096360a2be140c53fed77678b6e1"
                 "6c32091d9cc9acd178d94e6acb901dbc",
}
# Phase 7b through the JAX package (CPU, KHMER_TPU_ENGINE=auto):
# normalize-by-median -k 20 -C 20 -x 1e9 -N 4 -s out.ct on the reads of
# khmer_tpu_torch/scripts/synth_reads.py at its defaults.
EXPECT_C2_SCALE = {
    "reads": 1000000,
    "input_sha256": "a3157d2e2fad87287f346c335f697133"
                    "5f33c80d9cf6fb5e8e9549aca15a3329",
    "kept": 691977,
    "n_unique": 13244756,
    "keep_sha256": "4769367e26918d0f785edd76d51473be"
                   "56b25160ff04944dc3107b578cfc7d4d",
    "ct_bytes": 3999999702,
    "ct_sha256": "a96e76ab8d1b00f288e1f2130ff7e565"
                 "ce21567ee83f6b31ec7313b1a878b919",
}

# Config 3 through the JAX package (khmer_tpu, CPU), the same under
# KHMER_TPU_ENGINE=auto and =device, at the reference's parameters
# (khmer_tpu/cli/trim_low_abund.py and filter_abund.py epilogs):
# trim-low-abund -k 20 -x 5e7 -N 4 -C 2 [-V] -s out.ct --summary-info json
# on data/stamps-reads.fa.gz (n_unique read off the countgraph after the
# run); filter-abund -C 2 on phase 4b's .ct over data/25k.fq.gz; and
# filter-abund-single -k 20 -x 5e7 -C 2 on data/25k.fq.gz.
EXPECT_C3 = {
    "trim": {
        "abundtrim_sha256": "9900820a5a9d08df5a707d7b662d6b77"
                            "f29a0bf230733a9a22504d90bcda7963",
        "abundtrim_bytes": 16540203,
        "ct_sha256": "fc8aef5be11661caff4301540e9f8f3c"
                     "5fb7cef8506aa754d262b94219eb5e13",
        "ct_bytes": 199999772,
        "n_unique": 213613,
        "info_sha256": "9101e2927eb3ed524f8d52e627d0c327"
                       "f16450fe681036250e998b40153cbebe",
        "info": {"fpr": 3.3020481896772825e-10, "reads": 200000,
                 "basepairs": 20000000, "reads_written": 174719,
                 "basepairs_written": 14016091, "reads_skipped": 0,
                 "basepairs_skipped": 0, "reads_removed": 25281,
                 "reads_trimmed": 103194,
                 "basepairs_removed_or_trimmed": 5983909}},
    "trim-V": {
        "abundtrim_sha256": "e5ba57fa09b67fd2faac74814a163f23"
                            "61e348de501d9bf761dfa1262b5d8dc5",
        "abundtrim_bytes": 16869113,
        "ct_sha256": "fc8aef5be11661caff4301540e9f8f3c"
                     "5fb7cef8506aa754d262b94219eb5e13",
        "ct_bytes": 199999772,
        "n_unique": 213613,
        "info_sha256": "2cdef707ecef02ff22f29a6362341a56"
                       "5eca33af6800095828966854e8e7c327",
        "info": {"fpr": 3.3020481896772825e-10, "reads": 200000,
                 "basepairs": 20000000, "reads_written": 175828,
                 "basepairs_written": 14328974, "reads_skipped": 0,
                 "basepairs_skipped": 0, "reads_removed": 24172,
                 "reads_trimmed": 98592,
                 "basepairs_removed_or_trimmed": 5671026}},
    "filter": {"abundfilt_sha256": "9f577c7ab26cfd6eb8b31cd665c9a8d0"
                                   "3b7ea4f82f656f2cba500702d36843a6",
               "abundfilt_bytes": 7893},
    "single": {"abundfilt_sha256": "9f577c7ab26cfd6eb8b31cd665c9a8d0"
                                   "3b7ea4f82f656f2cba500702d36843a6",
               "abundfilt_bytes": 7893, "n_unique": 1246182},
}

# Phase 8b through the JAX package (CPU, KHMER_TPU_ENGINE=auto):
# trim-low-abund -k 20 -C 2 -x 1e9 -N 4 -s out.ct --summary-info json on
# phase 7b's reads. Pass 1 consumes a bundle iff normalize-by-median -C 20
# keeps it (trim coverage 20), so the .ct and n_unique are 7b's.
EXPECT_C3_SCALE = {
    "abundtrim_sha256": "59a4f4caed81fa15354a8986f1419c03"
                        "3153c9335e42cd5a9d0be8a9f8aee4fb",
    "abundtrim_bytes": 70658728,
    "ct_sha256": EXPECT_C2_SCALE["ct_sha256"],
    "ct_bytes": EXPECT_C2_SCALE["ct_bytes"],
    "n_unique": EXPECT_C2_SCALE["n_unique"],
    "info": {"fpr": 2.997075468214521e-08, "reads": 1000000,
             "basepairs": 100000000, "reads_written": 828866,
             "basepairs_written": 62462726, "reads_skipped": 0,
             "basepairs_skipped": 0, "reads_removed": 171134,
             "reads_trimmed": 619342,
             "basepairs_removed_or_trimmed": 37537274},
}


# Config 4 through the JAX package (khmer_tpu, CPU), the same under
# KHMER_TPU_ENGINE=auto and =device: unique-kmers -k 20 -e 0.01 and
# load-graph -k 20 -x 2.5e7 -N 4 on data/stamps-genomes.fa (the shape of
# scripts/bench_configs.py:180); unique-kmers -k 20 and load-graph -k 20
# -x 12.5e6 -N 4 on data/stamps-reads.fa.gz (config 5's tagged consume,
# bench_configs.py:214-216). Phase 9b's answers: the JAX CLIs under
# KHMER_TPU_ENGINE=auto only, load-graph at -x 8e9 -N 4 on phase 7b's
# reads (its device engine ran at -x 1e8 only, and matched auto there).
EXPECT_C4 = {
    "genomes": {
        "reads": 2, "kmers": 7962, "estimate": 7948, "n_unique": 7962,
        "n_tags": 206,
        "ng_sha256": "25975470d20cc3c8fa76f45b55d52ea7"
                     "0e695b68ed8f99ce59ffd6d6e59ec0ba",
        "ng_bytes": 12500039,
        "tagset_sha256": "60a4aeb92583e7554138083ef677c440"
                         "6d0655814d635747ae01c390966d48e3",
        "info_sha256": "872dbca49fe379883dbba08435220a2a"
                       "af144bf1a403ea9309206ec071082584"},
    "stamps": {
        "reads": 200000, "kmers": 16200000, "estimate": 542972,
        "n_unique": 536430, "n_tags": 16121,
        "ng_sha256": "b0f3ecd167f9abb4fbe752c474ec678d"
                     "2981dbe0e1dd2c33f2f563d6c42f4385",
        "ng_bytes": 6250029,
        "tagset_sha256": "9a6c123f03eae3a72c29ed517aa0ec44"
                         "b85e9576a9e132d481fd1e2c9c869329",
        "info_sha256": "2087ffcbf8dc667641d0f4974c05814b"
                       "6f3513d1b28417eba9fa857e6c2b28bb"},
    "synth": {
        "reads": 1000000, "kmers": 81000000, "estimate": 16167709,
        "n_unique": 16031415, "n_tags": 527780,
        "ng_sha256": "9eaf0a0f3259f1489860900f5a1c74b6"
                     "61994bf5f1b3d8cf622b5721733660b1",
        "ng_bytes": 4000000020,
        "tagset_sha256": "ca41862106ef6d7da1287ba21efaf6bc"
                         "c5b94c5e39f13344e4187a38c61c294b",
        "info_sha256": "e579c4422598ee84629d2fc37387b0e5"
                       "95d7dc054dfc0c474f03539bfe2a60cc"},
}
GENOMES = os.path.join(REPO, "data", "stamps-genomes.fa")

# Config 5 through the JAX package (khmer_tpu, CPU, KHMER_TPU_ENGINE=auto):
# do-partition -k 20 -N 4 with --keep-subsets, at -x 12.5e6 on
# data/stamps-reads.fa.gz with --no-big-traverse (phase 10) and without
# (10a), and at -x 8e9 with --no-big-traverse on phase 7b's reads (10b;
# its .part with the partition ids renamed by first appearance).
EXPECT_C5 = {
    "stamps": {
        "n_tags": 16121, "counts": (51, 16025), "subsets": 1, "output": 50,
        "info_sha256": "2382dde94fe52b75ba75f08bcf32631c"
                       "ee392e2557bd8ed9193a9f7dba99d309",
        "pmap_sha256": ["c6c2d8a3174f40b7a8850b7b0a77fb54"
                        "86857917099a3cb048b8e56104ed1d8e"],
        "part_sha256": "c067e37e35bccd0127998d83b6b6e18b"
                       "50db094fc0c4dad5fa2cfb313d986aaf"},
    "stamps_default": {
        "n_tags": 16121, "subsets": 1, "output": 1,
        "info_sha256": "2382dde94fe52b75ba75f08bcf32631c"
                       "ee392e2557bd8ed9193a9f7dba99d309",
        "pmap_sha256": ["d31a2d3d3459bcdefa1bcb8cb521fb8e"
                        "14013a17225d58e612ba7f006e007584"],
        "part_sha256": "3ed3a00c8b25a7b2407d416fd12624c3"
                       "db24c21126e31f4ce94123096b33d974"},
    "synth": {
        "n_tags": 527780, "subsets": 6, "output": 25451,
        "info_sha256": "68ac2e9bad52a42ca06b6b2a12458c34"
                       "2e714140255f5fd2fb8d24d1ac8ed074",
        "pmap_sha256": ["47f4e23abba8c4cb707231005300691b"
                        "56f7458650a6d0f002ec232c147ffeab",
                        "fefb158721a689f22d2020ce625503dc"
                        "ed7be2b9c93405019cc9521bc38dbd2e",
                        "15964cfce44c4c3776999ac22adc39de"
                        "3c595ebbf570e7fe856b056972cf1a82",
                        "81b2170f18ad2022b34e27b4f753e686"
                        "0f52ec5e20e33c496598197d96ecfb21",
                        "8666fd0fb85a2f9fad38bded44e94eef"
                        "2d05a5e8ec650b1ad9a7566b1d297fea",
                        "fc67a22520466654caf9c74383784c7c"
                        "f6aab55e93ad0d0418e2cf483de08ac1"],
        "renamed_part_sha256": "d45416e56258d788abd56c789929f70a"
                               "6d281100faa479269b6cb7cbb43a2f2e"},
}
GOLDEN_PMAP = os.path.join(REPO, "tests", "golden", "stamps_ref_pmap.txt.gz")

# The knot pipeline through the JAX package (khmer_tpu, CPU,
# KHMER_TPU_ENGINE=auto): phase 11's CLIs on data/stamps-reads.fa.gz, and
# phase 11b's find-knots on phase 9b's graph with phase 10b's subsets
# (their .pmap files in sorted order).
EXPECT_C11 = {
    "stamps": {
        "graph_sha256": [EXPECT_C4["stamps"]["ng_sha256"],
                         EXPECT_C4["stamps"]["tagset_sha256"]],
        "initial": (453465, "538adfd7b35e8a0890b39ac14790a020"
                            "7945c6c2c7a9f9c6e69e2a7b6629b58a"),
        "pmap_sha256": "0d599d9c29c7f9242155e4630a054002"
                       "eb3ddf7d13d37ea0639f7303ef12a7d3",
        "stoptags": (453465, "538adfd7b35e8a0890b39ac14790a020"
                             "7945c6c2c7a9f9c6e69e2a7b6629b58a"),
        "repartitioned": [15],
        "stopfilt_sha256": "7fafb2cf0e28f25036aa821c3a454cb1"
                           "a17d5cc12120b566f52b36499ad91f5d",
        "output": 241,
        "part_sha256": "23a0801ad82490805042f6799f5747d7"
                       "7e8ba239805ef3c7644ccb8e36d7216b",
        "extract": {"dist": "5d99a1d5409500be627fbc63ef198469"
                            "9356131b82eb9b4bfc396ba97bfb6790",
                    "groups": ["e09d4d8a505e191db197064d2b2c3356"
                               "ae2bbdf0d151bb0da81fefdb3daf020f"]},
        "extract10": {"dist": "d843ea312277840dfb6592afb1d91fb3"
                              "2463bf093177da754474f823ccb901cd",
                      "groups": ["d73ed13c4c13d198c9b064e5bcf8af56"
                                 "f4827e793362c4739a85cdc6549e275b"]}},
    "synth": {
        "stoptags": (10063, "16b0ac5c1007c8d7c3a25e97d2448bf8"
                            "52dbeb470ffb96c5beb981cc9f84dad0"),
        "repartitioned": [35, 43, 51, 56, 56, 56]},
}


# The Countgraph graph through the JAX package (khmer_tpu, CPU,
# KHMER_TPU_ENGINE=auto; count-median under =device, whose float32 sums
# the port follows, ROADMAP section 3): phase 12 on data/stamps-reads.fa.gz
# with Countgraph(20, 12.5e6, 4) and bigcount on (consume: reads, new
# k-mers, n_unique, tags, .tagset and .ct sha256; partition and abundance:
# count_partitions and the .pmap sha256; sweeps of the first 1,000 reads:
# the tags found and the sha256 of _tag_lists_sha256; cpf: consume_
# partitioned_fasta of phase 10's .part into a fresh graph: reads, k-mers,
# tags and the .pmap sha256; median: count-median's CSV on phase 4b's .ct
# over data/25k.fq.gz), and phase 12b at -x 1e9 on phase 7b's reads.
EXPECT_C12 = {
    "stamps": {
        "consume": [200000, 536430, 536430, 16121,
                    "9a6c123f03eae3a72c29ed517aa0ec44"
                    "b85e9576a9e132d481fd1e2c9c869329",
                    "0133f147186ad91816c1c86bc18892fd"
                    "4d2a5420e500a3123f188bc70fb35b92"],
        "partition": [[51, 16025], "c6c2d8a3174f40b7a8850b7b0a77fb54"
                                   "86857917099a3cb048b8e56104ed1d8e"],
        "abundance": [[450, 12140], "ea8c8cbb3dc813db21911d3ba4f53eef"
                                    "7d5d1258b953279ac9db25324f0d8998"],
        "sweep 0": [42475, "1f9dd5d1839641dddf132ebe3382888a"
                           "1c9fb4715f898549d4b6897824be0368"],
        "sweep 81": [714784, "7d52422ff380c554e58260f086addbaa"
                             "5ed9c5b671520dc9732746883f4a62bc"],
        "cpf": [5723, 463563, 1889, "83b582d1a7493769b47000865c2ba1a9"
                                    "0dac86725185afcc49ac9b469e2170c1"],
        "median": "8c801eaaa7b00d857917a71501069b9c"
                  "699568785ff1aad79a4b8c3f92e41e8f"},
    "synth": {
        "consume": [1000000, 16031414, 16031414, 527780,
                    "ca41862106ef6d7da1287ba21efaf6bc"
                    "c5b94c5e39f13344e4187a38c61c294b"],
        "abundance": [[61, 227949], "da3fcce3c8cd5a8847a2bff1eea3b5d5"
                                    "d7e1ddec2441c566eba4a8cc985f63e0"],
        "median": "4af79cb431ae8e94e73c3624fc215793"
                  "4dbd5e0b4f7210116cef3f6521db6e88"},
}


# Phases 13 and 13b through the JAX package (khmer_tpu, CPU,
# KHMER_TPU_ENGINE=auto; the CPU tests hold the port to both engines on
# smaller inputs, tests/test_torch_small_count_cli.py), --small-count: the
# sha256 of each output, n_unique, kept reads, and for trim-low-abund the
# reads written and (removed, trimmed). Phase 13: load-into-counting and
# abundance-dist-single -k 20 -x 5e7 -N 4 and filter-abund-single -k 20
# -x 5e7 -C 2 on data/25k.fq.gz; normalize-by-median -C 20 -s (a nibble
# never reaches 20: every read is kept) and trim-low-abund -k 20 -x 5e7
# -N 4 -C 2 -s, with and without -V, on data/stamps-reads.fa.gz; load-graph
# -k 20 -x 12.5e6 -N 4 of those reads, make-initial-stoptags -x 2e8 -N 4
# (the .stoptags), partition-graph -S and find-knots -x 2e8 -N 4. Phase
# 13b: load-into-counting and abundance-dist-single -k 20 -x 2e9 -N 4 on
# phase 7b's reads, normalize-by-median -C 20 -x 2e9 -N 4 on their first
# 250,000.
EXPECT_C13 = {
    "load": ["e621a312bd5ed06d4adc09b0bb746dd1"
             "cf16d4b2bed69ae0c5bafc39c5633444", 1246182],
    "single": "49b1e623b01c09e421de7678b5d5369a"
              "49c41d95eb45d7db9d8f74da5d76e059",
    "filter_single": "9f577c7ab26cfd6eb8b31cd665c9a8d0"
                     "3b7ea4f82f656f2cba500702d36843a6",
    "normalize": [200000, 868524, "fe07588c3b783881e1ec426b1056bb31"
                                  "c0b9d6f680a4159ad3ce99b12bff4cdd",
                  "14921fc7e70c07909b2c8dc0004349ce"
                  "069b2fae635a294e664348b70320adc5"],
    "trim": [196955, [3045, 20730], "1cf61e04e1623700540e41388a93a65a"
                                    "7cb1e91aceb98da4f66082fb7bdba638",
             "99e9fddbf9f89ecdf7b31d566f36363d"
             "2e64e1e9e24235150f5b9f7caff78979"],
    "trim-V": [200000, [0, 0], "fe07588c3b783881e1ec426b1056bb31"
                               "c0b9d6f680a4159ad3ce99b12bff4cdd",
               "99e9fddbf9f89ecdf7b31d566f36363d"
               "2e64e1e9e24235150f5b9f7caff78979"],
    "initial": "538adfd7b35e8a0890b39ac14790a020"
               "7945c6c2c7a9f9c6e69e2a7b6629b58a",
    "knots": ["538adfd7b35e8a0890b39ac14790a020"
              "7945c6c2c7a9f9c6e69e2a7b6629b58a", [15]],
    "synth": {
        "load": ["ae3eea903917c2befdbdb50681413b5b"
                 "2db038bc69dd12b2d34efe8cec0e2b89", 16031415],
        "single": "1adf59b8e1beaa30d272a733deb61630"
                  "a513f544e85355cd6355ccfe406da2f3",
        "normalize": [250000, 6705606, "0910d469976dc4f30c0960a57486850f"
                                       "901032b320a8e83127bdb7b7f730b220"],
        # JAX auto, filter-abund-single of the first 250,000 reads at -k
        # 20 -x 2e9 -N 4 -C 2 --small-count (20.3 GB of host memory)
        "filter_single": "1121e7027f41f9fcd23b8f99443e8813"
                         "c2027c3b68b0bcad0218d054c6bad26c"},
}


# Phases 14 and 14b through the JAX package (khmer_tpu, CPU,
# KHMER_TPU_ENGINE=auto; the CPU tests hold the port to both engines on
# smaller inputs, tests/test_torch_sketch_family.py and
# tests/test_torch_nibble_graph.py): the steps of family_steps and
# family_scale_steps run over JAX's classes in place of PortFamily. The
# "synth" answers are phase 14b's at its full 4 GB of tables (1,005 s and
# 21.0 GB of host memory on the CPU, scripts/peak_rss.py).
EXPECT_C14 = {
    "Counttable": [[25000, 1248896], 1246181, 1215488,
                   "8856afc5c9f7e121dfe793b4f1ac3d03"
                   "dfc5080d7000b688e32af06b7848ead6",
                   "d4a60ee186e8fc08394436cd54627a02"
                   "8c8c351170ac9adbd905244f1e50034b"],
    "SmallCounttable": [[25000, 1248896], 1246182, 1230733,
                        "536f076ab2e94b042833d79a17b3894a"
                        "c81c20e8c8865899c9450410d7527191",
                        "d4a60ee186e8fc08394436cd54627a02"
                        "8c8c351170ac9adbd905244f1e50034b"],
    "Nodetable": [[25000, 1248896], 1246182, 1242365,
                  "f5d44159930e034ca97dcb8d8f586bf1"
                  "64801448ad9a50783acd2b22927f49ee",
                  "602f41e16a91ef6c24ada65b7d72ce44"
                  "ecdf9dd41d7d5076cf59c1623757965d"],
    "BlockedCounttable": [[25000, 1248896], 1246161, 1215841,
                          "fb100ad6f7a814b9e93d7c7baa762d04"
                          "33e955fbc03363da6d9d50209626b633",
                          "d4a60ee186e8fc08394436cd54627a02"
                          "8c8c351170ac9adbd905244f1e50034b"],
    "CyclicCounttable": [[25000, 1248896], 1246181, 1215541,
                         "7f76a9029045661cbf0621af7c6439dd"
                         "20618b8c7e8c844e93d0767853064b41",
                         "d4a60ee186e8fc08394436cd54627a02"
                         "8c8c351170ac9adbd905244f1e50034b"],
    "mask unmasked": [[200000, 164212], 139642,
                      "ec38f45d6d57c39a9ccafe7c728a2820"
                      "a89b4355b90bf8fca68de778336fb940"],
    "mask masked": [[200000, 16200000], 536430,
                    "36b0658ccac3ae01a0d33814b3867993"
                    "91d45c879a572aa4dd5e31cb119e1756"],
    "bands": [[25000, 312961], [25000, 312153], [25000, 312078],
              [25000, 311704],
              "8856afc5c9f7e121dfe793b4f1ac3d03"
              "dfc5080d7000b688e32af06b7848ead6"],
    "band mask": [[200000, 4064957], 134006,
                  "3134db101c28df9973aaf0e6837abc4b"
                  "2605dd742de95974598dc528fa5ea631"],
    "graph": [[200000, 536430], 536430, 16121,
              "9a6c123f03eae3a72c29ed517aa0ec44"
              "b85e9576a9e132d481fd1e2c9c869329",
              "99e9fddbf9f89ecdf7b31d566f36363d"
              "2e64e1e9e24235150f5b9f7caff78979"],
    "partition": [[51, 16025],
                  "c6c2d8a3174f40b7a8850b7b0a77fb54"
                  "86857917099a3cb048b8e56104ed1d8e"],
    "abundance": [[467, 11932],
                  "55f1e3012b24da87d53774a9cd857335"
                  "12005b84cbf2156fd3dcc1fa96d1e40a"],
    "sweep 81": [714784,
                 "7d52422ff380c554e58260f086addbaa"
                 "5ed9c5b671520dc9732746883f4a62bc"],
    "synth": {
        "Counttable": [[1000000, 81000000], 16031415, 15904130,
                       "512c70e79928229f547336b01abe79d4"
                       "bb862271c5268d5eb6d105189fa670e6"],
        "SmallCounttable": [[1000000, 81000000], 16031415, 15967574,
                            "d060877741506d8b4a09bc1a342692a1"
                            "43b94b04267555fd7346f519f0092a95"],
        "mask": [[1000000, 10796973], 10385566,
                 "3875f8cadd9c8269ce8cadb0137c2338"
                 "5b9ae5bab31fcb5ba114dc3410aabcdb"],
        "graph": [[1000000, 16031415], 16031415, 527780,
                  "695b8abe450e3addea905d89588360df"
                  "094e2f5c2a196f63d98c1c1688aae846"],
        "abundance": [[736, 526289],
                      "f406df79f13939e44dedf7a024f3af4e"
                      "fdc91e5d2ed6e72b02cbf567ed87b68e"],
    },
}


class SmokeFailure(AssertionError):
    pass


def expect(cond, what):
    if not cond:
        raise SmokeFailure(what)


def say(*parts):
    print(*parts, flush=True)


T0 = time.perf_counter()


def lap(label):
    """The seconds since the script started, after `label`."""
    say("  [%s ends at %.1f s]" % (label, time.perf_counter() - T0))


def bound(nbytes, nops):
    """(least ms the card could take, "bytes" or "operations"): the
    larger of the bytes over the memory rate and the operations over the
    peak rate."""
    by_bytes = nbytes / PEAK_BYTES_S * 1e3
    by_ops = nops / PEAK_OPS_S * 1e3
    if by_bytes >= by_ops:
        return by_bytes, "bytes"
    return by_ops, "operations"


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this script needs one "
              "GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import numpy as np

    from khmer_tpu_torch.core import blocked as B
    from khmer_tpu_torch.core import sketch_kernels as SK
    from khmer_tpu_torch.ops import cuda

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # -- phase 1: device -------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    say(smi)
    kind = torch.cuda.get_device_name(0)
    say("phase 1 device: torch %s cuda %s, %s, %d device(s), %.0f GiB"
        % (torch.__version__, torch.version.cuda, kind,
           torch.cuda.device_count(),
           torch.cuda.get_device_properties(0).total_memory / 2**30))
    card = "%s [%s]" % (kind, smi)

    # -- phase 2: build --------------------------------------------------
    seconds, report = cuda.build()
    cuda.library()
    for line in report.splitlines():
        if "registers" in line or "Compiling entry" in line:
            say("  ptxas:", line.strip())
    say("phase 2 build: %.1f s (nvcc, sm_90a) -> %s"
        % (seconds, os.path.relpath(cuda.LIB_PATH, REPO)))
    lap("phase 2")

    # -- phase 3: kernels vs plain versions, exact -------------------------
    errs = {name: 0 for name in ("blocked_update", "blocked_gather",
                                 "byte_update", "byte_gather",
                                 "histogram_add", "proto_rmw",
                                 "diginorm_med", "diginorm_scan",
                                 "trim_mark", "trim_probe", "trim_scan",
                                 "read_counts", "bit_update", "hll_add",
                                 "neighbors", "byte_pertable",
                                 "byte_neighbors", "byte_neighbors_small",
                                 "nibble_update", "nibble_gather",
                                 "nibble_pertable", "nibble_pertable_rows",
                                 "nibble_row_counts", "consume_filter",
                                 "nibble_neighbors",
                                 "nibble_neighbors_small")}
    cases = adversarial_cases(np)
    for name, nb, chunks in cases:
        run_exact_case(torch, np, B, SK, dev, name, nb, chunks, errs)
    byte_cases = byte_adversarial_cases(np)
    for name, primes, chunks in byte_cases:
        run_byte_case(torch, np, SK, dev, name, primes, chunks, errs)
    n_hist = run_histogram_cases(torch, np, SK, dev, errs)
    n_proto = run_proto_cases(torch, np, B, dev, errs)
    n_edges = run_gather_edge_cases(torch, np, SK, dev, errs)
    n_edges2 = run_gather2_edge_cases(torch, np, B, dev, errs)
    n_digi = run_diginorm_cases(torch, dev, errs)
    n_trim = run_trim_cases(torch, dev, errs)
    n_bit, n_hll = run_graph_cases(torch, dev, errs)
    n_nbr = run_neighbor_cases(torch, dev, errs)
    n_pert = run_pertable_cases(torch, dev, errs)
    n_cg = run_countgraph_cases(torch, dev, errs)
    n_nib = run_nibble_cases(torch, dev, errs)
    n_fam = run_family_cases(torch, dev, errs)
    say("phase 3 exact: kernel == plain on %d blocked, %d byte, %d "
        "histogram, %d decoded-event, %d byte-gather-reduction, %d "
        "blocked-gather-reduction, %d diginorm, %d trim, %d bit-table, "
        "%d HLL, %d neighbour-probe, %d per-table-gather, %d Countgraph "
        "graph, %d nibble-table and %d sketch-family cases (tables, flags, "
        "n_unique, bigcount reports, counts, keep flags, branches, trim "
        "positions, registers, neighbour bytes, counters, kept hashes)"
        % (len(cases), len(byte_cases), n_hist, n_proto, n_edges, n_edges2,
           n_digi, n_trim, n_bit, n_hll, n_nbr, n_pert, n_cg, n_nib,
           n_fam))
    lap("phase 3")

    # -- phase 4: config 1, blocked, through the port's entry points -------
    launches = run_config1(torch, B, SK, dev, card, errs)
    lap("phase 4")

    # -- phase 4b: config 1, exact layout, through the CLIs ---------------
    exact_launches, exact_timings = run_config1_exact(torch, np, SK, dev,
                                                      card, errs)
    launches.update(exact_launches)
    lap("phase 4b")

    # -- phase 5: scale, blocked -------------------------------------------
    one = stream_hashes(np)
    timings = run_scale(torch, np, B, dev, card, errs, one)
    lap("phase 5")

    # -- phase 5b: scale, exact layout -------------------------------------
    timings.update(exact_timings)
    timings.update(run_scale_exact(torch, np, SK, dev, card, errs, one))
    lap("phase 5b")

    # -- phase 6: microbenchmarks -------------------------------------------
    timings.update(run_microbench(B, card, launches, errs))
    lap("phase 6")

    # -- phase 7: config 2, normalize-by-median, through the CLI -----------
    digi_launches, digi_timings = run_config2(torch, SK, dev, card, errs)
    launches.update(digi_launches)
    timings.update(digi_timings)
    lap("phase 7")

    with tempfile.TemporaryDirectory(prefix=".chip_smoke_",
                                     dir=REPO) as tmp:
        reads, gen_s = synth_reads(tmp)
        head = synth_head(reads)
        # what phases 9b, 10 and 10b leave for phases 11 and 11b
        kept = os.path.join(tmp, "kept")
        synth_kept = os.path.join(kept, "synth")
        os.makedirs(synth_kept)

        # -- phase 7b: config 2 at 4 GB of tables ----------------------------
        ct_7b = os.path.join(kept, "synth.ct")
        run_config2_scale(torch, SK, dev, card, errs, reads, head, gen_s,
                          ct_7b)
        lap("phase 7b")

        # -- phase 8: config 3 through the CLIs ------------------------------
        trim_launches, trim_timings = run_config3(torch, SK, dev, card,
                                                  errs)
        launches.update(trim_launches)
        timings.update(trim_timings)
        lap("phase 8")

        # -- phase 8b: trim-low-abund at 4 GB of tables ----------------------
        run_config3_scale(torch, SK, dev, card, errs, reads, head)
        lap("phase 8b")

        # -- phase 9: config 4, unique-kmers and load-graph, through the CLIs
        graph_launches, _ = run_config4(torch, SK, dev, card, errs,
                                        "phase 9", GENOMES, "2.5e7",
                                        EXPECT_C4["genomes"])
        launches.update(graph_launches)
        lap("phase 9")

        # -- phase 9a: config 4 on the real read set ------------------------
        _, first_block = run_config4(torch, SK, dev, card, errs, "phase 9a",
                                     STAMPS, "12.5e6", EXPECT_C4["stamps"])
        timings["hll_add"] = time_hll_block(torch, SK, dev, card, errs,
                                            first_block)
        lap("phase 9a")

        # -- phase 9b: load-graph on 4 GB of bit tables ----------------------
        ng, _ = run_config4(torch, SK, dev, card, errs, "phase 9b", reads,
                            "8e9", EXPECT_C4["synth"], keep_graph=True,
                            keep_dir=synth_kept)
        timings["bit_update"] = time_bit_chunk(torch, SK, dev, card, errs,
                                               ng, reads)
        del ng
        torch.cuda.empty_cache()
        lap("phase 9b")
        trace_config4(torch, card, reads)
        lap("phase 9's traces")

        # -- phase 10: config 5, do-partition, through the CLI ---------------
        l_launches, stamps_frontier = run_config5(
            torch, SK, dev, card, errs, "phase 10", STAMPS, "12.5e6",
            ["--no-big-traverse"], EXPECT_C5["stamps"], every=1,
            keep_files=[("stamps-reads.fa.gz.part",
                         os.path.join(kept, "p10.part"))])
        lap("phase 10")

        # -- phase 10a: the CLI's default walk ------------------------------
        run_config5(torch, SK, dev, card, errs, "phase 10a", STAMPS,
                    "12.5e6", [], EXPECT_C5["stamps_default"], every=1)
        lap("phase 10a")

        # -- phase 10b: do-partition on 4 GB of bit tables -------------------
        _, synth_frontier = run_config5(
            torch, SK, dev, card, errs, "phase 10b", reads, "8e9",
            ["--no-big-traverse"], EXPECT_C5["synth"], every=8,
            keep_files=[("g.subset.%d.pmap" % i, os.path.join(
                synth_kept, "g.subset.%d.pmap" % i)) for i in range(6)])
        launches["neighbors"] = l_launches
        time_neighbors(torch, SK, card, errs, "phase 10", stamps_frontier)
        del stamps_frontier
        timings["neighbors"] = time_neighbors(torch, SK, card, errs,
                                              "phase 10b", synth_frontier)
        del synth_frontier
        torch.cuda.empty_cache()
        lap("phase 10b")

        # -- phase 11: the knot pipeline on the stamps reads -----------------
        launches["byte_pertable"], timings["byte_pertable"] = run_knots(
            torch, SK, dev, card, errs, kept)
        torch.cuda.empty_cache()
        lap("phase 11")

        # -- phase 11b: find-knots on phase 10b's graph and subsets ----------
        run_knots_scale(torch, SK, dev, card, errs, synth_kept)
        torch.cuda.empty_cache()
        lap("phase 11b")

        # -- phase 12: the Countgraph graph at config 5's shape --------------
        cg_launches, checks = run_countgraph(torch, SK, dev, card, errs,
                                             kept)
        n_times = time_countgraph_kernels(torch, SK, card, errs, checks,
                                          "phase 12")
        del checks
        lap("phase 12")

        # -- phase 12b: the same graph at 4 GB --------------------------------
        checks, scale_launches = run_countgraph_scale(torch, SK, dev, card,
                                                      errs, reads, ct_7b)
        scale_times = time_countgraph_kernels(torch, SK, card, errs, checks,
                                              "phase 12b")
        del checks
        torch.cuda.empty_cache()
        # N's kernels-line times: the staged mode on phase 12's largest
        # level, the small-level mode on 12b's largest below the crossover
        timings["byte_neighbors"] = n_times["byte_neighbors"]
        timings["byte_neighbors_small"] = scale_times.get(
            "byte_neighbors_small", n_times.get("byte_neighbors_small"))
        for key in ("byte_neighbors", "byte_neighbors_small"):
            launches[key] = cg_launches[key] + scale_launches[key]
        lap("phase 12b")

        # -- phase 13: --small-count (nibble tables) through the CLIs --------
        nib_launches, knot_checks = run_small_count(torch, SK, dev, card,
                                                    errs)
        lap("phase 13")

        # -- phase 13b: --small-count at 4 GB of nibble tables ---------------
        scale_launches, nib_checks = run_small_count_scale(
            torch, SK, dev, card, errs, reads, head)
        timings.update(time_nibble_kernels(torch, SK, card, errs,
                                           nib_checks, knot_checks))
        del nib_checks, knot_checks
        torch.cuda.empty_cache()
        for key, n in nib_launches.items():
            launches[key] = n + scale_launches[key]
        lap("phase 13b")

        # -- phase 14: the sketch family (kernel S, N's nibble mode) --------
        fam_launches, fam_checks = run_family(torch, SK, B, dev, card, errs)
        n_times = time_nibble_neighbors(torch, SK, card, errs,
                                        fam_checks["nibble_neighbors"],
                                        "phase 14")
        del fam_checks
        torch.cuda.empty_cache()
        lap("phase 14")

        # -- phase 14b: the sketch family at 4 GB of tables -----------------
        scale_launches, fam_checks = run_family_scale(
            torch, SK, B, dev, card, errs, reads, head)
        timings.update(time_consume_filter(torch, SK, card, errs,
                                           fam_checks))
        scale_times = time_nibble_neighbors(torch, SK, card, errs,
                                            fam_checks["nibble_neighbors"],
                                            "phase 14b")
        del fam_checks
        torch.cuda.empty_cache()
        # N's nibble mode in the kernels line: its staged mode on phase
        # 14's largest level, its small-level mode on 14b's largest below
        # the crossover
        timings["nibble_neighbors"] = n_times["nibble_neighbors"]
        timings["nibble_neighbors_small"] = scale_times.get(
            "nibble_neighbors_small", n_times.get("nibble_neighbors_small"))
        for key in ("consume_filter", "nibble_neighbors",
                    "nibble_neighbors_small"):
            launches[key] = fam_launches[key] + scale_launches[key]
        lap("phase 14b")

    kernels = []
    for name, source, replaces in (
            ("blocked_update", "blocked_update.cu",
             "khmer_tpu/ops/pallas_blocked.py:63"),
            ("blocked_gather", "blocked_gather.cu",
             "khmer_tpu/core/blocked.py:158"),
            ("byte_update", "byte_update.cu",
             "khmer_tpu/core/sketch_kernels.py:496"),
            ("byte_gather", "byte_gather.cu",
             "khmer_tpu/core/sketch_kernels.py:649"),
            ("histogram_add", "histogram.cu",
             "scripts/profile_scatter2.py:59"),
            ("proto_rmw", "proto_rmw.cu", "scripts/pallas_proto.py:44"),
            ("diginorm_med", "diginorm_med.cu",
             "khmer_tpu/core/diginorm_scan.py:93"),
            ("diginorm_scan", "diginorm_scan.cu",
             "khmer_tpu/core/diginorm_scan.py:127"),
            ("trim_mark", "trim_prepass.cu",
             "khmer_tpu/core/diginorm_scan.py:168"),
            ("trim_probe", "trim_prepass.cu",
             "khmer_tpu/core/diginorm_scan.py:168"),
            ("trim_scan", "trim_scan.cu",
             "khmer_tpu/core/diginorm_scan.py:168"),
            ("read_counts", "read_counts.cu",
             "khmer_tpu/core/pipeline.py:755"),
            ("bit_update", "bit_update.cu",
             "khmer_tpu/core/sketch_kernels.py:204"),
            ("hll_add", "hll_add.cu", "khmer_tpu/core/hll.py:65"),
            ("neighbors", "neighbors.cu",
             "khmer_tpu/core/graphmixin.py:30"),
            ("byte_pertable", "byte_gather.cu",
             "khmer_tpu/core/sketch_kernels.py:681"),
            ("byte_neighbors", "neighbors.cu",
             "khmer_tpu/core/graphmixin.py:30"),
            ("byte_neighbors_small", "neighbors.cu",
             "khmer_tpu/core/graphmixin.py:30"),
            ("nibble_update", "nibble_update.cu",
             "khmer_tpu/core/sketch_kernels.py:198"),
            ("nibble_gather", "nibble_gather.cu",
             "khmer_tpu/core/sketch_kernels.py:649"),
            ("nibble_pertable", "nibble_gather.cu",
             "khmer_tpu/core/sketch_kernels.py:681"),
            ("nibble_pertable_rows", "nibble_gather.cu",
             "khmer_tpu/core/diginorm.py:36"),
            ("nibble_row_counts", "nibble_gather.cu",
             "khmer_tpu/core/pipeline.py:503"),
            ("consume_filter", "consume_filter.cu",
             "khmer_tpu/core/pipeline.py:163"),
            ("nibble_neighbors", "neighbors.cu",
             "khmer_tpu/core/graphmixin.py:30"),
            ("nibble_neighbors_small", "neighbors.cu",
             "khmer_tpu/core/graphmixin.py:30")):
        t = timings[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "khmer_tpu_torch/csrc/" + source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t.get("library_ms")})
    for k in kernels:
        expect(k["max_abs_err"] == 0, "%s differs from its plain version"
               % k["name"])
        expect(k["launches"] > 0, "%s never launched on its path"
               % k["name"])
    say(smi)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


# ---------------------------------------------------------------------------
# phase 3: adversarial cases
# ---------------------------------------------------------------------------


def adversarial_cases(np):
    """(name, nblocks, [(hashes u64 [M], nvalid), ...]) from fixed seeds."""
    rng = np.random.default_rng(20261016)
    M = 4096

    def full(n):
        return rng.integers(0, 2**64, n, dtype=np.uint64)

    high = full(M) | np.uint64(1 << 63)
    pool = full(300)
    dup = pool[rng.integers(0, 300, M)]
    sat7 = [(full(30000), 30000) for _ in range(3)]
    pool50 = full(50)
    sat101 = [(pool50[rng.integers(0, 50, 20000)], 20000) for _ in range(4)]
    pad = full(M)
    pad[:7] = 0  # hash 0 is the all-A k-mer: a real event inside nvalid
    pad[3000:] = 0
    seq = [(full(65536), 65536 - 1000 * i) for i in range(4)]
    for h, nvalid in seq:
        h[nvalid:] = 0
    one = [(np.full(CHUNK, full(1)[0]), CHUNK) for _ in range(2)]
    crowded = [(crowded_hashes(np, rng, 1 << 16, 400, 100003), 1 << 16)
               for _ in range(2)]
    return [
        ("hashes>=2^63", 101, [(high, M)]),
        ("duplicates", 101, [(dup, M), (dup[::-1].copy(), M)]),
        ("saturate-7-blocks", 7, sat7),
        ("saturate-101-blocks", 101, sat101),
        ("zero-padded-tail", 101, [(pad, 3000)]),
        ("chunk-sequence", 100003, seq),
        ("one-hash-x2^20", 101, one),
        ("full-chunk-7-blocks", 7, [(full(CHUNK), CHUNK)]),
        ("crowded-bucket", 100003, crowded),
    ]


CHUNK = 1 << 20  # core/pipeline.py DENSE_CHUNK


def crowded_hashes(np, rng, n, width, modulus):
    """n hashes whose residues mod `modulus` all lie below `width`: every
    event of the chunk on a narrow counter range, with far more distinct
    counters than one bucket's map of the update kernels holds."""
    low = rng.integers(0, width, n, dtype=np.uint64)
    k = rng.integers(0, 2**64 // modulus - 1, n, dtype=np.uint64)
    return low + k * np.uint64(modulus)


def _dev_hashes(torch, np, h, dev):
    return torch.from_numpy(np.ascontiguousarray(h).view(np.int64)).to(dev)


def run_exact_case(torch, np, B, SK, dev, name, nb, chunks, errs):
    tab_k = torch.zeros((nb, B.LANES), dtype=torch.uint8, device=dev)
    tab_p = tab_k.clone()
    nu_k = torch.zeros(1, dtype=torch.int64, device=dev)
    nu_p = nu_k.clone()
    scratch = None  # kept between chunks, as a sketch keeps it
    seen = []
    for h, nvalid in chunks:
        hd = _dev_hashes(torch, np, h, dev)
        scratch = SK.update_scratch(scratch, nvalid, B.SUB, dev)
        fk = B.blocked_update_cuda(tab_k, hd, nvalid, nu_k, scratch)
        fp = B.blocked_update_plain(nb, (tab_p,), nu_p, hd, nvalid)
        torch.cuda.synchronize()
        diff = int((tab_k.int() - tab_p.int()).abs().max())
        errs["blocked_update"] = max(errs["blocked_update"], diff,
                                     int((fk != fp).sum()),
                                     abs(int(nu_k) - int(nu_p)))
        expect(diff == 0 and torch.equal(fk, fp)
               and int(nu_k) == int(nu_p),
               "blocked_update != plain on case %s" % name)
        seen.append(h[:nvalid])
    q = _dev_hashes(torch, np, np.concatenate(
        seen + [np.random.default_rng(nb).integers(
            0, 2**64, 1000, dtype=np.uint64)]), dev)
    ck = B.blocked_gather_cuda(tab_k, q)
    cp = B.gather_counts_plain(nb, (tab_p,), q)
    d = int((ck - cp).abs().max())
    errs["blocked_gather"] = max(errs["blocked_gather"], d)
    expect(d == 0, "blocked_gather != plain on case %s" % name)
    say("  case %-20s nblocks %6d, %d chunk(s): n_unique %d, max count %d"
        % (name, nb, len(chunks), int(nu_k), int(tab_k.max())))


def byte_adversarial_cases(np):
    """(name, primes, [(hashes u64 [M], nvalid), ...]) from fixed seeds."""
    rng = np.random.default_rng(20261017)
    M = 4096

    def full(n):
        return rng.integers(0, 2**64, n, dtype=np.uint64)

    four = (1009, 1013, 1019, 1021)
    high = full(M) | np.uint64(1 << 63)
    pool = full(300)
    dup = pool[rng.integers(0, 300, M)]
    tiny = [(full(30000), 30000) for _ in range(3)]
    pool50 = full(50)
    big = [(pool50[rng.integers(0, 50, 20000)], 20000) for _ in range(4)]
    pad = full(M)
    pad[:7] = 0  # hash 0 is the all-A k-mer: a real event inside nvalid
    pad[3000:] = 0
    seq = [(full(65536), 65536 - 1000 * i) for i in range(4)]
    for h, nvalid in seq:
        h[nvalid:] = 0
    # hashes below 20,000 < every prime: each table's counters crowd into
    # its first 20,000 bytes
    crowded = [(rng.integers(0, 20000, 1 << 16, dtype=np.uint64), 1 << 16)
               for _ in range(2)]
    million = (999983, 999979, 999961, 999959)
    return [
        ("hashes>=2^63", four, [(high, M)]),
        ("duplicates", four, [(dup, M), (dup[::-1].copy(), M)]),
        ("bin-collisions-7-11-13", (7, 11, 13), tiny),
        ("bigcount-triggers", (10007, 10009, 10037, 10039), big),
        ("zero-padded-tail", four, [(pad, 3000)]),
        ("chunk-sequence", million, seq),
        # bigcount through 255 inside one chunk, then past it
        ("one-hash-x2^20", million,
         [(np.full(CHUNK, full(1)[0]), CHUNK) for _ in range(2)]),
        ("full-chunk-tiny-primes", (7, 11, 13), [(full(CHUNK), CHUNK)]),
        ("crowded-bucket", million, crowded),
    ]


def _fold(bigcounts, triggers, max_kcount=255, max_bigcount=65535):
    """Sketch._bigcount_add over a {hash: triggers} dict."""
    for h, t in triggers.items():
        b = bigcounts.get(h, 0)
        bigcounts[h] = min(max(b, max_kcount) + t, max_bigcount)


def _report_triggers(np, SK, report):
    """{hash: triggers} of an update's bigcount report (kernel or plain:
    its first n_cand entries)."""
    cand_hash, cand_old, n_cand = report
    n = int(n_cand[0])
    return SK.bigcount_triggers(cand_hash[:n].cpu().numpy().view(np.uint64),
                                cand_old[:n].cpu().numpy())


def run_byte_case(torch, np, SK, dev, name, primes, chunks, errs):
    flat_k = torch.zeros(SK.byte_flat_size(primes), dtype=torch.uint8,
                         device=dev)
    flat_p = flat_k.clone()
    nu_k = torch.zeros(1, dtype=torch.int64, device=dev)
    nu_p = nu_k.clone()
    scratch = None  # kept between chunks, as a sketch keeps it
    big_k, big_p = {}, {}
    seen = []
    for h, nvalid in chunks:
        hd = _dev_hashes(torch, np, h, dev)
        scratch = SK.update_scratch(scratch, nvalid, len(primes), dev)
        rk = SK.byte_update_cuda(primes, flat_k, nu_k, hd, nvalid,
                                 with_bigcount=True, scratch=scratch)
        rp = SK.byte_update_plain(primes, flat_p, nu_p, hd, nvalid,
                                  with_bigcount=True)
        _fold(big_k, _report_triggers(np, SK, rk))
        _fold(big_p, _report_triggers(np, SK, rp))
        diff = int((flat_k.int() - flat_p.int()).abs().max())
        errs["byte_update"] = max(errs["byte_update"], diff,
                                  abs(int(nu_k) - int(nu_p)),
                                  0 if big_k == big_p else 1)
        expect(diff == 0 and int(nu_k) == int(nu_p) and big_k == big_p,
               "byte_update != plain on case %s" % name)
        seen.append(h[:nvalid])
    q = _dev_hashes(torch, np, np.concatenate(
        seen + [np.random.default_rng(len(primes)).integers(
            0, 2**64, 1000, dtype=np.uint64)]), dev)
    d = int((SK.byte_gather_cuda(primes, flat_k, q)
             - SK.byte_gather_plain(primes, flat_p, q)).abs().max())
    errs["byte_gather"] = max(errs["byte_gather"], d)
    expect(d == 0, "byte_gather != plain on case %s" % name)
    say("  byte case %-22s primes %s, %d chunk(s): n_unique %d, max count "
        "%d, bigcount entries %d"
        % (name, list(primes), len(chunks), int(nu_k), int(flat_k.max()),
           len(big_k)))


def run_histogram_cases(torch, np, SK, dev, errs):
    """Kernel C against its plain version: mixed indices (hot bins, the top
    bin, out of range both sides, wrapped negatives) at three shapes;
    abundance-dist's shape, accumulated twice into a nonzero histogram;
    indices crowded onto the edges of each block's private bins [0, 256)
    and of the global ones; and an input split into launches under a
    lowered per-launch limit, from an offset view."""
    rng = np.random.default_rng(20261018)
    n_cases = 0

    def check(idx_d, start, what, times=1):
        got, want = start.clone(), start.clone()
        for _ in range(times):
            SK.histogram_add_cuda(got, idx_d)
            SK.histogram_add_plain(want, idx_d)
        d = int((got - want).abs().max())
        errs["histogram_add"] = max(errs["histogram_add"], d)
        expect(d == 0, "histogram_add != plain on %s" % what)

    for m, nbins in [(1 << 21, 1 << 17), (600000, SK.MAX_BIGCOUNT + 2),
                     (5000, 3)]:
        idx = rng.integers(-5, nbins + 5, m)    # out-of-range both sides
        idx[: m // 2] = rng.integers(0, 4, m // 2)        # hot bins
        idx[m // 2: m // 2 + 1000] = nbins - 1  # the top bin
        # [-nbins, 0) wraps as JAX's .at[].add wraps it; below, dropped
        idx[m // 4: m // 4 + 3000] = rng.integers(-nbins - 5, 0, 3000)
        check(torch.from_numpy(idx).to(dev),
              torch.from_numpy(rng.integers(0, 9, nbins)).to(dev),
              "%d x %d" % (m, nbins))
        n_cases += 1
    # abundance-dist's batch: three quarters past the last bin (dropped)
    nbins = SK.ABUND_BINS
    m = 1_785_856
    idx = np.full(m, nbins, dtype=np.int64)
    live = rng.choice(m, m // 4, replace=False)
    idx[live] = np.minimum(rng.geometric(0.6, len(live)), 255)
    idx[live[:3000]] = -rng.integers(1, nbins + 1, 3000)
    check(torch.from_numpy(idx).to(dev),
          torch.from_numpy(rng.integers(0, 1 << 40, nbins)).to(dev),
          "the abundance shape, accumulated", times=2)
    n_cases += 1
    low = SK.HIST_LOW_BINS
    for nbins in (3, low, low + 1, SK.MAX_BIGCOUNT + 2, 1 << 17, 10**6):
        edges = np.asarray(sorted(
            b for b in {0, 1, low - 2, low - 1, low, low + 1, nbins - 2,
                        nbins - 1} if 0 <= b < nbins), dtype=np.int64)
        idx = np.concatenate([rng.choice(edges, 1 << 20), edges - nbins,
                              rng.integers(-2 * nbins, 2 * nbins, 1 << 16)])
        rng.shuffle(idx)
        check(torch.from_numpy(idx).to(dev),
              torch.from_numpy(rng.integers(0, 9, nbins)).to(dev),
              "private-bin edges of %d bins" % nbins)
        n_cases += 1
    limit = SK.HIST_LAUNCH_LIMIT
    SK.HIST_LAUNCH_LIMIT = 100_000
    try:
        idx = rng.integers(-70_000, 70_000, 345_679)
        idx[::3] = 65_536
        idx_d = torch.from_numpy(idx).to(dev)
        before = SK.histogram_add_cuda.launches
        check(idx_d[1:], torch.ones(65_537, dtype=torch.int64, device=dev),
              "an offset view in launches of 100,000")
        expect(SK.histogram_add_cuda.launches == before + 4,
               "histogram_add split 345,678 indices into %d launches"
               % (SK.histogram_add_cuda.launches - before))
    finally:
        SK.HIST_LAUNCH_LIMIT = limit
    return n_cases + 1


def run_gather2_edge_cases(torch, np, B, dev, errs):
    """Kernel 2 against its plain version (which reduces by `%`) on the
    edges of its reduction by a reciprocal, on random tables of config 1's
    and the layout's largest block count (0.2 and 2.15 GB), on an aligned
    tensor, views one and three hashes in and odd lengths."""
    from khmer_tpu_torch.core.sketch_kernels import get_n_primes_near_x
    from khmer_tpu_torch.scripts.byte_gather_bench import reduction_edges

    sizes = (EXPECT["nblocks"], get_n_primes_near_x(1, B.MAX_BLOCKS + 1)[0])
    for nb in sizes:
        gen = torch.Generator(device=dev).manual_seed(nb)
        table = torch.randint(0, 256, (nb, B.LANES), dtype=torch.uint8,
                              device=dev, generator=gen)
        hd = _dev_hashes(torch, np, reduction_edges((nb,)), dev)
        for h in (hd, hd[1:], hd[3:-3], hd[:13]):
            d = int((B.blocked_gather_cuda(table, h)
                     - B.gather_counts_plain(nb, (table,), h)).abs().max())
            errs["blocked_gather"] = max(errs["blocked_gather"], d)
            expect(d == 0, "blocked_gather != plain on the reduction edges "
                   "of %d blocks" % nb)
        say("  gather2 case %d blocks (%.2f GB random table): %d edge and "
            "random hashes, aligned, offset and of odd length"
            % (nb, nb * B.LANES / 1e9, hd.shape[0]))
        del table
        torch.cuda.empty_cache()
    return len(sizes)


def run_proto_cases(torch, np, B, dev, errs):
    from khmer_tpu_torch.core.sketch_kernels import update_scratch
    from khmer_tpu_torch.scripts import pallas_proto

    bids, offs, table = pallas_proto.correctness_case(
        np.random.default_rng(0))
    cases = [("script-correctness", bids, pallas_proto.pack_offs(offs),
              table, 3)]
    cases += pallas_proto.adversarial_cases(np.random.default_rng(20261019))
    for name, bids, offs, table, passes in cases:
        bids_d = torch.from_numpy(bids).to(dev)
        offs_d = torch.from_numpy(offs).to(dev)
        tab_k = torch.from_numpy(table).to(dev)
        tab_p = tab_k.clone()
        scratch = None  # kept between passes, as the script keeps it
        for _ in range(passes):
            scratch = update_scratch(scratch, len(bids), B.SUB, dev)
            nk = int(B.proto_rmw_cuda(bids_d, offs_d, tab_k, scratch))
            np_ = int(B.proto_rmw_plain(bids_d, offs_d, tab_p))
            d = max(int((tab_k.int() - tab_p.int()).abs().max()),
                    abs(nk - np_))
            errs["proto_rmw"] = max(errs["proto_rmw"], d)
            expect(d == 0, "proto_rmw != plain on case %s" % name)
        say("  proto case %-26s %d events on %d blocks x %d passes: nnew "
            "(last) %d, max count %d" % (name, len(bids), table.shape[0],
                                         passes, nk, int(tab_k.max())))
        del tab_k, tab_p, scratch
    return len(cases)


def run_gather_edge_cases(torch, np, SK, dev, errs):
    """The byte gather against its plain version (which reduces by `%`) on
    the reduction's edge cases, on random tables of each prime set, through
    the paired loads (an aligned tensor) and the single ones (a view one
    hash in, of odd length)."""
    from khmer_tpu_torch.scripts.byte_gather_bench import (PRIME_SETS,
                                                           reduction_edges)

    for label, primes in PRIME_SETS.items():
        gen = torch.Generator(device=dev).manual_seed(len(label))
        flat = torch.randint(0, 256, (SK.byte_flat_size(primes),),
                             dtype=torch.uint8, device=dev, generator=gen)
        hd = _dev_hashes(torch, np, reduction_edges(primes), dev)
        for h in (hd, hd[1:]):
            d = int((SK.byte_gather_cuda(primes, flat, h)
                     - SK.byte_gather_plain(primes, flat, h)).abs().max())
            errs["byte_gather"] = max(errs["byte_gather"], d)
            expect(d == 0, "byte_gather != plain on the reduction edges of "
                   "%s" % label)
        say("  gather case %-12s primes %s (%.2f GB of random tables): %d "
            "edge and random hashes, aligned and offset by one"
            % (label, list(primes), flat.shape[0] / 1e9, hd.shape[0]))
        del flat
        torch.cuda.empty_cache()
    return len(PRIME_SETS)


# ---------------------------------------------------------------------------
# phase 4: config 1 through the CLIs
# ---------------------------------------------------------------------------


def _consume_rates(torch, make, expect_counts, label):
    """Time consume_seqfile of the 25k file on the record path (the CLI's)
    and the native-parser path, in turns."""
    from khmer_tpu_torch.io.fastx import FastxParser

    for path in ("record", "native", "native", "record"):
        g = make()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n_reads, n_kmers = g.consume_seqfile(
            FastxParser(DATA) if path == "record" else DATA)
        n_unique = g.n_unique_kmers()  # the one host sync of the stream
        s = time.perf_counter() - t0
        expect((n_reads, n_kmers, n_unique) == expect_counts,
               "%s consume_seqfile on the %s path" % (label, path))
        say("  config 1 %s consume, %s path: %.6f s = %.6g k-mers/s"
            % (label, path, s, n_kmers / s))
        del g
        torch.cuda.empty_cache()


def run_config1(torch, B, SK, dev, card, errs):
    """Config 1 (blocked) through the CLI and the histogram API, in this
    process so the kernels' launch counters see it; then kernels 2 and C
    on the histogram step's first batch. Returns the launch counts."""
    from khmer_tpu_torch import Nodegraph
    from khmer_tpu_torch.cli import load_into_counting

    with tempfile.TemporaryDirectory(prefix=".chip_smoke_",
                                     dir=REPO) as tmp:
        ct = os.path.join(tmp, "out.ct")
        B.blocked_update_cuda.launches = 0
        B.blocked_gather_cuda.launches = 0
        t0 = time.perf_counter()
        load_into_counting.main(
            ["-q", "-k", str(K), "-x", "5e7", "-N", "4", "--tpu-layout",
             "blocked", "--device", "cuda", ct, DATA])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        cg = B.BlockedCountgraph.load(ct, device=dev)
        tracking = Nodegraph(K, 1, 1, primes=cg.hashsizes(), device=dev)
        SK.bit_update_cuda.launches = 0
        t0 = time.perf_counter()
        hist = cg.abundance_distribution(DATA, tracking)
        hist_s = time.perf_counter() - t0
        launches = {"blocked_update": B.blocked_update_cuda.launches,
                    "blocked_gather": B.blocked_gather_cuda.launches,
                    "bit_update (tracking)": SK.bit_update_cuda.launches}
        with open(ct, "rb") as f:
            blob = f.read()
        with open(ct + ".info") as f:
            info = f.read()

    n_unique = int(info.split("Total number of unique k-mers:")[1].split()[0])
    sha = hashlib.sha256(blob).hexdigest()
    nonzero = [(i, c) for i, c in enumerate(hist) if c]
    say("phase 4 config 1, blocked: CLI %.2f s, histogram %.2f s; nblocks "
        "%d, n_unique %d, n_occupied %d, .ct %d B sha256 %s; histogram sum "
        "%d, %d bins, head %s; launches %s"
        % (cli_s, hist_s, cg.nblocks, n_unique, cg.n_occupied(), len(blob),
           sha, sum(hist), len(nonzero), nonzero[:8], launches))
    expect(cg.nblocks == EXPECT["nblocks"], "nblocks")
    expect(n_unique == EXPECT["n_unique"], "n_unique")
    expect(cg.n_occupied() == EXPECT["n_occupied"], "n_occupied")
    expect(len(blob) == EXPECT["ct_bytes"], ".ct size")
    expect(sha == EXPECT["ct_sha256"], ".ct sha256")
    expect(sum(hist) == EXPECT["hist_sum"], "histogram sum")
    expect(len(nonzero) == EXPECT["hist_nonzero"], "histogram bins")
    expect(nonzero[:8] == EXPECT["hist_head"], "histogram head")
    for name, n in launches.items():
        expect(n > 0, "%s never launched on the config-1 path" % name)
    del launches["bit_update (tracking)"]

    _consume_rates(torch, lambda: B.BlockedCountgraph(K, 5e7, 4, device=dev),
                   (EXPECT["n_reads"], EXPECT["n_kmers"], EXPECT["n_unique"]),
                   "blocked")
    time_blocked_batch(torch, B, SK, dev, cg, card, errs)
    del cg
    torch.cuda.empty_cache()
    return launches


def time_blocked_batch(torch, B, SK, dev, cg, card, errs):
    """The first batch of the blocked histogram step on the config-1 table
    (scripts/hist_gather_bench.first_batch, through the step's own
    sketch_kernels.abund_batch): kernel 2 over its events' hashes and
    kernel C over its indices, each against its plain version (C also
    against torch.bincount), timed at the shapes the main path gives them,
    as issued and on the device alone, with the host's time a call."""
    from khmer_tpu_torch.scripts import cuda_ms, device_ms, host_us
    from khmer_tpu_torch.scripts.hist_gather_bench import (bincount,
                                                           blocked_floors,
                                                           first_batch)

    uh, idx = first_batch(cg, dev)
    table, nb = cg.tables[0], cg.nblocks
    d_g = int((B.blocked_gather_cuda(table, uh)
               - B.gather_counts_plain(nb, (table,), uh)).abs().max())
    errs["blocked_gather"] = max(errs["blocked_gather"], d_g)
    expect(d_g == 0, "blocked_gather != plain on the blocked batch")
    nbins = SK.ABUND_BINS
    zeros = torch.zeros(nbins, dtype=torch.int64, device=dev)
    got = SK.histogram_add_cuda(zeros.clone(), idx)
    lib = bincount(idx, nbins)
    d_c = max(int((got - SK.histogram_add_plain(zeros.clone(),
                                                idx)).abs().max()),
              int((got - lib).abs().max()))
    errs["histogram_add"] = max(errs["histogram_add"], d_c)
    expect(d_c == 0, "histogram_add != plain on the blocked batch")
    reps = 50
    acc = zeros.clone()

    def gather():
        return B.blocked_gather_cuda(table, uh)

    def hist():
        return SK.histogram_add_cuda(acc, idx)

    t = {"gather": cuda_ms(gather, reps),
         "gather_device": device_ms(gather, reps),
         "gather_host_us": host_us(gather, reps),
         "gather_plain": cuda_ms(
             lambda: B.gather_counts_plain(nb, (table,), uh), reps),
         "hist": cuda_ms(hist, reps), "hist_device": device_ms(hist, reps),
         "hist_host_us": host_us(hist, reps),
         "hist_library": cuda_ms(lambda: bincount(idx, nbins), reps)}
    n = uh.shape[0]
    g_bytes, sectors = blocked_floors(nb, uh)
    g_bound = bound(g_bytes, n * B.SUB)
    h_bound = bound(8 * n + 16 * int((lib != 0).sum()), n)
    say("  blocked batch: %d events; blocked_gather kernel %.4f "
        "ms (device %.4f ms, host %.1f us a call), plain %.4f ms, bound "
        "%.4f ms (%s), sector floor %.4f ms (%d distinct (block, quarter) "
        "sectors); histogram_add into %d bins kernel %.4f ms (device %.4f "
        "ms, host %.1f us a call), torch.bincount %.4f ms, bound %.4f ms "
        "(%s); on %s"
        % (n, t["gather"], t["gather_device"], t["gather_host_us"],
           t["gather_plain"], g_bound[0], g_bound[1],
           sectors * 32 / PEAK_BYTES_S * 1e3, sectors, nbins, t["hist"],
           t["hist_device"], t["hist_host_us"], t["hist_library"],
           h_bound[0], h_bound[1], card))


def run_config1_exact(torch, np, SK, dev, card, errs):
    """Config 1 in the exact layout through the port's load-into-counting
    and abundance-dist, in this process so the kernels' launch counters
    see it; the known JAX answers asserted. Then the byte gather and the
    histogram kernels timed on one real abundance batch. Returns the
    launch counts and those times."""
    from khmer_tpu_torch import Countgraph, load_countgraph
    from khmer_tpu_torch.cli import abundance_dist, load_into_counting

    with tempfile.TemporaryDirectory(prefix=".chip_smoke_",
                                     dir=REPO) as tmp:
        ct = os.path.join(tmp, "out.ct")
        hist_csv = os.path.join(tmp, "out.hist")
        SK.byte_update_cuda.launches = 0
        SK.byte_gather_cuda.launches = 0
        SK.histogram_add_cuda.launches = 0
        SK.bit_update_cuda.launches = 0
        t0 = time.perf_counter()
        load_into_counting.main(
            ["-q", "-k", str(K), "-x", "5e7", "-N", "4", "--device", "cuda",
             ct, DATA])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        abundance_dist.main(["-q", "--device", "cuda", ct, DATA, hist_csv])
        torch.cuda.synchronize()
        hist_s = time.perf_counter() - t0
        launches = {"byte_update": SK.byte_update_cuda.launches,
                    "byte_gather": SK.byte_gather_cuda.launches,
                    "histogram_add": SK.histogram_add_cuda.launches}
        j_hist = SK.bit_update_cuda.launches
        with open(ct, "rb") as f:
            blob = f.read()
        with open(ct + ".info") as f:
            info = f.read()
        with open(hist_csv, "rb") as f:
            csv_blob = f.read()
        cg = load_countgraph(ct, device=dev)
        t_wall, t_dev, found, _ = _traced_cli(
            torch, abundance_dist.main,
            ["-q", "--device", "cuda", ct, DATA, hist_csv + ".traced"], tmp,
            _J_TRACED + ("histogram", "gather"), top=6)

    rows = list(csv.reader(csv_blob.decode().splitlines()))[1:]
    hist = [int(r[1]) for r in rows]
    nonzero = [(i, c) for i, c in enumerate(hist) if c]
    n_unique = int(info.split("Total number of unique k-mers:")[1].split()[0])
    sha = hashlib.sha256(blob).hexdigest()
    csv_sha = hashlib.sha256(csv_blob).hexdigest()
    say("phase 4b config 1, exact: load-into-counting %.2f s, abundance-dist "
        "%.2f s; primes %s, n_unique %d, n_occupied %d, bigcount entries %d, "
        ".ct %d B sha256 %s; histogram sum %d, %d bins, head %s; CSV %d B "
        "sha256 %s; launches %s"
        % (cli_s, hist_s, cg.hashsizes(), n_unique, cg.n_occupied(),
           len(cg._bigcounts), len(blob), sha, sum(hist), len(nonzero),
           nonzero[:12], len(csv_blob), csv_sha, launches))
    E = EXPECT_EXACT
    expect(cg.hashsizes() == E["primes"], "exact primes")
    expect(n_unique == E["n_unique"], "exact n_unique")
    expect(cg.n_occupied() == E["n_occupied"], "exact n_occupied")
    expect(len(cg._bigcounts) == E["n_bigcounts"], "exact bigcount entries")
    expect(cg.get_use_bigcount(), "exact .ct has bigcount on")
    expect(len(blob) == E["ct_bytes"], "exact .ct size")
    expect(sha == E["ct_sha256"], "exact .ct sha256")
    for line in E["info_lines"]:
        expect(line in info.splitlines(), "exact .info: %s" % line)
    expect(sum(hist) == E["hist_sum"], "exact histogram sum")
    expect(len(nonzero) == E["hist_nonzero"], "exact histogram bins")
    expect(nonzero[:12] == E["hist_head"], "exact histogram head")
    expect(len(csv_blob) == E["csv_bytes"], "histogram CSV size")
    expect(csv_sha == E["csv_sha256"], "histogram CSV sha256")
    for name, n in launches.items():
        expect(n > 0, "%s never launched on the exact config-1 path" % name)
    expect(j_hist > 0, "bit_update never launched in abundance-dist")
    j_ms, j_n = _j_traced(found)
    say("  abundance-dist traced: %.6f s, device %.4f ms (busy %.2f%%): "
        "tracking update (kernel J) %.4f ms in %d launches = %.4f ms a "
        "batch (%d kernels; %d launches untraced); histogram_add %.4f ms, "
        "byte_gather %.4f ms; the most device time: %s; on %s"
        % (t_wall, t_dev, 100 * t_dev / (t_wall * 1e3), j_ms,
           SK.bit_update_cuda.launches - j_hist, j_ms / max(
               SK.bit_update_cuda.launches - j_hist, 1), j_n, j_hist,
           found["histogram"][0], found["gather"][0], found["top"], card))

    def make():
        g = Countgraph(K, 5e7, 4, device=dev)
        g.set_use_bigcount(True)
        return g

    _consume_rates(torch, make,
                   (E["n_reads"], E["n_kmers"], E["n_unique"]), "exact")
    timings = time_abundance_batch(torch, np, SK, dev, cg, card, errs)
    del cg
    torch.cuda.empty_cache()
    return launches, timings


def time_abundance_batch(torch, np, SK, dev, cg, card, errs):
    """The first batch of abundance-dist's histogram step on the config-1
    .ct (scripts/hist_gather_bench.first_batch, through the step's own
    sketch_kernels.abund_batch): the byte gather over its events' hashes
    and the histogram of its indices, each kernel against its plain
    version (and the histogram against torch.bincount), at the shapes the
    main path gives them, as issued and on the device alone. Then the
    byte gather on 2^20 random live hashes on the same tables."""
    from khmer_tpu_torch.scripts import cuda_ms, device_ms, host_us
    from khmer_tpu_torch.scripts.byte_gather_bench import (gather_floors,
                                                           time_gather)
    from khmer_tpu_torch.scripts.hist_gather_bench import (bincount,
                                                           first_batch)

    uh, idx = first_batch(cg, dev)
    primes, flat = cg._primes, cg.tables.flat
    counts = SK.byte_gather_cuda(primes, flat, uh)
    d_b = int((counts - SK.byte_gather_plain(primes, flat, uh)).abs().max())
    errs["byte_gather"] = max(errs["byte_gather"], d_b)
    expect(d_b == 0, "byte_gather != plain on the abundance batch")
    nbins = SK.ABUND_BINS
    got = SK.histogram_add_cuda(
        torch.zeros(nbins, dtype=torch.int64, device=dev), idx)
    lib = bincount(idx, nbins)
    d_c = max(int((got - SK.histogram_add_plain(
        torch.zeros(nbins, dtype=torch.int64, device=dev), idx)).abs().max()),
        int((got - lib).abs().max()))
    errs["histogram_add"] = max(errs["histogram_add"], d_c)
    expect(d_c == 0, "histogram_add != plain on the abundance batch")

    # the histogram timings accumulate into one output each
    reps = 50
    acc_k, acc_p = got.clone(), got.clone()

    def gather():
        return SK.byte_gather_cuda(primes, flat, uh)

    def hist():
        return SK.histogram_add_cuda(acc_k, idx)

    t = {"gather": cuda_ms(gather, reps),
         "gather_device": device_ms(gather, reps),
         "gather_plain": cuda_ms(lambda: SK.byte_gather_plain(primes, flat,
                                                              uh), reps),
         "hist": cuda_ms(hist, reps),
         "hist_plain": cuda_ms(lambda: SK.histogram_add_plain(acc_p, idx),
                               reps),
         "hist_library": cuda_ms(lambda: bincount(idx, nbins), reps)}
    expect(torch.equal(acc_k, acc_p), "histogram_add != plain, accumulated")
    t["hist_device"] = device_ms(hist, reps)
    t["hist_host_us"] = host_us(hist, reps)
    j = time_tracking_update(torch, SK, dev, primes, errs)
    n = uh.shape[0]
    # least bytes: 8 B a hash, 4 B a count, each distinct counter once; the
    # sector floor: each distinct 32-byte sector of the counters once
    g_bytes, sectors = gather_floors(primes, uh)
    g_bound = bound(g_bytes, n * len(primes))
    h_bound = bound(8 * n + 16 * int((lib != 0).sum()), n)
    say("  abundance batch: %d events, %d histogrammed; "
        "byte_gather kernel %.4f ms (device %.4f ms), plain %.4f ms, bound "
        "%.4f ms (%s), sector floor %.4f ms (%d sectors); histogram_add "
        "into %d bins kernel %.4f ms (device %.4f ms, host %.1f us a call), "
        "plain %.4f ms, torch.bincount %.4f ms, bound %.4f ms (%s); on %s"
        % (n, int((idx < nbins).sum()), t["gather"], t["gather_device"],
           t["gather_plain"], g_bound[0], g_bound[1],
           sectors * 32 / PEAK_BYTES_S * 1e3, sectors, nbins, t["hist"],
           t["hist_device"], t["hist_host_us"], t["hist_plain"],
           t["hist_library"], h_bound[0], h_bound[1], card))
    say("  abundance batch's tracking update (kernel J, a fresh tracking "
        "table a call): kernel %.4f ms (device %.4f ms), plain %.4f ms, "
        "bound %.4f ms (%s); %d new of %d valid events; on %s"
        % (j["ms"], j["device"], j["plain_ms"], j["bound_ms"],
           j["bound_by"], j["new"], j["valid"], card))
    rnd = _dev_hashes(torch, np, np.random.default_rng(4).integers(
        0, 2**64, 1 << 20, dtype=np.uint64), dev)
    r = time_gather(primes, flat, rnd, reps)
    errs["byte_gather"] = max(errs["byte_gather"], r["max_abs_err"])
    expect(r["max_abs_err"] == 0, "byte_gather != plain on random hashes")
    say("  byte_gather on %d random live hashes: kernel %.4f ms, plain %.4f "
        "ms, bound %.4f ms (bytes), sector floor %.4f ms (%d sectors); on %s"
        % (r["hashes"], r["ms"], r["plain_ms"], r["bound_ms"],
           r["sector_floor_ms"], r["sectors"], card))
    return {
        "byte_gather": {"ms": t["gather"], "plain_ms": t["gather_plain"],
                        "bound_ms": g_bound[0], "bound_by": g_bound[1]},
        "histogram_add": {"ms": t["hist"], "plain_ms": t["hist_plain"],
                          "library_ms": t["hist_library"],
                          "bound_ms": h_bound[0], "bound_by": h_bound[1]},
    }


# ---------------------------------------------------------------------------
# phase 5: scale
# ---------------------------------------------------------------------------


def stream_hashes(np):
    """The 25k stream's canonical k-mer hashes, in order (host hash)."""
    from khmer_tpu_torch.core.pipeline import DenseHasher
    from khmer_tpu_torch.io.fastx import FastxParser

    t0 = time.perf_counter()
    hasher = DenseHasher(K, "twobit")
    parts = []
    for rec in FastxParser(DATA):
        seq = rec.cleaned_seq
        if len(seq) >= K:
            parts.extend(h[:n].copy() for h, n in hasher.add(seq))
    parts.extend(h[:n].copy() for h, n in hasher.flush())
    one = np.concatenate(parts)
    say("  host parse + hash of the 25k stream (record path): %.6f s"
        % (time.perf_counter() - t0))
    expect(len(one) == EXPECT["n_kmers"], "k-mers in the 25k stream")
    return one


def replay_chunks(torch, np, dev, one):
    """The stream REPLAY times over, as DENSE_CHUNK-hash chunks on the
    card: [(hashes, nvalid)], the tail zero-padded."""
    from khmer_tpu_torch.core.pipeline import DENSE_CHUNK

    total = len(one) * REPLAY
    nchunks = -(-total // DENSE_CHUNK)
    stream = torch.zeros(nchunks * DENSE_CHUNK, dtype=torch.int64,
                         device=dev)
    stream[:total] = _dev_hashes(torch, np, one, dev).repeat(REPLAY)
    return [(stream[i * DENSE_CHUNK:(i + 1) * DENSE_CHUNK],
             min(DENSE_CHUNK, total - i * DENSE_CHUNK))
            for i in range(nchunks)], total


def _timed(torch, fn):
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop)


def run_scale(torch, np, B, dev, card, errs, one):
    """Replay the stream REPLAY times in 2^20-hash chunks through the
    kernel and the plain version, on the config-1 and the largest table;
    compare the final states exactly; time kernel 2 on the first chunk,
    beside its floors. Returns the config-1 times of kernels 1 and 2."""
    from khmer_tpu_torch.core.pipeline import DENSE_CHUNK
    from khmer_tpu_torch.core.sketch_kernels import (get_n_primes_near_x,
                                                     update_plan,
                                                     update_scratch)
    from khmer_tpu_torch.ops.u64 import umod
    from khmer_tpu_torch.scripts import device_ms
    from khmer_tpu_torch.scripts.hist_gather_bench import blocked_floors

    chunks, total = replay_chunks(torch, np, dev, one)
    scratch_bytes = update_plan(DENSE_CHUNK, B.SUB)[2]
    nchunks = len(chunks)
    max_nb = get_n_primes_near_x(1, B.MAX_BLOCKS + 1)[0]
    out = {}
    for label, nb in (("config-1", EXPECT["nblocks"]), ("max", max_nb)):
        tabs = {}
        ms = {}
        for which in ("kernel", "plain"):
            tab = torch.zeros((nb, B.LANES), dtype=torch.uint8, device=dev)
            nu = torch.zeros(1, dtype=torch.int64, device=dev)
            if which == "kernel":
                # the chunk's scratch, kept between chunks as a sketch
                # keeps it
                scratch = update_scratch(None, DENSE_CHUNK, B.SUB, dev)

                def step(h, n):
                    B.blocked_update_cuda(tab, h, n, nu, scratch)
            else:
                def step(h, n):
                    B.blocked_update_plain(nb, (tab,), nu, h, n)
            # warm-up on a throwaway copy: allocator and first launch
            saved = tab.clone()
            step(*chunks[0])
            tab.copy_(saved)
            nu.zero_()
            del saved

            def run():
                for h, n in chunks:
                    step(h, n)
            ms[which] = _timed(torch, run)
            tabs[which] = (tab, int(nu))
            torch.cuda.empty_cache()
        (tk, nuk), (tp, nup) = tabs["kernel"], tabs["plain"]
        diff = int((tk.int() - tp.int()).abs().max()) if nb < 2**22 else \
            int(0 if torch.equal(tk, tp) else 1)
        errs["blocked_update"] = max(errs["blocked_update"], diff,
                                     abs(nuk - nup))
        expect(diff == 0 and nuk == nup,
               "blocked_update != plain at %s scale" % label)
        gq = chunks[0][0]
        gk = B.blocked_gather_cuda(tk, gq)
        gp = B.gather_counts_plain(nb, (tp,), gq)
        gd = int((gk - gp).abs().max())
        errs["blocked_gather"] = max(errs["blocked_gather"], gd)
        expect(gd == 0, "blocked_gather != plain at %s scale" % label)
        reps = 20
        g_ms = _timed(torch, lambda: [B.blocked_gather_cuda(tk, gq)
                                      for _ in range(reps)]) / reps
        gp_ms = _timed(torch, lambda: [B.gather_counts_plain(nb, (tp,), gq)
                                       for _ in range(reps)]) / reps
        g_dev = device_ms(lambda: B.blocked_gather_cuda(tk, gq), reps)
        # kernel 2's floors on this chunk: its least bytes, and each
        # distinct 32-byte (block, quarter) sector read once
        g_bytes, sectors = blocked_floors(nb, gq)
        say("phase 5 %s: %d blocks (%.2f GB, update scratch %.1f MB), %d "
            "k-mers in %d chunks of %d; n_unique %d; update kernel %.4f "
            "ms/chunk = %.4g k-mers/s, plain %.4f ms/chunk = %.4g k-mers/s; "
            "gather of %d hashes kernel %.4f ms (device %.4f ms), plain "
            "%.4f ms, bound %.4f ms (bytes), sector floor %.4f ms (%d "
            "sectors); on %s"
            % (label, nb, nb * B.LANES / 1e9, scratch_bytes / 1e6, total,
               nchunks, gq.shape[0], nuk, ms["kernel"] / nchunks,
               total / ms["kernel"] * 1e3, ms["plain"] / nchunks,
               total / ms["plain"] * 1e3, gq.shape[0], g_ms, g_dev, gp_ms,
               g_bytes / PEAK_BYTES_S * 1e3,
               sectors * 32 / PEAK_BYTES_S * 1e3, sectors, card))
        if label == "config-1":
            # least traffic: 8 B per hash, one read and one write of each
            # distinct counter a chunk touches (reads only for the gather)
            def lanes(h):
                return torch.unique(B._lane_index(umod(h, nb),
                                                  B._offsets(h))).numel()
            u_bytes = sum(8 * n + 2 * lanes(h[:n]) for h, n in chunks)
            u_bound = bound(u_bytes / nchunks, total * B.SUB / nchunks)
            g_bound = bound(g_bytes, gq.shape[0] * B.SUB)
            out = {"blocked_update": {
                "ms": ms["kernel"] / nchunks,
                "plain_ms": ms["plain"] / nchunks,
                "bound_ms": u_bound[0], "bound_by": u_bound[1]},
                "blocked_gather": {
                "ms": g_ms, "plain_ms": gp_ms,
                "bound_ms": g_bound[0], "bound_by": g_bound[1]}}
        del tabs, tk, tp
        torch.cuda.empty_cache()
    return out


def run_scale_exact(torch, np, SK, dev, card, errs, one):
    """Replay the stream REPLAY times through the byte update (bigcount
    on, as the CLI runs it) and its plain version, on the config-1 tables,
    on -x 1e9 -N 4 and on -x 5e9 -N 4 (20 GB of tables, more than the
    first design's table-sized scratch left room for); compare tables,
    n_unique and bigcount maps exactly. The kernel's timed run keeps its
    reports on the card and folds them afterwards. Returns the config-1
    times."""
    from khmer_tpu_torch.core.pipeline import DENSE_CHUNK
    from khmer_tpu_torch.ops.u64 import umod

    chunks, total = replay_chunks(torch, np, dev, one)
    nchunks = len(chunks)
    out = {}
    for label, primes in [("config-1", tuple(EXPECT_EXACT["primes"]))] + [
            ("-x %g -N 4" % x, tuple(SK.get_n_primes_near_x(4, x)))
            for x in SCALE_X]:
        size = SK.byte_flat_size(primes)
        scratch_bytes = SK.update_plan(DENSE_CHUNK, len(primes))[2]
        state = {}
        ms = {}
        for which in ("kernel", "plain"):
            flat = torch.zeros(size, dtype=torch.uint8, device=dev)
            nu = torch.zeros(1, dtype=torch.int64, device=dev)
            # the chunk's scratch, kept between chunks as a sketch keeps it
            scratch = (SK.update_scratch(None, DENSE_CHUNK, len(primes), dev)
                       if which == "kernel" else None)
            reports = []

            def step(h, n):
                if which == "kernel":
                    return SK.byte_update_cuda(primes, flat, nu, h, n,
                                               with_bigcount=True,
                                               scratch=scratch)
                return SK.byte_update_plain(primes, flat, nu, h, n,
                                            with_bigcount=True)
            # warm-up on a throwaway copy: allocator and first launch
            saved = flat.clone()
            step(*chunks[0])
            flat.copy_(saved)
            nu.zero_()
            del saved

            def run():
                for h, n in chunks:
                    reports.append(step(h, n))
            ms[which] = _timed(torch, run)
            big = {}
            for r in reports:
                _fold(big, _report_triggers(np, SK, r))
            del reports, scratch
            torch.cuda.empty_cache()
            state[which] = (flat, int(nu), big)
        (fk, nuk, bk), (fp, nup, bp) = state["kernel"], state["plain"]
        same = torch.equal(fk, fp)
        errs["byte_update"] = max(errs["byte_update"], 0 if same else 1,
                                  abs(nuk - nup), 0 if bk == bp else 1)
        expect(same and nuk == nup and bk == bp,
               "byte_update != plain at %s scale" % label)
        say("phase 5b %s: primes %s (%.2f GB of tables, update scratch "
            "%.1f MB), %d k-mers in %d chunks of %d; n_unique %d, bigcount "
            "entries %d; update kernel %.4f ms/chunk = %.4g k-mers/s, plain "
            "%.4f ms/chunk = %.4g k-mers/s; on %s"
            % (label, list(primes), size / 1e9, scratch_bytes / 1e6, total,
               nchunks, chunks[0][0].shape[0], nuk, len(bk),
               ms["kernel"] / nchunks, total / ms["kernel"] * 1e3,
               ms["plain"] / nchunks, total / ms["plain"] * 1e3, card))
        if label == "config-1":
            # least traffic: 8 B per hash, one read and one write of each
            # distinct counter a chunk touches
            def touched(h):
                return sum(int(torch.unique(umod(h, p)).numel())
                           for p in primes)
            u_bytes = sum(8 * n + 2 * touched(h[:n]) for h, n in chunks)
            u_bound = bound(u_bytes / nchunks,
                            total * len(primes) / nchunks)
            out["byte_update"] = {
                "ms": ms["kernel"] / nchunks,
                "plain_ms": ms["plain"] / nchunks,
                "bound_ms": u_bound[0], "bound_by": u_bound[1]}
        del state, fk, fp
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 6: microbenchmarks
# ---------------------------------------------------------------------------


def run_microbench(B, card, launches, errs):
    """The ports of scripts/pallas_proto.py and scripts/profile_scatter2.py.
    The decoded-event update's path is its script: its launches are
    counted there."""
    from khmer_tpu_torch.scripts import pallas_proto, profile_scatter2

    B.proto_rmw_cuda.launches = 0
    proto = pallas_proto.main()
    launches["proto_rmw"] = B.proto_rmw_cuda.launches
    scatter = profile_scatter2.main()
    c, t = proto["correct"], proto["timing"]
    say("phase 6 pallas_proto: correctness %d blocks x %d events, nnew %d, "
        "max_abs_err %d; %d blocks x %d events, %d calls: kernel %.4f ms "
        "(%.3f ns/event), plain %.4f ms, blocked_update on as many hashes "
        "into as many blocks in the same run %.4f ms (kernel / blocked_update "
        "%.3f), nnew %d, max_abs_err %d; scratch %d B (a winner image of one "
        "int32 per counter: %d B); on %s"
        % (c["nblocks"], c["events"], c["nnew"], c["max_abs_err"],
           t["nblocks"], t["events"], t["calls"], t["ms"], t["ns_per_event"],
           t["plain_ms"], t["blocked_update_ms"],
           t["ms"] / t["blocked_update_ms"], t["nnew"], t["max_abs_err"],
           t["scratch_bytes"], t["winner_image_bytes"], card))
    say("phase 6 profile_scatter2: %d indices into %d bins: kernel %.4f ms, "
        "plain %.4f ms, torch.bincount %.4f ms, max_abs_err %d; on %s"
        % (scatter["events"], scatter["nbins"], scatter["ms"],
           scatter["plain_ms"], scatter["library_ms"],
           scatter["max_abs_err"], card))
    errs["proto_rmw"] = max(errs["proto_rmw"], c["max_abs_err"],
                            t["max_abs_err"])
    errs["histogram_add"] = max(errs["histogram_add"],
                                scatter["max_abs_err"])
    expect(c["max_abs_err"] == 0 and t["max_abs_err"] == 0,
           "proto_rmw != plain in its script")
    expect(scatter["max_abs_err"] == 0,
           "histogram_add != plain or bincount in its script")
    p_bound = bound(t["bytes"], t["ops"])
    return {"proto_rmw": {"ms": t["ms"], "plain_ms": t["plain_ms"],
                          "bound_ms": p_bound[0], "bound_by": p_bound[1]}}


# ---------------------------------------------------------------------------
# phase 7: config 2, normalize-by-median, through the CLI
# ---------------------------------------------------------------------------


def run_diginorm_cases(torch, dev, errs):
    """Kernels E and F against their plain versions on the windows of
    scripts/diginorm_cases.py."""
    from khmer_tpu_torch.scripts import diginorm_cases

    for name in diginorm_cases.CASES:
        got = diginorm_cases.check_case(name, dev)
        errs["diginorm_med"] = max(errs["diginorm_med"], got["med"])
        errs["diginorm_scan"] = max(errs["diginorm_scan"], got["scan"])
        expect(got["med"] == 0, "diginorm_med != plain on case %s" % name)
        expect(got["scan"] == 0, "diginorm_scan != plain on case %s" % name)
        if name == "all-rejected":
            expect(got["rejected"] == got["bundles"]
                   and got["kept after E"] == 0,
                   "phase A left bundles in the all-rejected window")
        if name == "none-rejected":
            expect(got["rejected"] == 0,
                   "phase A rejected bundles in the none-rejected window")
        say("  diginorm case %-20s %d bundles: rejected by E %d; kept after "
            "E %d, alone %d; new k-mers after E %d, alone %d"
            % (name, got["bundles"], got["rejected"], got["kept after E"],
               got["kept alone"], got["new after E"], got["new alone"]))
    got = diginorm_cases.check_long_window(dev)
    errs["diginorm_med"] = max(errs["diginorm_med"], got["mismatches"])
    errs["diginorm_scan"] = max(errs["diginorm_scan"], got["mismatches"])
    expect(got["mismatches"] == 0,
           "ScanNormalizer on the card != on the CPU with long reads")
    expect(got["launches"] == (got["runs"], got["runs"]),
           "long-read windows: %s launches for %d runs"
           % (got["launches"], got["runs"]))
    say("  diginorm long reads: 3 windows of 200 bundles with reads of "
        "5,000-15,000 bases in %d runs, kept %d, card == CPU"
        % (got["runs"], got["kept"]))
    return len(diginorm_cases.CASES) + 1


def _run_cli(torch, main, args, cwd):
    """A port CLI's main(args) in this process, in `cwd`: (wall s, its
    stderr, what main returned)."""
    import contextlib
    import io

    err = io.StringIO()
    old = os.getcwd()
    os.chdir(cwd)
    try:
        with contextlib.redirect_stderr(err):
            t0 = time.perf_counter()
            got = main(args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        os.chdir(old)
    return wall, err.getvalue(), got


def _traced_cli(torch, main, args, cwd, kernels, top=None):
    """_run_cli under torch.profiler: (wall s, device ms in all, {name:
    (ms, launches)} of the device kernels whose names hold each of
    `kernels`, what main returned); with `top`, found["top"] lists the
    `top` device entries that took the most time as (name, ms, count)."""
    from torch.autograd import DeviceType

    from khmer_tpu_torch.scripts.trace_config1 import _self_device_us

    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        wall, _, got = _run_cli(torch, main, args, cwd)
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    found = {}
    for name in kernels:
        hit = [e for e in events if name in e.key]
        found[name] = (sum(_self_device_us(e) for e in hit) / 1e3,
                       sum(e.count for e in hit))
    if top:
        ranked = sorted(events, key=_self_device_us, reverse=True)[:top]
        found["top"] = [(e.key[:60], round(_self_device_us(e) / 1e3, 4),
                         e.count) for e in ranked]
    return (wall, sum(_self_device_us(e) for e in events) / 1e3, found,
            got)


def _normalize(torch, args, cwd):
    """The port's normalize-by-median in this process, in `cwd`: (wall s,
    its stderr, the ScanNormalizer it ran)."""
    from khmer_tpu_torch.cli import normalize_by_median as nbm

    return _run_cli(torch, nbm.main, args, cwd)


def _traced_normalize(torch, args, cwd):
    """_normalize under torch.profiler: (wall s, device ms in all, (ms,
    launches) of kernel E, of kernel F, the ScanNormalizer)."""
    from khmer_tpu_torch.cli import normalize_by_median as nbm

    wall, dev_ms, found, norm = _traced_cli(
        torch, nbm.main, args, cwd, ("med_kernel", "scan_kernel"))
    return (wall, dev_ms, found["med_kernel"], found["scan_kernel"], norm)


def _file_sha256(path):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 26), b""):
            h.update(block)
    return h.hexdigest(), os.path.getsize(path)


def _check_normalize(E, err, keep_path, ct_path, label):
    """The run's answers against the JAX package's: (kept reads, n_unique,
    .keep sha256, .ct sha256, .ct bytes)."""
    n_unique = int(err.split("Total number of unique k-mers:")[1].split()[0])
    with open(keep_path, "rb") as f:
        kept = f.read().count(b">")
    keep_sha, _ = _file_sha256(keep_path)
    ct_sha, ct_bytes = _file_sha256(ct_path)
    got = (kept, n_unique, keep_sha, ct_sha, ct_bytes)
    expect(got == (E["kept"], E["n_unique"], E["keep_sha256"],
                   E["ct_sha256"], E["ct_bytes"]),
           "%s: (kept, n_unique, .keep sha256, .ct sha256, .ct bytes) = %s, "
           "JAX gives %s" % (label, got, (E["kept"], E["n_unique"],
                                          E["keep_sha256"], E["ct_sha256"],
                                          E["ct_bytes"])))
    return got


def run_config2(torch, SK, dev, card, errs):
    """Config 2 as BASELINE defines it, through the port's CLI in this
    process: normalize-by-median -C 20 -s out.ct data/stamps-reads.fa.gz
    (k 32, 4 x 1e6 tables), the JAX answers asserted and kernels E and F
    seen to launch; then a traced run (device time by kernel), and E and
    F on window 6 against their plain versions, timed beside their bounds
    (scripts/diginorm_bench.py). Returns the launches and those times."""
    from khmer_tpu_torch.scripts.diginorm_bench import time_window

    E = EXPECT_C2
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_",
                                     dir=REPO) as tmp:
        run, traced = os.path.join(tmp, "run"), os.path.join(tmp, "trace")
        os.makedirs(run)
        os.makedirs(traced)
        SK.diginorm_med_cuda.launches = 0
        SK.diginorm_scan_cuda.launches = 0
        wall, err, norm = _normalize(
            torch, ["-C", "20", "-s", "out.ct", STAMPS], run)
        launches = {"diginorm_med": SK.diginorm_med_cuda.launches,
                    "diginorm_scan": SK.diginorm_scan_cuda.launches}
        got = _check_normalize(E, err, os.path.join(
            run, "stamps-reads.fa.gz.keep"), os.path.join(run, "out.ct"),
            "config 2")
        runs, cand = norm.scan_runs, int(norm.candidates)
        groups = int(norm.groups)
        t_wall, dev_ms, (e_ms, e_n), (f_ms, f_n), _ = _traced_normalize(
            torch, ["-C", "20", STAMPS], traced)
    for name, n in launches.items():
        expect(n > 0, "%s never launched on the config-2 path" % name)
    _say_groups("phase 7", runs, cand, groups)
    _say_med_loads("phase 7", norm, launches["diginorm_med"])
    say("phase 7 config 2: normalize-by-median -C 20 -s on "
        "data/stamps-reads.fa.gz: %.6f s = %.6g reads/s; kept %d of %d, "
        "n_unique %d, .keep sha256 %s, .ct %d B sha256 %s (the JAX "
        "answers); %d scan runs (a run a window), %d scan candidates (%.1f a "
        "run); "
        "launches %s; traced: %.6f s, device %.4f ms (busy %.2f%%), "
        "diginorm_med %.4f ms in %d launches (%.4f a window), "
        "diginorm_scan %.4f ms in %d launches (%.4f a window, %.3f us a "
        "candidate); on %s"
        % (wall, E["reads"] / wall, got[0], E["reads"], got[1], got[2],
           got[4], got[3], runs, cand, cand / max(runs, 1), launches,
           t_wall, dev_ms, 100 * dev_ms / (t_wall * 1e3), e_ms, e_n,
           e_ms / max(e_n, 1), f_ms, f_n, f_ms / max(f_n, 1),
           f_ms * 1e3 / max(cand, 1), card))

    w = _bench_window(time_window(dev), "config 2", errs, card)
    timings = {name: {"ms": w[key]["ms"], "plain_ms": w[key]["plain_ms"],
                      "bound_ms": w[key]["bound"][0],
                      "bound_by": w[key]["bound"][1], "library_ms": None}
               for key, name in (("med", "diginorm_med"),
                                 ("scan", "diginorm_scan"))}
    torch.cuda.empty_cache()
    return launches, timings


def _say_groups(label, runs, cand, groups):
    """Kernel F's groups over a run: more than one candidate a group on
    average, or the overlay did not engage."""
    expect(0 < groups < cand, "%s: kernel F took %d candidates in %d groups"
           % (label, cand, groups))
    say("%s groups: kernel F took %d scan candidates in %d groups, %.4f "
        "groups a run, %.4f candidates a group"
        % (label, cand, groups, groups / max(runs, 1), cand / groups))


def _say_med_loads(label, norm, launches):
    """Kernel E's counter loads over a run (ScanNormalizer.med_loads)
    beside every table of every valid window: (loads, windows x T)."""
    loads = int(norm.med_loads)
    all_loads = norm.med_windows * len(norm._primes)
    say("%s med loads: kernel E loaded %d counters in %d launches (%.1f a "
        "launch) for %d valid windows x %d tables = %d (%.4f of them)"
        % (label, loads, launches, loads / max(launches, 1),
           norm.med_windows, len(norm._primes), all_loads,
           loads / max(all_loads, 1)))
    return loads, all_loads


def _bench_window(w, label, errs, card):
    """Check and print one diginorm_bench.time_window result."""
    for key, name in (("med", "diginorm_med"), ("scan", "diginorm_scan")):
        errs[name] = max(errs[name], w[key]["mismatches"])
        expect(w[key]["mismatches"] == 0,
               "%s != plain on %s's window %d" % (name, label, w["window"]))
    m, s = w["med"], w["scan"]
    say("  %s window %d: %d bundles of rows of %d codes, %d candidates, %d "
        "kept; diginorm_med kernel %.4f ms as issued, device %.4f ms, "
        "plain %.4f ms, bound %.5f ms (%s; %d B, %d ops), sector floor "
        "%.5f ms (%d B; every counter), the rule's sector floor %.5f ms (%d "
        "B), loads %d of %d windows x tables (%.4f); diginorm_scan kernel "
        "%.4f ms (%.3f us a candidate), plain %.4f ms, bound %.5f ms (%s; "
        "%d B, %d ops); on %s"
        % (label, w["window"], w["bundles"], w["L"], w["candidates"],
           w["kept"], m["ms"], m["device_ms"], m["plain_ms"], m["bound"][0],
           m["bound"][1], m["bytes"], m["ops"], m["sector_ms"],
           m["sector_bytes"], m["rule_sector_ms"], m["rule_sector_bytes"],
           m["loads"], m["all_loads"], m["loads"] / max(m["all_loads"], 1),
           s["ms"], s["us_per_candidate"], s["plain_ms"], s["bound"][0],
           s["bound"][1], s["bytes"], s["ops"], card))
    return w


# phases 7b and 8b trace their CLIs on the first quarter of the reads
TRACED_READS = 250_000


def synth_head(reads, n=TRACED_READS):
    """The first n reads of `reads` (two FASTA lines each), written beside
    it."""
    head = reads[:-len(".fa")] + "-head.fa"
    with open(reads, "rb") as src, open(head, "wb") as dst:
        for _ in range(2 * n):
            dst.write(src.readline())
    return head


def synth_reads(tmp):
    """The 1,000,000 reads of scripts/synth_reads.py written in `tmp`, the
    input of phases 7b and 8b, their sha256 asserted: (path, seconds it
    took to write them)."""
    from khmer_tpu_torch.scripts.synth_reads import write_reads

    reads = os.path.join(tmp, "synth.fa")
    t0 = time.perf_counter()
    write_reads(reads)
    gen_s = time.perf_counter() - t0
    sha, _ = _file_sha256(reads)
    expect(sha == EXPECT_C2_SCALE["input_sha256"],
           "synthetic reads: sha256 %s" % sha)
    return reads, gen_s


def run_config2_scale(torch, SK, dev, card, errs, reads, head, gen_s,
                      keep_ct):
    """Config 2 at a table size users run: normalize-by-median -k 20 -C 20
    -x 1e9 -N 4 -s (4 GB of u8 tables) on 1,000,000 seeded synthetic
    reads (synth_reads), its .ct moved to `keep_ct` for phase 12b's
    count-median, the JAX answers asserted, E and F seen to launch,
    the device memory beside the tables read; then a traced run without -s
    on the first TRACED_READS of them (`head`) for F's time a candidate,
    and E and F on window 6 against their plain versions, timed beside
    their bounds."""
    from khmer_tpu_torch.scripts.diginorm_bench import time_window

    E = EXPECT_C2_SCALE
    args = ["-k", "20", "-C", "20", "-x", "1e9", "-N", "4"]
    primes = SK.get_n_primes_near_x(4, 1e9)
    tables = SK.byte_flat_size(primes)
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_",
                                     dir=REPO) as tmp:
        run, traced = os.path.join(tmp, "run"), os.path.join(tmp, "trace")
        os.makedirs(run)
        os.makedirs(traced)
        SK.diginorm_med_cuda.launches = 0
        SK.diginorm_scan_cuda.launches = 0
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        wall, err, norm = _normalize(torch, args + ["-s", "out.ct", reads],
                                     run)
        peak = torch.cuda.max_memory_allocated(dev)
        launches = (SK.diginorm_med_cuda.launches,
                    SK.diginorm_scan_cuda.launches)
        got = _check_normalize(E, err, os.path.join(run, "synth.fa.keep"),
                               os.path.join(run, "out.ct"), "config 2 at 4 GB")
        os.replace(os.path.join(run, "out.ct"), keep_ct)
        runs, cand = norm.scan_runs, int(norm.candidates)
        groups = int(norm.groups)
        t_wall, dev_ms, (e_ms, e_n), (f_ms, f_n), t_norm = _traced_normalize(
            torch, args + [head], traced)
        torch.cuda.empty_cache()
        w = time_window(dev, reads, k=20, x=1e9, reps=3)
    expect(min(launches) > 0, "diginorm kernels never launched at 4 GB")
    _say_groups("phase 7b", runs, cand, groups)
    loads, all_loads = _say_med_loads("phase 7b", norm, launches[0])
    expect(loads < all_loads, "phase 7b: kernel E loaded %d counters, every "
           "table of every window (%d): its rounds did not engage"
           % (loads, all_loads))
    say("phase 7b config 2 at -k 20 -C 20 -x 1e9 -N 4: %d synthetic reads "
        "(written in %.3f s), %.6f s = %.6g reads/s; kept %d, n_unique %d, "
        ".keep sha256 %s, .ct %d B sha256 %s (the JAX answers); tables "
        "%.3f GB, peak device memory %.3f GB, beside the tables %.1f MB (a "
        "u32 copy of the tables would add %.3f GB); %d scan runs, %d scan "
        "candidates; launches %s; traced on the first %d reads: %.6f s, "
        "device %.4f ms (busy %.2f%%), diginorm_med %.4f ms in %d "
        "launches, diginorm_scan %.4f ms in %d launches, %.3f us a "
        "candidate; on %s"
        % (E["reads"], gen_s, wall, E["reads"] / wall, got[0], got[1],
           got[2], got[4], got[3], tables / 1e9, peak / 1e9,
           (peak - tables) / 1e6, 4 * tables / 1e9, runs, cand,
           launches, TRACED_READS, t_wall, dev_ms,
           100 * dev_ms / (t_wall * 1e3), e_ms, e_n, f_ms, f_n,
           f_ms * 1e3 / max(int(t_norm.candidates), 1), card))
    _bench_window(w, "-x 1e9", errs, card)
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 8: config 3, trim-low-abund / filter-abund / filter-abund-single
# ---------------------------------------------------------------------------


def run_trim_cases(torch, dev, errs):
    """Kernels G and H against their plain versions on the windows of
    scripts/trim_cases.py, and the port's ScanTrimmerState on the card
    against the CPU's over windows holding long reads."""
    from khmer_tpu_torch.scripts import trim_cases

    for name in trim_cases.CASES:
        got = trim_cases.check_case(name, dev)
        for key, kernel in (("mark", "trim_mark"), ("probe", "trim_probe"),
                            ("walk", "trim_scan"), ("scan", "trim_scan"),
                            ("counts", "read_counts")):
            errs[kernel] = max(errs[kernel], got[key])
            expect(got[key] == 0, "%s (%s) != plain on case %s"
                   % (kernel, key, name))
        if name == "consume-lifts-trim":
            expect(got["lifted"] >= 30, "consume-lifts-trim: %d bundles' "
                   "trim positions moved" % got["lifted"])
        if name in ("consume-lifts-digi", "consume-lifts-candidate"):
            expect(got["moved"] >= 30, "%s: %d bundles' branches moved"
                   % (name, got["moved"]))
        if name == "groups-and-lone":
            expect(0 < got["alone"] < got["groups"] < got["live"]
                   < got["bundles"], "groups-and-lone: %d live bundles in "
                   "%d groups, %d alone" % (got["live"], got["groups"],
                                            got["alone"]))
        if name == "C=300-Z=300":
            expect(got["big entries"] > 0 and got["big moved"] > 0,
                   "C=300-Z=300: the bigcount table moved no count")
        say("  trim case %-23s %d bundles, rows of %d: branches %s, new "
            "k-mers %d, trim positions moved by earlier consumes in %d "
            "bundles, branches in %d; %d candidates, %d live in %d groups "
            "(%d alone); bigcount table %d entries, windows at 300 moved "
            "in %d reads" % (name, got["bundles"], got["L"], got["branches"],
                             got["new"], got["lifted"], got["moved"],
                             got["candidates"], got["live"], got["groups"],
                             got["alone"], got["big entries"],
                             got["big moved"]))
    for name in trim_cases.COUNT_CASES:
        got = trim_cases.check_counts_case(name, dev)
        errs["read_counts"] = max(errs["read_counts"], got["mismatches"])
        expect(got["mismatches"] == 0, "read_counts != plain on count case "
               "%s" % name)
        say("  count case %-36s %d rows of %d codes (plan %s): read_counts "
            "== plain; %d trimmed to 0, %d untrimmed over its thresholds"
            % (name, got["rows"], got["L"], got["plan"], got["trim 0"],
               got["untrimmed"]))
    got = trim_cases.check_long_window(dev)
    errs["trim_scan"] = max(errs["trim_scan"], got["mismatches"])
    expect(got["mismatches"] == 0,
           "ScanTrimmerState on the card != on the CPU with long reads")
    expect(got["launches"] == (got["runs"],) * 3,
           "long-read windows: %s launches for %d runs"
           % (got["launches"], got["runs"]))
    say("  trim long reads: 3 windows of 200 bundles with reads of "
        "5,000-15,000 bases in %d runs, %d bundles consumed, card == CPU"
        % (got["runs"], got["consumed"]))
    return len(trim_cases.CASES) + len(trim_cases.COUNT_CASES) + 1


# kernel G's launches and the wrappers that count them
_TRIM_WRAPPERS = (("trim_mark", "trim_mark_cuda"),
                  ("trim_probe", "trim_probe_cuda"),
                  ("trim_scan", "trim_walk_cuda"),
                  ("read_counts", "read_counts_cuda"))
# their kernels' names in a trace
_TRIM_TRACED = ("mark_kernel", "probe_kernel", "walk_kernel",
                "counts_kernel")


def _trim_launch_counters(SK):
    for _, fn in _TRIM_WRAPPERS:
        getattr(SK, fn).launches = 0


def _trim_launches(SK):
    return {name: getattr(SK, fn).launches for name, fn in _TRIM_WRAPPERS}


def _say_trim_trace(label, t_wall, dev_ms, found, scan, card):
    """A traced trim-low-abund run: device time in all, kernel G's
    pre-pass (mark and probe) and walk apart, a bundle and a live bundle,
    its counts (ScanTrimmerState), and H's time a window."""
    mark_ms, mark_n = found["mark_kernel"]
    probe_ms, probe_n = found["probe_kernel"]
    walk_ms, walk_n = found["walk_kernel"]
    h_ms, h_n = found["counts_kernel"]
    cand, live, groups = (int(c) for c in (scan.candidates, scan.live,
                                           scan.groups))
    expect(0 < groups <= live <= scan.bundles and cand <= live,
           "%s: %d candidates, %d live bundles in %d groups of %d"
           % (label, cand, live, groups, scan.bundles))
    g_ms = mark_ms + probe_ms + walk_ms
    say("%s traced: %.6f s, device %.4f ms (busy %.2f%%); kernel G %.4f ms "
        "over %d bundles = %.4f us a bundle: pre-pass mark %.4f ms in %d "
        "launches + probe %.4f ms in %d, walk %.4f ms in %d launches over "
        "%d live bundles (%.4f of all) = %.4f us a live bundle; %d "
        "candidates, %d groups (%.4f live bundles a group); read_counts "
        "%.4f ms in %d launches = %.4f ms a window; on %s"
        % (label, t_wall, dev_ms, 100 * dev_ms / (t_wall * 1e3), g_ms,
           scan.bundles, g_ms * 1e3 / max(scan.bundles, 1), mark_ms, mark_n,
           probe_ms, probe_n, walk_ms, walk_n, live,
           live / max(scan.bundles, 1), walk_ms * 1e3 / max(live, 1), cand,
           groups, live / max(groups, 1), h_ms, h_n, h_ms / max(h_n, 1),
           card))


def _check_trim(E, d, out_name, trimmer, label):
    """A trim-low-abund run's answers against the JAX package's: (.abundtrim
    sha256 and bytes, .ct sha256 and bytes, n_unique, summary-info sha256,
    its fields)."""
    info_path = os.path.join(d, "stamps-reads.fa.gz.info.json")
    with open(info_path) as f:
        info = json.load(f)
    got = (_file_sha256(os.path.join(d, out_name))
           + _file_sha256(os.path.join(d, "out.ct"))
           + (trimmer.graph.n_unique_kmers(), _file_sha256(info_path)[0],
              info))
    want = (E["abundtrim_sha256"], E["abundtrim_bytes"], E["ct_sha256"],
            E["ct_bytes"], E["n_unique"], E["info_sha256"], E["info"])
    expect(got == want, "%s: (.abundtrim sha256, bytes, .ct sha256, bytes, "
           "n_unique, summary sha256, summary) = %s, JAX gives %s"
           % (label, got, want))
    return got


def run_config3(torch, SK, dev, card, errs):
    """Config 3 through the port's CLIs in this process, at the reference's
    parameters, the JAX answers asserted and kernels G and H seen to
    launch: (a) trim-low-abund -k 20 -x 5e7 -N 4 -C 2 -s --summary-info json
    on data/stamps-reads.fa.gz, (b) the same with -V, (c) filter-abund -C 2
    on phase 4b's .ct (made again) over data/25k.fq.gz, (d)
    filter-abund-single -k 20 -x 5e7 -C 2 on it; then (a) traced (G's device
    time a bundle, H's a window), and G and H on its window 6 against their
    plain versions, timed beside their bounds (scripts/trim_bench.py).
    Returns the launches of (a) and those times."""
    from khmer_tpu_torch.cli import (filter_abund, filter_abund_single,
                                     load_into_counting, trim_low_abund)
    from khmer_tpu_torch.scripts.trim_bench import time_shape, time_window

    E = EXPECT_C3
    args = ["-k", "20", "-x", "5e7", "-N", "4", "-C", "2"]
    runs = {}
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_",
                                     dir=REPO) as tmp:
        for label, extra in (("trim", []), ("trim-V", ["-V"]),
                             ("trace", None)):
            d = os.path.join(tmp, label)
            os.makedirs(d)
            # --summary-info writes beside its input
            os.symlink(STAMPS, os.path.join(d, "stamps-reads.fa.gz"))
            _trim_launch_counters(SK)
            if extra is None:
                t_wall, dev_ms, found, t_trim = _traced_cli(
                    torch, trim_low_abund.main,
                    args + ["stamps-reads.fa.gz"], d, _TRIM_TRACED)
                continue
            wall, _, trimmer = _run_cli(
                torch, trim_low_abund.main, args + extra + [
                    "-s", "out.ct", "--summary-info", "json",
                    "stamps-reads.fa.gz"], d)
            runs[label] = (wall, _trim_launches(SK), trimmer, _check_trim(
                E[label], d, "stamps-reads.fa.gz.abundtrim", trimmer,
                "config 3 " + label))
        d = os.path.join(tmp, "filter")
        os.makedirs(d)
        _run_cli(torch, load_into_counting.main,
                 ["-q", "-k", str(K), "-x", "5e7", "-N", "4", "out.ct", DATA],
                 d)
        ct = _file_sha256(os.path.join(d, "out.ct"))
        expect(ct == (EXPECT_EXACT["ct_sha256"], EXPECT_EXACT["ct_bytes"]),
               "config 3 filter-abund: the .ct of load-into-counting %s" % (
                   ct,))
        _trim_launch_counters(SK)
        f_wall, _, _ = _run_cli(torch, filter_abund.main,
                                ["-C", "2", "out.ct", DATA], d)
        f_launches = _trim_launches(SK)
        f_got = _file_sha256(os.path.join(d, "25k.fq.gz.abundfilt"))
        d = os.path.join(tmp, "single")
        os.makedirs(d)
        _trim_launch_counters(SK)
        s_wall, s_err, _ = _run_cli(
            torch, filter_abund_single.main,
            ["-k", "20", "-x", "5e7", "-C", "2", DATA], d)
        s_launches = _trim_launches(SK)
        s_got = (_file_sha256(os.path.join(d, "25k.fq.gz.abundfilt"))
                 + (int(s_err.split("Total number of unique k-mers:")[1]
                        .split()[0]),))
    for label, want in (("filter", (E["filter"]["abundfilt_sha256"],
                                    E["filter"]["abundfilt_bytes"])),
                        ("single", (E["single"]["abundfilt_sha256"],
                                    E["single"]["abundfilt_bytes"],
                                    E["single"]["n_unique"]))):
        got = f_got if label == "filter" else s_got
        expect(got == want, "config 3 %s: %s, JAX gives %s"
               % (label, got, want))
    for label, n in (("trim", runs["trim"][1]), ("trim -V", runs["trim-V"][1]),
                     ("filter-abund", f_launches),
                     ("filter-abund-single", s_launches)):
        for name in ([n for n, _ in _TRIM_WRAPPERS] if "trim" in label
                     else ("read_counts",)):
            expect(n[name] > 0, "%s never launched on config 3's %s"
                   % (name, label))
    for label in ("trim", "trim-V"):
        wall, n, trimmer, got = runs[label]
        say("phase 8 config 3 (%s): trim-low-abund %s-s --summary-info "
            "json on data/stamps-reads.fa.gz: %.6f s = %.6g reads/s; "
            ".abundtrim %d B sha256 %s, .ct %d B sha256 %s, n_unique %d, "
            "summary %s (the JAX answers); %d scan runs; launches %s; on %s"
            % ("a" if label == "trim" else "b", "-V " if "V" in label
               else "", wall, got[6]["reads"] / wall, got[1], got[0], got[3],
               got[2], got[4], got[6], trimmer.scan.scan_runs, n, card))
    say("phase 8 config 3 (c): filter-abund -C 2 on phase 4b's .ct over "
        "data/25k.fq.gz: %.6f s; .abundfilt %d B sha256 %s (the JAX "
        "answer); launches %s; (d) filter-abund-single -k 20 -x 5e7 -C 2: "
        "%.6f s; .abundfilt %d B sha256 %s, n_unique %d (the JAX answers); "
        "launches %s; on %s"
        % (f_wall, f_got[1], f_got[0], f_launches, s_wall, s_got[1],
           s_got[0], s_got[2], s_launches, card))
    _say_trim_trace("phase 8 (a)", t_wall, dev_ms, found, t_trim.scan, card)
    w = _trim_bench_window(time_window(dev), "config 3", errs, card)
    for shape in ("c", "d"):
        _say_counts_shape(time_shape(dev, shape), errs, card)
    timings = {name: {"ms": w[key]["ms"], "plain_ms": w[key]["plain_ms"],
                      "bound_ms": w[key]["bound"][0],
                      "bound_by": w[key]["bound"][1], "library_ms": None}
               for key, name in (("mark", "trim_mark"),
                                 ("probe", "trim_probe"),
                                 ("walk", "trim_scan"),
                                 ("counts", "read_counts"))}
    torch.cuda.empty_cache()
    return runs["trim"][1], timings


def _say_counts(h):
    """Kernel H's part of a phase-8 line: times, bounds, the staging
    share."""
    staging = "%.4f" % h["staging"]
    if "staging_pass2" in h:
        staging += ", %.4f on the consumed reads after their consume" % (
            h["staging_pass2"])
    return ("read_counts kernel %.4f ms as issued, device %.4f ms, plain "
            "%.4f ms, bound %.5f ms (%s; %d B, %d ops), sector floor %.5f ms "
            "(%d B); loads a staging by table 0 would save %s"
            % (h["ms"], h["device_ms"], h["plain_ms"], h["bound"][0],
               h["bound"][1], h["bytes"], h["ops"], h["sector_ms"],
               h["sector_bytes"], staging))


def _say_counts_shape(h, errs, card):
    """Check and print one trim_bench.time_shape result."""
    errs["read_counts"] = max(errs["read_counts"], h["mismatches"])
    expect(h["mismatches"] == 0, "read_counts != plain on shape (%s)"
           % h["shape"])
    say("  H shape (%s) %s: %d rows of %d codes; %s; on %s"
        % (h["shape"], h["what"], h["rows"], h["L"], _say_counts(h), card))


def _trim_bench_window(w, label, errs, card):
    """Check and print one trim_bench.time_window result."""
    for key, name in (("scan", "trim_scan"), ("mark", "trim_mark"),
                      ("probe", "trim_probe"), ("walk", "trim_scan"),
                      ("counts", "read_counts")):
        errs[name] = max(errs[name], w[key]["mismatches"])
        expect(w[key]["mismatches"] == 0, "%s (%s) != plain on %s's window "
               "%d" % (name, key, label, w["window"]))
    g, h = w["scan"], w["counts"]
    parts = "; ".join(
        "%s %.4f ms as issued, device %.4f ms, plain %.4f ms, bound %.5f ms "
        "(%s; %d B, %d ops)" % (key, w[key]["ms"], w[key]["device_ms"],
                                w[key]["plain_ms"], w[key]["bound"][0],
                                w[key]["bound"][1], w[key]["bytes"],
                                w[key]["ops"])
        for key in ("mark", "probe", "walk"))
    say("  %s window %d: %d bundles (%d reads) of rows of %d codes, "
        "branches %s, %d candidates, %d probed, %d live in %d groups (set of "
        "2^%d bits); kernel G whole %.4f ms as issued (%.4f us a bundle), "
        "device %.4f ms, plain %.4f ms, bound %.5f ms (%s; %d B, %d ops); "
        "%s (%.4f us a live bundle); %s; on %s"
        % (label, w["window"], w["bundles"], w["reads"], w["L"],
           w["branches"], w["candidates"], w["probed"], w["live"],
           w["groups"], w["mark_bits"], g["ms"], g["us_per_bundle"],
           g["device_ms"], g["plain_ms"], g["bound"][0], g["bound"][1],
           g["bytes"], g["ops"], parts, w["walk"]["us_per_live"],
           _say_counts(h), card))
    return w


def run_config3_scale(torch, SK, dev, card, errs, reads, head):
    """trim-low-abund at a table size users run: -k 20 -C 2 -x 1e9 -N 4 -s
    --summary-info json (4 GB of u8 tables) on the 1,000,000 synthetic
    reads (50x coverage, 1% substitutions: the load trim-low-abund exists
    for), the JAX answers asserted, G and H seen to launch, the device
    memory beside the tables read; then a traced run without -s on the
    first TRACED_READS of them (`head`), and G and H on window 6 against
    their plain versions, beside their bounds."""
    from khmer_tpu_torch.cli import trim_low_abund
    from khmer_tpu_torch.scripts.trim_bench import time_window

    E = EXPECT_C3_SCALE
    args = ["-k", "20", "-C", "2", "-x", "1e9", "-N", "4"]
    tables = SK.byte_flat_size(SK.get_n_primes_near_x(4, 1e9))
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_",
                                     dir=REPO) as tmp:
        run, traced = os.path.join(tmp, "run"), os.path.join(tmp, "trace")
        for d, src in ((run, reads), (traced, head)):
            os.makedirs(d)
            os.symlink(src, os.path.join(d, "synth.fa"))
        _trim_launch_counters(SK)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        wall, _, trimmer = _run_cli(torch, trim_low_abund.main, args + [
            "-s", "out.ct", "--summary-info", "json", "synth.fa"], run)
        peak = torch.cuda.max_memory_allocated(dev)
        launches = _trim_launches(SK)
        with open(os.path.join(run, "synth.fa.info.json")) as f:
            info = json.load(f)
        got = (_file_sha256(os.path.join(run, "synth.fa.abundtrim"))
               + _file_sha256(os.path.join(run, "out.ct"))
               + (trimmer.graph.n_unique_kmers(), info))
        os.remove(os.path.join(run, "out.ct"))
        want = (E["abundtrim_sha256"], E["abundtrim_bytes"], E["ct_sha256"],
                E["ct_bytes"], E["n_unique"], E["info"])
        expect(got == want, "config 3 at 4 GB: (.abundtrim sha256, bytes, "
               ".ct sha256, bytes, n_unique, summary) = %s, JAX gives %s"
               % (got, want))
        del trimmer
        torch.cuda.empty_cache()
        t_wall, dev_ms, found, t_trim = _traced_cli(
            torch, trim_low_abund.main, args + ["synth.fa"], traced,
            _TRIM_TRACED)
        _say_trim_trace("phase 8b", t_wall, dev_ms, found, t_trim.scan, card)
        del t_trim
        torch.cuda.empty_cache()
        w = time_window(dev, reads, x=1e9, reps=3)
    expect(min(launches.values()) > 0,
           "trim kernels never launched at 4 GB: %s" % launches)
    say("phase 8b config 3 at -k 20 -C 2 -x 1e9 -N 4: trim-low-abund -s "
        "--summary-info json on %d synthetic reads: %.6f s = %.6g reads/s; "
        ".abundtrim %d B sha256 %s, .ct %d B sha256 %s, n_unique %d, "
        "summary %s (the JAX answers); tables %.3f GB, peak device memory "
        "%.3f GB, beside the tables %.1f MB; launches %s; on %s"
        % (info["reads"], wall, info["reads"] / wall, got[1], got[0], got[3],
           got[2], got[4], got[5], tables / 1e9, peak / 1e9,
           (peak - tables) / 1e6, launches, card))
    _trim_bench_window(w, "-x 1e9", errs, card)
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 3 (kernels J and K) and phase 9: config 4, unique-kmers and
# load-graph
# ---------------------------------------------------------------------------

# kernel J's launches in a trace: its sample and probe, its templates over
# BitEvents and the bucketed core's scan and finalize (no other update runs
# beside it)
_J_TRACED = ("bit_sample_kernel", "bit_probe_kernel", "BitEvents",
             "scan_kernel", "finalize_kernel")


def _j_traced(found):
    """(device ms, kernel launches) of kernel J in a _traced_cli result."""
    return (sum(found[n][0] for n in _J_TRACED),
            sum(found[n][1] for n in _J_TRACED))


def run_graph_cases(torch, dev, errs):
    """Kernels J and K against their plain versions on the cases of
    scripts/graph_cases.py."""
    from khmer_tpu_torch.scripts import graph_cases

    for name in graph_cases.BIT_CASES:
        err = graph_cases.check_bit_case(name, dev)
        errs["bit_update"] = max(errs["bit_update"], err)
        expect(err == 0, "bit_update != plain on case %s" % name)
        torch.cuda.empty_cache()
    for name in graph_cases.HLL_CASES:
        err = graph_cases.check_hll_case(name, dev)
        errs["hll_add"] = max(errs["hll_add"], err)
        expect(err == 0, "hll_add != plain on case %s" % name)
    say("  graph cases: bit_update == plain on %s; hll_add == plain on %s"
        % (", ".join(graph_cases.BIT_CASES),
           ", ".join(graph_cases.HLL_CASES)))
    return len(graph_cases.BIT_CASES), len(graph_cases.HLL_CASES)


def run_config4(torch, SK, dev, card, errs, label, path, x, E,
                keep_graph=False, keep_dir=None):
    """Config 4 through the port's CLIs in this process: unique-kmers -k
    20 -e 0.01 and load-graph -k 20 -x `x` -N 4 on `path`, the JAX
    answers E asserted and kernels K and J seen to launch (launches set to
    0 just before each CLI and read just after). Returns ({"bit_update":
    J's launches in load-graph, "hll_add": K's in unique-kmers}, the first
    native block of `path`); with keep_graph, in place of the launches, a
    Nodegraph that took the tagged consume through the API. keep_dir: a
    directory that keeps load-graph's graph and tagset as g, g.tagset."""
    from khmer_tpu_torch.cli import load_graph, unique_kmers
    from khmer_tpu_torch.core.sketch import Nodegraph
    from khmer_tpu_torch.io import native

    with tempfile.TemporaryDirectory(prefix=".chip_smoke_",
                                     dir=REPO) as tmp:
        SK.hll_add_cuda.launches = 0
        u_wall, u_err, _ = _run_cli(torch, unique_kmers.main, [
            "-k", "20", "-e", "0.01", path], tmp)
        k_launches = SK.hll_add_cuda.launches
        SK.bit_update_cuda.launches = 0
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        g_wall, g_err, _ = _run_cli(torch, load_graph.main, [
            "-k", "20", "-x", x, "-N", "4", "out.ng", path], tmp)
        peak = torch.cuda.max_memory_allocated(dev)
        j_launches = SK.bit_update_cuda.launches
        ng_path = os.path.join(tmp, "out.ng")
        got = {
            "estimate": int(re.search(
                r"Total estimated number of unique 20-mers: (\d+)",
                u_err).group(1)),
            "n_unique": int(g_err.split(
                "Total number of unique k-mers:")[1].split()[0]),
            "n_tags": (os.path.getsize(ng_path + ".tagset") - 22) // 8}
        got["ng_sha256"], got["ng_bytes"] = _file_sha256(ng_path)
        got["tagset_sha256"], _ = _file_sha256(ng_path + ".tagset")
        got["info_sha256"], _ = _file_sha256(ng_path + ".info")
        if keep_dir:
            os.replace(ng_path, os.path.join(keep_dir, "g"))
            os.replace(ng_path + ".tagset",
                       os.path.join(keep_dir, "g.tagset"))
        else:
            os.remove(ng_path)
    want = {key: E[key] for key in got}
    expect(got == want, "%s: %s, JAX gives %s" % (label, got, want))
    expect(k_launches > 0 and j_launches > 0, "%s: hll_add launched %d "
           "times, bit_update %d" % (label, k_launches, j_launches))
    tables = SK.bit_flat_size(SK.get_n_primes_near_x(4, float(x)))
    say("%s config 4: unique-kmers -k 20 -e 0.01 %.6f s = %.6g reads/s = "
        "%.6g k-mers/s, estimate %d; load-graph -k 20 -x %s -N 4 %.6f s = "
        "%.6g reads/s = %.6g k-mers/s, n_unique %d, %d tags, .ng %d B "
        "sha256 %s, .tagset sha256 %s, .info sha256 %s (the JAX answers); "
        "bit tables %.3f GB, peak device memory %.3f GB; launches hll_add "
        "%d, bit_update %d; on %s"
        % (label, u_wall, E["reads"] / u_wall, E["kmers"] / u_wall,
           got["estimate"], x, g_wall, E["reads"] / g_wall,
           E["kmers"] / g_wall, got["n_unique"], got["n_tags"],
           got["ng_bytes"], got["ng_sha256"], got["tagset_sha256"],
           got["info_sha256"], tables / 1e9, peak / 1e9, k_launches,
           j_launches, card))

    codes, meta, _ = next(native.pack_blocks(path))
    first = (codes, meta[:, 0].copy(), len(codes))
    if not keep_graph:
        return {"bit_update": j_launches, "hll_add": k_launches}, first
    ng = Nodegraph(20, float(x), 4, device=dev)
    ng.consume_seqfile_and_tag(path)
    expect(ng.n_unique_kmers() == E["n_unique"] and ng.n_tags()
           == E["n_tags"], "%s: the tagged consume" % label)
    return ng, first


def trace_config4(torch, card, reads):
    """scripts/trace_config4.py in its own process (traces taken late in
    this one lost device events: none of an HLL consume's launches, in
    runs of under a second): the HLL consume and the tagged consume of
    phases 9, 9a and 9b, each once untraced and once traced; their wall,
    device time, busy share and K's and J's device time, and whether the
    trace holds every launch the wrappers counted."""
    proc = subprocess.run(
        [sys.executable, "-m", "khmer_tpu_torch.scripts.trace_config4",
         "--synth", reads], cwd=REPO, capture_output=True, text=True,
        timeout=600)
    expect(proc.returncode == 0, "trace_config4 failed:\n" + proc.stderr)
    phases = {"stamps-genomes": "phase 9", "stamps-reads": "phase 9a",
              "synth": "phase 9b"}
    kmers = {"stamps-genomes": EXPECT_C4["genomes"]["kmers"],
             "stamps-reads": EXPECT_C4["stamps"]["kmers"],
             "synth": EXPECT_C4["synth"]["kmers"]}
    for line in proc.stdout.splitlines():
        r = json.loads(line)
        say("  %s %s traced: %.6f s = %.6g k-mers/s, device %.4f ms (busy "
            "%.2f%%): hll_add %.4f ms in %d launches, bit_update %.4f ms "
            "in %d kernel launches (%d calls; trace %s); the most device "
            "time: %s; on %s"
            % (phases[r["input"]], r["run"], r["wall_ms"] / 1e3,
               kmers[r["input"]] / (r["wall_ms"] / 1e3), r["device_ms"],
               100 * r["busy_share"], r["hll_add_ms"], r["hll_add_kernels"],
               r["bit_update_ms"], r["bit_update_kernels"],
               r["calls"]["bit_update"],
               "whole" if r["whole"] else "short of the launches",
               [(n[:40], round(ms, 4), c) for n, ms, c in r["top"][:4]],
               card))


def time_hll_block(torch, SK, dev, card, errs, block):
    """Kernel K on one native block of the run (a flat chunk) against its
    plain version, and the register half alone as one PyTorch call
    (scatter_reduce_ amax of precomputed indices and values), at -e 0.01
    (p 14), k 20; its bound by operations (graph_cases.hll_ops)."""
    import numpy as np

    from khmer_tpu_torch.ops.hashing import murmur_hash_windows
    from khmer_tpu_torch.scripts import cuda_ms, device_ms
    from khmer_tpu_torch.scripts.graph_cases import hll_ops

    codes, starts, fill = block
    k, p = 20, 14
    cd = torch.from_numpy(codes).to(dev)
    sd = torch.from_numpy(starts.astype(np.int64)).to(dev)
    rk = torch.zeros(1 << p, dtype=torch.uint8, device=dev)
    rp = rk.clone()
    SK.hll_add_cuda(rk, cd, sd, fill, k)
    SK.hll_add_plain(rp, cd, sd, fill, k)
    err = int((rk.to(torch.int32) - rp.to(torch.int32)).abs().max())
    errs["hll_add"] = max(errs["hll_add"], err)
    expect(err == 0, "hll_add != plain on the first block")
    h = murmur_hash_windows(cd[:fill], k)[0]
    valid = SK._flat_window_mask(sd, fill, k, dev)
    index, rho = SK.hll_index_rho(h[valid], p)
    rho = rho.to(torch.uint8)
    lib = torch.zeros_like(rk)
    nwin = int(valid.sum())
    reps = 20
    t = {"ms": cuda_ms(lambda: SK.hll_add_cuda(rk, cd, sd, fill, k), reps),
         "device": device_ms(lambda: SK.hll_add_cuda(rk, cd, sd, fill, k),
                             reps),
         "plain_ms": cuda_ms(lambda: SK.hll_add_plain(rp, cd, sd, fill, k),
                             3),
         "library_ms": cuda_ms(lambda: lib.scatter_reduce_(
             0, index, rho, "amax"), reps)}
    expect(torch.equal(lib, rk), "scatter_reduce_ registers != hll_add's")
    b = bound(fill + 8 * starts.shape[0] + 2 * (1 << p), hll_ops(k, nwin))
    say("  hll_add on the first native block (%d codes, %d reads, %d "
        "windows, p %d): kernel %.4f ms (device %.4f ms) = %.4g windows/s, "
        "plain %.4f ms, scatter_reduce_ amax of the registers alone %.4f "
        "ms, bound %.4f ms (%s: %.4g operations); on %s"
        % (fill, starts.shape[0], nwin, p, t["ms"], t["device"],
           nwin / (t["device"] / 1e3), t["plain_ms"], t["library_ms"], b[0],
           b[1], hll_ops(k, nwin), card))
    return {"ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": b[0],
            "bound_by": b[1], "library_ms": t["library_ms"]}


def time_tracking_update(torch, SK, dev, primes, errs):
    """Kernel J as abundance-dist's step calls it on its first batch
    (scripts/hist_gather_bench.first_events: every window of the batch's
    rows, with its valid mask) into the config-1 tracking tables, each
    call on a fresh zeroed table (as the first batch finds it), against
    its plain version; its byte bound: 8 B a hash, 1 B a flag and a mask
    byte, each distinct table byte the valid events touch read and
    written."""
    from khmer_tpu_torch.scripts import cuda_ms, device_ms
    from khmer_tpu_torch.scripts.hist_gather_bench import first_events

    hashes, valid = first_events(dev)
    n = hashes.shape[0]
    reps = 20
    fresh = [SK.init_tables("bit", primes, dev)
             for _ in range(2 * reps + 3)]
    nu = torch.zeros(1, dtype=torch.int64, device=dev)
    flags = SK.bit_update_cuda(primes, fresh.pop(), nu, hashes, n, valid)
    plain = SK.bit_update_plain(primes, fresh.pop(), nu.clone(), hashes, n,
                                valid)
    err = int((flags != plain).sum())
    errs["bit_update"] = max(errs["bit_update"], err)
    expect(err == 0, "bit_update != plain on the abundance batch")

    def kernel():
        return SK.bit_update_cuda(primes, fresh.pop(), nu, hashes, n, valid)

    t = {"ms": cuda_ms(kernel, reps - 1), "device": device_ms(kernel,
                                                             reps - 1)}
    spare = [SK.init_tables("bit", primes, dev) for _ in range(4)]
    t["plain_ms"] = cuda_ms(lambda: SK.bit_update_plain(
        primes, spare.pop(), nu, hashes, n, valid), 3)
    live = hashes[valid]
    touched = torch.cat([SK.umod(live, p) // 8 + off for p, off in zip(
        primes, SK.bit_offsets(primes))])
    nbytes = int(torch.unique(touched).numel())
    b = bound(10 * n + 2 * nbytes, live.shape[0] * len(primes))
    t.update(bound_ms=b[0], bound_by=b[1], new=int(flags.sum()),
             valid=int(valid.sum()))
    del fresh, spare
    torch.cuda.empty_cache()
    return t


def time_bit_chunk(torch, SK, dev, card, errs, ng, reads):
    """Kernel J on load-graph's calls at phase 9b's size (4 tables, 4 GB;
    scripts/graph_bench.py's shapes) against its plain version, each
    bit-exact, with the lanes its probe left open (its lane masks, left in
    the scratch) held to a count from the tables: (c) the stream's first
    chunk into the tables as the whole stream left them (every bit of it
    set, no flag, the tables unchanged); (a) the same chunk into the
    tables zeroed, as it finds them, each call timed alone after they are
    zeroed again (the time in the kernels line); (b) chunk 40 into the
    tables as chunks 0-39 left them, restored from a device copy before
    each call (the shape of most of the stream's calls). Bounds at each:
    bytes (8 B a hash, 1 B a flag, each distinct table byte the chunk
    touches read and written) and the sector floor (32 B for each
    distinct sector read, and again for each one in which a bit is set).
    Leaves ng's tables zeroed."""
    from khmer_tpu_torch.scripts import cuda_ms, device_ms, reset_ms
    from khmer_tpu_torch.scripts.graph_bench import (MID_CHUNK, SECTOR,
                                                     bit_lanes,
                                                     stream_chunks)
    from khmer_tpu_torch.scripts.graph_cases import probe_mask

    chunks = stream_chunks(reads, dev, upto=MID_CHUNK + 1)
    primes, tables = ng._primes, ng.tables
    nu = torch.zeros(1, dtype=torch.int64, device=dev)
    T = len(primes)
    # the chunk's scratch, kept between calls as the Nodegraph keeps it
    scratch = SK.update_scratch(None, 1 << 20, T, dev)
    reps = 20

    def floors(n, lanes):
        _, nbytes, sectors, _, written = lanes
        return (bound(9 * n + 2 * nbytes, n * T),
                bound(9 * n + SECTOR * (sectors + written), n * T)[0])

    def check(h, reset, label):
        """Kernel and plain version from the same state: their flags,
        n_unique and tables equal, and the lanes the probe left open those
        of bit_probe_plain; the state restored after. Returns bit_lanes
        and whether the sample let the probe run."""
        n = h.shape[0]
        reset()
        lanes = bit_lanes(SK, primes, tables.flat, h, n)
        probed = SK.bit_sample_plain(primes, tables.flat, h, n)
        want_open = SK.bit_open_lanes(SK.bit_probe_plain(primes, tables.flat,
                                                         h, n))
        nu.zero_()
        fk = SK.bit_update_cuda(primes, tables, nu, h, n, scratch=scratch)
        # the probe's lane masks, left in the scratch
        opened = SK.bit_open_lanes(probe_mask(scratch, n, T))
        nk, kflat = int(nu), tables.flat.clone()
        reset()
        nu.zero_()
        fp = SK.bit_update_plain(primes, tables, nu, h, n)
        err = int((fk != fp).sum()) + abs(nk - int(nu)) + int(
            (kflat != tables.flat).sum()) + abs(opened - want_open)
        del kflat
        torch.cuda.empty_cache()
        expect(err == 0, "bit_update on 9b's %s: %d differences"
               % (label, err))
        errs["bit_update"] = max(errs["bit_update"], err)
        reset()
        return lanes, probed, 1 - opened / lanes[0]

    def share(lanes):
        """On bits set before the call: the data's share; the lanes the
        probe settled, or "unprobed" where the sample left it out."""
        (_, _, _, zero, _), probed, settled = lanes
        return "%.4f on set bits, %s" % (
            1 - zero / lanes[0][0],
            "%.4f settled by the probe" % settled if probed
            else "unprobed")

    h = chunks[0]
    n = h.shape[0]
    # (c): the tables as the whole stream left them
    full = tables.flat.clone()

    def refill():
        tables.flat.copy_(full)
    lanes_c = check(h, refill, "full tables")
    del full
    expect(lanes_c[0][3] == 0, "9b's first chunk left lanes open after "
           "the whole stream")

    def kernel(h=h):
        return SK.bit_update_cuda(primes, tables, nu, h, h.shape[0],
                                  scratch=scratch)
    set_ms = cuda_ms(kernel, reps)
    set_dev = device_ms(kernel, reps)

    # (a): zeroed
    def zero():
        tables.flat.zero_()
    lanes_a = check(h, zero, "zeroed tables")
    t = {"ms": reset_ms(zero, kernel, reps, False)[0],
         "device": reset_ms(zero, kernel, reps, True)[0],
         "plain_ms": reset_ms(zero, lambda: SK.bit_update_plain(
             primes, tables, nu, h, n), 3, False)[0]}

    # (b): chunk MID_CHUNK into the tables as the chunks before it left them
    zero()
    for c in chunks[:MID_CHUNK]:
        kernel(c)
    mid = tables.flat.clone()
    hb = chunks[MID_CHUNK]

    def restore():
        tables.flat.copy_(mid)
    lanes_b = check(hb, restore, "chunk %d" % MID_CHUNK)
    mid_ms = reset_ms(restore, lambda: kernel(hb), reps, False)[0]
    mid_dev = reset_ms(restore, lambda: kernel(hb), reps, True)[0]
    mid_plain = reset_ms(restore, lambda: SK.bit_update_plain(
        primes, tables, nu, hb, hb.shape[0]), 3, False)[0]
    del mid, chunks
    zero()
    torch.cuda.empty_cache()
    (b_a, f_a), (b_b, f_b), (b_c, f_c) = (
        floors(n, lanes_a[0]), floors(hb.shape[0], lanes_b[0]),
        floors(n, lanes_c[0]))
    say("  bit_update on 4 tables of %.3f GB (kernel as issued, device, "
        "plain; bound by %s; sector floor; its lanes): (a) the first "
        "%d-hash chunk zeroed %.4f ms, %.4f ms, %.4f ms; bound %.4f ms; "
        "floor %.4f ms; %s; (b) chunk %d (%d hashes) into the tables as "
        "chunks 0-%d left them %.4f ms, %.4f ms, %.4f ms; bound %.4f ms; "
        "floor %.4f ms; %s; (c) the first chunk into the tables after the "
        "whole stream %.4f ms, %.4f ms; bound %.4f ms; floor %.4f ms; %s; "
        "kernel == plain (flags, n_unique, tables) and open lanes == "
        "bit_probe_plain's at each; on %s"
        % (tables.flat.shape[0] / 1e9, b_a[1], n, t["ms"], t["device"],
           t["plain_ms"], b_a[0], f_a, share(lanes_a), MID_CHUNK,
           hb.shape[0], MID_CHUNK - 1, mid_ms, mid_dev, mid_plain, b_b[0],
           f_b, share(lanes_b), set_ms, set_dev, b_c[0], f_c,
           share(lanes_c), card))
    return {"ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": b_a[0],
            "bound_by": b_a[1], "library_ms": None}



# ---------------------------------------------------------------------------
# phase 10: config 5, do-partition
# ---------------------------------------------------------------------------


def run_neighbor_cases(torch, dev, errs):
    """Kernel L (probe and gather) against its plain versions on the cases
    of scripts/partition_cases.py."""
    from khmer_tpu_torch.scripts import partition_cases

    for name in partition_cases.NEIGHBOR_CASES:
        err = partition_cases.check_neighbor_case(name, dev)
        errs["neighbors"] = max(errs["neighbors"], err)
        expect(err == 0, "neighbors != plain on case %s" % name)
    say("  neighbour cases: neighbors and bit_gather == plain on %s"
        % ", ".join(partition_cases.NEIGHBOR_CASES))
    return len(partition_cases.NEIGHBOR_CASES)


def _split_times(owner, names, times, keep=None, sync=None):
    """Wrap owner's methods (or a module's functions) `names` so that each
    adds its wall seconds to times[name]; keep[name] gathers what each
    call of it returned, and keep[name + " self"] the object of its first
    call (its first argument), where keep is given; sync() is called
    before and after each call (inside its time), where it is given, so
    that the time holds the device's work the call issued. Returns a
    function that restores them."""
    saved = {name: getattr(owner, name) for name in names}

    def wrap(name, fn):
        def timed(self, *args, **kwargs):
            if sync is not None:
                sync()
            t0 = time.perf_counter()
            out = fn(self, *args, **kwargs)
            if sync is not None:
                sync()
            times[name] = times.get(name, 0.0) + time.perf_counter() - t0
            if keep is not None:
                keep.setdefault(name, []).append(out)
                keep.setdefault(name + " self", self)
            return out
        return timed

    for name, fn in saved.items():
        setattr(owner, name, wrap(name, fn))
    return lambda: [setattr(owner, n, fn) for n, fn in saved.items()]


def _host_rss():
    """This process's resident set now, in bytes."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no VmRSS in the process status")


class _PeakRss:
    """This process's resident set, read every `every` seconds on a thread
    of its own inside a with block: .before and .peak, in bytes."""

    def __init__(self, every=0.01):
        self.every = every

    def __enter__(self):
        self.before = self.peak = _host_rss()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def _sample(self):
        while not self._stop.wait(self.every):
            self.peak = max(self.peak, _host_rss())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, _host_rss())


def _renamed_part_sha256(path):
    """sha256 of a .part with its partition ids renamed 1, 2, ... by first
    appearance."""
    ids = {}
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for line in f:
            if line[:1] in (b">", b"@") and b"\t" in line:
                head, pid = line.rstrip(b"\n").rsplit(b"\t", 1)
                pid = int(pid)
                if pid:
                    pid = ids.setdefault(pid, len(ids) + 1)
                line = head + b"\t%d\n" % pid
            h.update(line)
    return h.hexdigest()


def _check_golden(pmap_path):
    """Tags whose id in the subset .pmap differs from the reference's
    golden map (0: not in the map)."""
    import gzip

    import numpy as np

    with open(pmap_path, "rb") as f:
        blob = f.read()
    rec = np.frombuffer(blob[18:], dtype=[("tag", "<u8"), ("pid", "<u4")])
    got = dict(zip(rec["tag"].tolist(), rec["pid"].tolist()))
    ref = {}
    with gzip.open(GOLDEN_PMAP, "rt") as f:
        for line in f:
            tag, pid = line.split()
            ref[int(tag)] = int(pid)
    bad = [t for t in ref if got.get(t, 0) != ref[t]]
    return bad + [t for t in got if t not in ref], len(ref)


def run_config5(torch, SK, dev, card, errs, label, path, x, flags, E,
                every, keep_files=()):
    """Config 5 through the port's do-partition in this process: -k 20 -x
    `x` -N 4 --keep-subsets `flags` on `path`, the JAX answers E asserted,
    kernel L's launches counted (set to 0 just before the CLI and read
    just after) and every `every`-th level held to its plain version
    (scripts/level_tap.py: the walk's C++ loop calls the card's probe
    through a callback that checks after it, outside the probe's time);
    the wall split into its steps (the steps' methods timed by wrapping
    them while the CLI runs; the walk by its own clocks, kt_level_stats,
    and the probe context's), with the host's peak resident set over the
    CLI and the walk's keeper bytes; keep_files: (file the CLI wrote, path
    to move it to) pairs. Returns (L's launches, the largest frontier L
    probed, with its tables: (f, r, primes, flat, k))."""
    from khmer_tpu_torch.cli import do_partition
    from khmer_tpu_torch.core.graphmixin import HashgraphMixin
    from khmer_tpu_torch.ops.host import TagWalk
    from khmer_tpu_torch.scripts import held_ms
    from khmer_tpu_torch.scripts.level_tap import LevelTap

    times, keep = {}, {}
    restores = [
        _split_times(HashgraphMixin, (
            "consume_seqfile_and_tag", "divide_tags_into_subsets",
            "do_subset_partition", "merge_subset_from_disk",
            "output_partitions"), times, keep),
        _split_times(TagWalk, ("keeper_bytes", "tags"), times, keep)]
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_",
                                     dir=REPO) as tmp:
        tap = LevelTap("bit", every, os.path.join(tmp, "frontiers.i64"))
        restores.append(tap.install())
        try:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            SK.neighbors_cuda.launches = 0
            SK.bit_update_cuda.launches = 0
            with _PeakRss() as rss:
                wall, err, _ = _run_cli(torch, do_partition.main, [
                    "-k", "20", "-x", x, "-N", "4", "--keep-subsets"]
                    + flags + ["g", path], tmp)
            l_launches = SK.neighbors_cuda.launches
            j_launches = SK.bit_update_cuda.launches
        finally:
            for restore in restores:
                restore()
        peak = torch.cuda.max_memory_allocated(dev)
        graph = keep["divide_tags_into_subsets self"]
        replay_ms = sum(held_ms([
            functools.partial(SK.neighbors_cuda, graph._primes,
                              graph.tables.flat, f, r, graph.ksize())
            for f, r in tap.replay(dev)]))
        keepers = keep.pop("keeper_bytes")
        batches = [len(found) for found in keep.pop("tags")]
        n_tags = graph.n_tags()
        pmaps = [os.path.join(tmp, "g.subset.%d.pmap" % i)
                 for i in range(len(keep["do_subset_partition"]))]
        part = os.path.join(tmp, os.path.basename(path) + ".part")
        got = {"n_tags": n_tags, "subsets": len(pmaps),
               "output": int(re.search(r"output (\d+) partitions",
                                       err).group(1)),
               "info_sha256": _file_sha256(os.path.join(tmp, "g.info"))[0],
               "pmap_sha256": [_file_sha256(p)[0] for p in pmaps]}
        if "renamed_part_sha256" in E:
            got["renamed_part_sha256"] = _renamed_part_sha256(part)
        else:
            got["part_sha256"] = _file_sha256(part)[0]
        if "counts" in E:
            got["counts"] = keep["do_subset_partition"][0].count_partitions()
            bad, n_ref = _check_golden(pmaps[0])
            expect(not bad, "%s: %d tags' ids differ from the golden map"
                   % (label, len(bad)))
        f, r, prober = tap.largest
        largest = (f, r, graph._primes, graph.tables.flat, graph.ksize())
        del graph, keep, prober
        for name, to in keep_files:
            os.replace(os.path.join(tmp, name), to)
    want = {key: E[key] for key in got}
    expect(got == want, "%s: %s, JAX gives %s" % (label, got, want))
    expect(tap.err == 0, "%s: neighbors != plain on %d of %d nodes"
           % (label, tap.err, tap.checked))
    errs["neighbors"] = max(errs["neighbors"], tap.err)
    expect(l_launches > 0 and j_launches > 0, "%s: neighbors launched %d "
           "times, bit_update %d" % (label, l_launches, j_launches))
    expect(l_launches == tap.calls, "%s: %d launches of L, %d levels"
           % (label, l_launches, tap.calls))
    c = tap.totals
    passes = c["walk_s"] + c["frontier_s"]
    probes = c["probe_s"] - tap.seconds
    walk = passes + probes
    union = times["do_subset_partition"] - walk - tap.seconds
    say("%s config 5: do-partition -k 20 -x %s -N 4 %s %.6f s: tagged "
        "consume %.6f s (%d tags), walk %.6f s (C++ passes %.6f s, of them "
        "writing the frontiers %.6f s; probes %.6f s: issuing the uploads "
        "%.6f s, L's launches %.6f s, the copies back %.6f s, waiting in "
        "the syncs %.6f s; L replayed %.4f ms, %.3f ns a node: the walk's "
        "frontiers probed again in order after the CLI, CUDA events "
        "around each launch while a sleep kernel holds the stream, the "
        "card's gap between launches included (probe_bench's walk shape "
        "gives the profiler's kernel time); %d launches, %d levels, %d "
        "nodes probed; batches of %s traversals, their keepers at most "
        "%.3f GB, %.3f GB in all the batches), "
        "union-find %.6f s, merge %.6f s, annotate %.6f s; "
        "%d subsets, output %d partitions%s (the JAX answers); .info %s, "
        ".pmap %s, .part %s; bit_update launches %d; L held to its plain "
        "version on %d nodes of %d levels, every frontier written to "
        "a file, in %.3f s (in the wall, not in the walk's time); the "
        "host's peak resident set %.3f GB over the CLI, read "
        "every 10 ms (%.3f GB before it); peak device memory %.3f GB; on %s"
        % (label, x, " ".join(flags), wall, times["consume_seqfile_and_tag"],
           n_tags, walk, passes, c["frontier_s"], probes, c["upload_s"],
           c["launch_s"], c["copy_back_s"], c["sync_s"], replay_ms,
           replay_ms * 1e6 / max(sum(tap.sizes), 1), l_launches,
           len(tap.sizes), sum(tap.sizes), batches, max(keepers) / 1e9,
           sum(keepers) / 1e9, union, times["merge_subset_from_disk"],
           times["output_partitions"], got["subsets"], got["output"],
           ", count_partitions %s, every tag's id the golden map's (%d)"
           % (got["counts"], n_ref) if "counts" in E else "",
           got["info_sha256"][:16], [p[:16] for p in got["pmap_sha256"]],
           (got.get("part_sha256") or "renamed "
            + got["renamed_part_sha256"])[:24], j_launches, tap.checked,
           tap.calls, tap.seconds, rss.peak / 1e9, rss.before / 1e9,
           peak / 1e9, card))
    return l_launches, largest


def time_neighbors(torch, SK, card, errs, label, frontier):
    """Kernel L on a phase's largest frontier against its plain version:
    as issued and on the device, beside its byte bound (16 B up and 1 B
    back a node) and its two sector floors (32 B a distinct sector read),
    with the loads and sectors of each stage of L's rule."""
    from khmer_tpu_torch.scripts import cuda_ms, device_ms, partition_cases

    f, r, primes, flat, k = frontier
    n = f.shape[0]
    got = SK.neighbors_cuda(primes, flat, f, r, k)
    want = SK.neighbors_plain(primes, flat, f, r, k)
    err = int((got != want).sum())
    errs["neighbors"] = max(errs["neighbors"], err)
    expect(err == 0, "%s: neighbors != plain on its largest frontier"
           % label)
    t = {"ms": cuda_ms(lambda: SK.neighbors_cuda(primes, flat, f, r, k),
                       20),
         "plain_ms": cuda_ms(lambda: SK.neighbors_plain(primes, flat, f, r,
                                                       k), 3),
         "library_ms": None}
    dev_ms = device_ms(lambda: SK.neighbors_cuda(primes, flat, f, r, k), 20)
    t["bound_ms"], t["bound_by"] = bound(17 * n, 8 * len(primes) * n)
    every, needed = partition_cases.probe_floors(primes, flat, f, r, k)
    _, stages = partition_cases.neighbor_stages(primes, flat, f, r, k)
    say("  %s neighbors on its largest frontier, %d nodes into %d tables "
        "of %.3f GB: kernel %.4f ms (device %.4f ms), plain %.4f ms, bound "
        "%.4f ms (%s); sector floors (32 B a distinct sector): every "
        "table of every neighbour %.4f ms (%d sectors), what a probe that "
        "stops at the first unset bit needs %.4f ms (%d); L's rule loads "
        "%s bytes (stages' tables, rows, loads, distinct sectors: %s); == "
        "plain; on %s"
        % (label, n, len(primes), flat.shape[0] / 1e9, t["ms"], dev_ms,
           t["plain_ms"], t["bound_ms"], t["bound_by"],
           every * 32 / PEAK_BYTES_S * 1e3, every,
           needed * 32 / PEAK_BYTES_S * 1e3, needed,
           sum(s["loads"] for s in stages),
           [(s["tables"], s["rows"], s["loads"], s["sectors"])
            for s in stages], card))
    return t


# ---------------------------------------------------------------------------
# phase 11: the knot pipeline
# ---------------------------------------------------------------------------


def run_pertable_cases(torch, dev, errs):
    """Kernel M against its plain version on the cases of
    scripts/pertable_cases.py."""
    from khmer_tpu_torch.scripts import pertable_cases

    for name in pertable_cases.PERTABLE_CASES:
        err = pertable_cases.check_pertable_case(name, dev)
        errs["byte_pertable"] = max(errs["byte_pertable"], err)
        expect(err == 0, "byte_pertable != plain on case %s" % name)
        torch.cuda.empty_cache()
    say("  per-table gather cases: byte_pertable == plain on %s"
        % ", ".join(pertable_cases.PERTABLE_CASES))
    return len(pertable_cases.PERTABLE_CASES)


def _pertable_check(torch, SK):
    """Kernel M as the repartition calls it (see _CallCheck): every call
    held to byte_pertable_plain, the largest call's hashes cloned (the
    staging reuses its buffer)."""
    def check(fn, args, kwargs):
        got = fn(*args)
        return got, _max_abs(got, SK.byte_pertable_plain(*args)), \
            args[2].shape[0]
    return _CallCheck(torch, SK, "byte_pertable", check,
                      lambda a: a[2].shape[0],
                      keep=lambda a: (a[0], a[1], a[2].clone()))


def _knot_splits(torch, SK):
    """Wrap the repartition's steps while a knot CLI runs: the excursions'
    walk (traversal.walk_excursions, kernel L's probes included), the
    keepers' upload (partition._Staging.upload; of it, the C++ walk
    writing the keepers out, ExcursionWalk.keepers), kernel M's call
    (sketch_kernels.pertable_counts), the counters' copy back
    (_Staging.download), the host's evaluation (ExcursionWalk.evaluate,
    the re-walks included), kernel A's commits (Countgraph._commit_hashes)
    and the tags' walk again (SubsetPartition.repartition_a_partition).
    The upload, M's call and the copy back are each timed between two
    synchronises of the card. Returns (times, the evaluations' outputs, a
    function that restores them)."""
    from khmer_tpu_torch.core import partition as P
    from khmer_tpu_torch.core import traversal as TR
    from khmer_tpu_torch.core.sketch import Countgraph
    from khmer_tpu_torch.ops.host import ExcursionWalk

    times, keep = {}, {}
    restores = [
        _split_times(TR, ("walk_excursions",), times),
        _split_times(P._Staging, ("upload", "download"), times,
                     sync=torch.cuda.synchronize),
        _split_times(SK, ("pertable_counts",), times,
                     sync=torch.cuda.synchronize),
        _split_times(ExcursionWalk, ("evaluate",), times, keep),
        _split_times(ExcursionWalk, ("keepers",), times),
        _split_times(Countgraph, ("_commit_hashes",), times),
        _split_times(P.SubsetPartition, ("repartition_a_partition",),
                     times)]
    return times, keep, lambda: [r() for r in restores]


def _say_split(label, wall, times, keep, check_s, m_ms, card):
    """Print a knot CLI's wall split (see _knot_splits; m_ms: M's kernel
    time, CUDA events around its calls); returns it as a dict of seconds,
    with the tags walked again."""
    evals = keep.get("evaluate", [])
    split = {"wall": wall,
             "excursions_walk": times.get("walk_excursions", 0.0),
             "keepers_out": times.get("keepers", 0.0),
             "upload": times.get("upload", 0.0) - times.get("keepers", 0.0),
             "M": times.get("pertable_counts", 0.0) - check_s,
             "copy_back": times.get("download", 0.0),
             "evaluation": times.get("evaluate", 0.0),
             "A_commits": times.get("_commit_hashes", 0.0),
             "tags_walk_again": times.get("repartition_a_partition", 0.0)}
    split["rest"] = (wall - check_s
                     - sum(v for k, v in split.items() if k != "wall"))
    split["M_kernel_s"] = m_ms / 1e3
    split["tags"] = sum(len(out[2]) for out in evals)
    split["batches"] = len(evals)
    split["tags_walked_again"] = sum(int(out[3].sum()) for out in evals)
    say("  %s %.6f s: excursions' walk %.6f s (%d tags, %d batches), the "
        "walk writing the keepers out %.6f s, their upload %.6f s, M's "
        "calls %.6f s (kernel %.6f s by CUDA "
        "events; its check %.3f s left out), the counters' copy back %.6f "
        "s (upload, calls and copy back each between two synchronises), "
        "the host's evaluation %.6f s (%d tags walked again), A's commits "
        "%.6f s, the tags' walk again (break on stop tags) %.6f s, the "
        "rest %.6f s; on %s"
        % (label, wall, split["excursions_walk"], split["tags"],
           split["batches"], split["keepers_out"], split["upload"],
           split["M"],
           split["M_kernel_s"], check_s, split["copy_back"],
           split["evaluation"], split["tags_walked_again"],
           split["A_commits"], split["tags_walk_again"], split["rest"],
           card))
    return split


def _stoptags(path):
    """(number of stop tags, sha256) of a .stoptags file."""
    import struct

    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(18)[10:18])[0]
    return n, _file_sha256(path)[0]


def _extract_sha256(d, prefix):
    """sha256 of extract-partitions' .dist and of each group file, in name
    order."""
    import glob

    groups = sorted(glob.glob(os.path.join(d, prefix + ".group*")))
    return {"dist": _file_sha256(os.path.join(d, prefix + ".dist"))[0],
            "groups": [_file_sha256(g)[0] for g in groups]}


def _sorted_glob():
    """Make glob.glob list in sorted order (the .pmap files find-knots
    reads in turn; JAX's answers were taken so); returns a function that
    restores it."""
    import glob

    real = glob.glob
    glob.glob = lambda pattern, *a, **kw: sorted(real(pattern, *a, **kw))
    return lambda: setattr(glob, "glob", real)


def run_knots(torch, SK, dev, card, errs, kept):
    """Phase 11, the knot pipeline of khmer's partitioning guide through
    the port's CLIs in this process, on data/stamps-reads.fa.gz at -k 20
    (BASELINE row 5's graph, -x 12.5e6 -N 4; find-knots' and
    make-initial-stoptags' countgraph at -x 2e8 -N 4): load-graph,
    make-initial-stoptags, partition-graph -S (the default walk),
    find-knots, filter-stoptags, do-partition of the filtered reads and
    extract-partitions of its .part and of phase 10's (kept/p10.part); the
    JAX answers EXPECT_C11 asserted; kernels M, L and A seen to launch
    (their counts set to 0 just before the first CLI and read after the
    last); M held to its plain version on every call. Returns (M's
    launches, its timing on the largest call)."""
    from khmer_tpu_torch.cli import (do_partition, extract_partitions,
                                     filter_stoptags, find_knots,
                                     load_graph, make_initial_stoptags,
                                     partition_graph)

    E = EXPECT_C11["stamps"]
    check = _pertable_check(torch, SK)
    walls, got, splits = {}, {}, {}
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_",
                                     dir=REPO) as tmp:
        restore = check.install()
        try:
            torch.cuda.reset_peak_memory_stats(dev)
            SK.byte_pertable_cuda.launches = 0
            SK.neighbors_cuda.launches = 0
            SK.byte_update_cuda.launches = 0
            walls["load-graph"], _, _ = _run_cli(torch, load_graph.main, [
                "-k", "20", "-x", "12.5e6", "-N", "4", "g", STAMPS], tmp)
            got["graph_sha256"] = [
                _file_sha256(os.path.join(tmp, f))[0]
                for f in ("g", "g.tagset")]
            for step, main, args in (
                    ("make-initial-stoptags", make_initial_stoptags.main,
                     ["-k", "20", "-x", "2e8", "-N", "4", "g"]),
                    ("partition-graph", partition_graph.main,
                     ["-S", "g.stoptags", "g"]),
                    ("find-knots", find_knots.main,
                     ["-x", "2e8", "-N", "4", "g"])):
                times, keep, unwrap = _knot_splits(torch, SK)
                check_s, calls = check.seconds, check.calls
                try:
                    walls[step], err, _ = _run_cli(torch, main, args, tmp)
                finally:
                    unwrap()
                if step != "partition-graph":
                    splits[step] = (times, keep, check.seconds - check_s,
                                    check.launch_ms(calls))
                if step == "make-initial-stoptags":
                    got["initial"] = _stoptags(os.path.join(
                        tmp, "g.stoptags"))
                elif step == "partition-graph":
                    got["pmap_sha256"] = _file_sha256(os.path.join(
                        tmp, "g.subset.0.pmap"))[0]
                else:
                    got["stoptags"] = _stoptags(os.path.join(
                        tmp, "g.stoptags"))
                    got["repartitioned"] = [int(v) for v in re.findall(
                        r"\*\* repartitioned size: (\d+)", err)]
            walls["filter-stoptags"], _, _ = _run_cli(
                torch, filter_stoptags.main,
                ["-k", "20", "g.stoptags", STAMPS], tmp)
            stopfilt = os.path.join(tmp, "stamps-reads.fa.gz.stopfilt")
            got["stopfilt_sha256"] = _file_sha256(stopfilt)[0]
            with open(stopfilt, "rb") as f:
                n_kept = f.read().count(b">")
            walls["do-partition"], err, _ = _run_cli(
                torch, do_partition.main,
                ["-k", "20", "-x", "12.5e6", "-N", "4", "--keep-subsets",
                 "g2", stopfilt], tmp)
            got["output"] = int(re.search(r"output (\d+) partitions",
                                          err).group(1))
            got["part_sha256"] = _file_sha256(stopfilt + ".part")[0]
            walls["extract-partitions"], _, _ = _run_cli(
                torch, extract_partitions.main,
                ["ex", stopfilt + ".part"], tmp)
            got["extract"] = _extract_sha256(tmp, "ex")
            walls["extract-partitions (phase 10's .part)"], _, _ = _run_cli(
                torch, extract_partitions.main,
                ["ex10", os.path.join(kept, "p10.part")], tmp)
            got["extract10"] = _extract_sha256(tmp, "ex10")
            m_launches = SK.byte_pertable_cuda.launches
            l_launches = SK.neighbors_cuda.launches
            a_launches = SK.byte_update_cuda.launches
        finally:
            restore()
        peak = torch.cuda.max_memory_allocated(dev)
    want = {key: E[key] for key in got}
    expect(got == want, "phase 11: %s, JAX gives %s" % (got, want))
    expect(check.err == 0, "phase 11: byte_pertable differs from plain by "
           "up to %d over %d hashes" % (check.err, check.checked))
    errs["byte_pertable"] = max(errs["byte_pertable"], check.err)
    expect(m_launches > 0 and l_launches > 0 and a_launches > 0,
           "phase 11: byte_pertable launched %d times, neighbors %d, "
           "byte_update %d" % (m_launches, l_launches, a_launches))
    say("phase 11 the knot pipeline on data/stamps-reads.fa.gz -k 20 "
        "(graph -x 12.5e6 -N 4, countgraph -x 2e8 -N 4): walls %s s, "
        "%.6f s in all; %d initial stop tags (sha256 %s), partition-graph "
        "-S .pmap %s, find-knots %d stop tags (sha256 %s), repartitioned "
        "sizes %s; filter-stoptags kept %d reads (.stopfilt %s); "
        "do-partition output %d partitions (.part %s); extract-partitions "
        ".dist %s with %d group files, of phase 10's .part .dist %s with "
        "%d (the JAX answers); launches byte_pertable %d, neighbors %d, "
        "byte_update %d; M held to its plain version on %d hashes of %d "
        "calls, CUDA events around its calls %.4f ms; peak device memory "
        "%.3f GB; on %s"
        % (json.dumps({k: round(v, 6) for k, v in walls.items()}),
           sum(walls.values()), got["initial"][0], got["initial"][1][:16],
           got["pmap_sha256"][:16], got["stoptags"][0],
           got["stoptags"][1][:16], got["repartitioned"], n_kept,
           got["stopfilt_sha256"][:16], got["output"],
           got["part_sha256"][:16], got["extract"]["dist"][:16],
           len(got["extract"]["groups"]), got["extract10"]["dist"][:16],
           len(got["extract10"]["groups"]), m_launches, l_launches,
           a_launches, check.checked, check.calls, check.launch_ms(),
           peak / 1e9, card))
    split = {step: _say_split("phase 11 " + step, walls[step], times, keep,
                              check_s, m_ms, card)
             for step, (times, keep, check_s, m_ms) in splits.items()}
    say(json.dumps({"phase": "11", "walls_s": walls, "split_s": split,
                    "card": card}))
    t = time_pertable(torch, SK, card, errs, check.largest[1])
    return m_launches, t


def run_knots_scale(torch, SK, dev, card, errs, kept):
    """Phase 11b: find-knots -x 2e8 -N 4 in this process on phase 9b's
    graph (4 GB of bit tables, 527,780 tags; kept/g) with phase 10b's six
    subset .pmap files, read in sorted order; the JAX answers EXPECT_C11
    asserted, M held to its plain version on every call, the wall
    split."""
    from khmer_tpu_torch.cli import find_knots

    E = EXPECT_C11["synth"]
    check = _pertable_check(torch, SK)
    restores = [check.install(), _sorted_glob()]
    times, keep, unwrap = _knot_splits(torch, SK)
    restores.append(unwrap)
    try:
        torch.cuda.reset_peak_memory_stats(dev)
        SK.byte_pertable_cuda.launches = 0
        SK.neighbors_cuda.launches = 0
        SK.byte_update_cuda.launches = 0
        with _PeakRss() as rss:
            wall, err, _ = _run_cli(torch, find_knots.main,
                                    ["-x", "2e8", "-N", "4", "g"], kept)
        launches = (SK.byte_pertable_cuda.launches,
                    SK.neighbors_cuda.launches, SK.byte_update_cuda.launches)
    finally:
        for restore in restores:
            restore()
    peak = torch.cuda.max_memory_allocated(dev)
    got = {"stoptags": _stoptags(os.path.join(kept, "g.stoptags")),
           "repartitioned": [int(v) for v in re.findall(
               r"\*\* repartitioned size: (\d+)", err)]}
    want = {key: E[key] for key in got}
    expect(got == want, "phase 11b: %s, JAX gives %s" % (got, want))
    expect(check.err == 0, "phase 11b: byte_pertable != plain")
    errs["byte_pertable"] = max(errs["byte_pertable"], check.err)
    say("phase 11b find-knots -x 2e8 -N 4 on phase 10b's graph (-x 8e9 -N "
        "4, 4 GB of bit tables, 527,780 tags) and its 6 subsets %.6f s: %d "
        "stop tags (sha256 %s), repartitioned sizes %s (the JAX answers); "
        "launches byte_pertable %d, neighbors %d, byte_update %d; M held "
        "to its plain version on %d hashes of %d calls; the host's peak "
        "resident set %.3f GB (%.3f GB before); peak device memory %.3f "
        "GB; on %s"
        % (wall, got["stoptags"][0], got["stoptags"][1][:16],
           got["repartitioned"], launches[0], launches[1], launches[2],
           check.checked, check.calls, rss.peak / 1e9, rss.before / 1e9,
           peak / 1e9, card))
    split = _say_split("phase 11b find-knots", wall, times, keep,
                       check.seconds, check.launch_ms(), card)
    say(json.dumps({"phase": "11b", "walls_s": {"find-knots": wall},
                    "split_s": {"find-knots": split}, "card": card}))


def time_pertable(torch, SK, card, errs, largest):
    """Kernel M on the largest call of phase 11's path against its plain
    version and against torch.take of the joined tables at precomputed
    indices (the gather alone, the library call), each hot (back to back)
    and cold (each call after a write of 100 MB, which flushes L2), beside
    its bound: 8 B in a hash and T B out, and a sector floor of 32 B for
    each distinct sector of each table the call touches. Then the same on
    scripts/pertable_bench.py's shape (b): 8,775,042 distinct hashes into
    4 tables of 200 MB of random bytes, every read a DRAM sector."""
    import numpy as np

    from khmer_tpu_torch.scripts import cuda_ms
    from khmer_tpu_torch.scripts import pertable_bench as PB

    primes, flat, hashes = largest
    dev = flat.device
    scratch = torch.empty(PB.FLUSH_BYTES, dtype=torch.uint8, device=dev)

    def read(label, primes, flat, hashes):
        got = SK.byte_pertable_cuda(primes, flat, hashes)
        want = SK.byte_pertable_plain(primes, flat, hashes)
        err = int((got.int() - want.int()).abs().max())
        errs["byte_pertable"] = max(errs["byte_pertable"], err)
        expect(err == 0, "%s: byte_pertable != plain" % label)
        idx = PB.flat_indices(primes, hashes)
        expect(torch.equal(torch.take(flat, idx), got),
               "%s: torch.take differs from byte_pertable" % label)
        c = PB.shape_counts(primes, flat, hashes, idx)
        m = PB.readings(lambda: SK.byte_pertable_cuda(primes, flat, hashes),
                        scratch.zero_, idx.numel())
        take = PB.readings(lambda: torch.take(flat, idx), scratch.zero_,
                           idx.numel())
        plain_ms = cuda_ms(lambda: SK.byte_pertable_plain(primes, flat,
                                                          hashes), 5)
        say("  %s: byte_pertable, %d hashes into %d tables of %.3f GB: hot "
            "%.4f ms as issued (device %.4f ms, %.4g lookups/s), cold %.4f "
            "ms (device %.4f ms); torch.take at precomputed indices hot "
            "%.4f ms (device %.4f), cold %.4f (device %.4f); plain %.4f ms; "
            "bytes bound (8 B in, %d B out a hash) %.5f ms, sector floor "
            "(32 B a distinct sector, %d sectors) %.5f ms; == plain; on %s"
            % (label, c["hashes"], c["tables"], c["table_bytes"] / 1e9,
               m["ms"], m["device_ms"], m["lookups_s"], m["cold_ms"],
               m["cold_device_ms"], take["ms"], take["device_ms"],
               take["cold_ms"], take["cold_device_ms"], plain_ms,
               c["tables"], c["bound_ms"], c["sectors"], c["floor_ms"],
               card))
        return {"ms": m["ms"], "plain_ms": plain_ms,
                "library_ms": take["ms"],
                "bound_ms": max(c["bound_ms"], c["floor_ms"]),
                "bound_by": "bytes"}

    t = read("phase 11's largest call", primes, flat, hashes)
    bp = PB.shape_primes("b")
    read("shape (b), distinct hashes", bp, PB.random_tables(bp, dev),
         torch.from_numpy(PB.synth_hashes(PB.NHASH).view(np.int64)).to(dev))
    return t


# ---------------------------------------------------------------------------
# phases 12 and 12b: the Countgraph as a de Bruijn graph
# ---------------------------------------------------------------------------


def _tag_lists_sha256(lists):
    """sha256 of tag lists, a line each: the tags ascending, as decimal
    numbers joined by commas."""
    h = hashlib.sha256()
    for tags in lists:
        h.update((",".join(str(int(t)) for t in sorted(int(x) for x in tags))
                  + "\n").encode())
    return h.hexdigest()


class _CallCheck:
    """A kernel's dispatcher (SK.<name>) as a phase's main path calls it,
    wrapped while the phase runs: CUDA events around each call of the
    kernel (the host's launch included); every `every`-th call (the first
    included) held by `check(fn, args, kwargs)`, which runs it and returns
    (its result, the largest absolute difference from its plain version,
    the values compared); the values of all calls by `size(args)`; and the
    arguments of the largest call (as `keep(args)` gives them) for
    timing."""

    def __init__(self, torch, SK, name, check, size, every=1,
                 keep=lambda a: a):
        self.torch, self.SK, self.name = torch, SK, name
        self.check, self.size, self.every, self.keep = check, size, every, \
            keep
        self.calls = self.checked = self.err = self.values = 0
        self.seconds = 0.0
        self.events = []
        self.largest = None

    def install(self):
        """Wrap SK.<name>; returns a function that restores it."""
        fn, event = getattr(self.SK, self.name), self.torch.cuda.Event

        def timed(*args, **kwargs):
            t0, t1 = event(enable_timing=True), event(enable_timing=True)
            t0.record()
            out = fn(*args, **kwargs)
            t1.record()
            self.events.append((t0, t1))
            return out

        def wrapped(*args, **kwargs):
            if self.calls % self.every:
                out = timed(*args, **kwargs)
            else:
                t = time.perf_counter()
                out, err, n = self.check(timed, args, kwargs)
                self.err = max(self.err, err)
                self.checked += n
                self.seconds += time.perf_counter() - t
            n = self.size(args)
            self.values += n
            if self.largest is None or n > self.largest[0]:
                self.largest = (n, self.keep(args), kwargs)
            self.calls += 1
            return out
        setattr(self.SK, self.name, wrapped)
        return lambda: setattr(self.SK, self.name, fn)

    def launch_ms(self, since=0):
        """ms by the CUDA events around the calls from call `since` on."""
        return sum(t0.elapsed_time(t1) for t0, t1 in self.events[since:])


def _max_abs(a, b):
    """The largest absolute difference of two tensors (0 when empty)."""
    return int((a.int() - b.int()).abs().max()) if a.numel() else 0


def _max_abs_out(torch, a, b):
    """_max_abs of two outputs, a tensor or a tuple of them; an int64
    tensor (hashes, indices) counts 1 where the two are not equal."""
    if isinstance(a, tuple):
        return max(_max_abs_out(torch, x, y) for x, y in zip(a, b))
    if a.dtype == torch.int64:
        return int(not torch.equal(a, b))
    return _max_abs(a, b)


def _pairs(got, want):
    """Kernel N's outputs beside its plain version's: the presence bytes,
    and with a band the band bytes too."""
    return zip(got, want) if isinstance(got, tuple) else [(got, want)]


def _check_window_counts(SK):
    def check(fn, args, kwargs):
        got = fn(*args, **kwargs)
        return got, _max_abs(got, SK.read_window_counts_plain(*args)), \
            got.numel()
    return check


def _check_byte_update(torch, SK):
    """Kernel A with its new flags held to byte_update_plain on copies of
    the tables and the unique count as they stood before the call: the
    flags, every counter, the count and the bigcount triggers (1 where
    they differ)."""
    def triggers(report):
        if report is None:
            return {}
        n = int(report[2][0])
        return SK.bigcount_triggers(
            report[0][:n].cpu().numpy().view("uint64"),
            report[1][:n].cpu().numpy())

    def check(fn, args, kwargs):
        primes, flat, n_unique, hashes, nvalid = args[:5]
        flat0, nu0 = flat.clone(), n_unique.clone()
        got = fn(*args, **kwargs)
        kw = {key: v for key, v in kwargs.items() if key != "scratch"}
        want = SK.byte_update_plain(primes, flat0, nu0, hashes, nvalid,
                                    *args[5:6], **kw)
        err = max(_max_abs(flat, flat0), abs(int(n_unique) - int(nu0)))
        if kwargs.get("with_event_new"):
            err = max(err, _max_abs(got[1], want[1]))
            got_r, want_r = got[0], want[0]
        else:
            got_r, want_r = got, want
        err = max(err, int(triggers(got_r) != triggers(want_r)))
        del flat0
        return got, err, int(nvalid)
    return check


def _countgraph_checks(torch, SK, every_probe, every_update, spool=None,
                       max_check=1 << 21):
    """The three kernels of the Countgraph's path, wrapped: A
    (SK.byte_update) and H's counts mode (SK.read_window_counts) by
    _CallCheck, every `every_update`-th call; N by a level tap on the
    walks' C++ loop (scripts/level_tap.py), every `every_probe`-th level
    (at most max_check nodes of a level), its frontiers spooled where
    `spool` is given, the largest level and the largest below
    SK.NBR_SMALL_NODES (N's small-level mode) kept."""
    from khmer_tpu_torch.scripts.level_tap import LevelTap

    return {
        "byte_update": _CallCheck(torch, SK, "byte_update",
                                  _check_byte_update(torch, SK),
                                  lambda a: int(a[4]), every_update),
        "byte_neighbors": LevelTap("byte", every_probe, spool, max_check,
                                   SK.NBR_SMALL_NODES),
        "read_window_counts": _CallCheck(torch, SK, "read_window_counts",
                                         _check_window_counts(SK),
                                         lambda a: a[3].numel())}


def _reset_launches(SK):
    for fn in (SK.byte_update_cuda, SK.byte_neighbors_cuda,
               SK.read_window_counts_cuda, SK.byte_gather_cuda):
        fn.launches = 0
    SK.byte_neighbors_cuda.small_launches = 0


def _launches(SK):
    return {"byte_update": SK.byte_update_cuda.launches,
            "byte_neighbors": SK.byte_neighbors_cuda.launches,
            "byte_neighbors_small": SK.byte_neighbors_cuda.small_launches,
            "read_counts": SK.read_window_counts_cuda.launches,
            "byte_gather": SK.byte_gather_cuda.launches}


def _timed_step(torch, fn, checks, walls, checked, name):
    """fn(), its wall seconds (the device's work included) in walls[name]
    and those of the checks' plain versions within it in checked[name]."""
    held = sum(c.seconds for c in checks.values())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    walls[name] = time.perf_counter() - t0
    checked[name] = sum(c.seconds for c in checks.values()) - held
    return out


def run_countgraph(torch, SK, dev, card, errs, kept):
    """Phase 12: a Countgraph(20, 12.5e6, 4) (50 MB of byte tables,
    bigcount on) on the card as a de Bruijn graph through the port's entry
    points: the tagged consume of data/stamps-reads.fa.gz, do_subset_
    partition and do_subset_partition_with_abundance(2, 200) (both cutting
    big traversals), the sweep of the first 1,000 reads at ranges 0 and
    81, consume_partitioned_fasta of phase 10's .part into a fresh graph,
    and count-median on phase 4b's .ct over data/25k.fq.gz; the JAX
    answers EXPECT_C12 asserted, the launches of A, N and H's counts mode
    counted over the path, and every call of each held to its plain
    version. Returns (launches, the three checks)."""
    from khmer_tpu_torch.cli import count_median, load_into_counting
    from khmer_tpu_torch.core import partition as P
    from khmer_tpu_torch.core.sketch import Countgraph
    from khmer_tpu_torch.io.fastx import FastxParser

    E = EXPECT_C12["stamps"]
    checks = _countgraph_checks(torch, SK, 1, 1, max_check=1 << 23)
    tap = checks["byte_neighbors"]
    walls, checked, got, probes = {}, {}, {}, {}

    def step(name, fn):
        """_timed_step, and the step's walk split: the probes' host
        seconds (the tap's checks out) and the C++ passes'."""
        before = dict(tap.totals, checks=tap.seconds)
        out = _timed_step(torch, fn, checks, walls, checked, name)
        d = {key: tap.totals[key] - before[key] for key in tap.totals}
        probes[name] = {"probes": d["probe_s"] - tap.seconds
                        + before["checks"],
                        "passes": d["walk_s"] + d["frontier_s"]}
        return out
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_",
                                     dir=REPO) as tmp:
        path = lambda name: os.path.join(tmp, name)
        seqs = [rec.sequence for _, rec in zip(range(1000),
                                               FastxParser(STAMPS))]
        restores = [c.install() for c in checks.values()]
        try:
            _reset_launches(SK)

            def make():
                g = Countgraph(20, 12.5e6, 4, device=dev)
                g.set_use_bigcount(True)
                return g, g.consume_seqfile_and_tag(STAMPS)
            g, (total, n_consumed) = step("tagged consume", make)
            g.save_tagset(path("g.tagset"))
            g.save(path("g.ct"))
            got["consume"] = [total, n_consumed, g.n_unique_kmers(),
                              g.n_tags(), _file_sha256(path("g.tagset"))[0],
                              _file_sha256(path("g.ct"))[0]]
            for key, call in (
                    ("partition", lambda: g.do_subset_partition(
                        0, 0, stop_big_traversals=True)),
                    ("abundance", lambda: g.do_subset_partition_with_abundance(
                        2, 200, stop_big_traversals=True))):
                subset = step(key, call)
                subset.save_partitionmap(path(key + ".pmap"))
                got[key] = [list(subset.count_partitions()),
                            _file_sha256(path(key + ".pmap"))[0]]
            for rr in (0, 81):
                found, _ = step("sweep %d" % rr,
                                lambda: P.sweep_for_tags_batch(g, seqs, rr))
                got["sweep %d" % rr] = [sum(map(len, found)),
                                        _tag_lists_sha256(found)]
            for q, f in zip(seqs[:20], found):
                expect(g.sweep_tag_neighborhood(q, 81) == set(f.tolist()),
                       "phase 12: sweep_tag_neighborhood differs from the "
                       "batch's sweep")

            def rebuild():
                fresh = Countgraph(20, 12.5e6, 4, device=dev)
                return fresh, fresh.consume_partitioned_fasta(
                    os.path.join(kept, "p10.part"))
            fresh, (n_reads, n_kmers) = step("consume-partitioned-fasta",
                                             rebuild)
            fresh.save_partitionmap(path("cpf.pmap"))
            got["cpf"] = [n_reads, n_kmers, fresh.n_tags(),
                          _file_sha256(path("cpf.pmap"))[0]]
            del fresh
            launches = _launches(SK)
            _run_cli(torch, load_into_counting.main,
                     ["-q", "-k", str(K), "-x", "5e7", "-N", "4", "--device",
                      str(dev), "out.ct", DATA], tmp)
            expect(_file_sha256(path("out.ct"))[0]
                   == EXPECT_EXACT["ct_sha256"], "phase 12: phase 4b's .ct "
                   "differs")
            SK.read_window_counts_cuda.launches = 0
            step("count-median", lambda: _run_cli(
                torch, count_median.main,
                ["--device", str(dev), "out.ct", DATA, "median.csv"], tmp))
            launches["read_counts"] += SK.read_window_counts_cuda.launches
            got["median"] = _file_sha256(path("median.csv"))[0]
        finally:
            for restore in restores:
                restore()
    want = {key: E[key] for key in got}
    expect(got == want, "phase 12: %s, JAX gives %s" % (got, want))
    _expect_checks("phase 12", checks, errs)
    expect(min(launches["byte_update"], launches["byte_neighbors"],
               launches["byte_neighbors_small"],
               launches["read_counts"]) > 0,
           "phase 12: a kernel of the path never launched: %s" % launches)
    expect(launches["byte_neighbors"] + launches["byte_neighbors_small"]
           == tap.calls, "phase 12: N launched %d times on %d levels"
           % (launches["byte_neighbors"] + launches["byte_neighbors_small"],
              tap.calls))
    say("phase 12 the Countgraph graph at config 5's shape, Countgraph(20, "
        "12.5e6, 4) with bigcount, on the stamps reads: %s; n_unique %d, %d "
        "tags, bigcount entries %d; partitions %s, with abundance (2, 200) "
        "%s; sweeps of 1,000 reads found %d tags at range 0, %d at 81; "
        "consume-partitioned-fasta %d reads, %d k-mers, %d tags; "
        "count-median CSV %s (the JAX answers); walls (s) %s, of which the "
        "plain versions' checks took %s; the walks' probes and C++ passes "
        "in them (s; a Python callback a level, the level tap's, in the "
        "probes) %s; launches %s; on %s"
        % (got["consume"][:2], got["consume"][2], got["consume"][3],
           len(g._bigcounts), got["partition"][0], got["abundance"][0],
           got["sweep 0"][0], got["sweep 81"][0], got["cpf"][0],
           got["cpf"][1], got["cpf"][2], got["median"][:16],
           {k: round(v, 6) for k, v in walls.items()},
           {k: round(v, 6) for k, v in checked.items()},
           {k: {kk: round(vv, 6) for kk, vv in v.items()}
            for k, v in probes.items() if v["probes"] or v["passes"]},
           launches, card))
    say(json.dumps({"phase": "12", "walls_s": walls, "checks_s": checked,
                    "walk_split_s": probes, "card": card}))
    del g
    torch.cuda.empty_cache()
    return launches, checks


def _expect_checks(label, checks, errs):
    for name, c in checks.items():
        keys = {"read_window_counts": ["read_counts"],
                "byte_neighbors": ["byte_neighbors",
                                   "byte_neighbors_small"]}.get(name, [name])
        expect(c.err == 0, "%s: %s differs from plain by up to %d over "
               "its %d values" % (label, name, c.err, c.checked))
        expect(c.calls > 0 and c.checked > 0, "%s: %s was not held to its "
               "plain version" % (label, name))
        for key in keys:
            errs[key] = max(errs[key], c.err)
    say("  %s: A's flags, N (its levels) and H's counts mode == plain on "
        "%s values of %s calls" % (
            label, [c.checked for c in checks.values()],
            [c.calls for c in checks.values()]))


def run_countgraph_scale(torch, SK, dev, card, errs, reads, ct_7b):
    """Phase 12b: Countgraph(20, 1e9, 4) (4 GB of byte tables, far past L2,
    bigcount on) tagged from phase 7b's 1,000,000 synthetic reads,
    do_subset_partition_with_abundance(2, 200) over every tag cutting big
    traversals, and count-median of the reads against phase 7b's .ct; the
    JAX answers EXPECT_C12["synth"] asserted; the wall split into the
    tagged consume, the walk, the union-find and count-median; the walk
    run again as the partition ran it with no tap (its answer asserted
    equal), split by the walk's and the probe context's clocks into
    passes, frontiers, uploads, launches, copies back and syncs; and N over
    the walk replayed after it, every level on its own frontier in order,
    by held events (scripts.held_ms: the device's time, its gap between
    launches included). Returns the checks."""
    from khmer_tpu_torch.cli import count_median
    from khmer_tpu_torch.core import partition as P
    from khmer_tpu_torch.core.sketch import Countgraph
    from khmer_tpu_torch.scripts import held_ms
    from khmer_tpu_torch.scripts.level_tap import add_clocks

    E = EXPECT_C12["synth"]
    walls, checked, got, walks = {}, {}, {}, []
    step = lambda name, fn: _timed_step(torch, fn, checks, walls, checked,
                                        name)
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_",
                                     dir=REPO) as tmp:
        path = lambda name: os.path.join(tmp, name)
        checks = _countgraph_checks(torch, SK, 8, 40, path("frontiers"))
        tap = checks["byte_neighbors"]
        # A's and H's checks stay on through count-median; the tap and
        # the walk's record come off before the walk runs again
        calls = [c.install() for name, c in checks.items()
                 if name != "byte_neighbors"]
        restores = [tap.install(),
                    _keep_calls(P, "find_all_tags_batch", walks)]
        try:
            _reset_launches(SK)
            torch.cuda.reset_peak_memory_stats(dev)

            def make():
                g = Countgraph(20, 1e9, 4, device=dev)
                g.set_use_bigcount(True)
                return g, g.consume_seqfile_and_tag(reads)
            g, (total, n_consumed) = step("tagged consume", make)
            g.save_tagset(path("g.tagset"))
            got["consume"] = [total, n_consumed, g.n_unique_kmers(),
                              g.n_tags(), _file_sha256(path("g.tagset"))[0]]
            subset = step("abundance",
                          lambda: g.do_subset_partition_with_abundance(
                              2, 200, stop_big_traversals=True))
            subset.save_partitionmap(path("band.pmap"))
            got["abundance"] = [list(subset.count_partitions()),
                                _file_sha256(path("band.pmap"))[0]]
            peak = torch.cuda.max_memory_allocated(dev)
            launches = _launches(SK)
        finally:
            for restore in reversed(restores):
                restore()
        # the walk again, untapped, as the partition ran it
        clocks = {}
        restore = add_clocks(clocks)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            again = [P.find_all_tags_batch(*a, **kw) for a, kw, _ in walks]
            plain_walk_s = time.perf_counter() - t0
        finally:
            restore()
        expect([_tag_lists_sha256(x) for x in again]
               == [_tag_lists_sha256(out) for _, _, out in walks],
               "phase 12b: the walk run again gives other tags")
        _, _, prober = tap.largest
        band, big = prober.band, prober.big
        replay = held_ms([
            functools.partial(SK.byte_neighbors_cuda, g._primes,
                              g.tables.flat, f, r, 20, band, big)
            for f, r in tap.replay(dev)])
        replay_nodes = sum(tap.sizes)
        del g, subset, again, walks, prober
        torch.cuda.empty_cache()
        SK.read_window_counts_cuda.launches = 0
        try:
            step("count-median", lambda: _run_cli(
                torch, count_median.main,
                ["--device", str(dev), ct_7b, reads, "median.csv"], tmp))
        finally:
            for restore in calls:
                restore()
        launches["read_counts"] = SK.read_window_counts_cuda.launches
        got["median"] = _file_sha256(path("median.csv"))[0]
    want = {key: E[key] for key in got}
    expect(got == want, "phase 12b: %s, JAX gives %s" % (got, want))
    _expect_checks("phase 12b", checks, errs)
    expect(min(launches["byte_update"], launches["byte_neighbors_small"],
               launches["read_counts"]) > 0,
           "phase 12b: a kernel of the path never launched: %s" % launches)
    expect(launches["byte_neighbors"] + launches["byte_neighbors_small"]
           == tap.calls, "phase 12b: N launched %d times on %d levels"
           % (launches["byte_neighbors"] + launches["byte_neighbors_small"],
              tap.calls))
    c = tap.totals
    tapped_walk = c["walk_s"] + c["frontier_s"] + c["probe_s"] - tap.seconds
    split = {"tagged consume": walls["tagged consume"]
             - checked["tagged consume"],
             "walk (tapped, checks out)": tapped_walk,
             "union-find": walls["abundance"] - checked["abundance"]
             - tapped_walk,
             "count-median": walls["count-median"] - checked["count-median"],
             "plain versions' checks (outside the split)": sum(
                 checked.values())}
    walk_split = {"walk": plain_walk_s,
                  "passes (walking the levels)": clocks["walk_s"],
                  "writing the frontiers": clocks["frontier_s"],
                  "probes": clocks["probe_s"],
                  "issuing the uploads": clocks["upload_s"],
                  "launching N": clocks["launch_s"],
                  "issuing the copies back": clocks["copy_back_s"],
                  "waiting in the syncs": clocks["sync_s"]}
    say("phase 12b the Countgraph graph at 4 GB, Countgraph(20, 1e9, 4) with "
        "bigcount, on phase 7b's 1,000,000 reads: %s, n_unique %d, %d tags; "
        "partitions with abundance (2, 200) %s; count-median CSV %s (the "
        "JAX answers); wall split (s) %s; the walk again with no tap, "
        "split by its clocks (s) %s; %d levels, %d nodes (%d held to plain, "
        "every 8th level); N launched %d times in its staged mode, %d in "
        "its small-level mode (below %d nodes); N over the walk replayed "
        "(%d levels, %d nodes) %.4f ms by held events (the device), %.4f "
        "ns a node; launches %s; peak device memory %.3f GB; on %s"
        % (got["consume"][:2], got["consume"][2], got["consume"][3],
           got["abundance"][0], got["median"][:16],
           {k: round(v, 6) for k, v in split.items()},
           {k: round(v, 6) for k, v in walk_split.items()}, tap.calls,
           replay_nodes, tap.checked, launches["byte_neighbors"],
           launches["byte_neighbors_small"], SK.NBR_SMALL_NODES,
           len(replay), replay_nodes, sum(replay),
           sum(replay) * 1e6 / max(replay_nodes, 1), launches, peak / 1e9,
           card))
    say(json.dumps({"phase": "12b", "walls_s": walls, "checks_s": checked,
                    "split_s": split, "walk_split_s": walk_split,
                    "n_walk_replayed_ms": sum(replay), "card": card}))
    torch.cuda.empty_cache()
    return checks, launches


def _keep_calls(owner, name, calls):
    """Wrap owner.<name> so that each call's (args, kwargs, result) goes
    to `calls`; returns a function that restores it."""
    fn = getattr(owner, name)

    def kept(*args, **kwargs):
        out = fn(*args, **kwargs)
        calls.append((args, kwargs, out))
        return out
    setattr(owner, name, kept)
    return lambda: setattr(owner, name, fn)


def time_countgraph_kernels(torch, SK, card, errs, checks, label):
    """N, H's counts mode and A with and without its flags on the largest
    calls of a phase's path, against their plain versions. N as
    time_neighbor_probe times it, beside the sector floors of
    countgraph_cases.byte_probe_floors; H and A as issued
    (scripts.cuda_ms) and on the device (scripts.device_ms). Returns the
    kernels-line times of N: {mode: its time cold, as issued, on the
    largest level the walk runs in that mode}."""
    from khmer_tpu_torch.scripts import cuda_ms, device_ms
    from khmer_tpu_torch.scripts.countgraph_cases import byte_probe_floors

    def floors(primes, flat, f, r, k):
        every, needed, loads = byte_probe_floors(primes, flat, f, r, k)
        return ("sector floors (32 B a distinct sector): every table of "
                "every neighbour %.4f ms (%d sectors), the counters the "
                "staged rule loads %.4f ms (%d sectors, %d loads)"
                % (every * 32 / PEAK_BYTES_S * 1e3, every,
                   needed * 32 / PEAK_BYTES_S * 1e3, needed, loads))

    out = time_neighbor_probe(
        torch, SK, card, errs, checks["byte_neighbors"], label, "byte", "N",
        lambda p, fl, f, r, k, pr: SK.byte_neighbors_plain(
            p, fl, f, r, k, pr.band, pr.big),
        lambda p, fl, f, r, k, pr, small: SK.byte_neighbors_cuda(
            p, fl, f, r, k, pr.band, pr.big, small),
        floors)
    _, args, kwargs = checks["read_window_counts"].largest
    call = lambda: SK.read_window_counts_cuda(*args)
    plain = lambda: SK.read_window_counts_plain(*args)
    err = _max_abs(call(), plain())
    errs["read_counts"] = max(errs["read_counts"], err)
    expect(err == 0, "%s: H's counts mode != plain" % label)
    codes = args[3]
    ms, dev_ms, plain_ms = cuda_ms(call, 20), device_ms(call, 20), \
        cuda_ms(plain, 3)
    trim = lambda: SK.read_counts_cuda(args[0], args[1], 2, 20, *args[2:])
    trim_ms, trim_dev = cuda_ms(trim, 20), device_ms(trim, 20)
    W = codes.shape[1] - args[1] + 1
    hb, _ = bound(codes.numel() + 4 * codes.shape[0] + codes.shape[0] * W,
                  0)
    say("  %s H's counts mode on its largest call, %d rows of %d codes: "
        "kernel %.4f ms (device %.4f ms), plain %.4f ms, byte bound %.4f "
        "ms (codes and lengths in, a byte a window out); H's two "
        "reductions on the same rows %.4f ms (device %.4f ms); on %s"
        % (label, codes.shape[0], codes.shape[1], ms, dev_ms, plain_ms, hb,
           trim_ms, trim_dev, card))
    _, args, kwargs = checks["byte_update"].largest
    primes, flat, n_unique, hashes, nvalid = args[:5]
    for flags in (False, True, True, False):
        ms = cuda_ms(lambda: SK.byte_update_cuda(
            primes, flat, n_unique, hashes, nvalid, True,
            with_event_new=flags), 10)
        say("  %s A on its largest call (%d events into %.3f GB), bigcount "
            "report on, %s flags: %.4f ms; on %s"
            % (label, int(nvalid), flat.shape[0] / 1e9,
               "with" if flags else "without", ms, card))
    return out


def run_countgraph_cases(torch, dev, errs):
    """Kernel N, A's flags and H's counts mode against their plain versions
    on the cases of scripts/countgraph_cases.py."""
    from khmer_tpu_torch.scripts import countgraph_cases as C
    from khmer_tpu_torch.scripts.trim_cases import COUNT_CASES

    n = 0
    for key, cases, check in (("byte_neighbors", C.NBR_CASES,
                               C.check_nbr_case),
                              ("byte_update", C.FLAG_CASES,
                               C.check_flag_case),
                              ("read_counts", COUNT_CASES,
                               C.check_counts_case)):
        for name in cases:
            err = check(name, dev)
            errs[key] = max(errs[key], err)
            expect(err == 0, "%s != plain on Countgraph case %s"
                   % (key, name))
            n += 1
    torch.cuda.empty_cache()
    say("  Countgraph graph cases: byte_neighbors (N without a band and at "
        "%d bands), byte_update with its flags and read_window_counts == "
        "plain on %d cases"
        % (len(C.BANDS), n))
    return n


# ---------------------------------------------------------------------------
# phases 13 and 13b: --small-count (the nibble tables, kernels P, Q and R)
# ---------------------------------------------------------------------------


def run_nibble_cases(torch, dev, errs):
    """Kernels P, Q and R against their plain versions on the cases of
    scripts/nibble_cases.py: NIBBLE_CASES (P; Q unmasked and under three
    masks; R's hashes-in entry) and ROW_CASES (R's and Q's rows modes)."""
    from khmer_tpu_torch.scripts import nibble_cases

    ran = []
    for name, fits, check in (
            [(n, nibble_cases.case_fits, nibble_cases.check_nibble_case)
             for n in nibble_cases.NIBBLE_CASES]
            + [(n, nibble_cases.row_case_fits, nibble_cases.check_row_case)
               for n in nibble_cases.ROW_CASES]):
        if not fits(name, dev):
            say("  nibble case %s skipped: the card lacks the memory" % name)
            continue
        for key, err in check(name, dev).items():
            errs[key] = max(errs[key], err)
            expect(err == 0, "%s != plain on nibble case %s" % (key, name))
        ran.append(name)
        torch.cuda.empty_cache()
    say("  nibble cases: nibble_update (tables, n_unique, new flags), "
        "nibble_gather (unmasked, a random, an all-false and an all-true "
        "mask), nibble_pertable, nibble_pertable_rows (hashes, counters, "
        "flat nibble indices, the fill) and nibble_row_counts == plain on %s"
        % ", ".join(ran))
    return len(ran)


def _nibble_checks(torch, SK):
    """Kernels P, Q and R as a phase's main path calls them (_CallCheck on
    the dispatchers sketch_kernels.nibble_update, nibble_gather (with its
    mask), nibble_pertable and the rows modes nibble_pertable_rows and
    nibble_row_counts): every call held to its plain version on the same
    inputs, P's from a copy of the tables before the call (tables,
    n_unique and, where the caller asks, the new flags); the largest
    call's hashes, codes and lengths cloned for timing."""
    def check_update(fn, args, kwargs):
        primes, flat, n_unique, hashes, nvalid = args[:5]
        flat_p, nu_p = flat.clone(), n_unique.clone()
        want = SK.nibble_update_plain(primes, flat_p, nu_p, hashes, nvalid,
                                      with_event_new=True)
        got = fn(*args, **kwargs)
        err = abs(int(n_unique) - int(nu_p))
        if got is not None:
            err = max(err, _max_abs(got, want))
        if not torch.equal(flat, flat_p):
            err = max(err, 1)
        del flat_p
        return got, err, int(nvalid)

    def check_gather(fn, args, kwargs):
        got = fn(*args, **kwargs)
        return got, _max_abs(got, SK.nibble_gather_plain(*args, **kwargs)), \
            got.numel()

    def check_pertable(fn, args, kwargs):
        got = fn(*args)
        return got, _max_abs(got, SK.nibble_pertable_plain(*args)), \
            got.numel()

    def check_rows(fn, args, kwargs):
        got = fn(*args)
        want = SK.nibble_pertable_rows_plain(*args)
        err = max(int(not torch.equal(got[0], want[0])),
                  _max_abs(got[1], want[1]),
                  int(not torch.equal(got[2], want[2])))
        return got, err, got[1].numel()

    def check_row_counts(fn, args, kwargs):
        got = fn(*args)
        return got, _max_abs(got, SK.nibble_row_counts_plain(*args)), \
            got.numel()

    keep = lambda a: (a[0], a[1]) + tuple(
        x.clone() if hasattr(x, "clone") and x.dtype == torch.int64
        and x.numel() > 1 else x for x in a[2:])
    keep_rows = lambda a: (a[0], a[1], a[2].clone(), a[3].clone(), a[4])
    windows = lambda a: a[2].shape[0] * (a[2].shape[1] - int(a[4]) + 1)
    return {"nibble_update": _CallCheck(torch, SK, "nibble_update",
                                        check_update, lambda a: int(a[4]),
                                        keep=keep),
            "nibble_gather": _CallCheck(torch, SK, "nibble_gather",
                                        check_gather,
                                        lambda a: a[2].numel(), keep=keep),
            "nibble_pertable": _CallCheck(torch, SK, "nibble_pertable",
                                          check_pertable,
                                          lambda a: a[2].numel(),
                                          keep=keep),
            "nibble_pertable_rows": _CallCheck(torch, SK,
                                               "nibble_pertable_rows",
                                               check_rows, windows,
                                               keep=keep_rows),
            "nibble_row_counts": _CallCheck(torch, SK, "nibble_row_counts",
                                            check_row_counts, windows,
                                            keep=keep_rows)}


def _install(checks):
    restores = [c.install() for c in checks.values()]
    return lambda: [r() for r in restores]


def _nibble_launches(SK):
    return {"nibble_update": SK.nibble_update_cuda.launches,
            "nibble_gather": SK.nibble_gather_cuda.launches,
            "nibble_pertable": SK.nibble_pertable_cuda.launches,
            "nibble_pertable_rows": SK.nibble_pertable_rows_cuda.launches,
            "nibble_row_counts": SK.nibble_row_counts_cuda.launches}


def _zero_launches(SK):
    for fn in (SK.nibble_update_cuda, SK.nibble_gather_cuda,
               SK.nibble_pertable_cuda, SK.nibble_pertable_rows_cuda,
               SK.nibble_row_counts_cuda, SK.bit_update_cuda,
               SK.histogram_add_cuda, SK.neighbors_cuda):
        fn.launches = 0


def _count(path, byte=b">"):
    with open(path, "rb") as f:
        return sum(block.count(byte) for block in iter(
            lambda: f.read(1 << 26), b""))


def _fold_checks(checks, errs, label):
    for key, c in checks.items():
        errs[key] = max(errs[key], c.err)
        expect(c.err == 0, "%s: %s differs from its plain version by up "
               "to %d" % (label, key, c.err))


def run_small_count(torch, SK, dev, card, errs):
    """Phase 13: configs 1-3 and the knot pipeline with --small-count
    through the port's CLIs in this process, at their phases' shapes:
    load-into-counting and abundance-dist-single -k 20 -x 5e7 -N 4 (4 x 25
    MB of nibble tables, beyond L2) on data/25k.fq.gz; normalize-by-median
    -C 20 -s on data/stamps-reads.fa.gz; trim-low-abund -k 20 -x 5e7 -N 4
    -C 2 -s on it, with and without -V; filter-abund-single -k 20 -x 5e7
    -C 2 on data/25k.fq.gz; load-graph -k 20 -x 12.5e6 -N 4 of the stamps
    reads (phase 11's graph), make-initial-stoptags -x 2e8 -N 4,
    partition-graph -S and find-knots -x 2e8 -N 4. The JAX answers
    (EXPECT_C13) asserted; the launch counts set to 0 before the first CLI
    and read after the last: P, Q (under its mask, the histogram's count),
    R (the knots' hashes-in gather), R's rows mode (normalize's and trim's
    windows), Q's rows mode (filter-abund-single's counts), J (the
    histogram's tracking table), C (its histogram) and L (the knots' walks)
    launched; every call of P, Q and R held to its plain version. Returns
    (their launches, their checks)."""
    from khmer_tpu_torch.cli import (abundance_dist_single,
                                     filter_abund_single, find_knots,
                                     load_graph, load_into_counting,
                                     make_initial_stoptags,
                                     normalize_by_median, partition_graph,
                                     trim_low_abund)

    E = EXPECT_C13
    checks = _nibble_checks(torch, SK)
    walls, got = {}, {}
    tables = ["-k", "20", "-x", "5e7", "-N", "4", "--small-count"]
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_",
                                     dir=REPO) as tmp:
        restore = _install(checks)
        try:
            _zero_launches(SK)
            walls["load-into-counting"], err, _ = _run_cli(
                torch, load_into_counting.main, tables + ["sc.ct", DATA],
                tmp)
            got["load"] = [_file_sha256(os.path.join(tmp, "sc.ct"))[0],
                           _unique(err)]
            walls["abundance-dist-single"], err, _ = _run_cli(
                torch, abundance_dist_single.main,
                tables + [DATA, "sc.dist"], tmp)
            got["single"] = _file_sha256(os.path.join(tmp, "sc.dist"))[0]
            walls["filter-abund-single"], _, _ = _run_cli(
                torch, filter_abund_single.main,
                ["-k", "20", "-x", "5e7", "-C", "2", "--small-count", DATA],
                tmp)
            got["filter_single"] = _file_sha256(
                os.path.join(tmp, os.path.basename(DATA) + ".abundfilt"))[0]
            walls["normalize-by-median"], err, _ = _run_cli(
                torch, normalize_by_median.main,
                ["-C", "20", "-s", "norm.ct", "--small-count", STAMPS], tmp)
            keep = os.path.join(tmp, os.path.basename(STAMPS) + ".keep")
            got["normalize"] = [_count(keep), _unique(err),
                                _file_sha256(keep)[0],
                                _file_sha256(os.path.join(tmp,
                                                          "norm.ct"))[0]]
            for v in ("", "-V"):
                d = os.path.join(tmp, "trim" + v)
                os.makedirs(d)
                walls["trim-low-abund" + (" " + v if v else "")], err, _ = \
                    _run_cli(torch, trim_low_abund.main,
                             tables[:6] + ["-C", "2", "-s", "trim.ct",
                                           "--small-count"]
                             + ([v] if v else []) + [STAMPS], d)
                at = os.path.join(d, os.path.basename(STAMPS) + ".abundtrim")
                got["trim" + v] = [_count(at), [int(n) for n in re.search(
                    r"removed (\d+) reads and trimmed (\d+) reads",
                    err).groups()], _file_sha256(at)[0],
                    _file_sha256(os.path.join(d, "trim.ct"))[0]]
            walls["load-graph"], _, _ = _run_cli(torch, load_graph.main, [
                "-k", "20", "-x", "12.5e6", "-N", "4", "g", STAMPS], tmp)
            walls["make-initial-stoptags"], _, _ = _run_cli(
                torch, make_initial_stoptags.main,
                ["-k", "20", "-x", "2e8", "-N", "4", "--small-count", "g"],
                tmp)
            got["initial"] = _file_sha256(os.path.join(tmp,
                                                       "g.stoptags"))[0]
            walls["partition-graph"], _, _ = _run_cli(
                torch, partition_graph.main, ["-S", "g.stoptags", "g"], tmp)
            walls["find-knots"], err, _ = _run_cli(
                torch, find_knots.main,
                ["-x", "2e8", "-N", "4", "--small-count", "g"], tmp)
            got["knots"] = [_file_sha256(os.path.join(tmp,
                                                      "g.stoptags"))[0],
                            [int(v) for v in re.findall(
                                r"\*\* repartitioned size: (\d+)", err)]]
            launches = _nibble_launches(SK)
            others = {"bit_update": SK.bit_update_cuda.launches,
                      "histogram_add": SK.histogram_add_cuda.launches,
                      "neighbors": SK.neighbors_cuda.launches}
        finally:
            restore()
    want = {key: E[key] for key in got}
    expect(got == want, "phase 13: %s, JAX gives %s" % (got, want))
    _fold_checks(checks, errs, "phase 13")
    for name, n in dict(launches, **others).items():
        expect(n > 0, "phase 13: %s never launched" % name)
    say("phase 13 --small-count through the CLIs (nibble tables): walls %s "
        "s; load-into-counting n_unique %d, .ct %s; abundance-dist-single "
        ".dist %s; filter-abund-single %s; normalize-by-median kept %d "
        "(n_unique %d); trim-low-abund wrote %d (removed, trimmed %s), "
        "with -V %d; "
        "make-initial-stoptags %s, find-knots %s, repartitioned %s (the JAX "
        "answers); launches %s, J %d, C %d, L %d; every call of P, Q, R "
        "and the rows modes held to its plain version (calls %s, values "
        "%s); on %s"
        % (json.dumps({k: round(v, 6) for k, v in walls.items()}),
           got["load"][1], got["load"][0][:16], got["single"][:16],
           got["filter_single"][:16], got["normalize"][0],
           got["normalize"][1], got["trim"][0], got["trim"][1],
           got["trim-V"][0], got["initial"][:16], got["knots"][0][:16],
           got["knots"][1], launches, others["bit_update"],
           others["histogram_add"], others["neighbors"],
           json.dumps({k: c.calls for k, c in checks.items()}),
           json.dumps({k: c.values for k, c in checks.items()}), card))
    return launches, checks


def _unique(err):
    return int(err.split("Total number of unique k-mers:")[1].split()[0])


def run_small_count_scale(torch, SK, dev, card, errs, reads, head):
    """Phase 13b, --small-count at scale: load-into-counting -k 20 -x 2e9
    -N 4 --small-count on phase 7b's 1,000,000 reads (4 x 1 GB of nibble
    tables: the 4 GB that 7b's byte tables take, holding twice the
    counters) and abundance-dist-single at the same flags, then
    normalize-by-median -C 20 -x 2e9 -N 4 --small-count and
    filter-abund-single -k 20 -x 2e9 -N 4 -C 2 --small-count on the first
    250,000 of those reads. That cut keeps the script's time:
    BatchedNormalizer and the filter walk each window's reads in Python, as
    JAX's do. The JAX answers (EXPECT_C13["synth"], from its native engine)
    asserted, every call of P, Q and R and the rows modes held to its plain
    version, P, Q (masked), R's rows mode and Q's rows mode launched (R's
    hashes-in entry serves only the knots, phase 13), the device memory
    printed beside the tables. Returns (launches, checks)."""
    from khmer_tpu_torch.cli import (abundance_dist_single,
                                     filter_abund_single, load_into_counting,
                                     normalize_by_median)

    E = EXPECT_C13["synth"]
    checks = _nibble_checks(torch, SK)
    walls, got, peaks = {}, {}, {}
    tables = ["-k", "20", "-x", "2e9", "-N", "4", "--small-count"]
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_",
                                     dir=REPO) as tmp:
        restore = _install(checks)
        try:
            _zero_launches(SK)
            for step, main, args in (
                    ("load-into-counting", load_into_counting.main,
                     tables + ["sc.ct", reads]),
                    ("abundance-dist-single", abundance_dist_single.main,
                     tables + [reads, "sc.dist"]),
                    ("normalize-by-median", normalize_by_median.main,
                     ["-C", "20", "-x", "2e9", "-N", "4", "--small-count",
                      head]),
                    ("filter-abund-single", filter_abund_single.main,
                     ["-k", "20", "-x", "2e9", "-N", "4", "-C", "2",
                      "--small-count", head])):
                torch.cuda.reset_peak_memory_stats(dev)
                walls[step], err, _ = _run_cli(torch, main, args, tmp)
                peaks[step] = torch.cuda.max_memory_allocated(dev)
                if step == "load-into-counting":
                    ct = os.path.join(tmp, "sc.ct")
                    got["load"] = [_file_sha256(ct)[0], _unique(err)]
                    os.remove(ct)
                elif step == "abundance-dist-single":
                    got["single"] = _file_sha256(os.path.join(
                        tmp, "sc.dist"))[0]
                elif step == "filter-abund-single":
                    got["filter_single"] = _file_sha256(os.path.join(
                        tmp, os.path.basename(head) + ".abundfilt"))[0]
                else:
                    keep = os.path.join(tmp, os.path.basename(head)
                                        + ".keep")
                    got["normalize"] = [_count(keep), _unique(err),
                                        _file_sha256(keep)[0]]
            launches = _nibble_launches(SK)
        finally:
            restore()
    want = {key: E[key] for key in got}
    expect(got == want, "phase 13b: %s, JAX gives %s" % (got, want))
    _fold_checks(checks, errs, "phase 13b")
    for name in ("nibble_update", "nibble_gather", "nibble_pertable_rows",
                 "nibble_row_counts"):
        expect(launches[name] > 0, "phase 13b: %s never launched" % name)
    nib = sum(SK.nibble_table_bytes(p)
              for p in SK.get_n_primes_near_x(4, 2e9))
    say("phase 13b --small-count at -x 2e9 -N 4 (%.3f GB of nibble tables) "
        "on phase 7b's reads: walls %s s; peak device memory %s GB; "
        "load-into-counting n_unique %d, .ct %s; abundance-dist-single "
        ".dist %s; normalize-by-median of the first %d reads kept %d "
        "(n_unique %d), filter-abund-single of them %s (the JAX answers); "
        "launches %s; every call of P, Q, R and the rows modes held to its "
        "plain version (calls %s); on %s"
        % (nib / 1e9, json.dumps({k: round(v, 6) for k, v in walls.items()}),
           json.dumps({k: round(v / 1e9, 3) for k, v in peaks.items()}),
           got["load"][1], got["load"][0][:16], got["single"][:16],
           TRACED_READS, got["normalize"][0], got["normalize"][1],
           got["filter_single"][:16], launches,
           json.dumps({k: c.calls for k, c in checks.items()}), card))
    return launches, checks


def _sectors(torch, SK, primes, hashes):
    """(distinct 32-byte sectors, distinct bytes) of the nibble tables of
    `primes` that the counters of `hashes` (1-D) lie in."""
    from khmer_tpu_torch.ops.u64 import umod

    byte = torch.cat([(umod(hashes, p) + 2 * off) >> 1 for p, off in zip(
        primes, SK.nibble_offsets(primes))]).unique()
    return int((byte >> 5).unique().numel()), int(byte.numel())


def time_nibble_kernels(torch, SK, card, errs, checks, knot_checks):
    """P, Q and R on the largest calls of their paths, against their plain
    versions (max_abs_err 0 asserted again), beside their byte bound and
    sector floor (of the sectors each loads): Q under its mask on phase
    13b's largest abundance batch, R's hashes-in entry on phase 13's
    largest (the knots', `knot_checks`), R's rows mode on 13b's largest
    normalize window and Q's rows mode on its largest filter-abund-single
    window, each hot (as issued, device) and cold (each call after a 100
    MB write that flushes L2), R and R's rows mode beside torch.take of the
    flat tables at the precomputed byte indices of the counters they load
    (the gather alone); P on its largest call into its 4 GB of tables
    zeroed before each call (scripts.reset_ms: as issued and the device
    alone), each of its passes apart (torch.profiler,
    nibble_update_bench.pass_split) and its scratch bytes beside. Returns
    the kernels-line times."""
    from khmer_tpu_torch.ops.u64 import umod
    from khmer_tpu_torch.scripts import cuda_ms, reset_ms
    from khmer_tpu_torch.scripts import nibble_update_bench as NB
    from khmer_tpu_torch.scripts import pertable_bench as PB

    out = {}
    flush = torch.empty(PB.FLUSH_BYTES, dtype=torch.uint8,
                        device=checks["nibble_gather"].largest[1][1].device)
    for key, src, what in (
            ("nibble_gather", checks, "Q (masked) on phase 13b's largest "
             "abundance batch"),
            ("nibble_pertable", knot_checks, "R on phase 13's largest call "
             "(the knots')"),
            ("nibble_pertable_rows", checks, "R's rows mode on phase 13b's "
             "largest normalize window"),
            ("nibble_row_counts", checks, "Q's rows mode on phase 13b's "
             "largest filter-abund-single window")):
        _, args, kwargs = src[key].largest
        primes, flat = args[0], args[1]
        T = len(primes)
        if key in ("nibble_gather", "nibble_pertable"):
            hashes = args[2].reshape(-1)
            mask = kwargs.get("mask")
            call_args = (primes, flat, hashes)
            n = hashes.numel()
            loaded = hashes
            in_bytes = 8 * n
            if mask is not None:
                mask = mask.reshape(-1).contiguous()
                call_args += (mask,)
                loaded = hashes[mask]
                in_bytes += n
            out_bytes = 4 * n if key == "nibble_gather" else T * n
            items = "%d hashes (%d loaded)" % (n, loaded.numel())
        else:
            codes, lengths, k = args[2], args[3], int(args[4])
            call_args = (primes, flat, codes, lengths, k)
            wh, valid, _ = SK._window_hashes(codes, lengths, k)
            loaded = wh[valid]
            n = valid.numel()
            in_bytes = codes.numel() + 4 * lengths.numel()
            out_bytes = (8 + 9 * T) * n if key == "nibble_pertable_rows" \
                else n
            items = "%d rows of %d codes, k %d, %d windows (%d valid)" % (
                codes.shape[0], codes.shape[1], k, n, loaded.numel())
            del wh, valid
        lookups = T * loaded.numel()
        sectors, nbytes = _sectors(torch, SK, primes, loaded)
        kernel = getattr(SK, key + "_cuda")
        plain = getattr(SK, key + "_plain")
        call = lambda: kernel(*call_args)
        err = _max_abs_out(torch, call(), plain(*call_args))
        errs[key] = max(errs[key], err)
        expect(err == 0, "phase 13: %s != plain on its largest call" % key)
        m = PB.readings(call, flush.zero_, lookups)
        t = {"ms": m["ms"], "plain_ms": cuda_ms(lambda: plain(*call_args),
                                                3), "library_ms": None}
        t["bound_ms"], t["bound_by"] = bound(in_bytes + out_bytes + nbytes,
                                             lookups)
        line = ""
        if key in ("nibble_pertable", "nibble_pertable_rows"):
            idx = torch.cat([(umod(loaded, p) + 2 * off) >> 1
                             for p, off in zip(primes,
                                               SK.nibble_offsets(primes))])
            take = lambda: torch.take(flat, idx)
            tm = PB.readings(take, flush.zero_, lookups)
            t["library_ms"] = tm["ms"]
            line = ("; torch.take of the flat tables at the %d precomputed "
                    "byte indices (the gather alone) %.4f ms, device %.4f "
                    "ms, cold %.4f ms (device %.4f ms)"
                    % (lookups, tm["ms"], tm["device_ms"], tm["cold_ms"],
                       tm["cold_device_ms"]))
            del idx
        say("  %s (%s into %d nibble tables of %.3f GB): hot %.4f ms as "
            "issued (device %.4f ms), cold %.4f ms (device %.4f ms), %.3g "
            "lookups/s hot on the device, plain %.4f ms; bound %.5f ms (%s), "
            "sector floor %.4f ms (%d distinct 32-B sectors)%s; == plain; "
            "on %s"
            % (what, items, T, flat.shape[0] / 1e9, m["ms"], m["device_ms"],
               m["cold_ms"], m["cold_device_ms"], m["lookups_s"],
               t["plain_ms"], t["bound_ms"], t["bound_by"],
               32 * sectors / PEAK_BYTES_S * 1e3, sectors, line, card))
        out[key] = t
    del flush
    # P last: it zeroes the tables that R's largest call may share
    _, args, kwargs = checks["nibble_update"].largest
    primes, flat, n_unique, hashes, nvalid = args[:5]
    n = int(nvalid)
    h = hashes[:n]
    sectors, nbytes = _sectors(torch, SK, primes, h)
    zero = flat.zero_
    scratch = SK.nibble_update_scratch(None, n, len(primes), flat.device)
    call = lambda: SK.nibble_update_cuda(primes, flat, n_unique, hashes, n,
                                         scratch)
    ms, _ = reset_ms(zero, call, 10, False)
    dev_ms, _ = reset_ms(zero, call, 10, True)
    # each pass's device time (torch.profiler), the tables zeroed by a
    # copy, which the split leaves out
    zeros = torch.zeros_like(flat)
    split = NB.pass_split("design", lambda: flat.copy_(zeros), call)
    del zeros
    nbuckets = SK.nibble_update_plan(n, len(primes))[0]
    flat_k = flat.clone()
    zero()
    SK.nibble_update_plain(primes, flat, n_unique.clone(), hashes, n)
    err = 0 if torch.equal(flat, flat_k) else 1
    del flat_k
    errs["nibble_update"] = max(errs["nibble_update"], err)
    expect(err == 0, "phase 13b: P != plain on its largest call")
    plain_ms, _ = reset_ms(zero, lambda: SK.nibble_update_plain(
        primes, flat, n_unique.clone(), hashes, n), 3, False)
    t = {"ms": ms, "plain_ms": plain_ms, "library_ms": None}
    t["bound_ms"], t["bound_by"] = bound(8 * n + 2 * nbytes,
                                         n * len(primes))
    floor = 2 * 32 * sectors / PEAK_BYTES_S * 1e3
    say("  phase 13b P on its largest call (%d events into %d nibble tables "
        "of %.3f GB, zeroed before each call): %.4f ms as issued, device "
        "%.4f ms, plain %.4f ms; its passes on the device (torch.profiler, "
        "ms a call) %s; scratch %d B (sketch_kernels.nibble_update_plan: "
        "%d buckets, %d in use); bound %.5f ms (%s: 8 B a hash, each of its "
        "%d distinct table bytes read and written), sector floor %.4f ms "
        "(%d distinct 32-B sectors read and written); == plain; on %s"
        % (n, len(primes), flat.shape[0] / 1e9, ms, dev_ms, plain_ms,
           json.dumps({k: (round(v, 5) if isinstance(v, float) else v)
                       for k, v in split.items()}),
           SK.nibble_update_plan(n, len(primes))[2], nbuckets,
           SK.nibble_buckets(flat.shape[0], nbuckets)[1], t["bound_ms"],
           t["bound_by"], nbytes, floor, sectors, card))
    out["nibble_update"] = t
    return out


# ---------------------------------------------------------------------------
# phases 14 and 14b: the sketch family (kernel S, kernel N's nibble mode)
# ---------------------------------------------------------------------------


def run_family_cases(torch, dev, errs):
    """Kernel S and N's nibble mode against their plain versions on the
    cases of scripts/family_cases.py."""
    from khmer_tpu_torch.scripts import family_cases as F

    for name in F.FILTER_CASES:
        err = F.check_filter_case(name, dev)
        errs["consume_filter"] = max(errs["consume_filter"], err)
        expect(err == 0, "consume_filter != plain on case %s" % name)
    for name in F.NIBBLE_NBR_CASES:
        err = F.check_nibble_nbr_case(name, dev)
        for key in ("nibble_neighbors", "nibble_neighbors_small"):
            errs[key] = max(errs[key], err)
        expect(err == 0, "nibble_neighbors != plain on case %s" % name)
    torch.cuda.empty_cache()
    say("  family cases: consume_filter (kept hashes in order, their count) "
        "on %d cases and nibble_neighbors in both modes (presence and band "
        "bytes at %d bands) on %d == plain"
        % (len(F.FILTER_CASES), len(F.NIBBLE_BANDS) + 1,
           len(F.NIBBLE_NBR_CASES)))
    return len(F.FILTER_CASES) + len(F.NIBBLE_NBR_CASES)


# The tables of phases 14 and 14b, each class with the -x of its layout:
# phase 14's four tables of 25 MB (phase 13's nibble size; the blocked
# table holds the same 100 MB), phase 14b's of 1 GB.
FAMILY_X = {"Counttable": 2.5e7, "SmallCounttable": 5e7, "Nodetable": 2e8,
            "BlockedCounttable": 2.5e7, "CyclicCounttable": 2.5e7,
            "Nodegraph": 2e8, "Countgraph": 2.5e7, "SmallCountgraph": 5e7}
FAMILY_SCALE_X = {"Counttable": 1e9, "SmallCounttable": 2e9,
                  "Nodegraph": 8e9, "Countgraph": 1e9,
                  "SmallCountgraph": 2e9}
FAMILY_READS = 100  # the reads whose count ops phase 14 asserts
STAMPS_MASK_READS = 100_000  # phase 14's mask: the first half of the reads


class PortFamily:
    """The port's side of phases 14 and 14b: its classes made on the card,
    its loaders, its batched sweep and its tables' bytes. Another object
    with the same methods over the JAX package's classes (on the CPU)
    gives EXPECT_C14 from the same steps (family_steps,
    family_scale_steps)."""

    def __init__(self, dev):
        self.dev = dev

    def make(self, name, k, x, n):
        import khmer_tpu_torch as T

        return getattr(T, name)(k, x, n, device=self.dev)

    def load(self, name, path):
        import khmer_tpu_torch as T

        if name in ("Counttable", "SmallCounttable"):
            return T.load_counttable(path, small=name.startswith("Small"),
                                     device=self.dev)
        if name == "Nodetable":
            return T.load_nodetable(path, device=self.dev)
        return getattr(T, name).load(path, device=self.dev)

    def sweep(self, graph, seqs, sweep_range):
        from khmer_tpu_torch.core import partition as P

        return [set(int(t) for t in f) for f in P.sweep_for_tags_batch(
            graph, seqs, sweep_range)[0]]

    def tables(self, sketch):
        """The tables' bytes, one buffer each."""
        return [t.cpu().numpy() for t in sketch.tables]


def _tables_sha256(tables):
    h = hashlib.sha256()
    for t in tables:
        h.update(memoryview(t).cast("B"))
    return h.hexdigest()


def _json_sha256(value):
    return hashlib.sha256(json.dumps(value).encode()).hexdigest()


def _ints(pair):
    return [int(v) for v in pair]


def write_head(src, dst, n):
    """The first n records of a FASTA file (two lines each) into dst."""
    import gzip

    opener = gzip.open if src.endswith(".gz") else open
    with opener(src, "rt") as f, open(dst, "w") as out:
        for _ in range(2 * n):
            out.write(f.readline())
    return dst


def family_steps(fam, tmp, step=lambda name, fn: fn()):
    """Phase 14's steps through `fam` (PortFamily, or the same over the JAX
    package): the five tables consume data/25k.fq.gz (their reads and
    k-mers, n_unique, n_occupied, the saved file's sha256, which the
    loader reads back to the same tables, and the sha256 of the count ops
    of the first FAMILY_READS reads); a Countgraph consumes the stamps
    reads under a Nodegraph mask of their first half at threshold 0, both
    ways; a Counttable consumes data/25k.fq.gz in four bands and a band of
    the stamps reads under the mask; a SmallCountgraph tags the stamps
    reads, partitions them with and without the band (2, 14) (the big
    traversals cut) and sweeps its first 1,000 reads at 81. `step(name,
    fn)` runs each step (the port's phase times them). Returns the
    answers."""
    from khmer_tpu_torch.io.fastx import FastxParser

    got = {}
    path = lambda name: os.path.join(tmp, name)
    firsts = [r.cleaned_seq for _, r in zip(range(FAMILY_READS),
                                            FastxParser(DATA))]
    for name in ("Counttable", "SmallCounttable", "Nodetable",
                 "BlockedCounttable", "CyclicCounttable"):
        t = fam.make(name, K, FAMILY_X[name], 4)
        n = step(name, lambda: t.consume_seqfile(DATA))
        t.save(path(name))
        back = fam.load(name, path(name))
        expect(_tables_sha256(fam.tables(back))
               == _tables_sha256(fam.tables(t)), "phase 14: %s loads back "
               "other tables" % name)
        ops = [[[int(c) for c in t.get_kmer_counts(s)],
                [int(p) for p in t.find_spectral_error_positions(s, 2)],
                int(t.trim_below_abundance(s, 2)[1])] for s in firsts]
        got[name] = [_ints(n), int(t.n_unique_kmers()), int(t.n_occupied()),
                     _file_sha256(path(name))[0], _json_sha256(ops)]
        del t, back
    head = write_head(STAMPS, path("stamps-head.fa"), STAMPS_MASK_READS)
    mask = fam.make("Nodegraph", K, FAMILY_X["Nodegraph"], 4)
    mask.consume_seqfile(head)
    for masked in (False, True):
        g = fam.make("Countgraph", K, FAMILY_X["Countgraph"], 4)
        key = "masked" if masked else "unmasked"
        n = step("Countgraph " + key, lambda: g.consume_seqfile_with_mask(
            STAMPS, mask, 0, masked))
        g.save(path("masked.ct"))
        got["mask " + key] = [_ints(n), int(g.n_unique_kmers()),
                              _file_sha256(path("masked.ct"))[0]]
        del g
    ct = fam.make("Counttable", K, FAMILY_X["Counttable"], 4)
    got["bands"] = [step("band %d" % b, lambda: _ints(
        ct.consume_seqfile_banding(DATA, 4, b))) for b in range(4)]
    ct.save(path("bands.ct"))
    got["bands"].append(_file_sha256(path("bands.ct"))[0])
    ct = fam.make("Counttable", K, FAMILY_X["Counttable"], 4)
    n = step("band and mask", lambda: ct.consume_seqfile_banding_with_mask(
        STAMPS, 4, 1, mask, 0))
    ct.save(path("band-mask.ct"))
    got["band mask"] = [_ints(n), int(ct.n_unique_kmers()),
                        _file_sha256(path("band-mask.ct"))[0]]
    del ct, mask
    g = fam.make("SmallCountgraph", K, FAMILY_X["SmallCountgraph"], 4)
    n = step("tagged consume", lambda: g.consume_seqfile_and_tag(STAMPS))
    g.save(path("g.ct"))
    g.save_tagset(path("g.tagset"))
    got["graph"] = [_ints(n), int(g.n_unique_kmers()), int(g.n_tags()),
                    _file_sha256(path("g.tagset"))[0],
                    _file_sha256(path("g.ct"))[0]]
    for key, call in (
            ("partition", lambda: g.do_subset_partition(
                0, 0, stop_big_traversals=True)),
            ("abundance", lambda: g.do_subset_partition_with_abundance(
                2, 14, stop_big_traversals=True))):
        subset = step(key, call)
        subset.save_partitionmap(path(key + ".pmap"))
        got[key] = [[int(v) for v in subset.count_partitions()],
                    _file_sha256(path(key + ".pmap"))[0]]
    seqs = [r.sequence for _, r in zip(range(1000), FastxParser(STAMPS))]
    found = step("sweep 81", lambda: fam.sweep(g, seqs, 81))
    got["sweep 81"] = [sum(map(len, found)), _tag_lists_sha256(found)]
    return got


def family_scale_steps(fam, reads, head, step=lambda name, fn: fn()):
    """Phase 14b's steps through `fam` on phase 7b's reads, each table of
    FAMILY_SCALE_X (4 x 1 GB): a Counttable and a SmallCounttable consume
    them (reads and k-mers, n_unique, n_occupied, the tables' sha256); a
    Countgraph consumes them under a Nodegraph mask of their first
    250,000 (`head`) at threshold 0; a SmallCountgraph tags them and
    partitions every tag in the band (2, 14), the big traversals cut.
    Returns the answers."""
    got = {}
    for name in ("Counttable", "SmallCounttable"):
        t = fam.make(name, K, FAMILY_SCALE_X[name], 4)
        n = step(name, lambda: t.consume_seqfile(reads))
        got[name] = [_ints(n), int(t.n_unique_kmers()), int(t.n_occupied()),
                     _tables_sha256(fam.tables(t))]
        del t
    mask = fam.make("Nodegraph", K, FAMILY_SCALE_X["Nodegraph"], 4)
    step("mask", lambda: mask.consume_seqfile(head))
    g = fam.make("Countgraph", K, FAMILY_SCALE_X["Countgraph"], 4)
    n = step("masked consume", lambda: g.consume_seqfile_with_mask(
        reads, mask, 0))
    got["mask"] = [_ints(n), int(g.n_unique_kmers()),
                   _tables_sha256(fam.tables(g))]
    del g, mask
    g = fam.make("SmallCountgraph", K, FAMILY_SCALE_X["SmallCountgraph"], 4)
    n = step("tagged consume", lambda: g.consume_seqfile_and_tag(reads))
    got["graph"] = [_ints(n), int(g.n_unique_kmers()), int(g.n_tags()),
                    _json_sha256(sorted(int(t) for t in g.all_tags))]
    subset = step("abundance", lambda: g.do_subset_partition_with_abundance(
        2, 14, stop_big_traversals=True))
    got["abundance"] = [[int(v) for v in subset.count_partitions()],
                        _json_sha256(sorted(
                            [int(t), int(subset.get_partition_id(t))]
                            for t in g.all_tags))]
    return got


def _check_filter(torch, SK):
    """Kernel S held to consume_filter_plain on the same inputs: the
    count's difference, else the kept hashes that differ. check.best
    keeps the arguments of the call with the most events, and of those
    the one that kept the most (S's timed call)."""
    best = {}

    def check(fn, args, kwargs):
        got = fn(*args, **kwargs)
        want = SK.consume_filter_plain(*args, **kwargs)
        m = int(want[1][0])
        err = abs(int(got[1][0]) - m)
        if err == 0:
            err = int((got[0][:m] != want[0][:m]).sum())
        key = (int(args[1]), m)
        if not best or key > best["key"]:
            best.update(key=key, args=args, kwargs=kwargs)
        return got, err, int(args[1])
    check.best = best
    return check


def _check_bit_gather(SK):
    def check(fn, args, kwargs):
        got = fn(*args, **kwargs)
        return got, _max_abs(got, SK.bit_gather_plain(*args)), got.numel()
    return check


def _family_checks(torch, SK, every_probe, max_check=1 << 21,
                   mask_gather=False):
    """S (SK.consume_filter, every call, by _CallCheck) and N's nibble mode
    (a level tap on the walks' C++ loop, every `every_probe`-th level, the
    largest level and the largest below SK.NBR_SMALL_NODES kept); with
    `mask_gather`, L's gather mode too (SK.bit_gather: a Nodegraph mask's
    counts), every call, its largest kept for timing."""
    from khmer_tpu_torch.scripts.level_tap import LevelTap

    checks = {"consume_filter": _CallCheck(torch, SK, "consume_filter",
                                           _check_filter(torch, SK),
                                           lambda a: int(a[1])),
              "nibble_neighbors": LevelTap("nibble", every_probe, None,
                                           max_check, SK.NBR_SMALL_NODES)}
    if mask_gather:
        checks["bit_gather"] = _CallCheck(torch, SK, "bit_gather",
                                          _check_bit_gather(SK),
                                          lambda a: a[2].numel())
    return checks


FAMILY_KERNELS = ("consume_filter", "nibble_neighbors",
                  "nibble_neighbors_small", "nibble_update", "nibble_gather",
                  "byte_update", "byte_gather", "bit_update", "bit_gather",
                  "blocked_update", "blocked_gather")


def _family_launches(SK, B, zero=False):
    """The launch counts of the family's path (set to 0 with `zero`)."""
    owners = {"consume_filter": (SK.consume_filter_cuda, "launches"),
              "nibble_neighbors": (SK.nibble_neighbors_cuda, "launches"),
              "nibble_neighbors_small": (SK.nibble_neighbors_cuda,
                                         "small_launches"),
              "nibble_update": (SK.nibble_update_cuda, "launches"),
              "nibble_gather": (SK.nibble_gather_cuda, "launches"),
              "byte_update": (SK.byte_update_cuda, "launches"),
              "byte_gather": (SK.byte_gather_cuda, "launches"),
              "bit_update": (SK.bit_update_cuda, "launches"),
              "bit_gather": (SK.bit_gather_cuda, "launches"),
              "blocked_update": (B.blocked_update_cuda, "launches"),
              "blocked_gather": (B.blocked_gather_cuda, "launches")}
    if zero:
        for owner, attr in owners.values():
            setattr(owner, attr, 0)
    return {key: getattr(owner, attr) for key, (owner, attr) in
            owners.items()}


def _family_expect(label, checks, errs):
    for name, c in checks.items():
        keys = {"nibble_neighbors": ["nibble_neighbors",
                                     "nibble_neighbors_small"],
                "bit_gather": ["neighbors"]}.get(name, [name])
        expect(c.err == 0, "%s: %s differs from plain by up to %d over its "
               "%d values" % (label, name, c.err, c.checked))
        expect(c.calls > 0 and c.checked > 0, "%s: %s was not held to its "
               "plain version" % (label, name))
        for key in keys:
            errs[key] = max(errs[key], c.err)


def run_family(torch, SK, B, dev, card, errs):
    """Phase 14: the sketch family on the card through the port's entry
    points (family_steps on PortFamily), the JAX answers (EXPECT_C14)
    asserted; every call of S and every level of N's nibble mode held to
    its plain version; the launch counts set to 0 before the first step
    and read after the last, each kernel of the path launched (S, N's
    nibble mode in both its modes, P, Q, A, B, J, L's gather, 1 and 2); N
    launched once a level; each step's wall. Returns (launches,
    checks)."""
    E = EXPECT_C14
    checks = _family_checks(torch, SK, 1, max_check=1 << 23)
    tap = checks["nibble_neighbors"]
    walls, checked = {}, {}
    step = lambda name, fn: _timed_step(torch, fn, checks, walls, checked,
                                        name)
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_",
                                     dir=REPO) as tmp:
        restore = _install(checks)
        try:
            _family_launches(SK, B, zero=True)
            got = family_steps(PortFamily(dev), tmp, step)
            launches = _family_launches(SK, B)
        finally:
            restore()
    want = {key: E[key] for key in got}
    expect(got == want, "phase 14: %s, JAX gives %s" % (got, want))
    expect(got["bands"][-1] == got["Counttable"][3], "phase 14: the four "
           "bands' table differs from the full consume's")
    expect(sum(b[1] for b in got["bands"][:4]) == got["Counttable"][0][1],
           "phase 14: the bands' k-mers do not sum to the full consume's")
    _family_expect("phase 14", checks, errs)
    for name in FAMILY_KERNELS:
        expect(launches[name] > 0, "phase 14: %s never launched" % name)
    expect(launches["nibble_neighbors"] + launches["nibble_neighbors_small"]
           == tap.calls, "phase 14: N's nibble mode launched %d times on %d "
           "levels" % (launches["nibble_neighbors"]
                       + launches["nibble_neighbors_small"], tap.calls))
    say("phase 14 the sketch family at 4 x 25 MB tables: Counttable, "
        "SmallCounttable, Nodetable, BlockedCounttable and CyclicCounttable "
        "on data/25k.fq.gz (n_unique %s); a Countgraph under a Nodegraph "
        "mask of the first %d stamps reads (k-mers %d and %d); four bands "
        "(k-mers %s) whose table is the full consume's; a band under the "
        "mask (%d); SmallCountgraph(20, 5e7, 4) on the stamps reads: %s, "
        "partitions %s, with abundance (2, 14) %s, sweeps of 1,000 reads "
        "at 81 found %d tags (the JAX answers); walls (s) %s, of which the "
        "plain versions' checks took %s; S held to plain on %d calls, N's "
        "nibble mode on %d levels (%d nodes); launches %s; on %s"
        % ({k: got[k][1] for k in ("Counttable", "SmallCounttable",
                                   "Nodetable", "BlockedCounttable",
                                   "CyclicCounttable")},
           STAMPS_MASK_READS, got["mask unmasked"][0][1],
           got["mask masked"][0][1], [b[1] for b in got["bands"][:4]],
           got["band mask"][0][1], got["graph"][:3], got["partition"][0],
           got["abundance"][0], got["sweep 81"][0],
           {k: round(v, 6) for k, v in walls.items()},
           {k: round(v, 6) for k, v in checked.items() if v},
           checks["consume_filter"].calls, tap.calls, tap.checked,
           launches, card))
    say(json.dumps({"phase": "14", "walls_s": walls, "checks_s": checked,
                    "card": card}))
    return launches, checks


def run_family_scale(torch, SK, B, dev, card, errs, reads, head):
    """Phase 14b: family_scale_steps on the card at 4 GB of tables a
    step, the JAX answers (EXPECT_C14["synth"], from JAX's auto engine on
    the CPU) asserted; every call of S held to its plain version and every
    8th level of N's nibble mode; each step's wall and the device memory
    it peaked at. Returns (launches, checks)."""
    E = EXPECT_C14["synth"]
    checks = _family_checks(torch, SK, 8, mask_gather=True)
    tap = checks["nibble_neighbors"]
    walls, checked, peaks = {}, {}, {}

    def step(name, fn):
        torch.cuda.reset_peak_memory_stats(dev)
        out = _timed_step(torch, fn, checks, walls, checked, name)
        peaks[name] = torch.cuda.max_memory_allocated(dev)
        return out
    restore = _install(checks)
    try:
        _family_launches(SK, B, zero=True)
        got = family_scale_steps(PortFamily(dev), reads, head, step)
        launches = _family_launches(SK, B)
    finally:
        restore()
    torch.cuda.empty_cache()
    want = {key: E[key] for key in got}
    expect(got == want, "phase 14b: %s, JAX gives %s" % (got, want))
    _family_expect("phase 14b", checks, errs)
    for name in ("consume_filter", "nibble_neighbors", "nibble_update",
                 "byte_update", "bit_update", "bit_gather"):
        expect(launches[name] > 0, "phase 14b: %s never launched" % name)
    say("phase 14b the sketch family at 4 GB of tables on phase 7b's reads: "
        "Counttable(20, 1e9, 4) n_unique %d, SmallCounttable(20, 2e9, 4) "
        "%d; Countgraph(20, 1e9, 4) under a Nodegraph(20, 8e9, 4) mask of "
        "the first %d reads: k-mers %d, n_unique %d; SmallCountgraph(20, "
        "2e9, 4): %s, abundance (2, 14) partitions %s (the JAX answers); "
        "walls (s) %s, of which the plain versions' checks took %s; peak "
        "device memory (GB) %s; S held to plain on %d calls, N's nibble "
        "mode on %d of %d levels (%d nodes); launches %s; on %s"
        % (got["Counttable"][1], got["SmallCounttable"][1], TRACED_READS,
           got["mask"][0][1], got["mask"][1], got["graph"][:3],
           got["abundance"][0], {k: round(v, 6) for k, v in walls.items()},
           {k: round(v, 6) for k, v in checked.items() if v},
           {k: round(v / 1e9, 3) for k, v in peaks.items()},
           checks["consume_filter"].calls,
           -(-tap.calls // tap.every), tap.calls, tap.checked, launches,
           card))
    say(json.dumps({"phase": "14b", "walls_s": walls, "checks_s": checked,
                    "peak_bytes": peaks, "card": card}))
    return launches, checks


def _nibble_sectors(torch, SK, primes, hashes):
    """Distinct 32-byte sectors of the nibble tables of `primes` that the
    counters of `hashes` (any shape) lie in, every table."""
    from khmer_tpu_torch.ops.u64 import umod

    h = hashes.reshape(-1)
    byte = torch.cat([(umod(h, p) + 2 * off) >> 1 for p, off in zip(
        primes, SK.nibble_offsets(primes))])
    return int((byte >> 5).unique().numel())


def time_consume_filter(torch, SK, card, errs, checks):
    """S on 14b's largest call (the masked consume's chunk of 2^20 hashes
    with its mask's counts that keeps the most) against its plain version,
    beside its bound, torch.masked_select of the same keep mask (the
    library yardstick) and the host's read of its count (the update takes
    it as an int: one sync a chunk); the mask's gather on its largest call
    beside its sector floor. Returns S's kernels-line times."""
    from khmer_tpu_torch.scripts import cuda_ms, device_ms
    from khmer_tpu_torch.ops.u64 import umod

    out = {}
    best = checks["consume_filter"].check.best
    args, kwargs = best["args"], best["kwargs"]
    hashes, nvalid, band, counts, threshold, at_least = args
    n = hashes.shape[0]
    call = lambda: SK.consume_filter_cuda(*args, **kwargs)
    plain = lambda: SK.consume_filter_plain(*args, **kwargs)
    got, want = call(), plain()
    kept = int(want[1][0])
    err = abs(int(got[1][0]) - kept) or int(
        (got[0][:kept] != want[0][:kept]).sum())
    errs["consume_filter"] = max(errs["consume_filter"], err)
    expect(err == 0, "phase 14b: S != plain on its largest call")
    keep = SK.consume_filter_keep(*args, **kwargs)
    library = lambda: torch.masked_select(hashes, keep)
    t = {"ms": cuda_ms(call, 50), "plain_ms": cuda_ms(plain, 5),
         "library_ms": cuda_ms(library, 50)}
    nbytes = 8 * n + (4 * n if counts is not None else 0) + 8 * kept
    t["bound_ms"], t["bound_by"] = bound(nbytes, 0)
    dev_ms = device_ms(call, 50)

    def with_sync():
        _, c = call()
        return int(c[0])
    host_ms = cuda_ms(with_sync, 50)
    # the mask's gather (L's gather mode on the Nodegraph mask) on its
    # largest call, beside the sector floor of the mask's bits it reads
    _, gargs, _ = checks["bit_gather"].largest
    gprimes, gflat, ghashes = gargs
    gather = lambda: SK.bit_gather_cuda(gprimes, gflat, ghashes)
    expect(_max_abs(gather(), SK.bit_gather_plain(*gargs)) == 0,
           "phase 14b: L's gather mode != plain on the mask's largest call")
    gsectors = int(torch.cat([(umod(ghashes, p) + 8 * off) >> 8 for p, off
                              in zip(gprimes, SK.bit_offsets(gprimes))])
                   .unique().numel())
    gfloor = gsectors * 32 / PEAK_BYTES_S * 1e3
    gather_ms, gather_dev = cuda_ms(gather, 50), device_ms(gather, 50)
    say("  phase 14b S on its largest call (%d hashes, %d kept, band %s, "
        "mask counts %s): %.4f ms as issued (device %.4f ms), with the "
        "host's read of its count (the update's int: a sync a chunk) %.4f "
        "ms; plain %.4f ms; torch.masked_select of the same keep mask %.4f "
        "ms; bound %.5f ms (%s: 8 B a hash in%s, 8 B a kept hash out); the "
        "mask's counts, L's gather mode on its largest call (%d hashes "
        "into %d bit tables of %.3f GB), %.4f ms as issued (device %.4f "
        "ms), its sector floor %.4f ms (%d distinct 32-B sectors); the "
        "filter's path (8 B a hash in, 8 B a kept hash out, and the mask's "
        "sector floor) %.4f ms; == plain; on %s"
        % (n, kept, band is not None, counts is not None, t["ms"], dev_ms,
           host_ms, t["plain_ms"], t["library_ms"], t["bound_ms"],
           t["bound_by"], ", 4 B a count in" if counts is not None else "",
           ghashes.numel(), len(gprimes), gflat.shape[0] / 1e9, gather_ms,
           gather_dev, gfloor, gsectors,
           (8 * n + 8 * kept) / PEAK_BYTES_S * 1e3 + gfloor, card))
    out["consume_filter"] = t
    return out


def time_neighbor_probe(torch, SK, card, errs, tap, label, layout, what,
                        plain_fn, cuda_fn, floors_fn):
    """One layout's mode of N (`what`, on `layout` tables: the wrappers
    plain_fn(primes, flat, f, r, k, prober) and cuda_fn(..., small)) on the
    largest level of a phase's walks (`tap`, its level tap) and on its
    largest below SK.NBR_SMALL_NODES, each in both its modes (staged,
    small-level) with the walk's band, held to plain and timed hot and cold
    (each call after a write of 100 MB that flushes L2,
    pertable_bench.readings), beside its bound and the sector floors that
    floors_fn(primes, flat, f, r, k) describes. Returns the kernels-line
    times {"<layout>_neighbors[_small]": its time cold, as issued, on the
    largest level the walk runs in that mode}."""
    from khmer_tpu_torch.scripts import cuda_ms
    from khmer_tpu_torch.scripts import pertable_bench as PB

    out = {}
    picks = [("largest", tap.largest)]
    if tap.largest_below is not None \
            and tap.largest_below[0].shape[0] != tap.largest[0].shape[0]:
        picks.append(("largest below %d nodes" % SK.NBR_SMALL_NODES,
                      tap.largest_below))
    scratch = torch.empty(PB.FLUSH_BYTES, dtype=torch.uint8,
                          device=tap.largest[0].device)
    for which, (f, r, prober) in picks:
        g = prober.graph
        primes, flat, k = g._primes, g.tables.flat, g.ksize()
        band = prober.band
        n = f.shape[0]
        floors = floors_fn(primes, flat, f, r, k)
        plain = lambda: plain_fn(primes, flat, f, r, k, prober)
        want = plain()
        plain_ms = cuda_ms(plain, 3)
        for small in (False, True):
            key = "%s_neighbors%s" % (layout, "_small" if small else "")
            call = lambda: cuda_fn(primes, flat, f, r, k, prober, small)
            err = max(_max_abs(a, b) for a, b in _pairs(call(), want))
            errs[key] = max(errs[key], err)
            expect(err == 0, "%s: %s (%s) != plain on its %s level"
                   % (label, what, key, which))
            m = PB.readings(call, scratch.zero_, 8 * n)
            t = {"ms": m["cold_ms"], "plain_ms": plain_ms,
                 "library_ms": None}
            t["bound_ms"], t["bound_by"] = bound(
                (16 + (1 if band is None else 2)) * n, 8 * len(primes) * n)
            walks_mode = small == (n < SK.NBR_SMALL_NODES)
            say("  %s %s in its %s mode%s on the %s level (%d nodes, %s) "
                "into %d %s tables of %.3f GB: hot %.4f ms as issued "
                "(device %.4f ms), cold %.4f ms as issued (device %.4f ms, "
                "%.3f ns a node), plain %.4f ms, bound %.4f ms (%s); %s; "
                "== plain; on %s"
                % (label, what, "small-level" if small else "staged",
                   " (the walk's)" if walks_mode else "", which, n,
                   "band %s" % (band,) if band else "presence",
                   len(primes), layout, flat.shape[0] / 1e9, m["ms"],
                   m["device_ms"], m["cold_ms"], m["cold_device_ms"],
                   m["cold_device_ms"] * 1e6 / max(n, 1), plain_ms,
                   t["bound_ms"], t["bound_by"], floors, card))
            if walks_mode and key not in out:
                out[key] = t
    del scratch
    return out


def time_nibble_neighbors(torch, SK, card, errs, tap, label):
    """N's nibble mode, as time_neighbor_probe times it, beside the sector
    floor of every table of every neighbour."""
    def floors(primes, flat, f, r, k):
        nf, nr = SK.neighbor_kmers(f, r, k)
        sectors = _nibble_sectors(torch, SK, primes, SK.umin(nf, nr))
        return ("sector floor (every table of every neighbour, 32 B a "
                "distinct sector) %.4f ms (%d sectors)"
                % (sectors * 32 / PEAK_BYTES_S * 1e3, sectors))

    return time_neighbor_probe(
        torch, SK, card, errs, tap, label, "nibble", "N's nibble mode",
        lambda p, fl, f, r, k, pr: SK.nibble_neighbors_plain(
            p, fl, f, r, k, pr.band),
        lambda p, fl, f, r, k, pr, small: SK.nibble_neighbors_cuda(
            p, fl, f, r, k, pr.band, small),
        floors)

if __name__ == "__main__":
    sys.exit(main())
