#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (bbtools_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--reads N] [--pairs N] [--seed S]

From the root of a checkout, on a machine with a CUDA card:

  1. prints the card (nvidia-smi name and power limit) and versions;
  2. builds the CUDA kernels from bbtools_torch/csrc with nvcc (one
     compiler per source, in parallel), while it makes the inputs;
  3. holds each kernel against its plain PyTorch version on the card at
     the main path's shapes (exact equality), and times both with CUDA
     events: B1 lane_lookup and B2 cummax_i64 (BBDuk), B3 mm_lookup (the
     matcher configuration's index, on the full-k and short-k end keys
     the BBDuk scans send it for one batch), B5 overlap_scan and B6
     lane_table (one BBMerge batch), B4 msa_fill (BBMap's fill with
     traceback planes: window class 0 of one real 4,096-read batch, class
     3 of that batch, 4,096 synthetic tasks of mixed lengths at R=250,
     and 4,096 long-read tasks at R=400, those past 256 rows taking
     the band kernel, and mapPacBio's widest class, the band kernel's;
     plane bytes compared on live cells; the band kernel at each K and
     progress step; the warp, band and block kernels timed against each
     other at 256-2,048 tasks, the band and block kernels on few-task
     calls); each kernel's row
     carries its bound (bytes over the memory rate or operations over
     the card's rate for their type, the larger; B4's operations are the
     SASS instructions of its diagonal loop, counted with cuobjdump, over
     the live cells) and the time of one PyTorch call computing the same
     function where there is one; kernels of microseconds (B1, B2, B5,
     B6) and their library calls are timed in a CUDA graph, so the time
     is the card's and not the wrapper's; B2 (one pass) in turns with the
     first port's three-pass kernel and torch.cummax, and on random
     inputs up to 5,000,003 elements; B5 (bit-sliced) in turns with the
     first port's byte kernel, on codes
     drawn from 0..255, with the SASS of its word loops counted with
     cuobjdump for its bound; B1 (the 1-adapter table, packed
     and unpacked, in shared memory, and a table at LaneKmerIndex.build's cost
     cap, probed in L2) and B4 are timed in turns with the kernels they
     replace (kept as measurement variants); B3 is
     also timed, on the same keys and in turns, as the original dp4a
     kernel, with a max-only and a one-column epilogue (the product
     alone) and at half its query tile; B6, its original kernel and
     `table[idx]` are timed in turns in a graph on the same indices
     (L2-warm) and cycling through copies of them that overflow the L2
     (cold, the time its HBM bound is held against);
  4. drives each path through the CLI entry point on device=cuda with
     every launch counter set to 0 just before it and read just after:
     `bbduk` over a seeded gzipped FASTQ of N reads (200,000 by
     default) at ref=adapters hdist=1 (sorted join, B2) and on one
     literal adapter (lane table, B1); `bbduk` on the matcher backend
     (ref=adapters,phix k=23 mink=11 hdist=2, B3) over 50,000 of those
     reads, with its index build timed on its own line; a paired `bbduk
     tbo tpe` over 50,000 seeded interleaved pairs (B1, B5, B6); and `bbmerge`
     over a seeded pair of gzipped FASTQ files of N pairs (150,000 by
     default; B5, B6); `bbmap` (B4) against a seeded genome of E. coli
     K-12's length (4,641,652 bp) over 20,000 reads of 151 bp and over
     4,000 pairs, with reads/s, pairs/s, the index build, the mapped
     share, the B4 launches and the batches that overflowed the fused
     phase's walk cap on lines of their own;
  5. BASELINE configs #2 and #5 on one seeded data set (a 1,000,000 bp
     genome, a copy with planted SNPs and indels, 200,000 reads of 150 bp
     of the copy with 0.5% errors), through the CLI on device=cuda, each
     with the device routes of its counts required on the card
     (DeviceSpectrum's merges, count_batch's sort-reduce, the W-word
     sort): `kmercountexact k=31 khist= peaks=` over the reads (reads/s,
     unique k-mers, the spectrum's capacity, the main peak, held near
     the k-mer depth the coverage and error rate give), `kmercountexact
     k=93` over 50,000 of them, `tadpole k=62` over the reads of the
     copy's first 25,000 bp (its load and its host walk on lines of
     their own; contigs, N50, and the share of the region's 31-mers the
     contigs hold), Tadpole k=62's load (`Tadpole.load_kmers`) over all
     200,000 reads (reads/s; the 62-mers seen 3 or more times held near
     the genome's), then `bbmap` (B4) over 50,000 reads against the
     genome and `callvariants` on its SAM, with defaults and realign=t
     (variants called, recall of the planted SNPs and indels, false
     calls, reads realigned);
  6. runs every path but the matcher's on its first 10,000 reads (pairs)
     on device=cuda and device=cpu and requires byte-equal output files
     (the matcher's CUDA-against-CPU equality is held by the CPU tests);
     `bbmap` on its first 256 reads and 128 pairs; kmercountexact
     k=31 and k=93 (khist, peaks, dump) on 10,000 reads, Tadpole k=62
     on the region's reads and mode=correct on 500 of them, CallVariants
     realign=t and nn=t on 4,096 records of config #5's SAM, those with
     an indel soft-clipped from it on (realign=t: the same reads, at
     least one, realigned on both devices; nn=t equal but for a last
     QUAL digit that float32 rounding may flip, counted);
  7. the A6b tools through the CLI on device=cuda, each with its kernels
     or its device routes required: `tadpipe` at TadPipe's defaults
     (k=31,62,93, every stage) on 1,250 pairs of config #5's copy's
     first 25,000 bp (each stage's seconds, the recommended k, the
     contigs and their share of the region's 31-mers), its trim stage
     (`bbduk ref=adapters ... tbo tpe qtrim=r`) and ecco stage (`bbmerge
     ecco=t mix=t strict`) over 25,000 pairs of the whole copy, `bbmerge
     nn=t` over 25,000 of the smoke's pairs, `bbcms ecc=f mincount=2 hcf=0.5` over
     config #2's 200,000 reads (one add of a batch timed alone) and with
     ecc=t on 250 of the region's reads, `bbmap bloomfilter=t` over
     20,000 map reads and 2,000 foreign ones, and `bbrealign` on the
     clipped SAM; then each on both devices, byte for byte (BBMerge nn=t
     but for pairs whose net score lay within 1e-5 of the cutoff);
  8. the A2/A5 and A4b paths through the CLI on device=cuda:
     calctruequality on BBMap's SAM; `mappacbio` over one batch of 64
     FASTA records on the E. coli-length genome (51 long reads of
     1,000-6,000 bp, 13 of 6,100-12,000 bp that fastareadlen=6000 cuts
     in two: 26 chunk records), printing reads/s, the mapped share
     and the share placed within 50 bp, B4's launches, the fused phase's
     walk-cap overflows, the plane groups and the walk's seconds; then
     `bbmapskimmer` on the first 16 of them (its flag-256 lines) and `gradesam`
     on mapPacBio's SAM; B4's block kernel at mapPacBio's widest class
     (4 tasks, R=6,000, Cc=13,640) against its plain version, in the
     kernel phase; `bbduk` config #1 with align=t over its reads with one
     in ten replaced by phiX (the side SAM's mapped count within 1% of
     the planted, every planted read kept in out=); `bbduk
     recalibrate=t`; `bbmap` with covstats= basecov= covhist= bincov=,
     then `pileup` on its SAM (the files byte-equal); `bbsplit` (the
     genome and a second seeded one), `bbwrap` over two inputs with one
     index build, and `removehuman ref=`; then each on both devices,
     byte for byte, at a small size (coverage and bbsplit against 250 kb
     of each genome);
  9. the A8a tools through the CLI on device=cuda, each with its device
     route counted on the card: `seal k=31` against six references (the
     genome cut in four files, the second genome, phiX) over config #1's
     reads with phiX planted (phiX's count the planted one), `bbnorm
     k=31 target=10 mindepth=5` over config #2's reads (the kept share
     near the target over the 31-mer depth), `ecc` over config #5's
     region's reads, `loglog k=31` over config #2's reads (within 7% of
     kmercountexact's distinct 31-mers), `kmerlimit k=31` over config
     #2's reads with limit= a quarter of those (LogLog's count on the
     card, the reads it passes equal to a device=cpu run's), `dedupe s=2
     e=2` over 50,000
     reads with planted copies and near-copies (kept and duplicates
     exactly the planted), `clumpify k=31` over config #1's reads and
     `dedupe=t` over dedupe's (the same-strand copies removed); then
     each on both devices, byte for byte, on a head (dedupe with ac=t;
     loglog's bucket maxima in this process);
 10. `reformat qtrim=rl trimq=10 minlen=40` over config #1's reads
     (optimal_trim on the card; reads/s, the trimmed and kept counts),
     then the tools on the glocal identity aligner (ROADMAP L5) through
     the CLI on device=cuda, each with its device route counted on the
     card: `alltoall` over 128 seeded variants of the 16S consensus
     (75-99% identity, 1-3 bp indels: 8,128 pairs in 16 calls; every
     pair within ATA_TOLERANCE of its planted identity, and the
     ATA_HOST_PAIRS pairs farthest from it equal to the host aligner's
     identity), `splitribo` over 1,024 reads
     cut from the 16S, 18S, 23S and 5S consensus records (each type's
     count the planted one), `icecream` trim=t and kzt=t over 2,000
     PacBio-named subreads of 2,000-10,000 bp of the E. coli-length
     genome, 100 with a missed adapter (flagged and discarded held to
     those of even length, as the JAX package flags),
     `testalignersbatch length=2000 samples=10` (29 ANI levels, exact
     glocal) and `testalignerslength` at its defaults (its
     3,000 bp on the banded edit distance); then each on both devices,
     byte for byte, on a head (reformat 10,000 reads, alltoall 24
     sequences, idmatrix 12, splitribo and mergeribo 128 reads, icecream
     both modes 200 subreads, both ladders at samples=4);
 11. runs the CPU halves of the checks of 6 to 10 whose outputs are
     files in EARLY_SIDE_WORKERS processes (3 on 8 cores) from 5 on,
     beside the phases (their plain versions take minutes: glocal rows
     and the fill of long reads on one thread), so the rates from 5 on
     are taken beside them; the CUDA halves of 6-9's and 13's checks in
     CPU_SIDE_WORKERS processes (the cores less one, 4 to 8) once the
     last rate is taken, 10's and 13's in this process meanwhile;
 12. prints each phase's seconds;
 13. the last device-using tools through the CLI on device=cuda, each
     with its device route counted on the card: `msa` (findprimers)
     over 100,000 reads of 16S variants with two primers planted (every
     planting found at its offset with its NM), `indelfree subs=3
     minid=0` with 512 CRISPR records against the planted genome in 71
     chunks (every planting found; the search's peak memory under its
     budget), `kmercoverage k=31 hist=` over config #2's reads,
     `bloomfilter ref=<genome> k=31` over the bloom reads, `polyfilter`
     over config #1's reads with poly-G tails (counts the JAX package's
     in a dry run, tools/a8c_dryrun.py), `seqtovec` -> `train` ->
     `netfilter` and `scoresequence` over 25,000 of config #1's reads, `calibrate
     epochs=2000` over 100,000 rows; then each on both devices on a
     head: byte for byte, but train's nets, calibrate's constants,
     netfilter's reads near the cutoff and scoresequence's scores, held
     to stated tolerances;
 14. the multi-device paths (ROADMAP A7) on a virtual mesh of the card
     (cuda:0 repeated), each held to one device on the same input and
     each check's seconds printed: BBDuk config #1's flags over (dp=2,
     tp=2) on 50,000 reads (FASTQ and stats byte-equal), BBMap defaults
     over dp=4 on one 4,096-read batch (the SAM equal; B4's launches
     over the slabs), the insert scan over 4 slabs of one 8,192-pair
     BBMerge batch (equal to overlap_counts; B5's launches), the
     hash-sharded spectrum over 4 shards of config #2's first 50,000
     reads at k=31 (spectrum and khist equal to DeviceSpectrum's), the
     matcher over (2, 2) on the full-k keys of its first batch (equal
     to mm_lookup; B3's `mm_best` a slab, held against its plain twin
     and timed beside mm_lookup at the slab: the kernels line's
     `mm_best` row), and two processes on the card joined by a gloo
     group running kmercountexact and the one-adapter BBDuk on the
     halves of 20,000 reads (khist, dump, the outputs in rank order and
     the stats equal to one process's);
 15. the read-QC pipelines (ROADMAP A8b) on device=cuda: `rqcfilter2`
     with clumpify, filterbytile, removeribo, polyfilter, removeref
     (the second genome), merge and khist over 10,000 tiled pairs of
     2x150 bp of the E. coli-length genome with phiX, rRNA,
     second-genome, poly-G, duplicate and poor-tile pairs planted: each
     stage's reads, seconds, BBDuk backend and kernel launches printed,
     B1, B2, B4, B5 and B6 required on the path, filterstats.txt equal
     to the JAX package's in a dry run (tools/a8b_dryrun.py), each
     planted class removed at its own stage; `decontaminate` over three
     libraries with planted contaminant contigs (every one in its
     library's _dirty.fasta, every true contig clean); then each on both
     devices, byte for byte: rqcfilter2's output directory on the first
     2,000 pairs (reproduce.sh with the run's directory replaced), and
     decontaminate's results, covstats, clean and dirty FASTA;
 16. A8b group 4 on device=cuda: `postfilter` at its defaults over
     config #2's genome cut into 100 contigs of 10,000 bp with 40
     contigs of 300-2,000 bp of the second genome and 20 of 100-199 bp
     planted, and the first 20,000 of config #2's reads (every genome
     contig kept, every planted and short one removed; contigs/s, reads/s
     and B4's launches printed); `reassemble k=31` over two tid_ inputs
     of 1,000 reads of a 5,000 bp region each (every header labelled,
     each region's 31-mers at least 0.9 in its contigs); `fll2simulate`
     at its defaults (~10M keys through loglog_update on the card, every
     meanRelErr under 0.05; its device=cpu run in this process) and the
     pruned fill (`msa_fill_batch prune=True`) in one call over the
     windows of the BBMap row's first 256 reads (its device=cpu half in
     a process of its own); postfilter on a head (10
     genome contigs, the planted ones, the reads that fall in them) and
     reassemble against device=cpu, byte for byte;
 17. the surface phase: BBDuk config #1's and the one-adapter
     flags over the first 20,000 of config #1's reads, each without and
     with `profile=<dir>` (the files equal; the trace's kernel events of
     B2, and of B1, equal to those kernels' launch counts in the run; a
     trace with no device event fails; each wall and the trace's size
     printed); `ops.seed_cluster.seed_candidates` on the card over the
     BBMap row's first 4,096-read batch (all nine outputs equal to the
     host `candidates_for_batch`; both timed); `SortedKmerIndex` and
     `HashKmerIndex` over config #1's 217,135 keys, their card lookups of
     one batch's 4,194,304 canonical keys equal to `lookup_np` (ms a
     call); the pruned fill with planes and its walk
     (`msa_fill_batch(prune=True, traceback=True)`) over 16's windows,
     its device=cpu half in a process of its own (scores, columns,
     states, walk ops and steps equal).

Its last line is {"ok": true, "device": {...}}; any failed phase raises
and the script exits non-zero. Without CUDA, or outside a checkout, it
exits non-zero and prints no result. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import gzip
import io
import json
import os
import re
import shutil
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ADAPTER = b"AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"
ADAPTER2 = b"AGATCGGAAGAGCGTCGTGTAGGGAAAGAGTGT"
COMMON = ["k=23", "mink=11", "hdist=1", "ktrim=r", "minlen=40"]
CONFIGS = {
    "adapters_fa": ["ref=adapters"] + COMMON,
    "1adapter": [f"literal={ADAPTER.decode()}"] + COMMON,
}
#: the matcher configuration, a stand-in made to pass the sorted join's
#: cap of 8,000,000 keys: ref=adapters alone expands to 6,823,201 keys at
#: hdist=2, so the panel adds phiX (19,494,221 keys; PERF.md section 4)
MM_CONFIG = ["ref=adapters,phix", "k=23", "mink=11", "hdist=2", "ktrim=r",
             "minlen=40"]
MM_READS = 50_000
TBO_FLAGS = CONFIGS["1adapter"] + ["tbo", "tpe"]
TBO_PAIRS = 50_000
BATCH = 16384  # reads per batch of the bbduk main path (batchreads default)
MERGE_BATCH = 8192  # pairs per batch of the bbmerge main path
CHECK_READS = 10_000  # reads (pairs) of the CUDA-against-CPU comparison
#: merged share of the seeded pairs (inserts 100-400 bp, 150 bp reads):
#: the overlapping ones (insert <= ~290) that are neither ambiguous nor
#: too noisy; 0.6215 on the first 16,384 pairs (CPU run)
MERGED_RANGE = (0.55, 0.70)
#: the BBMap configuration: a seeded genome of the length of E. coli K-12
#: MG1655 (no E. coli FASTA is in the repo), 151 bp reads with 1%
#: substitutions and 1-10 bp indels in 10% of them, pairs from inserts of
#: 200-500 bp
ECOLI_LEN = 4_641_652
MAP_READS = 20_000
MAP_PAIRS = 4_000
MAP_BATCH_READS = 4096  # one batch (batchreads default), for B4's checks
MAP_CHECK_READS = 256  # reads of the CUDA-against-CPU comparison
MAP_CHECK_PAIRS = 128
#: mapped share predicted for reads drawn from the reference itself
#: (PERF.md section 6, written before the first run); the CPU tests map
#: 300 of 300 such reads on a 150 kb genome
MAPPED_RANGE = (0.99, 1.0)
#: share of mapped primary reads placed within 20 bp of their true start
PLACED_MIN = 0.97
#: BASELINE configs #2 (kmercountexact k=31 khist) and #5 (Tadpole k=62,
#: then CallVariants on BBMap's SAM), on one seeded data set: a genome of
#: a fifth of E. coli's length, a copy of it with planted SNPs (1 per
#: 1,000 bp) and ~100 indels of 1-10 bp, and 150 bp reads of the copy at
#: 30x with 0.5% base errors
ASM_GENOME = 1_000_000
ASM_READS = 200_000
ASM_READ_LEN = 150
ASM_ERR = 0.005
ASM_SNP_RATE = 0.001
ASM_INDELS = 100
KCE93_READS = 50_000  # reads of the k=93 count
CV_READS = 50_000  # reads BBMap maps for CallVariants
CV_CHECK_READS = 4096  # SAM records of the CUDA-against-CPU CallVariants
#: Tadpole assembles the reads that lie in the copy's first ASM_REGION bp:
#: its contig walk is host code whose steps grow with the longest contig,
#: ~0.8 ms a step on a CPU core, so the whole genome would take ~15 minutes
#: (PERF.md section 4)
ASM_REGION = 25_000
ECC_CHECK_READS = 500  # reads of Tadpole mode=correct on both devices
#: the least share of the region's distinct canonical 31-mers that the
#: k=62 contigs must hold: 0.9989 on a 20,000 bp region of a 100,000 bp
#: genome at the same depth and error rate on the CPU (PERF.md section 4)
ASM_RECALL_MIN = 0.98
#: CallVariants at 7.5x (CV_READS of the 30x reads): the least shares of
#: the planted SNPs and indels called PASS, and the most PASS rows that
#: match no planted variant (112 of 112 SNPs, 20 of 20 indels and no
#: false call at 10,000 reads of a 100,000 bp genome on the CPU)
CV_SNP_RECALL_MIN = 0.95
CV_INDEL_RECALL_MIN = 0.8
CV_FALSE_MAX = 10
#: tadpipe at assemble/TadPipe.java's defaults (k=31,62,93, every stage
#: on), on pairs of 2x150 bp from inserts of 100-450 bp of config #5's
#: copy's first ASM_REGION bp at ~15x (30x before: cut for the smoke's
#: time, PERF.md section 4 "Cuts"), each mate running into its adapter
#: past a short insert, with ASM_ERR base errors. Its stages past trim and
#: ecco (Tadpole's correction and walks, BBMerge's extension) are host
#: code, so the whole pipeline runs on the region; its two device stages
#: run on their own over PIPE_FULL_PAIRS pairs (7.5x; 30x and 15x before
#: the same cuts) of the whole copy.
#: Its check runs on PIPE_CHECK_PAIRS pairs (30x) of the region's head
PIPE_PAIRS = 1_250
PIPE_CHECK_PAIRS = 500
PIPE_FULL_PAIRS = 25_000
PIPE_INSERTS = (100, 450)
PIPE_TRIM = ["ref=adapters", "ktrim=r", "k=23", "mink=11", "hdist=1", "qtrim=r",
             "trimq=10", "tbo", "tpe", "minlen=62"]
PIPE_ECCO = ["ecco=t", "mix=t", "strict"]
PIPE_MERGE = ["k=75", "extend2=120", "rem=t", "ecct=t"]
PIPE_CHECK_BP = 5_000  # the region's head, for tadpipe's CUDA against CPU
#: pairs of BBMerge's CUDA-against-CPU checks of ecco and nn=t, and of its
#: merge stage with extend2 and ecct, whose host correction and extension
#: run ~35 pairs/s on a CPU core (PERF.md section 4)
MERGE_CHECK_PAIRS = 20_000
#: BBMerge nn=t's rate over the first NN_PAIRS of BBMerge's pairs (all
#: 150,000 at first, then 75,000, 50,000: cut for the smoke's time,
#: PERF.md section 4 "Cuts")
NN_PAIRS = 25_000
MERGE_ECCT_CHECK_PAIRS = 500
#: bbcms: all of config #2's reads with the depth filter; the default
#: ecc=t on the region's first CMS_ECC_READS reads (host correction,
#: ~46 reads/s; 500 at first: cut for the smoke's time, PERF.md section
#: 4 "Cuts")
CMS_FILTER = ["ecc=f", "mincount=2", "hcf=0.5"]
CMS_ECC_READS = 250
CMS_CHECK_READS = 2_000
#: BBMap bloomfilter=t over the map reads' head and seeded foreign reads,
#: one of them after every ten real reads. At E. coli's length the
#: sketch (3 x 2^22 cells, the JAX package's) holds ~4.6M 31-mers, so a
#: foreign 31-mer hits all three lanes ~30% of the time and a foreign
#: read of 121 of them is prescreened only by chance; the CUDA-against-
#: CPU check maps BLOOM_CHECK_READS reads of the region plus foreign ones
#: against the region alone, where every foreign read is prescreened
BLOOM_READS = 20_000
BLOOM_FOREIGN = 2_000
BLOOM_CHECK_READS = 2_048

#: mapPacBio (ROADMAP A4b) on the E. coli-length genome: one batch of 64
#: FASTA records (a full batch of the preset's batchreads=512 before: cut
#: for the smoke's time, PERF.md section 4 "Cuts") of reads of
#: 1,000-6,000 bp with 1% substitutions, three indels of 1-3 bp and, in
#: every other read, a 50 bp deletion, every third reverse-complemented;
#: LONG_CHUNKED of them are of 6,100-12,000 bp, which fastareadlen=6000
#: cuts in two chunks each (26 of the 77 records). The walk, a torch
#: loop of ~12,000-19,600 steps a call, costs ~11-14 s a call on the
#: card, a call a plane group (9 at 512 records, 5 at 128).
#: bbmapskimmer maps the first SKIM_READS of the same records: its walk
#: calls cost the same at any count, and fewer tasks need fewer groups
#: (128 at first, then 32: cut for the smoke's time, PERF.md section 4
#: "Cuts")
LONG_READS = 51
LONG_RANGE = (1000, 6000)
LONG_CHUNKED = 13
LONG_CHUNKED_RANGE = (6100, 12000)
SKIM_READS = 16
LONG_CHECK_READS = 8  # the CUDA-against-CPU check, reads of 1,000-1,500 bp
LONG_CHECK_RANGE = (1000, 1500)
#: the least share of mapped unchunked long reads placed within 50 bp
LONG_PLACED_MIN = 0.9
#: B4's block kernel at mapPacBio's widest window class: (tasks, rows,
#: columns, shortest read), reads of up to 6,000 bases in windows of
#: 6,000 + 7,640 columns
B4_LONG = (4, 6000, 6000 + 7640, 1000)
#: BBDuk config #1 with align=t: config #1's reads, one in SIDE_EVERY
#: replaced by a phiX segment of its length
SIDE_EVERY = 10
A2_CHECK_READS = 2_000  # BBDuk align and recalibrate, CUDA against CPU
COV_CHECK_READS = 2_048  # BBMap's coverage and bbsplit, CUDA against CPU
COV_FLAGS = ("covstats", "basecov", "covhist", "bincov")
#: bbsplit: the genome and a second seeded one; reads of each
SECOND_GENOME = 1_000_000
SPLIT_READS = 2_048
RH_READS = 2_200  # removehuman: the head of the bloom reads (200 foreign)
#: the coverage and bbsplit checks map to a region of the genome (and of
#: the second genome): the CPU's BBMap over the whole genome and its
#: 4.6M-line basecov= took 60-114 s beside the card's phases
CHECK_REGION = 250_000
#: processes running the CPU halves of the checks at once: the cores
#: processes running the CUDA halves of the checks once the last rate is
#: taken (and netfilter's and scoresequence's CPU halves): the cores
#: this process may use less one (this process, which runs the L5 and
#: a8c checks' CUDA halves and mostly waits for the processes), at least
#: 4 and at most 8
CPU_SIDE_WORKERS = max(4, min(8, len(os.sched_getaffinity(0)) - 1))
#: processes running the CPU halves of the checks (~1,500 process
#: seconds) beside the phases from config #2/#5 on (~600 s): with this
#: process they keep under half the cores busy, so that on cores of two
#: hardware threads no busy thread need share a core with this one's
EARLY_SIDE_WORKERS = max(1, min(3, len(os.sched_getaffinity(0)) // 2 - 1))
CTQ_RECORDS = 4_096  # calctruequality's input: the head of BBMap's SAM
#: the A8a tools (seal, bbnorm, ecc, loglog, dedupe, clumpify). Seal
#: bins config #1's reads with phiX planted (the align=t input) against
#: six references: the E. coli-length genome cut in SEAL_PARTS files,
#: the second genome and phiX
SEAL_PARTS = 4
SEAL_CHECK_READS = 10_000
BBNORM_FLAGS = ["k=31", "target=10", "mindepth=5"]
#: dedupe's input: DEDUPE_DISTINCT random reads of 150 bp, DEDUPE_EXACT
#: exact copies of as many of them (every other reverse-complemented)
#: and DEDUPE_NEAR near-copies of others (1-2 substitutions or a 1 bp
#: indel at 40-110), shuffled (four and two times as many of each at
#: first: cut for the smoke's time, PERF.md section 4 "Cuts")
DEDUPE_DISTINCT = 37_500
DEDUPE_EXACT = 6_250
DEDUPE_NEAR = 6_250
DEDUPE_FLAGS = ["s=2", "e=2"]
#: the dedupe and clumpify checks' heads: past one 16,384-read batch, so
#: that dedupe's second batch sends pairs to the banded edit distance
A8A_CHECK_READS = 20_000
#: loglog's estimate against kmercountexact's distinct count: 3 standard
#: errors (1.04 / sqrt(buckets)) at 2,048 buckets
LOGLOG_BAND = 0.07
#: kmerlimit's limit= as a share of kmercountexact's distinct 31-mers:
#: it stops after a few 4,096-read batches of config #2's reads
KMERLIMIT_SHARE = 4
#: reformat's quality trim (its device route) over config #1's reads
REFORMAT_FLAGS = ["qtrim=rl", "trimq=10", "minlen=40"]
#: the tools on the glocal identity aligner (ROADMAP L5). alltoall:
#: ATA_SEQS variants of the 16S universal consensus (1,533 bp) at
#: ATA_ID_RANGE identity with 1-3 indels of 1-3 bp (8,128 pairs in 16
#: calls), each pair held within ATA_TOLERANCE of its planted identity:
#: the JAX package's own largest deviation on this input (a CPU dry run
#: at full size from the smoke's seed, tools/l5_dryrun.py --only
#: alltoall --ata-scale 1: mean 0.0138, 99th percentile 0.0455, largest
#: 0.0569), rounded up
ATA_SEQS = 128
ATA_ID_RANGE = (0.75, 0.99)
ATA_TOLERANCE = 0.06
#: the pairs of the matrix held to the host aligner (glocal_align_np,
#: ~2.5 s a pair of 1,533 bp on one core)
ATA_HOST_PAIRS = 3
ATA_CHECK_SEQS = 24
IDM_CHECK_SEQS = 12
#: splitribo: RIBO_READS reads of RIBO_TYPES (a quarter each) of
#: RIBO_LEN bp (5S records whole) with RIBO_SUB substitutions; each
#: type's count held to the planted one (a CPU dry run of the JAX
#: package at a quarter of the size, tools/l5_dryrun.py, routed every
#: read to its type: PERF.md section 6)
RIBO_TYPES = ("16S", "18S", "23S", "5S")
RIBO_READS = 1_024
RIBO_LEN = (800, 1_500)
RIBO_SUB = (0.05, 0.10)
#: the CUDA-against-CPU heads of splitribo/mergeribo and icecream: their
#: CPU halves are plain glocal rows on one thread (minutes each), run in
#: EARLY_SIDE_WORKERS processes beside the phases
RIBO_CHECK_READS = 128
#: icecream: IC_ZMWS ZMWs of IC_PASSES subreads of IC_LEN bp of the
#: E. coli-length genome, one subread of IC_PLANTED of them folded at
#: its middle (a missed adapter). The JAX package flags exactly the
#: folded subreads of even length (the dry run: 14 of 25, the 14 even
#: ones): an odd one's junction lands on n // 2 and its refinement on the
#: right tip puts it at ~0.28 n, under MIN_JUNCTION_FRACTION. So the
#: flagged subreads and the discarded ZMWs are held to the folded
#: subreads of even length
IC_ZMWS = 500
IC_PASSES = 4
IC_LEN = (2_000, 10_000)
IC_PLANTED = 100
IC_CHECK_READS = 200
#: testalignersbatch's CUDA-against-CPU check, and its mean identities
#: at ANI >= 0.75 held within LADDER_TOLERANCE of the ANI (the dry run)
LADDER_CHECK = ["ani=1,0.95,0.85,0.75", "samples=4"]
LADDER_TOLERANCE = 0.05
#: the last device-using tools (ROADMAP A8a's L7 tools, the tools on the
#: count-min sketch, the CellNet family and calibrate). Every count held
#: below is the JAX package's on this input, from a CPU dry run at full
#: size from the smoke's seed (tools/a8c_dryrun.py; PERF.md section 6).
#: msa: MSA_READS reads of MSA_LEN bp cut from the L5 phase's 16S
#: variants away from the primers' own sites (MSA_AWAY), MSA_PRIMERS
#: (consensus offset, length) cut from the 16S consensus, and one of the
#: four primer rows (two primers, two strands) planted with 0-2
#: substitutions in MSA_PLANTED_SHARE of the reads; every planting found
#: at its offset with its NM
MSA_READS = 100_000
MSA_LEN = (150, 300)
MSA_PRIMERS = ((515, 19), (786, 20))
MSA_AWAY = ((0, 490), (830, 1_533))
MSA_PLANTED_SHARE = 0.8
MSA_CHECK_READS = 10_000
#: indelfree: the first IFA_QUERIES records of the bundled CRISPR panel
#: (22-55 bp), IFA_PLANTED of them planted with 0-3 substitutions on
#: either strand in a copy of the E. coli-length genome (the first
#: IFA_CHECK_PLANTED of them among the check's queries and in its head);
#: subs=3 minid=0; every planting found
IFA_QUERIES = 512
IFA_PLANTED = 64
IFA_FLAGS = ["subs=3", "minid=0"]
IFA_CHECK_QUERIES = 128
IFA_CHECK_BP = 262_144
IFA_CHECK_PLANTED = 8
#: polyfilter at its defaults with extra= its own input: config #1's
#: reads, one in POLY_EVERY given a poly-G tail of POLY_TAIL bp; removed
#: the JAX package's count (the dry run)
POLY_EVERY = 20
POLY_TAIL = (20, 60)
POLY_REMOVED = 7_899
#: kmercoverage k=31 over config #2's reads: the mode of its depth
#: histogram the JAX package's (the dry run)
KC_MODE = 20
#: bloomfilter ref=<the genome> k=31 over make_bloom_reads' reads: the
#: matched count the JAX package's (the dry run). At the genome's
#: 4,641,652 31-mers each lane of the default sketch (3 x 2^22 cells) is
#: ~67% set, so a foreign k-mer passes all three with p ~0.30: foreign
#: reads of ~120 k-mers match too
BLOOM_MATCHED = 22_000
#: the CellNet family: ML_READS reads of 150 bp, half drawn from GC-rich
#: and half from AT-rich pools (tests/test_mltools.py's classes), made
#: vectors by seqtovec (k=0, width 55: 224 features), a net trained on
#: them at train's defaults (2,000 epochs, [224, 64, 1]); netfilter and
#: scoresequence with it over the first NN_FILTER_READS of config #1's
#: reads (all 200,000 at first, then 100,000, 50,000: cut for the smoke's
#: time, PERF.md section 4 "Cuts"). The check trains on
#: ML_CHECK_ROWS rows a class on both devices: the nets within
#: FIT_WEIGHT_TOL in every weight (their files print six decimals) and
#: the reported mse within the same; netfilter's files equal but for
#: reads scoring within NN_NEAR of the cutoff (counted on the card);
#: scoresequence's scores within SCORE_TOL (one unit of their fourth
#: decimal). The bounds: tests/test_torch_mltools.py, from the dry run
ML_READS = 20_000
NN_FILTER_READS = 25_000
ML_POOLS = (b"GCGCGCAT", b"ATATATGC")
ML_CHECK_ROWS = 1_000
FIT_WEIGHT_TOL = 5e-5
NN_NEAR = 1e-5
SCORE_TOL = 1e-4
#: calibrate epochs=2000 over CAL_ROWS (score, label) rows drawn as
#: tests/test_research.py draws them; both devices' constants within
#: CAL_TOL (one unit of their fifth decimal), the mse within CAL_MSE_TOL
CAL_ROWS = 100_000
CAL_TOL = 1e-5
CAL_MSE_TOL = 1e-6

# Rates of one H100 SXM for the bounds (NVIDIA's data sheet and Hopper
# white paper): HBM3 at 3.35 TB/s; int8 tensor cores at 1,979 TOP/s;
# int32 outside the tensor cores at 132 SMs x 64 INT32 lanes x 1.98 GHz,
# half the float32 rate of 67 TFLOP/s (128 FP32 lanes per SM)
HBM_BYTES_S = 3.35e12
INT8_TC_OPS_S = 1979e12
INT32_OPS_S = 132 * 64 * 1.98e9
#: instructions the SMs can start: 4 schedulers of one warp instruction a
#: clock on each of 132 SMs, 32 lanes each, at 1.98 GHz. B4's count is of
#: SASS instructions, which go to several pipes (integer, the FMA pipe's
#: IMAD, shuffles, shared-memory loads), so the schedulers' rate, not
#: the int32 lanes, bounds them; it equals the float32 rate of 67
#: TFLOP/s counted as instructions (an FMA is two operations)
INSTR_S = 132 * 4 * 32 * 1.98e9
#: instructions a cell of the fill costs when cuobjdump is missing: the
#: count of the warp kernel's diagonal loop at 5 slices, 782 over 5 (my
#: count of the code built on an H100 with CUDA 12.8; each run prints the
#: count of the code it built)
B4_OPS_PER_CELL = 782 / 5


def make_fastq(path: str, n: int, seed: int) -> int:
    """Seeded reads of 90-151 bp, phred 2-40, every third read carrying
    an adapter tail from a random position >= 40 (truncated at the read
    end). Returns the number of bases."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    adapter = np.frombuffer(ADAPTER, np.uint8)
    lmax = 151
    lens = rng.integers(90, lmax + 1, n)
    seq = acgt[rng.integers(0, 4, (n, lmax))]
    qual = (33 + rng.integers(2, 40, (n, lmax))).astype(np.uint8)
    start = rng.integers(40, lens - 5)
    col = np.arange(lmax)[None, :]
    off = col - start[:, None]
    tail = ((np.arange(n) % 3) == 0)[:, None] & (off >= 0) & (off < len(adapter))
    seq[tail] = adapter[off[tail]]
    with gzip.open(path, "wb", compresslevel=1) as fh:
        for c0 in range(0, n, 100_000):
            recs = []
            for i in range(c0, min(n, c0 + 100_000)):
                L = lens[i]
                recs.append(b"@r%d\n%s\n+\n%s\n" % (
                    i, seq[i, :L].tobytes(), qual[i, :L].tobytes()))
            fh.write(b"".join(recs))
    return int(lens.sum())


def make_pairs(paths: list[str], n: int, seed: int, lo: int, hi: int,
               L: int = 150, genome=None, err: float | None = None) -> int:
    """Seeded pairs of L bp from inserts of lo..hi bp: r1 is the insert's
    start, r2 its reverse-complemented end, each read running into its
    adapter past the insert; phred 2-40, mostly high (41 - an exponential
    of mean 7), with sequencing errors drawn at each base's phred rate
    (or, given `err`, at that rate whatever the phred) and an N in every
    25th r1. The inserts are random sequence, or given `genome` (codes
    0-3) drawn from it at seeded starts. Written to two files (r1, r2)
    or, given one path, interleaved. Returns the number of pairs."""
    rng = np.random.default_rng(seed)
    ascii_ = np.frombuffer(b"ACGTN", np.uint8)
    p_err = (10.0 ** (-np.arange(41) / 10.0)).astype(np.float32)
    fh = [gzip.open(p, "wb", compresslevel=1) for p in paths]
    try:
        for c0 in range(0, n, 100_000):
            m = min(n, c0 + 100_000) - c0
            ins = rng.integers(lo, hi + 1, m)
            if genome is None:
                frag = rng.integers(0, 4, (m, hi), dtype=np.uint8)
            else:
                start = rng.integers(0, len(genome) - hi + 1, m)
                frag = np.asarray(genome, np.uint8)[start[:, None] + np.arange(hi)[None, :]]
            pos = np.arange(L)[None, :]
            reads = []
            for mate, adapter in ((0, ADAPTER), (1, ADAPTER2)):
                ad = np.frombuffer(adapter, np.uint8)
                # r1[p] = frag[p]; r2[p] = comp(frag[ins - 1 - p])
                src = pos if mate == 0 else ins[:, None] - 1 - pos
                codes = np.take_along_axis(frag, np.clip(src, 0, hi - 1), 1)
                if mate == 1:
                    codes = 3 - codes
                s = ascii_[codes]
                past = pos - ins[:, None]  # position into the adapter
                ad_pos = (past >= 0) & (past < len(ad))
                s[ad_pos] = ad[past[ad_pos]]
                s[past >= len(ad)] = ord("A")
                q = np.clip(41 - rng.exponential(7, (m, L)), 2, 40).astype(np.uint8)
                rate = p_err[q] if err is None else np.float32(err)
                e = rng.random((m, L), dtype=np.float32) < rate
                s[e] = ascii_[rng.integers(0, 4, int(e.sum()))]
                if mate == 0:
                    n_rows = np.arange(0, m, 25)
                    s[n_rows, rng.integers(0, L, len(n_rows))] = ord("N")
                reads.append((s, (q + 33).astype(np.uint8)))
            # fixed-width records, built as one byte matrix per mate:
            # "@p<8-digit index> <mate>:N:0\n<seq>\n+\n<qual>\n"
            ids = c0 + np.arange(m)
            digits = (ids[:, None] // 10 ** np.arange(7, -1, -1)[None, :]) % 10
            recs = []
            for mate, (s, q) in enumerate(reads):
                head = np.frombuffer(b"@p", np.uint8)[None, :].repeat(m, 0)
                tail = np.frombuffer(b" %d:N:0\n" % (mate + 1), np.uint8)
                recs.append(np.concatenate([
                    head, (48 + digits).astype(np.uint8), tail[None, :].repeat(m, 0),
                    s, np.full((m, 3), [10, 43, 10], np.uint8), q,
                    np.full((m, 1), 10, np.uint8)], axis=1))
            if len(fh) == 2:
                fh[0].write(recs[0].tobytes())
                fh[1].write(recs[1].tobytes())
            else:
                fh[0].write(np.stack(recs, axis=1).tobytes())
    finally:
        for f in fh:
            f.close()
    return n


def near_match_tasks(rng, S: int, R: int, Cc: int, lmin: int):
    """Seeded fill tasks: each read a slice of its window with 3%
    substitutions and one indel of up to 10 bases, a few N, code 4 past
    each read's length (lengths lmin..R)."""
    refs = rng.integers(0, 4, (S, Cc)).astype(np.uint8)
    refs[rng.random((S, Cc)) < 0.003] = 4
    lens = rng.integers(lmin, R + 1, S).astype(np.int32)
    reads = np.full((S, R), 4, np.uint8)
    for s in range(S):
        n = int(lens[s])
        start = int(rng.integers(0, max(Cc - n - 12, 1)))
        src = refs[s, start : start + n + 12].copy()
        p, k = int(rng.integers(0, max(n - 10, 1))), int(rng.integers(0, 11))
        if s % 2:
            src = np.concatenate([src[:p], src[p + k :]])
        else:
            src = np.concatenate([src[:p], rng.integers(0, 4, k).astype(np.uint8), src[p:]])
        src = np.resize(src, n)
        m = rng.random(n) < 0.03
        src[m] = (src[m] + rng.integers(1, 4, int(m.sum()))) % 4
        src[rng.random(n) < 0.003] = 4
        reads[s, :n] = src
    return reads, lens, refs


def head_fastq(src: str, dst: str, n: int):
    with gzip.open(src, "rb") as fi, gzip.open(dst, "wb", compresslevel=1) as fo:
        for _ in range(4 * n):
            fo.write(fi.readline())


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over `reps` back-to-back calls,
    after one warm-up call, with CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def graph_ms(fn, reps: int = 50, inputs=None) -> float:
    """Mean device milliseconds of fn() with the host's per-call cost out
    of the way: `reps` calls captured in one CUDA graph, replayed once to
    warm up and once under CUDA events. For kernels of microseconds,
    whose back-to-back calls (cuda_ms) measure the wrapper's Python.

    With `inputs`, fn takes one argument and the calls cycle through
    them, each call's output kept to the end of the replay: inputs and
    outputs larger together than the L2 (50 MB) make each call read and
    write HBM, the traffic its bound by bytes counts."""
    import torch

    def call(i):
        return fn(inputs[i % len(inputs)]) if inputs else fn()

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call(0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    kept = []
    with torch.cuda.graph(graph):
        for i in range(reps):
            out = call(i)
            if inputs:
                kept.append(out)
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def graph_turns(fns: dict) -> dict:
    """Each function's graph_ms, timed in turns: in the order of `fns`
    and back; the mean of the two."""
    t = {f: [] for f in fns}
    for order in (tuple(fns), tuple(fns)[::-1]):
        for f in order:
            t[f].append(graph_ms(fns[f]))
    return {f: sum(v) / len(v) for f, v in t.items()}


def compare(name: str, kernel, plain, reps: int = 20, plain_reps: int | None = None,
            graph: bool = False) -> dict:
    """Exact comparison of kernel() and plain() on the card, then timing
    in turns (plain, kernel, kernel, plain); `plain_reps` (default
    `reps`) calls of the plain version per turn. With `graph`, the
    kernel's `ms` is its time in a CUDA graph (graph_ms) and its
    back-to-back time is kept as `eager_ms`."""
    plain_reps = plain_reps or reps
    import torch

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
    err = 0
    for g, w in pairs:
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{name}: {g.shape}/{g.dtype} vs {w.shape}/{w.dtype}")
        if g.numel():
            err = max(err, int((g.to(torch.int64) - w.to(torch.int64)).abs().max().item()))
        if not torch.equal(g, w):
            raise AssertionError(f"{name}: kernel differs from its plain version (max |diff| {err})")
    n = sum(g.numel() for g in got) if isinstance(got, tuple) else got.numel()
    p1 = cuda_ms(plain, plain_reps)
    k1 = cuda_ms(kernel, reps)
    k2 = cuda_ms(kernel, reps)
    p2 = cuda_ms(plain, plain_reps)
    row = {"max_abs_err": err, "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2}
    if graph:
        row["eager_ms"] = row["ms"]
        row["ms"] = graph_ms(kernel)
    print(f"{name}: n={n} exact=True kernel {row['ms']:.4f} ms"
          + (f" in a graph ({row['eager_ms']:.4f} ms back to back)" if graph else "")
          + f", plain {row['plain_ms']:.4f} ms")
    return row


#: B3's measurement variants (bbtools_torch.ops.mm_match.VARIANTS), each
#: timed on the main path's keys in turns with the main kernel
MM_VARIANTS = ("main", "dp4a", "max_only", "one_column", "half_tile")


def mm_variants(label: str, args) -> dict:
    """B3's variants on one key set: those that compute the lookup held
    equal to the main kernel; then each timed twice, in the order of
    MM_VARIANTS and back."""
    import torch

    from bbtools_torch.ops.mm_match import LOOKUP_VARIANTS, mm_lookup, mm_lookup_variant

    want = mm_lookup(*args)
    for name in LOOKUP_VARIANTS:
        if not torch.equal(mm_lookup_variant(name, *args), want):
            raise AssertionError(f"B3 {label}: the {name} variant differs")
    ms = {v: [] for v in MM_VARIANTS}
    for order in (MM_VARIANTS, MM_VARIANTS[::-1]):
        for v in order:
            reps = 2 if v == "dp4a" else 5
            ms[v].append(cuda_ms(lambda: mm_lookup_variant(v, *args), reps))
    out = {v: sum(t) / len(t) for v, t in ms.items()}
    print(f"B3 {label} variants (ms): " + ", ".join(f"{v} {t:.4f}" for v, t in out.items()))
    return out


def bound(nbytes: float, ops: float, ops_rate: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over their peak rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / ops_rate
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": int(nbytes), "ops": int(ops)}


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


#: keys of the synthetic lane table at LaneKmerIndex.build's cost cap: the most a
#: layout of groups x slots = MAX_COST (1,280) holds for random keys
COST_CAP_KEYS = 70_000


def cost_cap_table():
    """A seeded lane table at LaneKmerIndex.MAX_COST, built by the port's
    index build: its planes (768 KB each) exceed a block's shared memory."""
    from bbtools_torch.ops.lane_index import LaneKmerIndex

    rng = np.random.default_rng(70)
    keys = np.unique(rng.integers(0, 1 << 44, 4 * COST_CAP_KEYS) | (1 << 44))[:COST_CAP_KEYS]
    idx = LaneKmerIndex.build(keys, rng.integers(1, 1000, len(keys)).astype(np.int32))
    if idx is None or idx.groups * idx.slots <= 0.9 * LaneKmerIndex.MAX_COST:
        raise AssertionError("B1: the cost-cap table did not build near MAX_COST")
    return idx


def b1_check(label: str, idx, q, dev) -> dict:
    """B1 on one table: the wrapper's kernel (shared memory, or the L2
    probe for a table past it) held equal to the plain version and to PR
    1's kernel, the path checked against the table's bytes, then the
    kernel and the original kernel timed in turns in CUDA graphs."""
    import torch

    from bbtools_torch.ops import lane_index

    tbl = idx.device_arrays(dev)
    args = (*tbl, *idx.static_params())
    shared = lane_index.fits_shared(dev, idx.nb, idx.slots, idx.rows, idx.packed)
    l2 = lane_index.lane_lookup.l2_launches
    r = compare(f"B1 lane_lookup {label} ({idx.groups}x{idx.slots} slots, "
                f"{nbytes(*tbl) // 1024} KB, {'shared memory' if shared else 'L2 probe'})",
                lambda: lane_index.lane_lookup(*args, q),
                lambda: lane_index.lookup_plain(*args, q), graph=True)
    if (lane_index.lane_lookup.l2_launches > l2) == shared:
        raise AssertionError(f"B1 {label}: the {'L2' if shared else 'shared'} path ran")
    if not torch.equal(lane_index.lane_lookup_variant("scalar", *args, q),
                       lane_index.lane_lookup(*args, q)):
        raise AssertionError(f"B1 {label}: the original kernel differs")
    hits = int((lane_index.lane_lookup(*args, q) > 0).sum().item())
    if label != "cost cap" and hits == 0:
        raise AssertionError("B1: no query hit the adapter table")
    ms = {"main": [], "scalar": []}
    for v in ("main", "scalar", "scalar", "main"):
        fn = lane_index.lane_lookup if v == "main" else (
            lambda *a: lane_index.lane_lookup_variant("scalar", *a))
        ms[v].append(graph_ms(lambda: fn(*args, q)))
    r["ms"] = sum(ms["main"]) / 2
    r["variants_ms"] = {"scalar": sum(ms["scalar"]) / 2}
    # per query: the hash (9 int32 operations) and one probed slot (5)
    r.update(bound(nbytes(q, *tbl) + 4 * q.numel(), 14 * q.numel(), INT32_OPS_S))
    r.update(label=label, path="shared" if shared else "l2", hits=hits,
             table_bytes=nbytes(*tbl))
    print(f"B1 {label}: kernel {r['ms']:.4f} ms, the original kernel {r['variants_ms']['scalar']:.4f} "
          f"ms in turns in a graph; bound {r['bound_ms']:.4f} ms ({r['bound_by']}, "
          f"{r['bound_ms'] / r['ms']:.3f} of it); {hits} of {q.numel()} queries hit")
    return r


def check_kernels(fq: str, pair1: str, pair2: str) -> list[dict]:
    import torch

    from bbtools_torch.io.fastq import FastqReader
    from bbtools_torch.kernels.build import library as build_lib
    from bbtools_torch.models.bbduk import build_index, load_reference, parse_args
    from bbtools_torch.models.bbmerge import _rc_batch
    from bbtools_torch.ops import bbduk_scan, lane_index, lane_table, scan, sort_join
    from bbtools_torch.ops.bbduk_scan import KScanConfig, canonical_keys, kscan_combined
    from bbtools_torch.ops.kmers import rolling_kmers
    from bbtools_torch.ops.mm_match import (MMKmerIndex, mm_lookup, mm_lookup_plain,
                                            mm_lookup_variant)
    from bbtools_torch.ops.overlap import PROB_CORRECT4
    from bbtools_torch.ops.overlap_scan import overlap_counts, overlap_counts_plain

    dev = torch.device("cuda")
    # read the file to its end, so the reader's threads and any gzip
    # process finish
    batch = list(FastqReader(fq, batch_reads=BATCH))[0]
    bases = torch.from_numpy(batch.bases).to(dev)
    print(f"main-path batch: {tuple(bases.shape)} bases")
    fwd, rkm, _ = rolling_kmers(bases, 23)

    def keys_for(cfg_args):
        cfg = parse_args(cfg_args)
        index, _, _ = build_index(cfg)
        mm = cfg.mid_mask_bits if cfg.mask_middle else -1
        keys = canonical_keys(KScanConfig(k=cfg.k, mid_mask=mm), fwd, rkm, cfg.k)
        return index, keys

    # B1: the 1-adapter lane table, packed (as built) and unpacked, in
    # shared memory; a table at LaneKmerIndex.build's cost cap, probed in L2
    lane, q = keys_for(CONFIGS["1adapter"])
    packed = lane_index.LaneKmerIndex.from_arrays(
        lane.tlo, lane.thi, lane.tid, *lane.static_params())
    unpacked = lane_index.LaneKmerIndex.from_arrays(
        lane.tlo, lane.thi >> 16, lane.thi & 0xFFFF, lane.nb, lane.groups,
        lane.slots, lane.rows, lane.salt, False)
    rows = [b1_check(label, idx, q, dev) for label, idx in
            (("packed", packed), ("unpacked", unpacked), ("cost cap", cost_cap_table()))]
    b1 = {
        "name": "lane_lookup", "route": "cuda",
        "source": "bbtools_torch/csrc/lane_lookup.cu",
        "replaces": "bbtools_tpu/ops/lane_index.py:244",
        "redesigned": True,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": rows[0]["ms"], "plain_ms": rows[0]["plain_ms"],
        "bound_ms": rows[0]["bound_ms"], "bound_by": rows[0]["bound_by"],
        "library_ms": None, "variants_ms": rows[0]["variants_ms"],
        "tables": rows,
    }

    # B2: the cummax input of the first join chunk of config #1
    join, q = keys_for(CONFIGS["adapters_fa"])
    skeys, ids32 = join.device_arrays(dev)
    v, _, _ = sort_join.segment_words(skeys, ids32, q.reshape(-1)[: sort_join.CHUNK])
    r2 = compare(f"B2 cummax_i64 join chunk ({join.n} index rows)",
                 lambda: scan.cummax_i64(v), lambda: scan.cummax_plain(v), graph=True)
    # an int64 compare and select per element, two int32 operations each
    r2.update(bound(2 * nbytes(v), 4 * v.numel(), INT32_OPS_S))
    for name in scan.VARIANTS:
        if not torch.equal(scan.cummax_i64_variant(name, v), scan.cummax_i64(v)):
            raise AssertionError(f"B2: the {name} variant differs on the join chunk")
    fns = {name: (lambda f=name: scan.cummax_i64_variant(f, v)) for name in scan.VARIANTS}
    fns["torch.cummax"] = lambda: torch.cummax(v, 0)
    ms = graph_turns(fns)
    r2["ms"] = ms.pop("main")
    r2["library_ms"] = ms.pop("torch.cummax")
    r2["variants_ms"] = ms
    r2["library_eager_ms"] = cuda_ms(lambda: torch.cummax(v, 0), 20)
    tile = build_lib().cummax_i64_tile()
    print(f"B2 in turns in a graph: one-pass kernel {r2['ms']:.4f} ms (tile {tile}, "
          f"{-(-v.numel() // tile)} tiles; {r2['bound_ms'] / r2['ms']:.3f} of the "
          f"{r2['bound_ms']:.4f} ms bound), the first port's three-pass kernel "
          f"{ms['three_pass']:.4f} ms ({ms['three_pass'] / r2['ms']:.2f}x); torch.cummax "
          f"{r2['library_ms']:.4f} ms ({r2['library_eager_ms']:.4f} ms back to back)")
    gen = torch.Generator(device="cpu").manual_seed(7)
    for n in (1, 4095, 4096, 4097, 1_000_003, 5_000_003):
        r = torch.randint(-(2**62), 2**62, (n,), generator=gen, dtype=torch.int64)
        r[r.abs() < 2**60] *= -1
        r[:: 997] = -(2**63)
        r = r.to(dev)
        want = scan.cummax_plain(r)
        if not torch.equal(scan.cummax_i64(r), want):
            raise AssertionError(f"B2: random n={n} differs from torch.cummax")
        for name in scan.VARIANTS:
            if not torch.equal(scan.cummax_i64_variant(name, r), want):
                raise AssertionError(f"B2: the {name} variant differs at random n={n}")
    print("B2 cummax_i64 and its variants, random (INT64_MIN, negatives, ragged n): exact=True")
    b2 = {
        "name": "cummax_i64", "route": "cuda",
        "source": "bbtools_torch/csrc/cummax_i64.cu",
        "replaces": "bbtools_tpu/ops/scan_pallas.py:49",
        "redesigned": True, "tile": tile,
        **r2,
    }

    # B3: the matcher of the main path's configuration (MM_CONFIG; its
    # raw-key columns, which need no hdist expansion) on the keys the main
    # path's scans send it for this batch: the full-k scan's and the
    # right-end short-kmer scan's (lengths mink..k-1, class channels set)
    mcfg = parse_args(MM_CONFIG)
    scaffolds, _ = load_reference(mcfg)
    mink = mcfg.mink if mcfg.use_short_kmers else 0
    mm = MMKmerIndex.build(scaffolds, mcfg.k, mink=mink, hdist=mcfg.hdist,
                           hdist2=mcfg.hdist2, mid_mask=mcfg.mid_mask_bits,
                           rcomp=mcfg.rcomp)
    table = mm.device_arrays(dev)
    scfg = KScanConfig(k=mcfg.k, mink=mink,
                       mid_mask=mcfg.mid_mask_bits if mcfg.mask_middle else -1,
                       mm=mm.static_params())
    sent = []

    def record(*args):
        sent.append(args[-1])
        return mm_lookup_plain(*args)

    bbduk_scan.mm_lookup = record
    try:
        kscan_combined(scfg, table, bases,
                       torch.from_numpy(batch.lengths).to(dev),
                       mcfg.use_short_kmers and mcfg.ktrim_left,
                       mcfg.use_short_kmers and mcfg.ktrim_right)
    finally:
        bbduk_scan.mm_lookup = mm_lookup
    if len(sent) != 2:
        raise AssertionError(f"B3: the scans sent {len(sent)} key sets, not 2")
    r3, hits = [], []
    for label, q in zip(("full-k", "short-k end"), sent):
        args = (*table, *mm.static_params(), q)
        r = compare(f"B3 mm_lookup {label} keys {tuple(q.shape)} ({mm.n_raw} "
                    f"raw keys, Kp={mm.Kp}, Dp={mm.Dp})",
                    lambda: mm_lookup(*args), lambda: mm_lookup_plain(*args), reps=3)
        # one int8 multiply-add per (query, column, one-hot byte), at the
        # int8 tensor-core rate
        r.update(bound(nbytes(q, *table) + 4 * q.numel(),
                       2 * q.numel() * mm.Dp * mm.Kp, INT8_TC_OPS_S))
        hits.append(int((mm_lookup(*args) > 0).sum().item()))
        print(f"B3 mm_lookup {label}: {hits[-1]} of {q.numel()} queries hit "
              f"(Dp={mm.Dp})")
        if hits[-1] == 0:
            raise AssertionError(f"B3: no {label} query hit the matcher")
        r["variants_ms"] = mm_variants(label, args)
        r3.append(r)
    # one batch of the main path makes both calls
    b3 = {
        "name": "mm_lookup", "route": "cuda",
        "source": "bbtools_torch/csrc/mm_match.cu",
        "replaces": "bbtools_tpu/ops/mm_match.py:386",
        "max_abs_err": max(r["max_abs_err"] for r in r3),
        "ms": sum(r["ms"] for r in r3), "plain_ms": sum(r["plain_ms"] for r in r3),
        "bound_ms": sum(r["bound_ms"] for r in r3), "bound_by": r3[0]["bound_by"],
        "library_ms": None, "redesigned": True,
        "variants_ms": {v: sum(r["variants_ms"][v] for r in r3) for v in MM_VARIANTS},
        "Dp": mm.Dp, "queries": [q.numel() for q in sent], "hits": hits,
    }
    v = b3["variants_ms"]
    print(f"B3 one batch (both calls): kernel {b3['ms']:.4f} ms, bound "
          f"{b3['bound_ms']:.4f} ms ({b3['bound_ms'] / b3['ms']:.3f} of it); in turns "
          f"in this call: main {v['main']:.4f} ms, the original dp4a kernel {v['dp4a']:.4f} ms "
          f"({v['dp4a'] / v['main']:.2f}x); max-only epilogue {v['max_only']:.4f} ms, "
          f"one-column epilogue {v['one_column']:.4f} ms; half the query tile "
          f"{v['half_tile']:.4f} ms")

    # B5 and B6 on one BBMerge batch: the insert scan, and the efilter's
    # probCorrect4 lookup of r1's quality plane
    from bbtools_torch.io.fastq import paired_reader

    b1m, b2m = list(paired_reader(pair1, pair2, batch_reads=MERGE_BATCH))[0]
    a = torch.from_numpy(b1m.bases).to(dev)
    b_rc = torch.from_numpy(_rc_batch(b2m)).to(dev)
    al = torch.from_numpy(b1m.lengths.astype(np.int32)).to(dev)
    bl = torch.from_numpy(b2m.lengths.astype(np.int32)).to(dev)
    min0 = 12  # the default preset's minInsert0
    D = int((b1m.lengths.astype(np.int64) + b2m.lengths).max() - min0 + 1)
    r5 = compare(f"B5 overlap_scan ({a.shape[0]} pairs, L={a.shape[1]}, D={D})",
                 lambda: torch.stack(overlap_counts(a, b_rc, al, bl, min0, D)),
                 lambda: torch.stack(overlap_counts_plain(a, b_rc, al, bl, min0, D)),
                 reps=5, graph=True)
    r5.update(b5_timings(a, b_rc, al, bl, min0, D))
    b5 = {
        "name": "overlap_scan", "route": "cuda",
        "source": "bbtools_torch/csrc/overlap_scan.cu",
        "replaces": "bbtools_tpu/ops/overlap_pallas.py:40",
        "redesigned": True,
        **r5,
    }
    pc4t = torch.from_numpy(lane_table.pack_table(PROB_CORRECT4)).to(dev)
    qidx = torch.clamp(torch.from_numpy(b1m.quals).to(dev).to(torch.int32), max=59)
    qidx = qidx.contiguous()
    r6 = compare(f"B6 lane_table (pc4, {tuple(qidx.shape)} phred)",
                 lambda: lane_table.lookup(pc4t, qidx).view(torch.int32),
                 lambda: lane_table.lookup_plain(pc4t, qidx).view(torch.int32), graph=True)
    # a range test and a select per index
    r6.update(bound(nbytes(pc4t, qidx) + 4 * qidx.numel(), 2 * qidx.numel(), INT32_OPS_S))
    r6.update(b6_timings(pc4t, qidx, r6["bound_ms"]))
    # the same indices one element off 16-byte alignment, and one more
    for shift, extra in ((1, 0), (0, 1)):
        buf = torch.zeros(qidx.numel() + shift + extra, dtype=torch.int32, device=dev)
        view = buf[shift:]
        view[: qidx.numel()] = qidx.reshape(-1)
        if not torch.equal(lane_table.lookup(pc4t, view), lane_table.lookup_plain(pc4t, view)):
            raise AssertionError(f"B6: an index view at offset {shift}, n={view.numel()} differs")
    print("B6 lane_table at a 4-byte offset and at n + 1: exact=True")
    b6 = {
        "name": "lane_table", "route": "cuda",
        "source": "bbtools_torch/csrc/lane_table.cu",
        "replaces": "bbtools_tpu/ops/lane_table.py:27",
        "redesigned": True, **r6,
    }
    return [b1, b2, b3, b5, b6]


def b5_timings(a, b_rc, al, bl, min0: int, D: int) -> dict:
    """B5 beside the first port's kernel (the variant "byte"), in turns
    in a CUDA graph on the batch; the batch with codes drawn from 0..255 (every
    pair compares 8 planes) held against the plain version; the SASS of
    the kernel's word loops; and its bounds: bytes (the inputs and the
    three output planes), the SASS instructions of the 3-plane word loop
    times the 32-position words the batch's windows need (ceil(olen /
    32) an insert; null where the toolkit has no cuobjdump), and, kept
    beside them, the first port's count of 4 int32 operations per
    overlapped position."""
    import torch

    from bbtools_torch.kernels import build
    from bbtools_torch.ops.overlap_scan import (VARIANTS, overlap_counts,
                                                overlap_counts_plain, overlap_counts_variant)

    want = overlap_counts_plain(a, b_rc, al, bl, min0, D)
    for name in VARIANTS:
        for g, w in zip(overlap_counts_variant(name, a, b_rc, al, bl, min0, D), want):
            if not torch.equal(g, w):
                raise AssertionError(f"B5: the {name} variant differs on the batch")
    ms = graph_turns({name: (lambda f=name: overlap_counts_variant(f, a, b_rc, al, bl, min0, D))
                      for name in VARIANTS})
    gen = torch.Generator(device="cpu").manual_seed(5)
    wide = [torch.randint(0, 256, a.shape, generator=gen, dtype=torch.uint8).to(a.device)
            for _ in range(2)]
    wide[1][:, ::2] = wide[0][:, ::2]  # equal codes at every other position
    got = overlap_counts(wide[0], wide[1], al, bl, min0, D)
    for g, w in zip(got, overlap_counts_plain(wide[0], wide[1], al, bl, min0, D)):
        if not torch.equal(g, w):
            raise AssertionError("B5: codes 0..255 differ from the plain version")
    print("B5 overlap_scan on codes 0..255 (8 planes): exact=True")
    loops = sass_innermost_loops(build.library_path(), "overlap_bits_kernel", "POPC")
    per_word = min(loops) if loops else None
    olen = want[2].to(torch.int64)
    words = int(((olen + 31) // 32).sum().item())
    nbytes_ = nbytes(a, b_rc, al, bl) + 3 * 4 * a.shape[0] * D
    r = bound(nbytes_, (per_word or 0) * words, INSTR_S)
    if per_word is None:
        r["ops"] = None  # not counted in this run: the bound is the bytes'
    old = bound(nbytes_, 4 * int(olen.sum().item()), INT32_OPS_S)
    r.update(ms=ms["main"], variants_ms={"byte": ms["byte"]}, sass_word_loops=loops,
             words=words, bound_ops_old_ms=old["bound_ms"], library_ms=None)
    print(f"B5 SASS: the word loops of overlap_bits_kernel hold {loops} instructions "
          f"(3 and 8 planes){'' if loops else ' (no cuobjdump: no instruction bound)'}; "
          f"{words} words of 32 positions in the batch's windows")
    print(f"B5 in turns in a graph: bit-sliced kernel {ms['main']:.4f} ms, the first port's "
          f"byte kernel {ms['byte']:.4f} ms ({ms['byte'] / ms['main']:.2f}x); bound {r['bound_ms']:.4f} ms "
          f"({r['bound_by']}: {nbytes_} bytes, {r['ops']} instructions; "
          f"{r['bound_ms'] / ms['main']:.3f} of it); the first port's operations bound "
          f"{old['bound_ms']:.4f} ms")
    return r


#: B6's timed functions: the kernel, its original kernel (a measurement
#: variant) and one PyTorch call computing the same function
B6_TIMED = ("main", "scalar", "table[idx]")
#: copies of B6's indices that the cold timing cycles through: with their
#: outputs, 8 x 16.8 MB overflow the 50 MB L2, so each call reads HBM
B6_COLD_COPIES = 8


def b6_timings(pc4t, qidx, bound_ms: float) -> dict:
    """B6, its original kernel and `table[idx]`, each timed in a CUDA
    graph in turns (in the order of B6_TIMED and back): L2-warm (every
    call on the same indices) and cold (cycling through B6_COLD_COPIES
    copies, the outputs kept); and back to back. The kernel's `ms` and
    `library_ms` are the cold times, the ones held against the HBM bound."""
    from bbtools_torch.ops import lane_table

    flat = pc4t.reshape(-1)
    fns = {"main": lambda i: lane_table.lookup_variant("main", pc4t, i),
           "scalar": lambda i: lane_table.lookup_variant("scalar", pc4t, i),
           "table[idx]": lambda i: flat[i]}
    copies = [qidx.clone() for _ in range(B6_COLD_COPIES)]
    t = {f: {"warm": [], "cold": [], "eager": []} for f in B6_TIMED}
    for order in (B6_TIMED, B6_TIMED[::-1]):
        for f in order:
            t[f]["warm"].append(graph_ms(lambda: fns[f](qidx)))
            t[f]["cold"].append(graph_ms(fns[f], inputs=copies))
            t[f]["eager"].append(cuda_ms(lambda: fns[f](qidx), 20))
    ms = {f: {m: sum(v) / len(v) for m, v in d.items()} for f, d in t.items()}
    for f, d in ms.items():
        print(f"B6 {f}: cold {d['cold']:.4f} ms ({bound_ms / d['cold']:.3f} of the "
              f"{bound_ms:.4f} ms HBM bound), L2-warm {d['warm']:.4f} ms, back to back "
              f"{d['eager']:.4f} ms")
    return {"ms": ms["main"]["cold"], "warm_ms": ms["main"]["warm"],
            "eager_ms": ms["main"]["eager"], "library_ms": ms["table[idx]"]["cold"],
            "variants_ms": ms}


def b4_equal(label: str, got, want, lens, Cc: int):
    """B4's outputs against the plain version's: scores, columns and
    states exactly, the planes in shape and on every live cell."""
    import torch

    from bbtools_torch.ops.msa_fill import live_cells

    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"B4 {label}: {g.shape}/{g.dtype} vs {w.shape}/{w.dtype}")
    for g, w in zip(got[:3], want[:3]):
        if not torch.equal(g, w):
            raise AssertionError(f"B4 {label}: a score, column or state differs")
    live = live_cells(lens, got[3].shape[2] - 1, Cc)
    if bool(((got[3] != want[3]) & live).any()):
        raise AssertionError(f"B4 {label}: a live plane byte differs")
    return int(live.sum().item())


@functools.cache
def sass_text(lib: str) -> str | None:
    """The built library's SASS as cuobjdump prints it, read once a
    library (~10 s a run on the card's host); None where the toolkit has
    no cuobjdump."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return None
    return subprocess.run([tool, "-sass", lib], capture_output=True, text=True,
                          check=True).stdout


def sass_loops(lib: str, kernel: str) -> list[tuple[int, int, list[str]]] | None:
    """The loops of `kernel` (a substring of its mangled name) in the
    built library's SASS, read with cuobjdump: (first address, address
    of the backward branch, the instructions between, NOPs left out) for
    each backward branch. None where the toolkit has no cuobjdump."""
    import re

    sass = sass_text(lib)
    if sass is None:
        return None
    body = None
    for chunk in sass.split("Function : ")[1:]:
        if kernel in chunk.split("\n", 1)[0]:
            body = chunk
    if body is None:
        raise AssertionError(f"no function {kernel} in the SASS of {lib}")
    ins = [(int(a, 16), t) for a, t in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]
    ins = [(a, t) for a, t in ins if not t.strip().startswith("NOP")]
    loops = []
    for a, t in ins:
        m = re.search(r"\bBRA(?:\.[A-Z.]+)?\s+(?:!?U?P[T0-9]+\s*,\s*)?(?:`\()?(0x[0-9a-f]+)", t)
        if m and int(m.group(1), 16) <= a:
            lo = int(m.group(1), 16)
            loops.append((lo, a, [x for y, x in ins if lo <= y <= a]))
    return loops


def sass_loop_instructions(lib: str, kernel: str) -> int | None:
    """Instructions in the body of the largest loop of `kernel`; None
    where the toolkit has no cuobjdump."""
    loops = sass_loops(lib, kernel)
    return max(len(b) for _, _, b in loops) if loops else None


def sass_innermost_loops(lib: str, kernel: str, opcode: str) -> list[int] | None:
    """Instruction counts of the innermost loops of `kernel` (no other
    loop inside them) that hold `opcode`, smallest first; None where the
    toolkit has no cuobjdump."""
    import re

    loops = sass_loops(lib, kernel)
    if loops is None:
        return None
    inner = [b for lo, hi, b in loops
             if not any((lo, hi) != (l2, h2) and lo <= l2 and h2 <= hi for l2, h2, _ in loops)]
    return sorted(len(b) for b in inner
                  if any(re.search(rf"\b{opcode}\b", t) for t in b))


#: the warp kernel's slices per lane at the main path's read length (151
#: bases: 152 rows, 5 slices of 32)
B4_MAIN_SLICES = 5


#: reference path -> its BBMap index, built once for fused_windows
WINDOW_INDEX: dict = {}


def fused_windows(ref_fa: str, batch_fq: str):
    """The fill tasks that the port's fused phase prepares for the first
    batch of `batch_fq` against `ref_fa` on the card (the index built once
    a reference, WINDOW_INDEX): (the BBMap tool,
    the batch's reads and padded length, window class -> its (reads,
    lens, refs), the last three of the class's fill arguments)."""
    from bbtools_torch.models.bbmap import BBMap, parse_args

    tool = BBMap(parse_args([f"ref={ref_fa}", f"in={batch_fq}", "device=cuda"]),
                 index=WINDOW_INDEX.get(ref_fa))
    WINDOW_INDEX[ref_fa] = tool.index
    batch = list(tool._read_batches(batch_fq))[0]
    lengths = batch.lengths.astype(np.int64)
    B, L = batch.bases.shape
    cand = tool.candidates_for_batch(batch.bases, lengths)
    task = tool._build_tasks(batch.bases, lengths, cand[0], cand[2], cand[5])
    prep = tool._fused_prep(B, L, cand[0], cand[3], cand[4], cand[5], cand[1], *task[:3])
    return tool, B, L, {wc: args[-3:] for (wc, _n), args in zip(prep["args"][3],
                                                                prep["args"][9])}


def check_msa_fill(ref_fa: str, batch_fq: str) -> list[dict]:
    """B4 against its plain version on four task sets: the window-class
    0 and class 3 tasks that the port's fused phase prepares for one
    4,096-read batch (`batch_fq` holds exactly that batch; 128 synthetic
    class-3 tasks if the batch gives none), 4,096 synthetic tasks of
    mixed lengths at R=250, and 4,096 long-read tasks of 150-400 bases,
    whose tasks past 256 rows take the band kernel. Every output is
    compared, plane bytes on live cells, for the wrapper and for each
    kernel over every task. The wrapper's choice is timed in turns with
    the warp kernel, the band kernel over every task and the block
    kernel over every task, on the trimmed rows and over all R rows (the
    fill's first design, whole), the plain version on its compared call;
    the band kernel at each K of BAND_K (`b4_band_k`); then the warp and
    the band kernel at 256 to 2,048 class-0 tasks (`b4_crossover`)."""
    import torch

    from bbtools_torch.kernels import build
    from bbtools_torch.ops.msa_fill import msa_fill, msa_fill_plain, msa_fill_variant

    dev = torch.device("cuda")
    n_ins = sass_loop_instructions(build.library_path(),
                                   f"msa_fill_warp_kernelILi{B4_MAIN_SLICES}E")
    ops_per_cell = n_ins / B4_MAIN_SLICES if n_ins else B4_OPS_PER_CELL
    print(f"B4 SASS: the diagonal loop of the warp kernel at {B4_MAIN_SLICES} slices holds "
          f"{n_ins} instructions: {ops_per_cell:.1f} a cell"
          + ("" if n_ins else f" (no cuobjdump: the recorded {B4_OPS_PER_CELL})"))
    band_ins = {k: sass_loop_instructions(build.library_path(),
                                          f"msa_fill_band_kernelILi{k}E") for k in (1, 8)}
    print(f"B4 SASS: the diagonal loop of the band kernel holds {band_ins[1]} instructions "
          f"at K=1, {band_ins[8]} at K=8")
    tool, B, L, by_wc = fused_windows(ref_fa, batch_fq)
    extras = tool.cfg.window_extras
    print(f"B4 one batch of {B} reads (L={L}): tasks per window class "
          + ", ".join(f"Cc={wc}: {t[0].shape[0]}" for wc, t in sorted(by_wc.items())))
    rng = np.random.default_rng(4)

    def synthetic(S, R, Cc, lmin):
        return tuple(torch.from_numpy(x).to(dev) for x in near_match_tasks(rng, S, R, Cc, lmin))

    c3 = L + extras[3]
    sets = [("class 0 of one batch", by_wc[L + extras[0]])]
    if c3 in by_wc:
        sets.append(("class 3 of that batch", by_wc[c3]))
    else:
        sets.append(("class 3, 128 synthetic tasks", synthetic(128, L, c3, L)))
    sets.append(("mixed lengths 100-250", synthetic(4096, 250, 274, 100)))
    sets.append(("long reads 150-400", synthetic(4096, 400, 424, 150)))
    rows = []
    for label, (reads, lens, refs) in sets:
        S, R = reads.shape
        Cc = refs.shape[1]
        before = (msa_fill.launches, msa_fill.band_launches, msa_fill.block_launches)
        got = msa_fill(reads, lens, refs)
        ran = [k for k, b, a in zip(("warp", "band", "block"), before, (
            msa_fill.launches, msa_fill.band_launches, msa_fill.block_launches)) if a > b]
        # the plain version timed on the call that is compared (one call:
        # it takes seconds at class 3)
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        want = msa_fill_plain(reads, lens, refs)
        e1.record()
        torch.cuda.synchronize()
        plain_ms = e0.elapsed_time(e1)
        live_bytes = b4_equal(label, got, want, lens, Cc)
        for v in ("warp", "band", "block"):
            b4_equal(f"{label}, {v} kernel", msa_fill_variant(v, reads, lens, refs), want,
                     lens, Cc)
        Rp = got[3].shape[2] - 1
        del got
        fns = {"main": lambda: msa_fill(reads, lens, refs),
               "warp": lambda: msa_fill_variant("warp", reads, lens, refs),
               "band": lambda: msa_fill_variant("band", reads, lens, refs),
               "block": lambda: msa_fill_variant("block", reads, lens, refs),
               "block_untrimmed": lambda: msa_fill_variant("block", reads, lens, refs,
                                                           trim=False)}
        t = {f: [] for f in fns}
        for order in (tuple(fns), tuple(fns)[::-1]):
            for f in order:
                t[f].append(cuda_ms(fns[f], 5))
        ms = {f: sum(v) / len(v) for f, v in t.items()}
        ms["plain"] = plain_ms
        by_k = b4_band_k(label, reads, lens, refs, want, 5)
        del want
        # live cells: rows 0..min(len, R'), columns 0..Cc
        nrows = (lens.clamp(max=Rp).to(torch.int64) + 1).clamp(min=0)
        live = int((nrows * (Cc + 1)).sum().item())
        all_cells = S * (R + Cc - 1) * (R + 1)
        inputs = nbytes(reads, lens, refs) + 12 * S
        r = {"max_abs_err": 0, "ms": ms["main"], "plain_ms": ms["plain"],
             "variants_ms": {f: ms[f] for f in ("warp", "band", "block", "block_untrimmed")},
             "band_k_ms": by_k}
        r.update(bound(inputs + live_bytes, ops_per_cell * live, INSTR_S))
        old = bound(inputs + all_cells, ops_per_cell * all_cells, INSTR_S)
        r.update(label=label, S=S, R=R, R_trimmed=Rp, Cc=Cc, live_cells=live,
                 all_cells=all_cells, bound_all_cells_ms=old["bound_ms"],
                 chain_floor_ms=chain_floor_ms(Rp, Cc, ops_per_cell), route=ran,
                 gcells_s=live / ms["main"] / 1e6)
        print(f"B4 {label} (S={S}, R={R} trimmed to {Rp}, Cc={Cc}): exact on outputs and "
              f"{live_bytes} live plane bytes; the wrapper ({' + '.join(ran)}) "
              f"{ms['main']:.4f} ms ({ms['main'] / ms['block']:.3f} of the block kernel): the "
              f"warp kernel {ms['warp']:.4f} ms, the band kernel {ms['band']:.4f} ms, the block "
              f"block kernel {ms['block']:.4f} ms trimmed, {ms['block_untrimmed']:.4f} ms over "
              f"all R rows; plain {ms['plain']:.2f} ms; bound {r['bound_ms']:.4f} ms on {live} "
              f"live cells ({r['bound_ms'] / ms['main']:.3f} of it), chain floor "
              f"{r['chain_floor_ms']:.4f} ms, {old['bound_ms']:.4f} ms on {all_cells} cells of "
              f"the old R x nd count")
        rows.append(r)
    if rows[0]["route"] != ["warp"] or rows[3]["route"] != ["warp", "band"]:
        raise AssertionError("B4: class 0 did not take the warp kernel alone, or the long "
                             "reads' tasks past 256 rows not the band kernel")
    crossover = b4_crossover(synthetic, L, L + extras[0])
    del tool

    def row(name: str, r: dict, ms: float) -> dict:
        return {"name": name, "route": "cuda", "source": "bbtools_torch/csrc/msa_fill.cu",
                "replaces": "bbtools_tpu/ops/msa_pallas.py:97", "redesigned": True,
                "ops_per_cell": ops_per_cell, "max_abs_err": 0, "ms": ms,
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "bound_all_cells_ms": r["bound_all_cells_ms"],
                "chain_floor_ms": r["chain_floor_ms"], "variants_ms": r["variants_ms"],
                "library_ms": None, "set": r["label"]}

    # two of the main path's kernels, each on the class it takes: the warp
    # kernel class 0, the block kernel class 3 (`few_task_route`: too
    # few tasks for warps, too few rows for bands); the band kernel's row
    # is mapPacBio's widest class (`check_b4_long`)
    return [{**row("msa_fill", rows[0], rows[0]["ms"]), "sass_loop_instructions": n_ins,
             "band_sass_loop_instructions": band_ins, "sets": rows,
             "crossover_ms": crossover},
            {**row("msa_fill_block", rows[1], rows[1]["ms"]), "route_taken": rows[1]["route"]}]


def chain_floor_ms(Rp: int, Cc: int, ops_per_cell: float) -> float:
    """The least time of a fill's chain of R' + Cc - 1 dependent diagonal
    steps (2..R'+Cc): each step a slice's diagonal-loop body, issued by
    one warp at most one instruction a clock at 1.98 GHz. Beside the
    operations bound, which spreads the cells over every scheduler."""
    return 1e3 * (Rp + Cc - 1) * ops_per_cell / 1.98e9


def b4_band_k(label: str, reads, lens, refs, want, reps: int) -> dict:
    """The band kernel over every task at each K of BAND_K, each exact
    against the plain version's outputs `want`, timed in turns: where the
    wrapper's K (`band_plan`) stands."""
    import torch

    from bbtools_torch.ops.msa_fill import BAND_K, band_k, msa_fill_variant

    for k in BAND_K:
        b4_equal(f"{label}, band kernel K={k}",
                 msa_fill_variant("band", reads, lens, refs, k=k), want, lens, refs.shape[1])
    t = {k: [] for k in BAND_K}
    for order in (BAND_K, BAND_K[::-1]):
        for k in order:
            t[k].append(cuda_ms(lambda: msa_fill_variant("band", reads, lens, refs, k=k), reps))
    out = {k: sum(v) / len(v) for k, v in t.items()}
    Rp = want[3].shape[2] - 1
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"B4 {label}: the band kernel over all {reads.shape[0]} tasks by K (the plan picks "
          f"K={band_k(Rp + 1, reads.shape[0], sms)}): "
          + ", ".join(f"K={k} {v:.4f} ms" for k, v in out.items()))
    return out


#: task counts at which the B4 kernels are timed on class-0 shapes,
#: around the wrapper's choice (WARP_MIN_TASKS_PER_SM tasks an SM)
B4_CROSSOVER_TASKS = (256, 512, 768, 1056, 1536, 2048)


def b4_crossover(synthetic, R: int, Cc: int) -> dict:
    """The warp kernel, the band kernel (the plan's K) and the block
    kernel over the same tasks (reads of up to 151 bases in rows of R,
    windows of Cc), in turns, at each of B4_CROSSOVER_TASKS: where the
    warp kernel starts to win; then the band and the block kernel at
    B4_FEW_TASK_SHAPES: where `few_task_route` keeps a call on the block
    kernel."""
    import torch

    from bbtools_torch.ops.msa_fill import (WARP_MIN_TASKS_PER_SM, few_task_route,
                                            msa_fill_variant)

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    kernels = ("warp", "band", "block")
    for S in B4_CROSSOVER_TASKS:
        reads, lens, refs = synthetic(S, R, Cc, 151)
        lens.clamp_(max=151)
        reads[torch.arange(R, device=reads.device)[None, :] >= lens[:, None]] = 4
        want = msa_fill_variant("warp", reads, lens, refs)[0]
        for v in kernels[1:]:
            if not torch.equal(msa_fill_variant(v, reads, lens, refs)[0], want):
                raise AssertionError(f"B4 crossover S={S}: the {v} kernel's scores differ")
        t = {v: [] for v in kernels}
        for v in kernels + kernels[::-1]:
            t[v].append(cuda_ms(lambda: msa_fill_variant(v, reads, lens, refs), 5))
        out[S] = {v: sum(x) / len(x) for v, x in t.items()}
    print(f"B4 warp / band / block kernel by tasks (class-0 shapes; the wrapper takes the "
          f"warp kernel from {WARP_MIN_TASKS_PER_SM * sms} tasks): "
          + ", ".join(f"S={S} {t['warp']:.4f} / {t['band']:.4f} / {t['block']:.4f} ms"
                      for S, t in out.items()))
    few = {}
    for S, rows in B4_FEW_TASK_SHAPES:
        Cc = rows + B4_FEW_TASK_EXTRA
        reads, lens, refs = synthetic(S, rows - 1, Cc, rows - 12)
        want = msa_fill_variant("block", reads, lens, refs)[0]
        if not torch.equal(msa_fill_variant("band", reads, lens, refs)[0], want):
            raise AssertionError(f"B4 few tasks S={S} rows={rows}: the band kernel's scores "
                                 f"differ")
        t = {v: [] for v in ("band", "block")}
        for v in ("band", "block", "block", "band"):
            t[v].append(cuda_ms(lambda: msa_fill_variant(v, reads, lens, refs), 3))
        few[f"{S}x{rows}"] = {v: sum(x) / len(x) for v, x in t.items()}
        few[f"{S}x{rows}"]["route"] = few_task_route(int(lens.max()) + 1, S, sms)
    print(f"B4 band / block kernel on few-task calls (tasks x rows, windows of rows + "
          f"{B4_FEW_TASK_EXTRA} columns; the wrapper's pick in brackets): "
          + ", ".join(f"{k} {t['band']:.4f} / {t['block']:.4f} ms [{t['route']}]"
                      for k, t in few.items()))
    return {"warp_by_tasks": out, "few_tasks": few}


#: (tasks, rows) of the few-task calls at which the band and the block
#: kernel are timed: where `few_task_route` draws its line
B4_FEW_TASK_SHAPES = tuple((S, rows) for S in (4, 28, 128) for rows in (152, 320, 600, 1000))
#: their windows' columns past the rows (a class-3 window of short reads)
B4_FEW_TASK_EXTRA = 2072


def counters():
    """Each kernel's launch count: (the object that holds it, its name)."""
    from bbtools_torch.ops import lane_index, lane_table, mm_match, msa_fill, overlap_scan, scan

    return {
        "lane_lookup": (lane_index.lane_lookup, "launches"),
        "cummax_i64": (scan.cummax_i64, "launches"),
        "mm_lookup": (mm_match.mm_lookup, "launches"),
        "mm_best": (mm_match.mm_best, "launches"),
        "overlap_scan": (overlap_scan.overlap_counts, "launches"),
        "lane_table": (lane_table.lookup, "launches"),
        "msa_fill": (msa_fill.msa_fill, "launches"),
        "msa_fill_band": (msa_fill.msa_fill, "band_launches"),
        "msa_fill_block": (msa_fill.msa_fill, "block_launches"),
    }


def b4_total(got: dict) -> int:
    """B4's launches in a path's counts: the warp, band and block kernels."""
    return got["msa_fill"] + got["msa_fill_band"] + got["msa_fill_block"]


def b4_routes(got: dict) -> str:
    return (f"{got['msa_fill']} (warp), {got['msa_fill_band']} (band), "
            f"{got['msa_fill_block']} (block)")


def run_path(name: str, fn, needs: tuple[str, ...], launches: dict):
    """Run one path with every launch counter set to 0 just before it;
    fail unless each kernel in `needs` launched, and record the first
    path's count of each kernel in `launches`. Returns (fn's result, the
    path's counts)."""
    for obj, attr in counters().values():
        setattr(obj, attr, 0)
    result = fn()
    got = {k: getattr(obj, attr) for k, (obj, attr) in counters().items()}
    print(f"launches on the {name} path: {got}")
    for k in needs:
        if got[k] <= 0:
            raise AssertionError(f"{k} never launched on the {name} path")
        launches.setdefault(k, got[k])
    return result, got


def bbduk_argv(name: str, flags: list[str], fin: str, work: str, device: str):
    """bbduk's argv on `device` and its output files (out=, stats=)."""
    out = os.path.join(work, f"{name}.{device}.fq")
    stats = os.path.join(work, f"{name}.{device}.stats.txt")
    return (["bbduk", f"in={fin}", f"out={out}", f"stats={stats}", f"device={device}",
             *flags], [out, stats])


def bbmerge_argv(fin: list[str], work: str, tag: str, device: str, flags=()):
    """bbmerge's argv on `device` and its output files (out=, outu1=,
    outu2=, ihist=)."""
    outs = [os.path.join(work, f"merge.{tag}.{device}.{x}")
            for x in ("merged.fq", "u1.fq", "u2.fq", "ihist.txt")]
    return (["bbmerge", f"in1={fin[0]}", f"in2={fin[1]}", f"out={outs[0]}",
             f"outu1={outs[1]}", f"outu2={outs[2]}", f"ihist={outs[3]}", f"device={device}",
             *flags], outs)


def run_bbduk(name: str, flags: list[str], fin: str, work: str, device: str,
              showtimes: bool = False) -> tuple[str, str, float, str]:
    from bbtools_torch.cli import main as cli_main

    argv, (out, stats) = bbduk_argv(name, flags, fin, work, device)
    argv += ["showtimes=t"] if showtimes else []
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        cli_main(argv)
    return out, stats, time.perf_counter() - t0, err.getvalue()


def run_bbmerge(fin: list[str], work: str, tag: str, device: str):
    from bbtools_torch.cli import main as cli_main

    argv, outs = bbmerge_argv(fin, work, tag, device)
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        cli_main(argv)
    return outs, time.perf_counter() - t0, err.getvalue()


def placed_share(sam: str) -> tuple[int, float]:
    """(mapped primary records, the share of them whose POS lies within
    20 bp of the read's true start, which synth writes into its name)."""
    from bbtools_torch.utils.synth import parse_truth

    mapped = placed = 0
    with open(sam, "rb") as fh:
        for line in fh:
            if line.startswith(b"@"):
                continue
            f = line.split(b"\t", 4)
            flag = int(f[1])
            if flag & 0x904 or not f[0].startswith(b"r"):
                continue
            mapped += 1
            _scaf, pos, _strand = parse_truth(f[0])
            placed += abs(int(f[3]) - 1 - pos) <= 20
    return mapped, placed / max(mapped, 1)


def plant_variants(codes, rng):
    """The copy of `codes` with SNPs at ASM_SNP_RATE and ASM_INDELS indels
    of 1-10 bp (half insertions), at least 200 bp apart. Returns the
    copy and the truth: {(pos0, "SUB"|"INS"|"DEL")} in the original's
    coordinates (an insertion goes before pos0, a deletion starts
    there)."""
    n = len(codes)
    snp = np.flatnonzero(rng.random(n) < ASM_SNP_RATE)
    out = codes.copy()
    out[snp] = (out[snp] + rng.integers(1, 4, len(snp))) % 4
    truth = {(int(p), "SUB") for p in snp}
    sites = np.sort(rng.choice(np.arange(1000, n - 1000, 200), ASM_INDELS, replace=False))
    parts, prev = [], 0
    for i, p in enumerate(sites):
        ln = int(rng.integers(1, 11))
        if i % 2:
            parts += [out[prev:p], rng.integers(0, 4, ln).astype(np.uint8)]
            prev = p
            truth.add((int(p), "INS"))
        else:
            parts.append(out[prev:p])
            prev = p + ln
            truth.add((int(p), "DEL"))
        # a SNP inside a deleted span is no variant of the copy
        truth -= {(int(q), "SUB") for q in range(p, p + ln)} if i % 2 == 0 else set()
    parts.append(out[prev:])
    return np.concatenate(parts), truth


def make_asm_data(work: str, seed: int) -> dict:
    """The config #2/#5 data set (ASM_* above), written as FASTA and
    gzipped FASTQ, with the heads the phases take."""
    from bbtools_torch.core.dna import CODE_TO_BASE
    from bbtools_torch.io.fasta import load_reference, write_fasta
    from bbtools_torch.utils.synth import parse_truth, random_genome, random_reads, write_reads

    rng = np.random.default_rng(seed)
    d = {k: os.path.join(work, f"asm_{k}") for k in (
        "ref.fa", "copy.fa", "reads.fq.gz", "kce93.fq.gz", "head.fq.gz", "cv.fq.gz",
        "region.fq.gz", "ecc.fq.gz", "cms_ecc.fq.gz")}
    write_fasta(d["ref.fa"], random_genome(ASM_GENOME, seed=seed))
    codes = load_reference(d["ref.fa"]).scaffold_codes(0)
    copy, d["truth"] = plant_variants(codes, rng)
    write_fasta(d["copy.fa"], [(b"copy", CODE_TO_BASE[np.minimum(copy, 4)].tobytes())])
    reads = random_reads(load_reference(d["copy.fa"]), ASM_READS, read_len=ASM_READ_LEN,
                         snp_rate=ASM_ERR, seed=seed + 1)
    write_reads(d["reads.fq.gz"], reads)
    write_reads(d["kce93.fq.gz"], reads[:KCE93_READS])
    write_reads(d["head.fq.gz"], reads[:CHECK_READS])
    write_reads(d["cv.fq.gz"], reads[:CV_READS])
    region = [r for r in reads if parse_truth(r[0])[1] + ASM_READ_LEN <= ASM_REGION]
    write_reads(d["region.fq.gz"], region)
    write_reads(d["ecc.fq.gz"], region[:ECC_CHECK_READS])
    write_reads(d["cms_ecc.fq.gz"], region[:CMS_ECC_READS])
    d["region_reads"] = len(region)
    d["copy_codes"] = copy
    d["depth31"] = (ASM_READS * ASM_READ_LEN / len(copy) * (ASM_READ_LEN - 30)
                    / ASM_READ_LEN * (1 - ASM_ERR) ** 31)
    return d


def device_calls() -> dict:
    """The device routes of the k-mer counts, the count-min sketch's adds
    and queries, the A8a tools' device ops, the glocal identity aligner,
    the quality trim, the substitution-only searches, CellNet's training
    and forward pass and calibrate's fit: calls on CUDA tensors."""
    from bbtools_torch.ml.cellnet import CellNet
    from bbtools_torch.models import (bbnorm, clumpify, findprimers, indelfree, loglog,
                                      research, seal)
    from bbtools_torch.ops import banded, cms, idalign, kmer_count, kmers2, trim

    return {"merge_spectra": kmer_count.merge_spectra.device_calls,
            "sort_reduce": kmer_count.sort_reduce.device_calls,
            "count_words": kmers2.count_words.device_calls,
            "cms_add": cms.cms_add.device_calls,
            "seal_votes": seal.seal_votes.device_calls,
            "read_depths": bbnorm.read_depths.device_calls,
            "loglog_update": loglog.loglog_update.device_calls,
            "banded_edits": banded.banded_edits.device_calls,
            "pivot_kmers": clumpify._pivot_kmers_t.device_calls,
            "glocal_identity": idalign.glocal_identity.device_calls,
            "optimal_trim": trim.optimal_trim.device_calls,
            "best_sites": findprimers.best_sites.device_calls,
            "indelfree_search": indelfree._device_search.device_calls,
            "cms_query": cms.cms_query.device_calls,
            "net_fit": CellNet.fit.device_calls,
            "net_forward": CellNet.forward.device_calls,
            "calibrate_fit": research.calibrate_fit.device_calls}


def cli_call(argv: list[str], stdout: str | None = None):
    """One CLI run in this process, `argv` = [tool, key=value...]: the
    CLI's output guard, then the tool, its standard output sent to the
    file `stdout` where one is given. Returns what the tool's main
    returns."""
    from bbtools_torch.cli import TOOLS, guard_output_files

    guard_output_files(argv[1:])
    with open(stdout or os.devnull, "w") as fh, contextlib.redirect_stdout(
            fh if stdout else sys.stdout):
        return TOOLS[argv[0]](argv[1:])


#: the attributes of a tool that a check compares besides its files
#: (BBMerge's pairs near the nn=t cutoff, BBMap's prescreened reads)
REPORTED = ("nn_near", "prescreened")


def write_report(res, path: str):
    """The REPORTED attributes that `res` has, as JSON in `path` (read
    names as latin-1 text)."""
    rep = {}
    for name in REPORTED:
        if hasattr(res, name):
            v = getattr(res, name)
            rep[name] = ([x.decode("latin-1") for x in v] if isinstance(v, (list, set))
                         else v)
    with open(path, "w") as fh:
        json.dump(rep, fh, default=str)


def run_tool(tool: str, argv: list[str], device: str):
    """`tool` through the CLI's output guard and dispatch on `device`:
    (what its main returns, wall seconds, its stderr)."""
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        res = cli_call([tool, *argv, f"device={device}"])
    return res, time.perf_counter() - t0, err.getvalue()


class Check(NamedTuple):
    """One side of a CUDA-against-CPU check: the CLI argv without its
    device=, the files compared, and the file its standard output goes
    to (None: the tool writes its files itself)."""
    argv: list
    outs: list
    stdout: str | None = None


def run_routed(name: str, tool: str, argv: list[str], needs: dict):
    """run_tool on cuda, requiring each device route in `needs` to be
    called exactly that many times (None: at least once) in the run."""
    return routed(name, lambda: run_tool(tool, argv, "cuda"), needs)


def routed(name: str, fn, needs: dict):
    """fn(), requiring each device route in `needs` to be called exactly
    that many times (None: at least once) in the call."""
    before = device_calls()
    res = fn()
    got = {k: v - before[k] for k, v in device_calls().items()}
    print(f"device calls on the {name} path: {got}")
    for k, n in needs.items():
        if got[k] <= 0 if n is None else got[k] != n:
            raise AssertionError(f"{name}: {k} called {got[k]} times on the card")
    return res


def kmer_recall(contigs: list[bytes], codes, k: int = 31) -> float:
    """Share of the distinct canonical k-mers of `codes` found in the
    contigs."""
    from bbtools_torch.core.dna import BASE_TO_CODE
    from bbtools_torch.ops.kmers import rolling_kmers_np

    def keys(c):
        fwd, rkm, run = rolling_kmers_np(np.asarray(c, np.uint8)[None, :], k)
        return np.unique(np.maximum(fwd, rkm)[run >= k])

    want = keys(codes)
    got = [keys(BASE_TO_CODE[np.frombuffer(c, np.uint8)]) for c in contigs if len(c) >= k]
    got = np.unique(np.concatenate(got)) if got else np.zeros(0, np.int64)
    return float(np.isin(want, got).mean())


def vcf_grade(path: str, truth: set) -> dict:
    """PASS rows of a VCF against the planted variants: SNPs by position,
    indels by type within 10 bp (an indel in a repeat may be placed
    anywhere in it)."""
    rows = []
    with open(path, "rb") as fh:
        for line in fh:
            if line.startswith(b"#"):
                continue
            f = line.split(b"\t")
            if f[6] != b"PASS":
                continue
            typ = f[7].split(b"TYP=")[1].split(b";")[0].decode()
            pos0 = int(f[1]) - (1 if typ == "SUB" else 0)
            rows.append((pos0, typ))
    found, false = set(), 0
    for pos0, typ in rows:
        hits = [t for t in ((pos0, typ),) if t in truth] if typ == "SUB" else [
            (p, typ) for p in range(pos0 - 10, pos0 + 11) if (p, typ) in truth]
        found.update(hits)
        false += not hits
    out = {"called": len(rows), "false": false}
    for typ in ("SUB", "INS", "DEL"):
        n = sum(t == typ for _, t in truth)
        out[typ] = (sum(t == typ for _, t in found), n)
    return out


def clip_indels(src: str, dst: str, n: int) -> int:
    """The header and first n records of SAM src, written to dst with each
    record whose CIGAR holds an insertion or a deletion soft-clipped from
    its first indel on, as a mapper that clips rather than opening a gap
    writes them: the reads realign=t exists for. Returns how many were
    clipped."""
    clipped = kept = 0
    with open(src, "rb") as fi, open(dst, "wb") as fo:
        for line in fi:
            if not line.startswith(b"@"):
                kept += 1
                if kept > n:
                    break
                f = line.split(b"\t")
                ops = re.findall(rb"(\d+)([MIDNSHP=X])", f[5])
                cut = next((i for i, (_, op) in enumerate(ops) if op in b"ID"), None)
                aligned = cut is not None and any(op in b"M=X" for _, op in ops[:cut])
                if aligned:
                    tail = sum(int(x) for x, op in ops[cut:] if op in b"MIS=X")
                    f[5] = b"".join(x + op for x, op in ops[:cut]) + b"%dS" % tail
                    line = b"\t".join(f)
                    clipped += 1
            fo.write(line)
    return clipped


def n50(lens) -> int:
    lens = sorted(lens, reverse=True)
    half, acc = sum(lens) / 2, 0
    for x in lens:
        acc += x
        if acc >= half:
            return x
    return 0


def asm_phases(asm: dict, work: str, card: str, phase_s: dict) -> dict:
    """BASELINE configs #2 and #5 through the CLI on device=cuda:
    kmercountexact k=31 (khist, peaks) over the reads and k=93 over their
    head, Tadpole k=62 over the region's reads, BBMap over CV_READS reads
    and CallVariants on its SAM, with defaults and realign=t. Each path's
    device routes must run on the card. Returns the outputs the CUDA
    against CPU checks reuse."""
    # ---- config #2: kmercountexact (DeviceSpectrum; W-word count) ----
    t0 = time.perf_counter()
    kh, pk = (os.path.join(work, f"asm.cuda.{x}") for x in ("khist", "peaks"))
    (spec, dt, _), _ = run_path("kmercountexact k=31", lambda: run_routed(
        "kmercountexact k=31", "kmercountexact",
        [f"in={asm['reads.fq.gz']}", "k=31", f"khist={kh}", f"peaks={pk}"],
        {"merge_spectra": None, "sort_reduce": 0, "count_words": 0}), (), {})
    with open(pk) as fh:
        peaks = [[int(x) for x in ln.split()] for ln in fh if not ln.startswith("#")]
    main_peak = max((r for r in peaks if r[1] >= 5), key=lambda r: r[4])
    asm["kce31_unique"] = spec.n_unique  # loglog's yardstick
    print(f"kmercountexact k=31 device=cuda: {ASM_READS} reads in {dt:.2f} s = "
          f"{ASM_READS / dt:.0f} reads/s (wall, incl. IO) on {card}; "
          f"{spec.n_unique} unique k-mers, spectrum capacity {spec.cap}; main peak "
          f"center {main_peak[1]} (expected depth {asm['depth31']:.1f}), volume "
          f"{main_peak[4]}")
    if abs(main_peak[1] - asm["depth31"]) > 0.2 * asm["depth31"]:
        raise AssertionError(f"kmercountexact: peak at {main_peak[1]}, expected "
                             f"{asm['depth31']:.1f}")
    (spec, dt, _), _ = run_path("kmercountexact k=93", lambda: run_routed(
        "kmercountexact k=93", "kmercountexact",
        [f"in={asm['kce93.fq.gz']}", "k=93", f"khist={kh}.93"],
        {"merge_spectra": 0, "sort_reduce": 0, "count_words": -(-KCE93_READS // BATCH)}),
        (), {})
    print(f"kmercountexact k=93 device=cuda: {KCE93_READS} reads in {dt:.2f} s = "
          f"{KCE93_READS / dt:.0f} reads/s on {card}; {spec.n_unique} unique k-mers")
    phase_s["kmercountexact"] = time.perf_counter() - t0

    # ---- config #5: Tadpole k=62 (micro-assembly of a region) ----
    t0 = time.perf_counter()
    contigs_fa = os.path.join(work, "asm.cuda.contigs.fa")
    (tad, dt, _), _ = run_path("tadpole k=62", lambda: run_routed(
        "tadpole k=62", "tadpole", [f"in={asm['region.fq.gz']}", "k=62",
                                    f"out={contigs_fa}"],
        {"merge_spectra": 0, "sort_reduce": 0, "count_words": None}), (), {})
    lens = [len(c) for c in tad.contigs]
    recall = kmer_recall(tad.contigs, asm["copy_codes"][:ASM_REGION])
    n_in = asm["region_reads"]
    print(f"tadpole k=62 load (count on the card, spectrum): {tad.load_seconds:.2f} s "
          f"for {n_in} reads = {n_in / tad.load_seconds:.0f} reads/s on {card}")
    print(f"tadpole k=62 walk (host): {tad.elapsed - tad.load_seconds:.2f} s on the host "
          f"of {card}")
    print(f"tadpole k=62 device=cuda: {n_in} reads in {dt:.2f} s = {n_in / dt:.0f} "
          f"reads/s (wall) on {card}; {len(lens)} contigs, {sum(lens)} bp, N50 {n50(lens)}, "
          f"longest {max(lens, default=0)}; {recall:.4f} of the region's 31-mers "
          f"in contigs")
    if recall < ASM_RECALL_MIN:
        raise AssertionError(f"tadpole: contigs hold {recall:.4f} of the region")
    # the load at config #5's full size: the tool's own count over every
    # read (the walk above runs on the region's reads only)
    from bbtools_torch.models.tadpole import Tadpole, parse_args

    full = Tadpole(parse_args([f"in={asm['reads.fq.gz']}", "k=62", "device=cuda"]))
    run_path("tadpole k=62 load", lambda: routed(
        "tadpole k=62 load", lambda: full.load_kmers(asm["reads.fq.gz"]),
        {"merge_spectra": 0, "sort_reduce": 0, "count_words": -(-ASM_READS // BATCH)}),
        (), {})
    genomic = len(asm["copy_codes"]) - 61
    solid = int((full.table.counts >= 3).sum())
    print(f"tadpole k=62 load over all {full.reads_in} reads (count on the card, host "
          f"spectrum): {full.load_seconds:.2f} s = {full.reads_in / full.load_seconds:.0f} "
          f"reads/s on {card}; {len(full.table.keys)} distinct 62-mers, {solid} seen 3 "
          f"or more times ({genomic} in the genome)")
    if full.reads_in != ASM_READS or abs(solid - genomic) > 0.03 * genomic:
        raise AssertionError(f"tadpole load: {full.reads_in} reads, {solid} solid 62-mers")
    del full
    phase_s["tadpole"] = time.perf_counter() - t0

    # ---- config #5: BBMap (B4) -> CallVariants, defaults and realign=t ----
    t0 = time.perf_counter()
    cv_sam = os.path.join(work, "asm.cuda.sam")
    (tool, dt, _), _ = run_path(
        "bbmap (config #5)", lambda: run_tool(
            "bbmap", [f"ref={asm['ref.fa']}", f"in={asm['cv.fq.gz']}", f"out={cv_sam}"],
            "cuda"), ("msa_fill",), {})
    print(f"bbmap (config #5) device=cuda: {CV_READS} reads in {dt:.2f} s = "
          f"{CV_READS / dt:.0f} reads/s on {card}; {tool.reads_mapped} mapped")
    from bbtools_torch.ops import msa

    realign_batch = msa.realign_batch
    tasks = []

    def counted(reads, *a, **kw):
        tasks.append(len(reads))
        return realign_batch(reads, *a, **kw)

    for flags in ([], ["realign=t"]):
        vcf = os.path.join(work, f"asm.cuda{''.join(flags)}.vcf")
        msa.realign_batch = counted
        try:
            cv, dt, log = run_tool("callvariants", [f"in={cv_sam}", f"ref={asm['ref.fa']}",
                                                    f"vcf={vcf}", *flags], "cuda")
        finally:
            msa.realign_batch = realign_batch
        g = vcf_grade(vcf, asm["truth"])
        print(f"callvariants {' '.join(flags) or 'defaults'} device=cuda: {cv.reads} "
              f"reads in {dt:.2f} s = {cv.reads / dt:.0f} reads/s on {card}; "
              f"{g['called']} variants called (PASS); recall SNPs "
              f"{g['SUB'][0]}/{g['SUB'][1]}, insertions {g['INS'][0]}/{g['INS'][1]}, "
              f"deletions {g['DEL'][0]}/{g['DEL'][1]}; false calls {g['false']}; "
              f"Realigned {cv.realigned} of {sum(tasks)} reads the gate sent to "
              f"realign_batch ({len(tasks)} calls)")
        indels = [g[t][0] / max(g[t][1], 1) for t in ("INS", "DEL")]
        if (g["SUB"][0] < CV_SNP_RECALL_MIN * g["SUB"][1] or g["false"] > CV_FALSE_MAX
                or min(indels) < CV_INDEL_RECALL_MIN):
            raise AssertionError(f"callvariants: {g}")
        if bool(flags) != bool(tasks):
            raise AssertionError(f"callvariants {flags}: {len(tasks)} realign_batch calls")
    phase_s["bbmap + callvariants"] = time.perf_counter() - t0
    return {"contigs": contigs_fa, "sam": cv_sam}


def asm_checks(asm: dict, work: str, main_out: dict, phase_s: dict):
    """kmercountexact (k=31, k=93: khist, peaks, dump) on CHECK_READS
    reads, Tadpole k=62 on the region's reads (the main phase's contigs
    against a CPU run) and mode=correct on ECC_CHECK_READS of them, and
    CallVariants realign=t and nn=t on CV_CHECK_READS records of the
    main phase's SAM, its indel reads soft-clipped (clip_indels):
    byte-equal on device=cuda and device=cpu (nn=t but for flipped last
    QUAL digits, bbtools_torch.utils.vcfdiff), with the same reads
    realigned, at least one."""
    contigs_fa, cv_sam, n_in = main_out["contigs"], main_out["sam"], asm["region_reads"]
    # ---- CUDA against CPU: kmercountexact, Tadpole, CallVariants ----
    t0 = time.perf_counter()
    side = main_out["cpu_side"]
    for k in (31, 93):
        side.wait(f"kmercountexact k={k} cuda")
        side.wait(f"kmercountexact k={k}")
        files = {d: read_all(kce_check_argv(asm, k, work, d)[1]) for d in ("cuda", "cpu")}
        if files["cuda"] != files["cpu"]:
            raise AssertionError(f"kmercountexact k={k}: cuda and cpu outputs differ")
        print(f"kmercountexact k={k}: cuda == cpu on {CHECK_READS} reads (khist, peaks, "
              f"dump of {len(files['cuda'][2])} bytes)")
    for tag, n in (("contig k=62", n_in), ("correct k=31", ECC_CHECK_READS)):
        files = {}
        if tag.startswith("contig"):
            files["cuda"] = read_all([contigs_fa])  # the main phase's run
        else:
            side.wait(f"tadpole {tag} cuda")
            files["cuda"] = read_all(tadpole_check_argv(asm, tag, work, "cuda")[1])
        dt = side.wait(f"tadpole {tag}")
        files["cpu"] = read_all(tadpole_check_argv(asm, tag, work, "cpu")[1])
        print(f"tadpole {tag} device=cpu: {n} reads in {dt:.2f} s (in a process of its own)")
        if files["cuda"] != files["cpu"]:
            raise AssertionError(f"tadpole {tag}: cuda and cpu outputs differ")
        print(f"tadpole {tag}: cuda == cpu on {n} reads ({len(files['cuda'][0])} bytes)")
    head_sam = os.path.join(work, "asm.head.sam")
    clipped = clip_indels(cv_sam, head_sam, CV_CHECK_READS)
    from bbtools_torch.utils.vcfdiff import qual_flips

    for flags in (["realign=t"], ["nn=t", "minscore=10"]):
        files, realigned = {}, {}
        for device in ("cuda", "cpu"):
            vcf = os.path.join(work, f"head.{flags[0]}.{device}.vcf")
            cv, dt, _ = run_tool("callvariants", [f"in={head_sam}",
                                                  f"ref={asm['ref.fa']}", f"vcf={vcf}",
                                                  *flags], device)
            files[device] = read_all([vcf])[0]
            realigned[device] = cv.realigned
        if flags[0] == "realign=t":
            if files["cuda"] != files["cpu"]:
                raise AssertionError("callvariants realign=t: cuda and cpu VCFs differ")
            if not realigned["cuda"] == realigned["cpu"] > 0:
                raise AssertionError(f"callvariants realign=t: realigned {realigned}")
            print(f"callvariants realign=t: cuda == cpu on {CV_CHECK_READS} SAM records, "
                  f"{clipped} of them soft-clipped from their first indel on "
                  f"({len(files['cuda'])} VCF bytes, {realigned['cuda']} realigned on "
                  f"each device)")
        else:
            flips = qual_flips(files["cuda"], files["cpu"])
            print(f"callvariants nn=t: cuda == cpu on {CV_CHECK_READS} SAM records "
                  f"({len(files['cuda'])} VCF bytes; {flips} rows whose QUAL's last "
                  f"digit flips)")
    phase_s["cuda == cpu, kmercountexact, tadpole, callvariants"] = (
        time.perf_counter() - t0)


def make_bloom_reads(map_fq: str, dst: str, seed: int, n_real: int | None = None):
    """n_real (BLOOM_READS) reads of map_fq's head with a seeded foreign
    read of the same length (random sequence) after every ten."""
    from bbtools_torch.io.fastq import FastqReader

    n_real = BLOOM_READS if n_real is None else n_real
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    ascii_ = np.frombuffer(b"ACGTN", np.uint8)
    recs, real = [], 0
    for b in FastqReader(map_fq):
        for i in range(b.n):
            if real == n_real:
                break
            L = int(b.lengths[i])
            seq = ascii_[np.minimum(b.bases[i, :L], 4)].tobytes()
            recs.append(b"@%s\n%s\n+\n%s\n" % (b.ids[i], seq, bytes(b.quals[i, :L] + 33)))
            real += 1
            if real % 10 == 0:
                junk = acgt[rng.integers(0, 4, L)].tobytes()
                recs.append(b"@junk%d_scaf0_pos0_strand0_insert0\n%s\n+\n%s\n"
                            % (real // 10, junk, b"F" * L))
        if real == n_real:
            break
    with gzip.open(dst, "wb", compresslevel=1) as fh:
        fh.write(b"".join(recs))


def make_pipe_data(asm: dict, work: str, seed: int) -> dict:
    """tadpipe's inputs (PIPE_* above): pairs of the region, of its first
    PIPE_CHECK_BP bp, and of the whole copy, and the heads BBMerge's
    checks take; the region as a FASTA and its reads with foreign ones,
    for bloomfilter's check (the main bloomfilter reads are made in
    main)."""
    copy = asm["copy_codes"]
    d = {}
    for tag, codes, n, s in (("region", copy[:ASM_REGION], PIPE_PAIRS, 0),
                             ("check", copy[:PIPE_CHECK_BP], PIPE_CHECK_PAIRS, 1),
                             ("full", copy, PIPE_FULL_PAIRS, 2)):
        d[tag] = [os.path.join(work, f"pipe_{tag}_{m}.fq.gz") for m in (1, 2)]
        make_pairs(d[tag], n, seed + s, *PIPE_INSERTS, genome=codes, err=ASM_ERR)
        d[tag + "_pairs"] = n
    # bloomfilter's check: the region as the reference, its reads with a
    # foreign read after every ten
    from bbtools_torch.core.dna import CODE_TO_BASE
    from bbtools_torch.io.fasta import write_fasta

    d["region.fq.gz"] = asm["region.fq.gz"]
    d["region.fa"] = os.path.join(work, "pipe_region.fa")
    write_fasta(d["region.fa"], [(b"region", CODE_TO_BASE[copy[:ASM_REGION]].tobytes())])
    d["bloom_check"] = os.path.join(work, "pipe_bloom_check.fq.gz")
    make_bloom_reads(asm["region.fq.gz"], d["bloom_check"], seed + 3,
                     BLOOM_CHECK_READS - BLOOM_CHECK_READS // 11)
    d["merge_check"] = [os.path.join(work, f"pipe_mcheck_{m}.fq.gz") for m in (1, 2)]
    d["ecct_check"] = [os.path.join(work, f"pipe_echeck_{m}.fq.gz") for m in (1, 2)]
    for m in (0, 1):
        head_fastq(d["full"][m], d["merge_check"][m], MERGE_CHECK_PAIRS)
        head_fastq(d["full"][m], d["ecct_check"][m], MERGE_ECCT_CHECK_PAIRS)
    return d


@contextlib.contextmanager
def stage_timer(stage_s: dict):
    """Add the seconds of each stage tadpipe runs in-process into stage_s:
    BBDuk (trim), BBMerge (ecco; merge), Tadpole (correct; each k of the
    wrapper's assembly)."""
    from bbtools_torch.models import bbduk, bbmerge, tadpole

    def label(mod, argv):
        if mod is bbduk:
            return "trim (bbduk)"
        if mod is bbmerge:
            return "ecco (bbmerge)" if "ecco=t" in argv else "merge (bbmerge extend2 ecct)"
        if "mode=correct" in argv:
            return "ecc (tadpole correct)"
        return "assemble " + next(a for a in argv if a.startswith("k="))

    saved = {m: m.main for m in (bbduk, bbmerge, tadpole)}

    def wrap(mod):
        def timed(argv=None, *a, **kw):
            t0 = time.perf_counter()
            try:
                return saved[mod](argv, *a, **kw)
            finally:
                key = label(mod, argv)
                stage_s[key] = stage_s.get(key, 0.0) + time.perf_counter() - t0
        return timed

    for m in saved:
        m.main = wrap(m)
    try:
        yield stage_s
    finally:
        for m, fn in saved.items():
            m.main = fn


def bloom_recount(sketch, fq: str) -> tuple[int, float]:
    """(reads of fq none of whose valid 31-mers hit the sketch, the share
    of the foreign reads' 31-mers that hit it), from the sketch's own
    queries."""
    from bbtools_torch.io.fastq import FastqReader
    from bbtools_torch.ops.kmers import rolling_kmers_np

    zero, hits, total = 0, 0, 0
    for b in FastqReader(fq):
        L = b.bases.shape[1]
        fwd, rkm, run = rolling_kmers_np(b.bases, 31)
        ok = (run >= 31) & (np.arange(L)[None, :] < b.lengths[:, None].astype(np.int64))
        cnt = np.zeros(ok.shape, np.int64)
        cnt[ok] = sketch.query(np.maximum(fwd, rkm)[ok])
        hit = cnt > 0
        zero += int((hit.sum(axis=1) == 0).sum())
        junk = np.array([i.startswith(b"junk") for i in b.ids])
        hits += int(hit[junk].sum())
        total += int(ok[junk].sum())
    return zero, hits / max(total, 1)


def time_cms_add(fq: str, card: str) -> float:
    """Device ms of one add at a batch's shape (CUDA events): the k-mers of
    fq's first batch into a fresh sketch. Not counted as the path's."""
    import torch

    from bbtools_torch.io.fastq import FastqReader
    from bbtools_torch.ops import cms
    from bbtools_torch.ops.kmer_count import batch_keys

    b = next(iter(FastqReader(fq)))
    keys = batch_keys(b.bases, b.lengths, 31, torch.device("cuda"))
    keys = keys[keys != np.iinfo(np.int64).max]
    sk = cms.CountMinSketch(device="cuda")
    calls = cms.cms_add.device_calls
    ms = cuda_ms(lambda: cms.cms_add(sk.table, keys, sk.max_count), 10)
    cms.cms_add.device_calls = calls
    print(f"bbcms add: {ms:.3f} ms for one batch's {keys.numel()} k-mers ({b.n} reads; "
          f"sort, runs, index_add_ over unique slots, saturation) on {card}")
    return ms


def a6b_phases(asm: dict, pipe: dict, ctx: dict, work: str, card: str,
               phase_s: dict) -> dict:
    """The A6b tools through the CLI on device=cuda, each with its kernels'
    launch counts or its counts' device routes required: tadpipe whole on
    the region, its trim and ecco stages at full size, BBMerge nn=t over
    the smoke's pairs, bbcms over config #2's reads and with ecc=t on the
    region's, BBMap bloomfilter=t, and bbrealign on the clipped SAM.
    Returns the outputs the CUDA-against-CPU checks reuse."""
    out = {}
    # ---- tadpipe whole, at TadPipe's defaults ----
    t0 = time.perf_counter()
    asm_fa = os.path.join(work, "pipe.cuda.fa")
    stage_s: dict[str, float] = {}
    with stage_timer(stage_s):
        (best_k, dt, log), got = run_path("tadpipe", lambda: routed(
            "tadpipe", lambda: run_tool("tadpipe", [
                f"in={pipe['region'][0]}", f"in2={pipe['region'][1]}", f"out={asm_fa}",
                f"tmpdir={os.path.join(work, 'pipe_tmp')}"], "cuda"),
            {"sort_reduce": None, "count_words": None}),
            ("cummax_i64", "overlap_scan", "lane_table"), {})
    from bbtools_torch.io.fasta import iter_fasta

    contigs = [r.seq for r in iter_fasta(asm_fa)]
    lens = [len(c) for c in contigs]
    recall = kmer_recall(contigs, asm["copy_codes"][:ASM_REGION])
    merged_ext = log.split("Merged by extension: \t")[1].split()[0]
    print(f"tadpipe (k=31,62,93, every stage) device=cuda: {PIPE_PAIRS} pairs in {dt:.2f} s "
          f"= {PIPE_PAIRS / dt:.0f} pairs/s (wall) on {card}; stages: "
          + ", ".join(f"{k} {v:.2f} s ({v / dt:.1%})" for k, v in stage_s.items())
          + f"; other {dt - sum(stage_s.values()):.2f} s")
    print(f"tadpipe: Recommended K {best_k}; {len(lens)} contigs, {sum(lens)} bp, N50 "
          f"{n50(lens)}, max contig {max(lens, default=0)}; {recall:.4f} of the region's "
          f"31-mers in the assembly; merged by extension {merged_ext}; launches "
          f"cummax_i64 {got['cummax_i64']}, overlap_scan {got['overlap_scan']}, "
          f"lane_table {got['lane_table']}")
    if recall < ASM_RECALL_MIN:
        raise AssertionError(f"tadpipe: the assembly holds {recall:.4f} of the region")
    out["tadpipe_launches"] = got
    phase_s["tadpipe"] = time.perf_counter() - t0

    # ---- tadpipe's two device stages at full size ----
    t0 = time.perf_counter()
    n = pipe["full_pairs"]
    trimmed = [os.path.join(work, f"pipe_full_trim_{m}.fq") for m in (1, 2)]
    (_, dt, _), got = run_path("tadpipe trim (full)", lambda: run_tool("bbduk", [
        f"in={pipe['full'][0]}", f"in2={pipe['full'][1]}", f"out={trimmed[0]}",
        f"out2={trimmed[1]}", *PIPE_TRIM], "cuda"),
        ("cummax_i64", "overlap_scan", "lane_table"), {})
    print(f"tadpipe trim stage (bbduk {' '.join(PIPE_TRIM)}) device=cuda: {n} pairs in "
          f"{dt:.2f} s = {n / dt:.0f} pairs/s (wall) on {card}; launches {got}")
    ecco = [os.path.join(work, f"pipe_full_ecco_{m}.fq") for m in (1, 2)]
    (tool, dt, _), got = run_path("tadpipe ecco (full)", lambda: run_tool("bbmerge", [
        f"in1={trimmed[0]}", f"in2={trimmed[1]}", f"out={ecco[0]}", f"outu2={ecco[1]}",
        *PIPE_ECCO], "cuda"), ("overlap_scan", "lane_table"), {})
    print(f"tadpipe ecco stage (bbmerge {' '.join(PIPE_ECCO)}) device=cuda: {tool.pairs} "
          f"pairs in {dt:.2f} s = {tool.pairs / dt:.0f} pairs/s (wall) on {card}; "
          f"{tool.merged} corrected by their overlap")
    phase_s["tadpipe device stages (full)"] = time.perf_counter() - t0

    # ---- BBMerge nn=t over the first NN_PAIRS of the smoke's pairs ----
    t0 = time.perf_counter()
    nn_out = [os.path.join(work, f"nn.cuda.{x}") for x in ("m.fq", "u1.fq", "u2.fq")]
    (tool, dt, _), got = run_path("bbmerge nn=t", lambda: run_tool("bbmerge", [
        f"in1={ctx['nn_pairs'][0]}", f"in2={ctx['nn_pairs'][1]}", f"out={nn_out[0]}",
        f"outu1={nn_out[1]}", f"outu2={nn_out[2]}", "nn=t"], "cuda"),
        ("overlap_scan", "lane_table"), {})
    share = tool.merged / tool.pairs
    print(f"bbmerge nn=t device=cuda: {tool.pairs} pairs in {dt:.2f} s = "
          f"{tool.pairs / dt:.0f} pairs/s (wall) on {card}, against {ctx['merge_rate']:.0f} "
          f"pairs/s at defaults over all the pairs; merged share {share:.4f} against "
          f"{ctx['merge_share']:.4f} at defaults; {tool.ambiguous} ambiguous; {len(tool.nn_near)} scores within "
          f"1e-5 of the cutoff {tool.net_cutoff}")
    # the gate moves decisions both ways: the widened scan (max_ratio 0.7)
    # finds more candidates, and the net rejects some
    if not 0 < share != ctx["merge_share"]:
        raise AssertionError(f"bbmerge nn=t: merged share {share:.4f}")
    phase_s["bbmerge nn=t"] = time.perf_counter() - t0

    # ---- bbcms ----
    t0 = time.perf_counter()
    kept_fq = os.path.join(work, "cms.cuda.fq")
    batches = -(-ASM_READS // BATCH)
    ((kept, tossed, _), dt, _), _ = run_path("bbcms", lambda: routed("bbcms", lambda: run_tool(
        "bbcms", [f"in={asm['reads.fq.gz']}", f"out={kept_fq}", *CMS_FILTER], "cuda"),
        {"cms_add": batches}), (), {})
    table_bytes = 3 * (1 << 22) * 4
    print(f"bbcms {' '.join(CMS_FILTER)} device=cuda: {ASM_READS} reads in {dt:.2f} s = "
          f"{ASM_READS / dt:.0f} reads/s (wall, count and filter passes) on {card}; "
          f"{kept} kept, {tossed} tossed; the sketch (3 x 2^22 int32) holds {table_bytes} "
          f"bytes on the card; {batches} adds")
    if not 0.9 * ASM_READS <= kept < ASM_READS:
        raise AssertionError(f"bbcms: kept {kept} of {ASM_READS}")
    out["cms_add_ms"] = time_cms_add(asm["reads.fq.gz"], card)
    ecc_fq = os.path.join(work, "cms_ecc.cuda.fq")
    ((kept, _, errors), dt, _), _ = run_path("bbcms ecc=t", lambda: routed(
        "bbcms ecc=t", lambda: run_tool("bbcms", [
            f"in={asm['cms_ecc.fq.gz']}", f"out={ecc_fq}"], "cuda"),
        {"cms_add": None}), (), {})
    n_in = CMS_ECC_READS
    print(f"bbcms ecc=t device=cuda: the region's first {n_in} reads in {dt:.2f} s = "
          f"{n_in / dt:.0f} reads/s (wall; the correction is host code) on {card}; "
          f"{errors} errors corrected")
    if errors <= 0:
        raise AssertionError("bbcms ecc=t corrected nothing")
    phase_s["bbcms"] = time.perf_counter() - t0

    # ---- BBMap bloomfilter=t (B4) ----
    t0 = time.perf_counter()
    sam = os.path.join(work, "bloom.cuda.sam")
    (tool, dt, _), got = run_path("bbmap bloomfilter=t", lambda: routed(
        "bbmap bloomfilter=t", lambda: run_tool("bbmap", [
            f"ref={ctx['ref_fa']}", f"in={ctx['bloom_fq']}", f"out={sam}",
            "bloomfilter=t"], "cuda"), {"cms_add": None}), ("msa_fill",), {})
    foreign = mapped_foreign = 0
    with open(sam, "rb") as fh:
        for line in fh:
            if line.startswith(b"junk"):
                foreign += 1
                mapped_foreign += not int(line.split(b"\t", 2)[1]) & 4
    # the prescreen recounted from the tool's own sketch: the reads none of
    # whose 31-mers hit it, and the foreign 31-mers' share that hits
    zero, hit_share = bloom_recount(tool.bloom, ctx["bloom_fq"])
    share = tool.reads_mapped / BLOOM_READS
    n = BLOOM_READS + BLOOM_FOREIGN
    print(f"bbmap bloomfilter=t device=cuda: {n} reads in {dt:.2f} s = {n / dt:.0f} reads/s "
          f"(wall, incl. the index and sketch build) on {card}, against {ctx['map_rate']:.0f} "
          f"reads/s for the fused default; {tool.prescreened} prescreened ({zero} recounted), "
          f"{foreign} foreign reads ({mapped_foreign} mapped), {hit_share:.4f} of their 31-mers "
          f"hit the sketch (3 x 2^22 cells over the genome's 31-mers); {tool.reads_mapped} "
          f"of {BLOOM_READS} real reads mapped ({share:.4f}); B4 launches {b4_routes(got)}")
    if (foreign != BLOOM_FOREIGN or mapped_foreign or tool.prescreened != zero
            or not MAPPED_RANGE[0] <= share <= MAPPED_RANGE[1]):
        raise AssertionError(f"bbmap bloomfilter=t: {tool.prescreened} prescreened "
                             f"({zero} recounted), {mapped_foreign} foreign mapped, share "
                             f"{share:.4f}")
    phase_s["bbmap bloomfilter=t"] = time.perf_counter() - t0

    # ---- bbrealign on the clipped SAM of config #5 ----
    t0 = time.perf_counter()
    clip_sam = os.path.join(work, "realign.in.sam")
    clipped = clip_indels(ctx["cv_sam"], clip_sam, CV_CHECK_READS)
    re_out = os.path.join(work, "realign.cuda.sam")
    ((realigned, total), dt, _), _ = run_path("bbrealign", lambda: run_tool("bbrealign", [
        f"in={clip_sam}", f"ref={asm['ref.fa']}", f"out={re_out}"], "cuda"), (), {})
    print(f"bbrealign device=cuda: {total} alignments ({clipped} soft-clipped from their "
          f"first indel on) in {dt:.2f} s = {total / dt:.0f} records/s on {card}; "
          f"{realigned} realigned")
    if realigned < 1:
        raise AssertionError("bbrealign realigned nothing")
    out.update(clip_sam=clip_sam, realign_out=re_out, realigned=realigned)
    phase_s["bbrealign"] = time.perf_counter() - t0
    return out


def a6b_checks(asm: dict, pipe: dict, ctx: dict, main_out: dict, work: str,
               phase_s: dict):
    """The A6b tools on device=cuda and device=cpu, byte for byte: tadpipe
    k=31,62 on the region's first PIPE_CHECK_BP bp (the final contigs and
    every stage file), BBMerge ecco and nn=t on MERGE_CHECK_PAIRS pairs
    and its merge stage (extend2 ecct) on MERGE_ECCT_CHECK_PAIRS (nn=t:
    only pairs whose score lay within 1e-5 of the cutoff may differ),
    bbcms ecc=t and mincount=2 on CMS_CHECK_READS of the region's reads,
    BBMap bloomfilter=t on BLOOM_CHECK_READS reads against the region
    (every foreign read prescreened), and bbrealign on the clipped
    SAM."""
    from bbtools_torch.utils.fqdiff import differing_names

    t0 = time.perf_counter()
    side = ctx["cpu_side"]
    dt = side.wait("tadpipe cuda")
    cpu_dt = side.wait("tadpipe")
    files = {}
    for device in ("cuda", "cpu"):
        tmp = tadpipe_check_argv(pipe, work, device)[1]
        names = sorted(os.listdir(tmp))
        files[device] = read_all([tmp + ".fa"] + [os.path.join(tmp, x) for x in names])
    print(f"tadpipe k=31,62: {pipe['check_pairs']} pairs in {dt:.2f} s on cuda, {cpu_dt:.2f} s "
          f"on cpu (each in a process of its own)")
    if files["cuda"] != files["cpu"] or len(names) != 12:
        raise AssertionError("tadpipe: cuda and cpu outputs differ")
    print(f"tadpipe: cuda == cpu on {pipe['check_pairs']} pairs of the region's first "
          f"{PIPE_CHECK_BP} bp (the assembly and {len(names)} stage files, "
          f"{sum(map(len, files['cuda']))} bytes)")
    for tag, ins, flags, n in a6b_merge_checks(pipe):
        # both halves ran in processes; nn=t's pairs near its cutoff, as
        # each tool object reported them
        secs = {d: side.wait(f"bbmerge {tag}" + x) for d, x in (("cuda", " cuda"), ("cpu", ""))}
        near = {x.encode("latin-1") for n in (f"bbmerge {tag} cuda", f"bbmerge {tag}")
                for x in side.report(n)["nn_near"]}
        files = {d: read_all(bbmerge_argv(ins, work, f"mcheck_{tag}", d, flags)[1])
                 for d in ("cuda", "cpu")}
        print(f"bbmerge {' '.join(flags)}: {n} pairs in {secs['cuda']:.2f} s on cuda, "
              f"{secs['cpu']:.2f} s on cpu")
        differ = set()
        for a, b in zip(files["cuda"], files["cpu"]):
            if a != b:
                if tag != "nn":
                    raise AssertionError(f"bbmerge {tag}: cuda and cpu outputs differ")
                differ |= differing_names(a, b)
        if not differ <= near:
            raise AssertionError(f"bbmerge nn=t: {len(differ - near)} pairs differ away "
                                 "from the cutoff")
        print(f"bbmerge {' '.join(flags)}: cuda == cpu on {n} pairs"
              + (f" but for {len(differ)} pairs of the {len(near)} whose score lay within "
                 f"1e-5 of the cutoff" if tag == "nn" else "")
              + f" ({sum(map(len, files['cuda']))} bytes)")
    for flags in CMS_CHECKS:
        side.wait(f"bbcms {' '.join(flags)} cuda")
        side.wait(f"bbcms {' '.join(flags)}")
        files = {d: read_all(bbcms_check_argv(pipe, flags, work, d)[1]) for d in ("cuda", "cpu")}
        if files["cuda"] != files["cpu"]:
            raise AssertionError(f"bbcms {flags}: cuda and cpu outputs differ")
        print(f"bbcms {' '.join(flags)}: cuda == cpu on {CMS_CHECK_READS} reads")
    dt = side.wait("bbmap bloomfilter=t cuda")
    cpu_dt = side.wait("bbmap bloomfilter=t")
    files = {d: read_all(bloom_check_argv(pipe, work, d)[1]) for d in ("cuda", "cpu")}
    pre = {d: side.report("bbmap bloomfilter=t" + x)["prescreened"]
           for d, x in (("cuda", " cuda"), ("cpu", ""))}
    print(f"bbmap bloomfilter=t (the region as reference): {BLOOM_CHECK_READS} reads in "
          f"{dt:.2f} s on cuda, {cpu_dt:.2f} s on cpu (each in a process of its own)")
    n_foreign = BLOOM_CHECK_READS // 11
    if files["cuda"] != files["cpu"] or not pre["cuda"] == pre["cpu"] >= n_foreign:
        raise AssertionError(f"bbmap bloomfilter=t: cuda and cpu SAM differ or too few "
                             f"prescreened ({pre})")
    print(f"bbmap bloomfilter=t: cuda == cpu on {BLOOM_CHECK_READS} reads against the "
          f"region ({pre['cuda']} prescreened on each device, {n_foreign} foreign)")
    out = os.path.join(work, "realign.cpu.sam")
    (realigned, _), dt, _ = run_tool("bbrealign", [
        f"in={main_out['clip_sam']}", f"ref={asm['ref.fa']}", f"out={out}"], "cpu")
    if read_all([out]) != read_all([main_out["realign_out"]]) or (
            realigned != main_out["realigned"]):
        raise AssertionError("bbrealign: cuda and cpu outputs differ")
    print(f"bbrealign: cuda == cpu on {CV_CHECK_READS} records ({realigned} realigned on "
          f"each device; cpu {dt:.2f} s)")
    phase_s["cuda == cpu, a6b tools"] = time.perf_counter() - t0


def make_long_reads(path: str, codes, rng, n: int, lo: int, hi: int, tag: str = "l"):
    """n FASTA reads of lo-hi bp of `codes` (one scaffold): 1%
    substitutions, three indels of 1-3 bp, a 50 bp deletion in every
    other read, every third reverse-complemented; truth names (synth's
    format) give the forward start of the read's window."""
    from bbtools_torch.core.dna import CODE_TO_BASE

    G = len(codes)
    with open(path, "wb") as fh:
        for i in range(n):
            ln = int(rng.integers(lo, hi + 1))
            start = int(rng.integers(0, G - ln - 200))
            read = codes[start : start + ln + 100].copy()
            if i % 2:
                read = np.concatenate([read[: ln // 2], read[ln // 2 + 50 :]])
            for _ in range(3):
                p = int(rng.integers(100, len(read) - 100))
                cut = int(rng.integers(1, 4))
                read = (np.concatenate([read[:p], read[p + cut :]]) if rng.random() < 0.5 else
                        np.concatenate([read[:p], rng.integers(0, 4, cut).astype(np.uint8),
                                        read[p:]]))
            read = read[:ln]
            m = rng.random(ln) < 0.01
            read[m] = (read[m] + rng.integers(1, 4, int(m.sum()))) % 4
            strand = int(i % 3 == 1)
            if strand:
                read = (3 - read)[::-1]
            fh.write(b">%s%d_scaf0_pos%d_strand%d_insert0\n%s\n"
                     % (tag.encode(), i, start, strand, CODE_TO_BASE[read].tobytes()))


def plant_phix(src: str, dst: str, every: int, seed: int, n: int | None = None) -> int:
    """src's reads (its first n), every `every`-th replaced by a phiX
    segment of its length (either strand); returns the planted count."""
    from bbtools_torch.core.dna import CODE_TO_BASE, encode
    from bbtools_torch.io.fastq import FastqReader

    with gzip.open(os.path.join(HERE, "bbtools_tpu", "resources", "phix2.fa.gz")) as fh:
        phix = encode(b"".join(ln for ln in fh.read().splitlines() if not ln.startswith(b">")))
    rng = np.random.default_rng(seed)
    ascii_ = np.frombuffer(b"ACGTN", np.uint8)
    recs, i, planted = [], 0, 0
    for b in FastqReader(src):
        for j in range(b.n):
            if i == n:
                break
            L = int(b.lengths[j])
            if i % every == 0:
                p = int(rng.integers(0, len(phix) - L))
                seg = phix[p : p + L]
                seq = CODE_TO_BASE[(3 - seg)[::-1] if rng.random() < 0.5 else seg].tobytes()
                name = b"phix%d" % i
                planted += 1
            else:
                seq, name = ascii_[np.minimum(b.bases[j, :L], 4)].tobytes(), b.ids[j]
            recs.append(b"@%s\n%s\n+\n%s\n" % (name, seq, bytes(b.quals[j, :L] + 33)))
            i += 1
    with open(dst, "wb") as fh:
        fh.write(b"".join(recs))
    return planted


def make_a2_data(work: str, genome, fq: str, map_fq: str, bloom_fq: str, seed: int) -> dict:
    """The inputs of the A2/A5 and A4b phases: the long reads (a full
    mapPacBio batch and LONG_CHUNKED reads past fastareadlen), the 8 of
    the CUDA-against-CPU check, config #1's reads with phiX planted, a
    second seeded genome and reads of it for bbsplit, and the heads of the
    checks."""
    from bbtools_torch.core.dna import CODE_TO_BASE
    from bbtools_torch.io.fasta import load_reference, write_fasta
    from bbtools_torch.utils.synth import random_genome, random_reads, write_reads

    rng = np.random.default_rng(seed)
    codes = genome.scaffold_codes(0)
    d = {"long": os.path.join(work, "long.fa"), "long_chunked": os.path.join(work, "long_c.fa"),
         "long_check": os.path.join(work, "long_check.fa"),
         "long_skim": os.path.join(work, "long_skim.fa")}
    make_long_reads(d["long"], codes, rng, LONG_READS, *LONG_RANGE)
    make_long_reads(d["long_chunked"], codes, rng, LONG_CHUNKED, *LONG_CHUNKED_RANGE, tag="c")
    with open(d["long"], "ab") as fh, open(d["long_chunked"], "rb") as src:
        fh.write(src.read())
    with open(d["long"], "rb") as src, open(d["long_skim"], "wb") as fh:
        fh.write(b"".join(src.read().splitlines(keepends=True)[: 2 * SKIM_READS]))
    make_long_reads(d["long_check"], codes, rng, LONG_CHECK_READS, *LONG_CHECK_RANGE)
    d["side"] = os.path.join(work, "side.fq")
    d["side_planted"] = plant_phix(fq, d["side"], SIDE_EVERY, seed + 1)
    with open(d["side"], "rb") as fh:
        d["side_total"] = fh.read().count(b"\n") // 4
    d["side_check"] = os.path.join(work, "side_check.fq")
    plant_phix(fq, d["side_check"], SIDE_EVERY, seed + 1, A2_CHECK_READS)
    d["recal_check"] = os.path.join(work, "a2_recal_check.fq.gz")
    head_fastq(map_fq, d["recal_check"], A2_CHECK_READS)
    d["rh_fq"] = os.path.join(work, "rh.fq.gz")
    head_fastq(bloom_fq, d["rh_fq"], RH_READS)
    d["second_fa"] = os.path.join(work, "second.fa")
    write_fasta(d["second_fa"], random_genome(SECOND_GENOME, seed=seed + 2))
    second = load_reference(d["second_fa"])
    d["split_fq"] = os.path.join(work, "split.fq")
    write_reads(d["split_fq"], random_reads(genome, SPLIT_READS, read_len=151,
                                            snp_rate=0.01, seed=seed + 3)
                + random_reads(second, SPLIT_READS, read_len=151, snp_rate=0.01,
                               seed=seed + 4))
    # the checks' references: CHECK_REGION bp of each genome, and reads
    # of them (COV_CHECK_READS of the first; half of each for bbsplit)
    regions = []
    for tag, ref in (("region", genome), ("second_region", second)):
        d[tag + "_fa"] = os.path.join(work, f"{tag}.fa")
        write_fasta(d[tag + "_fa"], [(tag.encode(), CODE_TO_BASE[
            ref.scaffold_codes(0)[:CHECK_REGION]].tobytes())])
        regions.append(load_reference(d[tag + "_fa"]))
    d["map_check"] = os.path.join(work, "a2_map_check.fq")
    write_reads(d["map_check"], random_reads(regions[0], COV_CHECK_READS, read_len=151,
                                             snp_rate=0.01, indel_rate=0.1, seed=seed + 5))
    d["split_check"] = os.path.join(work, "split_check.fq")
    write_reads(d["split_check"], [
        r for i, g in enumerate(regions) for r in random_reads(
            g, COV_CHECK_READS // 2, read_len=151, snp_rate=0.01, seed=seed + 6 + i)])
    return d


def check_b4_long() -> dict:
    """B4 at mapPacBio's widest window class (B4_LONG: tasks of reads of
    up to 6,000 bases in windows of 6,000 + 7,640 columns): the wrapper
    must take the band kernel; it and the block kernel against the
    plain version on the same tasks, every output and live plane byte;
    the two kernels timed in turns with CUDA events (the plain version on
    its one call, it takes seconds), the band kernel at each K of BAND_K
    and each progress step of B4_BAND_G; the bound on live cells, by the
    method of the main B4 row, and the chain floor. Returns the band
    kernel's row."""
    import torch

    from bbtools_torch.kernels import build
    from bbtools_torch.ops import msa_fill as mf
    from bbtools_torch.ops.msa_fill import msa_fill, msa_fill_plain, msa_fill_variant

    S, R, Cc, lmin = B4_LONG
    rng = np.random.default_rng(6)
    reads, lens, refs = (torch.from_numpy(x).to("cuda")
                         for x in near_match_tasks(rng, S, R, Cc, lmin))
    before = (msa_fill.launches, msa_fill.band_launches, msa_fill.block_launches)
    got = msa_fill(reads, lens, refs)
    if (msa_fill.launches, msa_fill.band_launches, msa_fill.block_launches) != (
            before[0], before[1] + 1, before[2]):
        raise AssertionError("B4 long reads: the band kernel did not take the tasks")
    # the plain version once (~20,000 diagonal steps of torch ops), timed
    # with CUDA events on the call that is compared
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    want = msa_fill_plain(reads, lens, refs)
    e1.record()
    torch.cuda.synchronize()
    plain_ms = e0.elapsed_time(e1)
    live_bytes = b4_equal("mapPacBio widest class", got, want, lens, Cc)
    b4_equal("mapPacBio widest class, block kernel",
             msa_fill_variant("block", reads, lens, refs), want, lens, Cc)
    Rp = got[3].shape[2] - 1
    del got
    by_k = b4_band_k("mapPacBio widest class", reads, lens, refs, want, 3)
    del want
    fns = {"band": lambda: msa_fill(reads, lens, refs),
           "block": lambda: msa_fill_variant("block", reads, lens, refs)}
    t = {f: [] for f in fns}
    for f in ("band", "block", "block", "band"):
        t[f].append(cuda_ms(fns[f], 2))
    ms = {f: sum(v) / len(v) for f, v in t.items()}
    # the progress step G, in turns (the wrapper's G restored after)
    g0, by_g = mf.BAND_G, {g: [] for g in B4_BAND_G}
    try:
        for order in (B4_BAND_G, B4_BAND_G[::-1]):
            for g in order:
                mf.BAND_G = g
                by_g[g].append(cuda_ms(fns["band"], 2))
    finally:
        mf.BAND_G = g0
    by_g = {g: sum(v) / len(v) for g, v in by_g.items()}
    n_ins = sass_loop_instructions(build.library_path(),
                                   f"msa_fill_warp_kernelILi{B4_MAIN_SLICES}E")
    ops_per_cell = n_ins / B4_MAIN_SLICES if n_ins else B4_OPS_PER_CELL
    block_ins = sass_loop_instructions(build.library_path(), "msa_fill_block_kernelILi8E")
    nrows = (lens.clamp(max=Rp).to(torch.int64) + 1).clamp(min=0)
    live = int((nrows * (Cc + 1)).sum().item())
    r = {"name": "msa_fill_band", "route": "cuda", "source": "bbtools_torch/csrc/msa_fill.cu",
         "replaces": "bbtools_tpu/ops/msa_pallas.py:97", "redesigned": True,
         "set": "mapPacBio widest class", "S": S, "R": R, "R_trimmed": Rp, "Cc": Cc,
         "live_cells": live, "max_abs_err": 0, "ms": ms["band"], "plain_ms": plain_ms,
         "block_ms": ms["block"], "library_ms": None, "band_k_ms": by_k, "band_g_ms": by_g,
         "chain_floor_ms": chain_floor_ms(Rp, Cc, ops_per_cell), "ops_per_cell": ops_per_cell,
         "block_loop_instructions_k8": block_ins, "gcells_s": live / ms["band"] / 1e6}
    r.update(bound(nbytes(reads, lens, refs) + 12 * S + live_bytes, ops_per_cell * live,
                   INSTR_S))
    print(f"B4 mapPacBio widest class (S={S}, R={R} trimmed to {Rp}, Cc={Cc}): the band "
          f"kernel (the wrapper's route) and the block kernel exact on outputs and "
          f"{live_bytes} live plane bytes; in turns the band kernel {ms['band']:.2f} ms, the "
          f"block kernel {ms['block']:.2f} ms ({ms['block'] / ms['band']:.1f}x), plain "
          f"{plain_ms:.1f} ms; bound {r['bound_ms']:.3f} ms ({r['bound_by']}) on {live} live "
          f"cells at {ops_per_cell:.1f} instructions a cell ({r['bound_ms'] / ms['band']:.3f} "
          f"of the band kernel), chain floor {r['chain_floor_ms']:.3f} ms; the band kernel by "
          f"progress step (the wrapper's G={g0}): "
          + ", ".join(f"G={g} {v:.2f} ms" for g, v in by_g.items())
          + f"; the block kernel's diagonal loop at K=8 holds {block_ins} instructions")
    return r


#: progress steps (columns between two progress stores) at which the band
#: kernel is timed at the widest class
B4_BAND_G = (8, 16, 32, 64)


def long_stats(sam: str) -> dict:
    """Primary records, mapped ones, those placed within 50 bp of their
    origin, chunk records and flag-256 lines of a long-read SAM."""
    from bbtools_torch.utils.synth import parse_truth

    s = {"primary": 0, "mapped": 0, "placed": 0, "chunks": 0, "secondary": 0}
    with open(sam, "rb") as fh:
        for line in fh:
            if line.startswith(b"@"):
                continue
            f = line.split(b"\t", 5)
            flag = int(f[1])
            if flag & 0x100:
                s["secondary"] += 1
                continue
            s["primary"] += 1
            s["chunks"] += b"_chunk" in f[0]
            if flag & 4:
                continue
            s["mapped"] += 1
            if b"_chunk" not in f[0]:
                s["placed"] += abs(int(f[3]) - 1 - parse_truth(f[0])[1]) <= 50
    return s


def timed_walk():
    """Wrap the traceback walk where BBMap's two phases call it so that
    each call is timed (a sync on each side); returns (the seconds list,
    a function that undoes the wrapping)."""
    import torch

    from bbtools_torch.ops import map_fused, msa_fill

    orig = map_fused.msa_walk
    secs: list[float] = []

    def walk(*a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(*a)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        return out

    map_fused.msa_walk = msa_fill.msa_walk = walk

    def undo():
        map_fused.msa_walk = msa_fill.msa_walk = orig

    return secs, undo


def a2_phases(a2: dict, ctx: dict, work: str, card: str, phase_s: dict, launches: dict):
    """The A2/A5 and A4b paths on device=cuda, each with its kernels
    required: calctruequality (host), mapPacBio and bbmapskimmer over the
    long reads, BBDuk config #1 with align=t, BBDuk recalibrate=t, BBMap
    with the four coverage outputs then pileup, bbsplit, bbwrap,
    removehuman and gradesam."""
    ref_fa = ctx["ref_fa"]
    sams = {}

    # ---- calctruequality on BBMap's SAM: the matrices recalibrate=t
    # reads, here and in the CPU runs of the checks ----
    t0 = time.perf_counter()
    mat = a2["matrices"] = os.path.join(work, "ctq")
    os.makedirs(mat, exist_ok=True)
    head_sam = os.path.join(work, "ctq_head.sam")
    with open(ctx["map_sam"], "rb") as src, open(head_sam, "wb") as fh:
        lines = src.read().split(b"\n")
        n_hdr = sum(ln.startswith(b"@") for ln in lines[:100])
        fh.write(b"\n".join(lines[: n_hdr + CTQ_RECORDS]) + b"\n")
    _, dt_ctq, _ = run_tool("calctruequality", [f"in={head_sam}", f"path={mat}"], "cuda")
    print(f"calctruequality on the first {CTQ_RECORDS} records of BBMap's SAM: {dt_ctq:.2f} s "
          f"(host)")
    phase_s["calctruequality"] = time.perf_counter() - t0

    # ---- mapPacBio (B4 on long reads), then the skimmer ----
    t0 = time.perf_counter()
    for tool, fin in (("mappacbio", a2["long"]), ("bbmapskimmer", a2["long_skim"])):
        sam = os.path.join(work, f"{tool}.cuda.sam")
        walks, undo = timed_walk()
        try:
            (mapper, dt, _), got = run_path(tool, lambda: run_tool(tool, [
                f"ref={ref_fa}", f"in={fin}", f"out={sam}"], "cuda"),
                ("msa_fill_band",), launches)
        finally:
            undo()
        s = long_stats(sam)
        sams[tool] = sam
        n_reads = mapper.reads_in - s["chunks"] // 2
        print(f"{tool} device=cuda: {n_reads} reads of {LONG_RANGE[0]}-{LONG_CHUNKED_RANGE[1]} "
              f"bp ({mapper.reads_in} after chunking: {s['chunks']} chunk records) in "
              f"{dt:.2f} s = {n_reads / dt:.1f} reads/s, {mapper.reads_in / dt:.1f} chunked "
              f"reads/s (wall, incl. the k=12 index build of {mapper.index_seconds:.2f} s) on "
              f"{card}; mapped {mapper.reads_mapped} of {mapper.reads_in} "
              f"({mapper.reads_mapped / max(mapper.reads_in, 1):.4f}), {s['placed']} of "
              f"{s['mapped'] - s['chunks']} unchunked mapped reads within 50 bp of their "
              f"origin; B4 launches {b4_routes(got)}; "
              f"fused overflows {mapper.fused_overflows}; plane groups {mapper.plane_groups}; "
              f"walk {sum(walks):.2f} s in {len(walks)} calls "
              f"({sum(walks) / dt:.3f} of the wall); flag-256 lines {s['secondary']}")
        unchunked = s["mapped"] - s["chunks"]
        if tool == "mappacbio" and (s["placed"] < LONG_PLACED_MIN * max(unchunked, 1)
                                    or mapper.reads_mapped < 0.95 * mapper.reads_in
                                    or s["chunks"] < 2 * LONG_CHUNKED):
            raise AssertionError(f"mappacbio: {s}")
        if tool == "bbmapskimmer" and s["primary"] != mapper.reads_in:
            raise AssertionError(f"bbmapskimmer: {s}")
    with contextlib.redirect_stdout(io.StringIO()):
        report, _, _ = run_tool("gradesam", [f"in={sams['mappacbio']}",
                                             f"ref={ref_fa}"], "cuda")
    print(f"gradesam on the mapPacBio SAM: {report.total} primary, {report.mapped} mapped, "
          f"{report.correct_loose} within 20 bp (loose), {report.correct_strict} exact, "
          f"{report.wrong} wrong (chunks graded against their read's start)")
    phase_s["mappacbio, bbmapskimmer"] = time.perf_counter() - t0

    # ---- BBDuk config #1 with the phiX side channel ----
    t0 = time.perf_counter()
    side_sam = os.path.join(work, "side.cuda.sam")
    (o, _, dt, log), got = run_path("bbduk align=t", lambda: run_bbduk(
        "side", CONFIGS["adapters_fa"] + ["align=t", f"alignout={side_sam}"], a2["side"],
        work, "cuda"), ("cummax_i64",), {})
    mapped = 0
    with open(side_sam, "rb") as fh:
        for line in fh:
            if not line.startswith(b"@") and not int(line.split(b"\t", 2)[1]) & 4:
                mapped += 1
    with open(o, "rb") as fh:
        names = fh.read().split(b"\n")[0::4]
    planted_kept = sum(n.startswith(b"@phix") for n in names)
    n = sum(1 for x in names if x)
    planted, total = a2["side_planted"], a2["side_total"]
    print(f"bbduk config #1 align=t device=cuda: {total} reads in {dt:.2f} s = "
          f"{total / dt:.0f} reads/s (wall) on {card}; side SAM mapped {mapped} against "
          f"{planted} planted phiX reads ({mapped / planted:.4f}); out= kept {n} reads, "
          f"{planted_kept} of the planted; {[ln for ln in log.splitlines() if 'Aligned' in ln]}")
    if abs(mapped - planted) > 0.01 * planted or planted_kept != planted:
        raise AssertionError(f"bbduk align=t: {mapped} mapped, {planted_kept} of {planted} kept")
    phase_s["bbduk align=t"] = time.perf_counter() - t0

    # ---- BBDuk recalibrate=t with calctruequality's matrices ----
    t0 = time.perf_counter()
    (_, _, dt, _), got = run_path("bbduk recalibrate=t", lambda: run_bbduk(
        "recal", CONFIGS["adapters_fa"] + ["recalibrate=t", f"path={mat}"], ctx["map_fq"],
        work, "cuda"), ("cummax_i64",), {})
    print(f"bbduk config #1 recalibrate=t device=cuda: {MAP_READS} reads in {dt:.2f} s = "
          f"{MAP_READS / dt:.0f} reads/s (wall) on {card}")
    phase_s["bbduk recalibrate=t"] = time.perf_counter() - t0

    # ---- BBMap's coverage outputs, then pileup on the same SAM ----
    t0 = time.perf_counter()
    cov = [os.path.join(work, f"cov.inline.{c}.txt") for c in COV_FLAGS]
    sam = os.path.join(work, "cov.cuda.sam")
    (mapper, dt, _), got = run_path("bbmap coverage", lambda: run_tool("bbmap", [
        f"ref={ref_fa}", f"in={ctx['map_batch']}", f"out={sam}",
        *(f"{c}={p}" for c, p in zip(COV_FLAGS, cov))], "cuda"), ("msa_fill",), {})
    pile = [os.path.join(work, f"cov.pileup.{c}.txt") for c in COV_FLAGS]
    _, dt_p, _ = run_tool("pileup", [f"in={sam}", f"ref={ref_fa}", f"out={pile[0]}",
                                     *(f"{c}={p}" for c, p in zip(COV_FLAGS[1:], pile[1:]))],
                          "cuda")
    if read_all(cov) != read_all(pile):
        raise AssertionError("bbmap coverage: the inline files differ from pileup's")
    print(f"bbmap covstats= basecov= covhist= bincov= device=cuda: {MAP_BATCH_READS} reads in "
          f"{dt:.2f} s on {card}; pileup over its SAM {dt_p:.2f} s (host); the four files "
          f"byte-equal ({sum(os.path.getsize(p) for p in cov)} bytes)")
    phase_s["bbmap coverage, pileup"] = time.perf_counter() - t0

    # ---- bbsplit, bbwrap, removehuman ----
    t0 = time.perf_counter()
    pat = os.path.join(work, "split.cuda_%.fq")
    (res, dt, log), got = run_path("bbsplit", lambda: run_tool("bbsplit", [
        f"in={a2['split_fq']}", f"ref={ref_fa},{a2['second_fa']}", f"basename={pat}",
        f"outu={os.path.join(work, 'split.cuda_u.fq')}"], "cuda"), ("msa_fill",), {})
    counts = {n: int(c) for n, c in zip(res.set_names, res.counts[:-1])}
    print(f"bbsplit device=cuda (the genome and a second seeded genome of {SECOND_GENOME} bp): "
          f"{2 * SPLIT_READS} reads in {dt:.2f} s (wall, incl. the merged index build) on "
          f"{card}; binned {counts}, unmapped {int(res.counts[-1])}")
    if min(counts.values()) < 0.95 * SPLIT_READS:
        raise AssertionError(f"bbsplit: {counts}")
    from bbtools_torch.models import bbmap_index

    builds = []
    orig_build = bbmap_index.SeedIndex.build
    bbmap_index.SeedIndex.build = staticmethod(
        lambda *a, **k: builds.append(1) or orig_build(*a, **k))
    wrap_out = [os.path.join(work, f"wrap{i}.cuda.sam") for i in (1, 2)]
    try:
        (_, dt, _), got = run_path("bbwrap", lambda: run_tool("bbwrap", [
            f"ref={ref_fa}", f"in={ctx['map_small']},{ctx['map_batch']}",
            f"out={','.join(wrap_out)}"], "cuda"), ("msa_fill",), {})
    finally:
        bbmap_index.SeedIndex.build = orig_build
    print(f"bbwrap device=cuda over two inputs ({MAP_CHECK_READS} and {MAP_BATCH_READS} "
          f"reads): {dt:.2f} s with {len(builds)} index build on {card}")
    if len(builds) != 1:
        raise AssertionError(f"bbwrap built {len(builds)} indexes")
    um, mm = (os.path.join(work, f"rh.cuda.{x}.fq") for x in ("u", "m"))
    (mapper, dt, _), got = run_path("removehuman", lambda: run_tool("removehuman", [
        f"ref={ref_fa}", f"in={a2['rh_fq']}", f"outu={um}", f"outm={mm}"], "cuda"),
        (), {})
    if b4_total(got) == 0:
        raise AssertionError("removehuman: B4 never launched")
    with open(mm, "rb") as fh:
        kept = fh.read().split(b"\n")[0::4]
    junk = sum(n.startswith(b"@junk") for n in kept)
    print(f"removehuman ref=<genome> device=cuda: {mapper.reads_in} reads in {dt:.2f} s on "
          f"{card}; {len(kept) - 1} to outm= ({junk} foreign), {mapper.prescreened} "
          f"prescreened")
    if junk:
        raise AssertionError("removehuman: a foreign read mapped")
    phase_s["bbsplit, bbwrap, removehuman"] = time.perf_counter() - t0


def a2_check_runs(a2: dict, ctx: dict, work: str) -> dict:
    """The CLI runs of the CUDA-against-CPU checks of the A2/A5 and A4b
    paths: name -> (argv on device d, d's output files), for mapPacBio
    and the skimmer on LONG_CHECK_READS long reads, BBDuk align=t and
    recalibrate=t on A2_CHECK_READS reads, BBMap's coverage outputs and
    bbsplit on COV_CHECK_READS reads of CHECK_REGION bp of the genome (and
    of the second genome, for bbsplit)."""
    ref_fa = ctx["ref_fa"]

    def w(name):
        return os.path.join(work, name)

    def bbduk(tag, fin, flags, side_sam=False):
        return lambda d: Check(
            ["bbduk", f"in={fin}", f"out={w(f'{tag}.{d}.fq')}", *CONFIGS["adapters_fa"], *flags]
            + ([f"alignout={w(f'{tag}.{d}.sam')}"] if side_sam else []),
            [w(f"{tag}.{d}.fq")] + ([w(f"{tag}.{d}.sam")] if side_sam else []))

    return {
        "mappacbio": lambda d: Check(["mappacbio", f"ref={ref_fa}", f"in={a2['long_check']}",
                                      f"out={w(f'lc.{d}.sam')}"], [w(f"lc.{d}.sam")]),
        "bbmapskimmer": lambda d: Check(["bbmapskimmer", f"ref={ref_fa}",
                                         f"in={a2['long_check']}", f"out={w(f'sc.{d}.sam')}"],
                                        [w(f"sc.{d}.sam")]),
        "bbduk align=t": bbduk("sidechk", a2["side_check"], ["align=t"], side_sam=True),
        "bbduk recalibrate=t": bbduk("recalchk", a2["recal_check"],
                                     ["recalibrate=t", f"path={a2['matrices']}"]),
        "bbmap coverage": lambda d: Check(
            ["bbmap", f"ref={a2['region_fa']}", f"in={a2['map_check']}",
             f"out={w(f'covchk.{d}.sam')}", *(f"{c}={w(f'covchk.{d}.{c}')}" for c in COV_FLAGS)],
            [w(f"covchk.{d}.{x}") for x in ("sam", *COV_FLAGS)]),
        "bbsplit": lambda d: Check(
            ["bbsplit", f"in={a2['split_check']}",
             f"ref={a2['region_fa']},{a2['second_region_fa']}",
             f"basename={w(f'splitchk.{d}_%.fq')}", f"outu={w(f'splitchk.{d}_u.fq')}"],
            [w(f"splitchk.{d}_{x}.fq") for x in ("u", "region", "second_region")]),
    }


def make_dedupe_reads(path: str, seed: int) -> tuple[int, int]:
    """dedupe's planted input (DEDUPE_* above), gzipped, names d<i>.
    Returns (distinct, planted duplicates)."""
    rng = np.random.default_rng(seed)
    L = 150
    base = rng.integers(0, 4, (DEDUPE_DISTINCT, L)).astype(np.uint8)
    reads = list(base)
    for i in range(DEDUPE_EXACT):  # copies of reads 0.., every other reversed
        reads.append((3 - base[i])[::-1].copy() if i % 2 else base[i].copy())
    for i in range(DEDUPE_NEAR):  # near-copies of reads DEDUPE_EXACT..
        r = base[DEDUPE_EXACT + i].copy()
        p = int(rng.integers(40, 110))
        kind = i % 4
        if kind < 2:
            r[p] = (r[p] + 1 + int(rng.integers(0, 3))) % 4
            if kind == 1:
                r[p + 5] = (r[p + 5] + 1 + int(rng.integers(0, 3))) % 4
        elif kind == 2:
            r = np.delete(r, p)
        else:
            r = np.insert(r, p, rng.integers(0, 4))
        reads.append(r)
    ascii_ = np.frombuffer(b"ACGT", np.uint8)
    with gzip.open(path, "wb", compresslevel=1) as fh:
        fh.write(b"".join(b"@d%d\n%s\n+\n%s\n" % (i, ascii_[reads[j]].tobytes(),
                                                   b"I" * len(reads[j]))
                          for i, j in enumerate(rng.permutation(len(reads)))))
    return DEDUPE_DISTINCT, DEDUPE_EXACT + DEDUPE_NEAR


def make_a8a_data(work: str, genome, fq: str, n_fq: int, a2: dict, asm: dict,
                  seed: int) -> dict:
    """The inputs of the A8a phases: seal's six references and the head
    of its check, dedupe's planted reads and the heads of the dedupe and
    clumpify checks."""
    from bbtools_torch.core.dna import CODE_TO_BASE
    from bbtools_torch.io.fasta import write_fasta

    d = {"seal_refs": [], "fq": fq, "fq_reads": n_fq}
    codes = genome.scaffold_codes(0)
    cut = -(-len(codes) // SEAL_PARTS)
    for i in range(SEAL_PARTS):
        d["seal_refs"].append(os.path.join(work, f"ecoli_part{i}.fa"))
        write_fasta(d["seal_refs"][-1], [(b"part%d" % i, CODE_TO_BASE[
            codes[i * cut:(i + 1) * cut]].tobytes())])
    d["seal_refs"] += [a2["second_fa"],
                       os.path.join(HERE, "bbtools_tpu", "resources", "phix2.fa.gz")]
    d["seal_check"] = os.path.join(work, "seal_check.fq")
    d["seal_check_planted"] = plant_phix(fq, d["seal_check"], SIDE_EVERY, seed + 1,
                                         SEAL_CHECK_READS)
    d["dedupe"] = os.path.join(work, "dedupe.fq.gz")
    d["dedupe_distinct"], d["dedupe_planted"] = make_dedupe_reads(d["dedupe"], seed)
    for tag, src in (("dedupe_check", d["dedupe"]), ("clump_check", fq)):
        d[tag] = os.path.join(work, f"{tag}.fq.gz")
        head_fastq(src, d[tag], A8A_CHECK_READS)
    d["norm_in"] = asm["region.fq.gz"]
    return d


def a8a_phases(asm: dict, a2: dict, a8: dict, work: str, card: str, phase_s: dict):
    """The A8a tools through the CLI on device=cuda, each with its device
    route required on the card: seal (six references) over config #1's
    reads with phiX planted, bbnorm over config #2's reads, ecc over the
    reads of config #5's region, loglog over config #2's reads (held to
    kmercountexact's distinct count), dedupe over its planted reads,
    clumpify over config #1's reads and dedupe=t over dedupe's."""

    def w(name):
        return os.path.join(work, name)

    # ---- seal: the bucket index of six references, votes on the card ----
    t0 = time.perf_counter()
    st = w("seal.cuda.txt")
    refs = ",".join(a8["seal_refs"])
    total = a2["side_total"]
    _, dt, _ = run_routed("seal", "seal", [f"in={a2['side']}", f"ref={refs}", "k=31",
                                           f"stats={st}"], {"seal_votes": None})
    with open(st) as fh:
        rows = {ln.split("\t")[0]: int(ln.split("\t")[1]) for ln in fh if ln[0] != "#"}
    phix = rows[a8["seal_refs"][-1]]
    print(f"seal k=31, {len(a8['seal_refs'])} references device=cuda: {total} reads in "
          f"{dt:.2f} s = {total / dt:.0f} reads/s (wall, incl. the index build and IO) on "
          f"{card}; phiX {phix} (planted {a2['side_planted']}), unmatched "
          f"{rows['*unmatched*']}, the genomes' files {total - phix - rows['*unmatched*']}")
    if phix != a2["side_planted"] or rows["*unmatched*"] != total - phix:
        raise AssertionError(f"seal: {rows}")
    phase_s["seal"] = time.perf_counter() - t0

    # ---- bbnorm (the sketch and the depths on the card), then ecc ----
    t0 = time.perf_counter()
    (kept, tossed), dt, _ = run_routed(
        "bbnorm", "bbnorm", [f"in={asm['reads.fq.gz']}", f"out={w('norm.cuda.fq')}",
                             f"outt={w('norm.cuda.toss.fq')}", *BBNORM_FLAGS],
        {"cms_add": None, "read_depths": None})
    share = kept / ASM_READS
    want = 10 / asm["depth31"]
    print(f"bbnorm {' '.join(BBNORM_FLAGS)} device=cuda: {ASM_READS} reads in {dt:.2f} s = "
          f"{ASM_READS / dt:.0f} reads/s (wall, two passes) on {card}; kept {kept} "
          f"({share:.4f}; target over the 31-mer depth {want:.4f}), tossed {tossed}")
    if kept + tossed != ASM_READS or abs(share - want) > 0.25 * want:
        raise AssertionError(f"bbnorm: kept {kept} of {ASM_READS}")
    n_ecc = asm["region_reads"]
    argv = a8a_check_runs(a8, work)["ecc"]("cuda").argv  # its check's CUDA half
    _, dt, log = run_routed("ecc", "ecc", argv[1:], {"cms_add": 1})
    fixed = int(log.split("Errors Corrected:")[1].split()[0])
    print(f"ecc device=cuda: {n_ecc} reads (config #5's region, ~30x) in {dt:.2f} s = "
          f"{n_ecc / dt:.0f} reads/s on {card} (a sketch query on the card per k-mer "
          f"tested); {fixed} errors corrected")
    if not fixed:
        raise AssertionError("ecc: no error corrected")
    phase_s["bbnorm, ecc"] = time.perf_counter() - t0

    # ---- loglog, against kmercountexact's exact distinct count ----
    t0 = time.perf_counter()
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        _, dt, _ = run_routed("loglog", "loglog", [f"in={asm['reads.fq.gz']}", "k=31"],
                              {"loglog_update": None})
    card_est = int(text.getvalue().split("Cardinality:")[1].split()[0])
    exact = asm["kce31_unique"]
    print(f"loglog k=31 device=cuda: {ASM_READS} reads in {dt:.2f} s = {ASM_READS / dt:.0f} "
          f"reads/s on {card}; cardinality {card_est}, kmercountexact's distinct 31-mers "
          f"{exact} ({card_est / exact - 1:+.4f})")
    if abs(card_est / exact - 1) > LOGLOG_BAND:
        raise AssertionError(f"loglog: {card_est} against {exact}")
    phase_s["loglog"] = time.perf_counter() - t0

    # ---- kmerlimit: config #2's reads until LogLog counts the limit ----
    t0 = time.perf_counter()
    limit = exact // KMERLIMIT_SHARE
    lim = {d: w(f"kmerlimit.{d}.fq") for d in ("cuda", "cpu")}
    argv = [f"in={asm['reads.fq.gz']}", f"limit={limit}"]
    n_out, dt, log = run_routed("kmerlimit", "kmerlimit", [*argv, f"out={lim['cuda']}"],
                                {"loglog_update": None})
    n_cpu, dt_cpu, log_cpu = run_tool("kmerlimit", [*argv, f"out={lim['cpu']}"], "cpu")
    count = int(log.split("Unique Kmers:")[1].split()[0])
    print(f"kmerlimit k=31 limit={limit} (a quarter of kmercountexact's {exact}) device=cuda: "
          f"{n_out} of {ASM_READS} reads passed in {dt:.2f} s = {n_out / dt:.0f} reads/s on "
          f"{card}; LogLog's count at the stop {count}; device=cpu {dt_cpu:.2f} s")
    if not 0 < n_out < ASM_READS or count < limit:
        raise AssertionError(f"kmerlimit: {n_out} reads passed, count {count}")
    if (n_cpu, log_cpu) != (n_out, log) or read_all([lim["cuda"]]) != read_all([lim["cpu"]]):
        raise AssertionError("kmerlimit: cuda and cpu outputs differ")
    print(f"kmerlimit: cuda == cpu ({n_out} reads, {os.path.getsize(lim['cuda'])} bytes, "
          f"stderr equal)")
    phase_s["kmerlimit"] = time.perf_counter() - t0

    # ---- dedupe s=2 e=2: fuzzy pairs on the banded edit distance ----
    t0 = time.perf_counter()
    n_dd = a8["dedupe_distinct"] + a8["dedupe_planted"]
    (kept, dupes), dt, _ = run_routed(
        "dedupe", "dedupe", [f"in={a8['dedupe']}", f"out={w('dd.cuda.fq')}",
                             f"outd={w('dd.cuda.dup.fq')}", *DEDUPE_FLAGS],
        {"banded_edits": None})
    print(f"dedupe {' '.join(DEDUPE_FLAGS)} device=cuda: {n_dd} reads in {dt:.2f} s = "
          f"{n_dd / dt:.0f} reads/s on {card}; kept {kept} (planted distinct "
          f"{a8['dedupe_distinct']}), duplicates {dupes} (planted {a8['dedupe_planted']})")
    if (kept, dupes) != (a8["dedupe_distinct"], a8["dedupe_planted"]):
        raise AssertionError(f"dedupe: kept {kept}, duplicates {dupes}")
    phase_s["dedupe"] = time.perf_counter() - t0

    # ---- clumpify k=31, then dedupe=t on dedupe's reads ----
    t0 = time.perf_counter()
    for tag, fin, flags, n_in, want_dupes in (
            ("clumpify", a8["fq"], ["k=31"], a8["fq_reads"], 0),
            ("clumpify dedupe=t", a8["dedupe"], ["dedupe=t"], n_dd, DEDUPE_EXACT // 2)):
        o = w(f"{tag.replace(' ', '_')}.cuda.fq.gz")
        (n, dupes), dt, _ = run_routed(tag, "clumpify", [f"in={fin}", f"out={o}", *flags],
                                       {"pivot_kmers": None})
        print(f"{tag} device=cuda: {n} reads in {dt:.2f} s = {n / dt:.0f} reads/s on {card}; "
              f"{dupes} duplicates removed (the same-strand exact copies: {want_dupes})")
        if n != n_in or dupes != want_dupes:
            raise AssertionError(f"{tag}: {n} reads, {dupes} removed")
    phase_s["clumpify"] = time.perf_counter() - t0


def a8a_check_runs(a8: dict, work: str) -> dict:
    """The CLI runs of the A8a tools' CUDA-against-CPU checks: name ->
    (argv on device d, d's output files): seal on SEAL_CHECK_READS reads,
    bbnorm on config #5's region (~30x), ecc (the phase's own run on the
    card), dedupe s=2 e=2 ac=t and clumpify on A8A_CHECK_READS reads."""
    def w(name):
        return os.path.join(work, name)

    def tool(name, fin, flags, outs):
        return lambda d: Check([name, f"in={fin}", *flags,
                                *(f"{k}={w(f'{d}.{v}')}" for k, v in outs)],
                               [w(f"{d}.{v}") for _, v in outs])

    return {
        "seal": tool("seal", a8["seal_check"], ["k=31", f"ref={','.join(a8['seal_refs'])}"],
                     [("stats", "sealchk.txt")]),
        "bbnorm": tool("bbnorm", a8["norm_in"], BBNORM_FLAGS,
                       [("out", "normchk.fq"), ("outt", "normchk.toss.fq")]),
        "ecc": tool("ecc", a8["norm_in"], [], [("out", "eccchk.fq")]),
        "dedupe": tool("dedupe", a8["dedupe_check"], [*DEDUPE_FLAGS, "ac=t"],
                       [("out", "ddchk.fq"), ("outd", "ddchk.dup.fq")]),
        "clumpify": tool("clumpify", a8["clump_check"], ["k=31"], [("out", "clchk.fq")]),
        "clumpify dedupe=t": tool("clumpify", a8["dedupe_check"], ["dedupe=t"],
                                  [("out", "cldchk.fq")]),
    }


def loglog_check(asm: dict):
    """LogLog's bucket maxima over config #2's first CHECK_READS reads on
    both devices, element for element."""
    from bbtools_torch.io.fastq import FastqReader
    from bbtools_torch.models.loglog import LogLog

    ll = {d: LogLog(buckets=2048, k=31, device=d) for d in ("cuda", "cpu")}
    for b in FastqReader(asm["head.fq.gz"]):
        for x in ll.values():
            x.add_batch(b.bases, b.lengths)
    import torch

    if not torch.equal(ll["cuda"].maxima.cpu(), ll["cpu"].maxima):
        raise AssertionError("loglog: cuda and cpu bucket maxima differ")
    print(f"loglog: cuda == cpu on {CHECK_READS} reads (2,048 bucket maxima; cardinality "
          f"{ll['cuda'].cardinality()})")


def consensus_records(rtype: str) -> list[tuple[bytes, bytes]]:
    """(name, sequence) of each record of a bundled rRNA consensus file
    (the JAX package's resources, read by path)."""
    path = os.path.join(HERE, "bbtools_tpu", "resources", f"{rtype}_consensus_sequence.fa")
    recs = []
    with open(path, "rb") as fh:
        for ln in fh:
            ln = ln.strip()
            if ln.startswith(b">"):
                recs.append([ln[1:], b""])
            elif ln:
                recs[-1][1] += ln
    return [(n, s) for n, s in recs]


def make_ata_seqs(path: str, n: int, rng) -> np.ndarray:
    """alltoall's input: n variants of the 16S universal consensus, each
    at an identity drawn from ATA_ID_RANGE (substitutions) with 1-3
    indels of 1-3 bp. Returns the planted identity of every pair: the
    matches over the columns of the alignment the mutations induce."""
    acgt = np.frombuffer(b"ACGT", np.uint8)
    base = np.searchsorted(acgt, np.frombuffer(consensus_records("16S")[0][1], np.uint8))
    L = len(base)
    kept = np.ones((n, L), bool)
    codes = np.tile(base, (n, 1))
    n_ins = np.zeros(n, np.int64)
    with open(path, "wb") as fh:
        for i in range(n):
            sub = rng.choice(L, int(round((1 - rng.uniform(*ATA_ID_RANGE)) * L)), replace=False)
            codes[i, sub] = (codes[i, sub] + rng.integers(1, 4, len(sub))) % 4
            ins_at = {}
            for _ in range(int(rng.integers(1, 4))):
                at, k = int(rng.integers(10, L - 10)), int(rng.integers(1, 4))
                if rng.random() < 0.5:
                    kept[i, at:at + k] = False
                else:
                    ins_at[at] = rng.integers(0, 4, k)
            n_ins[i] = sum(len(v) for v in ins_at.values())
            pieces = []
            for at in range(L):
                if at in ins_at:
                    pieces.append(ins_at[at])
                if kept[i, at]:
                    pieces.append(codes[i, at:at + 1])
            fh.write(b">v%d\n%s\n" % (i, acgt[np.concatenate(pieces)].tobytes()))
    planted = np.eye(n)
    for i in range(n):
        matches = (kept[i] & kept & (codes[i] == codes)).sum(axis=1)
        cols = (kept[i] | kept).sum(axis=1) + n_ins[i] + n_ins
        planted[i] = np.where(np.arange(n) == i, 1.0, matches / cols)
    return planted


def make_ribo_reads(path: str, n: int, rng) -> dict:
    """splitribo's input: n reads, a quarter of each type of
    RIBO_TYPES, cut from the type's universal and clade records (not the
    16S plastid and mitochondria and 18S mitochondria records, which are
    the p16S, m16S and m18S types): RIBO_LEN bp at a random start (5S
    records whole), RIBO_SUB substitutions, shuffled. Returns the planted
    count of each type."""
    acgt = np.frombuffer(b"ACGT", np.uint8)
    reads = []
    for t in RIBO_TYPES:
        recs = [s for name, s in consensus_records(t)
                if not name.startswith((b"plastid", b"mitochondria"))]
        for i in range(n // len(RIBO_TYPES)):
            s = np.frombuffer(recs[int(rng.integers(0, len(recs)))], np.uint8)
            ln = min(len(s), int(rng.integers(*RIBO_LEN)))
            at = int(rng.integers(0, len(s) - ln + 1))
            r = s[at:at + ln].copy()
            sub = rng.choice(ln, int(rng.uniform(*RIBO_SUB) * ln), replace=False)
            r[sub] = acgt[rng.integers(0, 4, len(sub))]
            reads.append(b">%s_%d\n%s\n" % (t.encode(), i, r.tobytes()))
    with open(path, "wb") as fh:
        fh.write(b"".join(reads[j] for j in rng.permutation(len(reads))))
    return {t: n // len(RIBO_TYPES) for t in RIBO_TYPES}


def make_subreads(path: str, codes, zmws: int, planted: int, rng) -> tuple[int, int, int]:
    """icecream's input: `zmws` ZMWs of IC_PASSES PacBio-named subreads
    (movie/zmw/start_end), each ZMW an insert of IC_LEN bp of the genome
    read on alternate strands with 1% substitutions; one subread of
    `planted` ZMWs carries a missed adapter: the first half of the pass,
    then its reverse complement. Returns (subreads, planted, planted of
    even length)."""
    acgt = np.frombuffer(b"ACGT", np.uint8)
    planted = set(rng.choice(zmws, planted, replace=False).tolist())
    out = []
    even = 0
    for z in range(zmws):
        ln = int(rng.integers(*IC_LEN))
        at = int(rng.integers(0, len(codes) - ln))
        insert = codes[at:at + ln]
        bad_pass = int(rng.integers(0, IC_PASSES)) if z in planted else -1
        pos = 0
        for k in range(IC_PASSES):
            c = insert if (k + z) % 2 == 0 else (3 - insert)[::-1]
            c = c.copy()
            sub = rng.choice(ln, ln // 100, replace=False)
            c[sub] = rng.integers(0, 4, len(sub))
            if k == bad_pass:
                c[ln // 2:] = (3 - c[: ln - ln // 2])[::-1]
                even += ln % 2 == 0
            out.append(b"@m64011_220101_000000/%d/%d_%d\n%s\n+\n%s\n" % (
                z, pos, pos + ln, acgt[c].tobytes(), b"~" * ln))
            pos += ln + 45  # the adapter between passes
    with gzip.open(path, "wb", compresslevel=1) as fh:
        fh.write(b"".join(out))
    return len(out), len(planted), even


def make_l5_data(work: str, genome, seed: int) -> dict:
    """The inputs of the phase of the tools on the glocal identity
    aligner (ROADMAP L5): alltoall's sequences and planted identities,
    splitribo's reads, icecream's subreads, and the heads of their
    CUDA-against-CPU checks."""
    rng = np.random.default_rng(seed)
    d = {"ata": os.path.join(work, "ata.fa"), "ribo": os.path.join(work, "ribo.fa"),
         "pb": os.path.join(work, "pb.fq.gz")}
    d["ata_planted"] = make_ata_seqs(d["ata"], ATA_SEQS, rng)
    d["ribo_planted"] = make_ribo_reads(d["ribo"], RIBO_READS, rng)
    d["pb_reads"], d["pb_planted"], d["pb_even"] = make_subreads(
        d["pb"], genome.scaffold_codes(0), IC_ZMWS, IC_PLANTED, rng)
    with open(d["ata"], "rb") as fh:
        ata = fh.read().splitlines(keepends=True)
    with open(d["ribo"], "rb") as fh:
        ribo = fh.read().splitlines(keepends=True)
    for tag, lines, n in (("ata_check", ata, ATA_CHECK_SEQS), ("idm_check", ata, IDM_CHECK_SEQS),
                          ("ribo_check", ribo, RIBO_CHECK_READS)):
        d[tag] = os.path.join(work, f"{tag}.fa")
        with open(d[tag], "wb") as fh:
            fh.writelines(lines[: 2 * n])
    d["pb_check"] = os.path.join(work, "pb_check.fq.gz")
    head_fastq(d["pb"], d["pb_check"], IC_CHECK_READS)
    return d


def ata_host_pairs(fasta: str, pct, dev) -> list[tuple[int, int, float, float]]:
    """The ATA_HOST_PAIRS pairs (i < j) of alltoall's matrix `pct` farthest
    from their planted identity (`dev`, over the upper triangle: where
    the gaps' placement, and so the tie rules, count most) against the
    host aligner: (i, j, the printed percentage, 100 x glocal_align_np's
    identity of query i against reference j, as alltoall aligns them)."""
    from bbtools_torch.core.dna import BASE_TO_CODE
    from bbtools_torch.ops.idalign import glocal_align_np

    with open(fasta, "rb") as fh:
        seqs = [BASE_TO_CODE[np.frombuffer(ln.strip(), np.uint8)]
                for ln in fh.read().splitlines()[1::2]]
    iu = np.triu_indices(len(seqs), 1)
    out = []
    for k in np.argsort(-dev, kind="stable")[:ATA_HOST_PAIRS]:
        i, j = int(iu[0][k]), int(iu[1][k])
        out.append((i, j, float(pct[i, j]), 100 * glocal_align_np(seqs[i], seqs[j])[0]))
    return out


def l5_phases(l5: dict, fq: str, n_fq: int, work: str, card: str, phase_s: dict):
    """reformat (qtrim) over config #1's reads and the tools on the glocal
    identity aligner through the CLI on device=cuda, each with its device
    route required on the card: alltoall over ATA_SEQS 16S variants (each
    pair within ATA_TOLERANCE of its planted identity), splitribo over
    RIBO_READS rRNA reads (each type's count the planted one), icecream
    trim=t and kzt=t over the subreads (flagged and discarded held to the
    folded subreads of even length), testalignersbatch length=2000
    samples=10 and testalignerslength at its defaults (its 3,000 bp on the
    banded route)."""

    def w(name):
        return os.path.join(work, name)

    # ---- reformat qtrim=rl trimq=10 minlen=40: optimal_trim on the card ----
    t0 = time.perf_counter()
    out = w("reformat.cuda.fq")
    (n_out, _), dt, _ = run_routed("reformat", "reformat",
                                           [f"in={fq}", f"out={out}", *REFORMAT_FLAGS],
                                           {"optimal_trim": None})
    lens_in = fastq_lengths(fq)
    lens_out = fastq_lengths(out)
    trimmed = sum(lens_out[k] < lens_in[k] for k in lens_out)
    print(f"reformat {' '.join(REFORMAT_FLAGS)} device=cuda: {n_fq} reads in {dt:.2f} s = "
          f"{n_fq / dt:.0f} reads/s on {card}; kept {n_out}, {trimmed} of them trimmed, "
          f"{n_fq - n_out} removed (under 40 bp after the trim)")
    if n_out != len(lens_out) or not 0 < trimmed < n_out <= n_fq:
        raise AssertionError(f"reformat: kept {n_out}, trimmed {trimmed}")
    phase_s["reformat"] = time.perf_counter() - t0

    # ---- alltoall: 8,128 pairs of 16S variants in 16 calls ----
    t0 = time.perf_counter()
    n = ATA_SEQS
    pairs = n * (n - 1) // 2
    calls = -(-pairs // 512)
    matrix = w("ata.cuda.txt")
    _, dt, _ = run_routed("alltoall", "alltoall", [f"in={l5['ata']}", f"out={matrix}"],
                          {"glocal_identity": calls})
    with open(matrix) as fh:
        rows = [ln.split("\t")[1:] for ln in fh.read().splitlines()[1:]]
    pct = np.array(rows, np.float64)
    dev = np.abs(pct / 100 - l5["ata_planted"])[np.triu_indices(n, 1)]
    print(f"alltoall device=cuda: {n} variants of the 16S consensus, {pairs} pairs in "
          f"{dt:.2f} s = {pairs / dt:.0f} pairs/s, {dt / calls:.3f} s a call of <= 512 pairs "
          f"({calls} calls) on {card}; |identity - planted| mean {dev.mean():.4f}, max "
          f"{dev.max():.4f} (tolerance {ATA_TOLERANCE})")
    if dev.max() > ATA_TOLERANCE:
        raise AssertionError(f"alltoall: max deviation {dev.max():.4f}")
    host = ata_host_pairs(l5["ata"], pct, dev)
    print("alltoall against the host aligner (glocal_align_np), the pairs farthest from "
          "their planted identity: " + ", ".join(f"v{i}-v{j} {p:.2f} / {h:.4f}"
                                                 for i, j, p, h in host))
    if any(abs(p - h) > 0.005 + 1e-5 for _, _, p, h in host):
        raise AssertionError(f"alltoall: the card's identities differ from the host's: {host}")
    phase_s["alltoall"] = time.perf_counter() - t0

    # ---- splitribo: each type's count ----
    t0 = time.perf_counter()
    _, dt, log = run_routed("splitribo", "splitribo",
                            [f"in={l5['ribo']}", f"out={w('ribo.cuda_#.fa')}"],
                            {"glocal_identity": None})
    counts = {m[1]: int(m[2]) for m in re.finditer(r"^(\S+):\t(\d+)$", log, re.M)}
    print(f"splitribo device=cuda: {RIBO_READS} reads in {dt:.2f} s = {RIBO_READS / dt:.0f} "
          f"reads/s on {card}; routed {counts} (planted {l5['ribo_planted']})")
    if counts != l5["ribo_planted"]:
        raise AssertionError(f"splitribo: routed {counts}")
    phase_s["splitribo"] = time.perf_counter() - t0

    # ---- icecream trim=t, then kzt=t ----
    t0 = time.perf_counter()
    for mode in ("trim=t", "kzt=t"):
        tag = mode.split("=")[0]
        tool, dt, log = run_routed(f"icecream {mode}", "icecream",
                                   [f"in={l5['pb']}", f"outg={w(f'ic_{tag}.cuda.fq')}",
                                    f"outb={w(f'ic_{tag}.cuda.bad.fq')}", mode],
                                   {"glocal_identity": None})
        flagged = tool.flagged
        zmws = getattr(tool, "zmws_flagged", None)
        print(f"icecream {mode} device=cuda: {l5['pb_reads']} subreads of {IC_LEN[0]}-"
              f"{IC_LEN[1]} bp in {dt:.2f} s = {l5['pb_reads'] / dt:.1f} subreads/s on {card}; "
              f"flagged {flagged} (planted {l5['pb_planted']}, {l5['pb_even']} of them of even "
              f"length), ZMWs discarded {zmws}, bases trimmed {tool.trimmed_bases}")
        if flagged != l5["pb_even"] or zmws not in (None, l5["pb_even"]):
            raise AssertionError(f"icecream {mode}: flagged {flagged}, ZMWs {zmws}")
    phase_s["icecream"] = time.perf_counter() - t0

    # ---- the aligner ladders: exact glocal, and banded at 3,000 bp ----
    t0 = time.perf_counter()
    for name, argv, needs in (
            ("testalignersbatch", ["length=2000", "samples=10"], {"glocal_identity": 29}),
            ("testalignerslength", [], {"glocal_identity": 3, "banded_edits": 1})):
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            _, dt, _ = run_routed(name, name, argv, needs)
        table = [ln.split("\t") for ln in text.getvalue().splitlines() if ln[:1].isdigit()]
        n_pairs = sum(int(r[3]) for r in table)
        print(f"{' '.join([name, *argv])} device=cuda: {len(table)} levels, {n_pairs} pairs in "
              f"{dt:.2f} s on {card}; " + ", ".join(f"{r[0]}: {r[1]}" for r in table))
        if name == "testalignersbatch":
            top = {float(r[0]): float(r[1]) for r in table}
            if top[1.0] != 1.0 or any(abs(v - a) > LADDER_TOLERANCE
                                      for a, v in top.items() if a >= 0.75):
                raise AssertionError(f"{name}: {top}")
    phase_s["aligner ladders"] = time.perf_counter() - t0


def fastq_lengths(path: str) -> dict:
    """name -> length of each record of a FASTQ file (gzipped or not)."""
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rb") as fh:
        lines = fh.read().split(b"\n")
    return {lines[i][1:]: len(lines[i + 1]) for i in range(0, len(lines) - 3, 4)}


def l5_check_runs(l5: dict, small: str, work: str) -> dict:
    """The CLI runs of the CUDA-against-CPU checks of reformat and the
    tools on L5: name -> (argv on device d, d's output files): reformat
    on config #1's first CHECK_READS reads, alltoall on the first
    ATA_CHECK_SEQS sequences and idmatrix on IDM_CHECK_SEQS, splitribo and
    mergeribo on RIBO_CHECK_READS reads, icecream (both modes) on
    IC_CHECK_READS subreads and both aligner ladders (their tables on
    standard output, which goes to a file)."""
    def w(name):
        return os.path.join(work, name)

    def icecream(mode):
        tag = f"ic{mode[0]}chk"
        return lambda d: Check(["icecream", f"in={l5['pb_check']}", mode,
                                f"outg={w(f'{tag}.{d}.fq')}", f"outb={w(f'{tag}.{d}.b.fq')}"],
                               [w(f"{tag}.{d}.fq"), w(f"{tag}.{d}.b.fq")])

    def ladder(name, tag, flags):
        return lambda d: Check([name, *flags], [w(f"{tag}.{d}.txt")], w(f"{tag}.{d}.txt"))

    return {
        "splitribo": lambda d: Check(["splitribo", f"in={l5['ribo_check']}",
                                      f"out={w(f'ribochk.{d}_#.fa')}"],
                                     [w(f"ribochk.{d}_{t}.fa") for t in RIBO_TYPES]),
        "icecream kzt=t": icecream("kzt=t"),
        "icecream trim=t": icecream("trim=t"),
        "mergeribo": lambda d: Check(["mergeribo", f"in={l5['ribo_check']}",
                                      f"out={w(f'mribochk.{d}.fa')}"], [w(f"mribochk.{d}.fa")]),
        "alltoall": lambda d: Check(["alltoall", f"in={l5['ata_check']}",
                                     f"out={w(f'atachk.{d}.txt')}"], [w(f"atachk.{d}.txt")]),
        "idmatrix": lambda d: Check(["idmatrix", f"in={l5['idm_check']}",
                                     f"out={w(f'idmchk.{d}.txt')}"], [w(f"idmchk.{d}.txt")]),
        "reformat": lambda d: Check(["reformat", f"in={small}", f"out={w(f'rfchk.{d}.fq')}",
                                     *REFORMAT_FLAGS], [w(f"rfchk.{d}.fq")]),
        "testalignersbatch": ladder("testalignersbatch", "tabchk", LADDER_CHECK),
        "testalignerslength": ladder("testalignerslength", "talchk", ["samples=4"]),
    }


class CpuSide:
    """CLI runs on device=cpu (and the CUDA halves of the A2/A4b and A8a
    checks), taken in order by `workers` threads, each run in its own
    process (one torch thread), while this process runs the other
    checks' CUDA halves: the plain versions (the fill of long reads above
    all) take minutes on the host. Each process gets this process's
    sys.argv, which the SAM writers put into the @PG line, so that the
    bytes compare, and runs its tool through cli_call, writing the
    tool's REPORTED attributes for `report(name)`. `add(runs)` queues
    more runs, until `close()`. `wait(name)` blocks until that run has
    ended and returns its seconds, raising if it failed (a name another
    side holds is that side's to wait for); `stop` kills the runs still
    going (main stops every one started, `started`)."""

    started: list = []
    CODE = ("import json, sys\n"
            "sys.argv, argv, stdout, report = json.loads(sys.argv[1])\n"
            "from chip_smoke import cli_call, write_report\n"
            "write_report(cli_call(argv, stdout), report)\n")

    def __init__(self, runs: list, work: str, workers: int = CPU_SIDE_WORKERS,
                 tag: str = "cpu_side"):
        """runs: [(name, argv with its device=, the file its standard
        output goes to or None)], in the order they start."""
        import threading

        CpuSide.started.append(self)
        self.runs, self.log = list(runs), os.path.join(work, tag)
        self.names = {name for name, _, _ in self.runs}
        self.done: dict[str, tuple[int, float]] = {}
        self.cond = threading.Condition()
        self.procs: dict[int, subprocess.Popen] = {}
        self.next = 0
        self.stopped = self.closed = False
        self.threads = [threading.Thread(target=self._run, args=(i,), daemon=True)
                        for i in range(workers)]
        for t in self.threads:
            t.start()

    def _report_path(self, name: str) -> str:
        return f"{self.log}.{re.sub(r'[^A-Za-z0-9]+', '_', name)}.json"

    def report(self, name: str) -> dict:
        """The REPORTED attributes of run `name`'s tool (after wait)."""
        if name not in self.names:
            return side_of(name).report(name)
        with open(self._report_path(name)) as fh:
            return json.load(fh)

    def add(self, runs: list):
        with self.cond:
            self.runs += runs
            self.names |= {name for name, _, _ in runs}
            self.cond.notify_all()

    def close(self):
        """No more runs: the workers end when the queue is empty."""
        with self.cond:
            self.closed = True
            self.cond.notify_all()

    def _run(self, worker: int):
        env = dict(os.environ, OMP_NUM_THREADS="1")
        with open(f"{self.log}.{worker}.log", "wb") as log:
            while True:
                with self.cond:
                    while not (self.stopped or self.closed or self.next < len(self.runs)):
                        self.cond.wait()
                    if self.stopped or self.next == len(self.runs):
                        break
                    name, argv, stdout = self.runs[self.next]
                    self.next += 1
                t0 = time.perf_counter()
                spec = [sys.argv, argv, stdout, self._report_path(name)]
                proc = self.procs[worker] = subprocess.Popen(
                    [sys.executable, "-c", self.CODE, json.dumps(spec)],
                    cwd=HERE, env=env, stdout=log, stderr=subprocess.STDOUT)
                rc = proc.wait()
                with self.cond:
                    self.done[name] = (rc, time.perf_counter() - t0)
                    self.cond.notify_all()
        with self.cond:
            self.cond.notify_all()

    def wait(self, name: str) -> float:
        if name not in self.names:
            return side_of(name).wait(name)
        with self.cond:
            while name not in self.done and not (
                    self.stopped or not any(t.is_alive() for t in self.threads)):
                self.cond.wait(timeout=1.0)
        rc, secs = self.done.get(name, (-1, 0.0))
        if rc:
            for i in range(len(self.threads)):
                with open(f"{self.log}.{i}.log", errors="replace") as fh:
                    print(fh.read()[-3000:])
            raise AssertionError(f"the CPU run of {name} failed (rc {rc})")
        return secs

    def stop(self):
        with self.cond:
            self.stopped = True
            self.cond.notify_all()
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
        for t in self.threads:
            t.join()


def make_msa_reads(path: str, primers_fa: str, ata_fa: str, n: int, rng) -> list:
    """msa's input: n FASTQ reads of MSA_LEN bp cut from the 16S variants
    of `ata_fa` inside MSA_AWAY (clear of the primers' own sites), and
    the primers of MSA_PRIMERS cut from the 16S consensus (`primers_fa`).
    One of the four primer rows (forward, then the reverse complements,
    in msa's order) is planted with 0-2 substitutions at a random offset
    in MSA_PLANTED_SHARE of the reads. Returns the plantings: (read
    index, row, 0-based offset, substitutions)."""
    acgt = np.frombuffer(b"ACGT", np.uint8)
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    cons = consensus_records("16S")[0][1]
    prim = [cons[at:at + ln] for at, ln in MSA_PRIMERS]
    with open(primers_fa, "wb") as fh:
        fh.write(b"".join(b">p%d\n%s\n" % (i, p) for i, p in enumerate(prim)))
    rows = prim + [p.translate(comp)[::-1] for p in prim]
    with open(ata_fa, "rb") as fh:
        variants = fh.read().splitlines()[1::2]
    planted, recs = [], []
    for i in range(n):
        v = variants[int(rng.integers(0, len(variants)))]
        lo, hi = MSA_AWAY[int(rng.integers(0, len(MSA_AWAY)))]
        hi = min(hi, len(v))
        ln = min(int(rng.integers(*MSA_LEN)), hi - lo)
        at = int(rng.integers(lo, hi - ln + 1))
        r = np.frombuffer(v[at:at + ln], np.uint8).copy()
        if rng.random() < MSA_PLANTED_SHARE:
            row = int(rng.integers(0, len(rows)))
            p = np.frombuffer(rows[row], np.uint8).copy()
            nm = int(rng.integers(0, 3))
            for j in rng.choice(len(p), nm, replace=False):
                p[j] = acgt[(int(np.searchsorted(acgt, p[j])) + int(rng.integers(1, 4))) % 4]
            d = int(rng.integers(0, ln - len(p) + 1))
            r[d:d + len(p)] = p
            planted.append((i, row, d, nm))
        recs.append(b"@m%d\n%s\n+\n%s\n" % (i, r.tobytes(), b"I" * ln))
    with gzip.open(path, "wb", compresslevel=1) as fh:
        fh.write(b"".join(recs))
    return planted


def make_ifa_data(work: str, codes, rng) -> dict:
    """indelfree's input: the first IFA_QUERIES records of the bundled
    CRISPR panel, and a copy of `codes` (the E. coli-length genome) with
    IFA_PLANTED of them planted, each with 0-3 substitutions, forward or
    reverse-complemented, at non-overlapping positions: the first
    IFA_CHECK_PLANTED among the check's queries and within its head.
    Returns the paths and the plantings (name, strand, 1-based position,
    substitutions); the check's queries and reference head."""
    from bbtools_torch.core.dna import CODE_TO_BASE, encode
    from bbtools_torch.io.fasta import iter_fasta, write_fasta

    panel = os.path.join(HERE, "bbtools_tpu", "resources", "crisprs.fa.gz")
    recs = []
    for rec in iter_fasta(panel):
        recs.append((rec.name.split()[0], encode(rec.seq)))
        if len(recs) == IFA_QUERIES:
            break
    d = {"queries": os.path.join(work, "spacers.fa"), "ref": os.path.join(work, "ifa_ref.fa"),
         "check_q": os.path.join(work, "spacers_check.fa"),
         "check_ref": os.path.join(work, "ifa_ref_check.fa")}
    write_fasta(d["queries"], [(n, CODE_TO_BASE[s].tobytes()) for n, s in recs])
    write_fasta(d["check_q"], [(n, CODE_TO_BASE[s].tobytes())
                               for n, s in recs[:IFA_CHECK_QUERIES]])
    genome = codes.copy()
    picks = np.concatenate([
        rng.choice(IFA_CHECK_QUERIES, IFA_CHECK_PLANTED, replace=False),
        rng.choice(np.arange(IFA_CHECK_QUERIES, len(recs)), IFA_PLANTED - IFA_CHECK_PLANTED,
                   replace=False)])
    slot = 100  # one planting a slot of 100 bp, the panel's longest fits
    slots = np.concatenate([
        rng.choice(IFA_CHECK_BP // slot - 1, IFA_CHECK_PLANTED, replace=False),
        IFA_CHECK_BP // slot + rng.choice((len(codes) - IFA_CHECK_BP) // slot - 1,
                                          IFA_PLANTED - IFA_CHECK_PLANTED, replace=False)])
    d["planted"] = []
    for q, sl in zip(picks.tolist(), slots.tolist()):
        name, s = recs[q]
        s = s.copy()
        nm = int(rng.integers(0, 4))
        for j in rng.choice(len(s), nm, replace=False):
            s[j] = (s[j] + int(rng.integers(1, 4))) % 4
        strand = int(rng.integers(0, 2))
        if strand:
            s = (3 - s)[::-1]
        pos = sl * slot + int(rng.integers(0, slot - len(s)))
        genome[pos:pos + len(s)] = s
        d["planted"].append((name, strand, pos + 1, nm))
    write_fasta(d["ref"], [(b"ecoli_len_ifa", CODE_TO_BASE[genome].tobytes())])
    write_fasta(d["check_ref"], [(b"ecoli_len_ifa", CODE_TO_BASE[genome[:IFA_CHECK_BP]]
                                  .tobytes())])
    return d


def make_poly_reads(src: str, dst: str, rng) -> int:
    """polyfilter's input: the reads of `src` (config #1), one in
    POLY_EVERY with its last POLY_TAIL bases (at most the read) made G.
    Returns the reads given a tail."""
    op = gzip.open if src.endswith(".gz") else open
    with op(src, "rb") as fh:
        lines = fh.read().split(b"\n")
    tails = 0
    for i in range(0, len(lines) - 3, 4):
        if (i // 4) % POLY_EVERY == POLY_EVERY - 1:
            s = lines[i + 1]
            t = min(len(s), int(rng.integers(POLY_TAIL[0], POLY_TAIL[1] + 1)))
            lines[i + 1] = s[:len(s) - t] + b"G" * t
            tails += 1
    with gzip.open(dst, "wb", compresslevel=1) as fh:
        fh.write(b"\n".join(lines))
    return tails


def make_ml_reads(work: str, rng) -> dict:
    """The CellNet family's input: ML_READS reads of 150 bp, half from
    each pool of ML_POOLS (label 1, then 0), as two gzipped FASTQ files."""
    d = {}
    for label, pool in zip((1, 0), ML_POOLS):
        seqs = np.frombuffer(pool, np.uint8)[rng.integers(0, len(pool), (ML_READS // 2, 150))]
        d[label] = os.path.join(work, f"ml_{label}.fq.gz")
        with gzip.open(d[label], "wb", compresslevel=1) as fh:
            fh.write(b"".join(b"@c%d_%d\n%s\n+\n%s\n" % (label, i, s.tobytes(), b"I" * 150)
                              for i, s in enumerate(seqs)))
    return d


def make_cal_rows(path: str, n: int, rng):
    """calibrate's input: n (score, label) rows, a label drawn with the
    logistic of 2 logit(score) + 0.5 (tests/test_research.py)."""
    x = rng.uniform(0.02, 0.98, n)
    p = 1.0 / (1 + np.exp(-(2.0 * np.log(x / (1 - x)) + 0.5)))
    y = (rng.random(n) < p).astype(float)
    with open(path, "w") as fh:
        fh.write("".join(f"{a:.5f}\t{b:.0f}\n" for a, b in zip(x, y)))


def make_a8c_data(work: str, genome, ref_fa: str, fq: str, bloom_fq: str, asm: dict,
                  l5: dict, seed: int) -> dict:
    """The inputs of the phase of the last device-using tools: msa's
    reads and primers, indelfree's panel and planted genome, polyfilter's
    reads, the CellNet family's reads, calibrate's rows, and the heads of
    their checks."""
    rng = np.random.default_rng(seed)

    def w(name):
        return os.path.join(work, name)

    d = {"msa": w("msa.fq.gz"), "primers": w("primers.fa"), "poly": w("poly.fq.gz"),
         "cal": w("cal.tsv"), "kc_in": asm["reads.fq.gz"], "ref_fa": ref_fa,
         "bloom_in": bloom_fq, "net": w("ml.cuda.bbnet")}
    d["msa_planted"] = make_msa_reads(d["msa"], d["primers"], l5["ata"], MSA_READS, rng)
    d["ifa"] = make_ifa_data(work, genome.scaffold_codes(0), rng)
    d["poly_tails"] = make_poly_reads(fq, d["poly"], rng)
    d["ml"] = make_ml_reads(work, rng)
    make_cal_rows(d["cal"], CAL_ROWS, rng)
    for tag, src, n in (("msa_check", d["msa"], MSA_CHECK_READS),
                        ("kc_check", d["kc_in"], A8A_CHECK_READS),
                        ("poly_check", d["poly"], A8A_CHECK_READS),
                        ("nn_check", fq, A8A_CHECK_READS),
                        ("nn_in", fq, NN_FILTER_READS),
                        ("bloom_check", bloom_fq, BLOOM_CHECK_READS)):
        d[tag] = w(f"{tag}.fq.gz")
        head_fastq(src, d[tag], n)
    d["ml_check"] = ml_vectors(d["ml"], work, ML_CHECK_ROWS, "ml_check")
    return d


def ml_vectors(ml: dict, work: str, rows: int | None, tag: str) -> str:
    """seqtovec (host only) of both classes, concatenated as
    tests/test_mltools.py does (the second file's header dropped), the
    first `rows` of each class where given: the training TSV's path."""
    out = os.path.join(work, f"{tag}.tsv")
    parts = []
    for label in (1, 0):
        fin = ml[label]
        if rows is not None:
            fin = os.path.join(work, f"{tag}_{label}.fq.gz")
            head_fastq(ml[label], fin, rows)
        tsv = os.path.join(work, f"{tag}_{label}.tsv")
        with contextlib.redirect_stderr(io.StringIO()):
            cli_call(["seqtovec", f"in={fin}", f"out={tsv}", f"result={label}"])
        with open(tsv, "rb") as fh:
            data = fh.read()
        parts.append(data if not parts else data.split(b"\n", 1)[1])
    with open(out, "wb") as fh:
        fh.write(b"".join(parts))
    return out


def sam_body(path: str) -> list[list[bytes]]:
    """The fields of each alignment line of a SAM file."""
    with open(path, "rb") as fh:
        return [ln.split(b"\t") for ln in fh.read().splitlines() if ln and ln[:1] != b"@"]


def a8c_phases(a8c: dict, fq: str, n_fq: int, work: str, card: str, phase_s: dict):
    """The last device-using tools through the CLI on device=cuda, each
    with its device route counted on the card: msa over MSA_READS reads
    (every planting found at its offset with its NM), indelfree over the
    planted genome in 71 chunks (every planting found), kmercoverage k=31
    hist= over config #2's reads, bloomfilter ref=<genome> over the
    bloom reads, polyfilter over config #1's reads with poly-G tails
    (their counts the JAX package's), seqtovec -> train -> netfilter and
    scoresequence over the first NN_FILTER_READS of config #1's reads
    (the net trained here, at a8c["net"]), and calibrate epochs=2000."""

    def w(name):
        return os.path.join(work, name)

    # ---- msa: best primer sites of every read (best_sites on the card) ----
    t0 = time.perf_counter()
    sam = w("msa.cuda.sam")
    n_out, dt, _ = run_routed("msa", "msa", [f"in={a8c['msa']}", f"ref={a8c['primers']}",
                                             f"out={sam}"], {"best_sites": None})
    names = [b"p0", b"p1", b"r_p0", b"r_p1"]
    site = {(r[0], r[2]): (int(r[3]) - 1, int(r[11].split(b":")[-1])) for r in sam_body(sam)}
    missed = [(i, row, d, nm) for i, row, d, nm in a8c["msa_planted"]
              if site.get((names[row], b"m%d" % i)) != (d, nm)]
    print(f"msa device=cuda: {MSA_READS} reads x {len(names)} primer rows in {dt:.2f} s = "
          f"{MSA_READS / dt:.0f} reads/s on {card}; {n_out} alignments; plantings found at "
          f"their offset and NM: {len(a8c['msa_planted']) - len(missed)} of "
          f"{len(a8c['msa_planted'])}")
    if missed or n_out != MSA_READS * len(names):
        raise AssertionError(f"msa: {n_out} alignments, missed {missed[:5]}")
    phase_s["msa"] = time.perf_counter() - t0

    # ---- indelfree: the panel against the genome, query rows in tiles ----
    t0 = time.perf_counter()
    from bbtools_torch.models import indelfree

    ifa = a8c["ifa"]
    sam = w("ifa.cuda.sam")
    chunks = -(-(ECOLI_LEN - 1) // indelfree.CHUNK)
    import torch

    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _, dt, _ = run_routed("indelfree", "indelfree",
                          [f"in={ifa['queries']}", f"ref={ifa['ref']}", f"out={sam}",
                           *IFA_FLAGS], {"indelfree_search": chunks})
    peak = torch.cuda.max_memory_allocated() - base
    hits = {(r[0], int(r[1]) // 16, int(r[3]), int(r[11].split(b":")[-1]))
            for r in sam_body(sam)}
    found = sum(p in hits for p in ifa["planted"])
    print(f"indelfree {' '.join(IFA_FLAGS)} device=cuda: {IFA_QUERIES} queries ("
          f"{2 * IFA_QUERIES} rows) against {ECOLI_LEN} bp ({chunks} chunks) in {dt:.2f} s = "
          f"{ECOLI_LEN / dt / 1e6:.2f} Mbp/s on {card}; {len(hits)} hits, plantings found "
          f"{found} of {len(ifa['planted'])}; peak memory of the search "
          f"{peak / 2**20:.0f} MiB (SEARCH_BUDGET {indelfree.SEARCH_BUDGET / 2**20:.0f} MiB)")
    if found != len(ifa["planted"]) or peak > indelfree.SEARCH_BUDGET:
        raise AssertionError(f"indelfree: found {found}, peak {peak} bytes")
    phase_s["indelfree"] = time.perf_counter() - t0

    # ---- kmercoverage, bloomfilter, polyfilter: the sketch on the card ----
    t0 = time.perf_counter()
    hist = w("kc.cuda.hist.txt")
    n, dt, _ = run_routed("kmercoverage", "kmercoverage",
                          [f"in={a8c['kc_in']}", f"out={w('kc.cuda.fq')}", f"hist={hist}",
                           "k=31"], {"cms_add": None, "cms_query": None})
    with open(hist) as fh:
        counts = [int(ln.split("\t")[1]) for ln in fh.read().splitlines()[1:]]
    mode = int(np.argmax(counts))
    print(f"kmercoverage k=31 device=cuda: {n} reads in {dt:.2f} s = {n / dt:.0f} reads/s on "
          f"{card}; depth histogram's mode {mode} (the JAX package's {KC_MODE})")
    if n != ASM_READS or mode != KC_MODE:
        raise AssertionError(f"kmercoverage: {n} reads, mode {mode}")
    bloom_in = a8c["bloom_in"]
    (kept, total), dt, _ = run_routed(
        "bloomfilter", "bloomfilter",
        [f"in={bloom_in}", f"ref={a8c['ref_fa']}", f"out={w('bf.cuda.fq')}",
         f"outm={w('bf.cuda.m.fq')}", "k=31"], {"cms_add": 1, "cms_query": None})
    matched = fastq_lengths(w("bf.cuda.m.fq"))
    real = sum(not k.startswith(b"junk") for k in matched)
    print(f"bloomfilter k=31 device=cuda: {total} reads in {dt:.2f} s = {total / dt:.0f} "
          f"reads/s (incl. the sketch of {ECOLI_LEN} bp) on {card}; matched {total - kept}: "
          f"{real} of {BLOOM_READS} genome reads, {len(matched) - real} of {BLOOM_FOREIGN} "
          f"foreign (the JAX package's matched count {BLOOM_MATCHED})")
    if real != BLOOM_READS or total - kept != BLOOM_MATCHED:
        raise AssertionError(f"bloomfilter: matched {total - kept}, genome reads {real}")
    (kept, removed), dt, _ = run_routed(
        "polyfilter", "polyfilter",
        [f"in={a8c['poly']}", f"out={w('pf.cuda.fq')}", f"outb={w('pf.cuda.b.fq')}",
         f"extra={a8c['poly']}"], {"cms_add": None, "cms_query": None})
    print(f"polyfilter extra=<its input> device=cuda: {n_fq} reads in {dt:.2f} s = "
          f"{n_fq / dt:.0f} reads/s on {card}; removed {removed} ({a8c['poly_tails']} given "
          f"a poly-G tail; the JAX package's count {POLY_REMOVED})")
    if kept + removed != n_fq or removed != POLY_REMOVED:
        raise AssertionError(f"polyfilter: kept {kept}, removed {removed}")
    phase_s["kmercoverage, bloomfilter, polyfilter"] = time.perf_counter() - t0

    # ---- seqtovec -> train -> netfilter, scoresequence; calibrate ----
    t0 = time.perf_counter()
    tsv = ml_vectors(a8c["ml"], work, None, "ml_train")
    vec_s = time.perf_counter() - t0
    net = a8c["net"]
    _, dt, log = run_routed("train", "train", [f"data={tsv}", f"out={net}"],
                            {"net_fit": 1, "net_forward": None})
    print(f"seqtovec: {ML_READS} reads in {vec_s:.2f} s (host); train device=cuda: "
          f"{ML_READS} vectors x 2,000 epochs in {dt:.2f} s = {2000 / dt:.0f} epochs/s on "
          f"{card}; {log.strip()}")
    if "acc=1.0000" not in log:
        raise AssertionError(f"train: {log}")
    nn_in, n_nn = a8c["nn_in"], min(NN_FILTER_READS, n_fq)
    (_, dt, log) = run_routed("netfilter", "netfilter",
                              [f"in={nn_in}", f"net={net}", f"out={w('nf.cuda.fq')}",
                               f"outu={w('nf.cuda.u.fq')}"], {"net_forward": None})
    print(f"netfilter device=cuda: {n_nn} reads in {dt:.2f} s = {n_nn / dt:.0f} reads/s on "
          f"{card}; {log.strip()}")
    (_, dt, log) = run_routed("scoresequence", "scoresequence",
                              [f"in={nn_in}", f"net={net}", f"out={w('ss.cuda.fq')}",
                               f"hist={w('ss.cuda.hist.txt')}"], {"net_forward": None})
    print(f"scoresequence device=cuda: {n_nn} reads in {dt:.2f} s = {n_nn / dt:.0f} reads/s "
          f"on {card}; {log.strip()}")
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        _, dt, _ = run_routed("calibrate", "calibrate", [f"in={a8c['cal']}", "epochs=2000"],
                              {"calibrate_fit": 1})
    print(f"calibrate epochs=2000 device=cuda: {CAL_ROWS} rows x 2,000 epochs in {dt:.2f} s "
          f"on {card}; {text.getvalue().strip()}")
    phase_s["cellnet family, calibrate"] = time.perf_counter() - t0


def a8c_check_runs(a8c: dict, work: str) -> dict:
    """The CLI runs of the CUDA-against-CPU checks of the last
    device-using tools: name -> (argv on device d, d's output files): msa
    on MSA_CHECK_READS reads, indelfree on the first IFA_CHECK_QUERIES
    queries against the genome's first IFA_CHECK_BP bp, kmercoverage,
    polyfilter, netfilter and scoresequence (the phase's net) on
    A8A_CHECK_READS reads, bloomfilter on BLOOM_CHECK_READS, train on
    ML_CHECK_ROWS rows a class, calibrate on the phase's rows. The
    checks of train, scoresequence, netfilter and calibrate are held to
    their tolerances (`a8c_checks`), the others byte for byte."""
    def w(name):
        return os.path.join(work, name)

    ifa, net = a8c["ifa"], a8c["net"]
    return {
        "train": lambda d: Check(["train", f"data={a8c['ml_check']}",
                                  f"out={w(f'mlchk.{d}.bbnet')}"], [w(f"mlchk.{d}.bbnet")]),
        "calibrate": lambda d: Check(["calibrate", f"in={a8c['cal']}", "epochs=2000",
                                      f"out={w(f'calchk.{d}.txt')}"], [w(f"calchk.{d}.txt")]),
        "indelfree": lambda d: Check(["indelfree", f"in={ifa['check_q']}",
                                      f"ref={ifa['check_ref']}", f"out={w(f'ifachk.{d}.sam')}",
                                      *IFA_FLAGS], [w(f"ifachk.{d}.sam")]),
        "msa": lambda d: Check(["msa", f"in={a8c['msa_check']}", f"ref={a8c['primers']}",
                                f"out={w(f'msachk.{d}.sam')}"], [w(f"msachk.{d}.sam")]),
        "polyfilter": lambda d: Check(["polyfilter", f"in={a8c['poly_check']}",
                                       f"extra={a8c['poly_check']}",
                                       f"out={w(f'pfchk.{d}.fq')}", f"outb={w(f'pfchk.{d}.b.fq')}"],
                                      [w(f"pfchk.{d}.fq"), w(f"pfchk.{d}.b.fq")]),
        "kmercoverage": lambda d: Check(["kmercoverage", f"in={a8c['kc_check']}", "k=31",
                                         f"out={w(f'kcchk.{d}.fq')}",
                                         f"hist={w(f'kcchk.{d}.h.txt')}"],
                                        [w(f"kcchk.{d}.fq"), w(f"kcchk.{d}.h.txt")]),
        "bloomfilter": lambda d: Check(["bloomfilter", f"in={a8c['bloom_check']}",
                                        f"ref={a8c['ref_fa']}", "k=31",
                                        f"out={w(f'bfchk.{d}.fq')}",
                                        f"outm={w(f'bfchk.{d}.m.fq')}"],
                                       [w(f"bfchk.{d}.fq"), w(f"bfchk.{d}.m.fq")]),
        "netfilter": lambda d: Check(["netfilter", f"in={a8c['nn_check']}", f"net={net}",
                                      f"out={w(f'nfchk.{d}.fq')}", f"outu={w(f'nfchk.{d}.u.fq')}"],
                                     [w(f"nfchk.{d}.fq"), w(f"nfchk.{d}.u.fq")]),
        "scoresequence": lambda d: Check(["scoresequence", f"in={a8c['nn_check']}",
                                          f"net={net}", f"out={w(f'sschk.{d}.fq')}"],
                                         [w(f"sschk.{d}.fq")]),
    }


#: the a8c checks held to a tolerance, not byte for byte
A8C_TOLERANT = ("train", "calibrate", "netfilter", "scoresequence")
#: the a8c checks that use the net the phase trains
A8C_NEED_NET = ("netfilter", "scoresequence")


def a8c_checks(a8c: dict, runs: dict, cpu_side: CpuSide, here: dict, phase_s: dict):
    """The a8c checks: the byte-for-byte ones as file_checks does; the
    nets of train within FIT_WEIGHT_TOL; calibrate's constants within
    CAL_TOL and its mse within CAL_MSE_TOL; netfilter's files equal but
    for reads the card scores within NN_NEAR of the cutoff;
    scoresequence's reads equal but for their scores, within
    SCORE_TOL."""
    from bbtools_torch.ml.cellnet import parse_bbnet
    from bbtools_torch.utils.fqdiff import differing_names

    file_checks("a8c", {k: v for k, v in runs.items() if k not in A8C_TOLERANT}, cpu_side,
                phase_s, here=here)
    t0 = time.perf_counter()
    for name in A8C_TOLERANT:
        cpu_s = cpu_side.wait(name)
        files = {d: runs[name](d).outs for d in ("cuda", "cpu")}
        if name == "train":
            nets = {d: parse_bbnet(files[d][0]) for d in files}
            pairs = list(zip(nets["cuda"].weights + nets["cuda"].biases,
                             nets["cpu"].weights + nets["cpu"].biases))
            if not all(np.isfinite(a).all() and np.isfinite(b).all() for a, b in pairs):
                raise AssertionError("train: a net holds a weight that is not finite")
            diff = max(float(np.abs(a - b).max()) for a, b in pairs)
            print(f"train: cuda against cpu on {2 * ML_CHECK_ROWS} vectors x 2,000 epochs, the "
                  f"largest weight difference {diff:.2e} (tolerance {FIT_WEIGHT_TOL})")
            if nets["cuda"].dims != nets["cpu"].dims or diff > FIT_WEIGHT_TOL:
                raise AssertionError(f"train: the nets differ by {diff}")
        elif name == "calibrate":
            vals = {}
            for d in files:
                with open(files[d][0]) as fh:
                    vals[d] = {k: float(v) for k, v in (kv.split("=") for kv in fh.read().split())}
            diff = max(abs(vals["cuda"][k] - vals["cpu"][k]) for k in ("a", "b", "K", "c"))
            dmse = abs(vals["cuda"]["mse"] - vals["cpu"]["mse"])
            print(f"calibrate: cuda {vals['cuda']} against cpu {vals['cpu']}: constants within "
                  f"{diff:.1e} (tolerance {CAL_TOL}), mse within {dmse:.1e}")
            if diff > CAL_TOL or dmse > CAL_MSE_TOL:
                raise AssertionError(f"calibrate: {vals}")
        elif name == "netfilter":
            near = nn_near_reads(a8c["nn_check"], a8c["net"])
            got = {d: read_all(files[d]) for d in files}
            differ = set()
            for a, b in zip(got["cuda"], got["cpu"]):
                differ |= differing_names(a, b)
            print(f"netfilter: cuda against cpu on {A8A_CHECK_READS} reads: {len(differ)} reads "
                  f"differ, {len(near)} score within {NN_NEAR} of the cutoff on the card")
            if not differ <= near:
                raise AssertionError(f"netfilter: {sorted(differ - near)[:5]} differ")
        else:
            recs = {d: read_all(files[d])[0].split(b"\n") for d in files}
            heads = {d: [ln.rsplit(b"\tscore=", 1) for ln in recs[d][0::4]] for d in recs}
            same = all(recs["cuda"][i] == recs["cpu"][i] for i in range(len(recs["cuda"]))
                       if i % 4) and len(recs["cuda"]) == len(recs["cpu"])
            diff = max((abs(float(a[1]) - float(b[1])) for a, b in
                        zip(heads["cuda"], heads["cpu"]) if len(a) == 2), default=0.0)
            flips = sum(a != b for a, b in zip(heads["cuda"], heads["cpu"]))
            print(f"scoresequence: cuda against cpu on {A8A_CHECK_READS} reads: {flips} scores "
                  f"differ, by at most {diff:.4f} (tolerance {SCORE_TOL})")
            names_differ = any(a[0] != b[0] for a, b in zip(heads["cuda"], heads["cpu"]))
            if not same or names_differ or diff > SCORE_TOL + 1e-9:
                raise AssertionError("scoresequence: cuda and cpu records differ")
        print(f"  ({name}: cuda {here[name]:.2f} s in this process, cpu {cpu_s:.2f} s in a "
              f"process of its own)")
    phase_s["cuda against cpu, a8c tolerances"] = time.perf_counter() - t0


def nn_near_reads(fq: str, net_path: str) -> set:
    """Names of the reads of `fq` whose score (the better strand) with
    the net at `net_path` lies within NN_NEAR of its cutoff, on the card."""
    from bbtools_torch.io.fastq import FastqReader
    from bbtools_torch.ml.cellnet import parse_bbnet
    from bbtools_torch.models.mltools import score_batch

    net = parse_bbnet(net_path)
    near = set()
    for b in FastqReader(fq):
        s = score_batch(net, b.bases, b.lengths, (net.dims[0] - 4) // 4, 0)
        near |= {b.ids[i].split()[0] for i in np.nonzero(np.abs(s - 0.5) < NN_NEAR)[0]}
    return near


def side_of(name: str) -> CpuSide:
    """The CpuSide that holds run `name`."""
    return next(side for side in CpuSide.started if name in side.names)


def early_runs(ctx: dict, pipe: dict, work: str, device: str) -> list:
    """One half of the earlier tools' CUDA-against-CPU checks, as CpuSide
    runs on `device` (a CUDA half's name ends in " cuda"): bbduk's three,
    bbmerge's, bbmap's single end and paired, kmercountexact's two,
    Tadpole's two (its contig run on the card is the main phase's),
    tadpipe's, bbmerge ecco, nn=t (its pairs near the cutoff reported)
    and its merge stage, bbcms's two (their input made here) and
    bloomfilter=t's (its prescreened count reported)."""
    runs = [(f"bbduk {name}", bbduk_argv(name, flags, fin, work, device)[0])
            for name, flags, fin in ctx["bbduk_checks"]]
    runs.append(("bbmerge", bbmerge_argv(ctx["small_pairs"], work, "head", device)[0]))
    for name, ins in ctx["bbmap_checks"]:
        runs.append((f"bbmap {name}", bbmap_check_argv(ctx, ins, name, work, device)[0]))
    for k in (31, 93):
        runs.append((f"kmercountexact k={k}", kce_check_argv(ctx["asm"], k, work, device)[0]))
    for tag in ("contig k=62", "correct k=31")[device == "cuda":]:
        runs.append((f"tadpole {tag}", tadpole_check_argv(ctx["asm"], tag, work, device)[0]))
    runs.append(("tadpipe", tadpipe_check_argv(pipe, work, device)[0]))
    for tag, ins, flags, _n in a6b_merge_checks(pipe):
        runs.append((f"bbmerge {tag}", bbmerge_argv(ins, work, f"mcheck_{tag}", device,
                                                    flags)[0]))
    pipe["cms_check"] = os.path.join(work, "cms_check.fq.gz")
    if not os.path.exists(pipe["cms_check"]):
        head_fastq(pipe["region.fq.gz"], pipe["cms_check"], CMS_CHECK_READS)
    for flags in CMS_CHECKS:
        runs.append((f"bbcms {' '.join(flags)}", bbcms_check_argv(pipe, flags, work, device)[0]))
    runs.append(("bbmap bloomfilter=t", bloom_check_argv(pipe, work, device)[0]))
    suffix = " cuda" if device == "cuda" else ""
    return [(name + suffix, argv, None) for name, argv in runs]


#: the CUDA halves the late processes start first: the longest
LATE_FIRST = ("tadpipe cuda", "rqcfilter2 cuda", "bbmerge merge cuda", "mappacbio cuda",
              "bbmapskimmer cuda", "dedupe cuda", "seal cuda")


def kce_check_argv(asm: dict, k: int, work: str, device: str):
    """kmercountexact's argv of a check on `device` and its outputs."""
    outs = [os.path.join(work, f"head{k}.{device}.{x}") for x in ("khist", "peaks", "dump")]
    return (["kmercountexact", f"in={asm['head.fq.gz']}", f"k={k}",
             *(f"{x}={o}" for x, o in zip(("khist", "peaks", "dump"), outs)),
             f"device={device}"], outs)


def tadpole_check_argv(asm: dict, tag: str, work: str, device: str):
    """Tadpole's argv of a check (contig k=62 on the region's reads, or
    correct k=31) on `device` and its output."""
    fin, flags = ((asm["region.fq.gz"], ["k=62"]) if tag.startswith("contig") else
                  (asm["ecc.fq.gz"], ["k=31", "mode=correct"]))
    out = os.path.join(work, f"tad.{tag[:6]}.{device}.out")
    return ["tadpole", f"in={fin}", *flags, f"out={out}", f"device={device}"], [out]


def bbmap_check_argv(ctx: dict, ins: list[str], name: str, work: str, device: str):
    """bbmap's argv of a check on `device` and its SAM."""
    out = os.path.join(work, f"map_head_{name[0]}.{device}.sam")
    return ["bbmap", f"ref={ctx['ref_fa']}", *ins, f"out={out}", f"device={device}"], [out]


def tadpipe_check_argv(pipe: dict, work: str, device: str):
    """tadpipe's argv of its check on `device` and its temp directory
    (the stage files; the assembly is the directory's name + .fa)."""
    tmp = os.path.join(work, f"pipe_check.{device}")
    return ["tadpipe", f"in={pipe['check'][0]}", f"in2={pipe['check'][1]}", f"out={tmp}.fa",
            f"tmpdir={tmp}", "k=31,62", "deletetemp=f", f"device={device}"], tmp


def a6b_merge_checks(pipe: dict) -> tuple:
    return (("ecco", pipe["merge_check"], PIPE_ECCO, MERGE_CHECK_PAIRS),
            ("nn", pipe["merge_check"], ["nn=t"], MERGE_CHECK_PAIRS),
            ("merge", pipe["ecct_check"], PIPE_MERGE, MERGE_ECCT_CHECK_PAIRS))


CMS_CHECKS = (["k=25"], ["ecc=f", "mincount=2"])


def bloom_check_argv(pipe: dict, work: str, device: str):
    """bbmap bloomfilter=t's argv of its check (the region as reference)
    on `device` and its SAM."""
    sam = os.path.join(work, f"bloom_check.{device}.sam")
    return (["bbmap", f"ref={pipe['region.fa']}", f"in={pipe['bloom_check']}", f"out={sam}",
             "bloomfilter=t", f"device={device}"], [sam])


def bbcms_check_argv(pipe: dict, flags: list[str], work: str, device: str):
    tag = "_".join(f.replace("=", "") for f in flags)
    outs = [os.path.join(work, f"cms_check.{tag}.{device}.{x}.fq") for x in ("out", "bad")]
    return (["bbcms", f"in={pipe['cms_check']}", f"out={outs[0]}", f"outb={outs[1]}", *flags,
             f"device={device}"], outs)


def pool_runs(runs: dict, skip=()) -> list:
    """Both halves of the file checks `runs` (a2_check_runs,
    a8a_check_runs) as CpuSide runs: `name` on device=cpu and `name
    cuda` on device=cuda, but for the CUDA halves named in `skip`, which
    their phase ran."""
    return ([(name, [*fn("cpu").argv, "device=cpu"], fn("cpu").stdout)
             for name, fn in runs.items()],
            [(f"{name} cuda", [*fn("cuda").argv, "device=cuda"], fn("cuda").stdout)
             for name, fn in runs.items() if name not in skip])


def file_checks(label: str, runs: dict, cpu_side: CpuSide, phase_s: dict,
                here: dict | None = None):
    """The outputs of both halves of `runs`, each run in a process of
    cpu_side's, byte for byte (a CUDA half that was not run there ran in
    its phase, or in this process: `here`, name -> seconds)."""
    t0 = time.perf_counter()
    for name, fn in runs.items():
        cpu_s = cpu_side.wait(name)
        started = any(f"{name} cuda" in side.names for side in CpuSide.started)
        cuda_s = cpu_side.wait(f"{name} cuda") if started else None
        files = {d: read_all(fn(d).outs) for d in ("cuda", "cpu")}
        if files["cuda"] != files["cpu"]:
            raise AssertionError(f"{name}: cuda and cpu outputs differ")
        where = (f"cuda {cuda_s:.2f} s in a process of its own, " if cuda_s is not None else
                 f"cuda {here[name]:.2f} s in this process, " if name in (here or {}) else
                 "cuda in its phase, ")
        print(f"{name}: cuda == cpu ({sum(len(f) for f in files['cuda'])} bytes in "
              f"{len(files['cuda'])} files; {where}cpu {cpu_s:.2f} s in a process of its own)")
    waited = time.perf_counter() - t0
    print(f"{label} checks: waited {waited:.1f} s for the processes")
    phase_s[f"cuda == cpu, {label}"] = waited


def cuda_halves_here(runs: dict) -> dict:
    """The CUDA halves of the checks `runs` in this process, one after
    another: name -> seconds."""
    secs = {}
    for name, fn in runs.items():
        check = fn("cuda")
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(io.StringIO()):
            cli_call([*check.argv, "device=cuda"], check.stdout)
        secs[name] = time.perf_counter() - t0
    return secs


#: A7 (multi-device): the sharded paths on a virtual mesh of the card
#: (cuda:0 repeated; NCCL refuses two ranks on one card, gloo does not),
#: each held to the single-device run on the same input: BBDuk config #1's
#: flags over (dp=2, tp=2) on the first A7_DUK_READS reads; BBMap defaults
#: over dp=4 on one 4,096-read batch; the insert scan over 4 slabs of one
#: BBMerge batch; the spectrum over 4 shards of config #2's first
#: A7_KMER_READS reads at k=31; the matcher over (2, 2) on the full-k keys
#: of its first batch; and two processes joined by a gloo group,
#: kmercountexact and the one-adapter BBDuk each on one half of
#: A7_JOIN_READS reads, their global answers those of one process on the
#: whole
A7_DUK_READS = 50_000
A7_KMER_READS = 50_000
A7_JOIN_READS = 20_000
A7_JOIN_TIMEOUT = 300

#: one process of the two-process check: argv[1:] are the BBDuk flags
A7_JOIN_WORKER = r"""
import os, sys
from bbtools_torch.cli import main

r, w = int(os.environ["RANK"]), os.environ["A7_WORK"]
main(["kmercountexact", f"in={w}/a7_join{r}.fq.gz", "k=31", f"khist={w}/a7_join{r}.khist.txt",
      f"dump={w}/a7_join{r}.dump.fa", "device=cuda"])
main(["bbduk", f"in={w}/a7_join{r}.fq.gz", f"out={w}/a7_join{r}.duk.fq",
      f"stats={w}/a7_join{r}.duk.stats", *sys.argv[1:], "device=cuda"])
"""


def virtual_mesh(n_dp: int, n_tp: int):
    """A (dp, tp) mesh of the card repeated: the slabs run one after
    another on cuda:0, through the kernels a mesh of n_dp * n_tp cards
    runs on each."""
    import torch

    from bbtools_torch.parallel.mesh import make_mesh

    return make_mesh(n_dp, n_tp, devices=[torch.device("cuda", 0)] * (n_dp * n_tp))


def split_fastq(src: str, dsts: list[str]):
    """The records of a gzipped FASTQ in len(dsts) consecutive parts of
    equal size (the last takes the rest)."""
    with gzip.open(src, "rb") as fi:
        lines = fi.readlines()
    n = len(lines) // 4
    per = n // len(dsts)
    for i, dst in enumerate(dsts):
        stop = n if i == len(dsts) - 1 else (i + 1) * per
        with gzip.open(dst, "wb", compresslevel=1) as fo:
            fo.writelines(lines[4 * i * per : 4 * stop])


def a7_phase(fq: str, map_batch: str, ref_fa: str, pairs: list[str], kmer_src: str,
             kern_fq: str, work: str, card: str, phase_s: dict, launches: dict) -> dict:
    """The A7 checks (see A7_DUK_READS), each one's seconds and the
    per-slab launches of B3, B4 and B5 printed; returns the kernels line's
    row of `mm_best`, B3's undecoded epilogue, held against its plain
    twin at the matcher's column slab and timed beside mm_lookup there."""
    import torch

    from bbtools_torch.io.fastq import FastqReader, paired_reader
    from bbtools_torch.models import bbduk, bbmap
    from bbtools_torch.models.bbmerge import _rc_batch
    from bbtools_torch.ops.bbduk_scan import KScanConfig, canonical_keys
    from bbtools_torch.ops.kmer_count import DeviceSpectrum
    from bbtools_torch.ops.kmers import rolling_kmers
    from bbtools_torch.ops.mm_match import MMKmerIndex, mm_best, mm_best_plain, mm_lookup
    from bbtools_torch.ops.overlap_scan import overlap_counts
    from bbtools_torch.parallel.sharded_count import sharded_mm_lookup_step, sharded_overlap_step
    from bbtools_torch.parallel.sharded_spectrum import ShardedSpectrum

    t_phase = time.perf_counter()
    secs: dict[str, float] = {}
    dev = torch.device("cuda", 0)

    def w(name):
        return os.path.join(work, f"a7_{name}")

    # ---- 6, started first: two processes on the card, joined by gloo;
    # they start and reach the card (~8 s each) while checks 1-5 run ----
    t_join = time.perf_counter()
    join_in = w("join.fq.gz")
    head_fastq(fq, join_in, A7_JOIN_READS)
    split_fastq(join_in, [w("join0.fq.gz"), w("join1.fq.gz")])
    duk_flags = CONFIGS["1adapter"]
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    # each process's output to a file, so that no pipe fills while this
    # process runs checks 1-5
    logs = [open(w(f"join{r}.log"), "wb") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", A7_JOIN_WORKER, *duk_flags],
        env=dict(os.environ, PYTHONPATH=HERE, MASTER_ADDR="127.0.0.1",
                 MASTER_PORT=str(port), WORLD_SIZE="2", RANK=str(r), A7_WORK=work),
        stdout=logs[r], stderr=subprocess.STDOUT) for r in range(2)]
    try:
        # ---- 1. BBDuk config #1 over (dp=2, tp=2): the bucket gather on
        # each shard against the sorted join (B2) on one device ----
        t0 = time.perf_counter()
        duk_in = w("duk.fq.gz")
        head_fastq(fq, duk_in, A7_DUK_READS)
        flags = CONFIGS["adapters_fa"]
        run_tool("bbduk", [f"in={duk_in}", f"out={w('duk.one.fq')}",
                           f"stats={w('duk.one.stats')}", *flags], "cuda")

        def sharded_bbduk():
            tool = bbduk.BBDuk(bbduk.parse_args([f"in={duk_in}", f"out={w('duk.mesh.fq')}",
                                                 f"stats={w('duk.mesh.stats')}", *flags,
                                                 "device=cuda"]))
            tool.enable_mesh(mesh=virtual_mesh(2, 2))
            with contextlib.redirect_stderr(io.StringIO()):
                tool.run()
            return tool

        run_path("bbduk over (2, 2)", sharded_bbduk, (), {})
        if (read_all([w("duk.mesh.fq"), w("duk.mesh.stats")])
                != read_all([w("duk.one.fq"), w("duk.one.stats")])):
            raise AssertionError("A7 bbduk: the (2, 2) mesh's FASTQ or stats differ")
        secs["bbduk"] = time.perf_counter() - t0
        print(f"A7 bbduk config #1 over (dp=2, tp=2): {A7_DUK_READS} reads, FASTQ and stats "
              f"byte-equal to one device; {secs['bbduk']:.1f} s")

        # ---- 2. BBMap defaults over dp=4 (B4 per slab) ----
        t0 = time.perf_counter()
        base = [f"ref={ref_fa}", f"in={map_batch}"]
        one = bbmap.BBMap(bbmap.parse_args([*base, f"out={w('map.one.sam')}", "device=cuda"]))
        with contextlib.redirect_stderr(io.StringIO()):
            one.run()

        def sharded_bbmap():
            tool = bbmap.BBMap(bbmap.parse_args([*base, f"out={w('map.mesh.sam')}",
                                                 "device=cuda"]), index=one.index)
            tool.enable_mesh(mesh=virtual_mesh(4, 1))
            with contextlib.redirect_stderr(io.StringIO()):
                tool.run()
            return tool

        _, got = run_path("bbmap over dp=4", sharded_bbmap, (), {})
        b4 = b4_total(got)
        if b4 <= 0:
            raise AssertionError("A7 bbmap: B4 never launched on the sharded path")
        if sam_body(w("map.mesh.sam")) != sam_body(w("map.one.sam")):
            raise AssertionError("A7 bbmap: the dp=4 mesh's SAM differs")
        secs["bbmap"] = time.perf_counter() - t0
        print(f"A7 bbmap over dp=4: {MAP_BATCH_READS} reads, SAM equal to one device; B4 "
              f"launches {b4_routes(got)} over the 4 "
              f"slabs' window classes; {secs['bbmap']:.1f} s")

        # ---- 3. the insert scan over 4 slabs of one BBMerge batch (B5) ----
        t0 = time.perf_counter()
        b1m, b2m = list(paired_reader(*pairs, batch_reads=MERGE_BATCH))[0]
        a = torch.from_numpy(b1m.bases).to(dev)
        b_rc = torch.from_numpy(_rc_batch(b2m)).to(dev)
        al = torch.from_numpy(b1m.lengths.astype(np.int32)).to(dev)
        bl = torch.from_numpy(b2m.lengths.astype(np.int32)).to(dev)
        min0 = 12
        D = int((b1m.lengths.astype(np.int64) + b2m.lengths).max() - min0 + 1)
        want = overlap_counts(a, b_rc, al, bl, min0, D)
        step = sharded_overlap_step(virtual_mesh(4, 1), min0, D)
        outs, got = run_path("insert scan over 4 slabs", lambda: step(a, b_rc, al, bl),
                             ("overlap_scan",), {})
        if not all(torch.equal(g, x) for g, x in zip(outs, want)):
            raise AssertionError("A7 insert scan: the 4 slabs differ from overlap_counts")
        secs["insert scan"] = time.perf_counter() - t0
        print(f"A7 sharded_overlap_step, 4 slabs of one {a.shape[0]}-pair batch: equal to "
              f"overlap_counts; B5 launches {got['overlap_scan']}; {secs['insert scan']:.1f} s")

        # ---- 4. the spectrum over 4 shards at k=31 ----
        t0 = time.perf_counter()
        kmer_in = w("kmer.fq.gz")
        head_fastq(kmer_src, kmer_in, A7_KMER_READS)
        batches = list(FastqReader(kmer_in, batch_reads=BATCH))
        single = DeviceSpectrum(31, device=dev)
        for b in batches:
            single.add_batch(b.bases, b.lengths)

        def sharded_spectrum():
            ss = ShardedSpectrum(virtual_mesh(4, 1), 31)
            for b in batches:
                ss.add_batch(b.bases, b.lengths)
            ss.flush()
            return ss

        ss = routed("spectrum over 4 shards", sharded_spectrum, {"merge_spectra": None})
        if not all(np.array_equal(g, x) for g, x in zip(ss.spectrum(), single.spectrum())):
            raise AssertionError("A7 spectrum: the 4 shards' spectrum differs")
        if not np.array_equal(ss.histogram(100_000), single.histogram(100_000)):
            raise AssertionError("A7 spectrum: the 4 shards' khist differs")
        secs["spectrum"] = time.perf_counter() - t0
        print(f"A7 ShardedSpectrum over 4 shards, {A7_KMER_READS} reads of config #2 at k=31: "
              f"{ss.n_unique} unique k-mers, spectrum and khist equal to DeviceSpectrum's; "
              f"{secs['spectrum']:.1f} s")

        # ---- 5. the matcher over (2, 2) on its first batch's full-k keys (B3's
        # mm_best per (row, column) slab) ----
        t0 = time.perf_counter()
        mcfg = bbduk.parse_args(MM_CONFIG)
        scaffolds, _ = bbduk.load_reference(mcfg)
        mm = MMKmerIndex.build(scaffolds, mcfg.k, mink=mcfg.mink if mcfg.use_short_kmers else 0,
                               hdist=mcfg.hdist, hdist2=mcfg.hdist2,
                               mid_mask=mcfg.mid_mask_bits, rcomp=mcfg.rcomp)
        table = mm.device_arrays(dev)
        batch = list(FastqReader(kern_fq, batch_reads=BATCH))[0]
        fwd, rkm, _ = rolling_kmers(torch.from_numpy(batch.bases).to(dev), mcfg.k)
        q = canonical_keys(KScanConfig(k=mcfg.k, mid_mask=mcfg.mid_mask_bits
                                       if mcfg.mask_middle else -1), fwd, rkm, mcfg.k)
        want = mm_lookup(*table, *mm.static_params(), q)
        step = sharded_mm_lookup_step(virtual_mesh(2, 2), mm.k, mm.mink, mm.Kp)
        ids, got = run_path("matcher over (2, 2)", lambda: step(*table, q), ("mm_best",), launches)
        if not torch.equal(ids, want):
            raise AssertionError("A7 matcher: the (2, 2) mesh differs from mm_lookup")
        half = mm.Dp // 2
        kw, pr = table[0][:half].contiguous(), table[1][:, :half].contiguous()
        qs = q[: q.shape[0] // 2].contiguous()
        args = (kw, pr, mm.k, mm.mink, mm.Kp, half, qs)
        best = compare(f"B3 mm_best at the (2, 2) slab: {qs.numel()} keys x {half} of {mm.Dp} "
                    f"columns", lambda: mm_best(*args), lambda: mm_best_plain(*args), reps=5,
                    plain_reps=2)
        best.update(bound(nbytes(qs, kw, pr) + 4 * qs.numel(), 2 * qs.numel() * half * mm.Kp,
                       INT8_TC_OPS_S))
        ms = {"mm_best": [], "mm_lookup": []}
        for order in (("mm_best", "mm_lookup"), ("mm_lookup", "mm_best")):
            for name in order:
                fn = mm_best if name == "mm_best" else mm_lookup
                ms[name].append(cuda_ms(lambda: fn(*args), 5))
        best["turns_ms"] = {k: sum(v) / len(v) for k, v in ms.items()}
        secs["matcher"] = time.perf_counter() - t0
        print(f"A7 sharded_mm_lookup_step over (dp=2, tp=2): {q.numel()} keys, equal to "
              f"mm_lookup; B3 mm_best launches {got['mm_best']} (one a slab); at the slab "
              f"in turns: mm_best {best['turns_ms']['mm_best']:.4f} ms, mm_lookup "
              f"{best['turns_ms']['mm_lookup']:.4f} ms, bound {best['bound_ms']:.4f} ms; "
              f"{secs['matcher']:.1f} s")

        # ---- 6. the two processes against one process on the whole ----
        run_tool("kmercountexact", [f"in={join_in}", "k=31", f"khist={w('join.khist.txt')}",
                                    f"dump={w('join.dump.fa')}"], "cuda")
        run_tool("bbduk", [f"in={join_in}", f"out={w('join.duk.fq')}",
                           f"stats={w('join.duk.stats')}", *duk_flags], "cuda")
        for r, p in enumerate(procs):
            p.wait(timeout=A7_JOIN_TIMEOUT)
            log = read_all([w(f"join{r}.log")])[0]
            if p.returncode:
                raise AssertionError(f"A7 join: process {r} exited {p.returncode}: "
                                     f"{log.decode()[-2000:]}")
            if b"Joined torch.distributed process group" not in log:
                raise AssertionError(f"A7 join: process {r} did not join the group")
    finally:
        for p, log in zip(procs, logs):
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    for r in range(2):
        if (read_all([w(f"join{r}.khist.txt"), w(f"join{r}.dump.fa")])
                != read_all([w("join.khist.txt"), w("join.dump.fa")])):
            raise AssertionError(f"A7 join: process {r}'s khist or dump differs")
    if b"".join(read_all([w("join0.duk.fq"), w("join1.duk.fq")])) != read_all(
            [w("join.duk.fq")])[0]:
        raise AssertionError("A7 join: the BBDuk outputs in rank order differ")

    def stats_body(path):
        return [ln for ln in read_all([path])[0].splitlines() if not ln.startswith(b"#File")]

    if not all(stats_body(w(f"join{r}.duk.stats")) == stats_body(w("join.duk.stats"))
               for r in range(2)):
        raise AssertionError("A7 join: the BBDuk stats differ")
    secs["two processes"] = time.perf_counter() - t_join
    print(f"A7 two processes on the card, joined by gloo: kmercountexact k=31 and bbduk "
          f"1adapter on the halves of {A7_JOIN_READS} reads; khist, dump, the outputs in "
          f"rank order and the stats equal to one process's; {secs['two processes']:.1f} s "
          f"from their start, beside checks 1-5")
    phase_s["a7 sharded paths"] = time.perf_counter() - t_phase
    print("A7 check seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in secs.items())
          + f"; phase {phase_s['a7 sharded paths']:.1f} s on {card}")
    return {
        "name": "mm_best", "route": "cuda",
        "source": "bbtools_torch/csrc/mm_match.cu",
        "replaces": "bbtools_tpu/ops/mm_match.py:386",
        "launches": launches["mm_best"], "max_abs_err": best["max_abs_err"],
        "ms": best["ms"], "plain_ms": best["plain_ms"], "bound_ms": best["bound_ms"],
        "bound_by": best["bound_by"], "library_ms": None, "turns_ms": best["turns_ms"],
        "slab": {"queries": qs.numel(), "columns": half, "Dp": mm.Dp},
    }


#: A8b (the read-QC slice): RQCFilter2 at rqcfilter2.sh's defaults (ktrim
#: against the adapters with tbo tpe on pairs, qtrim/maxns/maq, the
#: artifact + phiX + pJET filter) with clumpify, filterbytile, removeribo,
#: polyfilter, removeref against the second genome, merge and khist, over
#: A8B_PAIRS pairs of 2x150 bp of the E. coli-length genome with Illumina
#: headers that carry tiles (inserts A8B_INSERTS, adapters past short
#: inserts). Planted, each a share of the pairs: phiX, rRNA of the four
#: consensus files, pairs of the second genome, poly-G tails on r1 of
#: A8B_POLYG bases, exact duplicate pairs, and pairs in a corner of tile
#: A8B_BAD_TILE (x, y < 1000) with phred 2-12. Its CUDA-against-CPU check
#: runs on the first A8B_CHECK_PAIRS pairs.
A8B_PAIRS = 10_000
A8B_CHECK_PAIRS = 2_000
A8B_INSERTS = (100, 450)
A8B_SHARES = (("phix", 0.05), ("ribo", 0.03), ("second", 0.05), ("polyg", 0.02),
              ("badtile", 0.02), ("dup", 0.01))
A8B_POLYG = (20, 60)
A8B_BAD_TILE = 1104
A8B_TILES = (1101, 1102, 1103, 1104)
A8B_FLAGS = ["clumpify=t", "filterbytile=t", "removeribo=t", "polyfilter=1", "merge=t",
             "khist=t"]
#: the stage that removes each planted class, and the infix of each
#: stage's output (<stem>.<infix>.R1.fastq.gz with keepintermediates=t)
A8B_STAGE = {"dup": "dedupe", "badtile": "filterbytile", "phix": "filter", "ribo": "ribo",
             "second": "removal_second"}
A8B_STAGE_FILES = (("dedupe", "dd"), ("filterbytile", "fbt"), ("ktrim", "a"),
                   ("qtrim", "anq"), ("filter", "anqpt"), ("polyfilter", "anqptg"),
                   ("ribo", "anqptgr"), ("removal_second", "anqptgrh0"))
#: the polyfilter stage trims r1's poly-G tail where it holds a G k-mer
#: of at least mink=29 bases (literal=G*31 ktrim=r mink=29); shorter
#: tails stay
A8B_POLYG_MINK = 29
#: filterstats.txt of the JAX package's rqcfilter on the phase's input
#: (tools/a8b_dryrun.py, JAX on the CPU)
A8B_FILTERSTATS = (
    "#stage\treads\tbases\treads_pct\tbases_pct\n"
    "input\t20000\t3000000\t100.00\t100.00\n"
    "dedupe\t19800\t2970000\t99.00\t99.00\n"
    "filterbytile\t19400\t2910000\t97.00\t97.00\n"
    "ktrim\t19400\t2839525\t97.00\t94.65\n"
    "qtrim\t19400\t2834179\t97.00\t94.47\n"
    "filter\t18400\t2688804\t92.00\t89.63\n"
    "polyfilter\t18400\t2682491\t92.00\t89.42\n"
    "ribo\t17800\t2594375\t89.00\t86.48\n"
    "removal_second\t16800\t2447651\t84.00\t81.59\n"
)
#: DecontaminateByNormalization (decontaminate.sh, crossblock): DECON_LIBS
#: libraries, each assembled as its own seeded genome of DECON_CONTIGS
#: contigs of DECON_CONTIG_LEN bp plus DECON_PLANTED contaminant contigs
#: taken from the next library's genome; its reads its own genome at
#: DECON_DEPTH x and the next library's at DECON_SHARE x (reads of
#: DECON_READ_LEN bp), tests/test_decontaminate.py's shapes at three
#: libraries
DECON_LIBS = 3
DECON_CONTIGS = 12
DECON_CONTIG_LEN = 1_000
DECON_PLANTED = 2
DECON_DEPTH = 15
DECON_SHARE = 1.5
DECON_READ_LEN = 100
DECON_FLAGS = ["target=5", "mindepth=2"]


def make_a8b_data(work: str, genome_codes, second_fa: str, seed: int) -> dict:
    """The inputs of the read-QC phase: rqcfilter's pairs (two gzipped
    files) and their heads, the planted pairs by class (names, and the
    poly-G tail lengths), and decontaminate's libraries."""
    from bbtools_torch.io.fasta import iter_fasta

    rng = np.random.default_rng(seed)
    ascii_ = np.frombuffer(b"ACGT", np.uint8)
    code = np.zeros(256, np.uint8)
    code[np.frombuffer(b"ACGTacgt", np.uint8)] = [0, 1, 2, 3, 0, 1, 2, 3]
    phix_fa = os.path.join(HERE, "bbtools_tpu", "resources", "phix2.fa.gz")
    sources = {"phix": [code[np.frombuffer(next(iter_fasta(phix_fa)).seq, np.uint8)]],
               "ribo": [code[np.frombuffer(s, np.uint8)] for t in RIBO_TYPES
                        for _, s in consensus_records(t) if len(s) > A8B_INSERTS[1]],
               "second": [code[np.frombuffer(next(iter_fasta(second_fa)).seq, np.uint8)]]}
    main = np.asarray(genome_codes, np.uint8)
    n = A8B_PAIRS
    counts = {c: int(round(s * n)) for c, s in A8B_SHARES}
    n_dup = counts.pop("dup")
    cls = np.array(["main"] * (n - n_dup - sum(counts.values()))
                   + [c for c, m in counts.items() for _ in range(m)], dtype=object)
    cls = cls[rng.permutation(len(cls))]
    slots = rng.choice(len(A8B_TILES) * 3000 * 3000, n + n_dup, replace=False)
    p_err = (10.0 ** (-np.arange(41) / 10.0))
    L = 150
    r1s, r2s, planted, tails, made = [], [], {c: set() for c in A8B_STAGE}, {}, []
    planted["polyg"] = set()
    for i, c in enumerate(cls):
        src = sources.get(c)
        seq = main if src is None else src[int(rng.integers(0, len(src)))]
        ins = int(rng.integers(A8B_INSERTS[0], min(A8B_INSERTS[1], len(seq)) + 1))
        p = int(rng.integers(0, len(seq) - ins + 1))
        frag = seq[p: p + ins]
        if rng.random() < 0.5:
            frag = 3 - frag[::-1]
        mates = []
        for frag_m, ad in ((frag, ADAPTER), (3 - frag[::-1], ADAPTER2)):
            s = np.full(L, ord("A"), np.uint8)
            s[: min(L, ins)] = ascii_[frag_m[:L]]
            if ins < L:
                tail = np.frombuffer(ad, np.uint8)[: L - ins]
                s[ins: ins + len(tail)] = tail
            mates.append(s)
        tile_slot, xy = divmod(int(slots[i]), 3000 * 3000)
        tile, x, y = A8B_TILES[tile_slot], *divmod(xy, 3000)
        if c == "badtile":
            tile, x, y = A8B_BAD_TILE, x % 1000, y % 1000
        elif tile == A8B_BAD_TILE and x < 1000 and y < 1000:
            x += 1000
        if c == "polyg":
            t = int(rng.integers(A8B_POLYG[0], A8B_POLYG[1] + 1))
            mates[0][L - t:] = ord("G")
        recs = []
        for s in mates:
            if c == "badtile":
                q = rng.integers(2, 13, L)
            else:
                q = np.clip(41 - rng.exponential(7, L), 2, 40).astype(np.int64)
            e = rng.random(L) < p_err[q]
            if c == "polyg":
                e[L - t:] = False
            s = s.copy()
            s[e] = ascii_[rng.integers(0, 4, int(e.sum()))]
            recs.append((s.tobytes(), (q + 33).astype(np.uint8).tobytes()))
        name = b"M0:7:FC1:1:%d:%d:%d" % (tile, x, y)
        made.append((name, recs))
        if c in planted:
            planted[c].add(name)
        if c == "polyg":
            tails[name] = t
    # the duplicate pairs: copies of main pairs at slots of their own
    # (outside the poor corner), placed at random positions
    mains = [j for j, c in enumerate(cls) if c == "main"]
    copies = [made[int(j)][1] for j in rng.choice(mains, n_dup, replace=False)]
    for recs, slot in zip(copies, slots[len(cls):]):
        tile_slot, xy = divmod(int(slot), 3000 * 3000)
        x, y = divmod(xy, 3000)
        if A8B_TILES[tile_slot] == A8B_BAD_TILE and x < 1000 and y < 1000:
            x += 1000
        dup = b"M0:7:FC1:1:%d:%d:%d" % (A8B_TILES[tile_slot], x, y)
        made.insert(int(rng.integers(0, len(made) + 1)), (dup, recs))
        planted["dup"].add(dup)
    for name, ((s1, q1), (s2, q2)) in made:
        r1s.append(b"@%s 1:N:0:ACGTACGT\n%s\n+\n%s\n" % (name, s1, q1))
        r2s.append(b"@%s 2:N:0:ACGTACGT\n%s\n+\n%s\n" % (name, s2, q2))
    d = {"r1": os.path.join(work, "a8b_1.fq.gz"), "r2": os.path.join(work, "a8b_2.fq.gz"),
         "head1": os.path.join(work, "a8b_head_1.fq.gz"),
         "head2": os.path.join(work, "a8b_head_2.fq.gz"), "second_fa": second_fa,
         "planted": planted, "tails": tails, "pairs": len(made)}
    for path, recs in ((d["r1"], r1s), (d["r2"], r2s)):
        with gzip.open(path, "wb", compresslevel=1) as fh:
            fh.write(b"".join(recs))
    head_fastq(d["r1"], d["head1"], A8B_CHECK_PAIRS)
    head_fastq(d["r2"], d["head2"], A8B_CHECK_PAIRS)
    d["decon"] = make_decon_data(work, rng)
    return d


def make_decon_data(work: str, rng) -> dict:
    """decontaminate's libraries: each an assembly (its genome in
    contigs, then the planted contaminant contigs of the next library's
    genome) and its reads (gzipped FASTQ). Returns the paths and each
    library's true and planted contig names."""
    genomes = [rng.integers(0, 4, DECON_CONTIGS * DECON_CONTIG_LEN).astype(np.uint8)
               for _ in range(DECON_LIBS)]
    ascii_ = np.frombuffer(b"ACGT", np.uint8)
    d = {"reads": [], "refs": [], "true": [], "planted": []}

    def tile(codes, depth, prefix):
        m = int(depth * len(codes) / DECON_READ_LEN)
        starts = rng.integers(0, len(codes) - DECON_READ_LEN + 1, m)
        return [b"@%s_%d\n%s\n+\n%s\n" % (prefix, i, ascii_[codes[s: s + DECON_READ_LEN]].tobytes(),
                                         b"I" * DECON_READ_LEN) for i, s in enumerate(starts)]

    for lib in range(DECON_LIBS):
        nxt = genomes[(lib + 1) % DECON_LIBS]
        contigs = [(b"lib%d_c%d" % (lib, c), genomes[lib][c * DECON_CONTIG_LEN:
                                                          (c + 1) * DECON_CONTIG_LEN])
                   for c in range(DECON_CONTIGS)]
        taken = rng.choice(DECON_CONTIGS, DECON_PLANTED, replace=False)
        planted = [(b"lib%d_contam%d" % (lib, int(c)), nxt[int(c) * DECON_CONTIG_LEN:
                                                           (int(c) + 1) * DECON_CONTIG_LEN])
                   for c in taken]
        ref = os.path.join(work, f"decon_lib{lib}.fa")
        with open(ref, "wb") as fh:
            fh.write(b"".join(b">%s\n%s\n" % (nm, ascii_[c].tobytes())
                              for nm, c in contigs + planted))
        reads = os.path.join(work, f"decon_lib{lib}.fq.gz")
        with gzip.open(reads, "wb", compresslevel=1) as fh:
            fh.write(b"".join(tile(genomes[lib], DECON_DEPTH, b"own%d" % lib)
                              + tile(nxt, DECON_SHARE, b"other%d" % lib)))
        d["reads"].append(reads)
        d["refs"].append(ref)
        d["true"].append({nm for nm, _ in contigs})
        d["planted"].append({nm for nm, _ in planted})
    return d


def a8b_rqc_argv(a8b: dict, ins: tuple, outdir: str, extra=()) -> list:
    """rqcfilter2's argv (without device=) over the pairs `ins` into
    `outdir`."""
    return ["rqcfilter2", f"in={ins[0]}", f"in2={ins[1]}", f"path={outdir}",
            f"removeref={a8b['second_fa']}", *A8B_FLAGS, *extra]


def a8b_decon_argv(a8b: dict, outdir: str) -> list:
    """decontaminate's argv (without device=) over the phase's libraries."""
    dec = a8b["decon"]
    return ["decontaminate", f"reads={','.join(dec['reads'])}", f"ref={','.join(dec['refs'])}",
            f"out={outdir}", *DECON_FLAGS]


def fastq_names(path: str) -> dict:
    """name (the header's first token) -> sequence of each record."""
    from bbtools_torch.io.fastq import FastqReader

    out = {}
    for b in FastqReader(path):
        for i in range(b.n):
            out[b.ids[i].split()[0]] = b.sequence(i)
    return out


def stage_timed(stages: list):
    """Wrap the tools rqcfilter runs in this process (BBDuk, clumpify,
    filterbytile, BBMap, reformat, BBMerge, kmercountexact) so that each
    call appends (tool, seconds, BBDuk's index type or None, the kernel
    launches of the call) to `stages`. Returns the undo function."""
    from bbtools_torch.models import (bbduk, bbmap, bbmerge, clumpify, filterbytile,
                                      kmercountexact, reformat)

    saved = []

    def wrap(mod, attr, tool):
        orig = getattr(mod, attr)

        def run(*a, **kw):
            before = {k: getattr(o, n) for k, (o, n) in counters().items()}
            t0 = time.perf_counter()
            res = orig(*a, **kw)
            dt = time.perf_counter() - t0
            got = {k: getattr(o, n) - before[k] for k, (o, n) in counters().items()}
            stages.append((tool, dt, index_of.pop("type", None), got))
            return res

        saved.append((mod, attr, orig))
        setattr(mod, attr, run)

    index_of: dict = {}
    orig_init = bbduk.BBDuk.__init__

    def init(self, *a, **kw):
        orig_init(self, *a, **kw)
        index_of["type"] = None if self.index is None else type(self.index).__name__

    saved.append((bbduk.BBDuk, "__init__", orig_init))
    bbduk.BBDuk.__init__ = init
    for mod, attr, tool in ((bbduk, "main", "bbduk"), (clumpify, "main", "clumpify"),
                            (filterbytile, "main", "filterbytile"), (reformat, "main", "reformat"),
                            (bbmerge, "main", "bbmerge"), (kmercountexact, "run", "kmercountexact")):
        wrap(mod, attr, tool)
    orig_run = bbmap.BBMap.run

    def map_run(self, *a, **kw):
        before = {k: getattr(o, n) for k, (o, n) in counters().items()}
        t0 = time.perf_counter()
        res = orig_run(self, *a, **kw)
        got = {k: getattr(o, n) - before[k] for k, (o, n) in counters().items()}
        stages.append(("bbmap", time.perf_counter() - t0, None, got))
        return res

    saved.append((bbmap.BBMap, "run", orig_run))
    bbmap.BBMap.run = map_run

    def undo():
        for mod, attr, orig in reversed(saved):
            setattr(mod, attr, orig)

    return undo


def a8b_phases(a8b: dict, work: str, card: str, phase_s: dict, launches: dict):
    """rqcfilter2 over A8B_PAIRS pairs on device=cuda with
    keepintermediates=t: each stage's reads, seconds, BBDuk's backend and
    kernel launches printed; B1, B2, B4, B5 and B6 required on the path
    (the artifact filter's panel, past the join's and the matcher's caps,
    takes the bucket table and launches no B3); filterstats.txt against
    the JAX package's (A8B_FILTERSTATS); each planted class removed at its
    stage. Then decontaminate over the DECON_LIBS libraries: every
    planted contaminant in its library's _dirty.fasta, every true contig
    in _clean.fasta."""
    t0 = time.perf_counter()
    out = os.path.join(work, "a8b_rqc.cuda")
    stages: list = []
    undo = stage_timed(stages)
    try:
        (res, dt, _), got = run_path(
            "rqcfilter2",
            lambda: run_tool("rqcfilter2", a8b_rqc_argv(a8b, (a8b["r1"], a8b["r2"]), out,
                                                         ["ki=t"])[1:], "cuda"),
            ("lane_lookup", "cummax_i64", "overlap_scan", "lane_table", "msa_fill"), launches)
    finally:
        undo()
    rows, final = res
    reads = {tag: r for tag, r, _ in rows}
    print(f"rqcfilter2 device=cuda: {a8b['pairs']} pairs in {dt:.2f} s = "
          f"{a8b['pairs'] / dt:.0f} pairs/s (wall, every stage's index build and IO) on "
          f"{card}; final {os.path.basename(final)}, {rows[-1][1]} reads")
    labels = [t for t, _, _ in rows[1:]] + ["interleave", "merge", "khist"]
    for (tool, secs, index, got_s), tag in zip(stages, labels):
        kern = {k: v for k, v in got_s.items() if v}
        print(f"  stage {tag:<15} {tool:<15} reads {reads.get(tag, '-')!s:>6}  "
              f"{secs:7.2f} s  backend {index or '-'}  launches {kern}")
    if any(s[2] == "MMKmerIndex" for s in stages) or got["mm_lookup"]:
        raise AssertionError("rqcfilter2: a stage took the matcher")
    with open(os.path.join(out, "filterstats.txt")) as fh:
        stats = fh.read()
    print("rqcfilter2 filterstats.txt:\n" + stats.rstrip())
    if stats != A8B_FILTERSTATS:
        raise AssertionError("rqcfilter2: filterstats.txt differs from the JAX package's "
                             "(A8B_FILTERSTATS)")
    a8b_planted_check(a8b, out)
    phase_s["rqcfilter2"] = time.perf_counter() - t0

    # ---- decontaminate (crossblock): BBMap, bbnorm on the card ----
    t0 = time.perf_counter()
    dec = a8b["decon"]
    dout = os.path.join(work, "a8b_decon.cuda")
    (_, dt, _), got = run_path(
        "decontaminate",
        lambda: routed("decontaminate",
                       lambda: run_tool("decontaminate", a8b_decon_argv(a8b, dout)[1:], "cuda"),
                       {"cms_add": None, "read_depths": None}),
        (), {})
    if not b4_total(got):
        raise AssertionError("decontaminate: B4 never launched")
    n_reads = sum(len(fastq_names(p)) for p in dec["reads"])
    print(f"decontaminate device=cuda: {DECON_LIBS} libraries, {n_reads} reads in {dt:.2f} s "
          f"on {card}; B4 launches {b4_routes(got)}")
    decon_check(a8b, dout)
    phase_s["decontaminate"] = time.perf_counter() - t0


def a8b_planted_check(a8b: dict, out: str):
    """Each planted class of rqcfilter2's input leaves at its own stage
    (`out` written with keepintermediates=t): every planted pair that
    reaches the stage is removed there, at most 5% of the class earlier;
    the stage of duplicates removes exactly the planted copies; no phiX,
    rRNA, second-genome or poor-corner pair reaches the final output;
    every poly-G tail of at least A8B_POLYG_MINK bases that reaches the
    polyfilter stage is trimmed there."""
    stem = os.path.basename(a8b["r1"]).split(".")[0]
    present = {"input": set(fastq_names(a8b["r1"]))}
    seqs = {}
    for tag, infix in A8B_STAGE_FILES:
        seqs[tag] = fastq_names(os.path.join(out, f"{stem}.{infix}.R1.fastq.gz"))
        present[tag] = set(seqs[tag])
    order = ["input"] + [t for t, _ in A8B_STAGE_FILES]
    for cls, stage in A8B_STAGE.items():
        names = a8b["planted"][cls]
        prev = present[order[order.index(stage) - 1]]
        before = names & prev
        left_here = before - present[stage]
        earlier = names - prev
        if cls == "dup":
            removed = len(prev) - len(present[stage])
            ok = removed == len(names)
            detail = f"{removed} pairs removed by the stage, {len(names)} planted"
        else:
            ok = left_here == before and len(earlier) <= 0.05 * len(names)
            detail = (f"{len(left_here)} of the {len(before)} that reached it removed there, "
                      f"{len(earlier)} earlier")
        print(f"rqcfilter2 planted {cls} ({len(names)} pairs) -> stage {stage}: {detail}")
        if not ok:
            raise AssertionError(f"rqcfilter2: planted {cls} not removed at {stage}")
        if cls != "dup" and names & present[order[-1]]:
            raise AssertionError(f"rqcfilter2: planted {cls} pairs in the final output")
    tails = a8b["tails"]
    reached = {nm for nm, t in tails.items() if t >= A8B_POLYG_MINK} & set(seqs["filter"])
    untrimmed = [nm for nm in reached if seqs["polyfilter"].get(nm, b"").endswith(
        b"G" * A8B_POLYG_MINK)]
    short = {nm for nm, t in tails.items() if t < A8B_POLYG_MINK} & set(seqs["filter"])
    kept = [nm for nm in short if seqs["polyfilter"].get(nm) == seqs["filter"][nm]]
    print(f"rqcfilter2 planted poly-G tails: {len(reached)} of at least {A8B_POLYG_MINK} bases "
          f"reached the polyfilter stage, {len(untrimmed)} left untrimmed there; "
          f"{len(kept)} of the {len(short)} shorter ones passed it unchanged")
    if untrimmed or not reached:
        raise AssertionError(f"rqcfilter2: poly-G tails left: {untrimmed[:3]}")


def decon_check(a8b: dict, dout: str):
    """Every planted contaminant contig in its library's _dirty.fasta,
    every true contig in _clean.fasta."""
    dec = a8b["decon"]
    bad = []
    for lib in range(DECON_LIBS):
        core = f"decon_lib{lib}"
        clean = set(fasta_names(os.path.join(dout, f"{core}_clean.fasta")))
        dirty = set(fasta_names(os.path.join(dout, f"{core}_dirty.fasta")))
        print(f"decontaminate {core}: clean {len(clean)} contigs ({len(clean & dec['true'][lib])} "
              f"of {DECON_CONTIGS} true), dirty {len(dirty)} ({len(dirty & dec['planted'][lib])} "
              f"of {DECON_PLANTED} planted)")
        if dirty != dec["planted"][lib] or clean != dec["true"][lib]:
            bad.append(core)
    if bad:
        raise AssertionError(f"decontaminate: contigs misplaced in {bad}")


def fasta_names(path: str) -> list[bytes]:
    """The record names of a FASTA file (first token)."""
    with open(path, "rb") as fh:
        return [ln[1:].split()[0] for ln in fh.read().splitlines() if ln.startswith(b">")]


def a8b_check_runs(a8b: dict, work: str) -> dict:
    """The CUDA-against-CPU checks of the read-QC phase: name -> (argv on
    device d, the directory d's run writes). rqcfilter2 on the first
    A8B_CHECK_PAIRS pairs; decontaminate on the phase's libraries (its
    CUDA run is the phase's)."""
    return {
        "rqcfilter2": lambda d: Check(a8b_rqc_argv(a8b, (a8b["head1"], a8b["head2"]),
                                                   os.path.join(work, f"a8b_rqcchk.{d}")),
                                      [os.path.join(work, f"a8b_rqcchk.{d}")]),
        "decontaminate": lambda d: Check(a8b_decon_argv(a8b, os.path.join(work,
                                                                         f"a8b_decon.{d}")),
                                         [os.path.join(work, f"a8b_decon.{d}")]),
    }


def a8b_checks(a8b: dict, runs: dict, cpu_side: CpuSide, phase_s: dict):
    """The read-QC checks, CUDA against CPU: every file of rqcfilter2's
    output directory (the final FASTQ, filterstats.txt, file-list.txt,
    the ihist, the khist, reproduce.sh with the run's directory replaced)
    and decontaminate's results.txt, covstats, clean and dirty FASTA,
    byte for byte."""
    t0 = time.perf_counter()
    for name, fn in runs.items():
        cpu_s = cpu_side.wait(name)
        cuda_s = cpu_side.wait(f"{name} cuda") if name != "decontaminate" else None
        dirs = {d: fn(d).outs[0] for d in ("cuda", "cpu")}
        files = {}
        for d, path in dirs.items():
            files[d] = {f: open(os.path.join(path, f), "rb").read().replace(
                path.encode(), b"DIR") for f in sorted(os.listdir(path))}
        if files["cuda"] != files["cpu"]:
            differ = sorted(f for f in set(files["cuda"]) | set(files["cpu"])
                            if files["cuda"].get(f) != files["cpu"].get(f))
            raise AssertionError(f"{name}: cuda and cpu outputs differ in {differ}")
        need = ({"filterstats.txt", "file-list.txt", "reproduce.sh", "a8b_head_1.khist.txt",
                 "a8b_head_1.ihist_merge.txt"} if name == "rqcfilter2" else
                {"results.txt"} | {f"decon_lib{i}_covstats{p}.txt" for i in range(DECON_LIBS)
                                   for p in (0, 1)})
        if not need <= set(files["cuda"]):
            raise AssertionError(f"{name}: missing {sorted(need - set(files['cuda']))}")
        where = (f"cuda {cuda_s:.2f} s in a process of its own, " if cuda_s is not None
                 else "cuda in its phase, ")
        print(f"{name}: cuda == cpu ({len(files['cuda'])} files, "
              f"{sum(len(v) for v in files['cuda'].values())} bytes; {where}cpu {cpu_s:.2f} s "
              f"in a process of its own)")
    phase_s["cuda == cpu, a8b"] = time.perf_counter() - t0


#: A8b group 4: `postfilter` at its defaults (mincov=2 minlen=200
#: minreads=6; inside it BBMap maxindel=0 minid=0.9; Postfilter.java,
#: postfilter.sh, the contig filter that assembly pipelines run after
#: assembly) over config #2's 1,000,000 bp genome cut into G4_CONTIGS
#: contigs of G4_CONTIG_LEN bp, with G4_PLANTED contigs of G4_PLANTED_LEN
#: bp of the second genome and G4_SHORT of G4_SHORT_LEN bp of config #2's
#: planted among them, and the first G4_PF_READS of config #2's reads
#: (3x): every genome contig kept, every planted and short one removed.
#: Its CUDA-against-CPU check runs on the first G4_PF_CHECK_CONTIGS
#: genome contigs, the planted ones and the reads that fall in the first
#: ones
G4_CONTIGS = 100
G4_CONTIG_LEN = 10_000
G4_PLANTED = 40
G4_PLANTED_LEN = (300, 2_000)
G4_SHORT = 20
G4_SHORT_LEN = (100, 199)
G4_PF_READS = 20_000
G4_PF_CHECK_CONTIGS = 10
#: `reassemble k=31` over two tid_ inputs, each G4_RA_READS reads of 150
#: bp (30x, 0.5% errors) of a G4_RA_REGION bp region, one of config #2's
#: genome and one of the second genome: every header carries its input's
#: tid_ label, each region's 31-mers at least G4_RA_RECALL_MIN in its
#: contigs
G4_RA_READS = 1_000
G4_RA_REGION = 5_000
G4_RA_RECALL_MIN = 0.9
#: `fll2simulate` at its defaults (buckets=2048 trials=9
#: tiers=1000,10000,100000,1000000): 9,999,000 keys through
#: loglog_update, one call a trial; each tier's meanRelErr under
#: G4_SIM_ERR_MAX
G4_SIM_TIERS = (1_000, 10_000, 100_000, 1_000_000)
G4_SIM_TRIALS = 9
G4_SIM_ERR_MAX = 0.05
#: the pruned fill (`ops.msa.msa_fill_batch` prune=True) over the window
#: classes the fused phase prepares for the BBMap row's first
#: MAP_CHECK_READS reads, min_score at BBMap's default minratio
G4_MINRATIO = 0.56


def make_g4_data(work: str, asm: dict, second_fa: str, seed: int) -> dict:
    """The inputs of the group-4 phase: postfilter's assembly (genome
    contigs, planted and short ones in a seeded order), its reads and its
    check's head; reassemble's two tid_ inputs and their regions."""
    from bbtools_torch.core.dna import CODE_TO_BASE
    from bbtools_torch.io.fasta import load_reference, write_fasta
    from bbtools_torch.utils.synth import parse_truth

    rng = np.random.default_rng(seed)
    first = load_reference(asm["ref.fa"]).scaffold_codes(0)
    second = load_reference(second_fa).scaffold_codes(0)

    def text(codes):
        return CODE_TO_BASE[np.minimum(codes, 4)].tobytes()

    def pieces(tag, src, n, lens):
        out = []
        for j in range(n):
            ln = int(rng.integers(lens[0], lens[1] + 1))
            p = int(rng.integers(0, len(src) - ln))
            out.append((b"%s_%d" % (tag, j), text(src[p: p + ln])))
        return out

    genome = [(b"contig_%d" % i, text(first[i * G4_CONTIG_LEN: (i + 1) * G4_CONTIG_LEN]))
              for i in range(G4_CONTIGS)]
    planted = pieces(b"planted", second, G4_PLANTED, G4_PLANTED_LEN)
    short = pieces(b"short", first, G4_SHORT, G4_SHORT_LEN)
    d = {k: os.path.join(work, f"g4_{k}") for k in (
        "asm.fa", "pf.fq.gz", "pf_check.fa", "pf_check.fq.gz")}
    recs = genome + planted + short
    write_fasta(d["asm.fa"], [recs[i] for i in rng.permutation(len(recs))])
    write_fasta(d["pf_check.fa"], genome[:G4_PF_CHECK_CONTIGS] + planted + short)
    head_fastq(asm["reads.fq.gz"], d["pf.fq.gz"], G4_PF_READS)
    with gzip.open(d["pf.fq.gz"], "rb") as fh:
        lines = fh.read().split(b"\n")
    span = G4_PF_CHECK_CONTIGS * G4_CONTIG_LEN
    head = [b"\n".join(lines[i: i + 4]) + b"\n" for i in range(0, len(lines) - 3, 4)
            if parse_truth(lines[i][1:])[1] + ASM_READ_LEN <= span]
    with gzip.open(d["pf_check.fq.gz"], "wb", compresslevel=1) as fh:
        fh.write(b"".join(head))
    d["check_reads"] = len(head)
    d["kept"] = {n for n, _ in genome}
    d["n_contigs"] = len(recs)
    d["tid"] = {}
    for tid, tag, src in ((1, "a", first), (2, "b", second)):
        p0 = int(rng.integers(0, len(src) - G4_RA_REGION))
        region = src[p0: p0 + G4_RA_REGION]
        path = os.path.join(work, f"tid_{tid}_{tag}.fq")
        reads = []
        for i in range(G4_RA_READS):
            p = int(rng.integers(0, G4_RA_REGION - ASM_READ_LEN + 1))
            r = region[p: p + ASM_READ_LEN].copy()
            e = rng.random(ASM_READ_LEN) < ASM_ERR
            r[e] = (r[e] + rng.integers(1, 4, int(e.sum()))) % 4
            if i % 2:
                r = 3 - r[::-1]
            reads.append(b"@t%d_%d\n%s\n+\n%s\n" % (tid, i, text(r), b"F" * ASM_READ_LEN))
        with open(path, "wb") as fh:
            fh.write(b"".join(reads))
        d["tid"][tid] = (path, region)
    return d


def g4_check_runs(g4: dict, work: str) -> dict:
    """The group-4 CUDA-against-CPU checks: name -> (argv on device d,
    d's output file). postfilter on its check's head; reassemble on the
    phase's inputs (its CUDA run is the phase's)."""
    def w(name):
        return os.path.join(work, name)

    ins = ",".join(g4["tid"][t][0] for t in (1, 2))
    return {
        "postfilter": lambda d: Check(["postfilter", f"in={g4['pf_check.fq.gz']}",
                                       f"ref={g4['pf_check.fa']}",
                                       f"out={w(f'g4_pfchk.{d}.fa')}"],
                                      [w(f"g4_pfchk.{d}.fa")]),
        "reassemble": lambda d: Check(["reassemble", f"in={ins}", f"out={w(f'g4_ra.{d}.fa')}",
                                       "k=31"], [w(f"g4_ra.{d}.fa")]),
    }


def g4_phases(g4: dict, ctx: dict, work: str, card: str, phase_s: dict) -> dict:
    """A8b group 4 on device=cuda: postfilter over the G4 assembly (the
    kept contigs exactly the genome's; B4's launches printed, none
    required: maxindel=0 may leave no task past the ungapped scorer);
    reassemble k=31 over the two tid_ inputs (Tadpole's load on the card,
    every header labelled, each region's 31-mers in its contigs); then
    fll2simulate at its defaults on both devices (equal), and the pruned
    fill over one BBMap batch's windows on the card, its CPU half started
    in a process for g4_fill_check. Returns what g4_fill_check takes."""
    import torch

    from bbtools_torch.io.fasta import iter_fasta
    from bbtools_torch.ops import msa
    from bbtools_torch.ops import msa_constants as C

    # ---- postfilter: BBMap (B4 past the ungapped scorer), pileup and
    # FilterByCoverage ----
    t0 = time.perf_counter()
    out = os.path.join(work, "g4_pf.cuda.fa")
    (_, dt, log), got = run_path(
        "postfilter", lambda: run_tool("postfilter", [f"in={g4['pf.fq.gz']}",
                                                      f"ref={g4['asm.fa']}", f"out={out}"],
                                       "cuda"), (), {})
    kept = set(fasta_names(out))
    print(f"postfilter device=cuda: {g4['n_contigs']} contigs, {G4_PF_READS} reads in "
          f"{dt:.2f} s = {g4['n_contigs'] / dt:.1f} contigs/s, {G4_PF_READS / dt:.0f} reads/s "
          f"(wall, the index build, pileup and the filter included) on {card}; kept "
          f"{len(kept)} ({len(kept & g4['kept'])} of the {G4_CONTIGS} genome contigs), removed "
          f"{g4['n_contigs'] - len(kept)}; B4 launches {b4_routes(got)}; "
          + "; ".join(ln.strip() for ln in log.splitlines() if "mapped" in ln or "Kept" in ln))
    if kept != g4["kept"]:
        raise AssertionError(f"postfilter: kept {sorted(kept ^ g4['kept'])[:5]} wrongly")
    phase_s["postfilter"] = time.perf_counter() - t0

    # ---- reassemble k=31: Tadpole once a tid_ input ----
    t0 = time.perf_counter()
    check = g4_check_runs(g4, work)["reassemble"]("cuda")
    _, dt, _ = run_routed("reassemble", "reassemble", check.argv[1:], {"sort_reduce": None})
    recs = list(iter_fasta(check.outs[0]))
    recall = {t: kmer_recall([r.seq for r in recs if r.name.startswith(b"tid_%d_" % t)],
                             g4["tid"][t][1]) for t in (1, 2)}
    labelled = all(r.name.startswith((b"tid_1_", b"tid_2_")) for r in recs)
    print(f"reassemble k=31 device=cuda: {2 * G4_RA_READS} reads in 2 inputs in {dt:.2f} s = "
          f"{2 * G4_RA_READS / dt:.0f} reads/s (wall, Tadpole's load on the card, its walk on "
          f"the host) on {card}; {len(recs)} contigs, every header labelled {labelled}; the "
          f"regions' 31-mers in their contigs: "
          + ", ".join(f"tid_{t} {v:.4f}" for t, v in recall.items()))
    if not recs or not labelled or min(recall.values()) < G4_RA_RECALL_MIN:
        raise AssertionError(f"reassemble: labelled {labelled}, recall {recall}")
    phase_s["reassemble"] = time.perf_counter() - t0

    # ---- fll2simulate: the cardinality harness on LogLog ----
    t0 = time.perf_counter()
    res = {}
    for d in ("cuda", "cpu"):
        buf = io.StringIO()

        def sim():
            with contextlib.redirect_stdout(buf):
                return run_tool("fll2simulate", [], d)

        _, dt, log = (routed("fll2simulate", sim,
                             {"loglog_update": len(G4_SIM_TIERS) * G4_SIM_TRIALS})
                      if d == "cuda" else sim())
        res[d] = (buf.getvalue(), log, dt)
    rows = [ln.split("\t") for ln in res["cuda"][0].splitlines() if ln and ln[0] != "#"]
    errs = {int(r[0]): float(r[2]) for r in rows}
    n_keys = G4_SIM_TRIALS * sum(G4_SIM_TIERS)
    print(f"fll2simulate device=cuda: {n_keys} keys in {res['cuda'][2]:.2f} s = "
          f"{n_keys / res['cuda'][2]:.0f} keys/s on {card}; meanRelErr "
          + ", ".join(f"{n} {e:.4f}" for n, e in errs.items())
          + f"; device=cpu {res['cpu'][2]:.2f} s")
    if sorted(errs) != list(G4_SIM_TIERS) or max(errs.values()) >= G4_SIM_ERR_MAX:
        raise AssertionError(f"fll2simulate: {errs}")
    if res["cuda"][:2] != res["cpu"][:2]:
        raise AssertionError("fll2simulate: cuda and cpu outputs differ")
    print(f"fll2simulate: cuda == cpu ({len(res['cuda'][0])} bytes of stdout, stderr equal)")
    phase_s["fll2simulate"] = time.perf_counter() - t0

    # ---- the pruned fill over one 256-read BBMap batch's windows ----
    t0 = time.perf_counter()
    _, B, _, by_wc = fused_windows(ctx["ref_fa"], ctx["map_small"])
    # one call over the batch's windows: each class's windows padded to
    # the widest, each task's own window length its ref_len (columns past
    # a task's ref_len feed none of its cells at or before it)
    classes = [tuple(x.cpu().numpy() for x in by_wc[wc]) for wc in sorted(by_wc)]
    R, Cw = max(c[0].shape[1] for c in classes), max(by_wc)
    reads = np.concatenate([np.pad(r, ((0, 0), (0, R - r.shape[1])), constant_values=4)
                            for r, _, _ in classes])
    refs = np.concatenate([np.pad(f, ((0, 0), (0, Cw - f.shape[1])), constant_values=4)
                           for _, _, f in classes])
    lens = np.concatenate([ln for _, ln, _ in classes])
    cols = np.concatenate([np.full(len(ln), f.shape[1], np.int32) for _, ln, f in classes])
    mins = (G4_MINRATIO * (C.POINTS_MATCH + (lens.astype(np.int64) - 1)
                           * C.POINTS_MATCH2)).astype(np.int64)
    inputs = (reads, lens, refs, cols, mins)
    before = msa.msa_fill_batch.device_calls
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    got = msa.msa_fill_batch(*inputs, prune=True, device="cuda")
    secs = time.perf_counter() - t1
    calls = msa.msa_fill_batch.device_calls - before
    killed = int((got[0] < mins - C.MIN_SCORE_ADJUST).sum())
    print(f"msa_fill_batch prune=True device=cuda: {len(lens)} tasks of {B} reads, the window "
          f"classes' ({', '.join(f'Cc={wc}: {t[0].shape[0]}' for wc, t in sorted(by_wc.items()))}) "
          f"in one call, {secs:.2f} s = {len(lens) / secs:.0f} tasks/s ({R + Cw - 1} diagonal "
          f"steps) on {card}; {killed} tasks pruned below min_score; {calls} call on the card")
    if calls != 1 or not len(lens):
        raise AssertionError(f"msa_fill_batch: {calls} calls on the card, {len(lens)} tasks")
    # the CPU half (a torch loop on the host, a minute or two on one
    # thread) in a process of its own beside the checks' processes;
    # g4_fill_check compares
    io_paths = [os.path.join(work, f"g4_fill.{x}.npz") for x in ("in", "cpu")]
    np.savez(io_paths[0], **dict(zip(("reads", "lens", "refs", "cols", "mins"), inputs)))
    with open(os.path.join(work, "g4_fill.log"), "wb") as log:
        proc = subprocess.Popen([sys.executable, "-c", G4_FILL_WORKER, *io_paths], cwd=HERE,
                                env=dict(os.environ, PYTHONPATH=HERE, OMP_NUM_THREADS="1"),
                                stdout=log, stderr=subprocess.STDOUT)
    SIDE_PROCS.append(proc)
    phase_s["pruned fill"] = time.perf_counter() - t0
    return {"fill": (proc, got, io_paths[1], os.path.join(work, "g4_fill.log")),
            "fill_inputs": inputs}


#: the pruned fill's CPU half: argv[1] the inputs (.npz), argv[2] where
#: its outputs and seconds go
G4_FILL_WORKER = r"""
import sys, time
import numpy as np
from bbtools_torch.ops.msa import msa_fill_batch

with np.load(sys.argv[1]) as z:
    args = [z[k] for k in ("reads", "lens", "refs", "cols", "mins")]
t0 = time.perf_counter()
out = msa_fill_batch(*args, prune=True, device="cpu")
np.savez(sys.argv[2], *out, s=time.perf_counter() - t0)
"""
#: processes the phases start outside CpuSide (main stops them)
SIDE_PROCS: list = []


def g4_fill_check(pending: dict):
    """The pruned fill's CPU half (started by g4_phases) against its CUDA
    half: score, column and state of every task equal."""
    proc, got, out, log = pending["fill"]
    if proc.wait():
        with open(log, errors="replace") as fh:
            print(fh.read()[-3000:])
        raise AssertionError(f"the CPU half of the pruned fill failed (rc {proc.returncode})")
    with np.load(out) as z:
        cpu = [z[f"arr_{i}"] for i in range(3)]
        secs = float(z["s"])
    if not all(np.array_equal(a, b) for a, b in zip(got, cpu)):
        raise AssertionError("msa_fill_batch: cuda and cpu differ")
    print(f"msa_fill_batch prune=True: cuda == cpu on every task (score, column, "
          f"state; cpu {secs:.2f} s in a process of its own, one thread)")


#: reads of config #1 that the surface phase's profiled BBDuk runs take
SURF_READS = 20_000
#: each profiled kernel's launch counter and the names its kernels carry
#: in a trace (csrc/*.cu)
TRACED = {"cummax_i64": ("cummax_one_pass_kernel",),
          "lane_lookup": ("lane_lookup_shared_kernel", "lane_lookup_l2_kernel")}


def surface_phase(fq: str, kern_fq: str, ctx: dict, g4_pending: dict, work: str, card: str,
                  phase_s: dict) -> dict:
    """The port's last surface on the card: BBDuk under profile=,
    the device seed-and-cluster, the sorted and hash k-mer indexes and
    the pruned fill with planes; its device=cpu half in a process of its
    own, for surface_fill_check. Returns what surface_fill_check takes."""
    import torch

    from bbtools_torch.io.fastq import FastqReader
    from bbtools_torch.models.bbduk import build_index, parse_args
    from bbtools_torch.models.bbmap import BBMap
    from bbtools_torch.models.bbmap import parse_args as bbmap_args
    from bbtools_torch.ops import kmer_index, msa
    from bbtools_torch.ops.bbduk_scan import KScanConfig, canonical_keys
    from bbtools_torch.ops.kmers import rolling_kmers
    from bbtools_torch.ops.seed_cluster import seed_candidates
    from bbtools_torch.utils.timer import device_events, device_profile, kernel_table, trace_path

    t_phase = time.perf_counter()
    # ---- BBDuk without and with profile= (B2 on config #1, B1 on the
    # one-adapter panel) ----
    t0 = time.perf_counter()
    head = os.path.join(work, "surface_head.fq.gz")
    head_fastq(fq, head, SURF_READS)
    # the profiler's start-up (CUPTI's, once a process) apart from the
    # runs: a trace of one small op
    t1 = time.perf_counter()
    with contextlib.redirect_stderr(io.StringIO()):
        with device_profile(os.path.join(work, "surface_prof_start"), "cuda"):
            torch.ones(1, device="cuda").sum().item()
    start_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    with contextlib.redirect_stderr(io.StringIO()):
        with device_profile(os.path.join(work, "surface_prof_start2"), "cuda"):
            torch.ones(1, device="cuda").sum().item()
    print(f"torch.profiler with CUDA activities: the first trace of one op {start_s:.2f} s "
          f"(its start-up, once a process), a second {time.perf_counter() - t1:.2f} s on {card}")
    for name in CONFIGS:
        prof = os.path.join(work, f"surface_prof_{name}")
        walls, files = {}, {}
        for tag, extra in (("plain", []), ("profiled", [f"profile={prof}"])):
            (out, stats, dt, log), got = run_path(
                f"bbduk {name} {tag}",
                lambda: run_bbduk(f"surface_{name}_{tag}", CONFIGS[name] + extra, head, work,
                                  "cuda"), (), {})
            walls[tag] = dt
            files[tag] = read_all([out, stats])
        if files["plain"] != files["profiled"]:
            raise AssertionError(f"bbduk {name}: profile= changed the output files")
        if f"Device profile written to {prof}" not in log:
            raise AssertionError(f"bbduk {name}: no profile line on stderr")
        trace = trace_path(prof)
        events = device_events(trace)
        kernels = [e for e in events if e.get("cat") == "kernel"]
        counted = {k: sum(any(n in e.get("name", "") for n in names) for e in kernels)
                   for k, names in TRACED.items()}
        print(f"bbduk {name} profile= device=cuda: {SURF_READS} reads, wall {walls['plain']:.2f} "
              f"s without the profiler, {walls['profiled']:.2f} s with it "
              f"({walls['profiled'] / walls['plain']:.2f}x), trace {os.path.getsize(trace)} "
              f"bytes, {len(events)} device events ({len(kernels)} kernels); kernel events "
              f"{counted}, launch counts { {k: got[k] for k in TRACED} } on {card}")
        top = kernel_table(trace)[:5]
        print(f"bbduk {name} profile=: the trace's kernel table, the most device time "
              f"first: " + "; ".join(f"{n[:60]} x{c} {us / 1e3:.3f} ms" for n, c, us in top))
        if not kernels:
            raise AssertionError(f"bbduk {name}: the trace holds no kernel event")
        need = "cummax_i64" if name == "adapters_fa" else "lane_lookup"
        if got[need] <= 0 or any(counted[k] != got[k] for k in TRACED):
            raise AssertionError(f"bbduk {name}: trace kernels {counted}, launches {got}")
    phase_s["surface: bbduk profile="] = time.perf_counter() - t0

    # ---- the device seed-and-cluster on one 4,096-read BBMap batch ----
    t0 = time.perf_counter()
    ref_fa = ctx["ref_fa"]
    tool = BBMap(bbmap_args([f"ref={ref_fa}", f"in={ctx['map_batch']}", "device=cuda"]),
                 index=WINDOW_INDEX.get(ref_fa))
    WINDOW_INDEX[ref_fa] = tool.index
    batch = list(tool._read_batches(ctx["map_batch"]))[0]
    lengths = batch.lengths.astype(np.int64)
    B = batch.bases.shape[0]
    t1 = time.perf_counter()
    host = tool.candidates_for_batch(batch.bases, lengths)
    host_s = time.perf_counter() - t1
    keys, vmask, offs, K = tool._seed_slots(batch.bases, lengths)
    cfg = tool.cfg
    bridge = min(cfg.max_indel, cfg.window_extras[-1] - 2 * cfg.pad)
    t_cap = 1 << max(14, (4 * B * K).bit_length())
    static = (B, K, t_cap, 2 * B * cfg.max_sites, cfg.max_sites, int(bridge))
    dev = torch.device("cuda")
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
        keys[0].astype(np.int32), keys[1].astype(np.int32), vmask[0], vmask[1], offs,
        tool.index.starts.astype(np.int32), tool.index.sites.astype(np.int32))]
    got = [x.cpu().numpy() for x in seed_candidates(*args, *static)]
    dev_ms = cuda_ms(lambda: seed_candidates(*args, *static), 5)
    n = int(got[6])
    equal = (bool(got[7]) and n == len(host[0])
             and all(np.array_equal(h.astype(np.int64), g[:n].astype(np.int64))
                     for h, g in zip(host[:6], got[:6]))
             and np.array_equal(host[6].astype(np.int64), got[8].astype(np.int64)))
    print(f"seed_candidates device=cuda: {B} reads, K={K}, t_cap={t_cap}, {n} candidates of "
          f"{int(got[8].sum())} clusters; {dev_ms:.3f} ms a call (CUDA events, the index "
          f"on the card) against the host candidates_for_batch's {host_s * 1e3:.1f} ms on "
          f"{card}; the nine outputs equal the host's: {equal}")
    if not equal:
        raise AssertionError("seed_candidates: cuda differs from the host candidates_for_batch")
    del args
    phase_s["surface: seed_candidates"] = time.perf_counter() - t0

    # ---- the sorted and hash indexes over config #1's keys ----
    t0 = time.perf_counter()
    bcfg = parse_args(CONFIGS["adapters_fa"])
    _, _, _, rkeys, rids = build_index(bcfg, return_keys=True)
    rids = rids.astype(np.int32)
    qbatch = list(FastqReader(kern_fq, batch_reads=BATCH))[0]
    fwd, rkm, _ = rolling_kmers(torch.from_numpy(qbatch.bases).to(dev), bcfg.k)
    mid = bcfg.mid_mask_bits if bcfg.mask_middle else -1
    q = canonical_keys(KScanConfig(k=bcfg.k, mid_mask=mid), fwd, rkm, bcfg.k)
    q_host = q.cpu().numpy()
    t1 = time.perf_counter()
    hidx = kmer_index.HashKmerIndex.build(rkeys, rids)
    build_s = time.perf_counter() - t1
    for label, idx, lookup in (
            ("SortedKmerIndex", kmer_index.SortedKmerIndex(rkeys, rids),
             kmer_index.SortedKmerIndex.lookup),
            ("HashKmerIndex", hidx, lambda *a: kmer_index.HashKmerIndex.lookup(
                *a[:3], hidx.cap, hidx.max_probe, a[3]))):
        tables = idx.device_arrays(dev)
        ids = lookup(*tables, q).cpu().numpy()
        want = idx.lookup_np(q_host)
        ms = cuda_ms(lambda: lookup(*tables, q), 10)
        extra = (f", cap {hidx.cap}, max probe {hidx.max_probe}, built in {build_s:.2f} s"
                 if idx is hidx else "")
        print(f"{label} device=cuda: {len(rkeys)} keys{extra}; {q.numel()} queries "
              f"{tuple(q.shape)} in {ms:.3f} ms a call ({q.numel() / ms / 1e6:.2f} G "
              f"lookups/s) on {card}; {(ids > 0).sum()} hits; equal to lookup_np: "
              f"{np.array_equal(ids, want)}")
        if not np.array_equal(ids, want) or not (want > 0).any():
            raise AssertionError(f"{label}: cuda lookups differ from lookup_np")
    phase_s["surface: indexes"] = time.perf_counter() - t0

    # ---- the pruned fill with planes and its walk, over 16's windows ----
    t0 = time.perf_counter()
    inputs = g4_pending["fill_inputs"]
    before = msa.msa_fill_batch.device_calls
    walk, walk_s = msa.msa_walk, []

    def timed(*a):
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out = walk(*a)
        torch.cuda.synchronize()
        walk_s.append(time.perf_counter() - t2)
        return out

    msa.msa_walk = timed
    try:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        got = msa.msa_fill_batch(*inputs, prune=True, device="cuda", traceback=True)
        secs = time.perf_counter() - t1
    finally:
        msa.msa_walk = walk
    calls = msa.msa_fill_batch.device_calls - before
    reads, lens, refs = inputs[:3]
    print(f"msa_fill_batch prune=True traceback=True device=cuda: {len(lens)} tasks, "
          f"{int(lens.max()) + refs.shape[1] - 1} diagonal steps and the walk in "
          f"{secs:.2f} s (the walk {sum(walk_s):.2f} s of it, {len(walk_s)} group; {calls} call "
          f"on the card, planes of "
          f"{(int(lens.max()) + refs.shape[1] - 1) * (int(lens.max()) + 1) * len(lens)} "
          f"bytes) on {card}; {int((got[4] > 0).sum())} tasks walked, "
          f"{int(got[4].sum())} walk steps")
    if calls != 1 or not (got[4] > 0).any():
        raise AssertionError(f"msa_fill_batch traceback=True: {calls} calls on the card")
    io_paths = [os.path.join(work, f"surface_fill.{x}") for x in ("in.npz", "cpu.npz", "log")]
    np.savez(io_paths[0], **dict(zip(("reads", "lens", "refs", "cols", "mins"), inputs)))
    with open(io_paths[2], "wb") as log:
        proc = subprocess.Popen([sys.executable, "-c", SURFACE_FILL_WORKER, *io_paths[:2]],
                                cwd=HERE, env=dict(os.environ, PYTHONPATH=HERE,
                                                   OMP_NUM_THREADS="1"),
                                stdout=log, stderr=subprocess.STDOUT)
    SIDE_PROCS.append(proc)
    phase_s["surface: pruned fill with planes"] = time.perf_counter() - t0
    phase_s["surface"] = time.perf_counter() - t_phase
    print(f"surface phase: {phase_s['surface']:.1f} s on {card}")
    return {"fill": (proc, got, io_paths[1], io_paths[2])}


#: the pruned fill with planes' CPU half: argv[1] the inputs (.npz),
#: argv[2] where its outputs and seconds go
SURFACE_FILL_WORKER = r"""
import sys, time
import numpy as np
from bbtools_torch.ops.msa import msa_fill_batch

with np.load(sys.argv[1]) as z:
    args = [z[k] for k in ("reads", "lens", "refs", "cols", "mins")]
t0 = time.perf_counter()
out = msa_fill_batch(*args, prune=True, device="cpu", traceback=True)
np.savez(sys.argv[2], *out, s=time.perf_counter() - t0)
"""


def surface_fill_check(pending: dict):
    """The pruned fill with planes' CPU half (started by surface_phase)
    against its CUDA half: score, column, state, walk ops and steps of
    every task equal."""
    proc, got, out, log = pending["fill"]
    if proc.wait():
        with open(log, errors="replace") as fh:
            print(fh.read()[-3000:])
        raise AssertionError(f"the CPU half of the fill with planes failed (rc {proc.returncode})")
    with np.load(out) as z:
        cpu = [z[f"arr_{i}"] for i in range(5)]
        secs = float(z["s"])
    if not all(np.array_equal(a, b) for a, b in zip(got, cpu)):
        raise AssertionError("msa_fill_batch traceback=True: cuda and cpu differ")
    print(f"msa_fill_batch prune=True traceback=True: cuda == cpu on every task (score, "
          f"column, state, walk ops and steps; cpu {secs:.2f} s in a process of its own, "
          f"one thread)")


def read_all(paths) -> list[bytes]:
    out = []
    for p in paths:
        with open(p, "rb") as fh:
            out.append(fh.read())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reads", type=int, default=200_000)
    ap.add_argument("--pairs", type=int, default=150_000)
    ap.add_argument("--map-reads", type=int, default=MAP_READS)
    ap.add_argument("--map-pairs", type=int, default=MAP_PAIRS)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "bbtools_torch")):
        print("chip_smoke: run from a checkout (bbtools_torch/ missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)

    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    card = f"{smi} (nvidia-smi name, power.limit)"
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    from bbtools_torch.kernels import build

    import threading

    # the kernels build (nvcc processes) while this thread makes the inputs
    built: dict = {}

    def build_kernels():
        t0 = time.perf_counter()
        try:
            build.library()
        except BaseException as e:  # raised again where the kernels are needed
            built["error"] = e
        built["s"] = time.perf_counter() - t0

    build_thread = threading.Thread(target=build_kernels)
    build_thread.start()

    def kernels_built():
        build_thread.join()
        if "error" in built:
            raise built["error"]
        print(f"kernel build: {built['s']:.1f} s, beside the inputs "
              f"(nvcc {build.build_seconds:.1f} s) -> "
              f"{os.path.relpath(build.library_path(), HERE)}")
        with open(build.library_path()[:-3] + ".log") as fh:
            for line in fh:
                if "registers" in line or "Compiling entry" in line:
                    print("  " + line.strip())

    phase_s: dict[str, float] = {}
    work = os.path.join(HERE, "_smoke_work")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    launches: dict[str, int] = {}
    try:
        fq = os.path.join(work, "reads.fq.gz")
        t0 = time.perf_counter()
        n_bases = make_fastq(fq, args.reads, args.seed)
        r1, r2 = (os.path.join(work, f"pairs_{m}.fq.gz") for m in (1, 2))
        make_pairs([r1, r2], args.pairs, args.seed + 1, 100, 400)
        tbo_in = os.path.join(work, "tbo.fq.gz")
        make_pairs([tbo_in], TBO_PAIRS, args.seed + 2, 100, 300)
        print(f"input: {args.reads} reads, {n_bases} bases; {args.pairs} pairs "
              f"(inserts 100-400); {TBO_PAIRS} interleaved pairs (inserts "
              f"100-300); made in {time.perf_counter() - t0:.1f} s")

        small = os.path.join(work, "head.fq.gz")
        head_fastq(fq, small, CHECK_READS)
        # the kernels are checked on one batch of the main path: BATCH reads
        # (CHECK_READS >= MERGE_BATCH covers BBMerge's batch of pairs)
        kern_fq = os.path.join(work, "head_batch.fq.gz")
        head_fastq(fq, kern_fq, BATCH)
        small_pairs = [os.path.join(work, f"head_pairs_{m}.fq.gz") for m in (1, 2)]
        head_fastq(r1, small_pairs[0], CHECK_READS)
        head_fastq(r2, small_pairs[1], CHECK_READS)
        nn_pairs = [os.path.join(work, f"nn_pairs_{m}.fq.gz") for m in (1, 2)]
        head_fastq(r1, nn_pairs[0], min(NN_PAIRS, args.pairs))
        head_fastq(r2, nn_pairs[1], min(NN_PAIRS, args.pairs))
        small_tbo = os.path.join(work, "head_tbo.fq.gz")
        head_fastq(tbo_in, small_tbo, 2 * CHECK_READS)
        mm_reads = min(MM_READS, args.reads)
        mm_in = os.path.join(work, "head_mm.fq.gz")
        head_fastq(fq, mm_in, mm_reads)

        # BBMap's inputs: the genome, 151 bp reads, pairs; the heads of
        # the CUDA-against-CPU comparison
        from bbtools_torch.io.fasta import load_reference as load_fasta
        from bbtools_torch.io.fasta import write_fasta
        from bbtools_torch.utils.synth import random_genome, random_reads, write_reads

        t0 = time.perf_counter()
        ref_fa = os.path.join(work, "ecoli_len.fa")
        write_fasta(ref_fa, random_genome(ECOLI_LEN, seed=args.seed))
        genome = load_fasta(ref_fa)
        map_fq = os.path.join(work, "map.fq.gz")
        write_reads(map_fq, random_reads(genome, args.map_reads, read_len=151,
                                         snp_rate=0.01, indel_rate=0.1,
                                         indel_range=(1, 10), seed=args.seed + 3))
        pairs = random_reads(genome, args.map_pairs, read_len=151, paired=True,
                             insert_range=(200, 500), snp_rate=0.01, indel_rate=0.1,
                             indel_range=(1, 10), seed=args.seed + 4)
        map_pe = [os.path.join(work, f"map_{m}.fq.gz") for m in (1, 2)]
        for m in (0, 1):
            write_reads(map_pe[m], [p[m] for p in pairs])
        del pairs
        map_batch = os.path.join(work, "map_batch.fq.gz")
        head_fastq(map_fq, map_batch, MAP_BATCH_READS)
        map_small = os.path.join(work, "map_head.fq.gz")
        head_fastq(map_fq, map_small, MAP_CHECK_READS)
        map_small_pe = [os.path.join(work, f"map_head_{m}.fq.gz") for m in (1, 2)]
        for m in (0, 1):
            head_fastq(map_pe[m], map_small_pe[m], MAP_CHECK_PAIRS)
        print(f"bbmap input: genome of {ECOLI_LEN} bp (seeded), {args.map_reads} reads "
              f"and {args.map_pairs} pairs of 151 bp; made in "
              f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        asm = make_asm_data(work, args.seed + 10)
        print(f"config #2/#5 input: genome of {ASM_GENOME} bp (seeded), a copy with "
              f"{sum(t == 'SUB' for _, t in asm['truth'])} SNPs, "
              f"{sum(t != 'SUB' for _, t in asm['truth'])} indels of 1-10 bp; "
              f"{ASM_READS} reads of {ASM_READ_LEN} bp of the copy ({ASM_ERR:.1%} base "
              f"errors), {asm['region_reads']} of them in its first {ASM_REGION} bp; "
              f"made in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        pipe = make_pipe_data(asm, work, args.seed + 20)
        bloom_fq = os.path.join(work, "bloom.fq.gz")
        make_bloom_reads(map_fq, bloom_fq, args.seed + 21)
        a2 = make_a2_data(work, genome, fq, map_fq, bloom_fq, args.seed + 30)
        print(f"A6b input: {PIPE_PAIRS} pairs of the region, {pipe['check_pairs']} of its "
              f"first {PIPE_CHECK_BP} bp and {PIPE_FULL_PAIRS} of the whole copy (2x150 bp, "
              f"inserts {PIPE_INSERTS[0]}-{PIPE_INSERTS[1]}, adapters past short inserts, "
              f"{ASM_ERR:.1%} base errors); {BLOOM_READS} map reads and {BLOOM_FOREIGN} "
              f"foreign reads; A2/A4b input: {LONG_READS} long reads of {LONG_RANGE[0]}-"
              f"{LONG_RANGE[1]} bp and {LONG_CHUNKED} of {LONG_CHUNKED_RANGE[0]}-"
              f"{LONG_CHUNKED_RANGE[1]} bp, {a2['side_planted']} phiX reads planted in "
              f"{a2['side_total']}, a second genome of {SECOND_GENOME} bp; made in "
              f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        a8 = make_a8a_data(work, genome, fq, args.reads, a2, asm, args.seed + 40)
        print(f"A8a input: seal's {len(a8['seal_refs'])} references (the genome in "
              f"{SEAL_PARTS} files, the second genome, phiX); dedupe's "
              f"{a8['dedupe_distinct'] + a8['dedupe_planted']} reads of 150 bp "
              f"({DEDUPE_DISTINCT} distinct, {DEDUPE_EXACT} exact copies, {DEDUPE_NEAR} "
              f"near-copies); made in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        l5 = make_l5_data(work, genome, args.seed + 50)
        print(f"L5 input: {ATA_SEQS} variants of the 16S consensus "
              f"({ATA_ID_RANGE[0]}-{ATA_ID_RANGE[1]} identity, 1-3 indels); {RIBO_READS} rRNA "
              f"reads ({', '.join(RIBO_TYPES)}; {RIBO_LEN[0]}-{RIBO_LEN[1]} bp, 5S whole); "
              f"{l5['pb_reads']} subreads of {IC_LEN[0]}-{IC_LEN[1]} bp in {IC_ZMWS} ZMWs, "
              f"{l5['pb_planted']} with a missed adapter; made in "
              f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        a8c = make_a8c_data(work, genome, ref_fa, fq, bloom_fq, asm, l5, args.seed + 60)
        print(f"a8c input: {MSA_READS} reads of {MSA_LEN[0]}-{MSA_LEN[1]} bp of the 16S "
              f"variants, {len(a8c['msa_planted'])} with a primer row planted; "
              f"{IFA_QUERIES} CRISPR records, {IFA_PLANTED} planted in the genome; "
              f"{a8c['poly_tails']} of config #1's reads given a poly-G tail; {ML_READS} "
              f"reads of two classes; {CAL_ROWS} calibration rows; made in "
              f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        a8b = make_a8b_data(work, genome.scaffold_codes(0), a2["second_fa"], args.seed + 70)
        print(f"a8b input: {a8b['pairs']} pairs of 2x150 bp of the genome with tiled headers "
              f"(inserts {A8B_INSERTS[0]}-{A8B_INSERTS[1]}), planted "
              f"{ {k: len(v) for k, v in a8b['planted'].items()} }; decontaminate's "
              f"{DECON_LIBS} libraries of {DECON_CONTIGS} x {DECON_CONTIG_LEN} bp contigs and "
              f"{DECON_PLANTED} contaminants each; made in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        g4 = make_g4_data(work, asm, a2["second_fa"], args.seed + 80)
        print(f"group 4 input: postfilter's {g4['n_contigs']} contigs ({G4_CONTIGS} of "
              f"{G4_CONTIG_LEN} bp of config #2's genome, {G4_PLANTED} of the second genome, "
              f"{G4_SHORT} short), its check's {g4['check_reads']} reads; reassemble's 2 x "
              f"{G4_RA_READS} reads of {G4_RA_REGION} bp regions; made in "
              f"{time.perf_counter() - t0:.1f} s")
        phase_s["input"] = time.perf_counter() - t_start
        kernels_built()

        t0 = time.perf_counter()
        kernels = check_kernels(kern_fq, *small_pairs)
        kernels[3:3] = check_msa_fill(ref_fa, map_batch)
        kernels.insert(4, check_b4_long())
        phase_s["kernels"] = time.perf_counter() - t0
        print(f"kernel timings on: {card}; kernel phase {phase_s['kernels']:.1f} s")
        t0 = time.perf_counter()

        # ---- the BBDuk paths, through the CLI ----
        needs = {"adapters_fa": ("cummax_i64",), "1adapter": ("lane_lookup",)}
        for name in CONFIGS:
            (_, stats, dt, _), _ = run_path(
                f"bbduk {name}",
                lambda: run_bbduk(name, CONFIGS[name], fq, work, "cuda"),
                needs[name], launches)
            with open(stats) as fh:
                text = fh.read()
            total = int(text.split("#Total\t")[1].split()[0])
            matched = int(text.split("#Matched\t")[1].split()[0])
            # every third read carries an adapter tail, some too short
            # (under mink=11 bases) to be found: ~31% match
            if total != args.reads or not args.reads // 4 <= matched < args.reads // 2:
                raise AssertionError(f"{name}: {total} reads, {matched} matched")
            print(f"bbduk {name} device=cuda: {matched} of {total} reads matched")
            print(f"bbduk {name} device=cuda: {args.reads} reads in {dt:.2f} s = "
                  f"{args.reads / dt:.0f} reads/s, {n_bases / dt:.0f} bases/s "
                  f"(wall, incl. index build and IO) on {card}")

        # ---- BBDuk on the matcher backend (B3) ----
        (_, stats, dt, log), got = run_path(
            "bbduk mm",
            lambda: run_bbduk("mm", MM_CONFIG, mm_in, work, "cuda", showtimes=True),
            ("mm_lookup",), launches)
        if got["lane_lookup"] or got["cummax_i64"]:
            raise AssertionError("bbduk mm: the index is not the matcher")
        setup = float(log.split("Setup:")[1].split()[0])
        print(f"bbduk mm index build (ref=adapters,phix k=23 mink=11 hdist=2: "
              f"expansion, gate, matcher columns; CLI Setup phase): {setup:.1f} s")
        with open(stats) as fh:
            text = fh.read()
        total = int(text.split("#Total\t")[1].split()[0])
        matched = int(text.split("#Matched\t")[1].split()[0])
        if total != mm_reads or not mm_reads // 4 <= matched < mm_reads:
            raise AssertionError(f"mm: {total} reads, {matched} matched")
        print(f"bbduk mm device=cuda: {matched} of {total} reads matched; "
              f"{mm_reads} reads in {dt:.2f} s = {mm_reads / dt:.0f} reads/s "
              f"(wall, incl. the {setup:.1f} s index build), "
              f"{mm_reads / (dt - setup):.0f} reads/s after set-up, on {card}")

        # ---- paired BBDuk with tbo tpe (B1, B5, B6) ----
        (_, stats, dt, _), _ = run_path(
            "bbduk tbo",
            lambda: run_bbduk("tbo", TBO_FLAGS, tbo_in, work, "cuda"),
            ("lane_lookup", "overlap_scan", "lane_table"), {})
        print(f"bbduk tbo tpe device=cuda: {TBO_PAIRS} pairs in {dt:.2f} s = "
              f"{TBO_PAIRS / dt:.0f} pairs/s (wall) on {card}")

        # ---- BBMerge (B5, B6) ----
        (outs, dt, log), _ = run_path(
            "bbmerge", lambda: run_bbmerge([r1, r2], work, "main", "cuda"),
            ("overlap_scan", "lane_table"), launches)
        with open(outs[3]) as fh:
            merged = int(fh.read().split("#InsertCount\t")[1].split()[0])
        share = merged / args.pairs
        print(log.strip())
        if not MERGED_RANGE[0] <= share <= MERGED_RANGE[1]:
            raise AssertionError(f"bbmerge: merged share {share:.4f} outside {MERGED_RANGE}")
        print(f"bbmerge device=cuda: {merged} of {args.pairs} pairs merged "
              f"({share:.4f}, expected {MERGED_RANGE[0]}-{MERGED_RANGE[1]})")
        print(f"bbmerge device=cuda: {args.pairs} pairs in {dt:.2f} s = "
              f"{args.pairs / dt:.0f} pairs/s, {2 * args.pairs / dt:.0f} reads/s "
              f"(wall, incl. IO) on {card}")
        ctx = {"pairs": (r1, r2), "nn_pairs": nn_pairs, "merge_share": share,
               "merge_rate": args.pairs / dt,
               "asm": asm, "ref_fa": ref_fa, "bloom_fq": bloom_fq, "map_fq": map_fq,
               "map_batch": map_batch, "map_small": map_small, "small_pairs": small_pairs,
               "bbduk_checks": (*((n, CONFIGS[n], small) for n in CONFIGS),
                                ("tbo", TBO_FLAGS, small_tbo)),
               "bbmap_checks": (("single end", [f"in={map_small}"]),
                                ("paired", [f"in={map_small_pe[0]}", f"in2={map_small_pe[1]}"]))}

        # ---- BBMap (B4), single end and paired ----
        sam = ctx["map_sam"] = os.path.join(work, "map.cuda.sam")
        (tool, dt, _), got = run_path(
            "bbmap", lambda: run_tool("bbmap", [f"ref={ref_fa}", f"in={map_fq}",
                                                f"out={sam}"], "cuda"),
            ("msa_fill", "msa_fill_block"), launches)
        share = tool.reads_mapped / max(tool.reads_in, 1)
        mapped, placed = placed_share(sam)
        print(f"bbmap index build (k=13, {ECOLI_LEN} bp): {tool.index_seconds:.2f} s")
        print(f"bbmap device=cuda: {tool.reads_mapped} of {tool.reads_in} reads mapped "
              f"({share:.4f}, expected {MAPPED_RANGE[0]}-{MAPPED_RANGE[1]}); "
              f"{placed:.4f} of {mapped} placed within 20 bp of their origin")
        print(f"bbmap device=cuda: {args.map_reads} reads in {dt:.2f} s = "
              f"{args.map_reads / dt:.0f} reads/s (wall, incl. the index build and IO) "
              f"on {card}")
        ctx["map_rate"] = args.map_reads / dt
        print(f"bbmap B4 launches: {b4_routes(got)}; batches whose fused phase "
              f"overflowed its walk cap and ran staged: {tool.fused_overflows}")
        if tool.reads_in != args.map_reads or not MAPPED_RANGE[0] <= share <= MAPPED_RANGE[1]:
            raise AssertionError(f"bbmap: {tool.reads_mapped} of {tool.reads_in} mapped")
        if placed < PLACED_MIN:
            raise AssertionError(f"bbmap: only {placed:.4f} of mapped reads placed")
        pe_sam = os.path.join(work, "map_pe.cuda.sam")
        (tool, dt, _), got = run_path(
            "bbmap paired",
            lambda: run_tool("bbmap", [f"ref={ref_fa}", f"in={map_pe[0]}",
                                       f"in2={map_pe[1]}", f"out={pe_sam}"], "cuda"),
            ("msa_fill", "msa_fill_block"), {})
        share = tool.reads_mapped / max(tool.reads_in, 1)
        mapped, placed = placed_share(pe_sam)
        print(f"bbmap paired device=cuda: {tool.reads_mapped} of {tool.reads_in} reads "
              f"mapped ({share:.4f}), {tool.rescued} mates rescued; {placed:.4f} of "
              f"{mapped} placed within 20 bp; B4 launches {b4_routes(got)}, fused "
              f"overflows {tool.fused_overflows}")
        print(f"bbmap paired device=cuda: {args.map_pairs} pairs in {dt:.2f} s = "
              f"{args.map_pairs / dt:.0f} pairs/s (wall) on {card}")
        if tool.reads_in != 2 * args.map_pairs or not MAPPED_RANGE[0] <= share <= MAPPED_RANGE[1]:
            raise AssertionError(f"bbmap paired: {tool.reads_mapped} of {tool.reads_in} mapped")
        if placed < PLACED_MIN:
            raise AssertionError(f"bbmap paired: only {placed:.4f} of mapped reads placed")
        phase_s["bbduk, bbmerge, bbmap"] = time.perf_counter() - t0

        # the CPU halves of the checks (plain versions on one thread,
        # minutes each for the L5 tools' and the long reads') in
        # EARLY_SIDE_WORKERS processes from here on, beside the phases
        # below: the recalibrate=t and coverage checks' once calctruequality
        # has run; netfilter's and scoresequence's, which need the trained
        # net, with the CUDA halves once the last rate is taken
        early = CpuSide(pool_runs(l5_check_runs(l5, small, work))[0]
                        + early_runs(ctx, pipe, work, "cpu")
                        + pool_runs(a8a_check_runs(a8, work))[0]
                        + [r for r in pool_runs(a8c_check_runs(a8c, work))[0]
                           if r[0] not in A8C_NEED_NET]
                        + pool_runs(a8b_check_runs(a8b, work))[0]
                        + pool_runs(g4_check_runs(g4, work))[0], work,
                        workers=EARLY_SIDE_WORKERS, tag="early_side")
        print(f"CPU halves of the checks: {EARLY_SIDE_WORKERS} processes, from the config "
              f"#2/#5 phases on")
        asm_out = asm_phases(asm, work, card, phase_s)
        ctx["cv_sam"] = asm_out["sam"]
        a6b_out = a6b_phases(asm, pipe, ctx, work, card, phase_s)
        a2_phases(a2, ctx, work, card, phase_s, launches)
        early.add(pool_runs(a2_check_runs(a2, ctx, work))[0])
        a8a_phases(asm, a2, a8, work, card, phase_s)
        l5_phases(l5, fq, args.reads, work, card, phase_s)
        a8c_phases(a8c, fq, args.reads, work, card, phase_s)
        kernels.append(a7_phase(fq, map_batch, ref_fa, small_pairs, asm["reads.fq.gz"],
                                kern_fq, work, card, phase_s, launches))
        a8b_phases(a8b, work, card, phase_s, launches)
        g4_pending = g4_phases(g4, ctx, work, card, phase_s)
        surface_pending = surface_phase(fq, kern_fq, ctx, g4_pending, work, card, phase_s)
        early.close()
        # the CUDA halves of the checks, and the CPU halves that need the
        # trained net, in processes once the last rate is taken
        a8c_runs = a8c_check_runs(a8c, work)
        late = (early_runs(ctx, pipe, work, "cuda")
                + pool_runs(a2_check_runs(a2, ctx, work))[1]
                + pool_runs(a8a_check_runs(a8, work), skip=("ecc",))[1]
                + [r for r in pool_runs(a8c_runs)[0] if r[0] in A8C_NEED_NET]
                + pool_runs(a8b_check_runs(a8b, work), skip=("decontaminate",))[1]
                + pool_runs(g4_check_runs(g4, work), skip=("reassemble",))[1])
        print(f"CUDA halves of the checks: {CPU_SIDE_WORKERS} processes")
        import torch

        torch.cuda.empty_cache()  # the card's memory for the processes' CUDA halves
        # the longest first: tadpipe's, the merge stage's, mapPacBio's and
        # the skimmer's
        late.sort(key=lambda r: r[0] not in LATE_FIRST)
        cpu_side = ctx["cpu_side"] = CpuSide(late, work)
        cpu_side.close()
        # the L5 and a8c checks' CUDA halves here, while the processes run
        t0 = time.perf_counter()
        l5_here = cuda_halves_here(l5_check_runs(l5, small, work))
        a8c_here = cuda_halves_here(a8c_runs)
        phase_s["cuda halves of the l5 and a8c checks"] = time.perf_counter() - t0
        t0 = time.perf_counter()

        # ---- CUDA against CPU, byte for byte, on the first reads (both
        # halves in processes) ----
        for name, flags, fin in ctx["bbduk_checks"]:
            cpu_side.wait(f"bbduk {name} cuda")
            cpu_side.wait(f"bbduk {name}")
            files = {d: read_all(bbduk_argv(name, flags, fin, work, d)[1])
                     for d in ("cuda", "cpu")}
            if files["cuda"] != files["cpu"]:
                raise AssertionError(f"{name}: cuda and cpu outputs differ")
            print(f"bbduk {name}: cuda == cpu on {CHECK_READS} reads/pairs "
                  f"({len(files['cuda'][0])} output bytes, stats equal)")
        cpu_side.wait("bbmerge cuda")
        cpu_side.wait("bbmerge")
        files = {d: read_all(bbmerge_argv(small_pairs, work, "head", d)[1])
                 for d in ("cuda", "cpu")}
        if files["cuda"] != files["cpu"]:
            raise AssertionError("bbmerge: cuda and cpu outputs differ")
        print(f"bbmerge: cuda == cpu on {CHECK_READS} pairs (merged "
              f"{len(files['cuda'][0])} bytes, unmerged and ihist equal)")
        for (name, ins), n in zip(ctx["bbmap_checks"], (MAP_CHECK_READS, MAP_CHECK_PAIRS)):
            dt = cpu_side.wait(f"bbmap {name} cuda")
            cpu_dt = cpu_side.wait(f"bbmap {name}")
            files = {d: read_all(bbmap_check_argv(ctx, ins, name, work, d)[1])
                     for d in ("cuda", "cpu")}
            print(f"bbmap {name}: {n} reads/pairs in {dt:.2f} s on cuda, {cpu_dt:.2f} s on "
                  f"cpu (each in a process of its own)")
            if files["cuda"] != files["cpu"]:
                raise AssertionError(f"bbmap {name}: cuda and cpu SAM differ")
            print(f"bbmap {name}: cuda == cpu on {n} reads/pairs "
                  f"({len(files['cuda'][0])} SAM bytes)")
        phase_s["cuda == cpu, earlier tools"] = time.perf_counter() - t0

        asm_checks(asm, work, {**asm_out, "cpu_side": cpu_side}, phase_s)
        a6b_checks(asm, pipe, ctx, a6b_out, work, phase_s)
        file_checks("a2/a4b", a2_check_runs(a2, ctx, work), cpu_side, phase_s)
        file_checks("a8a", a8a_check_runs(a8, work), cpu_side, phase_s)
        file_checks("l5", l5_check_runs(l5, small, work), cpu_side, phase_s, here=l5_here)
        a8c_checks(a8c, a8c_runs, cpu_side, a8c_here, phase_s)
        a8b_checks(a8b, a8b_check_runs(a8b, work), cpu_side, phase_s)
        file_checks("a8b group 4", g4_check_runs(g4, work), cpu_side, phase_s)
        g4_fill_check(g4_pending)
        surface_fill_check(surface_pending)
        loglog_check(asm)
        for row in kernels:
            if "launches" not in row:
                row["launches"] = launches[row["name"]]
    finally:
        build_thread.join()
        for side in CpuSide.started:
            side.stop()
        for proc in SIDE_PROCS:
            if proc.poll() is None:
                proc.kill()
        shutil.rmtree(work, ignore_errors=True)

    print("phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items())
          + f"; total {time.perf_counter() - t_start:.1f}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
