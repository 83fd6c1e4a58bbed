"""Guards of the port's rules: it never imports JAX or the JAX package;
its copied host code does not drift from the JAX package's; the device
and the kernels are explicit, with no silent move to the CPU or to a
plain version; flags of stages not ported yet raise."""

import ast
import importlib
import inspect
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax():
    code = (
        "import pkgutil, importlib, sys, bbtools_torch\n"
        "import bbtools_torch.cli, bbtools_torch.models.bbduk\n"
        "for m in pkgutil.walk_packages(bbtools_torch.__path__, 'bbtools_torch.'):\n"
        "    if not m.name.endswith('__main__'):\n"
        "        importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'bbtools_tpu'))\n"
        "print(len([m for m in sys.modules if m.startswith('bbtools_torch')]), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True)
    assert res.returncode == 0, res.stdout + res.stderr
    assert int(res.stdout.split()[0]) >= 20


def test_port_sources_name_no_jax():
    """No module of the port even mentions an import of jax."""
    for root, _, files in os.walk(os.path.join(REPO, "bbtools_torch")):
        for f in files:
            if f.endswith(".py"):
                tree = ast.parse(open(os.path.join(root, f)).read())
                for node in ast.walk(tree):
                    names = (
                        [a.name for a in node.names] if isinstance(node, ast.Import)
                        else [node.module or ""] if isinstance(node, ast.ImportFrom)
                        else []
                    )
                    for n in names:
                        assert n.split(".")[0] not in ("jax", "bbtools_tpu"), (f, n)


#: modules the port copies verbatim (package name replaced)
COPIED_MODULES = [
    "core/dna.py", "core/parser.py", "core/qualtools.py",
    "io/readwrite.py", "io/fileformat.py", "io/bgzf.py", "io/batch.py",
    "io/fastq.py", "io/fasta.py", "ops/entropy.py", "ops/join.py",
    "utils/readstats.py", "native/__init__.py",
    "ops/msa_constants.py", "ops/gaps.py", "io/sam.py", "io/sam_read.py",
    "io/bam.py", "utils/synth.py", "models/bbmap_index.py",
    "io/stream.py", "models/tadpole_ecc.py", "ml/__init__.py",
    "models/assemblystats.py", "models/calctruequality.py", "models/pileup.py",
    "models/gradesam.py", "utils/graders.py", "models/kmernorm_ecc.py",
    # A8b's read-QC slice: the host tools
    "models/demux.py", "models/seqtools.py",
    "models/novademux.py", "models/filtertools.py", "models/splitpairs.py",
    "models/sortbyname.py", "models/bbmask.py", "models/smalltools.py",
    "models/barcodetools.py", "models/hiseqtools.py", "models/illuminatools.py",
    "models/splitnextera.py",
    # A8b's sketch, taxonomy and file-tool slice (callgenes for
    # translate6frames' translate; its launcher comes with pgm)
    "utils/graders2.py", "ops/sketch_hash.py", "models/taxonomy.py", "models/clade.py",
    "models/server.py", "models/seqmisc.py", "models/callgenes.py",
    # A8b group 4: the host modules of the long tail
    "models/consensus.py", "models/contam.py", "models/crispr.py", "models/fixgaps.py",
    "models/fungalrelease.py", "models/gfftools.py", "models/gradebins.py",
    "models/lilypad.py", "models/pgmtrain.py", "models/prottools.py", "models/quickbin.py",
    "models/randomreads.py", "models/samutils.py", "models/scalartools.py",
    "models/vcftools.py",
    # shared/MetadataWriter (its program field names the package)
    "utils/metadata.py",
]


def _function_text(src: str, name: str) -> str:
    """The source lines of the top-level function `name` of src."""
    node = next(n for n in ast.parse(src).body
                if isinstance(n, ast.FunctionDef) and n.name == name)
    return "".join(src.splitlines(keepends=True)[node.lineno - 1:node.end_lineno])


#: copied modules with one function departing from the copy (its lines
#: are held by EDITED_FUNCTIONS): C7's partition deals FASTA as FASTA
EDITED_IN_COPY = {"models/smalltools.py": "partition"}


@pytest.mark.parametrize("rel", COPIED_MODULES)
def test_copied_module_has_not_drifted(rel):
    src = open(os.path.join(REPO, "bbtools_tpu", rel)).read()
    port = open(os.path.join(REPO, "bbtools_torch", rel)).read()
    want = src.replace("bbtools_tpu", "bbtools_torch")
    # the port's copies cite the reference's sources by their path inside
    # the reference tree, without the local mount point
    want = re.sub(r"\S*/reference/current/", "", want)
    if rel == "native/__init__.py":
        # the port builds into a per-process temp name, so processes that
        # build at the same moment do not collide
        build = '    try:\n        subprocess.run(\n'
        assert want.count(build) == 1 and want.count('cache + ".tmp"') == 2
        want = want.replace(
            build, '    tmp = f"{cache}.{os.getpid()}.tmp"\n' + build
        ).replace('cache + ".tmp"', "tmp")
    if rel in EDITED_IN_COPY:
        name = EDITED_IN_COPY[rel]
        want = want.replace(_function_text(want, name), _function_text(port, name))
    assert port == want


#: modules the port copies but for the named definitions (top-level
#: names, or Class.member), which hold its device code or its device
#: flag; every other definition of the JAX package's module (functions,
#: classes, constants) is in the port's, equal to the letter. A class
#: with a named member is compared member by member.
PARTLY_COPIED = {
    "ops/kmer_count.py": ["batch_kmers_jnp", "sort_reduce", "count_batch",
                          "_merge_spectra", "_accumulate_batch", "DeviceSpectrum"],
    "ops/kmers2.py": ["count_batchw_exact", "rolling_kmersw_jnp", "canonical_words_jnp",
                      "_count_batchw_jit", "count_batchw_device", "PADW"],
    "models/kmercountexact.py": ["run"],
    "models/tadpole.py": ["TadpoleConfig.device", "parse_args", "Tadpole.load_kmers"],
    "models/callvariants.py": ["choose_net", "CallVariants.__init__",
                               "CallVariants._realign_flush", "main"],
    "ml/cellnet.py": ["_MSIG_YMULT", "_activations", "CellNet.device", "CellNet.forward",
                      "CellNet.apply", "CellNet.fit"],
    # tadpipe passes its device= to every stage
    "models/tadpipe.py": ["tadpipe"],
    "models/bbrealign.py": ["main"],
    "ops/cms.py": ["_jax", "_slots_jnp", "make_cms_add", "make_cms_query",
                   "CountMinSketch.__init__", "CountMinSketch.add", "CountMinSketch.query",
                   "CountMinSketch.query_jnp"],
    # the micro-aligner's batch functions run on the device; the index
    # build and the host fallback are the JAX package's
    "ops/microalign.py": ["micro_map_batch", "quick_align_batch",
                          "MicroIndex.device_tables"],
    # the side channel takes a device and reads phiX from the JAX
    # package's resources by path
    "models/sidechannel.py": ["_resolve_side_ref", "SideChannel.__init__",
                              "SideChannel._map_one_side"],
    # bbsplit passes its device= to the mapper
    "models/bbsplit.py": ["BBSplitConfig", "parse_args", "BBSplit.run"],
    # the batched banded edit distance runs as torch ops
    "ops/banded.py": ["banded_edits_jnp", "align_pairs_jnp"],
    # Dedupe takes a device and verifies a batch's pairs on it
    "models/dedupe.py": ["Dedupe.__init__", "Dedupe.judge_batch", "main"],
    # the pivot runs as torch ops on the run's device
    "models/clumpify.py": ["pivot_kmers", "_pivot_kmers_jnp", "main"],
    # the glocal identity aligner runs as torch ops (ROADMAP L5), the
    # banded identity on ops/banded; the host engines are the JAX package's
    "ops/idalign.py": ["BandedIDAligner.align_batch", "glocal_identity_jnp", "NEG", "KOFF",
                       "FIELD", "_glocal_scan", "glocal_identity", "glocal_counts"],
    # the tools on L5 take a device= and call it
    "models/alltoall.py": ["main"],
    "models/ribo.py": ["RES_DIR", "_batch_identities", "splitribo", "mergeribo"],
    "models/icecream.py": ["ICConfig", "parse_args", "check_batch",
                           "IceCreamFinder.__init__"],
    "models/alignertools.py": ["_device_identity", "batch_main", "length_main",
                               "align_random_main", "micro_main"],
    # reformat's quality trim runs on the device
    "models/reformat.py": ["main"],
    # the ML tools that train or run a net take a device=
    "models/mltools.py": ["train_main", "scoresequence_main", "netfilter_main"],
    # decontaminate passes its device= to BBMap, bbnorm and Tadpole
    "models/decontaminate.py": ["main"],
    # filterbytile also takes pairs (in2=, out2=), judged as the
    # interleaved stream
    "models/filterbytile.py": ["FBTConfig", "parse_args", "FilterByTile._records",
                               "FilterByTile.analyze", "FilterByTile.filter"],
    # the blacklist keywords name the JAX package's resources, by path
    "models/sketch.py": ["load_blacklist"],
    # comparessu and findssu align on the run's device (L5)
    "models/ssutools.py": ["comparessu_main", "findssu_main"],
    # kmerlimit's LogLog hashes on the run's device
    "models/synthtools.py": ["kmerlimit"],
    # javasetup reports torch's devices in place of JAX's
    "models/fileutils.py": ["javasetup_main"],
    # bloomfilter's sketch and kmercountmulti's LogLogs live on the device
    "models/texttools.py": ["bloomfilter", "kmercountmulti"],
    # kmercoverage's sketch lives on the device; the rest is host code
    "models/misctools.py": ["kmercoverage"],
    # the launchers that reach the device take a device=; calibrate fits
    # with torch autograd
    "models/research.py": ["cardinality_sim_main", "calibrate_main", "calibrate_fit",
                           "calibrate_fit.device_calls", "postfilter_main",
                           "reassemble_main"],
    # the bundled gene model is the JAX package's, read by path
    "models/pgm.py": ["parse_pgm"],
}


def _definitions(path: str, members_of: set) -> dict:
    """name -> source of each top-level definition and constant of a
    module (imports and docstrings left out); for the classes in
    members_of, each member as Class.member instead of the whole."""
    src = open(path).read()
    out = {}

    def add(prefix, body):
        for node in body:
            if isinstance(node, (ast.Import, ast.ImportFrom)) or (
                    isinstance(node, ast.Expr) and isinstance(node.value, ast.Constant)):
                continue
            if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
                name = node.name
            elif isinstance(node, ast.Assign):
                name = ast.unparse(node.targets[0])
            elif isinstance(node, ast.AnnAssign):
                name = ast.unparse(node.target)
            else:
                name = ast.unparse(node)
            if isinstance(node, ast.ClassDef) and prefix + name in members_of:
                add(prefix + name + ".", node.body)
            else:
                out[prefix + name] = ast.get_source_segment(src, node)
    add("", ast.parse(src).body)
    return out


@pytest.mark.parametrize("rel", sorted(PARTLY_COPIED))
def test_partly_copied_module_has_not_drifted(rel):
    skip = set(PARTLY_COPIED[rel])
    classes = {n.split(".")[0] for n in skip if "." in n}
    want = _definitions(os.path.join(REPO, "bbtools_tpu", rel), classes)
    got = _definitions(os.path.join(REPO, "bbtools_torch", rel), classes)
    assert skip <= set(want) | set(got)  # every name it skips exists
    for name, text in want.items():
        if name not in skip:
            assert got.get(name) == text.replace("bbtools_tpu", "bbtools_torch"), name
    assert len(set(want) - skip) >= 2


#: C sources the port copies byte for byte
COPIED_C_SOURCES = ["native/fastq_codec.c", "native/radix_count.c"]


@pytest.mark.parametrize("rel", COPIED_C_SOURCES)
def test_copied_c_source_has_not_drifted(rel):
    with open(os.path.join(REPO, "bbtools_tpu", rel), "rb") as fh:
        src = fh.read()
    with open(os.path.join(REPO, "bbtools_torch", rel), "rb") as fh:
        assert fh.read() == src


def test_native_build_reads_only_the_ports_sources(monkeypatch):
    """The port's native build compiles the C files of its own package,
    never the JAX package's."""
    from bbtools_torch import native

    calls = []
    monkeypatch.setattr(native.tempfile, "gettempdir", lambda: "/nonexistent-dir")

    def fake_run(cmd, **kw):
        calls.append(cmd)
        raise OSError("no compiler in this test")

    monkeypatch.setattr(native.subprocess, "run", fake_run)
    assert native._build() is None
    srcs = [a for a in calls[0] if a.endswith(".c")]
    port_dir = os.path.join(REPO, "bbtools_torch", "native")
    assert sorted(os.path.basename(s) for s in srcs) == sorted(native.SOURCES)
    assert all(os.path.samefile(os.path.dirname(s), port_dir) for s in srcs)


#: host functions the port copies into modules that also hold torch code
COPIED_FUNCTIONS = [
    ("ops.kmers", "rolling_kmers_np"), ("ops.kmers", "rc_kmer_np"),
    ("ops.kmers", "canonical_keys_np"), ("ops.kmers", "middle_mask"),
    ("ops.kmers", "mid_mask_len_default"), ("ops.kmers", "_last_undef_np"),
    ("ops.kmer_index", "build_ref_keys"),
    ("ops.kmer_index", "expand_kmers_edist"), ("ops.kmer_index", "_edist_children"),
    ("ops.kmer_index", "scaffold_kmer_stream"), ("ops.kmer_index", "_mix64"),
    ("ops.kmer_index", "_mutant_stream_hdist1"),
    ("ops.kmer_index", "BucketKmerIndex.build"),
    ("ops.kmer_index", "BucketKmerIndex.lookup_np"),
    ("ops.lane_index", "_hash32_np"), ("ops.lane_index", "LaneKmerIndex.build"),
    ("ops.lane_index", "LaneKmerIndex.lookup_np"),
    ("ops.sort_join", "SortJoinIndex.lookup_np"),
    ("ops.trim", "optimal_trim_np"), ("ops.trim", "apply_trim"),
    ("models.bbduk", "load_reference"), ("models.bbduk", "BBDuk._ktrim_stage"),
    ("models.bbduk", "BBDuk._poly_stage"), ("models.bbduk", "BBDuk._force_trim"),
    ("models.bbduk", "BBDuk._low_entropy_windows"),
    ("models.bbduk", "BBDuk.write_stats_file"),
    ("models.bbduk", "_count_big_kmer_hits"), ("models.bbduk", "_detect_poly_scan"),
    ("models.bbduk", "_avg_quality_by_prob"), ("models.bbduk", "_has_min_consecutive"),
    ("ops.lane_table", "pack_table"),
    ("ops.overlap", "_incr_table"), ("ops.overlap", "incr_table"),
    ("ops.overlap", "right_justify_np"), ("ops.overlap", "overlap_counts_quality_np"),
    ("ops.overlap", "find_best_ratio_np"), ("ops.overlap", "mate_by_overlap_ratio_np"),
    ("ops.overlap", "expected_mismatches_np"), ("ops.overlap", "probability_np"),
    ("ops.overlap", "calc_min_overlap_by_entropy_np"),
    ("ops.overlap", "expected_tip_errors_np"), ("ops.overlap", "bbmerge_nn_features"),
    ("ops.mm_match", "_field_onehot_np"), ("ops.mm_match", "_canonical_realizable_np"),
    ("ops.mm_match", "_masked_safety"), ("ops.mm_match", "MMKmerIndex.build"),
    ("ops.mm_match", "MMKmerIndex.lookup_np"), ("ops.mm_match", "_query_onehot_np"),
    ("models.bbmerge", "Preset"), ("models.bbmerge", "BBMerge.process_batch"),
    ("models.bbmerge", "BBMerge.write_ihist"), ("models.bbmerge", "BBMerge.print_stats"),
    ("models.bbmerge", "_rc_batch"), ("models.bbmerge", "_rev_quals"),
    ("models.bbmerge", "BBMerge._extend_rows"), ("models.bbmerge", "BBMerge._apply_ecco"),
    ("ops.msa", "col0_scores"), ("ops.msa", "match_strings_np"),
    ("ops.msa", "prepare_limits_np"),
    ("ops.score_ungapped", "score_no_indels_np"),
    ("models.bbmap", "max_quality"), ("models.bbmap", "MapResult"),
    ("models.bbmap", "BBMap.seed_offsets"), ("models.bbmap", "BBMap._seed_slots"),
    ("models.bbmap", "BBMap.candidates_for_batch"), ("models.bbmap", "BBMap._build_tasks"),
    ("models.bbmap", "BBMap._finalize_batch"), ("models.bbmap", "BBMap._stitch_gapped"),
    ("models.bbmap", "BBMap._tally_match"), ("models.bbmap", "BBMap._write_hists"),
    ("models.bbmap", "BBMap._padded_ref"), ("models.bbmap", "BBMap._ref_windows"),
    ("models.bbmap", "BBMap._read_batches"), ("models.bbmap", "BBMap._mark_blacklisted"),
    ("models.bbmap", "BBMap._scafstats_add"), ("models.bbmap", "BBMap._write_scafstats"),
    ("models.bbmap", "BBMap._load_or_build_index"),
    ("models.bbmap", "BBMap.pair_site_scores"), ("models.bbmap", "BBMap.to_sam_paired"),
    ("models.bbmap", "BBMap.to_sam"), ("models.bbmap", "BBMap.print_stats"),
    ("models.bbmap", "score_match_bytes"), ("models.bbmap", "to_local_match"),
    ("models.bbmap", "dels_to_introns"), ("models.bbmap", "_reflen"),
    ("models.bbmap", "_nm"), ("models.bbmap", "min_score_for"),
    ("models.bbmap", "clearzone_for"), ("models.bbmap", "_cz3_fraction"),
    ("models.bbmap", "apply_clearzone3"), ("models.bbmap", "tip_score_penalty"),
    ("models.bbmap", "load_ref"), ("models.bbmap", "main"),
    ("models.bbmap", "pacbio_preset"), ("models.bbmap", "skimmer_preset"),
    ("models.bbmap", "BBMap.run"), ("models.bbmap", "BBMap._want_coverage"),
    ("models.bbmap", "BBMap._cov_init"), ("models.bbmap", "BBMap._coverage_add"),
    ("models.bbmap", "BBMap._write_coverage"),
    ("cli", "_remove_preset"), ("cli", "_bbwrap"), ("cli", "guard_output_files"),
    ("cli", "_lazy"), ("models.research", "regressiontrainer_main"),
    ("models.polyfilter", "_max_pure_run"),
    ("parallel.sharded_index", "ShardedKmerIndex.build"),
    ("parallel.sharded_count", "shard_seed_index"),
    ("models.rqcfilter", "_count_fq"),
    ("cli", "_sketch"), ("cli", "_quickclade"), ("cli", "_gradevcf"),
    ("cli", "_grademerged"), ("cli", "_server"), ("cli", "_taxonomy"),
    ("cli", "_filterbytaxa"), ("cli", "_randomreads"), ("cli", "_consensus"),
    ("cli", "_lilypad"), ("cli", "_quickbin"), ("cli", "_callgenes"),
    ("cli", "_crosscontaminate"), ("cli", "_makecontaminated"), ("cli", "_splitsam_n"),
    # the last host pieces: k-mer helpers, the sorted and hash indexes'
    # builders and host lookups, 2-bit packing, the phase timer
    ("ops.kmers", "kmer_mask"), ("ops.kmers", "rc_kmer"),
    ("ops.kmer_index", "SortedKmerIndex.lookup_np"), ("ops.kmer_index", "HashKmerIndex.build"),
    ("ops.kmer_index", "HashKmerIndex._build_at"), ("ops.kmer_index", "HashKmerIndex.lookup_np"),
    ("ops.encode", "pack_bases_np"), ("utils.timer", "PhaseTimer"),
]


def _source(pkg, mod, qualname):
    obj = importlib.import_module(f"{pkg}.{mod}")
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return inspect.getsource(obj).replace(pkg, "PKG")


@pytest.mark.parametrize("mod,qualname", COPIED_FUNCTIONS)
def test_copied_function_has_not_drifted(mod, qualname):
    assert _source("bbtools_torch", mod, qualname) == _source("bbtools_tpu", mod, qualname)


#: functions the port copies but for its device flag and its device
#: calls: the JAX package's lines it leaves out. Every other line of the
#: JAX package's function is in the port's, in the same order.
EDITED_FUNCTIONS = {
    ("models.findprimers", "main"): [
        "        off, mm = best_sites(b.bases, b.lengths, q, ql)"],
    ("models.indelfree", "main"): [
        "            mism = _device_search(queries, qlens, chunk, max_subs)",
        "            hits = np.argwhere(mism <= allowed[:, None])",
        "            for qi, off in hits:",
        "                nm = int(mism[qi, off])"],
    ("models.misctools", "kmercoverage"): [
        "    from ..ops.kmers import canonical_keys_np, rolling_kmers_np",
        "    def read_keys(batch):",
        "        fwd, rkm, runlen = rolling_kmers_np(batch.bases, k)",
        "        keys = canonical_keys_np(fwd, rkm, k)",
        "        valid = (runlen >= k) & (",
        "            np.arange(batch.padded_len)[None, :] < batch.lengths[:, None]",
        "        )", "        return keys, valid", "",
        '    cms = CountMinSketch(hashes=a.get_int("hashes", default=2))',
        "            keys, valid = read_keys(b)", "            flat = keys[valid]",
        "                kk = keys[i][valid[i]]", "                if len(kk):",
        "                    depths = cms.query(kk)"],
    ("models.texttools", "bloomfilter"): [
        "    from ..ops.kmers import rolling_kmers_np", "    cms = CountMinSketch()",
        "        fwd, rkm, runlen = rolling_kmers_np(codes[None, :], k)",
        "        ok = runlen[0] >= k", "        cms.add(np.maximum(fwd[0][ok], rkm[0][ok]))",
        "        fwd, rkm, runlen = rolling_kmers_np(b.bases, k)",
        "        i_idx = np.arange(b.bases.shape[1])[None, :]",
        "        ok = (runlen >= k) & (i_idx < b.lengths[:, None])",
        "        keys = np.maximum(fwd, rkm)", "        flat_ok = ok.reshape(-1)",
        "        if flat_ok.any():", "            counts = np.zeros(ok.size, np.int64)",
        "            counts[flat_ok] = cms.query(keys.reshape(-1)[flat_ok])",
        "            hits = (counts.reshape(ok.shape) > 0).sum(axis=1)"],
    ("models.polyfilter", "main"): [
        '        cms = CountMinSketch(hashes=a.get_int("hashes", default=2))',
        "                for keys in _read_keys(b, k):",
        "                    if len(keys):",
        "                        cms.add(keys)",
        "            ldfrac = np.zeros(n)",
        "            for i, keys in enumerate(_read_keys(batch, k)):",
        "                if len(keys):",
        "                    counts = cms.query(keys)",
        "                    ldfrac[i] = float((counts < mincount).mean())",
        "        else:"],
    ("models.research", "calibrate_main"): [
        '    rows by gradient descent (jax)."""', "    import jax",
        "    import jax.numpy as jnp", "", "    xl = jnp.log(x / (1 - x))  # logit",
        "    yj = jnp.asarray(y)", "    def model(p):",
        '        s = jax.nn.sigmoid(p["a"] * xl + p["b"])',
        '        return p["K"] * s ** jnp.exp(p["logc"])', "    def loss(p):",
        "        return jnp.mean((model(p) - yj) ** 2)",
        '    p = {"a": jnp.float32(1.0), "b": jnp.float32(0.0),',
        '         "K": jnp.float32(1.0), "logc": jnp.float32(0.0)}',
        "    g = jax.jit(jax.grad(loss))", "    lossj = jax.jit(loss)",
        "    for _ in range(epochs):", "        grads = g(p)",
        "        p = {k_: v - lr * grads[k_] for k_, v in p.items()}",
        "    mse = float(lossj(p))"],
    ("models.mltools", "train_main"): [
        '    """train.sh -> ml.Trainer (jax gradient training on device)."""'],
    ("models.mltools", "scoresequence_main"): [],
    ("models.mltools", "netfilter_main"): [],
    # rqcfilter and decontaminate give every stage's tool their device=,
    # and rqcfilter reads the JAX package's resources by path
    ("models.rqcfilter", "main"): [
        "", "        bbduk_main(full + args)", "        clumpify_main(args)",
        "        reformat_main(args)", "            import PKG as _pkg",
        '                os.path.dirname(_pkg.__file__), "resources",',
        "        import PKG as _pkg",
        '        res_dir = os.path.join(os.path.dirname(_pkg.__file__), "resources")',
        "        import PKG", '                os.path.dirname(PKG.__file__), "resources"',
        '                       "overwrite=t"])',
        '        bbmerge_main([f"in={cur}", f"in2={cur2}", f"ihist={ih}"])',
        '        kce_run([f"in={final1}", f"khist={kh}", "k=31"])'],
    ("models.decontaminate", "main"): [
        '            f"ambig={ambig}", "ow=t",', '            f"k={tadpole_k}",'],
    ("models.filterbytile", "FBTConfig"): [],
    ("models.filterbytile", "parse_args"): [],
    ("models.filterbytile", "FilterByTile.analyze"): [
        "        for b in FastqReader(cfg.in1):"],
    ("models.filterbytile", "FilterByTile.filter"): [
        "        for b in FastqReader(cfg.in1):", "            if w:",
        "        for x in (w, wb):"],
    # C7: FASTA input is dealt as FASTA records, FASTQ as before
    ("models.smalltools", "partition"): ["    for b in FastqReader(in1):"],
    ("models.sketch", "load_blacklist"): [
        "        here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))"],
    ("models.synthtools", "kmerlimit"): ["    ll = LogLog(k=k)"],
    ("models.texttools", "kmercountmulti"): ["    lls = {k: LogLog(k=k) for k in ks}"],
    ("models.ssutools", "comparessu_main"): [
        "                                  [seqs[ri] for ri in keep])[0]"],
    ("models.ssutools", "findssu_main"): [
        "        ident = _batch_identities([q], [s for _, s in panel])[0]"],
    ("models.fileutils", "javasetup_main"): [
        '    (python/numpy/jax versions and visible devices)."""', "    try:",
        "        import jax", "", '        print(f"jax\\t{jax.__version__}")',
        '        print("devices\\t" + ",".join(str(d) for d in jax.devices()))',
        "    except Exception as e:  # noqa: BLE001 - report instead of crash",
        '        print(f"jax\\tunavailable ({e})")'],
    # A8b group 4: LogLog, BBMap and Tadpole on the run's device
    ("models.research", "cardinality_sim_main"): [
        '    """Accuracy-vs-cardinality sweep of the production HLL estimator."""',
        "            ll = LogLog(buckets=buckets)"],
    ("models.research", "postfilter_main"): [
        '    contigs by coverage (two-phase; Postfilter.java:1-12)."""',
        '                    "maxindel=0", "minid=0.9"])'],
    ("models.research", "reassemble_main"): [
        '    concatenate, preserving labels (Reassemble.java:1-10)."""',
        '            tadpole_main([f"in={p}", f"out={sub}", f"k={k}"])'],
    ("models.pgm", "parse_pgm"): [
        "            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),",
        '            "resources", "model.pgm",'],
}


@pytest.mark.parametrize("mod,qualname", list(EDITED_FUNCTIONS))
def test_edited_function_keeps_the_jax_lines(mod, qualname):
    left_out = EDITED_FUNCTIONS[(mod, qualname)]
    want = _source("bbtools_tpu", mod, qualname).splitlines()
    got = iter(_source("bbtools_torch", mod, qualname).splitlines())
    assert set(left_out) <= set(want)
    missing = [line for line in want if line not in left_out and line not in got]
    assert not missing, missing


def test_cuda_request_without_cuda_raises():
    from bbtools_torch.device import resolve_device
    from bbtools_torch.models.bbduk import BBDuk, parse_args

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        BBDuk(parse_args(["literal=ACGTACGTACGTACGTACGTACGTA", "k=23"]))
    from bbtools_torch.models import bbmap

    with pytest.raises(RuntimeError, match="cuda"):
        bbmap.BBMap(bbmap.parse_args(["ref=ref.fa", "in=r.fq", "device=cuda"]))
    assert resolve_device("cpu") == torch.device("cpu")


def test_wrappers_run_no_plain_version_off_the_cpu():
    """A tensor that is not on the CPU never reaches the plain version."""
    from bbtools_torch.ops import lane_table
    from bbtools_torch.ops.lane_index import lane_lookup
    from bbtools_torch.ops.mm_match import mm_best, mm_lookup
    from bbtools_torch.ops.msa_fill import msa_fill
    from bbtools_torch.ops.overlap_scan import overlap_counts
    from bbtools_torch.ops.scan import cummax_i64

    meta = torch.device("meta")
    q = torch.zeros(16, dtype=torch.int64, device=meta)
    t = torch.zeros((8, 128), dtype=torch.int32, device=meta)
    codes = torch.zeros((4, 30), dtype=torch.uint8, device=meta)
    lens = torch.zeros(4, dtype=torch.int32, device=meta)
    key_words = torch.zeros((512, 32), dtype=torch.int32, device=meta)
    prio = torch.zeros((1, 512), dtype=torch.int32, device=meta)
    calls = [
        lambda: lane_lookup(t, t, t, 128, 1, 1, 8, 0, True, q),
        lambda: cummax_i64(q),
        lambda: lane_table.lookup(t.float(), q.int()),
        lambda: overlap_counts(codes, codes, lens, lens, 5, 50),
        lambda: mm_lookup(key_words, prio, 23, 11, 128, 512, q),
        lambda: mm_best(key_words, prio, 23, 11, 128, 512, q),
        lambda: msa_fill(codes, lens, codes),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="device"):
            call()
    assert lane_lookup.launches == 0 and cummax_i64.launches == 0
    assert lane_table.lookup.launches == 0 and overlap_counts.launches == 0
    assert mm_lookup.launches == 0 and msa_fill.launches == 0
    assert mm_best.launches == 0


def test_kernel_build_without_nvcc_raises(tmp_path, monkeypatch):
    from bbtools_torch.kernels import build

    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(build, "_LIB", None)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(RuntimeError, match="nvcc"):
        build.library()
    assert build.sources() and all(s.endswith(".cu") for s in build.sources())


@pytest.mark.parametrize("tool,flag,item", [
    ("bbduk", "profile=trace", "A9"),
])
def test_unported_flags_raise(tmp_path, monkeypatch, tool, flag, item):
    """The flags that raised NotImplementedError naming their ROADMAP item
    until that item was ported now run (profile= writes its trace), and
    no NotImplementedError of the port names a ROADMAP item any more."""
    from bbtools_torch.cli import main

    monkeypatch.chdir(tmp_path)
    fq = tmp_path / "in.fq"
    fq.write_text("@r\nACGT\n+\nIIII\n")
    main([tool, f"in={fq}", "literal=ACGTACGTACGTACGTACGTACGTA", "k=23",
          "device=cpu", *([flag] if flag else [])])
    assert os.listdir(tmp_path / flag.split("=")[1])
    for root, _, files in os.walk(os.path.join(REPO, "bbtools_torch")):
        for f in files:
            if f.endswith(".py"):
                for node in ast.walk(ast.parse(open(os.path.join(root, f)).read())):
                    if isinstance(node, ast.Raise) and "NotImplementedError" in ast.unparse(
                            node):
                        assert f"ROADMAP {item}" not in ast.unparse(node), (f, node.lineno)
                        assert not re.search(r"ROADMAP [A-Z]\d", ast.unparse(node)), f


@pytest.mark.parametrize("tool,flag", [
    ("bbduk", "tpshards=2"), ("bbmerge", "tpshards=2"), ("bbmap", "tpshards=2"),
    ("kmercountexact", "shards=2"), ("kmercount", "tpshards=4"),
    ("khist", "shards=2"), ("tadpole", "shards=2"),
])
def test_shard_flags_run(tmp_path, tool, flag):
    """The multi-device flags that raised until the A7 port now run, on a
    mesh of CPU copies."""
    from bbtools_torch.cli import main

    fq = tmp_path / "in.fq"
    fq.write_text("@r\n" + "ACGTTGCAAG" * 6 + "\n+\n" + "I" * 60 + "\n")
    ref = tmp_path / "ref.fa"
    ref.write_text(">s\n" + "ACGTTGCAAGCTTCGA" * 40 + "\n")
    argv = {"bbduk": [f"in={fq}", "literal=ACGTACGTACGTACGTACGTACGTA", "k=23",
                      f"out={tmp_path}/o.fq"],
            "bbmerge": [f"in1={fq}", f"in2={fq}", f"out={tmp_path}/o.fq"],
            "bbmap": [f"ref={ref}", f"in={fq}", f"out={tmp_path}/o.sam", "nodisk"]}
    main([tool, *argv.get(tool, [f"in={fq}", "k=23"]), flag, "device=cpu"])


def test_native_codec_builds_under_concurrent_processes(tmp_path):
    """Three processes build the native codec into one fresh TMPDIR at
    the same moment; every one of them loads the library."""
    code = (
        "from bbtools_torch.native import get_lib\n"
        "import sys\n"
        "sys.exit(0 if get_lib() is not None else 3)\n"
    )
    env = dict(os.environ, TMPDIR=str(tmp_path))
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for _ in range(3)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0, 0], outs
    assert len(list(tmp_path.glob("bbtools_torch_native_*.so"))) == 1
    assert not list(tmp_path.glob("*.tmp"))


def test_unknown_tool_raises():
    """A name that neither package registers raises (the JAX package
    prints "Unknown tool:" and returns 2); nothing runs in its place."""
    from bbtools_torch.cli import TOOLS, main
    from bbtools_tpu.cli import TOOLS as JAX_TOOLS

    for tool in ("bbdukx", "mapreads", "notatool", "quickbin2", "vcf2bed"):
        assert tool not in TOOLS and tool not in JAX_TOOLS
        with pytest.raises(NotImplementedError, match=re.escape(f"unknown tool {tool!r}")):
            main([tool, "in=x.fq"])
    assert main(["help"]) == 0


def test_new_tools_default_to_cuda(tmp_path):
    """kmercountexact, Tadpole and CallVariants run on the card unless
    asked for the CPU: without one, the default raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from bbtools_torch.cli import main
    from bbtools_torch.io.fasta import load_reference, write_fasta
    from bbtools_torch.ml.cellnet import CellNet
    from bbtools_torch.models.callvariants import CallVariants

    fq = tmp_path / "in.fq"
    fq.write_text("@r\n" + "ACGT" * 10 + "\n+\n" + "I" * 40 + "\n")
    write_fasta(str(tmp_path / "ref.fa"), [(b"s", b"ACGT" * 50)])
    for argv in (["kmercountexact", f"in={fq}"], ["kmercountexact", f"in={fq}", "k=45"],
                 ["tadpole", f"in={fq}"], ["tadpole", f"in={fq}", "k=62"],
                 ["callvariants", f"in={fq}", f"ref={tmp_path / 'ref.fa'}"]):
        with pytest.raises(RuntimeError, match="cuda"):
            main(argv)
    with pytest.raises(RuntimeError, match="cuda"):
        CallVariants(load_reference(str(tmp_path / "ref.fa")))
    with pytest.raises(RuntimeError, match="cuda"):
        CellNet.create([4, 1]).apply(np.zeros((1, 4), np.float32))


#: the tools of ROADMAP A6b and the argv that reaches their first device
#: work; stats/assemblystats have none (host FASTA statistics)
A6B_TOOLS = {
    "tadpipe": ["in={fq}", "in2={fq}", "out={tmp}/asm.fa", "tmpdir={tmp}/t"],
    "tadwrapper": ["in={fq}", "out={tmp}/c_%.fa", "k=31"],
    "tadpolewrapper": ["in={fq}", "out={tmp}/c_%.fa", "k=31"],
    "bbcms": ["in={fq}", "out={tmp}/o.fq"],
    "bbrealign": ["in={tmp}/in.sam", "ref={tmp}/ref.fa", "out={tmp}/o.sam"],
    "stats": ["in={tmp}/ref.fa"],
    "assemblystats": ["in={tmp}/ref.fa"],
}


@pytest.mark.parametrize("tool", list(A6B_TOOLS))
def test_a6b_tools_default_to_cuda(tmp_path, tool):
    """The A6b tools run on the card unless asked for the CPU: without
    one, the default raises before any output is written. stats and
    assemblystats do no device work and run anywhere."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    import contextlib
    import io

    from bbtools_torch.cli import main

    fq = tmp_path / "in.fq"
    fq.write_text("@r\n" + "ACGT" * 10 + "\n+\n" + "I" * 40 + "\n")
    (tmp_path / "ref.fa").write_text(">s\n" + "ACGT" * 50 + "\n")
    (tmp_path / "in.sam").write_text("@SQ\tSN:s\tLN:200\n")
    argv = [a.format(fq=fq, tmp=tmp_path) for a in A6B_TOOLS[tool]]
    if tool in ("stats", "assemblystats"):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert main([tool, *argv]) == 0
        assert "Main genome scaffold total:         \t1" in out.getvalue()
        return
    with pytest.raises(RuntimeError, match="cuda"):
        main([tool, *argv])
    assert not [p for p in tmp_path.rglob("*") if p.name.startswith(("o.", "asm", "c_"))]


@pytest.mark.parametrize("flag", ["ecco=t", "extend2=20", "ecct=t", "nn=t"])
def test_bbmerge_flags_default_to_cuda(tmp_path, flag):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from bbtools_torch.cli import main

    fq = tmp_path / "in.fq"
    fq.write_text("@r\n" + "ACGT" * 10 + "\n+\n" + "I" * 40 + "\n")
    with pytest.raises(RuntimeError, match="cuda"):
        main(["bbmerge", f"in1={fq}", f"in2={fq}", flag])


def test_bbmap_bloomfilter_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from bbtools_torch.cli import main
    from bbtools_torch.ops.cms import CountMinSketch

    (tmp_path / "ref.fa").write_text(">s\n" + "ACGT" * 50 + "\n")
    with pytest.raises(RuntimeError, match="cuda"):
        main(["bbmap", f"ref={tmp_path / 'ref.fa'}", f"in={tmp_path / 'ref.fa'}",
              "bloomfilter=t"])
    with pytest.raises(RuntimeError, match="cuda"):
        CountMinSketch(1 << 10)


#: the flags and tools of ROADMAP A2/A5 and A4b, and the argv that reaches
#: their first device work; pileup, calctruequality and gradesam have none
#: (host numpy over a SAM)
A2_A4B_PATHS = {
    "bbduk_recalibrate": ["bbduk", "in={fq}", "out={tmp}/o.fq", "recalibrate=t",
                          "path={tmp}"],
    "bbduk_align": ["bbduk", "in={fq}", "out={tmp}/o.fq", "align=t",
                    "alignout={tmp}/o.sam"],
    "bbmap_covstats": ["bbmap", "ref={tmp}/ref.fa", "in={fq}", "covstats={tmp}/o.txt"],
    "bbmap_basecov": ["bbmap", "ref={tmp}/ref.fa", "in={fq}", "basecov={tmp}/o.txt"],
    "bbmap_covhist": ["bbmap", "ref={tmp}/ref.fa", "in={fq}", "covhist={tmp}/o.txt"],
    "bbmap_bincov": ["bbmap", "ref={tmp}/ref.fa", "in={fq}", "bincov={tmp}/o.txt"],
    "mappacbio": ["mappacbio", "ref={tmp}/ref.fa", "in={fq}", "out={tmp}/o.sam"],
    "bbmapskimmer": ["bbmapskimmer", "ref={tmp}/ref.fa", "in={fq}", "out={tmp}/o.sam"],
    "mappacbioskimmer": ["mappacbioskimmer", "ref={tmp}/ref.fa", "in={fq}",
                         "out={tmp}/o.sam"],
    "bbsplit": ["bbsplit", "ref={tmp}/ref.fa", "in={fq}", "basename={tmp}/o_%.fq"],
    "bbwrap": ["bbwrap", "ref={tmp}/ref.fa", "in={fq},{fq}", "out={tmp}/o.sam,{tmp}/o2.sam"],
    "removehuman": ["removehuman", "ref={tmp}/ref.fa", "in={fq}", "outu={tmp}/o.fq"],
    "removehuman2": ["removehuman2", "ref={tmp}/ref.fa", "in={fq}", "outu={tmp}/o.fq"],
    "removemicrobes": ["removemicrobes", "ref={tmp}/ref.fa", "in={fq}", "outu={tmp}/o.fq"],
    "removecatdogmousehuman": ["removecatdogmousehuman", "ref={tmp}/ref.fa", "in={fq}",
                               "outu={tmp}/o.fq"],
    "pileup": ["pileup", "in={tmp}/in.sam", "ref={tmp}/ref.fa", "out={tmp}/o.txt"],
    "coveragepileup": ["coveragepileup", "in={tmp}/in.sam", "ref={tmp}/ref.fa",
                       "out={tmp}/o.txt"],
    "pileup2": ["pileup2", "in={tmp}/in.sam", "ref={tmp}/ref.fa", "out={tmp}/o.txt"],
    "calctruequality": ["calctruequality", "in={tmp}/in.sam", "path={tmp}"],
    "gradesam": ["gradesam", "in={tmp}/in.sam", "ref={tmp}/ref.fa"],
}
HOST_ONLY = ("pileup", "coveragepileup", "pileup2", "calctruequality", "gradesam")


@pytest.mark.parametrize("case", list(A2_A4B_PATHS))
def test_a2_a4b_paths_default_to_cuda(tmp_path, case):
    """The flags and tools of this part of the port run on the card unless
    asked for the CPU: without one, the default raises before any output
    is written. The host-only tools run anywhere."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    import contextlib
    import io

    from bbtools_torch.cli import main

    fq = tmp_path / "in.fq"
    fq.write_text("@r\n" + "ACGT" * 10 + "\n+\n" + "I" * 40 + "\n")
    (tmp_path / "ref.fa").write_text(">s\n" + "ACGT" * 50 + "\n")
    (tmp_path / "in.sam").write_text(
        "@SQ\tSN:s\tLN:200\nr_scaf0_pos0_strand0\t0\ts\t1\t40\t40=\t*\t0\t0\t"
        + "ACGT" * 10 + "\t" + "I" * 40 + "\n")
    argv = [a.format(fq=fq, tmp=tmp_path) for a in A2_A4B_PATHS[case]]
    if case in HOST_ONLY:
        with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
            assert main(argv) == 0
        assert list(tmp_path.glob("o.txt")) or case in ("calctruequality", "gradesam")
        return
    with pytest.raises(RuntimeError, match="cuda"):
        main(argv)
    assert not [p for p in tmp_path.rglob("o*")]


#: the tools of ROADMAP A8a ported so far and the argv that reaches their
#: first device work
A8A_TOOLS = {
    "seal": ["in={fq}", "ref={tmp}/ref.fa", "stats={tmp}/o.txt"],
    "loglog": ["in={fq}"],
    "bbnorm": ["in={fq}", "out={tmp}/o.fq"],
    "ecc": ["in={fq}", "out={tmp}/o.fq"],
    "dedupe": ["in={fq}", "out={tmp}/o.fq"],
    "dedupe2": ["in={fq}", "out={tmp}/o.fq", "e=2"],
    "clumpify": ["in={fq}", "out={tmp}/o.fq"],
}


@pytest.mark.parametrize("tool", list(A8A_TOOLS))
def test_a8a_tools_default_to_cuda(tmp_path, tool):
    """seal, loglog, bbnorm, ecc, dedupe and clumpify run on the card
    unless asked for the CPU: without one, the default raises before any
    output is written."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from bbtools_torch.cli import main

    fq = tmp_path / "in.fq"
    fq.write_text("@r\n" + "ACGT" * 10 + "\n+\n" + "I" * 40 + "\n")
    (tmp_path / "ref.fa").write_text(">s\n" + "ACGT" * 50 + "\n")
    argv = [a.format(fq=fq, tmp=tmp_path) for a in A8A_TOOLS[tool]]
    with pytest.raises(RuntimeError, match="cuda"):
        main([tool, *argv])
    assert not list(tmp_path.glob("o.*"))


#: the tools of ROADMAP A8a items 1-3 and the argv that reaches their
#: first device work; reformatpb and the host aligner launchers have none
A8A_L5_TOOLS = {
    "reformat": ["in={fq}", "out={tmp}/o.fq", "qtrim=rl"],
    "reformat2": ["in={fq}", "out={tmp}/o.fq"],
    "reformat3": ["in={fq}", "out={tmp}/o.fq"],
    "alltoall": ["in={tmp}/ref.fa", "out={tmp}/o.txt"],
    "idmatrix": ["in={tmp}/ref.fa", "out={tmp}/o.txt"],
    "splitribo": ["in={tmp}/ref.fa", "out={tmp}/o_#.fa"],
    "mergeribo": ["in={tmp}/ref.fa", "out={tmp}/o.fa"],
    "keepbestcopy": ["in={tmp}/ref.fa", "out={tmp}/o.fa"],
    "icecream": ["in={fq}", "outg={tmp}/o.fq"],
    "icecreamfinder": ["in={fq}", "outg={tmp}/o.fq", "kzt=t"],
    "testalignersbatch": ["length=100", "samples=2"],
    "testalignerslength": ["lengths=100", "samples=2"],
    "alignrandom": ["out={tmp}/o.txt"],
    "microalign": ["in={fq}", "ref=phix", "out={tmp}/o.sam"],
    "reformatpb": ["in={fq}", "out={tmp}/o.fq"],
    "glocalaligner": ["ACGTTACG", "ACGTACG"],
    "testaligners": ["ACGTTACG", "ACGTACG"],
    "testaligners2": [],
    "visualizealignment": ["ACGTTACG", "ACGTACG", "out={tmp}/o.txt"],
}
A8A_L5_HOST = ("reformatpb", "glocalaligner", "testaligners", "testaligners2",
               "visualizealignment")


@pytest.mark.parametrize("tool", list(A8A_L5_TOOLS))
def test_a8a_l5_tools_default_to_cuda(tmp_path, tool):
    """reformat, alltoall/idmatrix, the ribo tools, icecream and the
    device aligner harnesses run on the card unless asked for the CPU:
    without one, the default raises before any output is written. The
    host-only names run anywhere."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    import contextlib
    import io

    from bbtools_torch.cli import main

    fq = tmp_path / "in.fq"
    fq.write_text("@m/1/0_40\n" + "ACGT" * 10 + "\n+\n" + "I" * 40 + "\n")
    (tmp_path / "ref.fa").write_text(">s\n" + "ACGT" * 50 + "\n>t\n" + "AGCT" * 40 + "\n")
    argv = [a.format(fq=fq, tmp=tmp_path) for a in A8A_L5_TOOLS[tool]]
    if tool in A8A_L5_HOST:
        with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
            assert main([tool, *argv]) == 0
        return
    with pytest.raises(RuntimeError, match="cuda"):
        main([tool, *argv])
    assert not list(tmp_path.glob("o*"))


#: the last device-using tools and the argv that reaches their first
#: device work; the vector tools have none
A8C_TOOLS = {
    "findprimers": ["in={fq}", "out={tmp}/o.sam", "literal=ACGTACGT"],
    "msa": ["in={fq}", "out={tmp}/o.sam", "ref={tmp}/ref.fa"],
    "indelfree": ["in={tmp}/ref.fa", "ref={tmp}/ref.fa", "out={tmp}/o.sam"],
    "indelfreealigner": ["in={fq}", "ref={tmp}/ref.fa", "out={tmp}/o.sam"],
    "kmercoverage": ["in={fq}", "out={tmp}/o.fq"],
    "bloomfilter": ["in={fq}", "ref={tmp}/ref.fa", "out={tmp}/o.fq"],
    "polyfilter": ["in={fq}", "out={tmp}/o.fq", "extra={fq}"],
    "train": ["data={tmp}/v.tsv", "out={tmp}/o.bbnet", "epochs=2"],
    "regressiontrainer": ["data={tmp}/v.tsv", "out={tmp}/o.bbnet", "epochs=2"],
    "scoresequence": ["in={fq}", "net={tmp}/n.bbnet", "out={tmp}/o.fq"],
    "netfilter": ["in={fq}", "net={tmp}/n.bbnet", "out={tmp}/o.fq"],
    "calibrate": ["in={tmp}/c.tsv", "out={tmp}/o.txt"],
    "seqtovec": ["in={fq}", "out={tmp}/o.tsv"],
    "netconvert": ["in={tmp}/n.bbnet", "out={tmp}/o.bbnet"],
    "reducecolumns": ["{tmp}/v.tsv", "{tmp}/o.tsv", "0", "2"],
    "vectorutils": ["in={tmp}/v.tsv", "out={tmp}/o.tsv"],
    "balancevectors": ["in={tmp}/v.tsv", "out={tmp}/o.tsv"],
}
A8C_HOST = ("seqtovec", "netconvert", "reducecolumns", "vectorutils", "balancevectors")


@pytest.mark.parametrize("tool", list(A8C_TOOLS))
def test_a8c_tools_default_to_cuda(tmp_path, tool):
    """findprimers/msa, indelfree, kmercoverage, bloomfilter, polyfilter,
    train, regressiontrainer, scoresequence, netfilter and calibrate run
    on the card unless asked for the CPU: without one, the default raises
    before any output is written. The vector tools run anywhere."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    import contextlib
    import io

    from bbtools_torch.cli import main
    from bbtools_torch.ml.cellnet import CellNet, save_bbnet

    fq = tmp_path / "in.fq"
    fq.write_text("@r\n" + "ACGT" * 10 + "\n+\n" + "I" * 40 + "\n")
    (tmp_path / "ref.fa").write_text(">s\n" + "ACGT" * 50 + "\n")
    (tmp_path / "v.tsv").write_text("#dims\t2\t1\n0.1\t0.2\t1\n0.3\t0.1\t0\n")
    (tmp_path / "c.tsv").write_text("0.2\t0\n0.8\t1\n")
    save_bbnet(CellNet.create([4, 2, 1]), str(tmp_path / "n.bbnet"))
    argv = [a.format(fq=fq, tmp=tmp_path) for a in A8C_TOOLS[tool]]
    if tool in A8C_HOST:
        with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
            assert main([tool, *argv]) == 0
        assert list(tmp_path.glob("o.*"))
        return
    with pytest.raises(RuntimeError, match="cuda"):
        main([tool, *argv])
    assert not list(tmp_path.glob("o.*"))


def test_cellnet_fit_defaults_to_cuda():
    """CellNet.fit trains on the net's device, cuda unless it says cpu."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from bbtools_torch.ml.cellnet import CellNet

    net = CellNet.create([4, 3, 1])
    with pytest.raises(RuntimeError, match="cuda"):
        net.fit(np.zeros((2, 4), np.float32), np.zeros((2, 1), np.float32), epochs=2)


#: the pipelines of ROADMAP A8b and the argv that reaches their first
#: device work
A8B_PIPELINES = {
    "rqcfilter": ["in={fq}", "path={tmp}/o"],
    "rqcfilter2": ["in={fq}", "path={tmp}/o", "removeribo=t"],
    "rqcfilter3": ["in={fq}", "path={tmp}/o", "ktrim=f"],
    "decontaminate": ["reads={fq}", "ref={tmp}/ref.fa", "out={tmp}/o"],
    "crossblock": ["reads={fq}", "ref={tmp}/ref.fa", "out={tmp}/o", "mapraw=f"],
}


@pytest.mark.parametrize("tool", list(A8B_PIPELINES))
def test_a8b_pipelines_default_to_cuda(tmp_path, tool):
    """rqcfilter and decontaminate run every device stage on the card
    unless asked for the CPU: without one, the default raises before the
    output directory is made."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from bbtools_torch.cli import main

    fq = tmp_path / "in.fq"
    fq.write_text("@r\n" + "ACGT" * 10 + "\n+\n" + "I" * 40 + "\n")
    (tmp_path / "ref.fa").write_text(">s\n" + "ACGT" * 50 + "\n")
    argv = [a.format(fq=fq, tmp=tmp_path) for a in A8B_PIPELINES[tool]]
    with pytest.raises(RuntimeError, match="cuda"):
        main([tool, *argv])
    assert not (tmp_path / "o").exists()


#: the tools of A8b's sketch, taxonomy and file-tool slice that do device
#: work, and the argv that reaches it
A8B_SLICE_DEVICE_TOOLS = {
    "kmerlimit": ["in={fq}", "out={tmp}/o.fq", "limit=100"],
    "kmerlimit2": ["in={fq}", "out={tmp}/o.fq", "limit=100"],
    "kmercountmulti": ["in={fq}", "out={tmp}/o.txt"],
    "comparessu": ["in={tmp}/ssu.fa", "out={tmp}/o.txt", "ata=t"],
    "findssu": ["in={tmp}/ssu.fa", "ref={tmp}/ssu.fa", "out={tmp}/o.txt"],
}


@pytest.mark.parametrize("tool", list(A8B_SLICE_DEVICE_TOOLS))
def test_a8b_slice_device_tools_default_to_cuda(tmp_path, tool):
    """kmerlimit/kmerlimit2 and kmercountmulti (LogLog) and comparessu/
    findssu (the glocal identity aligner) run on the card unless asked
    for the CPU: without one, the default raises before any output is
    written."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from bbtools_torch.cli import main

    fq = tmp_path / "in.fq"
    fq.write_text("@r\n" + "ACGTTGCAAG" * 6 + "\n+\n" + "I" * 60 + "\n")
    (tmp_path / "ssu.fa").write_text(">tid|1|a\n" + "ACGTTGCA" * 20 + "\n>tid|2|b\n"
                                     + "ACGTAGCA" * 20 + "\n")
    argv = [a.format(fq=fq, tmp=tmp_path) for a in A8B_SLICE_DEVICE_TOOLS[tool]]
    with pytest.raises(RuntimeError, match="cuda"):
        main([tool, *argv])
    assert not list(tmp_path.glob("o.*"))
