"""The sketch, taxonomy, clade and server tools of A8b on the CPU: each
launcher name of the port against the JAX package's on the same seeded
inputs, one case a name (sketch, bbsketch, comparesketch, sendsketch,
mergesketch, subsketch, summarizesketch; the 14 taxonomy names;
quickclade, clade, sendclade, cladeloader; server, taxserver,
sketchserver, cladeserver, ssuserver, demuxserver), then the library
cases of tests/test_sketch_interop.py and tests/test_taxonomy.py at a
small size. Every output file, the standard output and the standard
error are equal byte for byte, with these masks:

- a .npz file (taxonomy tree=, cladeloader out=) is compared array by
  array: its zip entries carry the time of writing;
- the server launchers print the port they listen on, which the system
  picks (port=0): `127.0.0.1:<port>` is masked. Each server answers the
  same requests on 127.0.0.1, and the replies (status, content type,
  body) are equal byte for byte.

The tools are host code copied from the JAX package; load_blacklist
reads the JAX package's bundled blacklists by path (blacklist=silva)."""

import json
import os
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

from bbtools_tpu.models.sketch import sketch_file, sketch_file_v2, write_sketch_v2
from bbtools_tpu.models.taxonomy import TaxTree
from torch_parity import run_host_both, warm_native_codecs  # noqa: F401  (autouse)

RES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "bbtools_tpu", "resources")
ACGT = np.frombuffer(b"ACGT", np.uint8)

NODES = """1\t|\t1\t|\tno rank\t|
2\t|\t131567\t|\tsuperkingdom\t|
2157\t|\t131567\t|\tsuperkingdom\t|
2759\t|\t131567\t|\tsuperkingdom\t|
131567\t|\t1\t|\tcellular root\t|
1224\t|\t2\t|\tphylum\t|
1236\t|\t1224\t|\tclass\t|
91347\t|\t1236\t|\torder\t|
543\t|\t91347\t|\tfamily\t|
561\t|\t543\t|\tgenus\t|
562\t|\t561\t|\tspecies\t|
83333\t|\t562\t|\tstrain\t|
620\t|\t543\t|\tgenus\t|
623\t|\t620\t|\tspecies\t|
9606\t|\t2759\t|\tspecies\t|
"""
NAMES = """1\t|\troot\t|\t\t|\tscientific name\t|
2\t|\tBacteria\t|\t\t|\tscientific name\t|
2157\t|\tArchaea\t|\t\t|\tscientific name\t|
2759\t|\tEukaryota\t|\t\t|\tscientific name\t|
131567\t|\tcellular organisms\t|\t\t|\tscientific name\t|
1224\t|\tProteobacteria\t|\t\t|\tscientific name\t|
1236\t|\tGammaproteobacteria\t|\t\t|\tscientific name\t|
91347\t|\tEnterobacterales\t|\t\t|\tscientific name\t|
543\t|\tEnterobacteriaceae\t|\t\t|\tscientific name\t|
561\t|\tEscherichia\t|\t\t|\tscientific name\t|
562\t|\tEscherichia coli\t|\t\t|\tscientific name\t|
83333\t|\tEscherichia coli K-12\t|\t\t|\tscientific name\t|
620\t|\tShigella\t|\t\t|\tscientific name\t|
623\t|\tShigella flexneri\t|\t\t|\tscientific name\t|
9606\t|\tHomo sapiens\t|\t\t|\tscientific name\t|
"""


def _seq(rng, n, p=None):
    return ACGT[rng.choice(4, n, p=p)].tobytes()


def _mutated(rng, s, rate):
    b = bytearray(s)
    for j in np.nonzero(rng.random(len(b)) < rate)[0]:
        b[j] = ACGT[(b"ACGT".index(b[j]) + int(rng.integers(1, 4))) % 4]
    return bytes(b)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The inputs every case reads, made once from seed 16."""
    d = tmp_path_factory.mktemp("sketchtax_in")
    rng = np.random.default_rng(16)
    (d / "nodes.dmp").write_text(NODES)
    (d / "names.dmp").write_text(NAMES)
    a = _seq(rng, 12_000, [0.35, 0.15, 0.15, 0.35])
    b = _seq(rng, 12_000, [0.15, 0.35, 0.35, 0.15])
    (d / "refA.fa").write_bytes(b">refA genome\n" + a + b"\n")
    (d / "refB.fa").write_bytes(b">refB genome\n" + b + b"\n")
    (d / "refA2.fa").write_bytes(b">refA2 variant\n" + _mutated(rng, a, 0.01) + b"\n")
    reads = []
    for i in range(120):
        src = a if i % 3 else b
        p = int(rng.integers(0, len(src) - 150))
        reads.append(b"@r%d\n%s\n+\n%s\n" % (i, src[p:p + 150], b"F" * 150))
    (d / "q.fq").write_bytes(b"".join(reads))
    (d / "contigs.fa").write_bytes(b"".join(
        b">ctg%d\n%s\n" % (i, (a if i % 2 else b)[1000 * i: 1000 * i + 2500])
        for i in range(5)))
    # taxid-annotated sequences, accession-named ones and an accession map
    (d / "tid.fa").write_bytes(
        b">tid|83333|k12_a\n%s\n>tid|562|ecoli_b\n%s\n>tid|9606|human_c\n%s\n"
        b">tid|623|shigella_d\n%s\n>tid|2157|archaea_e\n%s\n>NC_000913.3 E. coli\n%s\n"
        b">XX_1 unknown\n%s\n"
        % tuple(_seq(rng, int(rng.integers(80, 300))) for _ in range(7)))
    (d / "named.fa").write_bytes(b">Escherichia coli strain X\nACGTACGT\n"
                                 b">Homo sapiens chr1\nTTTTGGGG\n>nobody here\nACGT\n")
    (d / "acc.tsv").write_bytes(
        b"accession\taccession.version\ttaxid\tgi\n"
        b"NC_000913\tNC_000913.3\t562\t556503834\n"
        b"NZ_CP0001\tNZ_CP0001.1\t623\t-\n"
        b"AB123456\tAB123456.2\t9606\t12345\n"
        b"XY987\tXY987.1\t0\t77\n"
        b"Q9ZZ11\tQ9ZZ11.1\t83333\tna\n")
    (d / "gi_dump.tsv").write_bytes(b"4242\t562\n5151\t9606\n")
    (d / "queries.txt").write_bytes(b"562\t83333\n83333,9606\nNC_000913\n424242\n623\t562\n")
    cols = []
    for i, (org, tid, cat, lvl) in enumerate([
            (b"Escherichia coli K-12", 562, b"reference genome", b"Complete Genome"),
            (b"Escherichia coli O157", 562, b"na", b"Contig"),
            (b"Escherichia albertii", 562, b"representative genome", b"Scaffold"),
            (b"Shigella flexneri 2a", 623, b"na", b"Chromosome"),
            (b"Shigella flexneri 5", 623, b"reference genome", b"Complete Genome"),
            (b"Homo sapiens", 9606, b"na", b"Chromosome")]):
        f = [b"GCF_%09d.1" % i] + [b"x"] * 19
        f[4], f[6], f[7], f[11] = cat, b"%d" % tid, org, lvl
        f[19] = b"ftp://ftp.ncbi.nlm.nih.gov/genomes/all/GCF/%03d/GCF_%09d.1_asm" % (i, i)
        cols.append(b"\t".join(f))
    (d / "assembly_summary.txt").write_bytes(
        b"#   See ftp://ftp.ncbi.nlm.nih.gov/genomes/README_assembly_summary.txt\n"
        + b"\n".join(cols) + b"\n")
    # a serialized tree, legacy sketches and result tables
    TaxTree.load(str(d / "names.dmp"), str(d / "nodes.dmp")).save(str(d / "tree.npz"))
    for name, path in (("a1", "refA.fa"), ("a2", "refA2.fa"), ("b1", "refB.fa")):
        h = sketch_file(str(d / path), k=31, size=400)
        (d / f"{name}.sketch").write_bytes(b"#SZ:%d\tK:31\tNM:%s\n" % (len(h), path.encode())
                                           + b"".join(b"%d\n" % int(x) for x in h))
    (d / "results1.txt").write_bytes(
        b"Query\tRef\tWKID\tANI\tMatches\tSize\n"
        b"q1\trefA\t41.50%\t97.20%\t415\t1000\nq1\trefB\t2.10%\t88.00%\t21\t1000\n"
        b"q2\trefB\t77.00%\t99.10%\t770\t1000\n")
    (d / "results2.txt").write_bytes(
        b"Query\tRef\tWKID\tANI\tMatches\tSize\n"
        b"q1\trefA2\t45.00%\t97.60%\t450\t1000\nq3\trefA\t0.40%\t80.10%\t4\t1000\n")
    from bbtools_tpu.cli import main as jmain
    import contextlib
    import io

    with contextlib.redirect_stderr(io.StringIO()):
        jmain(["cladeloader", f"ref={d}/refA.fa,{d}/refB.fa", f"out={d}/db.npz"])
    # the reference .sketch text a SendSketch client posts (HASH_VERSION=2)
    keys, stats = sketch_file_v2(str(d / "refA2.fa"))
    write_sketch_v2(str(d / "q_v2.sketch"), keys, stats, name="queryA2", fname="refA2.fa")
    return d


TREE = ["names={i}/names.dmp", "nodes={i}/nodes.dmp"]

#: name -> argv with {i} the inputs and {o} the side's output directory
CASES = {
    "sketch": ["in={i}/refA.fa", "out={o}/a.sketch", "size=2000"],
    "bbsketch": ["in={i}/refA.fa,{i}/refA2.fa,{i}/refB.fa", "out={o}/a.sketch",
                 "blacklist=silva", "size=3000"],
    "comparesketch": ["in={i}/q.fq", "ref={i}/refA.fa", "size=5000"],
    "sendsketch": ["in={i}/refB.fa,{i}/refA2.fa", "ref={i}/refA.fa", "hv=1", "k=31",
                   "out={o}/b.sketch"],
    "mergesketch": ["in={i}/a1.sketch,{i}/a2.sketch,{i}/b1.sketch", "out={o}/m.sketch"],
    "subsketch": ["in={i}/a1.sketch", "out={o}/s.sketch", "size=50"],
    "summarizesketch": ["in={i}/results1.txt,{i}/results2.txt", "out={o}/sum.txt"],
    "taxonomy": [*TREE, "ids=562,Bacteria,Homo sapiens,424242,83333",
                 "tree={o}/t.taxtree.npz"],
    "taxtree": ["tree={i}/tree.npz", "ids=623,Escherichia,2157"],
    "filterbytaxa": ["in={i}/tid.fa", "out={o}/kept.fa", *TREE, "ids=Enterobacteriaceae",
                     "accession={i}/acc.tsv"],
    "splitbytaxa": ["in={i}/tid.fa", "out={o}/split_%.fa", *TREE, "level=genus",
                    "accession={i}/acc.tsv"],
    "fusebytaxa": ["in={i}/tid.fa", "out={o}/fused.fa", *TREE, "level=species", "npad=5"],
    "gi2taxid": ["in={i}/named.fa", "out={o}/renamed.fa", *TREE],
    "gi2ancestors": ["in={i}/queries.txt", "out={o}/anc.txt", "tree={i}/tree.npz",
                     "accession={i}/acc.tsv"],
    "gitable": ["in={i}/acc.tsv,{i}/gi_dump.tsv", "out={o}/gi.tsv"],
    "taxsize": ["in={i}/tid.fa", "out={o}/size.tsv", "tree={i}/tree.npz",
                "accession={i}/acc.tsv"],
    "explodetree": ["in={i}/tid.fa", "out={o}/tree", "results={o}/res.tsv", *TREE],
    "analyzeaccession": ["in={i}/acc.tsv", "out={o}/pat.tsv"],
    "shrinkaccession": ["in={i}/acc.tsv", "out={o}/shrunk.tsv"],
    "filterassemblysummary": ["in={i}/assembly_summary.txt", "out={o}/as.txt", *TREE,
                              "ids=Escherichia,9606"],
    "fetchproks": ["in={i}/assembly_summary.txt", "out={o}/fetch.sh", "mspg=2"],
    "cladeloader": ["ref={i}/contigs.fa", "out={o}/db.npz", "per=sequence"],
    "quickclade": ["in={i}/contigs.fa", "ref={i}/refA.fa,{i}/refB.fa"],
    "clade": ["in={i}/contigs.fa", "db={i}/db.npz"],
    "sendclade": ["in={i}/contigs.fa", "ref={i}/refA2.fa", "db={i}/db.npz"],
}


@pytest.mark.parametrize("tool", list(CASES))
def test_host_tool_equals_jax(inputs, tmp_path, tool):
    res = run_host_both(tool, CASES[tool], inputs, tmp_path)
    assert res["torch"] == res["jax"]
    assert res["jax"][2] or res["jax"][0], "no output"


# ---------------------------------------------------------------- servers


def _requests(tool, inputs):
    """(method, path, body) of the requests a case sends its server; the
    sketch bodies are refA2's, as a SendSketch client posts them (the
    legacy JSON of its hashes, the reference .sketch text)."""
    hashes = sketch_file(str(inputs / "refA2.fa"), k=31)
    js = json.dumps({"hashes": [int(h) for h in hashes], "k": 31}).encode()
    v2 = (inputs / "q_v2.sketch").read_bytes()
    clade_q = b">q\n" + (inputs / "refA.fa").read_bytes().split(b"\n")[1][2000:6000] + b"\n"
    tax = [("GET", "/health", None), ("GET", "/tax/562", None),
           ("GET", "/tax/Escherichia%20coli", None), ("GET", "/tax/424242", None),
           ("GET", "/tax/ancestor/83333/9606", None),
           ("GET", "/tax/pt/name/Escherichia_coli", None),
           ("GET", "/tax/pt/taxid/562,424242,9606", None),
           ("GET", "/tax/sc_name/Shigella_flexneri", None),
           ("GET", "/tax/ancestor/pt/taxid/83333,623", None),
           ("GET", "/tax/name/Escherichia_coli", None),
           ("GET", "/stax/sc/taxid/83333", None), ("GET", "/nowhere", None)]
    return {
        "server": tax + [("POST", "/sketch/compare", js), ("POST", "/sketch", v2),
                         ("POST", "/clade/classify", clade_q)],
        "taxserver": tax + [("GET", "/tax/pt/accession/NC_000913.3", None),
                            ("GET", "/tax/pt/header/tid|623|x", None),
                            ("POST", "/sketch", v2)],
        "sketchserver": [("POST", "/sketch/compare", js), ("POST", "/sketch", v2),
                         ("POST", "/sketch", b"not a sketch"), ("GET", "/tax/562", None)],
        "cladeserver": [("POST", "/clade/classify", clade_q), ("GET", "/health", None)],
        "ssuserver": tax[:4] + [("POST", "/sketch/compare", js)],
        "demuxserver": [("POST", "/demux/assign", json.dumps({
            "barcodes": ["ACGTACGT", "ACGTACGA", "TTTTCCCC", "GGGGGGGG", "TTTTCCCA"],
            "expected": ["ACGTACGT", "TTTTCCCC"]}).encode()),
            ("POST", "/demux/assign", b"{}"), ("POST", "/clade/classify", clade_q)],
    }[tool]


SERVER_ARGV = {
    "server": [*TREE, "ref={i}/refA.fa,{i}/refB.fa", "clade={i}/refA.fa,{i}/refB.fa"],
    "taxserver": [*TREE, "accession={i}/acc.tsv"],
    "sketchserver": ["ref={i}/refA.fa,{i}/refB.fa"],
    "cladeserver": ["clade={i}/db.npz,{i}/refA2.fa"],
    "ssuserver": [*TREE, "ref={i}/refB.fa"],
    "demuxserver": [],
}


def _fetch(port, method, path, body):
    """One request to 127.0.0.1 (no proxy): (status, content type, body)."""
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 method=method)
    try:
        with opener.open(req, timeout=60) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def _serve_and_query(monkeypatch, mod, requests, replies):
    """Patch `mod` (a server module) so that main, once listening, sends
    the requests, keeps the replies, and stops as on Ctrl-C."""
    import threading

    started = {}
    real_start = mod.start_server

    def start(state, port=0):
        srv, port = real_start(state, port)
        started["srv"], started["port"] = srv, port
        return srv, port

    class Event:
        def wait(self):
            for method, path, body in requests:
                replies.append(_fetch(started["port"], method, path, body))
            raise KeyboardInterrupt

    monkeypatch.setattr(mod, "start_server", start)
    monkeypatch.setattr(mod, "threading",
                        types.SimpleNamespace(Event=Event, Thread=threading.Thread))
    return started


@pytest.mark.parametrize("tool", list(SERVER_ARGV))
def test_server_equals_jax(inputs, tmp_path, monkeypatch, tool):
    """The server launchers, on 127.0.0.1 at a port the system picks:
    the same requests get the same replies from both packages."""
    from bbtools_torch.models import server as tserver
    from bbtools_tpu.models import server as jserver

    requests = _requests(tool, inputs)
    replies = {"jax": [], "torch": []}
    started = {d: _serve_and_query(monkeypatch, m, requests, replies[d])
               for d, m in (("jax", jserver), ("torch", tserver))}
    try:
        res = run_host_both(tool, [*SERVER_ARGV[tool], "port=0"], inputs, tmp_path,
                            masks=[(r"127\.0\.0\.1:\d+", "127.0.0.1:PORT")])
    finally:
        for s in started.values():
            if "srv" in s:
                s["srv"].server_close()
    assert res["torch"] == res["jax"]
    assert "Server listening on 127.0.0.1:PORT" in res["jax"][1]
    assert len(replies["torch"]) == len(requests)
    assert replies["torch"] == replies["jax"]
    assert any(status == 200 for status, _, _ in replies["jax"])


# ------------------------------------------------ library cases, small size


def test_java_random_replay_equals_jax():
    from bbtools_torch.ops import sketch_hash as t
    from bbtools_tpu.ops import sketch_hash as j

    for seed in (12345, 7, -3):
        rt, rj = t.JavaRandom(seed), j.JavaRandom(seed)
        assert [rt.next_long_u64() for _ in range(50)] == [rj.next_long_u64() for _ in range(50)]
        assert [rt.next_int(64) for _ in range(200)] == [rj.next_int(64) for _ in range(200)]
        assert [rt.next_int(4999) for _ in range(200)] == [rj.next_int(4999) for _ in range(200)]
    tab = t.codes1d()
    assert (tab == j.codes1d()).all() and tab.shape == (2048,)


def test_sketch_meets_java_blacklist_in_the_jax_keys():
    """The port's v2 sketch of the bundled 16S consensus meets the
    Java-made silva blacklist in exactly the JAX package's keys (the
    blacklist read through load_blacklist's keyword, by path)."""
    from bbtools_torch.models import sketch as t
    from bbtools_tpu.models import sketch as j

    bl_t, bl_j = t.load_blacklist("silva"), j.load_blacklist("silva")
    assert (bl_t == bl_j).all() and len(bl_t) > 1000
    fa = os.path.join(RES, "16S_consensus_sequence.fa")
    keys_t, stats_t = t.sketch_file_v2(fa, size=100000)
    keys_j, stats_j = j.sketch_file_v2(fa, size=100000)
    assert (keys_t == keys_j).all() and stats_t == stats_j
    inter_t = np.intersect1d(keys_t.astype(np.uint64), bl_t)
    assert (inter_t == np.intersect1d(keys_j.astype(np.uint64), bl_j)).all()
    assert len(inter_t) >= 100


def test_sketch_format_roundtrip_between_packages(tmp_path):
    from bbtools_torch.models import sketch as t
    from bbtools_tpu.models import sketch as j

    phix = os.path.join(RES, "phix2.fa.gz")
    keys, stats = t.sketch_file_v2(phix, size=500)
    t.write_sketch_v2(str(tmp_path / "t.sketch"), keys, stats, name="phiX", fname="phix2.fa.gz")
    j.write_sketch_v2(str(tmp_path / "j.sketch"), keys, stats, name="phiX", fname="phix2.fa.gz")
    assert (tmp_path / "t.sketch").read_bytes() == (tmp_path / "j.sketch").read_bytes()
    back, hdr = j.read_reference_sketch(str(tmp_path / "t.sketch"))
    assert (np.sort(keys.astype(np.uint64)) == back).all() and hdr["NM"] == "phiX"


def test_taxtree_serialization_between_packages(inputs, tmp_path):
    """A tree the port saves loads in the JAX package and the other way
    round, with the same lineages, names and levels."""
    from bbtools_torch.models.taxonomy import TaxTree as TTree

    tt = TTree.load(str(inputs / "names.dmp"), str(inputs / "nodes.dmp"))
    tt.save(str(tmp_path / "t.npz"))
    jt = TaxTree.load_tree(str(tmp_path / "t.npz"))
    back = TTree.load_tree(str(inputs / "tree.npz"))
    for tid in (83333, 562, 623, 9606, 2157, 1):
        assert jt.lineage(tid) == tt.lineage(tid) == back.lineage(tid)
        assert jt.name_of(tid) == back.name_of(tid)
        assert jt.ancestor_at_level(tid, "phylum") == back.ancestor_at_level(tid, "phylum")
    assert back.id_of("Shigella") == 620 and back.common_ancestor(83333, 623) == 543


def test_accession_index_equals_jax(tmp_path):
    from bbtools_torch.models import taxonomy as t
    from bbtools_tpu.models import taxonomy as j

    path = tmp_path / "acc2taxid"
    rows = [f"NZ_{i:07d}\tNZ_{i:07d}.1\t{i + 1}\t{i}\n" for i in range(3000)]
    path.write_text("accession\taccession.version\ttaxid\tgi\n" + "".join(rows)
                    + "THIS_ONE_IS_FAR_TOO_LONG_TO_PACK\tX.1\t777\t0\nplain2col\t4242\n")
    it, ij = t.AccessionIndex.build(str(path)), j.AccessionIndex.build(str(path))
    assert (it.keys == ij.keys).all() and (it.taxids == ij.taxids).all()
    for q in (b"NZ_0000000", b"NZ_0001234.1", b"nz_0002999", b"NOPE",
              b"THIS_ONE_IS_FAR_TOO_LONG_TO_PACK", b"PLAIN2COL"):
        assert it.get(q) == ij.get(q)
    small_t, small_j = t.load_accession_map(str(path)), j.load_accession_map(str(path))
    assert small_t == small_j
