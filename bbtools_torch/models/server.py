"""SketchServer / TaxServer — HTTP services over heavy indexes.

Reference: the reference hosts its large indexes behind
`com.sun.net.httpserver`-based services — tax/TaxServer.java:58
(createContext :351-355; also serves sketches in `sketchonly` mode
wrapping sketch/SketchSearcher), with clients tax/TaxClient and
sketch/SendSketch posting queries to the public endpoints listed in
shared/Shared.java:86-106 (SURVEY.md §2 "client/server distribution").

Here: one stdlib ThreadingHTTPServer hosting both roles —
  GET  /tax/<name-or-taxid>          -> lineage json
  GET  /tax/ancestor/<a>/<b>         -> common-ancestor json
  POST /sketch/compare               -> body: json {hashes:[...], k}
                                        -> top matches vs loaded refs
  GET  /health                       -> {"status": "ok"}

The heavy state (TaxTree, reference sketches) loads once at startup;
request handling is read-only and thread-safe. `send_sketch()` is the
SendSketch client analog.
"""

from __future__ import annotations

import json
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..core.parser import tokenize


class ServerState:
    def __init__(self):
        self.tree = None
        self.sketches = []  # (name, hashes, k)
        self.clades = []  # Clade profiles (QuickClade DB role)
        self.acc_map = None  # accession -> taxid (AccessionToTaxid role)
        self.sketches_v2 = []  # HASH_VERSION=2 twins (SendSketch interop)

    def load_accessions(self, path: str):
        from .taxonomy import load_accession_map

        self.acc_map = load_accession_map(path)

    def add_clade_fasta(self, path: str):
        if path.endswith(".npz"):  # cladeloader DB
            from .clade import load_db

            self.clades.extend(load_db(path))
            return
        from .clade import profile_fasta

        self.clades.append(profile_fasta(path))

    def load_tax(self, names_dmp: str, nodes_dmp: str):
        from .taxonomy import TaxTree

        self.tree = TaxTree.load(names_dmp, nodes_dmp)

    def add_sketch_file(self, path: str):
        from .sketch import read_sketch

        hashes, k = read_sketch(path)
        self.sketches.append((path, hashes, k))

    def add_reference_fasta(self, path: str, k: int = 31, size: int = 10000):
        from .sketch import sketch_file, sketch_file_v2

        hashes = sketch_file(path, k=k, size=size)
        self.sketches.append((path, hashes, k))
        # v2 (XOR-code-table) twin so reference SendSketch clients —
        # which hash with HASH_VERSION=2 (k=32,24) — get real matches
        keys2, _stats = sketch_file_v2(path, size=size)
        self.sketches_v2.append((path, keys2, 32))


# reference URL grammar (tax/TaxServer.java toResponse :1062-1210 +
# typeMap :1789): /tax/{flags...}/{type}/{name,name,...}. Reference
# clients (tax/TaxClient.java sendAndReceive "pt/name/" etc.) parse the
# PLAIN-TEXT replies, so those are the interop-critical shapes.
_TAX_TYPES = {
    "name", "taxid", "id", "tid", "ncbi", "tax_id", "header",
    "accession", "gi", "silvaheader", "img",
}
_TAX_FLAGS = {
    "pt", "plaintext", "sc", "semicolon", "pa", "path", "simple",
    "ancestor", "pp", "printpath", "ps", "size", "printsize", "range",
    "printrange", "children", "printchildren", "numchildren",
    "printnumchildren", "mono", "mononomial", "cn", "fixname", "fn",
    "refseq", "silva", "tax", "",
}
_LEVEL_SHORT = {
    "subspecies": "ss", "species": "s", "genus": "g", "family": "f",
    "order": "o", "class": "c", "phylum": "p", "kingdom": "k",
    "superkingdom": "sk", "domain": "d", "life": "l",
}


def _ref_tax_response(state, parts):
    """Handle a reference-grammar tax query; returns (body str,
    content_type) or None when the path is not reference-grammar (the
    caller falls through to the legacy JSON routes)."""
    import urllib.parse

    from .taxonomy import LEVELS

    t = state.tree
    simple = parts[0] in ("stax", "simpletax")
    toks = parts[1:]
    if not toks:
        return None
    plaintext = semicolon = ancestor = False
    typ = None
    for s in toks[:-1]:
        sl = s.lower()
        if sl in ("pt", "plaintext"):
            plaintext = True
        elif sl in ("sc", "semicolon"):
            semicolon = True
        elif sl == "ancestor":
            ancestor = True
        elif sl == "simple":
            simple = True
        elif sl in _TAX_TYPES or sl.startswith(("pt_", "sc_")):
            typ = sl
        elif sl in _TAX_FLAGS:
            pass
        else:
            return None
    if typ is None:
        return None
    if typ.startswith("pt_"):
        plaintext, typ = True, typ[3:]
    elif typ.startswith("sc_"):
        semicolon, typ = True, typ[3:]
    names = [
        urllib.parse.unquote(x) for x in toks[-1].split(",") if x
    ]

    def to_tid(nm: str) -> int:
        if typ in ("taxid", "id", "tid", "ncbi", "tax_id"):
            try:
                tid = int(nm)
            except ValueError:
                return -1
            return tid if t.valid(tid) else -1
        if typ in ("header", "silvaheader"):
            nm = nm.lstrip("@>")
            from .taxonomy import taxid_of_header

            tid = taxid_of_header(nm.encode(), state.acc_map)
            if tid <= 0:
                tid = t.id_of(nm.replace("_", " "))
            return tid if tid > 0 and t.valid(tid) else -1
        if typ == "accession":
            m = state.acc_map or {}
            key = nm.split(".")[0].upper().encode()
            tid = m.get(key, 0) or m.get(nm.encode(), 0)
            return tid if tid > 0 else -1
        if typ == "gi":
            return -1  # GI support suspended in the reference too
        # name: client sends '_' for ' ' (TaxClient.java:167)
        tid = t.id_of(nm.replace("_", " "))
        return tid if tid > 0 and t.valid(tid) else -1

    def semicolon_of(tid: int) -> str:
        if tid < 0:
            return "Not found"
        parts_ = []
        for a in reversed(t.lineage(tid)):
            lv = LEVELS[int(t.level[a])]
            if simple and lv in ("no rank", "subspecies"):
                continue
            short = _LEVEL_SHORT.get(lv)
            nm = t.name_of(a)
            parts_.append(f"{short}:{nm}" if short else nm)
        return ";".join(parts_) if parts_ else "Not found"

    def node_json(tid: int) -> dict:
        return {
            "name": t.name_of(tid),
            "tax_id": tid,
            "level": LEVELS[int(t.level[tid])],
        }

    tids = [to_tid(nm) for nm in names]
    if ancestor:
        ca = -1
        live = [x for x in tids if x >= 0]
        if live:
            ca = live[0]
            for x in live[1:]:
                ca = t.common_ancestor(ca, x)
        if plaintext:
            return str(ca if ca is not None and ca >= 0 else -1), "text/plain"
        if ca is None or ca < 0:
            return json.dumps({"error": "Not found."}), "application/json"
        if semicolon:
            return semicolon_of(ca), "text/plain"
        j = node_json(ca)
        for a in t.lineage(ca)[1:]:
            lv = LEVELS[int(t.level[a])]
            if simple and lv in ("no rank", "subspecies"):
                continue
            j[lv] = node_json(a)
        return json.dumps(j), "application/json"
    if plaintext:
        return ",".join(str(x) for x in tids), "text/plain"
    if semicolon:
        return ",".join(semicolon_of(x) for x in tids), "text/plain"
    out = {}
    for nm, tid in zip(names, tids):
        if tid < 0:
            out[nm] = {"error": "Not found."}
            continue
        j = node_json(tid)
        for a in t.lineage(tid)[1:]:
            lv = LEVELS[int(t.level[a])]
            if simple and lv in ("no rank", "subspecies"):
                continue
            j[lv] = node_json(a)
        out[nm] = j
    return json.dumps(out), "application/json"


def _make_handler(state: ServerState):
    class Handler(BaseHTTPRequestHandler):
        def _reply(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # quiet
            pass

        def _reply_raw(self, body: str, ctype: str, code=200):
            data = body.encode()
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            parts = [p for p in self.path.split("/") if p]
            if parts == ["health"]:
                return self._reply({"status": "ok"})
            if (
                parts
                and parts[0] in ("tax", "stax", "simpletax")
                and state.tree is not None
                and len(parts) >= 3
            ):
                # reference URL grammar first (TaxServer.java protocol;
                # reference TaxClient interop); legacy JSON shapes below
                res = _ref_tax_response(state, parts)
                if res is not None:
                    return self._reply_raw(*res)
            if parts and parts[0] == "tax":
                if state.tree is None:
                    return self._reply({"error": "no taxonomy loaded"}, 503)
                t = state.tree
                if len(parts) == 4 and parts[1] == "ancestor":
                    a, b = t.resolve(parts[2]), t.resolve(parts[3])
                    ca = t.common_ancestor(a, b)
                    return self._reply(
                        {"a": a, "b": b, "ancestor": ca,
                         "name": t.name_of(ca) if ca >= 0 else None}
                    )
                if len(parts) == 2:
                    import urllib.parse

                    tid = t.resolve(urllib.parse.unquote(parts[1]))
                    if tid < 0 or not t.valid(tid):
                        return self._reply({"error": "not found"}, 404)
                    return self._reply(
                        {
                            "taxid": tid,
                            "name": t.name_of(tid),
                            "lineage": t.lineage_string(tid),
                        }
                    )
            return self._reply({"error": "bad path"}, 404)

        def do_POST(self):
            if self.path == "/clade/classify":
                # QuickClade-with-server role (clade/CladeServer): POST a
                # fasta body, get the nearest reference clade
                if not state.clades:
                    return self._reply({"error": "no clade DB loaded"}, 503)
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n)
                import tempfile

                from .clade import classify, profile_fasta

                with tempfile.NamedTemporaryFile(suffix=".fa") as tf:
                    tf.write(body)
                    tf.flush()
                    q = profile_fasta(tf.name)
                scored = classify(q, state.clades)
                score, best = scored[0]
                name = best.name
                if isinstance(name, bytes):
                    name = name.decode(errors="replace")
                return self._reply(
                    {"best": name, "absdif": float(score)}
                )
            if self.path == "/demux/assign":
                # DemuxServer/DemuxClient role (barcode/DemuxClient.java):
                # probability-model barcode assignment as a service
                n = int(self.headers.get("Content-Length", 0))
                try:
                    req = json.loads(self.rfile.read(n))
                    observed = [b.encode() for b in req["barcodes"]]
                    expected = [e.encode() for e in req["expected"]]
                    minprob = float(req.get("minprob", -5.6))
                except (ValueError, KeyError) as e:
                    return self._reply({"error": f"bad request: {e}"}, 400)
                from collections import Counter

                from .novademux import PCRMatrixProb as PCRMatrix

                model = PCRMatrix(expected)
                model.fit(Counter(observed))
                uniq = sorted(set(observed))
                best, logp, _margin = model.score(uniq)
                amap = {
                    bc: (expected[int(b)].decode() if lp >= minprob else None)
                    for bc, b, lp in zip(uniq, best, logp)
                }
                return self._reply(
                    {"assignments": [amap[bc] for bc in observed]}
                )
            if (
                self.path.rstrip("/") == "/sketch"
                or self.path.startswith("/sketch/")
            ) and self.path != "/sketch/compare":
                # reference SendSketch wire protocol: the POST body is
                # the .sketch text coding (header line + A48 deltas,
                # sketch/SketchSearcher.loadSketchesFromString); reply is
                # the FORMAT_QUERY_REF_ANI TSV table
                # (sketch/DisplayParams.header :1361 — #Query Ref ANI
                # QSize RefSize QBases RBases KID WKID)
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n)
                from .sketch import compare_sketches, parse_sketch_records

                try:
                    recs = parse_sketch_records(body)
                except Exception as e:
                    return self._reply_raw(
                        f"\nERROR: could not parse sketch body: {e}\n",
                        "text/plain", 400,
                    )
                if not recs or not state.sketches:
                    return self._reply_raw(
                        "\nERROR: This server has no sketches loaded.\n"
                        if not state.sketches
                        else "\nERROR: no query sketches in body.\n",
                        "text/plain", 400,
                    )
                lines = [
                    "#Query\tRef\tANI\tQSize\tRefSize\tQBases\tRBases"
                    "\tKID\tWKID"
                ]
                for hdr, q in recs:
                    k = int(str(hdr.get("K", "31")).split(",")[0])
                    qname = hdr.get("NM", hdr.get("FN", "query"))
                    qbases = int(hdr.get("GS", 0) or 0)
                    # HASH_VERSION=2 queries (dual-k header) compare
                    # against the v2-hashed reference twins
                    hv2 = "," in str(hdr.get("K", "")) or hdr.get("HV") == "2"
                    refs = state.sketches_v2 if hv2 else state.sketches
                    rows = []
                    for rname, rh, k2 in refs:
                        wkid, ani, m, _sz = compare_sketches(
                            q, rh, k=min(k, k2)
                        )
                        if m <= 0:
                            continue
                        kid = m / max(len(q), len(rh), 1)
                        rows.append((ani, rname, wkid, kid, m, len(rh)))
                    rows.sort(key=lambda r: -r[0])
                    for ani, rname, wkid, kid, m, rsz in rows[:20]:
                        lines.append(
                            f"{qname}\t{rname}\t{100 * ani:.2f}"
                            f"\t{len(q)}\t{rsz}\t{qbases}\t0"
                            f"\t{100 * kid:.2f}\t{100 * wkid:.2f}"
                        )
                return self._reply_raw(
                    "\n".join(lines) + "\n", "text/plain"
                )
            if self.path != "/sketch/compare":
                return self._reply({"error": "bad path"}, 404)
            n = int(self.headers.get("Content-Length", 0))
            try:
                req = json.loads(self.rfile.read(n))
                q = np.array(req["hashes"], dtype=np.uint64)
                k = int(req.get("k", 31))
            except (ValueError, KeyError) as e:
                return self._reply({"error": f"bad request: {e}"}, 400)
            from .sketch import compare_sketches

            out = []
            for name, hashes, k2 in state.sketches:
                if k2 != k:
                    continue
                wkid, ani, matches, _size = compare_sketches(q, hashes, k=k)
                out.append(
                    {"ref": name, "matches": int(matches),
                     "wkid": float(wkid), "ani": float(ani)}
                )
            out.sort(key=lambda d: -d["matches"])
            return self._reply({"results": out[:10]})

    return Handler


def start_server(state: ServerState, port: int = 0):
    """Returns (server, port); serve_forever runs on a daemon thread."""
    srv = ThreadingHTTPServer(("127.0.0.1", port), _make_handler(state))
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    return srv, srv.server_address[1]


def send_sketch(host: str, port: int, fasta: str, k: int = 31,
                size: int = 10000):
    """SendSketch client: sketch a file locally, POST it, return matches."""
    import urllib.request

    from .sketch import sketch_file

    hashes = sketch_file(fasta, k=k, size=size)
    req = urllib.request.Request(
        f"http://{host}:{port}/sketch/compare",
        data=json.dumps(
            {"hashes": [int(h) for h in hashes], "k": k}
        ).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())


def main(argv=None):
    a = tokenize(argv if argv is not None else sys.argv[1:])
    state = ServerState()
    if a.get("names") and a.get("nodes"):
        state.load_tax(a.get("names"), a.get("nodes"))
    if a.get("accession"):
        state.load_accessions(a.get("accession"))
    for path in (a.get("ref") or "").split(","):
        if path.strip():
            state.add_reference_fasta(path.strip(), k=a.get_int("k", default=31))
    for path in (a.get("clade", "claderef") or "").split(","):
        if path.strip():
            state.add_clade_fasta(path.strip())
    port = a.get_int("port", default=3068)
    srv, port = start_server(state, port)
    print(f"Server listening on 127.0.0.1:{port}", file=sys.stderr)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        srv.shutdown()
    return srv
