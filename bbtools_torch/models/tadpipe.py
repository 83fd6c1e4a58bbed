"""TadPipe / TadpoleWrapper — multi-k assembly pipeline.

References (semantics source, no code reuse):
  - assemble/TadpoleWrapper.java (tadwrapper.sh) — run Tadpole contig
    assembly over a list of k values, compute assembly stats per k, and
    pick the best by hierarchical comparison of L50/L90/max-contig/
    contig-count (Record.compareTo :370; smaller k wins ties). Prints
    `Recommended K:` and keeps out=contigs_%.fa per-k outputs.
  - assemble/TadPipe.java (tadpipe.sh) — preprocessing pipeline before
    the wrapper (:230-340): BBDuk adapter/quality trim (ktrim=r k=23
    mink=11 hdist=1 tbo tpe qtrim=r trimq=10 minlen=62), BBMerge ecco,
    BBMerge merge (k=75 extend2=120 rem ecct), Tadpole ecc, then
    TadpoleWrapper over the merged+unmerged streams. Stage-specific
    flags pass through with prefixes (trim_/merge_/ecc_/assemble_).

The PyTorch port of bbtools_tpu/models/tadpipe.py, calling the port's
bbduk, bbmerge and tadpole in-process. The one difference: tadpipe
passes its own `device=` (cuda by default) to every stage, since the
stages' argv are built from literals and the stage-prefixed flags only.
"""

from __future__ import annotations

import os
import sys

from ..core.parser import tokenize


def _stats_key(path: str):
    """(L50-ish tuple) for hierarchical 'better assembly' comparison."""
    from .assemblystats import analyze, n_metrics

    scafs, contigs, gc, at, ns = analyze(path)
    n50, l50 = n_metrics(scafs, 0.5)
    n90, l90 = n_metrics(scafs, 0.9)
    return dict(
        n50=n50, l50=l50, n90=n90, l90=l90,
        maxc=int(scafs.max(initial=0)), count=len(scafs),
        total=int(scafs.sum()),
    )


def _better(a: dict, b: dict) -> bool:
    """True if b beats a (TadpoleWrapper.Record.compareTo :370 — N50
    then N90 with 1% tolerance, then max contig, then fewer contigs)."""
    if a is None:
        return True
    for key, bigger_wins in (("n50", True), ("n90", True)):
        av, bv = a[key], b[key]
        if bv > av * 1.01:
            return True
        if av > bv * 1.01:
            return False
    if b["maxc"] != a["maxc"]:
        return b["maxc"] > a["maxc"]
    if b["count"] != a["count"]:
        return b["count"] < a["count"]
    return False


def tadpolewrapper(argv=None):
    a = tokenize(argv if argv is not None else sys.argv[1:])
    from . import tadpole

    ins = a.get("in", "in1")
    out = a.get("out", "out1", default="contigs_%.fa")
    if "%" not in out:
        raise ValueError("out= must contain % (replaced by k)")
    klist = [
        int(x) for x in (a.get("k", "kmers") or "31,62,93").split(",") if x
    ]
    delete_bad = a.get_bool("delete", default=False)
    extra = [
        t for t in (argv or [])
        if "=" in t and t.split("=")[0] not in ("in", "in1", "out", "out1",
                                                "k", "kmers", "delete")
    ]
    concat_tmp = None
    if "," in ins:
        # tadpole streams one input; fuse multi-stream inputs first
        concat_tmp = out.replace("%", "cat_in") + ".fq"
        with open(concat_tmp, "wb") as dst:
            for p in ins.split(","):
                if p and os.path.exists(p):
                    with open(p, "rb") as src:
                        dst.write(src.read())
        ins = concat_tmp
    best_k, best_stats = None, None
    outputs = {}
    for k in sorted(set(klist)):
        dest = out.replace("%", str(k))
        tadpole.main([f"in={ins}", f"out={dest}", f"k={k}",
                      "mode=contig"] + extra)
        outputs[k] = dest
        st = _stats_key(dest)
        print(
            f"k={k}: contigs={st['count']} N50={st['n50']} "
            f"max={st['maxc']} total={st['total']}", file=sys.stderr,
        )
        if _better(best_stats, st):
            best_stats, best_k = st, k
    print(f"Recommended K:\t{best_k}", file=sys.stderr)
    if concat_tmp and os.path.exists(concat_tmp):
        os.remove(concat_tmp)
    if delete_bad:
        for k, dest in outputs.items():
            if k != best_k and os.path.exists(dest):
                os.remove(dest)
    return best_k, outputs


def tadpipe(argv=None):
    argv = list(argv if argv is not None else sys.argv[1:])
    # stage-prefixed passthrough args (TadPipe.java :89-97)
    stage_args = {"trim": [], "ecco": [], "merge": [], "ecc": [],
                  "assemble": []}
    plain = []
    for t in argv:
        key = t.split("=")[0].lower()
        pre = key.split("_")[0]
        if "_" in key and pre in stage_args:
            stage_args[pre].append(t[len(pre) + 1:])
        else:
            plain.append(t)
    a = tokenize(plain)
    in1 = a.get("in", "in1")
    in2 = a.get("in2")
    out = a.get("out", "out1", default="contigs.fa")
    tmpdir = a.get("tmpdir", default=".") or "."
    klist = a.get("k", "kmers", default="31,62,93")
    do_trim = a.get_bool("trim", default=True)
    do_ecco = a.get_bool("ecco", default=True) and in2 is not None
    do_merge = a.get_bool("merge", default=True) and in2 is not None
    do_ecc = a.get_bool("ecc", default=True)
    device = [f"device={a.get('device', default='cuda')}"]
    os.makedirs(tmpdir, exist_ok=True)

    def tpath(n):
        return os.path.join(tmpdir, n)

    from . import bbduk, bbmerge, tadpole

    cur1, cur2 = in1, in2
    temps = []
    if do_trim:
        t1, t2 = tpath("trimmed_1.fq"), tpath("trimmed_2.fq")
        args = [
            f"in={cur1}", f"out={t1}", "ref=adapters", "ktrim=r", "k=23",
            "mink=11", "hdist=1", "qtrim=r", "trimq=10", "tbo", "tpe",
            "minlen=62",
        ] + stage_args["trim"] + device
        if cur2:
            args += [f"in2={cur2}", f"out2={t2}"]
        bbduk.main(args)
        cur1, cur2 = t1, (t2 if cur2 else None)
        temps += [t1] + ([t2] if cur2 else [])
    if do_ecco:
        e1, e2 = tpath("ecco_1.fq"), tpath("ecco_2.fq")
        # ecco emits the corrected pair via out= (r1) + outu2= (r2)
        bbmerge.main([
            f"in={cur1}", f"in2={cur2}", f"out={e1}", f"outu2={e2}",
            "ecco=t", "mix=t", "strict",
        ] + stage_args["ecco"] + device)
        cur1, cur2 = e1, e2
        temps += [e1, e2]
    if do_merge:
        m, u1, u2 = tpath("merged.fq"), tpath("unmerged_1.fq"), tpath(
            "unmerged_2.fq"
        )
        bbmerge.main([
            f"in={cur1}", f"in2={cur2}", f"out={m}", f"outu={u1}",
            f"outu2={u2}", "k=75", "extend2=120", "rem=t", "ecct=t",
        ] + stage_args["merge"] + device)
        streams = [m, u1, u2]
        temps += streams
    else:
        streams = [cur1] + ([cur2] if cur2 else [])
    if do_ecc:
        ecc_streams = []
        for i, s in enumerate(streams):
            d = tpath(f"ecc_{i}.fq")
            tadpole.main([
                f"in={s}", f"out={d}", "mode=correct", "k=50",
            ] + stage_args["ecc"] + device)
            ecc_streams.append(d)
            temps.append(d)
        streams = ecc_streams
    pattern = tpath("contigs_%.fa")
    best_k, outputs = tadpolewrapper([
        "in=" + ",".join(streams), f"out={pattern}", f"k={klist}",
    ] + stage_args["assemble"] + device)
    import shutil

    shutil.copyfile(outputs[best_k], out)
    if a.get_bool("deletetemp", default=True):
        for t in temps:
            if os.path.exists(t):
                os.remove(t)
    print(f"Final assembly (k={best_k}): {out}", file=sys.stderr)
    return best_k


if __name__ == "__main__":
    tadpipe()
