"""LM toolkit CLI (cmuclmtk + sphinx_lmtools capability).

Subcommands mirror the reference pipeline programs:

    python -m cmusphinx_tpu.cli.lmtool train -text corpus.txt -lm out.arpa \
        [-n 3] [-discount good_turing] [-top 5000] [-cutoffs 0,0,0]
    python -m cmusphinx_tpu.cli.lmtool convert -i in.arpa -o out.DMP
    python -m cmusphinx_tpu.cli.lmtool eval -lm lm.arpa -text test.txt
    python -m cmusphinx_tpu.cli.lmtool interpolate -lms a.arpa,b.arpa \
        -weights 0.5,0.5 -lm out.arpa

Fringe format tools (cmuclmtk/src/programs):

    ... lmtool text2wngram -text corpus.txt -o out.wngram [-n 3]
    ... lmtool ngram2mgram -i in.idngram -o out.idngram -n 3 -m 2
    ... lmtool idngram2stats -i in.idngram -n 3 [-fof_size 50]
    ... lmtool binlm2arpa -binary in.DMP -arpa out.arpa
    ... lmtool arpa2binlm -arpa in.arpa -binary out.DMP

(reference: cmuclmtk text2wfreq/wfreq2vocab/text2idngram/idngram2lm/evallm,
lm_combine/lm_interpolate, ngram2mgram/text2wngram/idngram2stats/
binlm2arpa/arpa2binlm; sphinxbase sphinx_lm_convert / sphinx_lm_eval)
"""

from __future__ import annotations

import sys

from ..lm.estimate import interpolate, train_lm
from ..models.ngram import NgramModel
from .batch import parse_argv


def _read_corpus(path: str):
    out = []
    for line in open(path, errors="replace"):
        ws = line.split()
        # strip NIST-style (uttid) trailers
        if ws and ws[-1].startswith("(") and ws[-1].endswith(")"):
            ws = ws[:-1]
        if ws:
            out.append(ws)
    return out


def _write_lm(m: NgramModel, path: str) -> None:
    if path.upper().endswith(".DMP"):
        m.write_dmp(path)
    else:
        m.write_arpa(path)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__)
        return 1
    cmd, kv = argv[0], parse_argv(argv[1:])
    if cmd == "train":
        corpus = _read_corpus(kv["text"])
        cutoffs = ([int(x) for x in kv["cutoffs"].split(",")]
                   if "cutoffs" in kv else None)
        m = train_lm(corpus, n=int(kv.get("n", 3)),
                     discount=kv.get("discount", "good_turing"),
                     top=int(kv.get("top", 0)), cutoffs=cutoffs,
                     use_unk=kv.get("unk", "no") == "yes")
        _write_lm(m, kv["lm"])
        print(f"trained {m.n}-gram LM: counts {m.counts()} -> {kv['lm']}")
    elif cmd == "convert":
        m = NgramModel.read(kv["i"])
        _write_lm(m, kv["o"])
        print(f"converted {kv['i']} -> {kv['o']} (counts {m.counts()})")
    elif cmd == "eval":
        m = NgramModel.read(kv["lm"])
        ppl, n, oov = m.perplexity(_read_corpus(kv["text"]),
                                   use_unk=kv.get("unk", "no") == "yes")
        print(f"perplexity {ppl:.2f} over {n} words ({oov} OOV)")
    elif cmd == "text2wngram":
        from ..lm.idngram import text_to_wngram
        grams = text_to_wngram(_read_corpus(kv["text"]),
                               n=int(kv.get("n", 3)),
                               sent_markers=kv.get("sent_markers",
                                                   "no") == "yes")
        with open(kv["o"], "w") as fh:
            for g, c in grams:
                fh.write(" ".join(g) + f" {c}\n")
        print(f"{len(grams)} distinct {kv.get('n', 3)}-grams -> {kv['o']}")
    elif cmd == "ngram2mgram":
        from ..lm.idngram import ngram_to_mgram
        nd = ngram_to_mgram(kv["i"], kv["o"],
                            n=int(kv["n"]), m=int(kv["m"]))
        print(f"{kv['i']} ({kv['n']}-grams) -> {kv['o']} "
              f"({nd} distinct {kv['m']}-grams)")
    elif cmd == "idngram2stats":
        from ..lm.idngram import idngram_stats
        nd, total, fof = idngram_stats(kv["i"], n=int(kv["n"]),
                                       fof_size=int(kv.get("fof_size", 50)))
        print(f"{nd} distinct {kv['n']}-grams ({total} total)")
        print("fof (count : number of n-grams with that count):")
        for c, k in enumerate(fof, start=1):
            if k:
                print(f"{c} : {int(k)}")
    elif cmd == "binlm2arpa":
        m = NgramModel.read(kv["binary"])
        m.write_arpa(kv["arpa"])
        print(f"{kv['binary']} -> {kv['arpa']} (counts {m.counts()})")
    elif cmd == "arpa2binlm":
        m = NgramModel.read(kv["arpa"])
        m.write_dmp(kv["binary"])
        print(f"{kv['arpa']} -> {kv['binary']} (counts {m.counts()})")
    elif cmd == "interpolate":
        lms = [NgramModel.read(p) for p in kv["lms"].split(",")]
        ws = [float(x) for x in kv["weights"].split(",")]
        m = interpolate(lms, ws)
        _write_lm(m, kv["lm"])
        print(f"interpolated {len(lms)} LMs -> {kv['lm']} "
              f"(counts {m.counts()})")
    else:
        print(__doc__)
        return 1
    return 0


if __name__ == "__main__":
    from cmusphinx_tpu.utils.compile_cache import init_compile_cache
    init_compile_cache()
    sys.exit(main())
