#!/usr/bin/env python
"""Benchmark: batch N-gram decode throughput on the reference's tidigits
regression set (shipped model + DMP LM + 31 utterances, 67.6 s of audio).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.
value = audio-seconds decoded per wall-clock second (xRT) in steady state
(compiles amortized via a warm-up pass).  vs_baseline is against the
north-star >500x real-time per chip (BASELINE.json); the classic decoders
ran ~6x RT on this task (S3.3 0.16 xRT -> 6.25x, BASELINE.md).

Correctness is asserted (31/31 golden sentences) so the number can't be
bought with a broken decoder.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np


def main():
    import jax

    if "--cpu" in sys.argv:
        jax.config.update("jax_platforms", "cpu")
    from cmusphinx_tpu.utils.compile_cache import init_compile_cache
    init_compile_cache()

    from cmusphinx_tpu.decode import NgramSearch
    from cmusphinx_tpu.frontend.fe import FE_ARGS
    from cmusphinx_tpu.frontend.feat import FEAT_ARGS, FeatPipeline
    from cmusphinx_tpu.models import Mdef, TransitionMatrices, read_sendump
    from cmusphinx_tpu.models.dict import Dictionary
    from cmusphinx_tpu.models.gauden import read_gauden
    from cmusphinx_tpu.models.ngram import NgramModel
    from cmusphinx_tpu.ops.gmm import PsParityScorer
    from cmusphinx_tpu.utils.bio import read_mfc
    from cmusphinx_tpu.utils.config import Config

    R = "/root/reference/pocketsphinx"
    H = R + "/model/hmm/en/tidigits"
    mdef = Mdef.read(H + "/mdef")
    g = read_gauden(H + "/means", H + "/variances")
    w, meta = read_sendump(H + "/sendump", return_raw=True)
    tmat = TransitionMatrices.read(H + "/transition_matrices")
    d = Dictionary.read(R + "/model/lm/en/tidigits.dic", mdef)
    lm = NgramModel.read(R + "/model/lm/en/tidigits.DMP")
    cfg = Config(FE_ARGS, FEAT_ARGS)
    cfg.update_from_file(H + "/feat.params")
    fp = FeatPipeline(cfg)
    scorer = PsParityScorer(g, w, fp.stream_slices(),
                            wrap_uint8=meta["n_bits"] == 4)
    search = NgramSearch(lm, d, mdef, tmat, scorer)

    lsn = {}
    for line in open(R + "/test/data/tidigits/tidigits.lsn"):
        p = line.split()
        lsn[p[-1].strip("()")] = " ".join(p[:-1])
    ctl = [l.strip() for l in open(R + "/test/data/tidigits/tidigits.ctl")
           if l.strip()]
    ceps = [read_mfc(R + f"/test/data/tidigits/{u}.mfc") for u in ctl]
    audio_s = sum(len(c) for c in ceps) * 0.01

    # Warm-up pass (compiles the fused cep->feat->decode->backtrace
    # program) + correctness check against the committed golden
    # transcripts.
    hyps = search.decode_batch_cep(ceps, fp)
    n_ok = sum(h.text == lsn[u] for h, u in zip(hyps, ctl))
    assert n_ok == len(ctl), f"accuracy regression: {n_ok}/{len(ctl)}"

    # Timed steady-state passes (each is one batched device call + the
    # host hypothesis assembly); median of 5.
    dts = []
    for _ in range(5):
        t0 = time.time()
        search.decode_batch_cep(ceps, fp)
        dts.append(time.time() - t0)
    dt = sorted(dts)[len(dts) // 2]
    xrt = audio_s / dt

    # Model-FLOP MFU of the run: the senone GEMMs are the decode's model
    # math; this task is latency-bound, so the number is tiny — see
    # evals/mfu_report.py for the FLOP-rich stages.  No MFU on the CPU.
    from cmusphinx_tpu.utils import mfu as _mfu
    veclens = [len(sl) for sl in fp.stream_slices()]
    Tpad = -(-max(len(c) for c in ceps) // search.FRAME_BUCKET) \
        * search.FRAME_BUCKET
    flops = _mfu.psparity_flops(len(ceps) * Tpad, g.n_feat, g.n_density,
                                veclens, scorer.n_sen, 4)
    dev = jax.devices()[0]
    out = {
        "metric": "tidigits_batch_decode_throughput",
        "value": round(xrt, 2),
        "unit": "audio_seconds_per_second (xRT)",
        "vs_baseline": round(xrt / 500.0, 4),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }
    peaks = _mfu.device_peaks(dev)
    if peaks:
        out["mfu_bf16_peak"] = flops / dt / peaks.bf16
    print(json.dumps(out))


if __name__ == "__main__":
    main()
