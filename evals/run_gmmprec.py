#!/usr/bin/env python
"""The -gmmprec modes of the continuous scorer, measured on the GPU.

On the seeded continuous model (evals/seeded.py: 5,150 senones x 32
Gaussians x 39 dims), for each mode (ops/gmm.py GEMM_PRECISIONS):

1. the scorer alone on a 16 x 500-frame batch: median of --reps timed
   calls, and its largest error against the float64 reference relative to
   the mode's bound (evals/reference64.py REL_BOUND);
2. decode (c) end to end: 5,000 words, flat composite lexicon, 16 planted
   utterances of 2-6 s through NgramSearch.decode_batch, with the planted
   transcripts counted.

Prints one JSON line per measurement.

    python evals/run_gmmprec.py [--reps N] [--modes highest,high,bf16]
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--modes", default="highest,high,bf16")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    if jax.devices()[0].platform != "gpu":
        sys.exit("run_gmmprec.py measures the GPU; JAX found "
                 f"{jax.devices()[0].platform!r}")
    import reference64
    from seeded import Planter, write_models
    from cmusphinx_tpu.api import Decoder
    from cmusphinx_tpu.ops.gmm import ContinuousScorer

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.splitlines()[0].strip()

    def emit(**kw):
        print(json.dumps({"card": card, **kw}), flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        seeded = write_models(tmp, 0)
        pc = Planter(seeded, "cont", "words")
        lnw = np.log(pc.w).astype(np.float32)
        x = np.concatenate([f for _, f in pc.batch(
            np.random.default_rng(3), 20, 4.0, 6.0)])[: 16 * 500]
        want, mag = reference64.cont_scores(x[:200], pc.g, lnw)
        utts = pc.batch(np.random.default_rng(10), 16, 2.0, 6.0)
        feats = [f for _, f in utts]
        audio = sum(len(f) for f in feats) / 100.0
        for prec in args.modes.split(","):
            f = jax.jit(ContinuousScorer(pc.g, lnw, precision=prec).score)
            xj = jnp.asarray(x)
            got = np.asarray(f(xj))
            ts = []
            for _ in range(args.reps):
                t0 = time.perf_counter()
                jax.block_until_ready(f(xj))
                ts.append(time.perf_counter() - t0)
            err = np.abs(got[:200] - want)
            emit(what="scorer", gmmprec=prec, frames=len(x),
                 ms=1e3 * float(np.median(ts)),
                 max_abs_err=float(err.max()), max_err_over_bound=float(
                     (err / (reference64.REL_BOUND[prec] * mag)).max()))

            d = Decoder(hmm=seeded.cont, lm=seeded.words_lm,
                        dict=seeded.words_dic, lexmode="flat",
                        rcmode="composite", lcmode="composite", gmmprec=prec)
            t0 = time.perf_counter()
            hyps = d.search.decode_batch(feats)
            first = time.perf_counter() - t0
            ts = []
            for _ in range(3):
                t0 = time.perf_counter()
                d.search.decode_batch(feats)
                ts.append(time.perf_counter() - t0)
            steady = float(np.median(ts))
            emit(what="decode_c", gmmprec=prec, utterances=len(utts),
                 audio_s=audio, first_call_s=first, steady_s=steady,
                 xrt=audio / steady,
                 correct=sum(h.words == w for h, (w, _) in zip(hyps, utts)))
    return 0


if __name__ == "__main__":
    from cmusphinx_tpu.utils.compile_cache import init_compile_cache
    init_compile_cache()
    sys.exit(main())
