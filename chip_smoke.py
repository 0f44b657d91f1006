#!/usr/bin/env python
"""Bring-up check of the decoder and the trainer on one NVIDIA GPU.

Writes seeded models at full width (evals/seeded.py) and drives the main
paths through their normal entry points, comparing each with a plain
float64 numpy reference (evals/reference64.py):

1. frontend: Decoder.start_utt / process_raw / end_utt on a seeded waveform,
   the MFCC against the same filterbank and DCT matrices in float64;
2. scorers on 200 planted frames: PsParityScorer, SemiContinuousScorer and
   ContinuousScorer in each -gmmprec mode, plus what Precision.HIGH and
   DEFAULT lower to;
3. decode of 16 planted utterances of 2-6 s through Decoder and
   NgramSearch.decode_batch: (a) 11 digits, fanout, semi-continuous;
   (b) 5,000 words, tree lexicon, semi-continuous; (c) 5,000 words, flat
   composite, continuous.  Every planted transcript is required;
4. training: Trainer.em_step at 5k senones x 32 Gaussians, B=16 x T=500;
   the log-likelihood must be finite and must not decrease.

With --multi (four GPUs) it runs only the data-parallel paths and what they
are compared with: em_step_sharded on a 4-device `dp` mesh against the
one-device em_step, and decode (b) split over the mesh against one device.

Each phase prints one JSON line carrying the card's name and power limit;
the last line is {"ok": true, "device": {...}}.  A failed check raises, and
the script then exits non-zero without that line.  The xRT and compile
times are bring-up readings, not a benchmark.

    python chip_smoke.py            # one GPU
    python chip_smoke.py --multi    # four GPUs
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "evals"))

SEED = 0
CARD = {}


def emit(phase: str, **readings) -> None:
    print(json.dumps({"phase": phase, **CARD, **readings}), flush=True)


def nvidia_smi() -> list:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


def timed(fn, reps: int = 3):
    """(first-call seconds, median steady seconds, last result)."""
    t0 = time.perf_counter()
    out = fn()
    first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        ts.append(time.perf_counter() - t0)
    return first, float(np.median(ts)), out


# ----------------------------------------------------------------------
def phase_frontend(seeded):
    import reference64
    from seeded import waveform
    from cmusphinx_tpu.api import Decoder

    d = Decoder(hmm=seeded.sc, lm=seeded.digits_lm, dict=seeded.digits_dic)
    wav = waveform(SEED, 2.0)
    d.start_utt()
    d.process_raw(wav)
    hyp = d.end_utt()
    cep = np.asarray(d.fe.process(wav.astype(np.float32)))
    ref = reference64.mfcc(d.fe, wav)
    err = float(np.abs(cep - ref).max())
    # The frontend's cepstral contract (fe.py): 1e-3 absolute.
    tol = 1e-3
    emit("frontend", frames=int(cep.shape[0]), mfcc_max_abs_err=err,
         tol=tol, hyp_words=len(hyp.words))
    assert cep.shape == ref.shape and err <= tol, (cep.shape, err)


def phase_scorers(seeded):
    import jax
    import jax.numpy as jnp
    import reference64
    from seeded import Planter
    from cmusphinx_tpu.api import Decoder
    from cmusphinx_tpu.models.sendump import read_sendump
    from cmusphinx_tpu.ops.gmm import (GEMM_PRECISIONS, ContinuousScorer,
                                       SemiContinuousScorer)

    rng = np.random.default_rng(SEED + 1)
    # Semi-continuous: PsParityScorer as Decoder builds it, then the exact
    # float scorer.
    d = Decoder(hmm=seeded.sc, lm=seeded.digits_lm, dict=seeded.digits_dic)
    sc = d.scorer
    pl = Planter(seeded, "sc", "words")
    x = np.concatenate([f for _, f in pl.batch(rng, 1, 2.0, 2.0)])[:200]
    raw, _ = read_sendump(os.path.join(seeded.sc, "sendump"), return_raw=True)
    slices = d.fp.stream_slices()
    xj = jnp.asarray(x)
    n_diff = n_all = 0
    for f in range(pl.g.n_feat):
        got = np.asarray(jax.jit(sc.int_densities, static_argnums=1)(xj, f))
        want = reference64.parity_densities(x, pl.g, slices, f)
        n_diff += int((got != want).sum())
        n_all += got.size
    got = np.asarray(sc.score(xj))
    want = reference64.parity_scores(x, pl.g, raw, slices, topn=sc.topn)
    step = sc.scale
    # A density truncated on the other side of an integer moves a top-N
    # value by one unit; after the >>shift at most one quantization step
    # per stream.
    tol = pl.g.n_feat * step
    err = float(np.abs(got - want).max())
    emit("scorer", scorer="PsParityScorer", frames=len(x),
         int_densities_differing=n_diff, int_densities=n_all,
         max_abs_err=err, tol=tol,
         senone_scores_differing=int((np.abs(got - want) > 1e-3).sum()))
    assert err <= tol, err

    lnw = read_sendump(os.path.join(seeded.sc, "sendump"))
    semi = SemiContinuousScorer(pl.g, lnw, slices, topn=0)
    got = np.asarray(jax.jit(semi.score)(xj))
    want = reference64.semi_scores(x, pl.g, lnw, slices)
    err = float(np.abs(got - want).max())
    tol = 1e-3 * float(np.abs(want).max())   # f32 expanded form, |d| ~ 1e3
    emit("scorer", scorer="SemiContinuousScorer", frames=len(x),
         max_abs_err=err, tol=tol)
    assert err <= tol, err

    # Continuous, every precision mode.
    pc = Planter(seeded, "cont", "words")
    x = np.concatenate([f for _, f in pc.batch(rng, 1, 2.0, 2.0)])[:200]
    xj = jnp.asarray(x)
    lnw = np.log(pc.w).astype(np.float32)
    want, mag = reference64.cont_scores(x, pc.g, lnw)
    floored = pc.g.var[:, 0].min(-1).min(-1) <= 1.01e-4     # [S]
    for prec in GEMM_PRECISIONS:
        cs = ContinuousScorer(pc.g, lnw, precision=prec)
        got = np.asarray(jax.jit(cs.score)(xj))
        err = np.abs(got - want)
        bound = reference64.REL_BOUND[prec] * mag
        emit("scorer", scorer="ContinuousScorer", gmmprec=prec,
             frames=len(x), max_abs_err=float(err.max()),
             max_abs_err_floored_senones=float(err[:, floored].max()),
             max_magnitude=float(mag.max()),
             max_err_over_bound=float((err / bound).max()))
        assert np.isfinite(got).all()
        assert (err <= bound).all(), (prec, float(err.max()))

    # What the Precision enum lowers to: the largest error of the expanded
    # GEMM relative to its magnitude, as a count of mantissa bits.
    wa = np.asarray(ContinuousScorer(pc.g, lnw).w)
    xa = np.concatenate([x, x * x], 1)
    exact = xa.astype(np.float64) @ wa.astype(np.float64)
    scale = np.abs(xa).astype(np.float64) @ np.abs(wa).astype(np.float64)
    probe = {}
    for name in ("DEFAULT", "HIGH", "HIGHEST"):
        p = getattr(jax.lax.Precision, name)
        got = np.asarray(jax.jit(lambda a, b: jnp.dot(a, b, precision=p))(
            jnp.asarray(xa), jnp.asarray(wa)))
        rel = float((np.abs(got - exact) / np.maximum(scale, 1e-30)).max())
        probe[name] = {"max_rel_err": rel,
                       "bits": float(-np.log2(max(rel, 1e-30)))}
    emit("precision_probe", gemm="[200,78]x[78,S*K] f32", **probe)


def phase_decode(seeded):
    from seeded import Planter
    from cmusphinx_tpu.api import Decoder

    configs = [
        ("a", "sc", "digits", {}),
        ("b", "sc", "words", dict(lexmode="tree", rcmode="composite",
                                  lcmode="composite")),
        ("c", "cont", "words", dict(lexmode="flat", rcmode="composite",
                                    lcmode="composite")),
    ]
    for name, model, lex, kw in configs:
        dic, lm = seeded.lexicon(lex)
        t0 = time.perf_counter()
        d = Decoder(hmm=seeded.sc if model == "sc" else seeded.cont,
                    lm=lm, dict=dic, **kw)
        build = time.perf_counter() - t0
        utts = Planter(seeded, model, lex).batch(
            np.random.default_rng(SEED + 10), 16, 2.0, 6.0)
        feats = [f for _, f in utts]
        audio = sum(len(f) for f in feats) / 100.0
        first, steady, hyps = timed(lambda: d.search.decode_batch(feats))
        n_ok = sum(h.words == w for h, (w, _) in zip(hyps, utts))
        emit("decode", config=name, scorer=type(d.scorer).__name__,
             words=d.search.vocab.n_word, rcmode=d.search.rc_mode,
             lexmode=d.search.graph.lex_mode,
             channels=int(d.search.graph.n_chan),
             scan_core=d.search.scan_core(), utterances=len(utts),
             audio_s=audio, correct=n_ok, build_s=build,
             first_call_s=first, compile_s=first - steady, steady_s=steady,
             xrt=audio / steady)
        assert n_ok == len(utts), [
            (h.words, w) for h, (w, _) in zip(hyps, utts) if h.words != w]


def training_set(seeded, n_utts: int = 16, seconds: float = 5.0):
    """The Trainer's inputs at production size: CD units of 39 phones x 44
    context classes + SIL (5,151 senones), 32 Gaussians, features planted
    from the continuous model along 5k-word sentences of ~500 frames."""
    from seeded import PHONES, SIL, Planter
    from cmusphinx_tpu.train.sentence_hmm import FlatModel

    pc = Planter(seeded, "cont", "words")
    utts = pc.batch(np.random.default_rng(SEED + 20), n_utts, seconds,
                    seconds)
    ctx = {p: i for i, p in enumerate(PHONES + [SIL])}
    model = FlatModel.create([SIL] + [f"{p}_{c}" for p in PHONES
                                      for c in range(44)])
    pron = {}
    for words, _ in utts:
        for w in words:
            ph = [pc.mdef.ciname[p] for p in pc.dict.pron[pc.dict.wordid(w)]]
            pad = [SIL] + ph + [SIL]
            pron[w] = [f"{p}_{(ctx[pad[i]] * 40 + ctx[pad[i + 2]]) % 44}"
                       for i, p in enumerate(ph)]
    return model, pron, [w for w, _ in utts], [f for _, f in utts]


def phase_train(seeded, **size):
    from cmusphinx_tpu.train.trainer import Trainer

    model, pron, trans, feats = training_set(seeded, **size)
    t0 = time.perf_counter()
    tr = Trainer(model, pron, trans, feats, K=32)
    setup = time.perf_counter() - t0
    lls, ts = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        lls.append(tr.em_step())
        ts.append(time.perf_counter() - t0)
    frames = int(sum(len(f) for f in feats))
    emit("train", senones=model.n_sen, gaussians=32, utterances=len(feats),
         frames=frames, per_frame_ll=lls, setup_s=setup, step_s=ts,
         frames_per_s=frames / float(np.median(ts[1:])))
    assert np.isfinite(lls).all(), lls
    # EM never lowers the likelihood; allow float32 summation noise.
    assert all(b >= a - 1e-5 * abs(a) for a, b in zip(lls, lls[1:])), lls


def phase_multi(seeded, devices, **size):
    from jax.sharding import Mesh
    from seeded import Planter
    from cmusphinx_tpu.api import Decoder
    from cmusphinx_tpu.train.trainer import Trainer

    mesh = Mesh(np.array(devices), ("dp",))
    model, pron, trans, feats = training_set(seeded, **size)
    one = Trainer(model, pron, trans, feats, K=32)
    dp = Trainer(model, pron, trans, feats, K=32)
    ll1, ll4 = one.em_step(), dp.em_step_sharded(mesh)
    rel = {}
    for k in ("means", "var", "lnw", "tp"):
        a, b = getattr(one.params, k), getattr(dp.params, k)
        rel[k] = float(np.abs(a - b).max() / np.abs(a).max())
    # Accumulators are f32 sums over ~8,000 frames taken in another order
    # across devices: 1e-4 of the largest parameter.
    emit("multi_train", devices=len(devices), per_frame_ll_1=ll1,
         per_frame_ll_dp=ll4, max_rel_param_diff=rel, tol=1e-4)
    assert abs(ll1 - ll4) <= 1e-4 * abs(ll1), (ll1, ll4)
    assert max(rel.values()) <= 1e-4, rel

    d = Decoder(hmm=seeded.sc, lm=seeded.words_lm, dict=seeded.words_dic,
                lexmode="tree", rcmode="composite", lcmode="composite")
    utts = Planter(seeded, "sc", "words").batch(
        np.random.default_rng(SEED + 10), 16, 2.0, 6.0)
    feats = [f for _, f in utts]
    audio = sum(len(f) for f in feats) / 100.0
    f1, s1, h1 = timed(lambda: d.search.decode_batch(feats))
    f4, s4, h4 = timed(lambda: d.search.decode_batch(feats, mesh=mesh))
    same = sum(a.words == b.words for a, b in zip(h1, h4))
    n_ok = sum(h.words == w for h, (w, _) in zip(h4, utts))
    emit("multi_decode", config="b", devices=len(devices),
         utterances=len(utts), identical_to_1=same, correct=n_ok,
         xrt_1=audio / s1, xrt_dp=audio / s4, first_call_dp_s=f4)
    assert same == len(utts) and n_ok == len(utts)


def main() -> int:
    ap = argparse.ArgumentParser(description="GPU bring-up check")
    ap.add_argument("--multi", action="store_true",
                    help="four GPUs: data-parallel EM and decode only")
    args = ap.parse_args()

    import jax
    devices = jax.devices()
    if devices[0].platform != "gpu":
        sys.exit(f"chip_smoke.py needs a GPU; JAX found "
                 f"{devices[0].platform!r}")
    need = 4 if args.multi else 1
    if len(devices) < need:
        sys.exit(f"chip_smoke.py needs {need} GPUs; JAX found {len(devices)}")
    from cmusphinx_tpu.utils.compile_cache import init_compile_cache
    from seeded import write_models

    cache = init_compile_cache()
    smi = nvidia_smi()
    name, limit = smi[0].rsplit(",", 1)
    CARD.update(card=name.strip(), power_limit=limit.strip())
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        seeded = write_models(tmp, SEED)
        emit("setup", models_s=time.perf_counter() - t0,
             compile_cache=cache, jax=jax.__version__)
        if args.multi:
            phase_multi(seeded, devices[:4])
        else:
            phase_frontend(seeded)
            phase_scorers(seeded)
            phase_decode(seeded)
            phase_train(seeded)
    print("nvidia-smi: " + " | ".join(smi))
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
