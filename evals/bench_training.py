"""Training-throughput benchmark: Baum-Welch at production model size —
frames/sec per device, FLOP rate, and the collective share of the
psum-reduced data-parallel EM step.

Model: synthetic hub4-class 5,000 senones x 32 Gaussians (the repo's
shipped corpora top out at 335 senones); observations are REAL
tidigits feature frames tiled to utterance length so the densities see
speech statistics, with synthetic linear-chain sentence HMMs of
hub4-transcript size.  The restructured forward_backward (train/bw.py
state_logliks: per-state gathered params + GEMM accumulation) makes this
size feasible — the old all-senone form would materialize [T, 5000, 32]
per utterance.

    python evals/bench_training.py              # one-device throughput
    python evals/bench_training.py --scaling    # 1->8 virtual-device CPU
                                                # mesh collective share
                                                # (SURVEY §4 multi-node
                                                # testing)
"""

import argparse
import os
import sys
import time
from types import SimpleNamespace

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np

N_SEN, K, N_TMAT = 5000, 32, 40
N_STATE = 3


def synth_hmm(rng, n_phones: int):
    """Linear-chain sentence HMM (SIL w1 .. wn SIL shape) with random
    senone/tmat assignment into the production-size inventory."""
    S = n_phones * N_STATE
    state_sen = rng.randint(0, N_SEN, S).astype(np.int32)
    state_phone = np.repeat(np.arange(n_phones), N_STATE).astype(np.int32)
    state_word = np.repeat(rng.randint(0, 13, n_phones), N_STATE).astype(
        np.int32)
    tmat = rng.randint(0, N_TMAT, n_phones)
    esrc, edst, etm, eti, etj = [], [], [], [], []
    for p in range(n_phones):
        base = p * N_STATE
        for i in range(N_STATE):
            for j in (i, i + 1, i + 2):
                if j < N_STATE:
                    esrc.append(base + i); edst.append(base + j)
                    etm.append(tmat[p]); eti.append(i); etj.append(j)
            # cross-phone arcs out of exit-capable states
        if p + 1 < n_phones:
            esrc.append(base + N_STATE - 1); edst.append(base + N_STATE)
            etm.append(tmat[p]); eti.append(N_STATE - 1); etj.append(N_STATE)
    entry_lp = np.full(S, -1e30, np.float32)
    entry_lp[0] = 0.0
    return SimpleNamespace(
        state_sen=state_sen, state_phone=state_phone, state_word=state_word,
        entry_lp=entry_lp,
        esrc=np.asarray(esrc, np.int32), edst=np.asarray(edst, np.int32),
        etmat=np.asarray(etm, np.int32), eti=np.asarray(eti, np.int32),
        etj=np.asarray(etj, np.int32),
        fsrc=np.asarray([S - 1], np.int32),
        ftm=np.asarray([tmat[-1]], np.int32),
        fti=np.asarray([N_STATE - 1], np.int32))


def build(B=16, T=500, n_phones=60, seed=0):
    from cmusphinx_tpu.frontend.fe import FE_ARGS
    from cmusphinx_tpu.frontend.feat import FEAT_ARGS, FeatPipeline
    from cmusphinx_tpu.train.bw import pack_batch
    from cmusphinx_tpu.utils.bio import read_mfc
    from cmusphinx_tpu.utils.config import Config
    rng = np.random.RandomState(seed)
    R = "/root/reference/pocketsphinx"
    cfg = Config(FE_ARGS, FEAT_ARGS)
    cfg.update_from_file(R + "/model/hmm/en/tidigits/feat.params")
    fp = FeatPipeline(cfg)
    ctl = [l.strip() for l in open(R + "/test/data/tidigits/tidigits.ctl")
           if l.strip()]
    real = np.concatenate(
        [np.asarray(fp.compute(read_mfc(R + f"/test/data/tidigits/{u}.mfc")))
         for u in ctl])
    D = real.shape[1]
    feats, hmms = [], []
    for b in range(B):
        lo = rng.randint(0, max(len(real) - T, 1))
        f = real[lo : lo + T]
        if len(f) < T:
            f = np.concatenate([f] * (T // max(len(f), 1) + 1))[:T]
        feats.append(np.asarray(f, np.float32))
        hmms.append(synth_hmm(rng, n_phones))
    batch = pack_batch(hmms, feats)
    means = rng.randn(N_SEN, K, D).astype(np.float32) * 2.0
    var = (0.5 + rng.rand(N_SEN, K, D)).astype(np.float32)
    lnw = np.log(np.full((N_SEN, K), 1.0 / K, np.float32))
    tp = np.zeros((N_TMAT, N_STATE, N_STATE + 1), np.float32)
    tp[:, :, :] = 1e-10
    for i in range(N_STATE):
        tp[:, i, i] = 0.5
        tp[:, i, i + 1] = 0.5
    log_tp = np.log(tp)
    return batch, means, var, lnw, log_tp, D


def bw_flops(B, T, Smax, K, D, n_edges):
    """Model FLOPs of one forward-backward pass (mult-add = 2):
    density einsums (2x), weighted-obs accumulation einsums (2x), the
    alpha/beta logsumexp scans, and the xi edge pass."""
    gemms = 8.0 * B * T * Smax * K * D          # 4 einsums x 2 FLOP/MAC
    scans = 2.0 * B * T * Smax * Smax * 3.0     # fwd+bwd logsumexp matms
    post = 6.0 * B * T * Smax * K
    xi = 6.0 * B * T * n_edges
    return gemms + scans + post + xi


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--scaling", action="store_true",
                    help="1->8 virtual-device dp scaling efficiency (CPU)")
    ap.add_argument("-B", type=int, default=16)
    ap.add_argument("-T", type=int, default=500)
    ap.add_argument("--phones", type=int, default=60)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if args.cpu or args.scaling:
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_force_host_platform_device_count=8")
        import jax
        jax.config.update("jax_platforms", "cpu")
    import jax
    import jax.numpy as jnp
    from cmusphinx_tpu.train.bw import forward_backward
    from cmusphinx_tpu.utils import mfu

    batch, means, var, lnw, log_tp, D = build(args.B, args.T, args.phones)
    Smax = batch.state_sen.shape[1]
    n_edges = batch.esrc.shape[1]
    prec = (0.5 / var).astype(np.float32)
    margs = (jnp.asarray(means), jnp.asarray(prec), jnp.asarray(lnw),
             jnp.asarray(log_tp))
    print(f"model: {N_SEN} senones x {K} Gaussians x {D} dims "
          f"({N_SEN * K * D * 4 / 1e6:.0f} MB means); batch {args.B} utts "
          f"x {args.T} frames, {Smax} states/utt", flush=True)

    fb = jax.jit(forward_backward)
    llh, acc = fb(batch, *margs)
    jax.block_until_ready(acc["mean"])
    assert np.isfinite(np.asarray(llh)).all()
    ts = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        llh, acc = fb(batch, *margs)
        jax.block_until_ready(acc["mean"])
        ts.append(time.perf_counter() - t0)
    dt = sorted(ts)[len(ts) // 2]
    frames = args.B * args.T
    fl = bw_flops(args.B, args.T, Smax, K, D, n_edges)
    peaks = mfu.device_peaks(jax.devices()[0])
    print(f"\nsteady {dt * 1e3:.1f} ms/step = {frames / dt:,.0f} "
          f"frames/sec/device ({frames / dt / 100:,.0f}x RT audio)")
    print(f"FLOPs {fl / 1e9:.1f} GFLOP -> {fl / dt / 1e12:.2f} TFLOP/s"
          + (f" = {100 * fl / dt / peaks.fp32:.2f}% of the fp32 peak"
             if peaks else ""))

    if args.scaling:
        # Virtual CPU devices share the host's cores, so dp wall-clock
        # cannot show real speedup here (SURVEY §4: virtual-mesh testing
        # validates the CONTRACT; speed belongs to real devices).  What CAN
        # be measured is the collective's share of the step: run dp=8
        # with the accumulator psum on vs off.
        from jax.sharding import Mesh
        from jax import shard_map
        from jax.sharding import PartitionSpec as P
        from cmusphinx_tpu.train.bw import UttBatch
        devs = jax.devices()
        ndp = min(8, len(devs))
        fields = {k: jnp.asarray(getattr(batch, k))
                  for k in batch.__dataclass_fields__}
        mesh = Mesh(np.array(devs[:ndp]), ("dp",))
        times = {}
        for use_psum in (True, False):
            def shard_fn(bf, _p=use_psum):
                sb = UttBatch(**bf)
                llh, acc = forward_backward(sb, *margs)
                if _p:
                    acc = {k: jax.lax.psum(v, "dp")
                           for k, v in acc.items()}
                    return jax.lax.psum(jnp.sum(llh), "dp"), acc
                return jnp.sum(llh)[None], {k: v[None]
                                            for k, v in acc.items()}

            fn = jax.jit(shard_map(
                shard_fn, mesh=mesh,
                in_specs=({k: P("dp") for k in fields},),
                out_specs=(P() if use_psum else P("dp"),
                           {k: (P() if use_psum else P("dp")) for k in
                            ("mixw", "mean", "var", "tmat", "n_frames")})))
            tot, acc = fn(fields)
            jax.block_until_ready(acc["mean"])
            ts = []
            for _ in range(3):
                t0 = time.perf_counter()
                tot, acc = fn(fields)
                jax.block_until_ready(acc["mean"])
                ts.append(time.perf_counter() - t0)
            times[use_psum] = sorted(ts)[1]
        share = max(times[True] - times[False], 0.0) / times[True]
        print(f"\ndp={ndp} virtual mesh: step {times[True]*1e3:.0f} ms "
              f"with psum, {times[False]*1e3:.0f} ms without -> "
              f"collective share {100*share:.1f}% (host-emulated upper "
              "bound; device links are far faster than host memcpy)")
    return 0


if __name__ == "__main__":
    from cmusphinx_tpu.utils.compile_cache import init_compile_cache
    init_compile_cache()
    sys.exit(main())
