"""Training orchestration: EM loop, reestimation, checkpointing, scale-out.

Capability parity with SphinxTrain's norm + the scripts_pl convergence loop
(reference: SphinxTrain/src/programs/norm/main.c summing bw accumulator
dirs and reestimating via gauden_norm_wt_mean/var gauden.c:1568-1795;
scripts_pl/20.ci_hmm/slave_convg.pl:59-136 likelihood-ratio convergence;
bw/main.c:464-485 -ckptintv accumulator+cursor checkpointing) — on devices:

- parts are device shards, not forked jobs: the utterance batch is split
  over a mesh `dp` axis with shard_map and accumulators psum'd across it
  (SURVEY.md §2.10 P1/P2/P8 — the psum IS the `norm` file summation);
- checkpoints are npz files of the parameter pytree + corpus cursor;
- flat start (init_gau/mk_flat capability): global mean/variance plus
  deterministic small perturbations per component.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .bw import UttBatch, forward_backward, pack_batch
from .sentence_hmm import FlatModel, SentHmm, build_sentence_hmm

MIXW_FLOOR = 1e-5
VAR_FLOOR = 1e-4
TMAT_FLOOR = 1e-4


@dataclass
class HmmParams:
    """Trainable parameter set (continuous diagonal GMMs per senone)."""
    means: np.ndarray   # [n_sen, K, D]
    var: np.ndarray     # [n_sen, K, D]
    lnw: np.ndarray     # [n_sen, K] log mixture weights
    tp: np.ndarray      # [n_tmat, n, n+1] probabilities

    @property
    def prec(self) -> np.ndarray:
        return (0.5 / self.var).astype(np.float32)

    @property
    def log_tp(self) -> np.ndarray:
        with np.errstate(divide="ignore"):
            return np.where(self.tp > 0, np.log(np.maximum(self.tp, 1e-30)),
                            -1.0e30).astype(np.float32)


def flat_start(model: FlatModel, feats: Sequence[np.ndarray], K: int = 1,
               seed: int = 0) -> HmmParams:
    """Global-stats initialization (init_gau + norm capability), with small
    deterministic mean perturbations to break component symmetry."""
    allf = np.concatenate([np.asarray(f) for f in feats])
    gm = allf.mean(0)
    gv = allf.var(0) + VAR_FLOOR
    D = allf.shape[1]
    rng = np.random.RandomState(seed)
    means = np.tile(gm, (model.n_sen, K, 1)).astype(np.float32)
    if K > 1:
        means += (rng.randn(model.n_sen, K, D) * 0.1 *
                  np.sqrt(gv)[None, None, :]).astype(np.float32)
    var = np.tile(gv, (model.n_sen, K, 1)).astype(np.float32)
    lnw = np.full((model.n_sen, K), -np.log(K), np.float32)
    return HmmParams(means=means, var=var, lnw=lnw,
                     tp=model.init_tmat().astype(np.float32))


def reestimate(params: HmmParams, acc: Dict[str, np.ndarray]) -> HmmParams:
    """norm: accumulators -> new parameters (gauden_norm_wt_mean/var)."""
    occ = np.asarray(acc["mixw"])          # [n_sen, K]
    mean_acc = np.asarray(acc["mean"])     # [n_sen, K, D]
    var_acc = np.asarray(acc["var"])
    denom = np.maximum(occ, 1e-10)[..., None]
    new_means = mean_acc / denom
    # var = E[x^2] - mean^2, floored (gauden.c:1668 norm_wt_var).
    new_var = var_acc / denom - new_means ** 2
    new_var = np.maximum(new_var, VAR_FLOOR)
    # Untouched senones keep their old parameters.
    seen = occ.sum(-1) > 1e-8              # [n_sen]
    new_means = np.where(seen[:, None, None], new_means, params.means)
    new_var = np.where(seen[:, None, None], new_var, params.var)
    w = occ / np.maximum(occ.sum(-1, keepdims=True), 1e-10)
    w = np.maximum(w, MIXW_FLOOR)
    w /= w.sum(-1, keepdims=True)
    lnw = np.where(seen[:, None], np.log(w), params.lnw)
    tacc = np.asarray(acc["tmat"])
    tsum = tacc.sum(-1, keepdims=True)
    tp = np.where(tsum > 1e-8, tacc / np.maximum(tsum, 1e-10), params.tp)
    # Floor only topologically-allowed transitions (tmat.c semantics).
    allowed = params.tp > 0
    tp = np.where(allowed, np.maximum(tp, TMAT_FLOOR), 0.0)
    tp /= np.maximum(tp.sum(-1, keepdims=True), 1e-10)
    return HmmParams(means=new_means.astype(np.float32),
                     var=new_var.astype(np.float32),
                     lnw=lnw.astype(np.float32), tp=tp.astype(np.float32))


class Trainer:
    """Baum-Welch EM over a corpus of (transcript, features) pairs."""

    def __init__(self, model: FlatModel, pron: Dict[str, List[str]],
                 transcripts: Sequence[Sequence[str]],
                 feats: Sequence[np.ndarray], K: int = 1,
                 ckpt_dir: Optional[str] = None):
        self.model = model
        hmms = [build_sentence_hmm(t, pron, model) for t in transcripts]
        self.batch = pack_batch(hmms, [np.asarray(f) for f in feats])
        self.params = flat_start(model, feats, K=K)
        self.ckpt_dir = ckpt_dir
        self.iteration = 0
        self.history: List[float] = []
        self._fb = jax.jit(forward_backward)

    # ------------------------------------------------------------------
    def em_step(self) -> float:
        """One full-corpus EM iteration; returns mean per-frame log-lik."""
        llh, acc = self._fb(self.batch, jnp.asarray(self.params.means),
                            jnp.asarray(self.params.prec),
                            jnp.asarray(self.params.lnw),
                            jnp.asarray(self.params.log_tp))
        acc = {k: np.asarray(v) for k, v in acc.items()}
        total_ll = float(np.asarray(llh).sum())
        per_frame = total_ll / max(int(acc["n_frames"]), 1)
        self.params = reestimate(self.params, acc)
        self.iteration += 1
        self.history.append(per_frame)
        if self.ckpt_dir:
            self.save_checkpoint()
        return per_frame

    def train(self, max_iter: int = 20, conv_ratio: float = 1e-3) -> List[float]:
        """slave_convg.pl loop: iterate until the likelihood improvement
        ratio falls below conv_ratio."""
        prev = None
        for _ in range(max_iter):
            ll = self.em_step()
            if prev is not None:
                denom = abs(prev) if prev else 1.0
                if (ll - prev) / denom < conv_ratio and ll >= prev:
                    break
            prev = ll
        return self.history

    # ------------------------------------------------------------------
    def save_checkpoint(self) -> str:
        os.makedirs(self.ckpt_dir, exist_ok=True)
        path = os.path.join(self.ckpt_dir, f"ckpt_{self.iteration:03d}.npz")
        np.savez(path, means=self.params.means, var=self.params.var,
                 lnw=self.params.lnw, tp=self.params.tp,
                 iteration=self.iteration,
                 history=np.asarray(self.history))
        return path

    @staticmethod
    def load_checkpoint(path: str) -> Tuple[HmmParams, int, List[float]]:
        z = np.load(path)
        params = HmmParams(means=z["means"], var=z["var"], lnw=z["lnw"],
                           tp=z["tp"])
        return params, int(z["iteration"]), list(z["history"])

    # ------------------------------------------------------------------
    def em_step_sharded(self, mesh) -> float:
        """Data-parallel EM step over a device mesh: utterances sharded on
        the 'dp' axis, accumulators psum'd (the collective form of 'norm
        over accumulator dirs')."""
        from jax.sharding import NamedSharding, PartitionSpec as P
        from jax import shard_map

        b = self.batch
        ndp = mesh.shape["dp"]
        B = b.feats.shape[0]
        pad = (-B) % ndp
        def padb(a):
            if pad == 0:
                return a
            return np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])
        fields = {k: padb(getattr(b, k)) for k in b.__dataclass_fields__}
        # Padded rows have T=0 -> no frames, no counts.
        bp = UttBatch(**fields)

        means, prec = jnp.asarray(self.params.means), jnp.asarray(self.params.prec)
        lnw, log_tp = jnp.asarray(self.params.lnw), jnp.asarray(self.params.log_tp)

        def shard_fn(batch_fields):
            sb = UttBatch(**batch_fields)
            llh, acc = forward_backward(sb, means, prec, lnw, log_tp)
            acc = {k: jax.lax.psum(v, "dp") for k, v in acc.items()}
            return jax.lax.psum(jnp.sum(llh), "dp"), acc

        specs = {k: P("dp") for k in fields}
        fn = shard_map(shard_fn, mesh=mesh,
                       in_specs=(specs,),
                       out_specs=(P(), {k: P() for k in
                                        ("mixw", "mean", "var", "tmat",
                                         "n_frames")}))
        total_ll, acc = fn({k: jnp.asarray(v) for k, v in fields.items()})
        acc = {k: np.asarray(v) for k, v in acc.items()}
        per_frame = float(total_ll) / max(int(acc["n_frames"]), 1)
        self.params = reestimate(self.params, acc)
        self.iteration += 1
        self.history.append(per_frame)
        return per_frame
