"""Trained-model export in Sphinx-3 formats.

Writers for the artifacts SphinxTrain's norm/mk_flat produce (reference:
SphinxTrain/src/libs/libio/{s3gau_io,s3mixw_io,s3tmat_io}.c, model_def_io.c;
formats in SURVEY.md §2.9) — so a model trained here round-trips through the
framework's own readers AND remains loadable by the reference decoders.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Sequence

import numpy as np

from .sentence_hmm import FlatModel
from .trainer import HmmParams


def _write_s3(path: str, version: str, body_arrays: List[np.ndarray],
              ints: List[int]) -> None:
    """s3 binary: header lines, endian magic, int32s, float32 payloads,
    checksum-free (chksum0)."""
    with open(path, "wb") as fh:
        fh.write(b"s3\n")
        fh.write(f"version {version}\n".encode())
        fh.write(b"chksum0 no\n")
        fh.write(b"endhdr\n")
        fh.write(struct.pack("<I", 0x11223344))
        for v in ints:
            fh.write(struct.pack("<i", v))
        for a in body_arrays:
            fh.write(np.ascontiguousarray(a, dtype="<f4").tobytes())


def write_gauden(means_path: str, vars_path: str, params: HmmParams) -> None:
    """s3gau format for one feature stream (continuous models)."""
    write_gauden_streams(means_path, vars_path, params.means[:, None],
                         params.var[:, None])


def write_gauden_streams(means_path: str, vars_path: str, means: np.ndarray,
                         var: np.ndarray) -> None:
    """s3gau format: n_mgau, n_feat, n_density, veclen[n_feat], count, then
    the block [n_mgau][n_feat][n_density][veclen] (streams of equal width,
    e.g. a semi-continuous model's single codebook set over 3 streams)."""
    M, F, K, D = means.shape
    ints = [M, F, K] + [D] * F + [M * F * K * D]
    _write_s3(means_path, "1.0", [means], ints)
    _write_s3(vars_path, "1.0", [var], ints)


def write_mixture_weights(path: str, params: HmmParams) -> None:
    """s3mixw format: [n_sen][n_feat=1][n_density] float32 counts."""
    S, K = params.lnw.shape
    w = np.exp(params.lnw).reshape(S, 1, K).astype(np.float32)
    _write_s3(path, "1.0", [w], [S, 1, K, S * K])


def write_tmat(path: str, params: HmmParams) -> None:
    """s3tmat format: [n_tmat][n_state][n_state+1] float32 probabilities."""
    M, n, n1 = params.tp.shape
    _write_s3(path, "1.0", [params.tp], [M, n, n1, M * n * n1])


def write_text_mdef(path: str, model: FlatModel) -> None:
    """Text mdef 0.3 with CI phones only (mk_mdef_gen CI capability)."""
    n = model.n_state
    npho = len(model.phones)
    with open(path, "w") as fh:
        fh.write("0.3\n")
        fh.write(f"{npho} n_base\n0 n_tri\n")
        fh.write(f"{npho * (n + 1)} n_state_map\n")
        fh.write(f"{npho * n} n_tied_state\n")
        fh.write(f"{npho * n} n_tied_ci_state\n")
        fh.write(f"{npho} n_tied_tmat\n")
        fh.write("#\n# Columns definitions\n"
                 "#base lft  rt p attrib tmat      ... state id's ...\n")
        for i, p in enumerate(model.phones):
            attrib = "filler" if p == "SIL" or (
                p.startswith("+") and p.endswith("+")) else "n/a"
            states = " ".join(str(model.senone(i, s)) for s in range(n))
            fh.write(f"{p:>8s} {'-':>4s} {'-':>4s} {'-':>2s} "
                     f"{attrib:>8s} {i:>4d}    {states} N\n")


def export_model(dirpath: str, model: FlatModel, params: HmmParams,
                 feat: str = "1s_c_d_dd") -> None:
    """Write a complete decodable model directory (mdef, means, variances,
    mixture_weights, transition_matrices, feat.params)."""
    os.makedirs(dirpath, exist_ok=True)
    write_text_mdef(os.path.join(dirpath, "mdef"), model)
    write_gauden(os.path.join(dirpath, "means"),
                 os.path.join(dirpath, "variances"), params)
    write_mixture_weights(os.path.join(dirpath, "mixture_weights"), params)
    write_tmat(os.path.join(dirpath, "transition_matrices"), params)
    with open(os.path.join(dirpath, "feat.params"), "w") as fh:
        fh.write(f"-feat {feat}\n-cmn current\n-agc none\n")
