"""Gaussian codebook parameters (s3 `means` / `variances` files).

Reader for the format consumed by ms_gauden.c:179 `gauden_param_read`
(reference: pocketsphinx/src/libpocketsphinx/ms_gauden.c): s3 header, then
int32 n_mgau, n_feat, n_density, veclen[n_feat], total float count, and the
flat float32 parameter block laid out [n_mgau][n_feat][n_density][veclen_f].

On load we precompute what the device scoring kernels need (dense float32
arrays, padded across streams to max veclen):

- means  [n_mgau, n_feat, n_density, maxlen]
- prec   [n_mgau, n_feat, n_density, maxlen]  (0.5 / var, zero in padding)
- lrd    [n_mgau, n_feat, n_density]          log reciprocal sqrt((2pi)^d |var|)

so the log Gaussian density is `lrd - sum(prec * (x - mean)^2)` — a fused
multiply-add reduction that becomes matrix products via the identity
sum(prec*(x-m)^2) = sum(prec*x^2) - 2*sum(prec*m*x) + sum(prec*m^2)
(see ops/gmm.py).  Variance flooring matches gauden_dist_precompute
(ms_gauden.c:304): var < floor -> floor.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..utils.bio import S3File


@dataclass
class GaussianParams:
    means: np.ndarray      # [n_mgau, n_feat, n_density, maxlen] float32
    var: np.ndarray        # floored variances, same shape
    prec: np.ndarray       # 0.5 / var (0 in padded dims)
    lrd: np.ndarray        # [n_mgau, n_feat, n_density] float32 log det term
    veclen: List[int]
    n_mgau: int
    n_feat: int
    n_density: int

    @property
    def maxlen(self) -> int:
        return self.means.shape[-1]


def _read_gau_file(path: str):
    with S3File.open(path) as s3:
        n_mgau = int(s3.read_int32(1)[0])
        n_feat = int(s3.read_int32(1)[0])
        n_density = int(s3.read_int32(1)[0])
        veclen = [int(v) for v in s3.read_int32(n_feat)]
        n = int(s3.read_int32(1)[0])
        blk = sum(veclen)
        if n != n_mgau * n_density * blk:
            raise ValueError(f"{path}: float count {n} != {n_mgau}x{n_density}x{blk}")
        data = s3.read_float32(n)
        s3.verify_chksum()
    return n_mgau, n_feat, n_density, veclen, data


def read_gauden(means_path: str, vars_path: str, varfloor: float = 0.0001) -> GaussianParams:
    n_mgau, n_feat, n_density, veclen, mdata = _read_gau_file(means_path)
    vm, vf, vd, vveclen, vdata = _read_gau_file(vars_path)
    if (vm, vf, vd, vveclen) != (n_mgau, n_feat, n_density, veclen):
        raise ValueError("means/variances dimension mismatch")

    maxlen = max(veclen)
    means = np.zeros((n_mgau, n_feat, n_density, maxlen), np.float32)
    var = np.zeros_like(means)
    # Unpack the ragged layout: [n_mgau][n_feat][n_density][veclen_f]
    # (feature-major inside each codebook, per gauden_param_read).
    blk_per_mgau = n_density * sum(veclen)
    mdata = mdata.reshape(n_mgau, blk_per_mgau)
    vdata = vdata.reshape(n_mgau, blk_per_mgau)
    pos = 0
    for f, ln in enumerate(veclen):
        seg = n_density * ln
        means[:, f, :, :ln] = mdata[:, pos : pos + seg].reshape(n_mgau, n_density, ln)
        var[:, f, :, :ln] = vdata[:, pos : pos + seg].reshape(n_mgau, n_density, ln)
        pos += seg

    # Variance flooring + log determinant (gauden_dist_precompute).
    var = np.maximum(var, varfloor).astype(np.float32)
    prec = np.zeros_like(var)
    lrd = np.zeros((n_mgau, n_feat, n_density), np.float32)
    for f, ln in enumerate(veclen):
        v = var[:, :, :, :ln][:, f]
        prec[:, f, :, :ln] = 1.0 / (2.0 * v)
        lrd[:, f] = -0.5 * (np.log(v).sum(axis=-1) + ln * math.log(2.0 * math.pi))
    # Zero out padding (so padded dims contribute nothing).
    for f, ln in enumerate(veclen):
        prec[:, f, :, ln:] = 0.0
        means[:, f, :, ln:] = 0.0

    return GaussianParams(means=means, var=var, prec=prec, lrd=lrd,
                          veclen=veclen, n_mgau=n_mgau, n_feat=n_feat,
                          n_density=n_density)
