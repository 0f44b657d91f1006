"""FLOP/byte accounting and MFU (model FLOPs utilization) reporting.

The reference never reports hardware utilization (xRT only, SURVEY §5/§6).
Every hot stage gets an analytic FLOP and device-memory byte count here, and
evals/mfu_report.py divides measured wall time into them (PERF.md "stage |
ms | GFLOP | MFU").

Peaks are keyed by `device_kind` (`jax.devices()[0].device_kind`).  A kind
the table does not know is an error, never a default; on the CPU there is
no peak and no MFU is reported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional


@dataclass(frozen=True)
class Peaks:
    """Dense rates without sparsity, FLOP/s; memory bandwidth, bytes/s."""
    bf16: float
    tf32: float
    fp32: float
    hbm_bw: float
    source: str


# NVIDIA H100 data sheet (dense rates; the SXM rates assume the 700 W limit).
PEAKS = {
    "NVIDIA H100 80GB HBM3": Peaks(989e12, 495e12, 67e12, 3.35e12,
                                   "NVIDIA H100 data sheet, SXM5"),
    "NVIDIA H100 PCIe": Peaks(756e12, 378e12, 51e12, 2.0e12,
                              "NVIDIA H100 data sheet, PCIe"),
}


def device_peaks(device) -> Optional[Peaks]:
    """Peaks of a JAX device; None on the CPU; KeyError for an accelerator
    kind the table does not hold."""
    if device.platform == "cpu":
        return None
    try:
        return PEAKS[device.device_kind]
    except KeyError:
        raise KeyError(f"no published peaks for device kind "
                       f"{device.device_kind!r}; add them to "
                       f"cmusphinx_tpu/utils/mfu.py PEAKS") from None


# ----------------------------------------------------------------------
# Analytic FLOP counts (multiply-add = 2 FLOPs).

def continuous_gmm_flops(T: int, S: int, K: int, D: int) -> float:
    """ContinuousScorer: the [T, 2D] @ [2D, S*K]
    GEMM (linear + quadratic term) + the elementwise square, bias and
    logsumexp reduction (ops/gmm.py ContinuousScorer)."""
    gemm = 2 * 2.0 * T * D * S * K
    elem = T * D + 3.0 * T * S * K   # x*x, add const, exp+max+sum
    return gemm + elem


def continuous_gmm_bytes(T: int, S: int, K: int, D: int) -> float:
    """Device-memory traffic: params + feats + output, and the [T, S*K]
    density matrix written by the GEMM and read back by the
    log-sum-exp."""
    return 4.0 * (2 * S * K * D + S * K        # lin/quad + const
                  + 2 * T * D                  # feats + feats^2
                  + T * S                      # output
                  + 2 * T * S * K)             # density round trip


def psparity_flops(T: int, n_feat: int, n_density: int,
                   veclens, n_sen: int, topn: int) -> float:
    """Semi-continuous 8-bit parity scorer (ops/gmm.py PsParityScorer):
    per stream a [T, D_s] @ [D_s, n_density] density GEMM, the top-N
    argmax selection, and the senone logadd over topn x n_sen 8-bit
    mixture weights (s2_semi_mgau.c:81-530 capability)."""
    f = 0.0
    for d in veclens:
        f += 2.0 * T * int(d) * n_density      # density GEMM
        f += 4.0 * topn * T * n_density        # topn argmax rounds
        f += 3.0 * T * topn * n_sen            # logadd table stage
    return f


def viterbi_scan_bytes(T: int, C: int, S: int, B: int = 1,
                       planes: int = 2, n_rcvar: int = 1) -> float:
    """Device-memory traffic model of the dense Viterbi scan: per frame the carry
    planes (alpha + payload, [B, S, C] each) are read+written, the
    pre-expanded senone block is read, and the propagation gathers read
    the exit rows.  4 bytes/element."""
    per_frame = (planes * 2.0 * B * S * C      # carry r/w
                 + B * S * C                   # senone block read
                 + planes * B * C)             # propagation gather reads
    return 4.0 * T * per_frame


def onehot_scan_flops(T: int, tables_elems: float, B: int = 1) -> float:
    """One-hot matmul gathers in the small-graph scan cores: each gathered
    element costs a dot-product row (ngram_search.py _make_core)."""
    return 2.0 * T * B * tables_elems


# ----------------------------------------------------------------------
@dataclass
class Stage:
    name: str
    seconds: float
    flops: float = 0.0
    bytes: float = 0.0
    note: str = ""


def report(stages: List[Stage], peaks: Optional[Peaks]) -> str:
    """Markdown table: stage | ms | GFLOP | GB, plus MFU against the bf16
    and fp32 peaks and memory-bandwidth utilization when `peaks` is given
    (an accelerator); without peaks (the CPU) no utilization is printed."""
    head = "| stage | ms | GFLOP | GB |"
    if peaks:
        head += " MFU (bf16 peak) | MFU (fp32 peak) | HBM util |"
    out = [head, "|" + "---|" * (head.count("|") - 1)]
    for s in stages:
        dt = max(s.seconds, 1e-12)
        row = (f"| {s.name} | {s.seconds * 1e3:.2f} | {s.flops / 1e9:.2f} | "
               f"{s.bytes / 1e9:.2f} |")
        if peaks:
            row += (f" {100 * s.flops / dt / peaks.bf16:.3f}% |"
                    f" {100 * s.flops / dt / peaks.fp32:.2f}% |"
                    f" {100 * s.bytes / dt / peaks.hbm_bw:.1f}% |")
        out.append(row + (f" {s.note}" if s.note else ""))
    return "\n".join(out)
