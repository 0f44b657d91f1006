"""Signal frontend: waveform -> MFCC, batched on the device.

Capability parity with sphinxbase fe (reference:
sphinxbase/src/libsphinxbase/fe/fe_interface.c:203 `fe_init_auto_r`,
fe_sigproc.c:304 `fe_build_melfilters`, :430 `fe_compute_melcosine`,
:470 pre-emphasis, :535 Hamming window, :892 `fe_spec_magnitude`,
:937 `fe_mel_spec`, :1025 `fe_spec2cep` / :1045 `fe_dct2` / :1083 `fe_dct3`)
— but reformulated for an accelerator: the whole per-utterance pipeline is one fused
XLA program: global pre-emphasis, strided framing as a gather, window
multiply, batched rFFT, power spectrum, mel filterbank as a single
`[nbins, nfilt]` matmul, log, DCT as a `[nfilt, ncep]` matmul, liftering.
It runs batched over utterances and jit-compiles once per (nsamps) shape.

Numerical contract: matches the reference float build to ~1e-3 absolute on
cepstra (golden-tested against sphinxbase/test/regression/chan3.mfc).

Frame semantics (fe_interface.c:336 `fe_process_frames` + :507 `fe_end_utt`):
frame k covers samples [k*shift, k*shift + frame_size); an utterance of N
samples yields 1 + (N - frame_size)//shift full frames plus one final
zero-padded tail frame from `fe_end_utt`.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass, field
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.config import Arg, Config

# Defaults mirror sphinxbase/include/sphinxbase/fe.h:80-101 and the
# waveform_to_cepstral_command_line_macro arg table (fe.h:105-230).
FE_ARGS = [
    Arg("samprate", float, 16000.0, "Sampling rate"),
    Arg("frate", int, 100, "Frame rate"),
    Arg("wlen", float, 0.025625, "Hamming window length"),
    Arg("nfft", int, 512, "Size of FFT"),
    Arg("nfilt", int, 40, "Number of filter banks"),
    Arg("lowerf", float, 133.33334, "Lower edge of filters"),
    Arg("upperf", float, 6855.4976, "Upper edge of filters"),
    Arg("ncep", int, 13, "Number of cep coefficients"),
    Arg("alpha", float, 0.97, "Preemphasis parameter"),
    Arg("doublebw", bool, False, "Use double bandwidth filters (same center freq)"),
    Arg("lifter", int, 0, "Length of sin-curve for liftering, or 0 for no liftering"),
    Arg("unit_area", bool, True, "Normalize mel filters to unit area"),
    Arg("round_filters", bool, True, "Round mel filter frequencies to DFT points"),
    Arg("remove_dc", bool, False, "Remove DC offset from each frame"),
    Arg("dither", bool, False, "Add 1/2-bit noise"),
    Arg("seed", int, -1, "Seed for random number generator; if < 0, pick our own"),
    Arg("transform", str, "legacy", "Type of transform to calculate cepstra (legacy, dct, htk)"),
    Arg("logspec", bool, False, "Write out logspectral files instead of cepstra"),
    Arg("smoothspec", bool, False, "Write out cepstral-smoothed logspectral files"),
    Arg("warp_type", str, "inverse_linear", "Warping function type (inverse_linear, piecewise_linear, affine)"),
    Arg("warp_params", str, "", "Parameters defining the warping function"),
    Arg("input_endian", str, "little", "Endianness of input data"),
]


def _warp_unwarped_to_warped(warp_type: str, params: Tuple[float, ...], x: float,
                             nyquist: float) -> float:
    """VTLN warp (reference: fe_warp_{inverse_linear,affine,piecewise_linear}.c)."""
    if not params:
        return x
    if warp_type == "inverse_linear":
        a = params[0]
        return x if a == 0 or a == 1.0 else x / a
    if warp_type == "affine":
        a = params[0]
        b = params[1] if len(params) > 1 else 0.0
        if a == 1.0 and b == 0.0:
            return x
        return a * x + b
    if warp_type == "piecewise_linear":
        a = params[0]
        f0 = params[1] if len(params) > 1 else 0.875 * nyquist
        if a == 1.0:
            return x
        if x < f0:
            return a * x
        # Continuous linear section mapping [f0, nyquist] -> [a*f0, nyquist]
        if nyquist == f0:
            return a * x
        slope = (nyquist - a * f0) / (nyquist - f0)
        return a * f0 + slope * (x - f0)
    raise ValueError(f"unknown warp type {warp_type!r}")


def _warp_warped_to_unwarped(warp_type: str, params: Tuple[float, ...], y: float,
                             nyquist: float) -> float:
    if not params:
        return y
    if warp_type == "inverse_linear":
        a = params[0]
        return y if a == 0 or a == 1.0 else y * a
    if warp_type == "affine":
        a = params[0]
        b = params[1] if len(params) > 1 else 0.0
        if a == 1.0 and b == 0.0:
            return y
        return (y - b) / a
    if warp_type == "piecewise_linear":
        a = params[0]
        f0 = params[1] if len(params) > 1 else 0.875 * nyquist
        if a == 1.0:
            return y
        if y < a * f0:
            return y / a
        slope = (nyquist - a * f0) / (nyquist - f0)
        return f0 + (y - a * f0) / slope
    raise ValueError(f"unknown warp type {warp_type!r}")


def _parse_warp_params(s: str) -> Tuple[float, ...]:
    if not s:
        return ()
    return tuple(float(t) for t in s.replace(",", " ").split())


@dataclass
class MelSpec:
    """Host-precomputed mel filterbank + DCT matrices (float64 numpy)."""

    filters: np.ndarray  # [nbins, nfilt]
    dct: np.ndarray      # [nfilt, ncep] forward transform (applied as logmel @ dct)
    idct: np.ndarray     # [ncep, nfilt] inverse (dct3) for smoothspec, or None
    lifter: Optional[np.ndarray]  # [ncep] or None


def _mel(warp_type, params, x, nyquist):
    warped = _warp_unwarped_to_warped(warp_type, params, x, nyquist)
    return np.float32(2595.0 * math.log10(1.0 + warped / 700.0))


def _melinv(warp_type, params, x, nyquist):
    warped = 700.0 * (10.0 ** (x / 2595.0) - 1.0)
    return np.float32(_warp_warped_to_unwarped(warp_type, params, warped, nyquist))


def build_melbank(sampling_rate: float, nfft: int, nfilt: int, lowerf: float,
                  upperf: float, doublewide: bool = False, round_filters: bool = True,
                  unit_area: bool = True, warp_type: str = "inverse_linear",
                  warp_params: str = "") -> np.ndarray:
    """Construct the triangular mel filterbank matrix `[nfft//2+1, nfilt]`.

    Behavioral clone of fe_build_melfilters (fe_sigproc.c:304-430) including
    its quirks: float32 edge arithmetic, filter coefficient = min(loslope,
    hislope), left-edge bin included with zero weight, bin nfft/2 always
    excluded, optional rounding of edges to DFT points and unit-area
    normalization.
    """
    params = _parse_warp_params(warp_params)
    nyquist = sampling_rate / 2.0
    melmin = _mel(warp_type, params, np.float32(lowerf), nyquist)
    melmax = _mel(warp_type, params, np.float32(upperf), nyquist)
    melbw = np.float32((melmax - melmin) / (nfilt + 1))
    if doublewide:
        melmin = np.float32(melmin - melbw)
        melmax = np.float32(melmax + melbw)
        lo = _melinv(warp_type, params, melmin, nyquist)
        hi = _melinv(warp_type, params, melmax, nyquist)
        if lo < 0 or hi > nyquist:
            raise ValueError(f"doublewide filter edges out of range: {lo}..{hi}")

    fftfreq = np.float32(sampling_rate) / np.float32(nfft)
    nbins = nfft // 2 + 1
    filt = np.zeros((nbins, nfilt), dtype=np.float64)
    hz_of_bin = (np.arange(nbins).astype(np.float32) * fftfreq).astype(np.float32)

    for i in range(nfilt):
        freqs = []
        for j in range(3):
            step = (i + j * 2) if doublewide else (i + j)
            f = _melinv(warp_type, params, np.float32(step * melbw + melmin), nyquist)
            if round_filters:
                f = np.float32(int(f / fftfreq + 0.5) * fftfreq)
            freqs.append(np.float32(f))
        f0, f1, f2 = freqs
        for j in range(nbins):
            hz = hz_of_bin[j]
            if hz < f0:
                continue
            if hz > f2 or j == nfft // 2:
                break
            loslope = (np.float64(hz) - np.float64(f0)) / (np.float64(f1) - np.float64(f0))
            hislope = (np.float64(f2) - np.float64(hz)) / (np.float64(f2) - np.float64(f1))
            if unit_area:
                loslope *= 2.0 / (np.float64(f2) - np.float64(f0))
                hislope *= 2.0 / (np.float64(f2) - np.float64(f0))
            filt[j, i] = min(loslope, hislope)
    return filt


def build_dct(nfilt: int, ncep: int, transform: str = "legacy") -> np.ndarray:
    """DCT matrix `[nfilt, ncep]`, applied as `cep = logmel @ D`.

    Variants (fe_sigproc.c fe_spec2cep :1025 / fe_dct2 :1045):
    - legacy: c_i = (1/nfilt) * sum_j w_j l_j cos(pi i (j+.5)/nfilt), w_0=0.5 else 1
    - dct:    unitary DCT-II (sqrt(1/N) row 0, sqrt(2/N) others)
    - htk:    DCT-II with sqrt(2/N) everywhere (including row 0)
    """
    j = np.arange(nfilt, dtype=np.float64)
    i = np.arange(ncep, dtype=np.float64)
    cos = np.cos(math.pi / nfilt * np.outer(j + 0.5, i))  # [nfilt, ncep]
    if transform == "legacy":
        w = np.ones((nfilt, 1))
        w[0, 0] = 0.5
        return cos * w / nfilt
    if transform == "dct":
        scale = np.full((1, ncep), math.sqrt(2.0 / nfilt))
        scale[0, 0] = math.sqrt(1.0 / nfilt)
        d = cos * scale
        d[:, 0] = math.sqrt(1.0 / nfilt)  # row 0 basis is constant
        return d
    if transform == "htk":
        return cos * math.sqrt(2.0 / nfilt)
    raise ValueError(f"unknown transform {transform!r}")


def build_idct(nfilt: int, ncep: int) -> np.ndarray:
    """Inverse (DCT-III) matrix `[ncep, nfilt]` for smoothed log-spectra
    (fe_dct3, fe_sigproc.c:1083): l_j = sqrt(2/N) (c_0/sqrt(2) + sum_i c_i cos)."""
    j = np.arange(nfilt, dtype=np.float64)
    i = np.arange(ncep, dtype=np.float64)
    cos = np.cos(math.pi / nfilt * np.outer(i, j + 0.5))  # [ncep, nfilt]
    cos[0, :] = 1.0 / math.sqrt(2.0)
    return cos * math.sqrt(2.0 / nfilt)


def build_window(frame_size: int) -> np.ndarray:
    """Hamming window with the reference's symmetric-half construction
    (fe_create_hamming fe_sigproc.c:516): for odd frame_size the middle
    sample is left unwindowed (weight 1.0)."""
    w = np.ones(frame_size, dtype=np.float64)
    half = np.arange(frame_size // 2, dtype=np.float64)
    hamm = 0.54 - 0.46 * np.cos(2.0 * math.pi * half / (frame_size - 1.0))
    w[: frame_size // 2] = hamm
    w[frame_size - 1 : frame_size - 1 - frame_size // 2 : -1] = hamm
    return w


class Frontend:
    """Batched waveform->cepstra computation.

    All tables are precomputed on host at float64 then shipped to device as
    float32; the per-frame math runs in float32 (the reference float build is
    float64, but float32 matches within golden-test tolerance).
    """

    def __init__(self, config: Optional[Config] = None, **kwargs):
        cfg = (config.copy() if config else Config(FE_ARGS)).register(FE_ARGS)
        cfg.update(**kwargs)
        self.config = cfg
        self.sampling_rate = float(cfg["samprate"])
        self.frame_rate = int(cfg["frate"])
        self.frame_shift = int(self.sampling_rate / self.frame_rate + 0.5)
        self.frame_size = int(float(cfg["wlen"]) * self.sampling_rate + 0.5)
        self.nfft = int(cfg["nfft"])
        if self.frame_size > self.nfft:
            raise ValueError(
                f"frame size {self.frame_size} exceeds FFT size {self.nfft}")
        self.nfilt = int(cfg["nfilt"])
        self.ncep = int(cfg["ncep"])
        self.alpha = float(cfg["alpha"])
        self.remove_dc = bool(cfg["remove_dc"])
        self.transform = str(cfg["transform"])
        self.logspec = bool(cfg.get("logspec", False))
        self.smoothspec = bool(cfg.get("smoothspec", False))
        self.dither = bool(cfg.get("dither", False))
        self.dither_seed = int(cfg.get("seed", -1))

        self.filters = build_melbank(
            self.sampling_rate, self.nfft, self.nfilt,
            float(cfg["lowerf"]), float(cfg["upperf"]),
            doublewide=bool(cfg["doublebw"]),
            round_filters=bool(cfg["round_filters"]),
            unit_area=bool(cfg["unit_area"]),
            warp_type=str(cfg["warp_type"]),
            warp_params=str(cfg.get("warp_params") or ""),
        )
        self.dct = build_dct(self.nfilt, self.ncep, self.transform)
        self.idct = build_idct(self.nfilt, self.ncep)
        self.window = build_window(self.frame_size)
        lifter_val = int(cfg["lifter"])
        if lifter_val:
            i = np.arange(self.ncep, dtype=np.float64)
            self.lifter = 1.0 + lifter_val / 2.0 * np.sin(i * math.pi / lifter_val)
        else:
            self.lifter = None

    @property
    def output_dim(self) -> int:
        return self.nfilt if (self.logspec or self.smoothspec) else self.ncep

    def n_frames(self, nsamps: int, include_tail: bool = True) -> int:
        """Number of output frames for an utterance of `nsamps` samples
        (fe_process_frames counting + the fe_end_utt tail frame)."""
        if nsamps < self.frame_size:
            return 1 if (include_tail and nsamps > 0) else 0
        n = 1 + (nsamps - self.frame_size) // self.frame_shift
        if include_tail:
            n += 1
        return n

    # ------------------------------------------------------------------
    def process(self, samples: np.ndarray, include_tail: bool = True) -> np.ndarray:
        """Host API: int16/float samples [nsamps] or [B, nsamps] -> cepstra."""
        single = samples.ndim == 1
        x = np.atleast_2d(np.asarray(samples, dtype=np.float32))
        if self.dither:
            rng = np.random.RandomState(self.dither_seed if self.dither_seed >= 0 else None)
            x = x + (rng.randint(0, 4, size=x.shape) == 0).astype(np.float32)
        out = self._jit_process(x.shape[1], include_tail)(jnp.asarray(x))
        out = np.asarray(out)
        return out[0] if single else out

    @functools.lru_cache(maxsize=64)
    def _jit_process(self, nsamps: int, include_tail: bool):
        return jax.jit(functools.partial(self._process_batch, nsamps=nsamps,
                                         include_tail=include_tail))

    def _frame_starts(self, nsamps: int, include_tail: bool) -> int:
        return self.n_frames(nsamps, include_tail)

    def _process_batch(self, x, *, nsamps: int, include_tail: bool):
        """x: float32 [B, nsamps] -> [B, T, ncep] (pure jax; jit-friendly)."""
        nframes = self.n_frames(nsamps, include_tail)
        if nframes == 0:
            return jnp.zeros((x.shape[0], 0, self.output_dim), jnp.float32)

        # Global pre-emphasis (streaming-equivalent: prior carries across frames).
        if self.alpha != 0.0:
            prev = jnp.pad(x[:, :-1], ((0, 0), (1, 0)))
            y = x - self.alpha * prev
        else:
            y = x
        # Zero-pad so every frame (incl. the end_utt tail) is a full gather.
        padded_len = (nframes - 1) * self.frame_shift + self.frame_size
        if padded_len > nsamps:
            y = jnp.pad(y, ((0, 0), (0, padded_len - nsamps)))

        starts = jnp.arange(nframes) * self.frame_shift
        idx = starts[:, None] + jnp.arange(self.frame_size)[None, :]
        frames = y[:, idx]  # [B, T, frame_size]

        if self.remove_dc:
            frames = frames - jnp.mean(frames, axis=-1, keepdims=True)

        win = jnp.asarray(self.window, jnp.float32)
        frames = frames * win

        spec = jnp.fft.rfft(frames, n=self.nfft)
        power = jnp.square(spec.real) + jnp.square(spec.imag)  # [B, T, nbins]

        mel = jnp.einsum("btf,fm->btm", power.astype(jnp.float32),
                         jnp.asarray(self.filters, jnp.float32),
                         precision=jax.lax.Precision.HIGHEST)
        logmel = jnp.where(mel > 0, jnp.log(mel), -10.0)

        if self.logspec:
            return logmel
        cep = jnp.einsum("btm,mc->btc", logmel, jnp.asarray(self.dct, jnp.float32),
                         precision=jax.lax.Precision.HIGHEST)
        if self.smoothspec:
            return jnp.einsum("btc,cm->btm", cep, jnp.asarray(self.idct, jnp.float32),
                              precision=jax.lax.Precision.HIGHEST)
        if self.lifter is not None:
            cep = cep * jnp.asarray(self.lifter, jnp.float32)
        return cep

    # Streaming (live-mode) API -----------------------------------------
    def start_utt(self) -> "FrontendStream":
        return FrontendStream(self)


class FrontendStream:
    """Streaming wrapper with overflow-sample carry, mirroring
    fe_process_frames / fe_end_utt semantics for live audio.

    State: `_carry` holds all samples from the next frame *start* onward
    (overlap + residual, always < frame_size), `_prior` the sample just
    before it (for pre-emphasis continuity across calls).
    """

    def __init__(self, fe: Frontend):
        self.fe = fe
        self._carry = np.zeros(0, dtype=np.float32)
        self._prior = np.float32(0.0)

    def process(self, samples: np.ndarray) -> np.ndarray:
        fe = self.fe
        x = np.concatenate([self._carry, np.asarray(samples, dtype=np.float32)])
        if len(x) < fe.frame_size:
            self._carry = x
            return np.zeros((0, fe.output_dim), dtype=np.float32)
        n = 1 + (len(x) - fe.frame_size) // fe.frame_shift
        cep = self._run(x[: (n - 1) * fe.frame_shift + fe.frame_size], n)
        nxt = n * fe.frame_shift
        self._prior = x[nxt - 1]
        self._carry = x[nxt:]
        return cep

    def _run(self, x: np.ndarray, n: int) -> np.ndarray:
        fe = self.fe
        if fe.alpha != 0.0:
            prev = np.concatenate([[self._prior], x[:-1]]).astype(np.float32)
            y = x - fe.alpha * prev
        else:
            y = x.astype(np.float32)
        need = (n - 1) * fe.frame_shift + fe.frame_size
        if len(y) < need:  # zero-pad (end_utt tail frame)
            y = np.concatenate([y, np.zeros(need - len(y), dtype=np.float32)])
        starts = np.arange(n) * fe.frame_shift
        idx = starts[:, None] + np.arange(fe.frame_size)[None, :]
        frames = jnp.asarray(y[idx])
        if fe.remove_dc:
            frames = frames - jnp.mean(frames, axis=-1, keepdims=True)
        frames = frames * jnp.asarray(fe.window, jnp.float32)
        spec = jnp.fft.rfft(frames, n=fe.nfft)
        power = jnp.square(spec.real) + jnp.square(spec.imag)
        mel = jnp.dot(power.astype(jnp.float32), jnp.asarray(fe.filters, jnp.float32),
                      precision=jax.lax.Precision.HIGHEST)
        logmel = jnp.where(mel > 0, jnp.log(mel), -10.0)
        if fe.logspec:
            return np.asarray(logmel)
        cep = jnp.dot(logmel, jnp.asarray(fe.dct, jnp.float32),
                      precision=jax.lax.Precision.HIGHEST)
        if fe.lifter is not None:
            cep = cep * jnp.asarray(fe.lifter, jnp.float32)
        return np.asarray(cep)

    def end_utt(self) -> np.ndarray:
        fe = self.fe
        if len(self._carry) == 0:
            out = np.zeros((0, fe.output_dim), dtype=np.float32)
        else:
            out = self._run(self._carry, 1)
        self._carry = np.zeros(0, dtype=np.float32)
        self._prior = np.float32(0.0)
        return out
