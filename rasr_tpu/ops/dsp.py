"""Miscellaneous DSP ops: energy, silence detection, FIR filtering, delay.

Batched equivalents of the reference's remaining Signal flow nodes
(ref: src/Signal/ — energy node, silence detection, linear filtering,
delay [K?]): batched tensor programs over ``[B, T, ...]`` instead of
per-frame packet pulls. All are jit-safe with static shapes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def frame_energy(frames: jnp.ndarray, log: bool = True, floor: float = 1e-10) -> jnp.ndarray:
    """Per-frame energy of framed samples ``[..., T, L]`` -> ``[..., T]``."""
    e = jnp.sum(frames * frames, axis=-1)
    if log:
        e = jnp.log(jnp.maximum(e, floor))
    return e


def silence_detection(
    energy: jnp.ndarray,
    frame_mask: jnp.ndarray,
    threshold_db: float = 30.0,
    hangover: int = 5,
) -> jnp.ndarray:
    """Energy-based speech/silence classification per frame.

    A frame is speech if its energy is within ``threshold_db`` of the
    segment's maximum energy; speech runs are extended by ``hangover``
    frames on both sides (the reference's silence-detection node keeps
    short pauses attached to speech). energy ``[..., T]`` (log scale,
    nats), frame_mask ``[..., T]`` 1=valid. Returns float mask 1=speech.
    """
    neg = jnp.where(frame_mask > 0, energy, -jnp.inf)
    peak = jnp.max(neg, axis=-1, keepdims=True)
    thresh_nats = threshold_db * (np.log(10.0) / 10.0)
    speech = (neg > peak - thresh_nats).astype(jnp.float32)
    if hangover > 0:
        # dilate the speech mask by ±hangover via a max pool
        T = speech.shape[-1]
        idx = np.arange(T)[:, None] + np.arange(-hangover, hangover + 1)[None, :]
        idx = np.clip(idx, 0, T - 1)
        speech = jnp.max(speech[..., idx], axis=-1)
    return speech * frame_mask


def fir_filter(x: jnp.ndarray, taps: np.ndarray) -> jnp.ndarray:
    """Causal FIR filtering along the last axis (ref: the linear-filter
    flow node). x ``[..., S]``, taps ``[ntaps]`` (tap 0 = current sample).
    Implemented as a strided matmul-friendly correlation."""
    taps = jnp.asarray(taps, x.dtype)
    n = taps.shape[0]
    xp = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(n - 1, 0)])
    # window view [..., S, n] then dot with reversed taps
    S = x.shape[-1]
    idx = np.arange(S)[:, None] + np.arange(n)[None, :]
    win = xp[..., idx]
    return jnp.matmul(win, taps[::-1], precision=jax.lax.Precision.HIGHEST)


def delay(x: jnp.ndarray, frames: int) -> jnp.ndarray:
    """Shift along the last axis by ``frames`` (positive = delay),
    zero-filled (ref: delay flow node)."""
    if frames == 0:
        return x
    pads = [(0, 0)] * (x.ndim - 1)
    if frames > 0:
        return jnp.pad(x, pads + [(frames, 0)])[..., : x.shape[-1]]
    return jnp.pad(x, pads + [(0, -frames)])[..., -frames:]


# ---------------------------------------------------------- spectral analysis
def autocorrelation(frames: jnp.ndarray, max_lag: int) -> jnp.ndarray:
    """Per-frame autocorrelation r[0..max_lag] (ref: the autocorrelation
    flow node feeding LPC/AR estimation). frames ``[..., T, L]`` ->
    ``[..., T, max_lag+1]``; computed via the power spectrum (one rfft,
    matmul-friendly) — exact circular-free autocorrelation through
    zero padding."""
    L = frames.shape[-1]
    n = 1
    while n < 2 * L:
        n *= 2
    spec = jnp.fft.rfft(frames, n=n, axis=-1)
    r = jnp.fft.irfft(spec * jnp.conj(spec), n=n, axis=-1).real
    return r[..., : max_lag + 1]


def levinson(r: jnp.ndarray, order: int):
    """Levinson-Durbin recursion (ref: Signal AR/LPC estimation,
    src/Signal/ArEstimator [K?]).

    r ``[..., order+1]`` autocorrelation -> (lpc coefficients a
    ``[..., order]`` with sign convention x_t ~ sum_k a[k] x_{t-k},
    reflection coefficients ``[..., order]``, prediction-error power
    ``[...]``). Static unrolled loop (order is small and fixed) — maps
    to dense vector ops, no data-dependent control flow."""
    eps = 1e-8
    a = jnp.zeros(r.shape[:-1] + (order,), r.dtype)
    k_out = []
    err = r[..., 0] + eps
    for m in range(order):
        acc = r[..., m + 1]
        for i in range(m):
            acc = acc - a[..., i] * r[..., m - i]
        k = acc / err
        k_out.append(k)
        # a_new[i] = a[i] - k * a[m-1-i]
        if m > 0:
            flipped = a[..., :m][..., ::-1]
            a = a.at[..., :m].set(a[..., :m] - k[..., None] * flipped)
        a = a.at[..., m].set(k)
        err = err * (1.0 - k * k)
    return a, jnp.stack(k_out, axis=-1), err


def zero_crossing_rate(frames: jnp.ndarray) -> jnp.ndarray:
    """Per-frame zero-crossing rate in [0, 1] (ref: the zero-crossing
    feature node). frames ``[..., T, L]`` -> ``[..., T]``."""
    s = jnp.sign(frames)
    flips = jnp.abs(s[..., 1:] - s[..., :-1]) > 1.0
    return jnp.mean(flips.astype(jnp.float32), axis=-1)


def spectral_moments(power: jnp.ndarray, sample_rate: float) -> jnp.ndarray:
    """Spectral centroid + spread (Hz) from power spectra
    ``[..., T, F]`` -> ``[..., T, 2]`` (ref: spectral-statistics
    features)."""
    F = power.shape[-1]
    freqs = jnp.asarray(
        np.linspace(0.0, sample_rate / 2.0, F, dtype=np.float32)
    )
    mass = jnp.maximum(jnp.sum(power, axis=-1, keepdims=True), 1e-10)
    p = power / mass
    centroid = jnp.sum(p * freqs, axis=-1)
    spread = jnp.sqrt(
        jnp.maximum(
            jnp.sum(p * freqs**2, axis=-1) - centroid**2, 0.0
        )
    )
    return jnp.stack([centroid, spread], axis=-1)


def harmonic_sum_pitch(
    power: jnp.ndarray,
    sample_rate: float,
    fft_size: int,
    fmin: float = 60.0,
    fmax: float = 400.0,
    num_harmonics: int = 5,
) -> jnp.ndarray:
    """Harmonic-sum pitch + voicedness per frame (ref: the reference's
    pitch/voicedness feature nodes, src/Signal/Harmonic* [K?]).

    For each candidate f0 the harmonic sum S(f0) = sum_h power[h*f0]
    accumulates over ``num_harmonics``; the argmax is the pitch and the
    peak's share of frame energy the voicedness. power ``[..., T, F]``
    -> ``[..., T, 2]`` (f0 Hz, voicedness in [0, 1]). The candidate
    grid and harmonic gathers are trace-time constants — the per-frame
    work is one [T, C] matmul-like reduction."""
    F = power.shape[-1]
    hz_per_bin = sample_rate / fft_size
    cand = np.arange(
        max(int(fmin / hz_per_bin), 1), int(fmax / hz_per_bin) + 1
    )  # candidate f0 bins
    if cand.size == 0:
        raise ValueError("empty pitch candidate range")
    # [C, H] harmonic bin index matrix (clipped to the spectrum)
    harm = np.minimum(
        cand[:, None] * np.arange(1, num_harmonics + 1)[None, :], F - 1
    )
    sel = np.zeros((F, cand.size), np.float32)  # one-hot sum as matmul
    # each harmonic collects +-1 bin with triangular weights: real f0s
    # fall between bins and their upper harmonics drift by h * the
    # fractional offset — the spread keeps the sum on the comb
    for c in range(cand.size):
        for h in harm[c]:
            h = int(h)
            sel[h, c] += 1.0
            if h > 0:
                sel[h - 1, c] += 0.5
            if h < F - 1:
                sel[h + 1, c] += 0.5
    hsum = jnp.matmul(
        power, jnp.asarray(sel), precision=jax.lax.Precision.HIGHEST
    )  # [..., T, C]
    best = jnp.argmax(hsum, axis=-1)
    f0 = jnp.asarray(cand.astype(np.float32) * hz_per_bin)[best]
    total = jnp.maximum(jnp.sum(power, axis=-1), 1e-10)
    peak = jnp.max(hsum, axis=-1)
    voiced = jnp.clip(peak / (num_harmonics * total), 0.0, 1.0)
    return jnp.stack([f0, voiced], axis=-1)


# ------------------------------------------------------------- normalization
def histogram_normalization(
    feats: jnp.ndarray,
    frame_mask: jnp.ndarray,
    num_quantiles: int = 16,
) -> jnp.ndarray:
    """Quantile-based feature normalization (ref: the reference's
    histogram-normalization node): per segment and dimension, map the
    empirical quantiles onto the standard normal's — a monotone
    piecewise-linear warp that gaussianizes each feature dimension.
    feats ``[B, T, D]``, frame_mask ``[B, T]``."""
    from scipy.stats import norm as _norm  # host-side targets only

    qs = np.linspace(0.02, 0.98, num_quantiles, dtype=np.float32)
    targets = jnp.asarray(_norm.ppf(qs).astype(np.float32))  # [Q]
    big = jnp.float32(3.4e38)
    masked = jnp.where(frame_mask[..., None] > 0, feats, big)
    T = feats.shape[1]
    n = jnp.maximum(jnp.sum(frame_mask, axis=1), 1.0)  # [B]
    srt = jnp.sort(masked, axis=1)  # valid frames first (big sorts last)
    # per-(B,) quantile positions into the valid prefix
    pos = (
        qs[None, :] * (n[:, None] - 1.0)
    )  # [B, Q] fractional positions
    lo = jnp.clip(jnp.floor(pos).astype(jnp.int32), 0, T - 1)
    hi = jnp.clip(lo + 1, 0, T - 1)
    frac = (pos - lo.astype(pos.dtype))[..., None]
    take = jnp.take_along_axis
    qv = (1.0 - frac) * take(srt, lo[..., None], axis=1) + frac * take(
        srt, hi[..., None], axis=1
    )  # [B, Q, D] empirical quantile values
    qv = jnp.swapaxes(qv, 1, 2)  # [B, D, Q]
    # piecewise-linear map feats -> targets
    x = jnp.swapaxes(feats, 1, 2)  # [B, D, T]
    idx = jnp.sum(
        (x[..., None] >= qv[..., None, :]).astype(jnp.int32), axis=-1
    )  # [B, D, T] in [0, Q]
    i1 = jnp.clip(idx, 1, num_quantiles - 1)
    q_lo = take(qv, i1 - 1, axis=-1)
    q_hi = take(qv, i1, axis=-1)
    t_lo = targets[i1 - 1]
    t_hi = targets[i1]
    w = jnp.clip((x - q_lo) / jnp.maximum(q_hi - q_lo, 1e-6), -1.0, 2.0)
    out = t_lo + w * (t_hi - t_lo)
    return jnp.swapaxes(out, 1, 2) * frame_mask[..., None]


def normalize_energy(energy: jnp.ndarray, frame_mask: jnp.ndarray) -> jnp.ndarray:
    """Log-energy minus segment peak (speech ~ 0, silence negative)."""
    peak = jnp.max(
        jnp.where(frame_mask > 0, energy, -jnp.inf), axis=-1, keepdims=True
    )
    return (energy - peak) * frame_mask


# ------------------------------------------------------------ noise / misc
def noise_estimate(
    power: jnp.ndarray, frame_mask: jnp.ndarray, quantile: float = 0.1
) -> jnp.ndarray:
    """Per-bin noise floor: mean of the lowest-energy ``quantile`` of
    frames (ref: the minimum-statistics noise estimator feeding
    spectral subtraction). power ``[B, T, F]`` -> ``[B, F]``."""
    e = jnp.sum(power, axis=-1)
    e = jnp.where(frame_mask > 0, e, jnp.inf)
    T = power.shape[1]
    k = max(int(T * quantile), 1)
    neg, idx = jax.lax.top_k(-e, k)  # lowest-energy frames
    sel = jnp.take_along_axis(power, idx[..., None], axis=1)
    valid = (-neg < jnp.inf)[..., None]
    return jnp.sum(jnp.where(valid, sel, 0.0), axis=1) / jnp.maximum(
        jnp.sum(valid, axis=1), 1
    )


def spectral_subtraction(
    power: jnp.ndarray,
    noise: jnp.ndarray,
    over_subtraction: float = 1.0,
    floor: float = 0.01,
) -> jnp.ndarray:
    """Power spectral subtraction with flooring (ref: the spectral
    subtraction / noise reduction node). power ``[B, T, F]``, noise
    ``[B, F]``."""
    clean = power - over_subtraction * noise[:, None, :]
    return jnp.maximum(clean, floor * power)


def dc_detection(
    samples: jnp.ndarray, lengths: jnp.ndarray, window: int = 160,
    threshold: float = 1e-4,
) -> jnp.ndarray:
    """Flag segments that are (near-)constant / DC-only (ref: the
    reference's DC-detection guard against dead audio channels).
    samples ``[B, S]`` -> bool ``[B]`` (True = dead)."""
    B, S = samples.shape
    n = S // window
    x = samples[:, : n * window].reshape(B, n, window)
    v = jnp.var(x, axis=-1)  # [B, n]
    t = jnp.arange(n) * window
    valid = t[None, :] + window <= lengths[:, None]
    live = (v > threshold) & valid
    return ~jnp.any(live, axis=1)


def cross_correlation(a: jnp.ndarray, b: jnp.ndarray, max_lag: int) -> jnp.ndarray:
    """Cross-correlation of equal-length signals for lags
    [-max_lag, max_lag] (ref: cross-correlation node). a, b
    ``[..., S]`` -> ``[..., 2*max_lag+1]``."""
    S = a.shape[-1]
    n = 1
    while n < 2 * S:
        n *= 2
    fa = jnp.fft.rfft(a, n=n, axis=-1)
    fb = jnp.fft.rfft(b, n=n, axis=-1)
    cc = jnp.fft.irfft(fa * jnp.conj(fb), n=n, axis=-1).real
    # lag k (a leads by k): cc[k]; negative lags wrap at the end
    pos = cc[..., : max_lag + 1]
    neg = cc[..., -max_lag:]
    return jnp.concatenate([neg, pos], axis=-1)
