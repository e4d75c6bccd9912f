"""DSP breadth tests (ops/dsp.py vs numpy/scipy oracles).

The reference's src/Signal/ carries ~10k LoC of miscellaneous DSP flow
nodes beyond the MFCC path (SURVEY §2.2 "Misc DSP"); these tests pin
the batched equivalents against brute-force host oracles.
"""

import math

import numpy as np
import pytest

import jax.numpy as jnp

from rasr_tpu.ops.dsp import (
    autocorrelation,
    cross_correlation,
    dc_detection,
    frame_energy,
    harmonic_sum_pitch,
    histogram_normalization,
    levinson,
    noise_estimate,
    normalize_energy,
    spectral_moments,
    spectral_subtraction,
    zero_crossing_rate,
)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def test_autocorrelation_matches_numpy(rng):
    x = rng.normal(size=(2, 3, 64)).astype(np.float32)
    r = np.asarray(autocorrelation(jnp.asarray(x), max_lag=8))
    for b in range(2):
        for t in range(3):
            full = np.correlate(x[b, t], x[b, t], mode="full")
            want = full[len(x[b, t]) - 1 : len(x[b, t]) + 8]
            np.testing.assert_allclose(r[b, t], want, rtol=1e-4, atol=1e-3)


def test_levinson_matches_direct_solve(rng):
    # stable AR(3) process -> autocorrelation -> levinson must solve the
    # Yule-Walker normal equations
    a_true = np.array([0.6, -0.3, 0.1])
    x = np.zeros(4000, np.float64)
    e = rng.normal(size=4000) * 0.1
    for t in range(3, 4000):
        x[t] = a_true @ x[t - 3 : t][::-1] + e[t]
    r = np.array([np.dot(x[: 4000 - k], x[k:]) for k in range(4)]) / 4000
    a, k, err = levinson(jnp.asarray(r[None], jnp.float32), order=3)
    # oracle: solve the Toeplitz normal equations directly
    import scipy.linalg as sla

    want = sla.solve_toeplitz((r[:3], r[:3]), r[1:4])
    np.testing.assert_allclose(np.asarray(a)[0], want, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(np.asarray(a)[0], a_true, atol=0.1)
    assert float(err[0]) > 0


def test_zero_crossing_rate_oracle(rng):
    x = rng.normal(size=(2, 5, 40)).astype(np.float32)
    z = np.asarray(zero_crossing_rate(jnp.asarray(x)))
    for b in range(2):
        for t in range(5):
            s = np.sign(x[b, t])
            want = np.mean(np.abs(s[1:] - s[:-1]) > 1.0)
            np.testing.assert_allclose(z[b, t], want, atol=1e-6)


def test_spectral_moments_on_tone():
    sr, n = 16000, 512
    t = np.arange(n) / sr
    tone = np.sin(2 * np.pi * 1000.0 * t).astype(np.float32)
    spec = np.abs(np.fft.rfft(tone)) ** 2
    m = np.asarray(spectral_moments(jnp.asarray(spec[None, None]), sr))
    assert abs(m[0, 0, 0] - 1000.0) < 40.0  # centroid at the tone
    assert m[0, 0, 1] < 120.0  # narrow spread


def test_harmonic_sum_pitch_detects_f0():
    sr, n = 16000, 1024
    t = np.arange(n) / sr
    f0 = 120.0
    x = sum(
        (0.6 / h) * np.sin(2 * np.pi * f0 * h * t) for h in range(1, 6)
    ).astype(np.float32)
    spec = np.abs(np.fft.rfft(x, n)) ** 2
    noise = np.abs(np.fft.rfft(np.random.default_rng(0).normal(size=n), n)) ** 2
    out = np.asarray(
        harmonic_sum_pitch(
            jnp.asarray(np.stack([spec, noise])[None]), sr, fft_size=n
        )
    )
    assert abs(out[0, 0, 0] - f0) <= 1.5 * sr / n + 1.0  # ~one-bin accuracy
    assert out[0, 0, 1] > out[0, 1, 1]  # harmonic frame more voiced


def test_histogram_normalization_gaussianizes(rng):
    # heavily skewed features -> after quantile mapping, roughly N(0,1)
    B, T, D = 2, 400, 3
    feats = (rng.exponential(size=(B, T, D)) ** 1.5).astype(np.float32)
    mask = np.ones((B, T), np.float32)
    mask[1, 300:] = 0.0
    out = np.asarray(
        histogram_normalization(jnp.asarray(feats), jnp.asarray(mask))
    )
    valid = out[0]
    assert abs(valid.mean()) < 0.15
    assert abs(valid.std() - 1.0) < 0.25
    # monotone: ordering preserved per dimension
    o = out[0, :, 0]
    f = feats[0, :, 0]
    idx = np.argsort(f)
    assert np.all(np.diff(o[idx]) > -1e-4)
    # padded frames zeroed
    assert np.all(out[1, 300:] == 0.0)


def test_noise_estimate_and_spectral_subtraction(rng):
    sr, n, T = 16000, 256, 50
    t = np.arange(n) / sr
    tone = np.sin(2 * np.pi * 800.0 * t)
    frames = rng.normal(size=(1, T, n)) * 0.1
    frames[0, 10:40] += tone[None, :] * 1.0  # speech frames
    spec = np.abs(np.fft.rfft(frames, axis=-1)) ** 2
    mask = np.ones((1, T), np.float32)
    noise = np.asarray(noise_estimate(jnp.asarray(spec), jnp.asarray(mask)))
    bin800 = round(800 * n / sr)
    # the noise floor must NOT contain the tone
    assert noise[0, bin800] < spec[0, 20, bin800] * 0.05
    clean = np.asarray(
        spectral_subtraction(jnp.asarray(spec), jnp.asarray(noise))
    )
    # noise-only frames lose most mass; tone bin survives
    assert clean[0, 2].sum() < spec[0, 2].sum() * 0.6
    assert clean[0, 20, bin800] > spec[0, 20, bin800] * 0.8


def test_dc_detection():
    sr = 16000
    live = np.sin(2 * np.pi * 440 * np.arange(sr) / sr).astype(np.float32)
    dead = np.full(sr, 0.3, np.float32)
    x = np.stack([live, dead])
    flags = np.asarray(
        dc_detection(jnp.asarray(x), jnp.asarray([sr, sr]))
    )
    assert not flags[0] and flags[1]


def test_cross_correlation_matches_numpy(rng):
    a = rng.normal(size=(2, 50)).astype(np.float32)
    b = rng.normal(size=(2, 50)).astype(np.float32)
    got = np.asarray(cross_correlation(jnp.asarray(a), jnp.asarray(b), 5))
    for i in range(2):
        for k in range(-5, 6):
            if k >= 0:
                want = np.dot(a[i, k:], b[i, : 50 - k]) if k else np.dot(a[i], b[i])
            else:
                want = np.dot(a[i, : 50 + k], b[i, -k:])
            np.testing.assert_allclose(
                got[i, 5 + k], want, rtol=1e-3, atol=1e-3
            )


def test_normalize_energy():
    e = np.array([[1.0, 5.0, 3.0, 0.0]], np.float32)
    m = np.array([[1, 1, 1, 0]], np.float32)
    out = np.asarray(normalize_energy(jnp.asarray(e), jnp.asarray(m)))
    np.testing.assert_allclose(out[0], [-4.0, 0.0, -2.0, 0.0], atol=1e-6)
