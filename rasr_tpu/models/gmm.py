"""Gaussian mixture sets with a dense batched scoring layout.

Re-implements the reference's mixture-set model and its optimized scorers
(ref: src/Mm/MixtureSet.*, src/Mm/Density.*, src/Mm/*FeatureScorer*.cc —
the SSE batch scorers) the batched way: instead of lazily scoring requested
mixtures per frame with SIMD intrinsics, the whole inventory is resident
as dense ``[M, K, D]`` tensors and ALL mixtures are scored for ALL frames
of a batch with one gemm pair (the brief's batched Mahalanobis +
log-sum-exp over mixture densities as dense matmuls: two f32 gemms at
HIGHEST precision).

Math: for diagonal Gaussians the negative density log-likelihood is

    s_i(x) = c_i + sum_d a_{d,i} x_d^2 + sum_d b_{d,i} x_d
    a = 0.5/var,  b = -mean/var,
    c = -log w + 0.5 (D log 2pi + sum log var + sum mean^2/var)

so the full score matrix over N densities is ``X2 @ A + X @ B + c`` —
two gemms — followed by a per-mixture reduction (max-approximation like
the reference's default scorer, or exact logsumexp).

Layout: densities are stored padded ``[M, K_max, D]`` with +inf padding
scores so the reduction is a plain masked max/logsumexp on a static
shape. The scoring constants are a pytree (:class:`ScoringTensors`)
precomputed once per model.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

LOG_2PI = math.log(2.0 * math.pi)
PAD_SCORE = 1e30  # -log score of padding densities (never wins)


@dataclasses.dataclass
class MixtureSet:
    """Canonical (host, numpy) representation of a mixture set.

    means/variances ``[M, K, D]`` padded along K; weights ``[M, K]``
    (linear, rows sum to 1 over valid densities); num_densities ``[M]``.
    """

    means: np.ndarray
    variances: np.ndarray
    weights: np.ndarray
    num_densities: np.ndarray

    def __post_init__(self):
        assert self.means.shape == self.variances.shape
        assert self.weights.shape == self.means.shape[:2]
        assert self.num_densities.shape == (self.means.shape[0],)

    @property
    def num_mixtures(self) -> int:
        return self.means.shape[0]

    @property
    def max_densities(self) -> int:
        return self.means.shape[1]

    @property
    def dim(self) -> int:
        return self.means.shape[2]

    @property
    def total_densities(self) -> int:
        return int(self.num_densities.sum())

    @property
    def density_mask(self) -> np.ndarray:
        return (
            np.arange(self.max_densities)[None, :] < self.num_densities[:, None]
        )

    # ------------------------------------------------------------ constructors
    @classmethod
    def single_density(cls, means: np.ndarray, variances: np.ndarray) -> "MixtureSet":
        """One Gaussian per mixture (EM iteration 0)."""
        M, D = means.shape
        return cls(
            means=means[:, None, :].astype(np.float32),
            variances=variances[:, None, :].astype(np.float32),
            weights=np.ones((M, 1), np.float32),
            num_densities=np.ones(M, np.int32),
        )

    def pad_to(self, k_max: int) -> "MixtureSet":
        """Grow the density axis (identity if already >= k_max)."""
        M, K, D = self.means.shape
        if K >= k_max:
            return self
        pad = ((0, 0), (0, k_max - K), (0, 0))
        return MixtureSet(
            means=np.pad(self.means, pad),
            variances=np.pad(self.variances, pad, constant_values=1.0),
            weights=np.pad(self.weights, pad[:2]),
            num_densities=self.num_densities,
        )

    # ------------------------------------------------------------------- io
    def save(self, path: str) -> None:
        """Binary mixture-set artifact (role of the reference's .mix files,
        ref: Mm::MixtureSetReader/Writer)."""
        np.savez_compressed(
            path,
            means=self.means,
            variances=self.variances,
            weights=self.weights,
            num_densities=self.num_densities,
        )

    @classmethod
    def load(cls, path: str) -> "MixtureSet":
        if not path.endswith(".npz"):
            path = path + ".npz"
        data = np.load(path)
        return cls(
            means=data["means"],
            variances=data["variances"],
            weights=data["weights"],
            num_densities=data["num_densities"],
        )


# ------------------------------------------------------------- scoring tensors
@dataclasses.dataclass(frozen=True)
class ScoringTensors:
    """Precomputed gemm constants (a device pytree).

    a, b: ``[D, M*K]``; c: ``[M*K]`` with +PAD_SCORE on padding densities.
    """

    a: jnp.ndarray
    b: jnp.ndarray
    c: jnp.ndarray
    num_mixtures: int
    max_densities: int

    @property
    def dim(self) -> int:
        return self.a.shape[0]


jax.tree_util.register_pytree_node(
    ScoringTensors,
    lambda s: ((s.a, s.b, s.c), (s.num_mixtures, s.max_densities)),
    lambda aux, ch: ScoringTensors(*ch, *aux),
)


def make_scoring_tensors(ms: MixtureSet, var_floor: float = 1e-4) -> ScoringTensors:
    M, K, D = ms.means.shape
    var = np.maximum(ms.variances, var_floor).astype(np.float64)
    mean = ms.means.astype(np.float64)
    mask = ms.density_mask
    with np.errstate(divide="ignore"):
        log_w = np.where(mask, np.log(np.maximum(ms.weights, 1e-37)), 0.0)
    a = 0.5 / var  # [M,K,D]
    b = -mean / var
    c = -log_w + 0.5 * (
        D * LOG_2PI + np.log(var).sum(-1) + (mean * mean / var).sum(-1)
    )
    c = np.where(mask, c, PAD_SCORE)
    return ScoringTensors(
        a=jnp.asarray(a.reshape(M * K, D).T, jnp.float32),
        b=jnp.asarray(b.reshape(M * K, D).T, jnp.float32),
        c=jnp.asarray(c.reshape(M * K), jnp.float32),
        num_mixtures=M,
        max_densities=K,
    )


def density_scores(feats: jnp.ndarray, st: ScoringTensors) -> jnp.ndarray:
    """[..., D] -> [..., M*K] per-density -log(w * N(x)."""
    x = feats.astype(jnp.float32)
    return (
        jnp.matmul(x * x, st.a, precision=jax.lax.Precision.HIGHEST)
        + jnp.matmul(x, st.b, precision=jax.lax.Precision.HIGHEST)
        + st.c
    )


def mixture_scores(
    feats: jnp.ndarray, st: ScoringTensors, max_approx: bool = True
) -> jnp.ndarray:
    """[..., D] -> [..., M] emission scores (-log p(x|mixture)).

    ``max_approx=True`` reproduces the reference's default maximum
    approximation over densities (ref: Mm::GaussDiagonalMaximumFeatureScorer);
    otherwise an exact logsumexp over densities.
    """
    d = density_scores(feats, st)
    d = d.reshape(*d.shape[:-1], st.num_mixtures, st.max_densities)
    if max_approx:
        return jnp.min(d, axis=-1)
    return -jax.scipy.special.logsumexp(-d, axis=-1)


def mixture_posteriors(feats: jnp.ndarray, st: ScoringTensors) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-density posteriors within each mixture (for EM).

    Returns (gamma ``[..., M, K]``, mixture scores ``[..., M]``).
    """
    d = density_scores(feats, st)
    d = d.reshape(*d.shape[:-1], st.num_mixtures, st.max_densities)
    total = -jax.scipy.special.logsumexp(-d, axis=-1, keepdims=True)
    gamma = jnp.exp(total - d)  # exp(-(d - total))
    return gamma, total[..., 0]
