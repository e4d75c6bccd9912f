"""Per-speaker CMLLR / fMLLR feature-space adaptation (and SAT).

Re-implements the role of the reference's adaptation modules (ref:
src/Mm/ and src/Speech/ affine feature-transform adaptation,
MODULE_ADAPT_* — the constrained-MLLR transforms behind RASR's
speaker-adaptive recipes): estimate, per speaker, an affine feature
transform ``y = A x + b`` maximizing the aligned-GMM log likelihood

    sum_t [ log |det A| + log p(A x_t + b | m_t) ]

with the classic row-iterative solution for diagonal covariances
(Gales 1998, "Maximum likelihood linear transformations for HMM-based
speech recognition").

Device/host split: the only O(T) work — the per-row statistics

    G_i = sum_t c_{t,i} xi_t xi_t^T      c_{t,i} = sum_k gamma_{t,k} / sigma^2_{m_t,k,i}
    k_i = sum_t a_{t,i} xi_t             a_{t,i} = sum_k gamma_{t,k} mu_{m_t,k,i} / sigma^2_{m_t,k,i}

(xi = [x; 1] extended frames, gamma = within-mixture density
posteriors of the aligned mixture m_t) — runs as jitted row-gathers +
einsums over the frame axis; the row updates are tiny (D+1)^2 host
solves. Speaker-adaptive training (SAT) is the existing tool chain run
on transformed features: statistics accumulated under per-speaker
transforms stay mergeable accumulator files / psum reductions.
"""

from __future__ import annotations

import dataclasses
import json
import math
from functools import partial
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models.gmm import MixtureSet

BIG = 1.0e30


@dataclasses.dataclass(frozen=True)
class FmllrModelTensors:
    """Device pytree of the per-density params the statistics need."""

    means: jnp.ndarray  # [M, K, D]
    inv_var: jnp.ndarray  # [M, K, D]
    log_norm: jnp.ndarray  # [M, K]; -BIG on padding densities

    @classmethod
    def from_mixture_set(cls, ms: MixtureSet, var_floor: float = 1e-4
                         ) -> "FmllrModelTensors":
        var = np.maximum(ms.variances, var_floor).astype(np.float64)
        mask = ms.density_mask
        with np.errstate(divide="ignore"):
            log_w = np.where(mask, np.log(np.maximum(ms.weights, 1e-37)), -BIG)
        log_norm = log_w - 0.5 * (
            ms.dim * math.log(2.0 * math.pi) + np.log(var).sum(-1)
        )
        log_norm = np.where(mask, log_norm, -BIG)
        return cls(
            means=jnp.asarray(ms.means, jnp.float32),
            inv_var=jnp.asarray(1.0 / var, jnp.float32),
            log_norm=jnp.asarray(log_norm, jnp.float32),
        )


jax.tree_util.register_pytree_node(
    FmllrModelTensors,
    lambda t: ((t.means, t.inv_var, t.log_norm), None),
    lambda aux, ch: FmllrModelTensors(*ch),
)


def _fmllr_stats_fn(feats, mix, valid, mt: FmllrModelTensors):
    """[N, D] frames + [N] aligned mixture ids -> (G [D,D+1,D+1], k [D,D+1], beta)."""
    x = feats.astype(jnp.float32)
    mu = mt.means[mix]  # [N, K, D] packed-row gather
    iv = mt.inv_var[mix]
    ln = mt.log_norm[mix]  # [N, K]
    diff = x[:, None, :] - mu
    ll = ln - 0.5 * jnp.sum(diff * diff * iv, axis=-1)  # [N, K]
    gamma = jax.nn.softmax(ll, axis=-1) * valid[:, None].astype(jnp.float32)
    c = jnp.einsum("nk,nki->ni", gamma, iv)  # [N, D]
    a = jnp.einsum("nk,nki->ni", gamma, mu * iv)  # [N, D]
    xi = jnp.concatenate([x, jnp.ones((x.shape[0], 1), jnp.float32)], axis=-1)
    G = jnp.einsum("ni,nd,ne->ide", c, xi, xi,
                   precision=jax.lax.Precision.HIGHEST)
    k = jnp.einsum("ni,nd->id", a, xi, precision=jax.lax.Precision.HIGHEST)
    return G, k, jnp.sum(valid.astype(jnp.float32))


_fmllr_stats_impl = jax.jit(_fmllr_stats_fn)


def fmllr_stats(
    feats: np.ndarray,  # [N, D] valid frames (flattened over a speaker)
    mix_ids: np.ndarray,  # [N] aligned mixture (tied-state) per frame
    model: "MixtureSet | FmllrModelTensors",
    valid: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Accumulate the fMLLR statistics (G, k, beta) for one speaker.

    Calls are additive: sum G/k/beta across batches (the reference's
    mergeable-accumulator semantics; psum-reducible under a data mesh).
    """
    mt = (model if isinstance(model, FmllrModelTensors)
          else FmllrModelTensors.from_mixture_set(model))
    if valid is None:
        valid = np.ones(feats.shape[0], bool)
    G, k, beta = _fmllr_stats_impl(
        jnp.asarray(feats), jnp.asarray(mix_ids.astype(np.int32)),
        jnp.asarray(valid), mt,
    )
    return np.asarray(G, np.float64), np.asarray(k, np.float64), float(beta)


def estimate_fmllr(
    G: np.ndarray,  # [D, D+1, D+1]
    k: np.ndarray,  # [D, D+1]
    beta: float,
    iterations: int = 20,
    min_count: float = 200.0,
) -> np.ndarray:
    """Row-iterative CMLLR solve -> W = [A | b], shape [D, D+1].

    Falls back to identity when the speaker has fewer than ``min_count``
    frames (the reference's minimum-observation guard).
    """
    D = k.shape[0]
    W = np.hstack([np.eye(D), np.zeros((D, 1))])
    if beta < max(min_count, D + 1):
        return W
    # ridge keeps G_i invertible for thin speakers
    ridge = 1e-6 * np.trace(G.sum(0)) / (D * (D + 1))
    Ginv = np.linalg.inv(G + ridge * np.eye(D + 1))
    for _ in range(iterations):
        for i in range(D):
            A = W[:, :D]
            cof = np.linalg.det(A) * np.linalg.inv(A).T  # cofactor matrix
            p = np.append(cof[i], 0.0)  # [D+1] (bias has no det role)
            m1 = float(p @ Ginv[i] @ p)
            m2 = float(p @ Ginv[i] @ k[i])
            if m1 <= 0.0:
                continue
            r = math.sqrt(m2 * m2 + 4.0 * m1 * beta)
            best_q, best_w = -np.inf, None
            for alpha in ((-m2 + r) / (2 * m1), (-m2 - r) / (2 * m1)):
                w = Ginv[i] @ (k[i] + alpha * p)
                det_term = float(w @ p)
                if det_term == 0.0:
                    continue
                q = (beta * math.log(abs(det_term))
                     - 0.5 * float(w @ G[i] @ w) + float(w @ k[i]))
                if q > best_q:
                    best_q, best_w = q, w
            if best_w is not None:
                W[i] = best_w
    return W


def apply_fmllr(feats: np.ndarray, W: np.ndarray) -> np.ndarray:
    """[..., D] features -> [..., D] transformed (y = A x + b)."""
    A, b = W[:, :-1], W[:, -1]
    return feats @ A.T + b


def apply_speaker_transforms(
    feats: np.ndarray,  # [B, T, D] padded batch
    segments,  # batch segments (carry .speaker)
    table: Dict[str, np.ndarray],
) -> np.ndarray:
    """Apply each row's speaker transform (key "*" = default; speakers
    without a transform pass through). Host-side — adaptation is a
    per-utterance affine, not worth a device round trip on its own."""
    out = np.array(np.asarray(feats), copy=True)
    default = table.get("*")
    for i, seg in enumerate(segments):
        W = table.get(getattr(seg, "speaker", None) or "", default)
        if W is None:
            continue
        out[i] = out[i] @ W[:, :-1].T + W[:, -1]
    return out.astype(np.float32)


def batch_transform_tensors(
    segments, table: Dict[str, np.ndarray], dim: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-row (A [B, D, D], b [B, D]) with identity where a segment's
    speaker has no transform — the device-side application form
    (feats @ A^T + b as one batched einsum; avoids the host round trip
    of apply_speaker_transforms inside decode loops)."""
    B = len(segments)
    A = np.tile(np.eye(dim, dtype=np.float32), (B, 1, 1))
    b = np.zeros((B, dim), np.float32)
    default = table.get("*")
    for i, seg in enumerate(segments):
        W = table.get(getattr(seg, "speaker", None) or "", default)
        if W is None:
            continue
        A[i] = W[:, :-1]
        b[i] = W[:, -1]
    return A, b


def fmllr_auxiliary(G: np.ndarray, k: np.ndarray, beta: float,
                    W: np.ndarray) -> float:
    """The CMLLR auxiliary objective (up to a W-independent constant):
    beta log|det A| - 0.5 sum_i w_i G_i w_i^T + sum_i w_i k_i^T.
    Monotonically non-decreasing over estimate_fmllr iterations."""
    A = W[:, :-1]
    q = beta * math.log(abs(np.linalg.det(A)))
    for i in range(k.shape[0]):
        q += -0.5 * float(W[i] @ G[i] @ W[i]) + float(W[i] @ k[i])
    return q


# ------------------------------------------------------------------ artifacts
def save_transforms(path: str, table: Dict[str, np.ndarray]) -> None:
    """JSON artifact {speaker: W rows} (key "*" = default), the
    feature-space analog of the VTLN warp table."""
    with open(path, "w") as fh:
        json.dump({spk: np.asarray(W).tolist() for spk, W in table.items()}, fh)


def load_transforms(path: str) -> Dict[str, np.ndarray]:
    with open(path) as fh:
        raw = json.load(fh)
    return {spk: np.asarray(W, np.float64) for spk, W in raw.items()}
