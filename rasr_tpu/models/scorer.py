"""The emission-score interface ("FeatureScorer" seam).

Everything that consumes acoustic scores — the aligner and all decoders —
goes through this interface, preserving the reference's central seam
(ref: src/Mm/FeatureScorer.* — ``getScorer(feature)->score(mixture)``)
in batched form: one call scores ALL mixtures for ALL frames of an
utterance batch, returning a dense ``[B, T, M]`` score tensor
(-log p, scaled). Scorers are registered by name like the reference's
``feature-scorer-type`` config values.

Implementations:
* :class:`GmmFeatureScorer` — diag-GMM via Mahalanobis-as-gemm
  (ref: Mm::GaussDiagonalMaximumFeatureScorer / BatchFeatureScorer).
* :class:`PrecomputedScorer` — serves a precomputed score matrix
  (ref: Nn::PrecomputedHybridFeatureScorer pattern).
* NN hybrid posterior scorers live in models/nn.py and register here.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .gmm import MixtureSet, ScoringTensors, make_scoring_tensors, mixture_scores


class FeatureScorer:
    """Batched emission scorer: features ``[B, T, D]`` -> scores ``[B, T, M]``."""

    #: number of emission classes (tied states)
    num_classes: int

    def score(self, feats: jnp.ndarray) -> jnp.ndarray:  # pragma: no cover
        raise NotImplementedError

    def __call__(self, feats: jnp.ndarray, **kw) -> jnp.ndarray:
        # length-aware scorers (e.g. NnHybridScorer over a Conformer)
        # accept lengths=...; frame-local scorers ignore extra kwargs
        import inspect

        sig = inspect.signature(self.score)
        kw = {k: v for k, v in kw.items() if k in sig.parameters}
        return self.score(feats, **kw)


_REGISTRY: Dict[str, Callable[..., FeatureScorer]] = {}


def register_scorer(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def create_scorer(name: str, *args, **kwargs) -> FeatureScorer:
    if name not in _REGISTRY:
        raise KeyError(f"unknown feature-scorer-type {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](*args, **kwargs)


class GmmFeatureScorer(FeatureScorer):
    """Diag-GMM scorer over a dense HBM-resident mixture inventory."""

    def __init__(
        self,
        mixtures: MixtureSet,
        scale: float = 1.0,
        max_approx: bool = True,
        var_floor: float = 1e-4,
    ):
        self.tensors: ScoringTensors = make_scoring_tensors(mixtures, var_floor)
        self.scale = scale
        self.max_approx = max_approx
        self.num_classes = mixtures.num_mixtures
        self._jit = jax.jit(self._score)

    def _score(self, feats: jnp.ndarray) -> jnp.ndarray:
        return self.scale * mixture_scores(feats, self.tensors, self.max_approx)

    def score(self, feats: jnp.ndarray) -> jnp.ndarray:
        return self._jit(jnp.asarray(feats))


register_scorer("gmm")(GmmFeatureScorer)
register_scorer("batch-diagonal-maximum")(GmmFeatureScorer)  # reference alias


class PrecomputedScorer(FeatureScorer):
    """Serves an externally computed ``[B, T, M]`` score matrix."""

    def __init__(self, scores: np.ndarray, scale: float = 1.0):
        self._scores = jnp.asarray(scores)
        self.scale = scale
        self.num_classes = scores.shape[-1]

    def score(self, feats: jnp.ndarray) -> jnp.ndarray:
        return self.scale * self._scores


register_scorer("precomputed")(PrecomputedScorer)
