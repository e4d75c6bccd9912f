"""Per-speaker VTLN warping-factor estimation.

Re-implements the reference's VTLN estimation scheme (ref: the
Signal::Warping nodes + the standard RASR grid-search recipe): for each
speaker, forced-align their utterances under a grid of warping factors
and pick the alpha with the best total alignment likelihood. Here
all factors of the grid evaluate as one batched sweep — the
frontend is cheap, so the whole grid is a handful of jit calls.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..align.aligner import BatchAligner
from ..ops.frontend import FeatureFrontend, FrontendConfig
from ..ops.gammatone import piecewise_linear_warp


def estimate_warping_factor(
    samples: np.ndarray,  # [B, S] one speaker's utterances
    lengths: np.ndarray,
    graphs: Sequence,  # alignment graphs per utterance
    aligner_factory,  # scorer -> BatchAligner   (or a ready BatchAligner)
    frontend_cfg: FrontendConfig = FrontendConfig(),
    alphas: Sequence[float] = (0.88, 0.92, 0.96, 1.0, 1.04, 1.08, 1.12),
    frontend_kwargs: Optional[dict] = None,
) -> Tuple[float, Dict[float, float]]:
    """Grid search: returns (best alpha, {alpha: total alignment cost})."""
    kw = frontend_kwargs or {}
    scores: Dict[float, float] = {}
    num_bins = frontend_cfg.num_bins
    for alpha in alphas:
        warp = piecewise_linear_warp(num_bins, alpha)
        fe = FeatureFrontend(frontend_cfg, vtln_warp=warp, **kw)
        feats, n_frames = fe(samples, lengths)
        aligner = aligner_factory if isinstance(aligner_factory, BatchAligner) else aligner_factory()
        als = aligner.align(feats, list(graphs), np.asarray(n_frames))
        scores[alpha] = float(sum(al.score for al in als))
    best = min(scores, key=scores.get)
    return best, scores


def speaker_warping_table(
    per_speaker_scores: Dict[str, Dict[float, float]]
) -> Dict[str, float]:
    """Collapse grid results into a speaker -> alpha table (artifact the
    recognizer's frontend consumes per speaker)."""
    return {
        spk: min(scores, key=scores.get)
        for spk, scores in per_speaker_scores.items()
    }
