"""Batched forced alignment.

Re-implements the reference's aligner driver
(ref: src/Speech/Aligner.*, Speech::Alignment, Speech::AlignmentNode):
per utterance it produces the Viterbi (or Baum-Welch posterior) mapping
frame -> (allophone state, tied class, weight). Here, a *batch*
of utterances is aligned at once: graphs are padded to a common state
count, emissions for all graph states are gathered from the dense
``[B, T, M]`` score tensor, and one banded-Viterbi scan aligns the whole
batch.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models.scorer import FeatureScorer
from ..ops.viterbi import BIG, forward_backward, viterbi_align
from .graph import LinearGraph


@dataclasses.dataclass
class Alignment:
    """Per-frame alignment of one utterance (ref: Speech::Alignment)."""

    segment_name: str
    emission_ids: np.ndarray  # [T] int32 tied-class per frame
    state_indices: np.ndarray  # [T] int32 graph-chain state per frame
    score: float
    weights: Optional[np.ndarray] = None  # [T] posterior weight (Viterbi: 1)

    @property
    def num_frames(self) -> int:
        return self.emission_ids.shape[0]

    def pack(self) -> bytes:
        from ..utils.archive import pack_ndarray

        arr = np.stack(
            [
                self.emission_ids.astype(np.float32),
                self.state_indices.astype(np.float32),
                self.weights if self.weights is not None else np.ones(self.num_frames, np.float32),
            ],
            axis=1,
        )
        return pack_ndarray(arr)

    @classmethod
    def unpack(cls, name: str, data: bytes, score: float = 0.0) -> "Alignment":
        from ..utils.archive import unpack_ndarray

        arr = unpack_ndarray(data)
        return cls(
            segment_name=name,
            emission_ids=arr[:, 0].astype(np.int32),
            state_indices=arr[:, 1].astype(np.int32),
            score=score,
            weights=arr[:, 2],
        )


def linear_segmentation(
    graphs: Sequence[LinearGraph], n_frames: np.ndarray
) -> np.ndarray:
    """Uniform flat-start labels: frames spread evenly over chain states.

    The standard bootstrap for EM from identical models, where a Viterbi
    alignment would be TDP-driven and degenerate (the reference gets the
    same effect from its linear-segmentation alignment mode).
    Returns labels [B, T_max] (emission class ids, -1 padding).
    """
    B = len(graphs)
    T = int(np.max(n_frames))
    labels = np.full((B, T), -1, np.int32)
    for i, g in enumerate(graphs):
        n = int(n_frames[i])
        if n <= 0:
            continue
        S = g.num_states
        idx = np.minimum((np.arange(n) * S) // max(n, 1), S - 1)
        labels[i, :n] = g.emission_ids[idx]
    return labels


def _pad_graphs(graphs: Sequence[LinearGraph]):
    """Stack graphs into padded [B, S_max] arrays."""
    B = len(graphs)
    S = max(g.num_states for g in graphs)
    emission_ids = np.zeros((B, S), np.int32)
    loop = np.full((B, S), BIG, np.float32)
    fwd = np.full((B, S), BIG, np.float32)
    skip = np.full((B, S), BIG, np.float32)
    init = np.full((B, S), BIG, np.float32)
    final = np.full((B, S), BIG, np.float32)
    for i, g in enumerate(graphs):
        n = g.num_states
        emission_ids[i, :n] = g.emission_ids
        loop[i, :n] = g.loop
        fwd[i, :n] = g.fwd
        skip[i, :n] = g.skip
        init[i, :n] = g.init
        final[i, :n] = g.final
    return emission_ids, loop, fwd, skip, init, final


@jax.jit
def _gather_emissions(scores: jnp.ndarray, emission_ids: jnp.ndarray) -> jnp.ndarray:
    """[B, T, M] scores + [B, S] class ids -> [B, T, S] graph emissions."""
    return jnp.take_along_axis(
        scores, emission_ids[:, None, :].astype(jnp.int32), axis=2
    )


class BatchAligner:
    """Aligns utterance batches against linear graphs.

    mode 'viterbi' gives hard alignments; 'baum-welch' gives per-frame
    state posteriors (gamma) as weights.
    """

    def __init__(self, scorer: FeatureScorer, mode: str = "viterbi"):
        assert mode in ("viterbi", "baum-welch")
        self.scorer = scorer
        self.mode = mode

    def align_scores(
        self,
        scores: jnp.ndarray,  # [B, T, M]
        graphs: Sequence[LinearGraph],
        n_frames: np.ndarray,
        names: Optional[Sequence[str]] = None,
    ) -> List[Alignment]:
        names = names or [f"utt{i}" for i in range(len(graphs))]
        emission_ids, loop, fwd, skip, init, final = _pad_graphs(graphs)
        emis = _gather_emissions(jnp.asarray(scores), jnp.asarray(emission_ids))
        nf = jnp.asarray(n_frames, jnp.int32)
        if self.mode == "viterbi":
            best, states = viterbi_align(
                emis, jnp.asarray(loop), jnp.asarray(fwd), jnp.asarray(skip),
                jnp.asarray(init), jnp.asarray(final), nf,
            )
            best, states = np.asarray(best), np.asarray(states)
            out = []
            for i, g in enumerate(graphs):
                n = int(n_frames[i])
                seq = states[i, :n]
                out.append(
                    Alignment(
                        segment_name=names[i],
                        emission_ids=g.emission_ids[seq],
                        state_indices=seq.astype(np.int32),
                        score=float(best[i]),
                        weights=np.ones(n, np.float32),
                    )
                )
            return out
        total, gamma = forward_backward(
            emis, jnp.asarray(loop), jnp.asarray(fwd), jnp.asarray(skip),
            jnp.asarray(init), jnp.asarray(final), nf,
        )
        total, gamma = np.asarray(total), np.asarray(gamma)
        out = []
        for i, g in enumerate(graphs):
            n = int(n_frames[i])
            gm = gamma[i, :n, : g.num_states]  # [T, S]
            # hard labels for convenience = argmax posterior; weights = max
            seq = gm.argmax(axis=1)
            out.append(
                Alignment(
                    segment_name=names[i],
                    emission_ids=g.emission_ids[seq],
                    state_indices=seq.astype(np.int32),
                    score=float(total[i]),
                    weights=gm.max(axis=1).astype(np.float32),
                )
            )
        return out

    def align(
        self,
        feats: jnp.ndarray,  # [B, T, D]
        graphs: Sequence[LinearGraph],
        n_frames: np.ndarray,
        names: Optional[Sequence[str]] = None,
    ) -> List[Alignment]:
        return self.align_scores(self.scorer(feats), graphs, n_frames, names)

    def gamma(
        self,
        feats: jnp.ndarray,
        graphs: Sequence[LinearGraph],
        n_frames: np.ndarray,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Full posterior tensor for EM: (total [B], gamma [B,T,S],
        emission ids [B,S])."""
        emission_ids, loop, fwd, skip, init, final = _pad_graphs(graphs)
        emis = _gather_emissions(self.scorer(feats), jnp.asarray(emission_ids))
        total, gamma = forward_backward(
            emis, jnp.asarray(loop), jnp.asarray(fwd), jnp.asarray(skip),
            jnp.asarray(init), jnp.asarray(final), jnp.asarray(n_frames, jnp.int32),
        )
        return np.asarray(total), np.asarray(gamma), emission_ids
