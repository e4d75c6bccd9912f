"""Streaming (online) decoding: the reference's frame-feed search API.

The reference's ``Search::SearchAlgorithm`` seam is online — per segment
``restart()``, then ``feed(feature)`` frame by frame, with
``getCurrentBestSentence()`` available at any time (ref:
src/Search/Search.*; Speech::Recognizer drives it). The batched form
feeds BLOCKS of frames (a block is one jitted ``lax.scan`` over the
persistent beam carry): per-frame host round-trips would pay the
device round-trip latency 100x per audio second, while a block amortizes it
and keeps the hot loop on-chip. Identical final results to the offline
whole-utterance scan (same step function, same traceback records), so
exactness properties carry over; ``current_best()`` finalizes a COPY of
the live beam at the frontier — the partial-hypothesis semantics of the
reference's current-best traceback.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .decoder import (
    BeamConfig,
    DecodeResult,
    TreeDecoder,
    _build_state_pack,
    _compact_rnn_carry,
    _decode_block,
    _finalize_stream,
    init_carry,
)

_NO_END = np.int32(2**30)  # "length not declared": frames stay active
#: record buffers pad to multiples of this many frames before finalize,
#: so current_best()/finalize() compile once per BUCKET, not per frontier
#: (a decode compile takes seconds; a per-block recompile would stall
#: every getCurrentBestSentence-style query)
_REC_BUCKET = 256


class StreamingDecoder:
    """Block-feed online decoder over a TreeDecoder's compiled tables.

    Usage::

        sd = StreamingDecoder(decoder)
        sd.restart(batch_size=B, n_frames=totals)   # totals optional
        for block in emission_blocks:               # [B, Tb, M]
            sd.feed(block)
        results = sd.finalize()

    Feeding past a declared utterance end is safe (those rows freeze,
    exactly like padding frames in the offline scan).
    """

    def __init__(self, decoder: TreeDecoder):
        self.dec = decoder
        self._carry = None
        self._recs: list = []
        self._t = 0
        self._n_frames: Optional[np.ndarray] = None
        self._B = 0

    # ------------------------------------------------------------ lifecycle
    def restart(self, batch_size: int, n_frames: Optional[np.ndarray] = None):
        """Begin a new (batch of) segment(s) (ref: SearchAlgorithm::restart)."""
        B = batch_size
        state_pack, _, _ = _build_state_pack(
            self.dec.tables, self.dec.cfg, self.dec.bla
        )
        self._carry = init_carry(
            B, self.dec.cfg, self.dec.lm, state_pack, bla=self.dec.bla,
            rnn=self.dec.rnn, rnn_pool=0,
        )
        self._recs = []
        self._t = 0
        self._B = B
        self._n_frames = (
            np.asarray(n_frames, np.int32)
            if n_frames is not None
            else np.full(B, _NO_END, np.int32)
        )
        return self

    def feed(self, emissions: np.ndarray) -> "StreamingDecoder":
        """Advance the beam over a block of emission frames [B, Tb, M]."""
        assert self._carry is not None, "restart() first"
        cfg = self.dec.cfg
        kbranch = cfg.branch_hyps or cfg.max_hyps
        rnn_base = 0
        if self.dec.rnn is not None:
            # bounded-pool compaction: keep only the <=2K live state
            # rows, then size the pool for this block's R*Tb writes —
            # fixed memory per feed regardless of stream length
            rnn_base = 2 * cfg.max_hyps
            self._carry = _compact_rnn_carry(
                self._carry, cfg.word_end_limit * emissions.shape[1]
            )
        self._carry, recs = _decode_block(
            self.dec.tables,
            self.dec.lm,
            self.dec.lm_prep,
            jnp.asarray(emissions),
            jnp.int32(self._t),
            jnp.asarray(self._n_frames),
            self.dec.bla,
            self.dec.rnn,
            self._carry,
            cfg,
            self.dec.tree.max_word_ends,
            min(cfg.root_hyps, cfg.max_hyps),
            min(kbranch, cfg.max_hyps),
            rnn_base=rnn_base,
        )
        self._recs.append(recs)
        self._t += emissions.shape[1]
        return self

    @property
    def frames_fed(self) -> int:
        return self._t

    # ------------------------------------------------------------- results
    def _finalize(self, names: Optional[Sequence[str]]) -> List[DecodeResult]:
        recs = tuple(
            jnp.concatenate(parts, axis=0) for parts in zip(*self._recs)
        )
        # pad the record buffers to the bucket grid: padded rows are
        # invalid records (never referenced — bp chains only point at
        # real frames), and the fixed shapes reuse one executable
        pad = (-self._t) % _REC_BUCKET
        if pad:
            fill = (-1, 1e30, -1, 0.0, -1, -1)
            recs = tuple(
                jnp.concatenate(
                    [r, jnp.full((pad,) + r.shape[1:], f, r.dtype)], axis=0
                )
                for r, f in zip(recs, fill)
            )
        captured = jnp.asarray(self._n_frames <= self._t)
        best, records = _finalize_stream(
            self.dec.lm,
            self.dec.lm_prep,
            recs,
            self._carry,
            captured,
            self.dec.cfg,
            self.dec.tree.num_final_states,
            self.dec.rnn,
        )
        self.dec._last_device_records = records
        self.dec._last_n_frames_dev = np.minimum(self._n_frames, self._t)
        names = names or [f"utt{i}" for i in range(self._B)]
        return self.dec._results_from(best, names)

    def current_best(
        self, names: Optional[Sequence[str]] = None
    ) -> List[DecodeResult]:
        """Best sentences so far, without disturbing the live beam
        (ref: getCurrentBestSentence mid-segment)."""
        assert self._recs, "no frames fed"
        return self._finalize(names)

    def finalize(
        self, names: Optional[Sequence[str]] = None
    ) -> List[DecodeResult]:
        """Final best sentences; equals the offline decode when the fed
        frames cover each utterance's declared n_frames."""
        assert self._recs, "no frames fed"
        return self._finalize(names)
