"""First-pass RNN-LM fusion for the tree decoder.

Re-implements the role of the reference's in-search neural LM
(ref: src/Lm/TF* — Lm::TFRecurrentLanguageModel: an RNN LM scored
DURING decoding with per-history hidden-state caching and batched
score requests; recombination stays on truncated histories). The
batched re-design: RNN hidden states live in a POOL inside the scan carry and
each hypothesis carries its state's pool ROW as a sort-payload column
(like the bigram-lookahead class/phi payload — search/decoder.py):

* per frame, the R word-end records batch ONE LSTM step + full-vocab
  projection as matmuls (their source states are one row gather at the
  carried rows); the new states write one contiguous pool slice and
  the re-entry hypotheses point at it;
* hypotheses carry a single int32 row — not state vectors — so the
  payload rides the recombination sorts at negligible cost and every
  decoder configuration (root-select, deferred emission, compact
  branch expansion, streaming blocks) composes;
* recombination remains EXACT n-gram-state equality: two hypotheses
  with equal (tree_state, lm_state) but different RNN histories merge
  and the min-score path's state (row) survives — precisely the
  reference's on-the-fly rescoring semantics with truncated-history
  recombination. With an n-gram automaton of order >= the utterance
  length the truncation is vacuous and fusion scores are exact path
  scores (the parity tests use this).

Memory is BOUNDED: offline scans size the pool to R * T writable rows
for one utterance batch; STREAMING compacts the pool between feeds to
the <= 2K rows any future read can reach (live beam + frozen finals —
decoder._compact_rnn_carry) and re-sizes it to 2K + R * Tb per block,
so an arbitrarily long stream decodes at fixed memory — the role of
the reference's compressed per-history state cache (src/Lm/TF*).

The fused score of a word-end is ``lm_scale * ngram + weight * rnn``
(log-linear interpolation); silence and OOV words leave the RNN state
unchanged (OOV pays a fixed penalty).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..models.lm.rnn import lstm_cell


@dataclasses.dataclass(frozen=True)
class RnnFusionTables:
    """Device pytree of the fused RNN LM (plain-array LSTM cell).

    The cell is models/lm/rnn.py's :func:`lstm_cell` (gate order [i,
    f, g, o]) over the LM's own parameters. ``word_map`` maps n-gram
    LM word ids to RNN vocab ids (-1 = OOV: fixed penalty, state
    unchanged)."""

    emb: jnp.ndarray  # [Vr, E]
    wx: jnp.ndarray  # [E, 4H]
    wh: jnp.ndarray  # [H, 4H]
    b: jnp.ndarray  # [4H]
    proj_w: jnp.ndarray  # [H, Vr]
    proj_b: jnp.ndarray  # [Vr]
    word_map: jnp.ndarray  # [V_ngram] int32
    init_c: jnp.ndarray  # [H] state after <s>
    init_h: jnp.ndarray  # [H]
    weight: float
    oov_cost: float
    end_wid: int  # RNN vocab id of </s> (-1 = no sentence-end scoring)

    @property
    def hidden(self) -> int:
        return self.wh.shape[0]


jax.tree_util.register_pytree_node(
    RnnFusionTables,
    lambda t: (
        (t.emb, t.wx, t.wh, t.b, t.proj_w, t.proj_b, t.word_map,
         t.init_c, t.init_h),
        (t.weight, t.oov_cost, t.end_wid),
    ),
    lambda aux, ch: RnnFusionTables(*ch, *aux),
)


def cell_step(rnn: RnnFusionTables, x, c, h):
    """Batched LSTM cell step: x [..., E], c/h [..., H] -> (c', h')."""
    return lstm_cell(rnn.wx, rnn.wh, rnn.b, x, c, h)


def word_scores(rnn: RnnFusionTables, h, wid):
    """-log p(wid | state h): h [..., H], wid [...] (>=0)."""
    # full precision: these costs decide recombination, and a GPU runs
    # f32 matmuls in TF32 unless told otherwise
    logits = (
        jnp.matmul(h, rnn.proj_w, precision=jax.lax.Precision.HIGHEST)
        + rnn.proj_b
    )  # [..., Vr]
    lse = jax.scipy.special.logsumexp(logits, axis=-1)
    Vr = rnn.proj_b.shape[0]
    picked = jnp.sum(
        logits * jax.nn.one_hot(wid, Vr, dtype=logits.dtype), axis=-1
    )
    return lse - picked


def build_rnn_fusion(
    rnn_lm,  # models.lm.rnn.RnnLm
    ngram_vocab: Dict[str, int],
    weight: float = 0.5,
    oov_cost: float = 99.0,
) -> RnnFusionTables:
    """Extract the LSTM LM's parameters into decoder fusion tables.

    ``ngram_vocab`` is the decoder LM's token->id map (the decoder's
    word ids are n-gram LM ids); tokens absent from the RNN vocab map
    to -1 (OOV)."""
    # through host numpy, so the tables land on the current default
    # device whatever device the LM was trained on
    emb, wx, wh, b, proj_w, proj_b = (
        np.asarray(rnn_lm.params[k])
        for k in ("embed", "wx", "wh", "b", "proj_w", "proj_b")
    )
    H = wh.shape[0]

    V = max(ngram_vocab.values()) + 1 if ngram_vocab else 1
    word_map = np.full(V, -1, np.int32)
    for tok, i in ngram_vocab.items():
        r = rnn_lm.vocab.get(tok)
        if r is not None:
            word_map[i] = r

    # state after <s> (the decoder's initial history)
    bos = rnn_lm.vocab.get("<s>", 0)
    tables = RnnFusionTables(
        emb=jnp.asarray(emb),
        wx=jnp.asarray(wx),
        wh=jnp.asarray(wh),
        b=jnp.asarray(b),
        proj_w=jnp.asarray(proj_w),
        proj_b=jnp.asarray(proj_b),
        word_map=jnp.asarray(word_map),
        init_c=jnp.zeros(H, jnp.float32),
        init_h=jnp.zeros(H, jnp.float32),
        weight=float(weight),
        oov_cost=float(oov_cost),
        end_wid=int(rnn_lm.vocab.get("</s>", -1)),
    )
    c0, h0 = cell_step(
        tables, tables.emb[bos][None], jnp.zeros((1, H)), jnp.zeros((1, H))
    )
    return dataclasses.replace(
        tables,
        init_c=jnp.asarray(c0[0]),
        init_h=jnp.asarray(h0[0]),
    )
