"""Compact branch expansion (BeamConfig.branch_width) correctness.

The compact path packs the selected branch hypotheses' overflow arcs
contiguously into a static slot budget instead of the padded
[branch_hyps, max_degree] fan (ref shape: the fan-out expansion of
src/Search/AdvancedTreeSearch SearchSpace expansion; this is the
static width-budget form). Contract:

* with branch_width >= branch_hyps * max_degree the candidate set is
  IDENTICAL to the dense fan — same words, same scores, under tight
  pruning too (slots fill in the same best-first hyp order);
* with a small budget the decode stays valid (truncation drops the
  worst-ranked hyps' arcs only).

Word-scope skip networks are the target shape (finite cross-phone
skips double the junction fan).
"""

import math

import numpy as np
import pytest

from rasr_tpu.corpus.lexicon import Lexicon, build_default_silence
from rasr_tpu.models.hmm import HmmTopology, Tdp, TransitionModel
from rasr_tpu.models.lm.arpa import NgramLm
from rasr_tpu.models.lm.ngram_tpu import compile_ngram
from rasr_tpu.models.tying import MonophoneStateTying
from rasr_tpu.search.decoder import BeamConfig, TreeDecoder
from rasr_tpu.search.tree import build_prefix_tree


def _system(seed, across=False):
    rng = np.random.default_rng(seed)
    phones = ["p", "q", "r", "s"]
    lex = Lexicon()
    build_default_silence(lex)
    orths = []
    for i in range(6):
        length = int(rng.integers(1, 4))
        pron = [phones[int(rng.integers(len(phones)))] for _ in range(length)]
        orth = f"W{i}_" + "".join(pron).upper()
        lex.add_lemma([orth], [(pron, float(rng.uniform(0, 0.5)))])
        orths.append(orth)
    topo = HmmTopology(states_per_phone=2, silence_states=1)
    tying = MonophoneStateTying(lex, topo)
    # finite skips -> word-scope networks realize cross-phone skip arcs,
    # the branch-fan shape the compact expansion exists for
    trans = TransitionModel(
        speech=Tdp(loop=0.7, forward=0.1, skip=1.4, exit=0.3),
        silence=Tdp(loop=0.2, forward=0.4, skip=math.inf, exit=0.1),
    )
    sents = [
        [orths[int(rng.integers(len(orths)))] for _ in range(3)]
        for _ in range(8)
    ]
    lm = NgramLm.train_from_text(sents, order=2)
    tree = build_prefix_tree(
        lex, tying, topo, trans, lm_vocab=lm.vocab, across_word=across
    )
    M = tying.num_classes
    T = 9
    emis = rng.uniform(0.0, 6.0, size=(2, T, M)).astype(np.float32)
    nf = np.array([T, T - 2], np.int32)
    return tree, compile_ngram(lm), emis, nf


@pytest.mark.parametrize("seed,across,defer", [
    (3, False, False), (4, False, True), (5, True, False), (6, True, True),
])
def test_compact_equals_dense_fan(seed, across, defer):
    tree, tables, emis, nf = _system(seed, across)
    base = BeamConfig(
        max_hyps=32, word_end_limit=8, root_hyps=4, branch_hyps=8,
        lm_scale=0.8, deferred_emission=defer,
    )
    dense = TreeDecoder(tree, tables, base)
    # a budget covering every selected hyp's full fan == the dense fan
    wide = TreeDecoder(
        tree, tables,
        BeamConfig(**{**base.__dict__, "branch_width": 8 * 64}),
    )
    rd = dense.decode_scores(emis, nf)
    rw = wide.decode_scores(emis, nf)
    for a, b in zip(rd, rw):
        assert a.words == b.words, (a.words, b.words)
        np.testing.assert_allclose(a.score, b.score, rtol=1e-5, atol=1e-4)


def test_tight_budget_stays_valid():
    tree, tables, emis, nf = _system(9)
    dec = TreeDecoder(
        tree, tables,
        BeamConfig(max_hyps=32, word_end_limit=8, root_hyps=4,
                   branch_hyps=8, branch_width=4, lm_scale=0.8),
    )
    res = dec.decode_scores(emis, nf)
    assert all(r.score < 1e29 for r in res)


def test_compact_exact_vs_pruning_off_oracle():
    """branch_width wide + pruning off == dense pruning-off decode (the
    exactness contract composes with the compact path)."""
    tree, tables, emis, nf = _system(12)
    exact = TreeDecoder(
        tree, tables,
        BeamConfig(max_hyps=512, word_end_limit=128, root_hyps=512,
                   lm_scale=0.8),
    )
    compact = TreeDecoder(
        tree, tables,
        BeamConfig(max_hyps=512, word_end_limit=128, root_hyps=512,
                   branch_width=4096, lm_scale=0.8),
    )
    for a, b in zip(exact.decode_scores(emis, nf),
                    compact.decode_scores(emis, nf)):
        assert a.words == b.words
        np.testing.assert_allclose(a.score, b.score, rtol=1e-5, atol=1e-4)
