"""Generic WFST decoding through the shared token-passing decoder."""

import numpy as np
import pytest

from rasr_tpu.fsa.automaton import Automaton
from rasr_tpu.models.lm.arpa import NgramLm
from rasr_tpu.models.lm.ngram_tpu import compile_ngram
from rasr_tpu.search.decoder import BeamConfig, TreeDecoder
from rasr_tpu.search.wfst import compile_wfst


class _Lemma:
    def __init__(self, orth):
        self.primary_orth = orth
        self.special = None

    def eval_tokens(self):
        return [self.primary_orth]


def _grammar_fsa():
    """Two-word grammar: (GO (LEFT|RIGHT)) with classes:
    GO=cls0, LEFT=cls1, RIGHT=cls2. One emitting arc per word."""
    fsa = Automaton()
    s0, s1, s2 = fsa.add_state(), fsa.add_state(), fsa.add_state()
    fsa.initial = s0
    # ilabel = class+1, olabel = lemma+1
    fsa.add_arc(s0, s1, 1, 1, 0.0)  # GO (cls 0, lemma 0)
    fsa.add_arc(s1, s2, 2, 2, 0.0)  # LEFT (cls 1, lemma 1)
    fsa.add_arc(s1, s2, 3, 3, 0.5)  # RIGHT (cls 2, lemma 2), costlier
    fsa.set_final(s2)
    return fsa


@pytest.fixture
def zerolm():
    # trivial LM tables (no-LM words bypass lookup anyway)
    lm = NgramLm.train_from_text([["x"]], order=1)
    return compile_ngram(lm)


def test_wfst_decode_follows_emissions(zerolm):
    lemmas = [_Lemma("GO"), _Lemma("LEFT"), _Lemma("RIGHT")]
    tree = compile_wfst(_grammar_fsa(), num_classes=3, lemmas=lemmas, loop_cost=0.2)
    dec = TreeDecoder(tree, zerolm, BeamConfig(max_hyps=16, word_end_limit=8))
    # emissions: 3 frames GO, 3 frames LEFT
    T, M = 6, 3
    emis = np.full((1, T, M), 5.0, np.float32)
    emis[0, :3, 0] = 0.0
    emis[0, 3:, 1] = 0.0
    (res,) = dec.decode_scores(emis, np.array([T]))
    assert res.orth == "GO LEFT"
    # now favor RIGHT acoustically enough to beat its 0.5 grammar cost
    emis2 = np.full((1, T, M), 5.0, np.float32)
    emis2[0, :3, 0] = 0.0
    emis2[0, 3:, 2] = 0.0
    (res2,) = dec.decode_scores(emis2, np.array([T]))
    assert res2.orth == "GO RIGHT"


def test_wfst_grammar_cost_breaks_ties(zerolm):
    lemmas = [_Lemma("GO"), _Lemma("LEFT"), _Lemma("RIGHT")]
    tree = compile_wfst(_grammar_fsa(), num_classes=3, lemmas=lemmas, loop_cost=0.2)
    dec = TreeDecoder(tree, zerolm, BeamConfig(max_hyps=16, word_end_limit=8))
    # LEFT and RIGHT acoustically identical -> grammar cost decides
    T, M = 4, 3
    emis = np.full((1, T, M), 5.0, np.float32)
    emis[0, :2, 0] = 0.0
    emis[0, 2:, 1] = 0.0
    emis[0, 2:, 2] = 0.0
    (res,) = dec.decode_scores(emis, np.array([T]))
    assert res.orth == "GO LEFT"  # cheaper grammar arc wins


def test_wfst_rejects_ungrammatical(zerolm):
    """Emissions favoring LEFT first can't produce LEFT-first output."""
    lemmas = [_Lemma("GO"), _Lemma("LEFT"), _Lemma("RIGHT")]
    tree = compile_wfst(_grammar_fsa(), num_classes=3, lemmas=lemmas, loop_cost=0.2)
    dec = TreeDecoder(tree, zerolm, BeamConfig(max_hyps=16, word_end_limit=8))
    T, M = 4, 3
    emis = np.full((1, T, M), 2.0, np.float32)
    emis[0, :2, 1] = 0.0  # LEFT acoustics first...
    emis[0, 2:, 0] = 0.0  # ...then GO
    (res,) = dec.decode_scores(emis, np.array([T]))
    # grammar only allows GO (LEFT|RIGHT)
    assert res.words[0] == "GO" if res.words else True


def _cyclic_grammar_fsa():
    """A (B|C)* D — junction states + dense-arc cycles (the general
    WFST shape: word-end re-entries at non-root junctions)."""
    fsa = Automaton()
    s0, s1, s2 = fsa.add_state(), fsa.add_state(), fsa.add_state()
    fsa.initial = s0
    fsa.add_arc(s0, s1, 1, 1, 0.0)  # A
    fsa.add_arc(s1, s1, 2, 2, 0.1)  # B (loop)
    fsa.add_arc(s1, s1, 3, 3, 0.2)  # C (loop)
    fsa.add_arc(s1, s2, 4, 4, 0.0)  # D
    fsa.set_final(s2)
    return fsa


def test_wfst_bigram_lookahead_exact_shaping():
    """Bigram (word-set) lookahead on a WFST network with junction
    re-entries: the general builder (lookahead._wordset_general) must
    produce tables with ``reentry=True`` and the shaped decode must be
    EXACT — identical words and scores to the unshaped decode at
    pruning off (potential telescoping incl. the decoder's re-entry
    add-back of the junction node's correction).

    Ref: SURVEY §2.5 src/Search/Wfst/ — the reference's LM lookahead
    covers statically composed search spaces, not just the prefix tree."""
    from rasr_tpu.search.lookahead import build_bigram_lookahead

    words = ["A", "B", "C", "D"]
    lemmas = [_Lemma(w) for w in words]
    rng = np.random.default_rng(5)
    sents = []
    for _ in range(60):
        mid = [words[1 + int(rng.integers(2))] for _ in range(int(rng.integers(0, 4)))]
        sents.append(["A"] + mid + ["D"])
    lm = NgramLm.train_from_text(sents, order=2)
    lm_words = {i: lm.vocab[w] for i, w in enumerate(words)}
    tree = compile_wfst(
        _cyclic_grammar_fsa(), num_classes=4, lemmas=lemmas,
        loop_cost=0.3, lm_words=lm_words,
    )
    bla = build_bigram_lookahead(tree, lm, num_classes=6)
    assert bla is not None and bla.deep and bla.reentry
    tables = compile_ngram(lm)
    cfg = BeamConfig(max_hyps=64, word_end_limit=32, root_hyps=16,
                     lm_scale=1.0)
    plain = TreeDecoder(tree, tables, cfg)
    shaped = TreeDecoder(tree, tables, cfg, bigram_la=bla)
    for seed in range(4):
        r = np.random.default_rng(seed)
        T, M = 10, 4
        emis = r.uniform(0.0, 4.0, size=(2, T, M)).astype(np.float32)
        nf = np.array([T, T - 3])
        a = plain.decode_scores(emis, nf)
        b = shaped.decode_scores(emis, nf)
        for x, y in zip(a, b):
            assert x.words == y.words, (seed, x.words, y.words)
            np.testing.assert_allclose(x.score, y.score, rtol=1e-5, atol=1e-4)


def test_wfst_bigram_lookahead_partitioned_exact():
    """Partitioned-beam (gather-path) WFST bigram shaping: the word-end
    undo re-derives phi from the CURRENT node, so exactness REQUIRES
    the decoder's junction re-entry add-back (unlike the payload path,
    where any entry value telescopes out) — this is the test with teeth
    for the re-entry correction."""
    from rasr_tpu.parallel.mesh import make_mesh
    from rasr_tpu.search.lookahead import build_bigram_lookahead

    words = ["A", "B", "C", "D"]
    lemmas = [_Lemma(w) for w in words]
    rng = np.random.default_rng(5)
    sents = []
    for _ in range(60):
        mid = [words[1 + int(rng.integers(2))] for _ in range(int(rng.integers(0, 4)))]
        sents.append(["A"] + mid + ["D"])
    lm = NgramLm.train_from_text(sents, order=2)
    lm_words = {i: lm.vocab[w] for i, w in enumerate(words)}
    tree = compile_wfst(
        _cyclic_grammar_fsa(), num_classes=4, lemmas=lemmas,
        loop_cost=0.3, lm_words=lm_words,
    )
    bla = build_bigram_lookahead(tree, lm, num_classes=6)
    assert bla is not None and bla.reentry
    tables = compile_ngram(lm)
    cfg = BeamConfig(max_hyps=32, word_end_limit=16, root_hyps=32,
                     branch_hyps=32, lm_scale=1.0)
    ref = TreeDecoder(tree, tables, cfg)
    shaped = TreeDecoder(tree, tables, cfg, bigram_la=bla)
    mesh = make_mesh(data=2, model=4)
    r = np.random.default_rng(1)
    T, M = 10, 4
    emis = r.uniform(0.0, 4.0, size=(2, T, M)).astype(np.float32)
    nf = np.array([T, T - 3])
    a = ref.decode_scores(emis, nf)
    b = shaped.decode_scores(emis, nf, mesh=mesh, beam_axis="model")
    for x, y in zip(a, b):
        assert x.words == y.words, (x.words, y.words)
        np.testing.assert_allclose(x.score, y.score, rtol=1e-4, atol=1e-3)
