"""First-pass RNN-LM fusion tests (search/rnn_fusion.py).

Parity strategy: the fusion's recombination identity is the n-gram
automaton state, so with an n-gram LM whose contexts cover every word
sequence the test can reach, recombination only merges identical word
histories and the fused decode must equal a host brute force over word
sequences scored by alignment + lm_scale*ngram + weight*rnn (the
``Lm::TFRecurrentLanguageModel`` semantics with vacuous truncation).
"""

import itertools
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from rasr_tpu.align.graph import build_linear_graph
from rasr_tpu.corpus.lexicon import Lexicon, build_default_silence
from rasr_tpu.models.hmm import HmmTopology, Tdp, TransitionModel
from rasr_tpu.models.lm.arpa import NgramLm
from rasr_tpu.models.lm.ngram_tpu import compile_ngram
from rasr_tpu.models.lm.rnn import RnnLm
from rasr_tpu.models.lm.rnn import forward as rnn_forward
from rasr_tpu.models.tying import MonophoneStateTying
from rasr_tpu.ops.viterbi import viterbi_align
from rasr_tpu.search.decoder import BeamConfig, TreeDecoder
from rasr_tpu.search.rnn_fusion import build_rnn_fusion, cell_step, word_scores
from rasr_tpu.search.tree import build_prefix_tree


@pytest.fixture(scope="module")
def rnnlm():
    rng = np.random.default_rng(7)
    words = ["AB", "BA", "AA"]
    sents = [
        [words[rng.integers(0, 3)] for _ in range(rng.integers(1, 4))]
        for _ in range(40)
    ]
    return RnnLm.train_from_text(sents, embed_dim=8, hidden_dim=12, epochs=30)


def _flax_lstm_logits(params, toks):
    """Independent oracle: flax's LSTMCell + Dense over the same
    parameters (gate kernels split back into flax's per-gate layout)."""
    nn = pytest.importorskip("flax.linen")
    H = params["wh"].shape[0]
    E = params["wx"].shape[0]
    gate = lambda w, g: w[:, g * H : (g + 1) * H]
    lstm = {}
    for g, name in enumerate("ifgo"):
        lstm["i" + name] = {"kernel": gate(params["wx"], g)}
        lstm["h" + name] = {
            "kernel": gate(params["wh"], g),
            "bias": params["b"][g * H : (g + 1) * H],
        }
    cell = nn.OptimizedLSTMCell(H)
    carry = cell.initialize_carry(jax.random.PRNGKey(0), (toks.shape[0], E))
    emb = params["embed"][toks]
    out = []
    for t in range(toks.shape[1]):
        carry, y = cell.apply({"params": lstm}, carry, emb[:, t])
        out.append(
            nn.Dense(params["proj_b"].shape[0]).apply(
                {"params": {"kernel": params["proj_w"], "bias": params["proj_b"]}},
                y,
            )
        )
    return jnp.stack(out, axis=1)


def test_cell_matches_flax_module(rnnlm):
    """The plain-array LSTM (the LM's own forward and the extracted
    fusion cell + projection) reproduces flax's LSTMCell over the same
    parameters (same math)."""
    vocab = rnnlm.vocab
    fusion = build_rnn_fusion(rnnlm, vocab, weight=1.0)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, len(vocab), size=(2, 5)).astype(np.int32)
    with jax.default_matmul_precision("highest"):
        logits_ref = _flax_lstm_logits(rnnlm.params, jnp.asarray(toks))
    logits_own, _ = rnn_forward(rnnlm.params, jnp.asarray(toks))
    np.testing.assert_allclose(
        np.asarray(logits_own), np.asarray(logits_ref), atol=1e-5
    )
    H = fusion.hidden
    c = jnp.zeros((2, H))
    h = jnp.zeros((2, H))
    for t in range(toks.shape[1]):
        x = fusion.emb[toks[:, t]]
        c, h = cell_step(fusion, x, c, h)
        logits = h @ fusion.proj_w + fusion.proj_b
        np.testing.assert_allclose(
            np.asarray(logits), np.asarray(logits_ref[:, t]), atol=1e-5
        )
    # word_scores = -log softmax at the picked ids
    wid = jnp.asarray([1, 2])
    want = -jax.nn.log_softmax(logits_ref[:, -1])[jnp.arange(2), wid]
    got = word_scores(fusion, h, wid)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-5)


@pytest.fixture(scope="module")
def setup(rnnlm):
    lex = Lexicon()
    build_default_silence(lex)
    lex.add_lemma(["AB"], [(["a", "b"], 0.0)])
    lex.add_lemma(["BA"], [(["b", "a"], 0.0)])
    lex.add_lemma(["AA"], [(["a", "a"], 0.0)])
    topo = HmmTopology(states_per_phone=1, silence_states=1)
    tying = MonophoneStateTying(lex, topo)
    trans = TransitionModel(
        speech=Tdp(loop=1.0, forward=0.0, skip=math.inf, exit=0.5),
        silence=Tdp(loop=0.2, forward=0.5, skip=math.inf, exit=0.3),
    )
    # every triple is a training sentence: the order-5 LM holds every
    # context the brute force can reach, so the decoder's lm_state IS
    # the full word history (vacuous recombination truncation)
    words = ["AB", "BA", "AA"]
    text = [list(t) for t in itertools.product(words, repeat=3)]
    lm = NgramLm.train_from_text(text, order=5)
    tables = compile_ngram(lm)
    tree = build_prefix_tree(lex, tying, topo, trans, lm_vocab=lm.vocab)
    fusion = build_rnn_fusion(rnnlm, lm.vocab, weight=0.6)
    return lex, topo, tying, trans, lm, tables, tree, fusion


def _oracle_best(lex, topo, tying, trans, lm, rnnlm, weight, emis, T,
                 lm_scale, max_words=4):
    """Brute force incl. the fused RNN score (decoder semantics: real
    scored words advance the RNN state, silence does not; </s> scored
    at the end by both LMs)."""
    words = ["AB", "BA", "AA"]
    eos = lm.vocab["</s>"]
    items = words + ["[SILENCE]"]
    best = (np.inf, None)

    def lm_cost_of(seq):
        h = lm.start_history()
        rh: tuple = ()
        c = 0.0
        for w in seq:
            if w == "[SILENCE]":
                continue
            wid = lm.vocab[w]
            c += lm_scale * lm.score(h, wid)
            h = lm.extended_history(h, wid)
            rid = rnnlm.vocab.get(w)
            c += weight * rnnlm.score(rh, rid)
            rh = rh + (rid,)
        c += lm_scale * lm.score(h, eos)
        c += weight * rnnlm.score(rh, rnnlm.vocab["</s>"])
        return c

    for n in range(1, max_words + 1):
        for seq in itertools.product(items, repeat=n):
            g = build_linear_graph(
                " ".join(seq), lex, tying, topo, trans, optional_silence=False
            )
            if g.num_states > T:
                continue
            e = emis[:, :, g.emission_ids]
            cost, _ = viterbi_align(
                jnp.asarray(e), jnp.asarray(g.loop[None]), jnp.asarray(g.fwd[None]),
                jnp.asarray(g.skip[None]), jnp.asarray(g.init[None]),
                jnp.asarray(g.final[None]), jnp.asarray([T]),
            )
            total = float(np.asarray(cost)[0]) + lm_cost_of(seq)
            if total < best[0]:
                best = (total, seq)
    return best


@pytest.mark.parametrize("variant", ["plain", "rsel_defer"])
def test_rnn_fusion_decode_matches_oracle(setup, rnnlm, rng, variant):
    """Pruning off: fused decode == brute-force minimum over word
    sequences under am + lm_scale*ngram + weight*rnn."""
    lex, topo, tying, trans, lm, tables, tree, fusion = setup
    M = tying.num_classes
    T = 7
    lm_scale = 0.7
    kw = {}
    if variant == "rsel_defer":
        kw = dict(root_select=2048, deferred_emission=True)
    cfg = BeamConfig(
        max_hyps=512, beam=1e9, word_end_limit=64, root_hyps=512,
        lm_scale=lm_scale, **kw,
    )
    dec = TreeDecoder(tree, tables, cfg, rnn_fusion=fusion)
    for trial in range(2):
        emis = rng.uniform(0.0, 6.0, size=(1, T, M)).astype(np.float32)
        (res,) = dec.decode_scores(emis, np.array([T]))
        oracle_score, oracle_seq = _oracle_best(
            lex, topo, tying, trans, lm, rnnlm, fusion.weight, emis, T,
            lm_scale,
        )
        np.testing.assert_allclose(res.score, oracle_score, rtol=1e-4, atol=1e-3)
        got = [l.primary_orth for l in res.lemmas]
        assert got == list(oracle_seq), (variant, trial, got, oracle_seq)


def test_rnn_fusion_changes_the_answer(setup, rnnlm, rng):
    """The fusion must actually matter: across random emissions, some
    decodes differ between weight=0 (pure n-gram) and the fused decode,
    and fused scores include the RNN dimension."""
    lex, topo, tying, trans, lm, tables, tree, fusion = setup
    M = tying.num_classes
    cfg = BeamConfig(
        max_hyps=512, beam=1e9, word_end_limit=64, root_hyps=512,
        lm_scale=0.7,
    )
    dec0 = TreeDecoder(tree, tables, cfg)
    dec1 = TreeDecoder(tree, tables, cfg, rnn_fusion=fusion)
    differs = 0
    for trial in range(6):
        emis = rng.uniform(0.0, 4.0, size=(1, 7, M)).astype(np.float32)
        (a,) = dec0.decode_scores(emis, np.array([7]))
        (b,) = dec1.decode_scores(emis, np.array([7]))
        if a.orth != b.orth or abs(a.score - b.score) > 1e-3:
            differs += 1
    assert differs > 0


def test_rnn_fusion_streaming_blocks_match_offline(setup, rng):
    """STREAMING RNN fusion (r2 verdict item 6): block feeds with the
    bounded-pool compaction between blocks must reproduce the offline
    fused decode exactly — the pool holds only 2K live rows + R*Tb
    block rows regardless of stream length."""
    from rasr_tpu.search.streaming import StreamingDecoder

    lex, topo, tying, trans, lm, tables, tree, fusion = setup
    M = tying.num_classes
    T, B = 9, 2
    cfg = BeamConfig(
        max_hyps=128, beam=1e9, word_end_limit=32, root_hyps=128,
        lm_scale=0.7,
    )
    dec = TreeDecoder(tree, tables, cfg, rnn_fusion=fusion)
    emis = rng.uniform(0.0, 6.0, size=(B, T, M)).astype(np.float32)
    nfr = np.array([T, T - 3], np.int32)
    offline = dec.decode_scores(emis, nfr)

    sd = StreamingDecoder(dec).restart(B, n_frames=nfr)
    for lo in (0, 3, 6):  # three uneven blocks: 3 + 3 + 3
        sd.feed(emis[:, lo : lo + 3])
    online = sd.finalize()
    for a, b in zip(offline, online):
        np.testing.assert_allclose(b.score, a.score, rtol=1e-5, atol=1e-4)
        assert a.words == b.words


def test_rnn_fusion_streaming_memory_is_bounded(setup, rng):
    """The pool never grows past 2K + R*Tb rows no matter how many
    blocks are fed (the O(R*T) ring is gone)."""
    from rasr_tpu.search.streaming import StreamingDecoder

    lex, topo, tying, trans, lm, tables, tree, fusion = setup
    M = tying.num_classes
    cfg = BeamConfig(
        max_hyps=64, beam=1e9, word_end_limit=16, root_hyps=64,
        lm_scale=0.7,
    )
    dec = TreeDecoder(tree, tables, cfg, rnn_fusion=fusion)
    sd = StreamingDecoder(dec).restart(1)
    Tb = 4
    cap = 2 * cfg.max_hyps + cfg.word_end_limit * Tb
    for _ in range(6):  # 24 frames fed; ring form would need R*24 rows
        sd.feed(rng.uniform(0.0, 6.0, size=(1, Tb, M)).astype(np.float32))
        assert sd._carry[-2].shape[1] == cap
    assert sd.finalize()[0].score < 1e29


def test_rnn_fusion_composes_with_bigram_lookahead(setup, rng):
    """RNN fusion + bigram-lookahead shaping TOGETHER (both ride carry
    extras through the sorts): shaping must cancel (same fused scores
    as fusion alone), offline and via streaming blocks."""
    from rasr_tpu.search.lookahead import build_bigram_lookahead
    from rasr_tpu.search.streaming import StreamingDecoder

    lex, topo, tying, trans, lm, tables, tree, fusion = setup
    bla = build_bigram_lookahead(tree, lm, num_classes=4)
    assert bla is not None
    M = tying.num_classes
    T, B = 8, 2
    emis = rng.uniform(0.0, 6.0, size=(B, T, M)).astype(np.float32)
    nfr = np.full(B, T, np.int32)
    cfg = BeamConfig(
        max_hyps=64, beam=1e9, word_end_limit=16, root_hyps=64,
        lm_scale=0.7,
    )
    plain = TreeDecoder(tree, tables, cfg, rnn_fusion=fusion).decode_scores(
        emis, nfr
    )
    dec = TreeDecoder(
        tree, tables, cfg, bigram_la=bla, rnn_fusion=fusion
    )
    both = dec.decode_scores(emis, nfr)
    for a, b in zip(plain, both):
        np.testing.assert_allclose(b.score, a.score, rtol=1e-5, atol=1e-4)
        assert a.words == b.words
    sd = StreamingDecoder(dec).restart(B, n_frames=nfr)
    for lo in (0, 4):
        sd.feed(emis[:, lo : lo + 4])
    for a, b in zip(both, sd.finalize()):
        np.testing.assert_allclose(b.score, a.score, rtol=1e-5, atol=1e-4)
        assert a.words == b.words


def test_rnn_fusion_composes_with_beam_partitioning(setup, rng):
    """RNN fusion under beam partitioning (r3 verdict item 4): the pool
    row rides the local sorts AND the all_gather merge as a payload
    column; the word-end LSTM step + pool writes run replicated after
    the merge. Partitioned fused decode == single-device fused decode
    at exact settings (full-coverage limits)."""
    from rasr_tpu.parallel.mesh import make_mesh

    lex, topo, tying, trans, lm, tables, tree, fusion = setup
    M = tying.num_classes
    T, B = 8, 2
    emis = rng.uniform(0.0, 6.0, size=(B, T, M)).astype(np.float32)
    nfr = np.array([T, T - 2], np.int32)
    cfg = BeamConfig(
        max_hyps=64, beam=1e9, word_end_limit=16, root_hyps=64,
        branch_hyps=64, lm_scale=0.7,
    )
    dec = TreeDecoder(tree, tables, cfg, rnn_fusion=fusion)
    ref = dec.decode_scores(emis, nfr)
    mesh = make_mesh(data=2, model=4)
    got = dec.decode_scores(emis, nfr, mesh=mesh, beam_axis="model")
    for r, g in zip(ref, got):
        assert r.words == g.words
        np.testing.assert_allclose(r.score, g.score, rtol=1e-5, atol=1e-4)
