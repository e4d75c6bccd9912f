"""Gammatone frontend, VTLN, discriminative training tests."""

import numpy as np
import pytest

import jax.numpy as jnp

from rasr_tpu.ops.gammatone import (
    GammatoneConfig,
    GammatoneFrontend,
    apply_vtln,
    gammatone_kernels,
    piecewise_linear_warp,
)


def test_gammatone_kernels_properties():
    kernels, centers = gammatone_kernels(16, 16000)
    assert kernels.shape[0] == 16
    # unit energy
    np.testing.assert_allclose((kernels**2).sum(axis=1), 1.0, rtol=1e-5)
    # centers ascending within [fmin, nyquist]
    assert np.all(np.diff(centers) > 0)
    assert centers[0] >= 99 and centers[-1] <= 8000 + 1e-6


def test_gammatone_frontend_discriminates_tones(rng):
    """A 500Hz tone and a 4kHz tone excite different channels."""
    cfg = GammatoneConfig(num_channels=16)
    fe = GammatoneFrontend(cfg)
    sr = 16000
    t = np.arange(sr // 2) / sr
    low = (0.3 * np.sin(2 * np.pi * 500 * t)).astype(np.float32)
    high = (0.3 * np.sin(2 * np.pi * 4000 * t)).astype(np.float32)
    feats, n = fe(np.stack([low, high]), np.array([len(low), len(high)]))
    feats = np.asarray(feats)
    n0 = int(np.asarray(n)[0])
    assert n0 > 10
    lo_prof = feats[0, :n0].mean(0)
    hi_prof = feats[1, :n0].mean(0)
    assert np.argmax(lo_prof) < np.argmax(hi_prof)


def test_gammatone_dct_output_dim(rng):
    fe = GammatoneFrontend(GammatoneConfig(num_channels=16, num_outputs=8))
    x = rng.normal(size=(1, 8000)).astype(np.float32)
    feats, n = fe(x, np.array([8000]))
    assert feats.shape[-1] == 8 and fe.output_dim == 8


def test_vtln_identity():
    warp = piecewise_linear_warp(64, alpha=1.0)
    spec = np.random.default_rng(0).uniform(size=(3, 64)).astype(np.float32)
    out = np.asarray(apply_vtln(jnp.asarray(spec), jnp.asarray(warp)))
    np.testing.assert_allclose(out, spec, atol=1e-5)


def test_vtln_compresses_or_stretches():
    K = 64
    spec = np.zeros((1, K), np.float32)
    spec[0, 20] = 1.0  # impulse at bin 20
    for alpha, direction in ((1.2, +1), (0.8, -1)):
        warp = piecewise_linear_warp(K, alpha=alpha)
        out = np.asarray(apply_vtln(jnp.asarray(spec), jnp.asarray(warp)))
        peak = int(np.argmax(out[0]))
        # output(k) = input(k/alpha): alpha>1 moves energy to higher bins
        assert np.sign(peak - 20) == direction


def test_ebw_moves_towards_numerator(rng):
    """EBW update moves means toward num stats and away from den stats."""
    from rasr_tpu.models.gmm import MixtureSet
    from rasr_tpu.train.discriminative import MmiAccumulators, ebw_update
    from rasr_tpu.train.em import accumulate

    D = 2
    model = MixtureSet.single_density(
        np.zeros((1, D), np.float32), np.ones((1, D), np.float32)
    )
    acc = MmiAccumulators.zeros(1, 1, D)
    num_data = rng.normal(loc=+2.0, scale=0.5, size=(200, D)).astype(np.float32)
    den_data = rng.normal(loc=-2.0, scale=0.5, size=(200, D)).astype(np.float32)
    accumulate(acc.num, model, num_data, np.zeros(200, np.int32))
    accumulate(acc.den, model, den_data, np.zeros(200, np.int32))
    new = ebw_update(model, acc)
    # pulled towards +2 (num), pushed from -2 (den); magnitude limited by
    # the variance-positivity smoothing
    assert np.all(new.means[0, 0] > 0.1)
    assert np.all(new.variances[0, 0] > 0)


def test_mmi_end_to_end_improves_separation(rng):
    """Full MMI loop on a toy 2-word task: EBW sharpens the decision."""
    from rasr_tpu.align.aligner import BatchAligner
    from rasr_tpu.align.graph import build_linear_graph
    from rasr_tpu.corpus.lexicon import Lexicon, build_default_silence
    from rasr_tpu.lattice.lattice import decoder_lattice
    from rasr_tpu.models.gmm import MixtureSet
    from rasr_tpu.models.hmm import HmmTopology, TransitionModel
    from rasr_tpu.models.lm.arpa import NgramLm
    from rasr_tpu.models.lm.ngram_tpu import compile_ngram
    from rasr_tpu.models.scorer import GmmFeatureScorer
    from rasr_tpu.models.tying import MonophoneStateTying
    from rasr_tpu.search.decoder import BeamConfig, TreeDecoder
    from rasr_tpu.search.tree import build_prefix_tree
    from rasr_tpu.train.discriminative import (
        MmiAccumulators,
        accumulate_denominator_from_lattice,
        accumulate_numerator,
        ebw_update,
    )

    lex = Lexicon()
    build_default_silence(lex)
    lex.add_lemma(["AB"], [(["a", "b"], 0.0)])
    lex.add_lemma(["BA"], [(["b", "a"], 0.0)])
    topo = HmmTopology(states_per_phone=1, silence_states=1)
    tying = MonophoneStateTying(lex, topo)
    trans = TransitionModel()
    M, D = tying.num_classes, 4
    means = rng.normal(size=(M, D)).astype(np.float32) * 1.5  # weakly separated
    model = MixtureSet.single_density(means, np.ones((M, D), np.float32))
    lm = NgramLm.train_from_text([["AB"], ["BA"]], order=1)
    tree = build_prefix_tree(lex, tying, topo, trans, lm_vocab=lm.vocab)

    # an utterance of "AB": frames at slightly noisy class means
    g = build_linear_graph("AB", lex, tying, topo, trans)
    plan = [0, 1, 1, 2, 2, 3]  # sil a a b b sil
    feats = np.stack(
        [means[g.emission_ids[s]] + 0.3 * rng.normal(size=D).astype(np.float32) for s in plan]
    ).astype(np.float32)

    scorer = GmmFeatureScorer(model)
    dec = TreeDecoder(tree, compile_ngram(lm), BeamConfig(max_hyps=64, word_end_limit=16))
    (res,) = dec.decode_scores(np.asarray(scorer(feats[None])), np.array([len(plan)]))
    lat = decoder_lattice(dec, 0)

    aligner = BatchAligner(scorer)
    acc = MmiAccumulators.zeros(M, 1, D)
    (al,) = aligner.align(feats[None], [g], np.array([len(plan)]))
    labels = np.full((1, len(plan)), -1, np.int32)
    labels[0, : al.num_frames] = al.emission_ids
    accumulate_numerator(acc, model, feats[None], labels)
    accumulate_denominator_from_lattice(
        acc, model, feats, lat, aligner, lex, tying, topo, trans
    )
    assert acc.num.count.sum() > 0
    new = ebw_update(model, acc)
    # updated model should still be a valid mixture set
    assert np.all(new.variances > 0)
    assert np.allclose(new.weights.sum(axis=1), 1.0, atol=1e-5)


def test_vtln_estimation_tracks_frequency_shift(rng):
    """Speakers with scaled formants get warping factors on the right side."""
    from rasr_tpu.align.aligner import BatchAligner, linear_segmentation
    from rasr_tpu.align.graph import build_linear_graph
    from rasr_tpu.corpus.lexicon import Lexicon, build_default_silence
    from rasr_tpu.models.gmm import MixtureSet
    from rasr_tpu.models.hmm import HmmTopology
    from rasr_tpu.models.scorer import GmmFeatureScorer
    from rasr_tpu.models.tying import MonophoneStateTying
    from rasr_tpu.ops.frontend import FeatureFrontend, FrontendConfig
    from rasr_tpu.train.em import GmmAccumulator, accumulate, estimate
    from rasr_tpu.train.vtln import estimate_warping_factor

    sr = 16000
    lex = Lexicon()
    build_default_silence(lex)
    lex.add_lemma(["AB"], [(["a", "b"], 0.0)])
    topo = HmmTopology(states_per_phone=1, silence_states=1)
    tying = MonophoneStateTying(lex, topo)
    M = tying.num_classes
    cfg = FrontendConfig(normalize="none")

    def synth(scale):
        def tone(f, d):
            t = np.arange(int(d * sr)) / sr
            return (0.3 * np.sin(2 * np.pi * f * scale * t)).astype(np.float32)
        s = (0.002 * rng.normal(size=int(0.15 * sr))).astype(np.float32)
        return np.concatenate([s, tone(800, 0.3), tone(2400, 0.3), s])

    # train a model on scale-1.0 audio
    train = np.stack([synth(1.0) for _ in range(4)])
    lengths = np.full(4, train.shape[1])
    fe = FeatureFrontend(cfg)
    feats, nf = fe(train, lengths)
    nf = np.asarray(nf)
    graphs = [build_linear_graph("AB", lex, tying, topo) for _ in range(4)]
    model = MixtureSet.single_density(np.zeros((M, 16), np.float32), np.ones((M, 16), np.float32))
    labels = linear_segmentation(graphs, nf)
    labels = np.pad(labels, ((0, 0), (0, feats.shape[1] - labels.shape[1])), constant_values=-1)
    acc = GmmAccumulator.zeros(M, 1, 16)
    accumulate(acc, model, np.asarray(feats), labels)
    model = estimate(acc)
    for _ in range(3):
        als = BatchAligner(GmmFeatureScorer(model, var_floor=0.1)).align(feats, graphs, nf)
        labels = np.full(feats.shape[:2], -1, np.int32)
        for i, al in enumerate(als):
            labels[i, : al.num_frames] = al.emission_ids
        acc = GmmAccumulator.zeros(*model.means.shape)
        accumulate(acc, model, np.asarray(feats), labels)
        model = estimate(acc, prev=model)

    def factory():
        return BatchAligner(GmmFeatureScorer(model, var_floor=0.1))

    alphas = (0.85, 1.0, 1.18)
    results = {}
    for scale in (0.85, 1.0, 1.18):
        utt = np.stack([synth(scale) for _ in range(2)])
        best, scores = estimate_warping_factor(
            utt, np.full(2, utt.shape[1]), graphs[:2], factory, cfg, alphas=alphas
        )
        results[scale] = best
    # matched speaker picks neutral; shifted speakers pick shifted warps
    assert results[1.0] == 1.0
    assert results[1.18] != 1.0 or results[0.85] != 1.0
    # direction: the two shifted speakers should not pick the same side
    if results[1.18] != 1.0 and results[0.85] != 1.0:
        assert (results[1.18] - 1.0) * (results[0.85] - 1.0) < 0


def test_mpe_arc_accuracies():
    from rasr_tpu.lattice.lattice import Lattice, LatticeArc
    from rasr_tpu.train.discriminative import arc_accuracies

    arcs = [
        LatticeArc(0, 1, 0, 1.0, 0.0),  # HELLO 0-10 (matches ref exactly)
        LatticeArc(0, 1, 1, 1.0, 0.0),  # WORLD 0-10 (wrong word, full overlap)
        LatticeArc(1, 2, 2, 1.0, 0.0),  # [SIL] 10-12
    ]
    lat = Lattice(3, arcs, np.array([0, 10, 12], np.int32), {2: 0.0},
                  ["HELLO", "WORLD", "[SIL]"])
    acc = arc_accuracies(lat, ["HELLO"], [(0, 10)])
    np.testing.assert_allclose(acc[0], 1.0)   # correct word, full overlap
    np.testing.assert_allclose(acc[1], 0.0)   # wrong word, full overlap
    np.testing.assert_allclose(acc[2], 0.0)   # silence neutral


def test_mpe_accumulation_runs(rng):
    from rasr_tpu.align.aligner import BatchAligner
    from rasr_tpu.align.graph import build_linear_graph
    from rasr_tpu.corpus.lexicon import Lexicon, build_default_silence
    from rasr_tpu.lattice.lattice import decoder_lattice
    from rasr_tpu.models.gmm import MixtureSet
    from rasr_tpu.models.hmm import HmmTopology, TransitionModel
    from rasr_tpu.models.lm.arpa import NgramLm
    from rasr_tpu.models.lm.ngram_tpu import compile_ngram
    from rasr_tpu.models.scorer import GmmFeatureScorer
    from rasr_tpu.models.tying import MonophoneStateTying
    from rasr_tpu.search.decoder import BeamConfig, TreeDecoder
    from rasr_tpu.search.tree import build_prefix_tree
    from rasr_tpu.train.discriminative import (
        MmiAccumulators, accumulate_mpe_from_lattice, ebw_update,
    )

    lex = Lexicon(); build_default_silence(lex)
    lex.add_lemma(["AB"], [(["a", "b"], 0.0)])
    lex.add_lemma(["BA"], [(["b", "a"], 0.0)])
    topo = HmmTopology(states_per_phone=1, silence_states=1)
    tying = MonophoneStateTying(lex, topo)
    trans = TransitionModel()
    M, D = tying.num_classes, 4
    means = rng.normal(size=(M, D)).astype(np.float32) * 1.5
    model = MixtureSet.single_density(means, np.ones((M, D), np.float32))
    lm = NgramLm.train_from_text([["AB"], ["BA"]], order=1)
    tree = build_prefix_tree(lex, tying, topo, trans, lm_vocab=lm.vocab)
    g = build_linear_graph("AB", lex, tying, topo, trans)
    plan = [0, 1, 1, 2, 2, 3]
    feats = np.stack([
        means[g.emission_ids[s]] + 0.3 * rng.normal(size=D).astype(np.float32)
        for s in plan
    ]).astype(np.float32)
    scorer = GmmFeatureScorer(model)
    dec = TreeDecoder(tree, compile_ngram(lm), BeamConfig(max_hyps=64, word_end_limit=16))
    dec.decode_scores(np.asarray(scorer(feats[None])), np.array([len(plan)]))
    lat = decoder_lattice(dec, 0)
    acc = MmiAccumulators.zeros(M, 1, D)
    expected = accumulate_mpe_from_lattice(
        acc, model, feats, lat, ["AB"], [(0, len(plan))],
        BatchAligner(scorer), lex, tying, topo, trans,
    )
    assert -1.0 <= expected <= 1.0
    new = ebw_update(model, acc)
    assert np.all(new.variances > 0)


def test_profiling_helper(tmp_path):
    """profile_call traces a jitted fn and parses the hlo_stats table
    (rows come only from an accelerator; on the CPU test backend an empty list is the
    documented result — the call path itself must work everywhere)."""
    import jax
    import jax.numpy as jnp

    from rasr_tpu.utils.profiling import profile_call, top_table

    f = jax.jit(lambda x: (x * x).sum())
    out, rows = profile_call(
        f, jnp.ones((64, 64)), log_dir=str(tmp_path / "prof")
    )
    assert float(out) == 64.0 * 64.0
    assert isinstance(rows, list)
    assert isinstance(top_table(rows), str)
