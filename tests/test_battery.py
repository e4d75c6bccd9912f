"""Search-error battery regression (SURVEY §6 / BASELINE configs 4-5).

A scaled-down instance of the synthetic LVCSR battery
(rasr_tpu/pipeline/battery.py, full grid in
examples/search_error_battery.py): prefix-shared lexicon + homophones,
4-gram LM over a Markov source, controlled-noise GMM emissions. The
battery must BITE (over-tight pruning causes measurable search error)
and the pinned production operating point must hold search-induced WER
at ~reference level — the in-suite form of the reference's WER-parity
validation, which no toy 0-WER recipe can provide.
"""

import numpy as np
import pytest

from rasr_tpu.pipeline.battery import build_battery_task, run_operating_point
from rasr_tpu.search.decoder import BeamConfig

LM_SCALE = 3.0



pytestmark = pytest.mark.slow  # full tier: pytest -m "" tests/

@pytest.fixture(scope="module")
def task():
    return build_battery_task(
        num_words=300,
        num_utts=10,
        n_train_sentences=4000,
        noise=2.5,
        separation=1.3,
        lookahead_classes=350,
        seed=0,
    )


@pytest.fixture(scope="module")
def reference(task):
    cfg = BeamConfig(
        max_hyps=1024, beam=1e9, word_end_limit=128, root_hyps=64,
        lm_scale=LM_SCALE,
    )
    # calibrated: K=2048 measures identically (se=0, deg=0) — 1024 is
    # already past this task's histogram knee
    return run_operating_point(task, cfg)


def test_battery_reference_is_solvable(task, reference):
    """The wide decode recovers most of the planted transcript — the
    task is hard (noise + homophones: some residual WER) but sound."""
    assert 0.0 < reference["wer"] < 0.25


def test_battery_bites_under_tight_pruning(task, reference):
    """Over-tight pruning must produce measurable search error — if it
    does not, the battery has lost its teeth and says nothing about
    production operating points."""
    tight = BeamConfig(
        max_hyps=48, beam=35.0, word_end_limit=32, root_hyps=8,
        lm_scale=LM_SCALE,
    )
    r = run_operating_point(task, tight, ref_scores=reference["_scores"])
    assert r["search_error_rate"] > 0.2
    assert r["wer"] > reference["wer"] + 0.02


def test_battery_production_point_holds_parity(task, reference):
    """The pinned production operating point: search-induced WER within
    0.5% absolute of the reference decode and near-zero search-error
    mass."""
    prod = BeamConfig(
        max_hyps=256, beam=90.0, word_end_limit=64, root_hyps=16,
        lm_scale=LM_SCALE,
    )
    r = run_operating_point(task, prod, ref_scores=reference["_scores"])
    assert r["wer"] <= reference["wer"] + 0.005
    assert r["mean_degradation"] < 1.0


def test_battery_production_point_with_bigram_lookahead(task, reference):
    """The production point under bigram-lookahead shaping also holds
    parity (shaping is exact; at production width it must not cost
    accuracy either)."""
    prod = BeamConfig(
        max_hyps=256, beam=90.0, word_end_limit=64, root_hyps=16,
        lm_scale=LM_SCALE,
    )
    r = run_operating_point(
        task, prod, bigram=True, ref_scores=reference["_scores"]
    )
    assert r["wer"] <= reference["wer"] + 0.005


def test_battery_cn_and_fcn_decode_quality(task):
    """CN (arc-cluster) and min-fWER decodes over the battery's decode
    lattices: both must be at least as good as the Viterbi decode (on
    these lattices posterior mass concentrates on the MAP path, so the
    expected relation is equality; consensus-beats-MAP is covered by
    the constructed case in test_lattice.py)."""
    from rasr_tpu.lattice.evaluator import EditStats, align_tokens
    from rasr_tpu.lattice.flf import (
        cn_decode,
        confusion_network,
        fcn_decode,
        time_frame_cn,
    )
    from rasr_tpu.lattice.lattice import decoder_lattice

    cfg = BeamConfig(
        max_hyps=256, beam=90.0, word_end_limit=64, root_hyps=16,
        lm_scale=LM_SCALE,
    )
    dec = task.decoder(cfg)
    results = dec.decode_scores(task.emissions, task.n_frames)
    sv, sc, sf = EditStats(), EditStats(), EditStats()
    for b, res in enumerate(results):
        lat = decoder_lattice(dec, b)
        cn = [w for w in cn_decode(confusion_network(lat)) if not w.startswith("[")]
        fc = [w for w in fcn_decode(time_frame_cn(lat)) if not w.startswith("[")]
        sv.add(align_tokens(task.refs[b], res.words)[0])
        sc.add(align_tokens(task.refs[b], cn)[0])
        sf.add(align_tokens(task.refs[b], fc)[0])
    assert sc.errors <= sv.errors
    assert sf.errors <= sv.errors


def test_battery_lm_aware_word_end_rank_at_tight_r(task, reference):
    """LM-aware word-end selection (BeamConfig.word_end_rank_lm) at a
    tight word-end limit: the LM-blind rank loses words the biased rank
    keeps (full-grid evidence in BASELINE.md: K=256/beam=90/R=4 on the
    1k-word task improves WER 9.8% -> 9.1% and search-error 6.2% ->
    2.1%). The pin sits at R=2, where the effect on THIS scaled task is
    multi-utterance-sized (measured: search error 0.30 -> 0.10, mean
    degradation 6.93 -> 1.82, WER 6.2% -> 4.6%) — the r2 verdict's
    lesson: never pin a near-tied float ordering (the old R=3 pin
    asserted a 0.0008 difference on 1.79 with a 1e-6 margin and flipped
    with unrelated decoder changes). Margins here are set at half the
    measured effect size."""
    tight_r = dict(
        max_hyps=256, beam=90.0, word_end_limit=2, root_hyps=16,
        lm_scale=LM_SCALE,
    )
    plain = run_operating_point(
        task, BeamConfig(**tight_r), ref_scores=reference["_scores"]
    )
    ranked = run_operating_point(
        task, BeamConfig(**tight_r, word_end_rank_lm=True),
        ref_scores=reference["_scores"],
    )
    # measured gaps: se 0.20 (2 utts), deg 5.1 — assert half of each
    assert ranked["search_error_rate"] <= plain["search_error_rate"] - 0.1
    assert ranked["mean_degradation"] <= plain["mean_degradation"] - 2.5
    # WER: ranked must not be worse (measured one word better)
    assert ranked["wer"] <= plain["wer"] + 1e-6


def test_battery_across_word_variant_parity_and_shaping():
    """Across-word battery (r3): context-grouped triphone tying + the
    across-word network with planted TRUE cross-word alignments. Pins:
    (a) the wide decode solves the task, (b) the production point holds
    parity, (c) bigram shaping (across-word word-set lookahead) is
    exact at the wide point and does not cost accuracy at production.
    Tight-beam behaviour is documented in BASELINE.md (probe tables) —
    mixed by regime, like the within-word battery."""
    task = build_battery_task(
        num_words=200, num_utts=8, n_train_sentences=3000,
        noise=2.8, separation=1.2, lookahead_classes=250, seed=1,
        across_word=True,
    )
    assert task.bigram_la is not None and task.bigram_la.deep
    ref_cfg = BeamConfig(
        max_hyps=1024, beam=1e9, word_end_limit=128, root_hyps=64,
        lm_scale=LM_SCALE,
    )
    ref = run_operating_point(task, ref_cfg)
    ref_bla = run_operating_point(task, ref_cfg, bigram=True)
    # exactness on the across-word network: shaping cancels
    np.testing.assert_allclose(
        ref_bla["mean_score"], ref["mean_score"], rtol=1e-6
    )
    assert 0.0 <= ref["wer"] < 0.25
    # measured (2026-08-21): plain unigram shaping DEGRADES this point
    # (WER 2.1% -> 6.4%, mean degradation 2.35) while bigram shaping
    # restores reference parity (2.1%, degradation 0.0004) — the
    # across-word network re-enters at context roots where word
    # identity commits LATE, exactly where history-conditioned
    # potentials pay. Margins at ~half the measured effects.
    prod = BeamConfig(
        max_hyps=256, beam=90.0, word_end_limit=64, root_hyps=16,
        branch_hyps=64, lm_scale=LM_SCALE,
    )
    r = run_operating_point(task, prod, ref_scores=ref["_scores"])
    rb = run_operating_point(task, prod, bigram=True, ref_scores=ref["_scores"])
    assert rb["wer"] <= ref["wer"] + 0.005          # bigram: parity
    assert rb["mean_degradation"] < 1.0
    assert rb["wer"] <= r["wer"] - 0.02             # and beats unigram
    assert rb["mean_degradation"] <= r["mean_degradation"] - 1.0
