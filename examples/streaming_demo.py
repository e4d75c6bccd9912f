#!/usr/bin/env python
"""Online (streaming) recognition demo: restart / feed blocks / current_best.

The reference's search API is online (Search::SearchAlgorithm — feed one
feature at a time, query the current best sentence mid-segment); the
batched form feeds BLOCKS of frames into a persistent on-device beam
(search/streaming.StreamingDecoder) so the hot loop stays on-chip and
host round-trips amortize. This demo builds a tiny tone-word system
in-process, then "receives" audio block by block like a serving
frontend would:

  * after every block it prints the current best partial hypothesis
    (the reference's getCurrentBestSentence semantics), and
  * at the end it finalizes and asserts the streamed result is
    IDENTICAL to the offline whole-utterance decode — the streaming
    path is the same scan step, so exactness carries over.

Run:  python examples/streaming_demo.py   (CPU, ~1 min; set
RECIPE_ON_GPU=1 to run on the GPU.)
"""

from __future__ import annotations

import math
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
if not os.environ.get("RECIPE_ON_GPU"):
    import jax

    jax.config.update("jax_platforms", "cpu")

from rasr_tpu.corpus.lexicon import Lexicon, build_default_silence
from rasr_tpu.models.gmm import MixtureSet
from rasr_tpu.models.hmm import HmmTopology, Tdp, TransitionModel
from rasr_tpu.models.lm.arpa import NgramLm
from rasr_tpu.models.lm.ngram_tpu import compile_ngram
from rasr_tpu.models.scorer import GmmFeatureScorer
from rasr_tpu.models.tying import MonophoneStateTying
from rasr_tpu.ops.frontend import FeatureFrontend, FrontendConfig
from rasr_tpu.search.decoder import BeamConfig, TreeDecoder
from rasr_tpu.search.streaming import StreamingDecoder
from rasr_tpu.search.tree import build_prefix_tree
from rasr_tpu.align.aligner import linear_segmentation
from rasr_tpu.align.graph import build_linear_graph
from rasr_tpu.train.em import GmmAccumulator, accumulate, estimate

SR = 16000
TONES = {"a": 500.0, "b": 2000.0}
WORDS = {"AB": ["a", "b"], "BA": ["b", "a"]}


def tone(sym: str, dur: float, rng) -> np.ndarray:
    t = np.arange(int(dur * SR)) / SR
    return (0.3 * np.sin(2 * np.pi * TONES[sym] * t)
            + 0.01 * rng.normal(size=t.shape)).astype(np.float32)


def silence(dur: float, rng) -> np.ndarray:
    return (0.002 * rng.normal(size=int(dur * SR))).astype(np.float32)


def synthesize(words, rng) -> np.ndarray:
    parts = [silence(0.15, rng)]
    for w in words:
        for p in WORDS[w]:
            parts.append(tone(p, 0.25, rng))
        parts.append(silence(0.15, rng))
    return np.concatenate(parts)


def main() -> int:
    rng = np.random.default_rng(7)
    # ---- system build (library level; the toy recipe shows the tools)
    lex = Lexicon()
    build_default_silence(lex)
    for orth, phones in WORDS.items():
        lex.add_lemma([orth], [(phones, 0.0)])
    topo = HmmTopology(states_per_phone=1, silence_states=1)
    tying = MonophoneStateTying(lex, topo)
    trans = TransitionModel(
        speech=Tdp(loop=0.5, forward=0.0, skip=math.inf, exit=0.5),
        silence=Tdp(loop=0.1, forward=0.5, skip=math.inf, exit=0.3),
    )
    lm = NgramLm.train_from_text(
        [["AB", "BA"], ["BA", "AB"], ["AB", "AB"], ["BA", "BA"]], order=2
    )
    tables = compile_ngram(lm)
    tree = build_prefix_tree(lex, tying, topo, trans, lm_vocab=lm.vocab)

    # streaming-friendly frontend: no segment-global statistics (a
    # serving frontend can't see the whole utterance; sliding CMVN or
    # none keep the features causal-ish per block)
    fe = FeatureFrontend(FrontendConfig(normalize="none"))

    # quick GMM from linearly segmented training audio (flat start + EM)
    train_texts = [["AB", "BA"], ["BA", "AB"], ["AB", "AB"], ["BA", "BA"]]
    waves = [synthesize(ws, rng) for ws in train_texts]
    S = max(len(w) for w in waves)
    samples = np.zeros((len(waves), S), np.float32)
    lengths = np.array([len(w) for w in waves])
    for i, w in enumerate(waves):
        samples[i, : len(w)] = w
    feats, nf = fe(samples, lengths)
    feats, nf = np.asarray(feats), np.asarray(nf)
    graphs = [
        build_linear_graph(" ".join(ws), lex, tying, topo, trans)
        for ws in train_texts
    ]
    model = None
    labels = linear_segmentation(graphs, nf)
    pad = feats.shape[1] - labels.shape[1]
    if pad > 0:
        labels = np.pad(labels, ((0, 0), (0, pad)), constant_values=-1)
    for it in range(3):
        acc = GmmAccumulator.zeros(tying.num_classes, 1, feats.shape[-1])
        accumulate(acc, model or MixtureSet.single_density(
            np.zeros((tying.num_classes, feats.shape[-1]), np.float32),
            np.ones((tying.num_classes, feats.shape[-1]), np.float32)),
            feats, labels)
        model = estimate(acc, prev=model)
    scorer = GmmFeatureScorer(model)
    decoder = TreeDecoder(
        tree, tables, BeamConfig(max_hyps=128, word_end_limit=16, lm_scale=2.0)
    )

    # ---- the online part: blocks arrive, the beam persists on device
    test_words = ["AB", "BA", "AB"]
    audio = synthesize(test_words, rng)
    feats, nf = fe(audio[None, :], np.array([len(audio)]))
    emis = np.asarray(scorer(feats))  # a serving stack would score per block
    T = int(nf[0])

    BLOCK = 32  # frames per feed (~0.32 s of audio)
    sd = StreamingDecoder(decoder).restart(batch_size=1)  # length unknown
    t = 0
    print(f"streaming {T} frames in {BLOCK}-frame blocks "
          f"(reference: {' '.join(test_words)})")
    while t < T:
        block = emis[:, t : t + BLOCK]
        sd.feed(block)
        t += block.shape[1]
        partial = sd.current_best()[0]
        print(f"  t={t * 0.01:5.2f}s  partial: {partial.orth!r}")
    final = sd.finalize()[0]
    print(f"final:   {final.orth!r}  (score {final.score:.2f})")

    offline = decoder.decode_scores(emis[:, :T], np.array([T], np.int32))[0]
    assert final.words == offline.words, (final.words, offline.words)
    assert abs(final.score - offline.score) < 1e-4
    assert final.words == test_words, (final.words, test_words)
    print("streaming == offline decode; hypothesis matches the reference")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
