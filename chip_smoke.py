#!/usr/bin/env python
"""Smoke test of the decode pipeline on the GPU: every phase must pass.

Drives the main path once through the entry points a user calls, at the
width of the headline configuration (``bench.build_setup`` defaults:
5k-word lexicon, 2000 tied states x 8 densities, 45-dim LDA, bigram LM,
K=1024, root_select=512, deferred emission; B=64 utterances of 10 s),
with random weights made from ``--seed``, and checks what comes out
against the repository's own references. Phases, in order:

* device    — the platform is ``gpu``; prints the devices and the card's
              name and power limit (nvidia-smi, a child off JAX);
* canary    — ``bench.correctness_canary``: planted decodes plus
              CPU==GPU decode equality on 7 transport configs;
* oracles   — GMM scorer vs float64 numpy, frontend vs a CPU jit, decode
              vs the exhaustive host Viterbi (within- and across-word),
              n-gram LM lookup vs the host LM, int32 bit transport;
* pipeline  — FeatureFrontend -> GmmFeatureScorer ->
              TreeDecoder.decode_scores_device / results_from_device:
              setup and compile seconds, audio-s/s, per-stage times,
              peak device memory, compiles inside the timed batches;
* streaming — StreamingDecoder over the same emissions == offline;
* cli       — the speech-recognizer tool, in process, on a generated
              toy corpus.

``--four-cards`` runs only the four-card decodes (data-parallel over
``make_mesh(data=4)`` and the partitioned beam over a ``model=4`` mesh)
and the one-card decodes they are compared with.

The last line of stdout is one JSON object, printed only when every
phase passed: ``{"ok": true, "device": {"platform": "gpu", "kind": ...,
"count": N}}``. Without a GPU the script exits non-zero and prints no
such line. The CPU backend stays up beside the GPU as the oracle.

Run:  python chip_smoke.py [--seed N] [--four-cards]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import math
import os
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import numpy as np

import bench


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def select_backends(environ=os.environ) -> None:
    """Keep both the GPU and the CPU backend visible: the CPU is the
    oracle. Call before JAX initializes its backends."""
    plats = [p for p in environ.get("JAX_PLATFORMS", "").split(",") if p]
    if plats and not ({"cuda", "gpu"} & set(plats) and "cpu" in plats):
        environ["JAX_PLATFORMS"] = "cuda,cpu"


class CompileCounter:
    """Counts XLA backend compiles (and persistent-cache loads) while
    active."""

    EVENT = "/jax/core/compile/backend_compile_duration"

    def __init__(self):
        self.count = 0

    def _on_event(self, name, secs, **kw):
        if name == self.EVENT:
            self.count += 1

    def __enter__(self):
        import jax.monitoring

        jax.monitoring.register_event_duration_secs_listener(self._on_event)
        return self

    def __exit__(self, *exc):
        import jax.monitoring

        jax.monitoring.unregister_event_duration_listener(self._on_event)
        return False


# ------------------------------------------------------------------ device
def phase_device(count: int = 1):
    """The GPU devices under test and the card's ``name, power.limit``."""
    import jax

    bench.require_gpu()
    devs = jax.devices()
    if len(devs) < count:
        raise SystemExit(f"need {count} GPUs, JAX found {devs}")
    cpu = jax.devices("cpu")[0]
    card = bench.card_name_and_power_limit()
    log("device", f"jax.devices()={devs} cpu={cpu}")
    log("device", f"device_kind={devs[0].device_kind} jax={jax.__version__}")
    log("device", f"nvidia-smi name, power.limit: {card}")
    return devs[:count], cpu, card


# ------------------------------------------------------------------ canary
def phase_canary(dev) -> None:
    names = bench.correctness_canary(dev)
    assert len(names) == 8, names
    log("canary", f"ok on {dev.platform}: planted + cpu=={dev.platform} "
        f"on {len(names) - 1}/7 configs {names[1:]}")


# ----------------------------------------------------------------- oracles
def gmm_reference(ms, x: np.ndarray, chunk: int = 4096) -> np.ndarray:
    """float64 -log max_k w_k N(x; mu_k, diag var_k) per mixture, from the
    raw mixture parameters; x ``[N, D]`` -> ``[N, M]``."""
    M, K, D = ms.means.shape
    var = np.maximum(ms.variances.astype(np.float64), 1e-4)
    mu = ms.means.astype(np.float64)
    iv = (1.0 / var).reshape(M * K, D)
    miv = (mu / var).reshape(M * K, D)
    with np.errstate(divide="ignore"):
        logw = np.log(ms.weights.astype(np.float64))
    const = (
        -logw
        + 0.5 * (D * math.log(2 * math.pi) + np.log(var).sum(-1)
                 + (mu * mu / var).sum(-1))
    ).reshape(M * K)
    out = np.empty((x.shape[0], M), np.float64)
    for i in range(0, x.shape[0], chunk):
        xc = x[i : i + chunk].astype(np.float64)
        d = 0.5 * (xc * xc) @ iv.T - xc @ miv.T + const
        out[i : i + chunk] = d.reshape(-1, M, K).min(-1)
    return out


def oracle_gmm(dev, seed: int, M=2000, K=8, D=45, B=64, T=1000) -> float:
    """GmmFeatureScorer (max approximation, f32 at HIGHEST precision) vs
    float64 numpy. Tolerance: |err| <= 1e-3 + 1e-5 |ref| — f32 rounding
    of ~D-term sums of O(100) magnitude; TF32 products would miss it by
    two orders."""
    import jax

    from rasr_tpu.models.gmm import MixtureSet
    from rasr_tpu.models.scorer import GmmFeatureScorer

    rng = np.random.default_rng(seed)
    ms = MixtureSet(
        means=rng.normal(size=(M, K, D)).astype(np.float32),
        variances=(0.5 + rng.uniform(size=(M, K, D))).astype(np.float32),
        weights=rng.dirichlet(np.ones(K), size=M).astype(np.float32),
        num_densities=np.full(M, K, np.int32),
    )
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    with jax.default_device(dev):
        got = np.asarray(GmmFeatureScorer(ms)(x)).reshape(B * T, M)
    ref = gmm_reference(ms, x.reshape(B * T, D))
    err = np.abs(got - ref)
    worst = float((err - 1e-5 * np.abs(ref)).max())
    assert worst <= 1e-3, f"GMM scorer off by {err.max()} (margin {worst})"
    log("oracles", f"gmm {M}x{K}x{D} on {B}x{T} frames == float64 numpy "
        f"(max |err| {err.max():.3g}, tol 1e-3 + 1e-5|ref|, f32 HIGHEST)")
    return float(err.max())


def headline_frontend(seed: int, feat_dim: int = 45):
    """The benchmark's frontend: MFCC, splice +-4, random LDA to 45."""
    from rasr_tpu.ops.frontend import FeatureFrontend, FrontendConfig

    rng = np.random.default_rng(seed)
    lda = (rng.normal(size=(16 * 9, feat_dim)) * 0.1).astype(np.float32)
    return FeatureFrontend(FrontendConfig(), splice_context=4, lda=lda)


def oracle_frontend(dev, cpu, seed: int, B=64, audio_s=10.0) -> float:
    """Frontend on ``dev`` vs the same jitted program on the CPU.
    Tolerance: |err| <= 2e-3 (1 + |cpu|) — both f32 at HIGHEST
    precision; only summation order and transcendental rounding differ."""
    import jax

    rng = np.random.default_rng(seed)
    S = int(audio_s * 16000)
    x = (rng.normal(size=(B, S)) * 0.1).astype(np.float32)
    lengths = np.full(B, S, np.int32)
    lengths[1::2] = S - 16000 * int(audio_s // 3)  # ragged batch
    out = {}
    for side, d in (("cpu", cpu), ("dev", dev)):
        with jax.default_device(d):
            feats, nf = headline_frontend(seed)(x, lengths)
            out[side] = (np.asarray(feats), np.asarray(nf))
    np.testing.assert_array_equal(out["dev"][1], out["cpu"][1])
    ref, got = out["cpu"][0], out["dev"][0]
    assert np.isfinite(got).all()
    err = np.abs(got - ref)
    assert (err <= 2e-3 * (1.0 + np.abs(ref))).all(), err.max()
    log("oracles", f"frontend {B}x{audio_s:g}s {got.shape} == CPU jit "
        f"(max |err| {err.max():.3g}, tol 2e-3(1+|ref|), f32 HIGHEST)")
    return float(err.max())


def _toy_decoder_setup():
    from rasr_tpu.corpus.lexicon import Lexicon, build_default_silence
    from rasr_tpu.models.hmm import HmmTopology, Tdp, TransitionModel
    from rasr_tpu.models.lm.arpa import NgramLm
    from rasr_tpu.models.tying import MonophoneStateTying

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
    lm = NgramLm.train_from_text(
        [["AB", "BA"], ["AB", "AA"], ["BA", "AB"], ["AB", "BA"]], order=2
    )
    return lex, topo, tying, trans, lm


def host_viterbi(tree, tables, emis, lm_scale, lm_score) -> float:
    """Exhaustive token passing over (tree_state, lm_state) with no
    pruning: the best final score of utterance 0 of ``emis [1, T, M]``."""
    import collections

    BIGF = 1e30
    S = tree.num_states
    arc = [[] for _ in range(S)]  # (dst, cost) incl. root arcs
    for s in range(S):
        for ai in range(tree.arc_ptr[s], tree.arc_ptr[s + 1]):
            arc[s].append((int(tree.arc_dst[ai]), float(tree.arc_cost[ai])))
    cur = {(0, tables.start_state): 0.0}
    we_next = (
        tree.we_next if tree.we_next is not None else np.zeros_like(tree.we_word)
    )
    for t in range(emis.shape[1]):
        # expand: loops + arcs, add emission of the destination
        nxt = collections.defaultdict(lambda: BIGF)
        for (s, h), sc in cur.items():
            cands = [(s, sc + float(tree.loop_cost[s]))]
            for dst, cost in arc[s]:
                cands.append((dst, sc + cost))
            for dst, base in cands:
                if base >= BIGF / 2:
                    continue
                tot = base + float(emis[0, t, tree.emission_class[dst]])
                if tot < nxt[(dst, h)]:
                    nxt[(dst, h)] = tot
        # word ends -> re-entry
        for (s, h), sc in list(nxt.items()):
            for k in range(tree.max_word_ends):
                w = int(tree.we_word[s, k])
                if w == -1:
                    continue
                pre = sc + float(tree.we_cost[s, k])
                if pre >= BIGF / 2:
                    continue
                if w >= 0:
                    c, h2 = lm_score(h, w)
                    pre, hn = pre + lm_scale * c, h2
                else:
                    hn = h
                key = (int(we_next[s, k]), hn)
                if pre < nxt[key]:
                    nxt[key] = pre
        cur = dict(nxt)
    eosw = max(tables.end_word, 0)
    return min(
        (
            sc + lm_scale * lm_score(h, eosw)[0]
            for (s, h), sc in cur.items()
            if s < tree.num_final_states and sc < BIGF / 2
        ),
        default=BIGF,
    )


def oracle_decode(dev, across: bool) -> float:
    """Pruning-off decode on ``dev`` == exhaustive host Viterbi over the
    same compiled network. Tolerance: rtol 1e-4, atol 1e-3 (f32 path
    sums of ~T terms; the host sums in float64)."""
    import jax
    import jax.numpy as jnp

    from rasr_tpu.models.lm.ngram_tpu import (
        compile_ngram, lookup_prepared, prepare_lookup,
    )
    from rasr_tpu.search.decoder import BeamConfig, TreeDecoder
    from rasr_tpu.search.tree import build_prefix_tree

    lex, topo, tying, trans, lm = _toy_decoder_setup()
    tables = compile_ngram(lm)
    tree = build_prefix_tree(
        lex, tying, topo, trans, lm_vocab=lm.vocab, across_word=across
    )
    rng = np.random.default_rng(17)
    T, M = 7, tying.num_classes
    emis = rng.uniform(0.0, 6.0, size=(1, T, M)).astype(np.float32)
    lm_scale = 0.7
    cache = {}
    with jax.default_device(dev):
        prep = prepare_lookup(tables)

        def lm_score(state, word):
            key = (state, int(word))
            if key not in cache:
                c, n = lookup_prepared(
                    tables, prep,
                    jnp.asarray([state], jnp.int32),
                    jnp.asarray([int(word)], jnp.int32),
                )
                cache[key] = (float(np.asarray(c)[0]), int(np.asarray(n)[0]))
            return cache[key]

        best_host = host_viterbi(tree, tables, emis, lm_scale, lm_score)
        dec = TreeDecoder(
            tree, tables,
            BeamConfig(max_hyps=512, beam=1e9, word_end_limit=128,
                       root_hyps=512, lm_scale=lm_scale),
        )
        (res,) = dec.decode_scores(emis, np.array([T]))
    np.testing.assert_allclose(res.score, best_host, rtol=1e-4, atol=1e-3)
    kind = "across-word" if across else "within-word"
    log("oracles", f"decode {kind} == exhaustive host Viterbi "
        f"({res.score:.4f} vs {best_host:.4f}, rtol 1e-4 atol 1e-3)")
    return abs(res.score - best_host)


def random_ngram_lm(num_words: int, seed: int, order: int = 3):
    """A random back-off n-gram LM over ``num_words`` words, closed
    under prefixes (every context carries a backoff weight)."""
    from rasr_tpu.models.lm.arpa import NgramLm

    rng = np.random.default_rng(seed)
    vocab = {"<s>": 0, "</s>": 1, "<unk>": 2}
    for w in range(num_words):
        vocab[f"w{w}"] = len(vocab)
    ids = np.arange(len(vocab))
    ngrams = {(i,): (float(rng.uniform(5, 12)), float(rng.uniform(0.2, 2.0)))
              for i in ids}
    for a, b in rng.choice(ids, size=(num_words * 12, 2)):
        ngrams[(int(a), int(b))] = (float(rng.uniform(2, 9)), 0.0)
    for k in range(3, order + 1):
        prev = [g for g in ngrams if len(g) == k - 1]
        for pi in rng.integers(0, len(prev), size=num_words * 8):
            g = prev[int(pi)]
            ngrams[g + (int(rng.choice(ids)),)] = (float(rng.uniform(1, 7)), 0.0)
            if ngrams[g][1] == 0.0:
                ngrams[g] = (ngrams[g][0], float(rng.uniform(0.2, 1.5)))
    return NgramLm(order, vocab, ngrams)


def oracle_lm(dev, seed: int, num_words=5000, n_seqs=256, length=6) -> float:
    """Batched device hash-table lookup chain == host NgramLm, summed over
    random word sequences (full backoff chain + unigram level).
    Tolerance: rtol 1e-5 per sequence total (f32 costs)."""
    import jax
    import jax.numpy as jnp

    from rasr_tpu.models.lm.ngram_tpu import (
        compile_ngram, lookup_prepared, prepare_lookup,
    )

    lm = random_ngram_lm(num_words, seed)
    tables = compile_ngram(lm)
    rng = np.random.default_rng(seed + 1)
    words = rng.integers(3, len(lm.vocab), size=(n_seqs, length)).astype(np.int32)
    with jax.default_device(dev):
        prep = prepare_lookup(tables)
        look = jax.jit(lambda s, w: lookup_prepared(tables, prep, s, w))
        st = jnp.full((n_seqs,), tables.start_state, jnp.int32)
        dev_total = jnp.zeros((n_seqs,), jnp.float32)
        for t in range(length):
            c, st = look(st, jnp.asarray(words[:, t]))
            dev_total = dev_total + c
        dev_total = np.asarray(dev_total)
    host_total = np.zeros(n_seqs)
    for i in range(n_seqs):
        h = lm.start_history()
        for w in words[i]:
            host_total[i] += lm.score(h, int(w))
            h = lm.extended_history(h, int(w))
    np.testing.assert_allclose(dev_total, host_total, rtol=1e-5, atol=1e-4)
    err = float(np.abs(dev_total - host_total).max())
    log("oracles", f"{lm.order}-gram LM lookup ({len(lm.vocab)} words, "
        f"{n_seqs}x{length} batched) == host LM (max |err| {err:.3g}, "
        f"rtol 1e-5)")
    return err


def oracle_bit_transport(dev) -> None:
    """int32 carriers preserve bit patterns through fused stack/gather/
    select (denormal and NaN patterns included): the invariant the
    decoder's packed rows rely on. Exact equality."""
    import jax
    import jax.numpy as jnp

    vals = np.array([-1, -2, 0, 3, 511, 56432, 2143289344], np.int32)
    floats = np.resize(
        np.array([0.0, 1e30, -1.5, 3.25e-39, 7.0, 1e-40], np.float32),
        len(vals),
    )

    @jax.jit
    def f(xi, xf, idx):
        fb = jax.lax.bitcast_convert_type(xf, jnp.int32)
        rows = jnp.stack([xi, fb], axis=-1)
        g = rows[idx]
        sel = jnp.where((idx % 2 == 0)[:, None], g, g)
        return sel[:, 0], sel[:, 1]

    idx = np.arange(len(vals), dtype=np.int32)
    with jax.default_device(dev):
        a, b = f(vals, floats, idx)
    np.testing.assert_array_equal(np.asarray(a), vals)
    np.testing.assert_array_equal(np.asarray(b), floats.view(np.int32))
    log("oracles", "int32 bit-pattern transport exact (denormal + NaN patterns)")


def phase_oracles(dev, cpu, seed: int) -> None:
    oracle_gmm(dev, seed)
    oracle_frontend(dev, cpu, seed)
    for across in (False, True):
        oracle_decode(dev, across)
    oracle_lm(dev, seed)
    oracle_bit_transport(dev)


# ---------------------------------------------------------------- pipeline
@dataclasses.dataclass
class PipelineRun:
    dec: object  # TreeDecoder
    emis: object  # [B, T, M] device array of the last batch
    nf: object  # [B] device array
    results: list  # DecodeResults of the last batch


def phase_pipeline(dev, seed: int, card: str = "", batch=64, audio_s=10.0,
                   iters=3, **setup_kw) -> PipelineRun:
    """The headline configuration through the library API, timed stage by
    stage (each stage ends in block_until_ready)."""
    import jax

    t0 = time.time()
    with jax.default_device(dev):
        fe, scorer, dec, tree = bench.build_setup(seed=seed, **setup_kw)
        rng = np.random.default_rng(seed + 1)
        S = int(audio_s * 16000)
        samples = jax.device_put(
            (rng.normal(size=(batch, S)) * 0.1).astype(np.float32), dev
        )
        lengths = jax.device_put(np.full(batch, S, np.int32), dev)
        jax.block_until_ready(samples)
        setup_s = time.time() - t0

        def run_batch():
            t = [time.time()]
            feats, nf = jax.block_until_ready(fe(samples, lengths))
            t.append(time.time())
            emis = jax.block_until_ready(scorer(feats))
            t.append(time.time())
            results = dec.results_from_device(dec.decode_scores_device(emis, nf))
            t.append(time.time())
            return np.diff(t), emis, nf, results

        t0 = time.time()
        run_batch()
        compile_s = time.time() - t0
        times = []
        with CompileCounter() as compiles:
            for _ in range(iters):
                dt, emis, nf, results = run_batch()
                times.append(dt)
    times = np.array(times)  # [iters, 3]
    batch_s = times.sum(1)
    rate = batch * audio_s / float(np.median(batch_s))
    stage = np.median(times, axis=0)
    peak = dev.memory_stats().get("peak_bytes_in_use") if dev.memory_stats() else None
    assert len(results) == batch
    assert all(np.isfinite(r.score) for r in results), "non-finite scores"
    assert any(r.words for r in results), "no utterance decoded a word"
    T = int(emis.shape[1])
    log("pipeline", f"tree {tree.stats()} cfg K={dec.cfg.max_hyps} "
        f"root_select={dec.cfg.root_select} "
        f"deferred_emission={dec.cfg.deferred_emission}")
    log("pipeline", f"setup {setup_s:.2f} s, compile+first batch "
        f"{compile_s:.2f} s, B={batch} x {audio_s:g} s ({T} frames)")
    on = f"{dev.device_kind} ({card})" if card else dev.device_kind
    log("pipeline", f"{rate:.2f} audio-s/s on {on}; "
        f"batch {np.median(batch_s):.4f} s median of {iters}")
    log("pipeline", f"stage medians: frontend {stage[0]*1e3:.2f} ms "
        f"({100*stage[0]/stage.sum():.2f}%), scorer {stage[1]*1e3:.2f} ms "
        f"({100*stage[1]/stage.sum():.2f}%), decode+pull "
        f"{stage[2]*1e3:.2f} ms ({100*stage[2]/stage.sum():.2f}%)")
    log("pipeline", f"peak_bytes_in_use {peak} (process peak so far); "
        f"compiles inside the timed batches: {compiles.count}")
    assert compiles.count == 0, f"{compiles.count} compiles in timed batches"
    return PipelineRun(dec, emis, nf, results)


# --------------------------------------------------------------- streaming
def phase_streaming(run: PipelineRun, block: int = 128) -> None:
    """Block-feed online decode over the pipeline's emissions, with a
    mid-stream current_best(), must equal the offline decode: identical
    words, scores within 1e-3 relative."""
    import jax.numpy as jnp

    from rasr_tpu.search.streaming import StreamingDecoder

    emis = run.emis
    B, T, _ = emis.shape
    nblocks = -(-T // block)
    # frames past a row's declared end freeze it, so zero padding is inert
    emis = jnp.pad(emis, ((0, 0), (0, nblocks * block - T), (0, 0)))
    sd = StreamingDecoder(run.dec).restart(
        batch_size=B, n_frames=np.asarray(run.nf)
    )
    for i in range(nblocks):
        sd.feed(emis[:, i * block : (i + 1) * block])
        if i == nblocks // 2:
            partial = sd.current_best()
            assert len(partial) == B
            assert all(np.isfinite(p.score) for p in partial)
    final = sd.finalize()
    for f, o in zip(final, run.results):
        assert f.words == o.words, (f.words, o.words)
        assert abs(f.score - o.score) < 1e-3 * max(1.0, abs(o.score)), (
            f.score, o.score)
    log("streaming", f"{nblocks} blocks of {block} frames x B={B} + "
        f"current_best == offline decode (words identical, scores 1e-3 rel)")


# --------------------------------------------------------------------- cli
def write_cli_corpus(workdir: str, seed: int, n_utts: int = 4):
    """Wavs, corpus, lexicon, ARPA LM and a random mixture file for the
    speech-recognizer tool; returns the mixture path."""
    from rasr_tpu.corpus.audio import write_wav
    from rasr_tpu.corpus.lexicon import Lexicon
    from rasr_tpu.models.gmm import MixtureSet
    from rasr_tpu.models.hmm import HmmTopology
    from rasr_tpu.models.lm.arpa import NgramLm
    from rasr_tpu.models.tying import MonophoneStateTying

    os.makedirs(workdir, exist_ok=True)
    rng = np.random.default_rng(seed)
    sr = 16000
    freq = {"a": 500, "b": 2000}
    words = {"AB": ["a", "b"], "BA": ["b", "a"]}
    xml = ['<corpus name="smoke">']
    for i in range(n_utts):
        ws = [str(w) for w in rng.choice(list(words), size=2)]
        audio = [0.002 * rng.normal(size=int(0.15 * sr))]
        for w in ws:
            for p in words[w]:
                t = np.arange(int(0.25 * sr)) / sr
                audio.append(0.3 * np.sin(2 * np.pi * freq[p] * t))
            audio.append(0.002 * rng.normal(size=int(0.15 * sr)))
        a = np.concatenate(audio).astype(np.float32)
        write_wav(os.path.join(workdir, f"rec{i}.wav"), a, sr)
        xml.append(
            f'<recording name="rec{i}" audio="rec{i}.wav">'
            f'<segment name="s" start="0" end="{len(a)/sr}">'
            f'<orth>{" ".join(ws)}</orth></segment></recording>'
        )
    xml.append("</corpus>")
    with open(os.path.join(workdir, "smoke.corpus"), "w") as fh:
        fh.write("".join(xml))
    lex_path = os.path.join(workdir, "lexicon.xml")
    with open(lex_path, "w") as fh:
        fh.write(
            "<lexicon><phoneme-inventory>"
            "<phoneme><symbol>a</symbol></phoneme>"
            "<phoneme><symbol>b</symbol></phoneme>"
            "<phoneme><symbol>si</symbol><variation>none</variation></phoneme>"
            "</phoneme-inventory>"
            '<lemma special="silence"><orth>[SILENCE]</orth><phon>si</phon>'
            "<synt/><eval/></lemma>"
            "<lemma><orth>AB</orth><phon>a b</phon></lemma>"
            "<lemma><orth>BA</orth><phon>b a</phon></lemma></lexicon>"
        )
    NgramLm.train_from_text(
        [["AB", "BA"], ["BA", "AB"], ["AB", "AB"], ["BA", "BA"]], order=2
    ).write_arpa(os.path.join(workdir, "lm.arpa"))
    M = MonophoneStateTying(
        Lexicon.load(lex_path), HmmTopology(states_per_phone=1)
    ).num_classes
    K, D = 2, 16  # the tool's default frontend: 16 cepstra
    mix = os.path.join(workdir, "model.mix")
    MixtureSet(
        means=rng.normal(size=(M, K, D)).astype(np.float32),
        variances=(0.5 + rng.uniform(size=(M, K, D))).astype(np.float32),
        weights=np.full((M, K), 1.0 / K, np.float32),
        num_densities=np.full(M, K, np.int32),
    ).save(mix)
    return mix


def phase_cli(dev, seed: int, workdir: str, n_utts: int = 4) -> None:
    """The speech-recognizer tool, in process, decodes the generated
    corpus and writes its CTM and n-best outputs."""
    import jax

    from rasr_tpu.tools.speech_recognizer import SpeechRecognizerTool

    mix = write_cli_corpus(workdir, seed, n_utts)
    j = lambda f: os.path.join(workdir, f)
    for f in ("out.ctm", "out.nbest"):
        if os.path.exists(j(f)):
            os.remove(j(f))
    args = [
        f"--speech-recognizer.corpus-file={j('smoke.corpus')}",
        f"--speech-recognizer.audio-dir={workdir}",
        f"--speech-recognizer.lexicon-file={j('lexicon.xml')}",
        f"--speech-recognizer.lm-file={j('lm.arpa')}",
        f"--speech-recognizer.mixture-file={mix}",
        "--speech-recognizer.states-per-phone=1",
        f"--speech-recognizer.ctm-file={j('out.ctm')}",
        f"--speech-recognizer.nbest-file={j('out.nbest')}",
        "--speech-recognizer.nbest=3",
        "--speech-recognizer.search.max-hyps=128",
        "--speech-recognizer.search.lm-scale=2.0",
    ]
    out = io.StringIO()
    with jax.default_device(dev), contextlib.redirect_stdout(out):
        rc = SpeechRecognizerTool.main(args)
    text = out.getvalue()
    assert rc == 0, f"speech-recognizer exited {rc}:\n{text}"
    assert "WER:" in text, text
    assert os.path.exists(j("out.ctm"))
    with open(j("out.nbest")) as fh:
        segs = {ln.split()[0] for ln in fh if ln.strip()}
    assert len(segs) == n_utts, segs
    log("cli", f"speech-recognizer decoded {n_utts} utterances "
        f"({text.strip().splitlines()[-1]}); CTM and n-best written")


# -------------------------------------------------------------- four cards
def phase_four_cards(devs, seed: int, batch=64, audio_s=10.0,
                     beam_batch=16, **setup_kw) -> None:
    """Data-parallel decode over make_mesh(data=4) and the partitioned
    beam over a model=4 mesh, each against a one-card decode of the
    same batch on device 0: identical words, scores within 1e-4
    relative (per-row programs are the same; the partitioned beam
    merges slices by all_gather)."""
    import jax

    from rasr_tpu.parallel.mesh import make_mesh
    from rasr_tpu.search.decoder import TreeDecoder

    d0 = devs[0]

    def same(a, b, what):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.words == y.words, (what, x.words, y.words)
            assert abs(x.score - y.score) <= 1e-4 * max(1.0, abs(y.score)), (
                what, x.score, y.score)

    with jax.default_device(d0):
        fe, scorer, dec, tree = bench.build_setup(seed=seed, **setup_kw)
        rng = np.random.default_rng(seed + 1)
        S = int(audio_s * 16000)
        samples = (rng.normal(size=(batch, S)) * 0.1).astype(np.float32)
        feats, nf = fe(samples, np.full(batch, S, np.int32))
        emis = scorer(feats)
        one = dec.decode_scores(emis, nf)
        mesh = make_mesh(data=len(devs), devices=devs)
        t0 = time.time()
        dp = dec.decode_scores(emis, nf, mesh=mesh)
        same(dp, one, "data-parallel")
        log("four-cards", f"data-parallel decode over mesh {dict(mesh.shape)}"
            f" B={batch} == one-card decode on {d0} "
            f"({time.time()-t0:.1f} s incl. compile)")
        # full-coverage pruning caps (root/branch caps >= K, no root
        # pre-selection): the precondition under which the partitioned
        # beam equals the single-device beam (decode_scores_device)
        K = dec.cfg.max_hyps
        cfg = dataclasses.replace(
            dec.cfg, root_hyps=K, branch_hyps=0, branch_width=0,
            root_select=0, expansion_limit=0, deferred_emission=False,
        )
        full = TreeDecoder(tree, dec.lm, cfg)
        e16, n16 = emis[:beam_batch], nf[:beam_batch]
        one_b = full.decode_scores(e16, n16)
        bmesh = make_mesh(data=1, model=len(devs), devices=devs)
        t0 = time.time()
        part = full.decode_scores(e16, n16, mesh=bmesh, beam_axis="model")
        same(part, one_b, "partitioned-beam")
        log("four-cards", f"partitioned-beam decode K={K} over mesh "
            f"{dict(bmesh.shape)} B={beam_batch} == one-card decode "
            f"({time.time()-t0:.1f} s incl. compile)")


# -------------------------------------------------------------------- main
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card decodes and their reference")
    args = ap.parse_args(argv)
    select_backends()
    from rasr_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    t_start = time.time()
    count = 4 if args.four_cards else 1
    devs, cpu, card = phase_device(count)
    dev = devs[0]
    if args.four_cards:
        phase_four_cards(devs, args.seed)
    else:
        phase_canary(dev)
        phase_oracles(dev, cpu, args.seed)
        run = phase_pipeline(dev, args.seed, card)
        phase_streaming(run)
        phase_cli(dev, args.seed, os.path.join(REPO, "work", "chip_smoke_cli"))
    log("done", f"all phases passed in {time.time()-t_start:.1f} s; "
        f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count,
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
