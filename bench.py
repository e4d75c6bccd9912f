"""Benchmark: full decode pipeline throughput on one GPU.

Measures audio-seconds decoded per wall second per card for the complete
pipeline — MFCC/LDA frontend -> dense GMM emission scoring -> prefix-tree
beam decode with bigram LM — on a realistic synthetic setup (5k-word
lexicon, 2k tied states with 8 densities each, 45-dim LDA features).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline",
"platform", "device_kind", "device_count", "power_limit"} where
vs_baseline is value / 50 (BASELINE.json north-star: >=50x real time per
chip on LibriSpeech test-clean; real-data parity pending corpus access —
the synthetic load matches the compute shape: same frame rate, feature
dims, inventory sizes, beam widths). Without a GPU it exits non-zero:
a CPU number is never reported as a device number.

Run:  python bench.py          (BENCH_TRAIN=1 for the training step)
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

#: Dense (no sparsity) bf16 tensor-core peak per card, keyed by JAX's
#: ``device_kind``. Source: NVIDIA H100 Tensor Core GPU data sheet (SXM
#: part, at its full 700 W power limit).
PEAK_BF16_TFLOPS = {
    "NVIDIA H100 80GB HBM3": 989.0,
}


def peak_bf16_flops(device_kind: str) -> float:
    """bf16 peak FLOP/s of one card; an unknown card is an error."""
    if device_kind not in PEAK_BF16_TFLOPS:
        raise KeyError(
            f"no published peak for device_kind {device_kind!r}; "
            f"add it to bench.PEAK_BF16_TFLOPS with its source"
        )
    return PEAK_BF16_TFLOPS[device_kind] * 1e12


def require_gpu():
    """The first GPU device, or SystemExit when JAX found none."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"no GPU found (jax.devices()[0] is {dev}); "
            f"device measurements need the card"
        )
    return dev


def card_name_and_power_limit() -> str:
    """``name, power.limit`` of the card as nvidia-smi reports it (a
    child process that stays off JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def device_record(dev) -> dict:
    """What every device number is reported with."""
    import jax

    return {
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "power_limit": card_name_and_power_limit().split(",")[-1].strip(),
    }


def build_setup(
    num_words=5000,
    num_phones=40,
    num_classes=2000,
    densities=8,
    feat_dim=45,
    seed=0,
):
    import jax

    from rasr_tpu.corpus.lexicon import Lexicon, build_default_silence
    from rasr_tpu.models.gmm import MixtureSet
    from rasr_tpu.models.hmm import HmmTopology, TransitionModel
    from rasr_tpu.models.lm.arpa import NgramLm
    from rasr_tpu.models.lm.ngram_tpu import compile_ngram
    from rasr_tpu.models.scorer import GmmFeatureScorer
    from rasr_tpu.models.tying import CartStateTying, StateTying
    from rasr_tpu.ops.frontend import FeatureFrontend, FrontendConfig
    from rasr_tpu.search.decoder import BeamConfig, TreeDecoder
    from rasr_tpu.search.tree import build_prefix_tree

    rng = np.random.default_rng(seed)
    lex = Lexicon()
    build_default_silence(lex)
    phones = [f"p{i}" for i in range(num_phones)]
    for p in phones:
        lex.phonemes.add(p)
    seen = set()
    for w in range(num_words):
        length = int(rng.integers(2, 8))
        pron = tuple(rng.choice(phones, size=length))
        if pron in seen:
            continue
        seen.add(pron)
        lex.add_lemma([f"w{w}"], [(list(pron), 0.0)])

    topology = HmmTopology(states_per_phone=3, silence_states=1)

    class HashTying(StateTying):
        """Pseudo-CART: deterministic hash of (allophone, state) to
        num_classes tied classes (same compute shape as CART tying).

        ``ctx_groups`` quantizes left/right context phones into that
        many groups before hashing — a realistic CART collapses most
        contexts this way. 0 = fully context-distinct (the worst case
        for the across-word network's size: BENCH_CTX_GROUPS knob)."""

        def __init__(self, n, ctx_groups=0):
            self.num_classes = n
            self.g = ctx_groups

        def _ctx(self, p):
            return (1 + p % self.g) if (self.g and p) else p

        def classify(self, state):
            al = state.allophone
            left, right = self._ctx(al.left), self._ctx(al.right)
            h = (al.center * 73856093) ^ (left * 19349663) ^ (right * 83492791) ^ (state.state * 2971215073)
            return 1 + (h % (self.num_classes - 1))

    tying = HashTying(
        num_classes, ctx_groups=int(os.environ.get("BENCH_CTX_GROUPS", "0"))
    )

    # n-gram LM over the word vocab (BENCH_LM_ORDER: 2 = classic bigram
    # decode; 4 = production 4-gram shape — the LM state space outgrows
    # the packed-int32 recombination key, so the decoder's two-key sort
    # path and the deeper backoff-probe chain are what's measured)
    order = int(os.environ.get("BENCH_LM_ORDER", "2"))
    vocab = {"<s>": 0, "</s>": 1, "<unk>": 2}
    for lemma in lex.lemmata:
        if lemma.special:
            continue
        vocab.setdefault(lemma.primary_orth, len(vocab))
    ngrams = {}
    for w, i in vocab.items():
        ngrams[(i,)] = (float(rng.uniform(5, 12)), float(rng.uniform(0.2, 2.0)))
    ids = np.asarray(list(vocab.values()))
    for _ in range(num_words * 12):
        a, b = rng.choice(ids), rng.choice(ids)
        ngrams[(int(a), int(b))] = (float(rng.uniform(2, 9)), 0.0)
    for k in range(3, order + 1):
        # higher orders: extend existing (k-1)-grams so prefix closure
        # holds; contexts get backoff weights (they become LM states)
        prev = [g for g in ngrams if len(g) == k - 1]
        picks = rng.integers(0, len(prev), size=num_words * 8)
        for pi in picks:
            g = prev[int(pi)]
            w = int(rng.choice(ids))
            ngrams[g + (w,)] = (float(rng.uniform(1, 7)), 0.0)
            if g in ngrams and ngrams[g][1] == 0.0:
                ngrams[g] = (ngrams[g][0], float(rng.uniform(0.2, 1.5)))
    lm = NgramLm(order, vocab, ngrams)
    tables = compile_ngram(lm)

    unigrams = {wid: ngrams[(wid,)][0] for wid in vocab.values()}
    # BENCH_NET_CACHE=<path.npz>: search-network image cache (the
    # across-word worst case compiles a 25.8M-state network host-side —
    # minutes; the image loads in seconds). The caller keys the path by
    # config; a lexicon mismatch raises at load.
    net_cache = os.environ.get("BENCH_NET_CACHE", "")
    tree = None
    if net_cache and os.path.exists(net_cache):
        from rasr_tpu.search.tree import load_tree

        tree = load_tree(net_cache, lex)
        sys.stderr.write(f"[bench] network image loaded: {net_cache}\n")
    if tree is None:
        tree = build_prefix_tree(
            lex, tying, topology, TransitionModel(), lm_vocab=vocab,
            lm_unigrams=unigrams,
            # BENCH_ACROSS=1: the across-word network (exact word-boundary
            # triphone contexts; context roots + word-end fan-out)
            across_word=bool(int(os.environ.get("BENCH_ACROSS", "0"))),
            # "phone" pins the historical benchmark network (skips within
            # phones only) so headline numbers stay comparable across rounds;
            # skip_scope="word" additionally realizes the default TDPs'
            # finite cross-phone skips (the faithful production topology —
            # junction fan-out grows, widening the branch sections)
            skip_scope=os.environ.get("BENCH_SKIP_SCOPE", "phone"),
        )
        if net_cache:
            from rasr_tpu.search.tree import save_tree

            save_tree(tree, net_cache)
            sys.stderr.write(f"[bench] network image saved: {net_cache}\n")

    # BENCH_LA_ORDER=2: word-set bigram lookahead shaping in the timed
    # decode; BENCH_LA_CLASSES bounds the history-class table height
    bla = None
    if int(os.environ.get("BENCH_LA_ORDER", "1")) >= 2:
        from rasr_tpu.search.lookahead import build_bigram_lookahead

        t_la = time.time()
        bla = build_bigram_lookahead(
            tree, lm,
            num_classes=int(os.environ.get("BENCH_LA_CLASSES", "64")),
            # 3 = trigram (last-two-word pair) anchors — only
            # meaningful with BENCH_LM_ORDER >= 3
            order=min(int(os.environ.get("BENCH_LA_ORDER", "2")), 3),
            smooth=float(os.environ.get("BENCH_LA_SMOOTH", "0.0")),
        )
        assert bla is not None, "bigram lookahead unsupported for this network"
        sys.stderr.write(
            f"[bench] bigram lookahead build {time.time()-t_la:.1f}s "
            f"(nodes={bla.num_subtrees}, classes={bla.num_classes}, "
            f"corr_table={bla.corr.nbytes/1e6:.1f}MB)\n"
        )

    if os.environ.get("BENCH_SCORER", "gmm") == "conformer":
        # hybrid conformer acoustic model at production size (d=512,
        # 12 blocks, bf16 gemms) — the "config 5" modern pipeline
        # (models/nn.py: needs flax)
        import jax as _jax
        import jax.numpy as _jnp

        from rasr_tpu.models.nn import ConformerEncoderNet, NnHybridScorer, StatePriors

        net = ConformerEncoderNet(
            num_classes=num_classes, d_model=512, num_blocks=12, num_heads=8,
            compute_dtype=os.environ.get("BENCH_NN_DTYPE", "bfloat16"),
        )
        params = net.init(
            _jax.random.PRNGKey(0), _jnp.zeros((1, 8, feat_dim), _jnp.float32)
        )["params"]
        priors = StatePriors.from_counts(
            rng.uniform(1, 10, size=num_classes).astype(np.float32)
        )
        scorer = NnHybridScorer(net, params, priors, scale=10.0)
    else:
        ms = MixtureSet(
            means=rng.normal(size=(num_classes, densities, feat_dim)).astype(np.float32),
            variances=(0.5 + rng.uniform(size=(num_classes, densities, feat_dim))).astype(np.float32),
            weights=np.full((num_classes, densities), 1.0 / densities, np.float32),
            num_densities=np.full(num_classes, densities, np.int32),
        )
        scorer = GmmFeatureScorer(ms, scale=1.0)

    lda = (rng.normal(size=(16 * 9, feat_dim)) * 0.1).astype(np.float32)
    fe = FeatureFrontend(FrontendConfig(), splice_context=4, lda=lda)
    K_bench = int(os.environ.get("BENCH_MAX_HYPS", "1024"))
    kb_bench = int(os.environ.get("BENCH_BRANCH_HYPS", "146"))
    bw = int(os.environ.get("BENCH_BRANCH_WIDTH", "-1"))
    # Sort-pad budget (TPU-derived, unmeasured on the H100): the TPU
    # sort padded the sorted dim to the next power of 2, so the branch
    # caps keep every per-frame sort at or under 4096 wide. The budget
    # also decides which hypotheses expand, so it stays until its H100
    # A/B (ROADMAP D3/S5).
    if bw < 0:  # auto: keep the main sorts at/under the 4096 pad
        _deg = tree.arc_ptr[1:] - tree.arc_ptr[:-1]
        db_est = int(max(int((_deg[1:] - 2).max()), 1)) if _deg.size > 1 else 1
        budget = max(4096 - 3 * K_bench, 256) - 2
        bw = 0 if kb_bench * db_est <= budget + 2 else budget
    dec = TreeDecoder(
        tree, tables,
        bigram_la=bla,
        cfg=BeamConfig(
            max_hyps=K_bench,
            beam=1e9,
            word_end_limit=int(os.environ.get("BENCH_WORD_END", "64")),
            root_hyps=int(os.environ.get("BENCH_ROOT_HYPS", "16")),
            # candidate-section budgets land every sort at or under the
            # 4096 pad (see above): main sorts 3*1024 + 146*7 = 4094;
            # root-select sort 1537 + 15*160 = 3937
            branch_hyps=kb_bench,
            # compact branch expansion: pack the selected hyps' overflow
            # arcs contiguously into a static slot budget instead of the
            # padded [branch_hyps, max_degree] fan. Essential on networks
            # with high max branch degree (word-scope skips: Db=16;
            # across-word grouped roots: Db=45+) where the dense fan
            # blows the 4096 sort-pad budget; on the headline network
            # (Db=7, mean degree 2) 1022 slots hold MORE arcs than the
            # dense fan's 146 hyps while keeping 3*1024 + 1022 = 4094.
            # AUTO (-1, the default): dense fan while it fits the 4096
            # sort-pad budget, else compact slots. Large vocabularies
            # grow the max branch degree (Db=37 at 100k words), and the
            # dense fan would widen the recombination sorts to 8474.
            branch_width=bw,
            root_arc_limit=int(os.environ.get("BENCH_ROOT_CAP", "160")),
            # exact expansion by default (no pre-emission top-E stage)
            expansion_limit=int(os.environ.get("BENCH_EXPANSION", "0")),
            # word-start survivors per frame: pre-emission top-R3 over
            # the root fan-out, keeping the full fan-out OUT of the main
            # recombination sorts (half their width at these settings)
            root_select=int(os.environ.get("BENCH_ROOT_SELECT", "512")),
            # survivors-only emission gather (pre-emission top-K)
            deferred_emission=bool(int(os.environ.get("BENCH_DEFER", "1"))),
            # frame-loop unroll (cross-frame fusion of dispatch/layout slop)
            scan_unroll=int(os.environ.get("BENCH_UNROLL", "1")),
            # "survivor" = the reference's lazy lookahead activation
            # (with BENCH_LA_ORDER=2; NOT exact — see BeamConfig)
            lookahead_update=os.environ.get("BENCH_LA_UPDATE", "arc"),
            lm_scale=10.0,
        ),
    )
    return fe, scorer, dec, tree


def correctness_canary(device=None):
    """Tiny planted decodes asserted ON THE DEVICE before timing.

    The CPU test suite cannot catch corruption that only the
    accelerator's compiler or hardware introduces (an earlier
    accelerator flushed denormal/NaN bit patterns in fused f32 relayouts
    and silently corrupted the decoder beam while 240+ CPU tests passed
    — PERF.md "Bit-pattern transport"). This canary is the standing on-device
    correctness gate of bench.py and chip_smoke.py.

    ``device`` is the device under test; by default ``jax.devices()[0]``,
    which must not be the CPU (the CPU backend is the oracle). Returns
    the names of the checks that passed.

    Two layers:
    1. planted decodes (absolute answers) for the timed bench's configs;
    2. CPU-vs-device equality for every packed int32-carrier transport
       path the bench does NOT time: the across-word network (grouped
       roots + we_next re-entry), the 4-gram two-key recombination
       sort, word-set bigram lookahead (pair columns + quarter-row
       class/corr gathers), and RNN fusion (f32 state ring + fused
       word-end costs). The same decode must produce identical words
       and near-identical scores on both backends — any on-device
       transport corruption breaks the equality.
    """
    import jax

    from rasr_tpu.corpus.lexicon import Lexicon, build_default_silence
    from rasr_tpu.models.hmm import HmmTopology, TransitionModel
    from rasr_tpu.models.lm.arpa import NgramLm
    from rasr_tpu.models.lm.ngram_tpu import compile_ngram
    from rasr_tpu.models.tying import MonophoneStateTying
    from rasr_tpu.search.decoder import BeamConfig, TreeDecoder
    from rasr_tpu.search.tree import build_prefix_tree

    if device is None:
        device = jax.devices()[0]
        if device.platform == "cpu":
            raise RuntimeError(
                "correctness canary: no accelerator — the CPU backend is "
                "the oracle, not the device under test"
            )
    lex = Lexicon()
    build_default_silence(lex)
    lex.add_lemma(["AB"], [(["a", "b"], 0.0)])
    lex.add_lemma(["BA"], [(["b", "a"], 0.0)])
    topo = HmmTopology(states_per_phone=1, silence_states=1)
    tying = MonophoneStateTying(lex, topo)
    lm = NgramLm.train_from_text([["AB", "BA"], ["BA", "AB"]], order=2)
    tree = build_prefix_tree(lex, tying, topo, TransitionModel(), lm_vocab=lm.vocab)
    tables = compile_ngram(lm)
    # plant: sil sil a a b b  -> [SILENCE] AB
    from rasr_tpu.models.allophone import Allophone, AllophoneState

    cls_of = lambda sym: tying.classify(
        AllophoneState(Allophone(lex.phonemes[sym].id), 0)
    )
    seq = [cls_of("si")] * 2 + [cls_of("a")] * 2 + [cls_of("b")] * 2
    emis = np.full((1, len(seq), tying.num_classes), 50.0, np.float32)
    for t, c in enumerate(seq):
        emis[0, t, c] = 0.0
    # plain config AND the production pruning paths the timed bench uses
    # (root_select + deferred_emission + branch/root caps) must both
    # produce the planted answer on the device
    with jax.default_device(device):
        for cfg in (
            BeamConfig(max_hyps=64, word_end_limit=16, lm_scale=0.5),
            BeamConfig(max_hyps=64, word_end_limit=16, lm_scale=0.5,
                       root_hyps=4, root_select=8, root_arc_limit=2,
                       branch_hyps=16, deferred_emission=True),
        ):
            dec = TreeDecoder(tree, tables, cfg)
            (res,) = dec.decode_scores(emis, np.array([len(seq)]))
            got = [l.primary_orth for l in res.lemmas]
            assert got == ["[SILENCE]", "AB"], f"ON-DEVICE CANARY FAILED: {got}"
            assert res.word_ends == [1, 5], f"ON-DEVICE CANARY FAILED: {res.word_ends}"
    sys.stderr.write(
        f"canary ok on {device.platform}: [SILENCE] AB @ [1, 5] "
        f"(plain + rsel/defer)\n"
    )
    return ["planted"] + _cross_backend_canary(device)


def _cross_backend_canary(device):
    """CPU-vs-``device`` decode equality on the untimed transport paths
    (the CPU backend next to the card is an in-process oracle; a missing
    CPU backend raises)."""
    import dataclasses

    import jax

    from rasr_tpu.corpus.lexicon import Lexicon, build_default_silence
    from rasr_tpu.models.hmm import HmmTopology, TransitionModel
    from rasr_tpu.models.lm.arpa import NgramLm
    from rasr_tpu.models.lm.ngram_tpu import compile_ngram
    from rasr_tpu.models.lm.rnn import RnnLm
    from rasr_tpu.models.tying import MonophoneStateTying
    from rasr_tpu.search.decoder import BeamConfig, TreeDecoder
    from rasr_tpu.search.lookahead import build_bigram_lookahead
    from rasr_tpu.search.rnn_fusion import build_rnn_fusion
    from rasr_tpu.search.tree import build_prefix_tree

    cpu = jax.devices("cpu")[0]
    rng = np.random.default_rng(42)
    lex = Lexicon()
    build_default_silence(lex)
    lex.add_lemma(["AB"], [(["a", "b"], 0.0)])
    lex.add_lemma(["BA"], [(["b", "a"], 0.0)])
    lex.add_lemma(["AA"], [(["a", "a"], 0.0)])
    lex.add_lemma(["BAB"], [(["b", "a", "b"], 0.0)])
    topo = HmmTopology(states_per_phone=1, silence_states=1)
    tying = MonophoneStateTying(lex, topo)
    trans = TransitionModel()
    texts = [["AB", "BA"], ["AB", "AA"], ["BA", "BAB"], ["BAB", "AB"]] * 2
    lm2 = NgramLm.train_from_text(texts, order=2)
    lm4 = NgramLm.train_from_text(texts, order=4)
    uni = {wid: lm2.score((), wid) for wid in lm2.vocab.values()}
    t_in = build_prefix_tree(
        lex, tying, topo, trans, lm_vocab=lm2.vocab, lm_unigrams=uni
    )
    t_ax = build_prefix_tree(
        lex, tying, topo, trans, lm_vocab=lm2.vocab, lm_unigrams=uni,
        across_word=True,
    )
    bla = build_bigram_lookahead(t_in, lm2, num_classes=8)
    bla_ax = build_bigram_lookahead(t_ax, lm2, num_classes=8)
    assert bla_ax is not None, "across-word bigram lookahead must build"
    with jax.default_device(cpu):
        rnn = RnnLm.train_from_text(texts, embed_dim=8, hidden_dim=12, epochs=20)

    M = tying.num_classes
    T = 6
    emis = rng.uniform(0.0, 6.0, size=(2, T, M)).astype(np.float32)
    nf = np.array([T, T - 2], np.int32)
    cfg = BeamConfig(max_hyps=64, word_end_limit=16, lm_scale=0.8)
    configs = [
        ("across-word", t_ax, compile_ngram(lm2), {}, cfg),
        ("4gram-two-key", t_in, compile_ngram(lm4), {},
         dataclasses.replace(cfg, force_unpacked_keys=True)),
        ("bigram-la", t_in, compile_ngram(lm2), {"bigram_la": bla}, cfg),
        ("rnn-fusion", t_in, compile_ngram(lm2),
         {"rnn_fusion": None}, cfg),  # built per-device below
        # compact branch expansion (hp rowsel int32 carrier) + LM-aware
        # word-end rank (we_pack bias column + slot re-sort) + word-end
        # beam: the newest packed transport paths, untimed by the bench
        ("branch-width+we-rank", t_ax, compile_ngram(lm2), {},
         dataclasses.replace(cfg, branch_hyps=8, branch_width=24,
                             word_end_rank_lm=True, word_end_beam=60.0)),
        # across-word bigram lookahead: sentinel-root crossing deltas +
        # carried class/phi payload through the sorts
        ("across-word+bigram-la", t_ax, compile_ngram(lm2),
         {"bigram_la": bla_ax}, cfg),
        # big-table layouts FORCED onto the tiny canary nets: the
        # packed-row combo layout (binary int32 unpack) + the 128-lane
        # packed LM bucket rows — the large-vocab transport paths must
        # stay bit-exact on the device
        ("packed-rows+lm128", t_ax, compile_ngram(lm2), {}, cfg),
    ]
    passed = []
    for name, tr, tb, kw, c in configs:
        results = {}
        forced_env = (
            {"RASR_TPU_PACK_THRESHOLD": "1", "RASR_TPU_LM_REP_THRESHOLD": "1"}
            if name == "packed-rows+lm128"
            else {}
        )
        saved_env = {k: os.environ.get(k) for k in forced_env}
        os.environ.update(forced_env)
        try:
            for side, dev in (("cpu", cpu), ("device", device)):
                with jax.default_device(dev):
                    kw_dev = dict(kw)
                    if name == "rnn-fusion":
                        kw_dev["rnn_fusion"] = build_rnn_fusion(
                            rnn, lm2.vocab, weight=0.7
                        )
                    dec = TreeDecoder(tr, tb, c, **kw_dev)
                    results[side] = dec.decode_scores(emis, nf)
        finally:
            for k, v in saved_env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        for a, b in zip(results["cpu"], results["device"]):
            assert a.words == b.words, (
                f"CROSS-BACKEND CANARY FAILED ({name}): "
                f"{a.words} vs {b.words}"
            )
            assert abs(a.score - b.score) < 1e-2 * max(1.0, abs(a.score)), (
                f"CROSS-BACKEND CANARY FAILED ({name}): "
                f"{a.score} vs {b.score}"
            )
        sys.stderr.write(f"canary ok: cpu=={device.platform} [{name}]\n")
        passed.append(name)
    return passed


def train_bench(dev):
    """BENCH_TRAIN=1: training-side performance.

    Conformer hybrid AM train step at production size (d512 x 12
    blocks, bf16 gemms, f32 params/LN; models/nn.py needs flax) —
    reports step time, frames/s, achieved TFLOP/s from the compiled
    executable's own cost analysis, and MFU vs the card's bf16 peak
    (:data:`PEAK_BF16_TFLOPS`). Two step timings:

    * device-resident batch (pure compute: the steady state when the
      input pipeline overlaps, as FrameDataset staging does), and
    * per-step host upload of the same batch (the un-overlapped worst
      case) — the gap IS the input-pipeline overlap win.

    Opt-in; prints the same single-JSON-line contract.
    """
    import jax

    from rasr_tpu.models.nn import ConformerEncoderNet
    from rasr_tpu.train.nn_trainer import SequenceTrainer, TrainConfig

    d_model = int(os.environ.get("BENCH_TRAIN_DMODEL", "512"))
    n_blocks = int(os.environ.get("BENCH_TRAIN_BLOCKS", "12"))
    num_classes = int(os.environ.get("BENCH_CLASSES", "2000"))
    B = int(os.environ.get("BENCH_TRAIN_BATCH", "16"))
    T = int(os.environ.get("BENCH_TRAIN_FRAMES", "400"))
    feat_dim = 45
    steps = int(os.environ.get("BENCH_TRAIN_STEPS", "20"))
    peak = peak_bf16_flops(dev.device_kind)

    net = ConformerEncoderNet(
        num_classes=num_classes, d_model=d_model, num_blocks=n_blocks,
        num_heads=8,
        compute_dtype=os.environ.get("BENCH_NN_DTYPE", "bfloat16"),
    )
    trainer = SequenceTrainer(net, num_classes, TrainConfig())
    params = trainer.init_params(feat_dim)
    opt_state = trainer.opt.init(params)
    rng = np.random.default_rng(0)
    x_h = rng.normal(size=(B, T, feat_dim)).astype(np.float32)
    y_h = rng.integers(0, num_classes, size=(B, T)).astype(np.int32)
    w_h = np.ones((B, T), np.float32)
    x, y, w = (jax.device_put(a) for a in (x_h, y_h, w_h))

    t0 = time.time()
    params, opt_state, loss, acc = trainer._step(params, opt_state, x, y, w)
    jax.block_until_ready((params, loss))
    sys.stderr.write(f"train warmup/compile {time.time()-t0:.1f}s\n")
    ca = trainer._step.lower(params, opt_state, x, y, w).compile().cost_analysis()
    if isinstance(ca, (list, tuple)):
        ca = ca[0]
    flops_per_step = float(ca["flops"])

    # steady state: a window of ``steps`` chained steps ending in
    # block_until_ready on the final params and loss
    def window(n, upload=False):
        nonlocal params, opt_state
        t0 = time.time()
        for _ in range(n):
            if upload:
                xi, yi, wi = (jax.device_put(a) for a in (x_h, y_h, w_h))
            else:
                xi, yi, wi = x, y, w
            params, opt_state, loss, acc = trainer._step(
                params, opt_state, xi, yi, wi
            )
        jax.block_until_ready((params, loss))
        return time.time() - t0

    window(2)  # settle dispatch path
    step_s = float(np.median([window(steps) / steps for _ in range(3)]))
    step_upload_s = float(np.median(
        [window(steps, True) / steps for _ in range(3)]
    ))

    tflops = flops_per_step / step_s / 1e12
    mfu = flops_per_step / step_s / peak
    sys.stderr.write(
        f"train step {step_s*1e3:.1f}ms ({B}x{T} frames, d{d_model}x"
        f"{n_blocks}) | {B*T/step_s:.0f} frames/s | "
        f"{tflops:.1f} TFLOP/s achieved | MFU {mfu*100:.1f}% | "
        f"with per-step upload {step_upload_s*1e3:.1f}ms "
        f"(pipeline overlap win {100*(step_upload_s-step_s)/step_upload_s:.0f}%)\n"
    )
    print(json.dumps({
        "metric": "train_mfu",
        "value": round(mfu * 100, 2),
        "unit": "percent_of_peak",
        "vs_baseline": round(mfu * 100 / 40.0, 4),  # 40% MFU = solid
        "step_ms": round(step_s * 1e3, 2),
        "frames_per_s": round(B * T / step_s, 1),
        "achieved_tflops": round(tflops, 2),
        "step_ms_with_upload": round(step_upload_s * 1e3, 2),
        **device_record(dev),
    }))


def main():
    import jax

    from rasr_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev = require_gpu()
    if os.environ.get("BENCH_TRAIN") == "1":
        return train_bench(dev)

    correctness_canary(dev)
    t_setup = time.time()
    fe, scorer, dec, tree = build_setup(
        num_words=int(os.environ.get("BENCH_WORDS", "5000")),
        num_classes=int(os.environ.get("BENCH_CLASSES", "2000")),
    )
    # B=64 is inherited; the H100's batch knee is unmeasured (ROADMAP S1)
    batch_size = int(os.environ.get("BENCH_BATCH", "64"))
    audio_seconds_each = float(os.environ.get("BENCH_AUDIO_S", "10"))
    iters = int(os.environ.get("BENCH_ITERS", "3"))

    rng = np.random.default_rng(1)
    sr = 16000
    S = int(audio_seconds_each * sr)
    samples = rng.normal(size=(batch_size, S)).astype(np.float32) * 0.1
    lengths = np.full(batch_size, S, np.int64)
    # stage the audio on device once (data loading overlaps compute in
    # production; the host->device copy is not frontend time)
    samples = jax.device_put(samples)
    lengths = jax.device_put(lengths)
    jax.block_until_ready(samples)
    sys.stderr.write(
        f"setup {time.time()-t_setup:.1f}s tree={tree.stats()} "
        f"device={dev.platform}/{dev.device_kind}\n"
    )

    def dispatch():
        feats, nf = fe(samples, lengths)
        emis = scorer(feats)  # stays on device; decode consumes it directly
        # nf stays ON DEVICE too: no host round trip between the stages
        return dec.decode_scores_device(emis, nf)

    t0 = time.time()
    dec.results_from_device(dispatch())  # compile + warmup
    sys.stderr.write(f"warmup/compile {time.time()-t0:.1f}s\n")

    # Median of >=3 separately timed windows. Within a window the next
    # batch's device work is dispatched BEFORE the current batch's
    # result is pulled (depth-2 software pipeline — bounded memory, and
    # host dispatch overlaps the device scan); each window ends with the
    # last batch's results on the host.
    windows = int(os.environ.get("BENCH_WINDOWS", "3"))
    audio_window = iters * batch_size * audio_seconds_each
    rates = []
    for w in range(windows):
        t0 = time.time()
        prev = None
        for _ in range(iters):
            b = dispatch()
            if prev is not None:
                res = dec.results_from_device(prev)
            prev = b
        res = dec.results_from_device(prev)
        rates.append(audio_window / (time.time() - t0))
        sys.stderr.write(f"window {w}: {rates[-1]:.1f} audio-s/s\n")
    value = float(np.median(rates))
    print(
        json.dumps(
            {
                "metric": "decode_throughput",
                "value": round(value, 3),
                "unit": "audio_seconds/s/chip",
                "vs_baseline": round(value / 50.0, 4),
                **device_record(dev),
            }
        )
    )


if __name__ == "__main__":
    main()
