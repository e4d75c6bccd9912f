"""Real multi-process jax.distributed test on localhost (SURVEY §4:
"multi-host without a cluster — jax.distributed multi-process tests via
subprocess on localhost"). Two OS processes x two CPU devices form one
global (4,1) mesh; the framework's DP-EM psum reduction and counter
psum must equal the single-process oracle — the collective replacement
for the reference's accumulator-file merge, validated across a real
process boundary (Gloo collectives over the loopback)."""

import os
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = textwrap.dedent(
    """
    import sys
    sys.path.insert(0, {repo!r})
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 2)
    pid = int(sys.argv[1]); port = sys.argv[2]
    jax.distributed.initialize(
        f"localhost:{{port}}", num_processes=2, process_id=pid
    )
    import numpy as np
    from jax.sharding import Mesh
    from rasr_tpu.models.gmm import MixtureSet
    from rasr_tpu.parallel.sharded import dp_accumulate, psum_counters
    from rasr_tpu.train.em import GmmAccumulator, accumulate

    rng = np.random.default_rng(0)  # same global batch in every process
    M, K, D, N = 4, 2, 6, 64
    model = MixtureSet(
        means=rng.normal(size=(M, K, D)).astype(np.float32),
        variances=(0.5 + rng.uniform(size=(M, K, D))).astype(np.float32),
        weights=np.full((M, K), 0.5, np.float32),
        num_densities=np.full(M, K, np.int32),
    )
    feats = rng.normal(size=(N, D)).astype(np.float32)
    labels = rng.integers(0, M, size=N).astype(np.int32)

    mesh = Mesh(np.array(jax.devices()).reshape(4, 1), ("data", "model"))
    count, s1, s2 = dp_accumulate(mesh, model, feats, labels)

    acc = GmmAccumulator.zeros(M, K, D)
    accumulate(acc, model, feats, labels)
    assert np.allclose(count, acc.count, rtol=1e-4, atol=1e-4)
    assert np.allclose(s1, acc.sum, rtol=1e-4, atol=1e-4)
    assert np.allclose(s2, acc.sumsq, rtol=1e-3, atol=1e-3)

    wer = psum_counters(mesh, np.tile([[3.0, 100.0]], (4, 1)).astype(np.float32))
    assert np.allclose(np.asarray(wer), [12.0, 400.0])
    print(f"MP-OK {{pid}}")
    """
)



pytestmark = pytest.mark.slow  # full tier: pytest -m "" tests/

def test_two_process_dp_em(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER.format(repo=REPO))
    import socket

    with socket.socket() as sk:  # reserve a genuinely free port
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env.pop("JAX_PLATFORMS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(i), str(port)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=240)
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out}"
        assert f"MP-OK {i}" in out


# -------------------------------------------- end-to-end recognition (r2)
RECOG_WORKER = textwrap.dedent(
    """
    import os, sys
    sys.path.insert(0, {repo!r})
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 1)
    mode = sys.argv[1]          # "mp" or "solo"
    pid = int(sys.argv[2])
    port = sys.argv[3]
    work = sys.argv[4]
    tag = sys.argv[5]
    nproc = 2 if mode == "mp" else 1
    if mode == "mp":
        jax.distributed.initialize(
            f"localhost:{{port}}", num_processes=2, process_id=pid
        )
    import numpy as np
    import jax.numpy as jnp

    from rasr_tpu.corpus.bliss import CorpusDescription
    from rasr_tpu.corpus.lexicon import Lexicon, build_default_silence
    from rasr_tpu.lattice.evaluator import align_tokens
    from rasr_tpu.models.gmm import MixtureSet
    from rasr_tpu.models.hmm import HmmTopology, Tdp, TransitionModel
    from rasr_tpu.models.lm.arpa import NgramLm
    from rasr_tpu.models.lm.ngram_tpu import compile_ngram
    from rasr_tpu.models.scorer import GmmFeatureScorer
    from rasr_tpu.models.tying import MonophoneStateTying
    from rasr_tpu.parallel.workqueue import CorpusWorkQueue
    from rasr_tpu.search.decoder import BeamConfig, TreeDecoder
    from rasr_tpu.search.tree import build_prefix_tree
    from rasr_tpu.utils.archive import FileArchive

    # deterministic setup shared by every process (and the parent oracle)
    lex = Lexicon()
    build_default_silence(lex)
    lex.add_lemma(["AB"], [(["a", "b"], 0.0)])
    lex.add_lemma(["BA"], [(["b", "a"], 0.0)])
    topo = HmmTopology(states_per_phone=1, silence_states=1)
    tying = MonophoneStateTying(lex, topo)
    lm = NgramLm.train_from_text([["AB", "BA"], ["BA", "AB"]], order=2)
    import math
    trans = TransitionModel(
        speech=Tdp(loop=1.0, forward=0.0, skip=math.inf, exit=0.5),
        silence=Tdp(loop=0.2, forward=0.5, skip=math.inf, exit=0.3),
    )
    tree = build_prefix_tree(lex, tying, topo, trans, lm_vocab=lm.vocab)
    tables = compile_ngram(lm)
    M = tying.num_classes
    means = np.eye(M, dtype=np.float32)[:, None, :] * 4.0
    ms = MixtureSet(
        means=means,
        variances=np.ones((M, 1, M), np.float32),
        weights=np.ones((M, 1), np.float32),
        num_densities=np.ones(M, np.int32),
    )
    scorer = GmmFeatureScorer(ms, scale=1.0)
    dec = TreeDecoder(
        tree, tables, BeamConfig(max_hyps=64, word_end_limit=16, lm_scale=0.5)
    )

    corpus = CorpusDescription.load(os.path.join(work, "toy.corpus"))
    featz = np.load(os.path.join(work, "feats.npz"))
    done_path = os.path.join(work, f"done.{{tag}}.p{{pid}}.cache")
    wq = CorpusWorkQueue(
        corpus, process_index=pid, process_count=nproc,
        done_archive=done_path,
    )
    stats = {{"err": 0.0, "ref": 0.0}}
    crash_after = int(os.environ.get("CRASH_AFTER_BATCHES", "0"))
    batches = [0]

    def process_fn(batch):
        fl = [featz[s.full_name] for s in batch]
        T = max(f.shape[0] for f in fl)
        feats = np.zeros((len(fl), T, M), np.float32)
        nf = np.zeros(len(fl), np.int32)
        for i, f in enumerate(fl):
            feats[i, : f.shape[0]] = f
            nf[i] = f.shape[0]
        emis = np.asarray(scorer(feats))
        results = dec.decode_scores(emis, nf, names=[s.full_name for s in batch])
        with FileArchive(done_path, "a") as ar:
            for s, r in zip(batch, results):
                st, _ = align_tokens(s.orth.split(), r.words)
                stats["err"] += st.errors
                stats["ref"] += st.reference_length
                ar.write(s.full_name, r.orth.encode())
        batches[0] += 1
        if crash_after and batches[0] >= crash_after:
            print(f"CRASHING after {{batches[0]}} batches", flush=True)
            os._exit(17)  # simulated mid-run death
        return [s.full_name for s in batch]

    rep = wq.run(process_fn, batch_size=2)

    if mode == "mp":
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

        mesh = Mesh(np.array(jax.devices()).reshape(2, 1), ("data", "model"))
        dp = NamedSharding(mesh, P("data"))
        local = np.array([[stats["err"], stats["ref"]]], np.float32)
        garr = jax.make_array_from_process_local_data(dp, local)
        tot = np.asarray(
            jax.jit(
                lambda v: jnp.sum(v, axis=0),
                out_shardings=NamedSharding(mesh, P()),
            )(garr)
        )
        print(
            f"REC-OK {{pid}} processed={{rep.processed}} "
            f"skipped={{rep.skipped}} err={{tot[0]:.0f}} ref={{tot[1]:.0f}}"
        )
    else:
        print(
            f"REC-OK {{pid}} processed={{rep.processed}} "
            f"skipped={{rep.skipped}} err={{stats['err']:.0f}} "
            f"ref={{stats['ref']:.0f}}"
        )
    """
)


def _build_recog_workdir(tmp_path):
    """Toy corpus + planted per-segment features (one known-bad segment
    so merged error counters are non-trivial). Returns the expected
    (errors, ref_len) of a full single-process recognition."""
    rng = np.random.default_rng(3)
    texts = [["AB", "BA"], ["BA", "AB"], ["AB", "AB"], ["BA", "BA"],
             ["AB"], ["BA", "AB", "AB"]]
    xml = ['<corpus name="toy">']
    feats = {}
    # class layout mirrors the worker: MonophoneStateTying over (a,b,si)
    sys.path.insert(0, REPO)
    from rasr_tpu.corpus.lexicon import Lexicon, build_default_silence
    from rasr_tpu.models.hmm import HmmTopology
    from rasr_tpu.models.tying import MonophoneStateTying
    from rasr_tpu.models.allophone import Allophone, AllophoneState

    lex = Lexicon()
    build_default_silence(lex)
    lex.add_lemma(["AB"], [(["a", "b"], 0.0)])
    lex.add_lemma(["BA"], [(["b", "a"], 0.0)])
    topo = HmmTopology(states_per_phone=1, silence_states=1)
    tying = MonophoneStateTying(lex, topo)

    def cls(sym):
        return tying.classify(AllophoneState(Allophone(lex.phonemes[sym].id), 0))

    M = tying.num_classes
    word_phones = {"AB": ["a", "b"], "BA": ["b", "a"]}
    expected_err = 0
    expected_ref = 0
    for i, ws in enumerate(texts):
        name = f"toy/rec{i}/s"  # segment full_name includes the corpus
        # planted class sequence: sil word+ sil
        seq = [cls("si")]
        spoken = list(ws)
        if i == 2:
            # segment 2 SAYS "BA BA" while the reference orth is "AB AB"
            spoken = ["BA", "BA"]
            expected_err += 2
        expected_ref += len(ws)
        for w in spoken:
            for p in word_phones[w]:
                seq.extend([cls(p)] * 2)
        seq.append(cls("si"))
        f = np.eye(M, dtype=np.float32)[np.asarray(seq)] * 4.0
        f += 0.05 * rng.normal(size=f.shape).astype(np.float32)
        feats[name] = f
        xml.append(
            f'<recording name="rec{i}" audio="rec{i}.wav">'
            f'<segment name="s" start="0" end="1">'
            f"<orth>{' '.join(ws)}</orth></segment></recording>"
        )
    xml.append("</corpus>")
    (tmp_path / "toy.corpus").write_text("".join(xml))
    np.savez(tmp_path / "feats.npz", **feats)
    return expected_err, expected_ref


def _run_worker(worker, mode, pid, port, work, tag, env, timeout=300):
    return subprocess.run(
        [sys.executable, str(worker), mode, str(pid), str(port), str(work), tag],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, timeout=timeout,
    )


def _parse_rec(out, pid=0):
    m = re.search(
        rf"REC-OK {pid} processed=(\d+) skipped=(\d+) err=(\d+) ref=(\d+)",
        out,
    )
    assert m, out
    return tuple(int(g) for g in m.groups())


def test_two_process_recognition_with_psum_wer(tmp_path):
    """End-to-end DP recognition across a real process boundary
    (multi-process scale-out): two OS processes decode disjoint corpus
    partitions through CorpusWorkQueue, persist per-segment results in
    idempotent archives, and psum-merge their WER counters over a
    jax.distributed mesh — the merged counters must equal an
    uninterrupted single-process run of the same recognition."""
    _build_recog_workdir(tmp_path)
    worker = tmp_path / "worker.py"
    worker.write_text(RECOG_WORKER.format(repo=REPO))
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env.pop("JAX_PLATFORMS", None)

    solo = _run_worker(worker, "solo", 0, "0", tmp_path, "oracle", env)
    assert solo.returncode == 0, solo.stdout
    done_s, skip_s, err_s, ref_s = _parse_rec(solo.stdout)
    assert done_s == 6 and skip_s == 0
    assert err_s > 0  # the planted bad segment must produce errors

    import socket

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), "mp", str(i), str(port),
             str(tmp_path), "mp"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for i in range(2)
    ]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    done_total = 0
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out}"
        d, s, err, ref = _parse_rec(out, pid=i)
        done_total += d
        # every process sees the SAME merged counters (replicated psum)
        # and they equal the single-process run
        assert (err, ref) == (err_s, ref_s), (out, err_s, ref_s)
    assert done_total == 6  # disjoint partitions cover the corpus


def test_recognition_resume_after_crash(tmp_path):
    """Failure recovery: the worker dies after its
    first batch; the rerun's work queue skips the segments already in
    the done archive and completes the rest — the done archive then
    holds exactly the uninterrupted run's hypotheses."""
    _build_recog_workdir(tmp_path)
    worker = tmp_path / "worker.py"
    worker.write_text(RECOG_WORKER.format(repo=REPO))
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env.pop("JAX_PLATFORMS", None)

    solo = _run_worker(worker, "solo", 0, "0", tmp_path, "oracle", env)
    assert solo.returncode == 0, solo.stdout
    _, _, err_s, ref_s = _parse_rec(solo.stdout)

    env1 = dict(env)
    env1["CRASH_AFTER_BATCHES"] = "1"
    p = _run_worker(worker, "solo", 0, "0", tmp_path, "resume", env1)
    assert p.returncode == 17, p.stdout  # died mid-run as instructed
    assert "CRASHING after 1 batches" in p.stdout

    p2 = _run_worker(worker, "solo", 0, "0", tmp_path, "resume", env)
    assert p2.returncode == 0, p2.stdout
    processed, skipped, _, _ = _parse_rec(p2.stdout)
    assert skipped == 2  # the crashed run's first batch was persisted
    assert processed == 4
    # the archive now covers every segment; totals == uninterrupted run
    from rasr_tpu.utils.archive import FileArchive
    from rasr_tpu.corpus.bliss import CorpusDescription
    from rasr_tpu.lattice.evaluator import align_tokens

    corpus = CorpusDescription.load(str(tmp_path / "toy.corpus"))
    total_err = 0
    total_ref = 0
    with FileArchive(str(tmp_path / "done.resume.p0.cache"), "r") as ar:
        keys = set(ar.keys())
        for seg in corpus.segments():
            assert seg.full_name in keys
            hyp = ar.read(seg.full_name).decode().split()
            st, _ = align_tokens(seg.orth.split(), hyp)
            total_err += st.errors
            total_ref += st.reference_length
    assert (total_err, total_ref) == (err_s, ref_s)
