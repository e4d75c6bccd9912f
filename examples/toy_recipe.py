#!/usr/bin/env python
"""End-to-end toy recipe: the classical ASR stage chain on a synthetic
tone corpus, driven entirely through the CLI tools.

Mirrors the reference workflow (SURVEY.md §3: feature extraction ->
GMM/HMM EM training -> forced alignment -> hybrid NN training ->
recognition -> lattice processing / WER), the way a Sisyphus-style
recipe would drive the reference's tools — every stage is a separate
process exchanging file artifacts, so any stage can be rerun or
inspected in isolation.

Run:  python examples/toy_recipe.py [workdir]
(CPU by default; set RECIPE_ON_GPU=1 to use the GPU. ~2-4 min on CPU.)

The corpus is synthesized (no datasets ship with the repo): each "word"
is a sequence of pure tones, one tone per phoneme, separated by low-
noise silence — enough structure for the GMM/HMM chain to reach 0 WER
and for every stage's artifact to be non-trivial.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def run_tool(module: str, *args: str, cwd: str) -> str:
    """One tool invocation = one process (like the reference's tools)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    if not env.get("RECIPE_ON_GPU"):
        env["JAX_PLATFORMS"] = "cpu"
    t0 = time.time()
    cmd = [sys.executable, "-m", f"rasr_tpu.tools.{module}", *args]
    print(f"\n$ {module} " + " ".join(a for a in args if not a.startswith('--')))
    for a in args:
        print(f"    {a}")
    out = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True, text=True)
    if out.returncode != 0:
        sys.stderr.write(out.stdout + out.stderr)
        raise SystemExit(f"{module} failed (rc={out.returncode})")
    print(f"  [{time.time()-t0:.1f}s] " + (out.stdout.strip().splitlines() or ["ok"])[-1])
    return out.stdout


def synthesize_corpus(workdir: str) -> None:
    """Toy corpus + lexicon + LM: 3 words over 3 tone-phonemes."""
    from rasr_tpu.corpus.audio import write_wav
    from rasr_tpu.models.lm.arpa import NgramLm

    rng = np.random.default_rng(2024)
    sr = 16000
    phones = {"a": 500.0, "b": 1400.0, "c": 2600.0}
    words = {"ABBA": ["a", "b", "b", "a"], "CAB": ["c", "a", "b"], "BC": ["b", "c"]}
    texts = [
        ["ABBA", "CAB"], ["CAB", "BC"], ["BC", "ABBA"], ["ABBA", "BC", "CAB"],
        ["CAB", "CAB"], ["BC", "BC", "ABBA"], ["ABBA"], ["CAB", "ABBA", "BC"],
    ] * 2

    def tone(p, dur):
        t = np.arange(int(dur * sr)) / sr
        return (0.3 * np.sin(2 * np.pi * phones[p] * t)).astype(np.float32)

    def silence(dur):
        return (0.002 * rng.normal(size=int(dur * sr))).astype(np.float32)

    xml = ['<corpus name="toy">']
    for i, ws in enumerate(texts):
        audio = [silence(0.15)]
        for w in ws:
            for p in words[w]:
                audio.append(tone(p, 0.2))
            audio.append(silence(0.15))
        a = np.concatenate(audio)
        write_wav(os.path.join(workdir, f"rec{i}.wav"), a, sr)
        xml.append(
            f'<recording name="rec{i}" audio="rec{i}.wav">'
            f'<segment name="s" start="0" end="{len(a)/sr}">'
            f"<orth>{' '.join(ws)}</orth></segment></recording>"
        )
    xml.append("</corpus>")
    with open(os.path.join(workdir, "toy.corpus"), "w") as fh:
        fh.write("".join(xml))

    lex = ["<lexicon><phoneme-inventory>"]
    for p in phones:
        lex.append(f"<phoneme><symbol>{p}</symbol></phoneme>")
    lex.append("<phoneme><symbol>si</symbol><variation>none</variation></phoneme>")
    lex.append("</phoneme-inventory>")
    lex.append('<lemma special="silence"><orth>[SILENCE]</orth><phon>si</phon><synt/><eval/></lemma>')
    for w, ps in words.items():
        lex.append(f"<lemma><orth>{w}</orth><phon>{' '.join(ps)}</phon></lemma>")
    lex.append("</lexicon>")
    with open(os.path.join(workdir, "lexicon.xml"), "w") as fh:
        fh.write("".join(lex))

    NgramLm.train_from_text(texts, order=2).write_arpa(
        os.path.join(workdir, "lm.arpa")
    )
    print(f"synthesized {len(texts)} recordings, 3-word lexicon, bigram LM")


def main() -> None:
    workdir = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else "toy_work")
    os.makedirs(workdir, exist_ok=True)
    print(f"workdir: {workdir}")
    synthesize_corpus(workdir)
    fe_norm = "--feature-extraction.frontend.normalize=none"

    # -- stage 1: corpus statistics (ref: corpus-statistics tool)
    out = run_tool("corpus_statistics",
                   "--corpus-statistics.corpus-file=toy.corpus", cwd=workdir)
    assert json.loads(out)["segments"] == 16

    # -- stage 2: feature extraction into a cache archive
    run_tool("feature_extraction",
             "--feature-extraction.corpus-file=toy.corpus",
             "--feature-extraction.cache=feat.cache", fe_norm, cwd=workdir)

    # -- stage 3: GMM/HMM EM training (align -> accumulate -> estimate loop)
    run_tool("acoustic_model_trainer",
             "--acoustic-model-trainer.action=train",
             "--acoustic-model-trainer.corpus-file=toy.corpus",
             "--acoustic-model-trainer.lexicon-file=lexicon.xml",
             "--acoustic-model-trainer.states-per-phone=1",
             "--acoustic-model-trainer.iterations=5",
             "--acoustic-model-trainer.splits=1",
             "--acoustic-model-trainer.new-mixture-file=model.mix",
             "--acoustic-model-trainer.frontend.normalize=none", cwd=workdir)

    # -- stage 4: recognition with the GMM (lattices + online WER)
    out = run_tool("speech_recognizer",
                   "--speech-recognizer.corpus-file=toy.corpus",
                   "--speech-recognizer.lexicon-file=lexicon.xml",
                   "--speech-recognizer.lm-file=lm.arpa",
                   "--speech-recognizer.mixture-file=model.mix",
                   "--speech-recognizer.states-per-phone=1",
                   "--speech-recognizer.lattice-archive=lat.cache",
                   "--speech-recognizer.search.lm-scale=2.0",
                   "--speech-recognizer.search.max-hyps=256",
                   "--speech-recognizer.frontend.normalize=none", cwd=workdir)
    assert "WER: 0.0000" in out, "GMM recognition should nail the toy corpus"

    # -- stage 4b: CART triphone tying + retrained triphone GMM
    # (the reference's monophone -> CART-triphone stage)
    run_tool("acoustic_model_trainer",
             "--acoustic-model-trainer.action=estimate-cart",
             "--acoustic-model-trainer.corpus-file=toy.corpus",
             "--acoustic-model-trainer.lexicon-file=lexicon.xml",
             "--acoustic-model-trainer.states-per-phone=1",
             "--acoustic-model-trainer.mixture-file=model.mix",
             "--acoustic-model-trainer.cart-output-file=cart.json",
             "--acoustic-model-trainer.cart-max-leaves=8",
             "--acoustic-model-trainer.frontend.normalize=none", cwd=workdir)
    run_tool("acoustic_model_trainer",
             "--acoustic-model-trainer.action=train",
             "--acoustic-model-trainer.corpus-file=toy.corpus",
             "--acoustic-model-trainer.lexicon-file=lexicon.xml",
             "--acoustic-model-trainer.states-per-phone=1",
             "--acoustic-model-trainer.iterations=4",
             "--acoustic-model-trainer.cart-file=cart.json",
             "--acoustic-model-trainer.new-mixture-file=tri.mix",
             "--acoustic-model-trainer.frontend.normalize=none", cwd=workdir)
    out = run_tool("speech_recognizer",
                   "--speech-recognizer.corpus-file=toy.corpus",
                   "--speech-recognizer.lexicon-file=lexicon.xml",
                   "--speech-recognizer.lm-file=lm.arpa",
                   "--speech-recognizer.mixture-file=tri.mix",
                   "--speech-recognizer.states-per-phone=1",
                   "--speech-recognizer.cart-file=cart.json",
                   "--speech-recognizer.search.lm-scale=2.0",
                   "--speech-recognizer.search.max-hyps=256",
                   "--speech-recognizer.frontend.normalize=none", cwd=workdir)
    assert "WER: 0.0000" in out, "triphone recognition should nail the toy corpus"

    # -- stage 4c: across-word triphone decoding — exact word-boundary
    # contexts (context-conditioned roots + word-end fan-out) with the
    # same CART triphone model
    out = run_tool("speech_recognizer",
                   "--speech-recognizer.corpus-file=toy.corpus",
                   "--speech-recognizer.lexicon-file=lexicon.xml",
                   "--speech-recognizer.lm-file=lm.arpa",
                   "--speech-recognizer.mixture-file=tri.mix",
                   "--speech-recognizer.states-per-phone=1",
                   "--speech-recognizer.cart-file=cart.json",
                   "--speech-recognizer.across-word=true",
                   "--speech-recognizer.search.lm-scale=2.0",
                   "--speech-recognizer.search.max-hyps=256",
                   "--speech-recognizer.frontend.normalize=none", cwd=workdir)
    assert "WER: 0.0000" in out, "across-word recognition should nail the toy corpus"

    # -- stage 5: forced alignment cache for NN training
    run_tool("acoustic_model_trainer",
             "--acoustic-model-trainer.action=align",
             "--acoustic-model-trainer.corpus-file=toy.corpus",
             "--acoustic-model-trainer.lexicon-file=lexicon.xml",
             "--acoustic-model-trainer.states-per-phone=1",
             "--acoustic-model-trainer.mixture-file=model.mix",
             "--acoustic-model-trainer.alignment-cache=align.cache",
             "--acoustic-model-trainer.frontend.normalize=none", cwd=workdir)

    # -- stage 6: hybrid NN training on the alignments + state priors
    run_tool("nn_trainer",
             "--nn-trainer.action=supervised-training",
             "--nn-trainer.feature-cache=feat.cache",
             "--nn-trainer.alignment-cache=align.cache",
             "--nn-trainer.hidden-layers=32 32",
             "--nn-trainer.epochs=6",
             "--nn-trainer.params-file=nn.msgpack", cwd=workdir)
    run_tool("nn_trainer",
             "--nn-trainer.action=estimate-priors",
             "--nn-trainer.feature-cache=feat.cache",
             "--nn-trainer.alignment-cache=align.cache",
             "--nn-trainer.priors-file=priors.npy", cwd=workdir)

    # -- stage 7: hybrid recognition (same decoder, NN emission scorer).
    # am-scale=10: -log posterior emissions are ~an order of magnitude
    # smaller than GMM -log likelihoods, so the acoustic scale must rise
    # to keep the acoustic/TDP/LM balance (the classic hybrid-system
    # scale setting; with am-scale=1 the all-silence path wins).
    out = run_tool("speech_recognizer",
                   "--speech-recognizer.corpus-file=toy.corpus",
                   "--speech-recognizer.lexicon-file=lexicon.xml",
                   "--speech-recognizer.lm-file=lm.arpa",
                   "--speech-recognizer.mixture-file=model.mix",
                   "--speech-recognizer.states-per-phone=1",
                   "--speech-recognizer.am-scale=10",
                   "--speech-recognizer.feature-scorer-type=nn-hybrid",
                   "--speech-recognizer.nn-params-file=nn.msgpack",
                   "--speech-recognizer.nn-priors-file=priors.npy",
                   "--speech-recognizer.nn-hidden-layers=32 32",
                   "--speech-recognizer.search.lm-scale=4.0",
                   "--speech-recognizer.search.max-hyps=256",
                   "--speech-recognizer.frontend.normalize=none", cwd=workdir)
    assert "WER: 0.0000" in out, "hybrid recognition should nail the toy corpus"

    # -- stage 8: lattice processing — prune, best, oracle, WER
    out = run_tool("flf_tool",
                   "--flf-tool.lattice-archive=lat.cache",
                   "--flf-tool.corpus-file=toy.corpus",
                   "--flf-tool.ops=prune best evaluate oracle", cwd=workdir)
    assert "WER: 0.0000" in out

    # -- stage 9: speaker adaptation (fMLLR/SAT; ref: the CMLLR pass of
    # the reference's SAT recipes) — estimate per-speaker transforms
    # under the GMM, recognize in the adapted feature space
    run_tool("acoustic_model_trainer",
             "--acoustic-model-trainer.action=estimate-fmllr",
             "--acoustic-model-trainer.corpus-file=toy.corpus",
             "--acoustic-model-trainer.lexicon-file=lexicon.xml",
             "--acoustic-model-trainer.states-per-phone=1",
             "--acoustic-model-trainer.mixture-file=model.mix",
             "--acoustic-model-trainer.fmllr-output-file=fmllr.json",
             "--acoustic-model-trainer.fmllr-min-count=50",
             "--acoustic-model-trainer.frontend.normalize=none", cwd=workdir)
    out = run_tool("speech_recognizer",
                   "--speech-recognizer.corpus-file=toy.corpus",
                   "--speech-recognizer.lexicon-file=lexicon.xml",
                   "--speech-recognizer.lm-file=lm.arpa",
                   "--speech-recognizer.mixture-file=model.mix",
                   "--speech-recognizer.states-per-phone=1",
                   "--speech-recognizer.fmllr-file=fmllr.json",
                   "--speech-recognizer.search.lm-scale=2.0",
                   "--speech-recognizer.search.max-hyps=256",
                   "--speech-recognizer.frontend.normalize=none", cwd=workdir)
    assert "WER: 0.0000" in out, "fMLLR-adapted recognition regressed"

    # -- stage 10: sequence-discriminative NN training (LF-MMI through a
    # BLSTM encoder; numerator graphs from the corpus orths, phone-
    # bigram denominator over the lexicon)
    run_tool("nn_trainer",
             "--nn-trainer.action=sequence-mmi-training",
             "--nn-trainer.model-type=blstm",
             "--nn-trainer.corpus-file=toy.corpus",
             "--nn-trainer.lexicon-file=lexicon.xml",
             "--nn-trainer.states-per-phone=1",
             "--nn-trainer.feature-cache=feat.cache",
             "--nn-trainer.alignment-cache=align.cache",
             "--nn-trainer.hidden-layers=32",
             "--nn-trainer.epochs=4",
             "--nn-trainer.learning-rate=0.005",
             "--nn-trainer.optimizer=adam",
             "--nn-trainer.params-file=mmi.msgpack", cwd=workdir)
    assert os.path.exists(os.path.join(workdir, "mmi.msgpack"))

    # -- stage 10b: sMBR fine-tune from the MMI model (lattice-free
    # state-level minimum Bayes risk; MPE-style phone accuracy)
    run_tool("nn_trainer",
             "--nn-trainer.action=sequence-smbr-training",
             "--nn-trainer.model-type=blstm",
             "--nn-trainer.corpus-file=toy.corpus",
             "--nn-trainer.lexicon-file=lexicon.xml",
             "--nn-trainer.states-per-phone=1",
             "--nn-trainer.feature-cache=feat.cache",
             "--nn-trainer.alignment-cache=align.cache",
             "--nn-trainer.hidden-layers=32",
             "--nn-trainer.epochs=3",
             "--nn-trainer.learning-rate=0.002",
             "--nn-trainer.optimizer=adam",
             "--nn-trainer.smbr-accuracy=phone",
             "--nn-trainer.init-params-file=mmi.msgpack",
             "--nn-trainer.params-file=smbr.msgpack", cwd=workdir)
    assert os.path.exists(os.path.join(workdir, "smbr.msgpack"))

    # -- stage 11: model-space MLLR (per-speaker mean-adapted mixtures;
    # this corpus has one speaker group, so one adapted model)
    run_tool("acoustic_model_trainer",
             "--acoustic-model-trainer.action=estimate-mllr",
             "--acoustic-model-trainer.corpus-file=toy.corpus",
             "--acoustic-model-trainer.lexicon-file=lexicon.xml",
             "--acoustic-model-trainer.states-per-phone=1",
             "--acoustic-model-trainer.mixture-file=model.mix",
             "--acoustic-model-trainer.mllr-min-count=50",
             "--acoustic-model-trainer.frontend.normalize=none", cwd=workdir)
    out = run_tool("speech_recognizer",
                   "--speech-recognizer.corpus-file=toy.corpus",
                   "--speech-recognizer.lexicon-file=lexicon.xml",
                   "--speech-recognizer.lm-file=lm.arpa",
                   "--speech-recognizer.mixture-file=mllr-default.mix",
                   "--speech-recognizer.states-per-phone=1",
                   "--speech-recognizer.search.lm-scale=2.0",
                   "--speech-recognizer.search.max-hyps=256",
                   "--speech-recognizer.frontend.normalize=none", cwd=workdir)
    assert "WER: 0.0000" in out, "MLLR-adapted recognition regressed"

    print("\nrecipe complete: monophone / CART-triphone / hybrid / "
          f"fMLLR- and MLLR-adapted all at WER 0.0000 (+ LF-MMI and sMBR "
          f"sequence-trained BLSTM); artifacts in {workdir}")


if __name__ == "__main__":
    main()
