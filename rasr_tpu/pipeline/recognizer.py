"""Offline recognition driver.

Re-implements the reference's recognizer
(ref: src/Speech/Recognizer.* — per segment: restart search, feed
features, log <recognized> with timing/RTF statistics, online WER vs the
reference orth, optional lattice archive write). Here whole
batches decode at once; per-segment structured records keep the same
semantic fields (segment id, orth, score, RTF).
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np

from ..lattice.lattice import decoder_lattice
from ..lattice.evaluator import CorpusEvaluator
from ..models.scorer import FeatureScorer
from ..ops.frontend import FeatureFrontend
from ..search.decoder import DecodeResult, TreeDecoder
from ..utils.archive import FileArchive
from ..utils.logging import LogManager
from ..utils.statistics import Accumulator
from .visitor import CorpusVisitor, prefetch_batches


class OfflineRecognizer:
    def __init__(
        self,
        frontend: FeatureFrontend,
        scorer: FeatureScorer,
        decoder: TreeDecoder,
        lattice_archive: Optional[str] = None,
        frame_shift_s: float = 0.01,
        mesh=None,
        prefetch: bool = True,
        feature_cache: Optional[str] = None,
        feature_transforms=None,
        ctm_file: Optional[str] = None,
        nbest_file: Optional[str] = None,
        nbest: int = 10,
    ):
        self.frontend = frontend
        self.scorer = scorer
        self.decoder = decoder
        #: optional device mesh: utterance batches decode DP-sharded
        #: over the mesh's ``data`` axis (decode_scores(mesh=...))
        self.mesh = mesh
        self.lattice_archive = lattice_archive
        self.frame_shift_s = frame_shift_s
        self.log = LogManager.get().channel("recognizer", "log")
        self.stats = LogManager.get().channel("recognizer", "statistics")
        self.evaluator = CorpusEvaluator()
        self.rtf = Accumulator("rtf")
        #: overlap next batch's audio read/pad with the device decode
        self.prefetch = prefetch
        #: read features from this cache archive by segment name instead
        #: of running the frontend on audio (ref: decoding from feature
        #: caches — pair with CorpusVisitor(load_audio=False))
        self.feature_cache = feature_cache
        #: optional per-speaker fMLLR transforms {speaker: W [D, D+1]}
        #: applied after the frontend (ref: the adaptation pass of the
        #: reference's recognizer; train/fmllr.py)
        self.feature_transforms = feature_transforms
        #: optional CTM (time-marked conversation) output: one
        #: ``<recording> <channel> <begin_s> <dur_s> <word>`` line per
        #: recognized word, absolute times (segment start + frame
        #: boundaries from the decoder's word ends)
        self.ctm_file = ctm_file
        #: optional n-best output: ``<segment> <rank> <score> <words>``
        #: lines from the decode lattice (ref: Flf n-best extraction,
        #: here inline at recognition time)
        self.nbest_file = nbest_file
        self.nbest = nbest

    def _cached_features(self, batch):
        from .feature_extractor import load_features

        rows = [load_features(self.feature_cache, s.full_name) for s in batch.segments]
        T = max(r.shape[0] for r in rows)
        D = rows[0].shape[1]
        feats = np.zeros((len(rows), T, D), np.float32)
        n_frames = np.zeros(len(rows), np.int32)
        for i, r in enumerate(rows):
            feats[i, : r.shape[0]] = r
            n_frames[i] = r.shape[0]
        return feats, n_frames

    def _ctm_lines(self, seg, res) -> List[str]:
        lines = []
        prev_end = -1
        for lemma, end in zip(res.lemmas, res.word_ends):
            tokens = lemma.eval_tokens()
            begin_f, dur_f = prev_end + 1, max(end - prev_end, 1)
            prev_end = end
            if not tokens:  # silence / non-scored lemma
                continue
            tdur = dur_f * self.frame_shift_s / len(tokens)
            for k, tok in enumerate(tokens):
                t0 = seg.start + (begin_f * self.frame_shift_s) + k * tdur
                lines.append(
                    f"{seg.recording.name} {1 + seg.track} "
                    f"{t0:.3f} {tdur:.3f} {tok}"
                )
        return lines

    def run(self, visitor: CorpusVisitor) -> List[DecodeResult]:
        results: List[DecodeResult] = []
        archive = (
            FileArchive(self.lattice_archive, "a") if self.lattice_archive else None
        )
        ctm = open(self.ctm_file, "w", encoding="utf-8") if self.ctm_file else None
        nbf = (
            open(self.nbest_file, "w", encoding="utf-8")
            if self.nbest_file else None
        )
        try:
            batches = (
                prefetch_batches(visitor) if self.prefetch else visitor.batches()
            )
            for batch in batches:
                t0 = time.perf_counter()
                if self.feature_cache:
                    feats, n_frames = self._cached_features(batch)
                else:
                    feats, n_frames = self.frontend(batch.samples, batch.lengths)
                if self.feature_transforms:
                    # applied ON DEVICE: a [B,D,D] batched einsum — no
                    # host round trip in the decode loop (CLAUDE.md:
                    # device->host transfers cost ~70ms fixed each)
                    import jax.numpy as jnp

                    from ..train.fmllr import batch_transform_tensors

                    A, b = batch_transform_tensors(
                        batch.segments, self.feature_transforms,
                        int(feats.shape[-1]),
                    )
                    feats = (
                        jnp.einsum("btd,bed->bte", jnp.asarray(feats), jnp.asarray(A))
                        + jnp.asarray(b)[:, None, :]
                    )
                emis = self.scorer(feats)  # device array straight into decode
                batch_results = self.decoder.decode_scores(
                    emis, np.asarray(n_frames), batch.names, mesh=self.mesh
                )
                elapsed = time.perf_counter() - t0
                audio_s = float(batch.lengths.sum()) / visitor.sample_rate
                rtf = elapsed / max(audio_s, 1e-9)
                self.rtf.add(rtf)
                for i, res in enumerate(batch_results):
                    results.append(res)
                    seg = batch.segments[i]
                    if seg.orth:
                        self.evaluator.add(seg.full_name, seg.orth, res.orth)
                    self.stats(
                        "recognized",
                        segment=seg.full_name,
                        speaker=seg.speaker or "",
                        recognized=res.orth,
                        reference=seg.orth,
                        score=res.score,
                        frames=int(np.asarray(n_frames)[i]),
                        rtf=rtf,
                    )
                    if archive is not None or nbf is not None:
                        lat = decoder_lattice(self.decoder, i)
                        if archive is not None:
                            archive.write(seg.full_name, lat.pack())
                        if nbf is not None:
                            from ..lattice.flf import n_best

                            for rank, (score, path) in enumerate(
                                n_best(lat, self.nbest)
                            ):
                                words = " ".join(
                                    lat.lemma_orths[a.lemma]
                                    for a in path
                                    if a.lemma >= 0
                                    and not lat.lemma_orths[a.lemma].startswith("[")
                                )
                                nbf.write(
                                    f"{seg.full_name} {rank} {score:.4f} {words}\n"
                                )
                    if ctm is not None:
                        for line in self._ctm_lines(seg, res):
                            ctm.write(line + "\n")
        finally:
            if archive is not None:
                archive.close()
            if ctm is not None:
                ctm.close()
            if nbf is not None:
                nbf.close()
        report = self.evaluator.report()
        self.log("corpus done", **report, mean_rtf=self.rtf.mean)
        return results
