"""feature-extraction tool (ref: src/Tools/FeatureExtraction/).

Runs the batched frontend over a corpus into a feature cache archive.

Config (RASR-style selectors)::

    [feature-extraction]
    corpus-file   = train.corpus
    audio-dir     = /data/audio
    cache         = features.cache
    batch-size    = 8
    [feature-extraction.frontend]
    num-cepstra   = 16
    splice        = 4
    lda-file      = lda.npy        # optional
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..corpus.bliss import CorpusDescription
from ..ops.frontend import FeatureFrontend, FrontendConfig
from ..pipeline.feature_extractor import FeatureExtractor
from ..pipeline.visitor import CorpusVisitor
from ..utils.component import (
    ParameterBool, ParameterFloat, ParameterInt, ParameterString,
)
from .application import Application


def frontend_spec_from_config(component):
    """(FrontendConfig, FeatureFrontend kwargs) from a component's
    ``frontend`` scope — split out so per-speaker VTLN variants can be
    instantiated from one spec."""
    scope = component.select("frontend")
    cfg = FrontendConfig(
        sample_rate=int(scope.param("sample-rate", 16000)),
        frame_length_ms=float(scope.param("frame-length-ms", 25.0)),
        frame_shift_ms=float(scope.param("frame-shift-ms", 10.0)),
        preemphasis=float(scope.param("preemphasis", 1.0)),
        window=scope.param("window", "hamming"),
        num_mel=int(scope.param("num-mel", 20)),
        num_cepstra=int(scope.param("num-cepstra", 16)),
        normalize=scope.param("normalize", "segment"),
        cep_lifter=float(scope.param("cep-lifter", 0.0)),
        append_energy=str(scope.param("append-energy", "false")).lower() == "true",
    )
    lda_file = scope.param("lda-file", "")
    lda = np.load(lda_file) if lda_file else None
    kwargs = dict(
        splice_context=int(scope.param("splice", 0)),
        lda=lda,
        delta_order=int(scope.param("delta-order", 0)),
    )
    return cfg, kwargs


def frontend_from_config(component, vtln_warp=None) -> FeatureFrontend:
    """Build a FeatureFrontend from a component's ``frontend`` scope."""
    cfg, kwargs = frontend_spec_from_config(component)
    return FeatureFrontend(cfg, vtln_warp=vtln_warp, **kwargs)


class FeatureExtractionTool(Application):
    name = "feature-extraction"
    description = "extract features over a corpus into a cache archive"

    corpus_file = ParameterString("corpus-file")
    audio_dir = ParameterString("audio-dir", default="")
    cache = ParameterString("cache", default="features.cache")
    batch_size = ParameterInt("batch-size", default=8)
    partition = ParameterInt("partition", default=0)
    num_partitions = ParameterInt("num-partitions", default=1)
    overwrite = ParameterBool("overwrite", default=False)
    #: per-speaker VTLN warping factors (JSON {speaker: alpha}, from the
    #: acoustic-model-trainer's estimate-vtln action; key "*" = default).
    #: Segments extract through a frontend whose mel filterbank carries
    #: their speaker's piecewise-linear warp (ref: Signal::Warping).
    vtln_warp_file = ParameterString("vtln-warp-file", default="")
    #: per-speaker fMLLR transforms (JSON {speaker: W}, from the
    #: acoustic-model-trainer's estimate-fmllr action): write ADAPTED
    #: feature caches (the SAT data path; ref: MODULE_ADAPT)
    fmllr_file = ParameterString("fmllr-file", default="")

    def _transforms(self):
        if not self.fmllr_file:
            return None
        from ..train.fmllr import load_transforms

        return load_transforms(self.fmllr_file)

    def run(self, args: List[str]) -> int:
        corpus = CorpusDescription.load(self.corpus_file, audio_dir=self.audio_dir)
        if self.vtln_warp_file:
            import json

            from ..ops.gammatone import piecewise_linear_warp

            with open(self.vtln_warp_file) as fh:
                table = {k: float(v) for k, v in json.load(fh).items()}
            default = table.get("*", 1.0)
            groups: dict = {}
            for seg in corpus.segments(self.partition, self.num_partitions):
                alpha = table.get(seg.speaker or "", default)
                groups.setdefault(alpha, []).append(seg.full_name)
            cfg, kwargs = frontend_spec_from_config(self)
            transforms = self._transforms()
            written = 0
            for alpha in sorted(groups):
                warp = (
                    None if alpha == 1.0
                    else piecewise_linear_warp(cfg.num_bins, alpha)
                )
                fe = FeatureFrontend(cfg, vtln_warp=warp, **kwargs)
                visitor = CorpusVisitor(
                    corpus, self.batch_size, self.partition,
                    self.num_partitions, segment_list=groups[alpha],
                )
                written += FeatureExtractor(
                    fe, self.cache, feature_transforms=transforms
                ).run(visitor, overwrite=self.overwrite)
                self.log("vtln group", alpha=alpha, segments=len(groups[alpha]))
            self.log("done", segments_written=written, cache=self.cache)
            return 0
        frontend = frontend_from_config(self)
        visitor = CorpusVisitor(
            corpus, self.batch_size, self.partition, self.num_partitions
        )
        extractor = FeatureExtractor(
            frontend, self.cache, feature_transforms=self._transforms()
        )
        written = extractor.run(visitor, overwrite=self.overwrite)
        self.log("done", segments_written=written, cache=self.cache)
        return 0


if __name__ == "__main__":
    raise SystemExit(FeatureExtractionTool.main())
