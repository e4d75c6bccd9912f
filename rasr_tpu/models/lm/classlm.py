"""Class-based and log-linear-combination language models.

Batched re-design of the reference's remaining LM variants
(ref: src/Lm/ — Lm::ClassLm [K?] maps words onto classes and scores
P(w|h) = P(class(w) | class-history) * P(w | class(w)); Lm::CombineLm
[K?] combines several LMs log-linearly with per-LM weights).

Both follow the host-side history API (interface.LanguageModel); the
class LM additionally composes with the n-gram device compiler: since
class(w) is a static map, a class n-gram compiles into the same
integer-automaton tables as a word n-gram with the membership cost
folded into each word's arc — so the decoder needs no new machinery
(models/lm/ngram_tpu.py consumes the expanded word-level view).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

from .interface import History, LanguageModel


class ClassLm(LanguageModel):
    """P(w|h) = P_cls(c(w) | c(h)) + (-log) P(w | c(w)).

    ``class_lm`` is any LanguageModel over the class vocabulary;
    ``word_to_class`` maps word tokens to class tokens; ``membership``
    gives -log P(word | class) (defaults to uniform within class).
    """

    def __init__(
        self,
        class_lm: LanguageModel,
        vocab: Dict[str, int],
        word_to_class: Dict[str, str],
        membership: Dict[str, float] | None = None,
    ):
        self.class_lm = class_lm
        self.vocab = dict(vocab)
        self._id_to_word = {i: w for w, i in self.vocab.items()}
        self.word_to_class = dict(word_to_class)
        # default: uniform membership within each class
        if membership is None:
            sizes: Dict[str, int] = {}
            for w, c in word_to_class.items():
                sizes[c] = sizes.get(c, 0) + 1
            membership = {
                w: math.log(max(sizes[c], 1)) for w, c in word_to_class.items()
            }
        self.membership = membership

    def _class_id(self, word_id: int) -> int:
        w = self._id_to_word.get(word_id, "<unk>")
        c = self.word_to_class.get(w, w)
        return self.class_lm.word_id(c)

    def start_history(self) -> History:
        return self.class_lm.start_history()

    def extended_history(self, history: History, word: int) -> History:
        return self.class_lm.extended_history(history, self._class_id(word))

    def score(self, history: History, word: int) -> float:
        w = self._id_to_word.get(word, "<unk>")
        member = self.membership.get(w, 0.0)
        return self.class_lm.score(history, self._class_id(word)) + member

    def sentence_end_score(self, history: History) -> float:
        return self.class_lm.sentence_end_score(history)

    # ------------------------------------------------ device compilation
    def compile_to_device(self, max_probe: int = 16):
        """Compile into decoder-consumable NgramTables (ngram_tpu).

        The automaton's STATES are class contexts (exactly the
        reference's class-LM state space); TRANSITIONS are keyed by
        word id with cost = class-ngram cost + membership(word) and
        target = the class-extended context — so the decoder's generic
        ``lookup(tables, state, word)`` needs no new machinery.
        Requires an NgramLm class LM.
        """
        import numpy as np

        from .arpa import NgramLm
        from .ngram_tpu import build_tables

        cl = self.class_lm
        if not isinstance(cl, NgramLm):
            raise TypeError("compile_to_device needs an NgramLm class LM")
        order = cl.order
        contexts = [()] + sorted(g for g in cl.ngrams if len(g) < order)
        state_id = {g: i for i, g in enumerate(contexts)}

        def ctx_state(g):
            while g not in state_id:
                g = g[1:]
            return state_id[g]

        S = len(contexts)
        backoff_cost = np.zeros(S, np.float32)
        backoff_state = np.zeros(S, np.int32)
        for g, i in state_id.items():
            if g:
                backoff_cost[i] = cl.ngrams[g][1]
                backoff_state[i] = ctx_state(g[1:])

        cls_words: Dict[int, List[str]] = {}
        for w in self.vocab:
            cid = cl.word_id(self.word_to_class.get(w, w))
            cls_words.setdefault(cid, []).append(w)

        entries = []
        for gram, (cost, _bo) in cl.ngrams.items():
            h, c = gram[:-1], gram[-1]
            if h not in state_id:
                continue
            nxt = ctx_state(gram[-(order - 1):]) if order > 1 else 0
            for w in cls_words.get(c, []):
                entries.append(
                    (state_id[h], self.vocab[w],
                     cost + self.membership.get(w, 0.0), nxt)
                )

        bos_cls = cl.vocab.get(self.word_to_class.get("<s>", "<s>"))
        start = state_id.get((bos_cls,), 0) if bos_cls is not None else 0
        return build_tables(
            entries,
            backoff_cost,
            backoff_state,
            order=order,
            start_state=start,
            end_word=self.vocab.get("</s>", -1),
            unk_word=self.vocab.get("<unk>", -1),
            max_probe=max_probe,
        )


class CombineLm(LanguageModel):
    """Log-linear combination: score = sum_i w_i * score_i
    (ref: Lm::CombineLm — per-LM scales, shared vocabulary)."""

    def __init__(self, lms: Sequence[LanguageModel], weights: Sequence[float]):
        if len(lms) != len(weights) or not lms:
            raise ValueError("need equal, nonzero numbers of lms and weights")
        self.lms = list(lms)
        self.weights = [float(w) for w in weights]
        self.vocab = dict(lms[0].vocab)

    def start_history(self) -> History:
        return tuple(lm.start_history() for lm in self.lms)

    def extended_history(self, history: History, word: int) -> History:
        return tuple(
            lm.extended_history(h, lm.word_id(self._tok(word)))
            for lm, h in zip(self.lms, history)
        )

    def _tok(self, word_id: int) -> str:
        for tok, i in self.vocab.items():
            if i == word_id:
                return tok
        return "<unk>"

    def score(self, history: History, word: int) -> float:
        tok = self._tok(word)
        return sum(
            w * lm.score(h, lm.word_id(tok))
            for lm, w, h in zip(self.lms, self.weights, history)
        )

    def sentence_end_score(self, history: History) -> float:
        return sum(
            w * lm.sentence_end_score(h)
            for lm, w, h in zip(self.lms, self.weights, history)
        )
