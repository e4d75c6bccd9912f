"""Acoustic lattice rescoring (ref: src/Tools/LatticeProcessor/ +
src/Speech/LatticeExtractor — the legacy lattice-processor's core use:
replace each lattice arc's acoustic score by re-aligning the arc's word
over its time span under a (new) acoustic model; the workhorse of
old-style AM rescoring and discriminative-training lattice preparation).

Batched formulation: every arc becomes one row of a single batched banded-
Viterbi call (ops/viterbi.py) — arcs' linear alignment graphs are padded
to a common state count and frame span, so the whole lattice re-scores
in ONE device dispatch instead of a per-arc loop (the same batching the
lattice-based EBW accumulation uses, train/discriminative.py).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Optional

import jax.numpy as jnp
import numpy as np

from ..align.graph import OrthographyError, build_linear_graph, orth_to_lemmas
from ..corpus.lexicon import Lexicon
from ..models.hmm import HmmTopology, TransitionModel
from ..ops.viterbi import BIG, viterbi_align
from .lattice import Lattice


def rescore_am(
    lattice: Lattice,
    emissions: np.ndarray,  # [T, M] -log acoustic scores (scaled)
    lexicon: Lexicon,
    tying,
    topology: HmmTopology = HmmTopology(),
    transitions: TransitionModel = TransitionModel(),
) -> Lattice:
    """Return a lattice whose word arcs carry re-aligned acoustic scores.

    Per word arc (lemma, [t_from, t_to)): each of the lemma's
    pronunciations is compiled to a linear alignment graph (no optional
    silence — the lattice's own silence arcs carry silence) and
    Viterbi-aligned over ``emissions[t_from:t_to]``; the arc's
    ``am_score`` becomes the MIN cost over its pronunciation variants
    (lattice arcs carry no pronunciation index, and the reference's
    LatticeExtractor re-aligns the pronunciation the path realized —
    the best-variant cost is the faithful lower envelope; all variants
    batch into the same single viterbi_align call). Arcs whose span
    cannot realize the word (span shorter than the graph's minimum
    path) or whose orthography is not in the lexicon get BIG — they are
    impossible under the new model and vanish from best paths. Epsilon
    arcs keep am 0. LM scores are untouched (rescore_lm exists for
    those).
    """
    T_avail = int(np.asarray(emissions).shape[0])
    used = [a.to_node for a in lattice.arcs] + [a.from_node for a in lattice.arcs]
    if used:
        t_max = int(np.asarray(lattice.node_time)[used].max())
        if t_max > T_avail:
            raise ValueError(
                f"lattice node times reach frame {t_max} but the feature/"
                f"emission stream has only {T_avail} frames — the feature "
                "cache does not match the lattice (different frontend hop?)"
            )
    spans, graphs, arc_ids = [], [], []
    new_arcs = [dataclasses.replace(a) for a in lattice.arcs]
    for ai, arc in enumerate(lattice.arcs):
        if arc.lemma < 0:
            new_arcs[ai].am_score = 0.0
            continue
        orth = lattice.lemma_orths[arc.lemma]
        lo = int(lattice.node_time[arc.from_node])
        hi = int(lattice.node_time[arc.to_node])
        if hi <= lo:
            new_arcs[ai].am_score = BIG
            continue
        try:
            # one graph per pronunciation-variant COMBINATION (min taken
            # after the batched DP): multi-token orths enumerate the
            # per-lemma variant cross product (capped; beyond the cap a
            # clamped diagonal sweep is a documented approximation),
            # which reduces to the plain per-pronunciation sweep for the
            # single-word arcs decoders emit
            counts = [
                max(len(l.pronunciations), 1)
                for l in orth_to_lemmas(orth, lexicon, allow_unknown=False)
            ]
            n_prod = 1
            for c in counts:
                n_prod *= c
            if n_prod <= 256:
                combos = list(itertools.product(*[range(c) for c in counts]))
            else:  # pathological arc: diagonal sweep (variant i everywhere)
                combos = [(vi,) * len(counts) for vi in range(max(counts))]
            for combo in combos:
                g = build_linear_graph(
                    orth, lexicon, tying, topology, transitions,
                    optional_silence=False,
                    pronunciation_index=list(combo),
                    allow_unknown=False,
                )
                spans.append((lo, hi))
                graphs.append(g)
                arc_ids.append(ai)
        except OrthographyError:
            new_arcs[ai].am_score = BIG
            continue
    if not graphs:
        return Lattice(
            num_nodes=lattice.num_nodes, arcs=new_arcs,
            node_time=lattice.node_time,
            final_scores=dict(lattice.final_scores),
            lemma_orths=list(lattice.lemma_orths),
        )

    N = len(graphs)
    S = max(g.num_states for g in graphs)
    T = max(hi - lo for lo, hi in spans)
    emis = np.zeros((N, T, S), np.float32)
    loop = np.full((N, S), BIG, np.float32)
    fwd = np.full((N, S), BIG, np.float32)
    skip = np.full((N, S), BIG, np.float32)
    init = np.full((N, S), BIG, np.float32)
    final = np.full((N, S), BIG, np.float32)
    n_frames = np.zeros(N, np.int32)
    for i, (g, (lo, hi)) in enumerate(zip(graphs, spans)):
        n = g.num_states
        emis[i, : hi - lo, :n] = emissions[lo:hi][:, g.emission_ids]
        loop[i, :n] = g.loop
        fwd[i, :n] = g.fwd
        skip[i, :n] = g.skip
        init[i, :n] = g.init
        final[i, :n] = g.final
        n_frames[i] = hi - lo
    cost, _ = viterbi_align(
        jnp.asarray(emis), jnp.asarray(loop), jnp.asarray(fwd),
        jnp.asarray(skip), jnp.asarray(init), jnp.asarray(final),
        jnp.asarray(n_frames),
    )
    cost = np.asarray(cost)
    for ai in set(arc_ids):
        new_arcs[ai].am_score = BIG
    for i, ai in enumerate(arc_ids):
        c = float(cost[i])
        new_arcs[ai].am_score = min(
            new_arcs[ai].am_score, c if c < BIG / 2 else BIG
        )
    return Lattice(
        num_nodes=lattice.num_nodes, arcs=new_arcs,
        node_time=lattice.node_time,
        final_scores=dict(lattice.final_scores),
        lemma_orths=list(lattice.lemma_orths),
    )
