"""Lattice processing: best/n-best, posteriors, pruning, rescoring, CN.

Re-implements the core of the reference's FLF lattice toolkit
(ref: src/Flf/ — Best.cc, Prune.cc, FwdBwd.cc, Rescore.cc, Compose.cc,
ConfusionNetwork*.cc, NBest [K]): config-driven networks of lattice
processors there; direct functions over :class:`Lattice` here (the
pipeline drivers compose them). Scores are -log costs with separate
am/lm dimensions and per-call scales, matching the reference's multi-
dimensional semiring with per-dim scales.

All algorithms are host-side numpy/python: lattices are small (hundreds
of arcs); the accelerator is for the frame-synchronous stages.
"""

from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .lattice import BIG, Lattice, LatticeArc


def _arc_score(a: LatticeArc, am_scale: float, lm_scale: float) -> float:
    return am_scale * a.am_score + lm_scale * a.lm_score


# ------------------------------------------------------------------ best path
def best_path(
    lat: Lattice, am_scale: float = 1.0, lm_scale: float = 1.0
) -> Tuple[float, List[LatticeArc]]:
    """Min-cost path (ref: Flf::Best, SSSP over the tropical semiring)."""
    order = lat.topological_order()
    dist = np.full(lat.num_nodes, BIG)
    back: List[Optional[int]] = [None] * lat.num_nodes
    dist[0] = 0.0
    out = lat.out_arcs()
    for n in order:
        if dist[n] >= BIG / 2:
            continue
        for ai in out[n]:
            a = lat.arcs[ai]
            nd = dist[n] + _arc_score(a, am_scale, lm_scale)
            if nd < dist[a.to_node]:
                dist[a.to_node] = nd
                back[a.to_node] = ai
    best = (BIG, None)
    for node, final in lat.final_scores.items():
        total = dist[node] + final
        if total < best[0]:
            best = (total, node)
    if best[1] is None:
        return BIG, []
    path = []
    node = best[1]
    while back[node] is not None:
        a = lat.arcs[back[node]]
        path.append(a)
        node = a.from_node
    path.reverse()
    return float(best[0]), path


def n_best(
    lat: Lattice, n: int, am_scale: float = 1.0, lm_scale: float = 1.0
) -> List[Tuple[float, List[LatticeArc]]]:
    """N shortest distinct paths (ref: Flf n-best extraction)."""
    out = lat.out_arcs()
    results: List[Tuple[float, List[LatticeArc]]] = []
    seen: set = set()
    # uniform-cost search over (cost, node, path)
    counter = 0
    heap = [(0.0, counter, 0, [])]
    while heap and len(results) < n:
        cost, _, node, path = heapq.heappop(heap)
        if node in lat.final_scores:
            total = cost + lat.final_scores[node]
            key = tuple(a.lemma for a in path)
            if key not in seen:
                seen.add(key)
                results.append((total, path))
        for ai in out[node]:
            a = lat.arcs[ai]
            counter += 1
            heapq.heappush(
                heap,
                (cost + _arc_score(a, am_scale, lm_scale), counter, a.to_node, path + [a]),
            )
    return results


# ----------------------------------------------------------- forward-backward
def forward_backward(
    lat: Lattice, am_scale: float = 1.0, lm_scale: float = 1.0
) -> Tuple[float, np.ndarray]:
    """Arc posteriors (ref: Flf::FwdBwd).

    Returns (total -log mass, arc posterior p in [0,1] per arc)."""
    order = lat.topological_order()
    out = lat.out_arcs()
    inn = lat.in_arcs()

    def nlse(a, b):
        m = min(a, b)
        if m >= BIG / 2:
            return BIG
        return m - math.log1p(math.exp(-(max(a, b) - m)))

    alpha = np.full(lat.num_nodes, BIG)
    alpha[0] = 0.0
    for node in order:
        if alpha[node] >= BIG / 2:
            continue
        for ai in out[node]:
            a = lat.arcs[ai]
            alpha[a.to_node] = nlse(
                alpha[a.to_node], alpha[node] + _arc_score(a, am_scale, lm_scale)
            )
    beta = np.full(lat.num_nodes, BIG)
    for node, final in lat.final_scores.items():
        beta[node] = final
    for node in reversed(order):
        for ai in out[node]:
            a = lat.arcs[ai]
            if beta[a.to_node] < BIG / 2:
                beta[node] = nlse(
                    beta[node], _arc_score(a, am_scale, lm_scale) + beta[a.to_node]
                )
    total = BIG
    for node, final in lat.final_scores.items():
        total = nlse(total, alpha[node] + final)
    post = np.zeros(len(lat.arcs))
    for ai, a in enumerate(lat.arcs):
        c = alpha[a.from_node] + _arc_score(a, am_scale, lm_scale) + beta[a.to_node]
        post[ai] = math.exp(-(c - total)) if c < BIG / 2 else 0.0
    return float(total), post


def posterior_prune(
    lat: Lattice, threshold: float, am_scale: float = 1.0, lm_scale: float = 1.0
) -> Lattice:
    """Drop arcs with posterior < exp(-threshold) (ref: Flf::Prune fwd/bwd
    pruning). Keeps at least the best path."""
    total, post = forward_backward(lat, am_scale, lm_scale)
    _, best = best_path(lat, am_scale, lm_scale)
    keep_arcs = set(id(a) for a in best)
    arcs = [
        a
        for ai, a in enumerate(lat.arcs)
        if post[ai] >= math.exp(-threshold) or id(a) in keep_arcs
    ]
    return _trim(
        Lattice(
            lat.num_nodes, arcs, lat.node_time.copy(), dict(lat.final_scores),
            list(lat.lemma_orths),
        )
    )


def _trim(lat: Lattice) -> Lattice:
    """Remove unreachable/non-coaccessible nodes, renumber."""
    out = lat.out_arcs()
    reach = np.zeros(lat.num_nodes, bool)
    stack = [0]
    while stack:
        n = stack.pop()
        if reach[n]:
            continue
        reach[n] = True
        for ai in out[n]:
            stack.append(lat.arcs[ai].to_node)
    co = np.zeros(lat.num_nodes, bool)
    inn = lat.in_arcs()
    stack = [n for n in lat.final_scores if reach[n]]
    for n in stack:
        co[n] = True
    while stack:
        n = stack.pop()
        for ai in inn[n]:
            f = lat.arcs[ai].from_node
            if not co[f] and reach[f]:
                co[f] = True
                stack.append(f)
    keep = reach & co
    keep[0] = True
    remap = -np.ones(lat.num_nodes, np.int64)
    remap[keep] = np.arange(keep.sum())
    arcs = [
        LatticeArc(int(remap[a.from_node]), int(remap[a.to_node]), a.lemma, a.am_score, a.lm_score)
        for a in lat.arcs
        if keep[a.from_node] and keep[a.to_node]
    ]
    return Lattice(
        int(keep.sum()),
        arcs,
        lat.node_time[keep],
        {int(remap[n]): s for n, s in lat.final_scores.items() if keep[n]},
        list(lat.lemma_orths),
    )


# --------------------------------------------------------------- LM rescoring
def rescore_lm(
    lat: Lattice,
    lm,
    lemma_synt: Dict[int, Optional[int]],
    keep_old: bool = False,
) -> Lattice:
    """Replace the lm score dimension with a (different) LM
    (ref: Flf compose-with-LM / rescore — the lattice expands so every
    path carries exact LM context: nodes become (node, lm history)).

    lemma_synt: lattice lemma index -> LM word id (None = no-LM word).
    """
    out = lat.out_arcs()
    # expanded nodes: (lattice node, history) -> new id
    node_map: Dict[Tuple[int, Tuple[int, ...]], int] = {}
    new_time: List[int] = []
    new_final: Dict[int, float] = {}
    arcs: List[LatticeArc] = []

    def get_node(n: int, h: Tuple[int, ...]) -> int:
        key = (n, h)
        if key not in node_map:
            node_map[key] = len(new_time)
            new_time.append(int(lat.node_time[n]))
        return node_map[key]

    start = get_node(0, lm.start_history())
    stack = [(0, lm.start_history())]
    seen = {(0, lm.start_history())}
    while stack:
        n, h = stack.pop()
        src = get_node(n, h)
        if n in lat.final_scores:
            end = lm.sentence_end_score(h)
            if keep_old:
                end += lat.final_scores[n]
            new_final[src] = min(new_final.get(src, BIG), end)
        for ai in out[n]:
            a = lat.arcs[ai]
            wid = lemma_synt.get(a.lemma)
            if wid is None:
                nh = h
                lm_score = 0.0
            else:
                lm_score = lm.score(h, wid)
                nh = lm.extended_history(h, wid)
            dst = get_node(a.to_node, nh)
            old = a.lm_score if keep_old else 0.0
            arcs.append(LatticeArc(src, dst, a.lemma, a.am_score, old + lm_score))
            if (a.to_node, nh) not in seen:
                seen.add((a.to_node, nh))
                stack.append((a.to_node, nh))
    return Lattice(len(new_time), arcs, np.asarray(new_time, np.int32), new_final, list(lat.lemma_orths))


# --------------------------------------------------------- confusion networks
@dataclasses.dataclass
class ConfusionSlot:
    start: int
    end: int
    hypotheses: List[Tuple[str, float]]  # (orth or "", posterior), sorted desc

    @property
    def best(self) -> Tuple[str, float]:
        return self.hypotheses[0]


def _node_bitsets(lat: Lattice):
    """Per-node descendant and ancestor bitsets (node n included in its
    own sets): the precedence oracle for arc clustering. O(N^2/64)
    words — lattices here are hundreds-to-thousands of nodes."""
    N = lat.num_nodes
    W = (N + 63) // 64
    desc = np.zeros((N, W), np.uint64)
    anc = np.zeros((N, W), np.uint64)
    idx = np.arange(N)
    desc[idx, idx >> 6] |= np.uint64(1) << (idx & 63).astype(np.uint64)
    anc[idx, idx >> 6] |= np.uint64(1) << (idx & 63).astype(np.uint64)
    order = lat.topological_order()
    out = lat.out_arcs()
    for n in reversed(order):
        for ai in out[n]:
            desc[n] |= desc[lat.arcs[ai].to_node]
    for n in order:
        for ai in out[n]:
            anc[lat.arcs[ai].to_node] |= anc[n]
    return desc, anc


def confusion_network(
    lat: Lattice,
    am_scale: float = 1.0,
    lm_scale: float = 1.0,
    return_assignment: bool = False,
):
    """Arc-cluster (pivot) CN construction with topological ordering
    constraints (ref: src/Flf/ConfusionNetwork*.cc — the pivot
    arc-cluster algorithm).

    The best path seeds the slot sequence; the remaining arcs join
    slots in descending posterior order, where each arc may only join a
    slot STRICTLY AFTER every assigned arc that precedes it in the
    lattice and STRICTLY BEFORE every assigned arc it precedes (so two
    arcs on one path can never share a slot, and the slot order is a
    linear extension of the lattice's partial order). An arc whose
    admissible window holds no time-overlapping slot SPLITS the
    network: a fresh slot is inserted at the time-appropriate position
    inside the window. Every slot closes with the epsilon (skip) mass
    1 - sum(hyp posteriors).

    ``return_assignment=True`` additionally returns {arc index -> slot
    index} for the arcs carrying posterior mass."""
    total, post = forward_backward(lat, am_scale, lm_scale)
    _, pivot = best_path(lat, am_scale, lm_scale)
    if not pivot:
        return ([], {}) if return_assignment else []
    assign: Dict[int, int] = {}
    desc, anc = _node_bitsets(lat)
    W = desc.shape[1]

    # slot state: hypothesis mass, time span, and from/to node bitsets
    # (the per-slot aggregates the precedence checks run against)
    sl_hyp: List[Dict[str, float]] = []
    sl_span: List[Tuple[int, int]] = []
    sl_from = np.zeros((0, W), np.uint64)
    sl_to = np.zeros((0, W), np.uint64)

    def bit(n: int):
        v = np.zeros(W, np.uint64)
        v[n >> 6] |= np.uint64(1) << np.uint64(n & 63)
        return v

    def insert_slot(k: int, span: Tuple[int, int]):
        nonlocal sl_from, sl_to
        sl_hyp.insert(k, {})
        sl_span.insert(k, span)
        sl_from = np.insert(sl_from, k, np.zeros(W, np.uint64), axis=0)
        sl_to = np.insert(sl_to, k, np.zeros(W, np.uint64), axis=0)

    def add_arc(k: int, a: LatticeArc, p: float):
        nonlocal sl_from, sl_to
        orth = lat.lemma_orths[a.lemma] if a.lemma >= 0 else ""
        sl_hyp[k][orth] = sl_hyp[k].get(orth, 0.0) + p
        sl_from[k] |= bit(a.from_node)
        sl_to[k] |= bit(a.to_node)
        s, e = int(lat.node_time[a.from_node]), int(lat.node_time[a.to_node])
        s0, e0 = sl_span[k]
        sl_span[k] = (min(s0, s), max(e0, e))

    # seed one slot per pivot arc (bitsets + spans up front, so every
    # precedence window is constrained by the full pivot; the arcs'
    # posterior mass joins in the main pass)
    for k, a in enumerate(pivot):
        insert_slot(
            k, (int(lat.node_time[a.from_node]), int(lat.node_time[a.to_node]))
        )
        add_arc(k, a, 0.0)

    def overlap(s1, e1, s2, e2):
        inter = max(0, min(e1, e2) - max(s1, s2))
        denom = max(1, min(e1 - s1, e2 - s2))
        return inter / denom

    # descending posterior, pivot arcs pinned to their seeded slots
    arc_order = sorted(
        (ai for ai in range(len(lat.arcs)) if post[ai] > 0.0),
        key=lambda ai: -post[ai],
    )
    pivot_slot = {id(a): k for k, a in enumerate(pivot)}
    for ai in arc_order:
        a = lat.arcs[ai]
        if id(a) in pivot_slot:
            add_arc(pivot_slot[id(a)], a, float(post[ai]))
            assign[ai] = pivot_slot[id(a)]
            continue
        # admissible window [lo, hi]: a slot arc b precedes a iff
        # b.to_node is an ancestor of (or equals) a.from_node; a
        # precedes b iff b.from_node is a descendant of (or equals)
        # a.to_node
        a_anc = anc[a.from_node]
        a_desc = desc[a.to_node]
        prec = np.any(sl_to & a_anc[None, :], axis=1)
        succ = np.any(sl_from & a_desc[None, :], axis=1)
        lo = int(np.flatnonzero(prec).max()) + 1 if prec.any() else 0
        hi = int(np.flatnonzero(succ).min()) - 1 if succ.any() else len(sl_hyp) - 1
        s, e = int(lat.node_time[a.from_node]), int(lat.node_time[a.to_node])
        best_k, best_ov = -1, 0.0
        for k in range(lo, min(hi, len(sl_hyp) - 1) + 1):
            ov = overlap(s, e, *sl_span[k])
            if ov > best_ov:
                best_k, best_ov = k, ov
        if best_k < 0:
            # no admissible overlapping slot: split — insert a fresh
            # slot at the time-appropriate position inside the window
            k = lo
            while k <= min(hi, len(sl_hyp) - 1) and sl_span[k][0] < s:
                k += 1
            insert_slot(k, (s, e))
            pivot_slot = {
                ida: (sk if sk < k else sk + 1) for ida, sk in pivot_slot.items()
            }
            assign = {ia: (sk if sk < k else sk + 1) for ia, sk in assign.items()}
            best_k = k
        add_arc(best_k, a, float(post[ai]))
        assign[ai] = best_k

    out = []
    for k, d in enumerate(sl_hyp):
        d = {o: m for o, m in d.items() if m > 0.0}  # drop seed-only keys
        mass = sum(d.values())
        if mass < 1.0:
            d[""] = d.get("", 0.0) + (1.0 - mass)  # epsilon/deletion mass
        hyps = sorted(d.items(), key=lambda kv: -kv[1])
        out.append(ConfusionSlot(sl_span[k][0], sl_span[k][1], hyps))
    return (out, assign) if return_assignment else out


def cn_decode(slots: Sequence[ConfusionSlot]) -> List[str]:
    """MAP decoding over the CN (ref: Flf CN/MAP decoding): per-slot
    posterior argmax, skipping slots the epsilon hypothesis wins. Slot
    order is a linear extension of the lattice order (see
    confusion_network), so the output word order is path-consistent."""
    words = []
    for slot in slots:
        w, p = slot.best
        if w:
            words.append(w)
    return words


def fcn_decode(
    frames: Sequence[Dict[str, float]], threshold: float = 0.0
) -> List[str]:
    """Min-fWER decoding over the time-frame CN (ref: the reference's
    min-fWER / time-frame error decoder on the fCN): per frame take the
    posterior argmax (epsilon wins frames where no word reaches
    ``threshold``), then collapse consecutive same-word runs; epsilon
    frames terminate runs. Minimizes the expected FRAME-level word
    error under the lattice posterior by construction."""
    out: List[str] = []
    prev = ""
    for d in frames:
        w, p = "", 0.0
        for orth, q in d.items():
            if q > p:
                w, p = orth, q
        if w and p < threshold:
            w = ""
        if w and w != prev:
            out.append(w)
        prev = w
    return out


# ------------------------------------------------------- time-frame CN


def time_frame_cn(
    lat: Lattice, am_scale: float = 1.0, lm_scale: float = 1.0
) -> List[Dict[str, float]]:
    """Time-frame confusion network (ref: Flf time-frame CN — per-FRAME
    word posterior distributions; the basis of min-fWER decoding and
    frame-level confidence).

    Returns one dict {orth: posterior} per frame; "" collects epsilon
    (silence/no-word) mass. Each arc spreads its posterior uniformly
    over the frames it covers.
    """
    _, post = forward_backward(lat, am_scale, lm_scale)
    T = int(lat.node_time.max()) if lat.num_nodes else 0
    frames: List[Dict[str, float]] = [dict() for _ in range(T)]
    for ai, a in enumerate(lat.arcs):
        if post[ai] <= 0.0:
            continue
        s, e = int(lat.node_time[a.from_node]), int(lat.node_time[a.to_node])
        orth = lat.lemma_orths[a.lemma] if a.lemma >= 0 else ""
        for t in range(max(s, 0), min(e, T)):
            frames[t][orth] = frames[t].get(orth, 0.0) + post[ai]
    for d in frames:
        mass = sum(d.values())
        if mass < 1.0:
            d[""] = d.get("", 0.0) + (1.0 - mass)
    return frames


def word_confidence(
    lat: Lattice,
    am_scale: float = 1.0,
    lm_scale: float = 1.0,
) -> List[Tuple[str, float]]:
    """Frame-CN confidence for the best path's words (ref: the
    fCN-confidence used by the reference's CN tooling): each best-path
    word's confidence = mean over its frames of that word's frame
    posterior."""
    frames = time_frame_cn(lat, am_scale, lm_scale)
    _, best = best_path(lat, am_scale, lm_scale)
    out: List[Tuple[str, float]] = []
    for a in best:
        if a.lemma < 0:
            continue
        orth = lat.lemma_orths[a.lemma]
        s, e = int(lat.node_time[a.from_node]), int(lat.node_time[a.to_node])
        span = [frames[t].get(orth, 0.0) for t in range(max(s, 0), min(e, len(frames)))]
        conf = float(np.mean(span)) if span else 0.0
        out.append((orth, conf))
    return out


# --------------------------------------------------- structural lattice ops
def scale_scores(lat: Lattice, am_scale: float, lm_scale: float) -> Lattice:
    """Semiring rescale (ref: Flf semiring rescale nodes): bake the
    per-dimension scales into the score dims so downstream consumers can
    run with unit scales. Final scores are already in the total
    dimension (the decoder emits them pre-scaled — see
    search/decoder._best_and_records) and pass through unchanged."""
    arcs = [
        LatticeArc(a.from_node, a.to_node, a.lemma,
                   am_scale * a.am_score, lm_scale * a.lm_score)
        for a in lat.arcs
    ]
    return Lattice(lat.num_nodes, arcs, lat.node_time.copy(),
                   dict(lat.final_scores), list(lat.lemma_orths))


def map_lemmas(lat: Lattice, orth_map: Dict[str, str]) -> Lattice:
    """Alphabet mapping (ref: Flf map-alphabet nodes): rewrite arc
    labels through an orthography map; unmapped orths pass through.
    Lemmas merging onto the same orth share one output label."""
    new_orths: List[str] = []
    index: Dict[str, int] = {}
    remap: List[int] = []
    for orth in lat.lemma_orths:
        target = orth_map.get(orth, orth)
        if target not in index:
            index[target] = len(new_orths)
            new_orths.append(target)
        remap.append(index[target])
    arcs = [
        LatticeArc(a.from_node, a.to_node,
                   remap[a.lemma] if a.lemma >= 0 else -1,
                   a.am_score, a.lm_score)
        for a in lat.arcs
    ]
    return Lattice(lat.num_nodes, arcs, lat.node_time.copy(),
                   dict(lat.final_scores), new_orths)


def union(lats: Sequence[Lattice]) -> Lattice:
    """Lattice union (ref: Flf union node — e.g. system combination
    before CN decoding): a fresh initial node epsilon-branches into each
    input's initial node; alphabets merge by orthography."""
    assert lats, "union of nothing"
    new_orths: List[str] = []
    index: Dict[str, int] = {}
    arcs: List[LatticeArc] = []
    finals: Dict[int, float] = {}
    times: List[int] = [0]
    offset = 1
    for lat in lats:
        remap = []
        for orth in lat.lemma_orths:
            if orth not in index:
                index[orth] = len(new_orths)
                new_orths.append(orth)
            remap.append(index[orth])
        times.extend(int(t) for t in lat.node_time)
        arcs.append(LatticeArc(0, offset, -1, 0.0, 0.0))  # eps entry
        for a in lat.arcs:
            arcs.append(
                LatticeArc(offset + a.from_node, offset + a.to_node,
                           remap[a.lemma] if a.lemma >= 0 else -1,
                           a.am_score, a.lm_score)
            )
        for n, s in lat.final_scores.items():
            node = offset + n
            finals[node] = min(finals.get(node, BIG), float(s))
        offset += lat.num_nodes
    return Lattice(offset, arcs, np.asarray(times, np.int32), finals, new_orths)


def intersect(a: Lattice, b: Lattice) -> Lattice:
    """Lattice intersection (ref: Flf intersect node): keep exactly the
    word sequences present in BOTH lattices, with per-dimension scores
    added — the lattice-level counterpart of acceptor composition
    (fsa/algorithms.compose). Words match by orthography, so the inputs
    may use different lemma alphabets (e.g. lattices from two systems).

    Epsilon arcs (lemma < 0) advance one side at a time through the
    standard three-state epsilon-sequencing filter (Mohri's composition
    filter), so no path is generated twice. Node times come from ``a``
    (``b``'s boundaries may disagree; ``a`` is the primary system).
    """
    orth_to_b: Dict[str, List[int]] = {}
    for i, orth in enumerate(b.lemma_orths):
        orth_to_b.setdefault(orth, []).append(i)
    out_a, out_b = a.out_arcs(), b.out_arcs()

    # product states (node_a, node_b, filter); filter: 0 = free,
    # 1 = only eps-on-a may continue, 2 = only eps-on-b may continue.
    node_map: Dict[Tuple[int, int, int], int] = {}
    times: List[int] = []

    def get_node(na: int, nb: int, f: int) -> int:
        key = (na, nb, f)
        if key not in node_map:
            node_map[key] = len(times)
            times.append(int(a.node_time[na]))
        return node_map[key]

    start = get_node(0, 0, 0)
    arcs: List[LatticeArc] = []
    finals: Dict[int, float] = {}
    stack = [(0, 0, 0)]
    seen = {(0, 0, 0)}

    def push(key: Tuple[int, int, int]) -> int:
        if key not in seen:
            seen.add(key)
            stack.append(key)
        return get_node(*key)

    while stack:
        na, nb, f = stack.pop()
        src = get_node(na, nb, f)
        if na in a.final_scores and nb in b.final_scores:
            sc = a.final_scores[na] + b.final_scores[nb]
            finals[src] = min(finals.get(src, BIG), sc)
        for ai in out_a[na]:
            arc_a = a.arcs[ai]
            if arc_a.lemma < 0:
                if f in (0, 1):  # eps on a
                    dst = push((arc_a.to_node, nb, 1))
                    arcs.append(LatticeArc(src, dst, -1,
                                           arc_a.am_score, arc_a.lm_score))
                continue
            matches = orth_to_b.get(a.lemma_orths[arc_a.lemma])
            if not matches:
                continue
            for bi in out_b[nb]:
                arc_b = b.arcs[bi]
                if arc_b.lemma in matches:
                    dst = push((arc_a.to_node, arc_b.to_node, 0))
                    arcs.append(LatticeArc(
                        src, dst, arc_a.lemma,
                        arc_a.am_score + arc_b.am_score,
                        arc_a.lm_score + arc_b.lm_score,
                    ))
        if f in (0, 2):  # eps on b
            for bi in out_b[nb]:
                arc_b = b.arcs[bi]
                if arc_b.lemma < 0:
                    dst = push((na, arc_b.to_node, 2))
                    arcs.append(LatticeArc(src, dst, -1,
                                           arc_b.am_score, arc_b.lm_score))
        if f == 0:  # simultaneous eps advance (filter state 0 only)
            for ai in out_a[na]:
                arc_a = a.arcs[ai]
                if arc_a.lemma >= 0:
                    continue
                for bi in out_b[nb]:
                    arc_b = b.arcs[bi]
                    if arc_b.lemma < 0:
                        dst = push((arc_a.to_node, arc_b.to_node, 0))
                        arcs.append(LatticeArc(
                            src, dst, -1,
                            arc_a.am_score + arc_b.am_score,
                            arc_a.lm_score + arc_b.lm_score,
                        ))
    return _trim(Lattice(len(times), arcs, np.asarray(times, np.int32),
                         finals, list(a.lemma_orths)))
