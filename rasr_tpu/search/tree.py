"""Lexical prefix tree compiled to dense decode arrays.

Re-implements the reference's search network construction
(ref: src/Search/StateTree.*, src/Search/TreeBuilder.* — the lexical
prefix tree of allophone-state HMMs the word-conditioned and advanced
tree searches decode over). The reference expands tree nodes lazily into
linked structures; here the whole network compiles once, host-side, into
flat arrays the vectorized token-passing decoder consumes:

* tree nodes are **phone arcs**: an arc models one allophone (word-
  internal triphone; word-boundary contexts use the # approximation) as a
  chain of HMM states. Arcs sharing (position in tree, tied-class
  signature) are shared across words — the prefix-tree compression.
* per-state arrays: ``emission_class``, ``loop_cost``;
* out-arcs as CSR: ``arc_ptr [S+1]``, ``arc_dst [A]``, ``arc_cost [A]``
  (chain transitions, within-phone skips, phone-boundary fan-out, root
  entries);
* word ends padded per state: ``we_word / we_cost / we_lemma [S, Wmax]``
  (word id = LM vocab id; -1 none, -2 no-LM word e.g. silence); the
  word-end cost folds in the exit TDP and the pronunciation score.

State 0 is the non-emitting root (``loop=BIG``, no in-arcs): word-end
re-entry hyps sit at the root and expand into first-phone states on the
next frame.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..corpus.lexicon import Lexicon
from ..models.allophone import AllophoneAlphabet
from ..models.hmm import HmmTopology, TransitionModel
from ..models.tying import StateTying
from ..ops.viterbi import BIG

WORD_NONE = -1
WORD_SILENCE = -2  # word without LM tokens (silence and friends)


@dataclasses.dataclass
class PrefixTree:
    emission_class: np.ndarray  # [S] i32
    loop_cost: np.ndarray  # [S] f32
    arc_ptr: np.ndarray  # [S+1] i32 (CSR over out-arcs)
    arc_dst: np.ndarray  # [A] i32
    arc_cost: np.ndarray  # [A] f32
    we_word: np.ndarray  # [S, Wmax] i32
    we_cost: np.ndarray  # [S, Wmax] f32
    we_lemma: np.ndarray  # [S, Wmax] i32
    lemmas: List  # lemma objects by index used in we_lemma
    max_out_degree: int
    #: unigram LM lookahead potential per state (min unscaled unigram LM
    #: cost over word ends reachable in the subtree; 0 everywhere when no
    #: unigram table was provided at build). ref: src/Search/LmLookahead —
    #: folded into pruning via exact potential shaping in the decoder.
    lookahead: Optional[np.ndarray] = None
    #: word-end re-entry state per (state, word-end slot). None = all 0
    #: (the prefix tree's root). Generic WFST networks re-enter at
    #: non-emitting junction states instead (search/wfst.py), and the
    #: across-word network re-enters at context-conditioned roots.
    we_next: Optional[np.ndarray] = None
    #: states [0, num_final_states) accept complete hypotheses (utterance
    #: may end there). The within-word tree has exactly one such state
    #: (the root); the across-word network also accepts its
    #: boundary-committed root (state 1).
    num_final_states: int = 1

    @property
    def num_states(self) -> int:
        return self.emission_class.shape[0]

    @property
    def num_arcs(self) -> int:
        return self.arc_dst.shape[0]

    @property
    def max_word_ends(self) -> int:
        return self.we_word.shape[1]

    def stats(self) -> Dict[str, int]:
        return {
            "states": self.num_states,
            "arcs": self.num_arcs,
            "max_out_degree": self.max_out_degree,
            "max_word_ends": self.max_word_ends,
            "word_end_states": int((self.we_word[:, 0] != WORD_NONE).sum()),
        }


def build_prefix_tree(
    lexicon: Lexicon,
    tying: StateTying,
    topology: HmmTopology = HmmTopology(),
    transitions: TransitionModel = TransitionModel(),
    lm_vocab: Optional[Dict[str, int]] = None,
    within_phone_skip: bool = True,
    lm_unigrams: Optional[Dict[int, float]] = None,
    across_word: bool = False,
    skip_scope: str = "word",
) -> PrefixTree:
    """Compile the decoding network from the lexicon.

    ``lm_vocab`` maps syntactic tokens to LM word ids; lemmas whose first
    synt token is missing from it decode via <unk> if present, else are
    scored as no-LM words. ``lm_unigrams`` (LM word id -> unscaled -log
    unigram cost) enables the lookahead potential.

    ``across_word=True`` builds the across-word network instead: word-
    boundary triphone contexts are modeled exactly (context-conditioned
    roots + word-end right-context fan-out) rather than approximated with
    ``#`` (ref: the word-conditioned/advanced tree searches' across-word
    model support, src/Am/ClassicAcousticModel.* transducer contexts).

    ``skip_scope`` controls which finite-skip TDP transitions the network
    realizes (``within_phone_skip=False`` disables skips entirely):

    * ``"word"`` (default): skips connect state j-2 -> j over each WORD's
      whole state chain, crossing phone boundaries — the reference's
      topology (its transducers apply TDPs over the expanded
      pronunciation state sequence) and exactly what the alignment
      graphs do (align/graph.py), so alignment and decode scores agree.
    * ``"phone"``: skips stay within each phone's states (the leaner
      historical network of this repo's benchmarks: boundary skip arcs
      roughly double junction fan-out, which widens the decoder's
      branch-overflow sections; with skip = inf both scopes coincide).
    """
    if skip_scope not in ("word", "phone"):
        raise ValueError(f"unknown skip_scope {skip_scope!r}")
    if across_word:
        return _build_across_word_tree(
            lexicon, tying, topology, transitions, lm_vocab,
            within_phone_skip, lm_unigrams, skip_scope,
        )
    alphabet = AllophoneAlphabet(
        lexicon, max_states=max(topology.states_per_phone, topology.silence_states)
    )
    unk_id = lm_vocab.get("<unk>") if lm_vocab else None

    # ---- states ----------------------------------------------------------
    emission_class: List[int] = [0]  # root placeholder
    loop_cost: List[float] = [BIG]
    out_arcs: List[List[Tuple[int, float]]] = [[]]  # per state
    word_ends: List[List[Tuple[int, float, int]]] = [[]]

    def new_state(cls: int, loop: float) -> int:
        emission_class.append(cls)
        loop_cost.append(min(loop, BIG))
        out_arcs.append([])
        word_ends.append([])
        return len(emission_class) - 1

    # arc sharing: (parent_node, signature) -> (child_node, state ids)
    arc_map: Dict[Tuple[int, Tuple], Tuple[int, List[int]]] = {}
    next_node = [1]  # node ids (root=0); nodes are virtual (arcs carry states)

    lemma_list: List = []

    for lemma in lexicon.lemmata:
        if not lemma.pronunciations:
            continue
        synt = lemma.synt_tokens()
        if not synt:
            lm_word = WORD_SILENCE
        elif lm_vocab is None:
            lm_word = WORD_SILENCE if lemma.special == "silence" else 0
        else:
            lm_word = lm_vocab.get(synt[0], unk_id if unk_id is not None else WORD_SILENCE)
        lemma_idx = len(lemma_list)
        lemma_list.append(lemma)

        for pron in lemma.pronunciations:
            states_flat = alphabet.phone_sequence_states(pron.phonemes, topology)
            # group chain entries by phone position
            per_phone: List[List] = []
            pos = 0
            for i, pid in enumerate(pron.phonemes):
                ph = lexicon.phonemes.by_id(pid)
                n = topology.num_states(ph.context_independent)
                per_phone.append(states_flat[pos : pos + n])
                pos += n

            cur_node = 0
            prev_last_state = 0  # root
            prev_leave_cost = 0.0  # cost of arc from prev into this arc's head
            chain: List[Tuple[int, float]] = []  # (state, skip cost of its phone)
            for i, phone_states in enumerate(per_phone):
                ph = lexicon.phonemes.by_id(pron.phonemes[i])
                tdp = transitions.for_class(ph.context_independent)
                classes = tuple(tying.classify(st) for st in phone_states)
                key = (cur_node, classes)
                if key in arc_map:
                    child_node, sids = arc_map[key]
                else:
                    sids = [new_state(c, tdp.loop) for c in classes]
                    # chain transitions within the phone
                    for j in range(len(sids) - 1):
                        out_arcs[sids[j]].append((sids[j + 1], min(tdp.forward, BIG)))
                    if skip_scope == "phone" and within_phone_skip and tdp.skip < BIG:
                        for j in range(len(sids) - 2):
                            out_arcs[sids[j]].append((sids[j + 2], tdp.skip))
                    child_node = next_node[0]
                    next_node[0] += 1
                    arc_map[key] = (child_node, sids)
                # connect parent tail to this arc's head (flatten dedups)
                out_arcs[prev_last_state].append((sids[0], min(prev_leave_cost, BIG)))
                cur_node = child_node
                prev_last_state = sids[-1]
                prev_leave_cost = tdp.forward
                chain.extend((s, tdp.skip) for s in sids)

            if skip_scope == "word" and within_phone_skip:
                # skip transitions over the WHOLE word state chain (j-2 -> j,
                # crossing phone boundaries — matching the alignment graphs
                # and the reference's transducer topology); shared arcs
                # re-add identical skips, the flatten dedups them
                for j in range(2, len(chain)):
                    src, skip_cost = chain[j - 2]
                    if skip_cost < BIG:
                        out_arcs[src].append((chain[j][0], skip_cost))

            final_ph = lexicon.phonemes.by_id(pron.phonemes[-1])
            final_tdp = transitions.for_class(final_ph.context_independent)
            we_cost = min(final_tdp.exit + pron.score, BIG)
            word_ends[prev_last_state].append((lm_word, we_cost, lemma_idx, 0))

    tree = _flatten_tree(emission_class, loop_cost, out_arcs, word_ends, lemma_list)
    if lm_unigrams is not None:
        tree.lookahead = compute_lookahead(tree, lm_unigrams)
    return tree


def _flatten_tree(
    emission_class: List[int],
    loop_cost: List[float],
    out_arcs: List[List[Tuple[int, float]]],
    word_ends: List[List[Tuple[int, float, int, int]]],
    lemma_list: List,
    num_final_states: int = 1,
) -> PrefixTree:
    """Host lists -> dense decode arrays (shared by both network builders).

    Word-end entries are (lm_word, cost, lemma_idx, re-entry state); arcs
    with the same destination dedup to the min cost."""
    S = len(emission_class)
    arc_ptr = np.zeros(S + 1, np.int32)
    flat_dst: List[int] = []
    flat_cost: List[float] = []
    max_deg = 0
    for s in range(S):
        best: Dict[int, float] = {}
        for dst, cost in out_arcs[s]:
            if dst not in best or cost < best[dst]:
                best[dst] = cost
        items = sorted(best.items())
        max_deg = max(max_deg, len(items))
        for dst, cost in items:
            flat_dst.append(dst)
            flat_cost.append(cost)
        arc_ptr[s + 1] = len(flat_dst)

    w_max = max(1, max(len(w) for w in word_ends))
    we_word = np.full((S, w_max), WORD_NONE, np.int32)
    we_cost_arr = np.full((S, w_max), np.float32(BIG), np.float32)
    we_lemma = np.full((S, w_max), -1, np.int32)
    we_next = np.zeros((S, w_max), np.int32)
    any_next = False
    for s, ws in enumerate(word_ends):
        # dedup identical (word, lemma, re-entry) keeping best cost
        seen: Dict[Tuple[int, int, int], float] = {}
        for w, c, l, nx in ws:
            if (w, l, nx) not in seen or c < seen[(w, l, nx)]:
                seen[(w, l, nx)] = c
        # INVARIANT: slots sorted by cost ascending — the decoder's
        # two-stage word-end top-R (search/decoder.py, wmax > 1 path)
        # is exact ONLY under this ordering (slot 0 bounds the rest)
        for k, ((w, l, nx), c) in enumerate(
            sorted(seen.items(), key=lambda kv: kv[1])
        ):
            we_word[s, k] = w
            we_cost_arr[s, k] = c
            we_lemma[s, k] = l
            we_next[s, k] = nx
            any_next = any_next or nx != 0

    return PrefixTree(
        emission_class=np.asarray(emission_class, np.int32),
        loop_cost=np.asarray(loop_cost, np.float32),
        arc_ptr=arc_ptr,
        arc_dst=np.asarray(flat_dst, np.int32),
        arc_cost=np.asarray(flat_cost, np.float32),
        we_word=we_word,
        we_cost=we_cost_arr,
        we_lemma=we_lemma,
        lemmas=lemma_list,
        max_out_degree=max_deg,
        we_next=we_next if any_next else None,
        num_final_states=num_final_states,
    )


def _lm_word_of(lemma, lm_vocab, unk_id) -> int:
    synt = lemma.synt_tokens()
    if not synt:
        return WORD_SILENCE
    if lm_vocab is None:
        return WORD_SILENCE if lemma.special == "silence" else 0
    return lm_vocab.get(synt[0], unk_id if unk_id is not None else WORD_SILENCE)


def _build_across_word_tree(
    lexicon: Lexicon,
    tying: StateTying,
    topology: HmmTopology,
    transitions: TransitionModel,
    lm_vocab: Optional[Dict[str, int]],
    within_phone_skip: bool,
    lm_unigrams: Optional[Dict[int, float]],
    skip_scope: str = "word",
) -> PrefixTree:
    """Across-word search network: exact word-boundary triphone contexts.

    Structure (the dense-array form of the reference's across-word model —
    context-conditioned tree copies in Search::WordConditionedTreeSearch /
    AdvancedTreeSearch):

    * **state 0** (``root``): left context ``#`` and an unconstrained
      successor — utterance start and the state after any context-
      breaking (ci-final) word such as silence. FINAL.
    * **state 1** (``root#``): reached by committing right context ``#``
      at a word end — only context-breaking (ci-initial) words (silence)
      may follow, or the utterance ends. FINAL.
    * **root(f, G)** for every non-ci final phone f x right-context
      GROUP G: reached by ending a word on f having committed that the
      successor starts with some phone in G; fans out to words starting
      with any r in G, whose first-phone allophones take left context f.
      NOT final. Right contexts group by the tying: for a given word
      end, all successors r whose final-phone class signatures coincide
      are acoustically indistinguishable, so ONE word-end copy
      re-entering the grouped root covers them all — exact, and it
      keeps the word-end slot count at the tying's context RESOLUTION
      instead of the phone-set size (a collapsing tying otherwise
      stacked ~|R| slots per shared word-end state, ballooning the
      decoder's word-end scan width: measured 25.7 vs ~200 audio-s/s).
    * word ends of a word with non-ci final phone pn therefore fan out
      one copy per signature group (re-entering root(pn, G)) plus the
      ``#`` copy (re-entering root#). ci-final words re-enter state 0
      (context break).
    * arcs are shared by tied-class signature exactly as in the
      within-word tree (first-phone arcs share across roots, so suffixes
      are built once per signature, not once per left context).

    Pruning semantics, exactness contract, and the decoder are unchanged:
    re-entry at non-0 roots rides the generic ``we_next`` machinery the
    WFST networks already use; the only decoder-visible addition is
    ``num_final_states = 2``.
    """
    alphabet = AllophoneAlphabet(
        lexicon, max_states=max(topology.states_per_phone, topology.silence_states)
    )
    unk_id = lm_vocab.get("<unk>") if lm_vocab else None

    def is_ci(pid: int) -> bool:
        return lexicon.phonemes.by_id(pid).context_independent

    # ---- pass 1: pronunciation inventory + boundary-context sets ---------
    lemma_list: List = []
    prons: List[Tuple[int, int, object]] = []  # (lemma_idx, lm_word, pron)
    for lemma in lexicon.lemmata:
        if not lemma.pronunciations:
            continue
        lm_word = _lm_word_of(lemma, lm_vocab, unk_id)
        lemma_idx = len(lemma_list)
        lemma_list.append(lemma)
        for pron in lemma.pronunciations:
            prons.append((lemma_idx, lm_word, pron))

    F = sorted({p.phonemes[-1] for _, _, p in prons if not is_ci(p.phonemes[-1])})
    R = sorted({p.phonemes[0] for _, _, p in prons if not is_ci(p.phonemes[0])})

    from ..models.allophone import FLAG_FINAL, FLAG_INITIAL, NO_CONTEXT

    # ---- pass A: right-context signature groups per word end -------------
    # Successor phones r whose final-phone class signatures coincide are
    # acoustically indistinguishable at this word end: one word-end copy
    # + one grouped root covers them exactly. Groups (and therefore the
    # roots) depend on the tying's context resolution.
    def signature(pid, left, right, boundary):
        sts = alphabet.phone_states(pid, left, right, topology, boundary)
        return tuple(tying.classify(st) for st in sts)

    # memo: (pron identity, lam-or-None) -> {classes: sorted [r...]}
    group_memo: Dict[Tuple, Dict[Tuple, List[int]]] = {}
    root_keys = set()

    def groups_for(pron, lam):
        """Signature groups of the final phone over successors r in R.
        ``lam`` only matters for single-phone pronunciations."""
        ph = pron.phonemes
        n = len(ph)
        key = (id(pron), lam if n == 1 else None)
        if key not in group_memo:
            left = lam if n == 1 else ph[n - 2]
            bnd = (FLAG_INITIAL | FLAG_FINAL) if n == 1 else FLAG_FINAL
            g: Dict[Tuple, List[int]] = {}
            for r in R:
                g.setdefault(signature(ph[-1], left, r, bnd), []).append(r)
            group_memo[key] = g
        return group_memo[key]

    for _, _, pron in prons:
        ph = pron.phonemes
        if is_ci(ph[-1]):
            continue
        lams_a = (
            ([NO_CONTEXT] + F) if len(ph) == 1 and not is_ci(ph[0]) else [None]
        )
        for lam in lams_a:
            for G in groups_for(pron, lam).values():
                root_keys.add((ph[-1], tuple(G)))

    # ---- states -----------------------------------------------------------
    emission_class: List[int] = [0, 0]  # root, root#
    loop_cost: List[float] = [BIG, BIG]
    out_arcs: List[List[Tuple[int, float]]] = [[], []]
    word_ends: List[List[Tuple[int, float, int, int]]] = [[], []]
    ROOT0, ROOTH = 0, 1

    def new_state(cls: int, loop: float) -> int:
        emission_class.append(cls)
        loop_cost.append(min(loop, BIG))
        out_arcs.append([])
        word_ends.append([])
        return len(emission_class) - 1

    # context-conditioned roots, allocated up front so every arc runs from
    # a lower to a higher state id (keeps compute_lookahead's single
    # reverse sweep a valid reverse-topological relaxation)
    root_id: Dict[Tuple[int, Tuple[int, ...]], int] = {}
    for fk in sorted(root_keys):
        root_id[fk] = new_state(0, BIG)
    # entry lookup: (left context f, first phone p0) -> roots to enter from
    roots_by_entry: Dict[Tuple[int, int], List[int]] = {}
    for (f, G), rid in root_id.items():
        for r in G:
            roots_by_entry.setdefault((f, r), []).append(rid)

    # arc sharing: key -> state ids. First-phone arcs key on the phone
    # itself (shared across all roots with equal signatures); later arcs
    # key on the previous arc's last state (= the shared prefix), exactly
    # the within-word discipline.
    arc_map: Dict[Tuple, List[int]] = {}

    def build_arc(parent_key, pid, left, right, boundary):
        tdp = transitions.for_class(is_ci(pid))
        sts = alphabet.phone_states(pid, left, right, topology, boundary)
        classes = tuple(tying.classify(st) for st in sts)
        key = (parent_key, classes)
        if key in arc_map:
            return arc_map[key]
        sids = [new_state(c, tdp.loop) for c in classes]
        for j in range(len(sids) - 1):
            out_arcs[sids[j]].append((sids[j + 1], min(tdp.forward, BIG)))
        if skip_scope == "phone" and within_phone_skip and tdp.skip < BIG:
            for j in range(len(sids) - 2):
                out_arcs[sids[j]].append((sids[j + 2], tdp.skip))
        arc_map[key] = sids
        return arc_map[key]

    def wire_chain_skips(chain: List[Tuple[int, float]]) -> None:
        """Word-scope skip transitions j-2 -> j over a word's state chain
        (chain entries are (state, its phone's skip cost); duplicates from
        shared arcs dedup at flatten)."""
        if skip_scope != "word" or not within_phone_skip:
            return
        for j in range(2, len(chain)):
            src, skip_cost = chain[j - 2]
            if skip_cost < BIG:
                out_arcs[src].append((chain[j][0], skip_cost))

    for lemma_idx, lm_word, pron in prons:
        ph = pron.phonemes
        n = len(ph)
        final_tdp = transitions.for_class(is_ci(ph[-1]))
        we_cost = min(final_tdp.exit + pron.score, BIG)

        def rhos_for(lam):
            """Committed right contexts -> (representative r, re-entry
            root), one per signature group (+ the # copy)."""
            if is_ci(ph[-1]):
                return [(NO_CONTEXT, ROOT0)]  # context break: successor free
            return [(NO_CONTEXT, ROOTH)] + [
                (G[0], root_id[(ph[-1], tuple(G))])
                for G in groups_for(pron, lam).values()
            ]

        # left-context entry roots
        if is_ci(ph[0]):
            lams = [(NO_CONTEXT, (ROOT0, ROOTH))]
        else:
            lams = [(NO_CONTEXT, (ROOT0,))] + [
                (f, tuple(roots_by_entry.get((f, ph[0]), ()))) for f in F
            ]

        def skip_of(pid):
            return transitions.for_class(is_ci(pid)).skip

        for lam, entry_roots in lams:
            if n == 1:
                for rho, next_root in rhos_for(lam):
                    sids = build_arc(
                        ("a1", ph[0], FLAG_INITIAL | FLAG_FINAL),
                        ph[0], lam, rho, FLAG_INITIAL | FLAG_FINAL,
                    )
                    for er in entry_roots:
                        out_arcs[er].append((sids[0], 0.0))
                    wire_chain_skips([(s, skip_of(ph[0])) for s in sids])
                    word_ends[sids[-1]].append(
                        (lm_word, we_cost, lemma_idx, next_root)
                    )
                continue
            sids = build_arc(
                ("a1", ph[0], FLAG_INITIAL), ph[0], lam, ph[1], FLAG_INITIAL
            )
            for er in entry_roots:
                out_arcs[er].append((sids[0], 0.0))
            chain = [(s, skip_of(ph[0])) for s in sids]
            prev_last = sids[-1]
            for i in range(1, n - 1):
                fwd = min(transitions.for_class(is_ci(ph[i - 1])).forward, BIG)
                sids = build_arc(prev_last, ph[i], ph[i - 1], ph[i + 1], 0)
                out_arcs[prev_last].append((sids[0], fwd))
                chain.extend((s, skip_of(ph[i])) for s in sids)
                prev_last = sids[-1]
            fwd = min(transitions.for_class(is_ci(ph[n - 2])).forward, BIG)
            for rho, next_root in rhos_for(None):
                sids = build_arc(
                    prev_last, ph[n - 1], ph[n - 2], rho, FLAG_FINAL
                )
                out_arcs[prev_last].append((sids[0], fwd))
                wire_chain_skips(
                    chain + [(s, skip_of(ph[n - 1])) for s in sids]
                )
                word_ends[sids[-1]].append(
                    (lm_word, we_cost, lemma_idx, next_root)
                )

    tree = _flatten_tree(
        emission_class, loop_cost, out_arcs, word_ends, lemma_list,
        num_final_states=2,
    )
    if lm_unigrams is not None:
        tree.lookahead = compute_lookahead(tree, lm_unigrams)
        # the decoder's word-end undo subtracts (la[state] - la[root 0]);
        # with many roots the shaping telescope stays exact only if every
        # re-entry root carries the SAME potential — pin them all to
        # la[0] (any consistent potential is exact; this one just shapes
        # within words)
        tree.lookahead[: 2 + len(root_id)] = tree.lookahead[0]
    return tree


def compute_lookahead(tree: PrefixTree, lm_unigrams: Dict[int, float]) -> np.ndarray:
    """Per-state lookahead potential: min unscaled unigram cost over word
    ends reachable below each state (silence/no-LM words count as 0).

    States are created parent-before-child, so a single reverse sweep is
    a valid reverse-topological relaxation (loops/word-end re-entries are
    not tree arcs).
    """
    S = tree.num_states
    la = np.full(S, np.float32(BIG), np.float32)
    default = max(lm_unigrams.values()) if lm_unigrams else 0.0
    for s in range(S - 1, -1, -1):
        best = BIG
        for k in range(tree.max_word_ends):
            w = tree.we_word[s, k]
            if w == WORD_NONE:
                break
            best = min(best, 0.0 if w < 0 else lm_unigrams.get(int(w), default))
        for ai in range(tree.arc_ptr[s], tree.arc_ptr[s + 1]):
            best = min(best, float(la[tree.arc_dst[ai]]))
        la[s] = best
    la[la >= BIG / 2] = 0.0  # dead-end states (shouldn't exist): neutral
    return la.astype(np.float32)


# ------------------------------------------------------------- image caching
def save_tree(tree: PrefixTree, path: str) -> None:
    """Persist the compiled network (ref: the reference's image/dump
    caching of compiled state networks — compilation of large lexica
    takes seconds-to-minutes, so it is a cached build artifact).

    Lemma objects are not serialized: the list is rebound from the
    lexicon at load (it is exactly the lexicon's pronunciation-bearing
    lemmata in order); saved orths double-check the binding."""
    np.savez_compressed(
        path,
        emission_class=tree.emission_class,
        loop_cost=tree.loop_cost,
        arc_ptr=tree.arc_ptr,
        arc_dst=tree.arc_dst,
        arc_cost=tree.arc_cost,
        we_word=tree.we_word,
        we_cost=tree.we_cost,
        we_lemma=tree.we_lemma,
        max_out_degree=np.int64(tree.max_out_degree),
        num_final_states=np.int64(tree.num_final_states),
        lookahead=(
            tree.lookahead if tree.lookahead is not None else np.zeros(0, np.float32)
        ),
        we_next=(
            tree.we_next if tree.we_next is not None else np.zeros((0, 0), np.int32)
        ),
        lemma_orths=np.array(
            [l.primary_orth for l in tree.lemmas], dtype=np.str_
        ),
    )


def load_tree(path: str, lexicon) -> PrefixTree:
    """Load a saved network and rebind its lemma objects from ``lexicon``.
    Raises ValueError when the lexicon no longer matches the image."""
    data = np.load(path, allow_pickle=False)
    lemmas = [l for l in lexicon.lemmata if l.pronunciations]
    saved = [str(o) for o in data["lemma_orths"]]
    got = [l.primary_orth for l in lemmas]
    if saved != got:
        raise ValueError(
            f"search-network image {path} does not match the lexicon "
            f"({len(saved)} vs {len(got)} lemmata)"
        )
    la = data["lookahead"]
    wn = data["we_next"]
    return PrefixTree(
        emission_class=data["emission_class"],
        loop_cost=data["loop_cost"],
        arc_ptr=data["arc_ptr"],
        arc_dst=data["arc_dst"],
        arc_cost=data["arc_cost"],
        we_word=data["we_word"],
        we_cost=data["we_cost"],
        we_lemma=data["we_lemma"],
        lemmas=lemmas,
        max_out_degree=int(data["max_out_degree"]),
        lookahead=la if la.size else None,
        we_next=wn if wn.size else None,
        num_final_states=(
            int(data["num_final_states"]) if "num_final_states" in data else 1
        ),
    )
