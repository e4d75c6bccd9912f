"""Lattice-free MMI (LF-MMI) sequence-discriminative training.

The reference's discriminative training is LATTICE-BASED MMI/MPE
(ref: src/Speech/ MODULE_SPEECH_DT + Mm::EbwDiscriminativeMixtureSetEstimator
— numerator/denominator statistics from decoded lattices, extended
Baum-Welch updates; covered here by train/discriminative.py). LF-MMI is
its modern successor (PAPERS.md: "GPU-Accelerated Forward-Backward
algorithm with Application to Lattice-Free MMI"): the denominator is a
SMALL PHONE-LM GRAPH evaluated exactly every step — no decoding pass,
no lattices — which is exactly the accelerator-friendly shape: the denominator
forward pass is T logsumexp mat-vecs over a dense [S, S] transition
matrix, batched over utterances, and the MMI gradient w.r.t. the
emission scores (numerator minus denominator occupancies) falls out of
JAX autodiff through the forward recursions — no hand-written
backward pass.

Cost-domain conventions follow the repo: scores are -log probabilities,
BIG = 1e30 is the pseudo-infinity.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models.hmm import HmmTopology, TransitionModel
from ..ops.viterbi import BIG


@dataclasses.dataclass(frozen=True)
class DenseFsa:
    """Dense cost-domain automaton with per-state emissions.

    trans[s0, s1] = -log transition prob (BIG = absent); states EMIT on
    entry (emission class per state), matching the repo's HMM alignment
    convention (ops/viterbi.py).
    """

    trans: jnp.ndarray  # [S, S] f32
    emis_class: jnp.ndarray  # [S] int32
    init: jnp.ndarray  # [S] f32
    final: jnp.ndarray  # [S] f32

    @property
    def num_states(self) -> int:
        return self.trans.shape[0]


jax.tree_util.register_pytree_node(
    DenseFsa,
    lambda f: ((f.trans, f.emis_class, f.init, f.final), None),
    lambda _, ch: DenseFsa(*ch),
)


def build_phone_bigram_den(
    num_phones: int,
    states_per_phone: int,
    classify,  # (phone, state) -> emission class id
    bigram_costs: np.ndarray,  # [P, P] -log p(p1 | p0)
    unigram_costs: Optional[np.ndarray] = None,  # [P] start costs
    trans: TransitionModel = TransitionModel(),
    states_of=None,  # optional per-phone state count [P] (e.g. 1 for
    # context-independent silence) — uniform states_per_phone otherwise,
    # so the den's minimum phone durations match the numerator topology
) -> DenseFsa:
    """Denominator graph: all phone sequences under a phone-bigram LM.

    States are (phone, hmm_state) chains with the model's loop/forward
    TDPs; leaving a phone's last state applies exit TDP + bigram cost
    into every next phone's first state. S = sum of per-phone states —
    dense and tiny (e.g. 40x3 = 120), so the forward pass is a matmul-
    friendly [S, S] mat-"vec" per frame.
    """
    P = num_phones
    counts = (
        [int(states_of[p]) for p in range(P)]
        if states_of is not None else [states_per_phone] * P
    )
    offset = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    S = int(offset[-1])
    tdp = trans.speech
    T = np.full((S, S), BIG, np.float32)
    ecls = np.zeros(S, np.int32)
    for p in range(P):
        Qp = counts[p]
        for q in range(Qp):
            s = int(offset[p]) + q
            ecls[s] = classify(p, q)
            T[s, s] = tdp.loop
            if q + 1 < Qp:
                T[s, s + 1] = tdp.forward
                if q + 2 < Qp and np.isfinite(tdp.skip) and tdp.skip < BIG / 2:
                    T[s, s + 2] = tdp.skip
        # phone end -> next phone starts
        end = int(offset[p]) + Qp - 1
        for p2 in range(P):
            T[end, int(offset[p2])] = np.minimum(
                T[end, int(offset[p2])], tdp.exit + bigram_costs[p, p2]
            )
    init = np.full(S, BIG, np.float32)
    final = np.full(S, BIG, np.float32)
    for p in range(P):
        init[int(offset[p])] = (
            unigram_costs[p] if unigram_costs is not None else 0.0
        )
        final[int(offset[p]) + counts[p] - 1] = tdp.exit
    return DenseFsa(
        trans=jnp.asarray(T),
        emis_class=jnp.asarray(ecls),
        init=jnp.asarray(init),
        final=jnp.asarray(final),
    )


def _nlse(x: jnp.ndarray, axis: int) -> jnp.ndarray:
    """-logsumexp(-x): sum-semiring reduce in cost domain, BIG-safe."""
    m = jnp.min(x, axis=axis)
    safe = jnp.where(m >= BIG / 2, 0.0, m)
    s = jnp.sum(jnp.exp(-(x - jnp.expand_dims(safe, axis))), axis=axis)
    out = safe - jnp.log(jnp.maximum(s, 1e-37))
    return jnp.where(m >= BIG / 2, BIG, out)


def _forward_sts(
    e: jnp.ndarray,  # [B, T, S] expanded per-STATE -log scores
    fsa: DenseFsa,
    n_frames: jnp.ndarray,  # [B]
) -> jnp.ndarray:
    """Forward total over pre-expanded per-state scores (see
    dense_forward; split out so objectives can perturb the per-state
    scores directly, e.g. expected_accuracy's accuracy bonus)."""
    B, T, S = e.shape
    alpha0 = jnp.minimum(fsa.init[None] + e[:, 0], BIG)

    def step(carry, inputs):
        alpha, total0 = carry
        e_t, t = inputs
        new = _nlse(alpha[:, :, None] + fsa.trans[None], axis=1) + e_t
        new = jnp.minimum(new, BIG)
        alpha = jnp.where((t < n_frames)[:, None], new, alpha)
        tot = _nlse(alpha + fsa.final[None], axis=1)
        total0 = jnp.where(t == n_frames - 1, tot, total0)
        return (alpha, total0), None

    tot0 = _nlse(alpha0 + fsa.final[None], axis=1)
    total = jnp.where(n_frames == 1, tot0, jnp.full((B,), BIG))
    (alpha, total), _ = jax.lax.scan(
        step,
        (alpha0, total),
        (jnp.swapaxes(e[:, 1:], 0, 1), jnp.arange(1, T)),
    )
    return total


@jax.jit
def dense_forward(
    emissions: jnp.ndarray,  # [B, T, M] -log emission scores
    fsa: DenseFsa,
    n_frames: jnp.ndarray,  # [B]
) -> jnp.ndarray:
    """Total -log sum over all paths ([B]); differentiable — the
    gradient w.r.t. emissions IS the state-occupancy posterior summed
    into emission classes (the forward-backward statistics, by
    autodiff through the recursion)."""
    e = jnp.minimum(emissions, BIG)[:, :, fsa.emis_class]  # [B, T, S]
    return _forward_sts(e, fsa, n_frames)


def expected_accuracy(
    emissions: jnp.ndarray,  # [B, T, M] -log acoustic scores
    fsa: DenseFsa,
    n_frames: jnp.ndarray,  # [B]
    ref_labels: jnp.ndarray,  # [B, T] reference emission-class ids
    # (forced-alignment labels; -1 = no reference at that frame)
    class_map: Optional[jnp.ndarray] = None,  # [M] coarser unit per
    # class (e.g. phone id) — MPE-style phone accuracy instead of
    # state-level accuracy when given
) -> jnp.ndarray:
    """E_{paths ~ den posterior}[#frames whose state class matches the
    reference alignment] — the state-level sMBR objective ([B], to be
    MAXIMIZED).

    The lattice-free sMBR criterion (ref: the sequence-discriminative
    MMI/sMBR training of RASR/NN [Wiesler et al., ICASSP 2014], there
    lattice-based; here over the same dense denominator graph as LF-MMI).
    Computed as a directional derivative: with Z(k) = sum over paths of
    exp(-cost(path) + k*acc(path)), E[acc] = d log Z / dk at k=0 — i.e.
    -d total/dk of the forward pass with a per-frame-per-state accuracy
    BONUS folded into the scores, taken by jax.jvp. Training gradients
    are then forward-over-reverse second derivatives, still pure
    autodiff — no hand-written sMBR backward pass.
    """
    B, T, M = emissions.shape
    e = jnp.minimum(emissions, BIG)[:, :, fsa.emis_class]  # [B, T, S]
    state_unit = fsa.emis_class
    ref_unit = ref_labels
    if class_map is not None:
        state_unit = class_map[fsa.emis_class]
        # keep -1 (unscored) sentinel out of the map
        ref_unit = jnp.where(
            ref_labels >= 0, class_map[jnp.maximum(ref_labels, 0)], -1
        )
    acc = (state_unit[None, None, :] == ref_unit[:, :, None]).astype(
        jnp.float32
    )
    valid = (ref_labels >= 0) & (
        jnp.arange(T, dtype=n_frames.dtype)[None, :] < n_frames[:, None]
    )
    acc = acc * valid.astype(jnp.float32)[:, :, None]

    def tot(k):
        return _forward_sts(e - k * acc, fsa, n_frames)

    _, dtot = jax.jvp(tot, (jnp.zeros(()),), (jnp.ones(()),))
    return -dtot


def lfmmi_loss(
    emissions: jnp.ndarray,  # [B, T, M] -log acoustic scores
    num_total: jnp.ndarray,  # [B] numerator -log p (forced alignment fwd)
    den_fsa: DenseFsa,
    n_frames: jnp.ndarray,
) -> jnp.ndarray:
    """Per-utterance MMI cost = num_cost - den_cost (minimize).

    num_total must be computed from the SAME emissions tensor (e.g. via
    ops.viterbi.forward_backward's total on the utterance's linear
    graph) so gradients flow through both terms.
    """
    den_total = dense_forward(emissions, den_fsa, n_frames)
    return num_total - den_total


def lfmmi_grad_emissions(
    emissions: jnp.ndarray,
    den_fsa: DenseFsa,
    n_frames: jnp.ndarray,
    num_loop: jnp.ndarray,
    num_fwd: jnp.ndarray,
    num_skip: jnp.ndarray,
    num_init: jnp.ndarray,
    num_final: jnp.ndarray,
    num_classes: jnp.ndarray,  # [B, T? no: [B, Sg]] emission class per graph state
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(loss [B], d loss / d emissions [B, T, M]) for a batch whose
    numerators are banded linear alignment graphs (align/graph.py).

    The gradient equals (numerator occupancy - denominator occupancy)
    accumulated per emission class — the classic LF-MMI statistics —
    obtained by autodiff, not hand-derivation.
    """
    from ..ops.viterbi import forward_backward

    def loss_fn(emis):
        # numerator: banded sum-semiring total on the linear graph
        num_emis = jnp.take_along_axis(
            emis, num_classes[:, None, :], axis=2
        )  # [B, T, Sg]
        num_total, _ = forward_backward(
            num_emis, num_loop, num_fwd, num_skip, num_init, num_final,
            n_frames,
        )
        return jnp.sum(lfmmi_loss(emis, num_total, den_fsa, n_frames))

    loss, grad = jax.value_and_grad(loss_fn)(emissions)
    return loss, grad
