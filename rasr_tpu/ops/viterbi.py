"""Batched banded Viterbi / forward-backward over linear HMM graphs.

Batched replacement for the reference's frame-synchronous alignment DP
(ref: src/Speech/Aligner.* — time-sync Viterbi over a per-utterance
transducer with beam pruning). The reference walks a lazily expanded FSA
frame by frame; here alignment graphs are *linear chains with a
bandwidth-3 predecessor structure* (loop / forward / skip — exactly the
0-1-2 topology the reference's transducers produce for a fixed
pronunciation with optional skippable silence), so the whole DP is a
``lax.scan`` over time of dense ``[B, S]`` vector ops — no pruning needed
because the graph is small and dense occupancy is accelerator-friendly.

Conventions: all scores are -log ("costs", min-sum); BIG is the finite
pseudo-infinity (1e30) so f32 arithmetic never produces NaN via inf-inf.

Inputs per batch element b:
  emissions  [B, T, S]  cost of state s emitting frame t
  loop,fwd,skip [B, S]  cost of entering state s from s / s-1 / s-2
  init       [B, S]     cost of starting in s (BIG if not a start state)
  final      [B, S]     cost of ending in s (exit penalty; BIG if not final)
  n_frames   [B]        valid frame counts (padded frames ignored)

Outputs: best total cost [B], per-frame state sequence [B, T] (padding
frames hold -1), and for forward-backward the posterior occupancies.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

BIG = 1.0e30


def _shift1(x: jnp.ndarray) -> jnp.ndarray:
    """x[..., s-1] with BIG at s=0."""
    return jnp.concatenate([jnp.full_like(x[..., :1], BIG), x[..., :-1]], axis=-1)


def _shift2(x: jnp.ndarray) -> jnp.ndarray:
    return jnp.concatenate([jnp.full_like(x[..., :2], BIG), x[..., :-2]], axis=-1)


def _unshift1(x: jnp.ndarray) -> jnp.ndarray:
    """x[..., s+1] with BIG at s=S-1."""
    return jnp.concatenate([x[..., 1:], jnp.full_like(x[..., :1], BIG)], axis=-1)


def _unshift2(x: jnp.ndarray) -> jnp.ndarray:
    return jnp.concatenate([x[..., 2:], jnp.full_like(x[..., :2], BIG)], axis=-1)


def _nlse(*costs: jnp.ndarray) -> jnp.ndarray:
    """-log sum exp(-c_i): the sum-semiring combine in cost domain."""
    stacked = jnp.stack(costs, axis=0)
    m = jnp.min(stacked, axis=0)
    safe = jnp.where(m >= BIG, 0.0, m)  # avoid BIG-BIG
    s = jnp.sum(jnp.exp(-(stacked - safe[None])), axis=0)
    out = safe - jnp.log(jnp.maximum(s, 1e-37))
    return jnp.where(m >= BIG, BIG, out)


@partial(jax.jit, static_argnames=("return_backpointers",))
def viterbi_forward(
    emissions: jnp.ndarray,
    loop: jnp.ndarray,
    fwd: jnp.ndarray,
    skip: jnp.ndarray,
    init: jnp.ndarray,
    final: jnp.ndarray,
    n_frames: jnp.ndarray,
    return_backpointers: bool = True,
):
    """Min-sum forward pass.

    Returns (best_cost [B], final_state [B], backpointers [T, B, S] int8).
    """
    B, T, S = emissions.shape
    emissions = jnp.minimum(emissions, BIG)

    dp0 = jnp.minimum(init + emissions[:, 0], BIG)

    def best_final(dp):
        tot = jnp.minimum(dp + final, BIG)
        return jnp.min(tot, axis=-1), jnp.argmin(tot, axis=-1)

    f0, s0 = best_final(dp0)
    carry0 = (dp0, jnp.where(n_frames == 1, f0, BIG), jnp.where(n_frames == 1, s0, 0))

    def step(carry, inputs):
        dp, fbest, fstate = carry
        emis_t, t = inputs
        cand_loop = dp + loop
        cand_fwd = _shift1(dp) + fwd
        cand_skip = _shift2(dp) + skip
        stacked = jnp.stack([cand_loop, cand_fwd, cand_skip], axis=0)
        bp = jnp.argmin(stacked, axis=0).astype(jnp.int8)
        new_dp = jnp.minimum(jnp.min(stacked, axis=0) + emis_t, BIG)
        active = (t < n_frames)[:, None]
        dp = jnp.where(active, new_dp, dp)
        f_t, s_t = best_final(dp)
        is_last = t == n_frames - 1
        fbest = jnp.where(is_last, f_t, fbest)
        fstate = jnp.where(is_last, s_t, fstate)
        return (dp, fbest, fstate), (bp if return_backpointers else jnp.zeros((B, S), jnp.int8))

    ts = jnp.arange(1, T)
    (dp, fbest, fstate), bps = jax.lax.scan(step, carry0, (jnp.swapaxes(emissions[:, 1:], 0, 1), ts))
    # prepend a zero backpointer row for t=0
    bps = jnp.concatenate([jnp.zeros((1, B, S), jnp.int8), bps], axis=0)
    return fbest, fstate, bps


@jax.jit
def viterbi_backtrace(
    backpointers: jnp.ndarray,  # [T, B, S] int8
    final_state: jnp.ndarray,  # [B]
    n_frames: jnp.ndarray,  # [B]
) -> jnp.ndarray:
    """Recover the state sequence [B, T]; padding frames are -1."""
    T, B, S = backpointers.shape

    def step(cur, inputs):
        bp_t, t = inputs
        # state at time t (for those with t < n): cur if t == n-1 else
        # already-walked value; walk backwards one step where t <= n-1.
        emit = jnp.where(t < n_frames, cur, -1)
        offs = jnp.take_along_axis(bp_t, cur[:, None], axis=-1)[:, 0]
        walk = (t < n_frames) & (t > 0)
        cur = jnp.where(walk, cur - offs, cur)
        return cur, emit

    ts = jnp.arange(T - 1, -1, -1)
    _, states_rev = jax.lax.scan(step, final_state, (backpointers[::-1], ts))
    return jnp.swapaxes(states_rev[::-1], 0, 1)


def viterbi_align(
    emissions, loop, fwd, skip, init, final, n_frames
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Full forced alignment: (best_cost [B], state sequence [B, T])."""
    best, fstate, bps = viterbi_forward(emissions, loop, fwd, skip, init, final, n_frames)
    return best, viterbi_backtrace(bps, fstate, n_frames)


@jax.jit
def forward_backward(
    emissions: jnp.ndarray,
    loop: jnp.ndarray,
    fwd: jnp.ndarray,
    skip: jnp.ndarray,
    init: jnp.ndarray,
    final: jnp.ndarray,
    n_frames: jnp.ndarray,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Sum-semiring DP → state occupancy posteriors.

    Returns (total cost [B] = -log p(X), gamma [B, T, S], zero on padding).
    (ref: the aligner's Baum-Welch mode, Speech::Aligner with
    alignment posteriors.)
    """
    B, T, S = emissions.shape
    emissions = jnp.minimum(emissions, BIG)

    # ---------------------------------------------------------- alpha (fwd)
    a0 = jnp.minimum(init + emissions[:, 0], BIG)

    def astep(alpha, inputs):
        emis_t, t = inputs
        new = _nlse(alpha + loop, _shift1(alpha) + fwd, _shift2(alpha) + skip) + emis_t
        new = jnp.minimum(new, BIG)
        alpha = jnp.where((t < n_frames)[:, None], new, alpha)
        return alpha, alpha

    ts = jnp.arange(1, T)
    _, alphas = jax.lax.scan(astep, a0, (jnp.swapaxes(emissions[:, 1:], 0, 1), ts))
    alphas = jnp.concatenate([a0[None], alphas], axis=0)  # [T, B, S]

    # ----------------------------------------------------------- beta (bwd)
    # beta[t, s] = cost from state s at t to the end, EXCLUDING emis[t, s].
    def bstep(beta, inputs):
        emis_next, t = inputs
        # t is the *current* time; emis_next = emissions at t+1
        prop = _nlse(
            beta + loop + emis_next,
            _unshift1(beta + emis_next) + _unshift1(jnp.broadcast_to(fwd, beta.shape)),
            _unshift2(beta + emis_next) + _unshift2(jnp.broadcast_to(skip, beta.shape)),
        )
        prop = jnp.minimum(prop, BIG)
        is_last = (t == n_frames - 1)[:, None]
        beta = jnp.where(is_last, jnp.minimum(final, BIG), jnp.where(t < n_frames[:, None] - 1, prop, beta))
        return beta, beta

    beta_init = jnp.full((B, S), BIG)
    ts_rev = jnp.arange(T - 1, -1, -1)
    emis_next = jnp.concatenate(
        [jnp.swapaxes(emissions, 0, 1)[1:], jnp.full((1, B, S), BIG)], axis=0
    )  # emissions at t+1 (BIG beyond)
    emis_next_rev = emis_next[::-1]
    _, betas_rev = jax.lax.scan(bstep, beta_init, (emis_next_rev, ts_rev))
    betas = betas_rev[::-1]  # [T, B, S]

    total = -jax.scipy.special.logsumexp(-(jnp.minimum(alphas[0] + betas[0], BIG)), axis=-1)
    # clamp: batches may have n_frames == 0
    total = jnp.where(n_frames > 0, total, 0.0)

    post = alphas + betas  # [T, B, S] cost of paths through (t, s)
    gamma = jnp.exp(-(post - total[None, :, None]))
    tmask = (jnp.arange(T)[:, None] < n_frames[None, :])[..., None]
    gamma = jnp.where(tmask & (post < BIG / 2), gamma, 0.0)
    return total, jnp.swapaxes(gamma, 0, 1)
