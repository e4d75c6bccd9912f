"""Sequence (time-axis) parallelism: sharded frontend + blockwise Viterbi.

The reference needs no sequence parallelism — its Flow network streams
one frame at a time with O(1) live state (SURVEY §5 long-context). The
batched inversion processes whole utterances as dense tensors, so VERY long
recordings (hours of audio: meetings, broadcast) can exceed one chip's
HBM on the time axis. This module shards the time axis over a mesh axis:

* :class:`SpFrontend` — samples are split into contiguous time chunks,
  one per device; framing/preemphasis fetch sample halos and
  sliding-CMVN/deltas/splice fetch frame halos from neighbor devices via
  ``lax.ppermute`` (ICI neighbor exchange); segment CMVN statistics
  reduce with ``psum``. Bit-compatible semantics with the single-device
  :class:`~rasr_tpu.ops.frontend.FeatureFrontend` — including the edge
  replication of splice/deltas at the true segment boundaries, which is
  re-applied after every context stage exactly like the dense code path.

* :func:`sp_viterbi_align` — forced alignment over a time-sharded
  emission tensor. Classic DP is sequential in time; the parallel
  formulation composes per-block min-plus TRANSFER MATRICES
  ``M_b[s, s0]`` = best cost from state ``s0`` at block start to ``s``
  at block end (the "parallel prefix over semiring matmuls" of SURVEY
  §5d). Each device builds its block's matrix locally in O(T/P · S²),
  an ``all_gather`` + short sequential composition yields every block's
  entry vector, a second local pass records backpointers, and the
  backtrace stitches blocks right-to-left with a ``ppermute`` chain.
  Work inflates by a factor of S versus the sequential scan — the
  standard price of the associative form — so this is the long-utterance
  memory/latency tool, not a throughput optimization; results are
  EXACTLY equal to :func:`~rasr_tpu.ops.viterbi.viterbi_align`.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.frontend import FeatureFrontend, mfcc_from_frames, num_frames
from ..ops.viterbi import BIG


# --------------------------------------------------------------------- halos
def _halo(x: jnp.ndarray, h: int, axis: str, P_: int):
    """Left/right frame halos of width ``h`` from neighbor devices
    ([B, T_loc, ...] time-chunked). Chain ends receive zeros."""
    fwd = [(i, i + 1) for i in range(P_ - 1)]  # send right
    bwd = [(i + 1, i) for i in range(P_ - 1)]  # send left
    left = lax.ppermute(x[:, -h:], axis, fwd)  # from left neighbor
    right = lax.ppermute(x[:, :h], axis, bwd)  # from right neighbor
    return left, right


def _reclip(ext: jnp.ndarray, base, H: int, n: jnp.ndarray) -> jnp.ndarray:
    """Re-apply per-SEGMENT edge replication on an extended buffer.

    ``ext`` [B, W, D] covers global frames ``base - H .. base - H + W``;
    positions outside row b's ``[0, n[b])`` are replaced by the true edge
    frame. For every shard holding (or within a halo of) a row's valid
    frames, the edge frame is inside the buffer (``T_loc >= H``); shards
    wholly past a row's end produce clamped junk that the output mask
    zeroes. Matches ops.frontend.edge_fill + buffer-edge clipping."""
    B, W = ext.shape[0], ext.shape[1]
    j = jnp.arange(W, dtype=jnp.int32)
    g = base + j - H  # [W] global frame ids
    tgt = jnp.clip(g[None, :], 0, jnp.maximum(n[:, None] - 1, 0))  # [B, W]
    jj = jnp.clip(tgt - base + H, 0, W - 1)
    off = jnp.asarray((np.arange(B, dtype=np.int32) * W)[:, None])
    return ext.reshape((B * W,) + ext.shape[2:])[jj + off]


def _delta_shift(ext: jnp.ndarray, window: int) -> jnp.ndarray:
    """One regression-delta order by plain interior shifts (the caller
    guarantees the needed halo and re-clips edges between orders)."""
    W = ext.shape[1]
    denom = 2.0 * sum(i * i for i in range(1, window + 1))
    acc = jnp.zeros_like(ext)
    for i in range(1, window + 1):
        fwd = ext[:, np.clip(np.arange(W) + i, 0, W - 1)]
        bwd = ext[:, np.clip(np.arange(W) - i, 0, W - 1)]
        acc = acc + i * (fwd - bwd)
    return acc / denom


class SpFrontend:
    """Time-sharded drop-in for :class:`FeatureFrontend` on a mesh.

    Output features are numerically the single-device frontend's (exact
    up to f32 reduction order in the CMVN statistics); they come back
    as a global jax.Array sharded ``[B, T(time-sharded), D]``.
    """

    def __init__(self, frontend: FeatureFrontend, mesh: Mesh, axis: str = "data"):
        self.fe = frontend
        self.mesh = mesh
        self.axis = axis
        self.P = mesh.shape[axis]
        cfg = frontend.cfg
        if cfg.normalize == "sliding":
            self._h_norm = cfg.norm_window // 2
        else:
            self._h_norm = 0
        self._h_ctx = 0
        if frontend.delta_order:
            self._h_ctx += frontend.delta_order * 2  # regression window=2
        self._h_ctx += frontend.splice_context

    def __call__(self, samples: np.ndarray, lengths: np.ndarray):
        cfg = self.fe.cfg
        Pn = self.P
        samples = jnp.asarray(samples)
        lengths = jnp.asarray(lengths, jnp.int32)
        B, S = samples.shape
        t_glob = num_frames(S, cfg)
        T_loc = -(-t_glob // Pn)  # ceil
        H = max(self._h_norm, self._h_ctx, 1)
        if T_loc < H:
            raise ValueError(
                f"time chunk {T_loc} frames < required halo {H}: "
                f"utterance too short for {Pn}-way sequence parallelism"
            )
        C = T_loc * cfg.frame_shift
        # the last frame reads flen-shift samples past the sharded region;
        # that real tail rides along replicated (the last shard has no
        # right neighbor to fetch it from)
        hr = cfg.frame_length - cfg.frame_shift
        tail = samples[:, Pn * C : Pn * C + hr]
        if tail.shape[1] < hr:
            tail = jnp.pad(tail, ((0, 0), (0, hr - tail.shape[1])))
        pad = Pn * C - S
        if pad > 0:
            samples = jnp.pad(samples, ((0, 0), (0, pad)))
        else:
            samples = samples[:, : Pn * C]

        fn = jax.shard_map(
            partial(self._kernel, t_glob=t_glob, T_loc=T_loc, H=H),
            mesh=self.mesh,
            in_specs=(P(None, self.axis), P(), P()),
            out_specs=P(None, self.axis, None),
            check_vma=False,
        )
        sh = NamedSharding(self.mesh, P(None, self.axis))
        with self.mesh:
            feats = fn(jax.device_put(samples, sh), lengths, tail)
        n = jnp.minimum(
            jnp.where(
                lengths >= cfg.frame_length,
                1 + (lengths - cfg.frame_length) // cfg.frame_shift,
                0,
            ),
            t_glob,
        )
        return feats[:, :t_glob], n

    # ------------------------------------------------------------- the kernel
    def _kernel(self, chunk, lengths, tail, *, t_glob: int, T_loc: int, H: int):
        cfg = self.fe.cfg
        fe = self.fe
        Pn = self.P
        axis = self.axis
        idx = lax.axis_index(axis)
        base = idx * T_loc
        B, C = chunk.shape
        flen, shift = cfg.frame_length, cfg.frame_shift

        # --- sample halos: 1 left (preemphasis history), flen-shift right
        fwd = [(i, i + 1) for i in range(Pn - 1)]
        bwd = [(i + 1, i) for i in range(Pn - 1)]
        left1 = lax.ppermute(chunk[:, -1:], axis, fwd)  # shard 0: zeros
        hr = flen - shift
        right = lax.ppermute(chunk[:, :hr], axis, bwd)
        right = jnp.where(idx == Pn - 1, tail, right)  # real signal tail
        ext = jnp.concatenate([left1, chunk, right], axis=1)
        if cfg.preemphasis:
            pre = ext[:, 1:] - cfg.preemphasis * ext[:, :-1]
        else:
            pre = ext[:, 1:]
        fidx = (np.arange(T_loc) * shift)[:, None] + np.arange(flen)[None, :]
        frames = pre[:, fidx]
        feats = mfcc_from_frames(frames, fe.params, cfg)  # [B, T_loc, D0]

        n = jnp.minimum(
            jnp.where(
                lengths >= flen, 1 + (lengths - flen) // shift, 0
            ),
            t_glob,
        )
        g_local = base + jnp.arange(T_loc, dtype=jnp.int32)
        mask = (g_local[None, :] < n[:, None]).astype(jnp.float32)

        # ------------------------------------------------------ normalization
        if cfg.normalize == "segment":
            m3 = mask[..., None]
            count = jnp.maximum(lax.psum(jnp.sum(m3, axis=1), axis), 1.0)
            mean = lax.psum(jnp.sum(feats * m3, axis=1), axis) / count
            feats = (feats - mean[:, None]) * m3
            if cfg.norm_variance:
                var = lax.psum(jnp.sum(feats * feats * m3, axis=1), axis) / count
                feats = feats * lax.rsqrt(var[:, None] + 1e-8)
        elif cfg.normalize == "sliding":
            h = self._h_norm
            xl, xr = _halo(feats * mask[..., None], h, axis, Pn)
            ml, mr = _halo(mask[..., None], h, axis, Pn)
            x = jnp.concatenate([xl, feats * mask[..., None], xr], axis=1)
            m = jnp.concatenate([ml, mask[..., None], mr], axis=1)
            # zero contributions outside the global frame buffer (the
            # dense path's index clipping at [0, T])
            g_ext = base + jnp.arange(T_loc + 2 * h, dtype=jnp.int32) - h
            inb = ((g_ext >= 0) & (g_ext < t_glob)).astype(jnp.float32)[None, :, None]
            x = x * inb
            m = m * inb
            csum = jnp.cumsum(x, axis=1)
            csum2 = jnp.cumsum(x * x, axis=1)
            cnt = jnp.cumsum(m, axis=1)

            def rangesum(c):
                zero = jnp.zeros_like(c[:, :1])
                padded = jnp.concatenate([zero, c], axis=1)
                # local frame j: global window [g-h, g+h] — fully inside
                # the ext buffer by construction
                hi = np.arange(T_loc) + 2 * h + 1
                lo = np.arange(T_loc)
                return padded[:, hi] - padded[:, lo]

            nn = jnp.maximum(rangesum(cnt), 1.0)
            mean = rangesum(csum) / nn
            feats = (feats - mean) * mask[..., None]
            if cfg.norm_variance:
                var = jnp.maximum(rangesum(csum2) / nn - mean * mean, 1e-8)
                feats = feats * lax.rsqrt(var)

        # --------------------------------------------- context stages (halo'd)
        if fe.delta_order or fe.splice_context:
            h = self._h_ctx
            xl, xr = _halo(feats, h, axis, Pn)
            ext = jnp.concatenate([xl, feats, xr], axis=1)
            ext = _reclip(ext, base, h, n)
            if fe.delta_order:
                pieces = [ext]
                cur = ext
                for _ in range(fe.delta_order):
                    cur = _reclip(_delta_shift(cur, 2), base, h, n)
                    pieces.append(cur)
                ext = jnp.concatenate(pieces, axis=-1)
            if fe.splice_context:
                c = fe.splice_context
                W = ext.shape[1]
                sp = [
                    ext[:, np.clip(np.arange(W) + off, 0, W - 1)]
                    for off in range(-c, c + 1)
                ]
                ext = jnp.concatenate(sp, axis=-1)
            feats = ext[:, h : h + T_loc]
        if fe.lda is not None:
            feats = jnp.matmul(feats, fe.lda, precision=lax.Precision.HIGHEST)
        return feats * mask[..., None]


# ------------------------------------------------------------------ viterbi
def _transfer_step(M, inputs, loop, fwd, skip, n):
    """Compose one frame into the block transfer matrix [B, S, S]."""
    emis_t, g = inputs
    up1 = jnp.concatenate([jnp.full_like(M[:, :1], BIG), M[:, :-1]], axis=1)
    up2 = jnp.concatenate([jnp.full_like(M[:, :2], BIG), M[:, :-2]], axis=1)
    cand = jnp.minimum(
        jnp.minimum(M + loop[None, :, None], up1 + fwd[None, :, None]),
        up2 + skip[None, :, None],
    )
    S = M.shape[1]
    eye = jnp.where(jnp.eye(S, dtype=bool), 0.0, BIG)[None]
    cand = jnp.where(g == 0, eye, cand)  # frame 0 applies init, no TDP
    new = jnp.minimum(cand + emis_t[:, :, None], BIG)
    active = (g < n)[:, None, None]
    return jnp.where(active, new, M), None


def sp_viterbi_align(
    mesh: Mesh,
    emissions: np.ndarray,  # [B, T, S] -log emission costs
    loop: np.ndarray,  # [S]
    fwd: np.ndarray,
    skip: np.ndarray,
    init: np.ndarray,
    final: np.ndarray,
    n_frames: np.ndarray,  # [B]
    axis: str = "data",
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Time-sharded forced alignment == ops.viterbi.viterbi_align.

    Returns (best_cost [B], states [B, T] with -1 padding); ``states``
    comes back time-sharded over ``axis``.
    """
    Pn = mesh.shape[axis]
    emissions = jnp.asarray(emissions, jnp.float32)
    B, T, S = emissions.shape
    T_loc = -(-T // Pn)
    padT = Pn * T_loc - T
    if padT:
        emissions = jnp.pad(emissions, ((0, 0), (0, padT), (0, 0)),
                            constant_values=BIG)

    args = tuple(
        jnp.asarray(a, jnp.float32) for a in (loop, fwd, skip, init, final)
    )
    nf = jnp.asarray(n_frames, jnp.int32)

    fn = jax.shard_map(
        partial(_sp_viterbi_kernel, axis=axis, Pn=Pn, T_loc=T_loc),
        mesh=mesh,
        in_specs=(P(None, axis, None), P(), P(), P(), P(), P(), P()),
        out_specs=(P(), P(None, axis)),
        check_vma=False,
    )
    sh = NamedSharding(mesh, P(None, axis, None))
    with mesh:
        best, states = fn(jax.device_put(emissions, sh), *args, nf)
    return best, states[:, :T]


def _sp_viterbi_kernel(emis, loop, fwd, skip, init, final, n, *, axis, Pn, T_loc):
    B, _, S = emis.shape
    idx = lax.axis_index(axis)
    base = idx * T_loc
    g = base + jnp.arange(T_loc, dtype=jnp.int32)
    emis_t = jnp.swapaxes(jnp.minimum(emis, BIG), 0, 1)  # [T_loc, B, S]

    # ---- phase 1: block transfer matrix M[b, s_end, s_entry]
    eye = jnp.where(jnp.eye(S, dtype=bool), 0.0, BIG)[None]
    M0 = jnp.broadcast_to(eye, (B, S, S))
    M, _ = lax.scan(
        partial(_transfer_step, loop=loop, fwd=fwd, skip=skip, n=n),
        M0, (emis_t, g),
    )

    # ---- phase 2: entry vector per block (sequential over P blocks)
    Ms = lax.all_gather(M, axis)  # [P, B, S, S]

    def compose(b, carry):
        dp, entry = carry
        entry = jnp.where(b == idx, dp, entry)
        dp_new = jnp.min(Ms[b] + dp[:, None, :], axis=2)
        return jnp.minimum(dp_new, BIG), entry

    dp0 = jnp.broadcast_to(init[None], (B, S))
    _, entry = lax.fori_loop(0, Pn, compose, (dp0, jnp.zeros((B, S))))

    # ---- phase 3: local forward with backpointers from the entry vector
    def fstep(carry, inputs):
        dp, fbest, fstate = carry
        e_t, g_t = inputs
        cand_loop = dp + loop
        cand_fwd = jnp.concatenate([jnp.full_like(dp[:, :1], BIG), dp[:, :-1]], 1) + fwd
        cand_skip = jnp.concatenate([jnp.full_like(dp[:, :2], BIG), dp[:, :-2]], 1) + skip
        stacked = jnp.stack([cand_loop, cand_fwd, cand_skip], axis=0)
        bp = jnp.argmin(stacked, axis=0).astype(jnp.int8)
        new = jnp.min(stacked, axis=0)
        new = jnp.where(g_t == 0, dp, new)  # frame 0: init, no transition
        bp = jnp.where(g_t == 0, jnp.zeros_like(bp), bp)
        new = jnp.minimum(new + e_t, BIG)
        active = (g_t < n)[:, None]
        dp = jnp.where(active, new, dp)
        tot = jnp.minimum(dp + final, BIG)
        is_last = g_t == n - 1
        fbest = jnp.where(is_last, jnp.min(tot, axis=-1), fbest)
        fstate = jnp.where(is_last, jnp.argmin(tot, axis=-1).astype(jnp.int32), fstate)
        return (dp, fbest, fstate), bp

    carry0 = (entry, jnp.full((B,), BIG), jnp.zeros((B,), jnp.int32))
    (dp, fbest, fstate), bps = lax.scan(fstep, carry0, (emis_t, g))

    # exactly one block owns frame n-1; min/sum-combine across blocks
    own = (n - 1) >= base
    own &= (n - 1) < base + T_loc
    best = lax.pmin(jnp.where(own, fbest, BIG), axis)
    fstate_g = lax.psum(jnp.where(own, fstate, 0), axis)

    # ---- phase 4: block-stitched backtrace (right-to-left ppermute chain)
    bwd = [(i + 1, i) for i in range(Pn - 1)]

    def walk(exit_state):
        def wstep(cur, inputs):
            bp_t, g_t = inputs
            emit = jnp.where(g_t < n, cur, -1)
            offs = jnp.take_along_axis(bp_t, jnp.maximum(cur, 0)[:, None], axis=-1)[:, 0]
            step = (g_t < n) & (g_t > 0)
            cur = jnp.where(step, cur - offs, cur)
            return cur, emit

        pred, states_rev = lax.scan(
            wstep, exit_state, (bps[::-1], g[::-1])
        )
        return pred, jnp.swapaxes(states_rev[::-1], 0, 1)  # [B, T_loc]

    def chain(_, carry):
        recv, states = carry
        exit_state = jnp.where(own, fstate_g, recv)
        pred, states = walk(exit_state)
        recv = lax.ppermute(pred, axis, bwd)
        return recv, states

    recv0 = jnp.zeros((B,), jnp.int32)
    _, states = lax.fori_loop(
        0, Pn, chain, (recv0, jnp.zeros((B, T_loc), jnp.int32))
    )
    return best, states
