"""N-gram LM compiled to device-resident hash tables with gather lookups.

The batched replacement for the reference's in-decoder LM access
(ref: src/Lm/BackingOff.* trie walks): the ARPA model is compiled once,
host-side, into

* a **state space** = all contexts listed in the model (plus the empty
  context, id 0) — these ids ARE the decoder's word histories, so history
  recombination needs no interning (SURVEY §7: "n-gram probabilities
  compiled into HBM-resident integer-keyed tables so LM lookups are
  device gathers");
* ``backoff_cost/backoff_state [S]`` arrays;
* an open-addressing **transition hash table** keyed by (state, word)
  holding (cost, next_state), linear probing with a build-time-verified
  probe bound.

Lookups are fully vectorized: at most ``order`` backoff levels, each one
replicated-row gather — no data-dependent control flow. Inside a scan
body (the decoder's frame loop) call ``prepare_lookup`` ONCE outside the
loop and ``lookup_prepared`` per step; the one-shot ``lookup`` wrapper
rebuilds its gather tables every call and must stay out of loops.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .arpa import NgramLm

_H1 = np.uint32(0x9E3779B1)
_H2 = np.uint32(0x85EBCA6B)


def _hash(state: np.ndarray, word: np.ndarray, mask: int) -> np.ndarray:
    with np.errstate(over="ignore"):
        h = (state.astype(np.uint32) * _H1) ^ (word.astype(np.uint32) * _H2)
        h ^= h >> np.uint32(15)
        h = h * np.uint32(0x2545F491)
        h ^= h >> np.uint32(13)
    return (h & np.uint32(mask)).astype(np.int64)


def _hash_jax(state: jnp.ndarray, word: jnp.ndarray, mask: int) -> jnp.ndarray:
    h = (state.astype(jnp.uint32) * jnp.uint32(0x9E3779B1)) ^ (
        word.astype(jnp.uint32) * jnp.uint32(0x85EBCA6B)
    )
    h = h ^ (h >> 15)
    h = h * jnp.uint32(0x2545F491)
    h = h ^ (h >> 13)
    return (h & jnp.uint32(mask)).astype(jnp.int32)


@dataclasses.dataclass(frozen=True)
class NgramTables:
    """Device pytree of the compiled LM."""

    key_state: jnp.ndarray  # [H] i32, -1 = empty
    key_word: jnp.ndarray  # [H] i32
    val_cost: jnp.ndarray  # [H] f32
    val_next: jnp.ndarray  # [H] i32
    backoff_cost: jnp.ndarray  # [S] f32
    backoff_state: jnp.ndarray  # [S] i32
    order: int
    max_probe: int
    start_state: int
    end_word: int
    unk_word: int
    num_states: int
    #: bucket-of-(1<<bucket_bits) hashing (round 4): the hash selects a
    #: BUCKET of 2^bits consecutive slots (entries spill into the next
    #: bucket; build-verified). 0 = legacy per-slot linear probing.
    #: Bucketing shrinks the table 8x (load factor ~1 instead of 1/8)
    #: and turns the probe window into 1-2 aligned wide-row gathers.
    bucket_bits: int = 0

    @property
    def table_size(self) -> int:
        return self.key_state.shape[0]


jax.tree_util.register_pytree_node(
    NgramTables,
    lambda t: (
        (t.key_state, t.key_word, t.val_cost, t.val_next, t.backoff_cost, t.backoff_state),
        (t.order, t.max_probe, t.start_state, t.end_word, t.unk_word,
         t.num_states, t.bucket_bits),
    ),
    lambda aux, ch: NgramTables(*ch, *aux),
)


def build_tables(
    entries,
    backoff_cost: np.ndarray,
    backoff_state: np.ndarray,
    order: int,
    start_state: int,
    end_word: int,
    unk_word: int,
    max_probe: int = 16,
) -> NgramTables:
    """Low-level constructor: hash ``(state, word) -> (cost, next)``
    entries into an open-addressing table + pack with backoff arrays.
    Shared by the word n-gram compiler and the class-LM compiler."""
    n = len(entries)
    # bucket-of-4 layout (round 4): the hash picks a 4-slot BUCKET at
    # load factor <=1 (BH >= n buckets); an entry lands in its bucket
    # or spills into the next one (8-slot window, build-verified, grow
    # on failure). vs the old 8x-load-factor per-slot probing this is
    # an 8x smaller table whose probe window is 1-2 aligned wide rows
    # (the old layout's 100k-word [16.7M,4] table plus 7-row probe
    # windows dominated the LM's gather time on an earlier accelerator).
    bucket_bits = 2
    bsz = 1 << bucket_bits
    window = 2 * bsz
    BH = 1
    while BH < max(n, 1):
        BH *= 2

    while True:
        H = BH * bsz
        key_state = np.full(H, -1, np.int32)
        key_word = np.full(H, -1, np.int32)
        val_cost = np.zeros(H, np.float32)
        val_next = np.zeros(H, np.int32)
        worst = 0
        ok = True
        for st, w, cost, nxt in entries:
            h = int(_hash(np.int32(st), np.int32(w), BH - 1)) * bsz
            for p in range(window):
                idx = (h + p) & (H - 1)
                if key_state[idx] < 0:
                    key_state[idx] = st
                    key_word[idx] = w
                    val_cost[idx] = cost
                    val_next[idx] = nxt
                    worst = max(worst, p + 1)
                    break
            else:
                ok = False
                break
        if ok:
            break
        BH *= 2  # spill window exceeded: grow the bucket array

    return NgramTables(
        key_state=jnp.asarray(key_state),
        key_word=jnp.asarray(key_word),
        val_cost=jnp.asarray(val_cost),
        val_next=jnp.asarray(val_next),
        backoff_cost=jnp.asarray(backoff_cost.astype(np.float32)),
        backoff_state=jnp.asarray(backoff_state.astype(np.int32)),
        order=order,
        max_probe=worst,
        start_state=start_state,
        end_word=end_word,
        unk_word=unk_word,
        num_states=backoff_cost.shape[0],
        bucket_bits=bucket_bits,
    )


def state_contexts(lm: NgramLm):
    """The compiled automaton's state space: context tuples in state-id
    order (state 0 = empty context). This enumeration DEFINES the
    decoder's lm_state ids — compile_ngram and every consumer that maps
    states back to histories (e.g. search/lookahead.py's history
    classes) must share it."""
    return [()] + sorted(g for g in lm.ngrams if len(g) < lm.order)


def compile_ngram(lm: NgramLm, max_probe: int = 16) -> NgramTables:
    """Host-side compilation ARPA dict -> device tables."""
    order = lm.order
    # ---------------------------------------------------------------- states
    contexts = state_contexts(lm)
    state_id: Dict[Tuple[int, ...], int] = {g: i for i, g in enumerate(contexts)}

    def ctx_state(g: Tuple[int, ...]) -> int:
        while g not in state_id:
            g = g[1:]
        return state_id[g]

    S = len(contexts)
    backoff_cost = np.zeros(S, np.float32)
    backoff_state = np.zeros(S, np.int32)
    for g, i in state_id.items():
        if g:
            backoff_cost[i] = lm.ngrams[g][1]
            backoff_state[i] = ctx_state(g[1:])

    # ----------------------------------------------------------- transitions
    entries = []  # (state, word, cost, next_state)
    for gram, (cost, _bo) in lm.ngrams.items():
        h, w = gram[:-1], gram[-1]
        if h not in state_id:
            continue  # unreachable context (its own prefix is unlisted)
        nxt = ctx_state(gram[-(order - 1):]) if order > 1 else 0
        entries.append((state_id[h], w, cost, nxt))

    bos = lm.vocab.get("<s>")
    start = state_id.get((bos,), 0) if bos is not None else 0
    return build_tables(
        entries,
        backoff_cost,
        backoff_state,
        order=order,
        start_state=start,
        end_word=lm.vocab.get("</s>", -1),
        unk_word=lm.vocab.get("<unk>", -1),
        max_probe=max_probe,
    )


def prepare_lookup(tables: NgramTables):
    """Build the gather-side lookup tables ONCE.

    Must be called OUTSIDE any scan/loop body: the probe-chain
    replication below is ~max_probe x the hash table and XLA does not
    hoist its construction out of while loops — rebuilding it per frame
    collapses decoder throughput.

    Returns ``(packed, bo_packed, rep, uni_packed)``. ``uni_packed`` is
    the DENSE final-level table: the last level of any backoff chain is
    always the empty context, so it is an array lookup by word id — a
    tiny [V, 2] (cost-bits, next) table that stays in fast memory —
    instead of a hash probe. Words with no unigram hold the <unk>
    unigram (or cost 99) precomputed, so the separate unk probe level
    disappears too: ``order`` hash probes + 1 unk probe become
    ``order - 1`` probes + 1 dense row gather, exactly.
    """
    mask = tables.table_size - 1
    # packed [H, 4] table: (key_state, key_word, cost-bits, next)
    packed = jnp.stack(
        [
            tables.key_state,
            tables.key_word,
            jax.lax.bitcast_convert_type(tables.val_cost, jnp.int32),
            tables.val_next,
        ],
        axis=1,
    )
    bo_packed = jnp.stack(
        [
            jax.lax.bitcast_convert_type(tables.backoff_cost, jnp.int32),
            tables.backoff_state,
        ],
        axis=1,
    )
    P = tables.max_probe
    H = tables.table_size
    rep = None
    if tables.bucket_bits:
        # bucketed layout: the whole spill window is bucket b + bucket
        # b+1. Two device layouts by size:
        # * small/medium: pair-replicate the bucket rows -> ONE row
        #   gather per level ([BH, 2*bsz*4], 2x the packed bytes);
        # * LARGE (the 100k-word regime; TPU-derived, unmeasured on the
        #   H100 — PERF.md H4): a TPU tiled any <128-lane row at 128
        #   lanes, so a [BH,32] table padded 4x physically and XLA
        #   flipped it column-major (strided gathers). Pack
        #   128//(bsz*4) buckets per 128-lane row instead — EXACT
        #   tiling keeps it row-major; the lookup gathers the two rows
        #   holding buckets b and (b+1)&(BH-1) and binary-selects the
        #   bucket within each row (decoder.combo_sel's unpack).
        bsz = 1 << tables.bucket_bits
        BH = H >> tables.bucket_bits
        p16 = packed.reshape(BH, bsz * 4)
        _thr = int(
            os.environ.get("RASR_TPU_LM_REP_THRESHOLD", str(64 * 1024 * 1024))
        )
        if H * 2 * 16 <= _thr:
            rep = jnp.concatenate(
                [p16, jnp.roll(p16, -1, axis=0)], axis=1
            )  # [BH, 2*bsz*4]
        else:
            g8 = 128 // (bsz * 4)
            padr = (-BH) % g8
            if padr:
                # pad with EMPTY slots (key_state -1): an all-zero pad
                # row would falsely match (state 0, word 0)
                p16 = jnp.concatenate(
                    [p16, jnp.full((padr, bsz * 4), -1, jnp.int32)]
                )
            rep = p16.reshape((BH + padr) // g8, g8 * bsz * 4)  # [*,128]
        packed = p16[:BH]  # bucket-row form (2-gather fallback unused)
    elif H * P * 16 <= 512 * 1024 * 1024:
        # legacy per-slot probing (old table images): replicate the
        # probe window per slot so a lookup level costs one gather
        probes = jnp.arange(P, dtype=jnp.int32)
        rep = packed[
            (jnp.arange(H, dtype=jnp.int32)[:, None] + probes) & mask
        ].reshape(H, P * 4)
    # dense unigram table (host-built, once per decoder)
    ks = np.asarray(tables.key_state)
    kw = np.asarray(tables.key_word)
    vc = np.asarray(tables.val_cost)
    vn = np.asarray(tables.val_next)
    uni_rows = ks == 0
    V = int(kw[uni_rows].max()) + 1 if uni_rows.any() else 1
    # default = the current unk-fallback semantics
    if tables.unk_word >= 0:
        unk_hit = uni_rows & (kw == tables.unk_word)
        if unk_hit.any():
            i = int(np.flatnonzero(unk_hit)[0])
            d_cost, d_next = float(vc[i]), int(vn[i])
        else:
            d_cost, d_next = 99.0, 0
    else:
        d_cost, d_next = 99.0, 0
    # V+1 rows: the sentinel row V holds the default, so out-of-range
    # query ids clamp to it instead of aliasing a real word's row
    uni_cost = np.full(V + 1, d_cost, np.float32)
    uni_next = np.full(V + 1, d_next, np.int32)
    uni_cost[kw[uni_rows]] = vc[uni_rows]
    uni_next[kw[uni_rows]] = vn[uni_rows]
    uni_packed = jnp.asarray(
        np.stack([uni_cost.view(np.int32), uni_next], axis=1)
    )  # [V+1, 2]
    return packed, bo_packed, rep, uni_packed


def lookup_prepared(
    tables: NgramTables,
    prep,
    states: jnp.ndarray,
    words: jnp.ndarray,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Vectorized backing-off lookup over prepare_lookup() tables.

    states, words ``[N] i32`` -> (costs ``[N] f32``, next states ``[N] i32``).
    Unknown words (no unigram) get the <unk> unigram or cost 99.

    ``order - 1`` hash-probe levels; the final level (always the empty
    context after the backoff chain bottoms out) is a dense row gather
    by word id, with the unknown-word fallback precomputed into the
    dense rows (see prepare_lookup) — identical results, two fewer
    probe gathers per call than the naive order+unk chain.
    """
    packed, bo_packed, rep, uni_packed = prep
    mask = tables.table_size - 1
    N = states.shape
    acc = jnp.zeros(N, jnp.float32)
    nxt = jnp.zeros(N, jnp.int32)
    found = jnp.zeros(N, jnp.bool_)
    cur = states
    P = tables.max_probe
    probes = jnp.arange(max(P, 1), dtype=jnp.int32)

    bucket_bits = tables.bucket_bits
    bsz = 1 << bucket_bits
    BH = tables.table_size >> bucket_bits if bucket_bits else 0

    def _pick_bucket(r, off, g8, w):
        # binary-select the w-int bucket at index ``off`` (< g8) from a
        # gathered 128-lane row (int32 selects: bit-safe carriers)
        rr = r.reshape(r.shape[:-1] + (g8, w))
        o = off
        while rr.shape[-2] > 1:
            bsel = (o & 1)[..., None, None]
            rr = jnp.where(bsel == 1, rr[..., 1::2, :], rr[..., 0::2, :])
            o = o >> 1
        return rr[..., 0, :]

    def probe_level(cur, words):
        if bucket_bits:
            hb = _hash_jax(cur, words, BH - 1)
            if rep is not None and rep.shape[1] == 2 * bsz * 4:
                rows = rep[hb].reshape(hb.shape + (2 * bsz, 4))
            elif rep is not None:
                g8 = rep.shape[1] // (bsz * 4)
                sh = g8.bit_length() - 1
                b2 = (hb + 1) & (BH - 1)
                r1 = _pick_bucket(rep[hb >> sh], hb & (g8 - 1), g8, bsz * 4)
                r2 = _pick_bucket(rep[b2 >> sh], b2 & (g8 - 1), g8, bsz * 4)
                rows = jnp.concatenate([r1, r2], axis=-1).reshape(
                    hb.shape + (2 * bsz, 4)
                )
            else:
                rows = jnp.concatenate(
                    [packed[hb], packed[(hb + 1) & (BH - 1)]], axis=-1
                ).reshape(hb.shape + (2 * bsz, 4))
        else:
            h = _hash_jax(cur, words, mask)
            if rep is not None:
                rows = rep[h].reshape(h.shape + (P, 4))  # one row gather
            else:
                rows = packed[(h[..., None] + probes) & mask]  # [..., P, 4]
        match = (rows[..., 0] == cur[..., None]) & (rows[..., 1] == words[..., None])
        # at most one window row can match (keys are unique in the table)
        hit_any = jnp.any(match, axis=-1)
        row = jnp.sum(jnp.where(match[..., None], rows, 0), axis=-2)
        hit_cost = jnp.where(
            hit_any, jax.lax.bitcast_convert_type(row[..., 2], jnp.float32), 0.0
        )
        hit_next = jnp.where(hit_any, row[..., 3], 0)
        return hit_cost, hit_next, hit_any

    for _level in range(tables.order - 1):
        hit_cost, hit_next, hit_any = probe_level(cur, words)
        new_hit = hit_any & ~found
        acc = jnp.where(new_hit, acc + hit_cost, acc)
        nxt = jnp.where(new_hit, hit_next, nxt)
        found = found | hit_any
        # back off where still unfound and not yet at the empty context
        can_bo = ~found & (cur != 0)
        bo = bo_packed[cur]  # 1 gather for (cost, state)
        acc = jnp.where(
            can_bo, acc + jax.lax.bitcast_convert_type(bo[..., 0], jnp.float32), acc
        )
        cur = jnp.where(can_bo, bo[..., 1], cur)

    # final level: dense unigram rows (sentinel row V = no-unigram default)
    V = uni_packed.shape[0] - 1
    urow = uni_packed[jnp.minimum(words, V)]  # [N, 2] row gather
    ucost = jax.lax.bitcast_convert_type(urow[..., 0], jnp.float32)
    acc = jnp.where(~found, acc + ucost, acc)
    nxt = jnp.where(~found, urow[..., 1], nxt)
    return acc, nxt


def lookup(
    tables: NgramTables, states: jnp.ndarray, words: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """One-shot lookup (standalone use; inside scan bodies call
    prepare_lookup once outside and lookup_prepared per step)."""
    return lookup_prepared(tables, prepare_lookup(tables), states, words)


def score_batch(tables: NgramTables, states: jnp.ndarray, words: jnp.ndarray):
    # not jitted: prepare_lookup builds its dense unigram table host-side
    # (decoders prepare once and jit lookup_prepared instead)
    return lookup(tables, states, words)


# ------------------------------------------------------------- image caching
def save_tables(tables: NgramTables, path: str) -> None:
    """Persist compiled LM tables (ref: the ARPA image caching —
    hash-table construction over millions of n-grams is a build step,
    not a startup step)."""
    np.savez_compressed(
        path,
        key_state=np.asarray(tables.key_state),
        key_word=np.asarray(tables.key_word),
        val_cost=np.asarray(tables.val_cost),
        val_next=np.asarray(tables.val_next),
        backoff_cost=np.asarray(tables.backoff_cost),
        backoff_state=np.asarray(tables.backoff_state),
        aux=np.array(
            [tables.order, tables.max_probe, tables.start_state,
             tables.end_word, tables.unk_word, tables.num_states,
             tables.bucket_bits],
            np.int64,
        ),
    )


def load_tables(path: str) -> NgramTables:
    data = np.load(path, allow_pickle=False)
    aux = data["aux"]
    return NgramTables(
        key_state=jnp.asarray(data["key_state"]),
        key_word=jnp.asarray(data["key_word"]),
        val_cost=jnp.asarray(data["val_cost"]),
        val_next=jnp.asarray(data["val_next"]),
        backoff_cost=jnp.asarray(data["backoff_cost"]),
        backoff_state=jnp.asarray(data["backoff_state"]),
        order=int(aux[0]),
        max_probe=int(aux[1]),
        start_state=int(aux[2]),
        end_word=int(aux[3]),
        unk_word=int(aux[4]),
        num_states=int(aux[5]),
        bucket_bits=int(aux[6]) if aux.shape[0] > 6 else 0,
    )
