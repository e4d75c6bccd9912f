"""Recurrent neural language model with hidden-state caching.

Re-implements the role of the reference's neural LM integration
(ref: src/Lm/TF* — Lm::TFRecurrentLanguageModel [MODULE_LM_TF]: a
TensorFlow RNN LM driven from C++ with interned histories, per-history
hidden-state caching and batched score requests). JAX is the native
substrate here, so the "bridge" disappears: the model is a plain-array
LSTM (:func:`lstm_cell`, trained with optax), histories are word-id
tuples memoizing their hidden state, and scoring batches jit-compile.

Primary uses: n-best/lattice rescoring (lattice/flf.rescore_lm accepts
any LanguageModel), log-linear combination with the n-gram LM, and
first-pass fusion (search/rnn_fusion.py reads the same parameters).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from .interface import History, LanguageModel

#: f32 products at full precision: a GPU runs f32 matmuls in TF32 by
#: default, and fused scores feed exact recombination
_HIGHEST = jax.lax.Precision.HIGHEST

#: parameter names of the model (a flat dict of arrays):
#: embed [V, E]; wx [E, 4H]; wh [H, 4H]; b [4H]; proj_w [H, V]; proj_b [V]
PARAM_NAMES = ("embed", "wx", "wh", "b", "proj_w", "proj_b")


def lstm_cell(wx, wh, b, x, c, h):
    """One LSTM step: x [..., E], c/h [..., H] -> (c', h').

    Gate order [i, f, g, o] (sigmoid i/f/o, tanh g), one bias on the
    summed gates — the math of flax's ``LSTMCell``."""
    H = wh.shape[0]
    gates = (
        jnp.matmul(x, wx, precision=_HIGHEST)
        + jnp.matmul(h, wh, precision=_HIGHEST)
        + b
    )
    i = jax.nn.sigmoid(gates[..., :H])
    f = jax.nn.sigmoid(gates[..., H : 2 * H])
    g = jnp.tanh(gates[..., 2 * H : 3 * H])
    o = jax.nn.sigmoid(gates[..., 3 * H :])
    c2 = f * c + i * g
    return c2, o * jnp.tanh(c2)


def init_params(key, vocab_size: int, embed_dim: int, hidden_dim: int):
    """Random parameters (normal embeddings, LeCun-normal input and
    projection kernels, orthogonal recurrent kernel, zero biases)."""
    k_emb, k_x, k_h, k_p = jax.random.split(key, 4)
    lecun = jax.nn.initializers.lecun_normal()
    orth = jax.nn.initializers.orthogonal()
    wh = jnp.concatenate(
        [orth(k, (hidden_dim, hidden_dim)) for k in jax.random.split(k_h, 4)],
        axis=1,
    )
    return {
        "embed": jax.random.normal(k_emb, (vocab_size, embed_dim)),
        "wx": lecun(k_x, (embed_dim, 4 * hidden_dim)),
        "wh": wh,
        "b": jnp.zeros(4 * hidden_dim),
        "proj_w": lecun(k_p, (hidden_dim, vocab_size)),
        "proj_b": jnp.zeros(vocab_size),
    }


def forward(params, tokens, carry=None):
    """tokens [B, T] -> (logits [B, T, V], final carry (c, h))."""
    B = tokens.shape[0]
    H = params["wh"].shape[0]
    if carry is None:
        carry = (jnp.zeros((B, H)), jnp.zeros((B, H)))
    emb = params["embed"][tokens]  # [B, T, E]

    def step(ch, x):
        c, h = lstm_cell(params["wx"], params["wh"], params["b"], x, *ch)
        return (c, h), h

    carry, hs = jax.lax.scan(step, carry, jnp.swapaxes(emb, 0, 1))
    logits = (
        jnp.matmul(jnp.swapaxes(hs, 0, 1), params["proj_w"], precision=_HIGHEST)
        + params["proj_b"]
    )
    return logits, carry


class RnnLm(LanguageModel):
    """LSTM LM with per-history hidden-state cache (bounded LRU-ish)."""

    def __init__(self, params, vocab: Dict[str, int], cache_size: int = 10000):
        self.params = params
        self.vocab = dict(vocab)
        self.inv_vocab = {i: w for w, i in vocab.items()}
        self._bos = vocab.get("<s>", 0)
        self._cache: Dict[History, Tuple] = {}
        self._cache_size = cache_size
        self._step = jax.jit(self._step_impl)

    @property
    def embed_dim(self) -> int:
        return self.params["embed"].shape[1]

    @property
    def hidden_dim(self) -> int:
        return self.params["wh"].shape[0]

    @staticmethod
    def _step_impl(params, token, carry):
        logits, new_carry = forward(params, token[None, None], carry)
        return jax.nn.log_softmax(logits[0, 0]), new_carry

    def _state_of(self, history: History):
        if history in self._cache:
            return self._cache[history]
        if not history:
            # feed <s>
            logp, carry = self._step(self.params, jnp.asarray(self._bos), self._init_carry())
        else:
            prev_logp, prev_carry = self._state_of(history[:-1])
            logp, carry = self._step(self.params, jnp.asarray(history[-1]), prev_carry)
        if len(self._cache) >= self._cache_size:
            self._cache.pop(next(iter(self._cache)))
        self._cache[history] = (logp, carry)
        return self._cache[history]

    def _init_carry(self):
        z = jnp.zeros((1, self.hidden_dim))
        return (z, z)

    # ------------------------------------------------------------ LM api
    def start_history(self) -> History:
        return ()

    def extended_history(self, history: History, word: int) -> History:
        if word not in self.inv_vocab:  # OOV: fixed penalty, no context
            return tuple(history)
        return tuple(history) + (word,)

    def score(self, history: History, word: int) -> float:
        if word not in self.inv_vocab:
            return 99.0
        logp, _ = self._state_of(tuple(history))
        return float(-logp[word])

    def word_id(self, token: str) -> int:
        # OOV-safe (there is no trained <unk> embedding): -1 scores as a
        # fixed penalty and leaves the history unchanged, so generic
        # consumers (perplexity, rescoring) never crash on unseen words
        return self.vocab.get(token, -1)

    # ------------------------------------------------------------ artifacts
    def save(self, path: str) -> None:
        """Persist params + vocab (``<path>.npz`` beside a ``<path>.json``
        header), the LM-image analog of the n-gram .lmbin (ref: the
        reference's reloadable NN-LM graphs/checkpoints)."""
        import json

        with open(path + ".json", "w") as fh:
            json.dump({"vocab": self.vocab}, fh)
        with open(path + ".npz", "wb") as fh:
            np.savez(fh, **{k: np.asarray(self.params[k]) for k in PARAM_NAMES})

    @classmethod
    def load(cls, path: str, cache_size: int = 10000) -> "RnnLm":
        import json

        with open(path + ".json") as fh:
            meta = json.load(fh)
        vocab = {w: int(i) for w, i in meta["vocab"].items()}
        with np.load(path + ".npz") as data:
            params = {k: jnp.asarray(data[k]) for k in PARAM_NAMES}
        return cls(params, vocab, cache_size=cache_size)

    # ------------------------------------------------------------ training
    @classmethod
    def train_from_text(
        cls,
        sentences: Sequence[Sequence[str]],
        embed_dim: int = 32,
        hidden_dim: int = 64,
        epochs: int = 10,
        learning_rate: float = 0.05,
        seed: int = 0,
    ) -> "RnnLm":
        vocab = {"<s>": 0, "</s>": 1}
        for sent in sentences:
            for tok in sent:
                vocab.setdefault(tok, len(vocab))
        V = len(vocab)
        seqs = [
            [vocab["<s>"]] + [vocab[t] for t in sent] + [vocab["</s>"]]
            for sent in sentences
        ]
        T = max(len(s) for s in seqs)
        tokens = np.full((len(seqs), T), vocab["</s>"], np.int32)
        mask = np.zeros((len(seqs), T), np.float32)
        for i, s in enumerate(seqs):
            tokens[i, : len(s)] = s
            mask[i, 1 : len(s)] = 1.0  # predict positions 1..len-1
        params = init_params(jax.random.PRNGKey(seed), V, embed_dim, hidden_dim)
        opt = optax.adam(learning_rate)
        opt_state = opt.init(params)

        @jax.jit
        def train_step(params, opt_state, tokens, mask):
            def loss_fn(p):
                logits, _ = forward(p, tokens[:, :-1])
                targets = tokens[:, 1:]
                ce = optax.softmax_cross_entropy_with_integer_labels(logits, targets)
                m = mask[:, 1:]
                return (ce * m).sum() / jnp.maximum(m.sum(), 1.0)

            loss, grads = jax.value_and_grad(loss_fn)(params)
            updates, opt_state = opt.update(grads, opt_state)
            return optax.apply_updates(params, updates), opt_state, loss

        tk = jnp.asarray(tokens)
        mk = jnp.asarray(mask)
        for _ in range(epochs):
            params, opt_state, loss = train_step(params, opt_state, tk, mk)
        return cls(params, vocab)
