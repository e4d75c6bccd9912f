"""Neural network acoustic models and the hybrid DNN-HMM scorer.

Re-implements the reference's NN layer (ref: src/Nn/NeuralNetwork.*,
NeuralNetworkLayer.* — layered FFNN with linear/bias/activation layers on
CPU/CUDA math) and its hybrid scorer
(ref: src/Nn/*FeatureScorer*, ``feature-scorer-type=nn-precomputed-hybrid``:
emission score = -log p(s|x) + kappa * log p(s), prior-divided, scaled).

Here the network is a flax module (this module needs flax); the CPU/GPU
backend switch of the reference collapses into XLA. The TF/Python bridge modules of the
reference (src/Tensorflow/, src/Nn/Python*) are unnecessary here — JAX
is already the native substrate.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np

from .scorer import FeatureScorer, register_scorer


_ACTS: dict = {
    "sigmoid": jax.nn.sigmoid,
    "relu": jax.nn.relu,
    "tanh": jnp.tanh,
    "gelu": jax.nn.gelu,
    "identity": lambda x: x,
}


class FeedForwardNet(nn.Module):
    """Hybrid FFNN over (spliced) frames: [..., D] -> [..., num_classes]
    logits. Mirrors the reference's linear+activation layer stack."""

    num_classes: int
    hidden: Sequence[int] = (512, 512)
    activation: str = "relu"
    dropout: float = 0.0
    #: computation dtype for the gemms (params stay f32). "bfloat16"
    #: runs the tensor cores at their native rate; logits come back f32.
    compute_dtype: str = "float32"

    @nn.compact
    def __call__(self, x, train: bool = False):
        act = _ACTS[self.activation]
        cdt = jnp.dtype(self.compute_dtype)
        for i, width in enumerate(self.hidden):
            x = nn.Dense(width, name=f"hidden{i}", dtype=cdt)(x)
            x = act(x)
            if self.dropout > 0.0 and train:
                x = nn.Dropout(rate=self.dropout, deterministic=False)(x)
        return nn.Dense(self.num_classes, name="output", dtype=cdt)(x).astype(
            jnp.float32
        )


class ConvFrontendNet(nn.Module):
    """Small conv+FFNN encoder over feature windows — the "modern
    frontend" alternative (the reference reaches comparable models only
    through its TF bridge)."""

    num_classes: int
    channels: Sequence[int] = (64, 64)
    hidden: Sequence[int] = (512,)
    activation: str = "relu"

    @nn.compact
    def __call__(self, x, train: bool = False):
        # x: [B, T, D] -> treat D as channel-less 1D conv over time
        act = _ACTS[self.activation]
        h = x
        for i, ch in enumerate(self.channels):
            h = nn.Conv(ch, kernel_size=(3,), padding="SAME", name=f"conv{i}")(h)
            h = act(h)
        for i, width in enumerate(self.hidden):
            h = nn.Dense(width, name=f"hidden{i}")(h)
            h = act(h)
        return nn.Dense(self.num_classes, name="output")(h)


class BlstmEncoderNet(nn.Module):
    """Bidirectional-LSTM acoustic encoder over whole utterances
    [B, T, D] -> [B, T, num_classes] logits (the recurrent hybrid
    acoustic model the reference reaches only through its TF bridge,
    ref: src/Tensorflow/ TF-based feature scorers / encoder models).

    Each direction is one ``nn.RNN`` (lax.scan over an
    OptimizedLSTMCell — gates batched into single gemms);
    the backward direction runs on the time-reversed sequence and
    re-reverses, and directions concatenate per layer like the
    standard BLSTM stack.
    """

    num_classes: int
    hidden: Sequence[int] = (256, 256)
    compute_dtype: str = "float32"  # "bfloat16": gate gemms in bf16

    @nn.compact
    def __call__(self, x, lengths=None, train: bool = False):
        h = x
        cdt = jnp.dtype(self.compute_dtype)
        for i, width in enumerate(self.hidden):
            fwd = nn.RNN(nn.OptimizedLSTMCell(width, dtype=cdt), name=f"fwd{i}")(
                h, seq_lengths=lengths
            )
            bwd = nn.RNN(
                nn.OptimizedLSTMCell(width, dtype=cdt), reverse=True,
                keep_order=True, name=f"bwd{i}",
            )(h, seq_lengths=lengths)
            h = jnp.concatenate([fwd, bwd], axis=-1)
        return nn.Dense(self.num_classes, name="output", dtype=cdt)(h).astype(
            jnp.float32
        )


class ConformerBlock(nn.Module):
    """One conformer block: ½FF -> MHSA -> conv module -> ½FF, all
    residual, final LayerNorm (Gulati et al. 2020; see PAPERS.md).

    Shape notes: every hot op is a gemm (QKV/out projections, FF
    mats, pointwise convs) or a short depthwise conv; attention uses a
    dense [B, 1, T, T] validity mask so padded frames neither attend
    nor are attended to (static shapes, no dynamic slicing)."""

    d_model: int
    num_heads: int = 4
    ff_mult: int = 4
    conv_kernel: int = 15
    dropout: float = 0.0
    compute_dtype: str = "float32"

    @nn.compact
    def __call__(self, x, pad_mask, attn_mask, train: bool = False):
        det = not (train and self.dropout > 0.0)
        cdt = jnp.dtype(self.compute_dtype)

        def drop(h):
            if self.dropout > 0.0:
                h = nn.Dropout(rate=self.dropout, deterministic=det)(h)
            return h

        def ff(h, name):
            # LayerNorms stay f32 (bf16 moment accumulation is unstable);
            # the gemms around them run in compute_dtype
            h = nn.LayerNorm(name=f"{name}_ln", dtype=jnp.float32)(h)
            h = nn.Dense(self.d_model * self.ff_mult, name=f"{name}_in", dtype=cdt)(h)
            h = nn.swish(h)
            h = drop(h)
            return drop(nn.Dense(self.d_model, name=f"{name}_out", dtype=cdt)(h))

        x = x + 0.5 * ff(x, "ff1")
        # ---- multi-head self-attention over valid frames only
        h = nn.LayerNorm(name="mhsa_ln", dtype=jnp.float32)(x)
        h = nn.MultiHeadDotProductAttention(
            num_heads=self.num_heads, name="mhsa", dtype=cdt,
            dropout_rate=self.dropout, deterministic=det,
            force_fp32_for_softmax=True,
        )(h, h, mask=attn_mask)
        x = x + drop(h)
        # ---- convolution module (pointwise GLU -> depthwise -> pointwise)
        h = nn.LayerNorm(name="conv_ln", dtype=jnp.float32)(x)
        h = nn.Dense(2 * self.d_model, name="conv_in", dtype=cdt)(h)
        h = nn.glu(h, axis=-1)
        # zero padded frames so the depthwise window never reads them
        h = h * pad_mask.astype(h.dtype)
        h = nn.Conv(
            self.d_model, kernel_size=(self.conv_kernel,), padding="SAME",
            feature_group_count=self.d_model, name="conv_dw", dtype=cdt,
        )(h)
        h = nn.swish(nn.LayerNorm(name="conv_bn", dtype=jnp.float32)(h))
        h = nn.Dense(self.d_model, name="conv_out", dtype=cdt)(h)
        x = x + drop(h * pad_mask.astype(h.dtype))
        x = x + 0.5 * ff(x, "ff2")
        return nn.LayerNorm(name="final_ln", dtype=jnp.float32)(x)


class ConformerEncoderNet(nn.Module):
    """Conformer acoustic encoder [B, T, D] -> [B, T, num_classes]
    logits — the attention-based hybrid acoustic model (the reference
    reaches encoder-only acoustic models solely through its TF bridge,
    ref: src/Tensorflow/ feature scorers; here it is native flax/XLA).

    Frame-synchronous on purpose: no time subsampling, because the
    hybrid decoder and the HMM topology consume scores at the feature
    frame rate ([B, T, M] aligned 1:1 with frames). Positional
    information enters as sinusoidal encodings added before the block
    stack (absolute; the depthwise conv modules add local relative
    structure). With ``lengths`` given, padded frames are masked out of
    attention AND the conv modules, so batched ragged scoring equals
    per-utterance scoring on the valid prefix."""

    num_classes: int
    d_model: int = 256
    num_blocks: int = 4
    num_heads: int = 4
    ff_mult: int = 4
    conv_kernel: int = 15
    dropout: float = 0.0
    #: "bfloat16" runs every gemm/conv at the bf16 tensor-core rate;
    #: params and LayerNorms stay f32, logits return f32
    compute_dtype: str = "float32"

    @nn.compact
    def __call__(self, x, lengths=None, train: bool = False):
        B, T, _ = x.shape
        if lengths is None:
            valid = jnp.ones((B, T), bool)
        else:
            valid = jnp.arange(T)[None, :] < lengths[:, None]
        pad_mask = valid[..., None].astype(x.dtype)  # [B, T, 1]
        attn_mask = (valid[:, None, None, :] & valid[:, None, :, None])

        cdt = jnp.dtype(self.compute_dtype)
        h = nn.Dense(self.d_model, name="input_proj", dtype=cdt)(x)
        # sinusoidal positions (static shapes: computed at trace time)
        pos = jnp.arange(T, dtype=jnp.float32)[:, None]
        dim = jnp.arange(self.d_model // 2, dtype=jnp.float32)[None, :]
        ang = pos / jnp.power(10000.0, 2.0 * dim / self.d_model)
        pe = jnp.concatenate([jnp.sin(ang), jnp.cos(ang)], axis=-1)
        h = h + pe[None, :, : self.d_model].astype(h.dtype)
        for i in range(self.num_blocks):
            h = ConformerBlock(
                d_model=self.d_model, num_heads=self.num_heads,
                ff_mult=self.ff_mult, conv_kernel=self.conv_kernel,
                dropout=self.dropout, name=f"block{i}",
                compute_dtype=self.compute_dtype,
            )(h, pad_mask, attn_mask, train=train)
        return nn.Dense(self.num_classes, name="output", dtype=cdt)(
            h * pad_mask.astype(h.dtype)
        ).astype(jnp.float32)


@dataclasses.dataclass
class StatePriors:
    """Class priors for hybrid scoring (ref: src/Nn/Prior.* — estimated
    from alignment label counts or model marginals)."""

    log_priors: np.ndarray  # [M] natural-log priors

    @classmethod
    def from_counts(cls, counts: np.ndarray, smoothing: float = 1.0) -> "StatePriors":
        c = np.asarray(counts, np.float64) + smoothing
        return cls(np.log(c / c.sum()).astype(np.float32))

    def save(self, path: str) -> None:
        np.save(path if path.endswith(".npy") else path + ".npy", self.log_priors)

    @classmethod
    def load(cls, path: str) -> "StatePriors":
        return cls(np.load(path if path.endswith(".npy") else path + ".npy"))


class NnHybridScorer(FeatureScorer):
    """DNN posteriors -> emission scores:
    score(s|x) = am_scale * (-log p(s|x) + prior_scale * log p(s)).
    """

    def __init__(
        self,
        model: nn.Module,
        params,
        priors: StatePriors,
        scale: float = 1.0,
        prior_scale: float = 1.0,
    ):
        self.model = model
        self.params = params
        self.log_priors = jnp.asarray(priors.log_priors)
        self.scale = scale
        self.prior_scale = prior_scale
        self.num_classes = priors.log_priors.shape[0]
        # length-aware encoders (BLSTM, Conformer) take the valid frame
        # counts so batched ragged scoring matches unbatched scoring
        import inspect

        self._takes_lengths = "lengths" in inspect.signature(
            type(model).__call__
        ).parameters
        # params ride as jit ARGUMENTS, not closure constants: baked-in
        # constants bloat the compiled program by the full weight size
        # (a 70M-param conformer = 280MB of HLO literals — remote
        # compile services reject it) and defeat donation/sharding
        self._params_dev = jax.tree_util.tree_map(jnp.asarray, self.params)
        self._jit = jax.jit(self._score)
        self._jit_len = jax.jit(self._score_len)

    def _score(self, params, feats: jnp.ndarray) -> jnp.ndarray:
        logits = self.model.apply({"params": params}, feats)
        logp = jax.nn.log_softmax(logits, axis=-1)
        return self.scale * (-(logp - self.prior_scale * self.log_priors))

    def _score_len(self, params, feats: jnp.ndarray, lengths: jnp.ndarray):
        logits = self.model.apply(
            {"params": params}, feats, lengths=lengths
        )
        logp = jax.nn.log_softmax(logits, axis=-1)
        return self.scale * (-(logp - self.prior_scale * self.log_priors))

    def score(self, feats: jnp.ndarray, lengths=None) -> jnp.ndarray:
        if lengths is not None and self._takes_lengths:
            return self._jit_len(
                self._params_dev, jnp.asarray(feats), jnp.asarray(lengths)
            )
        return self._jit(self._params_dev, jnp.asarray(feats))


register_scorer("nn-precomputed-hybrid")(NnHybridScorer)
register_scorer("nn-hybrid")(NnHybridScorer)
