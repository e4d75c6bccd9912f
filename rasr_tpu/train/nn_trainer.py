"""Supervised NN training on alignment labels (hybrid DNN-HMM).

Re-implements the reference's feed-forward trainer
(ref: src/Nn/FeedForwardTrainer.*, Nn::BufferedAlignedFeatureProcessor —
minibatch SGD backprop with cross-entropy against forced-alignment state
labels, seeded shuffled minibatch assembly from feature+alignment caches,
L2 regularization, learning-rate schedules, state-prior estimation).

On the device: frames from an utterance batch are flattened and shuffled
once per epoch with a seeded permutation (reproducible like the
reference's seeded shuffling), minibatches are fixed-shape slices, the
update step is one jitted optax transaction, and data parallelism comes
from sharding the minibatch over the mesh (psum'd grads via jit sharding
— replacing the reference's single-process SGD).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Iterator, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
from flax import serialization

from ..models.nn import StatePriors


@dataclasses.dataclass
class TrainConfig:
    batch_size: int = 256
    learning_rate: float = 1e-3
    momentum: float = 0.9
    l2: float = 0.0
    optimizer: str = "momentum"  # sgd | momentum | adam
    epochs: int = 1
    seed: int = 0
    #: "constant", or "newbob" (ref: the classic relevance-driven
    #: learning-rate control of RASR/RETURNN hybrid training): when the
    #: control loss (dev set if given, else train) improves by less than
    #: ``newbob_threshold`` (relative), the learning rate multiplies by
    #: ``newbob_decay`` for the following epochs.
    lr_schedule: str = "constant"
    newbob_decay: float = 0.5
    newbob_threshold: float = 0.01


def make_optimizer(cfg: TrainConfig) -> optax.GradientTransformation:
    def base(learning_rate):
        if cfg.optimizer == "sgd":
            opt = optax.sgd(learning_rate)
        elif cfg.optimizer == "momentum":
            opt = optax.sgd(learning_rate, momentum=cfg.momentum)
        elif cfg.optimizer == "adam":
            opt = optax.adam(learning_rate)
        else:
            raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
        if cfg.l2 > 0:
            opt = optax.chain(optax.add_decayed_weights(cfg.l2), opt)
        return opt

    if cfg.lr_schedule == "newbob":
        # learning_rate lives in opt_state.hyperparams: epoch-boundary
        # decay updates it without retracing the jitted step
        return optax.inject_hyperparams(base)(learning_rate=cfg.learning_rate)
    if cfg.lr_schedule != "constant":
        raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}")
    return base(cfg.learning_rate)


def newbob_step(cfg: TrainConfig, opt_state, prev_loss, cur_loss):
    """Epoch-boundary newbob control: decay the injected learning rate
    when the relative improvement of the control loss is below threshold.
    Returns (opt_state, new_prev_loss, new_lr or None)."""
    if cfg.lr_schedule != "newbob" or prev_loss is None:
        return opt_state, cur_loss, None
    rel = (prev_loss - cur_loss) / max(abs(prev_loss), 1e-12)
    if rel >= cfg.newbob_threshold:
        return opt_state, cur_loss, None
    lr = float(opt_state.hyperparams["learning_rate"]) * cfg.newbob_decay
    opt_state = opt_state._replace(
        hyperparams={**opt_state.hyperparams, "learning_rate": jnp.asarray(lr)}
    )
    return opt_state, cur_loss, lr


class FrameDataset:
    """Flattened (feature, label, weight) frames from aligned utterances
    (the reference's buffered aligned-feature processor, minus the
    cache-streaming: whole-corpus tensors live in host RAM / HBM)."""

    def __init__(self, feats: np.ndarray, labels: np.ndarray,
                 weights: Optional[np.ndarray] = None):
        feats = np.asarray(feats)
        labels = np.asarray(labels)
        if feats.ndim == 3:
            feats = feats.reshape(-1, feats.shape[-1])
            labels = labels.reshape(-1)
            if weights is not None:
                weights = np.asarray(weights).reshape(-1)
        valid = labels >= 0
        self.feats = feats[valid].astype(np.float32)
        self.labels = labels[valid].astype(np.int32)
        self.weights = (
            weights[valid].astype(np.float32) if weights is not None
            else np.ones(self.labels.shape[0], np.float32)
        )

    def __len__(self) -> int:
        return self.labels.shape[0]

    def minibatches(self, batch_size: int, seed: int) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        perm = np.random.default_rng(seed).permutation(len(self))
        n_full = len(self) // batch_size
        for i in range(n_full):
            idx = perm[i * batch_size : (i + 1) * batch_size]
            yield self.feats[idx], self.labels[idx], self.weights[idx]

    def label_counts(self, num_classes: int) -> np.ndarray:
        return np.bincount(self.labels, weights=self.weights, minlength=num_classes)


class NnTrainer:
    def __init__(self, model, num_classes: int, cfg: TrainConfig = TrainConfig()):
        self.model = model
        self.num_classes = num_classes
        self.cfg = cfg
        self.opt = make_optimizer(cfg)
        self._step = jax.jit(self._update)
        self._eval = jax.jit(self._loss)

    def init_params(self, input_dim: int, seed: Optional[int] = None):
        rng = jax.random.PRNGKey(self.cfg.seed if seed is None else seed)
        dummy = jnp.zeros((2, input_dim), jnp.float32)
        return self.model.init(rng, dummy)["params"]

    def _loss(self, params, x, y, w):
        logits = self.model.apply({"params": params}, x)
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, y)
        acc = (jnp.argmax(logits, -1) == y).astype(jnp.float32)
        wsum = jnp.maximum(w.sum(), 1e-6)
        return (ce * w).sum() / wsum, (acc * w).sum() / wsum

    def _update(self, params, opt_state, x, y, w):
        (loss, acc), grads = jax.value_and_grad(self._loss, has_aux=True)(params, x, y, w)
        updates, opt_state = self.opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss, acc

    def train(
        self,
        dataset: FrameDataset,
        params=None,
        log=None,
        ckpt=None,  # train.checkpoint.CheckpointManager
        ckpt_every: int = 0,  # full-state checkpoint every N steps (0 = per epoch)
        resume: bool = False,  # restore the latest checkpoint and continue
        dev: Optional["FrameDataset"] = None,  # newbob control set
    ):
        """Run the SGD schedule; optionally checkpoint/resume MID-EPOCH.

        The reference resumes only at stage granularity (weight file per
        epoch; SURVEY §5 checkpoint/resume). Here the full training state
        (params + optimizer + epoch + minibatch cursor) checkpoints every
        ``ckpt_every`` steps; because minibatch assembly is a seeded
        permutation (like the reference's seeded shuffling), resuming at
        (epoch, batch) replays the exact remaining schedule — an
        interrupted run converges to bitwise the same parameters.
        """
        if params is None:
            params = self.init_params(dataset.feats.shape[1])
        opt_state = self.opt.init(params)
        start_epoch, start_batch, gstep = 0, 0, 0
        if resume and ckpt is not None and ckpt.latest_step() is not None:
            (params, opt_state), meta = ckpt.restore((params, opt_state))
            start_epoch = int(meta.get("epoch", 0))
            start_batch = int(meta.get("batch", 0))
            gstep = int(meta["step"])
            if log is not None:
                log("nn resume", epoch=start_epoch, batch=start_batch, step=gstep)
        stats = []
        self._newbob_prev = None
        for epoch in range(start_epoch, self.cfg.epochs):
            losses, accs = [], []
            skip = start_batch if epoch == start_epoch else 0
            for bi, (x, y, w) in enumerate(
                dataset.minibatches(self.cfg.batch_size, self.cfg.seed + epoch)
            ):
                if bi < skip:
                    continue
                params, opt_state, loss, acc = self._step(
                    params, opt_state, jnp.asarray(x), jnp.asarray(y), jnp.asarray(w)
                )
                losses.append(float(loss))
                accs.append(float(acc))
                gstep += 1
                if ckpt is not None and ckpt_every and gstep % ckpt_every == 0:
                    ckpt.save(
                        gstep, (params, opt_state),
                        {"epoch": epoch, "batch": bi + 1},
                    )
            rec = {
                "epoch": epoch,
                "loss": float(np.mean(losses)) if losses else 0.0,
                "frame_accuracy": float(np.mean(accs)) if accs else 0.0,
            }
            if dev is not None:
                dl, da = [], []
                for x, y, w in dev.minibatches(self.cfg.batch_size, 0):
                    loss, acc = self._eval(
                        params, jnp.asarray(x), jnp.asarray(y), jnp.asarray(w)
                    )
                    dl.append(float(loss))
                    da.append(float(acc))
                rec["dev_loss"] = float(np.mean(dl)) if dl else 0.0
                rec["dev_frame_accuracy"] = float(np.mean(da)) if da else 0.0
            control = rec.get("dev_loss", rec["loss"])
            opt_state, prev_control, new_lr = newbob_step(
                self.cfg, opt_state, getattr(self, "_newbob_prev", None), control
            )
            self._newbob_prev = prev_control
            if new_lr is not None:
                rec["learning_rate"] = new_lr
            stats.append(rec)
            if ckpt is not None:
                ckpt.save(gstep, (params, opt_state), {"epoch": epoch + 1, "batch": 0})
            if log is not None:
                log("nn epoch", **rec)
        return params, stats

    # -------------------------------------------------------------- priors
    def estimate_priors(self, dataset: FrameDataset) -> StatePriors:
        return StatePriors.from_counts(dataset.label_counts(self.num_classes))

    # ------------------------------------------------------------ artifacts
    @staticmethod
    def save_params(params, path: str) -> None:
        with open(path, "wb") as fh:
            fh.write(serialization.to_bytes(params))

    @staticmethod
    def load_params(template, path: str):
        with open(path, "rb") as fh:
            return serialization.from_bytes(template, fh.read())


class SequenceTrainer(NnTrainer):
    """Utterance-level trainer for recurrent encoders (BLSTM hybrid):
    minibatches are whole padded utterances [b, T, D] with framewise
    labels [b, T] (-1 on padding), CE masked over valid frames. The
    reference trains such models only through its TF/RETURNN bridge;
    here it is the same optax transaction as the frame trainer."""

    def init_params(self, input_dim: int, seed: Optional[int] = None):
        rng = jax.random.PRNGKey(self.cfg.seed if seed is None else seed)
        dummy = jnp.zeros((2, 4, input_dim), jnp.float32)
        return self.model.init(rng, dummy)["params"]

    def _loss(self, params, x, y, w):
        # valid length per row from the label padding (-1 tail), passed
        # to length-aware encoders (BLSTM, Conformer) so padded frames
        # are masked out of recurrence/attention, not just out of the CE
        T = y.shape[1]
        lengths = T - jnp.argmax((y >= 0)[:, ::-1], axis=1)
        logits = self.model.apply(
            {"params": params}, x, lengths=lengths
        )  # [b, T, C]
        valid = (y >= 0) & (w > 0)
        yc = jnp.maximum(y, 0)
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, yc)
        acc = (jnp.argmax(logits, -1) == yc).astype(jnp.float32)
        m = valid.astype(jnp.float32) * w
        msum = jnp.maximum(m.sum(), 1e-6)
        return (ce * m).sum() / msum, (acc * m).sum() / msum

    def train_sequences(
        self, feats: np.ndarray, labels: np.ndarray, params=None, log=None,
        batch_size: int = 8,
    ):
        """feats [N, T, D], labels [N, T] (-1 = padding/unlabeled)."""
        feats = np.asarray(feats, np.float32)
        labels = np.asarray(labels, np.int32)
        if params is None:
            params = self.init_params(feats.shape[-1])
        opt_state = self.opt.init(params)
        N = feats.shape[0]
        stats = []
        prev_control = None
        for epoch in range(self.cfg.epochs):
            perm = np.random.default_rng(self.cfg.seed + epoch).permutation(N)
            losses, accs = [], []
            for i in range(0, N - batch_size + 1, batch_size):
                sel = perm[i : i + batch_size]
                x = jnp.asarray(feats[sel])
                y = jnp.asarray(labels[sel])
                w = jnp.ones(y.shape, jnp.float32)
                params, opt_state, loss, acc = self._step(params, opt_state, x, y, w)
                losses.append(float(loss))
                accs.append(float(acc))
            rec = {
                "epoch": epoch,
                "loss": float(np.mean(losses)) if losses else 0.0,
                "frame_accuracy": float(np.mean(accs)) if accs else 0.0,
            }
            opt_state, prev_control, new_lr = newbob_step(
                self.cfg, opt_state, prev_control, rec["loss"]
            )
            if new_lr is not None:
                rec["learning_rate"] = new_lr
            stats.append(rec)
            if log is not None:
                log("nn sequence epoch", **rec)
        return params, stats


class LfMmiSequenceTrainer(SequenceTrainer):
    """Sequence-discriminative NN training: the LF-MMI objective
    differentiated through the encoder (ref: the sequence-discriminative
    MMI/sMBR training of RASR/NN [Wiesler et al., ICASSP 2014] — there
    lattice-based via the TF bridge; here the lattice-free formulation
    of train/lfmmi.py composed with the flax encoder, the whole gradient
    — numerator-minus-denominator occupancies chained through the
    network — by autodiff end to end, no hand-written backward pass).

    Per utterance: loss = (num_total - den_total) / frames
                          + ce_weight * framewise CE   (optional anchor)
    or, with criterion="smbr", the state-level minimum-Bayes-risk
    objective loss = -E[frame accuracy]/frames over the denominator
    posterior (train/lfmmi.expected_accuracy; needs alignment labels)
    with emissions = -am_scale * log_softmax(logits) — the hybrid
    scorer's posterior costs (state priors cancel between numerator and
    denominator). The numerator rides the utterance's banded linear
    alignment graph (align/graph.py), the denominator the dense phone-LM
    graph (train/lfmmi.build_phone_bigram_den).
    """

    def __init__(self, model, num_classes: int, den_fsa,
                 cfg: TrainConfig = TrainConfig(), am_scale: float = 1.0,
                 ce_weight: float = 0.0, criterion: str = "mmi",
                 class_map=None):
        super().__init__(model, num_classes, cfg)
        if criterion not in ("mmi", "smbr"):
            raise ValueError(f"unknown sequence criterion: {criterion}")
        self.den_fsa = den_fsa
        self.am_scale = am_scale
        self.ce_weight = ce_weight
        self.criterion = criterion
        #: optional [num_classes] coarser accuracy unit (phone id) for
        #: the smbr criterion — MPE-style phone accuracy (tiny, rides as
        #: a jit closure constant)
        self.class_map = (
            None if class_map is None else jnp.asarray(class_map, jnp.int32)
        )
        self._mmi_step = jax.jit(self._mmi_update)

    def _mmi_loss(self, params, x, y, n_frames,
                  g_cls, g_loop, g_fwd, g_skip, g_init, g_final):
        from ..ops.viterbi import forward_backward
        from .lfmmi import dense_forward, expected_accuracy

        logits = self.model.apply({"params": params}, x, lengths=n_frames)
        emis = -self.am_scale * jax.nn.log_softmax(logits, axis=-1)
        frames = jnp.maximum(jnp.sum(n_frames), 1)
        if self.criterion == "smbr":
            # state-level sMBR: maximize the den-posterior expected
            # per-frame accuracy vs the alignment labels y
            acc = expected_accuracy(
                emis, self.den_fsa, n_frames, y, class_map=self.class_map
            )
            mmi = -jnp.sum(acc) / frames
        else:
            num_emis = jnp.take_along_axis(emis, g_cls[:, None, :], axis=2)
            num_total, _ = forward_backward(
                num_emis, g_loop, g_fwd, g_skip, g_init, g_final, n_frames
            )
            den_total = dense_forward(emis, self.den_fsa, n_frames)
            mmi = jnp.sum(num_total - den_total) / frames
        loss = mmi
        if self.ce_weight > 0.0:
            valid = y >= 0
            yc = jnp.maximum(y, 0)
            ce = optax.softmax_cross_entropy_with_integer_labels(logits, yc)
            m = valid.astype(jnp.float32)
            loss = loss + self.ce_weight * (ce * m).sum() / jnp.maximum(m.sum(), 1e-6)
        return loss, mmi

    def _mmi_update(self, params, opt_state, x, y, n_frames, *graphs):
        (loss, mmi), grads = jax.value_and_grad(self._mmi_loss, has_aux=True)(
            params, x, y, n_frames, *graphs
        )
        updates, opt_state = self.opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, mmi

    def train_lfmmi(
        self,
        feats: np.ndarray,  # [N, T, D] padded utterances
        graphs,  # numerator alignment graphs (align/graph.LinearGraph)
        n_frames: np.ndarray,  # [N]
        labels: Optional[np.ndarray] = None,  # [N, T] for the CE anchor
        params=None,
        log=None,
        batch_size: int = 8,
    ):
        from ..align.aligner import _pad_graphs

        feats = np.asarray(feats, np.float32)
        n_frames = np.asarray(n_frames, np.int32)
        if labels is None:
            labels = np.full(feats.shape[:2], -1, np.int32)
        if params is None:
            params = self.init_params(feats.shape[-1])
        opt_state = self.opt.init(params)
        N = feats.shape[0]
        if self.criterion == "smbr":
            # the sMBR objective never reads the numerator graphs —
            # feed 1-state dummies instead of padding the real ones
            g_cls = jnp.zeros((N, 1), jnp.int32)
            g_loop = g_fwd = g_skip = jnp.full((N, 1), 1e30, jnp.float32)
            g_init = g_final = jnp.zeros((N, 1), jnp.float32)
        else:
            g_cls, g_loop, g_fwd, g_skip, g_init, g_final = (
                jnp.asarray(a) for a in _pad_graphs(graphs)
            )
        stats = []
        batch_size = min(batch_size, N)
        for epoch in range(self.cfg.epochs):
            perm = np.random.default_rng(self.cfg.seed + epoch).permutation(N)
            losses, mmis = [], []
            # drop-last keeps every _mmi_step call the same shape (one
            # jit trace; ragged tails would retrace — see train_sequences)
            for i in range(0, N - batch_size + 1, batch_size):
                sel = perm[i : i + batch_size]
                params, opt_state, loss, mmi = self._mmi_step(
                    params, opt_state,
                    jnp.asarray(feats[sel]), jnp.asarray(labels[sel]),
                    jnp.asarray(n_frames[sel]),
                    g_cls[sel], g_loop[sel], g_fwd[sel], g_skip[sel],
                    g_init[sel], g_final[sel],
                )
                losses.append(float(loss))
                mmis.append(float(mmi))
            # per-criterion stat name: under "mmi" this is the MMI
            # objective per frame; under "smbr" it is -E[acc]/frame
            rec = {
                "epoch": epoch,
                "loss": float(np.mean(losses)),
                f"{self.criterion}_per_frame": float(np.mean(mmis)),
            }
            stats.append(rec)
            if log is not None:
                log("nn lfmmi epoch", **rec)
        return params, stats
