"""Device mesh + sharding helpers.

The reference has no in-process distribution at all — scale-out is N
independent jobs over corpus partitions with results merged via files
(SURVEY §2.8). The replacement here is a first-class component:
a ``(data, model)`` mesh where

* utterance batches shard over ``data`` (DP — the reference's corpus
  partitioning, now with ``psum`` instead of accumulator-file merges);
* the GMM density inventory / NN hidden dims shard over ``model`` (TP —
  new; BASELINE: "GMM inventory exceeding one chip's HBM shards by
  mixture block with scores allgathered over ICI").

Multi-host initialization wraps ``jax.distributed`` (jax handles the
ICI/DCN split given the device set).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    data: Optional[int] = None,
    model: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a (data, model) mesh over the available devices."""
    devs = list(devices if devices is not None else jax.devices())
    if data is None:
        data = len(devs) // model
    assert data * model == len(devs), (
        f"mesh {data}x{model} != {len(devs)} devices"
    )
    arr = np.array(devs).reshape(data, model)
    return Mesh(arr, ("data", "model"))


def init_distributed(coordinator: Optional[str] = None, **kwargs) -> None:
    """Multi-host bring-up (ref replacement for job-level scale-out)."""
    if coordinator is not None:
        jax.distributed.initialize(coordinator_address=coordinator, **kwargs)
    elif kwargs:
        jax.distributed.initialize(**kwargs)


# ------------------------------------------------------------------ shardings
def data_sharding(mesh: Mesh) -> NamedSharding:
    """Batch-dim sharding for [B, ...] utterance tensors."""
    return NamedSharding(mesh, P("data"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def gmm_sharding(mesh: Mesh) -> NamedSharding:
    """Mixture-block sharding for scoring tensors a/b [D, M*K]: the
    density axis (last) shards over 'model'."""
    return NamedSharding(mesh, P(None, "model"))


def shard_batch(mesh: Mesh, *arrays):
    """Place [B, ...] host arrays data-parallel on the mesh."""
    sh = data_sharding(mesh)
    out = tuple(jax.device_put(jnp.asarray(a), sh) for a in arrays)
    return out if len(out) > 1 else out[0]
