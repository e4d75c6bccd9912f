"""Training-state checkpointing.

The reference checkpoints only per-iteration artifacts (mixture sets,
weight files, caches; SURVEY §5) — resumable at stage granularity. Here
stage artifacts keep that role (each trainer writes its own files), and
this module adds full training-state checkpoints (params + optimizer +
step + data-iterator cursor) as flax-msgpack + JSON metadata, so NN
epochs can resume mid-schedule on preemption — the elastic behavior a
preemptible accelerator job needs. The format is deliberately plain (one msgpack blob
per step, replicated params): swap in orbax.checkpoint when training
states grow beyond one host's params (sharded/async saves); the manager
API (save/restore/latest_step) is the orbax CheckpointManager subset so
the swap is local to this file.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

from flax import serialization


class CheckpointManager:
    """Step-indexed checkpoints of an arbitrary pytree + metadata."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep

    # ----------------------------------------------------------- fallback io
    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:08d}")

    def save(self, step: int, state: Any, metadata: Optional[Dict] = None) -> str:
        path = self._path(step)
        with open(path + ".msgpack", "wb") as fh:
            fh.write(serialization.to_bytes(state))
        with open(path + ".json", "w", encoding="utf-8") as fh:
            json.dump({"step": step, **(metadata or {})}, fh)
        self._gc()
        return path

    def restore(self, template: Any, step: Optional[int] = None) -> Tuple[Any, Dict]:
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints in {self.directory}")
        path = self._path(step)
        with open(path + ".msgpack", "rb") as fh:
            state = serialization.from_bytes(template, fh.read())
        with open(path + ".json", "r", encoding="utf-8") as fh:
            meta = json.load(fh)
        return state, meta

    def latest_step(self) -> Optional[int]:
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith("ckpt_") and name.endswith(".json"):
                steps.append(int(name[5:13]))
        return max(steps) if steps else None

    def all_steps(self):
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith("ckpt_") and name.endswith(".json"):
                steps.append(int(name[5:13]))
        return sorted(steps)

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: max(0, len(steps) - self.max_to_keep)]:
            for suffix in (".msgpack", ".json"):
                try:
                    os.remove(self._path(s) + suffix)
                except OSError:
                    pass
