"""Profiling: JAX trace capture + per-op HLO self-time tables.

Implements the plan for the reference's tracing/statistics
subsystem (SURVEY §5: the reference flushes Core::Statistics/Timer
into XML channels; decoders log states/frame and RTF — covered by
utils/statistics.py — while *sampling* profiling was left to external
tools). Here the external tool is the JAX profiler, and this module
productizes the recipe behind the decoder's earlier cost model
(PERF.md hypotheses H1-H5): capture a trace around a callable, convert
the xplane with xprof's ``hlo_stats`` tool, and return per-op self-time
rows sorted by cost. Needs the ``xprof`` package, which the GPU machine
may lack (ROADMAP S2 replaces it with ``jax.profiler.ProfileData``).
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import tempfile
from typing import Any, Callable, Dict, List, Optional, Tuple

import jax


def trace(log_dir: str):
    """Context manager: capture a JAX profiler trace into ``log_dir``."""
    return jax.profiler.trace(log_dir)


def _find_xplanes(log_dir: str) -> List[str]:
    return sorted(
        glob.glob(os.path.join(log_dir, "**", "*.xplane.pb"), recursive=True)
    )


def hlo_stats(log_dir: str) -> List[Dict[str, Any]]:
    """Parse a captured trace into per-op rows (xprof 'hlo_stats').

    Returns dicts with at least ``program``, ``name``, ``category``,
    ``occurrences``, ``self_time_us`` — sorted by self time, descending.
    """
    from xprof.convert import raw_to_tool_data

    paths = _find_xplanes(log_dir)
    if not paths:
        raise FileNotFoundError(f"no xplane.pb under {log_dir}")
    data, _ = raw_to_tool_data.xspace_to_tool_data(paths, "hlo_stats", {})
    if isinstance(data, bytes):
        try:
            data = gzip.decompress(data)
        except OSError:
            pass
        data = data.decode()
    table = json.loads(data)  # DataTable: {"cols": [...], "rows": [{"c": [...]}]}
    idx = {c.get("label", c.get("id", "")): i
           for i, c in enumerate(table["cols"])}

    def col(cells, *names, default=None):
        for n in names:
            if n in idx:
                v = cells[idx[n]]
                return v.get("v") if isinstance(v, dict) else v
        return default

    rows = []
    for row in table["rows"]:
        cells = row["c"] if isinstance(row, dict) else row
        rows.append(
            {
                "program": col(cells, "Program id", default=""),
                "name": col(cells, "HLO op name", default=""),
                "category": col(cells, "HLO op category", default=""),
                "occurrences": col(cells, "#Occurrences", default=0),
                "self_time_us": float(
                    col(cells, "Total self time (us)", default=0.0) or 0.0
                ),
            }
        )
    # CPU-backend traces emit no device-op rows for this tool — the
    # table is only populated for an accelerator; rows == [] on CPU is
    # expected
    rows.sort(key=lambda r: -r["self_time_us"])
    return rows


def profile_call(
    fn: Callable, *args, log_dir: Optional[str] = None, warmup: int = 1,
    **kwargs,
) -> Tuple[Any, List[Dict[str, Any]]]:
    """Run ``fn(*args)`` under a trace (after ``warmup`` untraced calls
    so compilation stays out of the profile) -> (result, hlo rows)."""
    for _ in range(warmup):
        out = fn(*args, **kwargs)
        jax.block_until_ready(out)
    tmp = log_dir or tempfile.mkdtemp(prefix="rasr_tpu_prof_")
    with trace(tmp):
        out = fn(*args, **kwargs)
        jax.block_until_ready(out)
    return out, hlo_stats(tmp)


def top_table(rows: List[Dict[str, Any]], n: int = 15) -> str:
    """Human-readable top-N self-time table (for log channels)."""
    lines = [f"{'self us':>10}  {'category':<18} name"]
    for r in rows[:n]:
        lines.append(
            f"{r['self_time_us']:>10.1f}  {str(r['category']):<18} {r['name']}"
        )
    return "\n".join(lines)
