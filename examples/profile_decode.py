#!/usr/bin/env python
"""Per-op HLO self-time profile of the bench decode at any BENCH_* shape.

When the decode frame runs serialized on the device, per-op self time
converts ~1:1 to throughput and the top rows of this table are the
optimization queue (PERF.md hypothesis H1 — unconfirmed on the H100).
This script productizes the recipe used for every measured cost model:
build the bench setup (all BENCH_* env knobs respected, incl.
BENCH_ACROSS / BENCH_CTX_GROUPS / BENCH_NET_CACHE), run the pipeline
once to compile, then trace PROF_ITERS timed iterations and print the
top-PROF_TOP ops by total self time plus the category roll-up.

Run ON CHIP, e.g. the across-word ctx4 shape:
  BENCH_ACROSS=1 BENCH_CTX_GROUPS=4 BENCH_BRANCH_WIDTH=1022 \
  BENCH_BRANCH_HYPS=146 BENCH_NET_CACHE=.bench_nets/aw_ctx4.npz \
  timeout 3600 python examples/profile_decode.py
"""

import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax
import numpy as np

import bench
from rasr_tpu.utils import profiling
from rasr_tpu.utils.compile_cache import enable_compile_cache


def main():
    enable_compile_cache()
    t0 = time.time()
    fe, scorer, dec, tree = bench.build_setup(
        num_words=int(os.environ.get("BENCH_WORDS", "5000")),
        num_classes=int(os.environ.get("BENCH_CLASSES", "2000")),
    )
    B = int(os.environ.get("BENCH_BATCH", "64"))
    audio_s = float(os.environ.get("BENCH_AUDIO_S", "10"))
    iters = int(os.environ.get("PROF_ITERS", "2"))
    rng = np.random.default_rng(1)
    sr = 16000
    S = int(audio_s * sr)
    samples = jax.device_put((rng.normal(size=(B, S)) * 0.1).astype(np.float32))
    lengths = jax.device_put(np.full(B, S, np.int64))
    sys.stderr.write(f"setup {time.time()-t0:.1f}s tree={tree.stats()}\n")

    def pipeline():
        feats, nf = fe(samples, lengths)
        emis = scorer(feats)
        return dec.results_from_device(dec.decode_scores_device(emis, nf))

    t0 = time.time()
    pipeline()
    sys.stderr.write(f"warmup/compile {time.time()-t0:.1f}s\n")

    log_dir = os.environ.get("PROF_DIR", "") or tempfile.mkdtemp(prefix="prof_")
    t0 = time.time()
    with profiling.trace(log_dir):
        for _ in range(iters):
            pipeline()
    wall = time.time() - t0
    rate = iters * B * audio_s / wall
    sys.stderr.write(f"traced {iters} iters in {wall:.2f}s ({rate:.1f} au-s/s)\n")

    rows = profiling.hlo_stats(log_dir)
    total = sum(r["self_time_us"] for r in rows)
    top = int(os.environ.get("PROF_TOP", "25"))
    print(f"# total self time {total/1e3:.1f}ms over {iters} iters "
          f"({total/1e3/iters:.1f}ms/iter); wall {wall*1e3:.0f}ms "
          f"({wall*1e3/iters:.0f}ms/iter) -> dispatch gap "
          f"{(wall*1e6-total)/1e3/iters:.0f}ms/iter")
    print(f"| # | self ms | % | x | category | op |")
    print(f"|---|---------|---|---|----------|----|")
    for i, r in enumerate(rows[:top]):
        print(f"| {i+1} | {r['self_time_us']/1e3:9.2f} "
              f"| {100*r['self_time_us']/total:4.1f} | {r['occurrences']} "
              f"| {r['category']} | {r['name'][:90]} |")
    cats = {}
    for r in rows:
        cats[r["category"]] = cats.get(r["category"], 0.0) + r["self_time_us"]
    print("# category roll-up:")
    for c, us in sorted(cats.items(), key=lambda kv: -kv[1]):
        print(f"#   {c}: {us/1e3:.1f}ms ({100*us/total:.1f}%)")
    print(json.dumps({"metric": "profile", "au_s_per_s": round(rate, 1),
                      "self_ms_per_iter": round(total / 1e3 / iters, 1),
                      "log_dir": log_dir}))


if __name__ == "__main__":
    main()
