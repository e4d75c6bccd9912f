#!/usr/bin/env python
"""On-chip streaming (online) decode measurement.

The reference IS an online frame-feed recognizer (SURVEY §3.1
Speech::Recognizer over Search::SearchAlgorithm); this framework
feeds BLOCKS into a persistent on-device beam (search/streaming.py).
This bench measures, at the HEADLINE system scale (bench.build_setup:
5k words, 2k tied states, K=1024):

* sustained streaming throughput (audio-s/s) vs block size (16/32/128
  frames) — the block-size knee is the latency/throughput dial a
  serving stack tunes;
* per-feed wall latency per block (the block budget a real-time stream
  must fit under: a Tb-frame block must take < Tb*10ms);
* warm ``current_best()`` latency (the getCurrentBestSentence query:
  record concat + bucketed finalize + the device->host pull).

Emissions are scored on device and fed as device-resident slices — in
production the acoustic model runs on the same chip, so the emission
block never crosses the host boundary. The host->device upload of one
emission block is reported separately as `block_upload_ms`.

Run ON CHIP:  timeout 3600 python examples/streaming_bench.py
Env: STREAM_BATCH=16 STREAM_BLOCKS="16,32,128" STREAM_FRAMES=1536
     (frames per measured stream; buckets of 256 keep finalize compiles
     bounded), BENCH_* knobs pass through to build_setup.

Prints one JSON line per (batch, block) point plus a summary line.
"""

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax
import numpy as np

import bench
from rasr_tpu.search.streaming import StreamingDecoder
from rasr_tpu.utils.compile_cache import enable_compile_cache


def main():
    enable_compile_cache()
    t0 = time.time()
    fe, scorer, dec, tree = bench.build_setup(
        num_words=int(os.environ.get("BENCH_WORDS", "5000")),
        num_classes=int(os.environ.get("BENCH_CLASSES", "2000")),
    )
    B = int(os.environ.get("STREAM_BATCH", "16"))
    frames = int(os.environ.get("STREAM_FRAMES", "3072"))
    blocks = [int(x) for x in os.environ.get("STREAM_BLOCKS", "16,32,128").split(",")]
    sys.stderr.write(f"setup {time.time()-t0:.1f}s device={jax.devices()[0].platform}\n")

    # emissions for the whole stream, scored and RESIDENT on device
    rng = np.random.default_rng(1)
    sr = 16000
    S = int(frames / 100 * sr) + 2048
    samples = jax.device_put(
        (rng.normal(size=(B, S)) * 0.1).astype(np.float32)
    )
    lengths = jax.device_put(np.full(B, S, np.int64))
    feats, nf = fe(samples, lengths)
    # score in frame chunks: the GMM's [B, T, densities] intermediate is
    # 12GB at B=64 x 3072 frames in one call (a serving stack scores per
    # block anyway; this is setup, not the measured path)
    import jax.numpy as jnp

    chunk = 512
    feats = feats[:, : frames + 8]
    emis = jnp.concatenate(
        [scorer(feats[:, i : i + chunk]) for i in range(0, feats.shape[1], chunk)],
        axis=1,
    )
    emis = jax.block_until_ready(emis)[:, :frames]
    M = emis.shape[-1]

    # host->device upload of ONE emission block (what a host-side
    # scorer would pay per feed)
    up = np.asarray(emis[:, :32])
    t0 = time.time()
    for _ in range(3):
        jax.block_until_ready(jax.device_put(up))
    block_upload_ms = (time.time() - t0) / 3 * 1e3

    # every timing below ends in block_until_ready on the beam carry
    def force(sd):
        jax.block_until_ready(sd._carry)

    results = []
    for Tb in blocks:
        sd = StreamingDecoder(dec)
        # ---- warmup: compile the feed step for this block size and the
        # finalize for the first bucket
        sd.restart(batch_size=B, n_frames=np.full(B, frames, np.int32))
        t0 = time.time()
        sd.feed(emis[:, :Tb])
        force(sd)
        t_compile_feed = time.time() - t0
        t0 = time.time()
        sd.current_best()
        t_compile_best = time.time() - t0

        # ---- sustained stream: chained async feeds over the whole
        # stream. Emission blocks are PRE-MATERIALIZED device arrays,
        # so no eager slice dispatch lands inside the window.
        n_feeds = frames // Tb
        blocks_dev = jax.block_until_ready(
            jax.jit(lambda e: tuple(
                e[:, i * Tb : (i + 1) * Tb] for i in range(n_feeds)
            ))(emis)
        )

        def stream(n):
            sd.restart(batch_size=B, n_frames=np.full(B, frames, np.int32))
            t0 = time.time()
            for i in range(n):
                sd.feed(blocks_dev[i])
            force(sd)
            return time.time() - t0

        stream(2)  # settle
        per_feed = float(np.median(
            [stream(n_feeds) / n_feeds for _ in range(3)]
        ))
        rate = B * Tb * 0.01 / per_feed
        rtf_per_stream = per_feed / (Tb * 0.01)

        # ---- interactive per-feed latency: one synced feed per block
        # (what a server syncing every block pays)
        lat = []
        for i in range(min(12, n_feeds)):
            t0 = time.time()
            sd.feed(blocks_dev[i])
            force(sd)
            lat.append(time.time() - t0)

        # ---- warm current_best latency at the full-stream frontier
        # (bucketed finalize; returns host DecodeResults = value read)
        t0 = time.time()
        sd.current_best()
        t_best_cold = time.time() - t0
        tb = []
        for _ in range(3):
            t0 = time.time()
            res = sd.current_best()
            tb.append(time.time() - t0)
        t_best = float(np.median(tb))
        final = sd.finalize()

        row = {
            "metric": "streaming_decode",
            "batch": B,
            "block_frames": Tb,
            "audio_s_per_s": round(rate, 1),
            "per_feed_ms_async": round(per_feed * 1e3, 2),
            "per_feed_ms_synced_p50": round(float(np.median(lat)) * 1e3, 2),
            "per_feed_ms_synced_p95": round(float(np.quantile(lat, 0.95)) * 1e3, 2),
            "feed_budget_ms": Tb * 10,
            "realtime_per_stream": round(1.0 / rtf_per_stream, 2),
            "current_best_ms_warm": round(t_best * 1e3, 1),
            "current_best_s_cold": round(t_best_cold, 1),
            "compile_s_feed": round(t_compile_feed, 1),
            "compile_s_finalize": round(t_compile_best, 1),
            "block_upload_ms": round(block_upload_ms, 1),
            "n_words_decoded": int(np.mean([len(r.words) for r in final])),
        }
        results.append(row)
        print(json.dumps(row), flush=True)

    best = max(results, key=lambda r: r["audio_s_per_s"])
    print(json.dumps({
        "metric": "streaming_best",
        "value": best["audio_s_per_s"],
        "unit": "audio_seconds/s/chip",
        "block_frames": best["block_frames"],
        "batch": B,
    }), flush=True)


if __name__ == "__main__":
    main()
