"""CPU checks of chip_smoke.py, bench.py's device helpers and the
compile-cache rule.

The phase functions of chip_smoke run here at tiny shapes with a second
virtual CPU device as the "device under test" and the first as the
oracle, so their control flow, arguments and comparisons are exercised
before the card sees them. The card itself runs them at full width
(``python chip_smoke.py``; tests/test_gpu.py).
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import bench
import chip_smoke
from rasr_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: headline pruning shape scaled down for CPU compiles
_TINY_BEAM = {
    "BENCH_MAX_HYPS": "64", "BENCH_BRANCH_HYPS": "16",
    "BENCH_ROOT_SELECT": "32", "BENCH_WORD_END": "16",
}
_TINY_SETUP = dict(num_words=150, num_classes=60)


@pytest.fixture
def devs():
    """(device under test, oracle) — two distinct CPU devices."""
    cpus = jax.devices("cpu")
    return cpus[1], cpus[0]


def test_main_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.mark.parametrize(
    "before, after",
    [(None, None), ("cpu", "cuda,cpu"), ("cuda,cpu", "cuda,cpu"),
     ("cuda", "cuda,cpu")],
)
def test_select_backends_keeps_gpu_and_cpu(before, after):
    env = {} if before is None else {"JAX_PLATFORMS": before}
    chip_smoke.select_backends(env)
    assert env.get("JAX_PLATFORMS") == after


@pytest.mark.parametrize("env_dir", ["/some/cache", None])
def test_compile_cache_dir(env_dir, monkeypatch):
    env = {} if env_dir is None else {compile_cache.ENV_VAR: env_dir}
    want = env_dir or os.path.join(REPO, ".jax_cache")
    assert compile_cache.compile_cache_dir(env) == want
    # enable_compile_cache configures JAX only when the variable is unset
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    if env_dir is None:
        monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    else:
        monkeypatch.setenv(compile_cache.ENV_VAR, env_dir)
    assert compile_cache.enable_compile_cache() == want
    assert calls == ([] if env_dir else [("jax_compilation_cache_dir", want)])


@pytest.mark.parametrize(
    "kind, peak",
    [("NVIDIA H100 80GB HBM3", 989e12), ("NVIDIA A100-SXM4-80GB", None), ("cpu", None)],
)
def test_peak_table(kind, peak):
    if peak is None:
        with pytest.raises(KeyError):
            bench.peak_bf16_flops(kind)
    else:
        assert bench.peak_bf16_flops(kind) == peak


def test_require_gpu_refuses_cpu():
    with pytest.raises(SystemExit):
        bench.require_gpu()


def test_canary_requires_accelerator():
    with pytest.raises(RuntimeError):
        bench.correctness_canary()


def test_gmm_reference_matches_direct_formula():
    """chip_smoke's float64 GMM oracle == the textbook density formula."""
    from rasr_tpu.models.gmm import MixtureSet

    rng = np.random.default_rng(3)
    M, K, D = 6, 3, 4
    ms = MixtureSet(
        means=rng.normal(size=(M, K, D)).astype(np.float32),
        variances=(0.5 + rng.uniform(size=(M, K, D))).astype(np.float32),
        weights=rng.dirichlet(np.ones(K), size=M).astype(np.float32),
        num_densities=np.full(M, K, np.int32),
    )
    x = rng.normal(size=(5, D))
    var = ms.variances.astype(np.float64)
    logn = -0.5 * (
        np.log(2 * np.pi * var).sum(-1)[None]
        + (((x[:, None, None, :] - ms.means[None]) ** 2) / var[None]).sum(-1)
    )
    want = (-np.log(ms.weights)[None] - logn).min(-1)
    np.testing.assert_allclose(
        chip_smoke.gmm_reference(ms, x, chunk=2), want, rtol=1e-6
    )


@pytest.mark.parametrize("phase", ["canary", "oracles", "pipeline+streaming", "cli"])
def test_phase_runs_on_cpu_at_tiny_shape(phase, devs, monkeypatch, tmp_path):
    dev, cpu = devs
    if phase == "canary":
        chip_smoke.phase_canary(dev)
    elif phase == "oracles":
        chip_smoke.oracle_gmm(dev, 0, M=50, K=4, D=13, B=2, T=9)
        chip_smoke.oracle_frontend(dev, cpu, 0, B=2, audio_s=0.5)
        chip_smoke.oracle_decode(dev, across=True)
        chip_smoke.oracle_lm(dev, 0, num_words=40, n_seqs=8, length=4)
        chip_smoke.oracle_bit_transport(dev)
    elif phase == "pipeline+streaming":
        for k, v in _TINY_BEAM.items():
            monkeypatch.setenv(k, v)
        run = chip_smoke.phase_pipeline(
            dev, 0, batch=2, audio_s=0.4, iters=1, **_TINY_SETUP
        )
        assert run.emis.shape[0] == 2 and run.emis.shape[2] == 60
        chip_smoke.phase_streaming(run, block=16)
    else:
        chip_smoke.phase_cli(dev, 0, str(tmp_path), n_utts=2)


def test_four_cards_on_virtual_devices(monkeypatch):
    """The --four-cards path on four virtual CPU devices."""
    for k, v in _TINY_BEAM.items():
        monkeypatch.setenv(k, v)
    chip_smoke.phase_four_cards(
        jax.devices("cpu")[:4], 0, batch=4, audio_s=0.3, beam_batch=2,
        **_TINY_SETUP,
    )
