"""Exactness contracts on the GPU (marker ``gpu``).

The regular suite forces the CPU (tests/conftest.py), where every copy
is bit-exact. An accelerator's compiler and hardware need not be: an
earlier accelerator flushed denormals in fused f32 relayouts and
silently corrupted the decoder's packed-row transport while 240+ CPU
tests passed (PERF.md "Bit-pattern transport"), and a GPU runs f32
matmuls in TF32 unless told otherwise. These tests re-run the core
exactness contracts on the card, at the widths chip_smoke.py uses. Run
on the card, in one process:

    RASR_TEST_GPU=1 python -m pytest tests/test_gpu.py -m gpu

Without a GPU every test here skips (the fixture decides, at run time).
"""

import jax
import pytest

import chip_smoke

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def gpu():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(
            f"no GPU visible ({dev}); card tests run with RASR_TEST_GPU=1 "
            "on a machine with a GPU"
        )
    return dev


@pytest.fixture(scope="module")
def cpu():
    return jax.devices("cpu")[0]


def test_device_is_gpu(gpu):
    assert gpu.platform == "gpu" and gpu.device_kind


def test_bit_pattern_transport(gpu):
    chip_smoke.oracle_bit_transport(gpu)


@pytest.mark.parametrize("across", [False, True])
def test_decode_matches_host_reference(gpu, across):
    chip_smoke.oracle_decode(gpu, across)


def test_gmm_scorer_matches_numpy(gpu):
    chip_smoke.oracle_gmm(gpu, seed=3)


def test_lm_lookup_matches_host(gpu):
    chip_smoke.oracle_lm(gpu, seed=5)


def test_frontend_matches_cpu_jit(gpu, cpu):
    chip_smoke.oracle_frontend(gpu, cpu, seed=11)


def test_canary_cpu_equals_gpu(gpu):
    chip_smoke.phase_canary(gpu)


def test_streaming_matches_offline_on_chip(gpu):
    """Online block-feed decode == offline decode on the headline
    network, with a mid-stream current_best()."""
    run = chip_smoke.phase_pipeline(gpu, seed=23, batch=8, audio_s=3.0, iters=1)
    chip_smoke.phase_streaming(run, block=64)
