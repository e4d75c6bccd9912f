"""Audio input.

Replaces the reference's libsndfile-backed Flow input nodes
(ref: src/Audio/ — wav/raw input with segment-bounded reading). Decoding
happens host-side into numpy; the device pipeline consumes whole-utterance
sample tensors, not frame-pulled packets.

Supported: PCM/float WAV (stdlib ``wave`` + numpy), headerless raw PCM16.
FLAC/other containers are gated behind optional soundfile, absent in this
image.
"""

from __future__ import annotations

import wave
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


@dataclass
class AudioData:
    samples: np.ndarray  # float32 [num_samples] (mono) or [num_samples, ch]
    sample_rate: int

    @property
    def duration(self) -> float:
        return self.samples.shape[0] / self.sample_rate


def read_wav(path: str) -> AudioData:
    with wave.open(path, "rb") as wf:
        rate = wf.getframerate()
        n = wf.getnframes()
        channels = wf.getnchannels()
        width = wf.getsampwidth()
        raw = wf.readframes(n)
    if width == 2:
        samples = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        samples = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        samples = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"{path}: unsupported sample width {width}")
    if channels > 1:
        samples = samples.reshape(-1, channels)
    return AudioData(samples, rate)


def read_raw(path: str, sample_rate: int = 16000, dtype: str = "<i2") -> AudioData:
    data = np.fromfile(path, dtype=np.dtype(dtype))
    scale = float(np.iinfo(data.dtype).max) + 1 if data.dtype.kind == "i" else 1.0
    return AudioData(data.astype(np.float32) / scale, sample_rate)


def read_audio(path: str, sample_rate_hint: int = 16000) -> AudioData:
    if path.endswith(".wav"):
        return read_wav(path)
    if path.endswith((".raw", ".pcm")):
        return read_raw(path, sample_rate_hint)
    try:  # optional backends, not in this image
        import soundfile  # type: ignore

        samples, rate = soundfile.read(path, dtype="float32")
        return AudioData(np.asarray(samples, dtype=np.float32), int(rate))
    except ImportError as exc:
        raise ValueError(
            f"{path}: unsupported audio container (only wav/raw without soundfile)"
        ) from exc


def extract_segment(
    audio: AudioData, start: float, end: float, track: int = 0
) -> np.ndarray:
    """Segment-bounded mono samples (ref: Audio segment reading semantics)."""
    samples = audio.samples
    if samples.ndim == 2:
        samples = samples[:, track]
    lo = max(0, int(round(start * audio.sample_rate)))
    hi = samples.shape[0] if end == float("inf") else int(round(end * audio.sample_rate))
    return samples[lo : min(hi, samples.shape[0])]


def write_wav(path: str, samples: np.ndarray, sample_rate: int = 16000) -> None:
    pcm = np.clip(samples, -1.0, 1.0 - 1.0 / 32768.0)
    pcm16 = (pcm * 32768.0).astype("<i2")
    with wave.open(path, "wb") as wf:
        wf.setnchannels(1 if pcm16.ndim == 1 else pcm16.shape[1])
        wf.setsampwidth(2)
        wf.setframerate(sample_rate)
        wf.writeframes(pcm16.tobytes())
