"""Host-side audio IO: WAV decode + polyphase resampling, in numpy.

A copy of the numpy path of the JAX package's `utils/audio_io.py`, the
replacement for the reference's `librosa.load(file_path, mono=True)`: decode
any common WAV encoding, mix down to mono, scale to float32 in [-1, 1] and
resample to the target rate (librosa's default 22 050 Hz) with a
kaiser_best-class windowed-sinc FIR. The C++ fast path (`utils/native.py`)
accelerates batch decode and resampling; this module is the always-available
numpy path and the one source of the filter design for both.
"""

from __future__ import annotations

import functools
import io
import struct

import numpy as np

__all__ = ["read_wav", "write_wav", "resample", "load_audio", "design_resample_filter"]

_PCM_SCALE = {1: 1 << 7, 2: 1 << 15, 3: 1 << 23, 4: 1 << 31}


def read_wav(path_or_bytes) -> tuple[np.ndarray, int]:
    """Decode a RIFF/WAVE file -> (float32 samples in [-1,1], sample_rate).

    Supports PCM 8/16/24/32-bit and IEEE float32/64, any channel count
    (returned as (channels, n) — use load_audio for the mono mixdown).
    """
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    pos = 12
    fmt = None
    fmt_sub = None
    raw = None
    while pos + 8 <= len(data):
        cid = data[pos : pos + 4]
        (csz,) = struct.unpack("<I", data[pos + 4 : pos + 8])
        body = data[pos + 8 : pos + 8 + csz]
        if cid == b"fmt ":
            if len(body) < 16:
                raise ValueError("truncated fmt chunk")
            fmt = struct.unpack("<HHIIHH", body[:16])
            fmt_sub = (struct.unpack("<H", body[24:26])[0]
                       if len(body) >= 26 else None)
        elif cid == b"data":
            raw = body
        pos += 8 + csz + (csz & 1)  # chunks are word-aligned
    if fmt is None or raw is None:
        raise ValueError("missing fmt/data chunk")
    audio_format, n_channels, sample_rate, _, _, bits = fmt
    if n_channels <= 0 or sample_rate <= 0:
        raise ValueError("invalid fmt chunk (channels/sample rate)")
    if audio_format == 0xFFFE:  # WAVE_FORMAT_EXTENSIBLE: real code is the
        # first two bytes of the SubFormat GUID at fmt offset 24
        audio_format = fmt_sub if fmt_sub is not None else 1
    if audio_format == 1:  # integer PCM
        if bits == 8:
            x = np.frombuffer(raw, dtype=np.uint8).astype(np.float32)
            x = (x - 128.0) / _PCM_SCALE[1]
        elif bits == 16:
            x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / _PCM_SCALE[2]
        elif bits == 24:
            b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
            x = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            x = (x - ((x & 0x800000) << 1)).astype(np.float32) / _PCM_SCALE[3]
        elif bits == 32:
            x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / _PCM_SCALE[4]
        else:
            raise ValueError(f"unsupported PCM bit depth {bits}")
    elif audio_format == 3:  # IEEE float
        if bits == 32:
            dt = "<f4"
        elif bits == 64:
            dt = "<f8"
        else:
            raise ValueError(f"unsupported IEEE-float bit depth {bits}")
        x = np.frombuffer(raw, dtype=dt).astype(np.float32)
    else:
        raise ValueError(f"unsupported WAV format code {audio_format}")
    n = (len(x) // n_channels) * n_channels
    return x[:n].reshape(-1, n_channels).T.copy(), int(sample_rate)


def write_wav(path, samples: np.ndarray, sample_rate: int) -> None:
    """Write mono/multi-channel float samples as 16-bit PCM WAV."""
    samples = np.asarray(samples)
    if samples.ndim == 1:
        samples = samples[None, :]
    x = np.clip(samples, -1.0, 1.0)
    # round to the nearest PCM value (astype truncates toward zero, a
    # signal-correlated 1-LSB bias)
    pcm = np.round(x * 32767.0).astype("<i2").T.reshape(-1)  # interleave
    n_channels = samples.shape[0]
    byte_rate = sample_rate * n_channels * 2
    body = pcm.tobytes()
    buf = io.BytesIO()
    buf.write(b"RIFF")
    buf.write(struct.pack("<I", 36 + len(body)))
    buf.write(b"WAVEfmt ")
    buf.write(struct.pack("<IHHIIHH", 16, 1, n_channels, sample_rate, byte_rate, n_channels * 2, 16))
    buf.write(b"data")
    buf.write(struct.pack("<I", len(body)))
    buf.write(body)
    with open(path, "wb") as f:
        f.write(buf.getvalue())


@functools.lru_cache(maxsize=None)
def design_resample_filter(up: int, down: int, half_len_mult: int = 24, beta: float = 14.769656) -> np.ndarray:
    """Windowed-sinc anti-alias FIR for polyphase up/down resampling.

    kaiser_best-class design: cutoff at min(1/up, 1/down) of Nyquist,
    `2*half_len_mult*max(up,down)+1` taps, Kaiser window.
    """
    max_rate = max(up, down)
    half_len = half_len_mult * max_rate
    n = np.arange(-half_len, half_len + 1, dtype=np.float64)
    fc = 1.0 / max_rate  # normalized to Nyquist
    taps = fc * np.sinc(fc * n)
    taps *= np.kaiser(2 * half_len + 1, beta)
    return (taps * up).astype(np.float64)


def resample(x: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resample a 1-D float signal: zero-stuff, filter, decimate."""
    if orig_sr == target_sr:
        return np.asarray(x, dtype=np.float32)
    g = np.gcd(orig_sr, target_sr)
    up, down = target_sr // g, orig_sr // g
    taps = design_resample_filter(up, down)
    x = np.asarray(x, dtype=np.float64)
    n_up = len(x) * up
    stuffed = np.zeros(n_up, dtype=np.float64)
    stuffed[::up] = x
    if n_up * len(taps) < 5e7:
        y = np.convolve(stuffed, taps, mode="full")
    else:
        try:
            from scipy.signal import fftconvolve

            y = fftconvolve(stuffed, taps, mode="full")
        except ImportError:  # scipy optional: slow-but-correct numpy path
            y = np.convolve(stuffed, taps, mode="full")
    half = (len(taps) - 1) // 2
    y = y[half : half + n_up]
    n_out = int(np.ceil(len(x) * up / down))
    return y[::down][:n_out].astype(np.float32)


def load_audio(path, target_sr: int = 22050,
               native: bool | None = None) -> tuple[np.ndarray, int]:
    """librosa.load-equivalent: mono float32 at target_sr.

    Mixdown = mean over channels (librosa `to_mono` semantics). Set
    `native=True/False` to force/disable the C++ fast path; None auto-selects.
    """
    if native is not False:
        from . import native as _native

        if _native.available():
            y = _native.decode_resample(path, target_sr)
            if y is not None:
                return y, target_sr
        if native is True:
            raise RuntimeError("native audio path requested but unavailable")
    ch, sr = read_wav(path)
    mono = ch.mean(axis=0) if ch.shape[0] > 1 else ch[0]
    return resample(mono, sr, target_sr), target_sr
