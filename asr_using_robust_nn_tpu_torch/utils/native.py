"""ctypes bindings for the C++ audio fast path (native/audioio.cpp): the
counterpart of the JAX package's `utils/native.py`.

The shared library is built from the repository's `native/audioio.cpp` with
the host C++ compiler at first use, into the port's git-ignored `_build/`
directory (the file name carries a hash of the source, so an edited source
is rebuilt). Where no compiler or no source is found, every function steps
down to the numpy path (`utils/audio_io`): a host-side step that hides
neither the device nor a kernel; `available()` says which decoder runs. All
C calls release the GIL, so `decode_resample_batch` parallelizes across a
thread pool.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from . import audio_io

__all__ = ["available", "decode_resample", "decode_only",
           "decode_only_batch", "decode_resample_batch"]

_PKG_DIR = Path(__file__).resolve().parent.parent
_SOURCE = _PKG_DIR.parent / "native" / "audioio.cpp"
_BUILD_DIR = _PKG_DIR / "_build"
_CXXFLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
_lock = threading.Lock()
_lib = None
_tried = False


def _compiler() -> str | None:
    for cand in (os.environ.get("CXX"), "g++", "c++", "clang++"):
        if cand and shutil.which(cand):
            return shutil.which(cand)
    return None


def _build() -> Path | None:
    """Compile native/audioio.cpp into _build/, or None where that cannot be
    done (no source, no compiler, a failed compile)."""
    if not _SOURCE.exists():
        return None
    digest = hashlib.sha256(
        _SOURCE.read_bytes() + " ".join(_CXXFLAGS).encode()).hexdigest()[:16]
    so = _BUILD_DIR / f"libasrnative-{digest}.so"
    if so.exists():
        return so
    cxx = _compiler()
    if cxx is None:
        return None
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        subprocess.run([cxx, *_CXXFLAGS, "-o", str(tmp), str(_SOURCE)],
                       check=True, capture_output=True, timeout=120)
    except (subprocess.SubprocessError, OSError):
        return None
    os.replace(tmp, so)  # atomic: a concurrent build never loads a torn file
    return so


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = _build()
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            return None
        lib.asr_wav_info.restype = ctypes.c_int
        lib.asr_wav_info.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.asr_wav_decode.restype = ctypes.c_int64
        lib.asr_wav_decode.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.asr_resample_poly.restype = ctypes.c_int64
        lib.asr_resample_poly.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the C++ decoder is built and loaded (builds it at the first
    call)."""
    return _load() is not None


def decode_only(path) -> tuple[np.ndarray, int] | None:
    """Decode one WAV to mono float32 at its native rate (no resampling):
    feeds the on-device polyphase resampler (ops/resample.py). None where
    the native path is missing or fails (the caller falls back to
    audio_io.read_wav)."""
    lib = _load()
    if lib is None:
        return None
    path_b = os.fsencode(path)
    sr = ctypes.c_int(0)
    n = ctypes.c_int64(0)
    if lib.asr_wav_info(path_b, ctypes.byref(sr), ctypes.byref(n)) != 0:
        return None
    mono = np.empty(n.value, dtype=np.float32)
    got = lib.asr_wav_decode(
        path_b,
        mono.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n.value,
        ctypes.byref(sr),
    )
    if got < 0:
        return None
    return mono[:got], sr.value


def decode_resample(path, target_sr: int = 22050) -> np.ndarray | None:
    """Decode one WAV to mono float32 at target_sr. None where the native
    path is missing or fails."""
    out = decode_only(path)
    if out is None:
        return None
    mono, sr = out
    if sr == target_sr:
        return mono
    lib = _load()
    g = np.gcd(sr, target_sr)
    up, down = int(target_sr // g), int(sr // g)
    taps = audio_io.design_resample_filter(up, down)
    n_out = -(-len(mono) * up // down)
    res = np.empty(n_out, dtype=np.float32)
    wrote = lib.asr_resample_poly(
        mono.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(mono),
        up,
        down,
        taps.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        len(taps),
        res.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n_out,
    )
    if wrote < 0:
        return None
    return res[:wrote]


def _workers(max_workers: int | None) -> int:
    return max_workers or min(32, (os.cpu_count() or 4))


def decode_only_batch(paths, max_workers: int | None = None):
    """Threaded decode at native rates -> list of (mono float32, sr)."""

    def fn(p):
        out = decode_only(p)
        if out is None:
            try:
                ch, sr = audio_io.read_wav(p)
            except (ValueError, OSError) as e:
                # surfaced from a worker thread: without the filename a
                # single bad file in a 256-file chunk is hard to identify
                raise ValueError(f"cannot decode audio file {p!r}: {e}")
            mono = ch.mean(axis=0) if ch.shape[0] > 1 else ch[0]
            return mono, sr
        return out

    with ThreadPoolExecutor(max_workers=_workers(max_workers)) as pool:
        return list(pool.map(fn, paths))


def decode_resample_batch(
    paths, target_sr: int = 22050, max_workers: int | None = None
) -> list[np.ndarray]:
    """Threaded batch decode+resample (the C calls release the GIL).

    Falls back to the numpy path per file where the native library is
    missing or fails on a file.
    """
    def numpy_path(p):
        return audio_io.load_audio(p, target_sr, native=False)[0]

    if available():

        def fn(p):
            out = decode_resample(p, target_sr)
            # on native decode failure, retry on the numpy path so the
            # caller gets a real diagnostic (ValueError naming the file)
            # instead of a None propagating
            if out is None:
                try:
                    return numpy_path(p)
                except (ValueError, OSError) as e:
                    # OSError too: a moved artifact dir raises
                    # FileNotFoundError, which must also name the file
                    raise ValueError(f"cannot decode audio file {p!r}: {e}")
            return out

    else:
        fn = numpy_path
    with ThreadPoolExecutor(max_workers=_workers(max_workers)) as pool:
        return list(pool.map(fn, paths))
