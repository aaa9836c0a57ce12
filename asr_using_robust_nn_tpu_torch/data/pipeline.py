"""Dataset construction: split, slice, featurize, store, standardize. The
counterpart of the JAX package's `data/pipeline.py`.

Rebuilds the reference's artifact layer: six .npy files
`{train,dev,test}_{data,label}.npy` plus `test_filenames.npy`/`test_label.npy`
for the audio-domain attack sets, with the same shapes and dtypes, but with a
seeded shuffle (the reference's was unseeded) and portable paths. Folders
written by either package load in the other.

Featurization runs through the batched frontend on the GPU: audio is decoded
and resampled on host threads (the C++ fast path of `utils/native.py` where
it builds, numpy otherwise) while the device computes the MFCCs of the
previous batch, instead of the reference's sequential per-file librosa loop.
`device=None` is the CUDA device; pass `device="cpu"` for the CPU.
"""

from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..frontend.mfcc import Frontend
from ..ops.mfcc_torch import FrontendConfig
from ..ops.resample import resample_batch_device
from ..utils import native
from ..utils.audio_io import resample
from ..utils.device import resolve_device
from .corpus import DIGIT_WORDS, walk_corpus

__all__ = [
    "DatasetSplits",
    "split_files",
    "slice_seconds",
    "featurize_files",
    "featurize_sliced_files",
    "build_dataset",
    "save_artifacts",
    "load_artifacts",
    "standardize_fit_all",
]


@dataclasses.dataclass
class DatasetSplits:
    train_data: np.ndarray
    train_label: np.ndarray
    dev_data: np.ndarray
    dev_label: np.ndarray
    test_data: np.ndarray
    test_label: np.ndarray
    test_filenames: np.ndarray | None = None  # raw audio attack set
    test_audio_label: np.ndarray | None = None


def split_files(
    filenames: list[str], labels: np.ndarray, seed: int | None = 0
) -> tuple[tuple[list[str], np.ndarray], ...]:
    """Shuffle then split 70/20/10 on file counts.

    Reproduces the reference's slicing exactly: train = [:70%],
    dev = [70%:90%], test = [-10%:]. On rounding a file can fall in no
    split, and for n < 10 the reference's `[-0:]` puts all files in test;
    both are kept for parity. The shuffle takes an explicit seed (the
    reference's was unseeded).
    """
    n = len(filenames)
    order = np.arange(n)
    if seed is not None:
        order = np.random.default_rng(seed).permutation(n)
    files = [filenames[i] for i in order]
    labs = np.asarray(labels)[order]
    n70, n90, n10 = int(n * 0.7), int(n * 0.9), int(n * 0.1)
    # test uses the reference's literal `[-n10:]` slice, including the n<10
    # quirk where int(n*0.1)==0 makes `[-0:]` the whole list; on rounding, a
    # file between the 90% mark and the last 10% belongs to no split (never
    # an overlap)
    test_files = files[-n10:] if n10 > 0 else list(files)
    test_labs = labs[-n10:] if n10 > 0 else labs.copy()
    return (
        (files[:n70], labs[:n70]),
        (files[n70:n90], labs[n70:n90]),
        (test_files, test_labs),
    )


def slice_seconds(y: np.ndarray, sr: int = 22050) -> np.ndarray:
    """Split audio into 1-s windows, dropping the first and last second.

    Reference semantics: with L = len(y) and W = sr, keep
    y[W : (floor(L/W)-1)*W] and cut it into floor(./W) windows.
    Returns (n_windows, sr); n_windows may be 0 for short recordings.
    """
    w = sr
    audio_len = int(len(y) / w)
    y = y[w : (audio_len - 1) * w]
    n = int(len(y) / w)
    if n <= 0:
        return np.zeros((0, w), dtype=np.float32)
    return np.asarray(y[: n * w], dtype=np.float32).reshape(n, w)


def featurize_files(
    filenames,
    cfg: FrontendConfig,
    batch_size: int = 256,
    backend: str = "cuda",
    max_samples: int | None = None,
    device_resample: bool = False,
    device=None,
) -> np.ndarray:
    """Decode+resample on host threads, MFCC on the device in batches.

    Output: (N, n_mfcc * utterance_length) float64, the flattened layout
    the reference stores.

    Fixed-length batching: waveforms are zero-padded to the longest in the
    batch (rounded to 1 s multiples, so few distinct shapes reach the
    device); per-file true lengths feed the frontend's masking so results
    equal per-file processing. With `device_resample` the host only decodes
    and the polyphase resampler runs on the device (ops/resample.py).
    """
    dev = resolve_device(device)
    fe = Frontend(cfg, backend=backend, device=dev)
    out = np.zeros((len(filenames), cfg.feature_dim), dtype=np.float64)
    starts = list(range(0, len(filenames), batch_size))

    def decode_native_rate(start):
        """device_resample path: decode only; resampling runs on the device
        when every file in the chunk shares one rate. Mixed-rate chunks hand
        their already-decoded audio to the host path (no double decode)."""
        chunk = list(filenames[start : start + batch_size])
        pairs = native.decode_only_batch(chunk)
        srs = {sr for _, sr in pairs}
        if len(srs) != 1:
            waves = [resample(w, sr, cfg.sr) for w, sr in pairs]
            return decode(start, waves=waves) + (cfg.sr,)
        (src_sr,) = srs
        waves = [w for w, _ in pairs]
        raw_lengths = np.array([len(w) for w in waves], dtype=np.int64)
        cap_src = -(-max(int(raw_lengths.max()), src_sr) // src_sr) * src_sr
        if max_samples is not None:
            # max_samples caps the target-rate length; convert to the source
            # rate and round up to whole seconds
            g0 = np.gcd(src_sr, cfg.sr)
            up0, down0 = cfg.sr // g0, src_sr // g0
            src_cap = -(-max_samples * down0 // up0)  # ceil
            cap_src = min(cap_src, -(-src_cap // src_sr) * src_sr)
        batch = np.zeros((batch_size, cap_src), dtype=np.float32)
        for i, w in enumerate(waves):
            batch[i, : min(len(w), cap_src)] = w[:cap_src]
        g = np.gcd(src_sr, cfg.sr)
        up, down = cfg.sr // g, src_sr // g
        lengths = np.zeros((batch_size,), dtype=np.int64)
        lengths[: len(waves)] = -(-np.minimum(raw_lengths, cap_src) * up // down)
        return start, len(chunk), batch, lengths, src_sr

    def decode(start, waves=None):
        chunk = list(filenames[start : start + batch_size])
        if waves is None:
            waves = native.decode_resample_batch(chunk, cfg.sr)
        lengths = np.zeros((batch_size,), dtype=np.int64)
        lengths[: len(waves)] = [len(w) for w in waves]
        cap = max(int(lengths.max()), cfg.sr)
        if max_samples is not None:
            cap = min(cap, max_samples)
        cap = -(-cap // cfg.sr) * cfg.sr  # round to 1 s multiples
        # fixed (batch_size, cap) shape: ragged tails are padded with zero
        # rows, so the device sees one shape per cap, not one per chunk size
        batch = np.zeros((batch_size, cap), dtype=np.float32)
        for i, w in enumerate(waves):
            batch[i, : min(len(w), cap)] = w[:cap]
        return start, len(chunk), batch, np.minimum(lengths, cap)

    def job(start):
        if device_resample:
            # always succeeds: mixed-rate chunks fall back to host
            # resampling internally (no double decode)
            return decode_native_rate(start)
        return decode(start) + (cfg.sr,)

    # pipeline: host decodes chunk k+1 while the device featurizes chunk k
    with ThreadPoolExecutor(max_workers=1) as prefetcher:
        pending = prefetcher.submit(job, starts[0]) if starts else None
        for idx in range(len(starts)):
            start, n, batch, lengths, src_sr = pending.result()
            if idx + 1 < len(starts):
                pending = prefetcher.submit(job, starts[idx + 1])
            waves = torch.from_numpy(batch).to(dev)
            if src_sr != cfg.sr:
                waves = resample_batch_device(waves, src_sr, cfg.sr)
                # the host path ends each file at its resampled length; the
                # device resampler's filter rings on past it, into the last
                # valid frame. Zero what lies beyond, so both paths see the
                # same signal (the JAX package leaves the ringing in, and
                # its last frame then departs from its own host path's).
                past = torch.arange(waves.shape[1], device=dev)[None, :] >= \
                    torch.as_tensor(lengths, device=dev)[:, None]
                waves = waves.masked_fill(past, 0.0)
            feats = fe(waves, lengths=lengths)
            out[start : start + n] = feats[:n].reshape(n, -1).cpu().numpy()
    return out


def featurize_sliced_files(
    filenames,
    labels,
    cfg: FrontendConfig,
    batch_size: int = 256,
    backend: str = "cuda",
    file_chunk: int = 64,
    device=None,
) -> tuple[np.ndarray, np.ndarray]:
    """Speaker-task featurization: slice each file into 1-s windows
    (dropping boundary seconds), replicate the label per window, MFCC each
    window.

    Bounded-memory pipeline (same shape as `featurize_files`): files are
    decoded `file_chunk` at a time on a prefetch thread while the device
    featurizes the previous chunk's windows in fixed `batch_size` batches;
    at no point is the whole corpus's audio resident on the host. Window
    order (file order, then window order within a file) matches the
    reference's sequential loop exactly.
    """
    fe = Frontend(cfg, backend=backend, device=resolve_device(device))
    filenames = list(filenames)
    labels_arr = np.asarray(labels)
    starts = list(range(0, len(filenames), file_chunk))
    win_len = cfg.sr  # slice_seconds emits 1-s windows at the target rate

    def decode(start):
        chunk = filenames[start : start + file_chunk]
        waves = native.decode_resample_batch(chunk, cfg.sr)
        wins, labs = [], []
        for y, lab in zip(waves, labels_arr[start : start + file_chunk]):
            s = slice_seconds(y, cfg.sr)
            if len(s):
                wins.append(s)
                labs.extend([lab] * len(s))
        if not wins:
            return (np.zeros((0, win_len), np.float32),
                    np.zeros((0,), np.int64))
        return (np.concatenate(wins, axis=0).astype(np.float32),
                np.asarray(labs, np.int64))

    def features(batch, n):
        return fe(batch)[:n].reshape(n, -1).cpu().numpy()

    feats_parts: list[np.ndarray] = []
    label_parts: list[np.ndarray] = []
    buf = np.zeros((0, win_len), np.float32)
    with ThreadPoolExecutor(max_workers=1) as prefetcher:
        pending = prefetcher.submit(decode, starts[0]) if starts else None
        for idx in range(len(starts)):
            wins, labs = pending.result()
            if idx + 1 < len(starts):
                pending = prefetcher.submit(decode, starts[idx + 1])
            label_parts.append(labs)
            buf = wins if not len(buf) else np.concatenate([buf, wins], 0)
            # drain full batches; the ragged tail carries into the next
            # chunk, so the device sees exactly one (batch_size, sr) shape
            while len(buf) >= batch_size:
                feats_parts.append(features(buf[:batch_size], batch_size))
                buf = buf[batch_size:]
    if len(buf):
        n = len(buf)
        tail = np.pad(buf, ((0, batch_size - n), (0, 0)))
        feats_parts.append(features(tail, n))
    if not feats_parts:
        return np.zeros((0, cfg.feature_dim)), np.zeros((0,), dtype=np.int64)
    return (np.concatenate(feats_parts, 0).astype(np.float64),
            np.concatenate(label_parts))


def build_dataset(
    data_dir,
    task: str,
    out_dir=None,
    seed: int = 0,
    cfg: FrontendConfig | None = None,
    backend: str = "cuda",
    device=None,
) -> DatasetSplits:
    """End-to-end dataset construction for either task.

    task='digit': walk the 10 digit folders, split, featurize fixed 44-frame
    MFCCs. task='speaker': walk speaker folders, split at the *file* level,
    then slice into 1-s windows with per-window labels.
    """
    dev = resolve_device(device)
    if cfg is None:
        cfg = FrontendConfig.digit() if task == "digit" else FrontendConfig.speaker()
    class_names = DIGIT_WORDS if task == "digit" else None
    filenames, labels, _ = walk_corpus(data_dir, class_names)
    (ftr, ltr), (fdv, ldv), (fte, lte) = split_files(filenames, labels, seed)
    kw = dict(backend=backend, device=dev)

    if task == "digit":
        splits = DatasetSplits(
            train_data=featurize_files(ftr, cfg, **kw),
            train_label=ltr,
            dev_data=featurize_files(fdv, cfg, **kw),
            dev_label=ldv,
            test_data=featurize_files(fte, cfg, **kw),
            test_label=lte,
            test_filenames=np.asarray(fte),
            test_audio_label=lte,
        )
    else:
        tr_d, tr_l = featurize_sliced_files(ftr, ltr, cfg, **kw)
        dv_d, dv_l = featurize_sliced_files(fdv, ldv, cfg, **kw)
        te_d, te_l = featurize_sliced_files(fte, lte, cfg, **kw)
        splits = DatasetSplits(
            train_data=tr_d, train_label=tr_l,
            dev_data=dv_d, dev_label=dv_l,
            test_data=te_d, test_label=te_l,
            test_filenames=np.asarray(fte),
            test_audio_label=lte,
        )
    if out_dir is not None:
        save_artifacts(splits, out_dir)
    return splits


def save_artifacts(splits: DatasetSplits, out_dir, attack_dir=None) -> None:
    """Write the six .npy artifacts (+ audio attack set): the reference's
    schema, with portable paths."""
    os.makedirs(out_dir, exist_ok=True)
    for name in ("train", "dev", "test"):
        np.save(os.path.join(out_dir, f"{name}_data.npy"), getattr(splits, f"{name}_data"))
        # labels as int32: the dtype the reference artifacts carry
        np.save(
            os.path.join(out_dir, f"{name}_label.npy"),
            np.asarray(getattr(splits, f"{name}_label"), dtype=np.int32),
        )
    if splits.test_filenames is not None:
        adir = attack_dir or os.path.join(out_dir, "test_dataset_to_add_noise")
        os.makedirs(adir, exist_ok=True)
        np.save(os.path.join(adir, "test_filenames.npy"), splits.test_filenames)
        np.save(os.path.join(adir, "test_label.npy"), splits.test_audio_label)


def load_artifacts(path) -> DatasetSplits:
    """Load the six .npy artifacts: a drop-in for the reference's
    load_npy_dataset; also reads reference-produced folders unchanged."""
    def L(name):
        return np.load(os.path.join(path, name), allow_pickle=False)

    splits = DatasetSplits(
        train_data=L("train_data.npy"), train_label=L("train_label.npy"),
        dev_data=L("dev_data.npy"), dev_label=L("dev_label.npy"),
        test_data=L("test_data.npy"), test_label=L("test_label.npy"),
    )
    for sub in ("test_dataset_to_add_noise", "test_dataset_to_add_noiseV2"):
        adir = os.path.join(path, sub)
        if os.path.exists(os.path.join(adir, "test_filenames.npy")):
            names = np.load(
                os.path.join(adir, "test_filenames.npy"), allow_pickle=False
            )
            # reference artifacts carry Windows '\\' separators; normalize
            # so the audio-attack paths resolve on any OS
            splits.test_filenames = np.asarray(
                [str(n).replace("\\", os.sep) for n in names]
            )
            splits.test_audio_label = np.load(
                os.path.join(adir, "test_label.npy"), allow_pickle=False
            )
            break
    return splits


def standardize_fit_all(
    train: np.ndarray, dev: np.ndarray, test: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Z-score using mean/std fit on train+dev+test *combined*, as the
    reference's scaler does (StandardScaler fit on the concatenation, then
    re-sliced). Returns (train, dev, test, mean, scale); scale uses ddof=0
    like sklearn, and a constant feature gets scale 1."""
    all_data = np.concatenate((train, dev, test), axis=0)
    mean = all_data.mean(axis=0)
    scale = all_data.std(axis=0)
    scale = np.where(scale == 0.0, 1.0, scale)  # sklearn constant-feature rule
    f = lambda x: (x - mean) / scale  # noqa: E731
    return f(train), f(dev), f(test), mean, scale
