"""The port's data-preparation path (asr_using_robust_nn_tpu_torch) against
the JAX package on the same WAV trees: corpus walk, split, artifact store,
native decode, host and device resampling, the featurizers, `build_dataset`
end to end and the `prepare-data` command. Everything runs with
`device="cpu"`; inputs are made with numpy from a seed and handed to both
packages. Also here: the rule that every entry point defaults to the CUDA
device and raises where there is none.
"""

import json
import os
import shutil
import warnings

import numpy as np
import pytest
import torch

from asr_using_robust_nn_tpu.data import corpus as jcorpus
from asr_using_robust_nn_tpu.data import pipeline as jpipe
from asr_using_robust_nn_tpu.ops.resample import (
    resample_batch_device as jresample_batch_device,
)
from asr_using_robust_nn_tpu.utils import audio_io as jaudio
from asr_using_robust_nn_tpu.utils import native as jnative
from asr_using_robust_nn_tpu_torch.cli.main import main as cli_main
from asr_using_robust_nn_tpu_torch.data import corpus, pipeline
from asr_using_robust_nn_tpu_torch.frontend.mfcc import Frontend
from asr_using_robust_nn_tpu_torch.models import convert
from asr_using_robust_nn_tpu_torch.models.mlp import MLPConfig, init_mlp
from asr_using_robust_nn_tpu_torch.ops.mfcc_torch import FrontendConfig
from asr_using_robust_nn_tpu_torch.ops.resample import (
    resample_batch_device,
    resample_matrix,
)
from asr_using_robust_nn_tpu_torch.serve.engine import InferenceEngine
from asr_using_robust_nn_tpu_torch.train.trainer import Trainer
from asr_using_robust_nn_tpu_torch.utils import audio_io, native


def _utterance(rng, n, sr, f0, noise=0.02):
    t = np.arange(n) / sr
    return (0.3 * np.sin(2 * np.pi * f0 * t)
            + noise * rng.standard_normal(n)).astype(np.float32)


@pytest.fixture()
def digit_tree(tmp_path):
    """Nine of the ten digit folders, 3 files each: 0.4-1.0 s int16 WAVs at
    16 kHz; plus a folder that is no digit word."""
    rng = np.random.default_rng(1)
    root = tmp_path / "digits"
    for c, word in enumerate(corpus.DIGIT_WORDS):
        if word == "seven":
            continue
        (root / word).mkdir(parents=True)
        for k in range(3):
            n = int(rng.integers(6400, 16001))
            audio_io.write_wav(root / word / f"{word}_{k}.wav",
                               _utterance(rng, n, 16000, 250 + 60 * c), 16000)
    (root / "_background_noise_").mkdir()
    audio_io.write_wav(root / "_background_noise_" / "x.wav",
                       np.zeros(100, np.float32), 16000)
    return str(root)


@pytest.fixture()
def speaker_tree(tmp_path):
    """Three speaker folders of 3 recordings, 3.2-5.9 s at 22 050 Hz (one
    to three 1-s windows each after the boundary seconds are dropped). The
    tone sits 10 dB over its noise: two fp32 frontends summing in different
    orders agree to 1e-3 on such audio; on a cleaner tone the quiet bins
    carry the loud ones' rounding and the gap passes 1e-3."""
    rng = np.random.default_rng(2)
    root = tmp_path / "speakers"
    for s in range(3):
        (root / f"spk{s}").mkdir(parents=True)
        for k in range(3):
            n = int(rng.integers(int(3.2 * 22050), int(5.9 * 22050)))
            audio_io.write_wav(root / f"spk{s}" / f"r{k}.wav",
                               _utterance(rng, n, 22050, 200 + 150 * s, 0.1),
                               22050)
    return str(root)


def _walk_both(root, names):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return corpus.walk_corpus(root, names), jcorpus.walk_corpus(root, names)


class TestCorpusAndSplit:
    """Pure host code: equal to the JAX package exactly."""

    def test_digit_words_equal(self):
        assert corpus.DIGIT_WORDS == jcorpus.DIGIT_WORDS

    @pytest.mark.parametrize("layout", ["digit", "speaker"])
    def test_walk_corpus_equal_jax(self, digit_tree, layout):
        names = corpus.DIGIT_WORDS if layout == "digit" else None
        (f, lab, cls), (jf, jlab, jcls) = _walk_both(digit_tree, names)
        assert f == jf and cls == jcls
        np.testing.assert_array_equal(lab, jlab)
        assert lab.dtype == jlab.dtype == np.int64
        assert len(f) == (27 if layout == "digit" else 28)

    def test_missing_folder_keeps_labels_and_warns(self, digit_tree):
        with pytest.warns(UserWarning, match="missing"):
            _, lab, cls = corpus.walk_corpus(digit_tree, corpus.DIGIT_WORDS)
        assert cls == corpus.DIGIT_WORDS
        assert sorted(set(lab.tolist())) == [0, 1, 2, 3, 4, 5, 6, 8, 9]

    def test_listdir_not_glob(self, tmp_path):
        """A folder name with glob metacharacters is walked like any other."""
        d = tmp_path / "c" / "run[1]"
        d.mkdir(parents=True)
        audio_io.write_wav(d / "a.WAV", np.zeros(10, np.float32), 16000)
        files, lab, cls = corpus.walk_corpus(tmp_path / "c")
        assert len(files) == 1 and cls == ["run[1]"] and lab.tolist() == [0]

    @pytest.mark.parametrize("n", [0, 5, 9, 10, 99, 100])
    @pytest.mark.parametrize("seed", [None, 0, 7])
    def test_split_files_equal_jax(self, n, seed):
        files = [f"f{i}" for i in range(n)]
        labels = np.arange(n)
        got = pipeline.split_files(files, labels, seed)
        want = jpipe.split_files(files, labels, seed)
        for (f, lab), (jf, jlab) in zip(got, want):
            assert f == jf
            np.testing.assert_array_equal(lab, jlab)
        if 0 < n < 10:  # the reference's `[-0:]` quirk: all files in test
            assert len(got[2][0]) == n


class TestArtifacts:
    @staticmethod
    def _splits(mod):
        rng = np.random.default_rng(3)
        return mod.DatasetSplits(
            train_data=rng.standard_normal((7, 880)),
            train_label=rng.integers(0, 10, 7),
            dev_data=rng.standard_normal((2, 880)),
            dev_label=rng.integers(0, 10, 2),
            test_data=rng.standard_normal((1, 880)),
            test_label=rng.integers(0, 10, 1),
            test_filenames=np.asarray(["data\\nine\\a.wav"]),
            test_audio_label=np.asarray([9]))

    @pytest.mark.parametrize("writer", ["jax", "port"])
    def test_store_crosses_packages(self, tmp_path, writer):
        """A folder written by either package loads in the other with equal
        arrays: float64 data, int32 labels, and the backslash repair of the
        attack set's file names."""
        w, r = (jpipe, pipeline) if writer == "jax" else (pipeline, jpipe)
        want = self._splits(w)
        w.save_artifacts(want, str(tmp_path / "npy"))
        got = r.load_artifacts(str(tmp_path / "npy"))
        for name in ("train", "dev", "test"):
            x = getattr(got, f"{name}_data")
            y = getattr(got, f"{name}_label")
            assert x.dtype == np.float64 and y.dtype == np.int32
            np.testing.assert_array_equal(x, getattr(want, f"{name}_data"))
            np.testing.assert_array_equal(y, getattr(want, f"{name}_label"))
        assert got.test_filenames.tolist() == [
            os.path.join("data", "nine", "a.wav")]
        np.testing.assert_array_equal(got.test_audio_label, [9])

    def test_files_equal_bytes(self, tmp_path):
        for mod, sub in ((jpipe, "j"), (pipeline, "p")):
            mod.save_artifacts(self._splits(mod), str(tmp_path / sub))
        for dirpath, _, names in os.walk(tmp_path / "j"):
            for name in names:
                a = os.path.join(dirpath, name)
                b = a.replace(str(tmp_path / "j"), str(tmp_path / "p"))
                with open(a, "rb") as fa, open(b, "rb") as fb:
                    assert fa.read() == fb.read(), name


class TestDecodeAndResample:
    def test_native_builds_into_the_ports_build_dir(self):
        assert native.available()
        assert native._build().parent.name == "_build"
        assert "asr_using_robust_nn_tpu_torch" in str(native._build())

    @pytest.mark.parametrize("sr", [16000, 22050, 44100])
    def test_native_decode_equals_jax(self, tmp_path, sr):
        """The same C++ source behind both bindings: equal samples."""
        rng = np.random.default_rng(sr)
        y = np.stack([_utterance(rng, 9000, sr, 440)] * 2)  # stereo
        path = str(tmp_path / "a.wav")
        audio_io.write_wav(path, y, sr)
        got, got_sr = native.decode_only(path)
        want, want_sr = jnative.decode_only(path)
        assert got_sr == want_sr == sr
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(native.decode_resample(path),
                                      jnative.decode_resample(path))
        (b,) = native.decode_resample_batch([path])
        np.testing.assert_array_equal(b, native.decode_resample(path))
        (pair,) = native.decode_only_batch([path])
        np.testing.assert_array_equal(pair[0], got)

    @pytest.mark.parametrize("use_native", [None, True, False])
    def test_load_audio_native_switch(self, tmp_path, use_native):
        """Native and numpy paths agree to fp32 rounding of the resampler
        (1e-5 abs, the JAX suite's bar for them)."""
        rng = np.random.default_rng(5)
        path = str(tmp_path / "a.wav")
        audio_io.write_wav(path, _utterance(rng, 12000, 16000, 330), 16000)
        got, sr = audio_io.load_audio(path, native=use_native)
        want, _ = jaudio.load_audio(path, native=False)
        assert sr == 22050 and got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)

    def test_bad_file_names_the_file(self, tmp_path):
        bad = tmp_path / "bad.wav"
        bad.write_bytes(b"not a wav")
        with pytest.raises(ValueError, match="bad.wav"):
            native.decode_resample_batch([str(bad)])
        with pytest.raises(ValueError, match="bad.wav"):
            native.decode_only_batch([str(bad)])

    @pytest.mark.parametrize("src", [16000, 44100, 8000, 22050])
    def test_resample_device_vs_jax_and_host(self, src):
        """One filter design behind all paths: the resample matrix equals
        the JAX one exactly, the fp32 product agrees with the JAX einsum to
        2e-6 abs and with the host resampler to 1e-5 abs (the JAX suite's
        bar)."""
        rng = np.random.default_rng(src)
        x = (rng.standard_normal((2, src // 2)) * 0.3).astype(np.float32)
        got = resample_batch_device(torch.from_numpy(x), src, 22050).numpy()
        want = np.asarray(jresample_batch_device(x, src, 22050))
        host = np.stack([audio_io.resample(xi, src, 22050) for xi in x])
        assert got.shape == want.shape == host.shape
        np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)
        np.testing.assert_allclose(got, host, atol=1e-5, rtol=0)
        if src != 22050:
            g = np.gcd(src, 22050)
            from asr_using_robust_nn_tpu.ops.resample import (
                resample_matrix as jresample_matrix)
            h, c, w = resample_matrix(22050 // g, src // g)
            jh, jc, jw = jresample_matrix(22050 // g, src // g)
            np.testing.assert_array_equal(h, jh)
            assert (c, w) == (jc, jw)


class TestFeaturize:
    def test_featurize_files_vs_jax(self, digit_tree):
        """The host-resampled featurizer against the JAX one (fp32 XLA
        path): 1e-3 abs; max_samples caps the batch width as in JAX."""
        (files, _, _), _ = _walk_both(digit_tree, corpus.DIGIT_WORDS)
        cfg, jcfg = FrontendConfig.digit(), jpipe.FrontendConfig.digit()
        got = pipeline.featurize_files(files, cfg, backend="plain",
                                       device="cpu", batch_size=16)
        want = jpipe.featurize_files(files, jcfg, backend="xla",
                                     batch_size=16)
        assert got.shape == (27, 880) and got.dtype == np.float64
        np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
        cap = pipeline.featurize_files(files[:4], cfg, backend="plain",
                                       device="cpu", batch_size=4,
                                       max_samples=8000)
        jcap = jpipe.featurize_files(files[:4], jcfg, backend="xla",
                                     batch_size=4, max_samples=8000)
        np.testing.assert_allclose(cap, jcap, atol=1e-3, rtol=0)

    @pytest.mark.parametrize("max_samples", [None, 12000])
    def test_device_resample_matches_host_path(self, digit_tree,
                                               max_samples):
        """Resampling on the device against the host path: atol 5e-3, rtol
        1e-3, the JAX suite's bar. The port zeroes the resampler's ringing
        past each file's end, so even files that stop abruptly agree."""
        (files, _, _), _ = _walk_both(digit_tree, corpus.DIGIT_WORDS)
        cfg = FrontendConfig.digit()
        kw = dict(backend="plain", device="cpu", batch_size=16,
                  max_samples=max_samples)
        host = pipeline.featurize_files(files, cfg, **kw)
        dev = pipeline.featurize_files(files, cfg, device_resample=True, **kw)
        np.testing.assert_allclose(dev, host, atol=5e-3, rtol=1e-3)

    def test_mixed_rate_chunk_falls_back_to_host(self, tmp_path):
        rng = np.random.default_rng(6)
        paths = []
        for i, sr in enumerate((16000, 22050, 44100)):
            paths.append(str(tmp_path / f"m{i}.wav"))
            audio_io.write_wav(paths[-1], _utterance(rng, sr // 2, sr, 500),
                               sr)
        cfg = FrontendConfig.digit()
        kw = dict(backend="plain", device="cpu", batch_size=4)
        a = pipeline.featurize_files(paths, cfg, device_resample=True, **kw)
        b = pipeline.featurize_files(paths, cfg, **kw)
        np.testing.assert_array_equal(a, b)

    def test_sliced_files_ragged_tail_vs_jax(self, speaker_tree):
        """Windows carried over chunk borders (batch 4, 2 files a chunk)
        come out in file order, equal to the JAX featurizer's: 1e-3 abs."""
        (files, lab, _), _ = _walk_both(speaker_tree, None)
        cfg, jcfg = FrontendConfig.speaker(), jpipe.FrontendConfig.speaker()
        x, y = pipeline.featurize_sliced_files(
            files, lab, cfg, batch_size=4, backend="plain", file_chunk=2,
            device="cpu")
        jx, jy = jpipe.featurize_sliced_files(
            files, lab, jcfg, batch_size=4, backend="xla", file_chunk=2)
        assert x.shape == jx.shape and x.shape[1] == 2020
        assert x.dtype == np.float64
        np.testing.assert_array_equal(y, jy)
        np.testing.assert_allclose(x, jx, atol=1e-3, rtol=0)

    def test_sliced_files_without_windows(self, tmp_path):
        path = str(tmp_path / "short.wav")
        audio_io.write_wav(path, np.zeros(22050, np.float32), 22050)
        x, y = pipeline.featurize_sliced_files(
            [path], [0], FrontendConfig.speaker(), device="cpu")
        assert x.shape == (0, 2020) and y.shape == (0,)


class TestBuildDataset:
    @pytest.mark.parametrize("task", ["digit", "speaker"])
    def test_end_to_end_vs_jax(self, task, digit_tree, speaker_tree,
                               tmp_path):
        """The whole path on one WAV tree against the JAX `build_dataset`:
        features within 1e-3 abs (two fp32 frontends), labels, order and the
        attack set equal; the written folder loads back equal."""
        root = digit_tree if task == "digit" else speaker_tree
        out = str(tmp_path / "npy")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            got = pipeline.build_dataset(root, task, out_dir=out, seed=3,
                                         device="cpu")
            want = jpipe.build_dataset(root, task, seed=3, backend="xla")
        dim = 880 if task == "digit" else 2020
        for name in ("train", "dev", "test"):
            x, jx = (getattr(s, f"{name}_data") for s in (got, want))
            assert x.shape == jx.shape and x.shape[1] == dim
            assert x.dtype == np.float64
            np.testing.assert_allclose(x, jx, atol=1e-3, rtol=0)
            np.testing.assert_array_equal(getattr(got, f"{name}_label"),
                                          getattr(want, f"{name}_label"))
        assert got.test_filenames.tolist() == want.test_filenames.tolist()
        np.testing.assert_array_equal(got.test_audio_label,
                                      want.test_audio_label)
        back = pipeline.load_artifacts(out)
        np.testing.assert_array_equal(back.train_data, got.train_data)
        assert back.train_label.dtype == np.int32
        assert all(os.path.isfile(p) for p in back.test_filenames)


class TestPrepareDataCommand:
    def test_json_line_and_artifacts(self, digit_tree, tmp_path, capsys):
        out = str(tmp_path / "npy")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            rc = cli_main(["prepare-data", "--task", "digit", "--data-dir",
                           digit_tree, "--out-dir", out, "--seed", "1",
                           "--backend", "plain", "--device", "cpu"])
        assert rc == 0
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert line == {"train": [18, 880], "dev": [6, 880],
                        "test": [2, 880], "out_dir": out}
        art = pipeline.load_artifacts(out)
        assert art.train_data.shape == (18, 880)
        assert art.test_filenames.shape == (2,)

    @pytest.mark.parametrize("case", ["empty", "missing"])
    def test_no_audio_exits_2_and_writes_nothing(self, tmp_path, capsys,
                                                 case):
        data = tmp_path / "data"
        if case == "empty":
            (data / "zero").mkdir(parents=True)
        out = tmp_path / "npy"
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            rc = cli_main(["prepare-data", "--task", "digit", "--data-dir",
                           str(data), "--out-dir", str(out), "--device",
                           "cpu"])
        assert rc == 2
        assert "error" in capsys.readouterr().err
        assert not out.exists()

    def test_backend_names_are_the_ports(self):
        with pytest.raises(SystemExit):
            cli_main(["prepare-data", "--task", "digit", "--data-dir", "x",
                      "--out-dir", "y", "--backend", "pallas_int8"])


_DEFAULT_DEVICE_CALLS = {
    "Frontend": lambda: Frontend(FrontendConfig.digit()),
    "InferenceEngine": lambda: InferenceEngine(
        MLPConfig.digit_constrained(), FrontendConfig.digit(),
        {"layers": []}, {"layers": []}),
    "Trainer": lambda: Trainer(MLPConfig.digit_constrained()),
    "init_mlp": lambda: init_mlp(MLPConfig.digit_constrained(),
                                 torch.Generator()),
    "params_from_numpy": lambda: convert.params_from_numpy(
        {"layers": []}, {"layers": []}),
    "adam_state_from_numpy": lambda: convert.adam_state_from_numpy(
        0, {"layers": []}, {"layers": []}),
    "cstate_from_numpy": lambda: convert.cstate_from_numpy(
        {"u": np.zeros(3)}),
    "fstate_from_numpy": lambda: convert.fstate_from_numpy({}),
    "featurize_files": lambda: pipeline.featurize_files(
        [], FrontendConfig.digit()),
    "build_dataset": lambda: pipeline.build_dataset(".", "speaker"),
}


@pytest.mark.parametrize("entry", sorted(_DEFAULT_DEVICE_CALLS))
def test_default_device_is_cuda_and_raises_without_one(entry):
    """Entry points run on the card unless the caller passes device="cpu":
    with no CUDA device the default raises and names the device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves")
    with pytest.raises(RuntimeError, match="'cuda'.*device='cpu'"):
        _DEFAULT_DEVICE_CALLS[entry]()


def test_prepare_data_default_device_raises_without_cuda(digit_tree,
                                                         tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves")
    out = tmp_path / "npy"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(RuntimeError, match="'cuda'"):
            cli_main(["prepare-data", "--task", "digit", "--data-dir",
                      digit_tree, "--out-dir", str(out)])
    assert not out.exists()
    shutil.rmtree(out, ignore_errors=True)
