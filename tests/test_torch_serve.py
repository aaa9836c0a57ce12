"""The port's serving engine (asr_using_robust_nn_tpu_torch/serve) against
the JAX package's `InferenceEngine(backend="xla")`, with the same params,
scaler and numpy audio; plus the port's host helpers against their JAX
originals and the port's import boundary.

Probabilities are held at 1e-4 abs: the two MFCC frontends differ by fp32
rounding (the port's dB/DCT finish runs in f64), which the scaler and the
6-layer MLP carry to the softmax; labels must be equal.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from asr_using_robust_nn_tpu.data.pipeline import slice_seconds as jslice
from asr_using_robust_nn_tpu.data.pipeline import (
    standardize_fit_all as jstandardize,
)
from asr_using_robust_nn_tpu.models.mlp import MLPConfig as JMLPConfig
from asr_using_robust_nn_tpu.models.mlp import init_mlp as jinit_mlp
from asr_using_robust_nn_tpu.ops.mfcc_xla import FrontendConfig as JFEConfig
from asr_using_robust_nn_tpu.serve.engine import (
    InferenceEngine as JInferenceEngine,
)
from asr_using_robust_nn_tpu.utils import audio_io as jaudio
from asr_using_robust_nn_tpu_torch.data.pipeline import (
    slice_seconds,
    standardize_fit_all,
)
from asr_using_robust_nn_tpu_torch.models.mlp import MLPConfig
from asr_using_robust_nn_tpu_torch.ops.cuda_mfcc import mel_power_cuda
from asr_using_robust_nn_tpu_torch.ops.mfcc_torch import FrontendConfig
from asr_using_robust_nn_tpu_torch.serve.engine import InferenceEngine
from asr_using_robust_nn_tpu_torch.utils import audio_io

ATOL = 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _model(task, seed):
    """JAX-initialized constrained model (NonNeg-range kernels, non-trivial
    BN moving statistics) and a scaler, as numpy arrays for both engines."""
    preset = f"{task}_constrained"
    jcfg = getattr(JMLPConfig, preset)()
    params, state = jax.tree_util.tree_map(
        np.asarray, jinit_mlp(jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for p, s in zip(params["layers"], state["layers"]):
        p["w"] = np.abs(p["w"])
        if "mean" in s:
            n = s["mean"].shape[0]
            s["mean"] = (rng.random(n) * 2).astype(np.float32)
            s["var"] = (1 + rng.random(n) * 4).astype(np.float32)
    dim = jcfg.in_dim
    scaler = ((rng.standard_normal(dim) * 5).astype(np.float32),
              (10 + 20 * rng.random(dim)).astype(np.float32))
    return preset, params, state, scaler


def _engines(task, buckets, seed=0):
    preset, params, state, scaler = _model(task, seed)
    jeng = JInferenceEngine(getattr(JMLPConfig, preset)(),
                            getattr(JFEConfig, task)(), params, state,
                            scaler=scaler, backend="xla", buckets=buckets)
    eng = InferenceEngine(getattr(MLPConfig, preset)(),
                          getattr(FrontendConfig, task)(), params, state,
                          scaler=scaler, buckets=buckets, device="cpu")
    return eng, jeng


def _waves(n, width=22050, seed=1):
    rng = np.random.default_rng(seed)
    t = np.arange(width) / 22050.0
    return (0.3 * np.sin(2 * np.pi * rng.uniform(100, 800, (n, 1)) * t)
            + 0.02 * rng.standard_normal((n, width))).astype(np.float32)


@pytest.fixture(scope="module")
def digit():
    return _engines("digit", buckets=(4, 16))


class TestDigitEngine:
    @pytest.mark.parametrize("n", [3, 20])
    def test_matches_jax_engine(self, digit, n):
        """3 rows pad to bucket 4; 20 rows run as 16 + 4 (chunking over
        the max bucket). Ragged true lengths exercise the frame masking."""
        eng, jeng = digit
        w = _waves(n, seed=n)
        lens = np.random.default_rng(n).integers(3000, 22051, n)
        for i, m in enumerate(lens):
            w[i, m:] = 0.0
        got = eng.classify(w, lengths=lens)
        want = jeng.classify(w, lengths=lens)
        assert got["probs"].shape == (n, 10)
        np.testing.assert_allclose(got["probs"], want["probs"], atol=ATOL,
                                   rtol=0)
        np.testing.assert_array_equal(got["labels"], want["labels"])

    def test_int16_ingress_bit_equal_and_matches_jax(self, digit):
        eng, jeng = digit
        pcm = np.random.default_rng(7).integers(
            -32768, 32768, (5, 22050)).astype(np.int16)
        out16 = eng.classify(pcm)
        outf = eng.classify(pcm.astype(np.float32) / 32768.0)
        np.testing.assert_array_equal(out16["probs"], outf["probs"])
        # list-of-rows int16 input stays int16 too
        rows = eng.classify([pcm[i] for i in range(5)])
        np.testing.assert_array_equal(rows["probs"], outf["probs"])
        # mixed dtypes fall back to f32 on the host, same interpretation
        mixed = eng.classify([pcm[0], pcm[1].astype(np.float32) / 32768.0])
        np.testing.assert_allclose(mixed["probs"], outf["probs"][:2],
                                   atol=1e-6)
        np.testing.assert_allclose(out16["probs"],
                                   jeng.classify(pcm)["probs"], atol=ATOL)

    def test_padding_rows_are_no_ops(self, digit):
        eng, _ = digit
        w = _waves(9, seed=4)
        full = eng.classify(w)["probs"]
        for n in (1, 3, 4):
            np.testing.assert_allclose(eng.classify(w[:n])["probs"],
                                       full[:n], atol=1e-6)

    def test_variable_length_list_input(self, digit):
        """Short rows are masked exactly, long rows truncated to 1 s."""
        eng, jeng = digit
        full = _waves(3, width=30000, seed=5)
        rows = [full[0][:9000], full[1][:22050], full[2]]
        np.testing.assert_allclose(eng.classify(rows)["probs"],
                                   jeng.classify(rows)["probs"], atol=ATOL)

    def test_warm_latency_and_launch_counter(self):
        """warmup() runs every (bucket, dtype); later calls are warm and
        recorded. On the CPU the K1 wrapper launches nothing."""
        eng, _ = _engines("digit", buckets=(4,), seed=2)
        assert eng.latency_stats() == {"n": 0}
        eng.warmup()
        eng.classify(np.zeros((3, 22050), np.int16))
        eng.classify(_waves(2))
        st = eng.latency_stats()
        assert st["n"] == 2 and 0 < st["p50_ms"] <= st["p95_ms"]
        assert mel_power_cuda.launches == 0

    def test_cold_call_not_counted_and_bad_buckets(self):
        eng, _ = _engines("digit", buckets=(4,), seed=3)
        eng.classify(_waves(2))
        assert eng.latency_stats() == {"n": 0}
        eng.classify(_waves(2))
        assert eng.latency_stats()["n"] == 1
        _, params, state, _ = _model("digit", 0)
        with pytest.raises(ValueError, match="buckets"):
            InferenceEngine(MLPConfig.digit_constrained(),
                            FrontendConfig.digit(), params, state,
                            buckets=(16, 4), device="cpu")
        with pytest.raises(ValueError, match="at least one"):
            eng.classify([])


class TestSpeakerWindows:
    @pytest.fixture(scope="class")
    def speaker(self):
        return _engines("speaker", buckets=(4,), seed=6)

    @pytest.mark.parametrize("agg", ["vote", "mean"])
    def test_windows_match_jax(self, speaker, agg):
        """6 s in -> first/last second dropped -> 4 windows."""
        eng, jeng = speaker
        wave = _waves(1, width=6 * 22050, seed=9)[0]
        got = eng.classify_windows(wave, agg=agg)
        want = jeng.classify_windows(wave, agg=agg)
        assert got["n_windows"] == want["n_windows"] == 4
        np.testing.assert_allclose(got["probs"], want["probs"], atol=ATOL)
        np.testing.assert_array_equal(got["window_labels"],
                                      want["window_labels"])
        assert got["label"] == want["label"]

    def test_short_recording_and_bad_agg(self, speaker):
        eng, _ = speaker
        out = eng.classify_windows(np.zeros(30000, np.float32))
        assert out["label"] is None and out["n_windows"] == 0
        with pytest.raises(ValueError, match="agg"):
            eng.classify_windows(np.zeros(5 * 22050, np.float32), agg="max")

    def test_classify_files(self, speaker, digit, tmp_path):
        """WAVs at 22.05 kHz and at 16 kHz (resampled on the host), through
        the numpy decode path on both sides."""
        eng, jeng = digit
        waves = _waves(3, seed=12)
        paths = []
        for i, w in enumerate(waves):
            paths.append(str(tmp_path / f"{i}.wav"))
            audio_io.write_wav(paths[-1], w, 22050)
        paths.append(str(tmp_path / "16k.wav"))
        audio_io.write_wav(paths[-1], waves[0][:16000], 16000)
        got = eng.classify_files(paths)
        decoded = [jaudio.load_audio(p, native=False)[0] for p in paths]
        want = jeng.classify(decoded)
        assert [r["path"] for r in got] == paths
        np.testing.assert_allclose(np.stack([r["probs"] for r in got]),
                                   want["probs"], atol=ATOL)
        assert [r["label"] for r in got] == want["labels"].tolist()
        # the speaker protocol over a file
        s_eng, s_jeng = speaker
        long = str(tmp_path / "long.wav")
        audio_io.write_wav(long, _waves(1, width=5 * 22050, seed=13)[0],
                           22050)
        (r,) = s_eng.classify_files([long], agg="vote")
        (jr,) = s_jeng.classify_files([long], agg="vote")
        assert r["n_windows"] == 3 and r["label"] == jr["label"]


class TestHostHelpers:
    def test_audio_io_equals_jax(self, tmp_path):
        rng = np.random.default_rng(14)
        y = (0.5 * rng.standard_normal((2, 8000))).astype(np.float32)
        p = str(tmp_path / "st.wav")
        audio_io.write_wav(p, y, 16000)
        jp = str(tmp_path / "st_j.wav")
        jaudio.write_wav(jp, y, 16000)
        assert open(p, "rb").read() == open(jp, "rb").read()
        ch, sr = audio_io.read_wav(p)
        jch, jsr = jaudio.read_wav(p)
        np.testing.assert_array_equal(ch, jch)
        assert sr == jsr == 16000
        np.testing.assert_array_equal(
            audio_io.load_audio(p, target_sr=22050)[0],
            jaudio.load_audio(p, target_sr=22050, native=False)[0])
        np.testing.assert_array_equal(audio_io.design_resample_filter(3, 2),
                                      jaudio.design_resample_filter(3, 2))

    def test_pipeline_helpers_equal_jax(self):
        rng = np.random.default_rng(15)
        for n in (0, 30000, 22050 * 3 + 7, 22050 * 6):
            y = rng.standard_normal(n).astype(np.float32)
            np.testing.assert_array_equal(slice_seconds(y), jslice(y))
        a, b, c = (rng.standard_normal((k, 6)) for k in (5, 3, 2))
        a[:, 2] = 1.0
        b[:, 2] = 1.0
        c[:, 2] = 1.0  # a constant feature gets scale 1
        for x, y in zip(standardize_fit_all(a, b, c), jstandardize(a, b, c)):
            np.testing.assert_array_equal(x, y)


def test_port_imports_no_jax():
    """Importing the port and every submodule leaves jax (and the JAX
    package) out of sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import asr_using_robust_nn_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m.startswith('asr_using_robust_nn_tpu.')\n"
        "       or m == 'asr_using_robust_nn_tpu']\n"
        "assert not bad, bad\n"
        "assert 'asr_using_robust_nn_tpu_torch.serve.engine' in sys.modules\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    # an import inside a function escapes the check above: scan the sources
    # (and chip_smoke.py, which runs where JAX is not installed)
    import pathlib
    import re

    root = pathlib.Path(REPO)
    banned = re.compile(r"^\s*(import (jax|optax|orbax)\b|from (jax|optax|"
                        r"orbax)\b|.*\basr_using_robust_nn_tpu\.)", re.M)
    sources = list((root / "asr_using_robust_nn_tpu_torch").rglob("*.py"))
    sources.append(root / "chip_smoke.py")
    assert len(sources) > 40
    hits = [f"{p}: {m.group(0).strip()}" for p in sources
            for m in banned.finditer(p.read_text())]
    assert not hits, hits
