"""The port's `attack` and `dolphin` subcommands (asr_using_robust_nn_tpu_
torch/cli/main.py) with `--device cpu` on tiny numpy-written artifacts: every
`--type`, the fgsm and pgd curves against the JAX package's whitebox_sweep
with the same weights, the grid rules, the speaker audio path, the rc 2
paths, and `dolphin` against the JAX function.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_using_robust_nn_tpu.attacks import dolphin as jdolphin
from asr_using_robust_nn_tpu.attacks.sweeps import \
    whitebox_sweep as jwhitebox_sweep
from asr_using_robust_nn_tpu.models import mlp as jmlp
from asr_using_robust_nn_tpu_torch.attacks import dolphin
from asr_using_robust_nn_tpu_torch.attacks.sweeps import GRIDS
from asr_using_robust_nn_tpu_torch.cli.main import main, model_cfg_for
from asr_using_robust_nn_tpu_torch.data.pipeline import standardize_fit_all
from asr_using_robust_nn_tpu_torch.train.checkpoints import CheckpointManager
from asr_using_robust_nn_tpu_torch.utils import audio_io

CPU = ["--device", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Several test workers share a few cores; one torch thread each keeps
    this file near its solo time."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_artifacts(out, width, n_classes, sizes, seed, wavs=None,
                     wav_labels=None):
    """The six .npy files of `prepare-data` and, with `wavs`, the audio
    attack set (test_dataset_to_add_noise/): seeded blobs at the scale of
    MFCC features, float64 features, int32 labels."""
    rng = np.random.default_rng(seed)
    means = 20 * rng.standard_normal((n_classes, width)) - 10
    out.mkdir()
    for name, n in zip(("train", "dev", "test"), sizes):
        y = rng.integers(0, n_classes, n).astype(np.int32)
        np.save(out / f"{name}_data.npy",
                means[y] + 5 * rng.standard_normal((n, width)))
        np.save(out / f"{name}_label.npy", y)
    if wavs is not None:
        adir = out / "test_dataset_to_add_noise"
        adir.mkdir()
        np.save(adir / "test_filenames.npy", np.asarray([str(p) for p in wavs]))
        np.save(adir / "test_label.npy", np.asarray(wav_labels, np.int32))
    return out


def _write_wavs(root, durations, sr, seed):
    rng = np.random.default_rng(seed)
    root.mkdir()
    paths = []
    for i, d in enumerate(durations):
        t = np.arange(int(d * sr)) / sr
        y = 0.3 * np.sin(2 * np.pi * (200 + 150 * i) * t) \
            + 0.02 * rng.standard_normal(len(t))
        paths.append(root / f"{i}.wav")
        audio_io.write_wav(paths[-1], y.astype(np.float32), sr)
    return paths


def _store(path, task, variant, seed):
    """A checkpoint store of a JAX-initialized model -> its numpy trees."""
    jcfg = getattr(jmlp.MLPConfig, f"{task}_{variant}")()
    p, s = jax.tree.map(np.asarray, jmlp.init_mlp(jcfg,
                                                  jax.random.PRNGKey(seed)))
    CheckpointManager(path).save_best(
        p, s, {"count": np.zeros((), np.int32), "mu": p, "nu": p},
        epoch=0, val_loss=1.0)
    return p, s


@pytest.fixture(scope="module")
def digit(tmp_path_factory):
    root = tmp_path_factory.mktemp("attack_cli")
    wavs = _write_wavs(root / "wavs", (1.0, 0.6, 0.8, 1.3), 16000, seed=1)
    art = _write_artifacts(root / "art", 880, 3, (40, 12, 16), seed=2,
                           wavs=wavs, wav_labels=[0, 1, 2, 1])
    trees = {v: _store(root / f"ck_{v[0]}", "digit", v, seed)
             for seed, v in enumerate(("constrained", "unconstrained"))}
    args = ["attack", "--data", str(art), "--constrained",
            str(root / "ck_c"), "--unconstrained", str(root / "ck_u")]
    return root, art, trees, args, wavs


def _run(capsys, argv):
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


# every --type; a shortened grid or sample count where the CPU time asks
_TYPES = {
    "white_mfcc": [], "mixture_mfcc": [], "white_audio": [],
    "mixture_audio": [], "snr_audio": [], "fgsm": [],
    "pgd": ["--strengths", "0.5,1"], "jsma": ["--max-samples", "3"],
    "cw_l2": ["--strengths", "1", "--max-samples", "6"],
    "cw_linf": ["--max-samples", "6"],
}
_DEFAULT = {"white_mfcc": "mfcc_sigmas", "mixture_mfcc": "mfcc_alphas",
            "white_audio": "audio_sigmas", "mixture_audio": "audio_alphas",
            "snr_audio": "snrs_db", "fgsm": "fgsm_eps_std",
            "jsma": "jsma_theta", "cw_linf": "cw_linf_confidence"}


@pytest.mark.parametrize("kind", list(_TYPES))
def test_every_type(digit, capsys, kind, tmp_path):
    _, _, _, args, _ = digit
    out = tmp_path / "curves.json"
    line = _run(capsys, [*args, "--type", kind, "--out", str(out),
                         *_TYPES[kind], *CPU])
    assert line["attack"] == kind
    if kind in _DEFAULT:
        np.testing.assert_allclose(line["strengths"], GRIDS[_DEFAULT[kind]])
    for k in ("accuracy_constrained", "accuracy_unconstrained"):
        acc = np.asarray(line[k])
        assert acc.shape == (len(line["strengths"]),)
        assert np.all((acc >= 0) & (acc <= 1))
    assert json.loads(out.read_text()) == line


def test_fgsm_and_pgd_curves_match_jax(digit, capsys):
    """The CLI's curves against the JAX package's whitebox_sweep on the same
    weights and the same standardized test features: within 1/n."""
    _, art, trees, args, _ = digit
    tr, dv, te = (np.load(art / f"{s}_data.npy")
                  for s in ("train", "dev", "test"))
    te = standardize_fit_all(tr, dv, te)[2].astype(np.float32)
    y = np.load(art / "test_label.npy")
    fns = []
    for v in ("constrained", "unconstrained"):
        jcfg = getattr(jmlp.MLPConfig, f"digit_{v}")()
        p, s = trees[v]

        def logits(xx, jcfg=jcfg, p=p, s=s):
            return jmlp.apply_mlp(jcfg, p, s, xx, train=False)[0]

        fns.append(logits)
    preds = [lambda xx, f=f: np.asarray(jax.nn.softmax(f(jnp.asarray(xx)),
                                                       -1)) for f in fns]
    for kind, extra in (("fgsm", []), ("pgd", ["--strengths", "0.5,2"])):
        got = _run(capsys, [*args, "--type", kind, *extra, *CPU])
        want = jwhitebox_sweep(kind, *fns, *preds, te, y,
                               strengths=got["strengths"])
        for k in ("accuracy_constrained", "accuracy_unconstrained"):
            assert np.abs(np.asarray(got[k])
                          - getattr(want, k)).max() <= 1 / len(y), (kind, k)


def test_standardize_after_takes_the_raw_fgsm_grid(digit, capsys):
    _, _, _, args, _ = digit
    line = _run(capsys, [*args, "--type", "fgsm", "--standardize", "after",
                         *CPU])
    np.testing.assert_allclose(line["strengths"], GRIDS["fgsm_eps_raw"])
    line = _run(capsys, [*args, "--type", "white_audio", "--standardize",
                         "after", "--strengths", "0,0.05", "--seed", "3",
                         *CPU])
    assert line["strengths"] == [0.0, 0.05]


def test_plot_writes_png(digit, capsys, tmp_path):
    pytest.importorskip("matplotlib")
    _, _, _, args, _ = digit
    png = tmp_path / "c.png"
    _run(capsys, [*args, "--type", "fgsm", "--strengths", "0.1", "--plot",
                  str(png), *CPU])
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_speaker_audio_is_sliced_on_the_speaker_grid(tmp_path, capsys):
    """--task speaker audio attacks noise whole recordings, slice 1-s
    windows and sweep the speaker grid (`Speaker recognition/attacks.py:
    319-322,336`)."""
    wavs = _write_wavs(tmp_path / "wavs", (4.0, 3.2), 22050, seed=4)
    art = _write_artifacts(tmp_path / "art", 2020, 20, (30, 8, 8), seed=5,
                           wavs=wavs, wav_labels=[3, 9])
    for seed, v in enumerate(("constrained", "unconstrained")):
        _store(tmp_path / f"ck_{v[0]}", "speaker", v, seed)
    line = _run(capsys, [
        "attack", "--task", "speaker", "--type", "snr_audio", "--data",
        str(art), "--constrained", str(tmp_path / "ck_c"),
        "--unconstrained", str(tmp_path / "ck_u"), *CPU])
    np.testing.assert_allclose(line["strengths"], GRIDS["snrs_db_speaker"])
    # 2 + 1 windows: every accuracy is a multiple of 1/3
    acc = np.asarray(line["accuracy_constrained"]) * 3
    np.testing.assert_allclose(acc, np.round(acc), atol=1e-9)


def test_refusals(digit, tmp_path, capsys):
    """rc 2 with a readable message: no artifacts; an audio attack on
    artifacts without test_dataset_to_add_noise/; dolphin without its
    voice file. Without --device the sweep runs on the card, and here,
    where there is none, raises."""
    root, _, _, args, _ = digit
    ck = ["--constrained", str(root / "ck_c"), "--unconstrained",
          str(root / "ck_u")]
    assert main(["attack", "--type", "fgsm", "--data", str(tmp_path), *ck,
                 *CPU]) == 2
    assert "prepare-data" in capsys.readouterr().err
    bare = _write_artifacts(tmp_path / "bare", 880, 3, (8, 4, 4), seed=6)
    assert main(["attack", "--type", "snr_audio", "--data", str(bare), *ck,
                 *CPU]) == 2
    assert "test_dataset_to_add_noise" in capsys.readouterr().err
    assert main(["dolphin", "--voice", str(tmp_path / "none.wav"), "--out",
                 str(tmp_path / "o.wav")]) == 2
    assert "not a file" in capsys.readouterr().err
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main([*args, "--type", "fgsm"])


def test_dolphin_matches_jax(digit, tmp_path, capsys):
    """dolphin_attack equals the JAX function at 1e-6; the subcommand writes
    the WAV the JAX function writes (192 kHz, peak 1)."""
    _, _, _, _, wavs = digit
    voice = audio_io.read_wav(wavs[0])[0][0]
    got, rate = dolphin.dolphin_attack(voice, 16000)
    want, jrate = jdolphin.dolphin_attack(voice, 16000)
    assert rate == jrate == 192_000
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    out = tmp_path / "ultra.wav"
    assert _run(capsys, ["dolphin", "--voice", str(wavs[0]), "--out",
                         str(out)]) == {"out": str(out)}
    jdolphin.generate_dolphin_wav(str(wavs[0]), str(tmp_path / "j.wav"))
    a, sr = audio_io.read_wav(out)
    b, _ = audio_io.read_wav(tmp_path / "j.wav")
    assert sr == 192_000 and abs(np.abs(a).max() - 1.0) < 1e-4
    np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="band edge"):
        dolphin.dolphin_attack(voice, 8000)


def test_model_cfg_for_speaker():
    assert model_cfg_for("speaker", "unconstrained").in_dim == 2020
