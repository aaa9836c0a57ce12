"""The port's CLI (asr_using_robust_nn_tpu_torch/cli/main.py) end to end on
seeded synthetic artifacts and a tiny WAV corpus with `--device cpu`: the counterparts of
tests/test_cli.py for `train`, `evaluate`, `infer` and `certify`, and one
parity run of both packages' `train --resume` on the same artifacts.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from asr_using_robust_nn_tpu.cli.main import main as jmain
from asr_using_robust_nn_tpu.train import checkpoints as jck
from asr_using_robust_nn_tpu_torch.cli import main as cli
from asr_using_robust_nn_tpu_torch.cli.main import load_model, main, \
    model_cfg_for
from asr_using_robust_nn_tpu_torch.train.checkpoints import CheckpointManager
from asr_using_robust_nn_tpu_torch.utils import audio_io

CPU = ["--device", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs several worker processes on a few cores, where torch's
    default thread pool oversubscribes them and these many small ops ran
    ~10x slower than alone. One thread keeps the file near its solo time."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_cli")
    rng = np.random.default_rng(7)
    sr = 16000
    for wi, w in enumerate(["zero", "one", "two"]):
        d = root / "data" / w
        d.mkdir(parents=True)
        for i in range(10):
            t = np.arange(sr) / sr
            y = 0.4 * np.sin(2 * np.pi * (250 + 200 * wi) * t)
            y += 0.03 * rng.standard_normal(sr)
            audio_io.write_wav(d / f"{i}.wav", y.astype(np.float32), sr)
    return root


def _write_artifacts(out, width, n_classes, sizes, scale, seed):
    """The six .npy files of `prepare-data` (tested in test_torch_data.py),
    written directly: seeded blobs, float64 features, int32 labels."""
    rng = np.random.default_rng(seed)
    means = scale * rng.standard_normal((n_classes, width))
    out.mkdir()
    for name, n in zip(("train", "dev", "test"), sizes):
        y = rng.integers(0, n_classes, n).astype(np.int32)
        x = means[y] + rng.standard_normal((n, width))
        np.save(out / f"{name}_data.npy", x)
        np.save(out / f"{name}_label.npy", y)
    return out


@pytest.fixture(scope="module")
def artifacts(corpus):
    return _write_artifacts(corpus / "processed", 880, 3, (48, 16, 16), 0.2,
                            seed=5)


def _train(artifacts, ck, *extra, variant="constrained", epochs=4):
    return main(["train", "--task", "digit", "--variant", variant,
                 "--data", str(artifacts), "--ckpt", str(ck),
                 "--epochs", str(epochs), "--patience", "10",
                 "--batch-size", "8", "--log-every", "0", *extra, *CPU])


@pytest.fixture(scope="module")
def trained_pair(corpus, artifacts):
    cu, cc = corpus / "ck_u", corpus / "ck_c"
    assert _train(artifacts, cu, variant="unconstrained") == 0
    assert _train(artifacts, cc) == 0
    return cu, cc


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_subcommand_table():
    """Nine of the JAX CLI's ten commands (`bench` waits); `infer` and
    `prepare-data` take the frontend backends and `auto`, and refuse the
    JAX package's names the port has no counterpart of."""
    assert list(cli._SUBCOMMANDS) == ["prepare-data", "train", "train-multi",
                                      "evaluate", "infer", "certify",
                                      "attack", "dolphin", "profile"]
    with pytest.raises(SystemExit):
        main([])
    for command in (["infer", "--ckpt", "x", "--audio", "x"],
                    ["prepare-data", "--task", "digit", "--data-dir", "x",
                     "--out-dir", "y"]):
        with pytest.raises(SystemExit):
            main([*command, "--backend", "xla"])
    # parsed, then refused for the missing --data (rc 2, not a parse error)
    assert main(["infer", "--ckpt", "x", "--audio", "x", "--backend",
                 "hopdft", "--device", "cpu"]) == 2


def test_train_writes_the_store(artifacts, trained_pair, capsys):
    _, cc = trained_pair
    assert sorted(os.listdir(cc)) == ["best.npz", "meta.json"]
    meta = json.loads((cc / "meta.json").read_text())
    assert sorted(meta) == ["epoch", "val_loss"]
    p, s = load_model(cc, model_cfg_for("digit", "constrained"))
    # the constrained variant clamps kernels NonNeg
    assert all(float(np.min(layer["w"])) >= 0.0 for layer in p["layers"])


def test_train_with_config_file(artifacts, corpus, capsys):
    conf = corpus / "conf.json"
    conf.write_text(json.dumps({
        "task": "digit", "variant": "constrained", "constraint": "norm",
        "rho": 0.5, "batch_size": 8, "patience": 5, "epochs": 2,
        "epoch_backend": "plain", "device_resident": True}))
    assert main(["train", "--config", str(conf), "--data", str(artifacts),
                 "--ckpt", str(corpus / "ck_conf"), "--log-every", "0",
                 *CPU]) == 0
    line = _last_json(capsys)
    assert line["epochs_run"] == 2 and line["epoch_backend"] == "plain"
    p, _ = load_model(corpus / "ck_conf", model_cfg_for("digit",
                                                          "constrained"))
    assert all(float(np.min(layer["w"])) >= 0.0 for layer in p["layers"])


def test_config_rejects_unknown_and_invalid(artifacts, corpus, capsys):
    bad1 = corpus / "bad1.json"
    bad1.write_text(json.dumps({"task": "digit", "batchsize": 8}))
    assert main(["train", "--config", str(bad1), "--data", str(artifacts),
                 "--ckpt", str(corpus / "x")]) == 2
    assert "unknown config keys" in capsys.readouterr().err
    bad2 = corpus / "bad2.json"
    bad2.write_text(json.dumps({"task": "Digit"}))
    assert main(["train", "--config", str(bad2), "--data", str(artifacts),
                 "--ckpt", str(corpus / "x")]) == 2
    bad3 = corpus / "bad3.json"
    bad3.write_text(json.dumps({"task": "digit", "epoch_backend": "pallas"}))
    assert main(["train", "--config", str(bad3), "--data", str(artifacts),
                 "--ckpt", str(corpus / "x")]) == 2
    assert "not in" in capsys.readouterr().err


def test_train_resume_keeps_best_and_continues_adam(artifacts, corpus,
                                                    capsys):
    ck = corpus / "ck_resume"
    assert _train(artifacts, ck, variant="unconstrained") == 0
    meta0 = json.loads((ck / "meta.json").read_text())
    count0 = int(CheckpointManager(ck).load_best()[0]["opt_state"]["count"])
    assert _train(artifacts, ck, "--resume", variant="unconstrained",
                  epochs=1) == 0
    out = capsys.readouterr().out
    assert "resumed from" in out and "epoch backend: streaming" in out
    tree, meta1 = CheckpointManager(ck).load_best()
    assert meta1["val_loss"] <= meta0["val_loss"]
    if meta1["val_loss"] < meta0["val_loss"]:  # saved after resumed steps
        assert int(tree["opt_state"]["count"]) > count0


def test_resume_without_checkpoint_errors(artifacts, corpus, capsys):
    assert _train(artifacts, corpus / "no_such_ck", "--resume") == 2
    assert "best.npz" in capsys.readouterr().err
    assert not (corpus / "no_such_ck").exists()


def test_data_parallel_not_ported(artifacts, corpus, capsys):
    """`train --data-parallel` as one process trains on a one-rank mesh
    what `train` trains, bit for bit (the rank holds every row, so the
    step is the single-device one); its evaluation sums per row, so the
    val and test losses agree within 1e-6 and the accuracy exactly.
    tests/test_torch_distributed.py runs the command on 2 ranks."""
    assert _train(artifacts, corpus / "ck_1", "--data-parallel") == 0
    got = _last_json(capsys)
    assert _train(artifacts, corpus / "ck_dp0") == 0
    want = _last_json(capsys)
    assert got["epochs_run"] == want["epochs_run"]
    for k in ("best_val_loss", "test_loss"):
        assert abs(got[k] - want[k]) <= 1e-6, k
    assert got["test_accuracy"] == want["test_accuracy"]
    meta = [json.loads((corpus / ck / "meta.json").read_text())
            for ck in ("ck_1", "ck_dp0")]
    assert meta[0]["epoch"] == meta[1]["epoch"]
    cfg = model_cfg_for("digit", "constrained")
    a = np.concatenate([v.ravel() for layer in load_model(
        corpus / "ck_1", cfg)[0]["layers"] for v in layer.values()])
    b = np.concatenate([v.ravel() for layer in load_model(
        corpus / "ck_dp0", cfg)[0]["layers"] for v in layer.values()])
    np.testing.assert_array_equal(a, b)


def test_train_export_h5_and_evaluate_from_it(artifacts, corpus, capsys):
    pytest.importorskip("h5py")
    h5 = corpus / "model.h5"
    assert _train(artifacts, corpus / "ck_h5", "--export-h5", str(h5),
                  epochs=2) == 0
    cfg = model_cfg_for("digit", "constrained")
    got = load_model(h5, cfg)
    want = CheckpointManager(corpus / "ck_h5").load_best()[0]
    for a, b in zip(got[0]["layers"] + got[1]["layers"],
                    want["params"]["layers"] + want["state"]["layers"]):
        assert all(np.array_equal(a[k], b[k]) for k in a)
    capsys.readouterr()
    assert main(["evaluate", "--task", "digit", "--variant", "constrained",
                 "--data", str(artifacts), "--ckpt", str(h5), *CPU]) == 0
    assert _last_json(capsys)["confusion_matrix"]


def test_export_h5_then_evaluate_and_infer_without_h5py(
        artifacts, corpus, capsys, monkeypatch):
    """`train --export-h5`, then `evaluate` and `infer` from the .h5, with
    h5py blocked: the port's own codec writes and reads the file, and both
    commands answer as they do from the store."""
    import sys

    monkeypatch.setitem(sys.modules, "h5py", None)
    h5 = corpus / "noh5.h5"
    assert _train(artifacts, corpus / "ck_noh5", "--export-h5", str(h5),
                  epochs=2) == 0
    assert h5.exists()
    capsys.readouterr()
    outs = {}
    for label, ck in (("h5", h5), ("store", corpus / "ck_noh5")):
        assert main(["evaluate", "--task", "digit", "--variant",
                     "constrained", "--data", str(artifacts), "--ckpt",
                     str(ck), *CPU]) == 0
        ev = _last_json(capsys)
        assert main(["infer", "--task", "digit", "--variant", "constrained",
                     "--ckpt", str(ck), "--data", str(artifacts), "--audio",
                     str(corpus / "data" / "two"), "--buckets", "16",
                     *CPU]) == 0
        inf = _last_json(capsys)["results"]
        outs[label] = (ev, [(r["path"], r["label"], r["confidence"])
                            for r in inf])
    assert outs["h5"][0]["test_accuracy"] == outs["store"][0]["test_accuracy"]
    assert outs["h5"][0]["confusion_matrix"] == \
        outs["store"][0]["confusion_matrix"]
    assert outs["h5"][1] == outs["store"][1]


def test_friendly_errors(tmp_path, capsys):
    assert main(["train", "--task", "digit", "--data", str(tmp_path),
                 "--ckpt", str(tmp_path / "ck"), *CPU]) == 2
    assert "prepare-data" in capsys.readouterr().err
    assert main(["evaluate", "--task", "digit", "--data", str(tmp_path),
                 "--ckpt", str(tmp_path / "missing"), *CPU]) == 2
    with pytest.raises(SystemExit, match="no checkpoint"):
        load_model(tmp_path / "missing", model_cfg_for("digit",
                                                        "constrained"))
    with pytest.raises(SystemExit, match="not found"):
        load_model(tmp_path / "missing.h5", model_cfg_for("digit",
                                                           "constrained"))


def test_wrong_variant_checkpoint_exits(trained_pair):
    cu, _ = trained_pair
    with pytest.raises(SystemExit, match="BatchNormalization|wrong"):
        load_model(cu, model_cfg_for("speaker", "unconstrained"))


def test_evaluate(artifacts, trained_pair, tmp_path, capsys):
    from asr_using_robust_nn_tpu_torch.data.pipeline import (
        load_artifacts, standardize_fit_all)
    from asr_using_robust_nn_tpu_torch.models.convert import (
        params_from_numpy)
    from asr_using_robust_nn_tpu_torch.train.trainer import (
        TrainConfig, Trainer)

    _, cc = trained_pair
    png = tmp_path / "conf.png"
    assert main(["evaluate", "--task", "digit", "--variant", "constrained",
                 "--data", str(artifacts), "--ckpt", str(cc), "--plot",
                 str(png), *CPU]) == 0
    res = _last_json(capsys)
    d = load_artifacts(artifacts)
    te = standardize_fit_all(d.train_data, d.dev_data, d.test_data)[2]
    cfg = model_cfg_for("digit", "constrained")
    loss, acc = Trainer(cfg, TrainConfig(batch_size=256),
                        device="cpu").evaluate(
        *params_from_numpy(*load_model(cc, cfg), "cpu"), te, d.test_label)
    assert res["test_loss"] == pytest.approx(loss, abs=1e-7)
    assert res["test_accuracy"] == pytest.approx(acc, abs=1e-7)
    conf = np.asarray(res["confusion_matrix"])
    assert conf.shape == (10, 10) and conf.sum() == len(d.test_label)
    assert png.stat().st_size > 0


def test_certify_l2_default_grid(artifacts, trained_pair, corpus, capsys):
    cu, cc = trained_pair
    out_json = corpus / "cert.json"
    assert main(["certify", "--task", "digit", "--data", str(artifacts),
                 "--constrained", str(cc), "--unconstrained", str(cu),
                 "--out", str(out_json), *CPU]) == 0
    cert = json.loads(out_json.read_text())
    assert cert["norm"] == "l2" and len(cert["certified_constrained"]) == 10
    assert cert["strengths"][0] == 0.0
    assert cert["lipschitz_sound_constrained"] > 0
    curve = cert["certified_constrained"]
    assert all(a >= b for a, b in zip(curve, curve[1:]))
    capsys.readouterr()
    assert main(["evaluate", "--task", "digit", "--variant", "constrained",
                 "--data", str(artifacts), "--ckpt", str(cc), *CPU]) == 0
    assert curve[0] == pytest.approx(_last_json(capsys)["test_accuracy"],
                                     abs=1e-6)


def test_certify_linf_explicit_grid(artifacts, trained_pair, capsys):
    cu, cc = trained_pair
    assert main(["certify", "--task", "digit", "--data", str(artifacts),
                 "--constrained", str(cc), "--unconstrained", str(cu),
                 "--norm", "linf", "--strengths", "0.0,0.01", *CPU]) == 0
    out = capsys.readouterr().out
    assert "eps=0" in out
    res = json.loads(out.strip().splitlines()[-1])
    assert res["norm"] == "linf" and len(res["certified_unconstrained"]) == 2


class TestInfer:
    def test_infer_digit_dir(self, artifacts, trained_pair, corpus, capsys):
        cu, _ = trained_pair
        assert main(["infer", "--task", "digit", "--variant",
                     "unconstrained", "--ckpt", str(cu), "--data",
                     str(artifacts), "--audio", str(corpus / "data" / "zero"),
                     "--buckets", "16", "--warmup", *CPU]) == 0
        summ = _last_json(capsys)
        assert summ["n_files"] == 10
        assert all(0 <= r["label"] < 10 for r in summ["results"])
        assert summ["latency"]["n"] >= 1 and summ["latency"]["p50_ms"] > 0
        assert summ["frontend_backend"] == "cuda"  # the twin on the CPU

    def test_infer_matches_engine(self, artifacts, trained_pair, corpus,
                                  capsys):
        from asr_using_robust_nn_tpu_torch.serve.engine import (
            InferenceEngine)

        _, cc = trained_pair
        assert main(["infer", "--task", "digit", "--variant", "constrained",
                     "--ckpt", str(cc), "--data", str(artifacts), "--audio",
                     str(corpus / "data" / "one"), "--buckets", "16",
                     *CPU]) == 0
        summ = _last_json(capsys)
        eng = InferenceEngine.from_checkpoint(
            "digit", "constrained", str(cc), artifacts_dir=str(artifacts),
            buckets=(16,), device="cpu")
        res = eng.classify_files([r["path"] for r in summ["results"]])
        assert [r["label"] for r in summ["results"]] == \
            [r["label"] for r in res]

    def test_infer_arg_errors(self, artifacts, trained_pair, tmp_path,
                              capsys):
        cu, _ = trained_pair
        base = ["infer", "--task", "digit", "--ckpt", str(cu), *CPU]
        assert main(base + ["--audio", "/tmp/definitely-missing.wav"]) == 2
        assert "--data" in capsys.readouterr().err
        assert main(base + ["--data", str(artifacts), "--audio",
                            str(tmp_path / "missing.wav")]) == 2
        assert "neither" in capsys.readouterr().err
        empty = tmp_path / "emptydir"
        empty.mkdir()
        assert main(base + ["--data", str(artifacts), "--audio",
                            str(empty)]) == 2
        assert "no .wav" in capsys.readouterr().err
        assert main(base + ["--data", str(artifacts), "--audio", str(empty),
                            "--buckets", "4,x"]) == 2
        assert "comma-separated" in capsys.readouterr().err
        wav = tmp_path / "a.wav"
        audio_io.write_wav(wav, np.zeros(16000, np.float32), 16000)
        assert main(["infer", "--task", "digit", "--ckpt",
                     str(tmp_path / "nope"), "--data", str(artifacts),
                     "--audio", str(wav), *CPU]) == 2
        assert "no checkpoint" in capsys.readouterr().err


def test_resume_parity_with_jax(tmp_path):
    """Both packages' `train --resume` for one streaming epoch from the same
    checkpoint on the same artifacts: speaker_unconstrained (dropout 0, no
    BatchNorm), so nothing random remains but the shuffle, which both draw
    from numpy's default_rng(seed). The starting checkpoint is the JAX
    package's own 2-epoch run, copied into the port's store (the packages'
    inits draw from different generators). Best params within 1e-5."""
    art = _write_artifacts(tmp_path / "art", 2020, 4, (128, 32, 16), 0.1,
                           seed=11)
    args = ["--task", "speaker", "--variant", "unconstrained", "--data",
            str(art), "--batch-size", "16", "--log-every", "0"]
    ck_j, ck_p = tmp_path / "ck_j", tmp_path / "ck_p"
    assert (jmain(["train", *args, "--ckpt", str(ck_j), "--epochs", "2"])
            or 0) == 0
    tree, meta0 = jck.CheckpointManager(ck_j).load_best()
    adam = tree["opt_state"][0]  # (ScaleByAdamState, EmptyState), restored
    CheckpointManager(ck_p).save_best(
        tree["params"], tree["state"],
        {k: adam[k] for k in ("count", "mu", "nu")}, meta0["epoch"],
        meta0["val_loss"])
    assert (jmain(["train", *args, "--ckpt", str(ck_j), "--epochs", "1",
                   "--resume"]) or 0) == 0
    assert main(["train", *args, "--ckpt", str(ck_p), "--epochs", "1",
                 "--resume", *CPU]) == 0
    jtree, jmeta = jck.CheckpointManager(ck_j).load_best()
    ptree, pmeta = CheckpointManager(ck_p).load_best()
    assert jmeta["val_loss"] < meta0["val_loss"]  # the resumed epoch saved
    assert pmeta["epoch"] == jmeta["epoch"]
    assert pmeta["val_loss"] == pytest.approx(jmeta["val_loss"], abs=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(ptree["params"]),
                    jax.tree_util.tree_leaves(jtree["params"])):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-5, rtol=0)
