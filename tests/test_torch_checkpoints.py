"""The port's checkpoint store, h5 interop and metric writer
(asr_using_robust_nn_tpu_torch/train/checkpoints.py, utils/profiling.py)
against the JAX package's: the same trees, files and messages through both.

The port's store is `best.npz` + `meta.json` (no Orbax); trees cross as
numpy. Trainer fits run on the CPU at small widths.
"""

import json
import sys

import jax
import numpy as np
import pytest
import torch

from asr_using_robust_nn_tpu.models import mlp as jmlp
from asr_using_robust_nn_tpu.train import checkpoints as jck
from asr_using_robust_nn_tpu_torch.models import mlp
from asr_using_robust_nn_tpu_torch.models.convert import (
    adam_state_from_numpy, adam_state_to_numpy, params_from_numpy)
from asr_using_robust_nn_tpu_torch.train import checkpoints as ck
from asr_using_robust_nn_tpu_torch.train.trainer import TrainConfig, Trainer
from asr_using_robust_nn_tpu_torch.utils.profiling import (
    MetricWriter, StepTimer, trace)

from conftest import blobs_task

KW = dict(in_dim=16, n_classes=4, hidden=(32, 16), dropout=(0.0, 0.0))


def _trees(seed=0, **kw):
    """Seeded (params, state) from the JAX init as numpy, and both cfgs."""
    jcfg = jmlp.MLPConfig(**dict(KW, **kw))
    p, s = jax.tree_util.tree_map(
        np.asarray, jmlp.init_mlp(jcfg, jax.random.PRNGKey(seed)))
    return jcfg, mlp.MLPConfig(**dict(KW, **kw)), p, s


def _opt(params, seed=1):
    rng = np.random.default_rng(seed)
    f = lambda a: rng.standard_normal(np.shape(a)).astype(np.float32)  # noqa: E731
    return {"count": np.int32(7),
            "mu": jax.tree_util.tree_map(f, params),
            "nu": jax.tree_util.tree_map(lambda a: np.abs(f(a)), params)}


def _equal(a, b):
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        y = y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        assert x.shape == y.shape and np.array_equal(x, y)


@pytest.mark.parametrize("batch_norm", [True, False])
def test_store_round_trip_bit_equal(tmp_path, batch_norm):
    """Tensors in, numpy out, bit for bit; flat keys in the JAX layout;
    empty state dicts survive; the file needs no pickle."""
    _, _, p, s = _trees(batch_norm=batch_norm)
    o = _opt(p)
    params, state = params_from_numpy(p, s, device="cpu")
    opt = adam_state_from_numpy(o["count"], o["mu"], o["nu"], device="cpu")
    mgr = ck.CheckpointManager(tmp_path / "ck")
    mgr.save_best(params, state, opt, epoch=3, val_loss=np.float32(0.25))
    tree, meta = ck.CheckpointManager(tmp_path / "ck").load_best()
    assert meta == {"epoch": 3, "val_loss": 0.25}
    _equal(tree["params"], p)
    _equal(tree["state"], s)
    assert tree["state"]["layers"][-1] == {}
    _equal(tree["opt_state"], o)
    assert tree["opt_state"]["count"].dtype == np.int32
    with np.load(tmp_path / "ck" / "best.npz", allow_pickle=False) as z:
        files = set(z.files)
    assert {"params/layers/0/w", "opt_state/count",
            "opt_state/mu/layers/2/b"} <= files
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "best.npz", "meta.json"]
    assert mgr.writes == 1 and mgr.write_seconds > 0


def test_interrupted_save_keeps_previous_best(tmp_path, monkeypatch):
    _, _, p, s = _trees()
    mgr = ck.CheckpointManager(tmp_path)
    mgr.save_best(p, s, _opt(p), epoch=0, val_loss=1.0)

    def fail(f, **arrays):
        f.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(ck.np, "savez", fail)
    p2 = jax.tree_util.tree_map(lambda a: a + 1.0, p)
    with pytest.raises(OSError):
        mgr.save_best(p2, s, _opt(p), epoch=1, val_loss=0.5)
    monkeypatch.undo()
    tree, meta = mgr.load_best()
    _equal(tree["params"], p)
    assert meta == {"epoch": 0, "val_loss": 1.0}
    assert sorted(x.name for x in tmp_path.iterdir()) == ["best.npz",
                                                          "meta.json"]


def test_tree_saved_by_jax_orbax_store_reads_back_equal(tmp_path):
    """A tree the JAX CheckpointManager saves and restores, written by the
    port's store, reads back equal; meta.json has the same keys."""
    _, _, p, s = _trees(seed=4)
    o = _opt(p, seed=5)
    jm = jck.CheckpointManager(tmp_path / "orbax")
    jm.save_best(p, s, o, epoch=2, val_loss=0.75)
    jtree, jmeta = jm.load_best()
    pm = ck.CheckpointManager(tmp_path / "port")
    pm.save_best(jtree["params"], jtree["state"], jtree["opt_state"],
                 epoch=jmeta["epoch"], val_loss=jmeta["val_loss"])
    tree, meta = pm.load_best()
    assert meta == jmeta
    for k in ("params", "state", "opt_state"):
        _equal(tree[k], jtree[k])
    assert [sorted(lay) for lay in tree["state"]["layers"]] == [
        sorted(lay) for lay in jtree["state"]["layers"]]


@pytest.mark.parametrize("case", ["wrong_width", "wrong_variant", "good"])
def test_validate_model_tree_messages_match_jax(case):
    jcfg, cfg, p, s = _trees()
    if case == "wrong_width":
        jcfg, cfg = (c.__class__(**dict(KW, in_dim=20)) for c in (jcfg, cfg))
    elif case == "wrong_variant":
        jcfg, cfg = (c.__class__(**dict(KW, batch_norm=False))
                     for c in (jcfg, cfg))
    msgs = []
    for fn, c in ((jck.validate_model_tree, jcfg),
                  (ck.validate_model_tree, cfg)):
        try:
            fn(p, s, c)
            msgs.append(None)
        except ValueError as e:
            msgs.append(str(e))
    assert msgs[0] == msgs[1]
    assert (msgs[1] is None) == (case == "good")
    if case != "good":
        assert "wrong --task/--variant" in msgs[1]


def _keras3_h5(path, p, s, h5py):
    """The Keras 3 `.weights.h5` layout: layers/<name>/vars/<idx>."""
    with h5py.File(path, "w") as f:
        for i, layer in enumerate(p["layers"]):
            name = f"dense_{i}" if i else "dense"
            g = f.create_group(f"layers/{name}/vars")
            g.create_dataset("0", data=layer["w"])
            g.create_dataset("1", data=layer["b"])
            if "gamma" in layer:
                bname = (f"batch_normalization_{i}" if i
                         else "batch_normalization")
                g = f.create_group(f"layers/{bname}/vars")
                for j, v in enumerate((layer["gamma"], layer["beta"],
                                       s["layers"][i]["mean"],
                                       s["layers"][i]["var"])):
                    g.create_dataset(str(j), data=v)


@pytest.mark.parametrize("layout", ["tf2", "keras3"])
def test_import_keras_h5_reads_jax_files(tmp_path, layout):
    """Files the JAX package writes (TF2 layout) or a Keras 3 layout file:
    the port's import equals the JAX import bit for bit."""
    h5py = pytest.importorskip("h5py")
    jcfg, cfg, p, s = _trees(seed=6)
    s["layers"][0]["var"] = s["layers"][0]["var"] + 0.5  # not the init
    path = str(tmp_path / "m.h5")
    if layout == "tf2":
        jck.export_h5(path, p, s)
    else:
        _keras3_h5(path, p, s, h5py)
    got = ck.import_keras_h5(path, cfg)
    want = jax.tree_util.tree_map(np.asarray, jck.import_keras_h5(path, jcfg))
    _equal(got, want)
    _equal(got[0], p)


def test_import_keras_h5_rejects_bn_and_dense_mismatch(tmp_path):
    pytest.importorskip("h5py")
    jcfg, cfg, p, s = _trees()
    _, cfg_no, p2, s2 = _trees(batch_norm=False)
    jck.export_h5(tmp_path / "bn.h5", p, s)
    jck.export_h5(tmp_path / "no_bn.h5", p2, s2)
    with pytest.raises(ValueError, match="BatchNormalization"):
        ck.import_keras_h5(tmp_path / "bn.h5", cfg_no)
    with pytest.raises(ValueError, match="BatchNormalization"):
        ck.import_keras_h5(tmp_path / "no_bn.h5", cfg)
    with pytest.raises(ValueError, match="3 dense layers"):
        ck.import_keras_h5(tmp_path / "bn.h5", mlp.MLPConfig(
            **dict(KW, hidden=(32, 16, 8), dropout=(0.0,) * 3)))


def test_port_export_h5_read_by_jax(tmp_path):
    pytest.importorskip("h5py")
    jcfg, cfg, p, s = _trees(seed=8)
    params, state = params_from_numpy(p, s, device="cpu")
    ck.export_h5(tmp_path / "port.h5", params, state)
    got = jax.tree_util.tree_map(
        np.asarray, jck.import_keras_h5(tmp_path / "port.h5", jcfg))
    _equal(got, (p, s))


def test_h5_helpers_raise_plain_error_without_h5py(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    _, cfg, p, s = _trees()
    for call in (lambda: ck.export_h5(tmp_path / "x.h5", p, s),
                 lambda: ck.import_keras_h5(tmp_path / "x.h5", cfg)):
        with pytest.raises(RuntimeError, match="needs h5py"):
            call()


def _fit_task(n=160):
    x, y = blobs_task(np.random.default_rng(3), n=n, d=16, k=4)
    return x[:96], y[:96].astype(np.int64), x[96:], y[96:].astype(np.int64)


def test_fit_checkpoints_every_improvement_and_resume_keeps_best(tmp_path):
    """The JAX suite's retention and resume checks
    (tests/test_models_train.py) on the port's store."""
    tx, ty, vx, vy = _fit_task()
    cfg = mlp.MLPConfig(**KW)
    tr = Trainer(cfg, TrainConfig(batch_size=32, epochs=8, patience=100),
                 device="cpu")
    res = tr.fit(tx, ty, vx, vy, checkpoint_dir=tmp_path / "ck")
    improvements = len(set(np.minimum.accumulate(
        res["history"]["val_loss"])))
    assert res["checkpoint_writes"] == improvements
    mgr = ck.CheckpointManager(tmp_path / "ck")
    tree, meta0 = mgr.load_best()
    assert meta0["val_loss"] == pytest.approx(res["best_val_loss"], abs=1e-9)
    assert meta0["epoch"] == int(np.argmin(res["history"]["val_loss"]))
    _equal(tree["params"], res["best_params"])
    # resume as the CLI does: warm params/state/Adam + the stored best val
    tr2 = Trainer(cfg, TrainConfig(batch_size=32, epochs=1, patience=100),
                  device="cpu")
    o = tree["opt_state"]
    res2 = tr2.fit(tx, ty, vx, vy,
                   *params_from_numpy(tree["params"], tree["state"], "cpu"),
                   opt_state=adam_state_from_numpy(o["count"], o["mu"],
                                                   o["nu"], device="cpu"),
                   initial_best_val=meta0["val_loss"],
                   checkpoint_dir=tmp_path / "ck")
    assert int(res2["opt_state"]["count"]) == int(o["count"]) + 3
    _, meta2 = mgr.load_best()
    assert meta2["val_loss"] <= meta0["val_loss"]
    assert res2["best_val_loss"] <= meta0["val_loss"]
    # an unbeatable seed: the store and best_params stay the warm start
    tree3, _ = mgr.load_best()
    res3 = Trainer(cfg, TrainConfig(batch_size=32, epochs=1, patience=100),
                   device="cpu").fit(
        tx, ty, vx, vy,
        *params_from_numpy(tree3["params"], tree3["state"], "cpu"),
        initial_best_val=0.0, checkpoint_dir=tmp_path / "ck")
    assert res3["best_val_loss"] == 0.0 and res3["checkpoint_writes"] == 0
    _equal(res3["best_params"], tree3["params"])
    _, meta3 = mgr.load_best()
    assert meta3 == meta2


def test_fit_metrics_dir_writes_jax_events(tmp_path, monkeypatch):
    """Per-epoch scalars as the JAX MetricWriter writes them; TensorBoard
    mirroring through torch.utils.tensorboard's SummaryWriter (a recording
    stand-in here)."""
    calls = []

    class FakeWriter:
        def __init__(self, log_dir):
            calls.append(("open", log_dir))

        def add_scalar(self, tag, value, global_step):
            calls.append((tag, value, global_step))

        def close(self):
            calls.append(("close",))

    fake = type(sys)("torch.utils.tensorboard")
    fake.SummaryWriter = FakeWriter
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", fake)
    tx, ty, vx, vy = _fit_task()
    res = Trainer(mlp.MLPConfig(**KW), TrainConfig(batch_size=32, epochs=3,
                                                   patience=100),
                  device="cpu").fit(tx, ty, vx, vy,
                                    metrics_dir=tmp_path / "m")
    rows = [json.loads(r) for r in
            (tmp_path / "m" / "metrics.jsonl").read_text().splitlines()]
    assert [r["tag"] for r in rows] == ["loss", "acc", "val_loss",
                                        "val_acc"] * 3
    assert [r["step"] for r in rows] == [0] * 4 + [1] * 4 + [2] * 4
    assert all(set(r) == {"tag", "value", "step", "time"} for r in rows)
    assert [r["value"] for r in rows if r["tag"] == "val_loss"] == \
        res["history"]["val_loss"]
    assert calls[0] == ("open", str(tmp_path / "m")) and calls[-1] == (
        "close",) and len(calls) == 14


def test_step_timer_and_trace(tmp_path):
    t = StepTimer()
    t.tick(8)
    t.tick(8)
    s = t.summary()
    assert s["steps"] == 2 and s["examples"] == 16
    assert s["utterances_per_sec"] > 0
    with trace(str(tmp_path / "tr")):
        torch.ones(4) @ torch.ones(4)
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0
    w = MetricWriter(str(tmp_path / "w"), use_tensorboard=False)
    w.scalars({"a": 1.0}, 5)
    w.close()
    assert json.loads((tmp_path / "w" / "metrics.jsonl").read_text())[
        "step"] == 5


def test_adam_state_crosses_the_store(tmp_path):
    """bf16 moments widen exactly into the store and come back as the
    optimizer's dtype."""
    _, _, p, _ = _trees()
    o = _opt(p)
    opt = adam_state_from_numpy(o["count"], o["mu"], o["nu"], device="cpu",
                                moments_dtype=torch.bfloat16)
    mgr = ck.CheckpointManager(tmp_path)
    mgr.save_best(p, {"layers": [{}, {}, {}]}, opt, 0, 1.0)
    tree, _ = mgr.load_best()
    back = adam_state_from_numpy(*(tree["opt_state"][k] for k in
                                   ("count", "mu", "nu")), device="cpu",
                                 moments_dtype=torch.bfloat16)
    _equal(adam_state_to_numpy(back), adam_state_to_numpy(opt))
