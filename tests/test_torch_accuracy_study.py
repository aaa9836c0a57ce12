"""The port's accuracy study (asr_using_robust_nn_tpu_torch/baselines/
accuracy_study.py) against `baselines/accuracy_study.py` and its archive,
on the CPU.

- `summarize` on the archived runs of `baselines/accuracy_study.json`
  reproduces the archived `summary` blocks, bootstrap included, at their
  stored precision (every key the archive stores; its digit block predates
  the selection analysis).
- `corpus_fingerprint` equals the JAX function's; the archive's runs are
  found by task, corpus seed, training seeds and fingerprint, and nothing is
  found for another corpus.
- `evaluate_models` from the same weights equals the JAX function's rows
  (shared noise draws, FGSM on each model's own gradients).
- A tiny framework arm: both packages' `run_framework_pipeline` on one
  blobs task from their own seeds; the seed-mean clean accuracies of each
  variant agree within the F3 margin max(4 s sqrt(2/n), 2/n_test).
- `main` runs end to end at a tiny size: the port's column beside "not run"
  archive columns, the JSON and the Markdown written; `--md-only` rebuilds
  the summary from the JSON.
"""

import argparse
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from asr_using_robust_nn_tpu.models import mlp as jmlp
from asr_using_robust_nn_tpu_torch.baselines import accuracy_study as acc
from asr_using_robust_nn_tpu_torch.models.convert import params_from_numpy
from asr_using_robust_nn_tpu_torch.models.mlp import MLPConfig

from conftest import blobs_task

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "baselines"))
import accuracy_study as jacc  # noqa: E402

ARCHIVE = os.path.join(REPO, "baselines", "accuracy_study.json")
CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: the file keeps near its solo time under the
    suite's worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def archive():
    with open(ARCHIVE) as f:
        return json.load(f)


def _stored_equal(got, want, path=""):
    """Every key `want` stores is in `got` with the same value."""
    if isinstance(want, dict):
        for k, v in want.items():
            assert k in got, path + "/" + k
            _stored_equal(got[k], v, path + "/" + k)
    else:
        assert got == want, (path, got, want)


@pytest.mark.parametrize("task", ["digit", "speaker"])
def test_summarize_reproduces_archived_summary(archive, task):
    t = archive["tasks"][task]
    got = acc.summarize(t["runs"])
    _stored_equal(got, t["summary"])
    assert got == jacc.summarize(t["runs"])
    if task == "speaker":  # the speaker block carries the bootstrap
        assert got == t["summary"]
        assert "selection" in got["constrained"]["clean"]


def _jax_defaults(**kw):
    ns = dict(files_per_class=240, recordings=24, f1_gap=60.0,
              f1_jitter=10.0, f2_gap=100.0, f2_jitter=15.0, noise_floor=0.10,
              shortcut_amp=0.006)
    ns.update(kw)
    return argparse.Namespace(**ns)


def test_corpus_fingerprint_and_archive_match(archive):
    for task in ("digit", "speaker"):
        for kw in ({}, {"files_per_class": 8, "recordings": 5},
                   {"f1_gap": 25.0, "shortcut_amp": 0.0}):
            args = _jax_defaults(**kw)
            assert acc.corpus_fingerprint(task, args) == \
                jacc.corpus_fingerprint(task, args)
        fp = jacc.corpus_fingerprint(task, _jax_defaults())
        assert acc.archive_fingerprint(task, archive) == fp
        for r in archive["tasks"][task]["runs"]:
            arms = acc.archived_arms(archive, task, r["seed"],
                                     r["train_seeds"], fp)
            assert arms == {k: r[k] for k in ("reference", "framework",
                                              "cross")}
        assert acc.archived_arms(archive, task, 0, [1, 2, 3, 4], fp) is None
        other = jacc.corpus_fingerprint(task, _jax_defaults(
            files_per_class=8, recordings=5))
        assert acc.archived_arms(archive, task, 0, [1000, 1001, 1002, 1003],
                                 other) is None


def test_evaluate_models_from_the_same_weights_matches_jax():
    rng = np.random.default_rng(1)
    x, y = blobs_task(rng, n=160, d=12, k=4, noise=1.5, spread=1.0)
    y = y.astype(np.int64)
    kw = dict(in_dim=12, n_classes=4, hidden=(16, 8), dropout=(0.0, 0.0))
    jmodels, models = {}, {}
    for i, (variant, extra) in enumerate((("unconstrained", {}),
                                          ("constrained", {"nonneg": True}))):
        jcfg, cfg = jmlp.MLPConfig(**kw, **extra), MLPConfig(**kw, **extra)
        p, s = jax.tree_util.tree_map(np.asarray, jmlp.init_mlp(
            jcfg, jax.random.PRNGKey(i)))
        jmodels[variant] = [(*jacc.make_framework_eval(jcfg, p, s), 0.5)]
        tp, ts = params_from_numpy(p, s, device=CPU)
        models[variant] = [(*acc.make_framework_eval(cfg, tp, ts, CPU), 0.5)]
    draws = {s: np.random.default_rng(7).standard_normal(x.shape)
             for s in acc.NOISE_SIGMAS}
    want = jacc.evaluate_models(jmodels, x, y, draws)
    got = acc.evaluate_models(models, x, y, draws)
    assert acc.NOISE_SIGMAS == jacc.NOISE_SIGMAS
    assert acc.FGSM_EPS == jacc.FGSM_EPS
    for variant in want:
        (g,), (w,) = got[variant], want[variant]
        assert sorted(g) == sorted(w)
        for k in w:
            assert abs(g[k] - w[k]) <= 1 / len(y) + 1e-9, (variant, k)


def test_framework_arm_seed_means_within_f3_margin(monkeypatch):
    """Both packages' framework arm (fit_multi_run on the f32 plain path,
    dropout 0.1 on the first block) on one blobs task, four training seeds
    each, from each package's own initialization."""
    rng = np.random.default_rng(3)
    x, y = blobs_task(rng, n=1400, d=20, k=4, noise=2.4, spread=1.0)
    y = y.astype(np.int64)
    feats = (x[:800], y[:800], x[800:1000], y[800:1000], x[1000:],
             y[1000:])
    kw = dict(in_dim=20, n_classes=4, hidden=(32, 16), dropout=(0.1, 0.0))
    presets = {"unconstrained": {}, "constrained": {"nonneg": True}}
    for name, extra in presets.items():
        monkeypatch.setattr(
            jmlp.MLPConfig, f"digit_{name}",
            staticmethod(lambda extra=extra: jmlp.MLPConfig(**kw, **extra)))
    seeds = [1000, 1001, 1002, 1003]
    jm = jacc.run_framework_pipeline("digit", feats, 30, 30, 2.0, seeds)
    pm, epochs_run = acc.run_framework_pipeline(
        "digit", feats, 30, 30, 2.0, seeds, device=CPU,
        cfgs={n: MLPConfig(**kw, **e) for n, e in presets.items()})
    assert sorted(epochs_run) == sorted(presets)
    assert all(e == [30] * 4 for e in epochs_run.values())
    draws = {s: np.random.default_rng(5).standard_normal(feats[4].shape)
             for s in acc.NOISE_SIGMAS}
    want = jacc.evaluate_models(jm, feats[4], feats[5], draws)
    got = acc.evaluate_models(pm, feats[4], feats[5], draws)
    for name in presets:
        f3 = acc.f3_margin([r["clean"] for r in want[name]],
                           [r["clean"] for r in got[name]], len(feats[5]))
        print(name, f3)
        assert 0.4 < f3["port"] < 0.97, f3  # neither chance nor saturated
        assert f3["ok"], f3


def test_f3_margin_formula():
    f3 = acc.f3_margin([0.5, 0.6, 0.7, 0.6], [0.55, 0.65, 0.6, 0.6], 100)
    s = np.sqrt((np.var([0.5, 0.6, 0.7, 0.6], ddof=1)
                 + np.var([0.55, 0.65, 0.6, 0.6], ddof=1)) / 2)
    assert f3["margin"] == pytest.approx(max(4 * s * np.sqrt(2 / 4), 0.02))
    assert f3["gap"] == pytest.approx(0.0) and f3["ok"]
    assert not acc.f3_margin([0.5] * 4, [0.6] * 4, 100)["ok"]


def test_main_end_to_end_tiny(tmp_path, capsys):
    out, md = tmp_path / "a.json", tmp_path / "a.md"
    argv = ["--tasks", "digit", "--seeds", "1", "--train-seeds", "2",
            "--files-per-class", "4", "--digit-epochs", "2", "--patience",
            "2", "--device", CPU, "--workdir", str(tmp_path / "w"),
            "--out", str(out), "--md", str(md), "--archive", ARCHIVE]
    assert acc.main(argv) == 0
    res = json.loads(out.read_text())
    assert res["speech_commands_fetch"].startswith("blocked")
    assert res["protocol"]["epoch_backend"] == "plain"
    (run,) = res["tasks"]["digit"]["runs"]
    assert run["train_seeds"] == [1000, 1001]
    assert run["framework"] == run["reference"] == run["cross"] == "not run"
    assert run["feature_max_abs_gap"] < 5e-4
    assert sorted(run["port"]) == ["constrained", "unconstrained"]
    assert sorted(run["port"]["constrained"][0]) == sorted(
        ["clean", "noise@0.5", "noise@1.0", "fgsm@0.1", "fgsm@0.3",
         "val_loss"])
    summary = res["tasks"]["digit"]["summary"]
    assert summary["n_matched"] == 0
    text = md.read_text()
    assert "| constrained | clean | not run | not run |" in text
    capsys.readouterr()
    md.unlink()
    assert acc.main(["--md-only", "--out", str(out), "--md", str(md)]) == 0
    assert json.loads(out.read_text())["tasks"]["digit"]["summary"] == summary
    assert md.read_text() == text
