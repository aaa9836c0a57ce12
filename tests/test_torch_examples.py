"""The port's thesis-study scripts (asr_using_robust_nn_tpu_torch/examples/)
against the repo's `examples/` originals and the JAX package, on the CPU.

- The corpus generators write the same WAV bytes and labels for the same
  seeds (both presets of `hard_corpus`, the demo's and the synthetic
  study's corpora) and `flip_labels` flips the same labels.
- The analysis block (`_study.analyze`: median margin over all test rows,
  margin / (2 L), the reference's and the sound Lipschitz estimates, the
  norms product) equals the JAX scripts' arithmetic within 1e-4 relative.
- The synthetic and the speaker study as a whole, at a tiny width (hidden
  (32, 16), 4 classes, a few epochs, dropout 0, shuffle off) from JAX's
  initial weights, against the JAX package's calls in the scripts' order on
  the same splits: clean accuracy and every FGSM / PGD point within one test
  row; the black-box sweeps' clean point exactly; their noisy points (other
  draws: threefry against torch's generator) within
  4 sqrt(2 p (1 - p) / n) plus one row.
- `hardness_sweep.eval_cell` writes a record with the JAX function's keys,
  and the built-in grids and probe strengths are JAX's.
- The demo runs end to end; every study's `main` refuses to run without a
  card unless given `--device cpu`; the port's `reproduce_thesis.sh` passes
  `bash -n` and every command in it parses with the port CLI's argparse.
"""

import argparse
import contextlib
import json
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from asr_using_robust_nn_tpu.attacks import sweeps as jsweeps
from asr_using_robust_nn_tpu.constraints import (
    get_lipschitz_constrained as jlip,
    get_lipschitz_sound as jlip_sound,
    get_norms as jnorms,
    get_upper_lipschitz as jupper,
    make_simple_norm_constraint as jmake,
)
from asr_using_robust_nn_tpu.data import build_dataset as jbuild
from asr_using_robust_nn_tpu.data import standardize_fit_all as jstd
from asr_using_robust_nn_tpu.models import mlp as jmlp
from asr_using_robust_nn_tpu.ops.mfcc_xla import FrontendConfig as JFEConfig
from asr_using_robust_nn_tpu.train import TrainConfig as JTrainConfig
from asr_using_robust_nn_tpu.train import Trainer as JTrainer
from asr_using_robust_nn_tpu.utils import native as jnative
from asr_using_robust_nn_tpu_torch.cli import main as port_cli
from asr_using_robust_nn_tpu_torch.examples import (
    _study,
    demo_synthetic as demo,
    hard_corpus as hc,
    hardness_sweep as hard,
    robustness_study_speaker as spk,
    robustness_study_synthetic as syn,
)
from asr_using_robust_nn_tpu_torch.models.mlp import MLPConfig
from asr_using_robust_nn_tpu_torch.ops import cuda_train
from asr_using_robust_nn_tpu_torch.train import TrainConfig
from examples import demo_synthetic as jdemo
from examples import hard_corpus as jhc
from examples import hardness_sweep as jhard
from examples import robustness_study_synthetic as jsyn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
NAMES = ("unconstrained", "constrained")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: the file keeps near its solo time under the
    suite's worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- (a) the corpora ---------------------------------------------------------

def _tree_bytes(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


CORPORA = {
    "hard": (jhc.make_hard_corpus, hc.make_hard_corpus,
             dict(n_classes=3, files_per_class=2, seed=4, sr=22050)),
    "hard_shortcut": (jhc.make_hard_corpus, hc.make_hard_corpus,
                      dict(n_classes=2, files_per_class=2, seed=1,
                           shortcut_amp=0.006, noise_floor=0.1)),
    "speaker": (jhc.make_speaker_corpus, hc.make_speaker_corpus,
                dict(n_speakers=3, recordings=2, duration_s=1.0, seed=2,
                     sr=22050)),
    "demo": (jdemo.make_corpus, demo.make_corpus,
             dict(n_classes=2, files_per_class=3, seed=0)),
    "synthetic": (jsyn.make_corpus, syn.make_corpus,
                  dict(n_classes=3, files_per_class=2, seed=5)),
}


@pytest.mark.parametrize("case", sorted(CORPORA))
def test_corpus_bytes_match_jax(case, tmp_path):
    jgen, gen, kw = CORPORA[case]
    jdir = jgen(str(tmp_path / "jax"), **kw)
    pdir = gen(str(tmp_path / "port"), **kw)
    assert os.path.relpath(jdir, tmp_path / "jax") == \
        os.path.relpath(pdir, tmp_path / "port") == "data"
    want, got = _tree_bytes(jdir), _tree_bytes(pdir)
    assert sorted(got) == sorted(want) and len(want) > 3
    for name in want:
        assert got[name] == want[name], name


def test_flip_labels_match_jax():
    labels = np.random.default_rng(3).integers(0, 10, 500)
    for frac, seed in ((0.0, 0), (0.15, 1), (0.5, 7)):
        want = jhc.flip_labels(labels, frac, 10, seed)
        got = hc.flip_labels(labels, frac, 10, seed)
        np.testing.assert_array_equal(got, want)
        if frac:
            assert 0 < np.mean(got != labels) < 2 * frac


# -- (b) the analysis block ----------------------------------------------------

def _jax_analysis(jcfg, p, s, te, yte):
    """The JAX scripts' arithmetic (`robustness_study_speaker.py:128-144`)."""
    logits = np.asarray(jmlp.apply_mlp(jcfg, p, s, jax.numpy.asarray(
        te, jax.numpy.float32), train=False)[0])
    rows = np.arange(len(te))
    z_true = logits[rows, yte]
    masked = logits.copy()
    masked[rows, yte] = -np.inf
    med = float(np.median(z_true - masked.max(axis=1)))
    lip = float(jlip(jcfg, p, s))
    return {"lipschitz": lip, "lipschitz_sound": float(jlip_sound(jcfg, p, s)),
            "norms_product": float(jupper(np.asarray(jnorms(p)))),
            "median_margin": med, "certified_radius": med / (2.0 * lip)}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_analysis_block_matches_jax_arithmetic():
    kw = dict(in_dim=12, n_classes=4, hidden=(16, 8), dropout=(0.0, 0.0))
    jcfg, cfg = jmlp.MLPConfig(**kw), MLPConfig(**kw)
    p, s = _np_tree(jmlp.init_mlp(jcfg, jax.random.PRNGKey(2)))
    rng = np.random.default_rng(0)
    for layer in s["layers"]:  # trained-looking BN state
        if "var" in layer:
            layer["mean"] = rng.normal(0, 0.3, layer["mean"].shape).astype(
                np.float32)
            layer["var"] = rng.uniform(0.2, 2.0, layer["var"].shape).astype(
                np.float32)
    te = rng.standard_normal((40, 12)).astype(np.float32)
    yte = rng.integers(0, 4, 40)
    want = _jax_analysis(jcfg, p, s, te, yte)
    from asr_using_robust_nn_tpu_torch.models.convert import params_from_numpy

    tp, ts = params_from_numpy(p, s, device=CPU)
    got = _study.analyze(cfg, tp, ts, te, yte, device=CPU)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


# -- (c) the studies as a whole ------------------------------------------------

def _tiny_cfgs(in_dim, n_classes, batch_norm_u=True):
    kw = dict(in_dim=in_dim, n_classes=n_classes, hidden=(32, 16),
              dropout=(0.0, 0.0))
    return {"unconstrained": dict(kw, batch_norm=batch_norm_u),
            "constrained": dict(kw, nonneg=True)}


def _inits(cfg_kw, seed=0):
    """JAX's initial weights of each recipe (init_mlp(PRNGKey(seed))) and
    the constrained side's power-iteration vector, as numpy."""
    out = {}
    for name, kw in cfg_kw.items():
        jcfg = jmlp.MLPConfig(**kw)
        p, s = jmlp.init_mlp(jcfg, jax.random.PRNGKey(seed))
        u = _np_tree(jmake(0.1, n_iter=8).init(p)) if name == NAMES[1] \
            else None
        out[name] = (_np_tree(p), _np_tree(s), u)
    return out


def _jax_fits(cfg_kw, inits, tr, ytr, dv, ydv, te, yte, rho, batches, epochs,
              per_dispatch):
    """The scripts' training loop on the JAX package: -> {name: (cfg,
    params, state, clean, analysis)}."""
    models = {}
    for name in NAMES:
        jcfg = jmlp.MLPConfig(**cfg_kw[name])
        p0, s0, u0 = inits[name]
        kw = {}
        if name == "constrained":
            con = jmake(rho, n_iter=8)
            kw = dict(constraint=con.apply, constraint_state=u0)
        trainer = JTrainer(jcfg, JTrainConfig(
            batch_size=batches[name], epochs=epochs, patience=epochs, seed=0,
            device_resident=True, epochs_per_dispatch=per_dispatch,
            shuffle=False), **kw)
        res = trainer.fit(tr, ytr, dv, ydv, params=p0, state=s0)
        p, s = res["best_params"], res["best_state"]
        _, acc = trainer.evaluate(p, s, te, yte)
        models[name] = (jcfg, p, s, float(acc),
                        _jax_analysis(jcfg, p, s, te, yte))
    return models


def _jax_fns(m):
    jcfg, p, s = m[:3]

    def logits(x):
        return jmlp.apply_mlp(jcfg, p, s, x, train=False)[0]

    def predict(x):
        return np.asarray(jax.nn.softmax(logits(jax.numpy.asarray(
            x, jax.numpy.float32)), -1))

    return logits, predict


def _overrides(cfg_kw, inits, batches, epochs, per_dispatch):
    return {name: dict(
        model_cfg=MLPConfig(**cfg_kw[name]),
        train_cfg=TrainConfig(batch_size=batches[name], epochs=epochs,
                              patience=epochs, seed=0, device_resident=True,
                              epochs_per_dispatch=per_dispatch,
                              shuffle=False),
        init=inits[name]) for name in NAMES}


def _hold_curves(got, want, n, blackbox, what):
    """One sweep's two curves: white-box points within one row; black-box
    clean point exact, noisy points within the draws' spread plus a row."""
    row = 1.0 / n + 1e-9
    for side in ("accuracy_constrained", "accuracy_unconstrained"):
        g = np.asarray(got[side])
        w = np.asarray(want[side])
        assert g.shape == w.shape, (what, side)
        for s, a, b in zip(want["strengths"], g, w):
            if not blackbox:
                tol = row
            elif s == 0 and what.endswith(("_mfcc", "white_audio",
                                           "mixture_audio")):
                tol = 1e-9
            else:
                p = (a + b) / 2
                tol = 4 * np.sqrt(2 * p * (1 - p) / n) + row
            assert abs(a - b) <= tol, (what, side, s, a, b, tol)


def _hold_models(res, jmodels, n_test, lip_key):
    for name in NAMES:
        _, _, _, acc, ana = jmodels[name]
        assert abs(res["clean"][name] - acc) <= 1.0 / n_test + 1e-9, name
        np.testing.assert_allclose(res[lip_key][name], ana["lipschitz"],
                                   rtol=1e-3, err_msg=name)
        np.testing.assert_allclose(res["median_margin"][name],
                                   ana["median_margin"], rtol=1e-3,
                                   atol=1e-3, err_msg=name)


@pytest.fixture(scope="module")
def digit_splits(tmp_path_factory):
    root = tmp_path_factory.mktemp("syn")
    corpus = jsyn.make_corpus(str(root), n_classes=4, files_per_class=40,
                              seed=0)
    return jbuild(corpus, "digit", seed=0)


SYN_SWEEPS = (("white_mfcc", (0.0, 1.0, 4.0)),
              ("mixture_mfcc", (0.0, 5.0)),
              ("fgsm", (0.02, 0.1)), ("pgd", (0.05, 0.2)))


def test_synthetic_study_matches_jax_calls(digit_splits):
    sp = digit_splits
    cfg_kw = _tiny_cfgs(880, 4)
    inits = _inits(cfg_kw)
    batches = {"unconstrained": 256, "constrained": 512}
    epochs, rho = 6, 0.1
    results, models = syn.run_study(
        sp, rho=rho, epochs=epochs, seed=0, device=CPU, sweeps=SYN_SWEEPS,
        overrides=_overrides(cfg_kw, inits, batches, epochs, 1),
        log=lambda m: None)
    # the JAX script's calls, in its order (`robustness_study_synthetic.py:
    # 92-205`)
    tr, dv, te, _, _ = jstd(sp.train_data, sp.dev_data, sp.test_data)
    yte = sp.test_label
    jm = _jax_fits(cfg_kw, inits, tr, sp.train_label, dv, sp.dev_label, te,
                   yte, rho, batches, epochs, 1)
    assert sorted(results) == ["certified_radius", "clean", "curves",
                               "lipschitz", "median_margin"]
    n = len(yte)
    _hold_models(results, jm, n, "lipschitz")
    lc, pc = _jax_fns(jm["constrained"])
    lu, pu = _jax_fns(jm["unconstrained"])
    for atk, strengths in SYN_SWEEPS:
        if atk.endswith("_mfcc"):
            want = jsweeps.blackbox_sweep(atk, pc, pu, yte, test_features=te,
                                          seed=0, strengths=list(strengths))
        else:
            want = jsweeps.whitebox_sweep(atk, lc, lu, pc, pu, te, yte,
                                          seed=0, strengths=list(strengths))
        _hold_curves(results["curves"][atk], want.as_dict(), n,
                     atk.endswith("_mfcc"), atk)
    assert all(m["result"]["epoch_backend"] == "plain"
               for m in models.values())


SPK_SWEEPS = (("white_audio", (0.0, 0.002, 0.005)),
              ("snr_audio", (60.0, 10.0)),
              ("mixture_audio", (0.0, 0.2)),
              ("white_mfcc", (0.0, 20.0)),
              ("mixture_mfcc", (0.0, 50.0)),
              ("fgsm", (0.02, 0.2)))


def test_speaker_study_matches_jax_calls(tmp_path):
    corpus = jhc.make_speaker_corpus(str(tmp_path), n_speakers=4,
                                     recordings=20, seed=0, sr=22050)
    sp = jbuild(corpus, "speaker", seed=0)
    cfg_kw = _tiny_cfgs(2020, 4, batch_norm_u=False)
    inits = _inits(cfg_kw)
    batches = {"unconstrained": 64, "constrained": 64}
    epochs, rho = 6, 1.0
    results, models = spk.run_study(
        sp, rho=rho, epochs=epochs, constrained_epochs=epochs, seed=0,
        device=CPU, sweeps=SPK_SWEEPS,
        overrides=_overrides(cfg_kw, inits, batches, epochs, 25),
        log=lambda m: None)
    # the JAX script's calls, in its order (`robustness_study_speaker.py:
    # 83-224`)
    tr, dv, te, _, _ = jstd(sp.train_data, sp.dev_data, sp.test_data)
    yte = sp.test_label

    def std(feats):
        return jstd(sp.train_data, sp.dev_data, feats)[2]

    jm = _jax_fits(cfg_kw, inits, tr, sp.train_label, dv, sp.dev_label, te,
                   yte, rho, batches, epochs, 25)
    n = len(yte)
    _hold_models(results, jm, n, "lipschitz_ref_formula")
    for name in NAMES:
        np.testing.assert_allclose(results["lipschitz_sound"][name],
                                   jm[name][4]["lipschitz_sound"], rtol=1e-3)
    lc, pc = _jax_fns(jm["constrained"])
    lu, pu = _jax_fns(jm["unconstrained"])
    fe_cfg = JFEConfig.speaker()
    waves = jnative.decode_resample_batch(list(sp.test_filenames), fe_cfg.sr)
    for atk, strengths in SPK_SWEEPS:
        kw = dict(seed=0, strengths=list(strengths))
        if atk.endswith("_audio"):
            want = jsweeps.blackbox_sweep(
                atk, pc, pu, sp.test_audio_label, test_waves_list=waves,
                frontend_cfg=fe_cfg, standardize=std, **kw)
        elif atk.endswith("_mfcc"):
            want = jsweeps.blackbox_sweep(atk, pc, pu, yte,
                                          test_features=sp.test_data,
                                          standardize=std, **kw)
        else:
            want = jsweeps.whitebox_sweep(atk, lc, lu, pc, pu, te, yte, **kw)
        _hold_curves(results["curves"][atk], want.as_dict(), n,
                     atk != "fgsm", atk)
    assert results["task"] == "speaker" and results["rho"] == rho
    assert [k for k in results if k not in ("corpus",)] == [
        "task", "rho", "clean", "train_fit", "lipschitz_ref_formula",
        "lipschitz_sound", "norms_product", "median_margin", "curves"]
    assert all(m["result"]["epoch_backend"] == "plain"
               for m in models.values())


def test_speaker_unconstrained_gate_runs_without_batchnorm():
    """The fused epoch's parity gate on a model without BatchNorm (the
    speaker study's unconstrained recipe) compares what it has: no BN mean
    (0), the parameters, loss and accuracy at their bars."""
    cfg = MLPConfig(in_dim=40, n_classes=4, hidden=(32, 16),
                    batch_norm=False, dropout=(0.0, 0.0))
    g = torch.Generator().manual_seed(0)
    x = torch.randn(128, 40, generator=g)
    y = torch.randint(0, 4, (128,), generator=g)
    gate = cuda_train.epoch_parity_vs_plain(cfg, 64, x, y, 128)
    assert gate["ok"] and gate["max_dmu"] == 0.0, gate


# -- (d) the hardness sweep ----------------------------------------------------

def _keys(tree):
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return ("list", len(tree))
    return type(tree).__name__ in ("int", "float")


@pytest.fixture
def tiny_presets(monkeypatch):
    """The digit presets at hidden (32, 16), dropout 0, in both packages."""
    def tiny(cls, **kw):
        return staticmethod(lambda: cls(in_dim=880, n_classes=10,
                                        hidden=(32, 16), dropout=(0.0, 0.0),
                                        **kw))

    for cls in (jmlp.MLPConfig, MLPConfig):
        monkeypatch.setattr(cls, "digit_unconstrained", tiny(cls))
        monkeypatch.setattr(cls, "digit_constrained", tiny(cls, nonneg=True))


def test_eval_cell_record_matches_jax_keys(tiny_presets):
    cell = dict(hard_kw=dict(files_per_class=2, noise_floor=0.1),
                label_noise=0.1, rho=0.3, epochs_u=2, epochs_c=2, seed=0,
                fgsm_eps=hard.FGSM_EPS, noise_sigmas=hard.NOISE_SIGMAS)
    want = jhard.eval_cell(**cell)
    got = hard.eval_cell(**cell, device=CPU)
    assert _keys(got) == _keys(want)
    json.dumps(got)
    assert got["n_train"] == want["n_train"]
    assert got["hard"] == want["hard"]
    hard._SPLITS_CACHE.clear()
    jhard._SPLITS_CACHE.clear()


@pytest.mark.parametrize("task", ["digit", "speaker"])
def test_hardness_grids_match_jax(task, tmp_path, monkeypatch):
    seen = []

    def record(hard_kw, label_noise, rho, epochs_u, epochs_c, seed,
               fgsm_eps, noise_sigmas, task="digit"):
        seen.append((dict(hard=hard_kw, label_noise=label_noise, rho=rho),
                     list(fgsm_eps), list(noise_sigmas)))
        return {"crossover": {"clean_gap": 0.0, "fgsm_c_minus_u": []}}

    monkeypatch.setattr(jhard, "eval_cell", record)
    monkeypatch.setattr(sys, "argv", ["hardness_sweep", "--task", task,
                                      "--out", str(tmp_path / "o.jsonl")])
    jhard.main()
    assert [c for c, _, _ in seen] == hard.default_cells(task)
    assert all(f == hard.FGSM_EPS and s == hard.NOISE_SIGMAS
               for _, f, s in seen)


# -- the demo, the device rule, reproduce_thesis.sh ---------------------------

def test_demo_runs_end_to_end(tmp_path, capsys):
    assert demo.main(["--workdir", str(tmp_path), "--device", CPU]) == 0
    out = capsys.readouterr().out
    assert "demo complete" in out
    accs = [float(m) for m in re.findall(r"clean test acc ([0-9.]+)", out)]
    assert len(accs) == 2 and min(accs) > 0.5, out


@pytest.mark.parametrize("module", ["demo_synthetic",
                                    "robustness_study_synthetic",
                                    "robustness_study_speaker",
                                    "hardness_sweep", "accuracy_study"])
def test_study_main_needs_a_card_unless_told_cpu(module, tmp_path,
                                                 monkeypatch):
    """Without `--device` every study runs on the card; where torch sees no
    CUDA device, `main` raises before it writes anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves")
    from asr_using_robust_nn_tpu_torch.baselines import accuracy_study

    mains = {"demo_synthetic": demo.main,
             "robustness_study_synthetic": syn.main,
             "robustness_study_speaker": spk.main,
             "hardness_sweep": hard.main,
             "accuracy_study": accuracy_study.main}
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mains[module](["--workdir", str(tmp_path)]
                      if module in ("demo_synthetic",)
                      else ["--out", str(tmp_path / "o")])
    assert os.listdir(tmp_path) == []


def test_study_main_passes_overrides_to_the_fits(tmp_path):
    """`main(argv, overrides=...)` hands each recipe's keywords to its fit
    (the route `tools/study_arm.py` takes to the plain epoch): on the CPU
    `auto` resolves to the plain epoch, so the constrained side is asked for
    the fused one, which runs K3's twin here. The run record keeps each
    fit's backend and its BatchNorm units under `bn_eps`."""
    out = tmp_path / "o"
    argv = ["--files-per-class", "4", "--epochs", "2",
            "--constrained-epochs", "2", "--device", CPU, "--out", str(out)]
    assert syn.main(argv, overrides={
        "constrained": {"epoch_backend": "fused"}}) == 0
    fits = json.loads((out / "run.json").read_text())["fits"]
    assert fits["unconstrained"]["epoch_backend"] == "plain"
    assert fits["constrained"]["epoch_backend"] == "fused"
    for fit in fits.values():
        assert fit["bn_units"] == [1024, 512, 256, 128, 64]
        assert all(0 <= k <= n for k, n in zip(fit["bn_units_under_eps"],
                                               fit["bn_units"]))


SCRIPT = os.path.join(REPO, "asr_using_robust_nn_tpu_torch", "examples",
                      "reproduce_thesis.sh")


def _script_commands():
    """Each `$CLI ...` command of the script as an argv list, with the loop
    variable of a `for atk in ...; do` line expanded."""
    text = open(SCRIPT).read().replace("\\\n", " ")
    cmds, loop = [], None
    for line in text.splitlines():
        line = line.strip()
        m = re.match(r"for (\w+) in (.*); do$", line)
        if m:
            loop = (m.group(1), m.group(2).split())
            continue
        if line == "done":
            loop = None
            continue
        if not line.startswith("$CLI "):
            continue
        argv = [a.strip('"') for a in line.split()[1:]]
        if loop is None:
            cmds.append(argv)
        else:
            name, values = loop
            cmds += [[a.replace(f"${name}", v) for a in argv]
                     for v in values]
    return cmds


def test_reproduce_thesis_script_parses():
    assert subprocess.run(["bash", "-n", SCRIPT]).returncode == 0
    text = open(SCRIPT).read()
    assert 'CLI="python -m asr_using_robust_nn_tpu_torch"' in text
    cmds = _script_commands()
    assert len(cmds) == 24

    parsed = []

    def parse_only(self, args=None, namespace=None):
        ns = real(self, args, namespace)
        parsed.append(ns)
        raise SystemExit(0)

    real = argparse.ArgumentParser.parse_args
    with contextlib.ExitStack() as stack:
        stack.enter_context(pytest.MonkeyPatch.context()).setattr(
            argparse.ArgumentParser, "parse_args", parse_only)
        for argv in cmds:
            with pytest.raises(SystemExit) as e:
                port_cli.main(argv)
            assert e.value.code == 0, argv
    assert [ns.cmd for ns in parsed] == [a[0] for a in cmds]
    attacks = [ns.type for ns in parsed if ns.cmd == "attack"]
    assert len(attacks) == 17 and "cw_linf" in attacks
