"""The port's white-box attacks (asr_using_robust_nn_tpu_torch/attacks/
whitebox.py) against the JAX package's, on a small JAX-trained blobs model
carried across with `params_from_numpy` and on one 1100-wide model for the
tiled JSMA pair search. Each test states its bar.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from asr_using_robust_nn_tpu.attacks import whitebox as jwb
from asr_using_robust_nn_tpu.attacks.sweeps import \
    whitebox_sweep as jwhitebox_sweep
from asr_using_robust_nn_tpu.models import mlp as jmlp
from asr_using_robust_nn_tpu.train import TrainConfig, Trainer
from asr_using_robust_nn_tpu_torch.attacks import whitebox as wb
from asr_using_robust_nn_tpu_torch.attacks.sweeps import whitebox_sweep
from asr_using_robust_nn_tpu_torch.models import mlp
from asr_using_robust_nn_tpu_torch.models.convert import params_from_numpy

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Several test workers share a few cores; one torch thread each keeps
    this file near its solo time."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(jcfg, jp, js):
    """(JAX logits fn, port logits fn) of one model's params."""
    cfg = mlp.MLPConfig(**{f: getattr(jcfg, f) for f in (
        "in_dim", "n_classes", "hidden", "dropout")})
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    p, s = params_from_numpy(to_np(jp), to_np(js), CPU)

    def jlogits(xx):
        return jmlp.apply_mlp(jcfg, jp, js, xx, train=False)[0]

    def logits(xx):
        return mlp.apply_mlp(cfg, p, s, xx, train=False)[0]

    return jlogits, logits


@pytest.fixture(scope="module")
def trained():
    """The blobs model of tests/test_attacks.py, trained in JAX."""
    from conftest import blobs_task

    rng = np.random.default_rng(3)
    x, y = blobs_task(rng, n=600, d=24, k=4, noise=0.7)
    jcfg = jmlp.MLPConfig(in_dim=24, n_classes=4, hidden=(32, 16),
                          dropout=(0.0, 0.0))
    res = Trainer(jcfg, TrainConfig(batch_size=64, epochs=60, patience=60,
                                    seed=0)).fit(x[:500], y[:500], x[500:],
                                                 y[500:])
    jlogits, logits = _pair(jcfg, res["best_params"], res["best_state"])
    return jlogits, logits, x[500:], y[500:]


@pytest.fixture(scope="module")
def wide():
    """An untrained 1100-wide model: n > 1024 puts JSMA on the tiled
    search."""
    jcfg = jmlp.MLPConfig(in_dim=1100, n_classes=5, hidden=(16,),
                          dropout=(0.0,))
    jp, js = jmlp.init_mlp(jcfg, jax.random.PRNGKey(1))
    jlogits, logits = _pair(jcfg, jp, js)
    x = np.random.default_rng(4).standard_normal((6, 1100)).astype(
        np.float32)
    return jlogits, logits, x


def _both(jattack, attack, x, y=None, **kw):
    jx = jnp.asarray(x)
    args = () if y is None else (jnp.asarray(y),)
    want = np.asarray(jattack(jx, *args, **kw))
    args = () if y is None else (torch.from_numpy(np.asarray(y)),)
    got = attack(torch.from_numpy(np.asarray(x)), *args, **kw).numpy()
    return got, want


def _agreement(got, want, x, jlogits, y, norm):
    """Success masks (misclassified against y), the mean perturbation norm of
    the samples that succeed on both sides, and adversarial accuracy."""
    def stats(adv):
        pred = np.argmax(np.asarray(jlogits(jnp.asarray(adv))), -1)
        return pred != y, norm(adv - x)
    s_got, n_got = stats(got)
    s_want, n_want = stats(want)
    both = s_got & s_want
    a, b = (float(n[both].mean()) if both.any() else 0.0
            for n in (n_got, n_want))
    return {"mask_agree": float(np.mean(s_got == s_want)),
            "norm_rel": abs(a - b) / max(b, 1e-12),
            "acc_diff": abs(float(np.mean(~s_got) - np.mean(~s_want))),
            "success": float(s_want.mean())}


def _hold(a, n):
    """Success masks equal on >= 95 % of samples, mean perturbation norm of
    the samples that succeed on both sides within 2 %, adversarial accuracy
    within 2/n. The readings print with `pytest -s`."""
    print(f"agreement with JAX over {n} samples: {a}")
    assert a["mask_agree"] >= 0.95, a
    assert a["norm_rel"] <= 0.02, a
    assert a["acc_diff"] <= 2.0 / n, a


def _l2(d):
    return np.sqrt(np.sum(d.astype(np.float64) ** 2, -1))


def _linf(d):
    return np.max(np.abs(d), -1)


def _l0(d):
    return np.sum(np.abs(d) > 1e-6, -1).astype(np.float64)


def test_pgd_matches_jax(trained):
    """>= 99 % of coordinates within 1e-4 of JAX's, the ball L-inf <= eps +
    1e-6 (a coordinate whose gradient is within rounding of zero may take
    the other sign on one side)."""
    jlogits, logits, x, y = trained
    for eps in (0.3, 2.0):
        got, want = _both(lambda xx, yy: jwb.pgd(jlogits, xx, yy, eps),
                          lambda xx, yy: wb.pgd(logits, xx, yy, eps), x, y)
        close = np.mean(np.abs(got - want) <= 1e-4)
        print(f"pgd eps {eps}: {close} of coordinates within 1e-4 of JAX")
        assert close >= 0.99
        assert np.abs(got - x).max() <= eps + 1e-6
    got, want = _both(
        lambda xx, yy: jwb.pgd(jlogits, xx, yy, 1.0, eps_step=0.05,
                               max_iter=7),
        lambda xx, yy: wb.pgd(logits, xx, yy, 1.0, eps_step=0.05,
                              max_iter=7), x, y)
    assert np.mean(np.abs(got - want) <= 1e-4) >= 0.99


_jselect = jax.jit(jwb._jsma_select_pair, static_argnums=3)
_jselect_tiled = jax.jit(jwb._jsma_select_pair_tiled)


class TestPairSelection:
    """Index-equal to JAX on identical alpha, beta and search inputs."""

    @staticmethod
    def _cmp(alpha, beta, search, k=None):
        ja, jb, js = (jnp.asarray(alpha), jnp.asarray(beta),
                      jnp.asarray(search))
        ta, tb, ts = (torch.from_numpy(alpha), torch.from_numpy(beta),
                      torch.from_numpy(search))
        want = [int(v) for v in _jselect(ja, jb, js, k)]
        got = [int(v) for v in wb._jsma_select_pair(ta, tb, ts, k)]
        assert got == want, (got, want)
        if k is None:
            want_t = [int(v) for v in _jselect_tiled(ja, jb, js)]
            got_t = [int(v) for v in wb._jsma_select_pair_tiled(ta, tb, ts)]
            assert got_t == want_t == want, (got_t, want_t)
        return want

    @pytest.mark.parametrize("n", [300, 333, 1030, 2020])
    def test_random_landscapes(self, rng, n):
        for _ in range(2):
            alpha = (rng.standard_normal(n) * 3).astype(np.float32)
            beta = rng.standard_normal(n).astype(np.float32)
            search = rng.random(n) > 0.3
            self._cmp(alpha, beta, search)
            self._cmp(alpha, beta, search, k=8)

    def test_forced_ties_small_integers(self, rng):
        """Small-integer scores tie often: the first maximum in row-major
        order on both sides, and in the tiled form across tiles."""
        for n in (40, 300):
            for _ in range(4):
                alpha = rng.integers(-2, 3, n).astype(np.float32)
                beta = rng.integers(-2, 3, n).astype(np.float32)
                search = rng.random(n) > 0.2
                self._cmp(alpha, beta, search)
                self._cmp(alpha, beta, search, k=5)
        alpha = np.full(300, -1.0, np.float32)
        beta = np.full(300, 1.0, np.float32)
        alpha[[5, 6, 200, 201]] = 1.0
        beta[[5, 6, 200, 201]] = -1.0
        p, q, ok = self._cmp(alpha, beta, np.ones(300, bool))
        assert ok and (p, q) == (5, 6)
        assert not self._cmp(alpha, beta, np.zeros(300, bool))[2]

    def test_batched_equals_per_sample(self, rng):
        a = rng.standard_normal((5, 1100)).astype(np.float32)
        b = rng.standard_normal((5, 1100)).astype(np.float32)
        s = rng.random((5, 1100)) > 0.5
        ta, tb, ts = (torch.from_numpy(v) for v in (a, b, s))
        for fn in (lambda *v: wb._jsma_select_pair(*v, None),
                   wb._jsma_select_pair_tiled):
            batch = [t.tolist() for t in fn(ta, tb, ts)]
            rows = [[int(v) for v in fn(ta[i], tb[i], ts[i])]
                    for i in range(5)]
            assert [list(r) for r in zip(*batch)] == rows


class TestARTLineSearch:
    """The four cases of tests/test_attacks.py::TestARTLineSearch, equal to
    JAX at 1e-6."""

    @pytest.mark.parametrize("w0,lr0,d", [
        ([[1.0]], [4.0], [[-1.0]]),      # halving picks the first improving
        ([[8.0]], [1.0], [[-1.0]]),      # doubling chains while improving
        ([[1.0]], [1.0], [[1.0]]),       # total failure: stay, collapse lr
        ([[1.0], [1.0]], [1.0, 1.0], [[-1.0], [1.0]]),  # per sample
    ])
    def test_case(self, w0, lr0, d):
        target = np.zeros_like(np.asarray(w0, np.float32))
        w, lr, dd = (np.asarray(v, np.float32) for v in (w0, lr0, d))

        def jobj(ww):
            return jnp.sum((ww - target) ** 2, axis=-1)

        def obj(ww):
            return torch.sum((ww - torch.from_numpy(target)) ** 2, dim=-1)

        jw, jlr = jwb._art_line_search_step(
            jobj, jnp.asarray(w), jnp.asarray(lr), jobj(jnp.asarray(w)),
            jnp.asarray(dd), max_halving=5, max_doubling=5)
        tw = torch.from_numpy(w)
        gw, glr = wb._art_line_search_step(
            obj, tw, torch.from_numpy(lr), obj(tw), torch.from_numpy(dd),
            max_halving=5, max_doubling=5)
        np.testing.assert_allclose(gw.numpy(), np.asarray(jw), atol=1e-6)
        np.testing.assert_allclose(glr.numpy(), np.asarray(jlr), atol=1e-6)


def test_adam_equals_optax(rng):
    """The port's Adam against optax.adam over 10 steps of a fixed gradient
    sequence: 1e-7."""
    w = rng.standard_normal((4, 7)).astype(np.float32)
    gs = [rng.standard_normal((4, 7)).astype(np.float32) for _ in range(10)]
    opt = optax.adam(0.01)
    jw, st = jnp.asarray(w), opt.init(jnp.asarray(w))
    tw = torch.from_numpy(w)
    adam = wb._Adam(0.01, tw)
    for g in gs:
        u, st = opt.update(jnp.asarray(g), st)
        jw = optax.apply_updates(jw, u)
        tw = adam.step(tw, torch.from_numpy(g))
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-7,
                                   rtol=0)


@pytest.mark.parametrize("theta,gamma", [(10.0, 0.1), (1.0, 0.5)])
def test_jsma_fixed_targets(trained, theta, gamma):
    """Bars of `_hold`, perturbation norm L0 (features moved)."""
    jlogits, logits, x, y = trained
    t = (y + 1) % 4
    kw = dict(targets=t, theta=theta, gamma=gamma)
    got, want = _both(lambda xx: jwb.jsma(jlogits, xx, **kw),
                      lambda xx: wb.jsma(logits, xx, **kw), x)
    a = _agreement(got, want, x, jlogits, y, _l0)
    _hold(a, len(x))
    # what a targeted hit means: both reach the target on the same rows
    hit = lambda adv: np.argmax(np.asarray(  # noqa: E731
        jlogits(jnp.asarray(adv))), -1) == t
    assert np.mean(hit(got) == hit(want)) >= 0.95


def test_jsma_tiled_wide_model(wide):
    """The 1100-wide model (tiled search) with fixed targets and a clip:
    the same rows moved by the same features on both sides on >= 95 % of
    samples, and the moved features' count within 2 %."""
    jlogits, logits, x = wide
    t = np.arange(len(x)) % 5
    kw = dict(targets=t, theta=0.5, gamma=0.004, clip=(-3.0, 3.0))
    got, want = _both(lambda xx: jwb.jsma(jlogits, xx, **kw),
                      lambda xx: wb.jsma(logits, xx, **kw), x)
    assert np.mean(np.all(np.abs(got - want) <= 1e-5, -1)) >= 0.95
    assert abs(_l0(got - x).sum() / _l0(want - x).sum() - 1) <= 0.02
    assert got.max() <= 3.0 and np.any(got != x)


@pytest.mark.parametrize("optimizer", ["art", "adam"])
def test_carlini_l2(trained, optimizer):
    """Bars of `_hold`, perturbation norm L2; 64 rows."""
    jlogits, logits, x, y = trained
    x, y = x[:64], y[:64]
    kw = dict(optimizer=optimizer, binary_search_steps=6, max_iter=10,
              learning_rate=0.01 if optimizer == "art" else 0.1)
    got, want = _both(lambda xx, yy: jwb.carlini_l2(jlogits, xx, yy, **kw),
                      lambda xx, yy: wb.carlini_l2(logits, xx, yy, **kw),
                      x, y)
    a = _agreement(got, want, x, jlogits, y, _l2)
    assert a["success"] > 0.5, a
    _hold(a, len(x))


def test_carlini_linf(trained):
    """Bars of `_hold`, perturbation norm L-inf; 64 rows, Adam re-initialized
    at every tau step on both sides."""
    jlogits, logits, x, y = trained
    x, y = x[:64], y[:64]
    kw = dict(max_iter=30, tau_steps=4, learning_rate=0.05)
    got, want = _both(lambda xx, yy: jwb.carlini_linf(jlogits, xx, yy, **kw),
                      lambda xx, yy: wb.carlini_linf(logits, xx, yy, **kw),
                      x, y)
    a = _agreement(got, want, x, jlogits, y, _linf)
    assert a["success"] > 0.3, a
    _hold(a, len(x))


@pytest.mark.parametrize("attack,grid", [("fgsm", [0.1, 0.5, 1.5]),
                                         ("pgd", [0.5, 1.0, 2.0])])
def test_whitebox_sweep_curves(trained, attack, grid):
    """fgsm and pgd curves within 1/n of JAX's whitebox_sweep, with the
    same model on both sides of the pair."""
    jlogits, logits, x, y = trained

    def jpredict(xx):
        return np.asarray(jax.nn.softmax(jlogits(jnp.asarray(xx)), -1))

    @torch.no_grad()
    def predict(xx):
        return torch.softmax(logits(torch.from_numpy(np.asarray(
            xx, np.float32))), -1).numpy()

    want = jwhitebox_sweep(attack, jlogits, jlogits, jpredict, jpredict, x,
                           y, strengths=grid)
    got = whitebox_sweep(attack, logits, logits, predict, predict, x, y,
                         strengths=grid, device="cpu")
    n = len(x)
    for k in ("accuracy_constrained", "accuracy_unconstrained"):
        assert np.abs(getattr(got, k) - getattr(want, k)).max() <= 1 / n
    assert got.accuracy_constrained[-1] < got.accuracy_constrained[0]
