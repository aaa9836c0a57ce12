"""The port's simple_norm projection and K2's plain twin
(asr_using_robust_nn_tpu_torch/constraints, ops/spectral.py,
ops/cuda_spectral.py) against the JAX package: the same numpy kernels and
start vector through both.

K2 itself runs only on a card and is held against its twins by
`chip_smoke.py` and the card tests of `tests/test_torch_kernels.py`; on CPU
tensors its wrapper is the chain's twin, and the product form's twin and the
host side of the launch (the plan, the arguments handed to the C entry) are
what these tests reach.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_using_robust_nn_tpu.constraints import (
    make_simple_norm_constraint as jmake)
from asr_using_robust_nn_tpu.models import mlp as jmlp
from asr_using_robust_nn_tpu.ops.pallas_spectral import (
    product_spectral_norm_pallas)
from asr_using_robust_nn_tpu.ops.spectral import (
    product_spectral_norm_with_state as jpsn)
from asr_using_robust_nn_tpu_torch.constraints import (
    make_simple_norm_constraint)
from asr_using_robust_nn_tpu_torch.models.convert import (
    cstate_from_numpy, cstate_to_numpy, params_from_numpy, params_to_numpy)
from asr_using_robust_nn_tpu_torch.ops.cuda_spectral import (
    product_spectral_norm_cuda)
from asr_using_robust_nn_tpu_torch.ops.spectral import (
    product_spectral_norm_with_state)

from conftest import product_norm_oracle

EPS = float(np.spacing(1.0))


def _stack(rng):
    """The JAX suite's stack (tests/test_constraints.py::TestPallasPI)."""
    return [rng.standard_normal(s).astype(np.float32) * 0.5
            for s in [(20, 16), (16, 8), (8, 4)]]


def _u0(n=4):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(23), (n,),
                                        jnp.float32))


@pytest.mark.parametrize("n_iter", [1, 8, 64])
def test_bf16_twin_matches_pallas_and_xla(rng, n_iter):
    """bf16 matvecs: sigma rtol 5e-3 and u atol 5e-3 against both JAX
    forms (the JAX suite's Pallas-vs-XLA bar: bf16 accumulation order)."""
    ws = _stack(rng)
    u0 = _u0()
    sig, u = product_spectral_norm_with_state(
        [torch.from_numpy(w) for w in ws], torch.from_numpy(u0),
        n_iter=n_iter, eps=EPS, matvec_dtype=torch.bfloat16)
    sig_p, u_p = product_spectral_norm_pallas(
        [jnp.asarray(w) for w in ws], jnp.asarray(u0), n_iter=n_iter,
        matvec_bf16=True, interpret=True)
    sig_x, u_x = jpsn([jnp.asarray(w) for w in ws], jnp.asarray(u0),
                      n_iter=n_iter, eps=EPS, matvec_dtype=jnp.bfloat16)
    for s_ref, u_ref in ((sig_p, u_p), (sig_x, u_x)):
        np.testing.assert_allclose(float(sig), float(s_ref), rtol=5e-3)
        np.testing.assert_allclose(u.numpy(), np.asarray(u_ref), atol=5e-3)


def test_f32_twin_matches_oracle_and_xla(rng):
    ws = _stack(rng)
    sig, u = product_spectral_norm_with_state(
        [torch.from_numpy(w) for w in ws], torch.from_numpy(_u0()),
        n_iter=64, eps=EPS)
    np.testing.assert_allclose(float(sig), product_norm_oracle(ws), rtol=1e-4)
    np.testing.assert_allclose(float(torch.linalg.norm(u)), 1.0, rtol=1e-5)
    sig_x, u_x = jpsn([jnp.asarray(w) for w in ws], jnp.asarray(_u0()),
                      n_iter=64, eps=EPS)
    np.testing.assert_allclose(float(sig), float(sig_x), rtol=1e-5)
    np.testing.assert_allclose(u.numpy(), np.asarray(u_x), atol=1e-5)


@pytest.mark.parametrize("bf16", [True, False])
def test_cuda_wrapper_runs_twin_on_cpu(rng, bf16):
    ws = [torch.from_numpy(w) for w in _stack(rng)]
    u0 = torch.from_numpy(_u0())
    before = product_spectral_norm_cuda.launches
    got = product_spectral_norm_cuda(ws, u0, n_iter=8, matvec_bf16=bf16)
    want = product_spectral_norm_with_state(
        ws, u0, n_iter=8, eps=EPS,
        matvec_dtype=torch.bfloat16 if bf16 else None)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert product_spectral_norm_cuda.launches == before  # nothing launched
    if bf16:  # the oracle at many rounds, bf16 class
        s, _ = product_spectral_norm_cuda(ws, u0, n_iter=64)
        np.testing.assert_allclose(float(s), product_norm_oracle(
            [w.numpy() for w in ws]), rtol=2e-2)


def _small_params(seed):
    cfg = jmlp.MLPConfig(in_dim=20, n_classes=4, hidden=(32, 16),
                         nonneg=True, dropout=(0.0, 0.0))
    p, s = jax.tree_util.tree_map(
        np.asarray, jmlp.init_mlp(cfg, jax.random.PRNGKey(seed)))
    for layer in p["layers"]:
        layer["w"] = np.abs(layer["w"]) * 1.7  # product norm well above rho
    return p, s


@pytest.mark.parametrize("affected", [(), (0, 2)])
@pytest.mark.parametrize("n_iter", [4, 16])
def test_simple_norm_apply_matches_jax(affected, n_iter):
    """One projection at fp32 matvecs: params within 2e-4 (the port's
    constraint bar, ROADMAP.md) and the carried u alike."""
    jp, js = _small_params(seed=n_iter + len(affected))
    jc = jmake(0.5, affected_layers_indices=affected, n_iter=n_iter)
    jcs = jc.init(jp)
    jp2, jcs2 = jc.apply(jax.tree_util.tree_map(jnp.asarray, jp), jcs)
    c = make_simple_norm_constraint(0.5, affected_layers_indices=affected,
                                    n_iter=n_iter, pi_backend="plain")
    params, _ = params_from_numpy(jp, js, device="cpu")
    p2, cs2 = c.apply(params, cstate_from_numpy(
        jax.tree_util.tree_map(np.asarray, jcs), device="cpu"))
    got, _ = params_to_numpy(p2, {"layers": []})
    for a, b in zip(got["layers"], jp2["layers"]):
        np.testing.assert_allclose(a["w"], np.asarray(b["w"]), atol=2e-4,
                                   rtol=2e-4)
    np.testing.assert_allclose(cstate_to_numpy(cs2)["u"],
                               np.asarray(jcs2["u"]), atol=1e-5)
    assert c.apply._asrtpu_kind == "simple_norm"
    assert c.apply._asrtpu_meta == jc.apply._asrtpu_meta


def test_backends_agree_on_cpu_and_bad_backend_raises():
    jp, js = _small_params(seed=1)
    params, _ = params_from_numpy(jp, js, device="cpu")
    outs = []
    for backend in ("auto", "plain", "cuda"):
        c = make_simple_norm_constraint(0.5, n_iter=8, pi_backend=backend)
        p2, _ = c.apply(params, c.init(params))
        outs.append([layer["w"] for layer in p2["layers"]])
    for ws in outs[1:]:
        for a, b in zip(outs[0], ws):
            assert torch.equal(a, b)
    with pytest.raises(ValueError):
        make_simple_norm_constraint(0.5, pi_backend="xla")


# -- K2's cluster launch: the host-side partition plan and its ordered twin --

from asr_using_robust_nn_tpu_torch.ops.cuda_spectral import (  # noqa: E402
    CLUSTER_SIZE, SMEM_MAX, pi_plan, product_spectral_norm_gram,
    product_spectral_norm_partitioned)

PLAN_CHAINS = {
    "digit": (880, 1024, 512, 256, 128, 64, 10),
    "digit_padded": (896, 1024, 512, 256, 128, 128, 128),
    "speaker": (2000, 1024, 512, 256, 128, 64, 20),
    "width_10": (300, 10),
    "width_8192": (64, 8192, 32),
    "square_8192": (8192, 8192, 10),
    "odd": (33, 7, 129, 5),
}


@pytest.mark.parametrize("wbf16", [True, False], ids=["bf16", "fp32"])
@pytest.mark.parametrize("cluster", [8, 16])
@pytest.mark.parametrize("chain", PLAN_CHAINS)
def test_pi_plan_partitions_every_dimension(chain, cluster, wbf16):
    """Every index of every dimension is owned by exactly one block, slices
    are contiguous, in rank order and start on an even index; the resident
    slices are 16-byte aligned, disjoint, behind the vectors, and a block's
    shared memory stays within the 232 448 bytes an H100 gives it."""
    dims = PLAN_CHAINS[chain]
    plan = pi_plan(dims, cluster, wbf16)
    assert plan.dims == dims and plan.cluster == cluster
    assert plan.esize == (2 if wbf16 else 4)
    for i, d in enumerate(dims):
        owner = np.full(d, -1)
        for rank in range(cluster):
            lo, hi = plan.owned(i, rank)
            assert 0 <= lo <= hi <= d and (lo % 2 == 0 or lo == hi)
            assert (owner[lo:hi] == -1).all()
            owner[lo:hi] = rank
            assert (hi > lo) == (rank < plan.ranks(i))
        assert (owner >= 0).all() and (np.diff(owner) >= 0).all()
    assert plan.smem_bytes <= SMEM_MAX == 232448
    spans = []
    for j in range(len(dims) - 1):
        assert plan.resident[j] == (plan.res_off[j] >= 0)
        if plan.resident[j]:
            size = plan.per[j] * dims[j + 1] * plan.esize
            assert plan.res_off[j] % 16 == 0
            assert plan.res_off[j] >= plan.vec_bytes
            assert plan.res_off[j] + size <= plan.smem_bytes
            spans.append((plan.res_off[j], plan.res_off[j] + size))
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))


def test_pi_plan_residency_and_refusals():
    """On 16 blocks the whole bf16 digit stack is resident; on 8 its first
    layer (229 KB a block) is read from global memory; a layer is never
    made resident past the limit. What the plan refuses raises."""
    padded = PLAN_CHAINS["digit_padded"]
    assert all(pi_plan(padded, 16, True).resident)
    assert pi_plan(padded, 8, True).resident == (False,) + (True,) * 5
    assert pi_plan(PLAN_CHAINS["square_8192"], 16, True).resident == \
        (False, True)
    assert pi_plan(padded) == pi_plan(padded, CLUSTER_SIZE, True)
    with pytest.raises(ValueError, match="widths"):
        pi_plan((10, 8193), 16, True)
    with pytest.raises(ValueError, match="layers"):
        pi_plan((4,) * 18, 16, True)
    with pytest.raises(ValueError, match="cluster"):
        pi_plan((4, 4), 3, True)


@pytest.mark.parametrize("cluster", [8, 16])
@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "fp32"])
@pytest.mark.parametrize("n_iter", [0, 4, 16])
def test_partitioned_twin_matches_twin_pallas_and_xla(rng, n_iter, bf16,
                                                      cluster):
    """The partition-ordered twin against the plain twin and both JAX forms
    on the JAX suite's stack, at the twin's own bars: sigma rtol 5e-3 and u
    atol 5e-3 with bf16 matvecs (summation order), 1e-4 in fp32."""
    ws = _stack(rng)
    u0 = _u0()
    tws = [torch.from_numpy(w) for w in ws]
    sig, u = product_spectral_norm_partitioned(
        tws, torch.from_numpy(u0), n_iter, EPS, bf16, cluster)
    sig_t, u_t = product_spectral_norm_with_state(
        tws, torch.from_numpy(u0), n_iter=n_iter, eps=EPS,
        matvec_dtype=torch.bfloat16 if bf16 else None)
    jws = [jnp.asarray(w) for w in ws]
    sig_p, u_p = product_spectral_norm_pallas(
        jws, jnp.asarray(u0), n_iter=n_iter, matvec_bf16=bf16,
        interpret=True)
    sig_x, u_x = jpsn(jws, jnp.asarray(u0), n_iter=n_iter, eps=EPS,
                      matvec_dtype=jnp.bfloat16 if bf16 else None)
    bar = 5e-3 if bf16 else 1e-4
    for s_ref, u_ref in ((sig_t, u_t.numpy()), (sig_p, u_p), (sig_x, u_x)):
        np.testing.assert_allclose(float(sig), float(s_ref), rtol=bar)
        np.testing.assert_allclose(u.numpy(), np.asarray(u_ref), atol=bar)


def _real_stack(dims, signed=False):
    """NonNeg-like kernels (|N(0, 1)| * 0.05; N(0, 1) * 0.05 if `signed`) of
    widths `dims` and a start vector, seeded by the chain's length."""
    rng = np.random.default_rng(len(dims))
    ws = [torch.from_numpy((rng.standard_normal((a, b)) if signed else
                            np.abs(rng.standard_normal((a, b))))
                           .astype(np.float32) * 0.05)
          for a, b in zip(dims[:-1], dims[1:])]
    return ws, torch.from_numpy(rng.standard_normal(dims[-1])
                                .astype(np.float32))


@pytest.mark.parametrize("cluster", [8, 16])
@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "fp32"])
@pytest.mark.parametrize("chain", ["digit", "speaker", "width_8192", "odd"])
def test_partitioned_twin_at_real_widths(chain, bf16, cluster):
    """At widths where the partition is not trivial (many blocks own rows,
    trailing blocks own none), bf16 and fp32, against the plain twin."""
    ws, u0 = _real_stack(PLAN_CHAINS[chain])
    bar = 5e-3 if bf16 else 1e-4
    sig, u = product_spectral_norm_partitioned(ws, u0, 4, EPS, bf16, cluster)
    sig_t, u_t = product_spectral_norm_with_state(
        ws, u0, n_iter=4, eps=EPS,
        matvec_dtype=torch.bfloat16 if bf16 else None)
    np.testing.assert_allclose(float(sig), float(sig_t), rtol=bar)
    np.testing.assert_allclose(u.numpy(), u_t.numpy(), atol=bar)


# -- K2's product form: the choice of form, its twin, its fmaf, its launch -----

PADDED_TRUE = {"digit_padded": "digit"}  # K3's buffers and their true widths


@pytest.mark.parametrize("chain", PLAN_CHAINS)
def test_pi_plan_picks_the_form_from_the_widths(chain):
    """The product (Gram) form for every chain that ends at 32 or fewer
    classes and whose two fp32 copies of R fit a block, the chain form for
    the 8192-wide chains; K3's padded buffers take the product form at
    their true widths and the chain form at the padded ones. A plan of the
    product form keeps no layer resident and fits SMEM_MAX."""
    dims = PLAN_CHAINS[chain]
    want = chain not in ("width_8192", "square_8192", "digit_padded")
    for wbf16 in (True, False):
        plan = pi_plan(dims, CLUSTER_SIZE, wbf16)
        assert plan.gram == want
        if plan.gram:
            assert not any(plan.resident) and set(plan.res_off) == {-1}
            assert plan.rrows == max((plan.per[0],) + dims[1:-1])
            assert plan.smem_bytes <= SMEM_MAX
    if chain in PADDED_TRUE:
        assert pi_plan(PLAN_CHAINS[PADDED_TRUE[chain]]).gram


def test_pi_plan_form_does_not_depend_on_n_iter(monkeypatch, tmp_path):
    """pi_plan takes no n_iter, and pi_launch hands the C entry the same
    form at 4 rounds (the parity gate's K3) and 16 (the fits'): K3's padded
    buffers at the true widths, with their row strides, their sizes for the
    rescale and u's whole length. Each launch counts its form once while a
    profiler records."""
    import contextlib
    import inspect
    import types

    from asr_using_robust_nn_tpu_torch.models.mlp import MLPConfig
    from asr_using_robust_nn_tpu_torch.ops import cuda_spectral as cs
    from asr_using_robust_nn_tpu_torch.ops.cuda_train import FusedStepSpec
    from asr_using_robust_nn_tpu_torch.utils import profiling

    assert "n_iter" not in inspect.signature(pi_plan).parameters
    calls = []

    def run(ws, dims, ld, numel, m, wbf16, u_in, u_out, u_len, sigma, n_iter,
            eps, rho, inv_m, masters, cluster, gram, per, res_off, smem,
            stream):
        calls.append(dict(dims=tuple(dims[:m + 1]), ld=tuple(ld[:m]),
                          numel=tuple(numel[:m]), u_len=u_len, gram=gram,
                          n_iter=n_iter, smem=smem))
        return 0

    monkeypatch.setattr(cs, "_lib", lambda: types.SimpleNamespace(
        asr_pi_run=run))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))
    spec = FusedStepSpec(cfg=MLPConfig.speaker_constrained(), batch=64,
                         rho=1.0, pi_iters=16)
    pd = spec.pdims
    w16 = [torch.zeros((a, b), dtype=torch.bfloat16)
           for a, b in zip(pd[:-1], pd[1:])]
    u, sg = torch.zeros((1, pd[-1])), torch.zeros(1)
    with profiling.trace(str(tmp_path)):
        for n_iter in (4, 16):
            cs.pi_launch(w16, u, u, sg, n_iter, dims=spec.dims)
        cs.pi_launch(w16, u, u, sg, 4)  # the padded widths: the chain form
        counters = profiling.recorded()["counters"][None]
    assert [c["n_iter"] for c in calls] == [4, 16, 4]
    assert [c["gram"] for c in calls] == [1, 1, 0]
    assert calls[0]["dims"] == spec.dims and calls[2]["dims"] == pd
    for c in calls:
        assert c["ld"] == pd[1:]
        assert c["numel"] == tuple(a * b for a, b in zip(pd[:-1], pd[1:]))
        assert c["u_len"] == pd[-1]
    assert calls[0]["smem"] == pi_plan(spec.dims).smem_bytes
    assert counters == {"k2.gram": 2, "k2.chain": 1}


GRAM_CHAINS = ["digit", "speaker", "width_10", "width_8192", "odd",
               "odd_signed"]


def _oracle(ws, u0, n_iter, bf16):
    """The iteration as written (the chain), in float64 on the kernels as
    the kernel reads them (bf16-rounded in bf16 mode)."""
    w64 = [(w.to(torch.bfloat16) if bf16 else w).double().numpy()
           for w in ws]

    def nrm(v):
        return v / (np.sqrt(v @ v) + EPS)

    def pt(x):
        for w in reversed(w64):
            x = w @ x
        return x

    def p(x):
        for w in w64:
            x = w.T @ x
        return x

    u = nrm(u0.double().numpy())
    for _ in range(n_iter):
        u = nrm(p(nrm(pt(u))))
    q = np.eye(len(u))
    for w in reversed(w64):
        q = w @ q
    g = q.T @ q  # the Gram; how many times u^T G u its terms' sizes add to
    spread = float(np.abs(u) @ np.abs(g) @ np.abs(u)) / float(u @ g @ u)
    return float(u @ p(nrm(pt(u)))), u, spread


@pytest.mark.parametrize("n_iter", [0, 4, 16])
@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "fp32"])
@pytest.mark.parametrize("chain", GRAM_CHAINS)
def test_gram_twin_against_the_chain_and_the_oracle(chain, bf16, n_iter):
    """The product form's twin (the kernel's partition, split order and
    rank-order sums, fmaf rounded once) against the float64 iteration: 1e-6
    in sigma and u at the digit and speaker widths and every other chain of
    PLAN_CHAINS that runs in seconds here (square_8192's first link is 8192
    x 8192 x 10 emulated fmaf). From a cold start (n_iter 0) u^T G u is a
    sum whose terms add to `spread` times its value (~300 at the speaker
    stack), and fp32's G carries that into sigma: the bar is 1e-6 x spread,
    and after a round u leans on the top singular vector and spread is near
    1 (1.00-1.03 here). Against the chain's twin, which rounds the vector to
    bf16 before every link, at the chain's own bars; on signed kernels
    (`odd_signed`) that rounding moves the chain's u further, so there sigma
    alone."""
    signed = chain.endswith("_signed")
    ws, u0 = _real_stack(PLAN_CHAINS[chain.removesuffix("_signed")], signed)
    sig, u = product_spectral_norm_gram(ws, u0, n_iter, EPS, bf16)
    s_o, u_o, spread = _oracle(ws, u0, n_iter, bf16)
    assert abs(float(sig) / s_o - 1.0) <= 1e-6 * spread
    np.testing.assert_allclose(u.double().numpy(), u_o, atol=1e-6)
    sig_t, u_t = product_spectral_norm_with_state(
        ws, u0, n_iter=n_iter, eps=EPS,
        matvec_dtype=torch.bfloat16 if bf16 else None)
    bar = 5e-3 if bf16 else 1e-4
    np.testing.assert_allclose(float(sig), float(sig_t), rtol=bar)
    if not signed:
        np.testing.assert_allclose(u.numpy(), u_t.numpy(), atol=bar)


def _round_once(x):
    """The float32 nearest the rational x, ties to even."""
    from fractions import Fraction

    f = np.float32(float(x))
    cands = [np.nextafter(f, np.float32(-np.inf)), f,
             np.nextafter(f, np.float32(np.inf))]
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - x),
                                     int(c.view(np.uint32)) & 1))


@pytest.mark.parametrize("kind", ["random", "near_ties"])
def test_gram_twin_fmaf_rounds_once(kind):
    """The twin's fmaf against exact rational arithmetic: random triples,
    and triples whose float64 sum lands exactly halfway between two floats
    while the exact sum does not (1 + m 2^-23 + 2^-24 a' b' with a' b' within
    2^-29 of 1), where rounding the float64 sum would be off by one ulp."""
    from fractions import Fraction

    from asr_using_robust_nn_tpu_torch.ops.cuda_spectral import _fma

    rng = np.random.default_rng(3)
    if kind == "random":
        a = rng.standard_normal(3000).astype(np.float32)
        b = rng.standard_normal(3000).astype(np.float32)
        c = rng.standard_normal(3000).astype(np.float32)
    else:
        a1 = (1 + rng.integers(1, 2 ** 23, 200000) / 2 ** 23).astype(
            np.float32)
        b1 = (1 / a1.astype(np.float64)).astype(np.float32)
        near = np.abs(a1.astype(np.float64) * b1 - 1) < 2.0 ** -29
        a = (a1[near] * np.float32(2.0 ** -24)).astype(np.float32)
        b = b1[near]
        c = (1 + rng.integers(0, 2 ** 23, a.shape[0]) / 2 ** 23).astype(
            np.float32)
        s64 = a.astype(np.float64) * b + c
        ties = s64 == c.astype(np.float64) + 2.0 ** -24
        assert ties.sum() > 50  # the float64 sum lands on a tie
    got = _fma(torch.from_numpy(a), torch.from_numpy(b),
               torch.from_numpy(c)).numpy()
    want = np.array([_round_once(Fraction(float(x)) * Fraction(float(y))
                                 + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got, want)
    if kind == "near_ties":
        naive = (a.astype(np.float64) * b + c).astype(np.float32)
        assert (naive != want).any()  # the case the tie rule is for


# -- the other three algorithms: norm, custom, fista ----------------------------

from asr_using_robust_nn_tpu.constraints import (  # noqa: E402
    make_custom_constraint as jcustom, make_fista_constraint as jfista,
    make_norm_constraint as jnorm)
from asr_using_robust_nn_tpu.constraints.engine import (  # noqa: E402
    _fista_project as j_fista_project)
from asr_using_robust_nn_tpu.ops.spectral import (  # noqa: E402
    spectral_norm_with_state as jsn)
from asr_using_robust_nn_tpu_torch.constraints import (  # noqa: E402
    engine as port_engine, make_custom_constraint, make_fista_constraint,
    make_norm_constraint)
from asr_using_robust_nn_tpu_torch.ops.spectral import (  # noqa: E402
    spectral_norm_with_state)


def _port_params(jp, js):
    return params_from_numpy(jp, js, device="cpu")[0]


def _assert_kernels_close(p_port, p_jax, tol=2e-4):
    got, _ = params_to_numpy(p_port, {"layers": []})
    for a, b in zip(got["layers"], p_jax["layers"]):
        for k in a:
            np.testing.assert_allclose(a[k], np.asarray(b[k]), atol=tol,
                                       rtol=tol)


@pytest.mark.parametrize("n_iter", [1, 8])
def test_spectral_norm_with_state_matches_jax(rng, n_iter):
    w = rng.standard_normal((24, 12)).astype(np.float32)
    u0 = rng.standard_normal(24).astype(np.float32)
    sig, u = spectral_norm_with_state(torch.from_numpy(w),
                                      torch.from_numpy(u0), n_iter)
    jsig, ju = jsn(jnp.asarray(w), jnp.asarray(u0), n_iter)
    np.testing.assert_allclose(float(sig), float(jsig), rtol=1e-5)
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), atol=1e-5)


@pytest.mark.parametrize("n_iter", [2, 8])
def test_norm_apply_matches_jax(n_iter):
    """Per-layer norm projection with the JAX start vectors carried across
    (threefry draws cannot match): kernels within 2e-4, u alike."""
    jp, js = _small_params(seed=3 + n_iter)
    jp["layers"][1]["w"][0, :3] = -0.5  # negatives the clamp removes
    jc = jnorm(0.5, n_iter=n_iter)
    jcs = jc.init(jp)
    jp2, jcs2 = jc.apply(jax.tree_util.tree_map(jnp.asarray, jp), jcs)
    c = make_norm_constraint(0.5, n_iter=n_iter)
    port_cs = c.init(_port_params(jp, js))
    assert [tuple(u.shape) for u in port_cs["u"]] == [
        tuple(np.shape(u)) for u in jcs["u"]]
    p2, cs2 = c.apply(_port_params(jp, js),
                      {"u": [torch.tensor(np.asarray(u))
                             for u in jcs["u"]]})
    _assert_kernels_close(p2, jp2)
    for a, b in zip(cs2["u"], jcs2["u"]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    assert all(float(torch.min(w)) >= 0 for w in
               (layer["w"] for layer in p2["layers"]))


def test_custom_apply_matches_jax():
    """Frobenius scaling, the reference's quirk (PARITY #4)."""
    jp, js = _small_params(seed=2)
    jp["layers"][0]["w"][:2] *= -1.0
    jc = jcustom(0.5)
    jp2, jcs2 = jc.apply(jax.tree_util.tree_map(jnp.asarray, jp),
                         jc.init(jp))
    c = make_custom_constraint(0.5)
    p2, cs2 = c.apply(_port_params(jp, js), c.init(None))
    _assert_kernels_close(p2, jp2)
    assert cs2 == () == jcs2
    for layer in p2["layers"]:
        np.testing.assert_allclose(float(torch.linalg.norm(layer["w"])), 0.5,
                                   rtol=1e-5)


def _count_svds(monkeypatch):
    calls = []
    svd = torch.linalg.svd

    def counted(*a, **kw):
        calls.append(1)
        return svd(*a, **kw)

    monkeypatch.setattr(port_engine.torch.linalg, "svd", counted)
    return calls


@pytest.mark.parametrize("case", ["nit2", "nit3_scaled", "early_exit"])
def test_fista_apply_matches_jax(case, monkeypatch):
    """FISTA per layer on the live weights, the JAX while_loop's exit rule:
    kernels within 2e-4. `early_exit`: weights that already meet rho leave
    every layer's loop after its first iteration of a possible 40, in both
    packages (the port's SVD count shows it)."""
    jp, js = _small_params(seed=5)
    nit = {"nit2": 2, "nit3_scaled": 3, "early_exit": 40}[case]
    rho = 0.5
    if case == "nit3_scaled":
        for layer in jp["layers"]:
            layer["w"] = layer["w"] * 3.0
    if case == "early_exit":
        for layer in jp["layers"]:
            layer["w"] = layer["w"] * 0.05  # product norm far below rho
    jc = jfista(rho, nit=nit)
    jp2, _ = jc.apply(jax.tree_util.tree_map(jnp.asarray, jp), jc.init(jp))
    calls = _count_svds(monkeypatch)
    c = make_fista_constraint(rho, nit=nit)
    p2, cs2 = c.apply(_port_params(jp, js), c.init(None))
    _assert_kernels_close(p2, jp2)
    assert cs2 == ()
    n_layers = len(jp["layers"])
    if case == "early_exit":
        assert len(calls) == n_layers  # one iteration a layer
        _assert_kernels_close(p2, jp)  # nonneg weights inside the ball
    else:
        assert len(calls) == nit * n_layers


def test_fista_project_single_layer_matches_jax(rng):
    """`_fista_project` alone on a wide matrix with A and B chains."""
    w = np.abs(rng.standard_normal((16, 24))).astype(np.float32) * 0.5
    a = np.abs(rng.standard_normal((4, 16))).astype(np.float32)
    b = np.abs(rng.standard_normal((24, 20))).astype(np.float32)
    got = port_engine._fista_project(torch.from_numpy(w), torch.from_numpy(a),
                                     torch.from_numpy(b), 1.0, 3, 2.1)
    want = j_fista_project(jnp.asarray(w), jnp.asarray(a), jnp.asarray(b),
                           1.0, 3, 2.1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=2e-4)
