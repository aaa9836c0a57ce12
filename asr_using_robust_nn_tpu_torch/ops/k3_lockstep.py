"""K3 held to its twin one operation at a time: the sharp part of the fused
epoch's parity gate (`ops/cuda_train.py::epoch_parity_vs_plain`).

  K3TwinLockstep(spec, candidate=None, held=None)
      a set of operations for `_epoch` that runs each operation of `_step`
      on the candidate (default: K3's kernels), then on the twin
      (`_PlainOps`) from the same buffers, reads what the operation computed
      on both sides, and puts the candidate's buffers back: every operation
      starts from the candidate's own state, so summation order cannot build
      up across operations or steps, and each reading is the departure of
      one operation in bf16 ulps of its operands' scale.
  k3_twin_lockstep(dev, spec, fs, xs, ys, ws, seeds, candidate, held)
      one epoch of that -> (readings, the first departure of a computed
      quantity or None).
  lockstep_on(dev, cfg, batch, data, labels, n_true, seeds)
      the same over the epoch of the parity gate with `seeds`.
  reordered_ops(spec)
      the twin with its fp32 sums in another order: the spread that
      summation order alone gives, which scales the gate's BN bar.

A candidate is any set of the step's operations: K3's (`_CudaOps`, on a
card), the twin's, or one with a planted fault (`tools/gate_faults.py`). On
a card the forward and dX GEMMs are also read alone, through K3's
plain-epilogue GEMM kernel on the same operands.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch

from ..models.mlp import init_mlp
from ..train.epoch_scan import shuffle_batches
from ..train.trainer import _generator
from . import cuda_train as ct
from .cuda_fista import fista_preload
from .cuda_spectral import preload

__all__ = ["K3TwinLockstep", "LOCKSTEP_PARAMS", "k3_twin_lockstep",
           "lockstep_on", "reordered_ops"]

# the quantities of the lockstep that Adam and the projection move: the
# parameters, their moments and copies, and the power-iteration vector, read
# but not held (a near-zero gradient whose fp32 sign differs between two sum
# orders moves a parameter by a whole Adam step). Everything else the step
# computes is held to one bf16 ulp of its operands' scale, the projection's
# factors and NonNeg's negative part included.
LOCKSTEP_PARAMS = ("Adam m", "Adam v", "master after NonNeg", "w16", "gamma",
                   "beta", "b", "sigma", "u", "FISTA v")


def _bf16_reading(k3, twin, scale=None):
    """How far K3's value of one quantity is from the twin's: the largest
    gap, the scale of the operands (given for a sum: its largest term;
    else the twin's largest magnitude), one bf16 ulp at that scale
    (2^(floor(log2 scale) - 7)), the gap in those ulps, how many entries
    part by more than one, and the mean signed gap in ulps."""
    k3, twin = k3.double().flatten(), twin.double().flatten()
    diff = k3 - twin
    if scale is None:
        scale = float(twin.abs().max()) if twin.numel() else 0.0
    ulp = (2.0 ** (math.floor(math.log2(scale)) - 7) if scale > 0
           else 2.0 ** -133)
    gap = float(diff.abs().max()) if diff.numel() else 0.0
    if not bool(torch.isfinite(k3).all() and torch.isfinite(twin).all()):
        gap = float("inf")
    return {"max_abs": gap, "scale": scale, "ulp": ulp, "ulps": gap / ulp,
            "n_over": int((diff.abs() > ulp).sum()), "n": int(diff.numel()),
            "bias_ulps": float(diff.mean()) / ulp if diff.numel() else 0.0}


def _held(op):
    """Run the wrapped operation in lockstep on a held step; on any other
    step run it on the candidate alone."""

    @functools.wraps(op)
    def run(self, *args):
        if self.holds(self.step):
            return op(self, *args)
        return getattr(self.k3, op.__name__)(*args)

    return run


class K3TwinLockstep:
    """K3 (or a `candidate` set of operations) and the twin in lockstep
    through one epoch: each operation of `ops/cuda_train.py::_step` runs on
    the candidate, then on the twin from the same buffers as they were
    before it, and the quantities that operation computes are read from
    both; then the candidate's buffers are put back, so that every operation
    of every step starts from the candidate's own state and the reading is
    the departure of that operation alone, in bf16 ulps of the scale of its
    operands (a sum's: its largest term; an elementwise result's: its
    largest value). Steps outside `held` (default: all) run on the
    candidate alone. Quantities in the order a step computes them: x (bf16)
    and the row-weight sum; per hidden layer z and a (the candidate's GEMM
    alone on the same operands; on a card K3's plain-epilogue GEMM kernel:
    the main loop of its fused forward), mu, sigma^2 (from the running
    variance's update), 1/sd, x^ as stored (bf16), the output (bf16) and the
    running statistics; the logits; the CE gradient dz (bf16), the output
    bias's db (the operation run again with that first moment zeroed: m' =
    (1 - b1) g) and the loss; per layer from the top, dD (the candidate's dX
    GEMM alone), dx^ = dD gamma, dz (bf16), dgamma, dbeta and db (as the
    output bias's) and the updated gamma, beta, b; per layer dW (the dW +
    Adam operation on zero moments, whose m' is (1 - b1) dW), Adam's m and
    v, the fp32 master after NonNeg, its negative part (a NonNeg model) and
    its bf16 copy; the projection's factor f per layer, sigma = rho / f^m
    and the power-iteration vector u; under FISTA (K7) each projected
    master, the FISTA iterations the step ran (exact: the exit tests agree)
    and K7's power vectors."""

    def __init__(self, spec, candidate=None, held=None):
        self.spec = spec
        self.k3 = ct._CudaOps(spec) if candidate is None else candidate
        self.twin = ct._PlainOps(spec)
        self.cuda = isinstance(self.k3, ct._CudaOps)
        if self.cuda:
            ct.preload_kernels(self.k3.lib)
            preload()
            if spec.fista:
                fista_preload(spec.dims)
            plain = dict(cluster=(1, 1, 1), cluster_axis=None,
                         bn_in_epilogue=False)
            plan = self.k3.plan
            self.fwd_dims = [dataclasses.replace(L, kernel="gemm_fwd",
                                                 **plain)
                             for L in plan["fwd"]]
            self.dx_dims = [None] + [dataclasses.replace(
                L, kernel="gemm_dx", **plain) for L in plan["dx"][1:]]
        a = ct._adam_consts(spec)
        self.b1, self.omb1 = a["b1"], a["omb1"]
        self.mom = spec.cfg.bn_momentum
        self.held = held
        self.rows, self.step = [], -1

    def holds(self, step):
        return self.held is None or step in self.held

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def bind(self, fs, sc, losses, accs):
        w = {}
        for k in ("masters", "w16", "mw", "vw"):
            w.update({f"{k}[{i}]": t for i, t in enumerate(fs[k])})
        w.update({f"small.{k}": t for k, t in fs["small"].items()})
        w.update(u=fs["u"], count=fs["count"], scales=fs["scales"],
                 losses=losses, accs=accs)
        w.update({k: fs[k] for k in ct._FISTA_KEYS if k in fs})
        for k, v in sc.items():
            if isinstance(v, list):
                w.update({f"{k}[{i}]": t for i, t in enumerate(v)})
            else:
                w[k] = v
        self.world, self.fs = w, fs

    def _note(self, op, q, k3, twin, scale=None):
        self.rows.append(dict(step=self.step, op=op, q=q,
                              **_bf16_reading(k3, twin, scale)))

    def _both(self, op, name, args, read):
        """Run `name` on the candidate, then on the twin from the same
        buffers; read the quantities (`read(before)` -> {quantity: tensor,
        or (tensor, the scale of its operands on the candidate's side)};
        a quantity keyed (op, quantity) is noted under that op) after each;
        leave the candidate's buffers."""

        def split(v):
            return (v[0], float(v[1])) if isinstance(v, tuple) else (v, None)

        before = {k: t.clone() for k, t in self.world.items()}
        getattr(self.k3, name)(*args)
        self._sync()
        got = {q: (split(v)[0].clone(), split(v)[1])
               for q, v in read(before).items()}
        after = {k: t.clone() for k, t in self.world.items()}
        for k, t in self.world.items():
            t.copy_(before[k])
        getattr(self.twin, name)(*args)
        for q, v in read(before).items():
            where, what = q if isinstance(q, tuple) else (op, q)
            self._note(where, what, got[q][0], split(v)[0], got[q][1])
        for k, t in self.world.items():
            t.copy_(after[k])

    def _grads(self, op, name, args, i, d, terms, dz):
        """The gradients an operation hands Adam for layer i's small
        vectors (the keys of `terms`, each with the scale of its sum's
        terms; "b": the largest dz), read by running the operation on the
        candidate and on the twin from the same buffers with those first
        moments zeroed, where Adam's m' is (1 - b1) g."""
        sm = self.fs["small"]
        before = {k: t.clone() for k, t in self.world.items()}
        got = []
        for side in (self.k3, self.twin):
            for k in terms:
                sm["m_" + k][i].zero_()
            getattr(side, name)(*args)
            self._sync()
            got.append({k: sm["m_" + k][i, :d] / self.omb1 for k in terms})
            if side is self.k3:
                terms = dict(terms, b=dz.float().abs().max())
            for k, t in self.world.items():
                t.copy_(before[k])
        for k, scale in terms.items():
            self._note(op, f"d{k}", got[0][k], got[1][k], float(scale))

    def _gemm_fwd_alone(self, i, a16, w16, bias, ncls):
        """The candidate's forward GEMM of layer i on these operands, with
        the bias (ncls = the width) or the bias and ReLU (ncls = -1)."""
        out = torch.empty((a16.shape[0], w16.shape[1]), device=a16.device)
        if self.cuda:
            self.k3._ran("gemm_fwd probe", self.k3.lib.asr_fe_gemm_fwd(
                a16.data_ptr(), w16.data_ptr(), bias.data_ptr(),
                out.data_ptr(), a16.shape[0], w16.shape[1], a16.shape[1],
                ncls, self.fwd_dims[i].dims(), self.k3._stream()))
            self._sync()
        else:
            self.k3.gemm_fwd(i, a16, w16, bias, out, ncls)
        return out

    def _gemm_dx_alone(self, i, dzb_up, w16_up):
        """The candidate's dX GEMM into layer i's output (i + 1's input)."""
        B, N = dzb_up.shape[0], w16_up.shape[0]
        out = torch.empty((B, N), device=dzb_up.device)
        if self.cuda:
            self.k3._ran("gemm_dx probe", self.k3.lib.asr_fe_gemm_dx(
                dzb_up.data_ptr(), w16_up.data_ptr(), out.data_ptr(), B, N,
                w16_up.shape[1], self.dx_dims[i + 1].dims(),
                self.k3._stream()))
            self._sync()
        else:
            self.k3.gemm_dx(i + 1, dzb_up, w16_up, out)
        return out

    # -- the operations of ct._epoch / ct._step ---------------------------

    def cast_w16(self, master, w16):
        self.k3.cast_w16(master, w16)

    def count_add(self, count, n):
        self.k3.count_add(count, n)

    def prologue(self, x, w, acts0, denom):
        self.step += 1
        if not self.holds(self.step):
            return self.k3.prologue(x, w, acts0, denom)
        self._both("prologue", "prologue", (x, w, acts0, denom),
                   lambda b: {"x (bf16)": acts0.float(), "row-weight sum":
                              denom})

    @_held
    def hidden_fwd(self, i, a16, w16, sm, w, sc, xhat, act_next, seeds, s):
        N = w16.shape[1]
        op = f"forward {i}"
        for q, ncls in (("z", N), ("a", -1)):
            out = self._gemm_fwd_alone(i, a16, w16, sm["b"][i], ncls)
            z = a16.float() @ w16.float() + sm["b"][i][:N]
            self._note(op, q, out, z if q == "z" else torch.clamp_min(z, 0))
        d, mom, a = N, self.mom, out  # the candidate's a: the sums' terms

        def read(b):
            mu = sc["muvec"][i, :d]
            return {"mu": (mu, a.abs().max()),
                    "sigma^2": ((sm["rvar"][i, :d] - mom * b["small.rvar"][
                        i, :d]) / (1 - mom), ((a - mu) ** 2).max()),
                    "1/sd": sc["sdvec"][i, :d],
                    "x^ (bf16)": xhat.float(), "output (bf16)":
                    act_next.float(), "running mean": sm["rmean"][i, :d],
                    "running var": sm["rvar"][i, :d]}

        self._both(op, "hidden_fwd",
                   (i, a16, w16, sm, w, sc, xhat, act_next, seeds, s), read)

    @_held
    def gemm_fwd(self, i, a16, w16, bias_row, out, n_classes):
        self._both("logits", "gemm_fwd", (i, a16, w16, bias_row, out,
                                          n_classes),
                   lambda b: {"logits": out[:, :n_classes]})

    @_held
    def ce_bwd(self, i, logits, y, w, sm, sc, losses, accs, s, dzb, count):
        d = self.spec.cfg.n_classes

        def read(b):
            return {"CE dz (bf16)": dzb[:, :d].float(),
                    "loss": losses[s:s + 1], "b": sm["b"][i, :d]}

        args = (i, logits, y, w, sm, sc, losses, accs, s, dzb, count)
        self._both("CE", "ce_bwd", args, read)
        self._grads("CE", "ce_bwd", args, i, d, {"b": 0.0}, dzb[:, :d])

    @_held
    def dx_bn_bwd(self, i, dzb_up, w16_up, xhat, w, sm, sc, dzb, seeds, s,
                  count):
        N = dzb.shape[1]
        op = f"backward {i}"
        dD = self._gemm_dx_alone(i, dzb_up, w16_up)
        ref = dzb_up.float() @ w16_up.float().T
        self._note(op, "dD", dD, ref)
        bn = self.spec.cfg.batch_norm
        if bn:
            g = sm["gamma"][i, :N]
            self._note(op, "dx^", dD * g, ref * g)

        keys = ("gamma", "beta", "b") if bn else ("b",)

        def read(b):
            out = {"dz (bf16)": dzb.float()}
            out.update({k: sm[k][i, :N] for k in keys})
            return out

        args = (i, dzb_up, w16_up, xhat, w, sm, sc, dzb, seeds, s, count)
        self._both(op, "dx_bn_bwd", args, read)
        terms = {"gamma": (dD * xhat.float()).abs().max(),
                 "beta": dD.abs().max(), "b": 0.0}
        self._grads(op, "dx_bn_bwd", args, i, N,
                    {k: terms[k] for k in keys}, dzb)

    @_held
    def dw_adam_all(self, acts, dzbs, fs, count, s):
        """Every layer's dW + Adam, as the candidate runs it (K3: the one
        grouped launch); each layer's quantities are noted under its own
        op, "dW + Adam i"."""
        m = len(dzbs)
        probe = {k: [torch.zeros_like(t) if k in ("mw", "vw") else t.clone()
                     for t in fs[k]] for k in ("masters", "mw", "vw", "w16")}
        self.k3.dw_adam_all(acts, dzbs, probe, count, s)
        self._sync()
        for i in range(m - 1, -1, -1):
            term = (acts[i].float().abs().amax(1)
                    * dzbs[i].float().abs().amax(1)).max()
            self._note(f"dW + Adam {i}", "dW", probe["mw"][i] / self.omb1,
                       self.twin.dw_product(i, acts[i], dzbs[i]), float(term))
        nonneg = self.spec.cfg.nonneg

        def read(b):
            out = {}
            for i in range(m - 1, -1, -1):
                op = f"dW + Adam {i}"
                out.update({(op, "Adam m"): fs["mw"][i],
                            (op, "Adam v"): fs["vw"][i],
                            (op, "master after NonNeg"): fs["masters"][i],
                            (op, "w16"): fs["w16"][i].float()})
                if nonneg:  # exactly 0 on both sides where the clamp holds
                    out[(op, "master < 0 (NonNeg)")] = (
                        torch.clamp_max(fs["masters"][i], 0.0),
                        b[f"masters[{i}]"].abs().max())
            return out

        self._both("dW + Adam", "dw_adam_all", (acts, dzbs, fs, count, s),
                   read)

    @_held
    def project(self, fs, sc):
        m = self.spec.n_layers
        if self.spec.fista:
            def read_fista(b):
                out = {f"projected W{i}": fs["masters"][i] for i in range(m)}
                out["FISTA iterations"] = (fs["fista_n"][1:2] - b["fista_n"][
                    1:2], 1.0)
                out["FISTA v"] = fs["fista_v"]
                return out

            return self._both("projection", "project", (fs, sc), read_fista)

        def read(b):
            f = torch.stack([
                torch.sum(fs["masters"][i] * b[f"masters[{i}]"])
                / torch.sum(b[f"masters[{i}]"] ** 2) for i in range(m)])
            return {"rescale f": f, "sigma": self.spec.rho / f[:1] ** m,
                    "u": fs["u"]}

        self._both("projection", "project", (fs, sc), read)


def k3_twin_lockstep(dev, spec, fs, xs, ys, ws, seeds, candidate=None,
                     held=None):
    """One epoch of the candidate (default: K3's kernels) and the twin in
    lockstep (`K3TwinLockstep`) from the packed state `fs` on the batches xs
    (n, B, pdims[0]), ys, ws (n, B) and the dropout seeds (n,); only the
    steps in `held` (default: all) are read -> (the readings in step order,
    the first departure: the first reading of a computed quantity, one
    outside `LOCKSTEP_PARAMS`, more than one bf16 ulp of its operands' scale
    apart, or None)."""
    xs, ys, ws, seeds = ct._epoch_inputs(spec, xs, ys, ws, seeds)
    fs = ct._state_map(lambda t: t.clone(), fs)
    sc = ct._scratch(spec, dev)
    n = xs.shape[0]
    losses = torch.zeros(n, device=dev)
    accs = torch.zeros(n, device=dev)
    lock = K3TwinLockstep(spec, candidate, held)
    lock.bind(fs, sc, losses, accs)
    with torch.no_grad():
        ct._epoch(lock, spec, fs, sc, xs, ys, ws, seeds, losses, accs)
    first = next((r for r in lock.rows if r["ulps"] > 1.0
                  and r["q"] not in LOCKSTEP_PARAMS), None)
    return lock.rows, first


def lockstep_on(dev, cfg, batch, data, labels, n_true, seeds):
    """`k3_twin_lockstep` over the whole epoch of the parity gate with
    `seeds` (`epoch_parity_vs_plain`: its init, its permutation, dropout 0,
    rho 0.1, 4 rounds)."""
    cfg0 = dataclasses.replace(cfg, dropout=(0.0,) * len(cfg.dropout))
    params, state = init_mlp(cfg0, _generator(dev, seeds[0]), device=dev)
    spec = ct.FusedStepSpec(cfg=cfg0, batch=batch, rho=0.1, pi_iters=4)
    feats = ct.pad_features(spec, data)
    xs, ys, ws = shuffle_batches(feats, labels, batch, True,
                                 _generator(dev, seeds[1]), n_true)
    zeros = torch.zeros(xs.shape[0], dtype=torch.int32, device=dev)
    return k3_twin_lockstep(dev, spec, ct.pack_state(spec, params, state),
                            xs, ys, ws, zeros)


def _fold(parts):
    """parts[0] + parts[1] + ... in that order: a cumsum over the leading
    dimension adds its rows one after another."""
    return torch.cumsum(parts, 0)[-1]


def _chained(a, b):
    """a (M, K) @ b (K, N), 16 of the depth at a time: the partial products
    added in order."""
    K = a.shape[1]
    pad = -K % 16
    a = torch.nn.functional.pad(a, (0, pad))
    b = torch.nn.functional.pad(b, (0, 0, 0, pad))
    chunks = a.shape[1] // 16
    return _fold(torch.bmm(a.reshape(a.shape[0], chunks, 16).transpose(0, 1),
                           b.reshape(chunks, 16, b.shape[1])))


class _ReorderedOps(ct._PlainOps):
    def colsum(self, t):
        """8-row group sums, added in order."""
        t = torch.nn.functional.pad(t, (0, 0, 0, -t.shape[0] % 8))
        return _fold(t.reshape(-1, 8, t.shape[1]).sum(1))

    def dw_product(self, i, acts, dzb):
        return _chained(acts.float().T, dzb.float())

    def gemm_fwd(self, i, a16, w16, bias_row, out, n_classes):
        d = out.shape[1]
        z = _chained(a16.float(), w16.float()) + bias_row[:d]
        if n_classes >= 0:
            cmask = torch.arange(d, device=z.device) >= n_classes
            z = torch.where(cmask, -1e9, z)
        else:
            z = torch.clamp_min(z, 0.0)
        out.copy_(z)

    def gemm_dx(self, i, dzb, w16, out):
        out.copy_(_chained(dzb.float(), w16.float().T))


def reordered_ops(spec):
    """The twin with its fp32 sums in another order, the kind of order K3's
    kernels add in: every GEMM accumulates its depth 16 at a time in order
    (the steps of a wgmma k16 chain), column sums add 8-row groups in order.
    The same arithmetic as the twin; only the order of the additions
    differs."""
    return _ReorderedOps(spec)
