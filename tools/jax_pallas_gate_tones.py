"""The JAX Pallas epoch's own parity gate on long epochs of steady tones.

The gate of `asr_using_robust_nn_tpu/ops/pallas_train.py::epoch_parity_vs_xla`
(one dropout-0 epoch of the Pallas epoch kernel against the XLA epoch on the
bf16 model config, from one init and one permutation; the layer-0 BN running
mean held to 6e-3) with the kernel run in interpret mode on the CPU
(`FusedStepSpec(interpret=True)`), so that it reads on any machine. The
package's function builds its spec without `interpret`; this script repeats
its arithmetic with it, and changes nothing else.

The corpus is the steady tones on which the port's K3 gate reads over its bar
at 32 to 64 steps of 512: class c a tone at 300 * 1.25**c Hz (+-2 %) with its
second and third harmonics at random weights, random loudness within 6 dB, low
noise, over the whole second; MFCCs of the digit preset by the JAX frontend
(rFFT form), flattened and standardized on themselves. Draw d seeds the
corpus, the init (PRNGKey(7 + d)) and the permutation (PRNGKey(3 + d)).

    JAX_PLATFORMS=cpu python tools/jax_pallas_gate_tones.py \\
        --steps 8,16,32,64 --draws 0,1 --out docs/f9_jax_pallas_gate/gate.json
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BATCH = 512  # the digit recipe's batch, at which the gate's bar was set


def steady_tones(labels, seed, width=22050, sr=22050, chunk=1024):
    """(n, width) float32 steady tones for `labels`, made `chunk` rows at a
    time (rows i*chunk.. from numpy's generator seeded (seed, i))."""
    return np.concatenate([
        _tones(labels[i: i + chunk], (seed, i // chunk), width, sr)
        for i in range(0, len(labels), chunk)])


def _tones(labels, seed, width, sr):
    rng = np.random.default_rng(seed)
    n = len(labels)

    def uni(lo, hi, shape=(n, 1)):
        return lo + (hi - lo) * rng.random(shape)

    t = np.arange(width)[None, :] / float(sr)
    f0 = 300.0 * 1.25 ** np.asarray(labels, np.float64)[:, None] \
        * uni(0.98, 1.02)
    k = np.arange(1, 4, dtype=np.float64)[None, :, None]
    weight = np.concatenate([np.ones((n, 1)), uni(0.0, 0.5, (n, 2))],
                            1)[:, :, None]
    phase = 2 * np.pi * f0[:, :, None] * k * t[:, None, :] \
        + uni(0, 6.3, (n, 3))[:, :, None]
    tone = (weight * np.sin(phase)).sum(1)
    noise = uni(1e-3, 5e-3) * rng.standard_normal((n, width))
    return (uni(0.2, 0.4) * tone + noise).astype(np.float32)


def features(waves):
    """Digit-preset MFCCs of `waves`, flattened, standardized on themselves."""
    import jax.numpy as jnp

    from asr_using_robust_nn_tpu.ops.mfcc_xla import (FrontendConfig,
                                                      mfcc_fft_batch)

    cfg = FrontendConfig.digit()
    out = [np.asarray(mfcc_fft_batch(jnp.asarray(waves[i: i + 256]), cfg))
           for i in range(0, len(waves), 256)]
    x = np.concatenate(out).reshape(len(waves), -1).astype(np.float64)
    x = (x - x.mean(0)) / np.where(x.std(0) > 0, x.std(0), 1.0)
    return x.astype(np.float32)


def gate(mcfg, batch, data, labels, n_true, draw):
    """`epoch_parity_vs_xla`'s arithmetic with an interpret-mode kernel and
    the draw's init and permutation keys."""
    import jax
    import jax.numpy as jnp

    from asr_using_robust_nn_tpu.constraints import make_simple_norm_constraint
    from asr_using_robust_nn_tpu.models.mlp import init_mlp
    from asr_using_robust_nn_tpu.ops import pallas_train as pt
    from asr_using_robust_nn_tpu.train.epoch_scan import build_epoch_fn
    from asr_using_robust_nn_tpu.train.trainer import adam_optimizer

    cfg0 = dataclasses.replace(mcfg, dropout=(0.0,) * len(mcfg.dropout))
    params, state = init_mlp(cfg0, jax.random.PRNGKey(7 + draw))
    pk, dk = jax.random.PRNGKey(3 + draw), jax.random.PRNGKey(4 + draw)
    spec = pt.FusedStepSpec(cfg=cfg0, batch=batch, rho=0.1, pi_iters=4,
                            interpret=True)
    fs = pt.pack_state(spec, params, state)
    con = make_simple_norm_constraint(0.1, n_iter=4)
    opt = adam_optimizer(1e-3, "float32")
    ep_xla = build_epoch_fn(cfg0.with_bf16(), opt, constraint=con.apply,
                            batch_size=batch, epochs_per_call=1,
                            reshuffle_inner=False)
    px, sx, _, _, loss_x, acc_x = ep_xla(
        params, state, opt.init(params), con.init(params), data, labels,
        pk, dk, n_true=n_true)
    ep_pl = pt.build_fused_epoch_fn(spec, epochs_per_call=1,
                                    reshuffle_inner=False)
    fs2, loss_p, acc_p = ep_pl(fs, pt.pad_features(spec, data), labels, pk,
                               dk, n_true=n_true)
    pp, sp = pt.unpack_params(spec, fs2)
    dw = max(float(jnp.max(jnp.abs(a["w"] - b["w"])))
             for a, b in zip(pp["layers"], px["layers"]))
    db = max(float(jnp.max(jnp.abs(a["b"] - b["b"])))
             for a, b in zip(pp["layers"], px["layers"]))
    dmu = float(jnp.max(jnp.abs(sp["layers"][0]["mean"]
                                - sx["layers"][0]["mean"])))
    steps = data.shape[0] // batch
    tol_param = 1e-3 * max(8.0, 2.0 * steps)
    dloss = abs(float(loss_p) - float(loss_x))
    dacc = abs(float(acc_p) - float(acc_x))
    ok = (dw < tol_param and db < tol_param and dmu < 6e-3
          and dloss < 3e-2 and dacc < 3e-2)
    return {"ok": bool(ok), "max_dw": dw, "max_db": db, "max_dmu": dmu,
            "dloss": dloss, "dacc": dacc, "tol_param": tol_param,
            "tol_bn_mean": 6e-3}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", default="8,16,32,64")
    ap.add_argument("--draws", default="0,1")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    import jax
    import jax.numpy as jnp

    from asr_using_robust_nn_tpu.models.mlp import MLPConfig

    steps = [int(s) for s in args.steps.split(",")]
    cfg = MLPConfig.digit_constrained()
    rows = []
    for d in (int(s) for s in args.draws.split(",")):
        n = max(steps) * BATCH
        lab = np.random.default_rng(95 + 10 * d).integers(0, 10, n)
        t0 = time.time()
        x = features(steady_tones(lab, 9500 + 100000 * d))
        t_feat = time.time() - t0
        for k in steps:
            r = k * BATCH
            t0 = time.time()
            g = gate(cfg, BATCH, jnp.asarray(x[:r]),
                     jnp.asarray(lab[:r].astype(np.int32)), r, d)
            rows.append(dict(draw=d, steps=k, batch=BATCH,
                             seconds=time.time() - t0, **g))
            print(f"draw {d}, {k} steps of {BATCH}: BN mean gap "
                  f"{g['max_dmu']:.3e} (bar 6e-3), params {g['max_dw']:.3e}"
                  f" / {g['max_db']:.3e} (bar {g['tol_param']:g}), loss "
                  f"{g['dloss']:.2e}, ok {g['ok']} "
                  f"({time.time() - t0:.0f} s)", flush=True)
        print(f"draw {d}: features {t_feat:.0f} s", flush=True)
    out = {"what": "epoch_parity_vs_xla with FusedStepSpec(interpret=True), "
                   "digit_constrained, steady tones",
           "jax": jax.__version__, "backend": jax.default_backend(),
           "rows": rows}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
