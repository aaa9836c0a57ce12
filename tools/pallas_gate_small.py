"""The port's parity-gate BN bar on the JAX Pallas epoch, small steady case.

The case of `tests/test_torch_parity_gate.py`'s
`test_bn_bar_admits_the_jax_pallas_epoch` (in_dim 20, hidden (32, 16), 4
classes, NonNeg, BN, dropout 0, rho 0.1, 4 power-iteration rounds, batch 64;
steady rows: 4 prototypes repeated with noise 1e-3, no shuffle) over longer
epochs: the JAX package's Pallas epoch in
interpret mode on the CPU, its end state carried across with
`models/convert.py`, the port's twin, and the twin with the Pallas kernel's
leaky backward ReLU mask (`FusedStepSpec(pallas_relu_mask=True)`), each
against the port's plain bf16 epoch from the same init, beside the order
spread s (twin against reordered twin) and the bar max(6e-3,
GATE_SPREAD_FACTOR * s). Seed d seeds the rows
and the JAX init (PRNGKey(d)).

    JAX_PLATFORMS=cpu python tools/pallas_gate_small.py --steps 8,16,32,64 \\
        --seeds 0,1
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

B = 64
KW = dict(in_dim=20, n_classes=4, hidden=(32, 16), nonneg=True,
          dropout=(0.0, 0.0))


def reading(steps, seed):
    import jax
    import jax.numpy as jnp
    import torch

    from asr_using_robust_nn_tpu.models import mlp as jmlp
    from asr_using_robust_nn_tpu.ops import pallas_train as jpt
    from asr_using_robust_nn_tpu_torch.constraints import (
        make_simple_norm_constraint)
    from asr_using_robust_nn_tpu_torch.models import mlp
    from asr_using_robust_nn_tpu_torch.models.convert import (
        fstate_from_numpy, params_from_numpy)
    from asr_using_robust_nn_tpu_torch.ops import cuda_train as ct
    from asr_using_robust_nn_tpu_torch.train.epoch_scan import build_epoch_fn
    from asr_using_robust_nn_tpu_torch.train.trainer import adam_optimizer

    rng = np.random.default_rng(seed)
    protos = rng.normal(0.0, 1.0, (4, 20))
    which = rng.integers(0, 4, steps * B)
    x = (protos[which] + 1e-3 * rng.standard_normal((steps * B, 20))
         ).astype(np.float32)
    y = (which % 4).astype(np.int64)
    jspec = jpt.FusedStepSpec(cfg=jmlp.MLPConfig(**KW), batch=B, rho=0.1,
                              pi_iters=4, interpret=True)
    spec = ct.FusedStepSpec(cfg=mlp.MLPConfig(**KW), batch=B, rho=0.1,
                            pi_iters=4)
    jp, js = jax.tree_util.tree_map(
        np.asarray, jmlp.init_mlp(jspec.cfg, jax.random.PRNGKey(seed)))
    fs_np = jax.tree_util.tree_map(np.asarray, jpt.pack_state(jspec, jp, js))
    xs = np.zeros((steps, B, spec.pdims[0]), np.float32)
    xs[..., :20] = x.reshape(steps, B, 20)
    batches = (xs, y.reshape(steps, B, 1).astype(np.int32),
               np.ones((steps, B, 1), np.float32), np.zeros(steps, np.int32))
    jfs = jpt.build_fused_epoch_call(jspec, steps)(
        jax.tree_util.tree_map(jnp.asarray, fs_np),
        *(jnp.asarray(a) for a in batches))[0]
    fs = fstate_from_numpy(fs_np, device="cpu")
    tb = [torch.from_numpy(a) for a in batches]

    def mu0(fstate):
        return ct.unpack_params(spec, fstate)[1]["layers"][0]["mean"]

    leaky = dataclasses.replace(spec, pallas_relu_mask=True)
    mu = {"pallas": mu0(fstate_from_numpy(
              jax.tree_util.tree_map(np.asarray, jfs), device="cpu")),
          "twin": mu0(ct.fused_epoch_plain(spec, fs, *tb)[0]),
          "leaky twin": mu0(ct.fused_epoch_plain(leaky, fs, *tb)[0])}
    params, state = params_from_numpy(jp, js, device="cpu")
    con = make_simple_norm_constraint(0.1, n_iter=4, pi_backend="plain")
    opt = adam_optimizer(1e-3, "float32")
    ep = build_epoch_fn(spec.cfg.with_bf16(), opt, constraint=con.apply,
                        batch_size=B, shuffle=False, reshuffle_inner=False)
    mu["plain"] = ep(params, state, opt.init(params), con.init(params),
                     torch.from_numpy(x), torch.from_numpy(y), None, None,
                     steps * B)[1]["layers"][0]["mean"]
    s = ct.order_spread(spec, fs, *tb)

    def gap(a, b):
        return float((mu[a] - mu[b]).abs().max())

    return {"steps": steps, "seed": seed,
            "pallas_vs_plain": gap("pallas", "plain"),
            "twin_vs_plain": gap("twin", "plain"),
            "pallas_vs_twin": gap("pallas", "twin"),
            "leaky_twin_vs_plain": gap("leaky twin", "plain"),
            "pallas_vs_leaky_twin": gap("pallas", "leaky twin"), "s": s,
            "bar": ct.bn_bar(steps, s)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", default="8,16,32,64")
    ap.add_argument("--seeds", default="0,1")
    args = ap.parse_args(argv)
    import torch

    torch.set_num_threads(1)
    for seed in (int(v) for v in args.seeds.split(",")):
        for steps in (int(v) for v in args.steps.split(",")):
            print(json.dumps(reading(steps, seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
