"""Where a K3 epoch's time goes, on a CUDA device.

    python3 -m asr_using_robust_nn_tpu_torch.tools.profile_epoch [--reps 10]

One digit-recipe epoch (digit_constrained, 33 steps of 512 rows, the last
with 182 true rows, seeded random features) as K3's CUDA graph:

  * ms per epoch by CUDA events at three projection settings (simple_norm
    rho 0.1 with 16 and with 4 power-iteration rounds, and no projection),
    and of the recipe without BatchNorm (the fused kernels then skip their
    exchanges across the cluster, which shows what those cost);
  * the graph replay alone against the whole call (state copied in and out);
  * device time by kernel family, from torch.profiler's key_averages() over
    3 replays, with launches per epoch, and the graph's kernel nodes per
    step;
  * the launches of one step (the second) in order, with each one's device
    time.

Exits non-zero without a CUDA device. Prints the card's name and power
limit, and as its last line the numbers as one JSON object.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import subprocess
import sys

import torch

from ..models.mlp import MLPConfig, init_mlp
from ..ops import cuda_train as ct

STEPS, BATCH, TRUE_LAST = 33, 512, 182

# kernel-name fragment -> family, first match wins
FAMILIES = (
    ("fe_dw_adam_group", "dW GEMM + Adam + NonNeg + bf16 copy, every layer "
     "in one persistent launch"),
    ("fe_dw_adam", "dW GEMM + Adam + NonNeg + bf16 copy (cluster over depth)"),
    ("fe_dx_bn", "dX GEMM + BN/ReLU/dropout backward + Adam of gamma, beta, b"),
    ("fe_fwd_bn", "forward GEMM + bias + ReLU + BN + dropout"),
    ("EpiLogits", "logits GEMM"),
    ("EpiStore", "dX GEMM (separate-BN form)"),
    ("EpiHidden", "forward GEMM (separate-BN form)"),
    ("pi_cluster", "K2 (one cluster launch per step: links, finish, rescale)"),
    ("fe_bn_bwd", "BN backward kernel (separate-BN form)"),
    ("fe_bn_fwd", "BN forward kernel (separate-BN form)"),
    ("fe_ce", "softmax-CCE + output layer's dZ, db, Adam of b"),
    ("fe_", "prologue, casts, count"),
)


def family(name: str) -> str:
    return next((f for key, f in FAMILIES if key in name), "other")


def time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_epoch: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    cfg = MLPConfig.digit_constrained()
    params, state = init_mlp(cfg, torch.Generator(device=dev).manual_seed(31),
                             device=dev)
    g = torch.Generator(device=dev).manual_seed(2)
    spec0 = ct.FusedStepSpec(cfg=cfg, batch=BATCH)
    xs = torch.randn((STEPS, BATCH, spec0.pdims[0]), generator=g, device=dev)
    xs[..., cfg.in_dim:] = 0.0
    ys = torch.randint(0, cfg.n_classes, (STEPS, BATCH, 1), generator=g,
                       device=dev)
    ws = torch.ones((STEPS, BATCH, 1), device=dev)
    ws[-1, TRUE_LAST:] = 0.0
    seeds = torch.randint(0, 2 ** 31 - 1, (STEPS,), generator=g, device=dev,
                          dtype=torch.int32)

    out = {"card": card, "epoch_ms": {}}
    runs = {}
    no_bn = dataclasses.replace(cfg, batch_norm=False)
    for c, rho, n_iter in ((cfg, 0.1, 16), (cfg, 0.1, 4), (cfg, None, 16),
                           (no_bn, 0.1, 16)):
        spec = ct.FusedStepSpec(cfg=c, batch=BATCH, rho=rho, pi_iters=n_iter)
        fs = ct.pack_state(spec, params, state)
        run = ct.build_fused_epoch_call(spec, STEPS)
        key = "no projection" if rho is None else f"rho {rho}, {n_iter} rounds"
        if c is no_bn:
            key += ", no BatchNorm"
        out["epoch_ms"][key] = time_ms(
            lambda: run(fs, xs, ys, ws, seeds), args.reps)
        runs[key] = run
    print(f"K3 ms/epoch by setting: {out['epoch_ms']}; card {card}",
          flush=True)

    run = runs["rho 0.1, 16 rounds"]
    graph = run.graphs[dev].graph
    out["replay_ms"] = time_ms(graph.replay, args.reps)
    print(f"K3 graph replay alone {out['replay_ms']:.3f} ms vs the whole call "
          f"{out['epoch_ms']['rho 0.1, 16 rounds']:.3f} ms", flush=True)

    from torch.profiler import ProfilerActivity, profile

    n = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            graph.replay()
        torch.cuda.synchronize()
    ms = collections.defaultdict(float)
    launches = collections.defaultdict(float)
    for e in prof.key_averages():
        dt = getattr(e, "device_time_total", None) or getattr(
            e, "cuda_time_total", 0)
        if dt > 0:
            ms[family(e.key)] += dt / 1e3 / n
            launches[family(e.key)] += e.count / n
    if not ms:
        print("profile_epoch: the profiler saw no device time",
              file=sys.stderr)
        return 1
    total = sum(ms.values())
    # the casts before and after the steps and the count update aside
    edge = 2 * spec0.n_layers + 1
    out["graph_nodes_per_step"] = (sum(launches.values()) - edge) / STEPS
    out["kernels_enqueued_at_capture"] = run.graphs[dev].kernel_nodes
    out["families"] = {f: {"ms": ms[f], "launches": launches[f],
                           "share": ms[f] / total}
                       for f in sorted(ms, key=lambda f: -ms[f])}
    out["families_sum_ms"] = total
    for f, v in out["families"].items():
        print(f"{v['ms']:9.3f} ms/epoch {v['launches']:7.0f} launches "
              f"{100 * v['share']:5.1f} %  {f}", flush=True)
    print(f"sum {total:.3f} ms/epoch vs replay {out['replay_ms']:.3f} ms; "
          f"{out['graph_nodes_per_step']:.1f} kernel nodes per step; card "
          f"{card}", flush=True)
    # one step's launches in order: the second step of the last replay
    events = sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    per_replay = len(events) // n
    nodes = round(out["graph_nodes_per_step"])
    first = len(events) - per_replay + spec0.n_layers + nodes
    out["step_launches_us"] = []
    for e in events[first: first + nodes]:
        name = e.name.replace("(anonymous namespace)::", "").split("(")[0]
        dur = e.time_range.end - e.time_range.start
        out["step_launches_us"].append([name[:40], dur])
        print(f"{dur:8.1f} us  {name[:60]}", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
