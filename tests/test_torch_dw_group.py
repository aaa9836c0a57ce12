"""K3's weight updates as one grouped launch after the dX chain
(asr_using_robust_nn_tpu_torch/ops/cuda_train.py: `_step`, `launch_plan`'s
`dw_group`, `_CudaOps.dw_adam_all`; csrc/fused_epoch.cu: `fe_dw_adam_group`).

On the CPU: the step with every dW after the whole dX chain gives the same
bits as the step that updated each layer right after its dX; the grouped
launch's tile list covers every tile of every layer once and sums each
layer's depth in the slices of the per-layer launch. On the card (marker
`cuda`; no JAX imported here, so it runs without the suite's conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_dw_group.py

the grouped launch against one `fe_dw_adam` launch a layer, bit for bit.
"""

import numpy as np
import pytest
import torch

from asr_using_robust_nn_tpu_torch.models import mlp
from asr_using_robust_nn_tpu_torch.ops import cuda_train as ct

SMALL = dict(in_dim=20, n_classes=4, hidden=(200, 64, 32), nonneg=True,
             dropout=(0.1, 0.0, 0.2))


def _interleaved_step(ops, spec, fs, sc, x, y, w, seeds, s, losses, accs):
    """The step as it was before the weight updates were grouped: layer
    i's dW + Adam right after the dX of layer i - 1."""
    m, pd, B = spec.n_layers, spec.pdims, spec.batch
    sm, dzb = fs["small"], sc["dzb"]
    ops.prologue(x, w, sc["acts"][0], sc["denom"])
    for i in range(m - 1):
        ops.hidden_fwd(i, sc["acts"][i], fs["w16"][i], sm, w, sc,
                       sc["xhats"][i], sc["acts"][i + 1], seeds, s)
    z = ct._view(sc["z"], B, pd[-1])
    ops.gemm_fwd(m - 1, sc["acts"][m - 1], fs["w16"][m - 1], sm["b"][m - 1],
                 z, spec.cfg.n_classes)
    ops.ce_bwd(m - 1, z, y, w, sm, sc, losses, accs, s, dzb[m - 1],
               fs["count"])
    for i in range(m - 1, -1, -1):
        if i > 0:
            ops.dx_bn_bwd(i - 1, dzb[i], fs["w16"][i], sc["xhats"][i - 1], w,
                          sm, sc, dzb[i - 1], seeds, s, fs["count"])
        ops.gemm_dw_adam(i, sc["acts"][i], dzb[i], fs, fs["count"], s)
    if spec.rho is not None:
        ops.project(fs, sc)


def _batches(spec, n, seed, ragged, device="cpu"):
    """n gathered batches, the last `ragged` rows of the last one weighted
    0 and filled with large values; labels, dropout seeds."""
    g = torch.Generator().manual_seed(seed)
    B, d = spec.batch, spec.dims[0]
    xs = torch.zeros((n, B, spec.pdims[0]))
    xs[..., :d] = torch.randn((n, B, d), generator=g)
    ys = torch.randint(0, spec.dims[-1], (n, B, 1), generator=g,
                       dtype=torch.int32)
    ws = torch.ones((n, B, 1))
    if ragged:
        ws[-1, -ragged:] = 0.0
        xs[-1, -ragged:, :d] = 1e3
    seeds = torch.randint(0, 2 ** 31 - 1, (n,), generator=g,
                          dtype=torch.int32)
    return tuple(t.to(device) for t in (xs, ys, ws, seeds))


def _state(spec, seed, device="cpu"):
    params, state = mlp.init_mlp(spec.cfg,
                                 torch.Generator(device=device).manual_seed(
                                     seed), device=device)
    return ct.pack_state(spec, params, state)


def _assert_same_bits(a, b):
    la, lb = ct._state_leaves(a), ct._state_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


@pytest.mark.parametrize("bn", [True, False])
@pytest.mark.parametrize("projection", ["simple_norm", "fista", None])
def test_grouped_step_is_bit_equal_to_the_interleaved_step(
        monkeypatch, bn, projection):
    """Four steps of the twin (dropout on, NonNeg, a ragged last batch):
    every dW after the whole dX chain gives the state, losses and
    accuracies of the step that ran each layer's dW right after its dX,
    bit for bit, with and without BN, under simple_norm, FISTA and no
    projection."""
    cfg = mlp.MLPConfig(batch_norm=bn, **SMALL)
    rho = {"simple_norm": 0.5, "fista": 2.0, None: None}[projection]
    spec = ct.FusedStepSpec(cfg=cfg, batch=128, rho=rho, pi_iters=8,
                            projection=projection or "simple_norm")
    fs0 = _state(spec, 3)
    args = _batches(spec, 4, 4, ragged=40)
    grouped = ct.fused_epoch_plain(spec, fs0, *args)
    monkeypatch.setattr(ct, "_step", _interleaved_step)
    interleaved = ct.fused_epoch_plain(spec, fs0, *args)
    _assert_same_bits(grouped[0], interleaved[0])
    assert torch.equal(grouped[1], interleaved[1])
    assert torch.equal(grouped[2], interleaved[2])
    # the steps moved every kernel: the comparison is not of a fixed point
    for a, b in zip(grouped[0]["masters"], fs0["masters"]):
        assert not torch.equal(a, b)


def test_twin_runs_the_weight_updates_after_the_dx_chain():
    """The step calls its operations in this order: the forward, the CCE,
    the dX chain from the top, then one `dw_adam_all` over every layer,
    which the twin composes from one `gemm_dw_adam` a layer, top first."""
    spec = ct.FusedStepSpec(cfg=mlp.MLPConfig(**SMALL), batch=64, rho=0.5)
    calls = []

    class Recording(ct._PlainOps):
        def dx_bn_bwd(self, i, *args):
            calls.append(("dx", i))
            return super().dx_bn_bwd(i, *args)

        def dw_adam_all(self, *args):
            calls.append(("all",))
            return super().dw_adam_all(*args)

        def gemm_dw_adam(self, i, *args):
            calls.append(("dw", i))
            return super().gemm_dw_adam(i, *args)

    ct.fused_epoch_plain(spec, _state(spec, 1), *_batches(spec, 1, 2, 0),
                         ops=Recording(spec))
    m = spec.n_layers
    assert calls == ([("dx", i) for i in range(m - 2, -1, -1)] + [("all",)]
                     + [("dw", i) for i in range(m - 1, -1, -1)])


def test_scratch_keeps_one_dz_buffer_a_layer():
    """Each layer's bf16 dZ has its own buffer, (batch, its padded width):
    every dW reads its dZ after the whole chain has written the others."""
    spec = ct.FusedStepSpec(cfg=mlp.MLPConfig.digit_constrained(),
                            batch=512, rho=0.1)
    dzb = ct._scratch(spec, "cpu")["dzb"]
    assert [tuple(t.shape) for t in dzb] == [(512, d) for d in spec.pdims[1:]]
    assert all(t.dtype == torch.bfloat16 for t in dzb)
    assert sum(t.numel() * 2 for t in dzb) == 512 * 2176 * 2  # 2.2 MB


# The three train cells' specs (h100bench/configs) and a batch whose BN runs
# as separate column kernels (more than 8 row tiles).
CELLS = [("digit_constrained", 512, "simple_norm"),
         ("speaker_constrained", 64, "simple_norm"),
         ("digit_constrained", 512, "fista"),
         ("digit_constrained", 1024, "simple_norm"),
         ("speaker_constrained", 576, "simple_norm")]


def _cell_spec(preset, batch, projection):
    rho = 5.0 if projection == "fista" else 0.1
    return ct.FusedStepSpec(cfg=getattr(mlp.MLPConfig, preset)(),
                            batch=batch, rho=rho, projection=projection)


@pytest.mark.parametrize("preset,batch,projection", CELLS)
def test_group_list_covers_every_tile_once(preset, batch, projection):
    """The grouped launch lists each 64 x 64 tile of each layer's dW once,
    the largest layer first; its persistent blocks (four an SM of an
    H100, at most one a tile) take the list round robin, so each tile goes
    to one block; four blocks' shared memory fits an SM."""
    spec = _cell_spec(preset, batch, projection)
    plan = ct.launch_plan(spec)
    g = plan["dw_group"]
    pd, m = spec.pdims, spec.n_layers
    assert sorted(i for i, *_ in g.layers) == list(range(m))
    sizes = [r * c for _, r, c, _ in g.layers]
    assert sizes == sorted(sizes, reverse=True)
    assert all((r, c) == (pd[i], pd[i + 1]) for i, r, c, _ in g.layers)
    seen = {i: np.zeros((pd[i] // 64, pd[i + 1] // 64), int)
            for i in range(m)}
    for i, r0, c0 in g.tiles():
        seen[i][r0 // 64, c0 // 64] += 1
    assert all((s == 1).all() for s in seen.values())
    assert g.n_tiles == len(g.tiles()) == sum(s.size for s in seen.values())
    assert g.grid == (min(4 * 132, g.n_tiles), 1, 1) and g.depth == batch
    owned = [t for b in range(g.grid[0]) for t in g.block_tiles(b)]
    assert sorted(owned) == sorted(g.tiles())
    assert max(map(len, map(g.block_tiles, range(g.grid[0])))) == \
        -(-g.n_tiles // g.grid[0])
    assert g.smem_bytes == 1024 + 3 * 2 * 64 * 128  # a 3-stage ring
    assert 4 * (g.smem_bytes + 1024) <= 233472      # four blocks an SM


@pytest.mark.parametrize("preset,batch,projection", CELLS)
def test_group_depth_slices_are_the_per_layer_splits(preset, batch,
                                                     projection):
    """For each layer the grouped launch adds the depth slices the
    per-layer launch's cluster ranks sum (`_dw_split`), in rank order: the
    same partial sums in the same order."""
    spec = _cell_spec(preset, batch, projection)
    plan = ct.launch_plan(spec)
    g, pd = plan["dw_group"], spec.pdims
    for i, rows, cols, split in g.layers:
        L = plan["dw"][i]
        assert split == L.cluster[2] == ct._dw_split(
            (rows // 64) * (cols // 64), batch // 64)
        assert g.depth_slices(i) == L.rank_depth()
        assert all((k1 - k0) % 64 == 0 for k0, k1 in g.depth_slices(i))
    if (preset, batch) == ("digit_constrained", 512):  # layers 2-5 split
        assert [plan["dw"][i].cluster[2] for i in range(6)] == \
            [1, 1, 4, 8, 8, 8]
    if preset == "speaker_constrained" and batch == 64:
        assert all(sp == 1 for *_, sp in g.layers)


def test_group_walk_sums_as_the_per_layer_launch():
    """The grouped block's sum of a tile, emulated in float32 (each depth
    rank's slices from zero, the rank sums added to zero in rank order),
    equals the per-layer launch's (each rank's partial, added in rank order
    by the owning rank) bit for bit, on bf16 operands at the digit widths
    of the narrow split layers."""
    spec = _cell_spec("digit_constrained", 512, "simple_norm")
    plan = ct.launch_plan(spec)
    g = torch.Generator().manual_seed(6)
    for i in (2, 3, 5):
        acts = torch.randn((512, spec.pdims[i]), generator=g).to(
            torch.bfloat16).float()
        dz = torch.randn((512, spec.pdims[i + 1]), generator=g).to(
            torch.bfloat16).float()
        per_layer = torch.zeros((spec.pdims[i], spec.pdims[i + 1]))
        for k0, k1 in plan["dw"][i].rank_depth():
            per_layer = per_layer + acts[k0:k1].T @ dz[k0:k1]
        grouped = torch.zeros_like(per_layer)
        for k0, k1 in plan["dw_group"].depth_slices(i):
            grouped += acts[k0:k1].T @ dz[k0:k1]
        assert torch.equal(grouped, per_layer)


def test_layers_past_the_group_limit_keep_the_per_layer_launches():
    """A model deeper than the grouped launch lists keeps one dW launch a
    layer (the plan has no group); the step's launches say so."""
    cfg = mlp.MLPConfig(in_dim=64, n_classes=10, hidden=(64,) * 16)
    plan = ct.launch_plan(ct.FusedStepSpec(cfg=cfg, batch=64))
    assert plan["dw_group"] is None
    launches = ct.plan_launches(plan)
    assert [L.kernel for L in launches[-17:]] == ["dw_adam"] * 17


# -- on the card ----------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


class _PerLayerOps(ct._CudaOps):
    """K3's kernels with one `fe_dw_adam` launch a layer."""

    dw_adam_all = ct._ComposedOps.dw_adam_all


@pytest.mark.cuda
@pytest.mark.parametrize("preset,batch,projection,ragged", [
    ("speaker_constrained", 64, "simple_norm", 37),
    ("digit_constrained", 512, "simple_norm", 182),
    ("digit_constrained", 512, "fista", 182)])
def test_grouped_launch_is_bit_equal_to_the_per_layer_launches(
        dev, monkeypatch, preset, batch, projection, ragged):
    """At the three train cells' specs (dropout on, a ragged last batch):
    one step (the ragged batch) launch by launch, then a 3-step epoch as a
    captured graph,
    with the grouped launch and with one `fe_dw_adam` launch a layer: the
    packed state (masters, w16, moments, small vectors, count, K7's state)
    bit-equal; two replays of the grouped graph bit-equal; the grouped
    graph holds m - 1 fewer kernels a step."""
    spec = _cell_spec(preset, batch, projection)
    fs0 = _state(spec, 7, dev)
    args = _batches(spec, 3, 8, ragged, dev)
    one = tuple(t[-1:] for t in args)  # the ragged batch
    ops = [ct._CudaOps(spec), _PerLayerOps(spec)]
    ct.preload_kernels(ops[0].lib)
    ct.preload()
    if spec.fista:
        ct.fista_preload(spec.dims)
    steps = [ct.fused_epoch_plain(spec, fs0, *one, ops=o) for o in ops]
    torch.cuda.synchronize()
    _assert_same_bits(steps[0][0], steps[1][0])
    assert ops[1].launched - ops[0].launched == spec.n_layers - 1

    grouped = ct.build_fused_epoch_call(spec, 3)
    out = [grouped(fs0, *args), grouped(fs0, *args)]
    monkeypatch.setattr(ct._CudaOps, "dw_adam_all",
                        ct._ComposedOps.dw_adam_all)
    per_layer = ct.build_fused_epoch_call(spec, 3)
    out.append(per_layer(fs0, *args))
    torch.cuda.synchronize()
    for o in out[1:]:
        _assert_same_bits(out[0][0], o[0])
        assert torch.equal(out[0][1], o[1]) and torch.equal(out[0][2], o[2])
    nodes = [run.graphs[dev].kernel_nodes for run in (grouped, per_layer)]
    assert nodes[1] - nodes[0] == 3 * (spec.n_layers - 1)
    for a, b in zip(out[0][0]["masters"], fs0["masters"]):
        assert not torch.equal(a, b)
