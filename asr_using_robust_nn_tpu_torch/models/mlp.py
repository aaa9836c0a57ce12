"""The reference's MLP model family on plain tensor dicts.

Counterpart of the JAX package's `models/mlp.py`. Four variants, all
6-layer dense stacks:

  digit_unconstrained   880->1024->512->256->128->64->10, per hidden block
                        Dense->ReLU->BN->Dropout(0.4)
  digit_constrained     same trunk, NonNeg on every Dense kernel,
                        Dropout(0.1) on the first 3 blocks only
  speaker_unconstrained 2020->...->20, plain Dense+ReLU (no BN/Dropout)
  speaker_constrained   2020->...->20, NonNeg + BN everywhere, Dropout(0.1)
                        first 3 blocks

Keras-parity details: glorot_uniform kernel init, zero bias; BN with
momentum 0.99, eps 1e-3, batch stats in training and moving stats in eval;
inverted dropout; softmax head.

Parameters keep the JAX pytree layout, so weights move between the packages
without transposes: params = {"layers": [{"w": (d_in, d_out), "b",
"gamma", "beta"}]}, state = {"layers": [{"mean", "var"}]}.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..utils.device import resolve_device

__all__ = ["MLPConfig", "init_mlp", "apply_mlp", "data_sum", "predict_probs",
           "dense_kernels", "set_dense_kernels"]

HIDDEN = (1024, 512, 256, 128, 64)


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    in_dim: int
    n_classes: int
    hidden: tuple[int, ...] = HIDDEN
    batch_norm: bool = True
    dropout: tuple[float, ...] = (0.4, 0.4, 0.4, 0.4, 0.4)
    nonneg: bool = False  # Keras kernel_constraint=NonNeg() on every Dense
    bn_momentum: float = 0.99
    bn_eps: float = 1e-3
    # 'bfloat16': every Dense GEMM takes bf16-rounded operands and sums in
    # fp32, as the JAX package's mixed-precision option does
    compute_dtype: str = "float32"

    def with_bf16(self) -> "MLPConfig":
        return dataclasses.replace(self, compute_dtype="bfloat16")

    @staticmethod
    def digit_unconstrained() -> "MLPConfig":
        return MLPConfig(in_dim=880, n_classes=10)

    @staticmethod
    def digit_constrained() -> "MLPConfig":
        return MLPConfig(
            in_dim=880, n_classes=10, nonneg=True,
            dropout=(0.1, 0.1, 0.1, 0.0, 0.0),
        )

    @staticmethod
    def speaker_unconstrained() -> "MLPConfig":
        return MLPConfig(
            in_dim=2020, n_classes=20, batch_norm=False,
            dropout=(0.0,) * 5,
        )

    @staticmethod
    def speaker_constrained() -> "MLPConfig":
        return MLPConfig(
            in_dim=2020, n_classes=20, nonneg=True,
            dropout=(0.1, 0.1, 0.1, 0.0, 0.0),
        )

    @property
    def n_dense(self) -> int:
        return len(self.hidden) + 1


def init_mlp(cfg: MLPConfig, generator: torch.Generator,
             device=None) -> tuple[dict, dict]:
    """-> (params, state): glorot-uniform kernels, zero biases, BN gamma 1,
    beta 0, moving mean 0 and var 1. Draws come from `generator`, which must
    live on `device` (None: the CUDA device); they differ from JAX's for the
    same seed."""
    device = resolve_device(device)
    dims = (cfg.in_dim,) + tuple(cfg.hidden) + (cfg.n_classes,)
    layers, slayers = [], []
    for i in range(len(dims) - 1):
        fan_in, fan_out = dims[i], dims[i + 1]
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        u = torch.rand((fan_in, fan_out), generator=generator, device=device)
        p = {"w": u * (2 * limit) - limit,
             "b": torch.zeros(fan_out, device=device)}
        s = {}
        if i < len(cfg.hidden) and cfg.batch_norm:
            p["gamma"] = torch.ones(fan_out, device=device)
            p["beta"] = torch.zeros(fan_out, device=device)
            s["mean"] = torch.zeros(fan_out, device=device)
            s["var"] = torch.ones(fan_out, device=device)
        layers.append(p)
        slayers.append(s)
    return {"layers": layers}, {"layers": slayers}


def apply_mlp(
    cfg: MLPConfig,
    params: dict,
    state: dict,
    x: torch.Tensor,
    train: bool = False,
    generator: torch.Generator | None = None,
    weights: torch.Tensor | None = None,
    mesh=None,
    kinds=None,
    rows: tuple[int, int] | None = None,
) -> tuple[torch.Tensor, dict]:
    """Forward pass -> (logits, new_state).

    Order per hidden block is Dense -> ReLU -> BN -> Dropout, the Keras
    graph. Dropout runs in train mode when a `generator` is given.

    `weights` (train mode only): per-row weights for the BN batch moments,
    divided by sum(weights) + 1e-9, so rows of weight 0 drop out of the
    statistics exactly. None keeps plain mean/var.

    Under a `mesh` (parallel/mesh.py) `x` holds this rank's rows of a batch
    and `params`/`state` this rank's leaves:
      - the weighted moments' sums (sum w*h, sum w, then sum w*(h - mean)^2)
        go over the mesh's 'data' axis through a differentiable all-reduce,
        so they are the whole batch's and BN keeps its cross-rank gradient
        terms (`weights=None` means the batch is whole on every rank);
      - `kinds[i]` is Dense i's split over 'model': "rep" (whole), "col"
        (its output columns: outputs, bias and BN leaves are this rank's;
        Megatron's identity/all-reduce pair on its input) or "row" (its
        input rows: the partial products are summed over 'model');
      - `rows` = (lo, n): x[0] is row lo of an n-row batch, and each
        dropout mask is this rank's block of the (n, width) mask one device
        draws (rows past n keep every unit).
    """
    if x.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False  # fp32 GEMMs, never TF32
    if mesh is not None:
        from ..parallel.mesh import MODEL_AXIS, copy_to_axis, reduce_from_axis
    n_hidden = len(cfg.hidden)
    kinds = kinds or ("rep",) * cfg.n_dense
    new_slayers = []
    h = x
    if weights is not None:
        denom = data_sum(mesh, torch.sum(weights), grad=False) + 1e-9
    for i, p in enumerate(params["layers"]):
        if kinds[i] == "col":
            h = copy_to_axis(mesh, h, MODEL_AXIS)
        if cfg.compute_dtype == "bfloat16":
            h = (h.to(torch.bfloat16).float()
                 @ p["w"].to(torch.bfloat16).float())
        else:
            h = h @ p["w"]
        if kinds[i] == "row":
            h = reduce_from_axis(mesh, h, MODEL_AXIS)
        h = h + p["b"]
        if i == n_hidden:  # output layer: logits
            new_slayers.append(dict(state["layers"][i]))
            break
        h = torch.relu(h)
        s = state["layers"][i]
        if cfg.batch_norm:
            if train:
                if weights is not None:
                    mean = data_sum(
                        mesh, torch.sum(h * weights[:, None], 0)) / denom
                    var = data_sum(mesh, torch.sum(
                        ((h - mean) ** 2) * weights[:, None], 0)) / denom
                else:
                    mean = torch.mean(h, dim=0)
                    var = torch.var(h, dim=0, unbiased=False)
                m = cfg.bn_momentum
                new_slayers.append({"mean": s["mean"] * m + mean * (1 - m),
                                    "var": s["var"] * m + var * (1 - m)})
            else:
                mean, var = s["mean"], s["var"]
                new_slayers.append(dict(s))
            h = (h - mean) * torch.rsqrt(var + cfg.bn_eps)
            h = h * p["gamma"] + p["beta"]
        else:
            new_slayers.append(dict(s))
        rate = cfg.dropout[i] if i < len(cfg.dropout) else 0.0
        if train and rate > 0.0 and generator is not None:
            keep = 1.0 - rate
            mask = _keep_mask(h, generator, keep, rows, mesh,
                              kinds[i] == "col")
            h = torch.where(mask, h / keep, 0.0)
    return h, {"layers": new_slayers}


def data_sum(mesh, t: torch.Tensor, grad: bool = True) -> torch.Tensor:
    """`t` summed over the 'data' ranks of `mesh` (`t` itself without a
    mesh). With `grad` the sum is differentiable: its backward sums the
    gradient over the same ranks."""
    if mesh is None:
        return t
    from ..parallel.mesh import all_reduce_sum, reduce_sum

    return all_reduce_sum(mesh, t) if grad else reduce_sum(mesh, t)


def _keep_mask(h, generator, keep, rows, mesh, col):
    """The dropout keep-mask of `h`: drawn on h's shape, or, with `rows` =
    (lo, n), this rank's block of the (n, width) mask one device draws
    (`col`: this rank's columns of it over 'model')."""
    lo, n = rows if rows is not None else (0, h.shape[0])
    if (lo, n) == (0, h.shape[0]) and not col:  # the whole batch is here
        return torch.rand(h.shape, generator=generator, device=h.device) < keep
    from ..parallel.mesh import MODEL_AXIS

    width = h.shape[1] * (mesh.shape[MODEL_AXIS] if col else 1)
    full = torch.rand((n, width), generator=generator, device=h.device) < keep
    if col:
        c = mesh.coords[MODEL_AXIS] * h.shape[1]
        full = full[:, c: c + h.shape[1]]
    mask = torch.ones(h.shape, dtype=torch.bool, device=h.device)
    take = max(0, min(h.shape[0], n - lo))
    mask[:take] = full[lo: lo + take]
    return mask


def predict_probs(cfg: MLPConfig, params: dict, state: dict,
                  x: torch.Tensor) -> torch.Tensor:
    """Softmax probabilities in eval mode — `model.predict` equivalent."""
    logits, _ = apply_mlp(cfg, params, state, x, train=False)
    return torch.softmax(logits, dim=-1)


def dense_kernels(params: dict) -> list[torch.Tensor]:
    """The Dense kernels W_1..W_m in forward order: the list the constraint
    engine works on."""
    return [p["w"] for p in params["layers"]]


def set_dense_kernels(params: dict, ws: list[torch.Tensor]) -> dict:
    """A new params dict with every Dense kernel replaced; the other leaves
    are shared with `params`."""
    layers = [dict(p, w=w) for p, w in zip(params["layers"], ws)]
    return dict(params, layers=layers)
