"""The plain reference's model: the thesis MLP's forward pass and its
constrained training step, in plain PyTorch at float32 (TF32 off).

    Dense -> ReLU -> BatchNorm -> Dropout per hidden block, a Dense head;
    categorical cross-entropy from logits over the real rows of a batch;
    Adam (b1 0.9, b2 0.999, eps 1e-7, bias-corrected: optax's form);
    NonNeg (w <- max(w, 0)) on every Dense kernel after the update;
    simple_norm: sigma = ||W_m^T ... W_1^T||_2 by `n_iter` rounds of power
    iteration from a persistent vector, then w_i <- w_i f_i with
    f_i = (rho / sigma)^(1/m) and sigma <- sigma f_i, layer by layer.

BatchNorm in training uses the batch's biased moments over its real rows and
moves its running statistics with momentum 0.99; in evaluation it uses the
running statistics. Dropout is inverted dropout whose keep-mask is the
trainer's documented counter hash of (step seed, layer, row, column), drawn
again here from the same seeds, so that both sides drop the same units.

`prec` selects the precision of every matrix product (the controls):
"fp32" (TF32 off), "tf32", or "fp8" (both operands rounded to float8 e4m3
under a per-tensor scale). Nothing here imports the program.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

__all__ = ["Model", "forward", "probs", "keep_mask", "derived_generator",
           "glorot_init", "train_epochs", "precision"]

_M32 = 0xFFFFFFFF
_PI_EPS = float(np.spacing(1.0))


@contextlib.contextmanager
def precision(prec: str):
    """CUDA fp32 matmuls with TF32 only for prec == "tf32"; restored after."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = prec == "tf32"
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """`t` rounded to float8 e4m3 under a per-tensor scale (amax -> 448);
    the backward passes the gradient straight through the rounding, so the
    backward products run on the rounded operands too."""
    s = torch.clamp(t.detach().abs().max(), min=1e-30) / 448.0
    q = (t.detach() / s).to(torch.float8_e4m3fn).float() * s
    return t + (q - t.detach())


def mm(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    if prec == "fp8":
        return _fp8(a) @ _fp8(b)
    return a @ b


class Model:
    """The model's sizes and switches, from a configuration file's
    `model` block."""

    def __init__(self, m: dict):
        self.dims = tuple(m["dims"])
        self.nonneg = bool(m["nonneg"])
        self.batch_norm = bool(m["batch_norm"])
        self.dropout = tuple(m["dropout"])
        self.bn_eps = float(m["bn_eps"])
        self.bn_momentum = float(m["bn_momentum"])

    @property
    def n_layers(self) -> int:
        return len(self.dims) - 1


def forward(model: Model, params: list, state: list, x: torch.Tensor,
            prec: str = "fp32") -> torch.Tensor:
    """Evaluation-mode logits: BatchNorm from the running statistics, no
    dropout. `params[i]` = {"w", "b", and "gamma", "beta" on hidden layers};
    `state[i]` = {"mean", "var"}."""
    h = x
    for i, p in enumerate(params):
        h = mm(h, p["w"], prec) + p["b"]
        if i == model.n_layers - 1:
            return h
        h = torch.relu(h)
        if model.batch_norm:
            s = state[i]
            h = (h - s["mean"]) * torch.rsqrt(s["var"] + model.bn_eps)
            h = h * p["gamma"] + p["beta"]
    return h


def probs(model, params, state, x, prec="fp32") -> torch.Tensor:
    with precision(prec):
        return torch.softmax(forward(model, params, state, x, prec), -1)


def derived_generator(device, *words) -> torch.Generator:
    """A torch.Generator on `device` seeded from integer words by numpy's
    SeedSequence: the trainer's documented derivation of its shuffle and
    dropout generators from its seed."""
    seed = int(np.random.SeedSequence(list(words)).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(seed)


def _mul32(x, c):
    return ((x & 0xFFFF) * c + ((((x >> 16) * c) & 0xFFFF) << 16)) & _M32


def _mix32(x):
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def keep_mask(seed: int, layer: int, rows: int, cols: int, keep: float,
              device) -> torch.Tensor:
    """(rows, cols) bool keep-mask of one step's layer: h = mix32((row * cols
    + col) ^ mix32(seed + layer)), kept iff (h >> 8) 2^-24 < keep."""
    key = _mix32(torch.tensor((int(seed) + layer) & _M32, device=device))
    idx = (torch.arange(rows, device=device)[:, None] * cols
           + torch.arange(cols, device=device)[None, :])
    u = (_mix32(idx ^ key) >> 8).float() * (1.0 / (1 << 24))
    return u < torch.tensor(keep, dtype=torch.float32, device=device)


def glorot_init(dims, batch_norm: bool, generator) -> tuple[list, list]:
    """Keras' initial state from one generator, drawn layer by layer:
    glorot-uniform kernels u (2 l) - l, l = sqrt(6 / (fan_in + fan_out)),
    from one uniform draw each; zero biases; BN gamma 1, beta 0, running
    mean 0 and variance 1."""
    dev = generator.device
    params, state = [], []
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        limit = np.sqrt(6.0 / (a + b))
        u = torch.rand((a, b), generator=generator, device=dev)
        p = {"w": u * (2 * limit) - limit, "b": torch.zeros(b, device=dev)}
        s = {}
        if batch_norm and i < len(dims) - 2:
            p["gamma"] = torch.ones(b, device=dev)
            p["beta"] = torch.zeros(b, device=dev)
            s = {"mean": torch.zeros(b, device=dev),
                 "var": torch.ones(b, device=dev)}
        params.append(p)
        state.append(s)
    return params, state


def _train_forward(model, params, state, x, masks, prec):
    """Training-mode logits and the batch moments of each hidden layer."""
    h, moments = x, []
    for i, p in enumerate(params):
        h = mm(h, p["w"], prec) + p["b"]
        if i == model.n_layers - 1:
            return h, moments
        h = torch.relu(h)
        if model.batch_norm:
            mean = h.mean(0)
            var = ((h - mean) ** 2).mean(0)
            moments.append((mean.detach(), var.detach()))
            h = (h - mean) * torch.rsqrt(var + model.bn_eps)
            h = h * p["gamma"] + p["beta"]
        if masks[i] is not None:
            keep = 1.0 - model.dropout[i]
            h = torch.where(masks[i], h / keep, 0.0)
    return h, moments


def _power_iteration(ws, u, n_iter, prec):
    def nrm(v):
        return v / (torch.sqrt(torch.sum(v * v)) + _PI_EPS)

    def apply(x):  # W_1 ... W_m x
        for w in reversed(ws):
            x = mm(w, x[:, None], prec)[:, 0]
        return x

    def apply_t(x):  # W_m^T ... W_1^T x
        for w in ws:
            x = mm(w.T, x[:, None], prec)[:, 0]
        return x

    u = nrm(u)
    for _ in range(n_iter):
        u = nrm(apply_t(nrm(apply(u))))
    v = nrm(apply(u))
    return torch.sum(u * apply_t(v)), u


def _val_loss(model, params, state, x, y, prec, block=1024):
    total = 0.0
    for i in range(0, x.shape[0], block):
        logits = forward(model, params, state, x[i:i + block], prec)
        total += float(torch.nn.functional.cross_entropy(
            logits, y[i:i + block], reduction="sum"))
    return total / x.shape[0]


def train_epochs(model: Model, params: list, state: list, x, y, vx, vy, *,
                 batch: int, epochs: int, lr: float, rho: float | None,
                 n_iter: int, seed: int, prec: str = "fp32",
                 fault: str | None = None, draws: str = "fused") -> dict:
    """`epochs` epochs of the constrained recipe from (params, state) on the
    device-resident split (x, y), with the validation loss on (vx, vy)
    after each.

    The trainer's order, drawn again here: one permutation of the real rows
    from its shuffle generator (words seed, 1, 0), kept for every epoch;
    per epoch, int32 step seeds from its dropout generator (words seed, 2,
    epoch); the real rows of a batch at its first positions (a step runs on
    batch rows padded to a multiple of 64 and layer widths padded to a
    multiple of 128, which index the hash; padding never counts). The power
    iteration's vector starts from a normal draw of the padded output width
    (a generator on the device seeded 23), of which the real columns count.
    That is the fused epoch's draw (`draws="fused"`). The plain autograd
    epoch (`draws="plain"`) draws each dropout mask as uniforms of the
    (batch, width) layer from the step's generator, layer by layer and step
    by step, and starts the vector from a normal draw of the output width.

    `fault` plants a fault in this program when it stands in the program's
    place (the harness's test of its own check): "half_batch" trains each
    step on the first half of its rows.

    -> {"loss", "val_loss": per epoch; "params", "state": after the last
    epoch; "mu": Adam's first moments then; "g1": the first step's
    gradients}."""
    dev = x.device
    n = x.shape[0]
    rows_run = -(-batch // 64) * 64
    keep = [1.0 - r for r in model.dropout]
    p = [{k: v.detach().clone() for k, v in layer.items()} for layer in params]
    st = [{k: v.detach().clone() for k, v in layer.items()} for layer in state]
    mu = [{k: torch.zeros_like(v) for k, v in layer.items()} for layer in p]
    nu = [{k: torch.zeros_like(v) for k, v in layer.items()} for layer in p]
    n_out = model.dims[-1]
    fused = draws == "fused"
    u = torch.randn((1, -(-n_out // 128) * 128 if fused else n_out),
                    device=dev,
                    generator=torch.Generator(device=dev).manual_seed(23))
    u = u[0, :n_out].clone()
    perm = torch.randperm(n, generator=derived_generator(dev, seed, 1, 0),
                          device=dev)
    n_batches = -(-n // batch)
    count = 0
    losses, val_losses = [], []
    with precision(prec):
        for epoch in range(epochs):
            drop_gen = derived_generator(dev, seed, 2, epoch)
            if fused:
                seeds = torch.randint(0, 2 ** 31 - 1, (n_batches,),
                                      dtype=torch.int32, device=dev,
                                      generator=drop_gen).tolist()
            ep_loss = torch.zeros((), dtype=torch.float64, device=dev)
            for s in range(n_batches):
                full = perm[s * batch:(s + 1) * batch]
                idx = full
                if fault == "half_batch":
                    idx = full[: max(1, full.shape[0] // 2)]
                rows = idx.shape[0]
                drop = [i < len(keep) and keep[i] < 1.0
                        for i in range(model.n_layers - 1)]
                if fused:
                    masks = [keep_mask(seeds[s], i, rows_run,
                                       -(-model.dims[i + 1] // 128) * 128,
                                       keep[i], dev)[:rows, :model.dims[i + 1]]
                             if d else None for i, d in enumerate(drop)]
                else:
                    masks = [torch.rand((batch, model.dims[i + 1]),
                                        generator=drop_gen, device=dev)[:rows]
                             < keep[i] if d else None
                             for i, d in enumerate(drop)]
                leaves = [t.requires_grad_(True) for layer in p
                          for t in layer.values()]
                with torch.enable_grad():
                    logits, moments = _train_forward(model, p, st, x[idx],
                                                     masks, prec)
                    loss = torch.nn.functional.cross_entropy(logits, y[idx])
                    grads = torch.autograd.grad(loss, leaves)
                ep_loss += loss.detach().double() * full.shape[0]
                count += 1
                if count == 1:
                    g_it = iter(grads)
                    g1 = [{k: next(g_it).detach().clone() for k in layer}
                          for layer in p]
                bc1, bc2 = 1.0 - 0.9 ** count, 1.0 - 0.999 ** count
                g_it = iter(grads)
                with torch.no_grad():
                    for i, layer in enumerate(p):
                        for k in layer:
                            g = next(g_it)
                            m = mu[i][k].mul_(0.9).add_(0.1 * g)
                            v = nu[i][k].mul_(0.999).add_(0.001 * g * g)
                            upd = (m / bc1) / (torch.sqrt(v / bc2) + 1e-7)
                            layer[k] = layer[k].detach() - lr * upd
                        if model.nonneg:
                            layer["w"] = torch.clamp_min(layer["w"], 0.0)
                    for i, (mean, var) in enumerate(moments):
                        mom = model.bn_momentum
                        st[i]["mean"] = mom * st[i]["mean"] + (1 - mom) * mean
                        st[i]["var"] = mom * st[i]["var"] + (1 - mom) * var
                    if rho is not None:
                        ws = [layer["w"] for layer in p]
                        sigma, u = _power_iteration(ws, u, n_iter, prec)
                        m_l = model.n_layers
                        for layer in p:
                            f = (rho / (sigma + _PI_EPS)) ** (1.0 / m_l)
                            layer["w"] = layer["w"] * f
                            sigma = sigma * f
            losses.append(float(ep_loss) / n)
            with torch.no_grad():
                val_losses.append(_val_loss(model, p, st, vx, vy, prec))
    detach = lambda tree: [{k: v.detach() for k, v in layer.items()}  # noqa
                           for layer in tree]
    return {"loss": losses, "val_loss": val_losses, "params": detach(p),
            "state": detach(st), "mu": detach(mu), "g1": g1}
