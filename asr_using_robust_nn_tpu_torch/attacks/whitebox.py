"""White-box attacks on tensors: FGSM, PGD, JSMA, Carlini-Wagner L2 / L-inf.

Counterpart of the JAX package's `attacks/whitebox.py` (the reference drives
these through ART's classifier wrappers, `Voice digit recogniton/attacks.py:
493-693`). Every attack is autograd over the model's logits: no kernel of
its own, the MLP's GEMMs on the tensors' device.

An attack takes `logits_fn(x) -> logits` (a batched closure over trained
params, e.g. `lambda x: apply_mlp(cfg, params, state, x)[0]`), the clean
inputs and the integer labels, and returns adversarial inputs of the same
shape and dtype. `logits_fn` must be row-separable (an eval-mode MLP is):
JSMA's Jacobian and the C&W candidate ladder run many rows through it in
one widened call.

Parity notes:
 - fgsm/pgd follow ART: the sign of the CE gradient; PGD's defaults are
   eps_step 0.1, max_iter 100, no random init, L-inf projection.
 - jsma is Papernot's feature-pair saliency attack (theta, gamma as at
   `attacks.py:546`); with no targets it draws random ones as ART does.
 - carlini_l2: tanh reparameterization and a binary search over c with
   ART's budgets; optimizer "art" (the default) is ART's per-sample
   lr-halving/doubling line search as one widened ladder, "adam" the
   C&W-paper Adam loop.
 - carlini_linf: the penalty form with a shrinking tau; Adam by default,
   re-initialized at every tau step.
The Adam here is a few lines of its own (b1 0.9, b2 0.999, eps 1e-8,
bias-corrected, eps_root 0), not torch.optim.Adam, so that each tau step
starts from a fresh state by construction.
"""

from __future__ import annotations

import torch

__all__ = ["fgsm", "pgd", "jsma", "carlini_l2", "carlini_linf"]

# dense pair scores are built for at most this many (sample, p, q) entries
# at once; JSMA splits its active samples into chunks that fit
_PAIR_CHUNK = 1 << 24


def _ce(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Summed cross-entropy of integer labels."""
    logp = torch.log_softmax(logits, -1)
    return -torch.gather(logp, -1, y[:, None].long()).sum()


def _grad_ce(logits_fn, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    xx = x.detach().clone().requires_grad_(True)
    with torch.enable_grad():
        (g,) = torch.autograd.grad(_ce(logits_fn(xx), y), xx)
    return g


def fgsm(logits_fn, x: torch.Tensor, y: torch.Tensor,
         eps: float) -> torch.Tensor:
    """x + eps * sign(grad_x CE): ART's FastGradientMethod, untargeted, no
    clip. sign(0) = 0, as in JAX."""
    return (x + eps * torch.sign(_grad_ce(logits_fn, x, y))).detach()


def pgd(logits_fn, x: torch.Tensor, y: torch.Tensor, eps: float,
        eps_step: float = 0.1, max_iter: int = 100) -> torch.Tensor:
    """Projected gradient descent in the L-inf ball of radius eps around x
    (ART ProjectedGradientDescent defaults, `attacks.py:647-661`): max_iter
    signed steps of eps_step from x itself, each projected back as
    x + clip(xa - x, -eps, eps). With these defaults the iterate moves at
    most eps_step * max_iter = 10, so the reference's eps grid saturates
    above 10 by construction."""
    x = x.detach()
    xa = x
    for _ in range(max_iter):
        xa = xa + eps_step * torch.sign(_grad_ce(logits_fn, xa, y))
        xa = x + torch.clamp(xa - x, -eps, eps)
    return xa


# -- JSMA -------------------------------------------------------------------------

def _as_batch(*ts):
    return tuple(t[None] for t in ts)


def _top_k(v: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries of each row, equal values in index
    order (a stable descending sort, as lax.top_k orders them)."""
    return torch.sort(v, dim=-1, descending=True, stable=True)[1][..., :k]


def _jsma_select_pair(alpha, beta, search, k_cand):
    """-> (p, q, any_valid): argmax of the Papernot pair saliency
    S(p,q) = -(a_p+a_q)*(b_p+b_q) over valid pairs (a_sum > 0, b_sum < 0,
    p != q, both in `search`), the first maximum in row-major order. Exact
    over all pairs when k_cand is None, else over the union of the top-k by
    alpha and the top-k by -beta (the ends of the (alpha, -beta) Pareto
    front; it may miss pairs strictly inside it). Takes one sample's (n,)
    vectors or a batch (S, n) of them."""
    single = alpha.dim() == 1
    if single:
        alpha, beta, search = _as_batch(alpha, beta, search)
    s, n = alpha.shape
    if k_cand is None:
        cand = torch.arange(n, device=alpha.device).expand(s, n)
    else:
        a_m = torch.where(search, alpha, -torch.inf)
        c_m = torch.where(search, -beta, -torch.inf)
        cand = torch.cat([_top_k(a_m, k_cand), _top_k(c_m, k_cand)], 1)
    ac, bc = torch.gather(alpha, 1, cand), torch.gather(beta, 1, cand)
    sc = torch.gather(search, 1, cand)
    a_pair = ac[:, :, None] + ac[:, None, :]
    b_pair = bc[:, :, None] + bc[:, None, :]
    valid = ((a_pair > 0) & (b_pair < 0) & sc[:, :, None] & sc[:, None, :]
             & (cand[:, :, None] != cand[:, None, :]))
    score = torch.where(valid, -a_pair * b_pair, -torch.inf).reshape(s, -1)
    flat = torch.argmax(score, dim=1)
    any_valid = torch.isfinite(torch.gather(score, 1, flat[:, None])[:, 0])
    m = cand.shape[1]
    p = torch.gather(cand, 1, (flat // m)[:, None])[:, 0]
    q = torch.gather(cand, 1, (flat % m)[:, None])[:, 0]
    if single:
        return p[0], q[0], any_valid[0]
    return p, q, any_valid


def _jsma_select_pair_tiled(alpha, beta, search, tile: int = 128):
    """The exact pair argmax without the (n, n) matrix: row tiles of
    (tile, n) scores, the running best carried across them. Equal to
    `_jsma_select_pair(..., None)` including its tie-breaking: argmax takes
    the first maximum inside a tile, and across tiles only a strictly
    greater score replaces the carried best. Takes (n,) or (S, n)."""
    single = alpha.dim() == 1
    if single:
        alpha, beta, search = _as_batch(alpha, beta, search)
    s, n = alpha.shape
    pad = -(-n // tile) * tile - n
    a = torch.nn.functional.pad(alpha, (0, pad))
    b = torch.nn.functional.pad(beta, (0, pad))
    srch = torch.nn.functional.pad(search, (0, pad))  # False: never valid
    n_pad = n + pad
    idx = torch.arange(n_pad, device=alpha.device)
    best = torch.full((s,), -torch.inf, device=alpha.device)
    best_p = torch.zeros((s,), dtype=torch.int64, device=alpha.device)
    best_q = torch.zeros_like(best_p)
    for start in range(0, n_pad, tile):
        ap, bp = a[:, start:start + tile], b[:, start:start + tile]
        sp = srch[:, start:start + tile]
        pi = idx[start:start + tile]
        a_pair = ap[:, :, None] + a[:, None, :]
        b_pair = bp[:, :, None] + b[:, None, :]
        valid = ((a_pair > 0) & (b_pair < 0) & sp[:, :, None]
                 & srch[:, None, :] & (pi[:, None] != idx[None, :]))
        score = torch.where(valid, -a_pair * b_pair,
                            -torch.inf).reshape(s, -1)
        flat = torch.argmax(score, dim=1)
        sc = torch.gather(score, 1, flat[:, None])[:, 0]
        better = sc > best
        best = torch.where(better, sc, best)
        best_p = torch.where(better, pi[flat // n_pad], best_p)
        best_q = torch.where(better, idx[flat % n_pad], best_q)
    ok = torch.isfinite(best)
    if single:
        return best_p[0], best_q[0], ok[0]
    return best_p, best_q, ok


def _jacobian(logits_fn, x: torch.Tensor, n_classes: int) -> torch.Tensor:
    """(B, n) -> (B, C, n): d logits_c / d x per row, as one forward and one
    backward of C copies of the batch, copy c with the one-hot cotangent of
    class c (what jacrev computes row by row)."""
    b = x.shape[0]
    xx = x.detach().repeat(n_classes, 1).requires_grad_(True)
    cls = torch.arange(n_classes, device=x.device).repeat_interleave(b)
    cot = torch.nn.functional.one_hot(cls, n_classes).to(x.dtype)
    with torch.enable_grad():
        (g,) = torch.autograd.grad((logits_fn(xx) * cot).sum(), xx)
    return g.reshape(n_classes, b, -1).transpose(0, 1)


def jsma(logits_fn, x: torch.Tensor, targets=None, theta: float = 10.0,
         gamma: float = 0.1, generator: torch.Generator | None = None,
         clip=None, max_iter: int | None = None,
         k_candidates: int | None = None) -> torch.Tensor:
    """Jacobian Saliency Map Attack with feature pairs (SaliencyMapMethod,
    theta 10, gamma 0.1 at `attacks.py:546`). Targeted; `targets=None` draws
    random targets (pred + randint[1, n_classes)) % n_classes from
    `generator` (None: seed 0 on x's device), ART's behavior when no labels
    are given.

    Search space as in ART: a feature leaves the candidate set only when
    clipping pins it at the bound (for theta > 0 at clip[1]); with
    clip=None features may be picked and bumped again. The budget counts
    distinct modified features, budget = max(2, int(gamma * n)); a sample
    is done when it reaches its target, finds no valid pair, or has
    modified more than `budget` features, and takes no update after that.
    `max_iter` (default max(2 budget, 8)) caps the loop.

    Pair selection is exact by default: the dense (n, n) argmax for
    n <= 1024 (the 880-dim digit task), the tiled one above (the 2020-dim
    speaker task). An explicit k_candidates < n opts into the top-k
    heuristic; k_candidates >= n is the exact dense search."""
    x = x.detach()
    b, n_feat = x.shape
    with torch.no_grad():
        logits0 = logits_fn(x)
    n_classes = logits0.shape[-1]
    if targets is None:
        if generator is None:
            generator = torch.Generator(device=x.device).manual_seed(0)
        shift = torch.randint(1, n_classes, (b,), generator=generator,
                              device=x.device)
        targets = (torch.argmax(logits0, -1) + shift) % n_classes
    targets = torch.as_tensor(targets, device=x.device).long()
    budget = max(2, int(gamma * n_feat))
    if max_iter is None:
        max_iter = max(2 * budget, 8)
    if k_candidates is None or k_candidates >= n_feat:
        k_cand = None
    else:
        k_cand = k_candidates
    tiled = k_cand is None and n_feat > 1024
    m = n_feat if k_cand is None else 2 * k_cand
    chunk = max(1, _PAIR_CHUNK // (128 * n_feat if tiled else m * m))

    def select(alpha, beta, search):
        outs = [(_jsma_select_pair_tiled(alpha[i:i + chunk],
                                         beta[i:i + chunk],
                                         search[i:i + chunk]) if tiled
                 else _jsma_select_pair(alpha[i:i + chunk],
                                        beta[i:i + chunk],
                                        search[i:i + chunk], k_cand))
                for i in range(0, alpha.shape[0], chunk)]
        return tuple(torch.cat(t) for t in zip(*outs))

    xa = x.clone()
    used = torch.zeros((b, n_feat), dtype=torch.bool, device=x.device)
    # ART drops features already at or past the bound from the search
    # domain up front, so a clipped no-op pair cannot use the budget
    if clip is None:
        search = torch.ones((b, n_feat), dtype=torch.bool, device=x.device)
    else:
        search = x < clip[1] if theta > 0 else x > clip[0]
    done = torch.zeros((b,), dtype=torch.bool, device=x.device)
    for _ in range(max_iter):
        act = torch.nonzero(~done)[:, 0]
        if act.numel() == 0:
            break
        xs, t, srch, usd = xa[act], targets[act], search[act], used[act]
        rows = torch.arange(act.numel(), device=x.device)
        jac = _jacobian(logits_fn, xs, n_classes)
        alpha = jac[rows, t]
        beta = jac.sum(dim=1) - alpha
        p, q, ok = select(alpha, beta, srch)
        xn = xs.clone()
        r_ok, p_ok, q_ok = rows[ok], p[ok], q[ok]
        xn[r_ok, p_ok] = xs[r_ok, p_ok] + theta
        xn[r_ok, q_ok] = xs[r_ok, q_ok] + theta
        if clip is not None:
            xn = torch.clamp(xn, clip[0], clip[1])
            at_bound = xn >= clip[1] if theta > 0 else xn <= clip[0]
            srch = srch & torch.where(ok[:, None], ~at_bound, True)
        usd[r_ok, p_ok] = True
        usd[r_ok, q_ok] = True
        with torch.no_grad():
            hit = torch.argmax(logits_fn(xn), -1) == t
        xa[act], search[act], used[act] = xn, srch, usd
        done[act] = hit | ~ok | (usd.sum(dim=1) > budget)
    return xa


# -- Carlini-Wagner -------------------------------------------------------------

def _cw_objective(logits, t, confidence, targeted):
    """f(x) from Carlini & Wagner: max(Z_t - max_other + conf, 0) when
    untargeted (push away from class t). `logits` may carry leading axes
    over the (B, C) batch."""
    onehot = torch.nn.functional.one_hot(t.long(), logits.shape[-1]).to(
        logits.dtype)
    z_t = torch.sum(logits * onehot, -1)
    z_other = torch.max(logits - onehot * 1e9, -1).values
    if targeted:
        return torch.clamp(z_other - z_t + confidence, min=0.0)
    return torch.clamp(z_t - z_other + confidence, min=0.0)


def _art_line_search_step(obj_per, w, lr, loss_now, direction, max_halving,
                          max_doubling):
    """One ART-semantics adaptive-lr update, per sample, over the whole
    candidate ladder lr * 2^k, k in [-(max_halving-1) .. max_doubling], as
    ONE widened evaluation: `obj_per` takes (K, B, D) and returns (K, B).

    Accept rule (ART's CarliniL2Method, sequential there): the halving walk
    lr, lr/2, ... stops at the first candidate that improves on loss_now;
    if lr itself improved, the doubling chain continues only while each
    doubling improves on its predecessor (and on loss_now); if nothing
    improves, w stays and the lr collapses by 2 ** max(max_halving, 1).
    Returns (w_new, lr_new)."""
    n_half = max(max_halving - 1, 0)
    ks = torch.arange(-n_half, max_doubling + 1, device=w.device,
                      dtype=torch.float32)
    cand_lr = lr[None, :] * (2.0 ** ks)[:, None]               # (K, B)
    wc = w[None] + cand_lr[..., None] * direction[None]        # (K, B, D)
    obj_c = obj_per(wc)                                        # (K, B)
    improved = obj_c < loss_now[None, :]
    i0 = n_half  # the unscaled lr's row
    base_ok = improved[i0]
    if max_doubling > 0:
        dbl = (obj_c[i0 + 1:] < obj_c[i0:-1]) & improved[i0 + 1:]
        n_dbl = torch.cumprod(dbl.to(torch.int64), dim=0).sum(dim=0)
    else:
        n_dbl = torch.zeros_like(lr, dtype=torch.int64)
    halv = torch.flip(improved[:i0 + 1], dims=(0,))            # lr, lr/2, ..
    first_halv = torch.argmax(halv.to(torch.int8), dim=0)
    pick = torch.where(base_ok, i0 + n_dbl, i0 - first_halv)
    accept = base_ok | halv.any(dim=0)
    bidx = torch.arange(w.shape[0], device=w.device)
    w_new = torch.where(accept[:, None], wc[pick, bidx], w)
    lr_new = torch.where(accept, cand_lr[pick, bidx],
                         lr / (2.0 ** max(max_halving, 1)))
    return w_new, lr_new


class _Adam:
    """Adam as optax.adam computes it: b1 0.9, b2 0.999, eps 1e-8, bias
    correction 1 - b**t in float32, eps_root 0; `step` returns the new
    parameters. A new instance is a fresh state."""

    def __init__(self, lr, like, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m = torch.zeros_like(like)
        self.v = torch.zeros_like(like)
        self.t = 0

    def step(self, w, g):
        self.t += 1
        self.m = (1 - self.b1) * g + self.b1 * self.m
        self.v = (1 - self.b2) * (g ** 2) + self.b2 * self.v
        # b ** t as powf of two float32s, as XLA computes it (an integer
        # exponent takes another rounding path)
        t = torch.tensor(float(self.t))
        m_hat = self.m / (1 - torch.tensor(self.b1) ** t).to(w.device)
        v_hat = self.v / (1 - torch.tensor(self.b2) ** t).to(w.device)
        return w + -self.lr * (m_hat / (torch.sqrt(v_hat) + self.eps))


def _value_and_grad(obj_per, w):
    """Per-sample objective (B,) and d sum(obj) / d w: the objective is
    row-separable, so one backward gives every sample's gradient."""
    ww = w.detach().requires_grad_(True)
    with torch.enable_grad():
        loss = obj_per(ww)
        (g,) = torch.autograd.grad(loss.sum(), ww)
    return loss.detach(), g


def _widened(logits_fn, xa):
    """logits of (..., B, D) inputs through one (N, D) call."""
    out = logits_fn(xa.reshape(-1, xa.shape[-1]))
    return out.reshape(*xa.shape[:-1], out.shape[-1])


def carlini_l2(logits_fn, x: torch.Tensor, y: torch.Tensor,
               confidence: float = 0.0, learning_rate: float = 0.01,
               binary_search_steps: int = 10, max_iter: int = 10,
               initial_const: float = 0.01, clip=None,
               optimizer: str = "art", max_halving: int = 5,
               max_doubling: int = 5) -> torch.Tensor:
    """Carlini & Wagner L2 (CarliniL2Method, `attacks.py:606-622`): minimize
    ||delta||^2 + c f(x + delta) in tanh space with a binary search over c
    per sample (c = (c_lo + c_hi) / 2 once an upper bound is known, else
    10 c). `clip=None` takes the min and max of the whole batch, as ART
    does without clip_values. optimizer "art" (default) is ART's adaptive
    lr line search (`_art_line_search_step`), "adam" the Adam loop."""
    x = x.detach()
    y = torch.as_tensor(y, device=x.device).long()
    b = x.shape[0]
    if clip is None:
        lo, hi = torch.min(x), torch.max(x)
    else:
        lo, hi = (torch.tensor(v, dtype=x.dtype, device=x.device)
                  for v in clip)
    span, mid = (hi - lo) / 2.0, (hi + lo) / 2.0
    x_c = torch.clamp(x, lo + 1e-6, hi - 1e-6)
    w0 = torch.arctanh((x_c - mid) / (span + 1e-9) * 0.999999)

    def to_x(w):
        return torch.tanh(w) * span + mid

    def obj_per(w, c):
        xa = to_x(w)
        l2 = torch.sum((xa - x) ** 2, dim=-1)
        f = _cw_objective(_widened(logits_fn, xa), y, confidence, False)
        return l2 + c * f

    def attack_at_c(c):
        best_x, best_l2 = x.clone(), torch.full((b,), torch.inf,
                                                device=x.device)
        w = w0
        lr = torch.full((b,), learning_rate, device=x.device)
        adam = _Adam(learning_rate, w0) if optimizer == "adam" else None
        for _ in range(max_iter):
            loss_now, g = _value_and_grad(lambda ww: obj_per(ww, c), w)
            with torch.no_grad():
                if adam is not None:
                    w = adam.step(w, g)
                else:
                    w, lr = _art_line_search_step(
                        lambda ww: obj_per(ww, c), w, lr, loss_now, -g,
                        max_halving, max_doubling)
                xa = to_x(w)
                f = _cw_objective(logits_fn(xa), y, confidence, False)
                l2 = torch.sum((xa - x) ** 2, dim=-1)
                better = (f <= 0.0) & (l2 < best_l2)
                best_x = torch.where(better[:, None], xa, best_x)
                best_l2 = torch.where(better, l2, best_l2)
        success = torch.isfinite(best_l2)
        return torch.where(success[:, None], best_x, to_x(w)), success

    c_lo = torch.zeros((b,), device=x.device)
    c_hi = torch.full((b,), 1e10, device=x.device)
    c = torch.full((b,), initial_const, device=x.device)
    best = x.clone()
    found = torch.zeros((b,), dtype=torch.bool, device=x.device)
    for _ in range(binary_search_steps):
        xa, success = attack_at_c(c)
        with torch.no_grad():
            better = (success & ~found) | (
                success & (torch.sum((xa - x) ** 2, -1)
                           < torch.sum((best - x) ** 2, -1)))
            best = torch.where(better[:, None], xa, best)
            found = found | success
            c_hi = torch.where(success, c, c_hi)
            c_lo = torch.where(success, c_lo, c)
            c = torch.where(c_hi < 1e9, (c_lo + c_hi) / 2.0, c * 10.0)
    return best


def carlini_linf(logits_fn, x: torch.Tensor, y: torch.Tensor,
                 confidence: float = 0.0, learning_rate: float = 0.01,
                 max_iter: int = 100, initial_tau: float | None = None,
                 tau_decrease: float = 0.9, tau_steps: int = 6,
                 const: float = 1.0, optimizer: str = "adam",
                 max_halving: int = 5, max_doubling: int = 5) -> torch.Tensor:
    """Carlini & Wagner L-inf (CarliniLInfMethod, `attacks.py:571-587`):
    minimize c f(x + delta) + sum(max(|delta| - tau, 0)) with tau shrinking
    geometrically from tau0 (default: a tenth of the whole batch's span).
    Each tau step runs max_iter optimizer steps on the carried delta, Adam
    re-initialized at every tau step; a sample succeeds at a tau when it is
    misclassified with max |delta| <= 1.01 tau, and the smallest successful
    perturbation is kept. Samples never found return x + the last delta.
    optimizer "art" swaps Adam for the line search."""
    x = x.detach()
    y = torch.as_tensor(y, device=x.device).long()
    b = x.shape[0]
    span = torch.max(x) - torch.min(x) + 1e-9
    tau = (torch.tensor(initial_tau, dtype=torch.float32, device=x.device)
           if initial_tau is not None else span / 10.0)

    def obj_per(d, tau):
        f = _cw_objective(_widened(logits_fn, x + d), y, confidence, False)
        excess = torch.clamp(torch.abs(d) - tau, min=0.0).sum(-1)
        return const * f + excess

    delta = torch.zeros_like(x)
    best = x.clone()
    best_linf = torch.full((b,), torch.inf, device=x.device)
    found = torch.zeros((b,), dtype=torch.bool, device=x.device)
    for _ in range(tau_steps):
        adam = _Adam(learning_rate, delta) if optimizer == "adam" else None
        lr = torch.full((b,), learning_rate, device=x.device)
        for _ in range(max_iter):
            loss_now, g = _value_and_grad(lambda dd: obj_per(dd, tau), delta)
            with torch.no_grad():
                if adam is not None:
                    delta = adam.step(delta, g)
                else:
                    delta, lr = _art_line_search_step(
                        lambda dd: obj_per(dd, tau), delta, lr, loss_now, -g,
                        max_halving, max_doubling)
        with torch.no_grad():
            xa = x + delta
            f = _cw_objective(logits_fn(xa), y, confidence, False)
            linf = torch.max(torch.abs(delta), -1).values
            success = (f <= 0.0) & (linf <= tau * 1.01)
            better = success & (linf < best_linf)
            best = torch.where(better[:, None], xa, best)
            best_linf = torch.where(better, linf, best_linf)
            found = found | success
            tau = tau * tau_decrease
    return torch.where(found[:, None], best, x + delta)
