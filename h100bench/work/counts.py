"""The benchmark's frozen arithmetic: the H100's peaks, the least time a piece
of work can take on it, and the operations and bytes of each measured piece
of work, from shapes alone.

Nothing here reads the program: a count is a function of the configuration's
published widths and the request or batch sizes, so the same work gets the
same bound whatever code implements it.
"""

from __future__ import annotations

import math

from ..reference.frontend_ref import mel_filterbank, num_frames

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at the 700 W
# power limit. fp32 and fp64 are the rates outside the tensor cores.
H100_BYTES_PER_S = 3.35e12
H100_OPS_PER_S = {"fp64": 34e12, "fp32": 67e12, "tf32": 495e12,
                  "bf16": 989e12, "fp8": 1979e12, "int8": 1979e12}


def bound_ms(n_bytes: float, ops: dict) -> tuple[float, str]:
    """The least time for `n_bytes` moved (each input read once, each output
    written once) and `ops` = {type: count}: the larger of the bytes over
    the memory rate and the operations over their peak rates. -> (ms,
    "bytes" or "operations", whichever bounds it)."""
    t_bytes = n_bytes / H100_BYTES_PER_S
    t_ops = sum(n / H100_OPS_PER_S[k] for k, n in ops.items())
    return max(t_bytes, t_ops) * 1e3, \
        "bytes" if t_bytes >= t_ops else "operations"


def bound_s(n_bytes: float, ops: dict) -> float:
    """`bound_ms` in seconds."""
    return bound_ms(n_bytes, ops)[0] * 1e-3


def links(dims) -> list[int]:
    """d_i * d_(i+1) for each Dense layer of the stack `dims`."""
    return [a * b for a, b in zip(dims[:-1], dims[1:])]


def forward_flop(dims) -> int:
    """Operations of one row's forward pass: 2 * sum d_i d_(i+1)."""
    return 2 * sum(links(dims))


def step_flop(rows: int, dims) -> int:
    """Model operations of a training step on `rows` rows: the forward, dW
    (as much again) and dX for every layer but the first, 2 flop a
    multiply-add. Neither the projection nor BatchNorm counts as model
    work."""
    ln = links(dims)
    return 2 * rows * (2 * sum(ln) + sum(ln[1:]))


def pad_to(n: int, m: int) -> int:
    return -(-n // m) * m


def k3_epoch_work(dims, batch: int, n_batches: int) -> tuple[float, dict]:
    """(bytes, ops) of one fused epoch: the model operations of its padded
    rows at bf16, and its inputs read once and outputs written once: the
    gathered batches (fp32 features at the padded width, int32 labels, fp32
    row weights) and the packed state read and written (fp32 masters and
    both Adam moments, bf16 copies, the small per-layer vectors)."""
    rows_run = pad_to(batch, 64)
    pd = [pad_to(d, 128) for d in dims]
    rows = n_batches * rows_run
    data = rows * (pd[0] * 4 + 4 + 4)
    weights = sum(links(pd))
    small = 11 * (len(dims) - 1) * max(pd[1:]) * 4
    state = weights * (4 + 4 + 4 + 2) + small
    return data + 2 * state, {"bf16": step_flop(rows, dims)}


def k2_work(dims, n_iter: int, fused: bool = True) -> tuple[float, dict]:
    """(bytes, ops) of one projection: 2 n_iter + 2 chained passes through
    the stack (each round a product and its transpose, then the final pair),
    each 2 * sum d_i d_(i+1) flop summed in fp32 outside the tensor cores.
    In the fused epoch (`fused`) the bf16 kernels are read once, and the
    rescale in the same launch reads and writes the fp32 masters and writes
    the bf16 copies once; in the plain path the fp32 kernels are read once
    and the rescale runs outside the launch."""
    w = sum(links(dims))
    n_bytes = w * (2 + 4 + 4 + 2) if fused else w * 4
    return n_bytes, {"fp32": (2 * n_iter + 2) * 2 * w}


def frontend_work(fe: dict, batch: int) -> tuple[float, dict]:
    """(bytes, ops) of one waves -> mel-power call on `batch` rows of `width`
    fp32 samples, one fixed work per preset whatever body runs: the waves
    read once, the fp32 mel written once; per frame the Hann window (n_fft
    products), a real FFT of n_fft points (2.5 n log2 n operations, half the
    5 n log2 n of a complex one), |X|^2 (3 a bin), counted in fp64; and the
    mel product, one multiply-add per nonzero filterbank weight, in fp32."""
    n = fe["n_fft"]
    frames = batch * num_frames(fe["width"], fe["hop_length"], n)
    n_freq = n // 2 + 1
    nnz = int((mel_filterbank(fe["sr"], n, fe["n_mels"]) != 0).sum())
    fp64 = frames * (n + 2.5 * n * math.log2(n) + 3 * n_freq)
    fp32 = frames * 2 * nnz
    n_bytes = batch * fe["width"] * 4 + frames * fe["n_mels"] * 4
    return n_bytes, {"fp64": fp64, "fp32": fp32}
