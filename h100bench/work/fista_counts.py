"""The least work of one step's FISTA projection (K7), from the widths alone:
the work of a step whose projection exits at its first layer's first
iteration, which no step can do without. The fp32 masters are read once
(the suffix chain needs every layer above the first); the suffix chain
A_0^T = W_1 ... W_m A_m^T runs once; and the first layer's n-row chain
t^T = W_0 A_0^T runs once, 2 flop a multiply-add in fp32. Under NonNeg the
first iteration's dual is zero, so w = W and nothing need be written: the
masters' write-back, the bf16 copies (which another kernel of the step could
refresh), later layers and iterations, the power-iteration rounds for
||B_i||_2 and the n x n eigenproblems are not counted. So whatever exits
fire, no kernel that does the projection can take less time than this
bound."""

from __future__ import annotations

from .counts import links


def k7_work(dims) -> tuple[float, dict]:
    """(bytes, ops) of one projection of the stack `dims` (n = dims[-1])."""
    n = dims[-1]
    ln = links(dims)
    flop = 2 * n * (sum(ln[1:]) + ln[0])
    return sum(ln) * 4, {"fp32": flop}
