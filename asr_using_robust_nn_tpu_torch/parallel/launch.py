"""Start a world of ranks on this host and collect what each returns.

`run_ranks(fn, world, backend, device)` spawns `world` processes (the
`spawn` start method: a child imports torch and the module of `fn`, nothing
of its parent), joins each to one process group through
`maybe_init_distributed`, calls `fn(*args)` in every rank and returns the
results in rank order. A rank that raises fails the call with its
traceback; a world that does not finish within `timeout` seconds is killed,
every rank of it, and the call raises TimeoutError. `fn` and its results
travel by pickle: a module-level function, and numpy or plain values back.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import socket
import time
import traceback

__all__ = ["run_ranks", "free_port"]


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free when asked."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world, port, backend, device, args, out, threads):
    os.environ.update({"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                       "WORLD_SIZE": str(world), "RANK": str(rank),
                       "LOCAL_RANK": str(rank)})
    try:
        import torch
        import torch.distributed as dist

        from .mesh import maybe_init_distributed

        if threads:
            torch.set_num_threads(threads)
        maybe_init_distributed(backend=backend, device=device)
        try:
            res = fn(*args)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, res))
    except BaseException:  # reported to the parent, which raises
        out.put((rank, False, traceback.format_exc()))


def run_ranks(fn, world: int, backend: str = "gloo", device="cpu",
              args: tuple = (), timeout: float = 300.0,
              threads: int | None = 1) -> list:
    """-> [fn(*args) of rank 0, ..., of rank world-1]. `backend` names the
    process group's backend ("gloo", or "nccl" with one card a rank);
    `device` is what each rank's `maybe_init_distributed` is told the rank
    computes on. `threads`: torch threads per rank (None: torch's
    default)."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world, port, backend, device, args, out,
                               threads))
             for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) + len(errors) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"run_ranks: {world - len(results) - len(errors)} of "
                    f"{world} ranks did not finish within {timeout} s "
                    f"(finished: {sorted(results)}, failed: "
                    f"{sorted(errors)})")
            try:
                rank, ok, val = out.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0)
                        and r not in results and r not in errors]
                if dead:  # a rank that died without reporting
                    raise RuntimeError(
                        f"run_ranks: rank(s) {dead} exited with codes "
                        f"{[procs[r].exitcode for r in dead]}")
                continue
            (results if ok else errors)[rank] = val
            if errors:
                break
    finally:
        for p in procs:
            if p.is_alive() and (errors or len(results) < world):
                p.kill()
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=30)
    if errors:
        r = min(errors)
        raise RuntimeError(f"run_ranks: rank {r} of {world} failed:\n"
                           f"{errors[r]}")
    return [results[r] for r in range(world)]
