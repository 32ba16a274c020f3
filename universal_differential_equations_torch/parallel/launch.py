"""Run a function on n gloo ranks on the CPU of one host.

The multi-rank tests and :func:`.dryrun.dryrun_multichip` run their ranks
through :func:`spawn`: ``torch.multiprocessing`` starts ``n`` processes (the
``spawn`` start method), which join one gloo group over a ``FileStore`` in
a temporary directory; each calls ``fn(*args)`` and leaves its return value
in that directory.  The ranks talk over the loopback interface; nothing
leaves the host.
"""
from __future__ import annotations

import os
import pickle
import shutil
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

__all__ = ["spawn"]


def _rank_main(rank, n, root, fn, args):
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(root, "store"), n),
                            rank=rank, world_size=n)
    try:
        out = fn(*args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(root, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def spawn(fn, n: int, *args, timeout: float = 600.0):
    """``[fn(*args) on rank 0, ..., on rank n-1]``: ``n`` gloo CPU ranks of
    one torch thread each.  ``fn`` and its arguments are pickled (``fn`` by
    its import path).  A rank that raises stops the others and its
    traceback comes back in ``torch.multiprocessing``'s
    ``ProcessRaisedException``; ranks still running after ``timeout``
    seconds are killed and ``TimeoutError`` is raised.  The caller's main
    module must guard its entry code with ``if __name__ == "__main__"``: the
    ranks import it again."""
    root = tempfile.mkdtemp(prefix="ude_ranks_")
    try:
        ranks = mp.start_processes(_rank_main, (n, root, fn, args), nprocs=n, join=False,
                                   start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ranks.join(timeout=max(deadline - time.monotonic(), 0.0)):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"{n} ranks gave no result in {timeout:.0f} s")
        finally:
            for p in ranks.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        out = []
        for r in range(n):
            with open(os.path.join(root, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)
