"""Start n ranks of the edge group, one process each.

    results = launch(fn, n, args=(...), device="cpu")        # gloo, CPU
    results = launch(fn, n, args=(...), shared_device=True)  # gloo, cuda:0
    results = launch(fn, n, args=(...))                      # NCCL, cuda:r

``fn`` must be importable by name (a module-level function): the ranks are
started with ``torch.multiprocessing``'s spawn, which imports ``fn``'s
module in each child. Each rank joins the group through a rendezvous file
in a temporary directory (no TCP port, so concurrent launches never
collide), calls ``fn(*args)``, and its return value (``torch.save``-able)
comes back in rank order. Every collective has the group's timeout, and
the whole launch has ``timeout``: a rank that raises, dies or outlives it
ends every rank and raises here with the ranks' tracebacks; nothing hangs.
"""

import multiprocessing.connection
import os
import tempfile
import time
import traceback

import torch
import torch.multiprocessing as mp

from . import mesh


class RankFailure(RuntimeError):
    pass


def _rank_entry(fn, args, rank, n, init_method, backend, device,
                shared_device, timeout, threads, out_dir):
    code = 0
    try:
        if threads:
            torch.set_num_threads(threads)
        mesh.init_edge_group(n, backend=backend, init_method=init_method,
                             timeout=timeout, rank=rank, device=device,
                             shared_device=shared_device)
        result = fn(*args)
        torch.save(result, os.path.join(out_dir, f"result{rank}.pt"))
    except BaseException:
        code = 1
        with open(os.path.join(out_dir, f"error{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
    finally:
        if code == 0:
            mesh.destroy_edge_group()
    # a failed rank leaves at once: its peers may still wait in a
    # collective, and tearing the group down would wait with them
    os._exit(code)


def _kill(procs):
    for p in procs:
        if p.is_alive():
            p.kill()
    for p in procs:
        p.join(10)


def launch(fn, n, args=(), *, backend=None, device=None,
           shared_device=False, timeout=mesh.DEFAULT_TIMEOUT_S,
           threads=None):
    """Run ``fn(*args)`` on ``n`` ranks; returns their results in rank
    order. ``threads``: torch intra-op threads per rank."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="edge_group_") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(
            target=_rank_entry,
            args=(fn, args, r, n, init, backend, device, shared_device,
                  timeout, threads, tmp), daemon=False)
            for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while True:
                codes = [p.exitcode for p in procs]
                if any(c not in (None, 0) for c in codes):
                    # let the others' errors land, then end them all
                    time.sleep(1.0)
                    break
                if all(c == 0 for c in codes):
                    break
                left = deadline - time.monotonic()
                if left <= 0:
                    _kill(procs)
                    raise TimeoutError(
                        f"{n} ranks did not finish within {timeout} s")
                multiprocessing.connection.wait(
                    [p.sentinel for p in procs if p.exitcode is None],
                    timeout=min(left, 1.0))
        finally:
            _kill(procs)
        errors = []
        for r in range(n):
            path = os.path.join(tmp, f"error{r}.txt")
            if os.path.exists(path):
                with open(path) as f:
                    errors.append(f"--- rank {r} ---\n{f.read()}")
            elif procs[r].exitcode not in (0, None):
                errors.append(f"--- rank {r} --- exit code "
                              f"{procs[r].exitcode}")
        if errors:
            raise RankFailure("edge-group ranks failed:\n"
                              + "\n".join(errors))
        return [torch.load(os.path.join(tmp, f"result{r}.pt"),
                           map_location="cpu", weights_only=False)
                for r in range(n)]
