"""Spawn gloo jobs of N CPU ranks for the multi-process tests of the port.

Each job is a function of ``torch_mesh_jobs`` run by every rank of a fresh
world: the ranks rendezvous through a ``FileStore`` under the job's own
directory (no TCP port, so parallel test workers never collide), pin torch
to one thread, and each saves what its job function returns to
``rank{r}.pt`` there.  :func:`run_jobs` starts several jobs at once and
joins them under ONE deadline: past it every rank is killed and the call
raises, and a rank that raises fails the call (the others are
terminated).  Use it from a module-scoped fixture, once per world size,
with each seed a case reading that job's results.
"""
import os
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _child(rank, world, root, job, kwargs):
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import init_world

    init_world(rank, world, store=dist.FileStore(os.path.join(root, "store"), world),
               device_type="cpu")
    try:
        import torch_mesh_jobs

        out = getattr(torch_mesh_jobs, job)(rank, world, **kwargs)
        torch.save(out, os.path.join(root, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_jobs(specs, deadline: float):
    """``specs``: ``[(job name, world size, directory, kwargs)]``.  Returns
    each job's list of per-rank results, in order."""
    contexts = []
    try:
        for job, world, root, kwargs in specs:
            os.makedirs(root, exist_ok=True)
            contexts.append(mp.start_processes(_child, args=(world, str(root), job, kwargs),
                                               nprocs=world, join=False, start_method="spawn"))
        end = time.monotonic() + deadline
        for ctx in contexts:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > end:
                    raise TimeoutError(f"spawned jobs still running after {deadline} s")
    finally:
        for ctx in contexts:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(timeout=10)
    return [[torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False)
             for r in range(world)] for _, world, root, _ in specs]
