"""Run one function on several ranks, each its own process.

``run_ranks(fn, world_size, args)`` spawns ``world_size`` processes, joins
them in one process group over a ``file://`` rendezvous in a fresh
temporary directory (no port to collide with another run), calls
``fn(mesh, *args)`` on each, and returns the ranks' results in rank order.
``fn`` is sent by import path, so it must be a module-level function, and
its result must pickle without tensors (numpy arrays, numbers). A rank
that raises, or a run that outlasts ``timeout`` seconds, ends every rank
and raises here with the traces; every collective also times out after
``timeout``. Each rank runs torch on ``threads`` intra-op threads, so that
ranks sharing a host do not oversubscribe its cores.

Used by ``parallel.dryrun``, ``chip_smoke.py`` (ranks sharing one card
over ``gloo``) and the tests (ranks on the CPU over ``gloo``).
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Callable, List, Optional


def _rank_main(fn, rank, world_size, backend, init_method, timeout, threads,
               args, results):
    import torch
    import torch.distributed as dist
    from mm3d_tpu_torch.parallel.mesh import make_mesh
    torch.set_num_threads(threads)
    try:
        dist.init_process_group(backend=backend, init_method=init_method,
                                rank=rank, world_size=world_size,
                                timeout=datetime.timedelta(seconds=timeout))
        try:
            out = fn(make_mesh(), *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn: Callable, world_size: int, args: tuple = (),
              backend: str = "gloo", timeout: float = 120.0,
              threads: int = 2, workdir: Optional[str] = None) -> List:
    """``[fn(mesh, *args) on rank r for r in range(world_size)]``, each
    rank a spawned process (see the module's docstring). ``workdir`` holds
    the rendezvous file (default: the system's temporary directory)."""
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="mm3d_ranks_", dir=workdir)
    init = "file://" + os.path.join(tmp, "rendezvous")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world_size, backend, init, timeout,
                               threads, args, results))
             for r in range(world_size)]
    out, errors = {}, []
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        # drain the queue before joining (a writer blocks on a full pipe)
        while len(out) + len(errors) < world_size:
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0)]
                if dead:
                    errors.append(f"ranks {dead} died (exit codes "
                                  f"{[procs[r].exitcode for r in dead]})")
                elif time.monotonic() > deadline:
                    errors.append(f"timed out after {timeout} s")
                else:
                    continue
                break
            if ok:
                out[rank] = payload
            else:
                errors.append(f"rank {rank}:\n{payload}")
                break  # the others may wait on the failed rank
        if not errors:
            for p in procs:
                p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if errors:
        raise RuntimeError("run_ranks: " + "\n".join(errors))
    return [out[r] for r in range(world_size)]
