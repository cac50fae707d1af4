"""Start a group of ranks on this host and collect what each returns.

    from femo_tpu_torch.parallel.launch import spawn
    results = spawn(fn, 4)                  # 4 ranks on the card(s)
    results = spawn(fn, 4, device="cpu")    # 4 CPU ranks, gloo

`fn(mesh, *args)` runs once in each rank, `mesh` the rank's `RankMesh`
(parallel/sharding.py), with the rank's device as its `config.device`
and the parent's working dtype, and `spawn` returns the list of the
ranks' return values, rank 0 first.  fn must be a module-level function
(it is pickled by name into fresh processes: the `spawn` start method,
which also imports the parent's main script, so a script that calls
`spawn` does so under `if __name__ == "__main__"`) and its result
picklable; return numpy arrays or Python numbers, not CUDA tensors.

The ranks meet through a `FileStore` in a fresh temporary directory, so
no TCP port is fixed and two groups on one host never meet by mistake.

Backend.  NCCL needs a card of its own for each rank: it refuses two ranks
on one device.  So the backend is "nccl" only when every rank has a card
of its own, and "gloo" otherwise: the CPU ranks of the tests, and ranks
that share one H100 (gloo stages CUDA tensors through the host).  The
choice is made from the arguments before any collective, printed, and
never retried with another backend after a failure.

No fallback.  With device=None the ranks run on the card and there must
be one.  A rank that raises, dies or is still running when the time
limit expires makes `spawn` kill every rank and raise, with the failed
rank's traceback.
"""

from __future__ import annotations

import multiprocessing
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from ..config import config, get_device, set_precision

# seconds between two looks at the ranks while waiting for results
_POLL = 0.5


def choose_backend(ranks: int, device_type: str) -> str:
    """"nccl" when each of `ranks` CUDA ranks has a card of its own, else
    "gloo"."""
    if device_type == "cuda" and torch.cuda.device_count() >= ranks:
        return "nccl"
    return "gloo"


def _rank_main(fn, rank, ranks, backend, device_type, store_path, dtype,
               args, results):
    """One rank: join the group, run fn(mesh, *args), put (rank, ok,
    result or traceback) on the results queue."""
    from .sharding import RankMesh

    try:
        set_precision(dtype)
        if device_type == "cuda":
            device = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(device)
        else:
            device = torch.device("cpu")
        config.device = str(device)  # the rank's default device
        store = dist.FileStore(store_path, ranks)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=ranks)
        out = fn(RankMesh(dist.group.WORLD, rank, ranks, device), *args)
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _stop(procs):
    started = [p for p in procs if p.pid is not None]
    for p in started:
        if p.is_alive():
            p.kill()
    for p in started:
        p.join(10)


def spawn(fn, ranks: int, device=None, backend: str | None = None,
          args: tuple = (), timeout: float = 600.0) -> list:
    """Run fn(mesh, *args) on `ranks` new processes and return their
    results, rank 0 first.

    device: None (the card, `config.device`; raises without one) or
    "cpu"; rank r runs on cuda:(r % device_count) or on the CPU.
    backend: None chooses (`choose_backend`); "nccl" with fewer cards than
    ranks, or with CPU ranks, raises.  The ranks take the parent's working
    dtype (`config.dtype`).  timeout: seconds for the whole group; on
    expiry every rank is killed and TimeoutError raised."""
    ranks = int(ranks)
    if ranks < 1:
        raise ValueError(f"ranks={ranks}: at least 1")
    dev = get_device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device {dev}: 'cuda' or 'cpu'")
    if backend is None:
        backend = choose_backend(ranks, dev.type)
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend={backend!r}: 'nccl' or 'gloo'")
    if backend == "nccl" and (dev.type != "cuda"
                              or torch.cuda.device_count() < ranks):
        raise ValueError(
            f"nccl needs a card for each rank: {ranks} ranks, "
            f"{torch.cuda.device_count() if dev.type == 'cuda' else 0} "
            "cards")
    print(f"[launch] {ranks} ranks, backend {backend}, device {dev.type}",
          flush=True)
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="femo_ranks_")
    store_path = os.path.join(tmp, "store")
    dtype = str(config.dtype).replace("torch.", "")
    procs = [ctx.Process(target=_rank_main, name=f"rank{r}", daemon=True,
                         args=(fn, r, ranks, backend, dev.type, store_path,
                               dtype, args, results))
             for r in range(ranks)]
    try:
        for p in procs:
            p.start()
        out = {}
        deadline = time.monotonic() + timeout
        while len(out) < ranks:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"{ranks - len(out)} of {ranks} ranks still running "
                    f"after {timeout:.0f} s (ranks done: {sorted(out)})")
            try:
                rank, ok, val = results.get(timeout=min(_POLL, left))
            except queue_mod.Empty:
                dead = [p.name for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if not dead:
                    continue
                try:  # a rank that raised has put its traceback
                    rank, ok, val = results.get(timeout=5.0)
                except queue_mod.Empty:
                    raise RuntimeError(
                        f"{', '.join(dead)} ended without a result "
                        f"(exit codes {[p.exitcode for p in procs]})"
                    ) from None
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{val}")
            out[rank] = val
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
        return [out[r] for r in range(ranks)]
    finally:
        _stop(procs)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
