"""Multi-process entry point: ``torch.distributed`` from the launch's
environment.

Counterpart of ``multimodal_moe_tpu/parallel/distributed.py``. Every rank
runs the same command; the launch names the cluster with the same
variables as the JAX package:

* ``MMOE_COORDINATOR_ADDRESS`` (or ``JAX_COORDINATOR_ADDRESS``): ``host:port``
  of rank 0's rendezvous;
* ``MMOE_NUM_PROCESSES`` / ``MMOE_PROCESS_ID`` (or the ``JAX_*`` variants):
  the world size and this rank;
* ``MMOE_LOCAL_RANK`` (or ``LOCAL_RANK``): the rank on this host, which
  picks the card (the process id where neither is set).

The backend is explicit: ``nccl`` for ranks on the card, ``gloo`` on the
CPU. A caller may ask for ``gloo`` on the card (two ranks sharing one card:
NCCL refuses two ranks on one device). NCCL with more ranks than cards
raises; the backend never changes behind the caller's back.

:func:`run_ranks` launches a command once per rank on this host, with the
variables above and a free port.
"""

from __future__ import annotations

import datetime
import os
import socket
import subprocess
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .._device import resolve_device

# A collective that waits longer than this fails instead of hanging.
TIMEOUT = datetime.timedelta(minutes=10)


def _env(*names: str) -> Optional[str]:
    for n in names:
        v = os.environ.get(n)
        if v:
            return v
    return None


def _env_int(*names: str) -> Optional[int]:
    v = _env(*names)
    return int(v) if v is not None else None


def local_rank() -> int:
    """This rank's index on its host."""
    v = _env_int("MMOE_LOCAL_RANK", "LOCAL_RANK")
    if v is not None:
        return v
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return _env_int("MMOE_PROCESS_ID", "JAX_PROCESS_ID") or 0


def rank_device(device=None) -> torch.device:
    """The device of this rank: ``device`` where the caller names one, else
    ``cuda:{local_rank % device_count}`` (and an error without a card)."""
    if device is not None:
        return resolve_device(device)
    resolve_device(None)
    return torch.device("cuda", local_rank() % torch.cuda.device_count())


def maybe_initialize_distributed(
    *,
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device=None,
) -> bool:
    """Initialize ``torch.distributed`` when a multi-process launch is
    requested; a no-op returning False on a plain single-process run. Safe
    to call twice. ``backend=None`` means ``nccl`` where this rank's device
    (:func:`rank_device`) is a card, ``gloo`` on the CPU."""
    if dist.is_initialized():
        return True
    coordinator_address = coordinator_address or _env(
        "MMOE_COORDINATOR_ADDRESS", "JAX_COORDINATOR_ADDRESS")
    if num_processes is None:
        num_processes = _env_int("MMOE_NUM_PROCESSES", "JAX_NUM_PROCESSES")
    if process_id is None:
        process_id = _env_int("MMOE_PROCESS_ID", "JAX_PROCESS_ID")
    if coordinator_address is None and not (num_processes and num_processes > 1):
        return False
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "a multi-process launch needs the coordinator address, the number of processes "
            "and this process's id (MMOE_COORDINATOR_ADDRESS, MMOE_NUM_PROCESSES, "
            f"MMOE_PROCESS_ID); got {coordinator_address!r}, {num_processes!r}, {process_id!r}")
    dev = rank_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("the nccl backend runs ranks on the card; pass backend='gloo' "
                             "for the CPU")
        cards = torch.cuda.device_count()
        if num_processes > cards:
            raise RuntimeError(
                f"NCCL takes one rank a card: {num_processes} ranks asked for, {cards} "
                "card(s) visible; pass backend='gloo' to share a card")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id, timeout=TIMEOUT)
    return True


def loader_shard() -> "Tuple[int, int]":
    """``(process_index, process_count)`` for the loaders' process shards:
    ``(0, 1)`` on a single process."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def free_port() -> int:
    """A TCP port free on this host now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(argv: Sequence[str], n: int, *, env: "Optional[Dict[str, str]]" = None,
              timeout: float = 600.0, cwd=None) -> "List[Tuple[int, str, str]]":
    """Run ``argv`` as ``n`` ranks of one cluster on this host (rendezvous
    on a free localhost port) and wait for all of them: ``[(returncode,
    stdout, stderr)]`` by rank. A rank that fails or outlives ``timeout``
    seconds stops every rank, and the call raises with its output's tail."""
    port = free_port()
    procs, files = [], []
    try:
        for rank in range(n):
            out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
            files.append((out, err))
            # One rank a share of the host's cores (torch's intra-op threads).
            threads = {"OMP_NUM_THREADS": str(max(1, (os.cpu_count() or 1) // n))}
            rank_env = {**threads, **os.environ, **(env or {}),
                        "MMOE_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
                        "MMOE_NUM_PROCESSES": str(n), "MMOE_PROCESS_ID": str(rank),
                        "MMOE_LOCAL_RANK": str(rank)}
            procs.append(subprocess.Popen(list(argv), env=rank_env, stdout=out, stderr=err,
                                          cwd=cwd))
        failed = None
        deadline = time.monotonic() + timeout
        while failed is None and any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
            if bad:
                failed = f"rank {bad[0]} exited with {procs[bad[0]].returncode}"
            elif time.monotonic() > deadline:
                failed = f"the ranks did not finish in {timeout:.0f} s"
            else:
                time.sleep(0.05)
        bad = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
        if failed is None and bad:
            failed = f"rank {bad[0]} exited with {procs[bad[0]].returncode}"
        if failed:
            for p in procs:
                p.kill()
            for p in procs:
                p.wait()
        results = []
        for p, (out, err) in zip(procs, files):
            out.seek(0)
            err.seek(0)
            results.append((p.returncode, out.read(), err.read()))
        if failed:
            tails = "\n".join(f"--- rank {r} (rc {rc}) ---\n{o[-2000:]}\n{e[-4000:]}"
                              for r, (rc, o, e) in enumerate(results))
            raise RuntimeError(f"{failed}\n{tails}")
        return results
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for out, err in files:
            out.close()
            err.close()
