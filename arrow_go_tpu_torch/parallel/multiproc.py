"""Multi-process distributed execution (runnable on the CPU over gloo).

Port of arrow_go_tpu/parallel/multiproc.py. Every rank of the port is
its own OS process, so the tier always crosses a process boundary; this
module starts such processes and moves whole arrays in and out of them.

Worker side (inside a started process):
  init_worker()       join the process group, return the mesh
  global_put()        full host array -> this rank's row block
  collect()           per-rank blocks -> the full host array, on every rank

Parent side:
  worker_env()        child environment (the package importable)
  launch()            start N workers of a module, wait, propagate rc
"""
from __future__ import annotations

import os
import subprocess
import sys
from typing import List, Sequence

import numpy as np
import torch

from .mesh import (Mesh, all_gather, free_port, initialize_multihost,
                   row_sharding)

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# ---------------------------------------------------------------------------
# worker side
# ---------------------------------------------------------------------------


def init_worker(process_id: int, num_processes: int, port: int,
                host: str = "localhost", device=None) -> Mesh:
    """Join this process to the group of `num_processes` ranks whose
    rendezvous is host:port, and return the mesh over it."""
    return initialize_multihost(f"tcp://{host}:{port}", num_processes,
                                process_id, device)


def global_put(mesh: Mesh, data: np.ndarray) -> torch.Tensor:
    """Full host array (identical on every rank) -> this rank's row
    block on the mesh device."""
    return row_sharding(mesh).put(data)


def collect(mesh: Mesh, arr: torch.Tensor) -> np.ndarray:
    """Every rank's block (all of one length), concatenated in rank
    order, as a host array on every rank (an all_gather)."""
    return all_gather(mesh, arr.contiguous().reshape(-1)).cpu().numpy()


# ---------------------------------------------------------------------------
# parent side
# ---------------------------------------------------------------------------


def worker_env() -> dict:
    """Child environment: this package importable, one compute thread
    per worker unless the caller's environment says otherwise."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [_ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                   if p])
    env.setdefault("OMP_NUM_THREADS", "1")
    return env


def launch(module: str, num_processes: int,
           extra_args: Sequence[str] = (), timeout: float = 600.0,
           capture: bool = False) -> List[subprocess.CompletedProcess]:
    """Start `num_processes` workers `python -m module`, each receiving
    `--process-id I --num-processes N --port PORT` plus extra_args
    (capture: their stdout and stderr come back in the results). Raises
    on any non-zero exit; on a timeout every worker is killed."""
    port = free_port()
    env = worker_env()
    procs = []
    for i in range(num_processes):
        cmd = [sys.executable, "-m", module, "--process-id", str(i),
               "--num-processes", str(num_processes), "--port", str(port),
               *extra_args]
        procs.append(subprocess.Popen(
            cmd, env=env,
            stdout=subprocess.PIPE if capture else None,
            stderr=subprocess.STDOUT if capture else None,
            text=True))
    done = []
    failed = None
    try:
        for i, p in enumerate(procs):
            out, _ = p.communicate(timeout=timeout)
            done.append(subprocess.CompletedProcess(p.args, p.returncode,
                                                    out))
            if p.returncode != 0 and failed is None:
                failed = i
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if failed is not None:
        raise RuntimeError(f"worker {failed} exited "
                           f"{done[failed].returncode}:\n"
                           f"{done[failed].stdout or ''}")
    return done
