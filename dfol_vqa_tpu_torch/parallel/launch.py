"""Processes of one mesh job, started side by side and watched from one
parent: the counterpart of JAX's self-provisioning re-exec
(``__graft_entry__._reexec_dryrun``) for the port's one-process-per-device
mesh. A job's ranks meet through a file rendezvous that the caller names
(``init_method="file://..."``), so nothing here needs a free port or
``torchrun``.
"""

from __future__ import annotations

import os
import subprocess
import time
from typing import Dict, Optional, Sequence


def run_processes(commands: Sequence[Sequence[str]], workdir: str, timeout: float, what: str,
                  cwd: Optional[str] = None, env: Optional[Dict[str, str]] = None) -> None:
    """Run ``commands`` side by side, one process each (rank ``i`` runs
    ``commands[i]``, its output in ``workdir/rank<i>.log``), all within
    ``timeout`` seconds of the start. When one fails or runs out of time,
    kill them all and raise, with the end of every log that names an error;
    no process outlives the call."""
    os.makedirs(workdir, exist_ok=True)
    procs = []
    try:
        for rank, argv in enumerate(commands):
            log_f = open(os.path.join(workdir, f"rank{rank}.log"), "w")
            procs.append((subprocess.Popen(list(argv), cwd=cwd, env=env, stdout=log_f,
                                           stderr=subprocess.STDOUT), log_f))
        deadline = time.monotonic() + timeout
        failed = None
        for rank, (proc, _) in enumerate(procs):
            try:
                rc = proc.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                failed = (rank, f"timed out after {timeout} s")
                break
            if rc != 0:
                failed = (rank, f"exit code {rc}")
                break
    finally:
        for proc, log_f in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log_f.close()
    if failed is not None:
        tails = []
        for rank in range(len(commands)):
            with open(os.path.join(workdir, f"rank{rank}.log")) as f:
                text = f.read()
            if "Error" in text:
                tails.append(f"--- rank {rank}:\n{text[-2500:]}")
        raise RuntimeError(f"{what}: rank {failed[0]} {failed[1]}:\n" + "\n".join(tails))
