"""Start an n-rank world on one machine and run a function on every rank.

    results = launch("package.module:function", n_ranks, args=(...),
                     device="cpu")

Each rank is a subprocess of its own (``python -m
heimdall_tpu_torch.parallel.launch``) pinned to one torch thread.  It joins
the world at a free localhost port (parallel/mesh.py::init_world: gloo on
the CPU or when ranks share a card, NCCL when each has one), imports the
function, calls it with ``args``, and hands back what it returns (tensors
moved to the host).  ``launch`` returns the ranks' results in rank order.

A rank that fails makes the whole run fail: the launcher stops the other
ranks (which would wait in a collective for ever) and raises RuntimeError
with the failed rank's traceback; so does a run past ``timeout`` seconds.
The workers build no CUDA library that is already built (ops/_cuda.py
keys each by its sources), so a caller that built them first
(``_cuda.build()``) keeps them from racing to.
"""

import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

_PKG_PARENT = str(Path(__file__).resolve().parents[2])


def _to_host(x):
    import torch
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to_host(v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    return x


class World:
    """An n-rank world started on this machine (see launch); join()
    waits for it and returns the ranks' results in rank order."""

    def __init__(self, target: str, n_ranks: int, args=(), device=None,
                 timeout: float = 600.0, sys_path=()):
        from heimdall_tpu_torch.parallel.mesh import free_port

        self.n_ranks = n_ranks
        self.work = Path(tempfile.mkdtemp(prefix="hd_world_"))
        spec = self.work / "spec.pkl"
        spec.write_bytes(pickle.dumps({
            "target": target, "args": args, "n_ranks": n_ranks,
            "address": f"127.0.0.1:{free_port()}", "device": device,
            "sys_path": list(sys_path)}))
        env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join(
                       [_PKG_PARENT] + [p for p in os.environ.get(
                           "PYTHONPATH", "").split(os.pathsep) if p]))
        self.deadline = time.monotonic() + timeout
        self.timeout = timeout
        self.procs = []
        for rank in range(n_ranks):
            with open(self.work / f"log_{rank}.txt", "w") as log:
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-m",
                     "heimdall_tpu_torch.parallel.launch", str(spec),
                     str(rank)], stdout=log, stderr=subprocess.STDOUT,
                    stdin=subprocess.DEVNULL, env=env, cwd=_PKG_PARENT))

    def join(self):
        try:
            failed = None
            while failed is None:
                codes = [p.poll() for p in self.procs]
                if any(c not in (None, 0) for c in codes):
                    # a rank that fails first brings down the ranks that
                    # wait for it in a collective: let them end too, and
                    # report every failed rank
                    end = time.monotonic() + 2.0
                    while (time.monotonic() < end
                           and any(p.poll() is None for p in self.procs)):
                        time.sleep(0.05)
                    failed = [r for r, p in enumerate(self.procs)
                              if p.poll() not in (None, 0)]
                    why = "exit codes " + ", ".join(
                        f"{self.procs[r].poll()}" for r in failed)
                elif all(c == 0 for c in codes):
                    break
                elif time.monotonic() > self.deadline:
                    failed = list(range(self.n_ranks))
                    why = f"no end after {self.timeout} s"
                else:
                    time.sleep(0.05)
            if failed is not None:
                self._stop()
                logs = "\n".join(
                    f"--- rank {r} ---\n"
                    + (self.work / f"log_{r}.txt").read_text()[-4000:]
                    for r in failed)
                raise RuntimeError(f"world of {self.n_ranks} ranks failed "
                                   f"(ranks {failed}: {why}):\n{logs}")
            return [pickle.loads((self.work / f"out_{r}.pkl").read_bytes())
                    for r in range(self.n_ranks)]
        finally:
            self.close()

    def close(self):
        """Stop the ranks that still run and remove the world's files."""
        self._stop()
        shutil.rmtree(self.work, ignore_errors=True)

    def _stop(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()


def launch(target: str, n_ranks: int, args=(), device=None,
           timeout: float = 600.0, sys_path=(), wait: bool = True):
    """Run target ("module:function") on every rank of an n_ranks world;
    returns the list of its results, by rank (with wait=False the World,
    whose join() returns them).  device: CUDA unless "cpu"; sys_path:
    directories the workers add to sys.path first (where the target's
    module lives)."""
    world = World(target, n_ranks, args, device, timeout, sys_path)
    return world.join() if wait else world


def _worker(spec_path: str, rank: int) -> int:
    spec = pickle.loads(Path(spec_path).read_bytes())
    sys.path[:0] = spec["sys_path"]
    import importlib

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        from heimdall_tpu_torch.parallel.mesh import init_world
        init_world(spec["address"], spec["n_ranks"], rank, spec["device"])
        module, name = spec["target"].split(":")
        fn = getattr(importlib.import_module(module), name)
        result = _to_host(fn(*spec["args"]))
        out = Path(spec_path).parent / f"out_{rank}.pkl"
        out.with_suffix(".tmp").write_bytes(pickle.dumps(result))
        os.replace(out.with_suffix(".tmp"), out)
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    return 0


if __name__ == "__main__":
    sys.exit(_worker(sys.argv[1], int(sys.argv[2])))
