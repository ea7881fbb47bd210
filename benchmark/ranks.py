"""Cells on more than one card: one process per card, all in one group.

A cell whose ``chips`` is above 1 runs as ``chips`` processes.  The
command's own process is rank 0 on ``cuda:0``; it starts ``chips - 1``
followers, fresh interpreters running ``python -m benchmark.ranks <group
dir> <rank>``, rank r on ``cuda:r``.  All of them join one NCCL group
(gloo on the CPU, where the tests run it) over a file store in a
temporary directory, so no port is taken, with the timeout
``GROUP_TIMEOUT_S``.  Each rank makes the same data from the seed, builds
the same session and hands it the 1-D mesh of
``mlff_tpu_torch.parallel.mesh.make_mesh``.

Rank 0 runs the harness as on one card, its session wrapped in
``Lockstep``: each call the harness makes on the session (each request of
the window, the traced work, the peak memory, the release) is first sent
to every follower over a gloo group of the run's own, so every rank meets
the program's collectives in the same order.  A request is ``ok`` only if
it is on every rank.  Only rank 0 is profiled and recorded; only rank 0
prints, and judges its own models (a sharded training returns the same
model on every rank).  The followers end at the release, where each
reports the modules it loaded, and rank 0 waits for them before the
reference runs.

Failure is bounded.  A follower that raises prints its traceback to
standard error and exits non-zero; one that ends before the release, by
any cause, makes rank 0 kill the others, wait for them and exit with
``FOLLOWER_LOST``, without a result.  A rank that waits past the timeout
in a collective fails as well.  A follower dies with rank 0, even when
rank 0 is killed (``PR_SET_PDEATHSIG``; rank 0 starts the followers from
its main thread, whose end is what the kernel watches).
"""

from __future__ import annotations

import ctypes
import dataclasses
import importlib
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

from benchmark import harness

# outlasts the longest honest wait in a collective: rank 0 alone runs the
# metric readers and its profiled trainings while the followers wait, and
# a rank can wait on another's host stages of the preconditioner build
GROUP_TIMEOUT_S = 300
FOLLOWER_LOST = 4
PR_SET_PDEATHSIG = 1


def host_threads(world: int) -> None:
    """Give each rank its share of the host's cores (``OMP_NUM_THREADS``,
    read by torch, OpenBLAS and MKL as they load): four ranks on a host of
    32 cores take 8 each, as one card's machine of 8 cores does.  Called
    before torch is imported; the followers inherit it."""
    os.environ["OMP_NUM_THREADS"] = str(
        max(1, len(os.sched_getaffinity(0)) // world))


def join(group_dir: str, rank: int, world: int, device_type: str):
    """Join the run's group as ``rank``: (device, mesh, control group)."""
    import datetime

    import torch
    import torch.distributed as dist
    from mlff_tpu_torch.parallel import distributed as pdist
    from mlff_tpu_torch.parallel import mesh as pmesh

    if device_type == "cuda":
        device, backend = torch.device("cuda", rank), "nccl"
        torch.cuda.set_device(device)
    else:
        device, backend = torch.device("cpu"), "gloo"
    timeout = datetime.timedelta(seconds=GROUP_TIMEOUT_S)
    pdist.init_distributed(
        backend=backend,
        init_method="file://" + os.path.join(group_dir, "store"),
        world_size=world, rank=rank, timeout=timeout)
    control = dist.new_group(backend="gloo", timeout=timeout)
    return device, pmesh.make_mesh(), control


def broadcast(control, cmd=None):
    """Rank 0's ``cmd`` on every rank."""
    import torch.distributed as dist

    box = [cmd]
    dist.broadcast_object_list(box, src=0, group=control)
    return box[0]


def gather(control, value) -> list:
    """Every rank's ``value``, by rank, on every rank."""
    import torch.distributed as dist

    out = [None] * dist.get_world_size(control)
    dist.all_gather_object(out, value, group=control)
    return out


class Group:
    """Rank 0's side of a run on ``cell.chips`` ranks: the followers it
    started, the group it formed with them, and a watcher of the
    followers.  ``follower`` is the module the followers run."""

    def __init__(self, cell, seed: int, device_type: str,
                 follower: str = "benchmark.ranks"):
        self.world = int(cell.chips)
        self.dir = tempfile.mkdtemp(prefix="benchmark-ranks-")
        with open(os.path.join(self.dir, "run.json"), "w") as f:
            json.dump({"cell": dataclasses.asdict(cell), "seed": seed,
                       "device": device_type, "parent": os.getpid()}, f)
        # ended: "end" sent, a follower may now exit with 0; closed: the
        # followers are done with, the watcher stops
        self.ended = self.closed = False
        self.forbidden = []
        # the followers' standard output goes to standard error: rank 0's
        # result line is the last line of standard output
        self.procs = [subprocess.Popen(
            [sys.executable, "-m", follower, self.dir, str(r)],
            cwd=harness.ROOT, stdout=sys.stderr.fileno())
            for r in range(1, self.world)]
        threading.Thread(target=self._watch, daemon=True).start()
        try:
            self.device, self.mesh, self.control = join(
                self.dir, 0, self.world, device_type)
        except BaseException:
            self.abort()
            raise

    def _watch(self) -> None:
        while not self.closed:
            for r, p in enumerate(self.procs, 1):
                code = p.poll()
                if (code is not None and (code != 0 or not self.ended)
                        and not self.closed):
                    print(f"benchmark: rank {r} ended (exit code {code}) "
                          "before the run's end", file=sys.stderr, flush=True)
                    self.kill()
                    os._exit(FOLLOWER_LOST)
            time.sleep(0.1)

    def send(self, *cmd) -> None:
        broadcast(self.control, cmd)

    def session(self, kind, cell, seed: int, device) -> "Lockstep":
        return Lockstep(self, kind.Session(cell, seed, device,
                                           mesh=self.mesh))

    def memory_peaks(self, own: int) -> list:
        """Every rank's peak of device memory, by rank."""
        self.send("peak")
        return gather(self.control, own)

    def close(self) -> None:
        """End the followers, leave the group with them (NCCL's teardown
        waits for every rank's), wait for them; raises if a follower ended
        badly."""
        import torch.distributed as dist

        self.ended = True
        self.send("end")
        try:
            dist.destroy_process_group()
            codes = [p.wait(timeout=GROUP_TIMEOUT_S) for p in self.procs]
        finally:
            self.closed = True
            self.kill()
            shutil.rmtree(self.dir, ignore_errors=True)
        bad = {r: c for r, c in enumerate(codes, 1) if c != 0}
        if bad:
            raise RuntimeError(f"followers ended badly: {bad}")

    def kill(self) -> None:
        """Kill every follower still running and wait for each."""
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()

    def abort(self) -> None:
        """After a failure on rank 0: kill the followers, remove the
        group's directory."""
        self.closed = True
        self.kill()
        shutil.rmtree(self.dir, ignore_errors=True)


class Lockstep:
    """Rank 0's session: each call the harness makes on it goes to every
    rank, in order; anything else is the session's own."""

    def __init__(self, group: Group, session):
        self._group, self._session = group, session

    def __getattr__(self, name):
        return getattr(self._session, name)

    def request(self, i: int) -> dict:
        self._group.send("request", i)
        rec = self._session.request(i)
        rec["ok"] = all(gather(self._group.control, bool(rec["ok"])))
        return rec

    def traced(self) -> None:
        self._group.send("traced")
        self._session.traced()

    def release(self) -> None:
        """Release every rank's session, take the modules each follower
        loaded, and end the followers."""
        self._group.send("release")
        self._session.release()
        found = gather(self._group.control, [])
        self._group.forbidden = sorted({m for names in found for m in names})
        self._group.close()


def run_cell(cell, seed: int, seconds: float, trace: bool, t_start: float,
             device_type: str = "cuda",
             follower: str = "benchmark.ranks") -> tuple[dict, list]:
    """One run of a cell on ``cell.chips`` ranks, this process rank 0:
    (the result line's object, the forbidden modules the followers
    loaded)."""
    group = Group(cell, seed, device_type, follower)
    try:
        out = harness.run_cell(cell, seed, seconds, trace, group.device,
                               t_start, group=group)
    except BaseException:
        group.abort()
        raise
    return out, group.forbidden


def die_with_parent(parent: int) -> None:
    """Have the kernel kill this process when its parent ends; exit now if
    the parent has already ended."""
    libc = ctypes.CDLL(None, use_errno=True)
    libc.prctl.argtypes = [ctypes.c_int] + [ctypes.c_ulong] * 4
    libc.prctl.restype = ctypes.c_int
    if libc.prctl(PR_SET_PDEATHSIG, signal.SIGKILL, 0, 0, 0) != 0:
        raise OSError(ctypes.get_errno(), "prctl(PR_SET_PDEATHSIG)")
    if os.getppid() != parent:
        os._exit(FOLLOWER_LOST)


def follow(group_dir: str, rank: int) -> int:
    """A follower's whole run: join the group, build the session, then do
    what rank 0 sends until it sends ``end``."""
    with open(os.path.join(group_dir, "run.json")) as f:
        run = json.load(f)
    die_with_parent(int(run["parent"]))
    import torch
    import torch.distributed as dist

    cell = harness.Cell(**run["cell"])
    device, mesh, control = join(group_dir, rank, cell.chips, run["device"])
    kind = importlib.import_module(f"benchmark.kinds.{cell.mix['kind']}")
    session = kind.Session(cell, int(run["seed"]), device, mesh=mesh)
    while True:
        cmd = broadcast(control)
        if cmd[0] == "request":
            gather(control, bool(session.request(cmd[1])["ok"]))
        elif cmd[0] == "traced":
            session.traced()
        elif cmd[0] == "peak":
            gather(control, harness.memory_peak(torch, device))
        elif cmd[0] == "release":
            session.release()
            gather(control, harness.forbidden_modules())
        elif cmd[0] == "end":
            break
        else:
            raise ValueError(f"unknown command {cmd!r}")
    dist.destroy_process_group()
    return 0


def main(argv=None) -> int:
    group_dir, rank = (sys.argv[1:] if argv is None else argv)
    try:
        return follow(group_dir, int(rank))
    except BaseException:
        print(f"benchmark: rank {rank} failed", file=sys.stderr, flush=True)
        raise


if __name__ == "__main__":
    sys.exit(main())
