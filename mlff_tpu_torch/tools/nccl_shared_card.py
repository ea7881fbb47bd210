"""Whether two NCCL ranks may share one CUDA card.

    python3 -m mlff_tpu_torch.tools.nccl_shared_card [--seconds 120]

Spawns two processes that both select ``cuda:0``, join one NCCL group
through a file store and all-reduce a small CUDA tensor.  NCCL refuses
two ranks on one device in the versions the port was written against
("Duplicate GPU detected"); the sharded phase of ``chip_smoke.py`` uses
gloo with host staging for its two ranks on one card for that reason.
Prints one JSON line: the NCCL version, whether the all-reduce succeeded,
and each rank's error text.  The ranks are killed after ``--seconds``.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time


def _rank(rank, store, out_dir):
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    result = {"rank": rank}
    try:
        dist.init_process_group("nccl", init_method=f"file://{store}",
                                world_size=2, rank=rank)
        t = torch.ones(4, device="cuda")
        dist.all_reduce(t)
        torch.cuda.synchronize()
        result.update(ok=True, value=float(t[0]))
    except Exception as e:  # the refusal is the measurement
        result.update(ok=False, error=f"{type(e).__name__}: {e}"[:2000])
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)
    if dist.is_initialized():
        dist.destroy_process_group()


def main(argv=None) -> None:
    import torch
    import torch.multiprocessing as mp

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=120.0)
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(_rank, args=(os.path.join(tmp, "store"), tmp),
                                 nprocs=2, start_method="spawn", join=False)
        deadline = time.perf_counter() + args.seconds
        done = False
        while not done and time.perf_counter() < deadline:
            try:
                done = ctx.join(timeout=2)
            except Exception as e:
                print(f"a rank failed: {type(e).__name__}: {e}"[:2000])
                break
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
        ranks = []
        for r in range(2):
            path = os.path.join(tmp, f"rank{r}.json")
            ranks.append(json.load(open(path)) if os.path.exists(path)
                         else {"rank": r, "ok": False,
                               "error": "no result (killed or hung)"})
    print(json.dumps({"nccl_version": ".".join(
        map(str, torch.cuda.nccl.version())), "torch": torch.__version__,
        "card": torch.cuda.get_device_name(0), "all_reduce_ok": all(
            r.get("ok") for r in ranks), "ranks": ranks}))


if __name__ == "__main__":
    main()
