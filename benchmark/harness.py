"""The harness: finds a cell's configuration, traffic mix, limits and
metrics by name, runs its window, reads its metrics and decides
``correct``.

Everything that belongs to one configuration, one traffic mix or one
metric sits in a file of its own, found by the name ``BENCHMARK.json``
gives it:

  * ``configs/<config>.json``: the configuration as it is run;
  * ``traffic/<traffic>.json``: the mix's parameters, read by the general
    driver of its ``kind`` (``kinds/<kind>.py``);
  * ``limits/<cell>.json``: the limit of each number ``correct`` compares;
  * ``metrics/<metric>.py``: a reader, ``read(ctx)``, that returns the
    metric's value or None when it finds nothing to read.

A run: the kind's ``Session`` makes the data from the seed and sets the
program up (loading, building, warming every shape the mix uses); the
window then runs requests back to back and ends with the first one that
completes after ``seconds``; the device's peak memory is read; with trace
the session's ``traced`` work runs once under ``torch.profiler``; the
metrics are read; the program's state is freed; and the plain reference
judges what the window produced.  A cell on more than one card runs one
process per card (``ranks.py``); this process, rank 0, runs these steps
with every rank in step, and reports the fullest card's peak memory.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MANIFEST = ROOT / "BENCHMARK.json"

# top-level module names no run may load: JAX and the JAX package, whole
# names (the port's own name, mlff_tpu_torch, begins with the latter)
FORBIDDEN = ("jax", "jaxlib", "flax", "mlff_tpu")


def forbidden_modules(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (``sys.modules`` by
    default), compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    limits: dict
    end_to_end: list
    per_layer: list
    chips: int = 1


def _reports(metric: dict, cell: str) -> bool:
    """Whether a cell reports a metric: the cells its ``workloads`` list,
    or every cell without the key."""
    return cell in metric.get("workloads", (cell,))


def find_cell(name: str, manifest: dict | None = None) -> Cell:
    """The cell ``name`` of the manifest, with every file it names."""
    m = load_json(MANIFEST) if manifest is None else manifest
    work = {w["name"]: w for w in m["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in {MANIFEST.name}")
    w = work[name]
    configs = {c["name"]: c for c in m["configs"]}
    config = load_json(ROOT / configs[w["config"]]["file"])
    mix = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    limits = load_json(HERE / "limits" / f"{name}.json")
    e2e = [x for x in m["end_to_end"] if _reports(x, name)]
    layer = [x for x in m["per_layer"] if _reports(x, name)]
    return Cell(name=name, config=config, mix=mix, limits=limits,
                end_to_end=e2e, per_layer=layer, chips=int(w["chips"]))


def reader(metric: str):
    """The reader module of a metric, ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Context:
    """What a metric's reader reads: the cell, the window's records (each
    with ``t0``, ``t1`` on the host's clock and the kind's fields), the
    window's and set-up's seconds, the session (the program set up for the
    cell, with its ``shapes``), the device, and with trace the profiled
    stretch (``devtrace.Trace``)."""

    cell: Cell
    records: list
    window_s: float
    setup_s: float
    session: object
    device: object
    trace: object = None


def window(session, seconds: float) -> tuple[list, float]:
    """Requests back to back, ending with the first that completes after
    ``seconds``: (records, the window's seconds)."""
    records = []
    start = time.perf_counter()
    i = 0
    while True:
        t0 = time.perf_counter()
        rec = session.request(i)
        t1 = time.perf_counter()
        rec.update(t0=t0, t1=t1)
        records.append(rec)
        i += 1
        if t1 - start >= seconds:
            return records, t1 - start


def card(torch, device, count: int = 1) -> dict:
    """The card's name, the count of cards the run uses (``device`` and
    the ``count - 1`` after it) and their power limits (nvidia-smi, one
    line each) beside the result."""
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": count}
    first = device.index or 0
    ids = ",".join(str(i) for i in range(first, first + count))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
         f"--id={ids}"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode == 0:
        out["power_limit"] = "; ".join(
            line.strip() for line in smi.stdout.splitlines() if line.strip())
    return out


def memory_peak(torch, device) -> int:
    """The peak of device memory this process allocated on ``device``, 0
    off the card."""
    if device.type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(device))


def built_files() -> set:
    """(path, size, mtime) of every file under the checkout's ``build``,
    where the program builds its kernels and the run keeps its caches."""
    out = set()
    for p in (ROOT / "build").rglob("*"):
        if p.is_file():
            st = p.stat()
            out.add((str(p), st.st_size, st.st_mtime_ns))
    return out


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device, t_start: float, group=None) -> dict:
    """One run of a cell; returns the result line's object.  ``t_start`` is
    the host clock at the process's start: set-up runs from it to the
    window's start.  ``group``: on more than one card, rank 0's
    ``ranks.Group``, which drives every rank's session in step."""
    import torch

    kind = importlib.import_module(f"benchmark.kinds.{cell.mix['kind']}")
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    before = built_files()
    session = (kind.Session(cell, seed, device) if group is None
               else group.session(kind, cell, seed, device))
    setup_s = time.perf_counter() - t_start
    built = bool(built_files() - before)
    records, window_s = window(session, seconds)
    dev_out = card(torch, device, cell.chips) if on_card else {
        "platform": "cpu", "count": cell.chips}
    peak = memory_peak(torch, device)
    if group is None:
        dev_out["memory_peak_bytes"] = peak
    else:
        # the fullest card's
        by_rank = group.memory_peaks(peak)
        dev_out.update(memory_peak_bytes=max(by_rank),
                       memory_peak_bytes_by_rank=by_rank)
    ctx = Context(cell=cell, records=records, window_s=window_s,
                  setup_s=setup_s, session=session, device=device)
    metrics_of = cell.per_layer if trace else cell.end_to_end
    breakdown = None
    if trace and on_card:
        from . import devtrace

        ctx.trace = devtrace.profile(torch, session.traced)
        dev_out["busy_s"] = ctx.trace.busy_s
        dev_out["window_s"] = ctx.trace.window_s
        breakdown = {"device_ops": ctx.trace.top_device_ops(),
                     "idle_gaps": ctx.trace.idle_gaps()}
    metrics = {}
    for m in metrics_of:
        value = reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    session.release()
    if on_card:
        torch.cuda.empty_cache()
    checks = session.check(records)
    failed = sum(1 for r in records if not r["ok"])
    correct = failed == 0 and all(v <= cell.limits[k]
                                  for k, v in checks.items())
    out = {"correct": bool(correct), "attempted": len(records),
           "failed": failed, "metrics": metrics, "device": dev_out,
           "built_kernels": built}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {k: {"value": v, "limit": cell.limits[k]}
                     for k, v in checks.items()}
    return out
