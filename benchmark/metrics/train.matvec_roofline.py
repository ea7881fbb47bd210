"""The cached kernel matvec's share of its roofline, %: its least time
(``peaks.matvec_seconds``: 6 N M D operations; the two (N, M) f64 weight
arrays, the descriptors, Jacobians, operand and output each once) over the
device time of one ``matvec_psd`` (``readers.device_ms``: 20 calls after a
warm call, the union of the profiler's device intervals), on a kernel
cache of the cell's task built as the port's ``tools/bench.py`` builds
it.  None off the card."""

from benchmark import peaks
from benchmark.readers import device_ms


def read(ctx):
    if ctx.device.type != "cuda":
        return None
    import torch
    from mlff_tpu_torch.models.gdml import CG_LAM, Trainer
    from mlff_tpu_torch.ops import kernel as knl

    task = ctx.session.task()
    spec, S, X, Jc, P_idx = Trainer(device=ctx.device).build_kernel_inputs(
        task)
    cache = knl.build_cache(X, Jc, S, P_idx, float(task["sig"]), CG_LAM,
                            device=ctx.device)
    gen = torch.Generator(device=ctx.device).manual_seed(0)
    v = torch.randn(cache.n, dtype=torch.float64, device=ctx.device,
                    generator=gen)
    ms = device_ms(torch, lambda: knl.matvec_psd(cache, v))
    s = ctx.session.shapes
    return 100.0 * peaks.matvec_seconds(s["N"], s["M"], s["D"], s["A"]) / (
        ms * 1e-3)
