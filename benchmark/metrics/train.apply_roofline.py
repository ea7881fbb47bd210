"""The preconditioner apply's share of its roofline, %: its least time
(``peaks.apply_seconds``: B (n, k) f64 read once, 4 n k operations) over
the device time of one ``woodbury_split_apply`` (``readers.device_ms``),
on a factor of the cell's shape (n, k) drawn on the card: the apply's time
depends on the shape alone.  None off the card."""

from benchmark import peaks
from benchmark.readers import device_ms


def read(ctx):
    if ctx.device.type != "cuda":
        return None
    import torch
    from mlff_tpu_torch.models.gdml import CG_LAM
    from mlff_tpu_torch.solvers import preconditioners as pc

    s = ctx.session.shapes
    n, k = s["n"], s["k"]
    gen = torch.Generator(device=ctx.device).manual_seed(0)

    def draw(*shape):
        return torch.randn(*shape, dtype=torch.float64, device=ctx.device,
                           generator=gen)

    P = pc.WoodburySplitPreconditioner(B=draw(n, k), W2=draw(k, k),
                                       lam=CG_LAM, info={})
    v = draw(n)
    ms = device_ms(torch, lambda: pc.woodbury_split_apply(P, v))
    return 100.0 * peaks.apply_seconds(n, k) / (ms * 1e-3)
