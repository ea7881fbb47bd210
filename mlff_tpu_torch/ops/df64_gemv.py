"""Double-f32 (df64) GEMV passes of the Woodbury preconditioner apply.

The CUDA kernels in ``csrc/df64_gemv.cu`` replace the TPU kernels
``mlff_tpu/ops/pallas_df64.py::_bt_v_kernel`` (``u = B^T v``) and
``::_b_x_kernel`` (``y = B x``).  B (n, m) is an f32 (hi, lo) pair, the
vector and the result are f64.  Each product is an error-free hi*hi product
plus the cross terms, summed in compensated df64 arithmetic: ~2^-48
relative, f64-class for the solver, from B stored in f32 words.

Both passes read the pair once, 8 bytes per element against ~18 f32
operations: on an H100 the bytes bound them by ~9x, and the instruction
slots come to about a third of that bound.  So each pass is one launch of a
persistent grid, one block per SM, that streams B through a ring of
shared-memory stages filled by asynchronous bulk copies (16-byte aligned
row segments, which is why the kernel is given a contiguous, 16-byte
aligned B, a copy where the caller's is not, and why the copies apply when
``m % 4 == 0``; for other m the block fills a stage with plain loads) and read back as 16-byte words, a lane owning four neighbouring
columns.  ``plan`` holds that geometry; the kernel source mirrors its
constants.  ``df64_bt_v`` sums each (row slab, column group) unit in one
block; the slabs' partials meet in a fixed tree, each node added by the
block that finishes it last (a ticket counter), so the pass needs no second
launch and its result is the same bit for bit from run to run.

``df64_bt_v`` and ``df64_b_x`` launch the kernels for CUDA tensors (a failed
build or launch raises) and run the plain PyTorch versions
``df64_bt_v_ref`` / ``df64_b_x_ref`` (``ops/df64.py``) for CPU tensors.
Each wrapper counts its launches, one per pass, in a counter of
``utils.trace`` (``LAUNCHES``).  Nothing is padded: any (n, m) is taken as
it is.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import torch

from ..utils import trace
from . import cuda_build
from . import df64

# the counters of ``utils.trace`` of each wrapper's launches
LAUNCHES = {"bt_v": "launches.df64_bt_v", "b_x": "launches.df64_b_x"}

# the launch geometry of csrc/df64_gemv.cu
ROWS = 8                 # rows of B in a shared-memory stage
COLS = 768               # columns of B in a stage
CONSUMERS = 384          # computing threads: 2 row sets x 6 warps x 32 lanes
THREADS = CONSUMERS + 32   # and the warp that starts the bulk copies
STAGE_BYTES = 2 * ROWS * COLS * 4 + 128   # Bh, Bl and the rows' v
GROUP = 5                # bt_v: column chunks a block walks together
FAN = 8                  # bt_v: partials added at one node of the tree
RED_BYTES = GROUP * (CONSUMERS // 2) * 4 * 8
BAR_BYTES = 256
MAX_STAGES = 4
SMEM_LIMIT = 232448      # shared memory one block may use on an H100
SLAB_ROWS_MAX = 640      # bt_v: at most 640 / 2 sequential terms per sum
# f32 operations per element in either pass: hi*hi product and its fmaf
# error (3), cross terms (4), df64 accumulation (11)
OPS_PER_ELEMENT = 18


@dataclass(frozen=True)
class Plan:
    """Launch geometry of both passes over B (n, m) on a card with
    ``sm_count`` SMs."""

    n: int
    m: int
    bulk: bool          # stages filled by bulk copies (m % 4 == 0)
    stages: int         # ring depth
    smem_bytes: int     # dynamic shared memory of a block
    n_chunks: int       # column chunks of COLS
    n_panels: int       # b_x: row panels of ROWS
    grid_b_x: int       # b_x: block b takes panels b, b + grid, ...
    n_slabs: int        # bt_v: slab s is the panels s, s + n_slabs, ...
    group_chunks: int   # bt_v: column chunks per group, at most GROUP
    n_groups: int
    grid_bt_v: int      # bt_v: block b takes units b, b + grid, ...;
                        # unit = slab * n_groups + group

    @property
    def n_units(self) -> int:
        return self.n_slabs * self.n_groups

    @property
    def tree_nodes(self) -> int:
        """Nodes of the FAN-ary tree over the slabs' partials: one ticket
        each, and all but the top one row of scratch."""
        count, nodes = self.n_slabs, 0
        while True:
            count = -(-count // FAN)
            nodes += count
            if count == 1:
                return nodes

    def b_x_tiles(self):
        """(block, row0, rows, col0, cols) of every stage b_x fills."""
        for b in range(self.grid_b_x):
            for p in range(b, self.n_panels, self.grid_b_x):
                for c in range(self.n_chunks):
                    yield (b, p * ROWS, min(ROWS, self.n - p * ROWS),
                           c * COLS, min(COLS, self.m - c * COLS))

    def bt_v_tiles(self):
        """(block, row0, rows, col0, cols) of every stage bt_v fills."""
        for b in range(self.grid_bt_v):
            for uid in range(b, self.n_units, self.grid_bt_v):
                g, s = uid % self.n_groups, uid // self.n_groups
                c_hi = min(self.n_chunks, (g + 1) * self.group_chunks)
                for p in range(s, self.n_panels, self.n_slabs):
                    for c in range(g * self.group_chunks, c_hi):
                        yield (b, p * ROWS, min(ROWS, self.n - p * ROWS),
                               c * COLS, min(COLS, self.m - c * COLS))


@functools.lru_cache(maxsize=64)
def plan(n: int, m: int, sm_count: int) -> Plan:
    """The geometry for B (n, m), n, m >= 1.  With bulk copies the ring
    takes what shared memory allows and one block runs per SM; without, a
    block holds one stage and two share an SM.  bt_v walks the column
    chunks in groups of at most ``GROUP`` (a thread keeps every chunk's sums
    in registers), and its slabs are cut so that slabs x groups fills whole
    waves of the grid, as long as a slab keeps to ``SLAB_ROWS_MAX`` rows."""
    bulk = m % 4 == 0
    stages = (min(MAX_STAGES, (SMEM_LIMIT - RED_BYTES - BAR_BYTES)
                  // STAGE_BYTES) if bulk else 1)
    blocks = sm_count if bulk else 2 * sm_count
    n_chunks = -(-m // COLS)
    n_panels = -(-n // ROWS)
    n_groups = -(-n_chunks // GROUP)
    group_chunks = -(-n_chunks // n_groups)
    n_groups = -(-n_chunks // group_chunks)
    per_wave = blocks // math.gcd(blocks, n_groups)
    waves = -(-n_panels * ROWS // (SLAB_ROWS_MAX * per_wave))
    n_slabs = min(n_panels, per_wave * waves)
    return Plan(n=n, m=m, bulk=bulk, stages=stages,
                smem_bytes=stages * STAGE_BYTES + RED_BYTES + BAR_BYTES,
                n_chunks=n_chunks, n_panels=n_panels,
                grid_b_x=min(n_panels, blocks),
                n_slabs=n_slabs, group_chunks=group_chunks, n_groups=n_groups,
                grid_bt_v=min(n_slabs * n_groups, blocks))


def _check(Bh: torch.Tensor, Bl: torch.Tensor, vec: torch.Tensor, axis: int):
    for name, t in (("Bh", Bh), ("Bl", Bl)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"{name} must be a 2-D tensor")
    if vec.dtype != torch.float64 or vec.dim() != 1:
        raise TypeError(f"the vector must be 1-D float64, got {vec.dtype} "
                        f"with shape {tuple(vec.shape)}")
    if Bl.shape != Bh.shape or vec.shape[0] != Bh.shape[axis]:
        raise ValueError(f"shape mismatch: Bh {tuple(Bh.shape)}, Bl "
                         f"{tuple(Bl.shape)}, vector {tuple(vec.shape)}")
    if Bl.device != Bh.device or vec.device != Bh.device:
        raise ValueError("Bh, Bl and the vector must lie on one device")
    if Bh.device.type not in ("cpu", "cuda"):
        raise ValueError(f"df64 passes run on cuda or cpu, not {Bh.device}")


def df64_bt_v_ref(Bh: torch.Tensor, Bl: torch.Tensor,
                  v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``df64_bt_v``: pairwise-tree reduction over
    all rows.  f64 (m,)."""
    vh, vl = df64.split_f64(v)
    return df64.join_f64(*df64.df64_dot_bv(Bh, Bl, vh, vl))


def df64_b_x_ref(Bh: torch.Tensor, Bl: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``df64_b_x``.  f64 (n,)."""
    xh, xl = df64.split_f64(x)
    return df64.join_f64(*df64.df64_dot_bx(Bh, Bl, xh, xl))


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of csrc/df64_gemv.cu on a loaded library."""
    lib.mlff_df64_bt_v.argtypes = ([ctypes.c_void_p] * 7
                                   + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.mlff_df64_bt_v.restype = ctypes.c_int
    lib.mlff_df64_b_x.argtypes = ([ctypes.c_void_p] * 4
                                  + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.mlff_df64_b_x.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    return _bind(cuda_build.load("df64_gemv"))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=16)
def _bt_v_scratch(index: int, stream: int, p: Plan) -> tuple:
    """(part_h, part_l, tickets) of one device, stream and plan: the f32
    partials of the slabs and, below them, of the tree's inner nodes, rows
    padded to a multiple of 4; and one ticket per column group and tree
    node.  The tickets are zeroed here once; the kernel leaves them zero."""
    dev = torch.device("cuda", index)
    part = torch.empty((2, p.n_slabs + p.tree_nodes - 1, -(-p.m // 4) * 4),
                       dtype=torch.float32, device=dev)
    tickets = torch.zeros(p.n_groups * p.tree_nodes, dtype=torch.int32,
                          device=dev)
    return part[0], part[1], tickets


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, contiguous and 16-byte aligned (a copy if it was not): the kernels
    copy 16-byte aligned row segments of B and read the vector in 16-byte
    words."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def df64_bt_v(Bh: torch.Tensor, Bl: torch.Tensor,
              v: torch.Tensor) -> torch.Tensor:
    """u = B^T v (f64 (m,)) for B (n, m) given as the f32 pair (Bh, Bl) and
    v (n,) f64.  CUDA tensors go through the kernel, CPU tensors through
    ``df64_bt_v_ref``.  Calls on one stream share their scratch."""
    _check(Bh, Bl, v, axis=0)
    if Bh.device.type == "cpu":
        return df64_bt_v_ref(Bh, Bl, v)
    n, m = Bh.shape
    dev = Bh.device
    if n == 0 or m == 0:
        return torch.zeros(m, dtype=torch.float64, device=dev)
    u = _launch_bt_v(_library(), _aligned(Bh), _aligned(Bl), _aligned(v))
    trace.count(LAUNCHES["bt_v"])
    return u


def _launch_bt_v(lib: ctypes.CDLL, Bh, Bl, v) -> torch.Tensor:
    (n, m), dev = Bh.shape, Bh.device
    p = plan(n, m, _sm_count(dev.index))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        part_h, part_l, tickets = _bt_v_scratch(dev.index, stream, p)
        u = torch.empty(m, dtype=torch.float64, device=dev)
        err = lib.mlff_df64_bt_v(
            Bh.data_ptr(), Bl.data_ptr(), v.data_ptr(), part_h.data_ptr(),
            part_l.data_ptr(), tickets.data_ptr(), u.data_ptr(), n, m,
            p.n_slabs, p.group_chunks, p.grid_bt_v, p.stages,
            int(p.bulk), stream)
    _raise_on(err, "df64_bt_v")
    return u


def df64_b_x(Bh: torch.Tensor, Bl: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """y = B x (f64 (n,)) for B (n, m) given as the f32 pair (Bh, Bl) and
    x (m,) f64.  CUDA tensors go through the kernel, CPU tensors through
    ``df64_b_x_ref``."""
    _check(Bh, Bl, x, axis=1)
    if Bh.device.type == "cpu":
        return df64_b_x_ref(Bh, Bl, x)
    n, m = Bh.shape
    dev = Bh.device
    if n == 0 or m == 0:
        return torch.zeros(n, dtype=torch.float64, device=dev)
    y = _launch_b_x(_library(), _aligned(Bh), _aligned(Bl), _aligned(x))
    trace.count(LAUNCHES["b_x"])
    return y


def _launch_b_x(lib: ctypes.CDLL, Bh, Bl, x) -> torch.Tensor:
    (n, m), dev = Bh.shape, Bh.device
    p = plan(n, m, _sm_count(dev.index))
    with torch.cuda.device(dev):
        y = torch.empty(n, dtype=torch.float64, device=dev)
        err = lib.mlff_df64_b_x(
            Bh.data_ptr(), Bl.data_ptr(), x.data_ptr(), y.data_ptr(), n, m,
            p.grid_b_x, p.stages, int(p.bulk),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "df64_b_x")
    return y


# each wrapper's kernel as torch.profiler names it: the __global__
# functions of csrc/df64_gemv.cu (their template argument follows)
KERNEL_NAMES = {"df64_bt_v": "bt_v_kernel", "df64_b_x": "b_x_kernel"}


def bound_seconds(n: int, m: int, f32_peak: float,
                  mem_rate: float) -> tuple[float, str]:
    """(least time, "operations" or "bytes") of one pass, either direction,
    over B (n, m) on a card with the given f32 peak (FLOP/s) and memory rate
    (bytes/s).  Operations: ``OPS_PER_ELEMENT`` f32 per element of B.
    Bytes: Bh and Bl read once, the f64 vector read and the f64 result
    written once."""
    t_ops = OPS_PER_ELEMENT * n * m / f32_peak
    t_bytes = (8.0 * n * m + 8.0 * (n + m)) / mem_rate
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
