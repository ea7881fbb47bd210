"""Multi-rank runs of the port's row-sharded operator on the CPU, for
``tests/test_torch_parallel.py`` and ``tests/test_torch_multiprocess.py``.

``run_group(world, scenarios)`` spawns ``world`` processes (``spawn``
start method) that join one gloo group through a file store, build the
mesh, run each ``(name, kwargs)`` (or ``(key, name, kwargs)``) scenario of
``SCENARIOS`` in order and return every rank's results (NumPy arrays and
plain values); ``start_groups`` starts several groups without waiting.
``backend="nccl"`` joins an NCCL group instead, rank r on card r, for the
card tests (``tests/test_torch_cuda.py``).  The module imports no JAX: the
spawned processes re-import it, and the port must run without JAX.  Each
rank takes one torch thread.
"""

from __future__ import annotations

import datetime
import functools
import os
import pickle
import shutil
import tempfile

import numpy as np


class Groups:
    """Groups started together (``start_groups``); ``results()`` waits for
    them and returns, per group, every rank's results."""

    def __init__(self, groups):
        import torch.multiprocessing as mp

        self.dir = tempfile.mkdtemp()
        self.ctxs = []
        for g, (world, scenarios, *options) in enumerate(groups):
            out = os.path.join(self.dir, str(g))
            os.mkdir(out)
            self.ctxs.append((world, out, mp.start_processes(
                functools.partial(_entry, **(options[0] if options else {})),
                args=(world, list(scenarios), out),
                nprocs=world, start_method="spawn", join=False)))

    def results(self) -> list:
        try:
            out = []
            for world, d, ctx in self.ctxs:
                while not ctx.join():
                    pass
                ranks = []
                for r in range(world):
                    with open(os.path.join(d, f"rank{r}.pkl"), "rb") as f:
                        ranks.append(pickle.load(f))
                out.append(ranks)
            return out
        finally:
            shutil.rmtree(self.dir, ignore_errors=True)


def start_groups(groups) -> Groups:
    """Start several groups at once, without waiting: ``groups`` is a list
    of ``(world, scenarios)`` or ``(world, scenarios, options)``, options a
    dict of ``_entry``'s keywords (``host_mesh``, ``backend``)."""
    return Groups(groups)


def run_groups(groups) -> list:
    """``start_groups(groups).results()``."""
    return start_groups(groups).results()


def run_group(world: int, scenarios, **options) -> list:
    """Every rank's results: a list (by rank) of {scenario name: result};
    ``options``: ``_entry``'s keywords."""
    return run_groups([(world, scenarios, options)])[0]


def _entry(rank, world, scenarios, outdir, host_mesh=False, backend="gloo"):
    """One rank: ``host_mesh`` builds ``make_host_mesh()`` (local groups of
    world // 2 ranks) in place of the row mesh; ``backend="nccl"`` puts rank
    r on card r."""
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    os.environ["LOCAL_WORLD_SIZE"] = str(max(1, world // 2))
    from mlff_tpu_torch.parallel import distributed as pdist
    from mlff_tpu_torch.parallel import mesh as pmesh

    # a file store in the group's own directory: no rendezvous port that
    # another group or test process could take
    pdist.init_distributed(backend=backend,
                           init_method="file://" + os.path.join(outdir,
                                                                "store"),
                           world_size=world, rank=rank,
                           timeout=datetime.timedelta(seconds=120))
    mesh = pdist.make_host_mesh() if host_mesh else pmesh.make_mesh()
    out = {}
    for item in scenarios:
        # (scenario, kwargs), or (result key, scenario, kwargs)
        key, name, kw = item if len(item) == 3 else (item[0],) + tuple(item)
        out[key] = SCENARIOS[name](mesh, **kw)
    with open(os.path.join(outdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# scenarios: each takes the mesh and NumPy inputs, returns NumPy results
# ---------------------------------------------------------------------------


def _cache(R, sig, lam, perms=None, pairwise=True, device="cpu"):
    import torch

    from mlff_tpu_torch.ops import descriptor as td
    from mlff_tpu_torch.ops import kernel as tk

    R = np.asarray(R)
    spec = td.make_spec(R.shape[1])
    X, Jc = td.descriptors_from_R(spec, torch.as_tensor(R))
    perms = np.arange(R.shape[1])[None] if perms is None else perms
    cache = tk.build_cache(X, Jc, td.incidence_matrix(spec),
                           td.desc_perms(np.asarray(perms)), sig, lam,
                           pairwise=pairwise, device=device)
    return spec, cache


def operator(mesh, R, v, V, sig=10.0, lam=1e-10, cols=()):
    """The sharded matvec (cached and on the fly), matmat, the diagonal and
    column assembly, each gathered whole; the local row counts."""
    import torch

    from mlff_tpu_torch.ops import kernel as tk
    from mlff_tpu_torch.parallel import mesh as pmesh

    spec, cache = _cache(R, sig, lam)
    _, otf = _cache(R, sig, lam, pairwise=False)
    sh = pmesh.shard_cache(cache, mesh)
    sh_otf = pmesh.shard_cache(otf, mesh)
    lay = tk.vector_layout(sh)
    v_loc = pmesh.shard_vector(torch.as_tensor(v), mesh)
    V_loc = lay.scatter(torch.as_tensor(V))
    out = {
        "matvec": pmesh.gather_vector(tk.matvec_psd(sh, v_loc), mesh).numpy(),
        "matvec_otf": pmesh.gather_vector(tk.matvec_psd(sh_otf, v_loc),
                                          mesh).numpy(),
        "matmat": lay.gather(tk.matmat_psd(sh, V_loc)).numpy(),
        "diag": lay.gather(tk.kernel_diag_any(spec, sh)).numpy(),
        "rows_A_exp": int(sh.A_exp.shape[0]),
        "rows_X": int(sh.X.shape[0]),
        "world": int(sh.shard.world),
    }
    for i, c in enumerate(cols):
        out[f"cols{i}"] = lay.gather(tk.assemble_columns(
            spec, sh, np.asarray(c))).numpy()
    return out


def column_routes(mesh, R, cols, col, sig=10.0, lam=1e-10):
    """The column routes the large-molecule rule picks, called directly on
    a small molecule's row-sharded cache with the square fields:
    compressed, compressed-grouped, square (with and without the per-point
    projections), single columns and the compressed diagonal."""
    import dataclasses

    import torch

    from mlff_tpu_torch.ops import descriptor as td
    from mlff_tpu_torch.ops import kernel as tk
    from mlff_tpu_torch.parallel import mesh as pmesh

    R = np.asarray(R)
    spec = td.make_spec(R.shape[1])
    X, Jc = td.descriptors_from_R(spec, torch.as_tensor(R))
    cache = tk.build_cache(X, Jc, td.incidence_matrix(spec),
                           td.desc_perms(np.arange(R.shape[1])[None]), sig,
                           lam, R=R, device="cpu")
    sh = pmesh.shard_cache(cache, mesh)
    lay = tk.vector_layout(sh)
    c = np.asarray(cols)
    g = torch.as_tensor([col])
    return {name: lay.gather(fn()).numpy() for name, fn in (
        ("compressed", lambda: tk.assemble_columns_compressed(spec, sh, c)),
        ("compressed_grouped",
         lambda: tk.assemble_columns_compressed_grouped(spec, sh, c)),
        ("square", lambda: tk.assemble_columns_square(spec, sh, c)),
        ("square_no_projections", lambda: tk.assemble_columns_square(
            spec, dataclasses.replace(sh, Usq=None, Zsq=None, C1sq=None),
            c)),
        ("column", lambda: tk.kernel_column(spec.dim_i, sh, g)),
        ("column_compressed",
         lambda: tk.kernel_column_compressed(spec.dim_i, sh, g)),
        ("diag_compressed",
         lambda: tk.kernel_diag_compressed(spec.dim_i, sh)))}


def uneven(mesh, R, sig=10.0, lam=1e-10):
    """shard_cache of an N that does not divide over the ranks."""
    from mlff_tpu_torch.parallel import mesh as pmesh

    _, cache = _cache(R, sig, lam)
    try:
        pmesh.shard_cache(cache, mesh)
    except ValueError as e:
        return "ValueError: " + str(e)
    return "no error"


def precon(mesh, L, v, lam):
    """A split and a column-blocked Woodbury operator placed on the mesh,
    and the split operator of a row-sharded factor; applies gathered."""
    import torch

    from mlff_tpu_torch.solvers import preconditioners as tpc
    from mlff_tpu_torch.parallel import mesh as pmesh

    L = torch.as_tensor(L)
    v_loc = pmesh.shard_vector(torch.as_tensor(v), mesh)
    P = tpc.woodbury_from_factor(L, lam)
    P_sh = pmesh.shard_preconditioner(P, mesh)
    Bs = (P.B[:, :64].clone(), P.B[:, 64:].clone())
    P_cb = tpc.WoodburyColBlockPreconditioner(Bs=Bs, W2=P.W2, lam=P.lam,
                                              info={})
    P_cb_sh = pmesh.shard_preconditioner(P_cb, mesh)
    lay = P_sh.layout
    P_fac = tpc.woodbury_from_factor(lay.scatter(L), lam, lay)
    P_df = pmesh.shard_preconditioner(tpc.df64_from_split(
        tpc.woodbury_from_factor(L, lam)), mesh)
    return {
        "split": pmesh.gather_vector(P_sh(v_loc), mesh).numpy(),
        "colblock": pmesh.gather_vector(P_cb_sh(v_loc), mesh).numpy(),
        "factor": pmesh.gather_vector(P_fac(v_loc), mesh).numpy(),
        "df64": pmesh.gather_vector(P_df(v_loc), mesh).numpy(),
        "rows_B": int(P_sh.B.shape[0]),
        "rows_Bs": [int(B.shape[0]) for B in P_cb_sh.Bs],
        "rows_W2": int(P_sh.W2.shape[0]),
    }


def df64_build(mesh, R, v, n_inducing, sig=10.0, lam=1e-10):
    """The solve's df64 builds (greedy Cholesky and Nystrom) on the sharded
    cache and on the unsharded one, with the component rule's limit set
    between this rank's factor bytes and the whole factor's: the number of
    components each builds, and the applies gathered."""
    import torch

    from mlff_tpu_torch.parallel import mesh as pmesh
    from mlff_tpu_torch.solvers import iterative as tit
    from mlff_tpu_torch.solvers import preconditioners as tpc

    spec, cache = _cache(R, sig, lam)
    sh = pmesh.shard_cache(cache, mesh)
    v_t = torch.as_tensor(v)
    k = n_inducing * spec.dim_i
    out = {}
    limit = tpc.DF64_TRANSIENT_BYTES
    try:
        for strategy in ("cholesky", "lev_random"):
            def build(c):
                return tit.build_preconditioner(
                    spec, c, strategy, k, lam, np.random.default_rng(5),
                    task={"apply_impl": "df64"}, n_inducing_pts=n_inducing)[0]

            tpc.DF64_TRANSIENT_BYTES = limit
            m_pad = build(cache).Bh.shape[1]
            # the whole factor's transient reaches the limit, a rank's not
            tpc.DF64_TRANSIENT_BYTES = 20 * v_t.shape[0] * m_pad
            P, P_sh = build(cache), build(sh)
            out[strategy] = {
                "components": (P.info["components"],
                               P_sh.info["components"]),
                "apply": P(v_t).numpy(),
                "apply_mesh": pmesh.gather_vector(
                    P_sh(P_sh.layout.scatter(v_t)), mesh).numpy()}
    finally:
        tpc.DF64_TRANSIENT_BYTES = limit
    return out


def square_matvec(mesh, R, perms, v, sig=10.0, lam=1e-10):
    import torch

    from mlff_tpu_torch.ops import kernel as tk
    from mlff_tpu_torch.parallel import mesh as pmesh

    sq = tk.build_cache_square(R, perms, sig, lam, device="cpu")
    sq_sh = pmesh.shard_square_cache(sq, mesh)
    v_loc = pmesh.shard_vector(torch.as_tensor(v), mesh)
    return {"matvec": pmesh.gather_vector(tk.matvec_psd_square(sq_sh, v_loc),
                                          mesh).numpy(),
            "rows_Gst": int(sq_sh.Gst.shape[0])}


def train(mesh, task, **kw):
    """Trainer(device="cpu").train(task, mesh=mesh, **kw): the model's
    arrays and scalars of interest."""
    from mlff_tpu_torch.models.gdml import Trainer

    tr = Trainer(device="cpu")
    m = tr.train(dict(task), mesh=mesh, **kw)
    nys = tr.last_info.get("nystrom", {})
    keys = ("alphas_F", "alphas_E", "solver_iters", "is_conv",
            "inducing_pts_idxs", "num_restarts", "R_d_desc_alpha", "c")
    out = {k: np.asarray(m[k]) for k in keys if k in m}
    out["gram_guard_fired"] = bool(nys.get("gram_guard_fired", False))
    out["pivots"] = np.asarray(tr.last_info.get("pivots", []))
    return out


def predict(mesh, model, R, ds_R, ds_F, ds_E, n_points=30):
    from mlff_tpu_torch.models.evaluate import evaluate
    from mlff_tpu_torch.models.predict import Predictor

    pred = Predictor(model, device="cpu", mesh=mesh, fast=True)
    E, F = pred.predict(R)
    E3, F3 = pred.predict(R[:3])
    res = evaluate(model, {"R": ds_R, "F": ds_F, "E": ds_E},
                   n_points=n_points, device="cpu", mesh=mesh)
    return {"E": E, "F": F, "E3": E3, "F3": F3, "eval": res.as_dict(),
            "fast": pred.fast}


def pcg(mesh, R, v, idxs, sig=10.0, lam=1e-10, tol=1e-6):
    """The counterpart of tests/dcn_worker.py: the sharded matvec against
    the rank's own unsharded oracle, and PCG through the sharded operator
    with a Nystrom preconditioner built on the unsharded cache and placed
    on the mesh, against the unsharded solve."""
    import functools

    import torch

    from mlff_tpu_torch.ops import kernel as tk
    from mlff_tpu_torch.parallel import mesh as pmesh
    from mlff_tpu_torch.solvers import preconditioners as tpc
    from mlff_tpu_torch.solvers.cg import pcg as tpcg

    spec, cache = _cache(R, sig, lam)
    sh = pmesh.shard_cache(cache, mesh)
    lay = tk.vector_layout(sh)
    v_t = torch.as_tensor(v)
    out = pmesh.gather_vector(tk.matvec_psd(sh, lay.scatter(v_t)), mesh)
    ref = tk.matvec_psd(cache, v_t)
    P = tpc.nystrom_preconditioner(spec, cache, idxs, lam)
    P_sh = pmesh.shard_preconditioner(P, mesh)
    res_sh = tpcg(functools.partial(tk.matvec_psd, sh), lay.scatter(v_t),
                  precon=P_sh, tol=tol, maxiter=500, layout=lay)
    res = tpcg(functools.partial(tk.matvec_psd, cache), v_t, precon=P,
               tol=tol, maxiter=500)
    r = tk.matvec_psd(cache, torch.as_tensor(res_sh.x)) - v_t
    return {"matvec": out.numpy(), "ref": ref.numpy(),
            "iters_sh": res_sh.num_iters, "iters": res.num_iters,
            "conv": (res_sh.converged, res.converged),
            "true_resid": float(torch.linalg.norm(r)),
            "v_norm": float(torch.linalg.norm(v_t)),
            "mesh_shape": tuple(mesh.mesh.shape)}


def ecstr_operator(mesh, R, perms, v, idxs, idxs_any, k, sig=10.0,
                   lam=1e-10):
    """The energy-constrained (n + N) system on the mesh: matvec, diagonal,
    columns, the Nystrom apply and the greedy / panel / block-RP factors,
    gathered whole (vectors in the global order [forces, energies])."""
    import torch

    from mlff_tpu_torch.ops import kernel as tk
    from mlff_tpu_torch.parallel import mesh as pmesh
    from mlff_tpu_torch.solvers import pivoted_cholesky as tpch
    from mlff_tpu_torch.solvers import preconditioners as tpc

    spec, cache = _cache(R, sig, lam, perms)
    sh = pmesh.shard_cache(cache, mesh)
    lay = tk.vector_layout(sh, use_E_cstr=True)
    v_loc = lay.scatter(torch.as_tensor(v))
    P = tpc.nystrom_preconditioner(spec, sh, idxs, lam, use_E_cstr=True)
    out = {
        "matvec": lay.gather(tk.matvec_psd_ecstr(sh, v_loc)).numpy(),
        "diag": lay.gather(tk.kernel_diag_ecstr(spec.dim_i, sh)).numpy(),
        "cols": lay.gather(tk.assemble_columns_ecstr(spec, sh, idxs)).numpy(),
        "cols_any": lay.gather(tk.assemble_columns_ecstr_any(
            spec, sh, idxs_any)).numpy(),
        "apply": lay.gather(P(v_loc)).numpy(),
    }
    for name, fn in (("greedy", tpch.pivoted_cholesky),
                     ("panel", tpch.panel_pivoted_cholesky),
                     ("rp", tpch.block_rp_cholesky)):
        res, _ = fn(spec, sh, k, use_E_cstr=True)
        out[name + "_pivots"] = res.pivots.numpy()
        out[name + "_L"] = lay.gather(res.L).numpy()
    return out


def otf_matvec(mesh, R, perms, v, sig=10.0, lam=1e-10):
    """The on-the-fly matvec on a row-sharded cache built as the Trainer
    builds it, (K + lam I) v gathered whole; and, while recording, what a
    sharded on-the-fly and a sharded cached matvec leave: the
    ``matvec.otf`` spans, the tiles counted, the ``mesh.collective`` spans
    and every synchronize the tracer made."""
    import torch

    from mlff_tpu_torch.ops import kernel as tk
    from mlff_tpu_torch.parallel import mesh as pmesh
    from mlff_tpu_torch.utils import trace

    _, otf = _cache(R, sig, lam, perms, pairwise=False)
    _, cached = _cache(R, sig, lam, perms)
    out = {}
    synced = []
    real_sync = trace._sync
    trace._sync = synced.append
    try:
        for route, cache in (("otf", otf), ("cached", cached)):
            sh = pmesh.shard_cache(cache, mesh)
            v_loc = tk.vector_layout(sh).scatter(torch.as_tensor(v))
            with trace.recording() as rec:
                Kv = tk.matvec_psd(sh, v_loc)
            out[route] = {
                "matvec": pmesh.gather_vector(Kv, mesh).numpy(),
                "otf_spans": len(rec.named("matvec.otf")),
                "otf_tiles": rec.counted(tk.OTF_TILES),
                "collective_spans": len(rec.named("mesh.collective")),
                "collectives": rec.counted("mesh.collectives")}
    finally:
        trace._sync = real_sync
    out["synced"] = [str(d) for d in synced]
    return out


def train_otf(mesh, task, **kw):
    """``train``, recorded, with the cache-layout rule
    (``ops/kernel.py::pairwise_fits``) sending every cache to the on-the-fly
    matvec: the model's arrays (``R_desc`` too), the ``matvec.otf`` spans
    and tiles of the training, its ``precon.apply`` spans with the
    collectives opened inside them, and the host-LAPACK factors of its
    Nystrom builds that this rank computed."""
    from mlff_tpu_torch.models.gdml import Trainer
    from mlff_tpu_torch.ops import kernel as tk
    from mlff_tpu_torch.solvers import preconditioners as tpc
    from mlff_tpu_torch.utils import trace

    real = tk.pairwise_fits
    host_fns = {f: getattr(tpc, f) for f in ("_host_whiten_factor",
                                             "_host_inner_isqrt")}
    factored = []

    def counted(f):
        def fn(*a, **k):
            factored.append(f)
            return host_fns[f](*a, **k)
        return fn

    tk.pairwise_fits = lambda n_train, n_perms: False
    for f in host_fns:
        setattr(tpc, f, counted(f))
    try:
        with trace.recording() as rec:
            m = Trainer(device="cpu").train(dict(task), mesh=mesh, **kw)
    finally:
        tk.pairwise_fits = real
        for f, fn in host_fns.items():
            setattr(tpc, f, fn)
    out = {k: np.asarray(m[k]) for k in ("alphas_F", "R_desc",
                                         "R_d_desc_alpha", "solver_iters",
                                         "is_conv")}
    out["otf_spans"] = len(rec.named("matvec.otf"))
    out["otf_tiles"] = rec.counted(tk.OTF_TILES)
    applies = {s.id for s in rec.named("precon.apply")}
    out["apply_spans"] = len(applies)
    out["apply_collectives"] = sum(1 for s in rec.named("mesh.collective")
                                   if s.parent in applies)
    out["host_factors"] = factored
    return out


def otf_pcg(mesh, R, perms, b, idxs, sig=10.0, lam=1e-5, tol=1e-8):
    """PCG on a row-sharded on-the-fly cache on this rank's device (its
    card under NCCL), with a Nystrom preconditioner built on the CPU's
    whole cache and placed on the mesh: the iterations, the solution
    gathered whole, and the captures and replayed iterations counted; on
    rank 0 the same for the solve on the whole cache, on its one device."""
    import dataclasses

    import torch

    from mlff_tpu_torch.ops import kernel as tk
    from mlff_tpu_torch.parallel import mesh as pmesh
    from mlff_tpu_torch.solvers import cg as tcg
    from mlff_tpu_torch.solvers import preconditioners as tpc
    from mlff_tpu_torch.utils import trace

    dev = pmesh.row_shard(mesh).device
    spec, cpu = _cache(R, sig, lam, perms, pairwise=False)
    _, whole = _cache(R, sig, lam, perms, pairwise=False, device=dev)
    P_cpu = tpc.nystrom_preconditioner(spec, cpu, np.asarray(idxs), lam)
    P = dataclasses.replace(P_cpu, B=P_cpu.B.to(dev), W2=P_cpu.W2.to(dev))
    b = torch.as_tensor(b, device=dev)

    def solved(cache, P, b, layout=None):
        before = (trace.counter(tcg.GRAPH_CAPTURES),
                  trace.counter(tcg.GRAPH_ITERS))
        res = tcg.pcg(lambda u: tk.matvec_psd(cache, u), b, precon=P,
                      tol=tol, layout=layout)
        return {"iters": res.num_iters, "converged": res.converged,
                "x": res.x,
                "captures": trace.counter(tcg.GRAPH_CAPTURES) - before[0],
                "replayed": trace.counter(tcg.GRAPH_ITERS) - before[1]}

    sh = pmesh.shard_cache(whole, mesh)
    lay = tk.vector_layout(sh)
    out = {"sharded": solved(sh, pmesh.shard_preconditioner(P, mesh),
                             lay.scatter(b), lay),
           "backend": sh.shard.backend}
    if sh.shard.rank == 0:
        out["whole"] = solved(whole, P, b)
    return out


SCENARIOS = {f.__name__: f for f in (operator, column_routes, uneven, precon,
                                     df64_build, square_matvec, train, predict, pcg,
                                     ecstr_operator, otf_matvec, train_otf,
                                     otf_pcg)}
