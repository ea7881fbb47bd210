"""Command-line interface: create / train / resume / validate / select / test
/ show / reset / all.

PyTorch port of ``mlff_tpu.cli`` (reference: sgdml/cli.py:421-529 `all`,
533-728 `create`, 729-846 `train`, 868-962 `resume`, 1001-1360
`validate`/`test`, 1443+ `select`, 1700-1731 verb table): the same verbs,
arguments, defaults and file names.  Model and task files are flat npz dicts
that either package's CLI reads.  One argument is added, ``--device``
(default ``cuda``) for the verbs that train or predict; without a card they
raise unless it is ``cpu``.

    python -m mlff_tpu_torch.cli all dataset.npz 200 --sig 10 20 --solver cg
"""

from __future__ import annotations

import argparse
import shutil
import sys
from pathlib import Path

import numpy as np

from . import resolve_device
from .models.evaluate import evaluate, select_model, validate
from .models.gdml import Trainer
from .models.task import create_task, create_task_from_model
from .utils import io, ui
from .utils.log import get_logger

log = get_logger("mlff_tpu_torch.cli")


def cmd_create(args) -> Path:
    dataset = io.load_dataset(args.dataset)
    valid_dataset = io.load_dataset(args.valid_dataset) if args.valid_dataset else dataset

    sigs = args.sig or list(range(10, 110, 10))  # reference default sigma grid
    task_dir = None
    for sig in sigs:
        task = create_task(
            dataset, args.n_train, valid_dataset, args.n_valid,
            sig=sig, lam=args.lam, use_sym=not args.gdml,
            use_E=not args.no_E, use_E_cstr=args.E_cstr,
            use_cprsn=args.cprsn, solver=args.solver,
            solver_tol=args.tol,
        )
        if task_dir is None:
            # one shared directory for the whole sigma sweep (the per-task
            # name embeds sig, which would scatter the sweep across dirs)
            n_perms = task["perms"].shape[0]
            task_dir = Path(
                args.task_dir
                or "{}-train{}-sym{}".format(
                    task["dataset_name"], args.n_train, n_perms
                )
            )
            task_dir.mkdir(parents=True, exist_ok=True)
        out = task_dir / f"task-sig{sig:04g}.npz"
        np.savez_compressed(out, **_npzable(task))
        log.info("wrote %s", out)
    return task_dir


def _npzable(d: dict) -> dict:
    return {
        k: (np.asarray("None") if v is None else v)
        for k, v in d.items()
        if not isinstance(v, dict)
    }


def _load_task(path) -> dict:
    with np.load(path, allow_pickle=True) as f:
        task = {k: f[k] for k in f.files}
    for k in ("dataset_name", "dataset_theory", "md5_train", "md5_valid",
              "solver_name"):
        if k in task and task[k].ndim == 0:
            task[k] = str(task[k].astype(str))
    for k in ("sig", "lam", "solver_tol"):
        if k in task:
            task[k] = float(task[k])
    for k in ("use_E", "use_E_cstr", "use_sym", "use_cprsn"):
        if k in task:
            task[k] = bool(task[k])
    for k in ("n_inducing_pts_init",):
        if k in task:
            task[k] = int(task[k])
    ico = task.get("interact_cut_off")
    if ico is not None and (getattr(ico, "ndim", 0) == 0):
        task["interact_cut_off"] = None if str(ico) == "None" else float(ico)
    return task


def cmd_train(args):
    paths = sorted(Path(args.task_dir).glob("task-*.npz")) \
        if Path(args.task_dir).is_dir() else [Path(args.task_dir)]
    trainer = Trainer(device=args.device)
    model_paths = []
    for p in paths:
        task = _load_task(p)
        unconv_path = p.parent / (p.stem + "_unconv_model.npz")

        def save_progress(model):
            io.save_model(unconv_path, _npzable(model))

        prog = ui.SolverProgress(tol=float(task.get("solver_tol", 1e-4)),
                                 label=p.stem)
        model = trainer.train(
            task,
            break_percentage=args.break_percentage,
            str_preconditioner=args.preconditioner,
            save_progr_callback=save_progress,
            callback=prog,
        )
        prog.close(converged=bool(model.get("is_conv", True)))
        out = p.parent / (p.stem.replace("task", "model") + ".npz")
        io.save_model(out, _npzable(model))
        unconv_path.unlink(missing_ok=True)  # reference cli.py:808-811
        model_paths.append(out)
        log.info("wrote %s", out)
    return model_paths


def cmd_resume(args):
    model = io.load_model(args.model)
    dataset = io.load_dataset(args.dataset)
    stored = str(np.asarray(model["md5_train"]).astype(str))
    if stored != io.dataset_md5(dataset):
        raise ValueError("dataset fingerprint does not match the model")
    task = create_task_from_model(model, dataset)
    task["solver_name"] = "cg"
    model2 = Trainer(device=args.device).train(
        task, break_percentage=args.break_percentage,
        str_preconditioner=args.preconditioner,
    )
    out = Path(args.model).with_suffix(".resumed.npz")
    io.save_model(out, _npzable(model2))
    log.info("wrote %s", out)
    return out


def cmd_validate(args):
    model = io.load_model(args.model)
    dataset = io.load_dataset(args.dataset)
    res = validate(model, dataset, device=args.device)
    _print_errors("validation", res)
    return res


def cmd_test(args):
    model = io.load_model(args.model)
    dataset = io.load_dataset(args.dataset)
    res = evaluate(model, dataset, n_points=args.n_test, device=args.device)
    _print_errors("test", res)
    return res


def _print_errors(tag, res):
    print(f"[{tag}] n={res.n_points}")
    print(f"  forces    MAE {res.f_mae:.6f}  RMSE {res.f_rmse:.6f}")
    print(f"  magnitude MAE {res.mag_mae:.6f}  RMSE {res.mag_rmse:.6f}")
    print(f"  cosine    MAE {res.cos_mae:.6f}  RMSE {res.cos_rmse:.6f}")
    if not np.isnan(res.e_mae):
        print(f"  energy    MAE {res.e_mae:.6f}  RMSE {res.e_rmse:.6f}")


def cmd_select(args):
    paths = sorted(Path(args.model_dir).glob("model-*.npz"))
    models = [io.load_model(p) for p in paths]
    dataset = io.load_dataset(args.dataset)
    best, results = select_model(models, dataset, device=args.device)
    best_path = Path(args.model_dir) / "best_model.npz"
    shutil.copy(paths[best], best_path)
    log.info("selected %s -> %s", paths[best], best_path)
    return best_path


def cmd_show(args):
    with np.load(args.file, allow_pickle=True) as f:
        d = {k: f[k] for k in f.files}
    kind = str(np.asarray(d.get("type", "?")).astype(str))
    names = {"d": "dataset", "t": "task", "m": "model"}
    print(f"{names.get(kind, 'unknown')} file: {args.file}")
    for k in sorted(d):
        v = d[k]
        desc = f"array{v.shape} {v.dtype}" if getattr(v, "ndim", 0) else v
        print(f"  {k}: {desc}")


def cmd_reset(args):
    p = Path(args.task_dir)
    if p.is_dir():
        shutil.rmtree(p)
        log.info("removed %s", p)


def cmd_all(args):
    """create -> train -> select -> test pipeline (reference cli.py:421-529)."""
    task_dir = cmd_create(args)
    args.task_dir = task_dir
    cmd_train(args)
    args.model_dir = task_dir
    best = cmd_select(args)
    args.model = best
    args.n_test = args.n_test or -1
    return cmd_test(args)


def main(argv=None):
    p = argparse.ArgumentParser(prog="mlff-tpu-torch",
                                description="sGDML training on a CUDA card")
    sub = p.add_subparsers(dest="command", required=True)

    def device_arg(sp):
        sp.add_argument("--device", default="cuda",
                        help="torch device to train and predict on")

    def common_train(sp):
        sp.add_argument("--break-percentage", type=float, default=0.1,
                        help="preconditioner strength k/n")
        sp.add_argument("--preconditioner", default="random_scores")
        device_arg(sp)

    sp = sub.add_parser("create")
    sp.add_argument("dataset")
    sp.add_argument("n_train", type=int)
    sp.add_argument("--valid-dataset")
    sp.add_argument("--n-valid", type=int, default=100)
    sp.add_argument("--sig", type=float, nargs="*")
    sp.add_argument("--lam", type=float, default=1e-15)
    sp.add_argument("--solver", default="analytic",
                    choices=["analytic", "cg", "cg_cholesky"])
    sp.add_argument("--tol", type=float, default=1e-4)
    sp.add_argument("--gdml", action="store_true", help="disable symmetries")
    sp.add_argument("--no-E", action="store_true")
    sp.add_argument("--E-cstr", action="store_true")
    sp.add_argument("--cprsn", action="store_true")
    sp.add_argument("--task-dir")
    sp.set_defaults(fn=cmd_create)

    sp = sub.add_parser("train")
    sp.add_argument("task_dir")
    common_train(sp)
    sp.set_defaults(fn=cmd_train)

    sp = sub.add_parser("resume")
    sp.add_argument("model")
    sp.add_argument("dataset")
    common_train(sp)
    sp.set_defaults(fn=cmd_resume)

    sp = sub.add_parser("validate")
    sp.add_argument("model")
    sp.add_argument("dataset")
    device_arg(sp)
    sp.set_defaults(fn=cmd_validate)

    sp = sub.add_parser("test")
    sp.add_argument("model")
    sp.add_argument("dataset")
    sp.add_argument("--n-test", type=int, default=-1)
    device_arg(sp)
    sp.set_defaults(fn=cmd_test)

    sp = sub.add_parser("select")
    sp.add_argument("model_dir")
    sp.add_argument("dataset")
    device_arg(sp)
    sp.set_defaults(fn=cmd_select)

    sp = sub.add_parser("show")
    sp.add_argument("file")
    sp.set_defaults(fn=cmd_show)

    sp = sub.add_parser("reset")
    sp.add_argument("task_dir")
    sp.set_defaults(fn=cmd_reset)

    sp = sub.add_parser("all")
    sp.add_argument("dataset")
    sp.add_argument("n_train", type=int)
    sp.add_argument("--valid-dataset")
    sp.add_argument("--n-valid", type=int, default=100)
    sp.add_argument("--sig", type=float, nargs="*")
    sp.add_argument("--lam", type=float, default=1e-15)
    sp.add_argument("--solver", default="analytic",
                    choices=["analytic", "cg", "cg_cholesky"])
    sp.add_argument("--tol", type=float, default=1e-4)
    sp.add_argument("--gdml", action="store_true")
    sp.add_argument("--no-E", action="store_true")
    sp.add_argument("--E-cstr", action="store_true")
    sp.add_argument("--cprsn", action="store_true")
    sp.add_argument("--task-dir")
    sp.add_argument("--n-test", type=int, default=-1)
    common_train(sp)
    sp.set_defaults(fn=cmd_all)

    args = p.parse_args(argv)
    if "device" in args:
        # a missing card stops the verb before it writes anything
        args.device = resolve_device(args.device)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(0 if main() is not None else 1)
