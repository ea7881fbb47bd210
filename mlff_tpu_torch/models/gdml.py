"""Training orchestration: the 'cg' solver, label normalization, model
creation, integration-constant recovery.

PyTorch port of the main slice of ``mlff_tpu.models.gdml`` (reference:
sgdml/train.py:707-1119).  A ``Trainer`` is a plain object bound to one
device (cuda by default).  ``lam`` is bumped from the task's 1e-15 to 1e-10
for the CG solver (reference train.py:865-866, 910-911); labels are
normalized by their standard deviation (train.py:835-845).  The model dict
has the JAX package's keys and sign convention (``alphas_F = -alpha_psd``),
so npz model files are interchangeable between the two packages.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import __version__, resolve_device, synchronize
from ..ops import descriptor as dsc
from ..ops import kernel as knl
from ..solvers.iterative import solve_iterative
from ..utils.log import get_logger
from .predict import Predictor

log = get_logger(__name__)

CG_LAM = 1e-10  # reference train.py:865-866


def _tril_perms_lin(perms: np.ndarray) -> np.ndarray:
    """Reference-format flattened descriptor-permutation index array
    (train.py:783-790): column-major flatten of desc_perms + per-perm offsets."""
    tril_perms = dsc.desc_perms(perms)
    n_perms, dim_d = tril_perms.shape
    perm_offsets = np.arange(n_perms)[:, None] * dim_d
    return (tril_perms + perm_offsets).flatten("F")


class Trainer:
    """Train (s)GDML force-field models from task dicts on ``device``.

    ``last_info`` holds the full solver info of the latest ``train`` call,
    including the Nyström build diagnostics (``last_info["nystrom"]``:
    whether the Gram guard fired, its probe error, stage times)."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.last_info: dict = {}

    # -- building blocks ---------------------------------------------------

    def build_kernel_inputs(self, task: dict):
        """Descriptors, Jacobians and kernel metadata for a task, on the
        trainer's device: (spec, S, X, Jc, P_idx)."""
        n_atoms = np.asarray(task["R_train"]).shape[1]
        spec = dsc.make_spec(n_atoms)
        dev = self.device
        S = dsc.incidence_matrix(spec, device=dev)

        lat_and_inv = None
        if "lattice" in task:
            lat = np.asarray(task["lattice"], dtype=np.float64)
            lat_and_inv = (torch.as_tensor(lat, device=dev),
                           torch.as_tensor(np.linalg.inv(lat), device=dev))

        R = torch.as_tensor(np.asarray(task["R_train"], dtype=np.float64),
                            device=dev)
        cut = task.get("interact_cut_off")
        cut = None if cut is None or (isinstance(cut, float) and np.isnan(cut)) else float(cut)
        X, Jc = dsc.descriptors_from_R(spec, R, lat_and_inv=lat_and_inv,
                                       interact_cut_off=cut)
        P_idx = torch.as_tensor(dsc.desc_perms(np.asarray(task["perms"])),
                                dtype=torch.int64, device=dev)
        return spec, S, X, Jc, P_idx

    def labels(self, task: dict):
        """Normalized force labels (train.py:835-845)."""
        y = np.asarray(task["F_train"], dtype=np.float64).ravel().copy()
        y_std = float(np.std(y))
        return y / y_std, y_std

    @staticmethod
    def _pairwise_fits(n_train: int, n_perms: int) -> bool:
        """Whether the two (N, M) f64 pairwise caches fit (<= 3 GB), the JAX
        package's switch to its on-the-fly matvec."""
        return 2 * n_train * n_train * n_perms * 8 <= int(3e9)

    # -- main entry --------------------------------------------------------

    def train(
        self,
        task: dict,
        break_percentage: float | None = 0.1,
        n_columns: int | None = None,
        str_preconditioner: str = "random_scores",
        flag_eigvals: bool = False,
        callback=None,
        save_progr_callback=None,
        allow_restarts: bool = False,
    ) -> dict:
        """Train a model for the task with the 'cg' solver
        (reference train.py:707-970)."""
        task = dict(task)
        solver = str(task["solver_name"])
        if solver != "cg":
            raise NotImplementedError(
                f"solver {solver!r}: the analytic and cg_cholesky solvers are "
                "ROADMAP module item 9")
        if task.get("use_E_cstr"):
            raise NotImplementedError(
                "energy-constrained training is ROADMAP module item 10")

        t_setup = time.perf_counter()
        spec, S, X, Jc, P_idx = self.build_kernel_inputs(task)
        y, y_std = self.labels(task)
        log.info("train setup (descriptors+labels): %.2fs",
                 time.perf_counter() - t_setup)

        if n_columns is not None:
            break_percentage = n_columns / len(y)
        if break_percentage is not None and not 0 <= break_percentage <= 1:
            raise ValueError(f"break_percentage {break_percentage} not in [0, 1]")
        if not self._pairwise_fits(X.shape[0], P_idx.shape[0]):
            raise NotImplementedError(
                "kernel caches above 3 GB need the on-the-fly matvec, ROADMAP "
                "module item 10")

        task["lam"] = CG_LAM  # stronger ridge for the iterative path
        t_cache = time.perf_counter()
        cache = knl.build_cache(X, Jc, S, P_idx, float(task["sig"]), CG_LAM,
                                device=self.device)
        synchronize(self.device)
        cache_build_s = time.perf_counter() - t_cache
        log.info("kernel cache build: %.2fs", cache_build_s)
        res = solve_iterative(
            spec, cache, task, y, y_std,
            break_percentage=break_percentage,
            str_preconditioner=str_preconditioner,
            flag_eigvals=flag_eigvals,
            callback=callback,
            save_progr_callback=self._wrap_ckpt(save_progr_callback, task, X,
                                                Jc, y, y_std),
            allow_restarts=allow_restarts,
        )
        del cache
        info_solver = dict(res.info, cache_build_s=cache_build_s)
        self.last_info = info_solver
        if not res.is_conv:
            log.warning(
                "Iterative solver did not converge; continuing with the "
                "unconverged model (accuracy will likely be bad).")

        t_model = time.perf_counter()
        # model boundary: reference sign convention
        alphas_F_ref = -res.alphas
        X_np, Jc_np = X.cpu().numpy(), Jc.cpu().numpy()
        model = self.create_model(
            task, solver, X_np, Jc_np, y_std, alphas_F_ref,
            solver_resid=res.resid, solver_iters=res.num_iters,
            norm_y_train=float(np.linalg.norm(y)),
            inducing_pts_idxs=res.inducing_pts_idxs,
        )
        model.update(
            {k: v for k, v in info_solver.items()
             if isinstance(v, (int, float, bool, np.ndarray))})

        if model["use_E"]:
            c = self._recov_int_const(model, task)
            if c is None:
                model["use_E"] = False
            else:
                model["c"] = c

        model["finalize_s"] = time.perf_counter() - t_model
        log.info("model finalize: %.2fs", model["finalize_s"])
        return model

    # -- model record ------------------------------------------------------

    def create_model(
        self, task, solver, R_desc, R_d_desc, std, alphas_F,
        alphas_E=None, solver_resid=None, solver_iters=None,
        norm_y_train=None, inducing_pts_idxs=None,
    ) -> dict:
        """Assemble the trained-model record (reference train.py:597-702);
        ``R_desc`` (N, D) and ``R_d_desc`` (N, D, 3) are NumPy arrays."""
        n_train = R_desc.shape[0]
        n_atoms = int(np.asarray(task["z"]).shape[0])
        spec = dsc.make_spec(n_atoms)
        S = dsc.incidence_matrix(spec).numpy()

        if "cprsn_keep_atoms_idxs" in task:
            # symmetry-compressed coefficients: contract against the kept
            # atoms' Jacobian columns only (reference train.py:616-634)
            keep = np.asarray(task["cprsn_keep_atoms_idxs"])
            Jfull = np.einsum("qa,kqx->kqax", S, np.asarray(R_d_desc))
            a3 = np.asarray(alphas_F).reshape(n_train, len(keep), 3)
            r_d_desc_alpha = np.einsum("kqax,kax->kq", Jfull[:, :, keep, :], a3)
        else:
            r_d_desc_alpha = dsc.d_desc_dot_vec(
                torch.as_tensor(R_d_desc), torch.as_tensor(S),
                torch.as_tensor(np.asarray(alphas_F).reshape(n_train, n_atoms, 3)),
            ).numpy()

        model = {
            "type": "m",
            "code_version": __version__,
            "dataset_name": task["dataset_name"],
            "dataset_theory": task["dataset_theory"],
            "solver_name": solver,
            "solver_tol": task["solver_tol"],
            "norm_y_train": norm_y_train,
            "n_inducing_pts_init": task["n_inducing_pts_init"],
            "z": np.asarray(task["z"]),
            "idxs_train": np.asarray(task["idxs_train"]),
            "md5_train": task["md5_train"],
            "idxs_valid": np.asarray(task["idxs_valid"]),
            "md5_valid": task["md5_valid"],
            "n_test": 0,
            "md5_test": None,
            "f_err": {"mae": np.nan, "rmse": np.nan},
            "R_desc": np.asarray(R_desc).T,  # stored transposed, like the reference
            "R_d_desc_alpha": r_d_desc_alpha,
            "interact_cut_off": task.get("interact_cut_off"),
            "c": 0.0,
            "std": std,
            "sig": task["sig"],
            "lam": task["lam"],
            "alphas_F": np.asarray(alphas_F),
            "perms": np.asarray(task["perms"]),
            "tril_perms_lin": _tril_perms_lin(np.asarray(task["perms"])),
            "use_E": bool(task["use_E"]),
            "use_cprsn": bool(task["use_cprsn"]),
        }
        if solver_resid is not None:
            model["solver_resid"] = solver_resid
        if solver_iters is not None:
            model["solver_iters"] = solver_iters
        if inducing_pts_idxs is not None:
            model["inducing_pts_idxs"] = np.asarray(inducing_pts_idxs)
        if task["use_E"]:
            model["e_err"] = {"mae": np.nan, "rmse": np.nan}
            if task.get("use_E_cstr") and alphas_E is not None:
                model["alphas_E"] = np.asarray(alphas_E)
        if "lattice" in task:
            model["lattice"] = task["lattice"]
        if "r_unit" in task and "e_unit" in task:
            model["r_unit"] = task["r_unit"]
            model["e_unit"] = task["e_unit"]
        return model

    def _wrap_ckpt(self, save_progr_callback, task, X, Jc, y, y_std):
        """Adapt the raw CG snapshot into an unconverged-model dict
        (reference iterative_solver.py:919-954)."""
        if save_progr_callback is None:
            return None

        def wrapped(alphas_psd, num_iters, resid, inducing_pts_idxs):
            alphas_F = -np.asarray(alphas_psd)
            X_np, Jc_np = X.cpu().numpy(), Jc.cpu().numpy()
            model = self.create_model(
                task, "cg", X_np, Jc_np, y_std, alphas_F,
                solver_resid=resid, solver_iters=num_iters + 1,
                norm_y_train=float(np.linalg.norm(y)),
                inducing_pts_idxs=inducing_pts_idxs,
            )
            pred = Predictor.from_alphas(task, X_np, Jc_np, alphas_F,
                                         std=y_std, device=self.device)
            E_pred, _ = pred.predict(np.asarray(task["R_train"]))
            E_ref = np.squeeze(np.asarray(task["E_train"]))
            model["c"] = float(np.sum(E_ref - E_pred) / E_ref.shape[0])
            save_progr_callback(model)

        return wrapped

    def _recov_int_const(self, model, task):
        """Least-squares integration constant + label self-diagnosis
        (reference train.py:972-1119)."""
        pred = Predictor(dict(model, c=0.0), device=self.device)
        E_pred, _ = pred.predict(np.asarray(task["R_train"]))
        E_ref = np.squeeze(np.asarray(task["E_train"]))

        e_fact = np.linalg.lstsq(
            np.column_stack((E_pred, np.ones(E_ref.shape))), E_ref, rcond=-1
        )[0][0]
        corrcoef = np.corrcoef(E_ref, E_pred)[0, 1]

        if np.sign(e_fact) == -1:
            log.warning(
                "Dataset seems to contain gradients instead of forces "
                "(flipped sign); disabling energy predictions.")
            return None
        if corrcoef < 0.95:
            log.warning(
                "Inconsistent energy labels detected (correlation %.2f); "
                "disabling energy predictions.", corrcoef)
            return None
        if np.abs(e_fact - 1) > 1e-1:
            log.warning(
                "Different scales in energy vs force labels (factor ~%.2f); "
                "disabling energy predictions.", e_fact)
            return None
        return float(np.sum(E_ref - E_pred) / E_ref.shape[0])
