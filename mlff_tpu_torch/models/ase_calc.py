"""ASE calculator interface.

PyTorch port of ``mlff_tpu.models.ase_calc`` (reference:
sgdml/intf/ase_calc.py:41-106): wraps a trained model as an
``ase.calculators.calculator.Calculator`` with unit conversion, the MD-loop
entry to ``Predictor``.  ASE is an optional dependency: without it the
module imports and the calculator raises ``ImportError``.
"""

from __future__ import annotations

import numpy as np

from ..utils.log import get_logger
from .predict import Predictor

log = get_logger(__name__)

try:
    from ase.calculators.calculator import Calculator

    _HAVE_ASE = True
except ImportError:  # pragma: no cover
    Calculator = object
    _HAVE_ASE = False


class MLFFCalculator(Calculator):
    """ASE calculator backed by the port's predictor on ``device`` (cuda by
    default).

    Parameters mirror the reference SGDMLCalculator: the model (dict or npz
    path) and conversion factors from the model's units to ASE's (eV, Ang).
    """

    implemented_properties = ["energy", "forces"]

    def __init__(
        self,
        model,
        E_to_eV: float = 0.0433641,   # kcal/mol -> eV, the reference default
        F_to_eV_Ang: float = 0.0433641,
        device=None,
        **kwargs,
    ):
        if not _HAVE_ASE:
            raise ImportError(
                "ase is not installed; MLFFCalculator requires the optional "
                "ASE dependency"
            )
        super().__init__(**kwargs)
        if isinstance(model, (str, bytes)) or hasattr(model, "__fspath__"):
            from ..utils.io import load_model

            model = load_model(model)
        self.predictor = Predictor(model, device=device)
        self.E_to_eV = E_to_eV
        self.F_to_eV_Ang = F_to_eV_Ang

    def calculate(self, atoms=None, properties=("energy",), system_changes=None):
        super().calculate(atoms, properties, system_changes)
        r = np.asarray(atoms.get_positions())[None]
        e, f = self.predictor.predict(r)
        self.results = {
            "energy": float(e[0]) * self.E_to_eV,
            "forces": np.asarray(f[0]) * self.F_to_eV_Ang,
        }
