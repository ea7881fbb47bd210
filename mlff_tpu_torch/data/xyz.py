"""xyz / extended-xyz geometry IO and dataset converters.

Rebuild of the reference xyz tooling (reference:
sgdml/utils/io.py:240-328 read/write/generate_xyz_str and the converter
scripts src/sGDML/scripts/sgdml_dataset_from_extxyz.py /
sgdml_dataset_to_extxyz.py semantics).

A verbatim copy of ``mlff_tpu.data.xyz`` (host NumPy only), so that the port
imports nothing of the JAX package; the same files give the same arrays.
``dataset_via_ase`` needs the optional ``ase`` package.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np

from ..utils.io import dataset_md5

# element symbol <-> atomic number (the subset relevant to the benchmark sets
# plus the common organic elements)
_Z_STR = {
    1: "H", 2: "He", 3: "Li", 4: "Be", 5: "B", 6: "C", 7: "N", 8: "O",
    9: "F", 10: "Ne", 11: "Na", 12: "Mg", 13: "Al", 14: "Si", 15: "P",
    16: "S", 17: "Cl", 18: "Ar", 19: "K", 20: "Ca", 26: "Fe", 29: "Cu",
    30: "Zn", 35: "Br", 53: "I",
}
_STR_Z = {v: k for k, v in _Z_STR.items()}


def z_to_str(z: int) -> str:
    return _Z_STR[int(z)]


def str_to_z(s: str) -> int:
    return _STR_Z[s.capitalize()]


def read_xyz(path: str | Path):
    """Read a (multi-frame) xyz file -> (R (M, A, 3), z (A,), comments)."""
    frames, comments = [], []
    with open(path) as fh:
        lines = fh.read().splitlines()
    i = 0
    z = None
    while i < len(lines):
        if not lines[i].strip():
            i += 1
            continue
        n_atoms = int(lines[i].strip())
        comments.append(lines[i + 1] if i + 1 < len(lines) else "")
        block = lines[i + 2 : i + 2 + n_atoms]
        geom = []
        z_frame = []
        for row in block:
            cols = row.split()
            z_frame.append(str_to_z(cols[0]))
            geom.append([float(c) for c in cols[1:4]])
        if z is None:
            z = np.asarray(z_frame)
        frames.append(geom)
        i += 2 + n_atoms
    return np.asarray(frames), z, comments


def generate_xyz_str(r, z, e=None, f=None, lattice=None) -> str:
    """One extended-xyz frame string (reference io.py:280-303)."""
    comment = ""
    if lattice is not None:
        comment += 'Lattice="{}" '.format(
            " ".join(f"{v:.12g}" for v in np.asarray(lattice).T.ravel())
        )
    if e is not None:
        comment += f"Energy={float(e):.12g} "
    comment += "Properties=species:S:1:pos:R:3"
    if f is not None:
        comment += ":forces:R:3"
    out = [str(len(r)), comment]
    for i, atom in enumerate(np.asarray(r)):
        row = f"{z_to_str(z[i])}\t" + "\t".join(f"{x:.12g}" for x in atom)
        if f is not None:
            row += "\t" + "\t".join(f"{x:.12g}" for x in np.asarray(f)[i])
        out.append(row)
    return "\n".join(out)


def write_xyz(path: str | Path, R, z, E=None, F=None, lattice=None) -> None:
    """Write a multi-frame extended-xyz file."""
    R = np.asarray(R).reshape(-1, len(z), 3)
    with open(path, "w") as fh:
        for m in range(R.shape[0]):
            fh.write(
                generate_xyz_str(
                    R[m], z,
                    e=None if E is None else E[m],
                    f=None if F is None else np.asarray(F).reshape(R.shape)[m],
                    lattice=lattice,
                )
                + "\n"
            )


_ENERGY_RE = re.compile(r"energy\s*=\s*([-+0-9.eEdD]+)", re.IGNORECASE)
_LATTICE_RE = re.compile(r'Lattice\s*=\s*"([^"]+)"', re.IGNORECASE)


def dataset_from_extxyz(
    path: str | Path, name: str | None = None, theory: str = "unknown",
    r_unit: str = "Ang", e_unit: str = "kcal/mol",
) -> dict:
    """Convert an extended-xyz trajectory (with per-frame Energy= comments and
    force columns) into the npz dataset schema
    (reference scripts/sgdml_dataset_from_extxyz.py behavior)."""
    frames, comments = [], []
    with open(path) as fh:
        lines = fh.read().splitlines()
    R, F, E = [], [], []
    z = None
    lattice = None
    i = 0
    while i < len(lines):
        if not lines[i].strip():
            i += 1
            continue
        n_atoms = int(lines[i].strip())
        comment = lines[i + 1]
        m = _ENERGY_RE.search(comment)
        if m:
            E.append(float(m.group(1).replace("D", "e").replace("d", "e")))
        mlat = _LATTICE_RE.search(comment)
        if mlat and lattice is None:
            vals = np.array([float(v) for v in mlat.group(1).split()])
            lattice = vals.reshape(3, 3).T
        geom, forces, z_frame = [], [], []
        for row in lines[i + 2 : i + 2 + n_atoms]:
            cols = row.split()
            z_frame.append(str_to_z(cols[0]))
            geom.append([float(c) for c in cols[1:4]])
            if len(cols) >= 7:
                forces.append([float(c) for c in cols[4:7]])
        if z is None:
            z = np.asarray(z_frame)
        R.append(geom)
        if forces:
            F.append(forces)
        i += 2 + n_atoms

    if not F:
        raise ValueError("extxyz file contains no force columns")
    dataset = {
        "type": "d",
        "name": np.asarray(name or Path(path).stem),
        "theory": np.asarray(theory),
        "z": z.astype(np.int64),
        "R": np.asarray(R, dtype=np.float64),
        "F": np.asarray(F, dtype=np.float64),
        "r_unit": np.asarray(r_unit),
        "e_unit": np.asarray(e_unit),
    }
    if E:
        dataset["E"] = np.asarray(E, dtype=np.float64)
    if lattice is not None:
        dataset["lattice"] = lattice
    dataset["md5"] = np.asarray(dataset_md5(dataset))
    return dataset


def dataset_to_extxyz(dataset: dict, path: str | Path) -> None:
    """Inverse converter (reference scripts/sgdml_dataset_to_extxyz.py)."""
    write_xyz(
        path, dataset["R"], np.asarray(dataset["z"]),
        E=dataset.get("E"), F=dataset.get("F"),
        lattice=dataset.get("lattice"),
    )


def dataset_from_ipi(pos_xyz: str | Path, frc_xyz: str | Path,
                     energies: str | Path | None = None, **kw) -> dict:
    """i-PI trajectory converter (reference scripts/sgdml_dataset_from_ipi.py
    semantics): positions and forces come as separate multi-frame xyz files,
    energies optionally as a column file."""
    R, z, _ = read_xyz(pos_xyz)
    F, _, _ = read_xyz(frc_xyz)
    if R.shape != F.shape:
        raise ValueError("position and force trajectories differ in shape")
    ds = {
        "type": "d",
        "name": np.asarray(kw.get("name", Path(pos_xyz).stem)),
        "theory": np.asarray(kw.get("theory", "unknown")),
        "z": np.asarray(z, dtype=np.int64),
        "R": R.astype(np.float64),
        "F": F.astype(np.float64),
        "r_unit": np.asarray(kw.get("r_unit", "Ang")),
        "e_unit": np.asarray(kw.get("e_unit", "kcal/mol")),
    }
    if energies is not None:
        ds["E"] = np.loadtxt(energies, usecols=kw.get("e_col", 0))[: R.shape[0]]
    ds["md5"] = np.asarray(dataset_md5(ds))
    return ds


# Hartree/eV over Hartree/(kcal/mol): the reference's eV -> kcal/mol factor
# (scripts/sgdml_dataset_from_aims.py:37)
_EV_TO_KCALMOL = 0.036749326 / 0.0015946679


def dataset_from_aims(path: str | Path, name: str | None = None, **kw) -> dict:
    """FHI-aims MD-output converter (reference
    scripts/sgdml_dataset_from_aims.py semantics).

    Scans an aims standard-output stream for the three per-step sections:

      * ``The structure contains <A> atoms,  and a total of ...`` — atom count,
      * ``Energy and forces in a compact form:`` — the next line's 6th token
        is the total energy in eV,
      * ``Total atomic forces (unitary forces cleaned) [eV/Ang]:`` — followed
        by A rows of ``| i fx fy fz``,
      * ``Atomic structure (and velocities) as used in the preceding time
        step:`` — followed by ``atom x y z <species>`` rows.

    Energies/forces are converted eV -> kcal/mol(/Ang); incomplete trailing
    output is pruned to the shortest complete section, exactly like the
    reference converter.
    """
    n_atoms = None
    R: list = []
    z: list = []
    E: list = []
    F: list = []
    mode = None          # None | 'energy' | 'forces' | 'geometry'
    a_count = 0
    geo_idx = 0

    with open(path) as fh:
        for line in fh:
            if n_atoms is None:
                if "The structure contains" in line and "atoms,  and a total of" in line:
                    n_atoms = int(line.split()[3])
                continue
            cols = line.split()
            if mode == "energy":
                E.append(float(cols[5]))
                mode = None
            elif mode == "forces":
                F.append([float(c) for c in cols[2:5]])
                if int(cols[1]) == n_atoms:
                    mode = None
            elif mode == "geometry":
                if "atom" in cols:
                    a_count += 1
                    R.append([float(c) for c in cols[1:4]])
                    if geo_idx == 0:
                        z.append(str_to_z(cols[4]))
                    if a_count == n_atoms:
                        mode = None
                        geo_idx += 1
            elif "Energy and forces in a compact form:" in line:
                mode = "energy"
            elif "Total atomic forces (unitary forces cleaned) [eV/Ang]:" in line:
                mode = "forces"
            elif ("Atomic structure (and velocities) as used in the "
                  "preceding time step:" in line):
                mode = "geometry"
                a_count = 0

    if n_atoms is None:
        raise ValueError(f"{path}: no 'The structure contains' header found")

    R_arr = np.asarray(R, dtype=np.float64).reshape(-1, n_atoms, 3)
    F_arr = (np.asarray(F, dtype=np.float64).reshape(-1, n_atoms, 3)
             * _EV_TO_KCALMOL)
    E_arr = np.asarray(E, dtype=np.float64) * _EV_TO_KCALMOL

    n_mols = min(R_arr.shape[0], F_arr.shape[0], E_arr.shape[0])
    if n_mols == 0:
        raise ValueError(f"{path}: no complete (R, E, F) steps found")
    R_arr, F_arr, E_arr = R_arr[:n_mols], F_arr[:n_mols], E_arr[:n_mols]

    dataset = {
        "type": "d",
        "name": np.asarray(name or Path(path).stem),
        "theory": np.asarray(kw.get("theory", "unknown")),
        "z": np.asarray(z, dtype=np.int64),
        "R": R_arr,
        "E": E_arr[:, None],
        "F": F_arr,
        "r_unit": np.asarray("Ang"),
        "e_unit": np.asarray("kcal/mol"),
        "F_min": np.min(F_arr), "F_max": np.max(F_arr),
        "F_mean": np.mean(F_arr), "F_var": np.var(F_arr),
        "E_min": np.min(E_arr), "E_max": np.max(E_arr),
        "E_mean": np.mean(E_arr), "E_var": np.var(E_arr),
    }
    dataset["md5"] = np.asarray(dataset_md5(dataset))
    return dataset


def dataset_via_ase(
    path: str | Path, name: str | None = None, theory: str = "unknown",
    r_unit: str | None = None, e_unit: str | None = None,
) -> dict:
    """Create a dataset from any input format ASE can read (reference
    scripts/sgdml_dataset_via_ase.py behavior, non-interactive: the
    reference prompts for name/theory/units on stdin — here they are
    keyword arguments).

    Requires the optional ``ase`` package; frames without attached
    calculator results are filtered, forces are mandatory, the atom
    ordering must be constant across frames, and an all-zero cell is
    treated as "no lattice"."""
    try:
        from ase.io import read
    except ImportError as exc:  # pragma: no cover - ase not in this image
        raise ImportError(
            "dataset_via_ase requires the optional 'ase' package"
        ) from exc

    mols = [m for m in read(str(path), index=":") if m.calc is not None]
    if not mols:
        raise ValueError(f"no frames with calculator results in {path}")
    if "forces" not in mols[0].calc.results:
        raise ValueError("forces are missing in the input file")
    Z = np.array([m.get_atomic_numbers() for m in mols])
    if not (Z == Z[0]).all():
        raise ValueError("order of atoms changes across the dataset")

    F = np.array([m.get_forces() for m in mols], dtype=np.float64)
    dataset = {
        "type": "d",
        "name": np.asarray(name or Path(path).stem),
        "theory": np.asarray(theory),
        "z": Z[0].astype(np.int64),
        "R": np.array([m.get_positions() for m in mols], dtype=np.float64),
        "F": F,
        "F_min": np.min(F), "F_max": np.max(F),
        "F_mean": np.mean(F), "F_var": np.var(F),
    }
    lattice = np.array(mols[0].get_cell())
    if np.any(lattice):
        dataset["lattice"] = lattice
    try:
        E = np.array([m.get_potential_energy() for m in mols],
                     dtype=np.float64)
        dataset["E"] = E
        dataset["E_min"], dataset["E_max"] = np.min(E), np.max(E)
        dataset["E_mean"], dataset["E_var"] = np.mean(E), np.var(E)
    except Exception:
        pass  # energies are optional (force-only training)
    if r_unit:
        dataset["r_unit"] = np.asarray(r_unit)
    if e_unit:
        dataset["e_unit"] = np.asarray(e_unit)
    dataset["md5"] = np.asarray(dataset_md5(dataset))
    return dataset


def dataset_subsets_from_model(model: dict, dataset: dict) -> dict:
    """Extract the train/valid dataset subsets a model was built from
    (reference scripts/sgdml_datasets_from_model.py): fingerprints are
    validated against the model's recorded md5s, and each subset is a
    self-contained dataset dict with its own fingerprint."""
    out = {}
    for s in ("train", "valid"):
        md5_ref = model.get(f"md5_{s}")
        if md5_ref is not None and str(np.asarray(md5_ref)) not in (
            "", "None"
        ) and str(np.asarray(md5_ref)) != str(np.asarray(dataset["md5"])):
            raise ValueError(
                f"dataset fingerprint does not match the one referenced in "
                f"the model for '{s}'"
            )
        idxs = np.asarray(model[f"idxs_{s}"])
        sub = {
            "type": "d",
            "name": np.asarray(str(np.asarray(dataset["name"]))),
            "theory": np.asarray(str(np.asarray(dataset["theory"]))),
            "z": np.asarray(dataset["z"]),
            "R": np.asarray(dataset["R"])[idxs],
            "F": np.asarray(dataset["F"])[idxs],
        }
        if "E" in dataset:
            sub["E"] = np.asarray(dataset["E"])[idxs]
        sub["md5"] = np.asarray(dataset_md5(sub))
        out[s] = sub
    return out


def download(command: str, file_name: str, **kw):
    """Benchmark dataset downloader — see ``mlff_tpu.data.get.download``
    (reference sgdml/get.py:45-69).  Kept here for backward compatibility."""
    from .get import download as _download

    return _download(command, file_name, **kw)
