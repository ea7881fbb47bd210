"""The port's data I/O against the JAX package's (counterparts of
tests/test_data_io.py): npz datasets and fingerprints, xyz / extended-xyz
(``Lattice=``), i-PI and FHI-aims converters, train/valid subsets of a
model, the checksum-verified downloader over ``file://`` mirrors only, and
the gate of the optional ``ase`` package.  Arrays must be equal bit for bit
and strings equal; nothing here opens a network connection.

The compile-cache tests of tests/test_data_io.py have no counterpart: the
JAX package's utils/cache.py seeds the XLA compilation cache, and the port
has no such cache.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

from mlff_tpu.data import get as jget  # noqa: E402
from mlff_tpu.data import xyz as jxyz  # noqa: E402
from mlff_tpu.data.synthetic import make_dataset  # noqa: E402
from mlff_tpu.utils import io as jio  # noqa: E402
from mlff_tpu_torch.data import get, xyz  # noqa: E402
from mlff_tpu_torch.utils import io  # noqa: E402


def _assert_same(a: dict, b: dict):
    """Equal keys; arrays equal bit for bit (dtype and shape included)."""
    assert set(a) == set(b)
    for key in a:
        x, y = np.asarray(a[key]), np.asarray(b[key])
        assert x.dtype == y.dtype and x.shape == y.shape, key
        np.testing.assert_array_equal(x, y, err_msg=key)


def _small(ds, m=7):
    return {**ds, "R": ds["R"][:m], "F": ds["F"][:m], "E": ds["E"][:m]}


def test_dataset_roundtrip(tmp_path, ethanol_ds):
    io.save_dataset(tmp_path / "port.npz", ethanol_ds)
    jio.save_dataset(tmp_path / "jax.npz", ethanol_ds)
    loaded = io.load_dataset(tmp_path / "port.npz")
    _assert_same(loaded, jio.load_dataset(tmp_path / "port.npz"))
    _assert_same(io.load_dataset(tmp_path / "jax.npz"), loaded)
    np.testing.assert_array_equal(loaded["R"], ethanol_ds["R"])
    assert io.dataset_md5(loaded) == jio.dataset_md5(ethanol_ds)


def test_fingerprint_detects_tamper(tmp_path, ethanol_ds):
    p = tmp_path / "ds.npz"
    io.save_dataset(p, ethanol_ds)
    data = dict(np.load(p, allow_pickle=True))
    data["F"] = data["F"] + 1.0
    np.savez_compressed(p, **data)
    for load in (io.load_dataset, jio.load_dataset):
        with pytest.raises(ValueError, match="fingerprint"):
            load(p)


def test_extxyz_roundtrip(tmp_path, ethanol_ds):
    small = _small(ethanol_ds)
    xyz.dataset_to_extxyz(small, tmp_path / "port.xyz")
    jxyz.dataset_to_extxyz(small, tmp_path / "jax.xyz")
    assert ((tmp_path / "port.xyz").read_text()
            == (tmp_path / "jax.xyz").read_text())
    back = xyz.dataset_from_extxyz(tmp_path / "port.xyz", name="roundtrip")
    _assert_same(back, jxyz.dataset_from_extxyz(tmp_path / "port.xyz",
                                                name="roundtrip"))
    np.testing.assert_allclose(back["R"], small["R"], rtol=1e-10)
    np.testing.assert_allclose(back["F"], small["F"], rtol=1e-10)
    np.testing.assert_allclose(back["E"], small["E"], rtol=1e-10)
    np.testing.assert_array_equal(back["z"], small["z"])


def test_extxyz_lattice(tmp_path, ethanol_ds):
    """``Lattice=`` (column-major, as the reference writes it) survives the
    round trip in both packages."""
    lat = np.array([[9.0, 0.5, 0.0], [0.0, 8.0, 0.25], [0.0, 0.0, 7.5]])
    small = dict(_small(ethanol_ds, 3), lattice=lat)
    xyz.dataset_to_extxyz(small, tmp_path / "cell.xyz")
    text = (tmp_path / "cell.xyz").read_text()
    assert text.splitlines()[1].startswith('Lattice="9 0 0 0.5 8 0 0 0.25 7.5"')
    frame = xyz.generate_xyz_str(small["R"][0], small["z"], e=small["E"][0],
                                 f=small["F"][0], lattice=lat)
    assert frame == jxyz.generate_xyz_str(small["R"][0], small["z"],
                                          e=small["E"][0], f=small["F"][0],
                                          lattice=lat)
    assert text.startswith(frame + "\n")
    back = xyz.dataset_from_extxyz(tmp_path / "cell.xyz")
    _assert_same(back, jxyz.dataset_from_extxyz(tmp_path / "cell.xyz"))
    np.testing.assert_array_equal(back["lattice"], lat)


def test_read_write_xyz(tmp_path, ethanol_ds):
    xyz.write_xyz(tmp_path / "geo.xyz", ethanol_ds["R"][:3], ethanol_ds["z"])
    jxyz.write_xyz(tmp_path / "jgeo.xyz", ethanol_ds["R"][:3], ethanol_ds["z"])
    assert ((tmp_path / "geo.xyz").read_text()
            == (tmp_path / "jgeo.xyz").read_text())
    R, z, comments = xyz.read_xyz(tmp_path / "geo.xyz")
    Rj, zj, cj = jxyz.read_xyz(tmp_path / "geo.xyz")
    np.testing.assert_array_equal(R, Rj)
    np.testing.assert_array_equal(z, zj)
    assert comments == cj
    np.testing.assert_allclose(R, ethanol_ds["R"][:3], rtol=1e-10)
    np.testing.assert_array_equal(z, ethanol_ds["z"])
    assert xyz.z_to_str(8) == jxyz.z_to_str(8) == "O"
    assert xyz.str_to_z("cl") == jxyz.str_to_z("cl") == 17


def test_dataset_from_ipi(tmp_path, ethanol_ds):
    """i-PI: positions and forces as two multi-frame xyz files, energies as
    a column file."""
    small = _small(ethanol_ds, 5)
    xyz.write_xyz(tmp_path / "pos.xyz", small["R"], small["z"])
    xyz.write_xyz(tmp_path / "frc.xyz", small["F"], small["z"])
    np.savetxt(tmp_path / "ener.txt",
               np.column_stack([np.ravel(small["E"]), np.arange(5)]))
    kw = dict(energies=tmp_path / "ener.txt", name="ipi", e_col=0)
    ds = xyz.dataset_from_ipi(tmp_path / "pos.xyz", tmp_path / "frc.xyz", **kw)
    _assert_same(ds, jxyz.dataset_from_ipi(tmp_path / "pos.xyz",
                                           tmp_path / "frc.xyz", **kw))
    assert str(ds["name"]) == "ipi" and ds["R"].shape == (5, 9, 3)
    np.testing.assert_allclose(ds["F"], small["F"], rtol=1e-10)
    np.testing.assert_allclose(ds["E"], np.ravel(small["E"]), rtol=1e-10)


def _fake_aims_output(path, R, z, E_eV, F_eV):
    """Emit a minimal FHI-aims MD stdout with the three per-step sections."""
    M, A, _ = R.shape
    with open(path, "w") as fh:
        fh.write(f"  The structure contains {A} atoms,  and a total of "
                 f"{float(sum(z)):.3f} electrons.\n\n")
        for s in range(M):
            fh.write("  Energy and forces in a compact form:\n")
            fh.write(f"  | Total energy uncorrected      :  {E_eV[s]: .12e} eV\n")
            fh.write("  Total atomic forces (unitary forces cleaned) [eV/Ang]:\n")
            for a in range(A):
                fx, fy, fz = F_eV[s, a]
                fh.write(f"  |{a + 1:4d}   {fx: .8e}  {fy: .8e}  {fz: .8e}\n")
            fh.write("  Atomic structure (and velocities) as used in the "
                     "preceding time step:\n")
            fh.write("  |\n")
            for a in range(A):
                x, y, zz = R[s, a]
                fh.write(f"            atom   {x: .8f}  {y: .8f}  {zz: .8f}"
                         f"  {xyz.z_to_str(z[a])}\n")


def test_dataset_from_aims(tmp_path):
    rng = np.random.default_rng(4)
    M, A = 5, 3
    R = rng.normal(size=(M, A, 3))
    z = np.array([8, 1, 1])
    E_eV = rng.normal(size=M) * 10 - 2000.0
    F_eV = rng.normal(size=(M, A, 3))
    path = tmp_path / "aims.out"
    _fake_aims_output(path, R, z, E_eV, F_eV)

    ds = xyz.dataset_from_aims(path, name="water_test")
    _assert_same(ds, jxyz.dataset_from_aims(path, name="water_test"))
    assert xyz._EV_TO_KCALMOL == jxyz._EV_TO_KCALMOL == 0.036749326 / 0.0015946679
    assert str(ds["name"]) == "water_test"
    np.testing.assert_array_equal(ds["z"], z)
    np.testing.assert_allclose(ds["R"], R, atol=1e-7)  # fixture prints %.8f
    np.testing.assert_allclose(ds["E"][:, 0], E_eV * xyz._EV_TO_KCALMOL,
                               rtol=1e-10)
    np.testing.assert_allclose(ds["F"], F_eV * xyz._EV_TO_KCALMOL, rtol=1e-6)
    assert ds["E"].shape == (M, 1)


def test_dataset_from_aims_prunes_incomplete_tail(tmp_path):
    rng = np.random.default_rng(5)
    M, A = 4, 3
    R = rng.normal(size=(M, A, 3))
    z = np.array([6, 1, 1])
    path = tmp_path / "aims_truncated.out"
    _fake_aims_output(path, R, z, rng.normal(size=M),
                      rng.normal(size=(M, A, 3)))
    # one extra energy+forces with no geometry (interrupted run)
    with open(path, "a") as fh:
        fh.write("  Energy and forces in a compact form:\n")
        fh.write("  | Total energy uncorrected      :  -1.0e+00 eV\n")

    ds = xyz.dataset_from_aims(path)
    _assert_same(ds, jxyz.dataset_from_aims(path))
    assert ds["R"].shape[0] == M and ds["E"].shape[0] == M


def test_dataset_subsets_from_model(ethanol_ds):
    model = {
        "md5_train": ethanol_ds["md5"],
        "md5_valid": ethanol_ds["md5"],
        "idxs_train": np.array([0, 2, 4]),
        "idxs_valid": np.array([1, 3]),
    }
    subs = xyz.dataset_subsets_from_model(model, ethanol_ds)
    ref = jxyz.dataset_subsets_from_model(model, ethanol_ds)
    for s in ("train", "valid"):
        _assert_same(subs[s], ref[s])
    assert subs["train"]["R"].shape[0] == 3
    np.testing.assert_array_equal(
        subs["train"]["F"], np.asarray(ethanol_ds["F"])[[0, 2, 4]])
    assert str(subs["valid"]["md5"]) == io.dataset_md5(subs["valid"])
    model["md5_train"] = "deadbeef"
    with pytest.raises(ValueError, match="fingerprint"):
        xyz.dataset_subsets_from_model(model, ethanol_ds)


def _mirror_with(tmp_path, name, dataset):
    """A file:// mirror in the reference's URL layout."""
    root = tmp_path / "mirror"
    (root / "data" / "npz").mkdir(parents=True, exist_ok=True)
    io.save_dataset(root / "data" / "npz" / name, dataset)
    return root.as_uri()


def test_downloader_fetches_and_verifies(tmp_path):
    """download() streams from a file:// mirror, verifies the embedded
    fingerprint, reports progress and places the npz in dest_dir: the same
    bytes and the same progress calls as the JAX package's."""
    ds = make_dataset("ethanol", n_samples=5, seed=0)
    base = _mirror_with(tmp_path, "ethanol_syn.npz", ds)
    seen, seen_j = [], []
    out = get.download("dataset", "ethanol_syn.npz", base_url=base,
                       dest_dir=tmp_path / "dl",
                       progress=lambda d, t: seen.append((d, t)))
    out_j = jget.download("dataset", "ethanol_syn.npz", base_url=base,
                          dest_dir=tmp_path / "dl_jax",
                          progress=lambda d, t: seen_j.append((d, t)))
    assert out.name == "ethanol_syn.npz" and out.read_bytes() == out_j.read_bytes()
    assert seen == seen_j and seen[-1][0] > 0
    np.testing.assert_array_equal(io.load_dataset(out)["R"], ds["R"])
    assert get._file_md5(out) == jget._file_md5(out)

    # registry checksum path: the right entry passes, a wrong one raises and
    # keeps the file as .corrupt
    get.CHECKSUMS["ethanol_syn.npz"] = get._file_md5(out)
    try:
        get.download("dataset", "ethanol_syn.npz", base_url=base,
                     dest_dir=tmp_path / "dl2")
        get.CHECKSUMS["ethanol_syn.npz"] = "0" * 32
        with pytest.raises(IOError, match="registry"):
            get.download("dataset", "ethanol_syn.npz", base_url=base,
                         dest_dir=tmp_path / "dl3")
        assert (tmp_path / "dl3" / "ethanol_syn.npz.corrupt").exists()
    finally:
        get.CHECKSUMS.pop("ethanol_syn.npz", None)


def test_downloader_rejects_tampered_dataset(tmp_path):
    ds = make_dataset("ethanol", n_samples=5, seed=0)
    base = _mirror_with(tmp_path, "bad.npz", ds)
    path = tmp_path / "mirror" / "data" / "npz" / "bad.npz"
    raw = dict(np.load(path, allow_pickle=True))
    raw["R"] = raw["R"] + 1.0
    np.savez_compressed(path, **raw)
    with pytest.raises(IOError, match="fingerprint"):
        get.download("dataset", "bad.npz", base_url=base, dest_dir=tmp_path)


def test_downloader_mirror_from_environment(tmp_path, monkeypatch):
    """fetch_dataset with the base URL from MLFF_TPU_DATA_MIRROR."""
    ds = make_dataset("ethanol", n_samples=5, seed=0)
    monkeypatch.setenv("MLFF_TPU_DATA_MIRROR", _mirror_with(tmp_path, "e.npz",
                                                            ds))
    out = get.fetch_dataset("e", dest_dir=tmp_path / "env")
    assert out == tmp_path / "env" / "e.npz" and out.exists()


def test_downloader_compat_shim(tmp_path):
    """xyz.download forwards to the port's data.get."""
    ds = make_dataset("ethanol", n_samples=5, seed=0)
    base = _mirror_with(tmp_path, "e.npz", ds)
    out = xyz.download("dataset", "e.npz", base_url=base,
                       dest_dir=tmp_path / "o")
    assert out.exists()


def test_ase_calc_gated():
    from mlff_tpu_torch.models import ase_calc

    if ase_calc._HAVE_ASE:
        pytest.skip("ase available; gating not exercised")
    with pytest.raises(ImportError, match="ase"):
        ase_calc.MLFFCalculator(model={})


def test_dataset_via_ase_gated():
    try:
        import ase  # noqa: F401
        pytest.skip("ase available; gating not exercised")
    except ImportError:
        pass
    with pytest.raises(ImportError, match="ase"):
        xyz.dataset_via_ase("nonexistent.traj")
