"""Benchmark dataset/model downloader with checksum verification.

Rebuild of the reference downloader (reference: sgdml/get.py:45-69), which
streams ``http://www.quantum-machine.org/gdml/{data/npz,models}/<file>`` to
the working directory with a progress callback and NO integrity checking.

Differences here (deliberate):
  * any URL scheme urllib supports works, including ``file://`` — so the
    downloader is testable offline and usable against local mirrors;
  * integrity is verified after download: (a) the dataset's embedded
    fingerprint must match a recomputed ``dataset_md5`` over z/R/E/F
    (reference io.py:210-231 semantics), and (b) when the checksum registry
    has an entry for the file, the whole-file md5 must match it;
  * the base URL is overridable (argument or MLFF_TPU_DATA_MIRROR), so a
    local mirror can stand in for quantum-machine.org.

A copy of ``mlff_tpu.data.get`` (host NumPy and urllib only), so that the
port imports nothing of the JAX package.
"""

from __future__ import annotations

import hashlib
import os
from pathlib import Path
from urllib.request import urlopen

import numpy as np

from ..utils.io import dataset_md5
from ..utils.log import get_logger

log = get_logger(__name__)

BASE_URL = "https://www.quantum-machine.org/gdml/"

# Whole-file md5 registry.  Entries are added as mirrors are provisioned;
# an absent entry means only the embedded-fingerprint check applies — which
# detects CORRUPTION only, not tampering: the embedded md5 is a function of
# the data (utils/io.py dataset_md5) and anyone altering the file can
# recompute it.  Tamper resistance requires a registry entry below (or the
# https transport's channel integrity).  The reference archive publishes no
# md5 table, so the registry starts empty; tests register per-test entries
# (tests/test_torch_data_io.py).
CHECKSUMS: dict[str, str] = {}

_CHUNK = 1 << 16


def _file_md5(path: str | Path) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        while chunk := f.read(_CHUNK):
            h.update(chunk)
    return h.hexdigest()


def download(
    command: str,
    file_name: str,
    base_url: str | None = None,
    dest_dir: str | Path = ".",
    progress=None,
    verify: bool = True,
) -> Path:
    """Fetch a benchmark ``'dataset'`` or ``'model'`` npz.

    progress(bytes_done, bytes_total) is called per chunk (bytes_total may
    be None for sources that don't report a length).  Returns the local
    path.  Raises IOError on checksum mismatch (the corrupt file is kept
    with a ``.corrupt`` suffix for inspection).
    """
    if base_url is None:
        base_url = os.environ.get("MLFF_TPU_DATA_MIRROR", BASE_URL)
    if not base_url.endswith("/"):
        base_url += "/"
    url = base_url + ("data/npz/" if command == "dataset" else "models/") \
        + file_name

    dest = Path(dest_dir) / file_name
    dest.parent.mkdir(parents=True, exist_ok=True)
    tmp = dest.with_suffix(dest.suffix + ".part")

    with urlopen(url) as request, open(tmp, "wb") as out:
        total = request.headers.get("Content-Length")
        total = int(total) if total else None
        done = 0
        while chunk := request.read(_CHUNK):
            out.write(chunk)
            done += len(chunk)
            if progress is not None:
                progress(done, total)

    if verify:
        try:
            _verify(command, file_name, tmp)
        except Exception:
            tmp.rename(dest.with_suffix(dest.suffix + ".corrupt"))
            raise
    tmp.rename(dest)
    log.info("downloaded %s -> %s", url, dest)
    return dest


def _verify(command: str, file_name: str, path: Path) -> None:
    registered = CHECKSUMS.get(file_name)
    if registered is not None:
        actual = _file_md5(path)
        if actual != registered:
            raise IOError(
                f"{file_name}: file md5 {actual} does not match the "
                f"registry entry {registered}"
            )
    if command == "dataset":
        # allow_pickle stays OFF: the file is untrusted until verified, and
        # a pickled payload would execute during this very load.  Dataset
        # npz members (z/R/E/F/md5/name/...) are plain arrays; any object-
        # dtype member in a "dataset" is itself grounds for rejection.
        with np.load(path, allow_pickle=False) as data:
            ds = {k: data[k] for k in data.files}
        embedded = str(np.asarray(ds.get("md5")))
        recomputed = dataset_md5(ds)
        if embedded != recomputed:
            raise IOError(
                f"{file_name}: embedded dataset fingerprint {embedded} does "
                f"not match recomputed {recomputed} (file is corrupt; NOTE "
                f"this check cannot detect deliberate tampering — see the "
                f"CHECKSUMS registry)"
            )


def fetch_dataset(name: str, dest_dir: str | Path = ".", **kw) -> Path:
    """Convenience wrapper: ``download('dataset', '<name>.npz')``."""
    file_name = name if name.endswith(".npz") else name + ".npz"
    return download("dataset", file_name, dest_dir=dest_dir, **kw)
