"""Build and load the hand-written CUDA kernels in ``mlff_tpu_torch/csrc``.

Each source ``csrc/<name>.cu`` has a plain C interface and compiles with
``nvcc`` alone into a shared library, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/<name>-<hash>.so <name>.cu

Builds happen at first use, never at import, into ``build/kernels`` beside
the package (a directory git ignores).  The library name carries a hash of
its source, so an edited source rebuilds and a stale library is never
loaded.  ``build`` starts one ``nvcc`` per missing library, all at once.
``build_variant`` compiles any other source with the same flags, for the
timing tools that hold two designs of a kernel against each other.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    path = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "mlff_tpu_torch build only where the CUDA toolkit "
                           "is installed")
    return found


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names) -> dict:
    """Compile every library of ``names`` that is not built yet, with one
    ``nvcc`` per source running concurrently.  Returns {name: ptxas report}
    for the libraries built now; raises with nvcc's output on failure."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    reports, failed = {}, []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{out}")
            os.unlink(tmp)
            continue
        os.replace(tmp, library_path(name))
        reports[name] = out
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def build_variant(name: str, source: str) -> tuple[ctypes.CDLL, str]:
    """Compile ``source`` (a path) with the package's nvcc flags into
    ``build/kernels/variant-<name>.so`` and load it.  Returns the library
    and nvcc's output (the ptxas report)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"variant-{name}.so"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(out), source],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source}:\n{proc.stdout}"
                           f"{proc.stderr}")
    return ctypes.CDLL(str(out)), proc.stdout + proc.stderr


def ptxas_lines(report: str) -> list:
    """The lines of an nvcc ``-Xptxas -v`` report that name a kernel, its
    registers or its spills."""
    return [ln.strip() for ln in report.splitlines()
            if "registers" in ln or "spill" in ln or "Compiling" in ln]


def _unmangled(name: str) -> str:
    """The function's own identifier in an Itanium-mangled name:
    ``wide_forces`` for ``_ZN12_GLOBAL__N_14wide11wide_forcesEPKd...``,
    ``contract_partial`` for ``_ZN12_GLOBAL__N_116contract_partialILi5E...``.
    """
    i, last = 2 + (name[2:3] == "N"), name
    while i < len(name) and name[i].isdigit():
        j = i
        while name[j].isdigit():
            j += 1
        n = int(name[i:j])
        last, i = name[j:j + n], j + n
    return last


def kernel_resources(report: str) -> dict:
    """{kernel: {"registers", "spill_stores", "spill_loads"}} from an nvcc
    ``-Xptxas -v`` report, each kernel under its unmangled identifier (the
    instantiations of a template share one entry, the last reported)."""
    out, name = {}, None
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '(_Z[^']+)'", ln)
        if m:
            name = _unmangled(m.group(1))
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            out[name]["spill_stores"] = int(m.group(1))
            out[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


def spill_lines(report: str) -> list:
    """The lines of a ptxas report that admit to spilling."""
    return [ln.strip() for ln in report.splitlines()
            if "spill" in ln
            and "0 bytes spill stores, 0 bytes spill loads" not in ln]


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))
