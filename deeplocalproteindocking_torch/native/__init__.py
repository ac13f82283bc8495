"""Build and load the C++ structure parsers of ``native/``.

The sources at the repository root, ``native/pdb_parser.cpp`` (the PDB
fixed-column parser) and ``native/cif_tokenizer.cpp`` (the CIF tokenizer
and ``_atom_site`` extractor), are compiled with ``g++ -O3 -fPIC -shared
-std=c++17`` into ONE library at first use, in ``build/native/`` under
the repository root, named by a hash of the sources and flags (as
``_build.py`` names the CUDA kernels' library): a changed source
rebuilds, an unchanged one loads the existing file.

Parsing is host work.  When the library cannot be built or loaded the
callers (``structure/pdb.py``, ``structure/mmcif.py``) parse in pure
Python, with the same rules; ``python -m deeplocalproteindocking_torch.cli
doctor`` reports which one runs.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCES = tuple(os.path.join(_REPO, "native", f)
                for f in ("pdb_parser.cpp", "cif_tokenizer.cpp"))
BUILD_DIR = os.path.join(_REPO, "build", "native")
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")


def library_path() -> str:
    """Path of the library for the current sources and flags."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for path in SOURCES:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libdlpd_native_{h.hexdigest()[:16]}.so")


def build(path: str) -> None:
    """Compile the sources into ``path``; raises with g++'s output on
    failure."""
    cxx = os.environ.get("CXX") or shutil.which("g++") or "g++"
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        res = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, *SOURCES],
                             capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"cannot run {cxx}: {e}") from e
    if res.returncode != 0:
        raise RuntimeError(f"{cxx} failed with code {res.returncode}:\n"
                           f"{res.stderr[-4000:]}")
    os.replace(tmp, path)          # atomic: concurrent builds agree


@functools.cache
def library() -> ctypes.CDLL:
    """The parsers' shared library, built on first use.  Raises
    (``RuntimeError`` or ``OSError``) when it cannot be built or
    loaded."""
    path = library_path()
    if not os.path.exists(path):
        build(path)
    return ctypes.CDLL(path)


def status() -> dict:
    """``{"ok", "path"}`` of the library, or ``{"ok": False, "error"}``
    where it cannot be built or loaded (parsing then runs in Python)."""
    try:
        library()
    except Exception as e:  # noqa: BLE001 -- a report, not a parse
        return dict(ok=False, error=f"{type(e).__name__}: {e}")
    return dict(ok=True, path=library_path())
