"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``),
one process per source, all at once, and linked into ONE shared library
with a plain C interface, loaded with ``ctypes`` (no PyTorch headers: a
build takes seconds, not minutes).  The library
is built at first use into ``build/kernels/`` under the repository root,
named by a hash of the sources and flags, so a changed source rebuilds
and an unchanged one loads the existing file.

Nothing here runs at import: ``nvcc`` runs only when a CUDA tensor first
reaches a kernel wrapper.
"""
from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess

import torch

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# name -> argtypes; every pointer and the stream are c_void_p.
_SIGNATURES = {
    "dlpd_fused_correlate_tc": [_P] * 14 + [_I] * 10 + [_P],
    "dlpd_fused_correlate_tf32": [_P] * 14 + [_I] * 10 + [_P],
    "dlpd_invz_blockmax_fft": [_P] * 4 + [_I] * 5 + [_P],
    "dlpd_idft_fft": [_P] * 5 + [_I] * 2 + [_P],
    "dlpd_separable_splat": [_P] * 5 + [_I] * 10 + [_F] * 4 + [_P],
}


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def library_path() -> str:
    """Path of the library for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libdlpd_kernels_{h.hexdigest()[:16]}.so")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
            "deeplocalproteindocking_torch cannot be built")
    return path


def build(path: str) -> None:
    """Compile every ``csrc/*.cu`` into ``path``: one ``nvcc -c`` per
    source, all started together, then one link.  The ptxas report goes
    to ``path + '.log'``.  Raises with nvcc's output on failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cu = [p for p in _sources() if p.endswith(".cu")]
    objs = [f"{tmp}.{os.path.basename(p)}.o" for p in cu]
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    cmds = [[_nvcc(), *compile_flags, "-c", "-o", o, p]
            for p, o in zip(cu, objs)]
    try:
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for c in cmds]
        outs = [p.communicate() for p in procs]      # waits for each
        runs = [(c, p.returncode, out, err)
                for c, p, (out, err) in zip(cmds, procs, outs)]
        if all(rc == 0 for _, rc, _, _ in runs):
            link = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *objs]
            res = subprocess.run(link, capture_output=True, text=True)
            runs.append((link, res.returncode, res.stdout, res.stderr))
        with open(path + ".log", "w") as f:
            for c, _, out, err in runs:
                f.write(" ".join(c) + "\n" + out + err)
        failed = [(c, rc, err) for c, rc, _, err in runs if rc != 0]
        if failed:
            c, rc, err = failed[0]
            raise RuntimeError(f"nvcc failed with code {rc} on "
                               f"{os.path.basename(c[-1])}:\n{err[-6000:]}")
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    os.replace(tmp, path)          # atomic: concurrent builds agree


@functools.cache
def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    path = library_path()
    if not os.path.exists(path):
        build(path)
    lib = ctypes.CDLL(path)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.dlpd_error_string.argtypes = [ctypes.c_int]
    lib.dlpd_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error."""
    if err != 0:
        msg = library().dlpd_error_string(err).decode()
        raise RuntimeError(f"{what} failed to launch: CUDA error {err} "
                           f"({msg})")


def check_tensors(what: str, device, dtype, specs) -> None:
    """Raise unless each ``(name, tensor, shape)`` of ``specs`` lies on
    ``device``, has ``dtype`` and ``shape``, and is contiguous: a kernel
    reads raw pointers with the strides of that shape."""
    for name, t, shape in specs:
        if t.device != device:
            raise ValueError(f"{what}: {name} is on {t.device}, "
                             f"expected {device}")
        if t.dtype != dtype:
            raise TypeError(f"{what}: {name} is {t.dtype}, expected "
                            f"{dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what}: {name} has shape "
                             f"{tuple(t.shape)}, expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")


def check_matrix(what: str, seen, name: str, t, tag: str, want) -> None:
    """Raise unless ``t`` holds the float32 matrix ``want`` (to 1e-7): a
    kernel that computes with ``want`` and never reads ``t`` must not be
    handed another one.  ``seen`` (a ``WeakIdKeyDictionary``) records,
    under ``tag``, the tensors found equal, so each is compared once."""
    if seen.get(t) == tag:
        return
    w = torch.as_tensor(want).to(t.device)
    if t.shape != w.shape or not torch.allclose(t, w, rtol=0, atol=1e-7):
        raise ValueError(f"{what}, and {name} is not its matrix at "
                         f"L={w.shape[-1]}")
    seen[t] = tag


def stream(t) -> int:
    """The current CUDA stream of ``t``'s device, as a C pointer."""
    return torch.cuda.current_stream(t.device).cuda_stream
