"""ctypes binding of the C++ CIF tokenizer (``native/cif_tokenizer.cpp``).

``tokenize_cif`` gives the token stream of ``structure.mmcif.
_tokenize_cif_py``; ``parse_atom_site`` extracts the whole
``_atom_site`` table in C++ with the row rules of ``structure.mmcif.
parse_mmcif_text``.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np

from deeplocalproteindocking_torch import native

_ATOM_SITE_FIELDS = [("cif_as_xyz", ctypes.c_float),
                     ("cif_as_occ", ctypes.c_float),
                     ("cif_as_rid", ctypes.c_int32),
                     ("cif_as_names", ctypes.c_char),
                     ("cif_as_res", ctypes.c_char),
                     ("cif_as_chain", ctypes.c_char),
                     ("cif_as_icode", ctypes.c_char),
                     ("cif_as_alt", ctypes.c_char)]


@functools.cache
def library() -> ctypes.CDLL:
    """The shared library with the tokenizer and the ``_atom_site``
    extractor bound; raises when it cannot be built or loaded."""
    lib = native.library()
    lib.cif_tokenize_v1.restype = ctypes.c_void_p
    lib.cif_tokenize_v1.argtypes = [ctypes.c_char_p, ctypes.c_long,
                                    ctypes.POINTER(ctypes.c_long)]
    lib.cif_token_buffer.restype = ctypes.POINTER(ctypes.c_char)
    lib.cif_token_offsets.restype = ctypes.POINTER(ctypes.c_int64)
    lib.cif_token_flags.restype = ctypes.POINTER(ctypes.c_uint8)
    for name in ("cif_token_buffer", "cif_token_offsets",
                 "cif_token_flags"):
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    lib.cif_free.restype = None
    lib.cif_free.argtypes = [ctypes.c_void_p]
    lib.cif_atom_site_v1.restype = ctypes.c_void_p
    lib.cif_atom_site_v1.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long)]
    for name, t in _ATOM_SITE_FIELDS:
        getattr(lib, name).restype = ctypes.POINTER(t)
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    lib.cif_as_free.restype = None
    lib.cif_as_free.argtypes = [ctypes.c_void_p]
    return lib


def tokenize_cif(text: str):
    """``[(is_value_literal, token), ...]``, the stream of the pure-Python
    ``structure.mmcif._tokenize_cif_py``."""
    lib = library()
    raw = text.encode("utf-8", "surrogateescape")
    n = ctypes.c_long(0)
    h = lib.cif_tokenize_v1(raw, len(raw), ctypes.byref(n))
    if not h:
        raise MemoryError("cif_tokenize_v1 failed")
    try:
        nt = n.value
        offs = lib.cif_token_offsets(h)
        flags = lib.cif_token_flags(h)
        buf = ctypes.string_at(lib.cif_token_buffer(h), offs[nt] if nt else 0)
        return [(bool(flags[i]),
                 buf[offs[i]:offs[i + 1]].decode("utf-8", "surrogateescape"))
                for i in range(nt)]
    finally:
        lib.cif_free(h)


def parse_atom_site(text: str, include_hetatm: bool = False,
                    model: int = 1):
    """The ``_atom_site`` table as numpy arrays, extracted in C++:
    ``(coords, names, res, chain, rid, icode, alt, occ, model_count)``,
    with the row rules of ``structure.mmcif.parse_mmcif_text`` (ATOM and
    optionally HETATM, the Nth distinct model, auth -> label fallbacks,
    '.' and '?' as missing).  ``model_count`` spans every row."""
    lib = library()
    raw = text.encode("utf-8", "surrogateescape")
    n = ctypes.c_long(0)
    mc = ctypes.c_long(0)
    h = lib.cif_atom_site_v1(raw, len(raw), 1 if include_hetatm else 0,
                             model, ctypes.byref(n), ctypes.byref(mc))
    if not h:
        raise MemoryError("cif_atom_site_v1 failed")
    try:
        k = n.value
        if k == 0:
            return (np.zeros((0, 3), np.float32), np.zeros(0, "<U8"),
                    np.zeros(0, "<U4"), np.zeros(0, "<U2"),
                    np.zeros(0, np.int32), np.zeros(0, "<U2"),
                    np.zeros(0, "<U2"), np.zeros(0, np.float32), mc.value)

        def chars(getter, w):
            b = ctypes.string_at(getter(h), w * k)
            return np.char.strip(
                np.frombuffer(b, dtype=f"S{w}").astype(f"<U{w}"))

        def numbers(getter, shape, dtype):
            return np.ctypeslib.as_array(getter(h), shape=shape).astype(
                dtype, copy=True)

        return (numbers(lib.cif_as_xyz, (k, 3), np.float32),
                chars(lib.cif_as_names, 8), chars(lib.cif_as_res, 4),
                chars(lib.cif_as_chain, 2),
                numbers(lib.cif_as_rid, (k,), np.int32),
                chars(lib.cif_as_icode, 2), chars(lib.cif_as_alt, 2),
                numbers(lib.cif_as_occ, (k,), np.float32), mc.value)
    finally:
        lib.cif_as_free(h)
