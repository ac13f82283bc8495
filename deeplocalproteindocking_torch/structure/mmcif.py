"""mmCIF (PDBx) ingestion: ``_atom_site`` records -> Structure.

Port of ``deeplocalproteindocking_tpu/structure/mmcif.py``, with the same
semantics as the PDB path:

* ATOM records (HETATM optional), NMR model selection by the Nth distinct
  ``pdbx_PDB_model_num`` (first model by default);
* occupancy-ranked alternate locations through ``structure.pdb.
  select_altlocs``;
* auth_* identifiers preferred (they match the legacy PDB columns),
  label_* when absent.

``parse_mmcif_text`` extracts the table through the C++ library of
``native/`` (``native/cif_native.parse_atom_site``) when it builds, else
through the pure-Python tokenizer and loop parser below.  Host work, once
per structure.
"""
from __future__ import annotations

import os

import numpy as np

from deeplocalproteindocking_torch.structure.atom_types import (
    assign_atom_types)
from deeplocalproteindocking_torch.structure.pdb import (Structure,
                                                         select_altlocs)

# None: not tried yet; False: off (no library, or disabled by a test to
# force the pure-Python paths); else the native tokenizer.
_native_tokenize = None


def _tokenize_cif(text: str):
    """CIF token stream through the C++ tokenizer when its library
    loads, else :func:`_tokenize_cif_py`; the two streams are equal."""
    global _native_tokenize
    if _native_tokenize is None:
        from deeplocalproteindocking_torch.native import cif_native
        try:
            cif_native.library()
            _native_tokenize = cif_native.tokenize_cif
        except Exception:  # noqa: BLE001 -- no compiler, no library
            _native_tokenize = False
    if _native_tokenize:
        try:
            return _native_tokenize(text)
        except Exception:  # noqa: BLE001 -- text the library refuses
            pass
    return _tokenize_cif_py(text)


def _tokenize_cif_py(text: str):
    """CIF token stream: ``(is_value_literal, token)`` pairs.

    A line starting with ``;`` opens a text block closed by the next
    ``;`` line, emitted as ONE value token; loop rows may wrap lines (the
    parser consumes values by count).  ``is_value_literal`` is True for
    text blocks and quoted strings, which may look like keywords or tags
    without being either.  ``#`` comments are stripped outside quotes.
    """
    lines = text.splitlines()
    i, n = 0, len(lines)
    toks = []
    while i < n:
        line = lines[i]
        if line.startswith(";"):
            block = [line[1:]]
            i += 1
            while i < n and not lines[i].startswith(";"):
                block.append(lines[i])
                i += 1
            i += 1                       # the closing ';' line
            toks.append((True, "\n".join(block)))
            continue
        s = line.strip()
        i += 1
        if not s or s.startswith("#"):
            continue
        if "'" in s or '"' in s:
            toks.extend(_lex_quoted_line(s))
        else:
            for t in s.split():
                if t.startswith("#"):
                    break                # trailing comment
                toks.append((False, t))
    return toks


def _lex_quoted_line(s: str):
    """Tokens of one CIF line with quoting: a quote opens a string only
    at a token start, and closes only before whitespace or the end of the
    line (embedded quotes are data); ``#`` starts a comment only at a
    token boundary outside quotes."""
    out = []
    i, n = 0, len(s)
    while i < n:
        c = s[i]
        if c in " \t":
            i += 1
            continue
        if c == "#":
            break
        if c in "'\"":
            j = i + 1
            buf = []
            while j < n and not (s[j] == c
                                 and (j + 1 == n or s[j + 1] in " \t")):
                buf.append(s[j])
                j += 1
            out.append((True, "".join(buf)))
            i = j + 1
        else:
            j = i
            while j < n and s[j] not in " \t":
                j += 1
            out.append((False, s[i:j]))
            i = j
    return out


def _is_kw(t, kw):
    lit, s = t
    return not lit and s.lower() == kw


def _is_tag(t):
    lit, s = t
    return not lit and s.startswith("_")


def _ends_loop(t):
    lit, s = t
    return not lit and (s.startswith("_") or s.lower() in ("loop_", "stop_")
                        or s.lower().startswith("data_"))


def _scan_atom_site(toks):
    """``(column index by item name, rows)`` of each ``_atom_site`` loop
    of ``toks``.  Rows are consumed by value count (they may wrap lines;
    a truncated final row is dropped).  Other loops are skipped whole:
    text blocks and quoted strings are single value tokens, so a block
    that holds ``loop_`` cannot desync the scan."""
    out = []
    i, n = 0, len(toks)
    while i < n:
        if not _is_kw(toks[i], "loop_"):
            i += 1
            continue
        j = i + 1
        cols = []
        while j < n and _is_tag(toks[j]):
            cols.append(toks[j][1])
            j += 1
        if not cols or not cols[0].startswith("_atom_site."):
            while j < n and not _ends_loop(toks[j]):
                j += 1
            i = j
            continue
        nc = len(cols)
        rows = []
        while j < n and not _ends_loop(toks[j]):
            if j + nc > n:
                break
            rows.append([toks[j + m][1] for m in range(nc)])
            j += nc
        out.append(({c.split(".", 1)[1]: k for k, c in enumerate(cols)},
                    rows))
        i = j
    return out


def parse_mmcif_text(text: str, include_hetatm: bool = False,
                     model: int = 1) -> Structure:
    """Parse ``_atom_site``; ``model`` selects the Nth distinct
    ``pdbx_PDB_model_num`` in file order (1-based, default first).  The
    C++ path when its library loads, else the pure-Python one."""
    st = _parse_native(text, include_hetatm, model)
    if st is not None:
        return st
    names, ress, chains, rids, icds, xyz = [], [], [], [], [], []
    alts, occs = [], []
    models_seen: list = []
    for idx, rows in _scan_atom_site(_tokenize_cif(text)):

        def col(row, *keys, default=None):
            for k in keys:
                p = idx.get(k)
                if p is not None and p < len(row) and row[p] not in (
                        ".", "?"):
                    return row[p]
            return default

        for row in rows:
            rec = col(row, "group_PDB", default="ATOM")
            if rec == "HETATM" and not include_hetatm:
                continue
            if rec not in ("ATOM", "HETATM"):
                continue
            m = col(row, "pdbx_PDB_model_num", default="1")
            if m not in models_seen:
                models_seen.append(m)
            if models_seen.index(m) + 1 != model:
                continue
            try:
                x = float(col(row, "Cartn_x"))
                y = float(col(row, "Cartn_y"))
                z = float(col(row, "Cartn_z"))
                rid = int(col(row, "auth_seq_id", "label_seq_id",
                              default="0"))
            except (TypeError, ValueError):
                continue
            try:
                occ = float(col(row, "occupancy", default="1.0"))
            except ValueError:
                occ = 1.0
            names.append(col(row, "auth_atom_id", "label_atom_id",
                             default="").strip('"').strip("'"))
            ress.append(col(row, "auth_comp_id", "label_comp_id",
                            default=""))
            chains.append(col(row, "auth_asym_id", "label_asym_id",
                              default="A"))
            rids.append(rid)
            icds.append(col(row, "pdbx_PDB_ins_code", default="") or "")
            alts.append(col(row, "label_alt_id", default="") or "")
            xyz.append((x, y, z))
            occs.append(occ)
    if model > 1 and model > len(models_seen):
        raise ValueError(
            f"model {model} requested but the file has only "
            f"{len(models_seen)} distinct pdbx_PDB_model_num value(s)")
    keep = select_altlocs(names, chains, rids, icds, alts, occs)
    coords = np.asarray(xyz, dtype=np.float32).reshape(-1, 3)[keep]
    atom_names = np.asarray([names[k] for k in keep], dtype="<U4")
    res_names = np.asarray([ress[k] for k in keep], dtype="<U3")
    return Structure(
        coords=coords, atom_names=atom_names, res_names=res_names,
        res_ids=np.asarray([rids[k] for k in keep], dtype=np.int32),
        chain_ids=np.asarray([chains[k] for k in keep], dtype="<U1"),
        types=assign_atom_types(res_names, atom_names),
        icodes=np.asarray([icds[k] for k in keep], dtype="<U1"))


def _parse_native(text: str, include_hetatm: bool,
                  model: int) -> Structure | None:
    """The C++ ``_atom_site`` extraction as a Structure, or None to fall
    back (no library, any failure, or ``_native_tokenize`` set False).

    As in the JAX package, the native model count spans every
    ``_atom_site`` row, so a model that exists only as excluded HETATM
    rows gives an empty Structure here where the Python parser raises."""
    if _native_tokenize is False:
        return None
    try:
        from deeplocalproteindocking_torch.native.cif_native import (
            parse_atom_site)
        (coords, names, ress, chains, rids, icds, alts, occs,
         model_count) = parse_atom_site(text, include_hetatm, model)
    except Exception:  # noqa: BLE001 -- no library: the Python parser
        return None
    if model > 1 and model > model_count:
        raise ValueError(
            f"model {model} requested but the file has only "
            f"{model_count} distinct pdbx_PDB_model_num value(s)")
    keep = select_altlocs(names, chains, rids, icds, alts, occs)
    res_names = np.asarray(ress[keep], dtype="<U3")
    atom_names = np.asarray(names[keep], dtype="<U4")
    return Structure(
        coords=coords[keep], atom_names=atom_names, res_names=res_names,
        res_ids=np.asarray(rids[keep], dtype=np.int32),
        chain_ids=np.asarray(chains[keep], dtype="<U1"),
        types=assign_atom_types(res_names, atom_names),
        icodes=np.asarray(icds[keep], dtype="<U1"))


def parse_mmcif(path: str | os.PathLike, include_hetatm: bool = False,
                model: int = 1) -> Structure:
    with open(path) as f:
        return parse_mmcif_text(f.read(), include_hetatm=include_hetatm,
                                model=model)


def count_models_mmcif_text(text: str) -> int:
    """Number of distinct ``pdbx_PDB_model_num`` values in the
    ``_atom_site`` loops (>= 1); rows without the column count as one
    model, as ``parse_mmcif_text`` selects them."""
    if _native_tokenize is not False:
        try:
            from deeplocalproteindocking_torch.native.cif_native import (
                parse_atom_site)
            return max(parse_atom_site(text, False, 1)[8], 1)
        except Exception:  # noqa: BLE001 -- no library: count in Python
            pass
    models: list = []
    for idx, rows in _scan_atom_site(_tokenize_cif(text)):
        mcol = idx.get("pdbx_PDB_model_num")
        for row in rows:
            m = row[mcol] if mcol is not None else "1"
            if m in (".", "?"):
                m = "1"
            if m not in models:
                models.append(m)
    return max(len(models), 1)


def parse_structure(path: str | os.PathLike, include_hetatm: bool = False,
                    model: int = 1) -> Structure:
    """By extension: ``.cif``/``.mmcif`` as mmCIF, anything else as PDB;
    ``model`` selects the Nth NMR model (1-based) in either format."""
    from deeplocalproteindocking_torch.structure.pdb import parse_pdb
    p = str(path)
    if p.lower().endswith((".cif", ".mmcif")):
        return parse_mmcif(p, include_hetatm=include_hetatm, model=model)
    return parse_pdb(p, include_hetatm=include_hetatm, model=model)


def count_models(path: str | os.PathLike) -> int:
    """Number of NMR models in a structure file (1 for a single model),
    counted as ``parse_structure(model=k)`` selects them."""
    from deeplocalproteindocking_torch.structure.pdb import (
        count_models_pdb_text)
    p = str(path)
    with open(p) as f:
        text = f.read()
    if p.lower().endswith((".cif", ".mmcif")):
        return count_models_mmcif_text(text)
    return count_models_pdb_text(text)
