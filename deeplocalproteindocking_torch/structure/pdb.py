"""PDB parsing and writing (host side, numpy).

Copy of ``deeplocalproteindocking_tpu/structure/pdb.py`` without the
ctypes native fast path: the pure-Python fixed-column parser is the rule
here.  Parsing runs once per structure, off the per-rotation hot path.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Sequence

import numpy as np

from deeplocalproteindocking_torch.structure.atom_types import (
    assign_atom_types)


@dataclasses.dataclass
class Structure:
    """Struct-of-arrays for one chain set of a protein."""
    coords: np.ndarray        # float32 [N, 3]
    atom_names: np.ndarray    # <U4 [N]
    res_names: np.ndarray     # <U3 [N]
    res_ids: np.ndarray       # int32 [N]
    chain_ids: np.ndarray     # <U1 [N]
    types: np.ndarray         # int32 [N], 11-type class, -1 = untyped
    icodes: np.ndarray = None  # <U1 [N] insertion codes ('' if absent)

    def __post_init__(self):
        if self.icodes is None:
            self.icodes = np.full(len(self.coords), "", dtype="<U1")

    def __len__(self) -> int:
        return int(self.coords.shape[0])

    def select(self, mask: np.ndarray) -> "Structure":
        return Structure(*(getattr(self, f.name)[mask]
                           for f in dataclasses.fields(self)))

    def typed(self) -> "Structure":
        """Drop atoms outside the 11-type table (hydrogens, hetero...)."""
        return self.select(self.types >= 0)

    def chains(self, chain_ids: Sequence[str]) -> "Structure":
        return self.select(np.isin(self.chain_ids, list(chain_ids)))

    def centered(self) -> "Structure":
        s = dataclasses.replace(self)
        s.coords = self.coords - self.coords.mean(axis=0, keepdims=True)
        return s

    @property
    def center(self) -> np.ndarray:
        return self.coords.mean(axis=0)


def _parse_atom_line(line: str):
    # PDB fixed columns (1-based): 13-16 atom name, 17 altloc,
    # 18-20 res name, 22 chain, 23-26 res seq, 27 insertion code,
    # 31-38/39-46/47-54 x/y/z, 55-60 occupancy.
    if len(line) < 54:
        return None
    altloc = line[16]
    name = line[12:16].strip()
    res = line[17:20].strip()
    chain = line[21]
    icode = line[26].strip() if len(line) > 26 else ""
    try:
        res_id = int(line[22:26])
        x = float(line[30:38])
        y = float(line[38:46])
        z = float(line[46:54])
    except ValueError:
        return None
    try:
        occ = float(line[54:60])
    except (ValueError, IndexError):
        occ = 1.0
    return name, res, chain, res_id, icode, x, y, z, altloc, occ


def select_altlocs(atom_names, chain_ids, res_ids, icodes, altlocs,
                   occupancies) -> np.ndarray:
    """Indices of atoms to keep after alternate-location resolution:
    for each physical atom (chain, res id, insertion code, atom name)
    the HIGHEST-occupancy altloc (first record wins ties), at its
    first-seen position."""
    n = len(atom_names)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    alt = np.asarray(altlocs)
    if bool(np.all((alt == "") | (alt == " "))):
        return np.arange(n, dtype=np.int64)
    keys = np.stack([np.asarray(chain_ids).astype("<U4"),
                     np.asarray(res_ids).astype("<U8"),
                     np.asarray(icodes).astype("<U4"),
                     np.asarray(atom_names).astype("<U4")], axis=1)
    flat = np.asarray(["|".join(k) for k in keys])
    _, first_idx, inv = np.unique(flat, return_index=True,
                                  return_inverse=True)
    occ = np.asarray(occupancies, dtype=np.float64)
    idx = np.arange(n)
    order = np.lexsort((idx, -occ, inv))
    inv_sorted = inv[order]
    group_start = np.ones(n, dtype=bool)
    group_start[1:] = inv_sorted[1:] != inv_sorted[:-1]
    winners = order[group_start]
    groups_of_winners = inv[winners]
    return winners[np.argsort(first_idx[groups_of_winners],
                              kind="stable")]


def parse_pdb_text(text: str, include_hetatm: bool = False,
                   model: int = 1) -> Structure:
    """Parse ATOM records; ``model`` selects the Nth NMR model (1-based,
    counted by MODEL records in file order; default first)."""
    names, ress, chains, rids, icds, xyz = [], [], [], [], [], []
    alts, occs = [], []
    cur_model = 0      # 0 = no MODEL record yet (single-model file)
    seen_models = 0
    for line in text.splitlines():
        rec = line[:6]
        if rec.startswith("MODEL"):
            seen_models += 1
            cur_model = seen_models
            continue
        if rec == "ENDMDL":
            if (cur_model or 1) >= model:
                break
            continue
        if cur_model != model and not (cur_model == 0 and model == 1):
            continue
        if rec.startswith("ATOM") or (include_hetatm
                                      and rec.startswith("HETATM")):
            parsed = _parse_atom_line(line)
            if parsed is None:
                continue
            name, res, chain, res_id, icode, x, y, z, alt, occ = parsed
            names.append(name)
            ress.append(res)
            chains.append(chain)
            rids.append(res_id)
            icds.append(icode)
            xyz.append((x, y, z))
            alts.append(alt.strip())
            occs.append(occ)
    if model > 1 and model > seen_models:
        raise ValueError(
            f"model {model} requested but the file declares only "
            f"{seen_models} MODEL record(s)"
            + (" (a file without MODEL records is a single model)"
               if seen_models == 0 else ""))
    keep = select_altlocs(names, chains, rids, icds, alts, occs)
    coords = np.asarray(xyz, dtype=np.float32).reshape(-1, 3)[keep]
    atom_names = np.asarray([names[i] for i in keep], dtype="<U4")
    res_names = np.asarray([ress[i] for i in keep], dtype="<U3")
    return Structure(
        coords=coords,
        atom_names=atom_names,
        res_names=res_names,
        res_ids=np.asarray([rids[i] for i in keep], dtype=np.int32),
        chain_ids=np.asarray([chains[i] for i in keep], dtype="<U1"),
        types=assign_atom_types(res_names, atom_names),
        icodes=np.asarray([icds[i] for i in keep], dtype="<U1"),
    )


def parse_pdb(path: str | os.PathLike, include_hetatm: bool = False,
              model: int = 1) -> Structure:
    with open(path) as f:
        return parse_pdb_text(f.read(), include_hetatm=include_hetatm,
                              model=model)


def write_pdb(path: str | os.PathLike, s: Structure) -> None:
    """Minimal PDB writer for pose output / debugging."""
    with open(path, "w") as f:
        for i in range(len(s)):
            name = s.atom_names[i]
            # PDB alignment rule: 1/2-char element names start in col 14.
            pname = f" {name:<3s}" if len(name) < 4 else name
            x, y, z = s.coords[i]
            icode = s.icodes[i] if s.icodes is not None else ""
            f.write(
                f"ATOM  {i + 1:5d} {pname}{'':1s}{s.res_names[i]:>3s} "
                f"{s.chain_ids[i]:1s}{int(s.res_ids[i]):4d}{icode:1s}   "
                f"{x:8.3f}{y:8.3f}{z:8.3f}{1.0:6.2f}{0.0:6.2f}\n")
        f.write("END\n")
