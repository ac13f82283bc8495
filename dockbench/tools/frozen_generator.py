"""Frozen copy of the port's synthetic-complex generator.

Copied from ``deeplocalproteindocking_torch`` (``structure/atom_types.py``,
``data/polymer.py`` and ``synthetic_complex`` / ``synthetic_band`` of
``data/benchmark.py``) so that ``make_pool.py`` makes the same complexes
whatever later becomes of the port.  numpy only; imports nothing of the
port.  ``Structure`` is a minimal stand-in with the port's fields.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass
class Structure:
    """The fields of the port's ``structure.pdb.Structure``."""
    coords: np.ndarray
    atom_names: np.ndarray
    res_names: np.ndarray
    res_ids: np.ndarray
    chain_ids: np.ndarray
    types: np.ndarray
    icodes: np.ndarray = None

    def __post_init__(self):
        if self.icodes is None:
            self.icodes = np.full(len(self.coords), "", dtype="<U1")

    def __len__(self) -> int:
        return int(self.coords.shape[0])

    def select(self, mask: np.ndarray) -> "Structure":
        return Structure(*(getattr(self, f.name)[mask]
                           for f in dataclasses.fields(self)))


# ---- structure/atom_types.py ----
NUM_ATOM_TYPES = 11

C_SP3, C_SP2, C_ARO, N_AMIDE, N_ARO, N_GUA, N_AMMO, O_CARBONYL, O_CARBOXYL, O_HYDROXYL, SULFUR = range(11)

ATOM_TYPE_NAMES = (
    "C_sp3", "C_sp2", "C_aromatic",
    "N_amide", "N_aromatic", "N_guanidinium", "N_ammonium",
    "O_carbonyl", "O_carboxyl", "O_hydroxyl",
    "S",
)

# Backbone atoms shared by every residue.
_BACKBONE = {
    "N": N_AMIDE,
    "CA": C_SP3,
    "C": C_SP2,        # carbonyl carbon
    "O": O_CARBONYL,
    "OXT": O_CARBOXYL,  # C-terminal carboxylate
}

# Side-chain atoms per residue (heavy atoms only, PDB v3 naming).
_SIDECHAIN = {
    "ALA": {"CB": C_SP3},
    "ARG": {"CB": C_SP3, "CG": C_SP3, "CD": C_SP3,
            "NE": N_GUA, "CZ": C_SP2, "NH1": N_GUA, "NH2": N_GUA},
    "ASN": {"CB": C_SP3, "CG": C_SP2, "OD1": O_CARBONYL, "ND2": N_AMIDE},
    "ASP": {"CB": C_SP3, "CG": C_SP2, "OD1": O_CARBOXYL, "OD2": O_CARBOXYL},
    "CYS": {"CB": C_SP3, "SG": SULFUR},
    "GLN": {"CB": C_SP3, "CG": C_SP3, "CD": C_SP2,
            "OE1": O_CARBONYL, "NE2": N_AMIDE},
    "GLU": {"CB": C_SP3, "CG": C_SP3, "CD": C_SP2,
            "OE1": O_CARBOXYL, "OE2": O_CARBOXYL},
    "GLY": {},
    "HIS": {"CB": C_SP3, "CG": C_ARO, "ND1": N_ARO, "CD2": C_ARO,
            "CE1": C_ARO, "NE2": N_ARO},
    "ILE": {"CB": C_SP3, "CG1": C_SP3, "CG2": C_SP3, "CD1": C_SP3},
    "LEU": {"CB": C_SP3, "CG": C_SP3, "CD1": C_SP3, "CD2": C_SP3},
    "LYS": {"CB": C_SP3, "CG": C_SP3, "CD": C_SP3, "CE": C_SP3,
            "NZ": N_AMMO},
    "MET": {"CB": C_SP3, "CG": C_SP3, "SD": SULFUR, "CE": C_SP3},
    "PHE": {"CB": C_SP3, "CG": C_ARO, "CD1": C_ARO, "CD2": C_ARO,
            "CE1": C_ARO, "CE2": C_ARO, "CZ": C_ARO},
    "PRO": {"CB": C_SP3, "CG": C_SP3, "CD": C_SP3},
    "SER": {"CB": C_SP3, "OG": O_HYDROXYL},
    "THR": {"CB": C_SP3, "OG1": O_HYDROXYL, "CG2": C_SP3},
    "TRP": {"CB": C_SP3, "CG": C_ARO, "CD1": C_ARO, "CD2": C_ARO,
            "NE1": N_ARO, "CE2": C_ARO, "CE3": C_ARO, "CZ2": C_ARO,
            "CZ3": C_ARO, "CH2": C_ARO},
    "TYR": {"CB": C_SP3, "CG": C_ARO, "CD1": C_ARO, "CD2": C_ARO,
            "CE1": C_ARO, "CE2": C_ARO, "CZ": C_ARO, "OH": O_HYDROXYL},
    "VAL": {"CB": C_SP3, "CG1": C_SP3, "CG2": C_SP3},
}

# Common alternate residue names mapped onto the standard 20.
_RES_ALIASES = {
    "MSE": "MET",  # selenomethionine; SE treated as SD below
    "HSD": "HIS", "HSE": "HIS", "HSP": "HIS", "HID": "HIS", "HIE": "HIS",
    "CYX": "CYS", "CYM": "CYS",
    "ASH": "ASP", "GLH": "GLU", "LYN": "LYS", "ARN": "ARG",
}

# Flattened lookup: (res, atom) -> type.
_TABLE = {}
for _res, _atoms in _SIDECHAIN.items():
    for _an, _ty in _BACKBONE.items():
        _TABLE[(_res, _an)] = _ty
    for _an, _ty in _atoms.items():
        _TABLE[(_res, _an)] = _ty
_TABLE[("MET", "SE")] = SULFUR  # MSE selenium


def assign_atom_types(res_names: Sequence[str],
                      atom_names: Sequence[str]) -> np.ndarray:
    """Map (residue name, atom name) pairs to the 11-type table.

    Returns ``int32[N]`` with ``-1`` for hydrogens, waters, hetero atoms
    and anything else outside the table; callers drop those atoms.
    """
    out = np.full(len(res_names), -1, dtype=np.int32)
    for i, (res, atom) in enumerate(zip(res_names, atom_names)):
        res = _RES_ALIASES.get(res, res)
        out[i] = _TABLE.get((res, atom), -1)
    return out


def type_histogram(types: np.ndarray) -> np.ndarray:
    """Count of atoms per type (ignores -1)."""
    t = types[types >= 0]
    return np.bincount(t, minlength=NUM_ATOM_TYPES)


# ---- data/polymer.py ----
def _unit(v: np.ndarray) -> np.ndarray:
    return v / max(float(np.linalg.norm(v)), 1e-12)


# ---------------------------------------------------------------------------
# CA trace: compact self-avoiding walk
# ---------------------------------------------------------------------------

def _ca_walk(rng: np.random.Generator, n_res: int, step: float = 3.8,
             min_sep: float = 5.0) -> np.ndarray:
    """Compact self-avoiding CA trace with protein-like local geometry.

    Virtual bonds are exactly ``step`` long; the CA(i-1)-CA(i)-CA(i+1)
    angle is confined to ~[80, 145] deg (the range real traces occupy);
    non-adjacent CAs stay >= ``min_sep`` apart; a center-pull keeps the
    walk inside a ball of protein-like density.  Dead ends backtrack.
    """
    R0 = 3.45 * n_res ** (1.0 / 3.0)
    for _restart in range(200):
        pts = [np.zeros(3)]
        d = _unit(rng.normal(size=3))
        backtracks = 0
        while len(pts) < n_res:
            p = pts[-1]
            placed = False
            for _att in range(80):
                w = 0.5 * d + rng.normal(size=3)
                r = float(np.linalg.norm(p))
                if r > R0:                       # globularity pull
                    w -= 2.0 * (r - R0 + 1.0) / R0 * (p / r)
                w = _unit(w)
                # CA-CA-CA angle = angle(-d, w); keep in [80, 145] deg.
                dot = float(w @ d)
                if not (-0.17 <= dot <= 0.82):
                    continue
                cand = p + step * w
                if len(pts) > 2:
                    dmin = float(np.linalg.norm(
                        np.asarray(pts[:-1]) - cand, axis=1).min())
                    if dmin < min_sep:
                        continue
                pts.append(cand)
                d = w
                placed = True
                break
            if not placed:
                if len(pts) > 2 and backtracks < 4 * n_res:
                    pts.pop()
                    d = _unit(pts[-1] - pts[-2])
                    backtracks += 1
                else:
                    break
        if len(pts) == n_res:
            ca = np.asarray(pts)
            return ca - ca.mean(0)
    raise RuntimeError(f"CA walk failed to close for n_res={n_res}")


# ---------------------------------------------------------------------------
# Backbone from the CA trace: rigid trans-peptide planes
# ---------------------------------------------------------------------------
# In-plane offsets of C(i) / N(i+1) / O(i) for a 3.8 A CA-CA virtual
# bond, solved from the ideal trans peptide (CA-C 1.52, C-N 1.33,
# N-CA 1.46, C=O 1.23, planar):  C and N sit on opposite sides of the
# CA-CA axis.
_C_U, _C_V = 1.421, 0.539
_N_U, _N_V = 2.384, -0.360
_O_U, _O_V = 0.193, 0.981      # unit direction from C, in-plane


def _backbone_from_ca(rng: np.random.Generator, ca: np.ndarray):
    """Place N/C/O for each residue from the CA trace.

    The peptide-plane orientation about each CA-CA axis is a free
    rotation; it is chosen greedily to maximize the clearance of the
    link's C/N/O atoms from sequence-distant backbone already placed
    (real chains do the same job with hydrogen-bonding geometry).
    Returns (N, C, O) arrays of shape [n_res, 3].
    """
    n = len(ca)
    N = np.zeros((n, 3))
    C = np.zeros((n, 3))
    O = np.zeros((n, 3))
    placed = []       # committed backbone atoms of earlier links
    placed_res = []
    prev_u = None
    for i in range(n - 1):
        ui = _unit(ca[i + 1] - ca[i])
        cands = []
        if prev_u is not None:
            ref = np.cross(ui, prev_u)
            if np.linalg.norm(ref) > 1e-6:
                ref = _unit(ref - (ref @ ui) * ui)
                cands += [ref, -ref]
        for _ in range(6):
            r = rng.normal(size=3)
            r -= (r @ ui) * ui
            cands.append(_unit(r))
        # Clearance reference: every CA plus all committed backbone
        # atoms and CBs, masked PER ATOM PAIR by sequence distance >= 2
        # (the link-level mask missed O(i)..N(i+2) contacts, measured
        # at ~1.9 A — real turns sit at ~2.9).
        ref_pts = np.concatenate(
            [ca, np.asarray(placed).reshape(-1, 3)], axis=0)
        ref_res = np.concatenate(
            [np.arange(n), np.asarray(placed_res, dtype=int)])
        trio_res = np.array([i, i + 1, i])
        pair_ok = np.abs(ref_res[:, None] - trio_res[None]) >= 2
        best = None
        for v in cands:
            trio = np.stack([
                ca[i] + _C_U * ui + _C_V * v,
                ca[i] + _N_U * ui + _N_V * v,
                ca[i] + _C_U * ui + _C_V * v
                + 1.23 * (_O_U * ui + _O_V * v)])
            dist = np.linalg.norm(ref_pts[:, None] - trio[None],
                                  axis=-1)
            dmin = float(np.where(pair_ok, dist, 99.0).min())
            if best is None or dmin > best[0]:
                best = (dmin, v, trio)
            if dmin >= 2.8:
                break
        _, v, (Ci, Ni1, Oi) = best
        C[i], N[i + 1], O[i] = Ci, Ni1, Oi
        placed += [Ci, Ni1, Oi]
        placed_res += [i, i + 1, i]
        if i == 0:
            N[0] = ca[0] + 1.46 * _unit(-ui + 0.6 * v)
        if i == n - 2:
            C[n - 1] = ca[n - 1] + 1.52 * _unit(ui + 0.6 * v)
            O[n - 1] = C[n - 1] + 1.23 * _unit(v - 0.4 * ui)
        # Residue i's CB is now fully determined; later links must
        # steer around it (measured: backbone-O vs early-CB at 1.6 A
        # without this).
        placed.append(_cb_position(N[i], ca[i], C[i]))
        placed_res.append(i)
        prev_u = ui
    return N, C, O


def _cb_position(N: np.ndarray, CA: np.ndarray, C: np.ndarray) -> np.ndarray:
    """Tetrahedral L-configuration CB from the backbone frame."""
    e1 = _unit(N - CA)
    e2 = _unit(C - CA)
    bis = _unit(e1 + e2)
    perp = _unit(np.cross(e2, e1))     # sign fixes L-chirality
    return CA + 1.53 * (-0.590 * bis + 0.807 * perp)


# ---------------------------------------------------------------------------
# Side chains: NeRF extension + ring templates
# ---------------------------------------------------------------------------

def _nerf(a, b, c, r, theta, phi):
    """Place atom D given chain A-B-C, bond |CD|=r, angle(BCD)=theta,
    dihedral(ABCD)=phi (radians)."""
    bc = _unit(c - b)
    nrm = _unit(np.cross(b - a, bc))
    m = np.cross(nrm, bc)
    d = np.array([-r * np.cos(theta),
                  r * np.sin(theta) * np.cos(phi),
                  r * np.sin(theta) * np.sin(phi)])
    return c + d[0] * bc + d[1] * m + d[2] * nrm


_BOND = {"C": 1.52, "N": 1.42, "O": 1.35, "S": 1.81}

# Linear/branched side-chain topology: ordered (atom, parent) pairs past
# CB.  Branch siblings (same parent, after the first child) get +-120 deg
# torsion offsets.  Ring residues list only CB->CG here; the ring is a
# planar template (below).
_SC_TOPO = {
    "ALA": [],
    "SER": [("OG", "CB")],
    "CYS": [("SG", "CB")],
    "VAL": [("CG1", "CB"), ("CG2", "CB")],
    "ASP": [("CG", "CB"), ("OD1", "CG"), ("OD2", "CG")],
    "ASN": [("CG", "CB"), ("OD1", "CG"), ("ND2", "CG")],
    "LEU": [("CG", "CB"), ("CD1", "CG"), ("CD2", "CG")],
    "LYS": [("CG", "CB"), ("CD", "CG"), ("CE", "CD"), ("NZ", "CE")],
    "ARG": [("CG", "CB"), ("CD", "CG"), ("NE", "CD"), ("CZ", "NE"),
            ("NH1", "CZ"), ("NH2", "CZ")],
    "PHE": [("CG", "CB")],
    "HIS": [("CG", "CB")],
    "TRP": [("CG", "CB")],
}

RESIDUES = tuple(_SC_TOPO)


def _ring_template(res: str):
    """Planar ring atoms as 2D coordinates with CG at the origin and the
    ring extending along +x (the CB->CG direction)."""
    if res == "PHE":
        s = 1.39
        ctr = np.array([s, 0.0])
        names = ["CD1", "CE1", "CZ", "CE2", "CD2"]
        pts = [ctr + s * np.array([np.cos(np.deg2rad(180 - 60 * k)),
                                   np.sin(np.deg2rad(180 - 60 * k))])
               for k in range(1, 6)]
        return names, pts
    if res == "HIS":
        s = 1.37
        R = s / (2 * np.sin(np.deg2rad(36)))
        ctr = np.array([R, 0.0])
        names = ["ND1", "CE1", "NE2", "CD2"]
        pts = [ctr + R * np.array([np.cos(np.deg2rad(180 - 72 * k)),
                                   np.sin(np.deg2rad(180 - 72 * k))])
               for k in range(1, 5)]
        return names, pts
    if res == "TRP":
        s = 1.37
        R = s / (2 * np.sin(np.deg2rad(36)))
        ctr = np.array([R, 0.0])
        penta = {}
        for k, nm in enumerate(["CD1", "NE1", "CE2", "CD2"], start=1):
            penta[nm] = ctr + R * np.array(
                [np.cos(np.deg2rad(180 - 72 * k)),
                 np.sin(np.deg2rad(180 - 72 * k))])
        # Benzene ring fused on the CE2-CD2 edge, on the far side of the
        # pentagon center.
        e2, d2 = penta["CE2"], penta["CD2"]
        mid = 0.5 * (e2 + d2)
        edge = _unit(d2 - e2)
        perp = np.array([-edge[1], edge[0]])
        if (mid + perp) @ (mid - ctr) < (mid - perp) @ (mid - ctr):
            perp = -perp
        hex_ctr = mid + 1.39 * np.sqrt(3) / 2 * perp
        # Walk the hexagon from CE2 away from CD2.
        def rot(p, deg):
            a = np.deg2rad(deg)
            Rm = np.array([[np.cos(a), -np.sin(a)],
                           [np.sin(a), np.cos(a)]])
            return Rm @ (p - hex_ctr) + hex_ctr
        sgn = 60 if np.linalg.norm(rot(e2, 60) - d2) > s else -60
        names = list(penta) + ["CZ2", "CH2", "CZ3", "CE3"]
        pts = list(penta.values()) + [rot(e2, sgn * k)
                                      for k in range(1, 5)]
        return names, pts
    raise KeyError(res)


_ROTAMER_WELLS = np.deg2rad([-60.0, 60.0, 180.0])


def _build_sidechain(rng, res, N, CA, C, CB):
    """Build one residue's side chain.

    Returns ``(atoms, self_min)``: the atom-name -> position dict
    (CB and beyond) and the residue's *self-clearance* — the smallest
    distance between a placed side-chain atom and any same-residue atom
    more than two bonds away (long chains like ARG/LYS can curl back
    onto their own backbone; measured 0.27 A without this guard).
    First-child torsions resample when they fold back.
    """
    pos = {"N": N, "CA": CA, "C": C, "CB": CB}
    parent_of = {"CB": "CA", "CA": "N", "N": "C"}  # N's "parent" unused
    first_child_phi = {}
    self_min = 99.0
    for atom, parent in _SC_TOPO[res]:
        gp = parent_of[parent]
        ggp = parent_of[gp]
        # 1-2/1-3 neighbors whose distance is fixed by bond geometry:
        near = {parent, gp} | {a for a, p in parent_of.items()
                               if p == parent}
        others = np.asarray([v for k, v in pos.items()
                             if k not in near]).reshape(-1, 3)
        if parent in first_child_phi:
            phi = first_child_phi[parent] + np.deg2rad(
                120.0 if atom[-1] not in "2" else -120.0)
            cand_phis = [phi]
        else:
            cand_phis = [w + np.deg2rad(rng.normal(0.0, 12.0))
                         for w in rng.permutation(_ROTAMER_WELLS)]
        theta = np.deg2rad(120.0 if atom[0] in "ON" and atom != "NE"
                           else 111.0)
        best = None
        for phi in cand_phis:
            p = _nerf(pos[ggp], pos[gp], pos[parent],
                      _BOND[atom[0]], theta, phi)
            d = (float(np.linalg.norm(others - p, axis=1).min())
                 if len(others) else 99.0)
            if best is None or d > best[0]:
                best = (d, phi, p)
            if d >= 2.4:
                break
        d, phi, p = best
        self_min = min(self_min, d)
        pos[atom] = p
        if parent not in first_child_phi:
            first_child_phi[parent] = phi
        parent_of[atom] = parent
    if res in ("PHE", "HIS", "TRP"):
        cg = pos["CG"]
        x = _unit(cg - CB)
        r = rng.normal(size=3)
        r -= (r @ x) * x
        y0 = _unit(r)
        ring_ref = np.asarray(
            [v for k, v in pos.items()
             if k not in ("CG", "CB")]).reshape(-1, 3)
        best = None
        # chi2: ring-plane rotation about the CB-CG axis, clash-picked.
        for _ in range(6):
            chi2 = rng.uniform(0.0, 2 * np.pi)
            y = np.cos(chi2) * y0 + np.sin(chi2) * np.cross(x, y0)
            ring = {nm: cg + px * x + py * y
                    for nm, (px, py) in zip(*_ring_template(res))}
            pts = np.asarray(list(ring.values()))
            d = float(np.linalg.norm(
                ring_ref[:, None] - pts[None], axis=-1).min())
            if best is None or d > best[0]:
                best = (d, ring)
            if d >= 2.4:
                break
        d, ring = best
        self_min = min(self_min, d)
        pos.update(ring)
    return {k: v for k, v in pos.items()
            if k not in ("N", "CA", "C")}, self_min


_BACKBONE_ORDER = ("N", "CA", "C", "O")


def polymer_chain(rng: np.random.Generator, n_res: int,
                  chain: str = "A") -> Structure:
    """Compact mini-protein with covalent polymer geometry.

    Bond-geometry guarantees (asserted by tests/test_torch_polymer.py):
    CA-CA 3.8 A, N-CA ~1.46, CA-C 1.52, C-N(+1) ~1.33, C=O 1.23,
    CA-CB 1.53, side-chain bonds 1.3-1.9 A, and no non-bonded heavy-atom
    pair of sequence-distant residues under ~2.4 A (clash-driven rotamer
    resampling).
    """
    ca = _ca_walk(rng, n_res)
    N, C, O = _backbone_from_ca(rng, ca)
    res_pool = list(RESIDUES)
    # All backbone atoms AND CBs are known up front (CB is a pure
    # function of the backbone frame), so side-chain placement can
    # clash-check against the complete future backbone (no early side
    # chain collides with backbone placed after it).
    cb_all = np.stack([_cb_position(N[i], ca[i], C[i])
                       for i in range(n_res)])
    bb_all = np.concatenate([N, ca, C, O, cb_all], axis=0)
    bb_res = np.tile(np.arange(n_res), 5)
    # Crowded cores fall back to smaller residues, as real cores do.
    _DOWNSIZE = ("VAL", "SER", "ALA")

    def fit_sidechain(i, res0, ref_pts, tries):
        best = None
        for res in (res0,) + _DOWNSIZE:
            for _try in range(tries):
                sc, self_min = _build_sidechain(
                    rng, res, N[i], ca[i], C[i], cb_all[i])
                pts = np.asarray(list(sc.values()))
                inter = (float(np.linalg.norm(
                    ref_pts[:, None, :] - pts[None], axis=-1).min())
                    if len(ref_pts) and len(pts) else 99.0)
                dmin = min(inter, self_min)
                if best is None or dmin > best[0]:
                    best = (dmin, res, sc)
            if best[0] >= 2.3:
                break
        return best

    res_of = [None] * n_res          # residue name
    sc_of = [None] * n_res           # side-chain dict (CB + beyond)
    sc_placed, sc_res = [], []
    for i in range(n_res):
        res0 = res_pool[rng.integers(len(res_pool))]
        far_bb = bb_all[np.abs(bb_res - i) >= 2]
        far_sc = np.asarray(
            [p for p, j in zip(sc_placed, sc_res)
             if abs(j - i) >= 2]).reshape(-1, 3)
        _, res, sc = fit_sidechain(
            i, res0, np.concatenate([far_bb, far_sc], axis=0), 8)
        res_of[i], sc_of[i] = res, sc
        for p in sc.values():
            sc_placed.append(p)
            sc_res.append(i)
    # Repair sweeps: with the whole chain known, re-sample any side
    # chain still clashing (sequence-distant contact < 2.25 A).
    for _sweep in range(2):
        all_sc = np.asarray(sc_placed).reshape(-1, 3)
        all_sc_res = np.asarray(sc_res)
        dirty = False
        for i in range(n_res):
            mine = np.asarray(list(sc_of[i].values()))
            far = np.concatenate(
                [bb_all[np.abs(bb_res - i) >= 2],
                 all_sc[np.abs(all_sc_res - i) >= 2]], axis=0)
            dmin = float(np.linalg.norm(
                far[:, None] - mine[None], axis=-1).min())
            if dmin >= 2.25:
                continue
            nd, nres, nsc = fit_sidechain(i, res_of[i], far, 16)
            if nd > dmin:
                res_of[i], sc_of[i] = nres, nsc
                keep = all_sc_res != i
                all_sc = np.concatenate(
                    [all_sc[keep],
                     np.asarray(list(nsc.values()))], axis=0)
                all_sc_res = np.concatenate(
                    [all_sc_res[keep],
                     np.full(len(nsc), i)])
                dirty = True
        sc_placed = list(all_sc)
        sc_res = list(all_sc_res)
        if not dirty:
            break

    names, ress, rids, xyz = [], [], [], []
    for i in range(n_res):
        atoms = dict(zip(_BACKBONE_ORDER, (N[i], ca[i], C[i], O[i])))
        atoms.update(sc_of[i])
        for an, p in atoms.items():
            names.append(an)
            ress.append(res_of[i])
            rids.append(i + 1)
            xyz.append(p)
    coords = np.asarray(xyz, dtype=np.float32)
    atom_names = np.asarray(names, dtype="<U4")
    res_names = np.asarray(ress, dtype="<U3")
    return Structure(
        coords=coords, atom_names=atom_names, res_names=res_names,
        res_ids=np.asarray(rids, dtype=np.int32),
        chain_ids=np.full(len(names), chain, dtype="<U1"),
        types=assign_atom_types(res_names, atom_names),
    )


# ---- data/benchmark.py ----
# Residues with their side-chain heavy atoms, used for synthesis.
_RES_ATOMS = {
    "ALA": ["CB"],
    "SER": ["CB", "OG"],
    "CYS": ["CB", "SG"],
    "VAL": ["CB", "CG1", "CG2"],
    "ASP": ["CB", "CG", "OD1", "OD2"],
    "ASN": ["CB", "CG", "OD1", "ND2"],
    "LEU": ["CB", "CG", "CD1", "CD2"],
    "LYS": ["CB", "CG", "CD", "CE", "NZ"],
    "PHE": ["CB", "CG", "CD1", "CD2", "CE1", "CE2", "CZ"],
    "ARG": ["CB", "CG", "CD", "NE", "CZ", "NH1", "NH2"],
    "HIS": ["CB", "CG", "ND1", "CD2", "CE1", "NE2"],
    "TRP": ["CB", "CG", "CD1", "CD2", "NE1", "CE2", "CE3", "CZ2", "CZ3",
            "CH2"],
}


@dataclasses.dataclass
class Complex:
    """A receptor/ligand pair; ligand in its native (bound) pose."""
    name: str
    receptor: Structure
    ligand: Structure


def _random_chain(rng: np.random.Generator, n_res: int,
                  chain: str) -> Structure:
    """Compact globular mini-protein with valid PDB atom/residue names:
    residue centers packed into a ball by min-distance rejection."""
    res_pool = list(_RES_ATOMS)
    radius = 3.2 * n_res ** (1.0 / 3.0)
    centers = []
    while len(centers) < n_res:
        p = rng.uniform(-radius, radius, 3)
        if np.linalg.norm(p) > radius:
            continue
        if centers and np.linalg.norm(
                np.asarray(centers) - p, axis=1).min() < 4.6:
            continue
        centers.append(p)
    names, ress, rids, xyz = [], [], [], []
    for ri, ca in enumerate(centers):
        res = res_pool[rng.integers(len(res_pool))]
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        local = {
            "N": np.array([-1.45, 0.0, 0.0]),
            "CA": np.zeros(3),
            "C": np.array([1.52, 0.0, 0.0]),
            "O": np.array([2.10, 1.05, 0.0]),
        }
        for k, an in enumerate(_RES_ATOMS[res]):
            local[an] = np.array([0.0, 1.5 + 1.3 * (k // 2),
                                  1.3 * (k % 2)])
        for an, off in local.items():
            names.append(an)
            ress.append(res)
            rids.append(ri + 1)
            xyz.append(ca + q @ off)
    atom_names = np.asarray(names, dtype="<U4")
    res_names = np.asarray(ress, dtype="<U3")
    return Structure(
        coords=np.asarray(xyz, dtype=np.float32), atom_names=atom_names,
        res_names=res_names, res_ids=np.asarray(rids, dtype=np.int32),
        chain_ids=np.full(len(names), chain, dtype="<U1"),
        types=assign_atom_types(res_names, atom_names),
    )


def _deform(rng: np.random.Generator, s: Structure, rmsd: float,
            lengthscale: float = 8.0, n_modes: int = 4) -> Structure:
    """Smooth Gaussian-RBF displacement field with per-atom RMS ``rmsd``
    and no net translation (the unbound-conformer stand-in)."""
    if rmsd <= 0.0:
        return s
    c = s.coords.astype(np.float64)
    lo, hi = c.min(0), c.max(0)
    centers = rng.uniform(lo, hi, size=(n_modes, 3))
    amps = rng.normal(size=(n_modes, 3))
    d2 = ((c[:, None, :] - centers[None]) ** 2).sum(-1)
    disp = np.exp(-d2 / (2.0 * lengthscale ** 2)) @ amps
    disp -= disp.mean(0)
    rms = float(np.sqrt((disp ** 2).sum(1).mean()))
    disp *= rmsd / max(rms, 1e-9)
    return dataclasses.replace(s, coords=(c + disp).astype(np.float32))


def synthetic_complex(seed: int = 0, n_res_rec: int = 30,
                      n_res_lig: int = 15, unbound_rmsd: float = 0.0,
                      backbone: bool = False) -> Complex:
    """Deterministic synthetic docked complex: one globular blob carved
    into a receptor and the surface chunk of ``n_res_lig`` residues
    nearest a seed residue (the ligand).  The receptor is centered at the
    origin; the ligand keeps its native placement.

    ``backbone=True`` builds the blob as one chain with covalent polymer
    geometry (``data/polymer.py``) and seeds the carve at the residue of
    the ~75th depth percentile, which carves a concave native interface;
    the blob generator seeds it at the most protruding residue.
    ``unbound_rmsd > 0`` then deforms receptor and ligand independently
    in place (:func:`_deform`), the unbound protocol."""
    rng = np.random.default_rng(seed)
    if backbone:
        whole = polymer_chain(rng, n_res_rec + n_res_lig, "A")
    else:
        whole = _random_chain(rng, n_res_rec + n_res_lig, "A")
    n_res = n_res_rec + n_res_lig
    res_centers = np.stack([
        whole.coords[whole.res_ids == i + 1].mean(0) for i in range(n_res)])
    depth = np.linalg.norm(res_centers - whole.coords.mean(0), axis=1)
    if backbone:
        seed_res = int(np.argsort(depth)[int(0.75 * (n_res - 1))])
    else:
        seed_res = int(np.argmax(depth))
    d_to_seed = np.linalg.norm(res_centers - res_centers[seed_res], axis=1)
    lig_res = set((np.argsort(d_to_seed)[:n_res_lig] + 1).tolist())
    lig_mask = np.isin(whole.res_ids, list(lig_res))
    rec = whole.select(~lig_mask)
    lig = whole.select(lig_mask)
    lig.chain_ids = np.full(len(lig), "B", dtype="<U1")
    shift = rec.coords.mean(0)
    rec.coords = rec.coords - shift
    lig.coords = lig.coords - shift
    if unbound_rmsd > 0.0:
        rec = _deform(rng, rec, unbound_rmsd)
        lig = _deform(rng, lig, unbound_rmsd)
    return Complex(name=f"synth{seed}", receptor=rec, ligand=lig)


def synthetic_band(seed0: int, n: int, widen: bool = False,
                   unbound: float = 0.0, backbone: bool = False) -> list:
    """Complexes of seeds ``seed0 .. seed0 + n - 1``, the JAX tools'
    bands (training 200+, validation 50+, held-out report 100+).
    ``widen`` draws sizes from a 9 x 5 grid (receptors 12..20, ligands
    6..10 residues); otherwise receptors 14..18 and ligands 7..9."""
    if widen:
        return [synthetic_complex(seed=seed0 + s, n_res_rec=12 + s % 9,
                                  n_res_lig=6 + (s // 9) % 5,
                                  unbound_rmsd=unbound, backbone=backbone)
                for s in range(n)]
    return [synthetic_complex(seed=seed0 + s, n_res_rec=14 + s % 5,
                              n_res_lig=7 + s % 3, unbound_rmsd=unbound,
                              backbone=backbone) for s in range(n)]
