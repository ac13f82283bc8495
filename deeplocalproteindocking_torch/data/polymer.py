"""Polymer-backbone synthetic mini-proteins.

The port's own copy of ``deeplocalproteindocking_tpu/data/polymer.py``
(numpy only).  It draws from the caller's ``np.random.Generator`` in the
same order with the same arithmetic, so a complex built from one seed
equals the JAX package's bit for bit.  Chains have real protein covalent
geometry:

* a compact self-avoiding CA walk (3.8 A virtual bonds, protein-like
  CA-CA-CA angles, center-pull for globularity, backtracking);
* backbone N/C/O placed by the rigid trans-peptide-plane construction
  (exact 1.46/1.52/1.33/1.23 A bond lengths by construction);
* CB at the tetrahedral L-configuration position from the N/CA/C frame;
* side chains grown by NeRF extension with torsions sampled from
  staggered rotamer wells ({-60, 60, 180} deg + noise), planar ring
  templates for PHE/HIS/TRP, and clash-driven rotamer resampling.

The carve-in-two + unbound-deformation protocol on top of these chains
is ``data/benchmark.synthetic_complex(backbone=True)``.
"""
from __future__ import annotations

import numpy as np

from deeplocalproteindocking_torch.structure.atom_types import (
    assign_atom_types)
from deeplocalproteindocking_torch.structure.pdb import Structure


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
