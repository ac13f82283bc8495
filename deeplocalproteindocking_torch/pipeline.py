"""End-to-end docking pipeline: structures in, ranked poses out.

Port of ``deeplocalproteindocking_tpu/pipeline.py``'s docking stages:

    parse/type (structure/) -> splat (grids/) -> represent (models/)
    -> resplat sweep (sweep/resplat.py) -> cluster (sweep/cluster.py)

then, as the two-stage protocol, ``rescore`` (a dense local cone sweep
around each top head, all heads in one head-batched sweep) and
``refine`` (gradient ascent in continuous pose space,
``sweep/refine.py``).  ``dock_ensemble`` docks every pair of an NMR
ensemble as complex-batched sweeps (``parallel/batch_eval.py``) and
merges one ranked set; ``_batched_receptor_engine`` builds the receptor
halves of a group of complexes at once for ``evaluation.
run_benchmark_batched``.

Receptor-side tensors (representations, the engine tuple) are built
under ``torch.no_grad``, never ``inference_mode``: ``refine`` reuses
them and saves them for backward.  Only the sweep loop runs in
``inference_mode``.

Two scoring modes: **learned** (the 3-D CNN representation + learned
channel coupling, optionally SVD-truncated to rank r and folded into the
last conv) and **shape** (``params=None``: analytic surface/core
channels with the fixed attract/repulse coupling).

Geometry: receptor centered at the origin, ligand centered at its own
center; a pose is ``x -> R x + shift * resolution``.
"""
from __future__ import annotations

import itertools
import math
import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from deeplocalproteindocking_torch.config import DockConfig
from deeplocalproteindocking_torch.correlate.fft import (
    coupled_receptor, resolve_engine, translation_mask)
from deeplocalproteindocking_torch.data.benchmark import (
    Complex, structure_to_device)
from deeplocalproteindocking_torch.grids.voxelize import separable_splat
from deeplocalproteindocking_torch.models.representation import (
    conv3d_channels_last, shape_channels)
from deeplocalproteindocking_torch.models.scoring import ScoringModel
from deeplocalproteindocking_torch.parallel import batch_eval
from deeplocalproteindocking_torch.structure.pdb import Structure
from deeplocalproteindocking_torch.structure.so3 import (
    local_rotations, super_fibonacci_rotations)
from deeplocalproteindocking_torch.sweep.cluster import (
    cluster_pose_set, nms_cluster, pose_pairwise_rmsd)
from deeplocalproteindocking_torch.sweep.refine import refine_poses
from deeplocalproteindocking_torch.sweep.resplat import (
    auto_ligand_grid, dock_sweep_resplat)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class PoseSet(NamedTuple):
    """Ranked rigid-body poses of the (centered) ligand, host arrays."""
    scores: np.ndarray        # [K]
    rotations: np.ndarray     # [K, 3, 3]
    translations: np.ndarray  # [K, 3] Angstrom
    rot_idx: np.ndarray       # [K] into the rotation set
    shifts: np.ndarray        # [K, 3] voxel shifts
    rank_scores: Optional[np.ndarray] = None  # [K] ranking statistic

    def __len__(self):
        return len(self.scores)

    def ligand_coords(self, lig_coords: np.ndarray, i: int) -> np.ndarray:
        """Posed ligand coordinates (receptor frame) for pose ``i``."""
        return (np.asarray(lig_coords) @ self.rotations[i].T
                + self.translations[i])


def shape_complementarity_reps(vol: torch.Tensor, *,
                               core_weight: float = 12.0,
                               threshold: float = 0.35, shell: int = 2):
    """Analytic (surface, core) rep ``[..., L, L, L, 2]`` of a density
    volume and the fixed coupling ``[[1, 0], [0, -core_weight]]``."""
    return shape_channels(vol, core_weight=core_weight,
                          threshold=threshold, shell=shell)


def dock_score_mask(cfg: DockConfig, lig_c: Structure,
                    translation_center=None, max_shift=None,
                    device: torch.device | str = "cuda"):
    """Translation mask ``[L, L, L]`` bool for one complex, or None.

    Combines the circular-wraparound guard (shifts whose ligand leaves
    the box alias under circular correlation) with the optional
    local-docking restriction around ``translation_center``.
    """
    lig_half_vox = int(np.ceil(
        (np.abs(lig_c.typed().coords).max() + 3.0 * cfg.sigma)
        / cfg.resolution))
    wrap_cap = max(1, cfg.grid_size // 2 - lig_half_vox)
    score_mask = None
    if wrap_cap < cfg.grid_size // 2:
        score_mask = translation_mask(cfg.grid_size, wrap_cap,
                                      device=device)
    if max_shift is not None:
        center = (None if translation_center is None
                  else torch.as_tensor(np.asarray(translation_center),
                                       dtype=torch.int64))
        local = translation_mask(
            cfg.grid_size, int(round(max_shift / cfg.resolution)), center,
            device=device)
        score_mask = local if score_mask is None else score_mask & local
    return score_mask


def stack_score_masks(masks: list, grid_size: int,
                      device: torch.device | str = "cuda"):
    """``[n, L, L, L]`` bool of per-complex masks from ``dock_score_mask``
    (None: every shift allowed), or None when every mask is None."""
    if all(m is None for m in masks):
        return None
    full = torch.ones((grid_size,) * 3, dtype=torch.bool, device=device)
    return torch.stack([full if m is None else m for m in masks])


def coupling_deviation_capture(coupling, rank: int, *,
                               shape_prior: bool = False,
                               core_weight: float = 12.0):
    """``(kept, dev)``: fraction of the LEARNED coupling deviation
    ``A - prior`` that a rank-``rank`` SVD truncation keeps, and the
    deviation norm (prior: ``diag(1, -core_weight)`` on the first two
    channels for the hybrid model, identity for the plain one)."""
    A = np.asarray(coupling, np.float64)
    SB = np.zeros_like(A)
    if shape_prior:
        SB[0, 0] = 1.0
        if min(A.shape) > 1:
            SB[1, 1] = -core_weight
    else:
        np.fill_diagonal(SB, 1.0)
    U, s, Vt = np.linalg.svd(A)
    r = min(rank, len(s))
    Ar = (U[:, :r] * s[:r]) @ Vt[:r]
    dev = float(np.linalg.norm(A - SB))
    lost = float(np.linalg.norm(A - Ar))
    kept = 1.0 if dev <= 0 else 1.0 - lost / dev
    return kept, dev


def min_licensed_rank(coupling, *, shape_prior: bool = False,
                      core_weight: float = 12.0,
                      threshold: float = 0.95) -> int:
    """Smallest truncation rank keeping >= ``threshold`` of the learned
    coupling deviation."""
    C = min(np.asarray(coupling).shape)
    for r in range(1, C + 1):
        kept, dev = coupling_deviation_capture(
            coupling, r, shape_prior=shape_prior, core_weight=core_weight)
        if dev <= 0 or kept >= threshold:
            return r
    return C


def ensemble_pair_batch(H_example: torch.Tensor,
                        budget_bytes: int = 512 * 1024 * 1024,
                        cap: int = 32) -> int:
    """Pairs per batched sweep of ``dock_ensemble``: as many as keep the
    stacked receptor spectra (one ``H_example``-sized tensor per pair)
    within ``budget_bytes``, at most ``cap``, at least 1.  The same
    budget, cap and formula as the JAX package, so pair batches split
    alike; ``H_example`` may be a ``meta`` tensor."""
    per_pair = math.prod(H_example.shape) * H_example.element_size()
    return max(1, min(cap, budget_bytes // max(per_pair, 1)))


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class DockingPipeline:
    """Docking with one model on one device.

    ``params`` is a ``ScoringModel`` state_dict (``weights.load_npz``) or
    None for shape mode; ``device`` is where every tensor of the sweep
    lives.
    """

    def __init__(self, config: DockConfig, params: Optional[dict] = None,
                 device: torch.device | str = "cuda"):
        self.config = config
        self.device = torch.device(device)
        self.model = ScoringModel(
            features=config.rep_features, kernel=config.rep_kernel,
            dtype=_DTYPES[config.compute_dtype],
            shape_prior=config.shape_prior,
            in_channels=config.num_atom_types).to(self.device)
        self.model.eval()
        self.model.requires_grad_(False)     # inference only
        self.params = None
        # Spectral parts memoized per (params, rank): the SVD runs once.
        self._closure_memo: dict = {}
        if params is not None:
            self.load_params(params)

    # ---- building blocks ----
    def load_params(self, state_dict: dict) -> dict:
        self.model.load_state_dict(state_dict)
        self.params = self.model.state_dict()
        self._closure_memo.clear()
        return self.params

    def init_params(self, generator: Optional[torch.Generator] = None
                    ) -> dict:
        """Fresh flax-style weights drawn from ``generator`` (default:
        a CPU generator seeded with ``config.seed``)."""
        if generator is None:
            generator = torch.Generator().manual_seed(self.config.seed)
        model = ScoringModel(
            features=self.config.rep_features,
            kernel=self.config.rep_kernel,
            shape_prior=self.config.shape_prior,
            in_channels=self.config.num_atom_types)
        model.reset_parameters(generator)
        return self.load_params(model.state_dict())

    def voxelize(self, s: Structure, max_atoms: Optional[int] = None):
        cfg = self.config
        coords, types, mask = structure_to_device(
            s, max_atoms, bucket=cfg.atom_bucket or None,
            device=self.device)
        return separable_splat(
            coords, types, mask, grid_size=cfg.grid_size,
            resolution=cfg.resolution, sigma=cfg.sigma,
            num_types=cfg.num_atom_types,
            atom_chunk=4096 if len(coords) > 4096 else None)

    def representations(self, rec_vol: torch.Tensor,
                        lig_vol: torch.Tensor):
        if self.params is None:
            rep_rec, coupling = shape_complementarity_reps(rec_vol)
            rep_lig, _ = shape_complementarity_reps(lig_vol)
            return rep_rec, rep_lig, coupling
        return self.model(rec_vol, lig_vol)

    def rotation_set(self, native_rotation: Optional[torch.Tensor] = None):
        cfg = self.config
        if cfg.local_cone_deg is not None:
            base = (torch.eye(3, device=self.device)
                    if native_rotation is None
                    else torch.as_tensor(native_rotation,
                                         dtype=torch.float32,
                                         device=self.device))
            return local_rotations(base, np.deg2rad(cfg.local_cone_deg),
                                   cfg.num_rotations)
        return super_fibonacci_rotations(cfg.num_rotations, self.device)

    def _ligand_rep_fn(self):
        """Batched density -> representation closure for the sweep."""
        if self.params is None:
            return lambda vols: shape_complementarity_reps(vols)[0]
        return self.model.represent

    def _spectral_parts(self, coupling):
        """(receptor-side coupling matrix, ligand rep_fn), with the
        optional rank-r SVD truncation: the receptor side absorbs
        ``U_r diag(s_r)``, the ligand side projects through ``V_r``."""
        key = ("spectral", id(self.params), self.config.coupling_rank)
        if key not in self._closure_memo:
            self._closure_memo[key] = self._spectral_parts_uncached(
                coupling)
        return self._closure_memo[key]

    def _spectral_parts_uncached(self, coupling):
        rep_fn = self._ligand_rep_fn()
        r = self.config.coupling_rank
        if r is None or coupling is None or r >= min(coupling.shape):
            return coupling, rep_fn
        coupling_np = _host(coupling)
        if self.params is not None:
            kept, dev = coupling_deviation_capture(
                coupling_np, r, shape_prior=self.config.shape_prior)
            if dev > 1e-6 and kept < 0.95:
                lic = min_licensed_rank(
                    coupling_np, shape_prior=self.config.shape_prior)
                warnings.warn(
                    f"coupling_rank={r} keeps only {kept:.0%} of this "
                    f"model's learned coupling deviation (licensing "
                    f"criterion >=95%). Use coupling_rank>={lic} or "
                    f"None.", stacklevel=3)
        # The numpy float32 SVD, as the JAX package takes it, so both
        # packages project onto the same rank-r bases.
        U, s, Vt = np.linalg.svd(np.asarray(coupling_np, np.float32))
        proj_rec = torch.as_tensor(U[:, :r] * s[None, :r],
                                   device=self.device)       # [C, r]
        proj_lig = torch.as_tensor(np.ascontiguousarray(Vt[:r].T),
                                   device=self.device)       # [C, r]
        folded = self._folded_rep_fn(proj_lig)
        if folded is not None:
            return proj_rec, folded

        def rep_fn_r(vols):
            reps = rep_fn(vols)
            return torch.einsum("...c,cr->...r", reps,
                                proj_lig.to(reps.dtype))
        return proj_rec, rep_fn_r

    def _folded_rep_fn(self, proj_lig: torch.Tensor):
        """rep_fn computing ``represent(vols) @ proj_lig`` with the
        projection folded into the last (linear) conv layer; None in
        shape mode."""
        if self.params is None:
            return None
        cfg = self.config
        rep = self.model.representation
        cnn = rep.cnn if cfg.shape_prior else rep
        kernels = [c.weight for c in cnn.convs]
        biases = [c.bias for c in cnn.convs]
        if cfg.shape_prior:
            proj_prior, proj_learned = proj_lig[:2], proj_lig[2:]
        else:
            proj_prior, proj_learned = None, proj_lig
        w_last = torch.einsum("oixyz,or->rixyz", kernels[-1],
                              proj_learned)
        b_last = None if biases[-1] is None else biases[-1] @ proj_learned
        dt = _DTYPES[cfg.compute_dtype]

        def conv(x, w, b):
            return conv3d_channels_last(
                x, w.to(dt), None if b is None else b.to(dt))

        def rep_fn(vols):
            lead = vols.shape[:-4]
            x = vols.reshape((-1,) + vols.shape[-4:]).to(dt)
            for w, b in zip(kernels[:-1], biases[:-1]):
                x = F.elu(conv(x, w, b))
            y = conv(x, w_last, b_last).to(torch.float32)    # [..., r]
            y = y.reshape(lead + y.shape[1:])
            if proj_prior is not None:
                prior = shape_channels(vols)[0]
                y = y + torch.einsum("...c,cr->...r", prior, proj_prior)
            return y
        return rep_fn

    def _engine_parts(self, rep_rec, coupling):
        """``(impl, H, rep_fn)``: the resolved engine, the receptor-side
        tensor it consumes, and the ligand density -> rep closure; built
        (and memoized) under ``no_grad``, never ``inference_mode``."""
        cfg = self.config
        impl = resolve_engine(cfg.fft_impl, cfg.grid_size)
        with torch.no_grad():
            cpl_eff, rep_fn = self._spectral_parts(coupling)
            return impl, coupled_receptor(rep_rec, cpl_eff, impl), rep_fn

    def _batched_receptor_engine(self, coords: torch.Tensor,
                                 types: torch.Tensor, mask: torch.Tensor):
        """``(impl, H_batch, rep_fn)``: the receptor halves of a group of
        complexes at once -- one splat of the padded receptors ``coords
        [B, A, 3]``, ``types [B, A]``, ``mask [B, A]`` (atom-chunked above
        4,096 atoms), one CNN call, the coupled spectra ``H_batch [B, L,
        L, L//2+1, C']``; no per-complex ``voxelize``."""
        cfg = self.config
        impl = resolve_engine(cfg.fft_impl, cfg.grid_size)
        if self.params is None:
            coupling = shape_complementarity_reps(
                torch.zeros((4, 4, 4, 1), device=self.device))[1]
        else:
            coupling = self.model.coupling
        with torch.no_grad():
            cpl_eff, rep_fn = self._spectral_parts(coupling)
            vols = separable_splat(
                coords, types, mask, grid_size=cfg.grid_size,
                resolution=cfg.resolution, sigma=cfg.sigma,
                num_types=cfg.num_atom_types,
                atom_chunk=4096 if coords.shape[1] > 4096 else None)
            reps = self._ligand_rep_fn()(vols)     # unprojected, batched
            del vols
            H = coupled_receptor(reps, cpl_eff, impl)
        return impl, H, rep_fn

    def _receptive_field(self) -> int:
        if self.params is None:
            return 3                      # shape mode: 2-voxel dilation + 1
        cfg = self.config
        rf = len(cfg.rep_features) * (cfg.rep_kernel // 2) + 1
        return max(rf, 3) if cfg.shape_prior else rf

    def _prepare(self, rec: Structure, lig: Structure):
        """Voxelize + represent both structures once."""
        rec_c = rec.centered()
        lig_c = lig.centered()
        if len(lig_c.typed()) == 0:
            raise ValueError(
                "no typed atoms in ligand: every atom fell outside the "
                "11-type table (all-HETATM/unknown-residue input?).")
        if len(rec_c.typed()) == 0:
            raise ValueError(
                "no typed atoms in receptor: every atom fell outside "
                "the 11-type table.")
        with torch.no_grad():
            rep_rec, rep_lig, coupling = self.representations(
                self.voxelize(rec_c), self.voxelize(lig_c))
        return rec_c, lig_c, rep_rec, rep_lig, coupling

    def _receptor_half(self, rec: Structure):
        """Centered receptor, its representation and the coupling, with
        no ligand: the half the serving cache amortizes over queries."""
        rec_c = rec.centered()
        if len(rec_c.typed()) == 0:
            raise ValueError(
                "no typed atoms in receptor: every atom fell outside "
                "the 11-type table.")
        with torch.no_grad():
            rec_vol = self.voxelize(rec_c)
            if self.params is None:
                rep_rec, coupling = shape_complementarity_reps(rec_vol)
            else:
                rep_rec = self.model.represent(rec_vol)
                coupling = self.model.coupling
        return rec_c, rep_rec, coupling

    def _stage_inputs(self, rec, lig, prep, engine):
        """``(lig_c, engine, (lc, lt, lm), lig_grid)`` for a sweep or
        refinement stage, reusing ``prep``/``engine`` when given."""
        cfg = self.config
        if prep is None:
            prep = self._prepare(rec, lig)
        rec_c, lig_c, rep_rec, rep_lig, coupling = prep
        if engine is None:
            engine = self._engine_parts(rep_rec, coupling)
        lig_dev = structure_to_device(
            lig_c, bucket=cfg.atom_bucket or None, device=self.device)
        lig_grid = cfg.lig_grid_size or auto_ligand_grid(
            lig_c.typed().coords, cfg.resolution, cfg.sigma,
            self._receptive_field(), cfg.grid_size)
        return lig_c, engine, lig_dev, lig_grid

    # ---- the full stack ----
    def dock(self, rec: Structure, lig: Structure,
             rotations: Optional[torch.Tensor] = None,
             cluster: bool = True,
             translation_center: Optional[np.ndarray] = None,
             max_shift: Optional[float] = None,
             prep=None, engine=None) -> PoseSet:
        """Dock centered structures; returns ranked (clustered) poses.

        ``engine`` is an optional precomputed ``_engine_parts`` tuple —
        the receptor half of the correlator, reusable across ligand
        queries against one receptor.
        """
        cfg = self.config
        if cfg.sweep_mode != "resplat":
            raise NotImplementedError(
                f"sweep_mode={cfg.sweep_mode!r} is not ported yet")
        lig_c, engine, (lc, lt, lm), lig_grid = self._stage_inputs(
            rec, lig, prep, engine)
        impl, H, rep_fn = engine
        if rotations is None:
            rotations = self.rotation_set()
        rotations = torch.as_tensor(rotations, dtype=torch.float32,
                                    device=self.device)
        score_mask = dock_score_mask(cfg, lig_c, translation_center,
                                     max_shift, device=self.device)
        res = dock_sweep_resplat(
            H, lc, lt, lm, rotations, rep_fn, grid_size=cfg.grid_size,
            lig_grid=lig_grid, resolution=cfg.resolution,
            sigma=cfg.sigma, num_types=cfg.num_atom_types,
            top_k=cfg.top_k, chunk=cfg.rotation_chunk,
            score_mask=score_mask, fft_impl=impl,
            dft_dtype=cfg.dft_dtype, topk_impl=cfg.topk_impl)
        scores = _host(res.scores)
        rot_idx = _host(res.rot_idx)
        shifts = _host(res.shifts)
        Rs = _host(rotations)[rot_idx]
        poses = PoseSet(scores=scores, rotations=Rs,
                        translations=shifts.astype(np.float32)
                        * cfg.resolution,
                        rot_idx=rot_idx, shifts=shifts)
        if cluster:
            poses = cluster_pose_set(lig_c.coords, poses, cfg.nms_rmsd)
        return poses

    def dock_complex(self, cplx: Complex, **kw) -> PoseSet:
        return self.dock(cplx.receptor, cplx.ligand, **kw)

    # ---- NMR-ensemble docking ----
    def dock_ensemble(self, rec_models: list, lig_models: list,
                      pairing: str = "product", cluster: bool = True,
                      **kw):
        """Dock model pairs of NMR ensembles and merge one ranked set.

        ``pairing`` is ``"product"`` (every receptor model x every ligand
        model) or ``"zip"`` (model i with model i).  Keyword arguments:
        ``rotations``, ``translation_center``, ``max_shift`` (as
        ``dock``) and ``pair_batch`` (default ``ensemble_pair_batch``).

        Returns ``(poses, pairs)``: the merged score-ranked ``PoseSet``
        and an int ``[K, 2]`` array of 0-based (receptor_model,
        ligand_model) per pose.  Cross-model NMS uses the first ligand
        model's coordinates (ensembles share one frame).

        Each receptor model's half (splat, CNN, coupled spectrum) is built
        once and each ligand model padded once (R + L preparations, not
        R x L); pairs then sweep ``pair_batch`` at a time as one
        complex-batched sweep (``batch_eval.dock_batch``), whose rotation
        chunk shrinks to ``rotation_chunk // pairs`` so a step holds as
        many rows as one dock's.
        """
        if pairing == "product":
            pair_list = list(itertools.product(range(len(rec_models)),
                                               range(len(lig_models))))
        elif pairing == "zip":
            if len(rec_models) != len(lig_models):
                raise ValueError(
                    f"pairing='zip' needs equal model counts, got "
                    f"{len(rec_models)} receptor vs {len(lig_models)} "
                    f"ligand models")
            pair_list = [(i, i) for i in range(len(rec_models))]
        else:
            raise ValueError(f"unknown pairing {pairing!r} "
                             "(want 'product' or 'zip')")
        if not pair_list:
            raise ValueError("empty model ensemble")
        cfg = self.config
        rotations = kw.pop("rotations", None)
        translation_center = kw.pop("translation_center", None)
        max_shift = kw.pop("max_shift", None)
        pair_batch = kw.pop("pair_batch", None)
        if kw:
            raise TypeError(f"dock_ensemble: unexpected kwargs {list(kw)}")
        if cfg.sweep_mode != "resplat":
            raise NotImplementedError(
                f"sweep_mode={cfg.sweep_mode!r} is not ported yet")
        if rotations is None:
            rotations = self.rotation_set()
        rotations = torch.as_tensor(rotations, dtype=torch.float32,
                                    device=self.device)

        # R receptor halves, once each.
        engines = [self._engine_parts(rep, cpl) for _, rep, cpl in
                   (self._receptor_half(r) for r in rec_models)]
        impl, H0, rep_fn = engines[0]
        if pair_batch is None:
            pair_batch = ensemble_pair_batch(H0)
        # L ligand halves: centered, padded to a common atom count, with
        # their translation masks, once each.
        lig_cs = []
        for lig in lig_models:
            lig_c = lig.centered()
            if len(lig_c.typed()) == 0:
                raise ValueError(
                    "no typed atoms in ligand: every atom fell outside "
                    "the 11-type table.")
            lig_cs.append(lig_c)
        max_atoms = max(len(lig_c.typed()) for lig_c in lig_cs)
        if cfg.atom_bucket:
            b = cfg.atom_bucket
            max_atoms = max(b, ((max_atoms + b - 1) // b) * b)
        lig_dev = [structure_to_device(lig_c, max_atoms, device=self.device)
                   for lig_c in lig_cs]
        lig_grid = cfg.lig_grid_size or max(
            auto_ligand_grid(lig_c.typed().coords, cfg.resolution,
                             cfg.sigma, self._receptive_field(),
                             cfg.grid_size)
            for lig_c in lig_cs)
        masks = stack_score_masks(
            [dock_score_mask(cfg, lig_c, translation_center, max_shift,
                             device=self.device) for lig_c in lig_cs],
            cfg.grid_size, self.device)

        scores, rot_idx, shifts, tags = [], [], [], []
        for start in range(0, len(pair_list), pair_batch):
            batch = pair_list[start:start + pair_batch]
            lig = [lig_dev[li] for _, li in batch]
            res = batch_eval.dock_batch(
                torch.stack([engines[ri][1] for ri, _ in batch]),
                *(torch.stack([d[i] for d in lig]) for i in range(3)),
                rotations, rep_fn, grid_size=cfg.grid_size,
                lig_grid=lig_grid, resolution=cfg.resolution,
                sigma=cfg.sigma, num_types=cfg.num_atom_types,
                top_k=cfg.top_k,
                chunk=max(1, cfg.rotation_chunk // len(batch)),
                score_mask=(None if masks is None
                            else masks[[li for _, li in batch]]),
                fft_impl=impl, dft_dtype=cfg.dft_dtype)
            scores.append(_host(res.scores).reshape(-1))
            rot_idx.append(_host(res.rot_idx).reshape(-1))
            shifts.append(_host(res.shifts).reshape(-1, 3))
            for pair in batch:
                tags.extend([pair] * res.scores.shape[1])
        scores = np.concatenate(scores)
        rot_idx = np.concatenate(rot_idx)
        shifts = np.concatenate(shifts)
        order = np.argsort(-scores, kind="stable")
        merged = PoseSet(
            scores=scores[order],
            rotations=_host(rotations)[rot_idx[order]],
            translations=shifts[order].astype(np.float32) * cfg.resolution,
            rot_idx=rot_idx[order], shifts=shifts[order])
        pairs = np.asarray(tags, dtype=np.int64)[order]
        return self._merge_ensemble(merged, pairs, lig_models, cluster)

    def _merge_ensemble(self, merged: PoseSet, pairs: np.ndarray,
                        lig_models: list, cluster: bool):
        """NMS of the merged set (at most ``top_k`` survivors), by pose
        RMSD of the first ligand model; ``pairs`` follow the poses."""
        if cluster and len(merged) > 1:
            D = pose_pairwise_rmsd(
                torch.as_tensor(lig_models[0].centered().coords),
                torch.as_tensor(merged.rotations),
                torch.as_tensor(merged.translations))
            keep = nms_cluster(merged.scores, D.numpy(),
                               self.config.nms_rmsd,
                               max_out=self.config.top_k)
            merged = PoseSet(*(np.asarray(f)[keep] for f in merged[:5]))
            pairs = pairs[keep]
        return merged, pairs

    # ---- hierarchical focused rescoring ----
    def rescore(self, rec: Structure, lig: Structure, poses: PoseSet,
                top: int = 16, nrot: int = 48,
                cone_deg: float = 15.0, shift_vox: int = 3,
                aggregate: str = "max", agg_top: int = 8,
                prep=None, engine=None) -> PoseSet:
        """Re-rank the top ``top`` heads by a dense local sweep each.

        Each head sweeps ``nrot`` rotations in a ``cone_deg`` cone around
        its rotation (the head itself first, so its rescored score is >=
        its coarse score) with translations confined to ``+-shift_vox``
        voxels of its shift and the wrap-around guard, and heads re-rank
        by their basin maxima (``aggregate="max"``) or by the mean of
        their best ``agg_top`` scores (``"topmean"``).  All heads run as
        one head-batched sweep.  Poses beyond ``top`` follow unrescored;
        under ``"topmean"`` the whole set is re-sorted on
        ``rank_scores``.
        """
        cfg = self.config
        n = min(top, len(poses))
        if n == 0:
            return poses
        lig_c, engine, (lc, lt, lm), lig_grid = self._stage_inputs(
            rec, lig, prep, engine)
        impl, H, rep_fn = engine
        dev = self.device
        head_rots = []
        for i in range(n):
            base = torch.tensor(poses.rotations[i], dtype=torch.float32,
                                device=dev)
            cone = local_rotations(base, np.deg2rad(cone_deg), nrot)
            head_rots.append(torch.cat([base[None], cone[:-1]]))
        head_rots = torch.stack(head_rots)              # [n, nrot, 3, 3]
        guard = dock_score_mask(cfg, lig_c, device=dev)
        masks = []
        for i in range(n):
            m = translation_mask(cfg.grid_size, int(shift_vox),
                                 torch.tensor(poses.shifts[i]),
                                 device=dev)
            masks.append(m if guard is None else m & guard)
        head_masks = torch.stack(masks)                 # [n, L, L, L]
        K = max(agg_top if aggregate == "topmean" else 1, 1)
        # The head axis multiplies every per-step activation by n, so the
        # per-head rotation chunk shrinks by the same factor.
        chunk = max(1, min(cfg.rotation_chunk, nrot) // max(n, 1))
        res = dock_sweep_resplat(
            H, lc, lt, lm, head_rots, rep_fn, grid_size=cfg.grid_size,
            lig_grid=lig_grid, resolution=cfg.resolution, sigma=cfg.sigma,
            num_types=cfg.num_atom_types, top_k=K, chunk=chunk,
            score_mask=head_masks, fft_impl=impl, dft_dtype=cfg.dft_dtype,
            topk_impl=cfg.topk_impl)
        scores = _host(res.scores)                      # [n, K]
        rot_idx = _host(res.rot_idx)
        shifts = _host(res.shifts)                      # [n, K, 3]
        best = scores[:, 0]
        rank = (scores[:, :agg_top].mean(axis=1)
                if aggregate == "topmean" else best)
        Rs = _host(head_rots)[np.arange(n), rot_idx[:, 0]]
        ts = shifts[:, 0].astype(np.float32) * cfg.resolution
        order = np.argsort(-rank)
        # Under "max" every rescored head is >= its coarse score, which
        # was >= every tail score, so heads-then-tail stays sorted; a
        # "topmean" head can fall below a tail pose, so that set is
        # re-sorted jointly.
        tail = slice(n, len(poses))
        out = PoseSet(
            scores=np.concatenate([best[order],
                                   poses.scores[tail]]).astype(np.float32),
            rotations=np.concatenate([Rs[order], poses.rotations[tail]]),
            translations=np.concatenate([ts[order],
                                         poses.translations[tail]]),
            rot_idx=np.concatenate([np.full(n, -1, np.int32),
                                    poses.rot_idx[tail]]),
            shifts=np.concatenate([shifts[order, 0], poses.shifts[tail]]),
            rank_scores=np.concatenate([rank[order],
                                        poses.scores[tail]]).astype(
                                            np.float32),
        )
        if aggregate == "topmean" and len(poses) > n:
            joint = np.argsort(-out.rank_scores, kind="stable")
            out = PoseSet(*(np.asarray(f)[joint] for f in out[:5]),
                          rank_scores=out.rank_scores[joint])
        return out

    # ---- continuous refinement (sweep/refine.py) ----
    def refine(self, rec: Structure, lig: Structure, poses: PoseSet,
               steps: int = 30, lr: float = 0.02,
               prep=None, engine=None) -> PoseSet:
        """Polish poses by gradient ascent in continuous pose space.

        Returns a re-ranked PoseSet with continuous translations
        (``shifts`` hold the nearest lattice point).  Shares the engine
        dispatch with ``dock``/``rescore``: ``H`` is the engine's coupled
        spectrum, made complex.
        """
        cfg = self.config
        lig_c, engine, (lc, lt, lm), lig_grid = self._stage_inputs(
            rec, lig, prep, engine)
        impl, H, rep_fn = engine
        if impl != "block" and not H.is_complex():
            H = H.to(torch.complex64)
        out = refine_poses(
            H, lc, lt, lm,
            torch.tensor(poses.rotations, dtype=torch.float32,
                         device=self.device),
            torch.tensor(poses.shifts, device=self.device), rep_fn,
            grid_size=cfg.grid_size, lig_grid=lig_grid,
            resolution=cfg.resolution, sigma=cfg.sigma,
            num_types=cfg.num_atom_types, steps=steps, lr=lr,
            fft_impl=impl)
        scores = _host(out.scores)
        order = np.argsort(-scores)
        translations = _host(out.translations)[order]
        return PoseSet(
            scores=scores[order],
            rotations=_host(out.rotations)[order],
            translations=translations,
            rot_idx=poses.rot_idx[order],
            shifts=np.round(translations / cfg.resolution).astype(np.int32),
        )
