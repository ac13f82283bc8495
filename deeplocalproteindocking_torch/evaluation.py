"""Benchmark evaluation: per-complex docking, CAPRI grading, resume.

Port of the sequential half of ``deeplocalproteindocking_tpu/
evaluation.py``: dock each complex of a benchmark split, grade every pose
against the native complex with CAPRI-style metrics, and aggregate top-1
and top-10 hit rates.  Evaluation is checkpointed per complex: a complex
either has a completed ``<name>.json`` result file or is recomputed, so
an interrupted run resumes where it stopped.

Grading runs on the pipeline's device.  The native contact table and the
interface masks are built once per complex; poses go through in batches
whose atom-pair intermediate stays under a fixed budget, so peak memory
does not grow with the number of poses.  ``run_benchmark_batched`` is the
throughput mode: groups of complexes padded to a shape bucket, their
receptor halves built at once and their sweeps run as one
complex-batched sweep (``parallel/batch_eval.py``), each complex graded
and written as in ``run_benchmark``.

Under a mesh (``pipeline.mesh``) every rank runs the same call: the
sweeps are sharded, each rank of ``run_benchmark_batched`` builds the
receptor halves of its own complexes, and rank 0 alone grades the
gathered poses and writes the files; every rank waits at a barrier
before it checks which complexes are done, and returns the summary.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from deeplocalproteindocking_torch.data.benchmark import (
    Complex, structure_to_device)
from deeplocalproteindocking_torch.parallel import batch_eval
from deeplocalproteindocking_torch.parallel.mesh import barrier, is_main_rank
from deeplocalproteindocking_torch.pipeline import (
    DockingPipeline, PoseSet, dock_score_mask, stack_score_masks)
from deeplocalproteindocking_torch.sweep.cluster import cluster_pose_set
from deeplocalproteindocking_torch.sweep.resplat import auto_ligand_grid
from deeplocalproteindocking_torch.structure.transforms import apply_pose
from deeplocalproteindocking_torch.train.data_gen import native_voxel_shift
from deeplocalproteindocking_torch.utils.logging import MetricsLogger
from deeplocalproteindocking_torch.utils.quality import (
    CAPRI_CLASSES, capri_class, interface_masks_chunked, ligand_rmsd,
    residue_contact_table)
from deeplocalproteindocking_torch.utils.rmsd import kabsch_rmsd

# Atom pairs held at once by one batch of poses' contact tables.
PAIR_BUDGET = 1 << 24


def _grade_batch(rec, native, posed, rec_res, lig_res, num_rec_res,
                 num_lig_res, atom_chunk):
    """``(lrmsd, irmsd, fnat)``, each ``[K]``, of poses ``posed [K, N_lig,
    3]`` against the native ligand, in batches of poses."""
    kw = dict(num_rec_res=num_rec_res, num_lig_res=num_lig_res,
              atom_chunk=atom_chunk)
    nat_tab = residue_contact_table(rec, native, rec_res, lig_res, **kw)
    n_nat = torch.clamp(nat_tab.sum(), min=1)
    rec_if, lig_if = interface_masks_chunked(rec, native,
                                             atom_chunk=atom_chunk)
    if_mask = torch.cat([rec_if, lig_if]).to(rec.dtype)
    nat_all = torch.cat([rec, native], dim=0)
    batch = max(1, PAIR_BUDGET // (min(atom_chunk, len(rec))
                                   * native.shape[0]))
    out = []
    for p in posed.split(batch):
        b = p.shape[0]
        model = torch.cat([rec.expand(b, -1, -1), p], dim=1)
        mod_tab = residue_contact_table(rec, p, rec_res, lig_res, **kw)
        out.append(torch.stack([
            ligand_rmsd(p, native),
            kabsch_rmsd(model, nat_all.expand(b, -1, -1), if_mask),
            (nat_tab & mod_tab).sum((-2, -1)) / n_nat]))
    return torch.cat(out, dim=1)


def grade_poses(cplx: Complex, poses: PoseSet,
                device: torch.device | str = "cuda") -> List[Dict]:
    """CAPRI-style quality of every pose against the native complex."""
    if len(poses) == 0:
        return []
    dev = torch.device(device)
    rec = cplx.receptor.centered()
    # The native ligand in the centered-receptor frame.
    native = torch.as_tensor(cplx.ligand.coords - cplx.receptor.center,
                             device=dev)
    rec_t = torch.as_tensor(rec.coords, device=dev)
    rec_res = _dense_res_ids(cplx.receptor)
    lig_res = _dense_res_ids(cplx.ligand)
    posed = apply_pose(
        torch.as_tensor(cplx.ligand.centered().coords, device=dev)[None],
        torch.as_tensor(poses.rotations, dtype=torch.float32, device=dev),
        torch.as_tensor(poses.translations, dtype=torch.float32,
                        device=dev))
    n_rec_atoms = rec.coords.shape[0]
    with torch.no_grad():
        l, ir, fn = _grade_batch(
            rec_t, native, posed, torch.as_tensor(rec_res, device=dev),
            torch.as_tensor(lig_res, device=dev),
            num_rec_res=int(rec_res.max()) + 1,
            num_lig_res=int(lig_res.max()) + 1,
            atom_chunk=min(1024, ((n_rec_atoms + 127) // 128) * 128)
        ).cpu().numpy()
    out = []
    for i in range(len(poses)):
        cls = capri_class(fn[i], l[i], ir[i])
        out.append(dict(rank=i, score=float(poses.scores[i]),
                        lrmsd=float(l[i]), irmsd=float(ir[i]),
                        fnat=float(fn[i]), capri=CAPRI_CLASSES[cls]))
    return out


def _dense_res_ids(s) -> np.ndarray:
    """Per-atom residue ids compressed to dense [0, n_res)."""
    icodes = (s.icodes if s.icodes is not None
              else np.full(len(s.res_ids), "", dtype="<U1"))
    _, dense = np.unique(
        np.stack([s.chain_ids, s.res_ids.astype(str), icodes], axis=1),
        axis=0, return_inverse=True)
    return dense.reshape(-1).astype(np.int32)


def hit_summary(name: str, graded: List[Dict]) -> Dict:
    """One complex's result: its graded poses, top-1 and top-10 hits
    (any class above "incorrect") and the best LRMSD."""
    return {
        "name": name,
        "num_poses": len(graded),
        "poses": graded,
        "hit_top1": bool(graded and graded[0]["capri"] != "incorrect"),
        "hit_top10": any(g["capri"] != "incorrect" for g in graded[:10]),
        "best_lrmsd": min((g["lrmsd"] for g in graded), default=None),
    }


def local_dock_kwargs(pipeline: DockingPipeline, cplx: Complex) -> Dict:
    """``dock`` arguments of the local docking protocol: the rotation
    cone around the native orientation and translations within
    ``decoy_max_shift`` of the native placement; none when the config
    sets no cone."""
    cfg = pipeline.config
    if cfg.local_cone_deg is None:
        return {}
    return dict(rotations=pipeline.rotation_set(None),
                translation_center=native_voxel_shift(cplx, cfg.resolution),
                max_shift=cfg.decoy_max_shift)


def evaluate_complex(pipeline: DockingPipeline, cplx: Complex,
                     refine_steps: int = 0,
                     rescore_top: int = 0) -> Dict:
    """Dock + grade one complex.

    When ``config.local_cone_deg`` is set this runs the *local docking*
    protocol: rotations restricted to a cone around the native
    orientation and translations to ``decoy_max_shift`` Angstrom around
    the native placement (the bound pose defines "native"; the benchmark
    measures whether scoring re-finds it).
    """
    poses = pipeline.dock_complex(cplx, **local_dock_kwargs(pipeline, cplx))
    if rescore_top:
        poses = pipeline.rescore(cplx.receptor, cplx.ligand, poses,
                                 top=rescore_top)
    if refine_steps:
        poses = pipeline.refine(cplx.receptor, cplx.ligand, poses,
                                steps=refine_steps)
    return hit_summary(cplx.name,
                       grade_poses(cplx, poses, device=pipeline.device))


def _write_result(out_dir: str, res: Dict) -> None:
    """``<name>.json``, written whole or not at all (the resume marker)."""
    path = os.path.join(out_dir, f"{res['name']}.json")
    with open(path + ".tmp", "w") as f:
        json.dump(res, f)
    os.replace(path + ".tmp", path)


def _rank_logger(out_dir: str, logger: Optional[MetricsLogger]
                 ) -> MetricsLogger:
    """``logger``, or ``metrics.jsonl`` in ``out_dir`` on rank 0 and a
    silent logger on the other ranks of a mesh."""
    if logger is not None:
        return logger
    if is_main_rank():
        return MetricsLogger(os.path.join(out_dir, "metrics.jsonl"))
    return MetricsLogger(None, echo=False)


def _summarize(out_dir: str, results: List[Dict],
               logger: MetricsLogger) -> Dict:
    n = max(len(results), 1)
    summary = {
        "num_complexes": len(results),
        "top1_hit_rate": sum(r["hit_top1"] for r in results) / n,
        "top10_hit_rate": sum(r["hit_top10"] for r in results) / n,
    }
    if is_main_rank():
        with open(os.path.join(out_dir, "summary.json"), "w") as f:
            json.dump(summary, f, indent=2)
    logger.log("benchmark_summary", **summary)
    return summary


def run_benchmark(pipeline: DockingPipeline,
                  complexes: Sequence[Complex],
                  out_dir: str,
                  logger: Optional[MetricsLogger] = None,
                  refine_steps: int = 0,
                  rescore_top: int = 0) -> Dict:
    """Evaluate many complexes with per-complex resume; aggregate hits.
    Under a mesh every rank docks (the sweep is sharded) and grades;
    rank 0 writes."""
    os.makedirs(out_dir, exist_ok=True)
    logger = _rank_logger(out_dir, logger)
    barrier()
    done = [os.path.exists(os.path.join(out_dir, f"{c.name}.json"))
            for c in complexes]
    results = []
    for cplx, cached in zip(complexes, done):
        path = os.path.join(out_dir, f"{cplx.name}.json")
        if cached:                         # idempotent resume
            with open(path) as f:
                res = json.load(f)
            logger.log("complex_cached", name=cplx.name)
        else:
            res = evaluate_complex(pipeline, cplx,
                                   refine_steps=refine_steps,
                                   rescore_top=rescore_top)
            if is_main_rank():
                _write_result(out_dir, res)
            logger.log("complex_done", name=cplx.name,
                       hit_top10=res["hit_top10"],
                       best_lrmsd=res["best_lrmsd"])
        results.append(res)
    return _summarize(out_dir, results, logger)


def batch_inputs(pipeline: DockingPipeline, group: Sequence[Complex],
                 rotations: torch.Tensor, members: slice = slice(None)):
    """``(args, kwargs)`` of ``batch_eval.dock_batch`` for a group of
    complexes, as ``run_benchmark_batched`` docks it; with ``members``
    only those complexes' tensors are built (a rank's share under a
    mesh: ``dock_batch_shard``'s arguments), the shapes still the
    whole group's.

    The group is padded to a shape bucket: atoms to a multiple of
    ``atom_bucket`` (or 64), the ligand box to the group's largest
    ``auto_ligand_grid`` rounded up to 16 and capped at the grid, so
    size-diverse groups share shapes; padding is masked, so scores do
    not change.  The receptor halves run through
    ``_batched_receptor_engine``; each complex keeps its wrap-around
    guard and, under ``local_cone_deg``, the local protocol's mask.  The
    rotation chunk shrinks to ``rotation_chunk // len(members)`` so a
    step holds as many rows as one dock's.
    """
    cfg = pipeline.config
    dev = pipeline.device
    ab = cfg.atom_bucket or 64
    max_atoms = max(max(len(c.receptor.typed()), len(c.ligand.typed()))
                    for c in group)
    max_atoms = max(ab, -(-max_atoms // ab) * ab)
    lig_grid = max(auto_ligand_grid(c.ligand.centered().typed().coords,
                                    cfg.resolution, cfg.sigma,
                                    pipeline._receptive_field(),
                                    cfg.grid_size) for c in group)
    lig_grid = min(cfg.grid_size, -(-lig_grid // 16) * 16)

    def padded(structures):
        dev_t = [structure_to_device(s.centered(), max_atoms, device=dev)
                 for s in structures]
        return tuple(torch.stack([d[i] for d in dev_t]) for i in range(3))

    group = group[members]
    impl, H_batch, rep_fn = pipeline._batched_receptor_engine(
        *padded([c.receptor for c in group]))
    masks = []
    for c in group:
        local = local_dock_kwargs(pipeline, c)
        masks.append(dock_score_mask(
            cfg, c.ligand.centered(), local.get("translation_center"),
            local.get("max_shift"), device=dev))
    score_mask = stack_score_masks(masks, cfg.grid_size, dev)
    args = (H_batch,) + padded([c.ligand for c in group]) + (rotations,
                                                              rep_fn)
    return args, dict(
        grid_size=cfg.grid_size, lig_grid=lig_grid,
        resolution=cfg.resolution, sigma=cfg.sigma,
        num_types=cfg.num_atom_types, top_k=cfg.top_k,
        chunk=max(1, cfg.rotation_chunk // len(group)),
        score_mask=score_mask, fft_impl=impl, dft_dtype=cfg.dft_dtype,
        fft_block=cfg.fft_block)


def run_benchmark_batched(pipeline: DockingPipeline,
                          complexes: Sequence[Complex],
                          out_dir: str,
                          group_size: int = 4,
                          logger: Optional[MetricsLogger] = None,
                          refine_steps: int = 0,
                          rescore_top: int = 0) -> Dict:
    """Throughput-mode benchmark: ``group_size`` complexes at a time
    docked as one complex-batched sweep (``batch_eval.dock_batch`` on
    :func:`batch_inputs`).  Then per complex, as ``run_benchmark``: NMS,
    optional ``rescore_top`` and ``refine_steps``, grading, an atomic
    ``<name>.json``; complexes that have a file are not recomputed.
    Under a mesh a group splits over ``batch`` (its size must divide by
    it; the chunk shrinks by the complexes per rank) and its rotations
    over ``rot``; rank 0 grades and writes.
    """
    cfg = pipeline.config
    dev = pipeline.device
    mesh = pipeline.mesh
    os.makedirs(out_dir, exist_ok=True)
    logger = _rank_logger(out_dir, logger)
    barrier()
    pending = [c for c in complexes
               if not os.path.exists(os.path.join(out_dir, f"{c.name}.json"))]
    rotations = torch.as_tensor(pipeline.rotation_set(), dtype=torch.float32,
                                device=dev)
    rot_np = rotations.cpu().numpy()
    for g0 in range(0, len(pending), group_size):
        group = pending[g0:g0 + group_size]
        if mesh is None:
            args, kw = batch_inputs(pipeline, group, rotations)
            res = batch_eval.dock_batch(*args, **kw)
        else:
            args, kw = batch_inputs(pipeline, group, rotations,
                                    batch_eval.batch_slice(mesh, len(group)))
            res = batch_eval.dock_batch_shard(mesh, *args, **kw)
        del args
        if not is_main_rank():
            continue
        scores, rot_idx = res.scores.cpu().numpy(), res.rot_idx.cpu().numpy()
        shifts = res.shifts.cpu().numpy()
        for i, c in enumerate(group):
            poses = PoseSet(
                scores=scores[i], rotations=rot_np[rot_idx[i]],
                translations=shifts[i].astype(np.float32) * cfg.resolution,
                rot_idx=rot_idx[i], shifts=shifts[i])
            poses = cluster_pose_set(c.ligand.centered().coords, poses,
                                     cfg.nms_rmsd)
            if rescore_top:
                poses = pipeline.rescore(c.receptor, c.ligand, poses,
                                         top=rescore_top)
            if refine_steps:
                poses = pipeline.refine(c.receptor, c.ligand, poses,
                                        steps=refine_steps)
            out = hit_summary(c.name, grade_poses(c, poses, device=dev))
            _write_result(out_dir, out)
            logger.log("complex_done", name=c.name,
                       hit_top10=out["hit_top10"])

    barrier()
    results = []
    for c in complexes:
        with open(os.path.join(out_dir, f"{c.name}.json")) as f:
            results.append(json.load(f))
    return _summarize(out_dir, results, logger)
