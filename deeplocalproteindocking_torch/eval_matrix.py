"""Held-out results matrix: learned vs shape, global + local protocols.

The port's eval-matrix script, a port of ``tools/eval_matrix.py``:

    python -m deeplocalproteindocking_torch.eval_matrix CKPT OUT_JSON \
        [--device cuda|cpu]

Held-out synthetic complexes (seeds >= 100, disjoint from every training
seed).  Global protocol: full super-Fibonacci SO(3) sweep, unrestricted
translations.  Local protocol: 50-degree cone around the native
orientation, +-8 A translations (the reference's local-docking
evaluation).

``CKPT`` is a checkpoint directory holding ``config.json``; the learned
rows load the weights of its latest ``step_*``, as the JAX script
restores them: the port's ``state.pt`` or the JAX trainer's Orbax
checkpoint, read without JAX (``train/checkpoint.py``).  A directory
without steps falls back on ``CKPT_params.npz`` beside it (the file
``tools/export_torch_weights.py`` writes, e.g.
``pretrained/synthetic-v9p/best`` -> ``pretrained/synthetic-v9p/
best_params.npz``).  The output JSON has the JAX script's layout and
fingerprint keys, so its rows compare key for key with a matrix that
script wrote, and ``tools/pooled_verdict.py`` reads it.

The knobs are the JAX script's environment variables: EM_NROT (global
rotations, default 1536), EM_GRID (default 64), EM_COMPLEXES (default
8), EM_MODES ("global,local"), EM_WIDEN, EM_SEED0, EM_UNBOUND
(deformation RMSD), EM_DTYPE, EM_BACKBONE (polymer fixtures), EM_RANK
(coupling_rank of the learned rows), EM_RESCORE (top-N rescoring in
global mode), EM_RERANK / EM_AGG (the two-stage global row),
EM_ALLOW_TRAIN_OVERLAP.  ``--device`` (default ``cuda``) is where every
tensor lives.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Callable, Dict, Mapping, Optional

import torch

from deeplocalproteindocking_torch.config import DockConfig
from deeplocalproteindocking_torch.data.benchmark import synthetic_band
from deeplocalproteindocking_torch.evaluation import (grade_poses,
                                                      hit_summary,
                                                      local_dock_kwargs)
from deeplocalproteindocking_torch.pipeline import DockingPipeline
from deeplocalproteindocking_torch.train import checkpoint


def heldout_complexes(n, widen=False, seed0=100, unbound=0.0,
                      backbone=False):
    """Held-out report complexes (seeds 100+, disjoint from training
    seeds 200+ and validation seeds 50+).  ``widen`` draws sizes from
    the same 9x5 (receptor 12..20, ligand 6..10 residue) grid as
    training/validation, the harder, size-diverse benchmark.  ``seed0``
    selects an alternative disjoint band."""
    return synthetic_band(seed0, n, widen=widen, unbound=unbound,
                          backbone=backbone)


def eval_row(dock_fn, complexes, label, partial=None, on_progress=None,
             device="cuda"):
    """Grade ``dock_fn(c)`` poses over ``complexes``, resumably.

    ``partial`` is a list of already-graded row dicts (matched by
    complex name) from an interrupted run; ``on_progress(rows)`` is
    called after every complex so the caller can checkpoint, and an
    interrupted row resumes without re-docking its finished complexes.
    Rows come back in ``complexes`` order.
    """
    rows = list(partial or [])
    done = {r["name"] for r in rows}
    for c in complexes:
        if c.name in done:
            continue
        res = hit_summary(c.name, grade_poses(c, dock_fn(c), device=device))
        rows.append({k: res[k] for k in ("name", "hit_top1", "hit_top10",
                                         "best_lrmsd")})
        print(f"  {label} {c.name}: top1={res['hit_top1']} "
              f"top10={res['hit_top10']}", flush=True)
        if on_progress is not None:
            on_progress(rows)
    by_name = {r["name"]: r for r in rows}
    rows = [by_name[c.name] for c in complexes]
    n = len(complexes)
    return dict(top1=sum(r["hit_top1"] for r in rows) / n,
                top10=sum(r["hit_top10"] for r in rows) / n,
                complexes=rows)


def fingerprints_match(row_fp, fingerprint, key):
    """Protocol equality for row ``key``, ignoring knobs the row does
    not depend on: ``agg`` only affects the rerank row (whose key
    already encodes a non-default aggregator), so adding a second
    rerank row to a matrix keeps its agg-independent rows."""
    if not key.startswith("learned_rerank"):
        def strip(fp):
            return {k: v for k, v in fp.items() if k != "agg"}
        return strip(row_fp) == strip(fingerprint)
    return row_fp == fingerprint


def completed_row_reusable(results, key, fingerprint):
    """Whether ``results[key]`` (a finished row) may be reused under
    ``fingerprint``; discards the row from ``results`` when not.

    Re-running with other knobs against the same file must not mix two
    protocols in one matrix.  Rows written without a fingerprint are
    kept with a warning.
    """
    if key not in results:
        return False
    row_fp = (results[key].get("fingerprint")
              if isinstance(results[key], dict) else None)
    if row_fp is None:
        print(f"keeping legacy row {key} (no fingerprint recorded); "
              f"delete it to recompute under the current protocol",
              flush=True)
        return True
    if fingerprints_match(row_fp, fingerprint, key):
        return True
    print(f"discarding completed row {key}: protocol changed "
          f"({row_fp} -> {fingerprint})", flush=True)
    del results[key]
    return False


def check_seed_disjointness(ckpt, seed0, n_cplx, environ=os.environ):
    """Refuse held-out bands that overlap the checkpoint's training or
    validation seeds (``TRAINING.json`` in ``ckpt`` or its parent).

    ``synthetic_complex`` derives the whole structure from
    ``np.random.default_rng(seed)``, so two complexes with the same seed
    share their random stream even at different residue counts: seed
    overlap is structural leakage.  EM_ALLOW_TRAIN_OVERLAP=1 turns the
    refusal into a warning (an explicit in-training diagnostic).
    """
    meta = None
    for d in (ckpt, os.path.dirname(ckpt.rstrip("/"))):
        p = os.path.join(d, "TRAINING.json")
        if d and os.path.exists(p):
            with open(p) as f:
                meta = json.load(f)
            break
    if meta is None:
        return
    held = set(range(seed0, seed0 + n_cplx))
    bands = {
        "train": range(meta.get("train_seed0", 200),
                       meta.get("train_seed0", 200)
                       + int(meta.get("n_train", 0))),
        "val": range(meta.get("val_seed0", 50),
                     meta.get("val_seed0", 50)
                     + int(meta.get("n_val", 0))),
    }
    for name, band in bands.items():
        hit = sorted(held & set(band))
        if not hit:
            continue
        msg = (f"held-out band {seed0}..{seed0 + n_cplx - 1} overlaps "
               f"the checkpoint's {name} seeds "
               f"{band.start}..{band.stop - 1} (e.g. {hit[:4]}): "
               f"this would evaluate on {name} complexes. Pick a "
               f"disjoint EM_SEED0 or set EM_ALLOW_TRAIN_OVERLAP=1 "
               f"for an explicit in-{name} diagnostic.")
        if environ.get("EM_ALLOW_TRAIN_OVERLAP", "0") == "1":
            print("WARNING (overridden):", msg, flush=True)
        else:
            raise SystemExit("eval_matrix: " + msg)


def mode_dock_fn(pipe, mode, rescore_top=0):
    """``complex -> PoseSet`` of one protocol (``"local"`` or
    ``"global"``) on ``pipe``."""
    def dock_fn(c):
        kw = local_dock_kwargs(pipe, c) if mode == "local" else {}
        poses = pipe.dock_complex(c, **kw)
        if rescore_top and mode == "global":
            poses = pipe.rescore(c.receptor, c.ligand, poses,
                                 top=rescore_top)
        return poses
    return dock_fn


def settings_from_env(environ: Mapping[str, str] = os.environ) -> Dict:
    """The matrix's knobs, read from the JAX script's EM_* variables."""
    return dict(
        n_rot=int(environ.get("EM_NROT", 1536)),
        grid=int(environ.get("EM_GRID", 64)),
        n_cplx=int(environ.get("EM_COMPLEXES", 8)),
        modes=environ.get("EM_MODES", "global,local").split(","),
        widen=environ.get("EM_WIDEN", "0") == "1",
        rescore=int(environ.get("EM_RESCORE", 0)),
        seed0=int(environ.get("EM_SEED0", 100)),
        unbound=float(environ.get("EM_UNBOUND", 0.0)),
        backbone=environ.get("EM_BACKBONE", "0") == "1",
        dtype=environ.get("EM_DTYPE", "bfloat16"),
        rank=int(environ.get("EM_RANK", 0)),
        agg=environ.get("EM_AGG", "max"),
        rerank=environ.get("EM_RERANK", "0") == "1")


def fingerprint_of(settings: Dict) -> Dict:
    """Every knob that changes what a row means, under the JAX script's
    keys: a partial row resumed under another protocol would mix two
    configurations inside one row."""
    keys = ("n_rot", "grid", "n_cplx", "widen", "seed0", "unbound",
            "backbone", "rescore", "dtype", "rank", "agg")
    return {k: settings[k] for k in keys}


def protocol_base(settings: Dict, mode: str) -> Dict:
    """The DockConfig fields one protocol fixes for every row."""
    local = mode == "local"
    return dict(grid_size=settings["grid"], resolution=1.25,
                num_rotations=64 if local else settings["n_rot"],
                local_cone_deg=50.0 if local else None,
                rotation_chunk=64, top_k=64, nms_rmsd=5.0,
                decoy_max_shift=8.0)


def learned_config(ckpt: str, settings: Dict, mode: str) -> DockConfig:
    """The checkpoint's own trained config, with the geometry overridden
    to the eval protocol."""
    with open(os.path.join(ckpt, "config.json")) as f:
        tcfg = DockConfig.from_json(f.read())
    dt = settings["dtype"]
    return tcfg.replace(compute_dtype=dt, dft_dtype=dt, lig_grid_size=None,
                        coupling_rank=settings["rank"] or None,
                        **protocol_base(settings, mode))


def params_path(ckpt: str) -> str:
    """The exported weights of checkpoint ``ckpt``."""
    return ckpt.rstrip("/") + "_params.npz"


def checkpoint_params(ckpt: str) -> dict:
    """The weights of checkpoint ``ckpt``: its latest step, else its
    exported :func:`params_path`."""
    return checkpoint.params_or_npz(ckpt, params_path(ckpt))


def platform_name(device: torch.device) -> str:
    """The card's name, or ``"cpu"``."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def run_matrix(ckpt: str, out_path: str, settings: Dict,
               device: torch.device | str = "cuda",
               environ: Mapping[str, str] = os.environ):
    """Compute (or resume) every row of the matrix into ``out_path``.

    Returns ``(results, seconds)``: the matrix as written and the wall
    seconds of each row computed in this call.
    """
    device = torch.device(device)
    n_cplx, seed0 = settings["n_cplx"], settings["seed0"]
    check_seed_disjointness(ckpt, seed0, n_cplx, environ)
    complexes = heldout_complexes(n_cplx, widen=settings["widen"],
                                  seed0=seed0, unbound=settings["unbound"],
                                  backbone=settings["backbone"])
    fingerprint = fingerprint_of(settings)
    results, seconds = {}, {}
    if os.path.exists(out_path):
        with open(out_path) as f:
            results = json.load(f)
        done = [k for k in results
                if k != "protocol" and not k.startswith("_partial_")]
        if done:
            print(f"resuming: rows {done} already computed", flush=True)

    def checkpoint_row():
        with open(out_path + ".tmp", "w") as f:
            json.dump(results, f, indent=2)
        os.replace(out_path + ".tmp", out_path)

    def run_row(key, dock_fn: Callable):
        """Compute one matrix row with per-complex checkpoint/resume."""
        if completed_row_reusable(results, key, fingerprint):
            return
        pkey = "_partial_" + key
        partial = results.get(pkey)
        if isinstance(partial, list):      # pre-fingerprint format
            partial = dict(fingerprint=None, rows=partial)
        if partial is not None:
            if not (partial.get("fingerprint") is not None
                    and fingerprints_match(partial["fingerprint"],
                                           fingerprint, key)):
                print(f"discarding partial {key}: protocol changed "
                      f"({partial.get('fingerprint')} -> {fingerprint})",
                      flush=True)
                partial = None
            else:
                partial = partial.get("rows")

        def on_progress(rows):
            results[pkey] = dict(fingerprint=fingerprint, rows=rows)
            checkpoint_row()

        t0 = time.perf_counter()
        row = eval_row(dock_fn, complexes, key, partial=partial,
                       on_progress=on_progress, device=device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds[key] = time.perf_counter() - t0
        row["fingerprint"] = fingerprint
        # Provenance, not protocol: kept out of the fingerprint.
        row["platform"] = platform_name(device)
        results[key] = row
        results.pop(pkey, None)
        checkpoint_row()

    params = None
    for mode in settings["modes"]:
        base = protocol_base(settings, mode)
        rescore_top = settings["rescore"]
        # Shape-complementarity baseline (params=None).
        shape_pipe = DockingPipeline(DockConfig(rep_features=(8,), **base),
                                     device=device)
        run_row(f"shape_{mode}",
                mode_dock_fn(shape_pipe, mode, rescore_top=rescore_top))
        print(mode, "shape:", results[f"shape_{mode}"]["top1"],
              results[f"shape_{mode}"]["top10"], flush=True)

        # The learned model of the checkpoint.
        if params is None:
            params = checkpoint_params(ckpt)
        lpipe = DockingPipeline(learned_config(ckpt, settings, mode),
                                params=params, device=device)
        run_row(f"learned_{mode}",
                mode_dock_fn(lpipe, mode, rescore_top=rescore_top))
        print(mode, "learned:", results[f"learned_{mode}"]["top1"],
              results[f"learned_{mode}"]["top10"], flush=True)

        # Two-stage: the shape sweep's heads re-ranked by a learned
        # dense-cone rescore.
        if settings["rerank"] and mode == "global":
            agg = settings["agg"]

            def rerank_fn(c):
                poses = shape_pipe.dock_complex(c)
                return lpipe.rescore(c.receptor, c.ligand, poses,
                                     top=16, aggregate=agg)

            rkey = ("learned_rerank_global" if agg == "max"
                    else f"learned_rerank_global_{agg}")
            run_row(rkey, rerank_fn)
            print(f"global learned_rerank[{agg}]:", results[rkey]["top1"],
                  results[rkey]["top10"], flush=True)

    results["protocol"] = dict(n_rotations=settings["n_rot"],
                               grid=settings["grid"], n_complexes=n_cplx,
                               size_diverse=settings["widen"],
                               unbound_rmsd=settings["unbound"],
                               backbone=settings["backbone"],
                               heldout_seeds=[seed0 + s
                                              for s in range(n_cplx)])
    with open(out_path, "w") as f:
        json.dump(results, f, indent=2)
    return results, seconds


def main(argv: Optional[list] = None) -> Dict:
    ap = argparse.ArgumentParser(
        prog="python -m deeplocalproteindocking_torch.eval_matrix",
        description="Held-out learned-vs-shape matrix (EM_* knobs).")
    ap.add_argument("ckpt", nargs="?", default="pretrained/synthetic-v9p/best")
    ap.add_argument("out_json", nargs="?", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out_path = args.out_json or os.path.join(args.ckpt, "eval_matrix.json")
    results, seconds = run_matrix(args.ckpt, out_path, settings_from_env(),
                                  device=args.device)
    print(json.dumps({k: (dict(top1=v["top1"], top10=v["top10"])
                          if isinstance(v, dict) and "top1" in v else v)
                      for k, v in results.items()}, indent=2))
    print(json.dumps({"row_seconds": seconds}), flush=True)
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
