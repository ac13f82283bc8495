"""Train the flagship hybrid model: the port of ``tools/train_flagship.py``.

    python -m deeplocalproteindocking_torch.train_flagship [steps] \
        [ckpt_dir] [--device cuda|cpu]

Curriculum for global-docking wins, as the JAX script runs it:

* the hybrid shape-prior model (untrained, it scores shape
  complementarity), so the baseline is the optimization's zero point;
* local + global decoys + FFT-mined hard negatives: every
  ``TF_MINE_EVERY`` steps the current model sweeps ``TF_MINE_CHUNK``
  training complexes (rotating through the set) and their top-24 poses
  join a persistent buffer (``mined.npz``);
* AdamW with a cosine rate, an EMA of the weights with a warmup-capped
  decay, and validation-selected checkpoints: every ``TF_VAL_EVERY``
  steps (and at the last) the EMA weights dock validation complexes
  (seeds 50+) globally through ``DockingPipeline.dock_complex`` and
  ``evaluation.grade_poses``; the best ``(top1, top10, -lrmsd)`` is saved
  in ``best/``.

A run resumes from ``ckpt_dir``: the latest ``step_*`` checkpoint under
the run's saved ``config.json``, the EMA weights (``ema/``), the mined
buffer and ``best.json``; the steps may be the port's ``state.pt`` or a
run of the JAX script's Orbax checkpoints (``Trainer.restore``).  A ``config.json`` with no checkpoint beside
it starts a run under that configuration.  As in the JAX script, whose
checkpoints keep the run's first PRNG key, each checkpoint keeps the data
generator's state from ``Trainer.init_state``: a resumed run draws its
batches again from the run's first one.  Events go to ``train.jsonl`` (with each
step's, mining round's and validation's seconds), a summary to
``TRAINING.json``.

Knobs (the JAX script's): TF_GRID, TF_NROT_MINE, TF_MINE_EVERY,
TF_SEEDS, TF_VAL_EVERY, TF_VAL_NROT, TF_VAL_COMPLEXES, TF_MINE_CHUNK,
TF_SEED0, TF_VAL_SEED0, TF_UNBOUND (deformation RMSD), TF_EMA (decay, 0
= raw params), TF_BACKBONE (polymer fixtures), TF_LR, TF_GLOBAL_FRAC,
TF_NEAR_NATIVE, TF_MARGIN, TF_FEATURES.  ``--device`` (default
``cuda``) is where the model, the batches and the sweeps live.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch

from deeplocalproteindocking_torch.config import DockConfig
from deeplocalproteindocking_torch.data.benchmark import synthetic_band
from deeplocalproteindocking_torch.evaluation import grade_poses
from deeplocalproteindocking_torch.pipeline import DockingPipeline
from deeplocalproteindocking_torch.train.data_gen import (
    fit_lig_grid, make_training_batch)
from deeplocalproteindocking_torch.train.mining import (
    load_mined, merge_mined, mine_hard_negatives, save_mined)
from deeplocalproteindocking_torch.train.trainer import Trainer
from deeplocalproteindocking_torch.utils.logging import MetricsLogger

DEFAULT_CKPT = os.path.join("runs", "train_flagship")


def settings_from_env(environ: Mapping[str, str] = os.environ) -> Dict:
    """The run's knobs, read from the JAX script's TF_* variables."""
    return dict(
        grid=int(environ.get("TF_GRID", 64)),
        mine_every=int(environ.get("TF_MINE_EVERY", 50)),
        mine_rots=int(environ.get("TF_NROT_MINE", 192)),
        n_train=int(environ.get("TF_SEEDS", 192)),
        seed0=int(environ.get("TF_SEED0", 200)),
        mine_chunk=int(environ.get("TF_MINE_CHUNK", 48)),
        val_every=int(environ.get("TF_VAL_EVERY", 100)),
        val_nrot=int(environ.get("TF_VAL_NROT", 256)),
        n_val=int(environ.get("TF_VAL_COMPLEXES", 16)),
        val_seed0=int(environ.get("TF_VAL_SEED0", 50)),
        unbound=float(environ.get("TF_UNBOUND", 0.0)),
        ema=float(environ.get("TF_EMA", 0.999)),
        backbone=environ.get("TF_BACKBONE", "0") == "1",
        lr=float(environ.get("TF_LR", 3e-4)),
        global_frac=float(environ.get("TF_GLOBAL_FRAC", 0.35)),
        near_native=float(environ.get("TF_NEAR_NATIVE", 4.0)),
        margin=float(environ.get("TF_MARGIN", 20.0)),
        features=tuple(int(x) for x in
                       environ.get("TF_FEATURES", "32,14").split(",")))


def recipe_config(settings: Dict, steps: int) -> DockConfig:
    """The flagship recipe's configuration (the JAX script's)."""
    s = settings
    return DockConfig(
        grid_size=s["grid"], resolution=1.25, rep_features=s["features"],
        shape_prior=True, num_decoys=24, batch_complexes=2,
        learning_rate=s["lr"], lr_decay_steps=steps, weight_decay=1e-4,
        near_native_rmsd=s["near_native"], hinge_margin=s["margin"],
        decoy_max_angle_deg=50.0, decoy_max_shift=8.0,
        decoy_global_frac=s["global_frac"], mined_frac=1 / 3,
        rotation_chunk=16, augment_rotations=True)


def val_global_hits(params: dict, cfg: DockConfig, complexes, n_rot=256,
                    device: torch.device | str = "cuda"):
    """Global-sweep ``(top1, top10, mean best LRMSD)`` of ``params`` on
    the validation complexes."""
    vcfg = cfg.replace(num_rotations=n_rot, top_k=32, local_cone_deg=None,
                       lig_grid_size=None)
    pipe = DockingPipeline(vcfg, params=params, device=device)
    h1 = h10 = 0
    best = []
    for c in complexes:
        graded = grade_poses(c, pipe.dock_complex(c), device=device)
        h1 += bool(graded and graded[0]["capri"] != "incorrect")
        h10 += any(g["capri"] != "incorrect" for g in graded[:10])
        best.append(min((g["lrmsd"] for g in graded), default=99.0))
    n = len(complexes)
    return h1 / n, h10 / n, float(np.mean(best))


def _clock(device: torch.device) -> float:
    """Host seconds, after the device's queued work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def run(steps: int, ckpt_dir: str, settings: Dict,
        device: torch.device | str = "cuda") -> List[Dict]:
    """Train (or resume) up to ``steps`` steps into ``ckpt_dir``; returns
    the events logged in this call."""
    device = torch.device(device)
    s = settings
    complexes = synthetic_band(s["seed0"], s["n_train"], widen=True,
                               unbound=s["unbound"], backbone=s["backbone"])
    val_cplx = synthetic_band(s["val_seed0"], s["n_val"], widen=True,
                              unbound=s["unbound"], backbone=s["backbone"])
    cfg = fit_lig_grid(complexes, recipe_config(s, steps))
    trainer = Trainer(cfg, device)
    logger = MetricsLogger(os.path.join(ckpt_dir, "train.jsonl"))
    events: List[Dict] = []

    def log(event, **fields):
        events.append(logger.log(event, **fields))

    best_dir = os.path.join(ckpt_dir, "best")
    best_json = os.path.join(ckpt_dir, "best.json")
    ema_dir = os.path.join(ckpt_dir, "ema")
    mined_npz = os.path.join(ckpt_dir, "mined.npz")
    resumed = False
    try:
        cfg_path = os.path.join(ckpt_dir, "config.json")
        if os.path.exists(cfg_path):
            # The schedule is keyed to the run's own total steps: resume
            # under the saved config, not this invocation's.
            with open(cfg_path) as f:
                cfg = DockConfig.from_json(f.read())
            trainer = Trainer(cfg, device)
        state = trainer.restore(ckpt_dir)
        resumed = True
    except (FileNotFoundError, OSError):
        state = trainer.init_state()
        # Baseline: the untrained hybrid scores shape complementarity,
        # the bar every later checkpoint must clear.
        t0 = _clock(device)
        v1, v10, vb = val_global_hits(state.params, cfg, val_cplx,
                                      s["val_nrot"], device)
        log("val", step=0, top1=v1, top10=v10, best_lrmsd=vb,
            seconds=_clock(device) - t0)
        best = dict(top1=v1, top10=v10, lrmsd=vb, step=0)
        trainer.save(ckpt_dir, state)
        os.makedirs(best_dir, exist_ok=True)
        trainer.save(best_dir, state)
        with open(best_json, "w") as f:
            json.dump(best, f)
    print(f"config: grid={cfg.grid_size} lig_grid={cfg.lig_grid_size} "
          f"decoys={cfg.num_decoys} global_frac={cfg.decoy_global_frac} "
          f"train={s['n_train']} wd={cfg.weight_decay} device={device}",
          flush=True)

    mined = None
    ema = state.params
    if resumed:
        try:
            with open(best_json) as f:
                best = json.load(f)
        except (FileNotFoundError, OSError):
            best = dict(top1=-1.0, top10=-1.0, lrmsd=99.0, step=-1)
        # The EMA and the mined buffer are training state too: losing the
        # buffer re-opens suppressed false positives.
        try:
            ema = trainer.restore(ema_dir).params
        except (FileNotFoundError, OSError):
            pass
        if os.path.exists(mined_npz):
            mined = load_mined(mined_npz)
        print(f"resumed at step {state.step} (best: {best}; mined buffer: "
              f"{sum(len(d.lrmsd) for d in (mined or {}).values())} "
              f"poses)", flush=True)

    gen = torch.Generator()
    if state.rng is None:   # a JAX state: its key cannot be reproduced
        gen.manual_seed(cfg.seed)
    else:
        gen.set_state(state.rng)
    ema_decay = s["ema"]

    def eval_params():
        return ema if ema_decay > 0 else state.params

    for step in range(state.step, steps):
        if s["mine_every"] and step % s["mine_every"] == 0 and step > 0:
            t0 = _clock(device)
            r = (step // s["mine_every"] - 1) * s["mine_chunk"]
            sub = [complexes[(r + i) % len(complexes)]
                   for i in range(min(s["mine_chunk"], len(complexes)))]
            fresh = mine_hard_negatives(trainer.bind(state.params), cfg,
                                        sub, n_rotations=s["mine_rots"],
                                        top_k=24)
            mined = merge_mined(mined, fresh)
            # The best mined pose per complex: the model's global top-24
            # neighbourhood on training complexes, for free.
            hit = float(np.mean([float(d.lrmsd.min()) < 4.0
                                 for d in fresh.values()]))
            log("mine", step=step, train_top24_hit=hit,
                buffer=sum(len(d.lrmsd) for d in mined.values()),
                rotations=len(sub) * s["mine_rots"],
                seconds=_clock(device) - t0)
        t0 = _clock(device)
        batch = make_training_batch(gen, complexes, cfg, mined=mined,
                                    device=device)
        state, metrics = trainer.train_step(state, batch)
        if ema_decay > 0:
            # Warmup-capped decay: early on the EMA tracks the raw params.
            d = min(ema_decay, (step + 1.0) / (step + 10.0))
            ema = {k: d * ema[k] + (1 - d) * state.params[k] for k in ema}
        loss = float(metrics["loss"])
        acc = float(metrics["ranking_accuracy"])
        log("train_step", step=step, loss=loss, ranking_accuracy=acc,
            seconds=_clock(device) - t0)
        if (step + 1) % s["val_every"] == 0 or step + 1 == steps:
            t0 = _clock(device)
            v1, v10, vb = val_global_hits(eval_params(), cfg, val_cplx,
                                          s["val_nrot"], device)
            log("val", step=step + 1, top1=v1, top10=v10, best_lrmsd=vb,
                seconds=_clock(device) - t0)
            if (v1, v10, -vb) > (best["top1"], best["top10"],
                                 -best["lrmsd"]):
                best = dict(top1=v1, top10=v10, lrmsd=vb, step=step + 1)
                # The validated (EMA) weights are what the best
                # checkpoint ships.
                trainer.save(best_dir, state._replace(params=eval_params()))
                with open(best_json, "w") as f:
                    json.dump(best, f)
                print("  -> new best (saved)", flush=True)
            trainer.save(ckpt_dir, state)
            if ema_decay > 0:
                trainer.save(ema_dir, state._replace(params=ema))
            if mined:
                save_mined(mined_npz, mined)
    logger.close()
    print(f"done; best val step {best['step']}: top1={best['top1']:.3f} "
          f"top10={best['top10']:.3f}", flush=True)
    with open(os.path.join(ckpt_dir, "TRAINING.json"), "w") as f:
        json.dump(dict(steps=steps, grid=s["grid"],
                       mine_every=s["mine_every"],
                       mine_rotations=s["mine_rots"], n_train=s["n_train"],
                       train_seed0=s["seed0"], unbound_rmsd=s["unbound"],
                       ema_decay=ema_decay, n_val=s["n_val"],
                       val_seed0=s["val_seed0"], best_val=best,
                       device=device.type,
                       curriculum="hybrid+local+global+persistent-mined"
                                  "+cosine-lr+valsel+ema"
                                  + (f"+unbound{s['unbound']}"
                                     if s["unbound"] else "")),
                  f, indent=2)
    return events


def main(argv: Optional[list] = None) -> List[Dict]:
    ap = argparse.ArgumentParser(
        prog="python -m deeplocalproteindocking_torch.train_flagship",
        description="Train the flagship hybrid model (TF_* knobs).")
    ap.add_argument("steps", nargs="?", type=int, default=1500)
    ap.add_argument("ckpt_dir", nargs="?", default=DEFAULT_CKPT)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(args.steps, args.ckpt_dir, settings_from_env(),
               device=args.device)


if __name__ == "__main__":
    main(sys.argv[1:])
