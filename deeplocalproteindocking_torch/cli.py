"""Command-line entry points of the port.

    python -m deeplocalproteindocking_torch.cli <command> ...

Port of ``deeplocalproteindocking_tpu/cli.py``: the same commands, flags
and output files (``poses.json``, ``pose_NNN.pdb``, ``screen.json``,
``train.jsonl``, ``<name>_decoys.npz``, the final JSON line of
``doctor``).  What differs:

* ``--device {cuda,cpu}`` (default ``cuda``) is where every tensor lives;
  ``cuda`` without a visible card raises, it never falls back.
* ``--checkpoint DIR`` loads the latest ``DIR/step_*``, as the JAX
  restore takes it: the port's own ``state.pt`` or the JAX trainer's
  Orbax checkpoint (read without JAX, ``train/checkpoint.py``); or else
  ``DIR/best_params.npz``.  Its ``config.json`` is the base config, as
  in the JAX CLI.
* ``--mesh-rot`` and the config's ``mesh_batch`` above 1 run the
  command on a ``(rot, batch)`` mesh of ``torch.distributed`` ranks
  (``parallel/mesh.py``), one process per rank, every rank running the
  same command: ``torchrun --nproc-per-node N -m
  deeplocalproteindocking_torch.cli dock --mesh-rot N ...``.  Each rank
  takes its own card (``cuda:LOCAL_RANK``; with ``--device cpu``, gloo
  ranks on the CPU); rank 0 alone writes files.  Without a matching
  process group the command raises, naming the torchrun line to use.
* ``--debug-nans`` raises ``FloatingPointError`` on a NaN or +inf score
  and on a non-finite loss or gradient (``jax_debug_nans``' role).
* ``--profile DIR`` writes a ``torch.profiler`` Chrome trace into DIR.
* ``generate-dataset --decoys`` draws on a torch generator seeded with
  ``--seed + i``: JAX's PRNG streams cannot be reproduced, so the files
  match the JAX CLI's in layout and labels, not in samples.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch

from deeplocalproteindocking_torch.parallel.mesh import barrier, is_main_rank


def _add_config_args(p: argparse.ArgumentParser):
    p.add_argument("--preset", default=None,
                   help="named preset from config.PRESETS")
    p.add_argument("--grid-size", type=int, default=None)
    p.add_argument("--resolution", type=float, default=None)
    p.add_argument("--num-rotations", type=int, default=None)
    p.add_argument("--top-k", type=int, default=None)
    p.add_argument("--local-cone-deg", type=float, default=None)
    p.add_argument("--mesh-rot", type=int, default=None,
                   help="rotation shards across ranks (run the command "
                        "under torchrun with mesh_rot x mesh_batch "
                        "processes)")
    p.add_argument("--sweep-mode", default=None,
                   choices=["resplat", "resample"])
    p.add_argument("--fft-impl", default=None,
                   choices=["dft_fused", "dft", "dft_pallas", "xla",
                            "block"])
    p.add_argument("--fft-block", type=int, default=None,
                   help="translation-block edge for --fft-impl block "
                        "(must divide grid size)")
    p.add_argument("--coupling-rank", type=int, default=None,
                   help="SVD-truncate the learned channel coupling to "
                        "this rank before the sweep (0/unset = full rank)")
    p.add_argument("--debug-nans", action="store_true",
                   help="raise FloatingPointError on a NaN score or a "
                        "non-finite loss or gradient")
    p.add_argument("--profile", default=None,
                   help="directory for a torch.profiler Chrome trace")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where every tensor lives (cuda needs a card)")


def _device(args) -> torch.device:
    """The device of ``--device``; ``cuda`` without a card raises."""
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA card is visible "
                         "(torch.cuda.is_available() is false); pass "
                         "--device cpu to run on the CPU")
    return torch.device(args.device)


def _build_config(args):
    """Preset, then the checkpoint's ``config.json``, then the flags."""
    from deeplocalproteindocking_torch.config import DockConfig, PRESETS
    cfg = PRESETS[args.preset] if args.preset else DockConfig()
    # A checkpoint carries the config it was trained with: it is the base,
    # so scoring semantics match the weights; explicit flags overlay it.
    ckpt = getattr(args, "checkpoint", None)
    if ckpt:
        ckpt_cfg_path = os.path.join(ckpt, "config.json")
        if os.path.exists(ckpt_cfg_path):
            with open(ckpt_cfg_path) as f:
                cfg = DockConfig.from_json(f.read())
    overrides = {k: getattr(args, k) for k in (
        "grid_size", "resolution", "num_rotations", "top_k",
        "local_cone_deg", "mesh_rot", "sweep_mode", "fft_impl",
        "fft_block") if getattr(args, k, None) is not None}
    cr = getattr(args, "coupling_rank", None)
    if cr is not None:
        overrides["coupling_rank"] = cr or None   # 0 -> full rank
    if getattr(args, "debug_nans", False):
        overrides["debug_nans"] = True
    if getattr(args, "global_frac", None) is not None:
        overrides["decoy_global_frac"] = args.global_frac
    if ckpt:
        # Geometry flags change scoring semantics relative to training.
        for geom in ("resolution", "grid_size"):
            if geom in overrides and overrides[geom] != getattr(cfg, geom):
                print(f"warning: --{geom.replace('_', '-')}="
                      f"{overrides[geom]} differs from the checkpoint's "
                      f"training value {getattr(cfg, geom)}; scores may "
                      f"not match training semantics", file=sys.stderr)
    return cfg.replace(**overrides)


def _mesh(cfg, device, command: str):
    """``(mesh, device)``: the config's ``(mesh_rot, mesh_batch)`` mesh
    and this rank's device, or ``(None, device)`` for a mesh of one.
    Joins torchrun's process group; without one (or with a world size
    other than ``mesh_rot * mesh_batch``) it raises with the torchrun
    line that fits."""
    from deeplocalproteindocking_torch.parallel import mesh as pmesh
    need = cfg.mesh_rot * cfg.mesh_batch
    if need == 1:
        return None, device
    try:
        device = pmesh.init_distributed(device.type)
        return pmesh.make_mesh(cfg.mesh_rot, cfg.mesh_batch,
                               device.type), device
    except (RuntimeError, ValueError) as e:
        hint = pmesh.torchrun_line(need, command)
        raise SystemExit(
            f"mesh (rot={cfg.mesh_rot}, batch={cfg.mesh_batch}): {e}"
            + ("" if hint in str(e) else f"; run `{hint}`")) from e



def load_checkpoint_params(ckpt: str) -> dict:
    """Params of checkpoint directory ``ckpt``: its latest ``step_*``,
    the port's ``state.pt`` (``Trainer.save``) or the JAX trainer's
    Orbax checkpoint, as the JAX CLI takes it; else ``best_params.npz``.
    A checkpoint that is missing or damaged exits naming it."""
    from deeplocalproteindocking_torch.train import checkpoint
    try:
        return checkpoint.params_or_npz(
            ckpt, os.path.join(ckpt, "best_params.npz"))
    except (OSError, ValueError) as e:
        raise SystemExit(f"checkpoint {ckpt}: {e}") from e


def _build_pipeline(cfg, checkpoint, device, mesh=None):
    from deeplocalproteindocking_torch.pipeline import DockingPipeline
    params = (load_checkpoint_params(checkpoint)
              if checkpoint else None)
    return DockingPipeline(cfg, params=params, device=device, mesh=mesh)


def _check_scores(cfg, scores):
    """``--debug-nans``: a NaN or +inf score raises (a -inf score is a
    masked translation)."""
    s = np.asarray(scores)
    if cfg.debug_nans and bool(np.any(np.isnan(s) | (s == np.inf))):
        raise FloatingPointError(f"non-finite docking score: {s}")


def _write_poses(out, poses, lig_models, num_out, pairs=None):
    """``pose_NNN.pdb`` for the first ``num_out`` poses and ``poses.json``
    for all, the JAX CLI's layout."""
    from deeplocalproteindocking_torch.structure.pdb import write_pdb
    os.makedirs(out, exist_ok=True)
    n = min(len(poses), num_out)
    for i in range(n):
        src = lig_models[0 if pairs is None else int(pairs[i, 1])]
        s = dataclasses.replace(src)
        s.coords = poses.ligand_coords(src.coords, i).astype(np.float32)
        write_pdb(os.path.join(out, f"pose_{i:03d}.pdb"), s)
    table = []
    for i in range(len(poses)):
        row = dict(rank=i, score=float(poses.scores[i]),
                   rot_idx=int(poses.rot_idx[i]),
                   shift=[int(v) for v in poses.shifts[i]])
        if pairs is not None:
            row.update(receptor_model=int(pairs[i, 0]) + 1,
                       ligand_model=int(pairs[i, 1]) + 1)
        table.append(row)
    with open(os.path.join(out, "poses.json"), "w") as f:
        json.dump(table, f, indent=2)
    return n


def cmd_dock(args):
    from deeplocalproteindocking_torch.structure.mmcif import (
        count_models, parse_structure)
    from deeplocalproteindocking_torch.utils.profiling import maybe_trace
    device = _device(args)
    cfg = _build_config(args)
    mesh, device = _mesh(cfg, device, args.command)
    pipe = _build_pipeline(cfg, args.checkpoint, device, mesh)

    def load(path, model, chain_sel):
        s = parse_structure(path, model=model).typed()
        return s.chains(list(chain_sel)) if chain_sel else s

    if args.ensemble:
        if args.rescore_top or args.refine_steps:
            raise SystemExit(
                "--ensemble is incompatible with --rescore-top/"
                "--refine-steps (rescoring is defined per model pair); "
                "dock a single model pair instead")
        n_rec = count_models(args.receptor)
        n_lig = count_models(args.ligand)
        if args.max_models:
            n_rec = min(n_rec, args.max_models)
            n_lig = min(n_lig, args.max_models)
        recs = [load(args.receptor, m + 1, args.receptor_chains)
                for m in range(n_rec)]
        ligs = [load(args.ligand, m + 1, args.ligand_chains)
                for m in range(n_lig)]
        print(f"ensemble dock: {n_rec} receptor x {n_lig} ligand "
              f"models ({args.ensemble} pairing)")
        with maybe_trace(args.profile):
            poses, pairs = pipe.dock_ensemble(recs, ligs,
                                              pairing=args.ensemble)
        _check_scores(cfg, poses.scores)
        if is_main_rank():
            n = _write_poses(args.out, poses, [l.centered() for l in ligs],
                             args.num_out, pairs)
            print(f"wrote {n} pose PDBs + poses.json to {args.out}")
        return
    rec = load(args.receptor, args.receptor_model, args.receptor_chains)
    lig = load(args.ligand, args.ligand_model, args.ligand_chains)
    with maybe_trace(args.profile):
        poses = pipe.dock(rec, lig)
        if args.rescore_top:
            poses = pipe.rescore(rec, lig, poses, top=args.rescore_top)
        if args.refine_steps:
            poses = pipe.refine(rec, lig, poses, steps=args.refine_steps)
    _check_scores(cfg, poses.scores)
    if is_main_rank():
        n = _write_poses(args.out, poses, [lig.centered()], args.num_out)
        print(f"wrote {n} pose PDBs + poses.json to {args.out}")


def cmd_generate_dataset(args):
    from deeplocalproteindocking_torch.data.benchmark import (
        synthetic_complex)
    from deeplocalproteindocking_torch.structure.pdb import write_pdb
    os.makedirs(args.out, exist_ok=True)
    for i in range(args.num_complexes):
        c = synthetic_complex(seed=args.seed + i, backbone=args.backbone,
                              unbound_rmsd=args.unbound_rmsd)
        write_pdb(os.path.join(args.out, f"{c.name}_r_u.pdb"), c.receptor)
        write_pdb(os.path.join(args.out, f"{c.name}_l_u.pdb"), c.ligand)
        if args.decoys:
            # Labelled decoy pose sets for interchange and inspection
            # (training draws its own on the fly).
            from deeplocalproteindocking_torch.train.data_gen import (
                native_voxel_shift)
            from deeplocalproteindocking_torch.train.decoys import (
                generate_decoys)
            lig_c = c.ligand.centered().typed()
            ds = generate_decoys(
                torch.Generator().manual_seed(args.seed + i),
                torch.as_tensor(lig_c.coords), torch.ones(len(lig_c)),
                torch.as_tensor(native_voxel_shift(c, 1.25)),
                n=args.decoys, resolution=1.25,
                max_angle=float(np.deg2rad(50.0)), max_shift=8.0)
            np.savez(os.path.join(args.out, f"{c.name}_decoys.npz"),
                     rotations=ds.rotations.numpy(),
                     shifts=ds.shifts.numpy(), lrmsd=ds.lrmsd.numpy())
    print(f"wrote {args.num_complexes} synthetic complexes to {args.out}"
          + (f" (+{args.decoys}-pose decoy sets)" if args.decoys else ""))


def _ligand_paths(spec: str):
    if os.path.isdir(spec):
        return sorted(os.path.join(spec, f) for f in os.listdir(spec)
                      if f.endswith((".pdb", ".cif", ".mmcif")))
    return spec.split(",")


def cmd_screen(args):
    from deeplocalproteindocking_torch.serving import DockingService
    from deeplocalproteindocking_torch.structure.mmcif import (
        parse_structure)
    from deeplocalproteindocking_torch.utils.profiling import maybe_trace
    device = _device(args)
    cfg = _build_config(args)
    mesh, device = _mesh(cfg, device, args.command)
    params = (load_checkpoint_params(args.checkpoint)
              if args.checkpoint else None)
    svc = DockingService(cfg, params=params, device=device, mesh=mesh)
    rec = parse_structure(args.receptor).typed()
    paths = _ligand_paths(args.ligands)
    os.makedirs(args.out, exist_ok=True)
    ranking = []
    with maybe_trace(args.profile):
        for path in paths:
            lig = parse_structure(path).typed()
            poses = svc.dock(rec, lig)
            if args.rescore_top:
                poses = svc.rescore(rec, lig, poses, top=args.rescore_top)
            _check_scores(cfg, poses.scores)
            name = os.path.splitext(os.path.basename(path))[0]
            ranking.append(dict(
                ligand=name, best_score=float(poses.scores[0]),
                poses=[dict(rank=i, score=float(poses.scores[i]),
                            shift=[int(v) for v in poses.shifts[i]])
                       for i in range(min(len(poses), args.num_out))]))
    ranking.sort(key=lambda r: -r["best_score"])
    if not is_main_rank():
        return
    with open(os.path.join(args.out, "screen.json"), "w") as f:
        json.dump(dict(receptor=args.receptor, cache=svc.stats,
                       ranking=ranking), f, indent=2)
    print(f"screened {len(paths)} ligands "
          f"(receptor prepared {svc.stats['misses']}x, "
          f"served {svc.stats['hits']}x from cache); "
          f"ranking -> {args.out}/screen.json")


def _load_complexes(args):
    from deeplocalproteindocking_torch.data.benchmark import (
        list_benchmark, load_complex, synthetic_complex)
    if args.data_dir:
        return [load_complex(args.data_dir, c)
                for c in list_benchmark(args.data_dir)]
    return [synthetic_complex(seed=i) for i in range(args.synthetic)]


def cmd_evaluate(args):
    from deeplocalproteindocking_torch.evaluation import (
        run_benchmark, run_benchmark_batched)
    from deeplocalproteindocking_torch.utils.profiling import maybe_trace
    device = _device(args)
    cfg = _build_config(args)
    mesh, device = _mesh(cfg, device, args.command)
    pipe = _build_pipeline(cfg, args.checkpoint, device, mesh)
    complexes = _load_complexes(args)
    with maybe_trace(args.profile):
        if args.batch_size > 1:
            summary = run_benchmark_batched(
                pipe, complexes, args.out, group_size=args.batch_size,
                refine_steps=args.refine_steps, rescore_top=args.rescore_top)
        else:
            summary = run_benchmark(
                pipe, complexes, args.out, refine_steps=args.refine_steps,
                rescore_top=args.rescore_top)
    if is_main_rank():
        print(json.dumps(summary, indent=2))


def _checked_step(trainer, value_and_grad, state, batch):
    """A train step with ``--debug-nans``' checks between the gradient
    (``value_and_grad``: the trainer's, or the mesh step's) and the
    update."""
    loss, acc, grads = value_and_grad(state.params, batch)
    for name, v in [("loss", loss)] + sorted(grads.items()):
        if not bool(torch.isfinite(torch.as_tensor(v)).all()):
            raise FloatingPointError(f"non-finite {name} in a train step")
    return (trainer.apply_gradients(state, grads),
            {"loss": loss, "ranking_accuracy": acc})


def cmd_train(args):
    """Train, or resume from ``--ckpt-dir``.  As in the JAX CLI, whose
    checkpoints keep the run's first PRNG key, every checkpoint keeps the
    data generator's state of ``Trainer.init_state``: a resumed run draws
    its batches again from the run's first one.  On a mesh every rank
    draws the same batch from its CPU generator and takes its tile
    (``parallel/train_parallel.py``); rank 0 mines the hard negatives and
    broadcasts them (the card's splat is not bit-reproducible, and every
    rank must see the same batch), and rank 0 alone writes checkpoints
    and ``train.jsonl``."""
    import torch.distributed as dist
    from deeplocalproteindocking_torch.train.data_gen import (
        fit_lig_grid, make_training_batch)
    from deeplocalproteindocking_torch.train.trainer import Trainer
    from deeplocalproteindocking_torch.utils.logging import MetricsLogger
    from deeplocalproteindocking_torch.utils.profiling import maybe_trace
    device = _device(args)
    cfg = _build_config(args)
    mesh, device = _mesh(cfg, device, args.command)
    complexes = _load_complexes(args)
    cfg = fit_lig_grid(complexes, cfg)   # auto-size for big ligands
    trainer = Trainer(cfg, device)
    step_fn, value_and_grad = trainer.train_step, trainer.value_and_grad
    if mesh is not None:
        from deeplocalproteindocking_torch.parallel.train_parallel import (
            make_parallel_train_step)
        step_fn = make_parallel_train_step(trainer, mesh)
        value_and_grad = step_fn.value_and_grad
        if is_main_rank():
            print(f"multi-GPU training on mesh (rot={cfg.mesh_rot}, "
                  f"batch={cfg.mesh_batch})")
    barrier()
    if args.resume and os.path.isdir(args.ckpt_dir) and any(
            d.startswith("step_") for d in os.listdir(args.ckpt_dir)):
        state = trainer.restore(args.ckpt_dir)
        print(f"resumed from step {state.step}")
    else:
        state = trainer.init_state()
    gen = torch.Generator()
    if state.rng is None:    # a JAX state: its key cannot be reproduced
        gen.manual_seed(cfg.seed)
    else:
        gen.set_state(state.rng)
    logger = (MetricsLogger(os.path.join(args.ckpt_dir, "train.jsonl"))
              if is_main_rank() else MetricsLogger(None, echo=False))
    mined = None
    with maybe_trace(args.profile):
        for step in range(state.step, args.steps):
            if args.mine_every and step % args.mine_every == 0:
                from deeplocalproteindocking_torch.train.mining import (
                    mine_hard_negatives)
                mined = [mine_hard_negatives(
                    trainer.bind(state.params), cfg, complexes,
                    n_rotations=args.mine_rotations)
                    if is_main_rank() else None]
                if mesh is not None:
                    dist.broadcast_object_list(mined, src=0)
                mined = mined[0]
                logger.log("mined_hard_negatives", step=step,
                           complexes=len(mined))
            batch = make_training_batch(gen, complexes, cfg, mined=mined,
                                        device=device)
            if cfg.debug_nans:
                state, metrics = _checked_step(trainer, value_and_grad,
                                               state, batch)
            else:
                state, metrics = step_fn(state, batch)
            logger.log("train_step", step=step, **metrics)
            if (step + 1) % args.ckpt_every == 0 or step + 1 == args.steps:
                if is_main_rank():
                    trainer.save(args.ckpt_dir, state)
                barrier()
    logger.close()
    if is_main_rank():
        print(f"trained to step {state.step}; checkpoints in "
              f"{args.ckpt_dir}")


def _probe_backend(timeout: float):
    """The card's identity and count, from a subprocess that can be
    killed: a CUDA initialisation that hangs must not hang the
    diagnostics.  ``ok=False`` carries the reason."""
    import subprocess
    code = ("import json, torch; ok = torch.cuda.is_available(); "
            "print(json.dumps({'backend': 'cuda' if ok else 'cpu', "
            "'n_devices': torch.cuda.device_count() if ok else 0, "
            "'device0': torch.cuda.get_device_name(0) if ok else 'cpu', "
            "'torch': torch.__version__, 'cuda': torch.version.cuda}))")
    try:
        r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                           text=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        return dict(ok=False, error=f"device probe hung >{timeout:.0f}s")
    if r.returncode != 0:
        return dict(ok=False, error=(r.stderr or "").strip()[-400:])
    try:
        out = json.loads(r.stdout.strip().splitlines()[-1])
    except (IndexError, ValueError):
        return dict(ok=False, error=f"probe emitted no JSON (stdout tail: "
                                    f"{(r.stdout or '')[-200:]!r})")
    out["ok"] = True
    return out


def _distributed(probe: dict, device_type: str) -> dict:
    """World size, backend, NCCL's availability and each rank's device:
    gathered from every rank under torchrun (``WORLD_SIZE`` > 1), else
    this one process and the probe's card."""
    import torch.distributed as dist
    from deeplocalproteindocking_torch.parallel import mesh as pmesh
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        return pmesh.describe(pmesh.init_distributed(device_type))
    card = (f"cuda:0 ({probe['device0']})"
            if probe.get("backend") == "cuda" else "cpu")
    return dict(world_size=1, backend=None,
                nccl_available=dist.is_available() and dist.is_nccl_available(),
                rank_devices=[card])


def _say_distributed(d: dict) -> str:
    return (f"distributed: world size {d['world_size']}, backend "
            f"{d['backend'] or 'none (one process)'}, NCCL available "
            f"{d['nccl_available']}; rank devices: "
            + ", ".join(f"{r}: {dev}" for r, dev in
                        enumerate(d['rank_devices'])))


def cmd_info(args):
    from deeplocalproteindocking_torch.config import PRESETS
    probe = _probe_backend(timeout=60.0)
    if probe.get("ok"):
        print(f"devices: {probe['n_devices']} x {probe['device0']} "
              f"({probe['backend']}; torch {probe['torch']}, CUDA "
              f"{probe['cuda']})")
    else:
        print(f"devices: UNAVAILABLE - {probe['error']}")
    print(_say_distributed(_distributed(
        probe, "cuda" if probe.get("backend") == "cuda" else "cpu")))
    print("presets:")
    for name, cfg in PRESETS.items():
        print(f"  {name}: grid={cfg.grid_size} rot={cfg.num_rotations} "
              f"topk={cfg.top_k} mesh=({cfg.mesh_rot},{cfg.mesh_batch})")


def _routes(cfg, device_type: str) -> dict:
    """The sweep, the engine, the fused top-K tail and each kernel's
    route at the configured geometry, by the rules the sweep itself
    applies.  The ``block`` engine and the ``resample`` sweep correlate
    with ``torch.fft`` and launch none of K1, K2, K3."""
    from deeplocalproteindocking_torch.correlate import fused, idft
    from deeplocalproteindocking_torch.correlate import invz_topk
    from deeplocalproteindocking_torch.correlate.fft import resolve_engine
    from deeplocalproteindocking_torch.sweep.resplat import (
        fused_topk_engaged)
    L = cfg.grid_size
    engine = resolve_engine(cfg.fft_impl, L)
    if cfg.sweep_mode != "resplat" or engine == "block":
        off = ("not on this path (" + ("resample sweep"
               if cfg.sweep_mode != "resplat" else "block engine") + ")")
        return dict(grid=L, lig_grid=cfg.lig_grid_size,
                    dtype=cfg.dft_dtype, sweep_mode=cfg.sweep_mode,
                    engine=("full-grid torch.fft" if cfg.sweep_mode
                            != "resplat" else engine),
                    fft_block=cfg.fft_block if engine == "block" else None,
                    fused_topk=False, k1=off, k2=off, k3=off)
    dt = torch.float32 if cfg.dft_dtype == "float32" else torch.bfloat16
    ls = cfg.lig_grid_size
    if ls is None:
        # Every box up to L takes one route (``fused.k1_route``).
        k1 = (f"box from the ligand: "
              f"{fused.k1_route(dt, 16, 16, L, L, L, L)} for every box")
    else:
        k1 = fused.k1_route(dt, ls, ls, L, L, L, L)
    if engine != "dft_fused":
        k2 = "not launched"
    elif L in invz_topk.FFT_GRIDS:
        k2 = invz_topk.k2_route(L)
    else:
        k2 = "not launched (the fused top-K tail needs L % 32 == 0)"
    k3 = (idft.k3_route(L) if L in idft.FFT_GRIDS
          else "none (dft_pallas takes L % 16 == 0 up to 128)")
    if engine != "dft_pallas":
        k3 += " (launched by dft_pallas only)"
    return dict(grid=L, lig_grid=ls, dtype=cfg.dft_dtype,
                sweep_mode=cfg.sweep_mode, engine=engine, fft_block=None,
                fused_topk=fused_topk_engaged(
                    None, engine, cfg.topk_impl, L, torch.device(device_type)),
                k1=k1 if engine == "dft_fused" else "not launched",
                k2=k2, k3=k3)


def _say(tag: str, msg: str):
    print(f"[{tag}]".ljust(7) + msg)


def cmd_doctor(args):
    """Diagnostics that never hang: the card (a subprocess probe with a
    timeout), the native parsers, the kernel library, the TF32 flags, the
    routes at the configured geometry, the checkpoint's rank licence."""
    from deeplocalproteindocking_torch import _build, native
    report = {}
    probe = _probe_backend(timeout=args.timeout)
    report["backend"] = probe
    card = probe.get("ok") and probe.get("backend") == "cuda"
    if card:
        _say("ok", f"card: {probe['device0']} ({probe['n_devices']} "
                   f"device(s), torch {probe['torch']}, CUDA "
                   f"{probe['cuda']})")
    elif probe.get("ok"):
        _say("ok" if args.device == "cpu" else "FAIL",
             f"card: none visible (torch {probe['torch']}); the entry "
             f"points need --device cpu")
    else:
        _say("FAIL", f"card: {probe['error']}")
    report["distributed"] = _distributed(probe, args.device)
    _say("ok", _say_distributed(report["distributed"]))

    # Native parsers (host; pure-Python fallbacks exist).
    st = native.status()
    for mod, syms in [("pdb_native", ["pdb_count_atoms", "pdb_parse_v2"]),
                      ("cif_native", ["cif_tokenize_v1",
                                      "cif_atom_site_v1"])]:
        if st["ok"]:
            lib = native.library()
            missing = [s for s in syms if not hasattr(lib, s)]
            report[mod] = dict(ok=not missing, path=st["path"],
                               missing=missing)
            _say("warn" if missing else "ok", f"native {mod}: " + (
                f"missing {missing} (pure-Python fallback)" if missing
                else ", ".join(syms)))
        else:
            report[mod] = dict(ok=False, error=st["error"])
            _say("warn", f"native {mod}: unavailable ({st['error']}); "
                         f"pure-Python fallback")

    lib_path = _build.library_path()
    built = os.path.exists(lib_path)
    report["kernels"] = dict(built=built, path=lib_path)
    _say("ok", f"kernel library: {lib_path} (" + (
        "built" if built else "not built yet: nvcc builds it at the "
        "first launch on the card") + ")")

    # torch's defaults: float32 convs on cuDNN's TF32, matmuls not.
    tf32 = dict(matmul=torch.backends.cuda.matmul.allow_tf32,
                cudnn=torch.backends.cudnn.allow_tf32)
    report["tf32"] = tf32
    _say("ok", f"TF32: matmul {tf32['matmul']}, cuDNN conv {tf32['cudnn']}")

    cfg = _build_config(args)
    routes = _routes(cfg, "cuda" if card else "cpu")
    report["routes"] = routes
    _say("ok", f"routes at grid {routes['grid']} ({routes['dtype']}, "
               f"{routes['sweep_mode']}, {routes['engine']}"
               + (f" block {routes['fft_block']}" if routes['fft_block']
                  else "") + ", fused top-K "
               f"{'on' if routes['fused_topk'] else 'off'}): K1 "
               f"{routes['k1']}, K2 {routes['k2']}, K3 {routes['k3']}")

    if args.checkpoint:
        from deeplocalproteindocking_torch.pipeline import (
            coupling_deviation_capture, min_licensed_rank)
        try:
            params = load_checkpoint_params(args.checkpoint)
            A = params["coupling"].detach().cpu().numpy()
            sp = bool(cfg.shape_prior)
            lic = min_licensed_rank(A, shape_prior=sp)
            kept, dev = coupling_deviation_capture(A, lic, shape_prior=sp)
            report["license"] = dict(shape=list(A.shape), licensed_rank=lic,
                                     kept=kept, deviation=dev)
            _say("ok", f"checkpoint coupling {tuple(A.shape)}: licensed "
                       f"rank >= {lic} (keeps {kept:.0%} of the learned "
                       f"deviation ||A-prior||={dev:.4f})")
        except (Exception, SystemExit) as e:  # noqa: BLE001 -- a report
            _say("warn", f"checkpoint license: {e}")
            report["license"] = dict(ok=False, error=str(e))

    ok = bool(probe.get("ok")) and (card or args.device == "cpu")
    print(json.dumps(dict(doctor_ok=ok, **report)))
    return 0 if ok else 1


def main(argv=None):
    ap = argparse.ArgumentParser(prog="deeplocalproteindocking_torch")
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("dock", help="dock one receptor/ligand pair")
    p.add_argument("--receptor", required=True)
    p.add_argument("--ligand", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--num-out", type=int, default=10)
    p.add_argument("--receptor-model", type=int, default=1,
                   help="NMR model of the receptor file to dock "
                        "(1-based; PDB MODEL records or mmCIF "
                        "pdbx_PDB_model_num)")
    p.add_argument("--ligand-model", type=int, default=1,
                   help="NMR model of the ligand file to dock")
    p.add_argument("--ensemble", choices=["product", "zip"], default=None,
                   help="dock ALL NMR models of both files and merge "
                        "the ranked poses (product: every pair; zip: "
                        "model i vs model i)")
    p.add_argument("--max-models", type=int, default=0,
                   help="with --ensemble, cap the models taken from "
                        "each file (0 = all)")
    p.add_argument("--receptor-chains", default="",
                   help="chain letters to keep, e.g. 'AB'")
    p.add_argument("--ligand-chains", default="")
    p.add_argument("--refine-steps", type=int, default=0,
                   help="continuous pose refinement iterations")
    p.add_argument("--rescore-top", type=int, default=0,
                   help="hierarchical rescoring: dense local cone "
                        "sweep around each of the top-N cluster heads")
    _add_config_args(p)
    p.set_defaults(fn=cmd_dock)

    p = sub.add_parser("generate-dataset",
                       help="write synthetic benchmark complexes")
    p.add_argument("--out", required=True)
    p.add_argument("--num-complexes", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--backbone", action="store_true",
                   help="polymer covalent geometry (data/polymer.py)")
    p.add_argument("--unbound-rmsd", type=float, default=0.0,
                   help="deform receptor+ligand in place by this "
                        "per-atom RMSD (unbound protocol)")
    p.add_argument("--decoys", type=int, default=0,
                   help="also write an N-pose labelled decoy set per "
                        "complex (<name>_decoys.npz: rotations, voxel "
                        "shifts, LRMSD labels)")
    p.set_defaults(fn=cmd_generate_dataset)

    p = sub.add_parser("evaluate", help="benchmark sweep + hit-rate table")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--synthetic", type=int, default=4)
    p.add_argument("--out", required=True)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--refine-steps", type=int, default=0)
    p.add_argument("--rescore-top", type=int, default=0,
                   help="hierarchical rescoring of the top-N cluster "
                        "heads before grading")
    p.add_argument("--batch-size", type=int, default=1,
                   help=">1: dock groups of complexes as one batched "
                        "sweep (throughput mode)")
    _add_config_args(p)
    p.set_defaults(fn=cmd_evaluate)

    p = sub.add_parser("train", help="train the representation model")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--synthetic", type=int, default=4)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--ckpt-dir", required=True)
    p.add_argument("--ckpt-every", type=int, default=25)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--mine-every", type=int, default=0,
                   help=">0: refresh FFT-mined hard negatives every N "
                        "steps (train/mining.py)")
    p.add_argument("--mine-rotations", type=int, default=256)
    p.add_argument("--global-frac", type=float, default=None,
                   help="fraction of decoys sampled globally "
                        "(config.decoy_global_frac)")
    _add_config_args(p)
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser(
        "screen",
        help="dock ONE receptor against MANY ligands (the receptor half "
             "is computed once and cached: serving.DockingService)")
    p.add_argument("--receptor", required=True)
    p.add_argument("--ligands", required=True,
                   help="directory of ligand .pdb/.cif files, or a "
                        "comma-separated file list")
    p.add_argument("--out", required=True)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--num-out", type=int, default=5)
    p.add_argument("--rescore-top", type=int, default=0)
    _add_config_args(p)
    p.set_defaults(fn=cmd_screen)

    p = sub.add_parser("info", help="devices and presets")
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser(
        "doctor",
        help="diagnostics: the card (hang-proof probe), native parsers, "
             "kernel library, TF32 flags, kernel routes, checkpoint rank "
             "licence")
    p.add_argument("--checkpoint", default=None,
                   help="also report this checkpoint's coupling-rank "
                        "licence (dir containing config.json)")
    p.add_argument("--timeout", type=float, default=60.0,
                   help="device probe timeout seconds")
    _add_config_args(p)
    p.set_defaults(fn=cmd_doctor)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
