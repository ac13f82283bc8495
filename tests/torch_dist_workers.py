"""Rank functions of ``tests/test_torch_parallel.py`` (not a test module).

The test spawns ``torch.distributed`` ranks (gloo, on the CPU) that run
:func:`rank_main` of this module, which imports no JAX, so the ranks
neither import JAX nor run ``conftest.py``.  Each rank joins the group
through a ``FileStore`` under the test's temporary directory (six pytest
workers run at once: no TCP port), runs one job, the same on every rank
as the port's multi-device entry points expect, and saves its results
with ``torch.save``; the test reads them back and holds them against the
JAX package.

The inputs are made here from seeds with numpy, so the test feeds the
JAX package the same arrays.
"""
import json
import multiprocessing as mp
import os
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

SWEEP_L, SWEEP_C, SWEEP_NROT, SWEEP_TOPK, SWEEP_CHUNK = 16, 3, 13, 8, 2
RS_L, RS_C = 12, 2                     # the resample sweep
BATCH_L, BATCH_NROT = 16, 7
BLOCK_L, BLOCK_LS, BLOCK_C = 16, 6, 2
GATHER_N = 3                           # AllGather rows per rank
JOB_TIMEOUT_S = 300


# ---- inputs, from seeds (both sides) ----

def resplat_inputs(L=SWEEP_L, C=SWEEP_C, seed=0):
    """A receptor splatted from random atoms (its rep is the density),
    a ligand of 8 atoms and a random translation mask, as numpy."""
    rng = np.random.default_rng(seed)
    rec_xyz = rng.uniform(-3.0, 3.0, (12, 3)).astype(np.float32)
    rec_t = rng.integers(0, C, 12).astype(np.int32)
    lig_xyz = rng.uniform(-2.5, 2.5, (8, 3)).astype(np.float32)
    lig_t = rng.integers(0, C, 8).astype(np.int32)
    mask = rng.random((L, L, L)) < 0.7
    return rec_xyz, rec_t, lig_xyz, lig_t, np.ones(8, np.float32), mask


def resample_inputs(L=RS_L, C=RS_C, seed=1):
    """Random receptor and ligand reps ``[L, L, L, C]``, a coupling."""
    rng = np.random.default_rng(seed)
    rep = rng.normal(size=(2, L, L, L, C)).astype(np.float32)
    return rep[0], rep[1], rng.normal(size=(C, C)).astype(np.float32)


def batch_inputs(B=4, L=BATCH_L, C=3, seed=0):
    """B complexes as ``tests/test_torch_batch.py``'s fixture: receptor
    atoms (shifted by 1 A) and ligand atoms, random masks."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-2.5, 2.5, (B, 8, 3)).astype(np.float32)
    types = rng.integers(0, C, (B, 8)).astype(np.int32)
    masks = rng.random((B, L, L, L)) < 0.6
    return xyz, types, np.ones((B, 8), np.float32), masks


def block_inputs(seed=2):
    rng = np.random.default_rng(seed)
    rec = rng.normal(size=(BLOCK_L,) * 3 + (BLOCK_C,)).astype(np.float32)
    lig = rng.normal(size=(BLOCK_LS,) * 3 + (BLOCK_C,)).astype(np.float32)
    return rec, lig, rng.normal(size=(BLOCK_C, BLOCK_C)).astype(np.float32)


def gather_inputs(world, seed=3):
    """Each rank's ``[GATHER_N, 2]`` rows and the weights of the test's
    function of the gathered rows."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(world * GATHER_N, 2)).astype(np.float32)
    w = rng.normal(size=(world * GATHER_N, 2)).astype(np.float32)
    return x, w


def gathered_loss(y: torch.Tensor, w: torch.Tensor, rank: int
                  ) -> torch.Tensor:
    """Rank ``rank``'s function of the gathered rows, one of its own per
    rank, each mixing all rows: ``sum((rank + 1) w * y * mean(y))``."""
    return ((rank + 1) * w * y * y.mean()).sum()


def sweep_kw(L=SWEEP_L, C=SWEEP_C):
    return dict(grid_size=L, lig_grid=12, resolution=1.0, sigma=1.0,
                num_types=C, top_k=SWEEP_TOPK, chunk=SWEEP_CHUNK,
                fft_impl="dft")


def bench_cfg():
    """The shape-mode config of ``run_benchmark_batched``'s check."""
    from deeplocalproteindocking_torch.config import DockConfig
    return DockConfig(grid_size=32, resolution=1.25, num_rotations=8,
                      rotation_chunk=8, top_k=8, nms_rmsd=3.0,
                      rep_features=(8, 8))


def bench_complexes():
    from deeplocalproteindocking_torch.data import synthetic_complex
    return [synthetic_complex(seed=s, n_res_rec=8, n_res_lig=4)
            for s in (30, 31)]


# ---- the port's side, on one rank ----

def _t(x):
    return torch.as_tensor(np.array(x))


def receptor_spectrum(rec_xyz, rec_t, L, C):
    from deeplocalproteindocking_torch.correlate.fft import (
        receptor_transform)
    from deeplocalproteindocking_torch.grids.voxelize import separable_splat
    vol = separable_splat(_t(rec_xyz) + 1.0, _t(rec_t),
                          torch.ones(rec_xyz.shape[-2]), grid_size=L,
                          resolution=1.0, num_types=C)
    return receptor_transform(vol)


def _sweeps(R):
    """The resplat and resample sweeps sharded over a ``(R, 1)`` mesh."""
    from deeplocalproteindocking_torch.parallel import make_mesh
    from deeplocalproteindocking_torch.parallel.sharded_sweep import (
        sharded_dock_sweep, sharded_dock_sweep_resplat)
    from deeplocalproteindocking_torch.structure.so3 import (
        super_fibonacci_rotations)
    mesh = make_mesh(rot=R, device_type="cpu")
    rec_xyz, rec_t, lc, lt, lm, mask = resplat_inputs()
    H = receptor_spectrum(rec_xyz, rec_t, SWEEP_L, SWEEP_C)
    rots = super_fibonacci_rotations(SWEEP_NROT)
    out = {}
    for name, sm in (("resplat", None), ("resplat_masked", _t(mask))):
        out[name] = tuple(sharded_dock_sweep_resplat(
            mesh, H, _t(lc), _t(lt), _t(lm), rots, lambda v: v,
            score_mask=sm, **sweep_kw()))
    rec, lig, A = resample_inputs()
    out["resample"] = tuple(sharded_dock_sweep(
        mesh, _t(rec), _t(lig), rots, _t(A), top_k=16, chunk=SWEEP_CHUNK,
        score_mask=_t(mask[:RS_L, :RS_L, :RS_L])))
    return out


def _dock_batch(rot, batch):
    from deeplocalproteindocking_torch.parallel import make_mesh
    from deeplocalproteindocking_torch.parallel.batch_eval import dock_batch
    from deeplocalproteindocking_torch.structure.so3 import (
        super_fibonacci_rotations)
    xyz, types, lm, masks = batch_inputs()
    H = torch.stack([receptor_spectrum(x, t, BATCH_L, 3)
                     for x, t in zip(xyz, types)])
    return tuple(dock_batch(
        H, _t(xyz), _t(types), _t(lm), super_fibonacci_rotations(BATCH_NROT),
        lambda v: v, grid_size=BATCH_L, lig_grid=12, resolution=1.0,
        sigma=1.0, num_types=3, top_k=4, chunk=2, score_mask=_t(masks),
        fft_impl="dft", mesh=make_mesh(rot, batch, "cpu")))


def _block(R):
    from deeplocalproteindocking_torch.correlate.blockfft import (
        sharded_block_correlate)
    from deeplocalproteindocking_torch.parallel import make_mesh
    rec, lig, A = block_inputs()
    return sharded_block_correlate(make_mesh(rot=R, device_type="cpu"),
                                   _t(rec), _t(lig), _t(A), block=4)


def _all_gather_grad(rank, world):
    from deeplocalproteindocking_torch.parallel import make_mesh
    from deeplocalproteindocking_torch.parallel.collectives import AllGather
    group = make_mesh(rot=world, device_type="cpu").get_group("rot")
    x, w = gather_inputs(world)
    mine = _t(x[rank * GATHER_N:(rank + 1) * GATHER_N]).requires_grad_(True)
    y = AllGather.apply(mine, group)
    gathered_loss(y, _t(w), rank).backward()
    return y.detach(), mine.grad


def _train(tmp, rot, batch, steps=3):
    """``make_parallel_train_step`` on the JAX state and batch the test
    wrote: the loss and params after each step."""
    from deeplocalproteindocking_torch.parallel import make_mesh
    from deeplocalproteindocking_torch.parallel.train_parallel import (
        make_parallel_train_step)
    from deeplocalproteindocking_torch.train import checkpoint
    from deeplocalproteindocking_torch.train.trainer import (
        TrainBatch, Trainer)
    cfg = train_cfg()
    state = checkpoint.load_train_state(tmp)
    with np.load(os.path.join(tmp, "train_batch.npz")) as z:
        tb = TrainBatch(*(torch.from_numpy(z[f]) for f in TrainBatch._fields))
    step = make_parallel_train_step(Trainer(cfg, device="cpu"),
                                    make_mesh(rot, batch, "cpu"))
    out = []
    for _ in range(steps):
        state, metrics = step(state, tb)
        out.append((float(metrics["loss"]), float(metrics["ranking_accuracy"]),
                    {k: v.clone() for k, v in state.params.items()}))
    return out


def train_cfg():
    """``tests/test_parallel.py``'s training config (grid 16, 8 decoys x
    2 complexes) as the port's ``DockConfig``."""
    from deeplocalproteindocking_torch.config import DockConfig
    return DockConfig(grid_size=16, resolution=1.5, rep_features=(4,),
                      num_decoys=8, batch_complexes=2, decoy_max_shift=3.0)


def _run_benchmark(tmp, rank, rot, batch):
    """``run_benchmark_batched`` on a mesh, recording which ranks write
    a result file."""
    from deeplocalproteindocking_torch import evaluation
    from deeplocalproteindocking_torch.parallel import make_mesh
    from deeplocalproteindocking_torch.pipeline import DockingPipeline
    writes = []
    write = evaluation._write_result
    evaluation._write_result = lambda d, res: (writes.append(res["name"]),
                                               write(d, res))
    try:
        pipe = DockingPipeline(bench_cfg(), device="cpu",
                               mesh=make_mesh(rot, batch, "cpu"))
        summary = evaluation.run_benchmark_batched(
            pipe, bench_complexes(), os.path.join(tmp, "bench"),
            group_size=2)
    finally:
        evaluation._write_result = write
    return summary, writes


def ensemble_models():
    """Two receptor models and one ligand model of one complex (the
    second receptor model jiggled), as an NMR ensemble."""
    import dataclasses
    from deeplocalproteindocking_torch.data import synthetic_complex
    c = synthetic_complex(seed=6, n_res_rec=6, n_res_lig=3)
    rng = np.random.default_rng(1)
    moved = dataclasses.replace(c.receptor, coords=(
        c.receptor.coords + rng.normal(0, 0.3, c.receptor.coords.shape)
    ).astype(np.float32))
    return [c.receptor, moved], [c.ligand]


V9P_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "pretrained", "synthetic-v9p")


def ensemble_cfg():
    """The v9p checkpoint's config at grid 32, rank-3 coupling folded
    into the last conv, on the ``dft_fused`` engine: continuous scores,
    so no ties between pairs (``tests/test_torch_batch.py``'s ensemble
    parity config)."""
    from deeplocalproteindocking_torch.config import DockConfig
    with open(os.path.join(V9P_DIR, "best", "config.json")) as f:
        cfg = DockConfig.from_json(f.read())
    return cfg.replace(grid_size=32, num_rotations=6, rotation_chunk=4,
                       top_k=8, coupling_rank=3, lig_grid_size=None,
                       nms_rmsd=3.0)


def v9p_flat() -> dict:
    """The exported v9p params, flat ``"a/b/c" -> np.ndarray``."""
    with np.load(os.path.join(V9P_DIR, "best_params.npz")) as z:
        return {k: z[k] for k in z.files}


def ensemble_pipeline(mesh=None):
    from deeplocalproteindocking_torch import weights
    from deeplocalproteindocking_torch.pipeline import DockingPipeline
    return DockingPipeline(ensemble_cfg(),
                           params=weights.params_from_numpy(v9p_flat()),
                           device="cpu", mesh=mesh)


def _ensemble_and_sequential(tmp, rot, batch):
    """``dock_ensemble`` (2 pairs) and the sequential ``run_benchmark``
    on a ``(rot, batch)`` mesh."""
    from deeplocalproteindocking_torch.evaluation import run_benchmark
    from deeplocalproteindocking_torch.parallel import make_mesh
    from deeplocalproteindocking_torch.pipeline import DockingPipeline
    mesh = make_mesh(rot, batch, "cpu")
    poses, pairs = ensemble_pipeline(mesh).dock_ensemble(*ensemble_models())
    summary = run_benchmark(
        DockingPipeline(bench_cfg(), device="cpu", mesh=mesh),
        bench_complexes()[:1], os.path.join(tmp, f"seq_{rot}_{batch}"))
    return tuple(poses[:5]), pairs, summary


def _errors(tmp):
    """The mesh's errors, each raised on every rank before any
    collective: ``{case: message}``."""
    from deeplocalproteindocking_torch.correlate.blockfft import (
        sharded_block_correlate)
    from deeplocalproteindocking_torch.parallel import make_mesh
    from deeplocalproteindocking_torch.parallel.batch_eval import dock_batch
    from deeplocalproteindocking_torch.parallel.train_parallel import (
        make_parallel_train_step)
    from deeplocalproteindocking_torch.train.trainer import (
        TrainBatch, Trainer)
    out = {}

    def catch(case, fn):
        try:
            fn()
        except (ValueError, RuntimeError) as e:
            out[case] = f"{type(e).__name__}: {e}"

    catch("world", lambda: make_mesh(rot=3, device_type="cpu"))
    mesh22 = make_mesh(2, 2, "cpu")
    xyz, types, lm, _ = batch_inputs(B=3)
    H = torch.zeros((3, BATCH_L, BATCH_L, BATCH_L // 2 + 1, 3),
                    dtype=torch.complex64)
    catch("dock_batch", lambda: dock_batch(
        H, _t(xyz), _t(types), _t(lm), torch.eye(3)[None], lambda v: v,
        grid_size=BATCH_L, lig_grid=12, resolution=1.0, sigma=1.0,
        num_types=3, mesh=mesh22))
    with np.load(os.path.join(tmp, "train_batch.npz")) as z:
        tb = TrainBatch(*(torch.from_numpy(z[f]) for f in TrainBatch._fields))
    trainer = Trainer(train_cfg(), device="cpu")
    state = trainer.init_state()
    catch("train_decoys", lambda: make_parallel_train_step(
        trainer, make_mesh(4, 1, "cpu"))(state, tb._replace(
            decoy_rot=tb.decoy_rot[:, :6], decoy_shift=tb.decoy_shift[:, :6],
            decoy_lrmsd=tb.decoy_lrmsd[:, :6])))
    catch("train_batch", lambda: make_parallel_train_step(
        trainer, make_mesh(1, 4, "cpu"))(state, tb))
    rec, lig, A = block_inputs()
    catch("block", lambda: sharded_block_correlate(
        make_mesh(4, 1, "cpu"), _t(rec), _t(lig), _t(A), block=8))
    return out


def _cli_dock(tmp, rank, argv):
    from deeplocalproteindocking_torch import cli
    cli.main(argv)
    out = os.path.join(argv[argv.index("--out") + 1], "poses.json")
    dist.barrier()
    with open(out) as f:
        return json.load(f)


def read_json_dir(d):
    """``{file name: contents}`` of every ``.json`` file in ``d``."""
    out = {}
    for name in sorted(os.listdir(d)):
        if name.endswith(".json"):
            with open(os.path.join(d, name)) as f:
                out[name] = json.load(f)
    return out


def cli_evaluate(argv):
    """``cli evaluate``: ``(complexes whose result this process wrote,
    {file: contents} of the out dir)``, read after every rank is done."""
    from deeplocalproteindocking_torch import cli, evaluation
    writes = []
    write = evaluation._write_result
    evaluation._write_result = lambda d, res: (writes.append(res["name"]),
                                               write(d, res))
    try:
        cli.main(argv)
    finally:
        evaluation._write_result = write
    if dist.is_initialized():
        dist.barrier()
    return writes, read_json_dir(argv[argv.index("--out") + 1])


def cli_screen(argv):
    """``cli screen``: ``screen.json``, read after every rank is done."""
    from deeplocalproteindocking_torch import cli
    cli.main(argv)
    if dist.is_initialized():
        dist.barrier()
    with open(os.path.join(argv[argv.index("--out") + 1],
                           "screen.json")) as f:
        return json.load(f)


TRAIN_ARGV = ["train", "--synthetic", "2", "--grid-size", "32",
              "--resolution", "2.0", "--ckpt-every", "1", "--mine-every",
              "1", "--mine-rotations", "8", "--device", "cpu"]


def cli_train(ckpt_dir, mesh_rot):
    """``cli train`` to step 1, then ``--resume`` to step 2, mining hard
    negatives before each step, with a narrow model and 6 decoys (no
    flag sets them): ``(steps this process checkpointed, the metrics
    log paths it opened, the params after its last step)``."""
    from deeplocalproteindocking_torch import cli
    from deeplocalproteindocking_torch.train.trainer import Trainer
    from deeplocalproteindocking_torch.utils.logging import MetricsLogger
    saved, logs, last = [], [], {}
    build, save = cli._build_config, Trainer.save
    apply, init = Trainer.apply_gradients, MetricsLogger.__init__

    def spy_save(self, d, state):
        saved.append(state.step)
        save(self, d, state)

    def spy_apply(self, state, grads):
        new = apply(self, state, grads)
        last.update({k: v.clone() for k, v in new.params.items()})
        return new

    def spy_init(self, path=None, echo=True):
        logs.append(path)
        init(self, path, echo)

    cli._build_config = lambda args: build(args).replace(
        rep_features=(4,), num_decoys=6)
    Trainer.save, Trainer.apply_gradients = spy_save, spy_apply
    MetricsLogger.__init__ = spy_init
    try:
        argv = TRAIN_ARGV + ["--ckpt-dir", ckpt_dir, "--mesh-rot",
                             str(mesh_rot)]
        cli.main(argv + ["--steps", "1"])
        cli.main(argv + ["--steps", "2", "--resume"])
    finally:
        cli._build_config, Trainer.save = build, save
        Trainer.apply_gradients, MetricsLogger.__init__ = apply, init
    return saved, logs, last


def job_world4(rank, tmp):
    return dict(sweeps=_sweeps(4), dock_batch=_dock_batch(2, 2),
                block=_block(4), all_gather=_all_gather_grad(rank, 4),
                train=_train(tmp, 2, 2), errors=_errors(tmp),
                run_benchmark=_run_benchmark(tmp, rank, 2, 2))


def job_world2(rank, tmp):
    with open(os.path.join(tmp, "cli_argv.json")) as f:
        argv = json.load(f)
    return dict(sweeps=_sweeps(2), dock_batch_rot=_dock_batch(2, 1),
                dock_batch_batch=_dock_batch(1, 2), block=_block(2),
                cli=_cli_dock(tmp, rank, argv["dock"]),
                cli_evaluate=cli_evaluate(argv["evaluate"]),
                cli_screen=cli_screen(argv["screen"]),
                cli_train=cli_train(os.path.join(tmp, "train"), 2),
                ensemble={(r, b): _ensemble_and_sequential(tmp, r, b)
                          for r, b in ((2, 1), (1, 2))})


JOBS = {"world4": job_world4, "world2": job_world2}


# ---- the harness ----

def rank_main(rank, world, job, tmp):
    torch.set_num_threads(1)
    from deeplocalproteindocking_torch.parallel.mesh import init_distributed
    init_distributed("cpu", rank=rank, world_size=world,
                     init_method="file://" + os.path.join(tmp, job + ".store"))
    try:
        torch.save(JOBS[job](rank, tmp),
                   os.path.join(tmp, f"{job}_{rank}.pt"))
    except BaseException:
        with open(os.path.join(tmp, f"{job}_{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


class Ranks:
    """``world`` spawned gloo ranks running ``job``; :meth:`result`
    waits for them."""

    def __init__(self, job: str, world: int, tmp: str):
        self.job, self.world, self.tmp = job, world, tmp
        ctx = mp.get_context("spawn")
        self.procs = [ctx.Process(target=rank_main,
                                  args=(r, world, job, tmp))
                      for r in range(world)]
        for p in self.procs:
            p.start()
        self.deadline = time.monotonic() + JOB_TIMEOUT_S
        self._results = None

    def result(self) -> list:
        """Each rank's results, in rank order.  Raises with the first
        rank's traceback when a rank fails, and stops every rank that
        outlives ``JOB_TIMEOUT_S``."""
        if self._results is None:
            for p in self.procs:
                p.join(max(1.0, self.deadline - time.monotonic()))
            hung = [r for r, p in enumerate(self.procs) if p.is_alive()]
            self.stop()
            for r in range(self.world):
                path = os.path.join(self.tmp, f"{self.job}_{r}.err")
                if os.path.exists(path):
                    with open(path) as f:
                        raise RuntimeError(f"{self.job} rank {r}:\n"
                                           f"{f.read()}")
            if hung or any(p.exitcode for p in self.procs):
                raise RuntimeError(
                    f"{self.job}: ranks {hung} hung, exit codes "
                    f"{[p.exitcode for p in self.procs]}")
            self._results = [
                torch.load(os.path.join(self.tmp, f"{self.job}_{r}.pt"),
                           weights_only=False) for r in range(self.world)]
        return self._results

    def stop(self):
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join()
