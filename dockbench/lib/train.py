"""Training cells: ``Trainer.train_step`` back to back on batches from
``make_training_batch``, from the configuration's weights.

Traffic parameters (``traffic/<name>.json``): ``pool`` (a file under
``data/``), ``mine_rotations`` (the rotations of the mining sweep that
fills the hard-negative buffer in set-up), ``checked_steps`` (the first
steps, run in set-up through the window's own call, that the reference
follows), ``trace_steps`` (how many steps of the window the traced
run profiles with the probes and the host's operations) and
``lean_steps`` (how many it runs untraced before those, for the MFU,
and then profiles with the device's activity alone, for the device's
idle share).
"""
from __future__ import annotations

import gc
import json

import numpy as np
import torch

from lib import bench, trace
from lib.dock import _sync, structure
from reference import train as ref_train


def program_name(flax_key: str) -> str:
    """``representation/cnn/conv0/kernel`` -> the program's parameter
    name ``representation.cnn.convs.0.weight``."""
    if flax_key == "coupling":
        return "coupling"
    *prefix, conv, kind = flax_key.split("/")
    return ".".join(prefix + ["convs", conv[len("conv"):],
                              "weight" if kind == "kernel" else "bias"])


class Train:
    """One training cell's program: the trainer, the pool's complexes and
    the mined buffer (set-up), then per seed one training state driven
    through its first steps (``warm_up``) and handed to the window."""

    def __init__(self, cell: dict, device: str, mesh=None):
        from deeplocalproteindocking_torch import weights
        from deeplocalproteindocking_torch.config import DockConfig
        from deeplocalproteindocking_torch.data.benchmark import Complex
        from deeplocalproteindocking_torch.train import mining, trainer
        self.cell = cell
        self.device = torch.device(device)
        self.cfgd = cell["config"]["dock_config"]
        self.cfg = DockConfig.from_json(json.dumps(self.cfgd))
        self.flat = bench.weights_arrays(cell["config"])
        self.params0 = weights.params_from_numpy(self.flat)
        self.pool = bench.load_pool(cell["traffic"]["pool"])
        self.complexes = [Complex(name=f"pool{c['seed']}",
                                  receptor=structure(c, "rec"),
                                  ligand=structure(c, "lig"))
                          for c in self.pool]
        self.trainer = trainer.Trainer(self.cfg, device=self.device)
        model = self.trainer.bind({k: v.to(self.device)
                                   for k, v in self.params0.items()})
        self.mined = mining.mine_hard_negatives(
            model, self.cfg, self.complexes,
            n_rotations=cell["traffic"]["mine_rotations"])
        _sync(self.device)

    def step(self):
        """One step of the window's own call and feed; the loss on the
        host."""
        from deeplocalproteindocking_torch.train import data_gen
        batch = data_gen.make_training_batch(
            self.gen, self.complexes, self.cfg, mined=self.mined,
            device=self.device)
        self.state, m = self.trainer.train_step(self.state, batch)
        return float(m["loss"]), batch

    def warm_up(self, seed: int) -> None:
        """A fresh state from the weights (zero moments) and the data
        generator seeded from ``seed``, driven through the checked steps:
        their losses, batches, the moments after the first and the
        parameters after the last are kept for the reference."""
        from deeplocalproteindocking_torch.train.trainer import TrainState
        p = {k: v.to(self.device) for k, v in self.params0.items()}
        opt = {"mu": {k: torch.zeros_like(v) for k, v in p.items()},
               "nu": {k: torch.zeros_like(v) for k, v in p.items()},
               "count": 0}
        self.state = TrainState(p, opt, 0, None)
        self.gen = torch.Generator().manual_seed(seed)
        self.kept = {"losses": [], "batches": []}
        for i in range(self.cell["traffic"]["checked_steps"]):
            loss, batch = self.step()
            self.kept["losses"].append(loss)
            self.kept["batches"].append(
                {k: v.detach().cpu() for k, v in batch._asdict().items()})
            if i == 0:
                self.kept["mu1"] = {k: v.detach().cpu() for k, v in
                                    self.state.opt_state["mu"].items()}
        self.kept["params"] = {k: v.detach().cpu()
                               for k, v in self.state.params.items()}
        _sync(self.device)

    def window(self, seed: int, seconds: float, traced: bool = False,
               go=bool):
        """Steps back to back for ``seconds``, continuing the state and
        feed of ``warm_up``; returns ``(units, None, window_s, failed,
        trace or None)``."""
        def step(n):
            loss, _ = self.step()
            return dict(loss=loss, done=bool(np.isfinite(loss)),
                        decoys=self.cfg.num_decoys,
                        complexes=self.cfg.batch_complexes)
        units, window_s, tr = trace.run_window(
            step, seconds, traced, self.cell["traffic"]["trace_steps"],
            self.cfgd, self.device, go, "step",
            self.cell["traffic"].get("lean_steps", 0))
        return (units, None, window_s, sum(not u["done"] for u in units),
                tr)

    @staticmethod
    def end_to_end(units, window_s) -> dict:
        return {"train_step_s": window_s / max(len(units), 1)}

    def free(self) -> None:
        del self.trainer, self.state, self.mined
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, seed: int, units, served, control=None) -> dict:
        names = {program_name(k): k for k in self.flat}
        return ref_train.compare(
            self.cfgd, self.flat, self.kept, names, device=self.device,
            control=control)
