"""Docking cells: full ``DockingPipeline.dock`` requests, back to back
from one client (closed loop), on complexes drawn from a committed pool.

Traffic parameters (``traffic/<name>.json``): ``pool`` (a file under
``data/``), ``warmup_rotations`` (the rotations of the one warm-up
request of set-up, which has every shape of a full request), and
``trace_requests`` (how many requests of the window the traced run
profiles with the probes and the host's operations) and
``lean_requests`` (how many it runs untraced before those, for the MFU,
and then profiles with the device's activity alone, for the device's
idle share).
"""
from __future__ import annotations

import gc
import json
import sys

import numpy as np
import torch

from lib import bench, trace
from reference import dock as ref_dock, geometry


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def structure(c: dict, side: str):
    from deeplocalproteindocking_torch.structure.pdb import Structure
    n = len(c[f"{side}_xyz"])
    return Structure(coords=np.asarray(c[f"{side}_xyz"], np.float32),
                     atom_names=np.full(n, "X", dtype="<U4"),
                     res_names=np.full(n, "UNK", dtype="<U3"),
                     res_ids=c[f"{side}_res"],
                     chain_ids=np.full(n, "A" if side == "rec" else "B",
                                       dtype="<U1"),
                     types=c[f"{side}_types"])


class Dock:
    """One docking cell's program, set up once: the pipeline with the
    configuration's weights and the pool's complexes; ``mesh`` the
    ``(rot, batch)`` mesh this rank belongs to, or None."""

    def __init__(self, cell: dict, device: str, mesh=None):
        from deeplocalproteindocking_torch import pipeline, weights
        from deeplocalproteindocking_torch.config import DockConfig
        self.cell = cell
        self.device = torch.device(device)
        self.cfgd = cell["config"]["dock_config"]
        self.cfg = DockConfig.from_json(json.dumps(self.cfgd))
        self.flat = bench.weights_arrays(cell["config"])
        self.pipe = pipeline.DockingPipeline(
            self.cfg, params=weights.params_from_numpy(self.flat),
            device=self.device, mesh=mesh)
        self.pool = bench.load_pool(cell["traffic"]["pool"])
        self.structs = [(structure(c, "rec"), structure(c, "lig"))
                        for c in self.pool]
        rf = geometry.receptive_field(self.cfgd["rep_features"],
                                      self.cfgd["rep_kernel"],
                                      self.cfgd["shape_prior"])
        self.boxes = []
        for c in self.pool:
            lig = geometry.centered(c["lig_xyz"])[c["lig_types"] >= 0]
            self.boxes.append(self.cfgd["lig_grid_size"] or
                              geometry.ligand_box(
                                  lig, self.cfgd["resolution"],
                                  self.cfgd["sigma"], rf,
                                  self.cfgd["grid_size"]))

    def warm_up(self, seed: int) -> None:
        """One request of every shape a request has, at fewer rotations."""
        first = bench.order(seed, len(self.pool), 1)[0]
        n = self.cell["traffic"]["warmup_rotations"]
        self.pipe.dock(*self.structs[first],
                       rotations=self.pipe.rotation_set()[:n])
        _sync(self.device)

    def window(self, seed: int, seconds: float, traced: bool = False,
               go=bool):
        """Requests back to back for ``seconds``; returns ``(units,
        served poses, window_s, failed, trace or None)``."""
        seq = bench.order(seed, len(self.pool), 64)

        def request(n):
            i = seq[n % len(seq)]
            try:
                poses = self.pipe.dock(*self.structs[i])
            except Exception as e:     # counted, and judged below
                print(f"request on pool complex {i} failed: {e!r}",
                      file=sys.stderr)
                poses = None
            return dict(pool_index=i, rotations=self.cfg.num_rotations,
                        lig_box=self.boxes[i], done=poses is not None,
                        poses=poses)
        units, window_s, tr = trace.run_window(
            request, seconds, traced, self.cell["traffic"]["trace_requests"],
            self.cfgd, self.device, go, "request",
            self.cell["traffic"].get("lean_requests", 0))
        served = [u.pop("poses") for u in units]
        return (units, served, window_s, sum(not u["done"] for u in units),
                tr)

    @staticmethod
    def end_to_end(units, window_s) -> dict:
        done = sum(u["rotations"] for u in units if u["done"])
        return {"rot_per_s": done / window_s}

    def free(self) -> None:
        del self.pipe
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, seed: int, units, served, control=None) -> dict:
        """The reference's numbers over a sample, drawn from the seed, of
        the finished requests (``limits.json``: ``n_check`` requests,
        ``n_sample`` other rotations each)."""
        lim = self.cell["limits"]
        done = [k for k, u in enumerate(units) if u["done"]]
        rng = np.random.default_rng([seed, 7])
        pick = rng.choice(len(done), size=min(lim["n_check"], len(done)),
                          replace=False) if done else []
        agg = {"score_err": 0.0, "missed": 0, "pose_faults": 0}
        if control is not None:
            agg.update(peak_gap=0.0, control_score_err=0.0,
                       control_peak_gap=0.0)
        if not done:
            return {k: float("inf") for k in agg}
        for j in sorted(pick):
            k = done[j]
            c = self.pool[units[k]["pool_index"]]
            p = served[k]
            out = ref_dock.check_request(
                self.cfgd, self.flat, c["rec_xyz"], c["rec_types"],
                c["lig_xyz"], c["lig_types"],
                dict(scores=p.scores, rotations=p.rotations,
                     translations=p.translations, rot_idx=p.rot_idx,
                     shifts=p.shifts),
                n_sample=lim["n_sample"],
                rng=np.random.default_rng([seed, 11, k]),
                score_limit=lim["limits"]["score_err"],
                device=self.device, control=control)
            for f in out.get("faults", []):
                print(f"request {k}: {f}", file=sys.stderr)
            for key in agg:
                agg[key] = (agg[key] + out[key]
                            if key in ("missed", "pose_faults")
                            else max(agg[key], out[key]))
        return agg

