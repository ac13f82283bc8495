"""Persistent docking service: receptor cache + many ligand queries.

Port of ``deeplocalproteindocking_tpu/serving.py``.  In screening one
receptor is docked against many ligands, and ``DockingPipeline.dock``
would redo the receptor half (splat, CNN, coupled spectrum) on every
call.  ``DockingService`` computes that half once per receptor and keeps
the engine tuple ``(impl, H, rep_fn)`` in an LRU cache keyed by a hash
of the receptor's coordinates and types, the scoring-geometry fields of
the config and a fingerprint of the parameters, so a repeat query pays
only the ligand side (per-rotation splat + CNN + correlation).

Cached tensors are built under ``torch.no_grad`` on the service's
device, so ``DockingPipeline.refine`` may reuse them.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from deeplocalproteindocking_torch.config import DockConfig
from deeplocalproteindocking_torch.pipeline import (
    DockingPipeline, PoseSet, shape_complementarity_reps)
from deeplocalproteindocking_torch.structure.pdb import Structure

# Config fields that change receptor-side scoring; sweep-control knobs
# (rotations, top_k, chunk, ...) reuse the same spectrum.
_GEOM_FIELDS = ("grid_size", "resolution", "sigma", "num_atom_types",
                "rep_features", "rep_kernel", "shape_prior",
                "compute_dtype")


@dataclasses.dataclass
class _Entry:
    rec_c: Structure
    rep_rec: torch.Tensor
    coupling: Optional[torch.Tensor]
    engine: tuple   # (impl, H, rep_fn) — DockingPipeline._engine_parts


class DockingService:
    """One receptor prepared once, many ligand queries, on ``device``.

    >>> svc = DockingService(cfg, params, device="cuda")
    >>> svc.dock(rec, lig1); svc.dock(rec, lig2)   # receptor half once

    With a ``mesh`` the dock stage shards as ``DockingPipeline.dock``
    does; ``rescore`` runs replicated on every rank.
    """

    def __init__(self, config: DockConfig, params: Optional[dict] = None,
                 device: torch.device | str = "cuda", capacity: int = 8,
                 mesh=None):
        self.pipeline = DockingPipeline(config=config, params=params,
                                        device=device, mesh=mesh)
        self.capacity = capacity
        self._cache: "OrderedDict[str, _Entry]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    # ---- keys ----
    def _params_fingerprint(self) -> str:
        p = self.pipeline.params
        if p is None:
            return "shape"
        h = hashlib.sha256()
        for name, t in p.items():
            h.update(name.encode())
            h.update(t.detach().to("cpu", torch.float32).numpy().tobytes())
        return h.hexdigest()[:16]

    def receptor_key(self, rec: Structure) -> str:
        cfg = self.pipeline.config
        h = hashlib.sha256()
        t = rec.typed()
        h.update(np.ascontiguousarray(t.coords).tobytes())
        h.update(np.ascontiguousarray(t.types).tobytes())
        h.update(json.dumps([getattr(cfg, f) for f in _GEOM_FIELDS],
                            default=str).encode())
        h.update(self._params_fingerprint().encode())
        return h.hexdigest()

    # ---- the cached receptor half ----
    def prepare_receptor(self, rec: Structure) -> str:
        """Voxelize + represent the receptor; returns the cache key."""
        key = self.receptor_key(rec)
        if key in self._cache:
            self._cache.move_to_end(key)
            self.hits += 1
            return key
        self.misses += 1
        pipe = self.pipeline
        rec_c, rep_rec, coupling = pipe._receptor_half(rec)
        self._cache[key] = _Entry(rec_c=rec_c, rep_rec=rep_rec,
                                  coupling=coupling,
                                  engine=pipe._engine_parts(rep_rec,
                                                            coupling))
        while len(self._cache) > self.capacity:
            self._cache.popitem(last=False)       # LRU eviction
        return key

    def _ligand_half(self, lig: Structure):
        pipe = self.pipeline
        lig_c = lig.centered()
        if len(lig_c.typed()) == 0:
            raise ValueError("no typed atoms in ligand")
        with torch.no_grad():
            lig_vol = pipe.voxelize(lig_c)
            if pipe.params is None:
                rep_lig, _ = shape_complementarity_reps(lig_vol)
            else:
                rep_lig = pipe.model.represent(lig_vol)
        return lig_c, rep_lig

    def cached(self, rec: Structure, lig: Structure):
        """``(prep, engine)`` for a query: the receptor half from the
        cache (a hit or a miss counts), the ligand half fresh.  The pair
        any ``DockingPipeline`` stage takes as ``prep=``/``engine=``."""
        e = self._cache[self.prepare_receptor(rec)]
        lig_c, rep_lig = self._ligand_half(lig)
        return (e.rec_c, lig_c, e.rep_rec, rep_lig, e.coupling), e.engine

    # ---- queries ----
    def dock(self, rec: Structure, lig: Structure, **kw) -> PoseSet:
        """``DockingPipeline.dock`` with the receptor half from cache."""
        prep, engine = self.cached(rec, lig)
        return self.pipeline.dock(rec, lig, prep=prep, engine=engine, **kw)

    def rescore(self, rec: Structure, lig: Structure, poses: PoseSet,
                **kw) -> PoseSet:
        """``DockingPipeline.rescore`` with the receptor half from cache."""
        prep, engine = self.cached(rec, lig)
        return self.pipeline.rescore(rec, lig, poses, prep=prep,
                                     engine=engine, **kw)

    @property
    def stats(self) -> dict:
        return dict(entries=len(self._cache), hits=self.hits,
                    misses=self.misses)
