"""Faults planted in the program, to show that the comparison which
decides ``correct`` catches them (``tests/test_dockbench_faults.py``)
and to read a training cell's numbers under each (``readings.py``).

``plant(kind, name)`` patches the program and returns a function that
undoes the patch.  Docking (``dock``):

* ``half``: half of each chunk's rotations left out (their ligand
  representations zeroed, so they never score);
* ``unchanged``: the sweep's carry never moves past its first chunk;
* ``altered``: the served top pose moved by three voxels where it is
  produced (its translation moved with it, its score kept);
* ``exchange``: on a mesh, the top-K merge across ranks left out (each
  rank serves its own slice's top-K).

Training (``train``):

* ``half``: half of the batch left out, the mean taken over the rest;
* ``unchanged``: a step that returns the state it was given;
* ``altered``: one answer altered where it is produced (the first
  decoy's score negated).
"""
from __future__ import annotations


def _patch(owner, attr, make):
    orig = getattr(owner, attr)
    setattr(owner, attr, make(orig))
    return lambda: setattr(owner, attr, orig)


def plant(kind: str, name: str):
    from deeplocalproteindocking_torch import pipeline
    from deeplocalproteindocking_torch.train import trainer
    if kind == "dock" and name == "half":
        def make(orig):
            def sweep(H, lc, lt, lm, rotations, rep_fn, **kw):
                def halved(vols):
                    reps = rep_fn(vols)
                    return reps.index_fill(
                        0, _second_half(reps.shape[0], reps.device), 0.0)
                return orig(H, lc, lt, lm, rotations, halved, **kw)
            return sweep
        return _patch(pipeline, "dock_sweep_resplat", make)
    if kind == "dock" and name == "unchanged":
        def make(orig):
            def sweep(H, lc, lt, lm, rotations, rep_fn, **kw):
                return orig(H, lc, lt, lm, rotations[:kw["chunk"]], rep_fn,
                            **kw)
            return sweep
        return _patch(pipeline, "dock_sweep_resplat", make)
    if kind == "dock" and name == "altered":
        def make(orig):
            def dock(self, *a, **kw):
                poses = orig(self, *a, **kw)
                poses.shifts[0, 0] += 3
                poses.translations[0, 0] += 3 * self.config.resolution
                return poses
            return dock
        return _patch(pipeline.DockingPipeline, "dock", make)
    if kind == "dock" and name == "exchange":
        from deeplocalproteindocking_torch.parallel import sharded_sweep

        def make(orig):
            def merge(mesh, res, base, n_rot, top_k):
                import torch
                rot_idx = res.rot_idx + base
                valid = rot_idx < n_rot
                scores = torch.where(valid, res.scores,
                                     torch.tensor(float("-inf"),
                                                  device=rot_idx.device))
                return type(res)(scores, torch.where(valid, rot_idx, 0),
                                 res.shifts)
            return merge
        return _patch(sharded_sweep, "merge_rot_shards", make)
    if kind == "train" and name == "half":
        def make(orig):
            def loss_fn(self, params, batch, complexes=None, **kw):
                if complexes is None:
                    complexes = range(max(1, batch.rec_coords.shape[0] // 2))
                return orig(self, params, batch, complexes, **kw)
            return loss_fn
        return _patch(trainer.Trainer, "loss_fn", make)
    if kind == "train" and name == "unchanged":
        def make(orig):
            def apply_gradients(self, state, grads):
                return state._replace(step=state.step + 1)
            return apply_gradients
        return _patch(trainer.Trainer, "apply_gradients", make)
    if kind == "train" and name == "altered":
        def make(orig):
            def complex_scores(*a, **kw):
                s = orig(*a, **kw)
                return s * _flip_first(s)
            return complex_scores
        return _patch(trainer, "complex_scores", make)
    raise ValueError(f"no fault {name!r} for {kind!r} cells")


def _second_half(n, device):
    import torch
    return torch.arange(n // 2, n, device=device)


def _flip_first(s):
    import torch
    f = torch.ones_like(s)
    f[0] = -1.0
    return f
