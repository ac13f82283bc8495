"""Multi-device train step: complexes x decoys sharded over the mesh.

Port of ``deeplocalproteindocking_tpu/parallel/train_parallel.py``.  Two
mesh dimensions are used:

* ``batch`` -- the complexes of the train batch (data parallelism);
* ``rot``   -- each complex's decoy set: every rank scores its slice of
  the decoys, the score vectors are gathered (``collectives.AllGather``)
  so the pairwise ranking hinge sees the full decoy set, and gradients
  flow back through the rank's own slice.

The local loss is the mean over the rank's complexes; every gradient and
the loss are summed over all ranks and divided by the world size (JAX's
``pmean`` over ``("rot", "batch")``).  Over ``rot`` the sum collects the
disjoint per-decoy paths while the division cancels the R-fold
replication of the gather's backward (every rot rank differentiates the
same full loss).  Every rank then applies the port's AdamW
(``Trainer.apply_gradients``) to identical gradients, so the params stay
identical on every rank.  The model is replicated; there is no tensor
parallelism.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from deeplocalproteindocking_torch.parallel.collectives import AllGather
from deeplocalproteindocking_torch.parallel.sharded_sweep import dim_size
from deeplocalproteindocking_torch.train.trainer import (
    TrainBatch, Trainer, TrainState)


class ParallelTrainStep:
    """``step(state, batch) -> (state, {"loss", "ranking_accuracy"})``
    over a mesh (see :func:`make_parallel_train_step`)."""

    def __init__(self, trainer: Trainer, mesh):
        self.trainer = trainer
        self.nb, self.R = dim_size(mesh, "batch"), dim_size(mesh, "rot")
        self.j = mesh.get_local_rank("batch")
        self.r = mesh.get_local_rank("rot")
        self.rot_group = mesh.get_group("rot")

    def value_and_grad(self, params, batch: TrainBatch):
        """``(loss, accuracy, grads)`` of the whole batch, the same on
        every rank: this rank's tile through ``Trainer.value_and_grad``
        (its complexes, its decoys, the scores gathered over ``rot``),
        then the values and gradients summed over all ranks in one
        all-reduce and divided by the world size."""
        B, D = batch.decoy_rot.shape[:2]
        if B % self.nb:
            raise ValueError(f"parallel train step: batch of {B} complexes "
                             f"does not divide over mesh batch={self.nb}")
        if D % self.R:
            raise ValueError(f"parallel train step: {D} decoys do not "
                             f"divide over mesh rot={self.R}")
        b, d = B // self.nb, D // self.R
        loss, acc, grads = self.trainer.value_and_grad(
            params, batch, complexes=range(self.j * b, (self.j + 1) * b),
            decoys=slice(self.r * d, (self.r + 1) * d),
            gather=lambda s: AllGather.apply(s, self.rot_group))
        flat = torch.cat([g.reshape(-1) for g in grads.values()]
                         + [loss[None], acc[None]])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        flat = flat / (self.nb * self.R)
        out, at = {}, 0
        for name, g in grads.items():
            out[name] = flat[at:at + g.numel()].reshape(g.shape)
            at += g.numel()
        return flat[-2], flat[-1], out

    def __call__(self, state: TrainState, batch: TrainBatch):
        loss, acc, grads = self.value_and_grad(state.params, batch)
        return (self.trainer.apply_gradients(state, grads),
                {"loss": loss, "ranking_accuracy": acc})


def make_parallel_train_step(trainer: Trainer, mesh) -> ParallelTrainStep:
    """The train step of ``trainer`` over ``mesh``: every rank passes the
    same ``TrainState`` and the same whole ``TrainBatch`` (on the
    trainer's device) and takes its own tile, complexes over ``batch``,
    decoys over ``rot``.  The batch size must divide by the ``batch``
    size and the decoy count by ``rot``."""
    return ParallelTrainStep(trainer, mesh)
