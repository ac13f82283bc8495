"""Representation training: the ranking-loss step, AdamW, checkpoints.

Port of ``deeplocalproteindocking_tpu/train/trainer.py``.  One step is
the gradient of the mean over a batch of complexes of the pairwise
ranking hinge (``train/losses.py``) over each complex's decoy scores
(``train/scoring_path.complex_scores``: receptor splat -> CNN -> coupled
spectrum, each decoy's splat -> CNN -> continuous score), then one
optimizer update with optax's semantics:

* ``scale_by_adam(b1=0.9, b2=0.999, eps=1e-8)``, then, when
  ``weight_decay > 0``, decayed weights on every parameter (the
  coupling included), then the learning rate at the update count before
  the step: ``torch.optim.AdamW`` with the rate set from
  :func:`learning_rate` each step;
* the rate: ``cosine_decay_schedule(lr, lr_decay_steps, alpha=0.1)``,
  flat at ``0.1 lr`` past ``lr_decay_steps`` (or constant when that is
  0).

A complex's D decoys are scored in one call, not one at a time under
remat as in the JAX package.  ``TrainState`` is a value: a step loads
it into the trainer's model and optimizer and returns a new one.
Checkpoints are ``torch.save`` files in ``step_%08d/`` directories plus
``config.json``, the JAX trainer's layout; :meth:`Trainer.restore` also
reads the JAX trainer's Orbax steps (``train/checkpoint.py``).
"""
from __future__ import annotations

import math
import os
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from deeplocalproteindocking_torch.config import DockConfig
from deeplocalproteindocking_torch.models.scoring import ScoringModel
from deeplocalproteindocking_torch.train.losses import (
    pairwise_ranking_accuracy, ranking_hinge_loss)
from deeplocalproteindocking_torch.train.scoring_path import complex_scores
from deeplocalproteindocking_torch.utils.profiling import span

_BETAS, _EPS, _ALPHA = (0.9, 0.999), 1e-8, 0.1


class TrainBatch(NamedTuple):
    """Padded batch of complexes with their decoy sets."""
    rec_coords: torch.Tensor   # [B, N, 3]
    rec_types: torch.Tensor    # [B, N]
    rec_mask: torch.Tensor     # [B, N]
    lig_coords: torch.Tensor   # [B, M, 3]  (centered)
    lig_types: torch.Tensor    # [B, M]
    lig_mask: torch.Tensor     # [B, M]
    decoy_rot: torch.Tensor    # [B, D, 3, 3]
    decoy_shift: torch.Tensor  # [B, D, 3] voxel shifts, float32
    decoy_lrmsd: torch.Tensor  # [B, D]

    def to(self, device) -> "TrainBatch":
        return TrainBatch(*(t.to(device) for t in self))


class TrainState(NamedTuple):
    """``params``: the ``ScoringModel`` state_dict; ``opt_state``: Adam's
    moments by parameter name and the update count, ``{"mu": {...},
    "nu": {...}, "count": int}`` (optax's ``ScaleByAdamState``); ``rng``:
    the data generator's state (``torch.Generator.get_state()``), or
    None."""
    params: Dict[str, torch.Tensor]
    opt_state: dict
    step: int
    rng: Optional[torch.Tensor]

    def to(self, device) -> "TrainState":
        """Params and moments on ``device`` (the generator state stays a
        CPU tensor)."""
        def dev(d):
            return {k: v.to(device) for k, v in d.items()}
        opt = self.opt_state
        return self._replace(params=dev(self.params), opt_state={
            "mu": dev(opt["mu"]), "nu": dev(opt["nu"]),
            "count": int(opt["count"])})


def learning_rate(cfg: DockConfig) -> Callable[[int], float]:
    """The rate at update count ``t``: optax's
    ``cosine_decay_schedule(cfg.learning_rate, cfg.lr_decay_steps,
    alpha=0.1)``, or constant when ``lr_decay_steps`` is 0."""
    lr, T = cfg.learning_rate, cfg.lr_decay_steps
    if T <= 0:
        return lambda t: lr

    def cosine(t: int) -> float:
        decay = 0.5 * (1.0 + math.cos(math.pi * min(t, T) / T))
        return lr * ((1.0 - _ALPHA) * decay + _ALPHA)
    return cosine


class Trainer:
    """A float32 ``ScoringModel`` with gradients and its optimizer on
    ``device``."""

    def __init__(self, config: DockConfig,
                 device: torch.device | str = "cuda"):
        self.config = config
        self.device = torch.device(device)
        self.model = self._new_model().to(self.device)
        self.lr = learning_rate(config)
        self.optimizer = torch.optim.AdamW(
            self.model.parameters(), lr=self.lr(0), betas=_BETAS, eps=_EPS,
            weight_decay=config.weight_decay)

    def _new_model(self) -> ScoringModel:
        cfg = self.config
        return ScoringModel(features=cfg.rep_features, kernel=cfg.rep_kernel,
                            shape_prior=cfg.shape_prior,
                            in_channels=cfg.num_atom_types)

    # ---- setup ----
    def init_state(self, seed: Optional[int] = None) -> TrainState:
        """Flax-style weights drawn from a CPU generator seeded with
        ``seed`` (default ``config.seed``), zero moments; the generator
        then carries on as the data generator."""
        g = torch.Generator().manual_seed(
            self.config.seed if seed is None else seed)
        model = self._new_model()
        model.reset_parameters(g)
        params = {k: v.to(self.device) for k, v in model.state_dict().items()}
        opt = {"mu": {k: torch.zeros_like(v) for k, v in params.items()},
               "nu": {k: torch.zeros_like(v) for k, v in params.items()},
               "count": 0}
        return TrainState(params, opt, 0, g.get_state())

    def bind(self, params: Dict[str, torch.Tensor]) -> ScoringModel:
        """The trainer's model holding ``params`` (copied in)."""
        with torch.no_grad():
            for name, p in self.model.named_parameters():
                p.copy_(params[name])
        return self.model

    # ---- forward/loss ----
    def loss_fn(self, params: Dict[str, torch.Tensor], batch: TrainBatch,
                complexes: Optional[range] = None,
                decoys: slice = slice(None),
                gather: Optional[Callable] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mean hinge loss, mean ranking accuracy) over the batch's
        complexes (or ``complexes`` of them); the loss carries the graph
        to the model's parameters.  A mesh's train step scores only
        ``decoys`` of each decoy set and passes ``gather``, which brings
        the whole set's scores together before the hinge."""
        cfg = self.config
        model = self.bind(params)
        if complexes is None:
            complexes = range(batch.rec_coords.shape[0])
        losses, accs = [], []
        for b in complexes:
            scores = complex_scores(model, cfg, *(f[b] for f in batch[:6]),
                                    batch.decoy_rot[b, decoys],
                                    batch.decoy_shift[b, decoys])
            if gather is not None:
                scores = gather(scores)
            lrmsd = batch.decoy_lrmsd[b]
            losses.append(ranking_hinge_loss(
                scores, lrmsd, near_native_rmsd=cfg.near_native_rmsd,
                margin=cfg.hinge_margin))
            accs.append(pairwise_ranking_accuracy(
                scores.detach(), lrmsd, cfg.near_native_rmsd))
        return torch.stack(losses).mean(), torch.stack(accs).mean()

    def value_and_grad(self, params: Dict[str, torch.Tensor],
                       batch: TrainBatch, **shard):
        """``(loss, accuracy, grads)``, grads by parameter name;
        ``shard`` goes to :meth:`loss_fn`."""
        names, ps = zip(*self.model.named_parameters())
        with torch.enable_grad():
            with span("train.forward"):
                loss, acc = self.loss_fn(params, batch, **shard)
            # Autograd runs a CUDA backward on its own device thread, so
            # the profiler puts its operators outside this range; the
            # span's host time is the whole backward.
            with span("train.backward"):
                grads = torch.autograd.grad(loss, ps)
        return loss.detach(), acc, dict(zip(names, grads))

    def apply_gradients(self, state: TrainState,
                        grads: Dict[str, torch.Tensor]) -> TrainState:
        """One optimizer update of ``state`` by ``grads``."""
        with span("train.optimizer"):
            self.bind(state.params)
            count = state.opt_state["count"]
            named = list(self.model.named_parameters())
            for name, p in named:
                p.grad = grads[name].detach()
                self.optimizer.state[p] = {
                    "step": torch.tensor(float(count)),
                    "exp_avg": state.opt_state["mu"][name].clone(),
                    "exp_avg_sq": state.opt_state["nu"][name].clone()}
            for group in self.optimizer.param_groups:
                group["lr"] = self.lr(count)
            self.optimizer.step()
            self.optimizer.zero_grad(set_to_none=True)
            opt = {"mu": {}, "nu": {}, "count": count + 1}
            params = {}
            for name, p in named:
                params[name] = p.detach().clone()
                opt["mu"][name] = self.optimizer.state[p]["exp_avg"].clone()
                opt["nu"][name] = self.optimizer.state[p]["exp_avg_sq"].clone()
            return TrainState(params, opt, state.step + 1, state.rng)

    def train_step(self, state: TrainState, batch: TrainBatch):
        """``(new state, {"loss", "ranking_accuracy"})`` for one step on
        ``batch`` (on the trainer's device)."""
        with span("train.step", root=True):
            loss, acc, grads = self.value_and_grad(state.params, batch)
            return (self.apply_gradients(state, grads),
                    {"loss": loss, "ranking_accuracy": acc})

    # ---- checkpointing ----
    def save(self, ckpt_dir: str, state: TrainState) -> None:
        """``ckpt_dir/step_%08d/state.pt`` (written atomically) and
        ``ckpt_dir/config.json``."""
        path = os.path.join(ckpt_dir, f"step_{int(state.step):08d}")
        os.makedirs(path, exist_ok=True)
        out = os.path.join(path, "state.pt")
        torch.save(state._asdict(), out + ".tmp")
        os.replace(out + ".tmp", out)
        with open(os.path.join(ckpt_dir, "config.json"), "w") as f:
            f.write(self.config.to_json())

    def restore(self, ckpt_dir: str, step: Optional[int] = None
                ) -> TrainState:
        """The checkpoint of ``step`` (default: the latest) in
        ``ckpt_dir``, params and moments on the trainer's device: the
        step's ``state.pt``, else its Orbax checkpoint from the JAX
        trainer (``train/checkpoint.py``; no generator state)."""
        from deeplocalproteindocking_torch.train import checkpoint
        return checkpoint.load_train_state(ckpt_dir, step).to(self.device)
