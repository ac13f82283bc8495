"""``DockConfig`` and ``PRESETS``: the port's own copy.

The same dataclass as ``deeplocalproteindocking_tpu/config.py``: the
same fields, types and defaults, ``to_json``/``from_json`` and named
presets, so a checkpoint's ``config.json`` reads the same way in both
packages.  The port keeps its own copy and never loads the JAX
package's file; a tier-1 test holds the two in step.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class DockConfig:
    # --- grid geometry (reference: TypedCoords2Volume args) ---
    grid_size: int = 128          # L: voxels per edge
    resolution: float = 1.25      # Angstrom per voxel
    sigma: float = 1.0            # Gaussian splat width (Angstrom)
    splat_window: int = 6         # voxels per axis of the local splat window
    num_atom_types: int = 11      # fixed by the 11-type chemistry table

    # --- representation model (reference: EQRepresentation) ---
    rep_features: Tuple[int, ...] = (32, 32, 16)  # conv widths; last = C_rep
    rep_kernel: int = 3
    shape_prior: bool = False     # hybrid model: analytic (surface,
                                  # core) channels ++ learned channels;
                                  # untrained == shape complementarity
    compute_dtype: str = "float32"   # "bfloat16" for tensor-core serving

    # --- sweep (reference: EQDocker + rotation sets) ---
    num_rotations: int = 13000
    rotation_chunk: int = 16      # rotations per sweep step (batched DFTs)
    sweep_mode: str = "resplat"   # "resplat" (exact rotation of the
                                  # ligand coordinates; the port's mode)
                                  # | "resample" (reference-style rep
                                  # rotation; not ported)
    lig_grid_size: Optional[int] = None  # ligand box; None = auto-fit
    fft_impl: str = "dft_fused"   # "dft_fused" (fused correlator kernel:
                                  #   forward-y/x + coupling + inverse-x/y
                                  #   in one launch -- the fast path)
                                  # | "dft" (pure-einsum matmul-DFT)
                                  # | "dft_pallas" (the inverse-DFT kernel)
                                  # | "xla" (FFT library calls)
                                  # | "block" (overlap-save block FFT;
                                  #   selected when grid_size > 128
                                  #   under the default impl)
    fft_block: int = 32           # translation-block edge for
                                  # fft_impl="block" (must divide
                                  # grid_size)
    dft_dtype: str = "float32"    # "bfloat16" trades precision for rate
    coupling_rank: Optional[int] = None
                                  # SVD-truncate the channel coupling to
                                  # rank r: ligand reps project to r
                                  # channels before the correlator, so
                                  # per-rotation forward-DFT/coupling
                                  # FLOPs scale with r instead of C.
                                  # None = exact full-rank scoring.
    topk_impl: str = "exact"      # "approx" = approximate top-K (faster)
    top_k: int = 32               # poses kept per complex
    atom_bucket: int = 64         # pad atom counts to a multiple so
                                  # size-diverse benchmarks share sweep
                                  # shapes (masked padding; 0 = exact
                                  # size)
    local_cone_deg: Optional[float] = None  # local docking: cone half-angle
    nms_rmsd: float = 5.0         # greedy clustering suppression radius (A)

    # --- training (reference: ranking hinge trainer) ---
    num_decoys: int = 32          # decoys per complex per step
    hinge_margin: float = 1.0
    near_native_rmsd: float = 5.0  # LRMSD below which a decoy is "positive"
    decoy_max_angle_deg: float = 60.0
    decoy_max_shift: float = 12.0  # Angstrom
    decoy_global_frac: float = 0.0  # fraction of decoys drawn GLOBALLY
                                    # (full SO(3) x box-wide shifts)
    mined_frac: float = 0.25        # fraction replaced by FFT-mined hard
                                    # negatives when a buffer is supplied
    learning_rate: float = 1e-3
    lr_decay_steps: int = 0       # >0: cosine-decay learning_rate to
                                  # 10% over this many steps
    weight_decay: float = 0.0     # AdamW decoupled weight decay
    batch_complexes: int = 2      # complexes per train step
    augment_rotations: bool = True  # joint SO(3) augmentation per sample

    # --- device mesh ---
    mesh_rot: int = 1             # devices along the rotation axis
    mesh_batch: int = 1           # devices along the complex/data axis

    # --- misc ---
    seed: int = 0
    debug_nans: bool = False      # NaN guard

    @property
    def c_rep(self) -> int:
        return self.rep_features[-1]

    @property
    def box_extent(self) -> float:
        return self.grid_size * self.resolution

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "DockConfig":
        d = json.loads(text)
        d["rep_features"] = tuple(d.get("rep_features", cls.rep_features))
        return cls(**d)

    def replace(self, **kw) -> "DockConfig":
        return dataclasses.replace(self, **kw)


# Named presets, the same as the JAX package's.
PRESETS = {
    # Single-complex rigid docking, shape channels only, coarse ~100
    # rotations, 64^3 grid (CPU-checkable).
    "tiny-shape": DockConfig(
        grid_size=64, resolution=1.5, num_rotations=96, rotation_chunk=8,
        top_k=16, rep_features=(8,),
    ),
    # Learned multi-channel representation scoring, one rotation batch.
    "rep-score": DockConfig(
        grid_size=96, num_rotations=16, rotation_chunk=16, top_k=16,
    ),
    # Full-resolution sweep with fused top-K + NMS.
    "full-sweep": DockConfig(
        grid_size=128, num_rotations=13000, rotation_chunk=128,
        top_k=64,
    ),
    # End-to-end representation training.
    "train": DockConfig(
        grid_size=96, num_rotations=512, rotation_chunk=8,
        num_decoys=32, batch_complexes=2,
    ),
    # Batched multi-complex benchmark eval on eight devices.
    "benchmark-v5e8": DockConfig(
        grid_size=128, num_rotations=13000, rotation_chunk=16, top_k=64,
        mesh_rot=8, mesh_batch=1,
    ),
}

__all__ = ["DockConfig", "PRESETS"]
