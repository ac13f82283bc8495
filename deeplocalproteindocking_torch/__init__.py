"""deeplocalproteindocking_torch — the docking main path in PyTorch + CUDA.

A port of ``deeplocalproteindocking_tpu`` (the JAX reference, which stays
beside it unchanged) to PyTorch on an NVIDIA Hopper card.  Module names
follow the JAX package so each function's counterpart is easy to find:

* ``structure/`` — PDB parse/write, 11-type atom table, rigid transforms,
  super-Fibonacci and local-cone SO(3) sets (numpy + torch);
* ``data/``      — synthetic carved complexes, padded device tensors;
* ``grids/``     — the matmul-form separable Gaussian splat;
* ``models/``    — shape channels, the 3-D CNN and the scoring model;
* ``correlate/`` — receptor spectrum, the matmul-DFT correlator and the
  two hand-written Hopper kernels: ``fused.py`` (forward-y/x + coupling +
  inverse-x/y) and ``invz_topk.py`` (inverse-z + mask + block max);
* ``sweep/``     — exact two-level top-K, the resplat rotation sweep,
  pose clustering;
* ``pipeline.py`` — ``DockingPipeline.dock``: structures in, ranked
  poses out;
* ``train/``     — ranking-loss training: decoys, batches, the trainer,
  FFT-mined hard negatives; ``train_flagship.py`` is its driver;
  ``train/checkpoint.py`` reads the JAX package's Orbax checkpoints
  without JAX (``utils/zstd.py``, ``utils/ocdbt.py``, ``utils/zarr.py``).

The package imports ``torch`` and numpy only; CUDA kernels are compiled
from ``csrc/`` with ``nvcc`` on first use (``_build.py``).
"""

__version__ = "0.1.0"

from deeplocalproteindocking_torch.config import DockConfig, PRESETS  # noqa: F401
