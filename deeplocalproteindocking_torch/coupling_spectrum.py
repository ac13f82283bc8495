"""Print a checkpoint's channel-coupling singular-value spectrum.

The port of ``tools/coupling_spectrum.py``, line for line the same
output, without JAX:

    python -m deeplocalproteindocking_torch.coupling_spectrum [CKPT_DIR]

(default ``pretrained/synthetic-v5u/best``).  ``CKPT_DIR`` holds
``step_*`` checkpoints (the port's ``state.pt`` or the JAX trainer's
Orbax steps; the latest is read) and a ``config.json``, or its parent
does.

It decides the ``DockConfig.coupling_rank`` knob: the docking score is
bilinear in the coupling, so a rank-r SVD truncation is a ligand-side
channel reduction in the correlator.  The licence is deviation capture,
not energy (``pipeline.coupling_deviation_capture`` /
``min_licensed_rank``, the computation that gates ``coupling_rank`` at
dock time): the hybrid's coupling is dominated by the shape block, and a
truncation can keep all of the energy while dropping most of what
training learned, the deviation from that block.
"""
from __future__ import annotations

import os
import sys
from typing import List, Optional

import numpy as np

from deeplocalproteindocking_torch.config import DockConfig
from deeplocalproteindocking_torch.pipeline import (
    coupling_deviation_capture, min_licensed_rank)
from deeplocalproteindocking_torch.train import checkpoint

DEFAULT_CKPT = os.path.join("pretrained", "synthetic-v5u", "best")


def spectrum_lines(ckpt: str) -> List[str]:
    """The lines the tool prints for checkpoint directory ``ckpt``."""
    cfg_path = os.path.join(ckpt, "config.json")
    if not os.path.exists(cfg_path):
        cfg_path = os.path.join(os.path.dirname(ckpt), "config.json")
    with open(cfg_path) as f:
        cfg = DockConfig.from_json(f.read())
    A = checkpoint.load_params(ckpt)["coupling"].numpy().astype(np.float64)
    _, s, _ = np.linalg.svd(A)
    e = s ** 2
    cum = np.cumsum(e) / e.sum()
    sp = bool(cfg.shape_prior)
    prior_name = "shape_block" if sp else "identity"
    _, dev = coupling_deviation_capture(A, 1, shape_prior=sp)
    lines = [f"coupling {A.shape}, ||A - {prior_name}|| = {dev:.4f}:"]
    for r in range(1, len(s) + 1):
        kept, _ = coupling_deviation_capture(A, r, shape_prior=sp)
        lost = (1.0 - kept) * dev
        lines.append(f"  r={r:2d}  s={s[r - 1]:9.4f}  energy "
                     f"{cum[r - 1]:.5f}  trunc-err {lost:.4f}  deviation "
                     f"kept {kept:6.1%}")
    lines.append(f"smallest rank keeping >=95% of the learned deviation: "
                 f"{min_licensed_rank(A, shape_prior=sp)}")
    return lines


def main(argv: Optional[List[str]] = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    print("\n".join(spectrum_lines(argv[0] if argv else DEFAULT_CKPT)))


if __name__ == "__main__":
    main()
