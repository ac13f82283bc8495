"""SO(3) rotation sets for exhaustive and local docking sweeps.

Port of ``deeplocalproteindocking_tpu/structure/so3.py``: the
Super-Fibonacci spiral (Alexa, CVPR 2022) as a closed-form function of
``n`` — quaternions built in float64 numpy, exactly as the JAX package
builds them — and the local cone around a base orientation.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deeplocalproteindocking_torch.structure.transforms import (
    axis_angle_to_matrix, quat_to_matrix)

_PHI = float(np.sqrt(2.0))
# Positive real root of x^4 = x + 4 (Super-Fibonacci constant psi).
_PSI = 1.533751168755204288118041


def super_fibonacci_rotations(n: int,
                              device: torch.device | str = "cpu"
                              ) -> torch.Tensor:
    """``[n, 3, 3]`` float32 near-uniform low-discrepancy cover of SO(3)."""
    i = np.arange(n, dtype=np.float64)
    s = i + 0.5
    t = s / n
    d = 2.0 * np.pi * s
    r, big_r = np.sqrt(t), np.sqrt(1.0 - t)
    alpha, beta = d / _PHI, d / _PSI
    q = np.stack([r * np.sin(alpha), r * np.cos(alpha),
                  big_r * np.sin(beta), big_r * np.cos(beta)], axis=-1)
    return quat_to_matrix(torch.as_tensor(q, dtype=torch.float32,
                                          device=device))


def _interp(x: torch.Tensor, xp: torch.Tensor,
            fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp`` (piecewise-linear, clamped ends) via searchsorted."""
    i = torch.searchsorted(xp, x, right=True).clamp(1, xp.numel() - 1)
    x0, x1 = xp[i - 1], xp[i]
    f0, f1 = fp[i - 1], fp[i]
    dx = x1 - x0
    f = torch.where(dx == 0, f1,
                    f0 + ((x - x0) / torch.where(dx == 0,
                                                 torch.ones_like(dx), dx))
                    * (f1 - f0))
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def local_rotations(base: torch.Tensor, max_angle: float, n: int,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
    """``n`` rotations within a geodesic cone of ``max_angle`` (radians)
    around ``base [3, 3]``.

    Deterministic by default (a Fibonacci sphere of axes crossed with a
    low-discrepancy angle schedule); pass ``generator`` for a random
    set.  The rotation angle follows the Haar density ∝ sin²(θ/2),
    inverted numerically from a 512-point CDF table.
    """
    device = base.device
    if generator is not None:
        axes = torch.randn((n, 3), generator=generator,
                           device=generator.device).to(device)
        u = torch.rand((n,), generator=generator,
                       device=generator.device).to(device)
    else:
        i = np.arange(n, dtype=np.float64)
        ga = np.pi * (3.0 - np.sqrt(5.0))  # golden angle
        z = 1.0 - 2.0 * (i + 0.5) / n
        rho = np.sqrt(np.maximum(0.0, 1.0 - z * z))
        axes = torch.as_tensor(np.stack(
            [rho * np.cos(ga * i), rho * np.sin(ga * i), z], axis=-1),
            dtype=torch.float32, device=device)
        u = torch.as_tensor((i + 0.5) / n, dtype=torch.float32,
                            device=device)
    grid = torch.linspace(0.0, max_angle, 512, dtype=torch.float32,
                          device=device)
    pdf = torch.sin(grid / 2.0) ** 2
    cdf = torch.cumsum(pdf, 0)
    cdf = cdf / cdf[-1]
    angles = _interp(u, cdf, grid)
    local = axis_angle_to_matrix(axes, angles)
    return torch.einsum("nij,jk->nik", local, base.to(torch.float32))
