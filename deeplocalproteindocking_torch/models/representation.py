"""3-D CNN representation network and the analytic shape channels.

Port of ``deeplocalproteindocking_tpu/models/representation.py``.  Public
functions keep the JAX layout, channels-last ``[..., L, L, L, C]``, and
permute to ``NCDHW`` only around ``F.conv3d``.  Flax ``DHWIO`` kernels
map to torch ``[O, I, kx, ky, kz]`` with no flip (both are
cross-correlations).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

# Flax lecun_normal: truncated normal on [-2, 2] std, rescaled so the
# truncated distribution has variance 1 / fan_in.
_TRUNC_STD = 0.87962566103423978


def shape_channels(vol: torch.Tensor, *, core_weight: float = 12.0,
                   threshold: float = 0.35, shell: int = 2):
    """Analytic (surface, core) channels from a density volume.

    ``vol [..., L, L, L, T] -> [..., L, L, L, 2]`` float32: core =
    occupancy above ``threshold``; surface = ``shell``-voxel cube
    dilation of the core minus the core.  Returns ``(rep, coupling)``
    with the fixed coupling ``[[1, 0], [0, -core_weight]]``.
    """
    occ = vol.sum(-1)
    core = (occ > threshold).to(torch.float32)
    w = 2 * shell + 1
    spatial = core.shape[-3:]
    dil = core.reshape((-1, 1) + spatial)
    # Separable cube dilation: three 1-D max-pools; max_pool3d pads with
    # -inf, as the JAX "SAME" reduce_window does.
    for win in ((w, 1, 1), (1, w, 1), (1, 1, w)):
        dil = F.max_pool3d(dil, win, stride=1,
                           padding=tuple(v // 2 for v in win))
    dil = dil.reshape(core.shape)
    rep = torch.stack([dil - core, core], dim=-1)
    coupling = torch.tensor([[1.0, 0.0], [0.0, -core_weight]],
                            dtype=torch.float32, device=vol.device)
    return rep, coupling


def conv3d_channels_last(x: torch.Tensor, w: torch.Tensor,
                         b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """"SAME" 3-D convolution on ``[N, L, L, L, C_in]`` with a torch
    weight ``[C_out, C_in, k, k, k]`` (odd k); returns channels-last."""
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), w, b,
                 padding=w.shape[-1] // 2)
    return y.permute(0, 2, 3, 4, 1)


class Representation(nn.Module):
    """Stack of "SAME" 3-D convolutions with ELU between them."""

    def __init__(self, in_channels: int = 11,
                 features: Sequence[int] = (32, 32, 16), kernel: int = 3,
                 dtype: torch.dtype = torch.float32,
                 use_bias: bool = True):
        super().__init__()
        self.dtype = dtype
        widths = [in_channels] + list(features)
        self.convs = nn.ModuleList(
            nn.Conv3d(cin, cout, kernel, padding=kernel // 2,
                      bias=use_bias)
            for cin, cout in zip(widths[:-1], widths[1:]))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for conv in self.convs:
            fan_in = conv.weight[0].numel()
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            with torch.no_grad():
                nn.init.trunc_normal_(conv.weight, 0.0, std, -2.0 * std,
                                      2.0 * std, generator=generator)
                if conv.bias is not None:
                    conv.bias.zero_()

    def forward(self, vol: torch.Tensor) -> torch.Tensor:
        """``[..., L, L, L, C_in] -> [..., L, L, L, C_rep]`` float32,
        computed in ``self.dtype`` (params stay float32)."""
        lead = vol.shape[:-4]
        x = vol.reshape((-1,) + vol.shape[-4:]).to(self.dtype)
        for i, conv in enumerate(self.convs):
            b = None if conv.bias is None else conv.bias.to(self.dtype)
            x = conv3d_channels_last(x, conv.weight.to(self.dtype), b)
            if i + 1 < len(self.convs):
                x = F.elu(x)
        x = x.to(torch.float32)
        return x.reshape(lead + x.shape[1:])


class HybridRepresentation(nn.Module):
    """Analytic ``[surface, core]`` channels ++ a bias-free learned CNN.

    Bias-free so the learned channels stay supported near atoms, like
    the physical channels (see the JAX module for the measurement).
    """

    def __init__(self, in_channels: int = 11,
                 features: Sequence[int] = (32, 16), kernel: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cnn = Representation(in_channels, features, kernel, dtype,
                                  use_bias=False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.cnn.reset_parameters(generator)

    def forward(self, vol: torch.Tensor) -> torch.Tensor:
        learned = self.cnn(vol)
        prior, _ = shape_channels(vol)
        return torch.cat([prior, learned], dim=-1)
