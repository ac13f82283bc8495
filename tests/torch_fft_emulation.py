"""Torch emulations of the FFT kernels' shared stages (``csrc/fft.cuh``),
used by the CPU tests of K2's and K3's FFT routes (not a test module).

Each function follows the CUDA code step by step in complex64: the same
radix splits, twiddles and digit orders, so that a test can hold the
formulation against the plain versions and the JAX kernels where no card
is present.
"""
import math

import torch

P = 8           # the c2r's first radix (c2r_columns)
SIN60 = math.sqrt(3) / 2


def idft2(a0, a1, mutate=None):
    """``idft<2>``: one butterfly, outputs a0 + a1 and a0 - a1;
    ``"radix2_sign"`` plants a1 - a0 as the second, ``"radix2_digit_order"``
    the two outputs swapped."""
    if mutate == "radix2_sign":
        return [a0 + a1, a1 - a0]
    if mutate == "radix2_digit_order":
        return [a0 - a1, a0 + a1]
    return [a0 + a1, a0 - a1]


def idft3(a0, a1, a2, mutate=None):
    """``idft3``: inverse DFT of 3, natural order, with the cube root of
    unity e^{+2 pi i/3} = -1/2 + i sqrt(3)/2; ``"radix3_sign"`` plants
    its conjugate."""
    s = -SIN60 if mutate == "radix3_sign" else SIN60
    t, d = a1 + a2, a1 - a2
    m, r = a0 - 0.5 * t, 1j * s * d
    return [a0 + t, m + r, m - r]


def idft4(a0, a1, a2, a3):
    """``idft4``: inverse DFT of 4, natural order."""
    t0, t1, t2, t3 = a0 + a2, a0 - a2, a1 + a3, 1j * (a1 - a3)
    return [t0 + t2, t1 + t3, t0 - t2, t1 - t3]


def idft8(v):
    """``idft<8>``: two ``idft4`` and the e^{i pi/4} steps."""
    e = idft4(v[0], v[2], v[4], v[6])
    o = idft4(v[1], v[3], v[5], v[7])
    r = math.sqrt(0.5)
    o[1] = (r + 1j * r) * o[1]
    o[2] = 1j * o[2]
    o[3] = (-r + 1j * r) * o[3]
    return [e[n] + o[n] for n in range(4)] + [e[n] - o[n] for n in range(4)]


def idft6(v, mutate=None):
    """``idft<6>``: ``idft3`` of the even and odd inputs, then the radix-2
    step with e^{+2 pi i n / 6}, outputs n and n + 3 from digit n;
    ``"radix6_digit_order"`` plants outputs 2n and 2n + 1 instead."""
    e = idft3(v[0], v[2], v[4], mutate)
    o = idft3(v[1], v[3], v[5], mutate)
    t = [complex(0.5, SIN60) ** n * o[n] for n in range(3)]
    if mutate == "radix6_digit_order":
        return [x for n in range(3) for x in (e[n] + t[n], e[n] - t[n])]
    return [e[n] + t[n] for n in range(3)] + [e[n] - t[n] for n in range(3)]


def idft12(v, mutate=None):
    """``idft<12>``: ``idft<6>`` of the even and odd inputs, then the
    radix-2 step with e^{+2 pi i n / 12}."""
    e, o = idft6(v[0::2], mutate), idft6(v[1::2], mutate)
    t = [complex(math.cos(math.pi * n / 6), math.sin(math.pi * n / 6)) * o[n]
         for n in range(6)]
    return [e[n] + t[n] for n in range(6)] + [e[n] - t[n] for n in range(6)]


def idft16(v, mutate=None):
    """``idft<16>``: ``idft<8>`` of the even and odd inputs, then the
    radix-2 step with e^{+2 pi i n / 16}; ``"radix16_digit_order"``
    plants outputs 2n and 2n + 1 instead of n and n + 8."""
    e, o = idft8(v[0::2]), idft8(v[1::2])
    t = [complex(math.cos(math.pi * n / 8), math.sin(math.pi * n / 8)) * o[n]
         for n in range(8)]
    if mutate == "radix16_digit_order":
        return [x for n in range(8) for x in (e[n] + t[n], e[n] - t[n])]
    return [e[n] + t[n] for n in range(8)] + [e[n] - t[n] for n in range(8)]


def idft_pairs(v, mutate=None):
    """``idft<5>`` / ``idft<7>``: the direct inverse DFT of odd N over the
    input pairs s_n = a_n + a_{N-n}, d_n = a_n - a_{N-n}: y_k = a_0 +
    sum_n s_n cos(2 pi n k/N) +- i sum_n d_n sin(2 pi n k/N) for k and
    N - k; ``"radix5_sign"`` / ``"radix7_sign"`` plants the conjugate
    root (the sine terms' sign flipped)."""
    N = len(v)
    h = N // 2
    sign = -1 if mutate == f"radix{N}_sign" else 1
    s = [v[n] + v[N - n] for n in range(1, h + 1)]
    d = [v[n] - v[N - n] for n in range(1, h + 1)]
    out = [v[0] + sum(s)] + [None] * (N - 1)
    for k in range(1, h + 1):
        a = v[0] + sum(math.cos(2 * math.pi * n * k / N) * s[n - 1]
                       for n in range(1, h + 1))
        b = sign * sum(math.sin(2 * math.pi * n * k / N) * d[n - 1]
                       for n in range(1, h + 1))
        out[k], out[N - k] = a + 1j * b, a - 1j * b
    return out


def idft_radix2(v, mutate=None):
    """``idft<10>`` / ``idft<14>``: ``idft_pairs`` of the even and odd
    inputs, then the radix-2 step with e^{+2 pi i n / N}, outputs n and
    n + N/2 from digit n; ``"radix10_digit_order"`` /
    ``"radix14_digit_order"`` plants outputs 2n and 2n + 1 instead."""
    H = len(v) // 2
    e, o = idft_pairs(v[0::2], mutate), idft_pairs(v[1::2], mutate)
    t = [complex(math.cos(math.pi * n / H), math.sin(math.pi * n / H)) * o[n]
         for n in range(H)]
    if mutate == f"radix{2 * H}_digit_order":
        return [x for n in range(H) for x in (e[n] + t[n], e[n] - t[n])]
    return [e[n] + t[n] for n in range(H)] + [e[n] - t[n] for n in range(H)]


def idft(v, mutate=None):
    """The kernels' ``idft<N>`` for N = len(v) in {2, 3, 4, 5, 6, 7, 8, 10,
    12, 14, 16}; ``mutate`` reaches the radix-2, 3, 5 and 7 stages, the
    2 x 5 and 2 x 7 splits and the radix-16 digit order only."""
    n = len(v)
    if n == 2:
        return idft2(*v, mutate)
    if n in (6, 12):
        return (idft6 if n == 6 else idft12)(v, mutate)
    if n == 3:
        return idft3(*v, mutate)
    if n in (5, 7):
        return idft_pairs(v, mutate)
    if n in (10, 14):
        return idft_radix2(v, mutate)
    if n == 16:
        return idft16(v, mutate)
    return {4: lambda v: idft4(*v), 8: idft8}[n](v)


def twiddles(L):
    """The kernels' shared table e^{+2 pi i j / L}, complex64."""
    return torch.exp(2j * torch.pi * torch.arange(L, dtype=torch.float64)
                     / L).to(torch.complex64)


def c2r_columns(X, mutate=None):
    """``c2r_columns`` and its 1/L: the half spectrum ``X [b, M+1, N]``
    (complex64, along dim 1) -> ``s [b, 2M, N]`` float32, the irfft of
    each column, for L = 16 Q (Q = 2 .. 8: L = 32 .. 128).  ``mutate``
    plants one error: ``"no_conj"``, ``"minus_i"``, ``"mirror_index"``
    (packing), ``"digit_order"``, or one of :func:`idft`'s errors."""
    b, K, N = X.shape
    M = K - 1
    L, Q = 2 * M, M // P
    tw = twiddles(L)
    X = X.clone()
    X[:, 0] = X[:, 0].real.to(X.dtype)                 # X[0], X[M]: real
    X[:, M] = X[:, M].real.to(X.dtype)
    k = torch.arange(M)
    mirror = M - k - 1 if mutate == "mirror_index" else M - k
    a, m = X[:, k], X[:, mirror]
    mc = m if mutate == "no_conj" else m.conj()
    sign = -1j if mutate == "minus_i" else 1j
    Z = (a + mc) + sign * tw[k, None] * (a - mc)       # [b, M, N]
    # Radix-8 pass: warp k2 takes Z[Q k1 + k2] over k1, then the twiddle.
    Zk = Z.reshape(b, P, Q, N)                         # [b, k1, k2, N]
    v = idft8([Zk[:, k1] for k1 in range(P)])          # v[n1]: [b, Q, N]
    k2 = torch.arange(Q)
    A = torch.stack([v[n1] * tw[(2 * k2 * n1) % L, None]
                     for n1 in range(P)], dim=1)       # [b, n1, k2, N]
    # Radix-Q pass: warp n1 takes A[n1, k2] over k2: z[n1 + P n2].
    u = idft([A[:, :, j] for j in range(Q)], mutate)   # u[n2]: [b, n1, N]
    zz = torch.stack(u, dim=1)                         # [b, n2, n1, N]
    if mutate == "digit_order":
        zz = zz.transpose(1, 2)
    z = zz.reshape(b, M, N)
    return torch.stack([z.real, z.imag], dim=2).reshape(b, L, N) / L
