"""SO(3) machinery for EquiformerV2's eSCN convolutions; torch port of
``repro.models.gnn.so3``.

Real spherical harmonics up to ``l_max`` are evaluated with the pole-free
polynomial recurrences (sectoral (2m−1)!! terms absorb sinᵐθ into
Re/Im((x+iy)ᵐ), so everything is a polynomial in the unit direction: no
divisions).

Wigner rotation matrices use the *sampled* construction: degree-l
harmonics are closed under rotation, so with K = (l_max+1)² generic sample
directions X, the matrix ``Y(R X) · Y(X)⁻¹`` is the exact rotation operator
in harmonic space. The sample directions and the per-degree inverses are
the reference's, bit for bit: host numpy and scipy with the same seed,
draws, QR pivoting and float32 pseudo-inverses (:func:`_sample_inverses`).

Orientation convention: ``frame_from_direction`` returns R with R @ ê = ẑ;
rotating features by D(R) expresses them in the edge-aligned frame where
z-rotations act block-diagonally on (m, −m) pairs, the structure the SO(2)
convolution in ``equiformer.py`` exploits.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch


def n_coeffs(l_max: int) -> int:
    return (l_max + 1) ** 2


def real_sph_harm(dirs, l_max: int):
    """dirs [..., 3] (unit) -> [..., (l_max+1)²] real SH, index l²+l+m.

    ``dirs`` is a tensor or a numpy array; numpy runs the same recurrences
    on the host (the sample inverses are built that way, as in the
    reference).
    """
    xp = np if isinstance(dirs, np.ndarray) else torch
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    # c_m + i s_m = (x + i y)^m  (Chebyshev-style recurrence, pole-free)
    cs = [xp.ones_like(x)]
    sn = [xp.zeros_like(x)]
    for m in range(1, l_max + 1):
        c_prev, s_prev = cs[-1], sn[-1]
        cs.append(c_prev * x - s_prev * y)
        sn.append(s_prev * x + c_prev * y)

    # T[l][m] = P_l^m(z) / sin^m θ  (polynomial in z), via upward recurrence
    T = [[None] * (l_max + 1) for _ in range(l_max + 1)]
    for m in range(l_max + 1):
        # sectoral: T_m^m = (-1)^m (2m-1)!!
        dfact = 1.0
        for k in range(1, m + 1):
            dfact *= 2 * k - 1
        T[m][m] = xp.full_like(z, ((-1.0) ** m) * dfact)
        if m + 1 <= l_max:
            T[m + 1][m] = z * (2 * m + 1) * T[m][m]
        for l in range(m + 1, l_max):
            T[l + 1][m] = ((2 * l + 1) * z * T[l][m]
                           - (l + m) * T[l - 1][m]) / (l - m + 1)

    out = []
    for l in range(l_max + 1):
        row = [None] * (2 * l + 1)
        for m in range(0, l + 1):
            nlm = math.sqrt((2 * l + 1) / (4 * math.pi)
                            * math.factorial(l - m) / math.factorial(l + m))
            if m == 0:
                row[l] = nlm * T[l][0]
            else:
                row[l + m] = math.sqrt(2) * nlm * T[l][m] * cs[m]
                row[l - m] = math.sqrt(2) * nlm * T[l][m] * sn[m]
        out.extend(row)
    return np.stack(out, axis=-1) if xp is np else torch.stack(out, dim=-1)


@lru_cache(maxsize=8)
def _sample_inverses_np(l_max: int, seed: int = 7):
    """Host-side: sample directions X [K, 3] and per-l inverse blocks of
    Y(X), [2l+1, K] each, as float32 numpy: the reference's draws and
    algebra, step for step."""
    import scipy.linalg

    rng = np.random.default_rng(seed)
    K = n_coeffs(l_max)
    pts = rng.normal(size=(4 * K, 3))
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    Y = real_sph_harm(pts.astype(np.float32), l_max)
    # pick K well-conditioned rows greedily (QR pivoting)
    _, _, piv = scipy.linalg.qr(Y.T, pivoting=True, mode="economic")
    sel = piv[:K]
    X = pts[sel]
    Yx = Y[sel]                                    # [K, K]
    invs = []
    for l in range(l_max + 1):
        lo, hi = l * l, (l + 1) * (l + 1)
        invs.append(np.linalg.pinv(Yx[:, lo:hi]))  # [2l+1, K]
    return (np.asarray(X, np.float32),
            tuple(np.asarray(i, np.float32) for i in invs))


def _sample_inverses(l_max: int, device=None, seed: int = 7):
    """``(X [K, 3], [inv_l [2l+1, K]])`` as float32 tensors on ``device``
    (default: the CPU), cached per ``(l_max, device, seed)``: the numpy
    build runs once per ``(l_max, seed)``."""
    return _sample_inverses_on(l_max, torch.device(device or "cpu"), seed)


@lru_cache(maxsize=None)
def _sample_inverses_on(l_max: int, device: torch.device, seed: int):
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    X, invs = _sample_inverses_np(l_max, seed)
    with unset_fake_temporarily():   # a cached constant is real, always
        return (torch.tensor(X, device=device),
                [torch.tensor(i, device=device) for i in invs])


def frame_from_direction(d: torch.Tensor) -> torch.Tensor:
    """[..., 3] unit vectors -> R [..., 3, 3] with R @ d = ẑ
    (deterministic)."""
    x = d[..., 0]
    one, zero = torch.ones_like(x), torch.zeros_like(x)
    # pick a reference not parallel to d (smooth deterministic switch)
    near_pole = torch.abs(d[..., 2]) > 0.99
    ref = torch.where(near_pole[..., None],
                      torch.stack([one, zero, zero], -1),
                      torch.stack([zero, zero, one], -1))
    u = torch.linalg.cross(ref, d)
    u = u / torch.clamp(torch.linalg.vector_norm(u, dim=-1, keepdim=True),
                        min=1e-12)
    v = torch.linalg.cross(d, u)
    # rows of R are the new basis: R @ d = ẑ
    return torch.stack([u, v, d], dim=-2)


def wigner_from_rotation(R: torch.Tensor, l_max: int) -> list:
    """R [..., 3, 3] -> list of D_l [..., 2l+1, 2l+1] with
    Y(R x) = D_l @ Y(x) per degree block (exact for generic samples)."""
    X, invs = _sample_inverses(l_max, R.device)
    RX = torch.einsum("...ij,kj->...ki", R, X.to(R.dtype))   # [..., K, 3]
    Yr = real_sph_harm(RX, l_max)                   # [..., K, (L+1)²]
    out = []
    for l in range(l_max + 1):
        lo, hi = l * l, (l + 1) ** 2
        # D_l[a, b]: Y_a(Rx) = Σ_b D[a,b] Y_b(x)  -> D = (pinv @ Yr_block)^T
        out.append(torch.einsum("bk,...ka->...ab", invs[l].to(R.dtype),
                                Yr[..., lo:hi]))
    return out


def pack_wigner(D_blocks: list) -> torch.Tensor:
    """[..., 2l+1, 2l+1] blocks -> packed [..., Σ(2l+1)²] (cross-layer
    reuse)."""
    return torch.cat([d.reshape(d.shape[:-2] + (-1,)) for d in D_blocks],
                     dim=-1)


def unpack_wigner(packed: torch.Tensor, l_max: int) -> list:
    out = []
    off = 0
    for l in range(l_max + 1):
        k = (2 * l + 1) ** 2
        out.append(packed[..., off: off + k].reshape(
            packed.shape[:-1] + (2 * l + 1, 2 * l + 1)))
        off += k
    return out


def rotate_coeffs(coeffs: torch.Tensor, D_blocks: list, l_max: int,
                  transpose: bool = False) -> torch.Tensor:
    """coeffs [..., (L+1)², C]; apply block-diag D (or Dᵀ = inverse)."""
    outs = []
    for l in range(l_max + 1):
        lo, hi = l * l, (l + 1) ** 2
        D = D_blocks[l].transpose(-1, -2) if transpose else D_blocks[l]
        outs.append(D @ coeffs[..., lo:hi, :])
    return torch.cat(outs, dim=-2)
