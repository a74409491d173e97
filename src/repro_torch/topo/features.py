"""Fixed-size ML features from persistence diagrams (counterpart of
``repro.topo.features``).

Turns the fixed-layout ``Diagrams`` tensors into dense vectors for a
classifier or an index: Betti curves, persistence statistics, persistence
images and landscapes.  Everything is masked arithmetic over (..., S)
tensors on the diagrams' device.

Sums of floats (the statistics' totals and means, the image) accumulate in
float64 and round to float32 once, and the image's Gaussian weights take
``exp`` in float64, so the CUDA and CPU paths give the same values; XLA's
float32 ``exp`` and summation order make ``repro``'s values differ from
these in the last bits.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.persistence import Diagrams


def _select(d: Diagrams, k: int) -> torch.Tensor:
    return d.valid & (d.dim == k)


def betti_curve(d: Diagrams, k: int, grid: torch.Tensor) -> torch.Tensor:
    """(..., G) number of dim-k classes alive at each grid value."""
    alive = ((grid >= d.birth[..., :, None]) & (grid < d.death[..., :, None])
             & _select(d, k)[..., :, None])
    return alive.sum(-2).to(torch.float32)


def _sum(x: torch.Tensor, dim) -> torch.Tensor:
    """Float32 sum accumulated in float64 (device-independent rounding)."""
    return x.double().sum(dim).to(torch.float32)


def persistence_stats(d: Diagrams, k: int, cap: float = 64.0) -> torch.Tensor:
    """(..., 6) [count, betti, total-pers, max-pers, mean-birth, mean-death].

    An empty dimension gives zeros (the maximum starts at 0).
    """
    sel = _select(d, k)
    n = sel.sum(-1).to(torch.float32)
    nz = n.clamp(min=1.0)
    death = d.finite_death(cap)
    pers = torch.where(sel, death - d.birth, 0.0)
    birth = torch.where(sel, d.birth, 0.0)
    return torch.stack([
        n,
        (sel & torch.isinf(d.death)).sum(-1).to(torch.float32),
        _sum(pers, -1),
        F.pad(pers, (0, 1)).amax(-1),
        _sum(birth, -1) / nz,
        _sum(torch.where(sel, death, 0.0), -1) / nz,
    ], dim=-1)


def linspace_f32(lo: float, hi: float, num: int) -> np.ndarray:
    """float32 ``num``-point grid on [lo, hi], with ``jnp.linspace``'s
    arithmetic as XLA folds it for constant bounds (so the grid equals the
    one ``repro``'s jitted features use)."""
    lo32, hi32 = np.float32(lo), np.float32(hi)
    if num == 1:
        return np.array([lo32], np.float32)
    c = np.float32(1.0) / np.float32(num - 1)
    i = np.arange(num - 1, dtype=np.float32)
    head = lo32 * (np.float32(1.0) - i * c) + i * (hi32 * c)
    return np.append(head, hi32).astype(np.float32)


def persistence_image(d: Diagrams, k: int, res: int = 8, lo: float = 0.0,
                      hi: float = 32.0, sigma: float = 1.0,
                      cap: float = 64.0) -> torch.Tensor:
    """(..., res, res) persistence-weighted Gaussian surface on
    (birth, persistence)."""
    sel = _select(d, k).to(torch.float32)
    birth0, death = d.finite_points(cap)
    pers = (death - birth0).clamp(0.0, hi - lo)
    birth = birth0.clamp(lo, hi)
    grid = torch.from_numpy(linspace_f32(lo, hi, res)).to(birth.device)

    def gauss(x):  # (..., S) -> (..., S, res) float64
        z = (x[..., :, None] - grid) / sigma
        return (-0.5 * z ** 2).double().exp()

    wb = gauss(birth) * (sel * pers).double()[..., :, None]
    img = wb.transpose(-1, -2) @ gauss(pers)  # sum over the S points
    return img.to(torch.float32)


def persistence_landscape(d: Diagrams, k: int, grid: torch.Tensor,
                          n_levels: int = 3, cap: float = 64.0) -> torch.Tensor:
    """(..., n_levels, G) landscape functions lambda_1..lambda_n on grid."""
    birth, death = d.finite_points(cap)
    tent = torch.minimum(grid - birth[..., :, None],
                         death[..., :, None] - grid).clamp(min=0.0)
    tent = torch.where(_select(d, k)[..., :, None], tent, float("-inf"))
    top = torch.topk(tent.transpose(-1, -2), n_levels, dim=-1).values
    return top.transpose(-1, -2).clamp(min=0.0)


def feature_vector(d: Diagrams, max_dim: int = 1, res: int = 8,
                   cap: float = 64.0) -> torch.Tensor:
    """Statistics + flattened persistence image per dimension:
    (..., (6 + res*res) * (max_dim + 1)) float32."""
    parts = []
    for k in range(max_dim + 1):
        parts.append(persistence_stats(d, k, cap))
        parts.append(persistence_image(d, k, res=res, cap=cap).reshape(
            d.birth.shape[:-1] + (res * res,)))
    return torch.cat(parts, dim=-1)


def signature_features(g, plan, res: int = 8,
                       cap: float = 64.0) -> torch.Tensor:
    """GraphBatch -> topological feature vectors through a
    :class:`repro_torch.core.api.TopoPlan`; equals ``feature_vector`` with
    ``max_dim = plan.dim``."""
    return feature_vector(plan.execute(g), max_dim=plan.dim, res=res, cap=cap)
