"""Batched hyperbolic (TDOA) Levenberg-Marquardt positioning.

Port of ``radio_mapper_tpu/solver.py`` (``solve_tdoa_impl`` with the
per-receiver noise model and no pair-parallel axis). The fixed-count LM
loop is a Python loop of branchless ``torch.where`` updates — no
``.item()``, no host synchronisation, so on the card it only enqueues.

Measurement model: for pair (i, j) with delay τ_ij (receiver i heard the
signal later ⇒ τ_ij > 0), ``dd_ij = c·τ_ij ≈ ‖x − p_i‖ − ‖x − p_j‖``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from radio_mapper_tpu_torch.constants import SPEED_OF_LIGHT_M_S


class SolveResult(NamedTuple):
    """Fields have the batch shape of the inputs (position adds a 3-axis)."""

    position_enu: torch.Tensor  # [..., 3] emitter estimate, meters ENU
    cost: torch.Tensor  # [...] final weighted mean squared residual (m²)
    residual_rms_m: torch.Tensor  # [...] √cost
    grad_norm: torch.Tensor  # [...] final gradient norm
    converged: torch.Tensor  # [...] bool
    num_measurements: torch.Tensor  # [...] unmasked measurement count
    cov_enu: torch.Tensor  # [..., 3, 3] 1σ² position covariance
    ellipse_major_m: torch.Tensor  # [...] 1σ semi-major axis of the EN ellipse
    ellipse_minor_m: torch.Tensor  # [...] 1σ semi-minor axis
    ellipse_orientation_deg: torch.Tensor  # [...] major-axis bearing in [0, 180)


def _residuals_and_jac(x, anchors, pair_i, pair_j, dd):
    """r_k = (‖x−p_i‖ − ‖x−p_j‖) − dd_k and its Jacobian wrt x ([..., P, 3])."""
    diff = x.unsqueeze(-2) - anchors  # [..., B, 3]
    dist = torch.linalg.vector_norm(diff, dim=-1)  # [..., B]
    unit = diff / (dist.unsqueeze(-1) + 1e-9)
    r = (dist.index_select(-1, pair_i) - dist.index_select(-1, pair_j)) - dd
    return r, unit.index_select(-2, pair_i) - unit.index_select(-2, pair_j)


def _solve3(a, b):
    """Solve a·x = b for batched 3×3 systems via the adjugate (Cramer)."""
    a00, a01, a02 = a[..., 0, 0], a[..., 0, 1], a[..., 0, 2]
    a10, a11, a12 = a[..., 1, 0], a[..., 1, 1], a[..., 1, 2]
    a20, a21, a22 = a[..., 2, 0], a[..., 2, 1], a[..., 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a12 * a20 - a10 * a22
    c02 = a10 * a21 - a11 * a20
    det = a00 * c00 + a01 * c01 + a02 * c02
    inv_det = 1.0 / torch.where(det.abs() < 1e-20, 1e-20, det)
    c10 = a02 * a21 - a01 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a01 * a20 - a00 * a21
    c20 = a01 * a12 - a02 * a11
    c21 = a02 * a10 - a00 * a12
    c22 = a00 * a11 - a01 * a10
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    x0 = (c00 * b0 + c10 * b1 + c20 * b2) * inv_det
    x1 = (c01 * b0 + c11 * b1 + c21 * b2) * inv_det
    x2 = (c02 * b0 + c12 * b1 + c22 * b2) * inv_det
    return torch.stack([x0, x1, x2], dim=-1)


def _inv3(a, floor: float = 1e-20):
    """Adjugate inverse of batched symmetric 3×3 matrices, with a
    sign-preserving determinant floor (near-singular ⇒ huge, not NaN)."""
    a00, a01, a02 = a[..., 0, 0], a[..., 0, 1], a[..., 0, 2]
    a10, a11, a12 = a[..., 1, 0], a[..., 1, 1], a[..., 1, 2]
    a20, a21, a22 = a[..., 2, 0], a[..., 2, 1], a[..., 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a12 * a20 - a10 * a22
    c02 = a10 * a21 - a11 * a20
    det = a00 * c00 + a01 * c01 + a02 * c02
    sign = torch.where(det < 0, -1.0, 1.0)
    inv_det = sign / torch.clamp(det.abs(), min=floor)
    c10 = a02 * a21 - a01 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a01 * a20 - a00 * a21
    c20 = a01 * a12 - a02 * a11
    c21 = a02 * a10 - a00 * a12
    c22 = a00 * a11 - a01 * a10
    row0 = torch.stack([c00, c10, c20], dim=-1)
    row1 = torch.stack([c01, c11, c21], dim=-1)
    row2 = torch.stack([c02, c12, c22], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2) * inv_det[..., None, None]


def error_ellipse_from_cov(cov_enu: torch.Tensor):
    """(semi_major_m, semi_minor_m, bearing_deg) of the 1σ East-North ellipse;
    bearing clockwise from North, folded to [0, 180)."""
    a = cov_enu[..., 0, 0]
    b = cov_enu[..., 0, 1]
    c = cov_enu[..., 1, 1]
    mean = 0.5 * (a + c)
    spread = torch.sqrt(torch.clamp(0.25 * (a - c) ** 2 + b * b, min=0.0))
    lam1 = torch.clamp(mean + spread, min=0.0)
    lam2 = torch.clamp(mean - spread, min=0.0)
    theta = 0.5 * torch.atan2(2.0 * b, a - c)
    bearing = torch.remainder(90.0 - torch.rad2deg(theta), 180.0)
    return torch.sqrt(lam1), torch.sqrt(lam2), bearing


def solve_tdoa_impl(
    anchors_enu: torch.Tensor,
    pair_i: torch.Tensor,
    pair_j: torch.Tensor,
    dd_m: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    *,
    init_enu: Optional[torch.Tensor] = None,
    solve_2d: bool = True,
    iterations: int = 40,
    grad_tol: float = 1e-2,
    sigma_m: Optional[torch.Tensor] = None,
    sigma_floor_m: Optional[torch.Tensor] = None,
) -> SolveResult:
    """Levenberg-Marquardt hyperbolic solve, batched over leading dims.

    Args:
      anchors_enu: ``[..., B, 3]`` receiver ENU positions.
      pair_i/pair_j: ``[P]`` integer receiver indices per measurement.
      dd_m: ``[..., P]`` measured distance differences c·τ (meters).
      weights: ``[..., P]`` non-negative weights; 0 masks a measurement.
      init_enu: ``[..., 3]`` initial guess; default the anchor centroid.
      solve_2d: freeze the Up component at its initial value.
      sigma_m / sigma_floor_m: known per-receiver 1σ noise / its floor.

    The covariance uses the per-receiver noise model (all-pairs dd
    measurements correlated through the pair-differencing matrix A): the
    GLS sandwich Cov = σ_r²·M⁻¹(JᵀWA)(JᵀWA)ᵀM⁻¹, σ_r² estimated without bias.
    """
    dev = dd_m.device
    f32 = torch.float32
    anchors_enu = anchors_enu.to(f32)
    dd_m = dd_m.to(f32)
    pair_i = pair_i.to(device=dev, dtype=torch.int64)
    pair_j = pair_j.to(device=dev, dtype=torch.int64)
    w = torch.ones_like(dd_m) if weights is None else torch.clamp(weights.to(f32), min=0.0)

    # All-zero weights would freeze the solver at its initial guess; degrade
    # to uniform weighting (the measurements still carry geometry).
    w_total = w.sum(dim=-1, keepdim=True)
    w = torch.where(w_total > 1e-9, w, torch.ones_like(w))

    x0 = anchors_enu.mean(dim=-2) if init_enu is None else init_enu.to(f32)
    batch_shape = torch.broadcast_shapes(x0.shape[:-1], dd_m.shape[:-1])
    x0 = x0.expand(*batch_shape, 3) + 0.0 * dd_m[..., :1]
    dim_mask = torch.tensor([1.0, 1.0, 0.0] if solve_2d else [1.0, 1.0, 1.0], dtype=f32, device=dev)
    eye = torch.eye(3, dtype=f32, device=dev)

    wsum = w.sum(dim=-1) + 1e-12

    def cost_fn(x):
        r, _ = _residuals_and_jac(x, anchors_enu, pair_i, pair_j, dd_m)
        return (w * r * r).sum(dim=-1) / wsum

    x = x0
    lam = torch.full(dd_m.shape[:-1], 1e-3, dtype=f32, device=dev) + 0.0 * dd_m[..., 0]
    cost = cost_fn(x0)
    for _ in range(iterations):
        r, jac = _residuals_and_jac(x, anchors_enu, pair_i, pair_j, dd_m)
        jac = jac * dim_mask  # frozen dims contribute nothing
        g = torch.einsum("...pk,...p->...k", jac, w * r) / wsum.unsqueeze(-1)
        h = torch.einsum("...pk,...pl->...kl", jac, jac * w.unsqueeze(-1)) / wsum[..., None, None]
        # Marquardt scaling plus a floor keeps H invertible for degenerate
        # geometry or frozen dims.
        diag = torch.diagonal(h, dim1=-2, dim2=-1)
        damp = lam.unsqueeze(-1) * torch.clamp(diag, min=1e-6) + 1e-6
        h_damped = h + eye * damp.unsqueeze(-2)
        x_new = x + _solve3(h_damped, -g) * dim_mask
        cost_new = cost_fn(x_new)
        improved = cost_new < cost
        x = torch.where(improved.unsqueeze(-1), x_new, x)
        lam = torch.clamp(torch.where(improved, lam * 0.3, lam * 3.0), 1e-8, 1e8)
        cost = torch.minimum(cost, cost_new)

    r, jac = _residuals_and_jac(x, anchors_enu, pair_i, pair_j, dd_m)
    jac = jac * dim_mask
    g = torch.einsum("...pk,...p->...k", jac, w * r) / wsum.unsqueeze(-1)
    grad_norm = torch.linalg.vector_norm(g, dim=-1)
    num_measurements = (w > 0).sum(dim=-1)

    # -- error ellipse from the undamped normal matrix
    m_u = torch.einsum("...pk,...pl->...kl", jac, jac * w.unsqueeze(-1))
    wrr = cost * wsum  # Σ w r²
    if solve_2d:
        # Up is frozen ⇒ m_u's Up row/col is zero; invert the EN block.
        ma, mb, mc = m_u[..., 0, 0], m_u[..., 0, 1], m_u[..., 1, 1]
        det = ma * mc - mb * mb
        det = torch.where(det.abs() < 1e-20, 1e-20, det)
        zeros = torch.zeros_like(ma)
        row0 = torch.stack([mc / det, -mb / det, zeros], dim=-1)
        row1 = torch.stack([-mb / det, ma / det, zeros], dim=-1)
        row2 = torch.stack([zeros, zeros, zeros], dim=-1)
        m_inv = torch.stack([row0, row1, row2], dim=-2)
    else:
        m_inv = _inv3(m_u)
    # A[p, r] = +1 at pair_i[p], −1 at pair_j[p]
    num_receivers = anchors_enu.shape[-2]
    a_mat = (
        torch.nn.functional.one_hot(pair_i, num_receivers).to(f32)
        - torch.nn.functional.one_hot(pair_j, num_receivers).to(f32)
    )
    g = torch.einsum("...pk,pb->...kb", jac * w.unsqueeze(-1), a_mat)
    # unbiased σ_r²: E[Σwr²] = σ_r²·(2·wsum − tr(GᵀM⁻¹G))
    m_inv_g = torch.einsum("...kl,...lb->...kb", m_inv, g)
    denom = 2.0 * wsum - torch.einsum("...kb,...kb->...", g, m_inv_g)
    sigma2 = wrr / torch.clamp(denom, min=0.25)
    if sigma_m is not None:
        sigma2 = torch.square(torch.as_tensor(sigma_m, dtype=f32, device=dev)).expand(sigma2.shape)
    if sigma_floor_m is not None:
        sigma2 = torch.maximum(
            sigma2, torch.square(torch.as_tensor(sigma_floor_m, dtype=f32, device=dev))
        )
    sandwich = torch.einsum("...kb,...lb->...kl", m_inv_g, m_inv_g)
    cov_enu = sigma2[..., None, None] * sandwich
    # degenerate geometry can overflow f32: clamp to a finite
    # "no information" bound (1e16 m² ⇒ 1e8 m axes)
    cov_enu = torch.clamp(
        torch.nan_to_num(cov_enu, nan=1e16, posinf=1e16, neginf=-1e16), -1e16, 1e16
    )
    major, minor, bearing = error_ellipse_from_cov(cov_enu)

    return SolveResult(
        position_enu=x,
        cost=cost,
        residual_rms_m=torch.sqrt(cost),
        grad_norm=grad_norm,
        converged=grad_norm < grad_tol,
        num_measurements=num_measurements,
        cov_enu=cov_enu,
        ellipse_major_m=major,
        ellipse_minor_m=minor,
        ellipse_orientation_deg=bearing,
    )


def tau_to_distance_difference(tau_s: torch.Tensor) -> torch.Tensor:
    """c·τ."""
    return tau_s * SPEED_OF_LIGHT_M_S
