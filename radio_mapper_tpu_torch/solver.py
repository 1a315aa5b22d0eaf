"""Batched hyperbolic (TDOA) Levenberg-Marquardt positioning.

Port of ``radio_mapper_tpu/solver.py`` (``solve_tdoa_impl`` with both
noise models and its pair-parallel mode, a ``psum`` callable in place of
the ``axis_name``, and its public name ``solve_tdoa``;
``perturbed_starts``, ``solve_tdoa_multistart`` and
``pair_weights_from_confidence``). The fixed-count LM runs in one of
two ways, by where its inputs lie. On the card with no ``psum`` it is one
CUDA launch (:mod:`.ops.cuda.lm_solve`: every iteration of every problem,
the loop's arithmetic in float32). On the CPU, and with ``psum`` (the
cross-rank sum each iteration needs), it is :func:`lm_loop`, a Python loop
of branchless ``torch.where`` updates. Neither path synchronises with the
host: the set-up builds every constant on the device, so on the card the
solve is enqueued behind the kernels before it and the host runs on. The
spans ``solve.prep``, ``solve.lm`` and, around the kernel's launch,
``solve.lm.kernel`` (:mod:`.utils.spans`) time the set-up and the LM of a
traced step.

Measurement model: for pair (i, j) with delay τ_ij (receiver i heard the
signal later ⇒ τ_ij > 0), ``dd_ij = c·τ_ij ≈ ‖x − p_i‖ − ‖x − p_j‖``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from radio_mapper_tpu_torch.constants import SPEED_OF_LIGHT_M_S
from radio_mapper_tpu_torch.ops.cuda import lm_solve
from radio_mapper_tpu_torch.utils import spans


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


def _on_card(t: torch.Tensor) -> bool:
    """Whether ``t`` lies on a CUDA device: the LM's kernel route."""
    return t.device.type == "cuda"


def _dim_mask(solve_2d: bool, dev: torch.device) -> torch.Tensor:
    """``[1, 1, 0]`` (Up frozen) or ``[1, 1, 1]``, made on ``dev``: no copy
    from host memory, which on the card would wait for the queue."""
    return (torch.arange(3, device=dev) < (2 if solve_2d else 3)).to(torch.float32)


def lm_setup(
    anchors_enu: torch.Tensor,
    pair_i: torch.Tensor,
    pair_j: torch.Tensor,
    dd_m: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    *,
    init_enu: Optional[torch.Tensor] = None,
    psum: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
):
    """The LM's inputs as :func:`lm_loop` and the kernel take them:
    ``(anchors, pair_i, pair_j, dd, w, wsum, x0)``, float32 (the pair
    indices int64) on ``dd_m``'s device; :func:`solve_tdoa_impl`'s
    arguments of the same names."""
    dev = dd_m.device
    f32 = torch.float32
    anchors_enu = anchors_enu.to(f32)
    dd_m = dd_m.to(f32)
    pair_i = pair_i.to(device=dev, dtype=torch.int64)
    pair_j = pair_j.to(device=dev, dtype=torch.int64)
    w = torch.ones_like(dd_m) if weights is None else torch.clamp(weights.to(f32), min=0.0)
    _psum = psum if psum is not None else (lambda x: x)
    # All-zero weights would freeze the solver at its initial guess; degrade
    # to uniform weighting (the measurements still carry geometry). With
    # psum the check is global: a rank whose pairs are all masked still
    # has live measurements elsewhere.
    w_total = _psum(w.sum(dim=-1, keepdim=True))
    w = torch.where(w_total > 1e-9, w, torch.ones_like(w))
    x0 = anchors_enu.mean(dim=-2) if init_enu is None else init_enu.to(f32)
    batch_shape = torch.broadcast_shapes(x0.shape[:-1], dd_m.shape[:-1])
    x0 = x0.expand(*batch_shape, 3)
    if psum is None:
        x0 = x0 + 0.0 * dd_m[..., :1]  # as the reference
    wsum = _psum(w.sum(dim=-1)) + 1e-12
    return anchors_enu, pair_i, pair_j, dd_m, w, wsum, x0


def lm_loop(
    anchors_enu: torch.Tensor,
    pair_i: torch.Tensor,
    pair_j: torch.Tensor,
    dd_m: torch.Tensor,
    w: torch.Tensor,
    wsum: torch.Tensor,
    x0: torch.Tensor,
    *,
    iterations: int,
    solve_2d: bool,
    psum: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
):
    """The LM's iterations from ``x0`` as an eager loop: ``(x, cost)``,
    on the inputs :func:`lm_setup` makes."""
    dev = dd_m.device
    f32 = torch.float32
    _psum = psum if psum is not None else (lambda x: x)

    def _psum_gh(g_loc, h_loc):
        """``(Σg, Σh)`` through one sum of 12 floats per batch element."""
        if psum is None:
            return g_loc, h_loc
        s = psum(torch.cat([g_loc, h_loc.flatten(-2)], dim=-1))
        return s[..., :3], s[..., 3:].unflatten(-1, (3, 3))

    dim_mask = _dim_mask(solve_2d, dev)
    eye = torch.eye(3, dtype=f32, device=dev)

    def cost_fn(x):
        r, _ = _residuals_and_jac(x, anchors_enu, pair_i, pair_j, dd_m)
        return _psum((w * r * r).sum(dim=-1)) / wsum

    x = x0
    lam = torch.full(dd_m.shape[:-1], 1e-3, dtype=f32, device=dev)
    if psum is None:
        lam = lam + 0.0 * dd_m[..., 0]
    cost = cost_fn(x0)
    for _ in range(iterations):
        r, jac = _residuals_and_jac(x, anchors_enu, pair_i, pair_j, dd_m)
        jac = jac * dim_mask  # frozen dims contribute nothing
        g, h = _psum_gh(
            torch.einsum("...pk,...p->...k", jac, w * r),
            torch.einsum("...pk,...pl->...kl", jac, jac * w.unsqueeze(-1)),
        )
        g = g / wsum.unsqueeze(-1)
        h = h / wsum[..., None, None]
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
    return x, cost


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
    noise_model: str = "receiver",
    sigma_m: Optional[torch.Tensor] = None,
    sigma_floor_m: Optional[torch.Tensor] = None,
    psum: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> SolveResult:
    """Levenberg-Marquardt hyperbolic solve, batched over leading dims.

    Args:
      anchors_enu: ``[..., B, 3]`` receiver ENU positions.
      pair_i/pair_j: ``[P]`` integer receiver indices per measurement.
      dd_m: ``[..., P]`` measured distance differences c·τ (meters).
      weights: ``[..., P]`` non-negative weights; 0 masks a measurement.
      init_enu: ``[..., 3]`` initial guess; default the anchor centroid.
      solve_2d: freeze the Up component at its initial value.
      noise_model: ``"receiver"`` (default): noise per receiver, so the
        all-pairs dd measurements are correlated through the
        pair-differencing matrix A, and the covariance is the GLS sandwich
        Cov = σ_r²·M⁻¹(JᵀWA)(JᵀWA)ᵀM⁻¹, σ_r² estimated without bias;
        ``"pair"``: independent per-pair noise, Cov = σ_p²·M⁻¹ with σ_p² =
        Σwr² / max(measurements − unknowns, 1).
      sigma_m / sigma_floor_m: known 1σ noise (per receiver, or per
        unit-weight pair) / its floor.
      psum: pair-parallel (EP) mode: this rank holds a slice of the
        measurements, and ``psum(x)`` returns the sum of ``x`` over the
        ranks that hold the others (:func:`..parallel.collectives.psum`).
        The normal equations, the cost and the counts are sums over
        measurements, so every rank takes the identical step: per LM
        iteration one 12-float sum of the gradient and the normal matrix,
        and one of the cost.
    """
    if noise_model not in ("receiver", "pair"):
        raise ValueError(f"unknown noise_model {noise_model!r}")
    with spans.span("solve.prep"):
        lm_args = lm_setup(anchors_enu, pair_i, pair_j, dd_m, weights, init_enu=init_enu, psum=psum)
    with spans.span("solve.lm"):
        if psum is None and _on_card(dd_m):
            x, cost = lm_solve.lm_solve(*lm_args, iterations=iterations, solve_2d=solve_2d)
        else:
            x, cost = lm_loop(*lm_args, iterations=iterations, solve_2d=solve_2d, psum=psum)

    anchors_enu, pair_i, pair_j, dd_m, w, wsum, _ = lm_args
    dev = dd_m.device
    f32 = torch.float32
    _psum = psum if psum is not None else (lambda x: x)
    dim_mask = _dim_mask(solve_2d, dev)
    r, jac = _residuals_and_jac(x, anchors_enu, pair_i, pair_j, dd_m)
    jac = jac * dim_mask
    g = _psum(torch.einsum("...pk,...p->...k", jac, w * r)) / wsum.unsqueeze(-1)
    grad_norm = torch.linalg.vector_norm(g, dim=-1)
    num_measurements = _psum((w > 0).sum(dim=-1))

    # -- error ellipse from the undamped normal matrix
    m_u = _psum(torch.einsum("...pk,...pl->...kl", jac, jac * w.unsqueeze(-1)))
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
    if noise_model == "receiver":
        # A[p, r] = +1 at pair_i[p], −1 at pair_j[p]
        num_receivers = anchors_enu.shape[-2]
        a_mat = (
            torch.nn.functional.one_hot(pair_i, num_receivers).to(f32)
            - torch.nn.functional.one_hot(pair_j, num_receivers).to(f32)
        )
        g = _psum(torch.einsum("...pk,pb->...kb", jac * w.unsqueeze(-1), a_mat))
        # unbiased σ_r²: E[Σwr²] = σ_r²·(2·wsum − tr(GᵀM⁻¹G))
        m_inv_g = torch.einsum("...kl,...lb->...kb", m_inv, g)
        denom = 2.0 * wsum - torch.einsum("...kb,...kb->...", g, m_inv_g)
        sigma2 = wrr / torch.clamp(denom, min=0.25)
    else:
        n_unknowns = 2 if solve_2d else 3
        sigma2 = wrr / torch.clamp(num_measurements.to(f32) - n_unknowns, min=1.0)
    if sigma_m is not None:
        sigma2 = torch.square(torch.as_tensor(sigma_m, dtype=f32, device=dev)).expand(sigma2.shape)
    if sigma_floor_m is not None:
        sigma2 = torch.maximum(
            sigma2, torch.square(torch.as_tensor(sigma_floor_m, dtype=f32, device=dev))
        )
    if noise_model == "receiver":
        cov_enu = sigma2[..., None, None] * torch.einsum("...kb,...lb->...kl", m_inv_g, m_inv_g)
    else:
        cov_enu = sigma2[..., None, None] * m_inv
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


# The reference's public (jitted) name for the solve.
solve_tdoa = solve_tdoa_impl


def perturbed_starts(anchors_enu: torch.Tensor, num_starts: int, spread_m: float = 0.0) -> torch.Tensor:
    """Deterministic multi-start seeds ``[num_starts, ..., 3]``: start 0 is
    the anchor centroid; start k>0 sits beyond anchor (k−1) mod B along
    the centroid→anchor ray (catching emitters outside the array hull)."""
    centroid = anchors_enu.mean(dim=-2)
    b = anchors_enu.shape[-2]
    starts = [centroid]
    for k in range(1, num_starts):
        a = anchors_enu[..., (k - 1) % b, :]
        starts.append(centroid + 2.5 * (a - centroid) + spread_m)
    return torch.stack(starts, dim=0)


# Final costs of the starts this close to the lowest, relative, are one tie:
# ~80 float32 ulps, room for a cost's sum over the pairs rounded in another
# order, and far below what separates two distinct minima in practice.
STARTS_TIE_RTOL = 1e-5


def best_start(cost: torch.Tensor) -> torch.Tensor:
    """The start :func:`solve_tdoa_multistart` keeps, ``[...]``, from the
    starts' final costs ``[S, ...]``: the first within ``STARTS_TIE_RTOL``
    of the lowest, a NaN cost counting as the lowest."""
    cost = torch.where(torch.isnan(cost), float("-inf"), cost)
    low = cost.amin(dim=0, keepdim=True)
    tie = torch.where(torch.isfinite(low), low + STARTS_TIE_RTOL * low.abs(), low)
    first = torch.arange(cost.shape[0], device=cost.device).reshape(-1, *(1,) * (cost.dim() - 1))
    return torch.where(cost <= tie, first, cost.shape[0]).amin(dim=0)


def solve_tdoa_multistart(
    anchors_enu: torch.Tensor,
    pair_i: torch.Tensor,
    pair_j: torch.Tensor,
    dd_m: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    *,
    num_starts: int = 4,
    **kwargs,
) -> SolveResult:
    """:func:`solve_tdoa_impl` from :func:`perturbed_starts`, keeping the
    lowest final cost. Costs within ``STARTS_TIE_RTOL`` of the lowest are
    a tie, which the lowest start index wins: starts that end at one point
    reach costs a few float32 roundings apart, in an order that the sums'
    order decides (the card's kernel and the CPU's loop differ there), and
    in 2-D each start keeps its own Up. A NaN cost counts as the lowest
    (as ``jnp.argmin``).

    The starts run as one batched solve on a new leading axis."""
    anchors_enu = anchors_enu.to(torch.float32)
    lead = [anchors_enu.shape[:-2], dd_m.shape[:-1]]
    if weights is not None:
        lead.append(weights.shape[:-1])
    batch = (num_starts, *torch.broadcast_shapes(*lead))
    over = lambda x, tail: x.expand(*batch, *tail)
    starts = perturbed_starts(anchors_enu, num_starts)  # [S, *anchor batch, 3]
    starts = starts.reshape(num_starts, *(1,) * (len(batch) + 1 - starts.dim()), *starts.shape[1:])
    res = solve_tdoa_impl(
        over(anchors_enu, anchors_enu.shape[-2:]),
        pair_i,
        pair_j,
        over(dd_m, dd_m.shape[-1:]),
        None if weights is None else over(weights, weights.shape[-1:]),
        init_enu=over(starts, (3,)),
        **kwargs,
    )
    best = best_start(res.cost)

    def take(field):
        idx = best.reshape(1, *best.shape, *(1,) * (field.dim() - 1 - best.dim()))
        return torch.take_along_dim(field, idx, dim=0)[0]

    return SolveResult(*(take(f) for f in res))


def tau_to_distance_difference(tau_s: torch.Tensor) -> torch.Tensor:
    """c·τ."""
    return tau_s * SPEED_OF_LIGHT_M_S


def pair_weights_from_confidence(
    conf_i: torch.Tensor, conf_j: torch.Tensor, timing_sigma_ns: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """min(conf_i, conf_j), times exp(−σ/100 µs) when a timing 1σ is given."""
    conf = torch.minimum(conf_i, conf_j)
    if timing_sigma_ns is not None:
        conf = conf * torch.exp(-torch.as_tensor(timing_sigma_ns, device=conf.device) / 100_000.0)
    return conf
