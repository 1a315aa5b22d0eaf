"""What the port's tests and ``chip_smoke.py`` share with the package: a
cap on CPU threads, the comparison of two top-K blocks, seeded LM
problems, the LM kernel's arithmetic in numpy float32, and delayed noise
captures for the pair stage.

The test suite runs in several worker processes at once, beside tests of
live services with deadlines. PyTorch's CPU operators would otherwise
each spread over every core of the machine; every ``tests/test_torch_*``
module calls :func:`cap_cpu_threads` when it is imported.

One thread, not two: with two intra-op threads, PyTorch's CPU build on
an AMX-capable Xeon returned wrong float32 products (MKL's AVX-512/AMX
path) in a few fresh processes in a hundred. The kernel wrappers run
their plain versions at one thread themselves
(:func:`radio_mapper_tpu_torch.device.cpu_single_thread`); the cap keeps
the tests' other torch code at one thread too.
"""

from __future__ import annotations

import numpy as np
import torch

TEST_THREADS = 1


def cap_cpu_threads(n: int = TEST_THREADS) -> None:
    """Cap PyTorch's intra-op CPU threads of this process at ``n``."""
    torch.set_num_threads(n)


def topk_errors(out, ref, rmax: torch.Tensor, k: int, spec_rel: float = 1e-5):
    """Compare top-K blocks (``[rows, 128]`` values and packed 8·f + off, as
    kernels K1 and K4 write them with ``emit_topk = k``) made from spectra
    that differ by float32 rounding: ``(value max |err|, that over the
    row's max power rmax, packed mismatches outside near-ties and nonzero
    lanes past k, share of the k lanes checked)``.

    A lane is a near-tie where its reference value lies within twice the
    move that a spectrum within ``spec_rel`` of the row's max |X| gives a
    power v (2·sqrt(v·rmax)·spec_rel) of a neighbour's in the ranking:
    there the two sides may rank two segments either way.
    """
    vals, packed = (x.double() for x in out)
    rv, rp = (x.double() for x in ref)
    pmax = rmax.double().reshape(-1, 1)
    fin = torch.isfinite(rv)
    zero = torch.zeros_like(rv)
    err = torch.where(fin, (vals - rv).abs(), zero)
    move = torch.where(fin, 2 * torch.sqrt(torch.where(fin, rv, zero).abs() * pmax) * spec_rel, zero)
    d = (rv[:, 1:] - rv[:, :-1]).abs() - move[:, 1:] - move[:, :-1]
    d = torch.where(torch.isnan(d), torch.full_like(d, float("inf")), d)
    gap = torch.full_like(rv, float("inf"))
    gap[:, 1:] = torch.minimum(gap[:, 1:], d)
    gap[:, :-1] = torch.minimum(gap[:, :-1], d)
    solid = (~fin | (gap > 0))[:, :k]
    bad = int(((packed[:, :k] != rp[:, :k]) & solid).sum())
    bad += int((torch.isfinite(vals) != fin).sum() + (vals[:, k:] != 0).sum() + (packed[:, k:] != 0).sum())
    return err.max().item(), (err / pmax).max().item(), bad, solid.float().mean().item()


def lm_problems(lead, b, seed, *, pairs=None, noise_m=5.0, edit=None):
    """Seeded TDOA problems for the LM: anchors ``[b, 3]`` on a 10 km ring,
    emitters ``[*lead, 3]`` within 6 km of its centre and their distance
    differences with Gaussian noise of ``noise_m`` and weights in [0.2, 1]
    ``[*lead, P]``, on every pair of receivers or on ``pairs`` (i, j).
    ``edit`` (``lead`` of one dim, at least 8 problems): "heights" puts
    the receivers 0–300 m up; "zero_row" zeroes problem 5's weights (the
    solver's uniform fallback) and problem 7's first three; "nan" puts NaN
    in problem 3's first measurement (carried into its start and lam) and
    problem 4's sixth (a NaN cost); "collinear" lines the receivers up on
    the East axis. Returns CPU tensors ``(anchors, pair_i, pair_j, dd,
    w)``."""
    rng = np.random.default_rng(seed)
    ang = 2 * np.pi * np.arange(b) / b + rng.uniform(0, 0.3, b)
    anchors = np.stack([1e4 * np.cos(ang), 1e4 * np.sin(ang), np.zeros(b)], -1).astype(np.float32)
    pi, pj = (np.asarray(a) for a in (pairs or np.triu_indices(b, k=1)))
    emit = rng.uniform(-6e3, 6e3, (*lead, 3))
    emit[..., 2] = 0.0
    dist = np.linalg.norm(emit[..., None, :] - anchors.astype(np.float64), axis=-1)
    dd = dist[..., pi] - dist[..., pj] + rng.normal(0, noise_m, (*lead, len(pi)))
    w = rng.uniform(0.2, 1.0, dd.shape)
    if edit == "heights":
        anchors[:, 2] = np.linspace(0.0, 300.0, b)
    elif edit == "zero_row":
        w[5] = 0.0
        w[7, :3] = 0.0
    elif edit == "nan":
        dd[3, 0] = dd[4, 5] = np.nan
    elif edit == "collinear":
        anchors[:, 1] = 0.0
    elif edit is not None:
        raise ValueError(f"unknown edit {edit!r}")
    t = lambda a, dt=torch.float32: torch.as_tensor(np.ascontiguousarray(a), dtype=dt)
    return t(anchors), t(pi, torch.int64), t(pj, torch.int64), t(dd), t(w)


def lm_emulate(anchors, pair_i, pair_j, dd, w, wsum, x0, *, iterations: int, solve_2d: bool, lanes: int = 0):
    """``csrc/lm_solve.cu``'s arithmetic in numpy float32, operation by
    operation, on N flat problems (numpy: ``anchors [N, B, 3]``, ``dd``,
    ``w [N, P]``, ``wsum [N]``, ``x0 [N, 3]``, ``pair_i``/``pair_j [P]``):
    ``(x [N, 3], cost [N])``. Every product, sum, quotient and square root
    is rounded to float32 on its own, as the kernel's ``__f*_rn``
    intrinsics round them, and the pair sums are taken in the kernel's
    order: pair by pair in index order (``lanes=0``, one thread a
    problem), or at ``lanes=32`` (one warp a problem) lane l's pairs l,
    l + 32, ... in order, then the lanes' partials by xor butterflies of
    16, 8, 4, 2, 1. So the kernel must equal it bit for bit. The formulas
    are :func:`..solver.lm_loop`'s."""
    f = np.float32
    anchors, dd, w, wsum, x0 = (np.asarray(a, dtype=f) for a in (anchors, dd, w, wsum, x0))
    pi, pj = np.asarray(pair_i), np.asarray(pair_j)
    n, p = dd.shape
    m = np.array([1, 1, 0 if solve_2d else 1], f)

    def total(terms):  # [N, P, ...] -> [N, ...], in the kernel's order
        if not lanes:
            acc = np.zeros((n, *terms.shape[2:]), f)
            for k in range(p):
                acc = acc + terms[:, k]
            return acc
        part = np.zeros((n, lanes, *terms.shape[2:]), f)
        for k0 in range(0, p, lanes):
            chunk = terms[:, k0:k0 + lanes]
            part[:, :chunk.shape[1]] = part[:, :chunk.shape[1]] + chunk
        o = lanes // 2
        while o:
            part = part + part[:, np.arange(lanes) ^ o]
            o //= 2
        return part[:, 0]

    def receivers(x):
        d = x[:, None, :] - anchors
        dist = np.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2])
        return dist, d / (dist + f(1e-9))[..., None]

    def cost_at(x):
        dist, _ = receivers(x)
        r = dist[:, pi] - dist[:, pj] - dd
        return total(w * r * r) / wsum

    def solve3(a, b):  # the adjugate over det, |det| floored at 1e-20
        A = lambda i, j: a[:, i, j]
        c00, c01, c02 = A(1, 1) * A(2, 2) - A(1, 2) * A(2, 1), A(1, 2) * A(2, 0) - A(1, 0) * A(2, 2), \
            A(1, 0) * A(2, 1) - A(1, 1) * A(2, 0)
        det = A(0, 0) * c00 + A(0, 1) * c01 + A(0, 2) * c02
        inv = f(1) / np.where(np.abs(det) < f(1e-20), f(1e-20), det)
        c10, c11, c12 = A(0, 2) * A(2, 1) - A(0, 1) * A(2, 2), A(0, 0) * A(2, 2) - A(0, 2) * A(2, 0), \
            A(0, 1) * A(2, 0) - A(0, 0) * A(2, 1)
        c20, c21, c22 = A(0, 1) * A(1, 2) - A(0, 2) * A(1, 1), A(0, 2) * A(1, 0) - A(0, 0) * A(1, 2), \
            A(0, 0) * A(1, 1) - A(0, 1) * A(1, 0)
        return np.stack([(c00 * b[:, 0] + c10 * b[:, 1] + c20 * b[:, 2]) * inv,
                         (c01 * b[:, 0] + c11 * b[:, 1] + c21 * b[:, 2]) * inv,
                         (c02 * b[:, 0] + c12 * b[:, 1] + c22 * b[:, 2]) * inv], -1)

    with np.errstate(all="ignore"):
        x = x0.copy()
        lam = f(1e-3) + f(0) * dd[:, 0]
        cost = cost_at(x)
        for _ in range(iterations):
            dist, u = receivers(x)
            r = dist[:, pi] - dist[:, pj] - dd
            jac = (u[:, pi] - u[:, pj]) * m
            wr = w * r
            g = total(jac * wr[..., None]) / wsum[:, None]
            h = total(jac[..., :, None] * (jac[..., None, :] * w[..., None, None])) / wsum[:, None, None]
            diag = np.diagonal(h, axis1=1, axis2=2)
            damp = lam[:, None] * np.where(diag < f(1e-6), f(1e-6), diag) + f(1e-6)
            xn = x + solve3(h + np.eye(3, dtype=f) * damp[:, None, :], -g) * m
            cn = cost_at(xn)
            better = cn < cost
            x = np.where(better[:, None], xn, x)
            lam = np.where(better, lam * f(0.3), lam * f(3.0))
            lam = np.where(lam < f(1e-8), f(1e-8), np.where(lam > f(1e8), f(1e8), lam))
            cost = np.where(np.isnan(cost) | np.isnan(cn), f(np.nan), np.where(cn < cost, cn, cost))
    return x, cost


def delayed_noise(chans: int, receivers: int, length: int, max_delay: int, *, seed: int,
                  device="cpu", noise: float = 1.0):
    """Captures with one correlation peak a pair: each channel's receivers
    hear one complex white source, receiver b advanced by an integer
    ``d[c, b]`` in [−max_delay, max_delay] samples, plus their own white
    noise of ``noise`` times the source's power. Returns ``(re, im, d)``:
    float32 ``[chans, receivers, length]`` strided views of one interleaved
    buffer, as ``ops.iq.decode_uint8_split`` returns them, and ``d``; pair
    (i, j)'s lag (x = i) is d[j] − d[i]. Drawn by a ``torch.Generator`` on
    ``device`` from ``seed``."""
    g = torch.Generator(device=device).manual_seed(seed)
    src = torch.randn((chans, length + 2 * max_delay, 2), generator=g, device=device)
    d = torch.randint(-max_delay, max_delay + 1, (chans, receivers), generator=g, device=device)
    at = max_delay + d[..., None] + torch.arange(length, device=device)
    x = src[torch.arange(chans, device=device)[:, None, None], at]
    x += noise ** 0.5 * torch.randn(x.shape, generator=g, device=device)
    return x[..., 0], x[..., 1], d

