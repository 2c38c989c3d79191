"""Batched 1D short-characteristics formal solvers.

Accelerator-native design: the reference's per-ray sequential C++ solvers
(ref: /root/reference/Source/FormalScalar.cpp:136-667) are re-expressed as

  1. dense, batched per-depth-point coefficient computation: every solver
     (piecewise linear, cubic Bezier-3, BESSER) yields an affine recurrence
         I_m = A_m * I_{m-1} + b_m          (m in sweep order)
     with A, b closed-form tensors over [batch, Ndep];
  2. a single shared linear-recurrence solve, either `lax.scan` over depth
     (sequential, batch-vectorized over thousands of rays) or
     `lax.associative_scan` (parallel in depth).

The diagonal approximate operator Psi* falls out of the same coefficients.
All quantities follow the reference numerics exactly
(ref: /root/reference/Source/LwInternal.hpp:90-110 `w2`,
 /root/reference/Source/Bezier.hpp `cent_deriv`/`Bezier3_coeffs`,
 /root/reference/Source/FormalScalar.cpp:327-467 BESSER).

Index conventions: depth index k runs 0 (top of atmosphere) to Ndep-1
(bottom).  A sweep in direction `to_obs=True` (upgoing ray) starts at the
bottom; `to_obs=False` starts at the top.  Internally everything is
computed in *sweep order* (index m: m=0 is the sweep start) and flipped
back at the end.
"""
from functools import partial

import jax
import jax.numpy as jnp


def w2(dtau):
    """Linear short-characteristics integration weights (w0, w1).

    ref: /root/reference/Source/LwInternal.hpp:90-110
    """
    # scalar bounds in the input dtype: Python floats passed to
    # jnp.clip/jnp.where bind as f64 constants under x64, which would
    # put f64 converts into the f32 program
    one = jnp.asarray(1.0, dtau.dtype)
    third = 1.0 / 3.0
    small = dtau < 5.0e-4
    big = dtau > 50.0
    dtau_safe = jnp.clip(dtau, jnp.zeros_like(one), 50.0 * one)
    expdt = jnp.exp(-dtau_safe)
    w0_mid = 1.0 - expdt
    w1_mid = w0_mid - dtau_safe * expdt
    w0_small = dtau * (1.0 - 0.5 * dtau)
    w1_small = dtau * dtau * (0.5 - dtau * third)
    w0 = jnp.where(small, w0_small, jnp.where(big, one, w0_mid))
    w1 = jnp.where(small, w1_small, jnp.where(big, one, w1_mid))
    return w0, w1


def cent_deriv(dsuw, dsdw, yuw, y0, ydw):
    """Steffen (1990) monotonic central derivative.

    ref: /root/reference/Source/Bezier.hpp:57-66
    """
    S0 = (ydw - y0) / dsdw
    Suw = (y0 - yuw) / dsuw
    P0 = jnp.abs((Suw * dsdw + S0 * dsuw) / (dsdw + dsuw))
    return ((jnp.sign(S0) + jnp.sign(Suw))
            * jnp.minimum(jnp.abs(Suw), jnp.minimum(jnp.abs(S0), 0.5 * P0)))


def bezier3_coeffs(dt):
    """Cubic Bezier integration coefficients (alpha, beta, gamma, delta, edt).

    alpha:S_uw, beta:S_0, gamma:C_uw, delta:C_0, edt:exp(-dtau).
    Taylor branch for dt < 5e-2, asymptotic branch for dt > 30.
    ref: /root/reference/Source/Bezier.hpp:81-127
    """
    dt2 = dt * dt
    dt3 = dt2 * dt
    small = dt < 5e-2
    big = dt > 30.0

    # Guard divisions/exp in unselected branches: the mid branch needs dt
    # clipped into [5e-2, 30]; the asymptotic branch must use the TRUE dt
    # (only guarded against division by zero from below).
    # dtype-matched clip bounds (see w2)
    one = jnp.asarray(1.0, dt.dtype)
    dt_m = jnp.clip(dt, 5e-2 * one, 30.0 * one)
    dt2_m = dt_m * dt_m
    dt3_m = dt2_m * dt_m
    edt_m = jnp.exp(-dt_m)

    a_small = 0.25 * dt - 0.2 * dt2 + dt3 / 12.0
    b_small = 0.25 * dt - 0.05 * dt2 + dt3 / 120.0
    g_small = 0.25 * dt - 0.15 * dt2 + 0.05 * dt3
    d_small = 0.25 * dt - 0.1 * dt2 + 0.025 * dt3
    e_small = 1.0 - dt + 0.5 * dt2 - dt3 / 6.0

    dt_b = jnp.maximum(dt, 5e-2)
    dt2_b = dt_b * dt_b
    dt3_b = dt2_b * dt_b
    a_big = 6.0 / dt3_b
    b_big = (-6.0 + 6.0 * dt_b - 3.0 * dt2_b + dt3_b) / dt3_b
    g_big = 3.0 * (2.0 * dt_b - 6.0) / dt3_b
    d_big = 3.0 * (6.0 - 4.0 * dt_b + dt2_b) / dt3_b
    e_big = jnp.zeros_like(dt)

    a_mid = (6.0 - edt_m * (6.0 + 6.0 * dt_m + 3.0 * dt2_m + dt3_m)) / dt3_m
    b_mid = (6.0 * edt_m - 6.0 + 6.0 * dt_m - 3.0 * dt2_m + dt3_m) / dt3_m
    g_mid = 3.0 * (2.0 * dt_m - 6.0 + edt_m * (6.0 + 4.0 * dt_m + dt2_m)) / dt3_m
    d_mid = 3.0 * (6.0 - 4.0 * dt_m + dt2_m - 2.0 * edt_m * (3.0 + dt_m)) / dt3_m

    def sel(s, b, m):
        return jnp.where(small, s, jnp.where(big, b, m))

    return (sel(a_small, a_big, a_mid), sel(b_small, b_big, b_mid),
            sel(g_small, g_big, g_mid), sel(d_small, d_big, d_mid),
            sel(e_small, e_big, edt_m))


def besser_control_point(hM, hP, yM, yO, yP):
    """BESSER (Stepan & Trujillo Bueno 2013) monotonic quadratic-Bezier
    control point.  ref: /root/reference/Source/FormalScalar.cpp:327-363
    """
    dM = (yO - yM) / hM
    dP = (yP - yO) / hP
    yOp = (hM * dP + hP * dM) / (hM + hP)
    cM = yO - 0.5 * hM * yOp
    cP = yO + 0.5 * hP * yOp

    incr = dM >= 0.0
    minYMO = jnp.where(incr, yM, yO)
    maxYMO = jnp.where(incr, yO, yM)
    minYOP = jnp.where(incr, yO, yP)
    maxYOP = jnp.where(incr, yP, yO)

    cM_bad = jnp.logical_or(cM < minYMO, cM > maxYMO)
    cP_bad = jnp.logical_or(cP < minYOP, cP > maxYOP)

    # if cP out of range: cP = yP, recompute cM
    cM_fixed = yO - 0.5 * hM * ((yP - yO) / (0.5 * hP))
    out = jnp.where(cM_bad, yM, jnp.where(cP_bad, cM_fixed, cM))
    return jnp.where(dM * dP <= 0.0, yO, out)


def besser_coeffs(t):
    """BESSER integration coefficients (M, O, C, edt) with Taylor branch
    t < 0.14.  ref: /root/reference/Source/FormalScalar.cpp:365-394
    """
    small = t < 0.14
    tm = jnp.clip(t, 0.14, None)
    t2 = tm * tm
    edt_m = jnp.exp(-jnp.minimum(tm, 200.0))
    m_mid = (2.0 - edt_m * (t2 + 2.0 * tm + 2.0)) / t2
    o_mid = 1.0 - 2.0 * (edt_m + tm - 1.0) / t2
    c_mid = 2.0 * (tm - 2.0 + edt_m * (tm + 2.0)) / t2

    m_small = (t * (t * (t * (t * (t * (t * ((140.0 - 18.0 * t) * t - 945.0)
               + 5400.0) - 25200.0) + 90720.0) - 226800.0) + 302400.0)) / 907200.0
    o_small = (t * (t * (t * (t * (t * (t * ((10.0 - t) * t - 90.0) + 720.0)
               - 5040.0) + 30240.0) - 151200.0) + 604800.0)) / 1814400.0
    c_small = (t * (t * (t * (t * (t * (t * ((35.0 - 4.0 * t) * t - 270.0)
               + 1800.0) - 10080.0) + 45360.0) - 151200.0) + 302400.0)) / 907200.0
    t3 = t * t * t
    e_small = (1.0 - t + 0.5 * t * t - t3 / 6.0 + t * t3 / 24.0
               - t * t * t3 / 120.0 + t3 * t3 / 720.0 - t3 * t3 * t / 5040.0)

    M = jnp.where(small, m_small, m_mid)
    O = jnp.where(small, o_small, o_mid)
    Cc = jnp.where(small, c_small, c_mid)
    edt = jnp.where(small, e_small, edt_m)
    return M, O, Cc, edt


def _affine_solve(A, b, mode='scan'):
    """Solve I_m = A_m I_{m-1} + b_m for all m, with I_0 = b_0 (A_0 = 0).

    A, b: [..., N] in sweep order.  Returns I: [..., N].
    """
    if mode == 'scan':
        def step(I_prev, ab):
            a, bb = ab
            I = a * I_prev + bb
            return I, I
        A_t = jnp.moveaxis(A, -1, 0)
        b_t = jnp.moveaxis(b, -1, 0)
        _, I_t = jax.lax.scan(step, jnp.zeros_like(b_t[0]), (A_t, b_t))
        return jnp.moveaxis(I_t, 0, -1)
    elif mode == 'parallel':
        def compose(x, y):
            ax, bx = x
            ay, by = y
            return ax * ay, ay * bx + by
        Ac, bc = jax.lax.associative_scan(compose, (A, b), axis=-1)
        return bc
    elif mode == 'blocked':
        # Two-level (Blelloch-style) scan: split depth into B blocks of
        # L; compose each block's affine maps in parallel across blocks
        # (sequential in L), chain the B block totals, then re-solve
        # each block from its start value.  Sequential latency drops
        # from N to 2L + B (~3 sqrt N) at ~5 streamed passes over the
        # coefficients — an order of magnitude less HBM traffic than
        # associative_scan's ~4 log2(N) passes.
        N = A.shape[-1]
        L = max(8, int(round(N ** 0.5)))
        B = -(-N // L)
        padN = B * L - N
        if padN:
            padW = [(0, 0)] * (A.ndim - 1) + [(0, padN)]
            A = jnp.pad(A, padW, constant_values=1.0)   # identity maps
            b = jnp.pad(b, padW)
        blkShape = A.shape[:-1] + (B, L)
        # scan axis leading: [L, ..., B]
        A_t = jnp.moveaxis(A.reshape(blkShape), -1, 0)
        b_t = jnp.moveaxis(b.reshape(blkShape), -1, 0)

        def compose_step(c, t):
            Ac, Bc = c
            a, bb = t
            return (a * Ac, a * Bc + bb), None

        ones = jnp.ones_like(A_t[0])
        (Atot, Btot), _ = jax.lax.scan(compose_step,
                                       (ones, jnp.zeros_like(ones)),
                                       (A_t, b_t))           # [..., B]

        def chain_step(J, t):
            a, bb = t
            J = a * J + bb
            return J, J

        At_b = jnp.moveaxis(Atot, -1, 0)                      # [B, ...]
        Bt_b = jnp.moveaxis(Btot, -1, 0)
        _, Jend = jax.lax.scan(chain_step, jnp.zeros_like(At_b[0]),
                               (At_b, Bt_b))                  # [B, ...]
        Jstart = jnp.concatenate([jnp.zeros_like(Jend[:1]), Jend[:-1]],
                                 axis=0)                      # [B, ...]
        Jstart = jnp.moveaxis(Jstart, 0, -1)                  # [..., B]

        def solve_step(Iprev, t):
            a, bb = t
            I = a * Iprev + bb
            return I, I

        _, I_t = jax.lax.scan(solve_step, Jstart, (A_t, b_t))  # [L, ..., B]
        I = jnp.moveaxis(I_t, 0, -1).reshape(A.shape[:-1] + (B * L,))
        return I[..., :N]
    else:
        raise ValueError(f'Unknown recurrence mode {mode}')


def _sweep_coeffs_linear(chi, S, ds):
    """Affine coefficients for piecewise-linear short characteristics.

    chi, S: [B, N] in sweep order; ds: [B, N-1] path length of interval
    (m, m+1) already divided by |mu|.  Returns A, b, Psi, bNL ([B, N]);
    Psi is not yet divided by chi.  bNL is the non-local part of b,
    bNL = b - Psi*chi*S_0, expressed WITHOUT the cancelling subtraction:
    for the linear step b - (w0 - w1/dtau) S_0 = (w1/dtau) S_uw, so the
    MALI effective intensity Ieff = A I_uw + bNL + Psi*chi*(S_0 - S_atom)
    avoids the catastrophic I - Psi*eta cancellation in optically-thick
    regions (which stalls f32 at dJ ~ 1e-2).
    ref: /root/reference/Source/FormalScalar.cpp:136-207
    """
    # dtau of interval (m-1, m), defined for m >= 1
    dtau = 0.5 * (chi[..., :-1] + chi[..., 1:]) * ds       # [B, N-1]
    dS = (S[..., :-1] - S[..., 1:]) / dtau                 # (S_uw - S_m)/dtau
    w0, w1 = w2(dtau)
    pad0 = [(0, 0)] * (chi.ndim - 1) + [(1, 0)]
    A = jnp.pad(1.0 - w0, pad0)
    b_interior = w0 * S[..., 1:] + w1 * dS
    b = jnp.pad(b_interior, pad0)
    Psi = jnp.pad(w0 - w1 / dtau, pad0)
    bNL = jnp.pad((w1 / dtau) * S[..., :-1], pad0)
    return A, b, Psi, bNL


def _one_sided_deriv(y0, y1, ds):
    return (y1 - y0) / ds


def _point_derivs(y, ds):
    """Per-point derivatives: Steffen central at interior, one-sided at ends.

    y: [B, N]; ds: [B, N-1] interval widths. Returns [B, N].
    """
    d_int = cent_deriv(ds[..., :-1], ds[..., 1:],
                       y[..., :-2], y[..., 1:-1], y[..., 2:])
    d0 = _one_sided_deriv(y[..., 0], y[..., 1], ds[..., 0])[..., None]
    dN = _one_sided_deriv(y[..., -2], y[..., -1], ds[..., -1])[..., None]
    return jnp.concatenate([d0, d_int, dN], axis=-1)


def _sweep_coeffs_bezier3(chi, S, ds):
    """Affine coefficients for the cubic-Bezier (DELO-Bezier3 scalar) solver.

    ref: /root/reference/Source/FormalScalar.cpp:209-325
    Interior points m = 1..N-2 use Bezier-3; the final point m = N-1 falls
    back to the linear w2 step (with the plain-average dtau).
    """
    n = chi.shape[-1]
    pad0 = [(0, 0)] * (chi.ndim - 1) + [(1, 0)]

    # chi control points per interval (m, m+1), m = 0..N-2
    dchi = _point_derivs(chi, ds)                          # [B, N]
    Cuw = chi[..., :-1] + (ds / 3.0) * dchi[..., :-1]
    C0 = chi[..., 1:] - (ds / 3.0) * dchi[..., 1:]
    dtau = ds * (chi[..., :-1] + chi[..., 1:] + Cuw + C0) * 0.25  # [B, N-1]

    # S derivatives wrt tau: one-sided at m=0, Steffen central interior.
    dS = _point_derivs(S, dtau)                            # [B, N]

    # Interval (m-1, m) quantities for interior target points m = 1..N-2
    dt_uw = dtau[..., :-1]                                 # [B, N-2]
    alpha, beta, gamma, delta, edt = bezier3_coeffs(dt_uw)
    CuwS = S[..., :-2] + (dt_uw / 3.0) * dS[..., :-2]
    C0S = S[..., 1:-1] - (dt_uw / 3.0) * dS[..., 1:-1]
    b_bez = (alpha * S[..., :-2] + beta * S[..., 1:-1]
             + gamma * CuwS + delta * C0S)
    A_bez = edt
    Psi_bez = beta + delta
    # non-local part of b: b - (beta+delta) S_0 without cancellation
    bNL_bez = (alpha * S[..., :-2] + gamma * CuwS
               - delta * (dt_uw / 3.0) * dS[..., 1:-1])

    # Final point: linear step with plain-average dtau.
    dtau_end = 0.5 * (chi[..., -1] + chi[..., -2]) * ds[..., -1]
    dS_end = (S[..., -1] - S[..., -2]) / dtau_end
    w0e, w1e = w2(dtau_end)
    A_end = (1.0 - w0e)[..., None]
    b_end = (w0e * S[..., -1] - w1e * dS_end)[..., None]
    Psi_end = (w0e - w1e / dtau_end)[..., None]
    bNL_end = ((w1e / dtau_end) * S[..., -2])[..., None]

    A = jnp.pad(jnp.concatenate([A_bez, A_end], axis=-1), pad0)
    b = jnp.pad(jnp.concatenate([b_bez, b_end], axis=-1), pad0)
    Psi = jnp.pad(jnp.concatenate([Psi_bez, Psi_end], axis=-1), pad0)
    bNL = jnp.pad(jnp.concatenate([bNL_bez, bNL_end], axis=-1), pad0)
    return A, b, Psi, bNL


def _sweep_coeffs_besser(chi, S, ds):
    """Affine coefficients for the BESSER solver.

    ref: /root/reference/Source/FormalScalar.cpp:396-467
    Interior points m = 1..N-2 use BESSER; final point linear.
    """
    pad0 = [(0, 0)] * (chi.ndim - 1) + [(1, 0)]

    # For target point m (1..N-2): uw interval (m-1, m), dw interval (m, m+1)
    ds_uw = ds[..., :-1]
    ds_dw = ds[..., 1:]
    chi_uw = chi[..., :-2]
    chi_0 = chi[..., 1:-1]
    chi_dw = chi[..., 2:]
    chiC = besser_control_point(ds_uw, ds_dw, chi_uw, chi_0, chi_dw)
    dtau_uw = (1.0 / 3.0) * (chi_uw + chiC + chi_0) * ds_uw
    dtau_dw = 0.5 * (chi_0 + chi_dw) * ds_dw

    S_uw = S[..., :-2]
    S_0 = S[..., 1:-1]
    S_dw = S[..., 2:]
    SC = besser_control_point(dtau_uw, dtau_dw, S_uw, S_0, S_dw)
    M, O, Cc, edt = besser_coeffs(dtau_uw)
    A_bes = edt
    b_bes = M * S_uw + O * S_0 + Cc * SC
    Psi_bes = O + Cc
    bNL_bes = M * S_uw + Cc * (SC - S_0)

    dtau_end = 0.5 * (chi[..., -1] + chi[..., -2]) * ds[..., -1]
    dS_end = (S[..., -1] - S[..., -2]) / dtau_end
    w0e, w1e = w2(dtau_end)
    A_end = (1.0 - w0e)[..., None]
    b_end = (w0e * S[..., -1] - w1e * dS_end)[..., None]
    Psi_end = (w0e - w1e / dtau_end)[..., None]
    bNL_end = ((w1e / dtau_end) * S[..., -2])[..., None]

    A = jnp.pad(jnp.concatenate([A_bes, A_end], axis=-1), pad0)
    b = jnp.pad(jnp.concatenate([b_bes, b_end], axis=-1), pad0)
    Psi = jnp.pad(jnp.concatenate([Psi_bes, Psi_end], axis=-1), pad0)
    bNL = jnp.pad(jnp.concatenate([bNL_bes, bNL_end], axis=-1), pad0)
    return A, b, Psi, bNL


_COEFF_FNS = {
    'piecewise_linear_1d': _sweep_coeffs_linear,
    'piecewise_bezier3_1d': _sweep_coeffs_bezier3,
    'piecewise_besser_1d': _sweep_coeffs_besser,
}

SOLVER_NAMES_1D = tuple(_COEFF_FNS)


@partial(jax.jit, static_argnames=('to_obs', 'method', 'mode',
                                   'compute_operator'))
def formal_sol_1d(chi, S, height, muz, I_upw, to_obs=True,
                  method='piecewise_bezier3_1d', mode='scan',
                  compute_operator=True):
    """Batched 1D formal solution along depth for many rays at once.

    Parameters
    ----------
    chi, S : [B, Ndep] opacity and source function per ray (k=0 is the top).
    height : [Ndep] or [B, Ndep] geometric height (decreasing with k).
    muz : [B] |mu| of each ray.
    I_upw : [B] upwind boundary intensity at the sweep start.
    to_obs : sweep direction; True = bottom-to-top (upgoing).

    Returns
    -------
    I : [B, Ndep] specific intensity (original depth indexing).
    Psi : [B, Ndep] diagonal approximate lambda operator (divided by chi),
          or None if compute_operator is False.
    """
    if height.ndim < chi.ndim:
        height = jnp.broadcast_to(height, chi.shape)
    if to_obs:
        chi_s = chi[..., ::-1]
        S_s = S[..., ::-1]
        h_s = height[..., ::-1]
    else:
        chi_s, S_s, h_s = chi, S, height

    ds = jnp.abs(h_s[..., 1:] - h_s[..., :-1]) / muz[..., None]
    A, b, Psi, bNL = _COEFF_FNS[method](chi_s, S_s, ds)
    b = b.at[..., 0].set(I_upw)
    I_s = _affine_solve(A, b, mode=mode)

    if compute_operator:
        # Ieff base = I - Psi*chi*S_0 assembled WITHOUT the cancelling
        # subtraction: A*I_upwind + non-local source terms.  At the sweep
        # start Psi = 0 and Ieff = I = I_upw.
        I_shift = jnp.concatenate(
            [I_upw[..., None], I_s[..., :-1]], axis=-1)
        ieffb = A * I_shift + bNL.at[..., 0].set(I_upw)

    if to_obs:
        I = I_s[..., ::-1]
        Psi = Psi[..., ::-1]
        if compute_operator:
            ieffb = ieffb[..., ::-1]
    else:
        I = I_s

    if compute_operator:
        Psi = Psi / chi
        return I, Psi, ieffb
    return I, None, None
