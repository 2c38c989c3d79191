"""2D short-characteristics formal solver (x periodic, z stratified).

Accelerator-native re-design of the reference's plane-by-plane sweep
(ref: /root/reference/Source/FormalScalar2d.cpp:434-706, intersection
geometry :1188-1327):

- The upwind-intersection geometry (which face, interpolation fraction,
  path length) depends only on (grid, mux, muz), so it is precomputed
  host-side as dense arrays instead of C++ stencil objects.
- Cells whose upwind point lies on the previous z-plane are data-parallel
  over x.  Cells whose upwind point lies on the x side face couple to the
  SAME plane's previous column: I(k,j) = A_j I(k,j-dj) + b_j -- an
  affine recurrence along x.  With periodic x this is a CYCLIC affine
  system, which we solve exactly with an associative ring scan; this
  replaces (and improves on) the reference's truncated long-characteristic
  substeps at the periodic seam.
- The outer z sweep is a lax.scan carrying the previous plane, batched
  over wavelength.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .formal_solver import besser_coeffs, besser_control_point, w2


def _besser_interp(yM, yO, yP, u):
    """Monotonic quadratic-Bezier interpolation between yM (u=0) and yO
    (u=1) with the third upwind point yP shaping the control point
    (uniform spacing).  ref: interp_besser_2d,
    /root/reference/Source/FormalScalar2d.cpp:297-434"""
    cM = besser_control_point(1.0, 1.0, yM, yO, yP)
    return (1.0 - u) ** 2 * yM + 2.0 * u * (1.0 - u) * cM + u ** 2 * yO


def build_geometry_2d(x, z, mux, muz, toObs, periodic=True):
    """Upwind-intersection geometry for one ray direction over the grid.

    x: [Nx] (increasing), z: [Nz] (decreasing with index, like height);
    mux, muz: ray direction for this (mu, toObs) (muz sign included).
    Returns dict of numpy arrays indexed in SWEEP order over planes
    (sweepZ[0] is the starting plane):
      axisZ [Nz-1, Nx] bool: upwind on x side face (couples in-plane),
      w      [Nz-1, Nx]: interpolation weight of the previous plane,
      ds     [Nz-1, Nx]: upwind path length,
      sweepZ [Nz]: z indices in sweep order,
      dj: x-sweep direction,
    plus the starting plane's DOWNWIND intersections (used by the
    thermalised z boundary exactly as the reference does,
    ref: FormalScalar2d.cpp:567-612 dw_intersection_2d:60-101):
      sAxisZ [Nx] bool: dw point on the x side face of column j+dj,
      sW     [Nx]: weight of the far point (next plane / next column),
      sDs    [Nx]: dw path length,
      sJ/sJn [Nx] int: anchor column and its dw-side neighbour (sJ != j
      only at the most-downwind column in non-periodic mode, which
      borrows its neighbour's intersection -- the reference's
      FormalScalar2d.cpp:586 hack).
    ref: /root/reference/Source/FormalScalar2d.cpp:102-142
    """
    Nx, Nz = len(x), len(z)
    dj = 1 if mux >= 0 else -1
    # sweep order: toObs sweeps towards larger height (decreasing k)
    if toObs:
        sweepZ = np.arange(Nz - 1, -1, -1)
    else:
        sweepZ = np.arange(Nz)

    dx = np.empty(Nx)
    if dj > 0:
        dx[1:] = x[1:] - x[:-1]
        dx[0] = x[1] - x[0]                      # periodic: uniform seam
    else:
        dx[:-1] = x[1:] - x[:-1]
        dx[-1] = x[-1] - x[-2]

    axisZ = np.zeros((Nz - 1, Nx), bool)
    wgt = np.zeros((Nz - 1, Nx))
    ds = np.zeros((Nz - 1, Nx))
    for m in range(1, Nz):
        k = sweepZ[m]
        kPrev = sweepZ[m - 1]
        dz = abs(z[k] - z[kPrev])
        tz = dz / max(abs(muz), 1e-30)
        for j in range(Nx):
            tx = (dx[j] / abs(mux)) if mux != 0.0 else np.inf
            if tx < tz:
                # hits the x side face: interpolate along z on column j-dj
                r = tx / tz                       # in (0, 1)
                axisZ[m - 1, j] = True
                wgt[m - 1, j] = r                 # weight of previous plane
                ds[m - 1, j] = tx
            else:
                # hits the previous z-plane: interpolate along x
                q = (tz / tx) if np.isfinite(tx) else 0.0
                axisZ[m - 1, j] = False
                wgt[m - 1, j] = q                 # weight of column j-dj
                ds[m - 1, j] = tz

    # starting-plane downwind intersections (thermalised z BC)
    dxDw = np.empty(Nx)
    if dj > 0:
        dxDw[:-1] = x[1:] - x[:-1]
        dxDw[-1] = x[-1] - x[-2]                 # periodic: uniform seam
    else:
        dxDw[1:] = x[1:] - x[:-1]
        dxDw[0] = x[1] - x[0]
    kS, kN = sweepZ[0], sweepZ[1]
    tzS = abs(z[kN] - z[kS]) / max(abs(muz), 1e-30)
    sAxisZ = np.zeros(Nx, bool)
    sW = np.zeros(Nx)
    sDs = np.zeros(Nx)
    sJ = np.arange(Nx)
    jEndIdx = Nx - 1 if dj > 0 else 0
    if not periodic and mux != 0.0:
        # most-downwind column: borrow the neighbour's dw intersection
        sJ[jEndIdx] = jEndIdx - dj
    for j in range(Nx):
        ja = sJ[j]
        tx = (dxDw[ja] / abs(mux)) if mux != 0.0 else np.inf
        if tx < tzS:
            sAxisZ[j] = True
            sW[j] = tx / tzS                     # weight of the next plane
            sDs[j] = tx
        else:
            q = (tzS / tx) if np.isfinite(tx) else 0.0
            sAxisZ[j] = False
            sW[j] = q                            # weight of column ja+dj
            sDs[j] = tzS
    sJn = (sJ + dj) % Nx

    # interior downwind intersections (BESSER along-ray control points,
    # ref: FormalScalar2d.cpp:955-1000 dw handling).  Row m describes the
    # dw of cells on sweep plane m towards plane m+1; the most-downwind
    # column in non-periodic mode has no dw (the reference zeroes its
    # distance, build_intersection_list:1306-1312) -> dwZero marks the
    # linear fallback there.
    dwAxisZ = np.zeros((Nz - 1, Nx), bool)
    dwW = np.zeros((Nz - 1, Nx))
    dwDs = np.zeros((Nz - 1, Nx))
    dwZero = np.zeros((Nz - 1, Nx), bool)
    for m in range(Nz - 1):
        kC, kN2 = sweepZ[m], sweepZ[m + 1]
        tzD = abs(z[kN2] - z[kC]) / max(abs(muz), 1e-30)
        for j in range(Nx):
            if not periodic and mux != 0.0 and j == jEndIdx:
                dwZero[m, j] = True
                continue
            tx = (dxDw[j] / abs(mux)) if mux != 0.0 else np.inf
            if tx < tzD:
                dwAxisZ[m, j] = True
                dwW[m, j] = tx / tzD             # weight of the next plane
                dwDs[m, j] = tx
            else:
                q = (tzD / tx) if np.isfinite(tx) else 0.0
                dwAxisZ[m, j] = False
                dwW[m, j] = q                    # weight of column j+dj
                dwDs[m, j] = tzD
    jn = (np.arange(Nx) + dj) % Nx
    return {'axisZ': axisZ, 'w': wgt, 'ds': ds, 'sweepZ': sweepZ, 'dj': dj,
            'sAxisZ': sAxisZ, 'sW': sW, 'sDs': sDs, 'sJ': sJ, 'sJn': sJn,
            'dwAxisZ': dwAxisZ, 'dwW': dwW, 'dwDs': dwDs, 'dwZero': dwZero,
            'jn': jn}


def _ring_affine_solve(A, b):
    """Solve the cyclic affine recurrence I_i = A_i I_{i-1} + b_i around a
    ring (indices in ring order).  A, b: [..., N]. Returns I [..., N]."""
    def compose(u, v):
        Au, bu = u
        Av, bv = v
        return Au * Av, Av * bu + bv

    As = jnp.moveaxis(A, -1, 0)
    bs = jnp.moveaxis(b, -1, 0)
    Ac, bc = jax.lax.associative_scan(compose, (As, bs), axis=0)
    Atot = Ac[-1]
    btot = bc[-1]
    Ilast = btot / (1.0 - Atot)
    I = Ac * Ilast[None] + bc
    return jnp.moveaxis(I, 0, -1)


@partial(jax.jit, static_argnames=('dj', 'interp', 'periodic', 'alongRay'))
def _sweep_2d(chi, S, geomAxisZ, geomW, geomDs, Iupw, dj, interp='linear',
              periodic=True, Ibc=None, alongRay='linear', dwGeom=None):
    """z-plane sweep for one ray group.

    chi, S: [B, Nzs, Nx] already reordered into sweep order along axis 1;
    geom*: [Nzs-1, Nx]; Iupw: [B, Nx] starting-plane intensity.
    interp: 'linear' | 'besser' upwind interpolation of chi, S and I.
    periodic: cyclic x coupling; when False, the most-upwind x column is
    a fixed (callable) boundary column whose intensity per plane comes
    from Ibc [Nzs-1, B] (sweep order, starting plane excluded) and whose
    Psi is zero (ref: /root/reference/Source/FormalScalar2d.cpp:496-546).
    alongRay: 'linear' (w2 short characteristics) or 'besser' (the
    reference's piecewise_besser_2d scheme, FormalScalar2d.cpp:950-1000:
    monotonic Bezier control points on chi and S built from the cell's
    downwind intersection; cells with no downwind -- the final plane and
    the most-downwind column in non-periodic mode -- fall back to
    linear, exactly as the reference's dsDw == 0 branch).  dwGeom:
    (dwAxisZ, dwW, dwDs, dwZero, chiN, SN) scan inputs, required for
    'besser': per computed plane, the dw-intersection geometry and the
    NEXT plane's chi/S (dummy row for the final plane).

    BESSER intensity interpolation keeps the in-plane coupling affine by
    freezing the monotonic control point at the linear-pass solution: an
    initial ring solve with linear I gives I0, the Bezier control point
    cM(I0) is then a known quantity, and the quadratic term (1-u)^2 in
    the unknown upwind intensity re-enters the affine recurrence exactly
    (a Jacobi linearisation of the reference's Gauss-Seidel x sweep,
    ref: interp_besser_2d /root/reference/Source/FormalScalar2d.cpp:297-434).

    Returns I, Psi (undivided), IeffBase: [B, Nzs, Nx] in sweep order,
    where IeffBase = I - Psi*S accumulated from non-cancelling terms
    (w1*SUw/dtau + (1-w0)*Iuw) for f32 safety in the optically-thick
    limit.
    """
    B, Nzs, Nx = chi.shape
    jPrev = (jnp.arange(Nx) - dj) % Nx
    jPrev2 = (jnp.arange(Nx) - 2 * dj) % Nx
    jn = (jnp.arange(Nx) + dj) % Nx
    ringOrder = jnp.arange(Nx) if dj > 0 else jnp.arange(Nx)[::-1]
    invOrder = jnp.argsort(ringOrder)
    j0 = 0 if dj > 0 else Nx - 1                # most-upwind x column
    colMask = (jnp.arange(Nx) == j0)
    if Ibc is None:
        Ibc = jnp.zeros((Nzs - 1, B), chi.dtype)

    def solve_ring(A, b):
        Iring = _ring_affine_solve(A[:, ringOrder], b[:, ringOrder])
        return Iring[:, invOrder]

    def plane_step(carry, inputs):
        Iprev, Iprev2 = carry
        (chiP2, chiP, chiC, SP2, SP, SC, axisZ, w, ds, IbcP,
         dwA, dwW, dwDs, dwZero, chiN, SN) = inputs
        # chiP/SP/Iprev: previous plane [B, Nx]; chiC/SC: current [B, Nx].
        # axis-Z (side face): upwind = (1-w)*(current, j-dj) + w*(prev, j-dj)
        # axis-X (prev plane): upwind = (1-w)*(prev, j) + w*(prev, j-dj)
        chiPP = chiP[:, jPrev]
        SPP = SP[:, jPrev]
        IPP = Iprev[:, jPrev]

        if interp == 'besser':
            # 3-point monotonic stencils (third point one step further
            # upwind): along x on the previous plane (axis-X) and along
            # z on the upwind column (axis-Z)
            chiUwX = _besser_interp(chiP, chiPP, chiP[:, jPrev2], w)
            SUwX = _besser_interp(SP, SPP, SP[:, jPrev2], w)
            chiUwZ = _besser_interp(chiC[:, jPrev], chiPP,
                                    chiP2[:, jPrev], w)
            SUwZ = _besser_interp(SC[:, jPrev], SPP, SP2[:, jPrev], w)
            chiUw = jnp.where(axisZ, chiUwZ, chiUwX)
            SUw = jnp.where(axisZ, SUwZ, SUwX)
        else:
            chiUw = jnp.where(axisZ,
                              (1.0 - w) * chiC[:, jPrev] + w * chiPP,
                              (1.0 - w) * chiP + w * chiPP)
            SUw = jnp.where(axisZ,
                            (1.0 - w) * SC[:, jPrev] + w * SPP,
                            (1.0 - w) * SP + w * SPP)

        dtau = 0.5 * (chiUw + chiC) * ds
        w0, w1 = w2(dtau)
        c1 = (SUw - SC) / dtau
        # linear short characteristics: I = Acoef*Iuw + base
        Acoef = 1.0 - w0
        base = w0 * SC + w1 * c1
        Psi = w0 - w1 / dtau
        IeffbS = w1 * SUw / dtau         # S-part of the compensated split

        if alongRay == 'besser':
            # BESSER along-ray integration (ref piecewise_besser_2d,
            # FormalScalar2d.cpp:955-1000): chi/S control points from the
            # downwind intersection; I = edt*Iuw + M*Suw + O*S + C*SC.
            # Cells with no downwind (dwZero: final plane / non-periodic
            # most-downwind column) keep the linear formula.
            dsDwSafe = jnp.where(dwZero, 1.0, dwDs)
            chiDw = jnp.where(dwA,
                              (1.0 - dwW) * chiC[:, jn] + dwW * chiN[:, jn],
                              (1.0 - dwW) * chiN + dwW * chiN[:, jn])
            SDw = jnp.where(dwA,
                            (1.0 - dwW) * SC[:, jn] + dwW * SN[:, jn],
                            (1.0 - dwW) * SN + dwW * SN[:, jn])
            chiCtrl = besser_control_point(ds, dsDwSafe, chiUw, chiC, chiDw)
            dtauUw = (1.0 / 3.0) * (chiUw + chiCtrl + chiC) * ds
            dtauDw = 0.5 * (chiC + chiDw) * dsDwSafe
            SCtrl = besser_control_point(dtauUw, dtauDw, SUw, SC, SDw)
            M, O, Cc, edt = besser_coeffs(dtauUw)
            Acoef = jnp.where(dwZero, Acoef, edt)
            base = jnp.where(dwZero, base, M * SUw + O * SC + Cc * SCtrl)
            Psi = jnp.where(dwZero, Psi, O + Cc)
            IeffbS = jnp.where(dwZero, IeffbS, M * SUw + Cc * (SCtrl - SC))

        # known part of Acoef*Iuw; the (current, j-dj) term is the
        # in-plane affine coupling with coefficient A
        IuwX = (1.0 - w) * Iprev + w * IPP
        bKnown = jnp.where(axisZ,
                           base + Acoef * w * IPP,
                           base + Acoef * IuwX)
        A = jnp.where(axisZ, Acoef * (1.0 - w), 0.0)
        if not periodic:
            # fixed boundary column: breaks the ring into a plain chain
            A = jnp.where(colMask[None, :], 0.0, A)
            bKnown = jnp.where(colMask[None, :], IbcP[:, None], bKnown)
        Icur = solve_ring(A, bKnown)
        Iuw = jnp.where(axisZ, (1.0 - w) * Icur[:, jPrev] + w * IPP, IuwX)

        if interp == 'besser':
            # second pass: BESSER-interpolated upwind intensity with the
            # control point frozen at the first-pass solution
            IuwXb = _besser_interp(Iprev, IPP, Iprev[:, jPrev2], w)
            cM = besser_control_point(1.0, 1.0, Icur[:, jPrev], IPP,
                                      Iprev2[:, jPrev])
            knownZ = 2.0 * w * (1.0 - w) * cM + w ** 2 * IPP
            bKnown2 = jnp.where(axisZ,
                                base + Acoef * knownZ,
                                base + Acoef * IuwXb)
            A2 = jnp.where(axisZ, Acoef * (1.0 - w) ** 2, 0.0)
            if not periodic:
                A2 = jnp.where(colMask[None, :], 0.0, A2)
                bKnown2 = jnp.where(colMask[None, :], IbcP[:, None],
                                    bKnown2)
            Icur = solve_ring(A2, bKnown2)
            Iuw = jnp.where(axisZ,
                            (1.0 - w) ** 2 * Icur[:, jPrev] + knownZ,
                            IuwXb)

        # compensated split: I - Psi*S from non-cancelling terms
        Ieffb = IeffbS + Acoef * Iuw
        if not periodic:
            Psi = jnp.where(colMask[None, :], 0.0, Psi)
            Ieffb = jnp.where(colMask[None, :], Icur, Ieffb)
        return (Icur, Iprev), (Icur, Psi, Ieffb)

    # plane m-2 (duplicated at the first interval, where the 3-point
    # stencil falls back towards linear)
    chiP2 = jnp.concatenate([chi[:, :1], chi[:, :-2]], axis=1)
    SP2 = jnp.concatenate([S[:, :1], S[:, :-2]], axis=1)
    if dwGeom is None:
        # placeholders, untraced when alongRay == 'linear'
        dwGeom = (geomAxisZ, geomW, geomDs, geomAxisZ,
                  chi[:, 1:].swapaxes(0, 1), S[:, 1:].swapaxes(0, 1))
    inputs = (chiP2.swapaxes(0, 1),
              chi[:, :-1].swapaxes(0, 1), chi[:, 1:].swapaxes(0, 1),
              SP2.swapaxes(0, 1),
              S[:, :-1].swapaxes(0, 1), S[:, 1:].swapaxes(0, 1),
              geomAxisZ, geomW, geomDs, Ibc) + dwGeom
    _, (Iseq, PsiSeq, IeffSeq) = jax.lax.scan(plane_step, (Iupw, Iupw),
                                              inputs)
    I = jnp.concatenate([Iupw[:, None, :], Iseq.swapaxes(0, 1)], axis=1)
    Psi = jnp.concatenate([jnp.zeros((B, 1, Nx), chi.dtype),
                           PsiSeq.swapaxes(0, 1)], axis=1)
    Ieffb = jnp.concatenate([Iupw[:, None, :], IeffSeq.swapaxes(0, 1)],
                            axis=1)
    return I, Psi, Ieffb


def formal_sol_2d(chi, S, geom, Iupw, interp='linear', periodic=True,
                  Ibc=None, alongRay='linear'):
    """2D formal solution for one (mu, toObs) ray over a [Nz, Nx] grid.

    chi, S: [B, Nz, Nx] (natural z order, index 0 = top); geom from
    build_geometry_2d; Iupw: [B, Nx] boundary intensity at the sweep
    start plane; interp: 'linear' | 'besser' upwind interpolation of
    chi, S and I; periodic: cyclic x (False = fixed callable x BC with
    per-plane intensities Ibc [B, Nz] in natural z order); alongRay:
    'linear' | 'besser' along-ray integration (see _sweep_2d).
    Returns I, Psi, IeffBase ([B, Nz, Nx], natural order; Psi divided by
    chi; IeffBase = I - (Psi/chi)*(S*chi) via the compensated split).
    """
    sweepZ = geom['sweepZ']
    chi_s = chi[:, sweepZ]
    S_s = S[:, sweepZ]
    IbcS = None
    if Ibc is not None:
        IbcS = Ibc[:, sweepZ[1:]].swapaxes(0, 1)    # [Nzs-1, B]
    dwGeom = None
    if alongRay == 'besser':
        Nx = chi.shape[-1]
        # dw rows for computed planes 1..Nz-1; the final plane has no
        # downwind -> dummy row flagged dwZero (linear fallback)
        dwA = np.concatenate([geom['dwAxisZ'][1:],
                              np.zeros((1, Nx), bool)])
        dwW = np.concatenate([geom['dwW'][1:], np.zeros((1, Nx))])
        dwDs = np.concatenate([geom['dwDs'][1:], np.ones((1, Nx))])
        dwZero = np.concatenate([geom['dwZero'][1:],
                                 np.ones((1, Nx), bool)])
        chiN = jnp.concatenate([chi_s[:, 2:], chi_s[:, -1:]], axis=1)
        SN = jnp.concatenate([S_s[:, 2:], S_s[:, -1:]], axis=1)
        dwGeom = (jnp.asarray(dwA), jnp.asarray(dwW, chi.dtype),
                  jnp.asarray(dwDs, chi.dtype), jnp.asarray(dwZero),
                  chiN.swapaxes(0, 1), SN.swapaxes(0, 1))
    I_s, Psi_s, Ieff_s = _sweep_2d(chi_s, S_s,
                                   jnp.asarray(geom['axisZ']),
                                   jnp.asarray(geom['w'], chi.dtype),
                                   jnp.asarray(geom['ds'], chi.dtype),
                                   Iupw, int(geom['dj']), interp=interp,
                                   periodic=periodic, Ibc=IbcS,
                                   alongRay=alongRay, dwGeom=dwGeom)
    inv = np.argsort(sweepZ)
    I = I_s[:, inv]
    Psi = Psi_s[:, inv] / chi
    Ieffb = Ieff_s[:, inv]
    return I, Psi, Ieffb
