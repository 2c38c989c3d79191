"""Full-Stokes polarised formal solution on 2D (x, z) atmospheres.

A capability the reference explicitly lacks: its Stokes solver rejects
Ndim != 1 (ref: /root/reference/Source/FormalStokes.cpp:606-621).  Here
the scalar 2D plane sweep (ops/formal_solver2d.py) generalises to
4-vectors: the along-ray step is DELO-linear -- the polarised transfer
equation dI/dtau = (1 + K') I - S with the Stokes-I optical depth tau
and the normalised off-diagonal propagation matrix K' (ops/stokes.py
stokes_K) is integrated treating S - K' I as a linearly-interpolated
effective source, giving the per-cell affine step

    (1 + a0 K'_0) I_0 = (e^{-dt} 1 - aU K'_uw) I_uw + aU S_uw + a0 S_0

with the scalar short-characteristic weights aU = w1/dt,
a0 = w0 - w1/dt.  In-plane x coupling on axis-Z cells makes each
z-plane a cyclic affine recurrence in 4-vector space,
I_j = A_j I_{j-dj} + b_j with 4x4 A_j, solved exactly by an associative
scan of matrix affine maps around the ring (the matrix analogue of the
scalar _ring_affine_solve).  Upwind chi7/S4/I are interpolated linearly
at the precomputed intersections, like interp='linear' in the scalar
sweep.  Synthesis only (upgoing sweep, no Psi operator), matching the
reference's single_stokes_fs contract.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .formal_solver import w2
from .linalg import batched_solve
from .stokes import _HI, stokes_K


def _ring_affine_solve_mat(A, b):
    """Solve the cyclic matrix affine recurrence I_i = A_i I_{i-1} + b_i
    around a ring (indices in ring order).
    A: [B, N, 4, 4]; b: [B, N, 4] -> I [B, N, 4]."""
    def compose(u, v):
        Au, bu = u
        Av, bv = v
        return (jnp.einsum('...ij,...jk->...ik', Av, Au, precision=_HI),
                jnp.einsum('...ij,...j->...i', Av, bu, precision=_HI) + bv)

    As = jnp.moveaxis(A, 1, 0)                       # [N, B, 4, 4]
    bs = jnp.moveaxis(b, 1, 0)
    Ac, bc = jax.lax.associative_scan(compose, (As, bs), axis=0)
    eye = jnp.eye(4, dtype=A.dtype)
    Ilast = batched_solve(eye[None] - Ac[-1], bc[-1])    # [B, 4]
    I = jnp.einsum('nbij,bj->nbi', Ac, Ilast, precision=_HI) + bc
    return jnp.moveaxis(I, 0, 1)


@partial(jax.jit, static_argnames=('dj', 'periodic'))
def _sweep_stokes_2d(chi7, S4, geomAxisZ, geomW, geomDs, Iupw, dj,
                     periodic=True, Ibc=None):
    """z-plane Stokes sweep for one upgoing ray group.

    chi7: [B, Nzs, Nx, 7]; S4: [B, Nzs, Nx, 4] in sweep order along
    axis 1; geom*: [Nzs-1, Nx]; Iupw: [B, Nx, 4] starting-plane Stokes
    vectors; Ibc: [Nzs-1, B] Stokes-I inflow for the fixed most-upwind
    x column in non-periodic mode (Q = U = V = 0 inflow).
    Returns I: [B, Nzs, Nx, 4] in sweep order.
    """
    B, Nzs, Nx, _ = chi7.shape
    dt = chi7.dtype
    jPrev = (jnp.arange(Nx) - dj) % Nx
    ringOrder = jnp.arange(Nx) if dj > 0 else jnp.arange(Nx)[::-1]
    invOrder = jnp.argsort(ringOrder)
    j0 = 0 if dj > 0 else Nx - 1                 # most-upwind x column
    colMask = (jnp.arange(Nx) == j0)
    if Ibc is None:
        Ibc = jnp.zeros((Nzs - 1, B), dt)
    eye = jnp.eye(4, dtype=dt)

    def solve_ring(A, b):
        Iring = _ring_affine_solve_mat(A[:, ringOrder], b[:, ringOrder])
        return Iring[:, invOrder]

    def plane_step(Iprev, inputs):
        chi7P, chi7C, S4P, S4C, axisZ, w, ds, IbcP = inputs
        # chi7P/S4P/Iprev: previous plane [B, Nx, c]; chi7C/S4C: current
        aZ = axisZ[None, :, None]
        wE = w[None, :, None]
        chi7PP = chi7P[:, jPrev]
        S4PP = S4P[:, jPrev]
        chi7Uw = jnp.where(aZ, (1.0 - wE) * chi7C[:, jPrev] + wE * chi7PP,
                           (1.0 - wE) * chi7P + wE * chi7PP)
        S4Uw = jnp.where(aZ, (1.0 - wE) * S4C[:, jPrev] + wE * S4PP,
                         (1.0 - wE) * S4P + wE * S4PP)

        dtau = 0.5 * (chi7Uw[..., 0] + chi7C[..., 0]) * ds[None, :]
        w0, w1 = w2(dtau)
        aU = w1 / dtau
        a0 = w0 - w1 / dtau
        edt = 1.0 - w0

        Kuw = stokes_K(chi7Uw)                    # [B, Nx, 4, 4]
        K0 = stokes_K(chi7C)
        Md = eye + a0[..., None, None] * K0
        Ma = edt[..., None, None] * eye - aU[..., None, None] * Kuw
        rhs = aU[..., None] * S4Uw + a0[..., None] * S4C

        MdF = Md.reshape(-1, 4, 4)
        Acols = [batched_solve(MdF, Ma.reshape(-1, 4, 4)[:, :, c])
                 for c in range(4)]
        Amat = jnp.stack(Acols, axis=-1).reshape(B, Nx, 4, 4)
        bBase = batched_solve(MdF, rhs.reshape(-1, 4)).reshape(B, Nx, 4)

        # known part of the upwind Stokes vector; the (current, j-dj)
        # term is the in-plane matrix affine coupling
        IPP = Iprev[:, jPrev]
        IuwX = (1.0 - wE) * Iprev + wE * IPP
        knownUw = jnp.where(aZ, wE * IPP, IuwX)
        bKnown = bBase + jnp.einsum('bxij,bxj->bxi', Amat, knownUw,
                                    precision=_HI)
        Aring = jnp.where(aZ[..., None],
                          Amat * (1.0 - w)[None, :, None, None],
                          jnp.zeros_like(Amat))
        if not periodic:
            # fixed boundary column: breaks the ring into a plain chain
            # (ref scalar path: FormalScalar2d.cpp:496-546)
            cm = colMask[None, :, None]
            Aring = jnp.where(cm[..., None], 0.0, Aring)
            bcVec = jnp.concatenate(
                [IbcP[:, None], jnp.zeros((B, 3), dt)[:, :]], axis=1)
            bKnown = jnp.where(cm, bcVec[:, None, :], bKnown)
        Icur = solve_ring(Aring, bKnown)
        return Icur, Icur

    inputs = (chi7[:, :-1].swapaxes(0, 1), chi7[:, 1:].swapaxes(0, 1),
              S4[:, :-1].swapaxes(0, 1), S4[:, 1:].swapaxes(0, 1),
              geomAxisZ, geomW, geomDs, Ibc)
    _, Iseq = jax.lax.scan(plane_step, Iupw, inputs)
    return jnp.concatenate([Iupw[:, None], Iseq.swapaxes(0, 1)], axis=1)


def formal_sol_stokes_2d(chi7, S4, geom, Iupw, periodic=True, Ibc=None):
    """2D Stokes formal solution for one upgoing (mu, toObs=True) ray
    over a [Nz, Nx] grid.

    chi7: [B, Nz, Nx, 7]; S4: [B, Nz, Nx, 4] (natural z order, index 0 =
    top); geom from build_geometry_2d for (mu, toObs=True); Iupw:
    [B, Nx, 4] boundary Stokes vector at the sweep start (bottom) plane;
    Ibc: [B, Nz] Stokes-I inflow at the fixed x column (natural z order)
    when periodic=False.  Returns I [B, Nz, Nx, 4] in natural order.
    """
    sweepZ = geom['sweepZ']
    chi_s = chi7[:, sweepZ]
    S_s = S4[:, sweepZ]
    IbcS = None
    if Ibc is not None:
        IbcS = Ibc[:, sweepZ[1:]].swapaxes(0, 1)     # [Nzs-1, B]
    I_s = _sweep_stokes_2d(chi_s, S_s,
                           jnp.asarray(geom['axisZ']),
                           jnp.asarray(geom['w'], chi7.dtype),
                           jnp.asarray(geom['ds'], chi7.dtype),
                           Iupw, int(geom['dj']),
                           periodic=periodic, Ibc=IbcS)
    inv = np.argsort(sweepZ)
    return I_s[:, inv]
