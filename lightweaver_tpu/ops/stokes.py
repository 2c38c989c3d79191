"""Full-Stokes polarised formal solution: 4x4 propagation matrix and the
DELO-Bezier3 integrator.

Accelerator-native re-design of the reference Stokes solver
(ref: /root/reference/Source/FormalStokes.cpp:119-341): the per-step 4x4
linear system I_k = Md^-1 (Ma I_{k-1} + rhs_k) has all of Md/Ma/rhs
independent of I, so every matrix is precomputed as a dense batched
tensor and the sweep reduces to an affine *matrix* recurrence
I_m = A_m @ I_{m-1} + b_m evaluated with one lax.scan over depth --
the 4-vector analogue of the scalar affine recurrence.  Unpolarised
wavelengths need no fallback path: with K = 0 the matrices collapse to
the scalar Bezier-3 coefficients.
"""
from functools import partial

import jax
import jax.numpy as jnp

from .formal_solver import _point_derivs, bezier3_coeffs
from .linalg import batched_solve

# f32 contractions must not drop to TF32 on the GPU
_HI = jax.lax.Precision.HIGHEST


def stokes_K(chi7):
    """Normalised 4x4 propagation matrix (minus the diagonal) from the
    7-component opacity vector [chiI, chiQ, chiU, chiV, psiQ, psiU, psiV].

    chi7: [..., 7] -> K: [..., 4, 4]
    ref: /root/reference/Source/FormalStokes.cpp:119-142
    """
    chiI = chi7[..., 0]
    eQ = chi7[..., 1] / chiI
    eU = chi7[..., 2] / chiI
    eV = chi7[..., 3] / chiI
    rQ = chi7[..., 4] / chiI
    rU = chi7[..., 5] / chiI
    rV = chi7[..., 6] / chiI
    z = jnp.zeros_like(chiI)
    K = jnp.stack([
        jnp.stack([z, eQ, eU, eV], axis=-1),
        jnp.stack([eQ, z, rV, -rU], axis=-1),
        jnp.stack([eU, -rV, z, rQ], axis=-1),
        jnp.stack([eV, rU, -rQ, z], axis=-1),
    ], axis=-2)
    return K


@partial(jax.jit, static_argnames=('to_obs',))
def delo_bezier_stokes(chi7, S4, height, muz, I_upw, to_obs=True):
    """DELO-Bezier3 polarised formal solution for a batch of rays.

    chi7: [B, 7, N]; S4: [B, 4, N]; height: [N] (k=0 top, decreasing);
    muz: [B]; I_upw: [B, 4] boundary Stokes vector at the sweep start.
    Returns I: [B, 4, N] in original depth indexing.
    """
    B, _, N = chi7.shape
    if to_obs:
        chi7 = chi7[..., ::-1]
        S4 = S4[..., ::-1]
        h_s = height[::-1]
    else:
        h_s = height

    chiI = chi7[:, 0]                                    # [B, N]
    ds = jnp.abs(h_s[1:] - h_s[:-1])[None, :] / muz[:, None]   # [B, N-1]

    # Bezier optical depth per interval (same as the scalar solver)
    dchi = _point_derivs(chiI, ds)
    Cuw = chiI[..., :-1] + (ds / 3.0) * dchi[..., :-1]
    C0 = chiI[..., 1:] - (ds / 3.0) * dchi[..., 1:]
    dtau = ds * (chiI[..., :-1] + chiI[..., 1:] + Cuw + C0) * 0.25  # [B, N-1]

    # K and S with their tau-derivatives at every point
    K = stokes_K(jnp.moveaxis(chi7, 1, -1))              # [B, N, 4, 4]
    S = jnp.moveaxis(S4, 1, -1)                          # [B, N, 4]
    dsK = dtau[..., None, None]
    dK = jnp.moveaxis(_point_derivs(jnp.moveaxis(K, 1, -1),
                                    jnp.moveaxis(dsK, 1, -1)), -1, 1)
    dS = jnp.moveaxis(_point_derivs(jnp.moveaxis(S, 1, -1),
                                    jnp.moveaxis(dtau[..., None], 1, -1)),
                      -1, 1)

    # Interval m = 1..N-1: upwind index m-1, local index m
    Ku = K[:, :-1]
    K0 = K[:, 1:]
    dKu = dK[:, :-1]
    dK0 = dK[:, 1:]
    Su = S[:, :-1]
    S0 = S[:, 1:]
    dSu = dS[:, :-1]
    dS0 = dS[:, 1:]
    dt = dtau[..., None, None]                           # [B, N-1, 1, 1]

    alpha, beta, gamma, delta, edt = bezier3_coeffs(dt)
    eye = jnp.eye(4, dtype=chi7.dtype)

    Ku2 = jnp.matmul(Ku, Ku, precision=_HI)
    K02 = jnp.matmul(K0, K0, precision=_HI)
    d = dt / 3.0 * (Ku2 + Ku - dKu) - Ku
    e = dt / 3.0 * (K02 + K0 - dK0) + K0
    Md = eye + beta * K0 + delta * e
    Ma = edt * eye - alpha * Ku + gamma * d
    Mb = alpha * eye + gamma * (eye - dt / 3.0 * Ku)
    Mc = beta * eye + delta * (eye + dt / 3.0 * K0)

    rhs = (jnp.einsum('bnij,bnj->bni', Mb, Su, precision=_HI)
           + jnp.einsum('bnij,bnj->bni', Mc, S0, precision=_HI)
           + dtau[..., None] / 3.0 * (gamma[..., 0] * dSu
                                      - delta[..., 0] * dS0))

    # Reduce to I_m = A_m I_{m-1} + b_m via batched 4x4 solves
    MdF = Md.reshape(-1, 4, 4)
    Acols = [batched_solve(MdF, Ma.reshape(-1, 4, 4)[:, :, c])
             for c in range(4)]
    A = jnp.stack(Acols, axis=-1).reshape(B, N - 1, 4, 4)
    b = batched_solve(MdF, rhs.reshape(-1, 4)).reshape(B, N - 1, 4)

    def step(Iprev, Ab):
        Am, bm = Ab
        Inew = jnp.einsum('bij,bj->bi', Am, Iprev, precision=_HI) + bm
        return Inew, Inew

    _, Iseq = jax.lax.scan(step, I_upw,
                           (jnp.moveaxis(A, 1, 0), jnp.moveaxis(b, 1, 0)))
    I = jnp.concatenate([I_upw[None], Iseq], axis=0)     # [N, B, 4]
    I = jnp.moveaxis(I, 0, -1)                           # [B, 4, N]
    if to_obs:
        I = I[..., ::-1]
    return I
