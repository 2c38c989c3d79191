"""Partial frequency redistribution: Gouttebroze gII approximation and the
angle-averaged scattering integral.

Accelerator-native re-design of the reference PRD core
(ref: /root/reference/Source/Prd.cpp:33-645): instead of per-depth loops
with cached per-(k, la) ragged fine grids, the scattering integral is
evaluated as one dense [Nk, W, Nfine] tensor with a static fine-grid
length and masked quadrature weights; gII is recomputed on the fly
(elementwise math is cheap on the VPU; no cache invalidation machinery).
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

# ref: /root/reference/Source/Prd.cpp:33-36
PrdQWing = 4.0
PrdQCore = 2.0
PrdQSpread = 5.0
PrdDQ = 0.15

# static fine-grid size: max integration range / DQ + 1
# (ref max_fine_grid_size: /root/reference/Source/Prd.cpp:126-129)
NFINE = int(max(2 * PrdQWing + PrdQSpread, 2 * PrdQSpread) / PrdDQ) + 2


def _G_zero(x):
    return 1.0 / (jnp.abs(x) + jnp.sqrt(x * x + 1.273239545))


def gII(aDamp, qEmit, qAbs):
    """Gouttebroze's fast approximation for the angle-averaged resonance
    redistribution function ratio GII = PII/phi (Gouttebroze 1986,
    A&A 160, 195; ref: /root/reference/Source/Prd.cpp:50-124).
    Elementwise over broadcastable inputs."""
    flip = qEmit < 0.0
    qE = jnp.where(flip, -qEmit, qEmit)
    qA = jnp.where(flip, -qAbs, qAbs)

    # core value (used for qE < PrdQWing)
    expArg = jnp.minimum(qE * qE - qA * qA, 50.0)
    giiCore = jnp.where(jnp.abs(qA) <= qE, _G_zero(qE),
                        jnp.exp(expArg) * _G_zero(qA))
    coreOutside = (qA < -PrdQWing) | (qA > qE + PrdQSpread)
    giiCore = jnp.where(coreOutside, 0.0, giiCore)

    # wing value (used for qE >= PrdQCore); waveratio == 1 (resonance)
    uMin = jnp.abs(qA - qE) / 2.0
    giiWing = ((1.0 - 2.0 * uMin * _G_zero(uMin))
               * jnp.exp(-uMin * uMin) / jnp.sqrt(jnp.pi))
    ratio = qA / jnp.maximum(qE, 1e-10)
    giiWing = giiWing * (2.75 - (2.5 - 0.75 * ratio) * ratio)
    wingOutside = jnp.abs(qA - qE) > PrdQSpread
    giiWingFar = jnp.where(wingOutside, 0.0, giiWing)

    # transition blend between core and wing
    phiCore = jnp.exp(-jnp.minimum(qE * qE, 50.0))
    phiWing = aDamp / (jnp.sqrt(jnp.pi) * (aDamp * aDamp + qE * qE))
    coreFactor = phiCore / (phiCore + phiWing)

    blended = coreFactor * giiCore + (1.0 - coreFactor) * giiWing
    inCoreRange = jnp.where(qE < PrdQCore, giiCore, blended)
    inCoreRange = jnp.where(coreOutside, 0.0, inCoreRange)
    return jnp.where(qE < PrdQWing, inCoreRange, giiWingFar)


def _scattering_range_start(qEmit):
    """Start q0 of the non-zero GII integration range around qEmit
    (ref scattering_int_range: /root/reference/Source/Prd.cpp:234-263)."""
    aq = jnp.abs(qEmit)
    q0 = jnp.where(
        aq < PrdQCore, -PrdQWing,
        jnp.where(aq < PrdQWing,
                  jnp.where(qEmit > 0.0, -PrdQWing, qEmit - PrdQSpread),
                  qEmit - PrdQSpread))
    qN = jnp.where(
        aq < PrdQCore, PrdQWing,
        jnp.where(aq < PrdQWing,
                  jnp.where(qEmit > 0.0, qEmit + PrdQSpread, PrdQWing),
                  qEmit + PrdQSpread))
    return q0, qN


@partial(jax.jit)
def prd_scatter_rho(qWave, aDamp, Jw, gammaPrefactor, Jbar):
    """rho(la, k) for one PRD line.

    qWave: [W, Nk] emission frequency in Doppler units per depth;
    aDamp: [Nk]; Jw: [W, Nk] mean intensity on the line window;
    gammaPrefactor: [Nk] = (n_i/n_j) Bij / (Pj+Qj); Jbar: [Nk] = Rij/Bij.
    Returns rho [W, Nk].
    ref: /root/reference/Source/Prd.cpp:468-645
    """
    W, Nk = qWave.shape
    dt = qWave.dtype
    qW = qWave.T                                  # [Nk, W]
    Jk = Jw.T                                     # [Nk, W]

    q0, qN = _scattering_range_start(qW)          # [Nk, W]
    Np = jnp.floor((qN - q0) / PrdDQ).astype(jnp.int32) + 1     # [Nk, W]
    f = jnp.arange(NFINE, dtype=dt)               # [Nfine]
    qFine = q0[..., None] + f * PrdDQ             # [Nk, W, Nfine]

    # hybrid Simpson/trapezoid end-corrected weights, masked past Np
    # (ref: /root/reference/Source/Prd.cpp:536-551)
    idx = jnp.arange(NFINE)[None, None, :]
    NpB = Np[..., None]
    wq = jnp.where((idx == 0) | (idx == NpB - 1), 5.0 / 12.0,
                   jnp.where((idx == 1) | (idx == NpB - 2), 13.0 / 12.0,
                             1.0)) * PrdDQ
    wq = jnp.where(idx < NpB, wq, 0.0)

    # J linearly interpolated onto the fine grid (clamped at window ends)
    def interp_k(qw_k, J_k, qf_k):
        return jnp.interp(qf_k.ravel(), qw_k, J_k).reshape(W, NFINE)
    JFine = jax.vmap(interp_k)(qW, Jk, qFine)     # [Nk, W, Nfine]

    g = gII(aDamp[:, None, None], qW[..., None], qFine) * wq
    gNorm = jnp.sum(g, axis=-1)
    scatInt = jnp.sum(g * JFine, axis=-1)
    rho = 1.0 + gammaPrefactor[:, None] * (scatInt / gNorm - Jbar[:, None])
    return rho.T                                  # [W, Nk]
