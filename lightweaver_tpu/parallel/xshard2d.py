"""x-sharded 2D formal solver: the device-mesh replacement for the
reference's ZPlaneDecomposition domain-decomposition hook.

The reference's only spatial-decomposition story is exporting boundary
intensities per z-plane through ``ExtraParams["ZPlaneDecomposition"]``
and stitching sub-domains by hand with callable BCs
(ref: /root/reference/Source/SimdFullIterationTemplates.hpp:253-281,
349-384).  Here the horizontal (x) axis of a 2D atmosphere is sharded
over a device mesh and the plane-by-plane sweep runs under
``shard_map`` with explicit collectives over the device interconnect:

- chi/S upwind/downwind halo columns are exchanged ONCE per sweep with
  ``lax.ppermute`` (they are static over the z scan);
- the previous plane's intensity halo is exchanged with one ppermute
  per z-plane, overlapping the sweep exactly as SURVEY.md section 2.3
  prescribes;
- the in-plane cyclic affine coupling I_j = A_j I_{j-1} + b_j (see
  ops/formal_solver2d._ring_affine_solve) is solved EXACTLY in
  distributed form: each shard reduces its local block with an
  associative scan, the per-shard affine totals (2 scalars per ray) are
  all_gathered, the p-shard ring closure is composed locally, and each
  shard applies its entry value -- a distributed associative scan, not
  a lagged-halo approximation.  Sharded and unsharded sweeps agree to
  float reassociation (~1e-13 in f64; tested).

Supports every solver configuration of ops/formal_solver2d.formal_sol_2d:
interp 'linear'/'besser', alongRay 'linear'/'besser', periodic or
callable (non-periodic) x boundary conditions.
"""
from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.formal_solver import besser_coeffs, besser_control_point, w2
from ..ops.formal_solver2d import _besser_interp


def _compose(u, v):
    """Composition of affine maps x -> A x + b (v after u)."""
    Au, bu = u
    Av, bv = v
    return Au * Av, Av * bu + bv


def _ring_solve_sharded(A, b, axisName, p):
    """Exact solve of the cyclic recurrence I_j = A_j I_{j-1} + b_j whose
    x axis (ascending ring order) is block-sharded over `axisName` with
    p shards.  A, b: [B, NxLocal] local blocks.  Returns I local block.

    Local associative scan -> all_gather of per-shard affine totals ->
    static p-step ring composition -> local entry application.
    """
    As = jnp.moveaxis(A, -1, 0)
    bs = jnp.moveaxis(b, -1, 0)
    Ac, bc = lax.associative_scan(_compose, (As, bs), axis=0)
    Atot, btot = Ac[-1], bc[-1]                    # local total map
    AtotAll = lax.all_gather(Atot, axisName)       # [p, B]
    btotAll = lax.all_gather(btot, axisName)
    # cumulative compositions C_s = F_s o ... o F_0 (static loop, p small)
    Aacc = jnp.ones_like(Atot)
    bacc = jnp.zeros_like(btot)
    ends = []                                      # I at end of shard s
    cums = []
    for s in range(p):
        Aacc, bacc = _compose((Aacc, bacc), (AtotAll[s], btotAll[s]))
        cums.append((Aacc, bacc))
    AtotG, btotG = Aacc, bacc                      # global ring total
    IlastG = btotG / (1.0 - AtotG)                 # I at ring end
    ends = [IlastG] + [Acs * IlastG + bcs for Acs, bcs in cums[:-1]]
    Ientry = jnp.stack(ends)[lax.axis_index(axisName)]
    return jnp.moveaxis(Ac * Ientry[None] + bc, 0, -1)


def _left_halo(arr, axisName, p, ncols):
    """Last `ncols` x-columns of the ring-previous shard (cyclic)."""
    perm = [(s, (s + 1) % p) for s in range(p)]
    return lax.ppermute(arr[..., -ncols:], axisName, perm)


def _right_halo(arr, axisName, p, ncols):
    """First `ncols` x-columns of the ring-next shard (cyclic)."""
    perm = [(s, (s - 1) % p) for s in range(p)]
    return lax.ppermute(arr[..., :ncols], axisName, perm)


def _shift1(cur, halo):
    """Value at column j-1 (halo = left-neighbour columns, >=1 wide)."""
    return jnp.concatenate([halo[..., -1:], cur[..., :-1]], axis=-1)


def _shift2(cur, halo):
    """Value at column j-2 (halo >= 2 wide)."""
    return jnp.concatenate([halo[..., -2:], cur[..., :-2]], axis=-1)


def _shiftR(cur, haloR):
    """Value at column j+1 (haloR = right-neighbour first column)."""
    return jnp.concatenate([cur[..., 1:], haloR[..., :1]], axis=-1)


def _sweep_2d_shard_body(chi, S, axisZ, w, ds, Iupw, Ibc, dwA, dwW, dwDs,
                         dwZero, *, axisName, p, interp, periodic,
                         alongRay, isFirstShard):
    """Per-shard sweep body (runs under shard_map; dj normalised to +1).

    chi, S: [B, Nzs, Nxl] in sweep order along axis 1; geometry arrays
    [Nzs-1, Nxl]; Iupw [B, Nxl]; Ibc [Nzs-1, B].  Mirrors
    ops/formal_solver2d._sweep_2d with halo columns standing in for the
    cyclic jPrev/jPrev2/jn gathers.

    NOTE: this intentionally restates _sweep_2d's plane physics with
    shard-local gathers; tests/test_xshard2d.py compares the two
    implementations directly across every solver configuration, so any
    change to one that is not mirrored in the other fails CI.
    """
    B, Nzs, Nxl = chi.shape
    dt = chi.dtype

    # static chi/S halos for the whole sweep (one ppermute each way)
    chiHL = _left_halo(chi, axisName, p, 2)        # [B, Nzs, 2]
    SHL = _left_halo(S, axisName, p, 2)
    chiHR = _right_halo(chi, axisName, p, 1)
    SHR = _right_halo(S, axisName, p, 1)
    IupwHL = _left_halo(Iupw, axisName, p, 2)      # [B, 2]

    # the fixed-BC column (non-periodic) is global column 0 after dj
    # normalisation: local column 0 of the first shard only
    colMask = (jnp.arange(Nxl) == 0) & isFirstShard

    def solve_ring(A, b):
        return _ring_solve_sharded(A, b, axisName, p)

    def plane_step(carry, inputs):
        (Iprev, IprevHL), (Iprev2, Iprev2HL) = carry
        (chiP2, chiP2H, chiP, chiPH, chiC, chiCH,
         SP2, SP2H, SP, SPH, SC, SCH,
         axZ, wP, dsP, IbcP,
         dwAP, dwWP, dwDsP, dwZeroP, chiN, chiNH, SN, SNH,
         chiCRH, SCRH) = inputs

        chiPP = _shift1(chiP, chiPH)
        SPP = _shift1(SP, SPH)
        IPP = _shift1(Iprev, IprevHL)

        if interp == 'besser':
            chiUwX = _besser_interp(chiP, chiPP, _shift2(chiP, chiPH), wP)
            SUwX = _besser_interp(SP, SPP, _shift2(SP, SPH), wP)
            chiUwZ = _besser_interp(_shift1(chiC, chiCH), chiPP,
                                    _shift1(chiP2, chiP2H), wP)
            SUwZ = _besser_interp(_shift1(SC, SCH), SPP,
                                  _shift1(SP2, SP2H), wP)
            chiUw = jnp.where(axZ, chiUwZ, chiUwX)
            SUw = jnp.where(axZ, SUwZ, SUwX)
        else:
            chiUw = jnp.where(axZ,
                              (1.0 - wP) * _shift1(chiC, chiCH)
                              + wP * chiPP,
                              (1.0 - wP) * chiP + wP * chiPP)
            SUw = jnp.where(axZ,
                            (1.0 - wP) * _shift1(SC, SCH) + wP * SPP,
                            (1.0 - wP) * SP + wP * SPP)

        dtau = 0.5 * (chiUw + chiC) * dsP
        w0, w1 = w2(dtau)
        c1 = (SUw - SC) / dtau
        Acoef = 1.0 - w0
        base = w0 * SC + w1 * c1
        Psi = w0 - w1 / dtau
        IeffbS = w1 * SUw / dtau

        if alongRay == 'besser':
            dsDwSafe = jnp.where(dwZeroP, 1.0, dwDsP)
            chiNn = _shiftR(chiN, chiNH)
            SNn = _shiftR(SN, SNH)
            chiDw = jnp.where(dwAP,
                              (1.0 - dwWP) * _shiftR(chiC, chiCRH)
                              + dwWP * chiNn,
                              (1.0 - dwWP) * chiN + dwWP * chiNn)
            SDw = jnp.where(dwAP,
                            (1.0 - dwWP) * _shiftR(SC, SCRH)
                            + dwWP * SNn,
                            (1.0 - dwWP) * SN + dwWP * SNn)
            chiCtrl = besser_control_point(dsP, dsDwSafe, chiUw, chiC,
                                           chiDw)
            dtauUw = (1.0 / 3.0) * (chiUw + chiCtrl + chiC) * dsP
            dtauDw = 0.5 * (chiC + chiDw) * dsDwSafe
            SCtrl = besser_control_point(dtauUw, dtauDw, SUw, SC, SDw)
            M, O, Cc, edt = besser_coeffs(dtauUw)
            Acoef = jnp.where(dwZeroP, Acoef, edt)
            base = jnp.where(dwZeroP, base, M * SUw + O * SC + Cc * SCtrl)
            Psi = jnp.where(dwZeroP, Psi, O + Cc)
            IeffbS = jnp.where(dwZeroP, IeffbS,
                               M * SUw + Cc * (SCtrl - SC))

        IuwX = (1.0 - wP) * Iprev + wP * IPP
        bKnown = jnp.where(axZ, base + Acoef * wP * IPP,
                           base + Acoef * IuwX)
        A = jnp.where(axZ, Acoef * (1.0 - wP), 0.0)
        if not periodic:
            A = jnp.where(colMask[None, :], 0.0, A)
            bKnown = jnp.where(colMask[None, :], IbcP[:, None], bKnown)
        Icur = solve_ring(A, bKnown)
        IcurHL = _left_halo(Icur, axisName, p, 2)
        Iuw = jnp.where(axZ,
                        (1.0 - wP) * _shift1(Icur, IcurHL) + wP * IPP,
                        IuwX)

        if interp == 'besser':
            IuwXb = _besser_interp(Iprev, IPP,
                                   _shift2(Iprev, IprevHL), wP)
            cM = besser_control_point(1.0, 1.0, _shift1(Icur, IcurHL),
                                      IPP, _shift1(Iprev2, Iprev2HL), )
            knownZ = 2.0 * wP * (1.0 - wP) * cM + wP ** 2 * IPP
            bKnown2 = jnp.where(axZ, base + Acoef * knownZ,
                                base + Acoef * IuwXb)
            A2 = jnp.where(axZ, Acoef * (1.0 - wP) ** 2, 0.0)
            if not periodic:
                A2 = jnp.where(colMask[None, :], 0.0, A2)
                bKnown2 = jnp.where(colMask[None, :], IbcP[:, None],
                                    bKnown2)
            Icur = solve_ring(A2, bKnown2)
            IcurHL = _left_halo(Icur, axisName, p, 2)
            Iuw = jnp.where(axZ,
                            (1.0 - wP) ** 2 * _shift1(Icur, IcurHL)
                            + knownZ,
                            IuwXb)

        Ieffb = IeffbS + Acoef * Iuw
        if not periodic:
            Psi = jnp.where(colMask[None, :], 0.0, Psi)
            Ieffb = jnp.where(colMask[None, :], Icur, Ieffb)
        return (((Icur, IcurHL), (Iprev, IprevHL)),
                (Icur, Psi, Ieffb))

    def roll_planes(a, aH):
        """Scan inputs for (plane m-2, m-1, m) + matching halo tensors."""
        p2 = jnp.concatenate([a[:, :1], a[:, :-2]], axis=1)
        p2H = jnp.concatenate([aH[:, :1], aH[:, :-2]], axis=1)
        return (p2.swapaxes(0, 1), p2H.swapaxes(0, 1),
                a[:, :-1].swapaxes(0, 1), aH[:, :-1].swapaxes(0, 1),
                a[:, 1:].swapaxes(0, 1), aH[:, 1:].swapaxes(0, 1))

    # next-plane chi/S for the BESSER downwind stencil (dummy last row)
    chiNseq = jnp.concatenate([chi[:, 2:], chi[:, -1:]], axis=1)
    SNseq = jnp.concatenate([S[:, 2:], S[:, -1:]], axis=1)
    chiNHseq = jnp.concatenate([chiHR[:, 2:], chiHR[:, -1:]], axis=1)
    SNHseq = jnp.concatenate([SHR[:, 2:], SHR[:, -1:]], axis=1)

    inputs = (roll_planes(chi, chiHL) + roll_planes(S, SHL)
              + (axisZ, w, ds, Ibc, dwA, dwW, dwDs, dwZero,
                 chiNseq.swapaxes(0, 1), chiNHseq.swapaxes(0, 1),
                 SNseq.swapaxes(0, 1), SNHseq.swapaxes(0, 1),
                 chiHR[:, 1:].swapaxes(0, 1), SHR[:, 1:].swapaxes(0, 1)))
    carry0 = ((Iupw, IupwHL), (Iupw, IupwHL))
    _, (Iseq, PsiSeq, IeffSeq) = lax.scan(plane_step, carry0, inputs)
    I = jnp.concatenate([Iupw[:, None, :], Iseq.swapaxes(0, 1)], axis=1)
    Psi = jnp.concatenate([jnp.zeros((B, 1, Nxl), dt),
                           PsiSeq.swapaxes(0, 1)], axis=1)
    Ieffb = jnp.concatenate([Iupw[:, None, :], IeffSeq.swapaxes(0, 1)],
                            axis=1)
    return I, Psi, Ieffb


def prep_xshard_geometry(geom, Nz, Nx, dtype):
    """Host-side, trace-time geometry preparation for the x-sharded
    sweep of one (mu, toObs) ray: everything static is reordered ONCE
    (sweep-order z, dj-normalised x) so the traced path touches no
    numpy.  Returns a dict of trace-time constants consumed by
    :func:`formal_sol_2d_xsharded_traced`."""
    sweepZ = np.asarray(geom['sweepZ'])
    dj = int(geom['dj'])
    flip = dj < 0

    def prep(a):
        a = np.asarray(a)
        if flip:
            a = a[..., ::-1]
        return np.ascontiguousarray(a)

    dwA = prep(np.concatenate([geom['dwAxisZ'][1:],
                               np.zeros((1, Nx), bool)]))
    dwW = prep(np.concatenate([geom['dwW'][1:],
                               np.zeros((1, Nx))])).astype(dtype)
    dwDs = prep(np.concatenate([geom['dwDs'][1:],
                                np.ones((1, Nx))])).astype(dtype)
    dwZero = prep(np.concatenate([geom['dwZero'][1:],
                                  np.ones((1, Nx), bool)]))
    return {
        'sweepZ': sweepZ, 'inv': np.argsort(sweepZ), 'flip': flip,
        'axisZ': prep(geom['axisZ']),
        'w': prep(geom['w']).astype(dtype),
        'ds': prep(geom['ds']).astype(dtype),
        'dwA': dwA, 'dwW': dwW, 'dwDs': dwDs, 'dwZero': dwZero,
    }


def formal_sol_2d_xsharded_traced(chi, S, prep, Iupw, mesh,
                                  axisName='x', interp='linear',
                                  periodic=True, Ibc=None,
                                  alongRay='linear'):
    """Fully-traceable x-sharded 2D formal solution for one (mu, toObs)
    ray: usable INSIDE a jitted MALI iteration (no host-side numpy on
    the data path — geometry reordering comes precomputed via
    :func:`prep_xshard_geometry`).

    chi, S: [B, Nz, Nx] traced arrays in natural z order; Iupw [B, Nx];
    Ibc [B, Nz] or None.  Under jit, GSPMD moves the operands into the
    shard_map's in_specs automatically, so the caller may hold them with
    any sharding (replicated included).  Returns I, Psi, IeffBase
    ([B, Nz, Nx] global, natural order).
    """
    p = mesh.shape[axisName]
    B, Nz, Nx = chi.shape
    if Nx % p != 0:
        raise ValueError(f'Nx={Nx} not divisible by {p} x-shards')
    if Nx // p < 2:
        # the 2-column upwind halo only reaches one shard back; a
        # 1-column shard would alias j-2 onto j-1 in the BESSER stencils
        raise ValueError(f'Need >= 2 x columns per shard (Nx={Nx}, '
                         f'{p} shards)')
    dt = chi.dtype
    sweepZ = prep['sweepZ']
    flip = prep['flip']

    def order(a):
        a = a[:, sweepZ]
        return jnp.flip(a, axis=-1) if flip else a

    chiG = order(chi)
    SG = order(S)
    IupwG = jnp.flip(Iupw, axis=-1) if flip else Iupw
    if Ibc is not None:
        IbcG = Ibc[:, sweepZ[1:]].swapaxes(0, 1)       # [Nzs-1, B]
    else:
        IbcG = jnp.zeros((Nz - 1, B), dt)

    specX = P(None, None, axisName)
    spec2 = P(None, axisName)
    specI = P(None, axisName)
    specB = P(None, None)

    body = partial(_sweep_2d_shard_body, axisName=axisName, p=p,
                   interp=interp, periodic=periodic, alongRay=alongRay)

    def shard_body(chiL, SL, axZL, wL, dsL, IupwL, IbcL, dwAL, dwWL,
                   dwDsL, dwZeroL):
        isFirst = lax.axis_index(axisName) == 0
        return body(chiL, SL, axZL, wL, dsL, IupwL, IbcL, dwAL, dwWL,
                    dwDsL, dwZeroL, isFirstShard=isFirst)

    fn = jax.shard_map(shard_body, mesh=mesh,
                       in_specs=(specX, specX, spec2, spec2, spec2, specI,
                                 specB, spec2, spec2, spec2, spec2),
                       out_specs=(specX, specX, specX), check_vma=False)

    I_s, Psi_s, Ieff_s = fn(chiG, SG,
                            jnp.asarray(prep['axisZ']),
                            jnp.asarray(prep['w'], dt),
                            jnp.asarray(prep['ds'], dt),
                            IupwG, IbcG,
                            jnp.asarray(prep['dwA']),
                            jnp.asarray(prep['dwW'], dt),
                            jnp.asarray(prep['dwDs'], dt),
                            jnp.asarray(prep['dwZero']))

    inv = prep['inv']
    I_s = I_s[:, inv]
    Psi_s = Psi_s[:, inv]
    Ieff_s = Ieff_s[:, inv]
    if flip:
        I_s = jnp.flip(I_s, axis=-1)
        Psi_s = jnp.flip(Psi_s, axis=-1)
        Ieff_s = jnp.flip(Ieff_s, axis=-1)
    Psi_s = Psi_s / chi
    return I_s, Psi_s, Ieff_s


def formal_sol_2d_xsharded(chi, S, geom, Iupw, mesh, axisName='x',
                           interp='linear', periodic=True, Ibc=None,
                           alongRay='linear'):
    """x-sharded 2D formal solution for one (mu, toObs) ray.

    Same contract as ops.formal_solver2d.formal_sol_2d -- chi, S
    [B, Nz, Nx] in natural z order, geom from build_geometry_2d, Iupw
    [B, Nx], Ibc [B, Nz] -- but the x axis is block-sharded over
    `mesh`'s `axisName` axis and the sweep runs under shard_map with
    explicit halo-exchange/all-gather collectives.  Nx must be divisible
    by the axis size.  Returns I, Psi, IeffBase as sharded jax.Arrays
    ([B, Nz, Nx] global shape).

    Standalone entry point: prepares geometry host-side and places the
    operands with the sharded layout; the in-iteration path uses
    :func:`formal_sol_2d_xsharded_traced` with geometry from
    :func:`prep_xshard_geometry` instead.
    """
    B, Nz, Nx = chi.shape
    dt = chi.dtype
    prep = prep_xshard_geometry(geom, Nz, Nx, dt)

    put = lambda a, sp: jax.device_put(jnp.asarray(a),
                                       NamedSharding(mesh, sp))
    chiD = put(np.asarray(chi), P(None, None, axisName))
    SD = put(np.asarray(S), P(None, None, axisName))
    IupwD = put(np.asarray(Iupw), P(None, axisName))
    IbcD = None if Ibc is None else put(np.asarray(Ibc), P(None, None))
    return formal_sol_2d_xsharded_traced(
        chiD, SD, prep, IupwD, mesh=mesh, axisName=axisName,
        interp=interp, periodic=periodic, Ibc=IbcD, alongRay=alongRay)
