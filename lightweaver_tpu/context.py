"""The Context: device state + jitted MALI iteration functions.

Accelerator-native re-design of the reference's intensity core
(ref: /root/reference/Source/SimdFullIterationTemplates.hpp:59-781,
 /root/reference/Source/LwMiddleLayer.pyx:2806-4003):

- The reference iterates one wavelength at a time across threads, with
  per-thread Gamma replicas.  Here ALL wavelengths, angles and directions
  are batched into dense tensors; the formal solve runs as one affine
  depth-recurrence over a [Nlambda x Nmu x 2] ray batch, and the Gamma /
  rate accumulations are masked window contractions (einsums) over those
  axes.  No replicas, no reductions beyond the contractions themselves.
- Per-transition ragged wavelength windows (Nblue/Nred) are static Python
  ints at trace time, so every window operation lowers to a static slice
  of the dense [Nlambda, ...] arrays: active-window efficiency without
  ragged data structures.
- MALI preconditioning with overlapping transitions uses a static overlap
  analysis: per-level chi/U accumulators (ref Atom::chi/U) are evaluated
  per transition window as sign-weighted sums of the overlapping
  transitions' contributions.
- The whole iteration is a pure function of a `params` pytree (pops, J,
  profiles, background, thermodynamics), so the same traced program can
  be vmapped over an axis of independent columns (1.5D synthesis) and
  sharded over a device mesh.
"""
from dataclasses import dataclass, field
from functools import partial
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from . import constants as Const
from .atmosphere import (Atmosphere, PeriodicRadiation,
                         ThermalisedRadiation, ZeroRadiation)
from .atomic_model import AtomicLine, AtomicModel, LineProfileState
from .background import basic_background
from .iteration_update import IterationUpdate
from .ops.faddeeva import voigt_H
from .ops.formal_solver import formal_sol_1d

# depth-recurrence evaluation of the 1D formal solver
# (ops/formal_solver.py `_affine_solve`)
RECURRENCE_MODES = ('scan', 'parallel', 'blocked')
from .ops.linalg import solve_KxK_over_depth
from .ops.planck import planck_nu


@dataclass
class TransStatic:
    """Static (trace-time) description of one transition's place in the
    global wavelength grid."""
    isLine: bool
    i: int
    j: int
    Nblue: int
    Nred: int
    lambda0: float
    Aji: float = 0.0
    Bji: float = 0.0
    Bij: float = 0.0
    wavelength: np.ndarray = None       # [W] window grid
    wlambda: np.ndarray = None          # [W] integration weights
    alpha: np.ndarray = None            # [W] continuum cross-section
    polarisable: bool = False
    isPrd: bool = False

    @property
    def W(self):
        return self.Nred - self.Nblue


def _wlambda(grid: np.ndarray, dopplerWidth: float) -> np.ndarray:
    """Trapezoidal wavelength integration weights over a window
    (ref: /root/reference/Source/LwTransition.hpp:72-82)."""
    w = np.empty_like(grid)
    w[0] = 0.5 * (grid[1] - grid[0])
    w[-1] = 0.5 * (grid[-1] - grid[-2])
    w[1:-1] = 0.5 * (grid[2:] - grid[:-2])
    return w * dopplerWidth


@dataclass
class AtomStatic:
    model: AtomicModel
    Nlevel: int
    trans: List[TransStatic]
    detailed: bool = False
    # overlap analysis: for each level, [(trans_idx, sign)] for chi sums
    chiLists: List[List[Tuple[int, int]]] = field(default_factory=list)
    # for each level, [trans_idx] with j == level (U accumulators)
    ULists: List[List[int]] = field(default_factory=list)

    def build_overlaps(self):
        self.chiLists = [[] for _ in range(self.Nlevel)]
        self.ULists = [[] for _ in range(self.Nlevel)]
        for idx, t in enumerate(self.trans):
            self.chiLists[t.i].append((idx, +1))
            self.chiLists[t.j].append((idx, -1))
            self.ULists[t.j].append(idx)


def _overlap_slices(t: TransStatic, t2: TransStatic):
    lo = max(t.Nblue, t2.Nblue)
    hi = min(t.Nred, t2.Nred)
    if hi <= lo:
        return None
    return slice(lo - t.Nblue, hi - t.Nblue), slice(lo - t2.Nblue,
                                                    hi - t2.Nblue)


@dataclass
class IterConfig:
    """Static configuration captured by the traced iteration function."""
    activeAtoms: List[AtomStatic]
    detailedAtoms: List[AtomStatic]
    Nlam: int
    Nmu: int
    Nk: int
    lowerThermalised: bool
    upperThermalised: bool
    formalSolver: str
    recurrenceMode: str
    dtype: object
    wavelength: np.ndarray      # trace-time constant [Nlam]
    muz: np.ndarray             # [Nmu]
    wmu: np.ndarray             # [Nmu]
    # Gamma/rate accumulation dtype.  The detailed-balance cancellations
    # in Gamma amplify rounding noise ~1e4x through the statistical
    # equilibrium solve, so f32 state needs f64 accumulation to converge
    # below dPops ~ 1e-2 (f64 state: same as dtype).
    accumDtype: object = None
    # Gamma accumulation: 'factored' contracts mu-independent (continuum)
    # transitions against precomputed angular moments (PsiBar/IBar/
    # IeffBar) instead of broadcasting them onto the [W,Nmu,2,Nk] ray
    # tensor; 'dense' is the straightforward reference-shaped path.
    gammaMode: str = 'factored'
    # Gamma/rate lambda-reduction precision under mixed precision:
    # 'exact' multiplies and reduces the [W, Nk] integrands in
    # accumDtype; 'blocked' keeps _GAMMA_BLOCK-row partials in the
    # working dtype with only the inter-block sum in accumDtype (dJ
    # floor ~8e-3 vs ~4e-3).  Ignored when dtype == accumDtype.
    gammaAccum: str = 'exact'
    # iteration scheme (the reference's per-SIMD plugin selection,
    # LwFormalInterface.hpp:110-136); 'mali_full_precond' is the only one
    fsIterScheme: str = 'mali_full_precond'
    # 2D extensions
    Ndim: int = 1
    # upwind-interpolation function for 2D sweeps, mirroring the
    # reference's InterpFn selection (FormalInterface.cpp:41-42):
    # 'interp_linear_2d' (default, like the reference) or
    # 'interp_besser_2d' (monotonic-Bezier upwind chi/S/I).
    interpFn2d: str = 'interp_linear_2d'
    xPeriodic: bool = True
    mux: Optional[np.ndarray] = None    # [Nmu] (2D rays)
    Nz: Optional[int] = None
    Nx: Optional[int] = None
    zGrid: Optional[np.ndarray] = None
    geom2d: Optional[Dict] = None       # (mu, toObs) -> geometry dict
    # x-sharded 2D sweep: device mesh + axis name + trace-time prepared
    # geometry ((mu, toObs) -> prep_xshard_geometry dict).  When set the
    # jitted iteration runs the plane sweep under shard_map with the x
    # axis block-sharded (halo exchange + distributed ring closure) --
    # the integrated form of parallel/xshard2d.py, replacing the
    # reference's ZPlaneDecomposition hook (SURVEY §2.3).
    mesh2d: Optional[object] = None
    xAxisName: str = 'x'
    prepGeom2d: Optional[Dict] = None
    # Local-operator acceleration of the coherent background-scattering
    # term: solve the diagonal feedback J = J_fs + PsiBar*sca*(J - Jdag)
    # pointwise after each formal solution.  Kills the slow lambda-
    # iteration mode at Rayleigh/Thomson-dominated wavelengths (deep-UV
    # J stalls at dJ ~1e-2 for hundreds of iterations without it); same
    # fixed point, different trajectory than the reference, hence off by
    # default (golden tests pin the reference trajectory).
    accelerateScattering: bool = False
    # hybrid-PRD extensions (ref: /root/reference/Source/Prd.cpp:697-945)
    hprd: bool = False
    prdIdxs: Optional[np.ndarray] = None         # PRD-active lambda subset
    laToPrdLa: Optional[np.ndarray] = None
    hprdCoeffs: Optional[Dict] = None   # (ai, ti) -> (i0, frac) arrays
    vlosMu: Optional[np.ndarray] = None          # [Nmu, Nk]


def _window_add(tot, start: int, val):
    """``tot[start:start+W] += val`` for a static wavelength window.

    Expressed as dynamic_slice + add + dynamic_update_slice rather than
    ``x.at[sl].add``: DUS requires matching dtypes, turning any
    accidental f32/f64 mix in the hot path into a trace-time error
    instead of a silent promotion of the big [W, Nmu, 2, Nk] tensors
    to f64.
    ``val`` may carry size-1 axes (continuum [W, 1, 1, Nk]
    contributions) — the add broadcasts, so no materialised
    broadcast_to is needed.
    """
    W = val.shape[0]
    s = (start,) + (0,) * (tot.ndim - 1)
    cur = jax.lax.dynamic_slice(tot, s, (W,) + tot.shape[1:])
    return jax.lax.dynamic_update_slice(tot, cur + val, s)


def _slab_add(tot, start: tuple, sizes: tuple, val):
    """General static-slab accumulate (same scatter-avoidance as
    :func:`_window_add` but with an explicit start/extent per axis, for
    updates along interior axes, e.g. one Stokes component plane).
    ``val`` must broadcast against the ``sizes`` region."""
    cur = jax.lax.dynamic_slice(tot, start, sizes)
    return jax.lax.dynamic_update_slice(tot, cur + val, start)


def _sum_mu(x, wmu):
    """Angular moment: contract [..., Nmu, 2, Nk] against wmu [Nmu] over
    the (mu, up/down) axes -> [..., Nk].

    Written as broadcast-multiply + sum rather than einsum: the
    multiply+reduce form fuses with its producers into one elementwise
    reduction kernel, and never reaches a matrix unit (no TF32).
    """
    return jnp.sum(x * wmu[:, None, None], axis=(-3, -2))


def _sum_lmd(x, wla, wmu):
    """Full transition integral: contract x [W, Nmu, 2, Nk] against
    wla [W, Nk] and wmu [Nmu] over (lambda, mu, up/down) -> [Nk].
    Same multiply+reduce rationale as :func:`_sum_mu`."""
    return jnp.sum(x * wla[:, None, None, :] * wmu[None, :, None, None],
                   axis=(0, 1, 2))


_GAMMA_BLOCK = 32


def _sum_lam_blocked(x, adt):
    """Lambda reduction of ``x`` [W, Nk] with working-dtype block
    partials (<= _GAMMA_BLOCK terms each) and the inter-block sum in
    ``adt``.  This removes the f64 elementwise work and the f64
    materialisation of the [W, Nk] integrands, at the price of a
    slightly raised mixed-precision dJ floor (~8e-3 vs ~4e-3; the
    dPops < 1e-3 convergence floor is unaffected — see
    test_gamma_accum.py)."""
    W = x.shape[0]
    nb = -(-W // _GAMMA_BLOCK)
    pad = nb * _GAMMA_BLOCK - W
    if pad:
        x = jnp.pad(x, ((0, pad), (0, 0)))
    part = jnp.sum(x.reshape(nb, _GAMMA_BLOCK, x.shape[1]), axis=1)
    return jnp.sum(part.astype(adt), axis=0)


def _sum_lmd_split(x, wla_adt, wmu_adt, wmu_dt, adt, blocked=False):
    """:func:`_sum_lmd` with the (mu, up/down) contraction performed in
    the dtype of ``x`` before casting to the accumulation dtype.

    The angular reduction has only 2*Nmu terms with positive *weights*
    (the summands themselves can be mixed-sign — the Gamma integrands
    carry an elementwise cross-term subtraction — so f32 cancellation
    across the angular sum is possible in principle; empirically it
    stays below what the 5e-3/1e-3 tolerances need, which
    test_mixed_precision.py pins — if f32 convergence ever regresses,
    revert the Gamma integrand call sites to the plain adt reduction
    first).  The lambda sum — thousands of terms with weights spanning
    orders of magnitude, the reason for ``accumDtype`` — still runs in
    ``adt``.  This shrinks the f64 elementwise work and HBM traffic of
    every Gamma/rate contraction by 2*Nmu.  When ``x`` is already in
    ``adt`` the original single-pass contraction is used (bit-stable f64
    default path)."""
    if x.dtype == jnp.dtype(adt):
        return _sum_lmd(x, wla_adt, wmu_adt)
    xm = jnp.sum(x * wmu_dt[None, :, None, None], axis=(1, 2))
    if blocked:
        return _sum_lam_blocked(xm * wla_adt.astype(x.dtype), adt)
    return jnp.sum(xm.astype(adt) * wla_adt, axis=0)


def _uv(cfg: IterConfig, params, ai: int, ti: int, t: TransStatic,
        lo: Optional[int] = None, hi: Optional[int] = None):
    """Uji, Vij, Vji for one transition over its window.
    Lines: [W, Nmu, 2, Nk]; continua: [W, 1, 1, Nk].

    ``lo``/``hi`` (GLOBAL wavelength indices inside the window) restrict
    the computation to those rows, slicing phi/rho at trace time —
    bitwise identical to slicing the full-window result.  Each distinct
    (lo, hi) call site owns a private elementwise subgraph that XLA
    fuses into its consumer instead of materialising the whole
    [W, Nmu, 2, Nk] window in HBM (the round-3 gather-stage cost).
    ref: /root/reference/Source/LwTransition.hpp:93-144"""
    dt = cfg.dtype
    if lo is None:
        lo, hi = t.Nblue, t.Nred
    sl = slice(lo - t.Nblue, hi - t.Nblue)
    lam = jnp.asarray(np.asarray(t.wavelength)[sl], dt)
    if t.isLine:
        phi = params['phi'][ai][ti][sl]
        hnu_4pi = Const.HC_FOURPI * (t.lambda0 / lam)
        Vij = hnu_4pi[:, None, None, None] * t.Bij * phi
        Vji = (t.Bji / t.Bij) * Vij
        if t.isPrd and params.get('rhoPrd') is not None:
            rho = params['rhoPrd'][ai][ti]
            if rho is not None:
                rho = rho.astype(dt)
                if cfg.hprd and params.get('hprdI0') is not None \
                        and params['hprdI0'][ai][ti] is not None:
                    # comoving-frame rho: linear interpolation at the
                    # Doppler-shifted window position per (mu, +/-, k);
                    # coefficients ride in params so columns can carry
                    # distinct velocity fields under vmap.  rho stays
                    # full-window (shifts cross rows); i0/frac slice.
                    # (ref: /root/reference/Source/LwTransition.hpp:118-126)
                    i0 = params['hprdI0'][ai][ti][sl]
                    frac = params['hprdFrac'][ai][ti][sl].astype(dt)
                    kIdx = jnp.arange(rho.shape[1])
                    rhoShift = ((1.0 - frac) * rho[i0, kIdx]
                                + frac * rho[i0 + 1, kIdx])
                    Vji = Vji * rhoShift
                else:
                    # emission profile psi = rho phi: scales Vji and Uji
                    # (ref: /root/reference/Source/LwAtom.hpp:119-123)
                    Vji = Vji * rho[sl][:, None, None, :]
        Uji = (t.Aji / t.Bji) * Vji
    else:
        nStar = params['nStar'][ai]
        hc_kl = Const.HC_K / lam                        # [w]
        gij = (nStar[t.i][None, :] / nStar[t.j][None, :]
               * jnp.exp(-hc_kl[:, None] / params['temperature'][None, :]))
        alpha = jnp.asarray(np.asarray(t.alpha)[sl], dt)   # [w]
        Vij = jnp.broadcast_to(alpha[:, None], gij.shape)[:, None, None, :]
        Vji = (gij * alpha[:, None])[:, None, None, :]
        twohc = Const.TwoHC / lam ** 3
        Uji = twohc[:, None, None, None] * Vji
    return Uji, Vij, Vji


def _wla(cfg: IterConfig, params, ai: int, ti: int, t: TransStatic):
    """Integration weight wla [W, Nk] (without the 0.5 wmu factor).
    ref: /root/reference/Source/LwAtom.hpp:82-128"""
    dt = cfg.dtype
    wla = jnp.asarray(t.wlambda, dt)
    if t.isLine:
        wphi = params['wphi'][ai][ti]
        return wla[:, None] * wphi[None, :] * Const.FOURPI_HC
    lam = jnp.asarray(t.wavelength, dt)
    w = (wla / lam) * Const.FOURPI_H
    return jnp.broadcast_to(w[:, None], (t.W, cfg.Nk))


def _accelerate_scattering(Jnew, Jdag, PsiBar, sca, adt):
    """Local (diagonal) operator acceleration of the coherent
    background-scattering lambda iteration.

    The formal solution computes J_fs = Lambda[(eta + sca*Jdag)/chi];
    its pointwise sensitivity to the lagged Jdag is
    c(la, k) = sca(la, k) * PsiBar(la, k), where PsiBar is the
    sum_mu wmu/2 * Psi(la, mu, +/-, k) angular moment.
    Solving the scalar fixed point J = J_fs + c*(J - Jdag) gives
    J = (J_fs - c*Jdag) / (1 - c): the Rayleigh/Thomson-dominated
    deep-UV rows converge in a few steps instead of O(1/(1-c)) pure
    lambda iterations.  Same fixed point (J = Jdag implies J = J_fs)."""
    c = sca.astype(adt) * PsiBar.astype(adt)
    c = jnp.clip(c, 0.0, 1.0 - 1e-3)
    return (Jnew - c * Jdag) / (1.0 - c)


def _cast_params_to_working(params, dt):
    """Normalise every input consumed by the ray-tensor math to the
    working dtype.  Host state (pops, background, thermodynamics) is kept
    in f64; without these casts an f32 program silently promotes its big
    [W, Nmu, 2, Nk] elementwise tensors to f64 (J alone stays in
    accumDtype by design)."""
    params = dict(params)
    cast = lambda x: x.astype(dt) if hasattr(x, 'astype') else x
    params['allPops'] = [cast(n) for n in
                         (list(params['pops']) + list(params['detPops']))]
    params['nStar'] = [cast(x) for x in
                       (list(params['nStar']) + list(params['detNStar']))]
    for key in ('bgChi', 'bgEta', 'bgSca', 'temperature', 'height'):
        params[key] = cast(params[key])
    for key in ('phi', 'wphi'):
        params[key] = [[cast(x) if x is not None else None for x in pa]
                       for pa in params[key]]
    return params


def build_iteration_fn(cfg: IterConfig):
    """The full MALI step as a pure function of the params pytree.

    params = {
      'J': [Nlam, Nk], 'bgChi'/'bgEta'/'bgSca': [Nlam, Nk],
      'temperature'/'height': [Nk],
      'pops'/'nStar': per active atom [Nlevel, Nk],
      'detPops'/'detNStar': per detailed atom,
      'C': per active atom [Nl, Nl, Nk] collisional matrices,
      'crsw': scalar collisional-radiative switching factor,
      'phi': nested [atom][trans] -> [W, Nmu, 2, Nk] or None,
      'wphi': nested [atom][trans] -> [Nk] or None,
    }
    Returns (Gamma, Rij, Rji, Jnew, Iout, dJ, I, Psi).
    """
    Nlam, Nmu, Nk = cfg.Nlam, cfg.Nmu, cfg.Nk
    dt = cfg.dtype
    allAtoms = cfg.activeAtoms + cfg.detailedAtoms
    muz = jnp.asarray(cfg.muz, dt)
    wmu = jnp.asarray(cfg.wmu, dt)
    lamGrid = jnp.asarray(cfg.wavelength, dt)

    # ---- sliced per-transition window accessors -------------------------
    # Each call computes ONLY the requested global-lambda rows [lo, hi)
    # from phi/rho/alpha slices.  Distinct (lo, hi) call sites own
    # private subgraphs, so XLA fuses the cheap elementwise products into
    # each consumer instead of materialising full [W, Nmu, 2, Nk] windows
    # (measured: window materialisation dominated the round-3 gather
    # stage, 1.16 ms of the 3.65 ms bench iteration, BREAKDOWN_r04).
    def chi_eta_w(params, ai, ti, lo, hi):
        """(chi_t, eta_t) of transition (ai, ti) on rows [lo, hi)."""
        t = allAtoms[ai].trans[ti]
        n = params['allPops'][ai]
        Uji, Vij, Vji = _uv(cfg, params, ai, ti, t, lo, hi)
        return n[t.i] * Vij - n[t.j] * Vji, n[t.j] * Uji

    def chiW(params, ai, ti, lo, hi):
        return chi_eta_w(params, ai, ti, lo, hi)[0]

    def etaW(params, ai, ti, lo, hi):
        return chi_eta_w(params, ai, ti, lo, hi)[1]

    def UjiW(params, ai, ti, lo, hi):
        t = allAtoms[ai].trans[ti]
        return _uv(cfg, params, ai, ti, t, lo, hi)[0]

    def gather(params):
        # Assemble chiTot/etaTot by STATIC wavelength segmentation instead
        # of a per-transition dynamic-update-slice chain: between two
        # consecutive window edges the covering transition set is fixed,
        # so each segment is one fused (background + covering windows)
        # sum and every element of the ray tensor is written exactly once
        # by the final concatenate.  A DUS chain over ~2x Ntrans updates
        # would copy the whole tensor once per update.
        # Per-segment chi/eta contributions are recomputed from phi
        # slices (chi_eta_w), never materialised as full windows.
        spans = [(t.Nblue, t.Nred, ai, ti)
                 for ai, a in enumerate(allAtoms)
                 for ti, t in enumerate(a.trans)]
        edges = sorted({0, Nlam, *(s[0] for s in spans),
                        *(s[1] for s in spans)})
        segsChi, segsEta = [], []
        for s0, s1 in zip(edges[:-1], edges[1:]):
            segChi = params['bgChi'][s0:s1][:, None, None, :]
            segEta = params['bgEta'][s0:s1][:, None, None, :]
            for (nb, nr, ai, ti) in spans:
                if nb <= s0 and s1 <= nr:
                    c, e = chi_eta_w(params, ai, ti, s0, s1)
                    segChi = segChi + c
                    segEta = segEta + e
            shape = (s1 - s0, Nmu, 2, Nk)
            segsChi.append(jnp.broadcast_to(segChi, shape))
            segsEta.append(jnp.broadcast_to(segEta, shape))
        chiTot = jnp.concatenate(segsChi, axis=0)
        etaTot = jnp.concatenate(segsEta, axis=0)
        return chiTot, etaTot

    def formal_solve_2d(params, chiTot, S):
        """2D plane-sweep formal solution per (mu, direction), flattened
        back onto the [Nlam, Nmu, 2, Nk] layout (k = z*Nx + x)."""
        from .ops.formal_solver2d import formal_sol_2d
        Nz, Nx = cfg.Nz, cfg.Nx
        T2 = params['temperature'].reshape(Nz, Nx)
        Iparts, PsiParts, IeffParts = [], [], []
        for d, toObs in ((0, False), (1, True)):
            Imu, PsiMu, IeffMu = [], [], []
            for mu in range(Nmu):
                geom = cfg.geom2d[(mu, toObs)]
                chi_m = chiTot[:, mu, d].reshape(Nlam, Nz, Nx)
                S_m = S[:, mu, d].reshape(Nlam, Nz, Nx)
                thermalised = (cfg.lowerThermalised if toObs
                               else cfg.upperThermalised)
                if thermalised:
                    # thermalised start plane from the ray's DOWNWIND
                    # intersection (fractional-x chi/T interpolation),
                    # exactly as the reference
                    # (ref: FormalScalar2d.cpp:567-612)
                    i0, i1 = (Nz - 1, Nz - 2) if toObs else (0, 1)
                    sA = geom['sAxisZ'][None, :]
                    sW = jnp.asarray(geom['sW'], dt)[None, :]
                    sDs = jnp.asarray(geom['sDs'], dt)[None, :]
                    sJ, sJn = geom['sJ'], geom['sJn']
                    chi0 = chi_m[:, i0]
                    chi1 = chi_m[:, i1]
                    chiDw = jnp.where(
                        sA,
                        (1.0 - sW) * chi0[:, sJn] + sW * chi1[:, sJn],
                        (1.0 - sW) * chi1[:, sJ] + sW * chi1[:, sJn])
                    dtau = 0.5 * (chi0 + chiDw) * sDs
                    T0, T1 = T2[i0], T2[i1]
                    TDw = jnp.where(
                        sA[0],
                        (1.0 - sW[0]) * T0[sJn] + sW[0] * T1[sJn],
                        (1.0 - sW[0]) * T1[sJ] + sW[0] * T1[sJn])
                    Bn = planck_nu(T0[None, :], lamGrid[:, None])
                    BnDw = planck_nu(TDw[None, :], lamGrid[:, None])
                    Iupw = Bn - (BnDw - Bn) / dtau
                else:
                    Iupw = jnp.zeros((Nlam, Nx), dt)
                # solver-name mapping mirrors the reference registries
                # (FormalInterface.cpp:35-42): 'piecewise_besser_2d'
                # selects the BESSER along-ray scheme; the upwind
                # interpolation comes from cfg.interpFn2d
                alongRay = ('besser' if cfg.formalSolver
                            == 'piecewise_besser_2d' else 'linear')
                interp2d = ('besser' if 'besser' in cfg.interpFn2d
                            else 'linear')
                # vertical rays have no x coupling and are never fixed
                # to the x BC (ref: FormalScalar2d.cpp:505-546 only
                # fills the boundary column when mux != 0)
                periodicEff = cfg.xPeriodic or cfg.mux[mu] == 0.0
                Ibc = None
                if not periodicEff:
                    # the most-upwind x column is fixed from the
                    # callable x BC: mux > 0 reads xLowerBc, mux < 0
                    # xUpperBc (ref: FormalScalar2d.cpp:496-546)
                    sgn = 1.0 if toObs else -1.0
                    key = ('xLowerBcData' if sgn * cfg.mux[mu] >= 0
                           else 'xUpperBcData')
                    Ibc = params[key][:, mu, d].astype(dt)  # [Nlam, Nz]
                    # the boundary column keeps the x-BC value on the
                    # starting plane too (the reference's whole-column
                    # pre-fill runs before the z-BC plane loop, which
                    # skips that column)
                    i0 = Nz - 1 if toObs else 0
                    j0 = 0 if geom['dj'] > 0 else Nx - 1
                    Iupw = Iupw.at[:, j0].set(Ibc[:, i0])
                if cfg.mesh2d is not None:
                    from .parallel.xshard2d import (
                        formal_sol_2d_xsharded_traced)
                    I_m, Psi_m, Ieff_m = formal_sol_2d_xsharded_traced(
                        chi_m, S_m, cfg.prepGeom2d[(mu, toObs)], Iupw,
                        mesh=cfg.mesh2d, axisName=cfg.xAxisName,
                        interp=interp2d, periodic=periodicEff, Ibc=Ibc,
                        alongRay=alongRay)
                else:
                    I_m, Psi_m, Ieff_m = formal_sol_2d(
                        chi_m, S_m, geom, Iupw, interp=interp2d,
                        periodic=periodicEff, Ibc=Ibc, alongRay=alongRay)
                Imu.append(I_m.reshape(Nlam, Nk))
                PsiMu.append(Psi_m.reshape(Nlam, Nk))
                IeffMu.append(Ieff_m.reshape(Nlam, Nk))
            Iparts.append(jnp.stack(Imu, axis=1))
            PsiParts.append(jnp.stack(PsiMu, axis=1))
            IeffParts.append(jnp.stack(IeffMu, axis=1))
        I = jnp.stack(Iparts, axis=2)           # [Nlam, Nmu, 2, Nk]
        Psi = jnp.stack(PsiParts, axis=2)
        IeffBase = jnp.stack(IeffParts, axis=2)
        return I, Psi, IeffBase

    def formal_solve(params, chiTot, S):
        T = params['temperature']
        height = params['height']

        # down sweep (toObs=False, d=0): upper BC
        if params.get('upperBcData') is not None:
            Iupw_d = params['upperBcData']
        elif cfg.upperThermalised:
            Bnu0 = planck_nu(T[0], lamGrid)
            Bnu1 = planck_nu(T[1], lamGrid)
            dtau = (0.5 * (chiTot[:, :, 0, 0] + chiTot[:, :, 0, 1])
                    * jnp.abs(height[0] - height[1]) / muz[None, :])
            Iupw_d = Bnu0[:, None] - (Bnu1[:, None] - Bnu0[:, None]) / dtau
        else:
            Iupw_d = jnp.zeros((Nlam, Nmu), dt)

        # up sweep (toObs=True, d=1): lower BC
        if params.get('lowerBcData') is not None:
            Iupw_u = params['lowerBcData']
        elif cfg.lowerThermalised:
            BnuN = planck_nu(T[Nk - 1], lamGrid)
            BnuN1 = planck_nu(T[Nk - 2], lamGrid)
            dtau = (0.5 * (chiTot[:, :, 1, Nk - 1]
                           + chiTot[:, :, 1, Nk - 2])
                    * jnp.abs(height[Nk - 1] - height[Nk - 2])
                    / muz[None, :])
            Iupw_u = BnuN[:, None] - (BnuN1[:, None] - BnuN[:, None]) / dtau
        else:
            Iupw_u = jnp.zeros((Nlam, Nmu), dt)

        muzB = jnp.broadcast_to(muz[None, :], (Nlam, Nmu)).reshape(-1)
        I_d, Psi_d, Ieffb_d = formal_sol_1d(
            chiTot[:, :, 0].reshape(-1, Nk), S[:, :, 0].reshape(-1, Nk),
            height, muzB, Iupw_d.reshape(-1), to_obs=False,
            method=cfg.formalSolver, mode=cfg.recurrenceMode)
        I_u, Psi_u, Ieffb_u = formal_sol_1d(
            chiTot[:, :, 1].reshape(-1, Nk), S[:, :, 1].reshape(-1, Nk),
            height, muzB, Iupw_u.reshape(-1), to_obs=True,
            method=cfg.formalSolver, mode=cfg.recurrenceMode)

        I = jnp.stack([I_d.reshape(Nlam, Nmu, Nk),
                       I_u.reshape(Nlam, Nmu, Nk)], axis=2)
        Psi = jnp.stack([Psi_d.reshape(Nlam, Nmu, Nk),
                         Psi_u.reshape(Nlam, Nmu, Nk)], axis=2)
        IeffBase = jnp.stack([Ieffb_d.reshape(Nlam, Nmu, Nk),
                              Ieffb_u.reshape(Nlam, Nmu, Nk)], axis=2)
        return I, Psi, IeffBase

    def level_sum_on_window(params, fn, ai, a: AtomStatic, t: TransStatic,
                            items, signed):
        """Level-list sum over t's window, members recomputed on the
        overlap rows via ``fn`` (chiW/etaW/UjiW)."""
        out = jnp.zeros((t.W, Nmu, 2, Nk), dt)
        for item in items:
            if signed:
                t2i, sign = item
            else:
                t2i, sign = item, 1
            t2 = a.trans[t2i]
            lo, hi = max(t.Nblue, t2.Nblue), min(t.Nred, t2.Nred)
            if hi <= lo:
                continue
            out = _window_add(out, lo - t.Nblue,
                              sign * fn(params, ai, t2i, lo, hi))
        return out

    def iteration(params, lambdaIterate=False, storeDepthData=False):
        params = _cast_params_to_working(params, dt)
        # J is carried in accumDtype (dJ at 5e-3 tolerance needs ~1e-4
        # relative precision in J, below the f32 noise floor of the
        # wmu-reduction); the formal solve consumes it at working dtype.
        Jdag = params['J'].astype(cfg.accumDtype)
        JdagW = params['J'].astype(cfg.dtype)

        scaJ = params['bgSca'] * JdagW
        chiTot, etaTot = gather(params)
        srcNum = etaTot + scaJ[:, None, None, :]
        S = srcNum / chiTot
        if cfg.Ndim == 2:
            I, Psi, IeffBase = formal_solve_2d(params, chiTot, S)
        else:
            I, Psi, IeffBase = formal_solve(params, chiTot, S)
        if lambdaIterate:
            Psi = jnp.zeros_like(Psi)
            IeffBase = I

        # J's angular sum MUST run in accumDtype: the scattering
        # feedback (sca*Jdag through the formal solution) amplifies
        # J noise by ~1/(1-c) ~ 1e3-1e4 in the Rayleigh/Thomson-
        # dominated deep UV, so a working-dtype (f32) reduction
        # floors dJ at ~1e-2 on FAL-C 5-ray problems (the 40-pt 3-ray
        # test_mixed_precision case converges either way and does NOT
        # catch this).  Do not "optimise" this cast away.
        Jnew = _sum_mu(I.astype(cfg.accumDtype),
                       0.5 * wmu.astype(cfg.accumDtype))
        if cfg.accelerateScattering:
            PsiBarAcc = _sum_mu(Psi.astype(cfg.accumDtype),
                                (0.5 * wmu).astype(cfg.accumDtype))
            Jnew = _accelerate_scattering(
                Jnew, Jdag, PsiBarAcc, params['bgSca'], cfg.accumDtype)
        dJ = jnp.max(jnp.abs(1.0 - jnp.where(Jnew != 0.0, Jdag / Jnew, 1.0)))

        JRest = None
        if cfg.hprd and cfg.prdIdxs is not None:
            # rest-frame mean intensity on the PRD-active subset: linear
            # interpolation of the Doppler-shifted spectrum per (mu,+/-,k)
            # -- the adjoint-tent accumulation of the reference expressed
            # as resampling (ref: Prd.cpp:816-897,
            # SimdFullIterationTemplates.hpp:397-408)
            lamPrd = lamGrid[jnp.asarray(cfg.prdIdxs)]
            vlosMu = params['vlosMu'].astype(dt)         # [Nmu, Nk]
            sgn = jnp.asarray([-1.0, 1.0], dt)
            fac = 1.0 + (sgn[None, :, None] * vlosMu[:, None, :]
                         / Const.CLight)                 # [Nmu, 2, Nk]

            def interp_one(facS, I_S):
                return jnp.interp(lamPrd, lamGrid * facS, I_S)
            f3 = jax.vmap(jax.vmap(jax.vmap(interp_one, in_axes=(0, 1)),
                                   in_axes=(0, 1)), in_axes=(0, 1))
            # fac [Nmu,2,Nk]; I [Nlam,Nmu,2,Nk] -> IRest [Nmu,2,Nk,Nprd]
            IRest = f3(fac, I)
            JRest = jnp.sum(IRest * (0.5 * wmu)[:, None, None, None],
                            axis=(0, 1)).T

        adt = cfg.accumDtype if cfg.accumDtype is not None else dt
        wmu2 = (0.5 * wmu).astype(adt)
        wmu2w = (0.5 * wmu).astype(dt)
        oneBar = jnp.sum(wmu2) * 2.0
        factored = getattr(cfg, 'gammaMode', 'factored') == 'factored'
        blockedAcc = (getattr(cfg, 'gammaAccum', 'exact') == 'blocked'
                      and jnp.dtype(dt) != jnp.dtype(adt))
        # contraction element dtype for the [W, Nk] lambda integrands
        cdt = dt if blockedAcc else adt

        def lam_sum(x):
            """Reduce a [W, Nk] integrand (in cdt) over lambda."""
            if blockedAcc:
                return _sum_lam_blocked(x, adt)
            return jnp.sum(x, axis=0)
        if factored:
            # angular moments shared by all mu-independent (continuum)
            # contractions: avoids broadcasting [W,1,1,Nk] continuum
            # quantities onto the full ray tensor (the dominant HBM
            # traffic of the dense path).  The mu contraction runs in
            # the working dtype BEFORE the accumDtype cast (see
            # _sum_lmd_split for the rationale; no-op when adt == dt).
            PsiBar = _sum_mu(Psi, wmu2w).astype(adt)
            IBar = _sum_mu(I, wmu2w).astype(adt)
            IeffBaseSrcBar = _sum_mu(IeffBase + Psi * srcNum,
                                     wmu2w).astype(adt)

        def eta_atom_on_window(ai, a, lo, hi):
            """Atom's total eta restricted to [lo, hi) as [hi-lo, ...]."""
            out = jnp.zeros((hi - lo, Nmu, 2, Nk), dt)
            for t2i, t2 in enumerate(a.trans):
                l2, h2 = max(lo, t2.Nblue), min(hi, t2.Nred)
                if h2 <= l2:
                    continue
                out = _window_add(
                    out, l2 - lo, etaW(params, ai, t2i, l2, h2))
            return out

        GammaOut, RijOut, RjiOut = [], [], []
        for ai, a in enumerate(cfg.activeAtoms):
            Gamma = (params['crsw'] * params['C'][ai]).astype(adt)
            if not factored:
                etaAtom = jnp.zeros((Nlam, Nmu, 2, Nk), dt)
                for ti, t in enumerate(a.trans):
                    etaAtom = _window_add(etaAtom, t.Nblue,
                                          etaW(params, ai, ti,
                                               t.Nblue, t.Nred))
                # compensated MALI effective intensity: algebraically
                # equal to I - Psi*etaAtom, but assembled from
                # non-cancelling terms so the optically-thick regime
                # (Psi*eta ~ I) keeps full relative precision even in f32
                Ieff = IeffBase + Psi * (srcNum - etaAtom)

            if factored:
                # IeffBar for this atom: global moments minus the
                # Psi*etaAtom moment (continuum part via PsiBar, line
                # parts via narrow-window contractions)
                PsiEtaBar = jnp.zeros((Nlam, Nk), adt)
                for ti, t in enumerate(a.trans):
                    sl = slice(t.Nblue, t.Nred)
                    if t.isLine:
                        contrib = _sum_mu(etaW(params, ai, ti,
                                               t.Nblue, t.Nred) * Psi[sl],
                                          wmu2w).astype(adt)
                    else:
                        contrib = (etaW(params, ai, ti, t.Nblue,
                                        t.Nred)[:, 0, 0, :].astype(adt)
                                   * PsiBar[sl])
                    PsiEtaBar = _window_add(PsiEtaBar, t.Nblue, contrib)
                IeffBarA = IeffBaseSrcBar - PsiEtaBar

                def cont_part_on(fn, items, signed, lo, hi):
                    """[hi-lo, Nk] sum of mu-independent (continuum)
                    members of a level list restricted to [lo, hi),
                    recomputed on the overlap rows via ``fn``."""
                    out = jnp.zeros((hi - lo, Nk), cdt)
                    for item in items:
                        t2i, sign = item if signed else (item, 1)
                        t2 = a.trans[t2i]
                        if t2.isLine:
                            continue
                        l2 = max(lo, t2.Nblue)
                        h2 = min(hi, t2.Nred)
                        if h2 <= l2:
                            continue
                        out = _window_add(
                            out, l2 - lo,
                            sign * fn(params, ai, t2i, l2,
                                      h2)[:, 0, 0, :].astype(cdt))
                    return out

                def cross_bar(t, listX, listU, wlaA):
                    """[Nk] = sum over t's window of
                    wla * wmu2 * Psi * chiLevel * ULevel."""
                    lo, hi = t.Nblue, t.Nred
                    wlaC = wlaA.astype(cdt)
                    XC = cont_part_on(chiW, listX, True, lo, hi)
                    UC = cont_part_on(UjiW, listU, False, lo, hi)
                    total = lam_sum(XC * UC * wlaC
                                    * PsiBar[lo:hi].astype(cdt))
                    # line(chi) x continuum(U) and line x line terms
                    for item in listX:
                        t2i, sign = item
                        t2 = a.trans[t2i]
                        if not t2.isLine:
                            continue
                        l2, h2 = max(lo, t2.Nblue), min(hi, t2.Nred)
                        if h2 <= l2:
                            continue
                        chiSub = chiW(params, ai, t2i, l2, h2)
                        total = total + sign * _sum_lmd_split(
                            chiSub * Psi[l2:h2],
                            UC[l2 - lo:h2 - lo] * wlaA[l2 - lo:h2 - lo],
                            wmu2, wmu2w, adt, blocked=blockedAcc)
                        for t3i in listU:
                            t3 = a.trans[t3i]
                            if not t3.isLine:
                                continue
                            l3 = max(l2, t3.Nblue)
                            h3 = min(h2, t3.Nred)
                            if h3 <= l3:
                                continue
                            total = total + sign * _sum_lmd_split(
                                chiW(params, ai, t2i, l3, h3)
                                * UjiW(params, ai, t3i, l3, h3)
                                * Psi[l3:h3],
                                wlaA[l3 - lo:h3 - lo], wmu2, wmu2w, adt,
                                blocked=blockedAcc)
                    # continuum(chi) x line(U) terms
                    for t3i in listU:
                        t3 = a.trans[t3i]
                        if not t3.isLine:
                            continue
                        l3, h3 = max(lo, t3.Nblue), min(hi, t3.Nred)
                        if h3 <= l3:
                            continue
                        USub = UjiW(params, ai, t3i, l3, h3)
                        total = total + _sum_lmd_split(
                            USub * Psi[l3:h3],
                            XC[l3 - lo:h3 - lo] * wlaA[l3 - lo:h3 - lo],
                            wmu2, wmu2w, adt, blocked=blockedAcc)
                    return total

            Rij, Rji = [], []
            for ti, t in enumerate(a.trans):
                sl = slice(t.Nblue, t.Nred)
                Uji, Vij, Vji = _uv(cfg, params, ai, ti, t)
                wla = _wla(cfg, params, ai, ti, t)         # [W, Nk]
                wlaA = wla.astype(adt)

                if factored and not t.isLine:
                    # mu-independent transition: contract against the
                    # angular moments only (integrands in cdt, reduced
                    # by lam_sum -- exact adt or blocked partials)
                    UjiC = Uji[:, 0, 0, :].astype(cdt)
                    VijC = Vij[:, 0, 0, :].astype(cdt)
                    VjiC = Vji[:, 0, 0, :].astype(cdt)
                    wlaB = wlaA.astype(cdt)
                    oneBarC = oneBar.astype(cdt)
                    Ieff_b = IeffBarA[sl].astype(cdt)
                    Gij = (lam_sum((UjiC * oneBarC + VjiC * Ieff_b) * wlaB)
                           - cross_bar(t, a.chiLists[t.i],
                                       a.ULists[t.j], wlaA))
                    Gji = (lam_sum(VijC * Ieff_b * wlaB)
                           - cross_bar(t, a.chiLists[t.j],
                                       a.ULists[t.i], wlaA))
                    Gamma = Gamma.at[t.i, t.j].add(Gij)
                    Gamma = Gamma.at[t.j, t.i].add(Gji)
                    IBar_w = IBar[sl].astype(cdt)
                    Rij.append(lam_sum(VijC * IBar_w * wlaB))
                    Rji.append(lam_sum((UjiC * oneBarC + VjiC * IBar_w)
                                       * wlaB))
                    continue

                if factored:
                    etaA_w = eta_atom_on_window(ai, a, t.Nblue, t.Nred)
                    Ieff_w = (IeffBase[sl]
                              + Psi[sl] * (srcNum[sl] - etaA_w))
                else:
                    Ieff_w = Ieff[sl]
                Psi_w = Psi[sl]
                I_w = I[sl]
                chi_i = level_sum_on_window(params, chiW, ai, a, t,
                                            a.chiLists[t.i], True)
                chi_j = level_sum_on_window(params, chiW, ai, a, t,
                                            a.chiLists[t.j], True)
                U_i = level_sum_on_window(params, UjiW, ai, a, t,
                                          a.ULists[t.i], False)
                U_j = level_sum_on_window(params, UjiW, ai, a, t,
                                          a.ULists[t.j], False)
                integ_ij = (Uji + Vji * Ieff_w) - Psi_w * chi_i * U_j
                integ_ji = (Vij * Ieff_w) - Psi_w * chi_j * U_i
                Gij = _sum_lmd_split(integ_ij, wlaA, wmu2, wmu2w, adt,
                                blocked=blockedAcc)
                Gji = _sum_lmd_split(integ_ji, wlaA, wmu2, wmu2w, adt,
                                blocked=blockedAcc)
                Gamma = Gamma.at[t.i, t.j].add(Gij)
                Gamma = Gamma.at[t.j, t.i].add(Gji)
                Rij.append(_sum_lmd_split(I_w * Vij, wlaA, wmu2, wmu2w,
                                          adt, blocked=blockedAcc))
                Rji.append(_sum_lmd_split(Uji + I_w * Vji, wlaA, wmu2,
                                          wmu2w, adt, blocked=blockedAcc))

            # finalise: diagonal = -column sums of off-diagonals
            eye = jnp.eye(a.Nlevel, dtype=adt)[:, :, None]
            Gamma = Gamma * (1.0 - eye)
            colSum = jnp.sum(Gamma, axis=0)
            Gamma = Gamma - eye * colSum[None, :, :]
            GammaOut.append(Gamma)
            RijOut.append(Rij)
            RjiOut.append(Rji)

        if cfg.Ndim == 2:
            Iout = I[:, :, 1, :cfg.Nx]   # emergent upgoing top plane
        else:
            Iout = I[:, :, 1, 0]        # emergent (upgoing, top)
        out = {'Gamma': GammaOut, 'Rij': RijOut, 'Rji': RjiOut,
               'J': Jnew, 'I': Iout, 'dJ': dJ}
        if JRest is not None:
            out['JRest'] = JRest
        if storeDepthData:
            # full-resolution capture of chi/eta/I per (lambda, mu, +/-, k)
            # (ref DepthData: /root/reference/Source/LwContext.hpp:12-18)
            out['depthChi'] = chiTot
            out['depthEta'] = etaTot
            out['depthI'] = I
        return out

    # expose the stage closures for component-level benchmarking/tests
    iteration.gather = gather
    iteration.formal_solve = formal_solve
    return iteration


def build_prd_subset_fn(cfg: IterConfig, subIdxs: np.ndarray,
                        prdLines: List[tuple]):
    """Formal solution restricted to the PRD-active wavelength subset.

    Mirrors the reference's ``FsMode::UpdateJ | UpdateRates | PrdOnly``
    (ref: /root/reference/Source/PrdTemplates.hpp:19-113): solve I only
    at the ``subIdxs`` rows of the global grid, update J (and JRest for
    hPRD) there, and accumulate Rij/Rji for the PRD lines alone — Gamma
    and all other transitions' rates are untouched.  Redistribution
    sub-iterations therefore cost FS work proportional to the PRD-active
    fraction of the grid instead of re-running the full-grid MALI step.

    ``subIdxs`` is a static sorted index array; each PRD line's full
    window must be contained in it.  ``prdLines`` is a list of (ai, ti)
    into ``cfg.activeAtoms``.
    """
    subIdxs = np.asarray(subIdxs, np.int64)
    Nsub = len(subIdxs)
    Nmu, Nk = cfg.Nmu, cfg.Nk
    dt = cfg.dtype
    adt = cfg.accumDtype if cfg.accumDtype is not None else dt
    allAtoms = cfg.activeAtoms + cfg.detailedAtoms
    muz = jnp.asarray(cfg.muz, dt)
    wmu = jnp.asarray(cfg.wmu, dt)
    lamSub = jnp.asarray(cfg.wavelength[subIdxs], dt)
    subIdxsJ = jnp.asarray(subIdxs)

    # contiguous runs of subIdxs: (global lo, global hi, dest row)
    segs = []
    start = 0
    for i in range(1, Nsub + 1):
        if i == Nsub or subIdxs[i] != subIdxs[i - 1] + 1:
            segs.append((int(subIdxs[start]), int(subIdxs[i - 1]) + 1,
                         start))
            start = i

    for (ai, ti) in prdLines:
        t = cfg.activeAtoms[ai].trans[ti]
        s0 = int(np.searchsorted(subIdxs, t.Nblue))
        if not np.array_equal(subIdxs[s0:s0 + t.W],
                              np.arange(t.Nblue, t.Nred)):
            raise ValueError('PRD line window not contained in subset')

    def subset_fn(params):
        params = _cast_params_to_working(params, dt)
        chiSub = jnp.broadcast_to(
            params['bgChi'][subIdxsJ][:, None, None, :], (Nsub, Nmu, 2, Nk))
        etaSub = jnp.broadcast_to(
            params['bgEta'][subIdxsJ][:, None, None, :], (Nsub, Nmu, 2, Nk))
        for ai, a in enumerate(allAtoms):
            n = params['allPops'][ai]
            for ti, t in enumerate(a.trans):
                if not any(min(hi, t.Nred) > max(lo, t.Nblue)
                           for lo, hi, _ in segs):
                    continue
                Uji, Vij, Vji = _uv(cfg, params, ai, ti, t)
                chi_t = n[t.i] * Vij - n[t.j] * Vji
                eta_t = n[t.j] * Uji
                for lo, hi, dst in segs:
                    l2, h2 = max(lo, t.Nblue), min(hi, t.Nred)
                    if h2 <= l2:
                        continue
                    sl = slice(l2 - t.Nblue, h2 - t.Nblue)
                    chiSub = _window_add(chiSub, dst + l2 - lo, chi_t[sl])
                    etaSub = _window_add(etaSub, dst + l2 - lo, eta_t[sl])

        Jdag = params['J'][subIdxsJ].astype(adt)
        JdagW = Jdag.astype(dt)
        srcNum = (etaSub + params['bgSca'][subIdxsJ][:, None, None, :]
                  * JdagW[:, None, None, :])
        S = srcNum / chiSub

        T = params['temperature']
        height = params['height']
        muzB = jnp.broadcast_to(muz[None, :], (Nsub, Nmu)).reshape(-1)
        # down sweep (toObs=False): upper BC
        if params.get('upperBcData') is not None:
            Iupw_d = params['upperBcData'][subIdxsJ].reshape(-1)
        elif cfg.upperThermalised:
            Bnu0 = planck_nu(T[0], lamSub)
            Bnu1 = planck_nu(T[1], lamSub)
            dtau = (0.5 * (chiSub[:, :, 0, 0] + chiSub[:, :, 0, 1])
                    * jnp.abs(height[0] - height[1]) / muz[None, :])
            Iupw_d = (Bnu0[:, None]
                      - (Bnu1[:, None] - Bnu0[:, None]) / dtau).reshape(-1)
        else:
            Iupw_d = jnp.zeros(Nsub * Nmu, dt)
        I_d, Psi_d, _ = formal_sol_1d(
            chiSub[:, :, 0].reshape(-1, Nk), S[:, :, 0].reshape(-1, Nk),
            height, muzB, Iupw_d, to_obs=False,
            method=cfg.formalSolver, mode=cfg.recurrenceMode)
        # up sweep (toObs=True): lower BC
        if params.get('lowerBcData') is not None:
            Iupw_u = params['lowerBcData'][subIdxsJ].reshape(-1)
        elif cfg.lowerThermalised:
            BnuN = planck_nu(T[Nk - 1], lamSub)
            BnuN1 = planck_nu(T[Nk - 2], lamSub)
            dtau = (0.5 * (chiSub[:, :, 1, Nk - 1] + chiSub[:, :, 1, Nk - 2])
                    * jnp.abs(height[Nk - 1] - height[Nk - 2])
                    / muz[None, :])
            Iupw_u = (BnuN[:, None]
                      - (BnuN1[:, None] - BnuN[:, None]) / dtau).reshape(-1)
        else:
            Iupw_u = jnp.zeros(Nsub * Nmu, dt)
        I_u, Psi_u, _ = formal_sol_1d(
            chiSub[:, :, 1].reshape(-1, Nk), S[:, :, 1].reshape(-1, Nk),
            height, muzB, Iupw_u, to_obs=True,
            method=cfg.formalSolver, mode=cfg.recurrenceMode)
        I = jnp.stack([I_d.reshape(Nsub, Nmu, Nk),
                       I_u.reshape(Nsub, Nmu, Nk)], axis=2)

        wmu2 = (0.5 * wmu).astype(adt)
        wmu2w = (0.5 * wmu).astype(dt)
        # accumDtype angular sum (see the main iteration's Jnew note:
        # scattering feedback amplifies J noise ~1e3x)
        Jnew = _sum_mu(I.astype(adt), wmu2)
        if cfg.accelerateScattering:
            Psi = jnp.stack([Psi_d.reshape(Nsub, Nmu, Nk),
                             Psi_u.reshape(Nsub, Nmu, Nk)], axis=2)
            Jnew = _accelerate_scattering(
                Jnew, Jdag, _sum_mu(Psi.astype(adt), wmu2),
                params['bgSca'][subIdxsJ], adt)
        dJ = jnp.max(jnp.abs(1.0 - jnp.where(Jnew != 0.0, Jdag / Jnew, 1.0)))

        JRest = None
        if cfg.hprd and cfg.prdIdxs is not None:
            # rest-frame mean intensity on the PRD-active subset, from the
            # subset rows only (subIdxs covers all lambdas that scatter
            # into the PRD region — ref: Prd.cpp:760-811)
            lamPrd = jnp.asarray(cfg.wavelength[cfg.prdIdxs], dt)
            vlosMu = params['vlosMu'].astype(dt)
            sgn = jnp.asarray([-1.0, 1.0], dt)
            fac = 1.0 + (sgn[None, :, None] * vlosMu[:, None, :]
                         / Const.CLight)

            def interp_one(facS, I_S):
                return jnp.interp(lamPrd, lamSub * facS, I_S)
            f3 = jax.vmap(jax.vmap(jax.vmap(interp_one, in_axes=(0, 1)),
                                   in_axes=(0, 1)), in_axes=(0, 1))
            IRest = f3(fac, I)
            JRest = jnp.sum(IRest * (0.5 * wmu)[:, None, None, None],
                            axis=(0, 1)).T

        RijOut, RjiOut = [], []
        for (ai, ti) in prdLines:
            t = cfg.activeAtoms[ai].trans[ti]
            s0 = int(np.searchsorted(subIdxs, t.Nblue))
            I_w = I[s0:s0 + t.W]
            Uji, Vij, Vji = _uv(cfg, params, ai, ti, t)
            wlaA = _wla(cfg, params, ai, ti, t).astype(adt)
            RijOut.append(_sum_lmd_split(I_w * Vij, wlaA, wmu2, wmu2w,
                                         adt))
            RjiOut.append(_sum_lmd_split(Uji + I_w * Vji, wlaA, wmu2,
                                         wmu2w, adt))

        out = {'J': Jnew, 'I': I[:, :, 1, 0], 'dJ': dJ,
               'Rij': RijOut, 'Rji': RjiOut}
        if JRest is not None:
            out['JRest'] = JRest
        return out

    return subset_fn


@partial(jax.jit)
@jax.jit
def _stat_eq_solve(Gamma, n, nTotal):
    """Batched-over-depth statistical equilibrium: replace the row of the
    largest population with particle conservation and solve.
    ref: /root/reference/Source/UpdatePopulations.cpp:7-47

    jitted: the unrolled KxK elimination is hundreds of small ops;
    dispatched eagerly each would be a separate device launch."""
    Nl = Gamma.shape[0]
    iElim = jnp.argmax(n, axis=0)                       # [Nk]
    rowMask = (jnp.arange(Nl)[:, None] == iElim[None, :])   # [Nl, Nk]
    G = jnp.where(rowMask[:, None, :], 1.0, Gamma)      # [Nl, Nl, Nk]
    rhs = jnp.where(rowMask, nTotal[None, :], 0.0)      # [Nl, Nk]
    return solve_KxK_over_depth(G, rhs)


@partial(jax.jit, static_argnames=('theta',))
def _time_dep_solve(Gamma, nOld, dt, theta=1.0):
    """Fully-implicit (backward-Euler) time-dependent population update:
    solve (I - theta dt Gamma) n_new = n_old.
    ref: /root/reference/Source/UpdatePopulations.cpp:120-151"""
    Nl = Gamma.shape[0]
    eye = jnp.eye(Nl, dtype=Gamma.dtype)[:, :, None]
    M = eye - theta * dt * Gamma
    return solve_KxK_over_depth(M, nOld)


class Context:
    """NLTE radiative transfer context over a single atmosphere.

    Mirrors the user-facing API of the reference's LwContext: construct
    from (atmos, spect, eqPops), then iterate formal_sol_gamma_matrices /
    stat_equil to convergence, and read I / J / populations.
    """

    def __init__(self, atmos: Atmosphere, spect, eqPops,
                 ngOptions=None, initSol=None, conserveCharge: bool = False,
                 nrHOnly: bool = False, hprd: bool = False,
                 formalSolver: str = 'piecewise_bezier3_1d',
                 interpFn2d: str = 'interp_linear_2d',
                 recurrenceMode: Optional[str] = None,
                 backgroundProvider=None,
                 crswCallback=None,
                 dtype=None, accumDtype=None,
                 accelerateScattering: bool = False,
                 mesh=None, meshXAxis: str = 'x',
                 fsIterScheme: Optional[str] = None,
                 gammaAccum: Optional[str] = None):
        self.atmos = atmos
        self.spect = spect
        self.eqPops = eqPops
        self.conserveCharge = conserveCharge
        self.nrHOnly = nrHOnly
        self.crswCallback = crswCallback
        self.crswDone = crswCallback is None
        # Autotuned/persisted defaults (lightweaverrc) -- the analogue of
        # the reference Context reading its config-selected SIMD impl
        # (ref: /root/reference/lightweaver/LwCompiled context creation)
        from .config import params as _cfgParams
        if recurrenceMode is None:
            recurrenceMode = _cfgParams.get('RecurrenceMode', 'scan')
        if recurrenceMode not in RECURRENCE_MODES:
            raise ValueError(f'Unknown recurrenceMode {recurrenceMode!r}; '
                             f'available: {RECURRENCE_MODES}')
        if dtype is None and _cfgParams.get('Precision') == 'mixed':
            dtype = jnp.float32
        if dtype is None:
            dtype = (jnp.float64 if jax.config.read('jax_enable_x64')
                     else jnp.float32)
        self.dtype = dtype
        if accumDtype is None:
            accumDtype = (jnp.float64 if (dtype == jnp.float32
                          and jax.config.read('jax_enable_x64')) else dtype)
        self.accumDtype = accumDtype
        radSet = spect.radSet

        if atmos.muz is None:
            raise ValueError('Atmosphere angular quadrature not set')

        activeAtoms = [self._build_atom_static(m, False)
                       for m in sorted(radSet.activeAtoms,
                                       key=lambda a: a.element)]
        detailedAtoms = [self._build_atom_static(m, True)
                         for m in sorted(radSet.detailedAtoms,
                                         key=lambda a: a.element)]

        self.cfg = IterConfig(
            activeAtoms=activeAtoms, detailedAtoms=detailedAtoms,
            Nlam=spect.Nspect, Nmu=atmos.Nrays, Nk=atmos.Nspace,
            lowerThermalised=isinstance(atmos.lowerBc, ThermalisedRadiation),
            upperThermalised=isinstance(atmos.upperBc, ThermalisedRadiation),
            formalSolver=formalSolver, interpFn2d=interpFn2d,
            recurrenceMode=recurrenceMode,
            dtype=dtype, wavelength=np.asarray(spect.wavelength),
            muz=np.asarray(atmos.muz), wmu=np.asarray(atmos.wmu),
            accumDtype=accumDtype,
            accelerateScattering=accelerateScattering,
            gammaAccum=gammaAccum if gammaAccum is not None else
            _cfgParams.get('GammaAccum', 'exact'))

        if atmos.Ndim == 2:
            from .ops.formal_solver2d import build_geometry_2d
            self.cfg.Ndim = 2
            self.cfg.Nz = atmos.Nz
            self.cfg.Nx = atmos.Nx
            self.cfg.zGrid = np.asarray(atmos.zGrid)
            self.cfg.mux = np.asarray(atmos.mux)
            xlP = isinstance(atmos.xLowerBc, PeriodicRadiation)
            xuP = isinstance(atmos.xUpperBc, PeriodicRadiation)
            if xlP != xuP:
                raise ValueError('Mixed x boundary types not supported: '
                                 'both periodic or both callable')
            self.cfg.xPeriodic = xlP
            geom = {}
            for mu in range(atmos.Nrays):
                for toObs in (False, True):
                    sgn = 1.0 if toObs else -1.0
                    geom[(mu, toObs)] = build_geometry_2d(
                        np.asarray(atmos.x), np.asarray(atmos.zGrid),
                        sgn * atmos.mux[mu], sgn * atmos.muz[mu], toObs,
                        periodic=self.cfg.xPeriodic)
            self.cfg.geom2d = geom
            if mesh is not None:
                # x-sharded 2D iteration: precompute the sweep-ordered
                # geometry once so the jitted iteration's sharded sweep
                # touches no host numpy (kills the per-call prep of the
                # standalone formal_sol_2d_xsharded path)
                from .parallel.xshard2d import prep_xshard_geometry
                p = mesh.shape[meshXAxis]
                if atmos.Nx % p != 0 or atmos.Nx // p < 2:
                    raise ValueError(
                        f'Nx={atmos.Nx} must be divisible by the '
                        f'{meshXAxis!r} mesh axis ({p}) with >= 2 '
                        'columns per shard')
                self.cfg.mesh2d = mesh
                self.cfg.xAxisName = meshXAxis
                self.cfg.prepGeom2d = {
                    key: prep_xshard_geometry(g, atmos.Nz, atmos.Nx,
                                              dtype)
                    for key, g in geom.items()}
        elif mesh is not None:
            raise ValueError('mesh= is only supported for 2D atmospheres '
                             '(1.5D column batches shard via '
                             'parallel.columns.ColumnBatch)')

        if backgroundProvider is None:
            backgroundProvider = basic_background
        self.backgroundProvider = backgroundProvider
        bg = backgroundProvider(spect, atmos, eqPops, radSet)
        self.background = bg

        dtc = dtype
        self.bgChi = jnp.asarray(bg.chi, dtc)
        self.bgEta = jnp.asarray(bg.eta, dtc)
        self.bgSca = jnp.asarray(bg.sca, dtc)
        self.temperature = jnp.asarray(atmos.temperature, dtc)
        self.height = jnp.asarray(atmos.height, dtc)

        self.J = jnp.zeros((spect.Nspect, atmos.Nspace), accumDtype)
        self.I = jnp.zeros((spect.Nspect, atmos.Nrays), dtc)
        self.popsState = []
        for a in activeAtoms:
            st = eqPops.atomicPops[a.model.element]
            self.popsState.append({'n': jnp.asarray(st.n, dtc),
                                   'nStar': jnp.asarray(st.nStar, dtc)})
        self.detailedPops = []
        for a in detailedAtoms:
            st = eqPops.atomicPops[a.model.element]
            self.detailedPops.append({'n': jnp.asarray(st.n, dtc),
                                      'nStar': jnp.asarray(st.nStar, dtc)})

        self.C = [np.zeros((a.Nlevel, a.Nlevel, atmos.Nspace))
                  for a in activeAtoms]
        self.compute_collisions()
        self.compute_profiles()

        # PRD emission-profile ratio rho per (active atom, PRD line);
        # detailed atoms padded with None so all-atom indexing works
        self.rhoPrd = [[jnp.ones((t.W, atmos.Nspace), dtype)
                        if (t.isLine and t.isPrd) else None
                        for t in a.trans] for a in activeAtoms]
        self.rhoPrd += [[None] * len(a.trans) for a in detailedAtoms]
        self.JRest = None
        if hprd and self._prd_lines():
            self._configure_hprd_coeffs()

        from .utils import InitialSolution
        if initSol == InitialSolution.EscapeProbability:
            from .escape import set_pops_escape_probability
            set_pops_escape_probability(self)

        from .ops.ng import Ng, NgOptions
        if ngOptions is None:
            ngOptions = NgOptions(0, 0, 0)
        self.ngs = [Ng(ngOptions.Norder, ngOptions.Nperiod, ngOptions.Ndelay,
                       np.asarray(st['n']).ravel())
                    for st in self.popsState]

        self._iter_fn = None
        self._Gamma = None
        self._Rij = None
        self._Rji = None
        self.J20 = None
        self._prd_fs_fn = None
        self._prdSubIdxs = None
        # persistent per-line Ng accelerators on rho.  The reference
        # tracks rho with Ng(0,0,0) (ref: PrdTemplates.hpp:205,263);
        # prdNgOptions opts in to actual extrapolation, which cuts the
        # number of redistribution sub-iterations on slow PRD problems.
        self.prdNgOptions = None
        self._prdNgs = None
        # 'subset' = reference FsMode::PrdOnly semantics (FS cost of a
        # rho sub-iteration scales with the PRD-active fraction of the
        # grid); 'full' re-runs the full-grid MALI step instead.
        self.prdFsMode = 'subset'

        from types import SimpleNamespace
        # opt-in full-resolution chi/eta/I capture
        # (ref: /root/reference/Source/LwMiddleLayer.pyx:469-553)
        self.depthData = SimpleNamespace(fill=False, chi=None, eta=None,
                                         I=None)

        # an explicit or lightweaverrc-sourced scheme that does not
        # exist raises: no silent fallback to another scheme
        self.set_fs_iter_scheme(
            fsIterScheme if fsIterScheme is not None
            else _cfgParams.get('IterationScheme', 'mali_full_precond'))

    # expose static atom lists like before
    @property
    def activeAtoms(self):
        return self.cfg.activeAtoms

    @property
    def detailedAtoms(self):
        return self.cfg.detailedAtoms

    # ------------------------------------------------------------------
    def _build_atom_static(self, model: AtomicModel, detailed: bool) \
            -> AtomStatic:
        spect = self.spect
        trans = []
        for t in model.transitions:
            ident = t.transId
            if ident not in spect.blueIdx:
                continue
            Nblue = spect.blueIdx[ident]
            Nred = spect.redIdx[ident]
            grid = spect.wavelength[Nblue:Nred]
            if isinstance(t, AtomicLine):
                from .atomic_model import LineType
                ts = TransStatic(
                    isLine=True, i=t.i, j=t.j, Nblue=Nblue, Nred=Nred,
                    lambda0=t.lambda0, Aji=t.Aji, Bji=t.Bji, Bij=t.Bij,
                    wavelength=np.asarray(grid),
                    wlambda=_wlambda(grid, Const.CLight / t.lambda0),
                    polarisable=t.polarisable,
                    isPrd=(t.type == LineType.PRD and not detailed))
            else:
                ts = TransStatic(
                    isLine=False, i=t.i, j=t.j, Nblue=Nblue, Nred=Nred,
                    lambda0=t.lambda0,
                    wavelength=np.asarray(grid),
                    wlambda=_wlambda(grid, 1.0),
                    alpha=t.alpha(np.asarray(grid)))
            trans.append(ts)
        a = AtomStatic(model=model, Nlevel=len(model.levels), trans=trans,
                       detailed=detailed)
        a.build_overlaps()
        return a

    # ------------------------------------------------------------------
    def compute_profiles(self):
        """Voigt profiles phi [W, Nmu, 2, Nspace] and normalisation wphi
        per line (ref: /root/reference/Source/FormalScalar.cpp:28-134)."""
        atmos = self.atmos
        dt = self.dtype
        vlosMu = jnp.asarray(atmos.vlos_mu(), dt)       # [Nmu, Nk]
        wmu = jnp.asarray(atmos.wmu, dt)
        self.phi = []      # [atom][trans] -> [W, Nmu, 2, Nk] or None
        self.wphi = []     # [atom][trans] -> [Nk] or None
        self.aDamp = []    # [atom][trans] -> [Nk] np or None (PRD needs it)
        self.Qelast = []
        for a in self.cfg.activeAtoms + self.cfg.detailedAtoms:
            vBroad = jnp.asarray(a.model.vBroad(atmos), dt)
            phiA, wphiA = [], []
            aDampA, QelastA = [], []
            lineByIdx = {(l.i, l.j): l for l in a.model.lines}
            for t in a.trans:
                if not t.isLine:
                    phiA.append(None)
                    wphiA.append(None)
                    aDampA.append(None)
                    QelastA.append(None)
                    continue
                line = lineByIdx[(t.i, t.j)]
                lam = jnp.asarray(t.wavelength, dt)
                vBase = (lam - t.lambda0) * Const.CLight / t.lambda0   # [W]
                s = jnp.asarray([-1.0, 1.0], dt)

                def voigt_cb(aDamp, vB, _vBase=vBase):
                    # Profiles are a one-off host-side setup cost:
                    # evaluate in f64 regardless of the state dtype, so
                    # the f32 path gets correctly-rounded phi (f32-native
                    # evaluation left the MALI fixed point riding on the
                    # profile's last bits -- rounding-induced dJ limit
                    # cycles at ~1e-2).
                    f64 = jnp.float64
                    aDamp = jnp.asarray(aDamp, f64)
                    vB = jnp.asarray(vB, f64)
                    vk = ((jnp.asarray(_vBase, f64)[:, None, None, None]
                           + jnp.asarray(s, f64)[None, None, :, None]
                           * jnp.asarray(vlosMu, f64)[None, :, None, :])
                          / vB[None, None, None, :])
                    return (voigt_H(aDamp[None, None, None, :], vk)
                            / (Const.SqrtPi * vB[None, None, None, :]))

                # LineProfileState protocol: user AtomicLine subclasses may
                # override compute_phi for custom profiles
                # (ref: /root/reference/lightweaver/atomic_model.py:605-630)
                res = line.compute_phi(LineProfileState(
                    wavelength=np.asarray(t.wavelength), vlosMu=vlosMu,
                    atmos=atmos, eqPops=self.eqPops,
                    default_voigt_callback=voigt_cb,
                    vBroad=np.asarray(vBroad)))
                aDampA.append(np.asarray(res.aDamp))
                QelastA.append(np.asarray(res.Qelast))
                phi = jnp.asarray(res.phi, dt)
                wla = jnp.asarray(t.wlambda, dt)
                wphi_inv = jnp.einsum('lmdk,l,m->k', phi, wla, 0.5 * wmu,
                                      precision=lax.Precision.HIGHEST)
                phiA.append(phi)
                wphiA.append(1.0 / wphi_inv)
            self.phi.append(phiA)
            self.wphi.append(wphiA)
            self.aDamp.append(aDampA)
            self.Qelast.append(QelastA)

    # ------------------------------------------------------------------
    def compute_collisions(self, force: bool = False):
        """(Re)compute collisional rate matrices.  Cached: they depend only
        on (T, ne, nStar), which change via update_deps / charge
        conservation, not during plain MALI iteration."""
        if not force and getattr(self, '_collisionsClean', False):
            return
        for a, C in zip(self.cfg.activeAtoms, self.C):
            C.fill(0.0)
            for col in a.model.collisions:
                col.compute_rates(self.atmos, self.eqPops, C)
            np.clip(C, 0.0, None, out=C)
        self._collisionsClean = True
        self._CDevDirty = True

    # ------------------------------------------------------------------
    def build_params(self, crswVal: float = 1.0) -> Dict:
        return {
            'J': self.J,
            'bgChi': self.bgChi, 'bgEta': self.bgEta, 'bgSca': self.bgSca,
            'temperature': self.temperature, 'height': self.height,
            'pops': [st['n'] for st in self.popsState],
            'nStar': [st['nStar'] for st in self.popsState],
            'detPops': [st['n'] for st in self.detailedPops],
            'detNStar': [st['nStar'] for st in self.detailedPops],
            'C': self._deviceC(),
            'crsw': jnp.asarray(crswVal, self.dtype),
            'phi': self.phi, 'wphi': self.wphi,
            'rhoPrd': self.rhoPrd,
            'upperBcData': self._bc_data(self.atmos.upperBc),
            'lowerBcData': self._bc_data(self.atmos.lowerBc),
            'xLowerBcData': self._x_bc_data(
                getattr(self.atmos, 'xLowerBc', None)),
            'xUpperBcData': self._x_bc_data(
                getattr(self.atmos, 'xUpperBc', None)),
            # hybrid-PRD per-depth data rides in params (not cfg) so the
            # iteration stays vmappable over columns with per-column
            # velocity fields (ColumnBatch hPRD)
            'vlosMu': (jnp.asarray(self.cfg.vlosMu, self.dtype)
                       if self.cfg.hprd and self.cfg.vlosMu is not None
                       else None),
            'hprdI0': self._hprd_coeff_params(0),
            'hprdFrac': self._hprd_coeff_params(1),
        }

    def _hprd_coeff_params(self, which: int):
        """Nested [atom][trans] list of hPRD interpolation coefficient
        arrays (0 = i0 indices, 1 = fractions), None-padded like phi."""
        if not self.cfg.hprd or self.cfg.hprdCoeffs is None:
            return None
        allAtoms = self.cfg.activeAtoms + self.cfg.detailedAtoms
        out = []
        for ai, a in enumerate(allAtoms):
            row = []
            for ti, t in enumerate(a.trans):
                c = self.cfg.hprdCoeffs.get((ai, ti))
                if c is None:
                    row.append(None)
                elif which == 0:
                    row.append(jnp.asarray(c[0]))
                else:
                    row.append(jnp.asarray(c[1], self.dtype))
            out.append(row)
        return out

    def _bc_data(self, bc):
        """Evaluate a user-callable boundary condition to
        I_incident[Nlam, Nmu], or None for analytic BC types.
        ref: /root/reference/Source/LwMiddleLayer.pyx:765-829"""
        data = bc.compute_bc(self.atmos, self.spect)
        if data is None:
            return None
        data = np.asarray(data, np.float64)
        if data.ndim == 3:          # [Nlam, Nmu, Nspatial=1]
            data = data[..., 0]
        return jnp.asarray(data, self.dtype)

    def _x_bc_data(self, bc):
        """Evaluate a callable x boundary condition for non-periodic 2D
        atmospheres to I_incident[Nlam, Nmu, 2, Nz] ((up, down) like the
        intensity layout), or None for periodic / absent / 1D.
        ref: /root/reference/Source/FormalScalar2d.cpp:496-546"""
        if self.cfg.Ndim != 2 or self.cfg.xPeriodic or bc is None:
            return None
        data = bc.compute_bc(self.atmos, self.spect)
        if data is None:
            return None
        data = np.asarray(data, np.float64)
        if data.shape != (self.cfg.Nlam, self.cfg.Nmu, 2, self.cfg.Nz):
            raise ValueError(
                'Callable x BC must return [Nlam, Nmu, 2(down,up), Nz], '
                f'got {data.shape}')
        return jnp.asarray(data, self.dtype)

    def _deviceC(self):
        if getattr(self, '_CDev', None) is None or self._CDevDirty:
            self._CDev = [jnp.asarray(C, self.dtype) for C in self.C]
            self._CDevDirty = False
        return self._CDev

    # ------------------------------------------------------------------
    def formal_sol_gamma_matrices(self, lambdaIterate: bool = False,
                                  printUpdate: bool = False) \
            -> IterationUpdate:
        """One full MALI step: formal solution over all wavelengths with
        Gamma-matrix and rate accumulation.
        ref: /root/reference/Source/LwMiddleLayer.pyx:3152"""
        if self._iter_fn is None:
            self._iter_fn = jax.jit(
                build_iteration_fn(self.cfg),
                static_argnames=('lambdaIterate', 'storeDepthData'))

        crswVal = self.crswCallback() if self.crswCallback is not None else 1.0
        self.crswDone = crswVal == 1.0
        self._crswVal = crswVal
        self.compute_collisions()
        if getattr(self, '_params', None) is None:
            self._params = self.build_params(crswVal)
        p = self._params
        p['J'] = self.J
        p['pops'] = [st['n'] for st in self.popsState]
        p['nStar'] = [st['nStar'] for st in self.popsState]
        p['C'] = self._deviceC()
        p['crsw'] = jnp.asarray(crswVal, self.dtype)
        p['rhoPrd'] = self.rhoPrd
        p['upperBcData'] = self._bc_data(self.atmos.upperBc)
        p['lowerBcData'] = self._bc_data(self.atmos.lowerBc)
        p['xLowerBcData'] = self._x_bc_data(
            getattr(self.atmos, 'xLowerBc', None))
        p['xUpperBcData'] = self._x_bc_data(
            getattr(self.atmos, 'xUpperBc', None))
        if self.cfg.mesh2d is not None:
            # one input layout on every call: the iteration and the
            # stat-eq solve hand back J and the populations sharded over
            # x, and a new input sharding compiles the iteration again
            from jax.sharding import NamedSharding, PartitionSpec
            p['J'], p['pops'] = jax.device_put(
                (p['J'], p['pops']),
                NamedSharding(self.cfg.mesh2d, PartitionSpec()))
        out = self._iter_fn(p, lambdaIterate=lambdaIterate,
                            storeDepthData=self.depthData.fill)
        self._Gamma = out['Gamma']
        self._Rij = out['Rij']
        self._Rji = out['Rji']
        self.J = out['J']
        self.I = out['I']
        if 'JRest' in out:
            self.JRest = out['JRest']
        if self.depthData.fill:
            self.depthData.chi = out['depthChi']
            self.depthData.eta = out['depthEta']
            self.depthData.I = out['depthI']
        return IterationUpdate(self, updatedJ=True, dJMax=out['dJ'],
                               crsw=crswVal)

    # ------------------------------------------------------------------
    def stat_equil(self) -> IterationUpdate:
        """Statistical equilibrium solve for each active atom; with
        conserveCharge, followed by a Newton-Raphson charge-conservation
        step coupling the populations and ne.
        ref: /root/reference/Source/LwMiddleLayer.pyx:3461-3560"""
        if self._Gamma is None:
            raise ValueError('Call formal_sol_gamma_matrices first')
        for ai, a in enumerate(self.cfg.activeAtoms):
            st = self.popsState[ai]
            nTotal = jnp.asarray(
                self.eqPops.atomicPops[a.model.element].nTotal, self.dtype)
            st['n'] = _stat_eq_solve(self._Gamma[ai], st['n'],
                                     nTotal).astype(self.dtype)

        dNeMax = None
        if self.conserveCharge:
            dNeMax = self.nr_post_update(hOnly=self.nrHOnly)

        dPops = []
        accelerated = False
        ngActive = any(ng.Norder > 0 for ng in self.ngs)
        if ngActive or self.conserveCharge:
            # host path: Ng extrapolation / NR coupling need the
            # populations on the host every iteration
            for ai, st in enumerate(self.popsState):
                nNew = st['n']
                nHost = np.asarray(nNew)
                if not np.all(np.isfinite(nHost)):
                    from .utils import ExplodingMatrixError
                    name = self.cfg.activeAtoms[ai].model.element.name
                    raise ExplodingMatrixError(
                        f'Non-finite populations for atom {name} after '
                        'the statistical-equilibrium solve (singular '
                        'Gamma matrix)')
                accel, sol = self.ngs[ai].accelerate(nHost)
                if accel:
                    nNew = jnp.asarray(sol.reshape(nNew.shape),
                                       self.dtype)
                    accelerated = True
                dPops.append(self.ngs[ai].max_change())
                st['n'] = nNew
        else:
            # single-pull path: each device->host fetch synchronises
            # with the device, so instead of per-atom pops pulls compute
            # the max-change and finite flags on device and fetch ONE
            # packed vector.  Semantics match Ng.max_change exactly: 0.0
            # until two post-solve solutions exist, then
            # max |(cur - old)/cur| over cur != 0.
            flags = []
            for ai, st in enumerate(self.popsState):
                nNew = st['n']
                nOld = st.get('nLastSE')
                if nOld is None:
                    dp = jnp.zeros((), jnp.float64)
                else:
                    mask = nNew != 0.0
                    dp = jnp.max(jnp.where(
                        mask, jnp.abs((nNew - nOld)
                                      / jnp.where(mask, nNew, 1.0)),
                        0.0))
                flags.append(dp.astype(jnp.float64))
                flags.append(jnp.all(jnp.isfinite(nNew))
                             .astype(jnp.float64))
                st['nLastSE'] = nNew
            vals = np.asarray(jnp.stack(flags))
            for ai in range(len(self.popsState)):
                if vals[2 * ai + 1] == 0.0:
                    from .utils import ExplodingMatrixError
                    name = self.cfg.activeAtoms[ai].model.element.name
                    raise ExplodingMatrixError(
                        f'Non-finite populations for atom {name} after '
                        'the statistical-equilibrium solve (singular '
                        'Gamma matrix)')
                dPops.append(float(vals[2 * ai]))
        upd = IterationUpdate(self, updatedPops=True, dPops=dPops,
                              ngAccelerated=accelerated)
        if dNeMax is not None:
            upd.updatedNe = True
            upd.dNeMax = dNeMax
        return upd

    # ------------------------------------------------------------------
    def _fd_dC(self, atoms, atomIdx, crswVal: float, pertSize: float = 1e-4):
        """Finite-difference dC/dne: perturb ne by 1e-4 relative, refresh
        the atom's LTE populations, and recompute its collisional rates.
        ref: /root/reference/lightweaver/nr_update.py:75-92"""
        from .atomic_set import lte_pops
        atmos = self.atmos
        neStart = np.asarray(atmos.ne).copy()
        pert = neStart * pertSize
        dCs = []
        for a, ai in zip(atoms, atomIdx):
            state = self.eqPops.atomicPops[a.model.element]
            Cprev = self.C[ai]
            atmos.ne[:] = neStart + pert
            nStarPrev = state.nStar.copy()
            state.nStar[:] = lte_pops(a.model, atmos.temperature, atmos.ne,
                                      state.nTotal, debye=True)
            Cpert = np.zeros_like(Cprev)
            for col in a.model.collisions:
                col.compute_rates(atmos, self.eqPops, Cpert)
            np.clip(Cpert, 0.0, None, out=Cpert)
            atmos.ne[:] = neStart
            state.nStar[:] = nStarPrev
            dCs.append(jnp.asarray(crswVal * (Cpert - Cprev) / pert,
                                   self.dtype))
        return dCs

    def nr_post_update(self, fdCollisionRates: bool = True,
                       hOnly: bool = False, timeDependentData=None,
                       stepLimit: bool = True) -> float:
        """Newton-Raphson charge-conservation update of (populations, ne).
        Returns the max relative change in ne.  stepLimit=False takes the
        reference's raw Newton step (see nr_update.build_nr_fn).
        ref: /root/reference/lightweaver/nr_update.py:7-106"""
        from .atomic_table import PeriodicTable
        from .nr_update import build_nr_fn
        if self.cfg.activeAtoms[0].model.element != PeriodicTable.element(1):
            raise ValueError(
                'Calling nr_post_update without Hydrogen active.')
        atoms = (self.cfg.activeAtoms[:1] if hOnly
                 else self.cfg.activeAtoms)
        atomIdx = list(range(len(atoms)))
        crswVal = getattr(self, '_crswVal', 1.0)
        timeDep = timeDependentData is not None

        # background electron contribution from non-NR species
        if hOnly:
            bgModels = [m for m in self.spect.radSet
                        if m.element != PeriodicTable.element(1)]
        else:
            bgModels = (self.spect.radSet.detailedAtoms
                        + self.spect.radSet.passiveAtoms)
        backgroundNe = np.zeros_like(np.asarray(self.atmos.ne))
        for m in bgModels:
            stages = np.array([l.stage for l in m.levels], dtype=np.float64)
            n = self.eqPops.atomicPops[m.element].n
            backgroundNe += np.sum(stages[:, None] * n, axis=0)

        dCs = (self._fd_dC(atoms, atomIdx, crswVal)
               if fdCollisionRates else None)

        key = (len(atoms), timeDep, fdCollisionRates, stepLimit)
        if getattr(self, '_nrFnKey', None) != key:
            Nlevels = [a.Nlevel for a in atoms]
            stagesList = [np.array([l.stage for l in a.model.levels],
                                   dtype=np.float64) for a in atoms]
            contPairs = [[(t.i, t.j) for t in a.trans if not t.isLine]
                         for a in atoms]
            self._nrFn = build_nr_fn(Nlevels, stagesList, contPairs,
                                     timeDep, self.dtype,
                                     stepLimit=stepLimit)
            self._nrFnKey = key

        Gammas = [self._Gamma[ai] for ai in atomIdx]
        ns = [self.popsState[ai]['n'] for ai in atomIdx]
        nTotals = [jnp.asarray(
            self.eqPops.atomicPops[a.model.element].nTotal, self.dtype)
            for a in atoms]
        Cs = [self._deviceC()[ai] for ai in atomIdx]
        ne = jnp.asarray(self.atmos.ne, self.dtype)
        bgNe = jnp.asarray(backgroundNe, self.dtype)
        crsw = jnp.asarray(crswVal, self.dtype)
        if timeDep:
            newNs, newNe = self._nrFn(
                Gammas, ns, nTotals, Cs, dCs, ne, bgNe, crsw,
                jnp.asarray(timeDependentData['dt'], self.dtype),
                [jnp.asarray(p, self.dtype)
                 for p in timeDependentData['nPrev'][:len(atoms)]])
        else:
            newNs, newNe = self._nrFn(Gammas, ns, nTotals, Cs, dCs, ne,
                                      bgNe, crsw)

        for ai, nNew in zip(atomIdx, newNs):
            self.popsState[ai]['n'] = nNew
        neStart = np.asarray(self.atmos.ne).copy()
        neNew = np.asarray(newNe, np.float64)
        self.atmos.ne[:] = neNew

        # refresh LTE populations / H- for the new ne, and push nStar back
        # to the device (continuum gij depends on it)
        self.eqPops.update_lte_atoms_Hmin_pops(self.atmos,
                                               conserveCharge=False)
        for a, st in zip(self.cfg.activeAtoms, self.popsState):
            st['nStar'] = jnp.asarray(
                self.eqPops.atomicPops[a.model.element].nStar, self.dtype)
        for a, st in zip(self.cfg.detailedAtoms, self.detailedPops):
            st['nStar'] = jnp.asarray(
                self.eqPops.atomicPops[a.model.element].nStar, self.dtype)
        self.compute_collisions(force=True)

        return float(np.max(np.abs(neNew - neStart) / neNew))

    # ------------------------------------------------------------------
    def time_dep_update(self, dt: float, prevTimePops=None) \
            -> Tuple[IterationUpdate, List]:
        """Backward-Euler time-dependent population update."""
        if self._Gamma is None:
            raise ValueError('Call formal_sol_gamma_matrices first')
        if prevTimePops is None:
            prevTimePops = [st['n'] for st in self.popsState]
        dPops = []
        for ai, a in enumerate(self.cfg.activeAtoms):
            st = self.popsState[ai]
            nNew = _time_dep_solve(self._Gamma[ai], prevTimePops[ai],
                                   jnp.asarray(dt, self.dtype))
            dPops.append(float(jnp.max(jnp.abs(1.0 - st['n'] / nNew))))
            st['n'] = nNew
        upd = IterationUpdate(self, updatedPops=True, dPops=dPops)
        return upd, prevTimePops

    def time_dep_restore_prev_pops(self, prevTimePops):
        for ai, nOld in enumerate(prevTimePops):
            self.popsState[ai]['n'] = nOld

    # ------------------------------------------------------------------
    def formal_sol(self, upOnly: bool = True):
        """Plain formal solution (no operator/rates), updating I and J."""
        return self.formal_sol_gamma_matrices(lambdaIterate=True)

    # ------------------------------------------------------------------
    def iterate_on_device(self, NmaxIter: int = 500, Nscatter: int = 3,
                          JTol: float = 5e-3, popsTol: float = 1e-3,
                          ngOptions=None, prd: bool = False,
                          maxPrdSubIter: int = 3, prdTol: float = 1e-2):
        """Run the full MALI loop (formal solution + Gamma + statistical
        equilibrium + convergence test) as ONE compiled lax.while_loop on
        the device -- zero host round trips until converged.

        Covers fixed collisions/CRSW.  Ng acceleration runs on-device
        when ``ngOptions`` (an NgOptions) is given: the ring buffer,
        weighted least-squares extrapolation and max-change all live
        inside the compiled loop (ops/ng.py:device_ng_accelerate),
        matching the host Ng class.  With ``prd=True`` the PRD (and
        hPRD) redistribution sub-iterations also run inside the loop:
        per-line scattering integrals followed by PRD-subset formal
        solutions, up to ``maxPrdSubIter`` per MALI iteration or until
        drho < ``prdTol`` -- the same schedule as the host
        ``prd_redistribute`` with the reference's default tracking-only
        Ng (persistent ``prdNgOptions`` stays a host-driver feature).
        Updates J/I/populations/rho in place; returns
        (nIter, dJ, dPops).
        ref design goal: SURVEY.md par.7.3 ('the full MALI loop runs
        on-device'); PRD schedule ref:
        /root/reference/Source/PrdTemplates.hpp:176-351.
        """
        from .ops.ng import device_ng_accelerate, device_ng_init

        self.compute_collisions()
        if self._iter_fn is None:
            self._iter_fn = jax.jit(
                build_iteration_fn(self.cfg),
                static_argnames=('lambdaIterate', 'storeDepthData'))
        iterFn = build_iteration_fn(self.cfg)
        baseParams = dict(self.build_params())
        nTotals = [jnp.asarray(
            self.eqPops.atomicPops[a.model.element].nTotal, self.dtype)
            for a in self.cfg.activeAtoms]
        dtc = self.dtype
        No = ngOptions.Norder if ngOptions is not None else 0
        Np = ngOptions.Nperiod if ngOptions is not None else 0
        Nd = ngOptions.Ndelay if ngOptions is not None else 0

        prdLines = self._prd_lines() if prd else []
        if prdLines:
            if self.cfg.Ndim != 1:
                raise ValueError('on-device PRD needs a 1D atmosphere')
            from .ops.prd import prd_scatter_rho
            if self._prd_fs_fn is None:
                self._prdSubIdxs = self._prd_subset_idxs()
                self._prd_fs_fn = jax.jit(build_prd_subset_fn(
                    self.cfg, self._prdSubIdxs,
                    [(ai, ti) for ai, ti, a, t in prdLines]))
            # nested jit traces straight through inside the while_loop
            subsetFn = self._prd_fs_fn
            subJ = jnp.asarray(self._prdSubIdxs)
            atmos = self.atmos
            prdConst = []
            for ai, ti, a, t in prdLines:
                vBroad = a.model.vBroad(atmos)
                qWave = ((t.wavelength[:, None] - t.lambda0)
                         * Const.CLight / (t.lambda0 * vBroad[None, :]))
                prdConst.append({
                    'qWave': jnp.asarray(qWave, dtc),
                    'aDamp': jnp.asarray(self.aDamp[ai][ti], dtc),
                    'Qelast': jnp.asarray(self.Qelast[ai][ti], dtc)})

            def prd_pjqj(Rij, Rji, ai, t):
                """Pj + Qj for one line: elastic + collisional + total
                radiative de/population of the upper level
                (ref: /root/reference/Source/Prd.cpp:9-30)."""
                PjQj = jnp.sum(baseParams['C'][ai][:, t.j, :], axis=0)
                for t2i, t2 in enumerate(self.cfg.activeAtoms[ai].trans):
                    if t2.j == t.j:
                        PjQj = PjQj + Rji[ai][t2i]
                    if t2.i == t.j:
                        PjQj = PjQj + Rij[ai][t2i]
                return PjQj

            def prd_substep(carry):
                si, rho, J, JRest, Rij, Rji, _drho = carry
                drho = jnp.asarray(0.0, dtc)
                rhoNew = [list(r) for r in rho]
                for c, (ai, ti, a, t) in zip(prdConst, prdLines):
                    PjQj = c['Qelast'] + prd_pjqj(Rij, Rji, ai, t)
                    # pops are fixed across sub-iterations (like host)
                    n = pops_ref[0][ai]
                    gammaPre = (n[t.i] / n[t.j] * t.Bij
                                / PjQj).astype(dtc)
                    Jbar = (Rij[ai][ti] / t.Bij).astype(dtc)
                    if self.cfg.hprd and JRest is not None:
                        win = jnp.asarray(
                            self.cfg.laToPrdLa[t.Nblue:t.Nred])
                        Jw = JRest[win]
                    else:
                        Jw = J[t.Nblue:t.Nred]
                    rNew = prd_scatter_rho(c['qWave'], c['aDamp'],
                                           Jw.astype(dtc), gammaPre,
                                           Jbar)
                    rOld = rho[ai][ti]
                    rel = jnp.abs(jnp.where(rNew != 0.0,
                                            (rNew - rOld) / rNew, 0.0))
                    drho = jnp.maximum(drho, jnp.max(rel).astype(dtc))
                    rhoNew[ai][ti] = rNew
                p2 = dict(baseParams)
                p2['J'] = J
                p2['pops'] = pops_ref[0]
                p2['rhoPrd'] = rhoNew
                out2 = subsetFn(p2)
                J2 = J.at[subJ].set(out2['J'].astype(J.dtype))
                Rij2 = [list(r) for r in Rij]
                Rji2 = [list(r) for r in Rji]
                for li, (ai, ti, a, t) in enumerate(prdLines):
                    Rij2[ai][ti] = out2['Rij'][li]
                    Rji2[ai][ti] = out2['Rji'][li]
                JRest2 = out2.get('JRest', JRest)
                return (si + 1, rhoNew, J2, JRest2, Rij2, Rji2, drho)

            def prd_subloop(rho, J, JRest, Rij, Rji):
                def cond2(carry):
                    si, _r, _J, _JR, _Rij, _Rji, drho = carry
                    return jnp.logical_and(si < maxPrdSubIter,
                                           drho >= prdTol)
                big = jnp.asarray(np.inf, dtc)
                st = (jnp.asarray(0), rho, J, JRest, Rij, Rji, big)
                st = jax.lax.while_loop(cond2, prd_substep, st)
                return st[1], st[2], st[3], st[4], st[5]

            # mutable cell so prd_substep sees the post-stat-eq pops of
            # the enclosing MALI iteration at trace time
            pops_ref = [None]

        def body(state):
            it, J, pops, _dJ, _dPops, hists, cnt, rho, JRest, _last = state
            p = dict(baseParams)
            p['J'] = J
            p['pops'] = pops
            p['rhoPrd'] = rho
            out = iterFn(p)
            popsNew, histsNew = [], []
            dPops = jnp.asarray(0.0, dtc)
            doSE = it >= Nscatter
            cntNew = jnp.where(doSE, cnt + 1, cnt)
            for ai in range(len(pops)):
                nNew = _stat_eq_solve(out['Gamma'][ai], pops[ai],
                                      nTotals[ai]).astype(dtc)
                # pure-Lambda warmup: keep the initial populations
                nNew = jnp.where(doSE, nNew, pops[ai])
                h2, _c2, sol, dMax = device_ng_accelerate(
                    hists[ai], cnt, nNew.ravel(), No, Np, Nd)
                # the Ng step (ring store + max_change) only happens on
                # statistical-equilibrium iterations, like the host driver
                hists2 = jnp.where(doSE, h2, hists[ai])
                nNew = jnp.where(doSE, sol.reshape(nNew.shape), nNew)
                dAtom = jnp.where(doSE, dMax.astype(dtc),
                                  jnp.asarray(1.0, dtc))
                dPops = jnp.maximum(dPops, dAtom)
                popsNew.append(nNew)
                histsNew.append(hists2)
            Jout = out['J']
            if prdLines:
                pops_ref[0] = popsNew
                JRestCur = out.get('JRest', JRest)

                def run_prd(args):
                    return prd_subloop(*args)

                def skip_prd(args):
                    return args

                rho, Jout, JRest, _, _ = jax.lax.cond(
                    doSE, run_prd, skip_prd,
                    (rho, Jout, JRestCur, out['Rij'], out['Rji']))
            # the last formal solution's I/Gamma/rates: the state the
            # host loop leaves behind (J and I lag the populations by
            # one statistical-equilibrium solve, as in the reference)
            last = (out['I'], out['Gamma'], out['Rij'], out['Rji'])
            return (it + 1, Jout, popsNew, out['dJ'].astype(dtc),
                    dPops, histsNew, cntNew, rho, JRest, last)

        def cond(state):
            it, _J, _pops, dJ, dPops = state[:5]
            return jnp.logical_and(
                it < NmaxIter,
                jnp.logical_or(it <= Nscatter,
                               jnp.logical_or(dJ >= JTol,
                                              dPops >= popsTol)))

        hists0, cnt0 = [], jnp.asarray(1, jnp.int32)
        for st in self.popsState:
            h, cnt0 = device_ng_init(st['n'].astype(dtc), No)
            hists0.append(h)
        JRest0 = self.JRest
        if prdLines and self.cfg.hprd and JRest0 is None:
            JRest0 = jnp.zeros((len(self.cfg.prdIdxs), self.cfg.Nk),
                               self.J.dtype)
        pops0 = [st['n'] for st in self.popsState]
        state0 = (jnp.asarray(0), self.J, pops0,
                  jnp.asarray(1.0, dtc), jnp.asarray(1.0, dtc),
                  hists0, cnt0, self.rhoPrd, JRest0)

        def run(s):
            # the zero carry for the last I/Gamma/rates, shaped at trace
            # time so a cached runner costs no re-trace of the iteration
            p = dict(baseParams, J=s[1], pops=s[2], rhoPrd=s[7])
            shp = jax.eval_shape(iterFn, p)
            last0 = jax.tree_util.tree_map(
                lambda x: jnp.zeros(x.shape, x.dtype),
                (shp['I'], shp['Gamma'], shp['Rij'], shp['Rji']))
            return jax.lax.while_loop(cond, body, s + (last0,))

        # cache the compiled loop per option set: re-jitting every call
        # costs a full re-trace and compile (tens of seconds for the f64
        # program).  The cache is dropped wherever the baked baseParams
        # would go stale (update_deps/_swap_cfg set self._params = None).
        key = (NmaxIter, Nscatter, JTol, popsTol, No, Np, Nd,
               bool(prdLines), maxPrdSubIter, prdTol)
        cache = getattr(self, '_odRunnerCache', None)
        if cache is None or cache[0] != key or self._params is None:
            runner = jax.jit(run)
            self._odRunnerCache = (key, runner)
            self._params = baseParams
        else:
            runner = self._odRunnerCache[1]
        stateF = runner(state0)
        it, J, pops, dJ, dPops = stateF[:5]
        if prdLines:
            self.rhoPrd = stateF[7]
            if self.cfg.hprd:
                self.JRest = stateF[8]
        # a NaN dJ/dPops makes every cond comparison False, so the loop
        # exits on the first non-finite state; surface it like the host
        # path instead of writing NaN populations back
        for a, n in zip(self.cfg.activeAtoms, pops):
            if not np.all(np.isfinite(np.asarray(n))):
                from .utils import ExplodingMatrixError
                raise ExplodingMatrixError(
                    f'Non-finite populations for atom {a.model.element.name}'
                    f' in iterate_on_device after {int(it)} iterations '
                    '(singular Gamma matrix or diverging Ng extrapolation)')
        self.J = J
        for st, n in zip(self.popsState, pops):
            st['n'] = n
        self.I, self._Gamma, self._Rij, self._Rji = stateF[9]
        return int(it), float(dJ), float(dPops)

    # ------------------------------------------------------------------
    def compute_polarised_profiles(self):
        """Zeeman-split polarised profiles per polarisable line:
        phi (I), phi_{Q,U,V}, psi_{Q,U,V}, each [W, Nmu, 2, Nk], from the
        anomalous-splitting component list and the B-field geometry.
        ref: /root/reference/Source/FormalStokes.cpp:9-117"""
        atmos = self.atmos
        if atmos.B is None:
            # no field: every line is unpolarised and the Stokes solve
            # degenerates to the scalar formal solution (K = 0)
            allAtoms = self.cfg.activeAtoms + self.cfg.detailedAtoms
            self.phi7 = [[None] * len(a.trans) for a in allAtoms]
            return
        dt = self.dtype
        from .ops.faddeeva import voigt_HF
        vlosMu = jnp.asarray(atmos.vlos_mu(), dt)
        wmu = jnp.asarray(atmos.wmu, dt)
        cosGamma, cos2chi, sin2chi = atmos.B_projections()
        cosG = jnp.asarray(cosGamma, dt)[None, :, None, :]
        sin2G = 1.0 - cosG * cosG
        c2chi = jnp.asarray(cos2chi, dt)[None, :, None, :]
        s2chi = jnp.asarray(sin2chi, dt)[None, :, None, :]
        s = jnp.asarray([-1.0, 1.0], dt)[None, None, :, None]

        self.phi7 = []   # [atom][trans] -> dict or None
        for ai, a in enumerate(self.cfg.activeAtoms + self.cfg.detailedAtoms):
            vBroad = a.model.vBroad(atmos)
            vB_fac = (Const.QElectron / (4.0 * np.pi * Const.MElectron)
                      * Const.NM_TO_M)
            lineByIdx = {(l.i, l.j): l for l in a.model.lines}
            phiA = []
            for ti, t in enumerate(a.trans):
                if not (t.isLine and t.polarisable):
                    phiA.append(None)
                    continue
                line = lineByIdx[(t.i, t.j)]
                z = line.zeeman_components()
                if z is None:
                    phiA.append(None)
                    continue
                aDamp = jnp.asarray(self.aDamp[ai][ti], dt)
                vB = jnp.asarray(vB_fac * t.lambda0 * atmos.B / vBroad, dt)
                sv = jnp.asarray(1.0 / (Const.SqrtPi * vBroad), dt)
                lam = jnp.asarray(t.wavelength, dt)
                vBase = (lam - t.lambda0) * Const.CLight / t.lambda0
                vk = ((vBase[:, None, None, None]
                       + s * vlosMu[None, :, None, :])
                      / jnp.asarray(vBroad, dt)[None, None, None, :])
                acc = {key: 0.0 for key in ('phi_sb', 'phi_pi', 'phi_sr',
                                            'psi_sb', 'psi_pi', 'psi_sr')}
                names = {-1: 'sb', 0: 'pi', 1: 'sr'}
                for nz in range(len(z.alpha)):
                    H, F = voigt_HF(aDamp[None, None, None, :],
                                    vk - z.shift[nz] * vB[None, None, None, :])
                    key = names[int(z.alpha[nz])]
                    acc['phi_' + key] += z.strength[nz] * H
                    acc['psi_' + key] += z.strength[nz] * F
                phi_sigma = acc['phi_sr'] + acc['phi_sb']
                phi_delta = 0.5 * acc['phi_pi'] - 0.25 * phi_sigma
                psi_sigma = acc['psi_sr'] + acc['psi_sb']
                psi_delta = 0.5 * acc['psi_pi'] - 0.25 * psi_sigma
                svB = sv[None, None, None, :]
                phi = (phi_delta * sin2G + 0.5 * phi_sigma) * svB
                out = {
                    'phi': phi,
                    'phiQ': s * phi_delta * sin2G * c2chi * svB,
                    'phiU': phi_delta * sin2G * s2chi * svB,
                    'phiV': s * 0.5 * (acc['phi_sr'] - acc['phi_sb'])
                            * cosG * svB,
                    'psiQ': s * psi_delta * sin2G * c2chi * svB,
                    'psiU': psi_delta * sin2G * s2chi * svB,
                    'psiV': s * 0.5 * (acc['psi_sr'] - acc['psi_sb'])
                            * cosG * svB,
                }
                wla = jnp.asarray(t.wlambda, dt)
                wphi_inv = jnp.einsum('lmdk,l,m->k', phi, wla, 0.5 * wmu,
                                      precision=lax.Precision.HIGHEST)
                out['wphi'] = 1.0 / wphi_inv
                phiA.append(out)
            self.phi7.append(phiA)

    # ------------------------------------------------------------------
    def single_stokes_fs(self, recompute: bool = False, updateJ: bool = False,
                         upOnly: bool = True, J20: bool = False):
        """Polarised (Zeeman) formal solution: emergent Stokes I, Q, U, V
        per (wavelength, mu).  Synthesis only (no Gamma/rates), matching
        the reference's single_stokes_fs.

        J20=True enables the anisotropic-scattering tensor J^2_0
        (scattering polarisation of the continuum): the background
        scattering emissivity gains wI(mu)*sca*J20 in Stokes I and
        wQ(mu)*sca*J20 in Stokes Q, and self.J20 [Nlam, Nk] is
        re-accumulated from the new I and Q after the solve (lambda
        iteration: call repeatedly with updateJ=True until J/J20
        converge).  Weights follow Trujillo Bueno (2001).
        ref: /root/reference/Source/LwMiddleLayer.pyx:3605,
             /root/reference/Source/FormalStokes.cpp:418-728
             (J20: :433-436, 469-486, 575-582, 642-648)"""
        if getattr(self, 'phi7', None) is None or recompute:
            self.compute_polarised_profiles()
        cfg = self.cfg
        Nlam, Nmu, Nk = cfg.Nlam, cfg.Nmu, cfg.Nk
        dt = self.dtype
        if cfg.Ndim == 2 and (updateJ or J20):
            raise ValueError('2D Stokes synthesis does not support '
                             'updateJ/J20 (synthesis only)')

        chi7, S4 = self._assemble_stokes_chi_S()
        chiI = chi7[:, :, 0, :]
        return self._stokes_solve(chi7, S4, chiI, updateJ=updateJ,
                                  J20=J20)

    def _assemble_stokes_chi_S(self):
        """chi7 [Nlam, Nmu, 7, Nk] and S4 [Nlam, Nmu, 4, Nk] for the
        upgoing polarised formal solution (shared by the 1D and 2D
        Stokes solvers and by tests)."""
        cfg = self.cfg
        Nlam, Nmu, Nk = cfg.Nlam, cfg.Nmu, cfg.Nk
        dt = self.dtype
        d = 1          # upgoing only

        params = self.build_params()
        params = dict(params)
        params['allPops'] = (list(params['pops']) + list(params['detPops']))
        params['nStar'] = (list(params['nStar']) + list(params['detNStar']))

        chi7 = jnp.zeros((Nlam, Nmu, 7, Nk), dt)
        eta4 = jnp.zeros((Nlam, Nmu, 4, Nk), dt)
        chi7 = _slab_add(chi7, (0, 0, 0, 0), (Nlam, Nmu, 1, Nk),
                         self.bgChi[:, None, None, :])

        allAtoms = cfg.activeAtoms + cfg.detailedAtoms
        for ai, a in enumerate(allAtoms):
            n = params['allPops'][ai]
            for ti, t in enumerate(a.trans):
                sl = slice(t.Nblue, t.Nred)
                pol = (t.isLine and getattr(self, 'phi7', None) is not None
                       and self.phi7[ai][ti] is not None)
                if pol:
                    p7 = self.phi7[ai][ti]
                    lam = jnp.asarray(t.wavelength, dt)
                    hnu_4pi = Const.HC_FOURPI * (t.lambda0 / lam)
                    rho = None
                    if t.isPrd and self.rhoPrd[ai][ti] is not None:
                        rho = self.rhoPrd[ai][ti][:, None, :]

                    def uv_pol(prof):
                        # prof: [W, Nmu, Nk] (direction pre-sliced)
                        Vij = hnu_4pi[:, None, None] * t.Bij * prof
                        Vji = (t.Bji / t.Bij) * Vij
                        if rho is not None:
                            Vji = Vji * rho
                        Uji = (t.Aji / t.Bji) * Vji
                        return Uji, Vij, Vji

                    comps = [('phi', 0), ('phiQ', 1), ('phiU', 2),
                             ('phiV', 3), ('psiQ', 4), ('psiU', 5),
                             ('psiV', 6)]
                    for name, ci in comps:
                        Uji, Vij, Vji = uv_pol(p7[name][:, :, d, :])
                        chi_c = n[t.i] * Vij - n[t.j] * Vji
                        chi7 = _slab_add(chi7, (t.Nblue, 0, ci, 0),
                                         (t.W, Nmu, 1, Nk),
                                         chi_c[:, :, None, :])
                        if ci < 4:
                            eta4 = _slab_add(eta4, (t.Nblue, 0, ci, 0),
                                             (t.W, Nmu, 1, Nk),
                                             (n[t.j] * Uji)[:, :, None, :])
                else:
                    Uji, Vij, Vji = _uv(cfg, params, ai, ti, t)
                    chi_c = (n[t.i] * Vij - n[t.j] * Vji)[:, :, d, :]
                    eta_c = (n[t.j] * Uji)[:, :, d, :]
                    chi7 = _slab_add(chi7, (t.Nblue, 0, 0, 0),
                                     (t.W, Nmu, 1, Nk), chi_c[:, :, None, :])
                    eta4 = _slab_add(eta4, (t.Nblue, 0, 0, 0),
                                     (t.W, Nmu, 1, Nk), eta_c[:, :, None, :])

        chiI = chi7[:, :, 0, :]
        S4 = eta4 / chiI[:, :, None, :]
        S4 = _slab_add(S4, (0, 0, 0, 0), (Nlam, Nmu, 1, Nk),
                       ((self.bgEta
                         + self.bgSca * self.J.astype(dt))[:, None, :]
                        / chiI)[:, :, None, :])
        return chi7, S4

    def _stokes_solve(self, chi7, S4, chiI, updateJ=False, J20=False):
        cfg = self.cfg
        Nlam, Nmu, Nk = cfg.Nlam, cfg.Nmu, cfg.Nk
        dt = self.dtype
        if J20:
            # anisotropic scattering source terms from the previous J20
            # (ref FormalStokes.cpp:483-486, 575-582): the mu-dependent
            # irreducible-tensor weights feed I and Q emissivity.
            inv2root2 = 1.0 / (2.0 * np.sqrt(2.0))
            mu2 = jnp.asarray(cfg.muz, dt) ** 2                  # [Nmu]
            wJ20_I = inv2root2 * (3.0 * mu2 - 1.0)
            wJ20_Q = inv2root2 * 3.0 * (mu2 - 1.0)
            if getattr(self, 'J20', None) is None:
                self.J20 = jnp.zeros((Nlam, Nk), self.accumDtype)
            scaJ20 = (self.bgSca * self.J20.astype(dt))          # [Nlam, Nk]
            etaJ20 = (scaJ20[:, None, :] / chiI)                 # [Nlam,Nmu,Nk]
            S4 = _slab_add(S4, (0, 0, 0, 0), (Nlam, Nmu, 1, Nk),
                           (wJ20_I[None, :, None] * etaJ20)[:, :, None, :])
            S4 = _slab_add(S4, (0, 0, 1, 0), (Nlam, Nmu, 1, Nk),
                           (wJ20_Q[None, :, None] * etaJ20)[:, :, None, :])

        if cfg.Ndim == 2:
            # 2D Stokes synthesis: plane sweep with DELO-linear along-ray
            # steps and a 4x4 matrix ring solve for in-plane coupling --
            # a capability the reference's Stokes solver rejects
            # (ref: /root/reference/Source/FormalStokes.cpp:606-621)
            from .ops.stokes2d import formal_sol_stokes_2d
            Nz, Nx = cfg.Nz, cfg.Nx
            lamGrid = jnp.asarray(cfg.wavelength, dt)
            T2 = self.temperature.reshape(Nz, Nx)
            params2 = self.build_params()
            Imu, QuvMu = [], []
            for mu in range(Nmu):
                geom = cfg.geom2d[(mu, True)]
                chi_m = jnp.moveaxis(
                    chi7[:, mu].reshape(Nlam, 7, Nz, Nx), 1, -1)
                S_m = jnp.moveaxis(
                    S4[:, mu].reshape(Nlam, 4, Nz, Nx), 1, -1)
                chiI_m = chi_m[..., 0]
                if cfg.lowerThermalised:
                    # thermalised start plane from the ray's downwind
                    # intersection, exactly as the scalar 2D path
                    i0, i1 = Nz - 1, Nz - 2
                    sA = geom['sAxisZ'][None, :]
                    sW = jnp.asarray(geom['sW'], dt)[None, :]
                    sDs = jnp.asarray(geom['sDs'], dt)[None, :]
                    sJ, sJn = geom['sJ'], geom['sJn']
                    chi0 = chiI_m[:, i0]
                    chi1 = chiI_m[:, i1]
                    chiDw = jnp.where(
                        sA,
                        (1.0 - sW) * chi0[:, sJn] + sW * chi1[:, sJn],
                        (1.0 - sW) * chi1[:, sJ] + sW * chi1[:, sJn])
                    dtauS = 0.5 * (chi0 + chiDw) * sDs
                    T0, T1 = T2[i0], T2[i1]
                    TDw = jnp.where(
                        sA[0],
                        (1.0 - sW[0]) * T0[sJn] + sW[0] * T1[sJn],
                        (1.0 - sW[0]) * T1[sJ] + sW[0] * T1[sJn])
                    Bn = planck_nu(T0[None, :], lamGrid[:, None])
                    BnDw = planck_nu(TDw[None, :], lamGrid[:, None])
                    I0m = Bn - (BnDw - Bn) / dtauS
                else:
                    I0m = jnp.zeros((Nlam, Nx), dt)
                Iupw = jnp.concatenate(
                    [I0m[..., None], jnp.zeros((Nlam, Nx, 3), dt)],
                    axis=-1)
                periodicEff = cfg.xPeriodic or cfg.mux[mu] == 0.0
                Ibc = None
                if not periodicEff:
                    key = ('xLowerBcData' if cfg.mux[mu] >= 0
                           else 'xUpperBcData')
                    Ibc = params2[key][:, mu, 1].astype(dt)   # [Nlam, Nz]
                    j0 = 0 if geom['dj'] > 0 else Nx - 1
                    Iupw = Iupw.at[:, j0, 0].set(Ibc[:, Nz - 1])
                    Iupw = Iupw.at[:, j0, 1:].set(0.0)
                Ifull = formal_sol_stokes_2d(chi_m, S_m, geom, Iupw,
                                             periodic=periodicEff,
                                             Ibc=Ibc)
                Imu.append(Ifull[:, 0, :, 0])                 # [Nlam, Nx]
                QuvMu.append(jnp.moveaxis(Ifull[:, 0, :, 1:], -1, 0))
            self.I = jnp.stack(Imu, axis=1)                   # [Nlam,Nmu,Nx]
            self.Quv = jnp.stack(QuvMu, axis=2)           # [3,Nlam,Nmu,Nx]
            return IterationUpdate(self, updatedJ=False)

        # thermalised lower boundary for Stokes I; Q=U=V=0
        lamGrid = jnp.asarray(cfg.wavelength, dt)
        muz = jnp.asarray(cfg.muz, dt)
        T = self.temperature
        height = self.height
        if cfg.lowerThermalised:
            BnuN = planck_nu(T[Nk - 1], lamGrid)
            BnuN1 = planck_nu(T[Nk - 2], lamGrid)
            dtau = (0.5 * (chiI[:, :, Nk - 1] + chiI[:, :, Nk - 2])
                    * jnp.abs(height[Nk - 1] - height[Nk - 2]) / muz[None, :])
            I0 = BnuN[:, None] - (BnuN1[:, None] - BnuN[:, None]) / dtau
        else:
            I0 = jnp.zeros((Nlam, Nmu), dt)
        Iupw = jnp.concatenate(
            [I0.reshape(-1, 1), jnp.zeros((Nlam * Nmu, 3), dt)], axis=1)

        from .ops.stokes import delo_bezier_stokes
        muzB = jnp.broadcast_to(muz[None, :], (Nlam, Nmu)).reshape(-1)
        Ifull = delo_bezier_stokes(
            chi7.reshape(Nlam * Nmu, 7, Nk).transpose(0, 1, 2),
            S4.reshape(Nlam * Nmu, 4, Nk),
            height, muzB, Iupw, to_obs=True)
        Ifull = Ifull.reshape(Nlam, Nmu, 4, Nk)
        self.I = Ifull[:, :, 0, 0]
        self.Quv = jnp.moveaxis(Ifull[:, :, 1:, 0], 2, 0)   # [3, Nlam, Nmu]
        if updateJ:
            self.J = jnp.einsum('lmk,m->lk',
                                Ifull[:, :, 0, :].astype(self.accumDtype),
                                0.5 * jnp.asarray(cfg.wmu, self.accumDtype),
                                precision=lax.Precision.HIGHEST)
            if J20:
                # J20(la,k) = sum_mu wmu [wI I + wQ Q]
                # (ref FormalStokes.cpp:642-648)
                acc = self.accumDtype
                wmu = jnp.asarray(cfg.wmu, acc)
                self.J20 = (
                    jnp.einsum('lmk,m->lk', Ifull[:, :, 0, :].astype(acc),
                               wmu * wJ20_I.astype(acc),
                               precision=lax.Precision.HIGHEST)
                    + jnp.einsum('lmk,m->lk', Ifull[:, :, 1, :].astype(acc),
                                 wmu * wJ20_Q.astype(acc),
                                 precision=lax.Precision.HIGHEST))
        return IterationUpdate(self, updatedJ=updateJ)

    # ------------------------------------------------------------------
    def _configure_hprd_coeffs(self):
        """Precompute the hybrid-PRD machinery: the PRD-active wavelength
        subset and, per PRD line, the (i0, frac) linear-interpolation
        coefficients locating each window wavelength's Doppler-shifted
        (comoving) position per (mu, +/-, depth).
        ref: /root/reference/Source/Prd.cpp:697-945"""
        atmos = self.atmos
        cfg = self.cfg
        cfg.hprd = True
        vlosMu = np.asarray(atmos.vlos_mu())            # [Nmu, Nk]
        cfg.vlosMu = vlosMu
        lam = np.asarray(self.spect.wavelength)

        prdActive = np.zeros(cfg.Nlam, bool)
        for ai, ti, a, t in self._prd_lines():
            prdActive[t.Nblue:t.Nred] = True
        cfg.prdIdxs = np.nonzero(prdActive)[0]
        laToPrd = np.full(cfg.Nlam, -1, np.int64)
        laToPrd[cfg.prdIdxs] = np.arange(len(cfg.prdIdxs))
        cfg.laToPrdLa = laToPrd

        sgn = np.array([-1.0, 1.0])
        fac = 1.0 + (sgn[None, :, None] * vlosMu[:, None, :]
                     / Const.CLight)                    # [Nmu, 2, Nk]
        cfg.hprdCoeffs = {}
        for ai, ti, a, t in self._prd_lines():
            w = t.wavelength                            # [W]
            lamRest = w[:, None, None, None] * fac[None]   # [W, Nmu, 2, Nk]
            i0 = np.searchsorted(w, lamRest, side='right') - 1
            i0 = np.clip(i0, 0, t.W - 2)
            frac = (lamRest - w[i0]) / (w[i0 + 1] - w[i0])
            frac = np.clip(frac, 0.0, 1.0)
            cfg.hprdCoeffs[(ai, ti)] = (i0.astype(np.int32),
                                        frac.astype(np.float64))

    # ------------------------------------------------------------------
    def _prd_lines(self):
        return [(ai, ti, a, t)
                for ai, a in enumerate(self.cfg.activeAtoms)
                for ti, t in enumerate(a.trans) if t.isLine and t.isPrd]

    def _prd_subset_idxs(self) -> np.ndarray:
        """Static PRD-active wavelength subset for redistribution
        sub-iterations: the union of the PRD lines' windows, widened
        (for hPRD) to every wavelength whose Doppler-shifted neighbour
        range scatters into the PRD region
        (ref: /root/reference/Source/Prd.cpp:740-811)."""
        cfg = self.cfg
        prdActive = np.zeros(cfg.Nlam, bool)
        for ai, ti, a, t in self._prd_lines():
            prdActive[t.Nblue:t.Nred] = True
        if cfg.hprd and cfg.vlosMu is not None:
            w = np.asarray(cfg.wavelength, np.float64)
            facs = (1.0 + np.array([-1.0, 1.0])[None, :, None]
                    * np.asarray(cfg.vlosMu)[:, None, :]
                    / Const.CLight).ravel()               # [Nmu*2*Nk]
            prevLam = w[np.maximum(np.arange(cfg.Nlam) - 1, 0)]
            nextLam = w[np.minimum(np.arange(cfg.Nlam) + 1, cfg.Nlam - 1)]
            lo = prevLam[:, None] * facs[None, :]         # [Nlam, M]
            hi = nextLam[:, None] * facs[None, :]
            # the reference's scan (Prd.cpp:766-793) is inclusive one
            # grid point on EACH side: the rollback lands on the largest
            # w <= prevLambda and checks it, and the forward loop checks
            # prdActive BEFORE the lambdaI > nextLambda break -- both
            # points enter the criterion.  This puts the first grid
            # point outside each PRD window into the hPRD subset, which
            # matters: those scattering-dominated edge wavelengths then
            # get the same number of scattering relaxations per
            # redistribution as the reference gives them.
            iLo = np.maximum(np.searchsorted(w, lo, side='right') - 1, 0)
            iHi = np.minimum(np.searchsorted(w, hi, side='right') + 1,
                             cfg.Nlam)
            cum = np.concatenate([[0], np.cumsum(prdActive)])
            scatters = (cum[iHi] - cum[iLo]) > 0
            prdActive |= scatters.any(axis=1)
        return np.nonzero(prdActive)[0]

    def _prd_subset_fs(self) -> 'IterationUpdate':
        """Subset formal solution for PRD sub-iterations: refresh J (and
        JRest) and the PRD lines' radiative rates at the PRD-active
        wavelengths only, leaving Gamma and every other rate untouched
        (ref: FsMode::PrdOnly, PrdTemplates.hpp:19-113)."""
        if self._prd_fs_fn is None:
            prdLines = [(ai, ti) for ai, ti, a, t in self._prd_lines()]
            self._prdSubIdxs = self._prd_subset_idxs()
            self._prd_fs_fn = jax.jit(build_prd_subset_fn(
                self.cfg, self._prdSubIdxs, prdLines))
        p = self._params
        p['J'] = self.J
        p['pops'] = [st['n'] for st in self.popsState]
        p['nStar'] = [st['nStar'] for st in self.popsState]
        p['rhoPrd'] = self.rhoPrd
        out = self._prd_fs_fn(p)
        subJ = jnp.asarray(self._prdSubIdxs)
        self.J = self.J.at[subJ].set(out['J'])
        self.I = self.I.at[subJ].set(out['I'].astype(self.I.dtype))
        for li, (ai, ti, a, t) in enumerate(self._prd_lines()):
            self._Rij[ai][ti] = out['Rij'][li]
            self._Rji[ai][ti] = out['Rji'][li]
        if 'JRest' in out:
            self.JRest = out['JRest']
        return out['dJ']

    def prd_redistribute(self, maxIter: int = 3,
                         tol: float = 1e-2) -> IterationUpdate:
        """Iterate the PRD emission-profile ratios rho: per line compute
        the angle-averaged scattering integral against the current J and
        rates, then refresh J/rates with a formal solution, until
        drho < tol or maxIter.
        ref: /root/reference/Source/PrdTemplates.hpp:176-351,
             /root/reference/Source/Prd.cpp:9-30, 468-645"""
        from .ops.ng import Ng
        from .ops.prd import prd_scatter_rho

        prdLines = self._prd_lines()
        if not prdLines:
            return IterationUpdate(self)
        if self._Rij is None:
            raise ValueError('Call formal_sol_gamma_matrices first')

        atmos = self.atmos
        if self.prdNgOptions is None:
            # reference behaviour: fresh tracking-only Ng per call
            ngs = [Ng(0, 0, 0, np.asarray(self.rhoPrd[ai][ti]).ravel())
                   for ai, ti, a, t in prdLines]
        else:
            # opt-in: persistent per-line accelerators whose history
            # spans sub-iterations AND outer MALI iterations, so the
            # extrapolation actually fires on slow PRD problems.
            o = self.prdNgOptions
            if (self._prdNgs is None or len(self._prdNgs) != len(prdLines)
                    or any(ng.init and ng.len != self.rhoPrd[ai][ti].size
                           for ng, (ai, ti, a, t)
                           in zip(self._prdNgs, prdLines))):
                self._prdNgs = [
                    Ng(o.Norder, o.Nperiod, o.Ndelay,
                       np.asarray(self.rhoPrd[ai][ti]).ravel())
                    for ai, ti, a, t in prdLines]
            ngs = self._prdNgs

        dRho = [0.0] * len(prdLines)
        nIter = 0
        for it in range(maxIter):
            nIter += 1
            dRhoMax = 0.0
            for li, (ai, ti, a, t) in enumerate(prdLines):
                # Pj + Qj: total upper-level depopulation + elastic rate
                # (ref: /root/reference/Source/Prd.cpp:9-30)
                PjQj = self.Qelast[ai][ti].copy()
                PjQj += np.asarray(self.C[ai][:, t.j, :]).sum(axis=0)
                for t2i, t2 in enumerate(a.trans):
                    if t2.j == t.j:
                        PjQj += np.asarray(self._Rji[ai][t2i])
                    if t2.i == t.j:
                        PjQj += np.asarray(self._Rij[ai][t2i])

                n = np.asarray(self.popsState[ai]['n'])
                gammaPre = n[t.i] / n[t.j] * t.Bij / PjQj
                Jbar = np.asarray(self._Rij[ai][ti]) / t.Bij
                vBroad = a.model.vBroad(atmos)
                qWave = ((t.wavelength[:, None] - t.lambda0) * Const.CLight
                         / (t.lambda0 * vBroad[None, :]))
                if self.cfg.hprd and self.JRest is not None:
                    prdWin = self.cfg.laToPrdLa[t.Nblue:t.Nred]
                    Jw = self.JRest[jnp.asarray(prdWin)]
                else:
                    Jw = self.J[t.Nblue:t.Nred]
                rho = prd_scatter_rho(
                    jnp.asarray(qWave, self.dtype),
                    jnp.asarray(self.aDamp[ai][ti], self.dtype), Jw,
                    jnp.asarray(gammaPre, self.dtype),
                    jnp.asarray(Jbar, self.dtype))
                accelerated, rhoFlat = ngs[li].accelerate(
                    np.asarray(rho).ravel(), trustFactor=2.0)
                dRho[li] = ngs[li].max_change()
                dRhoMax = max(dRhoMax, dRho[li])
                if accelerated:
                    rho = rhoFlat.reshape(np.asarray(rho).shape)
                self.rhoPrd[ai][ti] = jnp.asarray(rho, self.dtype)

            # refresh J and the PRD lines' rates with the new rho on the
            # PRD-active wavelength subset only (ref FsMode::PrdOnly);
            # 2D / depth-data runs (and prdFsMode='full') fall back to
            # the full-grid program.
            if self.prdFsMode == 'subset' and self.cfg.Ndim == 1 \
                    and not self.depthData.fill \
                    and getattr(self, '_params', None) is not None:
                self._prd_subset_fs()
            else:
                # freeze the CRSW schedule across sub-iterations
                cur = getattr(self, '_crswVal', 1.0)
                cb = self.crswCallback
                self.crswCallback = (lambda: cur) if cb is not None else None
                try:
                    self.formal_sol_gamma_matrices()
                finally:
                    self.crswCallback = cb
            if dRhoMax < tol:
                break

        upd = IterationUpdate(self, updatedRho=True, dRho=dRho,
                              NprdSubIter=nIter)
        upd.updatedJ = True
        return upd

    # ------------------------------------------------------------------
    def update_deps(self, temperature: bool = True, background: bool = True,
                    profiles: bool = True, collisions: bool = True):
        """Recompute quantities that depend on the atmosphere after it has
        been modified in place (T, ne, vlos, vturb, ...).
        ref: /root/reference/Source/LwMiddleLayer.pyx:3244-3288"""
        atmos = self.atmos
        dtc = self.dtype
        if temperature:
            self.eqPops.update_lte_atoms_Hmin_pops(
                atmos, conserveCharge=self.conserveCharge)
            for a, st in zip(self.cfg.activeAtoms, self.popsState):
                st['nStar'] = jnp.asarray(
                    self.eqPops.atomicPops[a.model.element].nStar, dtc)
            for a, st in zip(self.cfg.detailedAtoms, self.detailedPops):
                st['nStar'] = jnp.asarray(
                    self.eqPops.atomicPops[a.model.element].nStar, dtc)
            self.temperature = jnp.asarray(atmos.temperature, dtc)
            self.height = jnp.asarray(atmos.height, dtc)
        if background:
            bg = self.backgroundProvider(self.spect, atmos, self.eqPops,
                                         self.spect.radSet)
            self.background = bg
            self.bgChi = jnp.asarray(bg.chi, dtc)
            self.bgEta = jnp.asarray(bg.eta, dtc)
            self.bgSca = jnp.asarray(bg.sca, dtc)
        if profiles:
            self.compute_profiles()
        if collisions:
            self.compute_collisions(force=True)
        if self.cfg.hprd and self._prd_lines():
            # velocity changes move the comoving-frame coefficients
            self._configure_hprd_coeffs()
        # the cached params pytree holds references to the old
        # background/profile/thermodynamic arrays -- rebuild it on the
        # next iteration call (and drop the on-device loop whose body
        # baked them in)
        self._params = None
        self._odRunnerCache = None

    # ------------------------------------------------------------------
    def state_dict(self) -> Dict:
        """Serialisable snapshot of the full simulation state (checkpoint /
        clone / warm-restart).
        ref: /root/reference/Source/LwMiddleLayer.pyx:2977-3037"""
        return {
            'atmos': self.atmos,
            'spect': self.spect,
            'eqPops': self.eqPops,
            'J': np.asarray(self.J),
            'I': np.asarray(self.I),
            'pops': [np.asarray(st['n']) for st in self.popsState],
            'nStar': [np.asarray(st['nStar']) for st in self.popsState],
            'rhoPrd': {
                (a.model.element, t.i, t.j):
                    (t.wavelength.copy(), np.asarray(self.rhoPrd[ai][ti]))
                for ai, ti, a, t in self._prd_lines()},
            'kwargs': {
                'conserveCharge': self.conserveCharge,
                'hprd': self.cfg.hprd,
                'formalSolver': self.cfg.formalSolver,
                'interpFn2d': self.cfg.interpFn2d,
                'recurrenceMode': self.cfg.recurrenceMode,
            },
        }

    def __getstate__(self):
        """Pickle protocol: the Context pickles through its state dict
        like the reference's Cython classes do (checkpoint/resume with
        plain pickle.dump / pickle.load).
        ref: /root/reference/Source/LwMiddleLayer.pyx:2977-3037."""
        return self.state_dict()

    def __setstate__(self, state: Dict):
        ctx = Context.construct_from_state_dict_with(state)
        self.__dict__.update(ctx.__dict__)

    @classmethod
    def construct_from_state_dict_with(cls, state: Dict, atmos=None,
                                       spect=None, eqPops=None) -> 'Context':
        """Rebuild a Context from a state dict, optionally substituting the
        atmosphere/spectral configuration/populations; J is interpolated
        onto the new wavelength grid and populations are copied.
        ref: /root/reference/Source/LwMiddleLayer.pyx:3758-3896"""
        atmos = atmos if atmos is not None else state['atmos']
        spect = spect if spect is not None else state['spect']
        eqPops = eqPops if eqPops is not None else state['eqPops']
        ctx = cls(atmos, spect, eqPops, **state['kwargs'])

        oldLam = np.asarray(state['spect'].wavelength)
        newLam = np.asarray(spect.wavelength)
        Jold = state['J']
        if (len(newLam) == len(oldLam)) and np.allclose(newLam, oldLam):
            ctx.J = jnp.asarray(Jold, ctx.accumDtype)
            if state.get('I') is not None \
                    and state['I'].shape == tuple(ctx.I.shape):
                ctx.I = jnp.asarray(state['I'], ctx.dtype)
        else:
            Jnew = np.empty((len(newLam), Jold.shape[1]))
            for k in range(Jold.shape[1]):
                Jnew[:, k] = np.interp(newLam, oldLam, Jold[:, k])
            ctx.J = jnp.asarray(Jnew, ctx.accumDtype)
        for st, n, nStar in zip(ctx.popsState, state['pops'], state['nStar']):
            st['n'] = jnp.asarray(n, ctx.dtype)
            st['nStar'] = jnp.asarray(nStar, ctx.dtype)

        # interpolate PRD rho onto the new per-line windows
        # (ref: /root/reference/Source/LwMiddleLayer.pyx:1960-1963)
        oldRho = state.get('rhoPrd', {})
        for ai, ti, a, t in ctx._prd_lines():
            key = (a.model.element, t.i, t.j)
            if key not in oldRho:
                continue
            oldLamW, rho = oldRho[key]
            rhoNew = np.empty((t.W, rho.shape[1]))
            for k in range(rho.shape[1]):
                rhoNew[:, k] = np.interp(t.wavelength, oldLamW, rho[:, k])
            ctx.rhoPrd[ai][ti] = jnp.asarray(rhoNew, ctx.dtype)
        return ctx

    # ------------------------------------------------------------------
    def compute_rays(self, wavelengths=None, mus=None, stokes: bool = False,
                     refinePrd: bool = False) -> np.ndarray:
        """Synthesise final intensities on an arbitrary (wavelength, mu)
        grid from the converged state: clone the context onto a subset
        spectral configuration where every transition is active, and run a
        plain formal solution.
        ref: /root/reference/Source/LwMiddleLayer.pyx:3898-4003"""
        import copy as _copy
        state = self.state_dict()
        if wavelengths is not None:
            spect2 = self.spect.subset_configuration(wavelengths)
        else:
            spect2 = self.spect.subset_configuration(self.spect.wavelength)
        atmos2 = _copy.copy(self.atmos)
        if mus is not None:
            atmos2.rays(mus)
        rayCtx = Context.construct_from_state_dict_with(
            state, atmos=atmos2, spect=spect2)
        if refinePrd and rayCtx._prd_lines():
            rayCtx.formal_sol_gamma_matrices()
            rayCtx.prd_redistribute(maxIter=100)
        if stokes:
            rayCtx.single_stokes_fs()
            return np.concatenate([np.asarray(rayCtx.I)[None],
                                   np.asarray(rayCtx.Quv)], axis=0)
        rayCtx.formal_sol()
        return np.asarray(rayCtx.I)

    # convenience accessors --------------------------------------------
    @property
    def Nthreads(self) -> int:
        """Thread-count compatibility shim: XLA owns all scheduling on
        the device, so there is exactly one 'thread' and assigning to
        this is a no-op
        (ref: /root/reference/Source/LwMiddleLayer.pyx:3100-3123)."""
        return 1

    @Nthreads.setter
    def Nthreads(self, value):
        pass

    @property
    def hprd(self) -> bool:
        return self.cfg.hprd

    def _swap_cfg(self, **replacements):
        """Rebuild the static iteration config and invalidate every
        cached compiled program (the analogue of the reference's plugin
        re-selection, LwMiddleLayer.pyx:3039-3098)."""
        import dataclasses
        self.cfg = dataclasses.replace(self.cfg, **replacements)
        self._iter_fn = None
        self._prd_fs_fn = None
        self._params = None
        self._odRunnerCache = None

    def set_formal_solver(self, name: str):
        """Select the formal solver by registry name, re-tracing the
        iteration (ref: LwMiddleLayer.pyx:3039; registry
        ops/formal_solver.py SOLVER_NAMES_1D + the 2D scheme names)."""
        from .ops.formal_solver import SOLVER_NAMES_1D
        if self.cfg.Ndim == 2:
            valid = ('piecewise_linear_2d', 'piecewise_besser_2d')
        else:
            valid = tuple(SOLVER_NAMES_1D)
        if name not in valid:
            raise ValueError(f'Unknown formal solver {name!r} for a '
                             f'{self.cfg.Ndim}D atmosphere; '
                             f'available: {valid}')
        self._swap_cfg(formalSolver=name)

    def set_interp_fn(self, name: str):
        """Select the 2D upwind interpolation function by name
        (ref: LwMiddleLayer.pyx:3057)."""
        valid = ('interp_linear_2d', 'interp_besser_2d')
        if name not in valid:
            raise ValueError(f'Unknown interpolation function {name!r}; '
                             f'available: {valid}')
        self._swap_cfg(interpFn2d=name)

    def set_fs_iter_scheme(self, name: str):
        """Iteration-scheme selection (the reference's per-SIMD plugin
        registry, LwMiddleLayer.pyx:3077-3098).  One scheme exists:
        'mali_full_precond'; the reference's per-SIMD suffixes
        (_scalar/_SSE2/_AVX*) alias it.  Any other name raises."""
        base = name.partition('_scalar')[0].partition('_SSE2')[0] \
                   .partition('_AVX')[0]
        if base != 'mali_full_precond':
            raise ValueError(f'Unknown iteration scheme {name!r}; '
                             "available: 'mali_full_precond'")
        if getattr(self.cfg, 'fsIterScheme', None) != base:
            self._swap_cfg(fsIterScheme=base)

    def get_fs_iter_scheme_properties(self, fsIterScheme=None) -> dict:
        """Properties of the selected iteration scheme, with the
        reference's key layout
        (ref: LwMiddleLayer.pyx:4186-4194)."""
        return {'name': getattr(self.cfg, 'fsIterScheme',
                                'mali_full_precond'),
                'Ndim': self.cfg.Ndim,
                'dimensionSpecific': False,
                'respectsFormalSolver': True,
                'defaultPerAtomStorage': True,
                'defaultWlaGijStorage': True}

    @property
    def activePops(self):
        return {a.model.element.name: np.asarray(st['n'])
                for a, st in zip(self.cfg.activeAtoms, self.popsState)}

    def sync_pops_to_eqPops(self):
        for a, st in zip(self.cfg.activeAtoms, self.popsState):
            state = self.eqPops.atomicPops[a.model.element]
            if state.pops is not None:
                state.pops[:] = np.asarray(st['n'])
