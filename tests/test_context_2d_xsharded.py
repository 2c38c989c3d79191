"""Integrated x-sharded 2D MALI iteration: Context(mesh=...) runs the
plane sweep under shard_map (halo exchange + distributed ring closure)
INSIDE the jitted iteration, and must converge to the same populations
as the unsharded 2D context.

This is the integrated form of parallel/xshard2d.py (which
test_xshard2d.py validates at the single-sweep level), replacing the
reference's ZPlaneDecomposition + callable-BC stitching hook
(ref: /root/reference/Source/SimdFullIterationTemplates.hpp:253-281,
FormalScalar.cpp:497-528).
"""
import numpy as np
import pytest

import jax
from jax.sharding import Mesh

from lightweaver_tpu.atmosphere import Atmosphere
from lightweaver_tpu.atomic_set import RadiativeSet
from lightweaver_tpu.context import Context
from lightweaver_tpu.fal import Falc82
from lightweaver_tpu.rh_atoms import CaII_atom, H_6_atom


class _FixedXBc:
    def __init__(self, data):
        self.data = data

    def compute_bc(self, atmos, spect):
        return self.data


def _mesh(n=4):
    return Mesh(np.array(jax.devices()[:n]), ('x',))


def _make(Nz=16, Nx=8, mesh=None, xBcData=None, **ctxKw):
    full = Falc82()
    idx = np.unique(np.linspace(0, 81, Nz).astype(int))
    Nz = len(idx)
    x = np.arange(Nx) * 2e5        # narrow columns: slanted coupling

    def bc(a):
        return np.broadcast_to(a[:, None], (Nz, Nx)).copy()

    # x-dependent perturbation so the sharded axis carries real structure
    T = bc(full.temperature[idx])
    T = T * (1.0 + 0.1 * np.sin(2 * np.pi * np.arange(Nx) / Nx)[None, :])
    kw = {}
    if xBcData is not None:
        kw['xLowerBc'] = _FixedXBc(xBcData)
        kw['xUpperBc'] = _FixedXBc(xBcData)
    atmos = Atmosphere.make_2d(
        height=full.height[idx], x=x, temperature=T,
        vx=np.zeros((Nz, Nx)), vz=bc(full.vlos[idx]),
        vturb=bc(full.vturb[idx]), ne=bc(full.ne[idx]),
        nHTot=bc(full.nHTot[idx]), **kw)
    atmos.quadrature(3)
    rs = RadiativeSet([H_6_atom(), CaII_atom()])
    rs.set_active('Ca')
    spect = rs.compute_wavelength_grid()
    eqPops = rs.compute_eq_pops(atmos)
    return Context(atmos, spect, eqPops, mesh=mesh, **ctxKw), (Nz, Nx)


def _converge(ctx, maxIter=400):
    for it in range(maxIter):
        ju = ctx.formal_sol_gamma_matrices()
        if it < 3:
            continue
        pu = ctx.stat_equil()
        if float(ju.dJMax) < 5e-3 and pu.dPopsMax < 1e-3:
            return it
    raise AssertionError('no convergence')


def test_xsharded_context_compiles_its_iteration_once():
    """The iteration and the stat-eq solve hand back J and the
    populations sharded over x; the context feeds them back in one
    layout, so every iteration reuses the first compiled program."""
    ctx, _ = _make(Nz=8, mesh=_mesh(4))
    for it in range(3):
        ctx.formal_sol_gamma_matrices()
        if it >= 1:
            ctx.stat_equil()
    assert ctx._iter_fn._cache_size() == 1


@pytest.mark.slow
def test_xsharded_context_converges_like_unsharded():
    """Periodic slab, BESSER interp+along-ray (the reference-default 2D
    scheme): converged pops sharded == unsharded to ~1e-10."""
    ctxU, _ = _make()
    nitU = _converge(ctxU)
    ctxS, _ = _make(mesh=_mesh(4))
    assert ctxS.cfg.mesh2d is not None
    nitS = _converge(ctxS)
    assert nitS == nitU            # identical trajectory, not just fixpoint
    nU = np.asarray(ctxU.popsState[0]['n'])
    nS = np.asarray(ctxS.popsState[0]['n'])
    np.testing.assert_allclose(nS, nU, rtol=1e-9)
    np.testing.assert_allclose(np.asarray(ctxS.J), np.asarray(ctxU.J),
                               rtol=1e-8)
    np.testing.assert_allclose(np.asarray(ctxS.I), np.asarray(ctxU.I),
                               rtol=1e-8)


@pytest.mark.slow
def test_xsharded_context_callable_xbc():
    """Callable (non-periodic) x BCs through the sharded sweep: the
    fixed boundary column lives on shard 0 only."""
    # boundary data: thermal-ish plausible intensities from one periodic
    # iteration of the same slab
    ctx0, (Nz, Nx) = _make()
    ctx0.depthData.fill = True
    ctx0.formal_sol_gamma_matrices()
    I0 = np.asarray(ctx0.depthData.I).reshape(
        ctx0.cfg.Nlam, ctx0.cfg.Nmu, 2, Nz, Nx)
    bcData = I0[..., 0].copy()     # [Nlam, Nmu, 2, Nz]

    ctxU, _ = _make(xBcData=bcData)
    assert not ctxU.cfg.xPeriodic
    for _ in range(6):
        juU = ctxU.formal_sol_gamma_matrices()
        puU = ctxU.stat_equil()

    ctxS, _ = _make(xBcData=bcData, mesh=_mesh(4))
    for _ in range(6):
        juS = ctxS.formal_sol_gamma_matrices()
        puS = ctxS.stat_equil()

    nU = np.asarray(ctxU.popsState[0]['n'])
    nS = np.asarray(ctxS.popsState[0]['n'])
    np.testing.assert_allclose(nS, nU, rtol=1e-9)
    np.testing.assert_allclose(float(juS.dJMax), float(juU.dJMax),
                               rtol=1e-6)


def test_mesh_requires_2d():
    full = Falc82()
    idx = np.unique(np.linspace(0, 81, 10).astype(int))
    atmos = Atmosphere(height=full.height[idx],
                       temperature=full.temperature[idx],
                       vlos=full.vlos[idx], vturb=full.vturb[idx],
                       ne=full.ne[idx], nHTot=full.nHTot[idx])
    atmos.quadrature(3)
    rs = RadiativeSet([H_6_atom(), CaII_atom()])
    rs.set_active('Ca')
    spect = rs.compute_wavelength_grid()
    eqPops = rs.compute_eq_pops(atmos)
    with pytest.raises(ValueError, match='only supported for 2D'):
        Context(atmos, spect, eqPops, mesh=_mesh(4))


def test_mesh_divisibility_validated():
    with pytest.raises(ValueError, match='divisible'):
        _make(Nx=6, mesh=_mesh(4))
