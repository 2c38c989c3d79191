"""Array-native 1.5D ColumnBatch: construction from stacked arrays,
equivalence with single-column Contexts, per-column convergence masking,
charge conservation, and mesh sharding.
ref capability: /root/reference/docs/index.rst:36-38 (the reference
delegates 1.5D to user-level ProcessPool/MPI)."""
import numpy as np
import pytest

from lightweaver_tpu.atmosphere import Atmosphere
from lightweaver_tpu.atomic_set import RadiativeSet
from lightweaver_tpu.context import Context
from lightweaver_tpu.fal import Falc82
from lightweaver_tpu.iterate_ctx import iterate_ctx_se
from lightweaver_tpu.ops.ng import NgOptions
from lightweaver_tpu.parallel import ColumnBatch, make_mesh
from lightweaver_tpu.rh_atoms import CaII_atom, H_6_atom

_MODELS = lambda: [H_6_atom(), CaII_atom()]


def _stacked(C, Nk=24, seed=1):
    full = Falc82()
    idx = np.unique(np.linspace(0, 81, Nk).astype(int))
    Nk = len(idx)
    rng = np.random.default_rng(seed)
    scale = rng.uniform(0.95, 1.05, (C, 1))
    T = full.temperature[idx][None, :] * scale
    rep = lambda a: np.broadcast_to(a[idx], (C, Nk)).copy()
    return (full.height[idx], T, np.zeros((C, Nk)), rep(full.vturb),
            rep(full.ne), rep(full.nHTot))


@pytest.mark.slow
def test_from_stacked_matches_single_context():
    """No Ng, no acceleration: the batched iteration must follow the
    exact same trajectory as a standalone Context on each column."""
    C = 4
    height, T, vlos, vturb, ne, nH = _stacked(C)
    batch = ColumnBatch.from_stacked(height, T, vlos, vturb, ne, nH,
                                     _MODELS, ('Ca',), Nrays=3)
    nIt = batch.iterate(NmaxIter=400)
    assert batch.converged.all()

    c = 2
    atmos = Atmosphere(height=height, temperature=T[c].copy(),
                       vlos=vlos[c].copy(), vturb=vturb[c].copy(),
                       ne=ne[c].copy(), nHTot=nH[c].copy())
    atmos.quadrature(3)
    rs = RadiativeSet(_MODELS())
    rs.set_active('Ca')
    spect = rs.compute_wavelength_grid()
    eqPops = rs.compute_eq_pops(atmos)
    ctx = Context(atmos, spect, eqPops)
    # iterate the single column the same number of iterations as the
    # batch ran for that column (identical trajectory incl. the freeze)
    nThis = int(batch.nIterCol[c])
    for it in range(nThis):
        ctx.formal_sol_gamma_matrices()
        if it >= 3:
            ctx.stat_equil()
    n1 = np.asarray(ctx.popsState[0]['n'])
    err = np.abs(batch.pops[0][c] / n1 - 1).max()
    assert err < 1e-9, err
    # per-column iteration counts recorded
    assert batch.nIterCol.min() > 3 and batch.nIterCol.max() <= nIt


def test_batch_sharded_equals_unsharded():
    import jax
    C = 8
    height, T, vlos, vturb, ne, nH = _stacked(C, Nk=16)
    mesh = make_mesh(nColumns=4, nWavelength=2, devices=jax.devices()[:8])

    def run(mesh):
        b = ColumnBatch.from_stacked(height, T, vlos, vturb, ne, nH,
                                     _MODELS, ('Ca',), Nrays=2, mesh=mesh)
        for _ in range(5):
            b.formal_sol_gamma_matrices()
            b.stat_equil()
        return b

    bS = run(mesh)
    bU = run(None)
    for a, b in zip(bS.pops, bU.pops):
        assert np.abs(a / b - 1.0).max() < 1e-8
    assert np.abs(np.asarray(bS.params['J'])
                  / np.asarray(bU.params['J']) - 1.0).max() < 1e-8


@pytest.mark.parametrize('meshShape', [(4, 2), (8, 1)])
def test_sharded_batch_compiles_its_iteration_once(meshShape):
    """stat_equil and the iteration's own outputs leave leaves on one
    device or in XLA's layout; the batch puts them back on the mesh so
    that every iteration reuses the first compiled program."""
    import jax
    height, T, vlos, vturb, ne, nH = _stacked(8, Nk=12)
    mesh = make_mesh(nColumns=meshShape[0], nWavelength=meshShape[1],
                     devices=jax.devices()[:8])
    b = ColumnBatch.from_stacked(height, T, vlos, vturb, ne, nH,
                                 _MODELS, ('Ca',), Nrays=2, mesh=mesh)
    for _ in range(3):
        b.formal_sol_gamma_matrices()
        b.stat_equil()
    assert b._iter_full._cache_size() == 1


@pytest.mark.slow
def test_batch_ng_and_scattering_acceleration():
    """Ng + the local scattering operator converge the batch in far
    fewer iterations, to populations consistent with the plain run."""
    C = 4
    height, T, vlos, vturb, ne, nH = _stacked(C)
    plain = ColumnBatch.from_stacked(height, T, vlos, vturb, ne, nH,
                                     _MODELS, ('Ca',), Nrays=3)
    nPlain = plain.iterate(NmaxIter=400, JTol=2e-3, popsTol=2e-4)
    accel = ColumnBatch.from_stacked(height, T, vlos, vturb, ne, nH,
                                     _MODELS, ('Ca',), Nrays=3,
                                     accelerateScattering=True,
                                     ngOptions=NgOptions(2, 5, 20))
    nAccel = accel.iterate(NmaxIter=400, JTol=2e-3, popsTol=2e-4)
    assert accel.converged.all()
    assert nAccel < 0.5 * nPlain, (nAccel, nPlain)
    for a, b in zip(accel.pops, plain.pops):
        assert np.abs(a / b - 1.0).max() < 2e-2


@pytest.mark.slow
def test_batch_conserve_charge():
    """NR charge conservation through the flat context: per-column ne
    must match a standalone conserveCharge Context run."""
    C = 3
    height, T, vlos, vturb, ne, nH = _stacked(C, Nk=20, seed=3)
    batch = ColumnBatch.from_stacked(height, T, vlos, vturb, ne, nH,
                                     _MODELS, ('H',), Nrays=3,
                                     conserveCharge=True)
    batch.iterate(NmaxIter=300)
    assert batch.converged.all()
    neB = batch.ne
    assert not np.allclose(neB[0], ne[0])      # ne actually updated

    c = 1
    atmos = Atmosphere(height=height, temperature=T[c].copy(),
                       vlos=vlos[c].copy(), vturb=vturb[c].copy(),
                       ne=ne[c].copy(), nHTot=nH[c].copy())
    atmos.quadrature(3)
    rs = RadiativeSet(_MODELS())
    rs.set_active('H')
    spect = rs.compute_wavelength_grid()
    eqPops = rs.compute_eq_pops(atmos)
    ctx = Context(atmos, spect, eqPops, conserveCharge=True)
    iterate_ctx_se(ctx, NmaxIter=300, quiet=True)
    err = np.abs(neB[c] / np.asarray(ctx.atmos.ne) - 1).max()
    assert err < 5e-3, err


@pytest.mark.slow
def test_batch_prd_matches_single_context():
    """Batched PRD redistribution (vmapped scattering integral + subset
    FS) follows the standalone Context's PRD trajectory exactly on a
    batch of identical columns."""
    from lightweaver_tpu.rh_atoms import H_6_atom as H6

    full = Falc82()
    idx = np.unique(np.linspace(0, 81, 24).astype(int))
    Nk = len(idx)
    C = 3
    rep = lambda a: np.broadcast_to(a[idx], (C, Nk)).copy()
    batch = ColumnBatch.from_stacked(
        full.height[idx], rep(full.temperature), np.zeros((C, Nk)),
        rep(full.vturb), rep(full.ne), rep(full.nHTot),
        lambda: [H6()], ('H',), Nrays=3, accelerateScattering=True)
    nIt = batch.iterate(NmaxIter=200, prd=True, maxPrdSubIter=4,
                        prdTol=1e-3)
    assert batch.converged.all()
    ai, ti, a, t = batch.flatCtx._prd_lines()[0]
    rhoBatch = np.asarray(batch.params['rhoPrd'][ai][ti])
    assert np.all(np.isfinite(rhoBatch)) and np.all(rhoBatch > 0)
    assert np.abs(rhoBatch - 1.0).max() > 0.1    # real PRD departure
    # identical columns -> identical rho
    assert np.abs(rhoBatch[0] - rhoBatch[-1]).max() < 1e-12

    atmos = Atmosphere(height=full.height[idx],
                       temperature=full.temperature[idx].copy(),
                       vlos=np.zeros(Nk), vturb=full.vturb[idx].copy(),
                       ne=full.ne[idx].copy(), nHTot=full.nHTot[idx].copy())
    atmos.quadrature(3)
    rs = RadiativeSet([H6()])
    rs.set_active('H')
    spect = rs.compute_wavelength_grid()
    eqPops = rs.compute_eq_pops(atmos)
    ctx = Context(atmos, spect, eqPops, accelerateScattering=True)
    nThis = int(batch.nIterCol[0])
    for it in range(nThis):
        ctx.formal_sol_gamma_matrices()
        if it >= 3:
            ctx.stat_equil()
            ctx.prd_redistribute(maxIter=4, tol=1e-3)
    n1 = np.asarray(ctx.popsState[0]['n'])
    rho1 = np.asarray(ctx.rhoPrd[ai][ti])
    assert np.abs(batch.pops[0][0] / n1 - 1).max() < 1e-8
    assert np.abs(rhoBatch[0] - rho1).max() < 1e-8


@pytest.mark.slow
def test_batch_hprd_matches_single_context():
    """hPRD in ColumnBatch: per-column comoving-frame coefficients ride
    in the params pytree (vmapped), so a batch with per-column velocity
    fields follows each column's standalone hPRD trajectory.
    ref: /root/reference/Source/Prd.cpp:697-945."""
    from lightweaver_tpu.rh_atoms import H_6_atom as H6

    full = Falc82()
    idx = np.unique(np.linspace(0, 81, 24).astype(int))
    Nk = len(idx)
    C = 2
    rep = lambda a: np.broadcast_to(a[idx], (C, Nk)).copy()
    # DISTINCT per-column velocity fields: column 0 static, column 1
    # with a 5 km/s outflow gradient
    vlos = np.zeros((C, Nk))
    vlos[1] = np.linspace(5e3, 0.0, Nk)
    batch = ColumnBatch.from_stacked(
        full.height[idx], rep(full.temperature), vlos,
        rep(full.vturb), rep(full.ne), rep(full.nHTot),
        lambda: [H6()], ('H',), Nrays=3, hprd=True,
        accelerateScattering=True)
    assert batch.flatCtx.cfg.hprd
    nIt = batch.iterate(NmaxIter=250, prd=True, maxPrdSubIter=4,
                        prdTol=1e-3)
    assert batch.converged.all()
    ai, ti, a, t = batch.flatCtx._prd_lines()[0]
    rhoBatch = np.asarray(batch.params['rhoPrd'][ai][ti])
    assert np.all(np.isfinite(rhoBatch)) and np.all(rhoBatch > 0)
    # the velocity column's rho must differ from the static column's
    assert np.abs(rhoBatch[1] - rhoBatch[0]).max() > 1e-3

    # standalone hPRD contexts, one per column, driven for the same
    # number of iterations as that column took in the batch
    for c in range(C):
        atmos = Atmosphere(height=full.height[idx],
                           temperature=full.temperature[idx].copy(),
                           vlos=vlos[c].copy(),
                           vturb=full.vturb[idx].copy(),
                           ne=full.ne[idx].copy(),
                           nHTot=full.nHTot[idx].copy())
        atmos.quadrature(3)
        rs = RadiativeSet([H6()])
        rs.set_active('H')
        spect = rs.compute_wavelength_grid()
        eqPops = rs.compute_eq_pops(atmos)
        ctx = Context(atmos, spect, eqPops, hprd=True,
                      accelerateScattering=True)
        nThis = int(batch.nIterCol[c])
        for it in range(nThis):
            ctx.formal_sol_gamma_matrices()
            if it >= 3:
                ctx.stat_equil()
                ctx.prd_redistribute(maxIter=4, tol=1e-3)
        n1 = np.asarray(ctx.popsState[0]['n'])
        rho1 = np.asarray(ctx.rhoPrd[ai][ti])
        # vmapped-vs-flat reduction order leaves ~5e-8 after ~200
        # iterations of feedback
        assert np.abs(batch.pops[0][c] / n1 - 1).max() < 1e-6, c
        assert np.abs(rhoBatch[c] - rho1).max() < 1e-6, c
