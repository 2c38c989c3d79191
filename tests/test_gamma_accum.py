"""gammaAccum='blocked': working-dtype lambda-block partials with the
inter-block Gamma/rate reduction in accumDtype.

Checks (mixed precision, f32 state + f64 accum):
  * Gamma/rates/J agree with the exact-adt reduction to f32-roundoff
    levels on a FAL-C H+Ca problem;
  * the full MALI iteration converges to dPops < 1e-3 (the documented
    mixed-precision floor, CLAUDE.md) with the blocked reduction.
ref for what must stay faithful:
/root/reference/Source/SimdFullIterationTemplates.hpp:206-234
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from lightweaver_tpu.atmosphere import Atmosphere
from lightweaver_tpu.atomic_set import RadiativeSet
from lightweaver_tpu.context import Context
from lightweaver_tpu.fal import Falc82
from lightweaver_tpu.rh_atoms import CaII_atom, H_6_atom


def _ctx(gammaAccum, Nk=40, active=('H', 'Ca')):
    full = Falc82()
    idx = np.unique(np.linspace(0, 81, Nk).astype(int))
    atmos = Atmosphere(height=full.height[idx],
                       temperature=full.temperature[idx],
                       vlos=full.vlos[idx], vturb=full.vturb[idx],
                       ne=full.ne[idx], nHTot=full.nHTot[idx])
    atmos.quadrature(3)
    rs = RadiativeSet([H_6_atom(), CaII_atom()])
    rs.set_active(*active)
    spect = rs.compute_wavelength_grid()
    eqPops = rs.compute_eq_pops(atmos)
    return Context(atmos, spect, eqPops, dtype=jnp.float32,
                   gammaAccum=gammaAccum)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


def test_blocked_matches_exact():
    ctxE = _ctx('exact')
    ctxB = _ctx('blocked')
    for _ in range(2):
        for c in (ctxE, ctxB):
            c.formal_sol_gamma_matrices()
            c.stat_equil()
    uE = ctxE.formal_sol_gamma_matrices()
    uB = ctxB.formal_sol_gamma_matrices()
    # pops trajectories identical so far?  They will have diverged at
    # f32 roundoff; compare Gamma on the *same* state instead
    params = dict(ctxE._params)
    import dataclasses

    from lightweaver_tpu.context import build_iteration_fn
    outs = {}
    for mode in ('exact', 'blocked'):
        cfg = dataclasses.replace(ctxE.cfg, gammaAccum=mode)
        outs[mode] = jax.jit(build_iteration_fn(cfg))(params)
    e, b = outs['exact'], outs['blocked']
    assert _rel(b['J'], e['J']) < 1e-10          # J path is untouched
    for ai in range(len(e['Gamma'])):
        assert _rel(b['Gamma'][ai], e['Gamma'][ai]) < 5e-6
        for ti in range(len(e['Rij'][ai])):
            assert _rel(b['Rij'][ai][ti], e['Rij'][ai][ti]) < 5e-6
            assert _rel(b['Rji'][ai][ti], e['Rji'][ai][ti]) < 5e-6
    assert np.isfinite(float(uE.dJMax)) and np.isfinite(float(uB.dJMax))


@pytest.mark.slow
def test_blocked_converges_mixed_precision():
    # same problem as test_mixed_precision.py's exact-adt case (Ca-only
    # active) but at the BLOCKED accumulation contract: dPops < 1e-3
    # intact, dJ floor raised to ~8e-3 (vs ~4e-3 exact).  Measured
    # here: exact converges (dJ<5e-3, dPops<1e-3) at ~408 iterations;
    # blocked reaches dJ 7.8e-3 / dPops 5.7e-4 and holds there.
    ctx = _ctx('blocked', Nk=40, active=('Ca',))
    for it in range(600):
        ju = ctx.formal_sol_gamma_matrices()
        if it < 3:
            continue
        pu = ctx.stat_equil()
        if float(ju.dJMax) < 1e-2 and pu.dPopsMax < 1e-3:
            break
    assert it < 599, (float(ju.dJMax), pu.dPopsMax)
