"""Quantify the mixed-precision convergence floor per BASELINE config.

For each of the five BASELINE.md benchmark configs, converge with the
production default (f64, XLA path) and with the mixed fast path
(f32 state + f64 accumulation, gammaAccum='blocked'), recording:

  - iterations run and whether the iterate_ctx_se criteria
    (dJ < 5e-3, dPops < 1e-3, Nscatter=3) were met before NmaxIter;
  - the dJ / dPops floors reached (min over the run);
  - wall time;
  - the mixed-vs-f64 deviation of converged populations and of the
    emergent spectrum on bright rows (> 1e-3 of peak — the deep-UV
    rows where f32 state stalls carry ~1e-13 of the peak intensity).

Run on the GPU:  python scripts/precision_floors.py [config ...] > log
"""
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent / 'refgold'))

import numpy as np

import jax

jax.config.update('jax_enable_x64', True)
import jax.numpy as jnp


def log(**kw):
    print(json.dumps(kw), flush=True)


def converge_track(ctx, NmaxIter=500, prd=False, Nscatter=3,
                   JTol=5e-3, popsTol=1e-3):
    """iterate_ctx_se's loop with dJ/dPops floor tracking."""
    dJh, dPh = [], []
    t0 = time.perf_counter()
    it = -1
    try:
        for it in range(NmaxIter):
            u = ctx.formal_sol_gamma_matrices()
            dJ = float(u.dJMax)
            if it < Nscatter:
                continue
            pu = ctx.stat_equil()
            dP = float(pu.dPopsMax)
            if prd:
                ctx.prd_redistribute(maxIter=3, tol=1e-2)
            dJh.append(dJ)
            dPh.append(dP)
            if dJ < JTol and dP < popsTol:
                break
    except Exception as e:                     # record blow-ups honestly
        return {'error': repr(e)[:200], 'iterations': it + 1}
    wall = time.perf_counter() - t0
    return {
        'iterations': it + 1,
        'converged': bool(dJh[-1] < JTol and dPh[-1] < popsTol),
        'wall_s': round(wall, 1),
        'final_dJ': float(f'{dJh[-1]:.3g}'),
        'final_dPops': float(f'{dPh[-1]:.3g}'),
        'floor_dJ': float(f'{min(dJh):.3g}'),
        'floor_dPops': float(f'{min(dPh):.3g}'),
    }


def deviations(ctxM, ctx64):
    out = {}
    p64 = [np.asarray(st['n']) for st in ctx64.popsState]
    pM = [np.asarray(st['n']) for st in ctxM.popsState]
    popDev = 0.0
    for a, b in zip(pM, p64):
        m = b > 1e-8 * b.max()
        popDev = max(popDev, float(np.abs((a[m] - b[m]) / b[m]).max()))
    out['pops_max_rel_vs_f64'] = float(f'{popDev:.3g}')
    I64 = np.asarray(ctx64.I)
    IM = np.asarray(ctxM.I)
    if I64.ndim > 1:
        I64 = I64.reshape(I64.shape[0], -1)[:, -1]
        IM = IM.reshape(IM.shape[0], -1)[:, -1]
    bright = I64 > 1e-3 * I64.max()
    rel = np.abs(IM - I64) / np.maximum(np.abs(I64), 1e-300)
    out['spectrum_bright_max_rel_vs_f64'] = float(f'{rel[bright].max():.3g}')
    out['spectrum_median_rel_vs_f64'] = float(f'{np.median(rel):.3g}')
    return out


def build(config, dtype, fast):
    import lightweaver_tpu as lw
    from lightweaver_tpu.ops.ng import NgOptions
    from lightweaver_tpu.rh_atoms import (CaII_atom, H_6_atom, MgII_atom,
                                          NaI_atom)

    kw = {}
    if dtype is not None:
        kw['dtype'] = dtype
    prd = False
    if config == '1_falc_h6ca_crd':
        atmos = lw.Falc82()
        atmos.quadrature(5)
        rs = lw.RadiativeSet([H_6_atom(), CaII_atom()])
        rs.set_active('H', 'Ca')
    elif config == '2_multi_atom_ng':
        atmos = lw.Falc82()
        atmos.quadrature(5)
        rs = lw.RadiativeSet([H_6_atom(), CaII_atom(), NaI_atom(),
                              MgII_atom()])
        rs.set_active('H', 'Ca', 'Na')
        kw['ngOptions'] = NgOptions(Norder=2, Nperiod=5, Ndelay=50)
    elif config == '3_prd_h_mg':
        atmos = lw.Falc82()
        atmos.quadrature(5)
        rs = lw.RadiativeSet([H_6_atom(), MgII_atom()])
        rs.set_active('H', 'Mg')
        prd = True
    elif config == '4_stokes_zeeman':
        atmos = lw.Falc82()
        atmos.quadrature(5)
        atmos.B = np.full(atmos.Nspace, 0.1)
        atmos.gammaB = np.full(atmos.Nspace, np.pi / 3)
        atmos.chiB = np.full(atmos.Nspace, np.pi / 6)
        rs = lw.RadiativeSet([H_6_atom(), CaII_atom()])
        rs.set_active('H', 'Ca')
    elif config == '5_2d_ca':
        from export_inputs import build_2d_atmos
        atmos = build_2d_atmos()
        rs = lw.RadiativeSet([H_6_atom(), CaII_atom()])
        rs.set_active('Ca')
        kw['formalSolver'] = 'piecewise_linear_2d'
    else:
        raise ValueError(config)
    if fast:
        kw['gammaAccum'] = 'blocked'
    spect = rs.compute_wavelength_grid()
    eqPops = rs.compute_eq_pops(atmos)
    ctx = lw.Context(atmos, spect, eqPops, **kw)
    return ctx, prd


CONFIGS = ['1_falc_h6ca_crd', '2_multi_atom_ng', '3_prd_h_mg',
           '4_stokes_zeeman', '5_2d_ca']


def main():
    out = {'device': str(jax.devices()[0]),
           'criteria': 'iterate_ctx_se defaults: JTol=5e-3, popsTol=1e-3,'
                       ' Nscatter=3, NmaxIter=500',
           'mixed_config': "f32 state + f64 Gamma/rate accumulation, "
                           "gammaAccum='blocked'",
           'configs': {}}
    only = sys.argv[1:] or CONFIGS
    for config in only:
        row = {}
        ctx64 = None
        for tag, dtype, fast in (('f64', None, False),
                                 ('mixed_fast', jnp.float32, True)):
            try:
                ctx, prd = build(config, dtype, fast)
            except Exception as e:
                row[tag] = {'error': repr(e)[:200]}
                log(config=config, tag=tag, error=repr(e)[:200])
                continue
            res = converge_track(ctx, prd=prd)
            if tag == 'f64':
                ctx64 = ctx
            elif ctx64 is not None and 'error' not in res:
                res.update(deviations(ctx, ctx64))
            res['meets_popsTol_1e-3'] = bool(res.get('converged', False))
            row[tag] = res
            log(config=config, tag=tag, **res)
        out['configs'][config] = row
        p = Path(__file__).parent.parent / 'chiprun_out' / \
            'precision_floors.json'
        p.parent.mkdir(exist_ok=True)
        p.write_text(json.dumps(out, indent=1))
    log(wrote=str(p))


if __name__ == '__main__':
    main()
