"""Benchmark/autotune: time the configurable kernel variants on the
standard FALC-500 H+Ca problem and persist the fastest to lightweaverrc.

The analogue of the reference's SIMD-implementation autotuner
(ref: /root/reference/lightweaver/benchmark.py:19-113): instead of
scalar/SSE2/AVX2/AVX512 plugins, the tunables are the depth-recurrence
evaluation mode, the working precision and the Gamma accumulation
contract.  Timings are only meaningful on the GPU, so `benchmark()`
refuses any other device.
"""
import sys
import time

import numpy as np


def falc_ctx(Nspace=500, Nrays=5, dtype=None, recurrenceMode='scan',
             **kw):
    """FAL-C interpolated in log column mass to ``Nspace`` depths, H
    6-level + Ca II active, ``Nrays`` rays: the problem the compiled
    reference's autotuner times (Nlam = 1046)."""
    from .atmosphere import Atmosphere
    from .atomic_set import RadiativeSet
    from .context import Context
    from .fal import Falc82
    from .rh_atoms import CaII_atom, H_6_atom

    full = Falc82()
    cm = np.log10(full.cmass)
    cmNew = np.linspace(cm[0], cm[-1], Nspace)

    def interp(y, logY=False):
        if logY:
            return 10 ** np.interp(cmNew, cm, np.log10(y))
        return np.interp(cmNew, cm, y)

    atmos = Atmosphere(height=interp(full.height),
                       temperature=interp(full.temperature, logY=True),
                       vlos=np.zeros(Nspace), vturb=interp(full.vturb),
                       ne=interp(full.ne, logY=True),
                       nHTot=interp(full.nHTot, logY=True))
    atmos.quadrature(Nrays)
    rs = RadiativeSet([H_6_atom(), CaII_atom()])
    rs.set_active('H', 'Ca')
    spect = rs.compute_wavelength_grid()
    eqPops = rs.compute_eq_pops(atmos)
    return Context(atmos, spect, eqPops, dtype=dtype,
                   recurrenceMode=recurrenceMode, **kw)


def require_gpu():
    """The default JAX device, which must be a GPU: timings of the CPU
    backend are not timings of the card."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != 'gpu':
        raise RuntimeError(f'benchmarks run on a GPU; JAX found '
                           f'{dev.platform!r}')
    return dev


def race_iterations(ctxs, nIter=20, reps=3, warmup=2):
    """Time several contexts with INTERLEAVED blocks of ``nIter``
    `formal_sol_gamma_matrices` calls (every contender sees the same
    drift of clocks and power) and return {name: best seconds/iter}."""
    import jax
    for ctx in ctxs.values():
        for _ in range(warmup):
            ctx.formal_sol_gamma_matrices()
        jax.block_until_ready(ctx.J)
    best = {name: np.inf for name in ctxs}
    for _ in range(reps):
        for name, ctx in ctxs.items():
            t0 = time.perf_counter()
            for _ in range(nIter):
                u = ctx.formal_sol_gamma_matrices()
            jax.block_until_ready(ctx.J)
            best[name] = min(best[name],
                             (time.perf_counter() - t0) / nIter)
            if not np.isfinite(u.dJMax):
                raise FloatingPointError(f'{name}: non-finite dJ')
    return best


def benchmark(Niter: int = 20, writeConfig: bool = False,
              verbose: bool = True) -> dict:
    """Race every (recurrence, precision) variant, then the Gamma
    accumulation contract at the winner; optionally persist the winners
    to the user config.  Progress goes to stderr."""
    import jax.numpy as jnp

    from .compile_cache import setup_compile_cache
    from .context import RECURRENCE_MODES

    require_gpu()
    setup_compile_cache()
    precisions = {'f64': None, 'mixed': jnp.float32}
    ctxs = {(mode, prec): falc_ctx(dtype=dt, recurrenceMode=mode)
            for mode in RECURRENCE_MODES for prec, dt in precisions.items()}
    results = race_iterations(ctxs, nIter=Niter)
    if verbose:
        for (mode, prec), wall in results.items():
            print(f'{mode}/{prec}: {wall * 1e3:.3f} ms/iter',
                  file=sys.stderr)
    best = min(results, key=results.get)

    # Gamma lambda-accumulation contract at the winning variant (only
    # distinct under mixed precision): 'blocked' keeps working-dtype
    # block partials at a slightly raised dJ floor (test_gamma_accum.py)
    bestAccum = 'exact'
    accumResults = {'exact': results[best]}
    if best[1] == 'mixed':
        ctx = falc_ctx(dtype=jnp.float32, recurrenceMode=best[0],
                       gammaAccum='blocked')
        accumResults.update(race_iterations(
            {'exact': ctxs[best], 'blocked': ctx}, nIter=Niter))
        bestAccum = min(accumResults, key=accumResults.get)
        if verbose:
            print(f"gammaAccum [{best[0]}/{best[1]}]: "
                  + ' '.join(f'{k}={v * 1e3:.3f} ms/iter'
                             for k, v in accumResults.items()),
                  file=sys.stderr)

    if verbose:
        print(f'fastest: {best[0]}/{best[1]}/{bestAccum}', file=sys.stderr)
    if writeConfig:
        from .config import params
        params['RecurrenceMode'] = best[0]
        params['Precision'] = best[1]
        params['GammaAccum'] = bestAccum
        params.save()
    return {'timings': results, 'best': best,
            'accumTimings': accumResults, 'bestAccum': bestAccum}
