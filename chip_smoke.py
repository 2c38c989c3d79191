"""Smoke run of lightweaver_tpu on one NVIDIA GPU (four with --four).

    python chip_smoke.py          # one card: golden, recurrence, f32
    python chip_smoke.py --four   # four cards: sharded columns/PRD/2D

Phases (each prints its own lines; any failure exits non-zero):

* device: JAX must report a GPU; on a CPU-only machine the script stops
  here with exit code 2 and prints no result.
* golden: FAL-C (82 depths), H 6-level + Ca II active, 5 rays, f64 --
  the README's example.  Converged once with the host loop
  (`iterate_ctx_se`) and once with the on-device `lax.while_loop`
  (`Context.iterate_on_device`); each result is held to the compiled
  reference's goldens (tests/golden/falc_h6ca_ref.npz) with the bounds
  of tests/test_vs_reference_golden.py: iteration count within 2,
  populations, J and I within 1e-7 relative.  Then `compute_rays` over
  Ca II K (1001 wavelengths, mu=1) must be finite with K in absorption.
* recurrence: the repository has no hand-written kernel; the formal
  solver's alternative depth recurrences ('parallel', 'blocked') are
  checked against `formal_sol_1d(mode='scan')` on the FALC-500 ray
  batch (Nlam=1046, 5 rays, Nk=500), both directions, thermalised
  boundaries: f64 within 1e-10, f32 within 1e-5 (max relative error),
  then timed in interleaved turns.
* f32: one MALI iteration with dtype=float32 at FALC-500 against the
  same iteration on the host CPU and against f64 from the same state;
  rows with lambda > 200 nm are bounded (F32_TOL, see there), all rows
  are printed by band.

--four runs only the four-card phase: `__graft_entry__`'s sharded
ColumnBatch at ('columns','wavelength') = (2, 2) and (4, 1) with 64
FAL-C columns of 82 depths per card, PRD columns and the x-sharded 2D
iteration, each against the same problem on one card (1e-8 relative).

The last line of standard output is one JSON object naming the device.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

GOLDEN_POPS_TOL = 1e-7
GOLDEN_NITER_TOL = 2
# the associative and blocked recurrences reorder the sums of the
# sequential scan; A in [0, 1] keeps the recurrence well conditioned
RECURRENCE_TOL = {'float64': 1e-10, 'float32': 1e-5}
# f32 state (f64 Gamma/J accumulation), one iteration from the same LTE
# start, against the same f32 program on the host CPU and against f64.
# Bounded where f32 holds its range (lambda > 200 nm); below, extreme-UV
# emissivities leave the f32 normal range, which the host CPU flushes to
# zero and the card keeps as subnormals, and the rows are reported only.
# Per wavelength row, the max relative error over depth (values under
# F32_FLOOR of the row's maximum enter with that floor), bounded in
# (median, max) over rows.  Readings on an H100 above 200 nm: card vs
# host CPU median <= 4.2e-3, max <= 9.9e-3; f32 vs f64 median <= 6.6e-3,
# max <= 1.6e-2.  Card and host CPU differ about as much as either does
# from f64, on every row, so this phase cannot see a TF32-sized (~1e-3)
# error: tests/test_gpu_bringup.py checks that every f32 contraction of
# the traced programs asks for HIGHEST precision.
F32_TOL = {'card-vs-cpu': (1e-2, 3e-2), 'f32-vs-f64': (1e-2, 3e-2)}
F32_LAMBDA_MIN = 200.0
F32_FLOOR = 1e-6


def log(msg):
    print(msg, flush=True)


def require_gpu():
    """Stop with exit code 2 unless JAX's default device is a GPU."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != 'gpu':
        print(f'chip_smoke: needs a GPU, JAX found {dev.platform!r}',
              file=sys.stderr)
        raise SystemExit(2)
    return dev


def card_line():
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def relerr(ours, ref):
    ours, ref = np.asarray(ours), np.asarray(ref)
    floor = np.abs(ref).max() * 1e-300
    return float((np.abs(ours - ref) / np.maximum(np.abs(ref), floor)).max())


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def peak_bytes():
    import jax
    return (jax.devices()[0].memory_stats() or {}).get('peak_bytes_in_use')


# ---------------------------------------------------------------------
def _golden_ctx(**kw):
    from lightweaver_tpu.atomic_set import RadiativeSet
    from lightweaver_tpu.context import Context
    from lightweaver_tpu.fal import Falc82
    from lightweaver_tpu.rh_atoms import CaII_atom, H_6_atom

    atmos = Falc82()
    atmos.quadrature(5)
    rs = RadiativeSet([H_6_atom(), CaII_atom()])
    rs.set_active('H', 'Ca')
    spect = rs.compute_wavelength_grid()
    eqPops = rs.compute_eq_pops(atmos)
    return Context(atmos, spect, eqPops, formalSolver='piecewise_bezier3_1d',
                   **kw)


def _check_golden(name, ctx, nIter, ref):
    nRef = int(ref['out_niter'][0])
    errs = {f'pops_a{ia}': relerr(ctx.popsState[ia]['n'],
                                  ref[f'out_pops_a{ia}']) for ia in range(2)}
    errs['J'] = relerr(ctx.J, ref['out_J'])
    errs['I'] = relerr(ctx.I, ref['out_I'])
    log(f'golden {name}: niter={nIter} (reference {nRef}) ' + ' '.join(
        f'{k}={v:.3e}' for k, v in errs.items()))
    check(abs(nIter - nRef) <= GOLDEN_NITER_TOL,
          f'{name}: {nIter} iterations vs reference {nRef}')
    for k, v in errs.items():
        check(v < GOLDEN_POPS_TOL, f'{name}: {k} relative error {v:.3e}')


def phase_golden(card):
    import jax

    from lightweaver_tpu.iterate_ctx import iterate_ctx_se

    ref = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               'tests', 'golden', 'falc_h6ca_ref.npz'))

    ctx = _golden_ctx()
    t0 = time.perf_counter()
    ctx.formal_sol_gamma_matrices()
    jax.block_until_ready(ctx.J)
    tFirst = time.perf_counter() - t0
    ctx = _golden_ctx()
    t0 = time.perf_counter()
    nIter = iterate_ctx_se(ctx, NmaxIter=500, quiet=True)
    jax.block_until_ready(ctx.J)
    tHost = time.perf_counter() - t0
    log(f'golden host loop [{card}]: first iteration (compile + run) '
        f'{tFirst:.2f} s; converged in {tHost:.2f} s wall '
        '(this process already held the compiled iteration)')
    _check_golden('iterate_ctx_se', ctx, nIter, ref)

    lam = np.linspace(392.5, 394.5, 1001)
    I = np.asarray(ctx.compute_rays(wavelengths=lam, mus=[1.0]))[:, 0]
    check(I.shape == (1001,) and np.all(np.isfinite(I)),
          'compute_rays: non-finite or misshapen spectrum')
    core = I[np.abs(lam - 393.47) < 0.05].min()
    wing = 0.5 * (I[0] + I[-1])
    log(f'compute_rays [{card}]: Ca II K core/wing = {core / wing:.4f} '
        f'(core {core:.4e}, wings {wing:.4e})')
    check(core < 0.5 * wing, 'compute_rays: Ca II K not in absorption')

    ctx = _golden_ctx()
    J0 = ctx.J
    n0 = [st['n'] for st in ctx.popsState]
    t0 = time.perf_counter()
    nDev, dJ, dPops = ctx.iterate_on_device(NmaxIter=500)
    tDevFirst = time.perf_counter() - t0
    _check_golden('iterate_on_device', ctx, nDev, ref)
    # again from the initial state: the compiled loop is reused
    ctx.J = J0
    for st, n in zip(ctx.popsState, n0):
        st['n'] = n
    t0 = time.perf_counter()
    nDev2, _, _ = ctx.iterate_on_device(NmaxIter=500)
    tDev = time.perf_counter() - t0
    check(nDev2 == nDev, f'iterate_on_device rerun took {nDev2} iterations')
    log(f'golden on-device loop [{card}]: {nDev} iterations, '
        f'{tDevFirst:.2f} s with compile, {tDev:.3f} s warm '
        f'({tDev / nDev * 1e3:.3f} ms/iter); '
        f'peak_bytes_in_use={peak_bytes()}')


# ---------------------------------------------------------------------
def _falc500_rays(dtype):
    """The FALC-500 ray batch (chi, S, boundary intensities) of the first
    iteration, from the production gather."""
    import jax.numpy as jnp

    from lightweaver_tpu.benchmark import falc_ctx
    from lightweaver_tpu.context import (_cast_params_to_working,
                                         build_iteration_fn)
    from lightweaver_tpu.ops.planck import planck_nu

    ctx = falc_ctx(dtype=dtype)
    cfg = ctx.cfg
    it = build_iteration_fn(cfg)
    params = _cast_params_to_working(ctx.build_params(), cfg.dtype)
    chi, eta = it.gather(params)
    S = (eta + (params['bgSca'] * params['J'].astype(cfg.dtype))
         [:, None, None, :]) / chi
    T, h = params['temperature'], params['height']
    lam = jnp.asarray(cfg.wavelength, cfg.dtype)
    muz = jnp.asarray(cfg.muz, cfg.dtype)
    Nk = cfg.Nk
    rays = {}
    for d, toObs, (k0, k1) in ((0, False, (0, 1)),
                               (1, True, (Nk - 1, Nk - 2))):
        B0, B1 = planck_nu(T[k0], lam), planck_nu(T[k1], lam)
        dtau = (0.5 * (chi[:, :, d, k0] + chi[:, :, d, k1])
                * jnp.abs(h[k0] - h[k1]) / muz[None, :])
        Iu = B0[:, None] - (B1[:, None] - B0[:, None]) / dtau
        rays[toObs] = (chi[:, :, d].reshape(-1, Nk),
                       S[:, :, d].reshape(-1, Nk), h,
                       jnp.broadcast_to(muz, (cfg.Nlam, cfg.Nmu)).reshape(-1),
                       Iu.reshape(-1))
    return rays


def _time_interleaved(fns, rounds=3, n=10):
    import jax
    for f in fns.values():
        jax.block_until_ready(f())
    best = {k: np.inf for k in fns}
    for _ in range(rounds):
        for k, f in fns.items():
            t0 = time.perf_counter()
            for _ in range(n):
                out = f()
            jax.block_until_ready(out)
            best[k] = min(best[k], (time.perf_counter() - t0) / n)
    return best


def phase_recurrence(card):
    import jax
    import jax.numpy as jnp

    from lightweaver_tpu.ops.formal_solver import formal_sol_1d

    for dtype in (jnp.float64, jnp.float32):
        name = np.dtype(dtype).name
        rays = _falc500_rays(dtype)
        B, Nk = rays[True][0].shape
        fns = {}
        for mode in ('scan', 'parallel', 'blocked'):
            f = jax.jit(lambda r, mode=mode: [
                formal_sol_1d(*r[d], to_obs=d, mode=mode)
                for d in (False, True)])
            fns[mode] = (lambda f=f: f(rays))
        ref = fns['scan']()
        for mode in ('parallel', 'blocked'):
            errs = []
            for g, r in zip(fns[mode](), ref):
                for a, b in zip(g, r):
                    check(bool(jnp.all(jnp.isfinite(a))),
                          f'recurrence {mode} {name}: non-finite')
                    errs.append(float(jnp.max(jnp.abs(a - b))
                                      / jnp.max(jnp.abs(b))))
            log(f'recurrence {name} {mode} vs scan [B={B}, Nk={Nk}]: max '
                f'rel err {max(errs):.3e} over I, Psi, IeffBase and both '
                f'directions (bound {RECURRENCE_TOL[name]:.0e})')
            check(max(errs) <= RECURRENCE_TOL[name],
                  f'recurrence {mode} {name}: {max(errs):.3e}')
        best = _time_interleaved(fns)
        log(f'recurrence {name} [{card}]: ms per two-direction formal '
            'solve ' + ' '.join(f'{k}={v * 1e3:.3f}'
                                for k, v in best.items()))


def _one_iteration(dtype):
    """J, emergent I and the f32-range census of the emissivity after one
    FALC-500 MALI iteration from the LTE start, on JAX's default device."""
    import jax
    import jax.numpy as jnp

    from lightweaver_tpu.benchmark import falc_ctx
    from lightweaver_tpu.context import (_cast_params_to_working,
                                         build_iteration_fn)

    ctx = falc_ctx(dtype=dtype)
    ctx.formal_sol_gamma_matrices()
    jax.block_until_ready(ctx.J)
    cfg = ctx.cfg
    _, eta = build_iteration_fn(cfg).gather(
        _cast_params_to_working(ctx.build_params(), cfg.dtype))
    tiny = jnp.finfo(cfg.dtype).tiny
    # per wavelength: entries below the normal range, and exact zeros
    sub = jnp.sum((eta != 0) & (jnp.abs(eta) < tiny), axis=(1, 2, 3))
    zero = jnp.sum(eta == 0, axis=(1, 2, 3))
    return (np.asarray(ctx.J, np.float64), np.asarray(ctx.I, np.float64),
            np.asarray(ctx.spect.wavelength), np.asarray(sub),
            np.asarray(zero))


def _row_errors(ours, ref):
    """Max relative error of each wavelength row of J or I; values under
    F32_FLOOR of the row's maximum enter with that floor."""
    ours, ref = ours.reshape(len(ours), -1), ref.reshape(len(ref), -1)
    floor = F32_FLOOR * np.abs(ref).max(axis=1, keepdims=True)
    return (np.abs(ours - ref) / np.maximum(np.abs(ref), floor)).max(axis=1)


def phase_f32(card):
    import jax
    import jax.numpy as jnp

    f64 = _one_iteration(None)
    f32 = _one_iteration(jnp.float32)
    with jax.default_device(jax.devices('cpu')[0]):
        cpu = _one_iteration(jnp.float32)
    lam = f64[2]
    log(f'f32 state [{card}]: emissivity entries below the f32 normal '
        f'range: host CPU {int(cpu[3].sum())}, card {int(f32[3].sum())}; '
        f'exact zeros host CPU {int(cpu[4].sum())}, card '
        f'{int(f32[4].sum())}, f64 {int(f64[4].sum())} (largest lambda '
        f'with a zero: {lam[f32[4] > 0].max() if f32[4].any() else 0:.1f}'
        ' nm)')
    bands = ((0.0, 100.0), (100.0, F32_LAMBDA_MIN), (F32_LAMBDA_MIN, 500.0),
             (500.0, np.inf))
    rows = {(what, q): _row_errors(a, b[i])
            for what, b in (('card-vs-cpu', cpu), ('f32-vs-f64', f64))
            for i, (q, a) in enumerate(zip(('J', 'I'), f32))}
    for lo, hi in bands:
        m = (lam > lo) & (lam <= hi)
        for (what, q), r in rows.items():
            w = np.argmax(np.where(m, r, -1.0))
            log(f'f32 state [{card}]: {what} {q} on {lo:g} < lambda <= {hi:g}'
                f' nm ({int(m.sum())} rows): row max rel err median '
                f'{np.median(r[m]):.3e}, 90% {np.percentile(r[m], 90):.3e},'
                f' max {r[w]:.3e} at {lam[w]:.3f} nm')
    m = lam > F32_LAMBDA_MIN
    for (what, q), r in rows.items():
        tol = F32_TOL[what]
        check(np.median(r[m]) < tol[0] and r[m].max() < tol[1],
              f'f32 state {what} {q} on lambda > {F32_LAMBDA_MIN:g} nm: '
              f'median {np.median(r[m]):.3e}, max {r[m].max():.3e} '
              f'(bounds {tol})')


FOUR_COLS_PER_CARD = 64
FOUR_DEPTHS = 82
# --four only: the phase checks sharded == unsharded, not speed, so XLA
# skips autotuning its kernels (about half of each compile on the card)
FOUR_XLA_FLAGS = '--xla_gpu_autotune_level=0'


def phase_four(card):
    from concurrent.futures import ThreadPoolExecutor

    import jax

    import __graft_entry__ as g

    check(len(jax.devices()) >= 4, f'--four needs 4 GPUs, found '
          f'{len(jax.devices())}')
    nCols = 4 * FOUR_COLS_PER_CARD
    shapes = ((2, 2), (4, 1))
    t0 = time.perf_counter()
    # the same columns on one card (the reference of both meshes) and
    # sharded over each mesh shape
    batches = [g._columns_batch(None, nCols, FOUR_DEPTHS)] + [
        g._columns_batch(g.make_columns_mesh(4, s), nCols, FOUR_DEPTHS)
        for s in shapes]
    lowered = [b._iter_full.lower(b.params) for b in batches]
    log(f'columns: {nCols} columns x {FOUR_DEPTHS} depths set up and '
        f'lowered for one card and meshes {shapes} '
        f'[{time.perf_counter() - t0:.1f} s]')
    # XLA compiles outside the GIL: the three column programs compile in
    # threads while the PRD and 2D checks run; the column runs then find
    # their programs compiled
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(lowered)) as pool:
        compiling = [pool.submit(lo.compile) for lo in lowered]
        t1 = time.perf_counter()
        log(g._dryrun_prd_columns(4) + f' [{card}, '
            f'{time.perf_counter() - t1:.1f} s]')
        t1 = time.perf_counter()
        log(g._dryrun_2d_xsharded(4) + f' [{card}, '
            f'{time.perf_counter() - t1:.1f} s]')
        for f in compiling:
            f.result()
    log(f'columns: 3 iteration programs compiled [{card}, '
        f'{time.perf_counter() - t0:.1f} s after lowering]')
    t0 = time.perf_counter()
    ref = g._columns_iterate(batches[0])[0]
    log(f'columns: unsharded reference, 4 iterations [{card}, '
        f'{time.perf_counter() - t0:.1f} s]')
    for shape, batch in zip(shapes, batches[1:]):
        t0 = time.perf_counter()
        log(g._dryrun_columns(4, meshShape=shape,
                              colsPerDevice=FOUR_COLS_PER_CARD,
                              nDepth=FOUR_DEPTHS, refPops=ref, batch=batch)
            + f' [{card}, {time.perf_counter() - t0:.1f} s]')


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--four', action='store_true',
                    help='run only the four-card phase')
    args = ap.parse_args(argv)

    if args.four:
        os.environ['XLA_FLAGS'] = ' '.join(
            filter(None, (os.environ.get('XLA_FLAGS'), FOUR_XLA_FLAGS)))
    dev = require_gpu()
    import jax

    import lightweaver_tpu  # noqa: F401  (enables x64)
    from lightweaver_tpu.compile_cache import setup_compile_cache

    log(f'compile cache: {setup_compile_cache()}')
    card = card_line()
    log(f'card: {card}')
    log(f'jax {jax.__version__}: {len(jax.devices())} x {dev.device_kind}')
    phases = ([('four', phase_four)] if args.four else
              [('golden', phase_golden), ('recurrence', phase_recurrence),
               ('f32', phase_f32)])
    for name, fn in phases:
        t0 = time.perf_counter()
        fn(card)
        log(f'phase {name}: ok in {time.perf_counter() - t0:.1f} s')
    log(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': dev.platform, 'kind': dev.device_kind,
        'count': len(jax.devices())}}), flush=True)


if __name__ == '__main__':
    main()
