"""What keeps the program honest about its device: removed schemes and
modes raise, the compile cache lands where it should, and the GPU
drivers (chip_smoke.py, bench.py, benchmark()) refuse a CPU-only run."""
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax

from lightweaver_tpu import compile_cache
from lightweaver_tpu.config import params as cfgParams

REPO = Path(__file__).resolve().parent.parent


def _ctx(**kw):
    from lightweaver_tpu.atmosphere import Atmosphere
    from lightweaver_tpu.atomic_set import RadiativeSet
    from lightweaver_tpu.context import Context
    from lightweaver_tpu.fal import Falc82
    from lightweaver_tpu.rh_atoms import CaII_atom, H_6_atom

    full = Falc82()
    idx = np.unique(np.linspace(0, 81, 10).astype(int))
    atmos = Atmosphere(height=full.height[idx],
                       temperature=full.temperature[idx],
                       vlos=full.vlos[idx], vturb=full.vturb[idx],
                       ne=full.ne[idx], nHTot=full.nHTot[idx])
    atmos.quadrature(2)
    rs = RadiativeSet([H_6_atom(), CaII_atom()])
    rs.set_active('Ca')
    spect = rs.compute_wavelength_grid()
    eqPops = rs.compute_eq_pops(atmos)
    return Context(atmos, spect, eqPops, **kw)


REMOVED_SCHEMES = ['mali_full_precond_pallas', 'mali_full_precond_fused']


@pytest.mark.parametrize('name', REMOVED_SCHEMES)
def test_removed_scheme_raises(name):
    with pytest.raises(ValueError, match='Unknown iteration scheme'):
        _ctx(fsIterScheme=name)
    ctx = _ctx()
    with pytest.raises(ValueError, match=name):
        ctx.set_fs_iter_scheme(name)
    assert ctx.get_fs_iter_scheme_properties()['name'] == \
        'mali_full_precond'


@pytest.mark.parametrize('key,value,match', [
    ('IterationScheme', 'mali_full_precond_fused', 'Unknown iteration'),
    ('IterationScheme', 'mali_full_precond_pallas', 'Unknown iteration'),
    ('RecurrenceMode', 'pallas', 'Unknown recurrenceMode'),
    ('RecurrenceMode', 'mosaic', 'Unknown recurrenceMode'),
])
def test_lightweaverrc_value_that_no_longer_exists_raises(
        monkeypatch, key, value, match):
    """A lightweaverrc naming a scheme or mode that does not exist is
    an error, not a silent fallback to another path."""
    monkeypatch.setitem(cfgParams, key, value)
    with pytest.raises(ValueError, match=match) as e:
        _ctx()
    assert repr(value) in str(e.value)


def test_compile_cache_respects_env(monkeypatch):
    monkeypatch.setenv('JAX_COMPILATION_CACHE_DIR', '/elsewhere/cache')
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.setup_compile_cache() == '/elsewhere/cache'
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch):
    monkeypatch.delenv('JAX_COMPILATION_CACHE_DIR', raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.setup_compile_cache()
        assert jax.config.jax_compilation_cache_dir == path
        assert Path(path) == REPO / '.jax_cache'
        assert compile_cache.setup_compile_cache() == path   # stable
        ignored = (REPO / '.gitignore').read_text().split()
        assert '.jax_cache/' in ignored
    finally:
        jax.config.update('jax_compilation_cache_dir', before)


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', REPO / 'chip_smoke.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_device_check_refuses_cpu():
    cs = _load_chip_smoke()
    with pytest.raises(SystemExit) as e:
        cs.require_gpu()
    assert e.value.code == 2


@pytest.mark.parametrize('script', ['chip_smoke.py', 'bench.py'])
def test_gpu_drivers_exit_nonzero_without_gpu(script):
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    r = subprocess.run([sys.executable, str(REPO / script)], cwd=REPO,
                       env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    for line in r.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)


def test_chip_smoke_alone_fails(tmp_path):
    """Without the rest of the repository the script cannot pass."""
    (tmp_path / 'chip_smoke.py').write_text(
        (REPO / 'chip_smoke.py').read_text())
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    env.pop('PYTHONPATH', None)
    r = subprocess.run([sys.executable, 'chip_smoke.py'], cwd=tmp_path,
                       env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0 and '"ok"' not in r.stdout


def test_benchmark_refuses_cpu():
    from lightweaver_tpu.benchmark import benchmark, require_gpu
    with pytest.raises(RuntimeError, match='GPU'):
        require_gpu()
    with pytest.raises(RuntimeError, match='GPU'):
        benchmark(Niter=1, verbose=False)


def _dot_precisions(closed):
    """(operand dtype, precision) of every dot_general in a jaxpr and its
    sub-jaxprs."""
    from jax.extend import core as jcore

    found = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == 'dot_general':
                found.append((eqn.invars[0].aval.dtype,
                              eqn.params['precision']))
            for v in eqn.params.values():
                for sub in (v if isinstance(v, (list, tuple)) else [v]):
                    if isinstance(sub, jcore.ClosedJaxpr):
                        walk(sub.jaxpr)
                    elif isinstance(sub, jcore.Jaxpr):
                        walk(sub)
    walk(closed.jaxpr)
    return found


def _f32_programs():
    import jax.numpy as jnp

    from lightweaver_tpu.context import build_iteration_fn
    from lightweaver_tpu.ops.linalg import solve_KxK_over_depth
    from lightweaver_tpu.ops.ng import device_ng_accelerate, device_ng_init
    from lightweaver_tpu.ops.stokes import delo_bezier_stokes

    ctx = _ctx(dtype=jnp.float32)
    f32 = jnp.float32
    B, N = 3, ctx.cfg.Nk
    hist, cnt = device_ng_init(jnp.ones((4, 5), f32), 2)
    return {
        'iteration': (build_iteration_fn(ctx.cfg), (ctx.build_params(),)),
        'stokes': (delo_bezier_stokes,
                   (jnp.ones((B, 7, N), f32), jnp.ones((B, 4, N), f32),
                    jnp.asarray(np.linspace(1e3, 0.0, N), f32),
                    jnp.ones(B, f32), jnp.zeros((B, 4), f32))),
        'ng': (lambda h, c, s: device_ng_accelerate(h, c, s, 2, 1, 0),
               (hist, cnt, jnp.ones(20, f32))),
        'stat_eq': (solve_KxK_over_depth,
                    (jnp.ones((3, 3, N), f32) + jnp.eye(3, dtype=f32)
                     [:, :, None], jnp.ones((3, N), f32))),
    }


@pytest.mark.parametrize('name', ['iteration', 'stokes', 'ng', 'stat_eq'])
def test_f32_contractions_ask_for_highest_precision(name):
    """On the GPU an f32 dot_general without precision=HIGHEST may run
    in TF32 (a 10-bit mantissa); every contraction of the f32 programs
    asks for full precision."""
    fn, args = _f32_programs()[name]
    dots = _dot_precisions(jax.make_jaxpr(fn)(*args))
    for dtype, precision in dots:
        if np.dtype(dtype) == np.float32:
            assert precision is not None and all(
                p == jax.lax.Precision.HIGHEST for p in precision), (
                name, precision)


def test_on_device_loop_leaves_the_host_loop_state():
    """After iterate_on_device, J/I/Gamma are those of the last formal
    solution inside the loop (lagging the populations by one
    statistical-equilibrium solve), exactly as the host loop leaves
    them: the state the reference's goldens hold.  The linear formal
    solver keeps the two compiled programs' roundings apart by ~eps: the
    Bezier-3 closed forms cancel near their Taylor threshold, where two
    compilations can differ by ~1e-9."""
    nIter = 6
    dev = _ctx(formalSolver='piecewise_linear_1d')
    it, _, _ = dev.iterate_on_device(NmaxIter=nIter)
    assert it == nIter
    host = _ctx(formalSolver='piecewise_linear_1d')
    for i in range(nIter):
        host.formal_sol_gamma_matrices()
        if i >= 3:
            host.stat_equil()
    for a, b in ((dev.J, host.J), (dev.I, host.I),
                 (dev._Gamma[0], host._Gamma[0]),
                 (dev.popsState[0]['n'], host.popsState[0]['n'])):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-10, atol=1e-300)


@pytest.mark.gpu
@pytest.mark.parametrize('dtype,tol', [('float64', 1e-10),
                                       ('float32', 1e-5)])
def test_recurrence_modes_agree_on_gpu(gpu, dtype, tol):
    """The associative and blocked depth recurrences against the
    sequential scan, compiled for the card."""
    import jax.numpy as jnp

    from lightweaver_tpu.ops.formal_solver import formal_sol_1d

    rng = np.random.default_rng(3)
    B, N = 257, 64
    h = np.linspace(2e8, 0.0, N)
    chi = 10 ** rng.uniform(-1, 1, (B, 1)) * np.geomspace(1e-9, 1e-3, N)
    S = 1.0 + rng.uniform(0, 1, (B, N))
    dt = jnp.dtype(dtype)
    args = [jax.device_put(jnp.asarray(x, dt), gpu)
            for x in (chi, S, h, rng.uniform(0.1, 1, B), np.zeros(B))]
    ref = formal_sol_1d(*args, mode='scan')
    for mode in ('parallel', 'blocked'):
        for a, b in zip(formal_sol_1d(*args, mode=mode), ref):
            err = float(jnp.max(jnp.abs(a - b)) / jnp.max(jnp.abs(b)))
            assert err < tol, (mode, err)
