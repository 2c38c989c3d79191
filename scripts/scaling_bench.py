"""Measure 1.5D column-batch scaling (BASELINE config 5).

Two modes, both on virtual CPU devices:

  python scripts/scaling_bench.py mesh        # strong scaling
  python scripts/scaling_bench.py mesh-weak   # fixed work per device

Run with XLA_FLAGS=--xla_force_host_platform_device_count=8; the modes
pin the CPU backend themselves.  Results are printed as JSON lines.
They measure the partitioned program on an oversubscribed host, not a
GPU mesh.
"""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))


def build_batch(nCols, nDepth=40, Nrays=3, mesh=None, dtype='float64',
                active=('Ca',), seed=0):
    import jax.numpy as jnp
    from lightweaver_tpu.fal import Falc82
    from lightweaver_tpu.parallel import ColumnBatch
    from lightweaver_tpu.rh_atoms import CaII_atom, H_6_atom

    dtype = {'float32': jnp.float32, 'float64': jnp.float64}[str(dtype)]
    full = Falc82()
    idx = np.unique(np.linspace(0, 81, nDepth).astype(int))
    Nk = len(idx)
    rng = np.random.default_rng(seed)
    scale = 1.0 + 0.05 * rng.standard_normal((nCols, 1))
    T = full.temperature[idx][None, :] * scale
    rep = lambda a: np.broadcast_to(a[idx], (nCols, Nk)).copy()
    return ColumnBatch.from_stacked(
        full.height[idx], T, rep(full.vlos), rep(full.vturb),
        rep(full.ne), rep(full.nHTot),
        lambda: [H_6_atom(), CaII_atom()], active, Nrays=Nrays,
        mesh=mesh, dtype=dtype)


def time_iters(batch, nIter=6, nWarm=2):
    for _ in range(nWarm):
        batch.formal_sol_gamma_matrices()
        batch.stat_equil()
    t0 = time.perf_counter()
    for _ in range(nIter):
        batch.formal_sol_gamma_matrices()
        batch.stat_equil()
    np.asarray(batch.ne)  # sync
    return (time.perf_counter() - t0) / nIter


def run_mesh():
    import jax
    jax.config.update('jax_platforms', 'cpu')
    jax.config.update('jax_enable_x64', True)
    from lightweaver_tpu.parallel import make_mesh
    ndev = len(jax.devices())
    assert ndev >= 8, f'need 8 virtual devices, got {ndev}'
    nCols = 64
    results = {}
    for n in (1, 2, 4, 8):
        mesh = (make_mesh(nColumns=n, nWavelength=1,
                          devices=jax.devices()[:n]) if n > 1 else None)
        batch = build_batch(nCols, mesh=mesh)
        results[n] = time_iters(batch)
        print(json.dumps({'mode': 'mesh-strong', 'ndev': n,
                          'cols': nCols, 's_per_iter': results[n],
                          'speedup': results[1] / results[n],
                          'efficiency': results[1] / results[n] / n}),
              flush=True)


def run_mesh_weak(colsPerDev=32):
    """Weak scaling: fixed per-device work (colsPerDev columns each).

    Ideal weak scaling keeps s_per_iter constant as devices (and total
    columns) grow; efficiency = t(1 dev) / t(N dev).  The columns axis
    is embarrassingly parallel (scripts/comm_analysis.py shows the
    partitioner inserts ZERO collectives on it), so efficiency here
    measures only partitioning overhead on the virtual CPU mesh."""
    import jax
    jax.config.update('jax_platforms', 'cpu')
    jax.config.update('jax_enable_x64', True)
    from lightweaver_tpu.parallel import make_mesh
    ndev = len(jax.devices())
    assert ndev >= 8, f'need 8 virtual devices, got {ndev}'
    results = {}
    for n in (1, 2, 4, 8):
        mesh = (make_mesh(nColumns=n, nWavelength=1,
                          devices=jax.devices()[:n]) if n > 1 else None)
        batch = build_batch(colsPerDev * n, mesh=mesh)
        results[n] = time_iters(batch)
        print(json.dumps({'mode': 'mesh-weak', 'ndev': n,
                          'cols': colsPerDev * n,
                          's_per_iter': results[n],
                          'efficiency': results[1] / results[n]}),
              flush=True)


if __name__ == '__main__':
    mode = sys.argv[1] if len(sys.argv) > 1 else 'mesh'
    {'mesh': run_mesh, 'mesh-weak': run_mesh_weak}[mode]()
