"""Benchmark: formal-solver grid-point throughput of the full MALI step.

Times the same problem the compiled reference is timed on
(scripts/refgold, REFGOLD_BENCH_ITERS mode; see bench_baseline.json):
FAL-C interpolated to 500 depth points, H 6-level + Ca II active, 5-ray
quadrature, `formal_sol_gamma_matrices` iterations.  Mirrors the
reference's autotune harness configuration
(ref: /root/reference/lightweaver/benchmark.py:19-113).

Metric: formal-solver grid-point updates per second per GPU, where one
sweep touches Nlambda x Nmu x 2 directions x Nspace points
(BASELINE.md's north-star denominator).  `vs_baseline` is measured
throughput over the compiled reference's on a CPU (4 threads,
bench_baseline.json).

The recurrence modes ('scan'/'parallel'/'blocked') are raced in
interleaved blocks and the fastest is reported.  State is f32 with f64
accumulation (mixed); BENCH_F64=1 benches the f64 state.  Needs a GPU:
it exits non-zero elsewhere.

Diagnostics go to stderr; stdout is ONE json line.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    import lightweaver_tpu  # noqa: F401  (enables x64)
    from lightweaver_tpu.benchmark import (falc_ctx, race_iterations,
                                           require_gpu)
    from lightweaver_tpu.compile_cache import setup_compile_cache
    from lightweaver_tpu.context import RECURRENCE_MODES

    dev = require_gpu()
    setup_compile_cache()
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True).stdout.splitlines()[0]
    dtype = None if os.environ.get('BENCH_F64') else jnp.float32

    nIter = 50
    ctxs = {mode: falc_ctx(dtype=dtype, recurrenceMode=mode)
            for mode in RECURRENCE_MODES}
    raced = race_iterations(ctxs, nIter=nIter)
    for mode, wall in raced.items():
        print(f'# {mode}: {wall * 1e3:.3f} ms/iter', file=sys.stderr)
    winner = min(raced, key=raced.get)
    ctx = ctxs[winner]
    wallPerIter = raced[winner]
    msPerIter = wallPerIter * 1e3
    gridPointsPerSweep = ctx.cfg.Nlam * ctx.cfg.Nmu * 2 * ctx.cfg.Nk
    throughput = gridPointsPerSweep / wallPerIter

    base = json.loads((Path(__file__).parent
                       / 'bench_baseline.json').read_text())
    refMs = base['reference_ms_per_iter_4threads']

    print(json.dumps({
        'metric': 'mali_fs_gridpoint_updates_per_sec',
        'value': throughput,
        'unit': 'gridpoints/s',
        'vs_baseline': refMs / msPerIter,
        'baseline': 'compiled reference C++ core, 4 CPU threads, '
                    f'{refMs} ms/iter (bench_baseline.json)',
        'ms_per_iter': msPerIter,
        'ms_per_iter_by_mode': {k: v * 1e3 for k, v in raced.items()},
        'device': {'platform': dev.platform, 'kind': dev.device_kind,
                   'count': len(jax.devices()), 'card': card},
        'config': 'FALC-500, H6+CaII, 5 rays, Nlam=%d, %d iters, '
                  'state=%s accum=%s recurrence=%s (raced winner)'
                  % (ctx.cfg.Nlam, nIter, np.dtype(ctx.dtype).name,
                     np.dtype(ctx.accumDtype).name, winner),
        'wall_s_per_iter': wallPerIter,
    }))


if __name__ == '__main__':
    main()
