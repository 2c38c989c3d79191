"""Worker program for the TRUE 2-process multihost test.

Spawned by tests/test_multihost.py as
``python multihost_worker.py <process_id> <num_processes> <port>`` with
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` so each process
contributes 4 virtual CPU devices to an 8-device global mesh.

It exercises the documented multihost pipeline
(lightweaver_tpu/parallel/multihost.py module docstring): initialise
jax.distributed, build the global ('columns','wavelength') mesh, feed
THIS process's block of columns (``local_column_slice``) into globally
sharded params via ``make_array_from_process_local_data``, run the
jitted vmapped MALI iteration + statistical equilibrium, and check the
locally addressable shards of the result against an unsharded
single-controller run of the identical schedule.

The reference's multi-node story is "run MPI yourself on top"
(ref: /root/reference/docs/index.rst:36-38); this validates ours.
"""
import sys
from functools import partial
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]

import numpy as np

import jax

jax.config.update('jax_enable_x64', True)
try:
    # cross-process CPU collectives (default on new jaxlibs; set explicitly)
    jax.config.update('jax_cpu_collectives_implementation', 'gloo')
except Exception:
    pass

from lightweaver_tpu.parallel import multihost as mh

mh.initialize_multihost(coordinator_address=f'127.0.0.1:{port}',
                        num_processes=nproc, process_id=pid)
assert jax.process_count() == nproc, jax.process_count()
assert jax.process_index() == pid
assert len(jax.local_devices()) == 4
assert len(jax.devices()) == 4 * nproc

from jax.sharding import NamedSharding, PartitionSpec as P

from lightweaver_tpu.context import _stat_eq_solve, build_iteration_fn
from lightweaver_tpu.fal import Falc82
from lightweaver_tpu.parallel.columns import ColumnBatch

mesh = mh.global_mesh()                       # all devices on 'columns'
CG = mesh.shape['columns']
sl = mh.local_column_slice(CG)
assert sl == slice(pid * CG // nproc, (pid + 1) * CG // nproc)

# Deterministic global column set: FAL-C x 16 depths with per-column
# temperature perturbations (identical construction on every process).
full = Falc82()
idx = np.unique(np.linspace(0, 81, 16).astype(int))
Nk = len(idx)
rng = np.random.default_rng(0)
scale = 1.0 + 0.05 * rng.standard_normal((CG, 1))
TG = full.temperature[idx][None, :] * scale
rep = lambda a, C: np.broadcast_to(a[idx], (C, Nk))


def make_batch(T):
    C = T.shape[0]
    from lightweaver_tpu.rh_atoms import CaII_atom, H_6_atom
    return ColumnBatch.from_stacked(
        full.height[idx], T, rep(full.vlos, C), rep(full.vturb, C),
        rep(full.ne, C), rep(full.nHTot, C),
        lambda: [H_6_atom(), CaII_atom()], ('Ca',), Nrays=2)


# THIS process's column block -> globally sharded params
local = make_batch(TG[sl].copy())
spec = P('columns')


def to_global(x):
    if x is None:
        return None
    loc = np.asarray(x)
    gshape = (CG,) + loc.shape[1:]
    return jax.make_array_from_process_local_data(
        NamedSharding(mesh, spec), loc, gshape)


gparams = jax.tree.map(to_global, local.params,
                       is_leaf=lambda x: x is None)
nTotalG = [to_global(
    np.asarray(local.flatCtx.eqPops.atomicPops[a.model.element].nTotal,
               np.float64).reshape(-1, Nk))
    for a in local.cfg.activeAtoms]

it_fn = jax.jit(jax.vmap(partial(build_iteration_fn(local.cfg),
                                 lambdaIterate=False)))
stat_fn = jax.jit(jax.vmap(_stat_eq_solve))
gmax = jax.jit(jax.numpy.max)


def run(params, nTotal, fs, stat):
    dj = None
    for i in range(4):
        out = fs(params)
        params['J'] = out['J']
        if i >= 1:
            for ai in range(len(nTotal)):
                params['pops'][ai] = stat(out['Gamma'][ai],
                                          params['pops'][ai], nTotal[ai])
    return params, out


gparams, gout = run(gparams, nTotalG, it_fn, stat_fn)
# one genuine cross-process reduction: global max dJ over all columns
dJglobal = float(gmax(gout['dJ']))
assert np.isfinite(dJglobal)

# Unsharded reference: same schedule, full column set, local devices only
ref = make_batch(TG.copy())
refNTotal = [np.asarray(
    ref.flatCtx.eqPops.atomicPops[a.model.element].nTotal,
    np.float64).reshape(CG, Nk) for a in ref.cfg.activeAtoms]
rparams, rout = run(ref.params,
                    [jax.numpy.asarray(n) for n in refNTotal],
                    it_fn, stat_fn)

maxErr = 0.0
for ai in range(len(nTotalG)):
    g = gparams['pops'][ai]
    shards = sorted(g.addressable_shards,
                    key=lambda s: s.index[0].start or 0)
    locPops = np.concatenate([np.asarray(s.data) for s in shards], axis=0)
    refPops = np.asarray(rparams['pops'][ai])[sl]
    err = float(np.abs(locPops / refPops - 1.0).max())
    maxErr = max(maxErr, err)
assert maxErr < 1e-10, f'sharded != unsharded pops ({maxErr:.3e})'

print(f'MULTIHOST OK p{pid}/{nproc} devices={len(jax.devices())} '
      f'cols={sl.start}:{sl.stop} err={maxErr:.3e} dJ={dJglobal:.6e}',
      flush=True)
