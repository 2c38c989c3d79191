"""Multi-host orchestration: jax.distributed initialisation and global
meshes spanning several hosts.

The reference is single-node shared memory; its only multi-node story is
"run MPI yourself on top" (ref: /root/reference/docs/index.rst:36-38).
Here multi-host runs are first-class: every host launches the same
program, calls :func:`initialize_multihost`, builds a global mesh over
all devices of all processes, and feeds its local shard of columns into
:class:`~lightweaver_tpu.parallel.columns.ColumnBatch` -- GSPMD inserts
any needed collectives (there are none on the columns axis; wavelength
splits reduce J/Gamma over the interconnect).

Typical 1.5D pipeline on N hosts:

    from lightweaver_tpu.parallel import multihost as mh
    mh.initialize_multihost('host0:1234', N, rank)
    mesh = mh.global_mesh(nWavelength=1)   # all devices on 'columns'
    batch = ColumnBatch.from_stacked(..., mesh=mesh)
    batch.iterate()

Pass coordinator_address/num_processes/process_id explicitly unless the
cluster environment lets `jax.distributed.initialize()` discover them.
"""
from typing import Optional

import numpy as np

import jax
from jax.sharding import Mesh


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         **kwargs) -> None:
    """Initialise the jax.distributed runtime (idempotent).

    With no arguments, relies on jax.distributed's environment
    autodetection (cluster schedulers that it knows).  A single-process
    call (num_processes=1) is valid and turns the whole module into a
    no-op pipeline, so driver scripts run unchanged on one host.
    """
    if num_processes == 1:
        return      # single process: nothing to coordinate
    # NOTE: do not touch jax.process_count()/jax.devices() here -- that
    # would initialise the backends, after which distributed.initialize
    # is no longer allowed.  Probe the distributed client state directly.
    from jax._src import distributed as _dist
    if getattr(_dist.global_state, 'client', None) is not None:
        return      # already initialised by the runtime
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes, process_id=process_id, **kwargs)
    except RuntimeError as e:
        if 'already initialized' in str(e).lower():
            return
        raise


def global_mesh(nColumns: Optional[int] = None, nWavelength: int = 1) \
        -> Mesh:
    """A ('columns', 'wavelength') mesh over ALL devices in the slice
    (local + remote).  nColumns defaults to using every device not
    consumed by the wavelength axis."""
    devs = np.asarray(jax.devices())
    n = devs.size
    if n % nWavelength != 0:
        raise ValueError(f'{n} devices not divisible by '
                         f'nWavelength={nWavelength}')
    if nColumns is None:
        nColumns = n // nWavelength
    if nColumns * nWavelength != n:
        raise ValueError(f'mesh {nColumns}x{nWavelength} != {n} devices')
    return Mesh(devs.reshape(nColumns, nWavelength),
                axis_names=('columns', 'wavelength'))


def local_column_slice(nColumnsGlobal: int) -> slice:
    """The half-open [start, stop) range of global column indices this
    host should construct and feed to ColumnBatch.from_stacked.  Columns
    are block-distributed over processes in process_id order (matching a
    mesh whose 'columns' axis enumerates devices process-major)."""
    p = jax.process_index()
    np_ = jax.process_count()
    per = -(-nColumnsGlobal // np_)          # ceil
    return slice(p * per, min((p + 1) * per, nColumnsGlobal))


def make_global_array(localArrays, mesh: Mesh, spec) -> jax.Array:
    """Assemble a jax.Array distributed over the mesh from each host's
    local shards (jax.make_array_from_process_local_data).  localArrays
    is this process's block of the global array along the sharded axis."""
    from jax.sharding import NamedSharding
    sharding = NamedSharding(mesh, spec)
    return jax.make_array_from_process_local_data(
        sharding, np.asarray(localArrays))
