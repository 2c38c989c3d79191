"""Newton-Raphson charge conservation: coupled (populations, ne) update.

Accelerator-native re-design of the reference's split Python/C++ implementation
(ref: /root/reference/lightweaver/nr_update.py:7-106,
 /root/reference/Source/UpdatePopulations.cpp:230-394): the per-depth
(sum(Nlevel)+1)^2 Jacobian is assembled as one dense batched tensor over
depth and solved with the unrolled batched Gaussian elimination, instead
of a per-point LU inside a thread pool.

The Jacobian rows are: per-level kinetic equations (Gamma blocks, with
the last level of each atom replaced by particle conservation), and a
final charge-conservation row ne - sum(stages * n) - backgroundNe.  The
ne column carries the preconditioned continuum photoionisation derivative
(Gamma_ij - crsw*C_ij)/ne * n_j plus the finite-difference dC/dne terms
supplied by the Python driver (1e-4 relative ne perturbation).
"""
from functools import partial
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .ops.linalg import batched_solve


def build_nr_fn(Nlevels: Sequence[int], stagesList: Sequence[np.ndarray],
                contPairs: Sequence[Sequence[Tuple[int, int]]],
                timeDep: bool, dtype, stepLimit: bool = True):
    """Build the jitted batched NR step for a static atom structure.

    Nlevels: per-atom level counts; stagesList: per-atom ionisation stages
    [Nl]; contPairs: per-atom list of continuum (i, j) level pairs.
    stepLimit: apply the positivity-preserving step scaling (our
    improvement over the reference's raw Newton step, which can drive
    populations negative on hard starts; set False for bitwise parity
    with nr_post_update_impl, UpdatePopulations.cpp:292-395).
    Returns fn(Gammas, ns, nTotals, Cs, dCs, ne, backgroundNe, crsw
               [, dt, nPrevs]) -> (newNs, newNe).
    """
    Natom = len(Nlevels)
    Neqn = sum(Nlevels) + 1
    theta = 1.0

    def fn(Gammas, ns, nTotals, Cs, dCs, ne, backgroundNe, crsw,
           dt=None, nPrevs=None):
        Nk = ne.shape[0]
        F = jnp.zeros((Nk, Neqn), dtype)
        dF = jnp.zeros((Nk, Neqn, Neqn), dtype)
        eleContrib = jnp.zeros(Nk, dtype)

        offset = 0
        for a in range(Natom):
            Nl = Nlevels[a]
            stages = jnp.asarray(stagesList[a], dtype)
            G = Gammas[a]                                   # [Nl, Nl, Nk]
            n = ns[a]                                       # [Nl, Nk]
            Gn = jnp.einsum('ijk,jk->ik', G, n)             # [Nl, Nk]
            if timeDep:
                Fa = theta * dt * Gn - (n - nPrevs[a])
            else:
                Fa = -Gn
            Fa = Fa.at[Nl - 1].set(jnp.sum(n, axis=0) - nTotals[a])
            F = F.at[:, offset:offset + Nl].set(Fa.T)
            eleContrib = eleContrib + jnp.einsum(
                'l,lk->k', stages, n, precision=jax.lax.Precision.HIGHEST)

            # Jacobian block [Nk, Nl, Nl]
            blk = -jnp.moveaxis(G, -1, 0)
            if timeDep:
                blk = -theta * dt * blk
                blk = blk - jnp.eye(Nl, dtype=dtype)[None]

            # ne column: continuum Rji/ne precondition + FD dC/dne
            neCol = jnp.zeros((Nl, Nk), dtype)
            for (i, j) in contPairs[a]:
                precon = G[i, j] - crsw * Cs[a][i, j]
                entry = -(precon / ne) * n[j]
                if timeDep:
                    entry = -theta * dt * entry
                neCol = neCol.at[i].add(entry)
            if dCs is not None:
                entry = -jnp.einsum('ilk,lk->ik', dCs[a], n,
                                    precision=jax.lax.Precision.HIGHEST)
                if timeDep:
                    entry = -theta * dt * entry
                neCol = neCol + entry

            # particle-conservation row for this atom: 1s, no ne coupling
            blk = blk.at[:, Nl - 1, :].set(1.0)
            neCol = neCol.at[Nl - 1].set(0.0)

            dF = dF.at[:, offset:offset + Nl, offset:offset + Nl].set(blk)
            dF = dF.at[:, offset:offset + Nl, Neqn - 1].set(neCol.T)
            dF = dF.at[:, Neqn - 1, offset:offset + Nl].set(-stages[None, :])
            offset += Nl

        F = F.at[:, Neqn - 1].set(ne - eleContrib - backgroundNe)
        dF = dF.at[:, Neqn - 1, Neqn - 1].set(1.0)

        delta = batched_solve(dF, -F)                       # [Nk, Neqn]

        if stepLimit:
            # positivity-preserving step limiting: scale the whole Newton
            # step per depth point so no population (or ne) is driven
            # below 10% of its current value.  Full steps are taken near
            # the solution (s -> 1); far from it this prevents the
            # catastrophic overshoots a raw Newton produces on hard
            # starts.
            x = jnp.concatenate([jnp.moveaxis(n, -1, 0) for n in ns]
                                + [ne[:, None]], axis=1)    # [Nk, Neqn]
            shrinkRatio = jnp.where(delta < 0.0,
                                    -x / jnp.where(delta < 0.0, delta,
                                                   -1.0),
                                    jnp.inf)
            growthRatio = jnp.where(delta > 0.0,
                                    9.0 * x / jnp.where(delta > 0.0,
                                                        delta, 1.0),
                                    jnp.inf)
            s = jnp.minimum(1.0, jnp.minimum(
                0.9 * jnp.min(shrinkRatio, axis=1),
                jnp.min(growthRatio, axis=1)))
            delta = delta * s[:, None]

        newNs = []
        offset = 0
        for a in range(Natom):
            Nl = Nlevels[a]
            newNs.append(ns[a] + delta[:, offset:offset + Nl].T)
            offset += Nl
        newNe = ne + delta[:, Neqn - 1]
        return newNs, newNe

    return jax.jit(fn)
