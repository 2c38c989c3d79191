"""Batched dense linear solves for small static-size systems.

The population updates (statistical equilibrium, time-dependent, charge
conservation) solve an [Nlevel x Nlevel] system per depth point
(ref: /root/reference/Source/UpdatePopulations.cpp:7-47 uses a
partial-pivot LU per point, /root/reference/Source/LuSolve.cpp:1-132).

Nlevel is a small static Python int (6-9 for typical model atoms), so
partial-pivot Gaussian elimination is unrolled over the matrix
dimension: every step is an elementwise select/mul over the depth
batch, which XLA fuses, instead of one batched LAPACK-style custom
call per solve.  Whether `jnp.linalg.solve` is faster on the GPU is
not measured.
"""
from functools import partial

import jax
import jax.numpy as jnp


@partial(jax.jit, static_argnames=())
def batched_solve(A: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve A[k] x[k] = b[k] for a batch of small dense systems.

    A: [B, N, N], b: [B, N] -> x: [B, N].  N is static (from the shape);
    the elimination is unrolled N times, with partial pivoting done as a
    batched argmax + row swap via `where`.
    """
    B, N, _ = A.shape
    M = jnp.concatenate([A, b[..., None]], axis=-1)     # [B, N, N+1]

    for col in range(N):
        # partial pivot: strongest row at/below `col`
        mags = jnp.abs(M[:, :, col])                    # [B, N]
        rowIdx = jnp.arange(N)[None, :]
        mags = jnp.where(rowIdx >= col, mags, -jnp.inf)
        p = jnp.argmax(mags, axis=1)                    # [B]

        # swap rows col <-> p (batched)
        rowCol = M[:, col, :]                           # [B, N+1]
        rowP = jnp.take_along_axis(
            M, p[:, None, None].repeat(M.shape[-1], -1), axis=1)[:, 0, :]
        M = M.at[:, col, :].set(rowP)
        isP = (rowIdx == p[:, None])[..., None]         # [B, N, 1]
        M = jnp.where(isP, rowCol[:, None, :], M)

        # eliminate below
        piv = M[:, col, col][:, None]                   # [B, 1]
        factors = M[:, :, col] / piv                    # [B, N]
        below = (rowIdx > col)[..., None]
        M = jnp.where(below, M - factors[..., None] * M[:, col, :][:, None, :],
                      M)

    # back substitution (unrolled)
    x = jnp.zeros((B, N), M.dtype)
    for row in range(N - 1, -1, -1):
        acc = M[:, row, N]
        if row + 1 < N:
            acc = acc - jnp.einsum('bj,bj->b', M[:, row, row + 1:N],
                                   x[:, row + 1:N],
                                   precision=jax.lax.Precision.HIGHEST)
        x = x.at[:, row].set(acc / M[:, row, row])
    return x


def solve_KxK_over_depth(G: jnp.ndarray, rhs: jnp.ndarray) -> jnp.ndarray:
    """Solve G[:,:,k] x[:,k] = rhs[:,k] for each depth point k.
    G: [N, N, Nk], rhs: [N, Nk] -> [N, Nk]."""
    Gb = jnp.moveaxis(G, -1, 0)
    rb = jnp.moveaxis(rhs, -1, 0)
    return jnp.moveaxis(batched_solve(Gb, rb), 0, -1)
