"""Ng (1974) acceleration of fixed-point iterates.

Matches the reference's ring-buffer formulation with 1/|sol| weights
(ref: /root/reference/Source/Ng.hpp:16-163).  The small Norder x Norder
least-squares system is solved on host (numpy) since it is tiny; the
iterates themselves can live on device.
"""
from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class NgOptions:
    Norder: int = 0
    Nperiod: int = 0
    Ndelay: int = 0


class Ng:
    """Ng accelerator over flattened population vectors."""

    def __init__(self, Norder: int = 0, Nperiod: int = 0, Ndelay: int = 0,
                 sol: Optional[np.ndarray] = None):
        self.Norder = Norder
        self.Nperiod = max(Nperiod, 1)
        self.Ndelay = max(Ndelay, Nperiod + 2)
        self.count = 0
        self.init = False
        self.previous = None
        if sol is not None:
            sol = np.asarray(sol).ravel()
            self.len = sol.shape[0]
            self.previous = np.zeros((Norder + 2, self.len))
            self.previous[0] = sol
            self.count = 1
            self.init = True

    def _idx(self, cnt):
        return cnt % (self.Norder + 2)

    def accelerate(self, sol: np.ndarray, trustFactor: float = 0.0):
        """Store sol; every Nperiod steps after Ndelay, extrapolate it in
        place.  Returns (accelerated: bool, sol).

        trustFactor > 1 clips the extrapolated iterate elementwise to
        [sol/f, sol*f] around the raw iterate (used for positive
        quantities like PRD rho whose far wings make the unweighted
        extrapolation wild); the clipped value is what enters the
        history so subsequent extrapolations stay consistent."""
        sol = np.asarray(sol).ravel().copy()
        if not self.init:
            self.len = sol.shape[0]
            self.previous = np.zeros((max(self.Norder + 2, 2), self.len))
            self.init = True

        self.previous[self._idx(self.count)] = sol
        self.count += 1

        if not (self.Norder > 0 and self.count >= self.Ndelay
                and (self.count - self.Ndelay) % self.Nperiod == 0):
            return False, sol

        No = self.Norder
        Delta = np.empty((No + 1, self.len))
        for i in range(No + 1):
            ip = self._idx(self.count - i - 1)
            ipp = self._idx(self.count - i - 2)
            Delta[i] = self.previous[ip] - self.previous[ipp]
        weight = 1.0 / np.abs(sol)

        A = np.empty((No, No))
        b = np.empty(No)
        d0 = Delta[0]
        for j in range(No):
            b[j] = np.sum(weight * d0 * (d0 - Delta[j + 1]))
            for i in range(No):
                A[i, j] = np.sum(weight * (Delta[j + 1] - d0)
                                 * (Delta[i + 1] - d0))
        try:
            coeffs = np.linalg.solve(A, b)
        except np.linalg.LinAlgError:
            return False, sol

        i0 = self._idx(self.count - 1)
        raw = sol.copy()
        for i in range(No):
            ip = self._idx(self.count - i - 2)
            sol += coeffs[i] * (self.previous[ip] - self.previous[i0])
        if trustFactor > 1.0:
            lo = np.minimum(raw / trustFactor, raw * trustFactor)
            hi = np.maximum(raw / trustFactor, raw * trustFactor)
            sol = np.clip(sol, lo, hi)
        self.previous[i0] = sol
        return True, sol

    def max_change(self):
        if not self.init or self.count < 2:
            return 0.0
        old = self.previous[self._idx(self.count - 2)]
        cur = self.previous[self._idx(self.count - 1)]
        mask = cur != 0.0
        if not mask.any():
            return 0.0
        return float(np.max(np.abs((cur[mask] - old[mask]) / cur[mask])))

    def clear(self):
        if self.previous is not None:
            self.previous.fill(0.0)
        self.count = 0


def device_ng_init(sol, Norder: int):
    """Ring-buffer Ng state living on device: (hist [R, L], count),
    matching ``Ng(Norder, ..., sol=sol)`` (previous[0] = sol, count = 1).
    For use inside jitted loops (lax.while_loop) -- see
    Context.iterate_on_device."""
    import jax.numpy as jnp
    R = max(Norder + 2, 2)
    flat = jnp.ravel(sol)
    hist = jnp.zeros((R, flat.shape[0]), flat.dtype).at[0].set(flat)
    return hist, jnp.asarray(1, jnp.int32)


def device_ng_accelerate(hist, count, sol, Norder: int, Nperiod: int,
                         Ndelay: int):
    """Traceable equivalent of :meth:`Ng.accelerate`: store sol [L] into
    the ring buffer; every Nperiod steps after Ndelay solve the weighted
    Norder x Norder least-squares extrapolation.  Returns
    (hist, count, solOut, dMax) where dMax is the max relative change
    between the last two stored iterates (:meth:`Ng.max_change`).

    Norder/Nperiod/Ndelay are static Python ints.  A non-finite LS solve
    falls back to the unaccelerated iterate, like the host class."""
    import jax
    import jax.numpy as jnp

    from .linalg import solve_KxK_over_depth

    Nperiod = max(Nperiod, 1)
    Ndelay = max(Ndelay, Nperiod + 2)
    R = hist.shape[0]
    No = Norder

    hist = hist.at[count % R].set(sol)
    count = count + 1

    if No > 0:
        # prev[i] = previous[(count - 1 - i) % R], i = 0..No+1
        idxs = (count - 1 - jnp.arange(No + 2)) % R
        prev = jnp.take(hist, idxs, axis=0)             # [No+2, L]
        Delta = prev[:-1] - prev[1:]                    # [No+1, L]
        weight = 1.0 / jnp.abs(sol)                     # [L]
        d0 = Delta[0]
        diff = Delta[1:] - d0[None, :]                  # [No, L]
        b = jnp.sum(weight * d0 * (-diff), axis=1)      # [No]
        A = jnp.einsum('l,il,jl->ij', weight, diff, diff,
                       precision=jax.lax.Precision.HIGHEST)
        coeffs = solve_KxK_over_depth(A[:, :, None], b[:, None])[:, 0]
        accel = sol + jnp.sum(
            coeffs[:, None] * (prev[1:No + 1] - prev[0][None, :]), axis=0)
        ok = jnp.all(jnp.isfinite(accel))
        doA = jnp.logical_and(
            count >= Ndelay, (count - Ndelay) % Nperiod == 0)
        solOut = jnp.where(jnp.logical_and(doA, ok), accel, sol)
        hist = hist.at[(count - 1) % R].set(solOut)
    else:
        solOut = sol

    old = jnp.take(hist, (count - 2) % R, axis=0)
    cur = jnp.take(hist, (count - 1) % R, axis=0)
    dMax = jnp.max(jnp.abs(jnp.where(cur != 0.0, (cur - old)
                                     / jnp.where(cur != 0.0, cur, 1.0),
                                     0.0)))
    return hist, count, solOut, dMax


class BatchedNg:
    """Per-column Ng acceleration over a batch of independent problems.

    Same ring-buffer formulation as :class:`Ng` but vectorised over a
    leading batch axis: iterates are [C, L], the Norder x Norder
    least-squares systems are solved per column with one stacked
    np.linalg.solve, and max_change is reported per column.
    Columns flagged in ``freeze`` keep their previous iterate (used by
    the 1.5D driver to pin converged columns while the chunk finishes).
    """

    def __init__(self, Norder: int = 0, Nperiod: int = 0, Ndelay: int = 0,
                 sol: Optional[np.ndarray] = None):
        self.Norder = Norder
        self.Nperiod = max(Nperiod, 1)
        self.Ndelay = max(Ndelay, Nperiod + 2)
        self.count = 0
        self.previous = None
        if sol is not None:
            sol = np.asarray(sol)
            sol = sol.reshape(sol.shape[0], -1)
            self.C, self.len = sol.shape
            self.previous = np.zeros((max(self.Norder + 2, 2),
                                      self.C, self.len))
            self.previous[0] = sol
            self.count = 1

    def _idx(self, cnt):
        return cnt % max(self.Norder + 2, 2)

    def accelerate(self, sol: np.ndarray, freeze: Optional[np.ndarray] = None):
        """Store sol [C, ...]; extrapolate per column every Nperiod steps
        after Ndelay.  Returns (accelerated: bool, sol [C, L])."""
        sol = np.asarray(sol)
        sol = sol.reshape(sol.shape[0], -1).copy()
        if self.previous is None:
            self.C, self.len = sol.shape
            self.previous = np.zeros((max(self.Norder + 2, 2),
                                      self.C, self.len))
        if freeze is not None and self.count > 0:
            prev = self.previous[self._idx(self.count - 1)]
            sol[freeze] = prev[freeze]

        self.previous[self._idx(self.count)] = sol
        self.count += 1

        if not (self.Norder > 0 and self.count >= self.Ndelay
                and (self.count - self.Ndelay) % self.Nperiod == 0):
            return False, sol

        No = self.Norder
        Delta = np.empty((No + 1, self.C, self.len))
        for i in range(No + 1):
            ip = self._idx(self.count - i - 1)
            ipp = self._idx(self.count - i - 2)
            Delta[i] = self.previous[ip] - self.previous[ipp]
        weight = 1.0 / np.abs(sol)                      # [C, L]

        A = np.empty((self.C, No, No))
        b = np.empty((self.C, No))
        d0 = Delta[0]
        for j in range(No):
            b[:, j] = np.sum(weight * d0 * (d0 - Delta[j + 1]), axis=1)
            for i in range(No):
                A[:, i, j] = np.sum(weight * (Delta[j + 1] - d0)
                                    * (Delta[i + 1] - d0), axis=1)
        try:
            coeffs = np.linalg.solve(A, b[..., None])[..., 0]   # [C, No]
        except np.linalg.LinAlgError:
            return False, sol

        i0 = self._idx(self.count - 1)
        for i in range(No):
            ip = self._idx(self.count - i - 2)
            sol += coeffs[:, i:i + 1] * (self.previous[ip]
                                         - self.previous[i0])
        if freeze is not None:
            prev = self.previous[i0]
            sol[freeze] = prev[freeze]
        self.previous[i0] = sol
        return True, sol

    def max_change(self):
        """Per-column max relative change [C]."""
        if self.previous is None or self.count < 2:
            return np.zeros(getattr(self, 'C', 0))
        old = self.previous[self._idx(self.count - 2)]
        cur = self.previous[self._idx(self.count - 1)]
        rel = np.abs(np.where(cur != 0.0, (cur - old) / np.where(
            cur != 0.0, cur, 1.0), 0.0))
        return rel.max(axis=1)
