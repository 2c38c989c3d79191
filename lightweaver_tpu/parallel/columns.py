"""Scale-out over independent atmospheric columns (1.5D synthesis) and
wavelength, via jax.sharding over a device mesh.

The reference delegates multi-column work to user-level MPI/ProcessPool
(ref: /root/reference/docs/index.rst:36-38); here it is first-class:

- **Array-native construction** (:meth:`ColumnBatch.from_stacked`): the
  C stacked [C, Nk] atmosphere arrays are flattened into ONE C*Nk-point
  Atmosphere + Context, whose pointwise setup (background opacities,
  line profiles, collisional rates, LTE populations) vectorises over the
  entire batch in one numpy pass -- no per-column Context objects.  The
  params pytree is then reshaped [*, C*Nk] -> [C, *, Nk] for the
  batched device program.
- **Batched device iteration**: the single-column MALI step is a pure
  function of a params pytree (context.build_iteration_fn), so the
  batch is vmap over the stacked pytree, sharded across the mesh
  'columns' axis, with the dense wavelength axis optionally sharded
  across 'wavelength' (XLA inserts the window-slice halo collectives
  automatically under GSPMD).
- **Host-side state updates run on the flat context**: statistical
  equilibrium, Newton-Raphson charge conservation, and LTE refreshes
  are pointwise in depth, so the flat C*Nk-point context performs them
  for every column at once; per-column Ng acceleration and
  per-column convergence masking are layered on top.
"""
from functools import partial
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import constants as Const
from ..context import Context, build_iteration_fn, _stat_eq_solve
from ..iteration_update import IterationUpdate
from ..ops.ng import BatchedNg, NgOptions


def make_mesh(nColumns: Optional[int] = None, nWavelength: int = 1,
              devices=None) -> Mesh:
    """Create a ('columns', 'wavelength') device mesh."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if nColumns is None:
        nColumns = n // nWavelength
    if nColumns * nWavelength != n:
        raise ValueError(f'{nColumns} x {nWavelength} != {n} devices')
    dev = np.asarray(devices).reshape(nColumns, nWavelength)
    return Mesh(dev, axis_names=('columns', 'wavelength'))


def _batch_leaf(x, C: int, Nk: int):
    """Reshape a flat-context leaf [..., C*Nk] to a batch leaf
    [C, ..., Nk]; replicate k-independent leaves over C."""
    if x is None:
        return None
    x = jnp.asarray(x)
    if x.ndim >= 1 and x.shape[-1] == C * Nk:
        y = x.reshape(x.shape[:-1] + (C, Nk))
        return jnp.moveaxis(y, -2, 0)
    return jnp.broadcast_to(x, (C,) + x.shape)


def _unbatch_leaf(x):
    """Inverse of :func:`_batch_leaf` for k-carrying leaves:
    [C, ..., Nk] -> [..., C*Nk]."""
    y = jnp.moveaxis(x, 0, -2)
    return y.reshape(y.shape[:-2] + (y.shape[-2] * y.shape[-1],))


class ColumnBatch:
    """A batch of independent 1D NLTE problems sharing the same models and
    wavelength grid, iterated in lockstep and sharded over a mesh.

    Construct from stacked atmosphere arrays (:meth:`from_stacked`,
    array-native; supports Ng acceleration, charge conservation and
    per-column convergence masking) or from a list of prebuilt Contexts
    (legacy; lockstep only).
    """

    def __init__(self, contexts: Optional[List[Context]] = None,
                 mesh: Optional[Mesh] = None, *,
                 flatCtx: Optional[Context] = None, Ncol: int = 0,
                 ngOptions: Optional[NgOptions] = None):
        self.mesh = mesh
        self.flatCtx = None
        if flatCtx is not None:
            self.flatCtx = flatCtx
            self.Ncol = Ncol
            self.NkCol = flatCtx.atmos.Nspace // Ncol
            import dataclasses
            self.cfg = dataclasses.replace(flatCtx.cfg, Nk=self.NkCol)
            self.params = self._batch_params(flatCtx.build_params())
            ngOptions = ngOptions or NgOptions(0, 0, 0)
            self.ngs = [BatchedNg(ngOptions.Norder, ngOptions.Nperiod,
                                  ngOptions.Ndelay,
                                  np.asarray(self.params['pops'][ai])
                                  .reshape(Ncol, -1))
                        for ai in range(len(self.cfg.activeAtoms))]
            self.converged = np.zeros(Ncol, bool)
            self.nIterCol = np.zeros(Ncol, np.int64)
        elif contexts:
            self.contexts = contexts
            self.cfg = contexts[0].cfg
            self.Ncol = len(contexts)
            paramsList = [c.build_params() for c in contexts]
            self.params = jax.tree.map(lambda *xs: jnp.stack(xs),
                                       *paramsList)
        else:
            raise ValueError('Need contexts or a flat context')
        if mesh is not None:
            self.params = self._shard(self.params)

        base = build_iteration_fn(self.cfg)
        self._iter_full = jax.jit(jax.vmap(partial(base,
                                                   lambdaIterate=False)))
        self._iter_lambda = jax.jit(jax.vmap(partial(base,
                                                     lambdaIterate=True)))
        self._stat_eq = jax.jit(jax.vmap(_stat_eq_solve))
        self._GammaOut = None
        self._Rij = None
        self._Rji = None
        self._prd_fs = None
        self.JRest = None

    # ------------------------------------------------------------------
    @classmethod
    def from_stacked(cls, height, temperature, vlos, vturb, ne, nHTot,
                     models, activeSpecies, Nrays: int = 5,
                     mesh: Optional[Mesh] = None,
                     ngOptions: Optional[NgOptions] = None,
                     conserveCharge: bool = False,
                     **ctxKwargs) -> 'ColumnBatch':
        """Array-native batch construction from stacked [C, Nk] arrays
        (height may be shared [Nk]).  ``models`` is a zero-arg factory
        returning the list of AtomicModels (fresh per call);
        ``activeSpecies`` the names to set active."""
        from ..atomic_set import RadiativeSet
        from ..atmosphere import Atmosphere

        temperature = np.asarray(temperature, np.float64)
        C, Nk = temperature.shape
        height = np.asarray(height, np.float64)
        if height.ndim == 1:
            height = np.broadcast_to(height[None, :], (C, Nk))
        flat = lambda a: np.asarray(a, np.float64).reshape(C * Nk).copy()

        atmos = Atmosphere(height=flat(height), temperature=flat(temperature),
                           vlos=flat(vlos), vturb=flat(vturb),
                           ne=flat(ne), nHTot=flat(nHTot))
        atmos.quadrature(Nrays)
        rs = RadiativeSet(models())
        rs.set_active(*activeSpecies)
        spect = rs.compute_wavelength_grid()
        eqPops = rs.compute_eq_pops(atmos)
        # Ng handled per-column by the batch, not by the flat context
        flatCtx = Context(atmos, spect, eqPops,
                          conserveCharge=conserveCharge, **ctxKwargs)
        return cls(mesh=mesh, flatCtx=flatCtx, Ncol=C, ngOptions=ngOptions)

    def _batch_params(self, p: Dict) -> Dict:
        C, Nk = self.Ncol, self.NkCol
        return jax.tree.map(lambda x: _batch_leaf(x, C, Nk), p,
                            is_leaf=lambda x: x is None)

    def _shard(self, tree):
        """Columns axis on dim 0 of every stacked leaf; wavelength axis on
        the dense [Nlam, Nk] leaves."""
        mesh = self.mesh
        lamSharded = {'J', 'bgChi', 'bgEta', 'bgSca'}
        flat, treedef = jax.tree_util.tree_flatten_with_path(tree)
        out = []
        for path, leaf in flat:
            keys = [getattr(p, 'key', getattr(p, 'idx', None)) for p in path]
            name = next((k for k in reversed(keys) if isinstance(k, str)), '')
            if hasattr(leaf, 'ndim') and leaf.ndim >= 3 and name in lamSharded:
                spec = P('columns', 'wavelength')
            else:
                spec = P('columns')
            out.append(jax.device_put(leaf, NamedSharding(mesh, spec)))
        return jax.tree_util.tree_unflatten(treedef, out)

    def _params_on_mesh(self) -> Dict:
        """The params with every leaf back on its mesh spec: the host-side
        updates (stat_equil, PRD, the iteration's own outputs) leave
        leaves on one device or in XLA's chosen layout, and a changed
        input sharding would compile the iteration again."""
        if self.mesh is not None:
            self.params = self._shard(self.params)
        return self.params

    # ------------------------------------------------------------------
    def formal_sol_gamma_matrices(self, lambdaIterate: bool = False) \
            -> IterationUpdate:
        fn = self._iter_lambda if lambdaIterate else self._iter_full
        out = fn(self._params_on_mesh())
        if self.flatCtx is not None and self.converged.any():
            # freeze converged columns' radiation field
            mask = jnp.asarray(self.converged)[:, None, None]
            self.params['J'] = jnp.where(mask, self.params['J'], out['J'])
            if 'JRest' in out:
                self.JRest = (out['JRest'] if self.JRest is None else
                              jnp.where(mask, self.JRest, out['JRest']))
        else:
            self.params['J'] = out['J']
            if 'JRest' in out:
                self.JRest = out['JRest']
        self._GammaOut = out['Gamma']
        self._Rij = out['Rij']
        self._Rji = out['Rji']
        self.I = out['I']
        self.dJCol = np.asarray(out['dJ'])                  # [C]
        if self.flatCtx is not None:
            dJ = float(np.max(np.where(self.converged, 0.0, self.dJCol)))
        else:
            dJ = float(self.dJCol.max())
        return IterationUpdate(self, updatedJ=True, dJMax=dJ)

    def stat_equil(self) -> IterationUpdate:
        if self.flatCtx is not None:
            return self._stat_equil_flat()
        dPops = []
        for ai, a in enumerate(self.cfg.activeAtoms):
            n = self.params['pops'][ai]
            nTotal = jnp.stack(
                [jnp.asarray(c.eqPops.atomicPops[a.model.element].nTotal,
                             self.cfg.dtype) for c in self.contexts])
            nNew = self._stat_eq(self._GammaOut[ai], n, nTotal)
            dPops.append(float(jnp.max(jnp.abs(1.0 - n / nNew))))
            self.params['pops'][ai] = nNew
        return IterationUpdate(self, updatedPops=True, dPops=dPops)

    def _stat_equil_flat(self) -> IterationUpdate:
        """Statistical equilibrium (+ optional NR charge conservation)
        via the flat context: every update is pointwise in depth, so one
        flat call covers all columns; per-column Ng and convergence
        freezing are applied on the batched view."""
        fc = self.flatCtx
        C = self.Ncol
        # push the batched Gamma/pops into the flat context
        fc._Gamma = [_unbatch_leaf(G) for G in self._GammaOut]
        for ai, st in enumerate(fc.popsState):
            st['n'] = _unbatch_leaf(self.params['pops'][ai])

        if fc.conserveCharge:
            neOld = np.asarray(fc.atmos.ne).copy()
            fc.stat_equil()
            if self.converged.any():
                # restore converged columns' ne and dependent state
                neNew = np.asarray(fc.atmos.ne).reshape(C, -1)
                neNew[self.converged] = neOld.reshape(C, -1)[self.converged]
                fc.atmos.ne[:] = neNew.reshape(-1)
                fc.eqPops.update_lte_atoms_Hmin_pops(fc.atmos,
                                                     conserveCharge=False)
                fc.compute_collisions(force=True)
        else:
            fc.stat_equil()

        dPops = []
        frozen = self.converged
        for ai, st in enumerate(fc.popsState):
            nNew = np.asarray(st['n']).reshape(
                st['n'].shape[0], C, self.NkCol)
            nNew = np.moveaxis(nNew, 1, 0).reshape(C, -1)   # [C, Nl*Nk]
            _, sol = self.ngs[ai].accelerate(nNew, freeze=frozen)
            dPops.append(self.ngs[ai].max_change())         # [C]
            solBat = sol.reshape(C, -1, self.NkCol)
            self.params['pops'][ai] = jnp.asarray(solBat, self.cfg.dtype)
            st['n'] = _unbatch_leaf(self.params['pops'][ai])

        # refresh batched views of state the flat update may have changed
        if fc.conserveCharge:
            fp = fc.build_params()
            for key in ('nStar', 'C'):
                self.params[key] = [
                    _batch_leaf(x, C, self.NkCol) for x in fp[key]]

        self.dPopsCol = np.max(np.stack(dPops, axis=0), axis=0)    # [C]
        dPopsMasked = np.where(frozen, 0.0, self.dPopsCol)
        return IterationUpdate(self, updatedPops=True,
                               dPops=[float(dPopsMasked.max())])

    @property
    def crswDone(self):
        return True

    # ------------------------------------------------------------------
    def prd_redistribute(self, maxIter: int = 3,
                         tol: float = 1e-2) -> IterationUpdate:
        """Batched PRD redistribution: the per-line scattering integral
        and the PRD-subset formal solution vmapped over columns (angle-
        averaged PRD; hPRD needs per-column comoving coefficients and
        stays a single-Context feature).  Converged columns' rho is
        frozen like their J/populations.
        ref schedule: /root/reference/Source/PrdTemplates.hpp:176-351"""
        from ..context import build_prd_subset_fn
        from ..ops.prd import prd_scatter_rho

        fc = self.flatCtx
        if fc is None:
            raise ValueError('PRD needs from_stacked batches')
        prdLines = fc._prd_lines()
        if not prdLines:
            return IterationUpdate(self)
        if self._Rij is None:
            raise ValueError('Call formal_sol_gamma_matrices first')
        C, Nk = self.Ncol, self.NkCol

        if self._prd_fs is None:
            prdPairs = [(ai, ti) for ai, ti, a, t in prdLines]
            self._prdSubIdxs = fc._prd_subset_idxs()
            self._prd_fs = jax.jit(jax.vmap(build_prd_subset_fn(
                self.cfg, self._prdSubIdxs, prdPairs)))
            self._prd_scatter = jax.jit(jax.vmap(prd_scatter_rho))
            self._prdConst = []
            for ai, ti, a, t in prdLines:
                vBroad = a.model.vBroad(fc.atmos).reshape(C, Nk)
                qWave = ((t.wavelength[None, :, None] - t.lambda0)
                         * Const.CLight
                         / (t.lambda0 * vBroad[:, None, :]))
                self._prdConst.append({
                    'qWave': jnp.asarray(qWave, self.cfg.dtype),
                    'aDamp': jnp.asarray(
                        np.asarray(fc.aDamp[ai][ti]).reshape(C, Nk),
                        self.cfg.dtype),
                    'Qelast': jnp.asarray(
                        np.asarray(fc.Qelast[ai][ti]).reshape(C, Nk),
                        self.cfg.dtype)})

        frozen = jnp.asarray(self.converged)
        subJ = jnp.asarray(self._prdSubIdxs)
        dRhoCol = np.zeros(C)
        nSub = 0
        for _ in range(maxIter):
            nSub += 1
            dRho = jnp.zeros(C, self.cfg.dtype)
            for c, (ai, ti, a, t) in zip(self._prdConst, prdLines):
                PjQj = c['Qelast'] + jnp.sum(
                    self.params['C'][ai][:, :, t.j, :], axis=1)
                for t2i, t2 in enumerate(self.cfg.activeAtoms[ai].trans):
                    if t2.j == t.j:
                        PjQj = PjQj + self._Rji[ai][t2i]
                    if t2.i == t.j:
                        PjQj = PjQj + self._Rij[ai][t2i]
                n = self.params['pops'][ai]
                gammaPre = (n[:, t.i] / n[:, t.j] * t.Bij / PjQj)
                Jbar = self._Rij[ai][ti] / t.Bij
                if fc.cfg.hprd and self.JRest is not None:
                    # comoving-frame scattering source (ref: Prd.cpp:484-491)
                    prdWin = jnp.asarray(
                        fc.cfg.laToPrdLa[t.Nblue:t.Nred])
                    Jw = self.JRest[:, prdWin]
                else:
                    Jw = self.params['J'][:, t.Nblue:t.Nred]
                rNew = self._prd_scatter(
                    c['qWave'], c['aDamp'],
                    Jw.astype(self.cfg.dtype),
                    gammaPre.astype(self.cfg.dtype),
                    Jbar.astype(self.cfg.dtype))
                rOld = self.params['rhoPrd'][ai][ti]
                rNew = jnp.where(frozen[:, None, None], rOld, rNew)
                rel = jnp.abs(jnp.where(rNew != 0.0,
                                        (rNew - rOld) / rNew, 0.0))
                dRho = jnp.maximum(dRho, jnp.max(rel, axis=(1, 2)))
                self.params['rhoPrd'][ai][ti] = rNew

            out = self._prd_fs(self._params_on_mesh())
            mask = frozen[:, None, None]
            Jsub = self.params['J'][:, subJ]
            self.params['J'] = self.params['J'].at[:, subJ].set(
                jnp.where(mask, Jsub, out['J'].astype(Jsub.dtype)))
            if 'JRest' in out and self.JRest is not None:
                self.JRest = jnp.where(mask, self.JRest, out['JRest'])
            Isub = self.I[:, subJ]
            self.I = self.I.at[:, subJ].set(
                jnp.where(mask, Isub, out['I'].astype(Isub.dtype)))
            self._Rij = [list(r) for r in self._Rij]
            self._Rji = [list(r) for r in self._Rji]
            for li, (ai, ti, a, t) in enumerate(prdLines):
                self._Rij[ai][ti] = jnp.where(
                    frozen[:, None], self._Rij[ai][ti], out['Rij'][li])
                self._Rji[ai][ti] = jnp.where(
                    frozen[:, None], self._Rji[ai][ti], out['Rji'][li])
            dRhoCol = np.asarray(dRho)
            if np.max(np.where(self.converged, 0.0, dRhoCol)) < tol:
                break

        # keep the flat context's rho in sync (it backs state access and
        # any flat-level reuse of the batch's converged state)
        for ai, ti, a, t in prdLines:
            fc.rhoPrd[ai][ti] = _unbatch_leaf(
                self.params['rhoPrd'][ai][ti])

        self.dRhoCol = dRhoCol
        upd = IterationUpdate(self, updatedRho=True,
                              dRho=[float(np.max(np.where(
                                  self.converged, 0.0, dRhoCol)))],
                              NprdSubIter=nSub)
        upd.updatedJ = True
        return upd

    def iterate(self, Nscatter: int = 3, NmaxIter: int = 500,
                JTol: float = 5e-3, popsTol: float = 1e-3,
                quiet: bool = True, prd: bool = False,
                maxPrdSubIter: int = 3, prdTol: float = 1e-2) -> int:
        """Iterate the batch until every column converges; converged
        columns are frozen (per-column masking) while the rest finish.
        Returns the iteration count of the slowest column; per-column
        counts in ``nIterCol``."""
        for it in range(NmaxIter):
            ju = self.formal_sol_gamma_matrices()
            if it < Nscatter:
                continue
            pu = self.stat_equil()
            if prd:
                self.prd_redistribute(maxIter=maxPrdSubIter, tol=prdTol)
            if self.flatCtx is not None:
                newConv = ((self.dJCol < JTol) & (self.dPopsCol < popsTol)
                           & ~self.converged)
                self.nIterCol[newConv] = it + 1
                self.converged |= newConv
                if not quiet:
                    print(f'-- it {it}: dJ={ju.dJMax:.2e} '
                          f'dPops={pu.dPopsMax:.2e} '
                          f'converged {int(self.converged.sum())}/{self.Ncol}')
                if self.converged.all():
                    return it + 1
            else:
                if not quiet:
                    print(f'-- it {it}: dJ={ju.dJMax:.2e} '
                          f'dPops={pu.dPopsMax:.2e}')
                if ju.dJMax < JTol and pu.dPopsMax < popsTol:
                    return it + 1
        return NmaxIter

    # ------------------------------------------------------------------
    @property
    def pops(self) -> List[np.ndarray]:
        """Per active atom: populations [C, Nlevel, Nk]."""
        return [np.asarray(p) for p in self.params['pops']]

    @property
    def ne(self) -> np.ndarray:
        """Electron density [C, Nk] (updated when conserveCharge)."""
        if self.flatCtx is None:
            raise ValueError('per-column ne needs from_stacked batches')
        return np.asarray(self.flatCtx.atmos.ne).reshape(self.Ncol, -1)
