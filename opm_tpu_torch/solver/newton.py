"""NonlinearSolver: the Newton driver.

Port of the JAX package's solver/newton.py. Per iteration the residual and
the convergence norms, then the Newton increment by one of two routes,
and the chopped update (K9's two entries: the convergence check and the
update, one launch each on the card):

* ``dense`` (the reference's route at most DENSE_LIMIT cells): the
  Jacobian by ``torch.func.jacfwd`` of the residual (through the K1 and
  K3 kernels' forward-mode rules) and an equilibrated float64 LU solve;
* ``cpr`` (above DENSE_LIMIT): block-sparse assembly, Schur elimination
  of the wells, BiCGStab (tol 1e-2, at most 50 iterations) preconditioned
  by CPR with a structured-GMG pressure stage on structured grids (fully
  active or embedded) and an aggregation-AMG one on gather grids, and the
  well recovery (the reference's ``_solve_cpr`` Schur branch with its CPU
  settings, all float64).

Oscillation relaxation, the initial well-equation solve and the
exceptions the timestepper catches follow the reference.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch.func import jacfwd

from opm_tpu_torch.models import linearize
from opm_tpu_torch.models.blackoil import BlackoilModel
from opm_tpu_torch.models.linearize import degenerate_x_mask
from opm_tpu_torch.models.state import BlackoilState
from opm_tpu_torch.solver.update import update_state
from opm_tpu_torch.wells import standard as stdwells


def dense_solve(J, r):
    """Dense LU solve with symmetric row/column equilibration, float64
    (D_r J D_c with D = 1/max|row or col| tames the mixed Pa/saturation/
    rate unit scales)."""
    dr = 1.0 / torch.clamp(torch.amax(torch.abs(J), dim=1), min=1e-300)
    Js = J * dr[:, None]
    dc = 1.0 / torch.clamp(torch.amax(torch.abs(Js), dim=0), min=1e-300)
    Js = Js * dc[None, :]
    du_s = torch.linalg.solve(Js, r * dr)
    return du_s * dc


def connection_offsets(model, state, wd):
    """Two-pass wellbore pressure profile cdp (nw, mp) from perf-local cell
    quantities: well-level mixture first, then the implied perforation
    rates; frozen for a substep."""
    cellq = model.well_cell_quantities_local(state, wd)
    cdp0 = stdwells.connection_pressure_offsets(wd, cellq, state.qs)
    cq = stdwells.perforation_fluxes(
        wd, cellq, state.bhp, state.qs, cdp0,
        allow_crossflow=model.params.allow_crossflow)
    return stdwells.connection_pressure_offsets(wd, cellq, state.qs,
                                                perf_rates=cq)


class NumericalIssue(Exception):
    """Non-finite or exploding residuals; caught by the timestepper to chop
    dt."""


class TooManyIterations(Exception):
    pass


class LinearSolverProblem(Exception):
    """The linear solver failed; caught by the dt-chop retry loop."""


@dataclass
class SolverReport:
    iterations: int = 0
    converged: bool = False
    assemble_time: float = 0.0
    linear_solve_time: float = 0.0
    linear_iterations: int = 0
    # per-Newton rows [mb_w mb_o mb_g cnv_w cnv_o cnv_g well_flux well_ctrl]
    convergence_history: object = None


class NonlinearSolver:
    """linear_solver: 'dense', 'cpr', or 'auto' (dense at most DENSE_LIMIT
    cells, CPR above)."""

    DENSE_LIMIT = 2000
    # BiCGStab's reduction target and iteration cap (the reference's
    # linear_solver_reduction and its default, ISTLSolver.hpp:250-274)
    LINEAR_TOL = 1e-2
    LINEAR_MAXITER = 50

    def __init__(self, model: BlackoilModel, linear_solver: str = "auto",
                 max_iter: Optional[int] = None, min_iter: int = 1,
                 relax_max: float = 0.5, relax_increment: float = 0.1,
                 relax_rel_tol: float = 0.2, schwarz=None):
        self.model = model
        if schwarz is not None:
            raise NotImplementedError(
                "SchwarzGmg (the shard-local GMG of a multi-device run) is "
                "not ported yet (ROADMAP Queue 1 item 13)")
        if linear_solver == "auto":
            linear_solver = ("dense" if model.nc <= self.DENSE_LIMIT
                             else "cpr")
        if linear_solver not in ("dense", "cpr"):
            raise ValueError(f"unknown linear_solver {linear_solver!r}")
        if linear_solver == "dense" and model.faces is not None:
            raise NotImplementedError(
                "the dense route on a grid with a face list (a gather grid, "
                "or an embedded grid with extra faces) needs a forward-mode "
                "rule for K3-faces (ROADMAP Queue 1 item 9)")
        self.linear_solver = linear_solver
        self.max_iter = max_iter or model.params.max_iter
        self.min_iter = min_iter
        self.relax_max = relax_max
        self.relax_increment = relax_increment
        self.relax_rel_tol = relax_rel_tol
        # host-clock sections of the CPR route (each ended by a device
        # synchronize) when set to a dict; None costs nothing
        self.timing = None
        self.amg = None
        if linear_solver == "cpr":
            grid = model.grid
            if model.op_dims is not None:
                from opm_tpu_torch.linalg.gmg import StructuredGmg

                if os.environ.get("OPM_TPU_GMG", "1") != "1":
                    raise NotImplementedError(
                        "OPM_TPU_GMG=0 (the aggregation AMG on a structured "
                        "grid) is not ported yet (ROADMAP Queue 1 item 9)")
                self.amg = StructuredGmg(model.op_dims,
                                         grid.trans[:grid.nf_canonical])
            else:
                from opm_tpu_torch.linalg.amg import build_hierarchy

                self.amg = build_hierarchy(
                    model.nc, grid.face_cells, grid.trans).device(
                        model.device)

    # ------------------------------------------------------------------
    def _cdp(self, state, wd):
        return connection_offsets(self.model, state, wd)

    def _assemble(self, state, acc0, dt, wd, cdp):
        res = self.model.residual(state, acc0, dt, wd, cdp)
        conv = self.model.convergence(res, dt, state)
        ctrl, tgt = stdwells.update_controls(
            wd, state.bhp, state.qs, state.control, state.target,
            cq_sum=state.qs - res.well_flux)
        return res, conv, ctrl, tgt

    def jacobian(self, state, acc0, dt, wd, cdp):
        """(J, r): the dense Jacobian of the flat residual by forward-mode
        AD through the kernels, and the residual itself."""
        model = self.model

        def rfun(u):
            s = model.unflatten(u, state)
            r = model.residual_vector(model.residual(s, acc0, dt, wd, cdp))
            return r, r

        return jacfwd(rfun, has_aux=True)(model.flatten(state))

    def _section(self, name, t0):
        """Close a timed section (synchronizing the device) and return the
        next section's start; a no-op unless ``timing`` is a dict."""
        if self.timing is None:
            return t0
        if self.model.device.type == "cuda":
            torch.cuda.synchronize(self.model.device)
        t1 = time.perf_counter()
        self.timing[name] = self.timing.get(name, 0.0) + (t1 - t0)
        return t1

    def _solve_cpr(self, state, acc0, dt, wd, cdp, omega):
        """Block assembly, Schur elimination of the wells, CPR-BiCGStab and
        the well recovery. Returns (state, linear iterations, converged)."""
        from opm_tpu_torch.linalg.krylov import bicgstab
        from opm_tpu_torch.linalg.precond import make_cpr_cells

        model = self.model
        dims = model.op_dims
        t0 = time.perf_counter()
        sys = linearize.assemble(model, state, acc0, dt, wd, cdp)
        t0 = self._section("assembly", t0)
        mv, rhs, recover = linearize.schur_eliminate_wells(sys, dims)
        M = make_cpr_cells(sys, self.amg, dims)
        t0 = self._section("cpr_setup", t0)
        res = bicgstab(mv, rhs, precond=M, tol=self.LINEAR_TOL,
                       maxiter=self.LINEAR_MAXITER)
        du_c = res.x
        du_w = recover(du_c)
        t0 = self._section("krylov", t0)
        new = update_state(model, state, du_c, omega, du_w=du_w)
        self._section("update", t0)
        return new, res.iterations, res.converged

    def _solve_dense(self, state, acc0, dt, wd, cdp, omega):
        model = self.model
        J, r = self.jacobian(state, acc0, dt, wd, cdp)
        # regularize the degenerate (gas-eq, rs-var) diagonal of
        # hydrocarbon-free cells; gas-equation rows are the third nc-block
        nc = model.nc
        idx = 2 * nc + torch.arange(nc, device=J.device)
        J[idx, idx] += degenerate_x_mask(model, state) * model.pv / dt
        return update_state(model, state, dense_solve(J, r), omega)

    # -- host loop ---------------------------------------------------------
    def step(self, state0: BlackoilState, dt: float, wd,
             report: Optional[SolverReport] = None):
        """One (sub)timestep: Newton to convergence. Returns (state,
        report); raises NumericalIssue / TooManyIterations for the dt-chop
        retry loop."""
        model = self.model
        rep = report or SolverReport()
        state = state0
        acc0 = model.accumulation(state0)
        dt = float(dt)
        cdp = self._cdp(state, wd)
        if model.params.solve_welleq_initially:
            state = self._solve_welleq(state, acc0, dt, wd, cdp)
        omega = 1.0
        mb_history = []
        if rep.convergence_history is None:
            rep.convergence_history = []
        for it in range(self.max_iter + 1):
            t0 = time.perf_counter()
            res, conv, ctrl, tgt = self._assemble(state, acc0, dt, wd, cdp)
            # one host pull per iteration: K9's history row with both flags
            row = conv["row"].cpu().numpy()
            finite, converged = bool(row[8]), bool(row[9])
            mb = row[:3]
            rep.convergence_history.append(row[:8])
            rep.assemble_time += time.perf_counter() - t0
            if not finite:
                raise NumericalIssue(
                    f"non-finite residual at iteration {it}: "
                    f"mb={row[:3]} cnv={row[3:6]}")
            if converged and it >= self.min_iter:
                rep.converged = True
                rep.iterations = it
                return state, rep
            if it == self.max_iter:
                break
            state = state._replace(control=ctrl, target=tgt)
            mb_history.append(mb)
            if self._oscillating(mb_history):
                omega = max(self.relax_max, omega - self.relax_increment)
            t0 = time.perf_counter()
            if self.linear_solver == "cpr":
                state, lin_iters, lin_ok = self._solve_cpr(
                    state, acc0, dt, wd, cdp, omega)
            else:
                state = self._solve_dense(state, acc0, dt, wd, cdp, omega)
                lin_iters, lin_ok = 1, True
            rep.linear_solve_time += time.perf_counter() - t0
            rep.linear_iterations += lin_iters
            rep.iterations = it + 1
            if not lin_ok:
                raise LinearSolverProblem(
                    f"linear solver stalled after {lin_iters} iterations "
                    f"at Newton {it}")
        raise TooManyIterations(
            f"Newton failed to converge in {self.max_iter} iterations "
            f"(mb={row[:3]}, cnv={row[3:6]})")

    def _solve_welleq(self, state, acc0, dt, wd, cdp):
        """Inner well-equation Newton with reservoir variables frozen (up to
        max_welleq_iter iterations on (q_s, bhp); the Jacobian over the
        4*nw well variables by jacfwd). Perf-local: cell quantities only
        at the perforated cells."""
        model = self.model
        nw = state.bhp.shape[0]
        if nw == 0:
            return state
        nw_, mp = wd["perf_cell"].shape
        q_pf = model.perf_quantities(state, wd)
        b_pf = torch.movedim(q_pf.b, 0, -1).reshape(nw_, mp, 3)
        mob_pf = torch.movedim(q_pf.mob, 0, -1).reshape(nw_, mp, 3)
        po_pf = q_pf.po.reshape(nw_, mp)
        rs_pf = q_pf.rs.reshape(nw_, mp)
        rv_pf = q_pf.rv.reshape(nw_, mp)
        mask = wd["perf_mask"] * wd["open"][:, None]
        inj = torch.broadcast_to(wd["is_injector"][:, None], (nw_, mp))

        def rfun_w(u, s):
            qs = u[:3 * nw].reshape(nw, 3)
            bhp = u[3 * nw:]
            cmix = stdwells.wellbore_mixture(qs, wd["comp_frac"],
                                             wd["is_injector"])
            cq_s = stdwells.perf_flux_formula(
                po_pf, b_pf, mob_pf, rs_pf, rv_pf, wd["perf_wi"],
                bhp[:, None] + cdp,
                torch.broadcast_to(cmix[:, None, :], (nw_, mp, 3)), inj,
                allow_crossflow=model.params.allow_crossflow)
            cq_s = cq_s * mask[..., None]
            flux_res, ctrl_res = stdwells.well_residuals(
                wd, qs, bhp, cq_s, s.control, s.target,
                resv_coef=wd.get("resv_coef"), vfp=wd.get("vfp"))
            return torch.cat([flux_res.reshape(-1), ctrl_res])

        def flat(s):
            return torch.cat([s.qs.reshape(-1), s.bhp])

        r0 = float(torch.linalg.norm(rfun_w(flat(state), state)))
        s, rn = state, r0
        it = 0
        while (rn > 1e-10 and it < model.params.max_welleq_iter
               and np.isfinite(rn)):
            ctrl, tgt = stdwells.update_controls(
                wd, s.bhp, s.qs, s.control, s.target)
            s = s._replace(control=ctrl, target=tgt)
            u = flat(s)
            r = rfun_w(u, s)
            J = jacfwd(lambda v: rfun_w(v, s))(u)
            du = dense_solve(J, r)
            lim = model.params.dp_max_rel * torch.abs(s.bhp)
            dbhp = torch.clamp(du[3 * nw:], -lim, lim)
            s = s._replace(qs=s.qs - du[:3 * nw].reshape(nw, 3),
                           bhp=s.bhp - dbhp)
            rn = float(torch.linalg.norm(rfun_w(flat(s), s)))
            it += 1
        # keep the pre-solve state if the inner solve diverged
        if np.isfinite(rn) and rn <= r0 + 1e-30:
            return s
        return state

    def _oscillating(self, history, num_phases=3):
        """Oscillation detection on the MB-residual history
        (NonlinearSolver_impl.hpp:223-255)."""
        if len(history) < 3:
            return False
        f0, f1, f2 = history[-3], history[-2], history[-1]
        osc = 0
        for ph in range(num_phases):
            d1 = (f2[ph] - f1[ph]) / max(abs(f1[ph]), 1e-300)
            d2 = (f1[ph] - f0[ph]) / max(abs(f1[ph]), 1e-300)
            if d1 * d2 < 0 and min(abs(d1), abs(d2)) > self.relax_rel_tol:
                osc += 1
        return osc >= 2
