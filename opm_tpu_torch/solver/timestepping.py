"""Adaptive sub-stepping with failure chopping.

Counterpart of opm/simulators/timestepping/
AdaptiveTimeStepping_impl.hpp: report steps are subdivided; on solver failure
(TooManyIterations / NumericalIssue) the state is restored, dt is chopped by
restart_factor (0.33) and retried up to solver_restart_max (10) times
(:235-373); on success the next dt comes from a step controller (here the
iteration-count controller; PID on solution change is the 'pid' option),
bounded by growth_factor (:118-158). Schedule events (well changes) reset dt
to event_dt (SimulatorBase_impl.hpp:229-236).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from opm_tpu_torch.solver.newton import (LinearSolverProblem, NumericalIssue,
                                   SolverReport, TooManyIterations)

DAY = 86400.0


@dataclass
class TimeStepControlParams:
    initial_dt: float = 1.0 * DAY
    max_dt: float = 365.0 * DAY
    min_dt: float = 0.1 * DAY
    restart_factor: float = 0.33
    growth_factor: float = 3.0
    max_growth: float = 3.0
    failed_growth: float = 2.0     # growth cap right after a restart
    solver_restart_max: int = 10
    target_iterations: int = 8     # iteration-count controller
    event_reset: bool = True
    # controller: 'iterationcount' | 'pid' | 'pid+iteration'
    # (AdaptiveTimeStepping_impl.hpp:118-158 timestep.control options;
    # PID gains from the external PIDTimeStepControl)
    controller: str = "iterationcount"
    pid_tol: float = 8e-1
    pid_kP: float = 0.075
    pid_kI: float = 0.175
    pid_kD: float = 0.01


class PIDController:
    """PID-on-solution-change dt selector (PIDTimeStepControl semantics):
    given the relative solution change e_n of the accepted substep,
        dt' = dt * (e_{n-1}/e_n)^kP * (tol/e_n)^kI * (e_{n-1}^2/(e_n e_{n-2}))^kD
    """

    def __init__(self, p: TimeStepControlParams):
        self.p = p
        self.errors = [p.pid_tol, p.pid_tol, p.pid_tol]

    def compute_dt(self, dt, error, iterations):
        p = self.p
        e = max(float(error), 1e-12)
        self.errors = [self.errors[1], self.errors[2], e]
        e0, e1, e2 = self.errors
        factor = ((e1 / e2) ** p.pid_kP
                  * (p.pid_tol / e2) ** p.pid_kI
                  * ((e1 * e1) / (e2 * e0)) ** p.pid_kD)
        if p.controller == "pid+iteration" and iterations > \
                p.target_iterations:
            factor = min(factor, p.target_iterations / iterations)
        return dt * min(max(factor, 0.1), p.growth_factor)


@dataclass
class SubStepReport:
    substeps: int = 0
    failed_substeps: int = 0
    total_newton: int = 0
    total_linear: int = 0
    solver_time: float = 0.0


def _np(t):
    return t.detach().cpu().numpy()


def _solution_change(s0, s1) -> float:
    """Relative solution change between accepted substeps (the PID error
    measure): rms of relative pressure change + rms saturation-like change."""
    p0 = _np(s0.pressure)
    p1 = _np(s1.pressure)
    ep = np.sqrt(np.mean(((p1 - p0) / np.maximum(np.abs(p1), 1.0)) ** 2))
    es = np.sqrt(np.mean((_np(s1.sw) - _np(s0.sw)) ** 2))
    if hasattr(s0, "x"):
        xs = np.maximum(np.abs(_np(s1.x)), 1.0)
        es += np.sqrt(np.mean(
            ((_np(s1.x) - _np(s0.x)) / xs) ** 2))
    return float(ep + es)


class AdaptiveTimeStepping:
    def __init__(self, params: Optional[TimeStepControlParams] = None,
                 tuning: Optional[dict] = None):
        self.p = params or TimeStepControlParams()
        if tuning:
            self.p.initial_dt = tuning.get("tsinit", self.p.initial_dt)
            self.p.max_dt = tuning.get("tsmaxz", self.p.max_dt)
            self.p.min_dt = tuning.get("tsminz", self.p.min_dt)
            # TSFMAX (deck TUNING record 1 item 5) -> maxGrowth_: the
            # general max dt increase factor; TFDIFF (item 8, default
            # 1.25) -> growthFactor_: the growth cap right after a
            # chopped restart (AdaptiveTimeStepping_impl.hpp:82-84)
            if "tsfmax" in tuning:
                self.p.growth_factor = tuning["tsfmax"]
                self.p.max_growth = tuning["tsfmax"]
            if "tfdiff" in tuning:
                self.p.failed_growth = tuning["tfdiff"]
        self.suggested_dt = self.p.initial_dt
        self.pid = PIDController(self.p) if self.p.controller.startswith(
            "pid") else None

    def step(self, solve_fn: Callable, state, report_step_length: float,
             *, had_event: bool = False, substep_callback=None,
             failure_callback=None):
        """Run one report step of length report_step_length.

        solve_fn(state, dt) -> (new_state, SolverReport); must raise
        NumericalIssue/TooManyIterations on failure. Returns
        (state, SubStepReport). failure_callback(t_local, dt, exc) is
        invoked on each chopped retry (PRT logging)."""
        p = self.p
        rep = SubStepReport()
        remaining = report_step_length
        dt = min(self.suggested_dt, remaining, p.max_dt)
        if had_event and p.event_reset:
            dt = min(p.initial_dt, remaining)
        restarts = 0
        just_failed = False
        t_local = 0.0
        while remaining > 1e-6:
            dt = min(dt, remaining)
            state_prev = state
            try:
                new_state, srep = solve_fn(state, dt)
            except (NumericalIssue, TooManyIterations,
                    LinearSolverProblem) as exc:
                rep.failed_substeps += 1
                restarts += 1
                if failure_callback is not None:
                    failure_callback(t_local, dt, exc)
                if restarts > p.solver_restart_max:
                    raise
                dt = max(dt * p.restart_factor, p.min_dt)
                just_failed = True
                continue
            # success
            state = new_state
            remaining -= dt
            t_local += dt
            rep.substeps += 1
            rep.total_newton += srep.iterations
            rep.total_linear += srep.linear_iterations
            rep.solver_time += srep.assemble_time + srep.linear_solve_time
            if substep_callback is not None:
                substep_callback(state, t_local, dt, srep)
            its = max(srep.iterations, 1)
            if self.pid is not None:
                err = _solution_change(state_prev, state)
                dt_new = self.pid.compute_dt(dt, err, its)
            else:
                # iteration-count control (SimpleIterationCount semantics)
                dt_new = dt * min(p.growth_factor,
                                  max(0.1, p.target_iterations / its))
            growth_cap = p.failed_growth if just_failed else p.growth_factor
            dt_new = min(dt_new, dt * growth_cap)
            dt = float(np.clip(dt_new, p.min_dt, p.max_dt))
            just_failed = False
        self.suggested_dt = dt
        return state, rep
