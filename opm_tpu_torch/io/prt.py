"""PRT-style run log: the Eclipse-style print file the reference writes
through OpmLog (FlowMain.hpp:392-419 setupLogging; per-Newton convergence
tables BlackoilModelBase_impl.hpp:1790-1826; FIP tables + SimulatorReport
SimulatorBase_impl.hpp:277-304). Every run leaves a diagnosable trace:
per-substep dt / Newton counts / failure causes, per-iteration MB/CNV/well
norms, per-report-step field summaries, and the end-of-run timing report.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

DAY = 86400.0

_HEADER = (" Iter      MB(W)      MB(O)      MB(G)     CNV(W)     CNV(O)"
           "     CNV(G)     W-FLUX     W-CONT")


class PrtLogger:
    """Accumulates the run log; written incrementally so a crashed run
    still leaves its trace (the reference streams through OpmLog)."""

    def __init__(self, path: str, case_title: str = ""):
        self.path = path
        self._f = open(path, "w")
        self._f.write(f"-- PRT run log: {case_title}\n")
        self._f.flush()

    def warning(self, msg: str):
        """OpmLog::warning analogue — one flagged line in the run log."""
        self._f.write(f"-- WARNING: {msg}\n")
        self._f.flush()

    # -- substep/Newton level -------------------------------------------
    def substep(self, report_step: int, t_days: float, dt_days: float,
                iterations: int, converged: bool,
                convergence_history=None, failure: Optional[str] = None):
        f = self._f
        status = "converged" if converged else f"FAILED ({failure})"
        f.write(f"\n substep @ step {report_step:4d}  t={t_days:10.2f} d  "
                f"dt={dt_days:8.3f} d  newton={iterations:2d}  {status}\n")
        hist = convergence_history
        if hist is not None:
            rows = np.asarray(hist)
            f.write(_HEADER + "\n")
            for i, row in enumerate(rows):
                if not np.isfinite(row).any():
                    break
                f.write(f" {i:4d} " + " ".join(f"{v:10.3e}" for v in row)
                        + "\n")
        f.flush()

    def span(self, first_step: int, last_step: int, substeps: int,
             failed: int, newtons: int):
        self._f.write(
            f"\n fused span: report steps {first_step}-{last_step}  "
            f"substeps={substeps} failed={failed} newtons={newtons} "
            f"(per-Newton tables unavailable in span mode; set "
            f"OPM_TPU_SPAN=1 for full tables)\n")
        self._f.flush()

    # -- report-step level ----------------------------------------------
    def report_step(self, index: int, t_days: float, row: dict,
                    fip=None):
        f = self._f
        f.write(f"\n== report step {index:4d}  t={t_days:10.2f} d  "
                f"FPR={row.get('FPR', float('nan')) / 1e5:9.3f} bar  "
                f"FOPR={row.get('FOPR', 0.0) * DAY:10.2f} sm3/d  "
                f"FWCT={row.get('FWCT', 0.0):6.4f}  "
                f"FGOR={row.get('FGOR', 0.0):8.2f}\n")
        if fip is not None:
            fip = np.asarray(fip)
            f.write("   FIP (sm3): water %.6e  oil %.6e  gas %.6e\n"
                    % tuple(fip[:3]))
        f.flush()

    def failure(self, report_step: int, message: str):
        self._f.write(f"\n !! step {report_step}: {message}\n")
        self._f.flush()

    # -- end of run ------------------------------------------------------
    def final_report(self, report):
        f = self._f
        f.write("\n================ SimulatorReport ================\n")
        f.write(f" total wall time        : {report.total_time:10.3f} s\n")
        f.write(f" assemble time          : {report.assemble_time:10.3f}"
                " s\n")
        f.write(f" linear solve time      : "
                f"{report.linear_solve_time:10.3f} s\n")
        f.write(f" substeps               : {report.substeps:6d}"
                f"  (failed {report.failed_substeps})\n")
        f.write(f" newton iterations      : {report.newton_iterations:6d}\n")
        f.write(f" linear iterations      : {report.linear_iterations:6d}\n")
        f.flush()

    def close(self):
        self._f.close()
