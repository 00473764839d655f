"""ParameterGroup: key=value run configuration with usage audit.

The reference's two-level config (SURVEY.md §5): the Eclipse deck drives
physics/schedule, while a ParameterGroup (command line `key=value` tokens
and `param_file=`) carries solver/timestepping knobs, queried with typed
`getDefault` at point of use and audited for unused keys at shutdown
(opm/autodiff/FlowMain.hpp:327-352 setupParameters,
:862-868 warnIfUnusedParams; consumers e.g.
BlackoilModelParameters.cpp:43-70, AdaptiveTimeStepping_impl.hpp:99-158).

`apply_to_dataclass` maps matching keys onto the params dataclasses
(ModelParams, TimeStepControlParams, ...) so CLI overrides reach the same
knobs the reference exposes."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional


class ParameterGroup:
    def __init__(self, pairs: Optional[Dict[str, str]] = None):
        self._vals: Dict[str, str] = dict(pairs or {})
        self._used: set = set()

    @classmethod
    def from_args(cls, tokens: List[str]) -> "ParameterGroup":
        """tokens like ['tolerance_cnv=1e-3', 'param_file=run.param'];
        param_file= entries load `key=value` lines (later keys win)."""
        pg = cls()
        for tok in tokens:
            if "=" not in tok:
                raise ValueError(f"expected key=value, got {tok!r}")
            k, v = tok.split("=", 1)
            if k == "param_file":
                pg.load_file(v)
            else:
                pg._vals[k.strip()] = v.strip()
        return pg

    def load_file(self, path: str):
        with open(path) as f:
            for line in f:
                line = line.split("#", 1)[0].split("--", 1)[0].strip()
                if not line:
                    continue
                if "=" not in line:
                    raise ValueError(f"bad param line: {line!r}")
                k, v = line.split("=", 1)
                self._vals[k.strip()] = v.strip()

    # -- typed access (the getDefault pattern) -------------------------
    def get_default(self, key: str, default):
        if key not in self._vals:
            return default
        self._used.add(key)
        raw = self._vals[key]
        if isinstance(default, bool):
            return raw.lower() in ("1", "true", "yes", "on")
        if isinstance(default, int):
            return int(raw)
        if isinstance(default, float):
            return float(raw)
        return raw

    def has(self, key: str) -> bool:
        return key in self._vals

    def unused(self) -> List[str]:
        """warnIfUnusedParams: keys never queried."""
        return sorted(set(self._vals) - self._used)

    # -- dataclass mapping ---------------------------------------------
    def apply_to_dataclass(self, obj: Any) -> Any:
        """Replace fields of a params dataclass with matching keys."""
        updates = {}
        for f in dataclasses.fields(obj):
            if self.has(f.name):
                updates[f.name] = self.get_default(f.name,
                                                   getattr(obj, f.name))
        return dataclasses.replace(obj, **updates) if updates else obj
