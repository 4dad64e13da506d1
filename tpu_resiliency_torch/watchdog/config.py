"""Fault-tolerance configuration: dataclass ← YAML ← CLI overrides.

Analogue of the reference's ``FaultToleranceConfig`` (``fault_tolerance/config.py:28-283``):
same knob set and defaults (heartbeat timeouts 3600/2700 s, check every 5 s,
safety_factor 5.0, SIGKILL termination — ``config.py:59-71``), same YAML behavior
(``fault_tolerance`` section found at any nesting depth) and ``--ft-param-*`` CLI
override namespace.
"""

from __future__ import annotations

import dataclasses
import signal
from typing import Any, Mapping, Optional


@dataclasses.dataclass
class FaultToleranceConfig:
    # heartbeat-based detection
    initial_rank_heartbeat_timeout: Optional[float] = 60.0 * 60.0
    rank_heartbeat_timeout: Optional[float] = 45.0 * 60.0
    workload_check_interval: float = 5.0
    # section-based detection
    rank_section_timeouts: dict[str, Optional[float]] = dataclasses.field(default_factory=dict)
    rank_out_of_section_timeout: Optional[float] = None
    # timeout auto-calibration
    safety_factor: float = 5.0
    # enforcement
    rank_termination_signal: int = signal.SIGKILL
    log_level: str = "INFO"
    # hang forensics: on a hang verdict the monitor first requests an
    # all-thread stack dump from its rank AND every sibling rank's monitor
    # (the blocked waiters are half the story), waits out the grace, then
    # runs the kill ladder. 0 (or stack_dump_on_hang=False) kills immediately.
    stack_dump_on_hang: bool = True
    stack_dump_grace: float = 1.5
    # restart policy knobs consumed by the launcher
    restart_check_interval: float = 1.0
    # pluggable host/device health checks run by the monitor
    enable_health_checks: bool = False
    health_check_interval: float = 5.0
    # built-in health sources (watchdog/health.py), config-enabled like the
    # reference's GPU/NIC checks; None disables each. CudaRuntimeCheck is NOT
    # listed: it must run in the process that owns the card (wire it into the
    # in-process restart health chain instead).
    host_memory_min_fraction: Optional[float] = None  # e.g. 0.05
    ici_link_device_glob: Optional[str] = None  # e.g. /sys/class/accel/accel*
    ici_link_down_path_template: Optional[str] = None  # e.g. .../{device}/link_downed

    SECTION_NAME = "fault_tolerance"
    PARAM_PREFIX = "ft_param_"

    def __post_init__(self):
        if isinstance(self.rank_termination_signal, str):
            name = self.rank_termination_signal.upper()
            if not name.startswith("SIG"):
                name = "SIG" + name
            self.rank_termination_signal = getattr(signal, name)
        if isinstance(self.rank_termination_signal, signal.Signals):
            self.rank_termination_signal = int(self.rank_termination_signal)

    # -- construction ------------------------------------------------------

    @classmethod
    def _field_names(cls) -> set[str]:
        return {f.name for f in dataclasses.fields(cls)}

    @classmethod
    def from_dict(cls, d: Mapping[str, Any], strict: bool = True) -> "FaultToleranceConfig":
        known = cls._field_names()
        unknown = set(d) - known
        if unknown and strict:
            raise ValueError(f"unknown fault_tolerance config keys: {sorted(unknown)}")
        return cls(**{k: v for k, v in d.items() if k in known})

    @classmethod
    def from_yaml_file(cls, path: str, strict: bool = True) -> "FaultToleranceConfig":
        """Load, finding the ``fault_tolerance`` section at any nesting depth
        (reference ``config.py:224-239``)."""
        import yaml  # only the YAML paths need PyYAML

        with open(path) as f:
            doc = yaml.safe_load(f) or {}
        section = cls._find_section(doc)
        if section is None:
            raise ValueError(f"no '{cls.SECTION_NAME}' section found in {path}")
        return cls.from_dict(section, strict=strict)

    @classmethod
    def _find_section(cls, node: Any) -> Optional[Mapping[str, Any]]:
        if isinstance(node, Mapping):
            if cls.SECTION_NAME in node and isinstance(node[cls.SECTION_NAME], Mapping):
                return node[cls.SECTION_NAME]
            for v in node.values():
                found = cls._find_section(v)
                if found is not None:
                    return found
        return None

    @classmethod
    def from_args(cls, args, base: Optional["FaultToleranceConfig"] = None):
        """Apply ``--ft-param-*`` CLI overrides (argparse namespace attributes named
        ``ft_param_<field>``; reference ``config.py:144``)."""
        cfg = base or cls()
        known = cls._field_names()
        for key, value in vars(args).items():
            if not key.startswith(cls.PARAM_PREFIX) or value is None:
                continue
            field = key[len(cls.PARAM_PREFIX) :]
            if field not in known:
                raise ValueError(f"unknown --ft-param '{field}'")
            setattr(cfg, field, _coerce(cfg, field, value))
        cfg.__post_init__()
        return cfg

    def to_yaml_file(self, path: str) -> None:
        import yaml

        with open(path, "w") as f:
            yaml.safe_dump({self.SECTION_NAME: dataclasses.asdict(self)}, f)

    def merged(self, **overrides) -> "FaultToleranceConfig":
        return dataclasses.replace(self, **overrides)


def _coerce(cfg: FaultToleranceConfig, field: str, value: Any) -> Any:
    current = getattr(cfg, field)
    if isinstance(value, str):
        if field == "rank_section_timeouts":
            import yaml

            return yaml.safe_load(value)
        if isinstance(current, bool):
            return value.lower() in ("1", "true", "yes")
        if isinstance(current, (int, float)) or current is None:
            try:
                return float(value) if "." in value or "e" in value.lower() else int(value)
            except ValueError:
                return value
    return value
