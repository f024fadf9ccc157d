"""One documented accessor for every ``REPRO_*`` environment knob —
counterpart of ``repro.settings``.

The registry is the reference's, knob for knob: the same names, env vars,
kinds, defaults and docs, so :func:`describe` prints the same text in both
packages and one environment configures both.  Every consumer goes through
:func:`get`; ``python -m repro_torch.settings`` prints the list.

Knobs read only by parts of the JAX package the port does not have (the
traced decode checks, the conformance sweep) stay listed; in the port they
are no-ops, named in :data:`PORT_NOOPS`.  The port reads the tracing knobs
(``repro_torch.obs``), those of the worker pool, the HTTP plane and hedging
(``repro_torch.dist``), and ``calibration`` (``repro_torch.cdmm.calibrate``;
unset, the port's default is its own ``cdmm/calibration.json``, not the
reference's ``benchmarks/calibration.json`` its doc names).

The module imports nothing heavy (no torch, no numpy).

Booleans parse ``1/true/yes/on`` as True (case-insensitive); everything
else, including the empty string, is False.  A knob with
``legacy_env`` set falls back to the old variable and emits one
``DeprecationWarning`` per process via :func:`warn_deprecated_once`.
"""
from __future__ import annotations

import os
import warnings
from dataclasses import dataclass
from typing import Dict, Mapping, Optional

__all__ = [
    "PORT_NOOPS",
    "SETTINGS",
    "Setting",
    "describe",
    "get",
    "get_bool",
    "get_float",
    "get_int",
    "warn_deprecated_once",
]

# deprecation shims warn once per process per form, even under test
# harnesses that reset the warnings filters
_WARNED: set = set()

_TRUTHY = {"1", "true", "yes", "on"}


def warn_deprecated_once(key: str, message: str) -> None:
    if key in _WARNED:
        return
    _WARNED.add(key)
    warnings.warn(message, DeprecationWarning, stacklevel=3)


@dataclass(frozen=True)
class Setting:
    """One environment knob: where it comes from and what it defaults to."""

    name: str  # accessor name (settings.get(name))
    env: str  # environment variable
    kind: str  # "bool" | "int" | "float" | "str"
    default: object
    doc: str  # one line, printed by describe()
    legacy_env: Optional[str] = None  # deprecated fallback variable


SETTINGS: Dict[str, Setting] = {
    s.name: s
    for s in (
        Setting(
            "calibration", "REPRO_CALIBRATION", "str", None,
            "planner calibration source: a JSON path, or off/0/none for "
            "the analytic proxy (default: committed "
            "benchmarks/calibration.json)",
        ),
        Setting(
            "debug_solve", "REPRO_DEBUG_SOLVE", "bool", False,
            "run-time duplicate-live-set checks inside jitted decode "
            "paths via jax.debug.callback",
        ),
        Setting(
            "conformance_inproc", "REPRO_CONFORMANCE_INPROC", "bool", False,
            "run the conformance sweep fine-grained in-process instead of "
            "the subprocess-sharded quarantine variant",
        ),
        Setting(
            "trace", "REPRO_TRACE", "bool", False,
            "enable repro.obs request tracing (spans recorded to the "
            "process-local ring buffer; also via --trace flags / "
            "repro.obs.set_enabled)",
        ),
        Setting(
            "trace_buffer", "REPRO_TRACE_BUFFER", "int", 8192,
            "ring-buffer capacity (spans) of the process-local "
            "repro.obs tracer",
        ),
        Setting(
            "dist_workers", "REPRO_DIST_WORKERS", "int", None,
            "worker count for pools built from the environment "
            "(PoolConfig.from_env)", legacy_env="REPRO_POOL_WORKERS",
        ),
        Setting(
            "dist_transport", "REPRO_DIST_TRANSPORT", "str", None,
            "wire codec for pools built from the environment: auto, raw, "
            "pack, pack+zlib, pack+zstd",
        ),
        Setting(
            "dist_hostfile", "REPRO_DIST_HOSTFILE", "str", None,
            "hostfile (path or literal text) for pools built from the "
            "environment",
        ),
        Setting(
            "dist_master_addr", "REPRO_DIST_MASTER_ADDR", "str", None,
            "master endpoint (tcp:HOST:PORT or unix:/path) for pools "
            "built from the environment / rank-wired launches",
        ),
        Setting(
            "dist_stream_chunk", "REPRO_DIST_STREAM_CHUNK", "int", None,
            "share-streaming chunk size in bytes for pools built from "
            "the environment (0 disables pipelining)",
        ),
        Setting(
            "pool_log", "REPRO_POOL_LOG", "bool", False,
            "let spawned worker/agent stderr through instead of "
            "discarding it (pool debugging)",
        ),
        Setting(
            "obs_http_port", "REPRO_OBS_HTTP_PORT", "int", None,
            "serve the live telemetry plane (/metrics /healthz /stats "
            "/trace) on this port (0 = ephemeral; unset = no server)",
        ),
        Setting(
            "hedge_factor", "REPRO_HEDGE_FACTOR", "float", 0.0,
            "speculatively re-dispatch a share outstanding past "
            "p95(recent share round-trips) x this factor to a healthy "
            "worker; first valid reply wins (0 = never hedge)",
        ),
        Setting(
            "health_ewma", "REPRO_HEALTH_EWMA", "float", 0.2,
            "EWMA smoothing factor of the per-worker health signals "
            "(share round-trip + heartbeat jitter)",
        ),
        Setting(
            "obs_retention", "REPRO_OBS_RETENTION", "float", 300.0,
            "retention window in seconds of the time-series metrics "
            "behind windowed quantiles (hedge deadlines, /metrics "
            "window gauges)",
        ),
    )
}


# knobs the port lists for parity but does not read (yet)
PORT_NOOPS = frozenset(("debug_solve", "conformance_inproc"))


def _parse(setting: Setting, raw: str):
    if setting.kind == "bool":
        return raw.strip().lower() in _TRUTHY
    if setting.kind == "int":
        return int(raw)
    if setting.kind == "float":
        return float(raw)
    return raw


def get(name: str, env: Mapping[str, str] = os.environ):
    """The effective value of setting ``name``: the env var parsed per its
    kind, the deprecated legacy variable (one warning) as fallback, else
    the documented default."""
    setting = SETTINGS[name]
    raw = env.get(setting.env)
    if raw is None and setting.legacy_env is not None:
        raw = env.get(setting.legacy_env)
        if raw is not None:
            warn_deprecated_once(
                setting.legacy_env,
                f"{setting.legacy_env} is deprecated; set {setting.env} "
                f"instead",
            )
    if raw is None:
        return setting.default
    return _parse(setting, raw)


def get_bool(name: str, env: Mapping[str, str] = os.environ) -> bool:
    return bool(get(name, env))


def get_int(name: str, env: Mapping[str, str] = os.environ) -> Optional[int]:
    val = get(name, env)
    return val if val is None else int(val)


def get_float(
    name: str, env: Mapping[str, str] = os.environ
) -> Optional[float]:
    val = get(name, env)
    return val if val is None else float(val)


def describe() -> str:
    """One line per knob: env var, default, doc (the README table's source
    of truth)."""
    lines = []
    for s in SETTINGS.values():
        default = "unset" if s.default is None else repr(s.default)
        legacy = f" (legacy: {s.legacy_env})" if s.legacy_env else ""
        lines.append(f"{s.env}{legacy} [{s.kind}, default {default}]: {s.doc}")
    return "\n".join(lines)


if __name__ == "__main__":
    print(describe())
