"""Configuration: TOML file + environment overlay.

Mirrors corro-types/src/config.rs: sections db/api/gossip/admin/telemetry/
log/consul (config.rs:10-25), env overrides with the ``__`` separator
(config.rs:185-191, e.g. CORRO_DB__PATH=/x overrides [db].path), and a
programmatic constructor for tests (config.rs:194-306). Hot reload re-applies schema
paths (command/reload.rs). Counterpart of corrosion_tpu/agent/config.py.
"""

from __future__ import annotations

import os

try:
    import tomllib
except ModuleNotFoundError:  # Python < 3.11
    import tomli as tomllib  # type: ignore[no-redef]
from dataclasses import dataclass, field
from typing import Any

ENV_PREFIX = "CORRO_"


@dataclass
class DbConfig:
    path: str = "./corrosion.db"
    schema_paths: list[str] = field(default_factory=list)


@dataclass
class ApiConfig:
    addr: str = "127.0.0.1:0"


@dataclass
class GossipConfig:
    addr: str = "127.0.0.1:0"
    bootstrap: list[str] = field(default_factory=list)
    plaintext: bool = True
    max_transmissions: int = 4
    probe_interval_ms: int = 250
    sync_interval_ms: int = 500
    # TLS (config.rs GossipConfig.tls; flat here so the CORRO_GOSSIP__*
    # env overlay reaches every knob — a nested [gossip.tls] table in the
    # TOML maps onto these in Config.load).
    tls_cert_file: str | None = None
    tls_key_file: str | None = None
    tls_ca_file: str | None = None
    tls_insecure: bool = False
    tls_mtls: bool = False  # require + verify client certs
    tls_client_cert_file: str | None = None
    tls_client_key_file: str | None = None


@dataclass
class AdminConfig:
    uds_path: str = "./admin.sock"


@dataclass
class TelemetryConfig:
    prometheus_addr: str | None = None
    # OTLP/HTTP collector base URL (config.rs telemetry.open-telemetry;
    # spans batch-POST to <url>/v1/traces).
    otlp_endpoint: str | None = None


@dataclass
class LogConfig:
    format: str = "plaintext"  # plaintext | json (config.rs:318-326)
    colors: bool = False


@dataclass
class ConsulConfig:
    enabled: bool = False
    address: str = "127.0.0.1:8500"
    interval_ms: int = 1000


@dataclass
class Config:
    db: DbConfig = field(default_factory=DbConfig)
    api: ApiConfig = field(default_factory=ApiConfig)
    gossip: GossipConfig = field(default_factory=GossipConfig)
    admin: AdminConfig = field(default_factory=AdminConfig)
    telemetry: TelemetryConfig = field(default_factory=TelemetryConfig)
    log: LogConfig = field(default_factory=LogConfig)
    consul: ConsulConfig = field(default_factory=ConsulConfig)

    @classmethod
    def load(cls, path: str | None = None, env: dict | None = None) -> "Config":
        data: dict[str, Any] = {}
        if path is not None:
            with open(path, "rb") as f:
                data = tomllib.load(f)
        cfg = cls()
        for section, obj in (
            ("db", cfg.db), ("api", cfg.api), ("gossip", cfg.gossip),
            ("admin", cfg.admin), ("telemetry", cfg.telemetry),
            ("log", cfg.log), ("consul", cfg.consul),
        ):
            for k, v in data.get(section, {}).items():
                if k == "tls" and isinstance(v, dict):
                    # [gossip.tls] nested table → flat tls_* fields.
                    for tk, tv in v.items():
                        if isinstance(tv, dict):  # [gossip.tls.client]
                            for ck, cv in tv.items():
                                flat = f"tls_{tk}_{ck}"
                                if hasattr(obj, flat):
                                    setattr(obj, flat, cv)
                        elif hasattr(obj, f"tls_{tk}"):
                            setattr(obj, f"tls_{tk}", tv)
                    continue
                if hasattr(obj, k):
                    setattr(obj, k, v)
        cfg._apply_env(env if env is not None else dict(os.environ))
        return cfg

    def _apply_env(self, env: dict) -> None:
        """CORRO_<SECTION>__<FIELD>=value (config.rs:185-191)."""
        for key, value in env.items():
            if not key.startswith(ENV_PREFIX) or "__" not in key:
                continue
            section_name, _, field_name = key[len(ENV_PREFIX):].partition("__")
            obj = getattr(self, section_name.lower(), None)
            if obj is None:
                continue
            fname = field_name.lower()
            if not hasattr(obj, fname):
                continue
            current = getattr(obj, fname)
            setattr(obj, fname, _coerce(value, current))

    def schema_sql(self) -> str:
        parts = []
        for p in self.db.schema_paths:
            if os.path.isdir(p):
                for entry in sorted(os.listdir(p)):
                    if entry.endswith(".sql"):
                        with open(os.path.join(p, entry)) as f:
                            parts.append(f.read())
            elif os.path.exists(p):
                with open(p) as f:
                    parts.append(f.read())
        return "\n".join(parts)


def _coerce(value: str, current: Any) -> Any:
    if isinstance(current, bool):
        return value.lower() in ("1", "true", "yes", "on")
    if isinstance(current, int):
        return int(value)
    if isinstance(current, list):
        return [v.strip() for v in value.split(",") if v.strip()]
    return value


def parse_addr(addr: str) -> tuple[str, int]:
    host, _, port = addr.rpartition(":")
    return host or "127.0.0.1", int(port)


def resolve_bootstrap(entries: list[str]) -> list[tuple[str, int]]:
    """Expand bootstrap entries into peer addresses.

    Plain ``host:port`` entries pass through. The reference's DNS resolver
    syntax ``name:port@dns[:dns_port]`` (resolve_bootstrap,
    corro-agent/src/agent.rs:1494-1586) resolves ``name`` and announces to
    EVERY address it maps to; stdlib resolution is used (the custom-server
    part of the syntax is accepted but the system resolver answers).
    Unresolvable names are skipped — bootstrap keeps retrying via the
    announce loop, matching the reference's tolerant startup.
    """
    import socket

    out: list[tuple[str, int]] = []
    for entry in entries:
        spec, _, _dns = entry.partition("@")
        host, port = parse_addr(spec)
        if _dns:
            try:
                infos = socket.getaddrinfo(
                    host, port, type=socket.SOCK_STREAM
                )
            except socket.gaierror:
                continue
            for info in infos:
                addr = (info[4][0], port)
                if addr not in out:
                    out.append(addr)
        else:
            out.append((host, port))
    return out
