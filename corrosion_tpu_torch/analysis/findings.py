"""Finding model and the CT0xx rule registry.

Every rule has a stable id so suppressions (``# corro-lint:
disable=CT003 reason=...``), CI gating, and the JSON report format stay
meaningful as rules are added. The ids are the reference's
(corrosion_tpu/analysis/findings.py), so docs/ANALYSIS.md documents
both; the purity and sanitizer texts name torch's form of each hazard.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field

# rule id -> (title, one-line rationale). The long-form rationale (what
# the violation costs at kernel scale) lives in docs/ANALYSIS.md.
RULES: dict[str, tuple[str, str]] = {
    "CT000": (
        "bad-suppression",
        "corro-lint suppression without a reason= string or naming an "
        "unknown rule id",
    ),
    "CT009": (
        "stale-suppression",
        "a corro-lint suppression whose rule no longer fires on its "
        "line/scope — delete it so the suppression inventory can't rot "
        "(non-gating; listed under --show-suppressed)",
    ),
    "CT001": (
        "numpy-in-traced-code",
        "numpy (np.*) or .cpu()/.numpy()/.tolist() inside a kernel "
        "function — a host round-trip that blocks the device per call "
        "when it touches a tensor",
    ),
    "CT002": (
        "local-numpy-import",
        "function-local `import numpy` in a kernel module — hoist to "
        "module scope or suppress with a reason",
    ),
    "CT003": (
        "dtypeless-literal",
        "torch.tensor/zeros/ones/full/empty (or jnp.array/zeros/ones/"
        "full/empty) without an explicit dtype in a kernel module — "
        "torch's float32 default drifts downstream widths",
    ),
    "CT004": (
        "traced-value-coercion",
        "float()/int()/bool()/.item()/.tolist() in a kernel function — "
        "forces a device sync per call",
    ),
    "CT005": (
        "python-branch-on-traced",
        "Python if/while on a tensor value (`if t.any():`) in a kernel "
        "function, or on a traced parameter of a scan-body or jitted "
        "function — an implicit device sync per branch",
    ),
    "CT010": (
        "round-curve-schema",
        "engine scan body emits a telemetry key outside the canonical "
        "ROUND_CURVE_KEYS set (or its emission cannot be statically "
        "resolved)",
    ),
    "CT020": (
        "blocking-call-under-lock",
        "blocking call (sleep/subprocess/socket/file I/O) inside a "
        "`with <lock>:` block — stalls every waiter for the call's wall",
    ),
    "CT021": (
        "lock-order-cycle",
        "cycle in the lock-acquisition-order graph — a latent deadlock",
    ),
    "CT040": (
        "await-straddled-state-write",
        "an async method reads a shared `self` attribute, suspends at an "
        "await, then writes it back without holding the guarding lock — "
        "a concurrent task can interleave at the await and the write "
        "clobbers its update (the agent membership-wedge shape)",
    ),
    "CT041": (
        "fire-and-forget-task",
        "create_task/ensure_future whose result is neither stored, "
        "awaited, nor given add_done_callback — the task can die "
        "silently (exceptions vanish) or be garbage-collected mid-run",
    ),
    "CT042": (
        "blocking-call-in-async",
        "blocking call (sleep/subprocess/socket dial/sync sqlite/file "
        "open) lexically inside an `async def` — stalls the event loop "
        "for the call's wall time; every session on the loop waits",
    ),
    "CT043": (
        "cancellederror-swallowed",
        "an except handler in an `async def` catches "
        "asyncio.CancelledError (directly, bare, or via BaseException) "
        "without re-raising — cancellation is absorbed and "
        "shutdown/timeouts wedge",
    ),
    "CT050": (
        "engine-clone-drift",
        "an intentional engine-clone pair declared in SEAM_MAP.json "
        "diverges outside its declared seams — the four-copy round "
        "stanza drifted (the bug class CT010/parity runtime tests exist "
        "to catch after the fact)",
    ),
    "CT051": (
        "seam-map-function-missing",
        "a function mapped in SEAM_MAP.json no longer exists — update "
        "the map (an engine collapse deletes entries as its progress, "
        "but it must be deliberate)",
    ),
    "CT052": (
        "partial-plane-coverage",
        "a canonical round-curve key is emitted by some but not all "
        "four engines and carries no seam-map waiver — a new per-round "
        "plane was threaded through fewer than four copies",
    ),
    "CT060": (
        "nondeterminism-in-traced-code",
        "wall clock/random/uuid/os.urandom or set-order iteration "
        "inside a traced kernel function — the value is baked at trace "
        "time and differs per process, breaking replay and retrace "
        "stability",
    ),
    "CT061": (
        "nondeterminism-in-schedule-module",
        "nondeterministic source in a deterministic-schedule module "
        "(agent/netem.py, sim/faults.py) — impairment and fault "
        "schedules must be pure functions of seed+coordinates or exact "
        "replay breaks",
    ),
    "CT062": (
        "nondeterminism-at-artifact-emit",
        "nondeterministic source in a function that emits a "
        "`corro-*/N` artifact — committed artifacts must be "
        "byte-deterministic for baseline diff gates to mean anything",
    ),
    "CT030": (
        "retrace-tripwire",
        "sanitizer: the kernel library was built or loaded again on a "
        "second same-shape engine run (silent rebuild)",
    ),
    "CT031": (
        "strict-dtype-violation",
        "sanitizer: an operation of the engine's round mixes tensor "
        "dtypes (implicit promotion in the round)",
    ),
    "CT032": (
        "nan-produced",
        "sanitizer: an operation of the engine's round produced a NaN",
    ),
    "CT033": (
        "sanitizer-run-failure",
        "sanitizer: engine run failed for a reason other than dtype "
        "promotion or NaNs (the tiny-config run itself is broken)",
    ),
}


@dataclass
class Finding:
    rule: str
    path: str
    line: int
    message: str
    col: int = 0
    suppressed: bool = False
    suppress_reason: str = ""

    def render(self) -> str:
        title = RULES.get(self.rule, ("?",))[0]
        return (
            f"{self.path}:{self.line}:{self.col}: {self.rule} "
            f"[{title}] {self.message}"
        )


@dataclass
class LintResult:
    """Outcome of a lint run: active findings gate, suppressed ones are
    kept for transparency, per-engine emitted key sets feed the schema
    tests and the JSON artifact."""

    findings: list[Finding] = field(default_factory=list)
    suppressed: list[Finding] = field(default_factory=list)
    stale: list[Finding] = field(default_factory=list)  # CT009, non-gating
    files: int = 0
    engines: dict[str, list[str]] = field(default_factory=dict)
    canonical_keys: tuple[str, ...] = ()

    @property
    def ok(self) -> bool:
        return not self.findings

    def to_dict(self) -> dict:
        return {
            "version": 1,
            "ok": self.ok,
            "files": self.files,
            "findings": [asdict(f) for f in self.findings],
            "suppressed": [asdict(f) for f in self.suppressed],
            "stale_suppressions": [asdict(f) for f in self.stale],
            "engines": self.engines,
            "canonical_keys": list(self.canonical_keys),
            "rules": {k: {"title": t, "why": w} for k, (t, w) in RULES.items()},
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    def render_text(self, show_suppressed: bool = False) -> str:
        lines = [f.render() for f in self.findings]
        if show_suppressed:
            for f in self.suppressed:
                lines.append(
                    f"{f.render()}  (suppressed: {f.suppress_reason})"
                )
            for f in self.stale:
                lines.append(f"{f.render()}  (non-gating)")
        lines.append(
            f"{len(self.findings)} finding(s), "
            f"{len(self.suppressed)} suppressed, "
            f"{len(self.stale)} stale suppression(s), {self.files} file(s)"
        )
        return "\n".join(lines)
