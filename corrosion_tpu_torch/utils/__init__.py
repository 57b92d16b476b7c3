"""Infra utilities: counted task spawning, graceful shutdown, backoff.

Rebuilds the reference's infra crates (crates/spawn, crates/tripwire,
crates/backoff — see SURVEY.md §2) on asyncio.
"""

from .backoff import Backoff
from .spawn import TaskRegistry
from .tripwire import Tripwire

__all__ = ["Backoff", "TaskRegistry", "Tripwire"]
