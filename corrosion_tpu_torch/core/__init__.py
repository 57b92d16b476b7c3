"""Shared pure logic of the host planes: the oracles the simulator is held
against (counterpart of corrosion_tpu/core/).

Mirrors the reference's corro-base-types, corro-api-types and the pure parts
of corro-types (SURVEY.md §2): id newtypes, hybrid logical clock, interval
sets/maps, value types, change chunking, bookkeeping, sync-need computation,
wire messages and codec.
"""
