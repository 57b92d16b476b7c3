"""Backup / restore.

Mirrors `corrosion backup` / `corrosion restore` (reference
corrosion/src/main.rs:154-288): backup = `VACUUM INTO` a snapshot and strip
node-local state so the file can seed a *different* node; restore = swap
the db file into place (offline here — the reference's online variant takes
SQLite's C file locks, sqlite3-restore/lib.rs:15-57, which only matters for
a live process) optionally re-adopting the backup's actor id.

Counterpart of corrosion_tpu/agent/backup.py.
"""

from __future__ import annotations

import fcntl
import os
import shutil
import sqlite3

# SQLite's file-locking byte offsets (the C ABI contract sqlite3-restore
# manipulates, lib.rs:15-30): a PENDING byte, a RESERVED byte, and a
# 510-byte SHARED range at 1 GiB, plus the WAL-index lock bytes 120-128 in
# the -shm file.
PENDING_BYTE = 0x40000000
RESERVED_BYTE = PENDING_BYTE + 1
SHARED_FIRST = PENDING_BYTE + 2
SHARED_SIZE = 510
SHM_LOCK_OFF = 120
SHM_LOCK_LEN = 8

# Node-local tables a backup must not carry into another node
# (main.rs:176-216 strips members + local bookkeeping rewrite).
# Subscriptions are per-node state too: a restored node must keep ITS
# subscriptions, not adopt the backup origin's.
NODE_LOCAL_TABLES = ("__corro_members", "__corro_subs")


def backup(db_path: str, out_path: str) -> None:
    if os.path.exists(out_path):
        raise FileExistsError(out_path)
    src = sqlite3.connect(db_path)
    try:
        src.execute("VACUUM INTO ?", (out_path,))
    finally:
        src.close()
    snap = sqlite3.connect(out_path)
    try:
        for tbl in NODE_LOCAL_TABLES:
            snap.execute(f"DROP TABLE IF EXISTS {tbl}")
        # The snapshot must not reuse the origin's identity by default: a
        # restored node adopts it only with --self-actor-id (main.rs:220-288).
        snap.execute("COMMIT") if snap.in_transaction else None
        snap.execute("VACUUM")
    finally:
        snap.close()


def _prepare_restore_file(
    backup_path: str, db_path: str, self_actor_id: bool
) -> tuple[str, bytes]:
    """Copy the backup next to the target and fix its identity; returns
    (tmp_path, site_id that will be in effect)."""
    tmp = db_path + ".restore"
    shutil.copyfile(backup_path, tmp)
    conn = sqlite3.connect(tmp)
    try:
        if not self_actor_id:
            new_site = os.urandom(16)
            conn.execute(
                "UPDATE __corro_meta SET value = ? WHERE key = 'site_id'",
                (new_site,),
            )
            conn.commit()
        (site_id,) = conn.execute(
            "SELECT value FROM __corro_meta WHERE key='site_id'"
        ).fetchone()
    finally:
        conn.close()
    return tmp, bytes(site_id)


def online_restore(
    backup_path: str, db_path: str, self_actor_id: bool = False
) -> bytes:
    """Replace a LIVE database's content under SQLite's own file locks.

    The sqlite3-restore analogue (lib.rs:57+): take the PENDING, RESERVED
    and SHARED lock bytes on the main file (excluding every other reader
    and writer at the SQLite protocol level), take the WAL-index lock bytes
    on the -shm file, then overwrite the file's *content in place* — same
    inode, so connections already holding file descriptors keep working and
    observe the restored database on their next transaction (SQLite re-reads
    the header when the change counter moves). The -wal file is truncated so
    no stale frames overlay the new content.
    """
    tmp, site_id = _prepare_restore_file(backup_path, db_path, self_actor_id)
    fd = os.open(db_path, os.O_RDWR)
    shm_fd = None
    try:
        # Lock order mirrors the reference: PENDING → RESERVED → SHARED.
        fcntl.lockf(fd, fcntl.LOCK_EX, 1, PENDING_BYTE, os.SEEK_SET)
        fcntl.lockf(fd, fcntl.LOCK_EX, 1, RESERVED_BYTE, os.SEEK_SET)
        fcntl.lockf(fd, fcntl.LOCK_EX, SHARED_SIZE, SHARED_FIRST, os.SEEK_SET)
        shm_path = db_path + "-shm"
        if os.path.exists(shm_path):
            shm_fd = os.open(shm_path, os.O_RDWR)
            fcntl.lockf(
                shm_fd, fcntl.LOCK_EX, SHM_LOCK_LEN, SHM_LOCK_OFF, os.SEEK_SET
            )
        # Same-inode content replacement, chunked (a single os.write caps
        # out near 2 GiB on Linux and reports a short count).
        os.ftruncate(fd, 0)
        os.lseek(fd, 0, os.SEEK_SET)
        with open(tmp, "rb") as src:
            while chunk := src.read(1 << 24):
                view = memoryview(chunk)
                while view:
                    view = view[os.write(fd, view):]
        os.fsync(fd)
        wal_path = db_path + "-wal"
        if os.path.exists(wal_path):
            with open(wal_path, "r+b") as wal:
                wal.truncate(0)
        os.unlink(tmp)
    finally:
        if shm_fd is not None:
            fcntl.lockf(
                shm_fd, fcntl.LOCK_UN, SHM_LOCK_LEN, SHM_LOCK_OFF, os.SEEK_SET
            )
            os.close(shm_fd)
        fcntl.lockf(fd, fcntl.LOCK_UN, SHARED_SIZE, SHARED_FIRST, os.SEEK_SET)
        fcntl.lockf(fd, fcntl.LOCK_UN, 1, RESERVED_BYTE, os.SEEK_SET)
        fcntl.lockf(fd, fcntl.LOCK_UN, 1, PENDING_BYTE, os.SEEK_SET)
        os.close(fd)
    return site_id


def restore(
    backup_path: str, db_path: str, self_actor_id: bool = False
) -> bytes:
    """Swap the backup into place; returns the site_id now in effect.

    With self_actor_id=False a fresh identity is assigned so the restored
    node replicates as a new actor (the safe default); True keeps the
    backup's identity (re-adoption)."""
    tmp, site_id = _prepare_restore_file(backup_path, db_path, self_actor_id)
    for suffix in ("-wal", "-shm"):
        p = db_path + suffix
        if os.path.exists(p):
            os.unlink(p)
    os.replace(tmp, db_path)
    return site_id
