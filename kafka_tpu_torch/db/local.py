"""SQLite thread store.

Parity: reference `LocalDBClient` (src/db/local.py:20-370) — same duck
type, same JSON-blob message storage model (messages are opaque OpenAI-wire
dicts in a `message` column; reference src/db/supabase.py:67).  Built on
the stdlib `sqlite3` driven through `asyncio.to_thread` (aiosqlite isn't in
this environment; a dedicated thread-per-call over one WAL-mode connection
is equally non-blocking for the event loop and dependency-free).

Extensions over the reference:
* `set_thread_config` — the reference's per-thread config lives in Supabase
  tables edited out-of-band (supabase.py:458-541); locally it must be
  settable through the client;
* schema versioning via `PRAGMA user_version` for forward migrations.
"""

from __future__ import annotations

import asyncio
import json
import os
import secrets
import sqlite3
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

from ..failpoints import failpoint
from .base import DBClient

_SCHEMA_VERSION = 2

_DDL = """
CREATE TABLE IF NOT EXISTS threads (
    thread_id TEXT PRIMARY KEY,
    created_at REAL NOT NULL,
    updated_at REAL NOT NULL,
    metadata TEXT NOT NULL DEFAULT '{}',
    sandbox_id TEXT,
    config TEXT
);
CREATE TABLE IF NOT EXISTS messages (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    thread_id TEXT NOT NULL,
    message TEXT NOT NULL,
    created_at REAL NOT NULL
);
CREATE INDEX IF NOT EXISTS idx_messages_thread
    ON messages (thread_id, id);
CREATE TABLE IF NOT EXISTS vm_api_keys (
    thread_id TEXT PRIMARY KEY,
    api_key TEXT NOT NULL,
    created_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS profiles (
    profile_id TEXT PRIMARY KEY,
    name TEXT NOT NULL,
    config TEXT NOT NULL DEFAULT '{}',
    created_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS users (
    user_id TEXT PRIMARY KEY,
    email TEXT NOT NULL UNIQUE,
    password_hash TEXT NOT NULL,
    salt TEXT NOT NULL,
    created_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS sessions (
    token TEXT PRIMARY KEY,
    user_id TEXT NOT NULL,
    created_at REAL NOT NULL,
    expires_at REAL NOT NULL
);
"""


class LocalDBClient(DBClient):
    def __init__(self, db_path: Optional[str] = None):
        self.db_path = db_path or os.environ.get(
            "KAFKA_TORCH_DB_PATH", "data/threads.db"
        )
        self._conn: Optional[sqlite3.Connection] = None
        # sqlite3 objects must be used from one thread unless serialized;
        # a single lock serializes all access (to_thread may use any worker)
        self._lock = threading.Lock()

    # -- plumbing ------------------------------------------------------

    async def initialize(self) -> None:
        await asyncio.to_thread(self._init_sync)

    def _init_sync(self) -> None:
        if self._conn is not None:
            return
        if self.db_path != ":memory:":
            parent = os.path.dirname(self.db_path)
            if parent:
                os.makedirs(parent, exist_ok=True)
        conn = sqlite3.connect(self.db_path, check_same_thread=False)
        conn.row_factory = sqlite3.Row
        conn.execute("PRAGMA journal_mode=WAL")
        conn.execute("PRAGMA synchronous=NORMAL")
        conn.executescript(_DDL)
        # v1 -> v2: thread ownership for session auth (nullable — threads
        # created without a session stay anonymous)
        cols = {r[1] for r in conn.execute("PRAGMA table_info(threads)")}
        if "user_id" not in cols:
            conn.execute("ALTER TABLE threads ADD COLUMN user_id TEXT")
        conn.execute(f"PRAGMA user_version={_SCHEMA_VERSION}")
        conn.commit()
        self._conn = conn

    async def close(self) -> None:
        def _close():
            with self._lock:
                if self._conn is not None:
                    self._conn.close()
                    self._conn = None

        await asyncio.to_thread(_close)

    def _execute(self, sql: str, params: tuple = (), fetch: Optional[str] = None):
        assert self._conn is not None, "call initialize() first"
        if not sql.lstrip().upper().startswith("SELECT"):
            failpoint("db.write")
        with self._lock:
            cur = self._conn.execute(sql, params)
            if fetch == "one":
                row = cur.fetchone()
            elif fetch == "all":
                row = cur.fetchall()
            else:
                row = None
            self._conn.commit()
            return row

    async def _run(self, sql: str, params: tuple = (), fetch: Optional[str] = None):
        return await asyncio.to_thread(self._execute, sql, params, fetch)

    # -- threads -------------------------------------------------------

    @staticmethod
    def _thread_row(r) -> Dict[str, Any]:
        return {
            "thread_id": r["thread_id"],
            "created_at": r["created_at"],
            "updated_at": r["updated_at"],
            "metadata": json.loads(r["metadata"]),
            "sandbox_id": r["sandbox_id"],
        }

    async def create_thread(
        self,
        thread_id: Optional[str] = None,
        metadata: Optional[Dict[str, Any]] = None,
    ) -> str:
        tid = thread_id or f"thread_{uuid.uuid4().hex[:24]}"
        now = time.time()
        await self._run(
            "INSERT OR IGNORE INTO threads "
            "(thread_id, created_at, updated_at, metadata) VALUES (?,?,?,?)",
            (tid, now, now, json.dumps(metadata or {})),
        )
        return tid

    async def thread_exists(self, thread_id: str) -> bool:
        row = await self._run(
            "SELECT 1 FROM threads WHERE thread_id=?", (thread_id,), "one"
        )
        return row is not None

    async def get_thread_metadata(
        self, thread_id: str
    ) -> Optional[Dict[str, Any]]:
        row = await self._run(
            "SELECT * FROM threads WHERE thread_id=?", (thread_id,), "one"
        )
        if row is None:
            return None
        return {
            "thread_id": row["thread_id"],
            "created_at": row["created_at"],
            "updated_at": row["updated_at"],
            "metadata": json.loads(row["metadata"]),
            "sandbox_id": row["sandbox_id"],
        }

    async def list_threads(self) -> List[Dict[str, Any]]:
        rows = await self._run(
            "SELECT thread_id, created_at, updated_at, metadata, sandbox_id "
            "FROM threads ORDER BY updated_at DESC",
            (), "all",
        )
        return [self._thread_row(r) for r in rows]

    async def delete_thread(self, thread_id: str) -> None:
        await self._run("DELETE FROM messages WHERE thread_id=?", (thread_id,))
        await self._run("DELETE FROM vm_api_keys WHERE thread_id=?", (thread_id,))
        await self._run("DELETE FROM threads WHERE thread_id=?", (thread_id,))

    # -- messages ------------------------------------------------------

    async def get_thread_messages(self, thread_id: str) -> List[Dict[str, Any]]:
        rows = await self._run(
            "SELECT message FROM messages WHERE thread_id=? ORDER BY id",
            (thread_id,), "all",
        )
        return [json.loads(r["message"]) for r in rows]

    async def add_message(self, thread_id: str, message: Dict[str, Any]) -> None:
        await self.add_messages(thread_id, [message])

    async def add_messages(
        self, thread_id: str, messages: List[Dict[str, Any]]
    ) -> None:
        if not messages:
            return
        now = time.time()

        def _insert():
            assert self._conn is not None
            with self._lock:
                self._conn.executemany(
                    "INSERT INTO messages (thread_id, message, created_at) "
                    "VALUES (?,?,?)",
                    [(thread_id, json.dumps(m), now) for m in messages],
                )
                self._conn.execute(
                    "UPDATE threads SET updated_at=? WHERE thread_id=?",
                    (now, thread_id),
                )
                self._conn.commit()

        await asyncio.to_thread(_insert)

    async def delete_thread_messages(self, thread_id: str) -> None:
        await self._run("DELETE FROM messages WHERE thread_id=?", (thread_id,))

    # -- sandbox affinity ---------------------------------------------

    async def get_thread_sandbox_id(self, thread_id: str) -> Optional[str]:
        row = await self._run(
            "SELECT sandbox_id FROM threads WHERE thread_id=?",
            (thread_id,), "one",
        )
        return row["sandbox_id"] if row else None

    async def update_thread_sandbox_id(
        self, thread_id: str, sandbox_id: Optional[str]
    ) -> None:
        await self._run(
            "UPDATE threads SET sandbox_id=?, updated_at=? WHERE thread_id=?",
            (sandbox_id, time.time(), thread_id),
        )

    # -- config / keys -------------------------------------------------

    async def get_thread_config(
        self, thread_id: str
    ) -> Optional[Dict[str, Any]]:
        row = await self._run(
            "SELECT config FROM threads WHERE thread_id=?", (thread_id,), "one"
        )
        if row is None or row["config"] is None:
            return None  # dev fallback, reference local.py:332-347
        return json.loads(row["config"])

    async def set_thread_config(
        self, thread_id: str, config: Optional[Dict[str, Any]]
    ) -> None:
        await self._run(
            "UPDATE threads SET config=?, updated_at=? WHERE thread_id=?",
            (None if config is None else json.dumps(config), time.time(),
             thread_id),
        )

    # -- profiles ------------------------------------------------------
    # The reference models multi-tenant profiles in Supabase (threads →
    # kafka_profiles → profiles joins, supabase.py:458-541); locally a
    # profile is a named config template a thread copies at creation.

    async def create_profile(
        self,
        name: str,
        config: Optional[Dict[str, Any]] = None,
        profile_id: Optional[str] = None,
    ) -> Dict[str, Any]:
        pid = profile_id or f"profile_{uuid.uuid4().hex[:16]}"
        now = time.time()
        await self._run(
            "INSERT OR REPLACE INTO profiles "
            "(profile_id, name, config, created_at) VALUES (?,?,?,?)",
            (pid, name, json.dumps(config or {}), now),
        )
        return {"profile_id": pid, "name": name, "config": config or {},
                "created_at": now}

    async def list_profiles(self) -> List[Dict[str, Any]]:
        rows = await self._run(
            "SELECT profile_id, name, config, created_at FROM profiles "
            "ORDER BY created_at", (), "all",
        )
        return [
            {"profile_id": r["profile_id"], "name": r["name"],
             "config": json.loads(r["config"]),
             "created_at": r["created_at"]}
            for r in (rows or [])
        ]

    async def get_profile(self, profile_id: str) -> Optional[Dict[str, Any]]:
        row = await self._run(
            "SELECT profile_id, name, config, created_at FROM profiles "
            "WHERE profile_id=?", (profile_id,), "one",
        )
        if row is None:
            return None
        return {"profile_id": row["profile_id"], "name": row["name"],
                "config": json.loads(row["config"]),
                "created_at": row["created_at"]}

    async def get_or_create_vm_api_key(self, thread_id: str) -> str:
        row = await self._run(
            "SELECT api_key FROM vm_api_keys WHERE thread_id=?",
            (thread_id,), "one",
        )
        if row is not None:
            return row["api_key"]
        key = f"vmk_{secrets.token_hex(24)}"
        # INSERT OR IGNORE + re-read keeps this race-safe across tasks
        await self._run(
            "INSERT OR IGNORE INTO vm_api_keys (thread_id, api_key, created_at) "
            "VALUES (?,?,?)",
            (thread_id, key, time.time()),
        )
        row = await self._run(
            "SELECT api_key FROM vm_api_keys WHERE thread_id=?",
            (thread_id,), "one",
        )
        return row["api_key"]

    # -- users / sessions (playground auth; base.py contract) -----------

    async def create_user(self, email: str, password_hash: str,
                          salt: str) -> str:
        uid = f"user_{uuid.uuid4().hex[:24]}"
        try:
            await self._run(
                "INSERT INTO users (user_id, email, password_hash, salt, "
                "created_at) VALUES (?,?,?,?,?)",
                (uid, email.lower(), password_hash, salt, time.time()),
            )
        except sqlite3.IntegrityError:
            raise ValueError(f"email already registered: {email}")
        return uid

    async def get_user_by_email(self, email: str):
        row = await self._run(
            "SELECT * FROM users WHERE email=?", (email.lower(),), "one"
        )
        if row is None:
            return None
        return {"user_id": row["user_id"], "email": row["email"],
                "password_hash": row["password_hash"], "salt": row["salt"]}

    async def create_session(self, user_id: str, token: str,
                             expires_at: float) -> None:
        await self._run(
            "INSERT INTO sessions (token, user_id, created_at, expires_at) "
            "VALUES (?,?,?,?)",
            (token, user_id, time.time(), expires_at),
        )

    async def get_session_user(self, token: str):
        row = await self._run(
            "SELECT user_id, expires_at FROM sessions WHERE token=?",
            (token,), "one",
        )
        if row is None or row["expires_at"] < time.time():
            return None
        return row["user_id"]

    async def set_thread_owner(self, thread_id: str, user_id: str) -> None:
        await self._run(
            "UPDATE threads SET user_id=? WHERE thread_id=?",
            (user_id, thread_id),
        )

    async def get_thread_owner(self, thread_id: str):
        row = await self._run(
            "SELECT user_id FROM threads WHERE thread_id=?",
            (thread_id,), "one",
        )
        return row["user_id"] if row is not None else None

    async def list_threads_for_user(self, user_id: str):
        rows = await self._run(
            "SELECT thread_id, created_at, updated_at, metadata, sandbox_id "
            "FROM threads WHERE user_id=? ORDER BY updated_at DESC",
            (user_id,), "all",
        )
        return [self._thread_row(r) for r in rows]

    async def list_threads_unowned(self):
        rows = await self._run(
            "SELECT thread_id, created_at, updated_at, metadata, sandbox_id "
            "FROM threads WHERE user_id IS NULL ORDER BY updated_at DESC",
            (), "all",
        )
        return [self._thread_row(r) for r in rows]
