"""Remote thread store: a PostgREST/Supabase-dialect HTTP client.

The reference ships two DB clients: SQLite for dev and a Supabase client
for production multi-tenant deployments (src/db/supabase.py:41-707).  This
is the port's remote half — the same duck-type as db/base.py over any
PostgREST-speaking deployment (Supabase included), with the reference's
semantics:

* threads / messages CRUD with JSON message payloads in `oai_messages`
  (reference :67, :202-234), including multi-part content flattening on
  read (:154-164);
* the thread-config join across threads → kafka_profiles → profiles →
  vm_api_keys yielding per-provider virtual keys, global_prompt,
  memory_dsn and the sandbox claim key (:458-541) — expressed as explicit
  follow-up queries rather than PostgREST resource embedding, so any
  plain PostgREST deployment works without FK-naming coupling;
* VM API key get-or-create: reuse the active key for a thread, otherwise
  mint one through the `generate_vm_api_key` RPC with a local-uuid
  fallback (:543-679);
* playbooks fetch by kafka profile (:681-707).

Auth follows the Supabase convention: `apikey` + `Authorization: Bearer`
headers carry the service key.  Configure with
KAFKA_TORCH_REMOTE_DB_URL / KAFKA_TORCH_REMOTE_DB_KEY (db.make_db_client()
picks this client up automatically when the URL is set).

Schema contract (what the deployment must provide)::

    threads       (id text pk, metadata jsonb, config jsonb,
                   sandbox_id text, user_id text, kafka_profile_id text,
                   vm_api_key_id text,
                   created_at timestamptz, updated_at timestamptz)
    oai_messages  (seq bigserial pk, thread_id text, message jsonb,
                   created_at timestamptz)
    vm_api_keys   (id text pk, thread_id text, api_key text, status text,
                   created_at timestamptz)
    kafka_profiles / profiles / playbooks per the reference schema.

`seq` being server-assigned (bigserial) is load-bearing: insertion order
must not depend on client clocks across replicas.
"""

from __future__ import annotations

import datetime
import logging
import time
import uuid
from typing import Any, Dict, List, Optional, Sequence

import httpx

from .base import DBClient

logger = logging.getLogger("kafka_tpu_torch.db.remote")


def _now_iso() -> str:
    """timestamptz-compatible UTC timestamp (Supabase schema convention;
    epoch floats would be rejected by PostgREST for timestamp columns)."""
    return datetime.datetime.now(datetime.timezone.utc).isoformat()


def _flatten_content(content: Any) -> Any:
    """Multi-part message content → text (reference supabase.py:154-164)."""
    if isinstance(content, list):
        parts = []
        for part in content:
            if isinstance(part, dict) and part.get("type") == "text":
                parts.append(part.get("text") or "")
            elif isinstance(part, str):
                parts.append(part)
        return "".join(parts)
    return content


class RemoteDBClient(DBClient):
    """DBClient over a PostgREST endpoint (Supabase-compatible)."""

    def __init__(
        self,
        base_url: str,
        api_key: str = "",
        *,
        threads_table: str = "threads",
        messages_table: str = "oai_messages",
        timeout: float = 15.0,
    ):
        self.base_url = base_url.rstrip("/")
        self.api_key = api_key
        self.threads_table = threads_table
        self.messages_table = messages_table
        headers = {"Content-Type": "application/json"}
        if api_key:
            headers["apikey"] = api_key
            headers["Authorization"] = f"Bearer {api_key}"
        self._client = httpx.AsyncClient(
            base_url=self.base_url, headers=headers, timeout=timeout
        )

    # -- REST helpers ----------------------------------------------------

    def _table(self, name: str) -> str:
        return f"/rest/v1/{name}"

    async def _select(
        self, table: str, filters: Dict[str, Any], select: str = "*",
        order: Optional[str] = None, limit: Optional[int] = None,
    ) -> List[Dict[str, Any]]:
        params: Dict[str, str] = {"select": select}
        for col, val in filters.items():
            params[col] = f"eq.{val}"
        if order:
            params["order"] = order
        if limit is not None:
            params["limit"] = str(limit)
        r = await self._client.get(self._table(table), params=params)
        r.raise_for_status()
        return r.json()

    async def _insert(
        self, table: str, rows: Sequence[Dict[str, Any]]
    ) -> List[Dict[str, Any]]:
        r = await self._client.post(
            self._table(table),
            json=list(rows),
            headers={"Prefer": "return=representation"},
        )
        r.raise_for_status()
        try:
            return r.json()
        except ValueError:
            return []

    async def _update(
        self, table: str, filters: Dict[str, Any], values: Dict[str, Any]
    ) -> None:
        params = {col: f"eq.{val}" for col, val in filters.items()}
        r = await self._client.patch(
            self._table(table), params=params, json=values
        )
        r.raise_for_status()

    async def _delete(self, table: str, filters: Dict[str, Any]) -> None:
        params = {col: f"eq.{val}" for col, val in filters.items()}
        r = await self._client.delete(self._table(table), params=params)
        r.raise_for_status()

    async def _rpc(self, fn: str, args: Dict[str, Any]) -> Any:
        r = await self._client.post(f"/rest/v1/rpc/{fn}", json=args)
        r.raise_for_status()
        try:
            return r.json()
        except ValueError:
            return None

    # -- lifecycle -------------------------------------------------------

    async def initialize(self) -> None:  # schema is owned by the deployment
        return None

    async def close(self) -> None:
        await self._client.aclose()

    # -- threads ---------------------------------------------------------

    async def create_thread(
        self,
        thread_id: Optional[str] = None,
        metadata: Optional[Dict[str, Any]] = None,
    ) -> str:
        tid = thread_id or f"thread_{uuid.uuid4().hex[:24]}"
        now = _now_iso()
        try:
            await self._insert(self.threads_table, [{
                "id": tid,
                "metadata": metadata or {},
                "created_at": now,
                "updated_at": now,
            }])
        except httpx.HTTPStatusError as e:
            # concurrent duplicate create: unique-key conflict is success
            # (idempotency the duck type promises, matching LocalDBClient)
            if e.response.status_code != 409:
                raise
        return tid

    @staticmethod
    def _thread_row(row: Dict[str, Any]) -> Dict[str, Any]:
        return {
            "thread_id": row.get("id"),
            "created_at": row.get("created_at"),
            "updated_at": row.get("updated_at"),
            "metadata": row.get("metadata") or {},
            "sandbox_id": row.get("sandbox_id"),
        }

    async def thread_exists(self, thread_id: str) -> bool:
        return bool(
            await self._select(self.threads_table, {"id": thread_id},
                               select="id", limit=1)
        )

    async def get_thread_metadata(
        self, thread_id: str
    ) -> Optional[Dict[str, Any]]:
        rows = await self._select(
            self.threads_table, {"id": thread_id}, limit=1
        )
        return self._thread_row(rows[0]) if rows else None

    async def list_threads(self) -> List[Dict[str, Any]]:
        rows = await self._select(
            self.threads_table, {}, order="updated_at.desc"
        )
        return [self._thread_row(r) for r in rows]

    async def delete_thread(self, thread_id: str) -> None:
        await self._delete(self.messages_table, {"thread_id": thread_id})
        # keys must die with the thread (credential hygiene; a recreated
        # thread id must never inherit the prior tenant's key) — matching
        # LocalDBClient.delete_thread
        await self._delete("vm_api_keys", {"thread_id": thread_id})
        await self._delete(self.threads_table, {"id": thread_id})

    # -- messages --------------------------------------------------------

    async def get_thread_messages(self, thread_id: str) -> List[Dict[str, Any]]:
        rows = await self._select(
            self.messages_table, {"thread_id": thread_id},
            select="message", order="seq.asc",
        )
        out = []
        for r in rows:
            msg = dict(r.get("message") or {})
            if "content" in msg:
                msg["content"] = _flatten_content(msg["content"])
            out.append(msg)
        return out

    async def add_message(self, thread_id: str, message: Dict[str, Any]) -> None:
        await self.add_messages(thread_id, [message])

    async def add_messages(
        self, thread_id: str, messages: Sequence[Dict[str, Any]]
    ) -> None:
        if not messages:
            return
        now = _now_iso()
        # seq is a server-side bigserial: insertion order is assigned by
        # the database, not client clocks (concurrent writers / replicas
        # with skew would otherwise scramble thread replay order)
        rows = [
            {"thread_id": thread_id, "message": dict(m), "created_at": now}
            for m in messages
        ]
        await self._insert(self.messages_table, rows)
        await self._update(
            self.threads_table, {"id": thread_id}, {"updated_at": now}
        )

    async def delete_thread_messages(self, thread_id: str) -> None:
        await self._delete(self.messages_table, {"thread_id": thread_id})

    # -- sandbox binding -------------------------------------------------

    async def get_thread_sandbox_id(self, thread_id: str) -> Optional[str]:
        rows = await self._select(
            self.threads_table, {"id": thread_id},
            select="sandbox_id", limit=1,
        )
        return rows[0].get("sandbox_id") if rows else None

    async def update_thread_sandbox_id(
        self, thread_id: str, sandbox_id: Optional[str]
    ) -> None:
        await self._update(
            self.threads_table, {"id": thread_id}, {"sandbox_id": sandbox_id}
        )

    # -- multi-tenant config (reference supabase.py:458-541) -------------

    async def get_thread_config(
        self, thread_id: str
    ) -> Optional[Dict[str, Any]]:
        rows = await self._select(
            self.threads_table, {"id": thread_id}, limit=1
        )
        if not rows:
            return None
        thread = rows[0]
        kp_id = thread.get("kafka_profile_id")
        vm_key_id = thread.get("vm_api_key_id")

        kafka_profile: Dict[str, Any] = {}
        if kp_id:
            kp = await self._select(
                "kafka_profiles", {"id": kp_id}, limit=1
            )
            kafka_profile = kp[0] if kp else {}

        profile: Dict[str, Any] = {}
        kp_user = kafka_profile.get("user_id")
        if kp_user:
            pr = await self._select("profiles", {"id": kp_user}, limit=1)
            profile = pr[0] if pr else {}

        vm_api_key = None
        if vm_key_id:
            vk = await self._select(
                "vm_api_keys", {"id": vm_key_id}, select="api_key", limit=1
            )
            vm_api_key = vk[0].get("api_key") if vk else None

        playbooks = await self.get_playbooks(kp_id) if kp_id else []

        out = {
            "thread_id": thread.get("id"),
            "user_id": thread.get("user_id"),
            "kafka_profile_id": kp_id,
            "memory_dsn": kafka_profile.get("memory_dsn"),
            "global_prompt": kafka_profile.get("global_prompt"),
            "model": kafka_profile.get("model"),
            "vm_api_key": vm_api_key,
            "playbooks": playbooks,
        }
        # per-thread overrides set through set_thread_config win over the
        # joined profile defaults
        out.update(thread.get("config") or {})
        return out

    _LINK_COLUMNS = ("kafka_profile_id", "vm_api_key_id", "user_id")

    async def set_thread_config(
        self, thread_id: str, config: Optional[Dict[str, Any]]
    ) -> None:
        """Replace the per-thread config overlay (None clears it).

        The `config` jsonb column is REPLACED wholesale — absent keys
        clear, and get_thread_config overlays it on the joined profile
        data.  The deployment-managed link columns (kafka_profile_id /
        vm_api_key_id / user_id) are different: they bind the thread to
        its tenant and sandbox credentials, so they update only when a
        key is EXPLICITLY present (pass an explicit null to detach) — a
        config write that merely sets e.g. a model override must never
        silently sever the thread's profile and VM key."""
        if config is None:
            await self._update(
                self.threads_table, {"id": thread_id}, {"config": None}
            )
            return
        values: Dict[str, Any] = {
            col: config[col] for col in self._LINK_COLUMNS if col in config
        }
        extra = {
            k: v for k, v in config.items() if k not in self._LINK_COLUMNS
        }
        values["config"] = extra or None
        await self._update(self.threads_table, {"id": thread_id}, values)

    async def get_playbooks(
        self, kafka_profile_id: str
    ) -> List[Dict[str, Any]]:
        """Playbooks attached to a kafka profile (reference :681-707)."""
        try:
            return await self._select(
                "playbooks", {"kafka_profile_id": kafka_profile_id},
                order="created_at.asc",
            )
        except httpx.HTTPStatusError:
            return []  # deployments without the table

    # -- VM API keys (reference supabase.py:543-679) ---------------------

    async def get_or_create_vm_api_key(self, thread_id: str) -> str:
        rows = await self._select(
            "vm_api_keys",
            {"thread_id": thread_id, "status": "active"},
            limit=1,
        )
        if rows:
            key = rows[0].get("api_key")
            if key:
                return key
        # mint through the deployment's keygen RPC; fall back to a local
        # uuid key (dev parity with the reference's fallback)
        key = None
        try:
            key = await self._rpc(
                "generate_vm_api_key", {"p_thread_id": thread_id}
            )
            if isinstance(key, dict):
                key = key.get("api_key")
        except httpx.HTTPError as e:
            logger.warning("vm key RPC failed (%s); using local key", e)
        if key:
            # bookkeeping insert is best-effort in its OWN failure domain:
            # a 409 (concurrent mint / RPC already persisted the row) means
            # an active key exists — return the authoritative stored one so
            # claim config and in-VM auth can never diverge
            try:
                await self._insert("vm_api_keys", [{
                    "id": str(uuid.uuid4()), "thread_id": thread_id,
                    "api_key": key, "status": "active",
                    "created_at": _now_iso(),
                }])
            except httpx.HTTPStatusError as e:
                if e.response.status_code == 409:
                    rows = await self._select(
                        "vm_api_keys",
                        {"thread_id": thread_id, "status": "active"},
                        limit=1,
                    )
                    if rows and rows[0].get("api_key"):
                        return str(rows[0]["api_key"])
            except httpx.HTTPError:
                pass  # RPC key is server-persisted; still valid
            return str(key)
        key = f"vm_{uuid.uuid4()}"
        try:
            await self._insert("vm_api_keys", [{
                "id": str(uuid.uuid4()), "thread_id": thread_id,
                "api_key": key, "status": "active",
                "created_at": _now_iso(),
            }])
        except httpx.HTTPError:
            pass  # key still usable for this process
        return key

    # -- users / sessions (db/base.py user-store contract) ---------------
    # PostgREST tables `users` and `sessions` mirror the local schema
    # (db/local.py DDL); the reference kept these inside Supabase's auth
    # service — here they are ordinary rows the same REST dialect reaches.

    async def create_user(self, email: str, password_hash: str,
                          salt: str) -> str:
        uid = f"user_{uuid.uuid4().hex[:24]}"
        try:
            await self._insert("users", [{
                "user_id": uid, "email": email.lower(),
                "password_hash": password_hash, "salt": salt,
                "created_at": _now_iso(),
            }])
        except httpx.HTTPStatusError as e:
            if e.response.status_code == 409:  # unique(email) violation
                raise ValueError(f"email already registered: {email}")
            raise
        return uid

    async def get_user_by_email(self, email: str):
        rows = await self._select("users", {"email": email.lower()}, limit=1)
        if not rows:
            return None
        r = rows[0]
        return {"user_id": r["user_id"], "email": r["email"],
                "password_hash": r["password_hash"], "salt": r["salt"]}

    async def create_session(self, user_id: str, token: str,
                             expires_at: float) -> None:
        # timestamptz columns want ISO (module convention, _now_iso):
        # convert the contract's epoch float before insert
        iso = datetime.datetime.fromtimestamp(
            expires_at, tz=datetime.timezone.utc
        ).isoformat()
        await self._insert("sessions", [{
            "token": token, "user_id": user_id,
            "created_at": _now_iso(), "expires_at": iso,
        }])

    async def get_session_user(self, token: str):
        rows = await self._select("sessions", {"token": token}, limit=1)
        if not rows:
            return None
        raw = rows[0]["expires_at"]
        try:
            exp = float(raw)  # double-precision schema
        except (TypeError, ValueError):
            exp = datetime.datetime.fromisoformat(
                str(raw).replace("Z", "+00:00")
            ).timestamp()
        if exp < time.time():
            return None
        return rows[0]["user_id"]

    async def set_thread_owner(self, thread_id: str, user_id: str) -> None:
        await self._update(
            self.threads_table, {"id": thread_id}, {"user_id": user_id}
        )

    async def get_thread_owner(self, thread_id: str):
        rows = await self._select(
            self.threads_table, {"id": thread_id}, select="user_id", limit=1
        )
        return rows[0].get("user_id") if rows else None

    async def list_threads_for_user(self, user_id: str):
        rows = await self._select(
            self.threads_table, {"user_id": user_id},
            order="updated_at.desc",
        )
        return [self._thread_row(r) for r in rows]

    async def list_threads_unowned(self):
        # null filter is `is.null`, not `eq.` — built outside _select
        r = await self._client.get(
            self._table(self.threads_table),
            params={"select": "*", "user_id": "is.null",
                    "order": "updated_at.desc"},
        )
        r.raise_for_status()
        return [self._thread_row(row) for row in r.json()]
