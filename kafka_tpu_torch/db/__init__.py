"""Persistence tier: the thread/message store.

Copied from kafka_tpu/db: `LocalDBClient` over SQLite and
`RemoteDBClient` over any PostgREST / Supabase-dialect deployment, behind
one duck type (db/base.py).  `make_db_client()` picks by environment.
"""

import os
from typing import Optional

from .base import DBClient
from .local import LocalDBClient
from .remote import RemoteDBClient


def make_db_client(db_path: Optional[str] = None) -> DBClient:
    """Remote when KAFKA_TORCH_REMOTE_DB_URL is set, local SQLite
    otherwise."""
    url = os.environ.get("KAFKA_TORCH_REMOTE_DB_URL")
    if url:
        return RemoteDBClient(
            url, api_key=os.environ.get("KAFKA_TORCH_REMOTE_DB_KEY", ""))
    return LocalDBClient(db_path)


__all__ = ["DBClient", "LocalDBClient", "RemoteDBClient", "make_db_client"]
