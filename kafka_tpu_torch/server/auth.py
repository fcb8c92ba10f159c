"""Password + session-token primitives for the playground login.

The reference's playground authenticated users through Supabase email
sessions (playground/src/components/auth-provider.tsx:19-40) — an external
service.  Here the user store is the DB tier (db/base.py contract) and the
crypto is stdlib: scrypt password hashing with a per-user salt, and
unguessable urlsafe session tokens.  The server keeps its static
`api_token` tier (machine clients); session tokens are the human tier.
"""

from __future__ import annotations

import hashlib
import hmac
import secrets
import time

SESSION_TTL_S = 30 * 24 * 3600

# scrypt cost: interactive-login tier (~50 ms); N is the CPU/memory cost
_SCRYPT = dict(n=2**14, r=8, p=1)


def new_salt() -> str:
    return secrets.token_hex(16)


def hash_password(password: str, salt: str) -> str:
    return hashlib.scrypt(
        password.encode(), salt=bytes.fromhex(salt), **_SCRYPT
    ).hex()


def verify_password(password: str, salt: str, expected_hash: str) -> bool:
    got = hash_password(password, salt)
    return hmac.compare_digest(got, expected_hash)


def new_session_token() -> str:
    return f"sess_{secrets.token_urlsafe(32)}"


def session_expiry() -> float:
    return time.time() + SESSION_TTL_S
