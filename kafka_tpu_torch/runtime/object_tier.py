"""Object-store KV tier: portable thread state below the host/disk tiers.

Counterpart of kafka_tpu/runtime/object_tier.py (its jax-free body,
copied; env knobs are KAFKA_TORCH_*).  Almost every server-side *thread*
is dormant at any moment, and a dormant thread's warm KV must outlive any
single host: the tier ladder of runtime/kv_tier.py stops at per-host
disk, so a host drain (scale-in, deploy, crash) would discard every
conversation it was keeping warm.  This module adds the missing rung — a
shared object store (S3/GCS-shaped interface, local-filesystem default)
mounted under :class:`~.kv_tier.KVTierManager` — and makes thread state
*portable*:

* **Content addressing.**  Run objects are keyed by a hash of the FULL
  token path from the radix root through the run (plus a pool-geometry
  fingerprint): a KV page's values depend on its entire prefix, so the
  prefix-inclusive hash is what makes two hosts' runs interchangeable.
  Identical prefixes (the fan-out system prompt) therefore deduplicate
  across hosts — the second host's put finds the object present and only
  adds a reference.  The fingerprint string and the payload format are
  the JAX package's, character for character, so both packages can share
  one store.
* **Refcount / ownership manifest.**  Every owner (one ObjectTier per
  engine, uuid-namespaced like the disk tier) marks the keys it
  references with a per-owner ref marker; an object is deleted only when
  the last reference drops.  Puts of the same content are concurrency-safe
  by construction: the payload write is atomic (tmp + rename) and
  idempotent (same key == same bytes).
* **Sleep manifests.**  A per-thread manifest (thread key -> ordered
  content-addressed run keys + the token path they cover) is written when
  a thread's state is demoted past disk — organically when the local
  ladder would otherwise DROP a run, and in full by
  ``PrefixCache.sleep_to_object()`` (the ``POST /admin/drain/{replica}``
  seam).  A dormant thread can then wake on ANY engine sharing the
  store: ``prefix_cache.lookup`` reads the manifest, fetches the runs,
  imports them into fresh pool pages and serves the hit with
  ``cache_source="object_tier"`` instead of re-prefilling the
  conversation.
* **Failure semantics.**  A torn put is discarded before the ref/manifest
  commit (atomic rename; the store never holds partial payloads).  A
  get miss or torn fetch aborts the WHOLE wake — every page allocated for
  it is freed — and the request degrades to the disk-tier/local hit or a
  plain re-prefill, never partial KV.  All store touch points are
  chaos-testable via the ``kv.object_put`` / ``kv.object_get`` /
  ``kv.object_head`` / ``kv.object_list`` failpoints.
* **Fault containment.**  The engine mounts the store behind
  :class:`~.store_guard.StoreGuard` (``build_object_store``): per-op
  deadlines, bounded retry with jitter (every protocol op is
  idempotent), and a consecutive-failure circuit breaker.  While the
  breaker is open ``available()`` is False and every consumer degrades
  instead of stalling — archive falls back to plain eviction, wake to
  local/disk/re-prefill, and drain returns partial results with honest
  accounting.  ``fsck`` walks refs<->objects<->manifests to repair the
  refcount protocol's crash windows.

With ``KAFKA_TORCH_KV_OBJECT_DIR`` set and no explicit
``KAFKA_TORCH_TRACE_PERSIST_DIR``, finished traces persist under
``<object_dir>/traces`` (tracing.py), so a thread's observability history
survives the host exactly like its KV does.
"""

from __future__ import annotations

import email.utils
import hashlib
import hmac
import http.client
import json
import logging
import os
import re
import threading
import time
import uuid
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple
from urllib.parse import quote, unquote, urlsplit

import numpy as np

from ..failpoints import failpoint
from .store_guard import BREAKER_OPEN, StoreGuard, StoreGuardError
from ..tracing import record_span, sanitize_stem

logger = logging.getLogger("kafka_tpu_torch.object_tier")

# Wake-prefetch staging budget (MiB).  0/unset = prefetch OFF
# (today's synchronous wake path, bit-identical).  When set, a sleep-
# manifest hit at SUBMIT time starts the object GETs on a bounded
# executor so the store RTT overlaps queue wait; prefix_cache.lookup
# consumes the staged payloads at admission instead of fetching.
ENV_WAKE_PREFETCH_MB = "KAFKA_TORCH_WAKE_PREFETCH_MB"
# Simple-vs-multipart PUT threshold for the S3-shaped HTTP backend
# (MiB).  0/unset = simple puts only.
# Payloads at or over the threshold upload as S3 multipart (initiate /
# UploadPart / complete) with abort-on-failure, closing the multi-GB-run
# gap — single-request puts of that size trip per-op deadlines and
# buffer the whole payload in one socket write.
ENV_OBJECT_MULTIPART_MB = "KAFKA_TORCH_KV_OBJECT_MULTIPART_MB"
# Folded into the content-address fingerprint: deployments sharing one
# bucket across model revisions (weights change, config doesn't) bump this
# to fence off incompatible KV.
ENV_OBJECT_NAMESPACE = "KAFKA_TORCH_KV_OBJECT_NAMESPACE"
# Real-bucket auth for the S3/GCS-shaped HTTP backend.
# "sigv4" signs every request AWS-SigV4 style from AWS_ACCESS_KEY_ID /
# AWS_SECRET_ACCESS_KEY (+ optional AWS_SESSION_TOKEN), region from
# KAFKA_TORCH_OBJECT_REGION or AWS_REGION (default us-east-1).  "bearer"
# attaches ``Authorization: Bearer`` from KAFKA_TORCH_OBJECT_BEARER_TOKEN
# (GCS JSON/XML API with an OAuth access token).  Unset = no auth
# (the in-cluster stub / pre-signed gateway case).  Missing credentials
# for a selected mode fail LOUDLY at mount, not with per-request 403s.
ENV_OBJECT_AUTH = "KAFKA_TORCH_OBJECT_AUTH"
ENV_OBJECT_REGION = "KAFKA_TORCH_OBJECT_REGION"
ENV_OBJECT_BEARER = "KAFKA_TORCH_OBJECT_BEARER_TOKEN"

MiB = 1024 * 1024

# How long a cached manifest read may skip re-validating the store head
# (seconds).  Submit-cadence probes and page-blocked admission retries
# must not turn into one store stat per scheduler tick; a refresh landing
# within the window is picked up at most this late — wakes degrade to
# re-prefill in the meantime, never to wrong KV.
_HEAD_TTL_S = 0.5

# Sentinel head-signature for a manifest probe that FAILED (store error,
# not a miss): cached like a signature, but served as a counted negative
# for the breaker's open window instead of _HEAD_TTL_S.
_PROBE_FAILED = object()

# Manifests refreshed per organic archive are capped to the node's most
# recent claimants: a fan-out shared node can carry hundreds of thread
# claims, and the eviction path must not turn one archive into hundreds of
# manifest writes.  The drain/sleep path covers every claimant exactly.
_ARCHIVE_MANIFEST_CAP = 32


def object_multipart_bytes() -> int:
    """Part size (bytes) above which HTTP puts switch to S3 multipart
    uploads; 0 (the default) keeps every put a single request."""
    try:
        mb = max(0, int(os.environ.get(ENV_OBJECT_MULTIPART_MB, "0") or 0))
    except ValueError:
        mb = 0
    return mb * MiB


# ---------------------------------------------------------------------------
# the store interface (S3/GCS-shaped) + the local-filesystem default
# ---------------------------------------------------------------------------


class ObjectStore:
    """Opaque-key byte store: the minimal surface a real S3/GCS backend
    implements.  Keys are relative "/"-separated paths chosen by the
    tier (hex digests + sanitized stems — never raw user input)."""

    def put(self, key: str, data: bytes) -> None:
        """Atomic full-object write (visible all-or-nothing)."""
        raise NotImplementedError

    def get(self, key: str) -> Optional[bytes]:
        """Full-object read; None when the key does not exist."""
        raise NotImplementedError

    def head(self, key: str) -> Optional[Tuple[int, float]]:
        """(size_bytes, mtime) when the key exists, else None."""
        raise NotImplementedError

    def delete(self, key: str) -> None:
        """Remove a key (idempotent; missing keys are a no-op)."""
        raise NotImplementedError

    def list(self, prefix: str) -> List[str]:
        """Keys under `prefix` (non-recursive listing is sufficient)."""
        raise NotImplementedError

    def usage(self) -> Tuple[int, int]:
        """(object_count, total_bytes) of run payloads in the store."""
        raise NotImplementedError

    def put_if_absent(self, key: str, data: bytes) -> bool:
        """Conditional write: create `key` only when absent; True when
        this call created it.  The refcount protocol's ref markers use
        this so re-marking is a no-op, not a rewrite.  Backends with a
        native conditional (S3 ``If-None-Match: *``) override; the
        default head-then-put is good enough for a same-content race
        (markers are empty, so the loser overwrites with equal bytes)."""
        if self.head(key) is not None:
            return False
        self.put(key, data)
        return True


class LocalFSObjectStore(ObjectStore):
    """Shared-directory object store: the default backend, and the shape
    replicas on ONE host (or a fleet over NFS/FUSE-mounted buckets) share.

    Safe for concurrent writers across processes: every put lands in a
    uuid-named temp file first and ``os.replace``s into place, so readers
    never observe a torn object and same-key races resolve to one winner
    with identical bytes (keys are content addresses)."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(os.path.join(root, ".tmp"), exist_ok=True)
        # usage() walks the objects dir; a short TTL bounds scrape cost
        self._usage_cache: Tuple[float, Tuple[int, int]] = (0.0, (0, 0))

    def _path(self, key: str) -> str:
        parts = [p for p in key.split("/") if p not in ("", ".", "..")]
        return os.path.join(self.root, *parts)

    def put(self, key: str, data: bytes) -> None:
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = os.path.join(self.root, ".tmp", uuid.uuid4().hex)
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)

    def get(self, key: str) -> Optional[bytes]:
        try:
            with open(self._path(key), "rb") as f:
                return f.read()
        except OSError:
            return None

    def head(self, key: str) -> Optional[Tuple[int, float]]:
        try:
            st = os.stat(self._path(key))
        except OSError:
            return None
        return st.st_size, st.st_mtime

    def delete(self, key: str) -> None:
        try:
            os.unlink(self._path(key))
        except OSError:
            pass

    def list(self, prefix: str) -> List[str]:
        path = self._path(prefix)
        try:
            names = os.listdir(path)
        except OSError:
            return []
        base = prefix.rstrip("/")
        return [f"{base}/{n}" for n in names]

    def usage(self) -> Tuple[int, int]:
        now = time.monotonic()
        ts, cached = self._usage_cache
        if now - ts < 1.0:
            return cached
        count = total = 0
        obj_dir = os.path.join(self.root, "objects")
        try:
            for name in os.listdir(obj_dir):
                try:
                    total += os.stat(os.path.join(obj_dir, name)).st_size
                    count += 1
                except OSError:
                    continue
        except OSError:
            pass
        self._usage_cache = (now, (count, total))
        return count, total


class _TornBodyError(OSError):
    """Response body did not match its declared Content-Length."""


def _sigv4_headers(
    method: str,
    host: str,
    path: str,
    headers: Dict[str, str],
    body: Optional[bytes],
    access_key: str,
    secret_key: str,
    region: str,
    session_token: str = "",
    now: Optional[time.struct_time] = None,
) -> Dict[str, str]:
    """AWS Signature Version 4 for one S3 request (stdlib-only).

    ``path`` is the request target as it goes on the wire (already
    percent-encoded key path plus raw query).  S3's canonical URI is the
    path VERBATIM (single-encoded — S3 is the one AWS service that does
    not double-encode); the canonical query re-normalizes each
    name/value through unquote->quote(safe="-_.~") so characters the
    caller encoded loosely (e.g. '/' in a list prefix) land in the
    canonical %2F form the service recomputes.  ``now`` pins the clock
    for tests."""
    amz_date = time.strftime("%Y%m%dT%H%M%SZ", now or time.gmtime())
    datestamp = amz_date[:8]
    payload_hash = hashlib.sha256(body or b"").hexdigest()
    raw_path, _, raw_query = path.partition("?")
    pairs = []
    for item in raw_query.split("&") if raw_query else []:
        name, _, value = item.partition("=")
        pairs.append((quote(unquote(name), safe="-_.~"),
                      quote(unquote(value), safe="-_.~")))
    pairs.sort()
    canonical_query = "&".join(f"{n}={v}" for n, v in pairs)
    to_sign = {
        "host": host,
        "x-amz-content-sha256": payload_hash,
        "x-amz-date": amz_date,
    }
    if session_token:
        to_sign["x-amz-security-token"] = session_token
    signed_names = ";".join(sorted(to_sign))
    canonical_headers = "".join(
        f"{k}:{to_sign[k]}\n" for k in sorted(to_sign)
    )
    canonical = "\n".join([
        method, raw_path, canonical_query, canonical_headers,
        signed_names, payload_hash,
    ])
    scope = f"{datestamp}/{region}/s3/aws4_request"
    string_to_sign = "\n".join([
        "AWS4-HMAC-SHA256", amz_date, scope,
        hashlib.sha256(canonical.encode()).hexdigest(),
    ])
    key = ("AWS4" + secret_key).encode()
    for part in (datestamp, region, "s3", "aws4_request"):
        key = hmac.new(key, part.encode(), hashlib.sha256).digest()
    signature = hmac.new(
        key, string_to_sign.encode(), hashlib.sha256
    ).hexdigest()
    out = dict(headers)
    # explicit Host: http.client must send EXACTLY the signed value
    out["Host"] = host
    out["x-amz-date"] = amz_date
    out["x-amz-content-sha256"] = payload_hash
    if session_token:
        out["x-amz-security-token"] = session_token
    out["Authorization"] = (
        f"AWS4-HMAC-SHA256 Credential={access_key}/{scope}, "
        f"SignedHeaders={signed_names}, Signature={signature}"
    )
    return out


def _load_object_auth() -> Tuple[str, Dict[str, str]]:
    """Resolve ENV_OBJECT_AUTH into (mode, credential kwargs)."""
    mode = os.environ.get(ENV_OBJECT_AUTH, "").strip().lower()
    if mode in ("", "none", "off"):
        return "", {}
    if mode == "sigv4":
        access = os.environ.get("AWS_ACCESS_KEY_ID", "")
        secret = os.environ.get("AWS_SECRET_ACCESS_KEY", "")
        if not access or not secret:
            raise ValueError(
                f"{ENV_OBJECT_AUTH}=sigv4 needs AWS_ACCESS_KEY_ID and "
                "AWS_SECRET_ACCESS_KEY in the environment"
            )
        return "sigv4", {
            "access_key": access,
            "secret_key": secret,
            "region": (os.environ.get(ENV_OBJECT_REGION)
                       or os.environ.get("AWS_REGION")
                       or "us-east-1"),
            "session_token": os.environ.get("AWS_SESSION_TOKEN", ""),
        }
    if mode == "bearer":
        token = os.environ.get(ENV_OBJECT_BEARER, "")
        if not token:
            raise ValueError(
                f"{ENV_OBJECT_AUTH}=bearer needs "
                f"{ENV_OBJECT_BEARER} in the environment"
            )
        return "bearer", {"token": token}
    raise ValueError(
        f"{ENV_OBJECT_AUTH} must be 'sigv4', 'bearer', or unset; "
        f"got {mode!r}"
    )


class HTTPObjectStore(ObjectStore):
    """S3-shaped HTTP backend: PUT/GET/HEAD/DELETE on ``<base>/<key>``
    plus ``GET <base>?list-type=2&prefix=`` XML listings, over a small
    pool of persistent connections.

    Conditional writes (``If-None-Match: *``, 412 = already
    present) implement the ref-marker protocol without read-modify-write,
    and every body is length-checked against Content-Length — a torn
    response is discarded and counted, never decoded.  Transport faults
    raise OSError so :class:`~.store_guard.StoreGuard` (which production
    mounts around this class) owns the retry/deadline/breaker policy;
    the only in-class retry is one fresh-connection replay when a POOLED
    connection turns out stale before any response bytes arrived."""

    def __init__(self, base_url: str, timeout_s: float = 10.0,
                 pool_size: int = 4):
        parts = urlsplit(base_url)
        if parts.scheme not in ("http", "https"):
            raise ValueError(f"HTTPObjectStore needs http(s) URL, got {base_url!r}")
        self._https = parts.scheme == "https"
        self._host = parts.hostname or "localhost"
        self._port = parts.port
        self._base = parts.path.rstrip("/")
        self.timeout_s = float(timeout_s)
        self._pool: List[http.client.HTTPConnection] = []
        self._pool_size = int(pool_size)
        self._pool_lock = threading.Lock()
        self.torn_bodies = 0  # length-mismatched responses discarded
        # S3 multipart threshold: bodies larger than this go
        # initiate/part/complete instead of one monolithic PUT.  0 = off.
        self.multipart_bytes = object_multipart_bytes()
        self.multipart_puts = 0    # objects landed via multipart
        self.multipart_aborts = 0  # failed uploads aborted server-side
        self._usage_cache: Tuple[float, Tuple[int, int]] = (0.0, (0, 0))
        # real-bucket auth: resolved once at mount so a
        # selected-but-unconfigured mode fails loudly here, not as a
        # stream of per-request 403s under traffic
        self._auth_mode, self._auth = _load_object_auth()

    # -- transport -----------------------------------------------------

    def _new_conn(self) -> http.client.HTTPConnection:
        cls = http.client.HTTPSConnection if self._https else http.client.HTTPConnection
        return cls(self._host, self._port, timeout=self.timeout_s)

    def _checkout(self) -> Optional[http.client.HTTPConnection]:
        with self._pool_lock:
            return self._pool.pop() if self._pool else None

    def _checkin(self, conn: http.client.HTTPConnection) -> None:
        with self._pool_lock:
            if len(self._pool) < self._pool_size:
                self._pool.append(conn)
                return
        conn.close()

    def _auth_host(self) -> str:
        """The Host header value as http.client would send it (port
        elided when default) — what SigV4 must sign."""
        default = 443 if self._https else 80
        if self._port and self._port != default:
            return f"{self._host}:{self._port}"
        return self._host

    def _authorize(
        self, method: str, path: str, body: Optional[bytes],
        headers: Optional[Dict[str, str]],
    ) -> Dict[str, str]:
        if self._auth_mode == "sigv4":
            return _sigv4_headers(
                method, self._auth_host(), path, headers or {}, body,
                **self._auth,
            )
        if self._auth_mode == "bearer":
            out = dict(headers or {})
            out["Authorization"] = "Bearer " + self._auth["token"]
            return out
        return headers or {}

    def _request(
        self, method: str, path: str, body: Optional[bytes] = None,
        headers: Optional[Dict[str, str]] = None,
    ) -> Tuple[int, Dict[str, str], bytes]:
        # sign once per logical request: the stale-connection replay
        # below reuses the signature (well inside S3's clock-skew window)
        headers = self._authorize(method, path, body, headers)
        for attempt in range(2):
            pooled = self._checkout()
            conn = pooled if pooled is not None else self._new_conn()
            try:
                conn.request(method, path, body=body, headers=headers or {})
                resp = conn.getresponse()
            except (http.client.HTTPException, OSError):
                # nothing of the response arrived: a stale keep-alive
                # connection is indistinguishable from a dead server, so
                # replay ONCE on a fresh connection, then surface
                conn.close()
                if pooled is None or attempt == 1:
                    raise
                continue
            try:
                data = resp.read()
            except http.client.IncompleteRead as e:
                self.torn_bodies += 1
                conn.close()
                raise _TornBodyError(
                    f"{method} {path}: torn body ({len(e.partial)} bytes)"
                ) from e
            except OSError:
                conn.close()
                raise
            clen = resp.getheader("Content-Length")
            if method != "HEAD" and clen is not None and int(clen) != len(data):
                self.torn_bodies += 1
                conn.close()
                raise _TornBodyError(
                    f"{method} {path}: body {len(data)}B != declared {clen}B"
                )
            if resp.will_close:
                conn.close()
            else:
                self._checkin(conn)
            return resp.status, {k.lower(): v for k, v in resp.getheaders()}, data
        raise OSError("unreachable")  # pragma: no cover

    def _key_path(self, key: str) -> str:
        parts = [p for p in key.split("/") if p not in ("", ".", "..")]
        return self._base + "/" + quote("/".join(parts))

    # -- ObjectStore surface -------------------------------------------

    def put(self, key: str, data: bytes) -> None:
        if self.multipart_bytes and len(data) > self.multipart_bytes:
            self._put_multipart(key, data)
            return
        status, _, _ = self._request(
            "PUT", self._key_path(key), body=data,
            headers={"Content-Type": "application/octet-stream"},
        )
        if status not in (200, 201, 204):
            raise OSError(f"PUT {key}: HTTP {status}")

    def _put_multipart(self, key: str, data: bytes) -> None:
        """S3 multipart upload: initiate, PUT parts of ``multipart_bytes``
        each, complete.  Any failure aborts the upload server-side and
        re-raises — S3 only materializes the object at Complete, so an
        aborted upload leaves no partial object and the operation stays
        idempotent under StoreGuard's retry (each attempt is a fresh
        UploadId; the winner's Complete is the only visible write)."""
        path = self._key_path(key)
        status, _, body = self._request(
            "POST", path + "?uploads",
            headers={"Content-Type": "application/octet-stream"},
        )
        if status != 200:
            raise OSError(f"multipart initiate {key}: HTTP {status}")
        m = re.search(r"<UploadId>([^<]+)</UploadId>",
                      body.decode("utf-8", "replace"))
        if m is None:
            raise OSError(f"multipart initiate {key}: no UploadId")
        uid = quote(m.group(1), safe="")
        try:
            parts: List[Tuple[int, str]] = []
            psize = self.multipart_bytes
            for off in range(0, len(data), psize):
                n = off // psize + 1
                status, hdrs, _ = self._request(
                    "PUT", f"{path}?partNumber={n}&uploadId={uid}",
                    body=data[off:off + psize],
                    headers={"Content-Type": "application/octet-stream"},
                )
                if status not in (200, 201, 204):
                    raise OSError(f"multipart part {n} of {key}: HTTP {status}")
                parts.append((n, hdrs.get("etag", "")))
            xml = "<CompleteMultipartUpload>" + "".join(
                f"<Part><PartNumber>{n}</PartNumber><ETag>{e}</ETag></Part>"
                for n, e in parts
            ) + "</CompleteMultipartUpload>"
            status, _, _ = self._request(
                "POST", f"{path}?uploadId={uid}", body=xml.encode(),
                headers={"Content-Type": "application/xml"},
            )
            if status != 200:
                raise OSError(f"multipart complete {key}: HTTP {status}")
        except Exception:
            self.multipart_aborts += 1
            try:
                self._request("DELETE", f"{path}?uploadId={uid}")
            except Exception:
                pass  # the abort is best-effort; orphaned uploads age out
            raise
        self.multipart_puts += 1

    def put_if_absent(self, key: str, data: bytes) -> bool:
        status, _, _ = self._request(
            "PUT", self._key_path(key), body=data,
            headers={"Content-Type": "application/octet-stream",
                     "If-None-Match": "*"},
        )
        if status == 412:
            return False  # already present: the marker stands
        if status not in (200, 201, 204):
            raise OSError(f"conditional PUT {key}: HTTP {status}")
        return True

    def get(self, key: str) -> Optional[bytes]:
        status, _, data = self._request("GET", self._key_path(key))
        if status == 404:
            return None
        if status != 200:
            raise OSError(f"GET {key}: HTTP {status}")
        return data

    def head(self, key: str) -> Optional[Tuple[int, float]]:
        status, headers, _ = self._request("HEAD", self._key_path(key))
        if status == 404:
            return None
        if status != 200:
            raise OSError(f"HEAD {key}: HTTP {status}")
        size = int(headers.get("content-length", 0))
        mtime = 0.0
        lm = headers.get("last-modified")
        if lm:
            try:
                mtime = email.utils.parsedate_to_datetime(lm).timestamp()
            except (TypeError, ValueError):
                mtime = 0.0
        return size, mtime

    def delete(self, key: str) -> None:
        status, _, _ = self._request("DELETE", self._key_path(key))
        if status not in (200, 202, 204, 404):
            raise OSError(f"DELETE {key}: HTTP {status}")

    def _list_entries(self, prefix: str) -> List[Tuple[str, int]]:
        # Real S3 truncates ListObjectsV2 at 1000 keys per page; a
        # partial view here would make fsck see live objects as orphans
        # (and usage() undercount), so follow the continuation chain
        # until <IsTruncated> goes false — and refuse to return a
        # listing the backend admits is incomplete.
        out: List[Tuple[str, int]] = []
        token: Optional[str] = None
        while True:
            path = f"{self._base or '/'}?list-type=2&prefix={quote(prefix)}"
            if token is not None:
                path += f"&continuation-token={quote(token, safe='')}"
            status, _, data = self._request("GET", path)
            if status != 200:
                raise OSError(f"LIST {prefix}: HTTP {status}")
            text = data.decode("utf-8", "replace")
            for m in re.finditer(
                r"<Contents>.*?<Key>([^<]*)</Key>(?:.*?<Size>(\d+)</Size>)?.*?</Contents>",
                text, re.S,
            ):
                out.append((m.group(1), int(m.group(2) or 0)))
            if not re.search(r"<IsTruncated>\s*true\s*</IsTruncated>", text):
                return out
            nxt = re.search(
                r"<NextContinuationToken>([^<]+)</NextContinuationToken>",
                text,
            )
            if nxt is None or nxt.group(1) == token:
                raise OSError(
                    f"LIST {prefix}: truncated listing without a fresh "
                    "continuation token — refusing to act on a partial view"
                )
            token = nxt.group(1)

    def list(self, prefix: str) -> List[str]:
        # S3 has no directories: a prefix listing is recursive, which is
        # a superset of LocalFS's one-level listing — every consumer
        # (release's ref scan, fsck's walk) treats it as "keys under"
        return [k for k, _ in self._list_entries(prefix)]

    def usage(self) -> Tuple[int, int]:
        now = time.monotonic()
        ts, cached = self._usage_cache
        if now - ts < 1.0:
            return cached
        entries = self._list_entries("objects/")
        out = (len(entries), sum(s for _, s in entries))
        self._usage_cache = (now, out)
        return out


def build_object_store(spec: str) -> StoreGuard:
    """The engine's store constructor: ``http(s)://…`` mounts the
    S3-shaped backend, anything else is a shared directory — and either
    way the store is wrapped in a StoreGuard configured from the
    ``KAFKA_TORCH_KV_OBJECT_*`` env knobs, so a dead or slow backend costs
    warm-resume TTFT, never liveness."""
    inner: ObjectStore
    if spec.startswith(("http://", "https://")):
        inner = HTTPObjectStore(spec)
    else:
        inner = LocalFSObjectStore(spec)
    return StoreGuard.from_env(inner)


# ---------------------------------------------------------------------------
# run payload serialization: the disk tier's wire format, verbatim
# (kv_tier.encode_run_npz/decode_run_npz — ONE format, no drift)
# ---------------------------------------------------------------------------


def _encode_run(k_leaves: Sequence[np.ndarray],
                v_leaves: Sequence[np.ndarray], n_pages: int) -> bytes:
    from .kv_tier import encode_run_npz

    return encode_run_npz(k_leaves, v_leaves, n_pages)


def _decode_run(data: bytes) -> Tuple[List[np.ndarray], List[np.ndarray], int]:
    from .kv_tier import decode_run_npz

    return decode_run_npz(data)


# ---------------------------------------------------------------------------
# wake prefetch
# ---------------------------------------------------------------------------


class _StagedRun:
    """One prefetched run: inflight until ``event`` sets, then staged
    (payload present) or failed (payload None).  ``doomed`` marks a
    cancelled thread's entries — the worker drops the payload instead of
    staging it."""

    __slots__ = ("thread_key", "event", "payload", "nbytes", "started",
                 "doomed")

    def __init__(self, thread_key: str):
        self.thread_key = thread_key
        self.event = threading.Event()
        self.payload: Optional[Tuple[List[np.ndarray], List[np.ndarray],
                                     int, int]] = None
        self.nbytes = 0
        self.started = False
        self.doomed = False


class WakePrefetcher:
    """Start a sleeping thread's object GETs at SUBMIT time so the store
    RTT overlaps queue wait — the same overlap the host tier's
    promotion gets from enqueueing H2D ahead of the suffix prefill.

    Staging protocol: a tool's return hint (the engine's
    note_tool_return) or a multi-run wake schedules one fetch
    per PRESENT manifest run (single-flight per content key — a fan-out
    of requests for one thread schedules each run once) on a bounded
    executor; workers fetch through :meth:`ObjectTier.get_run`, so the
    existing accounting, failpoints, and StoreGuard policy all apply
    unchanged.  ``prefix_cache.lookup`` consumes staged payloads through
    :meth:`ObjectTier.fetch_run`: a ready payload is a prefetch HIT
    (zero fetch RTT inside admission), an inflight one is awaited (never
    slower than fetching synchronously — the GET is already closer to
    done), a queued-but-unstarted or missing one falls back to the
    synchronous fetch.

    Failure semantics: prefetch is an overlap optimization, never a
    correctness dependency.  A failed or cancelled prefetch degrades to
    the synchronous path; a dead store degrades at the scheduling gate
    (breaker-aware: no fetches are even queued while
    ``tier.available()`` is False).  Staged-but-never-consumed payloads
    are evicted oldest-first past the byte budget and counted
    ``prefetch_wasted``.
    """

    def __init__(self, tier: "ObjectTier", budget_bytes: int,
                 workers: int = 4):
        import concurrent.futures

        self.tier = tier
        self.budget_bytes = int(budget_bytes)
        self._lock = threading.Lock()
        self._staged: "OrderedDict[str, _StagedRun]" = OrderedDict()
        self._staged_bytes = 0
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=workers, thread_name_prefix="kv-prefetch"
        )
        self._closed = False

    @classmethod
    def from_env(cls, tier: "ObjectTier") -> Optional["WakePrefetcher"]:
        try:
            mb = max(0, int(os.environ.get(ENV_WAKE_PREFETCH_MB, "0") or 0))
        except ValueError:
            mb = 0
        if mb <= 0:
            return None
        return cls(tier, mb * MiB)

    # -- scheduling (the return hint) ---------------------------------

    def prefetch_thread(self, thread_key: str, min_depth: int = 0) -> bool:
        """Kick off prefetch for the thread's manifest without blocking the
        caller (the engine thread calls this on a tool's return, so even the
        manifest read — a store round trip when the head-sig memo is cold —
        must happen off-thread).  ``min_depth`` is the replica's local radix
        match: runs wholly covered by it are skipped, since a wake would
        skip them too.  Returns whether scheduling was accepted."""
        if self._closed or not self.tier.available():
            return False  # breaker open: degrade to the synchronous path
        try:
            self._pool.submit(self._schedule, thread_key, min_depth)
        except RuntimeError:  # executor shut down
            return False
        return True

    def _schedule(self, thread_key: str, min_depth: int) -> None:
        try:
            man = self.tier.read_manifest(thread_key)
            if man is None:
                return
            depth = self.tier._wakeable_depth(thread_key, man)
            covered = 0
            for r in man.get("runs") or []:
                covered += int(r.get("tokens", 0))
                if covered > depth:
                    break  # absent past here: a wake would truncate anyway
                if covered <= min_depth:
                    continue  # locally cached: the wake skips these runs
                key = r.get("key")
                if key:
                    self._begin(key, thread_key)
        except Exception as e:
            logger.warning("wake prefetch scheduling for %r failed: %s",
                           thread_key, e)

    def stage_runs(self, run_keys: Sequence[str], thread_key: str) -> None:
        """Begin staging an imminent wake's full run list: the wake loop
        consumes them in order while the GETs proceed in parallel on the
        pool, so a multi-run wake pays ~one store RTT instead of one per
        run.  Single-flight with any hint-kicked prefetch of the same
        content; entries the budget rejects simply fall back to the
        caller's serial fetch."""
        if self._closed:
            return
        for k in run_keys:
            self._begin(k, thread_key)

    def _begin(self, key: str, thread_key: str) -> bool:
        with self._lock:
            if key in self._staged:
                return False  # single-flight per content key
            if (self.budget_bytes
                    and self._staged_bytes >= self.budget_bytes):
                return False  # staging full: don't queue doomed work
            ent = _StagedRun(thread_key)
            self._staged[key] = ent
        try:
            self._pool.submit(self._fetch, key, ent)
        except RuntimeError:  # executor shut down
            with self._lock:
                if self._staged.get(key) is ent:
                    del self._staged[key]
            return False
        return True

    # -- the worker ----------------------------------------------------

    def _fetch(self, key: str, ent: _StagedRun) -> None:
        with self._lock:
            if self._staged.get(key) is not ent or ent.doomed:
                # reclaimed/cancelled before the fetch started (take()
                # dooms unstarted entries it hands to the sync path)
                if self._staged.get(key) is ent:
                    del self._staged[key]
                ent.event.set()
                return
            ent.started = True
        t0 = time.monotonic()
        got = None
        try:
            failpoint("kv.prefetch")
            got = self.tier.get_run(key)
        except Exception as e:  # injected faults included: degrade
            logger.warning("wake prefetch of run %s failed: %s", key, e)
        nbytes = got[3] if got is not None else 0
        with self._lock:
            ent2 = self._staged.get(key)
            if ent2 is not ent:
                # superseded: take() reclaimed this entry for the sync
                # path (or cancel dropped it) and a fresh fetch restaged
                # the key — never touch the newer entry
                if got is not None:
                    self.tier.prefetch_wasted += 1
            elif ent.doomed or got is None:
                # cancelled mid-flight or failed: never staged
                self._staged.pop(key, None)
                if got is not None:
                    self.tier.prefetch_wasted += 1
            else:
                ent.payload = got
                ent.nbytes = nbytes
                self._staged_bytes += nbytes
                self.tier.prefetch_bytes += nbytes
                self._evict_over_budget_locked()
            ent.event.set()
        record_span(
            self.tier._ctx(), "kv.prefetch", time.monotonic() - t0,
            attrs={"bytes": nbytes, "thread": ent.thread_key,
                   "hit": got is not None and not ent.doomed},
        )

    def _evict_over_budget_locked(self) -> None:
        """Oldest-staged-first eviction past the byte budget (callers
        hold the lock).  Only READY payloads evict — an inflight entry
        holds no bytes yet."""
        if not self.budget_bytes:
            return
        for key in list(self._staged):
            if self._staged_bytes <= self.budget_bytes:
                return
            ent = self._staged[key]
            if ent.payload is None:
                continue
            del self._staged[key]
            self._staged_bytes -= ent.nbytes
            self.tier.prefetch_wasted += 1

    # -- consumption (prefix_cache admission path) ---------------------

    def take(
        self, key: str
    ) -> Optional[Tuple[List[np.ndarray], List[np.ndarray], int, int]]:
        """Consume the staged payload for `key`, waiting out an inflight
        fetch.  None = not prefetched (or failed/cancelled/unstarted):
        the caller fetches synchronously, exactly today's path."""
        with self._lock:
            ent = self._staged.get(key)
            if ent is None:
                return None
            if not ent.started and not ent.event.is_set():
                # still queued behind other fetches: waiting could be
                # SLOWER than fetching now — reclaim it for the sync path
                ent.doomed = True
                del self._staged[key]
                return None
        ent.event.wait()
        with self._lock:
            if self._staged.get(key) is not ent or ent.payload is None:
                # failed, cancelled, or budget-evicted while we waited
                if self._staged.get(key) is ent:
                    del self._staged[key]
                return None
            del self._staged[key]
            self._staged_bytes -= ent.nbytes
        self.tier.prefetch_hits += 1
        return ent.payload

    # -- cancellation / introspection ----------------------------------

    def cancel_thread(self, thread_key: str) -> None:
        """Doom every entry staged for `thread_key` (request cancelled
        before admission): ready payloads drop now and count wasted,
        inflight fetches drop at completion."""
        with self._lock:
            for key in list(self._staged):
                ent = self._staged[key]
                if ent.thread_key != thread_key:
                    continue
                ent.doomed = True
                if ent.payload is not None:
                    del self._staged[key]
                    self._staged_bytes -= ent.nbytes
                    self.tier.prefetch_wasted += 1

    def inflight(self) -> int:
        """Fetches scheduled but not yet resolved (the gauge)."""
        with self._lock:
            return sum(
                1 for e in self._staged.values() if not e.event.is_set()
            )

    def staged_bytes(self) -> int:
        with self._lock:
            return self._staged_bytes

    def staged_bytes_for(self, thread_key: str) -> int:
        """Ready staged bytes for one thread (the lane-table column)."""
        with self._lock:
            return sum(
                e.nbytes for e in self._staged.values()
                if e.thread_key == thread_key and e.payload is not None
            )

    def close(self) -> None:
        self._closed = True
        self._pool.shutdown(wait=False)
        with self._lock:
            self._staged.clear()
            self._staged_bytes = 0


# ---------------------------------------------------------------------------
# the tier
# ---------------------------------------------------------------------------


class ObjectTier:
    """Policy layer over an :class:`ObjectStore`: content addressing,
    per-owner refcounting, sleep manifests, budget enforcement, and the
    OBJECT_TIER_METRIC_KEYS counters.

    One instance per engine replica (mounted by
    ``KVTierManager.attach_object``); many instances — across processes
    and hosts — share one store.  Mutating entry points run on the engine
    thread (the tier manager's single-writer contract); ``snapshot()``
    and the router's manifest probes are torn-tolerant reads.
    """

    def __init__(self, store: ObjectStore, budget_bytes: int = 0,
                 fingerprint: str = "", page_size: int = 16):
        self.store = store
        # The engine mounts a StoreGuard (build_object_store); bare
        # stores (unit tests, fsck) get no breaker and available() is
        # always True.  Never auto-wrap here — tests poke store internals.
        self.guard: Optional[StoreGuard] = (
            store if isinstance(store, StoreGuard) else None
        )
        # 0 = unbounded.  The budget bounds the bytes THIS OWNER holds
        # references on — a shared store is only ever shrunk through the
        # refcount protocol, never by one owner deleting another's state.
        self.budget_bytes = int(budget_bytes)
        self.fingerprint = fingerprint
        self.page_size = page_size
        self._uid = uuid.uuid4().hex[:12]
        self._lock = threading.Lock()
        # second-chance LRU over the keys this owner references
        self._owned: "OrderedDict[str, int]" = OrderedDict()  # key -> bytes
        self._ref_bits: Dict[str, bool] = {}
        self.owned_bytes = 0
        # manifest read cache: thread key -> [head signature, doc,
        # wakeable-depth memo] (the depth is computed lazily and
        # invalidated with the signature)
        self._manifest_cache: "OrderedDict[str, List[Any]]" = (
            OrderedDict()
        )
        self._manifest_cache_cap = 256
        # kv.object_* spans attach to the owning manager's trace context
        self.manager: Optional[Any] = None
        self.trace_ctx = None
        # counters (OBJECT_TIER_METRIC_KEYS)
        self.object_puts = 0
        self.object_put_failures = 0
        self.object_bytes_put = 0
        self.object_gets = 0
        self.object_get_failures = 0
        self.object_bytes_got = 0
        self.dedupe_hits = 0
        self.wake_threads = 0
        self.wake_tokens = 0
        self.manifests_written = 0
        self.objects_released = 0
        self.probe_neg_cached = 0
        self.scrub_repairs = 0
        # wake prefetch: attached by the engine when
        # KAFKA_TORCH_WAKE_PREFETCH_MB is set; counters stay zero (and
        # fetch_run degenerates to get_run) without it
        self.prefetcher: Optional[WakePrefetcher] = None
        self.prefetch_hits = 0
        self.prefetch_wasted = 0
        self.prefetch_bytes = 0
        # opt-in background janitor (start_janitor)
        self._janitor: Optional[threading.Thread] = None
        self._janitor_stop = threading.Event()

    # -- plumbing --------------------------------------------------------

    def _ctx(self):
        if self.manager is not None:
            return self.manager.trace_ctx
        return self.trace_ctx

    # -- fault containment ----------------------------------------------

    def available(self) -> bool:
        """False while the guard's breaker is OPEN: consumers use this to
        degrade cheaply (plain eviction, re-prefill, zero-RTT routing)
        instead of paying a doomed store op — and, on the archive path,
        instead of paying the D2H gather + encode for a put that cannot
        land.  Half-open counts as available: the single probe is how
        the breaker discovers recovery."""
        return self.guard is None or self.guard.breaker.state != BREAKER_OPEN

    def breaker_state(self) -> str:
        return self.guard.breaker.state if self.guard is not None else "closed"

    def _note_store_failure(self, e: BaseException) -> None:
        """Forward a tier-level store failure to the guard's breaker.
        Guard-typed exceptions were already recorded inside the guard
        (counting them twice would double the trip rate); everything
        else — including injected ``kv.object_*`` failpoint faults, which
        fire BEFORE the guard — is fresh evidence the store is sick."""
        if self.guard is not None and not isinstance(e, StoreGuardError):
            self.guard.breaker.record_failure()

    def _probe_failure_ttl(self) -> float:
        """How long a FAILED manifest head probe is negatively cached.
        Evaluated at READ time against the breaker's CURRENT state: while
        the breaker is actually OPEN the store is presumed down for the
        whole open window, so the negative hit answers for that long; an
        isolated blip with a closed (or recovered) breaker only hides
        warm state for the ordinary head TTL."""
        if self.guard is not None and self.guard.breaker.state == BREAKER_OPEN:
            return max(_HEAD_TTL_S, self.guard.breaker.open_window_s)
        return _HEAD_TTL_S

    # -- content addressing ----------------------------------------------

    def run_key(self, path_tokens: Sequence[int], n_pages: int) -> str:
        """Content address of a run: the FULL token path from the radix
        root through the run's last token, plus the run's own START
        boundary, plus the pool-geometry fingerprint.  KV values depend
        on their entire prefix, so the prefix-inclusive hash is what
        makes runs host-interchangeable — and the start boundary is what
        keeps a SPLIT run's back half (same full path, fewer own pages)
        from colliding with the unsplit whole: without it, a dedupe
        could bind a 4-page node to an 8-page object and a later promote
        would silently import the wrong half's KV."""
        start = len(path_tokens) - n_pages * self.page_size
        h = hashlib.sha256()
        h.update(self.fingerprint.encode())
        h.update(b"|")
        h.update(np.asarray(list(path_tokens), np.int64).tobytes())
        h.update(b"|")
        h.update(str(start).encode())
        return h.hexdigest()

    @staticmethod
    def _object_key(key: str) -> str:
        return f"objects/{key}.npz"

    def _ref_key(self, key: str) -> str:
        return f"refs/{key}/{self._uid}"

    def manifest_runs(
        self, path_runs: Sequence[Sequence[int]]
    ) -> List[Dict[str, Any]]:
        """The manifest "runs" entries for a root-anchored run path:
        cumulative content keys + per-run token counts."""
        out: List[Dict[str, Any]] = []
        acc: List[int] = []
        for seg in path_runs:
            acc.extend(seg)
            out.append({
                "key": self.run_key(acc, len(seg) // self.page_size),
                "tokens": len(seg),
            })
        return out

    # -- runs ------------------------------------------------------------

    def has_run(self, key: str) -> bool:
        try:
            failpoint("kv.object_head")
            return self.store.head(self._object_key(key)) is not None
        except Exception as e:
            self._note_store_failure(e)
            return False  # absent-shaped: wake truncates, routing skips

    def _own(self, key: str, nbytes: int) -> None:
        with self._lock:
            if key in self._owned:
                self._owned.move_to_end(key)
                self._ref_bits[key] = True
                return
            self._owned[key] = nbytes
            self._ref_bits[key] = False
            self.owned_bytes += nbytes
        try:
            self.store.put_if_absent(self._ref_key(key), b"")
        except Exception as e:
            # the local reference stands; the missing store-side marker
            # is a crash-window orphan the scrubber (fsck) repairs
            self._note_store_failure(e)
            logger.warning("object ref marker for %s failed: %s", key, e)

    def put_run(
        self,
        path_tokens: Sequence[int],
        k_leaves: Optional[Sequence[np.ndarray]],
        v_leaves: Optional[Sequence[np.ndarray]],
        n_pages: int,
    ) -> Optional[str]:
        """Archive one run under its content address.  Returns the run
        key, or None on failure (the caller degrades — plain eviction or
        a skipped sleep entry).  A put of content already present is a
        DEDUPE: no payload moves, only this owner's reference is added.
        ``k_leaves=None`` is the reference-only form (the sleep path uses
        it when the content is known present).  The torn-write contract:
        the failpoint fires before anything is written, and the payload
        write itself is atomic — a failed put leaves no partial object
        and no reference."""
        key = self.run_key(path_tokens, n_pages)
        okey = self._object_key(key)
        t0 = time.monotonic()
        try:
            failpoint("kv.object_put")
            head = self.store.head(okey)
            if head is not None:
                self.dedupe_hits += 1
                self._own(key, head[0])
                # a dedupe still grows THIS owner's reference set, so
                # the budget applies exactly like a payload write
                self._enforce_budget()
                return key
            if k_leaves is None:
                return None  # reference-only put of absent content
            data = _encode_run(k_leaves, v_leaves, n_pages)
            self.store.put(okey, data)
        except Exception as e:
            self.object_put_failures += 1
            self._note_store_failure(e)
            logger.warning("object put of %d-page run failed: %s",
                           n_pages, e)
            return None
        self._own(key, len(data))
        self.object_puts += 1
        self.object_bytes_put += len(data)
        record_span(
            self._ctx(), "kv.object_put", time.monotonic() - t0,
            attrs={"bytes": len(data), "pages": n_pages},
        )
        self._enforce_budget()
        return key

    def get_run(
        self, key: str
    ) -> Optional[Tuple[List[np.ndarray], List[np.ndarray], int, int]]:
        """Fetch one run payload: (k_leaves, v_leaves, n_pages, nbytes),
        or None on miss/corruption — the caller aborts the wake and
        degrades to disk-tier-then-re-prefill."""
        t0 = time.monotonic()
        try:
            failpoint("kv.object_get")
            data = self.store.get(self._object_key(key))
        except Exception as e:
            self.object_get_failures += 1
            self._note_store_failure(e)
            logger.warning("object get of run %s failed: %s", key, e)
            return None
        if data is None:
            self.object_get_failures += 1
            return None
        try:
            k_leaves, v_leaves, n_pages = _decode_run(data)
        except Exception as e:
            self.object_get_failures += 1
            logger.warning("object run %s is corrupt: %s", key, e)
            return None
        with self._lock:
            if key in self._owned:
                self._ref_bits[key] = True
                self._owned.move_to_end(key)
        self.object_gets += 1
        self.object_bytes_got += len(data)
        record_span(
            self._ctx(), "kv.object_get", time.monotonic() - t0,
            attrs={"bytes": len(data), "pages": n_pages,
                   "source": "object_tier"},
        )
        return k_leaves, v_leaves, n_pages, len(data)

    def fetch_run(
        self, key: str
    ) -> Optional[Tuple[List[np.ndarray], List[np.ndarray], int, int]]:
        """The wake path's fetch entry point: consume a staged prefetch
        payload when one is ready, otherwise fetch exactly
        like :meth:`get_run`.  Identical signature and failure shape."""
        p = self.prefetcher
        if p is not None:
            got = p.take(key)
            if got is not None:
                return got
        return self.get_run(key)

    def release(self, key: str) -> None:
        """Drop this owner's reference; delete the object when it was the
        last one.  Never touches keys other owners still reference."""
        with self._lock:
            nbytes = self._owned.pop(key, None)
            self._ref_bits.pop(key, None)
            if nbytes is not None:
                self.owned_bytes -= nbytes
        try:
            failpoint("kv.object_list")
            self.store.delete(self._ref_key(key))
            if not self.store.list(f"refs/{key}/"):
                self.store.delete(self._object_key(key))
        except Exception as e:
            # the local reference is gone either way; a marker (or a
            # now-refless object) left behind on a dead store is a
            # crash-window orphan the scrubber repairs after the grace
            # window — never a correctness problem, only garbage
            self._note_store_failure(e)
            logger.warning("object release of %s failed: %s", key, e)
        self.objects_released += 1

    def _enforce_budget(self) -> None:
        """Second-chance LRU over this owner's references: a referenced
        (recently-fetched) key gets one more cycle, then the reference
        drops (and the object, when nobody else holds one)."""
        if self.budget_bytes <= 0:
            return
        scanned = 0
        while True:
            with self._lock:
                if self.owned_bytes <= self.budget_bytes or not self._owned:
                    return
                victim = next(iter(self._owned))
                if self._ref_bits.get(victim) and scanned < len(self._owned):
                    self._ref_bits[victim] = False
                    self._owned.move_to_end(victim)
                    scanned += 1
                    continue
            scanned = 0
            self.release(victim)

    # -- sleep manifests -------------------------------------------------

    def _manifest_store_key(self, thread_key: str) -> str:
        # the fingerprint digest scopes the manifest like the run keys:
        # two model revisions sharing one bucket must not clobber each
        # other's manifests for the same thread (the loser's dormant
        # conversation would silently re-prefill in full)
        fp = hashlib.sha256(self.fingerprint.encode()).hexdigest()[:8]
        return f"threads/{sanitize_stem(thread_key)}.{fp}.json"

    def write_manifest(
        self,
        thread_key: str,
        tokens: Sequence[int],
        runs: List[Dict[str, Any]],
        meta: Optional[Dict[str, Any]] = None,
    ) -> bool:
        """Write/refresh one thread's sleep manifest (atomic: a torn
        write leaves the previous manifest intact).  An existing manifest
        that already covers these tokens AND MORE is kept — eviction is
        leaf-first, so the deepest archive writes first and shallower
        ancestors' archives must not truncate it."""
        tokens = list(tokens)
        existing = self.read_manifest(thread_key)
        if (
            existing is not None
            and len(existing.get("tokens") or []) >= len(tokens)
            and existing["tokens"][: len(tokens)] == tokens
        ):
            return True
        doc = {
            "version": 1,
            "thread": thread_key,
            "fingerprint": self.fingerprint,
            "page_size": self.page_size,
            "tokens": tokens,
            "runs": runs,
            "meta": meta or {},
            "written_at": time.time(),
        }
        skey = self._manifest_store_key(thread_key)
        try:
            failpoint("kv.object_put")
            self.store.put(skey, json.dumps(doc).encode())
        except Exception as e:
            self.object_put_failures += 1
            self._note_store_failure(e)
            logger.warning("sleep manifest for %r failed: %s",
                           thread_key, e)
            return False
        with self._lock:
            self._manifest_cache.pop(thread_key, None)
        self.manifests_written += 1
        return True

    def read_manifest(self, thread_key: str) -> Optional[Dict[str, Any]]:
        """Cached manifest read (head-signature validated: a refresh by
        any owner invalidates every reader's cache entry).  The head
        probe itself is rate-limited per thread (_HEAD_TTL_S): the
        router probes at submit cadence and a page-blocked admission
        re-runs lookup every scheduler iteration — on a network-mounted
        store an unbounded stat per tick would stall dispatch."""
        now = time.monotonic()
        with self._lock:
            hit = self._manifest_cache.get(thread_key)
            if hit is not None:
                ttl = (self._probe_failure_ttl()
                       if hit[0] is _PROBE_FAILED else _HEAD_TTL_S)
                if now - hit[3] < ttl:
                    self._manifest_cache.move_to_end(thread_key)
                    if hit[0] is _PROBE_FAILED:
                        # counted miss: the submit path pays zero store
                        # RTT for the rest of the breaker's open window
                        self.probe_neg_cached += 1
                        return None
                    return hit[1]
        skey = self._manifest_store_key(thread_key)
        try:
            failpoint("kv.object_head")
            sig = self.store.head(skey)
        except Exception as e:
            # cache the FAILURE too: pre-guard, an outage re-probed (and
            # could stall) on every keyed submit; now the first failure
            # eats the RTT and every probe until the breaker's window
            # elapses is a local negative hit
            self._note_store_failure(e)
            self.probe_neg_cached += 1
            with self._lock:
                self._manifest_cache[thread_key] = [_PROBE_FAILED, None, None, now]
                self._manifest_cache.move_to_end(thread_key)
                while len(self._manifest_cache) > self._manifest_cache_cap:
                    self._manifest_cache.popitem(last=False)
            return None
        with self._lock:
            hit = self._manifest_cache.get(thread_key)
            if hit is not None and hit[0] == sig:
                hit[3] = now
                self._manifest_cache.move_to_end(thread_key)
                return hit[1]  # noqa: the depth memo rides in hit[2]
        doc: Optional[Dict[str, Any]] = None
        if sig is not None:
            try:
                raw = self.store.get(skey)
            except Exception as e:
                self._note_store_failure(e)
                raw = None
            if raw is not None:
                try:
                    doc = json.loads(raw)
                except ValueError:
                    doc = None
            if doc is not None and (
                doc.get("fingerprint") != self.fingerprint
                or doc.get("page_size") != self.page_size
            ):
                # another deployment's state under the same thread key:
                # its runs can never import into this pool
                doc = None
        with self._lock:
            self._manifest_cache[thread_key] = [sig, doc, None, now]
            self._manifest_cache.move_to_end(thread_key)
            while len(self._manifest_cache) > self._manifest_cache_cap:
                self._manifest_cache.popitem(last=False)
        return doc

    def _wakeable_depth(self, thread_key: str,
                        man: Dict[str, Any]) -> int:
        """Tokens of the manifest's run path actually PRESENT in the
        store, contiguous from the root — what a wake can really
        deliver.  Organically-written manifests legitimately name
        ancestor runs the sleeping host has not archived yet; counting
        those as routable coverage would steer requests away from
        genuine local caches toward a wake that truncates to nothing.
        Memoized per manifest signature (head probes are stats, but not
        free at submit cadence); a run archived later without this
        thread's manifest being rewritten is picked up on the next
        manifest refresh — an underestimate in the meantime, which only
        ever degrades routing toward the pre-object behavior."""
        with self._lock:
            hit = self._manifest_cache.get(thread_key)
            if hit is not None and hit[1] is man and hit[2] is not None:
                return hit[2]
        depth = 0
        for r in man.get("runs") or []:
            key = r.get("key")
            if not key or not self.has_run(key):
                break
            depth += int(r.get("tokens", 0))
        with self._lock:
            hit = self._manifest_cache.get(thread_key)
            if hit is not None and hit[1] is man:
                hit[2] = depth
        return depth

    def manifest_match_tokens(self, thread_key: str,
                              prompt_ids: Sequence[int]) -> int:
        """Longest page-aligned, PRESENT-in-store manifest coverage of
        `prompt_ids` — the router's "manifest hit = routable affinity"
        probe.  Leaves at least one token to prefill, mirroring the
        radix walk, and never counts runs a wake could not fetch."""
        man = self.read_manifest(thread_key)
        if man is None:
            return 0
        toks = man.get("tokens") or []
        ps = self.page_size
        limit = ((len(prompt_ids) - 1) // ps) * ps
        m = 0
        stop = min(len(toks), limit)
        while m < stop and toks[m] == prompt_ids[m]:
            m += 1
        return min((m // ps) * ps,
                   (self._wakeable_depth(thread_key, man) // ps) * ps)

    def note_archive(
        self,
        threads: Sequence[str],
        path_runs: Sequence[Sequence[int]],
    ) -> None:
        """Organic-eviction manifest refresh: a run just archived past
        disk updates its claimants' manifests to cover the root->run
        path.  Ancestor runs may not be archived yet — their keys are
        computed anyway, and a wake simply truncates at the first absent
        object (the drain/sleep path archives everything)."""
        runs = self.manifest_runs(path_runs)
        tokens = [t for seg in path_runs for t in seg]
        for thread_key in list(threads)[-_ARCHIVE_MANIFEST_CAP:]:
            self.write_manifest(thread_key, tokens, runs)

    # -- export ----------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """The /metrics "object_tier" section (OBJECT_TIER_METRIC_KEYS).
        ``store_bytes``/``store_objects`` describe the SHARED store (the
        DP aggregate reports them once, unsummed) and
        ``store_breaker_state`` is a gauge the aggregate maxes (any open
        breaker is fleet-visible); everything else is per-owner and
        sums."""
        g = self.guard
        try:
            count, total = self.store.usage()
        except Exception:  # pragma: no cover - store flake
            count = total = 0
        return {
            "store_bytes": total,
            "store_objects": count,
            "owned_bytes": self.owned_bytes,
            "object_puts": self.object_puts,
            "object_put_failures": self.object_put_failures,
            "object_bytes_put": self.object_bytes_put,
            "object_gets": self.object_gets,
            "object_get_failures": self.object_get_failures,
            "object_bytes_got": self.object_bytes_got,
            "dedupe_hits": self.dedupe_hits,
            "wake_threads": self.wake_threads,
            "wake_tokens": self.wake_tokens,
            "manifests_written": self.manifests_written,
            "objects_released": self.objects_released,
            # store-guard families: zeros on a bare (unguarded) store
            "store_retries": g.retries_total if g else 0,
            "store_timeouts": g.timeouts_total if g else 0,
            "store_breaker_opens": g.breaker.opens if g else 0,
            "store_breaker_state": g.breaker.state_gauge() if g else 0,
            "store_probe_neg_cached": self.probe_neg_cached,
            "store_scrub_repairs": self.scrub_repairs,
            # wake-prefetch families: zeros when prefetch is
            # off (no prefetcher attached)
            "prefetch_hits": self.prefetch_hits,
            "prefetch_wasted": self.prefetch_wasted,
            "prefetch_bytes": self.prefetch_bytes,
            "prefetch_inflight": (
                self.prefetcher.inflight() if self.prefetcher else 0
            ),
        }

    def scrub(self, grace_s: float = 3600.0, repair: bool = False) -> Dict[str, Any]:
        """Run the crash-orphan scrubber against this tier's store (the
        background-janitor entry point; ``scripts/objstore_fsck.py`` is
        the offline one).  Repairs count into ``store_scrub_repairs``."""
        report = fsck(self.store, grace_s=grace_s, repair=repair)
        self.scrub_repairs += report["repaired"]
        return report

    def start_janitor(self, interval_s: float,
                      grace_s: float = 3600.0) -> None:
        """Opt-in background janitor: scrub(repair=True) every
        ``interval_s`` on a daemon thread (KAFKA_TORCH_KV_OBJECT_SCRUB_S;
        0 = off, the default — most fleets run the offline
        ``scripts/objstore_fsck.py`` on a schedule instead so exactly
        one scrubber walks the shared store).  Skips the walk outright
        while the breaker is open."""
        if interval_s <= 0 or self._janitor is not None:
            return

        def _loop() -> None:
            while not self._janitor_stop.wait(interval_s):
                if not self.available():
                    continue
                try:
                    self.scrub(grace_s=grace_s, repair=True)
                except Exception as e:  # never kill the thread
                    logger.warning("object-store janitor pass failed: %s",
                                   e)

        self._janitor = threading.Thread(
            target=_loop, name="objstore-janitor", daemon=True
        )
        self._janitor.start()

    def stop_janitor(self) -> None:
        t = self._janitor
        if t is not None:
            self._janitor_stop.set()
            t.join(timeout=5.0)
            self._janitor = None
            self._janitor_stop = threading.Event()


# ---------------------------------------------------------------------------
# crash-orphan scrubber (fsck): refs <-> objects <-> manifests
# ---------------------------------------------------------------------------


def _ref_markers(store: ObjectStore) -> List[str]:
    """Every ref marker key (``refs/<run-key>/<owner-uid>``), whichever
    listing shape the backend has: LocalFS lists one level (so ``refs/``
    yields per-run directories to descend into), S3-shaped prefix
    listings are recursive (so ``refs/`` yields the markers directly)."""
    out: List[str] = []
    for entry in store.list("refs/"):
        rest = entry[len("refs/"):] if entry.startswith("refs/") else entry
        if "/" in rest:
            out.append(entry)
        else:
            out.extend(store.list(entry.rstrip("/") + "/"))
    return out


def fsck(
    store: ObjectStore,
    grace_s: float = 3600.0,
    repair: bool = False,
    now: Optional[float] = None,
) -> Dict[str, Any]:
    """Walk refs↔objects↔manifests and report (or repair) the refcount
    protocol's crash-window orphans:

    * **ref-less object** — put committed but the owner died before its
      ref marker landed: nothing will ever release it.  Repair: delete
      the object (per protocol, refcount governs life; a manifest naming
      it makes the wake truncate there, which is safe).
    * **dangling ref** — marker for a deleted object (last-ref delete
      interrupted between the object delete and the marker delete, or a
      dedupe marker raced a concurrent release).  Repair: delete the
      marker.
    * **dead manifest** — manifest whose runs are ALL absent (or that no
      longer parses): a wake delivers nothing.  Repair: delete it.
      Manifests with at least one present run are kept — a wake
      truncates to the surviving prefix, token-exact.

    Anything whose mtime is inside ``grace_s`` is left untouched: the
    crash windows are milliseconds wide, so a generous grace window
    cleanly separates "in-flight protocol step" from "orphan".  Dry-run
    (``repair=False``) only reports.  Store faults during the walk are
    counted, never raised — fsck on a flaky store degrades to a partial
    report."""
    t_now = time.time() if now is None else now
    report: Dict[str, Any] = {
        "repair": bool(repair), "grace_s": float(grace_s),
        "objects": 0, "refs": 0, "manifests": 0,
        "refless_objects": [], "dangling_refs": [], "dead_manifests": [],
        "in_grace": 0, "repaired": 0, "errors": 0,
    }

    def _head_mtime(key: str) -> Optional[float]:
        try:
            sig = store.head(key)
        except Exception:
            report["errors"] += 1
            return None
        return None if sig is None else sig[1]

    def _in_grace(mtime: Optional[float]) -> bool:
        return mtime is None or (t_now - mtime) < grace_s

    def _repair_delete(key: str) -> None:
        if not repair:
            return
        try:
            store.delete(key)
            report["repaired"] += 1
        except Exception:
            report["errors"] += 1

    try:
        failpoint("kv.object_list")
        object_keys = [k for k in store.list("objects/") if k.endswith(".npz")]
        markers = _ref_markers(store)
        manifest_keys = [k for k in store.list("threads/")
                         if k.endswith(".json")]
    except Exception as e:
        logger.warning("fsck list walk failed: %s", e)
        report["errors"] += 1
        return report
    report["objects"] = len(object_keys)
    report["refs"] = len(markers)
    report["manifests"] = len(manifest_keys)

    referenced: set = set()
    for marker in markers:
        parts = marker.split("/")
        run_key = parts[1] if len(parts) >= 3 else ""
        referenced.add(run_key)
        if f"objects/{run_key}.npz" in object_keys:
            continue
        mtime = _head_mtime(marker)
        if _in_grace(mtime):
            report["in_grace"] += 1
            continue
        report["dangling_refs"].append(marker)
        _repair_delete(marker)

    for okey in object_keys:
        run_key = okey[len("objects/"):-len(".npz")]
        if run_key in referenced:
            continue
        mtime = _head_mtime(okey)
        if _in_grace(mtime):
            report["in_grace"] += 1
            continue
        report["refless_objects"].append(okey)
        _repair_delete(okey)

    # Aliveness must be the SAME predicate in both modes so a dry-run
    # reports exactly what --repair would delete: a run is alive iff its
    # object survives the (actual or hypothetical) repair above — i.e.
    # it is present and was not condemned as refless-outside-grace.
    # Present-but-refless objects still inside the grace window were
    # kept, so they keep their manifests alive in repair mode too.
    surviving = set(object_keys) - set(report["refless_objects"])
    for mkey in manifest_keys:
        try:
            raw = store.get(mkey)
            doc = json.loads(raw) if raw is not None else None
        except Exception:
            report["errors"] += 1
            doc = None
        runs = (doc or {}).get("runs") or []
        alive = any(
            f"objects/{r.get('key')}.npz" in surviving for r in runs
        )
        if doc is not None and alive:
            continue
        mtime = _head_mtime(mkey)
        if _in_grace(mtime):
            report["in_grace"] += 1
            continue
        report["dead_manifests"].append(mkey)
        _repair_delete(mkey)
    return report
