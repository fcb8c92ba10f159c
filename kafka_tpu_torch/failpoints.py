"""Failpoint fault injection: named sites where tests (or an operator
chasing a production bug) can make the serving stack fail on purpose.

(A copy of kafka_tpu/failpoints.py, read from KAFKA_TORCH_FAILPOINTS;
SITES lists the nine sites the port fires.)

Production LLM servers treat injectable faults as first-class (TiKV's
`fail_point!`, FreeBSD's KFAIL_POINT, gofail): the only way to *prove* the
scheduler frees pages on a mid-decode crash, or that a request whose DB
write dies still gets a terminal event, is to make those crashes happen on
demand.  This module is that seam for kafka_tpu:

* **Sites** are plain strings compiled into the hot paths:
  ``engine.step`` (top of the scheduler iteration), ``engine.prefill``
  (chunk dispatch), ``kv.alloc`` (page allocation), ``worker.dispatch``
  (token-event routing), ``sandbox.exec`` (tool execution, client side),
  ``sandbox.boot`` (subprocess sandbox spawn), ``sandbox.server.exec``
  (tool execution INSIDE the sandbox subprocess), ``agent.tool`` (one
  tool call), ``db.write`` (thread-store mutation).  The registry is
  open — any string works — but those are the wired ones (see SITES).
* **Rules** attach an action to a site: ``error`` raises
  :class:`FailpointError`, ``delay`` sleeps, ``exit`` hard-kills the
  process (``os._exit``) — the cross-process chaos primitive: armed in a
  sandbox subprocess or a jax.distributed worker it simulates a crashed
  peer, so tests can assert the SURVIVING process degrades cleanly.
  Triggers scope a rule to the ``nth`` call (1-based, fires once) or cap
  total firings with ``count``.
* **Off by default, zero hot-path cost**: every call site goes through
  :func:`failpoint`, whose first line is a module-global bool check — no
  dict lookup, no lock, nothing, until some rule is armed.
* **Cross-process inheritance**: :func:`subprocess_env` serializes the
  currently-armed rules back into the env syntax so child processes
  (sandbox subprocesses, jax.distributed workers) arm the same spec at
  import — chaos reaches across PID boundaries.

Activation is programmatic (``configure`` / the ``armed`` context manager
in tests) or environmental::

    KAFKA_TORCH_FAILPOINTS="engine.step=error(boom):nth=3;kv.alloc=delay(0.05)"

Syntax: ``site=action[(arg)][:nth=N][:count=N]``, ``;``-separated.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import threading
import time
from typing import Dict, List, Optional

logger = logging.getLogger("kafka_tpu_torch.failpoints")

ENV_VAR = "KAFKA_TORCH_FAILPOINTS"

# The sites wired into call paths.  This is the DOCUMENTED REGISTRY: a
# static check (tests/test_torch_failpoints.py) asserts every
# failpoint("<site>") call in kafka_tpu_torch/ appears here and vice versa,
# so new sites cannot ship undocumented.  The runtime registry itself stays
# open (any string works).
SITES = (
    # the scheduler iteration, before any dispatch (runtime/engine.py)
    "engine.step",
    # each prefill chunk dispatch, single-sequence and batched
    "engine.prefill",
    # every page allocation (runtime/kv_cache.py PagePool.alloc)
    "kv.alloc",
    # Tool execution (tools/provider.py run_tool_stream): fired once per
    # tool call, before the tool runs.  `delay` injects tool latency;
    # `error` surfaces as a tool-error event, the shape a crashed tool
    # produces, so the agent loop's error turn is reachable in tests.
    "agent.tool",
    # the worker's event routing (llm/worker.py): a fault drops a token or
    # parks a terminal event for a paced retry, never the loop
    "worker.dispatch",
    # sandbox tool execution, client side (sandbox/local.py), the
    # subprocess boot (sandbox/process.py) and execution inside the
    # sandbox server subprocess (sandbox/server.py)
    "sandbox.exec",
    "sandbox.boot",
    "sandbox.server.exec",
    # every thread-store mutation (db/local.py)
    "db.write",
)

ACTIONS = ("error", "delay", "exit")


class FailpointError(RuntimeError):
    """Raised by an armed ``error`` rule.  Deliberately NOT a subclass of
    any domain error (e.g. OutOfPagesError): an injected fault must take
    the *unhandled*-exception path of the layer it fires in, which is the
    path chaos tests exist to exercise."""

    def __init__(self, site: str, message: str = ""):
        self.site = site
        super().__init__(message or f"injected fault at failpoint {site!r}")


@dataclasses.dataclass
class Rule:
    """One armed rule.  `calls` counts every evaluation at the site;
    `fired` counts actual firings (the difference is trigger filtering)."""

    site: str
    action: str  # "error" | "delay" | "exit"
    arg: str = ""  # error message / delay seconds / exit code (as given)
    nth: Optional[int] = None  # fire ONLY on the nth call (1-based)
    count: Optional[int] = None  # max firings (None = unlimited)
    calls: int = 0
    fired: int = 0

    def _should_fire(self) -> bool:
        self.calls += 1
        if self.nth is not None and self.calls != self.nth:
            return False
        if self.count is not None and self.fired >= self.count:
            return False
        self.fired += 1
        return True

    def _fire(self) -> None:
        if self.action == "delay":
            time.sleep(float(self.arg or 0.01))
            return
        if self.action == "exit":
            # simulate a process crash: no atexit, no finally blocks, no
            # flushed streams — the way a SIGKILL'd peer actually looks to
            # the processes that outlive it
            logger.error("failpoint %s: hard process exit", self.site)
            os._exit(int(self.arg or 1))
        raise FailpointError(self.site, self.arg)


_rules: Dict[str, Rule] = {}
_lock = threading.Lock()
# Module-global fast flag: the ONLY thing disabled call sites touch.
# Reads are GIL-atomic; all writes happen under _lock.
_active = False


def failpoint(site: str) -> None:
    """Hot-path hook.  No-op (one bool check) unless some rule is armed."""
    if not _active:
        return
    with _lock:
        rule = _rules.get(site)
        if rule is None or not rule._should_fire():
            return
    logger.warning("failpoint %s firing: %s(%s)", site, rule.action, rule.arg)
    rule._fire()


def configure(
    site: str,
    action: str,
    arg: str = "",
    nth: Optional[int] = None,
    count: Optional[int] = None,
) -> Rule:
    """Arm one rule (replacing any existing rule at `site`)."""
    if action not in ACTIONS:
        raise ValueError(f"unknown failpoint action {action!r} for {site!r}")
    if any(c in str(arg) for c in ";:)"):
        # the spec metacharacters cannot serialize (format_rules), and an
        # unserializable rule would break subprocess_env — failing every
        # sandbox spawn while an UNRELATED rule is armed.  Fail at arm
        # time instead (parse() can't produce such args syntactically).
        raise ValueError(
            f"failpoint arg {arg!r} for {site!r} may not contain the "
            "spec metacharacters ';' ':' ')'"
        )
    if action == "delay":
        float(arg or 0.01)  # validate now, not at fire time
    elif action == "exit":
        int(arg or 1)
    rule = Rule(site=site, action=action, arg=str(arg), nth=nth, count=count)
    global _active
    with _lock:
        _rules[site] = rule
        _active = True
    return rule


def clear(site: Optional[str] = None) -> None:
    """Disarm one site (or all of them), restoring zero-cost paths."""
    global _active
    with _lock:
        if site is None:
            _rules.clear()
        else:
            _rules.pop(site, None)
        _active = bool(_rules)


def active_rules() -> List[Rule]:
    with _lock:
        return list(_rules.values())


@contextlib.contextmanager
def armed(
    site: str,
    action: str,
    arg: str = "",
    nth: Optional[int] = None,
    count: Optional[int] = None,
):
    """Test scoping: arm a rule for the block, always disarm after."""
    rule = configure(site, action, arg, nth=nth, count=count)
    try:
        yield rule
    finally:
        clear(site)


def parse(spec: str) -> List[Rule]:
    """Parse the env/config syntax into rules (without arming them).

    ``site=action[(arg)][:nth=N][:count=N]`` joined with ``;``.
    """
    rules: List[Rule] = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"bad failpoint spec {part!r}: expected site=action")
        site, rhs = part.split("=", 1)
        pieces = rhs.split(":")
        head, mods = pieces[0].strip(), pieces[1:]
        if "(" in head:
            if not head.endswith(")"):
                raise ValueError(f"bad failpoint action {head!r}")
            action, arg = head[:-1].split("(", 1)
        else:
            action, arg = head, ""
        nth = count = None
        for mod in mods:
            mod = mod.strip()
            if "=" not in mod:
                raise ValueError(f"bad failpoint modifier {mod!r}")
            k, v = mod.split("=", 1)
            if k == "nth":
                nth = int(v)
            elif k == "count":
                count = int(v)
            else:
                raise ValueError(f"unknown failpoint modifier {k!r}")
        if action not in ACTIONS:
            raise ValueError(
                f"unknown failpoint action {action!r} in {part!r}"
            )
        # validate args at parse time, same as configure(): a bad spec
        # must fail on load, not surface as the WRONG failure mode (a
        # recoverable ValueError where the chaos run expected a kill)
        if action == "delay":
            float(arg or 0.01)
        elif action == "exit":
            int(arg or 1)
        rules.append(
            Rule(site=site.strip(), action=action, arg=arg, nth=nth,
                 count=count)
        )
    return rules


def format_rules(rules: List[Rule]) -> str:
    """Serialize rules back into the env syntax (inverse of :func:`parse`).

    Round-trip property (chaos-tested): ``parse(format_rules(parse(s)))``
    produces the same rules as ``parse(s)``.  Args containing the syntax
    metacharacters ``;`` ``:`` ``)`` cannot round-trip and are rejected —
    a spec that silently re-parses differently in the child process would
    make cross-process chaos runs lie.
    """
    parts: List[str] = []
    for r in rules:
        if any(c in r.arg for c in ";:)"):
            raise ValueError(
                f"failpoint arg {r.arg!r} at {r.site!r} cannot be "
                "serialized (contains spec metacharacters)"
            )
        head = f"{r.site}={r.action}"
        if r.arg:
            head += f"({r.arg})"
        if r.nth is not None:
            head += f":nth={r.nth}"
        if r.count is not None:
            head += f":count={r.count}"
        parts.append(head)
    return ";".join(parts)


def subprocess_env(base: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """Environment for a child process that inherits the armed failpoints.

    Cross-process chaos seam: sandbox subprocesses (sandbox/process.py)
    and jax.distributed workers spawn with this env, so a spec armed in
    the parent — programmatically or via KAFKA_TORCH_FAILPOINTS — is live in
    the child from import time (load_env at module bottom).  With nothing
    armed, any stale spec inherited from the parent's own environment is
    scrubbed: a disarmed parent must not spawn pre-armed children.
    """
    env = dict(os.environ if base is None else base)
    spec = format_rules(active_rules())
    if spec:
        env[ENV_VAR] = spec
    else:
        env.pop(ENV_VAR, None)
    return env


def load_env(env: Optional[str] = None) -> int:
    """Arm rules from KAFKA_TORCH_FAILPOINTS (idempotent; returns how many).

    Called at import so any process-wide spec is live before the engine
    builds, and again by server startup so late env injection works."""
    spec = env if env is not None else os.environ.get(ENV_VAR, "")
    if not spec:
        return 0
    rules = parse(spec)
    for r in rules:
        configure(r.site, r.action, r.arg, nth=r.nth, count=r.count)
        logger.warning("failpoint armed from env: %s=%s(%s)", r.site,
                       r.action, r.arg)
    return len(rules)


load_env()
