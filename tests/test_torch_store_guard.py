"""kafka_tpu_torch.runtime.store_guard against the JAX package's copy.

The same scripted fault sequence drives both packages' StoreGuard over a
flaky in-memory store, with an injected breaker clock and no backoff, so
nothing sleeps: breaker states, open counts, retry and timeout counters
and the per-op accounting must agree step for step.  The deadline path
runs against a store that blocks on an event (released in the test), and
every guard's executor is shut down by the fixture.
"""

import threading

import pytest

from kafka_tpu.runtime import store_guard as ref
from kafka_tpu_torch.runtime import store_guard as port

PACKAGES = {"ref": ref, "port": port}


class Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


class FlakyStore:
    """A dict store whose next `fail` calls raise."""

    def __init__(self):
        self.data = {}
        self.fail = 0
        self.calls = 0

    def _maybe_fail(self):
        self.calls += 1
        if self.fail > 0:
            self.fail -= 1
            raise OSError("injected store fault")

    def put(self, key, data):
        self._maybe_fail()
        self.data[key] = data

    def get(self, key):
        self._maybe_fail()
        return self.data.get(key)

    def head(self, key):
        self._maybe_fail()
        return (len(self.data[key]), 0.0) if key in self.data else None

    def delete(self, key):
        self._maybe_fail()
        self.data.pop(key, None)

    def list(self, prefix):
        self._maybe_fail()
        return sorted(k for k in self.data if k.startswith(prefix))

    def usage(self):
        self._maybe_fail()
        return len(self.data), sum(len(v) for v in self.data.values())

    def put_if_absent(self, key, data):
        self._maybe_fail()
        if key in self.data:
            return False
        self.data[key] = data
        return True


@pytest.fixture
def guards():
    made = []

    def make(mod, inner, clock, **kw):
        g = mod.StoreGuard(
            inner, backoff_s=0.0,
            breaker=mod.CircuitBreaker(failure_threshold=3,
                                       open_window_s=10.0, clock=clock),
            **kw)
        made.append(g)
        return g

    yield make
    for g in made:
        if g._executor is not None:
            g._executor.shutdown(wait=True)


def run_script(mod, make):
    """One scripted fault sequence; returns the observations."""
    clock = Clock()
    store = FlakyStore()
    g = make(mod, store, clock, retries=1)
    seen = []

    def step(label, fn):
        try:
            out = fn()
            kind = "ok"
        except mod.StoreUnavailableError:
            out, kind = None, "unavailable"
        except mod.StoreOpError:
            out, kind = None, "op_error"
        snap = g.snapshot()
        snap["ops"] = {k: (v["calls"], v["errors"])
                       for k, v in snap["ops"].items()}
        seen.append((label, kind, out, g.breaker.state, snap, store.calls))

    step("put", lambda: g.put("a", b"xyz"))
    store.fail = 1  # one fault: the retry absorbs it
    step("get_retried", lambda: g.get("a"))
    for i in range(3):  # each op exhausts its retry budget
        store.fail = 2
        step(f"head_fail{i}", lambda: g.head("a"))
    # open: fast-fail without touching the store
    step("open_fast_fail", lambda: g.list(""))
    clock.t += 9.9
    step("still_open", lambda: g.usage())
    clock.t += 0.2  # window elapsed: one half-open probe
    store.fail = 2
    step("probe_fails", lambda: g.delete("a"))
    step("reopened", lambda: g.get("a"))
    clock.t += 10.0
    step("probe_ok", lambda: g.put_if_absent("b", b"q"))
    step("closed", lambda: g.head("b"))
    return seen


def test_breaker_and_retry_budget_match_the_reference(guards):
    want = run_script(ref, guards)
    got = run_script(port, guards)
    assert got == want
    states = [s[3] for s in got]
    assert states == ["closed", "closed", "closed", "closed", "open",
                      "open", "open", "open", "open", "closed", "closed"]
    kinds = {s[0]: s[1] for s in got}
    assert kinds["get_retried"] == "ok"
    assert kinds["open_fast_fail"] == "unavailable"
    assert kinds["probe_fails"] == "op_error"
    assert got[-1][4]["breaker_opens"] == 2
    assert got[-1][4]["retries"] == want[-1][4]["retries"] > 0


@pytest.mark.parametrize("side", list(PACKAGES))
def test_breaker_states_step_by_step(side):
    mod = PACKAGES[side]
    clock = Clock()
    b = mod.CircuitBreaker(failure_threshold=2, open_window_s=5.0,
                           clock=clock)
    assert b.allow() and b.state_gauge() == 0
    b.record_failure()
    assert b.state == mod.BREAKER_CLOSED
    b.record_failure()
    assert b.state == mod.BREAKER_OPEN and b.opens == 1
    assert not b.allow()
    clock.t += 5.0
    assert b.allow() and b.state == mod.BREAKER_HALF_OPEN
    assert not b.allow()  # one probe at a time
    assert b.state_gauge() == 1
    b.record_success()
    assert b.state == mod.BREAKER_CLOSED and b.consecutive_failures == 0


def test_env_knobs_are_the_ports_own(monkeypatch):
    for name, val in (("TIMEOUT_S", "2.5"), ("RETRIES", "4"),
                      ("BACKOFF_S", "0.5"), ("BREAKER_FAILURES", "7"),
                      ("BREAKER_OPEN_S", "3")):
        monkeypatch.setenv(f"KAFKA_TORCH_KV_OBJECT_{name}", val)
    g = port.StoreGuard.from_env(FlakyStore())
    assert (g.timeout_s, g.retries, g.backoff_s) == (2.5, 4, 0.5)
    assert g.breaker.failure_threshold == 7
    assert g.breaker.open_window_s == 3.0
    assert port.ENV_TIMEOUT_S == "KAFKA_TORCH_KV_OBJECT_TIMEOUT_S"


@pytest.mark.parametrize("side", list(PACKAGES))
def test_deadline_times_out_a_stuck_op(side, guards):
    mod = PACKAGES[side]
    release = threading.Event()

    class Stuck(FlakyStore):
        def get(self, key):
            release.wait(10.0)
            return b"late"

    g = guards(mod, Stuck(), Clock(), retries=0, timeout_s=0.05)
    try:
        with pytest.raises(mod.StoreTimeoutError):
            g.get("k")
        snap = g.snapshot()
        assert snap["timeouts"] == 1 and snap["stuck_ops"] == 1
        assert snap["ops"]["get"]["errors"] == 1
    finally:
        release.set()
