"""Fault containment across the ranks of a tensor-parallel group.

Counterpart of the rank-group half of kafka_tpu/parallel/distributed.py.
A collective whose peer process died does not fail: it hangs, the
transport waiting for a contribution that never comes.  A serving
process wedged inside an all-reduce is the worst failure mode there is
(no error, no progress, no drain).  The port's rank 0 never waits on a
step without a deadline: every host wait on a step's result (a fetch
landing, a synchronize) polls under the group's guard, which checks the
workers' liveness and their error reports as it waits, and a dead or
failed rank becomes a `DistributedStepError` within the deadline
(KAFKA_TORCH_DIST_STEP_TIMEOUT_S, default 60 s).  The caller treats the
group as broken: in-flight requests fail with an error event and /health
reports it.

`guarded_collective` is the reference's watchdog for a blocking call;
`barrier` a rendezvous on the group's store.  Failpoint sites: `dist.init`
(before a rank joins its process group) and `dist.step` (each guarded
wait), so chaos tests can fail a rank on purpose.  Multi-host
initialization and topology re-formation wait for a later slice
(ROADMAP A9).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Any, Callable, Optional

from ..failpoints import failpoint

logger = logging.getLogger("kafka_tpu_torch.distributed")

GUARD_TIMEOUT_ENV = "KAFKA_TORCH_DIST_STEP_TIMEOUT_S"


def guard_timeout_s(default: float = 60.0) -> float:
    try:
        return float(os.environ.get(GUARD_TIMEOUT_ENV) or default)
    except ValueError:
        return default


class DistributedStepError(RuntimeError):
    """A rank of the group died, failed, or missed a step's deadline.
    Deliberately terminal: the group is broken, and retrying a collective
    against a dead peer would only hang again."""


def barrier(store: Any, name: str, world_size: int,
            timeout_s: float = 60.0) -> bool:
    """Rendezvous of every rank on the group's store (each rank calls it
    with the same name once); raises DistributedStepError when not every
    rank arrives within the deadline.  False without a store."""
    if store is None:
        return False
    store.add(name, 1)
    deadline = time.monotonic() + timeout_s
    while int(store.add(name, 0)) < world_size:
        if time.monotonic() > deadline:
            raise DistributedStepError(
                f"barrier {name!r}: not every rank arrived within "
                f"{timeout_s:.0f}s")
        time.sleep(0.005)
    return True


def guarded_collective(fn: Callable[..., Any], *args: Any,
                       timeout_s: Optional[float] = None,
                       label: str = "collective") -> Any:
    """Run the blocking `fn(*args)` on a watchdog thread; raise
    DistributedStepError if it does not return within `timeout_s`.  `fn`
    must block until its result exists.  The stuck call is left behind on
    its daemon thread: a runtime collective cannot be cancelled."""
    failpoint("dist.step")
    if timeout_s is None:
        timeout_s = guard_timeout_s()
    result: dict = {}

    def run() -> None:
        try:
            result["value"] = fn(*args)
        except BaseException as e:  # surfaced to the caller
            result["error"] = e

    t = threading.Thread(target=run, name=f"kafka-torch-dist-{label}",
                         daemon=True)
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        raise DistributedStepError(
            f"distributed {label} did not complete within {timeout_s:.0f}s"
            " — a rank is dead or unreachable")
    if "error" in result:
        raise result["error"]
    return result.get("value")
