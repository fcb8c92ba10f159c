"""The processes of a tensor- and expert-parallel rank group.

One process per rank (tp * tq * ep of them).  Rank 0 is the engine in the
caller's process (the server's): it owns the scheduler, the prefix cache,
grammars, speculation and telemetry.  `RankGroup` spawns ranks 1..n-1 (the
`spawn` start method: CUDA cannot fork), joins them in a process group of
their own (NCCL on the card, gloo on the CPU, rendezvous through a
FileStore) and runs one warm-up collective; at ep > 1 each rank also joins
the tensor group of its ep slice (parallel/mesh.py) and warms it up, so
every NCCL communicator exists before any CUDA graph capture.  Rank r
works on `cuda:r`.

Each rank holds an engine over its own shard of the weights and of the KV
pool.  Rank 0 sends every device-side operation of its engine, with its
host inputs, down a pipe to every other rank, and each rank runs it in the
same order: a prefill chunk, a control-state upload, a decode graph's
capture or replay, a verify step, a grammar table upload, recovery
(runtime/engine.py marks these methods `replicated`).  Only rank 0 reads
results back to the host.  A rank that fails reports its traceback and
exits; rank 0 sees that, or a dead process, at its next send or guarded
wait, as a DistributedStepError.

Workers exit when rank 0 closes the group, when rank 0's end of the pipe
closes (rank 0 died), or after reporting a failure.  `close()` joins them,
then terminates and kills what is left; no process outlives the group.
"""

from __future__ import annotations

import dataclasses
import faulthandler
import gc
import logging
import multiprocessing as mp
import os
import shutil
import signal
import sys
import tempfile
import threading
import time
import traceback
from datetime import timedelta
from typing import Any, List, Optional, Tuple

import torch
import torch.distributed as dist

from ..device import DeviceLike
from ..failpoints import failpoint
from .distributed import DistributedStepError, barrier, guard_timeout_s
from .mesh import MeshConfig, RankMesh, make_mesh, rank_devices

logger = logging.getLogger("kafka_tpu_torch.parallel")


@dataclasses.dataclass(frozen=True)
class RandomWeights:
    """A weight source every rank draws its own shard from
    (sharding.init_params_shard): no full copy is ever built or sent."""

    seed: int = 0
    quantize: str = ""


def _group(backend: str, store: Any, rank: int, size: int,
           device: torch.device, timeout: timedelta) -> Any:
    """A process group over `store`, warmed up: the first collective
    creates NCCL's communicator, outside any capture."""
    if backend == "nccl":
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = timeout
        group = dist.ProcessGroupNCCL(store, rank, size, opts)
    else:
        group = dist.ProcessGroupGloo(store, rank, size, timeout)
    probe = torch.ones(1, device=device)
    dist.all_reduce(probe, group=group)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if int(probe.item()) != size:
        raise RuntimeError(f"warm-up all-reduce gave {probe.item()}, "
                           f"want {size}")
    return group


def _join(backend: str, path: str, mesh: RankMesh,
          timeout_s: float) -> Tuple[Any, Any, Any]:
    """This rank's process group over the FileStore at `path` (a group of
    its own, not the process's default group), the store, and at ep > 1
    the tensor group of the rank's ep slice (None when that slice is the
    rank alone, or when ep is 1 and the whole group is the tensor
    group)."""
    failpoint("dist.init")
    store = dist.FileStore(path, mesh.size)
    timeout = timedelta(seconds=timeout_s)
    if backend == "nccl":
        torch.cuda.set_device(mesh.device)
    group = _group(backend, store, mesh.rank, mesh.size, mesh.device,
                   timeout)
    tensor_group = None
    if mesh.ep > 1 and mesh.tensor_size > 1:
        tensor_group = _group(
            backend, dist.PrefixStore(f"tensor{mesh.ep_index}", store),
            mesh.tensor_rank, mesh.tensor_size, mesh.device, timeout)
    return group, store, tensor_group


def _release(groups: List[Any], wait_s: Optional[float] = None) -> bool:
    """Abort this rank's process groups, each on a daemon thread, all at
    once (None entries are skipped).  Abort is local: it needs no peer
    and also stops NCCL kernels spinning on a dead peer, so a host call
    waiting on the device returns.  A collective `shutdown` instead
    finalizes with every peer and was seen not to return within 30 s on
    the cards.  Waits at most `wait_s` for all of them together (None:
    not at all); True if every call returned in time."""
    threads = []
    for group in groups:
        fn = getattr(group, "abort", None)
        if fn is None:
            continue

        def run(fn=fn) -> None:
            try:
                fn()
            except Exception:  # best effort on the way out
                logger.debug("process group abort failed", exc_info=True)

        t = threading.Thread(target=run, name="kafka-torch-pg-abort",
                             daemon=True)
        t.start()
        threads.append(t)
    if wait_s is None:
        return not threads
    deadline = time.monotonic() + wait_s
    for t in threads:
        t.join(max(0.0, deadline - time.monotonic()))
    return not any(t.is_alive() for t in threads)


def _worker_main(conn, tp: int, tq: int, ep: int, rank: int, device: str,
                 backend: str, path: str, timeout_s: float) -> None:
    """Rank `rank`'s process: join the group, then run what rank 0 sends,
    in order, until told to stop.  SIGUSR1 prints every thread's stack
    (a rank that hangs can be asked where)."""
    faulthandler.enable()
    faulthandler.register(signal.SIGUSR1, all_threads=True)
    dev = torch.device(device)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    mesh = RankMesh(tp=tp, tq=tq, ep=ep, rank=rank, device=dev)
    group = tensor_group = None
    engines = {}
    try:
        group, store, tensor_group = _join(backend, path, mesh, timeout_s)
        barrier(store, "kafka-torch-tp/ready", mesh.size, timeout_s)
        conn.send(("ready", rank))
        while True:
            try:
                msg = conn.recv()
            except (EOFError, OSError):
                # rank 0 is gone: nothing to finalize with
                os._exit(0)
            kind = msg[0]
            if kind == "close":
                break
            if kind == "op":
                _, eid, name, args, kw = msg
                engine = engines[eid]
                getattr(type(engine), name).replicated(engine, *args, **kw)
            elif kind == "query":
                _, eid, name, args = msg
                conn.send(("reply", getattr(engines[eid], name)(*args)))
            elif kind == "build":
                _, eid, spec = msg
                engines[eid] = spec.build(mesh, group, tensor_group)
                conn.send(("built", eid))
            elif kind == "drop":
                engine = engines.pop(msg[1], None)
                if engine is not None:
                    engine.close()
                    # free its tensors now: the next engine's shard may
                    # need the room
                    del engine
                    gc.collect()
    except BaseException:
        tb = traceback.format_exc()
        print(f"rank {rank} of the rank group failed:\n{tb}",
              file=sys.stderr, flush=True)
        try:
            conn.send(("error", rank, tb))
        except Exception:
            pass
        # skip interpreter teardown: a collective may be stuck on a peer
        os._exit(1)
    # free every engine (and its captured graphs, which hold the NCCL
    # communicators) before the groups are torn down
    while engines:
        engines.popitem()[1].close()
    gc.collect()
    if group is not None:
        # rank 0 aborts its groups at the same time (RankGroup.close);
        # every operation it sent has run here
        _release([tensor_group, group], wait_s=30.0)
    conn.close()


@dataclasses.dataclass
class EngineSpec:
    """What a worker needs to build its rank's engine: the model and
    engine configurations and a weight source (a full parameter tree it
    slices, or RandomWeights it draws)."""

    cfg: Any
    ecfg: Any
    kv_dtype: Optional[torch.dtype]
    weights: Any

    def rank_params(self, mesh: RankMesh) -> Any:
        from .sharding import init_params_shard, shard_params

        if isinstance(self.weights, RandomWeights):
            return init_params_shard(self.cfg, self.weights.seed, mesh,
                                     device=mesh.device,
                                     quantize=self.weights.quantize)
        return shard_params(self.weights, self.cfg, mesh)

    def build(self, mesh: RankMesh, group: Any,
              tensor_group: Any = None) -> Any:
        from ..runtime.engine import InferenceEngine

        return InferenceEngine(self.cfg, self.rank_params(mesh), self.ecfg,
                               kv_dtype=self.kv_dtype, device=mesh.device,
                               mesh=RankContext(mesh, group, tensor_group))


@dataclasses.dataclass
class RankContext:
    """A worker rank's mesh position and process groups (the whole group,
    and at ep > 1 its tensor group), as its engine sees them (the engine
    then takes orders and sends none)."""

    mesh: RankMesh
    group: Any
    tensor_group: Any = None


class RankGroup:
    """Rank 0's handle on a rank group of tp*tq*ep ranks: the spawned
    ranks, the process groups, and the pipes that carry each engine's
    device operations.  Engines are built on it (`InferenceEngine(...,
    mesh=group)`); an engine built from a MeshConfig owns the group it
    creates and closes it with itself.

    device: None = rank r on `cuda:r` (tp*tq*ep cards); "cpu" for the
    tests.
    store_dir: where the FileStore rendezvous lives (a fresh temp dir by
    default; tests pass tmp_path).  timeout_s: the guard's deadline for a
    rank to answer or a step to land (KAFKA_TORCH_DIST_STEP_TIMEOUT_S)."""

    def __init__(self, config: MeshConfig, device: DeviceLike = None,
                 store_dir: Optional[str] = None,
                 timeout_s: Optional[float] = None):
        self.mesh = make_mesh(config, 0, device)
        self.size = self.mesh.size
        devices = rank_devices(self.size, device)
        self.backend = "nccl" if self.mesh.device.type == "cuda" else "gloo"
        self.timeout_s = timeout_s if timeout_s is not None \
            else guard_timeout_s()
        self.broken: Optional[str] = None
        self._closed = False
        self._released = False
        self._release_lock = threading.Lock()
        self._owned_dir = store_dir is None
        self.store_dir = store_dir or tempfile.mkdtemp(
            prefix="kafka-torch-tp-")
        os.makedirs(self.store_dir, exist_ok=True)
        path = os.path.join(self.store_dir, f"store-{os.getpid()}-"
                            f"{time.monotonic_ns()}")
        ctx = mp.get_context("spawn")
        self._procs: List[Any] = []
        self._conns: List[Any] = []
        self._next_engine = 0
        self.group = self.tensor_group = None
        try:
            for r in range(1, self.size):
                parent, child = ctx.Pipe()
                proc = ctx.Process(
                    target=_worker_main,
                    args=(child, config.tp, config.tq, config.ep, r,
                          str(devices[r]), self.backend, path,
                          self.timeout_s),
                    name=f"kafka-torch-rank{r}", daemon=True)
                proc.start()
                child.close()
                self._procs.append(proc)
                self._conns.append(parent)
            # joining blocks until every rank has joined: wait on a
            # watchdog thread while watching the workers
            self.group, self.store, self.tensor_group = self._watch(
                lambda: _join(self.backend, path, self.mesh, self.timeout_s),
                "process group join")
            self._watch(lambda: barrier(self.store, "kafka-torch-tp/ready",
                                        self.size, self.timeout_s),
                        "rank startup")
            for conn in self._conns:
                self._recv(conn, "ready")
        except BaseException:
            self.close()
            raise
        self._watcher = threading.Thread(target=self._watch_ranks,
                                         name="kafka-torch-rank-watch",
                                         daemon=True)
        self._watcher.start()

    def _watch_ranks(self) -> None:
        """A rank that exits before close() breaks the group at once: its
        peers' collectives would spin on the device forever, and a host
        call that waits on the device (a pinned allocation, a
        synchronize) with them.  Aborting this rank's communicators stops
        those kernels; every later send or guarded wait then raises."""
        from multiprocessing.connection import wait

        sentinels = {p.sentinel: r for r, p in enumerate(self._procs, 1)}
        while not self._closed:
            ready = wait(list(sentinels), timeout=0.5)
            if self._closed or not ready:
                continue
            r = sentinels[ready[0]]
            proc = self._procs[r - 1]
            proc.join(1.0)  # reap it, for its exit code
            self._fail(f"rank {r} (pid {proc.pid}) exited with code "
                       f"{proc.exitcode}")
            self._abort()
            return

    def _abort(self) -> None:
        with self._release_lock:
            if self.group is not None and not self._released:
                self._released = True
                _release([self.tensor_group, self.group])

    # -- health --------------------------------------------------------

    def _fail(self, reason: str) -> DistributedStepError:
        if self.broken is None:
            self.broken = reason
            logger.error("tensor-parallel group broken: %s", reason)
        return DistributedStepError(reason)

    def check(self) -> None:
        """Raise DistributedStepError if the group is broken, a rank has
        died or a rank reported a failure."""
        if self.broken is not None:
            raise DistributedStepError(self.broken)
        for r, (proc, conn) in enumerate(zip(self._procs, self._conns), 1):
            try:
                if conn.poll():
                    msg = conn.recv()
                    if msg[0] == "error":
                        raise self._fail(f"rank {msg[1]} failed:\n{msg[2]}")
                    raise self._fail(f"rank {r} sent an unexpected {msg[0]!r}")
            except (EOFError, OSError):
                raise self._fail(f"rank {r} closed its pipe")
            if not proc.is_alive():
                raise self._fail(f"rank {r} (pid {proc.pid}) exited with "
                                 f"code {proc.exitcode}")

    def explain(self, error: BaseException, grace_s: float = 1.0) -> None:
        """A local operation failed: if a rank is down (a gloo collective
        fails when its peer's connection drops, often before the peer is
        seen dead), raise that as DistributedStepError; otherwise return
        and let the caller re-raise `error`."""
        if isinstance(error, DistributedStepError):
            return
        deadline = time.monotonic() + grace_s
        while True:
            try:
                self.check()
            except DistributedStepError as e:
                raise e from error
            if time.monotonic() > deadline:
                return
            time.sleep(0.02)

    def _watch(self, fn, label: str):
        """Run the blocking fn on a thread while watching the ranks."""
        out: dict = {}

        def run() -> None:
            try:
                out["value"] = fn()
            except BaseException as e:
                out["error"] = e

        t = threading.Thread(target=run, name=f"kafka-torch-{label}",
                             daemon=True)
        t.start()
        deadline = time.monotonic() + self.timeout_s
        while t.is_alive():
            t.join(0.02)
            if t.is_alive():
                self.check()
                if time.monotonic() > deadline:
                    raise self._fail(f"{label} missed its "
                                     f"{self.timeout_s:.0f}s deadline")
        if "error" in out:
            raise out["error"]
        return out.get("value")

    def _recv(self, conn, want: str, timeout_s: Optional[float] = None
              ) -> Any:
        timeout_s = self.timeout_s if timeout_s is None else timeout_s
        deadline = time.monotonic() + timeout_s
        r = self._conns.index(conn) + 1
        while not conn.poll(0.01):
            if not self._procs[r - 1].is_alive():
                raise self._fail(f"rank {r} exited with code "
                                 f"{self._procs[r - 1].exitcode}")
            if time.monotonic() > deadline:
                raise self._fail(f"rank {r} did not answer within "
                                 f"{timeout_s:.0f}s")
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            raise self._fail(f"rank {r} closed its pipe")
        if msg[0] == "error":
            raise self._fail(f"rank {msg[1]} failed:\n{msg[2]}")
        if msg[0] != want:
            raise self._fail(f"rank {r} sent {msg[0]!r}, want {want!r}")
        return msg[1]

    def wait(self, ready, label: str = "step") -> None:
        """Poll `ready()` (a fetch's event landing, say) under the guard:
        a dead or failed rank, or the deadline, raises DistributedStepError
        instead of a hang inside a collective."""
        failpoint("dist.step")
        deadline = time.monotonic() + self.timeout_s
        spin = 0
        while not ready():
            spin += 1
            if spin % 64 == 0:
                self.check()
                if time.monotonic() > deadline:
                    raise self._fail(f"{label} did not complete within "
                                     f"{self.timeout_s:.0f}s")
            time.sleep(0 if spin < 256 else 0.0005)

    # -- engines and their operations -----------------------------------

    def _send_all(self, msg) -> None:
        self.check()
        for r, conn in enumerate(self._conns, 1):
            try:
                conn.send(msg)
            except (BrokenPipeError, OSError) as e:
                raise self._fail(f"rank {r}: {e}")

    def build(self, spec: EngineSpec) -> int:
        """Build an engine on every other rank; its id."""
        eid = self._next_engine
        self._next_engine += 1
        self._send_all(("build", eid, spec))
        return eid

    def await_built(self, eid: int, timeout_s: float = 900.0) -> None:
        """Wait until every rank has built engine `eid` (drawing a 70B
        shard takes far longer than a step's deadline)."""
        for conn in self._conns:
            got = self._recv(conn, "built", max(timeout_s, self.timeout_s))
            if got != eid:
                raise self._fail(f"a rank built engine {got}, want {eid}")

    def drop(self, eid: int) -> None:
        if self.broken is None and not self._closed:
            self._send_all(("drop", eid))

    def op(self, eid: int, name: str, args: tuple, kw: dict) -> None:
        self._send_all(("op", eid, name, args, kw))

    def query(self, eid: int, name: str, *args: Any) -> List[Any]:
        """Call engine method `name` on every other rank (after every
        operation sent before it) and return their results, rank order."""
        self._send_all(("query", eid, name, args))
        return [self._recv(conn, "reply") for conn in self._conns]

    @property
    def pids(self) -> List[int]:
        return [p.pid for p in self._procs]

    def close(self, timeout_s: float = 10.0) -> None:
        """Stop every rank: ask, abort this rank's process groups (every
        rank aborts its own on the same order), join, then terminate and
        kill what is left.  Never waits on NCCL for long.  Idempotent."""
        if self._closed:
            return
        self._closed = True
        for conn in self._conns:
            try:
                conn.send(("close",))
            except Exception:
                pass
        if self.group is not None:
            with self._release_lock:
                if not self._released:
                    self._released = True
                    _release([self.tensor_group, self.group], wait_s=30.0)
        deadline = time.monotonic() + timeout_s
        for proc in self._procs:
            proc.join(max(0.0, deadline - time.monotonic()))
        for proc in self._procs:
            if proc.is_alive():
                proc.terminate()
                proc.join(2.0)
            if proc.is_alive():
                proc.kill()
                proc.join(2.0)
        for conn in self._conns:
            conn.close()
        if self._owned_dir:
            shutil.rmtree(self.store_dir, ignore_errors=True)
