"""The port's sandbox tier against the JAX package's.

The cases of tests/test_sandbox.py and tests/test_remote_sandbox.py on
the port's copy (kafka_tpu_torch/sandbox/): one script of tool calls —
shells whose cwd persists, streamed deltas, a non-zero exit, a timeout
that replaces the shell, notebook state, stdout capture, an error cell,
an unknown tool — gives the same ToolEvent sequence on both packages'
sandbox servers; claims and keys behave alike; the manager's lifecycle
(create, reuse, restart, release) and the lazy and remote paths run on
the port's classes; a subprocess sandbox is `python -m
kafka_tpu_torch.sandbox.server`, imports no torch, and a failpoint armed
in the parent fires inside it; `builtin_tools(sandbox_url=...)` adds the
shell and notebook tools instead of raising.
"""

import asyncio
import os
import subprocess
import sys
import time

import pytest
from aiohttp.test_utils import TestServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def package(side):
    if side == "ref":
        from kafka_tpu import failpoints, sandbox
        from kafka_tpu.sandbox import server
    else:
        from kafka_tpu_torch import failpoints, sandbox
        from kafka_tpu_torch.sandbox import server
    return sandbox, server, failpoints


async def start_sandbox(side, sandbox_id="sbx-test"):
    sandbox, server, _ = package(side)
    srv = TestServer(server.create_sandbox_app(sandbox_id))
    await srv.start_server()
    return srv, sandbox.LocalSandbox(f"http://127.0.0.1:{srv.port}",
                                     sandbox_id)


def ev(e):
    return (e.kind, e.data, e.terminal)


SCRIPT = [
    ("create_shell", {"shell_id": "s1"}),
    ("shell_exec", {"shell_id": "s1", "command": "cd /tmp && pwd"}),
    ("shell_exec", {"shell_id": "s1", "command": "pwd"}),
    ("shell_exec", {"shell_id": "s1", "command": "echo a; echo b"}),
    ("shell_exec", {"command": "exit 3"}),
    ("shell_exec", {"command": "sleep 5", "timeout": 0.5}),
    ("shell_exec", {"command": "echo ok"}),
    ("notebook_run_cell", {"code": "x = 41"}),
    ("notebook_run_cell", {"code": "x + 1"}),
    ("notebook_run_cell", {"code": "print('hi'); x"}),
    ("notebook_run_cell", {"code": "1/0"}),
    ("no_such", {}),
]


def test_tool_script_gives_the_reference_events():
    async def side(name):
        srv, sbx = await start_sandbox(name)
        try:
            out = []
            for tool, args in SCRIPT:
                out.append([ev(e) async for e in sbx.run_tool(tool, args)])
            return out
        finally:
            await sbx.aclose()
            await srv.close()

    want = asyncio.run(asyncio.wait_for(side("ref"), 60))
    got = asyncio.run(asyncio.wait_for(side("port"), 60))
    assert got == want
    assert "/tmp" in got[2][-1][1]
    assert [d[1].strip() for d in got[3] if d[0] == "delta"] == ["a", "b"]
    assert "[exit code: 3]" in got[4][-1][1]
    assert got[5][-1][0] == "error" and "timed out" in got[5][-1][1]
    assert got[9][-1][1] == "hi\n41\n"
    assert got[10][-1][0] == "error" and got[11][-1][0] == "error"


def test_claims_keys_and_health_match_the_reference():
    async def side(name):
        sandbox, _, _ = package(name)
        Cfg = sandbox.SandboxConfig
        srv, sbx = await start_sandbox(name)
        out = []
        try:
            out.append(await sbx.check_health())
            out.append(await sbx.claim(Cfg(thread_id="t1")))
            out.append(await sbx.claim(Cfg(thread_id="t1")))
            out.append(await sbx.claim(Cfg(thread_id="t2")))
            out.append((await sbx.check_health())["claimed"])
            await sbx.reset()
            out.append((await sbx.check_health())["claimed"])
            # a key claimed with the sandbox is then required to run
            keyed = sandbox.LocalSandbox(sbx.url, sbx.sandbox_id)
            out.append(await keyed.claim(Cfg(thread_id="t3",
                                             vm_api_key="vmk_secret")))
            stranger = sandbox.LocalSandbox(sbx.url, sbx.sandbox_id)
            out.append([ev(e)[0] async for e in stranger.run_tool(
                "shell_exec", {"command": "echo hi"})])
            out.append([ev(e)[0] async for e in keyed.run_tool(
                "shell_exec", {"command": "echo hi"})])
            await keyed.aclose()
            await stranger.aclose()
        finally:
            await sbx.aclose()
            await srv.close()
        dead = sandbox.LocalSandbox(f"http://127.0.0.1:{srv.port}", "dead")
        out.append([ev(e)[0] async for e in dead.run_tool(
            "shell_exec", {"command": "echo"})])
        out.append((await dead.check_health())["healthy"])
        await dead.aclose()
        return out

    want = asyncio.run(asyncio.wait_for(side("ref"), 60))
    got = asyncio.run(asyncio.wait_for(side("port"), 60))
    assert got == want
    assert got[1:4] == [True, True, False]
    assert got[-2] == ["error"] and got[-1] is False


def test_sandbox_tools_through_the_tool_interface():
    from kafka_tpu_torch.sandbox import notebook_tools, shell_tools

    async def go():
        srv, sbx = await start_sandbox("port")
        try:
            create, execute = shell_tools(sbx)
            out = await execute.run({"command": "echo via-tool"})
            (nb,) = notebook_tools(sbx)
            cell = await nb.run({"code": "2**10"})
        finally:
            await sbx.aclose()
            await srv.close()
        (unbound,) = notebook_tools(None)
        events = [e async for e in unbound.run_stream({"code": "1"})]
        return out, cell, events[-1]

    out, cell, last = asyncio.run(asyncio.wait_for(go(), 60))
    assert "via-tool" in out and cell.strip() == "1024"
    assert last.kind == "error" and "no sandbox bound" in last.data


def test_builtin_tools_add_the_sandbox_tools_as_the_reference():
    from kafka_tpu.server_tools import builtin_tools as ref_builtin
    from kafka_tpu_torch.server_tools import builtin_tools

    url = "http://127.0.0.1:1"
    names = [t.name for t in builtin_tools(sandbox_url=url)]
    assert names == [t.name for t in ref_builtin(sandbox_url=url)]
    assert names[-3:] == ["create_shell", "shell_exec", "notebook_run_cell"]
    assert [t.to_openai() for t in builtin_tools(sandbox_url=url)] == \
        [t.to_openai() for t in ref_builtin(sandbox_url=url)]


# ---------------------------------------------------------------------------
# the manager and the lazy sandbox, over an in-memory factory
# ---------------------------------------------------------------------------


def fakes(side):
    sandbox, _, _ = package(side)
    from importlib import import_module

    ToolEvent = import_module(
        "kafka_tpu.tools.types" if side == "ref"
        else "kafka_tpu_torch.tools.types").ToolEvent

    class FakeSandbox(sandbox.LocalSandbox):
        def __init__(self, sandbox_id, healthy=True):
            self.sandbox_id = sandbox_id
            self.healthy = healthy
            self.claimed = False

        async def check_health(self):
            return {"healthy": self.healthy, "claimed": self.claimed}

        async def claim(self, config):
            self.claimed = True
            return True

        async def reset(self):
            self.claimed = False

        async def run_tool(self, name, arguments, tool_call_id=None,
                           timeout=None):
            yield ToolEvent("result", f"{name} ran", tool_name=name)

        async def aclose(self):
            pass

    class FakeFactory(sandbox.SandboxFactory):
        def __init__(self):
            self.sandboxes, self.created, self.restarted = {}, 0, []

        async def create(self, thread_id):
            self.created += 1
            sbx = FakeSandbox(f"fake-{self.created}")
            self.sandboxes[sbx.sandbox_id] = sbx
            return sbx

        async def connect(self, sandbox_id):
            return self.sandboxes.get(sandbox_id)

        async def restart(self, sandbox_id):
            self.restarted.append(sandbox_id)
            sbx = self.sandboxes.get(sandbox_id)
            if sbx is not None:
                sbx.healthy, sbx.claimed = True, False
            return sbx

    return sandbox, FakeFactory


def test_manager_lifecycle_matches_the_reference(tmp_path):
    async def side(name):
        sandbox, FakeFactory = fakes(name)
        DB = (__import__("kafka_tpu.db", fromlist=["x"]) if name == "ref"
              else __import__("kafka_tpu_torch.db", fromlist=["x"])
              ).LocalDBClient
        db = DB(str(tmp_path / f"{name}.db"))
        await db.initialize()
        out = []
        try:
            await db.create_thread("t1")
            factory = FakeFactory()
            mgr = sandbox.SandboxManager(db, factory)
            a = await mgr.ensure_sandbox("t1")
            b = await mgr.ensure_sandbox("t1")  # ready cache
            out.append((a.sandbox_id, b is a, factory.created))
            mgr._ready.clear()  # cache loss: the stored binding is reused
            c = await mgr.ensure_sandbox("t1")
            out.append((c.sandbox_id, factory.created))
            mgr._ready.clear()
            factory.sandboxes[c.sandbox_id].healthy = False  # dead: restart
            d = await mgr.ensure_sandbox("t1")
            out.append((d.sandbox_id, factory.restarted))
            lazy = sandbox.LazySandbox("t1", mgr)
            out.append([ev(e) async for e in lazy.run_tool("shell_exec",
                                                           {})])
            await mgr.release_sandbox("t1")
            out.append((d.claimed,
                        await mgr.get_sandbox_if_ready("t1") is d))
            await mgr.aclose()
        finally:
            await db.close()
        return out

    want = asyncio.run(asyncio.wait_for(side("ref"), 60))
    got = asyncio.run(asyncio.wait_for(side("port"), 60))
    assert got == want
    assert got[0] == ("fake-1", True, 1) and got[1] == ("fake-1", 1)
    assert got[2] == ("fake-1", ["fake-1"])
    assert got[3] == [("result", "shell_exec ran", True)]
    assert got[4] == (False, True)


# ---------------------------------------------------------------------------
# the remote factory, over a stub control plane whose VMs are the port's
# sandbox servers
# ---------------------------------------------------------------------------


def test_remote_factory_lifecycle(tmp_path):
    from kafka_tpu_torch.db import LocalDBClient
    from kafka_tpu_torch.sandbox import RemoteSandboxFactory, SandboxManager
    from kafka_tpu_torch.sandbox.server import create_sandbox_app
    from tests.test_remote_sandbox import StubControlPlane

    class Plane(StubControlPlane):
        async def _boot_vm(self, sandbox_id):
            server = TestServer(create_sandbox_app(sandbox_id))
            await server.start_server()
            self.sandboxes[sandbox_id] = {
                "state": "running", "server": server,
                "url": str(server.make_url(""))}
            return server

    plane = Plane()

    async def go():
        api = TestServer(plane.app())
        await api.start_server()

        class Factory(RemoteSandboxFactory):
            def _url_for(self, sandbox_id):
                return plane.url_of(sandbox_id)

        factory = Factory(str(api.make_url("")), proxy_template="unused",
                          snapshot="snap-1", boot_timeout_s=10.0)
        db = LocalDBClient(str(tmp_path / "r.db"))
        await db.initialize()
        try:
            assert await factory.connect("ghost") is None
            await db.create_thread("th-1")
            mgr = SandboxManager(db, factory)
            sb1 = await mgr.ensure_sandbox("th-1")
            sid = sb1.sandbox_id
            assert plane.created_with == [{"snapshot": "snap-1",
                                           "thread_id": "th-1"}]
            events = [e async for e in sb1.run_tool(
                "shell_exec", {"command": "echo remote"})]
            assert events[-1].kind == "result" and "remote" in events[-1].data
            assert (await mgr.ensure_sandbox("th-1")).sandbox_id == sid
            # the VM dies: the manager restarts it
            await plane.sandboxes[sid]["server"].close()
            plane.sandboxes[sid]["state"] = "stopped"
            mgr._ready.pop("th-1", None)
            sb3 = await mgr.ensure_sandbox("th-1")
            assert sb3.sandbox_id == sid
            assert (await sb3.check_health()).get("healthy")
            await factory.terminate(sid)
            assert sid not in plane.sandboxes
            await mgr.aclose()
        finally:
            await db.close()
            await factory.aclose()
            await plane.close()
            await api.close()

    asyncio.run(asyncio.wait_for(go(), 60))


# ---------------------------------------------------------------------------
# subprocess sandboxes
# ---------------------------------------------------------------------------


def test_sandbox_server_subprocess_imports_no_torch():
    """`python -m kafka_tpu_torch.sandbox.server` pulls in neither torch
    nor jax nor the JAX package through the package __init__s."""
    code = ("import sys\n"
            "import kafka_tpu_torch.sandbox.server, kafka_tpu_torch.sandbox\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'kafka_tpu', 'numpy'))\n"
            "print(bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=60, cwd=REPO, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_process_sandbox_runs_the_ports_server_and_inherits_failpoints():
    from kafka_tpu_torch import failpoints as fp
    from kafka_tpu_torch.sandbox.process import ProcessSandboxFactory

    async def go():
        factory = ProcessSandboxFactory(boot_timeout_s=30, supervise=False)
        try:
            # sandbox.boot fires in this process during the spawn
            with fp.armed("sandbox.boot", "error", "no-boot"):
                with pytest.raises(fp.FailpointError, match="no-boot"):
                    await factory.create("t-boot")
            assert not factory._procs
            # a rule armed here fires inside the child's exec site
            with fp.armed("sandbox.server.exec", "error", "inherited-chaos"):
                sbx = await factory.create("t-inherit")
                evs = [e async for e in sbx.run_tool(
                    "shell_exec", {"command": "echo hi"})]
                await sbx.aclose()
                await factory.terminate(sbx.sandbox_id)
            assert len(evs) == 1 and evs[0].kind == "error"
            assert evs[0].terminal and "inherited-chaos" in str(evs[0].data)
            # nothing armed: the child runs the port's server, cleanly
            sbx = await factory.create("t-clean")
            cmdline = open(f"/proc/{factory._procs[sbx.sandbox_id].pid}"
                           "/cmdline").read().split("\0")
            clean = [e async for e in sbx.run_tool(
                "shell_exec", {"command": "echo hi"})]
            # the client-side site fails before the request leaves
            with fp.armed("sandbox.exec", "error", "client-side"):
                client = [ev(e) async for e in sbx.run_tool(
                    "shell_exec", {"command": "echo hi"})]
            # a crashed subprocess is never handed back as connected
            sid = sbx.sandbox_id
            await sbx.aclose()
            proc = factory._procs[sid]
            proc.kill()
            await proc.wait()
            reconnect = await factory.connect(sid)
            return cmdline, clean, client, reconnect, sid in factory._procs
        finally:
            await factory.aclose()

    cmdline, clean, client, reconnect, kept = asyncio.run(
        asyncio.wait_for(go(), 120))
    assert "kafka_tpu_torch.sandbox.server" in cmdline
    assert any(e.kind == "result" and "hi" in e.data for e in clean)
    assert client[-1][0] == "error" and "client-side" in client[-1][1]
    assert reconnect is None and not kept


def test_crash_loop_detector():
    from kafka_tpu_torch.sandbox.process import ProcessSandboxFactory

    async def go():
        factory = ProcessSandboxFactory(supervise=False, max_restarts=2,
                                        crash_window_s=60.0)
        sid = "proc-1-deadbeef"
        counts = [factory._note_crash(sid), factory._note_crash(sid)]
        before = sid in factory._crash_looping
        factory._note_crash(sid)
        looping = sid in factory._crash_looping
        handed = (await factory.connect(sid), await factory.restart(sid))
        await factory.terminate(sid)
        return counts, before, looping, handed, sid in factory._crash_looping

    assert asyncio.run(go()) == ([1, 2], False, True, (None, None), False)


def test_inflight_exec_gets_one_terminal_error_and_restarts():
    """Kill the subprocess mid-tool: exactly one terminal error event,
    and the exit watcher restarts the sandbox."""
    from kafka_tpu_torch.sandbox.process import (
        ProcessSandboxFactory,
        supervisor_snapshot,
    )

    async def go():
        factory = ProcessSandboxFactory(boot_timeout_s=30,
                                        restart_backoff_s=0.05,
                                        max_restarts=5)
        before = supervisor_snapshot()
        try:
            sbx = await factory.create("t-crash")

            async def run_long():
                return [e async for e in sbx.run_tool(
                    "shell_exec", {"command": "sleep 30", "timeout": 60})]

            task = asyncio.create_task(run_long())
            await asyncio.sleep(0.5)
            factory._procs[sbx.sandbox_id].kill()
            evs = await asyncio.wait_for(task, timeout=15)
            deadline = time.monotonic() + 15
            healthy = False
            while time.monotonic() < deadline and not healthy:
                after = supervisor_snapshot()
                healthy = after["restarts"] > before["restarts"] and \
                    (await sbx.check_health()).get("healthy", False)
                if not healthy:
                    await asyncio.sleep(0.1)
            await sbx.aclose()
            return evs, healthy, supervisor_snapshot()
        finally:
            await factory.aclose()

    evs, healthy, after = asyncio.run(asyncio.wait_for(go(), 90))
    terminals = [e for e in evs if e.terminal]
    assert len(terminals) == 1 and terminals[0].kind == "error"
    assert healthy and after["crashes"] >= 1 and after["reaped"] >= 1
