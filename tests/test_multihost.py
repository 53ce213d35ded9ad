"""Multi-host (multi-process) tier: REAL cross-process execution.

The reference has no distributed anything (SURVEY.md §2); the engine's
DCN tier is parallel/multihost.py. This test launches two actual OS
processes, each owning 2 virtual CPU devices, joined through
jax.distributed with gloo collectives — the same rendezvous + global
mesh + shard_map program a multi-host cluster runs — and checks that
view-sharded NCC across processes equals the unsharded value.
"""

import json
import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "multihost_worker.py")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_view_sharded_ncc(tmp_path):
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    # the workers pick their own platform/devices; scrub the test
    # session's single-process overrides
    env.pop("XLA_FLAGS", None)
    procs = []
    outs = []
    for pid in range(2):
        out = str(tmp_path / f"worker{pid}.json")
        outs.append(out)
        procs.append(
            subprocess.Popen(
                [sys.executable, WORKER, str(pid), "2", str(port), out],
                env=env,
                stdout=subprocess.PIPE,
                stderr=subprocess.PIPE,
                text=True,
            )
        )
    msgs = []
    for p in procs:
        try:
            so, se = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        msgs.append(se[-2000:])
    assert all(p.returncode == 0 for p in procs), msgs

    for out in outs:
        with open(out) as f:
            rec = json.load(f)
        assert rec["ok"], rec
        assert rec["processes"] == 2
        assert rec["global_devices"] == 4
        assert rec["local_devices"] == 2
        assert rec["max_abs_diff"] < 1e-5
