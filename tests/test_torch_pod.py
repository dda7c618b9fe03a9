"""Pods: two hosts of the port's sweep on one shared store, claiming
grid blocks from one lease table (`parallel/pod.py`, `HostScheduler`).

Tolerances: exact. Each host reports the single-host winner and metric
matrix bit for bit (the other host's rows arrive through the journal
shards, whose floats round-trip exactly), and the blocks the hosts ran
add up to the plan, each block run once.

A host whose lanes drained sleeps until the earliest foreign lease could
expire before it polls the table again (the JAX package's rule), so the
tests lease for 3 s: a host never waits much past the other's last
block.
"""

import json
import os
import subprocess
import sys
import textwrap
import threading

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_journal import (  # noqa: E402
    binary_problem, one_intra_op_thread, outcome, selector_fit, small_models)
from test_torch_scheduler import _jobs, _port_inputs, _unscheduled  # noqa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_block_keys_are_the_jax_packages():
    from transmogrifai_tpu.parallel.pod import block_key as jax_key
    from transmogrifai_tpu_torch.parallel.pod import block_key
    for args in ((0, ("gbt", (200, 32, 20, 10)), [1, 0]),
                 (2, ("logistic", (50, True)), [3, 4, 5])):
        assert block_key(*args) == jax_key(*args)


def test_two_host_schedulers_split_the_blocks(tmp_path):
    """Two `HostScheduler`s in threads over one store: every block runs
    on exactly one host, and both return the single-host matrices."""
    from transmogrifai_tpu_torch.parallel.scheduler import HostScheduler
    from transmogrifai_tpu_torch.runtime.journal import ShardedSweepJournal
    X, y, folds, ev, ctx = _port_inputs()
    models = small_models()
    want = _unscheduled(models)
    out, reports, errors = {}, {}, []

    def host(name):
        try:
            journals = [ShardedSweepJournal(
                str(tmp_path / "ckpt" / f"f{i}.journal"),
                meta={"sig": str(i)}, fsync=False) for i in range(3)]
            sched = HostScheduler(str(tmp_path / "store"), name,
                                  sweep_id="t", n_workers=2, device="cpu",
                                  lease_ttl_s=3.0)
            out[name] = sched.run(_jobs(models, journals), X, y, folds, ev,
                                  ctx)
            reports[name] = sched.report
        except BaseException as e:  # surfaced on the test's thread
            errors.append(e)

    threads = [threading.Thread(target=host, args=(h,))
               for h in ("h0", "h1")]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert out["h0"] == want and out["h1"] == want
    ran = {h: sum(w.blocks for w in r.workers) for h, r in reports.items()}
    assert sum(ran.values()) == 5
    assert all(r.pod["host"] == h for h, r in reports.items())
    from transmogrifai_tpu_torch.store.state import LeaseTable
    snap = LeaseTable(str(tmp_path / "store"), "t", owner="x").snapshot()
    assert len(snap) == 5 and all(b["state"] == "done"
                                  for b in snap.values())


_HOST = textwrap.dedent("""
    import json, os, sys
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, {repo!r})
    sys.path.insert(0, os.path.join({repo!r}, "tests"))
    from test_torch_journal import binary_problem, outcome, selector_fit
    from transmogrifai_tpu_torch.parallel.mesh import make_mesh
    X, y = binary_problem(6)
    _, summ = selector_fit(X, y, checkpoint_dir={ckpt!r},
                           mesh=make_mesh(2, device="cpu"))
    # a host that starts after the other finished finds every family
    # checkpointed and schedules nothing
    rep = summ.timings["families"].get("scheduler")
    print(json.dumps({{"outcome": outcome(summ), "blocks": sum(
        w["blocks"] for w in rep["workers"]) if rep else 0,
        "host": rep["pod"]["host"] if rep else None}}))
""")


def test_two_host_processes_report_the_single_host_winner(tmp_path):
    """Two processes, each a pod host (``TRANSMOGRIFAI_POD_STORE``) with
    two CPU lanes, train the selector on one shared checkpoint dir and
    store: both report the single-host winner and matrix bit for bit,
    and their block counts add up to the plan (a host that starts after
    the other finished reads every family's checkpoint and runs none)."""
    X, y = binary_problem(6)
    want = outcome(selector_fit(X, y)[1])
    src = _HOST.format(repo=REPO, ckpt=str(tmp_path / "ckpt"))
    procs = []
    for h in ("h0", "h1"):
        env = dict(os.environ, TRANSMOGRIFAI_POD_STORE=str(tmp_path / "s"),
                   TRANSMOGRIFAI_POD_HOST=h, TRANSMOGRIFAI_POD_SWEEP="sel",
                   TRANSMOGRIFAI_POD_TTL_S="3")
        procs.append(subprocess.Popen([sys.executable, "-c", src], env=env,
                                      stdout=subprocess.PIPE))
    got = []
    for p in procs:
        stdout, _ = p.communicate(timeout=300)
        assert p.returncode == 0
        got.append(json.loads(stdout.decode().strip().splitlines()[-1]))
    for g in got:
        assert [tuple(c) for c in g["outcome"][0]] == \
            [(m, gr) for m, gr in want[0]]
        assert g["outcome"][1] == want[1]
        assert tuple(g["outcome"][2]) == want[2]
    assert sum(g["blocks"] for g in got) == 5
    assert {g["host"] for g in got} - {None} <= {"h0", "h1"}
