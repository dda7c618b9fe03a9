"""CAS state on the store: the port's `store/state.py` (`StateCell`,
`LeaseTable`, `SharedQuota`) against the JAX package's, and the F7
repair.

Tolerances: exact. The same operations give the same versions, values,
lease states, deadlines and quota balances (under one fake clock) in
both packages; a
claim whose base is not the newest version is refused (F7), where the
JAX package's copy accepts it; two processes CAS-incrementing one cell
lose no update.
"""

import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _state(which):
    if which == "jax":
        from transmogrifai_tpu.store import state
    else:
        from transmogrifai_tpu_torch.store import state
    return state


def _cell_ops(state, root):
    cell = state.StateCell(str(root), "c")
    out = [cell.read()]
    out.append(cell.try_write(0, {"n": 1}))
    out.append(cell.try_write(0, {"n": "lost"}))   # CAS lost
    out.append(cell.read())
    out.append(cell.update(lambda v: {"n": v["n"] + 1}))
    for _ in range(6):
        cell.update(lambda v: {"n": v["n"] + 1})
    out.append(cell.read())
    out.append(sorted(cell._versions()))           # the keep window
    with pytest.raises(ValueError):
        state.StateCell(str(root), "../escape")
    return out


def test_state_cell_matches_the_jax_package(tmp_path):
    got = {w: _cell_ops(_state(w), tmp_path / w) for w in ("jax", "port")}
    assert got["jax"] == got["port"]
    assert got["port"][-2] == (8, {"n": 8})
    assert got["port"][-1] == [5, 6, 7, 8]
    # the version files are the JAX package's layout
    names = sorted(n for n in os.listdir(tmp_path / "port" / "state")
                   if not n.startswith("."))
    assert names == [f"c.v{v}.json" for v in (5, 6, 7, 8)]


class _Clock:
    """A fake wall clock for the lease deadlines."""

    def __init__(self):
        self.now = 1000.0

    def time(self):
        return self.now

    def sleep(self, s):
        self.now += s


def _lease_ops(state, root, clock, monkeypatch):
    monkeypatch.setattr(state, "time", clock)
    a = state.LeaseTable(str(root), "sweep", owner="h0", ttl_s=10.0)
    b = state.LeaseTable(str(root), "sweep", owner="h1", ttl_s=10.0)
    out = []
    a.register(["k1", "k2", "k3"])
    b.register(["k3", "k4"])                         # union of plans
    out.append(a.claim(prefer=["k2"]))               # k2
    out.append(b.acquire("k2"))                      # busy
    out.append(a.acquire("k2"))                      # held
    out.append(b.claim())                            # k1
    out.append(a.complete("k2"))
    out.append(b.complete("k2"))                     # not ours: False
    out.append(a.pending())
    clock.now += 11.0                                # b's k1 lease expires
    out.append(a.acquire("k1"))                      # takeover
    out.append(b.renew("k1"))                        # revoked: False
    out.append(b.claim(prefer=["k4"]))               # k4
    out.append(b.fail("k4", "family failed"))
    out.append(a.release("k1"))
    out.append(b.acquire("k4"))                      # failed
    out.append(a.acquire("nope"))                    # missing
    out.append(a.snapshot())
    out.append((a.takeovers, b.takeovers, a.cas_rounds, b.cas_rounds))
    return out


def test_lease_table_matches_the_jax_package(tmp_path, monkeypatch):
    got = {w: _lease_ops(_state(w), tmp_path / w, _Clock(), monkeypatch)
           for w in ("jax", "port")}
    assert got["jax"] == got["port"]
    snap = got["port"][-2]
    assert snap["k2"]["state"] == "done" and snap["k4"]["state"] == "failed"
    assert snap["k1"]["state"] == "pool"


def _quota_ops(state, registry, root, clock, monkeypatch):
    """Two replicas spending one tenant's shared budget (rate 2/s, burst
    8, leases of a quarter burst) and a second tenant, under the fake
    clock: grants, denials, Retry-After and the shared cells."""
    monkeypatch.setattr(state, "time", clock)
    r0 = state.SharedQuota(str(root), replica="r0", registry=registry)
    r1 = state.SharedQuota(str(root), replica="r1", registry=registry)
    out = []
    for rep, n in [(r0, 1), (r0, 1), (r1, 3), (r0, 1), (r1, 2), (r0, 2),
                   (r1, 1), (r0, 1)]:
        out.append(rep.try_spend("acme/a", n, rate=2.0, burst=8.0))
    out.append(r0.refill_eta_s("acme/a", 3.0, rate=2.0))
    clock.now += 1.5                                 # refills 3 tokens
    out.append(r1.try_spend("acme/a", 3, rate=2.0, burst=8.0))
    out.append(r0.try_spend("acme/a", 2, rate=2.0, burst=8.0))
    out.append(r1.try_spend("other", 5, rate=1.0, burst=4.0))   # > burst
    out.append(r1.refill_eta_s("other", 5.0, rate=1.0))
    out.append(r0.try_spend("free", 10 ** 6, rate=float("inf"), burst=0))
    out.append(r0.refill_eta_s("acme/a", 1.0, rate=0.0))
    clock.now += 100.0                               # capped at burst
    out.append(r0.try_spend("acme/a", 8, rate=2.0, burst=8.0))
    out.append((r0.snapshot(), r1.snapshot()))
    out.append(sorted(n for n in os.listdir(root / "state")
                      if not n.startswith(".")))
    out.append([(name, tuple(sorted(labels.items())), value)
                for name, labels, value in _counters(registry)])
    return out


def _counters(registry):
    for name in ("router_quota_syncs_total", "router_quota_denied_total"):
        for rep in ("r0", "r1"):
            yield name, {"replica": rep}, registry.counter(
                name, replica=rep).value


def test_shared_quota_matches_the_jax_package(tmp_path, monkeypatch):
    from transmogrifai_tpu.obs.metrics import MetricsRegistry as JaxRegistry
    from transmogrifai_tpu_torch.obs.metrics import MetricsRegistry
    registries = {"jax": JaxRegistry(), "port": MetricsRegistry()}
    got = {w: _quota_ops(_state(w), registries[w], tmp_path / w, _Clock(),
                         monkeypatch)
           for w in ("jax", "port")}
    assert got["jax"] == got["port"]
    grants = got["port"][:8]
    assert grants == [True, True, True, True, False, False, True, True]
    assert got["port"][8:16] == [1.5, True, False, False, 1.0, True, 3600.0,
                                 True]
    r0, r1 = got["port"][-3]
    assert r0["tenants"]["acme/a"]["shared"]["tokens"] == 0.0
    assert r1["tenants"]["other"]["lease"] == 4.0    # the partial lease kept
    # eight round trips on the tenant's cell, the newest four kept
    assert got["port"][-2] == [f"quota-acme_a.v{v}.json" for v in (5, 6, 7, 8)
                               ] + ["quota-other.v1.json"]
    assert [v for _, _, v in got["port"][-1]] == [5.0, 4.0, 2.0, 2.0]


def _stale_claim(state, root):
    """A writer reads version 1, five newer versions land (pruning its
    base), then it tries to publish on top of version 1."""
    cell = state.StateCell(str(root), "lease")
    assert cell.try_write(0, "v1")
    version, _ = cell.read()
    for i in range(5):
        cell.update(lambda v, i=i: f"newer{i}")
    claimed = cell.try_write(version, "stale")
    return claimed, cell.read()


def test_f7_a_stale_claim_is_refused(tmp_path):
    """F7: the port's `try_write(v, ...)` (publish v + 1) returns False
    when v is not the newest version — here after five newer writes,
    with v + 1 already pruned — and the stale value is never the newest.
    Deterministic, no threads."""
    claimed, (version, value) = _stale_claim(_state("port"), tmp_path)
    assert claimed is False
    assert (version, value) == (6, "newer4")
    cell = _state("port").StateCell(str(tmp_path), "lease")
    assert cell.try_write(6, "next") and cell.read() == (7, "next")


def test_f7_the_jax_package_accepts_the_stale_claim(tmp_path):
    """The reference behaviour the port does not copy: the JAX package
    links the stale value into the pruned slot, reports success, and
    the value is lost (the newest version is higher)."""
    claimed, (version, value) = _stale_claim(_state("jax"), tmp_path)
    assert claimed is True
    assert (version, value) == (6, "newer4")


_WORKER = textwrap.dedent("""
    import sys
    sys.path.insert(0, {repo!r})
    from transmogrifai_tpu_torch.store.state import StateCell
    cell = StateCell({root!r}, "counter")
    for _ in range({n}):
        cell.update(lambda v: (v or 0) + 1, retries=100000)
""")


def test_two_processes_cas_lose_nothing(tmp_path):
    n = 60
    src = _WORKER.format(repo=REPO, root=str(tmp_path), n=n)
    procs = [subprocess.Popen([sys.executable, "-c", src])
             for _ in range(2)]
    assert [p.wait(timeout=120) for p in procs] == [0, 0]
    from transmogrifai_tpu_torch.store.state import StateCell
    assert StateCell(str(tmp_path), "counter").read() == (2 * n, 2 * n)


def test_threads_cas_lose_nothing(tmp_path):
    import threading
    from transmogrifai_tpu_torch.store.state import StateCell
    cell = StateCell(str(tmp_path), "t")

    def work():
        for _ in range(40):
            StateCell(str(tmp_path), "t").update(
                lambda v: (v or 0) + 1, retries=100000)

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert cell.read() == (160, 160)
