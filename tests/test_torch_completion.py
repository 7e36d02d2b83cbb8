"""The segment completion protocol of the port (pinot_tpu_torch/realtime/
completion.py) and its hosting on the leader controller
(cluster/controller.py), against the JAX package, response by response.

Each scenario drives the port's `SegmentCompletionManager` and the JAX
package's through the same calls, on one fake clock (each module's `time`
replaced, so leases and decision waits expire at the same step), each over
its package's own `PropertyStore`. At every step the responses (status,
offset, location) are equal, and so are the stores' records afterwards:
the DONE records (commitTimeMs from the fake clock) and the lineage epochs
a commit bumps. Scenarios: election of the largest offset with CATCHUP; a
tie broken by report order; re-election after the committer's lease
expires, its late commit refused; a late voter above the target moving it
up; a single replica deciding after the wait; extend_build_time holding a
lease; commit_start and commit_end refusals; and commit_end retried on a
new leader's manager (no FSM), idempotent on the DONE record.

Then the leader gating: only the leading controller hosts a manager, a
standby that takes the seat starts a fresh one, `stop()` drops it; and
`LeaderCompletionClient` raises `NoControllerLeaderError` with the JAX
package's text when no leader is claimed, when the leader is not
reachable and when it lost the seat.
"""

from __future__ import annotations

import pytest

from pinot_tpu.cluster.controller import ClusterController as JaxController
from pinot_tpu.cluster.store import PropertyStore as JaxStore
from pinot_tpu.realtime import completion as jax_completion
from pinot_tpu_torch.cluster.controller import ClusterController
from pinot_tpu_torch.cluster.leader import LEADER_PATH
from pinot_tpu_torch.cluster.store import PropertyStore
from pinot_tpu_torch.realtime import completion


class FakeClock:
    """`time` for both completion modules: monotonic() and time() read one
    settable value."""

    def __init__(self, t=1_700_000_000.0):
        self.t = t

    def monotonic(self):
        return self.t

    def time(self):
        return self.t

    def advance(self, s):
        self.t += s


@pytest.fixture()
def clock(monkeypatch):
    c = FakeClock()
    monkeypatch.setattr(completion, "time", c)
    monkeypatch.setattr(jax_completion, "time", c)
    return c


class Pair:
    """One manager per package, each over its own store, fed the same
    calls."""

    def __init__(self, **kw):
        self.store, self.jstore = PropertyStore(), JaxStore()
        self.port = completion.SegmentCompletionManager(self.store, **kw)
        self.jax = jax_completion.SegmentCompletionManager(self.jstore, **kw)

    def call(self, method, *args, **kw):
        got = getattr(self.port, method)(*args, **kw)
        want = getattr(self.jax, method)(*args, **kw)
        if isinstance(got, bool):
            assert got == want
            return got
        got_t = (got.status, got.offset, got.location)
        assert got_t == (want.status, want.offset, want.location), method
        return got

    def state(self, table, segment):
        got = self.port.fsm_state(table, segment)
        assert got == self.jax.fsm_state(table, segment)
        return got

    def records(self):
        """Every record and epoch of both stores, equal."""
        def dump(store):
            return {p: store.get(p) for prefix in ("/SEGMENTS", "/CACHEEPOCH")
                    for p in store.list_paths(prefix)}

        got = dump(self.store)
        assert got == dump(self.jstore)
        return got


def test_elects_largest_offset_and_catches_up(clock):
    p = Pair(num_replicas=2, commit_lease_s=10)
    s = ("t", "t__0__0__0")
    assert p.call("segment_consumed", *s, "B", 80).status == completion.HOLD
    r = p.call("segment_consumed", *s, "A", 100)
    assert (r.status, r.offset) == (completion.COMMIT, 100)
    assert p.state(*s) == completion.COMMITTER_DECIDED
    r = p.call("segment_consumed", *s, "B", 80)
    assert (r.status, r.offset) == (completion.CATCHUP, 100)
    assert p.call("segment_consumed", *s, "B", 100).status == completion.HOLD
    assert p.call("segment_commit_start", *s, "B", 100).status \
        == completion.FAILED
    assert p.call("segment_commit_start", *s, "A", 99).status \
        == completion.FAILED
    assert p.call("segment_commit_start", *s, "A", 100).status \
        == completion.CONTINUE
    assert p.state(*s) == completion.COMMITTER_UPLOADING
    assert p.call("segment_commit_end", *s, "B", 100, "/x").status \
        == completion.FAILED
    assert p.call("segment_commit_end", *s, "A", 99, "/x").status \
        == completion.FAILED
    clock.advance(0.5)
    r = p.call("segment_commit_end", *s, "A", 100, "/deep/seg",
               metadata={"partitions": {"k": {"partitions": [1]}}})
    assert r.status == completion.COMMIT_SUCCESS
    assert p.state(*s) == completion.COMMITTED
    recs = p.records()
    rec = recs["/SEGMENTS/t/t__0__0__0"]
    assert recs["/CACHEEPOCH/t"] == 1
    assert rec["status"] == "DONE" and rec["committer"] == "A"
    assert rec["endOffset"] == "100" and rec["partitions"]
    assert p.port.committed_record(*s) == rec
    # a late replica is told to discard and download the build
    r = p.call("segment_consumed", *s, "B", 100)
    assert (r.status, r.offset, r.location) == (completion.DISCARD, 100,
                                                "/deep/seg")
    # a second commit of the finished segment is refused
    assert p.call("segment_commit_start", *s, "A", 100).status \
        == completion.FAILED


def test_tie_breaks_on_report_order_and_reelects_after_lease(clock):
    p = Pair(num_replicas=2, commit_lease_s=2.0)
    s = ("t", "s")
    assert p.call("segment_consumed", *s, "A", 50).status == completion.HOLD
    assert p.call("segment_consumed", *s, "B", 50).status == completion.HOLD
    assert p.call("segment_consumed", *s, "A", 50).status == completion.COMMIT
    assert p.call("segment_commit_start", *s, "A", 50).status \
        == completion.CONTINUE
    clock.advance(1.0)
    assert p.call("segment_consumed", *s, "B", 50).status == completion.HOLD
    clock.advance(1.5)  # the committer died: its lease is over
    assert p.call("segment_consumed", *s, "B", 50).status == completion.COMMIT
    assert p.call("segment_commit_start", *s, "B", 50).status \
        == completion.CONTINUE
    # the dead committer coming back late cannot commit
    assert p.call("segment_commit_end", *s, "A", 50, "/a").status \
        == completion.FAILED
    assert p.call("segment_commit_end", *s, "B", 50, "/b").status \
        == completion.COMMIT_SUCCESS
    assert p.records()["/SEGMENTS/t/s"]["committer"] == "B"
    r = p.call("segment_consumed", *s, "A", 50)
    assert (r.status, r.location) == (completion.DISCARD, "/b")


def test_late_voter_above_target_moves_it_up(clock):
    p = Pair(num_replicas=2, commit_lease_s=1.0, decision_wait_s=0.5)
    s = ("t", "s")
    assert p.call("segment_consumed", *s, "A", 40).status == completion.HOLD
    clock.advance(0.6)
    r = p.call("segment_consumed", *s, "A", 40)
    assert (r.status, r.offset) == (completion.COMMIT, 40)
    r = p.call("segment_consumed", *s, "B", 45)
    assert r.status == completion.HOLD  # above the target, not the committer
    clock.advance(1.1)
    r = p.call("segment_consumed", *s, "B", 45)
    assert (r.status, r.offset) == (completion.COMMIT, 45)
    r = p.call("segment_consumed", *s, "A", 40)
    assert (r.status, r.offset) == (completion.CATCHUP, 45)


def test_single_replica_decides_after_wait(clock):
    p = Pair(num_replicas=2, commit_lease_s=5, decision_wait_s=0.1)
    s = ("t", "s")
    assert p.call("segment_consumed", *s, "A", 10).status == completion.HOLD
    clock.advance(0.05)
    assert p.call("segment_consumed", *s, "A", 10).status == completion.HOLD
    clock.advance(0.06)
    assert p.call("segment_consumed", *s, "A", 10).status == completion.COMMIT
    assert p.state("t", "other") is None


def test_extend_build_time_holds_the_lease(clock):
    p = Pair(num_replicas=2, commit_lease_s=1.0)
    s = ("t", "s")
    p.call("segment_consumed", *s, "A", 7)
    assert p.call("segment_consumed", *s, "B", 7).status == completion.HOLD
    assert p.call("segment_commit_start", *s, "A", 7).status \
        == completion.CONTINUE
    assert p.call("extend_build_time", *s, "B", 10.0) is False
    assert p.call("extend_build_time", "t", "none", "A", 10.0) is False
    assert p.call("extend_build_time", *s, "A", 10.0) is True
    clock.advance(5.0)  # past the lease, inside the extension
    assert p.call("segment_consumed", *s, "B", 7).status == completion.HOLD
    assert p.call("segment_commit_end", *s, "A", 7, "/a").status \
        == completion.COMMIT_SUCCESS


def test_commit_end_is_idempotent_across_failover(clock):
    p = Pair(num_replicas=1, commit_lease_s=5)
    s = ("t", "s")
    assert p.call("segment_consumed", *s, "A", 30).status == completion.COMMIT
    assert p.call("segment_commit_start", *s, "A", 30).status \
        == completion.CONTINUE
    assert p.call("segment_commit_end", *s, "A", 30, "/a").status \
        == completion.COMMIT_SUCCESS
    before = p.records()
    # the leader died after writing the DONE record, before its answer
    # reached the committer: a new leader's manager over the same store
    # has no FSM and answers the retry from the record
    q = Pair.__new__(Pair)
    q.store, q.jstore = p.store, p.jstore
    q.port = completion.SegmentCompletionManager(p.store, num_replicas=1)
    q.jax = jax_completion.SegmentCompletionManager(p.jstore, num_replicas=1)
    r = q.call("segment_commit_end", *s, "A", 30, "/a")
    assert (r.status, r.offset, r.location) == (completion.COMMIT_SUCCESS,
                                                30, "/a")
    assert q.call("segment_commit_end", *s, "B", 30, "/a").status \
        == completion.FAILED
    assert q.call("segment_commit_end", *s, "A", 31, "/a").status \
        == completion.FAILED
    assert q.state(*s) == completion.COMMITTED
    assert q.call("segment_consumed", *s, "B", 30).status \
        == completion.DISCARD
    assert q.records() == before  # no second record, no second epoch bump


def test_completion_manager_is_leader_gated():
    cfg = {"num_replicas": 2, "commit_lease_s": 2.0, "decision_wait_s": 1.0}
    store = PropertyStore()
    c1 = ClusterController(store, instance_id="c1", completion_config=cfg)
    c2 = ClusterController(store, instance_id="c2", completion_config=cfg)
    try:
        m1 = c1.completion_manager()
        assert isinstance(m1, completion.SegmentCompletionManager)
        assert (m1.num_replicas, m1.commit_lease_s, m1.decision_wait_s) \
            == (2, 2.0, 1.0)
        assert c1.completion_manager() is m1
        assert c2.completion_manager() is None  # a standby hosts none
        c1.leader.disconnect()  # crash-death: the session expires
        store.expire_session("c1")
        assert c1.completion_manager() is None
        m2 = c2.completion_manager()
        assert m2 is not None and m2 is not m1
        c2.stop()
        assert c2.completion_manager() is None
        assert store.get(LEADER_PATH) is None
        # without an instance id there is no election: it always hosts
        solo = ClusterController(PropertyStore())
        assert solo.completion_manager() is not None
        solo.stop()
        assert solo.completion_manager() is not None  # a fresh one
    finally:
        c1.stop()
        c2.stop()


def _errors(store_cls, controller_cls, pkg):
    """The NoControllerLeaderError texts of the three refusals."""
    store = store_cls()
    live = {}
    client = pkg.LeaderCompletionClient(store, live.get)
    out = []

    def attempt():
        with pytest.raises(pkg.NoControllerLeaderError) as e:
            client.segment_consumed("t", "s", "A", 1)
        out.append(str(e.value))

    attempt()  # no leader claimed
    c = controller_cls(store, instance_id="c1")
    attempt()  # claimed, but the resolver does not know it
    live["c1"] = c
    assert client.segment_consumed("t", "s", "A", 1).status == pkg.COMMIT
    c.leader._is_leader = False  # the seat is lost, the entry not yet gone
    attempt()
    c.stop()
    return out


def test_no_leader_errors_equal_jax():
    got = _errors(PropertyStore, ClusterController, completion)
    assert got == _errors(JaxStore, JaxController, jax_completion)
    assert got == ["no controller leader claimed", "leader c1 not reachable",
                   "c1 lost leadership"]


def test_client_routes_every_call_to_the_leader():
    store = PropertyStore()
    cfg = {"num_replicas": 1, "commit_lease_s": 5.0}
    live = {"c1": ClusterController(store, instance_id="c1",
                                    completion_config=cfg)}
    client = completion.LeaderCompletionClient(store, live.get)
    try:
        assert client.segment_consumed("t", "s", "A", 9).status \
            == completion.COMMIT
        assert client.segment_commit_start("t", "s", "A", 9).status \
            == completion.CONTINUE
        assert client.extend_build_time("t", "s", "A", 3.0) is True
        assert client.segment_commit_end("t", "s", "A", 9, "/a").status \
            == completion.COMMIT_SUCCESS
        rec = live["c1"].completion_manager().committed_record("t", "s")
        assert rec["status"] == "DONE" and rec["location"] == "/a"
    finally:
        for c in live.values():
            c.stop()
