"""A run with the timed path broken underneath comes out not correct:
one case for each fault a one-chip query cell can have (an answer altered
where it is produced, half of the segments left out, a stale answer
returned for a new query); the unbroken run comes out correct. The look
for a chip is skipped: the run is on the CPU at a small size."""

import time

import pytest

from benchmark.core import harness, traffic
from benchmark.tests._tiny import bench, cell, config


def _alter(monkeypatch):
    from pinot_tpu_torch.engine import reduce

    real = reduce.BrokerReducer.reduce

    def altered(self, query, combined):
        table = real(self, query, combined)
        for row in table.rows[:1]:
            for i, v in enumerate(row):
                if isinstance(v, float) and v:
                    row[i] = v * 1.001
        return table
    monkeypatch.setattr(reduce.BrokerReducer, "reduce", altered)


def _half(monkeypatch):
    from pinot_tpu_torch.engine.query_executor import QueryExecutor

    real = QueryExecutor.prune_segments

    def half(self, query, segments):
        kept, pruned = real(self, query, segments)
        keep = kept[:max(1, len(kept) // 2)]
        return keep, pruned + len(kept) - len(keep)
    monkeypatch.setattr(QueryExecutor, "prune_segments", half)


def _stale(monkeypatch):
    from pinot_tpu_torch.engine.query_executor import QueryExecutor

    real = QueryExecutor.execute
    last = {}

    def stale(self, query):
        resp = real(self, query)
        return last.setdefault(query.table_name, resp)
    monkeypatch.setattr(QueryExecutor, "execute", stale)


FAULTS = {"none": None, "altered_answer": _alter, "half_segments": _half,
          "stale_answer": _stale}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", ["ssb_flat_sf4.flights",
                                      "tpch_lineitem_sf3.pricing"])
def test_broken_path_is_not_correct(monkeypatch, workload, fault):
    w = cell(workload)
    cfg = config(w["config"], scale=0.004, segments=2)
    mix = traffic.load(w["traffic"])
    mix["clients"] = 2
    if FAULTS[fault] is not None:
        FAULTS[fault](monkeypatch)
    result, _detail = harness.run(cfg, mix, 31337, 1.0, False, "cpu", 2,
                                  time.perf_counter(), bench()["end_to_end"])
    assert result["attempted"] > 0
    assert result["correct"] is (fault == "none"), result["checks"]
    if fault != "none":
        assert result["failed"] > 0
