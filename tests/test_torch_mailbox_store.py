"""The port's MailboxStore (mse/distributed.py): the JAX package's
tests/test_mailbox_store.py cases (sequence dedup, per sender; streaming
credit backpressure; cancel unblocking a producer and a consumer; a loud
timeout), with the module constants monkeypatched as the JAX package's
tests do, and the port's own: a deadline clamping the wait, a delivery
after cleanup dropped, and a PTDP delivery decoded on arrival, a corrupt
one raising before anything is stored.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest

from pinot_tpu_torch.cluster.datatable import (DataTableCorruptionError,
                                               encode_packed_block)
from pinot_tpu_torch.mse import distributed as D
from pinot_tpu_torch.mse.distributed import MailboxCancelled, MailboxStore


def _block(rows, val=1):
    return {"c": np.full(rows, val, dtype=np.int64)}


def test_seq_dedup_drops_retried_chunk():
    s = MailboxStore()
    s.put("q", 1, 0, 0, _block(10, 1), sender=0, seq=0)
    s.put("q", 1, 0, 0, _block(10, 1), sender=0, seq=0)  # transport retry
    s.put("q", 1, 0, 0, _block(5, 2), sender=0, seq=1)
    s.mark_eos("q", 1, 0, 0, 0)
    chunks = s.wait_all("q", 1, 0, 0, 1)
    assert [len(c["c"]) for c in chunks] == [10, 5]
    assert s.metrics("q")["mailbox_duplicates_dropped"] == 1


def test_seq_dedup_is_per_sender():
    s = MailboxStore()
    s.put("q", 1, 0, 0, _block(1), sender=0, seq=0)
    s.put("q", 1, 0, 0, _block(1), sender=1, seq=0)  # different sender, kept
    s.mark_eos("q", 1, 0, 0, 0)
    s.mark_eos("q", 1, 0, 0, 1)
    assert len(s.wait_all("q", 1, 0, 0, 2)) == 2


def test_streaming_backpressure_blocks_then_drains(monkeypatch):
    monkeypatch.setattr(D, "MAILBOX_BUFFER_BYTES", 200)
    s = MailboxStore()
    # arm the credit: a streaming consumer must be registered
    got = []
    consumed = threading.Event()

    def consume():
        for chunk in s.stream("q", 1, 0, 0, 1):
            got.append(len(chunk["c"]))
            time.sleep(0.05)  # slow consumer
        consumed.set()

    t = threading.Thread(target=consume)
    t.start()
    time.sleep(0.05)  # let the consumer register
    t0 = time.monotonic()
    for seq in range(6):  # 6 x 10 rows x 8B = 480B >> 200B credit
        s.put("q", 1, 0, 0, _block(10), sender=0, seq=seq)
    put_elapsed = time.monotonic() - t0
    s.mark_eos("q", 1, 0, 0, 0)
    assert consumed.wait(5)
    t.join()
    assert got == [10] * 6
    # producers actually blocked on the credit (not a free-run append)
    assert put_elapsed > 0.08, put_elapsed
    assert s.metrics("q")["mailbox_bytes_peak"] <= 200


def test_cancel_unblocks_producer_and_consumer(monkeypatch):
    monkeypatch.setattr(D, "MAILBOX_BUFFER_BYTES", 100)
    s = MailboxStore()
    errors = []

    # a STALLED streaming consumer: takes one chunk then never advances,
    # so the producer fills the credit and blocks in put()
    gen = s.stream("q", 1, 0, 0, 1)
    s.put("q", 1, 0, 0, _block(10), sender=0, seq=0)
    next(gen)

    def produce():
        try:
            for seq in range(1, 50):
                s.put("q", 1, 0, 0, _block(10), sender=0, seq=seq)
        except MailboxCancelled as e:
            errors.append(e)

    def consume_other():  # blocked in the empty-partition wait
        try:
            for _ in s.stream("q", 1, 0, 1, 1):
                pass
        except MailboxCancelled as e:
            errors.append(e)

    tp = threading.Thread(target=produce)
    tc = threading.Thread(target=consume_other)
    tp.start()
    tc.start()
    time.sleep(0.2)
    assert tp.is_alive()  # credit exhausted: producer is really blocked
    s.cancel("q")
    tp.join(timeout=5)
    tc.join(timeout=5)
    assert not tp.is_alive() and not tc.is_alive()
    assert len(errors) == 2
    gen.close()


def test_wait_all_timeout_is_loud(monkeypatch):
    monkeypatch.setattr(D, "MAILBOX_WAIT_S", 0.2)
    s = MailboxStore()
    with pytest.raises(TimeoutError, match="senders"):
        s.wait_all("q", 1, 0, 0, 2)


def test_deadline_clamps_the_wait():
    s = MailboxStore()
    s.set_deadline("q", time.monotonic() + 0.1)
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        s.wait_all("q", 1, 0, 0, 1)
    assert time.monotonic() - t0 < 5.0


def test_cleanup_forgets_the_query_and_drops_late_deliveries():
    s = MailboxStore()
    s.set_deadline("q", time.monotonic() + 60)
    s.put("q", 1, 0, 0, _block(3), sender=0, seq=0)
    s.mark_eos("q", 1, 0, 0, 0)
    assert s.open_queries() == {"q"}
    s.cleanup("q")
    assert s.open_queries() == set()
    # a delivery that lands after the query ended re-creates nothing, and
    # a receive of it fails at once
    s.put("q", 1, 0, 0, _block(3), sender=0, seq=1)
    s.mark_eos("q", 1, 0, 1, 0)
    s.set_deadline("q", time.monotonic() + 60)
    assert s.open_queries() == set()
    with pytest.raises(MailboxCancelled):
        s.wait_all("q", 1, 0, 0, 1)
    assert s.open_queries() == set()


def test_packed_delivery_decodes_and_corrupt_raises():
    s = MailboxStore()
    block = {"k": np.arange(1000, dtype=np.int64),
             "v": np.linspace(0, 1, 1000)}
    blob = encode_packed_block(block, device="cpu")
    req = {"type": "mse_mailbox", "query_id": "q", "from_stage": 2,
           "to_stage": 1, "partition": 0, "block": None, "packed": blob,
           "sender": 0, "seq": 0, "eos": True}
    s.deliver(req)
    (got,) = s.wait_all("q", 2, 1, 0, 1)
    for c in block:
        np.testing.assert_array_equal(got[c], block[c])
    bad = bytearray(blob)
    bad[-3] ^= 0xFF
    with pytest.raises(DataTableCorruptionError):
        s.deliver(dict(req, packed=bytes(bad), query_id="q2"))
    assert "q2" not in s.open_queries()
