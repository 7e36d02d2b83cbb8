"""The join pipeline's device stages against the JAX package's.

The same seeded numpy inputs go through pinot_tpu/ops/join_pipeline.py
and pinot_tpu/mse/device_join.py (jitted XLA on the JAX CPU backend) and
through their torch ports on CPU tensors. Every output is integer or an
integer-valued float64 under the fused path's integer gate, so each is
compared element for element; the packed group table of the fused
join+aggregate bit for bit (its float64 bits, the metadata row of total
pairs and overflow included).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pinot_tpu.mse import device_join as jax_dj
from pinot_tpu.ops import join_pipeline as jax_jp
from pinot_tpu_torch.mse import device_join
from pinot_tpu_torch.ops import join_pipeline as jp

P = 8
EDGE_CODES = np.asarray(
    [0, 1, -1, 7, -7, (1 << 31) - 1, 1 << 31, -(1 << 31), (1 << 32) + 5,
     -(1 << 40), (1 << 62) - 1, -(1 << 62) + 1, (1 << 62) - 12345,
     -(1 << 62) + 99], dtype=np.int64)


def _u64_parts(codes: np.ndarray, P: int) -> np.ndarray:
    h = codes.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    return ((h >> np.uint64(33)) % np.uint64(P)).astype(np.int64)


@pytest.mark.parametrize("P", [1, 2, 3, 8, 16, 61])
def test_mix_mod_equals_the_uint64_form(P):
    rng = np.random.default_rng(P)
    codes = np.concatenate([
        EDGE_CODES, rng.integers(-(1 << 62), 1 << 62, 4000),
        rng.integers(-3000, 3000, 2000)]).astype(np.int64)
    want = _u64_parts(codes, P)
    assert np.array_equal(jp._mix_mod(torch.as_tensor(codes), P).numpy(),
                          want)
    assert np.array_equal(jp.host_partition_counts(codes, P),
                          np.bincount(want, minlength=P))
    assert np.array_equal(jp.host_partition_counts(codes, P),
                          jax_jp.host_partition_counts(codes, P))


def _codes(case: str, rng):
    """(padded codes, n, cap) of one partition case."""
    if case == "empty":
        return np.zeros(8, np.int64), 0, 8
    n = {"small": 5, "dense": 3000, "overflow": 3000, "wide": 2500}[case]
    N = jp.bucket(n)
    codes = np.zeros(N, np.int64)
    if case == "wide":
        codes[:n] = rng.integers(-(1 << 62) + 1, (1 << 62) - 1, n)
    else:
        codes[:n] = rng.integers(-40, 400, n)
    cap = {"small": 8, "dense": 1024, "overflow": 64, "wide": 512}[case]
    return codes, n, cap


# the packed sort needs a key span below pack_base(P): not the wide case
@pytest.mark.parametrize("mode,case", [
    (m, c) for m in ("rows", "packed", "keyed")
    for c in ("empty", "small", "dense", "overflow", "wide")
    if (m, c) != ("packed", "wide")])
def test_partition_planes_equal_jax(mode, case):
    rng = np.random.default_rng(len(case) * 7 + len(mode))
    codes, n, cap = _codes(case, rng)
    cmin = int(codes[:n].min()) if n else 0
    want_plane, want_counts = jax_jp._jit_partition_kernel()(
        codes, np.int64(n), np.int64(cmin), P=P, cap=cap, sort_mode=mode)
    plane, counts = jp._partition(torch.as_tensor(codes), n, cmin, P, cap,
                                  mode)
    assert np.array_equal(counts.numpy(), np.asarray(want_counts))
    assert np.array_equal(plane.numpy(), np.asarray(want_plane))


def test_sort_mode_follows_the_key_span():
    B = jp.pack_base(P)
    assert jp.sort_mode(False, 10, 0, 5, P) == "rows"
    assert jp.sort_mode(True, 10, 0, B - 1, P) == "packed"
    assert jp.sort_mode(True, 10, -1, B - 1, P) == "keyed"
    assert jp.sort_mode(True, 0, 0, 0, P) == "packed"
    assert B == jax_jp.pack_base(P)


SPEC_KINDS = [("count", "probe"), ("sum", "probe"), ("min", "probe"),
              ("max", "probe"), ("sum", "build"), ("min", "build"),
              ("max", "build")]


def _fused_inputs(seed: int, num_groups: int, overflow: bool):
    rng = np.random.default_rng(seed)
    pn, bn = 1500, 1100
    Np, Nb = jp.bucket(pn), jp.bucket(bn)
    pk = np.zeros(Np, np.int64)
    bk = np.zeros(Nb, np.int64)
    pk[:pn] = rng.integers(0, 90, pn)
    bk[:bn] = rng.integers(20, 130, bn)
    pg = np.zeros(Np, np.int64)
    pg[:pn] = rng.integers(0, num_groups, pn)
    pvals = np.zeros((2, Np))
    pvals[:, :pn] = rng.integers(-500, 500, (2, pn))
    bvals = np.zeros((2, Nb))
    bvals[:, :bn] = rng.integers(-500, 500, (2, bn))
    pmask = np.zeros(Np, bool)
    pmask[:pn] = rng.random(pn) < 0.7
    bmask = np.zeros(Nb, bool)
    bmask[:bn] = rng.random(bn) < 0.6
    if overflow:
        cap_l = cap_r = 64
    else:
        cap_l = jp.bucket(int(jp.host_partition_counts(pk[:pn], P).max()))
        cap_r = jp.bucket(int(jp.host_partition_counts(bk[:bn], P).max()))
    return dict(pk=pk, bk=bk, pg=pg, pvals=pvals, bvals=bvals, pmask=pmask,
                bmask=bmask, pn=pn, bn=bn, cap_l=cap_l, cap_r=cap_r,
                bmin=int(bk[:bn].min()), bmax=int(bk[:bn].max()))


@pytest.mark.parametrize("join_type", ["INNER", "LEFT", "SEMI", "ANTI"])
@pytest.mark.parametrize("masks", [False, True])
@pytest.mark.parametrize("num_groups", [5, 41])
def test_fused_join_agg_packed_plane_bit_equal(join_type, masks, num_groups):
    """Every aggregate kind on each side, at Gp <= 16 (the reference's
    one-hot reduction) and Gp > 16 (its scatters)."""
    x = _fused_inputs(17 + num_groups, num_groups, overflow=False)
    Gp = jp.bucket(num_groups)
    spec = tuple((k, s, i % 2) for i, (k, s) in enumerate(SPEC_KINDS))
    mask_kw = dict(pmask=x["pmask"], bmask=x["bmask"]) if masks else {}
    want = _jax_fused(x, spec, Gp, join_type, mask_kw)
    got = _port_fused(x, spec, Gp, join_type, mask_kw)
    assert got.shape == want.shape == (len(spec) + jp.META_ROWS, Gp)
    assert np.array_equal(got.view(np.int64), want.view(np.int64))
    assert got[-1][1] == 0.0 and got[-1][0] > 0


@pytest.mark.parametrize("one_mask", ["probe", "build"])
def test_fused_join_agg_one_side_mask(one_mask):
    x = _fused_inputs(5, 9, overflow=False)
    spec = (("count", "probe", 0), ("sum", "build", 1), ("max", "probe", 0))
    kw = {"pmask": x["pmask"]} if one_mask == "probe" else \
        {"bmask": x["bmask"]}
    want = _jax_fused(x, spec, 16, "LEFT", kw)
    got = _port_fused(x, spec, 16, "LEFT", kw)
    assert np.array_equal(got.view(np.int64), want.view(np.int64))


def test_fused_join_agg_reports_overflow_and_true_total():
    x = _fused_inputs(3, 7, overflow=True)
    spec = (("count", "probe", 0), ("sum", "probe", 0))
    want = _jax_fused(x, spec, 8, "INNER", {})
    got = _port_fused(x, spec, 8, "INNER", {})
    assert np.array_equal(got.view(np.int64), want.view(np.int64))
    assert got[-1][1] == 1.0


def _jax_fused(x, spec, Gp, join_type, mask_kw):
    pplane, pcounts = jax_jp.partition_planes(x["pk"], x["pn"], P, x["cap_l"])
    bplane, bcounts = jax_jp.partition_planes(
        x["bk"], x["bn"], P, x["cap_r"], key_sorted=True, cmin=x["bmin"])
    return np.asarray(jax_jp.fused_join_agg(
        x["pk"], x["pg"], x["pvals"], pplane, pcounts, x["bk"], x["bvals"],
        bplane, bcounts, x["pn"], x["bn"], spec, P, Gp, join_type=join_type,
        **mask_kw))


def _port_fused(x, spec, Gp, join_type, mask_kw):
    t = {k: torch.as_tensor(x[k]) for k in ("pk", "bk", "pg", "pvals",
                                            "bvals")}
    pplane, pcounts = jp.partition_planes(t["pk"], x["pn"], P, x["cap_l"])
    bplane, bcounts = jp.partition_planes(
        t["bk"], x["bn"], P, x["cap_r"], key_sorted=True, cmin=x["bmin"],
        cmax=x["bmax"])
    masks = {k: torch.as_tensor(v) for k, v in mask_kw.items()}
    return jp.fetch_packed(jp.fused_join_agg(
        t["pk"], t["pg"], t["pvals"], pplane, pcounts, t["bk"], t["bvals"],
        bplane, bcounts, x["pn"], x["bn"], spec, P, Gp, join_type=join_type,
        **masks))


@pytest.mark.parametrize("n", [0, 1, 777, 4096])
def test_gather_stack_equals_jax(n):
    rng = np.random.default_rng(n)
    cols = [rng.integers(-1000, 1000, 900).astype(np.int32),
            rng.integers(0, 50, 900).astype(np.int64)]
    idx = rng.integers(0, 900, max(n, 1)).astype(np.int64)
    n_to = jp.bucket(max(n, 1))
    want = np.asarray(jax_jp.gather_stack(cols, idx, n, n_to))
    got = jp.gather_stack(cols, idx, n, n_to, "cpu").numpy()
    assert got.dtype == np.float64
    assert np.array_equal(got, want)


@pytest.mark.parametrize("case", ["seed0", "seed1", "no_matches",
                                  "empty_left", "empty_right", "overflow"])
def test_device_join_indices_equal_jax(case):
    rng = np.random.default_rng(len(case))
    ln, rn = {"empty_left": (0, 300), "empty_right": (400, 0)}.get(
        case, (2000, 1500))
    lk = rng.integers(-50, 200, ln).astype(np.int64)
    rk = rng.integers(-50, 200, rn).astype(np.int64)
    if case == "no_matches":
        rk = rk + 1000
    max_out = 5000 if case == "overflow" else 1_000_000
    want = jax_dj.device_join_indices(lk, rk, max_out)
    got = device_join.device_join_indices(lk, rk, max_out, "cpu")
    assert got[2] == want[2]
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    if case == "overflow":
        assert got[2] > max_out and len(got[0]) == max_out


def test_gather_payload_takes_each_column_through_the_indices():
    rng = np.random.default_rng(4)
    cols = {"a": rng.integers(0, 9, 300).astype(np.int32),
            "b": rng.normal(size=300)}
    idx = rng.integers(0, 300, 1000)
    got = device_join.gather_payload(cols, idx, "cpu")
    for name, v in cols.items():
        assert got[name].dtype == v.dtype
        assert np.array_equal(got[name], v[idx])
    assert device_join.gather_payload({}, idx, "cpu") is None


def test_pair_join_gate_needs_the_executors_device(monkeypatch):
    monkeypatch.delenv("PINOT_TPU_DEVICE_JOIN", raising=False)
    big = device_join.AUTO_MIN_ROWS
    assert not device_join.enabled(big, big, None)
    assert not device_join.enabled(big, big, torch.device("cpu"))
    assert not device_join.enabled(10, 10, torch.device("cuda"))
    assert device_join.enabled(big, 0, torch.device("cuda"))
    monkeypatch.setenv("PINOT_TPU_DEVICE_JOIN", "1")
    assert device_join.enabled(1, 1, torch.device("cpu"))
    monkeypatch.setenv("PINOT_TPU_DEVICE_JOIN", "0")
    assert not device_join.enabled(big, big, torch.device("cuda"))
