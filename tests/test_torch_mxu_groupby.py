"""The port's dense limb sums (pinot_tpu_torch/ops/mxu_groupby.py) against
the JAX package's, on the CPU.

The same numpy inputs, made from a seed, go through the port's `limb_sums`
(its plain PyTorch version: the tensors lie on the CPU), the JAX Pallas
kernel in interpret mode, and the JAX XLA fallback `_xla_limb_sums`. Sums
are int64 and must be element-equal. With the family axis, (S, P, n)
planes give (S, P, G) sums whose row s equals the JAX sums of member s
(and `jax.vmap` of them, the JAX package's batch form).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinot_tpu.ops import mxu_groupby as jax_mxu
from pinot_tpu_torch.ops import mxu_groupby


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(n, p, g, seed, masked_frac=0.5):
    """Dense-path shaped inputs: masked rows carry the trash gid g-1 and
    zero payloads."""
    rng = np.random.default_rng(seed)
    gid = rng.integers(0, max(1, g - 1), n).astype(np.int32)
    planes = rng.integers(0, 128, (p, n)).astype(np.int8)
    masked = rng.random(n) < masked_frac
    gid[masked] = g - 1
    planes[:, masked] = 0
    return planes, gid


# inside supports(): G=1, the largest G with one plane, the most planes,
# and lengths that are no multiple of the Pallas block (4096 rows)
SHAPES = [
    (100, 2, 1),
    (8192, 1, 32768),
    (4096, 24, 128),
    (5003, 3, 700),
    (12289, 4, 7001),
]


@pytest.mark.parametrize("n,p,g", SHAPES)
def test_limb_sums_matches_jax(n, p, g):
    planes, gid = _inputs(n, p, g, seed=n + p + g)
    assert mxu_groupby.supports(g, p) and jax_mxu.supports(g, p)
    got = mxu_groupby.limb_sums(torch.from_numpy(planes), torch.from_numpy(gid), g)
    assert got.dtype == torch.int64 and tuple(got.shape) == (p, g)
    jplanes = [jnp.asarray(pl) for pl in planes]
    pallas = np.asarray(jax_mxu.limb_sums(jplanes, jnp.asarray(gid), g,
                                          interpret=True))
    xla = np.asarray(jax_mxu._xla_limb_sums(tuple(jplanes), jnp.asarray(gid), g))
    np.testing.assert_array_equal(got.numpy(), pallas)
    np.testing.assert_array_equal(got.numpy(), xla)
    # the trash slot of masked rows stays 0, as on the TPU
    if g > 1:
        assert got[:, g - 1].sum().item() == planes[:, gid == g - 1].sum()


def test_limb_sums_of_no_rows_are_zero():
    got = mxu_groupby.limb_sums(torch.zeros((3, 0), dtype=torch.int8),
                                torch.zeros(0, dtype=torch.int32), 50)
    assert got.dtype == torch.int64 and tuple(got.shape) == (3, 50)
    assert not got.any()


@pytest.mark.parametrize("g,p", [
    (1, 1), (32768, 1), (32769, 1), (128, 24), (128, 25), (100, 0),
    (7001, 8), (7001, 24), (20000, 24), (32768, 16), (32768, 17)])
def test_supports_matches_jax(g, p):
    assert mxu_groupby.supports(g, p) == jax_mxu.supports(g, p)


def _family(segments, n, p, g, seed, live=None):
    """S members' dense-path inputs; member s keeps live[s] rows and routes
    the rest (its pad rows) to the trash group with zero payloads."""
    planes = np.zeros((segments, p, n), dtype=np.int8)
    gid = np.zeros((segments, n), dtype=np.int32)
    for s in range(segments):
        planes[s], gid[s] = _inputs(n, p, g, seed=seed + s)
        if live is not None:
            gid[s, live[s]:] = g - 1
            planes[s, :, live[s]:] = 0
    return planes, gid


# (S, n, P, G, live rows per member or None)
FAMILY_SHAPES = [
    (1, 5003, 3, 700, None),
    (4, 12289, 4, 7001, None),
    (16, 4096, 2, 1001, [4096 - 37 * s for s in range(16)]),
    (3, 2048, 5, 128, [2048, 0, 100]),  # a member with no live rows
]


@pytest.mark.parametrize("segments,n,p,g,live", FAMILY_SHAPES)
def test_family_limb_sums_match_jax_per_member(segments, n, p, g, live):
    planes, gid = _family(segments, n, p, g, seed=segments + n, live=live)
    got = mxu_groupby.limb_sums(torch.from_numpy(planes),
                                torch.from_numpy(gid), g)
    assert got.dtype == torch.int64 and tuple(got.shape) == (segments, p, g)
    for s in range(segments):
        want = jax_mxu._xla_limb_sums(tuple(jnp.asarray(pl) for pl in planes[s]),
                                      jnp.asarray(gid[s]), g)
        np.testing.assert_array_equal(got[s].numpy(), np.asarray(want))
    # the JAX package's family form: a vmap over the members
    vm = jax.vmap(lambda pl, gi: jax_mxu._xla_limb_sums(
        tuple(pl[k] for k in range(p)), gi, g))(jnp.asarray(planes),
                                                jnp.asarray(gid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(vm))
    # the (P, n) form is the family of one
    one = mxu_groupby.limb_sums(torch.from_numpy(planes[0]),
                                torch.from_numpy(gid[0]), g)
    np.testing.assert_array_equal(one.numpy(), got[0].numpy())


def test_family_padding_adds_nothing():
    planes, gid = _family(4, 1001, 3, 50, seed=5)
    tp, tg = torch.from_numpy(planes), torch.from_numpy(gid)
    pp, pg = mxu_groupby.pad_family(tp, tg)
    assert pp.shape == (4, 3, 1008) and pg.shape == (4, 1008)
    np.testing.assert_array_equal(
        mxu_groupby.limb_sums_plain(pp, pg, 50).numpy(),
        mxu_groupby.limb_sums_plain(tp, tg, 50).numpy())


def test_limb_sums_rejects_bad_inputs():
    planes, gid = _inputs(100, 2, 10, seed=2)
    tp, tg = torch.from_numpy(planes), torch.from_numpy(gid)
    with pytest.raises(ValueError):
        mxu_groupby.limb_sums(tp, tg, 1 << 16)  # outside supports()
    with pytest.raises(TypeError):
        mxu_groupby.limb_sums(tp.to(torch.int32), tg, 10)
    with pytest.raises(ValueError):
        mxu_groupby.limb_sums(tp, tg[:50], 10)
    with pytest.raises(ValueError):
        mxu_groupby.limb_sums(tp[0], tg, 10)  # one plane, not (P, n)
    with pytest.raises(ValueError):  # a family's gid must be (S, n)
        mxu_groupby.limb_sums(tp.unsqueeze(0), tg, 10)
