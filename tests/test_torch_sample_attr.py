"""Port parity: repro_torch's sample_attr (plain PyTorch path on the CPU)
against the JAX reference's kernel in interpret mode and its
carry-update seam (neither needs the reference's device pipeline, so
this file imports the reference as it is)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.estimator import estimate_regions
from repro.kernels.sample_attr import ops as rops
from repro_torch.kernels.sample_attr import ops, ref


def _stream(n, R, seed, *, channels=None, pad=False):
    rng = np.random.default_rng(seed)
    lo, hi = (-2, R + 2) if pad else (0, R)
    ids = rng.integers(lo, hi, n).astype(np.int32)
    shape = (n,) if channels is None else (channels, n)
    pw = 50.0 + rng.random(shape) * 150.0
    valid = rng.random(n) < 0.85
    return ids, pw, valid


# ---------------------------------------------------------------------------
# One-shot sample_attr ≡ the reference kernel (interpret mode).
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,R", [(16, 3), (1000, 7), (4096, 128),
                                 (5000, 37), (100, 1), (3000, 300)])
def test_sample_attr_matches_reference_kernel(n, R):
    ids, pw, _ = _stream(n, R, n + R)
    pw32 = pw.astype(np.float32)
    c, s, sq = ops.sample_attr(torch.from_numpy(ids),
                               torch.from_numpy(pw32.astype(np.float64)), R)
    cr, sr, sqr = rops.sample_attr(jnp.asarray(ids), jnp.asarray(pw32), R,
                                   True)
    np.testing.assert_allclose(c.numpy(), np.asarray(cr), rtol=1e-6)
    np.testing.assert_allclose(s.numpy(), np.asarray(sr), rtol=1e-5)
    np.testing.assert_allclose(sq.numpy(), np.asarray(sqr), rtol=1e-5)
    assert c.dtype == torch.int64 and s.dtype == torch.float64


def test_sample_attr_padding_matches_nothing():
    """``-1`` pads and ids past R contribute nothing, as on the TPU."""
    ids, pw, _ = _stream(2000, 9, 5, pad=True)
    c, s, sq = ops.sample_attr(torch.from_numpy(ids), torch.from_numpy(pw),
                               9)
    keep = (ids >= 0) & (ids < 9)
    assert int(c.sum()) == int(keep.sum())
    np.testing.assert_allclose(
        s.numpy(), np.bincount(ids[keep], weights=pw[keep], minlength=9),
        rtol=1e-12)
    np.testing.assert_allclose(
        sq.numpy(),
        np.bincount(ids[keep], weights=pw[keep] ** 2, minlength=9),
        rtol=1e-12)


# ---------------------------------------------------------------------------
# make_carry_update ≡ the reference's carry fold (use_pallas=False).
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("channels", [None, 4])
@pytest.mark.parametrize("R", [16, 128, 300])
def test_carry_update_matches_reference(R, channels):
    rng = np.random.default_rng(R)
    stat = (R,) if channels is None else (R, channels)
    c0 = rng.integers(0, 50, R).astype(np.int64)
    s0 = rng.random(stat) * 1e3
    q0 = rng.random(stat) * 1e5
    got = (torch.from_numpy(c0.copy()), torch.from_numpy(s0.copy()),
           torch.from_numpy(q0.copy()))
    update = ops.make_carry_update(R)
    with jax.enable_x64(True):
        rupdate = jax.jit(rops.make_carry_update(R, use_pallas=False))
        want = (jnp.asarray(c0), jnp.asarray(s0), jnp.asarray(q0))
        for k in range(3):
            ids, pw, valid = _stream(2048, R, 10 * R + k, channels=channels)
            update(*got, torch.from_numpy(ids), torch.from_numpy(pw),
                   torch.from_numpy(valid))
            want = rupdate(*want, jnp.asarray(ids), jnp.asarray(pw),
                           jnp.asarray(valid))
        want = [np.asarray(w) for w in want]
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_allclose(got[1].numpy(), want[1], rtol=1e-9)
    np.testing.assert_allclose(got[2].numpy(), want[2], rtol=1e-9)


def test_carry_update_is_in_place_and_masks_nonfinite_lanes():
    """The fold updates the carry tensors themselves (the port's
    counterpart of the reference's donated carry), and a masked lane's
    non-finite power never reaches the sums."""
    ids = torch.tensor([0, 1, 1, 2], dtype=torch.int32)
    pw = torch.tensor([1.0, 2.0, float("nan"), 4.0], dtype=torch.float64)
    valid = torch.tensor([True, True, False, True])
    carry = (torch.zeros(3, dtype=torch.int64),
             torch.zeros(3, dtype=torch.float64),
             torch.zeros(3, dtype=torch.float64))
    out = ops.make_carry_update(3)(*carry, ids, pw, valid)
    assert all(a is b for a, b in zip(out, carry))
    assert carry[0].tolist() == [1, 1, 1]
    assert carry[1].tolist() == [1.0, 2.0, 4.0]
    assert carry[2].tolist() == [1.0, 4.0, 16.0]
    with pytest.raises(ValueError):
        ops.make_carry_update(4)(*carry, ids, pw, valid)


def test_fold_ref_is_the_cpu_path():
    ids, pw, valid = _stream(3000, 50, 1, channels=3, pad=True)
    args = (torch.from_numpy(ids), torch.from_numpy(pw),
            torch.from_numpy(valid))
    a = [torch.zeros(50, dtype=torch.int64),
         torch.zeros(50, 3, dtype=torch.float64),
         torch.zeros(50, 3, dtype=torch.float64)]
    b = [x.clone() for x in a]
    ops.sample_attr_fold(*a, *args)
    ref.sample_attr_fold_ref(*b, *args)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# The wrapper's checks (run before every kernel launch on the GPU).
# ---------------------------------------------------------------------------

def _carry(R, C=None, ids_dtype=torch.int32):
    stat = (R,) if C is None else (R, C)
    c = 64
    pw = (c,) if C is None else (C, c)
    return [torch.zeros(R, dtype=torch.int64),
            torch.zeros(stat, dtype=torch.float64),
            torch.zeros(stat, dtype=torch.float64),
            torch.zeros(c, dtype=ids_dtype),
            torch.zeros(pw, dtype=torch.float64),
            torch.ones(c, dtype=torch.bool)]


def test_wrapper_checks_accept_both_layouts():
    assert ops._check(*_carry(10)) == (10, 64, 1)
    assert ops._check(*_carry(10, 4)) == (10, 64, 4)


@pytest.mark.parametrize("breakage", ["ids_dtype", "pows_shape",
                                      "carry_shape", "noncontiguous",
                                      "valid_shape"])
def test_wrapper_checks_reject(breakage):
    args = _carry(10, 4)
    if breakage == "ids_dtype":
        args[3] = args[3].to(torch.int64)
    elif breakage == "pows_shape":
        args[4] = torch.zeros(3, 64, dtype=torch.float64)
    elif breakage == "carry_shape":
        args[1] = torch.zeros(10, 3, dtype=torch.float64)
    elif breakage == "noncontiguous":
        args[4] = torch.zeros(64, 4, dtype=torch.float64).T
    else:
        args[5] = torch.ones(63, dtype=torch.bool)
    with pytest.raises((TypeError, ValueError)):
        ops._check(*args)


# ---------------------------------------------------------------------------
# Estimator plug.
# ---------------------------------------------------------------------------

def test_as_aggregate_fn_plugs_into_estimator():
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 4, 20000).astype(np.int32)
    pw = 100 + 10 * rng.random(20000)
    names = ["a", "b", "c", "d"]
    est_np = estimate_regions(ids, pw, 10.0, names)
    est_k = estimate_regions(ids, pw, 10.0, names,
                             aggregate_fn=ops.as_aggregate_fn(device="cpu"))
    for r1, r2 in zip(est_np.regions, est_k.regions):
        assert r1.n_samples == r2.n_samples
        assert r1.e_hat == pytest.approx(r2.e_hat, rel=1e-12)


def test_as_aggregate_fn_defaults_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ops.as_aggregate_fn()
