"""Port parity: repro_torch's rmsnorm (the plain PyTorch path the wrapper
takes on the CPU) against the JAX reference's Pallas kernel in interpret
mode, at the reference's own shapes and tolerances
(``tests/test_kernels.py``: float32 1e-5, bfloat16 2e-2)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rmsnorm.ops import rmsnorm as rrmsnorm
from repro.kernels.rmsnorm.ref import rmsnorm_ref as rrmsnorm_ref
from repro_torch.kernels.rmsnorm import ops
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref


@pytest.mark.parametrize("n,d", [(64, 128), (100, 100), (513, 768),
                                 (7, 4096), (1, 33)])
def test_rmsnorm_matches_reference_kernel(n, d):
    rng = np.random.default_rng(n * d)
    x = rng.standard_normal((n, d)).astype(np.float32)
    s = rng.standard_normal(d).astype(np.float32)
    got = ops.rmsnorm(torch.from_numpy(x), torch.from_numpy(s))
    want = rrmsnorm(jnp.asarray(x), jnp.asarray(s), interpret=True)
    assert got.dtype == torch.float32 and got.shape == (n, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("eps", [1e-5, 1e-6, 1e-2])
def test_rmsnorm_eps_and_leading_axes(eps):
    """Any leading shape; eps reaches the arithmetic as in the reference."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 5, 48)).astype(np.float32) * 0.05
    s = rng.standard_normal(48).astype(np.float32)
    got = ops.rmsnorm(torch.from_numpy(x), torch.from_numpy(s), eps=eps)
    want = rrmsnorm_ref(jnp.asarray(x), jnp.asarray(s), eps=eps)
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("n,d", [(128, 256), (33, 80)])
def test_rmsnorm_bf16_matches_reference_kernel(n, d):
    rng = np.random.default_rng(5 + d)
    x = rng.standard_normal((n, d)).astype(np.float32)
    s = rng.standard_normal(d).astype(np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = ops.rmsnorm(xt, torch.from_numpy(s))
    want = rrmsnorm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(s),
                    interpret=True)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - np.asarray(want, np.float32)).max()
    assert err < 2e-2


def test_rmsnorm_cpu_path_is_the_plain_version():
    """On a CPU tensor the wrapper runs ref.py and counts no launch."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((9, 40)).astype(np.float32))
    s = torch.from_numpy(rng.standard_normal(40).astype(np.float32))
    before = ops.rmsnorm.launches
    assert torch.equal(ops.rmsnorm(x, s), rmsnorm_ref(x, s))
    assert ops.rmsnorm.launches == before


def test_rmsnorm_rejects_other_devices():
    x = torch.empty((4, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.rmsnorm(x, torch.empty(8, device="meta"))
