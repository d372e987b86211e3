"""Port parity: repro_torch's rmsnorm (the plain PyTorch path the wrapper
takes on the CPU) against the JAX reference's Pallas kernel in interpret
mode, at the reference's own shapes and tolerances
(``tests/test_kernels.py``: float32 1e-5, bfloat16 2e-2)."""

import ctypes
import re
from pathlib import Path

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


# ---------------------------------------------------------------------------
# The launch plan and the C interface (nothing here builds the kernel).
# ---------------------------------------------------------------------------

def test_c_signature_matches_declared_argtypes():
    """ctypes passes arguments by the declared types alone: a mismatch with
    the C signature would corrupt the call silently."""
    src = Path(ops.__file__).with_name("rmsnorm.cu").read_text()
    m = re.search(r"int rmsnorm_fwd\(([^)]*)\)", src)
    assert m, "rmsnorm_fwd not found in rmsnorm.cu"
    scalars = {"int": ctypes.c_int, "int64_t": ctypes.c_int64,
               "float": ctypes.c_float}
    got = []
    for p in m.group(1).split(","):
        decl = " ".join(p.split()).rsplit(" ", 1)[0]
        got.append(ctypes.c_void_p if decl.endswith("*") else scalars[decl])
    assert tuple(got) == ops._ARGTYPES


_ESIZE = {torch.float32: 4, torch.bfloat16: 2, torch.float16: 2}


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("d", [1, 33, 128, 768, 2048, 8192, 16384])
def test_plan_covers_the_row(d, dtype, aligned):
    """Every plan is one rmsnorm.cu compiles and accepts: 16-byte vectors
    only where d and the pointers allow them; the fewest lanes (a power of
    two, at most 32) that give each lane a vector, the rest of the warp on
    other rows; the least compiled register count that holds the row, or
    the looped form past 64 elements a lane and on the scalar path."""
    vec, lanes, rows, per_lane = ops._plan(d, dtype, aligned)
    wide = 16 // _ESIZE[dtype]
    assert vec == (wide if aligned and d % wide == 0 else 1)
    nvec = d // vec
    assert d % vec == 0
    assert lanes & (lanes - 1) == 0 and lanes * rows == 32
    assert lanes >= min(32, nvec) and (lanes == 1 or lanes // 2 < nvec)
    if per_lane:
        assert vec > 1 and per_lane in ops._PER_LANE
        assert per_lane * lanes >= nvec
        assert per_lane * vec <= ops._LANE_ELEMS
        assert all(p * lanes < nvec for p in ops._PER_LANE if p < per_lane)
    else:
        assert vec == 1 or -(-nvec // lanes) * vec > ops._LANE_ELEMS


@pytest.mark.parametrize("d,dtype,aligned,want", [
    (128, torch.bfloat16, True, (8, 16, 2, 1)),      # qk-norm: 2 rows a warp
    (2048, torch.bfloat16, True, (8, 32, 1, 8)),     # block norm
    (2048, torch.float32, True, (4, 32, 1, 16)),
    (8192, torch.float32, True, (4, 32, 1, 0)),      # looped
    (768, torch.float16, True, (8, 32, 1, 4)),
    (128, torch.bfloat16, False, (1, 32, 1, 0)),     # unaligned: scalar
    (33, torch.float32, True, (1, 32, 1, 0)),
    (1, torch.bfloat16, True, (1, 1, 32, 0))])
def test_plan_at_the_model_shapes(d, dtype, aligned, want):
    assert ops._plan(d, dtype, aligned) == want
