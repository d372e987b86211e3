"""Port parity: repro_torch's flash attention (the plain PyTorch path the
wrapper takes on the CPU) against the JAX reference's Pallas kernel in
interpret mode, at the reference's tolerances (``tests/test_kernels.py``:
float32 atol 2e-5 / rtol 1e-4, bfloat16 max abs 2e-2).

The reference kernel takes K/V repeated to H heads; the port takes them
with their own KV heads (query head h reads KV head h // (H // KV)), so
the GQA cases repeat them on the reference side only."""

import ctypes
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as rflash
from repro.kernels.flash_attention.ref import attention_ref as rattention_ref
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import (
    attention_ref, attention_wgmma_emulation)


def _qkv(B, H, KV, S, dh, seed, T=None):
    rng = np.random.default_rng(seed)
    T = S if T is None else T
    return (rng.standard_normal((B, H, S, dh)).astype(np.float32),
            rng.standard_normal((B, KV, T, dh)).astype(np.float32),
            rng.standard_normal((B, KV, T, dh)).astype(np.float32))


def _reference(q, k, v, *, causal, dtype=jnp.float32, block=128):
    G = q.shape[1] // k.shape[1]
    return rflash(jnp.asarray(q, dtype),
                  jnp.asarray(np.repeat(k, G, axis=1), dtype),
                  jnp.asarray(np.repeat(v, G, axis=1), dtype),
                  causal=causal, block_q=block, block_kv=block,
                  interpret=True)


@pytest.mark.parametrize("B,H,KV,S,dh,causal", [
    (2, 4, 4, 256, 64, True),
    (1, 2, 2, 256, 128, True),
    (2, 2, 2, 128, 64, False),
    (1, 1, 1, 384, 128, True),     # non-pow2 block count
    (1, 4, 4, 128, 32, True),
    (1, 2, 2, 128, 80, True),
    (1, 4, 2, 128, 32, True),      # GQA 4/2
    (2, 4, 1, 128, 80, False),     # GQA 4/1, non-causal
])
def test_flash_attention_f32_matches_reference_kernel(B, H, KV, S, dh,
                                                      causal):
    q, k, v = _qkv(B, H, KV, S, dh, S + dh + KV)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal)
    want = _reference(q, k, v, causal=causal)
    assert got.dtype == torch.float32 and got.shape == (B, H, S, dh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-4)


@pytest.mark.parametrize("S", [100, 37])
def test_flash_attention_ragged_length(S):
    """A length no block divides: the reference runs it as one block; the
    port's kernel masks the ragged tail instead of asserting."""
    q, k, v = _qkv(1, 2, 1, S, 64, S)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=True)
    want = _reference(q, k, v, causal=True, block=512)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-4)


@pytest.mark.parametrize("dh,KV", [(64, 2), (32, 1), (80, 2)])
def test_flash_attention_bf16_matches_reference_kernel(dh, KV):
    q, k, v = _qkv(1, 2, KV, 256, dh, 9 + dh)
    bf = [torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v)]
    got = ops.flash_attention(*bf, causal=True)
    want = _reference(q, k, v, causal=True, dtype=jnp.bfloat16)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - np.asarray(want, np.float32)).max()
    assert err < 2e-2


@pytest.mark.parametrize("causal", [True, False])
def test_plain_version_matches_reference_oracle(causal):
    """ref.py against the reference's jnp oracle with T != S (the causal
    mask is by index: key col is seen by query row iff col <= row)."""
    q, k, v = _qkv(2, 4, 2, 48, 32, 3, T=64)
    got = attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), causal=causal)
    want = rattention_ref(jnp.asarray(q), jnp.asarray(np.repeat(k, 2, 1)),
                          jnp.asarray(np.repeat(v, 2, 1)), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-4)


def test_flash_cpu_path_is_the_plain_version():
    q, k, v = (torch.from_numpy(t) for t in _qkv(1, 4, 2, 40, 64, 1))
    before = ops.flash_attention.launches
    assert torch.equal(ops.flash_attention(q, k, v, causal=True),
                       attention_ref(q, k, v, causal=True))
    assert ops.flash_attention.launches == before


@pytest.mark.parametrize("breakage,exc", [
    ("dh", ValueError), ("kv_heads", ValueError), ("dtype", TypeError),
    ("mixed_dtype", TypeError), ("rank", ValueError),
    ("kv_shape", ValueError)])
def test_flash_wrapper_checks(breakage, exc):
    """What the CUDA path refuses before it launches (checked on CPU
    tensors: the checks do not need the card)."""
    q = torch.zeros(1, 4, 8, 64)
    k = v = torch.zeros(1, 2, 8, 64)
    if breakage == "dh":
        q, k, v = torch.zeros(1, 4, 8, 96), torch.zeros(1, 2, 8, 96), \
            torch.zeros(1, 2, 8, 96)
    elif breakage == "kv_heads":
        k = v = torch.zeros(1, 3, 8, 64)
    elif breakage == "dtype":
        q, k, v = (t.to(torch.float64) for t in (q, k, v))
    elif breakage == "mixed_dtype":
        k = k.to(torch.bfloat16)
    elif breakage == "rank":
        q = q[0]
    elif breakage == "kv_shape":
        v = torch.zeros(1, 2, 9, 64)
    with pytest.raises(exc):
        ops._check(q, k, v)


def test_flash_rejects_other_devices():
    q = torch.empty((1, 1, 4, 32), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.flash_attention(q, q, q)


_KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


@pytest.mark.parametrize("dtype", _KERNEL_DTYPES)
@pytest.mark.parametrize("dh", ops.HEAD_DIMS)
def test_route_follows_dtype_and_head_dim(dtype, dh):
    """Tensor cores for bf16/fp16 at dh 64, 80, 128; the CUDA-core kernel
    for float32 (TF32 would break its limit) and for dh 32."""
    want = ("wgmma" if dtype != torch.float32 and dh in (64, 80, 128)
            else "simt")
    assert ops._route(dtype, dh) == want
    assert want in ops._ROUTES


_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
            "int": ctypes.c_int, "int64_t": ctypes.c_int64,
            "float": ctypes.c_float}


def test_c_signature_matches_declared_argtypes():
    """ctypes passes arguments by the declared types alone: a mismatch with
    the C signature would corrupt the call silently."""
    src = (Path(ops.__file__).with_name("flash_attention.cu")).read_text()
    m = re.search(r"int flash_attention_fwd\(([^)]*)\)", src)
    assert m, "flash_attention_fwd not found in flash_attention.cu"
    params = [" ".join(p.split()) for p in m.group(1).split(",")]
    ctypes_of = [_C_TYPES[p.rsplit(" ", 1)[0].replace(" *", "*")]
                 for p in params]
    assert tuple(ctypes_of) == ops._ARGTYPES


@pytest.mark.parametrize("dh", [80, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_wgmma_numerics_fit_the_reference_bf16_limit(dh, causal):
    """The tensor-core route rounds P to bf16 before P·V (the TPU kernel
    keeps it float32): its plain emulation, against the reference kernel
    in interpret mode, stays within the reference's bf16 limit."""
    q, k, v = _qkv(1, 2, 1, 512, dh, 100 + dh)
    bf = [torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v)]
    got = attention_wgmma_emulation(*bf, causal=causal)
    want = _reference(q, k, v, causal=causal, dtype=jnp.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == (1, 2, 512, dh)
    err = np.abs(got.float().numpy() - np.asarray(want, np.float32)).max()
    assert err < 2e-2


def test_wgmma_emulation_is_the_plain_version_in_float32():
    """In float32 nothing is rounded: the tiled base-2 online softmax is the
    plain softmax up to summation order."""
    q, k, v = (torch.from_numpy(t) for t in _qkv(2, 4, 2, 300, 64, 5))
    for causal in (True, False):
        torch.testing.assert_close(
            attention_wgmma_emulation(q, k, v, causal=causal),
            attention_ref(q, k, v, causal=causal), atol=2e-5, rtol=1e-4)


def test_tma_operand_keeps_strided_views_in_place():
    """The model's q ([B, S, H, dh] seen as [B, H, S, dh]) is read where it
    lies; a size-1 axis is given a contiguous stride whatever torch says."""
    q = torch.zeros(2, 64, 4, 128, dtype=torch.bfloat16).transpose(1, 2)
    assert ops._tma_operand(q) is q
    assert ops._strides(q) == [64 * 4 * 128, 128, 4 * 128]
    one = torch.zeros(1, 4, 64, 128, dtype=torch.bfloat16)[:, :1]
    assert ops._strides(one) == [64 * 128, 64 * 128, 128]


@pytest.mark.parametrize("breakage", ["offset", "row_stride", "expanded",
                                      "last_axis"])
def test_tma_operand_copies_what_tma_cannot_read(breakage):
    """A base or a stride that is not a multiple of 16 bytes, a zero
    stride or a strided last axis: the wrapper reads a contiguous copy."""
    base = torch.arange(2 * 4 * 64 * 136, dtype=torch.float32).to(
        torch.bfloat16).reshape(2, 4, 64, 136)
    if breakage == "offset":            # base 2 bytes past an aligned one
        t = base[..., 1:129]
    elif breakage == "row_stride":      # rows 136 + 1 elements apart
        t = torch.zeros(2, 4, 64 * 137, dtype=torch.bfloat16)[
            ..., :64 * 137].reshape(2, 4, 64, 137)[..., :128]
    elif breakage == "expanded":        # a KV head broadcast: stride 0
        t = base[:, :1, :, :128].expand(2, 4, 64, 128)
    else:
        t = base[..., :128].transpose(2, 3)
    got = ops._tma_operand(t)
    assert got is not t and got.is_contiguous()
    assert got.data_ptr() % 16 == 0 and torch.equal(got, t)
