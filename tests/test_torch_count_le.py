"""The interval lookup's CUDA kernel (``kernels/count_le``) on the card:
its counts against the plain version's bit for bit, one launch a call,
and a working set that does not follow the timeline's grid window. Every
test here needs a CUDA card and skips without one; on the card:
``python -m pytest -m gpu tests/test_torch_count_le.py``."""

import pytest
import torch

from repro_torch.core import device_pipeline as dp
from repro_torch.kernels.count_le import ops
from repro_torch.kernels.count_le.ref import count_le_ref
from _torch_count_le_cases import lookup_case


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("the count_le kernel runs only on a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("workers", [1, 4, 16])
@pytest.mark.parametrize("k", [1, 3, 5])
def test_count_le_kernel_bit_equal_to_ref(cuda_device, workers, k):
    """The kernel's counts equal ref.py's on the CPU and searchsorted's on
    the card, for lane counts that are and are not a multiple of its
    block; one launch a call through _count_le. ref.py's counts on these
    inputs are the JAX reference's (``test_count_le_ref_equals_jax``, a
    CPU test: the JAX reference is not run beside the card)."""
    for n in (4096, 4099):
        dtl, t = lookup_case(workers, k, n=n, seed=workers * 10 + k,
                             device=cuda_device)
        want = count_le_ref(dtl.ends.cpu(), dtl.grid.cpu(), dtl.cell.cpu(),
                            t.cpu(), dtl.grid_k)
        before = ops.count_le.launches
        got = dp._count_le(dtl.ends, dtl.grid, dtl.cell, t, dtl.grid_k)
        torch.cuda.synchronize()
        assert ops.count_le.launches - before == 1
        assert got.dtype == torch.int64 and got.shape == (workers, n)
        assert torch.equal(got.cpu(), want)
        assert torch.equal(got, torch.searchsorted(
            dtl.ends, t.expand(workers, -1).contiguous(), right=True))


@pytest.mark.gpu
def test_count_le_peak_does_not_follow_the_grid_window(cuda_device):
    """Two timelines of one shape whose grid windows differ (4 and 5 ends
    a cell): one _count_le call takes the same peak device memory."""
    peaks = {}
    for k in (4, 5):
        dtl, t = lookup_case(4, k, n=65536, seed=3, device=cuda_device)
        assert dtl.grid_k == k
        dp._count_le(dtl.ends, dtl.grid, dtl.cell, t, dtl.grid_k)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = dp._count_le(dtl.ends, dtl.grid, dtl.cell, t, dtl.grid_k)
        torch.cuda.synchronize()
        peaks[k] = torch.cuda.max_memory_allocated() - base
        assert peaks[k] == out.numel() * out.element_size()
        del out
    assert peaks[4] == peaks[5], peaks
