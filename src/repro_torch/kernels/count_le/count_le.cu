// count_le: the device pipeline's interval lookup, by hand for Hopper (sm_90a).
//
// Replaces no TPU kernel. The reference finds each sample's interval inside
// its jitted chunk step (src/repro/core/device_pipeline.py `_count_le`), where
// XLA fuses the grid route's gathers and compares into one pass. The port
// built the same route from torch operations (ref.py in this folder): about
// 26 launches a lookup, and a compare window of [W, c, k] int64 positions, a
// clamped copy, the gathered ends and three boolean masks, some 28 B a lane
// per unit of k, so the pipeline's peak memory followed k, a statistic of
// the profiled timeline. This kernel computes the same counts in one launch
// and holds nothing but its [W, n] output.
//
// For worker w and sample i (one thread per lane, lane = w * n + i) it runs
// count_le_grid_lane (count_le.cuh, shared with the trace_sensor kernel):
// the guarded grid cell of t[i], its prefix count grid[w, g], then at most
// k_max compares, each division, product and comparison rounded once as in
// ref.py. grid[w, g] is #(ends[w] <= g * cell[w]) with the same products,
// so the guarded cell and at most k_max compares give #(ends[w] <= t[i]):
// searchsorted(side="right") bit for bit.
//
// Bound on this card. A lookup reads n sample times (8 B each) and writes W * n
// counts; the grid and the ends a lane touches are a few cache lines of one
// worker, shared by neighbouring lanes (L2-resident across a chunk). At
// W = 4, n = 65536 the least traffic is ~1.3 MB, under a microsecond at
// 3.35 TB/s: like sample_clock, the kernel is bound by its launch, and its
// design is one pass with no shared memory and no synchronisation.

#include <cuda_runtime.h>
#include <stdint.h>

#include "count_le.cuh"

#define CL_BLOCK 256                       // threads (lanes) per CTA

__global__ void __launch_bounds__(CL_BLOCK)
count_le_grid(const double* __restrict__ ends, const int32_t* __restrict__ grid,
              const double* __restrict__ cell, const double* __restrict__ t,
              int64_t* __restrict__ out, int64_t W, int64_t M, int64_t G,
              int64_t n, int64_t k_max)
{
    const int64_t lane = (int64_t)blockIdx.x * CL_BLOCK + threadIdx.x;
    if (lane >= W * n) return;
    const int64_t w = lane / n;
    out[lane] = count_le_grid_lane(ends + w * M, grid + w * (G + 2), cell[w],
                                   M, G, k_max, t[lane - w * n]);
}

extern "C" {

const char* count_le_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// #(ends[w] <= t[i]) for every worker w < W and sample i < n, into out [W, n]
// int64 (row-major), on `stream` of `device`: ends [W, M] float64, grid
// [W, G + 2] int32 and cell [W] float64 of the timeline's grid accelerator,
// t [n] float64 shared by the workers, at most k_max ends a cell. Returns a
// cudaError_t (0 on success); nothing is synchronised.
int count_le(const double* ends, const int32_t* grid, const double* cell,
             const double* t, int64_t* out, int64_t W, int64_t M, int64_t G,
             int64_t n, int64_t k_max, void* stream, int device)
{
    if (W <= 0 || n <= 0) return 0;
    if (M <= 0 || G < 0 || k_max <= 0 || n > INT64_MAX / W
            || W * n > (int64_t)INT32_MAX * CL_BLOCK)
        return (int)cudaErrorInvalidValue;
    // This library links its own CUDA runtime, whose current device is
    // separate from PyTorch's: select the tensors' device explicitly.
    cudaError_t se = cudaSetDevice(device);
    if (se != cudaSuccess) return (int)se;
    const unsigned blocks = (unsigned)((W * n + CL_BLOCK - 1) / CL_BLOCK);
    count_le_grid<<<blocks, CL_BLOCK, 0, (cudaStream_t)stream>>>(
        ends, grid, cell, t, out, W, M, G, n, k_max);
    return (int)cudaGetLastError();
}

}  // extern "C"
