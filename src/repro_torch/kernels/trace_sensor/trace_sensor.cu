// trace_sensor: the device pipeline's trace-sensor stage, by hand for Hopper
// (sm_90a).
//
// Replaces no TPU kernel. The reference emulates its sensors inside its
// jitted chunk step (src/repro/core/device_pipeline.py `_sensor_powers`),
// where XLA fuses the lookups, gathers and differences into a few passes.
// The port built the same stage from torch operations (ref.py in this
// folder): about 40 launches a chunk under RAPL and 27 under INA231, most of
// the chunk loop's launches, and [W, D, c] temporaries (gathers, products,
// the shifted energies) of 8 B a lane each. This kernel computes every
// worker's and rail's readings in one launch a chunk and holds nothing but
// its output.
//
// One thread per (worker w, sample i), lane = w * c + i, looping over the D
// rails, which share the worker's interval. E_d(x) = eint[w, d, k] +
// (x - bounds[w, k]) * powers[w, d, k], k = clip(#(ends[w] <= x), 0, m_w - 1),
// with the count from count_le.cuh: the grid route at k_max > 0, the binary
// search at k_max == 0 (searchsorted's counts either way).
//
// RAPL (ts_rapl), update period up:
//     tq[i]  = floor(t[i] * (1 / up) + 1e-6) * up
//     tp     = tq[i - 1], or at i = 0 the chain head
//              prev < 0 ? max(tq[0] - up, 0) : prev
//     out    = (E(tq[i]) - E(tp)) / max(tq[i] - tp, up)
// Each thread recomputes tq[i - 1] from t[i - 1] and looks it up itself, so
// E(tp) is bit for bit lane i - 1's E(tq). The new chain head is the largest
// tq over the valid lanes (prev when none is valid): a block maximum of the
// values' order-preserving int64 keys, one atomicMax a block into a
// two-word scratch, and the last block to finish writes it and resets the
// scratch for the next launch on the stream. A maximum is exact in any
// order, so the result does not depend on the blocks' schedule.
//
// INA231 (ts_ina231), window w_s:
//     lo  = max(t[i] - w_s, 0),  span = max(t[i] - lo, 1e-12)
//     out = (E(t[i]) - E(lo)) / span
// E(t[i]) takes the caller's counts cnt[w, i]; E(lo) looks lo up.
//
// Every product, sum, difference and quotient is rounded once, in ref.py's
// order (__dmul_rn, __dadd_rn, __dsub_rn, __ddiv_rn: nvcc contracts nothing,
// so eint + dx * powers is two roundings, not an FMA). The quotient t / up is
// taken as t * (1 / up), with 1 / up rounded once on the host: that is how
// PyTorch's CUDA kernels divide a tensor by a Python scalar, and ref.py
// writes it so on the CPU too, so the readings are the same bits on both
// devices.
//
// Bound on this card. A chunk of c = 65536 lanes reads the times (8 B a
// lane), the valid flags or counts (1 or 8 B) and writes W * D * c readings;
// the timeline's rows a lane touches are a few cache lines shared by
// neighbouring lanes. At W = 1, D = 3 that is ~2.2 MB, under a microsecond at
// 3.35 TB/s: the kernel is bound by its launch, and its design is one pass.

#include <cuda_runtime.h>
#include <stdint.h>

#include "../count_le/count_le.cuh"

#define TS_BLOCK 256                       // threads (lanes) per CTA
#define TS_WARPS (TS_BLOCK / 32)
#define TS_NONE INT64_MIN                  // no valid lane: below every key

// The timeline's device arrays (repro_torch.core.device_pipeline.
// DeviceTimeline), row-major: ends [W, M], bounds [W, M + 1], eint
// [W, D, M + 1], powers [W, D, M] (D = 1 is the flat [W, .] layout), m_true
// [W], grid [W, G + 2], cell [W]; k_max is the grid window (0: search).
struct Trace {
    const double* __restrict__ ends;
    const double* __restrict__ bounds;
    const double* __restrict__ eint;
    const double* __restrict__ powers;
    const int32_t* __restrict__ m_true;
    const int32_t* __restrict__ grid;
    const double* __restrict__ cell;
    int64_t M, G, D, k_max;
};

// The interval index clip(#(ends[w] <= x), 0, m_w - 1).
__device__ __forceinline__ int64_t interval(const Trace& tr, int64_t w,
                                            int64_t cnt)
{
    const int64_t hi = (int64_t)tr.m_true[w] - 1;
    cnt = cnt < 0 ? 0 : cnt;
    return cnt < hi ? cnt : hi;
}

__device__ __forceinline__ int64_t locate(const Trace& tr, int64_t w,
                                          double x)
{
    const double* row = tr.ends + w * tr.M;
    const int64_t cnt = tr.k_max > 0
        ? count_le_grid_lane(row, tr.grid + w * (tr.G + 2), tr.cell[w],
                             tr.M, tr.G, tr.k_max, x)
        : count_le_search_lane(row, tr.M, x);
    return interval(tr, w, cnt);
}

// x - bounds[w, k]: the time into the interval, shared by the rails.
__device__ __forceinline__ double into(const Trace& tr, int64_t w, int64_t k,
                                       double x)
{
    return __dsub_rn(x, tr.bounds[w * (tr.M + 1) + k]);
}

// E_d = eint[w, d, k] + dx * powers[w, d, k], two roundings.
__device__ __forceinline__ double energy(const Trace& tr, int64_t w,
                                         int64_t d, int64_t k, double dx)
{
    const int64_t r = w * tr.D + d;
    return __dadd_rn(tr.eint[r * (tr.M + 1) + k],
                     __dmul_rn(dx, tr.powers[r * tr.M + k]));
}

__device__ __forceinline__ double quantise(double x, double up, double inv_up)
{
    return __dmul_rn(floor(__dadd_rn(__dmul_rn(x, inv_up), 1e-6)), up);
}

// An int64 whose signed order is the doubles' order (NaN aside).
__device__ __forceinline__ long long order_key(double v)
{
    const long long b = __double_as_longlong(v);
    return b >= 0 ? b : b ^ 0x7FFFFFFFFFFFFFFFLL;
}

__device__ __forceinline__ double from_key(long long k)
{
    return __longlong_as_double(k >= 0 ? k : k ^ 0x7FFFFFFFFFFFFFFFLL);
}

__global__ void __launch_bounds__(TS_BLOCK)
ts_rapl(Trace tr, const double* __restrict__ t, const bool* __restrict__ valid,
        const double* __restrict__ prev, double* __restrict__ out,
        double* __restrict__ new_prev, long long* __restrict__ scratch,
        int64_t W, int64_t c, double up, double inv_up)
{
    const int64_t lane = (int64_t)blockIdx.x * TS_BLOCK + threadIdx.x;
    long long key = TS_NONE;
    if (lane < W * c) {
        const int64_t w = lane / c;
        const int64_t i = lane - w * c;
        const double tq = quantise(t[i], up, inv_up);
        double tp;
        if (i > 0) {
            tp = quantise(t[i - 1], up, inv_up);
        } else {
            const double p = *prev;
            const double head = __dsub_rn(tq, up);
            tp = p < 0.0 ? (head < 0.0 ? 0.0 : head) : p;
        }
        const int64_t kq = locate(tr, w, tq);
        const int64_t kp = locate(tr, w, tp);
        const double dq = into(tr, w, kq, tq);
        const double dp = into(tr, w, kp, tp);
        double dt = __dsub_rn(tq, tp);
        dt = dt < up ? up : dt;
        for (int64_t d = 0; d < tr.D; ++d)
            out[(w * tr.D + d) * c + i] = __ddiv_rn(
                __dsub_rn(energy(tr, w, d, kq, dq), energy(tr, w, d, kp, dp)),
                dt);
        if (valid[i]) key = order_key(tq);
    }

    // The largest key of the block, then of the grid.
    for (int off = 16; off > 0; off >>= 1) {
        const long long other = __shfl_down_sync(0xffffffffu, key, off);
        key = other > key ? other : key;
    }
    __shared__ long long warp_key[TS_WARPS];
    __shared__ bool last;
    if ((threadIdx.x & 31) == 0) warp_key[threadIdx.x >> 5] = key;
    __syncthreads();
    if (threadIdx.x == 0) {
        for (int j = 1; j < TS_WARPS; ++j)
            key = warp_key[j] > key ? warp_key[j] : key;
        if (key != TS_NONE) atomicMax(&scratch[0], key);
        __threadfence();
        const unsigned long long done =
            atomicAdd((unsigned long long*)&scratch[1], 1ULL);
        last = done == (unsigned long long)gridDim.x - 1;
    }
    __syncthreads();
    if (last && threadIdx.x == 0) {
        const long long top = (long long)atomicExch(
            (unsigned long long*)&scratch[0], (unsigned long long)TS_NONE);
        scratch[1] = 0;
        *new_prev = top == TS_NONE ? *prev : from_key(top);
    }
}

__global__ void __launch_bounds__(TS_BLOCK)
ts_ina231(Trace tr, const double* __restrict__ t,
          const int64_t* __restrict__ cnt, double* __restrict__ out,
          int64_t W, int64_t c, double window)
{
    const int64_t lane = (int64_t)blockIdx.x * TS_BLOCK + threadIdx.x;
    if (lane >= W * c) return;
    const int64_t w = lane / c;
    const int64_t i = lane - w * c;
    const double x = t[i];
    double lo = __dsub_rn(x, window);
    lo = lo < 0.0 ? 0.0 : lo;
    double span = __dsub_rn(x, lo);
    span = span < 1e-12 ? 1e-12 : span;
    const int64_t kx = interval(tr, w, cnt[lane]);
    const int64_t kl = locate(tr, w, lo);
    const double dx = into(tr, w, kx, x);
    const double dl = into(tr, w, kl, lo);
    for (int64_t d = 0; d < tr.D; ++d)
        out[(w * tr.D + d) * c + i] = __ddiv_rn(
            __dsub_rn(energy(tr, w, d, kx, dx), energy(tr, w, d, kl, dl)),
            span);
}

extern "C" {

const char* trace_sensor_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// Every worker's and rail's sensor readings for one chunk of c shared sample
// times t [c] float64, into out [W, D, c] float64 (row-major), on `stream` of
// `device`. kind 0 is RAPL (param = update period, inv_param = 1 / param
// rounded once; valid [c] bool, prev a 0-d float64 read by lane 0, new_prev a
// 0-d float64 written once, scratch two int64 words holding {INT64_MIN, 0}
// between launches on the stream); kind 1 is INA231 (param = window; cnt
// [W, c] int64, the counts of t). The timeline's arrays as in struct Trace.
// Returns a cudaError_t (0 on success); nothing is synchronised.
int trace_sensor(int kind, const double* t, const int64_t* cnt,
                 const bool* valid, const double* prev, const double* ends,
                 const double* bounds, const double* eint,
                 const double* powers, const int32_t* m_true,
                 const int32_t* grid, const double* cell, double* out,
                 double* new_prev, long long* scratch, int64_t W, int64_t D,
                 int64_t M, int64_t G, int64_t c, int64_t k_max,
                 double param, double inv_param, void* stream, int device)
{
    if (W <= 0 || c <= 0 || D <= 0 || M <= 0 || G < 0 || k_max < 0
            || c > INT64_MAX / W
            || W * c > (int64_t)INT32_MAX * TS_BLOCK
            || (kind != 0 && kind != 1))
        return (int)cudaErrorInvalidValue;
    // This library links its own CUDA runtime, whose current device is
    // separate from PyTorch's: select the tensors' device explicitly.
    cudaError_t se = cudaSetDevice(device);
    if (se != cudaSuccess) return (int)se;
    const Trace tr = {ends, bounds, eint, powers, m_true, grid, cell,
                      M, G, D, k_max};
    const unsigned blocks = (unsigned)((W * c + TS_BLOCK - 1) / TS_BLOCK);
    if (kind == 0)
        ts_rapl<<<blocks, TS_BLOCK, 0, (cudaStream_t)stream>>>(
            tr, t, valid, prev, out, new_prev, scratch, W, c, param,
            inv_param);
    else
        ts_ina231<<<blocks, TS_BLOCK, 0, (cudaStream_t)stream>>>(
            tr, t, cnt, out, W, c, param);
    return (int)cudaGetLastError();
}

}  // extern "C"
