// sample_clock: the device pipeline's sample clock, by hand for Hopper (sm_90a).
//
// Replaces no TPU kernel. The reference draws a chunk's sample times with
// jax.random and a few float64 operations inside its jitted chunk step
// (src/repro/core/device_pipeline.py `chunk_sample_times`), which XLA fuses
// into one pass. The port built the same draw from int64 and float64 torch
// operations (src/repro_torch/kernels/sample_clock/ref.py): ~260 launches of a
// few microseconds of work each per chunk, which set the pace of the whole
// chunk loop. This kernel computes the same bits in one launch.
//
// For lane i of chunk k (one thread per lane):
//
//     (b1, b2) = threefry2x32(key, (i >> 32, i & 0xFFFFFFFF))   20 rounds
//     f  = as_double((b1 << 20 | b2 >> 12) | bits(1.0)) - 1.0
//     u  = max(f * span + lo, lo)
//     t  = fma(base + i, period, u0) + u
//     t  = floor(fma(t, 1e9, 0.5)) * 1e-9
//
// with key = fold_in(root, k + 1) and base = k * c computed on the host, and,
// when `valid` is given, valid = t < t_end and t = min(t, t_end) (the rest of
// the pipeline's clock stage). The reference's XLA build contracts the two
// products marked fma into fused multiply-adds; they are __fma_rn here, the
// single rounding ref.py emulates. Every other product and sum is an explicit
// __dmul_rn / __dadd_rn / __dsub_rn, so nvcc contracts nothing else (the build
// keeps --fmad at its default for the other kernels) and the times are those
// of ref.py bit for bit.
//
// Bound on this card. A lane reads nothing and writes 8 B of time and 1 B of
// mask: 0.59 MB at c = 65536, 0.18 us at 3.35 TB/s. Its ~200 integer
// operations and 8 float64 ones are far below the card's rates. The kernel
// is bound by its launch; its design is one pass with no shared memory and
// no synchronisation.

#include <cuda_runtime.h>
#include <stdint.h>

#define SC_BLOCK 256                       // threads (lanes) per CTA
#define SC_PARITY 0x1BD11BDAu
#define SC_ONE_BITS 0x3FF0000000000000ull  // float64 1.0

__device__ __forceinline__ uint32_t rotl(uint32_t v, int r) {
    return (v << r) | (v >> (32 - r));
}

// Threefry-2x32, 20 rounds: core/threefry.py `threefry2x32` on uint32.
__device__ __forceinline__ uint2 threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t x0, uint32_t x1) {
    const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ SC_PARITY};
    const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
    x0 += ks[0];
    x1 += ks[1];
#pragma unroll
    for (int i = 0; i < 5; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            x0 += x1;
            x1 = rotl(x1, rot[i % 2][j]) ^ x0;
        }
        x0 += ks[(i + 1) % 3];
        x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
    }
    return make_uint2(x0, x1);
}

__global__ void __launch_bounds__(SC_BLOCK)
sc_clock(uint32_t k0, uint32_t k1, int64_t base, int64_t c, double period,
         double u0, double lo, double span, double t_end,
         double* __restrict__ t, uint8_t* __restrict__ valid)
{
    const int64_t i = (int64_t)blockIdx.x * SC_BLOCK + threadIdx.x;
    if (i >= c) return;
    const uint2 b = threefry2x32(k0, k1, (uint32_t)((uint64_t)i >> 32),
                                 (uint32_t)i);
    const uint64_t m = ((uint64_t)b.x << 20) | (uint64_t)(b.y >> 12);
    const double f =
        __dsub_rn(__longlong_as_double((long long)(m | SC_ONE_BITS)), 1.0);
    double u = __dadd_rn(__dmul_rn(f, span), lo);
    u = u < lo ? lo : u;                   // clamp_min; NaN passes, as torch's
    const double x = __ll2double_rn(base + i);
    const double s = __dadd_rn(__fma_rn(x, period, u0), u);
    double q = __dmul_rn(floor(__fma_rn(s, 1e9, 0.5)), 1e-9);
    if (valid != nullptr) {
        valid[i] = q < t_end;
        q = q > t_end ? t_end : q;         // clamp_max; NaN passes
    }
    t[i] = q;
}

extern "C" {

const char* sample_clock_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// Chunk times of lanes [0, c) on `stream` of `device`: t [c] float64 and,
// if `valid` is not null, valid [c] bool (one byte a lane) with t clamped to
// t_end. (k0, k1) is the chunk's threefry key, base the global index of lane
// 0, (lo, span) the jitter draw's offset and width. Returns a cudaError_t (0
// on success); nothing is synchronised.
int sample_clock(uint32_t k0, uint32_t k1, int64_t base, int64_t c,
                 double period, double u0, double lo, double span,
                 double t_end, double* t, uint8_t* valid, void* stream,
                 int device)
{
    if (c <= 0) return 0;
    if (base < 0 || c > INT64_MAX - base || c > (int64_t)INT32_MAX * SC_BLOCK)
        return (int)cudaErrorInvalidValue;
    // This library links its own CUDA runtime, whose current device is
    // separate from PyTorch's: select the tensors' device explicitly.
    cudaError_t se = cudaSetDevice(device);
    if (se != cudaSuccess) return (int)se;
    const unsigned grid = (unsigned)((c + SC_BLOCK - 1) / SC_BLOCK);
    sc_clock<<<grid, SC_BLOCK, 0, (cudaStream_t)stream>>>(
        k0, k1, base, c, period, u0, lo, span, t_end, t, valid);
    return (int)cudaGetLastError();
}

}  // extern "C"
