// rmsnorm: fused RMSNorm, by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm/rmsnorm.py (`_kernel`,
// driven by `rmsnorm_pallas`):
//
//     out[i, :] = x[i, :] * rsqrt(mean_j x[i, j]^2 + eps) * scale[:]
//
// accumulated in float32, written in x's dtype (float32, bfloat16 or
// float16); `scale` is read as float32.
//
// Bound on this card. Per row it reads d values and writes d values and does
// about 4 operations per value, so it is bound by bytes: at [8192, 2048]
// bf16 that is 67 MB against 3.35 TB/s, about 0.020 ms.
//
// Design. The TPU kernel padded d to 128 lanes and n to 256 rows with a copy
// and divided by the true d. Here one warp owns one row (8 rows per CTA of
// 256 threads), so any d works with no padding copy: pass 1 sums x^2 in
// float32 (each lane a strided share, then a butterfly over the warp), pass 2
// reads the row again (from L1/L2 in practice) and writes the result. Where
// d is a multiple of 16 bytes' worth of elements and the pointers are 16-byte
// aligned, lanes move 16 bytes per load and store; otherwise one element at a
// time. Rows never share a warp, so no synchronisation is needed.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define RN_WARPS 8
#define RN_THREADS (RN_WARPS * 32)

static __device__ __forceinline__ float to_f(float v) { return v; }
static __device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
static __device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T> static __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
    return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) { return __float2half_rn(v); }

static __device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(RN_THREADS)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
               T* __restrict__ out, int64_t n, int64_t d, float eps)
{
    constexpr int V = VEC ? 16 / (int)sizeof(T) : 1;   // elements per access
    const int lane = threadIdx.x & 31;
    const int64_t row = (int64_t)blockIdx.x * RN_WARPS + (threadIdx.x >> 5);
    if (row >= n) return;                 // uniform across the warp
    const T* xr = x + row * d;
    T* orow = out + row * d;

    float ss = 0.f;
    for (int64_t j = (int64_t)lane * V; j < d; j += 32 * V) {
        if constexpr (VEC) {
            alignas(16) T buf[V];
            *reinterpret_cast<uint4*>(buf) = *reinterpret_cast<const uint4*>(xr + j);
#pragma unroll
            for (int e = 0; e < V; ++e) { const float f = to_f(buf[e]); ss += f * f; }
        } else {
            const float f = to_f(xr[j]);
            ss += f * f;
        }
    }
    ss = warp_sum(ss);
    const float r = 1.0f / sqrtf(ss / (float)d + eps);

    for (int64_t j = (int64_t)lane * V; j < d; j += 32 * V) {
        if constexpr (VEC) {
            alignas(16) T buf[V];
            *reinterpret_cast<uint4*>(buf) = *reinterpret_cast<const uint4*>(xr + j);
#pragma unroll
            for (int e = 0; e < V; ++e) buf[e] = from_f<T>(to_f(buf[e]) * r * scale[j + e]);
            *reinterpret_cast<uint4*>(orow + j) = *reinterpret_cast<const uint4*>(buf);
        } else {
            orow[j] = from_f<T>(to_f(xr[j]) * r * scale[j]);
        }
    }
}

template <typename T>
static int launch(const void* x, const float* scale, void* out, int64_t n,
                  int64_t d, float eps, cudaStream_t st)
{
    const int64_t blocks = (n + RN_WARPS - 1) / RN_WARPS;
    if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
    constexpr int V = 16 / (int)sizeof(T);
    const bool vec = d % V == 0 && ((uintptr_t)x % 16) == 0
                     && ((uintptr_t)out % 16) == 0;
    if (vec)
        rmsnorm_kernel<T, true><<<(unsigned)blocks, RN_THREADS, 0, st>>>(
            (const T*)x, scale, (T*)out, n, d, eps);
    else
        rmsnorm_kernel<T, false><<<(unsigned)blocks, RN_THREADS, 0, st>>>(
            (const T*)x, scale, (T*)out, n, d, eps);
    return (int)cudaGetLastError();
}

extern "C" {

const char* rmsnorm_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// out[n, d] = rmsnorm(x[n, d]) * scale[d] on `stream` of `device`; x and out
// contiguous, dtype 0 = float32, 1 = bfloat16, 2 = float16. Returns a
// cudaError_t (0 on success); nothing is synchronised.
int rmsnorm_fwd(const void* x, const float* scale, void* out, int64_t n,
                int64_t d, float eps, int dtype, void* stream, int device)
{
    if (n <= 0 || d <= 0) return 0;
    // This library links its own CUDA runtime, whose current device is
    // separate from PyTorch's: select the tensors' device explicitly.
    cudaError_t se = cudaSetDevice(device);
    if (se != cudaSuccess) return (int)se;
    cudaStream_t st = (cudaStream_t)stream;
    switch (dtype) {
    case 0: return launch<float>(x, scale, out, n, d, eps, st);
    case 1: return launch<__nv_bfloat16>(x, scale, out, n, d, eps, st);
    case 2: return launch<__half>(x, scale, out, n, d, eps, st);
    default: return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
