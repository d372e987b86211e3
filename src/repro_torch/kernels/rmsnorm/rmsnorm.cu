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
// bf16 that is 67 MB against 3.35 TB/s, about 0.020 ms. Reaching it takes
// each byte of x moved once, 16 bytes per load, and enough loads in flight.
//
// Design. The TPU kernel padded d to 128 lanes and n to 256 rows with a copy
// and divided by the true d. Here any d works with no padding copy, and the
// launch plan comes from the caller (ops.py `_plan`): `vec` elements per
// access (16 bytes, or 1 where d or a pointer does not allow it),
// `lanes` per row (the power of two >= d / vec, at most 32, so a warp
// holds 32 / lanes rows and a narrow row such as the qk-norm's d = 128 in
// bf16 keeps every lane busy), and `per_lane` vectors per lane.
//
//   per_lane > 0: the row stays in registers. A lane issues all its 16-byte
//     loads of the row before it sums, the sum of squares is a butterfly
//     over the row's lanes only, and the output is written from the same
//     registers: x is read once. `scale` is loaded once per warp, as float4,
//     into registers, and a persistent grid (as many CTAs as fit on the
//     SMs) lets each warp walk many rows with it. Where a lane holds at most
//     two vectors (narrow rows), the next row's loads are in flight while
//     this row is reduced and written.
//   per_lane = 0 (looped): rows wider than the registers hold (more than 64
//     elements per lane) and the scalar path (vec = 1) read the row twice,
//     once for the sum and once for the output, with the same lane layout.
//
// The C side refuses a plan it was not compiled for; nothing falls back.
// At [8192, 2048] bf16 (per_lane 8, 128 registers a thread) it takes ~0.026
// ms, 76% of the bound, and at the qk-norm's [131072, 128] bf16 ~0.025 ms
// (NVIDIA H100 80GB HBM3 at 700 W, chip_smoke.py; PERF.md has every number).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define RN_WARPS 8
#define RN_THREADS (RN_WARPS * 32)
#define RN_FULL 0xffffffffu

static __device__ __forceinline__ float to_f(float v) { return v; }
static __device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
static __device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T> static __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
    return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) { return __float2half_rn(v); }

// V elements of T at p: one 16-byte access when V > 1.
template <typename T, int V> struct alignas(V > 1 ? 16 : alignof(T)) Vec { T e[V]; };

template <typename T, int V>
static __device__ __forceinline__ Vec<T, V> load_vec(const T* p) {
    Vec<T, V> r;
    if constexpr (V == 1) {
        r.e[0] = *p;
    } else {
        static_assert(sizeof(Vec<T, V>) == 16, "16-byte vectors");
        *reinterpret_cast<uint4*>(r.e) = *reinterpret_cast<const uint4*>(p);
    }
    return r;
}

template <typename T, int V>
static __device__ __forceinline__ void store_vec(T* p, const Vec<T, V>& r) {
    if constexpr (V == 1) *p = r.e[0];
    else *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(r.e);
}

// The compiler must take b as changed here, so the floats converted from it
// for the sum of squares are not held in registers until the output (that
// took 64 more registers a lane at d = 2048 in bf16 and halved occupancy).
template <typename T, int V>
static __device__ __forceinline__ void launder(Vec<T, V>& b) {
    uint32_t* w = reinterpret_cast<uint32_t*>(b.e);
#pragma unroll
    for (int q = 0; q < (int)sizeof(b) / 4; ++q) asm volatile("" : "+r"(w[q]));
}

// V floats of scale at p: float4 loads when V > 1 (V is 4 or 8).
template <int V>
static __device__ __forceinline__ void load_scale(const float* p, float (&s)[V]) {
    if constexpr (V == 1) {
        s[0] = *p;
    } else {
#pragma unroll
        for (int q = 0; q < V; q += 4) {
            const float4 f = *reinterpret_cast<const float4*>(p + q);
            s[q] = f.x; s[q + 1] = f.y; s[q + 2] = f.z; s[q + 3] = f.w;
        }
    }
}

// Sum over the `lanes` lanes of one row (aligned groups of a power of two).
static __device__ __forceinline__ float row_sum(float v, int lanes) {
    for (int off = lanes >> 1; off > 0; off >>= 1)
        v += __shfl_xor_sync(RN_FULL, v, off);
    return v;
}

template <typename T, int V, int PL>
__global__ void __launch_bounds__(RN_THREADS)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
               T* __restrict__ out, int64_t n, int64_t d, float eps, int lanes)
{
    const int lane = threadIdx.x & 31;
    const int sub = lane & (lanes - 1);          // lane within its row
    const int rows = 32 / lanes;                 // rows per warp
    const int64_t nvec = d / V;
    const int64_t warp0 = (int64_t)blockIdx.x * RN_WARPS + (threadIdx.x >> 5);
    const int64_t nwarps = (int64_t)gridDim.x * RN_WARPS;

    if constexpr (PL > 0) {
        // Narrow rows (at most two vectors a lane) hold few registers:
        // there the next row's loads are issued before this row is reduced.
        constexpr bool ahead = PL <= 2;
        float sc[PL][V];
#pragma unroll
        for (int p = 0; p < PL; ++p) {
            const int64_t j = sub + (int64_t)p * lanes;
            if (j < nvec) load_scale<V>(scale + j * V, sc[p]);
        }
        Vec<T, V> buf[PL];
        if constexpr (ahead) {
            const int64_t row = warp0 * rows + lane / lanes;
#pragma unroll
            for (int p = 0; p < PL; ++p) {
                const int64_t j = sub + (int64_t)p * lanes;
                if (row < n && j < nvec) buf[p] = load_vec<T, V>(x + row * d + j * V);
            }
        }
        for (int64_t g = warp0; g * rows < n; g += nwarps) {   // uniform per warp
            const int64_t row = g * rows + lane / lanes;
            const bool live = row < n;
            Vec<T, V> nxt[PL];
            if constexpr (ahead) {
                const int64_t row2 = row + nwarps * rows;
#pragma unroll
                for (int p = 0; p < PL; ++p) {
                    const int64_t j = sub + (int64_t)p * lanes;
                    if (row2 < n && j < nvec) nxt[p] = load_vec<T, V>(x + row2 * d + j * V);
                }
            } else {
#pragma unroll
                for (int p = 0; p < PL; ++p) {
                    const int64_t j = sub + (int64_t)p * lanes;
                    if (live && j < nvec) buf[p] = load_vec<T, V>(x + row * d + j * V);
                }
            }
            float ss = 0.f;
#pragma unroll
            for (int p = 0; p < PL; ++p) {
                const int64_t j = sub + (int64_t)p * lanes;
                if (live && j < nvec) {
#pragma unroll
                    for (int e = 0; e < V; ++e) {
                        const float f = to_f(buf[p].e[e]);
                        ss += f * f;
                    }
                }
            }
            ss = row_sum(ss, lanes);
            const float r = 1.0f / sqrtf(ss / (float)d + eps);
#pragma unroll
            for (int p = 0; p < PL; ++p) launder<T, V>(buf[p]);
            T* orow = out + row * d;
#pragma unroll
            for (int p = 0; p < PL; ++p) {
                const int64_t j = sub + (int64_t)p * lanes;
                if (live && j < nvec) {
                    Vec<T, V> o;
#pragma unroll
                    for (int e = 0; e < V; ++e)
                        o.e[e] = from_f<T>(to_f(buf[p].e[e]) * r * sc[p][e]);
                    store_vec<T, V>(orow + j * V, o);
                }
            }
            if constexpr (ahead) {
#pragma unroll
                for (int p = 0; p < PL; ++p) buf[p] = nxt[p];
            }
        }
    } else {
        for (int64_t g = warp0; g * rows < n; g += nwarps) {
            const int64_t row = g * rows + lane / lanes;
            const bool live = row < n;
            const T* xr = x + row * d;
            float ss = 0.f;
            if (live) {
                for (int64_t j = sub; j < nvec; j += lanes) {
                    const Vec<T, V> b = load_vec<T, V>(xr + j * V);
#pragma unroll
                    for (int e = 0; e < V; ++e) {
                        const float f = to_f(b.e[e]);
                        ss += f * f;
                    }
                }
            }
            ss = row_sum(ss, lanes);
            const float r = 1.0f / sqrtf(ss / (float)d + eps);
            if (live) {
                T* orow = out + row * d;
                for (int64_t j = sub; j < nvec; j += lanes) {
                    const Vec<T, V> b = load_vec<T, V>(xr + j * V);
                    float s[V];
                    load_scale<V>(scale + j * V, s);
                    Vec<T, V> o;
#pragma unroll
                    for (int e = 0; e < V; ++e)
                        o.e[e] = from_f<T>(to_f(b.e[e]) * r * s[e]);
                    store_vec<T, V>(orow + j * V, o);
                }
            }
        }
    }
}

// Grid of as many CTAs as fit on the device at once (per instantiation and
// device, asked once), never more than the rows need.
template <typename T, int V, int PL>
static int launch(const void* x, const float* scale, void* out, int64_t n,
                  int64_t d, float eps, int lanes, int device, cudaStream_t st)
{
    static int resident[64];                 // CTAs per device, 0 = not asked
    if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
    if (resident[device] == 0) {
        int sms = 0, per_sm = 0;
        cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
        if (e == cudaSuccess)
            e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, rmsnorm_kernel<T, V, PL>, RN_THREADS, 0);
        if (e != cudaSuccess) return (int)e;
        if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
        resident[device] = sms * per_sm;
    }
    const int64_t rows = 32 / lanes;
    const int64_t groups = (n + rows - 1) / rows;
    int64_t blocks = (groups + RN_WARPS - 1) / RN_WARPS;
    if (blocks > resident[device]) blocks = resident[device];
    rmsnorm_kernel<T, V, PL><<<(unsigned)blocks, RN_THREADS, 0, st>>>(
        (const T*)x, scale, (T*)out, n, d, eps, lanes);
    return (int)cudaGetLastError();
}

// The compiled plans of one dtype: vec 16 / sizeof(T) with per_lane in
// {0 (looped), 1, 2, 4, 8} and, for float32, 16 (at most 64 elements per
// lane in registers), and vec 1 looped.
template <typename T>
static int dispatch(const void* x, const float* scale, void* out, int64_t n,
                    int64_t d, float eps, int vec, int lanes, int per_lane,
                    int device, cudaStream_t st)
{
    constexpr int V = 16 / (int)sizeof(T);
    if (vec == 1) {
        if (per_lane != 0) return (int)cudaErrorInvalidValue;
        return launch<T, 1, 0>(x, scale, out, n, d, eps, lanes, device, st);
    }
    if (vec != V) return (int)cudaErrorInvalidValue;
    switch (per_lane) {
    case 0: return launch<T, V, 0>(x, scale, out, n, d, eps, lanes, device, st);
    case 1: return launch<T, V, 1>(x, scale, out, n, d, eps, lanes, device, st);
    case 2: return launch<T, V, 2>(x, scale, out, n, d, eps, lanes, device, st);
    case 4: return launch<T, V, 4>(x, scale, out, n, d, eps, lanes, device, st);
    case 8: return launch<T, V, 8>(x, scale, out, n, d, eps, lanes, device, st);
    case 16:
        if constexpr (V * 16 <= 64)
            return launch<T, V, 16>(x, scale, out, n, d, eps, lanes, device, st);
        return (int)cudaErrorInvalidValue;
    default: return (int)cudaErrorInvalidValue;
    }
}

extern "C" {

const char* rmsnorm_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// out[n, d] = rmsnorm(x[n, d]) * scale[d] on `stream` of `device`; x and out
// contiguous, dtype 0 = float32, 1 = bfloat16, 2 = float16; the plan (vec,
// lanes, rows, per_lane) from ops.py `_plan`. Returns a cudaError_t (0 on
// success; cudaErrorInvalidValue for a plan not compiled here or that does
// not fit d and the pointers); nothing is synchronised.
int rmsnorm_fwd(const void* x, const float* scale, void* out, int64_t n,
                int64_t d, float eps, int dtype, int vec, int lanes, int rows,
                int per_lane, void* stream, int device)
{
    if (n <= 0 || d <= 0) return 0;
    const bool pow2 = lanes > 0 && lanes <= 32 && (lanes & (lanes - 1)) == 0;
    if (!pow2 || rows * lanes != 32 || vec < 1 || d % vec != 0)
        return (int)cudaErrorInvalidValue;
    if (per_lane > 0 && (int64_t)per_lane * lanes * vec < d)
        return (int)cudaErrorInvalidValue;   // the row must fit the registers
    if (vec > 1 && (((uintptr_t)x | (uintptr_t)out | (uintptr_t)scale) % 16))
        return (int)cudaErrorInvalidValue;
    // This library links its own CUDA runtime, whose current device is
    // separate from PyTorch's: select the tensors' device explicitly.
    cudaError_t se = cudaSetDevice(device);
    if (se != cudaSuccess) return (int)se;
    cudaStream_t st = (cudaStream_t)stream;
    switch (dtype) {
    case 0: return dispatch<float>(x, scale, out, n, d, eps, vec, lanes, per_lane, device, st);
    case 1: return dispatch<__nv_bfloat16>(x, scale, out, n, d, eps, vec, lanes, per_lane, device, st);
    case 2: return dispatch<__half>(x, scale, out, n, d, eps, vec, lanes, per_lane, device, st);
    default: return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
