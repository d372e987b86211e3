// flash_attention: forward attention with an online softmax, by hand for
// Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/flash_attention.py
// (`_fa_kernel`, driven by `flash_attention_fwd`): for every (batch, head)
// and query row,
//
//     o[row] = sum_col p[col] * v[col] / sum_col p[col],
//     p[col] = exp(s[col] - max s),   s[col] = (q[row] . k[col]) * dh^-0.5,
//
// with s = NEG_INF (-2e38) where the causal mask (col <= row, by index) or the
// ragged tail (col >= T) excludes a key, the denominator clamped at 1e-30,
// scores, p and the p.v sums all float32, output in q's dtype (float32,
// bfloat16 or float16). GQA: query head h reads key/value head
// h / (H / KV) directly, which is the function the TPU kernel computed on
// K/V repeated to H heads, without materialising the repeat.
//
// Bound on this card. At the model's prefill shape (B=4, H=16, S=2048,
// dh=128, causal) the work is 4*B*H*S^2*dh/2 = 6.9e10 operations against
// 134 MB of q, k, v and o: operations bound it (0.069 ms at 989 TFLOP/s bf16
// on the tensor cores, against 0.040 ms for the bytes).
//
// Two kernels, chosen by the caller's `route` (ops.py `_route`, from dtype
// and dh alone; nothing falls back from one to the other):
//   * route 1, "wgmma" (flash_attention_wgmma.cuh): bf16 and fp16 at dh 64,
//     80 and 128 on the tensor cores, TMA loads into a ring of K/V tiles, a
//     producer warpgroup and two consumer warpgroups. P is rounded to the
//     input type before P.V (the TPU kernel keeps it float32); scores, the
//     softmax and both accumulators stay float32.
//   * route 0, "simt" (below): float32 at any dh (TF32 would break the
//     reference's float32 limit) and dh=32 (reduced configs only), on the
//     CUDA cores in float32. One CTA owns one (b*h, 64-row query tile) and
//     walks the keys in tiles of 32 staged in shared memory as float32;
//     4 threads own one query row (float4 chunks interleaved across the
//     four), partial dot products combined with two shuffles, one rescale
//     of (l, acc) per tile; tiles above the diagonal are never loaded and
//     query tiles are issued longest first.
// Ragged S and T are masked, not asserted, on both routes.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define FA_BQ 64                      // query rows per CTA
#define FA_TPR 4                      // threads per query row
#define FA_THREADS (FA_BQ * FA_TPR)
#define FA_BKV 32                     // keys per shared-memory tile
#define FA_NEG_INF (-2.0e38f)

static __device__ __forceinline__ float to_f(float v) { return v; }
static __device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
static __device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T> static __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
    return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) { return __float2half_rn(v); }

struct FaStrides {                    // element strides of (batch, head, row)
    int64_t b, h, s;
};

template <typename T, int DH>
__global__ void __launch_bounds__(FA_THREADS, 2)
fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o,
              int H, int KV, int64_t S, int64_t Tk,
              FaStrides qs, FaStrides ks, FaStrides vs, FaStrides os,
              float scale, int causal)
{
    constexpr int NC = DH / (4 * FA_TPR);          // float4 chunks per thread
    static_assert(DH % (4 * FA_TPR) == 0, "dh must be a multiple of 16");
    __shared__ __align__(16) float Ks[FA_BKV * DH];
    __shared__ __align__(16) float Vs[FA_BKV * DH];

    const int tid = threadIdx.x;
    const int sub = tid % FA_TPR;
    const int64_t bh = blockIdx.x;
    const int b = (int)(bh / H), h = (int)(bh % H);
    const int kvh = h / (H / KV);
    const int64_t q0 = (int64_t)(gridDim.y - 1 - blockIdx.y) * FA_BQ;   // longest first
    const int64_t row = q0 + tid / FA_TPR;
    const bool row_ok = row < S;

    const T* qrow = q + b * qs.b + h * qs.h + row * qs.s;
    const T* kb = k + b * ks.b + kvh * ks.h;
    const T* vb = v + b * vs.b + kvh * vs.h;

    float qr[4 * NC], acc[4 * NC];
#pragma unroll
    for (int i = 0; i < NC; ++i) {
        const int c = (i * FA_TPR + sub) * 4;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            qr[i * 4 + e] = row_ok ? to_f(qrow[c + e]) : 0.f;
            acc[i * 4 + e] = 0.f;
        }
    }
    float m = FA_NEG_INF, l = 0.f;

    int64_t kv_end = Tk;
    if (causal && q0 + FA_BQ < kv_end) kv_end = q0 + FA_BQ;   // skip tiles above the diagonal

    for (int64_t k0 = 0; k0 < kv_end; k0 += FA_BKV) {
        __syncthreads();                           // the previous tile is consumed
        for (int idx = tid; idx < FA_BKV * DH; idx += FA_THREADS) {
            const int r = idx / DH, cc = idx % DH;
            const int64_t key = k0 + r;
            const bool ok = key < Tk;
            Ks[idx] = ok ? to_f(kb[key * ks.s + cc]) : 0.f;
            Vs[idx] = ok ? to_f(vb[key * vs.s + cc]) : 0.f;
        }
        __syncthreads();

        float s[FA_BKV];
        float m_tile = FA_NEG_INF;
#pragma unroll
        for (int j = 0; j < FA_BKV; ++j) {
            const float4* kr = reinterpret_cast<const float4*>(Ks + j * DH);
            float dot = 0.f;
#pragma unroll
            for (int i = 0; i < NC; ++i) {
                const float4 kk = kr[i * FA_TPR + sub];
                dot = fmaf(qr[i * 4 + 0], kk.x, dot);
                dot = fmaf(qr[i * 4 + 1], kk.y, dot);
                dot = fmaf(qr[i * 4 + 2], kk.z, dot);
                dot = fmaf(qr[i * 4 + 3], kk.w, dot);
            }
            dot += __shfl_xor_sync(0xffffffffu, dot, 1);
            dot += __shfl_xor_sync(0xffffffffu, dot, 2);
            const int64_t col = k0 + j;
            const bool keep = col < Tk && (!causal || col <= row);
            s[j] = keep ? dot * scale : FA_NEG_INF;
            m_tile = fmaxf(m_tile, s[j]);
        }

        const float m_new = fmaxf(m, m_tile);
        const float alpha = expf(m - m_new);
        l *= alpha;
#pragma unroll
        for (int i = 0; i < 4 * NC; ++i) acc[i] *= alpha;
#pragma unroll
        for (int j = 0; j < FA_BKV; ++j) {
            const float p = expf(s[j] - m_new);
            l += p;
            const float4* vr = reinterpret_cast<const float4*>(Vs + j * DH);
#pragma unroll
            for (int i = 0; i < NC; ++i) {
                const float4 vv = vr[i * FA_TPR + sub];
                acc[i * 4 + 0] = fmaf(p, vv.x, acc[i * 4 + 0]);
                acc[i * 4 + 1] = fmaf(p, vv.y, acc[i * 4 + 1]);
                acc[i * 4 + 2] = fmaf(p, vv.z, acc[i * 4 + 2]);
                acc[i * 4 + 3] = fmaf(p, vv.w, acc[i * 4 + 3]);
            }
        }
        m = m_new;
    }

    if (!row_ok) return;
    const float inv_l = 1.0f / fmaxf(l, 1e-30f);
    T* orow = o + b * os.b + h * os.h + row * os.s;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
        const int c = (i * FA_TPR + sub) * 4;
#pragma unroll
        for (int e = 0; e < 4; ++e) orow[c + e] = from_f<T>(acc[i * 4 + e] * inv_l);
    }
}

#include "flash_attention_wgmma.cuh"

template <typename T, int DH>
static int launch_simt(const void* q, const void* k, const void* v, void* o,
                       int B, int H, int KV, int64_t S, int64_t Tk,
                       FaStrides qs, FaStrides ks, FaStrides vs, FaStrides os,
                       float scale, int causal, cudaStream_t st)
{
    const int64_t bh = (int64_t)B * H;
    const int64_t qt = (S + FA_BQ - 1) / FA_BQ;
    if (bh > INT32_MAX || qt > 65535) return (int)cudaErrorInvalidValue;
    dim3 grid((unsigned)bh, (unsigned)qt);
    fa_fwd_kernel<T, DH><<<grid, FA_THREADS, 0, st>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)o, H, KV, S, Tk,
        qs, ks, vs, os, scale, causal);
    return (int)cudaGetLastError();
}

#define FA_ARGS q, k, v, o, B, H, KV, S, Tk, qs, ks, vs, os, scale, causal, st

template <typename T>
static int launch_dh(int route, int dh, const void* q, const void* k,
                     const void* v, void* o, int B, int H, int KV, int64_t S,
                     int64_t Tk, FaStrides qs, FaStrides ks, FaStrides vs,
                     FaStrides os, float scale, int causal, cudaStream_t st)
{
    if constexpr (std::is_same<T, float>::value) {
        if (route != 0) return (int)cudaErrorInvalidValue;
        switch (dh) {
        case 32: return launch_simt<T, 32>(FA_ARGS);
        case 64: return launch_simt<T, 64>(FA_ARGS);
        case 80: return launch_simt<T, 80>(FA_ARGS);
        case 128: return launch_simt<T, 128>(FA_ARGS);
        default: return (int)cudaErrorInvalidValue;
        }
    } else {
        if (route == 0) {                          // bf16/fp16 take it at dh 32 only
            if (dh != 32) return (int)cudaErrorInvalidValue;
            return launch_simt<T, 32>(FA_ARGS);
        }
        if (route != 1) return (int)cudaErrorInvalidValue;
        switch (dh) {
        case 64: return fa_hopper::launch<T, 64>(FA_ARGS);
        case 80: return fa_hopper::launch<T, 80>(FA_ARGS);
        case 128: return fa_hopper::launch<T, 128>(FA_ARGS);
        default: return (int)cudaErrorInvalidValue;
        }
    }
}

extern "C" {

const char* flash_attention_error_string(int err) {
    if (err == fa_hopper::ERR_NO_ENCODE)
        return "cuTensorMapEncodeTiled not found through cudaGetDriverEntryPoint";
    if (err >= fa_hopper::ERR_TENSOR_MAP)
        return "cuTensorMapEncodeTiled refused a tensor map (a base or stride not "
               "a multiple of 16 bytes, or a dimension out of range)";
    return cudaGetErrorString((cudaError_t)err);
}

// o[B, H, S, dh] = attention(q[B, H, S, dh], k/v[B, KV, T, dh]) on `stream`
// of `device`. Each tensor is given by its pointer and its element strides
// of (batch, head, row); the head-dim stride is 1. KV divides H; dh is 32,
// 64, 80 or 128; dtype 0 = float32, 1 = bfloat16, 2 = float16; route 0 =
// the CUDA-core kernel (float32 at any dh, bfloat16/float16 at dh 32), 1 =
// the tensor-core kernel (bfloat16/float16 at dh 64, 80 or 128; base
// pointers and strides multiples of 16 bytes); other pairs are refused. Returns a cudaError_t, or an error of the tensor maps
// (flash_attention_error_string); 0 on success. Nothing is synchronised.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int B, int H, int KV, int64_t S, int64_t Tk, int dh,
                        int64_t qsb, int64_t qsh, int64_t qss,
                        int64_t ksb, int64_t ksh, int64_t kss,
                        int64_t vsb, int64_t vsh, int64_t vss,
                        int64_t osb, int64_t osh, int64_t oss,
                        float scale, int causal, int dtype, int route,
                        void* stream, int device)
{
    if (B <= 0 || H <= 0 || S <= 0) return 0;
    if (KV <= 0 || H % KV != 0 || Tk <= 0) return (int)cudaErrorInvalidValue;
    // This library links its own CUDA runtime, whose current device is
    // separate from PyTorch's: select the tensors' device explicitly.
    cudaError_t se = cudaSetDevice(device);
    if (se != cudaSuccess) return (int)se;
    cudaStream_t st = (cudaStream_t)stream;
    const FaStrides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
        os{osb, osh, oss};
    switch (dtype) {
    case 0: return launch_dh<float>(route, dh, FA_ARGS);
    case 1: return launch_dh<__nv_bfloat16>(route, dh, FA_ARGS);
    case 2: return launch_dh<__half>(route, dh, FA_ARGS);
    default: return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
