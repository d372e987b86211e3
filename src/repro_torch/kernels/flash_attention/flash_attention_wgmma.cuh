// flash_attention on Hopper's tensor cores: bf16/fp16 tiles fed by TMA into
// wgmma, for dh in {64, 80, 128}. Included by flash_attention.cu, which
// holds the note on what the kernel computes and the CUDA-core kernel that
// keeps float32 and dh=32.
//
// Design. One CTA owns one (b*h, 128-row query tile) and has three
// warpgroups: two consumers of 64 query rows each (wgmma's M) and one
// producer, of which one thread issues every load. setmaxnreg gives the
// consumers the registers (232 each, the producer keeps 40).
//   * Shared memory holds Q's tile and a ring of STAGES (K, V) tiles of 128
//     keys, as stored (bf16/fp16), each a row of 64-element panels with
//     128-byte rows in the 128B swizzle that TMA writes and wgmma reads.
//     dh=80 is padded to two panels: TMA fills columns 80..127 with zeros,
//     which change neither product. Rows past S or T are zero-filled too.
//   * The producer waits on a stage's `empty` mbarrier, then issues the
//     K and V loads (cp.async.bulk.tensor, 4-d maps built on the host from
//     the tensors' own strides, so the model's transposed q and GQA's
//     shared K/V heads are read in place) completing on its `full` one.
//   * Each consumer computes S = Q.K^T (m64n128k16, both operands from
//     shared memory, f32 accumulator in registers), masks only the tiles
//     that cross the diagonal or the end of the keys, and runs the online
//     softmax on the fragments: row max by quad shuffles, one rescale of
//     (l, O) per tile, l kept as per-thread partial sums until the end.
//     P is rounded to the input type in registers and is wgmma's A
//     operand for O += P.V (V read as an MN-major B operand). Then it
//     releases the stage. Tiles wholly above the diagonal are not loaded.
//   * A consumer runs Q.K^T, the softmax and P.V of a tile in turn, waiting
//     for each product; the other consumer's products keep the tensor
//     cores busy meanwhile. (Issuing tile j's Q.K^T together with tile
//     j-1's P.V, so that the softmax overlaps P.V, spilled registers and
//     ran slower on the card; a third stage did not help either.)
//   * exp2f with log2(e) folded into the scale replaces the TPU kernel's
//     exp (p = exp2(s * scale * log2 e - m), m kept in the same units).
//   * The end divides by max(l, 1e-30) and writes rows < S, columns < dh,
//     in q's dtype. No split of the key axis, no atomics: bitwise
//     repeatable.
// A wait on an mbarrier that has not completed after 10 s traps, so a
// broken pipeline fails the launch instead of hanging the card.

#pragma once

#include <cuda.h>
#include <math.h>
#include <type_traits>

namespace fa_hopper {

constexpr int BQ = 128;            // query rows per CTA (two warpgroups of 64)
constexpr int BK = 128;            // keys per tile
constexpr int STAGES = 2;          // (K, V) tiles in flight
constexpr int THREADS = 384;       // two consumer warpgroups + one producer
constexpr int PANEL = 64;          // elements in one 128-byte swizzled row
constexpr uint32_t PANEL_BYTES = BQ * 128;   // one panel of a tile (BQ == BK)
constexpr float LOG2E = 1.4426950408889634f;
// Error codes beside cudaError_t's (see flash_attention_error_string).
constexpr int ERR_NO_ENCODE = 100000;        // no cuTensorMapEncodeTiled
constexpr int ERR_TENSOR_MAP = 100001;       // + CUresult of the encode

static __device__ __forceinline__ uint32_t smem_u32(const void* p)
{
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarrier -----------------------------------------------------------------

static __device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count)
{
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(bar), "r"(count) : "memory");
}

static __device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes)
{
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
}

static __device__ __forceinline__ void mbar_arrive(uint32_t bar)
{
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(bar) : "memory");
}

static __device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity)
{
    uint32_t ok;
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(ok) : "r"(bar), "r"(parity) : "memory");
    return ok != 0;
}

static __device__ __forceinline__ uint64_t global_ns()
{
    uint64_t t;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
    return t;
}

// Wait until the phase of parity `parity` has completed.
static __device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity)
{
    if (mbar_try(bar, parity)) return;
    const uint64_t t0 = global_ns();
    while (!mbar_try(bar, parity))
        if (global_ns() - t0 > 10000000000ull) __trap();
}

// -- TMA ------------------------------------------------------------------------

static __device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                                uint32_t bar, int c0, int c1, int c2, int c3)
{
    asm volatile("cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
                 " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
                 :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
                    "r"(c0), "r"(c1), "r"(c2), "r"(c3)
                 : "memory");
}

// -- wgmma ----------------------------------------------------------------------

// Shared-memory matrix descriptor, 128B swizzle (tiles 1024-byte aligned).
// Offsets in bytes: `lbo` between 64-element panels along MN (MN-major
// operands), `sbo` between groups of 8 rows.
static __device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo)
{
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16)
         | (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32)
         | (1ull << 62);
}

static __device__ __forceinline__ void wgmma_fence()
{
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

static __device__ __forceinline__ void wgmma_commit_and_wait()
{
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of wgmma's registers
// across the asynchronous instructions.
template <int N>
static __device__ __forceinline__ void fence_regs(float* r)
{
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <int N>
static __device__ __forceinline__ void fence_regs(uint32_t* r)
{
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

#define FA_D8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
                 "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define FA_D32 FA_D8(0), FA_D8(8), FA_D8(16), FA_D8(24)
#define FA_D64 FA_D32, FA_D8(32), FA_D8(40), FA_D8(48), FA_D8(56)
#define FA_OPS32 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
                 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define FA_OPS64 FA_OPS32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, " \
                 "%45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, " \
                 "%61, %62, %63"

// d[64] (+)= A[64x16] . B[16x128]: A K-major and B K-major, both in shared
// memory (scale_d = 0 overwrites d).
#define FA_SS_N128(TY)                                                          \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                   \
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY       \
                 " {" FA_OPS64 "}, %64, %65, p, 1, 1, 0, 0;\n}\n"               \
                 : FA_D64 : "l"(da), "l"(db), "r"(scale_d))

template <typename T>
static __device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da, uint64_t db, int scale_d)
{
    if constexpr (std::is_same<T, __nv_bfloat16>::value) FA_SS_N128("bf16");
    else FA_SS_N128("f16");
}

// d[N/2] += A[64x16] . B[16xN]: A from registers, B MN-major in shared memory.
#define FA_RS_N128(TY)                                                          \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                   \
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY       \
                 " {" FA_OPS64 "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n" \
                 : FA_D64 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]),        \
                   "l"(db), "r"(1))
#define FA_RS_N64(TY)                                                           \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                   \
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY        \
                 " {" FA_OPS32 "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n" \
                 : FA_D32 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]),        \
                   "l"(db), "r"(1))

template <typename T, int N>
static __device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t db)
{
    if constexpr (N == 128) {
        if constexpr (std::is_same<T, __nv_bfloat16>::value) FA_RS_N128("bf16");
        else FA_RS_N128("f16");
    } else {
        static_assert(N == 64, "wgmma_rs: N is 64 or 128");
        if constexpr (std::is_same<T, __nv_bfloat16>::value) FA_RS_N64("bf16");
        else FA_RS_N64("f16");
    }
}

template <typename T>
static __device__ __forceinline__ uint32_t pack2(float lo, float hi)
{
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
        __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
        return *reinterpret_cast<uint32_t*>(&v);
    } else {
        __half2 v = __floats2half2_rn(lo, hi);
        return *reinterpret_cast<uint32_t*>(&v);
    }
}

// -- the kernel -----------------------------------------------------------------

template <int DH> struct Shape {
    static constexpr int DHP = DH <= 64 ? 64 : 128;   // dh padded to whole panels
    static constexpr int NP = DHP / PANEL;            // panels per row
    static constexpr int KSTEPS = (DH + 15) / 16;     // k16 steps of Q.K^T
    static constexpr uint32_t TILE_BYTES = NP * PANEL_BYTES;
    // Q, then STAGES x (K, V), then the mbarriers; +1024 to align the base.
    static constexpr size_t SMEM = TILE_BYTES * (1 + 2 * STAGES) + 8 * (1 + 2 * STAGES) + 1024;
};

// One consumer warpgroup's state: thread (warp, lane) holds accumulator
// element i at row r0 + 8 * ((i / 2) % 2), column 8 * (i / 4) + cq + i % 2.
struct Rows {
    int row_lo;        // the warpgroup's first query row
    int r0;            // this thread's first row
    int cq;            // this thread's first column in each group of 8
};

// sc = Q.K^T for one tile (issued, not committed).
template <typename T, int DH>
static __device__ __forceinline__ void issue_qk(float* sc, uint32_t qa, uint32_t ka)
{
#pragma unroll
    for (int k = 0; k < Shape<DH>::KSTEPS; ++k) {
        const uint32_t off = (k / 4) * PANEL_BYTES + (k % 4) * 32;
        wgmma_ss_n128<T>(sc, sw128_desc(qa + off, 16, 1024), sw128_desc(ka + off, 16, 1024),
                         k > 0);
    }
}

// acc += P.V for one tile (issued, not committed). The S fragment of keys
// 16kk..16kk+15 is, pair by pair, the A fragment of step kk.
template <typename T, int DH>
static __device__ __forceinline__ void issue_pv(float* acc, const uint32_t* pa, uint32_t va)
{
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<T, Shape<DH>::DHP>(acc, pa + 4 * kk,
                                    sw128_desc(va + kk * 16 * 128, PANEL_BYTES, 1024));
}

// The online-softmax step of one tile on the score fragments: mask (only
// tiles crossing the diagonal or the end of the keys), row max by quad
// shuffles, the new running max m, alpha = the rescale of the old (l, acc),
// p = exp2(s * scale_log2 - m) in place of the scores, l updated.
static __device__ __forceinline__ void softmax_tile(float* sc, float* m, float* l, float* alpha,
                                                    const Rows& rw, int k0, int Tk, int causal,
                                                    float scale_log2)
{
    if (k0 + BK > Tk || (causal && k0 + BK - 1 > rw.row_lo)) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
            const int col = k0 + 8 * (i / 4) + rw.cq + (i % 2);
            const int row = rw.r0 + 8 * ((i / 2) % 2);
            if (col >= Tk || (causal && col > row)) sc[i] = -INFINITY;
        }
    }
    float mx[2] = {-INFINITY, -INFINITY}, ls[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r] * scale_log2);
        alpha[r] = exp2f(m[r] - m_new);
        m[r] = m_new;
    }
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
        const int r = (i / 2) % 2;
        sc[i] = exp2f(fmaf(sc[i], scale_log2, -m[r]));
        ls[r] += sc[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + ls[r];
}

template <typename T>
static __device__ __forceinline__ void pack_p(uint32_t* pa, const float* sc)
{
#pragma unroll
    for (int i = 0; i < BK / 4; ++i) pa[i] = pack2<T>(sc[2 * i], sc[2 * i + 1]);
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS, 1)
fa_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                T* __restrict__ o, int H, int KV, int S, int Tk,
                FaStrides os, float scale_log2, int causal)
{
    using Sh = Shape<DH>;
    extern __shared__ uint8_t smem_raw[];
    const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
    const uint32_t sQ = base;
    const uint32_t bars = base + Sh::TILE_BYTES * (1 + 2 * STAGES);
    const uint32_t q_full = bars;
    auto sK = [&](int s) { return base + Sh::TILE_BYTES * (1 + 2 * s); };
    auto sV = [&](int s) { return base + Sh::TILE_BYTES * (2 + 2 * s); };
    auto full = [&](int s) { return bars + 8u * (1 + s); };
    auto empty = [&](int s) { return bars + 8u * (1 + STAGES + s); };

    const int b = blockIdx.x / H, h = blockIdx.x % H;
    const int kvh = h / (H / KV);
    const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;      // longest first
    const int kv_end = causal ? min(Tk, q0 + BQ) : Tk;     // skip tiles above the diagonal
    const int n_tiles = (kv_end + BK - 1) / BK;

    if (threadIdx.x == 0) {
        mbar_init(q_full, 1);
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(full(s), 1);
            mbar_init(empty(s), 2 * 128);                  // every consumer thread
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    const int wg = threadIdx.x / 128;
    if (wg == 2) {
        // ---- producer ----
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
        if (threadIdx.x == 2 * 128) {
            mbar_expect_tx(q_full, Sh::TILE_BYTES);
#pragma unroll
            for (int p = 0; p < Sh::NP; ++p)
                tma_load(sQ + p * PANEL_BYTES, &tq, q_full, p * PANEL, q0, h, b);
            for (int j = 0; j < n_tiles; ++j) {
                const int s = j % STAGES;
                mbar_wait(empty(s), ((j / STAGES) & 1) ^ 1);
                mbar_expect_tx(full(s), 2 * Sh::TILE_BYTES);
#pragma unroll
                for (int p = 0; p < Sh::NP; ++p) {
                    tma_load(sK(s) + p * PANEL_BYTES, &tk, full(s), p * PANEL, j * BK, kvh, b);
                    tma_load(sV(s) + p * PANEL_BYTES, &tv, full(s), p * PANEL, j * BK, kvh, b);
                }
            }
        }
    } else {
        // ---- consumers ----
        asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
        const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
        Rows rw;
        rw.row_lo = q0 + wg * 64;
        rw.r0 = rw.row_lo + warp * 16 + lane / 4;
        rw.cq = 2 * (lane % 4);
        const uint32_t qa = sQ + wg * 64 * 128;            // its 64 rows of Q

        float acc[Sh::DHP / 2], sc[BK / 2];
        uint32_t pa[BK / 4];
#pragma unroll
        for (int i = 0; i < Sh::DHP / 2; ++i) acc[i] = 0.f;
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
        float m[2] = {FA_NEG_INF, FA_NEG_INF}, l[2] = {0.f, 0.f}, alpha[2];

        mbar_wait(q_full, 0);
        for (int j = 0; j < n_tiles; ++j) {
            const int s = j % STAGES;
            mbar_wait(full(s), (j / STAGES) & 1);
            fence_regs<BK / 2>(sc);
            wgmma_fence();
            issue_qk<T, DH>(sc, qa, sK(s));
            wgmma_commit_and_wait();
            fence_regs<BK / 2>(sc);
            softmax_tile(sc, m, l, alpha, rw, j * BK, Tk, causal, scale_log2);
#pragma unroll
            for (int i = 0; i < Sh::DHP / 2; ++i) acc[i] *= alpha[(i / 2) % 2];
            pack_p<T>(pa, sc);
            fence_regs<Sh::DHP / 2>(acc);
            fence_regs<BK / 4>(pa);
            wgmma_fence();
            issue_pv<T, DH>(acc, pa, sV(s));
            wgmma_commit_and_wait();
            fence_regs<Sh::DHP / 2>(acc);
            mbar_arrive(empty(s));
        }

        float inv[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
            l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
            inv[r] = 1.0f / fmaxf(l[r], 1e-30f);
        }
        T* ob = o + b * os.b + h * os.h;
#pragma unroll
        for (int i = 0; i < Sh::DHP / 2; i += 2) {
            const int col = 8 * (i / 4) + rw.cq;
            const int r = (i / 2) % 2;
            const int64_t row = rw.r0 + 8 * r;
            if (col < DH && row < S)
                *reinterpret_cast<uint32_t*>(ob + row * os.s + col) =
                    pack2<T>(acc[i] * inv[r], acc[i + 1] * inv[r]);
        }
    }
}

// -- host -----------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, found through the runtime (no -lcuda).
static EncodeTiled encode_tiled()
{
    static EncodeTiled fn = nullptr;
    if (fn) return fn;
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                            &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
    return fn;
}

// A 4-d map (dh, rows, heads, batch) over one of q/k/v, read in boxes of
// (64, 128, 1, 1) into the 128B swizzle; outside the tensor TMA fills zeros.
static int make_map(EncodeTiled enc, CUtensorMap* map, CUtensorMapDataType dt,
                    const void* ptr, int dh, int64_t rows, int heads, int batch, FaStrides st)
{
    const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)rows, (cuuint64_t)heads,
                                (cuuint64_t)batch};
    const cuuint64_t strides[3] = {(cuuint64_t)st.s * 2, (cuuint64_t)st.h * 2,
                                   (cuuint64_t)st.b * 2};
    const cuuint32_t box[4] = {PANEL, BQ, 1, 1};
    const cuuint32_t unit[4] = {1, 1, 1, 1};
    const CUresult r = enc(map, dt, 4, const_cast<void*>(ptr), dims, strides, box, unit,
                           CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                           CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                           CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : ERR_TENSOR_MAP + (int)r;
}

template <typename T, int DH>
static int launch(const void* q, const void* k, const void* v, void* o,
                  int B, int H, int KV, int64_t S, int64_t Tk,
                  FaStrides qs, FaStrides ks, FaStrides vs, FaStrides os,
                  float scale, int causal, cudaStream_t st)
{
    const int64_t bh = (int64_t)B * H;
    const int64_t qt = (S + BQ - 1) / BQ;
    if (bh > INT32_MAX || qt > 65535 || S > INT32_MAX || Tk > INT32_MAX)
        return (int)cudaErrorInvalidValue;
    const EncodeTiled enc = encode_tiled();
    if (!enc) return ERR_NO_ENCODE;
    const CUtensorMapDataType dt = std::is_same<T, __nv_bfloat16>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
    CUtensorMap tq, tk, tv;
    int err = make_map(enc, &tq, dt, q, DH, S, H, B, qs);
    if (!err) err = make_map(enc, &tk, dt, k, DH, Tk, KV, B, ks);
    if (!err) err = make_map(enc, &tv, dt, v, DH, Tk, KV, B, vs);
    if (err) return err;
    const size_t smem = Shape<DH>::SMEM;
    cudaError_t e = cudaFuncSetAttribute(fa_wgmma_kernel<T, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((unsigned)bh, (unsigned)qt);
    fa_wgmma_kernel<T, DH><<<grid, THREADS, smem, st>>>(
        tq, tk, tv, (T*)o, H, KV, (int)S, (int)Tk, os, scale * LOG2E, causal);
    return (int)cudaGetLastError();
}

}  // namespace fa_hopper
