// sample_attr: ALEA's sample-attribution reduction, by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/sample_attr/sample_attr.py
// (`_kernel`, driven by `sample_attr_pallas`), in the form the fused
// pipeline uses it (src/repro/kernels/sample_attr/ops.py
// `make_carry_update`): a masked fold of one chunk of samples into the
// per-region carry
//
//     counts[r] += #{i : valid_i, ids_i = r}
//     psum[r, ch] += sum pows[ch, i]      psumsq[r, ch] += sum pows[ch, i]^2
//
// over valid lanes whose id lies in [0, R). All C channels fold in one
// call (the TPU launched once per channel), and the sums are float64
// (the TPU accumulated float32 per chunk, which was its limit).
//
// The fold is IN PLACE into the caller's carry tensors; that takes the place
// of JAX's buffer donation in the reference pipeline.
//
// Design. The TPU turned the reduction into one-hot matmuls only because it
// has no atomics. Here the requirement that shapes the design is determinism:
// the reference pins statistics as a pure function of (seed, chunk grid),
// identical from run to run, so no floating-point atomics are used (their
// order varies). The kernel uses no atomics at all:
//
//   pass 1 (one CTA per SA_BLOCK samples): stage the keys (id << 32 | lane)
//     and the channel powers in shared memory, bitonic-sort the keys, and let
//     the first thread of every run of equal ids sum the run in lane order.
//     The CTA writes its sorted ids and, at each run head, the run's count
//     and sums into a scratch the wrapper allocates.
//   pass 2 (one warp per region): each lane binary-searches the region in a
//     strided set of blocks, sums what it finds in block order, the warp
//     combines its lanes with a fixed butterfly, and lane 0 adds the result
//     into the carry. Every sum is taken in a fixed order, so two runs on the
//     same inputs are bitwise equal.
//
// Bound on this card. The fold moves per sample 4 B of id, 8*C B of power and
// 1 B of mask, plus R*(1+2C)*8 B of carry read and written once; it does
// about 3*C float64 operations per sample. At c = 65536 that is a few MB per
// call against 3.35 TB/s, so it is bound by bytes (a few microseconds). This
// first version also writes and reads its per-block partials (through L2) and
// spends O(log^2 SA_BLOCK) shared-memory passes on the sort; a later version
// can overlap loads (cp.async/TMA) or replace the sort by a segmented
// reduction over a chunk-wide sort.

#include <cuda_runtime.h>
#include <stdint.h>

#define SA_BLOCK 1024       // samples per CTA in pass 1 (power of two)
#define SA_THREADS 512      // SA_BLOCK / 2: one compare-exchange per stage
#define SA_MAX_C 8          // channels per launch
#define SA_MERGE_THREADS 256

static __device__ __forceinline__ uint32_t key_id(unsigned long long k) {
    return (uint32_t)(k >> 32);
}

__global__ void __launch_bounds__(SA_THREADS)
sa_block_partials(const int32_t* __restrict__ ids,
                  const double* __restrict__ pows,
                  const uint8_t* __restrict__ valid,
                  int64_t c, int C, int64_t R,
                  int32_t* __restrict__ part_id,
                  int32_t* __restrict__ part_cnt,
                  double* __restrict__ part_val)
{
    extern __shared__ unsigned long long smem[];
    unsigned long long* keys = smem;                                // [SA_BLOCK]
    double* vals = reinterpret_cast<double*>(smem + SA_BLOCK);      // [C][SA_BLOCK]
    const unsigned long long NONE = ~0ull;
    const int64_t base = (int64_t)blockIdx.x * SA_BLOCK;
    const int tid = threadIdx.x;

    for (int l = tid; l < SA_BLOCK; l += SA_THREADS) {
        const int64_t i = base + l;
        unsigned long long key = NONE;
        if (i < c) {
            const int32_t id = ids[i];
            const bool ok = (valid == nullptr || valid[i] != 0)
                            && id >= 0 && (int64_t)id < R;
            if (ok) key = ((unsigned long long)(uint32_t)id << 32) | (unsigned)l;
            for (int ch = 0; ch < C; ++ch)
                vals[ch * SA_BLOCK + l] = pows[(int64_t)ch * c + i];
        }
        keys[l] = key;
    }
    __syncthreads();

    // Bitonic sort, ascending; the lane in the low word keeps equal ids in
    // sample order, and NONE (masked, out of range, past c) sorts last.
    for (int k = 2; k <= SA_BLOCK; k <<= 1) {
        for (int j = k >> 1; j > 0; j >>= 1) {
            const int i = 2 * j * (tid / j) + (tid % j);
            const int p = i + j;
            const bool up = (i & k) == 0;
            const unsigned long long a = keys[i], b = keys[p];
            if ((a > b) == up) { keys[i] = b; keys[p] = a; }
            __syncthreads();
        }
    }

    for (int l = tid; l < SA_BLOCK; l += SA_THREADS) {
        const unsigned long long key = keys[l];
        const int64_t e = base + l;
        part_id[e] = key == NONE ? INT32_MAX : (int32_t)key_id(key);
        if (key == NONE) continue;
        const uint32_t id = key_id(key);
        if (l > 0 && key_id(keys[l - 1]) == id) continue;   // not a run head
        double s[SA_MAX_C], sq[SA_MAX_C];
#pragma unroll
        for (int ch = 0; ch < SA_MAX_C; ++ch) { s[ch] = 0.0; sq[ch] = 0.0; }
        int q = l;
        for (; q < SA_BLOCK && key_id(keys[q]) == id; ++q) {
            const int lane = (int)(keys[q] & 0xffffffffull);
#pragma unroll
            for (int ch = 0; ch < SA_MAX_C; ++ch) {
                if (ch < C) {
                    const double v = vals[ch * SA_BLOCK + lane];
                    s[ch] = __dadd_rn(s[ch], v);
                    sq[ch] = __dadd_rn(sq[ch], __dmul_rn(v, v));
                }
            }
        }
        part_cnt[e] = q - l;
#pragma unroll
        for (int ch = 0; ch < SA_MAX_C; ++ch) {
            if (ch < C) {
                part_val[e * 2 * C + ch] = s[ch];
                part_val[e * 2 * C + C + ch] = sq[ch];
            }
        }
    }
}

__global__ void __launch_bounds__(SA_MERGE_THREADS)
sa_merge(const int32_t* __restrict__ part_id,
         const int32_t* __restrict__ part_cnt,
         const double* __restrict__ part_val,
         int nblocks, int C, int64_t R,
         long long* __restrict__ counts,
         double* __restrict__ psum,
         double* __restrict__ psumsq)
{
    const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (warp >= R) return;               // uniform across the warp
    const int32_t r = (int32_t)warp;
    long long cnt = 0;
    double s[SA_MAX_C], sq[SA_MAX_C];
#pragma unroll
    for (int ch = 0; ch < SA_MAX_C; ++ch) { s[ch] = 0.0; sq[ch] = 0.0; }

    for (int b = lane; b < nblocks; b += 32) {
        const int32_t* pid = part_id + (int64_t)b * SA_BLOCK;
        int lo = 0, hi = SA_BLOCK;       // first position with id >= r
        while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (pid[mid] < r) lo = mid + 1; else hi = mid;
        }
        if (lo < SA_BLOCK && pid[lo] == r) {
            const int64_t e = (int64_t)b * SA_BLOCK + lo;
            cnt += part_cnt[e];
#pragma unroll
            for (int ch = 0; ch < SA_MAX_C; ++ch) {
                if (ch < C) {
                    s[ch] = __dadd_rn(s[ch], part_val[e * 2 * C + ch]);
                    sq[ch] = __dadd_rn(sq[ch], part_val[e * 2 * C + C + ch]);
                }
            }
        }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
#pragma unroll
        for (int ch = 0; ch < SA_MAX_C; ++ch) {
            if (ch < C) {
                s[ch] = __dadd_rn(s[ch], __shfl_xor_sync(0xffffffffu, s[ch], off));
                sq[ch] = __dadd_rn(sq[ch], __shfl_xor_sync(0xffffffffu, sq[ch], off));
            }
        }
    }
    if (lane == 0 && cnt > 0) {
        counts[r] += cnt;
#pragma unroll
        for (int ch = 0; ch < SA_MAX_C; ++ch) {
            if (ch < C) {
                const int64_t o = (int64_t)r * C + ch;
                psum[o] = __dadd_rn(psum[o], s[ch]);
                psumsq[o] = __dadd_rn(psumsq[o], sq[ch]);
            }
        }
    }
}

extern "C" {

int sample_attr_block(void) { return SA_BLOCK; }

int sample_attr_max_channels(void) { return SA_MAX_C; }

const char* sample_attr_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// Fold one chunk into the carry on `stream` of `device`. `valid` may be null
// (all lanes valid). Scratch: part_id/part_cnt [nblocks * SA_BLOCK] int32, part_val
// [nblocks * SA_BLOCK * 2C] float64, nblocks = ceil(c / SA_BLOCK). Returns a
// cudaError_t (0 on success); nothing is synchronised.
int sample_attr_fold(const int32_t* ids, const double* pows,
                     const uint8_t* valid, int64_t c, int C, int64_t R,
                     long long* counts, double* psum, double* psumsq,
                     int32_t* part_id, int32_t* part_cnt, double* part_val,
                     void* stream, int device)
{
    if (C < 1 || C > SA_MAX_C) return (int)cudaErrorInvalidValue;
    if (c <= 0 || R <= 0) return 0;
    // This library links its own CUDA runtime, whose current device is
    // separate from PyTorch's: select the tensors' device explicitly.
    cudaError_t se = cudaSetDevice(device);
    if (se != cudaSuccess) return (int)se;
    cudaStream_t st = (cudaStream_t)stream;
    const int64_t nb64 = (c + SA_BLOCK - 1) / SA_BLOCK;
    if (nb64 > INT32_MAX) return (int)cudaErrorInvalidValue;
    const int nblocks = (int)nb64;
    const size_t smem = (size_t)SA_BLOCK * sizeof(double) * (1 + C);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            sa_block_partials, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    sa_block_partials<<<nblocks, SA_THREADS, smem, st>>>(
        ids, pows, valid, c, C, R, part_id, part_cnt, part_val);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const int64_t merge_blocks =
        (R * 32 + SA_MERGE_THREADS - 1) / SA_MERGE_THREADS;
    if (merge_blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
    sa_merge<<<(unsigned)merge_blocks, SA_MERGE_THREADS, 0, st>>>(
        part_id, part_cnt, part_val, nblocks, C, R, counts, psum, psumsq);
    return (int)cudaGetLastError();
}

}  // extern "C"
