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
// over valid lanes whose id lies in [0, R). All C <= 8 channels fold in one
// call (the TPU launched once per channel), and the sums are float64 (the
// TPU accumulated float32 per chunk, which was its limit). The fold is IN
// PLACE into the caller's carry tensors; that takes the place of JAX's
// buffer donation in the reference pipeline.
//
// Determinism. The reference pins statistics as a pure function of (seed,
// chunk grid), so no floating-point atomics are used: every sum is taken in
// an order fixed by the lane layout alone, and two runs on the same inputs
// are bitwise equal. No atomics are used at all (pass 2 builds its masks
// with warp ballots). Every product and sum is an
// explicit __dmul_rn / __dadd_rn, so nothing is contracted into an FMA and
// ref.py's `sample_attr_fold_emulated` repeats the arithmetic exactly.
//
// Bound on this card. Per sample the fold reads 4 B of id, 8*C B of power
// and 1 B of mask, and it reads and writes (1 + 2C) * 8 B of carry per
// region it touches: at c = 65536, C = 4 that is 2.4-3 MB a fold, 0.0007 to
// 0.0009 ms at 3.35 TB/s (the ~3C float64 operations per sample are far
// below the FP64 peak). The fold is therefore bound by latency: two kernel
// launches, a few dependent memory round trips and barriers. The design is
// about a short critical path with every SM busy.
//
// Design. Two kernels on the caller's stream.
//
//   pass 1, sa_tile_table: one CTA of SA_TILE = 256 threads per 256-sample
//     tile, so 256 CTAs at c = 65536 keep all 132 SMs busy (the first
//     version had 64 CTAs of 1024). Each thread loads one sample: key = id,
//     or NONE when masked or out of range. Runs of equal keys are the unit,
//     since the main path's chunks hold runs of ~1500 samples of one
//     region, so most tiles lie inside one run.
//     (a) Runs are compressed by a segmented reduction over head flags that
//         every thread shares: a Hillis-Steele scan with shuffles inside
//         each warp, then the warps' trailing partials carried in warp
//         order. No thread sums a run alone (the first version's run head
//         summed up to ~1000 samples serially).
//     (b) If the run records are not already strictly increasing in id,
//         they are put in (id, lane) order by a stable counting rank, and
//     (c) the same segmented reduction merges equal ids.
//     The result is a table of (id, count, 2C sums), strictly increasing in
//     id. It is written out contiguously (coalesced), with a head of
//     (length, first id, last id). A tile of uniform ids gives ~230
//     records; the main path's tiles give 1 or 2.
//   pass 2, sa_region_merge: one CTA of 256 threads per SA_RT = 32
//     regions, with the carry of its regions read into shared memory up
//     front. Each thread owns one table of a batch of 256:
//     - a table of 1 or 2 records is read from its head;
//     - a longer one is binary-searched for the CTA's region range.
//     Ballots then build, per region, a mask of the tables that hold it,
//     which gives each record its place in its region's list in tile
//     order. One warp per region sums the list: SA_LR consecutive lanes
//     read one record, so the loads coalesce, and each lane group takes
//     every 32/SA_LR-th record in order. A butterfly over the groups
//     combines them. The work scales with the records pass 1 emits (plus
//     one search per table and region tile), not with R times the number
//     of blocks as in the first version.
//
// Both kernels use static shared memory under 48 KB (at C = 8: ~43 KB), so
// no launch needs cudaFuncSetAttribute. Both are instantiated per C, so the
// 2C running sums stay in registers. On the full profiling run's chunk
// (c = 65536, R = 4096, C = 4, 42 regions in runs of ~1560 samples) the
// two take ~0.010 ms of device time (NVIDIA H100 80GB HBM3 at 700 W,
// chip_smoke.py; PERF.md has every number).

#include <cuda_runtime.h>
#include <stdint.h>

#define SA_TILE 256          // samples per pass-1 CTA, one per thread
#define SA_WARPS (SA_TILE / 32)
#define SA_MAX_C 8           // channels per launch
#define SA_RT 32             // regions per pass-2 CTA (one lane each)
#define SA_TB 256            // tables per pass-2 batch (one thread each)
#define SA_MW (SA_TB / 32)   // mask words per region
#define SA_LR(NV) ((NV) <= 2 ? 2 : (NV) <= 4 ? 4 : (NV) <= 8 ? 8 : 16)  // lanes per record
#define SA_NONE 0xffffffffu  // key of a masked or out-of-range sample
#define SA_FULL 0xffffffffu

// Segmented sum over one item per thread of the CTA, in thread order.
// Segments are runs of equal keys. On return, the thread at the last item
// of each segment holds the segment's count and sums; returns true there
// unless the key is NONE. Order: Hillis-Steele inside each warp
// (x_i = x_{i-d} + x_i for d = 1, 2, 4, 8, 16, skipped once x_i's window
// holds the segment's head), then, for a segment that starts in an earlier
// warp, the trailing partials of the warps from the one holding its head
// summed forward, plus this warp's partial.
template <int NV>
static __device__ __forceinline__ bool
seg_reduce(uint32_t key, int& cnt, double (&v)[NV], uint32_t* keys_s,
           int* w_flag, int* w_cnt, double* w_val)
{
    const int i = threadIdx.x, lane = i & 31, w = i >> 5;
    keys_s[i] = key;
    __syncthreads();
    const bool head = i == 0 || keys_s[i - 1] != key;
    const bool tail = i == SA_TILE - 1 || keys_s[i + 1] != key;
    bool f = head;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const bool fu = __shfl_up_sync(SA_FULL, (int)f, d);
        const int cu = __shfl_up_sync(SA_FULL, cnt, d);
        double vu[NV];
#pragma unroll
        for (int k = 0; k < NV; ++k) vu[k] = __shfl_up_sync(SA_FULL, v[k], d);
        if (lane >= d) {
            if (!f) {
                cnt += cu;
#pragma unroll
                for (int k = 0; k < NV; ++k) v[k] = __dadd_rn(vu[k], v[k]);
            }
            f = f || fu;
        }
    }
    if (lane == 31) {
        w_flag[w] = f;
        w_cnt[w] = cnt;
#pragma unroll
        for (int k = 0; k < NV; ++k) w_val[w * NV + k] = v[k];
    }
    __syncthreads();
    if (!f) {                     // the segment began in an earlier warp
        int u = w - 1;            // warp 0 starts with a head, so u >= 0
        while (!w_flag[u]) --u;
        int cc = w_cnt[u];
        double cv[NV];
#pragma unroll
        for (int k = 0; k < NV; ++k) cv[k] = w_val[u * NV + k];
        for (int q = u + 1; q < w; ++q) {
            cc += w_cnt[q];
#pragma unroll
            for (int k = 0; k < NV; ++k) cv[k] = __dadd_rn(cv[k], w_val[q * NV + k]);
        }
        cnt += cc;
#pragma unroll
        for (int k = 0; k < NV; ++k) v[k] = __dadd_rn(cv[k], v[k]);
    }
    __syncthreads();              // keys_s and the warp scratch are reused
    return tail && key != SA_NONE;
}

// Position of this thread's item among the CTA's items with `out` set, in
// thread order; the total through `total`.
static __device__ __forceinline__ int compact(bool out, int* w_pos, int& total)
{
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const unsigned b = __ballot_sync(SA_FULL, out);
    if (lane == 0) w_pos[w] = __popc(b);
    __syncthreads();
    int base = 0;
    total = 0;
#pragma unroll
    for (int q = 0; q < SA_WARPS; ++q) {
        const int nq = w_pos[q];
        if (q < w) base += nq;
        total += nq;
    }
    __syncthreads();
    return base + __popc(b & ((1u << lane) - 1u));
}

template <int C>
__global__ void __launch_bounds__(SA_TILE)
sa_tile_table(const int32_t* __restrict__ ids,
              const double* __restrict__ pows,
              const uint8_t* __restrict__ valid,
              int64_t c, int64_t R,
              int32_t* __restrict__ tbl_id,
              int32_t* __restrict__ tbl_cnt,
              double* __restrict__ tbl_val,
              int4* __restrict__ tbl_head)
{
    constexpr int NV = 2 * C;
    __shared__ uint32_t keys_s[SA_TILE];
    __shared__ uint32_t rkey[SA_TILE];
    __shared__ int rcnt[SA_TILE];
    __shared__ int perm[SA_TILE];
    __shared__ double rval[NV][SA_TILE + 1];   // +1: no bank conflicts on the copy-out
    __shared__ int w_flag[SA_WARPS], w_cnt[SA_WARPS], w_pos[SA_WARPS];
    __shared__ double w_val[SA_WARPS * NV];
    const int i = threadIdx.x;
    const int64_t s = (int64_t)blockIdx.x * SA_TILE + i;

    uint32_t key = SA_NONE;
    int cnt = 0;
    double v[NV];
#pragma unroll
    for (int k = 0; k < NV; ++k) v[k] = 0.0;
    if (s < c) {                  // every load issued before any is used
        const int32_t id = ids[s];
        const bool on = valid == nullptr || valid[s] != 0;
        double p[C];
#pragma unroll
        for (int ch = 0; ch < C; ++ch) p[ch] = pows[(int64_t)ch * c + s];
        if (on && id >= 0 && (int64_t)id < R) {
            key = (uint32_t)id;
            cnt = 1;
#pragma unroll
            for (int ch = 0; ch < C; ++ch) {
                v[ch] = p[ch];
                v[C + ch] = __dmul_rn(p[ch], p[ch]);
            }
        }
    }

    // (a) one record per run, in lane order.
    bool out = seg_reduce<NV>(key, cnt, v, keys_s, w_flag, w_cnt, w_val);
    int n;
    int pos = compact(out, w_pos, n);
    if (out) {
        rkey[pos] = key;
        rcnt[pos] = cnt;
#pragma unroll
        for (int k = 0; k < NV; ++k) rval[k][pos] = v[k];
    }
    // Runs already strictly increasing in id (a tile inside one run, as
    // most of the main path's are) are the table as they stand: (b) would
    // not move them and (c) would add nothing to them.
    __syncthreads();
    if (!__syncthreads_and(i == 0 || i >= n || rkey[i - 1] < rkey[i])) {
        // (b) records in (key, lane) order: a stable counting rank (each
        // record counts those before it in key order; equal keys keep lane
        // order). O(n) steps a thread, and no slower than a bitonic sort
        // even on uniform ids, where n is largest (NVIDIA H100 80GB HBM3 at
        // 700 W, scripts/kernel_variant.py).
        if (i < n) {
            const uint32_t mine = rkey[i];
            int rank = 0;
            for (int q = 0; q < n; ++q) {
                const uint32_t o = rkey[q];
                rank += (o < mine) || (o == mine && q < i);
            }
            perm[rank] = i;
        }
        __syncthreads();
        key = SA_NONE;
        cnt = 0;
#pragma unroll
        for (int k = 0; k < NV; ++k) v[k] = 0.0;
        if (i < n) {
            const int src = perm[i];
            key = rkey[src];
            cnt = rcnt[src];
#pragma unroll
            for (int k = 0; k < NV; ++k) v[k] = rval[k][src];
        }
        // (c) merge equal keys. The gather above finished before
        // seg_reduce's first barrier, so the table can take the records'
        // place in rkey, rcnt and rval.
        out = seg_reduce<NV>(key, cnt, v, keys_s, w_flag, w_cnt, w_val);
        pos = compact(out, w_pos, n);
        if (out) {
            rkey[pos] = key;
            rcnt[pos] = cnt;
#pragma unroll
            for (int k = 0; k < NV; ++k) rval[k][pos] = v[k];
        }
        __syncthreads();
    }

    // The tile's table, strictly increasing in id, written out contiguously
    // so that the stores coalesce.
    const int64_t e0 = (int64_t)blockIdx.x * SA_TILE;
    for (int q = i; q < n; q += SA_TILE) {
        tbl_id[e0 + q] = (int32_t)rkey[q];
        tbl_cnt[e0 + q] = rcnt[q];
    }
    for (int q = i; q < n * NV; q += SA_TILE) tbl_val[e0 * NV + q] = rval[q % NV][q / NV];
    if (i == 0)
        tbl_head[blockIdx.x] = make_int4(n, n ? (int)rkey[0] : 0,
                                         n ? (int)rkey[n - 1] : -1, 0);
}

template <int C>
__global__ void __launch_bounds__(SA_TB)
sa_region_merge(const int32_t* __restrict__ tbl_id,
                const int32_t* __restrict__ tbl_cnt,
                const double* __restrict__ tbl_val,
                const int4* __restrict__ tbl_head,
                int ntables, int64_t R,
                long long* __restrict__ counts,
                double* __restrict__ psum,
                double* __restrict__ psumsq)
{
    constexpr int NV = 2 * C;
    __shared__ uint32_t mask[SA_RT][SA_MW];
    __shared__ int roff[SA_RT], rnum[SA_RT];
    __shared__ int slot[SA_RT * SA_TB];
    __shared__ long long acc_cnt[SA_RT], carry_cnt[SA_RT];
    __shared__ double acc_val[SA_RT][NV], carry_val[SA_RT][NV];
    const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
    const int64_t r0 = (int64_t)blockIdx.x * SA_RT;
    const int64_t r1 = r0 + SA_RT < R ? r0 + SA_RT : R;
    // Thread tid < SA_RT reads its region's carry into shared memory now,
    // so the update at the end waits on no load.
    if (tid < SA_RT) {
        acc_cnt[tid] = 0;
#pragma unroll
        for (int k = 0; k < NV; ++k) acc_val[tid][k] = 0.0;
        if (r0 + tid < r1) {
            const int64_t r = r0 + tid;
            carry_cnt[tid] = counts[r];
#pragma unroll
            for (int ch = 0; ch < C; ++ch) {
                carry_val[tid][ch] = psum[r * C + ch];
                carry_val[tid][C + ch] = psumsq[r * C + ch];
            }
        }
    }

    for (int b0 = 0; b0 < ntables; b0 += SA_TB) {
        // Thread tid owns table t: the records with ids in [r0, r1) are
        // [lo, hi), and bit r of `present` says the table holds region
        // r0 + r. A table of one or two records is known from its head
        // (length, first id, last id); a longer one is searched (two binary
        // searches in step, skipped where the first or last id decides).
        const int t = b0 + tid;
        const int32_t* tid_t = tbl_id + (int64_t)t * SA_TILE;
        int lo = 0, hi = 0;
        uint32_t present = 0;
        const int4 h = t < ntables ? tbl_head[t] : make_int4(0, 0, -1, 0);
        if (h.x > 0 && h.x <= 2) {
            const int64_t first = h.y, last = h.z;
            lo = (first < r0) + (h.x == 2 && last < r0);
            hi = (first < r1) + (h.x == 2 && last < r1);
            if (lo == 0 && hi > 0) present |= 1u << (int)(first - r0);
            if (h.x == 2 && lo <= 1 && hi == 2) present |= 1u << (int)(last - r0);
        } else if (h.x > 2 && (int64_t)h.z >= r0 && (int64_t)h.y < r1) {
            int a0 = 0, z0 = (int64_t)h.y >= r0 ? 0 : h.x;
            int a1 = (int64_t)h.z < r1 ? h.x : 0, z1 = h.x;
            while (a0 < z0 || a1 < z1) {
                if (a0 < z0) {
                    const int m = (a0 + z0) >> 1;
                    if ((int64_t)tid_t[m] < r0) a0 = m + 1; else z0 = m;
                }
                if (a1 < z1) {
                    const int m = (a1 + z1) >> 1;
                    if ((int64_t)tid_t[m] < r1) a1 = m + 1; else z1 = m;
                }
            }
            lo = a0;
            hi = a1;
#pragma unroll 4
            for (int j = lo; j < hi; ++j) present |= 1u << (int)(tid_t[j] - r0);
        }
        // mask[r][w] bit l: table b0 + 32w + l holds region r0 + r.
        uint32_t mine = 0;
#pragma unroll
        for (int r = 0; r < SA_RT; ++r) {
            const uint32_t b = __ballot_sync(SA_FULL, (present >> r) & 1u);
            if (lane == r) mine = b;
        }
        mask[lane][w] = mine;
        __syncthreads();
        if (w == 0) {                         // lane = region: list offsets
            int n = 0;
#pragma unroll
            for (int q = 0; q < SA_MW; ++q) n += __popc(mask[lane][q]);
            int x = n;
#pragma unroll
            for (int d = 1; d < 32; d <<= 1) {
                const int y = __shfl_up_sync(SA_FULL, x, d);
                if (lane >= d) x += y;
            }
            roff[lane] = x - n;
            rnum[lane] = n;
        }
        __syncthreads();
        // Each record's place in its region's list: the tables before t
        // that hold the region.
        for (uint32_t left = present; left; left &= left - 1) {
            const int r = __ffs(left) - 1;
            int rank = __popc(mask[r][w] & ((1u << lane) - 1u));
            for (int q = 0; q < w; ++q) rank += __popc(mask[r][q]);
            slot[roff[r] + rank] = t * SA_TILE + lo + __popc(present & ((1u << r) - 1u));
        }
        __syncthreads();
        // One warp per region. A record's sums are read by SA_LR
        // consecutive lanes (value k by lane k of a group), so each load
        // is one contiguous piece; group g of the warp's 32 / SA_LR sums
        // records g, g + groups, ... from 0.0 in list order, and a
        // butterfly over the groups combines them.
        constexpr int LR = SA_LR(NV), G = 32 / LR;
        const int k = lane % LR, g = lane / LR;
        for (int r = w; r < SA_RT; r += SA_TB / 32) {
            const int n = rnum[r];
            if (n == 0) continue;             // uniform across the warp
            int cnt = 0;
            double v = 0.0;
#pragma unroll 4
            for (int q = g; q < n; q += G) {
                const int64_t e = slot[roff[r] + q];
                if (k < NV) v = __dadd_rn(v, tbl_val[e * NV + k]);
                if (k == 0) cnt += tbl_cnt[e];
            }
#pragma unroll
            for (int off = 16; off >= LR; off >>= 1) {
                cnt += __shfl_xor_sync(SA_FULL, cnt, off);
                v = __dadd_rn(v, __shfl_xor_sync(SA_FULL, v, off));
            }
            if (g == 0 && k < NV) acc_val[r][k] = __dadd_rn(acc_val[r][k], v);
            if (lane == 0) acc_cnt[r] += cnt;
        }
        __syncthreads();
    }

    if (tid < SA_RT && r0 + tid < r1 && acc_cnt[tid] > 0) {
        const int64_t r = r0 + tid;
        counts[r] = carry_cnt[tid] + acc_cnt[tid];
#pragma unroll
        for (int ch = 0; ch < C; ++ch) {
            psum[r * C + ch] = __dadd_rn(carry_val[tid][ch], acc_val[tid][ch]);
            psumsq[r * C + ch] = __dadd_rn(carry_val[tid][C + ch], acc_val[tid][C + ch]);
        }
    }
}

template <int C>
static int launch(const int32_t* ids, const double* pows, const uint8_t* valid,
                  int64_t c, int64_t R, long long* counts, double* psum,
                  double* psumsq, int32_t* tbl_id, int32_t* tbl_cnt,
                  double* tbl_val, int4* tbl_head, int ntables,
                  cudaStream_t st)
{
    sa_tile_table<C><<<ntables, SA_TILE, 0, st>>>(
        ids, pows, valid, c, R, tbl_id, tbl_cnt, tbl_val, tbl_head);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const int64_t merge_blocks = (R + SA_RT - 1) / SA_RT;
    if (merge_blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
    sa_region_merge<C><<<(unsigned)merge_blocks, SA_TB, 0, st>>>(
        tbl_id, tbl_cnt, tbl_val, tbl_head, ntables, R, counts, psum, psumsq);
    return (int)cudaGetLastError();
}

extern "C" {

int sample_attr_tile(void) { return SA_TILE; }

int sample_attr_max_channels(void) { return SA_MAX_C; }

const char* sample_attr_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// Fold one chunk into the carry on `stream` of `device`. `valid` may be null
// (all lanes valid). Scratch, for ntables = ceil(c / SA_TILE): tbl_id and
// tbl_cnt [ntables * SA_TILE] int32, tbl_val [ntables * SA_TILE * 2C]
// float64, tbl_head [ntables * 4] int32 (16-byte aligned: each table's
// length, first id, last id); nothing in it needs clearing. Returns a
// cudaError_t (0 on success); nothing is synchronised.
int sample_attr_fold(const int32_t* ids, const double* pows,
                     const uint8_t* valid, int64_t c, int C, int64_t R,
                     long long* counts, double* psum, double* psumsq,
                     int32_t* tbl_id, int32_t* tbl_cnt, double* tbl_val,
                     int32_t* tbl_head, void* stream, int device)
{
    if (C < 1 || C > SA_MAX_C) return (int)cudaErrorInvalidValue;
    if (c <= 0 || R <= 0) return 0;
    if (c > INT32_MAX - SA_TILE || R >= INT32_MAX) return (int)cudaErrorInvalidValue;
    // This library links its own CUDA runtime, whose current device is
    // separate from PyTorch's: select the tensors' device explicitly.
    cudaError_t se = cudaSetDevice(device);
    if (se != cudaSuccess) return (int)se;
    cudaStream_t st = (cudaStream_t)stream;
    const int ntables = (int)((c + SA_TILE - 1) / SA_TILE);
#define SA_CASE(N) case N: return launch<N>(ids, pows, valid, c, R, counts, \
        psum, psumsq, tbl_id, tbl_cnt, tbl_val, (int4*)tbl_head, ntables, st);
    switch (C) {
    SA_CASE(1) SA_CASE(2) SA_CASE(3) SA_CASE(4)
    SA_CASE(5) SA_CASE(6) SA_CASE(7) SA_CASE(8)
    }
#undef SA_CASE
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
