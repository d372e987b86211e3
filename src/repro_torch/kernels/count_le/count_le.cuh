// count_le.cuh: the interval lookup of one lane, shared by every kernel that
// finds a sample's interval (count_le.cu here, ../trace_sensor/trace_sensor.cu).
//
// Both functions give #(row[j] <= x) over a worker's sorted ends row[0:M]
// (+inf padded), i.e. searchsorted(side="right"), with every comparison
// exact. The grid route is count_le.cu's arithmetic (see that file); the
// binary search serves timelines whose grid window was too wide to bound
// (the pipeline's grid_k == 0).

#pragma once

#include <stdint.h>

// For sample time x and one worker's grid (grid_row [G + 2], cell width cw):
//
//     g   = (int64) floor(x / cw)
//     g  -= (double) g * cw > x
//     g  += (double) (g + 1) * cw <= x
//     lo  = grid_row[clamp(g, 0, G)]
//     out = lo + #{ j < k_max : lo + j < M and row[min(lo + j, M - 1)] <= x }
//
// in this order, each division, product and comparison rounded once as in
// the count_le ref.py (__ddiv_rn, __dmul_rn: nvcc contracts nothing here).
// The compares are all counted, not stopped at the first miss, as ref.py
// sums its whole window.
__device__ __forceinline__ int64_t
count_le_grid_lane(const double* __restrict__ row,
                   const int32_t* __restrict__ grid_row, double cw,
                   int64_t M, int64_t G, int64_t k_max, double x)
{
    int64_t g = (int64_t)floor(__ddiv_rn(x, cw));
    g -= __dmul_rn(__ll2double_rn(g), cw) > x;
    g += __dmul_rn(__ll2double_rn(g + 1), cw) <= x;
    g = g < 0 ? 0 : (g > G ? G : g);
    const int64_t lo = grid_row[g];
    int64_t hits = 0;
    for (int64_t j = 0; j < k_max; ++j) {
        const int64_t pos = lo + j;
        hits += (pos < M) & (row[pos < M ? pos : M - 1] <= x);
    }
    return lo + hits;
}

// The same count by binary search (upper bound) over row[0:M].
__device__ __forceinline__ int64_t
count_le_search_lane(const double* __restrict__ row, int64_t M, double x)
{
    int64_t lo = 0, hi = M;
    while (lo < hi) {
        const int64_t mid = lo + ((hi - lo) >> 1);
        if (row[mid] <= x)
            lo = mid + 1;
        else
            hi = mid;
    }
    return lo;
}
