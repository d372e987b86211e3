"""Plain PyTorch version of the sample-attribution reduction.

Given a stream of (region_id, power) samples, fold per-region counts,
Σpower and Σpower² — the sufficient statistics for Eqs. 4/6/14 — into a
carry, in float64 through ``index_add_``. This is the arithmetic the CUDA
kernel (``sample_attr.cu``) must reproduce: the CPU path of
:mod:`repro_torch.kernels.sample_attr.ops` runs it, and ``chip_smoke.py``
holds the kernel against it on the GPU.

:func:`sample_attr_fold_emulated` is for tests only: the same fold with
the kernel's own summation order (runs compressed, one table of records
per 256-sample tile, the tables summed per region in tile order), so the
tests can hold that order to the reference on the CPU and
``chip_smoke.py`` can hold the kernel to it bit for bit.
"""

from __future__ import annotations

import torch

__all__ = ["sample_attr_fold_emulated", "sample_attr_fold_ref",
           "sample_attr_ref"]


def sample_attr_fold_ref(counts, psum, psumsq, ids, pows, valid=None):
    """Fold one chunk into ``(counts [R] i64, psum, psumsq)`` in place.

    ``pows`` is [c] with ``psum``/``psumsq`` [R], or [C, c] with [R, C].
    Lanes with ``valid`` false (``None``: all valid) or an id outside
    [0, R) contribute nothing. Returns the carry.
    """
    R = counts.shape[0]
    ok = (ids >= 0) & (ids < R)
    if valid is not None:
        ok = ok & valid
    # Masked lanes add a zero into row 0 rather than being selected out:
    # a boolean selection is sized by the data, and on the GPU that makes
    # the host wait for the device. x + 0.0 is x, so the sums are those of
    # the selected lanes.
    idx = torch.where(ok, ids, 0).to(torch.int64)
    counts.index_add_(0, idx, ok.to(torch.int64))
    pw = pows if psum.ndim == 1 else pows.T
    pw = torch.where(ok if psum.ndim == 1 else ok[:, None], pw,
                     0.0).to(psum.dtype)
    psum.index_add_(0, idx, pw)
    psumsq.index_add_(0, idx, pw * pw)
    return counts, psum, psumsq


def sample_attr_ref(ids, powers, num_regions: int):
    """One-shot form: ``(counts i64 [R], psum f64 [R], psumsq f64 [R])``;
    ids outside [0, R) (the ``-1`` padding) match no region."""
    dev = ids.device
    carry = (torch.zeros(num_regions, dtype=torch.int64, device=dev),
             torch.zeros(num_regions, dtype=torch.float64, device=dev),
             torch.zeros(num_regions, dtype=torch.float64, device=dev))
    return sample_attr_fold_ref(*carry, ids, powers)


# The kernel's layout (sample_attr.cu): SA_TILE samples per pass-1 CTA,
# SA_TB tables per pass-2 batch, warps of 32 lanes.
TILE, TABLES_PER_BATCH, WARP = 256, 256, 32
_NONE = 2 ** 32 - 1


def _seg_reduce(key, cnt, val):
    """The kernel's ``seg_reduce`` on every tile at once: key/cnt [T, L]
    int64, val [T, L, NV] float64, segments = runs of equal keys in lane
    order. Returns (cnt, val, out): at each segment's last lane the
    segment's totals, and ``out`` true there unless the key is NONE."""
    T, L = key.shape
    W = L // WARP
    head = torch.ones_like(key, dtype=torch.bool)
    head[:, 1:] = key[:, 1:] != key[:, :-1]
    tail = torch.ones_like(head)
    tail[:, :-1] = key[:, :-1] != key[:, 1:]
    f = head.reshape(T, W, WARP)
    c = cnt.reshape(T, W, WARP)
    v = val.reshape(T, W, WARP, -1)
    lane = torch.arange(WARP, device=key.device)
    d = 1
    while d < WARP:               # Hillis-Steele inside each warp
        up = lane >= d
        add = up & ~f
        c = torch.where(add, torch.roll(c, d, 2) + c, c)
        v = torch.where(add[..., None], torch.roll(v, d, 2) + v, v)
        f = f | (up & torch.roll(f, d, 2))
        d *= 2
    # A segment that began in an earlier warp: the trailing partials of the
    # warps from its head's warp on, summed forward, plus this warp's own.
    fw, cw, vw = f[:, :, -1], c[:, :, -1], v[:, :, -1]
    carry_c, carry_v = torch.zeros_like(cw), torch.zeros_like(vw)
    for w in range(1, W):
        carry_c[:, w] = torch.where(fw[:, w - 1], cw[:, w - 1],
                                    carry_c[:, w - 1] + cw[:, w - 1])
        carry_v[:, w] = torch.where(fw[:, w - 1, None], vw[:, w - 1],
                                    carry_v[:, w - 1] + vw[:, w - 1])
    c = torch.where(f, c, carry_c[:, :, None] + c)
    v = torch.where(f[..., None], v, carry_v[:, :, None] + v)
    return (c.reshape(T, L), v.reshape(T, L, -1),
            tail & (key != _NONE))


def _tile_tables(ids, pows, valid, R):
    """Pass 1 on every tile: each tile's table of (id, count, 2C sums),
    strictly increasing in id. Returns (tile, id, count, sums) of every
    record, ordered by tile, then id."""
    c, C = ids.shape[0], pows.shape[0]
    T = -(-c // TILE)
    dev = ids.device
    ok = (ids >= 0) & (ids < R)
    if valid is not None:
        ok = ok & valid
    key = torch.full((T * TILE,), _NONE, dtype=torch.int64, device=dev)
    key[:c] = torch.where(ok, ids.to(torch.int64), _NONE)
    cnt = torch.zeros(T * TILE, dtype=torch.int64, device=dev)
    cnt[:c] = ok.to(torch.int64)
    p = torch.where(ok, pows, 0.0).T                          # [c, C]
    val = torch.zeros(T * TILE, 2 * C, dtype=torch.float64, device=dev)
    val[:c, :C] = p
    val[:c, C:] = p * p
    key, cnt, val = key.view(T, TILE), cnt.view(T, TILE), val.view(T, TILE,
                                                                   2 * C)
    # (a) runs; (b) records ranked stably by key; (c) equal keys merged.
    cnt, val, out = _seg_reduce(key, cnt, val)
    rkey = torch.where(out, key, _NONE)
    order = torch.sort(rkey, dim=1, stable=True).indices
    key = torch.gather(rkey, 1, order)
    cnt = torch.gather(torch.where(out, cnt, 0), 1, order)
    val = torch.gather(torch.where(out[..., None], val, 0.0), 1,
                       order[..., None].expand(-1, -1, 2 * C))
    cnt, val, out = _seg_reduce(key, cnt, val)
    tile = torch.arange(T, device=dev)[:, None].expand(T, TILE)
    return tile[out], key[out], cnt[out], val[out]


def _groups(C: int) -> int:
    """Records a pass-2 warp reads at once: each takes ``SA_LR`` lanes,
    the power of two >= 2C (at least 2), one float64 sum a lane."""
    return WARP // max(2, 1 << (2 * C - 1).bit_length())


def sample_attr_fold_emulated(counts, psum, psumsq, ids, pows, valid=None):
    """:func:`sample_attr_fold_ref` in the CUDA kernel's summation order,
    step for step; same arguments, updates the carry in place.

    Pass 1 per 256-sample tile (:func:`_tile_tables`); pass 2 per region:
    its records in tile order, in batches of 256 tables; in a batch, group
    ``g`` of the warp's :func:`_groups` sums records g, g + groups, ...
    from 0.0, a butterfly (``x[g] += x[g ^ off]``, off = groups / 2 … 1)
    combines the groups, the batches add up in order from 0.0, and the
    total is added to the carry. For tests only."""
    R = counts.shape[0]
    C = 1 if psum.ndim == 1 else psum.shape[1]
    tile, rid, rcnt, rval = _tile_tables(ids, pows.reshape(C, -1), valid, R)
    if rid.numel() == 0:
        return counts, psum, psumsq
    counts.index_add_(0, rid, rcnt)
    dev = ids.device
    batch = tile // TABLES_PER_BATCH
    nb = int(batch.max()) + 1
    order = torch.sort(rid * nb + batch, stable=True).indices  # tile order kept
    gkey, rval = (rid * nb + batch)[order], rval[order]
    groups, inv, size = torch.unique_consecutive(gkey, return_inverse=True,
                                                 return_counts=True)
    q = torch.arange(gkey.numel(), device=dev) - (size.cumsum(0) - size)[inv]
    ng = _groups(C)
    lane, step = q % ng, q // ng
    acc = torch.zeros(groups.numel(), ng, 2 * C, dtype=torch.float64,
                      device=dev)
    for s in range(int(step.max()) + 1):
        m = step == s
        acc[inv[m], lane[m]] = acc[inv[m], lane[m]] + rval[m]
    off = ng // 2
    while off:
        acc = acc + acc[:, torch.arange(ng, device=dev) ^ off]
        off //= 2
    tot = acc[:, 0]
    g_region = groups // nb
    regions, rinv, rsize = torch.unique_consecutive(
        g_region, return_inverse=True, return_counts=True)
    j = (torch.arange(groups.numel(), device=dev)
         - (rsize.cumsum(0) - rsize)[rinv])
    total = torch.zeros(regions.numel(), 2 * C, dtype=torch.float64,
                        device=dev)
    for b in range(int(j.max()) + 1):
        m = j == b
        total[rinv[m]] = total[rinv[m]] + tot[m]
    s2, q2 = psum.view(R, C), psumsq.view(R, C)
    s2[regions] = s2[regions] + total[:, :C]
    q2[regions] = q2[regions] + total[:, C:]
    return counts, psum, psumsq
