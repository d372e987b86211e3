"""Plain reference of one profile, and the comparison that decides
``correct``.

Works out, from the arrays the benchmark made (``generator.Arrays``) and
the profile's seed, everything the profiler's device pipeline produces:

1. the sample clock: sample ``i`` of chunk ``k`` (``i`` counted over the
   run) is at ``u0 + i·T + u_i`` quantised to whole nanoseconds, with
   ``u0 ~ U(0, T)`` from ``fold_in(key, 0)`` and ``u_i ~ U(0, jitter)``
   from ``fold_in(key, k + 1)`` of threefry2x32 (JAX's bits; both sums of
   a product rounded once, as a fused multiply-add does). A frozen copy
   of that arithmetic;
2. each worker's interval at each time (``searchsorted``, right side);
3. the RAPL sensor (ALEA §4.5): an energy counter that refreshes every
   ``RAPL_UPDATE_S``, read at each sample and differenced against the
   sample before: ``tq = floor(t / u + 1e-6)·u``, and the reading is
   ``(E(tq) - E(tq_prev)) / max(tq - tq_prev, u)`` per rail, with
   ``tq_prev`` the sample before's ``tq`` (the run's first sample:
   ``max(tq - u, 0)``) and ``E`` each rail's exact energy integral of
   the piecewise-constant trace; summed over the workers, plus the total
   channel (the sum of the rails) when there is more than one rail. Or the
   INA231 sensor (ALEA §4.5): a power meter that reports the mean power
   over the window of ``INA231_WINDOW_S`` that ends at the sample, so the
   reading at ``t`` is ``(E(t) - E(lo)) / (t - lo)`` per rail with
   ``lo = max(t - w, 0)``, nothing carried from one sample to the next;
   summed and totalled as the RAPL readings are. The one departure from
   that definition: the divisor is at least 1e-12 s, which matters only
   for a sample at ``t = 0``, whose window is empty;
4. the combination of each in-horizon sample (its row of region ids, one
   per worker) and the order in which the streaming interner numbers
   them: by the chunk in which a row first appears, and within a chunk in
   the rows' lexicographic order;
5. per combination (count, Σpow, Σpow²) of every channel;
6. the estimator's columns (paper Eqs. 4-16).

Plain PyTorch on whatever device it is given, in blocks of chunks, with
float64 sums (``fold_dtype`` float32 is the control: the same reference
with its sensor readings rounded to, and summed in, the precision below).
It imports nothing of the program.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_ONE_BITS = 0x3FF0000000000000      # float64 1.0
_VELTKAMP = 134217729.0             # 2^27 + 1
RAPL_UPDATE_S = 1e-3                # the energy counter's refresh period
# The INA231 power meter's averaging window: the shortest that ALEA §4.5
# found feasible on the Exynos board's meters.
INA231_WINDOW_S = 280e-6
SENSORS = ("rapl", "ina231")        # the sensors this reference models


# ---------------------------------------------------------------------------
# The sample clock.
# ---------------------------------------------------------------------------


def _rotl(v, r: int):
    return ((v << r) & _MASK) | (v >> (32 - r))


def threefry2x32(k1, k2, x0, x1):
    """Threefry-2x32, 20 rounds; words are Python ints or int64 tensors
    holding 32-bit values."""
    ks = (k1 & _MASK, k2 & _MASK, (k1 ^ k2 ^ _PARITY) & _MASK)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def prng_key(seed: int) -> tuple[int, int]:
    seed &= (1 << 64) - 1
    return (seed >> 32) & _MASK, seed & _MASK


def fold_in(key, data: int) -> tuple[int, int]:
    return threefry2x32(key[0], key[1], 0, data & _MASK)


def _mantissa(k1, k2, hi, lo):
    b1, b2 = threefry2x32(k1, k2, hi, lo)
    return (b1 << 20) | (b2 >> 12)


def phase(seed: int, period: float) -> float:
    """``u0``: counter 0 of ``fold_in(key, 0)``, uniform on [0, T)."""
    m = _mantissa(*fold_in(prng_key(seed), 0), 0, 0)
    return max(0.0, (m * 2.0 ** -52) * (period - 0.0) + 0.0)


def _split(x):
    t = x * _VELTKAMP
    hi = t - (t - x)
    return hi, x - hi


def _fma(a, b: float, c: float):
    """``a·b + c`` rounded once: Dekker's exact product, Knuth's exact sum,
    and the tail rounded to odd before the last addition."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = al * bl - (((p - ah * bh) - al * bh) - ah * bl)
    s = p + c
    z = s - p
    r = (p - (s - z)) + (c - z)
    v = r + e
    z = v - r
    w = (r - (v - z)) + (e - z)
    even = (v.view(torch.int64) & 1) == 0
    toward = torch.where(w > 0, math.inf, -math.inf).to(v.dtype)
    v = torch.where((w != 0) & even, torch.nextafter(v, toward), v)
    return s + v


def sample_times(seed: int, period: float, jitter: float, chunk: int,
                 k0: int, nk: int, device) -> torch.Tensor:
    """Times of chunks ``k0 .. k0 + nk - 1``, [nk·chunk] float64."""
    root = prng_key(seed)
    keys = [fold_in(root, k + 1) for k in range(k0, k0 + nk)]
    k1 = torch.tensor([k[0] for k in keys], device=device)[:, None]
    k2 = torch.tensor([k[1] for k in keys], device=device)[:, None]
    i = torch.arange(chunk, dtype=torch.int64, device=device)[None, :]
    m = _mantissa(k1, k2, i >> 32, i & _MASK)
    u = (m | _ONE_BITS).view(torch.float64) - 1.0
    u = torch.clamp_min(u * (jitter - 0.0) + 0.0, 0.0).reshape(-1)
    idx = torch.arange(nk * chunk, dtype=torch.int64, device=device)
    t = _fma((idx + k0 * chunk).to(torch.float64), period,
             phase(seed, period)) + u
    return torch.floor(_fma(t, 1e9, 0.5)) * 1e-9


def num_chunks(t_end: float, period: float, chunk: int) -> int:
    """Chunks whose samples can fall inside the horizon (sample ``i`` is
    never before ``i·T``)."""
    return max(int(math.ceil(t_end / (chunk * period))), 1)


# ---------------------------------------------------------------------------
# One profile.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Profile:
    """What a profile yields: the combination rows in the interner's order
    (``keys`` [k, W]; one worker: the region ids), their counts and
    channel sums [k, C], the sample count, the horizon, and the fold's work
    (lanes, in-horizon samples, chunks, and Σ over chunks of the rows each
    chunk touches)."""

    keys: np.ndarray
    counts: np.ndarray
    psum: np.ndarray
    psumsq: np.ndarray
    n: int
    t_exec: float
    chunks: int
    lanes: int
    touched: int
    channels: int
    rails: int


def _device_worker(arrs, device):
    """(ends, region ids, bounds [0, ends...], energy integral at the
    bounds [m + 1, D], rail powers [m, D]) of one worker on ``device``."""
    ends = np.cumsum(arrs.durations)
    rails = (arrs.powers[:, None] if arrs.rail_powers is None
             else arrs.rail_powers)
    eint = np.concatenate([np.zeros((1, rails.shape[1])),
                           np.cumsum(arrs.durations[:, None] * rails,
                                     axis=0)])
    bounds = np.concatenate([[0.0], ends])

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return (put(ends), put(arrs.region_ids.astype(np.int64)), put(bounds),
            put(eint), put(rails))


def _interval(ends, x):
    """Index of the interval that holds each time of ``x``."""
    return torch.searchsorted(ends, x, right=True).clamp(0, ends.numel() - 1)


def _energy(worker, x):
    """Each rail's energy from 0 to each time of ``x``, [n, D]."""
    ends, _, bounds, eint, rails = worker
    idx = _interval(ends, x)
    return eint[idx] + (x - bounds[idx])[:, None] * rails[idx]


def profile(workers, *, period: float, jitter: float, seed: int,
            chunk: int, device, sensor: str = "rapl",
            fold_dtype=torch.float64, block_lanes: int = 1 << 24) -> Profile:
    """The reference profile of ``workers`` (``generator.Arrays``, one per
    worker) read by ``sensor`` at ``period``/``jitter`` with sampling seed
    ``seed``."""
    if sensor not in SENSORS:
        raise ValueError(f"the reference models the sensors {SENSORS}, "
                         f"not {sensor!r}")
    dev = torch.device(device)
    W = len(workers)
    D = 1 if workers[0].rail_powers is None else workers[0].rail_powers.shape[1]
    C = D + 1 if D > 1 else D
    t_end = min(float(np.cumsum(a.durations)[-1]) for a in workers)
    subs = [_device_worker(a, dev) for a in workers]
    n_chunks = num_chunks(t_end, period, chunk)
    bits = max(max(len(a.names) for a in workers) - 1, 1).bit_length()
    per_block = max(1, block_lanes // (chunk * W))
    up = RAPL_UPDATE_S
    prev = None                     # RAPL: the last sample's tq so far
    parts = []
    touched = 0
    for k0 in range(0, n_chunks, per_block):
        nk = min(per_block, n_chunks - k0)
        t_raw = sample_times(seed, period, jitter, chunk, k0, nk, dev)
        valid = t_raw < t_end
        t = t_raw[valid]
        if t.numel() == 0:
            continue
        lane_chunk = (torch.arange(t_raw.numel(), device=dev)
                      // chunk)[valid]
        rows = torch.empty((t.numel(), W), dtype=torch.int64, device=dev)
        rails = torch.zeros((t.numel(), D), dtype=torch.float64, device=dev)
        for w, sub in enumerate(subs):
            rows[:, w] = sub[1][_interval(sub[0], t)]
        if sensor == "rapl":
            tq = torch.floor(t / up + 1e-6) * up
            head = torch.clamp_min(tq[:1] - up, 0.0) if prev is None else prev
            tq_prev = torch.cat([head, tq[:-1]])
            dt = torch.clamp_min(tq - tq_prev, up)[:, None]
            for sub in subs:
                e_q = _energy(sub, tq)
                e_prev = torch.cat([_energy(sub, head), e_q[:-1]])
                rails += (e_q - e_prev) / dt
            prev = tq[-1:]
        else:                       # ina231: the window [lo, t]
            lo = torch.clamp_min(t - INA231_WINDOW_S, 0.0)
            span = torch.clamp_min(t - lo, 1e-12)[:, None]
            for sub in subs:
                rails += (_energy(sub, t) - _energy(sub, lo)) / span
        chan = rails if D == 1 else torch.cat(
            [rails, rails.sum(dim=1, keepdim=True)], dim=1)
        chan = chan.to(fold_dtype)
        uniq, inv = unique_rows(rows, bits)
        U = uniq.shape[0]
        touched += int(torch.unique(lane_chunk * U + inv).numel())
        parts.append(_fold(uniq, inv, chan, lane_chunk + k0, fold_dtype))
    keys, counts, s, q, first = _merge(parts, fold_dtype, bits)
    if W > 1:
        lex = torch.arange(keys.shape[0], device=dev)
        order = torch.argsort(first * keys.shape[0] + lex)
        keys, counts, s, q = keys[order], counts[order], s[order], q[order]
    n = int(counts.sum())
    return Profile(keys=keys.cpu().numpy(), counts=counts.cpu().numpy(),
                   psum=s.to(torch.float64).cpu().numpy(),
                   psumsq=q.to(torch.float64).cpu().numpy(), n=n,
                   t_exec=t_end, chunks=n_chunks, lanes=n_chunks * chunk,
                   touched=touched, channels=C, rails=D)


def _fold(uniq, inv, chan, chunk_of, dtype):
    U = uniq.shape[0]
    counts = torch.bincount(inv, minlength=U)
    s = torch.zeros((U, chan.shape[1]), dtype=dtype, device=chan.device)
    q = torch.zeros_like(s)
    s.index_add_(0, inv, chan)
    q.index_add_(0, inv, chan * chan)
    first = torch.full((U,), torch.iinfo(torch.int64).max,
                       dtype=torch.int64, device=chan.device)
    first.scatter_reduce_(0, inv, chunk_of, "amin")
    return uniq, counts, s, q, first


def unique_rows(rows, bits: int):
    """``torch.unique(rows, dim=0, return_inverse=True)`` for rows of ids
    below ``2**bits``: the distinct rows in lexicographic order and each
    row's index among them. The ids are packed into 63-bit words, first
    column highest (so the words compare as the rows do), and the rows
    ranked word after word by one-dimensional ``unique``."""
    n, W = rows.shape
    per = max(63 // bits, 1)
    rank = torch.zeros(n, dtype=torch.int64, device=rows.device)
    for j in range(0, W, per):
        word = torch.zeros(n, dtype=torch.int64, device=rows.device)
        for i in range(j, min(j + per, W)):
            word = (word << bits) | rows[:, i]
        _, col = torch.unique(word, return_inverse=True)
        _, rank = torch.unique(rank * n + col, return_inverse=True)
    U = int(rank.max()) + 1 if n else 0
    first = torch.full((U,), n, dtype=torch.int64, device=rows.device)
    first.scatter_reduce_(0, rank, torch.arange(n, device=rows.device),
                          "amin")
    return rows[first], rank


def _merge(parts, dtype, bits):
    """Blocks' rows merged: sorted lexicographically, counts and sums
    added, the first chunk the least."""
    keys = torch.cat([p[0] for p in parts])
    uniq, inv = unique_rows(keys, bits)
    U, dev = len(uniq), keys.device
    counts = torch.zeros(U, dtype=torch.int64, device=dev).index_add_(
        0, inv, torch.cat([p[1] for p in parts]))
    C = parts[0][2].shape[1]
    s = torch.zeros((U, C), dtype=dtype, device=dev).index_add_(
        0, inv, torch.cat([p[2] for p in parts]))
    q = torch.zeros((U, C), dtype=dtype, device=dev).index_add_(
        0, inv, torch.cat([p[3] for p in parts]))
    first = torch.full((U,), torch.iinfo(torch.int64).max,
                       dtype=torch.int64, device=dev).scatter_reduce_(
        0, inv, torch.cat([p[4] for p in parts]), "amin")
    return uniq, counts, s, q, first


# ---------------------------------------------------------------------------
# The estimator (paper Eqs. 4-16).
# ---------------------------------------------------------------------------


def z_quantile(alpha: float) -> float:
    """``z_{alpha/2}`` by Acklam's inverse normal CDF."""
    p = 1.0 - alpha / 2.0
    a = (-3.969683028665376e+01, 2.209460984245205e+02, -2.759285104469687e+02,
         1.383577518672690e+02, -3.066479806614716e+01, 2.506628277459239e+00)
    b = (-5.447609879822406e+01, 1.615858368580409e+02, -1.556989798598866e+02,
         6.680131188771972e+01, -1.328068155288572e+01)
    c = (-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e+00,
         -2.549732539343734e+00, 4.374664141464968e+00, 2.938163982698783e+00)
    d = (7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e+00,
         3.754408661907416e+00)
    if p < 0.02425:
        q = math.sqrt(-2 * math.log(p))
        return (((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q
                + c[5]) / ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)
    if p <= 1 - 0.02425:
        q = p - 0.5
        r = q * q
        return (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r
                + a[5]) * q / (((((b[0] * r + b[1]) * r + b[2]) * r + b[3])
                                * r + b[4]) * r + 1)
    q = math.sqrt(-2 * math.log(1 - p))
    return -(((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q
             + c[5]) / ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)


def estimates(prof: Profile, alpha: float) -> dict:
    """The estimator's columns of ``prof`` (every row has samples)."""
    counts = prof.counts.astype(np.int64)
    cnt = counts.astype(np.float64)
    n = int(counts.sum())
    z = z_quantile(alpha)
    p_hat = counts / n
    se_p = np.sqrt(np.maximum(p_hat * (1.0 - p_hat), 0.0) / n)
    p_lo = np.maximum(p_hat - z * se_p, 0.0)
    p_hi = np.minimum(p_hat + z * se_p, 1.0)
    t_exec = prof.t_exec
    t_hat = p_hat * t_exec

    def power_ci(s, sq, k):
        hat = s / k
        var = np.where(k > 1, (sq - k * hat * hat) / np.maximum(k - 1, 1),
                       0.0)
        se = np.sqrt(np.maximum(var, 0.0) / k)
        return hat, hat - z * se, hat + z * se

    pow_hat, pow_lo, pow_hi = power_ci(prof.psum[:, -1], prof.psumsq[:, -1],
                                       cnt)
    out = dict(n_samples=counts, p_hat=p_hat, t_hat=t_hat,
               t_lo=p_lo * t_exec, t_hi=p_hi * t_exec, pow_hat=pow_hat,
               pow_lo=pow_lo, pow_hi=pow_hi, e_hat=pow_hat * t_hat,
               e_lo=p_lo * t_exec * pow_lo, e_hi=p_hi * t_exec * pow_hi)
    if prof.rails > 1:
        D = prof.rails
        hat, lo, hi = power_ci(prof.psum[:, :D], prof.psumsq[:, :D],
                               cnt[:, None])
        out.update(pow_rails=hat, pow_rails_lo=lo, pow_rails_hi=hi,
                   e_rails=hat * t_hat[:, None],
                   e_rails_lo=(p_lo * t_exec)[:, None] * lo,
                   e_rails_hi=(p_hi * t_exec)[:, None] * hi)
    return out


# ---------------------------------------------------------------------------
# The comparison.
# ---------------------------------------------------------------------------

# First moments and the columns that follow from counts: a relative gap.
MEAN_COLUMNS = ("p_hat", "t_hat", "t_lo", "t_hi", "pow_hat", "e_hat",
                "pow_rails", "e_rails")
# Interval bounds (they carry Σpow²), each against its estimate's size.
SPREAD_COLUMNS = (("pow_lo", "pow_hat"), ("pow_hi", "pow_hat"),
                  ("e_lo", "e_hat"), ("e_hi", "e_hat"),
                  ("pow_rails_lo", "pow_rails"), ("pow_rails_hi", "pow_rails"),
                  ("e_rails_lo", "e_rails"), ("e_rails_hi", "e_rails"))


def _rel(a, b, scale):
    a, b, scale = (np.asarray(x, np.float64) for x in (a, b, scale))
    d = np.abs(a - b)
    s = np.abs(scale)
    return float(np.max(np.divide(d, s, out=np.where(d > 0, np.inf, 0.0),
                                  where=s > 0), initial=0.0))


def compare(got_keys: np.ndarray, got: dict, got_n: int, got_t: float,
            ref: Profile, alpha: float) -> dict:
    """The numbers that decide one profile:

    - ``order_gap``: rows of the program's table whose key (region id, or
      combination) is not the reference's key at that position, plus the
      difference in row count;
    - ``count_gap``: keys whose count differs from the reference's or that
      one side lacks, plus one if the sample totals differ;
    - ``mean_gap``: the largest relative gap of the time, power and energy
      estimates and the horizon (first moments: counts and Σpow);
    - ``spread_gap``: the largest gap of an interval bound, relative to its
      estimate (they go through Σpow²).
    ``got`` holds the program's columns by the reference's names."""
    want = estimates(ref, alpha)
    gk = np.asarray(got_keys, np.int64).reshape(len(got_keys), -1)
    rk = ref.keys
    m = min(len(gk), len(rk))
    order_gap = abs(len(gk) - len(rk))
    if gk.shape[1] == rk.shape[1]:
        order_gap += int((gk[:m] != rk[:m]).any(axis=1).sum())
    else:
        order_gap += m
    pos = {k.tobytes(): i for i, k in enumerate(rk)}
    gi = np.array([pos.get(k.tobytes(), -1) for k in gk], np.int64)
    hit = gi >= 0
    count_gap = int((~hit).sum()) + (len(rk) - int(hit.sum()))
    count_gap += int((np.asarray(got["n_samples"])[hit]
                      != ref.counts[gi[hit]]).sum())
    count_gap += int(got_n != ref.n)
    mean_gap = _rel(got_t, ref.t_exec, ref.t_exec)
    spread_gap = 0.0
    for col in MEAN_COLUMNS:
        if col in want:
            a = np.asarray(got[col])[hit]
            mean_gap = max(mean_gap, _rel(a, want[col][gi[hit]],
                                          want[col][gi[hit]]))
    for col, base in SPREAD_COLUMNS:
        if col in want:
            a = np.asarray(got[col])[hit]
            spread_gap = max(spread_gap, _rel(a, want[col][gi[hit]],
                                              want[base][gi[hit]]))
    return dict(order_gap=order_gap, count_gap=count_gap, mean_gap=mean_gap,
                spread_gap=spread_gap)
