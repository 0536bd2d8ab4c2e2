"""Trace-driven memory-hierarchy model reproducing the paper's evaluation.

Counterpart of ``repro.core.memmodel``, on integer tensors of an explicit
device.  The paper evaluates BWMA vs RWMA on a gem5-X simulated SoC (32 KB
L1-D per core, 1 MB shared L2, DRAM; CPU @ 2.3 GHz) with tightly-coupled
accelerators (SA8x8 / SA16x16 / SIMD16).  This module rebuilds the
*measurement instrument*: it generates the exact cache-line access trace that
tiled GEMM + the non-GEMM operators produce under each memory arrangement,
runs it through a cache simulator, and converts hits/misses into cycles.

Every trace is an int64 tensor of cache-line numbers on one device; the
simulator is sorts, gathers and prefix tests on that device, so a full
BERT-base layer (127 M lines for SA8x8 RWMA) runs on the card in a fraction
of a second.  Every count equals the numpy model's bit for bit: the
direct-mapped miss test orders by a *stable* sort on the set index (the
numpy model's ``lexsort((t, sets))`` with ``t`` the time), the per-core merge
by a stable sort of float64 positions, per-core chunks split as
``np.array_split`` does (:func:`torch.tensor_split`), and the cycle
arithmetic is done on Python ints and floats taken from the device.

Modeling choices (documented deviations from gem5):
  * caches are direct-mapped (vectorizable closed form); associativity shifts
    absolute miss counts but not the RWMA/BWMA ordering, which is driven by
    spatial locality.
  * a sequential next-line prefetcher is modeled as: an L1 miss whose line is
    the successor of the immediately preceding access is serviced at hit
    latency (the paper's §1 'contiguous block can simultaneously be
    pre-fetched').
  * DRAM sequential bursts: an L2-miss line contiguous with the previous
    L2-miss line pays the burst beat, not the full row-activate latency.
  * per-tile address-generation overhead: RWMA needs per-row-segment index
    arithmetic (the paper's Fig. 8 I-cache observation); BWMA needs one per
    block.

Functions that make traces or simulate a layer take ``device`` (default the
CUDA device; raises without CUDA unless the caller passes ``"cpu"``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.encoder import resolve_device

LINE = 64  # bytes per cache line

_I64 = torch.int64


# --------------------------------------------------------------------------
# Hardware descriptions (paper §4.1)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CacheConfig:
    l1_bytes: int = 32 * 1024          # 32 KB L1-D per core
    l2_bytes: int = 1024 * 1024        # 1 MB shared L2
    lat_l1: int = 2                    # cycles (paper §4.3)
    lat_l2: int = 20                   # cycles (paper §4.3)
    lat_dram: int = 120                # row miss
    lat_dram_burst: int = 30           # sequential beat
    prefetch: bool = True


@dataclasses.dataclass(frozen=True)
class AccelSpec:
    """An accelerator with kernel size T (paper: #PEs per row / SIMD lanes)."""

    name: str
    kernel: int                  # T — this is what BWMA blocks align to
    cycles_per_tile: int         # cycles for one TxTxT tile-GEMM step
    esize: int = 1               # bytes/element (TiC-SAT is int8)

    @staticmethod
    def sa(kernel: int, esize: int = 1) -> "AccelSpec":
        # weight-stationary systolic array: stream T rows + pipeline fill
        return AccelSpec(f"SA{kernel}x{kernel}", kernel, 3 * kernel, esize)

    @staticmethod
    def simd(kernel: int = 16, esize: int = 1) -> "AccelSpec":
        # T lanes x 1 MAC/cycle -> T^3 / T cycles per tile
        return AccelSpec(f"SIMD{kernel}", kernel, kernel * kernel, esize)


PAPER_ACCELERATORS = (AccelSpec.sa(8), AccelSpec.sa(16), AccelSpec.simd(16))


# --------------------------------------------------------------------------
# Trace generation: cache-line addresses in program order
# --------------------------------------------------------------------------

def _arange(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=_I64, device=device)


def _seg_lines(addr: torch.Tensor, seg_bytes: int) -> torch.Tensor:
    """Expand byte addresses of aligned segments into line numbers.

    addr: (...,) start byte addresses; returns (..., lps) line indices.
    Segments are assumed not to straddle lines unless seg_bytes >= LINE
    (true for all paper configs: T*esize in {8,16,32,64,...}).
    """
    lps = max(1, seg_bytes // LINE)
    return addr[..., None] // LINE + _arange(lps, addr.device)


def gemm_trace(
    M: int, K: int, N: int, T: int, layout: str, esize: int,
    base_a: int, base_b: int, base_c: int, *, device=None,
) -> Tuple[torch.Tensor, Dict[str, int]]:
    """Line trace of an output-stationary tiled GEMM A(MxK) @ B(KxN) -> C.

    Loop order (paper Fig. 3): for i, for j, for k: load A[i,k], B[k,j];
    after the k loop, write C[i,j].  Returns the interleaved line trace and
    per-matrix access/segment counts (for the address-generation overhead).
    """
    device = resolve_device(device)
    It, J, Kt = M // T, N // T, K // T
    ii = _arange(It, device)[:, None, None, None]
    jj = _arange(J, device)[None, :, None, None]
    kk = _arange(Kt, device)[None, None, :, None]
    rr = _arange(T, device)[None, None, None, :]

    if layout == "rwma":
        # A tile (i,k): T row segments at stride K*esize
        a_addr = base_a + ((ii * T + rr) * K + kk * T) * esize
        b_addr = base_b + ((kk * T + rr) * N + jj * T) * esize
        a_lines = _seg_lines(a_addr.expand(It, J, Kt, T), T * esize).reshape(It, J, Kt, -1)
        b_lines = _seg_lines(b_addr.expand(It, J, Kt, T), T * esize).reshape(It, J, Kt, -1)
        c_addr = base_c + ((ii * T + rr) * N + jj * T) * esize
        c_lines = _seg_lines(c_addr[:, :, 0, :].expand(It, J, T), T * esize).reshape(It, J, -1)
        segs_per_tile = T
    elif layout == "bwma":
        # A tile (i,k): one contiguous T*T block (paper Fig. 4d)
        a_addr = base_a + (ii * Kt + kk) * (T * T) * esize
        b_addr = base_b + (kk * J + jj) * (T * T) * esize
        a_lines = _seg_lines(a_addr[..., 0].expand(It, J, Kt), T * T * esize
                             ).reshape(It, J, Kt, -1)
        b_lines = _seg_lines(b_addr[..., 0].expand(It, J, Kt), T * T * esize
                             ).reshape(It, J, Kt, -1)
        c_addr = base_c + (ii * J + jj) * (T * T) * esize
        c_lines = _seg_lines(c_addr[:, :, 0, 0].expand(It, J), T * T * esize).reshape(It, J, -1)
        segs_per_tile = 1
    else:
        raise ValueError(layout)

    # interleave per (i,j,k): A lines then B lines; append C write per (i,j)
    step = torch.cat([a_lines, b_lines], dim=-1)  # (It,J,Kt,L)
    per_ij = torch.cat([step.reshape(It, J, -1), c_lines], dim=-1)
    trace = per_ij.reshape(-1)
    meta = {
        "tiles": It * J * Kt,
        "addr_segments": (2 * It * J * Kt + It * J) * segs_per_tile,
        "flops": 2 * M * K * N,
    }
    return trace, meta


def rowwise_trace(
    M: int, N: int, T: int, layout: str, esize: int, base: int, passes: int = 1, *,
    device=None,
) -> torch.Tensor:
    """Softmax / LayerNorm access pattern (paper Fig. 5a): read each logical
    row, write it back.  ``passes`` models multi-pass ops (softmax: max, exp,
    normalize -> effectively ~2 read passes + 1 write)."""
    device = resolve_device(device)
    rows = _arange(M, device)[:, None]
    if layout == "rwma":
        step = max(1, LINE // esize)
        cols = torch.arange(0, N, step, dtype=_I64, device=device)
        lines = (base + (rows * N + cols) * esize) // LINE
    else:
        jb = _arange(N // T, device)[None, :]
        blk = (rows // T) * (N // T) + jb
        addr = base + (blk * T * T + (rows % T) * T) * esize
        lines = _seg_lines(addr, T * esize).reshape(M, -1)
    return lines.reshape(-1).repeat(passes + 1)  # reads + write-back


def transpose_trace(
    M: int, N: int, T: int, layout: str, esize: int, base_in: int, base_out: int, *,
    device=None,
) -> torch.Tensor:
    """Transpose (paper Fig. 5b): gather input column-wise, write sequential."""
    device = resolve_device(device)
    cols = _arange(N, device)[:, None]
    rows = _arange(M, device)[None, :]
    if layout == "rwma":
        read = (base_in + (rows * N + cols) * esize) // LINE  # (N, M) one line/elt
    else:
        ib = _arange(M // T, device)[None, :]
        blk = ib * (N // T) + cols // T
        addr = base_in + (blk * T * T + cols % T) * esize  # column within block
        read = _seg_lines(addr, T * T * esize).reshape(N, -1)
    write = rowwise_trace(N, M, T, layout, esize, base_out, passes=0, device=device)
    return torch.cat([read.reshape(-1), write])


# --------------------------------------------------------------------------
# Cache simulation (vectorized direct-mapped + sequential prefetch)
# --------------------------------------------------------------------------

def _dm_miss(lines: torch.Tensor, cache_bytes: int) -> torch.Tensor:
    """Direct-mapped miss vector in O(n log n), fully vectorized: an access
    hits where the previous access to its set, in time order, had its tag.
    The stable sort on the set keeps time order within a set."""
    n = lines.numel()
    if n == 0:
        return torch.zeros(0, dtype=torch.bool, device=lines.device)
    nsets = cache_bytes // LINE
    s_sorted, order = torch.sort(lines % nsets, stable=True)
    tag_sorted = lines[order] // nsets
    hit_sorted = torch.zeros(n, dtype=torch.bool, device=lines.device)
    hit_sorted[1:] = (s_sorted[1:] == s_sorted[:-1]) & (tag_sorted[1:] == tag_sorted[:-1])
    miss = torch.empty(n, dtype=torch.bool, device=lines.device)
    miss[order] = ~hit_sorted
    return miss


def _sequential(lines: torch.Tensor) -> torch.Tensor:
    """True where the access continues the previous line (prefetchable)."""
    seq = torch.zeros(lines.numel(), dtype=torch.bool, device=lines.device)
    if lines.numel() > 1:
        d = lines[1:] - lines[:-1]
        seq[1:] = (d == 1) | (d == 0)
    return seq


@dataclasses.dataclass
class MemStats:
    l1_accesses: int = 0
    l1_misses: int = 0
    l2_accesses: int = 0
    l2_misses: int = 0
    dram_accesses: int = 0
    mem_cycles: int = 0
    compute_cycles: int = 0
    addr_cycles: int = 0

    @property
    def cycles(self) -> int:
        # accelerator compute overlaps poorly with strided fetches in the
        # tightly-coupled design: total = memory + compute + address gen.
        return self.mem_cycles + self.compute_cycles + self.addr_cycles

    def add(self, o: "MemStats") -> "MemStats":
        for f in dataclasses.fields(self):
            setattr(self, f.name, getattr(self, f.name) + getattr(o, f.name))
        return self


def _l1_stage(lines: torch.Tensor, cache: CacheConfig) -> Tuple[int, torch.Tensor]:
    """(demand misses, the L1 miss mask): a miss the prefetcher covers
    (sequential after the previous access) is not a demand miss."""
    l1_miss = _dm_miss(lines, cache.l1_bytes)
    demand = l1_miss & ~_sequential(lines) if cache.prefetch else l1_miss
    return int(demand.sum()), l1_miss


def _dram_stage(l2_stream: torch.Tensor, cache: CacheConfig) -> Tuple[int, int, int]:
    """(L2 misses, DRAM accesses, DRAM cycles) of the L2 access stream: a
    DRAM line contiguous with the previous one pays the burst beat."""
    l2_miss = _dm_miss(l2_stream, cache.l2_bytes)
    dram_lines = l2_stream[l2_miss]
    n_burst = int(_sequential(dram_lines).sum())
    n_dram = dram_lines.numel()
    return (int(l2_miss.sum()), n_dram,
            (n_dram - n_burst) * cache.lat_dram + n_burst * cache.lat_dram_burst)


def _mem_cycles(st: MemStats, dram_cycles: int, cache: CacheConfig) -> int:
    # prefetched lines are fetched ahead -> hit latency at use time; demand
    # misses pay L2 or DRAM latency.
    # approximate: fraction of demand misses that also miss L2
    frac_dram = st.l2_misses / max(st.l2_accesses, 1)
    n_demand_dram = int(round(st.l1_misses * frac_dram))
    return ((st.l1_accesses - st.l1_misses) * cache.lat_l1
            + (st.l1_misses - n_demand_dram) * cache.lat_l2
            + dram_cycles)


def simulate_trace(lines: torch.Tensor, cache: CacheConfig) -> MemStats:
    st = MemStats()
    st.l1_accesses = lines.numel()
    st.l1_misses, l1_miss = _l1_stage(lines, cache)
    # L2 sees demand misses and prefetch fills
    l2_stream = lines[l1_miss]
    st.l2_accesses = l2_stream.numel()
    st.l2_misses, st.dram_accesses, dram_cycles = _dram_stage(l2_stream, cache)
    st.mem_cycles = _mem_cycles(st, dram_cycles, cache)
    return st


# --------------------------------------------------------------------------
# BERT encoder-layer workload (paper §4.1)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WorkloadConfig:
    seq: int = 512
    d_model: int = 768
    n_heads: int = 12
    d_head: int = 64
    d_ff: int = 3072


def _bases(n: int, stride: int = 1 << 22) -> List[int]:
    """Distinct, page-aligned base addresses for each tensor."""
    return [i * stride for i in range(n)]


def bert_layer_components(
    wl: WorkloadConfig, accel: AccelSpec, layout: str, *, device=None,
) -> List[Tuple[str, torch.Tensor, Dict[str, int]]]:
    """(name, trace, meta) for every component of one encoder layer."""
    device = resolve_device(device)
    T, es = accel.kernel, accel.esize
    S, D, H, Dh, F = wl.seq, wl.d_model, wl.n_heads, wl.d_head, wl.d_ff
    out: List[Tuple[str, torch.Tensor, Dict[str, int]]] = []
    b = iter(_bases(64))

    def gemm(name, M, K, N, reps=1):
        tr, meta = gemm_trace(M, K, N, T, layout, es, next(b), next(b), next(b),
                              device=device)
        if reps > 1:
            tr = tr.repeat(reps)
            meta = {k: v * reps for k, v in meta.items()}
        out.append((name, tr, meta))

    # per paper Fig. 1b / Fig. 7 components (all heads aggregated):
    gemm("qkv_gemm", S, D, Dh, reps=3 * H)
    out.append((
        "transpose",
        torch.cat([
            transpose_trace(S, Dh, T, layout, es, next(b), next(b), device=device)
            for _ in range(H)
        ]),
        {"tiles": 0, "addr_segments": H * S, "flops": 0,
         "cpu_cycles": CPU_CYC_TRANSPOSE * H * S * Dh},
    ))
    gemm("qk_gemm", S, Dh, S, reps=H)
    out.append((
        "softmax",
        torch.cat([
            rowwise_trace(S, S, T, layout, es, next(b), passes=2, device=device)
            for _ in range(H)
        ]),
        {"tiles": 0, "addr_segments": H * S, "flops": 5 * H * S * S,
         "cpu_cycles": CPU_CYC_SOFTMAX * H * S * S},
    ))
    gemm("av_gemm", S, S, Dh, reps=H)
    gemm("proj_gemm", S, H * Dh, D)
    out.append((
        "addnorm1",
        rowwise_trace(S, D, T, layout, es, next(b), passes=2, device=device),
        {"tiles": 0, "addr_segments": S, "flops": 8 * S * D,
         "cpu_cycles": CPU_CYC_NORM * S * D},
    ))
    gemm("ffn1_gemm", S, D, F)  # activation fused at write-back (paper §3.2)
    gemm("ffn2_gemm", S, F, D)
    out.append((
        "addnorm2",
        rowwise_trace(S, D, T, layout, es, next(b), passes=2, device=device),
        {"tiles": 0, "addr_segments": S, "flops": 8 * S * D,
         "cpu_cycles": CPU_CYC_NORM * S * D},
    ))
    return out


# scalar-CPU cycles per element for non-GEMM ops (exp / rsqrt are not
# accelerated in TiC-SAT; they run on the ARM core).  Calibrated so the
# BWMA non-GEMM share lands near the paper's 13.5 % (Fig. 7b).
CPU_CYC_SOFTMAX = 7
CPU_CYC_NORM = 6
CPU_CYC_TRANSPOSE = 1


ADDR_CYCLES_PER_SEGMENT = 4  # index arithmetic per fetched segment (RWMA pays
                             # this per row-segment, BWMA once per block)


def simulate_component(
    trace: torch.Tensor, meta: Dict[str, int], accel: AccelSpec, cache: CacheConfig
) -> MemStats:
    st = simulate_trace(trace, cache)
    st.compute_cycles = (
        meta["tiles"] * accel.cycles_per_tile + meta.get("cpu_cycles", 0)
    )
    st.addr_cycles = meta["addr_segments"] * ADDR_CYCLES_PER_SEGMENT
    return st


def _interleave(arrays: Sequence[torch.Tensor]) -> torch.Tensor:
    """Proportional shuffle-merge of per-core streams (shared-L2 contention):
    element ``i`` of a stream of ``n`` sits at position ``i / n`` (float64),
    exact ties kept in stream order by the stable sort.  The divisor is a
    tensor on the stream's device: CUDA turns division by a Python number
    into a product with its reciprocal, which rounds some positions
    otherwise than numpy's division and reorders near-ties."""
    arrays = [a for a in arrays if a.numel()]
    if not arrays:
        return torch.zeros(0, dtype=_I64)
    pos = torch.cat([
        torch.arange(a.numel(), dtype=torch.float64, device=a.device)
        / torch.tensor(float(a.numel()), dtype=torch.float64, device=a.device)
        for a in arrays
    ])
    return torch.cat(arrays)[torch.sort(pos, stable=True).indices]


def simulate_layer(
    wl: WorkloadConfig,
    accel: AccelSpec,
    layout: str,
    cores: int = 1,
    cache: Optional[CacheConfig] = None,
    *,
    device=None,
) -> Dict[str, MemStats]:
    """Simulate one encoder layer; returns per-component and 'total' stats.

    Multi-core: each component's outer loop is split across ``cores``; each
    core has a private L1, the L2 stream is the interleaved per-core miss
    streams (shared 1 MB L2), and wall-cycles divide the parallel work.
    """
    cache = cache or CacheConfig()
    results: Dict[str, MemStats] = {}
    total = MemStats()
    for name, trace, meta in bert_layer_components(wl, accel, layout, device=device):
        if cores == 1:
            st = simulate_component(trace, meta, accel, cache)
        else:
            st = MemStats()
            miss_streams = []
            for ch in torch.tensor_split(trace, cores):
                demand, l1_miss = _l1_stage(ch, cache)
                st.l1_accesses += ch.numel()
                st.l1_misses += demand
                miss_streams.append(ch[l1_miss])
            del trace
            l2_stream = _interleave(miss_streams).to(miss_streams[0].device)
            del miss_streams
            st.l2_accesses = l2_stream.numel()
            st.l2_misses, st.dram_accesses, dram_cycles = _dram_stage(l2_stream, cache)
            # wall clock: parallel across cores
            st.mem_cycles = _mem_cycles(st, dram_cycles, cache) // cores
            st.compute_cycles = (
                meta["tiles"] * accel.cycles_per_tile + meta.get("cpu_cycles", 0)
            ) // cores
            st.addr_cycles = meta["addr_segments"] * ADDR_CYCLES_PER_SEGMENT // cores
        results[name] = st
        total.add(st)
    results["total"] = total
    return results


GEMM_COMPONENTS = (
    "qkv_gemm", "qk_gemm", "av_gemm", "proj_gemm", "ffn1_gemm", "ffn2_gemm",
)
NON_GEMM_COMPONENTS = ("transpose", "softmax", "addnorm1", "addnorm2")


def speedup(wl: WorkloadConfig, accel: AccelSpec, cores: int = 1, *, device=None) -> float:
    r = simulate_layer(wl, accel, "rwma", cores, device=device)["total"].cycles
    bwma = simulate_layer(wl, accel, "bwma", cores, device=device)["total"].cycles
    return r / bwma


def conversion_overhead_fraction(wl: WorkloadConfig, accel: AccelSpec,
                                 n_layers: int = 12, *, device=None) -> float:
    """Paper §3.2: RWMA<->BWMA conversion cost vs whole-model run-time."""
    # conversion = read + write of the SxD input and output matrices once
    conv_lines = 2 * 2 * (wl.seq * wl.d_model * accel.esize) // LINE
    conv_cycles = conv_lines * CacheConfig().lat_dram_burst
    layer = simulate_layer(wl, accel, "bwma", device=device)["total"].cycles
    return conv_cycles / (layer * n_layers + conv_cycles)
