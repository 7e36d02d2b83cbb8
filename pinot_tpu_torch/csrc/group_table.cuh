// Persistent cluster machinery shared by the two dense group-by kernels
// (limb_sums.cu, fused_limb_sums.cu).
//
// One grid of thread-block clusters, about one CTA per SM, walks the rows
// of a FAMILY of S equal-length inputs (S = 1 for a single one) in tiles.
// The work is a sequence of units, segment by segment (a unit is one tile
// per CTA of a cluster, or one tile multicast to the whole cluster in the
// split mode), and each cluster walks a contiguous range of it, so its
// tables hold one segment's sums at a time: they are flushed into that
// segment's (P, G) block of the output when the next unit belongs to
// another segment. Warp 0 of each CTA keeps a ring of `stages` tiles in shared
// memory filled with 1-D bulk asynchronous copies (cp.async.bulk, one per
// slot plane and tile, completion counted in bytes on a "full" mbarrier),
// so `stages - 1` tiles are in flight while the CTA consumes one. Every
// warp reads its rows of a tile from shared memory, arrives on the stage's
// "empty" mbarrier and goes on to the next tile; warp 0 refills a stage
// once every warp has arrived, so no block-wide barrier separates tiles.
// Each row's plane values go into int32 counters:
//
//   private  each CTA holds the whole P x G table; at a flush the cluster
//            sums its C tables through distributed shared memory (DSMEM) in
//            int64 and adds the sums to the output once;
//   split    the planes are split across the cluster (CTA r holds planes
//            [r * TP, (r + 1) * TP) of every group); CTA 0 multicasts each
//            tile to every CTA of the cluster, each CTA adds its own planes
//            of every row, and the warps of every CTA arrive on CTA 0's
//            empty barriers;
//   shared   the table is split across the cluster by group (group g lives
//            in CTA g / TG at local group g % TG); a row's adds go to the
//            owning CTA's table through DSMEM; each CTA flushes its part;
//   global   no table: one 64-bit global atomic per row and plane.
//
// Tables are flushed in int64 and re-zeroed every `epoch_iters` loop steps,
// so no int32 counter sums more than 2^24 values <= 127. The geometry
// (tile rows, ring, cluster size, mode, flush interval, slot layout) comes
// from pinot_tpu_torch/ops/geometry.py and rides in `Geom`, a kernel
// parameter: the consumers index it with constants, so its fields are
// operands from the constant bank. Rows past the last whole tile of each
// segment are read from device memory directly, never past row n - 1, and
// added into the output by global atomics.
//
// Dynamic shared memory: the full and empty mbarriers (kMaxStages each), a
// junk word per lane, the table at Geom::table_off, the ring at ring_off.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pinot {

namespace cg = cooperative_groups;

constexpr int kThreads = 1024;
constexpr int kMaxSlots = 48;
// ring stages; the "empty" barriers follow the "full" ones
constexpr int kMaxStages = 4;
// dynamic shared memory a CTA may take: 232,448 bytes less 3 KB of static
constexpr int kMaxDynamicSmem = 232448 - 3072;
constexpr unsigned kFullMask = 0xffffffffu;
// consecutive rows a thread carries through one step of a tile: one vector
// load reads a slot's values of all of them, and their adds are independent
constexpr int kRowsPerStep = 4;

enum TableMode {
  kGlobalAtomics = 0,
  kPrivateTables = 1,
  kSharedTable = 2,
  kSplitPlanes = 3
};

// Layout shared with pinot_tpu_torch/ops/_cuda.py (_Geom).
struct Geom {
  long long n;
  long long full_rows;
  unsigned long long vec_mask;  // bit s: slot s's rows in a stage start on
                                // a multiple of 4 rows (one vector load)
  int tile_rows;
  int stages;
  int stage_bytes;
  int tx_bytes;
  int num_slots;
  int mode;
  int cluster;
  int clusters;
  int units;  // of the whole family: segments * seg_units
  int epoch_iters;
  int table_planes;
  int table_groups;
  int table_counters;
  int table_off;
  int ring_off;
  int smem_bytes;
  int warp_agg;
  int segments;    // S, each n rows of every slot plane
  int seg_units;   // units of one segment
  int unit_tiles;  // tiles of one unit: cluster, or 1 in the split mode
  unsigned tg_inv;  // ceil(2^32 / table_groups): g / table_groups = umulhi
  int mis[kMaxSlots];
  int copy_bytes[kMaxSlots];
  int smem_off[kMaxSlots];
  int row_off[kMaxSlots];  // of row 0 within a stage
};

// -- PTX helpers ---------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Arrive on the mbarrier at `addr` in the cluster's shared memory (mapa;
// a shared::cta address of this CTA is one too).
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t addr) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];" ::"r"(addr)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred P1;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
        "selp.u32 %0, 1, 0, P1;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// 1-D bulk copy of `bytes` (a multiple of 16, both addresses 16-aligned)
// from device memory into this CTA's shared memory.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The same copy into the shared memory of every CTA in `mask`, at the same
// offset, each completing on its own mbarrier at `bar`'s offset.
__device__ __forceinline__ void bulk_load_multicast(void* dst, const void* src,
                                                    uint32_t bytes,
                                                    uint64_t* bar,
                                                    uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes."
      "multicast::cluster [%0], [%1], %2, [%3], %4;" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar)),
      "h"(mask)
      : "memory");
}

// -- counters --------------------------------------------------------------

// One slot plane, as warp 0's copies read it; kept in shared memory.
struct Slot {
  const unsigned char* src;  // the aligned address below segment 0's row 0
  long long seg_bytes;       // from one segment's plane to the next
  int width;                 // bytes per row
  int copy_bytes;            // of one tile's copy
  int smem_off;              // of the copy within a stage
};

struct Ctx {
  int* table;
  uint32_t table_addr;  // the table's shared-memory address
  unsigned long long* out;
  long long seg_off;  // where the current segment's (P, G) block starts
  int mode;
  int rank;
  int tg;      // groups of one CTA's table
  unsigned tg_inv;
  int groups;  // G of the output
  int p0, p1;  // the planes of this CTA's table (split), else [0, P)
  uint32_t junk;  // this lane's word of the junk row (shared memory)
};

// The values of rows r .. r + 3 (r a multiple of 4) of a slot plane at
// `base` in shared memory: by one vector load when `vec` (the plane's place
// in the stage is aligned to 4 rows), else by four scalar loads; 0 where
// !valid.
__device__ __forceinline__ void load4_u8(const unsigned char* base, int r,
                                         bool valid, bool vec, int (&out)[4]) {
  if (!valid) {
    out[0] = out[1] = out[2] = out[3] = 0;
  } else if (vec) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(base + r);
#pragma unroll
    for (int k = 0; k < 4; ++k) out[k] = (int)((w >> (8 * k)) & 0xffu);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) out[k] = base[r + k];
  }
}

__device__ __forceinline__ void load4_s8(const unsigned char* base, int r,
                                         bool valid, bool vec, int (&out)[4]) {
  if (!valid) {
    out[0] = out[1] = out[2] = out[3] = 0;
  } else if (vec) {
    const int32_t w = *reinterpret_cast<const int32_t*>(base + r);
#pragma unroll
    for (int k = 0; k < 4; ++k) out[k] = (w << (24 - 8 * k)) >> 24;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      out[k] = reinterpret_cast<const int8_t*>(base)[r + k];
  }
}

__device__ __forceinline__ void load4_u16(const unsigned char* base, int r,
                                          bool valid, bool vec, int (&out)[4]) {
  const uint16_t* b = reinterpret_cast<const uint16_t*>(base);
  if (!valid) {
    out[0] = out[1] = out[2] = out[3] = 0;
  } else if (vec) {
    const uint2 w = *reinterpret_cast<const uint2*>(b + r);
    out[0] = (int)(w.x & 0xffffu);
    out[1] = (int)(w.x >> 16);
    out[2] = (int)(w.y & 0xffffu);
    out[3] = (int)(w.y >> 16);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) out[k] = b[r + k];
  }
}

__device__ __forceinline__ void load4_i32(const unsigned char* base, int r,
                                          bool valid, bool vec, int (&out)[4]) {
  const int32_t* b = reinterpret_cast<const int32_t*>(base);
  if (!valid) {
    out[0] = out[1] = out[2] = out[3] = 0;
  } else if (vec) {
    const int4 w = *reinterpret_cast<const int4*>(b + r);
    out[0] = w.x;
    out[1] = w.y;
    out[2] = w.z;
    out[3] = w.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) out[k] = b[r + k];
  }
}

// One add into this CTA's table. A row that adds nothing (a zero payload,
// or a row the filter drops) adds into its lane's own junk word instead:
// the add needs no branch around it, and the masked rows of a warp do not
// pile onto one counter (the trash group).
__device__ __forceinline__ void red_shared(uint32_t addr, int v) {
  asm volatile("red.shared::cta.add.u32 [%0], %1;" ::"r"(addr), "r"(v)
               : "memory");
}

// The same into a table anywhere in the cluster: `addr` from mapa (this
// CTA's own shared-memory addresses, such as the junk word, are cluster
// addresses too).
__device__ __forceinline__ void red_cluster(uint32_t addr, int v) {
  asm volatile("red.shared::cluster.add.u32 [%0], %1;" ::"r"(addr), "r"(v)
               : "memory");
}

// A predicated reduction: nothing happens where v == 0.
__device__ __forceinline__ void red_global(unsigned long long* addr, int v) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.s32 p, %1, 0;\n"
      "@p red.global.add.u64 [%0], %2;\n}\n" ::"l"(
          reinterpret_cast<uint64_t>(addr)),
      "r"(v), "l"((unsigned long long)(unsigned)v)
      : "memory");
}

// Adds `bytes` of int64 at `src` (shared memory, 16-aligned) into `dst`
// (device memory, 16-aligned) with one bulk asynchronous reduction.
__device__ __forceinline__ void bulk_add_u64(unsigned long long* dst,
                                             const long long* src,
                                             uint32_t bytes) {
  asm volatile(
      "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.u64 [%0], [%1], "
      "%2;" ::"l"(reinterpret_cast<uint64_t>(dst)),
      "r"(smem_u32(src)), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Until the bulk reductions issued by this thread have read their source.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// Until they have completed.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// The address of `addr` (this CTA's shared memory) in CTA `rank`'s.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

// Adds the plane values of K rows into their groups g[k], for the rows
// with m[k] (and, with kSkipZero, a non-zero value: kernel A's masked rows
// are live rows of zero payload in the trash group). Every other add goes
// to the lane's junk word. vals(p, v) fills v[k] with plane p's value of
// row k, whatever m[k]; the loop over the planes is unrolled to kMaxP, so
// the plane index is a constant of the code and per-plane fields of the
// kernels' parameters are operands from the constant bank. Every lane of
// the warp calls this together. With warp_agg (private tables of few
// groups, where lanes often hit one counter) the lanes first sum equal
// groups within the warp and one lane adds each sum.
template <int K, int kMaxP, bool kSkipZero, class Vals>
__device__ __forceinline__ void add_rows(const Ctx& c, const bool (&m)[K],
                                         const int (&g)[K], int planes,
                                         const Vals& vals, bool warp_agg) {
  int v[K];
  auto at = [&](int k, uint32_t addr) {
    return (kSkipZero ? m[k] && v[k] != 0 : m[k]) ? addr : c.junk;
  };
  if (c.mode == kGlobalAtomics) {
#pragma unroll
    for (int p = 0; p < kMaxP; ++p) {
      if (p >= planes) break;
      vals(p, v);
#pragma unroll
      for (int k = 0; k < K; ++k)
        red_global(c.out + c.seg_off + (long long)p * c.groups + g[k],
                   m[k] ? v[k] : 0);
    }
  } else if (c.mode == kSplitPlanes) {
    // this CTA's planes [p0, p1) of every group, at (p - p0) * G + g
    uint32_t a[K];
#pragma unroll
    for (int k = 0; k < K; ++k)
      a[k] = c.table_addr + 4u * (uint32_t)(g[k] - c.p0 * c.tg);
#pragma unroll
    for (int p = 0; p < kMaxP; ++p) {
      if (p >= c.p1) break;
      if (p < c.p0) continue;
      vals(p, v);
#pragma unroll
      for (int k = 0; k < K; ++k)
        red_shared(at(k, a[k] + 4u * (uint32_t)(p * c.tg)), v[k]);
    }
  } else if (c.mode == kSharedTable) {
    // group g lives in CTA g / tg at local group g % tg
    uint32_t a[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int owner = (int)__umulhi((unsigned)g[k], c.tg_inv);
      a[k] = map_rank(c.table_addr + 4u * (uint32_t)(g[k] - owner * c.tg),
                      owner);
    }
#pragma unroll
    for (int p = 0; p < kMaxP; ++p) {
      if (p >= planes) break;
      vals(p, v);
#pragma unroll
      for (int k = 0; k < K; ++k)
        red_cluster(at(k, a[k] + 4u * (uint32_t)(p * c.tg)), v[k]);
    }
  } else if (warp_agg) {
    const int lane = threadIdx.x & 31;
    unsigned peers[K];
    bool leader[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const unsigned active = __ballot_sync(kFullMask, m[k]);
      peers[k] = m[k] ? __match_any_sync(active, g[k]) : 0u;
      leader[k] = m[k] && lane == __ffs(peers[k]) - 1;
    }
#pragma unroll
    for (int p = 0; p < kMaxP; ++p) {
      if (p >= planes) break;
      vals(p, v);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (m[k]) {
          const unsigned sum = __reduce_add_sync(peers[k], (unsigned)v[k]);
          const uint32_t addr =
              c.table_addr + 4u * (uint32_t)(p * c.tg + g[k]);
          red_shared(leader[k] ? addr : c.junk, (int)sum);
        }
      }
    }
  } else {
    uint32_t a[K];
#pragma unroll
    for (int k = 0; k < K; ++k) a[k] = c.table_addr + 4u * (uint32_t)g[k];
#pragma unroll
    for (int p = 0; p < kMaxP; ++p) {
      if (p >= planes) break;
      vals(p, v);
#pragma unroll
      for (int k = 0; k < K; ++k)
        red_shared(at(k, a[k] + 4u * (uint32_t)(p * c.tg)), v[k]);
    }
  }
}

// Zeroes a table of `counters` int32, rounded up to whole int4s (the
// table's space in shared memory is).
__device__ __forceinline__ void zero_table(int* table, int counters) {
  int4* t4 = reinterpret_cast<int4*>(table);
  const int4 zero = make_int4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < (counters + 3) / 4; i += blockDim.x) t4[i] = zero;
}

// Where counter i of this CTA's shared or split table goes in the flat
// (P, G) output (a private table's layout is the output's).
__device__ __forceinline__ long long out_index(const Ctx& c, int i) {
  const int p = i / c.tg;
  const int g = i - p * c.tg;
  if (c.mode == kSharedTable)
    return (long long)p * c.groups + c.rank * c.tg + g;
  return (long long)(c.p0 + p) * c.groups + g;
}

// Collective over the cluster, between epochs and between segments: add
// the tables into the current segment's output (int64) with one global
// atomic per non-zero counter, and zero them for what follows. No CTA
// re-zeroes while another may still read or add into its table.
// Counters go four at a time (int4): in private mode CTA `rank` sums the
// rank-th share of the table's int4s over the C tables.
__device__ __forceinline__ void flush_tables(const Ctx& c,
                                             cg::cluster_group& cl,
                                             int counters, int csize) {
  cl.sync();
  const int chunks = (counters + 3) / 4;
  if (c.mode == kPrivateTables) {
    const int per = (chunks + csize - 1) / csize;
    const int lo = c.rank * per;
    const int hi = min(chunks, lo + per);
    for (int i4 = lo + (int)threadIdx.x; i4 < hi; i4 += blockDim.x) {
      long long s[4] = {0, 0, 0, 0};
      for (int r = 0; r < csize; ++r) {
        const int4 v =
            reinterpret_cast<const int4*>(cl.map_shared_rank(c.table, r))[i4];
        s[0] += v.x;
        s[1] += v.y;
        s[2] += v.z;
        s[3] += v.w;
      }
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        const int i = 4 * i4 + l;
        if (i < counters && s[l]) {
          const int p = i / c.tg;
          atomicAdd(c.out + c.seg_off + (long long)p * c.groups + (i - p * c.tg),
                    (unsigned long long)s[l]);
        }
      }
    }
  } else if (c.mode != kGlobalAtomics) {
    for (int i4 = threadIdx.x; i4 < chunks; i4 += blockDim.x) {
      const int4 v4 = reinterpret_cast<const int4*>(c.table)[i4];
      const int v[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        const int i = 4 * i4 + l;
        if (i < counters && v[l])
          atomicAdd(c.out + c.seg_off + out_index(c, i),
                    (unsigned long long)v[l]);
      }
    }
  }
  cl.sync();
  zero_table(c.table, counters);
  cl.sync();
}

// Adds values [0, count) to out[dst, dst + count) through `staging` (int64
// in this CTA's shared memory, room for `cap` values). A round of at most
// cap - 4 values (a multiple of 4): fill(b, n, at) writes values [b, b + n)
// to at[0, n); they sit at the parity of their place in `out`, padded with
// zeros to whole 16 bytes, and thread 0 adds them with one bulk reduction.
// The output is 16-aligned and has room for the padding past its last
// counter; adding 0 to a neighbour changes nothing.
template <class Fill>
__device__ __forceinline__ void reduce_range(unsigned long long* out,
                                             long long dst, int count,
                                             long long* staging, int cap,
                                             const Fill& fill) {
  const int step = (cap - 4) & ~3;
  for (int b = 0; b < count; b += step) {
    const int n = min(step, count - b);
    const int sh = (int)((dst + b) & 1);
    fill(b, n, staging + sh);
    if (threadIdx.x == 0) {
      if (sh) staging[0] = 0;
      if ((sh + n) & 1) staging[sh + n] = 0;
    }
    fence_proxy_async();
    __syncthreads();
    if (threadIdx.x == 0) {
      bulk_add_u64(out + (dst + b - sh), staging,
                   8u * (uint32_t)((sh + n + 1) & ~1));
      bulk_wait_read();
    }
    __syncthreads();
  }
}

// The last flush: like flush_tables, but each CTA adds its int64 sums to the
// current segment's output by bulk reductions of contiguous ranges, staged
// in the ring (idle by then), not by one global atomic per counter.
__device__ __forceinline__ void flush_final(const Ctx& c, cg::cluster_group& cl,
                                            int counters, int csize,
                                            long long* staging, int cap) {
  cl.sync();
  if (c.mode == kPrivateTables) {
    // CTA rank sums the rank-th share of the int4s of the flat P x G
    // tables, whose layout is the output's
    const int chunks = (counters + 3) / 4;
    const int per = (chunks + csize - 1) / csize;
    const int lo = min(counters, 4 * c.rank * per);
    const int hi = min(counters, 4 * (c.rank + 1) * per);
    reduce_range(c.out, c.seg_off + lo, hi - lo, staging, cap,
                 [&](int b, int n, long long* at) {
      for (int i = 4 * (int)threadIdx.x; i < n; i += 4 * blockDim.x) {
        long long v[4] = {0, 0, 0, 0};
        for (int r = 0; r < csize; ++r) {
          const int4 w = *reinterpret_cast<const int4*>(
              cl.map_shared_rank(c.table + lo + b + i, r));
          v[0] += w.x;
          v[1] += w.y;
          v[2] += w.z;
          v[3] += w.w;
        }
#pragma unroll
        for (int l = 0; l < 4; ++l)
          if (i + l < n) at[i + l] = v[l];
      }
    });
  } else if (c.mode == kSplitPlanes) {
    // planes [p0, p1) of every group: one contiguous range of the output
    const int n = (c.p1 - c.p0) * c.tg;
    if (n > 0)
      reduce_range(c.out, c.seg_off + (long long)c.p0 * c.groups, n, staging,
                   cap, [&](int b, int m, long long* at) {
        for (int j = threadIdx.x; j < m; j += blockDim.x)
          at[j] = c.table[b + j];
      });
  } else if (c.mode == kSharedTable) {
    // CTA rank holds groups [rank * tg, (rank + 1) * tg) of every plane
    const int g0 = c.rank * c.tg;
    const int n = min(c.tg, c.groups - g0);
    const int planes = counters / c.tg;
    for (int p = 0; n > 0 && p < planes; ++p)
      reduce_range(c.out, c.seg_off + (long long)p * c.groups + g0, n, staging,
                   cap, [&](int b, int m, long long* at) {
        for (int j = threadIdx.x; j < m; j += blockDim.x)
          at[j] = c.table[p * c.tg + b + j];
      });
  }
  if (threadIdx.x == 0) bulk_wait();
  // no CTA leaves while another may still read its table
  cl.sync();
}

// -- the persistent loop ------------------------------------------------------
//
// Op supplies, for the kernel's slot planes and rows:
//   int width(int s)                      bytes per row of slot s
//   const unsigned char* slot_ptr(int s)  slot s of segment 0 in device
//                                         memory
//   long long seg_bytes(int s)            from one segment's slot s to the
//                                         next's (a multiple of 16)
//   void smem_rows(Ctx&, stage, r, row0, tile_rows)
//        rows r .. r + kRowsPerStep - 1 (r a multiple of kRowsPerStep; none
//        when r >= tile_rows) of the tile of rows [row0, row0 + tile_rows)
//        of a segment in a stage
//   void global_row(Ctx&, seg, row, valid)  a tail row of segment seg, from
//                                           device memory
// Every lane of a warp calls them together.
template <class Op>
__device__ __forceinline__ void run(const Geom& geo, const Op& op, int planes,
                                    int groups,
                                    unsigned long long* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ Slot slots[kMaxSlots];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  cg::cluster_group cl = cg::this_cluster();
  const bool split = geo.mode == kSplitPlanes;
  Ctx c;
  c.table = reinterpret_cast<int*>(smem + geo.table_off);
  c.table_addr = smem_u32(c.table);
  c.out = out;
  c.seg_off = 0;
  c.mode = geo.mode;
  c.rank = (int)cl.block_rank();
  c.tg = geo.table_groups;
  c.tg_inv = geo.tg_inv;
  c.groups = groups;
  c.p0 = split ? c.rank * geo.table_planes : 0;
  c.p1 = split ? min(planes, c.p0 + geo.table_planes) : planes;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  c.junk = smem_u32(smem) + 8u * 2 * kMaxStages + 4u * (uint32_t)lane;

  if (tid < geo.num_slots) {
    Slot& sl = slots[tid];
    sl.width = op.width(tid);
    sl.src = op.slot_ptr(tid) - geo.mis[tid];
    sl.seg_bytes = op.seg_bytes(tid);
    sl.copy_bytes = geo.copy_bytes[tid];
    sl.smem_off = geo.smem_off[tid];
  }
  // a stage is free again once every warp that reads it (of the whole
  // cluster, in the split mode: CTA 0 refills it for all) has arrived
  const int warps = blockDim.x / 32;
  if (tid == 0) {
    for (int s = 0; s < geo.stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, split ? geo.cluster * warps : warps);
    }
    fence_mbar_init();
  }
  zero_table(c.table, geo.table_counters);
  // every table and barrier of the cluster is ready before the first
  // (remote) add, copy or arrival
  cl.sync();

  const long long seg_counters = (long long)planes * groups;
  // rows past the last whole tile of every segment, spread over the
  // grid's threads (each row once, every plane of it), straight into the
  // output by global atomics: a table holds one segment at a time
  {
    const long long tail = geo.n - geo.full_rows;
    const long long total = tail * geo.segments;
    const long long stride = (long long)gridDim.x * blockDim.x;
    Ctx g = c;
    g.mode = kGlobalAtomics;
    for (long long base = (long long)blockIdx.x * blockDim.x; base < total;
         base += stride) {
      const long long i = base + tid;
      const bool ok = i < total;
      const int seg = ok ? (int)(i / tail) : 0;
      g.seg_off = seg * seg_counters;
      op.global_row(g, seg, geo.full_rows + (ok ? i - seg * tail : 0), ok);
    }
  }

  const int q = blockIdx.x / geo.cluster;
  const long long num_tiles = geo.full_rows / geo.tile_rows;
  const int rank = c.rank;
  const int nslots = geo.num_slots;
  const uint16_t cta_mask = (uint16_t)((1u << geo.cluster) - 1);
  // this cluster's units [u0, u0 + steps): step j is unit u0 + j, of
  // segment (u0 + j) / seg_units; the CTA's tile of that segment is
  // ((u0 + j) % seg_units) * unit_tiles (+ rank), none when >= num_tiles.
  // Two cursors (segment, unit of it) walk the range one unit at a time,
  // the producer's ahead of the consumers': a 64-bit division per step
  // costs the consumers registers and about 15% of the kernel's time
  const long long u0 = (long long)q * geo.units / geo.clusters;
  const int steps =
      (int)((long long)(q + 1) * geo.units / geo.clusters - u0);
  // (no whole tile at all: no unit, and the table stays segment 0's)
  const int seg0 = steps > 0 ? (int)(u0 / geo.seg_units) : 0;
  const int unit0 = (int)(u0 - (long long)seg0 * geo.seg_units);
  int pj = 0, pseg = seg0, punit = unit0;
  int cseg = seg0, cunit = unit0;
  // warp 0 only, lane k taking slot k (k < 32, then k + 32): the tile of
  // the producer's next step into stage s, once every warp is done with
  // the stage (phase `free_parity` of its empty barrier, when `refill`).
  // In the split mode CTA 0 copies for the whole cluster and every CTA
  // expects the bytes.
  auto issue = [&](int s, bool refill, uint32_t free_parity) {
    if (pj >= steps) return;
    const long long seg = pseg;
    const long long t =
        (long long)punit * geo.unit_tiles + (split ? 0 : rank);
    ++pj;
    if (++punit == geo.seg_units) {
      punit = 0;
      ++pseg;
    }
    if (t >= num_tiles) return;
    unsigned char* dst = smem + geo.ring_off + (size_t)s * geo.stage_bytes;
    const long long row0 = t * geo.tile_rows;
    if (lane == 0) mbar_expect_tx(full + s, (uint32_t)geo.tx_bytes);
    if (split && rank != 0) return;
    if (refill && lane == 0) mbar_wait(empty + s, free_parity);
    __syncwarp();
    for (int k = lane; k < nslots; k += 32) {
      unsigned char* to = dst + slots[k].smem_off;
      const unsigned char* from =
          slots[k].src + seg * slots[k].seg_bytes + row0 * slots[k].width;
      if (split)
        bulk_load_multicast(to, from, (uint32_t)slots[k].copy_bytes, full + s,
                            cta_mask);
      else
        bulk_load(to, from, (uint32_t)slots[k].copy_bytes, full + s);
    }
  };

  if (tid < 32)
    for (int j = 0; j < geo.stages - 1; ++j) issue(j, false, 0);
  // Step j reads stage s = j % stages in phase `parity`; the copy issued at
  // step j fills stage (j - 1) % stages, freed when every warp has read
  // step j - 1 (whose phase was `fill_parity`). No block-wide barrier
  // between steps: a warp moves on to the next tile as soon as it is done,
  // so warps at different tiles overlap their latencies.
  int s = 0, fill = geo.stages - 1;
  uint32_t parity = 0, fill_parity = 0;
  const uint32_t empty_addr = split ? map_rank(smem_u32(empty), 0)
                                    : smem_u32(empty);
  int cur = cseg;
  c.seg_off = cur * seg_counters;
  for (int j = 0; j < steps; ++j) {
    // every CTA of the cluster is at the same unit, so they agree on when
    // to flush: at a new segment, and every epoch_iters steps
    if (j > 0 && (cseg != cur || j % geo.epoch_iters == 0)) {
      flush_tables(c, cl, geo.table_counters, geo.cluster);
      cur = cseg;
      c.seg_off = cur * seg_counters;
    }
    if (tid < 32) issue(fill, j > 0, fill_parity);
    const long long t =
        (long long)cunit * geo.unit_tiles + (split ? 0 : rank);
    if (++cunit == geo.seg_units) {
      cunit = 0;
      ++cseg;
    }
    if (t < num_tiles) {
      mbar_wait(full + s, parity);
      const unsigned char* stage =
          smem + geo.ring_off + (size_t)s * geo.stage_bytes;
      const long long row0 = t * geo.tile_rows;
      for (int r = kRowsPerStep * tid; r < geo.tile_rows;
           r += kRowsPerStep * blockDim.x)
        op.smem_rows(c, stage, r, row0, geo.tile_rows);
    }
    __syncwarp();
    if (lane == 0) {
      // the stage's reads (generic proxy) come before the next copy into
      // it (async proxy)
      fence_proxy_async();
      mbar_arrive_cluster(empty_addr + 8u * (uint32_t)s);
    }
    fill = s;
    fill_parity = parity;
    if (++s == geo.stages) {
      s = 0;
      parity ^= 1;
    }
  }
  flush_final(c, cl, geo.table_counters, geo.cluster,
              reinterpret_cast<long long*>(smem + geo.ring_off),
              (geo.stages * geo.stage_bytes / 8) & ~1);
}

// -- host side -------------------------------------------------------------

// Launch `kernel` over geo's grid of clusters on `stream`.
template <class Kernel, class... Args>
inline cudaError_t launch_clusters(Kernel kernel, const Geom& geo,
                                   cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(geo.clusters * geo.cluster), 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)geo.smem_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)geo.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// How many clusters of `cluster` CTAs with `smem` bytes of dynamic shared
// memory the card holds at once.
template <class Kernel>
inline cudaError_t max_active_clusters(Kernel kernel, int cluster, int smem,
                                       int* count) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cluster, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(count, (const void*)kernel, &cfg);
}

}  // namespace pinot
