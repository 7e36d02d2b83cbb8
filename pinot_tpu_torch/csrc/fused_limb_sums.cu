// Fused dense group-by (kernel B): filter -> group id -> count/limb/neg
// planes -> per-group sums, in one pass over the raw column planes.
//
// Replaces the TPU kernel pinot_tpu/ops/fused_groupby.py:314
// `_fused_limb_sums` (body `_kernel` :353, ending in mxu_groupby's
// `_matmul_tail`). Per row r:
//
//   m   = (r + row_offset < num_docs) AND every term holds, where a term
//         is a union of closed int32 runs [lo, hi] over one plane
//         (an interval is one run)
//   gid = sum of plane[slot][r] * stride over the group slots
//   planes: count -> m; limb -> (u32(v) >> shift) & 127; neg -> v < 0
//   out[p, gid] += plane value, for rows with m (other rows add 0)
//
// One compiled kernel serves every FusedPlan: the plan rides in a
// descriptor passed by value, the literal bounds in an int32 scalar vector
// [num_docs, row_offset, lo0, hi0, lo1, hi1, ...] read once per CTA.
//
// Bound on an H100: bytes. The function reads n times the sum of the
// distinct slots' widths (1, 2 or 4 bytes) and writes 8 * P * G; its
// integer work (a few compares and adds per row and plane) is far below the
// card's rate. The design (group_table.cuh) reads each slot plane once per
// launch, whatever P: bulk asynchronous copies bring a tile of every slot's
// rows into a ring in shared memory (2 tiles in flight per SM), so the
// filter, group and payload values of a row come from shared memory and
// never wait on device memory in a chain. The loops over the plan's terms,
// group dimensions and planes are unrolled to their maxima, so every field
// of the descriptor is read as a constant-bank operand; the host resolves
// each term's, dimension's and plane's slot into its type, vector-load flag
// and place in a stage once per plan and geometry, not per access. The
// per-group sums live in shared memory: in each CTA's private table when
// P x G fits one CTA (the q2 plan), else split across the cluster by plane,
// each tile multicast to every CTA of it (the q9 plan's 224 KB), so no
// plane is read twice.
#include "group_table.cuh"

namespace {

using pinot::Ctx;
using pinot::Geom;

constexpr int kMaxTerms = 8;
constexpr int kMaxRuns = 4;
constexpr int kMaxGroupDims = 16;
constexpr int kMaxPlanes = 24;
constexpr int kMaxScalars = 2 + 2 * kMaxTerms * kMaxRuns;


enum SlotType { kU8 = 0, kU16 = 1, kI32 = 2 };
// a load code is a SlotType, plus kVec when the rows in a stage take
// vector loads
constexpr int kVec = 4;
enum PlaneKind { kCount = 0, kLimb = 1, kNeg = 2 };

}  // namespace

// Layout shared with pinot_tpu_torch/ops/fused_groupby.py (_Desc).
struct FusedDesc {
  const void* slot_ptr[pinot::kMaxSlots];
  int slot_type[pinot::kMaxSlots];
  int n_terms;
  int term_slot[kMaxTerms];
  int term_code[kMaxTerms];
  int term_at[kMaxTerms];  // the slot's row 0 within a stage
  int term_runs[kMaxTerms];
  int term_bound[kMaxTerms];  // its first lo in the scalar vector
  int n_groups;
  int group_slot[kMaxGroupDims];
  int group_code[kMaxGroupDims];
  int group_at[kMaxGroupDims];
  int group_stride[kMaxGroupDims];
  int n_planes;
  int plane_kind[kMaxPlanes];
  int plane_slot[kMaxPlanes];
  int plane_code[kMaxPlanes];
  int plane_at[kMaxPlanes];
  int plane_shift[kMaxPlanes];
};

namespace {

__device__ __forceinline__ int load_at(const unsigned char* p, int type,
                                       long long r) {
  if (type == kU8) return p[r];
  if (type == kU16) return reinterpret_cast<const uint16_t*>(p)[r];
  return reinterpret_cast<const int32_t*>(p)[r];
}

struct FusedOp {
  const FusedDesc& d;  // the kernel parameter: constant-bank reads
  const Geom& geo;
  const int* sc;  // the scalar vector, in shared memory

  __device__ __forceinline__ int width(int s) const {
    return d.slot_type[s] == kU8 ? 1 : d.slot_type[s] == kU16 ? 2 : 4;
  }

  __device__ __forceinline__ const unsigned char* slot_ptr(int s) const {
    return static_cast<const unsigned char*>(d.slot_ptr[s]);
  }

  // K rows with their row numbers idx[k] (checked against num_docs when
  // `check_docs`); load(slot, code, at, mask, v) fills v[k] with the slot's
  // value of row k where mask[k] (0 elsewhere), from a stage (by code and
  // at) or from device memory (by slot).
  template <int K, class Load>
  __device__ __forceinline__ void rows(Ctx& c, const long long (&idx)[K],
                                       const bool (&valid)[K], bool check_docs,
                                       const Load& load) const {
    const long long num_docs = sc[0], row_offset = sc[1];
    bool m[K];
    int v[K], g[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      m[k] = valid[k] && (!check_docs || idx[k] + row_offset < num_docs);
      g[k] = 0;
    }
#pragma unroll
    for (int t = 0; t < kMaxTerms; ++t) {
      if (t >= d.n_terms) break;
      load(d.term_slot[t], d.term_code[t], d.term_at[t], m, v);
      const int* bounds = sc + d.term_bound[t];
      bool tm[K];
#pragma unroll
      for (int k = 0; k < K; ++k) tm[k] = false;
#pragma unroll
      for (int r = 0; r < kMaxRuns; ++r) {
        if (r >= d.term_runs[t]) break;
        const int lo = bounds[2 * r], hi = bounds[2 * r + 1];
#pragma unroll
        for (int k = 0; k < K; ++k) tm[k] |= (v[k] >= lo) & (v[k] <= hi);
      }
#pragma unroll
      for (int k = 0; k < K; ++k) m[k] = m[k] && tm[k];
    }
#pragma unroll
    for (int j = 0; j < kMaxGroupDims; ++j) {
      if (j >= d.n_groups) break;
      load(d.group_slot[j], d.group_code[j], d.group_at[j], m, v);
      const int stride = d.group_stride[j];
#pragma unroll
      for (int k = 0; k < K; ++k) g[k] += v[k] * stride;
    }
    // a SUM's limb and neg planes are consecutive: its slot is loaded once
    int held = -1;
    auto vals = [&](int p, int (&out)[K]) {
      const int kind = d.plane_kind[p];
      if (kind == kCount) {
#pragma unroll
        for (int k = 0; k < K; ++k) out[k] = 1;
        return;
      }
      const int slot = d.plane_slot[p];
      if (slot != held) {
        load(slot, d.plane_code[p], d.plane_at[p], m, v);
        held = slot;
      }
      if (kind == kLimb) {
        const int shift = d.plane_shift[p];
#pragma unroll
        for (int k = 0; k < K; ++k)
          out[k] = (int)(((unsigned)v[k] >> shift) & 127u);
      } else {
#pragma unroll
        for (int k = 0; k < K; ++k) out[k] = v[k] < 0;
      }
    };
    pinot::add_rows<K, kMaxPlanes, false>(c, m, g, d.n_planes, vals,
                                          geo.warp_agg);
  }

  __device__ __forceinline__ void smem_rows(Ctx& c, const unsigned char* stage,
                                            int r, long long row0,
                                            int tile_rows) const {
    constexpr int K = pinot::kRowsPerStep;
    const bool ok = r < tile_rows;
    long long idx[K];
    bool valid[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      idx[k] = row0 + r + k;
      valid[k] = ok;
    }
    // one vector load per slot for the K rows, whatever the rows' masks
    auto load = [&](int, int code, int at, const bool (&)[K], int (&out)[K]) {
      const unsigned char* base = stage + at;
      const bool vec = code & kVec;
      const int type = code & ~kVec;
      if (type == kU8)
        pinot::load4_u8(base, r, ok, vec, out);
      else if (type == kU16)
        pinot::load4_u16(base, r, ok, vec, out);
      else
        pinot::load4_i32(base, r, ok, vec, out);
    };
    // a tile wholly below num_docs (all but the last, on the main path)
    // needs no per-row check
    rows<K>(c, idx, valid, row0 + tile_rows + sc[1] > sc[0], load);
  }

  // one input per launch (the reference never batches this kernel)
  __device__ __forceinline__ long long seg_bytes(int) const { return 0; }

  __device__ __forceinline__ void global_row(Ctx& c, int, long long row,
                                             bool ok) const {
    const long long idx[1] = {row};
    const bool valid[1] = {ok};
    auto load = [&](int s, int, int, const bool (&mask)[1], int (&out)[1]) {
      out[0] = mask[0] ? load_at(slot_ptr(s), d.slot_type[s], row) : 0;
    };
    rows<1>(c, idx, valid, true, load);
  }
};

__global__ void __launch_bounds__(pinot::kThreads, 1)
fused_limb_sums_kernel(const __grid_constant__ FusedDesc d,
                       const __grid_constant__ Geom geo,
                       const int32_t* __restrict__ scalars, int n_scalars,
                       int groups, unsigned long long* __restrict__ out) {
  // the scalars in shared memory: the rows index them by term and run
  __shared__ int sc[kMaxScalars];
  for (int i = threadIdx.x; i < n_scalars; i += blockDim.x) sc[i] = scalars[i];
  __syncthreads();
  // run() synchronizes the cluster before any row is read
  const FusedOp op{d, geo, sc};
  pinot::run(geo, op, d.n_planes, groups, out);
}

}  // namespace

extern "C" int pinot_fused_limb_sums_setup() {
  return (int)cudaFuncSetAttribute(fused_limb_sums_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   pinot::kMaxDynamicSmem);
}

extern "C" int pinot_fused_limb_sums_max_clusters(int cluster, int smem,
                                                  int* count) {
  return (int)pinot::max_active_clusters(fused_limb_sums_kernel, cluster, smem,
                                         count);
}

extern "C" int pinot_fused_limb_sums(const FusedDesc* desc, const Geom* geo,
                                     const void* scalars, int n_scalars,
                                     int groups, void* out, void* stream) {
  if (n_scalars > kMaxScalars || desc->n_planes > kMaxPlanes ||
      desc->n_terms > kMaxTerms || desc->n_groups > kMaxGroupDims ||
      geo->num_slots > pinot::kMaxSlots || geo->segments != 1)
    return (int)cudaErrorInvalidValue;
  return (int)pinot::launch_clusters(
      fused_limb_sums_kernel, *geo, static_cast<cudaStream_t>(stream), *desc,
      *geo, static_cast<const int32_t*>(scalars), n_scalars, groups,
      static_cast<unsigned long long*>(out));
}
