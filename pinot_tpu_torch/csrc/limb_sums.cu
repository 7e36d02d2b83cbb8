// Dense per-group sums of small-integer payload planes (kernel A).
//
// Replaces the TPU kernel pinot_tpu/ops/mxu_groupby.py:211
// `_pallas_limb_sums` (body `_kernel` :128 -> `_matmul_tail` :142), which
// turns the reduction into a Kronecker one-hot matmul because the TPU's
// scatter unit is slow. Hopper has fast shared-memory atomics, so this
// kernel scatters instead:
//
//   out[p, g] = sum over rows r with gid[r] == g of planes[p, r]
//
// planes (S, P, n) int8 holding [0, 127], gid (S, n) int32 in [0, G);
// out (S, P, G) int64, zeroed by the caller: one launch for a batch family
// of S segments (the JAX package vmaps the Pallas call, which its batching
// rule turns into one launch with a batch grid axis), S = 1 for one
// segment. Rows whose payload is 0 add nothing: masked rows all carry gid
// G-1 and zero payloads, so they do not contend on the trash slot.
//
// Bound on an H100: bytes. The function reads S * n * (4 + P) bytes and
// writes 8 * S * P * G; it does one add per non-zero payload, far below the
// card's integer rate. The design (group_table.cuh) reads every input byte once,
// with bulk asynchronous copies keeping 2 tiles (32 KB each at P = 4) in
// flight per SM, and keeps the per-group sums in shared memory: in each
// CTA's private table when P x G fits one CTA (the cluster then sums its
// tables through distributed shared memory and flushes once), else split
// across the cluster by plane (each tile multicast to every CTA of it) or
// by group. A plane that does not start on 16 bytes (P planes of a ragged
// n, stacked) is copied from the aligned address below its tile and read at
// its offset. Plane p's place in a stage is a constant-bank operand
// (Geom::row_off), as the loop over the planes is unrolled. A family's
// units run segment by segment, each cluster over a contiguous range of
// them, so a table holds one segment at a time and is flushed into that
// segment's block when the range crosses into the next (at most a few
// times per cluster); the family is never folded into one table of
// S x G groups, which would leave the shared-memory tables for global
// atomics.
#include "group_table.cuh"

namespace {

using pinot::Ctx;
using pinot::Geom;

// mxu_groupby.MAX_PLANES
constexpr int kMaxPlanes = 24;

struct LimbOp {
  const Geom& geo;
  const int8_t* planes;
  const int32_t* gid;
  long long n;
  int num_planes;

  // slot 0 is gid, slot 1 + p is plane p
  __device__ __forceinline__ int width(int s) const { return s == 0 ? 4 : 1; }

  __device__ __forceinline__ const unsigned char* slot_ptr(int s) const {
    return s == 0 ? reinterpret_cast<const unsigned char*>(gid)
                  : reinterpret_cast<const unsigned char*>(
                        planes + (long long)(s - 1) * n);
  }

  // segment s's gid follows segment s - 1's n int32s, its planes the
  // previous segment's P planes of n bytes
  __device__ __forceinline__ long long seg_bytes(int s) const {
    return s == 0 ? 4 * n : (long long)num_planes * n;
  }

  __device__ __forceinline__ bool vec(int s) const {
    return (geo.vec_mask >> s) & 1ull;
  }

  __device__ __forceinline__ void smem_rows(Ctx& c, const unsigned char* stage,
                                            int r, long long,
                                            int tile_rows) const {
    constexpr int K = pinot::kRowsPerStep;
    const bool ok = r < tile_rows;
    const bool v[K] = {ok, ok, ok, ok};
    int g[K];
    pinot::load4_i32(stage + geo.row_off[0], r, ok, vec(0), g);
    auto vals = [&](int p, int (&out)[K]) {
      pinot::load4_s8(stage + geo.row_off[p + 1], r, ok, vec(p + 1), out);
    };
    pinot::add_rows<K, kMaxPlanes, true>(c, v, g, num_planes, vals,
                                         geo.warp_agg);
  }

  __device__ __forceinline__ void global_row(Ctx& c, int seg, long long row,
                                             bool valid) const {
    const bool v[1] = {valid};
    const int g[1] = {valid ? gid[(long long)seg * n + row] : 0};
    auto vals = [&](int p, int (&out)[1]) {
      out[0] = valid
                   ? (int)planes[((long long)seg * num_planes + p) * n + row]
                   : 0;
    };
    pinot::add_rows<1, kMaxPlanes, true>(c, v, g, num_planes, vals,
                                         geo.warp_agg);
  }
};

__global__ void __launch_bounds__(pinot::kThreads, 1)
limb_sums_kernel(const __grid_constant__ Geom geo,
                 const int8_t* __restrict__ planes,
                 const int32_t* __restrict__ gid, int num_planes, int groups,
                 unsigned long long* __restrict__ out) {
  const LimbOp op{geo, planes, gid, geo.n, num_planes};
  pinot::run(geo, op, num_planes, groups, out);
}

}  // namespace

extern "C" int pinot_limb_sums_setup() {
  return (int)cudaFuncSetAttribute(limb_sums_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   pinot::kMaxDynamicSmem);
}

extern "C" int pinot_limb_sums_max_clusters(int cluster, int smem,
                                            int* count) {
  return (int)pinot::max_active_clusters(limb_sums_kernel, cluster, smem,
                                         count);
}

extern "C" int pinot_limb_sums(const Geom* geo, const void* planes,
                               const void* gid, int num_planes, int groups,
                               void* out, void* stream) {
  if (geo->num_slots != num_planes + 1 || num_planes > kMaxPlanes ||
      geo->num_slots > pinot::kMaxSlots || geo->segments < 1)
    return (int)cudaErrorInvalidValue;
  return (int)pinot::launch_clusters(
      limb_sums_kernel, *geo, static_cast<cudaStream_t>(stream), *geo,
      static_cast<const int8_t*>(planes), static_cast<const int32_t*>(gid),
      num_planes, groups, static_cast<unsigned long long*>(out));
}

extern "C" const char* pinot_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
