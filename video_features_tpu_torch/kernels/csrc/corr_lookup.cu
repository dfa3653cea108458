// RAFT windowed correlation lookup for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernels of video_features_tpu/kernels/corr_lookup.py:
//   - vft_corr_lookup_level: `_level_kernel` (corr_lookup_level_pallas),
//     the 81-tap bilinear window of one pyramid level;
//   - vft_corr_lookup_proj:  `_proj_kernel` (_corr_lookup_proj_flat),
//     the 324 taps of all four levels projected through RAFT's motion-encoder
//     convc1: relu(taps @ W + b).
//
// Semantics (reference corr.py:29-50, models/raft.py corr_lookup_gather): for
// query q with level-0 centre (cx, cy), level l, tap k = xx * 9 + yy (x-offset
// slowest), the sample point is (cx / 2^l + xx - 4, cy / 2^l + yy - 4); its
// four bilinear corners are read straight from the unpadded (Hl, Wl) plane of
// that query, and a corner outside the plane contributes exactly zero (no
// clamping, no border replication). A level that pooled to 0x0 gives zeros.
//
// The TPU kernels recast the gather as one-hot / hat-function matmuls over
// planes padded to 8x128 tiles, because Mosaic has no fast gather. Hopper
// reads the four corners directly, so neither the padding nor the selector
// matmuls carry over.
//
// What bounds them on the card (shapes of the I3D flow stream, one 64-frame
// stack at 256x344: Q = 64 * 32 * 43 = 88,064 queries per GRU iteration):
//   - level: bytes. Each query writes 81 floats per level and reads about a
//     10x10 corner window; a few tens of MB per level, no arithmetic to speak
//     of. One thread per (query, tap): neighbouring threads write neighbouring
//     taps of one query (coalesced stores) and read one query's window.
//   - proj: operations. The projection is 2 * Q * 324 * 256 flops (about
//     14.6 GFLOP per iteration) in float32, which has no tensor-core path at
//     full precision; the window reads are ~0.2 GB. One block per tile of 32
//     queries writes its (32, 324) tap tile to shared memory (41.5 KB), then
//     each thread owns one output channel and accumulates the 32 queries in
//     registers over k, reading W[k, c] coalesced from L2 and four taps at a
//     time from shared memory (a broadcast float4 load feeds four FMAs), so
//     the loop is FMA-bound rather than shared-memory-bound. The 324-channel
//     intermediate never reaches device memory.
//
// vft_corr_lookup_packed replaces `_packed_kernel` (_corr_lookup_packed_flat):
// the same 324 taps, all four levels in one launch, read from the lane-dense
// packed (Q, K_total) plane of pack_pyramid. Level l's row r lives in group
// r / j_l at sub-row r % j_l, so the corner (r, x) of query q is the float at
// q * K_total + off_l + (r / j_l) * k_l + (r % j_l) * w_l + x. The TPU kernel
// selects a row's group with a G-way select-accumulate and the corners with
// one-hot matmuls (Mosaic has no gather); here each thread computes that
// address and reads its four corners directly. The bounds test is on (r, x)
// against the level's (h_l, w_l), never on the zero fill of the phantom rows
// and the lane tail. One thread per (query, tap): neighbouring threads write
// neighbouring taps of one query (coalesced stores) and read one query's
// packed row through L1. Bound: bytes, as for the level kernel; the packed
// plane's zero fill is never read. No size gate: JAX's G <= 16 and 2 MiB per
// query limits are the TPU's VMEM envelope.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRadius = 4;
constexpr int kWin = 2 * kRadius + 1;   // 9
constexpr int kTaps = kWin * kWin;      // 81
constexpr int kLevels = 4;
constexpr int kK = kLevels * kTaps;     // 324
constexpr int kTileQ = 32;
constexpr int kProjThreads = 256;
constexpr int kLevelThreads = 256;

struct Pyramid {
  const float* data[kLevels];
  int h[kLevels];
  int w[kLevels];
};

// Bilinear sample of one (h, w) plane at (x, y) with zeros outside the plane.
// Corner order and weight products follow corr_lookup_gather.
__device__ __forceinline__ float sample(const float* __restrict__ plane, int h,
                                        int w, float x, float y) {
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  const float wx1 = x - x0;
  const float wy1 = y - y0;
  float acc = 0.f;
#pragma unroll
  for (int dx = 0; dx < 2; ++dx) {
    const float xi = x0 + dx;
    const float wx = dx ? wx1 : 1.f - wx1;
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const float yi = y0 + dy;
      const float wy = dy ? wy1 : 1.f - wy1;
      if (xi >= 0.f && xi <= (float)(w - 1) && yi >= 0.f &&
          yi <= (float)(h - 1)) {
        acc += wx * wy * __ldg(plane + (int64_t)yi * w + (int64_t)xi);
      }
    }
  }
  return acc;
}

__device__ __forceinline__ float tap(const float* __restrict__ level, int h,
                                     int w, int64_t q, float cx, float cy,
                                     float scale, int k) {
  const int xx = k / kWin;
  const int yy = k - xx * kWin;
  const float* plane = level + q * (int64_t)h * w;
  return sample(plane, h, w, cx * scale + (float)(xx - kRadius),
                cy * scale + (float)(yy - kRadius));
}

__global__ void __launch_bounds__(kLevelThreads)
level_kernel(const float* __restrict__ level, int h, int w,
             const float* __restrict__ coords, int64_t q_total, float scale,
             float* __restrict__ out, int out_stride, int out_offset) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= q_total * kTaps) return;
  const int64_t q = i / kTaps;
  const int k = (int)(i - q * kTaps);
  const float cx = coords[2 * q];
  const float cy = coords[2 * q + 1];
  out[q * out_stride + out_offset + k] =
      tap(level, h, w, q, cx, cy, scale, k);
}

__global__ void __launch_bounds__(kProjThreads)
proj_kernel(Pyramid pyr, const float* __restrict__ coords, int64_t q_total,
            const float* __restrict__ weight, const float* __restrict__ bias,
            int c_out, float* __restrict__ out) {
  __shared__ __align__(16) float taps[kTileQ][kK];
  const int64_t q0 = (int64_t)blockIdx.x * kTileQ;

  // phase 1: the block's (32, 324) tap tile, one level at a time
#pragma unroll
  for (int lvl = 0; lvl < kLevels; ++lvl) {
    const float scale = 1.f / (float)(1 << lvl);
    for (int i = threadIdx.x; i < kTileQ * kTaps; i += blockDim.x) {
      const int ql = i / kTaps;
      const int k = i - ql * kTaps;
      const int64_t q = q0 + ql;
      float v = 0.f;
      if (q < q_total) {
        v = tap(pyr.data[lvl], pyr.h[lvl], pyr.w[lvl], q, coords[2 * q],
                coords[2 * q + 1], scale, k);
      }
      taps[ql][lvl * kTaps + k] = v;
    }
  }
  __syncthreads();

  // phase 2: relu(taps @ W + b), one output channel per thread
  for (int c = threadIdx.x; c < c_out; c += blockDim.x) {
    float acc[kTileQ];
#pragma unroll
    for (int q = 0; q < kTileQ; ++q) acc[q] = 0.f;
    for (int k = 0; k < kK; k += 4) {
      const float w0 = __ldg(weight + (int64_t)(k + 0) * c_out + c);
      const float w1 = __ldg(weight + (int64_t)(k + 1) * c_out + c);
      const float w2 = __ldg(weight + (int64_t)(k + 2) * c_out + c);
      const float w3 = __ldg(weight + (int64_t)(k + 3) * c_out + c);
#pragma unroll
      for (int q = 0; q < kTileQ; ++q) {
        const float4 t = *reinterpret_cast<const float4*>(&taps[q][k]);
        acc[q] = fmaf(t.x, w0, acc[q]);
        acc[q] = fmaf(t.y, w1, acc[q]);
        acc[q] = fmaf(t.z, w2, acc[q]);
        acc[q] = fmaf(t.w, w3, acc[q]);
      }
    }
    const float b = bias[c];
#pragma unroll
    for (int q = 0; q < kTileQ; ++q) {
      if (q0 + q < q_total) out[(q0 + q) * c_out + c] = fmaxf(acc[q] + b, 0.f);
    }
  }
}

// Packing geometry of one level (kernels/corr_lookup.py LevelMeta); h == 0
// marks a level that pooled to 0x0.
struct PackedLevel {
  int h, w, j, k, off;
};

struct PackedGeometry {
  PackedLevel lvl[kLevels];
};

// Corner (r, x) of one query's packed row, zero outside the level's plane.
// r and x arrive as floats (floor of a coordinate plus an integer offset) and
// are compared before any integer conversion, so far-away coords cannot wrap.
__device__ __forceinline__ float packed_corner(const float* __restrict__ row,
                                               const PackedLevel& m, float r,
                                               float x) {
  if (!(r >= 0.f && r <= (float)(m.h - 1) && x >= 0.f &&
        x <= (float)(m.w - 1))) {
    return 0.f;
  }
  const int ri = (int)r;
  const int xi = (int)x;
  return __ldg(row + m.off + (ri / m.j) * m.k + (ri % m.j) * m.w + xi);
}

__global__ void __launch_bounds__(kLevelThreads)
packed_kernel(const float* __restrict__ packed, int64_t k_total,
              const float* __restrict__ coords, int64_t q_total,
              PackedGeometry geo, float* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= q_total * kK) return;
  const int64_t q = i / kK;
  const int t = (int)(i - q * kK);
  const int lvl = t / kTaps;
  const int tap = t - lvl * kTaps;
  const int xx = tap / kWin;  // x-offset slowest
  const int yy = tap - xx * kWin;
  const float cx = coords[2 * q];
  const float cy = coords[2 * q + 1];
  const float* row = packed + q * k_total;
  float v = 0.f;
#pragma unroll
  for (int l = 0; l < kLevels; ++l) {
    if (l != lvl) continue;  // static index into geo: no local-memory copy
    const PackedLevel& m = geo.lvl[l];
    if (m.h == 0) break;  // a 0x0 level: every tap is zero
    const float scale = 1.f / (float)(1 << l);
    const float px0 = __fsub_rn(__fmul_rn(cx, scale), (float)kRadius);
    const float py0 = __fsub_rn(__fmul_rn(cy, scale), (float)kRadius);
    const float ix = floorf(px0);
    const float iy = floorf(py0);
    const float fx = __fsub_rn(px0, ix);
    const float fy = __fsub_rn(py0, iy);
    const float x0 = ix + (float)xx;
    const float r0 = iy + (float)yy;
    const float v00 = packed_corner(row, m, r0, x0);
    const float v10 = packed_corner(row, m, r0, x0 + 1.f);
    const float v01 = packed_corner(row, m, r0 + 1.f, x0);
    const float v11 = packed_corner(row, m, r0 + 1.f, x0 + 1.f);
    // the blend of JAX _packed_kernel, rounded op by op (no FMA contraction)
    // like the plain version
    const float gx = __fsub_rn(1.f, fx);
    const float gy = __fsub_rn(1.f, fy);
    v = __fmul_rn(__fmul_rn(gx, gy), v00);
    v = __fadd_rn(v, __fmul_rn(__fmul_rn(fx, gy), v10));
    v = __fadd_rn(v, __fmul_rn(__fmul_rn(gx, fy), v01));
    v = __fadd_rn(v, __fmul_rn(__fmul_rn(fx, fy), v11));
  }
  out[i] = v;
}

}  // namespace

extern "C" {

// One pyramid level: level (Q, h, w) f32, coords (Q, 2) f32 level-0 (x, y);
// writes out[q * out_stride + out_offset + k] for the 81 taps k.
// Returns the cudaError_t of the launch.
int vft_corr_lookup_level(const float* level, int h, int w,
                          const float* coords, int64_t q_total, int lvl,
                          float* out, int out_stride, int out_offset,
                          cudaStream_t stream) {
  const int64_t threads = q_total * kTaps;
  if (threads == 0) return (int)cudaSuccess;
  const int64_t blocks = (threads + kLevelThreads - 1) / kLevelThreads;
  level_kernel<<<(unsigned)blocks, kLevelThreads, 0, stream>>>(
      level, h, w, coords, q_total, 1.f / (float)(1 << lvl), out, out_stride,
      out_offset);
  return (int)cudaGetLastError();
}

// All four levels + convc1: level l (Q, h[l], w[l]) f32, coords (Q, 2) f32,
// weight (324, c_out) f32 in the lookup's channel order, bias (c_out,) f32;
// writes out (Q, c_out) = relu(lookup @ weight + bias).
int vft_corr_lookup_proj(const float* l0, int h0, int w0, const float* l1,
                         int h1, int w1, const float* l2, int h2, int w2,
                         const float* l3, int h3, int w3, const float* coords,
                         int64_t q_total, const float* weight,
                         const float* bias, int c_out, float* out,
                         cudaStream_t stream) {
  if (q_total == 0) return (int)cudaSuccess;
  Pyramid pyr{{l0, l1, l2, l3}, {h0, h1, h2, h3}, {w0, w1, w2, w3}};
  const int64_t blocks = (q_total + kTileQ - 1) / kTileQ;
  proj_kernel<<<(unsigned)blocks, kProjThreads, 0, stream>>>(
      pyr, coords, q_total, weight, bias, c_out, out);
  return (int)cudaGetLastError();
}

// All four levels from the packed plane: packed (Q, k_total) f32, coords
// (Q, 2) f32 level-0 (x, y), geometry = 4 x (h, w, j, k, off) host ints
// (h == 0 for a 0x0 level); writes out (Q, 324).
int vft_corr_lookup_packed(const float* packed, int64_t k_total,
                           const float* coords, int64_t q_total,
                           const int* geometry, float* out,
                           cudaStream_t stream) {
  const int64_t threads = q_total * kK;
  if (threads == 0) return (int)cudaSuccess;
  PackedGeometry geo;
  for (int l = 0; l < kLevels; ++l) {
    const int* g = geometry + 5 * l;
    geo.lvl[l] = PackedLevel{g[0], g[1], g[2], g[3], g[4]};
  }
  const int64_t blocks = (threads + kLevelThreads - 1) / kLevelThreads;
  packed_kernel<<<(unsigned)blocks, kLevelThreads, 0, stream>>>(
      packed, k_total, coords, q_total, geo, out);
  return (int)cudaGetLastError();
}

const char* vft_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
