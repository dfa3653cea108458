// RAFT windowed correlation lookup for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernels of video_features_tpu/kernels/corr_lookup.py:
//   - vft_corr_lookup_level: `_level_kernel` (corr_lookup_level_pallas),
//     the 81-tap bilinear window of every pyramid level, in one launch;
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
// The window loader (window_cells, blend_group), shared by level and proj: a
// warp loads the corner windows of kGroup = 4 queries at a time. With
// p = c / 2^l, every corner of a query's 81 taps lies in the 11x11 cells
// whose origin is (floor(px) - 4, floor(py) - 4): floor(p + d) is
// floor(p) + d or, where the float sum rounds up to an integer, one more.
// The warp reads those cells row by row, consecutive lanes on consecutive x,
// into warp-private shared memory with zeros outside the plane (level through
// registers, proj with cp.async); the blend then takes each tap's four
// corners from there in `sample`'s order and products (a zero corner adds
// exactly nothing, as the skipped corner did). Lane (query, y-offset) blends
// one column of 9 taps, computing its y-terms once. Coords are read once per
// query, by one lane, and shuffled. A centre that is not finite or whose
// window misses the plane gives zeros, as every corner test failed before.
//
// What bounds them on the card (shapes of the I3D flow stream, one 64-frame
// stack at 256x344: Q = 64 * 32 * 43 = 88,064 queries per GRU iteration):
//   - level: bytes. Each query writes 324 floats (114 MB per call) and reads
//     an 11-float run of each of 11 rows per level, scattered over its own
//     planes. The bytes bound counts only the in-plane cells read (69 MB,
//     chip_smoke.py `window_cells`); a card that fetches whole 32- or
//     64-byte pieces moves more for such runs (tools/level_fetch_model.py
//     models both; no counter has measured which). One launch per call
//     for all four levels (the TPU's four pallas_calls were its block shape,
//     not the function). A warp per 4 queries loads their windows, blends the
//     324 taps into a staging row per query and writes the 4 rows, which are
//     contiguous in the output, as float4 stores of whole 128-byte lines.
//     7 KB of shared memory a warp (28 warps an SM) measured faster than
//     staging all four levels at once or storing the taps directly.
//   - proj: operations. The projection is 2 * Q * 324 * 256 flops (about
//     14.6 GFLOP per iteration) in full float32 FMA (the parity contract pins
//     `highest`: no TF32 on the tensor cores). A block of 256 threads owns 64
//     queries x all 256 channels; each thread an 8 x 8 register tile, so one
//     k step is four 16-byte shared loads for 64 FMAs. W streams through two
//     cp.async stages of 27-row chunks (one barrier a chunk); each block reads
//     W once from L2, so W crosses L2 once per 64 queries. The taps
//     are k-major rows of 64 queries padded to 68 floats (conflict-free for
//     the blend's stores and the tile's loads), double-buffered by level:
//     level l + 1's windows are copied and blended during level l's chunks,
//     so the build interleaves with the FMAs instead of stopping them. 112 KB
//     of dynamic shared memory and at most 128 registers let two blocks share
//     an SM. The 324-channel intermediate never reaches device memory.
//
// vft_corr_lookup_packed replaces `_packed_kernel` (_corr_lookup_packed_flat):
// the same 324 taps, all four levels in one launch, read from the lane-dense
// packed (Q, K_total) plane of pack_pyramid. Level l's row r lives in group
// r / j_l at sub-row r % j_l, so the cell (r, x) of query q is the float at
// q * K_total + off_l + (r / j_l) * k_l + (r % j_l) * w_l + x. The TPU kernel
// selects a row's group with a G-way select-accumulate and the corners with
// one-hot matmuls (Mosaic has no gather). Here a warp stages the windows of
// 4 queries as level does, but in the packed formulation's own geometry and
// rounding, which it must keep to match JAX bit for bit: the origin is
// (ix, iy) = floor(c / 2^l - 4), tap (xx, yy) has its corners at
// (ix + xx + {0, 1}, iy + yy + {0, 1}), so the window is 10x10 cells from
// (ix, iy) (the gather's 11x11 from floor(p) - 4 can sit one cell off), and
// the four weights (1-fx)(1-fy), fx(1-fy), (1-fx)fy, fx fy are computed once
// per query and level and shared by its 81 taps. The address map runs once
// per staged cell, its division by j_l a multiply by the reciprocal; the
// bounds test is on (r, x) against the level's (h_l, w_l), never on the zero
// fill of the phantom rows and the lane tail, and compares floats first. A
// window outside the plane blends zero cells with the query's weights: 0 for
// a finite centre, NaN for a NaN or infinite one, as JAX gives; a 0x0 level
// gives exact zeros. Bound: bytes, as for the level kernel (the same cells
// and output; the packed plane's zero fill is never read). No size gate:
// JAX's G <= 16 and 2 MiB per query limits are the TPU's VMEM envelope.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRadius = 4;
constexpr int kWin = 2 * kRadius + 1;   // 9
constexpr int kTaps = kWin * kWin;      // 81
constexpr int kLevels = 4;
constexpr int kK = kLevels * kTaps;     // 324
constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;

// the window loader
constexpr int kSide = kWin + 2;         // 11 corner rows and columns
constexpr int kCells = kSide * kSide;   // 121
constexpr int kGroup = 4;               // queries a warp stages at once
constexpr int kCellLoads = (kCells + kWarp - 1) / kWarp;  // 4 per lane

// level kernel
constexpr int kLevelWarps = 4;
// staging rows of 328 floats: 16-byte aligned, 4 rows on 4 bank offsets
constexpr int kRowStride = kK + 4;

// packed kernel: its own 10x10 window from floor(c / 2^l - 4)
constexpr int kPackedWarps = 4;
constexpr int kPackedSide = kWin + 1;                     // 10
constexpr int kPackedCells = kPackedSide * kPackedSide;   // 100
constexpr int kPackedLoads = (kPackedCells + kWarp - 1) / kWarp;  // 4
// staged rows of 12 floats, queries 137 floats apart: the blend's reads are
// free of bank conflicts, the loader's stores 2-way
constexpr int kPackedPitch = 12;
constexpr int kPackedStride = 137;

// proj kernel
constexpr int kCout = 256;    // convc1's output channels, the only width taken
constexpr int kTileQ = 64;    // queries per block
// tap rows of 68 floats: float4 loads, conflict-free blend stores
constexpr int kTapStride = kTileQ + 4;
constexpr int kProjWarps = 8;
constexpr int kProjThreads = kProjWarps * kWarp;
constexpr int kWarpQ = kTileQ / kProjWarps;   // 8 queries each warp builds
constexpr int kChunk = 27;    // rows of W per ring stage (81 = 3 x 27)
constexpr int kChunks = kK / kChunk;          // 12
constexpr int kLevelChunks = kTaps / kChunk;  // 3
constexpr int kPacketsPerChunk = kChunk * kCout / 4;  // 1,728 16-byte copies

struct Pyramid {
  const float* data[kLevels];
  int h[kLevels];
  int w[kLevels];
};

// Address map of one unpadded level (Q, h, w): query q's plane and the
// offset of its cell (r, x).
struct PlaneMap {
  const float* data;
  int h, w;
  __device__ __forceinline__ const float* query(int64_t q) const {
    return data + q * (int64_t)h * w;
  }
  __device__ __forceinline__ int offset(int r, int x) const {
    return r * w + x;
  }
};

// Level lvl's map, selected without indexing the kernel parameter by a
// run-time value (which would copy the Pyramid to local memory).
__device__ __forceinline__ PlaneMap level_map(const Pyramid& p, int lvl) {
  PlaneMap m{p.data[0], p.h[0], p.w[0]};
#pragma unroll
  for (int l = 1; l < kLevels; ++l) {
    if (lvl == l) m = PlaneMap{p.data[l], p.h[l], p.w[l]};
  }
  return m;
}

// One query's window at one level: the level's centre p = c / 2^l, the
// origin floor(p) - 4 of the 11x11 cells, and whether any tap can be
// non-zero (a finite centre whose cells meet the plane; NaN fails the test).
struct Window {
  float px, py, bx, by;
  bool live;
};

__device__ __forceinline__ Window window_at(float cx, float cy, float scale,
                                            int h, int w) {
  Window o;
  o.px = cx * scale;
  o.py = cy * scale;
  o.bx = floorf(o.px) - (float)kRadius;
  o.by = floorf(o.py) - (float)kRadius;
  o.live = o.bx > (float)-kSide && o.bx < (float)w && o.by > (float)-kSide &&
           o.by < (float)h;
  return o;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 4 bytes global -> shared, asynchronously; `in` false writes a zero and
// reads nothing (cp.async's ignore-src: `src` is not accessed).
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  asm volatile(
      "{\n .reg .pred skip;\n setp.eq.u32 skip, %2, 0;\n"
      " cp.async.ca.shared.global [%0], [%1], 4, skip;\n}\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"((unsigned)in));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The query whose coords lanes `first`, `first` + 1 hold (lane i holds float
// i of its group's (x, y) pairs), at one level.
__device__ __forceinline__ Window shfl_window(float xy, int first, float scale,
                                              int h, int w) {
  const float cx = __shfl_sync(kFull, xy, first);
  const float cy = __shfl_sync(kFull, xy, first + 1);
  return window_at(cx, cy, scale, h, w);
}

// The window loader's address map: for each of the kGroup queries q0 + g
// (coords in lanes first .. first + 7) and each of this lane's cells
// i = lane + 32 j of its 11x11 window (row by row, consecutive lanes on
// consecutive x), calls cell(g, j, i, src, in) with the cell's address and
// whether it lies in the plane (never for a dead window; `src` is only
// meaningful where `in`). The level kernel loads through registers, the
// proj kernel copies with cp.async.
template <class Cell>
__device__ __forceinline__ void window_cells(const PlaneMap& map, int64_t q0,
                                             float xy, int first, float scale,
                                             int lane, Cell&& cell) {
  int row[kCellLoads], col[kCellLoads];
#pragma unroll
  for (int j = 0; j < kCellLoads; ++j) {
    const int i = lane + j * kWarp;
    row[j] = i / kSide;
    col[j] = i - row[j] * kSide;
  }
#pragma unroll
  for (int g = 0; g < kGroup; ++g) {
    const Window o = shfl_window(xy, first + 2 * g, scale, map.h, map.w);
    const int bx = o.live ? (int)o.bx : 0;
    const int by = o.live ? (int)o.by : 0;
#pragma unroll
    for (int j = 0; j < kCellLoads; ++j) {
      const int i = lane + j * kWarp;
      if (i < kCells) {
        const bool in = o.live && (unsigned)(by + row[j]) < (unsigned)map.h &&
                        (unsigned)(bx + col[j]) < (unsigned)map.w;
        cell(g, j, i,
             map.query(q0 + g) + map.offset(by + row[j], bx + col[j]), in);
      }
    }
  }
}

// The bilinear blend of one tap from its upper-left corner in a staged
// window: corner order and weight products of corr_lookup_gather (a zero
// corner adds exactly nothing, as the skipped out-of-plane corner did).
__device__ __forceinline__ float corners(const float* cell, float wx1,
                                         float wy1) {
  float acc = 0.f;
#pragma unroll
  for (int dx = 0; dx < 2; ++dx) {
    const float wx = dx ? wx1 : 1.f - wx1;
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const float wy = dy ? wy1 : 1.f - wy1;
      acc += wx * wy * cell[dy * kSide + dx];
    }
  }
  return acc;
}

// Tap k (x-offset slowest) of one staged window.
__device__ __forceinline__ float blend(const float* win, const Window& o,
                                       int k) {
  if (!o.live) return 0.f;
  const int xx = k / kWin;
  const int yy = k - xx * kWin;
  const float x = o.px + (float)(xx - kRadius);
  const float y = o.py + (float)(yy - kRadius);
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  return corners(win + (int)(y0 - o.by) * kSide + (int)(x0 - o.bx), x - x0,
                 y - y0);
}

// The 81 taps of the kGroup queries whose windows are staged in
// win[kGroup][121] (coords in lanes first .. first + 7), handed to
// store(g, k, v). Lane (g, yy) = (lane % 4, lane / 4) blends the column
// yy < 8 of query g, its y-terms computed once for the 9 x-offsets (whose
// terms fold to constants); the 36 taps of column yy = 8 follow, one a lane.
template <class Store>
__device__ __forceinline__ void blend_group(const float* win, float xy,
                                            int first, float scale, int h,
                                            int w, int lane, Store&& store) {
  const int g = lane % kGroup;
  const int yy = lane / kGroup;
  const Window o = shfl_window(xy, first + 2 * g, scale, h, w);
  if (o.live) {
    const float y = o.py + (float)(yy - kRadius);
    const float y0 = floorf(y);
    const float* row = win + g * kCells + (int)(y0 - o.by) * kSide;
#pragma unroll
    for (int xx = 0; xx < kWin; ++xx) {
      const float x = o.px + (float)(xx - kRadius);
      const float x0 = floorf(x);
      store(g, xx * kWin + yy,
            corners(row + (int)(x0 - o.bx), x - x0, y - y0));
    }
  } else {
#pragma unroll
    for (int xx = 0; xx < kWin; ++xx) store(g, xx * kWin + yy, 0.f);
  }
  constexpr int kLast = kGroup * kWin;  // taps of the columns yy = 8
#pragma unroll
  for (int j = 0; j < (kLast + kWarp - 1) / kWarp; ++j) {
    const int e = lane + j * kWarp;
    const int eg = (e < kLast ? e : kLast - 1) / kWin;
    // every lane shuffles, the lanes past the 36 taps store nothing
    const Window oe = shfl_window(xy, first + 2 * eg, scale, h, w);
    if (e < kLast) {
      const int k = (e - eg * kWin) * kWin + kWin - 1;
      store(eg, k, blend(win + eg * kCells, oe, k));
    }
  }
}

// The staged taps of a warp's nq <= 4 queries (rows of kRowStride floats),
// which are contiguous in out, as float4 stores of whole 128-byte lines.
__device__ __forceinline__ void store_rows(const float* rows, int64_t q0,
                                           int nq, int lane, float* out) {
  float4* dst = reinterpret_cast<float4*>(out + q0 * kK);
  for (int f = lane; f < nq * (kK / 4); f += kWarp) {
    const int r = f / (kK / 4);
    const int c = f - r * (kK / 4);
    dst[f] = *reinterpret_cast<const float4*>(rows + r * kRowStride + 4 * c);
  }
}

// One group of 4 queries a warp: the group's four windows of a level go
// through registers into shared memory, the 324 taps into a staging row per
// query, and the 4 rows, which are contiguous in out, leave as whole-line
// float4 stores.
__global__ void __launch_bounds__(kLevelWarps * kWarp)
level_kernel(Pyramid pyr, const float* __restrict__ coords, int64_t q_total,
             float* __restrict__ out) {
  __shared__ float win_s[kLevelWarps][kGroup * kCells];
  __shared__ __align__(16) float row_s[kLevelWarps][kGroup * kRowStride];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int64_t q0 = ((int64_t)blockIdx.x * kLevelWarps + warp) * kGroup;
  if (q0 >= q_total) return;  // no block-wide barrier follows
  const int nq = q_total - q0 < kGroup ? (int)(q_total - q0) : kGroup;
  // lane i < 2 * nq holds float i of the group's coords; a missing query's
  // NaN centre gives a dead window
  const float xy = lane < 2 * nq ? coords[2 * q0 + lane] : nanf("");
  float* win = win_s[warp];
  float* rows = row_s[warp];
#pragma unroll
  for (int lvl = 0; lvl < kLevels; ++lvl) {
    const PlaneMap map{pyr.data[lvl], pyr.h[lvl], pyr.w[lvl]};
    const float scale = 1.f / (float)(1 << lvl);
    float v[kGroup][kCellLoads];
    window_cells(map, q0, xy, 0, scale, lane,
                 [&](int g, int j, int, const float* src, bool in) {
                   v[g][j] = in ? __ldg(src) : 0.f;
                 });
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
#pragma unroll
      for (int j = 0; j < kCellLoads; ++j) {
        const int i = lane + j * kWarp;
        if (i < kCells) win[g * kCells + i] = v[g][j];
      }
    }
    __syncwarp();
    blend_group(win, xy, 0, scale, map.h, map.w, lane,
                [&](int g, int k, float t) {
                  rows[g * kRowStride + lvl * kTaps + k] = t;
                });
    __syncwarp();
  }
  store_rows(rows, q0, nq, lane, out);
}

struct ProjSmem {
  float taps[2][kTaps][kTapStride];        // level l's taps and level l + 1's
  float w[2][kChunk * kCout];              // two stages of W chunks
  float win[kProjWarps][kGroup * kCells];  // one query group's windows per warp
};
// dynamic shared memory of a block (ptxas reports only static); two blocks
// fit the 227 KB an SM offers
static_assert(sizeof(ProjSmem) == 114848, "proj_kernel's shared memory");

// Chunk g of W (rows 27g .. 27g + 26, contiguous) into stage g % 2.
__device__ __forceinline__ void fetch_chunk(ProjSmem& s,
                                            const float* __restrict__ weight,
                                            int g) {
  float* dst = s.w[g % 2];
  const float* src = weight + (int64_t)g * kChunk * kCout;
  for (int i = threadIdx.x; i < kPacketsPerChunk; i += kProjThreads) {
    cp_async16(dst + 4 * i, src + 4 * i);
  }
}

__global__ void __launch_bounds__(kProjThreads, 2)
proj_kernel(Pyramid pyr, const float* __restrict__ coords, int64_t q_total,
            const float* __restrict__ weight, const float* __restrict__ bias,
            float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ProjSmem& s = *reinterpret_cast<ProjSmem*>(smem_raw);
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int64_t q_tile = (int64_t)blockIdx.x * kTileQ;

  // tap building: warp `warp` owns tile queries 8 * warp .. 8 * warp + 7,
  // two groups of kGroup; lane i < 16 holds float i of their coords
  const int64_t qw = q_tile + warp * kWarpQ;
  const float xy = lane < 2 * kWarpQ && lane < 2 * (q_total - qw)
                       ? coords[2 * qw + lane]
                       : nanf("");
  float* win = s.win[warp];
  // issue the copies of group grp's windows at level lvl
  auto stage = [&](int lvl, int grp) {
    window_cells(level_map(pyr, lvl), qw + grp * kGroup, xy, 2 * kGroup * grp,
                 1.f / (float)(1 << lvl), lane,
                 [&](int g, int, int i, const float* src, bool in) {
                   cp_async4(win + g * kCells + i, src, in);
                 });
    cp_async_commit();
  };
  // blend group grp's staged windows at level lvl into tap buffer lvl % 2
  auto build = [&](int lvl, int grp) {
    const PlaneMap map = level_map(pyr, lvl);
    float* col = &s.taps[lvl % 2][0][warp * kWarpQ + grp * kGroup];
    blend_group(win, xy, 2 * kGroup * grp, 1.f / (float)(1 << lvl), map.h,
                map.w, lane,
                [&](int g, int k, float t) { col[k * kTapStride + g] = t; });
    __syncwarp();  // the windows are consumed before the next stage
  };

  // projection: thread (qg, cg) owns queries {4qg .. 4qg+3, 32+4qg .. 32+4qg+3}
  // and channels {4cg .. 4cg+3, 128+4cg .. 128+4cg+3}; a warp spans 4 qg x 8 cg
  const int qg = (warp / 4) * 4 + lane / 8;
  const int cg = (warp % 4) * 8 + lane % 8;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  // level 0's taps before the loop; in the loop, level l + 1's are built
  // during level l's chunks (its group 0 staged in chunk 0, blended in
  // chunk 1, group 1 staged then and blended in chunk 2), so the build's
  // latency and issue interleave with the FMAs
  fetch_chunk(s, weight, 0);
  cp_async_commit();
  for (int grp = 0; grp < kWarpQ / kGroup; ++grp) {
    stage(0, grp);
    cp_async_wait_all();
    __syncwarp();
    build(0, grp);
  }
#pragma unroll 1
  for (int g = 0; g < kChunks; ++g) {
    const int lvl = g / kLevelChunks;
    const int c = g - lvl * kLevelChunks;
    cp_async_wait_all();
    // chunk g, level lvl's taps and the staged windows visible to every
    // thread; every thread is done with chunk g - 1 (whose stage the next
    // fetch takes) and, at c == 0, with level lvl - 1's taps (whose buffer
    // level lvl + 1's build takes)
    __syncthreads();
    if (lvl + 1 < kLevels) {
      if (c > 0) build(lvl + 1, c - 1);
      if (c < kWarpQ / kGroup) stage(lvl + 1, c);
    }
    if (g + 1 < kChunks) fetch_chunk(s, weight, g + 1);
    cp_async_commit();
    const float* ws = s.w[g % 2];
    const float* ts = &s.taps[lvl % 2][c * kChunk][0];
#pragma unroll
    for (int r = 0; r < kChunk; ++r) {
      const float4 a0 =
          *reinterpret_cast<const float4*>(ts + r * kTapStride + 4 * qg);
      const float4 a1 =
          *reinterpret_cast<const float4*>(ts + r * kTapStride + 32 + 4 * qg);
      const float4 b0 =
          *reinterpret_cast<const float4*>(ws + r * kCout + 4 * cg);
      const float4 b1 =
          *reinterpret_cast<const float4*>(ws + r * kCout + 128 + 4 * cg);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
  }

  const float4 bias0 = *reinterpret_cast<const float4*>(bias + 4 * cg);
  const float4 bias1 = *reinterpret_cast<const float4*>(bias + 128 + 4 * cg);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t q = q_tile + (i < 4 ? 4 * qg + i : 32 + 4 * qg + i - 4);
    if (q < q_total) {
      float* row = out + q * kCout;
      *reinterpret_cast<float4*>(row + 4 * cg) = make_float4(
          fmaxf(acc[i][0] + bias0.x, 0.f), fmaxf(acc[i][1] + bias0.y, 0.f),
          fmaxf(acc[i][2] + bias0.z, 0.f), fmaxf(acc[i][3] + bias0.w, 0.f));
      *reinterpret_cast<float4*>(row + 128 + 4 * cg) = make_float4(
          fmaxf(acc[i][4] + bias1.x, 0.f), fmaxf(acc[i][5] + bias1.y, 0.f),
          fmaxf(acc[i][6] + bias1.z, 0.f), fmaxf(acc[i][7] + bias1.w, 0.f));
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

// One query's window at one level in the packed formulation (JAX
// _packed_kernel, corr_lookup_packed_ref), rounded op by op as there:
// origin (ix, iy) = floor(c / 2^l - 4), the four weights every tap shares,
// and whether the 10x10 cells from the origin meet the plane. The test
// compares floats, so a far-away centre never reaches an integer conversion;
// NaN and inf fail it (and make the weights NaN).
struct PackedWindow {
  float ix, iy, w00, w10, w01, w11;
  bool live;
};

__device__ __forceinline__ PackedWindow packed_window(float cx, float cy,
                                                      float scale,
                                                      const PackedLevel& m) {
  PackedWindow o;
  const float px0 = __fsub_rn(__fmul_rn(cx, scale), (float)kRadius);
  const float py0 = __fsub_rn(__fmul_rn(cy, scale), (float)kRadius);
  o.ix = floorf(px0);
  o.iy = floorf(py0);
  const float fx = __fsub_rn(px0, o.ix);
  const float fy = __fsub_rn(py0, o.iy);
  const float gx = __fsub_rn(1.f, fx);
  const float gy = __fsub_rn(1.f, fy);
  o.w00 = __fmul_rn(gx, gy);
  o.w10 = __fmul_rn(fx, gy);
  o.w01 = __fmul_rn(gx, fy);
  o.w11 = __fmul_rn(fx, fy);
  o.live = o.ix > (float)-kPackedSide && o.ix < (float)m.w &&
           o.iy > (float)-kPackedSide && o.iy < (float)m.h;
  return o;
}

// The window of the query whose coords lanes `first`, `first` + 1 hold.
__device__ __forceinline__ PackedWindow shfl_packed_window(
    float xy, int first, float scale, const PackedLevel& m) {
  const float cx = __shfl_sync(kFull, xy, first);
  const float cy = __shfl_sync(kFull, xy, first + 1);
  return packed_window(cx, cy, scale, m);
}

// Tap (xx, yy) from its corner c = cell (yy, xx) of a staged window: the
// blend of JAX _packed_kernel in its order, rounded op by op (no FMA
// contraction), like the plain version. A zero cell outside the plane gives
// what the plain version's zero corner gives (0, or NaN with NaN weights).
__device__ __forceinline__ float packed_tap(const float* c,
                                            const PackedWindow& o) {
  float v = __fmul_rn(o.w00, c[0]);
  v = __fadd_rn(v, __fmul_rn(o.w10, c[1]));
  v = __fadd_rn(v, __fmul_rn(o.w01, c[kPackedPitch]));
  return __fadd_rn(v, __fmul_rn(o.w11, c[kPackedPitch + 1]));
}

// One group of 4 queries a warp, level by level: the 4 windows of 10x10
// cells go through registers into shared memory (row r of query q at
// q * K_total + off + (r / j) * k + (r % j) * w, the division by j a
// multiply by its float reciprocal, exact for r < 2^22), the 324 taps into a
// staging row per query, and the 4 rows, which are contiguous in out, leave
// as whole-line float4 stores.
__global__ void __launch_bounds__(kPackedWarps * kWarp)
packed_kernel(const float* __restrict__ packed, int64_t k_total,
              const float* __restrict__ coords, int64_t q_total,
              PackedGeometry geo, float* __restrict__ out) {
  __shared__ float win_s[kPackedWarps][kGroup * kPackedStride];
  __shared__ __align__(16) float row_s[kPackedWarps][kGroup * kRowStride];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int64_t q0 = ((int64_t)blockIdx.x * kPackedWarps + warp) * kGroup;
  if (q0 >= q_total) return;  // no block-wide barrier follows
  const int nq = q_total - q0 < kGroup ? (int)(q_total - q0) : kGroup;
  // lane i < 2 * nq holds float i of the group's coords; a missing query's
  // NaN centre gives a dead window (its taps are never stored)
  const float xy = lane < 2 * nq ? coords[2 * q0 + lane] : nanf("");
  float* win = win_s[warp];
  float* rows = row_s[warp];
  // this lane's cells i = lane + 32 c of a window, row by row, consecutive
  // lanes on consecutive x
  int crow[kPackedLoads], ccol[kPackedLoads];
#pragma unroll
  for (int c = 0; c < kPackedLoads; ++c) {
    const int i = lane + c * kWarp;
    crow[c] = i / kPackedSide;
    ccol[c] = i - crow[c] * kPackedSide;
  }
  // the blend: lane (g, yy) = (lane % 4, lane / 4) takes the column yy < 8
  // of query g; the 36 taps of the columns yy = 8 follow, one a lane
  const int bg = lane % kGroup;
  const int byy = lane / kGroup;
  constexpr int kLast = kGroup * kWin;
#pragma unroll
  for (int l = 0; l < kLevels; ++l) {
    const PackedLevel m = geo.lvl[l];  // static index: no local-memory copy
    float* taps = rows + l * kTaps;
    if (m.h == 0) {  // a 0x0 level: exact zeros, whatever the coords
      for (int f = lane; f < kGroup * kTaps; f += kWarp) {
        const int g = f / kTaps;
        taps[g * kRowStride + f - g * kTaps] = 0.f;
      }
      continue;
    }
    const float scale = 1.f / (float)(1 << l);
    const float inv_j = 1.f / (float)m.j;
    float v[kGroup][kPackedLoads];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const PackedWindow o = shfl_packed_window(xy, 2 * g, scale, m);
      const int ix = o.live ? (int)o.ix : 0;
      const int iy = o.live ? (int)o.iy : 0;
      const float* src = packed + (q0 + g) * k_total + m.off;
#pragma unroll
      for (int c = 0; c < kPackedLoads; ++c) {
        const int r = iy + crow[c];
        const int x = ix + ccol[c];
        v[g][c] = 0.f;
        if (o.live && lane + c * kWarp < kPackedCells &&
            (unsigned)r < (unsigned)m.h && (unsigned)x < (unsigned)m.w) {
          const int grp = (int)(((float)r + 0.5f) * inv_j);
          v[g][c] = __ldg(src + grp * m.k + (r - grp * m.j) * m.w + x);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
#pragma unroll
      for (int c = 0; c < kPackedLoads; ++c) {
        if (lane + c * kWarp < kPackedCells) {
          win[g * kPackedStride + crow[c] * kPackedPitch + ccol[c]] = v[g][c];
        }
      }
    }
    __syncwarp();
    {
      const PackedWindow o = shfl_packed_window(xy, 2 * bg, scale, m);
      const float* cell = win + bg * kPackedStride + byy * kPackedPitch;
#pragma unroll
      for (int xx = 0; xx < kWin; ++xx) {
        taps[bg * kRowStride + xx * kWin + byy] = packed_tap(cell + xx, o);
      }
    }
#pragma unroll
    for (int c = 0; c < (kLast + kWarp - 1) / kWarp; ++c) {
      const int e = lane + c * kWarp;
      const int eg = (e < kLast ? e : kLast - 1) / kWin;
      // every lane shuffles, the lanes past the 36 taps store nothing
      const PackedWindow o = shfl_packed_window(xy, 2 * eg, scale, m);
      if (e < kLast) {
        const int xx = e - eg * kWin;
        taps[eg * kRowStride + xx * kWin + kWin - 1] = packed_tap(
            win + eg * kPackedStride + (kWin - 1) * kPackedPitch + xx, o);
      }
    }
    __syncwarp();  // the window is consumed before the next level's
  }
  __syncwarp();  // every lane's taps are in the rows
  store_rows(rows, q0, nq, lane, out);
}

}  // namespace

extern "C" {

// All four levels: level l (Q, h[l], w[l]) f32, coords (Q, 2) f32 level-0
// (x, y); writes out (Q, 324), level l's 81 taps at columns 81 l ...
// Returns the cudaError_t of the launch.
int vft_corr_lookup_level(const float* l0, int h0, int w0, const float* l1,
                          int h1, int w1, const float* l2, int h2, int w2,
                          const float* l3, int h3, int w3, const float* coords,
                          int64_t q_total, float* out, cudaStream_t stream) {
  if (q_total == 0) return (int)cudaSuccess;
  Pyramid pyr{{l0, l1, l2, l3}, {h0, h1, h2, h3}, {w0, w1, w2, w3}};
  const int64_t per_block = (int64_t)kLevelWarps * kGroup;
  const int64_t blocks = (q_total + per_block - 1) / per_block;
  level_kernel<<<(unsigned)blocks, kLevelWarps * kWarp, 0, stream>>>(
      pyr, coords, q_total, out);
  return (int)cudaGetLastError();
}

// All four levels + convc1: level l (Q, h[l], w[l]) f32, coords (Q, 2) f32,
// weight (324, 256) f32 in the lookup's channel order, bias (256,) f32, both
// 16-byte aligned; writes out (Q, 256) = relu(lookup @ weight + bias).
int vft_corr_lookup_proj(const float* l0, int h0, int w0, const float* l1,
                         int h1, int w1, const float* l2, int h2, int w2,
                         const float* l3, int h3, int w3, const float* coords,
                         int64_t q_total, const float* weight,
                         const float* bias, float* out, cudaStream_t stream) {
  if (q_total == 0) return (int)cudaSuccess;
  // above 48 KB of shared memory only after opting in (per device)
  const cudaError_t err = cudaFuncSetAttribute(
      proj_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sizeof(ProjSmem));
  if (err != cudaSuccess) return (int)err;
  Pyramid pyr{{l0, l1, l2, l3}, {h0, h1, h2, h3}, {w0, w1, w2, w3}};
  const int64_t blocks = (q_total + kTileQ - 1) / kTileQ;
  proj_kernel<<<(unsigned)blocks, kProjThreads, sizeof(ProjSmem), stream>>>(
      pyr, coords, q_total, weight, bias, out);
  return (int)cudaGetLastError();
}

// All four levels from the packed plane: packed (Q, k_total) f32, coords
// (Q, 2) f32 level-0 (x, y), geometry = 4 x (h, w, j, k, off) host ints
// (h == 0 for a 0x0 level); writes out (Q, 324), 16-byte aligned.
int vft_corr_lookup_packed(const float* packed, int64_t k_total,
                           const float* coords, int64_t q_total,
                           const int* geometry, float* out,
                           cudaStream_t stream) {
  if (q_total == 0) return (int)cudaSuccess;
  PackedGeometry geo;
  for (int l = 0; l < kLevels; ++l) {
    const int* g = geometry + 5 * l;
    geo.lvl[l] = PackedLevel{g[0], g[1], g[2], g[3], g[4]};
  }
  const int64_t per_block = (int64_t)kPackedWarps * kGroup;
  const int64_t blocks = (q_total + per_block - 1) / per_block;
  packed_kernel<<<(unsigned)blocks, kPackedWarps * kWarp, 0, stream>>>(
      packed, k_total, coords, q_total, geo, out);
  return (int)cudaGetLastError();
}

const char* vft_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
