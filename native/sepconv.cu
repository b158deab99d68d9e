// Fused separable convolution for NVIDIA Hopper (sm_90a), called from JAX
// through the XLA FFI (reforge_tpu/kernels/cuda_sepconv.py builds and
// registers it).
//
// out[p, y, x] = sum_i sum_j wh[i] * ww[j] * in[p, y + i - rh, x + j - rw]
// with clamp-to-edge or zero addressing outside the image, computed as an
// H pass (along rows) followed by a W pass (along columns), exactly as the
// plain path ops.conv1d(conv1d(x, wh, H), ww, W) does.
//
// One block walks over (plane, 32x64 output tile) work items.  For each it
// copies the tile plus its rh/rw halo from device memory into shared memory
// with cp.async (border addressing is applied to the source address, so no
// padded copy of the frame ever exists), runs the H pass into a shared f32
// intermediate, runs the W pass from shared memory into registers, stages
// the output tile in shared memory and writes it row by row.  The copies
// of the next two work items are in flight while the current one computes
// (a ring of three input tiles, cp.async groups).  Sums are f32 whatever
// the storage type.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <map>
#include <mutex>
#include <utility>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kTileH = 32;  // output rows per tile: one W-pass lane per row
constexpr int kTileW = 64;  // output columns per tile
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerThread = 8;                // H-pass register block
constexpr int kColsPerThread = kTileW / kWarps;  // W-pass register block
// Shared memory one block may opt in to on sm_90.
constexpr int kSmemBudget = 232448;

static_assert(kTileH == 32, "the W pass maps one lane to each tile row");
static_assert(kTileH % kRowsPerThread == 0, "H-pass row groups");

constexpr int kStages = 3;  // input tiles in flight per block

struct Geometry {
  int height, width, rh, rw;
  int in_h, in_w;      // input tile incl. halo; kSpare rows follow it
  int in_stride;       // shared row stride of the input tile (elements)
  int shift;           // shared column of the tile's first halo column
  int tmp_stride;      // shared row stride of the f32 intermediate (odd)
  int tiles_x, tiles_per_plane, tiles;
  int zero;            // 1: zero outside the image, 0: clamp to edge
};

// Spare rows (columns) after the input tile (intermediate) that let the
// tap windows read past the last tap without a branch.
constexpr int kSpare = 8;
static_assert(kSpare >= kRowsPerThread && kSpare >= kColsPerThread, "spare");

__host__ __device__ inline int buffer_elems(const Geometry& g) {
  return (g.in_h + kSpare) * g.in_stride;
}

// Taps of radius r zero-padded to a multiple of the register block (8).
__host__ __device__ inline int padded_taps(int r) { return (2 * r + 8) & ~7; }

__host__ __device__ inline size_t align16(size_t n) {
  return (n + 15) & ~size_t(15);
}

// Shared layout: taps (wh then ww), the f32 intermediate, kStages input
// tiles.
__host__ __device__ inline size_t taps_bytes(const Geometry& g) {
  return align16(size_t(padded_taps(g.rh) + padded_taps(g.rw)) *
                 sizeof(float));
}

__host__ __device__ inline size_t tmp_bytes(const Geometry& g) {
  return align16(size_t(kTileH) * g.tmp_stride * sizeof(float));
}

__host__ inline size_t smem_bytes(const Geometry& g, size_t itemsize) {
  return taps_bytes(g) + tmp_bytes(g) +
         kStages * size_t(buffer_elems(g)) * itemsize;
}

// 16-byte asynchronous copy; valid == false fills the 16 bytes with zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most the newest kStages - 1 groups are still in flight.
__device__ __forceinline__ void cp_async_wait_oldest() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Source row for tile row r, or -1 when it lies outside the image in zero mode.
__device__ __forceinline__ int source_row(const Geometry& g, int gy) {
  if (g.zero) return (gy >= 0 && gy < g.height) ? gy : -1;
  return min(max(gy, 0), g.height - 1);
}

__device__ __forceinline__ void decode(const Geometry& g, int tile, int& p,
                                       int& y0, int& x0) {
  p = tile / g.tiles_per_plane;
  int t = tile - p * g.tiles_per_plane;
  int ty = t / g.tiles_x;
  y0 = ty * kTileH;
  x0 = (t - ty * g.tiles_x) * kTileW;
}

// Copies the halo-extended input tile in 16-byte vectors.  Shared column j
// holds global column gxa + j, where gxa rounds the first halo column down
// to a vector boundary (g.shift = first halo column - gxa), so vectors are
// aligned on both sides.  Vectors that cross the image border, or rows of
// a width that is not a multiple of the vector, are written element by
// element with the border rule applied.
template <typename T>
__device__ void load_tile(const T* x, T* buf, const Geometry& g, int tile) {
  constexpr int kVec = 16 / sizeof(T);
  int p, y0, x0;
  decode(g, tile, p, y0, x0);
  const T* plane = x + size_t(p) * g.height * g.width;
  const int gxa = x0 - g.rw - g.shift;
  const int vecs = (g.in_w + g.shift + kVec - 1) / kVec;
  const bool aligned_rows = g.width % kVec == 0;
  int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < g.in_h; r += kWarps) {
    int gy = source_row(g, y0 - g.rh + r);
    T* dst = buf + r * g.in_stride;
    const T* row = plane + size_t(gy < 0 ? 0 : gy) * g.width;
    for (int q = lane; q < vecs; q += 32) {
      int gx = gxa + q * kVec;
      if (gy < 0) {
        cp_async16(dst + q * kVec, plane, false);
      } else if (aligned_rows && gx >= 0 && gx + kVec <= g.width) {
        cp_async16(dst + q * kVec, row + gx, true);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          int c = gx + e;
          T v;
          if (g.zero) {
            v = (c >= 0 && c < g.width) ? row[c] : from_f32<T>(0.f);
          } else {
            v = row[min(max(c, 0), g.width - 1)];
          }
          dst[q * kVec + e] = v;
        }
      }
    }
  }
}

// acc[o] = sum_k w[k] * src[(o + k) * stride] for o < N, k < kpad.  The
// taps are zero-padded to kpad, a multiple of N, and consumed N at a time
// from two register windows: each shared load feeds N FMAs and no register
// is shifted.  Sums run in ascending k, like the plain path.
template <int N, typename T>
__device__ __forceinline__ void window_sum(const T* src, int stride,
                                           const float* w, int kpad,
                                           float (&acc)[N]) {
  static_assert(N % 4 == 0, "taps are read as float4");
  float cur[N], nxt[N];
#pragma unroll
  for (int o = 0; o < N; ++o) {
    cur[o] = to_f32(src[o * stride]);
    acc[o] = 0.f;
  }
  for (int k0 = 0; k0 < kpad; k0 += N) {
#pragma unroll
    for (int o = 0; o < N; ++o) nxt[o] = to_f32(src[(k0 + N + o) * stride]);
    float wk[N];
#pragma unroll
    for (int j = 0; j < N; j += 4) {
      float4 q = *reinterpret_cast<const float4*>(w + k0 + j);
      wk[j] = q.x;
      wk[j + 1] = q.y;
      wk[j + 2] = q.z;
      wk[j + 3] = q.w;
    }
#pragma unroll
    for (int j = 0; j < N; ++j) {
#pragma unroll
      for (int o = 0; o < N; ++o)
        acc[o] = fmaf(wk[j], o + j < N ? cur[o + j] : nxt[o + j - N], acc[o]);
    }
#pragma unroll
    for (int o = 0; o < N; ++o) cur[o] = nxt[o];
  }
}

// H pass: tmp[r][c] = sum_k wh[k] * in[r + k][c] for the tile's rows and
// every column of the halo-extended tile.  Lanes take consecutive columns,
// each thread kRowsPerThread rows.
template <typename T>
__device__ void h_pass(const T* buf, float* tmp, const Geometry& g,
                       const float* wh) {
  constexpr int R = kRowsPerThread;
  const int groups = kTileH / R;
  const int chunks = (g.in_w + 31) / 32;
  const int khp = padded_taps(g.rh);
  int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int item = warp; item < groups * chunks; item += kWarps) {
    int grp = item % groups;
    int c = (item / groups) * 32 + lane;
    if (c >= g.in_w) continue;
    float acc[R];
    window_sum(buf + grp * R * g.in_stride + c + g.shift, g.in_stride, wh,
               khp, acc);
    float* out = tmp + grp * R * g.tmp_stride + c;
#pragma unroll
    for (int o = 0; o < R; ++o) out[o * g.tmp_stride] = acc[o];
  }
}

// The output tile is staged in shared memory as 32-bit words (one f32 or
// two bf16) with an odd row stride, then written row by row.
template <typename T>
struct Stage {
  static constexpr int kElems = 4 / sizeof(T);        // elements per word
  static constexpr int kRowWords = kTileW / kElems;   // a power of two
  static constexpr int kStride = kRowWords + 1;
  // The staged tile reuses an input slot, which holds at least
  // kTileH + kSpare rows of kTileW elements.
  static_assert((kTileH + kSpare) * kTileW * sizeof(T) >=
                    kTileH * kStride * sizeof(uint32_t),
                "staged output tile fits an input slot");
};

__device__ __forceinline__ uint32_t pack_word(const float* v, float) {
  return __float_as_uint(v[0]);
}
__device__ __forceinline__ uint32_t pack_word(const float* v, __nv_bfloat16) {
  return uint32_t(__bfloat16_as_ushort(__float2bfloat16_rn(v[0]))) |
         (uint32_t(__bfloat16_as_ushort(__float2bfloat16_rn(v[1]))) << 16);
}

// W pass: lane l takes tile row l (the odd tmp stride keeps the 32 rows in
// 32 banks), warp w takes kColsPerThread consecutive output columns, and
// the results go to the staging words.
template <typename T>
__device__ void w_pass(const float* tmp, uint32_t* stage, const Geometry& g,
                       const float* ww) {
  constexpr int U = kColsPerThread;
  constexpr int E = Stage<T>::kElems;
  int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float acc[U];
  window_sum(tmp + lane * g.tmp_stride + warp * U, 1, ww, padded_taps(g.rw),
             acc);
  uint32_t* dst = stage + lane * Stage<T>::kStride + warp * (U / E);
#pragma unroll
  for (int v = 0; v < U / E; ++v) dst[v] = pack_word(acc + v * E, T());
}

// Coalesced copy of the staged tile to device memory: a warp writes 128
// contiguous bytes per instruction.
template <typename T>
__device__ void store_tile(const uint32_t* stage, T* y, const Geometry& g,
                           int tile) {
  using S = Stage<T>;
  int p, y0, x0;
  decode(g, tile, p, y0, x0);
  T* plane = y + size_t(p) * g.height * g.width;
  const bool whole_words = x0 + kTileW <= g.width && g.width % S::kElems == 0;
  for (int i = threadIdx.x; i < kTileH * S::kRowWords; i += kThreads) {
    int r = i / S::kRowWords, w = i % S::kRowWords;
    int gy = y0 + r;
    if (gy >= g.height) break;  // later i are in later rows
    uint32_t word = stage[r * S::kStride + w];
    T* row = plane + size_t(gy) * g.width + x0;
    if (whole_words) {
      reinterpret_cast<uint32_t*>(row)[w] = word;
    } else {
      const T* elems = reinterpret_cast<const T*>(&word);
#pragma unroll
      for (int e = 0; e < S::kElems; ++e)
        if (x0 + w * S::kElems + e < g.width) row[w * S::kElems + e] = elems[e];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    sepconv_kernel(const T* __restrict__ x, const float* __restrict__ wh,
                   const float* __restrict__ ww, T* __restrict__ y,
                   Geometry g) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* taps = reinterpret_cast<float*>(smem);
  float* tmp = reinterpret_cast<float*>(smem + taps_bytes(g));
  T* bufs = reinterpret_cast<T*>(smem + taps_bytes(g) + tmp_bytes(g));
  const int kh = 2 * g.rh + 1, kw = 2 * g.rw + 1;
  const int khp = padded_taps(g.rh), kwp = padded_taps(g.rw);
  for (int i = threadIdx.x; i < khp + kwp; i += kThreads) {
    float v = 0.f;
    if (i < kh) v = wh[i];
    else if (i >= khp && i - khp < kw) v = ww[i - khp];
    taps[i] = v;
  }
  // The spare rows and columns meet only zero taps; zero them so that no
  // stale NaN reaches a sum.
  for (int s = 0; s < kStages; ++s) {
    T* spare = bufs + s * buffer_elems(g) + g.in_h * g.in_stride;
    for (int i = threadIdx.x; i < kSpare * g.in_stride; i += kThreads)
      spare[i] = from_f32<T>(0.f);
  }
  for (int i = threadIdx.x; i < kTileH * (g.tmp_stride - g.in_w);
       i += kThreads) {
    int r = i / (g.tmp_stride - g.in_w);
    tmp[r * g.tmp_stride + g.in_w + i % (g.tmp_stride - g.in_w)] = 0.f;
  }
  // All of the above is visible after the first barrier below.

  // Ring of kStages input tiles: tile i lives in slot i % kStages, and the
  // copies of the next kStages - 1 tiles are in flight while tile i
  // computes.  Every step commits one group (empty past the end), so
  // waiting for all but the newest kStages - 1 groups waits for tile i.
  const int first = blockIdx.x;
  for (int s = 0; s < kStages - 1; ++s) {
    int t = first + s * gridDim.x;
    if (t < g.tiles) load_tile(x, bufs + s * buffer_elems(g), g, t);
    cp_async_commit();
  }
  int slot = 0;
  for (int tile = first; tile < g.tiles; tile += gridDim.x) {
    int ahead = tile + (kStages - 1) * gridDim.x;
    int ahead_slot = (slot + kStages - 1) % kStages;
    if (ahead < g.tiles)
      load_tile(x, bufs + ahead_slot * buffer_elems(g), g, ahead);
    cp_async_commit();
    cp_async_wait_oldest();
    __syncthreads();
    T* in = bufs + slot * buffer_elems(g);
    h_pass(in, tmp, g, taps);
    __syncthreads();
    // The input tile is dead now; its slot stages the output tile.
    uint32_t* stage = reinterpret_cast<uint32_t*>(in);
    w_pass<T>(tmp, stage, g, taps + khp);
    __syncthreads();
    store_tile(stage, y, g, tile);
    __syncthreads();  // this slot and tmp are rewritten by later steps
    slot = (slot + 1) % kStages;
  }
}

// Blocks of sepconv_kernel<T> that fit on the current device at once, for
// this much shared memory.  The attribute calls and occupancy query cost
// more than the launch itself, so the answer is kept per (device, bytes).
template <typename T>
cudaError_t ResidentBlocks(size_t smem, int* blocks) {
  static std::mutex mu;
  static std::map<std::pair<int, size_t>, int> known;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  auto it = known.find({device, smem});
  if (it != known.end()) {
    *blocks = it->second;
    return cudaSuccess;
  }
  auto kernel = sepconv_kernel<T>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBudget);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  int sms = 0, per_sm = 0;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  if (err != cudaSuccess) return err;
  *blocks = std::max(1, sms * per_sm);
  known[{device, smem}] = *blocks;
  return cudaSuccess;
}

template <typename T>
ffi::Error Launch(cudaStream_t stream, const void* x, const float* wh,
                  size_t kh, const float* ww, size_t kw, void* y,
                  ffi::Span<const int64_t> dims, int32_t zero) {
  if (dims.size() < 2)
    return ffi::Error(ffi::ErrorCode::kInvalidArgument,
                      "sepconv needs (..., H, W) input");
  if (kh % 2 == 0 || kw % 2 == 0)
    return ffi::Error(ffi::ErrorCode::kInvalidArgument,
                      "sepconv tap counts must be odd");
  int64_t planes = 1;
  for (size_t i = 0; i + 2 < dims.size(); ++i) planes *= dims[i];
  Geometry g;
  g.height = static_cast<int>(dims[dims.size() - 2]);
  g.width = static_cast<int>(dims[dims.size() - 1]);
  if (planes == 0 || g.height == 0 || g.width == 0) return ffi::Error::Success();
  g.rh = static_cast<int>(kh / 2);
  g.rw = static_cast<int>(kw / 2);
  g.in_h = kTileH + 2 * g.rh;
  g.in_w = kTileW + 2 * g.rw;
  const int vec = 16 / sizeof(T);
  g.shift = (vec - g.rw % vec) % vec;  // tiles start at multiples of 64
  g.in_stride = (g.in_w + g.shift + vec - 1) / vec * vec;
  g.tmp_stride = (g.in_w + kSpare) | 1;
  g.tiles_x = (g.width + kTileW - 1) / kTileW;
  g.tiles_per_plane = g.tiles_x * ((g.height + kTileH - 1) / kTileH);
  int64_t tiles = planes * g.tiles_per_plane;
  if (tiles > INT32_MAX)
    return ffi::Error(ffi::ErrorCode::kInvalidArgument, "sepconv: too many tiles");
  g.tiles = static_cast<int>(tiles);
  g.zero = zero != 0;
  size_t smem = smem_bytes(g, sizeof(T));
  if (smem > size_t(kSmemBudget))
    return ffi::Error(ffi::ErrorCode::kInvalidArgument,
                      "sepconv radius exceeds the shared-memory budget");
  int blocks = 0;
  cudaError_t err = ResidentBlocks<T>(smem, &blocks);
  if (err != cudaSuccess)
    return ffi::Error(ffi::ErrorCode::kInternal, cudaGetErrorString(err));
  int grid = std::min(g.tiles, blocks);
  auto kernel = sepconv_kernel<T>;
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(x), wh, ww,
                                           static_cast<T*>(y), g);
  err = cudaGetLastError();
  if (err != cudaSuccess)
    return ffi::Error(ffi::ErrorCode::kInternal, cudaGetErrorString(err));
  return ffi::Error::Success();
}

// The taps arrive as f32 device buffers; under vmap they may carry leading
// size-1 dims, so only their element counts matter.
ffi::Error SepConvF32(cudaStream_t stream, ffi::Buffer<ffi::F32> x,
                      ffi::Buffer<ffi::F32> wh, ffi::Buffer<ffi::F32> ww,
                      ffi::ResultBuffer<ffi::F32> y, int32_t zero) {
  return Launch<float>(stream, x.untyped_data(), wh.typed_data(),
                       wh.element_count(), ww.typed_data(), ww.element_count(),
                       y->untyped_data(), x.dimensions(), zero);
}

ffi::Error SepConvBF16(cudaStream_t stream, ffi::Buffer<ffi::BF16> x,
                       ffi::Buffer<ffi::F32> wh, ffi::Buffer<ffi::F32> ww,
                       ffi::ResultBuffer<ffi::BF16> y, int32_t zero) {
  return Launch<__nv_bfloat16>(stream, x.untyped_data(), wh.typed_data(),
                               wh.element_count(), ww.typed_data(),
                               ww.element_count(), y->untyped_data(),
                               x.dimensions(), zero);
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(ReforgeSepConvF32, SepConvF32,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::F32>>()
                                  .Attr<int32_t>("zero"));

XLA_FFI_DEFINE_HANDLER_SYMBOL(ReforgeSepConvBF16, SepConvBF16,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::BF16>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::BF16>>()
                                  .Attr<int32_t>("zero"));

