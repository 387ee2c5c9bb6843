// The wavefront strip kernel for Hopper (sm_90a), called from JAX through
// the XLA foreign function interface (masa_tpu/ops/cuda_strip.py).
//
// One call computes one strip of R rows of the affine-gap DP (Gotoh) over
// nj columns, with exactly the arithmetic of the lax.scan twin
// (ops/wavefront.strip_scan), so the two agree bit for bit:
//
//   E = max(H_left - go, E_left) - ge
//   F = max(H_up - go, F_up) - ge
//   H = max(H_diag + sub, E, F)            [max 0 for Smith-Waterman]
//
// Geometry (the CUDAlign design, src/CUDAligner.cu:638-1007): a warp owns
// a band of 32 * kAlpha consecutive rows, each thread kAlpha of them, and
// walks the band left to right along its own anti-diagonals (thread l
// computes column t - l at step t).  Inside a warp the row above a thread's
// first row arrives by __shfl_up_sync; between bands it travels through the
// (H, F) bus in global memory, which the kernel updates IN PLACE: band b
// reads column j of the bus (band b-1's bottom row) before it writes its own
// bottom row there.  Bands are pipelined along the columns: band b may read
// a 32-column group only after band b-1 published (release store) that it
// wrote those columns.  Blocks take their bands from a ticket counter, so a
// band only ever waits on a band that is already running: no deadlock,
// whatever the order the hardware starts blocks in.
//
// Everything that varies per call is call data in `scal` (corner, width,
// true height, flush cadence); only the template variant (SW/NW, best
// tracking, last column) is compiled.
//
// Outputs (row-major, row r = strip row r):
//   bus_h/bus_f [P]   : row h_true-1 at columns 0..nj-1 (aliases the input)
//   best_v/best_j [R] : per-row maximum and its (smallest) column; NEG for
//                       rows >= h_true  (TRACK 1: values only)
//   lc_h/lc_e [R]     : H/E at column nj-1
//   rows_h/rows_f     : [n_int, P] interior rows (q+1)*flush-1 (full strips)
//   sync              : [1 + nbands] ticket counter and per-band progress

#include <cstdint>
#include <string>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kWarp = 32;
constexpr int kAlpha = 8;                  // rows per thread
constexpr int kBand = kWarp * kAlpha;      // rows per warp band
constexpr int kWarpsPerBlock = 4;
constexpr int32_t kNeg = -999999999;       // masa_tpu.types.INF
constexpr int32_t kASentinel = -2;         // padded strip rows
constexpr int32_t kBSentinel = -1;         // padded columns
constexpr unsigned kFull = 0xffffffffu;

enum { kCorner = 0, kWidth, kHeight, kFlush, kScalars };

struct Scores {
  int32_t match, mismatch, go, ge;
};

__device__ __forceinline__ int ld_acquire(const int32_t* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int32_t* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

template <bool SW>
__device__ __forceinline__ int32_t cell_h(int32_t diag, int32_t e,
                                          int32_t f) {
  // DPX: max of three (and zero for Smith-Waterman) in one instruction
  if (SW) return __vimax3_s32_relu(diag, e, f);
  return __vimax3_s32(diag, e, f);
}

// Per-thread state of one band walk.
struct Lane {
  int32_t ak[kAlpha];   // strip chars of the thread's rows
  int32_t h[kAlpha];    // H at (row, previous column)
  int32_t e[kAlpha];    // E at (row, previous column)
  int32_t bv[kAlpha];   // per-row best value
  int32_t bj[kAlpha];   // per-row best column
  int32_t out_h;        // bottom row H of the last step (sent down)
  int32_t out_f;        // bottom row F of the last step
  int32_t up_prev;      // H(row0-1, j-1): the diagonal of sub-row 0
  int32_t bc;           // column char of the current column
};

// One anti-diagonal step.  EDGE steps mask columns outside [0, nj) and
// load the column border at j == -1; fast steps know every column is
// interior.  ANYROW (the last band only) also captures (H, F) of sub-row
// `wk` for the bus writer; other bands send their bottom row, which is
// (out_h, out_f) after the step.
template <bool SW, int TRACK, bool EDGE, bool ANYROW>
__device__ __forceinline__ void step(
    Lane& s, int lane, int t, int32_t in_h, int32_t in_f, int32_t in_b,
    int nj, int row0, int R, const int32_t* __restrict__ init_h,
    const int32_t* __restrict__ init_e, const Scores& sc, int wk,
    int32_t& wr_h, int32_t& wr_f) {
  int32_t uh = __shfl_up_sync(kFull, s.out_h, 1);
  int32_t uf = __shfl_up_sync(kFull, s.out_f, 1);
  int32_t bc = __shfl_up_sync(kFull, s.bc, 1);
  if (lane == 0) {
    uh = in_h;
    uf = in_f;
    bc = in_b;
  }
  s.bc = bc;
  const int j = t - lane;
  int32_t diag = s.up_prev;
  s.up_prev = uh;
  int32_t up = uh, upf = uf;
#pragma unroll
  for (int k = 0; k < kAlpha; ++k) {
    const int32_t hl = s.h[k];
    const int32_t e = __viaddmax_s32(hl, -sc.go, s.e[k]) - sc.ge;
    const int32_t f = __viaddmax_s32(up, -sc.go, upf) - sc.ge;
    const int32_t sub = (s.ak[k] == bc) ? sc.match : sc.mismatch;
    int32_t h = cell_h<SW>(diag + sub, e, f);
    int32_t en = e;
    if (EDGE && j == -1) {
      const bool in = row0 + k < R;
      h = in ? init_h[row0 + k] : kNeg;
      en = in ? init_e[row0 + k] : kNeg;
    }
    s.h[k] = h;
    s.e[k] = en;
    if (TRACK) {
      const bool ok = !EDGE || (j >= 0 && j < nj);
      if (ok && h > s.bv[k]) {
        s.bv[k] = h;
        if (TRACK == 2) s.bj[k] = j;
      }
    }
    if (ANYROW && k == wk) {
      wr_h = h;
      wr_f = f;
    }
    diag = hl;
    up = h;
    upf = f;
  }
  s.out_h = up;
  s.out_f = upf;
  if (!ANYROW) {
    wr_h = up;
    wr_f = upf;
  }
}

// The 32 steps of one column group.
template <bool SW, int TRACK, bool LASTCOL, bool EDGE, bool ANYROW>
__device__ __forceinline__ void group(
    Lane& s, int lane, int c0, int32_t pf_h, int32_t pf_f, int32_t pf_b,
    int nj, int row0, int R, const int32_t* __restrict__ init_h,
    const int32_t* __restrict__ init_e, const Scores& sc, int wk,
    int32_t* bus_h, int32_t* bus_f, int32_t* rh, int32_t* rf,
    int32_t* lc_h, int32_t* lc_e) {
#pragma unroll 4
  for (int i = 0; i < kWarp; ++i) {
    const int t = c0 + i;
    int32_t oh = kNeg, of = kNeg;
    step<SW, TRACK, EDGE, ANYROW>(s, lane, t, __shfl_sync(kFull, pf_h, i),
                                  __shfl_sync(kFull, pf_f, i),
                                  __shfl_sync(kFull, pf_b, i), nj, row0, R,
                                  init_h, init_e, sc, wk, oh, of);
    const int j = t - lane;
    if (!EDGE || (j >= 0 && j < nj)) {
      if (wk >= 0) {
        bus_h[j] = oh;
        bus_f[j] = of;
        if (rh != nullptr) {
          rh[j] = oh;
          rf[j] = of;
        }
      }
      if (EDGE && LASTCOL && j == nj - 1) {
#pragma unroll
        for (int k = 0; k < kAlpha; ++k) {
          if (row0 + k < R) {
            lc_h[row0 + k] = s.h[k];
            lc_e[row0 + k] = s.e[k];
          }
        }
      }
    }
  }
}

template <bool SW, int TRACK, bool LASTCOL>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
    strip_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                 int32_t* bus_h, int32_t* bus_f,
                 const int32_t* __restrict__ init_h,
                 const int32_t* __restrict__ init_e,
                 const int32_t* __restrict__ scal, int32_t* best_v,
                 int32_t* best_j, int32_t* lc_h, int32_t* lc_e,
                 int32_t* rows_h, int32_t* rows_f, int32_t* sync, int R,
                 int P, Scores sc) {
  __shared__ int ticket;
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  if (threadIdx.x == 0) ticket = atomicAdd(sync, 1);
  __syncthreads();
  const int band = ticket * kWarpsPerBlock + warp;
  const int nj = scal[kWidth];
  const int h_true = scal[kHeight];
  const int flush = scal[kFlush];
  const int nbands = (h_true + kBand - 1) / kBand;
  const int top = band * kBand;
  const int row0 = top + lane * kAlpha;
  int32_t* progress = sync + 1;

  if (band >= nbands) {
    if (TRACK) {
#pragma unroll
      for (int k = 0; k < kAlpha; ++k) {
        const int r = row0 + k;
        if (r < R) {
          best_v[r] = kNeg;
          if (TRACK == 2) best_j[r] = 0;
        }
      }
    }
    return;
  }

  Lane s;
#pragma unroll
  for (int k = 0; k < kAlpha; ++k) {
    const int r = row0 + k;
    s.ak[k] = (r < h_true) ? a[r] : kASentinel;
    s.h[k] = (r < R) ? init_h[r] : kNeg;
    s.e[k] = (r < R) ? init_e[r] : kNeg;
    s.bv[k] = kNeg;
    s.bj[k] = 0;
  }
  // lane 0 has no border step: its bottom-row border is what lane 1 reads
  // as its first diagonal
  s.out_h = s.h[kAlpha - 1];
  s.out_f = kNeg;
  s.bc = kBSentinel;
  s.up_prev = (band == 0) ? scal[kCorner] : init_h[top - 1];

  // which sub-row of this thread feeds the bus: the band's bottom row, or
  // row h_true-1 in the last band
  const bool last_band = band == nbands - 1;
  int wk = -1;
  if (!last_band) {
    if (lane == kWarp - 1) wk = kAlpha - 1;
  } else {
    const int r = h_true - 1 - top;
    if (lane == r / kAlpha) wk = r % kAlpha;
  }
  // interior flush row (full strips; flush is a multiple of kBand)
  int q = -1;
  if (flush > 0 && lane == kWarp - 1 && (top + kBand) % flush == 0 &&
      top + kBand < R)
    q = (top + kBand) / flush - 1;
  int32_t* rh = q >= 0 ? rows_h + static_cast<size_t>(q) * P : nullptr;
  int32_t* rf = q >= 0 ? rows_f + static_cast<size_t>(q) * P : nullptr;

  const int groups = (nj + kWarp - 1 + kWarp - 1) / kWarp;
  int seen = 0;
  for (int g = 0; g < groups; ++g) {
    const int c0 = g * kWarp;
    // columns this group reads from the bus: [c0, c0 + 32) — wait until
    // band-1 has written them
    if (band > 0) {
      const int need = min(c0 + kWarp, nj);
        while (seen < need) {
        seen = ld_acquire(progress + band - 1);
        if (seen < need) __nanosleep(32);
      }
    }
    const int cj = c0 + lane;
    const int32_t pf_h = cj < nj ? bus_h[cj] : kNeg;
    const int32_t pf_f = cj < nj ? bus_f[cj] : kNeg;
    const int32_t pf_b = cj < nj ? b[cj] : kBSentinel;
    // the bus columns are read before anyone in this warp overwrites them
    __syncwarp();
    const bool fast = c0 >= kWarp - 1 && c0 + kWarp - 1 <= nj - 2;
    if (last_band) {
      if (fast)
        group<SW, TRACK, LASTCOL, false, true>(
            s, lane, c0, pf_h, pf_f, pf_b, nj, row0, R, init_h, init_e, sc,
            wk, bus_h, bus_f, rh, rf, lc_h, lc_e);
      else
        group<SW, TRACK, LASTCOL, true, true>(
            s, lane, c0, pf_h, pf_f, pf_b, nj, row0, R, init_h, init_e, sc,
            wk, bus_h, bus_f, rh, rf, lc_h, lc_e);
    } else {
      if (fast)
        group<SW, TRACK, LASTCOL, false, false>(
            s, lane, c0, pf_h, pf_f, pf_b, nj, row0, R, init_h, init_e, sc,
            wk, bus_h, bus_f, rh, rf, lc_h, lc_e);
      else
        group<SW, TRACK, LASTCOL, true, false>(
            s, lane, c0, pf_h, pf_f, pf_b, nj, row0, R, init_h, init_e, sc,
            wk, bus_h, bus_f, rh, rf, lc_h, lc_e);
    }
    // columns 0..c0 of this band's bottom row are written: publish them
    if (!last_band) {
      __syncwarp();
      if (lane == kWarp - 1) st_release(progress + band, min(c0 + 1, nj));
    }
  }

  if (TRACK) {
#pragma unroll
    for (int k = 0; k < kAlpha; ++k) {
      const int r = row0 + k;
      if (r < R) {
        best_v[r] = r < h_true ? s.bv[k] : kNeg;
        if (TRACK == 2) best_j[r] = r < h_true ? s.bj[k] : 0;
      }
    }
  }
}

template <bool SW, int TRACK, bool LASTCOL>
void launch(cudaStream_t st, int blocks, const int32_t* a, const int32_t* b,
            int32_t* bh, int32_t* bf, const int32_t* ih, const int32_t* ie,
            const int32_t* scal, int32_t* bv, int32_t* bj, int32_t* lh,
            int32_t* le, int32_t* rh, int32_t* rf, int32_t* sync, int R,
            int P, Scores sc) {
  strip_kernel<SW, TRACK, LASTCOL><<<blocks, kWarp * kWarpsPerBlock, 0,
                                     st>>>(a, b, bh, bf, ih, ie, scal, bv,
                                           bj, lh, le, rh, rf, sync, R, P,
                                           sc);
}

using Launcher = void (*)(cudaStream_t, int, const int32_t*,
                          const int32_t*, int32_t*, int32_t*,
                          const int32_t*, const int32_t*, const int32_t*,
                          int32_t*, int32_t*, int32_t*, int32_t*, int32_t*,
                          int32_t*, int32_t*, int, int, Scores);

template <bool SW>
Launcher pick(int track, bool lastcol) {
  if (track == 0) return lastcol ? launch<SW, 0, true> : launch<SW, 0, false>;
  if (track == 1) return lastcol ? launch<SW, 1, true> : launch<SW, 1, false>;
  return lastcol ? launch<SW, 2, true> : launch<SW, 2, false>;
}

ffi::Error StripImpl(cudaStream_t stream, ffi::Buffer<ffi::S32> a,
                     ffi::Buffer<ffi::S32> b, ffi::Buffer<ffi::S32> bus_h_in,
                     ffi::Buffer<ffi::S32> bus_f_in,
                     ffi::Buffer<ffi::S32> init_h,
                     ffi::Buffer<ffi::S32> init_e,
                     ffi::Buffer<ffi::S32> scal,
                     ffi::ResultBuffer<ffi::S32> bus_h,
                     ffi::ResultBuffer<ffi::S32> bus_f,
                     ffi::ResultBuffer<ffi::S32> best_v,
                     ffi::ResultBuffer<ffi::S32> best_j,
                     ffi::ResultBuffer<ffi::S32> lc_h,
                     ffi::ResultBuffer<ffi::S32> lc_e,
                     ffi::ResultBuffer<ffi::S32> rows_h,
                     ffi::ResultBuffer<ffi::S32> rows_f,
                     ffi::ResultBuffer<ffi::S32> sync, int32_t sw,
                     int32_t track, int32_t lastcol, int32_t match,
                     int32_t mismatch, int32_t gap_open, int32_t gap_ext) {
  const int R = static_cast<int>(a.element_count());
  const int P = static_cast<int>(bus_h_in.element_count());
  if (init_h.element_count() != static_cast<size_t>(R) ||
      init_e.element_count() != static_cast<size_t>(R) ||
      b.element_count() < static_cast<size_t>(P) ||
      scal.element_count() < kScalars)
    return ffi::Error::InvalidArgument("masa_strip: operand sizes");
  const int nbands = (R + kBand - 1) / kBand;
  if (sync->element_count() < static_cast<size_t>(nbands + 1))
    return ffi::Error::InvalidArgument("masa_strip: sync buffer too small");
  // the bus is updated in place; XLA aliases it, copy if it did not
  if (bus_h->typed_data() != bus_h_in.typed_data())
    cudaMemcpyAsync(bus_h->typed_data(), bus_h_in.typed_data(),
                    sizeof(int32_t) * P, cudaMemcpyDeviceToDevice, stream);
  if (bus_f->typed_data() != bus_f_in.typed_data())
    cudaMemcpyAsync(bus_f->typed_data(), bus_f_in.typed_data(),
                    sizeof(int32_t) * P, cudaMemcpyDeviceToDevice, stream);
  cudaMemsetAsync(sync->typed_data(), 0, sizeof(int32_t) * (nbands + 1),
                  stream);
  const int blocks = (nbands + kWarpsPerBlock - 1) / kWarpsPerBlock;
  Scores sc{match, mismatch, gap_open, gap_ext};
  Launcher fn = sw ? pick<true>(track, lastcol != 0)
                   : pick<false>(track, lastcol != 0);
  fn(stream, blocks, a.typed_data(), b.typed_data(), bus_h->typed_data(),
     bus_f->typed_data(), init_h.typed_data(), init_e.typed_data(),
     scal.typed_data(), best_v->typed_data(), best_j->typed_data(),
     lc_h->typed_data(), lc_e->typed_data(), rows_h->typed_data(),
     rows_f->typed_data(), sync->typed_data(), R, P, sc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess)
    return ffi::Error::Internal(std::string("masa_strip launch: ") +
                                cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    MasaStrip, StripImpl,
    ffi::Ffi::Bind()
        .Ctx<ffi::PlatformStream<cudaStream_t>>()
        .Arg<ffi::Buffer<ffi::S32>>()   // a
        .Arg<ffi::Buffer<ffi::S32>>()   // b
        .Arg<ffi::Buffer<ffi::S32>>()   // bus_h
        .Arg<ffi::Buffer<ffi::S32>>()   // bus_f
        .Arg<ffi::Buffer<ffi::S32>>()   // init_h
        .Arg<ffi::Buffer<ffi::S32>>()   // init_e
        .Arg<ffi::Buffer<ffi::S32>>()   // scal
        .Ret<ffi::Buffer<ffi::S32>>()   // bus_h
        .Ret<ffi::Buffer<ffi::S32>>()   // bus_f
        .Ret<ffi::Buffer<ffi::S32>>()   // best_v
        .Ret<ffi::Buffer<ffi::S32>>()   // best_j
        .Ret<ffi::Buffer<ffi::S32>>()   // lastcol_h
        .Ret<ffi::Buffer<ffi::S32>>()   // lastcol_e
        .Ret<ffi::Buffer<ffi::S32>>()   // rows_h
        .Ret<ffi::Buffer<ffi::S32>>()   // rows_f
        .Ret<ffi::Buffer<ffi::S32>>()   // sync
        .Attr<int32_t>("sw")
        .Attr<int32_t>("track")
        .Attr<int32_t>("lastcol")
        .Attr<int32_t>("match")
        .Attr<int32_t>("mismatch")
        .Attr<int32_t>("gap_open")
        .Attr<int32_t>("gap_ext"));
