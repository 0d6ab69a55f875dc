// Fused int4 dequant-matmul (w4a16) for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel clearml_serving_tpu/ops/fused_matmul.py::
// fused_int4_matmul (body _w4a16_kernel, pallas_call at :271). Same
// contract and the same algebra:
//
//   x        [M, K]      bf16, row-major
//   packed   [K/2, N]    uint8: byte (i, n) holds weight rows 2i (low
//                        nibble) and 2i+1 (high nibble) of column n, each
//                        stored as level + 8, level in [-8, 7]
//   scale    [K/g, N]    f32, one scale per (group of g rows, column)
//   out      [M, N]      bf16
//
// For each group, an f32 partial product of x with the levels (nibble - 8),
// multiplied AFTER the dot by that group's per-column scale, summed in f32:
// out = sum_g scale[g, :] * (x[:, group g] @ level[group g, :]).
//
// What bounds it on this card: decode calls (M <= 8) read every packed byte
// once for 2*M operations each, so they are bound by bytes (3.35 TB/s);
// K/2*N packed bytes are a quarter of the bf16 weight. At M = 312 (the
// ragged flat axis) a Llama-3-8B w_gate call is ~36.6 GFLOP against ~30 MB
// and the tensor cores bound it (989 TFLOP/s bf16).
//
// Common to both tilings:
// - mma.sync m16n8k16, bf16 in, f32 sums. A tensor-core fragment gives each
//   lane K rows (2t, 2t+1) of one weight column, which is exactly one packed
//   byte. Packed bytes are read from shared memory four or eight at a time
//   and become bf16 pairs with a byte permute, a mask and one subtraction:
//   the nibbles land in the mantissas of 128.0 (0x4300 | nibble = 128 +
//   nibble), minus 136 gives the level, exactly. Which output column each
//   register slot serves is chosen so that a lane's bytes are contiguous.
//   The TPU kernel's even/odd split of x is a Mosaic workaround and is not
//   carried over.
// - K is walked in stages through a ring of shared-memory buffers filled
//   with cp.async, several stages in flight (the counterpart of the TPU
//   kernel's two-slot DMA plan, which double-buffers one group's packed
//   rows): the stage's packed tile, its x tile and the scale rows of the
//   groups it touches. Rows past K or M and columns past N are zero-filled,
//   never read.
// - A warp's partial sum of the running group is folded into its total,
//   times the scale of each output column, when its next k-step lies in
//   another group, so any group size that is a multiple of 16 works (the
//   one-group fallback of K % 128 != 0 included).
//
// Decode tiling (M <= 16): the weight is the A operand and x the B operand
// (out^T = W^T x^T), so a 16-row weight tile meets the n8 x tile and no
// tensor-core row is spent on padding when M <= 8 (two n8 blocks for 9-16
// rows). At these rows the product does 4M operations per packed byte, far
// below the ~295 per byte where the tensor cores would bind: only bytes and
// their latency count. A CTA owns 128 columns (two column warps of 64), so
// each packed row is read as 128 contiguous bytes, and its other warps
// split each stage's K. K is split across CTAs (grid y) until the card holds one
// full wave of CTAs (decode_plan): narrow N (wk/wv: 8 column tiles) still
// fills every SM. Each split stores its f32 partial [M, N] into a
// workspace the wrapper allocates, and a second kernel adds the splits in
// split order and writes bf16: no atomics, so the same inputs give the
// same bits on every call. Calls whose columns alone fill the card (the
// lm_head) take one split and store bf16 directly. Both kernels launch as
// programmatic dependents (launch_dependent), so a launch overlaps the
// previous kernel's tail without reordering any memory access.
// Larger M (prefill buckets, the ragged flat axis) takes 64-row blocks with
// 2x2 warps of 32x32, x as the A operand.
//
// Known limits, left to later work: no TMA, no wgmma; the block tiling
// reaches ~15% of its bound at M = 312 and 2048.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void zero16(void* smem) {
  *reinterpret_cast<uint4*>(smem) = make_uint4(0u, 0u, 0u, 0u);
}

// Four 8x8 b16 matrices from shared memory; lane i names row i % 8 of
// matrix i / 8; lane t receives row t / 4, columns 2 * (t % 4) and +1 of
// each matrix.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// c += a * b on one m16n8k16 tile: a [16 x 16] bf16 row-major fragment,
// b [16 x 8] bf16 column fragment, c [16 x 8] f32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(c[0]), "f"(c[1]),
        "f"(c[2]), "f"(c[3]));
}

// Four packed bytes -> four bf16 pairs: r[j] = (low nibble - 8, high nibble
// - 8) of byte j, the low nibble (the even K row) in the low half.
__device__ __forceinline__ void int4_quad(uint32_t w, uint32_t* r) {
  const uint32_t w4 = w >> 4;  // byte j's high nibble in its low bits
  const __nv_bfloat162 off = __floats2bfloat162_rn(136.f, 136.f);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    // bytes (w_j, -, w4_j, -), masked to the nibbles, exponent of 128.0
    uint32_t t = (__byte_perm(w, w4, 0x4400u + 0x1111u * j) & 0x000F000Fu) | 0x43004300u;
    __nv_bfloat162 v = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&t), off);
    r[j] = *reinterpret_cast<uint32_t*>(&v);
  }
}

constexpr int kMaxDevices = 64;

// Shared memory above 48 KB needs the kernel to opt in, once per device.
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, int smem, bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

// ---- decode tiling: M <= 16, K split across CTAs ---------------------------------

constexpr int kDecWarps = 8;                 // warps of a CTA
constexpr int kDecThreads = 32 * kDecWarps;
constexpr int kDecNJ = 4;                    // 16-column weight tiles per warp: 64 columns
constexpr int kDecWC = 2;                    // warps side by side over the columns
constexpr int kDecWK = kDecWarps / kDecWC;   // warps along K
constexpr int kDecKS = 4;                    // k-steps per warp per stage
constexpr int kDecKC = 16 * kDecKS * kDecWK;      // K rows per stage (256)
constexpr int kDecPR = kDecKC / 2;                // packed rows per stage
constexpr int kDecBN = 64 * kDecWC;               // columns (= bytes of a packed row) per CTA
constexpr int kDecXStride = kDecKC + 8;           // bf16: rows shift 4 banks
constexpr int kDecWBytes = kDecPR * kDecBN;
constexpr int kDecStages = 4;                // cp.async ring: three stages in flight

// A CTA owns kDecBN = 128 columns, so it reads 128 contiguous bytes of each
// packed row; column warp wc (of 2) serves 64 of them and the 4 warps of a
// column split each stage's K. Lane (g, t) of column warp wc serves columns
// n0 + 64 wc + 8 g + (0 .. 7): in weight tile j, its fragment row g is
// column 2j and row g + 8 is column 2j + 1, so its 8 bytes of a packed row
// are contiguous.
//
// A staged packed row is its 128 bytes unpadded, eight 16-byte chunks,
// chunk c of row r stored at c ^ 2 (r & 3): a half warp's 8-byte reads
// (rows t = 0..3, 32 bytes each) then fall in four disjoint 8-bank ranges.
// Rows t and t + 4 share the permutation.
__device__ __forceinline__ int dec_w_offset(int row, int byte) {
  return row * kDecBN + (((byte >> 4) ^ ((row & 3) << 1)) << 4) + (byte & 15);
}

// MB: 8-row blocks of x, 1 for M <= 8 and 2 for M 9..16.
template <int MB>
struct DecTiling {
  static constexpr int kXRows = 8 * MB;
  static constexpr int kXBytes = kXRows * kDecXStride * 2;
  static constexpr int kStageBytes = kDecWBytes + kXBytes;
  static constexpr int kSmem = kDecStages * kStageBytes;
  static constexpr int kE = MB * kDecNJ * 4;           // f32 sums per lane
  static constexpr int kRedBytes = kDecWarps * 32 * (kE + 1) * 4;
  static_assert(kStageBytes % 16 == 0, "stages must stay 16-byte aligned");
  static_assert(kRedBytes <= kSmem, "reduction scratch must fit");
};

// acc += part * one group's scales for a lane's 8 columns (sa: columns 0-3,
// sb: 4-7); part restarts at zero
template <int MB>
__device__ __forceinline__ void fold_group(float (&part)[MB][kDecNJ][4],
                                           float (&acc)[MB][kDecNJ][4], const float4& sa,
                                           const float4& sb) {
  const float sv[2 * kDecNJ] = {sa.x, sa.y, sa.z, sa.w, sb.x, sb.y, sb.z, sb.w};
#pragma unroll
  for (int mb = 0; mb < MB; ++mb) {
#pragma unroll
    for (int j = 0; j < kDecNJ; ++j) {
      acc[mb][j][0] += part[mb][j][0] * sv[2 * j];
      acc[mb][j][1] += part[mb][j][1] * sv[2 * j];
      acc[mb][j][2] += part[mb][j][2] * sv[2 * j + 1];
      acc[mb][j][3] += part[mb][j][3] * sv[2 * j + 1];
#pragma unroll
      for (int e = 0; e < 4; ++e) part[mb][j][e] = 0.f;
    }
  }
}

// One CTA: kDecBN columns (blockIdx.x) over split blockIdx.y of K. The
// gridDim.y splits take contiguous, equal shares of K in units of `unit`
// rows (whole groups where there are at least as many groups as splits,
// else 16-row k-steps). With `partial` null (one split) the CTA stores bf16
// into `out`; else it stores its f32 sum into partial[split] and
// w4a16_split_sum adds the splits up. Packed rows and x stream through the
// shared-memory ring; a warp reads the 8 scales of its columns' running
// group from global memory (L2) when the group starts, ahead of its fold.
template <int MB>
__global__ void __launch_bounds__(kDecThreads)
    w4a16_decode_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ packed,
                        const float* __restrict__ scale, __nv_bfloat16* __restrict__ out,
                        float* __restrict__ partial, int m, int k, int n, int group, int unit) {
  using Tl = DecTiling<MB>;
  constexpr int kNJ = kDecNJ;
  constexpr int kWK = kDecWK;
  constexpr int kKC = kDecKC;
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wk = warp % kWK;  // this warp's place along K
  const int wc = warp / kWK;  // and over the columns
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int n0 = blockIdx.x * kDecBN;
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const int units = k / unit;
  const int kb = split * units / splits * unit;        // this split's K rows: [kb, ke)
  const int ke = (split + 1) * units / splits * unit;
  const int n_chunks = (ke - kb + kKC - 1) / kKC;

  auto w_s = [&](int buf) { return smem + buf * Tl::kStageBytes; };
  auto x_s = [&](int buf) {
    return reinterpret_cast<__nv_bfloat16*>(smem + buf * Tl::kStageBytes + kDecWBytes);
  };

  auto load_stage = [&](int c, int buf) {
    const int kc0 = kb + c * kKC;
    unsigned char* ws = w_s(buf);
    for (int i = tid; i < kDecPR * (kDecBN / 16); i += kDecThreads) {
      const int r = i / (kDecBN / 16);
      const int ch = i % (kDecBN / 16);
      if (kc0 / 2 + r < ke / 2 && n0 + ch * 16 < n) {
        cp_async16(ws + dec_w_offset(r, ch * 16),
                   packed + static_cast<size_t>(kc0 / 2 + r) * n + n0 + ch * 16);
      } else {
        zero16(ws + dec_w_offset(r, ch * 16));
      }
    }
    __nv_bfloat16* xs = x_s(buf);
    for (int i = tid; i < Tl::kXRows * (kKC / 8); i += kDecThreads) {
      const int r = i / (kKC / 8);
      const int col = kc0 + (i % (kKC / 8)) * 8;
      if (r < m && col < ke) {
        cp_async16(xs + r * kDecXStride + (col - kc0), x + static_cast<size_t>(r) * k + col);
      } else {
        zero16(xs + r * kDecXStride + (col - kc0));
      }
    }
  };

  float part[MB][kNJ][4];  // the running group's sum, unscaled
  float acc[MB][kNJ][4];   // the scaled total
#pragma unroll
  for (int mb = 0; mb < MB; ++mb) {
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) part[mb][j][e] = acc[mb][j][e] = 0.f;
    }
  }
  // this lane's 8 columns (all past N or none: N % 16 == 0) and their
  // scales in the running group
  const int col0 = n0 + 64 * wc + 8 * gid;
  const float* scol = scale + col0;
  float4 sa = make_float4(0.f, 0.f, 0.f, 0.f), sb = sa;
  bool have_scales = false;
  // this warp's k-steps are every kWK-th one of the split: rows kb + 16 wk
  // + 16 kWK i
  int g_cur = (kb + 16 * wk) / group;  // the group of the warp's next k-step
  int pos = (kb + 16 * wk) % group;    // that k-step's first row within it
  bool pending = false;                // part holds rows not folded yet
  // launched as a programmatic dependent (launch_dependent): wait for the
  // stream's previous kernel before touching global memory; then let the
  // next kernel (the split sum, or the next call) be scheduled
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

#pragma unroll
  for (int s = 0; s < kDecStages - 1; ++s) {
    if (s < n_chunks) load_stage(s, s);
    cp_async_commit();
  }

  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<kDecStages - 2>();
    __syncthreads();  // stage c has landed; every warp is done with stage c - 1
    if (c + kDecStages - 1 < n_chunks) {
      load_stage(c + kDecStages - 1, (c + kDecStages - 1) % kDecStages);
    }
    cp_async_commit();  // possibly empty: keeps the wait count uniform

    const int buf = c % kDecStages;
    const unsigned char* ws = w_s(buf);
    const __nv_bfloat16* xs = x_s(buf);
    const int kc0 = kb + c * kKC;
#pragma unroll
    for (int h = 0; h < kDecKS; ++h) {
      const int ks = wk + kWK * h;  // k-step within the stage
      if (kc0 + 16 * ks >= ke) break;
      if (!have_scales && col0 < n) {
        sa = __ldg(reinterpret_cast<const float4*>(scol + static_cast<size_t>(g_cur) * n));
        sb = __ldg(reinterpret_cast<const float4*>(scol + static_cast<size_t>(g_cur) * n + 4));
      }
      have_scales = true;
      // this lane's weight bytes in packed rows t and t + 4 of the k-step
      const unsigned char* wr = ws + dec_w_offset(ks * 8 + tig, 64 * wc + gid * 8);
      uint32_t lo[2 * kNJ], hi[2 * kNJ];  // A registers of rows t and t + 4
      const uint2 a = *reinterpret_cast<const uint2*>(wr);
      const uint2 b = *reinterpret_cast<const uint2*>(wr + 4 * kDecBN);
      int4_quad(a.x, lo);
      int4_quad(a.y, lo + 4);
      int4_quad(b.x, hi);
      int4_quad(b.y, hi + 4);
      uint32_t b0[MB], b1[MB];
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) {
        const __nv_bfloat16* xr = xs + (mb * 8 + gid) * kDecXStride + ks * 16 + 2 * tig;
        b0[mb] = *reinterpret_cast<const uint32_t*>(xr);
        b1[mb] = *reinterpret_cast<const uint32_t*>(xr + 8);
      }
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        const uint32_t af[4] = {lo[2 * j], lo[2 * j + 1], hi[2 * j], hi[2 * j + 1]};
#pragma unroll
        for (int mb = 0; mb < MB; ++mb) mma_bf16(part[mb][j], af, b0[mb], b1[mb]);
      }
      pending = true;
      // the warp's next k-step lies in another group: fold this one in
      int np = pos + 16 * kWK;
      if (np >= group) {
        fold_group<MB>(part, acc, sa, sb);
        pending = have_scales = false;
        while (np >= group) {
          np -= group;
          ++g_cur;
        }
      }
      pos = np;
    }
  }
  // the split ends inside the warp's last group (a split of k-steps in the
  // middle of a group): fold what it holds
  if (pending) fold_group<MB>(part, acc, sa, sb);

  // sum the K warps' totals through shared memory, then store
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int mb = 0; mb < MB; ++mb) {
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        red[(warp * 32 + lane) * (Tl::kE + 1) + (mb * kNJ + j) * 4 + e] = acc[mb][j][e];
      }
    }
  }
  __syncthreads();
  float* split_out = partial ? partial + static_cast<size_t>(split) * m * n : nullptr;
  for (int idx = tid; idx < kDecWC * 32 * Tl::kE; idx += kDecThreads) {
    const int cw = idx / (32 * Tl::kE);
    const int ln = (idx / Tl::kE) % 32;
    const int e = idx % Tl::kE;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kWK; ++w) v += red[((cw * kWK + w) * 32 + ln) * (Tl::kE + 1) + e];
    // C of tile j: rows g (column 2j) and g + 8 (column 2j + 1), columns
    // 2t and 2t + 1 of the m-block
    const int mb = e / (kNJ * 4);
    const int j = (e / 4) % kNJ;
    const int row = mb * 8 + 2 * (ln & 3) + (e & 1);
    const int col = n0 + 64 * cw + 2 * kNJ * (ln >> 2) + 2 * j + ((e >> 1) & 1);
    if (row < m && col < n) {
      if (split_out) {
        split_out[static_cast<size_t>(row) * n + col] = v;
      } else {
        out[static_cast<size_t>(row) * n + col] = __float2bfloat16_rn(v);
      }
    }
  }
}

constexpr int kSumThreads = 128;
constexpr int kMaxSplits = 16;  // K splits of a decode call (decode_plan)

// out = bf16(partial[0] + partial[1] + ... + partial[splits - 1]), in that
// order, four elements a thread: the same bits on every call. Launched as a
// programmatic dependent of the decode kernel (launch_dependent), so its
// launch overlaps the decode kernel's run.
__global__ void __launch_bounds__(kSumThreads)
    w4a16_split_sum(const float* __restrict__ partial, __nv_bfloat16* __restrict__ out, int mn,
                    int splits) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int i = 4 * (blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= mn) return;
  auto at = [&](int s) {
    return __ldcg(reinterpret_cast<const float4*>(partial + static_cast<size_t>(s) * mn + i));
  };
  auto add = [](float4& a, const float4& b) {
    a.x += b.x;
    a.y += b.y;
    a.z += b.z;
    a.w += b.w;
  };
  float4 b[kMaxSplits];  // every split's load in flight (splits <= kMaxSplits)
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s) {
    if (s < splits) b[s] = at(s);
  }
  float4 a = b[0];
#pragma unroll
  for (int s = 1; s < kMaxSplits; ++s) {
    if (s < splits) add(a, b[s]);
  }
  __nv_bfloat162 lo = __floats2bfloat162_rn(a.x, a.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(a.z, a.w);
  *reinterpret_cast<uint2*>(out + i) =
      make_uint2(*reinterpret_cast<uint32_t*>(&lo), *reinterpret_cast<uint32_t*>(&hi));
}

// The split of K for a decode call. The card is filled when every SM holds
// as many CTAs as fit at once: `resident` CTAs. Column tiles alone give n /
// 128 CTAs (8 for wk/wv, 32 for wq/wo and w_down, 112 for
// w_gate/w_up, 1002 for the lm_head), so K is split into as many shares as
// fit in one such wave, never more: a second, partial wave would leave most
// SMs idle while it runs. A share keeps at least one stage of K. Shares
// are whole groups where K holds at least as many groups as shares, else
// whole 16-row k-steps (the one-group fallback): the scale-after-dot fold
// is linear, so a group may straddle two shares. At most kMaxSplits shares:
// w4a16_split_sum then keeps every share's load in flight at once, and
// each further share adds partial sums to write and read.
struct DecPlan {
  int splits;
  int unit;
};

DecPlan decode_plan(int k, int n, int group, int resident) {
  const int tiles = (n + kDecBN - 1) / kDecBN;
  int splits = std::min(std::max(1, resident / tiles), kMaxSplits);
  splits = std::min(splits, std::max(1, k / kDecKC));
  const int unit = k / group >= splits ? group : 16;
  return {std::min(splits, k / unit), unit};
}

// CTAs of w4a16_decode_kernel<MB> resident on the current device at once;
// opts the kernel into its shared memory first. Cached per device.
template <int MB>
cudaError_t decode_resident(int* resident) {
  static bool opted_in[kMaxDevices] = {};
  static int cached[kMaxDevices] = {};
  auto kernel = w4a16_decode_kernel<MB>;
  cudaError_t err = opt_in(kernel, DecTiling<MB>::kSmem, opted_in);
  if (err != cudaSuccess) return err;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (!cached[dev]) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kDecThreads,
                                                        DecTiling<MB>::kSmem);
    if (err != cudaSuccess) return err;
    cached[dev] = sms * std::max(1, per_sm);
  }
  *resident = cached[dev];
  return cudaSuccess;
}

// Launches `kernel` as a programmatic dependent of the stream's previous
// kernel: its CTAs may be scheduled while that kernel finishes (once all
// of that kernel's CTAs have run griddepcontrol.launch_dependents, or
// exited), and the kernel's griddepcontrol.wait, ahead of any global memory
// access, holds them until the previous kernel has completed and its
// stores are visible. The order of memory effects is the stream's; only the
// launch latency overlaps.
template <typename... Params, typename... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), dim3 grid, int threads, int smem,
                             cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <int MB>
cudaError_t decode_workspace(int m, int k, int n, int group, long long* bytes) {
  int resident = 0;
  cudaError_t err = decode_resident<MB>(&resident);
  if (err != cudaSuccess) return err;
  const DecPlan plan = decode_plan(k, n, group, resident);
  *bytes = plan.splits > 1 ? 4LL * plan.splits * m * n : 0;
  return cudaSuccess;
}

template <int MB>
cudaError_t launch_decode(const void* x, const void* packed, const void* scale, void* out,
                          void* workspace, long long workspace_bytes, int m, int k, int n,
                          int group, cudaStream_t stream) {
  int resident = 0;
  cudaError_t err = decode_resident<MB>(&resident);
  if (err != cudaSuccess) return err;
  const DecPlan plan = decode_plan(k, n, group, resident);
  float* partial = nullptr;
  if (plan.splits > 1) {
    if (workspace == nullptr || workspace_bytes < 4LL * plan.splits * m * n) {
      return cudaErrorInvalidValue;
    }
    partial = static_cast<float*>(workspace);
  }
  err = launch_dependent(w4a16_decode_kernel<MB>,
                         dim3((n + kDecBN - 1) / kDecBN, plan.splits), kDecThreads,
                         DecTiling<MB>::kSmem, stream, static_cast<const __nv_bfloat16*>(x),
                         static_cast<const uint8_t*>(packed), static_cast<const float*>(scale),
                         static_cast<__nv_bfloat16*>(out), partial, m, k, n, group, plan.unit);
  if (err != cudaSuccess || partial == nullptr) return err;
  return launch_dependent(w4a16_split_sum, dim3((m * n / 4 + kSumThreads - 1) / kSumThreads),
                          kSumThreads, 0, stream, static_cast<const float*>(partial),
                          static_cast<__nv_bfloat16*>(out), m * n, plan.splits);
}

// ---- block tiling: M > 16 -------------------------------------------------------

constexpr int kKC = 128;            // K rows per pipeline stage
constexpr int kPR = kKC / 2;        // packed rows per stage
constexpr int kKSteps = kKC / 16;   // tensor-core k-steps per stage
constexpr int kBN = 64;             // output columns per CTA
constexpr int kThreads = 128;       // 2 x 2 warps
constexpr int kBM = 64;             // rows per CTA
constexpr int kMT = 2;              // 16-row m-tiles per warp
constexpr int kNT = 4;              // 8-column n-tiles per warp
constexpr int kMaxScaleRows = kKC / 16;  // groups (>= 16 rows) ending in one stage
constexpr int kXStride = kKC + 8;   // bf16 per staged x row: ldmatrix rows shift 4 banks
constexpr int kWStride = kBN + 32;  // bytes per staged packed row: conflict-free word reads
constexpr int kXBytes = kBM * kXStride * 2;
constexpr int kWBytes = kPR * kWStride;
constexpr int kSBytes = kMaxScaleRows * kBN * 4;
constexpr int kStageBytes = kXBytes + kWBytes + kSBytes;
static_assert(kStageBytes % 16 == 0, "stages must stay 16-byte aligned");

// Warp (wm, wn) owns rows 32 wm .. +31 and columns 32 wn .. +31 of the CTA;
// lane (g, t)'s B operand in n-tile nt is column 32 wn + 4 g + nt, so its
// accumulators hold columns 32 wn + 8 t + (0 .. 7).
template <int STAGES>
__global__ void __launch_bounds__(kThreads)
    w4a16_block_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ packed,
                       const float* __restrict__ scale, __nv_bfloat16* __restrict__ out, int m,
                       int k, int n, int group) {
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int wm = warp >> 1;
  const int wn = warp & 1;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int k2 = k >> 1;
  const int n_chunks = (k + kKC - 1) / kKC;

  auto x_s = [&](int buf) {
    return reinterpret_cast<__nv_bfloat16*>(smem + buf * kStageBytes);
  };
  auto w_s = [&](int buf) { return smem + buf * kStageBytes + kXBytes; };
  auto s_s = [&](int buf) {
    return reinterpret_cast<float*>(smem + buf * kStageBytes + kXBytes + kWBytes);
  };

  auto load_stage = [&](int c, int buf) {
    const int kc0 = c * kKC;
    __nv_bfloat16* xs = x_s(buf);
    for (int i = tid; i < kBM * (kKC / 8); i += kThreads) {
      const int r = i / (kKC / 8);
      const int col = kc0 + (i % (kKC / 8)) * 8;
      if (m0 + r < m && col < k) {
        cp_async16(xs + r * kXStride + (col - kc0), x + static_cast<size_t>(m0 + r) * k + col);
      } else {
        zero16(xs + r * kXStride + (col - kc0));
      }
    }
    unsigned char* ws = w_s(buf);
    for (int i = tid; i < kPR * (kBN / 16); i += kThreads) {
      const int r = i / (kBN / 16);
      const int ch = i % (kBN / 16);
      if (kc0 / 2 + r < k2 && n0 + ch * 16 < n) {
        cp_async16(ws + r * kWStride + ch * 16,
                   packed + static_cast<size_t>(kc0 / 2 + r) * n + n0 + ch * 16);
      } else {
        zero16(ws + r * kWStride + ch * 16);
      }
    }
    // the scale rows of the groups whose last row lies in this stage
    const int g_lo = kc0 / group;
    const int g_hi = min(kc0 + kKC, k) / group;
    float* ss = s_s(buf);
    for (int i = tid; i < (g_hi - g_lo) * (kBN / 4); i += kThreads) {
      const int r = i / (kBN / 4);
      const int ch = i % (kBN / 4);
      if (n0 + ch * 4 < n) {
        cp_async16(ss + r * kBN + ch * 4, scale + static_cast<size_t>(g_lo + r) * n + n0 + ch * 4);
      } else {
        zero16(ss + r * kBN + ch * 4);
      }
    }
  };

  float part[kMT][kNT][4];  // the running group's sum, unscaled
  float acc[kMT][kNT][4];   // the scaled total
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) part[mt][nt][e] = acc[mt][nt][e] = 0.f;
    }
  }
  int g_cur = 0;     // the group the partial sum belongs to
  int left = group;  // its K rows still to come

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_chunks) load_stage(s, s);
    cp_async_commit();
  }

  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage c has landed; every warp is done with stage c - 1
    if (c + STAGES - 1 < n_chunks) load_stage(c + STAGES - 1, (c + STAGES - 1) % STAGES);
    cp_async_commit();  // possibly empty: keeps the wait count uniform

    const int buf = c % STAGES;
    const __nv_bfloat16* xs = x_s(buf);
    const unsigned char* ws = w_s(buf);
    const float* ss = s_s(buf);
    const int kc0 = c * kKC;
    const int g_lo = kc0 / group;
    const int steps = min(kKSteps, (k - kc0) / 16);
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
      if (ks >= steps) break;
      uint32_t a[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        ldmatrix_x4(a[mt], xs + ((wm * kMT + mt) * 16 + (lane & 15)) * kXStride + ks * 16 +
                               (lane >> 4) * 8);
      }
      // four packed bytes per row: n-tiles 0..3 of this lane's column
      const unsigned char* wr = ws + (ks * 8 + tig) * kWStride + 32 * wn + 4 * gid;
      uint32_t b0[kNT], b1[kNT];
      int4_quad(*reinterpret_cast<const uint32_t*>(wr), b0);                 // K rows 2t, 2t+1
      int4_quad(*reinterpret_cast<const uint32_t*>(wr + 4 * kWStride), b1);  // 2t+8, 2t+9
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) mma_bf16(part[mt][nt], a[mt], b0[nt], b1[nt]);
      }
      left -= 16;
      if (left == 0) {  // the group ends here: fold it in, times its scales
        const float* srow = ss + (g_cur - g_lo) * kBN + 32 * wn + 8 * tig;
        const float4 s_a = *reinterpret_cast<const float4*>(srow);      // columns 8t + nt
        const float4 s_b = *reinterpret_cast<const float4*>(srow + 4);  // 8t + 4 + nt
        const float sa[kNT] = {s_a.x, s_a.y, s_a.z, s_a.w};
        const float sb[kNT] = {s_b.x, s_b.y, s_b.z, s_b.w};
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            acc[mt][nt][0] += part[mt][nt][0] * sa[nt];
            acc[mt][nt][1] += part[mt][nt][1] * sb[nt];
            acc[mt][nt][2] += part[mt][nt][2] * sa[nt];
            acc[mt][nt][3] += part[mt][nt][3] * sb[nt];
#pragma unroll
            for (int e = 0; e < 4; ++e) part[mt][nt][e] = 0.f;
          }
        }
        ++g_cur;
        left = group;
      }
    }
  }

  // each lane holds columns 32 wn + 8 t + (0 .. 7) of two rows per m-tile:
  // one 16-byte store per row
  const int col = n0 + 32 * wn + 8 * tig;
  if (col >= n) return;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + (wm * kMT + mt) * 16 + gid + 8 * half;
      if (row >= m) continue;
      uint32_t v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        // columns 8t + 2q and 8t + 2q + 1: n-tiles (2q, 2q + 1) of the
        // first accumulator column pair below 4, of the second above
        const int lo_c = 2 * q, hi_c = 2 * q + 1;
        const float f0 = lo_c < 4 ? acc[mt][lo_c][2 * half] : acc[mt][lo_c - 4][2 * half + 1];
        const float f1 = hi_c < 4 ? acc[mt][hi_c][2 * half] : acc[mt][hi_c - 4][2 * half + 1];
        __nv_bfloat162 p = __floats2bfloat162_rn(f0, f1);
        v[q] = *reinterpret_cast<uint32_t*>(&p);
      }
      *reinterpret_cast<uint4*>(out + static_cast<size_t>(row) * n + col) =
          make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

template <int STAGES>
cudaError_t launch_block(const void* x, const void* packed, const void* scale, void* out, int m,
                         int k, int n, int group, cudaStream_t stream) {
  constexpr int smem = STAGES * kStageBytes;
  auto kernel = w4a16_block_kernel<STAGES>;
  static bool opted_in[kMaxDevices] = {};
  cudaError_t err = opt_in(kernel, smem, opted_in);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out), m, k, n, group);
  return cudaGetLastError();
}

bool bad_args(int m, int k, int n, int group) {
  return m < 0 || k <= 0 || n <= 0 || group <= 0 || group % 16 || k % group || n % 16 ||
         (m + kBM - 1) / kBM > 65535;
}

}  // namespace

// C entry points, bound with ctypes. Each returns a cudaError_t (0 on
// success); the Python wrapper has checked shapes, types and gates.

// Bytes of f32 workspace the call (m, k, n, group) needs for its split-K
// partial sums (0 when K is not split), into *bytes.
extern "C" int tpu_torch_fused_int4_workspace(int m, int k, int n, int group,
                                              long long* bytes) {
  *bytes = 0;
  if (bad_args(m, k, n, group)) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0 || m > 16) return static_cast<int>(cudaSuccess);
  const cudaError_t err = m <= 8 ? decode_workspace<1>(m, k, n, group, bytes)
                                 : decode_workspace<2>(m, k, n, group, bytes);
  return static_cast<int>(err);
}

// out = x @ dequant(packed, scale). `workspace` holds at least the bytes
// tpu_torch_fused_int4_workspace reports (null when it reports 0), on the
// same stream: the call's split-K partial sums.
extern "C" int tpu_torch_fused_int4_matmul(const void* x, const void* packed, const void* scale,
                                           void* out, void* workspace, int m, int k, int n,
                                           int group, long long workspace_bytes, void* stream) {
  if (bad_args(m, k, n, group)) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (m > 16) {
    err = launch_block<3>(x, packed, scale, out, m, k, n, group, s);
  } else if (m <= 8) {
    err = launch_decode<1>(x, packed, scale, out, workspace, workspace_bytes, m, k, n,
                                  group, s);
  } else {
    err = launch_decode<2>(x, packed, scale, out, workspace, workspace_bytes, m, k, n,
                                  group, s);
  }
  return static_cast<int>(err);
}
