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
// What bounds it on this card: a call reads K/2*N packed bytes (a quarter
// of the bf16 weight) and does 2*M*K*N operations, 4M per packed byte. The
// tensor cores bind above ~295 operations per byte (989 TFLOP/s bf16
// against 3.35 TB/s): decode rows and block calls up to M ~ 64 are bound
// by bytes; the ragged flat axis (M = 312) and prefills by operations (a
// Llama-3-8B w_gate call at M = 312: 36.6 GFLOP, at least 0.037 ms).
//
// Common to both tilings:
// - out^T = W^T x^T: the dequantized weight is the tensor cores' A operand,
//   held in registers, and x the B operand. A lane's A fragment (the
//   m16n8k16 layout, which a wgmma register A keeps per warp) holds K rows
//   (2t, 2t+1) of one weight column: exactly one packed byte. It becomes a
//   bf16 pair with a byte permute, a mask and one subtraction: the nibbles
//   land in the mantissas of 128.0 (0x4300 | nibble = 128 + nibble), minus
//   136 gives the level, exactly. No dequantized weight goes through
//   memory. Which output column each accumulator row serves is chosen so
//   that a lane's bytes of a packed row are contiguous. The TPU kernel's
//   even/odd split of x is a Mosaic workaround and is not carried over.
// - The TPU kernel's algebra: a group's f32 partial sum is folded into the
//   total times the group's per-column scales after the dot, so any group
//   size that is a multiple of 16 works (the one-group fallback of K % 128
//   != 0 included).
// - K is split across CTAs until the CTAs fill one wave of the card; each
//   split stores its f32 partial [M, N] into a workspace the wrapper
//   allocates, and w4a16_split_sum adds the splits in split order and
//   writes bf16: no atomics, so the same inputs give the same bits on
//   every call. Calls whose tiles alone fill the card take one split and
//   store bf16 directly. The kernels launch as programmatic dependents
//   (launch_dependent), so a launch overlaps the previous kernel's tail
//   without reordering any memory access.
//
// Decode tiling (M <= 16): mma.sync m16n8k16, so a 16-row weight tile
// meets the n8 x tile and no tensor-core row is spent on padding when M <=
// 8 (two n8 blocks for 9-16 rows). At these rows only bytes and their
// latency count. A CTA owns 128 columns (two column warps of 64), so each
// packed row is read as 128 contiguous bytes, and its other warps split
// each stage's K; packed rows and x stream through a ring of shared-memory
// stages filled with cp.async (zero-filled past K, M and N). K is split
// across CTAs (grid y, decode_plan): narrow N (wk/wv: 8 column tiles)
// still fills every SM.
//
// Block tiling (M > 16; the ragged flat axis, prefill buckets, verify
// rows): wgmma fed by TMA. A CTA owns 128 columns and BN tokens (32, 64 or
// 160; one tile holds all rows up to 64, so each packed byte is read once
// per call). Two consumer warpgroups each run m64nBNk16 wgmma on 64 of the
// columns, the weight from registers and x from shared memory; one
// producer warp keeps an 8-stage ring filled by TMA behind full and empty
// mbarriers (x: BN tokens by 64 K rows; packed: 32 rows of 128 bytes; both
// with the 128-byte swizzle that wgmma's descriptor reads), and TMA's zero
// fill covers rows past M and K and columns past N. k-steps go to the
// tensor cores in pairs behind one fence, so a pair's products run while
// the next pair is dequantized. The group fold waits for the group's
// products; the other warpgroup's products fill that gap. K is split
// across grid z as above (block_plan).
//
// Known limits, left to later work: the block tiling stays under half of
// its operations bound at M = 312 and 2048 (PERF.md). Bytes and L2 do not
// hold it: timed on the card, the loop barely gained when the TMA copies
// after the first ring were left out, but ran much faster with constant A
// fragments, and as slowly when the same dequantization instructions ran
// in the idle producer warps instead: those instructions slow the tensor
// cores wherever they run. Fewer of them per weight need another packed
// layout.

#include <cuda.h>
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

// The split of K for a call. The card is filled when every SM holds as
// many CTAs as fit at once: `resident` CTAs. A decode call's column tiles
// alone give n / 128 CTAs (8 for wk/wv, 32 for wq/wo and w_down, 112 for
// w_gate/w_up, 1002 for the lm_head), so K is split into as many shares as
// fit in one such wave, never more: a second, partial wave would leave most
// SMs idle while it runs. A share keeps at least one stage of K. Shares
// are whole groups where K holds at least as many groups as shares, else
// whole 16-row k-steps (the one-group fallback): the scale-after-dot fold
// is linear, so a group may straddle two shares. At most kMaxSplits shares:
// w4a16_split_sum then keeps every share's load in flight at once, and
// each further share adds partial sums to write and read.
struct SplitPlan {
  int splits;
  int unit;
};

// The split of K over `tiles` CTA tiles, each share at least `min_rows`
// rows of K.
SplitPlan split_plan(int tiles, int k, int group, int min_rows, int resident) {
  int splits = std::min(std::max(1, resident / tiles), kMaxSplits);
  splits = std::min(splits, std::max(1, k / min_rows));
  const int unit = k / group >= splits ? group : 16;
  return {std::min(splits, k / unit), unit};
}

// CTAs of `kernel` resident on the current device at once, with `threads`
// threads and `smem` bytes of shared memory each; opts the kernel into its
// shared memory first. Cached per device.
template <auto kernel>
cudaError_t resident_ctas(int threads, int smem, int* resident) {
  static bool opted_in[kMaxDevices] = {};
  static int cached[kMaxDevices] = {};
  cudaError_t err = opt_in(kernel, smem, opted_in);
  if (err != cudaSuccess) return err;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (!cached[dev]) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (err != cudaSuccess) return err;
    cached[dev] = sms * std::max(1, per_sm);
  }
  *resident = cached[dev];
  return cudaSuccess;
}

template <int MB>
cudaError_t decode_plan(int k, int n, int group, SplitPlan* plan) {
  int resident = 0;
  const cudaError_t err =
      resident_ctas<w4a16_decode_kernel<MB>>(kDecThreads, DecTiling<MB>::kSmem, &resident);
  if (err == cudaSuccess) {
    *plan = split_plan((n + kDecBN - 1) / kDecBN, k, group, kDecKC, resident);
  }
  return err;
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

// The f32 partial sums of a call split plan.splits ways: null for one
// split, else the workspace, which must hold them.
cudaError_t split_partials(SplitPlan plan, int m, int n, void* workspace,
                           long long workspace_bytes, float** partial) {
  *partial = nullptr;
  if (plan.splits == 1) return cudaSuccess;
  if (workspace == nullptr || workspace_bytes < 4LL * plan.splits * m * n) {
    return cudaErrorInvalidValue;
  }
  *partial = static_cast<float*>(workspace);
  return cudaSuccess;
}

// out = the sum of the splits' partials (nothing to do for one split).
cudaError_t sum_splits(const float* partial, void* out, int m, int n, int splits,
                       cudaStream_t stream) {
  if (partial == nullptr) return cudaSuccess;
  return launch_dependent(w4a16_split_sum, dim3((m * n / 4 + kSumThreads - 1) / kSumThreads),
                          kSumThreads, 0, stream, partial, static_cast<__nv_bfloat16*>(out),
                          m * n, splits);
}

template <int MB>
cudaError_t launch_decode(const void* x, const void* packed, const void* scale, void* out,
                          void* workspace, long long workspace_bytes, int m, int k, int n,
                          int group, cudaStream_t stream) {
  SplitPlan plan;
  cudaError_t err = decode_plan<MB>(k, n, group, &plan);
  float* partial = nullptr;
  if (err == cudaSuccess) err = split_partials(plan, m, n, workspace, workspace_bytes, &partial);
  if (err != cudaSuccess) return err;
  err = launch_dependent(w4a16_decode_kernel<MB>,
                         dim3((n + kDecBN - 1) / kDecBN, plan.splits), kDecThreads,
                         DecTiling<MB>::kSmem, stream, static_cast<const __nv_bfloat16*>(x),
                         static_cast<const uint8_t*>(packed), static_cast<const float*>(scale),
                         static_cast<__nv_bfloat16*>(out), partial, m, k, n, group, plan.unit);
  if (err != cudaSuccess) return err;
  return sum_splits(partial, out, m, n, plan.splits, stream);
}

// ---- block tiling: M > 16, wgmma fed by TMA ---------------------------------------

// A CTA owns kBlkCols = 128 output columns and BN tokens. Consumer
// warpgroup wg takes columns 64 wg .. + 63 as one m64 wgmma tile (the
// dequantized weight is A, from registers) against all BN tokens (x is B,
// from shared memory, shared by both); one producer warp keeps TMA loads in
// flight.
constexpr int kBlkCols = 128;                  // output columns (= bytes of a packed row) per CTA
constexpr int kBlkKC = 64;                     // K rows per stage: one 128-byte x row
constexpr int kBlkPR = kBlkKC / 2;             // packed rows per stage
constexpr int kBlkWBytes = kBlkPR * kBlkCols;  // the packed tile of a stage: one box, 4 KB
constexpr int kBlkConsumers = kBlkCols / 64;            // consumer warpgroups, 64 columns each
constexpr int kBlkThreads = 128 * (kBlkConsumers + 1);  // and the producer warpgroup
// registers a thread after setmaxnreg: the producer gives its share to the
// consumers (128 * 40 + 256 * 232 <= 65536)
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

template <int BN>
struct BlkTiling {
  static constexpr int kAcc = BN / 2;           // f32 per thread of the m64 x BN tile
  static constexpr int kXBytes = BN * 128;      // the x tile of a stage: BN rows of 128 B
  static constexpr int kStageBytes = kXBytes + kBlkWBytes;
  static constexpr int kStages = 8;
  // the ring, its full and empty barriers, and slack to align the ring to
  // the 1024-byte period of the 128-byte swizzle
  static constexpr int kSmem = kStages * kStageBytes + 16 * kStages + 1024;
  static_assert(kXBytes % 1024 == 0, "stages must keep the swizzle's 1024-byte alignment");
};

// Two packed bytes (the low 16 bits of w) -> two bf16 pairs, as int4_quad
// does for four, with the nibble mask and the exponent of 128.0 applied by
// one lop3 (0x43004300 kept in a register).
__device__ __forceinline__ void int4_pair(uint32_t w, uint32_t* r) {
  const uint32_t w4 = w >> 4;
  const __nv_bfloat162 off = __floats2bfloat162_rn(136.f, 136.f);
  uint32_t exp128;
  asm("mov.b32 %0, 0x43004300;\n" : "=r"(exp128));
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    uint32_t t;
    asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n"  // (a & b) | c
        : "=r"(t)
        : "r"(__byte_perm(w, w4, 0x4400u + 0x1111u * j)), "n"(0x000F000F), "r"(exp128));
    __nv_bfloat162 v = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&t), off);
    r[j] = *reinterpret_cast<uint32_t*>(&v);
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed (a
// fresh barrier counts its phase of parity 1 as complete). The loop stays
// inside the asm block (its labels are local to the block).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// Arrive on the barrier from the threads with `arrive` set: a predicate,
// not a branch, so the consumers' wgmma path has no divergent code.
__device__ __forceinline__ void mbar_arrive_if(uint32_t bar, bool arrive) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(bar),
      "r"(static_cast<int>(arrive))
      : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// One 2-D TMA box into shared memory; completion counts on `bar`. Rows and
// columns outside the tensor arrive as zeros.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed wgmma groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Descriptor of a K-major B operand in shared memory with the 128-byte
// swizzle (as TMA writes it): rows of 128 bytes, 8-row atoms 1024 bytes
// apart. A k-step of 16 bf16 moves the start address by 32 bytes (+2).
__device__ __forceinline__ uint64_t b_desc(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

// Byte `col` of row `row` of a TMA box with the 128-byte swizzle: 16-byte
// chunk c of row r lies at chunk c ^ (r % 8) (the box is 1024-byte aligned).
__device__ __forceinline__ int swz128(int row, int col) {
  return row * 128 + ((((col >> 4) ^ row) & 7) << 4) + (col & 15);
}

// d (+)= A [64 x 16] bf16 from registers (m16n8k16's A layout per warp) *
// B [16 x N] bf16 in shared memory (desc); scale_d = 0 overwrites d.
template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], const uint32_t* a, uint64_t desc,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], const uint32_t* a, uint64_t desc,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <>
struct Wgmma<160> {
  static __device__ __forceinline__ void mma(float (&d)[80], const uint32_t* a, uint64_t desc,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79"
        "}, {%80, %81, %82, %83}, %84, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

// One CTA: kBlkCols columns (blockIdx.y) by BN tokens (blockIdx.x) over split
// blockIdx.z of K, in shares of `unit` rows as the decode kernel's. With
// `partial` null (one split) it stores bf16 into `out`; else its f32 sum
// into partial[split] for w4a16_split_sum.
//
// Warpgroup wg's warp w, lane (g, t): A rows 16 w + g and 16 w + g + 8
// serve columns cb and cb + 1, with cb = 64 wg + 16 w + 2 g, so the lane's
// bytes of a packed row are one aligned 16-bit word; a warp's reads of
// packed rows t = 0..3 fall in four different swizzled chunks, no bank
// twice. Its accumulators hold tokens 8 j + 2 t and + 1.
template <int BN>
__global__ void __launch_bounds__(kBlkThreads, 1)
    w4a16_block_kernel(const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap wmap, const float* __restrict__ scale,
                       __nv_bfloat16* __restrict__ out, float* __restrict__ partial, int m, int k,
                       int n, int group, int unit) {
  using Tl = BlkTiling<BN>;
  constexpr int kS = Tl::kStages;
  constexpr int kAcc = Tl::kAcc;
  constexpr int kSteps = kBlkKC / 16;  // k-steps per stage
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  const unsigned char* smem = smem_raw + (ring - raw);
  const uint32_t full0 = ring + kS * Tl::kStageBytes;  // full[s] at full0 + 8 s
  const uint32_t empty0 = full0 + 8 * kS;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  // the warp index through a shuffle, so the compiler knows it is uniform
  // across the warp and the role branch below is not divergent for wgmma
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int m0 = blockIdx.x * BN;
  const int n0 = blockIdx.y * kBlkCols;
  const int split = blockIdx.z;
  const int splits = gridDim.z;
  const int units = k / unit;
  const int kb = split * units / splits * unit;  // this split's K rows: [kb, ke)
  const int ke = (split + 1) * units / splits * unit;
  const int steps = (ke - kb) / 16;
  const int n_chunks = (steps + kSteps - 1) / kSteps;

  if (tid == 0) {
    for (int s = 0; s < kS; ++s) {
      mbar_init(full0 + 8 * s, 1);                   // the producer's expect_tx
      mbar_init(empty0 + 8 * s, 4 * kBlkConsumers);  // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // launched as a programmatic dependent (launch_dependent): wait for the
  // stream's previous kernel before touching global memory
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  if (warp >= 4 * kBlkConsumers) {
    // producer: stage c holds x[m0 .. m0 + BN, kc0 .. kc0 + 64] and the
    // 32 packed rows from kc0 / 2 of the CTA's columns
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == 4 * kBlkConsumers && lane == 0) {
      for (int c = 0; c < n_chunks; ++c) {
        const int s = c % kS;
        mbar_wait(empty0 + 8 * s, ((c / kS) & 1) ^ 1);
        mbar_expect_tx(full0 + 8 * s, Tl::kStageBytes);
        const uint32_t dst = ring + s * Tl::kStageBytes;
        const int kc0 = kb + c * kBlkKC;
        tma_load_2d(dst, &xmap, full0 + 8 * s, kc0, m0);
        tma_load_2d(dst + Tl::kXBytes, &wmap, full0 + 8 * s, n0, kc0 / 2);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = warp >> 2;
  const int w = warp & 3;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int cb = 64 * wg + 16 * w + 2 * gid;  // the lane's two columns (and packed bytes)
  const bool col_ok = n0 + cb < n;             // both or neither (N % 16 == 0)

  float part[kAcc];  // the running group's sum, unscaled (written by wgmma)
  float acc[kAcc];   // the scaled total
#pragma unroll
  for (int e = 0; e < kAcc; ++e) part[e] = acc[e] = 0.f;
  // the lane's scale row, clamped into the tensor for lanes past N (whose
  // sums are never stored), so every lane loads without a branch
  const float* scol = scale + min(n0 + cb, n - 2);
  // K rows 2t, 2t+1 (packed row t) and 2t+8, 2t+9 (row t + 4) of the
  // lane's two columns, k-step h of stage buffer `ws`: A rows g (column
  // cb) and g + 8 (cb + 1)
  auto dequant = [&](const unsigned char* ws, int h, uint32_t* a) {
    int4_pair(*reinterpret_cast<const uint16_t*>(ws + swz128(8 * h + tig, cb)), a);
    int4_pair(*reinterpret_cast<const uint16_t*>(ws + swz128(8 * h + tig + 4, cb)), a + 2);
  };
  int g_cur = kb / group;         // the running group
  int left = group - kb % group;  // its K rows from the next k-step on
  float2 sv = make_float2(0.f, 0.f);  // its scales, columns cb and cb + 1
  bool pending = false;               // part holds rows not folded yet
  bool paired = false;  // the previous k-step's fragments were made with this one's

  // k-steps go to the tensor cores in pairs behind one fence and one commit
  // (a pair never spans a group's end): a pair's products run while the
  // next pair is dequantized into the other half of abuf
  uint32_t abuf[2][8];
  for (int c = 0; c < n_chunks; ++c) {
    const int s = c % kS;
    mbar_wait(full0 + 8 * s, (c / kS) & 1);
    const unsigned char* ws = smem + s * Tl::kStageBytes + Tl::kXBytes;
    const uint64_t desc = b_desc(ring + s * Tl::kStageBytes);
#pragma unroll
    for (int h = 0; h < kSteps; ++h) {
      const int ks = c * kSteps + h;
      if (ks >= steps) break;
      uint32_t* a = abuf[h / 2] + 4 * (h & 1);
      if (!pending) {
        sv = __ldg(reinterpret_cast<const float2*>(scol + static_cast<size_t>(g_cur) * n));
      }
      bool commit = true;
      if (!paired) {
        dequant(ws, h, a);
        // an even k-step takes the next one along when both lie in this
        // group and this share
        if ((h & 1) == 0 && ks + 1 < steps && left > 16) {
          dequant(ws, h + 1, a + 4);
          commit = false;
        }
        wgmma_fence();
      }
      Wgmma<BN>::mma(part, a, desc + 2 * h, pending);
      paired = !commit;
      pending = true;
      left -= 16;
      if (commit) {
        wgmma_commit();
        if (left == 0 || ks == steps - 1) {
          // the group (or the share) ends here: fold it in, times its scales
          wgmma_wait<0>();
#pragma unroll
          for (int e = 0; e < kAcc; ++e) acc[e] += part[e] * ((e & 2) ? sv.y : sv.x);
          pending = false;
          if (left == 0) {
            ++g_cur;
            left = group;
          }
        } else {
          wgmma_wait<1>();  // the previous pair's products are done
        }
      }
      // every product reading the previous stage is done once the first
      // commit of this stage has waited for what came before: hand it back
      if (h == 1 && c > 0) mbar_arrive_if(empty0 + 8 * ((c - 1) % kS), lane == 0);
    }
  }

  if (!col_ok) return;
  // accumulator e of 8-token block j: token 8 j + 2 t + (e & 1), A row
  // g + 8 (e >> 1): column cb + (e >> 1)
  float* split_out = partial ? partial + static_cast<size_t>(split) * m * n : nullptr;
  const int tok0 = m0 + 2 * tig;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int odd = 0; odd < 2; ++odd) {
      const int tok = tok0 + 8 * j + odd;
      if (tok >= m) continue;
      const float v0 = acc[4 * j + odd], v1 = acc[4 * j + 2 + odd];
      const size_t at = static_cast<size_t>(tok) * n + n0 + cb;
      if (split_out) {
        *reinterpret_cast<float2*>(split_out + at) = make_float2(v0, v1);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(out + at) = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// cuTensorMapEncodeTiled from the CUDA driver API, found at run time, so the library
// needs no link against libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A row-major [outer, inner] tensor of `row_bytes` per row, read in boxes of
// [box_outer, box_inner] with the 128-byte swizzle; outside reads give zeros.
cudaError_t tensor_map_2d(CUtensorMap* map, CUtensorMapDataType type, const void* ptr,
                          uint64_t inner, uint64_t outer, uint64_t row_bytes, uint32_t box_inner,
                          uint32_t box_outer) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult r = encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box,
                            elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The token tile: one tile covers all of M up to 64 rows (those calls are
// bound by bytes, so each packed byte is read once; up to 32 rows, as the
// verify lm_head's gathered rows at spec_k 2-3, a 32-token tile takes 1-4%
// less time on an H100 than a 64-token one), 160 above (the widest the
// registers hold: a sum and a group's partial sum, 80 f32 each).
int block_tokens(int m) { return m <= 32 ? 32 : m <= 64 ? 64 : 160; }

// The split of K for a block call, over its CTA tiles of 128 columns by BN
// tokens (at M = 312, two token tiles: 16 tiles for wk/wv, split 8 ways;
// 64 for wq/wo and w_down, split 2 ways; 224 for w_gate/w_up, not split),
// each share at least four stages of K.
template <int BN>
cudaError_t block_plan(int m, int k, int n, int group, SplitPlan* plan) {
  int resident = 0;
  const cudaError_t err =
      resident_ctas<w4a16_block_kernel<BN>>(kBlkThreads, BlkTiling<BN>::kSmem, &resident);
  if (err == cudaSuccess) {
    // a wave or more of tiles takes one split: clamped there, the count fits an int
    const long long tiles = 1LL * ((n + kBlkCols - 1) / kBlkCols) * ((m + BN - 1) / BN);
    *plan = split_plan(static_cast<int>(std::min<long long>(tiles, resident)), k, group,
                       4 * kBlkKC, resident);
  }
  return err;
}

template <int BN>
cudaError_t launch_block(const void* x, const void* packed, const void* scale, void* out,
                         void* workspace, long long workspace_bytes, int m, int k, int n,
                         int group, cudaStream_t stream) {
  SplitPlan plan;
  cudaError_t err = block_plan<BN>(m, k, n, group, &plan);
  float* partial = nullptr;
  if (err == cudaSuccess) err = split_partials(plan, m, n, workspace, workspace_bytes, &partial);
  CUtensorMap xmap, wmap;
  if (err == cudaSuccess) {
    err = tensor_map_2d(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, k, m, 2ull * k, kBlkKC, BN);
  }
  if (err == cudaSuccess) {
    err = tensor_map_2d(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, packed, n, k / 2, n, kBlkCols,
                        kBlkPR);
  }
  if (err != cudaSuccess) return err;
  err = launch_dependent(w4a16_block_kernel<BN>,
                         dim3((m + BN - 1) / BN, (n + kBlkCols - 1) / kBlkCols, plan.splits),
                         kBlkThreads, BlkTiling<BN>::kSmem, stream, xmap, wmap,
                         static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out),
                         partial, m, k, n, group, plan.unit);
  if (err != cudaSuccess) return err;
  return sum_splits(partial, out, m, n, plan.splits, stream);
}

// The plan of the call (m, k, n, group): the tiling its row count takes.
cudaError_t call_plan(int m, int k, int n, int group, SplitPlan* plan) {
  if (m <= 8) return decode_plan<1>(k, n, group, plan);
  if (m <= 16) return decode_plan<2>(k, n, group, plan);
  const int bn = block_tokens(m);
  return bn == 32   ? block_plan<32>(m, k, n, group, plan)
         : bn == 64 ? block_plan<64>(m, k, n, group, plan)
                    : block_plan<160>(m, k, n, group, plan);
}

// The wrapper's gates; a row count past a 32-bit int (KERNEL_MAX_ROWS) cannot
// reach here. The block tiling puts column tiles on grid y (KERNEL_MAX_COLS).
bool bad_args(int m, int k, int n, int group) {
  return m < 0 || k <= 0 || n <= 0 || group <= 0 || group % 16 || k % group || n % 16 ||
         n > 65535 * kBlkCols;
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
  if (m == 0) return static_cast<int>(cudaSuccess);
  SplitPlan plan;
  const cudaError_t err = call_plan(m, k, n, group, &plan);
  if (err == cudaSuccess && plan.splits > 1) *bytes = 4LL * plan.splits * m * n;
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
  const auto launch = m <= 8                    ? launch_decode<1>
                      : m <= 16                 ? launch_decode<2>
                      : block_tokens(m) == 32   ? launch_block<32>
                      : block_tokens(m) == 64   ? launch_block<64>
                                                : launch_block<160>;
  const cudaError_t err =
      launch(x, packed, scale, out, workspace, workspace_bytes, m, k, n, group, s);
  return static_cast<int>(err);
}
