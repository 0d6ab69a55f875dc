// Paged GQA decode attention for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel clearml_serving_tpu/ops/paged_attention.py::
// paged_attention (body _paged_attention_kernel, pallas_call at :399). Same
// contract: one query token per sequence, the G query heads of a KV head
// attend over that head's pages through the page table, up to lengths[b].
//
//   q           [B, Hkv, G, D]  bf16
//   k/v pools   [Hkv, N, P, D]  bf16, or int8 with f32 scales [Hkv, N, P]
//   page_table  [B, PP]         int32 (entries at or past the length are
//                                never read and may hold anything)
//   lengths     [B]             int32
//   out         [B, Hkv, G, D]  bf16
//
// The kernel applies D**-0.5 itself (the caller folds any query_scale into
// q). Rows with length 0 give zeros. For int8 pools the K scale multiplies
// the f32 scores per key, the V scale multiplies the probabilities before
// the PV product, and the softmax denominator sums the unscaled
// probabilities, as in the TPU kernel.
//
// What bounds it: the K/V bytes. Every live token's K and V rows are read
// once (2*D bytes each in bf16, D in int8), against 4*G*D FLOPs per token,
// so the floor is bytes / 3.35 TB/s on an H100 SXM. At B=8, Hkv=8, D=128
// and 1024 live tokens per row that is 33.5 MB, about 10 us in bf16. To
// reach it the card needs every SM busy and a few MB in flight at once.
// Measured on an H100 (CUDA graphs; scripts/torch_kernel_ab.py, PERF.md):
// a call has a fixed cost of about 8 us (two grids, the length and
// page-table reads ahead of the first copy, the combine: 8 rows of 96
// tokens take that long), past which bf16 pools stream at close to the
// card's rate. int8 pools stay further from theirs: widening every code to
// bf16 costs instructions on the path of each tile (a development build
// that skipped it, with wrong results, ran markedly faster).
//
// Design (flash-decoding). The TPU kernel walks a row's pages in one grid
// step after another on one core; here the key range is split instead:
//
// 1. paged_split_kernel, grid (B*Hkv, S). CTA (bh, s) takes the tokens
//    [s*span, (s+1)*span) of its row, span a multiple of kSpanQuantum (64:
//    four warps' 16-token tiles, and a multiple of both page sizes). S and
//    span come from the host (ops/paged_attention.py::split_plan) from
//    shapes alone, so no length is read on the host. A CTA whose span starts
//    at or past its row's length writes the empty partial (m = -inf, l = 0;
//    its acc is never read) and exits.
// 2. Each of the CTA's 4 warps takes every 4th 16-token tile of the span
//    and runs its own online softmax over them, with its own ring of
//    kStages stages and one mbarrier per stage: no block barrier until the
//    warps' states are merged once at the end. A tile lies inside one page,
//    so its K rows are one contiguous block of the pool, and so are its V
//    rows. Lane 0 fetches them with Hopper's bulk tensor copies (TMA,
//    cp.async.bulk.tensor ... mbarrier::complete_tx::bytes): the pool is a
//    2-D tensor of Hkv*N*P rows, a tile side one or two boxes of 16 rows by
//    128 bytes (64 for int8 at D=64), written with the swizzle of that
//    width so that ldmatrix and word reads of 8 rows at one column hit 8
//    different banks; for int8, one 1-D bulk copy each brings the tile's 16
//    K and V scales. Not a 1-D bulk copy per page: its rows would land 2*D
//    bytes apart, unswizzled, and those 8-row reads would hit one bank 8
//    times over. Not one 1-D copy per row either: a first draft did that
//    (32 copies a tile, rows padded by 16 bytes); in development builds on
//    an H100 the boxes took less time on int8 pools and the same on bf16.
//    Three stages per warp put up to 12 tiles (96 KB in bf16 at D=128) in
//    flight per CTA.
// 3. QK^T and PV on mma.sync m16n8k16 (bf16 in, f32 sums), the G query
//    heads as the rows of a 16-row tile (rows past G are zero), bf16 K/V
//    fragments by ldmatrix (.trans for V), the score fragments reused in
//    registers as PV's A operand; the softmax runs in the log2 domain
//    (exp2f). int8 codes become bf16 (exactly) as their fragments are read,
//    one 32-bit word of four codes at a time, by bit operations and a bf16x2
//    subtraction (i8pair_to_bf16x2) rather than the quarter-rate conversion
//    pipe (I2F, F2F).
// 4. The CTA merges its warps in warp order and writes an f32 partial
//    (acc unnormalised, m, l) per (b, h, split, head).
// 5. paged_combine_kernel, grid B*Hkv, merges the splits in split order with
//    no atomics: M = max m_s, out = sum e^(m_s - M) acc_s / sum e^(m_s - M)
//    l_s, a sum of 0 giving 0; two calls give the same bits. Both kernels
//    are launched as programmatic dependents (launch_dependent), so the
//    combine's launch overlaps the split kernel's run.
//
// Page-table entries past the length are never read, and no page past it
// is copied; the row's last tile may bring rows of its own page past the
// length (a box is 16 rows). There the V rows past the length are zeroed
// in shared memory (a row never written could hold NaN, and 0 * NaN is
// NaN in the product); scores past it are selected to -inf and their
// probabilities to 0, so those K rows and scales reach no sum.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 16;   // tokens per stage (rows of a TMA box)
constexpr int kStages = 3;  // ring stages per warp
constexpr int kSpanQuantum = kWarps * kTile;  // a split's span is a multiple of this
constexpr int kMaxG = 8;
constexpr int kCombineThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kSpanQuantum % 32 == 0, "a span holds whole pages of 16 and of 32 tokens");

template <bool INT8>
struct KvType {
  using T = __nv_bfloat16;
};
template <>
struct KvType<true> {
  using T = int8_t;
};

// Shared-memory layout of one warp's stage: the tile's K rows, its V rows,
// then (int8) its K and V scales. Each side is kBoxes TMA boxes of kTile
// rows by kBoxBytes (128, or an int8 row of 64), written with the swizzle
// of that width, so ldmatrix and word reads of 8 rows at one column hit 8
// different banks. Stages start on 1024-byte boundaries (the swizzle's
// period).
template <int D, bool INT8>
struct Stage {
  using T = typename KvType<INT8>::T;
  static constexpr int kRowBytes = D * static_cast<int>(sizeof(T));
  static constexpr int kBoxBytes = kRowBytes < 128 ? kRowBytes : 128;
  static constexpr int kBoxes = kRowBytes / kBoxBytes;
  static constexpr int kBoxInner = kBoxBytes / static_cast<int>(sizeof(T));  // elements
  static constexpr int kBoxSmem = kTile * kBoxBytes;
  static constexpr int kSide = kBoxes * kBoxSmem;
  static constexpr int kScaleOff = 2 * kSide;
  static constexpr int kBytes = (kScaleOff + (INT8 ? 2 * kTile * 4 : 0) + 1023) / 1024 * 1024;
  static constexpr int kSmem = kWarps * kStages * kBytes + 1024;  // + alignment slack
  static_assert(kBoxBytes == 128 || kBoxBytes == 64, "a swizzle of 128 or 64 bytes");
};

// Byte offset of byte c of row r of one side of a stage: box c / kBoxBytes,
// its 16-byte chunk index XOR the row's bits, as TMA's swizzle writes it
// (r & 7 for 128-byte box rows, (r >> 1) & 3 for 64-byte ones).
template <int D, bool INT8>
__device__ __forceinline__ int swz(int r, int c) {
  using St = Stage<D, INT8>;
  const int cb = c % St::kBoxBytes;
  const int x = St::kBoxBytes == 128 ? (r & 7) : ((r >> 1) & 3);
  return (c / St::kBoxBytes) * St::kBoxSmem + r * St::kBoxBytes +
         ((((cb >> 4) ^ x) << 4) | (cb & 15));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// One 2-D TMA box into shared memory; completion counts on `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// One contiguous copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from global to shared memory; completion counts on `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Two floats as a bf16 pair, `lo` in the low half (the lower k or n index).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two int8 codes, in bits 0-7 and 16-23 of x (other bits ignored), as a
// bf16 pair, exactly, with two LOP3s and one bf16x2 subtraction (the
// conversion pipe, I2F and F2F, runs at a quarter of the ALU rate and
// would bound the int8 path): code c becomes the bf16 0x4300 | (c & 0x7F),
// that is 128 + (c & 127), minus 128 for c >= 0 and 256 for c < 0 (the
// bf16 0x4300 | sign << 7).
__device__ __forceinline__ uint32_t i8pair_to_bf16x2(uint32_t x) {
  const uint32_t v = (x & 0x007F007Fu) | 0x43004300u;
  const uint32_t b = (x & 0x00800080u) | 0x43004300u;
  const __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v),
                                   *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&r);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
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

// The head dim of column n (0..7) of output tile dt: plain for bf16 pools;
// int8 pools interleave four tiles over 32 dims, so a lane's column in
// tiles 4q .. 4q + 3 is one 4-byte word of a V row (dims 32q + 4n .. +3).
template <bool INT8>
__device__ __forceinline__ int out_col(int dt, int n) {
  return INT8 ? (dt / 4) * 32 + n * 4 + dt % 4 : dt * 8 + n;
}

// Partials of a call: acc [B*Hkv, S, G, D] f32 (unnormalised), m and l
// [B*Hkv, S, G] f32 (m in log2 units).
struct Partials {
  float* acc;
  float* m;
  float* l;
};

template <int D, bool INT8>
__global__ void __launch_bounds__(kThreads)
    paged_split_kernel(const __nv_bfloat16* __restrict__ q,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const float* __restrict__ k_scale, const float* __restrict__ v_scale,
                       const int* __restrict__ page_table, const int* __restrict__ lengths,
                       Partials part, int hkv, int groups, int n_pages, int page_shift,
                       int pages_per_seq, int span, float score_scale) {
  using St = Stage<D, INT8>;
  constexpr int kKSteps = D / 16;  // QK^T k-steps over the head dim
  constexpr int kDT = D / 8;       // 8-column output tiles
  constexpr int kNT = kTile / 8;   // 8-key score tiles per stage
  static_assert(kTile == 16, "PV takes one 16-key k-step per stage");

  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[kWarps * kStages];

  const int bh = blockIdx.x;
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const int b = bh / hkv;
  const int h = bh % hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;  // mma fragment row: query head gid
  const int tig = lane & 3;   // mma fragment column pair
  const int page_size = 1 << page_shift;

  // launched as a programmatic dependent (launch_dependent): wait for the
  // stream's previous kernel before touching global memory; then let the
  // combine kernel be scheduled (it waits for this grid to finish)
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  const size_t part_row = static_cast<size_t>(bh) * splits + split;
  // tokens past the table's capacity do not exist (as in the reference)
  const int length = min(lengths[b], pages_per_seq * page_size);
  const int t_begin = split * span;
  if (t_begin >= length) {
    if (tid < groups) {
      part.m[part_row * groups + tid] = -INFINITY;
      part.l[part_row * groups + tid] = 0.f;
    }
    return;
  }
  const int t_end = min(t_begin + span, length);
  const int n_tiles = (t_end - t_begin + kTile - 1) / kTile;
  // this warp's tiles: j = warp, warp + kWarps, ...
  const int my_tiles = n_tiles > warp ? (n_tiles - warp + kWarps - 1) / kWarps : 0;
  const int* table = page_table + static_cast<size_t>(b) * pages_per_seq;
  const int head_rows = h * n_pages * page_size;  // < 2^31: checked on the host

  unsigned char* stages = smem + ((1024 - (smem_u32(smem) & 1023)) & 1023);
  unsigned char* my_stages = stages + warp * kStages * St::kBytes;
  const uint32_t bar0 = smem_u32(&bars[warp * kStages]);
  if (lane == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bar0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();

  // the pages of the warp's first 32 tiles, one per lane, read together
  // (a read before each copy would add a round trip to each)
  const int my_page =
      lane < my_tiles ? table[(t_begin + (warp + lane * kWarps) * kTile) >> page_shift] : 0;

  // Start the copies of the warp's i-th tile into stage i % kStages, from
  // lane 0: the tile's 16 pool rows (inside one live page) as kBoxes TMA
  // boxes a side, and for int8 its 16 K and V scales (64 bytes each).
  // Called by the whole warp (the page comes by shuffle).
  auto fetch = [&](int i) {
    const int t0 = t_begin + (warp + i * kWarps) * kTile;
    const int shared_page = __shfl_sync(0xffffffffu, my_page, i & 31);
    if (lane != 0) return;
    const int page = i < 32 ? shared_page : table[t0 >> page_shift];
    const int st = i % kStages;
    const uint32_t bar = bar0 + 8 * st;
    const int row0 = head_rows + (page << page_shift) + (t0 & (page_size - 1));
    mbar_expect_tx(bar, 2 * St::kSide + (INT8 ? 2 * kTile * 4 : 0));
    const uint32_t dst = smem_u32(my_stages + st * St::kBytes);
#pragma unroll
    for (int bx = 0; bx < St::kBoxes; ++bx) {
      tma_load_2d(dst + bx * St::kBoxSmem, &kmap, bar, bx * St::kBoxInner, row0);
      tma_load_2d(dst + St::kSide + bx * St::kBoxSmem, &vmap, bar, bx * St::kBoxInner, row0);
    }
    if constexpr (INT8) {
      bulk_copy(dst + St::kScaleOff, k_scale + row0, kTile * 4, bar);
      bulk_copy(dst + St::kScaleOff + kTile * 4, v_scale + row0, kTile * 4, bar);
    }
  };

#pragma unroll
  for (int i = 0; i < kStages; ++i) {
    if (i < my_tiles) fetch(i);
  }

  // the warp's query heads as mma A fragments (rows gid; rows 8-15 and
  // heads past `groups` are zero). A k-step's 16 head dims are taken in
  // the order the B fragments hold them: bf16 K comes by ldmatrix in plain
  // order (lane pair tig*2, +1 and tig*2 + 8, +9); an int8 lane reads one
  // 32-bit word of dims tig*4 .. tig*4 + 3, so its fragment pairs are those
  // (the dot product does not depend on the order of its terms).
  uint32_t qf[kKSteps][2];
  {
    const __nv_bfloat16* qrow =
        gid < groups ? q + (static_cast<size_t>(bh) * groups + gid) * D : nullptr;
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
      const int c0 = ks * 16 + (INT8 ? tig * 4 : tig * 2);
      const int c1 = c0 + (INT8 ? 2 : 8);
      qf[ks][0] = qrow ? *reinterpret_cast<const uint32_t*>(qrow + c0) : 0u;
      qf[ks][1] = qrow ? *reinterpret_cast<const uint32_t*>(qrow + c1) : 0u;
    }
  }

  float m_run = -INFINITY;  // row gid's running max (log2 units)
  float l_run = 0.f;
  float acc[kDT][4];
#pragma unroll
  for (int dt = 0; dt < kDT; ++dt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;
  }

  for (int i = 0; i < my_tiles; ++i) {
    const int st = i % kStages;
    const int t0 = t_begin + (warp + i * kWarps) * kTile;
    const int rows = min(kTile, t_end - t0);
    unsigned char* stage = my_stages + st * St::kBytes;
    [[maybe_unused]] const float* ks_s = reinterpret_cast<const float*>(stage + St::kScaleOff);
    [[maybe_unused]] const float* vs_s = ks_s + kTile;
    mbar_wait(bar0 + 8 * st, (i / kStages) & 1);
    if constexpr (!INT8) {
      if (rows < kTile) {  // the row's last tile: zero the V rows past the length
        for (int c = lane; c < (kTile - rows) * (St::kRowBytes / 16); c += 32) {
          const int r = rows + c / (St::kRowBytes / 16);
          const int col = c % (St::kRowBytes / 16);
          *reinterpret_cast<uint4*>(stage + St::kSide + swz<D, INT8>(r, col * 16)) =
              make_uint4(0u, 0u, 0u, 0u);
        }
        __syncwarp();
      }
    }

    // scores S = Q K^T, [16 rows x 16 keys]; only rows 0-7 are heads. Odd
    // k-steps sum into s2, so two mma chains run side by side.
    float s[kNT][4], s2[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = s2[nt][e] = 0.f;
      if constexpr (INT8) {
#pragma unroll
        for (int ks = 0; ks < kKSteps; ++ks) {
          // codes c0..c3 of dims tig*4 ..: bytes (c0, c2, c1, c3), so the
          // pairs (c0, c1) and, shifted by 8, (c2, c3) sit in bits 0-7, 16-23
          const uint32_t w = __byte_perm(
              *reinterpret_cast<const uint32_t*>(stage + swz<D, INT8>(nt * 8 + gid,
                                                                      ks * 16 + tig * 4)),
              0u, 0x3120u);
          const uint32_t a[4] = {qf[ks][0], 0u, qf[ks][1], 0u};
          mma_bf16((ks & 1) ? s2[nt] : s[nt], a, i8pair_to_bf16x2(w), i8pair_to_bf16x2(w >> 8));
        }
      } else {
        // matrices j = 0..3: keys nt*8.. x head-dim columns 8j.. of a
        // 32-column slab: the B fragments of two k-steps
#pragma unroll
        for (int kp = 0; kp < kKSteps / 2; ++kp) {
          uint32_t bfr[4];
          ldmatrix_x4(bfr, smem_u32(stage) +
                               swz<D, INT8>(nt * 8 + (lane & 7), kp * 64 + (lane >> 3) * 16));
          const uint32_t a0[4] = {qf[2 * kp][0], 0u, qf[2 * kp][1], 0u};
          const uint32_t a1[4] = {qf[2 * kp + 1][0], 0u, qf[2 * kp + 1][1], 0u};
          mma_bf16(s[nt], a0, bfr[0], bfr[1]);
          mma_bf16(s2[nt], a1, bfr[2], bfr[3]);
        }
      }
    }

#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) s[nt][e] += s2[nt][e];
    }

    // scale (log2 units), mask past the length, online softmax in f32;
    // a row's values live in the four lanes of one quad
    float mx = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kc = nt * 8 + tig * 2 + e;
        float x = s[nt][e] * score_scale;
        if constexpr (INT8) x *= ks_s[kc];
        s[nt][e] = kc < rows ? x : -INFINITY;
        mx = fmaxf(mx, s[nt][e]);
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run, mx);  // finite: every tile holds a live key
    const float corr = exp2f(m_run - m_new);
    float sum = 0.f;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kc = nt * 8 + tig * 2 + e;
        s[nt][e] = kc < rows ? exp2f(s[nt][e] - m_new) : 0.f;
        sum += s[nt][e];
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l_run = l_run * corr + sum;
    m_run = m_new;
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt) {
      acc[dt][0] *= corr;
      acc[dt][1] *= corr;
    }

    // O += P V: the probabilities (int8: times the key's V scale, 0 past
    // the length) become the A fragment of one 16-key k-step
    float vs0 = 1.f, vs1 = 1.f, vs8 = 1.f, vs9 = 1.f;
    if constexpr (INT8) {
      const int kc = tig * 2;
      vs0 = kc < rows ? vs_s[kc] : 0.f;
      vs1 = kc + 1 < rows ? vs_s[kc + 1] : 0.f;
      vs8 = kc + 8 < rows ? vs_s[kc + 8] : 0.f;
      vs9 = kc + 9 < rows ? vs_s[kc + 9] : 0.f;
    }
    const uint32_t pa[4] = {pack_bf16(s[0][0] * vs0, s[0][1] * vs1), 0u,
                            pack_bf16(s[1][0] * vs8, s[1][1] * vs9), 0u};
    if constexpr (INT8) {
      // a lane reads 32-bit words of its four key rows (tig*2, +1, +8, +9):
      // output tile dt's column gid is head dim out_col(dt, gid), so the
      // word at dims 32*(dt/4) + 4*gid serves the lane's column in tiles
      // 4*(dt/4) .. +3
      const unsigned char* vt = stage + St::kSide;
      auto word = [&](int r, int c) {
        return *reinterpret_cast<const uint32_t*>(vt + swz<D, INT8>(r, c));
      };
#pragma unroll
      for (int dq = 0; dq < kDT / 4; ++dq) {
        const int c = dq * 32 + gid * 4;
        const uint32_t w0 = word(tig * 2, c), w1 = word(tig * 2 + 1, c);
        const uint32_t w8 = word(tig * 2 + 8, c), w9 = word(tig * 2 + 9, c);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // byte j of two rows into bits 0-7 and 16-23
          const uint32_t sel = j | ((4 + j) << 8);
          mma_bf16(acc[4 * dq + j], pa, i8pair_to_bf16x2(__byte_perm(w0, w1, sel)),
                   i8pair_to_bf16x2(__byte_perm(w8, w9, sel)));
        }
      }
    } else {
      // transposed matrices: keys 8*(j & 1).. x columns of output tiles
      // dp*2 + (j >> 1): the B fragments of two output tiles
      const uint32_t v0 = smem_u32(stage + St::kSide);
      const int vr = (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
      for (int dp = 0; dp < kDT / 2; ++dp) {
        uint32_t bfr[4];
        ldmatrix_x4_trans(bfr, v0 + swz<D, INT8>(vr, dp * 32 + (lane >> 4) * 16));
        mma_bf16(acc[2 * dp], pa, bfr[0], bfr[1]);
        mma_bf16(acc[2 * dp + 1], pa, bfr[2], bfr[3]);
      }
    }
    __syncwarp();  // every lane is done with this stage before it is refilled
    if (i + kStages < my_tiles) fetch(i + kStages);
  }

  // merge the warps' states in warp order (the stages are free: every copy
  // started has been waited for)
  __syncthreads();
  float* m_w = reinterpret_cast<float*>(stages);  // [kWarps][8]
  float* l_w = m_w + kWarps * 8;                  // [kWarps][8]
  float* a_w = l_w + kWarps * 8;                  // [kWarps][8][D]
  if (tig == 0) {
    m_w[warp * 8 + gid] = m_run;
    l_w[warp * 8 + gid] = l_run;
  }
#pragma unroll
  for (int dt = 0; dt < kDT; ++dt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      a_w[(warp * 8 + gid) * D + out_col<INT8>(dt, tig * 2 + e)] = acc[dt][e];
    }
  }
  __syncthreads();
  for (int c = tid; c < groups * (D / 4); c += kThreads) {
    const int g = c / (D / 4);
    const int d = (c % (D / 4)) * 4;
    float mx_all = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (l_w[w * 8 + g] > 0.f) mx_all = fmaxf(mx_all, m_w[w * 8 + g]);
    }
    float l_sum = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float lw = l_w[w * 8 + g];
      if (lw > 0.f) {
        const float wt = exp2f(m_w[w * 8 + g] - mx_all);
        const float4 x = *reinterpret_cast<const float4*>(a_w + (w * 8 + g) * D + d);
        l_sum += wt * lw;
        a.x += wt * x.x;
        a.y += wt * x.y;
        a.z += wt * x.z;
        a.w += wt * x.w;
      }
    }
    *reinterpret_cast<float4*>(part.acc + (part_row * groups + g) * D + d) = a;
    if (d == 0) {
      part.m[part_row * groups + g] = mx_all;
      part.l[part_row * groups + g] = l_sum;
    }
  }
}

// out = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s over the splits in
// order (M the largest m_s of a live split); a row with no live split gives
// zeros. A split with l = 0 (an empty span) weighs 0 and its acc is not
// read. The loops carry no branch and their loads do not depend on each
// other, so each pass is about one L2 round trip, not one per split.
template <int D>
__global__ void __launch_bounds__(kCombineThreads)
    paged_combine_kernel(Partials part, __nv_bfloat16* __restrict__ out, int groups,
                         int splits) {
  // launched as a programmatic dependent of the split kernel: wait for it
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int bh = blockIdx.x;
  for (int c = threadIdx.x; c < groups * (D / 4); c += kCombineThreads) {
    const int g = c / (D / 4);
    const int d = (c % (D / 4)) * 4;
    const size_t row0 = static_cast<size_t>(bh) * splits;
    float mx = -INFINITY;
#pragma unroll 8
    for (int s = 0; s < splits; ++s) {
      const size_t i = (row0 + s) * groups + g;
      const float m = __ldcg(part.m + i);
      mx = __ldcg(part.l + i) > 0.f ? fmaxf(mx, m) : mx;
    }
    float l_sum = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int s = 0; s < splits; ++s) {
      const size_t i = (row0 + s) * groups + g;
      const float l = __ldcg(part.l + i);
      const bool live = l > 0.f;
      const float wt = live ? exp2f(__ldcg(part.m + i) - mx) : 0.f;
      const float4 x = live ? __ldcg(reinterpret_cast<const float4*>(part.acc + i * D + d))
                            : make_float4(0.f, 0.f, 0.f, 0.f);
      l_sum += wt * l;
      a.x += wt * x.x;
      a.y += wt * x.y;
      a.z += wt * x.z;
      a.w += wt * x.w;
    }
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    if (l_sum > 0.f) o = make_float4(a.x / l_sum, a.y / l_sum, a.z / l_sum, a.w / l_sum);
    __nv_bfloat162* orow = reinterpret_cast<__nv_bfloat162*>(
        out + (static_cast<size_t>(bh) * groups + g) * D + d);
    orow[0] = __floats2bfloat162_rn(o.x, o.y);
    orow[1] = __floats2bfloat162_rn(o.z, o.w);
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

// cuTensorMapEncodeTiled (libcuda), looked up at run time, so the library
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

// A pool [Hkv, N, P, D] as a 2-D tensor of Hkv * N * P rows of D elements,
// read in boxes of kTile rows by kBoxInner elements with the swizzle of the
// box rows' width (Stage).
template <int D, bool INT8>
cudaError_t pool_map(CUtensorMap* map, const void* pool, long long rows) {
  using St = Stage<D, INT8>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(St::kRowBytes)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(St::kBoxInner),
                             static_cast<cuuint32_t>(kTile)};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult r = encode(
      map, INT8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
      const_cast<void*>(pool), dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      St::kBoxBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Launches `kernel` as a programmatic dependent of the stream's previous
// kernel: its CTAs may be scheduled while that kernel finishes (once all of
// that kernel's CTAs have run griddepcontrol.launch_dependents, or exited),
// and the kernel's griddepcontrol.wait, ahead of any global memory access,
// holds them until the previous kernel has completed and its stores are
// visible. The order of memory effects is the stream's; only the launch
// latency overlaps. The split kernel triggers at its start, so the combine
// kernel's launch overlaps the split kernel's run.
template <typename... Params, typename... Ts>
cudaError_t launch_dependent(void (*kernel)(Params...), dim3 grid, int threads, int smem,
                             cudaStream_t stream, Ts... args) {
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

// The last kMapCacheSize pool maps encoded, per kernel variant: a map
// depends only on the pool's address and row count (D and the dtype fix
// the rest), so a hit is always right, and an engine's calls (one K and one
// V pool per layer) skip the encoding's host time.
constexpr int kMapCacheSize = 128;

template <int D, bool INT8>
cudaError_t cached_pool_map(CUtensorMap* map, const void* pool, long long rows) {
  struct Entry {
    const void* pool;
    long long rows;
    CUtensorMap map;
  };
  static std::mutex mu;
  static Entry entries[kMapCacheSize] = {};
  static int next = 0;
  std::lock_guard<std::mutex> lock(mu);
  for (const Entry& e : entries) {
    if (e.pool == pool && e.rows == rows) {
      *map = e.map;
      return cudaSuccess;
    }
  }
  const cudaError_t err = pool_map<D, INT8>(map, pool, rows);
  if (err != cudaSuccess) return err;
  entries[next] = Entry{pool, rows, *map};
  next = (next + 1) % kMapCacheSize;
  return cudaSuccess;
}

struct Args {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const void* k_scale;
  const void* v_scale;
  const void* page_table;
  const void* lengths;
  void* out;
  Partials part;
  int batch, hkv, groups, n_pages, page_shift, pages_per_seq, splits, span;
};

template <int D, bool INT8>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using St = Stage<D, INT8>;
  static_assert(St::kSmem >= (2 * 8 + 8 * D) * kWarps * 4 + 1024, "the merge reuses the stages");
  static bool done[kMaxDevices] = {};
  auto split_kernel = paged_split_kernel<D, INT8>;
  cudaError_t err = opt_in(split_kernel, St::kSmem, done);
  if (err != cudaSuccess) return err;
  const long long rows = static_cast<long long>(a.hkv) * a.n_pages * (1 << a.page_shift);
  CUtensorMap kmap, vmap;
  err = cached_pool_map<D, INT8>(&kmap, a.k_pool, rows);
  if (err != cudaSuccess) return err;
  err = cached_pool_map<D, INT8>(&vmap, a.v_pool, rows);
  if (err != cudaSuccess) return err;
  const float score_scale =
      static_cast<float>(1.0 / sqrt(static_cast<double>(D))) * kLog2e;
  err = launch_dependent(split_kernel, dim3(a.batch * a.hkv, a.splits), kThreads, St::kSmem,
                         stream, static_cast<const __nv_bfloat16*>(a.q), kmap, vmap,
                         static_cast<const float*>(a.k_scale),
                         static_cast<const float*>(a.v_scale),
                         static_cast<const int*>(a.page_table),
                         static_cast<const int*>(a.lengths), a.part, a.hkv, a.groups, a.n_pages,
                         a.page_shift, a.pages_per_seq, a.span, score_scale);
  if (err != cudaSuccess) return err;
  return launch_dependent(paged_combine_kernel<D>, dim3(a.batch * a.hkv), kCombineThreads, 0,
                          stream, a.part, static_cast<__nv_bfloat16*>(a.out), a.groups,
                          a.splits);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// C entry point, bound with ctypes. Returns the cudaError_t of the launches
// (0 on success); the Python wrapper has checked shapes, types and gates.
// part_acc [B, Hkv, splits, G, D] and part_m / part_l [B, Hkv, splits, G]
// are f32 scratch; splits and span come from ops/paged_attention.py::
// split_plan: span a positive multiple of 64 and splits * span covering
// pages_per_seq * page_size, with no split wholly past it.
extern "C" int tpu_torch_paged_attention(const void* q, const void* k_pool, const void* v_pool,
                                         const void* k_scale, const void* v_scale,
                                         const void* page_table, const void* lengths, void* out,
                                         void* part_acc, void* part_m, void* part_l, int batch,
                                         int hkv, int groups, int head_dim, int n_pages,
                                         int page_size, int pages_per_seq, int kv_int8,
                                         int splits, int span, void* stream) {
  const long long capacity = static_cast<long long>(pages_per_seq) * page_size;
  if (groups < 1 || groups > kMaxG || (page_size != 16 && page_size != 32) ||
      (head_dim != 64 && head_dim != 128) || span <= 0 || span % kSpanQuantum != 0 ||
      splits < 1 || static_cast<long long>(splits) * span < capacity ||
      static_cast<long long>(splits - 1) * span >= (capacity > 0 ? capacity : 1) ||
      splits > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch * hkv == 0) return static_cast<int>(cudaSuccess);
  // pool rows are int32 TMA coordinates
  if (static_cast<long long>(hkv) * n_pages * page_size > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // TMA and bulk copies read 16-byte-aligned pools and 64-byte scale segments
  if (!aligned16(k_pool) || !aligned16(v_pool) || !aligned16(part_acc) || !aligned16(out) ||
      (kv_int8 && (!aligned16(k_scale) || !aligned16(v_scale)))) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const Args a{q,
               k_pool,
               v_pool,
               k_scale,
               v_scale,
               page_table,
               lengths,
               out,
               Partials{static_cast<float*>(part_acc), static_cast<float*>(part_m),
                        static_cast<float*>(part_l)},
               batch,
               hkv,
               groups,
               n_pages,
               page_size == 16 ? 4 : 5,
               pages_per_seq,
               splits,
               span};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (head_dim == 128) {
    err = kv_int8 ? launch<128, true>(a, s) : launch<128, false>(a, s);
  } else {
    err = kv_int8 ? launch<64, true>(a, s) : launch<64, false>(a, s);
  }
  return static_cast<int>(err);
}
