// Ragged paged attention for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel clearml_serving_tpu/ops/paged_attention.py::
// ragged_paged_attention (body _ragged_attention_kernel, pallas_call at
// :881). Same contract: one launch attends rows at mixed phases (prefill
// chunks, decode tokens) over the paged pools. The flat token axis is
// q-block aligned: every row's segment starts at a multiple of kQB, so each
// q block belongs to one row, named by block_rows / block_q0.
//
//   q            [T, Hkv, G, D]  bf16, T % kQB == 0
//   k/v pools    [Hkv, N, P, D]  bf16, or int8 with f32 scales [Hkv, N, P]
//   page_table   [R, PP]         int32 (entries past a row's causal bound
//                                 are never read and may hold anything)
//   kv_lens      [R]             tokens present per row, this step included
//   row_lens     [R]             query tokens per row (0 = idle)
//   block_rows   [T/kQB]         owning row per q block, -1 = no row
//   block_q0     [T/kQB]         in-row index of the block's first query
//   tree_anc     [T, DMAX]       optional int32 ancestor lists (below)
//   out          [T, Hkv, G, D]  bf16
//
// Query i of row r attends KV positions < kv_lens[r] - row_lens[r] + i + 1.
// Queries with q0 + i >= row_lens[r] and blocks no row owns give zeros.
//
// Draft-tree verify rows (the TPU kernel's `tree` branch, :701-722): with
// tree_anc, a query whose tree_anc[t, 0] is not -2 sees, inside that same
// causal limit, only the row's history (in-row offset t - base < 0) and the
// in-row offsets listed in its own tree_anc row (-1 pads). Queries with
// tree_anc[t, 0] == -2 stay plain causal. The node order is parent before
// child, so the causal limit still bounds every ancestor: trees change the
// mask inside the tiles already loaded, never the page walk. The variant is
// a template parameter (TREE), so the non-tree kernel is the code it was.
// Each thread reads the lists of its two fragment rows once, before the
// tile loop, into a plain flag and a 64-bit mask of allowed offsets 0..63;
// a listed offset of 64 or more (a row of more than 64 nodes) is found by
// scanning the list, a path no verify row of the engine takes. Only tiles
// that reach past the row's history (t0 + kTile > base) test the tree:
// the history tiles of a verify row run the plain loop. The mask moves no
// bytes: a tree launch has the bound of the same plain launch.
//
// The kernel applies D**-0.5 itself (the caller folds any query_scale into q).
// kernel applies D**-0.5 itself (the caller folds any query_scale into q).
// For int8 pools the K scale multiplies the f32 scores per key, the V scale
// multiplies the probabilities before the PV product, and the softmax
// denominator sums the unscaled probabilities, as in the TPU kernel
// (:680-744). Scales are read through the page table, one tile at a time,
// not pre-gathered per row as the TPU does (:839-860).
//
// Query block: kQB = 8 tokens (ops/paged_attention.py RAGGED_QB). With the
// G query heads of a KV head that is kQB * G = 32 rows at Llama-3-8B's G=4,
// two 16-row tensor-core tiles. The cost: a decode row (one query) owns a
// whole q block of the flat axis, so each launch carries max_batch*(kQB-1)
// pad tokens through every projection: 56 tokens at 8 decode rows, beside a
// 256-token step budget.
//
// What bounds it: a decode row reads its K/V once for 4*G*D FLOPs per key
// and head, so mixed launches of mostly decode rows are bound by bytes
// (3.35 TB/s). A prefill chunk of n tokens does n*G times the FLOPs per
// byte: a 512-token chunk at history 1536 is ~15 GFLOP against ~17 MB, so
// the tensor cores bound it (989 TFLOP/s bf16).
//
// Design (simple first): one CTA per (q block, KV head), kQB*G/16 warps,
// each warp owning 16 query rows (row = query * G + head). The CTA stages
// its row's page ids in shared memory once, then walks the row's pages only
// up to its causal bound min(kv_len, base + q0 + kQB), in 32-token tiles,
// with the decode kernel's double-buffered cp.async pipeline. QK^T and PV
// run on mma.sync m16n8k16 (bf16 in, f32 sums), bf16 fragments loaded with
// ldmatrix (.trans for V), the score fragments reused in registers as PV's
// A operand, and the online softmax held per row in f32. int8 codes become
// bf16 (exactly) as their fragments are loaded, element by element. Rows
// past the bound are zeroed in shared memory, so no NaN reaches a product.
//
// Known limits, left to later work: a long row's keys are walked by one
// CTA per q block, one tile after another, so a decode row at 1024 tokens
// is a 32-tile latency chain (splitting the key range across CTAs fixes
// that); every q block of a chunk re-reads the row's history (L2 absorbs
// most of it); no TMA, no wgmma; G is padded to a power of two (heads past
// `groups` compute on zero queries).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kQB = 8;     // query tokens per q block (ops/paged_attention.py RAGGED_QB)
constexpr int kTile = 32;  // KV tokens per pipeline stage: a multiple of the page size
constexpr int kMaxG = 8;
// page-table entries of the CTA's row staged in shared memory (4096 tokens
// at 16-token pages); entries past it are read from global memory
constexpr int kTableCap = 256;

template <bool INT8>
struct KvType {
  using T = __nv_bfloat16;
};
template <>
struct KvType<true> {
  using T = int8_t;
};

// GP: the query-head count rounded up to 1, 2, 4 or 8. Rows are
// (query, head) pairs, padded to one 16-row mma tile when kQB * GP < 16.
template <int GP>
struct Tiling {
  static constexpr int kM = kQB * GP;
  static constexpr int kWarps = kM >= 16 ? kM / 16 : 1;
  static constexpr int kThreads = 32 * kWarps;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most one committed group is still in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Two floats as a bf16 pair, `lo` in the low half (the lower k or n index).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two neighbouring elements of one K row as a bf16 pair.
__device__ __forceinline__ uint32_t k_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t k_pair(const int8_t* p) {
  return pack_bf16(static_cast<float>(p[0]), static_cast<float>(p[1]));
}

// One element of two V rows as a bf16 pair.
__device__ __forceinline__ uint32_t v_pair(const __nv_bfloat16* p0, const __nv_bfloat16* p1) {
  const uint32_t lo = *reinterpret_cast<const uint16_t*>(p0);
  const uint32_t hi = *reinterpret_cast<const uint16_t*>(p1);
  return lo | (hi << 16);
}
__device__ __forceinline__ uint32_t v_pair(const int8_t* p0, const int8_t* p1) {
  return pack_bf16(static_cast<float>(*p0), static_cast<float>(*p1));
}

// Four 8x8 b16 matrices from shared memory; lane i names row i % 8 of
// matrix i / 8. Without .trans lane t receives row t / 4, columns
// 2 * (t % 4) and +1 of each matrix; with .trans, of its transpose.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
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

// One query's draft-tree visibility: `plain` (no tree mask), or the
// allowed in-row offsets 0..63 as bits of `allow`, with `wide` set when its
// list also names offsets past 63 (found by scanning `anc`).
struct TreeRow {
  bool plain;
  bool wide;
  unsigned long long allow;
  const int* anc;
};

template <int D, bool INT8, int GP, bool TREE>
__global__ void __launch_bounds__(Tiling<GP>::kThreads)
    ragged_attention_kernel(const __nv_bfloat16* __restrict__ q,
                            const typename KvType<INT8>::T* __restrict__ k_pool,
                            const typename KvType<INT8>::T* __restrict__ v_pool,
                            const float* __restrict__ k_scale, const float* __restrict__ v_scale,
                            const int* __restrict__ page_table, const int* __restrict__ kv_lens,
                            const int* __restrict__ row_lens, const int* __restrict__ block_rows,
                            const int* __restrict__ block_q0, const int* __restrict__ tree_anc,
                            __nv_bfloat16* __restrict__ out, int hkv, int groups, int n_pages,
                            int page_shift, int pages_per_seq, int n_rows, int tree_width,
                            float sm_scale) {
  using T = typename KvType<INT8>::T;
  constexpr int kM = Tiling<GP>::kM;
  constexpr int kThreads = Tiling<GP>::kThreads;
  constexpr int kVec = 16 / sizeof(T);                 // elements per 16-byte copy
  constexpr int kChunksPerRow = D / kVec;              // 16-byte copies per K or V row
  constexpr int kStride = D + kVec;                    // padded row: rows shift by 4 banks
  constexpr int kCopies = kTile * kChunksPerRow / kThreads;  // per thread, per side
  constexpr int kKSteps = D / 16;                      // QK^T k-steps over the head dim
  constexpr int kNT = kTile / 8;                       // 8-key score tiles per stage
  constexpr int kDT = D / 8;                           // 8-column output tiles
  static_assert(kTile * kChunksPerRow % kThreads == 0, "tile copies must split evenly");
  static_assert(kThreads >= kTile, "the scale copies take one thread per token");

  // raw bytes: shared arrays of a class type (bf16) are declared untyped
  __shared__ __align__(16) unsigned char k_raw[2][kTile * kStride * sizeof(T)];
  __shared__ __align__(16) unsigned char v_raw[2][kTile * kStride * sizeof(T)];
  auto k_s = [&](int buf) { return reinterpret_cast<T*>(k_raw[buf]); };
  auto v_s = [&](int buf) { return reinterpret_cast<T*>(v_raw[buf]); };
  __shared__ float ks_s[2][kTile];
  __shared__ float vs_s[2][kTile];
  __shared__ int table_s[kTableCap];

  const int blk = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;  // mma fragment row (and row + 8)
  const int tig = lane & 3;   // mma fragment column pair
  const int page_size = 1 << page_shift;

  const int row_raw = block_rows[blk];
  const int q0 = block_q0[blk];
  int row_len = 0;
  int kv_len = 0;
  if (row_raw >= 0 && row_raw < n_rows) {
    row_len = row_lens[row_raw];
    kv_len = kv_lens[row_raw];
  }
  const int base = kv_len - row_len;  // absolute position of the row's query 0
  // causal bound of the block's last live query; tokens past the table's
  // capacity do not exist (as in the reference); a block with no live
  // query reads nothing
  int bound = 0;
  if (q0 < row_len) bound = max(0, min(min(kv_len, base + q0 + kQB), pages_per_seq * page_size));
  const int* table = page_table + static_cast<size_t>(row_raw < 0 ? 0 : row_raw) * pages_per_seq;
  const size_t head_rows = static_cast<size_t>(h) * n_pages * page_size;

  // this thread's two fragment rows (lo, hi = lo + 8) of the warp's tile
  const int r_lo = warp * 16 + gid;
  const int r_hi = r_lo + 8;
  auto q_row = [&](int r) -> const __nv_bfloat16* {
    if (r >= kM || r % GP >= groups) return nullptr;
    const size_t tok = static_cast<size_t>(blk) * kQB + r / GP;
    return q + ((tok * hkv + h) * groups + r % GP) * D;
  };
  // keys t < limit are visible to the row's query; 0 for dead rows
  auto limit = [&](int r) -> int {
    if (r >= kM || q0 + r / GP >= row_len) return 0;
    return min(base + q0 + r / GP + 1, bound);
  };
  const int lim_lo = limit(r_lo);
  const int lim_hi = limit(r_hi);

  // draft-tree rows: each fragment row's ancestor list, read once
  auto tree_row = [&](int r) -> TreeRow {
    TreeRow m{true, false, 0ull, nullptr};
    if (r >= kM || q0 + r / GP >= row_len) return m;  // dead row: limit 0
    const int* a = tree_anc + (static_cast<size_t>(blk) * kQB + r / GP) * tree_width;
    if (a[0] == -2) return m;
    m.plain = false;
    m.anc = a;
    for (int i = 0; i < tree_width; ++i) {
      const int off = a[i];
      if (off >= 0 && off < 64) {
        m.allow |= 1ull << off;
      } else if (off >= 64) {
        m.wide = true;
      }
    }
    return m;
  };
  TreeRow tr_lo{true, false, 0ull, nullptr};
  TreeRow tr_hi{true, false, 0ull, nullptr};
  if constexpr (TREE) {
    tr_lo = tree_row(r_lo);
    tr_hi = tree_row(r_hi);
  }
  // key t, inside a fragment row's causal limit, passes its tree mask
  auto tree_visible = [&](int t, const TreeRow& m) -> bool {
    if (m.plain) return true;
    const int off = t - base;  // in-row offset; < 0 is the row's history
    if (off < 0) return true;
    if (off < 64) return (m.allow >> off) & 1ull;
    if (!m.wide) return false;
    for (int i = 0; i < tree_width; ++i) {
      if (m.anc[i] == off) return true;
    }
    return false;
  };

  // the row's page ids up to the bound, read once (the tile loads would
  // otherwise wait on a dependent global read before each copy)
  const int n_row_pages = (bound + page_size - 1) >> page_shift;
  for (int i = tid; i < min(n_row_pages, kTableCap); i += kThreads) table_s[i] = table[i];
  auto page_of = [&](int t) -> size_t {
    const int pi = t >> page_shift;
    return static_cast<size_t>(pi < kTableCap ? table_s[pi] : table[pi]);
  };

  // the warp's query rows as mma A fragments, for every k-step of D
  uint32_t qf[kKSteps][4];
  {
    const __nv_bfloat16* qlo = q_row(r_lo);
    const __nv_bfloat16* qhi = q_row(r_hi);
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
      const int c = ks * 16 + tig * 2;
      qf[ks][0] = qlo ? *reinterpret_cast<const uint32_t*>(qlo + c) : 0u;
      qf[ks][1] = qhi ? *reinterpret_cast<const uint32_t*>(qhi + c) : 0u;
      qf[ks][2] = qlo ? *reinterpret_cast<const uint32_t*>(qlo + c + 8) : 0u;
      qf[ks][3] = qhi ? *reinterpret_cast<const uint32_t*>(qhi + c + 8) : 0u;
    }
  }

  float m_lo = -INFINITY, m_hi = -INFINITY;
  float l_lo = 0.f, l_hi = 0.f;
  float acc[kDT][4];
#pragma unroll
  for (int dt = 0; dt < kDT; ++dt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;
  }

  // Start the copies of one tile. Rows at or past the bound are not read;
  // they are zeroed instead, so no stale bits reach a product.
  auto load_tile = [&](int tile, int buf) {
    const int t0 = tile * kTile;
#pragma unroll
    for (int i = 0; i < kCopies; ++i) {
      const int c = tid + i * kThreads;
      const int r = c / kChunksPerRow;
      const int col = c % kChunksPerRow;
      const int t = t0 + r;
      T* k_dst = k_s(buf) + r * kStride + col * kVec;
      T* v_dst = v_s(buf) + r * kStride + col * kVec;
      if (t < bound) {
        const size_t tok = head_rows + (page_of(t) << page_shift) + (t & (page_size - 1));
        const size_t src = tok * D + col * kVec;
        cp_async16(k_dst, k_pool + src);
        cp_async16(v_dst, v_pool + src);
      } else {
        *reinterpret_cast<uint4*>(k_dst) = make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(v_dst) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    if constexpr (INT8) {
      if (tid < kTile) {
        const int t = t0 + tid;
        if (t < bound) {
          const size_t tok = head_rows + (page_of(t) << page_shift) + (t & (page_size - 1));
          cp_async4(&ks_s[buf][tid], k_scale + tok);
          cp_async4(&vs_s[buf][tid], v_scale + tok);
        } else {
          ks_s[buf][tid] = 0.f;
          vs_s[buf][tid] = 0.f;
        }
      }
    }
  };

  const int n_tiles = (bound + kTile - 1) / kTile;
  __syncthreads();  // table_s is complete
  if (n_tiles > 0) load_tile(0, 0);
  cp_async_commit();

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int buf = tile & 1;
    if (tile + 1 < n_tiles) load_tile(tile + 1, buf ^ 1);
    cp_async_commit();  // possibly empty: keeps the wait count uniform
    cp_async_wait_one();
    __syncthreads();
    const T* kt = k_s(buf);
    const T* vt = v_s(buf);
    const int t0 = tile * kTile;

    // scores S = Q K^T, [16 rows x kTile keys] per warp
    float s[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
      if constexpr (INT8) {
        const T* kr = kt + (nt * 8 + gid) * kStride + tig * 2;
#pragma unroll
        for (int ks = 0; ks < kKSteps; ++ks) {
          mma_bf16(s[nt], qf[ks], k_pair(kr + ks * 16), k_pair(kr + ks * 16 + 8));
        }
      } else {
        // matrices j = 0..3: keys nt*8.. x head-dim columns 8j.. of a
        // 32-column slab: the B fragments of two k-steps
        const T* kr = kt + (nt * 8 + (lane & 7)) * kStride + (lane >> 3) * 8;
#pragma unroll
        for (int kp = 0; kp < kKSteps / 2; ++kp) {
          uint32_t b[4];
          ldmatrix_x4(b, kr + kp * 32);
          mma_bf16(s[nt], qf[2 * kp], b[0], b[1]);
          mma_bf16(s[nt], qf[2 * kp + 1], b[2], b[3]);
        }
      }
    }

    // scale, mask past each row's causal limit (and, in a tile that holds
    // in-row keys, by each row's tree), online softmax in f32; a key the
    // tree masks is -inf here, so its probability below is exactly 0
    const bool tree_tile = TREE && t0 + kTile > base;
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kc = nt * 8 + tig * 2 + e;  // key column in the tile
        const int t = t0 + kc;
        float a = s[nt][e] * sm_scale;
        float b = s[nt][2 + e] * sm_scale;
        if constexpr (INT8) {
          a *= ks_s[buf][kc];
          b *= ks_s[buf][kc];
        }
        bool vis_lo = t < lim_lo;
        bool vis_hi = t < lim_hi;
        if (tree_tile) {
          vis_lo = vis_lo && tree_visible(t, tr_lo);
          vis_hi = vis_hi && tree_visible(t, tr_hi);
        }
        s[nt][e] = vis_lo ? a : -INFINITY;
        s[nt][2 + e] = vis_hi ? b : -INFINITY;
        mx_lo = fmaxf(mx_lo, s[nt][e]);
        mx_hi = fmaxf(mx_hi, s[nt][2 + e]);
      }
    }
    // a row's values live in the four lanes of one quad
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, o));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, o));
    }
    const float mn_lo = fmaxf(m_lo, fmaxf(mx_lo, -1e30f));
    const float mn_hi = fmaxf(m_hi, fmaxf(mx_hi, -1e30f));
    const float corr_lo = expf(m_lo - mn_lo);
    const float corr_hi = expf(m_hi - mn_hi);
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int t = t0 + nt * 8 + tig * 2 + e;
        s[nt][e] = t < lim_lo ? expf(s[nt][e] - mn_lo) : 0.f;
        s[nt][2 + e] = t < lim_hi ? expf(s[nt][2 + e] - mn_hi) : 0.f;
        sum_lo += s[nt][e];
        sum_hi += s[nt][2 + e];
      }
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      sum_lo += __shfl_xor_sync(0xffffffffu, sum_lo, o);
      sum_hi += __shfl_xor_sync(0xffffffffu, sum_hi, o);
    }
    l_lo = l_lo * corr_lo + sum_lo;
    l_hi = l_hi * corr_hi + sum_hi;
    m_lo = mn_lo;
    m_hi = mn_hi;
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt) {
      acc[dt][0] *= corr_lo;
      acc[dt][1] *= corr_lo;
      acc[dt][2] *= corr_hi;
      acc[dt][3] *= corr_hi;
    }

    // O += P V: the probabilities (int8: times the key's V scale) become
    // the A fragments of two 16-key k-steps
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      float vs0 = 1.f, vs1 = 1.f, vs8 = 1.f, vs9 = 1.f;
      if constexpr (INT8) {
        const int kc = kk * 16 + tig * 2;
        vs0 = vs_s[buf][kc];
        vs1 = vs_s[buf][kc + 1];
        vs8 = vs_s[buf][kc + 8];
        vs9 = vs_s[buf][kc + 9];
      }
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0] * vs0, s[2 * kk][1] * vs1),
          pack_bf16(s[2 * kk][2] * vs0, s[2 * kk][3] * vs1),
          pack_bf16(s[2 * kk + 1][0] * vs8, s[2 * kk + 1][1] * vs9),
          pack_bf16(s[2 * kk + 1][2] * vs8, s[2 * kk + 1][3] * vs9)};
      if constexpr (INT8) {
        const T* v0 = vt + (kk * 16 + tig * 2) * kStride + gid;
#pragma unroll
        for (int dt = 0; dt < kDT; ++dt) {
          const T* vp = v0 + dt * 8;
          mma_bf16(acc[dt], pa, v_pair(vp, vp + kStride),
                   v_pair(vp + 8 * kStride, vp + 9 * kStride));
        }
      } else {
        // transposed matrices: keys kk*16 + 8*(j & 1).. x columns of
        // output tiles dt + (j >> 1): the B fragments of two output tiles
        const T* v0 = vt + (kk * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * kStride +
                      (lane >> 4) * 8;
#pragma unroll
        for (int dp = 0; dp < kDT / 2; ++dp) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, v0 + dp * 16);
          mma_bf16(acc[2 * dp], pa, b[0], b[1]);
          mma_bf16(acc[2 * dp + 1], pa, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // this buffer may be refilled by the next prefetch
  }

  // normalise and store the rows this thread holds; dead rows give zeros
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? r_hi : r_lo;
    if (r >= kM || r % GP >= groups) continue;
    const float l = half ? l_hi : l_lo;
    const float inv = 1.f / (l == 0.f ? 1.f : l);
    const size_t tok = static_cast<size_t>(blk) * kQB + r / GP;
    __nv_bfloat16* orow = out + ((tok * hkv + h) * groups + r % GP) * D;
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt) {
      const float x0 = acc[dt][2 * half] * inv;
      const float x1 = acc[dt][2 * half + 1] * inv;
      *reinterpret_cast<__nv_bfloat162*>(orow + dt * 8 + tig * 2) = __floats2bfloat162_rn(x0, x1);
    }
  }
}

struct Args {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const void* k_scale;
  const void* v_scale;
  const void* page_table;
  const void* kv_lens;
  const void* row_lens;
  const void* block_rows;
  const void* block_q0;
  const void* tree_anc;
  void* out;
  int n_blocks, hkv, groups, n_pages, page_shift, pages_per_seq, n_rows, tree_width;
};

template <int D, bool INT8, int GP, bool TREE>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using T = typename KvType<INT8>::T;
  const float sm_scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  const dim3 grid(a.n_blocks, a.hkv);
  ragged_attention_kernel<D, INT8, GP, TREE><<<grid, Tiling<GP>::kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const T*>(a.k_pool),
      static_cast<const T*>(a.v_pool), static_cast<const float*>(a.k_scale),
      static_cast<const float*>(a.v_scale), static_cast<const int*>(a.page_table),
      static_cast<const int*>(a.kv_lens), static_cast<const int*>(a.row_lens),
      static_cast<const int*>(a.block_rows), static_cast<const int*>(a.block_q0),
      static_cast<const int*>(a.tree_anc), static_cast<__nv_bfloat16*>(a.out), a.hkv,
      a.groups, a.n_pages, a.page_shift, a.pages_per_seq, a.n_rows, a.tree_width, sm_scale);
  return cudaGetLastError();
}

template <int D, bool INT8, bool TREE>
cudaError_t launch_g(const Args& a, cudaStream_t stream) {
  if (a.groups <= 1) return launch<D, INT8, 1, TREE>(a, stream);
  if (a.groups <= 2) return launch<D, INT8, 2, TREE>(a, stream);
  if (a.groups <= 4) return launch<D, INT8, 4, TREE>(a, stream);
  return launch<D, INT8, 8, TREE>(a, stream);
}

template <int D, bool INT8>
cudaError_t launch_t(const Args& a, cudaStream_t stream) {
  return a.tree_anc ? launch_g<D, INT8, true>(a, stream) : launch_g<D, INT8, false>(a, stream);
}

}  // namespace

// C entry point, bound with ctypes. Returns the cudaError_t of the launch
// (0 on success); the Python wrapper has checked shapes, types and gates.
// tree_anc null selects the plain causal kernel; otherwise tree_width is
// its DMAX (1..64).
extern "C" int tpu_torch_ragged_paged_attention(
    const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
    const void* v_scale, const void* page_table, const void* kv_lens, const void* row_lens,
    const void* block_rows, const void* block_q0, const void* tree_anc, void* out,
    int n_blocks, int hkv, int groups, int head_dim, int n_pages, int page_size,
    int pages_per_seq, int n_rows, int kv_int8, int tree_width, void* stream) {
  if (groups < 1 || groups > kMaxG || (page_size != 16 && page_size != 32) ||
      (head_dim != 64 && head_dim != 128) ||
      (tree_anc != nullptr && (tree_width < 1 || tree_width > 64))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_blocks * hkv == 0) return static_cast<int>(cudaSuccess);
  const Args a{q,          k_pool,  v_pool,   k_scale,    v_scale, page_table,
               kv_lens,    row_lens, block_rows, block_q0, tree_anc, out,
               n_blocks,   hkv,     groups,   n_pages,    page_size == 16 ? 4 : 5,
               pages_per_seq, n_rows, tree_width};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (head_dim == 128) {
    err = kv_int8 ? launch_t<128, true>(a, s) : launch_t<128, false>(a, s);
  } else {
    err = kv_int8 ? launch_t<64, true>(a, s) : launch_t<64, false>(a, s);
  }
  return static_cast<int>(err);
}
