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
// once (2*D bytes each in bf16, D in int8), against a few FLOPs per byte,
// so the floor is bytes / 3.35 TB/s on an H100 SXM. At B=8, Hkv=8, D=128
// and 1024 live tokens per row that is 33.5 MB, about 10 us in bf16.
//
// Design (simple first): one CTA of 128 threads per (b, kv_head) serves
// that head's G query heads, so each K/V byte is read once for all G. The
// CTA walks the live tokens in tiles of 32 (one or two pages) with a
// double-buffered cp.async pipeline of 16-byte copies into shared memory:
// tile i+1 is in flight while tile i computes. Scores: one warp per token,
// lanes split D, the G heads' warp reductions interleaved (G is a template
// bucket, 1/2/4/8, so they unroll without branches). Online softmax in
// f32: one warp per query head. PV: one thread per output column. int8 is
// dequantized in registers. Rows past the length are masked, and their V
// rows zeroed in shared memory, so the unrolled loops carry no row guards.
//
// Known limits, left to later work: the (B, Hkv) grid gives only 64 CTAs at
// B=8 on 132 SMs, so one decode step cannot reach the bandwidth floor;
// splitting the KV length across CTAs (flash-decoding) fixes that. TMA and
// wgmma are not used.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;  // tokens per pipeline stage: one per lane, a multiple of P
constexpr int kMaxG = 8;

template <bool INT8>
struct KvType {
  using T = __nv_bfloat16;
};
template <>
struct KvType<true> {
  using T = int8_t;
};

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// G: the query-head count rounded up to 1, 2, 4 or 8; heads past `groups`
// compute on zero queries and are never stored.
template <int D, bool INT8, int G>
__global__ void __launch_bounds__(kThreads)
    paged_attention_kernel(const __nv_bfloat16* __restrict__ q,
                           const typename KvType<INT8>::T* __restrict__ k_pool,
                           const typename KvType<INT8>::T* __restrict__ v_pool,
                           const float* __restrict__ k_scale,
                           const float* __restrict__ v_scale,
                           const int* __restrict__ page_table,
                           const int* __restrict__ lengths,
                           __nv_bfloat16* __restrict__ out, int hkv, int groups,
                           int n_pages, int page_shift, int pages_per_seq, float sm_scale) {
  using T = typename KvType<INT8>::T;
  constexpr int kVec = 16 / sizeof(T);       // elements per 16-byte copy
  constexpr int kChunksPerRow = D / kVec;    // 16-byte copies per K or V row
  constexpr int kCopies = kTile * kChunksPerRow / kThreads;  // per thread, per side
  constexpr int kEpl = D / 32;               // row elements per lane (scores)
  constexpr int kSplit = kThreads / D;       // token groups in the PV product
  static_assert(kTile * kChunksPerRow % kThreads == 0, "tile copies must split evenly");
  static_assert(kTile == 32, "the softmax phase maps one row to each lane");

  // raw bytes: shared arrays of a class type (bf16) are declared untyped
  __shared__ __align__(16) unsigned char k_raw[2][kTile * D * sizeof(T)];
  __shared__ __align__(16) unsigned char v_raw[2][kTile * D * sizeof(T)];
  auto k_s = [&](int buf) { return reinterpret_cast<T*>(k_raw[buf]); };
  auto v_s = [&](int buf) { return reinterpret_cast<T*>(v_raw[buf]); };
  __shared__ float ks_s[2][kTile];
  __shared__ float vs_s[2][kTile];
  __shared__ float p_s[G][kTile];
  __shared__ float m_s[G];
  __shared__ float l_s[G];
  __shared__ float corr_s[G];
  __shared__ float red_s[kSplit > 1 ? G : 1][kThreads];

  const int bh = blockIdx.x;
  const int b = bh / hkv;
  const int h = bh % hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int page_size = 1 << page_shift;
  // tokens past the table's capacity do not exist (as in the reference)
  const int length = min(lengths[b], pages_per_seq * page_size);
  const int* table = page_table + static_cast<size_t>(b) * pages_per_seq;
  const size_t head_rows = static_cast<size_t>(h) * n_pages * page_size;

  // this lane's slice of every query head, in f32
  const __nv_bfloat16* qb = q + static_cast<size_t>(bh) * groups * D;
  float q_r[G][kEpl];
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int e = 0; e < kEpl; ++e) {
      q_r[g][e] = g < groups ? __bfloat162float(qb[g * D + lane * kEpl + e]) : 0.f;
    }
  }
  if (tid < G) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  float acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = 0.f;

  // Start the copies of one tile. Rows at or past the length are not read;
  // their V rows are zeroed instead, so the PV loop needs no row guard.
  auto load_tile = [&](int tile, int buf) {
    const int t0 = tile * kTile;
#pragma unroll
    for (int i = 0; i < kCopies; ++i) {
      const int c = tid + i * kThreads;
      const int row = c / kChunksPerRow;
      const int col = c % kChunksPerRow;
      const int t = t0 + row;
      T* k_dst = k_s(buf) + row * D + col * kVec;
      T* v_dst = v_s(buf) + row * D + col * kVec;
      if (t < length) {
        const size_t tok = head_rows +
                           (static_cast<size_t>(table[t >> page_shift]) << page_shift) +
                           (t & (page_size - 1));
        const size_t src = tok * D + col * kVec;
        cp_async16(k_dst, k_pool + src);
        cp_async16(v_dst, v_pool + src);
      } else {
        *reinterpret_cast<uint4*>(v_dst) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    if constexpr (INT8) {
      if (tid < kTile) {
        const int t = t0 + tid;
        if (t < length) {
          const size_t tok = head_rows +
                             (static_cast<size_t>(table[t >> page_shift]) << page_shift) +
                             (t & (page_size - 1));
          cp_async4(&ks_s[buf][tid], k_scale + tok);
          cp_async4(&vs_s[buf][tid], v_scale + tok);
        }
      }
    }
  };

  const int n_tiles = (length + kTile - 1) / kTile;
  if (n_tiles > 0) load_tile(0, 0);
  cp_async_commit();
  __syncthreads();  // m_s / l_s initialised

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int buf = tile & 1;
    if (tile + 1 < n_tiles) load_tile(tile + 1, buf ^ 1);
    cp_async_commit();  // possibly empty: keeps the wait count uniform
    cp_async_wait_one();
    __syncthreads();
    const int n_valid = min(kTile, length - tile * kTile);

    // scores: warp w takes rows w, w + kWarps, ...; lanes split D. Rows
    // past the length compute on stale bytes and are masked to -inf.
#pragma unroll
    for (int r = 0; r < kTile / kWarps; ++r) {
      const int row = warp + r * kWarps;
      const T* kr = k_s(buf) + row * D + lane * kEpl;
      float kf[kEpl];
#pragma unroll
      for (int e = 0; e < kEpl; ++e) kf[e] = to_f32(kr[e]);
      float s[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        s[g] = 0.f;
#pragma unroll
        for (int e = 0; e < kEpl; ++e) s[g] = fmaf(q_r[g][e], kf[e], s[g]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
        for (int g = 0; g < G; ++g) s[g] += __shfl_xor_sync(0xffffffffu, s[g], o);
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (lane == g) {
          float sc = s[g] * sm_scale;
          if constexpr (INT8) sc *= ks_s[buf][row];
          p_s[g][row] = row < n_valid ? sc : -INFINITY;
        }
      }
    }
    __syncthreads();

    // online softmax: warp w takes query heads w, w + kWarps; lane = row
    for (int g = warp; g < G; g += kWarps) {
      const bool valid = lane < n_valid;
      const float s = p_s[g][lane];
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, fmaxf(warp_max(valid ? s : -INFINITY), -1e30f));
      const float p = valid ? expf(s - m_new) : 0.f;
      const float sum = warp_sum(p);
      const float corr = expf(m_prev - m_new);
      if constexpr (INT8) {
        p_s[g][lane] = valid ? p * vs_s[buf][lane] : 0.f;
      } else {
        p_s[g][lane] = p;
      }
      __syncwarp();
      if (lane == 0) {
        m_s[g] = m_new;
        l_s[g] = l_s[g] * corr + sum;
        corr_s[g] = corr;
      }
    }
    __syncthreads();

    // PV: thread owns column d; kSplit thread groups split the rows. Rows
    // past the length have p = 0 and V zeroed at load.
    {
      const int d = tid % D;
      const int split = tid / D;
#pragma unroll
      for (int g = 0; g < G; ++g) acc[g] *= corr_s[g];
#pragma unroll
      for (int r = 0; r < kTile / kSplit; ++r) {
        const int row = split + r * kSplit;
        const float v = to_f32(v_s(buf)[row * D + d]);
#pragma unroll
        for (int g = 0; g < G; ++g) acc[g] = fmaf(p_s[g][row], v, acc[g]);
      }
    }
    __syncthreads();  // this buffer may be refilled by the next prefetch
  }

  const int d = tid % D;
  const int split = tid / D;
  if constexpr (kSplit > 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) red_s[g][tid] = acc[g];
    __syncthreads();
    if (split == 0) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        for (int s = 1; s < kSplit; ++s) acc[g] += red_s[g][s * D + d];
      }
    }
  }
  if (split == 0) {
    __nv_bfloat16* ob = out + static_cast<size_t>(bh) * groups * D;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (g < groups) {
        const float l = l_s[g];
        ob[g * D + d] = __float2bfloat16(acc[g] / (l == 0.f ? 1.f : l));
      }
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
  const void* lengths;
  void* out;
  int batch, hkv, groups, n_pages, page_shift, pages_per_seq;
};

template <int D, bool INT8, int G>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using T = typename KvType<INT8>::T;
  const float sm_scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  paged_attention_kernel<D, INT8, G><<<a.batch * a.hkv, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const T*>(a.k_pool),
      static_cast<const T*>(a.v_pool), static_cast<const float*>(a.k_scale),
      static_cast<const float*>(a.v_scale), static_cast<const int*>(a.page_table),
      static_cast<const int*>(a.lengths), static_cast<__nv_bfloat16*>(a.out), a.hkv, a.groups,
      a.n_pages, a.page_shift, a.pages_per_seq, sm_scale);
  return cudaGetLastError();
}

template <int D, bool INT8>
cudaError_t launch_g(const Args& a, cudaStream_t stream) {
  if (a.groups <= 1) return launch<D, INT8, 1>(a, stream);
  if (a.groups <= 2) return launch<D, INT8, 2>(a, stream);
  if (a.groups <= 4) return launch<D, INT8, 4>(a, stream);
  return launch<D, INT8, 8>(a, stream);
}

}  // namespace

// C entry point, bound with ctypes. Returns the cudaError_t of the launch
// (0 on success); the Python wrapper has checked shapes, types and gates.
extern "C" int tpu_torch_paged_attention(const void* q, const void* k_pool, const void* v_pool,
                                         const void* k_scale, const void* v_scale,
                                         const void* page_table, const void* lengths, void* out,
                                         int batch, int hkv, int groups, int head_dim,
                                         int n_pages, int page_size, int pages_per_seq,
                                         int kv_int8, void* stream) {
  if (groups < 1 || groups > kMaxG || (page_size != 16 && page_size != 32) ||
      (head_dim != 64 && head_dim != 128)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch * hkv == 0) return static_cast<int>(cudaSuccess);
  const Args a{q, k_pool, v_pool, k_scale, v_scale, page_table, lengths, out,
               batch, hkv, groups, n_pages, page_size == 16 ? 4 : 5, pages_per_seq};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (head_dim == 128) {
    err = kv_int8 ? launch_g<128, true>(a, s) : launch_g<128, false>(a, s);
  } else {
    err = kv_int8 ? launch_g<64, true>(a, s) : launch_g<64, false>(a, s);
  }
  return static_cast<int>(err);
}
