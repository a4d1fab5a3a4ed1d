// Decode attention (K4): one query token per row against the bf16 KV cache
// of one layer, split over the key axis ("flash-decoding"), plain C
// interface for ctypes.
//
// It replaces no TPU kernel: the JAX package's decode attention
// (kubegpu_tpu/workload/decode.py, make_forward_step) is plain jnp, and the
// port's plain version (kernels/decode_attn.py::decode_attention_plain)
// casts the whole [B, S_max, Hkv, D] pool to float32 and masks every slot
// out to S_max at every token step. Its inputs are those of the serving
// decode step: q [B, 1, Hq, D] bf16 (RoPE'd), the cache's K and V
// [B, S_max, Hkv, D] bf16 as init_cache lays them out, the per-row query
// positions pos [B] int64, a sliding window (0: none) and the scale.
// Row b attends keys [max(0, pos - window + 1), pos]; the cache past pos
// holds the stale K/V of earlier requests and is never read.
//
// What bounds it on an H100 SXM: bytes. Per live key and kv head it reads
// 2 * D * 2 bytes of K and V and does 4 * D * Hq/Hkv operations, so at
// Mistral's 4 query heads a kv head of 128 that is 4 operations a byte,
// far under the card's ~295 (bf16 tensor cores over 3.35 TB/s). At the
// reasoning cell's shape (B 128, 8 kv heads of 128) a full 4096-position
// pool is 2.15 GB a layer, 0.64 ms at 3.35 TB/s; a mean live length of
// 900 positions is 0.47 GB, 0.14 ms.
//
// The design reads each live K/V byte once, in bf16, and nothing else of
// the pool. One block per (split of the key axis, kv head, row) takes all
// Hq/Hkv query heads of its group as the rows of one 16-row mma.sync tile
// (the rows past the group are zero), so K and V are read once for the
// group. A split that lies wholly outside the row's live span exits at
// once. Inside a block each of the 4 warps streams its own 16-key tiles
// (tiles warp, warp + 4, ...) through shared memory with cp.async, 16-byte
// loads on the contiguous 2 * D-byte rows of one kv head, double-buffered:
// the next tile loads while this one computes; keys outside the live span
// are zero-filled, never read. QK^T is bf16 mma.sync with float32
// accumulation (the products are exact, as the plain version's q.float()
// x k), the online softmax runs in float32 (log2 units, exp2), P is
// rounded to bf16 before the PV product (the plain version's
// p.to(dt).float()) and PV accumulates in float32. The block merges its 4
// warps' (m, l, O) in shared memory and writes one float32 partial; a
// second small kernel merges a row's live splits and writes bf16. The split
// length is a constant (kernels/decode_attn.py::SPLIT_LEN), so the launch
// needs no readback.

#include "flash_common.cuh"

namespace {

using namespace kgt;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 16;      // keys per warp tile
constexpr int kMaxGroup = 16;  // query heads per kv head: one mma M tile

struct Params {
  const __nv_bfloat16* q;  // [B, 1, Hq, D]
  const __nv_bfloat16* k;  // [B, S, Hkv, D]
  const __nv_bfloat16* v;
  const long long* pos;    // [B]
  float* part_o;           // [B, Hq, n_split, D] unnormalised O per split
  float* part_ml;          // [B, Hq, n_split, 2]: running max (log2), sum
  __nv_bfloat16* o;        // [B, 1, Hq, D], contiguous
  int B, Hq, Hkv, S, D, group, split_len, n_split, window;
  long long qsb, qsh, ksb, kst, ksh, vsb, vst, vsh;
  float scale;
};

// Row b's live keys [lo, hi] (empty when hi < lo).
__device__ __forceinline__ void live_span(const Params& p, int b, int& lo,
                                          int& hi) {
  const long long pos = p.pos[b];
  hi = static_cast<int>(min(pos, static_cast<long long>(p.S) - 1));
  lo = p.window ? static_cast<int>(max(0LL, pos - p.window + 1)) : 0;
}

template <int D>
constexpr int staging_bytes() {  // two stages of K and V tiles per warp
  return kWarps * 2 * 2 * kTile * (D + 8) *
         static_cast<int>(sizeof(__nv_bfloat16));
}

template <int D>
constexpr int merge_bytes() {  // every warp's m, l and O rows
  return kWarps * kMaxGroup * (D + 2) * static_cast<int>(sizeof(float));
}

template <int D>
constexpr int smem_bytes() {
  return staging_bytes<D>() > merge_bytes<D>() ? staging_bytes<D>()
                                               : merge_bytes<D>();
}

template <int D>
__global__ void __launch_bounds__(kThreads) decode_attn_split(const Params p) {
  // Row stride D + 8: rows stay 16-byte aligned for cp.async and ldmatrix,
  // and the 8 row addresses of one 8x8 matrix fall in distinct banks.
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  int lo, hi;
  live_span(p, b, lo, hi);
  const int s0 = split * p.split_len;
  const int k_begin = max(lo, s0), k_end = min(hi + 1, s0 + p.split_len);
  if (k_begin >= k_end) return;  // the split holds no live key

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;   // mma fragment row / column pair
  const int lm = lane >> 3, lr = lane & 7;  // ldmatrix matrix / row
  auto* Ks = reinterpret_cast<__nv_bfloat16*>(smem) + warp * 4 * kTile * LD;
  auto* Vs = Ks + 2 * kTile * LD;  // each [2][kTile][LD], this warp's own

  const __nv_bfloat16* q = p.q + b * p.qsb + h * p.group * p.qsh;
  const __nv_bfloat16* k = p.k + b * p.ksb + h * p.ksh;
  const __nv_bfloat16* v = p.v + b * p.vsb + h * p.vsh;
  // Scores in log2 units: s * scale * log2(e), so exp2(s' - m') is
  // exp(s * scale - m).
  const float scale2 = p.scale * kLog2e;

  // The group's query heads as mma A fragments (rows g and g + 8), held in
  // registers; rows past the group are zero.
  const bool in0 = g < p.group, in1 = g + 8 < p.group;
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + tg * 2;
    qf[kk][0] = in0 ? load_u32(q + g * p.qsh + c) : 0u;
    qf[kk][1] = in1 ? load_u32(q + (g + 8) * p.qsh + c) : 0u;
    qf[kk][2] = in0 ? load_u32(q + g * p.qsh + c + 8) : 0u;
    qf[kk][3] = in1 ? load_u32(q + (g + 8) * p.qsh + c + 8) : 0u;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;  // running row max (log2 units)
  float l0 = 0.f, l1 = 0.f;          // this thread's share of the row sum

  // The block's 16-key tiles (aligned to its split) that hold a live key.
  const int t_first = (k_begin - s0) / kTile;
  const int t_end = (k_end - s0 + kTile - 1) / kTile;

  // Keys outside [k_begin, k_end) are zero-filled and never read: past pos
  // the cache holds stale K/V (possibly NaN), and 0 * NaN would poison PV.
  auto stage = [&](int t, int buf) {
    constexpr int kChunks = kTile * D / 8;  // 16-byte chunks of a K tile
    const int key0 = s0 + t * kTile;
#pragma unroll
    for (int i = lane; i < kChunks; i += 32) {
      const int row = i / (D / 8), col = (i % (D / 8)) * 8;
      const int key = key0 + row;
      const bool in = key >= k_begin && key < k_end;
      const long long src = in ? key : k_begin;
      cp_async16(&Ks[(buf * kTile + row) * LD + col], k + src * p.kst + col,
                 in);
      cp_async16(&Vs[(buf * kTile + row) * LD + col], v + src * p.vst + col,
                 in);
    }
    cp_async_commit();
  };

  int t = t_first + warp;
  if (t < t_end) stage(t, 0);
  for (int it = 0; t < t_end; t += kWarps, ++it) {
    const int buf = it & 1;
    if (t + kWarps < t_end) {
      stage(t + kWarps, buf ^ 1);
      cp_async_wait<1>();  // all but the newest group: tile t has landed
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();  // tile t is visible to the whole warp
    const __nv_bfloat16* ks = Ks + buf * kTile * LD;
    const __nv_bfloat16* vs = Vs + buf * kTile * LD;
    const int key0 = s0 + t * kTile;
    const bool full = key0 >= k_begin && key0 + kTile <= k_end;

    // S = Q K^T: 16 rows x 16 keys; one ldmatrix.x4 gives the B fragments
    // of two 16-dim steps of 8 keys.
    float s[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; kk += 2) {
        uint32_t bf[4];
        ldsm_x4(bf, &ks[(nt * 8 + lr) * LD + kk * 16 + lm * 8]);
        mma_bf16(s[nt], qf[kk], bf[0], bf[1]);
        mma_bf16(s[nt], qf[kk + 1], bf[2], bf[3]);
      }
    }

    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * scale2;
        if (!full) {
          const int key = key0 + nt * 8 + tg * 2 + (e & 1);
          if (key < k_begin || key >= k_end) x = -INFINITY;
        }
        s[nt][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x);
        else mx1 = fmaxf(mx1, x);
      }
    }
    // the four threads of a fragment row hold its 16 columns between them
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float a0 = exp2f(m0 - mx0), a1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - m0);  // outside the span: exp2(-inf) = 0
      s[nt][1] = exp2f(s[nt][1] - m0);
      s[nt][2] = exp2f(s[nt][2] - m1);
      s[nt][3] = exp2f(s[nt][3] - m1);
      ls0 += s[nt][0] + s[nt][1];
      ls1 += s[nt][2] + s[nt][3];
    }
    l0 = l0 * a0 + ls0;
    l1 = l1 * a1 + ls1;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      acc[dt][0] *= a0;
      acc[dt][1] *= a0;
      acc[dt][2] *= a1;
      acc[dt][3] *= a1;
    }

    // acc += P V with P rounded to bf16: the S accumulators of the tile's
    // 16 keys are exactly the A fragment of one 16-key step; one
    // ldmatrix.x4.trans gives the B fragments of two 8-dim blocks of V.
    uint32_t a[4];
    a[0] = pack_f32(s[0][0], s[0][1]);
    a[1] = pack_f32(s[0][2], s[0][3]);
    a[2] = pack_f32(s[1][0], s[1][1]);
    a[3] = pack_f32(s[1][2], s[1][3]);
#pragma unroll
    for (int dt = 0; dt < D / 8; dt += 2) {
      uint32_t bf[4];
      ldsm_x4_trans(bf, &vs[((lm & 1) * 8 + lr) * LD + dt * 8 + (lm >> 1) * 8]);
      mma_bf16(acc[dt], a, bf[0], bf[1]);
      mma_bf16(acc[dt + 1], a, bf[2], bf[3]);
    }
    __syncwarp();  // the warp is done with buf before it is restaged
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);

  // Merge the 4 warps' (m, l, O) in shared memory (the staging buffers,
  // once every warp is done with them); a warp that had no tile holds
  // m = -1e30, l = 0, O = 0 and weighs nothing.
  __syncthreads();
  auto* Mw = reinterpret_cast<float*>(smem);  // [kWarps][kMaxGroup]
  float* Lw = Mw + kWarps * kMaxGroup;        // [kWarps][kMaxGroup]
  float* Ow = Lw + kWarps * kMaxGroup;        // [kWarps][kMaxGroup][D]
  const int r0 = warp * kMaxGroup + g, r1 = r0 + 8;
  if (tg == 0) {
    if (in0) Mw[r0] = m0, Lw[r0] = l0;
    if (in1) Mw[r1] = m1, Lw[r1] = l1;
  }
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + tg * 2;
    if (in0) Ow[r0 * D + c] = acc[dt][0], Ow[r0 * D + c + 1] = acc[dt][1];
    if (in1) Ow[r1 * D + c] = acc[dt][2], Ow[r1 * D + c + 1] = acc[dt][3];
  }
  __syncthreads();
  for (int i = tid; i < p.group * D; i += kThreads) {
    const int r = i / D, d = i % D;
    float m = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, Mw[w * kMaxGroup + r]);
    float l = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wgt = exp2f(Mw[w * kMaxGroup + r] - m);
      l += Lw[w * kMaxGroup + r] * wgt;
      o += Ow[(w * kMaxGroup + r) * D + d] * wgt;
    }
    const long long row =
        (static_cast<long long>(b) * p.Hq + h * p.group + r) * p.n_split +
        split;
    p.part_o[row * D + d] = o;
    if (d == 0) {
      p.part_ml[row * 2] = m;
      p.part_ml[row * 2 + 1] = l;
    }
  }
}

// One block per (query head, row), one thread per d: the row's live splits'
// partials, weighted by exp2(m_split - m), over the merged sum; bf16 out. A
// row with no live key (never on the decode path, where pos is written
// first) gives O = 0.
__global__ void decode_attn_merge(const Params p) {
  const int hq = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  int lo, hi;
  live_span(p, b, lo, hi);
  const long long row0 = (static_cast<long long>(b) * p.Hq + hq) * p.n_split;
  float out = 0.f;
  if (lo <= hi) {
    const int first = lo / p.split_len, last = hi / p.split_len;
    float m = kNegInf;
    for (int s = first; s <= last; ++s)
      m = fmaxf(m, p.part_ml[(row0 + s) * 2]);
    float l = 0.f, o = 0.f;
    for (int s = first; s <= last; ++s) {
      const float wgt = exp2f(p.part_ml[(row0 + s) * 2] - m);
      l += p.part_ml[(row0 + s) * 2 + 1] * wgt;
      o += p.part_o[(row0 + s) * p.D + d] * wgt;
    }
    out = o / fmaxf(l, 1e-30f);
  }
  p.o[(static_cast<long long>(b) * p.Hq + hq) * p.D + d] =
      __float2bfloat16_rn(out);
}

template <int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int smem = smem_bytes<D>();
  const cudaError_t err = cudaFuncSetAttribute(
      decode_attn_split<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  decode_attn_split<D><<<dim3(p.n_split, p.Hkv, p.B), kThreads, smem,
                         stream>>>(p);
  decode_attn_merge<<<dim3(p.Hq, p.B), D, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// q [B, 1, Hq, D], k and v [B, S, Hkv, D] bf16 with unit stride in D; the
// strides (elements) of q's B and H dimensions and of the caches' B, S and
// H dimensions; pos [B] int64; part_o and part_ml float32 scratch of
// B * Hq * n_split * D and B * Hq * n_split * 2 elements; o [B, 1, Hq, D]
// bf16, contiguous. split_len is a multiple of 16 with split_len * n_split
// >= S. Returns cudaGetLastError() after the two launches (a launch the
// card refuses never runs, and a later synchronize would not report it).
extern "C" int kgt_decode_attn(const void* q, const void* k, const void* v,
                               const void* pos, void* part_o, void* part_ml,
                               void* o, int B, int Hq, int Hkv, int S, int D,
                               int split_len, int n_split, int window,
                               long long qsb, long long qsh, long long ksb,
                               long long kst, long long ksh, long long vsb,
                               long long vst, long long vsh, float scale,
                               void* stream) {
  if (B < 1 || Hkv < 1 || S < 1 || Hq % Hkv || Hq / Hkv > kMaxGroup ||
      split_len < kTile || split_len % kTile ||
      static_cast<long long>(split_len) * n_split < S || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{static_cast<const __nv_bfloat16*>(q),
           static_cast<const __nv_bfloat16*>(k),
           static_cast<const __nv_bfloat16*>(v),
           static_cast<const long long*>(pos),
           static_cast<float*>(part_o),
           static_cast<float*>(part_ml),
           static_cast<__nv_bfloat16*>(o),
           B, Hq, Hkv, S, D, Hq / Hkv, split_len, n_split, window,
           qsb, qsh, ksb, kst, ksh, vsb, vst, vsh, scale};
  auto st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return static_cast<int>(launch<32>(p, st));
    case 64: return static_cast<int>(launch<64>(p, st));
    case 128: return static_cast<int>(launch<128>(p, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
