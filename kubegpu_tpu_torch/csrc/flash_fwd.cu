// Flash attention forward (K1), mma.sync instances, plain C interface for
// ctypes: bf16 at head_dim 32 and float32 at 32, 64 and 128 on the main
// path, and bf16 at 64 and 128 as the previous design, which chip_smoke.py
// times beside the Hopper instance (flash_fwd_sm90.cu) that the main path
// takes there. The wrapper's shape rule (kernels/flash.py::_instance)
// picks the instance.
//
// Replaces kubegpu_tpu/workload/kernels/flash.py::_fwd_kernel, the TPU's
// Pallas forward: causal, sliding-window or non-causal attention with an
// online softmax over key tiles, tiles the mask hides skipped, masking at
// global positions q_offset + i and kv_offset + j. Layout [B, T, H, D] read
// through its strides (no transposes); O like q, lse [B, H, Tq] float32.
//
// What bounds it on an H100 SXM, at the serving slice's shape (B=4, T=1024,
// H=16, D=128, bf16, causal):
//   operations: 4 * D per visible (q, k) pair (QK^T and PV, 2 per MAC)
//               = 4 * 128 * (1024 * 1025 / 2) * 4 * 16 = 17.2 GFLOP,
//               17.4 us at 989 TFLOP/s (bf16 dense);
//   bytes:      q, k, v, o once each = 4 * 16.8 MB = 67.1 MB, plus lse
//               0.26 MB, 20.1 us at 3.35 TB/s.
// So the bound is memory, about 20 us, with the tensor-core time close
// behind. The design keeps S and P out of device memory entirely (registers
// only) and reads each K/V tile through shared memory once per 64-row query
// tile; K/V of one (b, h) is 512 KB, which the 50 MB L2 holds, so the
// re-reads by the 16 query tiles of a head mostly hit L2. It is the simple
// first version: mma.sync m16n8k16 with register-resident Q fragments,
// ldmatrix for the K and (transposed) V fragments, the softmax in log2
// units (exp2), the per-element mask only on tiles the mask cuts, K/V
// tiles staged in two stages with cp.async (the next tile loads while this
// one computes), and the query tiles that see the most keys scheduled
// first. mma.sync caps it well below Hopper's tensor-core rate, and every
// thread both copies and computes; flash_fwd_sm90.cu is the redesign with
// wgmma, TMA and a producer warp.
//
// Rows that see no key at all give O = 0 and lse <= -1e20: a masked
// score is -inf, so its probability is exactly 0 whatever tile it
// sits in. (The Pallas kernel averages the tile's V for such a row when the
// tile is partly visible; causal and windowed attention never have such a
// row, since every query sees itself.)

#include "flash_common.cuh"

namespace {

using namespace kgt;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int B, H, Tq, Tk;
  long long qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh, osb, ost, osh;
  float scale;
  int q_offset, kv_offset, causal, window;
};

// ---------------------------------------------------------------------------
// bf16: tensor cores, 4 warps x 16 query rows, 64-key tiles.

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int kThreads = 128;

// Dynamic shared memory of the bf16 kernel: two stages of K and V tiles.
template <int D>
constexpr int bf16_smem_bytes() {
  return 2 * 2 * BN * (D + 8) * static_cast<int>(sizeof(__nv_bfloat16));
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_bf16(const Params p) {
  // Row stride D + 8: rows stay 16-byte aligned for the staging stores and
  // ldmatrix, and the 8 row addresses of one 8x8 matrix fall in distinct
  // banks.
  constexpr int LD = D + 8;
  // Two stages: the next K/V tile loads (cp.async) while this one computes.
  extern __shared__ __align__(16) unsigned char smem[];
  auto* Ks = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][BN][LD]
  auto* Vs = Ks + 2 * BN * LD;                        // [2][BN][LD]

  // Causal: the last query tiles see the most keys, so they start first.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;  // mma fragment row / column pair
  const int lm = lane >> 3, lr = lane & 7;  // ldmatrix matrix / row
  const auto* q = static_cast<const __nv_bfloat16*>(p.q) + b * p.qsb + h * p.qsh;
  const auto* k = static_cast<const __nv_bfloat16*>(p.k) + b * p.ksb + h * p.ksh;
  const auto* v = static_cast<const __nv_bfloat16*>(p.v) + b * p.vsb + h * p.vsh;

  // This thread's two query rows (fragment rows g and g + 8 of its warp).
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const int qp0 = p.q_offset + r0, qp1 = p.q_offset + r1;
  // Scores are kept in log2 units (exp2 is one instruction): s * scale *
  // log2(e), so exp2(s' - m') = exp(s * scale - m).
  const float scale2 = p.scale * kLog2e;

  // Q as mma A fragments, held in registers for the whole key loop.
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + tg * 2;
    const bool in0 = r0 < p.Tq, in1 = r1 < p.Tq;
    qf[kk][0] = in0 ? load_u32(q + r0 * p.qst + c) : 0u;
    qf[kk][1] = in1 ? load_u32(q + r1 * p.qst + c) : 0u;
    qf[kk][2] = in0 ? load_u32(q + r0 * p.qst + c + 8) : 0u;
    qf[kk][3] = in1 ? load_u32(q + r1 * p.qst + c + 8) : 0u;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;  // running row max (log2 units)
  float l0 = 0.f, l1 = 0.f;          // this thread's share of the row sum

  const int q_lo = p.q_offset + q0;
  const int q_hi = p.q_offset + min(q0 + BM, p.Tq) - 1;
  const int num_k = (p.Tk + BN - 1) / BN;
  // The visible key tiles form one range: the causal bound cuts the newest,
  // the window the oldest.
  int kt_lo = num_k, kt_hi = 0;
  for (int kt = 0; kt < num_k; ++kt) {
    if (tile_visible(p, q_lo, q_hi, p.kv_offset + kt * BN,
                     p.kv_offset + min(kt * BN + BN, p.Tk) - 1)) {
      kt_lo = min(kt_lo, kt);
      kt_hi = kt + 1;
    }
  }

  // Rows past Tk are zero-filled.
  auto stage = [&](int kt, int buf) {
    constexpr int kChunks = BN * D / 8;  // 16-byte chunks per tile
    const int k0 = kt * BN;
    for (int i = tid; i < kChunks; i += kThreads) {
      const int row = i / (D / 8), col = (i % (D / 8)) * 8;
      const bool in = k0 + row < p.Tk;
      const long long src = in ? k0 + row : 0;
      cp_async16(&Ks[(buf * BN + row) * LD + col], k + src * p.kst + col, in);
      cp_async16(&Vs[(buf * BN + row) * LD + col], v + src * p.vst + col, in);
    }
    cp_async_commit();
  };
  if (kt_lo < kt_hi) stage(kt_lo, 0);

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int buf = (kt - kt_lo) & 1;
    if (kt + 1 < kt_hi) {
      stage(kt + 1, buf ^ 1);
      cp_async_wait<1>();  // all but the newest group: tile kt has landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile kt is visible to every thread
    const __nv_bfloat16* ks = Ks + buf * BN * LD;
    const __nv_bfloat16* vs = Vs + buf * BN * LD;
    const int k0 = kt * BN;
    const int k_lo = p.kv_offset + k0;
    const int k_hi = p.kv_offset + min(k0 + BN, p.Tk) - 1;
    const bool masked = k0 + BN > p.Tk || !tile_full(p, q_lo, q_hi, k_lo, k_hi);

    // S = Q K^T: 16 rows x BN keys per warp, float32 accumulators. One
    // ldmatrix.x4 gives the B fragments of two 16-dim steps of 8 keys.
    float s[BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; kk += 2) {
        uint32_t bf[4];
        ldsm_x4(bf, &ks[(nt * 8 + lr) * LD + kk * 16 + lm * 8]);
        mma_bf16(s[nt], qf[kk], bf[0], bf[1]);
        mma_bf16(s[nt], qf[kk + 1], bf[2], bf[3]);
      }
    }

    // Scale (and mask at global positions where the tile needs it), new
    // row max.
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * scale2;
        if (masked) {
          const int col = k0 + nt * 8 + tg * 2 + (e & 1);
          if (!(col < p.Tk &&
                visible(p, e < 2 ? qp0 : qp1, p.kv_offset + col)))
            x = -INFINITY;
        }
        s[nt][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x);
        else mx1 = fmaxf(mx1, x);
      }
    }
    // the four threads of a fragment row hold its 64 columns between them
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float a0 = exp2f(m0 - mx0), a1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;

    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - m0);  // masked: exp2(-inf) = 0
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

    // acc += P V, with P cast to bf16 first (flash.py casts p to v's type).
    // The S accumulators of key columns 16kk..16kk+15 are exactly the A
    // fragment of that 16-key step; one ldmatrix.x4.trans gives the B
    // fragments of two 8-dim column blocks of V.
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_f32(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_f32(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dt = 0; dt < D / 8; dt += 2) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, &vs[(kk * 16 + (lm & 1) * 8 + lr) * LD + dt * 8 +
                              (lm >> 1) * 8]);
        mma_bf16(acc[dt], a, bf[0], bf[1]);
        mma_bf16(acc[dt + 1], a, bf[2], bf[3]);
      }
    }
    __syncthreads();  // every warp is done with buf before it is restaged
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  auto* o = static_cast<__nv_bfloat16*>(p.o) + b * p.osb + h * p.osh;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + tg * 2;
    if (r0 < p.Tq)
      *reinterpret_cast<__nv_bfloat162*>(o + r0 * p.ost + c) =
          __floats2bfloat162_rn(acc[dt][0] / d0, acc[dt][1] / d0);
    if (r1 < p.Tq)
      *reinterpret_cast<__nv_bfloat162*>(o + r1 * p.ost + c) =
          __floats2bfloat162_rn(acc[dt][2] / d1, acc[dt][3] / d1);
  }
  if (tg == 0) {
    // back from log2 units: lse = m' ln 2 + log(l)
    float* lse = p.lse + (static_cast<long long>(b) * p.H + h) * p.Tq;
    if (r0 < p.Tq) lse[r0] = m0 * kLn2 + logf(d0);
    if (r1 < p.Tq) lse[r1] = m1 * kLn2 + logf(d1);
  }
}

// ---------------------------------------------------------------------------
// float32: plain FMAs, one thread per query row, 8-key tiles.

constexpr int F_BM = 64;
constexpr int F_BN = 8;

template <int D>
__global__ void __launch_bounds__(F_BM) flash_fwd_f32(const Params p) {
  __shared__ float Qs[F_BM * (D + 1)];  // +1: thread rows in distinct banks
  __shared__ float Ks[F_BN * D];
  __shared__ float Vs[F_BN * D];

  const int q0 = blockIdx.x * F_BM, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const auto* q = static_cast<const float*>(p.q) + b * p.qsb + h * p.qsh;
  const auto* k = static_cast<const float*>(p.k) + b * p.ksb + h * p.ksh;
  const auto* v = static_cast<const float*>(p.v) + b * p.vsb + h * p.vsh;

  for (int i = tid; i < F_BM * D; i += F_BM) {
    const int row = i / D, col = i % D;
    Qs[row * (D + 1) + col] = q0 + row < p.Tq ? q[(q0 + row) * p.qst + col]
                                              : 0.f;
  }
  const int r = q0 + tid, qp = p.q_offset + r;
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  float m = kNegInf, l = 0.f;

  const int q_lo = p.q_offset + q0;
  const int q_hi = p.q_offset + min(q0 + F_BM, p.Tq) - 1;
  const int num_k = (p.Tk + F_BN - 1) / F_BN;
  for (int kt = 0; kt < num_k; ++kt) {
    const int k0 = kt * F_BN;
    if (!tile_visible(p, q_lo, q_hi, p.kv_offset + k0,
                      p.kv_offset + min(k0 + F_BN, p.Tk) - 1))
      continue;
    __syncthreads();
    for (int i = tid; i < F_BN * D; i += F_BM) {
      const int row = i / D, col = i % D;
      const bool in = k0 + row < p.Tk;
      Ks[i] = in ? k[(k0 + row) * p.kst + col] : 0.f;
      Vs[i] = in ? v[(k0 + row) * p.vst + col] : 0.f;
    }
    __syncthreads();

    float s[F_BN];
    float mx = m;
#pragma unroll
    for (int j = 0; j < F_BN; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d)
        dot = fmaf(Qs[tid * (D + 1) + d], Ks[j * D + d], dot);
      const bool ok = k0 + j < p.Tk && visible(p, qp, p.kv_offset + k0 + j);
      s[j] = ok ? dot * p.scale : -INFINITY;
      if (ok) mx = fmaxf(mx, s[j]);
    }
    const float alpha = expf(m - mx);
    m = mx;
    float ls = 0.f;
#pragma unroll
    for (int j = 0; j < F_BN; ++j) {
      s[j] = expf(s[j] - m);
      ls += s[j];
    }
    l = l * alpha + ls;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      float a = acc[d] * alpha;
#pragma unroll
      for (int j = 0; j < F_BN; ++j) a = fmaf(s[j], Vs[j * D + d], a);
      acc[d] = a;
    }
  }

  if (r < p.Tq) {
    const float den = fmaxf(l, 1e-30f);
    float* o = static_cast<float*>(p.o) + b * p.osb + h * p.osh + r * p.ost;
#pragma unroll
    for (int d = 0; d < D; ++d) o[d] = acc[d] / den;
    p.lse[(static_cast<long long>(b) * p.H + h) * p.Tq + r] = m + logf(den);
  }
}

template <int D>
cudaError_t launch(const Params& p, int dtype, cudaStream_t stream) {
  if (dtype == 0) {
    constexpr int smem = bf16_smem_bytes<D>();
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((p.Tq + BM - 1) / BM, p.H, p.B);
    flash_fwd_bf16<D><<<grid, kThreads, smem, stream>>>(p);
  } else {
    const dim3 grid((p.Tq + F_BM - 1) / F_BM, p.H, p.B);
    flash_fwd_f32<D><<<grid, F_BM, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = bf16, 1 = float32. Strides are in elements, for the B, T and H
// dimensions of q, k, v and o; D has unit stride. Returns cudaGetLastError()
// after the launch (a launch the card refuses never runs, and a later
// synchronize would not report it).
extern "C" int kgt_flash_fwd_mma(const void* q, const void* k, const void* v,
                                 void* o, void* lse, int dtype, int B, int H,
                                 int Tq, int Tk, int D, long long qsb,
                                 long long qst, long long qsh, long long ksb,
                                 long long kst, long long ksh, long long vsb,
                                 long long vst, long long vsh, long long osb,
                                 long long ost, long long osh, float scale,
                                 int q_offset, int kv_offset, int causal,
                                 int window, void* stream) {
  if ((dtype != 0 && dtype != 1) || B < 1 || H < 1 || Tq < 1 || Tk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q,   k,   v,   o,   static_cast<float*>(lse), B,   H,   Tq,
           Tk,  qsb, qst, qsh, ksb,  kst,  ksh, vsb, vst, vsh, osb,
           ost, osh, scale, q_offset, kv_offset, causal, window};
  auto st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return static_cast<int>(launch<32>(p, dtype, st));
    case 64: return static_cast<int>(launch<64>(p, dtype, st));
    case 128: return static_cast<int>(launch<128>(p, dtype, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
