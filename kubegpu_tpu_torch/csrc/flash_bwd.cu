// Flash attention backward for Hopper (sm_90a): K2 (dQ) and K3 (dK, dV),
// plain C interface for ctypes.
//
// K2 replaces kubegpu_tpu/workload/kernels/flash.py::_dq_kernel (:213),
// K3 replaces ::_dkv_kernel (:244): the standard two-kernel flash backward
// off the forward's saved (o, lse). Both recompute S = scale Q K^T and
// P = exp(S - lse) tile by tile (in log2 units, exp2), form dP = dO V^T and
// dS = P o (dP - delta) with delta = rowsum(dO o O) - dlse computed by the
// wrapper, and never write an S or P matrix to device memory. Layout
// [B, T, H, D] read through its strides; dQ, dK, dV like q, k, v; lse and
// delta [B, H, Tq] float32. Masking at global positions q_offset + i and
// kv_offset + j, tiles the mask hides skipped, the per-element mask only
// on tiles it cuts; any Tq, Tk >= 1.
//
// K2: one block per (b, h, 64-row query tile), 4 warps x 16 rows; the block
// loops over the visible 64-key tiles (K and V staged in two stages with
// cp.async) and accumulates dQ += dS K in float32 registers; dQ is written
// once, times scale. K3: one block per (b, h, 64-key tile), 4 warps x 16
// keys; K and V stay in shared memory and the block loops over the visible
// 32-row query tiles (Q, dO, lse, delta staged in two stages), computing the
// transposed scores S^T = K Q^T so P^T and dS^T are mma A fragments
// directly, and accumulates dV += P^T dO and dK += dS^T Q in float32. No
// atomics: each output element is owned by one thread, so the results are
// deterministic, like the JAX _bwd. P and dS are cast to bf16 before their
// products (flash.py casts them to the operand type), with float32
// accumulation.
//
// What bounds them on an H100 SXM, at the training shape (B=4, T=2048,
// H=18, D=128, bf16, causal; 72 x 2048 x 2049 / 2 = 151.07M visible pairs):
//   K2: 6 D FLOP per pair (S, dP, dQ) = 116.0 GFLOP, 0.117 ms at 989
//       TFLOP/s; bytes q, k, v, dO, dQ, lse, delta = 189.9 MB, 0.057 ms at
//       3.35 TB/s: bound by operations;
//   K3: 8 D FLOP per pair (S, dP, dV, dK) = 154.7 GFLOP, 0.156 ms;
//       bytes q, k, v, dO, dK, dV, lse, delta = 227.7 MB, 0.068 ms: bound by
//       operations.
// Both use mma.sync, which caps them well below Hopper's tensor-core rate.
// They serve bf16 at head_dim 32 and float32 on the main path; at head_dim
// 64 and 128 in bf16 the main path takes the Hopper redesigns
// (flash_bwd_dq_sm90.cu, which also computes delta, and
// flash_bwd_dkv_sm90.cu: wgmma, TMA, a producer warp), and these stay as
// the previous designs, which chip_smoke.py times beside them. The
// wrapper's shape rule (kernels/flash.py::_instance) picks them.
//
// The float32 instances (plain FMAs, one thread per query row in K2 and per
// key in K3) serve float32 configs; at D = 128 their accumulators spill.

#include "flash_common.cuh"

namespace {

using namespace kgt;

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B, H, Tq]
  const float* delta;  // [B, H, Tq]
  void* dq;
  void* dk;
  void* dv;
  int B, H, Tq, Tk;
  long long qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh, dosb, dost, dosh;
  long long dqsb, dqst, dqsh, dksb, dkst, dksh, dvsb, dvst, dvsh;
  float scale;
  int q_offset, kv_offset, causal, window;
};

typedef __nv_bfloat16 bf16;

constexpr int BM = 64;   // K2: query rows per block
constexpr int BN = 64;   // K2: key tile; K3: keys per block
constexpr int BQ = 32;   // K3: query tile
constexpr int kThreads = 128;

// ---------------------------------------------------------------------------
// K2, bf16: dQ.

template <int D>
constexpr int dq_smem_bytes() {
  return 2 * 2 * BN * (D + 8) * static_cast<int>(sizeof(bf16));
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_bf16(const BwdParams p) {
  constexpr int LD = D + 8;  // 16-byte rows, conflict-free ldmatrix
  extern __shared__ __align__(16) unsigned char smem[];
  auto* Ks = reinterpret_cast<bf16*>(smem);  // [2][BN][LD]
  auto* Vs = Ks + 2 * BN * LD;               // [2][BN][LD]

  // Causal: the last query tiles see the most keys, so they start first.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;   // mma fragment row / column pair
  const int lm = lane >> 3, lr = lane & 7;  // ldmatrix matrix / row
  const auto* q = static_cast<const bf16*>(p.q) + b * p.qsb + h * p.qsh;
  const auto* k = static_cast<const bf16*>(p.k) + b * p.ksb + h * p.ksh;
  const auto* v = static_cast<const bf16*>(p.v) + b * p.vsb + h * p.vsh;
  const auto* dout =
      static_cast<const bf16*>(p.dout) + b * p.dosb + h * p.dosh;

  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const int qp0 = p.q_offset + r0, qp1 = p.q_offset + r1;
  const float scale2 = p.scale * kLog2e;

  // Q and dO as mma A fragments, in registers for the whole key loop; rows
  // past Tq are zero (their dS is then 0, and they are not stored).
  uint32_t qf[D / 16][4], df[D / 16][4];
  {
    const bool in0 = r0 < p.Tq, in1 = r1 < p.Tq;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk * 16 + tg * 2;
      qf[kk][0] = in0 ? load_u32(q + r0 * p.qst + c) : 0u;
      qf[kk][1] = in1 ? load_u32(q + r1 * p.qst + c) : 0u;
      qf[kk][2] = in0 ? load_u32(q + r0 * p.qst + c + 8) : 0u;
      qf[kk][3] = in1 ? load_u32(q + r1 * p.qst + c + 8) : 0u;
      df[kk][0] = in0 ? load_u32(dout + r0 * p.dost + c) : 0u;
      df[kk][1] = in1 ? load_u32(dout + r1 * p.dost + c) : 0u;
      df[kk][2] = in0 ? load_u32(dout + r0 * p.dost + c + 8) : 0u;
      df[kk][3] = in1 ? load_u32(dout + r1 * p.dost + c + 8) : 0u;
    }
  }
  const long long row_base = (static_cast<long long>(b) * p.H + h) * p.Tq;
  const float lse0 = r0 < p.Tq ? p.lse[row_base + r0] * kLog2e : 0.f;
  const float lse1 = r1 < p.Tq ? p.lse[row_base + r1] * kLog2e : 0.f;
  const float dl0 = r0 < p.Tq ? p.delta[row_base + r0] : 0.f;
  const float dl1 = r1 < p.Tq ? p.delta[row_base + r1] : 0.f;

  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  const int q_lo = p.q_offset + q0;
  const int q_hi = p.q_offset + min(q0 + BM, p.Tq) - 1;
  const int num_k = (p.Tk + BN - 1) / BN;
  // The visible key tiles form one range.
  int kt_lo = num_k, kt_hi = 0;
  for (int kt = 0; kt < num_k; ++kt) {
    if (tile_visible(p, q_lo, q_hi, p.kv_offset + kt * BN,
                     p.kv_offset + min(kt * BN + BN, p.Tk) - 1)) {
      kt_lo = min(kt_lo, kt);
      kt_hi = kt + 1;
    }
  }

  auto stage = [&](int kt, int buf) {  // rows past Tk are zero-filled
    constexpr int kChunks = BN * D / 8;
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
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* ks = Ks + buf * BN * LD;
    const bf16* vs = Vs + buf * BN * LD;
    const int k0 = kt * BN;
    const int k_lo = p.kv_offset + k0;
    const int k_hi = p.kv_offset + min(k0 + BN, p.Tk) - 1;
    const bool masked = k0 + BN > p.Tk || !tile_full(p, q_lo, q_hi, k_lo, k_hi);

    // dS of 16 rows x BN keys per warp, as bf16 A fragments of dS K.
    uint32_t dsf[BN / 16][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < D / 16; kk += 2) {
        uint32_t bf[4];
        ldsm_x4(bf, &ks[(nt * 8 + lr) * LD + kk * 16 + lm * 8]);
        mma_bf16(s, qf[kk], bf[0], bf[1]);
        mma_bf16(s, qf[kk + 1], bf[2], bf[3]);
        ldsm_x4(bf, &vs[(nt * 8 + lr) * LD + kk * 16 + lm * 8]);
        mma_bf16(dp, df[kk], bf[0], bf[1]);
        mma_bf16(dp, df[kk + 1], bf[2], bf[3]);
      }
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[e] * scale2 - (e < 2 ? lse0 : lse1);
        if (masked) {
          const int col = k0 + nt * 8 + tg * 2 + (e & 1);
          if (!(col < p.Tk &&
                visible(p, e < 2 ? qp0 : qp1, p.kv_offset + col)))
            x = -INFINITY;  // P = exp2(-inf) = 0 exactly
        }
        ds[e] = exp2f(x) * (dp[e] - (e < 2 ? dl0 : dl1));
      }
      dsf[nt >> 1][(nt & 1) * 2] = pack_f32(ds[0], ds[1]);
      dsf[nt >> 1][(nt & 1) * 2 + 1] = pack_f32(ds[2], ds[3]);
    }

    // acc += dS K: one ldmatrix.x4.trans gives the B fragments of two
    // 8-dim column blocks of K.
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
      for (int dt = 0; dt < D / 8; dt += 2) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, &ks[(kk * 16 + (lm & 1) * 8 + lr) * LD + dt * 8 +
                              (lm >> 1) * 8]);
        mma_bf16(acc[dt], dsf[kk], bf[0], bf[1]);
        mma_bf16(acc[dt + 1], dsf[kk], bf[2], bf[3]);
      }
    }
    __syncthreads();  // every warp is done with buf before it is restaged
  }

  auto* dq = static_cast<bf16*>(p.dq) + b * p.dqsb + h * p.dqsh;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + tg * 2;
    if (r0 < p.Tq)
      *reinterpret_cast<__nv_bfloat162*>(dq + r0 * p.dqst + c) =
          __floats2bfloat162_rn(acc[dt][0] * p.scale, acc[dt][1] * p.scale);
    if (r1 < p.Tq)
      *reinterpret_cast<__nv_bfloat162*>(dq + r1 * p.dqst + c) =
          __floats2bfloat162_rn(acc[dt][2] * p.scale, acc[dt][3] * p.scale);
  }
}

// ---------------------------------------------------------------------------
// K3, bf16: dK, dV.

template <int D>
constexpr int dkv_smem_bytes() {
  return (2 * BN * (D + 8) + 2 * 2 * BQ * (D + 8)) *
             static_cast<int>(sizeof(bf16)) +
         2 * 2 * BQ * static_cast<int>(sizeof(float));
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_bf16(const BwdParams p) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  auto* Ks = reinterpret_cast<bf16*>(smem);  // [BN][LD]
  auto* Vs = Ks + BN * LD;                   // [BN][LD]
  auto* Qs = Vs + BN * LD;                   // [2][BQ][LD]
  auto* Os = Qs + 2 * BQ * LD;               // dO, [2][BQ][LD]
  auto* Ls = reinterpret_cast<float*>(Os + 2 * BQ * LD);  // [2][BQ], log2
  auto* Dl = Ls + 2 * BQ;                                 // [2][BQ]

  // Causal: the first key tiles are seen by the most queries and start
  // first.
  const int k0 = blockIdx.x * BN;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int lm = lane >> 3, lr = lane & 7;
  const auto* q = static_cast<const bf16*>(p.q) + b * p.qsb + h * p.qsh;
  const auto* k = static_cast<const bf16*>(p.k) + b * p.ksb + h * p.ksh;
  const auto* v = static_cast<const bf16*>(p.v) + b * p.vsb + h * p.vsh;
  const auto* dout =
      static_cast<const bf16*>(p.dout) + b * p.dosb + h * p.dosh;
  const long long row_base = (static_cast<long long>(b) * p.H + h) * p.Tq;

  // This thread's two keys (fragment rows g and g + 8 of its warp).
  const int kr0 = k0 + warp * 16 + g, kr1 = kr0 + 8;
  const int kp0 = p.kv_offset + kr0, kp1 = p.kv_offset + kr1;
  const float scale2 = p.scale * kLog2e;

  {  // the block's K and V tile, once; rows past Tk are zero-filled
    constexpr int kChunks = BN * D / 8;
    for (int i = tid; i < kChunks; i += kThreads) {
      const int row = i / (D / 8), col = (i % (D / 8)) * 8;
      const bool in = k0 + row < p.Tk;
      const long long src = in ? k0 + row : 0;
      cp_async16(&Ks[row * LD + col], k + src * p.kst + col, in);
      cp_async16(&Vs[row * LD + col], v + src * p.vst + col, in);
    }
    cp_async_commit();
  }

  const int k_lo = p.kv_offset + k0;
  const int k_hi = p.kv_offset + min(k0 + BN, p.Tk) - 1;
  const int num_q = (p.Tq + BQ - 1) / BQ;
  // The query tiles that see this key tile form one range.
  int qt_lo = num_q, qt_hi = 0;
  for (int qt = 0; qt < num_q; ++qt) {
    if (tile_visible(p, p.q_offset + qt * BQ,
                     p.q_offset + min(qt * BQ + BQ, p.Tq) - 1, k_lo, k_hi)) {
      qt_lo = min(qt_lo, qt);
      qt_hi = qt + 1;
    }
  }

  // Q and dO rows past Tq are zero-filled, their lse and delta 0 (and
  // their columns masked).
  auto stage = [&](int qt, int buf) {
    constexpr int kChunks = BQ * D / 8;
    const int q0 = qt * BQ;
    for (int i = tid; i < kChunks; i += kThreads) {
      const int row = i / (D / 8), col = (i % (D / 8)) * 8;
      const bool in = q0 + row < p.Tq;
      const long long src = in ? q0 + row : 0;
      cp_async16(&Qs[(buf * BQ + row) * LD + col], q + src * p.qst + col, in);
      cp_async16(&Os[(buf * BQ + row) * LD + col],
                 dout + src * p.dost + col, in);
    }
    if (tid < BQ) {
      const int r = q0 + tid;
      Ls[buf * BQ + tid] = r < p.Tq ? p.lse[row_base + r] * kLog2e : 0.f;
      Dl[buf * BQ + tid] = r < p.Tq ? p.delta[row_base + r] : 0.f;
    }
    cp_async_commit();
  };

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    dk[dt][0] = dk[dt][1] = dk[dt][2] = dk[dt][3] = 0.f;
    dv[dt][0] = dv[dt][1] = dv[dt][2] = dv[dt][3] = 0.f;
  }
  if (qt_lo < qt_hi) stage(qt_lo, 0);

  for (int qt = qt_lo; qt < qt_hi; ++qt) {
    const int buf = (qt - qt_lo) & 1;
    if (qt + 1 < qt_hi) {
      stage(qt + 1, buf ^ 1);
      cp_async_wait<1>();  // K/V and tile qt have landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* qs = Qs + buf * BQ * LD;
    const bf16* os = Os + buf * BQ * LD;
    const float* ls = Ls + buf * BQ;
    const float* dl = Dl + buf * BQ;
    const int q0 = qt * BQ;
    const int q_lo = p.q_offset + q0;
    const int q_hi = p.q_offset + min(q0 + BQ, p.Tq) - 1;
    const bool masked = q0 + BQ > p.Tq || k0 + BN > p.Tk ||
                        !tile_full(p, q_lo, q_hi, k_lo, k_hi);

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x BQ queries per warp. K and
    // V give A fragments (ldmatrix), Q and dO B fragments (one ldmatrix.x4
    // serves two 8-query blocks).
    float s[BQ / 8][4], dp[BQ / 8][4];
#pragma unroll
    for (int nt = 0; nt < BQ / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ka[4], va[4];
      const int arow = (warp * 16 + (lm & 1) * 8 + lr) * LD + kk * 16 +
                       (lm >> 1) * 8;
      ldsm_x4(ka, &Ks[arow]);
      ldsm_x4(va, &Vs[arow]);
#pragma unroll
      for (int nt = 0; nt < BQ / 8; nt += 2) {
        const int brow = ((nt + (lm >> 1)) * 8 + lr) * LD + kk * 16 +
                         (lm & 1) * 8;
        uint32_t bq[4], bo[4];
        ldsm_x4(bq, &qs[brow]);
        mma_bf16(s[nt], ka, bq[0], bq[1]);
        mma_bf16(s[nt + 1], ka, bq[2], bq[3]);
        ldsm_x4(bo, &os[brow]);
        mma_bf16(dp[nt], va, bo[0], bo[1]);
        mma_bf16(dp[nt + 1], va, bo[2], bo[3]);
      }
    }

    // P^T = exp2(S^T scale2 - lse2), dS^T = P^T o (dP^T - delta); the
    // query is the column.
#pragma unroll
    for (int nt = 0; nt < BQ / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = nt * 8 + tg * 2 + (e & 1);
        float x = s[nt][e] * scale2 - ls[qc];
        if (masked && !(q0 + qc < p.Tq && (e < 2 ? kr0 : kr1) < p.Tk &&
                        visible(p, p.q_offset + q0 + qc, e < 2 ? kp0 : kp1)))
          x = -INFINITY;
        const float pe = exp2f(x);
        s[nt][e] = pe;
        dp[nt][e] = pe * (dp[nt][e] - dl[qc]);
      }
    }

    // dV += P^T dO and dK += dS^T Q: the accumulators of query columns
    // 16kk..16kk+15 are exactly the A fragment of that 16-query step.
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t pa[4], da[4];
      pa[0] = pack_f32(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_f32(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      da[0] = pack_f32(dp[2 * kk][0], dp[2 * kk][1]);
      da[1] = pack_f32(dp[2 * kk][2], dp[2 * kk][3]);
      da[2] = pack_f32(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
      da[3] = pack_f32(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
#pragma unroll
      for (int dt = 0; dt < D / 8; dt += 2) {
        const int row = (kk * 16 + (lm & 1) * 8 + lr) * LD + dt * 8 +
                        (lm >> 1) * 8;
        uint32_t bf[4];
        ldsm_x4_trans(bf, &os[row]);
        mma_bf16(dv[dt], pa, bf[0], bf[1]);
        mma_bf16(dv[dt + 1], pa, bf[2], bf[3]);
        ldsm_x4_trans(bf, &qs[row]);
        mma_bf16(dk[dt], da, bf[0], bf[1]);
        mma_bf16(dk[dt + 1], da, bf[2], bf[3]);
      }
    }
    __syncthreads();  // every warp is done with buf before it is restaged
  }
  cp_async_wait<0>();  // no copy outlives the block, even with no tile seen

  auto* dkp = static_cast<bf16*>(p.dk) + b * p.dksb + h * p.dksh;
  auto* dvp = static_cast<bf16*>(p.dv) + b * p.dvsb + h * p.dvsh;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + tg * 2;
    if (kr0 < p.Tk) {
      *reinterpret_cast<__nv_bfloat162*>(dkp + kr0 * p.dkst + c) =
          __floats2bfloat162_rn(dk[dt][0] * p.scale, dk[dt][1] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(dvp + kr0 * p.dvst + c) =
          __floats2bfloat162_rn(dv[dt][0], dv[dt][1]);
    }
    if (kr1 < p.Tk) {
      *reinterpret_cast<__nv_bfloat162*>(dkp + kr1 * p.dkst + c) =
          __floats2bfloat162_rn(dk[dt][2] * p.scale, dk[dt][3] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(dvp + kr1 * p.dvst + c) =
          __floats2bfloat162_rn(dv[dt][2], dv[dt][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// float32: plain FMAs. K2: one thread per query row, 8-key tiles. K3: one
// thread per key, 8-row query tiles.

constexpr int F_ROWS = 32;  // threads per block, one row each
constexpr int F_TILE = 8;   // the other side's tile

template <int D>
__global__ void __launch_bounds__(F_ROWS) flash_bwd_dq_f32(const BwdParams p) {
  __shared__ float Qs[F_ROWS * (D + 1)];  // +1: thread rows in distinct banks
  __shared__ float Os[F_ROWS * (D + 1)];
  __shared__ float Ks[F_TILE * D];
  __shared__ float Vs[F_TILE * D];

  const int q0 = blockIdx.x * F_ROWS, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const auto* q = static_cast<const float*>(p.q) + b * p.qsb + h * p.qsh;
  const auto* k = static_cast<const float*>(p.k) + b * p.ksb + h * p.ksh;
  const auto* v = static_cast<const float*>(p.v) + b * p.vsb + h * p.vsh;
  const auto* dout =
      static_cast<const float*>(p.dout) + b * p.dosb + h * p.dosh;
  for (int i = tid; i < F_ROWS * D; i += F_ROWS) {
    const int row = i / D, col = i % D;
    const bool in = q0 + row < p.Tq;
    Qs[row * (D + 1) + col] = in ? q[(q0 + row) * p.qst + col] : 0.f;
    Os[row * (D + 1) + col] = in ? dout[(q0 + row) * p.dost + col] : 0.f;
  }
  const int r = q0 + tid, qp = p.q_offset + r;
  const long long rowi = (static_cast<long long>(b) * p.H + h) * p.Tq + r;
  const float lse = r < p.Tq ? p.lse[rowi] : 0.f;
  const float dl = r < p.Tq ? p.delta[rowi] : 0.f;
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;

  const int q_lo = p.q_offset + q0;
  const int q_hi = p.q_offset + min(q0 + F_ROWS, p.Tq) - 1;
  const int num_k = (p.Tk + F_TILE - 1) / F_TILE;
  for (int kt = 0; kt < num_k; ++kt) {
    const int k0 = kt * F_TILE;
    if (!tile_visible(p, q_lo, q_hi, p.kv_offset + k0,
                      p.kv_offset + min(k0 + F_TILE, p.Tk) - 1))
      continue;
    __syncthreads();
    for (int i = tid; i < F_TILE * D; i += F_ROWS) {
      const int row = i / D, col = i % D;
      const bool in = k0 + row < p.Tk;
      Ks[i] = in ? k[(k0 + row) * p.kst + col] : 0.f;
      Vs[i] = in ? v[(k0 + row) * p.vst + col] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < F_TILE; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        s = fmaf(Qs[tid * (D + 1) + d], Ks[j * D + d], s);
        dp = fmaf(Os[tid * (D + 1) + d], Vs[j * D + d], dp);
      }
      const bool ok = k0 + j < p.Tk && visible(p, qp, p.kv_offset + k0 + j);
      const float ds = ok ? expf(s * p.scale - lse) * (dp - dl) : 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(ds, Ks[j * D + d], acc[d]);
    }
  }
  if (r < p.Tq) {
    float* dq = static_cast<float*>(p.dq) + b * p.dqsb + h * p.dqsh +
                r * p.dqst;
#pragma unroll
    for (int d = 0; d < D; ++d) dq[d] = acc[d] * p.scale;
  }
}

template <int D>
__global__ void __launch_bounds__(F_ROWS) flash_bwd_dkv_f32(const BwdParams p) {
  __shared__ float Ks[F_ROWS * (D + 1)];
  __shared__ float Vs[F_ROWS * (D + 1)];
  __shared__ float Qs[F_TILE * D];
  __shared__ float Os[F_TILE * D];
  __shared__ float Ls[F_TILE];
  __shared__ float Dl[F_TILE];

  const int k0 = blockIdx.x * F_ROWS, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const auto* q = static_cast<const float*>(p.q) + b * p.qsb + h * p.qsh;
  const auto* k = static_cast<const float*>(p.k) + b * p.ksb + h * p.ksh;
  const auto* v = static_cast<const float*>(p.v) + b * p.vsb + h * p.vsh;
  const auto* dout =
      static_cast<const float*>(p.dout) + b * p.dosb + h * p.dosh;
  const long long row_base = (static_cast<long long>(b) * p.H + h) * p.Tq;
  for (int i = tid; i < F_ROWS * D; i += F_ROWS) {
    const int row = i / D, col = i % D;
    const bool in = k0 + row < p.Tk;
    Ks[row * (D + 1) + col] = in ? k[(k0 + row) * p.kst + col] : 0.f;
    Vs[row * (D + 1) + col] = in ? v[(k0 + row) * p.vst + col] : 0.f;
  }
  const int kr = k0 + tid, kp = p.kv_offset + kr;
  float dk[D], dv[D];
#pragma unroll
  for (int d = 0; d < D; ++d) dk[d] = dv[d] = 0.f;

  const int k_lo = p.kv_offset + k0;
  const int k_hi = p.kv_offset + min(k0 + F_ROWS, p.Tk) - 1;
  const int num_q = (p.Tq + F_TILE - 1) / F_TILE;
  for (int qt = 0; qt < num_q; ++qt) {
    const int q0 = qt * F_TILE;
    if (!tile_visible(p, p.q_offset + q0,
                      p.q_offset + min(q0 + F_TILE, p.Tq) - 1, k_lo, k_hi))
      continue;
    __syncthreads();
    for (int i = tid; i < F_TILE * D; i += F_ROWS) {
      const int row = i / D, col = i % D;
      const bool in = q0 + row < p.Tq;
      Qs[i] = in ? q[(q0 + row) * p.qst + col] : 0.f;
      Os[i] = in ? dout[(q0 + row) * p.dost + col] : 0.f;
    }
    if (tid < F_TILE) {
      const bool in = q0 + tid < p.Tq;
      Ls[tid] = in ? p.lse[row_base + q0 + tid] : 0.f;
      Dl[tid] = in ? p.delta[row_base + q0 + tid] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < F_TILE; ++i) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        s = fmaf(Ks[tid * (D + 1) + d], Qs[i * D + d], s);
        dp = fmaf(Vs[tid * (D + 1) + d], Os[i * D + d], dp);
      }
      const bool ok = q0 + i < p.Tq && kr < p.Tk &&
                      visible(p, p.q_offset + q0 + i, kp);
      const float pi = ok ? expf(s * p.scale - Ls[i]) : 0.f;
      const float ds = pi * (dp - Dl[i]);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        dv[d] = fmaf(pi, Os[i * D + d], dv[d]);
        dk[d] = fmaf(ds, Qs[i * D + d], dk[d]);
      }
    }
  }
  if (kr < p.Tk) {
    float* dkp = static_cast<float*>(p.dk) + b * p.dksb + h * p.dksh +
                 kr * p.dkst;
    float* dvp = static_cast<float*>(p.dv) + b * p.dvsb + h * p.dvsh +
                 kr * p.dvst;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      dkp[d] = dk[d] * p.scale;
      dvp[d] = dv[d];
    }
  }
}

template <int D>
cudaError_t launch_dq(const BwdParams& p, int dtype, cudaStream_t stream) {
  if (dtype == 0) {
    constexpr int smem = dq_smem_bytes<D>();
    const cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((p.Tq + BM - 1) / BM, p.H, p.B);
    flash_bwd_dq_bf16<D><<<grid, kThreads, smem, stream>>>(p);
  } else {
    const dim3 grid((p.Tq + F_ROWS - 1) / F_ROWS, p.H, p.B);
    flash_bwd_dq_f32<D><<<grid, F_ROWS, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const BwdParams& p, int dtype, cudaStream_t stream) {
  if (dtype == 0) {
    constexpr int smem = dkv_smem_bytes<D>();
    const cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkv_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((p.Tk + BN - 1) / BN, p.H, p.B);
    flash_bwd_dkv_bf16<D><<<grid, kThreads, smem, stream>>>(p);
  } else {
    const dim3 grid((p.Tk + F_ROWS - 1) / F_ROWS, p.H, p.B);
    flash_bwd_dkv_f32<D><<<grid, F_ROWS, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

BwdParams make_params(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      int B, int H, int Tq, int Tk, const long long* st,
                      float scale, int q_offset, int kv_offset, int causal,
                      int window) {
  BwdParams p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.B = B;
  p.H = H;
  p.Tq = Tq;
  p.Tk = Tk;
  p.qsb = st[0]; p.qst = st[1]; p.qsh = st[2];
  p.ksb = st[3]; p.kst = st[4]; p.ksh = st[5];
  p.vsb = st[6]; p.vst = st[7]; p.vsh = st[8];
  p.dosb = st[9]; p.dost = st[10]; p.dosh = st[11];
  p.scale = scale;
  p.q_offset = q_offset;
  p.kv_offset = kv_offset;
  p.causal = causal;
  p.window = window;
  return p;
}

bool bad_args(int dtype, int B, int H, int Tq, int Tk) {
  return (dtype != 0 && dtype != 1) || B < 1 || H < 1 || Tq < 1 || Tk < 1;
}

}  // namespace

// dtype: 0 = bf16, 1 = float32. ``in_strides`` holds the B, T and H strides
// (elements) of q, k, v and dO, in that order (12 values); D has unit
// stride. lse and delta are [B, H, Tq] float32, contiguous. Each returns
// cudaGetLastError() after its launch.
extern "C" int kgt_flash_bwd_dq_mma(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int dtype, int B, int H,
    int Tq, int Tk, int D, const long long* in_strides, long long dqsb,
    long long dqst, long long dqsh, float scale, int q_offset, int kv_offset,
    int causal, int window, void* stream) {
  if (bad_args(dtype, B, H, Tq, Tk))
    return static_cast<int>(cudaErrorInvalidValue);
  BwdParams p = make_params(q, k, v, dout, lse, delta, B, H, Tq, Tk,
                            in_strides, scale, q_offset, kv_offset, causal,
                            window);
  p.dq = dq;
  p.dqsb = dqsb;
  p.dqst = dqst;
  p.dqsh = dqsh;
  auto st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return static_cast<int>(launch_dq<32>(p, dtype, st));
    case 64: return static_cast<int>(launch_dq<64>(p, dtype, st));
    case 128: return static_cast<int>(launch_dq<128>(p, dtype, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int kgt_flash_bwd_dkv_mma(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int dtype, int B,
    int H, int Tq, int Tk, int D, const long long* in_strides,
    long long dksb, long long dkst, long long dksh, long long dvsb,
    long long dvst, long long dvsh, float scale, int q_offset, int kv_offset,
    int causal, int window, void* stream) {
  if (bad_args(dtype, B, H, Tq, Tk))
    return static_cast<int>(cudaErrorInvalidValue);
  BwdParams p = make_params(q, k, v, dout, lse, delta, B, H, Tq, Tk,
                            in_strides, scale, q_offset, kv_offset, causal,
                            window);
  p.dk = dk;
  p.dv = dv;
  p.dksb = dksb;
  p.dkst = dkst;
  p.dksh = dksh;
  p.dvsb = dvsb;
  p.dvst = dvst;
  p.dvsh = dvsh;
  auto st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return static_cast<int>(launch_dkv<32>(p, dtype, st));
    case 64: return static_cast<int>(launch_dkv<64>(p, dtype, st));
    case 128: return static_cast<int>(launch_dkv<128>(p, dtype, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
