// Flash attention backward, dQ (K2), for Hopper (sm_90a), bf16 at head_dim
// 64 and 128, plain C interface for ctypes: the main path's instance. It
// also computes the backward's row term delta, which K3 then reads.
//
// Replaces kubegpu_tpu/workload/kernels/flash.py::_dq_kernel with the
// conventions of flash_bwd.cu (whose mma.sync K2 stays for head_dim 32 and
// float32, and as the previous design for comparison): S = scale Q K^T and
// P = exp(S - lse) recomputed tile by tile in log2 units, dP = dO V^T,
// dS = P o (dP - delta), dQ = scale dS K. Masking at global positions,
// tiles the mask hides skipped, any Tq, Tk >= 1. No atomics: each dQ
// element is owned by one thread, so the result is deterministic. dS is
// cast to bf16 before its product, with float32 accumulation.
//
// delta = rowsum(dO o O) - dlse is computed here, in float32, where the
// reference leaves it to XLA outside its kernels (flash.py:285-294): O
// arrives by TMA beside Q and dO, and each consumer warp sums its 16 rows
// of the two resident tiles in a prologue (both tiles are swizzled alike,
// so a row's bytes pair up at equal offsets), keeps its lanes' two rows
// in registers and writes delta [B, H, Tq] for K3. (A prologue that read
// O and dO from global memory instead stalled every block before its
// first product: 0.093 ms of 0.513 at the training shape, measured with
// tools/ablate_flash_sm90.py on that design.)
//
// What bounds it on an H100 SXM, at the training shape (B=4, T=2048,
// H=18, D=128, causal; 151.07M visible pairs): 6 D FLOP a pair (S, dP, dQ)
// = 116.0 GFLOP, 0.117 ms at 989 TFLOP/s, against q, k, v, dO, O, dQ,
// lse, delta = 227.7 MB, 0.068 ms at 3.35 TB/s: operations. The mma.sync
// design (flash_bwd.cu) reached about 190 TFLOP/s: mma.sync cannot reach
// Hopper's tensor-core rate, every thread staged K and V behind a
// __syncthreads() per tile, and each K/V tile fed only 64 query rows.
//
// The design here (K3's, flash_bwd_dkv_sm90.cu, with the roles of queries
// and keys swapped):
// - One block per (b, h, 128-row query tile): two consumer warpgroups of 64
//   rows each and a producer warpgroup, of which one thread works. The
//   query tiles that see the most keys start first.
// - Q, dO and O of the block are loaded once by TMA and stay in shared
//   memory. K and V arrive in a three-stage TMA ring of 64-key tiles, each
//   used by all 128 rows (two or four stages measured no faster). TMA
//   zero-fills rows past Tq or Tk. lse and delta are per row, so they stay
//   in registers.
// - S = Q K^T and dP = dO V^T are wgmma m64n64k16 with both operands
//   K-major in shared memory. P = exp2(S scale2 - lse2) and dS = P o
//   (dP - delta) are computed on the accumulators (the mask in a pass of
//   its own, on the tiles it cuts), then packed to bf16 as the register A
//   operand of dQ += dS K (wgmma m64nDk16, K MN-major from its ring
//   stage). A tile the mask hides from all 64 rows of a warpgroup is only
//   released. The two warpgroups work in step; taking turns to issue
//   their products (ping-pong) measured slower.
// - dQ is scaled once in the epilogue and stored as bf16.
// - setmaxnreg: 384 threads launch at 168 registers; the producer
//   warpgroup drops to 40 and the consumers rise to 232, room for the 64
//   dQ and 32 + 32 S, dP accumulators beside the packed operand.

#include "flash_sm90.cuh"

namespace {

using namespace kgt;

constexpr int BM = 128;  // query rows per block
constexpr int BN = 64;   // keys per tile
constexpr int kStages = 3;
constexpr int kConsumerWarps = 8;  // two warpgroups
constexpr int kThreads = 32 * kConsumerWarps + 128;  // + the producer's
// Registers a thread after setmaxnreg: 384 threads launch at 168 each; the
// producer warpgroup drops to 40 and the consumers rise to 232.
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

struct Params {
  CUtensorMap tq, tk, tv, tdo, to;  // 4-D maps over (D, T, H, B)
  const float* lse;                 // [B, H, Tq]
  const float* dlse;                // [B, H, Tq], or null
  float* delta;                     // [B, H, Tq], written
  void* dq;
  int B, H, Tq, Tk;
  long long dqsb, dqst, dqsh;
  float scale;
  int q_offset, kv_offset, causal, window;
};

// Shared-memory layout (byte offsets from a 1024-byte boundary).
template <int D>
struct Layout {
  static constexpr int kBoxes = D / 64;
  static constexpr int kQBytes = BM * D * 2;     // Q, dO or O of the block
  static constexpr int kQBoxBytes = BM * 128;    // one box of those
  static constexpr int kTileBytes = BN * D * 2;  // one K or V tile
  static constexpr int kBoxBytes = BN * 128;     // one box of such a tile
  static constexpr int kQ = 0;
  static constexpr int kDO = kQBytes;
  static constexpr int kO = 2 * kQBytes;
  static constexpr int kK = 3 * kQBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBar = kV + kStages * kTileBytes;
  static constexpr int kBytes = kBar + 128 + 1024;  // + alignment slack
  static_assert(kBytes <= 232448, "more shared memory than a block has");
};

// sum_i a[i] b[i] over E bf16 values from 2E-byte aligned addresses.
template <int E>
__device__ __forceinline__ float dot_bf16(const void* a, const void* b) {
  static_assert(E == 2 || E == 4, "one or two bf16 pairs");
  uint32_t x[E / 2], y[E / 2];
  if constexpr (E == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(a);
    const uint2 w = *reinterpret_cast<const uint2*>(b);
    x[0] = u.x, x[1] = u.y, y[0] = w.x, y[1] = w.y;
  } else {
    x[0] = *reinterpret_cast<const uint32_t*>(a);
    y[0] = *reinterpret_cast<const uint32_t*>(b);
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < E / 2; ++i) {
    const float2 fa =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x[i]));
    const float2 fb =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&y[i]));
    s = fmaf(fa.x, fb.x, s);
    s = fmaf(fa.y, fb.y, s);
  }
  return s;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_sm90(const __grid_constant__ Params p) {
  using L = Layout<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  auto* q_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full = q_full + 1;       // [kStages]
  uint64_t* empty = full + kStages;  // [kStages]

  // Causal: the last query tiles see the most keys, so they start first.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

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
  const int n_tiles = max(kt_hi - kt_lo, 0);

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // Producer warpgroup: one thread issues every copy.
    reg_dealloc<kProducerRegs>();
    if (warp != kConsumerWarps || lane != 0) return;
    mbar_expect_tx(q_full, 3 * L::kQBytes);
    for (int c = 0; c < L::kBoxes; ++c) {
      tma_load_4d(smem + L::kQ + c * L::kQBoxBytes, &p.tq, q_full, c * 64,
                  q0, h, b);
      tma_load_4d(smem + L::kDO + c * L::kQBoxBytes, &p.tdo, q_full, c * 64,
                  q0, h, b);
      tma_load_4d(smem + L::kO + c * L::kQBoxBytes, &p.to, q_full, c * 64,
                  q0, h, b);
    }
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);  // first round passes
      const int k0 = (kt_lo + i) * BN;
      mbar_expect_tx(&full[s], 2 * L::kTileBytes);
      for (int c = 0; c < L::kBoxes; ++c) {
        tma_load_4d(smem + L::kK + s * L::kTileBytes + c * L::kBoxBytes,
                    &p.tk, &full[s], c * 64, k0, h, b);
        tma_load_4d(smem + L::kV + s * L::kTileBytes + c * L::kBoxBytes,
                    &p.tv, &full[s], c * 64, k0, h, b);
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns query rows w0 .. w0 + 63.
  reg_alloc<kConsumerRegs>();
  const int wg = warp >> 2, wl = warp & 3;
  const int g = lane >> 2, tg = lane & 3;
  const int w0 = q0 + wg * 64;
  const int r0 = w0 + wl * 16 + g, r1 = r0 + 8;
  const int qp0 = p.q_offset + r0, qp1 = p.q_offset + r1;
  const float scale2 = p.scale * kLog2e;
  const long long row_base = (static_cast<long long>(b) * p.H + h) * p.Tq;

  const unsigned char* qs = smem + L::kQ + wg * 64 * 128;
  const unsigned char* dos = smem + L::kDO + wg * 64 * 128;
  mbar_wait(q_full, 0);

  // delta of this warp's 16 rows from the resident dO and O tiles, lanes
  // across a row (E values each), then a warp sum; the lanes of row g keep
  // it as dl0, those of row g + 8 as dl1. Rows past Tq (zero-filled): 0,
  // not written.
  float dl0 = 0.f, dl1 = 0.f;
  {
    constexpr int E = D / 32;  // values a lane
    const int at = lane * E * 2;  // the lane's bytes in a row of D values
    const int off = (at / 128) * L::kQBoxBytes + at % 128;
    const int wr = wg * 64 + wl * 16;  // the warp's first row in the block
    float part[16];
#pragma unroll
    for (int j = 0; j < 16; ++j)
      part[j] = dot_bf16<E>(smem + L::kO + off + (wr + j) * 128,
                            smem + L::kDO + off + (wr + j) * 128);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      float d = part[j];
#pragma unroll
      for (int sh = 16; sh > 0; sh >>= 1)
        d += __shfl_xor_sync(0xffffffffu, d, sh);
      const int r = q0 + wr + j;
      if (r < p.Tq) {
        if (p.dlse != nullptr) d -= p.dlse[row_base + r];
        if (lane == 0) p.delta[row_base + r] = d;
      }
      if (j == g) dl0 = d;
      if (j == g + 8) dl1 = d;
    }
  }
  const float ls0 = r0 < p.Tq ? p.lse[row_base + r0] * kLog2e : 0.f;
  const float ls1 = r1 < p.Tq ? p.lse[row_base + r1] * kLog2e : 0.f;

  float dq[D / 2];  // 64 rows x D per warpgroup
#pragma unroll
  for (int j = 0; j < D / 2; ++j) dq[j] = 0.f;

  const int wq_lo = p.q_offset + w0;
  const int wq_hi = p.q_offset + min(w0 + 64, p.Tq) - 1;
  const bool live = w0 < p.Tq;

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages, phase = (i / kStages) & 1;
    const int k0 = (kt_lo + i) * BN;
    const unsigned char* ks = smem + L::kK + s * L::kTileBytes;
    const unsigned char* vs = smem + L::kV + s * L::kTileBytes;
    const int k_lo = p.kv_offset + k0;
    const int k_hi = p.kv_offset + min(k0 + BN, p.Tk) - 1;
    // Waited for even when skipped, so no warp runs a round ahead on the
    // stage's "empty" barrier.
    mbar_wait(&full[s], phase);
    if (live && tile_visible(p, wq_lo, wq_hi, k_lo, k_hi)) {
      const bool masked = w0 + 64 > p.Tq || k0 + BN > p.Tk ||
                          !tile_full(p, wq_lo, wq_hi, k_lo, k_hi);

      // S = Q K^T and dP = dO V^T: 64 rows x 64 keys; the first step
      // writes them without reading them.
      float sc[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int q_off = (kk / 4) * L::kQBoxBytes + (kk % 4) * 32;
        const int kv_off = (kk / 4) * L::kBoxBytes + (kk % 4) * 32;
        const uint64_t q_desc = sw128_desc(qs + q_off, 16, 1024);
        const uint64_t k_desc = sw128_desc(ks + kv_off, 16, 1024);
        const uint64_t do_desc = sw128_desc(dos + q_off, 16, 1024);
        const uint64_t v_desc = sw128_desc(vs + kv_off, 16, 1024);
        if (kk == 0) {
          wgmma_ss_n64_first(sc, q_desc, k_desc);
          wgmma_ss_n64_first(dp, do_desc, v_desc);
        } else {
          wgmma_ss_n64(sc, q_desc, k_desc);
          wgmma_ss_n64(dp, do_desc, v_desc);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(sc);
      fence_acc(dp);

      // Masked scores -inf, so P = exp2(-inf) = 0 exactly; the key is the
      // column. A pass of its own, taken by the tiles the mask cuts only:
      // the same test inside the loop below costs about 0.14 ms at the
      // training shape (tools/ablate_flash_sm90.py, variant mask_in_loop).
      if (masked) {
#pragma unroll
        for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = k0 + nt * 8 + tg * 2 + (e & 1);
            if (!(col < p.Tk &&
                  visible(p, e < 2 ? qp0 : qp1, p.kv_offset + col)))
              sc[nt * 4 + e] = -INFINITY;
          }
        }
      }
      // P = exp2(S scale2 - lse2), dS = P o (dP - delta).
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = fmaf(sc[nt * 4 + e], scale2, -(e < 2 ? ls0 : ls1));
          dp[nt * 4 + e] = ex2(x) * (dp[nt * 4 + e] - (e < 2 ? dl0 : dl1));
        }
      }
      // dS as bf16 register A operands, one per 16 keys.
      uint32_t da[BN / 16][4];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
          da[kk][r] = pack_f32(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
      }

      // dQ += dS K: key rows are the reduction (16 keys = 2048 bytes a
      // step). It is waited for at once: a wgmma left in flight across the
      // next tile's products makes ptxas serialize every wgmma of the
      // kernel.
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_rs_mn<D>(dq, da[kk], ks + kk * 2048, L::kBoxBytes);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(dq);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with stage s
  }

  auto* dqp = static_cast<__nv_bfloat16*>(p.dq) + b * p.dqsb + h * p.dqsh;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + tg * 2;
    if (r0 < p.Tq)
      *reinterpret_cast<__nv_bfloat162*>(dqp + r0 * p.dqst + col) =
          __floats2bfloat162_rn(dq[dt * 4 + 0] * p.scale,
                                dq[dt * 4 + 1] * p.scale);
    if (r1 < p.Tq)
      *reinterpret_cast<__nv_bfloat162*>(dqp + r1 * p.dqst + col) =
          __floats2bfloat162_rn(dq[dt * 4 + 2] * p.scale,
                                dq[dt * 4 + 3] * p.scale);
  }
}

template <int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int smem = Layout<D>::kBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_sm90<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Tq + BM - 1) / BM, p.H, p.B);
  flash_bwd_dq_sm90<D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype must be 0 (bf16) and D 64 or 128. ``in_strides`` holds the B, T and
// H strides (elements) of q, k, v, dO and O, in that order (15 values); D
// has unit stride, bases are 16-byte aligned and strides multiples of 8
// elements (the tensor maps need that). lse and dlse (null: no lse
// cotangent) are [B, H, Tq] float32, contiguous; delta, [B, H, Tq] float32
// contiguous, is written. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments it does not take.
extern "C" int kgt_flash_bwd_dq_sm90(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* o, const void* dlse, void* dq, void* delta,
    int dtype, int B, int H, int Tq, int Tk, int D,
    const long long* in_strides, long long dqsb, long long dqst,
    long long dqsh, float scale, int q_offset, int kv_offset, int causal,
    int window, void* stream) {
  if (dtype != 0 || (D != 64 && D != 128) || B < 1 || H < 1 || Tq < 1 ||
      Tk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long* st = in_strides;
  Params p{};
  if (!make_map(&p.tq, q, B, Tq, H, D, st[0], st[1], st[2], BM) ||
      !make_map(&p.tk, k, B, Tk, H, D, st[3], st[4], st[5], BN) ||
      !make_map(&p.tv, v, B, Tk, H, D, st[6], st[7], st[8], BN) ||
      !make_map(&p.tdo, dout, B, Tq, H, D, st[9], st[10], st[11], BM) ||
      !make_map(&p.to, o, B, Tq, H, D, st[12], st[13], st[14], BM))
    return static_cast<int>(cudaErrorInvalidValue);
  p.lse = static_cast<const float*>(lse);
  p.dlse = static_cast<const float*>(dlse);
  p.delta = static_cast<float*>(delta);
  p.dq = dq;
  p.B = B;
  p.H = H;
  p.Tq = Tq;
  p.Tk = Tk;
  p.dqsb = dqsb;
  p.dqst = dqst;
  p.dqsh = dqsh;
  p.scale = scale;
  p.q_offset = q_offset;
  p.kv_offset = kv_offset;
  p.causal = causal;
  p.window = window;
  auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(D == 64 ? launch<64>(p, s) : launch<128>(p, s));
}
