// Flash attention backward, dK and dV (K3), for Hopper (sm_90a), bf16 at
// head_dim 64 and 128, plain C interface for ctypes: the main path's
// instance.
//
// Replaces kubegpu_tpu/workload/kernels/flash.py::_dkv_kernel with the
// conventions of flash_bwd.cu (whose mma.sync K3 stays for head_dim 32 and
// float32, and as the previous design for comparison): S = scale Q K^T and
// P = exp(S - lse) recomputed tile by tile in log2 units, dP = dO V^T,
// dS = P o (dP - delta) with delta = rowsum(dO o O) - dlse as K2
// (flash_bwd_dq_sm90.cu) wrote it; dV = P^T dO, dK = scale dS^T Q.
// Masking at global positions, tiles the mask hides skipped, any Tq,
// Tk >= 1. No atomics: each dK/dV element is owned by one thread, so the
// result is deterministic. P and dS are cast to bf16 before their
// products, with float32 accumulation.
//
// What bounds it on an H100 SXM, at the training shape (B=4, T=2048,
// H=18, D=128, causal; 151.07M visible pairs): 8 D FLOP a pair (S, dP, dV,
// dK) = 154.7 GFLOP, 0.156 ms at 989 TFLOP/s, against 227.7 MB, 0.068 ms
// at 3.35 TB/s: operations. The mma.sync design (flash_bwd.cu) reached
// about 180 TFLOP/s; it used each staged 32-row Q/dO tile for only 64
// keys, had every thread stage Q, dO, lse and delta behind a
// __syncthreads() per tile, and re-read every operand through ldmatrix.
//
// The design here:
// - One block per (b, h, 128-key block): two consumer warpgroups of 64 keys
//   each and a producer warpgroup, of which one warp works. The key blocks
//   seen by the most queries start first.
// - K and V of the block are loaded once by TMA and stay in shared memory.
//   Q and dO arrive in a three-stage TMA ring of 64-row query tiles (twice
//   the mma.sync design's 32), each used by all 128 keys; the producer
//   warp's lanes copy the tile's lse (times log2 e) and delta into the
//   same stage and arrive on its "full" mbarrier beside the TMA bytes. TMA
//   zero-fills rows past Tq or Tk.
// - S^T = K Q^T and dP^T = V dO^T are wgmma m64n64k16 with both operands
//   K-major in shared memory. P^T = exp2(S^T scale2 - lse2) and dS^T = P^T o
//   (dP^T - delta) are computed on the accumulators (key rows, query
//   columns), then packed to bf16 as register A operands of dV += P^T dO
//   and dK += dS^T Q (wgmma m64nDk16, dO and Q MN-major from shared
//   memory).
// - dK is scaled once in the epilogue; dK and dV are stored as bf16.
// - setmaxnreg: 384 threads launch at 168 registers, which cannot hold a
//   consumer's 64 + 64 dK, dV and 32 + 32 S^T, dP^T accumulators beside
//   the packed operands (168 spilled); the producer warpgroup drops to 40
//   and the consumers rise to 232. No spills.

#include "flash_sm90.cuh"

namespace {

using namespace kgt;

constexpr int BN = 128;  // keys per block
constexpr int BQ = 64;   // query rows per tile
constexpr int kStages = 3;
constexpr int kConsumerWarps = 8;  // two warpgroups
constexpr int kThreads = 32 * kConsumerWarps + 128;  // + the producer's
// Registers a thread after setmaxnreg: 384 threads launch at 168 each; the
// producer warpgroup drops to 40 and the consumers rise to 232.
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

struct Params {
  CUtensorMap tq, tk, tv, tdo;  // 4-D maps over (D, T, H, B)
  const float* lse;    // [B, H, Tq]
  const float* delta;  // [B, H, Tq]
  void* dk;
  void* dv;
  int B, H, Tq, Tk;
  long long dksb, dkst, dksh, dvsb, dvst, dvsh;
  float scale;
  int q_offset, kv_offset, causal, window;
};

// Shared-memory layout (byte offsets from a 1024-byte boundary).
template <int D>
struct Layout {
  static constexpr int kBoxes = D / 64;
  static constexpr int kKVBytes = BN * D * 2;  // K or V of the block
  static constexpr int kTileBytes = BQ * D * 2;  // one Q or dO tile
  static constexpr int kBoxBytes = BQ * 128;     // one box of such a tile
  static constexpr int kK = 0;
  static constexpr int kV = kKVBytes;
  static constexpr int kQ = 2 * kKVBytes;
  static constexpr int kDO = kQ + kStages * kTileBytes;
  static constexpr int kLse = kDO + kStages * kTileBytes;  // float [S][BQ]
  static constexpr int kDelta = kLse + kStages * BQ * 4;   // float [S][BQ]
  static constexpr int kBar = kDelta + kStages * BQ * 4;
  static constexpr int kBytes = kBar + 128 + 1024;  // + alignment slack
  static_assert(kBytes <= 232448, "more shared memory than a block has");
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_sm90(const __grid_constant__ Params p) {
  using L = Layout<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  auto* kv_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full = kv_full + 1;      // [kStages]
  uint64_t* empty = full + kStages;  // [kStages]
  auto* lse_s = reinterpret_cast<float*>(smem + L::kLse);
  auto* delta_s = reinterpret_cast<float*>(smem + L::kDelta);

  // Causal: the first key blocks are seen by the most queries and start
  // first.
  const int k0 = blockIdx.x * BN;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  const int k_lo = p.kv_offset + k0;
  const int k_hi = p.kv_offset + min(k0 + BN, p.Tk) - 1;
  const int num_q = (p.Tq + BQ - 1) / BQ;
  // The query tiles that see this key block form one range.
  int qt_lo = num_q, qt_hi = 0;
  for (int qt = 0; qt < num_q; ++qt) {
    if (tile_visible(p, p.q_offset + qt * BQ,
                     p.q_offset + min(qt * BQ + BQ, p.Tq) - 1, k_lo, k_hi)) {
      qt_lo = min(qt_lo, qt);
      qt_hi = qt + 1;
    }
  }
  const int n_tiles = max(qt_hi - qt_lo, 0);

  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);  // the producer warp's lanes
      mbar_init(&empty[s], kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // Producer warpgroup: its first warp's lane 0 issues the copies, every
    // lane of that warp stages lse and delta.
    reg_dealloc<kProducerRegs>();
    if (warp != kConsumerWarps) return;
    if (lane == 0) {
      mbar_expect_tx(kv_full, 2 * L::kKVBytes);
      for (int c = 0; c < L::kBoxes; ++c) {
        tma_load_4d(smem + L::kK + c * BN * 128, &p.tk, kv_full, c * 64, k0,
                    h, b);
        tma_load_4d(smem + L::kV + c * BN * 128, &p.tv, kv_full, c * 64, k0,
                    h, b);
      }
    }
    const long long row_base = (static_cast<long long>(b) * p.H + h) * p.Tq;
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);  // first round passes
      const int q0 = (qt_lo + i) * BQ;
      // rows past Tq: lse = delta = 0 (their columns are masked)
      for (int r = lane; r < BQ; r += 32) {
        const bool in = q0 + r < p.Tq;
        lse_s[s * BQ + r] = in ? p.lse[row_base + q0 + r] * kLog2e : 0.f;
        delta_s[s * BQ + r] = in ? p.delta[row_base + q0 + r] : 0.f;
      }
      if (lane == 0) {
        mbar_expect_tx(&full[s], 2 * L::kTileBytes);
        for (int c = 0; c < L::kBoxes; ++c) {
          tma_load_4d(smem + L::kQ + s * L::kTileBytes + c * BQ * 128, &p.tq,
                      &full[s], c * 64, q0, h, b);
          tma_load_4d(smem + L::kDO + s * L::kTileBytes + c * BQ * 128,
                      &p.tdo, &full[s], c * 64, q0, h, b);
        }
      } else {
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns keys k0 + 64 wg .. + 63.
  reg_alloc<kConsumerRegs>();
  const int wg = warp >> 2, wl = warp & 3;
  const int g = lane >> 2, tg = lane & 3;
  const int kr0 = k0 + wg * 64 + wl * 16 + g, kr1 = kr0 + 8;
  const int kp0 = p.kv_offset + kr0, kp1 = p.kv_offset + kr1;
  const float scale2 = p.scale * kLog2e;

  float dk[D / 2], dv[D / 2];  // 64 keys x D per warpgroup
#pragma unroll
  for (int j = 0; j < D / 2; ++j) dk[j] = dv[j] = 0.f;

  const unsigned char* ks = smem + L::kK + wg * 64 * 128;
  const unsigned char* vs = smem + L::kV + wg * 64 * 128;
  mbar_wait(kv_full, 0);

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages, phase = (i / kStages) & 1;
    const int q0 = (qt_lo + i) * BQ;
    const unsigned char* qs = smem + L::kQ + s * L::kTileBytes;
    const unsigned char* dos = smem + L::kDO + s * L::kTileBytes;
    const float* ls = lse_s + s * BQ;
    const float* dl = delta_s + s * BQ;
    const int q_lo = p.q_offset + q0;
    const int q_hi = p.q_offset + min(q0 + BQ, p.Tq) - 1;
    const bool masked = q0 + BQ > p.Tq || k0 + BN > p.Tk ||
                        !tile_full(p, q_lo, q_hi, k_lo, k_hi);

    // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries; the first step
    // writes them without reading them.
    float st[32], dp[32];
    mbar_wait(&full[s], phase);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int kv_off = (kk / 4) * BN * 128 + (kk % 4) * 32;
      const int q_off = (kk / 4) * L::kBoxBytes + (kk % 4) * 32;
      const uint64_t k_desc = sw128_desc(ks + kv_off, 16, 1024);
      const uint64_t q_desc = sw128_desc(qs + q_off, 16, 1024);
      const uint64_t v_desc = sw128_desc(vs + kv_off, 16, 1024);
      const uint64_t do_desc = sw128_desc(dos + q_off, 16, 1024);
      if (kk == 0) {
        wgmma_ss_n64_first(st, k_desc, q_desc);
        wgmma_ss_n64_first(dp, v_desc, do_desc);
      } else {
        wgmma_ss_n64(st, k_desc, q_desc);
        wgmma_ss_n64(dp, v_desc, do_desc);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(st);
    fence_acc(dp);

    // P^T = exp2(S^T scale2 - lse2), dS^T = P^T o (dP^T - delta); the
    // query is the column.
#pragma unroll
    for (int nt = 0; nt < BQ / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = nt * 8 + tg * 2 + (e & 1);
        float x = fmaf(st[nt * 4 + e], scale2, -ls[qc]);
        if (masked && !(q0 + qc < p.Tq && (e < 2 ? kr0 : kr1) < p.Tk &&
                        visible(p, p.q_offset + q0 + qc, e < 2 ? kp0 : kp1)))
          x = -INFINITY;
        const float pe = ex2(x);
        st[nt * 4 + e] = pe;
        dp[nt * 4 + e] = pe * (dp[nt * 4 + e] - dl[qc]);
      }
    }
    // P^T and dS^T as bf16 register A operands, one per 16 queries.
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pa[kk][r] = pack_f32(st[8 * kk + 2 * r], st[8 * kk + 2 * r + 1]);
        da[kk][r] = pack_f32(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
      }
    }

    // dV += P^T dO and dK += dS^T Q: query rows are the reduction (16
    // queries = 2048 bytes a step). They are waited for at once: a wgmma
    // left in flight across the next tile's products makes ptxas
    // serialize every wgmma of the kernel.
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      wgmma_rs_mn<D>(dv, pa[kk], dos + kk * 2048, L::kBoxBytes);
      wgmma_rs_mn<D>(dk, da[kk], qs + kk * 2048, L::kBoxBytes);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(dk);
    fence_acc(dv);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with stage s
  }

  auto* dkp = static_cast<__nv_bfloat16*>(p.dk) + b * p.dksb + h * p.dksh;
  auto* dvp = static_cast<__nv_bfloat16*>(p.dv) + b * p.dvsb + h * p.dvsh;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + tg * 2;
    if (kr0 < p.Tk) {
      *reinterpret_cast<__nv_bfloat162*>(dkp + kr0 * p.dkst + col) =
          __floats2bfloat162_rn(dk[dt * 4 + 0] * p.scale,
                                dk[dt * 4 + 1] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(dvp + kr0 * p.dvst + col) =
          __floats2bfloat162_rn(dv[dt * 4 + 0], dv[dt * 4 + 1]);
    }
    if (kr1 < p.Tk) {
      *reinterpret_cast<__nv_bfloat162*>(dkp + kr1 * p.dkst + col) =
          __floats2bfloat162_rn(dk[dt * 4 + 2] * p.scale,
                                dk[dt * 4 + 3] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(dvp + kr1 * p.dvst + col) =
          __floats2bfloat162_rn(dv[dt * 4 + 2], dv[dt * 4 + 3]);
    }
  }
}

template <int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int smem = Layout<D>::kBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_sm90<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Tk + BN - 1) / BN, p.H, p.B);
  flash_bwd_dkv_sm90<D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// The arguments of kgt_flash_bwd_dkv_mma (flash_bwd.cu); dtype must be 0
// (bf16) and D 64 or 128. ``in_strides`` holds the B, T and H strides
// (elements) of q, k, v and dO; the tensor maps need 16-byte aligned bases
// and strides that are multiples of 8 elements. lse and delta are
// [B, H, Tq] float32, contiguous. Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for arguments it does not take.
extern "C" int kgt_flash_bwd_dkv_sm90(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int dtype, int B,
    int H, int Tq, int Tk, int D, const long long* in_strides,
    long long dksb, long long dkst, long long dksh, long long dvsb,
    long long dvst, long long dvsh, float scale, int q_offset, int kv_offset,
    int causal, int window, void* stream) {
  if (dtype != 0 || (D != 64 && D != 128) || B < 1 || H < 1 || Tq < 1 ||
      Tk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long* st = in_strides;
  Params p{};
  if (!make_map(&p.tq, q, B, Tq, H, D, st[0], st[1], st[2], BQ) ||
      !make_map(&p.tk, k, B, Tk, H, D, st[3], st[4], st[5], BN) ||
      !make_map(&p.tv, v, B, Tk, H, D, st[6], st[7], st[8], BN) ||
      !make_map(&p.tdo, dout, B, Tq, H, D, st[9], st[10], st[11], BQ))
    return static_cast<int>(cudaErrorInvalidValue);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dk = dk;
  p.dv = dv;
  p.B = B;
  p.H = H;
  p.Tq = Tq;
  p.Tk = Tk;
  p.dksb = dksb;
  p.dkst = dkst;
  p.dksh = dksh;
  p.dvsb = dvsb;
  p.dvst = dvst;
  p.dvsh = dvsh;
  p.scale = scale;
  p.q_offset = q_offset;
  p.kv_offset = kv_offset;
  p.causal = causal;
  p.window = window;
  auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(D == 64 ? launch<64>(p, s) : launch<128>(p, s));
}
