// Flash attention forward (K1) for Hopper (sm_90a), bf16 at head_dim 64
// and 128, plain C interface for ctypes: the main path's instance.
//
// Replaces kubegpu_tpu/workload/kernels/flash.py::_fwd_kernel with the
// conventions of flash_fwd.cu (whose mma.sync kernels stay for head_dim 32
// and float32, and as the previous design for comparison): [B, T, H, D]
// read through its strides, masking at global positions q_offset + i and
// kv_offset + j (causal, window, non-causal), masked scores -inf so a row
// that sees no key gives O = 0 and lse <= -1e20, any Tq, Tk >= 1, P cast
// to bf16 before P V, float32 accumulation, lse [B, H, Tq] float32.
//
// What bounds it on an H100 SXM: at the training shape (B=4, T=2048,
// H=18, D=128, causal) 4 D FLOP per visible pair = 77.3 GFLOP, 0.078 ms
// at 989 TFLOP/s, against 151.6 MB, 0.045 ms at 3.35 TB/s: operations. At
// the serving shape (B=4, T=1024, H=16) 17.2 GFLOP (0.017 ms) against 67.4
// MB (0.020 ms): close to both. The mma.sync design (flash_fwd.cu) reached
// about 134 TFLOP/s; its limits were the instruction (mma.sync cannot
// reach Hopper's tensor-core rate), every thread both copying and
// computing behind a __syncthreads() per tile, and 64 query rows per K/V
// tile.
//
// The design here:
// - One block per (b, h, 128-row query tile): two consumer warpgroups of
//   64 rows each and a producer warpgroup, of which one thread works. The
//   query tiles that see the most keys start first.
// - That thread loads Q once and K, V tiles of 128 keys into a ring of
//   two stages (at D = 128: 32 KB Q + 2 x 64 KB) with TMA, 128-byte
//   swizzled; K and V of a stage have their own "full" mbarriers, so
//   S = Q K^T starts before V has landed, and the consumers free a stage
//   on an "empty" mbarrier. TMA zero-fills rows past Tq or Tk.
// - S = Q K^T is one wgmma m64n128k16 per 16 columns of D, both operands
//   read from shared memory; the online softmax (log2 units, the mask only
//   on tiles it cuts) runs on the accumulators, whose per-thread layout is
//   mma.sync's, so the row max and sum take the same 4-lane shuffles.
// - P is packed to bf16 in registers and is the register A operand of
//   O += P V (wgmma m64nDk16, V MN-major from shared memory). Each K/V tile
//   feeds 128 query rows.
// - setmaxnreg: 384 threads launch at 168 registers, which cannot hold a
//   consumer's 64 O and 64 S accumulators beside P; the producer
//   warpgroup drops to 40 and the consumers rise to 232. No spills.
// Still to do (ROADMAP): the ping-pong of the two warpgroups (one's
// softmax under the other's products) and the overlap of the softmax with
// the next tile's Q K^T inside a warpgroup.

#include "flash_sm90.cuh"

namespace {

using namespace kgt;

constexpr int BM = 128;  // query rows per block
constexpr int BN = 128;  // keys per tile
// K/V stages: three fit at D = 128 (224 KB) but measured no faster than
// two (tools/ablate_flash_sm90.py), so two.
constexpr int kStages = 2;
constexpr int kConsumerWarps = 8;  // two warpgroups
constexpr int kThreads = 32 * kConsumerWarps + 128;  // + the producer's
// Registers a thread after setmaxnreg: 384 threads launch at 168 each; the
// producer warpgroup drops to 40 and the consumers rise to 232.
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

struct Params {
  CUtensorMap tq, tk, tv;  // 4-D maps over (D, T, H, B)
  void* o;
  float* lse;
  int B, H, Tq, Tk;
  long long osb, ost, osh;
  float scale;
  int q_offset, kv_offset, causal, window;
};

// Shared-memory layout (byte offsets from a 1024-byte boundary).
template <int D>
struct Layout {
  static constexpr int kBoxes = D / 64;
  static constexpr int kQBytes = BM * D * 2;
  static constexpr int kTileBytes = BN * D * 2;  // one K or V tile
  static constexpr int kBoxBytes = BN * 128;     // one box of a K or V tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBar = kV + kStages * kTileBytes;
  static constexpr int kBytes = kBar + 256 + 1024;  // + alignment slack
  static_assert(kBytes <= 232448, "more shared memory than a block has");
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_sm90(const __grid_constant__ Params p) {
  using L = Layout<D>;
  constexpr int S = kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  auto* q_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* k_full = q_full + 1;  // [S]
  uint64_t* v_full = k_full + S;  // [S]
  uint64_t* empty = v_full + S;   // [S]

  // Causal: the last query tiles see the most keys, so they start first.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

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
  const int n_tiles = max(kt_hi - kt_lo, 0);

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // Producer warpgroup: one thread issues every copy.
    reg_dealloc<kProducerRegs>();
    if (warp != kConsumerWarps || lane != 0) return;
    mbar_expect_tx(q_full, L::kQBytes);
    for (int c = 0; c < L::kBoxes; ++c)
      tma_load_4d(smem + L::kQ + c * BM * 128, &p.tq, q_full, c * 64, q0, h,
                  b);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % S;
      mbar_wait(&empty[s], ((i / S) & 1) ^ 1);  // the first round passes
      const int k0 = (kt_lo + i) * BN;
      mbar_expect_tx(&k_full[s], L::kTileBytes);
      for (int c = 0; c < L::kBoxes; ++c)
        tma_load_4d(smem + L::kK + s * L::kTileBytes + c * L::kBoxBytes,
                    &p.tk, &k_full[s], c * 64, k0, h, b);
      mbar_expect_tx(&v_full[s], L::kTileBytes);
      for (int c = 0; c < L::kBoxes; ++c)
        tma_load_4d(smem + L::kV + s * L::kTileBytes + c * L::kBoxBytes,
                    &p.tv, &v_full[s], c * 64, k0, h, b);
    }
    return;
  }

  // Consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63.
  reg_alloc<kConsumerRegs>();
  const int wg = warp >> 2, wl = warp & 3;
  const int g = lane >> 2, tg = lane & 3;
  const int r0 = q0 + wg * 64 + wl * 16 + g, r1 = r0 + 8;
  const int qp0 = p.q_offset + r0, qp1 = p.q_offset + r1;
  // Scores in log2 units: exp2(s' - m') = exp(s * scale - m).
  const float scale2 = p.scale * kLog2e;

  float acc[D / 2];  // O: 64 rows x D per warpgroup
#pragma unroll
  for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;  // running row max (log2 units)
  float l0 = 0.f, l1 = 0.f;          // this thread's share of the row sum

  const unsigned char* qs = smem + L::kQ + wg * 64 * 128;
  mbar_wait(q_full, 0);

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % S, phase = (i / S) & 1;
    const int k0 = (kt_lo + i) * BN;
    const unsigned char* ks = smem + L::kK + s * L::kTileBytes;
    const unsigned char* vs = smem + L::kV + s * L::kTileBytes;
    const int k_lo = p.kv_offset + k0;
    const int k_hi = p.kv_offset + min(k0 + BN, p.Tk) - 1;
    const bool masked = k0 + BN > p.Tk || !tile_full(p, q_lo, q_hi, k_lo, k_hi);

    // S = Q K^T: 64 rows x 128 keys, 16 columns of D a step; the first
    // step writes S without reading it.
    float sc[64];
    mbar_wait(&k_full[s], phase);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk / 4, off = (kk % 4) * 32;
      const uint64_t da = sw128_desc(qs + c * BM * 128 + off, 16, 1024);
      const uint64_t db = sw128_desc(ks + c * L::kBoxBytes + off, 16, 1024);
      if (kk == 0) wgmma_ss_n128_first(sc, da, db);
      else wgmma_ss_n128(sc, da, db);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(sc);

    // Row max of the raw scores, masked ones -inf (at global positions,
    // only where the tile needs it), in four independent chains a row.
    float r0m[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
    float r1m[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[nt * 4 + e];
        if (masked) {
          const int col = k0 + nt * 8 + tg * 2 + (e & 1);
          if (!(col < p.Tk &&
                visible(p, e < 2 ? qp0 : qp1, p.kv_offset + col)))
            x = -INFINITY;
          sc[nt * 4 + e] = x;
        }
        if (e < 2) r0m[nt & 3] = fmaxf(r0m[nt & 3], x);
        else r1m[nt & 3] = fmaxf(r1m[nt & 3], x);
      }
    }
    // in log2 units (scale2 > 0 keeps the order); the four threads of a
    // row hold its 128 columns between them
    float mx0 = fmaxf(m0, fmaxf(fmaxf(r0m[0], r0m[1]),
                                fmaxf(r0m[2], r0m[3])) * scale2);
    float mx1 = fmaxf(m1, fmaxf(fmaxf(r1m[0], r1m[1]),
                                fmaxf(r1m[2], r1m[3])) * scale2);
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float a0 = ex2(m0 - mx0), a1 = ex2(m1 - mx1);
    m0 = mx0;
    m1 = mx1;

    // P = 2^(s scale2 - m), one FMA and one ex2 an element (masked:
    // ex2(-inf) = 0); the row sums in two chains a row.
    float ls0[2] = {0.f, 0.f}, ls1[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      sc[nt * 4 + 0] = ex2(fmaf(sc[nt * 4 + 0], scale2, -m0));
      sc[nt * 4 + 1] = ex2(fmaf(sc[nt * 4 + 1], scale2, -m0));
      sc[nt * 4 + 2] = ex2(fmaf(sc[nt * 4 + 2], scale2, -m1));
      sc[nt * 4 + 3] = ex2(fmaf(sc[nt * 4 + 3], scale2, -m1));
      ls0[nt & 1] += sc[nt * 4 + 0] + sc[nt * 4 + 1];
      ls1[nt & 1] += sc[nt * 4 + 2] + sc[nt * 4 + 3];
    }
    l0 = l0 * a0 + (ls0[0] + ls0[1]);
    l1 = l1 * a1 + (ls1[0] + ls1[1]);
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      acc[dt * 4 + 0] *= a0;
      acc[dt * 4 + 1] *= a0;
      acc[dt * 4 + 2] *= a1;
      acc[dt * 4 + 3] *= a1;
    }

    // P to bf16 (flash.py casts p to v's type): the accumulators of key
    // columns 16kk..16kk+15 are the A operand of that 16-key step.
    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      pa[kk][0] = pack_f32(sc[8 * kk + 0], sc[8 * kk + 1]);
      pa[kk][1] = pack_f32(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_f32(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_f32(sc[8 * kk + 6], sc[8 * kk + 7]);
    }

    // O += P V: V rows are the reduction (16 keys = 2048 bytes a step).
    // It is waited for at once: a wgmma left in flight across the next
    // tile's S = Q K^T makes ptxas serialize every wgmma of the kernel.
    mbar_wait(&v_full[s], phase);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_rs_mn<D>(acc, pa[kk], vs + kk * 2048, L::kBoxBytes);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with stage s
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  const float inv0 = 1.f / d0, inv1 = 1.f / d1;
  auto* o = static_cast<__nv_bfloat16*>(p.o) + b * p.osb + h * p.osh;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + tg * 2;
    if (r0 < p.Tq)
      *reinterpret_cast<__nv_bfloat162*>(o + r0 * p.ost + col) =
          __floats2bfloat162_rn(acc[dt * 4 + 0] * inv0,
                                acc[dt * 4 + 1] * inv0);
    if (r1 < p.Tq)
      *reinterpret_cast<__nv_bfloat162*>(o + r1 * p.ost + col) =
          __floats2bfloat162_rn(acc[dt * 4 + 2] * inv1,
                                acc[dt * 4 + 3] * inv1);
  }
  if (tg == 0) {
    // back from log2 units: lse = m' ln 2 + log(l)
    float* lse = p.lse + (static_cast<long long>(b) * p.H + h) * p.Tq;
    if (r0 < p.Tq) lse[r0] = m0 * kLn2 + logf(d0);
    if (r1 < p.Tq) lse[r1] = m1 * kLn2 + logf(d1);
  }
}

template <int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int smem = Layout<D>::kBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_sm90<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Tq + BM - 1) / BM, p.H, p.B);
  flash_fwd_sm90<D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// The arguments of kgt_flash_fwd_mma (flash_fwd.cu); dtype must be 0 (bf16)
// and D 64 or 128. The tensor maps need 16-byte aligned bases and strides
// that are multiples of 8 elements. Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for arguments it does not take.
extern "C" int kgt_flash_fwd_sm90(const void* q, const void* k, const void* v,
                                  void* o, void* lse, int dtype, int B, int H,
                                  int Tq, int Tk, int D, long long qsb,
                                  long long qst, long long qsh, long long ksb,
                                  long long kst, long long ksh, long long vsb,
                                  long long vst, long long vsh, long long osb,
                                  long long ost, long long osh, float scale,
                                  int q_offset, int kv_offset, int causal,
                                  int window, void* stream) {
  if (dtype != 0 || (D != 64 && D != 128) || B < 1 || H < 1 || Tq < 1 ||
      Tk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  if (!make_map(&p.tq, q, B, Tq, H, D, qsb, qst, qsh, BM) ||
      !make_map(&p.tk, k, B, Tk, H, D, ksb, kst, ksh, BN) ||
      !make_map(&p.tv, v, B, Tk, H, D, vsb, vst, vsh, BN))
    return static_cast<int>(cudaErrorInvalidValue);
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.B = B;
  p.H = H;
  p.Tq = Tq;
  p.Tk = Tk;
  p.osb = osb;
  p.ost = ost;
  p.osh = osh;
  p.scale = scale;
  p.q_offset = q_offset;
  p.kv_offset = kv_offset;
  p.causal = causal;
  p.window = window;
  auto st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(D == 64 ? launch<64>(p, st) : launch<128>(p, st));
}
