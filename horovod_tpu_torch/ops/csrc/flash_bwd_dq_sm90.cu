// Flash-attention dQ on Hopper's tensor cores (sm_90a), CUDA C++ with a
// plain C entry: the tensor-core route of B2 (bf16, D a multiple of 8 up to
// 128). flash_bwd.cu's `hvt_flash_bwd_dq` stays the CUDA-core route (f32,
// D > 128).
//
// Replaces the TPU kernel `horovod_tpu/ops/flash_attention.py:
// _bwd_dq_kernel` (launched by `_flash_bwd_core`). With S = Q K^T * scale
// under the forward's masks (flash_fwd_sm90.cu), lse from the forward and
// delta = rowsum(dO * O) - dlse from the caller:
//
//   P  = exp(S - lse) on kept (row, col) pairs, 0 elsewhere
//   dS = P * (dO V^T - delta)
//   dQ = dS K * scale,
//
// accumulated in f32 registers and rounded to bf16 once.
//
// Precision: S and dO V^T are exact products of the bf16 inputs summed in
// f32. dS, the A operand of dS K, is f32 in the TPU kernel; wgmma takes
// bf16. One bf16 rounding of dS moves dQ past the bf16 tolerance held
// against the plain version (dS carries both signs, so the sum over keys
// cancels; tests/test_torch_flash_sm90.py rehearses it), so dS is fed as a
// bf16 hi + lo pair, two products against the same K: four products a
// tile instead of three.
//
// What bounds it: at the training shape (B8 H8 T1024 D64 causal) the three
// products over the kept pairs are ~12.9 GFLOP, 13.0 us at 989 TFLOP/s,
// against ~42 MB moved, 12.7 us: operations, barely. So every product runs
// on the tensor cores, with the 64 q rows of the CTA as the wgmma M
// dimension throughout:
//
//   S   = Q K^T      A = Q (shared, K-major)     B = K (shared, K-major)
//   dP  = dO V^T     A = dO                      B = V
//   P, dS on the accumulators (lse and delta per row, in registers)
//   dQ += dS K       A = dS (bf16 hi, lo)        B = K (shared, MN-major)
//
// The S accumulator's rows are dQ's rows and its columns the keys, so dS
// becomes the A operand of the dQ product in registers: no transpose, no
// trip through shared memory.
//
// * one CTA per (64 q rows, q head, batch), the heaviest causal q tiles
//   first (flash_fwd_sm90.cu's order); 128 threads, one warpgroup, whose
//   thread 0 also issues the TMA loads (no producer warp, as B1 and B3):
//   at D <= 64 four CTAs fit an SM (124 registers a thread, ~50 KB of
//   shared memory), two at D 128 (158 registers);
// * Q and dO are resident in shared memory (bf16, 128-byte swizzle, loaded
//   once by TMA); K and V tiles of the q head's kv head (GQA) stream
//   through a 2-stage TMA ring over the k tiles the forward visits (up to
//   the diagonal, the band, the sink tiles), a stage refilled as soon as
//   the warpgroup is done with it;
// * each thread reads the lse and delta of its two rows once, from the
//   caller's [B, Tq, H] f32 arrays;
// * only tiles on the diagonal, the band edge, a ragged end or segmented
//   calls evaluate the per-element predicate. P is zeroed by a select,
//   never a multiply: a masked score (or a fully masked row's lse of
//   -1e30) can overflow exp to inf, and inf * 0 is NaN.
//
// Left on the table: one warpgroup per CTA; a tile's products and its
// arithmetic run in turn (no overlap of the next tile's S/dP with this
// tile's dQ products); no persistent scheduler; dQ stored from registers
// rather than through shared memory and TMA.
//
// Layout: q/dO [B,Tq,H,D] and k/v [B,Tk,Hkv,D] bf16 read in place through
// tensor maps (dims D, H, T, B); lse/delta f32 [B,Tq,H] contiguous; dQ
// written contiguous [B,Tq,H,D] bf16, rows past Tq not written.

#include "sm90.cuh"

namespace {

constexpr int BM = 64;   // q rows a CTA (one warpgroup)
constexpr int BN = 64;   // keys a tile
constexpr int ST = 2;    // K/V ring stages
constexpr int NT = 128;  // one warpgroup
constexpr int TILE_BYTES = BM * sm90::ROW_BYTES;  // one 64-column chunk

struct alignas(64) Params {
  CUtensorMap q_map, k_map, v_map, o_map;  // o_map: dO
  const float* lse;    // [B, Tq, H]
  const float* delta;  // [B, Tq, H]
  const int* qseg;     // [B, Tq] or null
  const int* kseg;     // [B, Tk] or null
  __nv_bfloat16* dq;
  int B, Tq, Tk, H, Hkv, D, nq;
  int causal, window, sinks, offset;  // window 0 = no band
  float scale;
};

// The k tiles q tile q0 visits: kt in [0, hi], skipping [n_sink, lo)
// (flash_fwd_sm90.cu's rule).
__device__ __forceinline__ void k_tiles(const Params& p, int q0, int& hi,
                                        int& lo, int& n_sink) {
  const int nk = (p.Tk + BN - 1) / BN;
  hi = nk - 1;
  lo = 0;
  n_sink = 0;
  if (p.causal) {
    const long long max_col = (long long)min(q0 + BM, p.Tq) - 1 + p.offset;
    if (max_col < 0)
      hi = -1;
    else if (max_col / BN < nk - 1)
      hi = (int)(max_col / BN);
    if (p.window > 0) {
      const long long min_col = (long long)q0 + p.offset - p.window + 1;
      lo = min_col <= 0 ? 0 : (int)min(min_col / BN, (long long)nk);
      n_sink = (p.sinks + BN - 1) / BN;
    }
  }
}

template <int NC>
__global__ void __launch_bounds__(NT, NC == 1 ? 4 : 2)
    flash_bwd_dq_sm90_kernel(__grid_constant__ const Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* q_s = base;
  uint8_t* o_s = q_s + NC * TILE_BYTES;       // dO
  uint8_t* k_s = o_s + NC * TILE_BYTES;       // [ST][NC] chunks
  uint8_t* v_s = k_s + ST * NC * TILE_BYTES;  // [ST][NC] chunks
  uint64_t* qo_bar = reinterpret_cast<uint64_t*>(v_s + ST * NC * TILE_BYTES);
  uint64_t* full = qo_bar + 1;

  const int tid = threadIdx.x;
  const int hb = p.H * p.B;
  const int qt = p.nq - 1 - (int)(blockIdx.x / hb);  // heaviest first
  const int h = (int)(blockIdx.x % p.H);
  const int b = (int)((blockIdx.x / p.H) % p.B);
  const int hk = h / (p.H / p.Hkv);
  const int q0 = qt * BM;
  int kt_hi, kt_lo, n_sink;
  k_tiles(p, q0, kt_hi, kt_lo, n_sink);

  // Tile i of the sweep: the i-th k tile of [0, kt_hi] outside
  // [n_sink, kt_lo), in stage i % ST.
  const int skip = max(0, kt_lo - n_sink);
  const int n = max(0, kt_hi + 1 - max(0, min(kt_lo, kt_hi + 1) - n_sink));
  auto tile = [&](int i) { return i < n_sink ? i : i + skip; };
  // Thread 0: tile i's K and V into its stage.
  auto issue = [&](int i) {
    const int s = i % ST, kt = tile(i);
    sm90::mbar_expect_tx(&full[s], 2 * NC * TILE_BYTES);
    for (int c = 0; c < NC; ++c) {
      sm90::tma_load_4d(k_s + (s * NC + c) * TILE_BYTES, &p.k_map, &full[s],
                        c * 64, hk, kt * BN, b);
      sm90::tma_load_4d(v_s + (s * NC + c) * TILE_BYTES, &p.v_map, &full[s],
                        c * 64, hk, kt * BN, b);
    }
  };

  if (tid == 0) {
    sm90::mbar_init(qo_bar, 1);
    for (int s = 0; s < ST; ++s) sm90::mbar_init(&full[s], 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0 && n > 0) {
    sm90::mbar_expect_tx(qo_bar, 2 * NC * TILE_BYTES);
    for (int c = 0; c < NC; ++c) {
      sm90::tma_load_4d(q_s + c * TILE_BYTES, &p.q_map, qo_bar, c * 64, h, q0,
                        b);
      sm90::tma_load_4d(o_s + c * TILE_BYTES, &p.o_map, qo_bar, c * 64, h, q0,
                        b);
    }
    for (int i = 0; i < min(ST, n); ++i) issue(i);
  }

  // Thread owns tile rows r0 and r0 + 8, and in each 8-column group of S
  // the key columns cq, cq + 1.
  const int warp = tid >> 5, lane = tid & 31;
  const int r0 = warp * 16 + (lane >> 2);
  const int cq = 2 * (lane & 3);
  const float sl2 = p.scale * sm90::LOG2E;
  const bool seg = p.qseg != nullptr;
  // Per row: lse * log2 e and delta (rows past Tq read nothing; the mask
  // zeroes their P).
  float lse2[2] = {0.f, 0.f}, del[2] = {0.f, 0.f};
  int qid[2] = {0, 0};
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int gr = q0 + r0 + 8 * hh;
    if (gr < p.Tq) {
      const long long row = ((long long)b * p.Tq + gr) * p.H + h;
      lse2[hh] = p.lse[row] * sm90::LOG2E;
      del[hh] = p.delta[row];
      if (seg) qid[hh] = p.qseg[(long long)b * p.Tq + gr];
    }
  }

  float dq[NC][32];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) dq[c][e] = 0.f;
  const uint32_t q_addr = sm90::smem_u32(q_s);
  const uint32_t o_addr = sm90::smem_u32(o_s);
  if (n > 0) sm90::mbar_wait(qo_bar, 0);

  for (int i = 0; i < n; ++i) {
    const int kt = tile(i), s = i % ST;
    sm90::mbar_wait(&full[s], (i / ST) & 1);
    const uint32_t k_addr = sm90::smem_u32(k_s + s * NC * TILE_BYTES);
    const uint32_t v_addr = sm90::smem_u32(v_s + s * NC * TILE_BYTES);

    float sc[32], dp[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) sc[e] = dp[e] = 0.f;
    sm90::fence_regs(sc);
    sm90::fence_regs(dp);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NC; ++kk) {
      const uint32_t off = (kk >> 2) * TILE_BYTES + (kk & 3) * 32;
      sm90::wgmma_ss(sc, sm90::desc_sw128(q_addr + off),
                     sm90::desc_sw128(k_addr + off), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < 4 * NC; ++kk) {
      const uint32_t off = (kk >> 2) * TILE_BYTES + (kk & 3) * 32;
      sm90::wgmma_ss(dp, sm90::desc_sw128(o_addr + off),
                     sm90::desc_sw128(v_addr + off), kk > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sc);
    sm90::fence_regs(dp);

    const int k0 = kt * BN;
    const bool interior =
        !seg && q0 + BM <= p.Tq && k0 + BN <= p.Tk &&
        (!p.causal ||
         (k0 + BN - 1 <= q0 + p.offset &&
          (p.window == 0 || k0 > q0 + BM - 1 + p.offset - p.window)));
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int hh = (e >> 1) & 1;
      float pv = exp2f(fmaf(sc[e], sl2, -lse2[hh]));
      if (!interior) {
        const int gr = q0 + r0 + 8 * hh;
        const int gc = k0 + 8 * (e >> 2) + cq + (e & 1);
        bool keep = gr < p.Tq && gc < p.Tk;
        if (p.causal) {
          const int pos = gr + p.offset;
          keep = keep && gc <= pos;
          if (p.window > 0)
            keep = keep && (gc > pos - p.window || gc < p.sinks);
        }
        if (seg && keep) keep = p.kseg[(long long)b * p.Tk + gc] == qid[hh];
        if (!keep) pv = 0.f;
      }
      dp[e] = pv * (dp[e] - del[hh]);
    }
    uint32_t da[16], da_lo[16];
    sm90::acc_to_a_split(dp, da, da_lo);

#pragma unroll
    for (int c = 0; c < NC; ++c) sm90::fence_regs(dq[c]);
    sm90::wgmma_fence();
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t k_desc = sm90::desc_sw128(k_addr + c * TILE_BYTES +
                                                 kk * 16 * sm90::ROW_BYTES);
        sm90::wgmma_rs(dq[c], &da[4 * kk], k_desc);
        sm90::wgmma_rs(dq[c], &da_lo[4 * kk], k_desc);
      }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < NC; ++c) sm90::fence_regs(dq[c]);
    // Stage s is free once every warp is past its products: refill it.
    __syncthreads();
    if (tid == 0 && i + ST < n) issue(i + ST);
  }

  // Epilogue: dQ * scale for the thread's two rows, bf16.
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int gr = q0 + r0 + 8 * hh;
    if (gr >= p.Tq) continue;
    __nv_bfloat16* row = p.dq + (((long long)b * p.Tq + gr) * p.H + h) * p.D;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = c * 64 + 8 * j;
        if (col >= p.D) continue;
        const int e = 4 * j + 2 * hh;
        *reinterpret_cast<uint32_t*>(row + col + cq) = sm90::pack_bf16(
            dq[c][e] * p.scale, dq[c][e + 1] * p.scale);
      }
  }
}

template <int NC>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem =
      (size_t)(2 + 2 * ST) * NC * TILE_BYTES + (1 + ST) * 8 + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_sm90_kernel<NC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)p.nq * p.H * p.B;
  flash_bwd_dq_sm90_kernel<NC><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// q/k/v/dout: int64 tensor descriptions (sm90::TENSOR_DESC_LEN each, as
// hvt_flash_fwd_sm90). lse/delta: f32 [B, Tq, H] contiguous. Returns a CUDA
// error code (0 = launched). The caller validates shapes and allocates dq
// contiguous.
extern "C" int hvt_flash_bwd_dq_sm90(
    const long long* qd, const long long* kd, const long long* vd,
    const long long* od, const void* lse, const void* delta,
    const void* qseg, const void* kseg, void* dq, int B, int Tq, int Tk,
    int H, int Hkv, int D, int causal, int window, int sinks, int offset,
    float scale, void* stream) {
  if (D < 8 || D > 128 || D % 8 != 0 || Hkv < 1 || H % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  cudaError_t err;
  if ((err = sm90::make_map(&p.q_map, qd)) != cudaSuccess ||
      (err = sm90::make_map(&p.k_map, kd)) != cudaSuccess ||
      (err = sm90::make_map(&p.v_map, vd)) != cudaSuccess ||
      (err = sm90::make_map(&p.o_map, od)) != cudaSuccess)
    return (int)err;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.qseg = static_cast<const int*>(qseg);
  p.kseg = static_cast<const int*>(kseg);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.B = B;
  p.Tq = Tq;
  p.Tk = Tk;
  p.H = H;
  p.Hkv = Hkv;
  p.D = D;
  p.nq = (Tq + BM - 1) / BM;
  p.causal = causal;
  p.window = window;
  p.sinks = sinks;
  p.offset = offset;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(D <= 64 ? launch<1>(p, st) : launch<2>(p, st));
}
