// Flash-attention dK/dV on Hopper's tensor cores (sm_90a), CUDA C++ with a
// plain C entry: the tensor-core route of B3 (bf16, D a multiple of 8 up to
// 128). flash_bwd.cu's `hvt_flash_bwd_dkv` stays the CUDA-core route (f32,
// D > 128); B2 (dQ) has its tensor-core route in flash_bwd_dq_sm90.cu.
//
// Replaces the TPU kernel `horovod_tpu/ops/flash_attention.py:
// _bwd_dkv_kernel` (launched by `_flash_bwd_core`, twice with sinks: the
// band pass and a `sink_only` pass over k block 0). With S = Q K^T * scale
// under the forward's masks (flash_fwd_sm90.cu), lse from the forward and
// delta = rowsum(dO * O) - dlse from the caller:
//
//   P  = exp(S - lse) on kept (row, col) pairs, 0 elsewhere
//   dS = P * (dO V^T - delta)
//   dV = P^T dO,   dK = dS^T Q * scale,
//
// summed over the H / Hkv query heads of each kv head (GQA), in registers:
// no atomics, deterministic. A k tile holding sink columns visits every q
// tile from the diagonal on, which replaces the TPU's second launch.
//
// Precision: S and dO V^T are exact products of the bf16 inputs summed in
// f32. P and dS, the A operands of the two transposed products, are f32 in
// the TPU kernel and flash_bwd.cu; wgmma takes bf16. Rounding them to bf16
// (as FlashAttention does) moves dK and dV past the bf16 tolerance held
// against the plain version (dO and dS carry both signs, so the sums
// cancel; tests/test_torch_flash_sm90.py rehearses it), so each is fed as a
// bf16 hi + lo pair, two products against the same B: six products a tile
// instead of four. dK/dV accumulate in f32 and are rounded to bf16 once.
//
// What bounds it: at the training shape (B8 H8 T1024 D64 causal) the four
// products over the kept pairs are ~17.2 GFLOP, 17.4 us at 989 TFLOP/s,
// against ~51 MB moved, 15.2 us: operations. So every product runs on the
// tensor cores, transposed so that the 64 k rows of the CTA are the wgmma
// M dimension:
//
//   S^T  = K Q^T     A = K (shared, K-major)   B = Q (shared, K-major)
//   dP^T = V dO^T    A = V                     B = dO
//   P^T, dS^T on the accumulators (lse and delta broadcast along columns)
//   dV  += P^T dO    A = P^T (bf16 hi, lo)     B = dO (shared, MN-major)
//   dK  += dS^T Q    A = dS^T (bf16 hi, lo)    B = Q (shared, MN-major)
//
// * one CTA per (64 k rows, kv head, batch), the k tiles with the most
//   causal work first; 128 threads, one warpgroup, whose thread 0 also
//   issues the TMA loads: without a producer warp three CTAs fit an SM's
//   registers at D <= 64 (168 a thread), and they hide each other's waits;
// * K and V are resident in shared memory (bf16, 128-byte swizzle, loaded
//   once by TMA); Q and dO tiles with their lse and delta rows stream
//   through a 3-stage TMA ring over the rep q heads and the q tiles that
//   see the k tile (flash_bwd.cu's range rule), a stage refilled as soon as
//   the warpgroup is done with it. lse and delta arrive as one zero-padded
//   [2, B, H, Tq_pad] f32 array, each 64-row run a 256-byte bulk copy on
//   the stage's barrier;
// * only tiles on the diagonal, the band edge, a ragged end or segmented
//   calls evaluate the per-element predicate.
//
// Left on the table: one warpgroup per CTA (FA3 runs two over 128 k rows);
// a tile's products and its arithmetic run in turn (issuing the next
// tile's S^T/dP^T ahead of this tile's dV/dK products, FA3's intra-
// warpgroup overlap, needs registers that three CTAs per SM do not leave,
// and was no faster at two, where the other CTA fills those gaps); no
// persistent scheduler; dK/dV stored from registers
// rather than through shared memory and TMA.
//
// Layout: q/dO [B,Tq,H,D] and k/v [B,Tk,Hkv,D] bf16 read in place through
// tensor maps (dims D, H, T, B); dK/dV written contiguous [B,Tk,Hkv,D] bf16.

#include "sm90.cuh"

namespace {

constexpr int BM = 64;   // k rows a CTA (one warpgroup)
constexpr int BN = 64;   // q rows a tile
constexpr int ST = 3;    // Q/dO ring stages
constexpr int NT = 128;  // one warpgroup
constexpr int TILE_BYTES = BM * sm90::ROW_BYTES;  // one 64-column chunk
constexpr int STAT_BYTES = BN * 4;                // 64 f32 rows

struct alignas(64) Params {
  CUtensorMap q_map, k_map, v_map, o_map;  // o_map: dO
  const float* stats;  // [2, B, H, Tq_pad]: lse, delta (padding 0)
  const int* qseg;     // [B, Tq] or null
  const int* kseg;     // [B, Tk] or null
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int B, Tq, Tk, H, Hkv, D, Tq_pad, nk;
  int causal, window, sinks, offset;  // window 0 = no band
  float scale;
};

// The q tiles that can see k tile k0 (flash_bwd.cu's rule): from the first
// row on the diagonal of its first column; up to the last row whose band
// holds its last column, or to the end when the tile holds sink columns.
__device__ __forceinline__ void q_tiles(const Params& p, int k0, int& lo,
                                        int& hi) {
  const int nq = (p.Tq + BN - 1) / BN;
  lo = 0;
  hi = nq - 1;
  if (p.causal) {
    const long long first_row = (long long)k0 - p.offset;
    lo = first_row <= 0 ? 0 : (int)min(first_row / BN, (long long)nq);
    if (p.window > 0 && k0 >= p.sinks) {
      const long long last_col = min(k0 + BM, p.Tk) - 1;
      const long long last_row = last_col - p.offset + p.window - 1;
      if (last_row < 0)
        hi = -1;
      else if (last_row / BN < nq - 1)
        hi = (int)(last_row / BN);
    }
  }
}

template <int NC>
__global__ void __launch_bounds__(NT, NC == 1 ? 3 : 1)
    flash_bwd_dkv_sm90_kernel(__grid_constant__ const Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* k_s = base;
  uint8_t* v_s = k_s + NC * TILE_BYTES;
  uint8_t* q_s = v_s + NC * TILE_BYTES;    // [ST][NC] chunks
  uint8_t* o_s = q_s + ST * NC * TILE_BYTES;  // dO, [ST][NC] chunks
  float* stat_s = reinterpret_cast<float*>(o_s + ST * NC * TILE_BYTES);
  uint64_t* kv_bar = reinterpret_cast<uint64_t*>(stat_s + ST * 2 * BN);
  uint64_t* full = kv_bar + 1;

  const int tid = threadIdx.x;
  const int hb = p.Hkv * p.B;
  const int kt = (int)(blockIdx.x / hb);  // most causal work first
  const int hk = (int)(blockIdx.x % p.Hkv);
  const int b = (int)((blockIdx.x / p.Hkv) % p.B);
  const int rep = p.H / p.Hkv;
  const int k0 = kt * BM;
  int qt_lo, qt_hi;
  q_tiles(p, k0, qt_lo, qt_hi);
  // Tile j of the CTA's sweep: q head hk * rep + j / nqt, q tile
  // qt_lo + j % nqt, in stage j % ST.
  const int nqt = max(qt_hi - qt_lo + 1, 0);
  const int n = rep * nqt;

  // Thread 0: tile j's Q, dO, lse and delta into its stage.
  auto issue = [&](int j) {
    const int s = j % ST;
    const int h = hk * rep + j / nqt;
    const int qt = qt_lo + j % nqt;
    const float* lse_g = p.stats + ((long long)b * p.H + h) * p.Tq_pad;
    const float* del_g = lse_g + (long long)p.B * p.H * p.Tq_pad;
    sm90::mbar_expect_tx(&full[s], 2 * NC * TILE_BYTES + 2 * STAT_BYTES);
    for (int c = 0; c < NC; ++c) {
      sm90::tma_load_4d(q_s + (s * NC + c) * TILE_BYTES, &p.q_map, &full[s],
                        c * 64, h, qt * BN, b);
      sm90::tma_load_4d(o_s + (s * NC + c) * TILE_BYTES, &p.o_map, &full[s],
                        c * 64, h, qt * BN, b);
    }
    sm90::bulk_load(stat_s + s * 2 * BN, lse_g + qt * BN, STAT_BYTES,
                    &full[s]);
    sm90::bulk_load(stat_s + s * 2 * BN + BN, del_g + qt * BN, STAT_BYTES,
                    &full[s]);
  };

  if (tid == 0) {
    sm90::mbar_init(kv_bar, 1);
    for (int s = 0; s < ST; ++s) sm90::mbar_init(&full[s], 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    sm90::mbar_expect_tx(kv_bar, 2 * NC * TILE_BYTES);
    for (int c = 0; c < NC; ++c) {
      sm90::tma_load_4d(k_s + c * TILE_BYTES, &p.k_map, kv_bar, c * 64, hk,
                        k0, b);
      sm90::tma_load_4d(v_s + c * TILE_BYTES, &p.v_map, kv_bar, c * 64, hk,
                        k0, b);
    }
    for (int j = 0; j < min(ST, n); ++j) issue(j);
  }

  // Thread owns k rows kr0 and kr0 + 8 of the tile, and in each 8-column
  // group of S^T the q columns cq, cq + 1.
  const int warp = tid >> 5, lane = tid & 31;
  const int kr0 = warp * 16 + (lane >> 2);
  const int cq = 2 * (lane & 3);
  const float sl2 = p.scale * sm90::LOG2E;
  const bool seg = p.qseg != nullptr;
  int kid[2] = {0, 0};
  if (seg) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int gc = k0 + kr0 + 8 * hh;
      kid[hh] = gc < p.Tk ? p.kseg[(long long)b * p.Tk + gc] : 0;
    }
  }

  float dk[NC][32], dv[NC][32];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) dk[c][e] = dv[c][e] = 0.f;
  const uint32_t k_addr = sm90::smem_u32(k_s);
  const uint32_t v_addr = sm90::smem_u32(v_s);
  sm90::mbar_wait(kv_bar, 0);

  for (int i = 0; i < n; ++i) {
    const int s = i % ST;
    sm90::mbar_wait(&full[s], (i / ST) & 1);
    const uint32_t q_addr = sm90::smem_u32(q_s + s * NC * TILE_BYTES);
    const uint32_t o_addr = sm90::smem_u32(o_s + s * NC * TILE_BYTES);
    const float* lse_s = stat_s + s * 2 * BN;
    const float* del_s = lse_s + BN;

    float st[32], dpt[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) st[e] = dpt[e] = 0.f;
    sm90::fence_regs(st);
    sm90::fence_regs(dpt);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NC; ++kk) {
      const uint32_t off = (kk >> 2) * TILE_BYTES + (kk & 3) * 32;
      sm90::wgmma_ss(st, sm90::desc_sw128(k_addr + off),
                     sm90::desc_sw128(q_addr + off), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < 4 * NC; ++kk) {
      const uint32_t off = (kk >> 2) * TILE_BYTES + (kk & 3) * 32;
      sm90::wgmma_ss(dpt, sm90::desc_sw128(v_addr + off),
                     sm90::desc_sw128(o_addr + off), kk > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(st);
    sm90::fence_regs(dpt);

    const int q0 = (qt_lo + i % nqt) * BN;
    const bool interior =
        !seg && q0 + BN <= p.Tq && k0 + BM <= p.Tk &&
        (!p.causal ||
         (k0 + BM - 1 <= q0 + p.offset &&
          (p.window == 0 || k0 > q0 + BN - 1 + p.offset - p.window)));
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int qc = 8 * j + cq;
      const float2 lse2 = *reinterpret_cast<const float2*>(lse_s + qc);
      const float2 del2 = *reinterpret_cast<const float2*>(del_s + qc);
#pragma unroll
      for (int e4 = 0; e4 < 4; ++e4) {
        const int e = 4 * j + e4;
        const int odd = e4 & 1;
        const float lse_v = odd ? lse2.y : lse2.x;
        const float del_v = odd ? del2.y : del2.x;
        float pv = exp2f(fmaf(st[e], sl2, -lse_v * sm90::LOG2E));
        if (!interior) {
          const int gr = q0 + qc + odd;
          const int gc = k0 + kr0 + 8 * (e4 >> 1);
          bool keep = gr < p.Tq && gc < p.Tk;
          if (p.causal) {
            const int pos = gr + p.offset;
            keep = keep && gc <= pos;
            if (p.window > 0)
              keep = keep && (gc > pos - p.window || gc < p.sinks);
          }
          if (seg && keep)
            keep = p.qseg[(long long)b * p.Tq + gr] == kid[e4 >> 1];
          if (!keep) pv = 0.f;
        }
        st[e] = pv;
        dpt[e] = pv * (dpt[e] - del_v);
      }
    }
    uint32_t pa[16], pa_lo[16], da[16], da_lo[16];
    sm90::acc_to_a_split(st, pa, pa_lo);
    sm90::acc_to_a_split(dpt, da, da_lo);

#pragma unroll
    for (int c = 0; c < NC; ++c) {
      sm90::fence_regs(dv[c]);
      sm90::fence_regs(dk[c]);
    }
    sm90::wgmma_fence();
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t off = c * TILE_BYTES + kk * 16 * sm90::ROW_BYTES;
        const uint64_t o_desc = sm90::desc_sw128(o_addr + off);
        const uint64_t q_desc = sm90::desc_sw128(q_addr + off);
        sm90::wgmma_rs(dv[c], &pa[4 * kk], o_desc);
        sm90::wgmma_rs(dv[c], &pa_lo[4 * kk], o_desc);
        sm90::wgmma_rs(dk[c], &da[4 * kk], q_desc);
        sm90::wgmma_rs(dk[c], &da_lo[4 * kk], q_desc);
      }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      sm90::fence_regs(dv[c]);
      sm90::fence_regs(dk[c]);
    }
    // Stage s is free once every warp is past its products: refill it.
    __syncthreads();
    if (tid == 0 && i + ST < n) issue(i + ST);
  }

  // Epilogue: dK * scale and dV for the thread's two k rows, bf16.
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int gc = k0 + kr0 + 8 * hh;
    if (gc >= p.Tk) continue;
    const long long row = (((long long)b * p.Tk + gc) * p.Hkv + hk) * p.D;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = c * 64 + 8 * j;
        if (col >= p.D) continue;
        const int e = 4 * j + 2 * hh;
        *reinterpret_cast<uint32_t*>(p.dk + row + col + cq) = sm90::pack_bf16(
            dk[c][e] * p.scale, dk[c][e + 1] * p.scale);
        *reinterpret_cast<uint32_t*>(p.dv + row + col + cq) =
            sm90::pack_bf16(dv[c][e], dv[c][e + 1]);
      }
  }
}

template <int NC>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = (size_t)(2 + 2 * ST) * NC * TILE_BYTES +
                      ST * 2 * STAT_BYTES + (1 + ST) * 8 + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_sm90_kernel<NC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)p.nk * p.Hkv * p.B;
  flash_bwd_dkv_sm90_kernel<NC><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// q/k/v/dout: int64 tensor descriptions (sm90::TENSOR_DESC_LEN each, as
// hvt_flash_fwd_sm90). stats: f32 [2, B, H, Tq_pad] (lse, delta; Tq_pad a
// multiple of 64, zero-padded). Returns a CUDA error code (0 = launched).
// The caller validates shapes and allocates dk/dv contiguous.
extern "C" int hvt_flash_bwd_dkv_sm90(
    const long long* qd, const long long* kd, const long long* vd,
    const long long* od, const void* stats, const void* qseg,
    const void* kseg, void* dk, void* dv, int B, int Tq, int Tk, int H,
    int Hkv, int D, int Tq_pad, int causal, int window, int sinks, int offset,
    float scale, void* stream) {
  if (D < 8 || D > 128 || D % 8 != 0 || Hkv < 1 || H % Hkv != 0 ||
      Tq_pad % BN != 0 || Tq_pad < Tq)
    return (int)cudaErrorInvalidValue;
  Params p;
  cudaError_t err;
  if ((err = sm90::make_map(&p.q_map, qd)) != cudaSuccess ||
      (err = sm90::make_map(&p.k_map, kd)) != cudaSuccess ||
      (err = sm90::make_map(&p.v_map, vd)) != cudaSuccess ||
      (err = sm90::make_map(&p.o_map, od)) != cudaSuccess)
    return (int)err;
  p.stats = static_cast<const float*>(stats);
  p.qseg = static_cast<const int*>(qseg);
  p.kseg = static_cast<const int*>(kseg);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.B = B;
  p.Tq = Tq;
  p.Tk = Tk;
  p.H = H;
  p.Hkv = Hkv;
  p.D = D;
  p.Tq_pad = Tq_pad;
  p.nk = (Tk + BM - 1) / BM;
  p.causal = causal;
  p.window = window;
  p.sinks = sinks;
  p.offset = offset;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(D <= 64 ? launch<1>(p, st) : launch<2>(p, st));
}
