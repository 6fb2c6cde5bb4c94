// Flash-attention forward on Hopper's tensor cores (sm_90a), CUDA C++ with a
// plain C entry: the tensor-core route of B1 (bf16, D a multiple of 8 up to
// 128). flash_fwd.cu stays the CUDA-core route (f32, D > 128).
//
// Replaces the TPU kernel `horovod_tpu/ops/flash_attention.py:_fwd_kernel`
// (launched by `_flash_fwd_impl`): O = softmax(Q K^T * D^-1/2 + mask) V and
// the per-row logsumexp, with flash_fwd.cu's masks — end-aligned causal (row
// r sees col c <= r + offset), window band (c > r + offset - window), sinks
// (c < sinks re-admitted beyond the band, once), segment-id equality — and
// its rules: tiles wholly above the diagonal or below the band are skipped
// (sink tiles kept); a row with no visible key gives O = 0 and lse = -1e30,
// never NaN; P is rounded to bf16 before P.V, as the TPU kernel's
// `p.astype(v.dtype)`.
//
// What bounds it: at the training shape (B8 H8 T1024 D64 causal) the call
// must move q, k, v, O and lse once, ~34 MB, 10.1 us at 3.35 TB/s, against
// ~8.6 GFLOP of kept products, 8.7 us at 989 TFLOP/s: bytes, barely. Both
// are far below what a CUDA-core kernel reaches, so the design puts the
// products on the tensor cores and keeps every intermediate on chip:
//
// * one CTA per (64 q rows, head, batch); the heaviest causal q tiles get
//   the lowest block ids, so they start first and the short ones fill the
//   tail. 128 threads, one warpgroup (the 64 rows, wgmma M), whose thread
//   0 also issues the TMA loads: without a producer warp four CTAs fit an
//   SM's registers at D <= 64, and they hide each other's waits;
// * Q is loaded once; K and V tiles of 64 keys stream through a 2-stage
//   ring of bf16, 128-byte-swizzled shared memory, filled by
//   cp.async.bulk.tensor under mbarriers (a stage refilled as soon as the
//   warpgroup is done with it), read in place through
//   tensor maps built from the views' own strides (V is a strided view of
//   the fused qkv projection). Columns past D (D 40) are zero-filled by TMA;
//   rows past T likewise, and the mask drops them;
// * S = Q K^T by wgmma m64n64k16 (both operands from shared memory,
//   K-major) into f32 registers; the online softmax runs on that fragment
//   (row max and sum across the quad by shuffles, exp2 with scale * log2 e
//   folded in); m, l and O stay in registers; P becomes the bf16 register A
//   operand of O += P V, with V the MN-major B operand (transpose bit).
//   S never touches shared memory;
// * only tiles that cross the diagonal, the band edge, the sequence end or
//   a segmented call evaluate the per-element predicate.
//
// Left on the table: one consumer warpgroup (no ping-pong of softmax and
// products between two), S and P.V of one tile serialised (no
// intra-warpgroup overlap of the next QK^T with this P.V), no persistent
// scheduler, O stored from registers (4-byte stores) rather than through
// shared memory and TMA.
//
// Layout: q [B,Tq,H,D], k/v [B,Tk,Hkv,D] bf16 read in place through tensor
// maps (dims D, H, T, B; the caller checks 16-byte alignment); O written
// contiguous [B,Tq,H,D] bf16, lse f32 [B,Tq,H].

#include "sm90.cuh"

#include <math_constants.h>

namespace {

constexpr int BM = 64;   // q rows a CTA (one warpgroup)
constexpr int BN = 64;   // keys a tile
constexpr int ST = 2;    // K/V ring stages
constexpr int NT = 128;  // one warpgroup
constexpr int TILE_BYTES = BM * sm90::ROW_BYTES;  // one 64-column chunk
constexpr float BIG_NEG = -1e30f;

struct alignas(64) Params {
  CUtensorMap q_map, k_map, v_map;
  const int* qseg;  // [B, Tq] or null
  const int* kseg;  // [B, Tk] or null
  __nv_bfloat16* o;
  float* lse;
  int B, Tq, Tk, H, Hkv, D, nq;
  int causal, window, sinks, offset;  // window 0 = no band
  float scale;
};

// The k tiles q tile q0 visits: kt in [0, hi], skipping [n_sink, lo).
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
    flash_fwd_sm90_kernel(__grid_constant__ const Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* q_s = base;
  uint8_t* k_s = q_s + NC * TILE_BYTES;
  uint8_t* v_s = k_s + ST * NC * TILE_BYTES;
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(v_s + ST * NC * TILE_BYTES);
  uint64_t* full = q_bar + 1;

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
    sm90::mbar_init(q_bar, 1);
    for (int s = 0; s < ST; ++s) sm90::mbar_init(&full[s], 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    sm90::mbar_expect_tx(q_bar, NC * TILE_BYTES);
    for (int c = 0; c < NC; ++c)
      sm90::tma_load_4d(q_s + c * TILE_BYTES, &p.q_map, q_bar, c * 64, h, q0,
                        b);
    for (int i = 0; i < min(ST, n); ++i) issue(i);
  }

  // Thread owns tile rows r0 and r0 + 8, and in each 8-column group of S
  // the columns cq, cq + 1.
  const int warp = tid >> 5, lane = tid & 31;
  const int r0 = warp * 16 + (lane >> 2);
  const int cq = 2 * (lane & 3);
  const float sl2 = p.scale * sm90::LOG2E;
  const bool seg = p.qseg != nullptr;
  int qid[2] = {0, 0};
  if (seg) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int gr = q0 + r0 + 8 * hh;
      qid[hh] = gr < p.Tq ? p.qseg[(long long)b * p.Tq + gr] : 0;
    }
  }

  float o[NC][32];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) o[c][e] = 0.f;
  float m[2] = {BIG_NEG, BIG_NEG}, l[2] = {0.f, 0.f};
  const uint32_t q_addr = sm90::smem_u32(q_s);
  sm90::mbar_wait(q_bar, 0);

  for (int i = 0; i < n; ++i) {
    const int kt = tile(i), s = i % ST;
    sm90::mbar_wait(&full[s], (i / ST) & 1);
    const uint32_t k_addr = sm90::smem_u32(k_s + s * NC * TILE_BYTES);
    const uint32_t v_addr = sm90::smem_u32(v_s + s * NC * TILE_BYTES);

    float sc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) sc[e] = 0.f;
    sm90::fence_regs(sc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NC; ++kk) {
      const uint32_t off = (kk >> 2) * TILE_BYTES + (kk & 3) * 32;
      sm90::wgmma_ss(sc, sm90::desc_sw128(q_addr + off),
                     sm90::desc_sw128(k_addr + off), kk > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sc);

    const int k0 = kt * BN;
    const bool interior =
        !seg && k0 + BN <= p.Tk &&
        (!p.causal ||
         (k0 + BN - 1 <= q0 + p.offset &&
          (p.window == 0 || k0 > q0 + BM - 1 + p.offset - p.window)));
    if (!interior) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int hh = (e >> 1) & 1;
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
        if (!keep) sc[e] = -CUDART_INF_F;
      }
    }

    // Online softmax on the fragment; l stays a per-thread partial sum.
    float alpha[2], msl[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * hh], sc[4 * j + 2 * hh + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hh], mx);  // finite: m starts at BIG_NEG
      alpha[hh] = exp2f((m[hh] - m_new) * sl2);
      m[hh] = m_new;
      msl[hh] = m_new * sl2;
      l[hh] *= alpha[hh];
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int hh = (e >> 1) & 1;
      const float pv = exp2f(fmaf(sc[e], sl2, -msl[hh]));
      l[hh] += pv;
      sc[e] = pv;
    }
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) o[c][e] *= alpha[(e >> 1) & 1];
    uint32_t pa[16];
    sm90::acc_to_a(sc, pa);

#pragma unroll
    for (int c = 0; c < NC; ++c) sm90::fence_regs(o[c]);
    sm90::wgmma_fence();
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::wgmma_rs(o[c], &pa[4 * kk],
                       sm90::desc_sw128(v_addr + c * TILE_BYTES +
                                        kk * 16 * sm90::ROW_BYTES));
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < NC; ++c) sm90::fence_regs(o[c]);
    // Stage s is free once every warp is past its products: refill it.
    __syncthreads();
    if (tid == 0 && i + ST < n) issue(i + ST);
  }

  // Epilogue: O / l and lse for the thread's two rows.
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float lt = l[hh];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int gr = q0 + r0 + 8 * hh;
    if (gr >= p.Tq) continue;
    const bool empty_row = lt == 0.f;
    const float inv = empty_row ? 0.f : 1.f / lt;
    __nv_bfloat16* orow = p.o + (((long long)b * p.Tq + gr) * p.H + h) * p.D;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = c * 64 + 8 * j;
        if (col < p.D)
          *reinterpret_cast<uint32_t*>(orow + col + cq) =
              sm90::pack_bf16(o[c][4 * j + 2 * hh] * inv,
                              o[c][4 * j + 2 * hh + 1] * inv);
      }
    if ((lane & 3) == 0)
      p.lse[((long long)b * p.Tq + gr) * p.H + h] =
          empty_row ? BIG_NEG : m[hh] * p.scale + logf(lt);
  }
}

template <int NC>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem =
      (size_t)(1 + 2 * ST) * NC * TILE_BYTES + (1 + ST) * 8 + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_sm90_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)p.nq * p.H * p.B;
  flash_fwd_sm90_kernel<NC><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// q/k/v: int64 tensor descriptions (sm90::TENSOR_DESC_LEN each: pointer,
// dims D, H, T, B, byte strides of H, T, B, box). Returns a CUDA error code
// (0 = launched). The caller validates shapes (bf16, D % 8 == 0, D <= 128,
// H % Hkv == 0, 16-byte alignment) and allocates o/lse contiguous.
extern "C" int hvt_flash_fwd_sm90(const long long* qd, const long long* kd,
                                  const long long* vd, const void* qseg,
                                  const void* kseg, void* o, void* lse, int B,
                                  int Tq, int Tk, int H, int Hkv, int D,
                                  int causal, int window, int sinks,
                                  int offset, float scale, void* stream) {
  if (D < 8 || D > 128 || D % 8 != 0 || Hkv < 1 || H % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  cudaError_t err;
  if ((err = sm90::make_map(&p.q_map, qd)) != cudaSuccess ||
      (err = sm90::make_map(&p.k_map, kd)) != cudaSuccess ||
      (err = sm90::make_map(&p.v_map, vd)) != cudaSuccess)
    return (int)err;
  p.qseg = static_cast<const int*>(qseg);
  p.kseg = static_cast<const int*>(kseg);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
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
