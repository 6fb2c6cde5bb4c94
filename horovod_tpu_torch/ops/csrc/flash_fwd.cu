// Flash-attention forward for Hopper (sm_90a), CUDA C++ with a plain C entry.
//
// Replaces the TPU kernel `horovod_tpu/ops/flash_attention.py:_fwd_kernel`
// (launched by `_flash_fwd_impl`): O = softmax(Q K^T * D^-1/2 + mask) V and
// the per-row logsumexp, with the same masks — end-aligned causal (row r sees
// col c <= r + offset), sliding-window band (c > r + offset - window), sinks
// (c < sinks re-admitted beyond the band, each pair counted once) and
// segment-id equality. A row with no visible key gives O = 0 and
// lse = -1e30, never NaN.
//
// What bounds it on this card: at the serving prefill shape (B8 H8 T128 D64)
// the call moves ~4 MB and does ~0.13 GFLOP, so the H100's bound is HBM
// bytes (~1.3 us); at long prompts (T >= 2k) the 2*B*H*T^2*D matmul FLOPs
// dominate. Design: one CUDA block per (q tile of 64 rows, head, batch); a
// loop inside the block sweeps the k tiles, which takes the place of the TPU
// grid's sequential axis. The q tile stays in shared memory for the whole
// sweep, each K/V tile is read from HBM once per q tile, and the [64, 64]
// score tile lives only in shared memory, so HBM traffic is the inputs once
// per q tile plus O and lse once. Online softmax keeps the running max m,
// normaliser l and the output accumulator in f32 registers. Tiles wholly
// above the causal diagonal or below the window band are skipped (the sink
// tiles are still visited). This first version multiplies on the CUDA cores
// from shared memory (no wgmma/TMA yet), so at long T it is bound by
// shared-memory issue rate, far from the tensor-core bound.
//
// Layout: q [B,Tq,H,D], k/v [B,Tk,Hkv,D] read in place through their strides
// (last dim contiguous; H % Hkv == 0, kv head = h / (H / Hkv)); O written
// contiguous [B,Tq,H,D] in the input dtype, lse f32 [B,Tq,H]. Inputs f32, bf16
// or fp16; all products accumulate in f32. P is rounded to the input dtype
// before the P.V product, as the TPU kernel does (`p.astype(v.dtype)`).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // keys per shared-memory tile
constexpr int NT = 256;  // threads per block: 4 per query row
constexpr float BIG_NEG = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* qseg;  // [B, Tq] or null
  const int* kseg;  // [B, Tk] or null
  void* o;
  float* lse;
  int B, Tq, Tk, H, Hkv, D;
  long long q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh;
  int causal, window, sinks, offset;  // window 0 = no band
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

// Round to the input dtype and back (identity for f32).
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(Params p) {
  extern __shared__ float smem[];
  const int D = p.D;
  const int ld = D + 1;  // padded row stride: no bank conflicts on columns
  float* Qs = smem;
  float* Ks = Qs + BQ * ld;
  float* Vs = Ks + BK * ld;
  float* Ss = Vs + BK * ld;  // [BQ][BK + 1] scores, then probabilities
  int* qid = reinterpret_cast<int*>(Ss + BQ * (BK + 1));
  int* kid = qid + BQ;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);
  const bool seg = p.qseg != nullptr;
  const T* qp = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, d = i - r * D, gr = q0 + r;
    Qs[r * ld + d] = gr < p.Tq ? to_f32(qp[gr * p.q_st + d]) : 0.f;
  }
  if (seg && tid < BQ) {
    const int gr = q0 + tid;
    qid[tid] = gr < p.Tq ? p.qseg[(long long)b * p.Tq + gr] : 0;
  }

  // The k tiles this q tile can see: up to the diagonal of its last row,
  // from the band start of its first row, plus the sink tiles.
  const int nk = (p.Tk + BK - 1) / BK;
  int kt_hi = nk - 1, kt_lo = 0, n_sink = 0;
  if (p.causal) {
    const long long last_row = min(q0 + BQ, p.Tq) - 1;
    const long long max_col = last_row + p.offset;
    if (max_col < 0)
      kt_hi = -1;
    else if (max_col / BK < nk - 1)
      kt_hi = (int)(max_col / BK);
    if (p.window > 0) {
      const long long min_col = (long long)q0 + p.offset - p.window + 1;
      kt_lo = min_col <= 0 ? 0 : (int)(min_col / BK);
      n_sink = (p.sinks + BK - 1) / BK;
    }
  }

  // Row ownership for softmax and P.V: 4 consecutive lanes per row.
  const int row = tid >> 2, quad = tid & 3;
  float m = BIG_NEG, l = 0.f;
  float acc[DMAX / 4];
#pragma unroll
  for (int j = 0; j < DMAX / 4; ++j) acc[j] = 0.f;

  for (int kt = 0; kt <= kt_hi; ++kt) {
    if (kt < kt_lo && kt >= n_sink) continue;  // uniform across the block
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BK * D; i += NT) {
      const int c = i / D, d = i - c * D, gc = k0 + c;
      const bool in = gc < p.Tk;
      Ks[c * ld + d] = in ? to_f32(kp[gc * p.k_st + d]) : 0.f;
      Vs[c * ld + d] = in ? to_f32(vp[gc * p.v_st + d]) : 0.f;
    }
    if (seg && tid < BK) {
      const int gc = k0 + tid;
      kid[tid] = gc < p.Tk ? p.kseg[(long long)b * p.Tk + gc] : 0;
    }
    __syncthreads();

    // Scores: each thread a 4x4 micro-tile, rows rg*4+i, cols cg+16*j.
    {
      const int rg = tid >> 4, cg = tid & 15;
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
      for (int d = 0; d < D; ++d) {
        float qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = Qs[(rg * 4 + i) * ld + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[j] = Ks[(cg + 16 * j) * ld + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = rg * 4 + i, c = cg + 16 * j;
          const int gr = q0 + r, gc = k0 + c;
          bool keep = gr < p.Tq && gc < p.Tk;
          if (p.causal) {
            const int pos = gr + p.offset;
            keep = keep && gc <= pos;
            if (p.window > 0)
              keep = keep && (gc > pos - p.window || gc < p.sinks);
          }
          if (seg) keep = keep && qid[r] == kid[c];
          Ss[r * (BK + 1) + c] = keep ? s[i][j] * p.scale : -CUDART_INF_F;
        }
      }
    }
    __syncthreads();

    // Online softmax over this tile: each lane 16 of the row's 64 columns.
    {
      float* srow = Ss + row * (BK + 1) + quad * 16;
      float tmax = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 16; ++j) tmax = fmaxf(tmax, srow[j]);
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      const float m_new = fmaxf(m, tmax);  // finite: m starts at BIG_NEG
      const float alpha = expf(m - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float sv = srow[j];
        const float pv = sv == -CUDART_INF_F ? 0.f : expf(sv - m_new);
        psum += pv;
        srow[j] = round_to<T>(pv);
      }
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      psum += __shfl_xor_sync(0xffffffffu, psum, 2);
      l = l * alpha + psum;
      m = m_new;
#pragma unroll
      for (int j = 0; j < DMAX / 4; ++j) acc[j] *= alpha;
    }
    __syncthreads();

    // acc[row, quad + 4j] += sum_c P[row, c] * V[c, quad + 4j]
    {
      const float* prow = Ss + row * (BK + 1);
      for (int c = 0; c < BK; ++c) {
        const float pv = prow[c];
        const float* vrow = Vs + c * ld + quad;
#pragma unroll
        for (int j = 0; j < DMAX / 4; ++j)
          if (quad + 4 * j < D) acc[j] = fmaf(pv, vrow[4 * j], acc[j]);
      }
    }
  }

  // Epilogue: stage O through shared memory for coalesced stores.
  __syncthreads();
  const bool empty = l == 0.f;
  const float l_safe = empty ? 1.f : l;
#pragma unroll
  for (int j = 0; j < DMAX / 4; ++j) {
    const int d = quad + 4 * j;
    if (d < D) Qs[row * ld + d] = acc[j] / l_safe;
  }
  const int grow = q0 + row;
  if (quad == 0 && grow < p.Tq)
    p.lse[((long long)b * p.Tq + grow) * p.H + h] =
        empty ? BIG_NEG : m + logf(l_safe);
  __syncthreads();
  T* op = static_cast<T*>(p.o);
  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, d = i - r * D, gr = q0 + r;
    if (gr < p.Tq)
      op[(((long long)b * p.Tq + gr) * p.H + h) * D + d] =
          from_f32<T>(Qs[r * ld + d]);
  }
}

template <typename T, int DMAX>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem =
      (size_t)(BQ * (p.D + 1) + 2 * BK * (p.D + 1) + BQ * (BK + 1)) *
          sizeof(float) +
      (BQ + BK) * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Tq + BQ - 1) / BQ, p.H, p.B);
  flash_fwd_kernel<T, DMAX><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const Params& p, cudaStream_t stream) {
  if (p.D <= 64) return launch<T, 64>(p, stream);
  if (p.D <= 128) return launch<T, 128>(p, stream);
  return launch<T, 256>(p, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. Returns cudaGetLastError()
// after the launch (0 = launched). The caller validates shapes, D <= 256 and
// H % Hkv == 0, and allocates o/lse contiguous.
extern "C" int hvt_flash_fwd(
    const void* q, const void* k, const void* v, const void* qseg,
    const void* kseg, void* o, void* lse, int B, int Tq, int Tk, int H,
    int Hkv, int D, long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_st, long long k_sh, long long v_sb,
    long long v_st, long long v_sh, int causal, int window, int sinks,
    int offset, float scale, int dtype, void* stream) {
  if (D < 1 || D > 256 || Hkv < 1 || H % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  Params p{q,    k,    v,    static_cast<const int*>(qseg),
           static_cast<const int*>(kseg),
           o,    static_cast<float*>(lse),
           B,    Tq,   Tk,   H,    Hkv,  D,
           q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh,
           causal, window, sinks, offset, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_d<float>(p, st);
  else if (dtype == 1)
    err = dispatch_d<__nv_bfloat16>(p, st);
  else if (dtype == 2)
    err = dispatch_d<__half>(p, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
