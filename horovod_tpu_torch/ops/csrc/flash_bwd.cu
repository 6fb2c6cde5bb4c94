// Flash-attention backward for Hopper (sm_90a), CUDA C++ with plain C entries.
//
// Replaces the TPU kernels `horovod_tpu/ops/flash_attention.py:_bwd_dq_kernel`
// (B2) and `_bwd_dkv_kernel` (B3), both launched by `_flash_bwd_core` (B3
// twice there with sinks: the band pass and a `sink_only` pass over k block
// 0). Given q, k, v, dO, the forward's lse and delta = rowsum(dO * O) - dlse
// (computed by the caller, as JAX does it outside its kernels), with
// S = Q K^T * scale under the forward's masks:
//
//   P  = exp(S - lse)  on kept (row, col) pairs, 0 elsewhere
//   dS = P * (dO V^T - delta)
//   dQ = dS K * scale        (B2, `hvt_flash_bwd_dq`)
//   dK = dS^T Q * scale      (B3, `hvt_flash_bwd_dkv`)
//   dV = P^T dO              (B3)
//
// Masks as in flash_fwd.cu: end-aligned causal (row r sees col
// c <= r + offset), window band (c > r + offset - window), sinks (c < sinks
// re-admitted beyond the band, each pair counted once), segment-id
// equality. P is zero on every masked pair, so a row with no visible key
// (lse = -1e30) gets zero gradient, never NaN. P stays f32 (the TPU kernels
// do not round it to the input dtype in the backward); dO, V, K and Q are
// upcast to f32 as they are loaded; dQ/dK/dV are cast to the input dtype
// once, at the end.
//
// What bounds them on this card: at the training shape (B8 H8 T1024 D64
// causal bf16) B2 does 3 products of B*H*T^2*D/2 multiply-adds each
// (~12.9 GFLOP, ~13 us at 989 TFLOP/s) and moves ~42 MB (~12.7 us); B3 does
// 4 (~17.2 GFLOP) and moves ~51 MB. Both are operation-bound on the tensor
// cores. This first version multiplies on the CUDA cores from f32 shared
// memory, as B1 does, so it is bound by shared-memory issue rate, far from
// that bound; the tensor-core (wgmma/TMA) redesign is later work.
//
// Design. B2: one block per (q tile, head, batch). The Q and dO rows, their
// lse and delta stay in shared memory; a loop sweeps the k tiles the
// forward visits (same skip rule: above the diagonal, below the band, sink
// tiles kept), forms S and dP for the [BQ, BK] tile, keeps dS in shared
// memory and accumulates dQ in f32 registers (TPR lanes per row), written
// once. B3: one block per (k tile, KV head, batch). K and V stay in shared
// memory; the block loops over the H / Hkv query heads that share the kv
// head (GQA: the sum over the group that autodiff of the JAX model's
// `jnp.repeat` gives) and over the q tiles that can see the tile: the
// causal/band range, or every q tile from the diagonal on when the tile
// holds sink columns (this replaces the TPU's separate `sink_only` launch).
// dK and dV are summed in registers: no atomics, runs are deterministic.
// Tiles are 64 x 64 up to D = 128 and 32 x 32 for D <= 256, so that Q, dO,
// K, V and the score tiles fit in 227 KB of shared memory in f32.
//
// Layout: q/dO [B,Tq,H,D] and k/v [B,Tk,Hkv,D] read in place through their
// strides (last dim contiguous; H % Hkv == 0, kv head = h / (H / Hkv));
// lse/delta f32 [B,Tq,H] contiguous; dQ written contiguous [B,Tq,H,D] and
// dK/dV contiguous [B,Tk,Hkv,D], in the input dtype (f32, bf16 or fp16).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;  // threads per block

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B, Tq, H]
  const float* delta;  // [B, Tq, H]
  const int* qseg;     // [B, Tq] or null
  const int* kseg;     // [B, Tk] or null
  void* dq;
  void* dk;
  void* dv;
  int B, Tq, Tk, H, Hkv, D;
  long long q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh;
  long long o_sb, o_st, o_sh;  // dO strides
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

// The forward's position masks for global (row, col); segment ids apart.
__device__ __forceinline__ bool keep_pair(const Params& p, int gr, int gc) {
  bool keep = gr < p.Tq && gc < p.Tk;
  if (p.causal) {
    const long long pos = (long long)gr + p.offset;
    keep = keep && gc <= pos;
    if (p.window > 0) keep = keep && (gc > pos - p.window || gc < p.sinks);
  }
  return keep;
}

// Shared-memory floats/ints of each kernel for tile size BT and head dim D.
__host__ __device__ inline size_t dq_smem_bytes(int BT, int D) {
  return (size_t)(4 * BT * (D + 1) + BT * (BT + 1) + 2 * BT) * sizeof(float) +
         (size_t)(2 * BT) * sizeof(int);
}
__host__ __device__ inline size_t dkv_smem_bytes(int BT, int D) {
  return (size_t)(4 * BT * (D + 1) + 2 * BT * (BT + 1) + 2 * BT) *
             sizeof(float) +
         (size_t)(2 * BT) * sizeof(int);
}

// S = Q K^T * scale and dP = dO V^T for one [BT, BT] tile, then
// P = exp(S - lse) on kept pairs and dS = P (dP - delta). Each thread a
// (BT/16) x (BT/16) micro-tile: rows rg*RM + i, cols cg + 16*j. Writes P to
// Ps (if not null) and dS to DSs, both [BT][BT + 1].
template <int BT>
__device__ __forceinline__ void score_tile(
    const Params& p, const float* Qs, const float* dOs, const float* Ks,
    const float* Vs, const float* lse_s, const float* del_s, const int* qid,
    const int* kid, bool seg, int q0, int k0, float* Ps, float* DSs) {
  constexpr int RM = BT / 16, CN = BT / 16;
  const int D = p.D, ld = D + 1;
  const int tid = threadIdx.x;
  const int rg = tid >> 4, cg = tid & 15;
  float s[RM][CN], dp[RM][CN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < CN; ++j) s[i][j] = dp[i][j] = 0.f;
  for (int d = 0; d < D; ++d) {
    float qv[RM], ov[RM], kv[CN], vv[CN];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      qv[i] = Qs[(rg * RM + i) * ld + d];
      ov[i] = dOs[(rg * RM + i) * ld + d];
    }
#pragma unroll
    for (int j = 0; j < CN; ++j) {
      kv[j] = Ks[(cg + 16 * j) * ld + d];
      vv[j] = Vs[(cg + 16 * j) * ld + d];
    }
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) {
#pragma unroll
    for (int j = 0; j < CN; ++j) {
      const int r = rg * RM + i, c = cg + 16 * j;
      bool keep = keep_pair(p, q0 + r, k0 + c);
      if (seg) keep = keep && qid[r] == kid[c];
      const float pr = keep ? expf(s[i][j] * p.scale - lse_s[r]) : 0.f;
      if (Ps != nullptr) Ps[r * (BT + 1) + c] = pr;
      DSs[r * (BT + 1) + c] = pr * (dp[i][j] - del_s[r]);
    }
  }
}

// B2: dQ for one (q tile, head, batch).
template <typename T, int DMAX, int BT>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(Params p) {
  constexpr int TPR = NT / BT;  // lanes per q row in the dQ product
  extern __shared__ float smem[];
  const int D = p.D;
  const int ld = D + 1;  // padded row stride: no bank conflicts on columns
  float* Qs = smem;
  float* dOs = Qs + BT * ld;
  float* Ks = dOs + BT * ld;
  float* Vs = Ks + BT * ld;
  float* DSs = Vs + BT * ld;  // [BT][BT + 1]
  float* lse_s = DSs + BT * (BT + 1);
  float* del_s = lse_s + BT;
  int* qid = reinterpret_cast<int*>(del_s + BT);
  int* kid = qid + BT;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);
  const bool seg = p.qseg != nullptr;
  const T* qp = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* op = static_cast<const T*>(p.dout) + b * p.o_sb + h * p.o_sh;
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  for (int i = tid; i < BT * D; i += NT) {
    const int r = i / D, d = i - r * D, gr = q0 + r;
    const bool in = gr < p.Tq;
    Qs[r * ld + d] = in ? to_f32(qp[gr * p.q_st + d]) : 0.f;
    dOs[r * ld + d] = in ? to_f32(op[gr * p.o_st + d]) : 0.f;
  }
  if (tid < BT) {
    const int gr = q0 + tid;
    const bool in = gr < p.Tq;
    const long long row = ((long long)b * p.Tq + gr) * p.H + h;
    lse_s[tid] = in ? p.lse[row] : 0.f;
    del_s[tid] = in ? p.delta[row] : 0.f;
    if (seg) qid[tid] = in ? p.qseg[(long long)b * p.Tq + gr] : 0;
  }

  // The k tiles the forward visits for this q tile (flash_fwd.cu's rule).
  const int nk = (p.Tk + BT - 1) / BT;
  int kt_hi = nk - 1, kt_lo = 0, n_sink = 0;
  if (p.causal) {
    const long long last_row = min(q0 + BT, p.Tq) - 1;
    const long long max_col = last_row + p.offset;
    if (max_col < 0)
      kt_hi = -1;
    else if (max_col / BT < nk - 1)
      kt_hi = (int)(max_col / BT);
    if (p.window > 0) {
      const long long min_col = (long long)q0 + p.offset - p.window + 1;
      kt_lo = min_col <= 0 ? 0 : (int)min(min_col / BT, (long long)nk);
      n_sink = (p.sinks + BT - 1) / BT;
    }
  }

  const int row = tid / TPR, lane = tid % TPR;
  float acc[DMAX / TPR];
#pragma unroll
  for (int j = 0; j < DMAX / TPR; ++j) acc[j] = 0.f;

  for (int kt = 0; kt <= kt_hi; ++kt) {
    if (kt < kt_lo && kt >= n_sink) continue;  // uniform across the block
    const int k0 = kt * BT;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BT * D; i += NT) {
      const int c = i / D, d = i - c * D, gc = k0 + c;
      const bool in = gc < p.Tk;
      Ks[c * ld + d] = in ? to_f32(kp[gc * p.k_st + d]) : 0.f;
      Vs[c * ld + d] = in ? to_f32(vp[gc * p.v_st + d]) : 0.f;
    }
    if (seg && tid < BT) {
      const int gc = k0 + tid;
      kid[tid] = gc < p.Tk ? p.kseg[(long long)b * p.Tk + gc] : 0;
    }
    __syncthreads();
    score_tile<BT>(p, Qs, dOs, Ks, Vs, lse_s, del_s, qid, kid, seg, q0, k0,
                   nullptr, DSs);
    __syncthreads();
    // acc[row, lane + TPR j] += sum_c dS[row, c] * K[c, lane + TPR j]
    const float* dsrow = DSs + row * (BT + 1);
    for (int c = 0; c < BT; ++c) {
      const float ds = dsrow[c];
      const float* krow = Ks + c * ld + lane;
#pragma unroll
      for (int j = 0; j < DMAX / TPR; ++j)
        if (lane + TPR * j < D) acc[j] = fmaf(ds, krow[TPR * j], acc[j]);
    }
  }

  // Epilogue: stage dQ through shared memory for coalesced stores.
  __syncthreads();
#pragma unroll
  for (int j = 0; j < DMAX / TPR; ++j) {
    const int d = lane + TPR * j;
    if (d < D) Qs[row * ld + d] = acc[j] * p.scale;
  }
  __syncthreads();
  T* dqp = static_cast<T*>(p.dq);
  for (int i = tid; i < BT * D; i += NT) {
    const int r = i / D, d = i - r * D, gr = q0 + r;
    if (gr < p.Tq)
      dqp[(((long long)b * p.Tq + gr) * p.H + h) * D + d] =
          from_f32<T>(Qs[r * ld + d]);
  }
}

// B3: dK and dV for one (k tile, kv head, batch).
template <typename T, int DMAX, int BT>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel(Params p) {
  constexpr int TPR = NT / BT;  // lanes per k row in the dK/dV products
  extern __shared__ float smem[];
  const int D = p.D;
  const int ld = D + 1;
  float* Ks = smem;
  float* Vs = Ks + BT * ld;
  float* Qs = Vs + BT * ld;
  float* dOs = Qs + BT * ld;
  float* Ps = dOs + BT * ld;      // [BT][BT + 1]
  float* DSs = Ps + BT * (BT + 1);  // [BT][BT + 1]
  float* lse_s = DSs + BT * (BT + 1);
  float* del_s = lse_s + BT;
  int* qid = reinterpret_cast<int*>(del_s + BT);
  int* kid = qid + BT;

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * BT;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = p.H / p.Hkv;
  const bool seg = p.qseg != nullptr;
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  for (int i = tid; i < BT * D; i += NT) {
    const int c = i / D, d = i - c * D, gc = k0 + c;
    const bool in = gc < p.Tk;
    Ks[c * ld + d] = in ? to_f32(kp[gc * p.k_st + d]) : 0.f;
    Vs[c * ld + d] = in ? to_f32(vp[gc * p.v_st + d]) : 0.f;
  }
  if (seg && tid < BT) {
    const int gc = k0 + tid;
    kid[tid] = gc < p.Tk ? p.kseg[(long long)b * p.Tk + gc] : 0;
  }

  // The q tiles that can see this k tile: from the first row on the
  // diagonal of its first column; up to the last row whose band holds its
  // last column, or to the end when the tile holds sink columns.
  const int nq = (p.Tq + BT - 1) / BT;
  int qt_lo = 0, qt_hi = nq - 1;
  if (p.causal) {
    const long long first_row = (long long)k0 - p.offset;
    qt_lo = first_row <= 0 ? 0 : (int)min(first_row / BT, (long long)nq);
    if (p.window > 0 && k0 >= p.sinks) {
      const long long last_col = min(k0 + BT, p.Tk) - 1;
      const long long last_row = last_col - p.offset + p.window - 1;
      if (last_row < 0)
        qt_hi = -1;
      else if (last_row / BT < nq - 1)
        qt_hi = (int)(last_row / BT);
    }
  }

  const int col = tid / TPR, lane = tid % TPR;
  float dk_acc[DMAX / TPR], dv_acc[DMAX / TPR];
#pragma unroll
  for (int j = 0; j < DMAX / TPR; ++j) dk_acc[j] = dv_acc[j] = 0.f;

  for (int hi = 0; hi < rep; ++hi) {
    const int h = hk * rep + hi;
    const T* qp = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
    const T* op = static_cast<const T*>(p.dout) + b * p.o_sb + h * p.o_sh;
    for (int qt = qt_lo; qt <= qt_hi; ++qt) {
      const int q0 = qt * BT;
      __syncthreads();  // the previous tile's readers are done
      for (int i = tid; i < BT * D; i += NT) {
        const int r = i / D, d = i - r * D, gr = q0 + r;
        const bool in = gr < p.Tq;
        Qs[r * ld + d] = in ? to_f32(qp[gr * p.q_st + d]) : 0.f;
        dOs[r * ld + d] = in ? to_f32(op[gr * p.o_st + d]) : 0.f;
      }
      if (tid < BT) {
        const int gr = q0 + tid;
        const bool in = gr < p.Tq;
        const long long row = ((long long)b * p.Tq + gr) * p.H + h;
        lse_s[tid] = in ? p.lse[row] : 0.f;
        del_s[tid] = in ? p.delta[row] : 0.f;
        if (seg) qid[tid] = in ? p.qseg[(long long)b * p.Tq + gr] : 0;
      }
      __syncthreads();
      score_tile<BT>(p, Qs, dOs, Ks, Vs, lse_s, del_s, qid, kid, seg, q0, k0,
                     Ps, DSs);
      __syncthreads();
      // dV[col, .] += sum_r P[r, col] dO[r, .];
      // dK[col, .] += sum_r dS[r, col] Q[r, .]
      for (int r = 0; r < BT; ++r) {
        const float pv = Ps[r * (BT + 1) + col];
        const float dsv = DSs[r * (BT + 1) + col];
        const float* orow = dOs + r * ld + lane;
        const float* qrow = Qs + r * ld + lane;
#pragma unroll
        for (int j = 0; j < DMAX / TPR; ++j) {
          if (lane + TPR * j < D) {
            dv_acc[j] = fmaf(pv, orow[TPR * j], dv_acc[j]);
            dk_acc[j] = fmaf(dsv, qrow[TPR * j], dk_acc[j]);
          }
        }
      }
    }
  }

  // Epilogue: stage dK (scaled) and dV through shared memory.
  __syncthreads();
#pragma unroll
  for (int j = 0; j < DMAX / TPR; ++j) {
    const int d = lane + TPR * j;
    if (d < D) {
      Ks[col * ld + d] = dk_acc[j] * p.scale;
      Vs[col * ld + d] = dv_acc[j];
    }
  }
  __syncthreads();
  T* dkp = static_cast<T*>(p.dk);
  T* dvp = static_cast<T*>(p.dv);
  for (int i = tid; i < BT * D; i += NT) {
    const int c = i / D, d = i - c * D, gc = k0 + c;
    if (gc < p.Tk) {
      const long long o = (((long long)b * p.Tk + gc) * p.Hkv + hk) * D + d;
      dkp[o] = from_f32<T>(Ks[c * ld + d]);
      dvp[o] = from_f32<T>(Vs[c * ld + d]);
    }
  }
}

template <typename T, int DMAX, int BT>
cudaError_t launch_dq(const Params& p, cudaStream_t stream) {
  const size_t smem = dq_smem_bytes(BT, p.D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, DMAX, BT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Tq + BT - 1) / BT, p.H, p.B);
  flash_bwd_dq_kernel<T, DMAX, BT><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int DMAX, int BT>
cudaError_t launch_dkv(const Params& p, cudaStream_t stream) {
  const size_t smem = dkv_smem_bytes(BT, p.D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, DMAX, BT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Tk + BT - 1) / BT, p.Hkv, p.B);
  flash_bwd_dkv_kernel<T, DMAX, BT><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

// Head-dim bins: 64 x 64 tiles up to D = 128, 32 x 32 above (shared memory).
template <typename T>
cudaError_t dispatch(const Params& p, bool dkv, cudaStream_t stream) {
  if (p.D <= 64)
    return dkv ? launch_dkv<T, 64, 64>(p, stream)
               : launch_dq<T, 64, 64>(p, stream);
  if (p.D <= 128)
    return dkv ? launch_dkv<T, 128, 64>(p, stream)
               : launch_dq<T, 128, 64>(p, stream);
  return dkv ? launch_dkv<T, 256, 32>(p, stream)
             : launch_dq<T, 256, 32>(p, stream);
}

int run(const Params& p, int dtype, bool dkv, void* stream) {
  if (p.D < 1 || p.D > 256 || p.Hkv < 1 || p.H % p.Hkv != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch<float>(p, dkv, st);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16>(p, dkv, st);
  else if (dtype == 2)
    err = dispatch<__half>(p, dkv, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. Each returns
// cudaGetLastError() after its launch (0 = launched). The caller validates
// shapes, D <= 256 and H % Hkv == 0, computes delta, and allocates the
// outputs contiguous.
extern "C" int hvt_flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* qseg, const void* kseg,
    void* dq, int B, int Tq, int Tk, int H, int Hkv, int D, long long q_sb,
    long long q_st, long long q_sh, long long k_sb, long long k_st,
    long long k_sh, long long v_sb, long long v_st, long long v_sh,
    long long o_sb, long long o_st, long long o_sh, int causal, int window,
    int sinks, int offset, float scale, int dtype, void* stream) {
  Params p{q,    k,    v,    dout, static_cast<const float*>(lse),
           static_cast<const float*>(delta), static_cast<const int*>(qseg),
           static_cast<const int*>(kseg), dq, nullptr, nullptr,
           B,    Tq,   Tk,   H,    Hkv,  D,
           q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh,
           o_sb, o_st, o_sh, causal, window, sinks, offset, scale};
  return run(p, dtype, false, stream);
}

extern "C" int hvt_flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* qseg, const void* kseg,
    void* dk, void* dv, int B, int Tq, int Tk, int H, int Hkv, int D,
    long long q_sb, long long q_st, long long q_sh, long long k_sb,
    long long k_st, long long k_sh, long long v_sb, long long v_st,
    long long v_sh, long long o_sb, long long o_st, long long o_sh,
    int causal, int window, int sinks, int offset, float scale, int dtype,
    void* stream) {
  Params p{q,    k,    v,    dout, static_cast<const float*>(lse),
           static_cast<const float*>(delta), static_cast<const int*>(qseg),
           static_cast<const int*>(kseg), nullptr, dk, dv,
           B,    Tq,   Tk,   H,    Hkv,  D,
           q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh,
           o_sb, o_st, o_sh, causal, window, sinks, offset, scale};
  return run(p, dtype, true, stream);
}
