// Fused multi-head self-attention for head dim D = 32, Hopper.
//
// Replaces the Pallas TPU kernel `_mha_kernel` / `_mha_dt_layout` in
// pytracking_tpu/ops/pallas_mha.py (the only pl.pallas_call of the JAX
// package), which the TaMOs transformer encoder reaches at B=2, L=2592, H=8,
// D=32 in bf16 (one launch per encoder layer).
//
// What it computes, per (batch, head) and query row i:
//   s_ij = (q_i . k_j) * sm_scale + bias_j    bias_j = 0 kept, -1e30 masked
//   p_ij = softmax_j(s_ij)                    in float32
//   o_i  = sum_j p_ij v_j                     p cast to the input dtype,
//                                             products accumulated in float32
// Keys past the end of the sequence (the ragged last tile) are excluded
// exactly (p = 0); a row whose real keys are all masked gets the mean of V
// over the L real keys, as the XLA attention of the JAX package gives.
//
// What bounds it on an H100 at the TaMOs shape, counted over the keys the
// tracker keeps (one of the two memory slots is masked in both batch entries,
// 1728 of 2592 keys): H*L*sum(kept) = 71.7 M exponentials (~18.5 us at the
// special-function rate) and 4*D times that = 9.2 GFLOP (>= 9.3 us at 989
// TFLOP/s bf16), while Q/K/V/O are only 10.6 MB (3.2 us at 3.35 TB/s). It is
// bounded by the operations, not by memory, so the design keeps the (L, L)
// logits out of device memory and feeds the tensor cores:
//   * the TPU kernel kept one head's whole K and V resident (344 KB at the
//     TaMOs shape), more than the 227 KB a block may use. Here one CTA takes
//     one (batch*head, 64-query tile) and streams K/V through shared memory
//     in 64-key tiles, with an online softmax kept in float32 registers;
//   * bf16: each of the 4 warps owns 16 query rows; QK^T and PV run on the
//     tensor cores through nvcuda::wmma 16x16x16 with float32 accumulators;
//   * float32: scalar FMA, one thread per query row (the f32 path is not on
//     the tracker's main path and keeps float32 accuracy);
//   * tensors are read in the public (B, L, H, D) layout: a token's head is
//     D contiguous values, tokens are H*D apart. No transposes, no padding.
// wgmma/TMA pipelining is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;          // queries per CTA
constexpr int kBK = 64;          // keys per shared-memory tile
constexpr int kWarps = 4;        // bf16 kernel: 16 query rows per warp
constexpr float kMaskBias = -1e30f;

// Copy rows [row0, row0 + 64) of one head into a shared tile with row stride
// `ld` elements, zero-filling rows at or past L. 16-byte chunks.
template <int D, typename T>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* __restrict__ src,
                                          size_t token_stride, int row0, int L) {
  constexpr int kPerChunk = 16 / sizeof(T);
  constexpr int kChunks = D / kPerChunk;  // chunks per row
  for (int idx = threadIdx.x; idx < kBK * kChunks; idx += blockDim.x) {
    const int r = idx / kChunks;
    const int c = idx % kChunks;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < L) {
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * token_stride +
                                            c * kPerChunk);
    }
    *reinterpret_cast<uint4*>(dst + r * ld + c * kPerChunk) = val;
  }
}

// Additive key bias of one key tile: 0 kept, -1e30 masked, -inf past L.
__device__ __forceinline__ void load_bias(float* kbias, const uint8_t* __restrict__ keep,
                                          int b, int kt, int L) {
  for (int j = threadIdx.x; j < kBK; j += blockDim.x) {
    const int key = kt + j;
    float bias = -INFINITY;
    if (key < L) bias = (keep == nullptr || keep[(size_t)b * L + key]) ? 0.f : kMaskBias;
    kbias[j] = bias;
  }
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
mha_fwd_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ keep,
             __nv_bfloat16* __restrict__ out, int L, int H, float sm_scale) {
  using namespace nvcuda;
  constexpr int LDT = D + 8;    // bf16 Q/K/V tile row stride
  constexpr int LDS = kBK + 4;  // f32 logits row stride
  constexpr int LDP = kBK + 8;  // bf16 probability row stride
  constexpr int LDO = D + 4;    // f32 PV result row stride (reuses the logits buffer)
  constexpr int kHalf = D / 2;  // output columns per lane

  __shared__ __align__(32) __nv_bfloat16 qs[kBQ * LDT];
  __shared__ __align__(32) __nv_bfloat16 ks[kBK * LDT];
  __shared__ __align__(32) __nv_bfloat16 vs[kBK * LDT];
  __shared__ __align__(32) float ss[kWarps][16 * LDS];
  __shared__ __align__(32) __nv_bfloat16 ps[kWarps][16 * LDP];
  __shared__ float kbias[kBK];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * kBQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r = lane >> 1;     // this lane's row within the warp's 16
  const int half = lane & 1;   // which half of the columns it handles

  const size_t token_stride = (size_t)H * D;
  const size_t head_off = (size_t)b * L * token_stride + (size_t)h * D;

  load_tile<D>(qs, LDT, q + head_off, token_stride, q0, L);
  __syncthreads();

  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> qf[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wmma::load_matrix_sync(qf[kk], qs + warp * 16 * LDT + kk * 16, LDT);

  float o[kHalf];
#pragma unroll
  for (int d = 0; d < kHalf; ++d) o[d] = 0.f;
  float m = -INFINITY;
  float l = 0.f;

  float* sw = ss[warp];
  __nv_bfloat16* pw = ps[warp];

  for (int kt = 0; kt < L; kt += kBK) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D>(ks, LDT, k + head_off, token_stride, kt, L);
    load_tile<D>(vs, LDT, v + head_off, token_stride, kt, L);
    load_bias(kbias, keep, b, kt, L);
    __syncthreads();

    // S (16 x 64) = Q_w (16 x D) K^T (D x 64)
#pragma unroll
    for (int nb = 0; nb < kBK / 16; ++nb) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, ks + nb * 16 * LDT + kk * 16, LDT);
        wmma::mma_sync(acc, qf[kk], kf, acc);
      }
      wmma::store_matrix_sync(sw + nb * 16, acc, LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax: two lanes per row, 32 columns each
    float sv[kBK / 2];
    float mt = -INFINITY;
    const float* srow = sw + r * LDS + half * (kBK / 2);
#pragma unroll
    for (int c = 0; c < kBK / 2; ++c) {
      sv[c] = srow[c] * sm_scale + kbias[half * (kBK / 2) + c];
      mt = fmaxf(mt, sv[c]);
    }
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    const float m_new = fmaxf(m, mt);  // finite: every tile holds a key < L
    const float alpha = __expf(m - m_new);
    float ls = 0.f;
    __nv_bfloat16* prow = pw + r * LDP + half * (kBK / 2);
#pragma unroll
    for (int c = 0; c < kBK / 2; ++c) {
      const float p = __expf(sv[c] - m_new);
      ls += p;
      prow[c] = __float2bfloat16(p);
    }
    ls += __shfl_xor_sync(0xffffffffu, ls, 1);
    l = l * alpha + ls;
    m = m_new;
#pragma unroll
    for (int d = 0; d < kHalf; ++d) o[d] *= alpha;
    __syncwarp();  // P written, logits read: the logits buffer is free

    // PV (16 x D) = P (16 x 64) V (64 x D), into the logits buffer
#pragma unroll
    for (int nb = 0; nb < D / 16; ++nb) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> pf;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> vf;
        wmma::load_matrix_sync(pf, pw + kk * 16, LDP);
        wmma::load_matrix_sync(vf, vs + kk * 16 * LDT + nb * 16, LDT);
        wmma::mma_sync(acc, pf, vf, acc);
      }
      wmma::store_matrix_sync(sw + nb * 16, acc, LDO, wmma::mem_row_major);
    }
    __syncwarp();
    const float* orow = sw + r * LDO + half * kHalf;
#pragma unroll
    for (int d = 0; d < kHalf; ++d) o[d] += orow[d];
    __syncwarp();  // PV read before the next tile's logits overwrite it
  }

  const int row = q0 + warp * 16 + r;
  if (row < L) {
    const float inv = 1.f / l;
    __nv_bfloat16* dst = out + head_off + (size_t)row * token_stride + half * kHalf;
#pragma unroll
    for (int d = 0; d < kHalf; ++d) dst[d] = __float2bfloat16(o[d] * inv);
  }
}

template <int D>
__global__ void __launch_bounds__(kBQ)
mha_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const uint8_t* __restrict__ keep,
            float* __restrict__ out, int L, int H, float sm_scale) {
  __shared__ __align__(16) float ks[kBK * D];
  __shared__ __align__(16) float vs[kBK * D];
  __shared__ float kbias[kBK];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int row = blockIdx.x * kBQ + threadIdx.x;
  const size_t token_stride = (size_t)H * D;
  const size_t head_off = (size_t)b * L * token_stride + (size_t)h * D;

  float qr[D];
  float o[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = row < L ? q[head_off + (size_t)row * token_stride + d] : 0.f;
    o[d] = 0.f;
  }
  float m = -INFINITY;
  float l = 0.f;

  for (int kt = 0; kt < L; kt += kBK) {
    __syncthreads();
    load_tile<D>(ks, D, k + head_off, token_stride, kt, L);
    load_tile<D>(vs, D, v + head_off, token_stride, kt, L);
    load_bias(kbias, keep, b, kt, L);
    __syncthreads();

    float s[kBK];
    float mt = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) acc = fmaf(qr[d], ks[j * D + d], acc);
      s[j] = acc * sm_scale + kbias[j];
      mt = fmaxf(mt, s[j]);
    }
    const float m_new = fmaxf(m, mt);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int d = 0; d < D; ++d) o[d] *= alpha;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float p = expf(s[j] - m_new);
      l += p;
#pragma unroll
      for (int d = 0; d < D; ++d) o[d] = fmaf(p, vs[j * D + d], o[d]);
    }
    m = m_new;
  }

  if (row < L) {
    const float inv = 1.f / l;
    float* dst = out + head_off + (size_t)row * token_stride;
#pragma unroll
    for (int d = 0; d < D; ++d) dst[d] = o[d] * inv;
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const uint8_t* keep, void* out,
                   int B, int L, int H, int is_bf16, float sm_scale, cudaStream_t stream) {
  const dim3 grid((L + kBQ - 1) / kBQ, B * H);
  if (is_bf16) {
    mha_fwd_bf16<D><<<grid, kWarps * 32, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), keep, static_cast<__nv_bfloat16*>(out), L, H,
        sm_scale);
  } else {
    mha_fwd_f32<D><<<grid, kBQ, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), keep, static_cast<float*>(out), L, H, sm_scale);
  }
  return cudaGetLastError();
}

}  // namespace

// q, k, v, out: contiguous (B, L, H, D), 16-byte aligned; keep: (B, L) bytes
// (1 = attend) or null. dtype: 0 float32, 1 bfloat16. Returns the CUDA error
// code of the launch (0 on success). Launches on `stream`, does not synchronise.
extern "C" int fused_mha_fwd(const void* q, const void* k, const void* v, const void* keep,
                             void* out, int B, int L, int H, int D, int dtype,
                             float sm_scale, void* stream) {
  const uint8_t* keep8 = static_cast<const uint8_t*>(keep);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || L <= 0 || H <= 0 || B * H > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  switch (D) {
    case 32: return (int)launch<32>(q, k, v, keep8, out, B, L, H, dtype, sm_scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
