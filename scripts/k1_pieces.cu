// The pieces of K1's bf16 kernel on their own, built from the kernel's own
// helpers (TMA 4-D maps with the 64-byte swizzle, wgmma descriptors, the
// accumulator and register-A layouts): one warpgroup computes a 64x64 tile
// of Q K^T, or P V for a P given in float32, and writes it out in row-major
// order. scripts/k1_check.py builds it and compares both with torch.
#include "../pytracking_tpu_torch/csrc/fused_mha.cu"

namespace {
struct alignas(1024) PieceSmem {
  __nv_bfloat16 a[kBQ * kD];
  __nv_bfloat16 bt[kBK * kD];
  uint64_t bar;
};

__device__ PieceSmem& piece_smem(uint8_t* raw) {
  return *reinterpret_cast<PieceSmem*>(raw + ((1024u - (smem_u32(raw) & 1023u)) & 1023u));
}

__global__ void piece_qk(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk, float* S, int h, int b, int q0,
                       int k0) {
  extern __shared__ uint8_t raw[];
  PieceSmem& sm = piece_smem(raw);
  if (threadIdx.x == 0) {
    mbar_init(&sm.bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(&sm.bar, 2 * kTileBytes);
    tma_load(sm.a, &tq, &sm.bar, h, q0, b);
    tma_load(sm.bt, &tk, &sm.bar, h, k0, b);
  }
  mbar_wait(&sm.bar, 0);
  float s[32];
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  const uint64_t da = desc_sw64(sm.a), db = desc_sw64(sm.bt);
  reg_fence(s);
  wgmma_fence();
  wgmma_m64n64k16_ss(s, da, db, 0);
  wgmma_m64n64k16_ss(s, da + 2, db + 2, 1);
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(s);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, quad = lane % 4;
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int row = 16 * warp + g + 8 * ((e / 2) % 2);
    const int col = 8 * (e / 4) + 2 * quad + e % 2;
    S[row * 64 + col] = s[e];
  }
}

__global__ void piece_pv(const __grid_constant__ CUtensorMap tv, const float* P, float* O,
                       int h, int b, int k0) {
  extern __shared__ uint8_t raw[];
  PieceSmem& sm = piece_smem(raw);
  if (threadIdx.x == 0) {
    mbar_init(&sm.bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(&sm.bar, kTileBytes);
    tma_load(sm.bt, &tv, &sm.bar, h, k0, b);
  }
  mbar_wait(&sm.bar, 0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, quad = lane % 4;
  float s[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int row = 16 * warp + g + 8 * ((e / 2) % 2);
    const int col = 8 * (e / 4) + 2 * quad + e % 2;
    s[e] = P[row * 64 + col];
  }
  float o[16];
  for (int i = 0; i < 16; ++i) o[i] = 0.f;
  uint32_t pa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
    reg_fence(pa[kk]);
  }
  const uint64_t dv = desc_sw64(sm.bt);
  reg_fence(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_m64n32k16_rs(o, pa[kk], dv + ((kk * 16 * 64) >> 4));
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(o);
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    const int row = 16 * warp + g + 8 * ((e / 2) % 2);
    const int col = 8 * (e / 4) + 2 * quad + e % 2;
    O[row * 32 + col] = o[e];
  }
}
}  // namespace

extern "C" int piece_qk_run(const void* q, const void* k, float* S, int B, int L, int H, int h,
                          int b, int q0, int k0) {
  const EncodeTiledFn fn = encode_tiled();
  if (!fn) return -1;
  CUtensorMap tq, tk;
  if (!encode_head_map(fn, &tq, q, B, L, H) || !encode_head_map(fn, &tk, k, B, L, H)) return -2;
  piece_qk<<<1, 128, sizeof(PieceSmem) + 1024>>>(tq, tk, S, h, b, q0, k0);
  cudaError_t e = cudaGetLastError();
  if (e) return (int)e;
  return (int)cudaDeviceSynchronize();
}

extern "C" int piece_pv_run(const void* v, const float* P, float* O, int B, int L, int H, int h,
                          int b, int k0) {
  const EncodeTiledFn fn = encode_tiled();
  if (!fn) return -1;
  CUtensorMap tv;
  if (!encode_head_map(fn, &tv, v, B, L, H)) return -2;
  piece_pv<<<1, 128, sizeof(PieceSmem) + 1024>>>(tv, P, O, h, b, k0);
  cudaError_t e = cudaGetLastError();
  if (e) return (int)e;
  return (int)cudaDeviceSynchronize();
}
