// Fused multi-head self-attention for head dim D = 32, Hopper (sm_90a).
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
// 1728 of 2592 keys): H*L*sum(kept) = 71.7 M exponentials (18.5 us at the
// special-function rate of 132 SMs x 16 per clock), 4*D times that = 9.2
// GFLOP (9.3 us at 989 TFLOP/s bf16), Q/K/V/O only 10.6 MB (3.2 us at 3.35
// TB/s). The exponentials bound it, so the bf16 kernel keeps S and P in
// registers and issues no exponential the function does not need:
//   * one CTA = one consumer warpgroup of 64 query rows (warps 0-3, so
//     `wgmma` runs on a warpgroup-aligned group) and one producer warp
//     (warp 4); no setmaxnreg. Three CTAs share an SM (124 registers): fewer
//     ran slower, four no faster, and two warpgroups per CTA (half the K/V
//     traffic) or CTA pairs multicasting K/V were slower too
//     (scripts/k1_check.py, PERF.md);
//   * the producer warp loads K/V tiles of 64 keys into a 4-stage ring with
//     TMA (4-D tensor maps over the public (B, L, H, D) layout: no transpose,
//     no pad; the ragged last tile is zero-filled), signalled through full /
//     empty mbarriers; Q is loaded once, at entry;
//   * S = Q K^T: two wgmma.m64n64k16 per tile, Q and K K-major in shared
//     memory with the 64-byte swizzle (a token's head is 64 bytes);
//   * softmax in the accumulator layout: a thread holds 16 columns of two
//     rows; a row's max comes from two quad shuffles, its sum stays a
//     per-thread partial until the end. Logits are scaled by
//     sm_scale*log2(e) and exponentiated with ex2.approx; masked keys and
//     keys past L get -1e30*log2(e) (finite, exp -> 0);
//   * O += P V: P converted to bf16 in place is the register A operand of
//     four wgmma.m64n32k16, V the MN-major (transposed) B operand in shared
//     memory. S, P and O never pass through shared memory;
//   * overlap inside the warpgroup: the next tile's S and this tile's P V
//     are issued back to back; the next softmax runs while P V is in flight
//     (P double-buffered). Every wait sees a fixed number of pending groups
//     and no in-flight register is touched, so ptxas keeps wgmma async;
//   * masked-tile skip: each CTA scans its batch entry's keep mask once
//     (L bytes, one round trip) into per-tile 64-bit keep words and a list of
//     the tiles holding a kept key; only those are loaded and computed.
//     Exact: a masked key contributes exp(-1e30 - m) = 0 to a row that has a
//     kept key. An entry with no kept key takes every real key with one logit
//     (0): the mean of V.
// What holds it at ~2.3x its bound (PERF.md): each warp's tile is a chain
// (wait for S, softmax, wait for P V) that three CTAs per SM hide only in
// part; no unit is saturated (L2 ~3.5 TB/s, exps ~half their rate).
// float32 (not on the tracker's main path): scalar FMA, one thread per query
// row, K/V tiles through shared memory, to keep float32 accuracy.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched from the driver
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;          // queries per CTA (f32) / per warpgroup (bf16)
constexpr int kBK = 64;          // keys per tile
constexpr float kMaskBias = -1e30f;

// ---------------------------------------------------------------------------
// bf16: warp-specialised wgmma + TMA kernel
// ---------------------------------------------------------------------------

constexpr int kD = 32;                         // the one head dim it is built for
constexpr int kConsumerWGs = 1;                // 64-query warpgroups per CTA
constexpr int kBlocksPerSM = 3;                // register budget: 65536 / (3 * 160)
constexpr int kThreads = (kConsumerWGs * 4 + 1) * 32;
constexpr int kStages = 4;                     // K/V ring depth
constexpr int kTileBytes = kBK * kD * 2;       // one 64-row tile of one head
constexpr int kMaxLenBf16 = 65536;             // keeps the per-tile tables small
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMaskedLogit2 = kMaskBias * kLog2e;

struct alignas(1024) SharedBf16 {
  __nv_bfloat16 q[kConsumerWGs][kBQ * kD];     // tiles 1024-aligned: the swizzle
  __nv_bfloat16 k[kStages][kBK * kD];          // pattern repeats every 512 B
  __nv_bfloat16 v[kStages][kBK * kD];
  uint64_t full[kStages];
  uint64_t empty[kStages];
  uint64_t q_full[kConsumerWGs];
  int n_live;
  int uniform;
  // followed by uint64_t keep_bits[n_tiles], uint16_t live[n_tiles]
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// Waits for the completion of the barrier's phase of the given parity.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of the 4-D map (D, H, L, B) at (0, h, row, b) into shared memory.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int h, int row, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(0), "r"(h), "r"(row),
      "r"(b)
      : "memory");
}

// wgmma shared-memory descriptor of a tile of 64-byte rows stored with the
// 64-byte swizzle (as TMA's CU_TENSOR_MAP_SWIZZLE_64B writes it): start
// address >> 4 in bits 0-13, 8-row groups 512 B apart (SBO, bits 32-45),
// layout type 2 (64B swizzle) in bits 62-63. LBO (bits 16-29) is unused by
// these tiles (one swizzle atom wide) and set to the same 512 B. Advancing
// the start address by 32 B steps K by 16 elements in a K-major tile; by
// 1024 B steps it by 16 rows in an MN-major one.
__device__ __forceinline__ uint64_t desc_sw64(const void* tile) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(512 >> 4) << 16) | (uint64_t(512 >> 4) << 32) |
         (uint64_t(2) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Waits until at most N committed wgmma groups of the warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across the fence/wait instructions.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (64x64 f32) = [d if accumulate] + A (64x16, K-major smem) * B (64x16, K-major smem)^T
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a,
                                                   uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %34, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64x32 f32) += A (64x16 bf16, registers) * B (16x32, MN-major smem: trans-b)
__device__ __forceinline__ void wgmma_m64n32k16_rs(float (&d)[16], const uint32_t (&a)[4],
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %21, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Accumulator layout of wgmma m64nN (f32), per thread of a warpgroup: warp w
// owns rows 16w..16w+15; with g = lane / 4 and c = lane % 4, element i is at
// row 16w + g + 8 * ((i / 2) % 2), column 8 * (i / 4) + 2 * c + i % 2. The
// register A operand of m64nNk16 has the same order, so S's columns
// 16kk..16kk+15 (elements 8kk..8kk+7) are, packed in pairs, the A fragment of
// the kk-th k-step of P V.

// S (64 x 64) = Q K^T for one key tile: D = 32 in two k-steps of 16, each
// 32 bytes further into the swizzled rows. Issued and committed, not awaited.
__device__ __forceinline__ void issue_qk(float (&s)[32], uint64_t dq, uint64_t dk) {
  reg_fence(s);
  wgmma_fence();
  wgmma_m64n64k16_ss(s, dq, dk, 0);
  wgmma_m64n64k16_ss(s, dq + (32 >> 4), dk + (32 >> 4), 1);
  wgmma_commit();
}

struct RowState {                  // rows g and g + 8 of the thread's warp
  float m0 = -INFINITY, m1 = -INFINITY;  // running max, log2 domain
  float l0 = 0.f, l1 = 0.f;              // this thread's part of the row sums
};

// Online softmax of one tile's S (in place) into P, packed in bf16 pairs as
// the register A operand of the four P V k-steps. Logits go to the log2
// domain (scale = sm_scale * log2(e)); masked keys and keys past L get
// kMaskedLogit2. Returns in alpha0/alpha1 the factors by which O of rows g
// and g + 8 must be rescaled.
__device__ __forceinline__ void softmax_tile(float (&s)[32], uint64_t word, float scale,
                                             int quad, RowState& rows, uint32_t (&p)[16],
                                             float& alpha0, float& alpha1) {
  if (word == ~0ull) {
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] *= scale;
  } else {
    const uint64_t mine = word >> (2 * quad);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const bool kept = (mine >> (8 * (e / 4) + (e % 2))) & 1ull;
      s[e] = kept ? s[e] * scale : kMaskedLogit2;
    }
  }

  float mx0 = rows.m0, mx1 = rows.m1;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  // finite: every live tile holds a kept key (or, uniform, a real one)
  alpha0 = ex2(rows.m0 - mx0);
  alpha1 = ex2(rows.m1 - mx1);
  rows.m0 = mx0;
  rows.m1 = mx1;

  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    s[4 * j] = ex2(s[4 * j] - mx0);
    s[4 * j + 1] = ex2(s[4 * j + 1] - mx0);
    s[4 * j + 2] = ex2(s[4 * j + 2] - mx1);
    s[4 * j + 3] = ex2(s[4 * j + 3] - mx1);
    ps0 += s[4 * j] + s[4 * j + 1];
    ps1 += s[4 * j + 2] + s[4 * j + 3];
  }
  rows.l0 = rows.l0 * alpha0 + ps0;
  rows.l1 = rows.l1 * alpha1 + ps1;
#pragma unroll
  for (int r = 0; r < 16; ++r) p[r] = pack_bf16(s[2 * r], s[2 * r + 1]);
}

// One step of a consumer warpgroup for the i-th live tile, whose P is in `p`
// and whose rescale O has had. With kNext (a next tile exists): issue the
// next tile's S = Q K^T and this tile's O += P V (V MN-major, 16 keys per
// k-step) back to back; once S is in, run the next tile's softmax into
// `p_next` while P V is in flight. Then wait for P V, hand the stage back to
// the producer and rescale O for the next tile. No register of an in-flight
// wgmma is read or written meanwhile, and the groups pending at each wait
// are fixed by the template arguments, so ptxas keeps the wgmmas async.
template <bool kNext>
__device__ __forceinline__ void consume_tile(SharedBf16& sm, const uint64_t* keep_bits,
                                             const uint16_t* live, int i, int n_live,
                                             uint64_t dq, float scale, int quad, int lane,
                                             float (&s)[32], float (&o)[16], uint32_t (&p)[16],
                                             uint32_t (&p_next)[16], RowState& rows) {
  const int st = i % kStages;
  if (kNext) {
    const int st1 = (i + 1) % kStages;
    mbar_wait(&sm.full[st1], ((i + 1) / kStages) & 1);
    issue_qk(s, dq, desc_sw64(sm.k[st1]));
  }
  const uint64_t dv = desc_sw64(sm.v[st]);
  reg_fence(o);
  reg_fence(p);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
    wgmma_m64n32k16_rs(o, a, dv + ((kk * 16 * 64) >> 4));
  }
  wgmma_commit();

  float alpha0 = 1.f, alpha1 = 1.f;
  if (kNext) {
    wgmma_wait<1>();  // S of the next tile is in; P V may still run
    reg_fence(s);
    softmax_tile(s, keep_bits[live[i + 1]], scale, quad, rows, p_next, alpha0, alpha1);
  }
  wgmma_wait<0>();
  reg_fence(o);
  __syncwarp();
  if (lane == 0 && i + kStages < n_live) mbar_arrive(&sm.empty[st]);  // no load awaits the last
  if (kNext) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      o[4 * j] *= alpha0;
      o[4 * j + 1] *= alpha0;
      o[4 * j + 2] *= alpha1;
      o[4 * j + 3] *= alpha1;
    }
  }
}

// scale_log2 = sm_scale * log2(e).
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
mha_fwd_bf16_sm90(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v, const uint8_t* __restrict__ keep,
                  __nv_bfloat16* __restrict__ out, int L, int H, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  SharedBf16& sm = *reinterpret_cast<SharedBf16*>(
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u));
  const int n_tiles = (L + kBK - 1) / kBK;
  uint64_t* keep_bits = reinterpret_cast<uint64_t*>(&sm + 1);
  uint16_t* live = reinterpret_cast<uint16_t*>(keep_bits + n_tiles);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int q0 = blockIdx.x * (kConsumerWGs * kBQ);

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kConsumerWGs * 4);  // one arrival per consumer warp
    }
#pragma unroll
    for (int w = 0; w < kConsumerWGs; ++w) mbar_init(&sm.q_full[w], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
#pragma unroll
    for (int w = 0; w < kConsumerWGs; ++w) {  // Q needs no tile list: load it now
      mbar_expect_tx(&sm.q_full[w], kTileBytes);
      tma_load(sm.q[w], &tm_q, &sm.q_full[w], h, q0 + w * kBQ, b);
    }
  }

  // Keep words: bit j of keep_bits[t] is set when key t*64+j is < L and kept.
  // A thread reads two 16-key pieces (all 32 byte loads issued together: one
  // round trip up to L = 32 * kThreads); the four pieces of a tile sit on
  // four neighbouring lanes.
  for (int c0 = 0; c0 < n_tiles * 4; c0 += 2 * kThreads) {
    uint32_t bits[2] = {0u, 0u};
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int c = c0 + u * kThreads + tid;
      if (c < n_tiles * 4) {
        const uint8_t* row = keep + (size_t)b * L;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int key = c * 16 + j;
          const bool kept = key < L && (keep == nullptr || row[key] != 0);
          bits[u] |= uint32_t(kept) << j;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int c = c0 + u * kThreads + tid;
      unsigned long long word = (unsigned long long)bits[u] << (16 * (lane & 3));
      word |= __shfl_xor_sync(0xffffffffu, word, 1);
      word |= __shfl_xor_sync(0xffffffffu, word, 2);
      if ((lane & 3) == 0 && c < n_tiles * 4) keep_bits[c / 4] = word;
    }
  }
  __syncthreads();
  if (warp == 0) {  // the list of live tiles, in key order
    int n = 0;
    for (int t0 = 0; t0 < n_tiles; t0 += 32) {
      const int t = t0 + lane;
      const bool is_live = t < n_tiles && keep_bits[t] != 0;
      const uint32_t ballot = __ballot_sync(0xffffffffu, is_live);
      if (is_live) live[n + __popc(ballot & ((1u << lane) - 1u))] = (uint16_t)t;
      n += __popc(ballot);
    }
    const bool uniform = n == 0;
    if (uniform) {  // no kept key: every real key, one logit -> mean of V
      for (int t = lane; t < n_tiles; t += 32) {
        const int rem = L - t * kBK;
        keep_bits[t] = rem >= kBK ? ~0ull : (1ull << rem) - 1ull;
        live[t] = (uint16_t)t;
      }
      n = n_tiles;
    }
    if (lane == 0) {
      sm.n_live = n;
      sm.uniform = uniform;
    }
  }
  __syncthreads();
  const int n_live = sm.n_live;

  if (warp == kConsumerWGs * 4) {
    // ---- producer warp: one lane issues the K/V loads of the live tiles ----
    if (lane == 0) {
      for (int i = 0; i < n_live; ++i) {
        const int st = i % kStages;
        if (i >= kStages) mbar_wait(&sm.empty[st], (i / kStages - 1) & 1);
        mbar_expect_tx(&sm.full[st], 2 * kTileBytes);
        const int key0 = live[i] * kBK;
        tma_load(sm.k[st], &tm_k, &sm.full[st], h, key0, b);
        tma_load(sm.v[st], &tm_v, &sm.full[st], h, key0, b);
      }
    }
  } else {
    // ---- consumer warpgroup: 64 query rows ----
    const int wg = warp / 4;
    const int g = lane / 4;
    const int quad = lane % 4;
    const float scale = sm.uniform ? 0.f : scale_log2;
    float s[32];              // S of the next tile, then its softmax
    float o[16];
    uint32_t pa[16], pb[16];  // P of this tile (in P V) and of the next
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) o[i] = 0.f;
    RowState rows;

    const uint64_t dq = desc_sw64(sm.q[wg]);
    mbar_wait(&sm.q_full[wg], 0);
    mbar_wait(&sm.full[0], 0);
    issue_qk(s, dq, desc_sw64(sm.k[0]));
    wgmma_wait<0>();
    reg_fence(s);
    float unused0, unused1;  // O is still 0
    softmax_tile(s, keep_bits[live[0]], scale, quad, rows, pa, unused0, unused1);
    int i = 0;
    for (; i + 2 < n_live; i += 2) {  // two steps per trip: P alternates pa, pb
      consume_tile<true>(sm, keep_bits, live, i, n_live, dq, scale, quad, lane, s, o,
                                  pa, pb, rows);
      consume_tile<true>(sm, keep_bits, live, i + 1, n_live, dq, scale, quad, lane, s,
                                  o, pb, pa, rows);
    }
    if (i + 1 < n_live) {
      consume_tile<true>(sm, keep_bits, live, i, n_live, dq, scale, quad, lane, s, o,
                                  pa, pb, rows);
      consume_tile<false>(sm, keep_bits, live, i + 1, n_live, dq, scale, quad, lane, s,
                                   o, pb, pa, rows);
    } else {
      consume_tile<false>(sm, keep_bits, live, i, n_live, dq, scale, quad, lane, s, o,
                                   pa, pb, rows);
    }

    // epilogue: finish the row sums across the quad, normalise, store bf16 pairs
    float l0 = rows.l0, l1 = rows.l1;
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = 1.f / l0;
    const float inv1 = 1.f / l1;
    const int row0 = q0 + wg * kBQ + (warp % 4) * 16 + g;
    const int row1 = row0 + 8;
    const size_t token_stride = (size_t)H * kD;
    __nv_bfloat16* head = out + (size_t)b * L * token_stride + (size_t)h * kD;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = 8 * j + 2 * quad;
      if (row0 < L)
        *reinterpret_cast<__nv_bfloat162*>(head + (size_t)row0 * token_stride + col) =
            __floats2bfloat162_rn(o[4 * j] * inv0, o[4 * j + 1] * inv0);
      if (row1 < L)
        *reinterpret_cast<__nv_bfloat162*>(head + (size_t)row1 * token_stride + col) =
            __floats2bfloat162_rn(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
  }
}

// cuTensorMapEncodeTiled, fetched from the driver through the runtime, so the
// library links no libcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// 4-D map over a contiguous (B, L, H, 32) bf16 tensor, innermost first; one
// box is 64 consecutive tokens of one head (64 rows of 64 bytes), 64B swizzle.
bool encode_head_map(EncodeTiledFn fn, CUtensorMap* map, const void* ptr, int B, int L, int H) {
  const cuuint64_t dims[4] = {(cuuint64_t)kD, (cuuint64_t)H, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)kD * 2, (cuuint64_t)H * kD * 2,
                                 (cuuint64_t)L * H * kD * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kD, 1, (cuuint32_t)kBK, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
            box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

size_t bf16_smem_bytes(int L) {
  const size_t n_tiles = (L + kBK - 1) / kBK;
  return 1024 + sizeof(SharedBf16) + n_tiles * (sizeof(uint64_t) + sizeof(uint16_t));
}

cudaError_t launch_bf16(const void* q, const void* k, const void* v, const uint8_t* keep,
                        void* out, int B, int L, int H, float sm_scale, cudaStream_t stream) {
  if (L > kMaxLenBf16) return cudaErrorInvalidValue;
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!encode_head_map(fn, &tm_q, q, B, L, H) || !encode_head_map(fn, &tm_k, k, B, L, H) ||
      !encode_head_map(fn, &tm_v, v, B, L, H))
    return cudaErrorInvalidValue;
  const size_t smem = bf16_smem_bytes(L);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mha_fwd_bf16_sm90, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((L + kConsumerWGs * kBQ - 1) / (kConsumerWGs * kBQ), B * H);
  mha_fwd_bf16_sm90<<<grid, kThreads, smem, stream>>>(tm_q, tm_k, tm_v, keep,
                                                      static_cast<__nv_bfloat16*>(out), L, H,
                                                      sm_scale * kLog2e);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32: scalar kernel
// ---------------------------------------------------------------------------

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

}  // namespace

// q, k, v, out: contiguous (B, L, H, D), 16-byte aligned; keep: (B, L) bytes
// (1 = attend) or null. dtype: 0 float32, 1 bfloat16 (L <= 65536). Returns the
// CUDA error code of the launch (0 on success). Launches on `stream`, does not
// synchronise.
extern "C" int fused_mha_fwd(const void* q, const void* k, const void* v, const void* keep,
                             void* out, int B, int L, int H, int D, int dtype,
                             float sm_scale, void* stream) {
  const uint8_t* keep8 = static_cast<const uint8_t*>(keep);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || L <= 0 || H <= 0 || B * H > 65535 || D != kD || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (dtype == 1) return (int)launch_bf16(q, k, v, keep8, out, B, L, H, sm_scale, s);
  const dim3 grid((L + kBQ - 1) / kBQ, B * H);
  mha_fwd_f32<kD><<<grid, kBQ, 0, s>>>(static_cast<const float*>(q),
                                       static_cast<const float*>(k),
                                       static_cast<const float*>(v), keep8,
                                       static_cast<float*>(out), L, H, sm_scale);
  return (int)cudaGetLastError();
}
