// Flash attention forward for Hopper (sm_90a): softmax(q k^T / sqrt(Dh) + mask) v
// with an online softmax, so the [L, L] score matrix is never stored.
//
// Replaces the Pallas TPU kernel sparkdl_tpu/ops/flash_attention.py
// (`_flash_kernel`, launched by `flash_attention` through pl.pallas_call).
// Same semantics:
//   - scale = 1/sqrt(Dh) of the true Dh (passed in by the wrapper);
//   - the running max starts at NEG_INF = -1e30, so a key masked with
//     finfo(float32).min never becomes the running max; a row whose keys
//     are all masked keeps l = 0 and comes out as 0 / max(0, 1e-30) = 0.
//     Scores are kept in log2 units (times log2(e)) for exp2; finfo.min
//     times log2(e) overflows to -inf there, which is harmless because the
//     running max starts finite (-1e30 * log2(e)) and exp2(-inf) = 0;
//   - keys beyond L contribute nothing (their scores are -inf here; the TPU
//     kernel padded them with NEG_INF);
//   - scores, running max/sum and the accumulator are f32; the output is
//     in the input's type (f32 or bf16).
//
// Layout: q, k, v, out are contiguous [B, H, L, Dh]; mask is an additive
// f32 key mask [B, L] (0 keeps a key, a large negative value drops it),
// or null for none.
//
// What bounds it on an H100 SXM: at bert-base (B=32, H=12, L=512, Dh=64)
// the two products are 4*B*H*L*L*Dh = 25.8 GFLOP. In bf16 q/k/v/o move
// 101 MB (0.030 ms at 3.35 TB/s) against 0.026 ms at 989 TFLOP/s: bound by
// bytes, and only reachable on the tensor cores. In f32 the bytes take
// 0.060 ms; run as 3xTF32 the products are 77 GFLOP of TF32 work, 0.156 ms
// at 494.7 TFLOP/s: bound by operations.
//
// Design. In both kernels a warpgroup (128 threads, 4 warps) owns 64
// query rows of one (b, h); warp w owns rows 16w..16w+15. A loop inside
// the block walks the head's K/V tiles of 64 keys (it takes the place of
// the TPU kernel's sequential `ki` grid axis); K/V tiles sit in a ring of
// shared-memory stages, so the next tiles' copies overlap this tile's
// arithmetic. Per tile: S = Q K^T on the tensor cores into f32 registers;
// the online softmax in registers (each row is shared by the 4 threads of
// a quad, reduced by shuffles; exp2 on ex2.approx); O += P V on the tensor
// cores. Both products leave S and O in the same register layout (row g /
// g+8 of the warp's 16, columns 8n + 2t, 8n + 2t + 1), so the softmax and
// the epilogue are one piece of code.
//
//   bf16: wgmma fed by TMA. A block holds two warpgroups (128 query rows)
//     that share each K/V tile, which halves the K/V traffic from L2.
//     Q (once) and each K/V tile come in through
//     cp.async.bulk.tensor over 3-D tensor maps [B*H, L, Dh]: rows past L
//     come back zero-filled and never read the next head. 128-byte
//     swizzle for Dh = 64 (128-byte rows), 64-byte for Dh = 32. Thread 0
//     issues the copies into a ring of 3 stages; each stage signals an
//     mbarrier. Each thread reads its Q fragments once from the swizzled
//     tile into registers, so S is a wgmma m64n64k16 with A = Q from
//     registers and B = K (K-major) from shared memory: only K is read
//     from shared memory per product. O: P is rounded to bf16 in registers
//     and is wgmma's register A operand; V is an MN-major B operand from
//     shared memory (the transpose bit). The dense build rounds P to its
//     working type the same way (models/bert.py, `probs.to(dtype)`), as
//     the TPU's MXU did at default precision; the plain version keeps P in
//     f32, and the bf16 tolerance (3e-2) covers the difference;
//     flash_attention_reference(..., p_dtype=torch.bfloat16) rounds P the
//     same way, and the card tests hold this kernel to it more closely.
//     The loop is software-pipelined by one tile (S_j and P_{j-1} V_{j-1}
//     are issued together; the softmax of tile j runs while P_{j-1} V_{j-1}
//     does): against a plain loop per tile it takes 9 % less device time
//     at bert-long (L=2048, Dh=32) and 3-5 % less at bert-base lengths on
//     an H100 (PERF.md).
//     The mask of each tile is staged once per block in shared memory in
//     log2 units (-inf past L), two tiles ahead, by one warp.
//   f32: 3xTF32 with mma.sync m16n8k8, one warpgroup per block (its
//     registers leave no room for a second). Each operand x is split into
//     a TF32 high part hi = rna(x) and a TF32 residual lo = rna(x - hi),
//     and each product is lo*hi + hi*lo + hi*hi, which keeps f32 accuracy
//     (kernel against plain at atol 1e-4). K/V tiles arrive by cp.async
//     (16-byte copies, zero-fill past L) into 2 stages of rows padded to
//     Dh + 4 floats, which makes the fragment loads free of bank
//     conflicts. P stays f32
//     and is split like the other operands; its accumulator layout is used
//     as the A fragment directly by reading the keys of V in the matching
//     order (A column t <-> key 2t, t + 4 <-> key 2t + 1), so no shuffles.
//     wgmma is not used here: TF32 wgmma takes no transposed B, so V would
//     have to be transposed in shared memory for P V.
//
// What the bytes bound leaves out: at Dh = 64 the exponentials are as
// much work as the bf16 products. At bert-base L=512, B*H*L*L = 100.7M
// exp2 at 16 a cycle per SM take about 0.027 ms, as long as the products
// at the tensor cores' peak. Times on the card are in PERF.md.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // one warpgroup: 4 warps x 16 query rows
constexpr int kBlockQ = 64;    // query rows per warpgroup
constexpr int kBlockK = 64;    // keys per K/V tile
constexpr int kStages = 2;     // K/V tiles in flight (f32)
constexpr int kBf16Groups = 2;  // warpgroups per bf16 block, sharing each K/V tile
constexpr int kBf16Stages = 3;  // K/V tiles in flight (bf16)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegInfLog2 = -1e30f * kLog2e;  // NEG_INF in log2 units

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Keeps the compiler from moving reads of x above an asynchronous
// instruction's wait (x is an operand or accumulator of wgmma).
__device__ __forceinline__ void fence_operand(float& x) {
  asm volatile("" : "+f"(x)::"memory");
}
__device__ __forceinline__ void fence_operand(uint32_t& x) {
  asm volatile("" : "+r"(x)::"memory");
}

// ---------------------------------------------------------------------------
// The online softmax and the epilogue, shared by both kernels.
//
// s[32] holds this thread's scores of one 64-key tile: s[4n + e] is row
// g + 8 * (e >> 1) of the warp's 16 rows, key 8n + 2t + (e & 1), where
// g = lane / 4 and t = lane % 4. On return s holds P = exp2(x - m_new)
// and alpha[r] the factor by which the accumulator's row r must shrink.

__device__ __forceinline__ float fast_exp2(float x) {
  float y;  // exp2(-inf) = +0
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The additive mask of key `key`, in log2 units; a key past L gets -inf,
// so exp2() gives it exactly 0 weight (finfo.min * log2(e) is -inf too).
__device__ __forceinline__ float mask_log2(const float* __restrict__ mask_row, int key, int L) {
  return key >= L ? -INFINITY : (mask_row != nullptr ? __ldg(mask_row + key) * kLog2e : 0.f);
}

// The mask of this thread's 16 keys of the tile at k0: mv[2n + c] is key
// 8n + 2t + c. Loaded before the tile's scores are waited for.
__device__ __forceinline__ void load_mask(float (&mv)[16], const float* __restrict__ mask_row,
                                          int k0, int L, int t) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int key = k0 + 8 * (i >> 1) + 2 * t + (i & 1);
    mv[i] = mask_log2(mask_row, key, L);
  }
}

// scale_log2 = scale * log2(e) and mv in log2 units: one FFMA per score.
__device__ __forceinline__ void online_softmax(float (&s)[32], float (&m)[2],
                                               float (&l)[2], float (&alpha)[2],
                                               const float (&mv)[16], float scale_log2) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s[i] = fmaf(s[i], scale_log2, mv[2 * (i >> 2) + (i & 1)]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = m[r];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      mx = fmaxf(mx, fmaxf(s[4 * n + 2 * r], s[4 * n + 2 * r + 1]));
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    alpha[r] = fast_exp2(m[r] - mx);
    float sum = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float& x = s[4 * n + 2 * r + c];
        x = fast_exp2(x - mx);
        sum += x;
      }
    }
    // l stays a per-thread partial sum; the quad's partials are added in
    // the epilogue (alpha is the same for the 4 threads of a row)
    l[r] = l[r] * alpha[r] + sum;
    m[r] = mx;
  }
}

template <int NO>
__device__ __forceinline__ void rescale(float (&o)[NO], const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] *= alpha[(i >> 1) & 1];
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// o[4n + e]: row g + 8 * (e >> 1), column 8n + 2t + (e & 1). Rows at or
// past L are not written.
template <int DH, typename T>
__device__ __forceinline__ void write_out(const float (&o)[DH / 2], float (&l)[2],
                                          T* __restrict__ out_bh, int row0,
                                          int L, int g, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float denom = fmaxf(l[r], 1e-30f);
    const int row = row0 + g + 8 * r;
    if (row < L) {
      T* dst = out_bh + static_cast<size_t>(row) * DH + 2 * t;
#pragma unroll
      for (int n = 0; n < DH / 8; ++n) {
        store2(dst + 8 * n, o[4 * n + 2 * r] / denom, o[4 * n + 2 * r + 1] / denom);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: mbarrier, TMA and wgmma, as inline PTX.

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Spins until the barrier's phase with the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One box [1, 64, Dh] at (row, bh) of a 3-D map [B*H, L, Dh] into shared
// memory; completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int row,
                                         int bh, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(row), "r"(bh), "r"(bar)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (given in bytes, encoded in 16-byte units) and the swizzle
// mode (1 = 128 B, 2 = 64 B).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// waits until at most N committed groups are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

#define SDL_F8(d, i)                                                              \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),     \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64 x 64] (+)= A[64 x 16] B[16 x 64]; A in registers, B K-major in
// shared memory.
__device__ __forceinline__ void wgmma_rs_kmajor_n64(float (&d)[32], const uint32_t* a,
                                                    uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : SDL_F8(d, 0), SDL_F8(d, 8), SDL_F8(d, 16), SDL_F8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate)
      : "memory");
}

// d[64 x 64] += A[64 x 16] B[16 x 64]; A in registers, B MN-major in
// shared memory (transpose bit set).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
      "}\n"
      : SDL_F8(d, 0), SDL_F8(d, 8), SDL_F8(d, 16), SDL_F8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db)
      : "memory");
}

// d[64 x 32] += A[64 x 16] B[16 x 32]; as above.
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, 1, 1, 1, 1;\n"
      "}\n"
      : SDL_F8(d, 0), SDL_F8(d, 8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db)
      : "memory");
}

#undef SDL_F8

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int DH>
struct Bf16Tiles {
  static constexpr int kRowBytes = DH * 2;                // 128 or 64
  static constexpr int kTileBytes = kBlockK * kRowBytes;  // Q, K or V tile
  static constexpr uint32_t kGroupBytes = 8 * kRowBytes;  // 8 rows: one swizzle atom
  static constexpr uint64_t kLayout = DH == 64 ? 1 : 2;   // 128 B / 64 B swizzle
  // a Q tile per warpgroup, then K and V of each stage, then
  // 1 + kBf16Stages mbarriers (64 bytes), then each stage's 64 mask
  // values; 1 KB of slack to align the base to the 1024-byte swizzle
  // period
  static constexpr int kSmemBytes =
      (kBf16Groups + 2 * kBf16Stages) * kTileBytes + 64 + kBf16Stages * kBlockK * 4 + 1024;
};

// Two warpgroups, each with its own 64 query rows, share every K/V tile.
// The loop is software-pipelined by one tile: S_j = Q K_j^T and
// O += P_{j-1} V_{j-1} are issued together, and the softmax of tile j runs
// on the CUDA cores while the tensor cores work on P_{j-1} V_{j-1}.
template <int DH>
__global__ void __launch_bounds__(kBf16Groups * kThreads, 2)
flash_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const float* __restrict__ mask, __nv_bfloat16* __restrict__ out,
                        int H, int L, float scale) {
  using C = Bf16Tiles<DH>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_q = base + (kBf16Groups + 2 * kBf16Stages) * C::kTileBytes;
  auto sK = [&](int st) { return base + (kBf16Groups + 2 * st) * C::kTileBytes; };
  auto sV = [&](int st) { return base + (kBf16Groups + 1 + 2 * st) * C::kTileBytes; };
  auto bar_kv = [&](int st) { return bar_q + 8 * (1 + st); };
  // each stage's mask in log2 units, -inf past L: the first stages staged
  // by every thread, later ones two tiles ahead by warp 0
  float* smask = reinterpret_cast<float*>(smem_raw + (bar_q + 64 - smem_u32(smem_raw)));

  const int tid = threadIdx.x;
  const int wg = tid / kThreads;  // warpgroup: query rows 64wg..64wg+63
  const int warp = (tid % kThreads) / 32, g = (tid % 32) / 4, t = tid % 4;
  // the query tiles of one head are neighbours in the grid, so they run
  // together and read the head's K/V from L2 rather than device memory
  const int nq = (L + kBf16Groups * kBlockQ - 1) / (kBf16Groups * kBlockQ);
  const int bh = blockIdx.x / nq;
  const int q0 = (blockIdx.x % nq) * kBf16Groups * kBlockQ;
  const int ntiles = (L + kBlockK - 1) / kBlockK;
  const uint32_t sQ = base + wg * C::kTileBytes;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < kBf16Stages; ++st) mbar_init(bar_kv(st), 1);
    // make the initialised barriers visible to the TMA unit
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  auto load_kv = [&](int j) {
    const int st = j % kBf16Stages;
    mbar_expect_tx(bar_kv(st), 2 * C::kTileBytes);
    tma_load(sK(st), &tk, j * kBlockK, bh, bar_kv(st));
    tma_load(sV(st), &tv, j * kBlockK, bh, bar_kv(st));
  };
  // the copies start before anything else waits: only thread 0 has used
  // the barriers so far
  if (tid == 0) {
    mbar_expect_tx(bar_q, kBf16Groups * C::kTileBytes);
    for (int w = 0; w < kBf16Groups; ++w) {
      tma_load(base + w * C::kTileBytes, &tq, q0 + w * kBlockQ, bh, bar_q);
    }
    for (int j = 0; j < kBf16Stages && j < ntiles; ++j) load_kv(j);
  }
  const float* mask_row = mask == nullptr ? nullptr : mask + static_cast<size_t>(bh / H) * L;
  for (int i = tid; i < kBf16Stages * kBlockK; i += kBf16Groups * kThreads) {
    smask[i] = mask_log2(mask_row, i, L);
  }
  __syncthreads();  // the barriers' initialisation and the staged mask

  float o[DH / 2], s[32];
  uint32_t p[16];
  uint32_t qf[DH / 4];  // Q's A fragments, see below
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  float m[2] = {kNegInfLog2, kNegInfLog2};
  float l[2] = {0.f, 0.f};
  float alpha[2];
  float mv[16];
  const float scale_log2 = scale * kLog2e;
  // the mask of the tile in stage st: mv[2n + c] is key 8n + 2t + c
  auto read_mask = [&](int st) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 v = *reinterpret_cast<const float2*>(smask + st * kBlockK + 8 * n + 2 * t);
      mv[2 * n] = v.x;
      mv[2 * n + 1] = v.y;
    }
  };

  // S = Q K^T of the tile in stage st: Dh / 16 steps of k16, each 32 bytes
  // further along the swizzled rows of K; the first overwrites s
  auto issue_s = [&](int st) {
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      wgmma_rs_kmajor_n64(s, qf + 4 * kk,
                          smem_desc(sK(st) + 32 * kk, 0, C::kGroupBytes, C::kLayout), kk > 0);
    }
    wgmma_commit();
  };
  // O += P V of the tile in stage st. V [keys, Dh] is MN-major; step kk
  // starts 16 keys further. Both byte offsets are the 8-key stride (only
  // one is read, since the tile is one swizzle atom wide in Dh).
  auto issue_pv = [&](int st) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dv = smem_desc(sV(st) + kk * 16 * C::kRowBytes, C::kGroupBytes,
                                    C::kGroupBytes, C::kLayout);
      if constexpr (DH == 64) {
        wgmma_rs_n64(o, p + 4 * kk, dv);
      } else {
        wgmma_rs_n32(o, p + 4 * kk, dv);
      }
    }
    wgmma_commit();
  };
  // P in bf16 as the A fragment of k16 step kk (keys 16kk..16kk+15):
  // rows g / g+8, keys 2t, 2t+1 and 2t+8, 2t+9 -- the accumulator's own
  // layout
  auto pack_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      p[4 * kk + 0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      p[4 * kk + 1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      p[4 * kk + 2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      p[4 * kk + 3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
  };

  // Q as register A fragments, read once from its swizzled tile: step kk
  // holds rows g / g+8, Dh columns 16kk + 2t (+1) and 16kk + 2t + 8 (+1).
  // The swizzle XORs the 16-byte chunk of a row with bits 7.. of its
  // offset: row % 8 for 128-byte rows, (row / 2) % 4 for 64-byte rows.
  mbar_wait(bar_q, 0);
#pragma unroll
  for (int i = 0; i < DH / 4; ++i) {
    const int row = 16 * warp + g + 8 * (i & 1);
    const int col = 16 * (i >> 2) + 2 * t + 8 * ((i >> 1) & 1);
    const int chunk = (col / 8) ^ (DH == 64 ? row % 8 : (row / 2) % 4);
    const uint32_t addr = sQ + row * C::kRowBytes + chunk * 16 + (col % 8) * 2;
    asm volatile("ld.shared.b32 %0, [%1];" : "=r"(qf[i]) : "r"(addr));
  }
  mbar_wait(bar_kv(0), 0);
  wgmma_fence();
  issue_s(0);
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < 32; ++i) fence_operand(s[i]);
  read_mask(0);
  online_softmax(s, m, l, alpha, mv, scale_log2);  // o is 0: nothing to rescale
  pack_p();

  for (int j = 1; j < ntiles; ++j) {
    const int st = j % kBf16Stages;
    const int next = j - 1 + kBf16Stages;  // refills tile j - 1's stage
    float2 next_mask = make_float2(0.f, 0.f);
    if (tid < 32 && next < ntiles) {
      next_mask = make_float2(mask_log2(mask_row, next * kBlockK + 2 * tid, L),
                              mask_log2(mask_row, next * kBlockK + 2 * tid + 1, L));
    }
    mbar_wait(bar_kv(st), (j / kBf16Stages) & 1);
    wgmma_fence();
    issue_s(st);
    issue_pv((j - 1) % kBf16Stages);
    wgmma_wait<1>();  // S_j is in; P_{j-1} V_{j-1} may still run
#pragma unroll
    for (int i = 0; i < 32; ++i) fence_operand(s[i]);
    read_mask(st);
    online_softmax(s, m, l, alpha, mv, scale_log2);
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) fence_operand(o[i]);
#pragma unroll
    for (int i = 0; i < 16; ++i) fence_operand(p[i]);
#pragma unroll
    for (int i = 0; i < DH / 4; ++i) fence_operand(qf[i]);
    rescale(o, alpha);
    pack_p();
    if (tid < 32 && next < ntiles) {
      *reinterpret_cast<float2*>(smask + (next % kBf16Stages) * kBlockK + 2 * tid) = next_mask;
    }
    // every warp is done with tile j - 1: refill its stage
    __syncthreads();
    if (tid == 0 && next < ntiles) load_kv(next);
  }
  wgmma_fence();
  issue_pv((ntiles - 1) % kBf16Stages);
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) fence_operand(o[i]);
#pragma unroll
  for (int i = 0; i < 16; ++i) fence_operand(p[i]);
  write_out<DH>(o, l, out + static_cast<size_t>(bh) * L * DH,
                q0 + kBlockQ * wg + 16 * warp, L, g, t);
}

// ---------------------------------------------------------------------------
// f32: 3xTF32 on mma.sync m16n8k8, K/V staged by cp.async.

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo with both parts exact in TF32 up to the residual's rounding
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in 3xTF32: the small cross terms first, then hi * hi
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4], float b0, float b1) {
  uint32_t b0h, b0l, b1h, b1l;
  split_tf32(b0, b0h, b0l);
  split_tf32(b1, b1h, b1l);
  mma_tf32(d, alo, b0h, b1h);
  mma_tf32(d, ahi, b0l, b1l);
  mma_tf32(d, ahi, b0h, b1h);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  // src-size 0 zero-fills the 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

template <int DH>
struct F32Tiles {
  static constexpr int kStride = DH + 4;  // padded row: conflict-free fragment loads
  static constexpr int kTileFloats = kBlockK * kStride;
  static constexpr int kSmemBytes = 2 * kStages * kTileFloats * 4;  // K and V per stage
};

// Rows [k0, k0 + 64) of a head's K or V into a padded tile; rows past L
// are zero-filled.
template <int DH>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* __restrict__ src,
                                              int k0, int L, int tid) {
  constexpr int kVecs = DH / 4;  // 16-byte pieces per row
#pragma unroll
  for (int r = 0; r < kBlockK * kVecs / kThreads; ++r) {
    const int i = tid + r * kThreads;
    const int row = i / kVecs, c = (i % kVecs) * 4;
    const bool valid = k0 + row < L;
    const float* p = valid ? src + static_cast<size_t>(k0 + row) * DH + c : src;
    cp_async16(smem_u32(dst + row * F32Tiles<DH>::kStride + c), p, valid);
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_f32_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ mask,
                        float* __restrict__ out, int H, int L, float scale) {
  using C = F32Tiles<DH>;
  constexpr int ST = C::kStride;
  extern __shared__ float smem_f[];
  auto sK = [&](int st) { return smem_f + (2 * st) * C::kTileFloats; };
  auto sV = [&](int st) { return smem_f + (2 * st + 1) * C::kTileFloats; };

  const int tid = threadIdx.x;
  const int warp = tid / 32, g = (tid % 32) / 4, t = tid % 4;
  const int nq = (L + kBlockQ - 1) / kBlockQ;  // a head's query tiles are neighbours
  const int bh = blockIdx.x / nq;
  const int row0 = (blockIdx.x % nq) * kBlockQ + 16 * warp;
  const int ntiles = (L + kBlockK - 1) / kBlockK;
  const size_t head = static_cast<size_t>(bh) * L * DH;
  const float* kh = k + head;
  const float* vh = v + head;

  load_tile_f32<DH>(sK(0), kh, 0, L, tid);
  load_tile_f32<DH>(sV(0), vh, 0, L, tid);
  asm volatile("cp.async.commit_group;" ::: "memory");

  // Q's A fragments, split once: step kb covers Dh columns 8kb..8kb+7;
  // a0 = (g, t), a1 = (g+8, t), a2 = (g, t+4), a3 = (g+8, t+4)
  uint32_t qhi[DH / 8][4], qlo[DH / 8][4];
#pragma unroll
  for (int kb = 0; kb < DH / 8; ++kb) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + g + 8 * (e & 1);
      const int col = 8 * kb + t + 4 * (e >> 1);
      const float x = row < L ? q[head + static_cast<size_t>(row) * DH + col] : 0.f;
      split_tf32(x, qhi[kb][e], qlo[kb][e]);
    }
  }

  float o[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInfLog2, kNegInfLog2};
  float l[2] = {0.f, 0.f};
  const float* mask_row = mask == nullptr ? nullptr : mask + static_cast<size_t>(bh / H) * L;
  const float scale_log2 = scale * kLog2e;

  for (int j = 0; j < ntiles; ++j) {
    const int st = j % kStages;
    if (j + 1 < ntiles) {  // the stage was freed by the barrier closing j - 1
      load_tile_f32<DH>(sK((j + 1) % kStages), kh, (j + 1) * kBlockK, L, tid);
      load_tile_f32<DH>(sV((j + 1) % kStages), vh, (j + 1) * kBlockK, L, tid);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
    asm volatile("cp.async.wait_group 1;" ::: "memory");
    __syncthreads();
    const float* tk = sK(st);
    const float* tv = sV(st);

    // S = Q K^T: B fragment of keys 8n..8n+7 is b0 = K[8n+g][8kb+t],
    // b1 = K[8n+g][8kb+t+4]
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float(&d)[4] = *reinterpret_cast<float(*)[4]>(s + 4 * n);
      const float* kr = tk + (8 * n + g) * ST + t;
#pragma unroll
      for (int kb = 0; kb < DH / 8; ++kb) {
        mma_3xtf32(d, qhi[kb], qlo[kb], kr[8 * kb], kr[8 * kb + 4]);
      }
    }

    // loaded here rather than before the products: it keeps 16 registers
    // free during them, and a tile's products hide far more than its latency
    float mv[16], alpha[2];
    load_mask(mv, mask_row, j * kBlockK, L, t);
    online_softmax(s, m, l, alpha, mv, scale_log2);
    rescale(o, alpha);

    // O += P V over keys 8kb..8kb+7. P's accumulator holds keys 2t, 2t+1
    // of rows g, g+8; taken as the A fragment (columns t, t+4) it pairs
    // A column t with key 2t and t+4 with key 2t+1, so B reads V's keys
    // in that order: b0 = V[8kb+2t][8n+g], b1 = V[8kb+2t+1][8n+g].
#pragma unroll
    for (int kb = 0; kb < 8; ++kb) {
      uint32_t ahi[4], alo[4];
      split_tf32(s[4 * kb + 0], ahi[0], alo[0]);
      split_tf32(s[4 * kb + 2], ahi[1], alo[1]);
      split_tf32(s[4 * kb + 1], ahi[2], alo[2]);
      split_tf32(s[4 * kb + 3], ahi[3], alo[3]);
      const float* vr = tv + (8 * kb + 2 * t) * ST + g;
#pragma unroll
      for (int n = 0; n < DH / 8; ++n) {
        float(&d)[4] = *reinterpret_cast<float(*)[4]>(o + 4 * n);
        mma_3xtf32(d, ahi, alo, vr[8 * n], vr[ST + 8 * n]);
      }
    }
    __syncthreads();  // every warp is done with this stage
  }
  write_out<DH>(o, l, out + head, row0, L, g, t);
}

// ---------------------------------------------------------------------------
// Host side.

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API symbol; take it from the driver
// library the process already has loaded, so nothing links against libcuda.
EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (h == nullptr) h = dlopen("libcuda.so.1", RTLD_NOW);
    return h == nullptr ? nullptr
                        : reinterpret_cast<EncodeTiledFn>(dlsym(h, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// A 3-D map over a contiguous bf16 [B*H, L, DH] tensor, boxes [1, 64, DH],
// swizzled as the wgmma descriptors expect; rows past L read as zero.
template <int DH>
bool encode_map(CUtensorMap* map, const void* ptr, int BH, int L) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(DH), static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(BH)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(DH) * 2,
                                 static_cast<cuuint64_t>(L) * DH * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(DH), kBlockK, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
            box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
            DH == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DH>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const float* mask,
                        void* out, int B, int H, int L, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!encode_map<DH>(&tq, q, B * H, L) || !encode_map<DH>(&tk, k, B * H, L) ||
      !encode_map<DH>(&tv, v, B * H, L)) {
    return cudaErrorInvalidValue;
  }
  constexpr int smem = Bf16Tiles<DH>::kSmemBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bf16_wgmma_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  constexpr int rows = kBf16Groups * kBlockQ;
  const dim3 grid(B * H * ((L + rows - 1) / rows));
  flash_bf16_wgmma_kernel<DH><<<grid, kBf16Groups * kThreads, smem, stream>>>(
      tq, tk, tv, mask, static_cast<__nv_bfloat16*>(out), H, L, scale);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_f32(const void* q, const void* k, const void* v, const float* mask,
                       void* out, int B, int H, int L, float scale, cudaStream_t stream) {
  constexpr int smem = F32Tiles<DH>::kSmemBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_f32_tf32x3_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H * ((L + kBlockQ - 1) / kBlockQ));
  flash_f32_tf32x3_kernel<DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), mask, static_cast<float*>(out), H, L, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t: the launch's
// cudaGetLastError(), or cudaErrorInvalidValue for arguments the kernel
// does not take (the wrapper checks them first) or a tensor map the
// driver refuses.
extern "C" int sdl_flash_attention_forward(const void* q, const void* k,
                                           const void* v, const void* mask,
                                           void* out, int B, int H, int L,
                                           int head_dim, int dtype,
                                           float scale, void* stream) {
  if (B <= 0 || H <= 0 || L <= 0 || (dtype != 0 && dtype != 1) ||
      (head_dim != 32 && head_dim != 64) ||
      static_cast<long long>(B) * H * ((L + kBlockQ - 1) / kBlockQ) > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* m = static_cast<const float*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = head_dim == 64 ? launch_f32<64>(q, k, v, m, out, B, H, L, scale, s)
                         : launch_f32<32>(q, k, v, m, out, B, H, L, scale, s);
  } else {
    err = head_dim == 64 ? launch_bf16<64>(q, k, v, m, out, B, H, L, scale, s)
                         : launch_bf16<32>(q, k, v, m, out, B, H, L, scale, s);
  }
  return static_cast<int>(err);
}
