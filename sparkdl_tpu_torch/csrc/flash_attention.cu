// Flash attention forward for Hopper (sm_90a): softmax(q k^T / sqrt(Dh) + mask) v
// with an online softmax, so the [L, L] score matrix is never stored.
//
// Replaces the Pallas TPU kernel sparkdl_tpu/ops/flash_attention.py
// (`_flash_kernel`, launched by `flash_attention` through pl.pallas_call).
// Same semantics:
//   - scale = 1/sqrt(Dh) of the true Dh (passed in by the wrapper);
//   - the running max starts at NEG_INF = -1e30, so a key masked with
//     finfo(float32).min never becomes the running max; a row whose keys
//     are all masked keeps l = 0 and comes out as 0 / max(0, 1e-30) = 0;
//   - keys beyond L contribute nothing (masked by bounds here; the TPU
//     kernel padded them with NEG_INF);
//   - scores, running max/sum and the accumulator are f32; the output is
//     in the input's type (f32 or bf16).
//
// Layout: q, k, v, out are contiguous [B, H, L, Dh]; mask is an additive
// f32 key mask [B, L] (0 keeps a key, a large negative value drops it),
// or null for none.
//
// Design (simple first version): one block of 64 threads per
// (b*h, tile of 64 query rows); thread i owns query row i of the tile and
// keeps its q row, running max, running sum and f32 accumulator in
// registers. A loop inside the block walks the K/V tiles (64 keys each),
// staged in shared memory as f32 (two 64x64 tiles = 32 KB at Dh = 64);
// this loop takes the place of the TPU kernel's sequential `ki` grid
// axis. Every thread reads the same K/V element at the same time, which
// shared memory serves as a broadcast. The TPU's Dh -> 128 lane padding
// and the q/k/v padding copies are gone.
//
// What bounds it on an H100 SXM: at bert-base f32 (B=32, H=12, L=512,
// Dh=64) q/k/v/o move 201 MB (0.060 ms at 3.35 TB/s) and the two products
// are 4*B*H*L*L*Dh = 25.8 GFLOP (0.385 ms at the 67 TFLOP/s of f32 outside
// the tensor cores), so the f32 case is bound by operations. In bf16 the
// same work is 101 MB (0.030 ms) against 0.026 ms at 989 TFLOP/s: bound
// by bytes, but only for a kernel that uses the tensor cores.
//
// What this design leaves on the table: it runs both products on the
// CUDA cores in f32 (no mma/wgmma, so none of the bf16 or TF32 tensor-core
// rate), loads K/V tiles synchronously (no cp.async/TMA double buffering),
// and with 64 threads and 32 KB of shared memory per block keeps few
// warps resident per SM. Those are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;   // query rows per block = threads per block
constexpr int kBlockK = 64;   // keys per shared-memory tile
constexpr int kChunk = 16;    // keys scored per online-softmax update
constexpr float kNegInf = -1e30f;

// 16-byte vector of T <-> f32 values
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ static void load(const float* p, float* dst) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    dst[0] = t.x; dst[1] = t.y; dst[2] = t.z; dst[3] = t.w;
  }
  __device__ static void store(const float* src, float* p) {
    *reinterpret_cast<float4*>(p) = make_float4(src[0], src[1], src[2], src[3]);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void load(const __nv_bfloat16* p, float* dst) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      dst[2 * j] = f.x;
      dst[2 * j + 1] = f.y;
    }
  }
  __device__ static void store(const float* src, __nv_bfloat16* p) {
    uint4 t;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&t);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      h[j] = __floats2bfloat162_rn(src[2 * j], src[2 * j + 1]);
    }
    *reinterpret_cast<uint4*>(p) = t;
  }
};

// Stage rows [0, rows_valid) of a kBlockK x DH tile into shared memory as
// f32, coalesced; rows past rows_valid (past L) are zero-filled.
template <typename T, int DH>
__device__ void load_tile(const T* __restrict__ src, int rows_valid,
                          float* __restrict__ dst) {
  constexpr int kN = Vec<T>::kN;
  constexpr int kNumVec = kBlockK * DH / kN;
  for (int vi = threadIdx.x; vi < kNumVec; vi += kBlockQ) {
    const int e = vi * kN;
    float vals[kN];
    if (e / DH < rows_valid) {
      Vec<T>::load(src + e, vals);
    } else {
#pragma unroll
      for (int j = 0; j < kN; ++j) vals[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < kN; j += 4) {
      *reinterpret_cast<float4*>(dst + e + j) =
          make_float4(vals[j], vals[j + 1], vals[j + 2], vals[j + 3]);
    }
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kBlockQ)
flash_forward_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ mask,
                     T* __restrict__ out, int H, int L, float scale) {
  __shared__ __align__(16) float sK[kBlockK * DH];
  __shared__ __align__(16) float sV[kBlockK * DH];
  __shared__ float sMask[kBlockK];

  constexpr int kN = Vec<T>::kN;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int row = blockIdx.y * kBlockQ + threadIdx.x;
  const bool active = row < L;
  const size_t base = static_cast<size_t>(bh) * L * DH;

  float qr[DH];
  float acc[DH];
#pragma unroll
  for (int d = 0; d < DH; d += kN) {
    if (active) {
      Vec<T>::load(q + base + static_cast<size_t>(row) * DH + d, qr + d);
    } else {
#pragma unroll
      for (int j = 0; j < kN; ++j) qr[d + j] = 0.f;
    }
  }
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] = 0.f;

  float m = kNegInf;  // running max
  float l = 0.f;      // running sum of exp(s - m)

  for (int k0 = 0; k0 < L; k0 += kBlockK) {
    const int kn = min(kBlockK, L - k0);
    __syncthreads();  // every thread is done with the previous tile
    load_tile<T, DH>(k + base + static_cast<size_t>(k0) * DH, kn, sK);
    load_tile<T, DH>(v + base + static_cast<size_t>(k0) * DH, kn, sV);
    if (threadIdx.x < kBlockK) {
      const int j = threadIdx.x;
      sMask[j] = (mask != nullptr && j < kn)
                     ? mask[static_cast<size_t>(b) * L + k0 + j]
                     : 0.f;
    }
    __syncthreads();

    for (int c = 0; c < kn; c += kChunk) {
      float s[kChunk];
      float m_new = m;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float4* kr = reinterpret_cast<const float4*>(sK + (c + jj) * DH);
        float dot = 0.f;
#pragma unroll
        for (int d4 = 0; d4 < DH / 4; ++d4) {
          const float4 kv = kr[d4];
          dot = fmaf(qr[4 * d4], kv.x, dot);
          dot = fmaf(qr[4 * d4 + 1], kv.y, dot);
          dot = fmaf(qr[4 * d4 + 2], kv.z, dot);
          dot = fmaf(qr[4 * d4 + 3], kv.w, dot);
        }
        // a key past L scores -inf: exp() gives it exactly 0 weight
        s[jj] = (c + jj < kn) ? dot * scale + sMask[c + jj] : -INFINITY;
        m_new = fmaxf(m_new, s[jj]);
      }
      const float alpha = expf(m - m_new);
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[d] *= alpha;
      float psum = 0.f;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float p = expf(s[jj] - m_new);
        psum += p;
        const float4* vr = reinterpret_cast<const float4*>(sV + (c + jj) * DH);
#pragma unroll
        for (int d4 = 0; d4 < DH / 4; ++d4) {
          const float4 vv = vr[d4];
          acc[4 * d4] = fmaf(p, vv.x, acc[4 * d4]);
          acc[4 * d4 + 1] = fmaf(p, vv.y, acc[4 * d4 + 1]);
          acc[4 * d4 + 2] = fmaf(p, vv.z, acc[4 * d4 + 2]);
          acc[4 * d4 + 3] = fmaf(p, vv.w, acc[4 * d4 + 3]);
        }
      }
      l = l * alpha + psum;
      m = m_new;
    }
  }

  if (active) {
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] = acc[d] / denom;
#pragma unroll
    for (int d = 0; d < DH; d += kN) {
      Vec<T>::store(acc + d, out + base + static_cast<size_t>(row) * DH + d);
    }
  }
}

template <typename T, int DH>
void launch(const void* q, const void* k, const void* v, const float* mask,
            void* out, int B, int H, int L, float scale, cudaStream_t stream) {
  const dim3 grid(B * H, (L + kBlockQ - 1) / kBlockQ);
  flash_forward_kernel<T, DH><<<grid, kBlockQ, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<T*>(out), H, L, scale);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t: the launch's
// cudaGetLastError(), or cudaErrorInvalidValue for arguments the kernel
// does not take (the wrapper checks them first).
extern "C" int sdl_flash_attention_forward(const void* q, const void* k,
                                           const void* v, const void* mask,
                                           void* out, int B, int H, int L,
                                           int head_dim, int dtype,
                                           float scale, void* stream) {
  if (B <= 0 || H <= 0 || L <= 0 || (dtype != 0 && dtype != 1) ||
      (head_dim != 32 && head_dim != 64) ||
      static_cast<long long>(B) * H > 2147483647LL ||
      (L + kBlockQ - 1) / kBlockQ > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* m = static_cast<const float*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (head_dim == 64) launch<float, 64>(q, k, v, m, out, B, H, L, scale, s);
    else launch<float, 32>(q, k, v, m, out, B, H, L, scale, s);
  } else {
    if (head_dim == 64) launch<__nv_bfloat16, 64>(q, k, v, m, out, B, H, L, scale, s);
    else launch<__nv_bfloat16, 32>(q, k, v, m, out, B, H, L, scale, s);
  }
  return static_cast<int>(cudaGetLastError());
}
