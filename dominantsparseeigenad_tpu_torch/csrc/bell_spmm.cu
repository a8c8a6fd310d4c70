// Blocked-ELL sparse matrix times a block of vectors, for Hopper (sm_90a).
//
//   Y[i*bs + a, c] = sum_j sum_b vals[i, j, a, b] * X[cols[i, j]*bs + b, c]
//
// vals: (nb, mb, bs, bs) row-major, float or bfloat16 (upcast in
// registers); cols: (nb, mb) int32 block-column indices in [0, nb_cols);
// X: (nb_cols*bs, r) and Y: (nb*bs, r) float, row-major (the layout of
// the JAX package's public function).  Accumulation is always float.
// X is read only through cols, so nb_cols never enters the kernel: a
// square operator has nb_cols = nb, a rectangular row panel (one rank's
// block-rows of a row-sharded operator) any nb_cols.  The caller checks
// the range of cols; every offset into X, (cols*bs + b)*r + c, is formed
// in 64 bits.
//
// Replaces the Pallas TPU kernel `_spmv_kernel` of
// dominantsparseeigenad_tpu/ops/pallas_spmv.py for its SpMM entry
// `bell_spmm` (K3), which `BellOperator.matmat` calls for the block
// solvers (LOBPCG, the batched deflated CG of the block eigensolver's
// backward), on a square operator and on a row panel (K4a, from
// `RowShardedBellOperator._panel_spmv` of
// dominantsparseeigenad_tpu/parallel/sharded_sparse.py).
//
// What bounds it on an H100: the value stream, as for the SpMV.  Each
// value is used for all r columns, so at r = 8 a value costs 16 flops
// against 4 bytes (f32), still far below the 20 flops/byte at which the
// 67 TFLOP/s float rate would limit; up to r ~ 40 the least time is
// bytes / memory bandwidth.  The tensor cores are out: TF32 would round
// the operands, and a bf16 product would round the float X.
//
// What the design does about it:
// * One thread block per slab of rows of block-row i (up to 8 warps, so
//   that two blocks share an SM and one streams values while the other
//   stages X), looping over the block-row's mb slots itself: no atomics,
//   Y is written once.  The TPU grid carried the partial Y across sequential
//   grid steps in VMEM; CUDA blocks run in no order, so the slot loop
//   runs inside the block.
// * The X segments of a tile of slots (all 17 of config #5, in 72 KB) are
//   staged in shared memory, transposed to (slot, column, b) with a
//   padded row, so that the lanes of a warp, which walk b, read
//   consecutive 16-byte words (no bank conflicts).  Each thread keeps 8
//   staging loads in flight (16 bytes each where X is aligned and r is a
//   multiple of 4, else 4 bytes), so the gather costs a few latencies per
//   tile, not one per element.
// * Each group of G lanes reads TR rows of a value block (8 for float
//   values, 4 for bfloat16) with 16-byte loads along b (coalesced), all
//   issued before the products; each X word it takes from shared memory
//   serves all TR rows: shared-memory traffic is r / TR floats per value,
//   well under what the SM delivers.  (TR, the warps per block and the
//   loads in flight were chosen by timing variants on an H100 at
//   config #5, r = 8 and 4.)
// * Each lane keeps TR x RC partial sums in registers across all slots,
//   reduced over the G lanes with warp shuffles once, at the end.
// * RC (4 or 8) columns per block: a ragged r masks the tail (r < 4 does
//   the work of 4 columns), and r > 8 runs ceil(r / 8) column chunks as
//   separate blocks (each streams the values again; the block solvers
//   here use r <= 8).
// * A block size that is not a multiple of the vector width, or unaligned
//   values, take the same code with VEC = 1 (scalar loads).
// Making the stream faster (cp.async/TMA pipelines, several block-rows per
// block) is left for later work.
//
// Banded mode (K4b): the same kernel body for the banded slot plan of
// `_spmv_kernel` (pallas_spmv.py:161; its slab DMAs :211-258).  Where a
// slot's plan entry band_off[j] = o is >= 0, the staging takes the slot's
// block-column from (i + o) % nb and never reads cols; a slot with -1
// reads cols as in the gather mode.  Staging, slot loop and sums run in
// the same order in both modes, so a plan that matches cols gives the
// gather mode's Y bit for bit.  On the TPU a band let one slab DMA fetch
// the X segments of a row group of G block-rows instead of G row
// gathers.  Here one block owns (a slab of rows of) one block-row and
// loads its own indices, so the slab has no direct counterpart at this
// design: the band mode removes the cols read and makes the X segments
// that neighbouring blocks stage contiguous.  A block that owns G
// block-rows and stages a band's (G, bs, r) slab with one bulk (TMA) copy,
// reusing X across them, is later, performance work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// Rows per lane group: 8 for float values; 4 for bfloat16, whose 16-byte
// loads carry 8 values, so that the unpacked values, the TR x 8
// accumulators and the loads fit in 128 registers (two blocks per SM).
template <typename T>
struct RowsPerGroup {
  static constexpr int value = sizeof(T) == 4 ? 8 : 4;
};
constexpr int MAX_WARPS = 8;
constexpr int SB = 8;                 // staging loads in flight per thread
// Shared memory of a block (two blocks share an SM's 227 KB); above
// 48 KB it needs the opt-in attribute.
constexpr int SMEM_BYTES = 100 * 1024;
constexpr int SMEM_DEFAULT = 48 * 1024;

// Values are loaded raw, 16 bytes (VEC values) at a time, and unpacked to
// float 4 (or 1) at a time where they are used.
template <typename T, int VEC>
struct Raw;

template <>
struct Raw<float, 4> {
  float4 d;
  __device__ void load(const float* p) {
    d = __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ void zero() { d = make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ void unpack(int, float (&v)[4]) const {
    v[0] = d.x; v[1] = d.y; v[2] = d.z; v[3] = d.w;
  }
};

template <>
struct Raw<float, 1> {
  float d;
  __device__ void load(const float* p) { d = __ldg(p); }
  __device__ void zero() { d = 0.f; }
  __device__ void unpack(int, float (&v)[1]) const { v[0] = d; }
};

template <>
struct Raw<__nv_bfloat16, 8> {
  uint4 d;
  __device__ void load(const __nv_bfloat16* p) {
    d = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ void zero() { d = make_uint4(0u, 0u, 0u, 0u); }
  // Values 4q .. 4q+3 of the 8.
  __device__ void unpack(int q, float (&v)[4]) const {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&d);
    float2 lo = __bfloat1622float2(h[2 * q]);
    float2 hi = __bfloat1622float2(h[2 * q + 1]);
    v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
  }
};

template <>
struct Raw<__nv_bfloat16, 1> {
  __nv_bfloat16 d;
  __device__ void load(const __nv_bfloat16* p) { d = p[0]; }
  __device__ void zero() { d = __float2bfloat16(0.f); }
  __device__ void unpack(int, float (&v)[1]) const {
    v[0] = __bfloat162float(d);
  }
};

// Grid: (nb * slabs, ceil(r / RC)).  Block: warps of 32 lanes; a warp
// covers (32 / G) lane groups of TR rows each.  ld: the padded length of a
// staged X column (a multiple of 4 floats); jt: slots staged at a time.
// BANDED: band_off (mb,) holds o in [0, nb) for a band slot, -1 for a
// gather slot; unused otherwise.
template <typename T, int VEC, int RC, bool BANDED>
__global__ void __launch_bounds__(MAX_WARPS * 32)
bell_spmm_kernel(const T* __restrict__ vals, const int* __restrict__ cols,
                 const int* __restrict__ band_off,
                 const float* __restrict__ X, float* __restrict__ Y,
                 long long nb, int mb, int bs, int r, int G, int slabs,
                 int ld, int jt) {
  constexpr int TR = RowsPerGroup<T>::value;
  constexpr int U = VEC < 4 ? VEC : 4;  // values unpacked at a time
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  const long long i = blockIdx.x / slabs;
  const int slab = blockIdx.x - (int)(i * slabs);
  const int c0 = blockIdx.y * RC;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = lane & (G - 1);       // chunk index within a row
  const int grp = lane / G;             // lane group within the warp
  const int rows_per_warp = (32 / G) * TR;
  const int rows_per_block = (blockDim.x >> 5) * rows_per_warp;
  const int a0 = slab * rows_per_block + warp * rows_per_warp + grp * TR;
  const int chunks = bs / VEC;
  const int* cols_i = cols + i * mb;
  const long long blk = (long long)bs * bs;
  const T* vals_i = vals + i * mb * blk;

  float acc[TR][RC];
#pragma unroll
  for (int t = 0; t < TR; ++t)
#pragma unroll
    for (int c = 0; c < RC; ++c) acc[t][c] = 0.f;

  // Shared memory: the staged X tile, (slot, column, b) with padded b,
  // then the tile's block-column indices.
  int* cs = reinterpret_cast<int*>(xs + jt * RC * ld);
  const bool xvec = r % 4 == 0 &&
                    (reinterpret_cast<uintptr_t>(X) & 15) == 0;
  for (int j0 = 0; j0 < mb; j0 += jt) {
    const int jn = min(jt, mb - j0);
    __syncthreads();                    // the previous tile is consumed
    for (int jj = threadIdx.x; jj < jn; jj += blockDim.x) {
      if constexpr (BANDED) {
        const int o = __ldg(band_off + j0 + jj);
        cs[jj] = o < 0 ? __ldg(cols_i + j0 + jj)
                       : (int)(i + o < nb ? i + o : i + o - nb);
      } else {
        cs[jj] = __ldg(cols_i + j0 + jj);
      }
    }
    __syncthreads();
    // SB independent loads per thread before their stores, so the
    // gather's latency is paid once per batch, not once per element.
    if (xvec) {
      // float4 of columns c0+4q .. c0+4q+3 of one X row.
      constexpr int R4 = RC / 4;
      const int total = jn * bs * R4;
      for (int e0 = threadIdx.x; e0 < total; e0 += SB * blockDim.x) {
        float4 tmp[SB];
#pragma unroll
        for (int u = 0; u < SB; ++u) {
          const int e = e0 + u * blockDim.x;
          tmp[u] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (e < total) {
            const int jj = e / (bs * R4);
            const int rem = e - jj * bs * R4;
            const int b = rem / R4, q = rem % R4;
            if (c0 + 4 * q < r)
              tmp[u] = __ldg(reinterpret_cast<const float4*>(
                  X + ((long long)cs[jj] * bs + b) * r + c0 + 4 * q));
          }
        }
#pragma unroll
        for (int u = 0; u < SB; ++u) {
          const int e = e0 + u * blockDim.x;
          if (e < total) {
            const int jj = e / (bs * R4);
            const int rem = e - jj * bs * R4;
            const int b = rem / R4, q = rem % R4;
            float* d = xs + (jj * RC + 4 * q) * ld + b;
            d[0] = tmp[u].x; d[ld] = tmp[u].y;
            d[2 * ld] = tmp[u].z; d[3 * ld] = tmp[u].w;
          }
        }
      }
    } else {
      const int total = jn * bs * RC;
      for (int e0 = threadIdx.x; e0 < total; e0 += SB * blockDim.x) {
        float tmp[SB];
#pragma unroll
        for (int u = 0; u < SB; ++u) {
          const int e = e0 + u * blockDim.x;
          tmp[u] = 0.f;
          if (e < total) {
            const int jj = e / (bs * RC);
            const int rem = e - jj * bs * RC;
            const int b = rem / RC, c = rem % RC;
            if (c0 + c < r)
              tmp[u] = __ldg(X + ((long long)cs[jj] * bs + b) * r + c0 + c);
          }
        }
#pragma unroll
        for (int u = 0; u < SB; ++u) {
          const int e = e0 + u * blockDim.x;
          if (e < total) {
            const int jj = e / (bs * RC);
            const int rem = e - jj * bs * RC;
            xs[(jj * RC + rem % RC) * ld + rem / RC] = tmp[u];
          }
        }
      }
    }
    __syncthreads();
    for (int jj = 0; jj < jn; ++jj) {
      const T* vb = vals_i + (long long)(j0 + jj) * blk;
      const float* xj = xs + jj * RC * ld;
      for (int ch = sub; ch < chunks; ch += G) {
        // All TR loads are issued before any product.
        Raw<T, VEC> raw[TR];
#pragma unroll
        for (int t = 0; t < TR; ++t) {
          if (a0 + t < bs)
            raw[t].load(vb + (long long)(a0 + t) * bs + ch * VEC);
          else
            raw[t].zero();
        }
#pragma unroll
        for (int q = 0; q < VEC / U; ++q) {
          float v[TR][U];
#pragma unroll
          for (int t = 0; t < TR; ++t) raw[t].unpack(q, v[t]);
#pragma unroll
          for (int c = 0; c < RC; ++c) {
            // U floats of staged column c (16-byte aligned when U = 4).
            const float* xc = xj + c * ld + ch * VEC + q * U;
            float xv[U];
            if constexpr (U == 4) {
              const float4 x4 = *reinterpret_cast<const float4*>(xc);
              xv[0] = x4.x; xv[1] = x4.y; xv[2] = x4.z; xv[3] = x4.w;
            } else {
              xv[0] = xc[0];
            }
#pragma unroll
            for (int t = 0; t < TR; ++t)
#pragma unroll
              for (int k = 0; k < U; ++k)
                acc[t][c] = fmaf(v[t][k], xv[k], acc[t][c]);
          }
        }
      }
    }
  }

  // Every lane of the warp takes part in the shuffles (the loop bounds
  // above are uniform across the warp); lanes past the row contribute 0.
#pragma unroll
  for (int t = 0; t < TR; ++t)
#pragma unroll
    for (int c = 0; c < RC; ++c)
      for (int off = G >> 1; off > 0; off >>= 1)
        acc[t][c] += __shfl_xor_sync(0xffffffffu, acc[t][c], off);
  if (sub == 0) {
#pragma unroll
    for (int t = 0; t < TR; ++t) {
      if (a0 + t >= bs) continue;
      float* yr = Y + (i * bs + a0 + t) * r;
#pragma unroll
      for (int c = 0; c < RC; ++c)
        if (c0 + c < r) yr[c0 + c] = acc[t][c];
    }
  }
}

int next_pow2_capped(int c) {
  int g = 1;
  while (g < c && g < 32) g <<= 1;
  return g;
}

template <typename T, int VEC, int RC, bool BANDED>
int launch_rc(const void* vals, const void* cols, const void* band_off,
              const void* X, void* Y, long long nb, int mb, int bs, int r,
              cudaStream_t stream) {
  const int G = next_pow2_capped(bs / VEC);
  const int rows_per_warp = (32 / G) * RowsPerGroup<T>::value;
  int warps = (bs + rows_per_warp - 1) / rows_per_warp;
  if (warps > MAX_WARPS) warps = MAX_WARPS;
  const int rows_per_block = warps * rows_per_warp;
  const int slabs = (bs + rows_per_block - 1) / rows_per_block;
  const int ld = ((bs + 3) / 4) * 4 + 4;
  // Per staged slot: RC columns of ld floats, and its column index.
  const int slot_bytes = RC * ld * (int)sizeof(float) + (int)sizeof(int);
  if (slot_bytes > SMEM_BYTES) return (int)cudaErrorInvalidConfiguration;
  int jt = SMEM_BYTES / slot_bytes;
  if (jt > mb) jt = mb;
  const int smem = jt * slot_bytes;
  if (smem > SMEM_DEFAULT) {
    cudaError_t err = cudaFuncSetAttribute(
        bell_spmm_kernel<T, VEC, RC, BANDED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)(nb * slabs), (unsigned)((r + RC - 1) / RC));
  bell_spmm_kernel<T, VEC, RC, BANDED><<<grid, warps * 32, smem, stream>>>(
      (const T*)vals, (const int*)cols, (const int*)band_off,
      (const float*)X, (float*)Y, nb, mb, bs, r, G, slabs, ld, jt);
  return (int)cudaGetLastError();
}

template <typename T, int VEC, bool BANDED>
int launch(const void* vals, const void* cols, const void* band_off,
           const void* X, void* Y, long long nb, int mb, int bs, int r,
           int device, void* stream) {
  // The library carries its own CUDA runtime: bind it to the caller's
  // device so the launch goes to the context that owns `stream`.
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (r > 4)
    return launch_rc<T, VEC, 8, BANDED>(vals, cols, band_off, X, Y, nb, mb,
                                        bs, r, s);
  return launch_rc<T, VEC, 4, BANDED>(vals, cols, band_off, X, Y, nb, mb, bs,
                                      r, s);
}

// The vector width the caller checked (16 bytes of values, or 1) picks
// the instantiation.
template <bool BANDED>
int launch_f32(const void* vals, const void* cols, const void* band_off,
               const void* X, void* Y, long long nb, int mb, int bs, int r,
               int vec, int device, void* stream) {
  if (vec == 4)
    return launch<float, 4, BANDED>(vals, cols, band_off, X, Y, nb, mb, bs,
                                    r, device, stream);
  return launch<float, 1, BANDED>(vals, cols, band_off, X, Y, nb, mb, bs, r,
                                  device, stream);
}

template <bool BANDED>
int launch_bf16(const void* vals, const void* cols, const void* band_off,
                const void* X, void* Y, long long nb, int mb, int bs, int r,
                int vec, int device, void* stream) {
  if (vec == 8)
    return launch<__nv_bfloat16, 8, BANDED>(vals, cols, band_off, X, Y, nb,
                                            mb, bs, r, device, stream);
  return launch<__nv_bfloat16, 1, BANDED>(vals, cols, band_off, X, Y, nb,
                                          mb, bs, r, device, stream);
}

}  // namespace

// Plain C entry points for ctypes.  `vec` is the vector width the caller
// checked the block size and the values' alignment for (16 bytes of
// values, or 1); `band_off` the banded entries' plan, (mb,) int32 on the
// device.  Each returns cudaGetLastError() after the launch
// (0 = launched).
extern "C" int bell_spmm_f32(const void* vals, const void* cols,
                             const void* X, void* Y, long long nb, int mb,
                             int bs, int r, int vec, int device,
                             void* stream) {
  return launch_f32<false>(vals, cols, nullptr, X, Y, nb, mb, bs, r, vec,
                           device, stream);
}

extern "C" int bell_spmm_bf16vals(const void* vals, const void* cols,
                                  const void* X, void* Y, long long nb,
                                  int mb, int bs, int r, int vec, int device,
                                  void* stream) {
  return launch_bf16<false>(vals, cols, nullptr, X, Y, nb, mb, bs, r, vec,
                            device, stream);
}

extern "C" int bell_spmm_banded_f32(const void* vals, const void* cols,
                                    const void* band_off, const void* X,
                                    void* Y, long long nb, int mb, int bs,
                                    int r, int vec, int device,
                                    void* stream) {
  return launch_f32<true>(vals, cols, band_off, X, Y, nb, mb, bs, r, vec,
                          device, stream);
}

extern "C" int bell_spmm_banded_bf16vals(const void* vals, const void* cols,
                                         const void* band_off, const void* X,
                                         void* Y, long long nb, int mb,
                                         int bs, int r, int vec, int device,
                                         void* stream) {
  return launch_bf16<true>(vals, cols, band_off, X, Y, nb, mb, bs, r, vec,
                           device, stream);
}
