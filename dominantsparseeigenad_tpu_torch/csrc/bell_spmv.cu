// Blocked-ELL sparse matrix-vector product for Hopper (sm_90a).
//
//   y[i*bs + a] = sum_j sum_b vals[i, j, a, b] * x[cols[i, j]*bs + b]
//
// vals: (nb, mb, bs, bs) row-major, float or bfloat16 (upcast in
// registers); cols: (nb, mb) int32 block-column indices in [0, nb_cols);
// x: (nb_cols*bs,) float; y: (nb*bs,) float.  Accumulation is always
// float.  Complex64 values take complex64 x and y (float2, re and im
// interleaved) and a float2 accumulator (K5, below).  x is read only
// through cols, so nb_cols never enters the
// kernel: a square operator has nb_cols = nb, a rectangular row panel
// (one rank's block-rows of a row-sharded operator) any nb_cols.  The
// caller checks the range of cols; every offset into x, cols*bs + b, is
// formed in 64 bits.
//
// Replaces the Pallas TPU kernel `_spmv_kernel` of
// dominantsparseeigenad_tpu/ops/pallas_spmv.py (launched by
// `_bell_spmv_pallas` through `pl.pallas_call`), for its SpMV entry
// `bell_spmv` with float values (K1) and bfloat16 values (K2), on a
// square operator and on a row panel (K4a, from
// `RowShardedBellOperator._panel_spmv` of
// dominantsparseeigenad_tpu/parallel/sharded_sparse.py).
//
// What bounds it on an H100: the value stream.  Per (bs, bs) block the
// kernel reads bs*bs values against bs floats of x, so at bs = 128 the
// values are ~99% of the bytes; 2 flops per value is far below the ratio
// at which arithmetic would limit (67 TFLOP/s float against 3.35 TB/s).
// The least time is therefore bytes / memory bandwidth.
//
// What the design does about it:
// * One thread block per block-row i; blocks share nothing, so there are
//   no atomics and y is written once.  (The TPU grid carried the partial
//   y of row i across sequential grid steps in VMEM; here the loop over
//   the mb slots runs inside the block instead.)
// * Each row a of a value block is read by a group of G lanes with
//   16-byte vector loads along b (4 floats, 8 bfloat16 or 2 complex64
//   values), so a warp's loads are contiguous and coalesced.  Reading
//   with one thread per row a would stride by bs and waste most of each
//   memory transaction.
// * The x segment a group needs is read through the read-only cache:
//   it is reused by every row of the block-row and stays in L1/L2, so the
//   device-memory traffic stays the value stream plus one gather of x.
// * Each lane keeps its partial sum in a register across all mb slots;
//   the G lanes of a row are reduced with warp shuffles once, at the end.
// * A block size that is not a multiple of the vector width, or an
//   unaligned pointer, takes the same code with VEC = 1 (scalar loads,
//   still coalesced), and the lane loop masks the ragged tail.
// The loads of consecutive slots are independent, so the unrolled slot
// loop keeps several of them in flight per thread; making the stream
// faster (cp.async/TMA pipelines, several block-rows per block) is left
// for later work.
//
// Banded mode (K4b): the same kernel body for the banded slot plan of
// `_spmv_kernel` (pallas_spmv.py:161; its slab DMAs :211-258).  A slot j
// whose plan entry band_off[j] = o is >= 0 takes its column from
// (i + o) % nb and never reads cols; a slot with -1 reads cols as in the
// gather mode.  Each block writes its slots' columns to shared memory
// once, before the slot loop.  The slot loop and the sums run in the same
// order in both modes, so a plan that matches cols gives the gather
// mode's y bit for bit.  On the TPU a band let one slab DMA fetch the x segments of a row
// group of G block-rows instead of G row gathers.  Here one block owns
// one block-row and loads its own indices, so the slab has no direct
// counterpart at this design: the band mode removes the cols read
// (4 bytes a slot) and makes the x segments that neighbouring blocks read
// contiguous, which the L2 serves alike.  A block that owns G block-rows
// and copies a band's (G, bs) slab with one bulk (TMA) copy is later,
// performance work.
//
// Complex64 values (K5): the JAX package multiplies complex blocks on its
// XLA path only (`BellOperator._xla_matvec`, ops/sparse.py:337-351, and
// `RowShardedBellOperator._panel_spmv`, parallel/sharded_sparse.py:206);
// its Pallas kernel has no complex dtype.  The same body runs them with
// T = float2: a 16-byte load carries 2 complex values (VEC = 2), x comes
// as float2 through the read-only cache, each value costs 4 FMAs into a
// float2 register sum, and the shuffles reduce both halves.  The bound is
// the same value stream, twice the bytes of float values (8 flops a
// 8-byte value stays far below the arithmetic rate).  Gather, banded and
// panel modes are the real ones', so banded equals gather bit for bit.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

template <typename T, int VEC>
struct Loader;

template <>
struct Loader<float, 4> {
  __device__ static void load(const float* p, float (&v)[4]) {
    float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  }
};

template <>
struct Loader<float, 1> {
  __device__ static void load(const float* p, float (&v)[1]) {
    v[0] = __ldg(p);
  }
};

template <>
struct Loader<__nv_bfloat16, 8> {
  __device__ static void load(const __nv_bfloat16* p, float (&v)[8]) {
    uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float2 f = __bfloat1622float2(h[k]);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  }
};

template <>
struct Loader<__nv_bfloat16, 1> {
  __device__ static void load(const __nv_bfloat16* p, float (&v)[1]) {
    v[0] = __bfloat162float(p[0]);
  }
};

// Complex64 values: float2 (re, im), two to a 16-byte load.
template <>
struct Loader<float2, 2> {
  __device__ static void load(const float2* p, float2 (&v)[2]) {
    float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = make_float2(t.x, t.y);
    v[1] = make_float2(t.z, t.w);
  }
};

template <>
struct Loader<float2, 1> {
  __device__ static void load(const float2* p, float2 (&v)[1]) {
    v[0] = __ldg(p);
  }
};

// The type of x, y and the sums: float for float and bfloat16 values,
// float2 for complex64 values.
template <typename T>
struct Elem {
  using type = float;
};
template <>
struct Elem<float2> {
  using type = float2;
};

// VEC elements of x at a 16-byte aligned address when VEC > 1.
template <int VEC>
__device__ __forceinline__ void load_x(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    v[0] = __ldg(p);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; k += 4) {
      float4 t = __ldg(reinterpret_cast<const float4*>(p + k));
      v[k] = t.x; v[k + 1] = t.y; v[k + 2] = t.z; v[k + 3] = t.w;
    }
  }
}

template <int VEC>
__device__ __forceinline__ void load_x(const float2* p, float2 (&v)[VEC]) {
  if constexpr (VEC == 1) {
    v[0] = __ldg(p);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; k += 2) {
      float4 t = __ldg(reinterpret_cast<const float4*>(p + k));
      v[k] = make_float2(t.x, t.y);
      v[k + 1] = make_float2(t.z, t.w);
    }
  }
}

// acc + v * x, in float or in complex arithmetic (4 FMAs).
__device__ __forceinline__ float mac(float v, float x, float acc) {
  return fmaf(v, x, acc);
}

__device__ __forceinline__ float2 mac(float2 v, float2 x, float2 acc) {
  acc.x = fmaf(v.x, x.x, acc.x);
  acc.x = fmaf(-v.y, x.y, acc.x);
  acc.y = fmaf(v.x, x.y, acc.y);
  acc.y = fmaf(v.y, x.x, acc.y);
  return acc;
}

// a plus the a of the lane `off` away (a butterfly step of the reduction).
__device__ __forceinline__ float shfl_add(float a, int off) {
  return a + __shfl_xor_sync(0xffffffffu, a, off);
}

__device__ __forceinline__ float2 shfl_add(float2 a, int off) {
  const float re = __shfl_xor_sync(0xffffffffu, a.x, off);
  const float im = __shfl_xor_sync(0xffffffffu, a.y, off);
  return make_float2(a.x + re, a.y + im);
}

// The product of block-row i, the body of both modes.  G: lanes per row
// (a power of two <= 32).  Each warp covers 32 / G rows per pass; the
// block's warps stride over the bs rows of block-row i.  Slot j's
// block-column is cols_i[j], or s_cols[j] in the banded mode; the loop
// and the sums run in the same order in both.
template <typename T, int VEC, bool BANDED>
__device__ __forceinline__ void spmv_block_row(
    const T* __restrict__ vals, const int* __restrict__ cols_i,
    const int* s_cols, const typename Elem<T>::type* __restrict__ x,
    typename Elem<T>::type* __restrict__ y, long long i, int mb, int bs,
    int G) {
  using X = typename Elem<T>::type;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int sub = lane & (G - 1);        // chunk index within the row
  const int rsub = lane / G;             // row within the warp's pass
  const int rows_per_warp = 32 / G;
  const int chunks = bs / VEC;           // VEC-wide chunks per row
  const long long blk = (long long)bs * bs;
  const T* vals_i = vals + i * mb * blk;

  for (int a0 = warp * rows_per_warp; a0 < bs;
       a0 += nwarps * rows_per_warp) {
    const int a = a0 + rsub;
    X acc{};
    if (a < bs) {
      const T* row = vals_i + (long long)a * bs;
#pragma unroll 4
      for (int j = 0; j < mb; ++j) {
        const long long col = BANDED ? s_cols[j] : __ldg(cols_i + j);
        const X* xs = x + col * bs;
        const T* vr = row + j * blk;
        for (int c = sub; c < chunks; c += G) {
          X v[VEC], xv[VEC];
          Loader<T, VEC>::load(vr + c * VEC, v);
          load_x<VEC>(xs + c * VEC, xv);
#pragma unroll
          for (int k = 0; k < VEC; ++k) acc = mac(v[k], xv[k], acc);
        }
      }
    }
    // Every lane of the warp takes part in the shuffles (the loop bound
    // is uniform across the warp); rows past bs contribute nothing.
    for (int off = G >> 1; off > 0; off >>= 1) acc = shfl_add(acc, off);
    if (sub == 0 && a < bs) y[i * bs + a] = acc;
  }
}

// Gather mode: one block per block-row, columns from cols.
template <typename T, int VEC>
__global__ void bell_spmv_kernel(const T* __restrict__ vals,
                                 const int* __restrict__ cols,
                                 const typename Elem<T>::type* __restrict__ x,
                                 typename Elem<T>::type* __restrict__ y,
                                 int mb, int bs, int G) {
  const long long i = blockIdx.x;
  spmv_block_row<T, VEC, false>(vals, cols + i * mb, nullptr, x, y, i, mb,
                                bs, G);
}

// Banded mode: band_off (mb,) holds o in [0, nb) for a band slot, -1 for
// a gather slot.  The block first writes its slots' columns to shared
// memory, (i + o) % nb for a band, cols for the rest.  At most 32
// registers a thread, so that 8 blocks of 256 threads share an SM, as the
// gather mode's float kernel does: with the column select inside the
// slot loop the banded float kernel took 37 registers (6 blocks an SM)
// and ran 4.8% slower than the gather mode on an H100.
template <typename T, int VEC>
__global__ void __launch_bounds__(256, 8)
bell_spmv_banded_kernel(const T* __restrict__ vals,
                        const int* __restrict__ cols,
                        const int* __restrict__ band_off,
                        const typename Elem<T>::type* __restrict__ x,
                        typename Elem<T>::type* __restrict__ y,
                        long long nb, int mb, int bs, int G) {
  extern __shared__ int s_cols[];
  const long long i = blockIdx.x;
  const int* cols_i = cols + i * mb;
  for (int j = threadIdx.x; j < mb; j += blockDim.x) {
    const int o = __ldg(band_off + j);
    s_cols[j] = o < 0 ? __ldg(cols_i + j)
                      : (int)(i + o < nb ? i + o : i + o - nb);
  }
  __syncthreads();
  spmv_block_row<T, VEC, true>(vals, cols_i, s_cols, x, y, i, mb, bs, G);
}

int next_pow2_capped(int c) {
  int g = 1;
  while (g < c && g < 32) g <<= 1;
  return g;
}

template <typename T, int VEC, bool BANDED>
int launch(const void* vals, const void* cols, const void* band_off,
           const void* x, void* y, long long nb, int mb, int bs, int device,
           void* stream) {
  // The library carries its own CUDA runtime: bind it to the caller's
  // device so the launch goes to the context that owns `stream`.
  using X = typename Elem<T>::type;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int G = next_pow2_capped(bs / VEC);
  const int rows_per_warp = 32 / G;
  int warps = (bs + rows_per_warp - 1) / rows_per_warp;
  if (warps > 8) warps = 8;
  cudaStream_t s = (cudaStream_t)stream;
  if constexpr (BANDED) {
    const size_t smem = (size_t)mb * sizeof(int);
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(bell_spmv_banded_kernel<T, VEC>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    bell_spmv_banded_kernel<T, VEC><<<(unsigned)nb, warps * 32, smem, s>>>(
        (const T*)vals, (const int*)cols, (const int*)band_off,
        (const X*)x, (X*)y, nb, mb, bs, G);
  } else {
    bell_spmv_kernel<T, VEC><<<(unsigned)nb, warps * 32, 0, s>>>(
        (const T*)vals, (const int*)cols, (const X*)x, (X*)y, mb, bs, G);
  }
  return (int)cudaGetLastError();
}

// The vector width the caller checked (16 bytes of values, or 1) picks
// the instantiation.
template <bool BANDED>
int launch_f32(const void* vals, const void* cols, const void* band_off,
               const void* x, void* y, long long nb, int mb, int bs, int vec,
               int device, void* stream) {
  if (vec == 4)
    return launch<float, 4, BANDED>(vals, cols, band_off, x, y, nb, mb, bs,
                                    device, stream);
  return launch<float, 1, BANDED>(vals, cols, band_off, x, y, nb, mb, bs,
                                  device, stream);
}

template <bool BANDED>
int launch_bf16(const void* vals, const void* cols, const void* band_off,
                const void* x, void* y, long long nb, int mb, int bs,
                int vec, int device, void* stream) {
  if (vec == 8)
    return launch<__nv_bfloat16, 8, BANDED>(vals, cols, band_off, x, y, nb,
                                            mb, bs, device, stream);
  return launch<__nv_bfloat16, 1, BANDED>(vals, cols, band_off, x, y, nb,
                                          mb, bs, device, stream);
}

template <bool BANDED>
int launch_c64(const void* vals, const void* cols, const void* band_off,
               const void* x, void* y, long long nb, int mb, int bs, int vec,
               int device, void* stream) {
  if (vec == 2)
    return launch<float2, 2, BANDED>(vals, cols, band_off, x, y, nb, mb, bs,
                                     device, stream);
  return launch<float2, 1, BANDED>(vals, cols, band_off, x, y, nb, mb, bs,
                                   device, stream);
}

}  // namespace

// Plain C entry points for ctypes.  `vec` is the vector width the caller
// checked the block size and pointer alignment for (16 bytes of values: 4
// floats, 8 bfloat16 or 2 complex64; or 1); `band_off` the banded entries'
// plan, (mb,) int32 on the device.
// Each returns cudaGetLastError() after the launch (0 = launched).
extern "C" int bell_spmv_f32(const void* vals, const void* cols,
                             const void* x, void* y, long long nb, int mb,
                             int bs, int vec, int device, void* stream) {
  return launch_f32<false>(vals, cols, nullptr, x, y, nb, mb, bs, vec,
                           device, stream);
}

extern "C" int bell_spmv_bf16vals(const void* vals, const void* cols,
                                  const void* x, void* y, long long nb,
                                  int mb, int bs, int vec, int device,
                                  void* stream) {
  return launch_bf16<false>(vals, cols, nullptr, x, y, nb, mb, bs, vec,
                            device, stream);
}

extern "C" int bell_spmv_banded_f32(const void* vals, const void* cols,
                                    const void* band_off, const void* x,
                                    void* y, long long nb, int mb, int bs,
                                    int vec, int device, void* stream) {
  return launch_f32<true>(vals, cols, band_off, x, y, nb, mb, bs, vec,
                          device, stream);
}

extern "C" int bell_spmv_banded_bf16vals(const void* vals, const void* cols,
                                         const void* band_off, const void* x,
                                         void* y, long long nb, int mb,
                                         int bs, int vec, int device,
                                         void* stream) {
  return launch_bf16<true>(vals, cols, band_off, x, y, nb, mb, bs, vec,
                           device, stream);
}

// Complex64 values, x and y (K5).
extern "C" int bell_spmv_c64(const void* vals, const void* cols,
                             const void* x, void* y, long long nb, int mb,
                             int bs, int vec, int device, void* stream) {
  return launch_c64<false>(vals, cols, nullptr, x, y, nb, mb, bs, vec,
                           device, stream);
}

extern "C" int bell_spmv_banded_c64(const void* vals, const void* cols,
                                    const void* band_off, const void* x,
                                    void* y, long long nb, int mb, int bs,
                                    int vec, int device, void* stream) {
  return launch_c64<true>(vals, cols, band_off, x, y, nb, mb, bs, vec,
                          device, stream);
}

extern "C" const char* bell_spmv_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
