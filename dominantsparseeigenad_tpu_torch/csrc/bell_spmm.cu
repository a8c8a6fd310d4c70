// Blocked-ELL sparse matrix times a block of vectors, for Hopper (sm_90a).
//
//   Y[i*bs + a, c] = sum_j sum_b vals[i, j, a, b] * X[cols[i, j]*bs + b, c]
//
// vals: (nb, mb, bs, bs) row-major, float or bfloat16 (upcast in
// registers); cols: (nb, mb) int32 block-column indices in [0, nb_cols);
// X: (nb_cols*bs, r) and Y: (nb*bs, r) float, row-major (the layout of
// the JAX package's public function).  Accumulation is always float.
// Complex64 values take complex64 X and Y (K6, below).
// X is read only through cols, so nb_cols never enters the kernel: a
// square operator has nb_cols = nb, a rectangular row panel (one rank's
// block-rows of a row-sharded operator) any nb_cols.  The caller checks
// the range of cols; every offset into X, (cols*bs + b)*r + c, is formed
// in 64 bits.
//
// Replaces the Pallas TPU kernel `_spmv_kernel` of
// dominantsparseeigenad_tpu/ops/pallas_spmv.py for its SpMM entry
// `bell_spmm` (K3), which `BellOperator.matmat` calls for the block
// solvers (LOBPCG, the batched deflated CG and MINRES of the block
// backward, the KPM probe blocks, vmap of the matvec), on a square
// operator and on a row panel (K4a, from
// `RowShardedBellOperator._panel_spmv` of
// dominantsparseeigenad_tpu/parallel/sharded_sparse.py).
//
// What bounds it on an H100: the value stream.  Each value serves all r
// columns, 2 r flops against 4 bytes (f32) or 2 (bf16): the bound is
// bytes / memory bandwidth up to r ~ 40 (f32; ~20 for bf16 values),
// though at r = 32 (f32) or 16 (bf16) the float rate, 67 TFLOP/s outside
// the tensor cores, is within 25% of it, so the instructions around each
// FMA count.  The tensor cores are out: TF32 would round the operands,
// and a bf16 product would round the float X.  One pass over the values
// for all the columns is necessary: a second pass alone costs as much as
// the bound.
//
// Two bodies, picked by r:
//
// * r <= 4, the narrow body (bell_spmm_narrow_kernel).  One thread block
//   per slab of rows of block-row i (up to 8 warps), looping over the
//   block-row's mb slots itself: no atomics, Y is written once (the TPU
//   grid carried the partial Y across sequential grid steps in VMEM; CUDA
//   blocks run in no order, so the slot loop runs inside the block).
//   Values go straight from device memory to registers: each group of G
//   lanes reads TR rows of a value block (8 for float values, 4 for
//   bfloat16) with 16-byte loads along b, all issued before the products.
//   The X segments of a tile of slots are staged in shared memory,
//   transposed to (slot, column, b) with a padded row, so the lanes,
//   which walk b, read consecutive 16-byte words; each X word serves TR
//   rows.  Each thread keeps 6-8 staging loads in flight, so the gather
//   costs a few latencies a tile, not one an element.  Each lane keeps
//   TR x RC partial sums (RC = 4 columns), reduced over its G lanes with
//   warp shuffles once, at the end.  Its shared-memory reads cost
//   4 RC / TR bytes a value and its sums TR x RC registers, so it does
//   not widen: at RC = 16 the sums spill or, with TR cut to 4, the X
//   reads (16 bytes a value) come close to what the SM's shared memory
//   delivers at the bound for bf16 values.  It keeps r <= 4, where it
//   reaches 0.89 of its bound (f32, config #5) and the wide body with 8
//   columns a warp took 8% (f32) and 6% (bf16) longer; at r = 8 that
//   wide body is 3-8% (f32) and 25% (bf16) faster, so r = 8 goes wide
//   (H100, timed in turns).
//
// * r > 4, the wide body (bell_spmm_wide_kernel): one pass over the
//   values for up to 32 columns; wider blocks go in passes of 32 columns
//   (gridDim.y), each streaming the values again.  One block of 8 warps
//   per 128-row slab of block-row i, two blocks an SM.
//   - Values go through shared memory.  A stage is one slot's 128 rows x
//     128 bytes (32 floats or 64 bfloat16 along b) and the matching
//     (32 or 64) x RC floats of its X segment, copied by cp.async (16
//     bytes each, no registers held) into a ring of 4 stages: three are
//     in flight while the block computes on the fourth, which hides the
//     memory latency with no loads in registers and overlaps the X
//     staging that the narrow body does not.  Reading 128 bytes of each
//     row a stage keeps the device-memory accesses whole lines.
//   - Lanes walk rows: lane l owns rows l, l+32, l+64, l+96 (4 rows) and
//     CW columns (8 up to r = 8, else 16: 64 partial sums).  It reads
//     each value 16 bytes at a time from its own row (rows padded to 144
//     bytes, so the 8 lanes of a 16-byte access phase hit distinct banks)
//     and each X float4 of row b as a broadcast (one access serves the
//     warp): per b, 4 + CW/4 accesses for 4 x CW FMAs.
//   - The 8 warps split a stage's 128 bytes of b between them (KG groups)
//     and, at r > 16, the 32 columns into two groups of 16 (CG = 2,
//     KG = 4), so every warp reads every stage; no cross-lane reduction
//     in the loop.  At the end the KG partial tiles meet in shared memory
//     and are summed in a fixed order, and Y is written once, coalesced.
//   - Values go in 16-byte copies where they are 16-byte aligned and bs
//     is a multiple of the 16-byte width, X where it is 16-byte aligned
//     and r a multiple of 4; otherwise by plain loads and 4-byte copies
//     into the same layout (separate instantiations).  A ragged r, b or
//     row range reads zeros and writes only the valid outputs.
//   - Its staging loops have trip counts known at compile time (or stay
//     rolled), so no loop-invariant offsets stay live beside the sums: at
//     128 registers (two blocks an SM) ptxas spills nothing.
//   On config #5 (H100) it reaches 0.77 of its bound at r = 16 and 0.57
//   at r = 32 (f32), 0.57-0.59 at r = 16 with bf16 values; there the
//   instruction issue (the FMAs and the X reads), not the memory, binds.
//
// Both bodies sum each output in an order that depends only on (j, b)
// and r, never on the block's position or on where a slot's column comes
// from: a panel gives the square product's rows and the banded mode the
// gather mode's Y, bit for bit.
//
// Banded mode (K4b): the same kernel bodies for the banded slot plan of
// `_spmv_kernel` (pallas_spmv.py:161; its slab DMAs :211-258).  Where a
// slot's plan entry band_off[j] = o is >= 0, the staging takes the slot's
// block-column from (i + o) % nb and never reads cols; a slot with -1
// reads cols as in the gather mode.  On the TPU a band let one slab DMA
// fetch the X segments of a row group of G block-rows instead of G row
// gathers.  Here a block owns (a slab of rows of) one block-row and loads
// its own indices, so the band mode removes the cols read and makes the
// X segments that neighbouring blocks stage contiguous.
//
// Complex64 values (K6): the JAX package multiplies complex blocks by an
// (N, r) block on its XLA path only (`BellOperator.matmat`,
// ops/sparse.py:364-382; the panels of `RowShardedBellOperator`,
// parallel/sharded_sparse.py:206); its Pallas kernel has no complex
// dtype.  The wide body runs them for every r, with T = float2: X and Y
// are (N, 2r) floats (re and im interleaved), so the X staging, the
// partial tiles and the write of Y are the float body's on 2r float
// columns, and a stage's 128 bytes of a row are 16 complex values.  The
// products take each value as (re, im) and each float4 of an X row as two
// complex columns, 4 FMAs a column (the negation folds into the FMA).  A
// warp owns 16 float columns (8 complex) except at r <= 4 (4 complex),
// so the sums are the float body's 64 registers; the column groups are 1,
// 2 and, at r > 16, 4 (KG = 2 warps along b), so one pass takes up to 32
// complex columns with the same shared memory as the float body's 32 (a
// stage holds half the b, so an X stage is the same 4 KB).  What bounds
// it: the value stream up to r ~ 20, beyond that the FMAs (8 r flops a
// complex value over 67 TFLOP/s).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// ---- The narrow body (r <= 4) ----

// Rows per lane group: 8 for float values; 4 for bfloat16, whose 16-byte
// loads carry 8 values, so that the unpacked values, the sums and the
// loads fit in 128 registers (two blocks per SM).
template <typename T>
struct RowsPerGroup {
  static constexpr int value = sizeof(T) == 4 ? 8 : 4;
};
constexpr int MAX_WARPS = 8;
// Staging loads in flight per thread: 8, and 6 for bfloat16 values at
// RC = 4, where 8 made ptxas spill the tile counter (its register target
// there is 64-80) and 6 costs no time (timed on an H100 at config #5).
template <typename T, int RC>
struct StagingLoads {
  static constexpr int value = sizeof(T) == 2 && RC == 4 ? 6 : 8;
};
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
bell_spmm_narrow_kernel(const T* __restrict__ vals,
                        const int* __restrict__ cols,
                        const int* __restrict__ band_off,
                        const float* __restrict__ X, float* __restrict__ Y,
                        long long nb, int mb, int bs, int r, int G,
                        int slabs, int ld, int jt) {
  constexpr int TR = RowsPerGroup<T>::value;
  constexpr int SB = StagingLoads<T, RC>::value;
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
int launch_narrow(const void* vals, const void* cols, const void* band_off,
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
        bell_spmm_narrow_kernel<T, VEC, RC, BANDED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)(nb * slabs), (unsigned)((r + RC - 1) / RC));
  bell_spmm_narrow_kernel<T, VEC, RC, BANDED>
      <<<grid, warps * 32, smem, stream>>>(
      (const T*)vals, (const int*)cols, (const int*)band_off,
      (const float*)X, (float*)Y, nb, mb, bs, r, G, slabs, ld, jt);
  return (int)cudaGetLastError();
}

// ---- The wide body (r > 4) ----

constexpr int NT = 256;               // threads of a block
constexpr int NW = NT / 32;
constexpr int LANE_ROWS = 4;          // rows a lane owns
constexpr int ROWS = 32 * LANE_ROWS;  // rows of a block (its slab)
constexpr int ROW_CHUNKS = 8;         // 16-byte chunks of a row a stage
constexpr int LDV = ROW_CHUNKS + 1;   // a staged row, in chunks (odd)

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Value k of a 16-byte chunk, as float (a bfloat16 is the top half of
// its float).
__device__ __forceinline__ float chunk_value(const uint4& w, int k,
                                            const float*) {
  const unsigned u = k == 0 ? w.x : k == 1 ? w.y : k == 2 ? w.z : w.w;
  return __uint_as_float(u);
}

__device__ __forceinline__ float chunk_value(const uint4& w, int k,
                                            const __nv_bfloat16*) {
  const int h = k >> 1;
  const unsigned u = h == 0 ? w.x : h == 1 ? w.y : h == 2 ? w.z : w.w;
  return __uint_as_float(k & 1 ? u & 0xffff0000u : u << 16);
}

__device__ __forceinline__ void store_zero(float* p) { *p = 0.f; }
__device__ __forceinline__ void store_zero(__nv_bfloat16* p) {
  *p = __float2bfloat16(0.f);
}
__device__ __forceinline__ void store_zero(float2* p) {
  *p = make_float2(0.f, 0.f);
}

// Complex value k (0 or 1) of a 16-byte chunk of complex64 values.
__device__ __forceinline__ float2 chunk_complex(const uint4& w, int k) {
  return k == 0 ? make_float2(__uint_as_float(w.x), __uint_as_float(w.y))
                : make_float2(__uint_as_float(w.z), __uint_as_float(w.w));
}

// Floats a column of X and Y: 1, or 2 for complex64 (re, im).
template <typename T>
struct ColFloats {
  static constexpr int value = 1;
};
template <>
struct ColFloats<float2> {
  static constexpr int value = 2;
};

// CW columns a warp owns, CG warps side by side along the columns; for
// complex64 values columns are float columns (two a complex column).
template <typename T, int CW, int CG>
struct Wide {
  static constexpr int CH = 16 / (int)sizeof(T);   // values a chunk
  static constexpr int BK = ROW_CHUNKS * CH;       // b a stage
  static constexpr int RC = CW * CG;               // columns a pass
  static constexpr int KG = NW / CG;               // warps along b
  static constexpr int CPW = ROW_CHUNKS / KG;      // chunks a warp a stage
  static constexpr int LDR = RC + 4;               // a partial row (odd
                                                   // in float4s)
  static constexpr int VAL_BYTES = ROWS * LDV * 16;
  static constexpr int STAGE_BYTES = VAL_BYTES + BK * RC * 4;
  static constexpr int STAGES = 4;                 // the ring of stages
  static constexpr int RING_BYTES = STAGES * STAGE_BYTES;
  static constexpr int RED_BYTES = KG * ROWS * LDR * 4;
  static constexpr int SMEM =
      RING_BYTES > RED_BYTES ? RING_BYTES : RED_BYTES;
};

// Grid: (nb * slabs, ceil(r / RC)); NT threads.  VASYNC: values staged
// by 16-byte cp.async (bs a multiple of CH, values 16-byte aligned), else
// by plain loads.  XVEC: X staged by 16-byte cp.async (r % 4 == 0, X
// 16-byte aligned), else by 4-byte ones.  The same layout either way.
// BANDED: as in the narrow body.  X, Y and r count float columns: for
// complex64 values r is twice the complex columns.
template <typename T, bool VASYNC, bool XVEC, int CW, int CG, bool BANDED>
__global__ void __launch_bounds__(NT, 2)
bell_spmm_wide_kernel(const T* __restrict__ vals,
                      const int* __restrict__ cols,
                      const int* __restrict__ band_off,
                      const float* __restrict__ X, float* __restrict__ Y,
                      long long nb, int mb, int bs, int r, int slabs) {
  using W = Wide<T, CW, CG>;
  constexpr int CH = W::CH, BK = W::BK, RC = W::RC, KG = W::KG;
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const long long i = blockIdx.x / slabs;
  const int a0 = (int)(blockIdx.x - i * slabs) * ROWS;
  const int c0 = blockIdx.y * RC;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int cg = warp % CG;             // the warp's column group
  const int kg = warp / CG;             // and its share of each stage
  const int nkc = (bs + BK - 1) / BK;   // stages a slot
  const int n_stages = mb * nkc;
  const long long blk = (long long)bs * bs;
  const T* vals_i = vals + i * mb * blk;
  const int* cols_i = cols + i * mb;

  // This thread's share of a stage's values: rows vrow + VSTEP u of the
  // slab, 16-byte chunk vq of the stage's 128 bytes of each row.
  constexpr int VSTEP = NT / ROW_CHUNKS;
  constexpr int VN = ROWS / VSTEP;
  const int vrow = tid / ROW_CHUNKS, vq = tid % ROW_CHUNKS;
  const T* vsrc = vals_i + (long long)(a0 + vrow) * bs + vq * CH;
  const int vdst = (vrow * LDV + vq) * 16;

  // Copy stage s (slot s / nkc, b from (s % nkc) * BK) into its buffer.
  auto stage = [&](int s) {
    char* st = smem + (s % W::STAGES) * W::STAGE_BYTES;
    float* sx = reinterpret_cast<float*>(st + W::VAL_BYTES);
    const int j = s / nkc;
    const int b0 = (s - j * nkc) * BK;
    int col;
    if constexpr (BANDED) {
      const int o = __ldg(band_off + j);
      col = o < 0 ? __ldg(cols_i + j)
                  : (int)(i + o < nb ? i + o : i + o - nb);
    } else {
      col = __ldg(cols_i + j);
    }
    const T* g = vsrc + (long long)j * blk + b0;
    const bool bok = b0 + vq * CH < bs;
    // Inputs the 16-byte copies do not take (ragged or unaligned) go by
    // plain loads and 4-byte copies, in loops kept rolled: few registers.
    if constexpr (VASYNC) {
#pragma unroll
      for (int u = 0; u < VN; ++u) {
        const bool ok = bok && a0 + vrow + u * VSTEP < bs;
        cp_async16(st + vdst + u * VSTEP * LDV * 16,
                   ok ? g + (long long)u * VSTEP * bs : vals, ok);
      }
    } else {
#pragma unroll 1
      for (int u = 0; u < VN; ++u) {
        const bool ok = bok && a0 + vrow + u * VSTEP < bs;
        T* d = reinterpret_cast<T*>(st + vdst + u * VSTEP * LDV * 16);
        const T* gu = g + (long long)u * VSTEP * bs;
#pragma unroll
        for (int k = 0; k < CH; ++k) {
          if (ok && b0 + vq * CH + k < bs)
            d[k] = gu[k];
          else
            store_zero(d + k);
        }
      }
    }
    // X: BK rows of RC columns.
    const float* xg = X + ((long long)col * bs + b0) * r + c0;
    if constexpr (XVEC) {
      constexpr int NC = BK * RC / 4;   // 16-byte copies
#pragma unroll
      for (int u = 0; u < (NC + NT - 1) / NT; ++u) {
        const int e = tid + u * NT;
        if (NC % NT != 0 && e >= NC) break;
        const int k = e / (RC / 4), c = e % (RC / 4) * 4;
        const bool ok = b0 + k < bs && c0 + c < r;
        cp_async16(sx + k * RC + c, ok ? xg + (long long)k * r + c : X, ok);
      }
    } else {
#pragma unroll 1
      for (int e = tid; e < BK * RC; e += NT) {
        const int k = e / RC, c = e % RC;
        const bool ok = b0 + k < bs && c0 + c < r;
        cp_async4(sx + k * RC + c, ok ? xg + (long long)k * r + c : X, ok);
      }
    }
  };

  float acc[LANE_ROWS][CW];
#pragma unroll
  for (int t = 0; t < LANE_ROWS; ++t)
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[t][c] = 0.f;

  for (int s = 0; s < W::STAGES - 1; ++s) {
    if (s < n_stages) stage(s);
    cp_async_commit();
  }
  for (int s = 0; s < n_stages; ++s) {
    // Stage s has landed (this thread's copies), and after the barrier
    // everyone's; everyone is also done with stage s - 1, whose buffer
    // takes stage s + STAGES - 1.
    cp_async_wait<W::STAGES - 2>();
    __syncthreads();
    if (s + W::STAGES - 1 < n_stages) stage(s + W::STAGES - 1);
    cp_async_commit();
    const char* st = smem + (s % W::STAGES) * W::STAGE_BYTES;
    const float* sx =
        reinterpret_cast<const float*>(st + W::VAL_BYTES) + cg * CW;
    // One chunk at a time: its values and one row of X in registers.
#pragma unroll 1
    for (int u = 0; u < W::CPW; ++u) {
      const int q = kg * W::CPW + u;
      uint4 raw[LANE_ROWS];
#pragma unroll
      for (int t = 0; t < LANE_ROWS; ++t)
        raw[t] = *reinterpret_cast<const uint4*>(
            st + ((lane + 32 * t) * LDV + q) * 16);
#pragma unroll
      for (int k = 0; k < CH; ++k) {
        const float* xk = sx + (q * CH + k) * RC;
        if constexpr (ColFloats<T>::value == 1) {
          float v[LANE_ROWS];
#pragma unroll
          for (int t = 0; t < LANE_ROWS; ++t)
            v[t] = chunk_value(raw[t], k, (const T*)nullptr);
#pragma unroll
          for (int c4 = 0; c4 < CW / 4; ++c4) {
            const float4 x4 =
                *reinterpret_cast<const float4*>(xk + 4 * c4);
#pragma unroll
            for (int t = 0; t < LANE_ROWS; ++t) {
              acc[t][4 * c4] = fmaf(v[t], x4.x, acc[t][4 * c4]);
              acc[t][4 * c4 + 1] = fmaf(v[t], x4.y, acc[t][4 * c4 + 1]);
              acc[t][4 * c4 + 2] = fmaf(v[t], x4.z, acc[t][4 * c4 + 2]);
              acc[t][4 * c4 + 3] = fmaf(v[t], x4.w, acc[t][4 * c4 + 3]);
            }
          }
        } else {
          // Complex: a float4 of X is two complex columns, (x, y) and
          // (z, w); the sums hold (re, im) of each.
          float2 v[LANE_ROWS];
#pragma unroll
          for (int t = 0; t < LANE_ROWS; ++t) v[t] = chunk_complex(raw[t], k);
#pragma unroll
          for (int c4 = 0; c4 < CW / 4; ++c4) {
            const float4 x4 =
                *reinterpret_cast<const float4*>(xk + 4 * c4);
#pragma unroll
            for (int t = 0; t < LANE_ROWS; ++t) {
              float* a = acc[t] + 4 * c4;
              a[0] = fmaf(v[t].x, x4.x, a[0]);
              a[0] = fmaf(-v[t].y, x4.y, a[0]);
              a[1] = fmaf(v[t].x, x4.y, a[1]);
              a[1] = fmaf(v[t].y, x4.x, a[1]);
              a[2] = fmaf(v[t].x, x4.z, a[2]);
              a[2] = fmaf(-v[t].y, x4.w, a[2]);
              a[3] = fmaf(v[t].x, x4.w, a[3]);
              a[3] = fmaf(v[t].y, x4.z, a[3]);
            }
          }
        }
        // A compiler fence: the next b's loads stay after this point,
        // one row of X in registers at a time (2-3% faster with bf16
        // values at r = 16, config #5, H100).
        asm volatile("" ::: "memory");
      }
    }
  }

  // The KG partial tiles meet in shared memory (the ring is free once
  // every copy has landed and every warp is past its last stage) and are
  // summed in the order kg = 0, 1, ...
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int t = 0; t < LANE_ROWS; ++t)
#pragma unroll
    for (int c4 = 0; c4 < CW / 4; ++c4)
      *reinterpret_cast<float4*>(
          red + (kg * ROWS + lane + 32 * t) * W::LDR + cg * CW + 4 * c4) =
          make_float4(acc[t][4 * c4], acc[t][4 * c4 + 1], acc[t][4 * c4 + 2],
                      acc[t][4 * c4 + 3]);
  __syncthreads();
  for (int e = tid; e < ROWS * RC; e += NT) {
    const int row = e / RC, c = e % RC;
    const int a = a0 + row;
    if (a >= bs || c0 + c >= r) continue;
    float sum = red[row * W::LDR + c];
#pragma unroll
    for (int g = 1; g < KG; ++g) sum += red[(g * ROWS + row) * W::LDR + c];
    Y[(i * bs + a) * r + c0 + c] = sum;
  }
}

template <typename T, bool VASYNC, bool XVEC, int CW, int CG, bool BANDED>
int launch_wide(const void* vals, const void* cols, const void* band_off,
                const void* X, void* Y, long long nb, int mb, int bs, int r,
                cudaStream_t stream) {
  using W = Wide<T, CW, CG>;
  auto kernel = bell_spmm_wide_kernel<T, VASYNC, XVEC, CW, CG, BANDED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, W::SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const int slabs = (bs + ROWS - 1) / ROWS;
  const dim3 grid((unsigned)(nb * slabs), (unsigned)((r + W::RC - 1) / W::RC));
  kernel<<<grid, NT, W::SMEM, stream>>>(
      (const T*)vals, (const int*)cols, (const int*)band_off,
      (const float*)X, (float*)Y, nb, mb, bs, r, slabs);
  return (int)cudaGetLastError();
}

// The warp's columns by r (float columns): 8 up to r = 8, 16 up to 16,
// 16 in two groups (passes of 32) beyond; for complex64 values, in four
// groups (passes of 64 float columns, 32 complex) beyond 32.
template <typename T, bool VASYNC, bool XVEC, bool BANDED>
int launch_wide_r(const void* vals, const void* cols, const void* band_off,
                  const void* X, void* Y, long long nb, int mb, int bs,
                  int r, cudaStream_t s) {
  if constexpr (ColFloats<T>::value == 2) {
    if (r > 32)
      return launch_wide<T, VASYNC, XVEC, 16, 4, BANDED>(
          vals, cols, band_off, X, Y, nb, mb, bs, r, s);
  }
  if (r > 16)
    return launch_wide<T, VASYNC, XVEC, 16, 2, BANDED>(
        vals, cols, band_off, X, Y, nb, mb, bs, r, s);
  if (r > 8)
    return launch_wide<T, VASYNC, XVEC, 16, 1, BANDED>(
        vals, cols, band_off, X, Y, nb, mb, bs, r, s);
  return launch_wide<T, VASYNC, XVEC, 8, 1, BANDED>(vals, cols, band_off, X,
                                                    Y, nb, mb, bs, r, s);
}

// ---- Dispatch ----

template <typename T, int VEC, bool BANDED>
int launch(const void* vals, const void* cols, const void* band_off,
           const void* X, void* Y, long long nb, int mb, int bs, int r,
           int device, void* stream) {
  // The library carries its own CUDA runtime: bind it to the caller's
  // device so the launch goes to the context that owns `stream`.
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  // Complex64 values take the wide body at every r.
  if constexpr (ColFloats<T>::value == 1) {
    if (r <= 4)
      return launch_narrow<T, VEC, 4, BANDED>(vals, cols, band_off, X, Y,
                                              nb, mb, bs, r, s);
  }
  const int rf = r * ColFloats<T>::value;   // float columns of X and Y
  if constexpr (VEC > 1) {
    if (rf % 4 == 0 && (reinterpret_cast<uintptr_t>(X) & 15) == 0)
      return launch_wide_r<T, true, true, BANDED>(vals, cols, band_off, X, Y,
                                                  nb, mb, bs, rf, s);
    return launch_wide_r<T, true, false, BANDED>(vals, cols, band_off, X, Y,
                                                 nb, mb, bs, rf, s);
  }
  return launch_wide_r<T, false, false, BANDED>(vals, cols, band_off, X, Y,
                                                nb, mb, bs, rf, s);
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

template <bool BANDED>
int launch_c64(const void* vals, const void* cols, const void* band_off,
               const void* X, void* Y, long long nb, int mb, int bs, int r,
               int vec, int device, void* stream) {
  if (vec == 2)
    return launch<float2, 2, BANDED>(vals, cols, band_off, X, Y, nb, mb, bs,
                                     r, device, stream);
  return launch<float2, 1, BANDED>(vals, cols, band_off, X, Y, nb, mb, bs, r,
                                   device, stream);
}

}  // namespace

// Plain C entry points for ctypes.  `vec` is the vector width the caller
// checked the block size and the values' alignment for (16 bytes of
// values: 4 floats, 8 bfloat16 or 2 complex64; or 1); `r` counts the
// columns of X (complex ones for the complex64 entries); `band_off` the
// banded entries' plan, (mb,) int32 on the device.  Each returns
// cudaGetLastError() after the launch (0 = launched).
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

// Complex64 values, X and Y (K6).
extern "C" int bell_spmm_c64(const void* vals, const void* cols,
                             const void* X, void* Y, long long nb, int mb,
                             int bs, int r, int vec, int device,
                             void* stream) {
  return launch_c64<false>(vals, cols, nullptr, X, Y, nb, mb, bs, r, vec,
                           device, stream);
}

extern "C" int bell_spmm_banded_c64(const void* vals, const void* cols,
                                    const void* band_off, const void* X,
                                    void* Y, long long nb, int mb, int bs,
                                    int r, int vec, int device,
                                    void* stream) {
  return launch_c64<true>(vals, cols, band_off, X, Y, nb, mb, bs, r, vec,
                          device, stream);
}
