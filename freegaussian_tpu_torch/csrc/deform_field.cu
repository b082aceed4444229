// The field MLPs of the deform and control fields in one kernel pair: the
// in-kernel NeRF embedding of one or two 3-vector sources plus a broadcast
// time row, the 8x256 bf16 ReLU trunk with its skip after layer 4, and one of
// two outputs (the template flag HEADS):
//   HEADS   the four deform heads packed as 13 f32 lanes
//           [w (3) | v (3) | rotation (4) | scaling (3)]
//   !HEADS  the trunk's last activation h (N, 256) bf16; the caller runs its
//           heads in f32. In training h is the last saved activation, so
//           it is written once, there.
//
// Replaces the TPU kernels freegaussian_tpu/ops/mlp_pallas.py:
//   _fused_field_heads_fwd (body _field_fwd_kernel_heads) -> field_fwd, HEADS
//   _fused_field_heads_bwd (body _field_bwd_kernel_heads) -> field_bwd, HEADS
//   _fused_field_fwd       (body _field_fwd_kernel)       -> field_fwd, !HEADS
//   _fused_field_bwd       (body _field_bwd_kernel)       -> field_bwd, !HEADS
// and computes what they compute, per row of S sources x (N, 3 S) with one
// shared time row:
//   emb  = [x_0, sin(2^0 x_0), cos(2^0 x_0), ..., cos(2^(L-1) x_0) | x_1 ... |
//           t_row | 0]                                   (128 lanes)
//   h_0  = relu(emb @ W0 + b0);  h_i = relu(h_{i-1} @ W_i + b_i), except
//   h_5  = relu([emb | h_4] @ W5 + b5)
//   y    = h_7 @ HW + HB                      (HEADS: f32 heads)
// Source s takes lanes [s X, (s + 1) X) with X = 3 (1 + 2 L), the time row
// the S X lanes after them: the deform field is S = 1 with the timenet's 30
// lanes, the control field S = 2 (position, control value) without a time
// row (126 lanes). Matrix products take bf16 operands with f32 accumulation
// (tensor cores, WMMA 16x16x16), the bias and ReLU run in f32 and each
// activation is stored as bf16: the numerics of mlp_pallas.py (_mm,
// _forward_acts). The heads run in f32 on the CUDA cores, as the Pallas
// kernel runs them at HIGHEST.
//
// The backward takes dy (N, 13) f32 (HEADS) or dh (N, 256) f32 (!HEADS) and
// gives dx (N, 3 S), the row sum of d emb (the shared time row's gradient is
// its t lanes), every weight and bias gradient in f32. Per layer, top down:
// g = (g_above @ W^T) * (h > 0); db = sum of g (f32); dW = h_below^T bf16(g);
// the products take bf16(g), as _mm_nt / _mm_tn do.
//
// Design. The TPU kernel walks row blocks in order and keeps the weight
// gradients resident across its sequential grid; here blocks run in parallel,
// so the work is split in three launches:
//   field_fwd_kernel    one block of 64 rows runs the embedding, the trunk
//                       (activations ping-pong in shared memory, weights read
//                       through L2) and the heads or the h store. In training
//                       it also writes the bf16 embedding and the eight
//                       activations (4.35 KB a row), which the backward reads
//                       instead of recomputing.
//   field_dgrad_kernel  one block of 64 rows walks the layers top down and
//                       writes each layer's masked gradient bf16(g) (the
//                       operand of its weight gradient), the small f32 sums
//                       (biases, heads, time row) by atomics, and dx.
//   field_wgrad_kernel  dW = h_below^T bf16(g) for all eight layers: one block
//                       per (layer, 128 x 32 tile of dW, share of the rows),
//                       each writing its partial sum; the wrapper adds the
//                       shares in a fixed order.
// Bound on an H100: ~1.0e11 bf16 tensor operations per forward at N = 1e5
// (2.1e11 backward) against ~0.46 GB of saved-activation traffic in
// training; chip_smoke.py prints both bounds from its own run. This first
// version reads the weights' WMMA tiles straight from L2 and keeps one block
// of 64 rows per SM pass: wgmma, TMA staging and a persistent schedule are
// later work.
//
// sinf / cosf, never __sinf: with -fmad=false the scaled argument (a power of
// two times x, exact) reaches the thousands at 2^9, where the fast intrinsic
// loses its accuracy.
//
// Plain C interface (loaded with ctypes); launches on the caller's stream,
// allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int H = 256;        // trunk width
constexpr int DEPTH = 8;      // trunk layers
constexpr int SKIP_IN = 5;    // the layer that takes [emb | h_4]
constexpr int EMB = 128;      // embedding lanes (source lanes + time lanes, zero padded)
constexpr int MAX_SRC = 2;    // 3-vector sources per row
constexpr int NOUT = 13;      // packed head outputs
constexpr int ROWS = 64;      // rows of one block
constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int XBYTES = ROWS * 3 * MAX_SRC * 4 + 512;  // the block's source rows, rounded to 2 KB
constexpr int LDE = EMB + 8;  // shared-memory row strides (bf16 / f32 elements)
constexpr int LDA = H + 8;
constexpr int LDS = EMB + 8;
constexpr int WG_O = 128;     // weight-gradient tile: output rows x input columns
constexpr int WG_K = 32;
constexpr int LDG = WG_O + 8;
constexpr int LDI = WG_K + 8;

__host__ __device__ constexpr int layer_k(int i) { return i == 0 ? EMB : (i == SKIP_IN ? EMB + H : H); }

__host__ __device__ constexpr long layer_off(int i) {
    long o = 0;
    for (int j = 0; j < i; ++j) o += (long)H * layer_k(j);
    return o;
}

__host__ __device__ constexpr int wgrad_tiles(int i) { return (H / WG_O) * (layer_k(i) / WG_K); }

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;

template <typename L>
__device__ __forceinline__ const bf16* btile(const bf16* B, int ldb, int k0, int n0);
template <>
__device__ __forceinline__ const bf16* btile<wmma::col_major>(const bf16* B, int ldb, int k0, int n0) {
    return B + (size_t)n0 * ldb + k0;  // B(k, n) = W[n][k]: the forward's W^T
}
template <>
__device__ __forceinline__ const bf16* btile<wmma::row_major>(const bf16* B, int ldb, int k0, int n0) {
    return B + (size_t)k0 * ldb + n0;  // B(k, n) = W[k][n]: the backward's W
}

// acc[r][t] += A[r-th 16 rows, :kdim] @ B[:kdim, n0 + 16 t ...]: A is the
// block's 64 rows in shared memory, B a weight in global memory (L2).
template <typename L, int NT>
__device__ __forceinline__ void gemm64(Acc (&acc)[4][NT], const bf16* sA, int lda, int kdim,
                                       const bf16* B, int ldb, int n0) {
    for (int k0 = 0; k0 < kdim; k0 += 16) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, L> b[NT];
#pragma unroll
        for (int t = 0; t < NT; ++t) wmma::load_matrix_sync(b[t], btile<L>(B, ldb, k0, n0 + 16 * t), ldb);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
            wmma::load_matrix_sync(a, sA + r * 16 * lda + k0, lda);
#pragma unroll
            for (int t = 0; t < NT; ++t) wmma::mma_sync(acc[r][t], a, b[t], acc[r][t]);
        }
    }
}

template <int NT>
__device__ __forceinline__ void zero(Acc (&acc)[4][NT]) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int t = 0; t < NT; ++t) wmma::fill_fragment(acc[r][t], 0.0f);
}

// Hand every element of the warp's accumulators to f(row, col, value),
// through the warp's 16x16 f32 staging tile.
template <int NT, typename F>
__device__ __forceinline__ void epilogue(Acc (&acc)[4][NT], float* stage, int n0, int lane, F f) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int t = 0; t < NT; ++t) {
            wmma::store_matrix_sync(stage, acc[r][t], 16, wmma::mem_row_major);
            __syncwarp();
            for (int e = lane; e < 256; e += 32) f(r * 16 + (e >> 4), n0 + 16 * t + (e & 15), stage[e]);
            __syncwarp();
        }
}

// `rows` rows of `cols` bf16 between global memory (row stride ldg) and
// shared memory (row stride lds), 16 bytes a thread.
template <bool TO_SHARED>
__device__ __forceinline__ void copy_rows(bf16* smem, int lds, bf16* gmem, int ldg, int cols, int tid,
                                          int rows = ROWS) {
    const int per_row = cols / 8;
    for (int i = tid; i < rows * per_row; i += THREADS) {
        const int r = i / per_row, c = (i - r * per_row) * 8;
        uint4* s = (uint4*)(smem + r * lds + c);
        uint4* g = (uint4*)(gmem + (size_t)r * ldg + c);
        if (TO_SHARED) *s = *g;
        else *g = *s;
    }
}

// The block's source rows (ROWS x 3 S f32) into shared memory, zeros past n.
__device__ __forceinline__ void load_sources(float* s_x, const float* x, int row0, int n, int src, int tid) {
    const int xw = 3 * src;
    for (int i = tid; i < ROWS * xw; i += THREADS) s_x[i] = row0 + i / xw < n ? x[(size_t)row0 * xw + i] : 0.0f;
}

__device__ __forceinline__ float embed_lane(const float* xr, int lane, int src, int xl, const float* trow, int tl) {
    if (lane < src * xl) {
        const int s = lane / xl, l = lane - s * xl;
        const int c = l % 3, b = l / 3;
        const float v = xr[3 * s + c];
        if (b == 0) return v;
        const float a = v * (float)(1 << ((b - 1) >> 1));  // exact: a power of two
        return (b & 1) ? sinf(a) : cosf(a);
    }
    if (lane < src * xl + tl) return trow[lane - src * xl];
    return 0.0f;
}

__device__ __forceinline__ float relu(float v) { return v < 0.0f ? 0.0f : v; }  // keeps NaN, as torch.relu

constexpr size_t FWD_SMEM =
    XBYTES + sizeof(bf16) * (ROWS * LDE + 2 * ROWS * LDA) + sizeof(float) * (WARPS * 256 + NOUT * H);

template <bool HEADS>
__global__ void __launch_bounds__(THREADS)
field_fwd_kernel(const float* __restrict__ x,      // (N, 3 S)
                 int n, int src, int xl, const float* __restrict__ trow, int tl,
                 const bf16* __restrict__ wpack,   // packed trunk weights, layer i (256, K_i)
                 const float* __restrict__ bias,   // (8, 256)
                 const float* __restrict__ hw,     // (13, 256), HEADS only
                 const float* __restrict__ hb,     // (13,), HEADS only
                 void* __restrict__ out,           // y (N, 13) f32, or h (N, 256) bf16
                 bf16* __restrict__ emb_out,       // (N_pad, 128) or null
                 bf16* __restrict__ acts_out,      // (8, N_pad, 256) or null
                 int n_pad) {
    extern __shared__ __align__(128) unsigned char smem[];
    float* s_x = (float*)smem;
    bf16* s_emb = (bf16*)(smem + XBYTES);
    bf16* s_act0 = s_emb + ROWS * LDE;
    bf16* s_act1 = s_act0 + ROWS * LDA;
    float* s_stage = (float*)(s_act1 + ROWS * LDA);
    float* s_hw = s_stage + WARPS * 256;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int row0 = blockIdx.x * ROWS;
    float* stage = s_stage + warp * 256;

    load_sources(s_x, x, row0, n, src, tid);
    if (HEADS)
        for (int i = tid; i < NOUT * H; i += THREADS) s_hw[i] = hw[i];
    __syncthreads();
    for (int i = tid; i < ROWS * EMB; i += THREADS) {
        const int r = i / EMB, l = i - r * EMB;
        s_emb[r * LDE + l] = __float2bfloat16_rn(embed_lane(s_x + 3 * src * r, l, src, xl, trow, tl));
    }
    __syncthreads();
    if (emb_out) copy_rows<false>(s_emb, LDE, emb_out + (size_t)row0 * EMB, EMB, EMB, tid);

    bf16* cur = s_act0;
    bf16* nxt = s_act1;
    const int n0 = warp * 32;
    for (int i = 0; i < DEPTH; ++i) {
        Acc acc[4][2];
        zero(acc);
        const bf16* W = wpack + layer_off(i);
        const int K = layer_k(i);
        if (i == 0) {
            gemm64<wmma::col_major, 2>(acc, s_emb, LDE, EMB, W, K, n0);
        } else if (i == SKIP_IN) {
            gemm64<wmma::col_major, 2>(acc, s_emb, LDE, EMB, W, K, n0);
            gemm64<wmma::col_major, 2>(acc, cur, LDA, H, W + EMB, K, n0);
        } else {
            gemm64<wmma::col_major, 2>(acc, cur, LDA, H, W, K, n0);
        }
        const float* b = bias + i * H;
        epilogue(acc, stage, n0, lane, [&](int r, int c, float v) {
            nxt[r * LDA + c] = __float2bfloat16_rn(relu(v + b[c]));
        });
        __syncthreads();
        if (acts_out) copy_rows<false>(nxt, LDA, acts_out + ((size_t)i * n_pad + row0) * H, H, H, tid);
        bf16* tmp = cur;
        cur = nxt;
        nxt = tmp;
    }

    if (HEADS) {
        float* y = (float*)out;
        for (int o = tid; o < ROWS * NOUT; o += THREADS) {
            const int r = o / NOUT, j = o - r * NOUT;
            if (row0 + r >= n) continue;
            const bf16* hr = cur + r * LDA;
            const float* wj = s_hw + j * H;
            float s = 0.0f;
            for (int k = 0; k < H; ++k) s += __bfloat162float(hr[k]) * wj[k];
            y[(size_t)(row0 + r) * NOUT + j] = s + hb[j];
        }
    } else if (!acts_out) {  // in training h is acts_out[7], stored above
        const int rows = min(ROWS, n - row0);  // the last block's rows past n are padding
        if (rows > 0) copy_rows<false>(cur, LDA, (bf16*)out + (size_t)row0 * H, H, H, tid, rows);
    }
}

constexpr size_t DGRAD_SMEM =
    XBYTES + sizeof(float) * ROWS * 16 + sizeof(bf16) * 3 * ROWS * LDA + sizeof(float) * (ROWS * LDS + WARPS * 256 + H);

template <bool HEADS>
__global__ void __launch_bounds__(THREADS)
field_dgrad_kernel(const float* __restrict__ x, int n, int src, int xl,
                   const float* __restrict__ dout,   // dy (N, 13) (HEADS) or dh (N, 256)
                   const bf16* __restrict__ wpack, const float* __restrict__ hw,
                   const bf16* __restrict__ acts,    // (8, N_pad, 256)
                   int n_pad,
                   bf16* __restrict__ G,             // (8, N_pad, 256) out: bf16(g) per layer
                   float* __restrict__ dbias,        // (8, 256), accumulated
                   float* __restrict__ dhw,          // (13, 256), accumulated (HEADS)
                   float* __restrict__ dhb,          // (13,), accumulated (HEADS)
                   float* __restrict__ demb_sum,     // (128,), accumulated
                   float* __restrict__ dx) {         // (N, 3 S)
    extern __shared__ __align__(128) unsigned char smem[];
    float* s_x = (float*)smem;
    float* s_dy = (float*)(smem + XBYTES);
    bf16* s_g0 = (bf16*)(s_dy + ROWS * 16);
    bf16* s_g1 = s_g0 + ROWS * LDA;
    bf16* s_a = s_g1 + ROWS * LDA;
    float* s_demb = (float*)(s_a + ROWS * LDA);
    float* s_stage = s_demb + ROWS * LDS;
    float* s_db = s_stage + WARPS * 256;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int row0 = blockIdx.x * ROWS;
    float* stage = s_stage + warp * 256;

    load_sources(s_x, x, row0, n, src, tid);
    if (HEADS) {
        for (int i = tid; i < ROWS * 16; i += THREADS) {
            const int r = i >> 4, j = i & 15;
            s_dy[i] = (j < NOUT && row0 + r < n) ? dout[(size_t)(row0 + r) * NOUT + j] : 0.0f;
        }
    }
    copy_rows<true>(s_a, LDA, (bf16*)acts + ((size_t)(DEPTH - 1) * n_pad + row0) * H, H, H, tid);
    __syncthreads();

    // the top layer's g_7, one column per thread: HEADS, d HB, d HW = h_7^T
    // dy and g_7 = (dy @ HW) * (h_7 > 0); else g_7 = dh * (h_7 > 0)
    bf16* cur = s_g0;
    bf16* nxt = s_g1;
    {
        const int k = tid;
        float db = 0.0f;
        if (HEADS) {
            if (tid < NOUT) {
                float s = 0.0f;
                for (int r = 0; r < ROWS; ++r) s += s_dy[r * 16 + tid];
                atomicAdd(dhb + tid, s);
            }
            float hwk[NOUT], dacc[NOUT];
#pragma unroll
            for (int j = 0; j < NOUT; ++j) {
                hwk[j] = hw[j * H + k];
                dacc[j] = 0.0f;
            }
            for (int r = 0; r < ROWS; ++r) {
                const float a = __bfloat162float(s_a[r * LDA + k]);
                float g = 0.0f;
#pragma unroll
                for (int j = 0; j < NOUT; ++j) {
                    const float d = s_dy[r * 16 + j];
                    g += d * hwk[j];
                    dacc[j] += a * d;
                }
                g = g * (a > 0.0f ? 1.0f : 0.0f);
                db += g;
                cur[r * LDA + k] = __float2bfloat16_rn(g);
            }
#pragma unroll
            for (int j = 0; j < NOUT; ++j) atomicAdd(dhw + j * H + k, dacc[j]);
        } else {
            for (int r = 0; r < ROWS; ++r) {
                const float a = __bfloat162float(s_a[r * LDA + k]);
                const float d = row0 + r < n ? dout[(size_t)(row0 + r) * H + k] : 0.0f;
                const float g = d * (a > 0.0f ? 1.0f : 0.0f);
                db += g;
                cur[r * LDA + k] = __float2bfloat16_rn(g);
            }
        }
        atomicAdd(dbias + (DEPTH - 1) * H + k, db);
    }
    __syncthreads();
    copy_rows<false>(cur, LDA, G + ((size_t)(DEPTH - 1) * n_pad + row0) * H, H, H, tid);

    for (int i = DEPTH - 1; i >= 1; --i) {
        // mask source: the activation below this layer's input
        const int below = i - 1;
        copy_rows<true>(s_a, LDA, (bf16*)acts + ((size_t)below * n_pad + row0) * H, H, H, tid);
        s_db[tid] = 0.0f;
        __syncthreads();
        const bf16* W = wpack + layer_off(i);
        const int K = layer_k(i);
        const int hoff = i == SKIP_IN ? EMB : 0;
        const int n0 = warp * 32;
        Acc acc[4][2];
        zero(acc);
        gemm64<wmma::row_major, 2>(acc, cur, LDA, H, W + hoff, K, n0);
        epilogue(acc, stage, n0, lane, [&](int r, int c, float v) {
            v = v * (__bfloat162float(s_a[r * LDA + c]) > 0.0f ? 1.0f : 0.0f);
            atomicAdd(s_db + c, v);
            nxt[r * LDA + c] = __float2bfloat16_rn(v);
        });
        if (i == SKIP_IN && warp < EMB / 16) {
            // the skip's share of d emb: g_5 @ W5[:, :128]^T
            Acc sk[4][1];
            zero(sk);
            gemm64<wmma::row_major, 1>(sk, cur, LDA, H, W, K, warp * 16);
#pragma unroll
            for (int r = 0; r < 4; ++r)
                wmma::store_matrix_sync(s_demb + r * 16 * LDS + warp * 16, sk[r][0], LDS, wmma::mem_row_major);
        }
        __syncthreads();
        copy_rows<false>(nxt, LDA, G + ((size_t)below * n_pad + row0) * H, H, H, tid);
        atomicAdd(dbias + below * H + tid, s_db[tid]);
        bf16* tmp = cur;
        cur = nxt;
        nxt = tmp;
    }

    // layer 0: d emb = g_0 @ W0^T + the skip's share
    if (warp < EMB / 16) {
        Acc acc[4][1];
#pragma unroll
        for (int r = 0; r < 4; ++r)
            wmma::load_matrix_sync(acc[r][0], s_demb + r * 16 * LDS + warp * 16, LDS, wmma::mem_row_major);
        gemm64<wmma::row_major, 1>(acc, cur, LDA, H, wpack, EMB, warp * 16);
#pragma unroll
        for (int r = 0; r < 4; ++r)
            wmma::store_matrix_sync(s_demb + r * 16 * LDS + warp * 16, acc[r][0], LDS, wmma::mem_row_major);
    }
    __syncthreads();
    if (tid < EMB) {
        float s = 0.0f;
        for (int r = 0; r < ROWS; ++r) s += s_demb[r * LDS + tid];
        atomicAdd(demb_sum + tid, s);
    }
    // dx: lane (s, b, c) is x_sc, sin(f x_sc) or cos(f x_sc)
    const int xw = 3 * src;
    for (int i = tid; i < ROWS * xw; i += THREADS) {
        const int r = i / xw, sc = i - r * xw, s = sc / 3, c = sc - 3 * s;
        if (row0 + r >= n) continue;
        const float xv = s_x[i];
        const float* d = s_demb + r * LDS + s * xl;
        float acc = d[c];
        for (int b = 1; b < xl / 3; ++b) {
            const float f = (float)(1 << ((b - 1) >> 1));
            const float a = xv * f;
            const float deriv = (b & 1) ? cosf(a) : -sinf(a);
            acc += d[3 * b + c] * deriv * f;
        }
        dx[(size_t)(row0 + r) * xw + sc] = acc;
    }
}

constexpr size_t WGRAD_SMEM = sizeof(bf16) * ROWS * (LDG + LDI);

__global__ void __launch_bounds__(THREADS)
field_wgrad_kernel(const bf16* __restrict__ emb,   // (N_pad, 128)
                   const bf16* __restrict__ acts,  // (8, N_pad, 256)
                   const bf16* __restrict__ G,     // (8, N_pad, 256)
                   int n_pad, int rows_per_split,
                   float* __restrict__ partial) {  // (splits, packed weight size)
    extern __shared__ __align__(128) unsigned char smem[];
    bf16* s_g = (bf16*)smem;
    bf16* s_in = s_g + ROWS * LDG;
    const int tid = threadIdx.x, warp = tid >> 5;
    int t = blockIdx.x, i = 0;
    while (t >= wgrad_tiles(i)) t -= wgrad_tiles(i++);
    const int K = layer_k(i), nk = K / WG_K;
    const int o0 = (t / nk) * WG_O, k0 = (t % nk) * WG_K;
    // this tile's input columns: the embedding, or the activation below
    const bf16* src;
    int lds, col;
    if (i == 0 || (i == SKIP_IN && k0 < EMB)) {
        src = emb;
        lds = EMB;
        col = k0;
    } else {
        src = acts + (size_t)(i == SKIP_IN ? SKIP_IN - 1 : i - 1) * n_pad * H;
        lds = H;
        col = i == SKIP_IN ? k0 - EMB : k0;
    }
    const bf16* g = G + (size_t)i * n_pad * H;

    Acc acc[2];
    wmma::fill_fragment(acc[0], 0.0f);
    wmma::fill_fragment(acc[1], 0.0f);
    const int r_begin = blockIdx.y * rows_per_split;
    const int r_end = min(n_pad, r_begin + rows_per_split);
    for (int r0 = r_begin; r0 < r_end; r0 += ROWS) {
        __syncthreads();
        copy_rows<true>(s_g, LDG, (bf16*)g + (size_t)r0 * H + o0, H, WG_O, tid);
        copy_rows<true>(s_in, LDI, (bf16*)src + (size_t)r0 * lds + col, lds, WG_K, tid);
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < ROWS; kk += 16) {
            // A(o, r) = g[r][o]: the stored gradient read column-major
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
            wmma::load_matrix_sync(a, s_g + kk * LDG + warp * 16, LDG);
#pragma unroll
            for (int f = 0; f < 2; ++f) {
                wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
                wmma::load_matrix_sync(b, s_in + kk * LDI + f * 16, LDI);
                wmma::mma_sync(acc[f], a, b, acc[f]);
            }
        }
    }
    float* out = partial + (size_t)blockIdx.y * layer_off(DEPTH) + layer_off(i) + (size_t)(o0 + warp * 16) * K + k0;
    wmma::store_matrix_sync(out, acc[0], K, wmma::mem_row_major);
    wmma::store_matrix_sync(out + 16, acc[1], K, wmma::mem_row_major);
}

bool valid_lanes(int src, int xl, int tl) {
    return src >= 1 && src <= MAX_SRC && xl >= 3 && xl % 3 == 0 && (xl / 3) % 2 == 1 && tl >= 0 &&
           src * xl + tl <= EMB;
}

template <bool HEADS>
cudaError_t launch_fwd(const void* x, int n, int src, int xl, const void* trow, int tl, const void* wpack,
                       const void* bias, const void* hw, const void* hb, void* out, void* emb_out, void* acts_out,
                       int n_pad, cudaStream_t stream) {
    cudaFuncSetAttribute(field_fwd_kernel<HEADS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)FWD_SMEM);
    field_fwd_kernel<HEADS><<<n_pad / ROWS, THREADS, FWD_SMEM, stream>>>(
        (const float*)x, n, src, xl, (const float*)trow, tl, (const bf16*)wpack, (const float*)bias,
        (const float*)hw, (const float*)hb, out, (bf16*)emb_out, (bf16*)acts_out, n_pad);
    return cudaGetLastError();
}

template <bool HEADS>
cudaError_t launch_dgrad(const void* x, int n, int src, int xl, const void* dout, const void* wpack, const void* hw,
                         const void* acts, int n_pad, void* G, void* dbias, void* dhw, void* dhb, void* demb_sum,
                         void* dx, cudaStream_t stream) {
    cudaFuncSetAttribute(field_dgrad_kernel<HEADS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)DGRAD_SMEM);
    field_dgrad_kernel<HEADS><<<n_pad / ROWS, THREADS, DGRAD_SMEM, stream>>>(
        (const float*)x, n, src, xl, (const float*)dout, (const bf16*)wpack, (const float*)hw, (const bf16*)acts,
        n_pad, (bf16*)G, (float*)dbias, (float*)dhw, (float*)dhb, (float*)demb_sum, (float*)dx);
    return cudaGetLastError();
}

}  // namespace

extern "C" long field_packed_size() { return layer_off(DEPTH); }

// heads != 0: out is y (N, 13) f32 and hw / hb the packed heads; heads == 0:
// out is h (N, 256) bf16 and hw / hb are not read; with acts_out, h is its
// last layer and out is not written (it may be null).
extern "C" int field_fwd(int heads, const void* x, int n, int src, int xl, const void* trow, int tl,
                         const void* wpack, const void* bias, const void* hw, const void* hb, void* out,
                         void* emb_out, void* acts_out, int n_pad, void* stream) {
    // no early exit at n == 0: the padded rows (n_pad >= 64) still run, so
    // the saved tensors are written whatever n is
    if (!valid_lanes(src, xl, tl) || n_pad % ROWS != 0 || n_pad < n || n_pad == 0) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    return (int)(heads ? launch_fwd<true>(x, n, src, xl, trow, tl, wpack, bias, hw, hb, out, emb_out, acts_out, n_pad, s)
                       : launch_fwd<false>(x, n, src, xl, trow, tl, wpack, bias, hw, hb, out, emb_out, acts_out, n_pad, s));
}

// heads != 0: dout is dy (N, 13) and hw, dhw, dhb are the heads'; heads ==
// 0: dout is dh (N, 256) and those three are not touched.
extern "C" int field_bwd(int heads, const void* x, int n, int src, int xl, const void* dout, const void* wpack,
                         const void* hw, const void* emb, const void* acts, int n_pad, int splits, void* G,
                         void* dbias, void* dhw, void* dhb, void* demb_sum, void* dx, void* partial, void* stream) {
    // no early exit at n == 0: every split of the weight-gradient partials
    // is written (zeros then), since the wrapper sums them
    if (!valid_lanes(src, xl, 0) || n_pad % ROWS != 0 || n_pad < n || n_pad == 0 || splits < 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err = heads ? launch_dgrad<true>(x, n, src, xl, dout, wpack, hw, acts, n_pad, G, dbias, dhw, dhb,
                                                 demb_sum, dx, s)
                            : launch_dgrad<false>(x, n, src, xl, dout, wpack, hw, acts, n_pad, G, dbias, dhw, dhb,
                                                  demb_sum, dx, s);
    if (err != cudaSuccess) return (int)err;
    int tiles = 0;
    for (int i = 0; i < DEPTH; ++i) tiles += wgrad_tiles(i);
    const int chunks = n_pad / ROWS;
    const int rows_per_split = ((chunks + splits - 1) / splits) * ROWS;
    dim3 grid(tiles, splits);
    field_wgrad_kernel<<<grid, THREADS, WGRAD_SMEM, s>>>((const bf16*)emb, (const bf16*)acts, (const bf16*)G, n_pad,
                                                         rows_per_split, (float*)partial);
    return (int)cudaGetLastError();
}

extern "C" const char* field_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
