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
//   _pallas_fwd            (body _fwd_kernel)             -> field_fwd, !HEADS, S = 0
//   _fused_trunk_bwd       (body _bwd_kernel)             -> field_bwd, !HEADS, S = 0
// The last two take the embedding precomputed (S = 0: no sources, no time
// row): x is the (N, 128) f32 input [x_emb | t_emb | 0] of
// mlp_pallas.fused_trunk, rounded to bf16 lane by lane where the others
// compute their lanes, and the backward stops at d emb (N, 128) f32, written
// where the others write dx (the caller's autograd chains it further).
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
// (tensor cores: mma.sync m16n8k16 in both directions), the bias and ReLU
// run in f32 and each activation is stored as bf16: the numerics of
// mlp_pallas.py (_mm, _forward_acts). The heads run in f32 on the CUDA
// cores, as the Pallas kernel runs them at HIGHEST: w, v and theta form the
// SE(3) screw axis.
//
// The backward takes dy (N, 13) f32 (HEADS) or dh (N, 256) f32 (!HEADS) and
// gives dx (N, 3 S), the row sum of d emb (the shared time row's gradient is
// its t lanes), every weight and bias gradient in f32. Per layer, top down:
// g = (g_above @ W^T) * (h > 0); db = sum of g (f32); dW = h_below^T bf16(g);
// the products take bf16(g), as _mm_nt / _mm_tn do.
//
// Design. The TPU kernel walks row blocks in order and keeps the weight
// gradients resident across its sequential grid; here blocks run in parallel,
// so the work is split in three launches. Every block of the first two is
// 128 rows of 16 warps (2 x 8: 64 rows by 32 columns a warp) with one block
// an SM, and every product is mma.sync m16n8k16 on ldmatrix fragments, its
// weight staged 64 reduction rows (32 KB) at a time through a two-slice
// cp.async ring, the next slice in flight during this one's products: no
// operand is read from global memory inside the k loop.
//   field_fwd_kernel    runs the embedding (layer 0's first slice already in
//                       flight), then the eight layers as one stream of 32
//                       slices (the ring runs on across layers, so a layer's
//                       first slice loads during the last one's products).
//                       A layer's epilogue works from the accumulator
//                       registers: bias, ReLU and bf16 rounding, written in
//                       place over the block's one activation buffer once
//                       every warp has read it. In training the embedding
//                       and each activation (4.35 KB a row, which the
//                       backward reads instead of recomputing) leave by
//                       16-byte stores during the next layer's products.
//                       The heads (HEADS) read h_7 and the f32 head weights
//                       from shared memory: lanes own rows (32 a warp), each
//                       warp a quarter of the 256 k; h as 16-byte row chunks
//                       (the row stride is 132 words: 8 rows a phase fall on
//                       distinct banks), the weights as warp-wide broadcasts,
//                       13 f32 sums a lane; the quarters meet in shared
//                       memory and are added in a fixed order. 192,512
//                       bytes of shared memory.
//   field_dgrad_kernel  walks the layers top down (216,064 bytes of shared
//                       memory). A is the block's bf16(g), B the layer's
//                       weight; the next mask activation loads by cp.async
//                       during the products too. The epilogue masks, stores
//                       bf16(g) in place and sums columns by warp shuffles
//                       (no atomics); the layer's G leaves by 16-byte stores
//                       while the next layer's products run. The block's f32
//                       sums (biases, heads, d emb row sums) go to its own
//                       row of a scratch, added in a fixed order by the
//                       wrapper.
//   field_wgrad_kernel  dW = h_below^T bf16(g): one block per (layer, 256 x
//                       128 tile of dW, share of the rows): G and the input
//                       stream through a four-chunk cp.async ring (64 rows a
//                       chunk), the products in mma.sync with ldmatrix.trans
//                       operands, the sums in registers; G of a layer is read
//                       K / 128 times (1-3), its input once. Each share writes
//                       its partial sum; the wrapper adds the shares in a fixed
//                       order, so the weight gradients are deterministic.
// Live blocks. With a block list (`blocks`, `live_count`: the wrapper's
// stable partition of the 128-row blocks, those holding a live row first in
// row order, then the others, and the live count, both on the device) the
// forward and data-gradient grids stay n_pad / 128 blocks, block b taking
// list entry b: a live block works as without a list, a dead one writes
// zeros to the rows of what the caller reads (y or h, h being acts[7] in
// training; dx and its own row of the block sums) and returns, leaving its
// saved embedding, activations and G unwritten (nothing reads them). The
// weight-gradient pass keeps its grid and splits the live blocks' 64-row
// chunks, in list order, evenly over its shares, so its work follows the
// live rows. Without a list every block is live, as the list over an
// all-live mask gives.
// Bound on an H100: ~1.0e11 bf16 tensor operations per forward at N = 1e5
// (2.1e11 backward) against ~0.46 GB of saved-activation traffic in
// training; chip_smoke.py prints both bounds from its own run, and the
// weight-gradient pass's bytes from its tile sizes. wgmma with TMA-staged
// operands is later work, in both directions.
//
// sinf / cosf, never __sinf: with -fmad=false the scaled argument (a power of
// two times x, exact) reaches the thousands at 2^9, where the fast intrinsic
// loses its accuracy.
//
// Plain C interface (loaded with ctypes); launches on the caller's stream,
// allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int H = 256;        // trunk width
constexpr int DEPTH = 8;      // trunk layers
constexpr int SKIP_IN = 5;    // the layer that takes [emb | h_4]
constexpr int EMB = 128;      // embedding lanes (source lanes + time lanes, zero padded)
constexpr int MAX_SRC = 2;    // 3-vector sources per row
constexpr int NOUT = 13;      // packed head outputs
constexpr int LDE = EMB + 8;  // shared-memory row strides (bf16 / f32 elements)
constexpr int LDA = H + 8;

__host__ __device__ constexpr int layer_k(int i) { return i == 0 ? EMB : (i == SKIP_IN ? EMB + H : H); }

__host__ __device__ constexpr long layer_off(int i) {
    long o = 0;
    for (int j = 0; j < i; ++j) o += (long)H * layer_k(j);
    return o;
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

// ---------------------------------------------------------------------------
// the tensor-core machinery of both directions: mma.sync m16n8k16 (bf16
// operands, f32 accumulation), operands fed by ldmatrix from shared memory,
// rows and weight slices staged by cp.async
// ---------------------------------------------------------------------------

constexpr int BROWS = 128;          // rows of one forward or data-gradient block
constexpr int BTHREADS = 512;       // 16 warps: 2 (rows) x 8 (columns) in the products
constexpr int WS = 64;              // weight rows (the products' reduction) per staged slice
constexpr int LDW = H + 8;          // backward slice stride (bf16): 64 reduction rows x 256
constexpr int LDK = WS + 8;         // forward slice stride (bf16): 256 outputs x 64 reduction columns
constexpr int LDD = EMB + 4;        // d emb stride (f32)
// per-block f32 sums, in this order: d bias (8, 256), d head_w (13, 256),
// d head_b (13,), the row sum of d emb (128,)
constexpr int SM_DB = 0;
constexpr int SM_DHW = SM_DB + DEPTH * H;
constexpr int SM_DHB = SM_DHW + NOUT * H;
constexpr int SM_DEMB = SM_DHB + NOUT;
constexpr int SMALL = SM_DEMB + EMB;
constexpr int WG_TK = 128;          // weight-gradient tile: all 256 outputs x 128 input columns
constexpr int WG_CHUNK = 64;        // rows per staged chunk
constexpr int WG_STAGES = 4;
constexpr int LDGW = H + 8;         // staged G chunk stride (bf16)
constexpr int LDIW = WG_TK + 8;     // staged input chunk stride (bf16)
constexpr size_t BXBYTES = sizeof(float) * BROWS * 3 * MAX_SRC;  // a block's source rows

__host__ __device__ constexpr int wgrad_tiles(int i) { return layer_k(i) / WG_TK; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(smem)), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 bf16 matrices; lane l gives the row address of matrix l / 8
// (a shared-window byte address, or a pointer).
__device__ __forceinline__ void ldsm_x4_at(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr)
                 : "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) { ldsm_x4_at(r, smem_u32(p)); }
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(p))
                 : "memory");
}

// d (16x8 f32) += a (16x16 bf16, row) b (16x8 bf16, col)
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int NT>
__device__ __forceinline__ void zero_acc(float (&acc)[4][NT][4]) {
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
}

// The block's 128 rows of 256 bf16 between global memory (row stride H) and
// shared memory (row stride LDA), 16 bytes a thread at a time: into shared
// memory by cp.async (the caller commits and waits).
__device__ __forceinline__ void load_rows_async(bf16* smem, const bf16* gmem, int tid) {
    for (int i = tid; i < BROWS * (H / 8); i += BTHREADS) {
        const int r = i / (H / 8), c = (i % (H / 8)) * 8;
        cp_async16(smem + r * LDA + c, gmem + (size_t)r * H + c);
    }
}

// `rows` rows of `cols` bf16 from shared memory (row stride lds) to global
// memory (row stride ldg), 16 bytes a thread.
__device__ __forceinline__ void copy_rows(const bf16* smem, int lds, bf16* gmem, int ldg, int cols, int tid,
                                          int rows = BROWS) {
    const int per_row = cols / 8;
    for (int i = tid; i < rows * per_row; i += BTHREADS) {
        const int r = i / per_row, c = (i - r * per_row) * 8;
        *(uint4*)(gmem + (size_t)r * ldg + c) = *(const uint4*)(smem + r * lds + c);
    }
}

// The block's source rows (BROWS x 3 S f32) into shared memory, zeros past n
// (nothing for S = 0).
__device__ __forceinline__ void load_sources(float* s_x, const float* x, int row0, int n, int src, int tid) {
    const int xw = 3 * src;
    for (int i = tid; i < BROWS * xw; i += BTHREADS) s_x[i] = row0 + i / xw < n ? x[(size_t)row0 * xw + i] : 0.0f;
}

// ---------------------------------------------------------------------------
// the forward
// ---------------------------------------------------------------------------

constexpr int FWD_RING = H * LDK;  // bf16 elements of one staged forward slice
constexpr size_t FWD_SMEM =
    BXBYTES + sizeof(bf16) * (BROWS * LDE + BROWS * LDA + 2 * FWD_RING) + sizeof(float) * NOUT * H;
static_assert(sizeof(float) * 4 * BROWS * NOUT <= sizeof(bf16) * 2 * FWD_RING, "the heads' quarter sums fit the ring");
static_assert(FWD_SMEM <= 232448, "one block's shared memory");

// Forward slice: W[0:256, k0:k0 + 64] of a layer (row stride ldw) into ring
// slot `dst`, output n at dst[n LDK ..], by cp.async (the caller commits).
__device__ __forceinline__ void load_fwd_slice(bf16* dst, const bf16* W, int ldw, int k0, int tid) {
    for (int c = tid; c < H * (WS / 8); c += BTHREADS) {
        const int r = c / (WS / 8), cc = (c % (WS / 8)) * 8;
        cp_async16(dst + r * LDK + cc, W + (size_t)r * ldw + k0 + cc);
    }
}

// acc += A[:, 64 columns] @ slice^T, A the block's 128 rows (shared, row
// stride LD), the slice holding W[n][k0 + k] at [n LDK + k]: warp (wm, wn)
// owns rows 64 wm .. and outputs 32 wn ..; lane holds acc[mt][nt] of the
// m16n8 tile (mt, nt). B(k, n) = W[n][k] is the mma's column-major operand,
// so both fragments come from plain (untransposed) ldmatrix. a_lane and
// b_lane are the lane's ldmatrix row addresses at the first column of A's
// 64 and in the slice; every other offset is a constant.
template <int LD>
__device__ __forceinline__ void mma_fwd_slice(float (&acc)[4][4][4], uint32_t a_lane, uint32_t b_lane) {
#pragma unroll
    for (int kk = 0; kk < WS; kk += 16) {
        uint32_t b[4][2];
#pragma unroll
        for (int np = 0; np < 2; ++np) {
            uint32_t r[4];
            ldsm_x4_at(r, b_lane + 2 * (np * 16 * LDK + kk));
            b[2 * np][0] = r[0];
            b[2 * np][1] = r[1];
            b[2 * np + 1][0] = r[2];
            b[2 * np + 1][1] = r[3];
        }
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
            uint32_t a[4];
            ldsm_x4_at(a, a_lane + 2 * (mt * 16 * LD + kk));
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) mma16816(acc[mt][nt], a, b[nt][0], b[nt][1]);
        }
    }
}

template <bool HEADS>
__global__ void __launch_bounds__(BTHREADS, 1)
field_fwd_kernel(const float* __restrict__ x,      // (N, 3 S)
                 int n, int src, int xl, const float* __restrict__ trow, int tl,
                 const bf16* __restrict__ wpack,   // packed trunk weights, layer i (256, K_i)
                 const float* __restrict__ bias,   // (8, 256)
                 const float* __restrict__ hw,     // (13, 256), HEADS only
                 const float* __restrict__ hb,     // (13,), HEADS only
                 void* __restrict__ out,           // y (N, 13) f32, or h (N, 256) bf16
                 bf16* __restrict__ emb_out,       // (N_pad, 128) or null
                 bf16* __restrict__ acts_out,      // (8, N_pad, 256) or null
                 int n_pad,
                 const int* __restrict__ blocks,   // (N_pad / 128,) block list, or null: every block live
                 const int* __restrict__ live_count) {
    extern __shared__ __align__(128) unsigned char smem[];
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int row0 = (blocks ? blocks[blockIdx.x] : (int)blockIdx.x) * BROWS;
    if (blocks && (int)blockIdx.x >= *live_count) {  // no live row: zeros where the caller reads
        if (HEADS) {
            float* y = (float*)out + (size_t)row0 * NOUT;
            for (int i = tid; i < min(BROWS, n - row0) * NOUT; i += BTHREADS) y[i] = 0.0f;
        } else {
            bf16* hr = acts_out ? acts_out + ((size_t)(DEPTH - 1) * n_pad + row0) * H : (bf16*)out + (size_t)row0 * H;
            uint4* h = (uint4*)hr;
            const int rows = acts_out ? BROWS : min(BROWS, n - row0);
            for (int i = tid; i < rows * (H / 8); i += BTHREADS) h[i] = make_uint4(0u, 0u, 0u, 0u);
        }
        return;
    }
    float* s_x = (float*)smem;
    bf16* s_emb = (bf16*)(smem + BXBYTES);
    bf16* s_act = s_emb + BROWS * LDE;       // the current activation, overwritten in place layer by layer
    bf16* s_ring = s_act + BROWS * LDA;      // two staged weight slices
    float* s_hw = (float*)(s_ring + 2 * FWD_RING);
    float* s_red = (float*)s_ring;           // the heads' quarter sums (after the last layer)
    const int wm = warp >> 3, wn = warp & 7;
    // the lane's ldmatrix row addresses: A in the embedding and in the
    // activation (column 0), B in ring slot 0
    const uint32_t a_emb = smem_u32(s_emb + (wm * 64 + (lane & 15)) * LDE + (lane >> 4) * 8);
    const uint32_t a_act = smem_u32(s_act + (wm * 64 + (lane & 15)) * LDA + (lane >> 4) * 8);
    const uint32_t b_ring = smem_u32(s_ring + (wn * 32 + (lane & 7) + ((lane >> 4) << 3)) * LDK + ((lane >> 3) & 1) * 8);

    load_fwd_slice(s_ring, wpack, layer_k(0), 0, tid);  // in flight during the embedding
    cp_async_commit();
    load_sources(s_x, x, row0, n, src, tid);
    if (HEADS)
        for (int i = tid; i < NOUT * H; i += BTHREADS) s_hw[i] = hw[i];
    __syncthreads();
    for (int i = tid; i < BROWS * EMB; i += BTHREADS) {
        const int r = i / EMB, l = i - r * EMB;
        const float v = src > 0 ? embed_lane(s_x + 3 * src * r, l, src, xl, trow, tl)
                                : (row0 + r < n ? x[(size_t)row0 * EMB + i] : 0.0f);  // S = 0: the given lanes
        s_emb[r * LDE + l] = __float2bfloat16_rn(v);
    }

    int q = 0;  // slices staged so far over all layers; slice q sits in ring slot q & 1
#pragma unroll 1
    for (int i = 0; i < DEPTH; ++i) {
        const int K = layer_k(i), S = K / WS;
        const bf16* W = wpack + layer_off(i);
        float acc[4][4][4];
        zero_acc(acc);
#pragma unroll 1
        for (int s = 0; s < S; ++s, ++q) {
            cp_async_wait<0>();
            // slice q in place for every thread; slice q - 1 read by every
            // warp; the embedding or the last epilogue written
            __syncthreads();
            bf16* next = s_ring + ((q + 1) & 1) * FWD_RING;
            if (s + 1 < S) load_fwd_slice(next, W, K, (s + 1) * WS, tid);
            else if (i + 1 < DEPTH) load_fwd_slice(next, wpack + layer_off(i + 1), layer_k(i + 1), 0, tid);
            cp_async_commit();
            if (s == 0) {  // the layer below leaves during this layer's products
                if (i == 0) {
                    if (emb_out) copy_rows(s_emb, LDE, emb_out + (size_t)row0 * EMB, EMB, EMB, tid);
                } else if (acts_out) {
                    copy_rows(s_act, LDA, acts_out + ((size_t)(i - 1) * n_pad + row0) * H, H, H, tid);
                }
            }
            // the skip layer's first EMB / WS slices multiply the embedding
            const uint32_t b = b_ring + (q & 1) * (2 * FWD_RING);
            if (i == 0 || (i == SKIP_IN && s < EMB / WS)) mma_fwd_slice<LDE>(acc, a_emb + 2 * s * WS, b);
            else mma_fwd_slice<LDA>(acc, a_act + 2 * (i == SKIP_IN ? s - EMB / WS : s) * WS, b);
        }
        __syncthreads();  // every warp has read s_act: the epilogue writes over it
        const float* b = bias + i * H;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
            const int c = wn * 32 + nt * 8 + (lane & 3) * 2;
            const float b0 = b[c], b1 = b[c + 1];
#pragma unroll
            for (int mt = 0; mt < 4; ++mt)
#pragma unroll
                for (int hf = 0; hf < 2; ++hf) {
                    const int r = wm * 64 + mt * 16 + (lane >> 2) + 8 * hf;
                    *(__nv_bfloat162*)(s_act + r * LDA + c) =
                        __floats2bfloat162_rn(relu(acc[mt][nt][2 * hf] + b0), relu(acc[mt][nt][2 * hf + 1] + b1));
                }
        }
    }
    __syncthreads();  // h_7 in s_act
    if (acts_out) copy_rows(s_act, LDA, acts_out + ((size_t)(DEPTH - 1) * n_pad + row0) * H, H, H, tid);

    if (HEADS) {
        // lane: row (warp & 3) 32 + lane; warp >> 2: the quarter of k
        const int r = (warp & 3) * 32 + lane, k0 = (warp >> 2) * (H / 4);
        float yj[NOUT];
#pragma unroll
        for (int j = 0; j < NOUT; ++j) yj[j] = 0.0f;
#pragma unroll 1
        for (int k = k0; k < k0 + H / 4; k += 8) {
            const uint4 hv = *(const uint4*)(s_act + r * LDA + k);
            const uint32_t words[4] = {hv.x, hv.y, hv.z, hv.w};
            float hf[8];  // bf16 to f32 is exact: the bf16 bits above 16 zero bits
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                hf[2 * e] = __uint_as_float(words[e] << 16);
                hf[2 * e + 1] = __uint_as_float(words[e] & 0xffff0000u);
            }
#pragma unroll
            for (int j = 0; j < NOUT; ++j) {
                const float4 w0 = *(const float4*)(s_hw + j * H + k);
                const float4 w1 = *(const float4*)(s_hw + j * H + k + 4);
                float s = yj[j];
                s = fmaf(hf[0], w0.x, s);
                s = fmaf(hf[1], w0.y, s);
                s = fmaf(hf[2], w0.z, s);
                s = fmaf(hf[3], w0.w, s);
                s = fmaf(hf[4], w1.x, s);
                s = fmaf(hf[5], w1.y, s);
                s = fmaf(hf[6], w1.z, s);
                s = fmaf(hf[7], w1.w, s);
                yj[j] = s;
            }
        }
        float* red = s_red + ((warp >> 2) * BROWS + r) * NOUT;  // stride 13 words: no bank conflicts
#pragma unroll
        for (int j = 0; j < NOUT; ++j) red[j] = yj[j];
        __syncthreads();
        float* y = (float*)out;
        for (int o = tid; o < BROWS * NOUT; o += BTHREADS) {
            const int rr = o / NOUT, j = o - rr * NOUT;
            if (row0 + rr >= n) continue;
            float s = s_red[o];
#pragma unroll
            for (int qq = 1; qq < 4; ++qq) s += s_red[qq * BROWS * NOUT + o];
            y[(size_t)row0 * NOUT + o] = s + hb[j];
        }
    } else if (!acts_out) {  // in training h is acts_out[7], stored above
        const int rows = min(BROWS, n - row0);  // the last block's rows past n are padding
        if (rows > 0) copy_rows(s_act, LDA, (bf16*)out + (size_t)row0 * H, H, H, tid, rows);
    }
}

// ---------------------------------------------------------------------------
// the backward
// ---------------------------------------------------------------------------
// acc += A (the block's 128 rows x 256, shared, stride LDA) @ W[0:256, 0:8 NT 8]
// (global, row stride ldw): warp (wm, wn) owns rows 64 wm .. and columns
// NT 8 wn ..; each lane holds acc[mt][nt] of the m16n8 tile (mt, nt). W goes
// through a two-slice ring in shared memory, 64 of its rows a slice, the
// next slice's cp.async in flight while the products of this one run. With
// `side_dst`, the 128 x 256 bf16 rows at `side_src` are loaded into it by
// cp.async alongside, complete (for the calling thread) from the third
// slice on. The caller syncs the block before (the ring and side_dst are
// free, A is written) and after (before anything overwrites A or the ring).
template <int NT>
__device__ __forceinline__ void gemm_staged(float (&acc)[4][NT][4], const bf16* sA, const bf16* W, int ldw,
                                            bf16* ring, bf16* side_dst, const bf16* side_src, int tid, int lane,
                                            int wm, int wn) {
    constexpr int COLS = 8 * NT * 8;   // output columns of the block
    constexpr int PER_ROW = COLS / 8;  // 16-byte chunks in a slice row
    constexpr int SLICES = H / WS;
    static_assert(SLICES == 4, "the wait counts below assume four slices");
    auto load_slice = [&](int s) {
        bf16* dst = ring + (s & 1) * WS * LDW;
        const bf16* src = W + (size_t)(s * WS) * ldw;
        for (int c = tid; c < WS * PER_ROW; c += BTHREADS) {
            const int r = c / PER_ROW, cc = (c % PER_ROW) * 8;
            cp_async16(dst + r * LDW + cc, src + (size_t)r * ldw + cc);
        }
    };
    load_slice(0);
    cp_async_commit();
#pragma unroll 1
    for (int s = 0; s < SLICES; ++s) {
        // groups in commit order: slice 0 | slice 1, side | slice 2 | slice 3
        if (s == 1) cp_async_wait<1>();
        else cp_async_wait<0>();
        __syncthreads();  // slice s in place for every thread; slice s - 1 read by every warp
        if (s + 1 < SLICES) load_slice(s + 1);
        cp_async_commit();
        if (s == 0) {
            if (side_dst) load_rows_async(side_dst, side_src, tid);
            cp_async_commit();
        }
        const bf16* sw = ring + (s & 1) * WS * LDW;
#pragma unroll
        for (int kk = 0; kk < WS; kk += 16) {
            uint32_t b[NT][2];
#pragma unroll
            for (int np = 0; np < NT / 2; ++np) {
                uint32_t r[4];
                ldsm_x4_t(r, sw + (kk + (lane & 15)) * LDW + wn * (8 * NT) + np * 16 + (lane >> 4) * 8);
                b[2 * np][0] = r[0];
                b[2 * np][1] = r[1];
                b[2 * np + 1][0] = r[2];
                b[2 * np + 1][1] = r[3];
            }
#pragma unroll
            for (int mt = 0; mt < 4; ++mt) {
                uint32_t a[4];
                ldsm_x4(a, sA + (wm * 64 + mt * 16 + (lane & 15)) * LDA + s * WS + kk + (lane >> 4) * 8);
#pragma unroll
                for (int nt = 0; nt < NT; ++nt) mma16816(acc[mt][nt], a, b[nt][0], b[nt][1]);
            }
        }
    }
}


constexpr size_t DGRAD_SMEM = BXBYTES + sizeof(float) * BROWS * 16 + sizeof(bf16) * (2 * BROWS * LDA + 2 * WS * LDW) +
                              sizeof(float) * 2 * H;
static_assert(sizeof(float) * NOUT * H <= sizeof(bf16) * 2 * WS * LDW, "the heads' reduction fits the ring");
static_assert(sizeof(float) * BROWS * LDD <= sizeof(bf16) * 2 * WS * LDW, "d emb fits the ring");
static_assert(DGRAD_SMEM <= 232448, "one block's shared memory");

template <bool HEADS>
__global__ void __launch_bounds__(BTHREADS, 1)
field_dgrad_kernel(const float* __restrict__ x, int n, int src, int xl,
                   const float* __restrict__ dout,   // dy (N, 13) (HEADS) or dh (N, 256)
                   const bf16* __restrict__ wpack, const float* __restrict__ hw,
                   const bf16* __restrict__ acts,    // (8, N_pad, 256)
                   int n_pad,
                   bf16* __restrict__ G,             // (8, N_pad, 256) out: bf16(g) per layer
                   float* __restrict__ small,        // (blocks, SMALL) out: each block's f32 sums, by block
                   float* __restrict__ dx,           // (N, 3 S), or d emb (N, 128) for S = 0
                   const int* __restrict__ blocks,   // (N_pad / 128,) block list, or null: every block live
                   const int* __restrict__ live_count) {
    extern __shared__ __align__(128) unsigned char smem[];
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int blk = blocks ? blocks[blockIdx.x] : (int)blockIdx.x;
    const int row0 = blk * BROWS;
    float* pb = small + (size_t)blk * SMALL;
    if (blocks && (int)blockIdx.x >= *live_count) {  // no live row: zero sums (its cotangents are zeros) and dx
        for (int i = tid; i < SMALL; i += BTHREADS) pb[i] = 0.0f;
        const int xw = src > 0 ? 3 * src : EMB;
        float* d = dx + (size_t)row0 * xw;
        for (int i = tid; i < min(BROWS, n - row0) * xw; i += BTHREADS) d[i] = 0.0f;
        return;
    }
    float* s_x = (float*)smem;
    float* s_dy = (float*)(smem + BXBYTES);
    bf16* s_g = (bf16*)(s_dy + BROWS * 16);  // the current layer's bf16(g), in place
    bf16* s_m = s_g + BROWS * LDA;           // the mask activation (or g_5 at the end)
    bf16* s_w = s_m + BROWS * LDA;           // the weight ring
    float* s_db = (float*)(s_w + 2 * WS * LDW);  // [row half][256] column sums
    float* s_red = (float*)s_w;              // the heads' second-half sums (top layer only)
    float* s_demb = (float*)s_w;             // d emb (the end only)
    const int wm = warp >> 3, wn = warp & 7;

    load_sources(s_x, x, row0, n, src, tid);
    if (HEADS) {
        for (int i = tid; i < BROWS * 16; i += BTHREADS) {
            const int r = i >> 4, j = i & 15;
            s_dy[i] = (j < NOUT && row0 + r < n) ? dout[(size_t)(row0 + r) * NOUT + j] : 0.0f;
        }
    }
    load_rows_async(s_m, acts + ((size_t)(DEPTH - 1) * n_pad + row0) * H, tid);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // the top layer's g_7, one column and 64 rows per thread: HEADS, d HB,
    // d HW = h_7^T dy and g_7 = (dy @ HW) * (h_7 > 0); else g_7 = dh * (h_7 > 0)
    {
        const int k = tid & (H - 1), half = tid / H;
        float db = 0.0f;
        if (HEADS) {
            float hwk[NOUT], dacc[NOUT];
#pragma unroll
            for (int j = 0; j < NOUT; ++j) {
                hwk[j] = hw[j * H + k];
                dacc[j] = 0.0f;
            }
            for (int r = half * 64; r < half * 64 + 64; ++r) {
                const float a = __bfloat162float(s_m[r * LDA + k]);
                float g = 0.0f;
#pragma unroll
                for (int j = 0; j < NOUT; ++j) {
                    const float d = s_dy[r * 16 + j];
                    g += d * hwk[j];
                    dacc[j] += a * d;
                }
                g = g * (a > 0.0f ? 1.0f : 0.0f);
                db += g;
                s_g[r * LDA + k] = __float2bfloat16_rn(g);
            }
            if (half == 1)
#pragma unroll
                for (int j = 0; j < NOUT; ++j) s_red[j * H + k] = dacc[j];
            s_db[half * H + k] = db;
            __syncthreads();
            if (half == 0) {
#pragma unroll
                for (int j = 0; j < NOUT; ++j) pb[SM_DHW + j * H + k] = dacc[j] + s_red[j * H + k];
                pb[SM_DB + (DEPTH - 1) * H + k] = s_db[k] + s_db[H + k];
            } else if (k < NOUT) {
                float s = 0.0f;
                for (int r = 0; r < BROWS; ++r) s += s_dy[r * 16 + k];
                pb[SM_DHB + k] = s;
            }
        } else {
            for (int r = half * 64; r < half * 64 + 64; ++r) {
                const float a = __bfloat162float(s_m[r * LDA + k]);
                const float d = row0 + r < n ? dout[(size_t)(row0 + r) * H + k] : 0.0f;
                const float g = d * (a > 0.0f ? 1.0f : 0.0f);
                db += g;
                s_g[r * LDA + k] = __float2bfloat16_rn(g);
            }
            s_db[half * H + k] = db;
            for (int j = tid; j < NOUT * H + NOUT; j += BTHREADS) pb[SM_DHW + j] = 0.0f;  // no heads
            __syncthreads();
            if (half == 0) pb[SM_DB + (DEPTH - 1) * H + k] = s_db[k] + s_db[H + k];
        }
        __syncthreads();
    }

    // layers 7 .. 1: g_{i-1} = (g_i @ W_i[:, h columns]) * (h_{i-1} > 0)
#pragma unroll 1
    for (int i = DEPTH - 1; i >= 1; --i) {
        const int below = i - 1;
        copy_rows(s_g, LDA, G + ((size_t)i * n_pad + row0) * H, H, H, tid);  // bf16(g_i), the weight gradient's operand
        float acc[4][4][4];
        zero_acc(acc);
        gemm_staged<4>(acc, s_g, wpack + layer_off(i) + (i == SKIP_IN ? EMB : 0), layer_k(i), s_w, s_m,
                       acts + ((size_t)below * n_pad + row0) * H, tid, lane, wm, wn);
        __syncthreads();  // every warp has read s_g; the mask is in s_m
        // epilogue: mask, store bf16(g) in place, column sums of the f32 g
        float cs[4][2];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) cs[nt][0] = cs[nt][1] = 0.0f;
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
#pragma unroll
                for (int hf = 0; hf < 2; ++hf) {
                    const int r = wm * 64 + mt * 16 + (lane >> 2) + 8 * hf;
                    const int c = wn * 32 + nt * 8 + (lane & 3) * 2;
                    const __nv_bfloat162 m2 = *(const __nv_bfloat162*)(s_m + r * LDA + c);
                    const float v0 = acc[mt][nt][2 * hf] * (__low2float(m2) > 0.0f ? 1.0f : 0.0f);
                    const float v1 = acc[mt][nt][2 * hf + 1] * (__high2float(m2) > 0.0f ? 1.0f : 0.0f);
                    cs[nt][0] += v0;
                    cs[nt][1] += v1;
                    *(__nv_bfloat162*)(s_g + r * LDA + c) = __floats2bfloat162_rn(v0, v1);
                }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                float v = cs[nt][e];
                v += __shfl_xor_sync(0xffffffffu, v, 4);
                v += __shfl_xor_sync(0xffffffffu, v, 8);
                v += __shfl_xor_sync(0xffffffffu, v, 16);
                if (lane < 4) s_db[wm * H + wn * 32 + nt * 8 + lane * 2 + e] = v;
            }
        __syncthreads();
        if (tid < H) pb[SM_DB + below * H + tid] = s_db[tid] + s_db[H + tid];
    }

    // layer 0 and the skip's embedding columns: d emb = g_0 @ W0 + g_5 @ W5[:, :128],
    // g_5 reloaded (bf16, as the product takes it) from G into s_m
    copy_rows(s_g, LDA, G + (size_t)row0 * H, H, H, tid);
    float acc[4][2][4];
    zero_acc(acc);
    gemm_staged<2>(acc, s_g, wpack, EMB, s_w, s_m, G + ((size_t)SKIP_IN * n_pad + row0) * H, tid, lane, wm, wn);
    __syncthreads();
    gemm_staged<2>(acc, s_m, wpack + layer_off(SKIP_IN), layer_k(SKIP_IN), s_w, nullptr, nullptr, tid, lane, wm, wn);
    __syncthreads();
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
                const int r = wm * 64 + mt * 16 + (lane >> 2) + 8 * hf;
                const int c = wn * 16 + nt * 8 + (lane & 3) * 2;
                *(float2*)(s_demb + r * LDD + c) = make_float2(acc[mt][nt][2 * hf], acc[mt][nt][2 * hf + 1]);
            }
    __syncthreads();
    if (src == 0) {  // d emb itself: every lane of every row below n
        for (int i = tid; i < BROWS * EMB; i += BTHREADS) {
            const int r = i / EMB, l = i - r * EMB;
            if (row0 + r < n) dx[(size_t)row0 * EMB + i] = s_demb[r * LDD + l];
        }
        if (tid < EMB) pb[SM_DEMB + tid] = 0.0f;
        return;
    }
    if (tid < EMB) {
        float s = 0.0f;
        for (int r = 0; r < BROWS; ++r) s += s_demb[r * LDD + tid];
        pb[SM_DEMB + tid] = s;
    }
    // dx: lane (s, b, c) is x_sc, sin(f x_sc) or cos(f x_sc)
    const int xw = 3 * src;
    for (int i = tid; i < BROWS * xw; i += BTHREADS) {
        const int r = i / xw, sc = i - r * xw, s = sc / 3, c = sc - 3 * s;
        if (row0 + r >= n) continue;
        const float xv = s_x[i];
        const float* d = s_demb + r * LDD + s * xl;
        float a = d[c];
        for (int b = 1; b < xl / 3; ++b) {
            const float f = (float)(1 << ((b - 1) >> 1));
            const float v = xv * f;
            const float deriv = (b & 1) ? cosf(v) : -sinf(v);
            a += d[3 * b + c] * deriv * f;
        }
        dx[(size_t)(row0 + r) * xw + sc] = a;
    }
}

constexpr size_t WGRAD_SMEM = sizeof(bf16) * WG_STAGES * WG_CHUNK * (LDGW + LDIW);
static_assert(WGRAD_SMEM <= 232448, "one block's shared memory");

// dW tile (layer i, input columns k0 .. k0 + 127, all 256 outputs) over the
// block's share of the rows: dW[o][k] = sum_r G[r][o] In[r][k]. The rows are
// the live blocks' 64-row chunks in list order (every chunk without a list),
// split evenly over the gridDim.y shares; a share with no chunk writes
// zeros. Warp (wo, wk) owns outputs 64 wo .. and columns 32 wk ..; rows
// stream through a four-chunk cp.async ring, three chunks in flight while
// one is multiplied.
constexpr int WG_PER_BLOCK = BROWS / WG_CHUNK;  // weight-gradient chunks in a block
static_assert(BROWS % WG_CHUNK == 0, "a block is whole chunks");
__global__ void __launch_bounds__(BTHREADS, 1)
field_wgrad_kernel(const bf16* __restrict__ emb,   // (N_pad, 128)
                   const bf16* __restrict__ acts,  // (8, N_pad, 256)
                   const bf16* __restrict__ G,     // (8, N_pad, 256)
                   int n_pad,
                   const int* __restrict__ blocks,      // (N_pad / 128,) block list, or null
                   const int* __restrict__ live_count,
                   float* __restrict__ partial) {  // (splits, packed weight size)
    extern __shared__ __align__(128) unsigned char smem[];
    bf16* s_ring = (bf16*)smem;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int wo = warp >> 2, wk = warp & 3;
    int t = blockIdx.x, i = 0;
    while (t >= wgrad_tiles(i)) t -= wgrad_tiles(i++);
    const int K = layer_k(i), k0 = t * WG_TK;
    // this tile's input columns: the embedding, or the activation below
    const bf16* in;
    int ldi, col;
    if (i == 0 || (i == SKIP_IN && k0 < EMB)) {
        in = emb;
        ldi = EMB;
        col = k0;
    } else {
        in = acts + (size_t)(i == SKIP_IN ? SKIP_IN - 1 : i - 1) * n_pad * H;
        ldi = H;
        col = i == SKIP_IN ? k0 - EMB : k0;
    }
    const bf16* g = G + (size_t)i * n_pad * H;
    const int total = (blocks ? *live_count : n_pad / BROWS) * WG_PER_BLOCK;
    const int per = (total + (int)gridDim.y - 1) / (int)gridDim.y;
    const int c_begin = min(total, (int)blockIdx.y * per);
    const int chunks = min(total, c_begin + per) - c_begin;

    auto load_chunk = [&](int c) {
        bf16* sg = s_ring + (c % WG_STAGES) * WG_CHUNK * (LDGW + LDIW);
        bf16* si = sg + WG_CHUNK * LDGW;
        const int l = c_begin + c;  // the chunk's place in the list
        const int b = blocks ? blocks[l / WG_PER_BLOCK] : l / WG_PER_BLOCK;
        const size_t r0 = (size_t)b * BROWS + (size_t)(l % WG_PER_BLOCK) * WG_CHUNK;
        for (int e = tid; e < WG_CHUNK * (H / 8); e += BTHREADS) {
            const int r = e / (H / 8), cc = (e % (H / 8)) * 8;
            cp_async16(sg + r * LDGW + cc, g + (r0 + r) * H + cc);
        }
        for (int e = tid; e < WG_CHUNK * (WG_TK / 8); e += BTHREADS) {
            const int r = e / (WG_TK / 8), cc = (e % (WG_TK / 8)) * 8;
            cp_async16(si + r * LDIW + cc, in + (r0 + r) * ldi + col + cc);
        }
    };

    float acc[4][4][4];
    zero_acc(acc);
#pragma unroll
    for (int c = 0; c < WG_STAGES - 1; ++c) {
        if (c < chunks) load_chunk(c);
        cp_async_commit();
    }
#pragma unroll 1
    for (int c = 0; c < chunks; ++c) {
        cp_async_wait<WG_STAGES - 2>();
        __syncthreads();  // chunk c in place for every thread; chunk c - 1 read by every warp
        if (c + WG_STAGES - 1 < chunks) load_chunk(c + WG_STAGES - 1);
        cp_async_commit();
        const bf16* sg = s_ring + (c % WG_STAGES) * WG_CHUNK * (LDGW + LDIW);
        const bf16* si = sg + WG_CHUNK * LDGW;
#pragma unroll
        for (int kk = 0; kk < WG_CHUNK; kk += 16) {
            uint32_t b[4][2];
#pragma unroll
            for (int np = 0; np < 2; ++np) {
                uint32_t r[4];
                ldsm_x4_t(r, si + (kk + (lane & 15)) * LDIW + wk * 32 + np * 16 + (lane >> 4) * 8);
                b[2 * np][0] = r[0];
                b[2 * np][1] = r[1];
                b[2 * np + 1][0] = r[2];
                b[2 * np + 1][1] = r[3];
            }
#pragma unroll
            for (int mt = 0; mt < 4; ++mt) {
                // A(o, r) = G[r][o]: the stored rows read transposed
                uint32_t a[4];
                ldsm_x4_t(a, sg + (kk + (lane & 7) + ((lane >> 4) << 3)) * LDGW + wo * 64 + mt * 16 +
                                 ((lane >> 3) & 1) * 8);
#pragma unroll
                for (int nt = 0; nt < 4; ++nt) mma16816(acc[mt][nt], a, b[nt][0], b[nt][1]);
            }
        }
    }
    cp_async_wait<0>();
    float* out = partial + (size_t)blockIdx.y * layer_off(DEPTH) + layer_off(i) + k0;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
                const int o = wo * 64 + mt * 16 + (lane >> 2) + 8 * hf;
                const int kc = wk * 32 + nt * 8 + (lane & 3) * 2;
                *(float2*)(out + (size_t)o * K + kc) = make_float2(acc[mt][nt][2 * hf], acc[mt][nt][2 * hf + 1]);
            }
}

bool valid_lanes(int src, int xl, int tl) {
    if (src == 0) return xl == 0 && tl == 0;  // the embedding is given
    return src >= 1 && src <= MAX_SRC && xl >= 3 && xl % 3 == 0 && (xl / 3) % 2 == 1 && tl >= 0 &&
           src * xl + tl <= EMB;
}

template <bool HEADS>
cudaError_t launch_fwd(const void* x, int n, int src, int xl, const void* trow, int tl, const void* wpack,
                       const void* bias, const void* hw, const void* hb, void* out, void* emb_out, void* acts_out,
                       int n_pad, const int* blocks, const int* live_count, cudaStream_t stream) {
    cudaFuncSetAttribute(field_fwd_kernel<HEADS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)FWD_SMEM);
    field_fwd_kernel<HEADS><<<n_pad / BROWS, BTHREADS, FWD_SMEM, stream>>>(
        (const float*)x, n, src, xl, (const float*)trow, tl, (const bf16*)wpack, (const float*)bias,
        (const float*)hw, (const float*)hb, out, (bf16*)emb_out, (bf16*)acts_out, n_pad, blocks, live_count);
    return cudaGetLastError();
}

template <bool HEADS>
cudaError_t launch_dgrad(const void* x, int n, int src, int xl, const void* dout, const void* wpack, const void* hw,
                         const void* acts, int n_pad, void* G, void* small, void* dx, const int* blocks,
                         const int* live_count, cudaStream_t stream) {
    cudaFuncSetAttribute(field_dgrad_kernel<HEADS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)DGRAD_SMEM);
    field_dgrad_kernel<HEADS><<<n_pad / BROWS, BTHREADS, DGRAD_SMEM, stream>>>(
        (const float*)x, n, src, xl, (const float*)dout, (const bf16*)wpack, (const float*)hw, (const bf16*)acts,
        n_pad, (bf16*)G, (float*)small, (float*)dx, blocks, live_count);
    return cudaGetLastError();
}

}  // namespace

extern "C" long field_packed_size() { return layer_off(DEPTH); }

// heads != 0: out is y (N, 13) f32 and hw / hb the packed heads; heads == 0:
// out is h (N, 256) bf16 and hw / hb are not read; with acts_out, h is its
// last layer and out is not written (it may be null). src == 0 (with xl ==
// tl == 0, heads == 0): x is the (N, 128) f32 embedding. blocks and
// live_count: the device block list (n_pad / 128 ints, the live blocks first)
// and its live count, or both null (every block live).
extern "C" int field_fwd(int heads, const void* x, int n, int src, int xl, const void* trow, int tl,
                         const void* wpack, const void* bias, const void* hw, const void* hb, void* out,
                         void* emb_out, void* acts_out, int n_pad, const int* blocks, const int* live_count,
                         void* stream) {
    // no early exit at n == 0: the padded rows (n_pad >= 128) still run, so
    // without a block list the saved tensors are written whatever n is
    if (!valid_lanes(src, xl, tl) || (heads && src == 0) || n_pad % BROWS != 0 || n_pad < n || n_pad == 0 ||
        (blocks == nullptr) != (live_count == nullptr))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    return (int)(heads ? launch_fwd<true>(x, n, src, xl, trow, tl, wpack, bias, hw, hb, out, emb_out, acts_out, n_pad,
                                          blocks, live_count, s)
                       : launch_fwd<false>(x, n, src, xl, trow, tl, wpack, bias, hw, hb, out, emb_out, acts_out, n_pad,
                                           blocks, live_count, s));
}

extern "C" int field_bwd_rows() { return BROWS; }
extern "C" int field_bwd_small() { return SMALL; }

// heads != 0: dout is dy (N, 13) and hw the heads' weights; heads == 0: dout
// is dh (N, 256), hw is not read and the heads' sums are zeros. src == 0
// (xl == 0, heads == 0): dx receives d emb (N, 128) and the d emb row sums are
// zeros. n_pad is a multiple of field_bwd_rows(). Outputs: G (8, n_pad, 256)
// bf16; small (n_pad / field_bwd_rows(), field_bwd_small()) f32, each
// block's d bias, d head_w, d head_b and d emb row sums; dx; partial
// (splits, packed size) f32, each split's share of the weight gradients.
// parts: 1 the data-gradient walk, 2 the weight-gradient pass (from G), 3 both.
// blocks and live_count: the forward's block list, or both null.
extern "C" int field_bwd(int heads, const void* x, int n, int src, int xl, const void* dout, const void* wpack,
                         const void* hw, const void* emb, const void* acts, int n_pad, int splits, void* G,
                         void* small, void* dx, void* partial, int parts, const int* blocks, const int* live_count,
                         void* stream) {
    // no early exit at n == 0: every block's sums and every split of the
    // weight-gradient partials are written (zeros then), since the wrapper sums them
    if (!valid_lanes(src, xl, 0) || (heads && src == 0) || n_pad % BROWS != 0 || n_pad < n || n_pad == 0 ||
        splits < 1 || parts < 1 || parts > 3 || (blocks == nullptr) != (live_count == nullptr))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (parts & 1) {
        cudaError_t err = heads ? launch_dgrad<true>(x, n, src, xl, dout, wpack, hw, acts, n_pad, G, small, dx, blocks,
                                                     live_count, s)
                                : launch_dgrad<false>(x, n, src, xl, dout, wpack, hw, acts, n_pad, G, small, dx, blocks,
                                                      live_count, s);
        if (err != cudaSuccess) return (int)err;
    }
    if (parts & 2) {
        int tiles = 0;
        for (int i = 0; i < DEPTH; ++i) tiles += wgrad_tiles(i);
        cudaFuncSetAttribute(field_wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)WGRAD_SMEM);
        dim3 grid(tiles, splits);
        field_wgrad_kernel<<<grid, BTHREADS, WGRAD_SMEM, s>>>((const bf16*)emb, (const bf16*)acts, (const bf16*)G,
                                                              n_pad, blocks, live_count, (float*)partial);
    }
    return (int)cudaGetLastError();
}

extern "C" const char* field_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
