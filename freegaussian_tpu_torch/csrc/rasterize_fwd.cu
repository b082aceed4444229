// Tile compositor, forward: front-to-back alpha compositing of the
// (tile, depth)-sorted intersections, one block per 16 x 16 quadrant of a
// tile, one thread per pixel.
//
// Replaces the TPU kernel freegaussian_tpu/ops/rasterize_pallas.py:_fwd_kernel
// (launcher _run_fwd, with _alphas and _transmittance). It computes what that
// kernel computes, per pixel:
//   sigma = 0.5 (a dx^2 + c dy^2) + b dx dy,  alpha = min(0.999, op exp(-sigma))
//   skip the pair if sigma < 0 or alpha < 1/255 (or, at a tile size other
//   than 16, if the pixel's 16-px contract tile lies outside the Gaussian's
//   radius bbox: the gate of _alphas)
//   next_T = T (1 - alpha); if next_T <= 1e-4 the pixel terminates and this
//   Gaussian is NOT composited; else accumulate w = alpha T into color and alpha.
// Outputs, for every pixel of the image: color (H, W, C), alpha (H, W),
// livecnt (H, W) = slots of the tile's run walked before termination, and
// t_final (H, W) = transmittance after the last composited Gaussian.
//
// Bound on an H100: the work is one exp and ~22 + 2C f32 operations per
// (pixel, intersection) pair inside the Gaussian's 16-px tile bbox, up to the
// pixel's termination, against a read-once cost of the per-Gaussian rows
// ((7 + C) floats), one id per intersection and H*W*(C+3) output words. At the
// serving point (N = 1e5, 640x480) the operations bound it (chip_smoke.py
// prints both bounds from the run's own data).
//
// Design: quadrant blocks. Every block is one 16 x 16 quadrant of a kernel
// tile, 256 threads, one pixel each (grid Q x T, Q = 4 at tile 32, 1 at tile
// 16: the one-quadrant case of the same code, without the gate and the
// compaction, which it would not change). A 32-px
// tile as one 1024-thread block walked its run to its deepest pixel and
// evaluated every slot for all four quadrants; here each quadrant walks on
// its own. The block walks its tile's run in batches of 256: each thread
// loads one slot's Gaussian and tests the quadrant's contract tile against
// its radius bbox, which is exact because at tile 32 a quadrant is one 16-px
// contract tile (the gate of _alphas). A ballot and the warps' counts compact
// the passing slots, each kept with its rank in the run, and the pixels walk
// only those. livecnt is the terminating slot's rank (the slots of the run
// walked before termination) or the run's length. The block leaves as soon
// as __syncthreads_count says every pixel of the quadrant has terminated.
// Each pair's arithmetic is that of the walk over the whole run, in its
// order: a skipped slot would not have changed T or the sums.
//
// Built with -fmad=false so every product and sum rounds as PyTorch's
// separate elementwise kernels do: the plain version then reaches the same
// termination decisions bit for bit, and the backward's walks
// (rasterize_bwd.cu) replay them.
//
// Plain C interface (loaded with ctypes); launches on the caller's stream,
// allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kAlphaThreshold = 1.0f / 255.0f;
constexpr float kTransmittanceEps = 1e-4f;
constexpr float kMaxAlpha = 0.999f;
constexpr int kMaxChannels = 8;
constexpr float kContractTile = 16.0f;
constexpr int kQuad = 16;                // quadrant side: the contract tile
constexpr int kThreads = kQuad * kQuad;  // one pixel per thread
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = kThreads;         // slots loaded (and compacted) at a time, one a thread

template <int TILE>
__global__ void __launch_bounds__(kThreads)
rasterize_fwd_kernel(const float* __restrict__ means2d,    // (N, 2)
                     const float* __restrict__ conics,     // (N, 3)
                     const float* __restrict__ opacities,  // (N,)
                     const float* __restrict__ colors,     // (N, C)
                     const float* __restrict__ radii,      // (N,) bbox radius
                     const int32_t* __restrict__ gauss_ids,     // (I,)
                     const int32_t* __restrict__ tile_offsets,  // (T + 1,)
                     int C, int width, int height, int tiles_w, int gate,
                     float* __restrict__ out_color,    // (H, W, C)
                     float* __restrict__ out_alpha,    // (H, W)
                     int32_t* __restrict__ out_livecnt,  // (H, W)
                     float* __restrict__ out_tfinal)   // (H, W)
{
    constexpr int kSide = TILE / kQuad;  // quadrants per tile side
    // at tile 16 the block's quadrant is its tile, which every slot of the
    // run overlaps: no gate, no compaction, a slot's rank is its position
    constexpr bool kCompact = kSide > 1;
    // the walk unrolled as far as registers allow without spills (ptxas:
    // 4 at tile 16; at tile 32, where the compaction holds more, 2)
    constexpr int kUnroll = kCompact ? 2 : 4;
    // the batch's passing slots, compacted in run order
    __shared__ float s_mx[kBatch], s_my[kBatch];
    __shared__ float s_ca[kBatch], s_cb[kBatch], s_cc[kBatch];
    __shared__ float s_op[kBatch];
    __shared__ float s_col[kBatch * kMaxChannels];
    __shared__ int s_rank[kBatch];  // the slot's rank in the tile's run
    __shared__ int s_warp_pass[kWarps];

    const int q = blockIdx.x;
    const int tile = blockIdx.y;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int qx = (tile % tiles_w) * kSide + q % kSide;  // the quadrant's 16-px contract tile
    const int qy = (tile / tiles_w) * kSide + q / kSide;
    const int x = qx * kQuad + tid % kQuad;
    const int y = qy * kQuad + tid / kQuad;
    const bool inside = x < width && y < height;
    const float px = (float)x + 0.5f;
    const float py = (float)y + 0.5f;
    // floorf((px - 0.5) / 16), the pixel's contract tile as _alphas computes
    // it, is the quadrant's for every pixel of the block
    const float ctx = (float)qx;
    const float cty = (float)qy;

    const int start = tile_offsets[tile];
    const int end = tile_offsets[tile + 1];

    float T = 1.0f;
    float acc[kMaxChannels];
#pragma unroll
    for (int c = 0; c < kMaxChannels; ++c) acc[c] = 0.0f;
    float acc_alpha = 0.0f;
    int livecnt = end - start;  // the run's length unless the pixel terminates
    bool done = !inside;

    for (int b0 = start; b0 < end; b0 += kBatch) {
        // also the barrier that keeps the previous batch's rows until all
        // threads have read them
        if (__syncthreads_count(!done) == 0) break;
        const int j = b0 + tid;
        bool pass = false;
        int g = 0;
        if (j < end) {
            g = gauss_ids[j];
            pass = true;
            if (kCompact && gate) {
                // the same f32 arithmetic as tile_bounds (/16 is exact)
                const float r = radii[g];
                const float mx = means2d[2 * g], my = means2d[2 * g + 1];
                pass = ctx >= floorf((mx - r) / kContractTile) && ctx < ceilf((mx + r) / kContractTile) &&
                       cty >= floorf((my - r) / kContractTile) && cty < ceilf((my + r) / kContractTile);
            }
        }
        int pos = tid, np = min(kBatch, end - b0);
        if (kCompact) {
            const unsigned mask = __ballot_sync(0xffffffffu, pass);
            if (lane == 0) s_warp_pass[warp] = __popc(mask);
            __syncthreads();
            pos = __popc(mask & ((1u << lane) - 1u));
            np = 0;
#pragma unroll
            for (int w = 0; w < kWarps; ++w) {
                const int c = s_warp_pass[w];
                pos += w < warp ? c : 0;
                np += c;
            }
        }
        if (pass) {
            if (kCompact) s_rank[pos] = j - start;
            s_mx[pos] = means2d[2 * g];
            s_my[pos] = means2d[2 * g + 1];
            s_ca[pos] = conics[3 * g];
            s_cb[pos] = conics[3 * g + 1];
            s_cc[pos] = conics[3 * g + 2];
            s_op[pos] = opacities[g];
            for (int c = 0; c < C; ++c) s_col[pos * kMaxChannels + c] = colors[g * C + c];
        }
        __syncthreads();
        if (done) continue;
#pragma unroll kUnroll
        for (int k = 0; k < np; ++k) {
            const float gx = s_mx[k], gy = s_my[k];
            const float dx = gx - px;
            const float dy = gy - py;
            const float sigma = 0.5f * (s_ca[k] * dx * dx + s_cc[k] * dy * dy) + s_cb[k] * dx * dy;
            const float alpha = fminf(kMaxAlpha, s_op[k] * expf(-sigma));
            if (sigma >= 0.0f && alpha >= kAlphaThreshold) {
                const float next_T = T * (1.0f - alpha);
                if (next_T <= kTransmittanceEps) {
                    done = true;
                    livecnt = kCompact ? s_rank[k] : b0 - start + k;
                    break;
                }
                const float w = alpha * T;
#pragma unroll
                for (int c = 0; c < kMaxChannels; ++c)
                    if (c < C) acc[c] += w * s_col[k * kMaxChannels + c];
                acc_alpha += w;
                T = next_T;
            }
        }
    }

    if (inside) {
        const int pix = y * width + x;
#pragma unroll
        for (int c = 0; c < kMaxChannels; ++c)
            if (c < C) out_color[pix * C + c] = acc[c];
        out_alpha[pix] = acc_alpha;
        out_livecnt[pix] = livecnt;
        out_tfinal[pix] = T;
    }
}

}  // namespace

extern "C" int rasterize_fwd(const void* means2d, const void* conics, const void* opacities,
                             const void* colors, const void* radii, const void* gauss_ids,
                             const void* tile_offsets, int C, int width, int height, int tile_size,
                             int tiles_w, int tiles_h, int gate, void* out_color, void* out_alpha,
                             void* out_livecnt, void* out_tfinal, void* stream) {
    if (C < 1 || C > kMaxChannels) return (int)cudaErrorInvalidValue;
    if (tile_size != 16 && tile_size != 32) return (int)cudaErrorInvalidValue;
    const int num_tiles = tiles_w * tiles_h;
    if (num_tiles == 0) return (int)cudaGetLastError();
    const int side = tile_size / kQuad;
    dim3 grid(side * side, num_tiles);
    cudaStream_t s = (cudaStream_t)stream;
#define FG_LAUNCH(TS)                                                                                     \
    rasterize_fwd_kernel<TS><<<grid, kThreads, 0, s>>>(                                                  \
        (const float*)means2d, (const float*)conics, (const float*)opacities, (const float*)colors,      \
        (const float*)radii, (const int32_t*)gauss_ids, (const int32_t*)tile_offsets, C, width, height, \
        tiles_w, gate, (float*)out_color, (float*)out_alpha, (int32_t*)out_livecnt, (float*)out_tfinal)
    if (tile_size == 16) FG_LAUNCH(16);
    else FG_LAUNCH(32);
#undef FG_LAUNCH
    return (int)cudaGetLastError();
}

extern "C" const char* rasterize_fwd_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
