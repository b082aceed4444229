// Tile compositor, backward: walks of each tile's depth-sorted run (one per
// 16 x 16 quadrant of the tile) and a combine that write one gradient row
// per intersection, with the AbsGS absgrad. Two walks, one template (FWD):
//
//   reverse (rasterize_bwd)      replaces the TPU kernel
//       freegaussian_tpu/ops/rasterize_pallas.py:_bwd_kernel_rev (launcher
//       _run_bwd_rev, with _bwd_half_body_rev and _grad_rows). Each pixel
//       starts from the forward's t_final and walks its tile's run back to
//       front; a slot is live for the pixel when its rank in the run is below
//       the forward's livecnt (the slots walked before termination).
//   forward (rasterize_bwd_fwd)  replaces the TPU kernel
//       rasterize_pallas.py:_bwd_kernel (launcher _run_bwd, body
//       _bwd_half_body), selected there by BWD_WALK = "fwd". Each pixel walks
//       the run front to back from T = 1, replaying the forward's running
//       product T *= 1 - alpha in the forward's order and rounding (this file
//       is built with -fmad=false, as rasterize_fwd.cu is), so it stops at the
//       same slot the forward stopped at; the suffix comes from the identity
//       r_after = r_total - S, with S the running sum of w b up to and
//       including the slot and r_total = sum_c color g_color + alpha g_alpha
//       the pixel's total, computed by the caller.
//
// Per (pixel, live slot):
//   b      = g_alpha + sum_c g_color[c] color[c]
//   T_excl = the transmittance before the slot (reverse: T / (1 - alpha);
//            live alpha <= 0.999)
//   w      = alpha T_excl
//   da     = T_excl b - r_after / (1 - alpha)   (r_after: sum of w b over deeper slots)
//   dsigma = -alpha da, if the raw alpha op exp(-sigma) <= 0.999, else 0
// and the row of the slot holds the sums over the tile's pixels of
//   d means2d = dsigma (a dx + b dy, b dx + c dy)
//   d conic   = (dsigma dx^2 / 2, dsigma dx dy, dsigma dy^2 / 2)
//   d opacity = -sum dsigma / op
//   absgrad   = |d means2d|, the abs taken after the whole tile's sum
//   d colors  = w g_color
// At a tile size other than 16 the pair is gated by the Gaussian's 16-px
// contract bbox, as the forward gates it.
//
// Every row of the (I, 8 + C) output is written: rows whose rank is at or
// past every pixel's livecnt get exact zeros (the unwritten rows of the TPU
// kernel's output held garbage that poisoned the per-Gaussian reduction).
// The forward walk's suffix identity cancels where r_after is small next to
// r_total (deep in a saturated pixel): its gradients carry that error, which
// the reverse walk does not have.
//
// Bound on an H100: per live (pixel, slot) pair ~33 + 3C f32 operations for
// the slot's terms and one exp, against a read-once cost of the per-Gaussian
// rows, the ids, the per-pixel cotangents and an (I, 8 + C) f32 write; at
// the training point (N = 1e5, 640x480) the operations bound it (chip_smoke.py
// prints both bounds from the run's own data).
//
// Design: quadrant blocks and a fixed-order combine. Every block is one
// 16 x 16 quadrant of a kernel tile, 256 threads, one pixel each (grid Q x T,
// Q = 4 at tile 32, 1 at tile 16: the one-quadrant case of the same code).
// A quadrant block walks its tile's depth-sorted run only up to its own
// quadrant's deepest livecnt, and at tile 32 it drops, block-uniformly and
// before any exp, every slot whose 16-px contract bbox misses the quadrant:
// there the gate is the quadrant test, and in both walks T (and the forward
// walk's running sum) change only on slots that pass it, so the skip is
// exact. Each batch of 32 slots is loaded once per block and compacted to
// the slots that pass; each pixel's terms are summed over its warp with
// shuffles (skipped when no lane of the warp has a live pair), the 8 warp
// sums of a slot in a fixed order. The walk writes the quadrant's sums of
// the 6 + C terms of every slot of its tile's run to a scratch (Q, I, 6 + C)
// f32, exact zeros for the slots it skipped or never reached (every slot is
// written, so the combine reads every quadrant). The combine, a second
// launch with one thread per output element, adds the Q partials in
// quadrant order, then takes d opacity = -sum / op and the absgrad |sum| of
// the means2d terms after the whole kernel tile's sum, and writes every
// row. A padding slot of a capacity-bounded binning (gauss_ids >= N, past
// every tile's range, so never walked) gets a zero row without a read of
// its scratch or of opacities. No atomics: two calls give the same bits.
//
// Plain C interface (loaded with ctypes); launches on the caller's stream,
// allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kAlphaThreshold = 1.0f / 255.0f;
constexpr float kMaxAlpha = 0.999f;
constexpr float kTransmittanceEps = 1e-4f;
constexpr int kMaxChannels = 8;
constexpr int kHead = 8;                    // row columns ahead of the colors
constexpr int kCols = 6 + kMaxChannels;     // reduced terms per slot
constexpr float kContractTile = 16.0f;
constexpr int kQuad = 16;                   // quadrant side: the contract tile
constexpr int kThreads = kQuad * kQuad;     // one pixel per thread
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 32;                  // slots loaded (and compacted) at a time
constexpr int kCombineThreads = 256;
static_assert(kBatch == 32, "one warp loads and compacts a batch");

// One quadrant block's walk of its tile's run. Writes scratch[q][slot][j],
// j < 6 + C: the quadrant's sums of d means2d (2), d conic (3), dsigma (1)
// and d colors (C) for every slot of the tile, zeros where it has none.
template <int TILE, bool FWD>
__global__ void __launch_bounds__(kThreads)
rasterize_bwd_walk(const float* __restrict__ means2d,    // (N, 2)
                   const float* __restrict__ conics,     // (N, 3)
                   const float* __restrict__ opacities,  // (N,)
                   const float* __restrict__ colors,     // (N, C)
                   const float* __restrict__ radii,      // (N,) bbox radius
                   const int32_t* __restrict__ gauss_ids,     // (I,)
                   const int32_t* __restrict__ tile_offsets,  // (T + 1,)
                   const float* __restrict__ g_color,    // (H, W, C)
                   const float* __restrict__ g_alpha,    // (H, W)
                   const int32_t* __restrict__ livecnt,  // (H, W)
                   const float* __restrict__ t_final,    // (H, W), reverse walk
                   const float* __restrict__ r_total,    // (H, W), forward walk
                   int C, int width, int height, int tiles_w, int gate, int num_isects,
                   float* __restrict__ scratch)          // (Q, I, 6 + C)
{
    constexpr int kSide = TILE / kQuad;  // quadrants per tile side
    __shared__ float s_mx[kBatch], s_my[kBatch];
    __shared__ float s_ca[kBatch], s_cb[kBatch], s_cc[kBatch];
    __shared__ float s_op[kBatch];
    __shared__ float s_col[kBatch * kMaxChannels];
    __shared__ int s_pos[kBatch];        // batch slot -> compacted position, or -1
    __shared__ int s_rank[kBatch];       // compacted position -> batch slot
    __shared__ int s_npass;
    // per-warp sums of each compacted slot's terms: [warp][slot][term]
    __shared__ float s_part[kWarps * kBatch * kCols];
    __shared__ int s_maxlive;

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
    const float ctx = (float)qx;  // floorf((px - 0.5) / 16) for every pixel of the quadrant
    const float cty = (float)qy;

    const int start = tile_offsets[tile];
    const int n = tile_offsets[tile + 1] - start;
    const int J = 6 + C;
    float* part_out = scratch + ((size_t)q * num_isects + start) * J;

    int lc = 0;
    float T = 1.0f;
    float rt = 0.0f;
    float ga = 0.0f;
    float gc[kMaxChannels];
#pragma unroll
    for (int c = 0; c < kMaxChannels; ++c) gc[c] = 0.0f;
    if (inside) {
        const int pix = y * width + x;
        lc = livecnt[pix];
        if (FWD) rt = r_total[pix];
        else T = t_final[pix];
        ga = g_alpha[pix];
#pragma unroll
        for (int c = 0; c < kMaxChannels; ++c)
            if (c < C) gc[c] = g_color[pix * C + c];
    }
    if (tid == 0) s_maxlive = 0;
    __syncthreads();
    if (lc > 0) atomicMax(&s_maxlive, lc);  // a max: the same for any order
    __syncthreads();
    const int maxlive = s_maxlive;

    // slots at or past every pixel's termination in this quadrant: zeros
    for (int o = maxlive * J + tid; o < n * J; o += kThreads) part_out[o] = 0.0f;

    float r_after = 0.0f;  // reverse: the sum of w b over the deeper slots
    float s_cum = 0.0f;    // forward: the sum of w b up to the slot
    bool done = !inside;   // forward: the pixel has terminated, as in the forward
    const int last_lo = maxlive > 0 ? ((maxlive - 1) / kBatch) * kBatch : -kBatch;
    for (int it = 0; it <= last_lo / kBatch; ++it) {
        const int lo = FWD ? it * kBatch : last_lo - it * kBatch;
        const int nb = min(kBatch, maxlive - lo);
        // also the barrier that keeps the previous batch's rows and sums
        // until every thread has read them
        __syncthreads();
        if (warp == 0) {
            // load the batch, keep the slots whose contract bbox holds the
            // quadrant (all of them at tile 16), compacted in walk order
            bool pass = false;
            int g = 0;
            if (lane < nb) {
                g = gauss_ids[start + lo + lane];
                pass = true;
                if (gate) {
                    // the forward's f32 bbox arithmetic (/16 is exact)
                    const float r = radii[g];
                    const float mx = means2d[2 * g], my = means2d[2 * g + 1];
                    pass = ctx >= floorf((mx - r) / kContractTile) && ctx < ceilf((mx + r) / kContractTile) &&
                           cty >= floorf((my - r) / kContractTile) && cty < ceilf((my + r) / kContractTile);
                }
            }
            const unsigned mask = __ballot_sync(0xffffffffu, pass);
            const int pos = __popc(mask & ((1u << lane) - 1u));
            s_pos[lane] = pass ? pos : -1;
            if (lane == 0) s_npass = __popc(mask);
            if (pass) {
                s_rank[pos] = lane;
                s_mx[pos] = means2d[2 * g];
                s_my[pos] = means2d[2 * g + 1];
                s_ca[pos] = conics[3 * g];
                s_cb[pos] = conics[3 * g + 1];
                s_cc[pos] = conics[3 * g + 2];
                s_op[pos] = opacities[g];
                for (int c = 0; c < C; ++c) s_col[pos * kMaxChannels + c] = colors[g * C + c];
            }
        }
        __syncthreads();
        const int np = s_npass;

        for (int kk = 0; kk < np; ++kk) {
            const int k = FWD ? kk : np - 1 - kk;  // compacted position, in walk order
            float v[kCols];
#pragma unroll
            for (int j = 0; j < kCols; ++j) v[j] = 0.0f;
            bool contrib = false;
            // reverse: the slot is live for the pixel when its rank in the
            // run is below the pixel's livecnt
            if (FWD ? !done : lo + s_rank[k] < lc) {
                const float dx = s_mx[k] - px;
                const float dy = s_my[k] - py;
                const float ca = s_ca[k], cb = s_cb[k], cc = s_cc[k];
                // sigma and alpha as rasterize_fwd.cu computes them
                const float sigma = 0.5f * (ca * dx * dx + cc * dy * dy) + cb * dx * dy;
                const float raw = s_op[k] * expf(-sigma);
                const float alpha = fminf(kMaxAlpha, raw);
                const bool vis = sigma >= 0.0f && alpha >= kAlphaThreshold;
                if (vis) {
                    const float om = 1.0f - alpha;
                    float b = ga;
#pragma unroll
                    for (int c = 0; c < kMaxChannels; ++c)
                        if (c < C) b += gc[c] * s_col[k * kMaxChannels + c];
                    float t_excl, da;
                    if (FWD) {
                        const float next_T = T * om;
                        if (next_T <= kTransmittanceEps) {
                            done = true;  // the forward stopped here: not composited
                        } else {
                            t_excl = T;
                            s_cum += alpha * t_excl * b;
                            da = t_excl * b - (rt - s_cum) / om;
                            T = next_T;
                            contrib = true;
                        }
                    } else {
                        t_excl = T / om;
                        da = t_excl * b - r_after / om;
                        r_after += alpha * t_excl * b;
                        T = t_excl;
                        contrib = true;
                    }
                    if (contrib) {
                        const float w = alpha * t_excl;
                        const float dsig = raw <= kMaxAlpha ? -alpha * da : 0.0f;
                        v[0] = dsig * (ca * dx + cb * dy);
                        v[1] = dsig * (cb * dx + cc * dy);
                        v[2] = 0.5f * dsig * dx * dx;
                        v[3] = dsig * dx * dy;
                        v[4] = 0.5f * dsig * dy * dy;
                        v[5] = dsig;
#pragma unroll
                        for (int c = 0; c < kMaxChannels; ++c)
                            if (c < C) v[6 + c] = w * gc[c];
                    }
                }
            }
            float* part = s_part + (warp * kBatch + k) * kCols;
            if (__any_sync(0xffffffffu, contrib)) {
#pragma unroll
                for (int j = 0; j < kCols; ++j) {
                    if (j < J) {
                        float s = v[j];
#pragma unroll
                        for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
                        if (lane == 0) part[j] = s;
                    }
                }
            } else if (lane == 0) {
                for (int j = 0; j < J; ++j) part[j] = 0.0f;
            }
        }
        __syncthreads();

        // sum the warps of each slot in a fixed order; zeros for the slots
        // the quadrant skipped
        for (int o = tid; o < nb * J; o += kThreads) {
            const int b = o / J;
            const int j = o - b * J;
            const int k = s_pos[b];
            float s = 0.0f;
            if (k >= 0)
                for (int w = 0; w < kWarps; ++w) s += s_part[(w * kBatch + k) * kCols + j];
            part_out[(size_t)(lo + b) * J + j] = s;
        }
    }
}

// rows[i][d] from the Q quadrant partials of slot i, added in quadrant order;
// zeros for a padding slot (gauss_ids[i] >= num_gauss).
__global__ void __launch_bounds__(kCombineThreads)
rasterize_bwd_combine(const float* __restrict__ scratch,     // (Q, I, 6 + C)
                      const float* __restrict__ opacities,   // (N,)
                      const int32_t* __restrict__ gauss_ids, // (I,)
                      int C, int Q, int num_isects, int num_gauss,
                      float* __restrict__ out_rows)          // (I, 8 + C)
{
    const int D = kHead + C;
    const int J = 6 + C;
    const size_t o = (size_t)blockIdx.x * kCombineThreads + threadIdx.x;
    if (o >= (size_t)num_isects * D) return;
    const int i = (int)(o / D);
    const int d = (int)(o - (size_t)i * D);
    const int g = gauss_ids[i];
    if (g < 0 || g >= num_gauss) {
        out_rows[o] = 0.0f;
        return;
    }
    const int j = d < 6 ? d : (d < kHead ? d - 6 : d - 2);
    float s = 0.0f;
    for (int q = 0; q < Q; ++q) s += scratch[((size_t)q * num_isects + i) * J + j];
    float val = s;
    if (d == 5) {
        const float op = opacities[g];
        val = (op > 0.0f && s != 0.0f) ? -s / op : 0.0f;
    } else if (d == 6 || d == 7) {
        val = fabsf(s);  // after the whole kernel tile's sum
    }
    out_rows[o] = val;
}

template <bool FWD>
int launch(const void* means2d, const void* conics, const void* opacities, const void* colors, const void* radii,
           const void* gauss_ids, const void* tile_offsets, const void* g_color, const void* g_alpha,
           const void* livecnt, const void* t_final, const void* r_total, int C, int width, int height,
           int tile_size, int tiles_w, int tiles_h, int gate, int num_isects, int num_gauss, void* out_rows,
           void* scratch, int parts, void* stream) {
    if (C < 1 || C > kMaxChannels || num_isects < 0 || num_gauss < 0 || parts < 1 || parts > 3)
        return (int)cudaErrorInvalidValue;
    if (tile_size != 16 && tile_size != 32) return (int)cudaErrorInvalidValue;
    const int num_tiles = tiles_w * tiles_h;
    const int Q = (tile_size / kQuad) * (tile_size / kQuad);
    cudaStream_t s = (cudaStream_t)stream;
    if ((parts & 1) && num_tiles > 0) {
        dim3 grid(Q, num_tiles);
#define FG_LAUNCH(TS)                                                                                        \
        rasterize_bwd_walk<TS, FWD><<<grid, kThreads, 0, s>>>(                                               \
            (const float*)means2d, (const float*)conics, (const float*)opacities, (const float*)colors,     \
            (const float*)radii, (const int32_t*)gauss_ids, (const int32_t*)tile_offsets,                   \
            (const float*)g_color, (const float*)g_alpha, (const int32_t*)livecnt, (const float*)t_final,   \
            (const float*)r_total, C, width, height, tiles_w, gate, num_isects, (float*)scratch)
        if (tile_size == 16) FG_LAUNCH(16);
        else FG_LAUNCH(32);
#undef FG_LAUNCH
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    const size_t elements = (size_t)num_isects * (kHead + C);
    if ((parts & 2) && elements > 0) {
        const unsigned blocks = (unsigned)((elements + kCombineThreads - 1) / kCombineThreads);
        rasterize_bwd_combine<<<blocks, kCombineThreads, 0, s>>>(
            (const float*)scratch, (const float*)opacities, (const int32_t*)gauss_ids, C, Q, num_isects, num_gauss,
            (float*)out_rows);
    }
    return (int)cudaGetLastError();
}

}  // namespace

// The reverse walk, from the forward's t_final. scratch: (Q, I, 6 + C) f32,
// Q = (tile_size / 16)^2. num_gauss: N, the padding id of gauss_ids. parts:
// 1 the quadrant walk (into scratch), 2 the combine (scratch into out_rows),
// 3 both.
extern "C" int rasterize_bwd(const void* means2d, const void* conics, const void* opacities,
                             const void* colors, const void* radii, const void* gauss_ids,
                             const void* tile_offsets, const void* g_color, const void* g_alpha,
                             const void* livecnt, const void* t_final, int C, int width, int height,
                             int tile_size, int tiles_w, int tiles_h, int gate, int num_isects, int num_gauss,
                             void* out_rows, void* scratch, int parts, void* stream) {
    return launch<false>(means2d, conics, opacities, colors, radii, gauss_ids, tile_offsets, g_color, g_alpha,
                         livecnt, t_final, nullptr, C, width, height, tile_size, tiles_w, tiles_h, gate, num_isects,
                         num_gauss, out_rows, scratch, parts, stream);
}

// The forward walk, from the per-pixel totals r_total (H, W).
extern "C" int rasterize_bwd_fwd(const void* means2d, const void* conics, const void* opacities,
                                 const void* colors, const void* radii, const void* gauss_ids,
                                 const void* tile_offsets, const void* g_color, const void* g_alpha,
                                 const void* livecnt, const void* r_total, int C, int width, int height,
                                 int tile_size, int tiles_w, int tiles_h, int gate, int num_isects, int num_gauss,
                                 void* out_rows, void* scratch, int parts, void* stream) {
    return launch<true>(means2d, conics, opacities, colors, radii, gauss_ids, tile_offsets, g_color, g_alpha,
                        livecnt, nullptr, r_total, C, width, height, tile_size, tiles_w, tiles_h, gate, num_isects,
                        num_gauss, out_rows, scratch, parts, stream);
}

extern "C" const char* rasterize_bwd_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
