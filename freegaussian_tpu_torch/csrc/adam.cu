// Adam's update of every optimizer group of a training step in one pass, with
// the dead-slot mask of the Gaussian groups folded in.
//
// Replaces no TPU kernel: the JAX package's optax update is fused by XLA.
// The port's plain version (ops/adam_cuda.py:adam_plain) is a chain of
// separate elementwise kernels per tensor, each a pass over memory. Per
// element, in optax's order and with every product and sum rounded on its
// own, as those kernels round them:
//   g  = alive[e / row_width] ? g : +0   (Gaussian tensors; a select, so a
//                                         NaN or inf of a dead row is dropped)
//   mu = mu b1 + g c1
//   nu = nu b2 + (g g) c2
//   u  = (mu inv_bc1) / (sqrt(nu inv_bc2) + eps)
//   p  = p + u neg_lr
// with c1 = f32(1 - b1) and c2 = f32(1 - b2) taken in double, and a group's
// (neg_lr, inv_bc1, inv_bc2) read from a device row (a CUDA graph's table)
// or passed as values (an eager step). A Gaussian tensor's gradient may be
// a view whose slot rows lie apart (the SH coefficients' gradients are
// slices of one (N, 16, 3) gradient): it is read in place, by row stride.
//
// Bound on an H100: bytes. Each element reads p, g, mu and nu and writes p,
// mu and nu (28 bytes, plus one mask byte a Gaussian slot) against ~12 f32
// operations. Design: every byte is read once and written once. The tensor
// table travels in the kernel's parameters (a __grid_constant__ struct, so
// a CUDA graph captures it as a value), and the work is a flat list of
// 4096-element items over all tensors, one 512-thread block an item, which
// the card's block scheduler spreads over the 132 SMs as they free up. A
// thread takes one 16-byte vector of each operand at a time, with streaming
// (evict-first) loads and stores, and the SM's many resident warps keep the
// loads in flight; a row-strided gradient takes four scalar loads, and the
// vector's slots come from one division. A tensor whose pointers are not
// all 16-byte aligned, and the tail of a tensor, take scalar loads. A
// missing gradient reads as +0 with no load. Measured on an H100 (700 W) at the training
// cells' 2^19 slots, 0.88 GB a step: 0.302 ms, 87% of HBM3's 3.35 TB/s. A
// grid of the resident blocks walking the items, with 16 vectors a thread
// in flight, reached 81-83%; 256-thread blocks holding two or four vectors
// a thread, 83-87%.
//
// Built with -fmad=false, and written with the _rn intrinsics besides, so
// that no product and sum fuse: the kernel equals the plain chain bit for
// bit.
//
// Plain C interface (loaded with ctypes); launches on the caller's stream,
// allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxTensors = 48;
constexpr int kMaxGroups = 16;
constexpr int kThreads = 512;
constexpr int kChunk = 4096;  // elements of one work item: two float4s of each operand a thread

struct Group {
    const float* scalars;  // (neg_lr, inv_bc1, inv_bc2) on the device, or null: the values below
    float neg_lr, inv_bc1, inv_bc2;
    float b1, c1, b2, c2, eps;
};

struct Table {
    float* p[kMaxTensors];
    const float* g[kMaxTensors];  // null: a zero gradient
    float* mu[kMaxTensors];
    float* nu[kMaxTensors];
    const unsigned char* alive;      // (capacity,) bool
    int numel[kMaxTensors];
    int row_width[kMaxTensors];      // elements of one slot (masked by alive), or 0: no mask
    int g_stride[kMaxTensors];       // elements from one slot's gradient row to the next, or 0: contiguous
    int group[kMaxTensors];
    int chunk_start[kMaxTensors + 1];  // each tensor's first work item; [num_tensors]: the items
    int num_tensors;
    Group groups[kMaxGroups];
};

struct Consts {
    float b1, c1, b2, c2, eps, neg_lr, inv_bc1, inv_bc2;
};

__device__ __forceinline__ void adam_element(float& p, float g, float& mu, float& nu, const Consts& q) {
    mu = __fadd_rn(__fmul_rn(mu, q.b1), __fmul_rn(g, q.c1));
    nu = __fadd_rn(__fmul_rn(nu, q.b2), __fmul_rn(__fmul_rn(g, g), q.c2));
    const float u = __fdiv_rn(__fmul_rn(mu, q.inv_bc1), __fadd_rn(__fsqrt_rn(__fmul_rn(nu, q.inv_bc2)), q.eps));
    p = __fadd_rn(p, __fmul_rn(u, q.neg_lr));
}

// The gradient of element r of slot `slot` of a masked tensor: read by row
// stride `gs` when not 0, else the value `g` already loaded; +0 on a dead
// slot.
__device__ __forceinline__ float masked(float g, const float* grad, const unsigned char* alive, unsigned slot,
                                        unsigned r, unsigned gs) {
    if (gs != 0u) g = grad[(size_t)slot * gs + r];
    return __ldg(alive + slot) ? g : 0.0f;
}

// (slot, r): element r of slot `slot`; the next element's.
__device__ __forceinline__ void next_element(unsigned& slot, unsigned& r, unsigned rw) {
    if (++r == rw) {
        r = 0u;
        ++slot;
    }
}

__global__ void __launch_bounds__(kThreads) adam_kernel(const __grid_constant__ Table t) {
    const int c = blockIdx.x;
    // the tensor of item c: the last whose first item is <= c
    int k = 0, hi = t.num_tensors - 1;
    while (k < hi) {
        const int mid = (k + hi + 1) >> 1;
        if (t.chunk_start[mid] <= c) k = mid;
        else hi = mid - 1;
    }
    const Group& gr = t.groups[t.group[k]];
    Consts q{gr.b1, gr.c1, gr.b2, gr.c2, gr.eps, gr.neg_lr, gr.inv_bc1, gr.inv_bc2};
    if (gr.scalars != nullptr) {
        q.neg_lr = gr.scalars[0];
        q.inv_bc1 = gr.scalars[1];
        q.inv_bc2 = gr.scalars[2];
    }
    float* p = t.p[k];
    const float* g = t.g[k];
    float* mu = t.mu[k];
    float* nu = t.nu[k];
    const unsigned rw = (unsigned)t.row_width[k];
    const unsigned gs = (unsigned)t.g_stride[k];  // not 0 only with a gradient of a masked tensor
    const float* gvec = gs == 0u ? g : nullptr;   // a gradient read as vectors
    const int begin = (c - t.chunk_start[k]) * kChunk;
    const int end = min(begin + kChunk, t.numel[k]);
    const bool aligned = ((reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(gvec) |
                           reinterpret_cast<uintptr_t>(mu) | reinterpret_cast<uintptr_t>(nu)) & 15u) == 0;
    const int nvec = aligned ? (end - begin) / 4 : 0;
    for (int v = threadIdx.x; v < nvec; v += kThreads) {
        const int e = begin + 4 * v;
        float4 pv = __ldcs(reinterpret_cast<const float4*>(p + e));
        float4 gv = gvec != nullptr ? __ldcs(reinterpret_cast<const float4*>(gvec + e)) : make_float4(0.f, 0.f, 0.f, 0.f);
        float4 mv = __ldcs(reinterpret_cast<const float4*>(mu + e));
        float4 nv = __ldcs(reinterpret_cast<const float4*>(nu + e));
        if (rw != 0u) {
            unsigned slot = (unsigned)e / rw, r = (unsigned)e - slot * rw;
            gv.x = masked(gv.x, g, t.alive, slot, r, gs);
            next_element(slot, r, rw);
            gv.y = masked(gv.y, g, t.alive, slot, r, gs);
            next_element(slot, r, rw);
            gv.z = masked(gv.z, g, t.alive, slot, r, gs);
            next_element(slot, r, rw);
            gv.w = masked(gv.w, g, t.alive, slot, r, gs);
        }
        adam_element(pv.x, gv.x, mv.x, nv.x, q);
        adam_element(pv.y, gv.y, mv.y, nv.y, q);
        adam_element(pv.z, gv.z, mv.z, nv.z, q);
        adam_element(pv.w, gv.w, mv.w, nv.w, q);
        __stcs(reinterpret_cast<float4*>(p + e), pv);
        __stcs(reinterpret_cast<float4*>(mu + e), mv);
        __stcs(reinterpret_cast<float4*>(nu + e), nv);
    }
    for (int e = begin + 4 * nvec + threadIdx.x; e < end; e += kThreads) {
        float pe = p[e], me = mu[e], ne = nu[e];
        float ge = gvec != nullptr ? gvec[e] : 0.0f;
        if (rw != 0u) {
            const unsigned slot = (unsigned)e / rw;
            ge = masked(ge, g, t.alive, slot, (unsigned)e - slot * rw, gs);
        }
        adam_element(pe, ge, me, ne, q);
        p[e] = pe;
        mu[e] = me;
        nu[e] = ne;
    }
}

}  // namespace

extern "C" int adam_table_bytes() { return (int)sizeof(Table); }
extern "C" int adam_max_tensors() { return kMaxTensors; }
extern "C" int adam_max_groups() { return kMaxGroups; }
extern "C" int adam_chunk() { return kChunk; }

// One launch over the table: a block for each work item.
extern "C" int adam_launch(const void* table, void* stream) {
    const Table* t = (const Table*)table;
    if (t->num_tensors < 1 || t->num_tensors > kMaxTensors) return (int)cudaErrorInvalidValue;
    const int items = t->chunk_start[t->num_tensors];
    if (items <= 0) return (int)cudaErrorInvalidValue;
    adam_kernel<<<items, kThreads, 0, (cudaStream_t)stream>>>(*t);
    return (int)cudaGetLastError();
}

extern "C" const char* adam_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
