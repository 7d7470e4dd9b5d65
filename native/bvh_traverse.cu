// Per-ray BVH traversal for NVIDIA GPUs, called from JAX through the XLA FFI.
//
// One thread walks one ray with a private stack in local memory (Aila &
// Laine 2009, "while-while" collapsed to one loop). Children are pushed
// nearest-last so the nearest pops first; leaves ride the stack as tagged
// refs, and a popped entry farther than the current hit is skipped.
//
// Layout (built by embree_tpu/traverse/gpu.py:pack_gpu_bvh):
//   nodes  (M, 8W) f32: [lo_x[W] lo_y[W] lo_z[W] hi_x[W] hi_y[W] hi_z[W]
//                        child[W] count[W]], child/count as int32 bits.
//          count: 0 inner, >0 leaf prim count, <0 empty slot. One BVH4
//          node is 128 bytes.
//   tris   (T, 12) f32 in leaf order: [v0 e1 e2 Ng] with e1 = v0 - v1,
//          e2 = v2 - v0, Ng = cross(e2, e1) (precomputed Moeller-Trumbore).
//   order  (T,) i32 leaf slot -> committed prim index.
//   rays   (R, 8) f32: [org.xyz tnear dir.xyz tfar].
// Outputs: t (R,) f32, prim (R,) i32 (committed prim index, -1 = miss;
// any-hit writes t = -inf on a hit), stats (blocks, 3) i32 per block:
// [inner nodes popped, leaf prim tests, stack overflows].
//
// Built with --fmad=false so every product and sum rounds as in the XLA
// walk (traverse/packet.py) and the NumPy twin (traverse/gpu.py).

#include <cuda_runtime.h>

#include <cstdint>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kBlock = 128;
constexpr float kInf = __builtin_huge_valf();
// robust slab scaling, node_intersector1.h:108-179 (1 -/+ 3 ulp)
constexpr float kUlp = 1.1920928955078125e-07f;  // 2^-23
constexpr float kRobustMin = 1.0f - 3.0f * kUlp;
constexpr float kRobustMax = 1.0f + 3.0f * kUlp;

__device__ __forceinline__ float rcp_safe(float a) {
  return fabsf(a) < 1e-30f ? (a < 0.0f ? -1e30f : 1e30f) : 1.0f / a;
}

template <int W>
__device__ __forceinline__ void sort_children(float (&key)[W], int (&ref)[W]) {
  // ascending by entry distance; misses carry +inf
#pragma unroll
  for (int i = 0; i < W - 1; ++i) {
#pragma unroll
    for (int j = 0; j < W - 1 - i; ++j) {
      const bool swap = key[j + 1] < key[j];
      const float k0 = key[j], k1 = key[j + 1];
      const int r0 = ref[j], r1 = ref[j + 1];
      key[j] = swap ? k1 : k0;
      key[j + 1] = swap ? k0 : k1;
      ref[j] = swap ? r1 : r0;
      ref[j + 1] = swap ? r0 : r1;
    }
  }
}

template <int W, int S, bool OCC, bool CULL>
__global__ void __launch_bounds__(kBlock)
    traverse_kernel(const float4* __restrict__ nodes,
                    const float4* __restrict__ tris,
                    const int* __restrict__ order,
                    const float4* __restrict__ rays, float* __restrict__ t_out,
                    int* __restrict__ prim_out, int* __restrict__ stats,
                    int64_t num_rays) {
  constexpr int Q = W / 4;  // float4 per field
  const int64_t ray = int64_t(blockIdx.x) * kBlock + threadIdx.x;
  int pops = 0, tests = 0, overflows = 0;

  if (ray < num_rays) {
    const float4 r0 = __ldg(rays + 2 * ray);
    const float4 r1 = __ldg(rays + 2 * ray + 1);
    const float ox = r0.x, oy = r0.y, oz = r0.z, tnear = r0.w;
    const float dx = r1.x, dy = r1.y, dz = r1.z;
    float t = r1.w;
    const float rdx = rcp_safe(dx), rdy = rcp_safe(dy), rdz = rcp_safe(dz);
    const float orx = ox * rdx, ory = oy * rdy, orz = oz * rdz;
    int prim = -1;

    int2 stack[S];
    stack[0] = make_int2(0, __float_as_int(-kInf));
    int sp = 1;
    while (sp > 0) {
      --sp;
      const int2 e = stack[sp];
      if (__int_as_float(e.y) > t) continue;  // pop-cull
      const int ref = e.x;
      if (ref >= 0) {
        ++pops;
        const float4* np4 = nodes + int64_t(ref) * (2 * W);
        float f[8][W];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
#pragma unroll
          for (int q = 0; q < Q; ++q) {
            const float4 v = __ldg(np4 + k * Q + q);
            f[k][4 * q + 0] = v.x;
            f[k][4 * q + 1] = v.y;
            f[k][4 * q + 2] = v.z;
            f[k][4 * q + 3] = v.w;
          }
        }
        float key[W];
        int cref[W];
#pragma unroll
        for (int c = 0; c < W; ++c) {
          const float tx0 = f[0][c] * rdx - orx, tx1 = f[3][c] * rdx - orx;
          const float ty0 = f[1][c] * rdy - ory, ty1 = f[4][c] * rdy - ory;
          const float tz0 = f[2][c] * rdz - orz, tz1 = f[5][c] * rdz - orz;
          float tmin = kRobustMin * fmaxf(fmaxf(fminf(tx0, tx1),
                                                fminf(ty0, ty1)),
                                          fminf(tz0, tz1));
          const float tmax = kRobustMax * fminf(fminf(fmaxf(tx0, tx1),
                                                      fmaxf(ty0, ty1)),
                                                fmaxf(tz0, tz1));
          tmin = fmaxf(tmin, tnear);
          const int child = __float_as_int(f[6][c]);
          const int count = __float_as_int(f[7][c]);
          const bool hit = (tmin <= tmax) && (tmin <= t) && (count >= 0);
          key[c] = hit ? tmin : kInf;
          cref[c] = count > 0 ? -(((child << 4) | count) + 1) : child;
        }
        sort_children<W>(key, cref);
#pragma unroll
        for (int c = W - 1; c >= 0; --c) {
          if (key[c] < kInf) {
            if (sp < S) {
              stack[sp++] = make_int2(cref[c], __float_as_int(key[c]));
            } else {
              ++overflows;
            }
          }
        }
      } else {
        const int v = -ref - 1;
        const int start = v >> 4;
        const int cnt = v & 15;
        tests += cnt;
        bool occluded = false;
        for (int k = 0; k < cnt; ++k) {
          const int p = start + k;
          const float4 a = __ldg(tris + 3 * int64_t(p));
          const float4 b = __ldg(tris + 3 * int64_t(p) + 1);
          const float4 c4 = __ldg(tris + 3 * int64_t(p) + 2);
          const float e1x = a.w, e1y = b.x, e1z = b.y;
          const float e2x = b.z, e2y = b.w, e2z = c4.x;
          const float ngx = c4.y, ngy = c4.z, ngz = c4.w;
          const float cx = a.x - ox, cy = a.y - oy, cz = a.z - oz;
          const float rx = cy * dz - cz * dy;
          const float ry = cz * dx - cx * dz;
          const float rz = cx * dy - cy * dx;
          const float den = ngx * dx + ngy * dy + ngz * dz;
          const float absden = fabsf(den);
          const float sgn = den >= 0.0f ? 1.0f : -1.0f;
          const float us = (rx * e2x + ry * e2y + rz * e2z) * sgn;
          const float vs = (rx * e1x + ry * e1y + rz * e1z) * sgn;
          const float ts = (ngx * cx + ngy * cy + ngz * cz) * sgn;
          const bool front = CULL ? (den < 0.0f) : (den != 0.0f);
          const bool ok = front && us >= 0.0f && vs >= 0.0f &&
                          us + vs <= absden && absden * tnear < ts &&
                          ts <= absden * t;
          if (ok) {
            prim = p;
            if (OCC) {
              occluded = true;
              break;
            }
            t = ts * (1.0f / fmaxf(absden, 1e-37f));
          }
        }
        if (OCC && occluded) {
          t = -kInf;
          break;
        }
      }
    }
    t_out[ray] = t;
    prim_out[ray] = prim >= 0 ? __ldg(order + prim) : -1;
  }

  // per-block counters: warp shuffle, then one shared slot per warp
  __shared__ int partial[kBlock / 32][3];
  int vals[3] = {pops, tests, overflows};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      vals[k] += __shfl_down_sync(0xffffffffu, vals[k], off);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    partial[warp][0] = vals[0];
    partial[warp][1] = vals[1];
    partial[warp][2] = vals[2];
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < kBlock / 32; ++w) s += partial[w][threadIdx.x];
    stats[int64_t(blockIdx.x) * 3 + threadIdx.x] = s;
  }
}

template <int W, int S, bool OCC, bool CULL>
void launch(cudaStream_t stream, const float* nodes, const float* tris,
            const int* order, const float* rays, float* t, int* prim,
            int* stats, int64_t num_rays, int64_t blocks) {
  traverse_kernel<W, S, OCC, CULL><<<blocks, kBlock, 0, stream>>>(
      reinterpret_cast<const float4*>(nodes),
      reinterpret_cast<const float4*>(tris), order,
      reinterpret_cast<const float4*>(rays), t, prim, stats, num_rays);
}

using LaunchFn = void (*)(cudaStream_t, const float*, const float*,
                          const int*, const float*, float*, int*, int*,
                          int64_t, int64_t);

template <int W, int S>
LaunchFn pick_flags(bool occ, bool cull) {
  if (occ) return cull ? launch<W, S, true, true> : launch<W, S, true, false>;
  return cull ? launch<W, S, false, true> : launch<W, S, false, false>;
}

template <int W>
LaunchFn pick_stack(int stack, bool occ, bool cull) {
  switch (stack) {
    case 64: return pick_flags<W, 64>(occ, cull);
    case 128: return pick_flags<W, 128>(occ, cull);
    case 256: return pick_flags<W, 256>(occ, cull);
    default: return nullptr;
  }
}

ffi::Error TraverseImpl(cudaStream_t stream, ffi::Buffer<ffi::F32> nodes,
                        ffi::Buffer<ffi::F32> tris, ffi::Buffer<ffi::S32> order,
                        ffi::Buffer<ffi::F32> rays,
                        ffi::ResultBuffer<ffi::F32> t_out,
                        ffi::ResultBuffer<ffi::S32> prim_out,
                        ffi::ResultBuffer<ffi::S32> stats_out, int32_t width,
                        int32_t stack, int32_t occluded, int32_t cull) {
  const int64_t num_rays = t_out->element_count();
  const int64_t blocks = (num_rays + kBlock - 1) / kBlock;
  if (rays.element_count() != 8 * num_rays ||
      stats_out->element_count() != 3 * blocks)
    return ffi::Error(ffi::ErrorCode::kInvalidArgument,
                      "bvh_traverse: ray or stats buffer has the wrong size");
  if (nodes.element_count() % (8 * width) != 0 ||
      tris.element_count() % 12 != 0)
    return ffi::Error(ffi::ErrorCode::kInvalidArgument,
                      "bvh_traverse: node or triangle table has the wrong size");
  LaunchFn fn = nullptr;
  if (width == 4) fn = pick_stack<4>(stack, occluded != 0, cull != 0);
  if (width == 8) fn = pick_stack<8>(stack, occluded != 0, cull != 0);
  if (fn == nullptr)
    return ffi::Error(ffi::ErrorCode::kInvalidArgument,
                      "bvh_traverse: unsupported width or stack depth");
  if (blocks == 0) return ffi::Error::Success();
  fn(stream, nodes.typed_data(), tris.typed_data(), order.typed_data(),
     rays.typed_data(), t_out->typed_data(), prim_out->typed_data(),
     stats_out->typed_data(), num_rays, blocks);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess)
    return ffi::Error(ffi::ErrorCode::kInternal, cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(EtBvhTraverse, TraverseImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Attr<int32_t>("width")
                                  .Attr<int32_t>("stack")
                                  .Attr<int32_t>("occluded")
                                  .Attr<int32_t>("cull"));
