// Merged encode kernel for Hopper (sm_90a): k4.
//
// Replaces the Pallas TPU kernel _make_merged_kernel
// (foldcomp_tpu/kernels/pallas_encode.py:147). It computes what that kernel
// computes; the plain PyTorch version beside it
// (foldcomp_tpu_torch/kernels/fused_encode.py merged_plain) is the oracle.
//
// For every (protein b, residue r): unpack the residue's 14 atom slots,
// then the three backbone dihedral-cosine planes and three bond-cosine
// planes of the windows that start at backbone atoms 3r, 3r+1, 3r+2 (they
// reach into residue r+1; residue L-1 wraps onto residue 0, a row the
// epilogue masks), and the eleven side-chain dihedral cosines over the
// predecessor table. Outputs are plane-major [planes, B, L]:
//   tcos, bcos, relt, relb f32 [3, B, L]; tbits i32 [3, B, L] (1 tie,
//   2 guard, 4 det < 0, 8 bond tie, 16 bond guard, 32 det within noise);
//   scc f32 [11, B, L]; scb i32 [B, L] (bit j bad, bit 11+j det < 0).
//
// Two loaders behind one template parameter, everything after the load
// shared:
//  - compact: baseT i32 [3, B, L], deltaT i16 [42, B, L], present u16
//    [B, L] (native fcz_pack_encode_wire's plane-major wire), slot k's
//    coordinate = present bit k ? base + delta : 0, then the correctly
//    rounded /1000 from exact mul/add (kernels/encode.py _div1000_cr);
//  - f32: atom14 f32 [B, L, 14, 3] as is (the input of the JAX package's
//    XLA core encode_parity_core).
//
// Design. One thread per (protein, residue), 128 residues of one protein
// per block: for a fixed plane, neighbouring threads read and write
// neighbouring addresses. The side-chain predecessors index a thread's 42
// coordinates at run time, so they live in shared memory as [42][128]
// floats (a thread's column is its own bank: no conflicts for any index)
// instead of a register array that would spill. Residue r+1's slots 0..2
// come from the neighbouring column, or from global memory for the last
// residue of a tile. The predecessor table is a device-pointer argument
// copied into shared memory at block start: per-lane indices into
// __constant__ memory serialise (k3's lesson, PERF.md). The TPU kernel's
// where-chains (_sel_pred), protein block, length bound (MAX_L_FUSED) and
// prologue transposes have no counterpart.
//
// Bound: about 98 B in and 108 B out per residue slot, and ~2.5k float
// operations (17 dihedrals or bond angles with Dekker double-f32 division
// for the six backbone ones); at B=2048, L=1088 that is ~460 MB, so the
// memory floor is ~0.15 ms on an H100.
//
// Float rules (nvcc -fmad=false, no --use_fast_math; build.py): no FMA
// contraction, so _two_prod and _div1000_cr stay exact; IEEE sqrtf and
// '/', on which _cos_f64_emul and scc depend; rsqrtf only where JAX has
// lax.rsqrt (relt, relb); NaN-propagating max as jnp.maximum.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kAtoms = 14;
constexpr int kSlots = 3 * kAtoms;
constexpr int kTile = 128;   // residues per block
constexpr int kCodes = 24;   // PRED_IDX rows; codes are clipped to 0..23

struct V {
  float x, y, z;
};

__device__ __forceinline__ V sub(V a, V b) {
  V v;
  v.x = a.x - b.x;
  v.y = a.y - b.y;
  v.z = a.z - b.z;
  return v;
}

__device__ __forceinline__ V neg(V a) {
  V v;
  v.x = -a.x;
  v.y = -a.y;
  v.z = -a.z;
  return v;
}

// jnp.maximum(a, b): NaN in a propagates (fmaxf would drop it)
__device__ __forceinline__ float max_nan(float a, float b) {
  return a != a ? a : fmaxf(a, b);
}

// _div1000_cr (foldcomp_tpu/kernels/encode.py:53)
__device__ __forceinline__ float div1000_cr(int xi) {
  const float xf = (float)xi;
  const float c = 0.001f;
  float q = xf * c;
#pragma unroll
  for (int it = 0; it < 2; ++it) {
    const float s = q * 4097.0f;
    const float hi = s - (s - q);
    const float lo = q - hi;
    const float r = (xf - hi * 1000.0f) - lo * 1000.0f;
    q = q + r * c;
  }
  return q;
}

// _two_prod (encode.py:220): a*b = p + e exactly
__device__ __forceinline__ void two_prod(float a, float b, float* p,
                                         float* e) {
  *p = a * b;
  const float s = a * 4097.0f;
  const float ah = s - (s - a);
  const float al = a - ah;
  const float t = b * 4097.0f;
  const float bh = t - (t - b);
  const float bl = b - bh;
  *e = ((ah * bh - *p) + ah * bl + al * bh) + al * bl;
}

// _cos_f64_emul (encode.py:233): float round of inner / sqrt(denom2) in
// double-f32, and whether it is a rounding tie. denom2 > 0.
__device__ __forceinline__ float cos_f64_emul(float inner, float denom2,
                                              bool* tie) {
  const float s = sqrtf(denom2);
  float p, pe;
  two_prod(s, s, &p, &pe);
  const float r = (denom2 - p) - pe;
  const float e = r / (s + s);
  const float q0 = inner / s;
  float qp, qpe;
  two_prod(q0, s, &qp, &qpe);
  const float rr = ((inner - qp) - qpe) - q0 * e;
  const float corr = rr / s;
  const float c = q0 + corr;
  const float resid = (q0 - c) + corr;
  const float ulp = fabsf(c) * 1.1920928955078125e-7f + 1e-38f;
  *tie = fabsf(resid) > 0.499f * ulp;
  return c;
}

struct Dihedral {
  float inner, denom2, det, abs_inner, abs_det;
};

// cross products, inner, denom2 and the sign determinant in the XLA
// core's order (torsion_angle.cpp:46-96)
__device__ __forceinline__ Dihedral dihedral_parts(V d1, V d2, V d3) {
  const float u1x = d1.y * d2.z - d2.y * d1.z;
  const float u1y = d1.z * d2.x - d2.z * d1.x;
  const float u1z = d1.x * d2.y - d2.x * d1.y;
  const float u2x = d2.y * d3.z - d3.y * d2.z;
  const float u2y = d2.z * d3.x - d3.z * d2.x;
  const float u2z = d2.x * d3.y - d3.x * d2.y;
  const float pbx = u2y * d2.z - d2.y * u2z;
  const float pby = u2z * d2.x - d2.z * u2x;
  const float pbz = u2x * d2.y - d2.x * u2y;
  Dihedral h;
  h.inner = u1x * u2x + u1y * u2y + u1z * u2z;
  h.denom2 = (u1x * u1x + u1y * u1y + u1z * u1z) *
             (u2x * u2x + u2y * u2y + u2z * u2z);
  h.det = u1x * pbx + u1y * pby + u1z * pbz;
  h.abs_inner = fabsf(u1x * u2x) + fabsf(u1y * u2y) + fabsf(u1z * u2z);
  h.abs_det = fabsf(u1x * pbx) + fabsf(u1y * pby) + fabsf(u1z * pbz);
  return h;
}

// _dihedral_cos (pallas_encode.py:82)
__device__ __forceinline__ void dihedral_cos(V d1, V d2, V d3, float eps,
                                             float* cos_t, int* bits,
                                             float* rel) {
  const Dihedral h = dihedral_parts(d1, d2, d3);
  const bool bad = h.denom2 <= 0.0f;
  bool tie;
  const float c = cos_f64_emul(h.inner, bad ? 1.0f : h.denom2, &tie);
  const bool guard_neg = bad && h.denom2 == 0.0f && h.inner < 0.0f;
  *cos_t = bad ? (guard_neg ? -2.0f : 2.0f) : c;
  *bits = (int)tie | ((int)bad << 1) | ((int)(h.det < 0.0f) << 2) |
          ((int)(fabsf(h.det) <= eps * h.abs_det) << 5);
  *rel = h.abs_inner * rsqrtf(max_nan(h.denom2, 1e-30f));
}

// _bond_cos (pallas_encode.py:127): no NaN guard
__device__ __forceinline__ void bond_cos(V e1, V e2, float* cos_b, int* bits,
                                         float* rel) {
  const float inner = e1.x * e2.x + e1.y * e2.y + e1.z * e2.z;
  const float denom2 = (e1.x * e1.x + e1.y * e1.y + e1.z * e1.z) *
                       (e2.x * e2.x + e2.y * e2.y + e2.z * e2.z);
  const bool bad = denom2 <= 0.0f;
  bool tie;
  *cos_b = cos_f64_emul(inner, bad ? 1.0f : denom2, &tie);
  *bits = ((int)tie << 3) | ((int)bad << 4);
  const float abs_b =
      fabsf(e1.x * e2.x) + fabsf(e1.y * e2.y) + fabsf(e1.z * e2.z);
  *rel = abs_b * rsqrtf(max_nan(denom2, 1e-30f));
}

// coordinate j (slot j/3, component j%3) of the residue at flat offset o
template <bool kF32>
__device__ __forceinline__ float load_coord(const int32_t* __restrict__ baseT,
                                            const int16_t* __restrict__ deltaT,
                                            int pres,
                                            const float* __restrict__ atom14,
                                            size_t plane, size_t o, int j) {
  if (kF32) return atom14[o * kSlots + j];
  const int k = j / 3;
  const int xi = (int)deltaT[(size_t)j * plane + o] +
                 baseT[(size_t)(j - 3 * k) * plane + o];
  return div1000_cr(((pres >> k) & 1) ? xi : 0);
}

template <bool kF32>
__global__ void __launch_bounds__(kTile)
    k4_merged(const int32_t* __restrict__ baseT,
              const int16_t* __restrict__ deltaT,
              const uint16_t* __restrict__ present,
              const float* __restrict__ atom14,
              const int32_t* __restrict__ res_code,
              const int32_t* __restrict__ pred, float eps,
              float* __restrict__ tcos, float* __restrict__ bcos,
              int32_t* __restrict__ tbits, float* __restrict__ scc,
              int32_t* __restrict__ scb, float* __restrict__ relt,
              float* __restrict__ relb, int n_b, int n_l) {
  __shared__ int s_pred[kCodes * kAtoms * 3];
  __shared__ float s_xyz[kSlots * kTile];
  const int t = threadIdx.x;
  const int b = blockIdx.x;
  const int r = blockIdx.y * kTile + t;
  const int n_r = min(kTile, n_l - (int)blockIdx.y * kTile);
  const size_t plane = (size_t)n_b * n_l;
  const size_t o = (size_t)b * n_l + r;

  for (int i = t; i < kCodes * kAtoms * 3; i += kTile) s_pred[i] = pred[i];
  if (t < n_r) {
    const int pres = kF32 ? 0 : (int)present[o];
#pragma unroll 6
    for (int j = 0; j < kSlots; ++j)
      s_xyz[j * kTile + t] =
          load_coord<kF32>(baseT, deltaT, pres, atom14, plane, o, j);
  }
  __syncthreads();
  if (t >= n_r) return;

  auto at = [&](int k) {
    V v;
    v.x = s_xyz[(3 * k) * kTile + t];
    v.y = s_xyz[(3 * k + 1) * kTile + t];
    v.z = s_xyz[(3 * k + 2) * kTile + t];
    return v;
  };
  // residue r+1's N, CA, C (r = L-1 wraps onto residue 0)
  V nx[3];
  if (t + 1 < n_r) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      nx[k].x = s_xyz[(3 * k) * kTile + t + 1];
      nx[k].y = s_xyz[(3 * k + 1) * kTile + t + 1];
      nx[k].z = s_xyz[(3 * k + 2) * kTile + t + 1];
    }
  } else {
    const size_t on = (size_t)b * n_l + (r + 1 == n_l ? 0 : r + 1);
    const int pres = kF32 ? 0 : (int)present[on];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      nx[k].x = load_coord<kF32>(baseT, deltaT, pres, atom14, plane, on,
                                 3 * k);
      nx[k].y = load_coord<kF32>(baseT, deltaT, pres, atom14, plane, on,
                                 3 * k + 1);
      nx[k].z = load_coord<kF32>(baseT, deltaT, pres, atom14, plane, on,
                                 3 * k + 2);
    }
  }

  // backbone: d[a] = x[a+1] - x[a] over the chain N, CA, C, N', CA', C'
  const V a0 = at(0), a1 = at(1), a2 = at(2);
  const V dN = sub(a1, a0), dCA = sub(a2, a1), dC = sub(nx[0], a2);
  const V rdN = sub(nx[1], nx[0]), rdCA = sub(nx[2], nx[1]);
  const V tw[3][3] = {{dN, dCA, dC}, {dCA, dC, rdN}, {dC, rdN, rdCA}};
  const V bw[3][2] = {{dN, dCA}, {dCA, dC}, {dC, rdN}};
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    float ct, cb, rt, rb;
    int bt, bb;
    dihedral_cos(tw[p][0], tw[p][1], tw[p][2], eps, &ct, &bt, &rt);
    bond_cos(neg(bw[p][0]), bw[p][1], &cb, &bb, &rb);
    const size_t q = (size_t)p * plane + o;
    tcos[q] = ct;
    bcos[q] = cb;
    tbits[q] = bt | bb;
    relt[q] = rt;
    relb[q] = rb;
  }

  // side chains: slots 3..13 from their three predecessors
  const int code = min(max(res_code[o], 0), kCodes - 1);
  const int* pr = s_pred + code * kAtoms * 3;
  int bits = 0;
  for (int k = 3; k < kAtoms; ++k) {
    const V p0 = at(pr[3 * k]), p1 = at(pr[3 * k + 1]), p2 = at(pr[3 * k + 2]);
    const Dihedral h = dihedral_parts(sub(p1, p0), sub(p2, p1), sub(at(k), p2));
    const bool bad = h.denom2 <= 0.0f;
    const int j = k - 3;
    scc[(size_t)j * plane + o] = h.inner / sqrtf(bad ? 1.0f : h.denom2);
    bits |= ((int)bad << j) | ((int)(h.det < 0.0f) << (11 + j));
  }
  scb[o] = bits;
}

}  // namespace

extern "C" {

// k4 over B proteins of L residue slots. atom14 == NULL selects the compact
// loader (baseT, deltaT, present); otherwise those three are unused.
cudaError_t fe_merged(const int32_t* baseT, const int16_t* deltaT,
                      const uint16_t* present, const float* atom14,
                      const int32_t* res_code, const int32_t* pred,
                      float* tcos, float* bcos, int32_t* tbits, float* scc,
                      int32_t* scb, float* relt, float* relb, float eps,
                      int n_b, int n_l, cudaStream_t stream) {
  const dim3 grid(n_b, (n_l + kTile - 1) / kTile);
  if (atom14 != nullptr)
    k4_merged<true><<<grid, kTile, 0, stream>>>(
        baseT, deltaT, present, atom14, res_code, pred, eps, tcos, bcos,
        tbits, scc, scb, relt, relb, n_b, n_l);
  else
    k4_merged<false><<<grid, kTile, 0, stream>>>(
        baseT, deltaT, present, atom14, res_code, pred, eps, tcos, bcos,
        tbits, scc, scb, relt, relb, n_b, n_l);
  return cudaGetLastError();
}

}  // extern "C"
