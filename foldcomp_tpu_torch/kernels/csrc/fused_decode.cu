// Fused ragged-lane decode for Hopper (sm_90a): k1 tails, k2 backbone,
// k3 side chains, and the bb wire's epilogue.
//
// Replaces the three Pallas TPU decode kernels and their bb-wire call site
// in foldcomp_tpu/kernels/pallas_decode.py:
//   k1 fd_tails      <- _make_tails_kernel      (pallas_decode.py:186)
//   k2 fd_backbone   <- _make_backbone_kernel   (pallas_decode.py:227),
//                       with the seed roll of :596-610 (or, for width
//                       classes, the prev_idx gather of :654-670) and the
//                       N-CA lengths of _class_prep (:405-437)
//   k3 fd_sidechain  <- _make_sidechain_kernel  (pallas_decode.py:338)
//   fd_backbone_bb   <- _run_backbone_only      (pallas_decode.py:529):
//                       k2, then its XLA epilogue as k2_bb_out
// Each computes what the Pallas kernel computes; the plain PyTorch
// versions beside them (fused_decode.py tails_plain / backbone_rolled_plain
// / sidechain_plain / bb_epilogue_plain) are the oracle, bit for bit on the
// rows a lane owns.
//
// Layouts are the pack's lane-minor ones (codec/batch.py
// pack_decode_batch_lanes): row-major [rows, NL]. k1 and k2 take one
// thread per lane in the order lane_order gives (by row count, longest
// first), so that a warp's lanes have one length; k2 stages its rows at
// the thread's column and copies them to the lane's (k2_copy_out), or on
// the bb wire turns them into 24 B rows (k2_bb_out); k3 walks groups of
// 32 neighbouring lanes. Each walks a lane's own rows only (r < tat =
// 3*seg_m); the rest is pack padding and is left unwritten. On an H100 at
// B=8192 (PERF.md §6) k2 takes ~0.42 ms, of which the copy ~0.14 and
// k2_bb_out ~0.13; k1, the forward alone, runs near the issue rate.
//
// Float rules (nvcc -fmad=false, no --use_fast_math; build.py):
//  - no FMA contraction, so every expression rounds in the JAX order;
//  - cosf/sinf (full precision, through sincosf: the same values from one
//    range reduction), not __cosf/__sinf;
//  - rsqrtf where JAX uses lax.rsqrt, sqrtf and IEEE '/' where it uses
//    sqrt then divide;
//  - rintf (round half to even) for jnp.round; roundf would round half
//    away from zero;
//  - clip to +-32767 before the int16 cast.
//
// Each launcher is a plain C function: it launches on the given stream,
// does not synchronise, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

// Chemistry tables over all 32 5-bit residue codes and the scalar decode
// constants, copied in from foldcomp_tpu_torch/core/tables.py by
// fd_set_tables (never retyped here). __constant__ memory is per device:
// fd_set_tables fills the current device's copy, and build.py calls it
// once for each device before that device's first launch.
enum { K_C_TO_N = 0, K_CA_TO_C, K_N_TO_CA, K_RADK, K_SC_CONT, K_SC_MIN,
       K_PRO_N_TO_CA, K_COUNT };
#define N_CODES 32
#define MAX_ATOM 14
__constant__ int c_pred[N_CODES * MAX_ATOM * 3];
__constant__ float c_blen[N_CODES * MAX_ATOM];
__constant__ float c_bang[N_CODES * MAX_ATOM];
__constant__ float c_k[K_COUNT];
__constant__ int c_pro_code;  // proline's 5-bit residue code

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) {
  V3 v;
  v.x = x;
  v.y = y;
  v.z = z;
  return v;
}

__device__ __forceinline__ V3 load3(const float* __restrict__ p, size_t row,
                                    int nl, int l) {
  return v3(p[row * nl + l], p[(row + 1) * nl + l], p[(row + 2) * nl + l]);
}

// The frame of _place_atom_cs (pallas_decode.py:93-117): the atom after c
// at offsets (dx, dy, dz) along (bc, n x bc, n), n the normal of (ab, bc).
__device__ __forceinline__ V3 place_frame(V3 a, V3 b, V3 c, float dx,
                                          float dy, float dz) {
  float abx = b.x - a.x, aby = b.y - a.y, abz = b.z - a.z;
  float bcx = c.x - b.x, bcy = c.y - b.y, bcz = c.z - b.z;
  float inv_bc = rsqrtf(fmaxf(bcx * bcx + bcy * bcy + bcz * bcz, 1e-30f));
  float bcnx = bcx * inv_bc, bcny = bcy * inv_bc, bcnz = bcz * inv_bc;
  float nx = aby * bcnz - bcny * abz;
  float ny = abz * bcnx - bcnz * abx;
  float nz = abx * bcny - bcnx * aby;
  float inv_n = rsqrtf(fmaxf(nx * nx + ny * ny + nz * nz, 1e-30f));
  nx = nx * inv_n;
  ny = ny * inv_n;
  nz = nz * inv_n;
  float mx = ny * bcnz - bcny * nz;
  float my = nz * bcnx - bcnz * nx;
  float mz = nx * bcny - bcnx * ny;
  return v3(bcnx * dx + mx * dy + nx * dz + c.x,
            bcny * dx + my * dy + ny * dz + c.y,
            bcnz * dx + mz * dy + nz * dz + c.z);
}

// (cos, sin) of an angle in degrees: one range reduction for both, the
// values of cosf and sinf.
__device__ __forceinline__ float2 cs_deg(float deg) {
  float s, c;
  sincosf(deg * c_k[K_RADK], &s, &c);
  return make_float2(c, s);
}

// _place_atom_cs (pallas_decode.py:93-117): place the atom after c with
// the bond angle and the torsion given as (cos, sin).
__device__ __forceinline__ V3 place_cs(V3 a, V3 b, V3 c, float bond_length,
                                       float cos_ba, float sin_ba,
                                       float2 tor) {
  return place_frame(a, b, c, -bond_length * cos_ba,
                     bond_length * tor.x * sin_ba,
                     bond_length * tor.y * sin_ba);
}

// place_atom_c (foldcomp_tpu/kernels/geometry.py:78-112): the bond angle
// in degrees.
__device__ __forceinline__ V3 place_deg(V3 a, V3 b, V3 c, float bond_length,
                                        float bond_angle_deg, float2 tor) {
  const float2 ba = cs_deg(bond_angle_deg);
  return place_cs(a, b, c, bond_length, ba.x, ba.y, tor);
}

// _bond_angle_cs (pallas_decode.py:72-87): (cos, sin) of the angle at b.
__device__ __forceinline__ void bond_angle_cs(V3 a, V3 b, V3 c, float* cos_t,
                                              float* sin_t) {
  float d1x = a.x - b.x, d1y = a.y - b.y, d1z = a.z - b.z;
  float d2x = c.x - b.x, d2y = c.y - b.y, d2z = c.z - b.z;
  float inner = d1x * d2x + d1y * d2y + d1z * d2z;
  float s1 = d1x * d1x + d1y * d1y + d1z * d1z;
  float s2 = d2x * d2x + d2y * d2y + d2z * d2z;
  float ct = inner / sqrtf(fmaxf(s1 * s2, 1e-30f));
  ct = fminf(fmaxf(ct, -1.0f), 1.0f);
  *cos_t = ct;
  *sin_t = sqrtf(fmaxf(1.0f - ct * ct, 0.0f));
}

// One lane's records: byte b of residue k at recs[(b * seg + k) * nl + l]
// (byte-plane-major [8, SEG, NL], convertBytesToBackboneChain bit layout),
// dequantized per field f as q * cont6[f] + mins6[f] in the field order
// (psi, omega, phi, n_ca_c, ca_c_n, c_n_ca) of _unpack_ang6_into
// (pallas_decode.py:127-151). A residue's bytes travel packed, bytes 0-3
// in .x and 4-7 in .y, so they can be loaded one residue ahead of use.
struct Lane {
  const uint8_t* p;  // recs + l
  size_t ps, rs;     // plane stride seg * nl, row stride nl
  float mins[6], cont[6];

  // bytes 0 .. n-1 of residue k, packed
  __device__ __forceinline__ uint2 rec(int k, int n) const {
    const uint8_t* q = p + (size_t)k * rs;
    uint32_t w[2] = {0u, 0u};
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      if (b < n) w[b >> 2] |= (uint32_t)*q << (8 * (b & 3));
      q += ps;
    }
    return make_uint2(w[0], w[1]);
  }
  __device__ __forceinline__ float deq(int f, int q) const {
    return (float)q * cont[f] + mins[f];
  }
  // torsion field f (0 psi, 1 omega, 2 phi) of packed residue bytes w
  __device__ __forceinline__ float torsion(int f, uint2 w) const {
    const int b0 = w.x & 0xff, b1 = (w.x >> 8) & 0xff,
              b2 = (w.x >> 16) & 0xff, b3 = w.x >> 24, b4 = w.y & 0xff;
    if (f == 0) return deq(0, (b2 << 4) | (b3 >> 4));
    if (f == 1) return deq(1, ((b0 & 0x7) << 8) | b1);
    return deq(2, ((b3 & 0xF) << 8) | b4);
  }
};

__device__ __forceinline__ void lane_init(Lane* ln,
                                          const uint8_t* __restrict__ recs,
                                          const float* __restrict__ mins6,
                                          const float* __restrict__ cont6,
                                          int seg, int nl, int l) {
  ln->p = recs + l;
  ln->ps = (size_t)seg * nl;
  ln->rs = (size_t)nl;
#pragma unroll
  for (int f = 0; f < 6; ++f) {
    ln->mins[f] = mins6[(size_t)f * nl + l];
    ln->cont[f] = cont6[(size_t)f * nl + l];
  }
}

// One forward NeRF step (_fwd_scan_into body, pallas_decode.py:163-181):
// residue k's angles (packed bytes w) place residue k+1's N, CA, C after
// (a, b, c). The N-CA length is proline's where residue code byte0 >> 3
// is PRO_CODE, as _class_prep's blca (pallas_decode.py:405-437) has it.
__device__ __forceinline__ void fwd_step(const Lane& ln, uint2 w, V3* a,
                                         V3* b, V3* c) {
  const int b0 = w.x & 0xff, b5 = (w.y >> 8) & 0xff,
            b6 = (w.y >> 16) & 0xff, b7 = w.y >> 24;
  float ncac = ln.deq(3, b7);
  float cacn = ln.deq(4, b5);
  float cnca = ln.deq(5, b6);
  const float n_ca =
      (b0 >> 3) == c_pro_code ? c_k[K_PRO_N_TO_CA] : c_k[K_N_TO_CA];
  V3 n = place_deg(*a, *b, *c, c_k[K_C_TO_N], cacn, cs_deg(ln.torsion(0, w)));
  V3 ca = place_deg(*b, *c, n, n_ca, cnca, cs_deg(ln.torsion(1, w)));
  V3 cc = place_deg(*c, n, ca, c_k[K_CA_TO_C], ncac,
                    cs_deg(ln.torsion(2, w)));
  *a = n;
  *b = ca;
  *c = cc;
}

// Row r of lane l in the [3*SEG, NL] planes.
__device__ __forceinline__ void put_row(float* __restrict__ ox,
                                        float* __restrict__ oy,
                                        float* __restrict__ oz, int r, int nl,
                                        int l, V3 v) {
  const size_t i = (size_t)r * nl + l;
  ox[i] = v.x;
  oy[i] = v.y;
  oz[i] = v.z;
}

__device__ __forceinline__ V3 get_row(const float* __restrict__ ox,
                                      const float* __restrict__ oy,
                                      const float* __restrict__ oz, int r,
                                      int nl, int l) {
  const size_t i = (size_t)r * nl + l;
  return v3(ox[i], oy[i], oz[i]);
}

// k1: forward scan from the anchor seed, blended 3-atom tail per lane.
//
// One thread per lane, the lanes taken in the order `order` gives
// (fused_decode.py lane_order: by tat, longest first, stable), so that the
// threads of a warp walk lanes of one length and none waits for a longer
// one. The loop over residues runs inside the thread and stops at the
// lane's own row tat-1; the tail atoms are the three in registers, so k1
// needs no row buffer (the TPU kernel wrote all 3*SEG forward rows to VMEM
// and picked rows tat-3..tat-1 with a masked pass over every row: a TPU
// lane cannot index a row of its own). Bound: instruction issue, 3
// placements and 6 full-precision sin/cos pairs a residue; the lanes
// against the card's resident threads are the only parallelism.
//
// out [9, NL] rows comp*3 + kk, row stride out_ld >= NL: tail row tat-3+kk
// blended with the stored next anchor ranc by weights (tat-3+kk, 3-kk)/tat
// (pallas_decode.py:213-222). A width class writes its columns of the
// tails of every class, [9, NL_total] (out_ld = NL_total, out at the
// class's first column), from which k2 gathers its seeds through prev.
__global__ void __launch_bounds__(128)
k1_tails(const uint8_t* __restrict__ recs, const float* __restrict__ seed,
         const float* __restrict__ ranc, const int* __restrict__ tat_,
         const float* __restrict__ mins6, const float* __restrict__ cont6,
         const int* __restrict__ order, float* __restrict__ out, int out_ld,
         int seg, int nl) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nl) return;
  const int l = order[i];
  Lane ln;
  lane_init(&ln, recs, mins6, cont6, seg, nl, l);
  int tat = tat_[l];
  V3 a = load3(seed, 0, nl, l), b = load3(seed, 3, nl, l),
     c = load3(seed, 6, nl, l);
  // rows 0..2 are the seed; step k writes rows 3k+3..3k+5. The tail rows
  // tat-3..tat-1 exist when 3 <= tat <= 3*SEG (the pack's 1 <= seg_m <=
  // SEG); otherwise the TPU kernel's masked pass matches no row and the
  // tail is zero.
  V3 t0 = v3(0.f, 0.f, 0.f), t1 = t0, t2 = t0;
  if (tat >= 3 && tat <= 3 * seg) {
    uint2 w = ln.rec(0, 8);  // residue k's bytes, loaded a step ahead
    for (int k = 0; 3 * k + 3 < tat; ++k) {
      const uint2 cur = w;
      if (3 * k + 6 < tat) w = ln.rec(k + 1, 8);
      fwd_step(ln, cur, &a, &b, &c);
    }
    t0 = a;
    t1 = b;
    t2 = c;
  }
  float tf = fmaxf((float)tat, 1.0f);
  const V3 tails[3] = {t0, t1, t2};
#pragma unroll
  for (int kk = 0; kk < 3; ++kk) {
    const float w_r = (float)(tat - 3 + kk);
    const float w_f = tf - w_r;
    const V3 v = tails[kk];
    const V3 anc = load3(ranc, kk * 3, nl, l);
    out[(size_t)kk * out_ld + l] = (v.x * w_f + anc.x * w_r) / tf;
    out[(size_t)(3 + kk) * out_ld + l] = (v.y * w_f + anc.y * w_r) / tf;
    out[(size_t)(6 + kk) * out_ld + l] = (v.z * w_f + anc.z * w_r) / tf;
  }
}

// k2: seed, forward scan, reverse C->N sweep and blend of each lane
// (_make_backbone_kernel, pallas_decode.py:227-296, after the seed roll of
// :596-610), in two launches: k2_backbone computes each lane's rows into
// scratch planes at its thread's column, k2_copy_out moves them to the
// lane's column of the output planes ox/oy/oz [3*SEG, NL].
//
// k2_backbone: one thread per lane, the lanes in the order `order` gives
// (lane_order: by tat, longest first, stable), so that a warp's lanes have
// one length and none waits for a longer one (in pack order the warps of
// the B=8192 batch walk 1.46x its real rows). A lane walks its own rows
// only, 0 .. tat-1 (tat = 3*seg_m): rows >= tat are pack padding, neither
// computed nor written, and pad lanes (seg_m 1) do the 3-row blend alone.
//  - Seed: with tails9 (refine_iters >= 2, [9, tails_ld] rows comp*3 +
//    atom) and not is_first[l], the blended tail of the lane's predecessor:
//    column prev[l] where prev is given (width classes: the tails of every
//    class share one buffer, tails_ld = NL_total, and a protein's lanes may
//    sit in different classes, pallas_decode.py:654-670), else lane l-1
//    (tails_ld = NL; lane -1 wraps to NL-1, as jnp.roll and torch.roll
//    do). Otherwise, and always without tails9, the lane's own anchor seed
//    fwd9.
//  - Forward: rows 0 .. tat-4 to the scratch planes sx/sy/sz at column i,
//    the thread's place in the order, so a warp stores one aligned 128-byte
//    line a plane; the last three rows stay in registers. Each residue's
//    record bytes are loaded a step ahead.
//  - Reverse: down from row tat-1. Rows tat-1..tat-3 are the stored
//    anchors ranc; row r <= tat-4 is placed from the reverse atoms at
//    r+1..r+3 (registers), its bond angle from forward rows r..r+2 (row r
//    read back a residue ahead, r+1 and r+2 in registers), its torsion from
//    the record; then the blend (f*(tat-r) + rev*r)/tat goes back into
//    scratch row r, in place.
// The N-CA length comes from the record's residue code (fwd_step), the
// bond lengths of the reverse cycle C-N, CA-C, N-CA by row, all as the
// TPU kernel has them. No VMEM-style limit on SEG (the TPU kernel's 3*SEG
// scratch capped SEG at ~96).
//
// Bound (PERF.md §6): the forward runs near the issue rate (k1, the
// same loop without the stores, at ~0.095 ms for B=8192); the reverse's
// arithmetic and divisions hide behind its loads and stores. The blend's
// stores cost ~0.31 ms when they went straight to the lanes' columns of
// the output planes, ~0.04 ms in place at the thread's; so they are
// staged, and the copy moves the 36 B a row at ~2 TB/s with every store a
// whole line.
__global__ void __launch_bounds__(128)
k2_backbone(const uint8_t* __restrict__ recs, const float* __restrict__ tails9,
            const int* __restrict__ prev, const float* __restrict__ fwd9,
            const uint8_t* __restrict__ is_first,
            const float* __restrict__ ranc, const int* __restrict__ tat_,
            const float* __restrict__ mins6, const float* __restrict__ cont6,
            const int* __restrict__ order, float* __restrict__ sx,
            float* __restrict__ sy, float* __restrict__ sz,
            int* __restrict__ pos, int tails_ld, int seg, int nl) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nl) return;
  const int l = order[i];
  pos[l] = i;
  const int tat = min(tat_[l], 3 * seg);
  if (tat < 3) return;
  const int sm = tat / 3;  // the lane's residues
  Lane ln;
  lane_init(&ln, recs, mins6, cont6, seg, nl, l);
  V3 a, b, c;
  if (tails9 != nullptr && !is_first[l]) {
    // the predecessor's tail, rows comp*3 + atom
    const size_t p = prev != nullptr ? (size_t)prev[l]
                                     : (l == 0 ? nl - 1 : l - 1);
    const size_t ld = (size_t)tails_ld;
    a = v3(tails9[p], tails9[3 * ld + p], tails9[6 * ld + p]);
    b = v3(tails9[ld + p], tails9[4 * ld + p], tails9[7 * ld + p]);
    c = v3(tails9[2 * ld + p], tails9[5 * ld + p], tails9[8 * ld + p]);
  } else {
    a = load3(fwd9, 0, nl, l);
    b = load3(fwd9, 3, nl, l);
    c = load3(fwd9, 6, nl, l);
  }
  uint2 w = ln.rec(0, 8);  // residue k's bytes, loaded a step ahead
  for (int k = 0; k < sm - 1; ++k) {
    const uint2 cur = w;
    if (k + 2 < sm) w = ln.rec(k + 1, 8);
    put_row(sx, sy, sz, 3 * k, nl, i, a);
    put_row(sx, sy, sz, 3 * k + 1, nl, i, b);
    put_row(sx, sy, sz, 3 * k + 2, nl, i, c);
    fwd_step(ln, cur, &a, &b, &c);
  }

  const float tatf = (float)tat;
  const float tf = fmaxf(tatf, 1.0f);
  auto blend = [&](int r, V3 f, V3 w) {
    const float w_r = (float)r;
    const float w_f = tatf - w_r;
    put_row(sx, sy, sz, r, nl, i,
            v3((f.x * w_f + w.x * w_r) / tf, (f.y * w_f + w.y * w_r) / tf,
               (f.z * w_f + w.z * w_r) / tf));
  };
  // reverse atoms at rows r+1..r+3 and forward atoms at r+1, r+2
  V3 v3_ = load3(ranc, 6, nl, l), v2 = load3(ranc, 3, nl, l),
     v1 = load3(ranc, 0, nl, l);
  blend(tat - 1, c, v3_);
  blend(tat - 2, b, v2);
  blend(tat - 3, a, v1);
  V3 f1 = a, f2 = b;
  auto rev = [&](int r, V3 f0, float bl, float2 tor) {
    float cos_a, sin_a;
    bond_angle_cs(f0, f1, f2, &cos_a, &sin_a);
    const V3 w = place_cs(v3_, v2, v1, bl, cos_a, sin_a, tor);
    blend(r, f0, w);
    v3_ = v2;
    v2 = v1;
    v1 = w;
    f2 = f1;
    f1 = f0;
  };
  // residue j's forward rows and torsion bytes, loaded one residue ahead
  V3 p0 = a, p1 = a, p2 = a;
  uint2 tw = make_uint2(0u, 0u);
  if (sm >= 2) {
    p0 = get_row(sx, sy, sz, tat - 6, nl, i);
    p1 = get_row(sx, sy, sz, tat - 5, nl, i);
    p2 = get_row(sx, sy, sz, tat - 4, nl, i);
    tw = ln.rec(sm - 2, 5);
  }
  for (int j = sm - 2; j >= 0; --j) {
    const V3 q0 = p0, q1 = p1, q2 = p2;
    const uint2 cw = tw;
    if (j > 0) {
      p0 = get_row(sx, sy, sz, 3 * j - 3, nl, i);
      p1 = get_row(sx, sy, sz, 3 * j - 2, nl, i);
      p2 = get_row(sx, sy, sz, 3 * j - 1, nl, i);
      tw = ln.rec(j - 1, 5);
    }
    rev(3 * j + 2, q2, c_k[K_C_TO_N], cs_deg(ln.torsion(2, cw)));
    rev(3 * j + 1, q1, c_k[K_CA_TO_C], cs_deg(ln.torsion(1, cw)));
    rev(3 * j, q0, c_k[K_N_TO_CA], cs_deg(ln.torsion(0, cw)));
  }
}

// k2's copy-out: residue s (rows 3s .. 3s+2) of lane l, s < seg_m, from
// the scratch column pos[l] (the thread that walked the lane) to the
// lane's column of the output planes; one thread per (residue, lane), so a
// warp stores 32 neighbouring lanes, and loads before it stores.
__global__ void __launch_bounds__(256)
k2_copy_out(const float* __restrict__ sx, const float* __restrict__ sy,
            const float* __restrict__ sz, const int* __restrict__ pos,
            const int* __restrict__ tat_, float* __restrict__ ox,
            float* __restrict__ oy, float* __restrict__ oz, int seg,
            int nl) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = 3 * blockIdx.y;
  if (l >= nl || r >= min(tat_[l], 3 * seg)) return;
  const int p = pos[l];
  float v[9];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const size_t src = (size_t)(r + k) * nl + p;
    v[3 * k] = sx[src];
    v[3 * k + 1] = sy[src];
    v[3 * k + 2] = sz[src];
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const size_t dst = (size_t)(r + k) * nl + l;
    ox[dst] = v[3 * k];
    oy[dst] = v[3 * k + 1];
    oz[dst] = v[3 * k + 2];
  }
}

// k2's bb-wire epilogue (the XLA epilogue of _run_backbone_only,
// pallas_decode.py:561-570), reading k2_backbone's staged rows in place of
// k2_copy_out: residue s < seg_m[l] of lane l < nl_out, rows 3s (N), 3s+1
// (CA), 3s+2 (C) at the scratch column pos[l], becomes
//   off[l, s, 0:3] = clip(rint((N - CA) * 10000)), off[l, s, 3:6] the same
//   for C, as int16 (0.1 mA offsets from CA), and ca[l, s, :] = CA,
// 24 B a residue in [NL_out, SEG, 6] / [NL_out, SEG, 3]. Pad rows and
// lanes are left unwritten, as k3 leaves them.
//
// A block takes KB_TL = 32 neighbouring lanes and walks their residues
// KB_TS at a time, one thread per (lane, residue): a warp reads one row of
// its 32 lanes at their staging columns (neighbouring lanes of one length
// have neighbouring columns, lane_order being stable), stages the finished
// rows in shared memory in the output's order, and the block then stores
// each lane's run of up to KB_TS rows (KB_TS * 12 B of each output) as
// whole words. Bound: bytes, 36 B in and 24 B out a residue; on an H100
// at B=8192 it moves 254.8 MB in ~0.127 ms, 60% of that bound (PERF.md
// §6).
#define KB_TL 32
#define KB_TS 8
#define KB_W (3 * KB_TS + 1)  // words a lane in the stage; odd: no conflicts

__global__ void __launch_bounds__(KB_TL * KB_TS)
k2_bb_out(const float* __restrict__ sx, const float* __restrict__ sy,
          const float* __restrict__ sz, const int* __restrict__ pos,
          const int* __restrict__ seg_m, int16_t* __restrict__ off,
          float* __restrict__ ca, int seg, int nl, int nl_out) {
  __shared__ uint32_t s_off[KB_TL * KB_W];
  __shared__ float s_ca[KB_TL * KB_W];
  __shared__ int s_rows[KB_TL];
  const int tl = threadIdx.x % KB_TL, ts = threadIdx.x / KB_TL;
  const int l0 = blockIdx.x * KB_TL, l = l0 + tl;
  const int rows = l < nl_out ? min(seg_m[l], seg) : 0;
  if (ts == 0) s_rows[tl] = rows;
  int most = rows;  // the most rows of the block's lanes, in every warp
#pragma unroll
  for (int o = KB_TL / 2; o > 0; o >>= 1)
    most = max(most, __shfl_xor_sync(0xffffffffu, most, o));
  const int p = rows > 0 ? pos[l] : 0;
  for (int s0 = 0; s0 < most; s0 += KB_TS) {
    const int s = s0 + ts;
    __syncthreads();  // s_rows is set; the previous run's stores are done
    if (s < rows) {
      const V3 n = get_row(sx, sy, sz, 3 * s, nl, p);
      const V3 a = get_row(sx, sy, sz, 3 * s + 1, nl, p);
      const V3 c = get_row(sx, sy, sz, 3 * s + 2, nl, p);
      const float d[6] = {n.x - a.x, n.y - a.y, n.z - a.z,
                          c.x - a.x, c.y - a.y, c.z - a.z};
      uint32_t q[3];
#pragma unroll
      for (int w = 0; w < 3; ++w) {
        const float v0 =
            fminf(fmaxf(rintf(d[2 * w] * 10000.0f), -32767.0f), 32767.0f);
        const float v1 = fminf(
            fmaxf(rintf(d[2 * w + 1] * 10000.0f), -32767.0f), 32767.0f);
        q[w] = (uint32_t)(uint16_t)(int16_t)v0 |
               ((uint32_t)(uint16_t)(int16_t)v1 << 16);
      }
      uint32_t* so = s_off + tl * KB_W + 3 * ts;
      float* sc = s_ca + tl * KB_W + 3 * ts;
      so[0] = q[0];
      so[1] = q[1];
      so[2] = q[2];
      sc[0] = a.x;
      sc[1] = a.y;
      sc[2] = a.z;
    }
    __syncthreads();
    // lane lc's rows s0 .. s0 + n - 1: 3n words of each output, one run
    for (int i = threadIdx.x; i < KB_TL * 3 * KB_TS; i += blockDim.x) {
      const int lc = i / (3 * KB_TS), j = i - lc * (3 * KB_TS);
      const int n = min(max(s_rows[lc] - s0, 0), KB_TS);
      if (j < 3 * n) {
        const size_t dst = ((size_t)(l0 + lc) * seg + s0) * 3 + j;
        reinterpret_cast<uint32_t*>(off)[dst] = s_off[lc * KB_W + j];
        ca[dst] = s_ca[lc * KB_W + j];
      }
    }
  }
}

// k3's tables, derived on the card from the __constant__ ones by
// k3_tables (launched by fd_set_tables, once per device) and copied into
// shared memory once by each persistent k3 block. Each value is computed
// with the expression the per-placement code used (place_deg), so it is
// the same float:
//  - geo[code * 14 + atom]: (bond length, dx = -length * cosf(bond
//    angle), sinf(bond angle), the three predecessor slots i0 | i1 << 8 |
//    i2 << 16 as the float's bits), one 16-byte load;
//  - tor[q]: (cosf, sinf) of the dequantized torsion of side-chain torsion
//    code q, q * SC_CONT + SC_MIN degrees, for all 256 codes.
// So k3 evaluates no trigonometric function.
struct K3Tables {
  float4 geo[N_CODES * MAX_ATOM];
  float2 tor[256];
};
__device__ K3Tables g_k3;

__global__ void k3_tables() {
  const int i = threadIdx.x;
  if (i < N_CODES * MAX_ATOM) {
    const int* p = &c_pred[i * 3];
    const float bl = c_blen[i];
    const float ba = c_bang[i] * c_k[K_RADK];
    g_k3.geo[i] = make_float4(bl, -bl * cosf(ba), sinf(ba),
                              __int_as_float(p[0] | (p[1] << 8) |
                                             (p[2] << 16)));
  }
  if (i < 256) {
    // u8 -> int -> float, then cast*cont + min (pallas_decode.py:369-370)
    const float tor = (float)i * c_k[K_SC_CONT] + c_k[K_SC_MIN];
    const float ta = tor * c_k[K_RADK];
    g_k3.tor[i] = make_float2(cosf(ta), sinf(ta));
  }
}

// k3: side chains and the compact int16 wire.
//
// Work: one thread per real residue row (lane l, row s < seg_m[l]); rows
// s >= seg_m[l] are pack padding, neither computed nor written (their
// output rows are left as allocated; the host stitch reads none of them).
// A persistent grid of a few blocks per SM walks groups of K3_TL = 32
// neighbouring lanes; each block copies the tables into shared memory
// once. Lanes carry ~25 rows but SEG is the widest lane's (48 at the
// default anchor interval), so a group's rows are split at m, the median
// of its lanes' row counts:
//  - dense steps, rows s < m, K3_TS = 4 rows at a time, one thread per
//    (lane, row), a warp on 32 neighbouring lanes of one row: the reads of
//    the backbone rows, codes and torsion codes are coalesced, and each
//    lane's run of up to 4 rows is copied out with 16-byte stores when it
//    starts 16-byte aligned (SEG % 4 == 0, as the pack's 8-row bucket
//    gives; 84 * 4 = 336 = 21 * 16), else with 4-byte ones;
//  - sparse steps, the rows m <= s < seg_m[l] of the longer lanes (the
//    anchor tails), packed lane by lane onto consecutive threads, 128 at
//    a time, and copied out row by row with 4-byte stores.
// So no warp spends its issue slots on padding rows.
//
// A residue's 14 atoms live in shared memory as [42][K3_T] float columns,
// the thread's own column in its own bank, so the predecessor slots that
// the table gives at run time index shared memory, not a local array.
// After the placements each thread packs its [42] int16 row ((k, c)-major
// mA offsets from CA) into registers; the columns are then reused as the
// output stage, slot by slot in the order of the output rows, as they lie
// in the final [NL_out, SEG, 42] / [NL_out, SEG, 3] layout. So the TPU
// path's epilogue transpose (pallas_decode.py:517-525) is gone.
//
// Bound: bytes. Per real row 36 B of backbone, 4 B of code and 11 B of
// torsion codes in, 84 B of offsets and 12 B of CA out (147 B); the 11
// placements are ~66 flops and 2 rsqrtf each. The kernel's previous tiled
// form took 1.41 ms at B=8192 on an H100 80GB HBM3 (700 W power limit):
// it computed and stored the padding rows too (half the slots), evaluated
// 4 full-precision sinf/cosf per placement, kept the atoms in a run-time
// indexed local array and filled 9 KB of shared tables in each of 31.7k
// blocks.
#define K3_TL 32
#define K3_TS 4
#define K3_T (K3_TL * K3_TS)
#define K3_ROW (3 * MAX_ATOM)

// Side chain and int16 offsets of row s of lane l: the thread's atom
// column `col` (stride K3_T) ends up holding the 14 atoms; packed[w] holds
// offsets 2w and 2w + 1, and ca the CA.
__device__ __forceinline__ void k3_row(
    const float* __restrict__ bx, const float* __restrict__ by,
    const float* __restrict__ bz, const int* __restrict__ code,
    const uint8_t* __restrict__ sct, const K3Tables& tab, float* col,
    int l, int s, int nl, uint32_t* packed, float* ca) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const size_t row = (size_t)(3 * s + a) * nl + l;
    col[(3 * a) * K3_T] = bx[row];
    col[(3 * a + 1) * K3_T] = by[row];
    col[(3 * a + 2) * K3_T] = bz[row];
  }
  const int cd = code[(size_t)s * nl + l] & (N_CODES - 1);  // 5-bit code
  // the 11 torsion codes, loaded at once before the placements, which
  // would otherwise each wait for one: 4 to a register
  const uint8_t* q = sct + (size_t)s * 11 * nl + l;
  uint32_t tq4[3] = {0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 11; ++i)
    tq4[i >> 2] |= (uint32_t)q[(size_t)i * nl] << (8 * (i & 3));
#pragma unroll 1
  for (int k = 3; k < MAX_ATOM; ++k) {
    const int i = k - 3;
    const uint32_t w = i < 4 ? tq4[0] : (i < 8 ? tq4[1] : tq4[2]);
    const float4 g = tab.geo[cd * MAX_ATOM + k];
    const float2 tc = tab.tor[(w >> (8 * (i & 3))) & 0xffu];
    const int p = __float_as_int(g.w);
    const float* c0 = col + (3 * (p & 0xff)) * K3_T;
    const float* c1 = col + (3 * ((p >> 8) & 0xff)) * K3_T;
    const float* c2 = col + (3 * ((p >> 16) & 0xff)) * K3_T;
    // (bond_length * cos t) * sin_ba, as place_cs rounds it
    const V3 o = place_frame(v3(c0[0], c0[K3_T], c0[2 * K3_T]),
                             v3(c1[0], c1[K3_T], c1[2 * K3_T]),
                             v3(c2[0], c2[K3_T], c2[2 * K3_T]), g.y,
                             g.x * tc.x * g.z, g.x * tc.y * g.z);
    col[(3 * k) * K3_T] = o.x;
    col[(3 * k + 1) * K3_T] = o.y;
    col[(3 * k + 2) * K3_T] = o.z;
  }
  ca[0] = col[3 * K3_T];
  ca[1] = col[4 * K3_T];
  ca[2] = col[5 * K3_T];
#pragma unroll
  for (int j = 0; j < K3_ROW; j += 2) {
    const float v0 = fminf(
        fmaxf(rintf((col[j * K3_T] - ca[j % 3]) * 1000.0f), -32767.0f),
        32767.0f);
    const float v1 = fminf(
        fmaxf(rintf((col[(j + 1) * K3_T] - ca[(j + 1) % 3]) * 1000.0f),
              -32767.0f),
        32767.0f);
    packed[j / 2] = (uint32_t)(uint16_t)(int16_t)v0 |
                    ((uint32_t)(uint16_t)(int16_t)v1 << 16);
  }
}

// Writes a finished row to stage slot `slot` (int16 [K3_T][42], then
// float [K3_T][3]).
__device__ __forceinline__ void k3_stage(int16_t* s_off, float* s_ca,
                                         int slot, const uint32_t* packed,
                                         const float* ca) {
  uint32_t* o = reinterpret_cast<uint32_t*>(s_off + slot * K3_ROW);
#pragma unroll
  for (int w = 0; w < K3_ROW / 2; ++w) o[w] = packed[w];
  s_ca[slot * 3] = ca[0];
  s_ca[slot * 3 + 1] = ca[1];
  s_ca[slot * 3 + 2] = ca[2];
}

__global__ void __launch_bounds__(K3_T, 6)
k3_sidechain(const float* __restrict__ bx, const float* __restrict__ by,
             const float* __restrict__ bz, const int* __restrict__ code,
             const uint8_t* __restrict__ sct, const int* __restrict__ seg_m,
             int16_t* __restrict__ off, float* __restrict__ ca, int seg,
             int nl, int nl_out) {
  __shared__ K3Tables s_tab;
  // atom columns; between a step's placements and its copy-out, the
  // output stage: int16 [K3_T][42] then float [K3_T][3]
  __shared__ __align__(16) float s_at[K3_ROW * K3_T];
  __shared__ int s_rows[K3_TL];      // rows of each lane of the group
  __shared__ int s_pre[K3_TL + 1];   // prefix of the lanes' sparse rows
  __shared__ int s_med;              // m, the group's dense row count
  __shared__ int s_dst[K3_T];        // output row of each sparse slot
  {
    const float4* src = reinterpret_cast<const float4*>(&g_k3);
    float4* dst = reinterpret_cast<float4*>(&s_tab);
    for (int i = threadIdx.x; i < (int)(sizeof(K3Tables) / 16);
         i += blockDim.x)
      dst[i] = src[i];
  }
  int16_t* const s_off = reinterpret_cast<int16_t*>(s_at);
  float* const s_ca = s_at + K3_T * K3_ROW / 2;
  float* const col = s_at + threadIdx.x;  // this thread's atom column
  const int tl = threadIdx.x % K3_TL, ts = threadIdx.x / K3_TL;
  const int n_groups = (nl_out + K3_TL - 1) / K3_TL;
  uint32_t packed[K3_ROW / 2];
  float cav[3];

  for (int grp = blockIdx.x; grp < n_groups; grp += gridDim.x) {
    const int l0 = grp * K3_TL;
    __syncthreads();  // the previous group's copy-out is done
    if (threadIdx.x < K3_TL) {
      // warp 0: each lane's row count, their median m, and the prefix of
      // the rows past m
      const int lane = l0 + threadIdx.x;
      const int r = lane < nl_out ? min(seg_m[lane], seg) : 0;
      const bool valid = lane < nl_out;
      int below = 0, same = 0, nv = 0;
      for (int o = 0; o < K3_TL; ++o) {
        const int ro = __shfl_sync(0xffffffffu, r, o);
        const int vo = __shfl_sync(0xffffffffu, (int)valid, o);
        nv += vo;
        below += vo && ro < r;
        same += vo && ro == r && o < (int)threadIdx.x;
      }
      // the valid lane of rank (nv - 1) / 2 holds the median
      const bool is_med = valid && below + same == (nv - 1) / 2;
      const unsigned who = __ballot_sync(0xffffffffu, is_med);
      const int m = __shfl_sync(0xffffffffu, r, __ffs(who) - 1);
      int e = max(r - m, 0);
      s_rows[threadIdx.x] = r;
      for (int o = 1; o < K3_TL; o <<= 1) {  // inclusive scan
        const int v = __shfl_up_sync(0xffffffffu, e, o);
        if ((int)threadIdx.x >= o) e += v;
      }
      s_pre[threadIdx.x + 1] = e;
      if (threadIdx.x == 0) {
        s_pre[0] = 0;
        s_med = m;
      }
    }
    __syncthreads();
    const int m = s_med, n_sparse = s_pre[K3_TL];

    // dense steps: rows s0 .. s0 + 3 of every lane, s < min(m, rows)
    for (int s0 = 0; s0 < m; s0 += K3_TS) {
      const int l = l0 + tl, s = s0 + ts;
      const bool real = s < min(s_rows[tl], m);
      __syncthreads();  // the previous step's copy-out is done
      if (real) k3_row(bx, by, bz, code, sct, s_tab, col, l, s, nl, packed,
                       cav);
      __syncthreads();  // every column read before the stage overwrites it
      if (real) k3_stage(s_off, s_ca, tl * K3_TS + ts, packed, cav);
      __syncthreads();
      // lane lc's n rows: one run of n * 84 B of off and n * 12 B of ca,
      // in global memory and in the stage
      if ((seg & 3) == 0) {
        // (l * SEG + s0) % 4 == 0: both runs start 16-byte aligned; n * 84
        // B is (n * 84) / 16 chunks and n % 4 words
        const int c16 = K3_TS * K3_ROW * 2 / 16;
        for (int i = threadIdx.x; i < K3_TL * (c16 + 3); i += K3_T) {
          const int lc = i / (c16 + 3), j = i - lc * (c16 + 3);
          const int n = min(max(min(s_rows[lc], m) - s0, 0), K3_TS);
          const int nc = n * K3_ROW * 2 / 16;
          int16_t* dst = off + ((size_t)(l0 + lc) * seg + s0) * K3_ROW;
          const int16_t* src = s_off + lc * K3_TS * K3_ROW;
          if (j < nc) {
            reinterpret_cast<int4*>(dst)[j] =
                reinterpret_cast<const int4*>(src)[j];
          } else if (j >= c16 && j - c16 < (n & 3)) {
            const int w = nc * 4 + (j - c16);  // the words past the chunks
            reinterpret_cast<uint32_t*>(dst)[w] =
                reinterpret_cast<const uint32_t*>(src)[w];
          }
        }
      } else {
        const int wl = K3_TS * K3_ROW / 2;  // words of a lane's stage
        for (int i = threadIdx.x; i < K3_TL * wl; i += K3_T) {
          const int lc = i / wl, j = i - lc * wl;
          const int n = min(max(min(s_rows[lc], m) - s0, 0), K3_TS);
          if (j < n * K3_ROW / 2)
            reinterpret_cast<uint32_t*>(
                off + ((size_t)(l0 + lc) * seg + s0) * K3_ROW)[j] =
                reinterpret_cast<const uint32_t*>(
                    s_off + lc * K3_TS * K3_ROW)[j];
        }
      }
      for (int i = threadIdx.x; i < K3_TL * K3_TS * 3; i += K3_T) {
        const int lc = i / (K3_TS * 3), j = i - lc * (K3_TS * 3);
        const int n = min(max(min(s_rows[lc], m) - s0, 0), K3_TS);
        if (j < n * 3)
          ca[((size_t)(l0 + lc) * seg + s0) * 3 + j] =
              s_ca[lc * K3_TS * 3 + j];
      }
    }

    // sparse steps: rows m <= s < rows of each lane, lane by lane
    for (int j0 = 0; j0 < n_sparse; j0 += K3_T) {
      const int j = j0 + (int)threadIdx.x;
      const bool real = j < n_sparse;
      int lc = 0;
      if (real)
        while (s_pre[lc + 1] <= j) ++lc;
      const int s = m + j - s_pre[lc];
      __syncthreads();  // the previous step's copy-out is done
      if (real) k3_row(bx, by, bz, code, sct, s_tab, col, l0 + lc, s, nl,
                       packed, cav);
      __syncthreads();
      if (real) {
        k3_stage(s_off, s_ca, threadIdx.x, packed, cav);
        s_dst[threadIdx.x] = (l0 + lc) * seg + s;
      }
      __syncthreads();
      // consecutive slots of one lane are consecutive output rows
      const int n = min(n_sparse - j0, K3_T);
      for (int i = threadIdx.x; i < n * (K3_ROW / 2); i += K3_T) {
        const int sl = i / (K3_ROW / 2), w = i - sl * (K3_ROW / 2);
        reinterpret_cast<uint32_t*>(off)[(size_t)s_dst[sl] * (K3_ROW / 2) +
                                         w] =
            reinterpret_cast<const uint32_t*>(s_off)[i];
      }
      for (int i = threadIdx.x; i < n * 3; i += K3_T)
        ca[(size_t)s_dst[i / 3] * 3 + i % 3] = s_ca[i];
    }
  }
}

static unsigned blocks_for(size_t n, unsigned threads) {
  return (unsigned)((n + threads - 1) / threads);
}

extern "C" {

// Fills the current device's __constant__ tables, then derives k3's
// tables from them on the device and waits for that.
cudaError_t fd_set_tables(const int* pred32, const float* blen32,
                          const float* bang32, const float* consts,
                          int n_consts, int pro_code) {
  if (n_consts != K_COUNT) return cudaErrorInvalidValue;
  cudaError_t e = cudaMemcpyToSymbol(c_pred, pred32, sizeof(c_pred));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(c_blen, blen32, sizeof(c_blen));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(c_bang, bang32, sizeof(c_bang));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(c_k, consts, sizeof(c_k));
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(c_pro_code, &pro_code, sizeof(c_pro_code));
  if (e != cudaSuccess) return e;
  k3_tables<<<1, 512>>>();
  e = cudaGetLastError();
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  return e;
}

// k1 into out [9, NL] with row stride out_ld.
cudaError_t fd_tails(const uint8_t* recs, const float* seed,
                     const float* ranc, const int* tat, const float* mins6,
                     const float* cont6, const int* order, float* out,
                     int out_ld, int seg, int nl, cudaStream_t stream) {
  k1_tails<<<blocks_for(nl, 128), 128, 0, stream>>>(
      recs, seed, ranc, tat, mins6, cont6, order, out, out_ld, seg, nl);
  return cudaGetLastError();
}

// k2: k2_backbone, then k2_copy_out, on the stream. sx, sy, sz: [3*SEG,
// NL] float scratch planes, pos: [NL] int scratch. tails9 null: the seeds
// are fwd9 (refine_iters 1); else [9, tails_ld], read at column prev[l]
// (prev given) or l-1 (prev null, tails_ld = NL).
cudaError_t fd_backbone(const uint8_t* recs, const float* tails9,
                        const int* prev, const float* fwd9,
                        const uint8_t* is_first, const float* ranc,
                        const int* tat, const float* mins6,
                        const float* cont6, const int* order, float* ox,
                        float* oy, float* oz, float* sx, float* sy,
                        float* sz, int* pos, int tails_ld, int seg, int nl,
                        cudaStream_t stream) {
  k2_backbone<<<blocks_for(nl, 128), 128, 0, stream>>>(
      recs, tails9, prev, fwd9, is_first, ranc, tat, mins6, cont6, order, sx,
      sy, sz, pos, tails_ld, seg, nl);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  k2_copy_out<<<dim3(blocks_for(nl, 256), seg), 256, 0, stream>>>(
      sx, sy, sz, pos, tat, ox, oy, oz, seg, nl);
  return cudaGetLastError();
}

// k2_bb_out alone, on rows k2_backbone staged in sx, sy, sz at the columns
// pos: off [NL_out, SEG, 6] int16, ca [NL_out, SEG, 3] float.
cudaError_t fd_bb_out(const float* sx, const float* sy, const float* sz,
                      const int* pos, const int* seg_m, int16_t* off,
                      float* ca, int seg, int nl, int nl_out,
                      cudaStream_t stream) {
  k2_bb_out<<<blocks_for(nl_out, KB_TL), KB_TL * KB_TS, 0, stream>>>(
      sx, sy, sz, pos, seg_m, off, ca, seg, nl, nl_out);
  return cudaGetLastError();
}

// The bb wire: k2_backbone as fd_backbone runs it, then k2_bb_out in place
// of k2_copy_out, on the stream.
cudaError_t fd_backbone_bb(const uint8_t* recs, const float* tails9,
                           const int* prev, const float* fwd9,
                           const uint8_t* is_first, const float* ranc,
                           const int* tat, const float* mins6,
                           const float* cont6, const int* order,
                           const int* seg_m, int16_t* off, float* ca,
                           float* sx, float* sy, float* sz, int* pos,
                           int tails_ld, int seg, int nl, int nl_out,
                           cudaStream_t stream) {
  k2_backbone<<<blocks_for(nl, 128), 128, 0, stream>>>(
      recs, tails9, prev, fwd9, is_first, ranc, tat, mins6, cont6, order, sx,
      sy, sz, pos, tails_ld, seg, nl);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return fd_bb_out(sx, sy, sz, pos, seg_m, off, ca, seg, nl, nl_out, stream);
}

// k3 on a persistent grid: as many blocks as fit on the device at once,
// at most one per group of 32 lanes.
cudaError_t fd_sidechain(const float* bx, const float* by, const float* bz,
                         const int* code, const uint8_t* sct,
                         const int* seg_m, int16_t* off, float* ca, int seg,
                         int nl, int nl_out, cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k3_sidechain,
                                                      K3_T, 0);
  if (e != cudaSuccess) return e;
  const size_t groups = blocks_for(nl_out, K3_TL);
  const size_t fit = (size_t)sms * (per_sm > 0 ? per_sm : 1);
  k3_sidechain<<<(unsigned)(groups < fit ? groups : fit), K3_T, 0,
                 stream>>>(bx, by, bz, code, sct, seg_m, off, ca, seg, nl,
                           nl_out);
  return cudaGetLastError();
}

}  // extern "C"
