// Fused ragged-lane decode for Hopper (sm_90a): k1 tails, k2 backbone,
// k3 side chains.
//
// Replaces the three Pallas TPU kernels of
// foldcomp_tpu/kernels/pallas_decode.py:
//   k1 fd_tails      <- _make_tails_kernel      (pallas_decode.py:186)
//   k2 fd_backbone   <- _make_backbone_kernel   (pallas_decode.py:227)
//   k3 fd_sidechain  <- _make_sidechain_kernel  (pallas_decode.py:338)
// Each computes what the Pallas kernel computes; the plain PyTorch
// versions beside them (fused_decode.py tails_plain / backbone_plain /
// sidechain_plain) are the oracle.
//
// Layouts are the pack's lane-minor ones (codec/batch.py
// pack_decode_batch_lanes): row-major [rows, NL], so that the threads of a
// warp, one per lane, read neighbouring addresses.
//
// Float rules (nvcc -fmad=false, no --use_fast_math; build.py):
//  - no FMA contraction, so every expression rounds in the JAX order;
//  - cosf/sinf (full precision), not __cosf/__sinf;
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
       K_COUNT };
#define N_CODES 32
#define MAX_ATOM 14
__constant__ int c_pred[N_CODES * MAX_ATOM * 3];
__constant__ float c_blen[N_CODES * MAX_ATOM];
__constant__ float c_bang[N_CODES * MAX_ATOM];
__constant__ float c_k[K_COUNT];

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

// _place_atom_cs (pallas_decode.py:93-117): place the atom after c with
// the bond angle given as (cos, sin).
__device__ __forceinline__ V3 place_cs(V3 a, V3 b, V3 c, float bond_length,
                                       float cos_ba, float sin_ba,
                                       float torsion_deg) {
  float abx = b.x - a.x, aby = b.y - a.y, abz = b.z - a.z;
  float bcx = c.x - b.x, bcy = c.y - b.y, bcz = c.z - b.z;
  float inv_bc = rsqrtf(fmaxf(bcx * bcx + bcy * bcy + bcz * bcz, 1e-30f));
  float bcnx = bcx * inv_bc, bcny = bcy * inv_bc, bcnz = bcz * inv_bc;
  float ta = torsion_deg * c_k[K_RADK];
  float dx = -bond_length * cos_ba;
  float dy = bond_length * cosf(ta) * sin_ba;
  float dz = bond_length * sinf(ta) * sin_ba;
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

// place_atom_c (foldcomp_tpu/kernels/geometry.py:78-112): the bond angle
// in degrees.
__device__ __forceinline__ V3 place_deg(V3 a, V3 b, V3 c, float bond_length,
                                        float bond_angle_deg,
                                        float torsion_deg) {
  float ba = bond_angle_deg * c_k[K_RADK];
  return place_cs(a, b, c, bond_length, cosf(ba), sinf(ba), torsion_deg);
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
// (pallas_decode.py:127-151).
struct Lane {
  const uint8_t* recs;
  int seg, nl, l;
  float mins[6], cont[6];

  __device__ __forceinline__ int byte(int b, int k) const {
    return (int)recs[((size_t)b * seg + k) * nl + l];
  }
  __device__ __forceinline__ float deq(int f, int q) const {
    return (float)q * cont[f] + mins[f];
  }
  // torsion field f (0 psi, 1 omega, 2 phi) of residue k
  __device__ __forceinline__ float torsion(int f, int k) const {
    if (f == 0) return deq(0, (byte(2, k) << 4) | (byte(3, k) >> 4));
    if (f == 1) return deq(1, ((byte(0, k) & 0x7) << 8) | byte(1, k));
    return deq(2, ((byte(3, k) & 0xF) << 8) | byte(4, k));
  }
};

__device__ __forceinline__ void lane_init(Lane* ln,
                                          const uint8_t* __restrict__ recs,
                                          const float* __restrict__ mins6,
                                          const float* __restrict__ cont6,
                                          int seg, int nl, int l) {
  ln->recs = recs;
  ln->seg = seg;
  ln->nl = nl;
  ln->l = l;
#pragma unroll
  for (int f = 0; f < 6; ++f) {
    ln->mins[f] = mins6[(size_t)f * nl + l];
    ln->cont[f] = cont6[(size_t)f * nl + l];
  }
}

// One forward NeRF step (_fwd_scan_into body, pallas_decode.py:163-181):
// residue k's angles place residue k+1's N, CA, C after (a, b, c).
__device__ __forceinline__ void fwd_step(const Lane& ln,
                                         const float* __restrict__ blca,
                                         int k, V3* a, V3* b, V3* c) {
  int b0 = ln.byte(0, k), b1 = ln.byte(1, k), b2 = ln.byte(2, k);
  int b3 = ln.byte(3, k), b4 = ln.byte(4, k), b5 = ln.byte(5, k);
  int b6 = ln.byte(6, k), b7 = ln.byte(7, k);
  float psi = ln.deq(0, (b2 << 4) | (b3 >> 4));
  float omega = ln.deq(1, ((b0 & 0x7) << 8) | b1);
  float phi = ln.deq(2, ((b3 & 0xF) << 8) | b4);
  float ncac = ln.deq(3, b7);
  float cacn = ln.deq(4, b5);
  float cnca = ln.deq(5, b6);
  V3 n = place_deg(*a, *b, *c, c_k[K_C_TO_N], cacn, psi);
  V3 ca = place_deg(*b, *c, n, blca[(size_t)k * ln.nl + ln.l], cnca, omega);
  V3 cc = place_deg(*c, n, ca, c_k[K_CA_TO_C], ncac, phi);
  *a = n;
  *b = ca;
  *c = cc;
}

// k1: forward scan from the anchor seed, blended 3-atom tail per lane.
//
// One thread per lane; the loop over residues runs inside the thread. The
// TPU kernel wrote all 3*SEG forward rows to VMEM and picked rows
// tat-3..tat-1 with a masked pass over every row (a TPU lane cannot index
// a row of its own); here the scan stops at row tat-1 and the tail atoms
// are the three in registers, so k1 needs no row buffer. Bound: the serial
// chain of sinf/cosf/rsqrtf per lane (3 placements per residue), with
// lanes against the 132 SMs' resident threads as the only parallelism.
//
// out [9, NL] rows comp*3 + kk: tail row tat-3+kk blended with the stored
// next anchor ranc by weights (tat-3+kk, 3-kk)/tat (pallas_decode.py:213-222).
__global__ void __launch_bounds__(128)
k1_tails(const uint8_t* __restrict__ recs, const float* __restrict__ blca,
         const float* __restrict__ seed, const float* __restrict__ ranc,
         const int* __restrict__ tat_, const float* __restrict__ mins6,
         const float* __restrict__ cont6, float* __restrict__ out, int seg,
         int nl) {
  int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= nl) return;
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
    for (int k = 0; 3 * k + 3 < tat; ++k) fwd_step(ln, blca, k, &a, &b, &c);
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
    out[(size_t)kk * nl + l] = (v.x * w_f + anc.x * w_r) / tf;
    out[(size_t)(3 + kk) * nl + l] = (v.y * w_f + anc.y * w_r) / tf;
    out[(size_t)(6 + kk) * nl + l] = (v.z * w_f + anc.z * w_r) / tf;
  }
}

// k2: forward scan from the refined seeds, reverse C->N sweep, blend.
//
// One thread per lane. The forward rows go straight into the output planes
// ox/oy/oz [3*SEG, NL]. The reverse sweep then runs down from row t-1 with
// a register window of forward rows r+1, r+2: at row r it reads forward row
// r, places the reverse atom (its bond angle comes from forward rows
// r..r+2), and overwrites row r with the blend (f*(tat-r) + rev*r)/tat
// (_blend_pass_sweep parity, pallas_decode.py:249-294). No reverse-row
// scratch, and no VMEM-style limit on SEG (the TPU kernel's 3*SEG scratch
// capped SEG at ~96). Bound: per lane a serial chain of ~3*SEG forward and
// 3*SEG reverse placements (sinf/cosf/rsqrtf/sqrtf/divide); lane count
// against the 132 SMs' resident threads is the only parallelism.
//
// Precondition: tat <= 3*SEG (the pack's seg_m <= SEG, checked on the host
// by codec/batch.py arrays_to_torch). Rows r <= tat-4 are the only placed
// ones, so min(r, t-3) is r there and the window holds every row the
// angle needs.
__global__ void __launch_bounds__(128)
k2_backbone(const uint8_t* __restrict__ recs, const float* __restrict__ blca,
            const float* __restrict__ seed, const float* __restrict__ ranc,
            const int* __restrict__ tat_, const float* __restrict__ mins6,
            const float* __restrict__ cont6, float* __restrict__ ox,
            float* __restrict__ oy, float* __restrict__ oz, int seg,
            int nl) {
  int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= nl) return;
  Lane ln;
  lane_init(&ln, recs, mins6, cont6, seg, nl, l);
  const int t = 3 * seg;

  V3 a = load3(seed, 0, nl, l), b = load3(seed, 3, nl, l),
     c = load3(seed, 6, nl, l);
  ox[l] = a.x;
  oy[l] = a.y;
  oz[l] = a.z;
  ox[(size_t)nl + l] = b.x;
  oy[(size_t)nl + l] = b.y;
  oz[(size_t)nl + l] = b.z;
  ox[(size_t)2 * nl + l] = c.x;
  oy[(size_t)2 * nl + l] = c.y;
  oz[(size_t)2 * nl + l] = c.z;
  for (int k = 0; k < seg - 1; ++k) {
    fwd_step(ln, blca, k, &a, &b, &c);
    size_t row = (size_t)(3 * k + 3) * nl + l;
    ox[row] = a.x;
    oy[row] = a.y;
    oz[row] = a.z;
    ox[row + nl] = b.x;
    oy[row + nl] = b.y;
    oz[row + nl] = b.z;
    ox[row + 2 * (size_t)nl] = c.x;
    oy[row + 2 * (size_t)nl] = c.y;
    oz[row + 2 * (size_t)nl] = c.z;
  }

  const int tat = tat_[l];
  const float tatf = (float)tat;
  const float tf = fmaxf(tatf, 1.0f);
  const V3 anc_n = load3(ranc, 0, nl, l), anc_ca = load3(ranc, 3, nl, l),
           anc_c = load3(ranc, 6, nl, l);
  const V3 zero = v3(0.f, 0.f, 0.f);
  V3 v1 = zero, v2 = zero, v3_ = zero;  // reverse atoms at rows r+1..r+3
  V3 f1 = zero, f2 = zero;              // forward atoms at rows r+1, r+2
  for (int i = 0; i < t; ++i) {
    const int r = t - 1 - i;
    const size_t row = (size_t)r * nl + l;
    const V3 f0 = v3(ox[row], oy[row], oz[row]);
    V3 w;
    if (r <= tat - 4) {
      // bond length cycle C-N, CA-C, N-CA by descending step (t % 3 == 0)
      const int im3 = i % 3;
      const float bl = im3 == 0 ? c_k[K_C_TO_N]
                                : (im3 == 1 ? c_k[K_CA_TO_C] : c_k[K_N_TO_CA]);
      float cos_a, sin_a;
      bond_angle_cs(f0, f1, f2, &cos_a, &sin_a);
      w = place_cs(v3_, v2, v1, bl, cos_a, sin_a, ln.torsion(r % 3, r / 3));
    } else if (r == tat - 1) {
      w = anc_c;
    } else if (r == tat - 2) {
      w = anc_ca;
    } else if (r == tat - 3) {
      w = anc_n;
    } else {
      w = zero;
    }
    const float w_r = (float)r;
    const float w_f = tatf - w_r;
    ox[row] = (f0.x * w_f + w.x * w_r) / tf;
    oy[row] = (f0.y * w_f + w.y * w_r) / tf;
    oz[row] = (f0.z * w_f + w.z * w_r) / tf;
    v3_ = v2;
    v2 = v1;
    v1 = w;
    f2 = f1;
    f1 = f0;
  }
}

// k3: side chains and the compact int16 wire.
//
// One thread per (lane, residue), in tiles of K3_TL lanes x K3_TS residues
// per block: a warp holds 32 neighbouring lanes of one residue row, so the
// reads of the backbone rows, codes and torsion codes are coalesced.
// PRED_IDX, BOND_LEN and BOND_ANG are looked up by residue code (the TPU
// kernel's where-chains, _chain_const/_sel_pred, exist only because a TPU
// lane has no gather). The tile's residues write their [42] int16 rows
// ((k, c)-major mA offsets from CA) and f32 CA into shared memory; the
// block then copies each lane's run of K3_TS residues, which is contiguous
// in the final [NL_out, SEG, 42] / [NL_out, SEG, 3] layout, with
// neighbouring threads on neighbouring 4-byte words. So the TPU path's
// epilogue transpose (pallas_decode.py:517-525) is gone.
//
// Bound, measured on an H100 80GB HBM3 (700 W power limit) at B=8192: a
// direct form of this kernel (one thread per residue, tables read from
// __constant__, each thread storing its own 84-byte row with 2-byte
// stores) took ~9.7 ms, against ~1.4 ms for this tiled form. Both of
// its memory paths serialise: neighbouring lanes carry different residue
// codes, and the constant cache serves one address per cycle to a warp,
// so each table read is replayed per distinct code; and 2-byte stores
// with a 4 KB stride between neighbouring threads touch a sector each.
// The tables are therefore copied into shared memory (banked: distinct
// addresses are served together) and the stores go through the staged
// tile. What remains is 11 placements per residue (sinf/cosf x2, rsqrtf
// x2) and 96 B of output per residue.
#define K3_TL 32
#define K3_TS 8
__global__ void __launch_bounds__(K3_TL* K3_TS)
k3_sidechain(const float* __restrict__ bx, const float* __restrict__ by,
             const float* __restrict__ bz, const int* __restrict__ code,
             const uint8_t* __restrict__ sct, int16_t* __restrict__ off,
             float* __restrict__ ca, int seg, int nl, int nl_out) {
  __shared__ int s_pred[N_CODES * MAX_ATOM * 3];
  __shared__ float s_blen[N_CODES * MAX_ATOM];
  __shared__ float s_bang[N_CODES * MAX_ATOM];
  __shared__ __align__(16) int16_t s_off[K3_TL * K3_TS * 3 * MAX_ATOM];
  __shared__ __align__(16) float s_ca[K3_TL * K3_TS * 3];
  for (int i = threadIdx.x; i < N_CODES * MAX_ATOM * 3; i += blockDim.x)
    s_pred[i] = c_pred[i];
  for (int i = threadIdx.x; i < N_CODES * MAX_ATOM; i += blockDim.x) {
    s_blen[i] = c_blen[i];
    s_bang[i] = c_bang[i];
  }
  __syncthreads();

  const int l0 = blockIdx.x * K3_TL, s0 = blockIdx.y * K3_TS;
  const int n_l = min(K3_TL, nl_out - l0), n_s = min(K3_TS, seg - s0);
  const int tl = threadIdx.x % K3_TL, ts = threadIdx.x / K3_TL;
  const int l = l0 + tl, s = s0 + ts;
  if (tl < n_l && ts < n_s) {
    float X[MAX_ATOM], Y[MAX_ATOM], Z[MAX_ATOM];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const size_t row = (size_t)(3 * s + a) * nl + l;
      X[a] = bx[row];
      Y[a] = by[row];
      Z[a] = bz[row];
    }
    const int cd = code[(size_t)s * nl + l] & (N_CODES - 1);  // 5-bit code
    for (int k = 3; k < MAX_ATOM; ++k) {
      const int* p = &s_pred[(cd * MAX_ATOM + k) * 3];
      const int i0 = p[0], i1 = p[1], i2 = p[2];
      // u8 -> int -> float, then cast*cont + min (pallas_decode.py:369-370)
      const float tor =
          (float)(int)sct[((size_t)s * 11 + (k - 3)) * nl + l] *
              c_k[K_SC_CONT] +
          c_k[K_SC_MIN];
      const V3 o = place_deg(v3(X[i0], Y[i0], Z[i0]),
                             v3(X[i1], Y[i1], Z[i1]),
                             v3(X[i2], Y[i2], Z[i2]),
                             s_blen[cd * MAX_ATOM + k],
                             s_bang[cd * MAX_ATOM + k], tor);
      X[k] = o.x;
      Y[k] = o.y;
      Z[k] = o.z;
    }
    // lane tl's residues are contiguous in the tile: slot tl * n_s + ts
    const int slot = tl * n_s + ts;
    const float cax = X[1], cay = Y[1], caz = Z[1];
    s_ca[slot * 3] = cax;
    s_ca[slot * 3 + 1] = cay;
    s_ca[slot * 3 + 2] = caz;
    int16_t* o = s_off + slot * (3 * MAX_ATOM);
#pragma unroll
    for (int k = 0; k < MAX_ATOM; ++k) {
      o[k * 3] = (int16_t)fminf(
          fmaxf(rintf((X[k] - cax) * 1000.0f), -32767.0f), 32767.0f);
      o[k * 3 + 1] = (int16_t)fminf(
          fmaxf(rintf((Y[k] - cay) * 1000.0f), -32767.0f), 32767.0f);
      o[k * 3 + 2] = (int16_t)fminf(
          fmaxf(rintf((Z[k] - caz) * 1000.0f), -32767.0f), 32767.0f);
    }
  }
  __syncthreads();

  // Each lane's n_s residues: n_s * 84 B of off (21 words a residue; the
  // run starts at a multiple of 84 B, so 4-byte aligned) and n_s * 3
  // floats of ca, contiguous in global and in the tile.
  const int w_off = n_s * (3 * MAX_ATOM / 2), w_ca = n_s * 3;
  const uint32_t* t_off = reinterpret_cast<const uint32_t*>(s_off);
  for (int i = threadIdx.x; i < n_l * w_off; i += blockDim.x) {
    const int lc = i / w_off, q = i - lc * w_off;
    reinterpret_cast<uint32_t*>(
        off + ((size_t)(l0 + lc) * seg + s0) * (3 * MAX_ATOM))[q] =
        t_off[lc * w_off + q];
  }
  for (int i = threadIdx.x; i < n_l * w_ca; i += blockDim.x) {
    const int lc = i / w_ca, q = i - lc * w_ca;
    ca[((size_t)(l0 + lc) * seg + s0) * 3 + q] = s_ca[lc * w_ca + q];
  }
}

static unsigned blocks_for(size_t n, unsigned threads) {
  return (unsigned)((n + threads - 1) / threads);
}

extern "C" {

cudaError_t fd_set_tables(const int* pred32, const float* blen32,
                          const float* bang32, const float* consts,
                          int n_consts) {
  if (n_consts != K_COUNT) return cudaErrorInvalidValue;
  cudaError_t e = cudaMemcpyToSymbol(c_pred, pred32, sizeof(c_pred));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(c_blen, blen32, sizeof(c_blen));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(c_bang, bang32, sizeof(c_bang));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(c_k, consts, sizeof(c_k));
  return e;
}

cudaError_t fd_tails(const uint8_t* recs, const float* blca, const float* seed,
                     const float* ranc, const int* tat, const float* mins6,
                     const float* cont6, float* out, int seg, int nl,
                     cudaStream_t stream) {
  k1_tails<<<blocks_for(nl, 128), 128, 0, stream>>>(
      recs, blca, seed, ranc, tat, mins6, cont6, out, seg, nl);
  return cudaGetLastError();
}

cudaError_t fd_backbone(const uint8_t* recs, const float* blca,
                        const float* seed, const float* ranc, const int* tat,
                        const float* mins6, const float* cont6, float* ox,
                        float* oy, float* oz, int seg, int nl,
                        cudaStream_t stream) {
  k2_backbone<<<blocks_for(nl, 128), 128, 0, stream>>>(
      recs, blca, seed, ranc, tat, mins6, cont6, ox, oy, oz, seg, nl);
  return cudaGetLastError();
}

cudaError_t fd_sidechain(const float* bx, const float* by, const float* bz,
                         const int* code, const uint8_t* sct, int16_t* off,
                         float* ca, int seg, int nl, int nl_out,
                         cudaStream_t stream) {
  const dim3 grid(blocks_for(nl_out, K3_TL), blocks_for(seg, K3_TS));
  k3_sidechain<<<grid, K3_TL * K3_TS, 0, stream>>>(bx, by, bz, code, sct,
                                                   off, ca, seg, nl, nl_out);
  return cudaGetLastError();
}

}  // extern "C"
