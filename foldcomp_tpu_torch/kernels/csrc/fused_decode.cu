// Fused ragged-lane decode for Hopper (sm_90a): k0 the kernel inputs,
// k1 tails, k2 backbone, k3 side chains, and the bb wire's backbone kernel.
//
// Replaces the three Pallas TPU decode kernels and their bb-wire call site
// in foldcomp_tpu/kernels/pallas_decode.py, and the XLA glue before them:
//   k0 fd_prep       <- _class_prep             (pallas_decode.py:405-437)
//                       and the lane order, every width class of a batch
//                       in one launch
//   k1 fd_tails      <- _make_tails_kernel      (pallas_decode.py:186),
//                       every width class of a batch in one launch
//                       (_run_tails once a class, :654-656)
//   k2 fd_backbone   <- _make_backbone_kernel   (pallas_decode.py:227),
//                       with the seed roll of :596-610 (or, for width
//                       classes, the prev_idx gather of :654-670) and the
//                       N-CA lengths of _class_prep (:405-437); every width
//                       class of a batch in one launch of k2_backbone
//                       (_run_backbone_sc once a class, :675-677)
//   k3 fd_sidechain  <- _make_sidechain_kernel  (pallas_decode.py:338)
//   fd_backbone_bb   <- _run_backbone_only      (pallas_decode.py:529):
//                       k2 with its XLA epilogue (:561-570) in one kernel,
//                       k2_backbone_bb
// Each computes what the Pallas kernel computes; the plain PyTorch
// versions beside them (fused_decode.py tails_plain / backbone_rolled_plain
// / sidechain_plain / bb_epilogue_plain) are the oracle, bit for bit on the
// rows a lane owns.
//
// Layouts are the pack's lane-minor ones (codec/batch.py
// pack_decode_batch_lanes): row-major [rows, NL]. k1 and k2 take one
// thread per lane in the order lane_order gives (by row count, longest
// first), so that a warp's lanes have one length; k2 stages its rows at
// the thread's column (pos[l]), or on the bb wire turns its blended rows
// into the wire's 24 B rows as it goes (k2_backbone_bb); k3 walks groups
// of 32 neighbouring lanes and reads lane l's rows there, at pos[l]. Each
// walks a lane's own rows only (r < tat = 3*seg_m); the rest is pack
// padding and is left unwritten. What bounds each on an H100 (PERF.md §6;
// chip_smoke.py counts the operations, a full-precision sincosf at the
// float instructions of its compiled fast path, at 33.5 T float
// instructions/s, since -fmad=false leaves no FMA): k1, k2 and
// k2_backbone_bb their float operations, k3 its loads and stores.
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
// in .x and 4-7 in .y, so they can be loaded one residue ahead of use,
// through the read-only path (k1 takes its pointers from a class table,
// where no __restrict__ parameter tells the compiler they are read-only).
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
      if (b < n) w[b >> 2] |= (uint32_t)__ldg(q) << (8 * (b & 3));
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

// A batch's width classes as k0, k1 and k2 take them, laid out once a
// batch by fused_decode.py class_layout: the classes that have lanes and
// rows, at most MAX_CLASSES (core/tables.py's, split_lanes_classes' cap),
// in launch order, the widest SEG first (its walks the longest, so that
// they start first and the shorter classes fill the SMs behind them; k0's
// output does not depend on the order). Each kernel's class is a
// ClassGeom and the kernel's own pointers; the launch takes its table by
// value (no copy to the device) and read_classes checks the geometry.
#define MAX_CLASSES 4

struct ClassGeom {
  int seg, nl;
  int col0;    // the class's first column of the [9, NL_total] tails
  int sort0;   // its first sort block of k0
  int unit0;   // its first unit of k0
  int block0;  // its first block of k1 and of k2_backbone
};

// k0: the kernel inputs of every width class of a batch in one launch, what
// fused_decode.py class_prep and lane_order give (the plain version and
// the oracle), each class into its slots of one workspace the wrapper
// allocates:
//   code  = recs[0] >> 3 (the residue-code plane k3 reads), i32 [SEG, NL];
//   tat   = 3 * seg_m, i32 [NL];
//   mins6, cont6: the quantizer rows in kernel field order (K0_FIELD_COLS
//         of the header's columns), f32 [6, NL];
//   order: the lanes by tat, longest first, stable (a permutation equal to
//         torch.argsort(tat, descending=True, stable=True)), i32 [NL].
// In bb mode (the table's `bb`: the backbone-only wire, where no k3 runs
// to read it) there is no code plane: a class's units are its lanes alone,
// and the other outputs are those of the full mode, bit for bit.
// On the TPU path these were XLA operations, and in the port torch's: some
// ten launches a class, an argsort among them, and a column table copied
// from the host, which waited for the stream. Here nothing is copied from
// the host: the table of classes goes by value, the column order is a
// constant of the kernel.
//
// Bound: bytes, the code plane's (1 B in, 4 B out a slot). The first
// blocks sort, K0_SORT_LANES lanes of one class each; the blocks after
// them fill the planes, a thread a unit: K0_CODE_UNIT code slots (a 4-byte
// load where the plane allows, one 16-byte store, so that a warp's store
// is 512 contiguous bytes), or one lane's tat, mins6 and cont6.
//
// The sort is a stable counting sort on key = SEG - seg_m (0 .. SEG-1;
// seg_m outside 1 .. SEG, which the pack never gives, sorts as the nearest
// end, and any order gives the kernels the same values). A block orders
// the lanes [lo, hi) of its class into their places among all the class's
// lanes, so it needs, for each key, the class's lanes of a smaller key and
// those of the same key before lo: it counts every lane of the class
// outside [lo, hi) itself (the blocks share nothing, so no block waits
// for another; each reads the class's seg_m from L2): a thread takes
// K0_RUN consecutive lanes and adds each run of one key with one shared
// atomic (a protein's interior segments share one length, so runs are
// long), with no warp-wide step.
// Warp w owns a contiguous run of [lo, hi) and walks it 32 lanes at a time,
// so its lanes come in pack order: it counts its lanes of each key, the
// counts are scanned bucket-major and warp-minor (a bucket's lanes of warp
// w follow those of warps < w), and it walks again, writing each lane at
// its bucket's offset for the warp plus its rank among the lower lanes of
// its group (a warp's lanes of one key: __match_any_sync, or the whole
// warp where every lane has one key, as a protein's interior segments do).
// Keys go in passes of K0_BUCKETS (one pass for SEG <= K0_BUCKETS, which
// the default anchor interval gives; a wider SEG takes more passes, with
// no limit).
#define K0_THREADS 512
#define K0_WARPS (K0_THREADS / 32)
#define K0_SORT_LANES 8192  // lanes a sort block orders: 16 rows a warp
#define K0_BUCKETS 256
#define K0_UNROLL 4         // rows of 32 lanes loaded at once
#define K0_RUN 16           // consecutive lanes a thread counts at once
#define K0_CODE_UNIT 4
// decode field order (psi, omega, phi, n_ca_c, ca_c_n, c_n_ca) from the
// header's column order (phi, psi, omega, ...): core/tables.py FIELD_COLS,
// which a CPU test holds this to
#define K0_FIELD_COLS {1, 2, 0, 3, 4, 5}
__constant__ int c_field_cols[6] = K0_FIELD_COLS;

struct K0Class : ClassGeom {
  const uint8_t* recs;       // [8, seg, nl]; plane 0 holds byte 0
  const float* mins_lane;    // [nl, 6], the header's column order
  const float* cont_lane;    // [nl, 6]
  const int* seg_m;          // [nl]
  int* code;                 // [seg, nl]
  int* tat;                  // [nl]
  float* mins6;              // [6, nl]
  float* cont6;              // [6, nl]
  int* order;                // [nl]
};
struct K0Table {
  K0Class c[MAX_CLASSES];     // by sort0 and unit0, ascending; none empty
  int n;
  int sort_blocks;
  int units;
  int bb;                     // 1: no code plane (code is null)
};

// The bucket of seg_m value sm in the pass from key k0, or -1 outside it.
__device__ __forceinline__ int k0_bucket(int sm, int seg, int k0) {
  const int k = seg - min(max(sm, 1), seg) - k0;
  return k >= 0 && k < K0_BUCKETS ? k : -1;
}

// The warp's lanes whose key is k (each lane's own k).
__device__ __forceinline__ unsigned k0_peers(int k) {
  if (__all_sync(0xffffffffu, k == __shfl_sync(0xffffffffu, k, 0)))
    return 0xffffffffu;
  return __match_any_sync(0xffffffffu, k);
}

// Adds the class's lanes [from, to) of each bucket of the pass to hist
// (shared): thread t takes lanes [from + K0_RUN * i, + K0_RUN) for i = t,
// t + K0_THREADS, ... (16-byte loads where seg_m + from is 16-byte
// aligned) and adds each run of one bucket at once.
__device__ __forceinline__ void k0_count(const K0Class& cl, int from, int to,
                                         int k0, int* hist) {
  const bool vec = (reinterpret_cast<uintptr_t>(cl.seg_m + from) & 15) == 0;
  for (int l0 = from + K0_RUN * (int)threadIdx.x; l0 < to;
       l0 += K0_RUN * K0_THREADS) {
    int sm[K0_RUN];
    if (vec && l0 + K0_RUN <= to) {
#pragma unroll
      for (int q = 0; q < K0_RUN / 4; ++q) {
        const int4 v = __ldg(reinterpret_cast<const int4*>(cl.seg_m + l0) + q);
        sm[4 * q] = v.x;
        sm[4 * q + 1] = v.y;
        sm[4 * q + 2] = v.z;
        sm[4 * q + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int q = 0; q < K0_RUN; ++q)
        sm[q] = l0 + q < to ? __ldg(cl.seg_m + l0 + q) : 0;
    }
    int run_k = -1, run_n = 0;
#pragma unroll
    for (int q = 0; q < K0_RUN; ++q) {
      const int k = l0 + q < to ? k0_bucket(sm[q], cl.seg, k0) : -1;
      if (k != run_k) {
        if (run_k >= 0) atomicAdd(hist + run_k, run_n);
        run_k = k;
        run_n = 0;
      }
      ++run_n;
    }
    if (run_k >= 0) atomicAdd(hist + run_k, run_n);
  }
}

// Walks the warp's run [c0, c1) in pack order, K0_UNROLL rows of 32 at a
// time: visit(bucket, lane, peers), every thread of the warp at every
// step.
template <class Visit>
__device__ __forceinline__ void k0_walk(const K0Class& cl, int c0, int c1,
                                        int k0, Visit visit) {
  const int lane = threadIdx.x & 31;
  for (int r0 = c0; r0 < c1; r0 += 32 * K0_UNROLL) {
    int key[K0_UNROLL];
#pragma unroll
    for (int u = 0; u < K0_UNROLL; ++u) {
      const int l = r0 + 32 * u + lane;
      key[u] = l < c1 ? k0_bucket(__ldg(cl.seg_m + l), cl.seg, k0) : -1;
    }
#pragma unroll
    for (int u = 0; u < K0_UNROLL; ++u)
      visit(key[u], r0 + 32 * u + lane, k0_peers(key[u]));
  }
}

// Block q of class cl's sort blocks: the places of lanes [lo, hi).
__device__ __forceinline__ void k0_sort(const K0Class& cl, int q) {
  __shared__ int s_cnt[K0_BUCKETS * K0_WARPS];  // [bucket][warp]
  __shared__ int s_before[K0_BUCKETS], s_after[K0_BUCKETS];
  __shared__ int s_part[32];
  __shared__ int s_total;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int lo = q * K0_SORT_LANES, hi = min(lo + K0_SORT_LANES, cl.nl);
  const int per = (((hi - lo + 31) >> 5) + K0_WARPS - 1) / K0_WARPS;
  const int c0 = min(lo + warp * per * 32, hi);  // the warp's run
  const int c1 = min(c0 + per * 32, hi);
  const int t = threadIdx.x;
  int base = 0;  // the class's lanes of the passes before
  for (int k0 = 0; k0 < cl.seg; k0 += K0_BUCKETS) {
    for (int i = t; i < K0_BUCKETS * K0_WARPS; i += K0_THREADS) s_cnt[i] = 0;
    for (int i = t; i < K0_BUCKETS; i += K0_THREADS)
      s_before[i] = s_after[i] = 0;
    __syncthreads();
    k0_count(cl, 0, lo, k0, s_before);
    k0_count(cl, hi, cl.nl, k0, s_after);
    k0_walk(cl, c0, c1, k0, [&](int k, int, unsigned peers) {
      if (k >= 0 && (peers & below) == 0)
        s_cnt[k * K0_WARPS + warp] += __popc(peers);
      __syncwarp();
    });
    __syncthreads();
    // bucket t's first place for warp w: the class's lanes of smaller
    // keys, its lanes of key t before lo, those of warps < w
    int tot = 0, before = 0;
    if (t < K0_BUCKETS) {
      before = s_before[t];
      tot = before + s_after[t];
#pragma unroll
      for (int w = 0; w < K0_WARPS; ++w) tot += s_cnt[t * K0_WARPS + w];
    }
    int incl = tot;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) s_part[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int p = lane < K0_WARPS ? s_part[lane] : 0;
      int x = p;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
      }
      if (lane < K0_WARPS) s_part[lane] = x - p;
      if (lane == 31) s_total = x;
    }
    __syncthreads();
    if (t < K0_BUCKETS) {
      int run = base + s_part[warp] + incl - tot + before;
#pragma unroll
      for (int w = 0; w < K0_WARPS; ++w) {
        const int v = s_cnt[t * K0_WARPS + w];
        s_cnt[t * K0_WARPS + w] = run;
        run += v;
      }
    }
    base += s_total;
    __syncthreads();
    k0_walk(cl, c0, c1, k0, [&](int k, int l, unsigned peers) {
      if (k >= 0)
        cl.order[s_cnt[k * K0_WARPS + warp] + __popc(peers & below)] = l;
      __syncwarp();
      if (k >= 0 && (peers & below) == 0)
        s_cnt[k * K0_WARPS + warp] += __popc(peers);
      __syncwarp();
    });
    __syncthreads();  // s_cnt and s_total are read before the next pass
  }
}

// Unit j of a class: code slots K0_CODE_UNIT * j .. + K0_CODE_UNIT - 1, or
// past the code units (none in bb mode), lane j - code units.
__device__ __forceinline__ void k0_unit(const K0Class& cl, int j, int bb) {
  const long long n = (long long)cl.seg * cl.nl;
  const long long quads = bb ? 0 : (n + K0_CODE_UNIT - 1) / K0_CODE_UNIT;
  if (j < quads) {
    const long long i = (long long)j * K0_CODE_UNIT;
    const uint8_t* src = cl.recs + i;
    int* dst = cl.code + i;  // 16-byte aligned (the workspace's slots)
    if (i + K0_CODE_UNIT <= n &&
        (reinterpret_cast<uintptr_t>(src) & 3) == 0) {
      const uint32_t w = __ldg(reinterpret_cast<const unsigned int*>(src));
      *reinterpret_cast<int4*>(dst) =
          make_int4((w & 0xff) >> 3, ((w >> 8) & 0xff) >> 3,
                    ((w >> 16) & 0xff) >> 3, (w >> 24) >> 3);
    } else {
      for (long long q = 0; q < K0_CODE_UNIT && i + q < n; ++q)
        dst[q] = (int)__ldg(src + q) >> 3;
    }
    return;
  }
  const int l = (int)(j - quads);
  const int nl = cl.nl;
  cl.tat[l] = 3 * __ldg(cl.seg_m + l);
  const float* m = cl.mins_lane + (size_t)l * 6;
  const float* c = cl.cont_lane + (size_t)l * 6;
#pragma unroll
  for (int f = 0; f < 6; ++f) {
    cl.mins6[(size_t)f * nl + l] = __ldg(m + c_field_cols[f]);
    cl.cont6[(size_t)f * nl + l] = __ldg(c + c_field_cols[f]);
  }
}

__global__ void __launch_bounds__(K0_THREADS)
k0_prep(const __grid_constant__ K0Table tab) {
  const int b = blockIdx.x;
  if (b < tab.sort_blocks) {
    int ci = 0;  // the last class whose sort blocks start at or before b
    for (int k = 1; k < tab.n; ++k)
      if (b >= tab.c[k].sort0) ci = k;
    k0_sort(tab.c[ci], b - tab.c[ci].sort0);
    return;
  }
  const int stride = ((int)gridDim.x - tab.sort_blocks) * K0_THREADS;
  for (int u = (b - tab.sort_blocks) * K0_THREADS + (int)threadIdx.x;
       u < tab.units; u += stride) {
    int ci = 0;  // the last class whose units start at or before u
    for (int k = 1; k < tab.n; ++k)
      if (u >= tab.c[k].unit0) ci = k;
    k0_unit(tab.c[ci], u - tab.c[ci].unit0, tab.bb);
  }
}

// k1: forward scan from the anchor seed, blended 3-atom tail per lane,
// for every width class of a batch in one launch.
//
// One thread per lane, the lanes of a class taken in the order its
// `order` gives (fused_decode.py lane_order: by tat, longest first,
// stable), so that the threads of a warp walk lanes of one length and none
// waits for a longer one. The loop over residues runs inside the thread
// and stops at the lane's own row tat-1; the tail atoms are the three in
// registers, so k1 needs no row buffer (the TPU kernel wrote all 3*SEG
// forward rows to VMEM and picked rows tat-3..tat-1 with a masked pass
// over every row: a TPU lane cannot index a row of its own).
//
// Bound: operations. A forward step is 3 placements with 6 full-precision
// sincosf: 357 float instructions on its compiled fast path, 23 a sincosf
// (chip_smoke.py counts them from the SASS of this loop), and -fmad=false
// leaves no FMA, so one float instruction is one operation at the card's
// 33.5 T instructions/s; the 8 B record a step moves takes far less time
// than that. At B=8192 on an H100 that bound is ~0.044 ms and k1 takes
// ~0.096 (PERF.md §6); computing a run of steps' sincosf ahead of the
// placement chain through shared memory made it slower. The lanes against
// the card's resident threads are the only parallelism, so a launch must
// give the card all of them at once: a width class alone (a few dozen
// blocks for the widest class) left most SMs idle, and four class launches
// ran one after another (~0.20 ms against ~0.09 in one). So one launch
// takes a table of up to MAX_CLASSES classes by value (no copy to the
// device) and gives each class a range of blocks, the widest class (its
// lanes the longest walks) the first blocks, so that its walks start first
// and the shorter classes fill the SMs behind them.
//
// out [9, NL_total] rows comp*3 + kk, row stride out_ld >= NL_total: lane
// l of a class writes column col0 + l, its tail row tat-3+kk blended with
// the stored next anchor ranc by weights (tat-3+kk, 3-kk)/tat
// (pallas_decode.py:213-222); k2 gathers its seeds from there through
// prev.
#define K1_THREADS 128

struct K1Class : ClassGeom {
  const uint8_t* recs;  // [8, seg, nl]
  const float* seed;    // [9, nl]
  const float* ranc;    // [9, nl]
  const int* tat;       // [nl]
  const float* mins6;   // [6, nl]
  const float* cont6;   // [6, nl]
  const int* order;     // [nl], a permutation of the class's lanes
};
struct K1Table {
  K1Class c[MAX_CLASSES];  // by block0, ascending; none empty
  int n;
};

__global__ void __launch_bounds__(K1_THREADS)
k1_tails(const __grid_constant__ K1Table tab, float* __restrict__ out,
         int out_ld) {
  int ci = 0;  // the last class whose blocks start at or before this one
  for (int k = 1; k < tab.n; ++k)
    if ((int)blockIdx.x >= tab.c[k].block0) ci = k;
  const K1Class& cl = tab.c[ci];
  const int i = ((int)blockIdx.x - cl.block0) * K1_THREADS + threadIdx.x;
  const int nl = cl.nl, seg = cl.seg;
  if (i >= nl) return;
  const int l = cl.order[i];
  Lane ln;
  lane_init(&ln, cl.recs, cl.mins6, cl.cont6, seg, nl, l);
  int tat = cl.tat[l];
  const float* __restrict__ seed = cl.seed;
  const float* __restrict__ ranc = cl.ranc;
  out += cl.col0;
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
// :596-610). k2_lane is one lane's walk; the two wires differ only in
// where its blended rows go (the Out policy): on the full wire
// (k2_backbone, StageRows) into the planes sx/sy/sz [3*SEG, NL] at its
// thread's column, where k3 reads them; on the bb wire (k2_backbone_bb,
// BbRuns) straight into the wire's 24 B rows.
//
// One thread per lane, the lanes in the order `order` gives (lane_order:
// by tat, longest first, stable), so that a warp's lanes have one length
// and none waits for a longer one (in pack order the warps of the B=8192
// batch walk 1.46x its real rows). A lane walks its own rows only, 0 ..
// tat-1 (tat = 3*seg_m): rows >= tat are pack padding, neither computed
// nor written, and pad lanes (seg_m 1) do the 3-row blend alone.
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
//    the record; then the blend (f*(tat-r) + rev*r)/tat goes to the Out
//    policy, atom by atom (C, CA, N of residue j), then the residue.
// The N-CA length comes from the record's residue code (fwd_step), the
// bond lengths of the reverse cycle C-N, CA-C, N-CA by row, all as the
// TPU kernel has them. No VMEM-style limit on SEG (the TPU kernel's 3*SEG
// scratch capped SEG at ~96).
template <class Out>
__device__ __forceinline__ void k2_lane(
    const Lane& ln, V3 a, V3 b, V3 c, const float* __restrict__ ranc,
    float* __restrict__ sx, float* __restrict__ sy, float* __restrict__ sz,
    int tat, int nl, int l, int i, Out& out) {
  const int sm = tat / 3;  // the lane's residues
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
    return v3((f.x * w_f + w.x * w_r) / tf, (f.y * w_f + w.y * w_r) / tf,
              (f.z * w_f + w.z * w_r) / tf);
  };
  // reverse atoms at rows r+1..r+3 and forward atoms at r+1, r+2
  V3 v3_ = load3(ranc, 6, nl, l), v2 = load3(ranc, 3, nl, l),
     v1 = load3(ranc, 0, nl, l);
  out.atom(2, tat - 1, blend(tat - 1, c, v3_));
  out.atom(1, tat - 2, blend(tat - 2, b, v2));
  out.atom(0, tat - 3, blend(tat - 3, a, v1));
  out.residue(sm - 1);
  V3 f1 = a, f2 = b;
  auto rev = [&](int r, V3 f0, float bl, float2 tor) {
    float cos_a, sin_a;
    bond_angle_cs(f0, f1, f2, &cos_a, &sin_a);
    const V3 w = place_cs(v3_, v2, v1, bl, cos_a, sin_a, tor);
    v3_ = v2;
    v2 = v1;
    v1 = w;
    f2 = f1;
    f1 = f0;
    return blend(r, f0, w);
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
    out.atom(2, 3 * j + 2,
             rev(3 * j + 2, q2, c_k[K_C_TO_N], cs_deg(ln.torsion(2, cw))));
    out.atom(1, 3 * j + 1,
             rev(3 * j + 1, q1, c_k[K_CA_TO_C], cs_deg(ln.torsion(1, cw))));
    out.atom(0, 3 * j,
             rev(3 * j, q0, c_k[K_N_TO_CA], cs_deg(ln.torsion(0, cw))));
    out.residue(j);
  }
}

// The lane's seed: the predecessor's blended tail or its own fwd9 (above).
__device__ __forceinline__ void k2_seed(
    const float* __restrict__ tails9, const int* __restrict__ prev,
    const float* __restrict__ fwd9, const uint8_t* __restrict__ is_first,
    int tails_ld, int nl, int l, V3* a, V3* b, V3* c) {
  if (tails9 != nullptr && !is_first[l]) {
    // the predecessor's tail, rows comp*3 + atom
    const size_t p = prev != nullptr ? (size_t)prev[l]
                                     : (l == 0 ? nl - 1 : l - 1);
    const size_t ld = (size_t)tails_ld;
    *a = v3(tails9[p], tails9[3 * ld + p], tails9[6 * ld + p]);
    *b = v3(tails9[ld + p], tails9[4 * ld + p], tails9[7 * ld + p]);
    *c = v3(tails9[2 * ld + p], tails9[5 * ld + p], tails9[8 * ld + p]);
  } else {
    *a = load3(fwd9, 0, nl, l);
    *b = load3(fwd9, 3, nl, l);
    *c = load3(fwd9, 6, nl, l);
  }
}

// The full wire's Out: each blended row back into scratch row r, in place
// (the forward row there has been read by then).
struct StageRows {
  float *sx, *sy, *sz;
  int nl, i;
  __device__ __forceinline__ void atom(int, int r, V3 v) {
    put_row(sx, sy, sz, r, nl, i, v);
  }
  __device__ __forceinline__ void residue(int) {}
};

// k2_backbone, the full wire, in one launch over every width class of a
// batch: the lane walks into the planes at each thread's column i, and
// pos[l] = i records where lane l went. The rows stay there: k3 reads
// them in the same column order (k3_sidechain).
//
// Bound (PERF.md §6): operations, the forward's as k1's (k1 is the same
// loop without the stores) and the reverse's placements, its 3 sincosf a
// residue and its divisions, with its loads and stores behind them. The
// blend's stores cost ~0.31 ms when they went straight to the lanes'
// columns, ~0.04 ms in place at the thread's; so they stay at the thread's
// column, every warp store a whole line (a second kernel that copied them
// to the lanes' columns took 8-9% of the card's time in the full-wire
// resident cells, until k3 read them where they are).
//
// Why one launch takes every class: a thread walks its lane's residues in
// order, so a class's launch lasts as long as its longest walks however
// few its lanes, and launches on one stream run one after another. Once a
// class at B=8192 (4 classes, SEG 24/32/40/48: 23,552, 142,336, 2,048
// and 2,048 lanes; the two small classes 16 blocks each on 132 SMs), k2
// and its copy-out took 0.088-0.140, 0.321-0.333, 0.090-0.143 and
// 0.105-0.110 ms: 0.60-0.73 ms summed, though the three small classes
// hold 14% of the rows, against 0.417-0.428 ms for the same batch as one
// class, whose walks are the same arithmetic. So, as k1 (K1Table), the
// kernel takes a table of up to MAX_CLASSES classes by value and gives
// each class a range of blocks, the widest class first (class_layout's
// order, with k1's blocks), so that its long walks start first and the
// bulk class fills the SMs behind them. A block
// finds its class before the walk; the walk itself (k2_seed, k2_lane,
// StageRows) is a class's launch's, so every row a lane owns is the same
// float. The bound is unchanged: the same operations and bytes.
#define K2_THREADS K1_THREADS  // k2_backbone's block: k1's table's blocks

struct K2Class : ClassGeom {
  const uint8_t* recs;       // [8, seg, nl]
  const float* fwd9;         // [9, nl]
  const uint8_t* is_first;   // [nl]
  const float* ranc;         // [9, nl]
  const int* tat;            // [nl]
  const float* mins6;        // [6, nl]
  const float* cont6;        // [6, nl]
  const int* order;          // [nl], a permutation of the class's lanes
  const int* prev;           // [nl] columns of tails9, or null: lane l-1
  float *sx, *sy, *sz;       // [3*seg, nl] out, at the thread's column
  int* pos;                  // [nl] out: the column (thread) of lane l
};
struct K2Table {
  K2Class c[MAX_CLASSES];     // by block0, ascending; none empty
  const float* tails9;        // [9, tails_ld], or null (refine_iters 1)
  int tails_ld;
  int n;
};

__global__ void __launch_bounds__(K2_THREADS)
k2_backbone(const __grid_constant__ K2Table tab) {
  int ci = 0;  // the last class whose blocks start at or before this one
  for (int k = 1; k < tab.n; ++k)
    if ((int)blockIdx.x >= tab.c[k].block0) ci = k;
  const K2Class& cl = tab.c[ci];
  const int nl = cl.nl, seg = cl.seg;
  const int i = ((int)blockIdx.x - cl.block0) * K2_THREADS + threadIdx.x;
  if (i >= nl) return;
  const int l = cl.order[i];
  cl.pos[l] = i;
  const int tat = min(cl.tat[l], 3 * seg);
  if (tat < 3) return;
  Lane ln;
  lane_init(&ln, cl.recs, cl.mins6, cl.cont6, seg, nl, l);
  V3 a, b, c;
  k2_seed(tab.tails9, cl.prev, cl.fwd9, cl.is_first, tab.tails_ld, nl, l, &a,
          &b, &c);
  float* __restrict__ sx = cl.sx;
  float* __restrict__ sy = cl.sy;
  float* __restrict__ sz = cl.sz;
  StageRows out{sx, sy, sz, nl, i};
  k2_lane(ln, a, b, c, cl.ranc, sx, sy, sz, tat, nl, l, i, out);
}

// The bb wire's Out (the XLA epilogue of _run_backbone_only,
// pallas_decode.py:561-570): once residue s's C, CA and N are blended,
//   off[l, s, 0:3] = clip(rint((N - CA) * 10000)), off[l, s, 3:6] the same
//   for C, as int16 (0.1 mA offsets from CA), and ca[l, s, :] = CA,
// 24 B a residue in [NL_out, SEG, 6] / [NL_out, SEG, 3]. The rows of a
// lane are contiguous 12-byte rows of each output, so the thread gathers
// its lane's residues in runs of KB_RUN = 8 (residues 8R .. 8R+7) in its
// own slice of shared memory (3 words of off and 3 of ca a residue; the
// slices KB_WORDS apart, an odd count, so that the threads of a warp hit
// 32 different banks) and writes a run when its lowest residue is done
// (the reverse walks down): 96 B of off and 96 B of ca. Where SEG % 4 ==
// 0 the run starts 16-byte aligned (12 * (l * SEG + 8R) bytes) and goes
// out as 16-byte stores; with the pack's 8-row bucket (SEG % 8 == 0) it
// starts 32-byte aligned, so every sector is written whole. A lane's top
// run (from 8 * floor((rows - 1) / 8)) may be partial: its whole 16-byte
// chunks, then 4-byte words. Other SEG: 4-byte stores. Rows s >= rows =
// min(seg_m[l], tat / 3) are left unwritten.
#define KB_RUN 8
#define KB_WORDS (6 * KB_RUN + 1)

// Offsets a and b as int16 0.1 mA units, a in the low half.
__device__ __forceinline__ uint32_t bb_pack(float a, float b) {
  const float v0 = fminf(fmaxf(rintf(a * 10000.0f), -32767.0f), 32767.0f);
  const float v1 = fminf(fmaxf(rintf(b * 10000.0f), -32767.0f), 32767.0f);
  return (uint32_t)(uint16_t)(int16_t)v0 |
         ((uint32_t)(uint16_t)(int16_t)v1 << 16);
}

struct BbRuns {
  uint32_t* s;   // this thread's slice: off words [0, 3*KB_RUN), ca after
  int16_t* off;  // [NL_out, SEG, 6]
  float* ca;     // [NL_out, SEG, 3]
  int seg, l, rows;

  // The atoms of residue j = r / 3 come C, CA, N. Each goes to the slice
  // at once, so that nothing is held in registers across the placements:
  // C as it is, until CA gives its offsets (C.x - CA.x held in its word
  // until N comes); then CA; then N's offsets, with CA read back.
  __device__ __forceinline__ void atom(int k, int r, V3 v) {
    const int j = r / 3;
    if (j >= rows) return;
    uint32_t* o = s + 3 * (j % KB_RUN);
    uint32_t* a = o + 3 * KB_RUN;
    if (k == 2) {
      o[0] = __float_as_uint(v.x);
      o[1] = __float_as_uint(v.y);
      o[2] = __float_as_uint(v.z);
    } else if (k == 1) {
      const V3 c = v3(__uint_as_float(o[0]), __uint_as_float(o[1]),
                      __uint_as_float(o[2]));
      o[1] = __float_as_uint(c.x - v.x);
      o[2] = bb_pack(c.y - v.y, c.z - v.z);
      a[0] = __float_as_uint(v.x);
      a[1] = __float_as_uint(v.y);
      a[2] = __float_as_uint(v.z);
    } else {
      const V3 ca = v3(__uint_as_float(a[0]), __uint_as_float(a[1]),
                       __uint_as_float(a[2]));
      o[0] = bb_pack(v.x - ca.x, v.y - ca.y);
      o[1] = bb_pack(v.z - ca.z, __uint_as_float(o[1]));
    }
  }
  // a run is written when its lowest residue is staged
  __device__ __forceinline__ void residue(int j) {
    if (j < rows && j % KB_RUN == 0) flush(j, min(rows - j, KB_RUN));
  }
  // residues s0 .. s0 + m - 1 of the slice: 3m words of each output
  __device__ __forceinline__ void flush(int s0, int m) {
    const size_t base = ((size_t)l * seg + s0) * 3;
    uint32_t* go = reinterpret_cast<uint32_t*>(off) + base;
    uint32_t* gc = reinterpret_cast<uint32_t*>(ca) + base;
    const uint32_t* sc = s + 3 * KB_RUN;
    const int words = 3 * m;
    const int chunks = (seg & 3) == 0 ? words / 4 : 0;
#pragma unroll 1
    for (int q = 0; q < chunks; ++q) {
      const int w = 4 * q;
      reinterpret_cast<uint4*>(go)[q] =
          make_uint4(s[w], s[w + 1], s[w + 2], s[w + 3]);
      reinterpret_cast<uint4*>(gc)[q] =
          make_uint4(sc[w], sc[w + 1], sc[w + 2], sc[w + 3]);
    }
#pragma unroll 1
    for (int w = 4 * chunks; w < words; ++w) {
      go[w] = s[w];
      gc[w] = sc[w];
    }
  }
};

// k2_backbone_bb, the bb wire in one kernel: the lane walk of k2_backbone
// (the forward staged in scratch planes, since the reverse reads it back),
// its blended rows turned into the wire's rows as they come (BbRuns), so
// neither the 36 B blended rows nor a second pass over them reach device
// memory; the blend stores 24 B a residue. Lanes l >= nl_out are pack
// padding: nothing is computed or written for them.
//
// Bound: operations, as k2's (the same walk; ~0.097 ms at B=8192 on an
// H100), with the forward's 36 B a residue written and read back once
// through L2 and the wire's 24 B stored. It takes ~0.36 ms there, against
// ~0.40 for k2_backbone and the second kernel this replaces, k2_bb_out
// (which read the 36 B blended rows back and wrote the 24 B in ~0.127 ms):
// the walk is latency-bound at 80 registers a thread (6 blocks an SM;
// capped at 72 it spills and runs slower), and a run's 16-byte stores
// reach 32 lines a warp store (PERF.md §6).
__global__ void __launch_bounds__(128)
k2_backbone_bb(const uint8_t* __restrict__ recs,
               const float* __restrict__ tails9, const int* __restrict__ prev,
               const float* __restrict__ fwd9,
               const uint8_t* __restrict__ is_first,
               const float* __restrict__ ranc, const int* __restrict__ tat_,
               const float* __restrict__ mins6,
               const float* __restrict__ cont6, const int* __restrict__ order,
               const int* __restrict__ seg_m, int16_t* __restrict__ off,
               float* __restrict__ ca, float* __restrict__ sx,
               float* __restrict__ sy, float* __restrict__ sz, int tails_ld,
               int seg, int nl, int nl_out) {
  __shared__ uint32_t s_run[128 * KB_WORDS];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nl) return;
  const int l = order[i];
  if (l >= nl_out) return;
  const int tat = min(tat_[l], 3 * seg);
  if (tat < 3) return;
  Lane ln;
  lane_init(&ln, recs, mins6, cont6, seg, nl, l);
  V3 a, b, c;
  k2_seed(tails9, prev, fwd9, is_first, tails_ld, nl, l, &a, &b, &c);
  BbRuns out{s_run + threadIdx.x * KB_WORDS, off, ca, seg, l,
             min(seg_m[l], tat / 3)};
  k2_lane(ln, a, b, c, ranc, sx, sy, sz, tat, nl, l, i, out);
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
// Work: one thread per real residue row (lane l < nl_out, row s <
// seg_m[l]); rows s >= seg_m[l] and lanes l >= nl_out are pack padding,
// neither computed nor written (their output rows are left as allocated;
// the host stitch reads none of them). The backbone rows are k2's, where
// k2_backbone left them: lane l's at column pos[l] of the planes, the
// columns in k0's lane order. A persistent grid of a few blocks per SM
// walks groups of K3_TL = 32 neighbouring lanes in pack order, reading
// lane l's rows at pos[l]; each block copies the tables into shared
// memory once. Groups of 32 neighbouring columns in k0's lane order
// (column i taking lane order[i], its backbone reads whole lines) took
// 0.5527 ms at B=8192 on an H100 80GB HBM3 (700 W) against the pack
// order's 0.5307 (0.5894 against 0.5841 summed over the four classes of
// the classed batch; PERF.md §6), so k3 has the pack order's groups only.
// Lanes carry ~25 rows but SEG is the widest lane's (48 at the default
// anchor interval), so a group's rows are split at m, the median of its
// lanes' row counts:
//  - dense steps, rows s < m, K3_TS = 4 rows at a time, one thread per
//    (lane, row), a warp on the 32 lanes of one row: the reads of codes
//    and torsion codes are coalesced, those of the backbone rows nearly
//    so (a protein's interior lanes, of one length, lie in consecutive
//    columns), and each lane's run of up to 4 rows is copied out with
//    16-byte stores when it starts 16-byte aligned (SEG % 4 == 0, as the
//    pack's 8-row bucket gives; 84 * 4 = 336 = 21 * 16), else with 4-byte
//    ones;
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
// Bound: bytes. Per real row 36 B of k2's rows, 4 B of code and 11 B of
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

// Side chain and int16 offsets of row s of lane l, whose backbone rows
// are at column bc of the planes: the thread's atom column `col` (stride
// K3_T) ends up holding the 14 atoms; packed[w] holds offsets 2w and
// 2w + 1, and ca the CA.
__device__ __forceinline__ void k3_row(
    const float* __restrict__ bx, const float* __restrict__ by,
    const float* __restrict__ bz, const int* __restrict__ code,
    const uint8_t* __restrict__ sct, const K3Tables& tab, float* col,
    int bc, int l, int s, int nl, uint32_t* packed, float* ca) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const size_t row = (size_t)(3 * s + a) * nl + bc;
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
             const float* __restrict__ bz, const int* __restrict__ pos,
             const int* __restrict__ code,
             const uint8_t* __restrict__ sct, const int* __restrict__ seg_m,
             int16_t* __restrict__ off, float* __restrict__ ca, int seg,
             int nl, int nl_out) {
  __shared__ K3Tables s_tab;
  // atom columns; between a step's placements and its copy-out, the
  // output stage: int16 [K3_T][42] then float [K3_T][3]
  __shared__ __align__(16) float s_at[K3_ROW * K3_T];
  __shared__ int s_rows[K3_TL];      // rows of each lane of the group
  __shared__ int s_lane[K3_TL];      // the lanes (0 where none)
  __shared__ int s_col[K3_TL];       // their columns of the planes (pos)
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
    const int c0 = grp * K3_TL;  // its first lane
    __syncthreads();  // the previous group's copy-out is done
    if (threadIdx.x < K3_TL) {
      // warp 0: each lane's column and row count, their median m, and
      // the prefix of the rows past m
      const int lane = c0 + threadIdx.x;
      const bool valid = lane < nl_out;
      const int bc = valid ? pos[lane] : 0;
      const int r = valid ? min(seg_m[lane], seg) : 0;
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
      s_lane[threadIdx.x] = valid ? lane : 0;
      s_col[threadIdx.x] = bc;
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
      const int s = s0 + ts;
      const bool real = s < min(s_rows[tl], m);
      __syncthreads();  // the previous step's copy-out is done
      if (real) k3_row(bx, by, bz, code, sct, s_tab, col, s_col[tl],
                       s_lane[tl], s, nl, packed, cav);
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
          int16_t* dst = off + ((size_t)s_lane[lc] * seg + s0) * K3_ROW;
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
                off + ((size_t)s_lane[lc] * seg + s0) * K3_ROW)[j] =
                reinterpret_cast<const uint32_t*>(
                    s_off + lc * K3_TS * K3_ROW)[j];
        }
      }
      for (int i = threadIdx.x; i < K3_TL * K3_TS * 3; i += K3_T) {
        const int lc = i / (K3_TS * 3), j = i - lc * (K3_TS * 3);
        const int n = min(max(min(s_rows[lc], m) - s0, 0), K3_TS);
        if (j < n * 3)
          ca[((size_t)s_lane[lc] * seg + s0) * 3 + j] =
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
      if (real) k3_row(bx, by, bz, code, sct, s_tab, col, s_col[lc],
                       s_lane[lc], s, nl, packed, cav);
      __syncthreads();
      if (real) {
        k3_stage(s_off, s_ca, threadIdx.x, packed, cav);
        s_dst[threadIdx.x] = s_lane[lc] * seg + s;
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

// The grids of one batch's classes (read_classes).
struct ClassGrid {
  int n, bb;
  long long sorts, units, blocks;
};

// Reads one batch's class geometry (fused_decode.py class_layout) into the
// ClassGeom of c[0 .. n): geo holds n (1 .. MAX_CLASSES), bb (1: k0's bb
// mode, no code plane), then 6 ints a class (seg, nl, col0, sort0, unit0,
// block0) in launch order. Every class has lanes and rows, and each of its
// ranges starts where the last class's ends: ceil(nl / K0_SORT_LANES) sort
// blocks and ceil(seg * nl / K0_CODE_UNIT) code units (none in bb mode)
// then nl lane units of k0, ceil(nl / K1_THREADS) blocks of k1 and
// k2_backbone. -> false where that does not hold or a grid passes INT_MAX.
template <class Class>
static bool read_classes(const int* geo, Class* c, ClassGrid* g) {
  *g = ClassGrid{geo[0], geo[1], 0, 0, 0};
  if (g->n < 1 || g->n > MAX_CLASSES || (g->bb != 0 && g->bb != 1))
    return false;
  for (int k = 0; k < g->n; ++k) {
    const int* v = geo + 2 + 6 * k;
    ClassGeom& cl = c[k];
    cl = ClassGeom{v[0], v[1], v[2], v[3], v[4], v[5]};
    if (cl.seg < 1 || cl.nl < 1 || cl.col0 < 0 || cl.sort0 != g->sorts ||
        cl.unit0 != g->units || cl.block0 != g->blocks)
      return false;
    g->sorts += blocks_for(cl.nl, K0_SORT_LANES);
    g->units += (g->bb ? 0
                       : ((long long)cl.seg * cl.nl + K0_CODE_UNIT - 1) /
                             K0_CODE_UNIT) +
                cl.nl;
    g->blocks += blocks_for(cl.nl, K1_THREADS);
  }
  return g->units <= 0x7fffffffLL;
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

// k0 over a batch's classes in one launch (geo: read_classes). ptrs: 9 a
// class (recs, mins_lane, cont_lane, seg_m, then the outputs code, tat,
// mins6, cont6, order; code null in bb mode).
cudaError_t fd_prep(const void* const* ptrs, const int* geo,
                    cudaStream_t stream) {
  K0Table tab = {};
  ClassGrid g;
  if (!read_classes(geo, tab.c, &g)) return cudaErrorInvalidValue;
  for (int k = 0; k < g.n; ++k) {
    const void* const* p = ptrs + 9 * k;
    K0Class& c = tab.c[k];
    c.recs = static_cast<const uint8_t*>(p[0]);
    c.mins_lane = static_cast<const float*>(p[1]);
    c.cont_lane = static_cast<const float*>(p[2]);
    c.seg_m = static_cast<const int*>(p[3]);
    c.code = static_cast<int*>(const_cast<void*>(p[4]));
    c.tat = static_cast<int*>(const_cast<void*>(p[5]));
    c.mins6 = static_cast<float*>(const_cast<void*>(p[6]));
    c.cont6 = static_cast<float*>(const_cast<void*>(p[7]));
    c.order = static_cast<int*>(const_cast<void*>(p[8]));
  }
  tab.n = g.n;
  tab.bb = g.bb;
  tab.sort_blocks = (int)g.sorts;
  tab.units = (int)g.units;
  k0_prep<<<(unsigned)g.sorts + blocks_for((size_t)g.units, K0_THREADS),
            K0_THREADS, 0, stream>>>(tab);
  return cudaGetLastError();
}

// k1 over a batch's classes in one launch (geo: read_classes). ptrs: 7 a
// class (recs, seed, ranc, tat, mins6, cont6, order); out [9, *] with row
// stride out_ld.
cudaError_t fd_tails(const void* const* ptrs, const int* geo, float* out,
                     int out_ld, cudaStream_t stream) {
  K1Table tab = {};
  ClassGrid g;
  if (!read_classes(geo, tab.c, &g)) return cudaErrorInvalidValue;
  for (int k = 0; k < g.n; ++k) {
    const void* const* p = ptrs + 7 * k;
    K1Class& c = tab.c[k];
    c.recs = static_cast<const uint8_t*>(p[0]);
    c.seed = static_cast<const float*>(p[1]);
    c.ranc = static_cast<const float*>(p[2]);
    c.tat = static_cast<const int*>(p[3]);
    c.mins6 = static_cast<const float*>(p[4]);
    c.cont6 = static_cast<const float*>(p[5]);
    c.order = static_cast<const int*>(p[6]);
  }
  tab.n = g.n;
  k1_tails<<<(unsigned)g.blocks, K1_THREADS, 0, stream>>>(tab, out, out_ld);
  return cudaGetLastError();
}

// k2 over a batch's classes in one launch of k2_backbone (geo:
// read_classes). ptrs: 13 a class (recs, fwd9, is_first, ranc, tat, mins6,
// cont6, order, prev, then the outputs sx, sy, sz [3*SEG, NL] float, lane
// l's rows at column pos[l], and pos [NL] int). tails9 null: the seeds are
// fwd9 (refine_iters 1); else [9, tails_ld], read at column prev[l] (prev
// given) or l-1 (prev null, one class, tails_ld = NL).
cudaError_t fd_backbone(const void* const* ptrs, const int* geo,
                        const float* tails9, int tails_ld,
                        cudaStream_t stream) {
  K2Table tab = {};
  ClassGrid g;
  if (!read_classes(geo, tab.c, &g)) return cudaErrorInvalidValue;
  for (int k = 0; k < g.n; ++k) {
    const void* const* p = ptrs + 13 * k;
    K2Class& c = tab.c[k];
    c.recs = static_cast<const uint8_t*>(p[0]);
    c.fwd9 = static_cast<const float*>(p[1]);
    c.is_first = static_cast<const uint8_t*>(p[2]);
    c.ranc = static_cast<const float*>(p[3]);
    c.tat = static_cast<const int*>(p[4]);
    c.mins6 = static_cast<const float*>(p[5]);
    c.cont6 = static_cast<const float*>(p[6]);
    c.order = static_cast<const int*>(p[7]);
    c.prev = static_cast<const int*>(p[8]);
    c.sx = static_cast<float*>(const_cast<void*>(p[9]));
    c.sy = static_cast<float*>(const_cast<void*>(p[10]));
    c.sz = static_cast<float*>(const_cast<void*>(p[11]));
    c.pos = static_cast<int*>(const_cast<void*>(p[12]));
  }
  tab.tails9 = tails9;
  tab.tails_ld = tails_ld;
  tab.n = g.n;
  k2_backbone<<<(unsigned)g.blocks, K2_THREADS, 0, stream>>>(tab);
  return cudaGetLastError();
}

// The bb wire in one launch of k2_backbone_bb: off [NL_out, SEG, 6]
// int16, ca [NL_out, SEG, 3] float; sx, sy, sz: [3*SEG, NL] float scratch
// planes for the forward rows. tails9 null: the seeds are fwd9; else [9,
// tails_ld], read at column prev[l] (prev given) or l-1 (prev null,
// tails_ld = NL).
cudaError_t fd_backbone_bb(const uint8_t* recs, const float* tails9,
                           const int* prev, const float* fwd9,
                           const uint8_t* is_first, const float* ranc,
                           const int* tat, const float* mins6,
                           const float* cont6, const int* order,
                           const int* seg_m, int16_t* off, float* ca,
                           float* sx, float* sy, float* sz, int tails_ld,
                           int seg, int nl, int nl_out,
                           cudaStream_t stream) {
  k2_backbone_bb<<<blocks_for(nl, 128), 128, 0, stream>>>(
      recs, tails9, prev, fwd9, is_first, ranc, tat, mins6, cont6, order,
      seg_m, off, ca, sx, sy, sz, tails_ld, seg, nl, nl_out);
  return cudaGetLastError();
}

// k3 on a persistent grid: as many blocks as fit on the device at once,
// at most one per group of 32 lanes. bx, by, bz: [3*SEG, NL] float, lane
// l's rows at column pos[l] (k2's staged rows); off [NL_out, SEG, 42]
// int16, ca [NL_out, SEG, 3] float.
cudaError_t fd_sidechain(const float* bx, const float* by, const float* bz,
                         const int* pos, const int* code,
                         const uint8_t* sct, const int* seg_m, int16_t* off,
                         float* ca, int seg, int nl, int nl_out,
                         cudaStream_t stream) {
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
                 stream>>>(bx, by, bz, pos, code, sct, seg_m, off, ca,
                           seg, nl, nl_out);
  return cudaGetLastError();
}

}  // extern "C"
