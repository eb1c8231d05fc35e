// Wrap-around DP, counts mode, on an NVIDIA Hopper card: one warp per job.
//
// Computes, in one pass over the rows, what mtr/ops/wrap_dp_xla.py
// computes: the fill of wrap_around_DP.c:222-354 plus the exact move
// counts of its traceback (precedence match > mismatch > deletion >
// insertion), carried forward as per-cell aux values (matches,
// insertions, start row) so no move tensor is ever stored.  Output rows
// have the (B, 15) int32 layout of the XLA engine.
//
// Layout: the unit is RIGHT-aligned over 32*V columns, lane L holding
// columns L*V .. L*V+V-1 in registers.  The last unit column is then
// always lane 31's last register, so the wrap column (D[i][0] =
// D[i][unit_len]) is one broadcast shuffle.  A job's whole row stays in
// registers for the entire loop, and each warp runs exactly its own
// job's rows.
//
// Per row:
//   * the deletion chain v[j] = max(m[j], v[j-1] - ip), broken at match
//     cells and at the first column, is a segmented prefix max of
//     m[j] + ip*j: sequential inside a lane, Kogge-Stone across lanes;
//   * deletion cells take the aux values of their nearest non-deletion
//     cell to the left (circularly, through the wrap column): a
//     copy-forward inside the lane, and one shuffle from the lane that
//     __ballot_sync names across lanes;
//   * each thread keeps its own first maximum in row-major order; a
//     warp reduction at the end resolves (max value, min row, min col).
//
// Everything is int32 integer arithmetic: results equal the oracle
// exactly.
//
// Build (needs only the CUDA toolkit and JAX's FFI headers):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -I "$(python -c 'import jax.ffi; \
//        print(jax.ffi.include_dir())')" -o native/build/libmtr_wrap_dp_cuda.so \
//        native/wrap_dp_counts.cu
// mtr/ops/wrap_dp_cuda.py runs this at first use.

#include <cstdint>
#include <string>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int NEG = -(1 << 30);
constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 4;  // warps (jobs) per block
constexpr int OUT_COLS = 15;

template <int V>
__global__ void __launch_bounds__(WARPS * 32)
wrap_dp_counts_kernel(const int8_t* __restrict__ flat, int64_t n_flat,
                      const int32_t* __restrict__ starts,
                      const int32_t* __restrict__ scal,
                      const int8_t* __restrict__ unit, int u_stride,
                      int32_t* __restrict__ out, int n_jobs) {
  constexpr int NW = (V + 3) / 4;
  const int lane = threadIdx.x & 31;
  const int job = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (job >= n_jobs) return;  // uniform across the warp

  const int32_t* sc = scal + (int64_t)job * 8;
  const int rep_len = sc[0];
  const int unit_len = sc[1];
  const int mg = sc[2], mp = sc[3], ip = sc[4];
  const int64_t start = starts[job];
  const int off = 32 * V - unit_len;  // column of the first unit base

  // unit codes packed 4 per word; 0xfe on padding never matches a base
  uint32_t uw[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) uw[w] = 0;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int ui = lane * V + k - off;
    const uint32_t code =
        ui >= 0 ? (uint32_t)(uint8_t)unit[(int64_t)job * u_stride + ui]
                : 0xfeu;
    uw[k >> 2] |= code << (8 * (k & 3));
  }

  int pv[V], am[V], ai[V], as[V], t[V];
#pragma unroll
  for (int k = 0; k < V; ++k) pv[k] = am[k] = ai[k] = as[k] = 0;
  int bv = 0, bi = 0, bc = 0, bm = 0, bn = 0, bs = 0;

  uint32_t rw = 0;
  for (int r = 0; r < rep_len; ++r) {
    if ((r & 127) == 0) {
      // the warp stages the next 128 read bases, 4 per lane
      uint32_t w = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int64_t idx = start + r + lane * 4 + q;
        const uint32_t b = idx < n_flat ? (uint32_t)(uint8_t)flat[idx] : 0xffu;
        w |= b << (8 * q);
      }
      rw = w;
    }
    const uint32_t word = __shfl_sync(FULL, rw, (r & 127) >> 2);
    const uint32_t rc = (word >> (8 * (r & 3))) & 0xffu;
    const int i = r + 1;

    // previous-row neighbours: left lane's last column, and the wrap
    // column (lane 31's last register) for the first unit column
    const int pl = __shfl_up_sync(FULL, pv[V - 1], 1);
    const int aml = __shfl_up_sync(FULL, am[V - 1], 1);
    const int ail = __shfl_up_sync(FULL, ai[V - 1], 1);
    const int asl = __shfl_up_sync(FULL, as[V - 1], 1);
    const int pw = __shfl_sync(FULL, pv[V - 1], 31);
    const int amw = __shfl_sync(FULL, am[V - 1], 31);
    const int aiw = __shfl_sync(FULL, ai[V - 1], 31);
    const int asw = __shfl_sync(FULL, as[V - 1], 31);

    // 1. match / mismatch / insertion candidates; pv becomes diag - mp
    uint32_t mi_bits = 0;
#pragma unroll
    for (int k = V - 1; k >= 0; --k) {
      const int c = lane * V + k;
      int d = k > 0 ? pv[k - 1] : pl;
      d = c == off ? pw : d;
      const bool mi = ((uw[k >> 2] >> (8 * (k & 3))) & 0xffu) == rc;
      const int dmp = d - mp;
      const int mnm = max(0, max(dmp, pv[k] - ip));
      const int m = mi ? d + mg : mnm;
      t[k] = c < off ? NEG : m + ip * (c - off);
      pv[k] = dmp;
      mi_bits |= (uint32_t)mi << k;
    }

    // 2. deletion chain: segmented prefix max; segments start at match
    //    cells, at the first unit column and on padding
    bool lane_flag = false;
    int run = NEG;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const bool f = ((mi_bits >> k) & 1u) || lane * V + k <= off;
      run = f ? t[k] : max(run, t[k]);
      t[k] = run;
      lane_flag = lane_flag || f;
    }
    int v = run;
    int fl = lane_flag;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const int vr = __shfl_up_sync(FULL, v, s);
      const int fr = __shfl_up_sync(FULL, fl, s);
      if (lane >= s) {
        if (!fl) v = max(v, vr);
        fl |= fr;
      }
    }
    int carry = __shfl_up_sync(FULL, v, 1);
    if (lane == 0) carry = NEG;
    bool open = true;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int c = lane * V + k;
      open = open && !(((mi_bits >> k) & 1u) || c <= off);
      const int tv = open ? max(t[k], carry) : t[k];
      t[k] = c < off ? 0 : tv - ip * (c - off);  // t now holds the row
    }

    // 3. traceback class of every cell (running-score equality tests)
    const int rl = __shfl_up_sync(FULL, t[V - 1], 1);
    const int rwv = __shfl_sync(FULL, t[V - 1], 31);
    uint32_t del_bits = 0, diag_bits = 0, pos_bits = 0;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int c = lane * V + k;
      const int row = t[k];
      const bool mi = (mi_bits >> k) & 1u;
      const bool pos = row > 0;
      const bool e2v = row == pv[k];
      int left = k > 0 ? t[k - 1] : rl;
      left = c == off ? rwv : left;
      const bool e3v = row == left - ip;
      const bool sx = !mi && e2v && pos;
      const bool sd = pos && !mi && !e2v && e3v;
      diag_bits |= (uint32_t)(mi || sx) << k;
      del_bits |= (uint32_t)sd << k;
      pos_bits |= (uint32_t)pos << k;
    }

    // 4. aux values from the diagonal / upper predecessor (in place,
    //    right to left so the previous row's left neighbour survives)
#pragma unroll
    for (int k = V - 1; k >= 0; --k) {
      const int c = lane * V + k;
      int dm = k > 0 ? am[k - 1] : aml;
      int di = k > 0 ? ai[k - 1] : ail;
      int ds = k > 0 ? as[k - 1] : asl;
      if (c == off) {
        dm = amw;
        di = aiw;
        ds = asw;
      }
      const bool sdg = (diag_bits >> k) & 1u;
      const bool pos = (pos_bits >> k) & 1u;
      const int mi = (mi_bits >> k) & 1u;
      am[k] = sdg ? dm + mi : (pos ? am[k] : 0);
      ai[k] = sdg ? di : (pos ? ai[k] + 1 : 0);
      as[k] = sdg ? ds : (pos ? as[k] : i);
    }

    // 5. deletion cells copy their origin's aux values forward
    bool has = false;
    int cm = 0, ci = 0, cs = 0;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const bool org = lane * V + k >= off && !((del_bits >> k) & 1u);
      if (org) {
        has = true;
        cm = am[k];
        ci = ai[k];
        cs = as[k];
      } else if (has) {
        am[k] = cm;
        ai[k] = ci;
        as[k] = cs;
      }
    }
    // the nearest lane to the left holding an origin; with none, the
    // chain wraps to the origin of the last column (a row always has
    // an origin: an all-deletion row would lose ip per step round a
    // cycle)
    const uint32_t omask = __ballot_sync(FULL, has);
    const uint32_t below = omask & ((1u << lane) - 1u);
    const int src = below ? 31 - __clz(below)
                          : (omask ? 31 - __clz(omask) : 31);
    const int pm = __shfl_sync(FULL, cm, src);
    const int pi = __shfl_sync(FULL, ci, src);
    const int ps = __shfl_sync(FULL, cs, src);
    bool seen = false;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      seen = seen || (lane * V + k >= off && !((del_bits >> k) & 1u));
      if (!seen) {
        am[k] = pm;
        ai[k] = pi;
        as[k] = ps;
      }
    }

    // 6. running first maximum in row-major order
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if (t[k] > bv) {
        bv = t[k];
        bi = i;
        bc = lane * V + k;
        bm = am[k];
        bn = ai[k];
        bs = as[k];
      }
      pv[k] = t[k];
    }
  }

  // (max value, min row, min column) across the warp
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const int ov = __shfl_xor_sync(FULL, bv, s);
    const int oi = __shfl_xor_sync(FULL, bi, s);
    const int oc = __shfl_xor_sync(FULL, bc, s);
    const int om = __shfl_xor_sync(FULL, bm, s);
    const int on = __shfl_xor_sync(FULL, bn, s);
    const int os = __shfl_xor_sync(FULL, bs, s);
    const bool better =
        ov > bv || (ov == bv && (oi < bi || (oi == bi && oc < bc)));
    if (better) {
      bv = ov;
      bi = oi;
      bc = oc;
      bm = om;
      bn = on;
      bs = os;
    }
  }
  if (lane != 0) return;
  const bool found = bv > 0;
  const int max_i = found ? bi : 0;
  const int max_j = found ? bc - off + 1 : 0;
  const int m = found ? bm : 0;
  const int ins = found ? bn : 0;
  const int si = found ? bs : 0;
  const int x = max_i - si - m - ins;
  const int dl = (m * mg - x * mp - bv - ins * ip) / ip;
  int32_t* o = out + (int64_t)job * OUT_COLS;
  o[0] = m;
  o[1] = x;
  o[2] = ins;
  o[3] = dl;
  o[4] = m + x + dl;
  o[5] = si;
  o[6] = 1;
  o[7] = 0;
  o[8] = bv;
  o[9] = max_i;
  o[10] = max_j;
  o[11] = m;
  o[12] = ins;
  o[13] = si;
  o[14] = 0;
}

template <int V>
cudaError_t launch(cudaStream_t stream, const int8_t* flat, int64_t n_flat,
                   const int32_t* starts, const int32_t* scal,
                   const int8_t* unit, int u_stride, int32_t* out,
                   int n_jobs) {
  const int blocks = (n_jobs + WARPS - 1) / WARPS;
  wrap_dp_counts_kernel<V><<<blocks, WARPS * 32, 0, stream>>>(
      flat, n_flat, starts, scal, unit, u_stride, out, n_jobs);
  return cudaGetLastError();
}

ffi::Error WrapDpCounts(cudaStream_t stream, ffi::Buffer<ffi::S8> flat,
                        ffi::Buffer<ffi::S32> starts,
                        ffi::Buffer<ffi::S32> scal,
                        ffi::Buffer<ffi::S8> unit,
                        ffi::ResultBuffer<ffi::S32> out) {
  const auto ud = unit.dimensions();
  const auto sd = scal.dimensions();
  const auto od = out->dimensions();
  if (ud.size() != 2 || sd.size() != 2 || od.size() != 2 || sd[1] != 8 ||
      od[1] != OUT_COLS || sd[0] != ud[0] || od[0] != ud[0] ||
      (int64_t)starts.element_count() != ud[0]) {
    return ffi::Error::InvalidArgument("wrap_dp_counts: bad shapes");
  }
  const int n_jobs = (int)ud[0];
  const int u_pad = (int)ud[1];
  if (n_jobs == 0) return ffi::Error::Success();
  const int8_t* f = flat.typed_data();
  const int64_t nf = (int64_t)flat.element_count();
  const int32_t* st = starts.typed_data();
  const int32_t* s = scal.typed_data();
  const int8_t* u = unit.typed_data();
  int32_t* o = out->typed_data();
  cudaError_t err;
  if (u_pad <= 32) {
    err = launch<1>(stream, f, nf, st, s, u, u_pad, o, n_jobs);
  } else if (u_pad <= 64) {
    err = launch<2>(stream, f, nf, st, s, u, u_pad, o, n_jobs);
  } else if (u_pad <= 128) {
    err = launch<4>(stream, f, nf, st, s, u, u_pad, o, n_jobs);
  } else if (u_pad <= 256) {
    err = launch<8>(stream, f, nf, st, s, u, u_pad, o, n_jobs);
  } else if (u_pad <= 512) {
    err = launch<16>(stream, f, nf, st, s, u, u_pad, o, n_jobs);
  } else {
    return ffi::Error::InvalidArgument("wrap_dp_counts: unit pad > 512");
  }
  if (err != cudaSuccess) {
    return ffi::Error::Internal(std::string("wrap_dp_counts launch: ") +
                                cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(MtrWrapDpCounts, WrapDpCounts,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::S8>>()   // flat
                                  .Arg<ffi::Buffer<ffi::S32>>()  // starts
                                  .Arg<ffi::Buffer<ffi::S32>>()  // scal
                                  .Arg<ffi::Buffer<ffi::S8>>()   // unit
                                  .Ret<ffi::Buffer<ffi::S32>>());
