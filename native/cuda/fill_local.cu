// Mode-1 (local POA) fill for NVIDIA GPUs, called from JAX through the
// XLA FFI.  Same recurrence, tie rules and outputs as the XLA scan
// engine recgraph_tpu/ops/poa_engine.py:_fill_local, which is its
// reference (tests compare the two exactly):
//
//   d[j] = max_p m_p[j-1] (start rows: floored at 0) + sm(seq[j], lnz[i])
//   u[j] = max_p m_p[j]   (start rows: floored at 0) + sm('-', lnz[i])
//   A[j] = max(d[j], u[j], 0),  A[0] = 0
//   m[j] = max(A[j], m[j-1] + sm(seq[j], '-'))
//
// One thread block per read; threads own C consecutive columns; the
// block loops over the graph rows itself.  The in-row dependency is a
// (max,+) prefix scan: each column is the map x -> max(a, x + g), maps
// compose associatively, and the block scans them serially inside a
// thread, with warp shuffles across a warp and through shared memory
// across warps.  Predecessors of node-start rows are node ends; their
// rows live in a shared-memory ring indexed by end rank (slot =
// rank % ring), sized by the graph's compact span, and in device memory
// for graphs whose span does not fit (use_global).  Non-start rows read
// the previous row.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC -I <jax.ffi.include_dir()>

#include <cstdint>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int32_t NEG = -(1 << 28);   // poa_engine.NEG
constexpr int32_t IDA = -(1 << 30);   // identity "a" of the (max,+) maps
constexpr int kAlpha = 7;             // scoring table is int32[7, 7]
constexpr int kGap = 5;               // scoring.GAP
constexpr int kN = 4;                 // scoring.N (read padding)
// direction codes of poa_engine._DIRS
constexpr int32_t O_DIR = 0, D_DIR = 1, LOW_D = 2, L_DIR = 3, U_DIR = 4;

struct Params {
  const int32_t* seq;        // [B, Lp]
  const int32_t* len;        // [B]
  const int32_t* table;      // [7, 7]
  const int32_t* codes;      // [n]
  const int32_t* node_start; // [n]
  const int32_t* pred_idx;   // [n, Pm], -1 padded
  const int32_t* pred_rank;  // [n, Pm]
  const int32_t* erank;      // [n], -1 for rows that are no node end
  int32_t* best_val;         // [B]
  int32_t* best_i;           // [B]
  int32_t* best_j;           // [B]
  int32_t* packed;           // [B, n, Lp]
  int32_t* ends;             // [B, n_ends, Lp] when use_global
  int n, pm, lp, lpad, ring, n_ends, use_global;
};

// (a, g) <- the map "(pa, pg), then (a, g)":
//   x -> max(a, max(pa, x + pg) + g)
__device__ __forceinline__ void compose(int32_t& a, int32_t& g, int32_t pa,
                                        int32_t pg) {
  a = max(a, pa + g);
  g = pg + g;
}

template <int C>
__global__ void fill_local_kernel(Params p) {
  extern __shared__ int32_t smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int lp = p.lp, lpad = p.lpad, n = p.n;

  int32_t* tab = smem;                       // [49]
  int32_t* wtot = tab + kAlpha * kAlpha + 1;  // [2 * 32] warp totals
  int32_t* rows = wtot + 64;                 // [2 + ring, lpad]
  int32_t* buf0 = rows;
  int32_t* buf1 = rows + lpad;
  int32_t* ringb = rows + 2 * lpad;

  for (int k = tid; k < kAlpha * kAlpha; k += blockDim.x) tab[k] = p.table[k];

  const int j0 = tid * C;
  const int L = p.len[b];
  int32_t sq[C], gs[C];
  for (int c = 0; c < C; ++c) {
    const int j = j0 + c;
    sq[c] = j < lp ? p.seq[(int64_t)b * lp + j] : kN;
  }
  __syncthreads();
  for (int c = 0; c < C; ++c) gs[c] = tab[sq[c] * kAlpha + kGap];

  // row 0: all zeros, packed 0; it is end rank 0
  int32_t* pk = p.packed + (int64_t)b * n * lp;
  int32_t* ends = p.ends + (int64_t)b * p.n_ends * lp;
  for (int c = 0; c < C; ++c) {
    const int j = j0 + c;
    buf0[j] = 0;
    ringb[j] = 0;  // slot 0 % ring
    if (j < lp) {
      pk[j] = 0;
      pk[(int64_t)(n - 1) * lp + j] = 0;
      if (p.use_global) ends[j] = 0;
    }
  }
  int32_t tb_val = 0, tb_i = 0, tb_j = 0;
  int ends_seen = 1;  // end rows written so far (row 0)
  int32_t* prev = buf0;
  int32_t* cur = buf1;
  __syncthreads();

  for (int i = 1; i < n - 1; ++i) {
    const int code = p.codes[i];
    const bool start = p.node_start[i] != 0;
    const int32_t gnode = tab[kGap * kAlpha + code];
    int32_t dv[C], uv[C], di[C], ui[C], A[C];

    if (!start) {
      for (int c = 0; c < C; ++c) {
        const int j = j0 + c;
        const int32_t dpre = j > 0 ? prev[j - 1] : NEG;
        dv[c] = dpre + tab[sq[c] * kAlpha + code];
        uv[c] = prev[j] + gnode;
        di[c] = ui[c] = i - 1;
      }
    } else {
      int32_t dpre[C], upre[C], darg[C], uarg[C];
      for (int c = 0; c < C; ++c) {
        dpre[c] = upre[c] = NEG - 1;
        darg[c] = uarg[c] = 0;
      }
      const int32_t* pidx = p.pred_idx + (int64_t)i * p.pm;
      const int32_t* prk = p.pred_rank + (int64_t)i * p.pm;
      for (int k = 0; k < p.pm; ++k) {
        const int pr = pidx[k];
        if (pr < 0) continue;
        const int rk = prk[k];
        // ring rows are lpad wide; rows in device memory lp wide
        const bool in_ring = ends_seen - 1 - rk < p.ring;
        const int32_t* src = in_ring ? ringb + (int64_t)(rk % p.ring) * lpad
                                     : ends + (int64_t)rk * lp;
        const int width = in_ring ? lpad : lp;
        for (int c = 0; c < C; ++c) {
          const int j = j0 + c;
          const int32_t uval = j < width ? src[j] : NEG;
          const int32_t dval = (j == 0 || j - 1 >= width) ? NEG : src[j - 1];
          // first max over ascending predecessors (argmax tie rule)
          if (dval > dpre[c]) { dpre[c] = dval; darg[c] = pr; }
          if (uval > upre[c]) { upre[c] = uval; uarg[c] = pr; }
        }
      }
      for (int c = 0; c < C; ++c) {
        dv[c] = max(dpre[c], 0) + tab[sq[c] * kAlpha + code];
        di[c] = dpre[c] > 0 ? darg[c] : 0;
        uv[c] = max(upre[c], 0) + gnode;
        ui[c] = upre[c] > 0 ? uarg[c] : 0;
      }
    }

    // (max,+) scan of x -> max(A[j], x + gs[j]) over the row
    int32_t ta = IDA, tg = 0;
    for (int c = 0; c < C; ++c) {
      A[c] = (j0 + c == 0) ? 0 : max(max(dv[c], uv[c]), 0);
      int32_t a = A[c], g = gs[c];
      compose(a, g, ta, tg);
      ta = a;
      tg = g;
    }
    int32_t wa = ta, wg = tg;
    for (int off = 1; off < 32; off <<= 1) {
      const int32_t pa = __shfl_up_sync(0xffffffffu, wa, off);
      const int32_t pg = __shfl_up_sync(0xffffffffu, wg, off);
      if (lane >= off) compose(wa, wg, pa, pg);
    }
    if (lane == 31) {
      wtot[2 * warp] = wa;
      wtot[2 * warp + 1] = wg;
    }
    // exclusive prefix within the warp
    int32_t ea = __shfl_up_sync(0xffffffffu, wa, 1);
    int32_t eg = __shfl_up_sync(0xffffffffu, wg, 1);
    if (lane == 0) { ea = IDA; eg = 0; }
    __syncthreads();
    int32_t xa = IDA, xg = 0;
    for (int w = 0; w < warp; ++w) {
      int32_t a = wtot[2 * w], g = wtot[2 * w + 1];
      compose(a, g, xa, xg);
      xa = a;
      xg = g;
    }
    compose(ea, eg, xa, xg);
    // ea is m[j0 - 1] (IDA before column 0)
    int32_t x = ea;
    int32_t m[C];
    for (int c = 0; c < C; ++c) {
      const int j = j0 + c;
      x = max(A[c], x + gs[c]);
      int32_t v = j < L ? x : NEG;
      if (j == 0) v = 0;
      m[c] = v;
      cur[j] = v;
    }
    __syncthreads();

    int32_t* pkr = pk + (int64_t)i * lp;
    const bool is_end = p.erank[i] >= 0;
    int32_t* rslot = ringb + (int64_t)(ends_seen % p.ring) * lpad;
    for (int c = 0; c < C; ++c) {
      const int j = j0 + c;
      const int32_t lv = (j > 0 ? cur[j - 1] : NEG) + gs[c];
      const bool valid = j < L;
      int32_t dcode, pred;
      if (j == 0 || !valid ||
          (dv[c] < 0 && uv[c] < 0 && lv < 0)) {
        dcode = O_DIR;
        pred = 0;
      } else if (dv[c] >= uv[c] && dv[c] >= lv) {
        dcode = sq[c] == code ? D_DIR : LOW_D;
        pred = di[c];
      } else if (dv[c] < uv[c] && uv[c] >= lv) {
        dcode = U_DIR;
        pred = ui[c];
      } else {
        dcode = L_DIR;
        pred = i;
      }
      if (j < lp) pkr[j] = pred * 16 + dcode;
      // running best, strict > in row-major order (per thread; the
      // block reduction below restores the global order)
      const int32_t rv = valid ? m[c] : NEG;
      if (rv > tb_val) { tb_val = rv; tb_i = i; tb_j = j; }
      if (is_end) {
        rslot[j] = m[c];
        if (p.use_global && j < lp)
          ends[(int64_t)ends_seen * lp + j] = m[c];
      }
    }
    if (is_end) ++ends_seen;
    int32_t* t = prev;
    prev = cur;
    cur = t;
    __syncthreads();
  }

  // block reduction of the per-thread bests: max value, then the
  // earliest row, then the earliest column
  for (int off = 16; off > 0; off >>= 1) {
    const int32_t ov = __shfl_down_sync(0xffffffffu, tb_val, off);
    const int32_t oi = __shfl_down_sync(0xffffffffu, tb_i, off);
    const int32_t oj = __shfl_down_sync(0xffffffffu, tb_j, off);
    if (ov > tb_val || (ov == tb_val && (oi < tb_i || (oi == tb_i && oj < tb_j)))) {
      tb_val = ov; tb_i = oi; tb_j = oj;
    }
  }
  int32_t* red = rows;  // row buffers are free now
  if (lane == 0) {
    red[3 * warp] = tb_val;
    red[3 * warp + 1] = tb_i;
    red[3 * warp + 2] = tb_j;
  }
  __syncthreads();
  if (tid == 0) {
    int32_t bv = red[0], bi = red[1], bj = red[2];
    for (int w = 1; w < nwarps; ++w) {
      const int32_t ov = red[3 * w], oi = red[3 * w + 1], oj = red[3 * w + 2];
      if (ov > bv || (ov == bv && (oi < bi || (oi == bi && oj < bj)))) {
        bv = ov; bi = oi; bj = oj;
      }
    }
    p.best_val[b] = bv;
    p.best_i[b] = bi;
    p.best_j[b] = bj;
  }
}

template <int C>
cudaError_t launch(const Params& p, int threads, size_t smem_bytes,
                   int blocks, cudaStream_t stream) {
  auto* k = fill_local_kernel<C>;
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  if (err != cudaSuccess) return err;
  k<<<blocks, threads, smem_bytes, stream>>>(p);
  return cudaGetLastError();
}

ffi::Error FillLocalImpl(cudaStream_t stream, ffi::Buffer<ffi::S32> seq,
                         ffi::Buffer<ffi::S32> len,
                         ffi::Buffer<ffi::S32> table,
                         ffi::Buffer<ffi::S32> codes,
                         ffi::Buffer<ffi::S32> node_start,
                         ffi::Buffer<ffi::S32> pred_idx,
                         ffi::Buffer<ffi::S32> pred_rank,
                         ffi::Buffer<ffi::S32> erank,
                         ffi::ResultBuffer<ffi::S32> best_val,
                         ffi::ResultBuffer<ffi::S32> best_i,
                         ffi::ResultBuffer<ffi::S32> best_j,
                         ffi::ResultBuffer<ffi::S32> packed,
                         ffi::ResultBuffer<ffi::S32> ends, int64_t cols,
                         int64_t threads, int64_t ring, int64_t use_global) {
  auto sd = seq.dimensions();
  auto pd = pred_idx.dimensions();
  auto ed = ends->dimensions();
  if (sd.size() != 2 || pd.size() != 2 || ed.size() != 3)
    return ffi::Error::InvalidArgument("fill_local: bad operand ranks");
  if (table.element_count() != kAlpha * kAlpha)
    return ffi::Error::InvalidArgument("fill_local: table must be 7x7");
  Params p;
  p.seq = seq.typed_data();
  p.len = len.typed_data();
  p.table = table.typed_data();
  p.codes = codes.typed_data();
  p.node_start = node_start.typed_data();
  p.pred_idx = pred_idx.typed_data();
  p.pred_rank = pred_rank.typed_data();
  p.erank = erank.typed_data();
  p.best_val = best_val->typed_data();
  p.best_i = best_i->typed_data();
  p.best_j = best_j->typed_data();
  p.packed = packed->typed_data();
  p.ends = ends->typed_data();
  const int B = (int)sd[0];
  p.lp = (int)sd[1];
  p.n = (int)pd[0];
  p.pm = (int)pd[1];
  p.lpad = (int)(cols * threads);
  p.ring = (int)ring;
  p.n_ends = (int)ed[1];
  p.use_global = (int)use_global;
  if (p.lpad < p.lp || threads % 32 || threads > 1024 || ring < 1)
    return ffi::Error::InvalidArgument("fill_local: bad launch plan");
  if (B == 0) return ffi::Error::Success();
  const size_t smem =
      sizeof(int32_t) * ((size_t)kAlpha * kAlpha + 1 + 64 +
                         (size_t)(2 + ring) * p.lpad);
  cudaError_t err;
  switch (cols) {
    case 1: err = launch<1>(p, (int)threads, smem, B, stream); break;
    case 2: err = launch<2>(p, (int)threads, smem, B, stream); break;
    case 4: err = launch<4>(p, (int)threads, smem, B, stream); break;
    case 8: err = launch<8>(p, (int)threads, smem, B, stream); break;
    case 16: err = launch<16>(p, (int)threads, smem, B, stream); break;
    default:
      return ffi::Error::InvalidArgument("fill_local: cols not in 1..16");
  }
  if (err != cudaSuccess)
    return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    RecgraphFillLocal, FillLocalImpl,
    ffi::Ffi::Bind()
        .Ctx<ffi::PlatformStream<cudaStream_t>>()
        .Arg<ffi::Buffer<ffi::S32>>()  // seq
        .Arg<ffi::Buffer<ffi::S32>>()  // len
        .Arg<ffi::Buffer<ffi::S32>>()  // table
        .Arg<ffi::Buffer<ffi::S32>>()  // codes
        .Arg<ffi::Buffer<ffi::S32>>()  // node_start
        .Arg<ffi::Buffer<ffi::S32>>()  // pred_idx
        .Arg<ffi::Buffer<ffi::S32>>()  // pred_rank
        .Arg<ffi::Buffer<ffi::S32>>()  // erank
        .Ret<ffi::Buffer<ffi::S32>>()  // best_val
        .Ret<ffi::Buffer<ffi::S32>>()  // best_i
        .Ret<ffi::Buffer<ffi::S32>>()  // best_j
        .Ret<ffi::Buffer<ffi::S32>>()  // packed
        .Ret<ffi::Buffer<ffi::S32>>()  // ends (scratch)
        .Attr<int64_t>("cols")
        .Attr<int64_t>("threads")
        .Attr<int64_t>("ring")
        .Attr<int64_t>("use_global"));
