// Tile-sort slot emission: per-splat table -> (u32 key as int64, 10 payload
// rows) per slot.
//
// Replaces brush_tpu/ops/emit_pallas.py:133 `_emit_kernel`, reached through
// `emit_slots`. The slot layout is that of the reference package's jnp
// emission (brush_tpu/ops/tiling.py `_emit_jnp`): a dense k-major region
// [k0, N] (slot k*N + g is splat g's k-th emitted tile) followed by a
// remainder region [rem_cap] of the later slots of large splats; remainder
// slot r belongs to the last splat g with rem_starts[g] <= r. The TPU
// kernel finds a remainder slot's owner with a windowed one-hot matmul and
// carries the key as two u16 limbs (a TPU copy may canonicalise NaN bit
// patterns); here the key is written as an int64 holding the u32 value and
// words move as raw bits.
//
// Table rows (f32 words, row r at table + r * stride):
//   0..8 payload xy(2) conic(3) opac rgb(3); 9 gid; 10 depth bit pattern;
//   11,12 tile_min x,y; 13 bbox width (>= 1); 14 exact emission count;
//   15,16 hit-mask limbs (lo16, hi16); 17 rem_starts (int32 bit pattern).
// Output: key[s] = tile << (32 - tile_bits) | depth_bits >> tile_bits, with
// tile = num_tiles (the sentinel) for unused slots, and rows_out[r, s] the
// owner's table row r for r < 10.
//
// Bound on the H100: bytes -- the table is read once (18 * N * 4 bytes) and
// every slot writes 8 + 40 bytes. One launch, two kinds of block:
//   * Remainder blocks take kRemSlots consecutive remainder slots each, as
//     csrc/expand.cu does: two warps find the owners of the block's first
//     and last slot in global memory, the block stages that owner range's
//     rem_starts in shared memory, and each thread finds the owner of each
//     of its 4-slot groups there. A range longer than kWindow owners (runs
//     of splats without remainder slots, such as the dead half of the
//     loop's capacity, all at one start) is searched in global memory
//     instead, once a group. The owner's table words are read once a run
//     of slots, the first slot's bit comes from `__fns`, the next ones by
//     clearing the bits below, and a group's four slots go out as 16-byte
//     stores where the layout is aligned. `rem_needed` is computed once a
//     block. The remainder blocks are spread evenly among the dense ones,
//     so both read the same splats' table words close in time.
//   * Dense blocks take one splat a thread: its table words are read once
//     (one coalesced pass over the table; one thread per slot read each
//     splat's words k0 times, and the table does not fit in L2), its mask
//     is decoded once and walked bit by bit, and a warp writes each of its
//     k0 slots of every row as one coalesced 128-byte run.
#include <climits>

#include "owner_search.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMinBlocks = 8;                       // blocks an SM
constexpr int kGroups = 2;                          // 4-slot groups a thread
constexpr int kWindow = 1024;                       // owners in shared memory
static_assert(kThreads >= 64 && kThreads % 32 == 0,
              "two warps search the block's first and last owner");
constexpr int kGroupStride = kThreads * 4;          // slots between groups
constexpr int kRemSlots = kGroupStride * kGroups;   // remainder slots a block
constexpr int kScanBits = 32;  // B_SCAN: exact-tested bbox-local slots
constexpr int kPayload = 10;

struct Geometry {
  const uint32_t* table;  // [18, stride] words
  int64_t stride;
  int n, k0, rem_cap, tile_bw, num_tiles, tile_bits;
  int64_t s_cap;
};

// What a slot's key needs of its splat.
struct Splat {
  int counts, pc, tmin_x, tmin_y, bb_w;
  uint32_t mask, depth;
};

__device__ __forceinline__ int word_int(const Geometry& geo, int row, int g) {
  return static_cast<int>(
      __uint_as_float(geo.table[static_cast<int64_t>(row) * geo.stride + g]));
}

__device__ __forceinline__ Splat load_splat(const Geometry& geo, int g) {
  Splat sp;
  sp.counts = word_int(geo, 14, g);
  sp.mask = static_cast<uint32_t>(word_int(geo, 15, g)) |
            (static_cast<uint32_t>(word_int(geo, 16, g)) << 16);
  sp.pc = __popc(sp.mask);
  sp.tmin_x = word_int(geo, 11, g);
  sp.tmin_y = word_int(geo, 12, g);
  sp.bb_w = max(word_int(geo, 13, g), 1);
  sp.depth = geo.table[10 * geo.stride + g];
  return sp;
}

// Key of the slot at bbox-local tile `local`; the sentinel tile where the
// slot is not in range.
__device__ __forceinline__ uint32_t slot_key(const Geometry& geo,
                                             const Splat& sp, int local,
                                             bool in_range) {
  const uint32_t tile =
      in_range ? static_cast<uint32_t>(
                     (sp.tmin_y + local / sp.bb_w) * geo.tile_bw +
                     sp.tmin_x + local % sp.bb_w)
               : static_cast<uint32_t>(geo.num_tiles);
  return (tile << (32 - geo.tile_bits)) | (sp.depth >> geo.tile_bits);
}

// Splat g's k0 dense slots, k * n + g.
__device__ void emit_dense(const Geometry& geo, int g,
                           int64_t* __restrict__ key_out,
                           uint32_t* __restrict__ rows_out) {
  const Splat sp = load_splat(geo, g);
  uint32_t payload[kPayload];
#pragma unroll
  for (int r = 0; r < kPayload; ++r) {
    payload[r] = geo.table[r * geo.stride + g];
  }
  uint32_t rest = sp.mask;  // the set bits not taken yet
  for (int k = 0; k < geo.k0; ++k) {
    int local;
    if (k < sp.pc) {
      local = __ffs(rest) - 1;
      rest &= rest - 1;
    } else {
      local = kScanBits + k - sp.pc;
    }
    const int64_t s = static_cast<int64_t>(k) * geo.n + g;
    key_out[s] = static_cast<int64_t>(slot_key(geo, sp, local, k < sp.counts));
#pragma unroll
    for (int r = 0; r < kPayload; ++r) rows_out[r * geo.s_cap + s] = payload[r];
  }
}

// owner[j][i]: the owner of remainder slot r0 + j * kGroupStride + 4 t + i
// of thread t, from the starts ws[0, size) of splats g_lo, g_lo + 1, ...
// (slots before ws[0] keep owner 0: the plain version's clamp). A group
// searches for its first slot and walks forward, searching again past a
// longer stretch of starts.
__device__ __forceinline__ void find_owners(const int32_t* ws, int size,
                                            int g_lo, int r0, int r_last,
                                            int (&owner)[kGroups][4]) {
  const int first = ws[0];
#pragma unroll
  for (int j = 0; j < kGroups; ++j) {
    const int s0 = r0 + j * kGroupStride + threadIdx.x * 4;
    int idx = -1;  // index of the first start past the last slot
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = s0 + i;
      if (s > r_last) break;
      if (s < first) continue;
      if (idx < 0) {
        idx = owner_search::window_upper_bound(ws, 0, size, s);
      } else {
        for (int steps = 0; idx < size && ws[idx] <= s; ++idx) {
          if (++steps > 4) {
            idx = owner_search::window_upper_bound(ws, idx, size, s);
            break;
          }
        }
      }
      owner[j][i] = g_lo + idx - 1;
    }
  }
}

// The remainder slots [r0, r_last] of one block.
__device__ void emit_remainder(const Geometry& geo, int r0,
                               int64_t* __restrict__ key_out,
                               uint32_t* __restrict__ rows_out, bool vec) {
  __shared__ int32_t w_start[kWindow];
  __shared__ int bounds[2];
  __shared__ int s_rem_needed;
  const int32_t* starts =
      reinterpret_cast<const int32_t*>(geo.table + 17 * geo.stride);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r_last = min(r0 + kRemSlots, geo.rem_cap) - 1;
  if (warp < 2) {
    const int ub = owner_search::warp_upper_bound(
        starts, geo.n, warp == 0 ? r0 : r_last, lane);
    if (lane == 0) bounds[warp] = ub - 1;
    if (threadIdx.x == 0) {
      const int cnt_last = word_int(geo, 14, geo.n - 1);
      s_rem_needed = starts[geo.n - 1] + max(cnt_last - geo.k0, 0);
    }
  }
  __syncthreads();
  // Owners of the block's slots: [g_lo, g_hi].
  const int g_lo = max(bounds[0], 0);
  const int g_hi = max(bounds[1], 0);
  const int rem_needed = s_rem_needed;

  int owner[kGroups][4] = {};
  const int size = g_hi + 1 - g_lo;
  if (size <= kWindow) {
    for (int i = threadIdx.x; i < size; i += kThreads) {
      w_start[i] = starts[g_lo + i];
    }
    __syncthreads();
    find_owners(w_start, size, g_lo, r0, r_last, owner);
  } else {
    // A longer range is mostly splats without remainder slots, which share
    // their successor's start (thousands of small splats, or the dead tail
    // of a capacity): search it where it lies, a few steps a group.
    find_owners(starts + g_lo, size, g_lo, r0, r_last, owner);
  }

#pragma unroll
  for (int j = 0; j < kGroups; ++j) {
    const int s0 = r0 + j * kGroupStride + threadIdx.x * 4;
    if (s0 > r_last) continue;
    uint32_t key[4] = {0u, 0u, 0u, 0u};
    Splat sp{};
    int jj = 0;
    uint32_t rest = 0;   // the owner's set bits above the last one taken
    bool walk = false;   // rest holds the bits after slot jj - 1's
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = s0 + i;
      if (r > r_last) break;
      if (i == 0 || owner[j][i] != owner[j][i - 1]) {
        sp = load_splat(geo, owner[j][i]);
        const int start =
            sp.counts - geo.k0 > 0 ? starts[owner[j][i]] : geo.rem_cap;
        jj = geo.k0 + (r - start);
        walk = false;
      } else {
        ++jj;
      }
      // The jj-th set bit of the mask (jj < 0: no tile, the slot is out of
      // range), or past the mask's bits, kScanBits + jj - popcount.
      int local = 0;
      if (jj >= sp.pc) {
        local = kScanBits + jj - sp.pc;
      } else if (jj >= 0) {
        local = walk ? __ffs(rest) - 1
                     : static_cast<int>(__fns(sp.mask, 0, jj + 1));
        rest = sp.mask & ((~0u << local) << 1);
      }
      walk = jj >= 0 && jj < sp.pc;
      key[i] = slot_key(geo, sp, local,
                        r < rem_needed && jj >= 0 && jj < sp.counts);
    }
    const int64_t s = static_cast<int64_t>(geo.n) * geo.k0 + s0;
    const bool full = vec && s0 + 3 <= r_last;
    if (full) {
      ulonglong2* kp = reinterpret_cast<ulonglong2*>(key_out + s);
      kp[0] = make_ulonglong2(key[0], key[1]);
      kp[1] = make_ulonglong2(key[2], key[3]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (s0 + i <= r_last) key_out[s + i] = static_cast<int64_t>(key[i]);
      }
    }
#pragma unroll
    for (int p = 0; p < kPayload; ++p) {
      const uint32_t* trow = geo.table + p * geo.stride;
      uint32_t* orow = rows_out + p * geo.s_cap + s;
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        w[i] = i > 0 && owner[j][i] == owner[j][i - 1] ? w[i - 1]
                                                       : trow[owner[j][i]];
      }
      if (full) {
        *reinterpret_cast<uint4*>(orow) = make_uint4(w[0], w[1], w[2], w[3]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (s0 + i <= r_last) orow[i] = w[i];
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
emit_slots_kernel(Geometry geo, int rem_blocks, bool vec,
                  int64_t* __restrict__ key_out,
                  uint32_t* __restrict__ rows_out) {
  // Remainder blocks are spread evenly among the dense ones, so the
  // remainder's owners are read from the table while the dense blocks of
  // the same splats have it in L2: block b is remainder block `before`
  // where the count of remainder blocks up to it steps.
  const int64_t b = blockIdx.x;
  const int before = static_cast<int>(b * rem_blocks / gridDim.x);
  if ((b + 1) * rem_blocks / gridDim.x > before) {
    emit_remainder(geo, before * kRemSlots, key_out, rows_out, vec);
    return;
  }
  const int g = static_cast<int>(b - before) * kThreads + threadIdx.x;
  if (g < geo.n) emit_dense(geo, g, key_out, rows_out);
}

}  // namespace

// table: [>= 18, stride] f32 words (layout above). key_out: [s_cap] int64;
// rows_out: [10, s_cap] f32, both contiguous. s_cap = n * k0 + rem_cap.
BRUSH_EXPORT int brush_emit_slots(const void* table, int64_t stride, int n,
                                  int k0, int rem_cap, int tile_bw,
                                  int num_tiles, int tile_bits, int64_t s_cap,
                                  void* key_out, void* rows_out,
                                  void* stream) {
  if (n <= 0 || s_cap <= 0) return 0;
  if (k0 < 1 || rem_cap < 0 ||
      s_cap != static_cast<int64_t>(n) * k0 + rem_cap) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Geometry geo{static_cast<const uint32_t*>(table), stride, n, k0,
                     rem_cap, tile_bw, num_tiles, tile_bits, s_cap};
  const int64_t rem_blocks = (rem_cap + kRemSlots - 1) / kRemSlots;
  const int64_t dense_blocks = (n + kThreads - 1) / kThreads;
  // 16-byte stores of a remainder group: every group starts at a slot and
  // a row offset that are multiples of 4.
  const bool vec = (static_cast<int64_t>(n) * k0) % 4 == 0 && s_cap % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(key_out) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(rows_out) & 15) == 0;
  emit_slots_kernel<<<static_cast<unsigned>(rem_blocks + dense_blocks),
                      kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      geo, static_cast<int>(rem_blocks), vec, static_cast<int64_t*>(key_out),
      static_cast<uint32_t*>(rows_out));
  return brush_last_error();
}
