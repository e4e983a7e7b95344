// Inbox compaction for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel experiments/pallas_compact.py
// (_compact_kernel / pallas_compact), whose function is the JAX package's
// inbox compaction: the engine's round-boundary compact_wire_carry and the
// in-round compact_inbox of models/raft.py (etcd_tpu/models/engine.py,
// etcd_tpu/models/raft.py). For every receiver column (to, c), rank the
// nonempty message slots (type != 0) over the S = M*K sender slots in
// delivery order, and write the first B of them, for all 17 message leaves,
// into [B, to(*E), C]; output slots past the last nonempty one are all zero
// (frm included).
//
// Bound: bytes. There is no arithmetic to speak of; the card has to read the
// type plane once and, for every other leaf, each 32 B sector (8 int32 or 32
// bool columns of one slot row) from which some column selects a slot, and
// to write the B output slots. Design: one thread per (to, c) column, so the
// threads of a warp walk along C, the minor axis, and every access to a slot
// row is coalesced. The thread reads the S type words once, keeps the source
// slot of each output slot in registers, and then copies only the selected
// slots of each leaf: a dropped or empty slot is never read, so the
// keep-masked (type-zeroed) slots cannot leak their other fields. The integer
// leaves are stored as OutT: int16 at the round boundary (the int16 wire the
// round stores, which fuses the cast that follows the compaction in the plain
// form), int32 at the in-round compact_inbox site.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kFields = 17;
constexpr int kMaxSlots = 32;

struct Leaves {
  const void* in[kFields];  // [S, M, (E,) C]: int32, or uint8 for bool leaves
  void* out[kFields];       // [B, M, (E,) C]: OutT, or uint8 for bool leaves
};

template <typename OutT>
__global__ void compact_wire_kernel(Leaves p, unsigned bool_mask,
                                    unsigned ent_mask, int S, int M, int E,
                                    int B, long long C) {
  const long long MC = static_cast<long long>(M) * C;
  const long long col = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (col >= MC) return;
  const long long to = col / C;
  const long long c = col - to * C;

  // src[b]: the input slot that lands in output slot b, or -1
  int src[kMaxSlots];
  const int32_t* typ = static_cast<const int32_t*>(p.in[0]);
  int nb = 0;
  for (int s = 0; s < S; ++s) {
    if (typ[s * MC + col] != 0) {
      if (nb < B) src[nb] = s;
      ++nb;
    }
  }
  for (int b = nb; b < B; ++b) src[b] = -1;

  for (int f = 0; f < kFields; ++f) {
    if ((bool_mask >> f) & 1u) {
      const uint8_t* in = static_cast<const uint8_t*>(p.in[f]);
      uint8_t* out = static_cast<uint8_t*>(p.out[f]);
      for (int b = 0; b < B; ++b)
        out[b * MC + col] = src[b] >= 0 ? in[src[b] * MC + col] : 0;
    } else if ((ent_mask >> f) & 1u) {
      const int32_t* in = static_cast<const int32_t*>(p.in[f]);
      OutT* out = static_cast<OutT*>(p.out[f]);
      const long long row = MC * E;           // one slot of an entry leaf
      for (int b = 0; b < B; ++b)
        for (int e = 0; e < E; ++e) {
          const long long at = (to * E + e) * C + c;
          out[b * row + at] =
              static_cast<OutT>(src[b] >= 0 ? in[src[b] * row + at] : 0);
        }
    } else {
      const int32_t* in = static_cast<const int32_t*>(p.in[f]);
      OutT* out = static_cast<OutT*>(p.out[f]);
      for (int b = 0; b < B; ++b)
        out[b * MC + col] = static_cast<OutT>(src[b] >= 0 ? in[src[b] * MC + col] : 0);
    }
  }
}

}  // namespace

// Launches the compaction on `stream`. in_ptrs/out_ptrs hold the 17 leaves'
// device pointers in Msg field order; bit f of bool_mask / ent_mask marks
// leaf f as a bool leaf / an entry leaf with an E axis; the integer leaves
// are written with out_bytes bytes each (2: int16, 4: int32). Returns the
// CUDA error of the launch (0 on success) or -1 for arguments the kernel
// does not take.
extern "C" int etcd_compact_wire(void** in_ptrs, void** out_ptrs,
                                 unsigned bool_mask, unsigned ent_mask, int S,
                                 int M, int E, int B, long long C, int out_bytes,
                                 void* stream) {
  if (S < 1 || S > kMaxSlots || B < 1 || B > S || M < 1 || E < 1 || C < 1 ||
      (out_bytes != 2 && out_bytes != 4))
    return -1;
  Leaves p;
  for (int f = 0; f < kFields; ++f) {
    p.in[f] = in_ptrs[f];
    p.out[f] = out_ptrs[f];
  }
  const int threads = 256;
  const long long cols = static_cast<long long>(M) * C;
  const unsigned blocks = static_cast<unsigned>((cols + threads - 1) / threads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_bytes == 2)
    compact_wire_kernel<int16_t><<<blocks, threads, 0, st>>>(p, bool_mask, ent_mask,
                                                             S, M, E, B, C);
  else
    compact_wire_kernel<int32_t><<<blocks, threads, 0, st>>>(p, bool_mask, ent_mask,
                                                             S, M, E, B, C);
  return static_cast<int>(cudaGetLastError());
}
