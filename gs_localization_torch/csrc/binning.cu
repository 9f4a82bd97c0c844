// Tile binning's two segment expansions for Hopper (sm_90a): the owner of
// each slow-pool slot (bin_owner_kernel) and each stream position's place in
// the aligned pair stream (bin_place_kernel).
//
// Replaces no Pallas kernel of gs_localization_tpu. It stands for the two
// jax.lax.associative_scan(jnp.maximum, ...) calls in
// gs_localization_tpu/raster/binning.py and the writes after them:
//   :222  gsrt = running max of each rank scattered at its segment start
//         (_emit_pair_keys: the owner rank of every slow-pool slot)
//   :315  shift_of_pos = running max of each tile's shift scattered at its
//         first position (bin_stream), then the two scatters of gid_of_apos
//         and ap_by_slot at the live positions
// In PyTorch those are a scatter-max, torch.cummax and boolean-mask writes:
// cummax scans an innermost dimension one row per block, so a 2^21-slot pool
// got a single block (milliseconds), and every boolean-mask index made the
// host wait for the device.
//
// Why a search is exact:
// - owner: starts is non-decreasing and starts[0] = 0, so the running max of
//   the ranks scattered at their starts is, at slot j, the largest rank s
//   with starts[s] <= j, which is upper_bound(starts[0:p], j) - 1. Ranks
//   whose start lies at or past the pool never reach a slot, as the scatter
//   drops them. Zero-length segments share a start with the next segment,
//   and the largest rank wins, as the scatter-max's tie rule gives.
// - placement: the clamped tile starts min(tstart_pos[t], mr - 1) and the
//   shifts astart_all[t] - tstart_pos[t] >= 0 are both non-decreasing in t,
//   so the running max at position i is the shift of the last tile t with
//   min(tstart_pos[t], mr - 1) <= i (0 if there is none).
// Each target index is written at most once (live aligned positions are
// distinct, slots are a permutation), so there are no atomics and no races;
// the integers equal the scans' bit for bit.
//
// What bounds them on the H100: bytes. The owner kernel writes 4 B a slot
// (8 MB at 2^21 slots) and reads starts (at most ~1.6 MB, L2-resident): about
// 3 us at 3.35 TB/s. The placement kernel reads a key (4 B) and a slot index
// (8 B) a position and writes a rank, a Gaussian id and an aligned position
// (4 B each): about 40 MB at 2^21 positions, about 12 us. Each thread's
// binary search reads only L1/L2-resident tables, and neighbouring threads
// take the same path through them (their slots share a segment or a tile), so
// a warp's search loads are broadcasts.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// Slot j < n gets the largest rank s < p with starts[s] <= j (0 if p == 0).
__global__ void __launch_bounds__(kThreads)
bin_owner_kernel(const int* __restrict__ starts, int p, int n,
                 int* __restrict__ owner) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= n) return;
  int lo = 0, hi = p;  // starts[s] <= j for s < lo, > j for s >= hi
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(starts + mid) <= j) lo = mid + 1;
    else hi = mid;
  }
  owner[j] = lo > 0 ? lo - 1 : 0;
}

// Position i < mr: rank_of_pos[i] from its key; its aligned position ap = i +
// the shift of the last tile whose clamped start is <= i; if i < *kept,
// gid_of_apos[ap] = order[rank] (when ap < mr_al) and ap_by_slot[slot] = ap
// (when slot < s).
__global__ void __launch_bounds__(kThreads)
bin_place_kernel(const int* __restrict__ keys_sorted,
                 const long long* __restrict__ slot_of_pos,
                 const int* __restrict__ order,
                 const int* __restrict__ tstart_pos,
                 const int* __restrict__ astart_all,
                 const int* __restrict__ kept, int mr, int mr_al, int s,
                 int num_tiles, int rank_mask, int p,
                 int* __restrict__ rank_of_pos, int* __restrict__ gid_of_apos,
                 int* __restrict__ ap_by_slot) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= mr) return;
  const int rank = min(keys_sorted[i] & rank_mask, p - 1);
  rank_of_pos[i] = rank;
  int lo = 0, hi = num_tiles;  // clamped start <= i for t < lo, > i from hi
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (min(__ldg(tstart_pos + mid), mr - 1) <= i) lo = mid + 1;
    else hi = mid;
  }
  const int shift =
      lo > 0 ? max(__ldg(astart_all + lo - 1) - __ldg(tstart_pos + lo - 1), 0)
             : 0;
  if (i >= __ldg(kept)) return;
  const int ap = i + shift;
  if (ap < mr_al) gid_of_apos[ap] = __ldg(order + rank);
  const long long slot = slot_of_pos[i];
  if (slot >= 0 && slot < s) ap_by_slot[slot] = ap;
}

int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" {

// owner (n ints) receives each pool slot's owner rank; starts holds at least
// p non-decreasing ints with starts[0] = 0.
int gsl_bin_owner(const int* starts, int p, int n, int* owner,
                  void* cuda_stream) {
  if (n == 0) return 0;
  if (p < 0 || n < 0) return (int)cudaErrorInvalidValue;
  bin_owner_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)cuda_stream>>>(
      starts, p, n, owner);
  return (int)cudaGetLastError();
}

// keys_sorted and slot_of_pos hold at least mr entries, tstart_pos
// num_tiles and astart_all num_tiles + 1; kept is one int on the device.
// rank_of_pos (mr ints) is written whole; gid_of_apos (mr_al ints) and
// ap_by_slot (s ints) only at the live positions' targets, so the caller
// fills them first.
int gsl_bin_place(const int* keys_sorted, const long long* slot_of_pos,
                  const int* order, const int* tstart_pos,
                  const int* astart_all, const int* kept, int mr, int mr_al,
                  int s, int num_tiles, int rank_mask, int p,
                  int* rank_of_pos, int* gid_of_apos, int* ap_by_slot,
                  void* cuda_stream) {
  if (mr == 0) return 0;
  if (mr < 0 || num_tiles < 0 || p < 1) return (int)cudaErrorInvalidValue;
  bin_place_kernel<<<blocks_for(mr), kThreads, 0, (cudaStream_t)cuda_stream>>>(
      keys_sorted, slot_of_pos, order, tstart_pos, astart_all, kept, mr, mr_al,
      s, num_tiles, rank_mask, p, rank_of_pos, gid_of_apos, ap_by_slot);
  return (int)cudaGetLastError();
}

}  // extern "C"
