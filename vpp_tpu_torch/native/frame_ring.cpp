// Shared-memory SPSC frame ring: the host-side packet transport.
//
// Reference analog: govpp's shared-memory adapter between the Go agent
// and VPP (vendor/git.fd.io/govpp.git/adapter) and VPP's vlib frame
// queues — the reference moves packets NIC→VPP in C and config over a
// shared-memory API. Here the ring carries 256-packet frames in the
// exact SoA column layout of vpp_tpu_torch.pipeline.vector.PacketVector, so
// the Python/JAX side maps a committed slot as nine numpy views with
// zero copies and feeds it straight to the pipeline step.
//
// Single-producer single-consumer, lock-free: one ring per direction
// (rx: IO process → agent, tx: agent → IO process). Memory is provided
// by the caller (mmap / POSIX shm / multiprocessing.shared_memory), so
// the same code serves in-process and cross-process setups.
//
// Build: g++ -O2 -shared -fPIC -o libframering.so frame_ring.cpp

#include <atomic>
#include <cstdint>
#include <cstring>

namespace {

constexpr uint32_t kMagic = 0x54505652;  // "RVPT"
constexpr uint32_t kVersion = 2;
constexpr uint32_t kVec = 256;           // packets per frame (PacketVector VEC)
// PacketVector's nine fields plus three IO columns (disp, next_hop,
// meta) used on the tx direction, 4 bytes each.
constexpr uint32_t kColumns = 12;
constexpr uint32_t kCacheLine = 64;

struct RingHeader {
  uint32_t magic;
  uint32_t version;
  uint32_t n_slots;
  uint32_t slot_size;
  // head: next sequence the producer will write; tail: next the consumer
  // will read. Separate cache lines to avoid false sharing.
  alignas(kCacheLine) std::atomic<uint64_t> head;
  alignas(kCacheLine) std::atomic<uint64_t> tail;
  alignas(kCacheLine) uint8_t slots[];  // n_slots * slot_size
};

struct SlotHeader {
  uint32_t n_packets;
  uint32_t epoch;     // table epoch the frame was processed under (tx)
  uint64_t seq;       // ring sequence, for debugging/tracing
};

constexpr uint32_t slot_payload_size() { return kVec * 4 * kColumns; }
constexpr uint32_t slot_size_aligned() {
  uint32_t raw = sizeof(SlotHeader) + slot_payload_size();
  return (raw + kCacheLine - 1) / kCacheLine * kCacheLine;
}

RingHeader* as_ring(void* mem) { return reinterpret_cast<RingHeader*>(mem); }

uint8_t* slot_ptr(RingHeader* r, uint64_t seq) {
  return r->slots + (seq % r->n_slots) * r->slot_size;
}

}  // namespace

extern "C" {

// Total bytes the caller must provide for an n_slots ring.
uint64_t fr_required_size(uint32_t n_slots) {
  return sizeof(RingHeader) + uint64_t(n_slots) * slot_size_aligned();
}

uint32_t fr_slot_size() { return slot_size_aligned(); }
uint32_t fr_vec() { return kVec; }
uint32_t fr_columns() { return kColumns; }
uint32_t fr_header_size() { return sizeof(RingHeader); }
uint32_t fr_slot_header_size() { return sizeof(SlotHeader); }

// Initialize a ring in caller-provided zeroed memory.
int fr_create(void* mem, uint64_t size, uint32_t n_slots) {
  if (mem == nullptr || n_slots == 0) return -1;
  if (size < fr_required_size(n_slots)) return -2;
  RingHeader* r = as_ring(mem);
  r->n_slots = n_slots;
  r->slot_size = slot_size_aligned();
  r->head.store(0, std::memory_order_relaxed);
  r->tail.store(0, std::memory_order_relaxed);
  r->version = kVersion;
  reinterpret_cast<std::atomic<uint32_t>*>(&r->magic)
      ->store(kMagic, std::memory_order_release);
  return 0;
}

// Attach to an existing ring; validates magic/version/slot layout.
int fr_attach(void* mem) {
  RingHeader* r = as_ring(mem);
  // Pair with fr_create's release fence: only after an acquire fence may
  // we trust n_slots/slot_size written before magic became visible
  // (a cross-process attach racing creation on a weakly-ordered CPU
  // could otherwise see magic with stale geometry).
  if (reinterpret_cast<std::atomic<uint32_t>*>(&r->magic)
          ->load(std::memory_order_acquire) != kMagic)
    return -1;
  if (r->version != kVersion) return -2;
  // Reject rings built by a binary with a different slot layout.
  if (r->slot_size != slot_size_aligned()) return -3;
  return 0;
}

// ---- producer side ----

// Reserve the next slot for writing. Returns byte offset of the slot
// (relative to ring base) or -1 if the ring is full.
int64_t fr_produce_reserve(void* mem) {
  RingHeader* r = as_ring(mem);
  uint64_t head = r->head.load(std::memory_order_relaxed);
  uint64_t tail = r->tail.load(std::memory_order_acquire);
  if (head - tail >= r->n_slots) return -1;  // full
  SlotHeader* s = reinterpret_cast<SlotHeader*>(slot_ptr(r, head));
  s->seq = head;
  return static_cast<int64_t>(slot_ptr(r, head) - reinterpret_cast<uint8_t*>(r));
}

// Publish the reserved slot (after the payload + n_packets are written).
void fr_produce_commit(void* mem) {
  RingHeader* r = as_ring(mem);
  uint64_t head = r->head.load(std::memory_order_relaxed);
  r->head.store(head + 1, std::memory_order_release);
}

// ---- consumer side ----

// Peek the oldest unconsumed slot. Returns byte offset or -1 if empty.
int64_t fr_consume_peek(void* mem) {
  RingHeader* r = as_ring(mem);
  uint64_t tail = r->tail.load(std::memory_order_relaxed);
  uint64_t head = r->head.load(std::memory_order_acquire);
  if (tail >= head) return -1;  // empty
  return static_cast<int64_t>(slot_ptr(r, tail) - reinterpret_cast<uint8_t*>(r));
}

// Peek the k-th oldest unconsumed slot (k=0 == fr_consume_peek).
// Returns byte offset or -1 if fewer than k+1 frames are pending. Lets
// the consumer keep several frames in flight (dispatched to the device)
// while their slots stay owned by the ring — released in order once the
// results are written out. The producer cannot touch these slots until
// tail advances, so the views stay stable without a payload copy.
int64_t fr_consume_peek_nth(void* mem, uint32_t k) {
  RingHeader* r = as_ring(mem);
  uint64_t tail = r->tail.load(std::memory_order_relaxed);
  uint64_t head = r->head.load(std::memory_order_acquire);
  if (tail + k >= head) return -1;
  return static_cast<int64_t>(slot_ptr(r, tail + k) -
                              reinterpret_cast<uint8_t*>(r));
}

// Release the slot returned by the last successful peek. Returns 0, or
// -1 if there is nothing to release (a mismatched release would
// otherwise advance tail past head and wedge the ring permanently).
int fr_consume_release(void* mem) {
  RingHeader* r = as_ring(mem);
  uint64_t tail = r->tail.load(std::memory_order_relaxed);
  uint64_t head = r->head.load(std::memory_order_acquire);
  if (tail >= head) return -1;
  r->tail.store(tail + 1, std::memory_order_release);
  return 0;
}

uint32_t fr_n_slots(void* mem) { return as_ring(mem)->n_slots; }

// Number of committed-but-unconsumed frames.
uint64_t fr_pending(void* mem) {
  RingHeader* r = as_ring(mem);
  uint64_t head = r->head.load(std::memory_order_acquire);
  uint64_t tail = r->tail.load(std::memory_order_acquire);
  return head - tail;
}

// ---- batch copy helpers (amortize ctypes call overhead) ----

// Copy a full frame (kColumns × kVec int32) into the slot at `offset`
// and set n_packets. Caller still must fr_produce_commit.
void fr_write_frame(void* mem, int64_t offset, const int32_t* columns,
                    uint32_t n_packets, uint32_t epoch) {
  uint8_t* base = reinterpret_cast<uint8_t*>(mem) + offset;
  SlotHeader* s = reinterpret_cast<SlotHeader*>(base);
  s->n_packets = n_packets;
  s->epoch = epoch;
  std::memcpy(base + sizeof(SlotHeader), columns, slot_payload_size());
}

void fr_read_frame(void* mem, int64_t offset, int32_t* columns,
                   uint32_t* n_packets, uint32_t* epoch) {
  uint8_t* base = reinterpret_cast<uint8_t*>(mem) + offset;
  SlotHeader* s = reinterpret_cast<SlotHeader*>(base);
  *n_packets = s->n_packets;
  *epoch = s->epoch;
  std::memcpy(columns, base + sizeof(SlotHeader), slot_payload_size());
}

}  // extern "C"
