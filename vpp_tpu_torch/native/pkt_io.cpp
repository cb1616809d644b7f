// Native packet codec: wire frames <-> the ring's SoA columns.
//
// The front-end half of the data plane the reference gets from VPP's C
// graph input/output nodes (dpdk-input / af-packet-input -> ethernet-input
// -> ip4-input parse; interface-output serialize, see the upstream
// project's docs/VPP_PACKET_TRACING_K8S.md:28-50). Batch functions
// so the Python side makes one ctypes call per 256-packet frame:
//
//   pio_parse    raw ethernet frames -> 12 SoA columns + payload copies
//   pio_rewrite  patch L3/L4 headers in stored frames from (possibly
//                NAT-rewritten) columns, with incremental checksums
//   pio_encap    wrap a stored frame in outer Ethernet+IPv4+UDP+VXLAN
//
// Checksum discipline: IPv4 header checksum recomputed from scratch;
// TCP/UDP checksums updated incrementally per RFC 1624 (HC' = ~(~HC +
// ~m + m')) over the rewritten words, so payload bytes never need to be
// touched. UDP checksum 0 (disabled) is preserved as 0.
//
// Build: g++ -O2 -shared -fPIC -o libpktio.so pkt_io.cpp

#include <array>
#include <cstdint>
#include <cstring>

#include <cerrno>
#include <sys/socket.h>
#include <sys/uio.h>
#include <unistd.h>

namespace {

constexpr uint32_t kVec = 256;
constexpr uint32_t kColumns = 12;

// Column indices (must match vpp_tpu_torch/native/ring.py RING_COLUMNS).
enum Col {
  kSrcIp = 0, kDstIp, kProto, kSport, kDport, kTtl, kPktLen, kRxIf,
  kFlags, kDisp, kNextHop, kMeta,
};

// flags bits (bit0 mirrors PacketVector FLAG_VALID)
constexpr int32_t kFlagValid = 1;
constexpr int32_t kFlagNonIp4 = 2;   // not IPv4: punt/bypass, never classify
constexpr int32_t kFlagTrunc = 4;    // captured bytes < claimed length:
                                     // must be dropped, never transmitted
                                     // (stale slot bytes would leak)

constexpr uint32_t kEthHdr = 14;
constexpr uint16_t kEthIp4 = 0x0800;

inline uint16_t rd16(const uint8_t* p) {
  return static_cast<uint16_t>(p[0]) << 8 | p[1];
}
inline uint32_t rd32(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) << 24 | static_cast<uint32_t>(p[1]) << 16 |
         static_cast<uint32_t>(p[2]) << 8 | p[3];
}
inline void wr16(uint8_t* p, uint16_t v) {
  p[0] = v >> 8;
  p[1] = v & 0xff;
}
inline void wr32(uint8_t* p, uint32_t v) {
  p[0] = v >> 24;
  p[1] = (v >> 16) & 0xff;
  p[2] = (v >> 8) & 0xff;
  p[3] = v & 0xff;
}

// One's-complement sum over a byte range (big-endian 16-bit words).
uint32_t csum_add(uint32_t sum, const uint8_t* p, uint32_t len) {
  while (len > 1) {
    sum += rd16(p);
    p += 2;
    len -= 2;
  }
  if (len) sum += static_cast<uint32_t>(p[0]) << 8;
  return sum;
}

uint16_t csum_fold(uint32_t sum) {
  while (sum >> 16) sum = (sum & 0xffff) + (sum >> 16);
  return static_cast<uint16_t>(~sum & 0xffff);
}

// RFC 1624 incremental update: checksum at `ck` (big-endian in the
// packet) adjusted for a 16-bit word changing old->neu.
void csum_update16(uint8_t* ck, uint16_t old, uint16_t neu) {
  uint16_t hc = rd16(ck);
  uint32_t sum = static_cast<uint32_t>(static_cast<uint16_t>(~hc)) +
                 static_cast<uint16_t>(~old) + neu;
  while (sum >> 16) sum = (sum & 0xffff) + (sum >> 16);
  wr16(ck, static_cast<uint16_t>(~sum & 0xffff));
}

void csum_update32(uint8_t* ck, uint32_t old, uint32_t neu) {
  csum_update16(ck, old >> 16, neu >> 16);
  csum_update16(ck, old & 0xffff, neu & 0xffff);
}

inline int32_t* col(int32_t* cols, int c) { return cols + c * kVec; }

// Per-frame write() transmission for char-device (TAP) fds — sendmmsg
// rejects non-sockets. Short-count-on-error policy matches the socket
// path: the caller counts the remainder as drops.
int32_t write_rows(int32_t fd, const uint8_t* base, uint32_t stride,
                   const uint32_t* rows, const uint32_t* lens, uint32_t n) {
  int32_t sent = 0;
  for (uint32_t j = 0; j < n; j++) {
    ssize_t rc = write(fd, base + static_cast<uint64_t>(rows[j]) * stride,
                       lens[j]);
    if (rc < 0) break;
    sent++;
  }
  return sent;
}

// Identity row indices for batches compacted sequentially into a
// scratch area (pio_send_batch addresses by row index). C++ magic
// static: initialization is thread-safe under concurrent first calls
// from multiple tx threads (a hand-rolled `static bool init` flag was
// not — one thread could observe partially filled rows).
const uint32_t* identity_rows() {
  static const std::array<uint32_t, kVec> rows = [] {
    std::array<uint32_t, kVec> r{};
    for (uint32_t i = 0; i < kVec; i++) r[i] = i;
    return r;
  }();
  return rows.data();
}

// Field extraction for one frame at slot i (shared by the copying and
// in-place parse entry points). `f` points at the frame bytes, `len`
// is the wire length, `copy` the bytes actually available (<= snap).
void parse_fields(const uint8_t* f, uint32_t len, uint32_t copy,
                  uint32_t snap, uint32_t i, int32_t rx_if,
                  int32_t* cols) {
  col(cols, kRxIf)[i] = rx_if;
  // pkt_len convention is L3 length (wire length = pkt_len + 14);
  // keep it for non-IPv4 frames too so the tx side reconstructs the
  // right wire length for punts. Clamped to the captured bytes.
  col(cols, kPktLen)[i] =
      static_cast<int32_t>(copy >= kEthHdr ? copy - kEthHdr : 0);
  col(cols, kFlags)[i] = kFlagValid;
  if (len > snap) col(cols, kFlags)[i] |= kFlagTrunc;
  // Runts shorter than an Ethernet header have no meaningful wire
  // length; without kFlagTrunc the punt path would transmit up to 14
  // bytes including residual data from the slot's previous occupant.
  if (copy < kEthHdr) col(cols, kFlags)[i] |= kFlagTrunc;
  if (len < kEthHdr + 20 || rd16(f + 12) != kEthIp4) {
    col(cols, kFlags)[i] |= kFlagNonIp4;
    return;
  }
  const uint8_t* ip = f + kEthHdr;
  uint32_t ihl = (ip[0] & 0x0f) * 4u;
  if ((ip[0] >> 4) != 4 || ihl < 20 || len < kEthHdr + ihl) {
    col(cols, kFlags)[i] |= kFlagNonIp4;
    return;
  }
  col(cols, kSrcIp)[i] = static_cast<int32_t>(rd32(ip + 12));
  col(cols, kDstIp)[i] = static_cast<int32_t>(rd32(ip + 16));
  col(cols, kProto)[i] = ip[9];
  col(cols, kTtl)[i] = ip[8];
  // pkt_len is CLAMPED to what was actually captured: a header
  // claiming more than the wire delivered (or a frame longer than
  // snap) must never cause tx of residual bytes from a previous
  // packet in the reused slot — that would leak cross-flow data.
  uint32_t tot_len = rd16(ip + 2);
  uint32_t captured_l3 = copy - kEthHdr;
  if (tot_len > captured_l3 || len > snap) {
    col(cols, kFlags)[i] |= kFlagTrunc;
    tot_len = tot_len > captured_l3 ? captured_l3 : tot_len;
  }
  col(cols, kPktLen)[i] = static_cast<int32_t>(tot_len);
  uint8_t proto = ip[9];
  const uint8_t* l4 = ip + ihl;
  if ((proto == 6 || proto == 17) && len >= kEthHdr + ihl + 4) {
    col(cols, kSport)[i] = rd16(l4);
    col(cols, kDport)[i] = rd16(l4 + 2);
  }
}

}  // namespace

extern "C" {

// ---- pump fast path (io/pump.py hot loops in one GIL-releasing call
// per batch/frame): pack rx ring slots into the [5, B] bit-packed
// device batch, and decode the [5, B] packed result straight into a tx
// ring slot's column block. Layouts must mirror
// pipeline/dataplane.py's _packed_call / pack_packet_columns /
// unpack_packet_result. ----

// Pack `n_frames` rx slots (each a int32[12][kVec] column block, base
// pointers in `slot_bases`) into the packed batch `flat` =
// int32[5][bucket], sequentially from column 0. Non-IPv4/truncated
// packets are masked INVALID for the device step (flags byte cleared),
// and their non-ip bit is reported in `non_ip` (uint8[bucket], 1 =
// punt to host after the step) — exactly the Python dispatch path.
void pio_pack_batch(const uint64_t* slot_bases, const uint32_t* ns,
                    uint32_t n_frames, int32_t* flat, uint32_t bucket,
                    uint8_t* non_ip) {
  uint32_t* f0 = reinterpret_cast<uint32_t*>(flat);
  uint32_t* f1 = f0 + bucket;
  uint32_t* f2 = f1 + bucket;
  uint32_t* f3 = f2 + bucket;
  uint32_t* f4 = f3 + bucket;
  uint32_t off = 0;
  for (uint32_t j = 0; j < n_frames; j++) {
    const int32_t* slot = reinterpret_cast<const int32_t*>(slot_bases[j]);
    uint32_t n = ns[j];
    if (n > kVec) n = kVec;
    if (off + n > bucket) n = bucket - off;
    const uint32_t* src = reinterpret_cast<const uint32_t*>(slot);
    for (uint32_t i = 0; i < n; i++) {
      uint32_t flags = src[kFlags * kVec + i] & 0xFFu;
      uint8_t nip = (flags & kFlagNonIp4) ? 1 : 0;
      if (flags & (kFlagNonIp4 | kFlagTrunc)) flags = 0;
      non_ip[off + i] = nip;
      f0[off + i] = src[kSrcIp * kVec + i];
      f1[off + i] = src[kDstIp * kVec + i];
      f2[off + i] = (src[kSport * kVec + i] << 16)
                    | (src[kDport * kVec + i] & 0xFFFFu);
      f3[off + i] = ((src[kPktLen * kVec + i] & 0xFFFFu) << 16)
                    | ((src[kProto * kVec + i] & 0xFFu) << 8)
                    | (src[kTtl * kVec + i] & 0xFFu);
      f4[off + i] = (src[kRxIf * kVec + i] << 8) | flags;
    }
    off += n;
  }
}

// Decode packed result columns [off, off+n) of `packed` =
// int32[5][bucket] into a TX ring slot column block `tx_slot`
// (int32[12][kVec]), taking pipeline-invariant and pass-through
// columns (proto/pkt_len/flags/meta) from the matching RX slot.
// Non-IPv4 packets (rx flags) are re-routed to the HOST punt
// disposition. The per-packet drop_cause nibble is written to
// `cause` (int32[kVec], slots >= n zeroed) for the caller's ICMP
// error generation. Columns beyond `n` are zeroed (ring consumers
// must never see a previous lap's data).
void pio_unpack_to_slot(const int32_t* packed, uint32_t bucket,
                        uint32_t off, uint32_t n, const int32_t* rx_slot,
                        int32_t* tx_slot, int32_t host_if,
                        int32_t* cause) {
  const uint32_t* f0 = reinterpret_cast<const uint32_t*>(packed);
  const uint32_t* f1 = f0 + bucket;
  const uint32_t* f2 = f1 + bucket;
  const uint32_t* f3 = f2 + bucket;
  const uint32_t* f4 = f3 + bucket;
  const uint32_t* rx = reinterpret_cast<const uint32_t*>(rx_slot);
  if (n > kVec) n = kVec;
  for (uint32_t i = 0; i < n; i++) {
    uint32_t r3 = f3[off + i];
    int32_t tx_if = static_cast<int32_t>(r3 & 0xFFFFu);
    if (tx_if == 0xFFFF) tx_if = -1;
    int32_t disp = static_cast<int32_t>((r3 >> 24) & 0xFu);
    cause[i] = static_cast<int32_t>(r3 >> 28);
    uint32_t rx_flags = rx[kFlags * kVec + i];
    if (rx_flags & kFlagNonIp4) {  // punt path: bypassed the pipeline
      disp = 3;                    // Disposition.HOST
      tx_if = host_if;
    }
    tx_slot[kSrcIp * kVec + i] = static_cast<int32_t>(f0[off + i]);
    tx_slot[kDstIp * kVec + i] = static_cast<int32_t>(f1[off + i]);
    tx_slot[kProto * kVec + i] = rx_slot[kProto * kVec + i];
    tx_slot[kSport * kVec + i] = static_cast<int32_t>(f2[off + i] >> 16);
    tx_slot[kDport * kVec + i] =
        static_cast<int32_t>(f2[off + i] & 0xFFFFu);
    tx_slot[kTtl * kVec + i] = static_cast<int32_t>((r3 >> 16) & 0xFFu);
    tx_slot[kPktLen * kVec + i] = rx_slot[kPktLen * kVec + i];
    tx_slot[kRxIf * kVec + i] = tx_if;  // tx direction: egress if
    tx_slot[kFlags * kVec + i] = static_cast<int32_t>(rx_flags);
    tx_slot[kDisp * kVec + i] = disp;
    tx_slot[kNextHop * kVec + i] = static_cast<int32_t>(f4[off + i]);
    tx_slot[kMeta * kVec + i] = rx_slot[kMeta * kVec + i];
  }
  for (uint32_t i = n; i < kVec; i++) {
    cause[i] = 0;
    for (uint32_t c = 0; c < kColumns; c++) tx_slot[c * kVec + i] = 0;
  }
}


uint32_t pio_vec() { return kVec; }
uint32_t pio_columns() { return kColumns; }

// Parse up to kVec raw ethernet frames into SoA columns and copy each
// frame into payload[i*snap .. ]. bufs: concatenated frames; offsets/
// lens: per-frame location. Returns number of slots filled.
//
// Non-IPv4 frames (ARP, IPv6, LLDP...) get kFlagNonIp4 and no L3/L4
// fields: the IO daemon punts them to the host path un-classified (the
// reference's VPP punts unmatched ethertypes similarly).
uint32_t pio_parse(const uint8_t* bufs, const uint64_t* offsets,
                   const uint32_t* lens, uint32_t n, int32_t rx_if,
                   int32_t* cols, uint8_t* payload, uint32_t snap) {
  if (n > kVec) n = kVec;
  std::memset(cols, 0, sizeof(int32_t) * kVec * kColumns);
  for (uint32_t i = 0; i < n; i++) {
    const uint8_t* f = bufs + offsets[i];
    uint32_t len = lens[i];
    uint32_t copy = len < snap ? len : snap;
    std::memcpy(payload + static_cast<uint64_t>(i) * snap, f, copy);
    parse_fields(f, len, copy, snap, i, rx_if, cols);
  }
  return n;
}

// Patch stored frames from (possibly rewritten) columns: IP src/dst,
// TTL, L4 ports; fix IPv4 + L4 checksums. Only valid IPv4 slots touched.
void pio_rewrite(const int32_t* cols_c, uint8_t* payload, uint32_t n,
                 uint32_t snap) {
  int32_t* cols = const_cast<int32_t*>(cols_c);
  if (n > kVec) n = kVec;
  for (uint32_t i = 0; i < n; i++) {
    int32_t flags = col(cols, kFlags)[i];
    if (!(flags & kFlagValid) || (flags & kFlagNonIp4)) continue;
    uint8_t* f = payload + static_cast<uint64_t>(i) * snap;
    uint8_t* ip = f + kEthHdr;
    uint32_t ihl = (ip[0] & 0x0f) * 4u;
    uint8_t proto = ip[9];
    uint8_t* l4 = ip + ihl;

    uint32_t old_src = rd32(ip + 12), old_dst = rd32(ip + 16);
    uint32_t new_src = static_cast<uint32_t>(col(cols, kSrcIp)[i]);
    uint32_t new_dst = static_cast<uint32_t>(col(cols, kDstIp)[i]);
    uint8_t new_ttl = static_cast<uint8_t>(col(cols, kTtl)[i]);

    // L4 checksum location (TCP: +16, UDP: +6); UDP 0 = disabled stays 0
    uint8_t* l4ck = nullptr;
    if (proto == 6) l4ck = l4 + 16;
    else if (proto == 17 && rd16(l4 + 6) != 0) l4ck = l4 + 6;

    if (new_src != old_src) {
      wr32(ip + 12, new_src);
      if (l4ck) csum_update32(l4ck, old_src, new_src);
    }
    if (new_dst != old_dst) {
      wr32(ip + 16, new_dst);
      if (l4ck) csum_update32(l4ck, old_dst, new_dst);
    }
    if (proto == 6 || proto == 17) {
      uint16_t old_sp = rd16(l4), old_dp = rd16(l4 + 2);
      uint16_t new_sp = static_cast<uint16_t>(col(cols, kSport)[i]);
      uint16_t new_dp = static_cast<uint16_t>(col(cols, kDport)[i]);
      if (new_sp != old_sp) {
        wr16(l4, new_sp);
        if (l4ck) csum_update16(l4ck, old_sp, new_sp);
      }
      if (new_dp != old_dp) {
        wr16(l4 + 2, new_dp);
        if (l4ck) csum_update16(l4ck, old_dp, new_dp);
      }
    }
    ip[8] = new_ttl;
    // IPv4 header checksum: recompute from scratch (cheap, 20-60B)
    wr16(ip + 10, 0);
    wr16(ip + 10, csum_fold(csum_add(0, ip, ihl)));
  }
}

// VXLAN-encapsulate one stored frame into out (must hold 50 + frame_len
// bytes): outer Ethernet + IPv4 + UDP + VXLAN, inner = frame as-is.
// Returns total outer length. Outer MACs are caller-provided.
// Reference wire format: RFC 7348 (matches ops/vxlan.py encode_frame).
uint32_t pio_encap(const uint8_t* frame, uint32_t frame_len, uint32_t src_ip,
                   uint32_t dst_ip, uint16_t src_port, uint32_t vni,
                   const uint8_t* src_mac, const uint8_t* dst_mac,
                   uint8_t* out) {
  uint8_t* p = out;
  std::memcpy(p, dst_mac, 6);
  std::memcpy(p + 6, src_mac, 6);
  wr16(p + 12, kEthIp4);
  p += kEthHdr;
  uint32_t udp_len = 8 + 8 + frame_len;       // UDP + VXLAN + inner
  uint32_t ip_len = 20 + udp_len;
  p[0] = 0x45; p[1] = 0;
  wr16(p + 2, static_cast<uint16_t>(ip_len));
  wr16(p + 4, 0);                              // id
  wr16(p + 6, 0x4000);                         // DF
  p[8] = 64;                                   // ttl
  p[9] = 17;                                   // udp
  wr16(p + 10, 0);
  wr32(p + 12, src_ip);
  wr32(p + 16, dst_ip);
  wr16(p + 10, csum_fold(csum_add(0, p, 20)));
  p += 20;
  wr16(p, src_port);
  wr16(p + 2, 4789);                           // VXLAN dst port
  wr16(p + 4, static_cast<uint16_t>(udp_len));
  wr16(p + 6, 0);                              // UDP csum optional for v4
  p += 8;
  p[0] = 0x08; p[1] = 0; p[2] = 0; p[3] = 0;   // flags: VNI present
  wr32(p + 4, vni << 8);
  p += 8;
  std::memcpy(p, frame, frame_len);
  return kEthHdr + ip_len;
}

// Decapsulate: returns offset of the inner frame within `frame` (the
// payload of a VXLAN UDP datagram), or 0 if not VXLAN-to-our-port, not
// a VNI-present VXLAN header, or from a different overlay segment than
// `vni` (the reference maps tunnels by VNI; accepting any UDP/4789
// frame would inject foreign-segment or crafted traffic as inner
// frames).
uint32_t pio_decap_offset(const uint8_t* frame, uint32_t frame_len,
                          uint32_t vni) {
  if (frame_len < kEthHdr + 20) return 0;
  if (rd16(frame + 12) != kEthIp4) return 0;
  const uint8_t* ip = frame + kEthHdr;
  if ((ip[0] >> 4) != 4) return 0;
  uint32_t ihl = (ip[0] & 0x0f) * 4u;
  if (ihl < 20) return 0;
  // Bounds must use the ACTUAL header length (IHL up to 60): a crafted
  // IHL with a 20-byte-based check would read past the buffer.
  if (frame_len < kEthHdr + ihl + 8 + 8 + kEthHdr) return 0;
  if (ip[9] != 17) return 0;
  const uint8_t* udp = ip + ihl;
  if (rd16(udp + 2) != 4789) return 0;
  const uint8_t* vx = udp + 8;
  if (vx[0] != 0x08) return 0;                 // I flag: VNI present
  if ((rd32(vx + 4) >> 8) != vni) return 0;    // segment match
  return kEthHdr + ihl + 8 + 8;
}

// ---- batch socket IO (the syscall-amortization layer; reference: VPP
// moves packets in 256-frame vectors precisely so per-packet costs
// amortize — a Python send() per packet re-introduces them) ----

constexpr uint32_t kMmsgChunk = 64;

// Transmit n frames over one socket fd with sendmmsg. rows[i] selects
// the payload slot row, lens[i] the wire length. Returns frames sent
// (short count on EAGAIN/tx-queue-full; caller counts the rest as
// drops, same policy as the per-frame path).
int32_t pio_send_batch(int32_t fd, const uint8_t* payload, uint32_t snap,
                       const uint32_t* rows, const uint32_t* lens,
                       uint32_t n) {
  mmsghdr msgs[kMmsgChunk];
  iovec iov[kMmsgChunk];
  uint32_t sent = 0;
  while (sent < n) {
    uint32_t k = n - sent < kMmsgChunk ? n - sent : kMmsgChunk;
    std::memset(msgs, 0, sizeof(mmsghdr) * k);
    for (uint32_t i = 0; i < k; i++) {
      uint32_t row = rows[sent + i];
      iov[i].iov_base =
          const_cast<uint8_t*>(payload + static_cast<uint64_t>(row) * snap);
      iov[i].iov_len = lens[sent + i];
      msgs[i].msg_hdr.msg_iov = &iov[i];
      msgs[i].msg_hdr.msg_iovlen = 1;
    }
    int rc = sendmmsg(fd, msgs, k, MSG_DONTWAIT);
    if (rc <= 0) break;
    sent += static_cast<uint32_t>(rc);
    if (static_cast<uint32_t>(rc) < k) break;  // tx queue filled mid-batch
  }
  return static_cast<int32_t>(sent);
}

// Receive up to max_frames datagrams/frames into payload rows [0..) in
// one recvmmsg; lens[i] gets each frame's TRUE wire byte count
// (MSG_TRUNC: a frame longer than snap reports its real length, so the
// parser sets kFlagTrunc and the tx path can never emit a silently
// truncated frame — the copying path's trunc_drops guarantee).
// Non-blocking; returns the count, 0 when nothing pending, -1 on a
// hard socket error with nothing received (dead/detached fd).
int32_t pio_recv_batch(int32_t fd, uint8_t* payload, uint32_t snap,
                       uint32_t* lens, uint32_t max_frames) {
  mmsghdr msgs[kMmsgChunk];
  iovec iov[kMmsgChunk];
  uint32_t got = 0;
  while (got < max_frames) {
    uint32_t k = max_frames - got < kMmsgChunk ? max_frames - got
                                               : kMmsgChunk;
    std::memset(msgs, 0, sizeof(mmsghdr) * k);
    for (uint32_t i = 0; i < k; i++) {
      iov[i].iov_base = payload + static_cast<uint64_t>(got + i) * snap;
      iov[i].iov_len = snap;
      msgs[i].msg_hdr.msg_iov = &iov[i];
      msgs[i].msg_hdr.msg_iovlen = 1;
    }
    int rc = recvmmsg(fd, msgs, k, MSG_DONTWAIT | MSG_TRUNC, nullptr);
    if (rc < 0) {
      if (got) return static_cast<int32_t>(got);
      return (errno == EAGAIN || errno == EWOULDBLOCK) ? 0 : -1;
    }
    for (int i = 0; i < rc; i++) lens[got + i] = msgs[i].msg_len;
    got += static_cast<uint32_t>(rc);
    if (static_cast<uint32_t>(rc) < k) break;  // drained
  }
  return static_cast<int32_t>(got);
}

// Parse frames already resident in the payload block (recv_batch wrote
// them there): same field extraction as pio_parse but zero copies —
// each row IS the stored frame.
uint32_t pio_parse_inplace(const uint8_t* payload, uint32_t snap,
                           const uint32_t* lens, uint32_t n,
                           int32_t rx_if, int32_t* cols) {
  if (n > kVec) n = kVec;
  std::memset(cols, 0, sizeof(int32_t) * kVec * kColumns);
  for (uint32_t i = 0; i < n; i++) {
    const uint8_t* f = payload + static_cast<uint64_t>(i) * snap;
    uint32_t len = lens[i];
    uint32_t copy = len < snap ? len : snap;
    parse_fields(f, len, copy, snap, i, rx_if, cols);
  }
  return n;
}

// ---- (ip -> MAC) neighbor table, caller-owned arrays (the daemon's
// static-ARP + rx-learning store; reference: configured static ARP
// entries per pod link, plugins/contiv/pod.go:375-452). Open-addressed
// hash, capacity a power of two, insert-only — overwrites refresh, a
// full probe run evicts an UNPINNED slot in the run, occupancy never
// clears, so probe chains stay intact without tombstones. Static
// control-plane entries are pinned: rx learning can refresh their MAC
// but never evict them for an unrelated IP (a silent pod's entry must
// survive table pressure or its no-flood guarantee is gone).
//
// Concurrency: the rx thread learns, the tx thread looks up and the
// control thread installs static entries, all GIL-free (ctypes calls
// release the GIL). Per-slot u32 SEQUENCE word: 0 = never written
// (ends a probe chain), odd = write in progress, even>0 = valid
// version. Writers take the slot with a CAS to odd (mutual exclusion —
// concurrent writers retry the probe), write ip+mac, publish seq+2.
// Readers snapshot the sequence, copy, and re-check sequence equality:
// any complete rewrite during the copy changed the version (no ABA),
// so a torn 6-byte MAC can never be returned — the reader degrades to
// a miss (broadcast), never misdelivery. ----

constexpr uint32_t kMacProbe = 16;

static inline uint32_t mac_hash(uint32_t ip) { return ip * 0x9e3779b1u; }

// Returns 1 when the entry was installed, 0 when dropped (probe run
// fully pinned for an UNPINNED learn, or pathological CAS contention),
// and 2 when installing required evicting a DIFFERENT ip's pinned
// entry (kPinnedVictim displacement): the entry IS installed, but the
// displaced pod lost its static-ARP guarantee — the caller must
// surface the displacement to the control plane, not treat it as a
// clean install. A pinned (control-plane) put never drops for pin
// pressure: statics outrank learned entries AND each other's slots —
// the caller surfaces a 0 as an RPC error instead of silently not
// installing.
int32_t pio_mac_put(uint32_t* ips, uint8_t* macs, uint32_t* seq,
                    uint8_t* pin, uint32_t cap, uint32_t ip,
                    const uint8_t* mac, uint32_t pin_flag) {
  uint32_t mask = cap - 1;
  uint32_t h = mac_hash(ip) & mask;
  enum { kEmpty, kRefresh, kVictim, kPinnedVictim };
  for (uint32_t attempt = 0; attempt < 64; attempt++) {
    // pick a slot: empty, same-ip refresh, or (last resort) the first
    // unpinned slot of the probe run; a pinned put may evict a pinned
    // victim when everything is pinned
    int32_t slot = -1, victim = -1;
    int kind = kEmpty;
    for (uint32_t probe = 0; probe < kMacProbe; probe++) {
      uint32_t s = (h + probe) & mask;
      uint32_t sq = __atomic_load_n(&seq[s], __ATOMIC_ACQUIRE);
      if (sq == 0) {
        slot = static_cast<int32_t>(s);
        kind = kEmpty;
        break;
      }
      if (__atomic_load_n(&ips[s], __ATOMIC_ACQUIRE) == ip) {
        slot = static_cast<int32_t>(s);
        kind = kRefresh;
        break;
      }
      if (victim < 0 && !pin[s]) victim = static_cast<int32_t>(s);
    }
    if (slot < 0 && victim >= 0) {
      slot = victim;
      kind = kVictim;
    }
    if (slot < 0) {
      if (!pin_flag) return 0;  // whole run pinned: drop the learn
      slot = static_cast<int32_t>(h);  // static outranks static: home
      kind = kPinnedVictim;
    }
    uint32_t s = static_cast<uint32_t>(slot);
    uint32_t sq = __atomic_load_n(&seq[s], __ATOMIC_ACQUIRE);
    if (sq & 1) continue;  // another writer mid-flight: re-probe
    // claim the slot (writer mutual exclusion)
    if (!__atomic_compare_exchange_n(&seq[s], &sq, sq + 1, false,
                                     __ATOMIC_ACQ_REL, __ATOMIC_ACQUIRE)) {
      continue;  // lost the race: re-probe
    }
    // re-validate the selection criteria UNDER the claim: between
    // selection and the CAS another writer may have completed a full
    // cycle (the CAS only proves seq didn't change since our re-read),
    // e.g. a pinned static landing in "our" empty slot — overwriting
    // it here would evict the very entry pinning protects
    bool ok = true;
    if (kind == kEmpty) {
      ok = (sq == 0);
    } else if (kind == kRefresh) {
      ok = (__atomic_load_n(&ips[s], __ATOMIC_ACQUIRE) == ip);
    } else if (kind == kVictim) {
      ok = !pin[s];
    }  // kPinnedVictim: unconditional — control plane wins
    if (!ok) {
      __atomic_store_n(&seq[s], sq, __ATOMIC_RELEASE);  // release claim
      continue;  // re-probe with fresh state
    }
    // a pinned-victim overwrite of ANOTHER ip's pinned slot displaces
    // that static entry — report it distinctly (checked under the
    // claim, so the displaced identity is stable)
    bool displaced =
        kind == kPinnedVictim && pin[s] &&
        __atomic_load_n(&ips[s], __ATOMIC_ACQUIRE) != ip;
    __atomic_store_n(&ips[s], ip, __ATOMIC_RELEASE);
    std::memcpy(macs + static_cast<uint64_t>(s) * 6u, mac, 6);
    if (pin_flag) {
      pin[s] = 1;
    } else if (kind == kEmpty || kind == kVictim) {
      // a learned entry occupying a slot must not inherit a stale pin
      // (slot may have held a static for a since-deleted pod)
      pin[s] = 0;
    }
    __atomic_store_n(&seq[s], sq + 2, __ATOMIC_RELEASE);  // publish
    return displaced ? 2 : 1;
  }
  return 0;  // pathological contention: caller decides (learns drop)
}

int32_t pio_mac_get(const uint32_t* ips, const uint8_t* macs,
                    const uint32_t* seq, uint32_t cap, uint32_t ip,
                    uint8_t* out) {
  uint32_t mask = cap - 1;
  uint32_t h = mac_hash(ip) & mask;
  for (uint32_t probe = 0; probe < kMacProbe; probe++) {
    uint32_t s = (h + probe) & mask;
    uint32_t s1 = __atomic_load_n(&seq[s], __ATOMIC_ACQUIRE);
    if (s1 == 0) return 0;              // chain end
    if (s1 & 1) continue;               // mid-write: probe on
    if (__atomic_load_n(&ips[s], __ATOMIC_ACQUIRE) != ip) continue;
    std::memcpy(out, macs + static_cast<uint64_t>(s) * 6u, 6);
    __atomic_thread_fence(__ATOMIC_ACQUIRE);
    // sequence unchanged == no rewrite overlapped the copy (a full
    // rewrite bumps the version by 2, so ABA cannot slip through)
    if (__atomic_load_n(&seq[s], __ATOMIC_ACQUIRE) == s1) return 1;
    return 0;                            // torn: miss (broadcast)
  }
  return 0;
}

// Unpin a static entry when its interface is unwired. The table is
// insert-only (probe chains rely on seq==0 terminators, no
// tombstones), so "delete" means dropping the pin: the entry becomes
// an ordinary learned entry — evictable under probe pressure and
// refreshable by rx learning — instead of permanently occupying
// pin-limited space for an interface that no longer exists. Returns 1
// if an entry for ip was found, else 0.
int32_t pio_mac_unpin(uint32_t* ips, uint8_t* pin, uint32_t* seq,
                      uint32_t cap, uint32_t ip) {
  uint32_t mask = cap - 1;
  uint32_t h = mac_hash(ip) & mask;
  for (uint32_t attempt = 0; attempt < 64; attempt++) {
    for (uint32_t probe = 0; probe < kMacProbe; probe++) {
      uint32_t s = (h + probe) & mask;
      uint32_t sq = __atomic_load_n(&seq[s], __ATOMIC_ACQUIRE);
      if (sq == 0) return 0;            // chain end: not present
      if (sq & 1) goto retry;           // mid-write: restart the probe
      if (__atomic_load_n(&ips[s], __ATOMIC_ACQUIRE) != ip) continue;
      // claim like a writer so a concurrent put can't re-pin under us
      if (!__atomic_compare_exchange_n(&seq[s], &sq, sq + 1, false,
                                       __ATOMIC_ACQ_REL,
                                       __ATOMIC_ACQUIRE)) {
        goto retry;
      }
      if (__atomic_load_n(&ips[s], __ATOMIC_ACQUIRE) == ip) pin[s] = 0;
      __atomic_store_n(&seq[s], sq + 2, __ATOMIC_RELEASE);
      return 1;
    }
    return 0;                            // probed the whole run
  retry:;
  }
  return 0;  // pathological contention
}

// Learn (src_ip -> source MAC) for every valid IPv4 packet of a parsed
// frame in one pass — replaces a per-packet Python loop that capped
// the rx path at ~1 Mpps. flags/src are the frame's column arrays.
void pio_mac_learn(uint32_t* ips, uint8_t* macs, uint32_t* seq,
                   uint8_t* pin, uint32_t cap, const int32_t* flags,
                   const int32_t* src, const uint8_t* payload,
                   uint32_t snap, uint32_t n) {
  if (n > kVec) n = kVec;
  for (uint32_t i = 0; i < n; i++) {
    if (!(flags[i] & kFlagValid) || (flags[i] & kFlagNonIp4)) continue;
    pio_mac_put(ips, macs, seq, pin, cap, static_cast<uint32_t>(src[i]),
                payload + static_cast<uint64_t>(i) * snap + 6, 0);
  }
}

// Batch VXLAN decap for frames resident in payload rows (the uplink rx
// path: every inter-node packet arrives encapsulated, and a per-packet
// ctypes decap call capped that path at well under 1 Mpps): for each
// row whose bytes are a VXLAN datagram of segment `vni`, shift the
// inner frame to the row start and shrink lens[i]. Returns the number
// of rows decapped.
uint32_t pio_decap_batch(uint8_t* payload, uint32_t snap, uint32_t* lens,
                         uint32_t n, uint32_t vni) {
  if (n > kVec) n = kVec;
  uint32_t decapped = 0;
  for (uint32_t i = 0; i < n; i++) {
    uint8_t* row = payload + static_cast<uint64_t>(i) * snap;
    uint32_t len = lens[i] < snap ? lens[i] : snap;
    uint32_t off = pio_decap_offset(row, len, vni);
    if (!off) continue;
    uint32_t inner = len - off;
    std::memmove(row, row + off, inner);
    lens[i] = inner;
    decapped++;
  }
  return decapped;
}

// Batch VXLAN encap + transmit for REMOTE-disposed rows (the
// vxlan-encap -> interface-output chain; completes the native tx path —
// pio_tx_dispatch hands these rows back by index, and a per-packet
// Python encap+send would cap inter-node traffic the way the local
// path used to be capped). Each inner frame is wrapped into its
// scratch row (outer Ethernet+IPv4+UDP+VXLAN via pio_encap, dst MAC
// from the neighbor table, flow-entropy source port), then the batch
// goes out in sendmmsg chunks (or write() for a TAP uplink).
// Returns frames sent.
int32_t pio_encap_tx_batch(const int32_t* cols, const uint8_t* payload,
                           uint32_t snap, const uint32_t* rows, uint32_t n,
                           uint32_t vtep_ip, uint32_t vni,
                           const uint8_t* src_mac,
                           const uint32_t* mac_ips, const uint8_t* mac_macs,
                           const uint32_t* mac_seq, uint32_t mac_cap,
                           int32_t fd, uint32_t fd_is_sock,
                           uint8_t* scratch, uint32_t scratch_stride) {
  const int32_t* pkt_len = cols + kPktLen * kVec;
  const int32_t* next_hop = cols + kNextHop * kVec;
  const int32_t* dst_ip = cols + kDstIp * kVec;
  if (n > kVec) n = kVec;
  uint32_t out_lens[kVec], k = 0;
  uint8_t bcast[6];
  std::memset(bcast, 0xff, 6);
  for (uint32_t j = 0; j < n; j++) {
    uint32_t row = rows[j];
    if (row >= kVec) continue;
    uint32_t wire = static_cast<uint32_t>(pkt_len[row]) + kEthHdr;
    if (wire > snap) wire = snap;
    if (wire + 50 > scratch_stride) continue;  // no headroom: skip
    uint32_t nh = static_cast<uint32_t>(next_hop[row]);
    uint8_t dst_mac[6];
    if (!pio_mac_get(mac_ips, mac_macs, mac_seq, mac_cap, nh, dst_mac)) {
      std::memcpy(dst_mac, bcast, 6);
    }
    out_lens[k] = pio_encap(
        payload + static_cast<uint64_t>(row) * snap, wire, vtep_ip, nh,
        static_cast<uint16_t>(
            49152 + (static_cast<uint32_t>(dst_ip[row]) & 0x3FFF)),
        vni, src_mac, dst_mac,
        scratch + static_cast<uint64_t>(k) * scratch_stride);
    k++;
  }
  if (!k) return 0;
  // encapped frames are compacted sequentially into scratch rows
  if (fd_is_sock) {
    return pio_send_batch(fd, scratch, scratch_stride, identity_rows(),
                          out_lens, k);
  }
  return write_rows(fd, scratch, scratch_stride, identity_rows(),
                    out_lens, k);
}

// ---- tx dispatch: one native pass over a tx frame (the
// interface-output node; reference: VPP's l2/ip4-rewrite +
// interface-output run per vector in C, never per packet in a slow
// layer). Validity/trunc policy, disposition switch, Ethernet
// addressing from the neighbor table, per-egress-interface batching,
// sendmmsg (sockets) or write() (TAP char devices). REMOTE packets
// with a VXLAN next-hop are returned to the caller for encap.
//
// counters: [0]=tx_pkts [1]=tx_drops [2]=tx_punts [3]=trunc_drops
//           [4]=n_remote (rows listed in remote_rows)
void pio_tx_dispatch(const int32_t* cols, uint8_t* payload, uint32_t snap,
                     uint32_t n, const int32_t* if_indices,
                     const int32_t* if_fds, const uint8_t* if_sock,
                     const uint8_t* if_macs, uint32_t n_if,
                     int32_t uplink_if, int32_t host_if,
                     const uint32_t* mac_ips, const uint8_t* mac_macs,
                     const uint32_t* mac_seq, uint32_t mac_cap,
                     uint32_t* remote_rows, uint32_t* counters) {
  const int32_t* flags = cols + kFlags * kVec;
  const int32_t* disp = cols + kDisp * kVec;
  // tx direction: the rx_if column carries the EGRESS interface
  const int32_t* tx_if = cols + kRxIf * kVec;
  const int32_t* dst_ip = cols + kDstIp * kVec;
  const int32_t* next_hop = cols + kNextHop * kVec;
  const int32_t* pkt_len = cols + kPktLen * kVec;
  if (n > kVec) n = kVec;

  int16_t assign[kVec];
  uint32_t wlen[kVec];

  for (uint32_t i = 0; i < n; i++) {
    assign[i] = -1;
    int32_t f = flags[i];
    if (!(f & kFlagValid)) continue;
    if (f & kFlagTrunc) {
      // captured < claimed bytes: transmitting would pad with residual
      // slot data (cross-flow leak) — drop and make it visible
      counters[3]++;
      continue;
    }
    uint32_t wire = static_cast<uint32_t>(pkt_len[i]) + kEthHdr;
    if (wire > snap) wire = snap;
    int32_t d = disp[i];
    int32_t target = -1;
    bool set_mac = true;
    if (d == 0) {  // DROP
      counters[1]++;
      continue;
    } else if (d == 1) {  // LOCAL
      target = tx_if[i];
    } else if (d == 2) {  // REMOTE
      if (next_hop[i] != 0) {
        remote_rows[counters[4]++] = i;  // caller VXLAN-encapsulates
        continue;
      }
      target = uplink_if;
    } else if (d == 3) {  // HOST
      // Raw punts (non-IPv4, bypassed the pipeline) keep the original
      // Ethernet intact — STN semantics. Pipeline-ROUTED host traffic
      // (a FIB route with HOST disposition: the VPP↔host interconnect,
      // host.go:92-110) is a routed hop: it must be re-addressed to the
      // host stack's MAC or the kernel on the interconnect veth drops
      // the frame as not-for-me.
      target = host_if;
      set_mac = !(f & kFlagNonIp4);
    } else {
      counters[1]++;
      continue;
    }
    int slot = -1;
    for (uint32_t s = 0; s < n_if; s++) {
      if (if_indices[s] == target) {
        slot = static_cast<int>(s);
        break;
      }
    }
    if (slot < 0 || wire < kEthHdr) {
      counters[1]++;
      continue;
    }
    if (set_mac) {
      uint8_t* raw = payload + static_cast<uint64_t>(i) * snap;
      if (!pio_mac_get(mac_ips, mac_macs, mac_seq, mac_cap,
                       static_cast<uint32_t>(dst_ip[i]), raw)) {
        std::memset(raw, 0xff, 6);  // broadcast fallback
      }
      std::memcpy(raw + 6, if_macs + static_cast<uint64_t>(slot) * 6u, 6);
    }
    assign[i] = static_cast<int16_t>(slot);
    wlen[i] = wire;
  }

  for (uint32_t s = 0; s < n_if; s++) {
    uint32_t rows[kVec], lens[kVec], k = 0;
    for (uint32_t i = 0; i < n; i++) {
      if (assign[i] == static_cast<int16_t>(s)) {
        rows[k] = i;
        lens[k] = wlen[i];
        k++;
      }
    }
    if (!k) continue;
    int32_t sent;
    if (if_sock[s]) {
      sent = pio_send_batch(if_fds[s], payload, snap, rows, lens, k);
    } else {  // TAP char device: one write per frame
      sent = write_rows(if_fds[s], payload, snap, rows, lens, k);
    }
    bool punt = if_indices[s] == host_if;
    counters[punt ? 2 : 0] += static_cast<uint32_t>(sent);
    counters[1] += k - static_cast<uint32_t>(sent);
  }
}

}  // extern "C"
