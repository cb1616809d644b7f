"""IO daemon: pumps packets between transports and the frame rings.

The port's copy of ``vpp_tpu/io/daemon.py`` over the port's native
codec (``native/pktio.py``) and rings (``io/rings.py``). It is host
code only: it never imports torch, so a daemon process takes no CUDA
context; the agent's pump owns the card.

The process that plays VPP's input/output nodes (af-packet-input →
ethernet-input on rx; ip4-rewrite → interface-output on tx): an rx
thread select()s across all transports, batch-parses raw frames through
the native codec into the rx ring; a tx thread drains the tx ring,
applies native header rewrite (NAT results, TTL, checksums), VXLAN-
encapsulates remote-bound packets toward their peer VTEP, and transmits
per disposition. Ethernet addressing uses learned (ip → MAC) mappings
from rx traffic with broadcast fallback — the ARP analog for the
directly-attached pod links the reference configures static ARP for
(plugins/contiv/pod.go:375-452).
"""

from __future__ import annotations

import logging
import select
import threading
import time
from typing import Dict, Optional

import numpy as np

from vpp_tpu_torch.io.rings import IORingPair, VEC
from vpp_tpu_torch.io.transport import Transport
from vpp_tpu_torch.native.pktio import MacTable, PacketCodec

log = logging.getLogger("io_daemon")


class IODaemon:
    def __init__(
        self,
        rings: IORingPair,
        transports: Dict[int, Transport],
        uplink_if: int,
        host_if: Optional[int] = None,
        vtep_ip: int = 0,
        vni: int = 10,
        poll_s: float = 0.0002,
        rx_push_wait_s: float = 0.02,
    ):
        """``rx_push_wait_s``: how long a full rx ring backpressures
        the rx thread before the parsed batch is dropped. While the
        thread waits, later frames queue in the (64 MB-deep) kernel
        sockets instead of dying between the transport and the pump —
        a transient pump stall (jit ramp, GC, a chained fold draining)
        then costs queueing delay, not loss. 0 restores drop-on-full."""
        self.rings = rings
        self.transports = dict(transports)
        self.uplink_if = uplink_if
        self.host_if = host_if
        self.vtep_ip = vtep_ip
        self.vni = vni
        self.poll_s = poll_s
        self.rx_push_wait_s = rx_push_wait_s
        self.codec = PacketCodec(snap=rings.rx.snap)
        self._scratch = np.zeros((VEC, rings.rx.snap), np.uint8)
        self._rx_lens = np.zeros(VEC, np.uint32)
        # native neighbor table: rx learning + static entries, consulted
        # inside the per-frame native calls (never per packet in Python)
        self.mac = MacTable()
        # VXLAN encap staging: outer headers add 50 bytes of headroom
        self._encap_scratch = np.zeros((VEC, rings.rx.snap + 64), np.uint8)
        self.stats = {
            "rx_frames": 0, "rx_pkts": 0, "rx_ring_full": 0,
            "rx_ring_waits": 0,
            # rx-ring overflow drops in PACKETS (rx_ring_full counts
            # frames): the rx_full cause of the pump drop accounting
            # (vpp_tpu_pump_drops_total{reason="rx_full"})
            "drops_rx_full": 0,
            "tx_frames": 0, "tx_pkts": 0, "tx_drops": 0, "tx_punts": 0,
            "trunc_drops": 0, "vxlan_encap": 0, "vxlan_decap": 0,
        }
        self._stop = threading.Event()
        self._threads = []

    # --- runtime interface management (driven by IOControlServer; the
    # reference analog is the CNI server creating pod TAP/veth
    # interfaces in the running vswitch, remote_cni_server.go:895-1250) ---
    def attach(self, if_idx: int, kind: str, arg: str) -> None:
        """Create a transport and plug it in as interface ``if_idx``.
        Replaces (and closes) any previous transport on that index —
        attach is idempotent for agent resync."""
        from vpp_tpu_torch.io.transport import make_transport

        new = make_transport(kind, arg)
        old = self.transports.get(if_idx)
        self.transports[if_idx] = new  # dict assignment: GIL-atomic
        if old is not None:
            old.close()
        log.info("attached if %d: %s(%s)", if_idx, kind, arg)

    def detach(self, if_idx: int) -> bool:
        t = self.transports.pop(if_idx, None)
        if t is None:
            return False
        t.close()
        log.info("detached if %d (%s)", if_idx, t.name)
        return True

    def set_static_mac(self, ip: int, mac: bytes) -> bool:
        """Static (ip → MAC) entry — the reference's configured static
        ARP for pod links (pod.go:375-452); rx learning keeps it fresh
        but the first packet toward a silent pod no longer floods.
        Returns True when installing evicted ANOTHER pod's pinned entry
        (probe run fully pinned): that pod lost its no-flood guarantee,
        and the caller must surface the displacement, not treat the
        install as clean."""
        rc = self.mac.put(int(ip), bytes(mac))
        if not rc:
            # surfaced as an RPC error through the control socket: a
            # silently missing static means permanent broadcast flood
            raise RuntimeError("neighbor table rejected static entry")
        if rc == 2:
            log.warning(
                "static MAC for ip %#x displaced another pinned entry "
                "(neighbor table pin pressure)", ip,
            )
        return rc == 2

    def del_static_mac(self, ip: int) -> bool:
        """Unpin a static entry when its interface is unwired (CNI
        Delete / interconnect teardown). The entry becomes an ordinary
        learned entry — evictable, refreshable — instead of occupying
        pin-limited neighbor-table space for a dead interface. True if
        an entry existed."""
        return self.mac.unpin(int(ip))

    # --- lifecycle ---
    def start(self) -> "IODaemon":
        for fn, name in ((self._rx_loop, "io-rx"), (self._tx_loop, "io-tx")):
            t = threading.Thread(target=fn, daemon=True, name=name)
            t.start()
            self._threads.append(t)
        return self

    def stop(self, join_timeout: Optional[float] = None) -> bool:
        """Stop rx/tx threads; unbounded join by default — callers free
        the ring buffers next, so returning with a live thread would be
        a use-after-free into shared memory."""
        self._stop.set()
        ok = True
        for t in self._threads:
            t.join(timeout=join_timeout)
            ok = ok and not t.is_alive()
        return ok

    # --- rx: wire -> ring ---
    def _rx_loop(self) -> None:
        while not self._stop.is_set():
            # The control thread mutates transports at runtime
            # (attach/detach); a transport closed between the snapshot
            # and the select/recv surfaces as ValueError (fileno -1) or
            # OSError — both are routine during a CNI Delete and must
            # never kill the rx thread (that would silently stop ALL
            # packet reception on the node).
            try:
                fds = {t.fileno(): (if_idx, t)
                       for if_idx, t in list(self.transports.items())
                       if t.fileno() >= 0}
                if not fds:
                    time.sleep(0.05)
                    continue
                ready, _, _ = select.select(list(fds), [], [], 0.05)
                for fd in ready:
                    if_idx, transport = fds[fd]
                    bfd = transport.batch_fd
                    if bfd is not None:
                        # native fast path: recvmmsg straight into the
                        # payload scratch rows, zero bytes objects.
                        # Drain in a burst (bounded so one flooding
                        # interface can't starve the rest): a single
                        # batch per select wake caps rx at
                        # VEC / wake-latency and drops the rest in the
                        # kernel queue.
                        for _ in range(16):
                            n = self.codec.recv_batch(
                                bfd, self._scratch, self._rx_lens
                            )
                            if n <= 0:
                                break
                            self._ingest_scratch(if_idx, n)
                            if n < VEC:
                                break
                    else:
                        frames = transport.recv_frames(VEC)
                        if frames:
                            self._ingest(if_idx, frames)
            except (OSError, ValueError):
                continue
            except Exception:
                log.exception("rx iteration failed; continuing")

    def _ingest(self, if_idx: int, frames: list) -> None:
        if if_idx == self.uplink_if:
            # VXLAN datagrams from peer nodes carry the inner frame
            unwrapped = []
            for f in frames:
                off = self.codec.decap_offset(f, self.vni)
                if off:
                    self.stats["vxlan_decap"] += 1
                    unwrapped.append(f[off:])
                else:
                    unwrapped.append(f)
            frames = unwrapped
        for start in range(0, len(frames), VEC):
            chunk = frames[start:start + VEC]
            cols, n = self.codec.parse(chunk, if_idx, self._scratch)
            self.mac.learn(cols, self._scratch, n)
            if self._rx_push(cols, n):
                self.stats["rx_frames"] += 1
                self.stats["rx_pkts"] += n
            else:
                self.stats["rx_ring_full"] += 1
                self.stats["drops_rx_full"] += n

    def _ingest_scratch(self, if_idx: int, n: int) -> None:
        """Batch-received frames already sit in scratch rows: decap
        VXLAN on the uplink (in-row shift), parse in place, push."""
        lens = self._rx_lens
        if if_idx == self.uplink_if:
            self.stats["vxlan_decap"] += self.codec.decap_batch(
                self._scratch, lens, n, self.vni
            )
        cols, n = self.codec.parse_inplace(self._scratch, lens, n, if_idx)
        self.mac.learn(cols, self._scratch, n)
        if self._rx_push(cols, n):
            self.stats["rx_frames"] += 1
            self.stats["rx_pkts"] += n
        else:
            self.stats["rx_ring_full"] += 1
            self.stats["drops_rx_full"] += n

    def _rx_push(self, cols, n: int) -> bool:
        """Push one parsed frame, backpressuring briefly on a full
        ring (constructor doc). The retry sleeps at pump-poll
        granularity so a freed slot is taken within ~poll_s."""
        if self.rings.rx.push(cols, n, payload=self._scratch):
            return True
        deadline = time.monotonic() + self.rx_push_wait_s
        waited = False
        while time.monotonic() < deadline and not self._stop.is_set():
            waited = True
            time.sleep(self.poll_s)
            if self.rings.rx.push(cols, n, payload=self._scratch):
                if waited:
                    self.stats["rx_ring_waits"] += 1
                return True
        return False

    # --- tx: ring -> wire ---
    def _tx_loop(self) -> None:
        rings = self.rings
        while not self._stop.is_set():
            frame = rings.tx.peek()
            if frame is None:
                time.sleep(self.poll_s)
                continue
            try:
                self._transmit(frame)
            except Exception:
                log.exception("tx frame failed")
            rings.tx.release()
            self.stats["tx_frames"] += 1

    def _iface_arrays(self):
        """Snapshot the transport set into the parallel arrays the
        native dispatch consumes (if index, send fd, socket?, MAC).
        Transports mutate at runtime (attach/detach) so this is built
        per frame — a handful of entries, microseconds."""
        items = list(self.transports.items())
        idx = np.array([i for i, _ in items], np.int32)
        fds = np.zeros(len(items), np.int32)
        sock = np.zeros(len(items), np.uint8)
        macs = np.zeros((len(items), 6), np.uint8)
        for s, (_, t) in enumerate(items):
            bfd = t.batch_fd
            if bfd is not None:
                fds[s], sock[s] = bfd, 1
            else:
                # TAP char device: native path write()s per frame
                fds[s], sock[s] = t.fileno(), 0
            macs[s] = np.frombuffer(t.mac, np.uint8)
        return idx, fds, sock, macs

    def _transmit(self, frame) -> None:
        from vpp_tpu_torch.native.pktio import flatten_cols

        cols, n, payload = frame.cols, frame.n, frame.payload
        # flatten the slot columns ONCE; rewrite + dispatch share it
        flat = flatten_cols(cols)
        # native rewrite: NAT/TTL results patched into the raw bytes with
        # checksum fixes (no-op for untouched packets)
        self.codec.rewrite(flat, payload, n)
        # native dispatch: policy checks, Ethernet addressing from the
        # neighbor table, per-egress batching and transmission in ONE
        # C pass — the per-packet Python loop it replaces capped the tx
        # path at ~0.34 Mpps; VPP runs this whole node in C per vector
        idx, fds, sock, macs = self._iface_arrays()
        counters, remote = self.codec.tx_dispatch(
            flat, payload, n, idx, fds, sock, macs,
            self.uplink_if,
            self.host_if if self.host_if is not None else -2,
            self.mac,
        )
        self.stats["tx_pkts"] += int(counters[0])
        self.stats["tx_drops"] += int(counters[1])
        self.stats["tx_punts"] += int(counters[2])
        self.stats["trunc_drops"] += int(counters[3])

        # REMOTE rows with a peer next-hop: batch VXLAN encap toward
        # the VTEPs + transmit, one native pass (vxlan-encap →
        # interface-output; inter-node traffic is a majority in real
        # clusters, so this path gets the same treatment as local tx)
        n_remote = int(counters[4])
        if n_remote:
            uplink = self.transports.get(self.uplink_if)
            if uplink is None:
                self.stats["tx_drops"] += n_remote
                return
            bfd = uplink.batch_fd
            sent = self.codec.encap_tx_batch(
                flat, payload, remote, n_remote,
                self.vtep_ip, self.vni, uplink.mac, self.mac,
                bfd if bfd is not None else uplink.fileno(),
                bfd is not None,
                self._encap_scratch,
            )
            self.stats["vxlan_encap"] += sent
            self.stats["tx_pkts"] += sent
            self.stats["tx_drops"] += n_remote - sent
