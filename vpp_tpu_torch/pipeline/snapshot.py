"""Crash-consistent incremental session snapshots, restore and range migration.

The port of ``vpp_tpu/pipeline/snapshot.py``, in its on-disk format: the
session tables split into fixed bucket-range chunks (``chunk_buckets``
buckets of every column of a table, one ``[C, CB, W]`` int32 block a
chunk), a per-chunk content digest computed on the device so a snapshot
drains only the chunks whose digest moved since the last published
manifest, every chunk file written and fsync'd before the manifest that
gives it meaning is published by an atomic rename, a CRC32 on every
chunk, and a restore that either loads and verifies a whole generation
or refuses cleanly (a cold start, never a half-restored table). The
digest equals the reference's bit for bit (the uint32 wrap runs through
int64 with a mask after every multiply, as pipeline/vector.py fixes
it), so the two packages' snapshot directories restore into each other.

Consistency. The reference drains one immutable tables pytree taken
under the dataplane lock. The port's session tensors are written in
place by every step, so draining them outside the lock would write a
snapshot whose chunks come from different steps (a NAT session paired
with a reflective session of another epoch). ``_drain`` instead clones
the 17 session columns and the two sweep cursors on the device under
``dp._lock`` into buffers it keeps — one device-to-device pass, ordered
on the stream before any later step — releases the lock, and digests
and drains the copy through a pinned host buffer. ``stats["lock_hold_ms"]`` is the host time
the lock was held; the range drain clones only its range the same way.

Restore and migration write into the live tensors (``Dataplane.
adopt_sessions``), so no captured step program is rebuilt. Timestamps
rebase as in the reference: ``time' = time - snap_now`` at restore (ages
preserved across the restart), ``time - now_src + now_dst`` for a
migrated range.

Fault seams (vpp_tpu_torch/testing/faults.py): ``snapshot.chunk`` fires
inside a chunk write and leaves a torn file, ``snapshot.manifest`` before
the atomic rename, ``fleet.migrate`` before each drained range chunk.
"""

from __future__ import annotations

import functools
import json
import logging
import os
import struct
import threading
import time
import zlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from vpp_tpu_torch.ops.session import _mul32
from vpp_tpu_torch.pipeline.tables import (
    SESSION_FIELDS,
    natsess_slots_of,
    state_shapes,
)
from vpp_tpu_torch.pipeline.transfer import count_device_transfer
from vpp_tpu_torch.pipeline.vector import u32
from vpp_tpu_torch.testing import faults

log = logging.getLogger("vpp_tpu_torch.snapshot")

MANIFEST = "manifest.json"
FORMAT_VERSION = 1
_MAGIC = b"VPPSNAP1"
_HDR = struct.Struct("<8sII")  # magic, crc32(payload), payload length
_M32 = 0xFFFFFFFF


def _table_of(field: str) -> str:
    return ("scalar" if field.endswith("_sweep_cursor")
            else "natsess" if field.startswith("natsess_") else "sess")


# per-table column lists, in SESSION_FIELDS order (the chunk payload
# layout: restore relies on the same order)
TABLE_COLS: Dict[str, Tuple[str, ...]] = {
    t: tuple(k for k in SESSION_FIELDS if _table_of(k) == t)
    for t in ("sess", "natsess")
}
SCALAR_FIELDS: Tuple[str, ...] = tuple(
    k for k in SESSION_FIELDS if _table_of(k) == "scalar")

# restore outcomes (the reference's label axis)
RESTORE_OUTCOMES = (
    "restored", "no_manifest", "bad_manifest", "version", "geometry",
    "missing_chunk", "crc_mismatch", "error",
)


@functools.lru_cache(maxsize=8)
def _fetch_fn(chunk_buckets: int):
    """The chunk fetch of one bucket range: every column's
    ``[chunk_buckets, W]`` rows from ``start`` stacked into ONE
    ``[C, CB, W]`` int32 block on the device (one device-to-host copy a
    chunk)."""
    def fetch(cols, start: int) -> torch.Tensor:
        return torch.stack([c[start:start + chunk_buckets] for c in cols])

    return fetch


@functools.lru_cache(maxsize=8)
def _digest_fn(chunk_buckets: int):
    """The per-chunk content digest of the reference: fold every column
    elementwise (``acc * 0x9E3779B1 + u``), finalise per slot, then
    weight by position (``2i + 1``) and sum within each chunk, all mod
    2^32. Returns ``[n_chunks]`` int64 holding the uint32 values."""
    def digest(cols) -> torch.Tensor:
        acc = None
        for c in cols:
            u = u32(c).reshape(c.shape[0] // chunk_buckets, -1)
            acc = u if acc is None else (_mul32(acc, 0x9E3779B1) + u) & _M32
        e = acc ^ (acc >> 15)
        e = _mul32(e, 0x2545F491)
        e = e ^ (e >> 13)
        pos = (torch.arange(e.shape[1], dtype=torch.int64,
                            device=e.device) << 1) | 1
        return _mul32(e, pos).sum(dim=1) & _M32

    return digest


def _chunk_name(table: str, idx: int, gen: int,
                node: Optional[int] = None) -> str:
    if node is None:
        return f"{table}-{idx:05d}-g{gen}.chunk"
    return f"{table}-n{node:03d}-{idx:05d}-g{gen}.chunk"


def _fsync_dir(path: str) -> None:
    """fsync a directory, so the entries of the fsync'd chunk files (and
    the manifest's rename) are durable too. Best effort: some file
    systems refuse it."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _geometry_of(config) -> Dict[str, int]:
    return {
        "sess_slots": int(config.sess_slots),
        "sess_ways": int(config.sess_ways),
        "natsess_slots": int(natsess_slots_of(config)),
    }


def _mesh_of(dp) -> Optional[Dict[str, int]]:
    """The mesh geometry of a cluster handle (None for a standalone
    Dataplane), recorded in the manifest and REFUSED on mismatch at
    restore: a per-shard drain's bucket ranges mean something only on
    the mesh that drained them."""
    mesh = getattr(dp, "mesh", None)
    if mesh is None:
        return None
    from vpp_tpu_torch.parallel.partition import NODE_AXIS, RULE_AXIS

    return {"n_nodes": int(mesh.shape[NODE_AXIS]),
            "rule_shards": int(mesh.shape[RULE_AXIS])}


def _to_host(block: torch.Tensor) -> np.ndarray:
    """A block as host numpy; from the card through a pinned buffer (the
    pinned allocator recycles it once the array is dropped)."""
    if block.device.type != "cuda":
        return block.numpy()
    pinned = torch.empty(block.shape, dtype=block.dtype, pin_memory=True)
    pinned.copy_(block)
    return pinned.numpy()


def _session_clone(dp, fields, rows=...,
                   into: Optional[Dict[str, torch.Tensor]] = None):
    """Device copies of ``fields`` (``rows`` of each: a slice, or all of
    it), taken under
    ``dp._lock`` into ``into`` (buffers of their shapes, allocated
    before the lock when not given), the drain clock, and the host ms
    the lock was held. A step that runs after the lock is released is
    ordered after the copies on the stream, so they are one step's
    state."""
    tables = dp.tables
    if tables is None:
        raise RuntimeError("the dataplane has no live tables")
    if into is None:
        into = {f: torch.empty_like(getattr(tables, f)[rows])
                for f in fields}
    with dp._lock:
        t0 = time.perf_counter()
        tables = dp.tables
        now = max(dp._now, dp.clock_ticks())
        for f in fields:
            into[f].copy_(getattr(tables, f)[rows])
        hold_ms = (time.perf_counter() - t0) * 1e3
    return into, int(now), hold_ms


class SessionSnapshotter:
    """Owns one snapshot directory for one dataplane.

    ``snapshot()`` / ``maybe_snapshot()`` run on one caller (a
    maintenance thread); a concurrent call returns None instead of
    stacking drains. ``stats_snapshot()`` and ``degraded`` are safe from
    any thread."""

    def __init__(self, dataplane, directory: str,
                 chunk_buckets: int = 4096, pace_s: float = 0.0):
        self.dp = dataplane
        self.directory = directory
        if chunk_buckets <= 0 or (chunk_buckets & (chunk_buckets - 1)):
            raise ValueError(
                f"snapshot_chunk_buckets must be a power of two, got "
                f"{chunk_buckets}")
        self.chunk_buckets = int(chunk_buckets)
        self.pace_s = float(pace_s)
        self._lock = threading.Lock()
        self._snapping = False
        # the device buffers each drain copies the live columns into
        # (allocated by the first drain, outside the dataplane's lock)
        self._copy: Optional[Dict[str, torch.Tensor]] = None
        # the last PUBLISHED manifest: the diff base of the next drain
        # (loaded at construction, so the first snapshot after a restart
        # is incremental too)
        self._manifest: Optional[dict] = None
        self.stats = {
            "generation": 0,
            "snapshots": 0,
            "snapshot_failures": 0,
            "consecutive_failures": 0,
            "chunks_written": 0,
            "chunks_skipped": 0,
            "bytes_written": 0,
            "chunk_seconds": 0.0,
            "last_snapshot_wall": 0.0,
            "last_error": "",
            "restore_outcome": "",
            "restores": {k: 0 for k in RESTORE_OUTCOMES},
            "lock_hold_ms": 0.0,
        }
        os.makedirs(directory, exist_ok=True)
        m = self._load_manifest()
        if isinstance(m, dict):
            with self._lock:
                self._manifest = m
                self.stats["generation"] = int(m.get("generation", 0))
                self.stats["last_snapshot_wall"] = float(
                    m.get("t_wall", 0.0))

    # --- observability ---
    @property
    def degraded(self) -> bool:
        """True while the most recent snapshot attempt failed."""
        with self._lock:
            return self.stats["consecutive_failures"] > 0

    def due(self, interval_s: float) -> bool:
        """Whether ``maybe_snapshot(interval_s)`` would drain now."""
        with self._lock:
            last = self.stats["last_snapshot_wall"]
        return not last or time.time() - last >= interval_s

    def stats_snapshot(self) -> dict:
        with self._lock:
            s = dict(self.stats)
            s["restores"] = dict(self.stats["restores"])
        s["age_s"] = (time.time() - s["last_snapshot_wall"]
                      if s["last_snapshot_wall"] else -1.0)
        return s

    # --- snapshot (writer side) ---
    def maybe_snapshot(self, interval_s: float) -> Optional[int]:
        """Drain only when the last published generation is older than
        ``interval_s``. Returns the new generation or None."""
        if not self.due(interval_s):
            return None
        return self.snapshot()

    def final_snapshot(self, timeout: float = 120.0) -> Optional[int]:
        """The parting snapshot of a clean shutdown: waits out a drain
        in flight, then drains once more. Returns the generation, or
        None on a failure (counted) or a timeout."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            gen = self.snapshot()
            if gen is not None:
                return gen
            with self._lock:
                in_flight = self._snapping
            if not in_flight:
                return None
            time.sleep(0.1)
        return None

    def snapshot(self) -> Optional[int]:
        """Drain the dirty chunks and publish a new manifest generation.
        Returns the generation, or None when a snapshot is in flight or
        this one failed: a failure (an injected one too) marks the
        snapshotter degraded and raises nothing."""
        with self._lock:
            if self._snapping:
                return None
            self._snapping = True
            prev = self._manifest
            gen = self.stats["generation"] + 1
        try:
            manifest = self._drain(gen, prev)
            with self._lock:
                self._manifest = manifest
                self.stats["generation"] = gen
                self.stats["snapshots"] += 1
                self.stats["consecutive_failures"] = 0
                self.stats["last_error"] = ""
                self.stats["last_snapshot_wall"] = manifest["t_wall"]
            self._gc(manifest)
            return gen
        except Exception as e:  # noqa: BLE001 — degraded, not fatal
            log.exception("session snapshot failed (generation %d)", gen)
            with self._lock:
                self.stats["snapshot_failures"] += 1
                self.stats["consecutive_failures"] += 1
                self.stats["last_error"] = f"{type(e).__name__}: {e}"
            return None
        finally:
            with self._lock:
                self._snapping = False

    def _drain(self, gen: int, prev: Optional[dict]) -> dict:
        dp = self.dp
        clone, now, hold_ms = _session_clone(dp, tuple(SESSION_FIELDS),
                                             into=self._copy)
        self._copy = clone
        with self._lock:
            self.stats["lock_hold_ms"] = hold_ms
        geometry = _geometry_of(dp.config)
        mesh = _mesh_of(dp)
        prev_ok = (prev is not None
                   and prev.get("version") == FORMAT_VERSION
                   and prev.get("config") == geometry
                   and prev.get("mesh") == mesh
                   and prev.get("chunk_buckets") == self.chunk_buckets)
        manifest = {
            "version": FORMAT_VERSION,
            "generation": gen,
            "now": now,
            "t_wall": time.time(),
            "config": geometry,
            "mesh": mesh,
            "chunk_buckets": self.chunk_buckets,
            # a cluster's cursors are per node ([N])
            "scalars": {f: (clone[f].tolist() if clone[f].dim()
                            else int(clone[f])) for f in SCALAR_FIELDS},
            "tables": {},
        }
        written = skipped = wbytes = 0
        t_chunks = 0.0
        # a cluster drains per (node, shard) bucket range: chunks are
        # capped to a shard's range, so no chunk file straddles a shard
        # boundary, and each entry records its node and shard
        nodes = (None,) if mesh is None else tuple(range(mesh["n_nodes"]))
        shards = 1 if mesh is None else mesh["rule_shards"]
        for table, fields in TABLE_COLS.items():
            all_cols = tuple(clone[f] for f in fields)
            n_buckets = int(all_cols[0].shape[-2])
            per_shard = n_buckets // shards
            cb = min(self.chunk_buckets, per_shard)
            n_chunks = n_buckets // cb
            flagged = int(clone[f"{table}_valid"].sum())
            prev_tab = (prev["tables"].get(table)
                        if prev_ok and isinstance(prev.get("tables"), dict)
                        else None)
            prev_chunks = (prev_tab["chunks"] if prev_tab is not None
                           and prev_tab.get("chunk_buckets") == cb
                           else None)
            fetch = _fetch_fn(cb)
            entries = []
            for node in nodes:
                cols = (all_cols if node is None
                        else tuple(c[node] for c in all_cols))
                digests = _digest_fn(cb)(cols).cpu().numpy()
                for idx in range(n_chunks):
                    flat = (0 if node is None else node) * n_chunks + idx
                    d = int(digests[idx])
                    if prev_chunks is not None and \
                            flat < len(prev_chunks) and \
                            prev_chunks[flat]["digest"] == d:
                        # unchanged since the published generation: its
                        # file keeps serving the chunk
                        entries.append(dict(prev_chunks[flat]))
                        skipped += 1
                        continue
                    t0 = time.perf_counter()
                    host = _to_host(fetch(cols, idx * cb))
                    count_device_transfer("snapshot.drain", host)
                    payload = host.tobytes()
                    name = _chunk_name(table, idx, gen, node)
                    crc = self._write_chunk(
                        os.path.join(self.directory, name), payload)
                    t_chunks += time.perf_counter() - t0
                    entry = {"file": name, "digest": d, "crc": crc,
                             "start": idx * cb,
                             "shard": (idx * cb) // per_shard}
                    if node is not None:
                        entry["node"] = node
                    entries.append(entry)
                    written += 1
                    wbytes += len(payload)
                    if self.pace_s:
                        time.sleep(self.pace_s)
            manifest["tables"][table] = {
                "chunk_buckets": cb,
                "n_chunks": n_chunks,
                "flagged": flagged,
                "chunks": entries,
            }
        self._publish_manifest(manifest)
        with self._lock:
            self.stats["chunks_written"] += written
            self.stats["chunks_skipped"] += skipped
            self.stats["bytes_written"] += wbytes
            self.stats["chunk_seconds"] += t_chunks
        return manifest

    @staticmethod
    def _write_chunk(path: str, payload: bytes) -> int:
        """One chunk file: header (magic, crc32, length) and payload,
        fsync'd. The ``snapshot.chunk`` fault fires mid-write and leaves
        a torn file (no manifest references it yet)."""
        crc = zlib.crc32(payload) & _M32
        with open(path, "wb") as f:
            f.write(_HDR.pack(_MAGIC, crc, len(payload)))
            try:
                faults.fire("snapshot.chunk")
            except BaseException:
                f.write(payload[: len(payload) // 2])
                f.flush()
                raise
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        return crc

    def _publish_manifest(self, manifest: dict) -> None:
        """tmp -> fsync -> atomic rename: the rename is the commit point.
        The ``snapshot.manifest`` fault fires before it (every chunk
        durable, the generation unpublished)."""
        path = os.path.join(self.directory, MANIFEST)
        _fsync_dir(self.directory)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        faults.fire("snapshot.manifest")
        os.replace(tmp, path)
        _fsync_dir(self.directory)

    def _gc(self, manifest: dict) -> None:
        """Delete chunk files the published manifest no longer
        references, and leftover temporaries. Best effort."""
        live = {e["file"] for t in manifest["tables"].values()
                for e in t["chunks"]}
        try:
            names = os.listdir(self.directory)
        except OSError:
            return
        for name in names:
            if (name.endswith(".chunk") and name not in live) \
                    or name.endswith(".tmp"):
                try:
                    os.unlink(os.path.join(self.directory, name))
                except OSError:
                    pass

    # --- restore (reader side) ---
    def _load_manifest(self):
        """The manifest dict, None when absent, ``"bad"`` when present
        but unreadable."""
        path = os.path.join(self.directory, MANIFEST)
        try:
            with open(path) as f:
                m = json.load(f)
        except FileNotFoundError:
            return None
        except (OSError, json.JSONDecodeError, ValueError):
            return "bad"
        return m if isinstance(m, dict) else "bad"

    def _count_restore(self, outcome: str, detail: str = "") -> None:
        with self._lock:
            self.stats["restore_outcome"] = outcome
            self.stats["restores"][outcome] = \
                self.stats["restores"].get(outcome, 0) + 1
            if detail:
                self.stats["last_error"] = detail
        if outcome != "restored":
            log.warning("session restore: %s%s", outcome,
                        f" ({detail})" if detail else "")

    def restore(self) -> Tuple[Optional[Dict[str, np.ndarray]], str]:
        """Load the last published generation into host session arrays.
        Returns ``(sessions, outcome)``; sessions is None on any refusal,
        and a refusal is always whole: never a half-restored table."""
        m = self._load_manifest()
        if m is None:
            self._count_restore("no_manifest")
            return None, "no_manifest"
        if m == "bad":
            self._count_restore("bad_manifest")
            return None, "bad_manifest"
        if m.get("version") != FORMAT_VERSION:
            self._count_restore("version",
                                f"manifest version {m.get('version')!r}")
            return None, "version"
        geometry = _geometry_of(self.dp.config)
        if m.get("config") != geometry:
            self._count_restore(
                "geometry",
                f"snapshot {m.get('config')} != configured {geometry}")
            return None, "geometry"
        mesh = _mesh_of(self.dp)
        if m.get("mesh") != mesh:
            self._count_restore(
                "geometry",
                f"snapshot mesh {m.get('mesh')} != configured {mesh}")
            return None, "geometry"
        snap_now = int(m.get("now", 0))
        shapes = state_shapes(self.dp.config)
        leading = () if mesh is None else (mesh["n_nodes"],)
        sessions: Dict[str, np.ndarray] = {}
        try:
            for table, fields in TABLE_COLS.items():
                tinfo = m["tables"][table]
                cb = int(tinfo["chunk_buckets"])
                arrs = {f: np.zeros(leading + shapes[f], SESSION_FIELDS[f])
                        for f in fields}
                for entry in tinfo["chunks"]:
                    block = self._read_chunk(entry, len(fields), cb,
                                             shapes[fields[0]][1])
                    if block is None:
                        self._count_restore(
                            "crc_mismatch",
                            f"chunk {entry['file']} failed verification")
                        return None, "crc_mismatch"
                    start = int(entry["start"])
                    for i, f in enumerate(fields):
                        dst = (arrs[f] if mesh is None
                               else arrs[f][int(entry["node"])])
                        dst[start:start + cb] = \
                            block[i].view(SESSION_FIELDS[f])
                sessions.update(arrs)
        except FileNotFoundError as e:
            self._count_restore("missing_chunk", str(e))
            return None, "missing_chunk"
        except Exception as e:  # noqa: BLE001 — a whole refusal
            self._count_restore("error", f"{type(e).__name__}: {e}")
            return None, "error"
        # ages are preserved: time' = time - snap_now
        for f in ("sess_time", "natsess_time"):
            sessions[f] = (sessions[f].astype(np.int64)
                           - snap_now).astype(np.int32)
        for f in SCALAR_FIELDS:
            v = m["scalars"].get(f, 0)
            sessions[f] = (np.asarray(v, np.int32) if mesh is not None
                           else np.int32(v if not isinstance(v, list)
                                         else v[0]))
        self._count_restore("restored")
        return sessions, "restored"

    def _read_chunk(self, entry: dict, n_cols: int, cb: int,
                    ways: int) -> Optional[np.ndarray]:
        """Read and verify one chunk file; None on any mismatch (torn
        header, truncated payload, CRC failure, manifest and file CRC
        disagreeing)."""
        path = os.path.join(self.directory, entry["file"])
        want = n_cols * cb * ways * 4
        with open(path, "rb") as f:
            hdr = f.read(_HDR.size)
            if len(hdr) != _HDR.size:
                return None
            magic, crc, length = _HDR.unpack(hdr)
            if magic != _MAGIC or length != want or \
                    crc != int(entry["crc"]):
                return None
            payload = f.read(length + 1)
        if len(payload) != length or (zlib.crc32(payload) & _M32) != crc:
            return None
        return np.frombuffer(payload, np.int32).reshape(n_cols, cb, ways)

    def restore_into(self, dataplane=None) -> bool:
        """Restore the last generation into the dataplane's live tensors
        (``adopt_sessions``: nothing is recaptured). True when the table
        came back warm; False is a clean cold start (the reason in the
        restore outcome)."""
        dp = dataplane if dataplane is not None else self.dp
        sessions, outcome = self.restore()
        if sessions is None:
            return False
        dp.adopt_sessions(sessions)
        log.info("session table restored warm: generation %d (%s)",
                 self.stats["generation"], outcome)
        return True


# --- range-scoped drain and adopt (live migration) ---------------------
#
# Session ownership moves between dataplanes in contiguous bucket ranges:
# drain_bucket_range fetches a range off the source (chunked like a
# snapshot), adopt_bucket_range splices it into the destination's live
# columns with the age rebase (time' = time - now_src + now_dst), and
# release_bucket_range invalidates it on the source once ownership moved.
# Only the reflective "sess" table migrates by default: NAT sessions key
# on the post-NAT reply tuple, which a steering tier cannot hash
# direction-invariantly.


def _check_range(start: int, n: int, total: int) -> None:
    if not (0 <= start and n > 0 and start + n <= total):
        raise ValueError(
            f"bucket range [{start}, {start + n}) outside table of "
            f"{total} buckets")


def drain_bucket_range(dp, start: int, n_buckets: int,
                       table: str = "sess", chunk_buckets: int = 256):
    """Rows ``[start, start + n_buckets)`` of one session table as
    ``({field: host array [n, W]}, now_src)``: the range is cloned under
    the lock (one step's state), then fetched in chunks outside it."""
    fields = TABLE_COLS[table]
    total = int(getattr(dp.tables, fields[0]).shape[0])
    _check_range(start, n_buckets, total)
    clone, now, _ = _session_clone(dp, fields,
                                   slice(start, start + n_buckets))
    cols = tuple(clone[f] for f in fields)
    cb = min(chunk_buckets, n_buckets)
    out = {f: [] for f in fields}
    for off in range(0, n_buckets, cb):
        faults.fire("fleet.migrate")
        step = min(cb, n_buckets - off)
        block = _to_host(_fetch_fn(step)(cols, off))
        count_device_transfer("migrate.drain", block)
        for i, f in enumerate(fields):
            out[f].append(block[i].view(SESSION_FIELDS[f]))
    return ({f: np.concatenate(v, axis=0) for f, v in out.items()}, now)


def _live_sessions(dp, site: str) -> Dict[str, np.ndarray]:
    """Every session column of the live tables on the host (call under
    ``dp._lock``)."""
    t = dp.tables
    out = {}
    for f, dt in SESSION_FIELDS.items():
        a = getattr(t, f).cpu().numpy()
        out[f] = a.view(np.uint32) if dt == np.uint32 else a
    count_device_transfer(site, out)
    return out


def adopt_bucket_range(dp, cols: Dict[str, np.ndarray], start: int,
                       now_src: int, table: str = "sess") -> int:
    """Splice migrated rows into the destination's live table at
    ``[start, start + n)``, age-rebased to its clock, and publish them
    through ``adopt_sessions`` (the epoch bumps; the telemetry, tenancy
    and ECMP state start cold, as in the reference). The read, splice
    and write run under the lock, so no step lands in between. Returns
    the count of live sessions adopted."""
    fields = TABLE_COLS[table]
    n = int(next(iter(cols.values())).shape[0])
    with dp._lock:
        now_dst = max(dp._now, dp.clock_ticks())
        sessions = _live_sessions(dp, "migrate.adopt")
        _check_range(start, n, int(sessions[fields[0]].shape[0]))
        adopted = 0
        for f in fields:
            arr = np.asarray(cols[f], SESSION_FIELDS[f])
            if f.endswith("_time"):
                arr = (arr.astype(np.int64) - now_src
                       + now_dst).astype(np.int32)
            sessions[f][start:start + n] = arr
            if f.endswith("_valid"):
                adopted = int(arr.sum())
        dp.adopt_sessions(sessions)
    return adopted


def release_bucket_range(dp, start: int, n_buckets: int,
                         table: str = "sess") -> int:
    """Invalidate rows ``[start, start + n)`` on the source after its
    range moved away (through ``adopt_sessions``, as the reference).
    Returns the count of live sessions released."""
    valid_field = f"{table}_valid"
    with dp._lock:
        sessions = _live_sessions(dp, "migrate.release")
        _check_range(start, n_buckets,
                     int(sessions[valid_field].shape[0]))
        released = int(sessions[valid_field][start:start + n_buckets].sum())
        sessions[valid_field][start:start + n_buckets] = 0
        dp.adopt_sessions(sessions)
    return released
