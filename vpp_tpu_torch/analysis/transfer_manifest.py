"""Approved device-to-host read sites for the ``--transfers`` pass.

``TRANSFER_SITES`` maps ``(repo-relative path, function qualname)`` to
why the function may read table state back to the host; ``"*"``
approves a whole file. Say what bounds the bytes (a rider, K candidates,
a bucket range, one drain per snapshot interval): "it was convenient"
is no bound. An entry that no longer resolves is itself a finding
(``transfer-site-stale``). A single bounded read in a function that is
no drain carries an inline ``# transfer-ok: <reason>`` instead.
"""

from typing import Dict, Tuple

TRANSFER_SITES: Dict[Tuple[str, str], str] = {
    ("vpp_tpu_torch/pipeline/persistent.py", "PersistentPump._fetch_loop"): (
        "THE packed-result fetch: one copy per ring window of the tx and "
        "aux records (and the telemetry rider), never table columns"),
    # the session snapshot and the range migration: the sanctioned bulk
    # session drains
    ("vpp_tpu_torch/pipeline/snapshot.py", "SessionSnapshotter._drain"): (
        "the periodic checkpoint drain: chunked, amortised over the "
        "snapshot interval, on the snapshotter's thread"),
    ("vpp_tpu_torch/pipeline/snapshot.py", "drain_bucket_range"): (
        "a migration's drain: the moved bucket range only, chunked"),
    ("vpp_tpu_torch/pipeline/snapshot.py", "adopt_bucket_range"): (
        "a migration's adopt: splices the drained range in; bounded by "
        "the range and the migration cadence"),
    ("vpp_tpu_torch/pipeline/snapshot.py", "release_bucket_range"): (
        "a migration's release: invalidates the moved range on the "
        "source; bounded as the adopt"),
    ("vpp_tpu_torch/pipeline/snapshot.py", "_live_sessions"): (
        "the session columns adopt_bucket_range and release_bucket_range "
        "splice (their only caller), once per migrated range"),
    # the dataplane's snapshots
    ("vpp_tpu_torch/pipeline/dataplane.py", "Dataplane.fib_snapshot"): (
        "the ECMP counter plane only ([groups, ways]), at CLI or "
        "collector cadence"),
    ("vpp_tpu_torch/pipeline/dataplane.py", "Dataplane.telemetry_snapshot"): (
        "the telemetry rider: the histogram bins and the top-K "
        "candidates, a few hundred bytes; the sketch stays on the card"),
    ("vpp_tpu_torch/pipeline/dataplane.py", "Dataplane.tenant_snapshot"): (
        "per-tenant rows ([max_tenants] each) and the device-reduced "
        "occupancy, at collector cadence"),
    ("vpp_tpu_torch/parallel/cluster.py",
     "ClusterDataplane.shard_sessions_resident"): (
        "[rule shards] counts, reduced on the device"),
    # operator pages (the VPP `show` commands): on an explicit request
    ("vpp_tpu_torch/cli.py", "DebugCLI.show_session"): (
        "operator page: one device reduction per request"),
    ("vpp_tpu_torch/cli.py", "DebugCLI.show_sessions"): (
        "operator page: a page of session rows per request"),
    ("vpp_tpu_torch/cli.py", "DebugCLI.show_nat44"): (
        "operator page: the NAT session listing per request"),
    ("vpp_tpu_torch/cli.py", "DebugCLI.show_fastpath"): (
        "operator page: two device-reduced counts per request"),
}
