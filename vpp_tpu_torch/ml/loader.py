"""Agent-side model source: load artifacts from disk, stage them
through the builder/epoch-swap path, refuse garbage cleanly.

The port's copy of ``vpp_tpu/ml/loader.py``. The swap contract
(mirrored on the snapshot restore ledger): a corrupt / mis-versioned / mis-shaped artifact NEVER
reaches the device — ``TableBuilder.set_ml_model`` validates before
mutating staging, so a refusal leaves the previous model serving and
the outcome is COUNTED (``vpp_tpu_ml_load_total{outcome=}``) with the
``ml`` component of ``vpp_tpu_degraded`` raised until a good load
lands. The ``ml.load`` fault point (testing/faults.py) injects
exactly here, so the tests drive the refusal path through the real
seam.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Dict, Optional

from vpp_tpu_torch.ml.model import MlModelError, load_model
from vpp_tpu_torch.testing import faults

log = logging.getLogger("vpp_tpu_torch.ml")

# load outcomes, in ledger order (every refusal reason keeps the
# previous epoch serving; `loaded` is the only success)
LOAD_OUTCOMES = ("loaded", "corrupt", "bad_version", "bad_shape",
                 "io_error", "error")


class MlModelSource:
    """Watches one artifact path and publishes it into a Dataplane.

    ``load()`` stages + swaps under the dataplane's commit lock;
    ``poll()`` is the maintenance-tick hook (reloads only when the
    file's mtime moved). Thread-safe: the maintenance thread loads
    while the collector/CLI snapshot stats.
    """

    def __init__(self, dataplane, path: str):
        self.dp = dataplane
        self.path = path
        self._lock = threading.Lock()
        self._outcomes: Dict[str, int] = {o: 0 for o in LOAD_OUTCOMES}
        self._degraded = False
        self._last_error = ""
        self._loaded_version = 0
        self._loaded_kind = ""
        self._mtime: Optional[float] = None

    # --- observability surface (collector set_ml / `show ml`) ---
    @property
    def degraded(self) -> bool:
        with self._lock:
            return self._degraded

    def stats_snapshot(self) -> dict:
        with self._lock:
            return {
                "path": self.path,
                "outcomes": dict(self._outcomes),
                "degraded": self._degraded,
                "last_error": self._last_error,
                "loaded_version": self._loaded_version,
                "loaded_kind": self._loaded_kind,
            }

    def _refuse(self, outcome: str, err: BaseException) -> None:
        with self._lock:
            self._outcomes[outcome] += 1
            self._degraded = True
            self._last_error = f"{type(err).__name__}: {err}"
        log.warning("ML model load refused (%s), previous model keeps "
                    "serving: %s", outcome, err)

    def load(self) -> bool:
        """Load the artifact and publish it as a new epoch. Returns
        True on success; every failure is a counted refusal that
        leaves the previous model serving."""
        try:
            # the fault seam: a chaos plan makes THIS load fail with a
            # site-native error, driving the refusal path end to end
            faults.fire("ml.load")
            model = load_model(self.path)
        except MlModelError as e:
            out = "bad_version" if "format_version" in str(e) else "corrupt"
            self._refuse(out, e)
            return False
        except OSError as e:
            self._refuse("io_error", e)
            return False
        except faults.FaultInjected as e:
            self._refuse("error", e)
            return False
        try:
            with self.dp.commit_lock:
                self.dp.builder.set_ml_model(model)
                self.dp.builder.txn_label = f"ml-model v{model.version}"
                self.dp.swap()
        except (ValueError, MlModelError) as e:
            # geometry mismatch against the configured capacity:
            # set_ml_model validated BEFORE mutating, staging is intact
            self._refuse("bad_shape", e)
            return False
        with self._lock:
            self._outcomes["loaded"] += 1
            self._degraded = False
            self._last_error = ""
            self._loaded_version = int(model.version)
            self._loaded_kind = model.kind
        log.info("ML model v%d (%s) published from %s",
                 model.version, model.kind, self.path)
        return True

    def poll(self) -> bool:
        """Maintenance-tick hook: reload when the artifact changed on
        disk (mtime). Missing file on first poll is a counted refusal;
        a previously-loaded model keeps serving if the file vanishes."""
        try:
            mtime = os.stat(self.path).st_mtime
        except OSError as e:
            with self._lock:
                first = self._mtime is None
                self._mtime = -1.0
            if first:
                self._refuse("io_error", e)
            return False
        with self._lock:
            unchanged = self._mtime == mtime
            self._mtime = mtime
        if unchanged:
            return False
        return self.load()
