"""Per-packet ML scoring: the model artifact, the offline
trainer/packer (NumPy only) and the agent-side loader (``MlModelSource``,
``ml/loader.py``); the device stage lives in
``vpp_tpu_torch/ops/mlscore.py``."""

from vpp_tpu_torch.ml.model import (
    ML_FEATURES,
    MlModel,
    MlModelError,
    load_model,
    packet_features,
    save_model,
    score_oracle,
)
from vpp_tpu_torch.ml.loader import MlModelSource

__all__ = ["ML_FEATURES", "MlModel", "MlModelError", "MlModelSource",
           "load_model", "packet_features", "save_model", "score_oracle"]
