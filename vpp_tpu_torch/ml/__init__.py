"""Per-packet ML scoring: the model artifact and the offline
trainer/packer (NumPy only; the device stage lives in
``vpp_tpu_torch/ops/mlscore.py``)."""

from vpp_tpu_torch.ml.model import (
    ML_FEATURES,
    MlModel,
    MlModelError,
    load_model,
    packet_features,
    save_model,
    score_oracle,
)

__all__ = ["ML_FEATURES", "MlModel", "MlModelError", "load_model",
           "packet_features", "save_model", "score_oracle"]
