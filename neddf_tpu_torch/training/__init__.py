from neddf_tpu_torch.training.losses import (  # noqa: F401
    ColorLoss,
    FieldsConstraintLoss,
    MaskBCELoss,
    MaskMSELoss,
)
from neddf_tpu_torch.training.trainer import NeRFTrainer  # noqa: F401
