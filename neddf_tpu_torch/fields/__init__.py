from neddf_tpu_torch.fields.base import Linear, Schedule  # noqa: F401
from neddf_tpu_torch.fields.neddf import NeDDF  # noqa: F401
