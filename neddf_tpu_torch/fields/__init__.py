from neddf_tpu_torch.fields.base import Linear, Schedule  # noqa: F401
from neddf_tpu_torch.fields.neddf import NeDDF  # noqa: F401
from neddf_tpu_torch.fields.nerf import NeRF  # noqa: F401
from neddf_tpu_torch.fields.neus import NeuS  # noqa: F401
