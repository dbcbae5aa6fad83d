from neddf_tpu_torch.data.base import BaseDataset  # noqa: F401
from neddf_tpu_torch.data.nerf_synthetic import NeRFSyntheticDataset  # noqa: F401
