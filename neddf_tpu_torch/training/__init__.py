from neddf_tpu_torch.training.trainer import NeRFTrainer  # noqa: F401
