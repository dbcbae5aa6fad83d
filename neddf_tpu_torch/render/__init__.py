from neddf_tpu_torch.render.renderer import NeRFRender  # noqa: F401
