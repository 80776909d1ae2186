from demo2program_tpu_torch.utils.logger import log  # noqa: F401
