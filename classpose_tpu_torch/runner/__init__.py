from classpose_tpu_torch.runner.model import ClassposeModel  # noqa: F401
