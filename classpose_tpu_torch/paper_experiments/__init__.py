"""The paper's experiment scripts that run a model (counterpart of the
repository's ``paper_experiments/``): the semantic Cellpose-SAM
baseline, ``python -m
classpose_tpu_torch.paper_experiments.run_cellpose_semantic``."""
