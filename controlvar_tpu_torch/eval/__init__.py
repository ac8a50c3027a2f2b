"""eval of the PyTorch port."""
from controlvar_tpu_torch.eval.harness import (  # noqa: F401
    SamplingHarness,
    class_shard,
)
