from repro_torch.data.pipeline import (
    SyntheticLM, Dataset, shard, make_batch_specs,
)
