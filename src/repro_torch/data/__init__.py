from repro_torch.data.pipeline import SyntheticLMDataset, shard_batch  # noqa: F401
