from repro_torch.sharding.rules import (LogicalAxisRules, default_rules,
                                        serving_rules, shard_shape,
                                        spec_for_shape, tree_specs)  # noqa: F401
