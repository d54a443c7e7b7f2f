from repro_torch.parallel.sharding import (DEFAULT_RULES, ShardingRules,
                                           rules_for_arch, spec_for,
                                           tree_shardings)
